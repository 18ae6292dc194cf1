"""hsrans-compatible benchmark/test CLI.

Mirrors the reference binary's interface (main.cpp:367-399):

  python -m hsrans.cli <file> [flags]

    --test              run every codec/variant once and validate roundtrips
    --all               include all variants (default: relevant set)
    --hist-min N        minimum TotalSymbolCountBits (default 10)
    --hist-max N        maximum TotalSymbolCountBits (default 15)
    --include-raw/--exclude-raw, --include-mt/--exclude-mt,
    --include-32blk/--exclude-32blk, --include-block/--exclude-block,
    --include-tpx/--exclude-tpx
    --runs N            timed runs per codec (default 3)
    --runs-enc/--runs-dec N   separate encode/decode run counts
    --max-simd <level>  capability downgrade (reference main.cpp:463-618):
                        'none' -> numpy scalar tier; other levels -> the
                        interpret tier (device rows only where JAX runs on
                        the CPU, in Pallas interpret mode)
    --backend {auto,device,interpret,numpy}
                        auto: device rows on a GPU, host codecs elsewhere
    --exclude-dev       drop the mt device rows (mt_encode_device /
                        mt_decode_device)
    --no-sleep / --low-mem    accepted for flag parity (thermal sleeps
                        have no device analog)
    --cpu-core N        pin the process to core N (host-tier timing
                        stability, same purpose as the reference's flag)

Output mirrors the reference's table: ratio, encode MiB/s (best run),
decode max/avg/min MiB/s and per-run σ (main.cpp:72-118's stat set).
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np


def _build_codecs(args) -> list[dict]:
    from .models.histogram import make_hist
    from .ops import blk32, block, mt, reference
    from .ops.tpx import tpx_decode, tpx_encode

    bits_range = range(args["hist_min"], args["hist_max"] + 1)
    codecs = []
    # --max-simd none (backend numpy) must also downgrade the HOST tier:
    # the numpy authorities run instead of the native AVX-512 codecs, so
    # capability-downgrade rows measure what they claim to (the reference's
    # --max-simd cascade, main.cpp:463-618)
    scalar = args["backend"] == "numpy"

    def add(name, enc, dec, bits):
        codecs.append({"name": f"{name} {bits}", "enc": enc, "dec": dec})

    widths = [n for n in (16, 32, 64) if args[f"w{n}"]]
    for bits in bits_range:
        if args["raw"]:
            for n in widths:
                if scalar:
                    enc = (lambda b, n=n: lambda d: reference.raw_encode_16w(d, make_hist(d, b), n))(bits)
                    dec = (lambda b, n=n: lambda c: reference.raw_decode_16w(c, b, n))(bits)
                else:
                    enc = (lambda b, n=n: lambda d: reference.raw_encode(d, b, n))(bits)
                    dec = (lambda b, n=n: lambda c: reference.raw_decode(c, b, n))(bits)
                add(f"rANS32x{n} 16w", enc, dec, bits)
        if args["blk32"] and 32 in widths:
            for wb in (16, 8):
                if scalar:
                    enc = (lambda b, wb=wb: lambda d: blk32.blk32_encode(d, make_hist(d, b), wb))(bits)
                    dec = (lambda b, wb=wb: lambda c: blk32.blk32_decode(c, b, wb))(bits)
                else:
                    enc = (lambda b, wb=wb: lambda d: blk32.blk32_encode_host(d, b, wb))(bits)
                    dec = (lambda b, wb=wb: lambda c: blk32.blk32_decode_host(c, b, wb))(bits)
                add(f"rANS32x32 32blk {wb}w", enc, dec, bits)
        if args["block"]:
            for n in [n for n in (32, 64) if n in widths]:
                enc_fn = block.block_encode_py if scalar else block.block_encode
                dec_fn = block.block_decode_py if scalar else block.block_decode
                add(
                    f"block rANS32x{n} 16w",
                    (lambda b, n=n, f=enc_fn: lambda d: f(d, b, n))(bits),
                    (lambda b, n=n, f=dec_fn: lambda c: f(c, b, n))(bits),
                    bits,
                )
        if args["mt"]:
            for n in [n for n in (32, 64) if n in widths]:
                enc_fn = mt.mt_encode_py if scalar else mt.mt_encode
                dec_fn = mt.mt_decode_py if scalar else mt.mt_decode
                add(
                    f"mt rANS32x{n} 16w",
                    (lambda b, n=n, f=enc_fn: lambda d: f(d, b, n))(bits),
                    (lambda b, n=n, f=dec_fn: lambda c: f(c, b, n))(bits),
                    bits,
                )
            if args["backend"] != "numpy" and args["dev"]:
                from .parallel.sharded import mt_decode_device, mt_encode_device

                for n in [n for n in (32, 64) if n in widths]:
                    add(
                        f"mt rANS32x{n} 16w dev",
                        (lambda b, n=n: lambda d: mt_encode_device(d, b, n))(bits),
                        (lambda b, n=n: lambda c: mt_decode_device(c, b, n))(bits),
                        bits,
                    )
        if args["tpx"]:
            from .ops.tpx import tpx_encode_adaptive

            add("tpx rANS32x128x1024", (lambda b: lambda d: tpx_encode(d, b))(bits), tpx_decode, bits)
            add("tpx adaptive (v3)", (lambda b: lambda d: tpx_encode_adaptive(d, b))(bits), tpx_decode, bits)
    return codecs


def parse_args(argv: list[str]) -> dict:
    args = {
        "file": None,
        "test": False,
        "runs": 3,
        "runs_enc": None,
        "runs_dec": None,
        "hist_min": 10,
        "hist_max": 15,
        "raw": True,
        "blk32": False,
        "mt": False,
        "block": True,
        "tpx": True,
        "dev": True,  # --exclude-dev drops the mt device rows
        # state-width filters (reference --exclude-16/-32/-64, main.cpp:247-249)
        "w16": True,
        "w32": True,
        "w64": True,
        "backend": "auto",
        "max_simd": None,
        "cpu_core": None,
    }
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "--test":
            args.update(test=True, runs=1, raw=True, blk32=True, mt=True, block=True, tpx=True)
        elif a == "--all":
            args.update(raw=True, blk32=True, mt=True, block=True, tpx=True)
        elif a in ("--runs", "--runs-enc", "--runs-dec"):
            key = {"--runs": "runs", "--runs-enc": "runs_enc", "--runs-dec": "runs_dec"}[a]
            i += 1
            args[key] = int(argv[i])
        elif a == "--hist-min":
            i += 1
            args["hist_min"] = int(argv[i])
        elif a == "--hist-max":
            i += 1
            args["hist_max"] = int(argv[i])
        elif a.startswith("--include-") or a.startswith("--exclude-"):
            # the reference spells the 32blk family "--include-32blk"
            # (main.cpp flag table); internal key is "blk32".  Bare width
            # numbers are the state-width filters (--exclude-16/-32/-64).
            key = a[10:].replace("-", "")
            key = {"32blk": "blk32", "16": "w16", "32": "w32", "64": "w64"}.get(key, key)
            args[key] = a.startswith("--include-")
        elif a == "--max-simd":
            i += 1
            args["max_simd"] = argv[i]
        elif a == "--backend":
            i += 1
            args["backend"] = argv[i]
        elif a in ("--no-sleep", "--low-mem"):
            pass  # thermal/memory hygiene flags: accepted, nothing to do
        elif a == "--cpu-core":
            i += 1
            args["cpu_core"] = int(argv[i])
        elif not a.startswith("-"):
            args["file"] = a
        i += 1
    # Capability downgrade (reference: main.cpp:463-618), resolved once AFTER
    # all flags so the result is argument-order independent.  Only ever
    # downgrades: the full level is a no-op, mid levels force the interpret
    # tier, none forces the numpy scalar tier — even over an explicit
    # --backend device (warned), never upgrading an explicit numpy.
    level = args.pop("max_simd")
    if level == "none":
        if args["backend"] == "device":
            print("warning: --max-simd none overrides --backend device", file=sys.stderr)
        args["backend"] = "numpy"
    elif level is not None and level not in ("avx512bw", "avx512f"):
        if args["backend"] in ("auto", "device"):
            if args["backend"] == "device":
                print(f"warning: --max-simd {level} overrides --backend device", file=sys.stderr)
            args["backend"] = "interpret"
    return args


def _print_mismatch(want: np.ndarray, got: bytes | None) -> None:
    """Hex context around the first differing byte (the reference's Validate
    diff dump, main.cpp:949-1039)."""
    if got is None:
        print("  decode returned None (malformed-input path)", file=sys.stderr)
        return
    g = np.frombuffer(got, dtype=np.uint8)
    if g.size != want.size:
        print(f"  length mismatch: expected {want.size}, got {g.size}", file=sys.stderr)
    n = min(g.size, want.size)
    diffs = np.nonzero(g[:n] != want[:n])[0]
    at = int(diffs[0]) if diffs.size else n
    lo, hi = max(0, at - 16), min(n, at + 16)
    print(f"  first mismatch at offset {at} ({diffs.size} differing bytes)", file=sys.stderr)
    print("  expected: " + want[lo:hi].tobytes().hex(" "), file=sys.stderr)
    print("  got:      " + g[lo:hi].tobytes().hex(" "), file=sys.stderr)


def main(argv: list[str] | None = None) -> int:
    args = parse_args(argv if argv is not None else sys.argv[1:])
    if not args["file"]:
        print(__doc__)
        return 2

    from .runtime.device import banner, detect

    cap = detect()
    if args["backend"] == "auto":
        args["backend"] = "device" if cap.tier == "gpu" else "numpy"
    if args["backend"] == "interpret" and cap.platform != "cpu":
        # interpret mode is a CPU tier; on a GPU the downgrade keeps the
        # host codecs only
        print("note: interpret tier on a GPU host: device rows dropped", file=sys.stderr)
        args["dev"] = False
    core = args.pop("cpu_core")
    if core is not None:
        # pin the process for stable host-tier timing (the reference pins its
        # bench thread the same way, main.cpp --cpu-core)
        try:
            os.sched_setaffinity(0, {core})
        except (AttributeError, OSError) as e:
            print(f"warning: --cpu-core {core} not applied: {e}", file=sys.stderr)
    print(banner(cap))

    data = np.fromfile(args["file"], dtype=np.uint8)
    print(f"file: {args['file']} ({data.size} bytes)")
    print(
        f"{'codec':<28} {'ratio':>8} {'enc MiB/s':>10} "
        f"{'dec max':>9} {'dec avg':>9} {'dec min':>9} {'dec σ%':>7}  status"
    )

    runs_enc = args["runs_enc"] or args["runs"]
    runs_dec = args["runs_dec"] or args["runs"]
    failed = 0
    for codec in _build_codecs(args):
        try:
            blob = None
            enc_dt = float("inf")
            for _ in range(runs_enc):
                t0 = time.perf_counter()
                blob = codec["enc"](data)
                enc_dt = min(enc_dt, time.perf_counter() - t0)
            dts = []
            out = None
            for _ in range(runs_dec):
                t0 = time.perf_counter()
                out = codec["dec"](blob)
                dts.append(time.perf_counter() - t0)
            ok = out == data.tobytes()
            if not ok:
                failed += 1
                _print_mismatch(data, out)
            mib = data.size / (1 << 20)
            # per-run spread, reference main.cpp:72-118 (avg/min/max/std dev);
            # rates: best run = mib/min(dts), worst = mib/max(dts)
            rates = [mib / dt for dt in dts]
            avg = sum(rates) / len(rates)
            sigma = (sum((r - avg) ** 2 for r in rates) / len(rates)) ** 0.5
            print(
                f"{codec['name']:<28} {len(blob)/max(data.size,1)*100:7.2f}% "
                f"{mib/enc_dt:>10.2f} {max(rates):>9.2f} {avg:>9.2f} "
                f"{min(rates):>9.2f} {100*sigma/avg if avg else 0:>6.1f}%  "
                f"{'OK' if ok else 'MISMATCH'}"
            )
        except Exception as e:  # mirror reference: any failure is a test failure
            failed += 1
            print(f"{codec['name']:<28} ERROR: {type(e).__name__}: {e}")

    if args["test"]:
        print(f"--test: {'ALL OK' if failed == 0 else f'{failed} FAILURES'}")
        return 1 if failed else 0
    return 0


if __name__ == "__main__":
    sys.exit(main())
