"""Smoke test of the mt device codec on one NVIDIA GPU (or four with --multi).

    python chip_smoke.py            # one card: every phase below
    python chip_smoke.py --multi    # four cards: the sharded path only

Phases (one process; any failure exits non-zero before the last line):
  1. the platform is 'gpu'; the card's name and power limit are printed;
  2. 64 MiB of x-ray at B=12, n=64 with device_plan: mt_encode_device's blob
     decodes to the input through the host oracle (ops.mt.mt_decode) and
     through mt_decode_device; so does the host oracle's own blob;
  3. the same on 64 MiB of the mixed corpus;
  4. mt_decode_device on host-oracle blobs at every B=10..15 and n=32, 64
     (8 MiB each, the reference planner's uncapped blocks), and on the mt
     golden vectors;
  5. the Pallas kernel (mt_decode_device) and the plain-XLA scan
     (mt_decode_scan) give the same bytes; both are timed.
With --multi, a 1-D mesh over four cards runs mt_encode_device and
mt_decode_device sharded; the blob must equal the one-card blob, and both
the oracle and the sharded decode must return the input.

The last line is one JSON object: {"ok": true, "device": {...}}.  Byte
equality is the only check: this is an integer codec.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
MIB = 1 << 20


def _log(msg: str) -> None:
    print(msg, flush=True)


def _phase(name: str, fn) -> None:
    t0 = time.perf_counter()
    fn()
    _log(f"phase {name}: ok ({time.perf_counter() - t0:.1f} s)")


def _timed(fn, reps: int = 5) -> tuple[object, list[float]]:
    out = fn()  # warm-up: compiles
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        ts.append(time.perf_counter() - t0)
    return out, ts


def _expect(got, want: np.ndarray, what: str) -> None:
    if got != want.tobytes():
        raise AssertionError(f"{what}: decoded bytes differ from the input")


def _corpus(name: str, size: int) -> np.ndarray:
    data = np.fromfile(REPO / "tests" / "corpus" / name, np.uint8)
    return np.tile(data, -(-size // data.size))[:size]


def _roundtrip_64mib(name: str, data: np.ndarray) -> None:
    from hsrans.ops.mt import mt_decode, mt_encode
    from hsrans.parallel.sharded import device_plan, mt_decode_device, mt_decode_scan, mt_encode_device

    bits, n = 12, 64
    plan = device_plan(data, bits, n)
    blob, t_enc = _timed(lambda: mt_encode_device(data, bits, n, plan=plan), reps=2)
    _log(f"  {name}: {len(plan)} blocks, ratio {len(blob) / data.size:.4f}, mt_encode_device {min(t_enc):.3f} s")
    _expect(mt_decode(blob, bits, n), data, f"{name}: host oracle on the device blob")
    got, t_kernel = _timed(lambda: mt_decode_device(blob, bits, n))
    _expect(got, data, f"{name}: mt_decode_device on the device blob")
    scan, t_scan = _timed(lambda: mt_decode_scan(blob, bits, n))
    if scan != got:
        raise AssertionError(f"{name}: kernel and scan decodes differ")
    mib = data.size / MIB
    _log(f"  {name}: decode kernel {mib / np.median(t_kernel):.1f} MiB/s (median of {len(t_kernel)}), "
         f"scan {mib / np.median(t_scan):.1f} MiB/s")
    oracle = mt_encode(data, bits, n, plan=plan)
    _expect(mt_decode_device(oracle, bits, n), data, f"{name}: mt_decode_device on the oracle blob")


def _depths_and_goldens() -> None:
    from hsrans.ops.mt import mt_encode
    from hsrans.parallel.sharded import mt_decode_device
    from hsrans.runtime.native import fnv1a
    from tools.gen_inputs import CASES

    data = np.concatenate([_corpus("corpus.bin", 6 * MIB), _corpus("xray.bin", 2 * MIB)])
    for n in (32, 64):
        for bits in range(10, 16):
            t0 = time.perf_counter()
            blob = mt_encode(data, bits, n)
            t1 = time.perf_counter()
            _expect(mt_decode_device(blob, bits, n), data, f"B={bits} n={n}")
            _log(f"  B={bits} n={n}: oracle encode {t1 - t0:.2f} s, device decode {time.perf_counter() - t1:.2f} s")

    golden = REPO / "tests" / "golden"
    count = 0
    for meta in sorted(golden.glob("*.mt*_*.meta")):
        case, codec = meta.stem.split(".")
        n, bits = (int(x) for x in codec[2:].split("_"))
        fn, size = CASES[case]
        want = fn(np.random.default_rng(sum(ord(c) for c in case)), size)
        ref_size, ref_hash = meta.read_text().split()
        bin_path = meta.with_suffix(".bin")
        blob = bin_path.read_bytes() if bin_path.exists() else mt_encode(want, bits, n)
        if len(blob) != int(ref_size) or fnv1a(blob) != int(ref_hash, 16):
            raise AssertionError(f"golden {meta.name}: blob differs from the reference's")
        _expect(mt_decode_device(blob, bits, n), want, f"golden {meta.name}")
        count += 1
    if count == 0:
        raise AssertionError("no mt golden vectors found")
    _log(f"  {count} mt golden vectors decode on the device")


def _multi() -> None:
    import jax
    from jax.sharding import Mesh

    from hsrans.ops.mt import mt_decode
    from hsrans.parallel.sharded import device_plan, mt_decode_device, mt_encode_device

    devs = jax.devices()
    if len(devs) != 4:
        raise AssertionError(f"--multi needs four cards, found {len(devs)}")
    mesh = Mesh(np.array(devs), ("dp",))
    bits, n = 12, 64
    data = _corpus("xray.bin", 64 * MIB)
    plan = device_plan(data, bits, n)
    one = mt_encode_device(data, bits, n, plan=plan)
    blob, t_enc = _timed(lambda: mt_encode_device(data, bits, n, mesh=mesh, plan=plan), reps=2)
    if blob != one:
        raise AssertionError("four-card encode differs from the one-card blob")
    _expect(mt_decode(blob, bits, n), data, "host oracle on the four-card blob")
    got, t_dec = _timed(lambda: mt_decode_device(blob, bits, n, mesh=mesh))
    _expect(got, data, "four-card mt_decode_device")
    one_dec, t_one = _timed(lambda: mt_decode_device(blob, bits, n))
    _expect(one_dec, data, "one-card mt_decode_device")
    mib = data.size / MIB
    _log(f"  4 cards: encode {mib / min(t_enc):.1f} MiB/s, decode {mib / np.median(t_dec):.1f} MiB/s "
         f"(one card in the same process: {mib / np.median(t_one):.1f} MiB/s)")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi", action="store_true", help="four cards: the sharded path only")
    args = ap.parse_args()

    sys.path.insert(0, str(REPO))
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {dev.platform!r}", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    _log(f"card: {smi.stdout.strip().splitlines()[0]}")

    from hsrans.runtime.device import detect

    cap = detect()
    if cap.tier != "gpu" or cap.pallas_interpret:
        raise AssertionError(f"expected the compiled gpu tier, got {cap}")
    _log(f"jax {jax.__version__}, {cap.device_kind} x{cap.num_devices}")

    if args.multi:
        _phase("multi", _multi)
    else:
        _phase("xray-64MiB", lambda: _roundtrip_64mib("x-ray", _corpus("xray.bin", 64 * MIB)))
        _phase("corpus-64MiB", lambda: _roundtrip_64mib("mixed corpus", _corpus("corpus.bin", 64 * MIB)))
        _phase("depths-and-goldens", _depths_and_goldens)

    print(json.dumps({"ok": True, "device": {"platform": dev.platform, "kind": dev.device_kind, "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
