"""End-to-end timing of the mt device codec on a GPU.

    python bench.py [--runs N] [--trace DIR]

Times `mt_decode_device` (the Pallas kernel), `mt_decode_scan` (the same
decode in plain XLA) and `mt_encode_device` from host bytes to host bytes;
each call returns host bytes, so it has finished on the device when it
returns.  Blobs use `device_plan` at B=12, n=64, on 64 MiB of the x-ray and
of the mixed corpus (tests/corpus, tiled).  Every row is one JSON line
stamped with the device, its power limit and the median and spread of
`--runs` timed calls after one warm-up call.

With --trace, one more call of each is traced with jax.profiler and the
device busy time of that call (the union of the intervals in which device
work runs) is added to its row.  A run that finds no GPU fails.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
MIB = 1 << 20
BITS, N = 12, 64


def device_info() -> dict:
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py measures a GPU; JAX found {dev.platform!r}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return {
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "count": len(jax.devices()),
        "power_limit": smi.stdout.strip().splitlines()[0].split(",")[-1].strip(),
    }


def device_busy_ns(trace_dir: str) -> int:
    """Device busy time in the newest trace under `trace_dir`: the union of
    the events on the device planes' stream lines (the derived 'XLA ...'
    lines summarise the same work and are skipped)."""
    from jax.profiler import ProfileData

    path = sorted(glob.glob(os.path.join(trace_dir, "plugins", "profile", "*", "*.xplane.pb")))[-1]
    spans = []
    for plane in ProfileData.from_file(path).planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            if line.name.startswith("XLA"):
                continue
            spans += [(e.start_ns, e.start_ns + e.duration_ns) for e in line.events]
    busy, end = 0, None
    for s, e in sorted(spans):
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return int(busy)


def _corpus(name: str, size: int) -> np.ndarray:
    data = np.fromfile(os.path.join(REPO, "tests", "corpus", name), np.uint8)
    return np.tile(data, -(-size // data.size))[:size]


def measure(label: str, fn, nbytes: int, runs: int, trace_dir: str | None, info: dict, **extra) -> dict:
    fn()  # warm-up: compiles
    ts = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    med = float(np.median(ts))
    row = {
        "metric": label,
        "mib_s": nbytes / MIB / med,
        "median_s": med,
        "min_s": min(ts),
        "max_s": max(ts),
        "runs": runs,
        **extra,
        **info,
    }
    if trace_dir:
        import jax

        sub = os.path.join(trace_dir, label)
        with jax.profiler.trace(sub):
            t0 = time.perf_counter()
            fn()
            row["traced_call_s"] = time.perf_counter() - t0
        row["device_busy_s"] = device_busy_ns(sub) / 1e9
    print(json.dumps(row), flush=True)
    return row


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--trace", metavar="DIR", help="also trace one call of each row")
    args = ap.parse_args()

    sys.path.insert(0, REPO)
    from hsrans.parallel.sharded import device_plan, mt_decode_device, mt_decode_scan, mt_encode_device

    info = device_info()
    for name, file in (("xray", "xray.bin"), ("corpus", "corpus.bin")):
        data = _corpus(file, 64 * MIB)
        plan = device_plan(data, BITS, N)
        blob = mt_encode_device(data, BITS, N, plan=plan)
        want = data.tobytes()
        for route, dec in (("kernel", mt_decode_device), ("scan", mt_decode_scan)):
            if dec(blob, BITS, N) != want:
                raise SystemExit(f"{route} decode of {name} differs from the input")
            measure(f"mt_dp_{name}_decode_B{BITS}_{route}", lambda: dec(blob, BITS, N), data.size,
                    args.runs, args.trace, info, ratio=len(blob) / data.size, blocks=len(plan))
        measure(f"mt_dp_{name}_encode_B{BITS}", lambda: mt_encode_device(data, BITS, N, plan=plan), data.size,
                args.runs, args.trace, info, ratio=len(blob) / data.size, blocks=len(plan))


if __name__ == "__main__":
    main()
