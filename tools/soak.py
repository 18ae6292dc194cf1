"""Differential soak: random inputs through every family x depth x width,
cross-checking the numpy oracle, native C++, and the mt device paths (the
decode kernel in interpret mode, the XLA encode) on the CPU.

This is the checked-in version of the harness that found the n=16 mt/block
dispatch bug in round 4 (commit 17d1cc8).  The reference has no fuzz layer;
its nearest analog is main.cpp's --test roundtrip loop — this goes further
by diffing *tiers* against each other, not just roundtripping one path.

Usage:
    python tools/soak.py [--cases N] [--seed S] [--max-size BYTES]

Exit code 0 iff every case passed.  Runs CPU-only (never touches a device).
"""

from __future__ import annotations

import argparse
import sys
import traceback
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax

jax.config.update("jax_platforms", "cpu")

from tools.gen_inputs import text_like  # noqa: E402

from hsrans.ops.blk32 import blk32_decode_host, blk32_encode_host  # noqa: E402
from hsrans.ops.block import (  # noqa: E402
    block_decode,
    block_decode_py,
    block_encode,
    block_encode_py,
)
from hsrans.ops.mt import mt_decode, mt_decode_py, mt_encode, mt_encode_py  # noqa: E402
from hsrans.ops.reference import raw_decode, raw_encode  # noqa: E402
from hsrans.ops.tpx import tpx_decode, tpx_encode, tpx_encode_adaptive  # noqa: E402
from hsrans.parallel.sharded import mt_decode_device, mt_encode_device  # noqa: E402


def make_input(rng: np.random.Generator, it: int, max_size: int) -> np.ndarray:
    kind = it % 4
    size = int(rng.integers(1, max_size))
    sub = np.random.default_rng(it)
    if kind == 0:
        return text_like(sub, size)
    if kind == 1:
        return (np.minimum(sub.zipf(1.1 + (it % 7) * 0.2, size), 255) - 1).astype(np.uint8)
    if kind == 2:
        return np.full(size, it % 256, np.uint8)  # RLE / single-symbol
    return sub.integers(0, 256, size).astype(np.uint8)  # incompressible


def run_case(rng: np.random.Generator, it: int, max_size: int) -> None:
    data = make_input(rng, it, max_size)
    want = data.tobytes()
    bits = int(rng.integers(10, 16))
    n = [16, 32, 64][it % 3]

    # the pure-numpy tier is the slow oracle; diff it on small/mid inputs
    # only (the native/kernel tiers run at every size)
    diff_py = data.size <= 384 << 10

    # mt: native-vs-numpy tier diff both ways + the device paths
    blob = mt_encode(data, bits, n)
    assert mt_decode(blob, bits, n) == want, "mt host decode"
    if diff_py:
        assert blob == mt_encode_py(data, bits, n), "mt encode tier mismatch"
        assert mt_decode_py(blob, bits, n) == want, "mt numpy decode"
    if n in (32, 64):
        assert mt_decode_device(blob, bits, n) == want, "mt device decode"
        assert mt_decode(mt_encode_device(data, bits, n), bits, n) == want, "mt device encode"

    # block codec, same tier diff
    bblob = block_encode(data, bits, n)
    assert block_decode(bblob, bits, n) == want, "block host decode"
    if diff_py:
        assert bblob == block_encode_py(data, bits, n), "block encode tier mismatch"
        assert block_decode_py(bblob, bits, n) == want, "block numpy decode"

    # raw (single-shot lanes)
    if data.size <= 1 << 20:
        rblob = raw_encode(data, bits, n)
        assert raw_decode(rblob, bits, n) == want, "raw roundtrip"

    if n == 32:
        for wb in (16, 8):
            bb = blk32_encode_host(data, bits, wb)
            assert blk32_decode_host(bb, bits, wb) == want, f"blk32 {wb}w"

    # tpx (own format, host codec): v2 fixed geometry + v3 adaptive
    if bits <= 13 and data.size < 200_000:
        assert tpx_decode(tpx_encode(data, bits)) == want, "tpx v2"
        assert tpx_decode(tpx_encode_adaptive(data, 12)) == want, "tpx v3"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cases", type=int, default=500)
    ap.add_argument("--seed", type=int, default=20260817)
    ap.add_argument("--max-size", type=int, default=1_500_000)
    ap.add_argument("--max-fails", type=int, default=5)
    args = ap.parse_args()

    rng = np.random.default_rng(args.seed)
    fails = 0
    for it in range(args.cases):
        try:
            run_case(rng, it, args.max_size)
        except Exception as e:  # noqa: BLE001 — report and continue
            fails += 1
            print(f"FAIL it={it} seed={args.seed}: {type(e).__name__}: {e}", flush=True)
            traceback.print_exc()
            if fails > args.max_fails:
                break
        if it % 20 == 19:
            print(f"...{it + 1}/{args.cases} ok", flush=True)
    print(f"SOAK DONE, {fails} failures / {args.cases} cases (seed {args.seed})")
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
