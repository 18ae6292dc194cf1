"""Native C++ codecs vs the numpy wire authority: identical bytes.

The public ops functions dispatch to native/hsrans_codec.cpp when built;
these tests pin that dispatch to the pure-numpy `_py` bodies byte-for-byte
(encode) and output-for-output (decode), across lane widths, histogram
depths, and tail/RLE shapes.  Golden-vector tests (test_raw.py,
test_block_mt.py) separately pin both to the compiled C++ reference.
"""

from pathlib import Path

import numpy as np
import pytest

from hsrans.models.histogram import make_hist
from hsrans.ops import block, mt, reference
from hsrans.runtime import native

CORPUS = Path(__file__).parent / "corpus" / "corpus.bin"


def _native_or_skip():
    if native.load() is None:
        pytest.skip("native library unavailable")


def _data(size, off=0):
    return np.fromfile(CORPUS, np.uint8)[off : off + size]


@pytest.mark.parametrize("n", (16, 32, 64))
@pytest.mark.parametrize("bits", (10, 12, 15))
def test_raw_native_matches_numpy(n, bits):
    _native_or_skip()
    for size in (0, 63, 70001, 200_000):
        d = _data(size)
        a = reference.raw_encode_16w(d, make_hist(d, bits) if size else make_hist(np.zeros(1, np.uint8), bits), n)
        b = native.raw_encode(d, bits, n)
        assert a == b, f"size={size}"
        assert native.raw_decode(a, bits, n) == d.tobytes()
        assert reference.raw_decode_16w(b, bits, n) == d.tobytes()


@pytest.mark.parametrize("n", (32, 64))
@pytest.mark.parametrize("bits", (10, 12, 13, 15))
def test_block_native_matches_numpy(n, bits):
    _native_or_skip()
    d = _data(200_000, off=3 << 20)  # spans the corpus RLE run (singles)
    a = block.block_encode_py(d, bits, n)
    assert native.block_encode(d, bits, n) == a
    assert native.block_decode(a, bits, n) == d.tobytes()
    assert block.block_decode_py(a, bits, n) == d.tobytes()


@pytest.mark.parametrize("n", (32, 64))
@pytest.mark.parametrize("bits", (12, 15))
def test_mt_native_matches_numpy(n, bits):
    _native_or_skip()
    d = _data(200_001, off=3 << 20)
    a = mt.mt_encode_py(d, bits, n)
    assert native.mt_encode(d, bits, n) == a
    assert native.mt_decode(a, bits, n) == d.tobytes()  # pooled fan-out
    assert native.mt_decode(a, bits, n, threads=1) == d.tobytes()
    assert mt.mt_decode_py(a, bits, n) == d.tobytes()


def test_native_decode_rejects_malformed():
    _native_or_skip()
    d = _data(70_000)
    blob = bytearray(native.block_encode(d, 12, 64))
    assert native.block_decode(bytes(blob[: len(blob) // 2]), 12, 64) is None
    blob[16 + 300] ^= 0xFF  # corrupt a freq byte: sum != 2^B -> reject
    assert native.block_decode(bytes(blob), 12, 64) is None
    mt_blob = native.mt_encode(d, 12, 64)
    assert native.mt_decode(mt_blob[:40], 12, 64) is None


def test_public_ops_dispatch_native():
    """The public block/mt/raw entry points return authority bytes."""
    _native_or_skip()
    d = _data(100_000)
    assert block.block_encode(d, 12, 64) == block.block_encode_py(d, 12, 64)
    assert mt.mt_encode(d, 12, 64) == mt.mt_encode_py(d, 12, 64)
    assert reference.raw_encode(d, 12, 64) == reference.raw_encode_16w(d, make_hist(d, 12), 64)
    assert block.block_decode(block.block_encode(d, 12, 64), 12, 64) == d.tobytes()


@pytest.mark.parametrize("wb", (16, 8))
@pytest.mark.parametrize("bits", (10, 12, 15))
def test_blk32_native_matches_numpy(wb, bits):
    _native_or_skip()
    from hsrans.ops import blk32

    for size in (0, 31, 70001):
        d = _data(size, off=1 << 20)
        a = blk32.blk32_encode(d, make_hist(d if size else np.zeros(1, np.uint8), bits), wb)
        assert native.blk32_encode(d, bits, wb) == a, f"size={size}"
        assert native.blk32_decode(a, bits, wb) == d.tobytes()
        assert blk32.blk32_decode(a, bits, wb) == d.tobytes()


def test_native_incompressible_data():
    """Uniform-random input: the stream is slightly LARGER than the input
    (ratio ~1.0002), which overflowed the original size/2-word emission
    scratch. Covers the worst-case sizing of every native encoder."""
    _native_or_skip()
    rng = np.random.default_rng(5)
    d = rng.integers(0, 256, 1_000_000, dtype=np.uint8).astype(np.uint8)
    for n in (16, 32, 64):
        blob = native.raw_encode(d, 12, n)
        assert native.raw_decode(blob, 12, n) == d.tobytes()
    for enc, dec in ((native.block_encode, native.block_decode), (native.mt_encode, native.mt_decode)):
        blob = enc(d, 12, 64)
        assert len(blob) > d.size  # genuinely incompressible
        assert dec(blob, 12, 64) == d.tobytes()
    for wb in (16, 8):
        assert native.blk32_decode(native.blk32_encode(d, 12, wb), 12, wb) == d.tobytes()
    assert native.block_encode(d, 12, 64) == block.block_encode_py(d, 12, 64)


def test_native_mt_rejects_wrapping_offset():
    """A crafted writeHeadOffset near 2^64 must not wrap the read cursor
    past the bound check into a heap under-read; the walker rejects any
    forward skip that leaves the stream."""
    import struct

    _native_or_skip()
    d = _data(70_001)
    blob = bytearray(native.mt_encode(d, 12, 64))
    blob[24:32] = struct.pack("<Q", 2**64 - 20)  # first coded block's offset
    assert native.mt_decode(bytes(blob), 12, 64) is None
    blob[24:32] = struct.pack("<Q", 2**40)  # far past the stream, no wrap
    assert native.mt_decode(bytes(blob), 12, 64) is None


def test_native_mt_unaligned_block_sizes():
    """Coded blocks whose size % n != 0 (format-valid via a custom plan):
    the sequential oracle resolves the ceil-group overshoot by decode order
    (the later block overwrites), so the concurrent native path must clamp
    every worker to its own output range — an overshoot would clobber a
    following RLE block (threads=1) or race a coded one (advisor r2, high)."""
    from hsrans.ops.planner import BlockPlan

    _native_or_skip()
    rng = np.random.default_rng(7)
    part0 = rng.integers(0, 50, 10_000, dtype=np.uint8)
    part1 = np.full(48, 7, dtype=np.uint8)
    part2 = rng.integers(0, 200, 20_001, dtype=np.uint8)
    d = np.concatenate([part0, part1, part2])
    plan = [
        BlockPlan(0, part0.size, False, 0, make_hist(part0, 12).symbol_count),
        BlockPlan(part0.size, part1.size, True, 7, None),
        BlockPlan(10_048, part2.size, False, 0, make_hist(part2, 12).symbol_count),
    ]
    blob = mt.mt_encode_py(d, 12, 64, plan=plan)
    assert mt.mt_decode_py(blob, 12, 64) == d.tobytes()
    for threads in (1, 0):
        assert native.mt_decode(blob, 12, 64, threads=threads) == d.tobytes(), f"threads={threads}"


def test_native_mt_unaligned_many_blocks_threaded():
    """Many adjacent unaligned coded blocks decoded by the thread pool: any
    cross-block overshoot races a neighbor's writes (flaky corruption in the
    pre-fix build ~50% of runs)."""
    from hsrans.ops.planner import BlockPlan

    _native_or_skip()
    rng = np.random.default_rng(11)
    bs = 997  # not a multiple of 32 or 64
    nblk = 200
    # total size is a multiple of bs: a block boundary inside the final
    # n-byte tail window is not representable (the walk stops at the first
    # block entering that window — mt_rANS32x64_16w_decode.cpp:209-214)
    d = rng.integers(0, 64, bs * nblk, dtype=np.uint8)
    for n in (32, 64):
        plan = []
        pos = 0
        while pos < d.size:
            size = min(bs, d.size - pos)
            seg = d[pos : pos + size]
            plan.append(BlockPlan(pos, size, False, 0, make_hist(seg, 12).symbol_count))
            pos += size
        blob = mt.mt_encode_py(d, 12, n, plan=plan)
        assert mt.mt_decode_py(blob, 12, n) == d.tobytes()
        for _ in range(5):
            assert native.mt_decode(blob, 12, n, threads=8) == d.tobytes()


def test_decode_forged_rawlength_returns_none():
    """A tiny blob with a forged (huge but sub-cap) rawLength must return
    None, not raise MemoryError from the output allocation (advisor r2)."""
    import struct

    _native_or_skip()
    d = _data(600)
    blob = bytearray(mt.mt_encode(d, 12, 64))
    blob[0:8] = struct.pack("<Q", (1 << 40) - 1)  # ~1 TiB claim, 600 B blob
    out = native.mt_decode(bytes(blob), 12, 64)
    assert out is None or out != d.tobytes()  # never raises


@pytest.mark.parametrize("bits", [13, 14])
def test_native_high_bits_pack_boundary(bits):
    """Both hi-bits dec_pack paths at B>=13: a near-uniform input keeps every
    frequency under 2^(24-B) (single-gather packed layout engages) while a
    heavily skewed one exceeds it (slot-fc / dependent fallback).  Wire bytes
    and roundtrips must be identical either way."""
    rng = np.random.default_rng(bits)
    flat = rng.integers(0, 256, 200_000).astype(np.uint8)  # maxfreq ~ 2^B/256
    skew = np.concatenate(
        [np.zeros(150_000, np.uint8), rng.integers(0, 256, 50_000).astype(np.uint8)]
    )  # symbol 0 takes >> 2^(24-bits) of the mass
    for data in (flat, skew):
        for fam_enc, fam_dec in (
            (reference.raw_encode, reference.raw_decode),
            (block.block_encode, block.block_decode),
            (mt.mt_encode, mt.mt_decode),
        ):
            blob = fam_enc(data, bits, 64)
            assert fam_dec(blob, bits, 64) == data.tobytes()
        from hsrans.ops import blk32

        for wb in (16, 8):
            bb = blk32.blk32_encode_host(data, bits, wb)
            assert blk32.blk32_decode_host(bb, bits, wb) == data.tobytes()
            assert bb == blk32.blk32_encode(data, make_hist(data, bits), wb)
