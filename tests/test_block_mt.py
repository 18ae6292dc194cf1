"""Adaptive block and mt codecs: planner + wire bit-parity + roundtrips."""

import numpy as np
import pytest

from hsrans.ops.block import block_capacity, block_decode, block_encode
from hsrans.ops.mt import block_index, mt_capacity, mt_decode, mt_encode
from hsrans.ops.planner import plan_blocks, plan_blocks_py
from hsrans.runtime import native

from .conftest import fnv1a, read_meta

BLOCK_CONFIGS = [("block64", 64, (10, 12, 15)), ("block32", 32, (12,))]
MT_CONFIGS = [("mt64", 64, (10, 12, 15)), ("mt32", 32, (12,))]
CASES = ("mixed_2m", "rle_1m", "text_1m", "text_63k", "tiny_130", "skew_50k", "uniform_8k")


@pytest.mark.parametrize("tag,n,bits_list", BLOCK_CONFIGS)
def test_block_parity(golden_dir, golden_inputs, tag, n, bits_list):
    for case in CASES:
        data = golden_inputs[case]
        for bits in bits_list:
            meta = golden_dir / f"{case}.{tag}_{bits}.meta"
            if not meta.exists():
                continue
            size, ref_hash = read_meta(meta)
            blob = block_encode(data, bits, n)
            assert len(blob) == size and fnv1a(blob) == ref_hash, (case, bits)
            assert block_decode(blob, bits, n) == data.tobytes(), (case, bits)


@pytest.mark.parametrize("tag,n,bits_list", MT_CONFIGS)
def test_mt_parity(golden_dir, golden_inputs, tag, n, bits_list):
    for case in CASES:
        data = golden_inputs[case]
        for bits in bits_list:
            meta = golden_dir / f"{case}.{tag}_{bits}.meta"
            if not meta.exists():
                continue
            size, ref_hash = read_meta(meta)
            blob = mt_encode(data, bits, n)
            assert len(blob) == size and fnv1a(blob) == ref_hash, (case, bits)
            assert mt_decode(blob, bits, n) == data.tobytes(), (case, bits)


def test_planner_python_matches_native(golden_inputs):
    if native.load() is None:
        pytest.skip("native library unavailable")
    data = golden_inputs["mixed_2m"]
    for mode, n in (("block", 64), ("mt", 64), ("block", 32)):
        a = plan_blocks(data, 12, mode, n)
        b = plan_blocks_py(data, 12, mode, n)
        assert len(a) == len(b), mode
        for x, y in zip(a, b):
            assert (x.start, x.size, x.is_single) == (y.start, y.size, y.is_single), mode
            if not x.is_single:
                assert np.array_equal(x.freq, y.freq), mode


def test_block_index_seeks():
    rng = np.random.default_rng(3)
    parts = [np.full(200_000, 7, dtype=np.uint8), rng.integers(40, 80, 300_000).astype(np.uint8)]
    data = np.concatenate(parts)
    blob = mt_encode(data, 12, 64)
    idx = block_index(blob, 64)
    assert idx is not None
    length, _, blocks = idx
    assert length == data.size
    assert blocks[0].is_single and blocks[0].symbol == 7
    # coverage is contiguous and complete
    pos = 0
    for b in blocks:
        assert b.out_start == pos
        pos += b.size
    assert pos >= length - 64


def test_capacities():
    assert block_capacity(1 << 20, 64) > (1 << 20)
    assert mt_capacity(1 << 20, 64) > (1 << 20)


@pytest.mark.parametrize("codec_enc,codec_dec,n", [(block_encode, block_decode, 64), (mt_encode, mt_decode, 64)])
def test_adaptive_roundtrip_edges(codec_enc, codec_dec, n):
    rng = np.random.default_rng(17)
    for length in (1, 63, 64, 65, 100_000):
        data = np.minimum(rng.geometric(0.3, size=length) - 1, 255).astype(np.uint8)
        blob = codec_enc(data, 12, n)
        assert codec_dec(blob, 12, n) == data.tobytes()


def test_block_malformed():
    assert block_decode(b"\0" * 4, 12, 64) is None
    assert mt_decode(b"\0" * 4, 12, 64) is None


@pytest.mark.parametrize("fam", ("mt", "block"))
def test_n16_falls_back_to_numpy_tier(fam):
    """n=16 mt/block is a generalization past the reference's widths: the
    native tier rejects it, so the dispatch must route to the numpy
    authority instead of reading -1 as malformed (soak-found bug)."""
    from tools.gen_inputs import text_like

    rng = np.random.default_rng(71)
    data = text_like(rng, 60_000)
    if fam == "mt":
        from hsrans.ops.mt import mt_decode, mt_encode

        blob = mt_encode(data, 12, 16)
        assert mt_decode(blob, 12, 16) == data.tobytes()
    else:
        from hsrans.ops.block import block_decode, block_encode

        blob = block_encode(data, 12, 16)
        assert block_decode(blob, 12, 16) == data.tobytes()
