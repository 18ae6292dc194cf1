"""mt device encode (ops/raw_jax.encode_section batched over blocks): valid
reference-format blobs that the host oracle and the device decode read back."""

import numpy as np
import pytest

from hsrans.ops.mt import mt_decode
from hsrans.parallel.sharded import mt_decode_device, mt_encode_device, uniform_plan


@pytest.mark.parametrize(
    "name,size,block",
    [
        ("text", 200_000, 4096),
        ("odd-tail", 123_457, 4096),
        ("8k-blocks", 100_000, 8192),
        ("sub-block", 700, 4096),
        ("empty", 0, 4096),
    ],
)
def test_mt64_encode_kernel(name, size, block):
    from tools.gen_inputs import text_like

    rng = np.random.default_rng(13)
    data = text_like(rng, size) if size else np.zeros(0, np.uint8)
    blob = mt_encode_device(data, 12, 64, plan=uniform_plan(data, 12, 64, block))
    # decodes through the oracle AND the device decoder
    assert mt_decode(blob, 12, 64) == data.tobytes()
    assert mt_decode_device(blob, 12, 64) == data.tobytes()


def test_mt64_encode_kernel_rle():
    data = np.concatenate([np.full(60_000, 7, np.uint8), np.arange(5000, dtype=np.int64).astype(np.uint8)])
    blob = mt_encode_device(data, 12, 64, plan=uniform_plan(data, 12, 64, 4096))
    assert mt_decode(blob, 12, 64) == data.tobytes()


def test_mt64_encode_kernel_many_blocks():
    """Many blocks, the last one carrying an unaligned tail."""
    from tools.gen_inputs import text_like

    rng = np.random.default_rng(31)
    data = text_like(rng, 136 * 4096 + 100)  # 136 kernel blocks at 4 KiB
    blob = mt_encode_device(data, 12, 64, plan=uniform_plan(data, 12, 64, 4096))
    assert mt_decode(blob, 12, 64) == data.tobytes()
    assert mt_decode_device(blob, 12, 64) == data.tobytes()


def test_mt64_encode_planner_plan():
    """Greedy-planner plans (the reference's variable 2^16+ block sizes):
    fresh-state blocks stay valid mt wire and roundtrip through the oracle
    and device decoders."""
    from pathlib import Path

    from hsrans.ops.planner import plan_blocks

    corpus = Path(__file__).parent / "corpus" / "corpus.bin"
    data = np.fromfile(corpus, np.uint8)[: 512 * 1024]
    plan = plan_blocks(data, 12, "mt", 64)
    assert len({r.size for r in plan}) >= 1 and max(r.size for r in plan) >= 1 << 16
    blob = mt_encode_device(data, 12, 64, plan=plan)
    assert mt_decode(blob, 12, 64) == data.tobytes()
    assert mt_decode_device(blob, 12, 64) == data.tobytes()


def test_mt64_encode_plan_with_rle_rows():
    """Plans with single-symbol rows: RLE indicators between coded blocks."""
    from hsrans.ops.planner import BlockPlan

    rng = np.random.default_rng(41)
    from tools.gen_inputs import text_like

    data = np.concatenate([text_like(rng, 8192), np.full(4096, 7, np.uint8), text_like(rng, 9000)])
    plan = [
        BlockPlan(0, 8192, False, 0, None),
        BlockPlan(8192, 4096, True, 7, None),
        BlockPlan(12288, 9000, False, 0, None),
    ]
    blob = mt_encode_device(data, 12, 64, plan=plan)
    assert mt_decode(blob, 12, 64) == data.tobytes()


@pytest.mark.parametrize("block", (16384, 32768))
def test_mt64_encode_segmented_large_blocks(block):
    """Large blocks: 256 and 512 lane-group steps per block."""
    from tools.gen_inputs import text_like

    rng = np.random.default_rng(22)
    data = text_like(rng, 150_000)
    blob = mt_encode_device(data, 12, 64, plan=uniform_plan(data, 12, 64, block))
    assert mt_decode(blob, 12, 64) == data.tobytes()
    assert mt_decode_device(blob, 12, 64) == data.tobytes()


@pytest.mark.parametrize("bits", (13, 15))
def test_mt64_encode_kernel_high_bits(bits):
    """B>12 device encode."""
    from pathlib import Path

    data = np.fromfile(Path(__file__).parent / "corpus" / "corpus.bin", np.uint8)[:150_000]
    blob = mt_encode_device(data, bits, 64, plan=uniform_plan(data, bits, 64, 4096))
    assert mt_decode(blob, bits, 64) == data.tobytes()
    assert mt_decode_device(blob, bits, 64) == data.tobytes()
