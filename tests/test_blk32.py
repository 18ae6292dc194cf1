"""32blk independent-substream codecs: parity + roundtrip."""

import numpy as np
import pytest

from hsrans.models.histogram import make_hist
from hsrans.ops.blk32 import blk32_capacity, blk32_decode, blk32_encode

from .conftest import fnv1a, read_meta

CASES = ("text_63k", "uniform_8k", "tiny_130", "skew_50k")


@pytest.mark.parametrize("word_bits,tag", [(16, "32blk16w"), (8, "32blk8w")])
@pytest.mark.parametrize("bits", (10, 12, 15))
def test_blk32_parity(golden_dir, golden_inputs, word_bits, tag, bits):
    for case in CASES:
        data = golden_inputs[case]
        size, ref_hash = read_meta(golden_dir / f"{case}.{tag}_{bits}.meta")
        hist = make_hist(data, bits)
        blob = blk32_encode(data, hist, word_bits)
        assert len(blob) == size and fnv1a(blob) == ref_hash, case
        assert blk32_decode(blob, bits, word_bits) == data.tobytes(), case


@pytest.mark.parametrize("word_bits", (16, 8))
def test_blk32_roundtrip_edges(word_bits):
    rng = np.random.default_rng(5)
    for length in (1, 31, 32, 33, 4096, 65537):
        data = np.minimum(rng.geometric(0.15, size=length) - 1, 255).astype(np.uint8)
        hist = make_hist(data, 12)
        blob = blk32_encode(data, hist, word_bits)
        assert len(blob) <= blk32_capacity(length, word_bits)
        assert blk32_decode(blob, 12, word_bits) == data.tobytes()


def test_blk32_malformed():
    assert blk32_decode(b"\0" * 10, 12, 16) is None
    assert blk32_decode(b"\0" * 2000, 12, 16) is None
