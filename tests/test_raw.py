"""Raw interleaved codecs: wire-format bit-parity with the C++ reference
plus roundtrip properties the reference can't test (tiny inputs)."""

import numpy as np
import pytest

from hsrans.models.histogram import make_hist, normalize_hist
from hsrans.ops.reference import raw_capacity, raw_decode_16w, raw_encode_16w

from .conftest import fnv1a, read_meta

LANES = (16, 32, 64)
BITS = (10, 11, 12, 13, 14, 15)

# big cases are covered by hash-only .meta files; keep runtime sane by
# hashing the flagship configs on every input and the full matrix on one.
FULL_MATRIX_CASES = ("text_63k", "tiny_130", "uniform_8k")
FLAGSHIP = ((64, 12), (32, 12), (16, 12), (64, 10), (64, 15))


def _golden_pairs(golden_inputs):
    for case, data in golden_inputs.items():
        for n in LANES:
            for bits in BITS:
                if case in FULL_MATRIX_CASES or (n, bits) in FLAGSHIP:
                    yield case, data, n, bits


def test_raw_encode_bit_parity(golden_dir, golden_inputs):
    checked = 0
    for case, data, n, bits in _golden_pairs(golden_inputs):
        meta = golden_dir / f"{case}.raw{n}_{bits}.meta"
        if not meta.exists():
            continue
        size, ref_hash = read_meta(meta)
        hist = make_hist(data, bits)
        blob = raw_encode_16w(data, hist, n)
        assert len(blob) == size, (case, n, bits, len(blob), size)
        assert fnv1a(blob) == ref_hash, (case, n, bits)
        checked += 1
    assert checked >= 30


def test_raw_decode_reference_blobs(golden_dir, golden_inputs):
    """Decode blobs produced by the C++ reference encoder directly."""
    checked = 0
    for case, data, n, bits in _golden_pairs(golden_inputs):
        bin_path = golden_dir / f"{case}.raw{n}_{bits}.bin"
        if not bin_path.exists():
            continue
        blob = bin_path.read_bytes()
        out = raw_decode_16w(blob, bits, n)
        assert out == data.tobytes(), (case, n, bits)
        checked += 1
    assert checked >= 10


@pytest.mark.parametrize("n", LANES)
def test_raw_roundtrip_edge_sizes(n):
    rng = np.random.default_rng(7)
    for length in (0, 1, 2, n - 1, n, n + 1, 2 * n - 1, 255, 4096, 100_001):
        data = np.minimum(rng.geometric(0.2, size=length) - 1, 255).astype(np.uint8)
        if length:
            hist = make_hist(data, 12)
        else:
            hist = normalize_hist(np.ones(256, dtype=np.uint32), 256, 12)
        blob = raw_encode_16w(data, hist, n)
        assert len(blob) <= raw_capacity(length, n)
        assert raw_decode_16w(blob, 12, n) == data.tobytes()


def test_raw_decode_rejects_malformed():
    assert raw_decode_16w(b"\x00" * 8, 12, 32) is None
    # wrong freq sum
    blob = bytearray(16 + 512 + 128 + 2)
    blob[0:8] = (2).to_bytes(8, "little")
    blob[8:16] = len(blob).to_bytes(8, "little")
    assert raw_decode_16w(bytes(blob), 12, 32) is None
