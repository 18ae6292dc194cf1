"""JAX device-path codecs vs the numpy oracle and reference goldens."""

import numpy as np
import pytest

from hsrans.models.histogram import make_hist
from hsrans.ops.raw_jax import raw_decode_jax, raw_encode_jax
from hsrans.ops.reference import raw_encode_16w

from .conftest import fnv1a, read_meta


@pytest.mark.parametrize("n", (16, 32, 64))
@pytest.mark.parametrize("bits", (10, 12, 15))
def test_jax_encode_matches_oracle(n, bits):
    rng = np.random.default_rng(11)
    for length in (1, n - 1, n, 1000, 30_000):
        data = np.minimum(rng.geometric(0.1, size=length) - 1, 255).astype(np.uint8)
        hist = make_hist(data, bits)
        assert raw_encode_jax(data, hist, n) == raw_encode_16w(data, hist, n)


@pytest.mark.parametrize("n", (16, 32, 64))
@pytest.mark.parametrize("bits", (10, 12, 15))
def test_jax_roundtrip(n, bits):
    rng = np.random.default_rng(13)
    data = rng.choice(
        np.arange(32, dtype=np.uint8), size=50_001, p=np.arange(32, 0, -1) / np.arange(32, 0, -1).sum()
    )
    hist = make_hist(data, bits)
    blob = raw_encode_jax(data, hist, n)
    assert raw_decode_jax(blob, bits, n) == data.tobytes()


def test_jax_golden_parity(golden_dir, golden_inputs):
    """JAX encode is bit-identical to the C++ reference on a golden case,
    and JAX decode round-trips the reference's own blob."""
    data = golden_inputs["text_63k"]
    for n, bits in ((64, 12), (32, 12), (16, 14)):
        size, ref_hash = read_meta(golden_dir / f"text_63k.raw{n}_{bits}.meta")
        hist = make_hist(data, bits)
        blob = raw_encode_jax(data, hist, n)
        assert len(blob) == size and fnv1a(blob) == ref_hash
        bin_path = golden_dir / f"text_63k.raw{n}_{bits}.bin"
        assert raw_decode_jax(bin_path.read_bytes(), bits, n) == data.tobytes()
