"""On-device histogram model: bit-exact parity with the host authority."""

import numpy as np
import pytest

jnp = pytest.importorskip("jax.numpy")
import jax  # noqa: E402

from hsrans.models.histogram import make_hist, normalize_hist, observe_hist
from hsrans.models.jax_hist import (
    make_dec3_device,
    make_hist_device,
    make_rank_tables_device,
    normalize_device,
    observe_device,
)
from hsrans.models.tables import make_dec3
from hsrans.ops.tpx import make_rank_tables


def _cases(rng):
    yield np.zeros(100, np.uint8)  # single symbol
    yield np.arange(256, dtype=np.uint8)  # flat
    yield rng.integers(0, 256, 10_000, dtype=np.int64).astype(np.uint8)
    yield np.minimum(rng.geometric(0.07, 50_000) - 1, 255).astype(np.uint8)  # skewed
    yield np.minimum(rng.geometric(0.60, 30_000) - 1, 255).astype(np.uint8)  # very skewed
    yield rng.choice([0, 3, 200], 7_777).astype(np.uint8)  # 3 symbols, rebalance heavy
    yield rng.integers(0, 2, 65_536, dtype=np.int64).astype(np.uint8)  # binary


def test_observe_device_matches_host():
    rng = np.random.default_rng(0)
    for data in _cases(rng):
        got = np.asarray(observe_device(jnp.asarray(data)))
        assert np.array_equal(got, observe_hist(data))


@pytest.mark.parametrize("bits", (10, 12, 15))
def test_normalize_device_bit_exact(bits):
    rng = np.random.default_rng(1)
    for data in _cases(rng):
        ref = make_hist(data, bits)
        freq, cumul = make_hist_device(jnp.asarray(data), bits=bits)
        assert np.array_equal(np.asarray(freq), ref.symbol_count), "freq mismatch"
        assert np.array_equal(np.asarray(cumul), ref.cumul), "cumul mismatch"


@pytest.mark.parametrize("bits", (10, 12))
def test_normalize_device_divisor_override(bits):
    """Block codecs pass a divisor different from sum(hist) — must match."""
    rng = np.random.default_rng(2)
    counts = rng.integers(0, 5000, 256, dtype=np.int64).astype(np.uint32)
    for divisor in (1 << 16, 12345, int(counts.sum())):
        ref = normalize_hist(counts, divisor, bits)
        freq, cumul = normalize_device(jnp.asarray(counts), jnp.int32(divisor), bits=bits)
        assert np.array_equal(np.asarray(freq), ref.symbol_count)
        assert np.array_equal(np.asarray(cumul), ref.cumul)


@pytest.mark.parametrize("bits", (10, 12))
def test_device_tables_match_host(bits):
    rng = np.random.default_rng(3)
    for data in list(_cases(rng))[:4]:
        ref = make_hist(data, bits)
        host3 = make_dec3(ref)
        dev3 = make_dec3_device(jnp.asarray(ref.symbol_count), jnp.asarray(ref.cumul), bits=bits)
        for k in ("sym", "freq", "cumul"):
            assert np.array_equal(np.asarray(dev3[k]), host3[k]), k
        host_rt = make_rank_tables(ref)
        dev_rt = make_rank_tables_device(jnp.asarray(ref.symbol_count), jnp.asarray(ref.cumul), bits=bits)
        assert np.array_equal(np.asarray(dev_rt["c0"]), host_rt["c0"])
        assert np.array_equal(np.asarray(dev_rt["bm"]), host_rt["bm"].view(np.uint32))
        assert np.array_equal(np.asarray(dev_rt["t1"]), host_rt["t1"].view(np.uint32))
        assert np.array_equal(np.asarray(dev_rt["t2"]), host_rt["t2"].view(np.uint32))
