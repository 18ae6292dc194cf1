"""Histogram model: normalization bit-parity with the C++ reference."""

import numpy as np
import pytest

from hsrans.models.histogram import complete_hist, make_hist, normalize_hist, observe_hist
from hsrans.models.tables import make_cumul_inv, make_dec3, make_dec_pack
from hsrans.runtime import native

from .conftest import GOLDEN

BITS = range(10, 16)


@pytest.mark.parametrize("bits", BITS)
def test_hist_matches_reference(golden_dir, golden_inputs, bits):
    for case, data in golden_inputs.items():
        golden = np.fromfile(golden_dir / f"{case}.hist_{bits}", dtype="<u2")
        ours = make_hist(data, bits)
        assert np.array_equal(ours.symbol_count, golden), case
        assert int(ours.symbol_count.sum(dtype=np.uint64)) == 1 << bits


@pytest.mark.parametrize("bits", [10, 12, 15])
def test_hist_native_matches_numpy(golden_inputs, bits):
    lib = native.load()
    if lib is None:
        pytest.skip("native library unavailable")
    for case, data in golden_inputs.items():
        counts_native = native.observe_hist(data)
        counts_np = observe_hist(data)
        assert np.array_equal(counts_native, counts_np)
        freq, cumul = native.normalize_hist(counts_np, data.size, bits)
        ours = normalize_hist(counts_np, data.size, bits)
        assert np.array_equal(freq, ours.symbol_count), case
        assert np.array_equal(cumul, ours.cumul), case


def test_normalize_edge_cases():
    # single symbol
    counts = np.zeros(256, dtype=np.uint32)
    counts[42] = 1000
    h = normalize_hist(counts, 1000, 12)
    assert h.symbol_count[42] == 4096 and h.symbol_count.sum(dtype=np.int64) == 4096
    # all 256 symbols at B=10: sum must still be exactly 1024 with none lost
    counts = np.arange(1, 257, dtype=np.uint32)
    h = normalize_hist(counts, int(counts.sum()), 10)
    assert int(h.symbol_count.sum(dtype=np.int64)) == 1024
    assert (h.symbol_count >= 1).all()


def test_tables_roundtrip():
    counts = np.zeros(256, dtype=np.uint32)
    counts[: 8] = [100, 50, 25, 12, 6, 3, 2, 1]
    h = normalize_hist(counts, int(counts.sum()), 12)
    inv = make_cumul_inv(h)
    assert inv.shape == (4096,)
    # every slot maps into its symbol's [cumul, cumul+freq) interval
    slots = np.arange(4096)
    syms = inv.astype(np.int64)
    assert (slots >= h.cumul[syms]).all()
    assert (slots < h.cumul[syms].astype(np.int64) + h.symbol_count[syms]).all()
    d3 = make_dec3(h)
    assert np.array_equal(d3["freq"], h.symbol_count[syms])
    pack = make_dec_pack(h)
    assert np.array_equal(pack & 0xFF, syms)
    assert np.array_equal((pack >> 8) & 0xFFF, h.cumul[syms])
    assert np.array_equal(pack >> 20, h.symbol_count[syms])


def test_complete_hist_rejects_bad_sum():
    freqs = np.zeros(256, dtype=np.uint16)
    freqs[0] = 4095
    assert complete_hist(freqs, 12) is None
