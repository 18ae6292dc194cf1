"""tpx tile-parallel format: the host codec (numpy and native)."""

import numpy as np
import pytest

from hsrans.models.histogram import make_hist
from hsrans.ops.tpx import TpxParams, make_rank_tables, tpx_decode, tpx_encode
from hsrans.models.tables import make_cumul_inv
from hsrans.ops.tpx import _popcount


def _cases(rng):
    from tools.gen_inputs import text_like

    return [
        ("text", text_like(rng, 1_500_000)),
        ("rle+text", np.concatenate([np.full(500_000, 3, np.uint8), text_like(rng, 400_000)])),
        ("geom", np.minimum(rng.geometric(0.25, 800_000) - 1, 255).astype(np.uint8)),
        ("tiny", text_like(rng, 777)),
        ("empty", np.zeros(0, np.uint8)),
    ]


@pytest.mark.parametrize("bits", (10, 12))
def test_tpx_numpy_roundtrip(bits):
    rng = np.random.default_rng(4)
    for name, data in _cases(rng):
        blob = tpx_encode(data, bits)
        assert tpx_decode(blob) == data.tobytes(), name
        assert tpx_decode(blob, use_rank_tables=True) == data.tobytes(), name


@pytest.mark.parametrize("bits", (10, 12, 15))
def test_rank_tables_exact(bits):
    """Bucketed-rank lookup reproduces cumulInv for adversarial hists."""
    rng = np.random.default_rng(5)
    for trial in range(20):
        n_sym = int(rng.integers(1, 257))
        counts = np.zeros(256, np.uint32)
        syms = rng.choice(256, size=n_sym, replace=False)
        counts[syms] = rng.integers(1, 1000, n_sym)
        hist = make_hist(np.repeat(np.arange(256, dtype=np.uint8), counts), bits)
        inv = make_cumul_inv(hist)
        rt = make_rank_tables(hist)
        c0, bm = rt["c0"], rt["bm"].view(np.uint32)
        t1, t2 = rt["t1"].view(np.uint32), rt["t2"].view(np.uint32)
        slots = np.arange(1 << bits, dtype=np.uint32)
        k = (slots >> 5).astype(np.int64)
        m = (np.uint32(2) << (slots & np.uint32(31))) - np.uint32(2)
        rank = (c0[k].astype(np.uint32) + _popcount(bm[k] & m)).astype(np.int64)
        sym = t1[rank] & np.uint32(0xFF)
        assert np.array_equal(sym, inv.astype(np.uint32)), trial
        assert np.array_equal(t1[rank] >> 8, hist.symbol_count[inv].astype(np.uint32))
        assert np.array_equal(t2[rank], hist.cumul[inv].astype(np.uint32))


def test_tpx_header_rejects_garbage():
    assert tpx_decode(b"NOTTPX00" + b"\0" * 64) is None
    assert tpx_decode(b"") is None


def test_tpx_ratio_parity_on_real_corpus():
    """VERDICT item: pin the ratio claims to real data.  On the checked-in
    mixed text/binary corpus the block codec (bit-exact reference wire)
    measures 0.603; tpx v2 must stay within 12% of it, and the v1
    pathology (rectangular padding -> ratio 1.75) must never return."""
    from pathlib import Path

    from hsrans.ops.block import block_encode
    from hsrans.ops.tpx import tpx_decode, tpx_encode

    data = np.fromfile(Path(__file__).parent / "corpus" / "corpus.bin", np.uint8)
    blob_block = block_encode(data, 12, 64)
    blob_tpx = tpx_encode(data, 12)
    r_block = len(blob_block) / data.size
    r_tpx = len(blob_tpx) / data.size
    assert r_block < 0.62, r_block  # reference-wire ratio on this corpus
    assert r_tpx < r_block * 1.12, (r_tpx, r_block)
    assert tpx_decode(blob_tpx) == data.tobytes()


def test_tpx_auto_geometry_small_inputs():
    """Small inputs get shrunk row counts: blobs stay near-entropy-sized
    instead of paying a fixed 16 MiB megablock's headers."""
    from hsrans.ops.tpx import TpxParams, tpx_decode, tpx_encode
    from tools.gen_inputs import text_like

    rng = np.random.default_rng(77)
    for size in (1000, 20_000, 300_000):
        data = text_like(rng, size)
        blob = tpx_encode(data, 12)
        # floor = minimum geometry's state snapshot (8 rows x 128 lanes x 4)
        assert len(blob) < size * 0.95 + 6000, (size, len(blob))
        assert tpx_decode(blob) == data.tobytes()
    p = TpxParams.auto(20_000, 12)
    assert p.rows == 8 and p.mega_bytes >= 20_000


def test_tpx_adaptive_v3_roundtrip_and_ratio():
    """v3 per-mega geometry: planner-informed cuts keep the hist-local
    ratio win at 4x the ratio goal's chain count (128 rows vs 32)."""
    from pathlib import Path

    from hsrans.ops.tpx import tpx_decode, tpx_encode_adaptive, tpx_parse

    data = np.fromfile(Path(__file__).parent / "corpus" / "corpus.bin", np.uint8)
    blob = tpx_encode_adaptive(data, 12)
    ratio = len(blob) / data.size
    assert ratio <= 0.60, ratio
    p, length, megas = tpx_parse(blob)
    assert length == data.size
    assert all(m.rows >= 128 for m in megas), [m.rows for m in megas]
    assert tpx_decode(blob) == data.tobytes()


def test_tpx_adaptive_v3_mixed_geometries():
    """Homogeneous + heterogeneous regions produce distinct per-mega
    geometries in one blob, and it decodes."""
    from hsrans.ops.tpx import tpx_decode, tpx_encode_adaptive, tpx_parse
    from tools.gen_inputs import text_like

    rng = np.random.default_rng(53)
    # 5 MiB homogeneous zipf span + 1.5 MiB text (content shift)
    ranks = rng.zipf(1.2, 5 << 20)
    homog = ((ranks - 1) % 200).astype(np.uint8)
    data = np.concatenate([homog, text_like(rng, 3 << 19)])
    blob = tpx_encode_adaptive(data, 12)
    p, length, megas = tpx_parse(blob)
    geoms = {(m.rows, m.steps) for m in megas}
    assert len(geoms) >= 2, geoms  # speed geometry + hist-local geometry
    assert tpx_decode(blob) == data.tobytes()
