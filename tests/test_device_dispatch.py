"""Tier selection, the compile cache's place, and the pieces around the
decode kernel: lane order, slot tables and row staging."""

from types import SimpleNamespace

import numpy as np
import pytest

from hsrans.runtime import device


@pytest.mark.parametrize(
    "platform,tier,interpret",
    [("gpu", "gpu", False), ("cpu", "interpret", True)],
)
def test_detect_tier_per_platform(monkeypatch, platform, tier, interpret):
    import jax

    fake = [SimpleNamespace(platform=platform, device_kind=f"{platform} kind")] * 2
    monkeypatch.setattr(jax, "devices", lambda *a: fake)
    device.detect.cache_clear()
    try:
        cap = device.detect()
        assert (cap.platform, cap.tier, cap.num_devices) == (platform, tier, 2)
        assert cap.pallas_interpret is interpret
        assert f"tier '{tier}'" in device.banner(cap)
    finally:
        device.detect.cache_clear()


@pytest.mark.parametrize("platform", ("neuron", "rocm-unknown", "METAL"))
def test_detect_unknown_platform_raises(monkeypatch, platform):
    import jax

    monkeypatch.setattr(jax, "devices", lambda *a: [SimpleNamespace(platform=platform, device_kind="x")])
    device.detect.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="unsupported JAX platform"):
            device.detect()
    finally:
        device.detect.cache_clear()


def test_compile_cache_dir_default(monkeypatch):
    from pathlib import Path

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    repo = Path(__file__).resolve().parent.parent
    assert device.compile_cache_dir() == str(repo / ".jax_cache")
    updates = {}
    fake = SimpleNamespace(config=SimpleNamespace(jax_compilation_cache_dir=None, update=updates.__setitem__))
    device._enable_compile_cache(fake)
    assert updates == {"jax_compilation_cache_dir": str(repo / ".jax_cache")}


def test_compile_cache_dir_from_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert device.compile_cache_dir() == str(tmp_path)
    # JAX has read the variable itself: nothing else is set in code
    updates = {}
    fake = SimpleNamespace(config=SimpleNamespace(jax_compilation_cache_dir=str(tmp_path), update=updates.__setitem__))
    device._enable_compile_cache(fake)
    assert updates == {}


@pytest.mark.parametrize("n", (32, 64))
def test_lane_bytes_is_idx2idx(n):
    import jax.numpy as jnp

    from hsrans.kernels.mt_decode import lane_bytes
    from hsrans.rans import IDX2IDX

    assert np.array_equal(np.asarray(lane_bytes(jnp.arange(n, dtype=jnp.int32))), IDX2IDX[n])


@pytest.mark.parametrize("bits", range(10, 16))
def test_packed_tables_match_dec3(bits):
    """Device slot tables equal the host dec3 layout, and the packed kernel
    words decode back to the same fields."""
    import jax.numpy as jnp

    from hsrans.kernels.mt_decode import dec3_rows, packed_tables
    from hsrans.models.histogram import normalize_hist
    from hsrans.models.tables import make_dec3

    rng = np.random.default_rng(bits)
    hists = []
    for k in range(3):
        counts = rng.integers(0, 50, 256).astype(np.uint32)
        counts[rng.random(256) < 0.5 * k] = 0  # sparse alphabets, zero runs at both ends
        counts[rng.integers(0, 256)] += 1
        hists.append(normalize_hist(counts, int(counts.sum()), bits))
    freq = np.stack([h.symbol_count for h in hists])
    t = dec3_rows(jnp.asarray(freq), bits)
    sym, f, cumul = (np.asarray(t[k]) for k in ("sym", "freq", "cumul"))
    words = [np.asarray(a).reshape(3, -1) for a in packed_tables(jnp.asarray(freq), bits)]
    slots = np.arange(1 << bits)
    for i, h in enumerate(hists):
        want = make_dec3(h)
        assert np.array_equal(sym[i], want["sym"])
        assert np.array_equal(f[i], want["freq"])
        assert np.array_equal(cumul[i], want["cumul"])
        w = words[0][i].astype(np.int64)
        if bits <= 12:
            assert np.array_equal(w & 0xFF, want["sym"])
            assert np.array_equal((w >> 8) & 0xFFF, slots - want["cumul"])
            assert np.array_equal((w >> 20) + 1, want["freq"])
        else:
            assert np.array_equal(words[1][i], want["sym"])
            assert np.array_equal(w & 0xFFFF, slots - want["cumul"])
            assert np.array_equal((w >> 16) + 1, want["freq"])


@pytest.mark.parametrize("g,n_dev", [(4, 1), (2, 4), (1, 8)])
def test_stage_rows_order_and_padding(g, n_dev):
    """Rows are sorted longest first, dealt to devices tile by tile, and
    padded with rows that decode nothing; the final block runs to the end."""
    from hsrans.ops.mt import block_index, mt_encode
    from hsrans.parallel.sharded import stage_rows, uniform_plan
    from tools.gen_inputs import text_like

    data = text_like(np.random.default_rng(5), 9 * 1024 + 3000 + 77)
    plan = uniform_plan(data, 12, 64, 1024)
    blob = mt_encode(data, 12, 64, plan=plan)
    rows = stage_rows(blob, 12, 64, g, n_dev)
    _, _, blocks = block_index(blob, 64)
    coded = len(blocks)
    r = rows.sizes.size
    assert r % (g * n_dev) == 0 and r >= coded
    assert sorted(rows.sizes[rows.sizes > 0].tolist()) == sorted(
        [b.size for b in blocks[:-1]] + [data.size - blocks[-1].out_start]
    )
    assert np.array_equal(rows.steps, -(-rows.sizes // 64))
    assert (rows.freq.sum(axis=1) == 1 << 12).all()
    # device d holds tiles d, d + n_dev, ... of the longest-first order
    per_dev = rows.steps.reshape(n_dev, -1, g)
    merged = per_dev.transpose(1, 0, 2).reshape(-1)
    assert np.array_equal(merged, np.sort(merged)[::-1])
    assert rows.out_len > rows.length == data.size
