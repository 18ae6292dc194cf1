"""On-device (jittable) histogram model: observe, normalize-to-2^B, tables.

The host numpy implementation (models/histogram.py) is the canonical wire
authority; this module provides the same operations as pure JAX so a fused
on-device pipeline never has to leave the chip.  `normalize_device`
reproduces the reference algorithm *exactly* (float32 scale + round, clamp,
heap-sorted steal/charity rebalance, hist.cpp:16-215) — including the
heap-sort tie-break permutation — so its output matches the host path
bit-for-bit (asserted in tests/test_jax_hist.py):

  * the heap sort runs as scalar lax loops (256 entries, once per table —
    latency-bound but tiny);
  * the reference's sequential steal/charity passes collapse to vectorized
    per-pass updates: within one pass every sorted position in
    [min_two, 256) is decremented unconditionally until the running sum
    hits 2^B, so a whole pass is `pass_count` decrements at consecutive
    sorted positions — a masked scatter-add, no inner loop.

Table builders are fully vectorized (scatter/cummax/cumsum), giving the
slot-indexed dec3 layout and the tpx rank-bucket tables on device.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


def observe_device(data: jax.Array) -> jax.Array:
    """Byte-frequency count on device. Returns u32[256]."""
    return jnp.bincount(data.astype(jnp.int32), length=256).astype(jnp.uint32)


def _heap_sort_indices(val: jax.Array) -> jax.Array:
    """Heap-sort 256 indices ascending by val, bit-exact to hist.cpp:110-144
    (the unstable tie-break permutation is wire-visible downstream)."""

    def sift_down(state):
        idx, n, i, done = state
        left, right = 2 * i + 1, 2 * i + 2
        largest = i
        largest = jnp.where((left < n) & (val[idx[left]] > val[idx[largest]]), left, largest)
        largest = jnp.where((right < n) & (val[idx[right]] > val[idx[largest]]), right, largest)
        swap = largest != i
        vi, vl = idx[i], idx[largest]
        idx = idx.at[i].set(jnp.where(swap, vl, vi)).at[largest].set(jnp.where(swap, vi, vl))
        return idx, n, jnp.where(swap, largest, i), ~swap

    def sift(idx, n, i):
        idx, _, _, _ = jax.lax.while_loop(lambda s: ~s[3], sift_down, (idx, n, i, False))
        return idx

    idx = jnp.arange(256, dtype=jnp.int32)
    idx = jax.lax.fori_loop(0, 128, lambda k, ix: sift(ix, 256, 127 - k), idx)

    def pop(k, ix):
        i = 255 - k
        v0, vi = ix[0], ix[i]
        ix = ix.at[0].set(vi).at[i].set(v0)
        return sift(ix, i, 0)

    return jax.lax.fori_loop(0, 256, pop, idx)


@partial(jax.jit, static_argnames=("bits",))
def normalize_device(hist: jax.Array, data_bytes: jax.Array, *, bits: int) -> tuple[jax.Array, jax.Array]:
    """Normalize counts to sum exactly 2^bits; returns (freq u16, cumul u16).

    Bit-exact to the reference/host algorithm (hist.cpp:16-215): float32
    scale semantics, >=1 clamp for present symbols, heap-sort order, and
    the steal/charity pass structure (each pass touches sorted positions
    [min_two, ...) in order until the sum is correct).
    """
    total = jnp.uint32(1 << bits)
    hist = hist.astype(jnp.uint32)
    mul = jnp.float32(1 << bits) / data_bytes.astype(jnp.float32)
    capped = (hist.astype(jnp.float32) * mul + jnp.float32(0.5)).astype(jnp.uint16)
    capped = jnp.where((capped == 0) & (hist != 0), jnp.uint16(1), capped).astype(jnp.int32)

    def rebalance(capped):
        order = _heap_sort_indices(capped)
        sorted_vals = lambda c: c[order]  # noqa: E731
        rank = jnp.arange(256, dtype=jnp.int32)

        def min_two(c, start):
            ge2 = (sorted_vals(c) >= 2) & (rank >= start)
            return jnp.where(ge2.any(), jnp.argmax(ge2), start)

        def steal_pass(state):
            c, s, mt = state
            mt = min_two(c, mt)
            n = jnp.minimum(256 - mt, s - jnp.int32(total))
            hit = (rank >= mt) & (rank < mt + n)
            c = c.at[order].add(-hit.astype(jnp.int32))
            return c, s - n, mt

        def charity_pass(state):
            c, s, mt = state
            mt = min_two(c, mt)
            n = jnp.minimum(256 - mt, jnp.int32(total) - s)
            hit = rank >= 256 - n
            c = c.at[order].add(hit.astype(jnp.int32))
            return c, s + n, mt

        s0 = capped.sum()
        c, _, _ = jax.lax.while_loop(lambda st: st[1] > total, steal_pass, (capped, s0, 0))
        s1 = c.sum()
        c, _, _ = jax.lax.while_loop(lambda st: st[1] < total, charity_pass, (c, s1, 0))
        return c

    capped = jax.lax.cond(capped.sum() != total, rebalance, lambda c: c, capped)
    freq = capped.astype(jnp.uint16)
    cumul = jnp.concatenate([jnp.zeros(1, jnp.uint16), jnp.cumsum(capped[:-1]).astype(jnp.uint16)])
    return freq, cumul


@partial(jax.jit, static_argnames=("bits",))
def make_hist_device(data: jax.Array, *, bits: int) -> tuple[jax.Array, jax.Array]:
    """observe + normalize, fully on device (reference: make_hist)."""
    counts = observe_device(data)
    return normalize_device(counts, jnp.int32(data.shape[0]), bits=bits)


@partial(jax.jit, static_argnames=("bits",))
def make_dec3_device(freq: jax.Array, cumul: jax.Array, *, bits: int) -> dict[str, jax.Array]:
    """Slot-indexed decode tables on device (flat dec3 layout).

    inv[slot] = the symbol whose [cumul, cumul + freq) span holds the slot:
    each symbol marks its first slot (a zero-frequency symbol shares the
    next symbol's first slot, where the larger index wins, or falls off the
    end) and a running max fills the span (vectorized `make_cumul_inv`).
    `cumul` must be the exclusive prefix sum of `freq`.
    """
    starts = jnp.zeros(1 << bits, jnp.int32).at[cumul.astype(jnp.int32)].max(
        jnp.arange(256, dtype=jnp.int32), mode="drop"
    )
    inv = jax.lax.cummax(starts)
    return {
        "sym": inv.astype(jnp.uint8),
        "freq": freq.astype(jnp.uint32)[inv],
        "cumul": cumul.astype(jnp.uint32)[inv],
    }


@partial(jax.jit, static_argnames=("bits",))
def make_rank_tables_device(freq: jax.Array, cumul: jax.Array, *, bits: int) -> dict[str, jax.Array]:
    """tpx rank-bucket decode tables on device (ops.tpx.make_rank_tables)."""
    total = 1 << bits
    slots = jnp.arange(total, dtype=jnp.uint32)
    incl = jnp.cumsum(freq.astype(jnp.uint32))
    inv = jnp.searchsorted(incl, slots, side="right").astype(jnp.int32)

    present = freq.astype(jnp.int32) > 0
    rank_of_sym = jnp.cumsum(present.astype(jnp.int32)) - present.astype(jnp.int32)
    inv_rank = rank_of_sym[inv]
    c0 = inv_rank[::32]
    first = jnp.concatenate([jnp.ones(1, dtype=bool), inv[1:] != inv[:-1]])
    bits_m = first.reshape(total // 32, 32).astype(jnp.uint32)
    bm = (bits_m << jnp.arange(32, dtype=jnp.uint32)[None, :]).sum(axis=1, dtype=jnp.uint32)

    n_present = present.sum()
    scatter_idx = jnp.where(present, rank_of_sym, 256)
    syms = jnp.arange(256, dtype=jnp.uint32)
    t1 = jnp.zeros(257, jnp.uint32).at[scatter_idx].set(syms | (freq.astype(jnp.uint32) << 8))[:256]
    t2 = jnp.zeros(257, jnp.uint32).at[scatter_idx].set(cumul.astype(jnp.uint32))[:256]
    del n_present
    return {"c0": c0, "bm": bm, "t1": t1, "t2": t2}
