"""Jittable (XLA) rANS 16w codecs: the plain device path.

Design notes (not a translation of the reference's SIMD):

* The interleaved-lane state machine is a `lax.scan` over symbol groups.
  All lane-parallel work (slot extraction, table gathers, state update,
  renormalization) is vectorized over a trailing lane axis of width N and
  an optional leading batch axis of B independent streams — the batch axis
  is what fills the device (64 lanes alone would waste it).
* Renormalization replaces the reference's movemask/popcount/shuffle-LUT
  stream compaction (rANS32x32_16w.cpp:1237-1266) with
  mask -> exclusive-prefix-sum -> dynamic gather of the word stream, which
  is the natural vector formulation.
* The decode table is the flat slot-indexed `dec3` layout (hist.cpp:272-289)
  — one gather per field, no dependent lookup chain.
* Encode runs the scan over groups in reverse and materializes (word, emit)
  pairs; the forward wire stream is the reversed emission sequence, i.e.
  (group ascending, lane ascending) — compacted with a cumsum + scatter.
  Division by freq uses uint32 arithmetic (XLA lowers it); a reciprocal
  path can replace it if it shows up in profiles.

All state arithmetic is uint32: states live in [0, 2^31), and the largest
intermediate (EncodeEmitPoint * freq) is exactly 2^31, so uint32 is safe
and int32 is not.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..rans import DECODE_CONSUME_POINT_16, IDX2IDX, INV_IDX2IDX, encode_emit_point_16


def _exclusive_cumsum(x: jnp.ndarray, axis: int = -1) -> jnp.ndarray:
    c = jnp.cumsum(x, axis=axis)
    return c - x


# ---------------------------------------------------------------------------
# Decode


@partial(jax.jit, static_argnames=("bits", "num_steps", "tail"))
def decode_section(
    states: jnp.ndarray,  # u32[..., N]
    stream: jnp.ndarray,  # u16[..., W] (padded)
    read_pos: jnp.ndarray,  # i32[...]
    tab_sym: jnp.ndarray,  # u8 [..., 2^bits]
    tab_freq: jnp.ndarray,  # u16[..., 2^bits]
    tab_cumul: jnp.ndarray,  # u16[..., 2^bits]
    valid_counts: jnp.ndarray,  # i32[...]: number of valid symbols to decode
    *,
    bits: int,
    num_steps: int,
    tail: bool,
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Decode `num_steps` lane groups; returns (symbols, states, read_pos).

    symbols has shape [..., num_steps, N] in *lane* order (apply the
    inverse idx2idx permutation to get byte order).  When `tail` is True the
    final group applies the reference's partial-group masking: lane j only
    decodes (and only consumes stream words) if its output byte index
    `(num_steps-1)*N + idx2idx[j] < valid_counts`.
    """
    n = states.shape[-1]
    mask_slot = jnp.uint32((1 << bits) - 1)
    consume_point = jnp.uint32(DECODE_CONSUME_POINT_16)
    perm = jnp.asarray(IDX2IDX[n], dtype=jnp.int32)

    def gather_tab(tab, slot):
        idx = slot.astype(jnp.int32)
        if tab.ndim == idx.ndim:  # per-stream tables: batch gather
            return jnp.take_along_axis(tab, idx, axis=-1)
        return jnp.take(tab, idx, axis=0)

    def gather_stream(r, offs):
        idx = r[..., None].astype(jnp.int32) + offs.astype(jnp.int32)
        return jnp.take_along_axis(stream, idx, axis=-1) if stream.ndim == idx.ndim else jnp.take(stream, idx, axis=0)

    def step(carry, step_idx):
        states, r = carry
        slot = states & mask_slot
        sym = gather_tab(tab_sym, slot)
        freq = gather_tab(tab_freq, slot).astype(jnp.uint32)
        cumul = gather_tab(tab_cumul, slot).astype(jnp.uint32)
        new_states = (states >> jnp.uint32(bits)) * freq + slot - cumul

        if tail:
            byte_idx = step_idx * n + perm  # [N]
            valid = byte_idx < valid_counts[..., None]
        else:
            valid = jnp.ones(states.shape, dtype=bool)

        new_states = jnp.where(valid, new_states, states)
        consume = (new_states < consume_point) & valid
        offs = _exclusive_cumsum(consume.astype(jnp.int32), axis=-1)
        w = gather_stream(r, offs).astype(jnp.uint32)
        states = jnp.where(consume, (new_states << jnp.uint32(16)) | w, new_states)
        r = r + consume.sum(axis=-1).astype(r.dtype)
        return (states, r), sym

    (states, read_pos), syms = jax.lax.scan(
        step, (states, read_pos), jnp.arange(num_steps, dtype=jnp.int32)
    )
    # scan stacks on axis 0; move steps next-to-last: [..., S, N]
    if syms.ndim > 2:
        syms = jnp.moveaxis(syms, 0, -2)
    return syms, states, read_pos


def raw_decode_jax(blob: bytes, bits: int, n_lanes: int) -> bytes | None:
    """Decode a raw 16w wire blob on device; None on malformed input."""
    from ..models.histogram import complete_hist
    from ..models.tables import make_dec3

    buf = np.frombuffer(blob, dtype=np.uint8)
    n = n_lanes
    if buf.size < 16 + 512 + 4 * n:
        return None
    length = int.from_bytes(buf[0:8].tobytes(), "little")
    expected_in = int.from_bytes(buf[8:16].tobytes(), "little")
    if buf.size < expected_in:
        return None
    hist = complete_hist(buf[16:528].view("<u2"), bits)
    if hist is None:
        return None
    states = buf[528 : 528 + 4 * n].view("<u4").astype(np.uint32)
    word_bytes = (buf.size - 528 - 4 * n) // 2 * 2
    stream = np.zeros(word_bytes // 2 + 2 * n, dtype=np.uint16)
    stream[: word_bytes // 2] = buf[528 + 4 * n : 528 + 4 * n + word_bytes].view("<u2")

    if length == 0:
        return b""
    total = -(-length // n)
    tab = make_dec3(hist)
    syms, _, _ = decode_section(
        jnp.asarray(states),
        jnp.asarray(stream),
        jnp.zeros((), jnp.int32),
        jnp.asarray(tab["sym"]),
        jnp.asarray(tab["freq"].astype(np.uint16)),
        jnp.asarray(tab["cumul"].astype(np.uint16)),
        jnp.asarray(length, jnp.int32),
        bits=bits,
        num_steps=total,
        tail=True,
    )
    out = np.asarray(syms)[:, INV_IDX2IDX[n]].reshape(-1)[:length]
    return out.tobytes()


# ---------------------------------------------------------------------------
# Encode


@partial(jax.jit, static_argnames=("bits", "num_steps"))
def encode_section(
    states: jnp.ndarray,  # u32[..., N]
    group_bytes: jnp.ndarray,  # u8[..., S, N] in lane order, group 0 first
    valid: jnp.ndarray,  # bool[..., S, N]
    freq_tab: jnp.ndarray,  # u16[256] or [..., 256]
    cumul_tab: jnp.ndarray,  # u16[256] or [..., 256]
    *,
    bits: int,
    num_steps: int,
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Encode `num_steps` groups in reverse order (rANS is LIFO).

    Returns (words u16[..., S, N], emit bool[..., S, N], final states).
    The forward wire stream is words[emit] flattened in (group asc, lane
    asc) order — the exact reverse of the reference's emission sequence.
    """
    emit_point = jnp.uint32(encode_emit_point_16(bits))

    def gather_tab(tab, idx):
        idx = idx.astype(jnp.int32)
        if tab.ndim == idx.ndim:
            return jnp.take_along_axis(tab, idx, axis=-1)
        return jnp.take(tab, idx, axis=0)

    def step(states, xs):
        b, v = xs
        freq = jnp.maximum(gather_tab(freq_tab, b).astype(jnp.uint32), 1)
        cumul = gather_tab(cumul_tab, b).astype(jnp.uint32)
        emit = (states >= emit_point * freq) & v
        word = jnp.where(emit, states, 0).astype(jnp.uint16)
        states_r = jnp.where(emit, states >> jnp.uint32(16), states)
        new_states = ((states_r // freq) << jnp.uint32(bits)) + cumul + (states_r % freq)
        states = jnp.where(v, new_states, states)
        return states, (word, emit)

    # reverse over the group axis (last-to-first input order)
    gb = jnp.flip(group_bytes, axis=-2)
    vv = jnp.flip(valid, axis=-2)
    if gb.ndim > 2:
        gb = jnp.moveaxis(gb, -2, 0)
        vv = jnp.moveaxis(vv, -2, 0)
    states, (words, emits) = jax.lax.scan(step, states, (gb, vv))
    if words.ndim > 2:
        words = jnp.moveaxis(words, 0, -2)
        emits = jnp.moveaxis(emits, 0, -2)
    words = jnp.flip(words, axis=-2)
    emits = jnp.flip(emits, axis=-2)
    return words, emits, states


def raw_encode_jax(data: bytes | np.ndarray, hist, n_lanes: int) -> bytes:
    """Encode one buffer on device; byte-identical wire output to the
    reference scalar encoder (and to ops.reference.raw_encode_16w)."""
    arr = np.frombuffer(data, dtype=np.uint8) if isinstance(data, (bytes, bytearray, memoryview)) else np.asarray(data, dtype=np.uint8)
    n = n_lanes
    length = arr.size
    bits = hist.total_symbol_count_bits

    total = -(-length // n) if length else 0
    perm = IDX2IDX[n]
    states = np.full(n, DECODE_CONSUME_POINT_16, dtype=np.uint32)
    if total:
        padded = np.zeros(total * n, dtype=np.uint8)
        padded[:length] = arr
        pos = np.arange(total, dtype=np.int64)[:, None] * n + perm[None, :]
        groups = padded[pos]
        valid = pos < length
        words, emits, fin = encode_section(
            jnp.asarray(states),
            jnp.asarray(groups),
            jnp.asarray(valid),
            jnp.asarray(hist.symbol_count),
            jnp.asarray(hist.cumul),
            bits=bits,
            num_steps=total,
        )
        words = np.asarray(words)
        emits = np.asarray(emits)
        states = np.asarray(fin)
        stream = words[emits]
    else:
        stream = np.zeros(0, dtype=np.uint16)

    out = bytearray()
    out += int(length).to_bytes(8, "little")
    out += b"\0" * 8
    out += hist.symbol_count.astype("<u2").tobytes()
    out += states.astype("<u4").tobytes()
    out += stream.astype("<u2").tobytes()
    out[8:16] = len(out).to_bytes(8, "little")
    return bytes(out)
