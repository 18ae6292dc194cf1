"""rANS32x32 32blk codecs: 32 states with 32 *independent* sub-streams.

Unlike the interleaved codecs there is no cross-lane renormalization
coupling: every lane owns a private compressed stream, so lanes are
embarrassingly parallel (the reference stores 31 u32 sub-stream sizes in the
header; rans32x32_32blk_16w.cpp:160-175, decode head setup :222-231).

Two word widths:
  16w — one u16 consumed per lane per step when state < 2^15;
  8w  — up to two u8 consumed per step while state < 2^23
        (rans32x32_32blk_8w.cpp:226-249), emit is a while-loop too.

Wire format:  u64 rawLength | u64 compressedLength | 256*u16 freq |
32*u32 states | 31*u32 sub-stream byte sizes (lanes 0..30) |
lane-0 stream | lane-1 stream | ... (each read forward).

On a vector device these are the natural case: a [32, W] stream matrix
with per-lane read heads, no prefix-sum needed.
"""

from __future__ import annotations

import numpy as np

from ..models.histogram import Hist, complete_hist
from ..models.tables import make_cumul_inv
from ..rans import (
    DECODE_CONSUME_POINT_8,
    DECODE_CONSUME_POINT_16,
    IDX2IDX,
    INV_IDX2IDX,
    encode_emit_point_8,
    encode_emit_point_16,
)

_U32 = np.uint32
N = 32


def blk32_capacity(input_size: int, word_bits: int) -> int:
    """Reference: rans32x32_32blk_16w.cpp:10-13 (same formula for 8w)."""
    return input_size + N + 512 + 4 * N * 2 + 16


def _groups(arr: np.ndarray, length: int) -> tuple[np.ndarray, np.ndarray, int]:
    perm = IDX2IDX[N]
    total = -(-length // N) if length else 0
    padded = np.zeros(max(total * N, 1), dtype=np.uint8)
    padded[:length] = arr
    pos = np.arange(total, dtype=np.int64)[:, None] * N + perm[None, :]
    return padded[pos], pos < length, total


def blk32_encode_host(data: bytes | np.ndarray, bits: int, word_bits: int) -> bytes:
    """32blk encode with a whole-input histogram: native C++ when built
    (identical bytes — tests/test_native_codec.py), numpy fallback."""
    from ..models.histogram import make_hist
    from ..runtime import native

    arr = np.frombuffer(data, dtype=np.uint8) if isinstance(data, (bytes, bytearray, memoryview)) else np.asarray(data, dtype=np.uint8)
    fast = native.blk32_encode(arr, bits, word_bits)
    if fast is not None:
        return fast
    return blk32_encode(arr, make_hist(arr, bits), word_bits)


def blk32_decode_host(blob: bytes | np.ndarray, bits: int, word_bits: int) -> bytes | None:
    """32blk decode: native C++ when built, numpy oracle otherwise."""
    from ..runtime import native

    if native.load() is not None:
        return native.blk32_decode(blob, bits, word_bits)
    return blk32_decode(blob, bits, word_bits)


def blk32_encode(data: bytes | np.ndarray, hist: Hist, word_bits: int) -> bytes:
    """Encode with 32 independent per-lane streams (16w or 8w words)."""
    arr = np.frombuffer(data, dtype=np.uint8) if isinstance(data, (bytes, bytearray, memoryview)) else np.asarray(data, dtype=np.uint8)
    length = arr.size
    bits = hist.total_symbol_count_bits
    if word_bits == 16:
        emit_point = _U32(encode_emit_point_16(bits))
        init = DECODE_CONSUME_POINT_16
        max_emits = 1
        shift = _U32(16)
    else:
        emit_point = _U32(encode_emit_point_8(bits))
        init = DECODE_CONSUME_POINT_8
        max_emits = 3  # state < 2^31 -> at most ceil((31-16)/8)=2 shifts; 3 is safe
        shift = _U32(8)

    freq_tab = hist.symbol_count.astype(_U32)
    cumul_tab = hist.cumul.astype(_U32)
    states = np.full(N, init, dtype=_U32)
    groups, valid, total = _groups(arr, length)

    # per-lane emissions: words[g, e, lane] with masks, e = emission sub-step
    words = np.zeros((total, max_emits, N), dtype=np.uint16)
    emits = np.zeros((total, max_emits, N), dtype=bool)

    for g in range(total - 1, -1, -1):
        v = valid[g]
        b = groups[g]
        freq = freq_tab[b]
        max_state = emit_point * np.maximum(freq, 1)
        for e in range(max_emits):
            emit = (states >= max_state) & v
            words[g, e] = np.where(emit, (states & ((_U32(1) << shift) - _U32(1))).astype(np.uint16), 0)
            states = np.where(emit, states >> shift, states)
            emits[g, e] = emit
            if word_bits == 16:
                break
        new_states = ((states // np.maximum(freq, 1)) << _U32(bits)) + cumul_tab[b] + (states % np.maximum(freq, 1))
        states = np.where(v, new_states, states)

    # Per-lane forward stream = fully reversed per-lane emission sequence:
    # (groups ascending, emission sub-step DESCENDING).
    lane_streams = []
    for j in range(N):
        w = words[:, ::-1, j].reshape(-1)
        m = emits[:, ::-1, j].reshape(-1)
        lane_streams.append(w[m])

    out = bytearray()
    out += int(length).to_bytes(8, "little")
    out += b"\0" * 8
    out += hist.symbol_count.astype("<u2").tobytes()
    out += states.astype("<u4").tobytes()
    if word_bits == 16:
        payloads = [s.astype("<u2").tobytes() for s in lane_streams]
    else:
        payloads = [s.astype(np.uint8).tobytes() for s in lane_streams]
    for p in payloads[:-1]:
        out += len(p).to_bytes(4, "little")
    for p in payloads:
        out += p
    out[8:16] = len(out).to_bytes(8, "little")
    return bytes(out)


def blk32_decode(blob: bytes | np.ndarray, total_symbol_count_bits: int, word_bits: int) -> bytes | None:
    buf = np.frombuffer(blob, dtype=np.uint8) if isinstance(blob, (bytes, bytearray, memoryview)) else np.asarray(blob, dtype=np.uint8)
    bits = total_symbol_count_bits
    if buf.size < 16 + 512 + 4 * (2 * N - 1):
        return None
    length = int.from_bytes(buf[0:8].tobytes(), "little")
    expected_in = int.from_bytes(buf[8:16].tobytes(), "little")
    if buf.size < expected_in:
        return None
    hist = complete_hist(buf[16:528].view("<u2"), bits)
    if hist is None:
        return None
    states = buf[528:656].view("<u4").astype(_U32)
    sizes = buf[656 : 656 + 124].view("<u4").astype(np.int64)
    base = 656 + 124
    starts = base + np.concatenate([[0], np.cumsum(sizes)])

    consume_point = _U32(DECODE_CONSUME_POINT_16 if word_bits == 16 else DECODE_CONSUME_POINT_8)
    shift = _U32(16 if word_bits == 16 else 8)
    max_consumes = 1 if word_bits == 16 else 2

    # [N, W] per-lane word matrix, padded
    ends = [int(starts[j + 1]) if j < N - 1 else int(expected_in) for j in range(N)]
    if word_bits == 16:
        lane_words = [buf[starts[j] : ends[j]].view("<u2") for j in range(N)]
    else:
        lane_words = [buf[starts[j] : ends[j]] for j in range(N)]
    maxw = max((w.size for w in lane_words), default=0) + 2 * max(1, -(-length // N))
    streams = np.zeros((N, maxw), dtype=np.uint16)
    for j, w in enumerate(lane_words):
        streams[j, : w.size] = w

    inv_tab = make_cumul_inv(hist)
    freq_of = hist.symbol_count.astype(_U32)
    cumul_of = hist.cumul.astype(_U32)
    mask_slot = _U32((1 << bits) - 1)
    perm = IDX2IDX[N]
    inv_perm = INV_IDX2IDX[N]
    lane_ids = np.arange(N)

    if length == 0:
        return b""
    total = -(-length // N)
    out_len_states = length - N + 1
    full = 0 if out_len_states <= 0 else -(-out_len_states // N)
    syms = np.zeros((total, N), dtype=np.uint8)
    r = np.zeros(N, dtype=np.int64)

    for g in range(total):
        if g < full:
            v = np.ones(N, dtype=bool)
        else:
            v = (g * N + perm) < length
        slot = states & mask_slot
        sym = inv_tab[slot]
        syms[g] = np.where(v, sym, 0)
        s64 = sym.astype(np.int64)
        new_states = (states >> _U32(bits)) * freq_of[s64] + slot - cumul_of[s64]
        states = np.where(v, new_states, states)
        for _ in range(max_consumes):
            consume = (states < consume_point) & v
            if not consume.any():
                break
            w = streams[lane_ids, r].astype(_U32)
            states = np.where(consume, (states << shift) | w, states)
            r = r + consume
    return syms[:, inv_perm].reshape(-1)[:length].tobytes()
