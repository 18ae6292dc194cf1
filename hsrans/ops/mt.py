"""mt_rANS32xN 16w — self-contained blocks, decodable independently.

Like the block codec but every coded block embeds everything needed to
decode it in isolation: a fresh state snapshot, its histogram, and a forward
skip (`writeHeadOffset`) to the next block header, so a scheduler can fan
blocks out without decoding (mt_rANS32x64_16w_encode.cpp:266-298).  The
reference fans out to a thread pool; the device paths fan out to batched
kernel rows (kernels/) and to a device mesh (parallel/).

Wire format:  u64 rawLength | u64 compressedLength | per block:
  single-symbol:  u64 (size | 1<<63 | sym<<54)
  coded:          u64 blockSize | u64 writeHeadOffset | N*u32 states |
                  256*u16 freq | u16 words...
writeHeadOffset is measured in u16 words from the states field + 1 to the
next block's size field; encode states are carried continuously (LIFO), the
per-block snapshot is taken *after* the block is encoded, which is exactly
the state vector its decoder starts from.

The `block_index` helper walks the headers once (O(blocks), no entropy
decoding) and returns a flat table — the batched decoders' replacement
for the reference's sequential pReadHead chase.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..models.histogram import Hist, complete_hist
from ..rans import DECODE_CONSUME_POINT_16, IDX2IDX, INV_IDX2IDX
from .planner import BlockPlan, plan_blocks
from .reference import decode_full_groups, decode_tail_group, encode_groups

_U32 = np.uint32
_SINGLE_BIT = 1 << 63
_SYM_SHIFT = 54
_SIZE_MASK = (1 << 54) - 1


def mt_capacity(input_size: int, n: int) -> int:
    """Reference: mt_rANS32x64_16w_encode.cpp:50-57."""
    base = 16 + 512 + input_size + n * 4
    block_count = (input_size + (1 << 15)) // (1 << 15) + 1
    return base + block_count * (16 + 512 + n * 4)


def _lane_groups(arr, start, end, length, n):
    perm = IDX2IDX[n]
    total = -(-(end - start) // n)
    padded = np.zeros(max(total * n, 1), dtype=np.uint8)
    padded[: min(end, length) - start] = arr[start : min(end, length)]
    pos = np.arange(total, dtype=np.int64)[:, None] * n + perm[None, :]
    return padded[pos], (start + pos) < length


def mt_encode(data: bytes | np.ndarray, bits: int, n: int, plan: list[BlockPlan] | None = None) -> bytes:
    """Sequential-oracle mt encode (native C++ when built, numpy fallback;
    identical bytes either way — tests/test_native_codec.py)."""
    if plan is None:
        from ..runtime import native

        arr0 = np.frombuffer(data, dtype=np.uint8) if isinstance(data, (bytes, bytearray, memoryview)) else np.asarray(data, dtype=np.uint8)
        fast = native.mt_encode(arr0, bits, n)
        if fast is not None:
            return fast
    return mt_encode_py(data, bits, n, plan)


def mt_encode_py(data: bytes | np.ndarray, bits: int, n: int, plan: list[BlockPlan] | None = None) -> bytes:
    """Pure-numpy encoder (the wire authority)."""
    arr = np.frombuffer(data, dtype=np.uint8) if isinstance(data, (bytes, bytearray, memoryview)) else np.asarray(data, dtype=np.uint8)
    length = arr.size
    if plan is None:
        plan = plan_blocks(arr, bits, "mt", n)

    states = np.full(n, DECODE_CONSUME_POINT_16, dtype=_U32)
    parts: list[bytes] = [b""] * len(plan)

    for k in range(len(plan) - 1, -1, -1):
        row = plan[k]
        if row.is_single:
            indicator = row.size | _SINGLE_BIT | (row.symbol << _SYM_SHIFT)
            parts[k] = indicator.to_bytes(8, "little")
            continue
        hist = complete_hist(row.freq, bits)
        assert hist is not None, "planner produced an invalid histogram"
        groups, valid = _lane_groups(arr, row.start, row.start + row.size, length, n)
        words, emits, states = encode_groups(states, groups, valid, hist)
        w_count = int(emits.sum())
        # words from the states field (+1) to the next block's size field;
        # the last input block's offset points at the stream end slot instead
        # (pEnd), one word less (mt_rANS32x64_16w_encode.cpp:280-283).
        offset = 2 * n + 256 + w_count - (2 if k == len(plan) - 1 else 1)
        parts[k] = (
            int(row.size).to_bytes(8, "little")
            + int(offset).to_bytes(8, "little")
            + states.astype("<u4").tobytes()
            + row.freq.astype("<u2").tobytes()
            + words[emits].astype("<u2").tobytes()
        )

    out = bytearray()
    out += int(length).to_bytes(8, "little")
    out += b"\0" * 8
    for p in parts:
        out += p
    out[8:16] = len(out).to_bytes(8, "little")
    return bytes(out)


@dataclass
class MtBlock:
    """One entry of the O(1)-seek block index."""

    out_start: int  # first output byte
    size: int  # output bytes
    is_single: bool
    symbol: int
    states: np.ndarray | None  # u32[n]
    freq: np.ndarray | None  # u16[256]
    word_start: int  # index into the u16 stream where this block's words begin
    is_last: bool


def block_index(blob: bytes | np.ndarray, n: int) -> tuple[int, np.ndarray, list[MtBlock]] | None:
    """Walk the header chain once; returns (rawLength, u16 stream, blocks)."""
    buf = np.frombuffer(blob, dtype=np.uint8) if isinstance(blob, (bytes, bytearray, memoryview)) else np.asarray(blob, dtype=np.uint8)
    if buf.size < 16:
        return None
    length = int.from_bytes(buf[0:8].tobytes(), "little")
    expected_in = int.from_bytes(buf[8:16].tobytes(), "little")
    if buf.size < expected_in:
        return None
    word_region = buf[16:]
    nwords = word_region.size // 2
    stream = np.zeros(nwords + 2 * n + 4, dtype=np.uint16)
    stream[:nwords] = word_region[: nwords * 2].view("<u2")

    blocks: list[MtBlock] = []
    i = 0
    r = 0
    out_len_states = max(length - n + 1, 0)
    while i < length:
        if r + 4 > nwords:
            return None
        val = int.from_bytes(stream[r : r + 4].tobytes(), "little")
        r += 4
        if val & _SINGLE_BIT:
            size = val & _SIZE_MASK
            blocks.append(MtBlock(i, size, True, (val >> _SYM_SHIFT) & 0xFF, None, None, r, False))
            i += size
        else:
            offset = int.from_bytes(stream[r : r + 4].tobytes(), "little")
            r += 4
            states_pos = r
            states = np.frombuffer(stream[r : r + 2 * n].tobytes(), dtype="<u4").astype(_U32)
            r += 2 * n
            freq = stream[r : r + 256].copy()
            r += 256
            is_last = i + val > out_len_states
            blocks.append(MtBlock(i, min(val, length - i), False, 0, states, freq, r, is_last))
            i += val
            if not is_last:
                r = states_pos + offset + 1
        if i >= length:
            break
        if blocks[-1].is_last:
            break
    return length, stream, blocks


def mt_decode(blob: bytes | np.ndarray, bits: int, n: int) -> bytes | None:
    """Host mt decode: native C++ (thread-pool block fan-out) when built,
    numpy oracle otherwise.  The batched/sharded device paths live in
    kernels/ and parallel/."""
    from ..runtime import native

    # the native tier implements the reference's widths (32/64); other n
    # (e.g. 16, a generalization the numpy authority supports) must not
    # be mistaken for malformed input by its -1
    if native.load() is not None and n in (32, 64):
        return native.mt_decode(blob, bits, n)
    return mt_decode_py(blob, bits, n)


def mt_decode_py(blob: bytes | np.ndarray, bits: int, n: int) -> bytes | None:
    """Sequential (single-stream) numpy decode — the correctness oracle."""
    idx = block_index(blob, n)
    if idx is None:
        return None
    length, stream, blocks = idx
    if length == 0:
        return b""
    out = np.zeros(length, dtype=np.uint8)
    inv_perm = INV_IDX2IDX[n]
    out_len_states = max(length - n + 1, 0)

    last_states = None
    last_hist = None
    last_r = None
    i = 0
    for blk in blocks:
        i = blk.out_start
        if blk.is_single:
            out[i : i + blk.size] = blk.symbol
            i += blk.size
            continue
        hist = complete_hist(blk.freq, bits)
        if hist is None:
            return None
        block_end = min(blk.out_start + blk.size, out_len_states)
        num_groups = max(0, -(-(block_end - i) // n))
        syms, states, r = decode_full_groups(blk.states.copy(), stream, blk.word_start, hist, n, num_groups)
        out[i : i + num_groups * n] = syms[:, inv_perm].reshape(-1)
        i += num_groups * n
        last_states, last_hist, last_r = states, hist, r

    if i < length:
        if last_hist is None:
            return None  # trailing partial group after a single-symbol block
        tail, _, _ = decode_tail_group(last_states, stream, last_r, last_hist, n, i, length)
        perm = IDX2IDX[n]
        sel = (i + perm) < length
        out[i + perm[sel]] = tail[np.arange(n)[sel]]
    return out.tobytes()
