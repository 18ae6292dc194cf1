"""Core rANS constants and lane-interleave permutations.

Rebuild of the hypersonic-rANS "ISA" (see SURVEY.md §2.1):
32-bit states, 16-bit-word renormalization (or 8-bit for the 8w variants),
N interleaved lanes advancing in lockstep.

Reference semantics (for parity checking, not copied code):
  - /root/reference/src/rans.h:7-8            (consume points)
  - /root/reference/src/rANS32x32_16w.cpp:41  (EncodeEmitPoint)
  - /root/reference/src/rANS32x16_16w.cpp:51, rANS32x32_16w.cpp:51,
    block_codec64.h:22-28                     (idx2idx lane permutations)

The lane permutation `idx2idx` maps lane index j -> byte offset within a
group of N input bytes.  The reference chose it so its AVX2 `packus`-based
output packing writes bytes contiguously; we reproduce the exact mapping for
bit-compatibility of the wire format.
"""

from __future__ import annotations

import numpy as np

# Decode lower bounds: when a lane's state drops below this, it shifts in one
# renormalization word (16-bit or 8-bit).
DECODE_CONSUME_POINT_16 = 1 << 15
DECODE_CONSUME_POINT_8 = 1 << 23

# Supported histogram depths (TotalSymbolCountBits).
HIST_BITS_RANGE = range(10, 16)  # 10..15 inclusive


def encode_emit_point_16(total_symbol_count_bits: int) -> int:
    """Per-symbol emit threshold multiplier for 16-bit-word renorm.

    A lane emits its low 16 bits iff state >= emit_point * freq.
    """
    return (DECODE_CONSUME_POINT_16 >> total_symbol_count_bits) << 16


def encode_emit_point_8(total_symbol_count_bits: int) -> int:
    """Per-symbol emit threshold multiplier for 8-bit-word renorm."""
    return (DECODE_CONSUME_POINT_8 >> total_symbol_count_bits) << 8


def _interleave_perm(n: int) -> np.ndarray:
    """Build the idx2idx lane->byte-offset permutation for N lanes.

    Pattern (verified against the reference tables for N in {16, 32, 64}):
    the N lanes are split into chunks of 32 (or the whole width if N<=32);
    within each 32-wide chunk built from two 16-lane halves interleaved in
    4-byte runs:  00-03, 10-13, 04-07, 14-17, 08-0B, 18-1B, 0C-0F, 1C-1F.
    """
    if n == 16:
        perm = [0x00, 0x01, 0x02, 0x03, 0x08, 0x09, 0x0A, 0x0B,
                0x04, 0x05, 0x06, 0x07, 0x0C, 0x0D, 0x0E, 0x0F]
    elif n == 32:
        perm = [0x00, 0x01, 0x02, 0x03, 0x10, 0x11, 0x12, 0x13,
                0x04, 0x05, 0x06, 0x07, 0x14, 0x15, 0x16, 0x17,
                0x08, 0x09, 0x0A, 0x0B, 0x18, 0x19, 0x1A, 0x1B,
                0x0C, 0x0D, 0x0E, 0x0F, 0x1C, 0x1D, 0x1E, 0x1F]
    elif n == 64:
        base = _interleave_perm(32)
        perm = list(base) + [p + 0x20 for p in base]
    else:
        raise ValueError(f"unsupported lane count {n}")
    return np.asarray(perm, dtype=np.int64)


# idx2idx permutations per lane width; IDX2IDX[n][j] = byte offset of lane j.
IDX2IDX = {n: _interleave_perm(n) for n in (16, 32, 64)}

# Inverse permutations: INV_IDX2IDX[n][byte offset] = lane index.
INV_IDX2IDX = {n: np.argsort(p) for n, p in IDX2IDX.items()}
