"""Encoder/decoder lookup-table layouts derived from a normalized histogram.

The reference offers four decode-table layouts trading table size against
gather count (/root/reference/src/hist.h:19-50, hist.cpp:230-306):

  dec   : freq/cumul[256] + cumulInv[2^B] slot->symbol       (2 dep. gathers)
  dec2  : packed {freq,cumul}[256] + cumulInv[2^B]           (2 dep. gathers)
  dec3  : per-slot freq/cumul[2^B] + cumulInv[2^B]           (2 indep. gathers)
  pack  : single u32/slot  sym | cumul<<8 | freq<<20, B<=12  (1 gather)

The flat slot-indexed layouts (dec3 / pack) need no dependent lookup
chain: for B<=12 `pack` is one load per symbol.  The GPU decode kernel
(kernels/mt_decode.py) builds the same layouts on the device, packed into
one word per slot (plus a symbol table above B=12).
"""

from __future__ import annotations

import numpy as np

from .histogram import Hist


def make_cumul_inv(hist: Hist) -> np.ndarray:
    """slot -> symbol table, uint8[2^B] (reference: hist.cpp:240-246)."""
    return np.repeat(
        np.arange(256, dtype=np.uint8), hist.symbol_count.astype(np.int64)
    )


def make_enc_table(hist: Hist) -> np.ndarray:
    """Packed encode table u32: cumul<<16 | freq (hist.cpp:224-228)."""
    return (
        hist.cumul.astype(np.uint32) << np.uint32(16)
    ) | hist.symbol_count.astype(np.uint32)


def make_dec3(hist: Hist) -> dict[str, np.ndarray]:
    """Flat slot-indexed tables: one gather per field, no second lookup."""
    inv = make_cumul_inv(hist)
    return {
        "sym": inv,
        "freq": hist.symbol_count[inv].astype(np.uint32),
        "cumul": hist.cumul[inv].astype(np.uint32),
    }


def make_dec_pack(hist: Hist) -> np.ndarray:
    """Single-u32-per-slot table: sym | cumul<<8 | freq<<20; needs B<=12.

    Reference: make_dec_pack_hist (hist.cpp:291-306).
    """
    if hist.total_symbol_count_bits > 12:
        raise ValueError("dec_pack layout requires TotalSymbolCountBits <= 12")
    inv = make_cumul_inv(hist)
    return (
        inv.astype(np.uint32)
        | (hist.cumul[inv].astype(np.uint32) << np.uint32(8))
        | (hist.symbol_count[inv].astype(np.uint32) << np.uint32(20))
    )
