"""tpx — a tile-parallel rANS format (host codec; its device decoder was
removed, see ROADMAP.md).

Same rANS math and constants as the reference 16w codecs (32-bit states,
16-bit renorm words, DecodeConsumePoint 2^15, per-tile adaptive histograms
normalized to 2^B exactly like hist.cpp), but a container laid out for a
wide vector unit instead of AVX registers:

  * megablock = R(=128) independent row-chains x T tiles; each row is a
    128-lane interleaved rANS stream (identity lane order, no idx2idx);
  * all rows of a tile share one histogram; rANS states chain across
    tiles within a mega
    (only table switches, like the reference block codec) so per-row state
    snapshots cost one 64 KiB header per 16 MiB megablock;
  * each row's renorm words for a tile are stored left-aligned in a
    [R, W] u32-slot matrix (two u16 words per slot), W shared per
    megablock — the padding is the price of a rectangular one-DMA layout
    and bounded-window gathers (few % on text);
  * decode consumption order within a step is lane-ascending; encode emits
    the exact reverse, so the forward stream is (tile, step, lane)
    ascending per row.

Output byte mapping (chosen so a decoder's packed u32 output IS the wire
byte order — no transpose anywhere):

  pos = mega_base + (((t*R + r)*(S/4) + s//4)*L + l)*4 + (s % 4)

i.e. lane l's four consecutive step-group symbols are the four bytes of one
little-endian u32 at (tile, row, step-group, lane).

Wire layout (little-endian):
  "HSRTPX01" | u64 rawLength | u64 totalLength |
  u32 bits | u32 R | u32 L | u32 S | u32 T |
  per megablock:
    u32 n_tiles | u32 W | R*L u32 states |
    n_tiles * (256*u16 freq | R*u16 word counts) |
    n_tiles * R * W * u32 stream slots
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..models.histogram import Hist, complete_hist, normalize_hist, observe_hist


def make_tile_hist(tile_bytes: np.ndarray, bits: int) -> Hist:
    """Per-tile adaptive histogram (native C++ fast path, numpy fallback).

    Empty tiles (fully beyond the input length) get the 1-symbol histogram,
    mirroring the reference's defensive handling of zero-length sections.
    """
    if tile_bytes.size == 0:
        counts = np.zeros(256, np.uint32)
        counts[0] = 1
        return normalize_hist(counts, 1, bits)
    from ..runtime import native

    counts = native.observe_hist(tile_bytes)
    if counts is not None:
        r = native.normalize_hist(counts, tile_bytes.size, bits)
        if r is not None:
            return Hist(symbol_count=r[0], cumul=r[1], total_symbol_count_bits=bits)
    return normalize_hist(observe_hist(tile_bytes), tile_bytes.size, bits)
from ..models.tables import make_cumul_inv
from ..rans import DECODE_CONSUME_POINT_16, encode_emit_point_16

_U32 = np.uint32
MAGIC = b"HSRTPX01"  # v1: rectangular per-mega [T, R, W] stream section
MAGIC2 = b"HSRTPX02"  # v2: ragged streams (exact per-row slots; counts are
#                       already in the wire, so padding never hits the wire
#                       — the rectangular layout is rebuilt at parse time).
#                       Encoders emit v2; both parse.
MAGIC3 = b"HSRTPX03"  # v3: per-megablock GEOMETRY (u32 rows | u32 steps
#                       before each mega's n_tiles) — the adaptive encoder
#                       picks tile span / chain count per content region
#                       (the _CanExtendHist-style cost model places the
#                       cuts); header rows/steps/tiles become defaults.

# Default geometry (the wire records it, so any geometry decodes): many
# independent rows for parallel decode; tiles per mega stay small so the
# per-mega padded stream W tracks per-tile maxima.
R = 1024  # rows (independent sub-streams) per tile
L = 128  # interleaved rANS lanes per row
S = 32  # lane-group steps per tile (tile covers S*L bytes per row)
T = 4  # tiles per megablock (mega covers R*T*S*L = 16 MiB)


@dataclass
class TpxParams:
    bits: int = 12
    rows: int = R
    lanes: int = L
    steps: int = S
    tiles: int = T

    @property
    def row_span(self) -> int:
        return self.tiles * self.steps * self.lanes

    @property
    def mega_bytes(self) -> int:
        return self.rows * self.row_span

    @classmethod
    def auto(cls, length: int, bits: int = 12, goal: str = "balanced") -> "TpxParams":
        """Geometry scaled to the input and the speed/ratio goal.

        The dial is the CHAIN COUNT (rows x 128 lanes): decode parallelism
        scales with chains, while ratio pays for them twice — the per-mega
        state snapshot is 4 bytes/chain, and the per-tile histogram span
        is rows * 4 KiB.  Large inputs (>= 32 MiB) always take the default
        geometry (rows=1024, 4 MiB tiles, snapshot <= 0.8 %).  Below that:

          * "speed":    rows to fill the device (snapshot up to ~3 %)
          * "balanced": rows ~ len/85 KB, capped 128 (mixed 6 MiB: 0.629)
          * "ratio":    rows ~ len/200 KB, capped 96 — 128 KiB-class tiles
            and ~0.3 % snapshot; the mixed 6 MiB corpus compresses to
            0.589, BEATING the block codec's 0.603

        Tiles-per-mega rises so one mega covers the input (snapshots don't
        duplicate across megas)."""
        if length >= 32 << 20:
            return cls(bits=bits)
        if goal == "speed":
            rows = max(8, min(R, -(-length // (T * S * L))))
        elif goal == "ratio":
            rows = max(8, min(96, length // 200000))
        else:
            rows = max(8, min(128, length // 85000))
        rows = -(-rows // 8) * 8
        tiles = max(1, min(64, -(-length // (rows * S * L))))
        return cls(bits=bits, rows=rows, tiles=tiles)


def make_rank_tables(hist: Hist) -> dict[str, np.ndarray]:
    """Bucketed-rank decode tables (the layout of a former device decoder
    whose gathers took 128-entry operands; `tpx_decode(use_rank_tables=True)`
    exercises it).

    cumulInv is monotone over the *present* (freq>0) symbols, so with
    32-slot buckets:  rank = C0[slot>>5] + popcount(bm[slot>>5] &
    ((2 << (slot&31)) - 2))  indexes the present-symbol list exactly
    (rank, not symbol id — absent symbols make cumulInv jump by >1).
    Then t1[rank] = sym | freq<<8 and t2[rank] = cumul give the full
    decode tuple.  For B<=12 c0/bm are <=128 entries (one shuffle each);
    t1/t2 are <=256 (two shuffles + select).
    """
    inv = make_cumul_inv(hist)
    total = 1 << hist.total_symbol_count_bits
    n_buckets = total // 32
    present = np.nonzero(hist.symbol_count)[0]
    rank_of_sym = np.zeros(256, dtype=np.int64)
    rank_of_sym[present] = np.arange(present.size)
    inv_rank = rank_of_sym[inv]
    c0 = inv_rank[::32].astype(np.int32)
    first = np.zeros(total, dtype=bool)
    first[0] = True
    first[1:] = inv[1:] != inv[:-1]
    bits = first.reshape(n_buckets, 32)
    bm = (bits.astype(np.uint64) << np.arange(32, dtype=np.uint64)[None, :]).sum(axis=1).astype(np.uint32)
    t1 = np.zeros(256, dtype=np.uint32)
    t2 = np.zeros(256, dtype=np.uint32)
    t1[: present.size] = present.astype(np.uint32) | (hist.symbol_count[present].astype(np.uint32) << np.uint32(8))
    t2[: present.size] = hist.cumul[present].astype(np.uint32)
    out = {"c0": c0, "bm": bm.view(np.int32), "t1": t1.view(np.int32), "t2": t2.view(np.int32)}
    if hist.total_symbol_count_bits <= 12:
        # single-u32 rank table (a rank-indexed hist_dec_pack_t,
        # hist.cpp:291-306): sym | (freq-1)<<8 | cumul<<20 — freq-1 keeps
        # the full-table single-symbol case (freq = 2^12) in 12 bits
        tp = np.zeros(256, dtype=np.uint32)
        tp[: present.size] = (
            present.astype(np.uint32)
            | ((hist.symbol_count[present].astype(np.uint32) - np.uint32(1)) << np.uint32(8))
            | (hist.cumul[present].astype(np.uint32) << np.uint32(20))
        )
        out["tp"] = tp.view(np.int32)
    if hist.total_symbol_count_bits <= 11:
        # 16-slot buckets pack bm (u16, bits 0..15) and c0 (<= 256, bits
        # 16..) into ONE u32: rank = (v>>16) + popcount(v & ((2<<(slot&15))
        # - 2)) — the -2 mask never touches bit 0 or the c0 half, so no
        # extra masking.  One table gather per step where c0/bm cost two;
        # 2^B/16 entries = 64 at B10 / 128 at B11 (one lane-shuffle).
        n16 = total // 16
        c0_16 = inv_rank[::16].astype(np.uint32)
        bits16 = first.reshape(n16, 16)
        bm16 = (bits16.astype(np.uint32) << np.arange(16, dtype=np.uint32)[None, :]).sum(axis=1)
        out["cb16"] = (bm16 | (c0_16 << np.uint32(16))).astype(np.uint32).view(np.int32)
    return out


def _mega_layout(length: int, p: TpxParams) -> list[tuple[int, int, int]]:
    """[(mega_base, n_tiles, valid_bytes)] covering the input."""
    out = []
    base = 0
    while base < length or (length == 0 and not out):
        rem = length - base
        if rem >= p.mega_bytes:
            out.append((base, p.tiles, p.mega_bytes))
            base += p.mega_bytes
        else:
            per_row = p.steps * p.lanes
            n_tiles = max(1, -(-rem // (p.rows * per_row)))
            out.append((base, n_tiles, max(rem, 0)))
            base = length
    return out


def _encode_mega_into(
    out: bytearray,
    arr: np.ndarray,
    mega_base: int,
    n_tiles: int,
    valid_bytes: int,
    bits: int,
    rows: int,
    steps: int,
    lanes: int = L,
) -> None:
    """Encode one megablock of `arr` at the given geometry and append its
    wire section (n_tiles | W | states | tables | ragged streams) to `out`.
    Shared by the uniform (v2) and adaptive (v3) encoders — byte-identical
    mega sections either way."""
    emit_point = _U32(encode_emit_point_16(bits))
    s4c = steps // 4
    row_span = n_tiles * steps * lanes
    flat = np.zeros(rows * row_span, dtype=np.uint8)
    n_valid = min(valid_bytes, rows * row_span)
    flat[:n_valid] = arr[mega_base : mega_base + n_valid]
    # wire byte mapping [t, r, s4, l, b] -> symbol layout [r, t, s, l]
    view = (
        flat.reshape(n_tiles, rows, s4c, lanes, 4)
        .transpose(1, 0, 2, 4, 3)
        .reshape(rows, n_tiles, steps, lanes)
    )
    r_ = np.arange(rows)[:, None, None, None]
    t_ = np.arange(n_tiles)[None, :, None, None]
    s_ = np.arange(steps)[None, None, :, None]
    l_ = np.arange(lanes)[None, None, None, :]
    pos = (((t_ * rows + r_) * s4c + s_ // 4) * lanes + l_) * 4 + s_ % 4
    valid = pos < n_valid

    # per-tile histograms over valid bytes: tile t's valid bytes are the
    # contiguous wire range [t*rows*steps*L, ...) of this megablock
    tile_bytes = rows * steps * lanes
    hists = [
        make_tile_hist(flat[t * tile_bytes : min((t + 1) * tile_bytes, n_valid)], bits)
        for t in range(n_tiles)
    ]

    states = np.full((rows, lanes), DECODE_CONSUME_POINT_16, dtype=_U32)
    words = np.zeros((n_tiles, steps, rows, lanes), dtype=np.uint16)
    emits = np.zeros((n_tiles, steps, rows, lanes), dtype=bool)

    for t in range(n_tiles - 1, -1, -1):
        freq_tab = hists[t].symbol_count.astype(_U32)
        cumul_tab = hists[t].cumul.astype(_U32)
        for s in range(steps - 1, -1, -1):
            b = view[:, t, s]
            v = valid[:, t, s]
            freq = freq_tab[b]
            emit = (states >= emit_point * np.maximum(freq, 1)) & v
            words[t, s] = np.where(emit, (states & _U32(0xFFFF)).astype(np.uint16), 0)
            emits[t, s] = emit
            states = np.where(emit, states >> _U32(16), states)
            new_states = ((states // np.maximum(freq, 1)) << _U32(bits)) + cumul_tab[b] + (states % np.maximum(freq, 1))
            states = np.where(v, new_states, states)

    # per-row per-tile forward streams = reversed emission order
    counts = emits.transpose(0, 2, 1, 3).reshape(n_tiles, rows, -1).sum(axis=2)
    max_words = int(counts.max()) if counts.size else 0
    w_slots = max(128, -(-(-(-max_words // 2)) // 128) * 128)
    stream = np.zeros((n_tiles, rows, w_slots), dtype=np.uint32)
    for t in range(n_tiles):
        wt = words[t].transpose(1, 0, 2).reshape(rows, -1)  # [rows, steps*lanes] fwd order
        et = emits[t].transpose(1, 0, 2).reshape(rows, -1)
        for r in range(rows):
            rw = wt[r][et[r]].astype(np.uint32)
            if rw.size & 1:
                rw = np.concatenate([rw, [np.uint32(0)]])
            stream[t, r, : rw.size // 2] = rw[0::2] | (rw[1::2] << np.uint32(16))

    _write_mega(out, n_tiles, w_slots, states, [h.symbol_count for h in hists], counts, stream)


def tpx_encode(data: bytes | np.ndarray, bits: int = 12, p: TpxParams | None = None, goal: str = "balanced") -> bytes:
    arr = np.frombuffer(data, dtype=np.uint8) if isinstance(data, (bytes, bytearray, memoryview)) else np.asarray(data, dtype=np.uint8)
    length = arr.size
    p = p or TpxParams.auto(length, bits, goal)
    bits = p.bits

    out = tpx_header(length, p)
    for mega_base, n_tiles, valid_bytes in _mega_layout(length, p):
        _encode_mega_into(out, arr, mega_base, n_tiles, valid_bytes, bits, p.rows, p.steps, p.lanes)

    total = len(out)
    out[16:24] = total.to_bytes(8, "little")
    return bytes(out)


@dataclass
class MegaGeom:
    """One v3 megablock's geometry: covers rows * n_tiles * steps * 128
    bytes from `base` (the last mega may be partial)."""
    base: int
    rows: int
    steps: int
    n_tiles: int

    @property
    def span(self) -> int:
        return self.rows * self.n_tiles * self.steps * L


def tpx_plan_geometry(arr: np.ndarray, bits: int) -> list[MegaGeom]:
    """Planner-informed per-region geometry (the _CanExtendHist analog,
    block_rANS32x64_16w_encode.cpp:58-133, reused via ops/planner.py).

    The greedy mt planner segments the input into histogram-homogeneous
    blocks; each run of similarly-sized plan blocks becomes one megablock
    whose TILE SPAN tracks the local block size (histograms stay inside
    one content region) while the CHAIN COUNT stays high by shrinking
    steps instead of rows — hist locality and parallelism decouple:

      region block size   tile span   rows x steps (span = rows*steps*128)
      >= 4 MiB (homog.)     4 MiB     1024 x 32   (the default geometry)
      >= 1 MiB              1 MiB     1024 x 8
      >= 256 KiB          256 KiB      256 x 8
      else                128 KiB      128 x 8
    """
    from .planner import plan_blocks

    length = arr.size
    if length == 0:
        return [MegaGeom(0, 8, 4, 1)]
    plan = plan_blocks(arr, bits, "mt", 64)

    def geom_of(block_size: int) -> tuple[int, int]:
        if block_size >= 4 << 20:
            return 1024, 32
        if block_size >= 1 << 20:
            return 1024, 8
        if block_size >= 256 << 10:
            return 256, 8
        return 128, 8

    out: list[MegaGeom] = []
    base = 0
    i = 0
    while base < length:
        # geometry of the region starting here: the plan block covering base
        while i + 1 < len(plan) and plan[i + 1].start <= base:
            i += 1
        rows, steps = geom_of(plan[i].size)
        # small-input clamp: the per-mega state snapshot is rows*512 bytes,
        # so rows scale down until the tile span fits the remaining data
        # (same floor as TpxParams.auto)
        rows = min(rows, max(8, (length - base) // (steps * L) // 8 * 8))
        tile_span = rows * steps * L
        # extend the mega while following plan blocks keep the same geometry
        end = min(plan[i].start + plan[i].size, length)
        j = i + 1
        while j < len(plan) and geom_of(plan[j].size) == (rows, steps):
            end = min(plan[j].start + plan[j].size, length)
            j += 1
        n_tiles = max(1, (end - base) // tile_span)
        if base + n_tiles * tile_span >= length:
            n_tiles = max(1, -(-(length - base) // tile_span))
        # cap tiles per mega (TpxParams.auto's bound): bounds the encoder's
        # resident flat buffer; a long homogeneous span just repeats megas
        n_tiles = min(n_tiles, 64)
        out.append(MegaGeom(base, rows, steps, n_tiles))
        base += n_tiles * tile_span
    return out


def tpx_encode_adaptive(data: bytes | np.ndarray, bits: int = 12) -> bytes:
    """v3 encode: per-megablock geometry from `tpx_plan_geometry` — speed
    geometry survives on homogeneous spans, small (hist-local) tiles engage
    only where content shifts pay for them."""
    arr = np.frombuffer(data, dtype=np.uint8) if isinstance(data, (bytes, bytearray, memoryview)) else np.asarray(data, dtype=np.uint8)
    length = arr.size
    geoms = tpx_plan_geometry(arr, bits)

    out = bytearray()
    out += MAGIC3
    out += length.to_bytes(8, "little")
    out += b"\0" * 8
    g0 = geoms[0]
    for v in (bits, g0.rows, L, g0.steps, g0.n_tiles):
        out += int(v).to_bytes(4, "little")
    for g in geoms:
        out += int(g.rows).to_bytes(4, "little")
        out += int(g.steps).to_bytes(4, "little")
        _encode_mega_into(out, arr, g.base, g.n_tiles, max(0, min(length - g.base, g.span)), bits, g.rows, g.steps)

    total = len(out)
    out[16:24] = total.to_bytes(8, "little")
    return bytes(out)


def tpx_header(length: int, p: TpxParams) -> bytearray:
    """Wire header shared by the host and device encoders."""
    out = bytearray()
    out += MAGIC2
    out += length.to_bytes(8, "little")
    out += b"\0" * 8
    for v in (p.bits, p.rows, p.lanes, p.steps, p.tiles):
        out += int(v).to_bytes(4, "little")
    return out


def _write_mega(out, n_tiles, w_slots, states, freqs, counts, stream) -> None:
    """Append one megablock to `out`: header fields, then (v2) each row's
    exact ceil(words/2) stream slots back to back — the counts table already
    in the header is what delimits them, so rectangular padding never
    reaches the wire."""
    out += int(n_tiles).to_bytes(4, "little")
    out += int(w_slots).to_bytes(4, "little")
    out += states.astype("<u4").tobytes()
    for t in range(n_tiles):
        out += np.asarray(freqs[t]).astype("<u2").tobytes()
        out += np.asarray(counts[t]).astype("<u2").tobytes()
    flat = np.ascontiguousarray(stream, dtype=np.uint32).reshape(-1, stream.shape[-1])
    sc = (np.asarray(counts, dtype=np.int64).reshape(-1) + 1) // 2
    starts = np.cumsum(sc) - sc
    total = int(sc.sum())
    row_of = np.repeat(np.arange(flat.shape[0]), sc)
    col_of = np.arange(total) - np.repeat(starts, sc)
    out += flat[row_of, col_of].astype("<u4").tobytes()


@dataclass
class TpxMega:
    base: int
    n_tiles: int
    w_slots: int
    states: np.ndarray  # u32[R, L]
    freqs: np.ndarray  # u16[n_tiles, 256]
    counts: np.ndarray  # u16[n_tiles, R]
    stream: np.ndarray  # u32[n_tiles, R, W]
    rows: int = 0  # per-mega geometry (v3); v1/v2 fill from the header
    steps: int = 0

    @property
    def span(self) -> int:
        return self.rows * self.n_tiles * self.steps * L


def tpx_parse(blob: bytes | np.ndarray) -> tuple[TpxParams, int, list[TpxMega]] | None:
    """Parse the container; None on malformed/truncated input (the
    reference's defensive-header error model, e.g.
    block_rANS32x64_16w_decode.cpp:15-32)."""
    buf = np.frombuffer(blob, dtype=np.uint8) if isinstance(blob, (bytes, bytearray, memoryview)) else np.asarray(blob, dtype=np.uint8)
    if buf.size < 44 or buf[:8].tobytes() not in (MAGIC, MAGIC2, MAGIC3):
        return None
    ragged = buf[:8].tobytes() in (MAGIC2, MAGIC3)
    per_mega_geom = buf[:8].tobytes() == MAGIC3
    length = int.from_bytes(buf[8:16].tobytes(), "little")
    bits, rows, lanes, steps, tiles = (int.from_bytes(buf[24 + 4 * i : 28 + 4 * i].tobytes(), "little") for i in range(5))
    if not (10 <= bits <= 15) or rows < 1 or lanes < 1 or steps < 1 or tiles < 1:
        return None
    if steps % 4 or rows * lanes > (1 << 24) or steps * tiles > (1 << 20):
        return None  # implausible header: refuse before allocating
    p = TpxParams(bits=bits, rows=rows, lanes=lanes, steps=steps, tiles=tiles)
    megas = []
    off = 44
    base = 0
    while base < length or (length == 0 and not megas):
        if per_mega_geom:
            # v3: u32 rows | u32 steps precede each mega's n_tiles; the
            # header values are defaults only.  Same plausibility gates.
            if off + 8 > buf.size:
                return None
            rows = int.from_bytes(buf[off : off + 4].tobytes(), "little")
            steps = int.from_bytes(buf[off + 4 : off + 8].tobytes(), "little")
            if rows < 1 or steps < 1 or steps % 4 or rows * lanes > (1 << 24):
                return None
            off += 8
        if off + 8 > buf.size:
            return None
        n_tiles = int.from_bytes(buf[off : off + 4].tobytes(), "little")
        w_slots = int.from_bytes(buf[off + 4 : off + 8].tobytes(), "little")
        max_tiles = (1 << 20) // steps if per_mega_geom else tiles
        if n_tiles < 1 or n_tiles > max_tiles or w_slots < 1 or w_slots > steps * lanes:
            return None
        need_hdr = 4 * rows * lanes + n_tiles * (512 + 2 * rows)
        if off + 8 + need_hdr > buf.size:
            return None
        off += 8
        states = buf[off : off + 4 * rows * lanes].view("<u4").reshape(rows, lanes).astype(_U32)
        off += 4 * rows * lanes
        freqs = np.zeros((n_tiles, 256), dtype=np.uint16)
        counts = np.zeros((n_tiles, rows), dtype=np.uint16)
        for t in range(n_tiles):
            freqs[t] = buf[off : off + 512].view("<u2")
            off += 512
            counts[t] = buf[off : off + 2 * rows].view("<u2")
            off += 2 * rows
        if ragged:
            # rebuild the rectangular [T, R, W] layout the decoders consume;
            # the wire stores each row's exact ceil(words/2) slots
            sc = (counts.astype(np.int64).reshape(-1) + 1) // 2
            if sc.max(initial=0) > w_slots:
                return None
            total = int(sc.sum())
            if off + 4 * total > buf.size:
                return None
            flat_words = buf[off : off + 4 * total].view("<u4")
            off += 4 * total
            stream = np.zeros((n_tiles * rows, w_slots), dtype=np.uint32)
            starts = np.cumsum(sc) - sc
            row_of = np.repeat(np.arange(n_tiles * rows), sc)
            col_of = np.arange(total) - np.repeat(starts, sc)
            stream[row_of, col_of] = flat_words
            stream = stream.reshape(n_tiles, rows, w_slots)
        else:
            n_stream = n_tiles * rows * w_slots
            if off + 4 * n_stream > buf.size:
                return None
            stream = buf[off : off + 4 * n_stream].view("<u4").reshape(n_tiles, rows, w_slots).astype(np.uint32)
            off += 4 * n_stream
        megas.append(TpxMega(base, n_tiles, w_slots, states, freqs, counts, stream, rows, steps))
        base += rows * n_tiles * steps * lanes
    return p, length, megas


def tpx_decode(blob: bytes | np.ndarray, use_rank_tables: bool = False) -> bytes | None:
    """Numpy reference decode; `use_rank_tables` exercises the C0/bitmask
    lookup path (make_rank_tables) instead of direct cumulInv."""
    parsed = tpx_parse(blob)
    if parsed is None:
        return None
    p, length, megas = parsed
    bits = p.bits
    mask_slot = _U32((1 << bits) - 1)
    max_span = max((m.span for m in megas), default=0)
    out = np.zeros(length + max_span, dtype=np.uint8)

    for mega in megas:
        n_tiles, rows, steps = mega.n_tiles, mega.rows, mega.steps
        row_span = n_tiles * steps * p.lanes
        states = mega.states.copy()
        n_valid = min(length - mega.base, rows * row_span)
        syms_all = np.zeros((n_tiles, steps, rows, p.lanes), dtype=np.uint8)
        lanes_idx = np.arange(p.lanes)

        for t in range(n_tiles):
            hist = complete_hist(mega.freqs[t], bits)
            if hist is None:
                return None
            freq_of = hist.symbol_count.astype(_U32)
            cumul_of = hist.cumul.astype(_U32)
            if use_rank_tables:
                rt = make_rank_tables(hist)
                c0, bm = rt["c0"], rt["bm"].view(np.uint32)
                t1, t2 = rt["t1"].view(np.uint32), rt["t2"].view(np.uint32)
            else:
                inv = make_cumul_inv(hist)
            stream = mega.stream[t]
            r_word = np.zeros((rows, 1), dtype=np.int64)
            s4c = steps // 4
            base_pos = (
                (t * rows + np.arange(rows)[:, None]) * s4c * p.lanes
                + lanes_idx[None, :]
            ) * 4
            for s in range(steps):
                slot = states & mask_slot
                if use_rank_tables:
                    k = (slot >> _U32(5)).astype(np.int64)
                    tbit = slot & _U32(31)
                    m = (_U32(2) << tbit) - _U32(2)
                    rank = (c0[k].astype(_U32) + _popcount(bm[k] & m)).astype(np.int64)
                    v1 = t1[rank]
                    sym = (v1 & _U32(0xFF)).astype(np.int64)
                    freq = v1 >> _U32(8)
                    cumul = t2[rank]
                else:
                    sym = inv[slot].astype(np.int64)
                    freq = freq_of[sym]
                    cumul = cumul_of[sym]
                v = (base_pos + ((s // 4) * p.lanes * 4 + s % 4)) < n_valid
                syms_all[t, s] = np.where(v, sym, 0)
                new_states = (states >> _U32(bits)) * freq + slot - cumul
                states_t = np.where(v, new_states, states)
                consume = (states_t < _U32(DECODE_CONSUME_POINT_16)) & v
                offs = np.cumsum(consume, axis=1) - consume
                widx = r_word + offs
                slot_val = np.take_along_axis(stream, np.minimum((widx >> 1).astype(np.int64), stream.shape[1] - 1), axis=1)
                word = (slot_val >> ((widx & 1) * 16).astype(np.uint32)) & _U32(0xFFFF)
                states = np.where(consume, (states_t << _U32(16)) | word, states_t)
                r_word = r_word + consume.sum(axis=1, keepdims=True)

        # [t, s, r, l] -> wire order [t, r, s4, l, b]
        mega_out = (
            syms_all.reshape(n_tiles, steps // 4, 4, rows, p.lanes)
            .transpose(0, 3, 1, 4, 2)
            .reshape(-1)
        )
        span = min(rows * row_span, out.size - mega.base)
        if span < 0:
            return None  # inconsistent (corrupted) header geometry
        out[mega.base : mega.base + span] = mega_out[:span]
    return out[:length].tobytes()


def _popcount(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint32)
    x = x - ((x >> np.uint32(1)) & np.uint32(0x55555555))
    x = (x & np.uint32(0x33333333)) + ((x >> np.uint32(2)) & np.uint32(0x33333333))
    x = (x + (x >> np.uint32(4))) & np.uint32(0x0F0F0F0F)
    return (x * np.uint32(0x01010101)) >> np.uint32(24)
