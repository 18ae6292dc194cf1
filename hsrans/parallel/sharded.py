"""mt blocks on the device: batched decode and encode over a 1-D mesh.

Every coded mt block carries its own states and histogram, so blocks are
independent rows of one batched computation (the reference fans them out
to a thread pool, mt_rANS32x64_16w_decode.cpp:217-224).

Decode: the host walks the block headers once (ops.mt.block_index) and
stages one row per coded block: states, first word, output span and the
256 frequencies, plus the blob's u16 word stream.  The rest runs on the
device: slot tables, the decode itself, single-symbol (RLE) runs, and the
bytes placed in output order.  With a mesh, rows are sharded over the mesh
axis with shard_map (the word stream is replicated); each device writes
its rows' disjoint byte spans into a zeroed buffer, and a psum merges them.

  mt_decode_device  decodes with the Pallas kernel (kernels/mt_decode.py):
                    compiled on a GPU, in interpret mode on the CPU.
  mt_decode_scan    the plain-XLA version of the same decode: one lax.scan
                    over lane-group steps (ops/raw_jax.decode_section) with
                    every block padded to the longest.  It is the reference
                    the kernel is checked and timed against.

Encode: blocks are encoded from fresh states, which keeps them independent
in both directions; the blob is valid mt wire (the reference decodes it)
but not byte-equal to the sequential oracle, whose states carry over.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from ..kernels.mt_decode import TILE_ROWS, dec3_rows, decode_tiles, lane_bytes
from ..ops.mt import block_index
from ..ops.planner import BlockPlan, plan_blocks
from ..ops.raw_jax import decode_section, encode_section
from ..rans import DECODE_CONSUME_POINT_16, IDX2IDX


def axis_size(mesh, axis: str) -> int:
    return 1 if mesh is None else mesh.shape[axis]


def _bucket(x: int, floor: int = 1) -> int:
    """Round up to one of 8 sizes per octave, so that shapes (and compiled
    programs) repeat across blobs of similar size."""
    x = max(x, floor)
    step = max(floor, 1 << max(0, (x - 1).bit_length() - 3))
    return -(-x // step) * step


@dataclass
class DecodeRows:
    """Host-staged rows of one mt blob: one per coded block, sorted by step
    count (longest first) and dealt out tile by tile to the devices."""

    length: int
    stream: np.ndarray  # u16[W], zero-padded
    states: np.ndarray  # u32[R, n]
    read_pos: np.ndarray  # i32[R] first word of each block
    out_start: np.ndarray  # i32[R]
    sizes: np.ndarray  # i32[R] bytes each block decodes
    freq: np.ndarray  # u16[R, 256]
    steps: np.ndarray  # i32[R] lane-group steps, ceil(size / n)
    seg_sym: np.ndarray | None  # u8[K] fill byte of every block in order
    seg_len: np.ndarray | None  # i32[K] (None when no block is single-symbol)

    @property
    def out_len(self) -> int:
        return _bucket(self.length + 1, 1 << 10)  # one spare byte (decode_tiles)

    def tile_steps(self, g: int) -> np.ndarray:
        return self.steps.reshape(-1, g).max(axis=1)


def stage_rows(blob: bytes | np.ndarray, bits: int, n: int, g: int = TILE_ROWS, n_dev: int = 1) -> DecodeRows | None:
    """Index an mt blob and stage its coded blocks as device rows; None if
    the blob is malformed.

    The final coded block also decodes the trailing partial lane group, so
    its size runs to the end of the output; earlier blocks stop at their
    own size (a non-final block's last group is decoded, by the oracle, in
    full, but those extra bytes belong to the next block and are
    overwritten there)."""
    idx = block_index(blob, n)
    if idx is None:
        return None
    length, stream, blocks = idx
    if length >= 1 << 31:
        raise ValueError("the device decode handles outputs below 2 GiB")
    coded = [b for b in blocks if not b.is_single]
    total = 1 << bits
    freq = np.stack([b.freq for b in coded]) if coded else np.zeros((0, 256), np.uint16)
    if np.any(freq.sum(axis=1, dtype=np.uint64) != total):
        return None
    sizes = np.asarray([length - b.out_start if b.is_last else b.size for b in coded], np.int64)
    steps = -(-sizes // n)

    unit = g * n_dev
    r_pad = _bucket(-(-max(len(coded), 1) // unit)) * unit
    pad = r_pad - len(coded)
    # longest rows first, then tile t goes to device t % n_dev
    order = np.argsort(-steps, kind="stable")
    tiles = np.arange(r_pad // g).reshape(-1, n_dev).T.reshape(-1)
    rows = (tiles[:, None] * g + np.arange(g)).reshape(-1)

    def arrange(a, fill=0):
        a = np.concatenate([a[order], np.full((pad,) + a.shape[1:], fill, a.dtype)])
        return a[rows]

    pad_freq = np.zeros(256, np.uint16)
    pad_freq[0] = total  # padding rows decode nothing, but get a valid table
    w = np.zeros(_bucket(stream.size, 1 << 10), np.uint16)
    w[: stream.size] = stream

    seg_sym = seg_len = None
    if len(coded) < len(blocks):
        k = _bucket(len(blocks))
        seg_sym = np.zeros(k, np.uint8)
        seg_len = np.zeros(k, np.int32)
        for j, b in enumerate(blocks):
            seg_sym[j] = b.symbol if b.is_single else 0
            seg_len[j] = (length - b.out_start) if b.is_last else min(b.size, length - b.out_start)

    return DecodeRows(
        length=length,
        stream=w,
        states=arrange(np.stack([b.states for b in coded]) if coded else np.zeros((0, n), np.uint32)),
        read_pos=arrange(np.asarray([b.word_start for b in coded], np.int32)),
        out_start=arrange(np.asarray([b.out_start for b in coded], np.int32)),
        sizes=arrange(sizes.astype(np.int32)),
        freq=arrange(freq, pad_freq),
        steps=arrange(steps.astype(np.int32)),
        seg_sym=seg_sym,
        seg_len=seg_len,
    )


def _on_rows(local, row_args, stream, seg_sym, seg_len, out_len, mesh, axis):
    """Run `local(*row_args, stream) -> u8[out_len]` (the coded bytes,
    zeros elsewhere) over all rows, sharded over `axis` when a mesh is
    given, then lay the single-symbol runs over it."""
    if mesh is None:
        out = local(*row_args, stream)
    else:
        out = jax.shard_map(
            lambda *a: jax.lax.psum(local(*a), axis),
            mesh=mesh,
            in_specs=(P(axis),) * len(row_args) + (P(),),
            out_specs=P(),
            check_vma=False,
        )(*row_args, stream)
    if seg_sym is not None:
        out = out | jnp.repeat(seg_sym, seg_len, total_repeat_length=out_len)
    return out


@partial(jax.jit, static_argnames=("bits", "n", "out_len", "interpret", "mesh", "axis"))
def _decode_kernel_rows(tile_steps, states, read_pos, out_start, sizes, freq, stream, seg_sym, seg_len, *, bits, n, out_len, interpret, mesh, axis):
    def local(tile_steps, states, read_pos, out_start, sizes, freq, stream):
        out = jnp.zeros(out_len, jnp.uint8)
        return decode_tiles(
            tile_steps, states, read_pos, out_start, sizes, freq, stream, out,
            bits=bits, n=n, interpret=interpret,
        )

    row_args = (tile_steps, states, read_pos, out_start, sizes, freq)
    return _on_rows(local, row_args, stream, seg_sym, seg_len, out_len, mesh, axis)


@partial(jax.jit, static_argnames=("bits", "n", "num_steps", "out_len", "mesh", "axis"))
def _decode_scan_rows(states, read_pos, out_start, sizes, freq, stream, seg_sym, seg_len, *, bits, n, num_steps, out_len, mesh, axis):
    def local(states, read_pos, out_start, sizes, freq, stream):
        t = dec3_rows(freq, bits)
        syms, _, _ = decode_section(
            states, stream, read_pos, t["sym"], t["freq"].astype(jnp.uint16), t["cumul"].astype(jnp.uint16),
            sizes, bits=bits, num_steps=num_steps, tail=True,
        )
        byte = jnp.arange(num_steps, dtype=jnp.int32)[:, None] * n + lane_bytes(jnp.arange(n, dtype=jnp.int32))
        pos = jnp.where(byte < sizes[:, None, None], out_start[:, None, None] + byte, out_len)
        return jnp.zeros(out_len, jnp.uint8).at[pos.reshape(-1)].set(syms.reshape(-1), mode="drop")

    row_args = (states, read_pos, out_start, sizes, freq)
    return _on_rows(local, row_args, stream, seg_sym, seg_len, out_len, mesh, axis)


def _seg_args(rows: DecodeRows):
    if rows.seg_sym is None:
        return None, None
    return jnp.asarray(rows.seg_sym), jnp.asarray(rows.seg_len)


def mt_decode_device(
    blob: bytes | np.ndarray,
    bits: int,
    n: int,
    mesh: jax.sharding.Mesh | None = None,
    axis: str = "dp",
) -> bytes | None:
    """Decode an mt blob (n in {32, 64}, B in 10..15) on the device; None if
    it is malformed.  Every coded block decodes in the kernel, the final
    partial lane group included; with `mesh`, rows shard over `axis`."""
    from ..runtime.device import detect

    if n not in (32, 64) or not 10 <= bits <= 15:
        raise ValueError(f"the device decode takes n in (32, 64) and B in 10..15, not n={n}, B={bits}")
    interpret = detect().pallas_interpret
    rows = stage_rows(blob, bits, n, TILE_ROWS, axis_size(mesh, axis))
    if rows is None:
        return None
    if rows.length == 0:
        return b""
    out = _decode_kernel_rows(
        jnp.asarray(rows.tile_steps(TILE_ROWS)), jnp.asarray(rows.states), jnp.asarray(rows.read_pos),
        jnp.asarray(rows.out_start), jnp.asarray(rows.sizes), jnp.asarray(rows.freq), jnp.asarray(rows.stream),
        *_seg_args(rows), bits=bits, n=n, out_len=rows.out_len,
        interpret=interpret, mesh=mesh, axis=axis,
    )
    return np.asarray(out)[: rows.length].tobytes()


def mt_decode_scan(
    blob: bytes | np.ndarray,
    bits: int,
    n: int,
    mesh: jax.sharding.Mesh | None = None,
    axis: str = "dp",
) -> bytes | None:
    """The same decode as `mt_decode_device`, in plain XLA: a lax.scan over
    the longest block's lane-group steps for all blocks at once."""
    rows = stage_rows(blob, bits, n, 1, axis_size(mesh, axis))
    if rows is None:
        return None
    if rows.length == 0:
        return b""
    out = _decode_scan_rows(
        jnp.asarray(rows.states), jnp.asarray(rows.read_pos), jnp.asarray(rows.out_start),
        jnp.asarray(rows.sizes), jnp.asarray(rows.freq), jnp.asarray(rows.stream), *_seg_args(rows),
        bits=bits, n=n, num_steps=_bucket(int(rows.steps.max(initial=1))), out_len=rows.out_len,
        mesh=mesh, axis=axis,
    )
    return np.asarray(out)[: rows.length].tobytes()


# ---------------------------------------------------------------------------
# Encode


def uniform_plan(data: np.ndarray, bits: int, n: int, block_size: int = 1 << 16) -> list[BlockPlan]:
    """Fixed-size segmentation: every block has the same step count.

    Valid per the wire format (block sizes are free)."""
    length = data.size
    starts = list(range(0, length, block_size))
    # The trailing partial lane group must belong to the last block's chain
    # (the decoder's tail path continues the last block's stream), so the
    # remainder is merged into the final block rather than given its own.
    if len(starts) > 1 and length - starts[-1] < n:
        starts.pop()
    from ..ops.tpx import make_tile_hist  # native C++ fast path when built

    rows = []
    for i, start in enumerate(starts):
        end = starts[i + 1] if i + 1 < len(starts) else length
        freq = make_tile_hist(data[start:end], bits).symbol_count
        rows.append(BlockPlan(start, end - start, False, 0, freq))
    return rows


def device_plan(
    data: np.ndarray, bits: int, n: int = 64, max_block: int = 32 << 10
) -> list[BlockPlan]:
    """Greedy plan with coded blocks capped at `max_block`.

    The reference's greedy planner (ops/planner.py, mirror of
    mt_rANS32x64_16w_encode.cpp:21-133) coalesces homogeneous spans into
    blocks of up to 2^25 bytes: right for its 32 threads, but a batched
    device decode needs many more independent blocks.  This keeps the
    planner's content cuts and its free RLE single-symbol rows, and splits
    oversized coded blocks into 512-aligned pieces.  Consecutive pieces
    share one histogram in pairs, computed over their joint span (x-ray at
    B10: ratio 0.8014, against 0.8097 with the parent's histogram and
    0.8023 for the reference planner).  Any segmentation is valid wire; the
    blob stays decodable by the reference.
    """
    from ..ops.tpx import make_tile_hist

    rows = plan_blocks(data, bits, "mt", n)
    out: list[BlockPlan] = []
    for r in rows:
        if r.is_single or r.size <= max_block:
            out.append(r)
            continue
        n_pieces = -(-r.size // max_block)
        base = r.size // n_pieces // 512 * 512
        if base == 0:
            out.append(r)
            continue
        starts = [r.start + i * base for i in range(n_pieces)]
        ends = starts[1:] + [r.start + r.size]
        for p in range(0, n_pieces, 2):
            s0, e_last = starts[p], ends[min(p + 1, n_pieces - 1)]
            freq = make_tile_hist(data[s0:e_last], bits).symbol_count
            for s, e in zip(starts[p : p + 2], ends[p : p + 2]):
                out.append(BlockPlan(s, e - s, False, 0, freq))
    return out


@partial(jax.jit, static_argnames=("bits", "num_steps", "mesh", "axis"))
def _encode_batched(states, group_bytes, valid, freq_tab, cumul_tab, *, bits, num_steps, mesh, axis):
    def local(states, group_bytes, valid, freq_tab, cumul_tab):
        return encode_section(
            states, group_bytes, valid, freq_tab, cumul_tab, bits=bits, num_steps=num_steps
        )

    if mesh is None:
        return local(states, group_bytes, valid, freq_tab, cumul_tab)

    shard = P(axis)
    fn = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(shard, shard, shard, shard, shard),
        out_specs=(shard, shard, shard),
        check_vma=False,
    )
    return fn(states, group_bytes, valid, freq_tab, cumul_tab)


def mt_encode_device(
    data: bytes | np.ndarray,
    bits: int,
    n: int,
    mesh: jax.sharding.Mesh | None = None,
    axis: str = "dp",
    plan: list[BlockPlan] | None = None,
) -> bytes:
    """Encode to the mt wire format with blocks batched on the device
    (ops/raw_jax.encode_section, every block padded to the longest).

    The plan defaults to `device_plan`; coded rows without a histogram get
    one from their own bytes.  With `mesh`, blocks shard over `axis`."""
    arr = np.frombuffer(data, dtype=np.uint8) if isinstance(data, (bytes, bytearray, memoryview)) else np.asarray(data, dtype=np.uint8)
    length = arr.size
    if plan is None:
        plan = device_plan(arr, bits, n)

    from ..ops.tpx import make_tile_hist

    # plan rows without a histogram get one from their own bytes
    coded = [
        (k, row if row.freq is not None else BlockPlan(row.start, row.size, False, 0, make_tile_hist(arr[row.start : row.start + row.size], bits).symbol_count))
        for k, row in enumerate(plan)
        if not row.is_single
    ]
    parts: list[bytes] = [b""] * len(plan)
    for k, row in enumerate(plan):
        if row.is_single:
            parts[k] = (row.size | (1 << 63) | (row.symbol << 54)).to_bytes(8, "little")

    if coded:
        n_dev = axis_size(mesh, axis)
        B = len(coded)
        s_max = max(-(-row.size // n) for _, row in coded)
        pad_b = (-B) % n_dev
        perm = IDX2IDX[n]

        gb = np.zeros((B + pad_b, s_max, n), dtype=np.uint8)
        gv = np.zeros((B + pad_b, s_max, n), dtype=bool)
        ft = np.ones((B + pad_b, 256), dtype=np.uint16)
        ct = np.zeros((B + pad_b, 256), dtype=np.uint16)
        for i, (_, row) in enumerate(coded):
            end = min(row.start + row.size, length)
            total = -(-row.size // n)
            padded = np.zeros(total * n, dtype=np.uint8)
            padded[: end - row.start] = arr[row.start : end]
            pos = np.arange(total, dtype=np.int64)[:, None] * n + perm[None, :]
            gb[i, :total] = padded[pos]
            gv[i, :total] = (row.start + pos) < end
            ft[i] = row.freq
            ct[i, 1:] = np.cumsum(row.freq[:-1].astype(np.uint64)).astype(np.uint16)

        init = np.full((B + pad_b, n), DECODE_CONSUME_POINT_16, dtype=np.uint32)
        words, emits, fin = _encode_batched(
            jnp.asarray(init), jnp.asarray(gb), jnp.asarray(gv), jnp.asarray(ft), jnp.asarray(ct),
            bits=bits, num_steps=s_max, mesh=mesh, axis=axis,
        )
        words = np.asarray(words)
        emits = np.asarray(emits)
        fin = np.asarray(fin)

        for i, (k, row) in enumerate(coded):
            w = words[i][emits[i]]
            offset = 2 * n + 256 + w.size - (2 if k == len(plan) - 1 else 1)
            parts[k] = (
                int(row.size).to_bytes(8, "little")
                + int(offset).to_bytes(8, "little")
                + fin[i].astype("<u4").tobytes()
                + row.freq.astype("<u2").tobytes()
                + w.astype("<u2").tobytes()
            )

    out = bytearray()
    out += int(length).to_bytes(8, "little")
    out += b"\0" * 8
    for p in parts:
        out += p
    out[8:16] = len(out).to_bytes(8, "little")
    return bytes(out)
