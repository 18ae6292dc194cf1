"""mt block decode for the GPU: one Pallas kernel on the Triton route.

One program decodes a tile of G mt blocks, each an n-lane interleaved rANS
stream (n in {32, 64}), held as a [G, n] tile of 32-bit states in
registers.  The lane-group steps run as a loop inside the program, so a
state never leaves the chip between steps.  Each step:

  * slot = x & (2^B - 1), one load from the block's flat slot table
    (B <= 12: sym | bias << 8 | (freq-1) << 20) or two (B > 12: a
    bias | (freq-1) << 16 word and a u8 symbol table);
  * x' = (x >> B) * freq + bias, with bias = slot - cumul[sym];
  * the exclusive cumsum of the consume mask (x' < 2^15) across the n
    lanes gives each consuming lane its offset into the block's u16 word
    stream; one gather at read_pos + offset refills it;
  * the n decoded bytes are stored in wire order: lane j owns byte
    step * n + idx2idx[j] of its block (idx2idx in closed form below).

Blocks of different sizes share one launch.  Each row carries its own byte
count; a lane decodes (and consumes) only while its byte index is below
it, which is also how the final block's partial lane group is masked.
The host sorts rows by step count so the G rows of a tile end together,
and each tile loops for its own longest row (`tile_steps`).

Slot tables are built on the device from the blocks' 256-entry
frequencies (`packed_tables`), so only the wire's own header fields cross
from the host.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from ..models.jax_hist import make_dec3_device
from ..rans import DECODE_CONSUME_POINT_16

# Rows (mt blocks) per program and warps per program, chosen on the H100
# (PERF.md): a [G, n] tile is a few registers per thread, and enough
# programs stay resident to cover the load latency of the serial chain.
TILE_ROWS = 4
NUM_WARPS = 4


def lane_bytes(lanes: jax.Array) -> jax.Array:
    """idx2idx[j] for n in {32, 64} (rans.IDX2IDX) as integer arithmetic:
    within each 32 lanes, lane 8a + 4b + c owns byte 4a + 16b + c."""
    return (lanes & 3) | (((lanes >> 3) & 3) << 2) | (((lanes >> 2) & 1) << 4) | (lanes & 32)


def dec3_rows(freq: jax.Array, bits: int) -> dict[str, jax.Array]:
    """The flat slot-indexed dec3 tables (models/jax_hist.make_dec3_device)
    for a batch of blocks: freq u16[R, 256] -> sym, freq, cumul [R, 2^bits].
    Frequencies must sum to 2^bits per row (the host checks that first)."""
    f = freq.astype(jnp.uint32)
    return jax.vmap(partial(make_dec3_device, bits=bits))(f, jnp.cumsum(f, axis=1) - f)


def packed_tables(freq: jax.Array, bits: int) -> tuple[jax.Array, ...]:
    """The kernel's slot tables: one u32 word per slot, plus a u8 symbol
    table when B > 12 leaves no room for the symbol in that word."""
    t = dec3_rows(freq, bits)
    bias = jnp.arange(1 << bits, dtype=jnp.uint32) - t["cumul"]
    if bits <= 12:
        word = t["sym"].astype(jnp.uint32) | (bias << 8) | ((t["freq"] - 1) << 20)
        return (word.reshape(-1),)
    return (bias | ((t["freq"] - 1) << 16)).reshape(-1), t["sym"].reshape(-1)


def _decode_kernel(tile_steps_ref, states_ref, read_pos_ref, out_start_ref, sizes_ref, *refs, g, n, bits, n_words):
    tab_ref, *sym_ref, stream_ref, _, out_ref = refs
    pid = pl.program_id(0)
    rows = pid * g + jnp.arange(g, dtype=jnp.int32)
    lanes = jnp.arange(n, dtype=jnp.int32)
    perm = lane_bytes(lanes)[None, :]
    tab_base = rows[:, None] * (1 << bits)
    sizes = sizes_ref[rows][:, None]
    out_base = out_start_ref[rows][:, None] + perm
    x0 = states_ref[rows[:, None] * n + lanes[None, :]]
    mask_slot = jnp.uint32((1 << bits) - 1)

    def step(s, carry):
        x, r = carry
        byte = s * n + perm
        valid = byte < sizes
        idx = tab_base + (x & mask_slot).astype(jnp.int32)
        t = tab_ref[idx]
        if bits <= 12:
            sym = t & 0xFF
            bias = (t >> 8) & 0xFFF
            freq = (t >> 20) + 1
        else:
            sym = sym_ref[0][idx]
            bias = t & 0xFFFF
            freq = (t >> 16) + 1
        xn = jnp.where(valid, (x >> bits) * freq + bias, x)
        consume = valid & (xn < DECODE_CONSUME_POINT_16)
        c = consume.astype(jnp.int32)
        offs = jnp.cumsum(c, axis=1) - c
        widx = jnp.minimum(r[:, None] + offs, n_words - 1)
        w = pl_triton.load(stream_ref.at[widx], mask=consume, other=0).astype(jnp.uint32)
        x = jnp.where(consume, (xn << 16) | w, xn)
        # masked-off lanes also aim at the spare last byte: interpret mode
        # writes every lane back, and must not clobber another row's bytes
        pos = jnp.where(valid, out_base + s * n, out_ref.shape[0] - 1)
        pl_triton.store(out_ref.at[pos], sym.astype(jnp.uint8), mask=valid)
        return x, r + jnp.sum(c, axis=1)

    jax.lax.fori_loop(0, tile_steps_ref[pid], step, (x0, read_pos_ref[rows]))


def decode_tiles(tile_steps, states, read_pos, out_start, sizes, freq, stream, out, *, bits, n, interpret=False):
    """Decode every row into `out` (u8, returned updated; its last byte is
    scratch and must lie past the output); callable inside jit and
    shard_map.  Rows are grouped TILE_ROWS to a program in order; tile k
    runs tile_steps[k] steps.  states u32[R, n]; read_pos, out_start,
    sizes i32[R]; freq u16[R, 256]; stream u16[W]."""
    tables = packed_tables(freq, bits)
    args = (tile_steps, states.reshape(-1), read_pos, out_start, sizes, *tables, stream, out)
    return pl.pallas_call(
        partial(_decode_kernel, g=TILE_ROWS, n=n, bits=bits, n_words=stream.shape[0]),
        out_shape=jax.ShapeDtypeStruct(out.shape, out.dtype),
        grid=(tile_steps.shape[0],),
        input_output_aliases={len(args) - 1: 0},
        interpret=interpret,
        backend="triton",
        compiler_params=pl_triton.CompilerParams(num_warps=NUM_WARPS, num_stages=1),
        name="mt_decode",
    )(*args)
