"""hsrans — interleaved rANS entropy coding in JAX.

A JAX rebuild of the capabilities of rainerzufalldererste/hypersonic-rANS
(see SURVEY.md):

  * bit-exact wire-format parity codecs: raw rANS32x{16,32,64} 16w,
    rANS32x32 32blk {16w,8w}, block_rANS32x{32,64} 16w (adaptive
    histograms), mt_rANS32x{32,64} 16w (independent blocks)
    — `hsrans.ops.*` (numpy oracle, native C++ host tier);
  * mt blocks on the GPU: `mt_decode_device` (a Pallas kernel on the
    Triton route, `hsrans.kernels`) and `mt_encode_device` (XLA), batched
    over blocks and sharded over a device mesh — `hsrans.parallel`;
  * the tpx tile-parallel format (host codec) — `hsrans.ops.tpx`;
  * C++ host runtime (histograms, block planner, thread pool) —
    `hsrans.runtime.native`;
  * hsrans-compatible CLI — `python -m hsrans.cli`.
"""

from .models.histogram import Hist, make_hist, normalize_hist, observe_hist
from .ops.blk32 import blk32_decode, blk32_decode_host, blk32_encode, blk32_encode_host
from .ops.block import block_decode, block_encode
from .ops.mt import mt_decode, mt_encode
from .ops.reference import raw_decode, raw_decode_16w, raw_encode, raw_encode_16w
from .ops.tpx import TpxParams, tpx_decode, tpx_encode

__all__ = [
    "Hist",
    "make_hist",
    "normalize_hist",
    "observe_hist",
    "raw_encode",
    "raw_decode",
    "raw_encode_16w",
    "raw_decode_16w",
    "blk32_encode",
    "blk32_decode",
    "blk32_encode_host",
    "blk32_decode_host",
    "block_encode",
    "block_decode",
    "mt_encode",
    "mt_decode",
    "TpxParams",
    "tpx_encode",
    "tpx_decode",
    "mt_encode_device",
    "mt_decode_device",
]

__version__ = "0.4.0"


def __getattr__(name: str):
    # device entry points import jax lazily
    if name in ("mt_encode_device", "mt_decode_device"):
        from .parallel import sharded

        return getattr(sharded, name)
    raise AttributeError(name)
