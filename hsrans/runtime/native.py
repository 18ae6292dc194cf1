"""ctypes bindings to the C++ host runtime (native/libhsrans_native.so).

The native library carries the host-side hot paths: byte histogramming,
exact float32 histogram normalization, the greedy block-segmentation
planner, FNV hashing, and a thread pool for host-side pipelining.  Every
entry point has a pure-numpy fallback (hsrans.models / ops) so the
framework works without a compiled library; tests assert both agree.
"""

from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path

import numpy as np

_REPO = Path(__file__).resolve().parent.parent.parent
_SO = _REPO / "native" / "libhsrans_native.so"

_lib = None


class PlanRow(ctypes.Structure):
    _fields_ = [
        ("start", ctypes.c_uint64),
        ("size", ctypes.c_uint64),
        ("is_single", ctypes.c_uint32),
        ("symbol", ctypes.c_uint32),
        ("freq", ctypes.c_uint16 * 256),
    ]


def _build() -> bool:
    try:
        subprocess.run(
            ["make", "-C", str(_REPO / "native"), "-s"],
            check=True,
            capture_output=True,
            timeout=120,
        )
        return _SO.exists()
    except Exception:
        return False


def load(build_if_missing: bool = True):
    """Load (building on demand) the native library; None if unavailable."""
    global _lib
    if _lib is not None:
        return _lib
    if build_if_missing:
        _build()  # make is mtime-based: rebuilds only when sources changed
    if not _SO.exists():
        return None
    lib = ctypes.CDLL(str(_SO))

    lib.hsr_fnv1a.restype = ctypes.c_uint64
    lib.hsr_fnv1a.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
    lib.hsr_observe_hist.restype = None
    lib.hsr_observe_hist.argtypes = [
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_uint32),
    ]
    lib.hsr_normalize_hist.restype = None
    lib.hsr_normalize_hist.argtypes = [
        ctypes.POINTER(ctypes.c_uint32),
        ctypes.c_uint64,
        ctypes.c_uint32,
        ctypes.POINTER(ctypes.c_uint16),
        ctypes.POINTER(ctypes.c_uint16),
    ]
    lib.hsr_hist_blocks.restype = None
    lib.hsr_hist_blocks.argtypes = [
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_uint64,
        ctypes.c_uint64,
        ctypes.c_uint32,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint16),
        ctypes.POINTER(ctypes.c_uint16),
        ctypes.c_int32,
    ]
    lib.hsr_plan_blocks.restype = ctypes.c_int64
    lib.hsr_plan_blocks.argtypes = [
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_uint64,
        ctypes.c_uint32,
        ctypes.c_uint32,
        ctypes.c_uint64,
        ctypes.POINTER(PlanRow),
        ctypes.c_int64,
    ]
    buf_sig = [
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_uint64,
        ctypes.c_uint32,
        ctypes.c_uint32,
    ]
    for fn in (
        "hsr_raw_encode",
        "hsr_raw_decode",
        "hsr_block_encode",
        "hsr_block_decode",
        "hsr_mt_encode",
        "hsr_blk32_encode",
        "hsr_blk32_decode",
    ):
        getattr(lib, fn).restype = ctypes.c_int64
        getattr(lib, fn).argtypes = buf_sig
    lib.hsr_mt_decode.restype = ctypes.c_int64
    lib.hsr_mt_decode.argtypes = buf_sig + [ctypes.c_int32]
    _lib = lib
    return lib


def fnv1a(data: bytes) -> int:
    lib = load()
    if lib is None:
        h = 0xCBF29CE484222325
        for b in data:
            h = ((h ^ b) * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
        return h
    return int(lib.hsr_fnv1a(bytes(data), len(data)))


def observe_hist(data: np.ndarray) -> np.ndarray | None:
    lib = load()
    if lib is None:
        return None
    data = np.ascontiguousarray(data, dtype=np.uint8)
    out = np.zeros(256, dtype=np.uint32)
    lib.hsr_observe_hist(
        data.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        data.size,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
    )
    return out


def normalize_hist(hist: np.ndarray, data_bytes: int, bits: int) -> tuple[np.ndarray, np.ndarray] | None:
    lib = load()
    if lib is None:
        return None
    hist = np.ascontiguousarray(hist, dtype=np.uint32)
    freq = np.zeros(256, dtype=np.uint16)
    cumul = np.zeros(256, dtype=np.uint16)
    lib.hsr_normalize_hist(
        hist.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        data_bytes,
        bits,
        freq.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        cumul.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
    )
    return freq, cumul


def hist_blocks(data: np.ndarray, block_size: int, bits: int, n_blocks: int, threads: int = 0) -> tuple[np.ndarray, np.ndarray] | None:
    """Batched observe+normalize for uniform blocks (threaded C++).

    Returns (freq u16[n_blocks, 256], cumul u16[n_blocks, 256]); the final
    block covers the remainder; blocks past the data get 1-symbol hists.
    """
    lib = load()
    if lib is None:
        return None
    data = np.ascontiguousarray(data, dtype=np.uint8)
    freq = np.zeros((n_blocks, 256), dtype=np.uint16)
    cumul = np.zeros((n_blocks, 256), dtype=np.uint16)
    lib.hsr_hist_blocks(
        data.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        data.size,
        block_size,
        bits,
        n_blocks,
        freq.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        cumul.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        threads,
    )
    return freq, cumul


def plan_blocks(data: np.ndarray, bits: int, mode: str, state_count: int) -> list[dict] | None:
    """Greedy block segmentation via the native planner.

    mode: "block" (cross-block state continuity codec) or "mt" (independent
    blocks).  Returns rows in input order (reversed from plan order).
    """
    lib = load()
    if lib is None:
        return None
    data = np.ascontiguousarray(data, dtype=np.uint8)
    max_rows = int(data.size // (1 << 15)) + 16
    rows = (PlanRow * max_rows)()
    n = lib.hsr_plan_blocks(
        data.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        data.size,
        bits,
        1 if mode == "mt" else 0,
        state_count,
        rows,
        max_rows,
    )
    if n <= 0:
        return None
    out = []
    for i in range(n - 1, -1, -1):  # planner emits last block first
        r = rows[i]
        out.append(
            {
                "start": int(r.start),
                "size": int(r.size),
                "is_single": bool(r.is_single),
                "symbol": int(r.symbol),
                "freq": np.ctypeslib.as_array(r.freq).copy(),
            }
        )
    return out


def _u8p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _codec_encode(fn_name: str, data: np.ndarray, bits: int, n: int, capacity: int) -> bytes | None:
    lib = load()
    if lib is None:
        return None
    data = np.ascontiguousarray(data, dtype=np.uint8)
    out = np.zeros(capacity, dtype=np.uint8)
    got = getattr(lib, fn_name)(_u8p(data), data.size, _u8p(out), out.size, bits, n)
    return out[:got].tobytes() if got >= 0 else None


def codec_call_len(fn_name: str, src: np.ndarray, dst: np.ndarray, bits: int, n: int, *extra) -> int:
    """Raw timed entry for benchmarking: src/dst are caller-owned reusable
    buffers (the reference bench preallocates both, main.cpp:627-680), no
    bytes copy-out.  Returns the native return value."""
    lib = load()
    return int(getattr(lib, fn_name)(_u8p(src), src.size, _u8p(dst), dst.size, bits, n, *extra))


def _codec_decode(fn_name: str, blob, bits: int, n: int, *extra, out: np.ndarray | None = None) -> bytes | None:
    lib = load()
    if lib is None:
        return None
    buf = np.frombuffer(blob, dtype=np.uint8) if isinstance(blob, (bytes, bytearray, memoryview)) else np.ascontiguousarray(blob, dtype=np.uint8)
    if buf.size < 16:
        return None
    length = int.from_bytes(buf[:8].tobytes(), "little")
    if length > (1 << 40):
        return None  # implausible header; avoid huge allocation
    if out is None or out.size < length:
        try:
            # the header length is untrusted: a forged rawLength below the
            # plausibility cap can still exceed available memory, and the
            # malformed-input contract is "return None, never raise"
            out = np.zeros(max(length, 1), dtype=np.uint8)
        except MemoryError:
            return None
    got = getattr(lib, fn_name)(_u8p(buf), buf.size, _u8p(out), out.size, bits, n, *extra)
    return out[:got].tobytes() if got >= 0 else None


def raw_encode(data: np.ndarray, bits: int, n: int) -> bytes | None:
    """Native rANS32xN 16w raw encode (hist computed internally)."""
    return _codec_encode("hsr_raw_encode", data, bits, n, data.size + n * 8 + 1024 + (data.size >> 2))


def raw_decode(blob, bits: int, n: int, out: np.ndarray | None = None) -> bytes | None:
    return _codec_decode("hsr_raw_decode", blob, bits, n, out=out)


def block_encode(data: np.ndarray, bits: int, n: int) -> bytes | None:
    cap = data.size + (data.size >> 2) + ((data.size >> 15) + 4) * (8 + 512) + n * 8 + 1024
    return _codec_encode("hsr_block_encode", data, bits, n, cap)


def block_decode(blob, bits: int, n: int, out: np.ndarray | None = None) -> bytes | None:
    return _codec_decode("hsr_block_decode", blob, bits, n, out=out)


def mt_encode(data: np.ndarray, bits: int, n: int) -> bytes | None:
    cap = data.size + (data.size >> 2) + ((data.size >> 15) + 4) * (16 + 512 + 4 * n) + n * 8 + 1024
    return _codec_encode("hsr_mt_encode", data, bits, n, cap)


def mt_decode(blob, bits: int, n: int, threads: int = 0, out: np.ndarray | None = None) -> bytes | None:
    """Native mt decode; blocks fan out to the C++ thread pool."""
    return _codec_decode("hsr_mt_decode", blob, bits, n, threads, out=out)


def blk32_encode(data: np.ndarray, bits: int, word_bits: int) -> bytes | None:
    """Native 32blk encode (16w/8w); hist computed internally."""
    cap = data.size + (data.size >> 2) + 32 * 8 + 1024
    return _codec_encode("hsr_blk32_encode", data, bits, word_bits, cap)


def blk32_decode(blob, bits: int, word_bits: int, out: np.ndarray | None = None) -> bytes | None:
    return _codec_decode("hsr_blk32_decode", blob, bits, word_bits, out=out)
