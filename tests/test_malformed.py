"""Malformed-input hardening: decoders must return None/empty, never raise.

The reference's error model is `return 0` on defensive header checks
(e.g. block_rANS32x64_16w_decode.cpp:15-32); ours is None.  Truncations
and bit flips in headers must not escape as exceptions.
"""

import numpy as np
import pytest

from hsrans.ops.blk32 import blk32_decode
from hsrans.ops.block import block_decode, block_encode
from hsrans.ops.mt import mt_decode, mt_encode
from hsrans.ops.reference import raw_decode_16w, raw_encode_16w
from hsrans.models.histogram import make_hist
from hsrans.ops.tpx import tpx_decode, tpx_encode


def _data():
    rng = np.random.default_rng(21)
    from tools.gen_inputs import text_like

    return text_like(rng, 40_000)


CUTS = (0, 7, 8, 15, 16, 43, 44, 100, 800, 1000, -1)


def _truncations(blob):
    for cut in CUTS:
        yield blob[: cut if cut >= 0 else len(blob) - 1]


def test_tpx_truncations_safe():
    blob = tpx_encode(_data(), 12)
    assert tpx_decode(blob) == _data().tobytes()
    for t in _truncations(blob):
        out = tpx_decode(t)
        assert out is None or isinstance(out, bytes)


def test_raw_truncations_safe():
    data = _data()
    blob = raw_encode_16w(data, make_hist(data, 12), 64)
    for t in _truncations(blob):
        out = raw_decode_16w(t, 12, 64)
        assert out is None or isinstance(out, bytes)


def test_mt_truncations_safe():
    blob = mt_encode(_data(), 12, 64)
    for t in _truncations(blob):
        out = mt_decode(t, 12, 64)
        assert out is None or isinstance(out, bytes)


def test_block_truncations_safe():
    blob = block_encode(_data(), 12, 64)
    for t in _truncations(blob):
        out = block_decode(t, 12, 64)
        assert out is None or isinstance(out, bytes)


def test_tpx_header_bitflips_safe():
    blob = bytearray(tpx_encode(_data(), 12))
    for pos in (8, 24, 28, 32, 36, 40, 44, 48):
        for val in (0x00, 0xFF, 0x7F):
            b = bytearray(blob)
            b[pos] = val
            out = tpx_decode(bytes(b))
            assert out is None or isinstance(out, bytes)


def _payload_flips(blob, rng, n_flips=120):
    """Byte corruptions across the ENTIRE blob (headers, tables, states,
    word streams), plus targeted 0x00/0xFF stomps."""
    for _ in range(n_flips):
        pos = int(rng.integers(0, len(blob)))
        b = bytearray(blob)
        b[pos] ^= int(rng.integers(1, 256))
        yield bytes(b)
    for pos in (len(blob) // 2, len(blob) - 3):
        for val in (0x00, 0xFF):
            b = bytearray(blob)
            b[pos] = val
            yield bytes(b)


def test_tpx_payload_bitflips_safe():
    """Flips in freq tables, word counts, states and stream words of tpx
    megablocks must never raise or write out of bounds."""
    rng = np.random.default_rng(31)
    blob = tpx_encode(_data(), 12)
    for b in _payload_flips(blob, rng):
        out = tpx_decode(b)
        assert out is None or isinstance(out, bytes)


def test_mt_payload_bitflips_safe():
    """Flips in mt block headers (size, writeHeadOffset, states, freq) and
    stream words: host oracle, native decoder, and the Pallas path's host
    indexing must all fail closed."""
    from hsrans.ops.mt import block_index, mt_decode_py
    from hsrans.runtime import native

    rng = np.random.default_rng(32)
    blob = mt_encode(_data(), 12, 64)
    for b in _payload_flips(blob, rng, n_flips=80):
        out = mt_decode_py(b, 12, 64)
        assert out is None or isinstance(out, bytes)
        if native.load() is not None:
            out_n = native.mt_decode(b, 12, 64)
            assert out_n is None or isinstance(out_n, bytes)
        block_index(b, 64)  # must not raise; None or an index both fine


def test_mt_kernel_payload_bitflips_safe():
    """The mt device decode (host indexing + the kernel, interpret mode) on
    corrupted blobs: returns None or bytes, never raises (targeted header
    fields: writeHeadOffset and states of the first coded block)."""
    from hsrans.parallel.sharded import mt_decode_device

    blob = mt_encode(_data(), 12, 64)
    for off in (16 + 8, 16 + 12, 16 + 16, 16 + 20, 16 + 16 + 256):
        for val in (0x00, 0xFF, 0x80):
            b = bytearray(blob)
            b[off] = val
            out = mt_decode_device(bytes(b), 12, 64)
            assert out is None or isinstance(out, bytes)


def test_block_payload_bitflips_safe():
    rng = np.random.default_rng(33)
    blob = block_encode(_data(), 12, 64)
    from hsrans.ops.block import block_decode_py
    from hsrans.runtime import native

    for b in _payload_flips(blob, rng, n_flips=60):
        out = block_decode_py(b, 12, 64)
        assert out is None or isinstance(out, bytes)
        if native.load() is not None:
            out_n = native.block_decode(b, 12, 64)
            assert out_n is None or isinstance(out_n, bytes)


def test_blk32_payload_bitflips_safe():
    rng = np.random.default_rng(34)
    data = _data()
    from hsrans.ops.blk32 import blk32_encode
    from hsrans.runtime import native

    blob = blk32_encode(data, make_hist(data, 12), 16)
    for b in _payload_flips(blob, rng, n_flips=60):
        out = blk32_decode(b, 12, 16)
        assert out is None or isinstance(out, bytes)
        if native.load() is not None:
            out_n = native.blk32_decode(b, 12, 16)
            assert out_n is None or isinstance(out_n, bytes)


def test_tpx_v3_truncations_and_bitflips_safe():
    """The adaptive (per-mega geometry) wire gets the same error model:
    truncations and arbitrary byte corruption never raise or OOB — the
    per-mega rows/steps fields are plausibility-gated at parse."""
    from hsrans.ops.tpx import tpx_encode_adaptive

    rng = np.random.default_rng(61)
    blob = tpx_encode_adaptive(_data(), 12)
    assert tpx_decode(blob) == _data().tobytes()
    for t in _truncations(blob):
        out = tpx_decode(t)
        assert out is None or isinstance(out, bytes)
    for b in _payload_flips(blob, rng, n_flips=80):
        out = tpx_decode(b)
        assert out is None or isinstance(out, bytes)
    # targeted stomps on the per-mega geometry fields (rows/steps at offset
    # 44, right after the global header)
    for pos in (44, 45, 48, 49):
        for val in (0x00, 0xFF, 0x80):
            b = bytearray(blob)
            b[pos] = val
            out = tpx_decode(bytes(b))
            assert out is None or isinstance(out, bytes)


@pytest.mark.parametrize("n", (32, 64))
def test_mt_device_payload_bitflips_safe(n):
    """Byte corruptions anywhere in an n-lane blob through the device decode
    (kernel in interpret mode): None or bytes, never an exception."""
    from hsrans.parallel.sharded import mt_decode_device, uniform_plan

    rng = np.random.default_rng(67 + n)
    data = _data()[:12_000]
    blob = mt_encode(data, 12, n, plan=uniform_plan(data, 12, n, 4096))
    assert mt_decode_device(blob, 12, n) == data.tobytes()
    for b in _payload_flips(blob, rng, n_flips=12):
        out = mt_decode_device(b, 12, n)
        assert out is None or isinstance(out, bytes)
