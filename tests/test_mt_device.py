"""mt device codec on the CPU: the decode kernel in interpret mode and the
plain-XLA scan, against the host oracle and the reference's golden blobs."""

import numpy as np
import pytest

from hsrans.ops.mt import mt_decode, mt_decode_py, mt_encode
from hsrans.ops.planner import BlockPlan
from hsrans.ops.tpx import make_tile_hist
from hsrans.parallel.sharded import device_plan, mt_decode_device, mt_decode_scan, mt_encode_device, uniform_plan

from .conftest import GOLDEN

LAYOUTS = ("uniform4k", "device_plan", "rle_rows", "odd_tail")


def _text(seed: int, size: int) -> np.ndarray:
    from tools.gen_inputs import text_like

    return text_like(np.random.default_rng(seed), size)


def _rle_plan(data_parts: list[tuple[np.ndarray, bool]], bits: int) -> tuple[np.ndarray, list[BlockPlan]]:
    data = np.concatenate([p for p, _ in data_parts])
    plan, start = [], 0
    for part, single in data_parts:
        if single:
            plan.append(BlockPlan(start, part.size, True, int(part[0]), None))
        else:
            plan.append(BlockPlan(start, part.size, False, 0, make_tile_hist(part, bits).symbol_count))
        start += part.size
    return data, plan


def _layout(layout: str, bits: int, n: int) -> tuple[np.ndarray, list[BlockPlan]]:
    seed = 100 * bits + n
    if layout == "uniform4k":
        data = _text(seed, 3 * 4096)
        return data, uniform_plan(data, bits, n, 4096)
    if layout == "device_plan":
        data = np.concatenate([_text(seed, 9000), np.full(3000, 7, np.uint8), _text(seed + 1, 2000)])
        return data, device_plan(data, bits, n, 2048)
    if layout == "rle_rows":
        return _rle_plan(
            [(np.full(2500, 3, np.uint8), True), (_text(seed, 4096), False),
             (np.full(700, 9, np.uint8), True), (_text(seed + 1, 2048 + 17), False)],
            bits,
        )
    data = _text(seed, 2 * 4096 + n + 5)  # final block carries a partial lane group
    return data, uniform_plan(data, bits, n, 4096)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("n", (32, 64))
@pytest.mark.parametrize("bits", range(10, 16))
def test_device_decode_grid(bits, n, layout):
    """Oracle-encoded blobs decode byte-exactly through the kernel; the
    device_plan layout also through the scan."""
    data, plan = _layout(layout, bits, n)
    blob = mt_encode(data, bits, n, plan=plan)
    assert mt_decode(blob, bits, n) == data.tobytes()
    assert mt_decode_device(blob, bits, n) == data.tobytes()
    if layout == "device_plan":
        assert mt_decode_scan(blob, bits, n) == data.tobytes()


GOLDEN_CASES = ("text_63k", "skew_50k", "tiny_130", "uniform_8k")
GOLDEN_CODECS = ("mt64_10", "mt64_12", "mt64_15", "mt32_12")


@pytest.mark.parametrize("codec", GOLDEN_CODECS)
@pytest.mark.parametrize("case", GOLDEN_CASES)
def test_device_decode_golden(golden_inputs, case, codec):
    """The reference's own mt blobs (tests/golden) decode on the device."""
    n, bits = (int(x) for x in codec[2:].split("_"))
    blob = (GOLDEN / f"{case}.{codec}.bin").read_bytes()
    assert mt_decode_device(blob, bits, n) == golden_inputs[case].tobytes()


@pytest.mark.parametrize("n", (32, 64))
@pytest.mark.parametrize("bits", range(10, 16))
def test_device_encode_oracle_parity(bits, n):
    """mt_encode_device blobs are valid wire: the numpy oracle and the native
    decoder read them back, and so does the device decode."""
    data = np.concatenate([_text(7 * bits + n, 6000), np.full(2100, 5, np.uint8), _text(bits, 1001)])
    blob = mt_encode_device(data, bits, n, plan=device_plan(data, bits, n, 2048))
    assert mt_decode_py(blob, bits, n) == data.tobytes()
    assert mt_decode(blob, bits, n) == data.tobytes()
    assert mt_decode_device(blob, bits, n) == data.tobytes()


def test_device_decode_empty_and_malformed():
    assert mt_decode_device(mt_encode(np.zeros(0, np.uint8), 12, 64), 12, 64) == b""
    assert mt_decode_device(b"\x01" + b"\0" * 7, 12, 64) is None
    blob = bytearray(mt_encode(_text(3, 5000), 12, 64, plan=uniform_plan(_text(3, 5000), 12, 64, 4096)))
    blob[16 + 16 + 4 * 64] ^= 0x01  # first freq entry: the table no longer sums to 2^12
    assert mt_decode_device(bytes(blob), 12, 64) is None


@pytest.mark.gpu
def test_compiled_kernel_matches_scan(gpu):
    """On a card: the compiled kernel and the scan agree on a planner blob."""
    data = np.concatenate([_text(11, 200_000), np.full(70_000, 1, np.uint8), _text(12, 33_333)])
    for bits, n in ((12, 64), (15, 32)):
        blob = mt_encode(data, bits, n)
        got = mt_decode_device(blob, bits, n)
        assert got == data.tobytes()
        assert mt_decode_scan(blob, bits, n) == got
