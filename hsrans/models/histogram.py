"""Byte-frequency probability model: observe + normalize-to-2^B.

This is the L1 "model" layer of the codec framework (SURVEY.md §1).  The
normalization must be *bit-identical* to the reference implementation
(/root/reference/src/hist.cpp:16-215) because the normalized frequencies are
written into the wire format and drive every encode decision:

  1. capped[i] = trunc(hist[i] * (2^B / total) + 0.5f)  in float32,
     clamped to >= 1 for symbols that occur at all;
  2. if sum != 2^B: heap-sort symbol indices by capped value (the exact,
     unstable heap-sort order matters for tie-breaking), then repeatedly
     "steal" 1 from every entry >= the first value-2 entry (descending pass)
     or "gift" 1 (ascending pass from the top) until the sum is exactly 2^B.

The host (numpy) implementation below is the canonical one used by encoders;
`hsrans.models.jax_hist` provides the on-device (jittable) variant for
fused pipelines, bit-exact with this one (tests/test_jax_hist.py).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class Hist:
    """Normalized histogram: freq + exclusive prefix sums (cumul).

    Mirrors hist_t (/root/reference/src/hist.h:6-10): uint16 freq[256],
    uint16 cumul[256], with sum(freq) == 2^total_symbol_count_bits.
    """

    symbol_count: np.ndarray  # uint16[256]
    cumul: np.ndarray  # uint16[256]
    total_symbol_count_bits: int

    @property
    def total(self) -> int:
        return 1 << self.total_symbol_count_bits


def observe_hist(data: np.ndarray | bytes) -> np.ndarray:
    """Count byte frequencies. Returns uint32[256]."""
    arr = np.frombuffer(data, dtype=np.uint8) if isinstance(data, (bytes, bytearray, memoryview)) else np.asarray(data, dtype=np.uint8)
    return np.bincount(arr, minlength=256).astype(np.uint32)


def _heap_sort_indices(values: np.ndarray) -> np.ndarray:
    """Heap-sort 256 symbol indices ascending by value.

    Reproduces the reference's in-place heapsort (hist.cpp:110-144) exactly,
    including its tie-breaking permutation, which affects which of several
    equal-frequency symbols gets stolen from first.
    """
    idx = np.arange(256, dtype=np.int64)
    val = values

    def sift_down(n: int, i: int) -> None:
        while True:
            left = 2 * i + 1
            right = 2 * i + 2
            largest = i
            if left < n and val[idx[left]] > val[idx[largest]]:
                largest = left
            if right < n and val[idx[right]] > val[idx[largest]]:
                largest = right
            if largest == i:
                return
            idx[i], idx[largest] = idx[largest], idx[i]
            i = largest

    for i in range(256 // 2 - 1, -1, -1):
        sift_down(256, i)
    for i in range(255, -1, -1):
        idx[0], idx[i] = idx[i], idx[0]
        sift_down(i, 0)
    return idx


def normalize_hist(hist: np.ndarray, data_bytes: int, total_symbol_count_bits: int) -> Hist:
    """Normalize raw counts so they sum exactly to 2^B.

    `data_bytes` is the divisor used for the float scale; callers sometimes
    pass a value different from sum(hist) (the block codecs do this on
    purpose, e.g. block_rANS32x64_16w_encode.cpp:332).
    """
    total = np.uint32(1) << np.uint32(total_symbol_count_bits)
    mul = np.float32(total) / np.float32(data_bytes)

    # float32 multiply-add-truncate, exactly as the reference (hist.cpp:60-70).
    capped = (hist.astype(np.float32) * mul + np.float32(0.5)).astype(np.uint16)
    capped = np.where((capped == 0) & (hist != 0), np.uint16(1), capped)
    capped_sum = int(capped.sum(dtype=np.uint64))

    if capped_sum != int(total):
        sorted_idx = _heap_sort_indices(capped)

        def find_min_two(start: int) -> int:
            for i in range(start, 256):
                if capped[sorted_idx[i]] >= 2:
                    return i
            return start

        min_two = find_min_two(0)

        while capped_sum > int(total):  # steal
            done = False
            for i in range(min_two, 256):
                capped[sorted_idx[i]] -= 1
                capped_sum -= 1
                if capped_sum == int(total):
                    done = True
                    break
            if done:
                break
            min_two = find_min_two(min_two)

        while capped_sum < int(total):  # charity
            done = False
            for i in range(255, min_two - 1, -1):
                capped[sorted_idx[i]] += 1
                capped_sum += 1
                if capped_sum == int(total):
                    done = True
                    break
            if done:
                break
            min_two = find_min_two(min_two)

    cumul = np.zeros(256, dtype=np.uint16)
    cumul[1:] = np.cumsum(capped[:-1].astype(np.uint64)).astype(np.uint16)
    return Hist(symbol_count=capped, cumul=cumul, total_symbol_count_bits=total_symbol_count_bits)


def make_hist(data: np.ndarray | bytes, total_symbol_count_bits: int) -> Hist:
    """observe + normalize (reference: hist.cpp:217-222)."""
    counts = observe_hist(data)
    size = len(data) if isinstance(data, (bytes, bytearray, memoryview)) else int(np.asarray(data).size)
    return normalize_hist(counts, size, total_symbol_count_bits)


def complete_hist(symbol_count: np.ndarray, total_symbol_count_bits: int) -> Hist | None:
    """Rebuild cumul from freqs read off the wire; None if the sum is wrong.

    Reference: inplace_complete_hist (hist.cpp:308-324).
    """
    sc = np.asarray(symbol_count, dtype=np.uint16)
    if int(sc.sum(dtype=np.uint64)) != (1 << total_symbol_count_bits):
        return None
    cumul = np.zeros(256, dtype=np.uint16)
    cumul[1:] = np.cumsum(sc[:-1].astype(np.uint64)).astype(np.uint16)
    return Hist(symbol_count=sc, cumul=cumul, total_symbol_count_bits=total_symbol_count_bits)
