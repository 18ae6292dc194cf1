"""Backend detection and codec tiers.

The analog of the reference's cpuid feature detection
(simd_platform.c `_DetectCPUFeatures`, and the per-codec dispatch cascades
like block_rANS32x64_16w_decode.cpp:135-151): instead of SSE/AVX2/AVX-512
levels, the JAX platform picks the execution tier of the device paths.

Tiers (highest first):
  gpu        — NVIDIA GPU: compiled kernels
  interpret  — CPU backend: the same kernels in Pallas interpret mode (the
               CI analog of the reference's --max-simd downgrade)
  numpy      — host paths only (numpy oracle and native C++); chosen on
               the CLI (`--backend numpy`, `--max-simd none`), mirroring how
               the reference clears its feature globals to force scalar
               decoders (main.cpp:463-618)
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from functools import lru_cache
from pathlib import Path

_TIER_OF_PLATFORM = {"gpu": "gpu", "cpu": "interpret"}


@dataclass(frozen=True)
class Capabilities:
    platform: str  # 'gpu' | 'cpu'
    device_kind: str  # e.g. 'NVIDIA H100 80GB HBM3'
    num_devices: int
    tier: str  # 'gpu' | 'interpret'

    @property
    def pallas_interpret(self) -> bool:
        """Kernels run in interpret mode only on the CPU."""
        return self.platform == "cpu"


def compile_cache_dir() -> str:
    """JAX_COMPILATION_CACHE_DIR when set, else `.jax_cache` at the repo root
    (a fixed path: the path is part of what the cache keys on)."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or str(Path(__file__).resolve().parents[2] / ".jax_cache")


def _enable_compile_cache(jax_mod) -> None:
    """Persistent executable cache.  JAX reads JAX_COMPILATION_CACHE_DIR
    itself; only the default needs setting here."""
    if not jax_mod.config.jax_compilation_cache_dir:
        jax_mod.config.update("jax_compilation_cache_dir", compile_cache_dir())


@lru_cache(maxsize=1)
def detect() -> Capabilities:
    """Probe the JAX backend once (cf. _DetectCPUFeatures' one-shot globals);
    a platform other than 'gpu' or 'cpu' raises."""
    import jax

    _enable_compile_cache(jax)
    devs = jax.devices()
    platform, kind = devs[0].platform, devs[0].device_kind
    if platform not in _TIER_OF_PLATFORM:
        raise RuntimeError(f"unsupported JAX platform {platform!r}: hsrans runs on 'gpu' or 'cpu'")
    return Capabilities(platform, kind, len(devs), _TIER_OF_PLATFORM[platform])


def banner(cap: Capabilities | None = None) -> str:
    """One-line capability report (cf. the reference's CPU feature banner,
    main.cpp:684-738)."""
    cap = cap or detect()
    return (
        f"backend: {cap.platform} ({cap.device_kind} x{cap.num_devices}) "
        f"-> tier '{cap.tier}'"
    )
