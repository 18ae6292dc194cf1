"""Test config: a virtual 8-device CPU mesh, so sharding tests run on one
host and Pallas kernels run in interpret mode.  The tests marked `gpu`
need a card: `JAX_PLATFORMS=cuda python -m pytest tests -m gpu`."""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
GOLDEN = REPO / "tests" / "golden"
INPUTS = Path("/tmp/golden_build/inputs")

sys.path.insert(0, str(REPO))


def fnv1a(data: bytes) -> int:
    """Mirror of the golden generator's FNV-1a-64 (tools/golden_gen.cpp)."""
    from hsrans.runtime import native

    return native.fnv1a(data)


@pytest.fixture(scope="session")
def golden_dir() -> Path:
    if not GOLDEN.exists() or not any(GOLDEN.iterdir()):
        pytest.skip("golden vectors not generated (run tools/gen_golden.sh)")
    return GOLDEN


@pytest.fixture(scope="session")
def golden_inputs() -> dict[str, np.ndarray]:
    """Regenerate the deterministic inputs if /tmp was cleaned."""
    if not INPUTS.exists():
        subprocess.run(
            [sys.executable, str(REPO / "tools" / "gen_inputs.py"), str(INPUTS)],
            check=True,
        )
    out = {}
    for f in sorted(INPUTS.glob("*.bin")):
        out[f.stem] = np.fromfile(f, dtype=np.uint8)
    return out


def read_meta(path: Path) -> tuple[int, int]:
    size_s, hash_s = path.read_text().split()
    return int(size_s), int(hash_s, 16)


@pytest.fixture
def gpu():
    """Skip unless JAX runs on a GPU (compiled kernels have no CPU form)."""
    import jax

    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU: compiled Triton kernels (run with JAX_PLATFORMS=cuda)")
