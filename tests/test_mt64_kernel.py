"""mt device decode (the Pallas kernel, in interpret mode here) on
reference-wire-format blobs, against the host oracle."""

import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

from hsrans.ops.mt import mt_decode, mt_encode
from hsrans.parallel.sharded import mt_decode_device, uniform_plan


def _blob(data, block, bits=12):
    return mt_encode(data, bits, 64, plan=uniform_plan(data, bits, 64, block))


@pytest.mark.parametrize(
    "name,size,block",
    [
        ("text-4k", 300_000, 4096),
        ("odd-tail", 123_457, 4096),
        ("8k-blocks", 250_000, 8192),
        ("tiny", 100, 4096),
    ],
)
def test_mt64_kernel_matches_oracle(name, size, block):
    from tools.gen_inputs import text_like

    rng = np.random.default_rng(9)
    data = text_like(rng, size)
    blob = _blob(data, block)
    assert mt_decode(blob, 12, 64) == data.tobytes()
    got = mt_decode_device(blob, 12, 64)
    assert got == data.tobytes()


def test_mt64_kernel_rle_single_blocks():
    """Single-symbol blocks interleave with coded blocks (filled on the device)."""
    from tools.gen_inputs import text_like

    rng = np.random.default_rng(10)
    data = np.concatenate(
        [np.full(100_000, 9, np.uint8), text_like(rng, 60_000), np.full(70_000, 3, np.uint8)]
    )
    blob = _blob(data, 8192)
    assert mt_decode_device(blob, 12, 64) == data.tobytes()


def test_mt64_kernel_planner_blob():
    """Greedy-planner blobs (the reference's own variable 2^16+ block sizes)
    decode in one launch, rows sorted by step count."""
    from tools.gen_inputs import text_like

    rng = np.random.default_rng(11)
    data = text_like(rng, 400_000)
    blob = mt_encode(data, 12, 64)  # reference greedy planner
    assert mt_decode_device(blob, 12, 64) == data.tobytes()


def test_mt64_kernel_planner_blob_corpus():
    """Real mixed corpus: the planner emits several distinct block sizes."""
    from pathlib import Path

    corpus = Path(__file__).parent / "corpus" / "corpus.bin"
    data = np.fromfile(corpus, np.uint8)[: 512 * 1024]
    blob = mt_encode(data, 12, 64)
    assert mt_decode_device(blob, 12, 64) == data.tobytes()


@pytest.mark.parametrize("bits", (13, 15))
def test_mt64_kernel_high_bits(bits):
    """B=13..15: the symbol moves to its own table (two loads per step)."""
    from tools.gen_inputs import text_like

    rng = np.random.default_rng(17)
    data = text_like(rng, 150_000)
    blob = _blob(data, 4096, bits=bits)
    assert mt_decode(blob, bits, 64) == data.tobytes()
    assert mt_decode_device(blob, bits, 64) == data.tobytes()


@pytest.fixture(scope="session")
def ref_mt_drive(tmp_path_factory):
    """Compile the unmodified reference mt decoder as an interop oracle."""
    ref = Path("/root/reference/src")
    if not ref.exists() or shutil.which("g++") is None:
        pytest.skip("reference sources or g++ unavailable")
    out = tmp_path_factory.mktemp("refdrive") / "ref_mt_drive"
    src = out.parent / "drive.cpp"
    src.write_text(
        r"""
#include <cstdio>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>
#include "hist.h"
#include "mt_rANS32x64_16w.h"
static uint64_t fnv1a(const uint8_t *p, size_t n) {
  uint64_t h = 1469598103934665603ull;
  for (size_t i = 0; i < n; i++) { h ^= p[i]; h *= 1099511628211ull; }
  return h;
}
int main(int argc, char **argv) {
  FILE *f = fopen(argv[1], "rb");
  fseek(f, 0, SEEK_END); long sz = ftell(f); fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> blob(sz); fread(blob.data(), 1, sz, f); fclose(f);
  size_t raw = strtoull(argv[2], nullptr, 10);
  std::vector<uint8_t> out(raw + 256);
  size_t got = mt_rANS32x64_16w_decode_12(blob.data(), sz, out.data(), raw);
  printf("%zu %016llx\n", got, (unsigned long long)fnv1a(out.data(), raw));
  return 0;
}
"""
    )
    srcs = [
        "mt_rANS32x64_16w_encode.cpp",
        "mt_rANS32x64_16w_decode.cpp",
        "rANS32x32_16w.cpp",
        "hist.cpp",
        "simd_platform.c",
        "thread_pool.cpp",
    ]
    cmd = ["g++", "-O2", "-std=c++20", "-mxsave", f"-I{ref}", str(src)]
    cmd += [str(ref / s) for s in srcs] + ["-o", str(out), "-lpthread"]
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if r.returncode != 0:
        pytest.skip(f"reference build failed: {r.stderr[:200]}")
    return out


def test_reference_binary_decodes_our_device_plan_blob(ref_mt_drive, tmp_path):
    """Wire interop for device_plan segmentation (greedy plan with coded
    blocks split at the device cap): mixed single-symbol RLE rows + capped
    coded rows must decode byte-exactly through the unmodified reference."""
    from hsrans.ops.mt import mt_encode
    from hsrans.parallel.sharded import device_plan
    from hsrans.runtime.native import fnv1a

    xr = np.fromfile(Path(__file__).parent / "corpus" / "xray.bin", np.uint8)[: 2 << 20]
    blob = mt_encode(xr, 12, 64, plan=device_plan(xr, 12, 64, 32 << 10))
    p = tmp_path / "dp.blob"
    p.write_bytes(blob)
    r = subprocess.run(
        [str(ref_mt_drive), str(p), str(xr.size)], capture_output=True, text=True, timeout=120
    )
    got_n, got_h = r.stdout.split()
    assert int(got_n) == xr.size
    assert got_h == f"{fnv1a(xr.tobytes()):016x}"


def test_reference_binary_decodes_our_uniform_blob(ref_mt_drive, tmp_path):
    """Wire interop: the unmodified C++ reference decodes our blobs."""
    from hsrans.runtime.native import fnv1a
    from tools.gen_inputs import text_like

    rng = np.random.default_rng(12)
    data = text_like(rng, 500_000)
    blob = _blob(data, 4096)
    p = tmp_path / "b.blob"
    p.write_bytes(blob)
    r = subprocess.run(
        [str(ref_mt_drive), str(p), str(data.size)], capture_output=True, text=True, timeout=120
    )
    got_n, got_h = r.stdout.split()
    assert int(got_n) == data.size
    assert got_h == f"{fnv1a(data.tobytes()):016x}"


@pytest.fixture(scope="session")
def ref_mt32_drive(tmp_path_factory):
    """Compile the unmodified reference mt x32 B13 decoder (interop oracle
    for the n=32 wire)."""
    ref = Path("/root/reference/src")
    if not ref.exists() or shutil.which("g++") is None:
        pytest.skip("reference sources or g++ unavailable")
    out = tmp_path_factory.mktemp("refdrive32") / "ref_mt32_drive"
    src = out.parent / "drive32.cpp"
    src.write_text(
        r"""
#include <cstdio>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>
#include "hist.h"
#include "mt_rANS32x32_16w.h"
static uint64_t fnv1a(const uint8_t *p, size_t n) {
  uint64_t h = 1469598103934665603ull;
  for (size_t i = 0; i < n; i++) { h ^= p[i]; h *= 1099511628211ull; }
  return h;
}
int main(int argc, char **argv) {
  FILE *f = fopen(argv[1], "rb");
  fseek(f, 0, SEEK_END); long sz = ftell(f); fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> blob(sz); fread(blob.data(), 1, sz, f); fclose(f);
  size_t raw = strtoull(argv[2], nullptr, 10);
  std::vector<uint8_t> out(raw + 256);
  size_t got = mt_rANS32x32_16w_decode_13(blob.data(), sz, out.data(), raw);
  printf("%zu %016llx\n", got, (unsigned long long)fnv1a(out.data(), raw));
  return 0;
}
"""
    )
    srcs = [
        "mt_rANS32x32_16w_encode.cpp",
        "mt_rANS32x32_16w_decode.cpp",
        "rANS32x32_16w.cpp",
        "hist.cpp",
        "simd_platform.c",
        "thread_pool.cpp",
    ]
    cmd = ["g++", "-O2", "-std=c++20", "-mxsave", f"-I{ref}", str(src)]
    cmd += [str(ref / s) for s in srcs] + ["-o", str(out), "-lpthread"]
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if r.returncode != 0:
        pytest.skip(f"reference build failed: {r.stderr[:200]}")
    return out


def test_reference_binary_decodes_our_mt32_blob(ref_mt32_drive, tmp_path):
    """Wire interop for the n=32 high-B path: the unmodified C++ reference
    decodes the same B13 x32 blob the device decode reads."""
    from hsrans.runtime.native import fnv1a
    from tools.gen_inputs import text_like

    rng = np.random.default_rng(49)
    data = text_like(rng, 300_000)
    blob = mt_encode(data, 13, 32, plan=uniform_plan(data, 13, 32, 4096))
    assert mt_decode_device(blob, 13, 32) == data.tobytes()
    p = tmp_path / "b32.blob"
    p.write_bytes(blob)
    r = subprocess.run(
        [str(ref_mt32_drive), str(p), str(data.size)], capture_output=True, text=True, timeout=120
    )
    got_n, got_h = r.stdout.split()
    assert int(got_n) == data.size
    assert got_h == f"{fnv1a(data.tobytes()):016x}"


def test_mt64_kernel_sharded_mesh():
    """Blocks sharded over the virtual mesh via shard_map around the kernel."""
    import jax
    from jax.sharding import Mesh

    from tools.gen_inputs import text_like

    devs = jax.devices()
    if len(devs) < 2:
        pytest.skip("needs the virtual multi-device CPU mesh")
    mesh = Mesh(np.array(devs).reshape(len(devs)), ("dp",))
    rng = np.random.default_rng(15)
    data = text_like(rng, 600_000)
    blob = _blob(data, 4096)
    assert mt_decode_device(blob, 12, 64, mesh=mesh) == data.tobytes()


@pytest.mark.parametrize("bits", (10, 11))
def test_mt64_kernel_low_bits(bits):
    """B<12: smaller slot tables."""
    from tools.gen_inputs import text_like

    rng = np.random.default_rng(16)
    data = text_like(rng, 150_000)
    blob = _blob(data, 4096, bits=bits)
    assert mt_decode(blob, bits, 64) == data.tobytes()
    assert mt_decode_device(blob, bits, 64) == data.tobytes()


@pytest.mark.parametrize("bits", (12, 13))
def test_mt_kernel_n32(bits):
    """n=32 blobs on the same kernel."""
    from tools.gen_inputs import text_like

    rng = np.random.default_rng(19)
    data = text_like(rng, 200_000)
    blob = mt_encode(data, bits, 32, plan=uniform_plan(data, bits, 32, 4096))
    assert mt_decode(blob, bits, 32) == data.tobytes()
    assert mt_decode_device(blob, bits, 32) == data.tobytes()


def test_mt_kernel_n32_planner():
    from pathlib import Path

    data = np.fromfile(Path(__file__).parent / "corpus" / "corpus.bin", np.uint8)[: 256 * 1024]
    blob = mt_encode(data, 12, 32)  # greedy planner (mt32 constants)
    assert mt_decode_device(blob, 12, 32) == data.tobytes()


@pytest.mark.parametrize("bits", (13, 15))
def test_mt64_kernel_sharded_mesh_high_bits(bits):
    """B>=13 (two table loads per step) sharded over the mesh."""
    import jax
    from jax.sharding import Mesh

    from tools.gen_inputs import text_like

    devs = jax.devices()
    if len(devs) < 2:
        pytest.skip("needs the virtual multi-device CPU mesh")
    mesh = Mesh(np.array(devs).reshape(len(devs)), ("dp",))
    rng = np.random.default_rng(27)
    data = text_like(rng, 400_000)
    blob = _blob(data, 4096, bits=bits)
    assert mt_decode_device(blob, bits, 64, mesh=mesh) == data.tobytes()


def test_mt64_kernel_planner_blob_sharded():
    """Variable-size blocks shard over the mesh too (rows dealt out tile by
    tile; the devices' byte spans merge with a psum)."""
    import jax
    from jax.sharding import Mesh

    devs = jax.devices()
    if len(devs) < 2:
        pytest.skip("needs the virtual multi-device CPU mesh")
    mesh = Mesh(np.array(devs).reshape(len(devs)), ("dp",))
    data = np.fromfile(Path(__file__).parent / "corpus" / "corpus.bin", np.uint8)[: 512 * 1024]
    blob = mt_encode(data, 12, 64)  # greedy planner
    assert mt_decode_device(blob, 12, 64, mesh=mesh) == data.tobytes()
