"""CLI flag parsing + numpy-tier self-test on a tiny file."""

import numpy as np

from hsrans.cli import main, parse_args


def test_parse_args_reference_flags():
    a = parse_args(
        ["f.bin", "--test", "--hist-min", "11", "--hist-max", "13", "--runs-enc", "2",
         "--max-simd", "avx2", "--no-sleep", "--cpu-core", "5", "--exclude-raw"]
    )
    assert a["file"] == "f.bin" and a["test"] and a["hist_min"] == 11 and a["hist_max"] == 13
    assert a["runs_enc"] == 2 and a["backend"] == "interpret" and not a["raw"]
    assert parse_args(["x", "--max-simd", "none"])["backend"] == "numpy"


def test_cli_numpy_tier_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    f = tmp_path / "t.bin"
    rng.integers(0, 200, 20_000, dtype=np.int64).astype(np.uint8).tofile(f)
    rc = main([str(f), "--test", "--hist-min", "12", "--hist-max", "12",
               "--backend", "numpy", "--exclude-tpx", "--exclude-blk32"])
    assert rc == 0


def test_width_filters(tmp_path):
    """--exclude-16/-32/-64 drop state-width variants (main.cpp:247-249)."""
    from hsrans.cli import _build_codecs

    a = parse_args(["f", "--test", "--hist-min", "12", "--hist-max", "12",
                    "--exclude-16", "--exclude-32", "--exclude-tpx", "--backend", "numpy"])
    names = [c["name"] for c in _build_codecs(a)]
    assert names and all("x64" in n for n in names)
    assert not any("x16" in n or "x32" in n for n in names)
