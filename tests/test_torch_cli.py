"""The port's CLI (``seamlesscloneoptimization_tpu_torch.cli``) on the CPU.

Against the JAX package's CLI on the same YAML files (every mode, solver
and knob of the JAX CLI: diff_max <= 1 between the two BMPs), against the
port's engine with the same config (bit-equal), ``result.yml`` against the
BMP, the printout (the reference's two lines in JAX's format, the solver
line after them), the errors, and ``--debug-dump``. Synthetic images made
from a seed: a 60x80 source with an ellipse mask into a 120x160
destination.
"""

import re

import numpy as np
import pytest
import torch
from jax_native_build import jax_native

from seamlesscloneoptimization_tpu_torch import native
from seamlesscloneoptimization_tpu_torch.cli import main
from seamlesscloneoptimization_tpu_torch.core.config import CloneConfig
from seamlesscloneoptimization_tpu_torch.core.engine import SeamlessClone

# Several pytest-xdist workers share the cores: one intra-op thread each.
torch.set_num_threads(1)

CENTER = (84, 58)
REF_LINES = (r"Compute stage performance time= \d+\.\d{3} msec, patch size=\d+x\d+",
             r"total device memory used: \d+ bytes")


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """(src.yml, dst.yml, mask.yml paths, src, dst, mask)."""
    d = tmp_path_factory.mktemp("cli_inputs")
    rng = np.random.default_rng(11)
    src = rng.integers(0, 256, (60, 80, 3)).astype(np.uint8)
    dst = rng.integers(0, 256, (120, 160, 3)).astype(np.uint8)
    yy, xx = np.mgrid[:60, :80]
    mask = (((yy - 30) / 25.0) ** 2 + ((xx - 40) / 35.0) ** 2 <= 1).astype(np.uint8) * 255
    paths = []
    for name, a in (("src", src), ("dst", dst), ("mask", mask)):
        native.write_yaml_mat(d / f"{name}.yml", a, name=name)
        paths.append(str(d / f"{name}.yml"))
    return paths, src, dst, mask


def _argv(inputs, *extra):
    return [*inputs[0], str(CENTER[0]), str(CENTER[1]), *extra]


# (CLI arguments, the port's CloneConfig they map to)
CASES = {
    "normal": ([], {}),
    "mixed": (["--flags", "2"], dict(flags=2)),
    "monochrome": (["--flags", "3"], dict(flags=3)),
    "dst_gemm": (["--solver", "dst_gemm"], dict(solver="dst_gemm")),
    "multigrid": (["--solver", "multigrid"], dict(solver="multigrid")),
    "precision_highest": (["--precision", "highest"], dict(precision="highest")),
    "no_folded": (["--no-folded"], dict(dst_folded=False)),
    "no_pallas": (["--no-pallas"], dict(use_pallas_preprocess=False,
                                        use_pallas_postprocess=False,
                                        use_pallas_smoother=False)),
    "multigrid_tol": (["--solver", "multigrid", "--tol", "1e-3"],
                      dict(solver="multigrid", tol=1e-3)),
    "multigrid_cycles": (["--solver", "multigrid", "--mg-cycles", "4", "--flags", "2"],
                         dict(solver="multigrid", mg_cycles=4, flags=2)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_cli_matches_jax_cli_and_engine(tmp_path, inputs, case, capsys):
    """The port's CLI (--device cpu) within 1 of the JAX CLI, bit-equal to
    the port's engine with the mapped config; result.yml is the BMP."""
    from seamlesscloneoptimization_tpu.cli import main as jax_main

    jax_native()
    extra, cfg = CASES[case]
    assert main(_argv(inputs, *extra, "--device", "cpu", "--loops", "2",
                      "--output-dir", str(tmp_path / "port"))) == 0
    assert jax_main(_argv(inputs, *extra, "--output-dir", str(tmp_path / "jax"))) == 0
    port = native.read_bmp(tmp_path / "port" / "ucRGB_Output.bmp")
    jax = native.read_bmp(tmp_path / "jax" / "ucRGB_Output.bmp")
    _, src, dst, mask = inputs
    assert int(np.abs(port.astype(np.int16) - jax).max()) <= 1
    eng = SeamlessClone(CloneConfig(**cfg), device="cpu")
    assert np.array_equal(port, eng.run(src, dst, mask, CENTER).numpy())
    assert not np.array_equal(port, dst)
    assert np.array_equal(native.read_yaml_mat(tmp_path / "port" / "result.yml"), port)
    out = capsys.readouterr().out
    if "--solver" not in extra:  # auto: both CLIs resolve to the same solver
        solver = [ln for ln in out.splitlines() if ln.startswith("solver: auto -> ")]
        assert len(solver) == 2 and solver[0] == solver[1]


def test_printout_reference_lines_then_solver(tmp_path, inputs, capsys):
    """The reference's two lines in the JAX CLI's format, consecutive, the
    solver line right after them (the JAX CLI prints it before them)."""
    from seamlesscloneoptimization_tpu.cli import main as jax_main

    jax_native()
    assert main(_argv(inputs, "--device", "cpu", "--output-dir", str(tmp_path / "p"))) == 0
    port = capsys.readouterr().out.splitlines()
    assert jax_main(_argv(inputs, "--output-dir", str(tmp_path / "j"))) == 0
    jax = capsys.readouterr().out.splitlines()
    for lines in (port, jax):
        i = next(k for k, ln in enumerate(lines) if ln.startswith("Compute stage"))
        assert re.fullmatch(REF_LINES[0], lines[i]) and re.fullmatch(REF_LINES[1], lines[i + 1])
        assert lines[i].split(", ")[1] == "patch size=71x51"
    i = next(k for k, ln in enumerate(port) if ln.startswith("Compute stage"))
    assert port[i + 2] == "solver: auto -> dst_gemm"
    assert port[0] == "using device cpu:0 (1 visible)"
    assert port[1] == jax[1] == "src (60, 80, 3) dst (120, 160, 3) mask (60, 80)"


def test_missing_file_raises_file_not_found(tmp_path):
    with pytest.raises(FileNotFoundError):
        main([str(tmp_path / "nope.yml"), str(tmp_path / "nope2.yml"),
              str(tmp_path / "nope3.yml"), "10", "10", "--device", "cpu"])


def test_without_card_raises(tmp_path, inputs, monkeypatch):
    """Without a card and without --device cpu the CLI raises before it
    reads or runs anything; it never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(_argv(inputs, "--output-dir", str(tmp_path / "o")))
    assert not (tmp_path / "o").exists()


def test_bad_device_id_returns_2(tmp_path, inputs, capsys):
    assert main(_argv(inputs, "3", "--device", "cpu", "--output-dir", str(tmp_path))) == 2
    assert "device 3 not available (have 1)" in capsys.readouterr().err


@pytest.mark.parametrize("flags", ["1", "2"])
def test_debug_dump_writes_stages(tmp_path, inputs, flags):
    """--debug-dump: dump_stages's artifacts under <output-dir>/debug, its
    g{c}.yml equal to a fresh engine's dump_stages RHS, its output.bmp
    within 1 of the CLI's image."""
    out = tmp_path / "out"
    assert main(_argv(inputs, "--device", "cpu", "--flags", flags, "--debug-dump",
                      "--output-dir", str(out))) == 0
    dbg = out / "debug"
    for f in ("mask_eroded.yml", "g0.yml", "g1.yml", "g2.yml", "output.bmp", "gx.npy",
              "gy.npy", "u.npy", "rhs.npy"):
        assert (dbg / f).is_file(), f
    _, src, dst, mask = inputs
    eng = SeamlessClone(CloneConfig(flags=int(flags), debug_dir=str(tmp_path / "ref")),
                        device="cpu")
    _, stages = eng.dump_stages(src, dst, mask, CENTER)
    for c in range(3):
        assert np.array_equal(native.read_yaml_mat(dbg / f"g{c}.yml"), stages["rhs"][c])
        assert (dbg / f"g{c}.yml").read_bytes() == (tmp_path / "ref" / f"g{c}.yml").read_bytes()
    image = native.read_bmp(out / "ucRGB_Output.bmp")
    assert int(np.abs(native.read_bmp(dbg / "output.bmp").astype(np.int16) - image).max()) <= 1
