"""The port's compare harness (``seamlesscloneoptimization_tpu_torch.compare``)
against the JAX package's, on the CPU.

``diff_stats``, ``compare_images`` (its stats, and ``diff.yml`` /
``diff.bmp`` byte for byte), ``compare_yaml_stage`` and ``main``'s
printout equal the JAX package's on seeded pairs, identical images
included; a format the port does not read raises ValueError.
"""

import numpy as np
import pytest
import torch
from jax_native_build import jax_native

from seamlesscloneoptimization_tpu_torch import compare, native

# Several pytest-xdist workers share the cores: one intra-op thread each.
torch.set_num_threads(1)


def _pairs():
    rng = np.random.default_rng(5)
    a = rng.integers(0, 256, (20, 30, 3)).astype(np.uint8)
    b = a.copy()
    hit = rng.random(a.shape) < 0.05
    b[hit] = np.clip(b[hit].astype(int) + rng.integers(-9, 10, hit.sum()), 0, 255)
    far = a.copy()
    far[3, 4] = 255 - far[3, 4]
    return {"close": (a, b), "identical": (a, a.copy()), "far": (a, far)}


PAIRS = _pairs()


def _jax():
    jax_native()
    from seamlesscloneoptimization_tpu import compare as jax_compare

    return jax_compare


@pytest.mark.parametrize("key", sorted(PAIRS))
def test_diff_stats_equals_jax(key):
    a, b = PAIRS[key]
    assert compare.diff_stats(a, b) == _jax().diff_stats(a, b)


@pytest.mark.parametrize("suffix", [".bmp", ".yml"])
@pytest.mark.parametrize("key", sorted(PAIRS))
def test_compare_images_equals_jax(tmp_path, key, suffix):
    """Stats equal; diff.yml (int32) and the amplified diff.bmp byte-equal."""
    a, b = PAIRS[key]
    for name, img in (("a", a), ("b", b)):
        if suffix == ".bmp":
            native.write_bmp(tmp_path / f"{name}.bmp", img)
        else:
            native.write_yaml_mat(tmp_path / f"{name}.yml", img, name=name)
    pa, pb = str(tmp_path / f"a{suffix}"), str(tmp_path / f"b{suffix}")
    got = compare.compare_images(pa, pb, amplify=20, out_dir=str(tmp_path / "port"))
    want = _jax().compare_images(pa, pb, amplify=20, out_dir=str(tmp_path / "jax"))
    assert got == want
    for f in ("diff.yml", "diff.bmp"):
        assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes(), f
    assert native.read_yaml_mat(tmp_path / "port" / "diff.yml").dtype == np.int32


def test_compare_yaml_stage_equals_jax(tmp_path):
    rng = np.random.default_rng(1)
    g = rng.normal(size=(20, 30)).astype(np.float32)
    native.write_yaml_mat(tmp_path / "a.yml", g, "g0")
    native.write_yaml_mat(tmp_path / "b.yml", g + np.float32(1e-3), "mod_diff2")
    got = compare.compare_yaml_stage(tmp_path / "a.yml", tmp_path / "b.yml")
    assert got == _jax().compare_yaml_stage(tmp_path / "a.yml", tmp_path / "b.yml")
    assert 0.9e-3 < got["abs_max"] < 1.1e-3


@pytest.mark.parametrize("mode", ["image", "image_out_dir", "yaml"])
def test_main_printout_equals_jax(tmp_path, mode, capsys):
    a, b = PAIRS["close"]
    if mode == "yaml":
        args = ["--yaml", str(tmp_path / "a.yml"), str(tmp_path / "b.yml")]
        native.write_yaml_mat(tmp_path / "a.yml", a.astype(np.float32), "g0")
        native.write_yaml_mat(tmp_path / "b.yml", b.astype(np.float32), "g0")
    else:
        native.write_bmp(tmp_path / "a.bmp", a)
        native.write_bmp(tmp_path / "b.bmp", b)
        args = [str(tmp_path / "a.bmp"), str(tmp_path / "b.bmp")]
        if mode == "image_out_dir":
            args += ["--amplify", "10", "--out-dir", str(tmp_path / "d")]
    assert compare.main(args) == 0
    port = capsys.readouterr().out
    assert _jax().main(args) == 0
    assert port == capsys.readouterr().out
    assert port.splitlines()[0].startswith("abs_max: " if mode == "yaml" else "diff_sum: ")


@pytest.mark.parametrize("name", ["a.jpg", "a.png"])
def test_other_formats_raise_value_error(tmp_path, name):
    native.write_bmp(tmp_path / "a.bmp", PAIRS["close"][0])
    with pytest.raises(ValueError, match="yml"):
        compare.compare_images(str(tmp_path / name), str(tmp_path / "a.bmp"))
