"""The port's ``native``: YAML / BMP IO and ``prep_mask`` against the JAX
package's C++ ones (``seamlesscloneoptimization_tpu/native``).

The YAML text byte for byte (every element type, 2-D and 3-D, lines that
wrap at column 68, constant and one-element matrices), read back both ways;
JAX's malformed files raise ValueError, as does a BMP that is cut short;
``prep_mask`` on seeded masks of every dtype the JAX wrapper binarizes,
empty, single-pixel and frame-touching masks.
"""

import numpy as np
import pytest
import torch
from jax_native_build import jax_native

from seamlesscloneoptimization_tpu_torch import native
from seamlesscloneoptimization_tpu_torch.core.reference import mask_bounding_box, zero_mask_border

# Several pytest-xdist workers share the cores: one intra-op thread each.
torch.set_num_threads(1)


def _arrays():
    rng = np.random.default_rng(7)
    return {
        "u8_2d": rng.integers(0, 256, (9, 13)).astype(np.uint8),
        "u8_3d": rng.integers(0, 256, (7, 9, 3)).astype(np.uint8),
        "u8_wide": rng.integers(0, 256, (3, 200)).astype(np.uint8),
        "u8_constant": np.full((40, 60), 255, np.uint8),
        "u8_one": np.full((1, 1), 3, np.uint8),
        "i16_2d": rng.integers(-32768, 32768, (5, 40)).astype(np.int16),
        "i16_3d": rng.integers(-300, 300, (4, 6, 3)).astype(np.int16),
        "i32_2d": rng.integers(-5, 5, (6, 30)).astype(np.int32),
        "i32_3d": rng.integers(-2**31, 2**31, (6, 30, 3), dtype=np.int64).astype(np.int32),
        "f32_2d": rng.normal(size=(9, 11)).astype(np.float32),
        "f32_3d": (rng.normal(size=(5, 7, 3)) * 1e-3).astype(np.float32),
        "f32_special": np.array([[1e-30, -np.inf, np.inf, 0.0, -0.0, 3e38]], np.float32),
        "f64_2d": rng.normal(size=(8, 25)),
        "f64_3d": rng.normal(size=(4, 50, 3)) * 1e10,
    }


ARRAYS = _arrays()


@pytest.mark.parametrize("key", sorted(ARRAYS))
def test_yaml_text_equals_jax_writer(tmp_path, key):
    """Byte-equal files; each reader reads the other's file exactly."""
    J = jax_native()
    a = ARRAYS[key]
    native.write_yaml_mat(tmp_path / "t.yml", a, name=key)
    J.write_yaml_mat(tmp_path / "j.yml", a, name=key)
    assert (tmp_path / "t.yml").read_bytes() == (tmp_path / "j.yml").read_bytes()
    for reader, path in ((native.read_yaml_mat, "j.yml"), (J.read_yaml_mat, "t.yml")):
        back = reader(tmp_path / path)
        assert back.dtype == a.dtype and np.array_equal(back, a)


def test_yaml_lines_wrap_before_column_68(tmp_path):
    """A wide matrix's data lines: none longer than 68 columns but the
    first, which the writer counts from after ``   data: [ ``."""
    native.write_yaml_mat(tmp_path / "w.yml", ARRAYS["u8_wide"])
    data = (tmp_path / "w.yml").read_text().split("   data: [ ", 1)[1].splitlines()
    assert len(data) > 5
    assert all(len(line) <= 68 for line in data[1:]) and len(data[0]) <= 69
    assert all(line.startswith(" " * 7) and not line.startswith(" " * 8) for line in data[1:])


@pytest.mark.parametrize("content", [
    b"",
    b"garbage not yaml at all",
    b"%YAML:1.0\n---\nrows: 2\ncols: 2\ndt: u\n",
    b"%YAML:1.0\n---\nrows: 999999999\ncols: 999999999\ndt: u\ndata: [ 1 ]\n",
    b"%YAML:1.0\n---\nrows: -5\ncols: 3\ndt: u\ndata: [ 1 ]\n",
    b"%YAML:1.0\n---\nrows: 2\ncols: 2\ndt: z\ndata: [ 1, 2, 3, 4 ]\n",
    b"%YAML:1.0\n---\nrows: 4\ncols: 4\ndt: 3u\ndata: [ 1, 2 ]\n",
])
def test_malformed_yaml_raises_value_error(tmp_path, content):
    """The JAX package's malformed files (tests/test_native_cli.py): each a
    ValueError, as the JAX reader raises for them."""
    p = tmp_path / "bad.yml"
    p.write_bytes(content)
    with pytest.raises(ValueError):
        native.read_yaml_mat(p)
    with pytest.raises((ValueError, KeyError)):
        jax_native().read_yaml_mat(p)


def test_yaml_reads_like_the_c_reader(tmp_path):
    """The first rows * cols * channels values count, integers wrap to the
    element type, tabs and newlines separate like commas."""
    p = tmp_path / "m.yml"
    p.write_bytes(b"%YAML:1.0\n---\nm: !!opencv-matrix\n   rows: 2\n   cols: 2\n   dt: u\n"
                  b"   data: [ 1,\t256,\n  -1, 7, 9 ]\n")
    want = np.array([[1, 0], [255, 7]], np.uint8)
    assert np.array_equal(native.read_yaml_mat(p), want)
    assert np.array_equal(jax_native().read_yaml_mat(p), want)


@pytest.mark.parametrize("content", [b"BM\x00\x00", "truncated body"])
def test_short_bmp_raises_value_error(tmp_path, content):
    p = tmp_path / "bad.bmp"
    if content == "truncated body":
        native.write_bmp(p, ARRAYS["u8_3d"])
        p.write_bytes(p.read_bytes()[:-5])
    else:
        p.write_bytes(content)
    with pytest.raises(ValueError):
        native.read_bmp(p)
    with pytest.raises((ValueError, OSError)):
        jax_native().read_bmp(p)


@pytest.mark.parametrize("img", [ARRAYS["u8_3d"], ARRAYS["u8_2d"], np.zeros((3, 5, 3), np.uint8)])
def test_bmp_bytes_equal_jax(tmp_path, img):
    J = jax_native()
    native.write_bmp(tmp_path / "t.bmp", img)
    J.write_bmp(tmp_path / "j.bmp", img)
    assert (tmp_path / "t.bmp").read_bytes() == (tmp_path / "j.bmp").read_bytes()
    assert np.array_equal(native.read_bmp(tmp_path / "j.bmp"), J.read_bmp(tmp_path / "t.bmp"))


def _masks():
    rng = np.random.default_rng(3)
    ellipse = np.zeros((60, 80), np.uint8)
    yy, xx = np.mgrid[:60, :80]
    ellipse[((yy - 30) / 25.0) ** 2 + ((xx - 40) / 35.0) ** 2 <= 1] = 200
    single = np.zeros((9, 9), np.uint8)
    single[4, 5] = 1
    touching = np.zeros((20, 30), np.uint8)
    touching[0:12, 5:30] = 255  # touches the top and right frame
    f = (rng.random((30, 40)) < 0.3).astype(np.float32) * 0.5
    i = (rng.random((30, 40)) < 0.3).astype(np.int32) * 256
    return {"u8_seeded": (rng.random((40, 50)) < 0.4).astype(np.uint8) * rng.integers(
                1, 256, (40, 50)).astype(np.uint8),
            "u8_ellipse": ellipse, "bool": rng.random((30, 40)) < 0.2,
            "float32_half": f, "int32_256": i, "empty": np.zeros((10, 12), np.uint8),
            "full": np.full((50, 60), 255, np.uint8), "single_pixel": single,
            "thin": np.full((2, 9), 255, np.uint8),
            "frame_touching": touching}


MASKS = _masks()


@pytest.mark.parametrize("key", sorted(MASKS))
def test_prep_mask_equals_jax(key):
    """Prepared mask and bbox equal the JAX native.prep_mask's (0.5 and 256
    are inside: binarized before any cast)."""
    m = MASKS[key]
    got, bbox = native.prep_mask(m)
    want, want_bbox = jax_native().prep_mask(m)
    assert got.dtype == np.uint8 and np.array_equal(got, want)
    assert bbox == want_bbox
    # and the port's own reference helpers, which prep_mask replaces on the host path
    ref = zero_mask_border(np.where(m != 0, np.uint8(255), np.uint8(0)))
    assert np.array_equal(got, ref) and bbox == mask_bounding_box(ref)
    if key == "empty":
        assert bbox[2] == 0
    if key in ("float32_half", "int32_256"):
        assert got.any()
