"""The engine's tools and the port's YAML / BMP IO on the CPU.

``dump_stages`` (the reference's SCDEBUG artifacts: mask_eroded.yml,
g{0,1,2}.yml, output.bmp, gx / gy / u / rhs .npy), its stages against the
JAX package's plain stages, its YAML read back bit-exactly by the port's
reader and by ``cv2.FileStorage``, its BMP by ``cv2.imread``; ``profile``'s
Chrome trace; ``destroy``; and ``native``'s writer against the format of
the JAX package's C++ writer, pinned here as text (the JAX package's own
``native`` builds with g++ at import, which races between test workers, so
this file does not import it).
"""

import json

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seamlesscloneoptimization_tpu.ops.guidance import guidance_field as j_guidance
from seamlesscloneoptimization_tpu.ops.mask import binarize_mask as j_binarize
from seamlesscloneoptimization_tpu.ops.mask import erode3x3 as j_erode
from seamlesscloneoptimization_tpu.ops.rhs import poisson_rhs as j_rhs
from seamlesscloneoptimization_tpu_torch import native
from seamlesscloneoptimization_tpu_torch.core.config import CloneConfig
from seamlesscloneoptimization_tpu_torch.core.engine import SeamlessClone

# Several pytest-xdist workers share the cores: one intra-op thread each.
torch.set_num_threads(1)

CENTER = (90, 70)


def _images(seed=0, src_hw=(80, 110), dst_hw=(150, 190)):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, 256, src_hw + (3,)).astype(np.uint8)
    dst = rng.integers(0, 256, dst_hw + (3,)).astype(np.uint8)
    yy, xx = np.mgrid[: src_hw[0], : src_hw[1]]
    mask = ((yy - 40) / 30.0) ** 2 + ((xx - 55) / 45.0) ** 2 <= 1
    return src, dst, mask.astype(np.uint8) * 255


def _diff_max(a, b):
    return int(np.abs(np.asarray(a).astype(np.int16) - np.asarray(b)).max())


@pytest.mark.parametrize("cfg", [dict(), dict(solver="multigrid", flags=2),
                                 dict(bbox_bucket=64, flags=3)])
def test_dump_stages_writes_artifacts(tmp_path, cfg):
    """Every artifact written; the stages are the JAX package's plain stages
    on the same ROI (the bucketed one with bbox_bucket); the YAML RHS reloads
    bit-exactly through the port's reader and cv2.FileStorage, the BMP
    through cv2.imread; the image within 1 of run()'s."""
    src, dst, mask = _images()
    d = tmp_path / "dbg"
    eng = SeamlessClone(CloneConfig(debug_dir=str(d), debug_dump=True, **cfg), device="cpu")
    out, stages = eng.dump_stages(src, dst, mask, CENTER)
    for f in ("mask_eroded.yml", "g0.yml", "g1.yml", "g2.yml", "output.bmp", "gx.npy",
              "gy.npy", "u.npy", "rhs.npy"):
        assert (d / f).is_file(), f
    x0, y0, bw, bh = stages["bbox"]
    left, top = stages["left_top"]
    if cfg.get("bbox_bucket"):  # 61 x 91 rounded up, the width capped by the source's
        assert (bh, bw) == (64, 110)
    # the JAX package's plain stages on the same ROI
    flags = cfg.get("flags", 1)
    dest = jnp.asarray(np.moveaxis(dst[top : top + bh, left : left + bw], 2, 0)).astype(
        jnp.float32)
    m_roi = stages["mask_roi"]
    patch = np.where(m_roi[..., None] != 0, src[y0 : y0 + bh, x0 : x0 + bw], 0)
    me = j_erode(j_binarize(jnp.asarray(m_roi)))
    gx, gy = j_guidance(dest, jnp.asarray(np.moveaxis(patch, 2, 0)).astype(jnp.float32), me,
                        flags)
    assert np.array_equal(stages["mask_eroded"], np.asarray(me))
    np.testing.assert_allclose(stages["gx"], np.asarray(gx), rtol=0, atol=1e-4)
    np.testing.assert_allclose(stages["rhs"], np.asarray(j_rhs(gx, gy, dest)), rtol=0,
                               atol=1e-3)
    # the artifacts read back
    for c in range(3):
        g = native.read_yaml_mat(d / f"g{c}.yml")
        assert g.dtype == np.float32 and np.array_equal(g, stages["rhs"][c])
    fs = cv2.FileStorage(str(d / "g0.yml"), cv2.FILE_STORAGE_READ)
    assert np.array_equal(fs.getNode("data").mat(), stages["rhs"][0])
    fs.release()
    assert np.array_equal(native.read_yaml_mat(d / "mask_eroded.yml"), stages["mask_eroded"])
    assert np.array_equal(cv2.imread(str(d / "output.bmp")), out)
    for k in ("gx", "gy", "u", "rhs"):
        assert np.array_equal(np.load(d / f"{k}.npy"), stages[k])
    assert out.shape == dst.shape and not np.array_equal(out, dst)
    assert _diff_max(out, eng.run(src, dst, mask, CENTER).numpy()) <= 1


def test_dump_stages_raises_on_a_failed_write(tmp_path):
    """A debug_dir that cannot be made raises (the JAX package swallows a
    failed native write)."""
    blocker = tmp_path / "file"
    blocker.write_text("")
    src, dst, mask = _images(1)
    eng = SeamlessClone(CloneConfig(debug_dir=str(blocker / "dbg")), device="cpu")
    with pytest.raises(OSError):
        eng.dump_stages(src, dst, mask, CENTER)
    with pytest.raises(ValueError, match="empty mask"):
        eng.dump_stages(src, dst, np.zeros_like(mask), CENTER)


def test_profile_writes_a_trace(tmp_path):
    """profile() yields its directory and leaves a Chrome trace there."""
    src, dst, mask = _images(2)
    eng = SeamlessClone(device="cpu")
    with eng.profile(str(tmp_path / "trace")) as d:
        eng.run(src, dst, mask, CENTER)
    traces = sorted((tmp_path / "trace").glob("trace_*.json"))
    assert d == str(tmp_path / "trace") and len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any("erode3x3" in str(e.get("name", "")) or "aten::" in str(e.get("name", ""))
               for e in events)


def test_destroy_drops_the_engines_tensors():
    """After destroy() the engine holds no tensor (device_memory_bytes() ==
    0) and no cached basis, and it still runs."""
    src, dst, mask = _images(3)
    for cfg in (CloneConfig(), CloneConfig(solver="multigrid")):
        eng = SeamlessClone(cfg, device="cpu")
        want = eng.run(src, dst, mask, CENTER).numpy()
        eng.timed_serve(src, dst, mask, CENTER, loops=1)
        assert eng.device_memory_bytes() > 0
        assert len(eng._bases) + len(eng._eig_cache) > 0
        eng.destroy()
        assert eng.device_memory_bytes() == 0
        assert len(eng._bases) == len(eng._eig_cache) == 0 and eng._last_out is None
        assert np.array_equal(eng.run(src, dst, mask, CENTER).numpy(), want)


# ---------------------------------------------------------------------------
# native: OpenCV FileStorage YAML and 24-bit BMP
# ---------------------------------------------------------------------------


def test_yaml_text_is_the_reference_format(tmp_path):
    """The header, the dt forms, %.9g floats and the wrap before column 68,
    as the JAX package's C++ writer (native/src/scnative.cpp) emits them."""
    p = tmp_path / "a.yml"
    native.write_yaml_mat(p, np.array([[1.5, -2.0, 1 / 3]], np.float32), "g0")
    assert p.read_text() == ("%YAML:1.0\n---\nmat_name: g0\ndata: !!opencv-matrix\n"
                             "   rows: 1\n   cols: 3\n   dt: f\n"
                             "   data: [ 1.5, -2, 0.333333343 ]\n")
    native.write_yaml_mat(p, np.arange(60, dtype=np.uint8).reshape(5, 4, 3) * 4, "src")
    lines = p.read_text().splitlines()
    assert lines[5] == "   cols: 4" and lines[6] == '   dt: "3u"'
    assert lines[7].startswith("   data: [ 0, 4, 8,") and lines[-1].endswith(" ]")
    assert len(lines) > 9 and all(len(x) <= 68 and x.startswith("       ")
                                  for x in lines[8:])


@pytest.mark.parametrize("dtype, shape", [(np.uint8, (21, 34, 3)), (np.float32, (37, 53)),
                                          (np.int32, (4, 6)), (np.int16, (5, 9)),
                                          (np.float64, (6, 7, 2))])
def test_yaml_roundtrip_and_cv2(tmp_path, dtype, shape):
    """Each dtype written and read back bit-exactly, by the port and by
    cv2.FileStorage; a cv2-written matrix read by the port."""
    rng = np.random.default_rng(shape[0])
    if np.dtype(dtype).kind == "f":
        a = (rng.normal(size=shape) * 300).astype(dtype)
    else:
        info = np.iinfo(dtype)
        a = rng.integers(info.min, info.max, shape, endpoint=True).astype(dtype)
    p = tmp_path / "m.yml"
    native.write_yaml_mat(p, a, "m")
    back = native.read_yaml_mat(p)
    assert back.dtype == a.dtype and np.array_equal(back, a)
    fs = cv2.FileStorage(str(p), cv2.FILE_STORAGE_READ)
    assert np.array_equal(fs.getNode("data").mat(), a)
    fs.release()
    q = tmp_path / "cv.yml"
    fs = cv2.FileStorage(str(q), cv2.FILE_STORAGE_WRITE)
    fs.write("data", a)
    fs.release()
    assert np.array_equal(native.read_yaml_mat(q), a)


@pytest.mark.parametrize("shape", [(31, 45, 3), (8, 1, 3), (17, 22), (2, 3, 3)])
def test_bmp_roundtrip_and_cv2(tmp_path, shape):
    """24-bit BMP with row padding (every width mod 4): read back by the
    port and by cv2.imread; a cv2-written BMP read by the port; a gray
    image written as three equal channels; anything else refused."""
    rng = np.random.default_rng(shape[1])
    img = rng.integers(0, 256, shape).astype(np.uint8)
    want = img if img.ndim == 3 else np.repeat(img[..., None], 3, axis=2)
    p = tmp_path / "t.bmp"
    native.write_bmp(p, img)
    assert np.array_equal(native.read_bmp(p), want)
    assert np.array_equal(cv2.imread(str(p)), want)
    q = tmp_path / "cv.bmp"
    cv2.imwrite(str(q), want)
    assert np.array_equal(native.read_bmp(q), want)
    with pytest.raises(ValueError):
        native.write_bmp(p, np.zeros((4, 4, 2), np.uint8))
