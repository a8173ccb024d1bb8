"""Bucketed serving (``CloneConfig.bbox_bucket``) against the JAX package on
the CPU.

The grown bucket (the Poisson problem of the rounded-up ROI) and
``bucket_exact`` (the tight bbox's own system inside the bucket:
``clone_roi_dyn`` and the runtime-domain multigrid) against the JAX
engine's ``bbox_bucket=128`` in NORMAL, MIXED and MONOCHROME, diff_max <= 1;
the DST bases cached once per bucket; a serve frame bit-equal to ``run``;
a tight bbox without interior; ``TiledSeamlessClone`` on a CPU 2x2 mesh in
both modes against JAX's tiled engine. Each JAX engine compiles once per
module. Images are numpy-seeded.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from seamlesscloneoptimization_tpu.core.config import CloneConfig as JConfig
from seamlesscloneoptimization_tpu.core.engine import SeamlessClone as JEngine
from seamlesscloneoptimization_tpu.parallel import make_tile_mesh as jax_mesh
from seamlesscloneoptimization_tpu.parallel.clone_tiled import TiledSeamlessClone as JTiled
from seamlesscloneoptimization_tpu_torch.core.config import CloneConfig
from seamlesscloneoptimization_tpu_torch.core.engine import SeamlessClone, prepare_inputs
from seamlesscloneoptimization_tpu_torch.models.pipeline import clone_roi_dyn
from seamlesscloneoptimization_tpu_torch.ops.mask import binarize_mask
from seamlesscloneoptimization_tpu_torch.parallel import TiledSeamlessClone, make_tile_mesh

# Several pytest-xdist workers share the cores: one intra-op thread each.
torch.set_num_threads(1)

BUCKET = 128
SRC_HW, DST_HW, CENTER = (200, 300), (300, 420), (200, 150)


def _smooth(rng, hw, cell=16):
    """A blocky colour field plus noise: gradients of both signs and sizes."""
    coarse = rng.integers(0, 256, (hw[0] // cell + 2, hw[1] // cell + 2, 3)).astype(np.float32)
    img = np.kron(coarse, np.ones((cell, cell, 1), np.float32))[: hw[0], : hw[1]]
    return np.clip(img + rng.normal(0, 6, hw + (3,)), 0, 255).astype(np.uint8)


def _ellipse(hw, bbox_hw, centre=None):
    """An ellipse mask whose bbox is exactly ``bbox_hw`` (odd sides)."""
    ry, rx = (bbox_hw[0] - 1) // 2, (bbox_hw[1] - 1) // 2
    cy, cx = centre or (hw[0] // 2, hw[1] // 2)
    yy, xx = np.mgrid[: hw[0], : hw[1]]
    inside = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1
    return inside.astype(np.uint8) * 255


@functools.lru_cache(maxsize=None)
def _images():
    rng = np.random.default_rng(7)
    return _smooth(rng, SRC_HW), _smooth(rng, DST_HW)


MASK_BBOX = (121, 171)  # bucket 128 x 256: interior 126 x 254, tight 119 x 169


@functools.lru_cache(maxsize=None)
def _jax_engine(exact: bool, flags: int):
    return JEngine(JConfig(bbox_bucket=BUCKET, bucket_exact=exact, flags=flags))


@functools.lru_cache(maxsize=None)
def _jax_run(exact: bool, flags: int, bbox=MASK_BBOX):
    src, dst = _images()
    eng = _jax_engine(exact, flags)
    out = np.asarray(eng.run(src, dst, _ellipse(SRC_HW, bbox), CENTER))
    return out, eng.metrics["bbox"], eng.metrics["left_top"]


def _diff_max(a, b):
    return int(np.abs(np.asarray(a).astype(np.int16) - np.asarray(b)).max())


@pytest.mark.parametrize("flags", [1, 2, 3])
@pytest.mark.parametrize("exact", [False, True])
def test_engine_matches_jax(exact, flags):
    """The port's engine against the JAX engine's bbox_bucket=128: the same
    bucket, the image within 1; the grown bucket resolves auto on the
    bucket (dst_gemm here), bucket_exact runs the runtime-domain multigrid."""
    src, dst = _images()
    want, bbox, left_top = _jax_run(exact, flags)
    eng = SeamlessClone(CloneConfig(bbox_bucket=BUCKET, bucket_exact=exact, flags=flags),
                        device="cpu")
    got = eng.run(src, dst, _ellipse(SRC_HW, MASK_BBOX), CENTER).numpy()
    assert eng.metrics["bbox"] == tuple(bbox) and eng.metrics["left_top"] == tuple(left_top)
    assert bbox[2:] == (256, 128)
    assert eng.metrics["solver_resolved"] == ("multigrid_dyn" if exact else "dst_gemm")
    assert _diff_max(got, want) <= 1
    assert not np.array_equal(got, dst)


@pytest.mark.parametrize("use_pallas_pre", [True, False])
def test_clone_roi_dyn_matches_jax(use_pallas_pre):
    """clone_roi_dyn on the bucketed ROI (the kernel route's twins, or the
    plain RHS), pasted into the destination, against the JAX engine's
    bucket_exact image; a tight bbox without interior writes nothing."""
    src, dst = _images()
    mask = _ellipse(SRC_HW, MASK_BBOX)
    m, (x0, y0), (left, top), (bh, bw), tight = prepare_inputs(
        mask, src.shape, dst.shape, CENTER, bucket=BUCKET, return_tight=True)
    assert (bh, bw) == (128, 256) and tight[2:] == MASK_BBOX
    dest = torch.from_numpy(dst.copy()).permute(2, 0, 1)
    dest_roi = dest[:, top : top + bh, left : left + bw]
    src_roi = torch.from_numpy(src[y0 : y0 + bh, x0 : x0 + bw]).permute(2, 0, 1)
    mask_roi = binarize_mask(torch.from_numpy(m[y0 : y0 + bh, x0 : x0 + bw]))
    patch = torch.where(mask_roi[None] != 0, src_roi, 0).to(torch.uint8)
    blended = clone_roi_dyn(dest_roi, patch, mask_roi, 1, tight,
                            use_pallas_pre=use_pallas_pre)
    assert blended.shape == (3, bh, bw)
    out = dst.copy()
    out[top : top + bh, left : left + bw] = blended.permute(1, 2, 0).numpy()
    assert _diff_max(out, _jax_run(True, 1)[0]) <= 1
    # in place: only the tight interior moves
    clone_roi_dyn(dest_roi, patch, mask_roi, 1, tight, out=dest, out_offset=(top + 1, left + 1),
                  use_pallas_pre=use_pallas_pre)
    assert np.array_equal(dest.permute(1, 2, 0).numpy(), out)
    dy, dx, th, tw = tight
    outside = np.ones(DST_HW, bool)
    outside[top + dy + 1 : top + dy + th - 1, left + dx + 1 : left + dx + tw - 1] = False
    assert np.array_equal(out[outside], dst[outside])
    flat = clone_roi_dyn(dest_roi, patch, mask_roi, 1, (dy, dx, 2, tw))
    assert torch.equal(flat, dest_roi)


def test_three_mask_sizes_share_one_bucket():
    """Three tight bboxes in one 128 x 256 bucket: the grown bucket's DST
    bases are built once (one _bases entry), bucket_exact builds none; every
    frame within 1 of the JAX engine's."""
    src, dst = _images()
    grown = SeamlessClone(CloneConfig(bbox_bucket=BUCKET), device="cpu")
    exact = SeamlessClone(CloneConfig(bbox_bucket=BUCKET, bucket_exact=True), device="cpu")
    for bbox in (MASK_BBOX, (101, 131), (115, 201)):
        mask = _ellipse(SRC_HW, bbox)
        for eng, is_exact in ((grown, False), (exact, True)):
            got = eng.run(src, dst, mask, CENTER).numpy()
            assert eng.metrics["bbox"][2:] == (256, 128)
            assert _diff_max(got, _jax_run(is_exact, 1, bbox)[0]) <= 1
    assert len(grown._bases) == 1 and len(exact._bases) == 0
    assert len(_jax_engine(False, 1)._cache) == len(_jax_engine(True, 1)._cache) == 1


@pytest.mark.parametrize("exact", [False, True])
def test_serve_frame_equals_run(exact):
    """One chained serve frame (timed_serve's warm-up frame on the planar
    buffer, the tight bbox carried along in bucket_exact mode) equals run()
    byte for byte (the JAX package's test_serve_program_carries_tight_bbox);
    so does the next frame served on run's output."""
    src, dst = _images()
    mask = _ellipse(SRC_HW, (99, 161), (95, 140))
    eng = SeamlessClone(CloneConfig(bbox_bucket=BUCKET, bucket_exact=exact), device="cpu")
    want = eng.run(src, dst, mask, CENTER).numpy()
    served, _ = eng.timed_serve(src, dst, mask, CENTER, loops=0)
    assert np.array_equal(served.numpy(), want)
    served2, _ = eng.timed_serve(src, dst, mask, CENTER, loops=1)
    assert np.array_equal(served2.numpy(), eng.run(src, want, mask, CENTER).numpy())


def test_no_interior_tight_bbox():
    """A 2-row mask: bucket_exact leaves the destination as it is (the tight
    bbox has no interior; JAX's window is empty) and timed_serve refuses it;
    the grown bucket has an interior and solves it, as JAX's does (the
    eroded mask is empty, so the guidance is the destination's own)."""
    src, dst = _images()
    mask = np.zeros(SRC_HW, np.uint8)
    mask[90:92, 60:200] = 255
    exact = SeamlessClone(CloneConfig(bbox_bucket=BUCKET, bucket_exact=True), device="cpu")
    assert np.array_equal(exact.run(src, dst, mask, CENTER).numpy(), dst)
    want = np.asarray(_jax_engine(True, 1).run(src, dst, mask, CENTER))
    assert np.array_equal(want, dst)
    with pytest.raises(ValueError, match="no interior"):
        exact.timed_serve(src, dst, mask, CENTER, loops=0)
    grown = SeamlessClone(CloneConfig(bbox_bucket=BUCKET), device="cpu")
    got = grown.run(src, dst, mask, CENTER).numpy()
    assert _diff_max(got, np.asarray(_jax_engine(False, 1).run(src, dst, mask, CENTER))) <= 1
    assert grown.metrics["bbox"][2:] == (256, 128)


@pytest.mark.parametrize("exact", [False, True])
def test_tiled_engine_bucket_modes(exact):
    """TiledSeamlessClone(bbox_bucket=32) on a CPU 2x2 mesh against JAX's
    tiled engine on its 2x2 mesh: the grown bucket is the DD solve's ROI,
    bucket_exact the runtime-domain solve on the first device (bit-equal to
    the single-device engine's); the config's mg_cycles reaches the tiled
    bucket_exact solve."""
    rng = np.random.default_rng(3)
    src = rng.integers(0, 256, (72, 128, 3)).astype(np.uint8)
    dst = rng.integers(0, 256, (100, 200, 3)).astype(np.uint8)
    mask = _ellipse((72, 128), (53, 101), (36, 64))
    center = (100, 50)
    cfg = dict(bbox_bucket=32, bucket_exact=exact)
    want = np.asarray(JTiled(JConfig(**cfg), mesh=jax_mesh(jax.devices()[:4], (2, 2))).run(
        src, dst, mask, center))
    mesh = make_tile_mesh([torch.device("cpu")] * 4, (2, 2))
    eng = TiledSeamlessClone(CloneConfig(**cfg), mesh=mesh)
    got = eng.run(src, dst, mask, center).numpy()
    assert eng.metrics["solver_resolved"] == ("multigrid_dyn" if exact else "multigrid_dd")
    assert eng.metrics["bbox"][2:] == (128, 64)
    assert _diff_max(got, want) <= 1 and not np.array_equal(got, dst)
    if exact:
        for extra in ({}, {"mg_cycles": 2}):
            one = SeamlessClone(CloneConfig(**cfg, **extra), device="cpu")
            tiled = TiledSeamlessClone(CloneConfig(**cfg, **extra), mesh=mesh)
            assert np.array_equal(tiled.run(src, dst, mask, center).numpy(),
                                  one.run(src, dst, mask, center).numpy())
        assert not np.array_equal(tiled.run(src, dst, mask, center).numpy(), got)
