"""The port's batch (``parallel/batch.py``, ``api.seamless_clone_batch``)
against the JAX package on the CPU.

``clone_roi_batch`` against JAX's (its ``clone_roi`` under ``vmap``) in
the three clone modes, the plain route and the per-job kernel route
(``use_pallas=True``: the twins of ``erode3`` and ``preprocess_rhs_p``
here; JAX's CPU run takes its plain route); ``clone_batch_composite`` and
``clone_batch_composite_p`` with overlapping jobs (the ring of the later
window must be the ORIGINAL destination's: windows are gathered before any
paste and written whole in order); ``seamless_clone_batch_fused`` in
``"exact"``, ``"pad"`` and ``"pad_exact"`` (tol 1e-6) with mixed sizes, a
job without mask pixels and a ``None`` mask; ``seamless_clone_batch``;
every ValueError of JAX's ``seamless_clone_batch_fused`` under the same
inputs; the batched ``erode3x3`` bit-equal to the per-job one. The solves
are FP32 GEMMs on both sides (JAX's ``"high"`` on the CPU) and the
runtime-domain multigrid: diff_max <= 1 (u8). Inputs are numpy-seeded,
N = 3 to 7 jobs of at most 60x80.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seamlesscloneoptimization_tpu import api as JA
from seamlesscloneoptimization_tpu.parallel import batch as JB
from seamlesscloneoptimization_tpu_torch import api as TA
from seamlesscloneoptimization_tpu_torch.ops import kernels as K
from seamlesscloneoptimization_tpu_torch.ops.mask import erode3x3
from seamlesscloneoptimization_tpu_torch.parallel import batch as TB

# Several pytest-xdist workers share the cores: one intra-op thread each keeps
# torch's OpenMP pools from oversubscribing them. Results do not depend on it.
torch.set_num_threads(1)


def _dmax(a, b) -> int:
    return int(np.abs(np.asarray(a).astype(np.int64) - np.asarray(b).astype(np.int64)).max())


def _img(rng, hw, cell=6):
    """A blocky colour field plus noise, u8 (H, W, 3)."""
    h, w = hw
    base = np.kron(rng.integers(0, 256, (h // cell + 1, w // cell + 1, 3)),
                   np.ones((cell, cell, 1)))[:h, :w]
    return np.clip(base + rng.normal(0, 8, base.shape), 0, 255).astype(np.uint8)


def _ellipse(hw, fill=0.45):
    h, w = hw
    yy, xx = np.ogrid[:h, :w]
    inside = ((yy - (h - 1) / 2) / (h * fill)) ** 2 + ((xx - (w - 1) / 2) / (w * fill)) ** 2 <= 1
    return inside.astype(np.uint8) * 255


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _stacks(seed, n=4, hw=(34, 46)):
    """(dest_rois, patches, masks) of a group as the batch step makes them:
    planar u8 ROIs, patches zeroed outside the masks, border-zero masks."""
    rng = np.random.default_rng(seed)
    dest = np.stack([_img(rng, hw).transpose(2, 0, 1) for _ in range(n)])
    masks = np.stack([_ellipse(hw, 0.4 + 0.03 * i) for i in range(n)])
    patches = np.stack([_img(rng, hw).transpose(2, 0, 1) for _ in range(n)])
    patches = np.where(masks[:, None] != 0, patches, 0).astype(np.uint8)
    return dest, patches, masks


# ---------------------------------------------------------------------------
# the batched erosion
# ---------------------------------------------------------------------------


def test_batched_erode3x3_equals_per_job():
    rng = np.random.default_rng(3)
    m = (rng.random((5, 23, 31)) < 0.9).astype(np.uint8) * 255
    m[2] = 255
    got = erode3x3(_t(m))
    assert got.shape == m.shape
    for i in range(5):
        assert torch.equal(got[i], erode3x3(_t(m[i])))


# ---------------------------------------------------------------------------
# clone_roi_batch and the composites against JAX's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("flags", [1, 2, 3])
def test_clone_roi_batch_matches_jax(flags, use_pallas):
    dest, patches, masks = _stacks(flags)
    want = JB.clone_roi_batch(jnp.asarray(dest), jnp.asarray(patches), jnp.asarray(masks),
                              flags, JB.fast_dst_solver(), use_pallas)
    K.reset_launches()
    got = TB.clone_roi_batch(_t(dest), _t(patches), _t(masks), flags, TB.fast_dst_solver(),
                             use_pallas)
    assert not any(K.LAUNCHES.values())  # the twins run on the CPU, uncounted
    assert got.dtype == torch.uint8 and got.shape == dest.shape
    assert _dmax(got.numpy(), want) <= 1
    # the ring of every ROI is its destination's, and the input is untouched
    np.testing.assert_array_equal(got.numpy()[:, :, [0, -1], :], dest[:, :, [0, -1], :])
    np.testing.assert_array_equal(got.numpy()[:, :, :, [0, -1]], dest[:, :, :, [0, -1]])
    assert TB.fast_dst_solver() is TB.fast_dst_solver("high", True)


def _overlapping_jobs(seed):
    rng = np.random.default_rng(seed)
    dst = _img(rng, (90, 130))
    bh, bw = 36, 44
    srcs = np.stack([_img(rng, (bh, bw)) for _ in range(4)])
    masks = np.stack([_ellipse((bh, bw), 0.42)] * 4)
    masks[:, 0, :] = masks[:, -1, :] = masks[:, :, 0] = masks[:, :, -1] = 0
    # job 1 overlaps job 0 only, job 3 job 2 only
    lts = np.array([[10, 8], [30, 20], [80, 40], [84, 50]], np.int32)
    return dst, srcs, masks, lts, (bh, bw)


@pytest.mark.parametrize("planar", [False, True])
def test_clone_batch_composite_overlap_matches_jax(planar):
    """Overlapping jobs: the later window wins, ring included; its ring is
    the original destination's (gathered before any paste)."""
    dst, srcs, masks, lts, roi = _overlapping_jobs(5)
    solver_j, solver_t = JB.fast_dst_solver(), TB.fast_dst_solver()
    if planar:
        dst_p = np.ascontiguousarray(dst.transpose(2, 0, 1))
        want = np.asarray(JB.clone_batch_composite_p(
            jnp.asarray(dst_p), jnp.asarray(srcs), jnp.asarray(masks), jnp.asarray(lts), 1,
            solver_j, roi)).transpose(1, 2, 0)
        got = TB.clone_batch_composite_p(_t(dst_p), _t(srcs), _t(masks), _t(lts), 1, solver_t,
                                         roi).permute(1, 2, 0).numpy()
    else:
        want = np.asarray(JB.clone_batch_composite(
            jnp.asarray(dst), jnp.asarray(srcs), jnp.asarray(masks), jnp.asarray(lts), 1,
            solver_j, roi))
        got = TB.clone_batch_composite(_t(dst), _t(srcs), _t(masks), lts, 1, solver_t,
                                       roi).numpy()
    assert got.shape == dst.shape and _dmax(got, want) <= 1
    bh, bw = roi
    for lf, tp in lts[[1, 3]]:  # the later window of each overlapping pair
        win = got[tp : tp + bh, lf : lf + bw]
        orig = dst[tp : tp + bh, lf : lf + bw]
        np.testing.assert_array_equal(win[[0, -1]], orig[[0, -1]])
        np.testing.assert_array_equal(win[:, [0, -1]], orig[:, [0, -1]])


def test_clone_batch_composite_dyn_matches_jax():
    """The pad_exact step: each job's tight system in the shared window."""
    dst, srcs, masks, lts, roi = _overlapping_jobs(6)
    tights = np.array([[2, 3, 30, 36], [0, 0, 36, 44], [5, 1, 26, 40], [1, 6, 33, 30]],
                      np.int32)
    for i, (dy, dx, th, tw) in enumerate(tights):  # the masks inside the tight bboxes
        keep = np.zeros(roi, bool)
        keep[dy + 1 : dy + th - 1, dx + 1 : dx + tw - 1] = True
        masks[i] = np.where(keep, masks[i], 0)
    dst_p = np.ascontiguousarray(dst.transpose(2, 0, 1))
    want = JB.clone_batch_composite_dyn(jnp.asarray(dst_p), jnp.asarray(srcs),
                                        jnp.asarray(masks), jnp.asarray(lts),
                                        jnp.asarray(tights), 1, roi, 1e-6)
    got = TB.clone_batch_composite_dyn(_t(dst_p), _t(srcs), _t(masks), lts, tights, 1, roi,
                                       1e-6)
    assert _dmax(got.numpy(), want) <= 1


# ---------------------------------------------------------------------------
# seamless_clone_batch_fused and seamless_clone_batch against JAX's
# ---------------------------------------------------------------------------


def _jobs(seed):
    """Mixed sizes (two share a shape), overlapping jobs, a mask without
    pixels, a None (full) mask, a 3-D mask."""
    rng = np.random.default_rng(seed)
    dst = _img(rng, (120, 160))
    shapes = [(40, 50), (40, 50), (30, 44), (36, 36), (24, 60), (20, 20), (44, 30)]
    srcs = [_img(rng, s) for s in shapes]
    masks = [_ellipse(s, 0.4) for s in shapes]
    masks[3] = None
    masks[5] = np.zeros((20, 20), np.uint8)
    masks[6] = np.repeat(masks[6][..., None], 3, axis=2)
    centers = [(30, 25), (60, 40), (110, 70), (120, 92), (80, 60), (10, 10), (140, 30)]
    return dst, srcs, masks, centers


@pytest.mark.parametrize("bucket,flags,use_pallas", [
    ("exact", 1, False), ("exact", 1, True), ("exact", 2, False), ("exact", 3, True),
    ("pad", 1, False), ("pad", 3, True), ("pad_exact", 1, False), ("pad_exact", 2, False)])
def test_seamless_clone_batch_fused_matches_jax(bucket, flags, use_pallas):
    dst, srcs, masks, centers = _jobs(flags)
    kw = dict(flags=flags, bucket=bucket, use_pallas=use_pallas)
    if bucket == "pad_exact":
        kw["tol"] = 1e-6
    want = JB.seamless_clone_batch_fused(dst, srcs, masks, centers, **kw)
    got = TB.seamless_clone_batch_fused(dst, srcs, masks, centers, device="cpu", **kw)
    assert isinstance(got, np.ndarray) and got.dtype == np.uint8 and got.shape == dst.shape
    assert _dmax(got, want) <= 1
    assert not np.array_equal(got, dst)


def test_batch_api_matches_jax():
    dst, srcs, masks, centers = _jobs(7)
    want = JA.seamless_clone_batch(srcs, dst, masks, centers)
    got = TA.seamless_clone_batch(srcs, dst, masks, centers, device="cpu")
    assert isinstance(got, np.ndarray) and _dmax(got, want) <= 1
    want = JA.seamless_clone_batch_fused(dst, srcs, masks, centers, 2)
    got = TA.seamless_clone_batch_fused(dst, srcs, masks, centers, 2, device="cpu")
    assert _dmax(got, want) <= 1
    dst_before = dst.copy()
    TA.seamless_clone_batch(srcs, dst, masks, centers, device="cpu")
    np.testing.assert_array_equal(dst, dst_before)  # the caller's array is not written


def test_no_job_returns_a_copy():
    """No job with a mask pixel: a copy of dst, before the bucket is read."""
    dst, srcs, _, centers = _jobs(8)
    masks = [np.zeros(s.shape[:2], np.uint8) for s in srcs]
    for bucket in ("exact", "spiral"):
        want = JB.seamless_clone_batch_fused(dst, srcs, masks, centers, bucket=bucket)
        got = TB.seamless_clone_batch_fused(dst, srcs, masks, centers, bucket=bucket,
                                            device="cpu")
        np.testing.assert_array_equal(got, want)
        assert got is not dst
    np.testing.assert_array_equal(TA.seamless_clone_batch([], dst, [], [], device="cpu"), dst)


@pytest.mark.parametrize("case", ["pad_exact_solver", "bucket", "outside_left", "outside_bottom"])
def test_value_errors_match_jax(case):
    """Every ValueError JAX's seamless_clone_batch_fused raises, under the
    same inputs. (Its "bucket larger than destination" cannot be reached:
    the ROI check and the pad bucket's clamp to the destination keep every
    window inside.)"""
    dst, srcs, masks, centers = _jobs(9)
    kw = {}
    if case == "pad_exact_solver":
        kw = dict(bucket="pad_exact", solver=object())
    elif case == "bucket":
        kw = dict(bucket="spiral")
    elif case == "outside_left":
        centers = [(3, 60)] + centers[1:]
    else:
        centers = [(60, 118)] + centers[1:]
    errors = []
    for fn, extra in ((JB.seamless_clone_batch_fused, {}),
                      (TB.seamless_clone_batch_fused, dict(device="cpu"))):
        with pytest.raises(ValueError) as e:
            fn(dst, srcs, masks, centers, **kw, **extra)
        errors.append(str(e.value))
    assert errors[0] == errors[1]


def test_batch_needs_a_device():
    """Without a card the default device raises; nothing falls back."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    dst, srcs, masks, centers = _jobs(10)
    with pytest.raises(RuntimeError, match="CUDA"):
        TB.seamless_clone_batch_fused(dst, srcs, masks, centers)
    with pytest.raises(RuntimeError, match="CUDA"):
        TA.seamless_clone_batch(srcs, dst, masks, centers)
