"""The port's jacobi / dst_fft engines, the ``use_pallas_preprocess`` x
``use_pallas_postprocess`` routes and the ``postprocess_transposed`` twin,
against the JAX package and cv2 on the CPU.

``postprocess_transposed`` is integer-valued (a transpose, a clamp and a
truncating cast): its twin is bit-exact against
``postprocess_transposed_pallas`` run with ``interpret=True``. The routes
run JAX's ``clone_roi`` with its Pallas kernels interpreted (the mocks of
``tests/test_torch_pipeline.py``, plus the exact-size RHS and the
transposed post-process), so its #28 tail really runs; the solves sum in
other orders, so the u8 results may differ by 1 where the truncation flips:
diff_max <= 1, and no further from cv2 than the JAX engine. Images are
numpy-seeded.
"""

import contextlib
from unittest import mock

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seamlesscloneoptimization_tpu.core.config import CloneConfig as JConfig
from seamlesscloneoptimization_tpu.core.engine import SeamlessClone as JEngine
from seamlesscloneoptimization_tpu.models import pipeline as JP
from seamlesscloneoptimization_tpu.ops import pallas_kernels as PK
from seamlesscloneoptimization_tpu.solvers import multigrid as JM
from seamlesscloneoptimization_tpu.solvers import solve_dst_gemm as j_solve_dst_gemm
from seamlesscloneoptimization_tpu_torch.core.config import CloneConfig
from seamlesscloneoptimization_tpu_torch.core.engine import SeamlessClone
from seamlesscloneoptimization_tpu_torch.models import pipeline as TP
from seamlesscloneoptimization_tpu_torch.ops import kernels as K
from seamlesscloneoptimization_tpu_torch.solvers import multigrid as TM
from seamlesscloneoptimization_tpu_torch.solvers import solve_dst_gemm

# Several pytest-xdist workers share the cores: one intra-op thread each keeps
# torch's OpenMP pools from oversubscribing them (it cut this suite's CPU time
# about 3.5x). Results do not depend on it.
torch.set_num_threads(1)


def _diff_max(a, b):
    return int(np.abs(np.asarray(a).astype(np.int16) - np.asarray(b)).max())


# ---------------------------------------------------------------------------
# postprocess_transposed
# ---------------------------------------------------------------------------


def _post_inputs(bh, bw, seed):
    rng = np.random.default_rng(seed)
    u_t = rng.uniform(-60.0, 320.0, (3, bw - 2, bh - 2)).astype(np.float32)
    dest = rng.integers(0, 256, (3, bh, bw)).astype(np.uint8)
    return u_t, dest


@pytest.mark.parametrize("hw", [(64, 90), (64, 126), (64, 127), (64, 128), (64, 256),
                                (150, 260)])
def test_postprocess_transposed_matches_pallas(hw):
    """The blended ROI, bit-exact against the Pallas kernel (the bw % 128
    classes of tests/test_pallas_kernels.py, two strips at bh = 150), in a
    copy of the ROI and inside a larger interleaved image; the twin is
    postprocess_roi of the un-transposed solve."""
    bh, bw = hw
    u_t, dest = _post_inputs(bh, bw, bh + bw)
    want = np.asarray(PK.postprocess_transposed_pallas(jnp.asarray(u_t), jnp.asarray(dest),
                                                       interpret=True))
    roi = torch.from_numpy(dest.copy())
    K.reset_launches()
    assert K.postprocess_transposed(torch.from_numpy(u_t), roi, 1, 1) is roi
    assert K.LAUNCHES["postprocess_transposed"] == 0
    np.testing.assert_array_equal(roi.numpy(), want)
    img = np.zeros((bh + 9, bw + 5, 3), np.uint8)
    img[4 : 4 + bh, 3 : 3 + bw] = dest.transpose(1, 2, 0)
    got = torch.from_numpy(img.copy())
    K.postprocess_transposed(torch.from_numpy(u_t), got.permute(2, 0, 1), 5, 4)
    np.testing.assert_array_equal(got.numpy()[4 : 4 + bh, 3 : 3 + bw], want.transpose(1, 2, 0))
    outside = np.ones(img.shape[:2], bool)
    outside[5 : 3 + bh, 4 : 2 + bw] = False
    assert np.array_equal(got.numpy()[outside], img[outside])


def test_postprocess_transposed_validates_inputs():
    u_t = torch.zeros((3, 28, 18))
    dst = torch.zeros((3, 20, 30), dtype=torch.uint8)
    for bad in (lambda: K.postprocess_transposed(u_t, dst, 0, 1),   # no border row
                lambda: K.postprocess_transposed(u_t, dst, 2, 1),   # past the bottom
                lambda: K.postprocess_transposed(u_t[:2], dst, 1, 1),
                lambda: K.postprocess_transposed(u_t.transpose(1, 2), dst, 1, 1)):
        with pytest.raises(ValueError):
            bad()
    with pytest.raises(TypeError):
        K.postprocess_transposed(u_t.double(), dst, 1, 1)


# ---------------------------------------------------------------------------
# the four dst_gemm routes of clone_roi
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def jax_pallas_routes():
    """The JAX pipeline's Pallas kernels in interpret mode with its backend
    gate open, so every route of its clone_roi runs as on the TPU."""

    def force_interp(orig):
        return lambda *a, **k: orig(*a, **{**k, "interpret": True})

    with contextlib.ExitStack() as es:
        for name in ("preprocess_rhs_transposed_pallas", "preprocess_rhs_pallas",
                     "erode3_pallas", "transpose_pallas", "clamp_cast_pallas",
                     "clamp_cast_guarded_pallas", "paste_interior_pallas",
                     "fold_minor_pallas", "unfold_minor_pallas", "transpose_pair_pallas",
                     "unfold_transpose_pallas", "unfold_clamp_guarded_pallas",
                     "postprocess_transposed_pallas"):
            es.enter_context(mock.patch.object(PK, name, force_interp(getattr(PK, name))))
        es.enter_context(mock.patch.object(JP, "_pallas_backend_available", lambda: True))
        yield


def _roi(seed, h=48, w=70):
    rng = np.random.default_rng(seed)
    dest = rng.integers(0, 256, (3, h, w)).astype(np.uint8)
    src = rng.integers(0, 256, (3, h, w)).astype(np.uint8)
    mask = np.zeros((h, w), np.uint8)
    mask[4 : h - 4, 6 : w - 4] = 255
    return dest, np.where(mask[None] != 0, src, 0).astype(np.uint8), mask


@pytest.mark.parametrize("post", [False, True])
@pytest.mark.parametrize("pre", [False, True])
@pytest.mark.parametrize("flags", [1, 3])
def test_dst_gemm_routes_match_jax(flags, pre, post):
    """clone_roi under the four use_pallas_preprocess x use_pallas_postprocess
    combinations against JAX's; pre=False, post=True is the #28 tail
    (postprocess_transposed on both sides). Each route writes only the ROI
    interior."""
    dest, patch, mask = _roi(flags + 2 * pre + post)
    kw = {"precision": "high", "folded": True}
    with jax_pallas_routes():
        want = np.asarray(JP.clone_roi(jnp.asarray(dest), jnp.asarray(patch), jnp.asarray(mask),
                                       flags, j_solve_dst_gemm, solver_kwargs=kw,
                                       use_pallas_pre=pre, use_pallas_post=post,
                                       solver_name="dst_gemm"))
    got = TP.clone_roi(torch.from_numpy(dest), torch.from_numpy(patch), torch.from_numpy(mask),
                       flags, solve_dst_gemm, kw, solver_name="dst_gemm",
                       use_pallas_pre=pre, use_pallas_post=post).numpy()
    assert _diff_max(got, want) <= 1
    ring = np.ones(mask.shape, bool)
    ring[1:-1, 1:-1] = False
    assert np.array_equal(got[:, ring], dest[:, ring])


@pytest.mark.parametrize("post", [False, True])
@pytest.mark.parametrize("pre", [False, True])
def test_multigrid_routes_match_jax(pre, post):
    """The multigrid tail under the same four combinations on a small ROI
    (the element path): the plain RHS into solve(padded_output=True) when
    only the post-process is on, the generic tail without it."""
    dest, patch, mask = _roi(10 + 2 * pre + post)
    kw = CloneConfig(solver="multigrid").solver_kwargs()
    with jax_pallas_routes():
        want = np.asarray(JP.clone_roi(jnp.asarray(dest), jnp.asarray(patch), jnp.asarray(mask),
                                       1, JM.solve_multigrid, solver_kwargs=kw,
                                       use_pallas_pre=pre, use_pallas_post=post,
                                       solver_name="multigrid"))
    got = TP.clone_roi(torch.from_numpy(dest), torch.from_numpy(patch), torch.from_numpy(mask),
                       1, TM.solve_multigrid, kw, solver_name="multigrid",
                       use_pallas_pre=pre, use_pallas_post=post).numpy()
    assert _diff_max(got, want) <= 1
    ring = np.ones(mask.shape, bool)
    ring[1:-1, 1:-1] = False
    assert np.array_equal(got[:, ring], dest[:, ring])


@pytest.mark.parametrize("name", ["jacobi", "dst_fft"])
def test_post_tail_refuses_other_solvers(name):
    """The post-process tails are dst_gemm's and multigrid's (the engine turns
    the post-process off for the others): asked of another solver directly,
    clone_roi raises rather than solve with another solver's chain."""
    dest, patch, mask = (torch.from_numpy(a) for a in _roi(20))
    with pytest.raises(ValueError, match="no tail"):
        TP.clone_roi(dest, patch, mask, 1, solver_name=name)
    out = TP.clone_roi(dest, patch, mask, 1, solver_name=name, use_pallas_post=False)
    assert out.shape == dest.shape


def _count_twins(monkeypatch, names):
    """Each outermost twin call of ``names`` counted as a launch (rb_sweeps:
    ceil(n / 4) launches a call), as the card would count them."""
    counts = dict.fromkeys(names, 0)
    for name in names:
        orig = getattr(K, f"{name}_plain")

        def counted(*a, _orig=orig, _name=name, **k):
            counts[_name] += -(-a[2] // K.RB_SWEEPS_PER_LAUNCH) if _name == "rb_sweeps" else 1
            return _orig(*a, **k)

        monkeypatch.setattr(K, f"{name}_plain", counted)
    return counts


ROUTE_KERNELS = ("erode3", "preprocess_rhs_t", "preprocess_rhs_p", "clamp_cast_paste",
                 "transpose", "postprocess_transposed", "rb_sweeps")


@pytest.mark.parametrize("route", ["pre only", "post only", "neither"])
def test_route_launch_counts(route, monkeypatch):
    """A CPU rehearsal of the card's per-frame counts for the routes that the
    two fields select on dst_gemm (46 x 68 interior: nothing folds)."""
    pre, post = {"pre only": (True, False), "post only": (False, True),
                 "neither": (False, False)}[route]
    counts = _count_twins(monkeypatch, ROUTE_KERNELS)
    src, dst, mask = _images(7, (50, 72), (90, 120))
    eng = SeamlessClone(CloneConfig(use_pallas_preprocess=pre, use_pallas_postprocess=post),
                        device="cpu")
    eng.run(src, dst, mask, (60, 45))
    want = dict.fromkeys(ROUTE_KERNELS, 0)
    if pre:
        want.update(erode3=1, preprocess_rhs_p=1)
    want.update(postprocess_transposed=1) if post else want.update(clamp_cast_paste=1)
    assert counts == want
    assert len(eng._bases) == 0  # the routes' solvers build their own bases


# ---------------------------------------------------------------------------
# the jacobi and dst_fft engines
# ---------------------------------------------------------------------------


def _images(seed, src_hw, dst_hw):
    """Smooth images and a full mask: the ROI is the source less its border."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[: dst_hw[0], : dst_hw[1]]
    base = np.sin(yy / 9.0)[..., None] * 50 + np.cos(xx / 7.0)[..., None] * 40 + 128
    dst = np.clip(base + rng.normal(0, 6, dst_hw + (3,)), 0, 255).astype(np.uint8)
    src = np.clip(255 - base[: src_hw[0], : src_hw[1]] + rng.normal(0, 9, src_hw + (3,)),
                  0, 255).astype(np.uint8)
    return src, dst, np.full(src_hw, 255, np.uint8)


@pytest.mark.parametrize("solver, flags", [("dst_fft", 1), ("dst_fft", 2), ("dst_fft", 3),
                                           ("jacobi", 1), ("jacobi", 3)])
def test_engine_matches_jax_and_cv2(solver, flags):
    """dst_fft on a 120 x 150 interior, jacobi on a 40 x 56 one (converged
    within max_iters): the port within 1 of the JAX engine and no further
    from cv2.seamlessClone than it; timed_serve's frame lands where run does."""
    src_hw = (124, 154) if solver == "dst_fft" else (44, 60)
    src, dst, mask = _images(flags, src_hw, (200, 240))
    center = (120, 100)
    eng = SeamlessClone(CloneConfig(solver=solver), device="cpu")
    got = eng.run(src, dst, mask, center, flags).numpy()
    assert eng.metrics["solver_resolved"] == solver and len(eng._bases) == 0
    want = np.asarray(JEngine(JConfig(solver=solver)).run(src, dst, mask.copy(), center, flags))
    golden = cv2.seamlessClone(src, dst, mask.copy(), center, flags)
    assert _diff_max(got, want) <= 1
    assert _diff_max(got, golden) <= max(_diff_max(want, golden), 1)
    served, _ = eng.timed_serve(src, dst, mask, center, loops=0, flags=flags)
    assert np.array_equal(served.numpy(), got)


def test_jacobi_launch_counts(monkeypatch):
    """The jacobi frame, rehearsed: erode3, preprocess_rhs_p and
    clamp_cast_paste once, rb_sweeps ceil(50 / 4) = 13 launches per burst of
    50 sweeps, the bursts being the solve's iterations / 50."""
    counts = _count_twins(monkeypatch, ROUTE_KERNELS)
    src, dst, mask = _images(5, (44, 60), (200, 240))
    eng = SeamlessClone(CloneConfig(solver="jacobi"), device="cpu")
    eng.run(src, dst, mask, (120, 100))
    bursts = counts["rb_sweeps"] // 13
    assert counts == dict(dict.fromkeys(ROUTE_KERNELS, 0), erode3=1, preprocess_rhs_p=1,
                          clamp_cast_paste=1, rb_sweeps=13 * bursts)
    assert 1 <= bursts < CloneConfig().max_iters // 50
