"""The port's multigrid serve path (``mg_padded`` "q" and "t") against the
JAX package and cv2 on the CPU.

The JAX side runs its multigrid serve tail (``pipeline.py:152-237``) with
every Pallas kernel in interpret mode: the mocks of
``tests/test_mg_serve_tail.py``, the backend gate open, and the solver
called with ``interpret=True``. The ROI interiors are above the 2^18-point
gate, so both sides run the quarter-plane chain ("q", the default) or the
transpose-fused V-cycles ("t"). The solves differ by
f32 rounding (XLA's FMA contraction, the GEMM summation order), so the u8
results may differ by 1 where the truncation flips: diff_max <= 1. Images
are numpy-seeded.
"""

import contextlib
import functools
from unittest import mock

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seamlesscloneoptimization_tpu.core import engine as JE
from seamlesscloneoptimization_tpu.core.config import CloneConfig as JConfig
from seamlesscloneoptimization_tpu.models import pipeline as JP
from seamlesscloneoptimization_tpu.ops import pallas_kernels as PK
from seamlesscloneoptimization_tpu.solvers import multigrid as JM
from seamlesscloneoptimization_tpu_torch.core import engine as TE
from seamlesscloneoptimization_tpu_torch.core.config import CloneConfig
from seamlesscloneoptimization_tpu_torch.core.engine import SeamlessClone
from seamlesscloneoptimization_tpu_torch.models import pipeline as TP
from seamlesscloneoptimization_tpu_torch.ops import kernels as K
from seamlesscloneoptimization_tpu_torch.solvers import multigrid as TM

# Several pytest-xdist workers share the cores: one intra-op thread each keeps
# torch's OpenMP pools from oversubscribing them (it cut this suite's CPU time
# about 3.5x). Results do not depend on it.
torch.set_num_threads(1)

ROI = (522, 530)   # interior 520 x 528: 274,560 points, above the 2^18 gate
MODES = [(1, "opencv"), (2, "opencv"), (2, "norm"), (3, "opencv")]


@contextlib.contextmanager
def jax_mg_interpret():
    """The JAX multigrid serve tail with its Pallas kernels interpreted."""

    def force_interp(orig):
        return lambda *a, **k: orig(*a, **{**k, "interpret": True})

    with contextlib.ExitStack() as es:
        for name in ("preprocess_rhs_pallas", "erode3_pallas", "clamp_cast_pallas",
                     "clamp_cast_guarded_pallas", "paste_interior_pallas",
                     "preprocess_rhs_quarters_pallas", "clamp_cast_guarded_quarters_pallas"):
            es.enter_context(mock.patch.object(PK, name, force_interp(getattr(PK, name))))
        es.enter_context(mock.patch.object(JP, "_pallas_backend_available", lambda: True))
        es.enter_context(mock.patch.dict(
            JE.SOLVERS, {"multigrid": functools.partial(JM.solve_multigrid, interpret=True)}))
        yield


def _roi_inputs(seed):
    rng = np.random.default_rng(seed)
    h, w = ROI
    yy, xx = np.mgrid[:h, :w]
    base = (np.sin(yy / 37.0)[..., None] * 60 + np.cos(xx / 23.0)[..., None] * 50 + 128)
    dest = np.clip(base + rng.normal(0, 8, (h, w, 3)), 0, 255).astype(np.uint8)
    src = np.clip(255 - base + rng.normal(0, 12, (h, w, 3)), 0, 255).astype(np.uint8)
    mask = (((yy - h / 2) ** 2 / (h / 2.4) ** 2 + (xx - w / 2) ** 2 / (w / 2.6) ** 2) < 1)
    mask = mask.astype(np.uint8) * 255
    mask[[0, -1], :] = 0
    mask[:, [0, -1]] = 0
    return (np.ascontiguousarray(dest.transpose(2, 0, 1)),
            np.ascontiguousarray(src.transpose(2, 0, 1)), mask)


def _diff_max(a, b):
    return int(np.abs(np.asarray(a).astype(np.int16) - np.asarray(b)).max())


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("cycles", [None, 2])
def test_clone_roi_matches_jax(mode, cycles):
    flags, rule = mode
    dest, src, mask = _roi_inputs(flags)
    patch = np.where(mask[None] != 0, src, 0).astype(np.uint8)
    cfg = CloneConfig(solver="multigrid", mg_padded="t", mg_cycles=cycles, flags=flags,
                      mixed_rule=rule)
    kw = cfg.solver_kwargs()
    with jax_mg_interpret():
        want = np.asarray(JP.clone_roi(
            jnp.asarray(dest), jnp.asarray(patch), jnp.asarray(mask), flags,
            JM.solve_multigrid, {**kw, "interpret": True}, use_pallas_pre=True,
            use_pallas_post=True, mixed_rule=rule, solver_name="multigrid"))
    got = TP.clone_roi(torch.from_numpy(dest), torch.from_numpy(patch),
                       torch.from_numpy(mask), flags, TM.solve_multigrid, kw,
                       mixed_rule=rule, solver_name="multigrid").numpy()
    assert got.shape == want.shape == dest.shape
    assert _diff_max(got, want) <= 1
    assert np.array_equal(got[:, [0, -1]], dest[:, [0, -1]])  # the frame is dst's


def _images(seed):
    """A 522x530 source with a full mask (ROI 520x528 after the border
    zeroing: interior 518x526, above the gate) and a 600x640 destination."""
    rng = np.random.default_rng(seed)
    _, src, _ = _roi_inputs(seed)
    dst = rng.integers(0, 256, (600, 640, 3)).astype(np.uint8)
    dst = cv2.GaussianBlur(dst, (0, 0), 6)
    return np.ascontiguousarray(src.transpose(1, 2, 0)), dst, np.full(ROI, 255, np.uint8)


@pytest.mark.parametrize("flags", [1, 2, 3])
def test_engine_matches_jax_and_cv2(flags):
    """Port engine vs JAX engine (both mg_padded="t"), each against
    cv2.seamlessClone: the port no further from cv2 than the JAX engine,
    and within 1 of it."""
    src, dst, mask = _images(10 + flags)
    center = (320, 300)
    cfg = dict(solver="multigrid", mg_padded="t", flags=flags)
    eng = SeamlessClone(CloneConfig(**cfg), device="cpu")
    got = eng.run(src, dst, mask, center).numpy()
    assert eng.metrics["solver_resolved"] == "multigrid"
    with jax_mg_interpret():
        want = np.asarray(JE.SeamlessClone(JConfig(**cfg)).run(src, dst, mask.copy(), center))
    golden = cv2.seamlessClone(src, dst, mask.copy(), center, flags)
    assert _diff_max(got, want) <= 1
    assert _diff_max(got, golden) <= max(_diff_max(want, golden), 1)


def test_serve_matches_run():
    """timed_serve's chained planar frames land where a single run does
    (one frame: the same solve of the same destination)."""
    src, dst, mask = _images(20)
    eng = SeamlessClone(CloneConfig(solver="multigrid", mg_padded="t", mg_cycles=3),
                        device="cpu")
    run = eng.run(src, dst, mask, (320, 300)).numpy()
    served, ms = eng.timed_serve(src, dst, mask, (320, 300), loops=0)
    assert ms >= 0.0
    assert np.array_equal(served.numpy(), run)


def test_launch_counts_on_the_t_path(monkeypatch):
    """A CPU rehearsal of the card's per-frame counts: each outermost twin
    call stands for a kernel launch (mg_down_t_plain calls mg_down_plain and
    mg_restrict_t_plain: one kernel). Fixed mode, 2 cycles, 2 fused levels
    at this size: each fused V-cycle kernel twice per level and cycle, the
    standalone level kernels and transfers never."""
    counts = {}
    depth = [0]
    for name in ("erode3", "preprocess_rhs_p", "clamp_cast_paste", "mg_down", "mg_up",
                 "mg_restrict_t", "mg_prolong_t", "mg_down_t", "mg_up_t"):
        orig = getattr(K, f"{name}_plain")

        def counted(*a, _orig=orig, _name=name, **k):
            if depth[0] == 0:
                counts[_name] = counts.get(_name, 0) + 1
            depth[0] += 1
            try:
                return _orig(*a, **k)
            finally:
                depth[0] -= 1

        monkeypatch.setattr(K, f"{name}_plain", counted)
    src, dst, mask = _images(30)
    eng = SeamlessClone(CloneConfig(solver="multigrid", mg_padded="t", mg_cycles=2),
                        device="cpu")
    eng.run(src, dst, mask, (320, 300))
    _, _, bw, bh = eng.metrics["bbox"]
    levels, (h, w) = 0, (bh - 2, bw - 2)
    while TM._fused_level(h, w, 1, 2, True, TM.FUSE_MIN if levels == 0 else TM.FUSE_MIN_T):
        levels, (h, w) = levels + 1, ((w - 1) // 2, (h - 1) // 2)
    assert levels == 2
    assert counts == {"erode3": 1, "preprocess_rhs_p": 1, "clamp_cast_paste": 1,
                      "mg_down_t": 2 * levels, "mg_up_t": 2 * levels}


def test_auto_above_crossover_runs_multigrid(monkeypatch):
    monkeypatch.setattr(TE, "AUTO_CROSSOVER_PIXELS", 100)
    monkeypatch.setattr(TE, "SERVE_CROSSOVER_PIXELS", 100)
    src, dst, mask = _images(40)
    small_src, small_mask = src[:90, :120].copy(), np.full((90, 120), 255, np.uint8)
    eng = SeamlessClone(CloneConfig(mg_padded="t"), device="cpu")
    got = eng.run(small_src, dst, small_mask, (320, 300)).numpy()
    assert eng.metrics["solver_resolved"] == "multigrid"
    want = SeamlessClone(CloneConfig(solver="multigrid", mg_padded="t"), device="cpu").run(
        small_src, dst, small_mask, (320, 300)).numpy()
    assert np.array_equal(got, want)
    out, _ = eng.timed_serve(small_src, dst, small_mask, (320, 300), loops=1)
    assert eng.metrics["solver_resolved"] == "multigrid"
    assert out.shape == dst.shape
    # a zero check-free burst on a grid the quarter chain takes: the
    # check-first loop
    eng = SeamlessClone(CloneConfig(tol=0.05), device="cpu")
    assert eng.run(src, dst, mask, (320, 300)).shape == dst.shape
    assert eng.metrics["solver_resolved"] == "multigrid"
    # mg_padded=True: a grid below the fused gate runs the element path too
    dense = SeamlessClone(CloneConfig(mg_padded=True), device="cpu")
    assert np.array_equal(dense.run(small_src, dst, small_mask, (320, 300)).numpy(), want)
    assert dense.metrics["solver_resolved"] == "multigrid"
    # mg_padded=False runs the element V-cycle: below the fused gate, the
    # same arithmetic as every other mode
    eng = SeamlessClone(CloneConfig(mg_padded=False), device="cpu")
    assert np.array_equal(eng.run(small_src, dst, small_mask, (320, 300)).numpy(), want)
    assert eng.metrics["solver_resolved"] == "multigrid"


def test_multigrid_engine_builds_no_dst_bases():
    src, dst, mask = _images(50)
    eng = SeamlessClone(CloneConfig(solver="multigrid", mg_padded="t", mg_cycles=1),
                        device="cpu")
    eng.run(src, dst, mask, (320, 300))
    assert len(eng._bases) == 0
    assert len(eng._eig_cache) == 1  # the coarsest level's basis, cached once
    with pytest.raises(ValueError, match="mg_padded"):
        SeamlessClone(CloneConfig(mg_padded="x"), device="cpu")


# ---------------------------------------------------------------------------
# the quarter-plane chain (mg_padded="q", the default)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("cycles", [None, 2])
def test_clone_roi_q_matches_jax(mode, cycles):
    """The "q" tail: preprocess_rhs_q -> the quarter-plane solve ->
    clamp_cast_paste_q, against JAX's interpreted "q" tail."""
    flags, rule = mode
    dest, src, mask = _roi_inputs(flags + 4)
    patch = np.where(mask[None] != 0, src, 0).astype(np.uint8)
    cfg = CloneConfig(solver="multigrid", mg_cycles=cycles, flags=flags, mixed_rule=rule)
    kw = cfg.solver_kwargs()
    assert kw["padded"] == "q" and TM.quarter_path_applies(ROI[0] - 2, ROI[1] - 2)
    with jax_mg_interpret():
        want = np.asarray(JP.clone_roi(
            jnp.asarray(dest), jnp.asarray(patch), jnp.asarray(mask), flags,
            JM.solve_multigrid, {**kw, "interpret": True}, use_pallas_pre=True,
            use_pallas_post=True, mixed_rule=rule, solver_name="multigrid"))
    got = TP.clone_roi(torch.from_numpy(dest), torch.from_numpy(patch),
                       torch.from_numpy(mask), flags, TM.solve_multigrid, kw,
                       mixed_rule=rule, solver_name="multigrid").numpy()
    assert got.shape == want.shape == dest.shape
    assert _diff_max(got, want) <= 1
    assert np.array_equal(got[:, [0, -1]], dest[:, [0, -1]])


@pytest.mark.parametrize("flags", [1, 2, 3])
def test_default_engine_q_matches_jax_and_cv2(flags, monkeypatch):
    """CloneConfig() with the crossover patched low: auto -> multigrid "q" on
    both sides, the port within 1 of the JAX engine and no further from
    cv2.seamlessClone than it."""
    import seamlesscloneoptimization_tpu.solvers as JS

    for mod in (TE, JS):
        monkeypatch.setattr(mod, "AUTO_CROSSOVER_PIXELS", 100)
        monkeypatch.setattr(mod, "SERVE_CROSSOVER_PIXELS", 100)
    src, dst, mask = _images(60 + flags)
    center = (320, 300)
    eng = SeamlessClone(CloneConfig(flags=flags), device="cpu")
    got = eng.run(src, dst, mask, center).numpy()
    assert eng.metrics["solver_resolved"] == "multigrid"
    with jax_mg_interpret():
        want = np.asarray(JE.SeamlessClone(JConfig(flags=flags)).run(src, dst, mask.copy(),
                                                                     center))
    golden = cv2.seamlessClone(src, dst, mask.copy(), center, flags)
    assert _diff_max(got, want) <= 1
    assert _diff_max(got, golden) <= max(_diff_max(want, golden), 1)


@pytest.mark.parametrize("cycles", [None, 3])
def test_serve_matches_run_q(cycles):
    src, dst, mask = _images(70)
    eng = SeamlessClone(CloneConfig(solver="multigrid", mg_cycles=cycles), device="cpu")
    run = eng.run(src, dst, mask, (320, 300)).numpy()
    served, _ = eng.timed_serve(src, dst, mask, (320, 300), loops=0)
    assert np.array_equal(served.numpy(), run)
    assert np.array_equal(eng.run(src, dst, mask, (320, 300)).numpy(), run)  # a second run


Q_KERNELS = ("erode3", "preprocess_rhs_q", "mg_down_q", "mg_ud_q", "mg_up_q",
             "mg_prolong_tq", "clamp_cast_paste_q", "preprocess_rhs_p", "clamp_cast_paste",
             "mg_down", "mg_up", "mg_restrict_t", "mg_prolong_t", "mg_down_t", "mg_up_t",
             "to_quarters", "from_quarters", "mg_restrict_tq")


def _count_q_frame(monkeypatch, cfg, seed):
    """One single-shot run of ``cfg`` on ``_images(seed)`` with each outermost
    twin call of Q_KERNELS counted as a launch (a twin calling another, as
    preprocess_rhs_q_plain calls to_quarters_plain, is one kernel). Returns
    (counts, (h, w), the frame's dense RHS (C, h, w))."""
    counts = dict.fromkeys(Q_KERNELS, 0)
    depth = [0]
    for name in Q_KERNELS:
        orig = getattr(K, f"{name}_plain")

        def counted(*a, _orig=orig, _name=name, **k):
            counts[_name] += depth[0] == 0
            depth[0] += 1
            try:
                return _orig(*a, **k)
            finally:
                depth[0] -= 1

        monkeypatch.setattr(K, f"{name}_plain", counted)
    src, dst, mask = _images(seed)
    eng = SeamlessClone(cfg, device="cpu")
    eng.run(src, dst, mask, (320, 300))
    frame = dict(counts)  # the frame's launches, before the checks below
    _, _, bw, bh = eng.metrics["bbox"]
    h, w = bh - 2, bw - 2
    assert TM._fused_level((w - 1) // 2, (h - 1) // 2, 1, 2, True, TM.FUSE_MIN_T)
    assert not TM._fused_level(((h - 1) // 2 - 1) // 2, ((w - 1) // 2 - 1) // 2, 1, 2, True,
                               TM.FUSE_MIN_T)
    m, (x0, y0), (left, top), _ = TE.prepare_inputs(mask, src.shape, dst.shape, (320, 300))
    dest = torch.from_numpy(dst[top : top + bh, left : left + bw].transpose(2, 0, 1).copy())
    m01 = torch.from_numpy((m[y0 : y0 + bh, x0 : x0 + bw] != 0).astype(np.uint8))
    patch = torch.from_numpy(src[y0 : y0 + bh, x0 : x0 + bw].transpose(2, 0, 1).copy())
    patch = torch.where(m01[None] != 0, patch, 0).to(torch.uint8)
    g = K.preprocess_rhs_p_plain(dest, patch, K.erode3_plain(m01), (h, w))
    return frame, (h, w), g


@pytest.mark.parametrize("cycles", [None, 3])
def test_launch_counts_on_the_q_path(cycles, monkeypatch):
    """A CPU rehearsal of the card's per-frame counts (each twin call stands
    for a launch). Interior 518 x 526: one fused coarse level (262 x 258,
    transposed), then the exact solve. Fixed mode, k cycles: mg_down_q 1,
    mg_ud_q k-1, mg_prolong_tq k, mg_up_q 1, mg_down_t and mg_up_t k.
    Tolerance mode: mg_down_q 1, mg_ud_q = mg_prolong_tq = the cycles run,
    which is what the JAX package reports for the same RHS."""
    frame, _, g = _count_q_frame(
        monkeypatch, CloneConfig(solver="multigrid", mg_cycles=cycles), 80)
    k = cycles if cycles is not None else frame["mg_ud_q"]
    want = dict.fromkeys(Q_KERNELS, 0)
    want.update(erode3=1, preprocess_rhs_q=1, clamp_cast_paste_q=1, mg_down_q=1,
                mg_prolong_tq=k, mg_down_t=k, mg_up_t=k)
    if cycles is None:
        want.update(mg_ud_q=k)
        # the frame's RHS, dense, through the JAX solve's report
        _, info = JM.solve_multigrid(jnp.asarray(g.numpy()), padded="q", use_pallas=True,
                                     interpret=True, return_info=True)
        assert k == int(info["cycles"]) >= 3
    else:
        want.update(mg_ud_q=k - 1, mg_up_q=1)
    assert frame == want


def test_launch_counts_on_the_q_check_first_path(monkeypatch):
    """The check-first loop (tol 0.05: no check-free cycle), rehearsed: per
    cycle the split mg_down_q, mg_restrict_tq, the coarse level's two
    kernels, mg_prolong_tq and mg_up_q with its residual; no mg_ud_q, no
    conversion. The cycles are what the JAX package reports for the same
    RHS."""
    frame, _, g = _count_q_frame(monkeypatch, CloneConfig(solver="multigrid", tol=0.05), 90)
    k = frame["mg_up_q"]
    want = dict.fromkeys(Q_KERNELS, 0)
    want.update(erode3=1, preprocess_rhs_q=1, clamp_cast_paste_q=1,
                **{n: k for n in ("mg_down_q", "mg_restrict_tq", "mg_prolong_tq", "mg_up_q",
                                  "mg_down_t", "mg_up_t")})
    assert frame == want
    _, info = JM.solve_multigrid(jnp.asarray(g.numpy()), padded="q", use_pallas=True,
                                 interpret=True, tol=0.05, return_info=True)
    assert k == int(info["cycles"]) >= 1


@pytest.mark.parametrize("mode", [MODES[0], MODES[1], MODES[3]])
def test_clone_roi_q_coarse_tol_matches_jax(mode):
    """The "q" tail at tol 0.05 (the check-first loop) against JAX's
    interpreted "q" tail, NORMAL, MIXED and MONOCHROME."""
    flags, rule = mode
    dest, src, mask = _roi_inputs(flags + 8)
    patch = np.where(mask[None] != 0, src, 0).astype(np.uint8)
    kw = CloneConfig(solver="multigrid", tol=0.05, flags=flags, mixed_rule=rule).solver_kwargs()
    with jax_mg_interpret():
        want = np.asarray(JP.clone_roi(
            jnp.asarray(dest), jnp.asarray(patch), jnp.asarray(mask), flags,
            JM.solve_multigrid, {**kw, "interpret": True}, use_pallas_pre=True,
            use_pallas_post=True, mixed_rule=rule, solver_name="multigrid"))
    got = TP.clone_roi(torch.from_numpy(dest), torch.from_numpy(patch),
                       torch.from_numpy(mask), flags, TM.solve_multigrid, kw,
                       mixed_rule=rule, solver_name="multigrid").numpy()
    assert _diff_max(got, want) <= 1
    assert np.array_equal(got[:, [0, -1]], dest[:, [0, -1]])


@pytest.mark.parametrize("flags", [1, 2, 3])
def test_default_engine_coarse_tol_matches_jax(flags, monkeypatch):
    """SeamlessClone(CloneConfig(tol=0.05)) above a patched crossover: auto ->
    the "q" multigrid's check-first loop on both sides, within 1 of the JAX
    engine."""
    import seamlesscloneoptimization_tpu.solvers as JS

    for mod in (TE, JS):
        monkeypatch.setattr(mod, "AUTO_CROSSOVER_PIXELS", 100)
        monkeypatch.setattr(mod, "SERVE_CROSSOVER_PIXELS", 100)
    src, dst, mask = _images(100 + flags)
    eng = SeamlessClone(CloneConfig(flags=flags, tol=0.05), device="cpu")
    got = eng.run(src, dst, mask, (320, 300)).numpy()
    assert eng.metrics["solver_resolved"] == "multigrid"
    with jax_mg_interpret():
        want = np.asarray(JE.SeamlessClone(JConfig(flags=flags, tol=0.05)).run(
            src, dst, mask.copy(), (320, 300)))
    assert _diff_max(got, want) <= 1
