"""The port's dense multigrid modes against the JAX package on the CPU:
``mg_geometry``, the dense rounded V-cycle ``vcycle_p`` and
``solve_multigrid(padded=True)`` (and ``"q"`` with nu1 = 0, which falls to
it), the full-multigrid cascade ``fmg`` and ``fmg_start`` on every chain,
the flexible CG ``pcg``, and the dense serve frame through the engine.

The JAX side runs with ``interpret=True`` (its Pallas level kernels
interpreted); the port's level kernels run their plain twins. Tolerances:
a V-cycle and the 2-cycle solves from zero to relative 1e-5 of max |u|
(XLA's FMA contraction and the coarsest level's GEMM order); the longer
solves (tolerance mode, and every solve from an fmg start, whose cascade
adds a V-cycle a level) with equal cycle counts to 5e-5, as
``tests/test_torch_quarter_dense.py`` holds its tolerance-mode solves: the
coarse corrections amplify rounding, and JAX's own solves here move by
1.3e-5 to 2.0e-5 of max |u| under a one-ulp change of g (padded=True, 2
and 4 cycles, fmg start; measured at both shapes), while the port and JAX
differ by up to 1.1e-5 (tol) and 2.2e-5 (fmg start, 2 cycles); pcg to 5e-5
with equal iterations; the engines end to end diff_max <= 1 (u8). The dense
mode is bit-equal to the port's own ``padded=False``: both launch the same
level kernels, on slabs padded differently. JAX's references are computed
once per module (``_jax_solve``). Inputs are numpy-seeded.
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
from seamlesscloneoptimization_tpu_torch.core.config import CloneConfig
from seamlesscloneoptimization_tpu_torch.core.engine import SeamlessClone
from seamlesscloneoptimization_tpu_torch.models import pipeline as TP
from seamlesscloneoptimization_tpu_torch.ops import kernels as K
from seamlesscloneoptimization_tpu_torch.solvers import jacobi as TJ
from seamlesscloneoptimization_tpu_torch.solvers import multigrid as TM

# Several pytest-xdist workers share the cores: one intra-op thread each keeps
# torch's OpenMP pools from oversubscribing them. Results do not depend on it.
torch.set_num_threads(1)

SHAPES = [(1, 512, 520), (1, 511, 517)]  # above the 2^18-point gate: fused levels
MODES = {"cycles": {"cycles": 2}, "tol": {}}  # fixed work; tol 1e-4


def _rand(shape, seed, scale=50.0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32) * scale


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.abs(got - want).max() / np.abs(want).max()


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _slab(x, shape):
    out = np.zeros(shape, np.float32)
    out[tuple(slice(0, n) for n in x.shape)] = x
    return out


def _key(kw):
    return tuple(sorted(kw.items()))


@functools.lru_cache(maxsize=None)
def _jax_solve(shape, seed, key):
    """JAX's interpreted solve of ``_rand(shape, seed)`` with the keywords
    ``dict(key)``: (u, cycles or None), computed once per module."""
    kw = dict(key)
    out = JM.solve_multigrid(jnp.asarray(_rand(shape, seed)), use_pallas=True, interpret=True,
                             return_info=not kw.get("padded_output"), **kw)
    if kw.get("padded_output"):
        return np.asarray(out), None
    return np.asarray(out[0]), int(out[1]["cycles"])


def _port(shape, seed, **kw):
    return TM.solve_multigrid(_t(_rand(shape, seed)), use_pallas=True, return_info=True, **kw)


@pytest.mark.parametrize("hw", [(3, 3), (16, 17), (100, 129), (511, 517), (512, 520),
                                (773, 1197), (1548, 2396), (698, 948), (1398, 1898),
                                (2798, 3798), (1000, 2560), (1000, 2561), (40, 9000)])
def test_mg_geometry_matches_jax(hw):
    """The slab of every level: th 160 up to wp 2560, 128 above, clamped by
    the height and the strip budget; hp even."""
    got = K.mg_geometry(*hw)
    assert got == PK.mg_geometry(*hw)
    assert got[1] % 2 == 0 and got[1] >= hw[0] and got[2] % 128 == 0


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("known_zero", [False, True])
def test_vcycle_p_matches_jax(shape, known_zero):
    """One dense rounded V-cycle on mg_geometry's slab, from a random guess
    or a known-zero one (``u_p=None``; JAX's ``u_zero``): rel 1e-5, the slab
    kept, exact zeros outside the domain."""
    c, h, w = shape
    _, hp, wp = K.mg_geometry(h, w)
    g = _slab(_rand(shape, 3), (c, hp, wp))
    u = _slab(_rand(shape, 4, 10.0), (c, hp, wp)) * (0.0 if known_zero else 1.0)
    want = JM.vcycle_p(jnp.asarray(u), jnp.asarray(g), h, w, 1, 2, 63, use_pallas=True,
                       interpret=True, u_zero=known_zero)
    got = TM.vcycle_p(None if known_zero else _t(u), _t(g), h, w, 1, 2, 63)
    assert got.shape == (c, hp, wp)
    assert _rel(got, want) < 1e-5
    assert not got[:, h:].any() and not got[:, :, w:].any()


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("mode", list(MODES))
def test_solve_dense_matches_jax(shape, mode):
    """solve_multigrid(padded=True) against JAX's: rel 1e-5 (5e-5 in
    tolerance mode), the same cycles, and the same padded_output slab."""
    kw = dict(padded=True, **MODES[mode])
    want, cycles = _jax_solve(shape, 16, _key(kw))
    got, info = _port(shape, 16, **kw)
    assert info["cycles"] == cycles
    assert _rel(got, want) < (1e-5 if mode == "cycles" else 5e-5)
    if mode == "tol":
        assert info["residual"] <= 1e-4 * np.abs(_rand(shape, 16)).max()
    slab_want, _ = _jax_solve(shape, 16, _key(dict(kw, padded_output=True)))
    slab = TM.solve_multigrid(_t(_rand(shape, 16)), use_pallas=True, padded_output=True, **kw)
    assert slab.shape == slab_want.shape == (shape[0], *K.mg_geometry(*shape[1:])[1:])
    assert torch.equal(slab[:, : shape[1], : shape[2]], got)
    assert not slab[:, shape[1]:].any() and not slab[:, :, shape[2]:].any()


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("mode", list(MODES))
def test_dense_bit_equal_to_unpadded(shape, mode):
    """padded=True and padded=False launch the same level kernels on slabs
    padded differently (mg_geometry's, an even height): bit-equal results,
    equal cycles and residuals."""
    got, info = _port(shape, 16, padded=True, **MODES[mode])
    want, info_f = _port(shape, 16, padded=False, **MODES[mode])
    assert torch.equal(got, want) and info == info_f


@pytest.mark.parametrize("mode", list(MODES))
def test_q_with_nu1_zero_runs_vcycle_p(mode, monkeypatch):
    """The quarter chain needs nu1 >= 1: "q" with nu1 = 0 runs the dense
    rounded chain, as in the JAX package, bit-equal to padded=True, every
    cycle one vcycle_p on the fine slab; against JAX's rel 1e-5."""
    shape = SHAPES[0]
    calls = []
    vcycle_p = TM.vcycle_p

    def counted(u_p, g_p, h, w, *a, **k):
        calls.append((h, w))
        return vcycle_p(u_p, g_p, h, w, *a, **k)

    monkeypatch.setattr(TM, "vcycle_p", counted)
    got, info = _port(shape, 16, padded="q", nu1=0, **MODES[mode])
    fine = calls.count(shape[1:])
    assert fine == info["cycles"] >= 1
    dense, info_p = _port(shape, 16, padded=True, nu1=0, **MODES[mode])
    assert torch.equal(got, dense) and info == info_p
    want, cycles = _jax_solve(shape, 16, _key(dict(padded="q", nu1=0, **MODES[mode])))
    assert info["cycles"] == cycles
    assert _rel(got, want) < (1e-5 if mode == "cycles" else 5e-5)


@pytest.mark.parametrize("shape", SHAPES)
def test_fmg_matches_jax(shape):
    """The cascade itself: restrict down, the exact coarsest solve, then
    prolong and one element V-cycle (fused levels) a level."""
    g = _rand(shape, 21)
    want = JM.fmg(jnp.asarray(g), 1, 2, 63, use_pallas=True, interpret=True)
    got = TM.fmg(_t(g), 1, 2, 63, use_pallas=True)
    assert _rel(got, want) < 1e-5


@pytest.mark.parametrize("padded", ["q", "t", True, False])
@pytest.mark.parametrize("mode", list(MODES))
def test_fmg_start_matches_jax(padded, mode):
    """fmg_start on every chain, the fmg result taking each branch's warm
    start: equal cycles, rel 5e-5; from fmg the tolerance solve needs no
    more cycles than from zero."""
    shape = SHAPES[0]
    kw = dict(padded=padded, fmg_start=True, **MODES[mode])
    want, cycles = _jax_solve(shape, 16, _key(kw))
    got, info = _port(shape, 16, **kw)
    assert info["cycles"] == cycles
    assert _rel(got, want) < 5e-5
    if mode == "tol":
        _, zero = _port(shape, 16, padded=padded)
        assert info["cycles"] <= zero["cycles"]
        assert info["residual"] <= 1e-4 * np.abs(_rand(shape, 16)).max()


def test_fmg_start_yields_to_u0():
    """With u0 and fmg_start both given, u0 is the start (as in JAX)."""
    shape = SHAPES[0]
    u0 = _t(_rand(shape, 5, 1.0))
    for padded in ("q", True):
        a = TM.solve_multigrid(_t(_rand(shape, 16)), u0, use_pallas=True, cycles=1,
                               padded=padded, fmg_start=True)
        b = TM.solve_multigrid(_t(_rand(shape, 16)), u0, use_pallas=True, cycles=1,
                               padded=padded)
        assert torch.equal(a, b)


@pytest.mark.parametrize("shape", SHAPES)
def test_pcg_matches_jax(shape):
    """pcg in tolerance mode: the same iterations (``cycles``), rel 5e-5;
    the reported residual is the recurrence's max |r| and within tol, and
    the true residual is close to it."""
    want, iters = _jax_solve(shape, 16, _key(dict(pcg=True)))
    got, info = _port(shape, 16, pcg=True)
    assert info["cycles"] == iters
    assert _rel(got, want) < 5e-5
    gmax = np.abs(_rand(shape, 16)).max()
    assert info["residual"] <= 1e-4 * gmax
    true = TJ.residual(got, _t(_rand(shape, 16))).abs().max().item()
    assert true <= 2e-4 * gmax


def test_pcg_from_fmg_and_u0_matches_jax():
    shape = SHAPES[0]
    want, iters = _jax_solve(shape, 16, _key(dict(pcg=True, fmg_start=True)))
    got, info = _port(shape, 16, pcg=True, fmg_start=True)
    assert info["cycles"] == iters and _rel(got, want) < 5e-5


@pytest.mark.parametrize("padded", ["q", True, False])
def test_pcg_with_cycles_is_the_fixed_work_solve(padded):
    """As in the JAX package, ``cycles`` returns before pcg is read."""
    shape = SHAPES[0]
    a = TM.solve_multigrid(_t(_rand(shape, 16)), use_pallas=True, cycles=2, pcg=True,
                           padded=padded)
    b = TM.solve_multigrid(_t(_rand(shape, 16)), use_pallas=True, cycles=2, padded=padded)
    assert torch.equal(a, b)


def test_pcg_and_fmg_refuse_a_quartered_rhs():
    h, w = SHAPES[0][1:]
    _, hq, wq2, _ = K.mg_geometry_q(h, w)
    gq = torch.zeros((1, 4, hq, wq2))
    for kw in ({"pcg": True}, {"fmg_start": True}):
        with pytest.raises(ValueError, match="quartered"):
            TM.solve_multigrid(gq, true_hw=(h, w), use_pallas=True, **kw)


def test_solve_without_cache_builds_each_basis_once(monkeypatch):
    """A solve called without eig_cache keeps its own: fmg and every pcg
    iteration reach the coarsest level, and each geometry's basis is built
    once a call; the result equals the solve with a caller's cache."""
    shape = SHAPES[0]
    built = []
    basis = TM.sep_eig_basis

    def counted(h, w, bh, bw, device):
        built.append((h, w, bh, bw))
        return basis(h, w, bh, bw, device)

    monkeypatch.setattr(TM, "sep_eig_basis", counted)
    got, info = _port(shape, 16, pcg=True, fmg_start=True)
    assert info["cycles"] >= 2 and built and len(built) == len(set(built))
    cache: dict = {}
    again, _ = _port(shape, 16, pcg=True, fmg_start=True, eig_cache=cache)
    assert torch.equal(got, again) and len(cache) == len(set(built))


@contextlib.contextmanager
def _jax_mg_interpret():
    """The JAX multigrid serve tail with its Pallas kernels interpreted (as
    tests/test_torch_mg_pipeline.py runs it)."""

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


def _diff_max(a, b):
    return int(np.abs(np.asarray(a).astype(np.int16) - np.asarray(b)).max())


@pytest.mark.parametrize("flags", [1, 3])
def test_engine_dense_matches_jax(flags, monkeypatch):
    """SeamlessClone(CloneConfig(solver="multigrid", mg_padded=True)) on a
    full-mask 522x530 source (interior 518x526, fused levels) against the
    JAX engine (interpreted): diff_max <= 1, no further from cv2 than the
    JAX engine; the solve hands the paste mg_geometry's slab."""
    rng = np.random.default_rng(30 + flags)
    h, w = 522, 530
    yy, xx = np.mgrid[:h, :w]
    base = np.sin(yy / 37.0)[..., None] * 60 + np.cos(xx / 23.0)[..., None] * 50 + 128
    src = np.clip(255 - base + rng.normal(0, 12, (h, w, 3)), 0, 255).astype(np.uint8)
    dst = cv2.GaussianBlur(rng.integers(0, 256, (600, 640, 3)).astype(np.uint8), (0, 0), 6)
    mask = np.full((h, w), 255, np.uint8)
    center = (320, 300)
    cfg = dict(solver="multigrid", mg_padded=True, flags=flags)
    slabs = []
    paste = K.clamp_cast_paste

    def seen(u, *a, **k):
        slabs.append(tuple(u.shape))
        return paste(u, *a, **k)

    monkeypatch.setattr(TP, "clamp_cast_paste", seen)
    eng = SeamlessClone(CloneConfig(**cfg), device="cpu")
    got = eng.run(src, dst, mask, center).numpy()
    assert eng.metrics["solver_resolved"] == "multigrid"
    assert slabs == [(3, *K.mg_geometry(h - 4, w - 4)[1:])]
    with _jax_mg_interpret():
        want = np.asarray(JE.SeamlessClone(JConfig(**cfg)).run(src, dst, mask.copy(), center))
    golden = cv2.seamlessClone(src, dst, mask.copy(), center, flags)
    assert _diff_max(got, want) <= 1
    assert _diff_max(got, golden) <= max(_diff_max(want, golden), 1)
