"""The port's transpose-fused multigrid against the JAX package on the CPU.

Each kernel twin of the ``"t"`` chain (``ops/kernels.py``) against its
Pallas kernel run with ``interpret=True`` (the shapes of
``tests/test_pallas_kernels.py``'s multigrid CASES: beta != 1, odd and even
sides, w == wp, multi-strip); the plain parts of ``solvers/multigrid.py``
and the coarsest-level solve against their JAX functions; and
``solve_multigrid(padded="t")`` against the JAX solve in interpret mode.

Tolerances: the twins and the plain parts run the same float operations in
the same order as the JAX functions, but XLA on the CPU may contract a
multiply and an add into one FMA, so they agree to rtol 3e-6 with an
absolute floor of 1e-6 max |ref| (``tests/test_pallas_kernels.py:726``
allows the same); the integer-valued RHS kernel is bit-exact. The solves
differ further by the coarsest level's GEMM summation order: rel 1e-5.
Inputs are numpy-seeded.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seamlesscloneoptimization_tpu.ops import pallas_kernels as PK
from seamlesscloneoptimization_tpu.solvers import dst_gemm as JD
from seamlesscloneoptimization_tpu.solvers import jacobi as JJ
from seamlesscloneoptimization_tpu.solvers import multigrid as JM
from seamlesscloneoptimization_tpu_torch.ops import kernels as K
from seamlesscloneoptimization_tpu_torch.ops.guidance import bgr_to_gray_u8
from seamlesscloneoptimization_tpu_torch.solvers import dst_gemm as TD
from seamlesscloneoptimization_tpu_torch.solvers import jacobi as TJ
from seamlesscloneoptimization_tpu_torch.solvers import multigrid as TM

# Several pytest-xdist workers share the cores: one intra-op thread each keeps
# torch's OpenMP pools from oversubscribing them (it cut this suite's CPU time
# about 3.5x). Results do not depend on it.
torch.set_num_threads(1)

CASES = [
    ((64, 130), (1.0, 1.0)),
    ((63, 127), (1.5, 1.25)),   # odd sizes, beta-level operator
    ((70, 200), (1.0, 2.0)),    # even h, beta on w
    ((129, 257), (2.0, 1.0)),   # multi-strip at th=32
    ((64, 128), (1.0, 1.0)),    # w == wp
    ((40, 256), (1.0, 1.5)),    # w == wp with beta on w
]


def _rand(shape, seed, scale=50.0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32) * scale


def _close(got, want, rtol=3e-6):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-6 * np.abs(want).max())


def _slab(x, shape):
    out = np.zeros(shape, np.float32)
    out[tuple(slice(0, n) for n in x.shape)] = x
    return out


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# ---------------------------------------------------------------------------
# the kernel twins against their Pallas kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("th", [None, 32])
@pytest.mark.parametrize("hw,beta", CASES)
def test_mg_down_matches_pallas(hw, beta, th):
    (h, w), (bh, bw) = hw, beta
    geom = K.mg_geometry_t(h, w, th=th)
    _, hp, wp, hp2 = geom
    hc = (h - 1) // 2
    g = _slab(_rand((3, h, w), 3), (3, hp, wp))
    u = _slab(_rand((3, h, w), 4, 10.0), (3, hp, wp))
    for u_zero in (False, True):
        ju, jrh = PK.mg_down_pallas(None if u_zero else jnp.asarray(u), jnp.asarray(g), 1,
                                    bh=bh, bw=bw, interpret=True, blocked=True,
                                    padded_io=True, true_hw=(h, w), u_zero=u_zero,
                                    geom=geom[:3], rh_rows=hp2)
        tu, trh = K.mg_down(None if u_zero else _t(u), _t(g), 1, h, w, bh, bw, rh_rows=hp2)
        assert tu.shape == (3, hp, wp) and trh.shape == (3, hp2, wp)
        _close(tu[:, :h, :w], np.asarray(ju)[:, :h, :w])
        _close(trh[:, :hc], np.asarray(jrh)[:, :hc])
        # the zero invariant: u outside the domain, rh past hp // 2
        zm = np.ones(tu.shape, bool)
        zm[:, :h, :w] = False
        assert not tu.numpy()[zm].any()
        assert not trh[:, hp // 2 :].any()


@pytest.mark.parametrize("th", [None, 32])
@pytest.mark.parametrize("hw,beta", CASES)
def test_mg_up_matches_pallas(hw, beta, th):
    (h, w), (bh, bw) = hw, beta
    geom = K.mg_geometry_t(h, w, th=th)
    _, hp, wp, hp2 = geom
    hc = (h - 1) // 2
    g = _slab(_rand((3, h, w), 5), (3, hp, wp))
    u = _slab(_rand((3, h, w), 6, 10.0), (3, hp, wp))
    e = _slab(_rand((3, hc, w), 7, 5.0), (3, hp2, wp))
    ju = PK.mg_up_pallas(jnp.asarray(u), jnp.asarray(g), jnp.asarray(e), 2, bh=bh, bw=bw,
                         interpret=True, blocked=True, padded_io=True, true_hw=(h, w),
                         geom=geom[:3])
    tu = K.mg_up(_t(u), _t(g), _t(e), 2, h, w, bh, bw)
    _close(tu[:, :h, :w], np.asarray(ju)[:, :h, :w])
    zm = np.ones(tu.shape, bool)
    zm[:, :h, :w] = False
    assert not tu.numpy()[zm].any()


@pytest.mark.parametrize("hw,beta", CASES)
def test_mg_restrict_t_matches_pallas(hw, beta):
    (h, w), (_, bw) = hw, beta
    _, hp, wp, hp2 = K.mg_geometry_t(h, w)
    hc, wc = (h - 1) // 2, (w - 1) // 2
    out_rows = K.mg_geometry_t(wc, hc, wp_min=hp2)[1]
    # rh as mg_down leaves it: leftovers on rows [hc, hp // 2) must be masked
    rh = _slab(_rand((3, hp // 2, w), 21), (3, hp2, wp))
    want = np.asarray(PK.mg_restrict_t_pallas(jnp.asarray(rh), h, w, bw, out_rows=out_rows,
                                              interpret=True))
    got = K.mg_restrict_t(_t(rh), h, w, bw, out_rows)
    assert got.shape == (3, out_rows, hp2)
    _close(got, want)
    assert not got[:, wc:].any() and not got[:, :, hc:].any()


@pytest.mark.parametrize("hw,beta", CASES)
def test_mg_prolong_t_matches_pallas(hw, beta):
    (h, w), (_, bw) = hw, beta
    _, hp, wp, hp2 = K.mg_geometry_t(h, w)
    hc, wc = (h - 1) // 2, (w - 1) // 2
    _, chp, cwp, _ = K.mg_geometry_t(wc, hc, wp_min=hp2)
    ec = _slab(_rand((3, wc, hc), 22, 5.0), (3, chp, cwp))
    want = np.asarray(PK.mg_prolong_t_pallas(jnp.asarray(ec), h, w, bw, out_rows=hp2, wp=wp,
                                             interpret=True))
    got = K.mg_prolong_t(_t(ec), w, bw, hp2, wp)
    assert got.shape == (3, hp2, wp)
    _close(got, want)
    assert not got[:, hc:].any() and not got[:, :, w:].any()


def _rhs_inputs(h, w, seed):
    rng = np.random.default_rng(seed)
    dest = rng.integers(0, 256, (3, h, w)).astype(np.uint8)
    patch = rng.integers(0, 256, (3, h, w)).astype(np.uint8)
    mask = ((rng.random((h, w)) < 0.85) * 255).astype(np.uint8)
    mask[: h // 3, : w // 4] = 0
    return dest, patch, mask


@pytest.mark.parametrize("hw", [(40, 57), (131, 260)])
@pytest.mark.parametrize("mode", [(1, "opencv"), (2, "opencv"), (2, "norm"), (3, "opencv")])
def test_preprocess_rhs_p_matches_pallas(hw, mode):
    """Bit-exact against preprocess_rhs_pallas on the true region (the
    role the kernel plays on the "t" serve tail) and against
    preprocess_rhs_padded_pallas over the whole slab; MONOCHROME passes its
    gray patch with flags 1, as the pipeline does."""
    flags, rule = mode
    h, w = hw
    dest, patch, mask = _rhs_inputs(h, w, h + flags)
    kflags = flags
    if flags == 3:
        gray = bgr_to_gray_u8(_t(patch)).numpy().astype(np.uint8)
        patch = np.broadcast_to(gray[None], patch.shape).copy()
        kflags = 1
    me = K.erode3((_t(mask) != 0).to(torch.uint8))
    exact = K.preprocess_rhs_p(_t(dest), _t(patch), me, (h - 2, w - 2), kflags, rule)
    want = np.asarray(PK.preprocess_rhs_pallas(jnp.asarray(dest), jnp.asarray(patch),
                                               jnp.asarray(mask), kflags, rule,
                                               interpret=True))
    np.testing.assert_array_equal(exact.numpy(), want)
    out_hw = (K.ru128(h - 2), K.ru128(w - 2) + 128)
    slab = K.preprocess_rhs_p(_t(dest), _t(patch), me, out_hw, kflags, rule)
    want_p = np.asarray(PK.preprocess_rhs_padded_pallas(
        jnp.asarray(dest), jnp.asarray(patch), jnp.asarray(mask), out_hw, kflags, rule,
        interpret=True))
    np.testing.assert_array_equal(slab.numpy(), want_p)


def test_preprocess_rhs_p_rejects_a_small_slab():
    dest, patch, mask = _rhs_inputs(20, 30, 0)
    me = K.erode3((_t(mask) != 0).to(torch.uint8))
    with pytest.raises(ValueError, match="smaller than the interior"):
        K.preprocess_rhs_p(_t(dest), _t(patch), me, (17, 28))


# ---------------------------------------------------------------------------
# the plain parts
# ---------------------------------------------------------------------------


def test_geometry_coarsen_and_burst_bit_equal():
    for h in (3, 10, 16, 17, 63, 64, 100, 129, 255, 511, 1548, 2798):
        for w in (3, 40, 127, 128, 129, 520, 2396, 3798):
            for wp_min in (0, 256, 1536):
                assert K.mg_geometry_t(h, w, wp_min) == PK.mg_geometry_t(h, w, wp_min)
        for beta in (1.0, 1.5, 1.25, 2.0, 1.9375):
            assert TM._coarsen(h, beta) == JM._coarsen(h, beta)
    for tol in (0.5, 0.15, 0.1, 1e-2, 2e-4, 1e-4, 1e-6, 0.0):
        for mc in (1, 3, 60):
            for nu in ((1, 2), (1, 1), (2, 2)):
                assert TM._tol_burst(tol, mc, *nu) == JM._tol_burst(tol, mc, *nu)
    assert TM._tol_burst(1e-4, 60, 1, 2) == 3


@pytest.mark.parametrize("n,beta", [(5, 1.0), (30, 1.5), (47, 1.25), (64, 1.9375)])
def test_beta_eigenbasis_bit_equal(n, beta):
    for got, want in zip(TD.beta_eigenbasis(n, beta), JD.beta_eigenbasis(n, beta)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("beta", [(1.0, 1.0), (1.625, 1.625), (1.9375, 1.4375), (1.0, 1.5)])
def test_solve_sep_eig_matches_jax(beta):
    bh, bw = beta
    g = _rand((3, 47, 61), 30)
    want = np.asarray(JD.solve_sep_eig(jnp.asarray(g), bh, bw))
    got = TM.coarse_solve(_t(g), bh, bw).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    cache = {}
    cached = TM.coarse_solve(_t(g), bh, bw, cache).numpy()  # the engine's path
    assert len(cache) == 1
    assert np.abs(cached - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("hw,beta", CASES[:4])
def test_transfers_match_jax(hw, beta):
    (h, w), (bh, bw) = hw, beta
    r = _rand((3, h, w), 40)
    _close(TM.restrict_fw(_t(r), bh, bw), JM.restrict_fw(jnp.asarray(r), bh, bw))
    e = _rand((3, (h - 1) // 2, (w - 1) // 2), 41)
    _close(TM.prolong_bilinear(_t(e), h, w, bh, bw),
           JM.prolong_bilinear(jnp.asarray(e), h, w, bh, bw))


@pytest.mark.parametrize("hw,beta", CASES[:4])
def test_sweeps_and_residuals_match_jax(hw, beta):
    (h, w), (bh, bw) = hw, beta
    u, g = _rand((3, h, w), 50, 10.0), _rand((3, h, w), 51)
    _close(TJ.redblack_sweep(_t(u), _t(g)), JJ.redblack_sweep(jnp.asarray(u), jnp.asarray(g)))
    _close(TJ.residual(_t(u), _t(g)), JJ.residual(jnp.asarray(u), jnp.asarray(g)))
    _close(TM._sweeps_b(_t(u), _t(g), 2, bh, bw),
           JM._sweeps_b(jnp.asarray(u), jnp.asarray(g), 2, bh, bw))
    _close(TM._residual_b(_t(u), _t(g), bh, bw),
           JM._residual_b(jnp.asarray(u), jnp.asarray(g), bh, bw))


# ---------------------------------------------------------------------------
# the solver
# ---------------------------------------------------------------------------


def _rel_residual(u, g):
    r = TJ.residual(torch.from_numpy(np.asarray(u)), torch.from_numpy(g))
    return float(r.abs().max()) / float(np.abs(g).max())


@pytest.mark.parametrize("shape", [(1, 512, 520), (3, 511, 517)])
@pytest.mark.parametrize("mode", ["cycles", "tol"])
def test_solve_multigrid_t_matches_jax(shape, mode):
    g = _rand(shape, 16)
    kw = dict(cycles=2) if mode == "cycles" else dict(tol=1e-4, return_info=True)
    want = JM.solve_multigrid(jnp.asarray(g), use_pallas=True, interpret=True, padded="t",
                              **kw)
    got = TM.solve_multigrid(_t(g), use_pallas=True, padded="t", **kw)
    if mode == "tol":
        (want, jinfo), (got, info) = want, got
        assert info["cycles"] == int(jinfo["cycles"])
        assert info["residual"] <= 1e-4 * np.abs(g).max()
        assert _rel_residual(got, g) <= 1e-4
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("mode", ["cycles", "tol"])
def test_solve_multigrid_element_path_matches_jax(mode):
    """200x220 is below the fused gate: the plain element V-cycles."""
    g = _rand((3, 200, 220), 17)
    kw = dict(cycles=3) if mode == "cycles" else dict(tol=1e-4, return_info=True)
    want = JM.solve_multigrid(jnp.asarray(g), use_pallas=True, interpret=True, padded="t",
                              **kw)
    got = TM.solve_multigrid(_t(g), use_pallas=True, padded="t", **kw)
    if mode == "tol":
        (want, jinfo), (got, info) = want, got
        assert info["cycles"] == int(jinfo["cycles"])
        assert _rel_residual(got, g) <= 1e-4
    want = np.asarray(want)
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()


def test_padded_output_and_true_hw():
    """padded_output: the fine level's slab, exact zeros outside the domain,
    equal to the cropped solve; true_hw: the same solve from a pre-padded
    RHS (what the serve tail hands over)."""
    h, w = 512, 520
    g = _rand((1, h, w), 5)
    want = TM.solve_multigrid(_t(g), cycles=2, use_pallas=True, padded="t")
    slab = TM.solve_multigrid(_t(g), cycles=2, use_pallas=True, padded="t", padded_output=True)
    _, hp, wp, _ = K.mg_geometry_t(h, w)
    assert slab.shape == (1, hp, wp)
    assert torch.equal(slab[:, :h, :w], want)
    assert not slab[:, h:].any() and not slab[:, :, w:].any()
    pre = TM.solve_multigrid(_t(_slab(g, (1, hp, wp))), cycles=2, use_pallas=True,
                             padded="t", padded_output=True, true_hw=(h, w))
    assert torch.equal(pre, slab)
    small = TM.solve_multigrid(_t(g[:, :100, :90]), cycles=1, use_pallas=True, padded="t",
                               padded_output=True)
    assert small.shape == (1, 100, 90)  # the element path returns the exact size
    with pytest.raises(ValueError, match="geometry"):
        TM.solve_multigrid(_t(g), padded="t", use_pallas=True, true_hw=(h, w))
    with pytest.raises(ValueError, match="exclusive"):
        TM.solve_multigrid(_t(g), padded_output=True, return_info=True)


_U0 = _t(_rand((1, 512, 520), 9, 1.0))


@pytest.mark.parametrize("kw, same_as", [
    # with cycles, pcg is not read (as in JAX): the fixed-work V-cycles
    (dict(padded="q", pcg=True), dict(padded="q")),
    (dict(padded=True), dict(padded=False)),  # vcycle_p: bit-equal to the element chain
    (dict(padded="q", nu1=0), dict(padded=True, nu1=0)),  # the quarter gate fails: vcycle_p
    (dict(padded="t", pcg=True), dict(padded="t")),
    (dict(padded="t", fmg_start=True), dict(padded="t", u0="fmg")),  # fmg(g) as a warm start
    (dict(padded="q", fmg_start=True, u0=_U0), dict(padded="q", u0=_U0)),  # u0 wins
])
def test_unported_modes_raise(kw, same_as):
    """The modes that raised before the dense modes were ported (pcg,
    fmg_start, padded=True, "q" with nu1 = 0) now run on a fused grid, each
    equal to the solve it stands for."""
    g = _t(_rand((1, 512, 520), 10))
    if same_as.get("u0") == "fmg":
        same_as = dict(same_as, u0=TM.fmg(g, 1, 2, 63, use_pallas=True))
    got = TM.solve_multigrid(g, use_pallas=True, cycles=1, **kw)
    assert got.shape == g.shape and torch.isfinite(got).all() and got.abs().max() > 0
    assert torch.equal(got, TM.solve_multigrid(g, use_pallas=True, cycles=1, **same_as))


def test_small_grids_run_every_mode():
    """Below the fused gate every mg_padded runs the element path, as in
    the JAX package (the quarter and dense chains gate themselves off)."""
    g = _t(_rand((1, 90, 100), 8))
    want = TM.solve_multigrid(g, cycles=2, use_pallas=True, padded="t")
    for padded in ("q", True, False):
        assert torch.equal(TM.solve_multigrid(g, cycles=2, use_pallas=True, padded=padded),
                           want)
