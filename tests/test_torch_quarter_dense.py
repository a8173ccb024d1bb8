"""The rest of the port's quarter-plane multigrid against the JAX package on
the CPU: the split descent's transposed restriction, the unfused V-cycle
``vcycle_q``, and ``solve_multigrid(padded="q")`` from a born-quartered RHS
and on a dense RHS in every mode (fixed cycles, tolerance with and without a
check-free burst, the dense results, ``return_info``, warm starts,
``max_cycles=0``), plus warm starts on the ``"t"`` chain and the element
path. JAX's interpreted solve of the dense RHS is computed once per shape
and mode (``_jax_dense_solve``) for the tests that hold the port to it.

Tolerances, as in ``tests/test_torch_quarter.py`` (which also holds the
conversions, both descent forms and the ascent's residual): the
restriction's twin runs the Pallas kernel's float operations in the same
order, but XLA on the CPU may contract a multiply and an add into one FMA,
so it agrees to rtol 3e-6 with an absolute floor of 1e-6 max |ref|. One
V-cycle and two fixed cycles agree to rel 1e-5, the residual max of a
V-cycle to 1e-5 relative; a tolerance-mode solve to 5e-5 with equal cycle
counts (the coarse corrections amplify rounding: a one-ulp change of g
moves a 4-cycle result of either implementation by about 1e-5 of max
|u|). Inputs are numpy-seeded.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seamlesscloneoptimization_tpu.ops import pallas_mg_quarter as MQ
from seamlesscloneoptimization_tpu.solvers import multigrid as JM
from seamlesscloneoptimization_tpu_torch.ops import kernels as K
from seamlesscloneoptimization_tpu_torch.solvers import jacobi as TJ
from seamlesscloneoptimization_tpu_torch.solvers import multigrid as TM

# Several pytest-xdist workers share the cores: one intra-op thread each keeps
# torch's OpenMP pools from oversubscribing them (it cut this suite's CPU time
# about 3.5x). Results do not depend on it.
torch.set_num_threads(1)

# (h, w): even/even, odd/odd, even/odd, odd/even, and two 128-row strips
CASES = [(200, 230), (201, 231), (250, 129), (129, 300), (300, 257)]
SHAPES = [(1, 512, 520), (3, 511, 517)]  # above the 2^18-point gate: the "q" chain


def _rand(shape, seed, scale=50.0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32) * scale


def _close(got, want, rtol=3e-6):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-6 * np.abs(want).max())


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return np.abs(got - want).max() / np.abs(want).max()


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _j(x):
    return jnp.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


def _dense(g):
    """g (C, h, w) zero-padded to the quarter geometry's (C, 2 hq, 2 wq2)."""
    c, h, w = g.shape
    _, hq, wq2, _ = K.mg_geometry_q(h, w)
    out = np.zeros((c, 2 * hq, 2 * wq2), np.float32)
    out[:, :h, :w] = g
    return out


def _level(h, w, seed):
    """(geom, chp, g, u): quarter planes of a random RHS and guess, exact zeros
    outside the (h, w) domain."""
    geom = K.mg_geometry_q(h, w)
    chp = K.mg_geometry_t((w - 1) // 2, (h - 1) // 2, wp_min=geom[3])[1]
    g = K.to_quarters(_t(_dense(_rand((3, h, w), seed))))
    u = K.to_quarters(_t(_dense(_rand((3, h, w), seed + 1, 10.0))))
    return geom, chp, g, u


def _rel_residual(u, g):
    return TJ.residual(u, _t(g)).abs().max().item() / np.abs(g).max()


# ---------------------------------------------------------------------------
# the split descent's restriction
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hw", CASES)
def test_mg_restrict_tq_matches_pallas(hw):
    """Against mg_restrict_tq_pallas on rh planes with data in every row (as
    the Pallas descent leaves them beyond hc), and the split descent +
    restriction against the Pallas descent's fused restriction to a few ulp
    (its even-w edge lane rounds once less: MQ:429-433). NaN outside the
    rows and columns read does not reach the result."""
    h, w = hw
    geom, chp, g, u = _level(h, w, 5 * h + w)
    _, hq, wq2, hp2 = geom
    hc, wc = (h - 1) // 2, (w - 1) // 2
    rh_e, rh_o = (_t(_rand((3, hp2, wq2), 5 * h + w + k, 20.0)) for k in (2, 3))
    want = MQ.mg_restrict_tq_pallas(_j(rh_e), _j(rh_o), h, w, 1.0, out_rows=chp,
                                    out_lanes=hp2, interpret=True)
    got = K.mg_restrict_tq(rh_e, rh_o, h, w, chp)
    assert got.shape == (3, chp, hp2)
    _close(got, want)
    assert not got[:, wc:].any() and not got[:, :, hc:].any()
    poisoned = [x.clone() for x in (rh_e, rh_o)]
    for x in poisoned:
        x[:, hc:] = float("nan")
        x[:, :, wc + 1 :] = float("nan")
    assert torch.equal(K.mg_restrict_tq(*poisoned, h, w, chp), got)
    _, fused = MQ.mg_down_q_pallas(_j(u), _j(g), 1, (h, w), geom, interpret=True,
                                   rct_rows=chp)
    _close(K.mg_restrict_tq(*K.mg_down_q(u, g, 1, h, w)[1:], h, w, chp), fused)


# ---------------------------------------------------------------------------
# the unfused V-cycle and the solver
# ---------------------------------------------------------------------------

SOLVE_MODES = {"cycles": dict(cycles=2), "tol": dict(tol=1e-4), "coarse tol": dict(tol=0.05)}


@functools.lru_cache(maxsize=None)
def _jax_dense_solve(shape, mode):
    """JAX's interpreted solve of the dense RHS ``_rand(shape, 16)`` in
    ``mode``: (u, cycles from return_info), computed once per module."""
    u, info = JM.solve_multigrid(_j(_rand(shape, 16)), padded="q", use_pallas=True,
                                 interpret=True, return_info=True, **SOLVE_MODES[mode])
    return np.asarray(u), int(info["cycles"])


def _zero_outside(uq, h, w):
    d = K.from_quarters(uq).numpy()
    return not d[:, h:].any() and not d[:, :, w:].any()


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("mode", ["cycles", "tol"])
def test_solve_multigrid_q_matches_jax(shape, mode, monkeypatch):
    """The born-quartered solve against JAX's interpreted one; tolerance
    mode: the cycles run (mg_ud_q launches) equal to the cycles JAX reports
    for the dense RHS, and the relative residual within tol."""
    _, h, w = shape
    g = _rand(shape, 16)
    gq = K.to_quarters(_t(_dense(g)))
    kw = SOLVE_MODES[mode]
    want = np.asarray(JM.solve_multigrid(_j(gq), true_hw=(h, w), padded="q", use_pallas=True,
                                         interpret=True, padded_output="quarters", **kw))
    launches = []
    orig = K.mg_ud_q_plain
    monkeypatch.setattr(K, "mg_ud_q_plain", lambda *a, **k: launches.append(1) or orig(*a, **k))
    got = TM.solve_multigrid(gq, true_hw=(h, w), padded="q", use_pallas=True,
                             padded_output="quarters", **kw)
    assert got.shape == gq.shape and _zero_outside(got, h, w)
    rel = np.abs(got.numpy() - want).max() / np.abs(want).max()
    if mode == "cycles":
        assert len(launches) == 1 and rel <= 1e-5
        return
    assert len(launches) == _jax_dense_solve(shape, "tol")[1]
    assert rel <= 5e-5
    u = K.from_quarters(got)[:, :h, :w]
    assert TJ.residual(u, _t(g)).abs().max().item() <= 1e-4 * np.abs(g).max()


@pytest.mark.parametrize("start", ["zero", "guess"])
def test_vcycle_q_matches_jax(start):
    """One unfused quarter V-cycle with its residual, against JAX's vcycle_q
    (the zero start: explicit zero planes there, the known-zero descent
    here)."""
    h, w = 512, 520
    geom, _, g, u = _level(h, w, 31)
    uq = None if start == "zero" else u
    ju, jmax = JM.vcycle_q(jnp.zeros(g.shape, jnp.float32) if uq is None else _j(uq), _j(g),
                           h, w, interpret=True, geom=geom, with_residual=True)
    tu, tmax = TM.vcycle_q(uq, g, h, w, with_residual=True)
    assert _rel(tu, ju) <= 1e-5
    assert abs(float(tmax) - float(jmax)) <= 1e-5 * float(jmax)
    assert torch.equal(TM.vcycle_q(uq, g, h, w), tu)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("mode", ["cycles", "tol", "coarse tol"])
def test_solve_multigrid_q_dense_matches_jax(shape, mode):
    """A dense RHS through the quarter chain (to_quarters in, from_quarters
    out) against JAX's interpreted solve: two fixed cycles; tol 1e-4 (a
    check-free burst first); tol 0.05 (no burst: the check-first loop), each
    with return_info's cycles equal and its residual within tol. The RHS is
    ``tests/test_torch_quarter.py``'s born-quartered one, dense here."""
    g = _rand(shape, 16)
    kw = SOLVE_MODES[mode]
    want, jcycles = _jax_dense_solve(shape, mode)
    got, info = TM.solve_multigrid(_t(g), padded="q", use_pallas=True, return_info=True, **kw)
    assert got.shape == g.shape
    assert info["cycles"] == jcycles
    assert _rel(got, want) <= (1e-5 if mode == "cycles" else 5e-5)
    assert info["residual"] == pytest.approx(TJ.residual(got, _t(g)).abs().max().item())
    if mode != "cycles":
        assert info["residual"] <= kw["tol"] * np.abs(g).max()
    if mode == "coarse tol":
        assert TM._tol_burst(0.05, 60) == 0 and info["cycles"] >= 1


def test_dense_results_and_pre_padded_g():
    """padded_output True: the (C, 2 hq, 2 wq2) interleaved planes, exact zeros
    outside the domain; False: its [:h, :w]; "quarters": the planes. A
    dense pre-padded g (true_hw) gives the same solve as the true-size g."""
    h, w = 511, 517
    g = _rand((1, h, w), 40)
    _, hq, wq2, _ = K.mg_geometry_q(h, w)
    kw = dict(padded="q", use_pallas=True, cycles=1)
    planes = TM.solve_multigrid(_t(g), padded_output="quarters", **kw)
    slab = TM.solve_multigrid(_t(g), padded_output=True, **kw)
    crop = TM.solve_multigrid(_t(g), **kw)
    assert planes.shape == (1, 4, hq, wq2) and slab.shape == (1, 2 * hq, 2 * wq2)
    assert torch.equal(slab, K.from_quarters(planes))
    assert not slab[:, h:].any() and not slab[:, :, w:].any()
    assert torch.equal(crop, slab[:, :h, :w])
    assert torch.equal(TM.solve_multigrid(_t(_dense(g)), true_hw=(h, w), **kw), crop)


@pytest.mark.parametrize("mode", ["cycles", "tol"])
def test_solve_multigrid_q_warm_start_matches_jax(mode):
    """u0 on the quarter chain: split by to_quarters; fixed mode opens with
    the given-guess fused descent, tolerance mode checks the start first (no
    check-free burst), as JAX does."""
    h, w = 512, 520
    g = _rand((1, h, w), 50)
    u0 = np.asarray(JM.solve_multigrid(_j(g), padded="q", use_pallas=True, interpret=True,
                                       cycles=1))
    u0 = u0 + _rand(u0.shape, 51, 0.01 * np.abs(u0).max())
    kw = dict(cycles=2) if mode == "cycles" else dict(tol=1e-4)
    want, jinfo = JM.solve_multigrid(_j(g), u0=_j(u0), padded="q", use_pallas=True,
                                     interpret=True, return_info=True, **kw)
    got, info = TM.solve_multigrid(_t(g), u0=_t(u0), padded="q", use_pallas=True,
                                   return_info=True, **kw)
    assert info["cycles"] == int(jinfo["cycles"])
    assert _rel(got, want) <= (1e-5 if mode == "cycles" else 5e-5)
    if mode == "tol":
        assert info["cycles"] >= 1 and _rel_residual(got, g) <= 1e-4


@pytest.mark.parametrize("start", ["zero", "u0", "converged u0"])
def test_solve_multigrid_q_max_cycles_zero_and_converged_start(start):
    """max_cycles=0 returns the start (zeros or u0) with 0 cycles, as JAX;
    a warm start that already meets tol runs no cycle."""
    h, w = 512, 520
    g = _rand((1, h, w), 60)
    u0 = _rand((1, h, w), 61)
    kw = dict(tol=1e-4, max_cycles=0)
    if start == "converged u0":  # relative residual <= 0.05, asked for 0.1
        u0 = TM.solve_multigrid(_t(g), padded="q", use_pallas=True, tol=0.05).numpy()
        kw = dict(tol=0.1)
    if start != "zero":
        kw["u0"] = u0
    want, jinfo = JM.solve_multigrid(_j(g), padded="q", use_pallas=True, interpret=True,
                                     return_info=True,
                                     **{k: (_j(v) if k == "u0" else v) for k, v in kw.items()})
    got, info = TM.solve_multigrid(_t(g), padded="q", use_pallas=True, return_info=True,
                                   **{k: (_t(v) if k == "u0" else v) for k, v in kw.items()})
    assert info["cycles"] == int(jinfo["cycles"]) == 0
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), np.zeros_like(g) if start == "zero" else u0)


@pytest.mark.parametrize("chain, mode", [("t", "cycles"), ("t", "tol"), ("element", "cycles"),
                                         ("element", "tol")])
def test_warm_start_on_the_t_chain_and_element_path(chain, mode):
    """u0 needs no new kernel off the quarter chain: the "t" chain pads it
    into its slab, the element path starts from it; tolerance mode checks it
    first. Against JAX's interpreted solve."""
    shape = (1, 512, 520) if chain == "t" else (3, 200, 220)
    g = _rand(shape, 80)
    u0 = _rand(shape, 81, 0.05 * np.abs(g).max())
    kw = dict(cycles=2) if mode == "cycles" else dict(tol=1e-4)
    want, jinfo = JM.solve_multigrid(_j(g), u0=_j(u0), padded="t", use_pallas=True,
                                     interpret=True, return_info=True, **kw)
    got, info = TM.solve_multigrid(_t(g), u0=_t(u0), padded="t", use_pallas=True,
                                   return_info=True, **kw)
    assert info["cycles"] == int(jinfo["cycles"])
    assert _rel(got, want) <= 1e-5
    if mode == "tol":
        assert _rel_residual(got, g) <= 1e-4


def test_warm_start_shape_is_checked():
    with pytest.raises(ValueError, match="u0"):
        TM.solve_multigrid(torch.zeros((1, 512, 520)), u0=torch.zeros((1, 512, 519)),
                           padded="q", use_pallas=True)
