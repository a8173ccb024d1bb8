"""The port's red-black solver against the JAX package on the CPU: the
``rb_sweeps`` twin against ``rb_sweeps_pallas`` run with ``interpret=True``,
``solve_redblack`` against JAX's, and the multigrid element path whose fine
level bursts through ``rb_sweeps`` (nu2 = 6, beyond the fused chains' nu2 <= 4).

Tolerances: the sweeps are a subtract, a multiply by 0.25 and a select, with
the neighbour sum in the same order on both sides: no multiply-add pair to
contract, so the twin is bit-exact against the Pallas kernel and the
solver's iterate against JAX's; only the residual check may differ by an ulp,
so the solves are held to max |du| <= 1e-6 max |u| with equal iteration
counts. The element-path multigrid differs by the coarsest level's GEMM
summation order: rel 1e-5, equal cycles. Inputs are numpy-seeded.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seamlesscloneoptimization_tpu.ops import pallas_kernels as PK
from seamlesscloneoptimization_tpu.solvers import jacobi as JJ
from seamlesscloneoptimization_tpu.solvers import multigrid as JM
from seamlesscloneoptimization_tpu_torch.ops import kernels as K
from seamlesscloneoptimization_tpu_torch.solvers import jacobi as TJ
from seamlesscloneoptimization_tpu_torch.solvers import multigrid as TM

# Several pytest-xdist workers share the cores: one intra-op thread each keeps
# torch's OpenMP pools from oversubscribing them (it cut this suite's CPU time
# about 3.5x). Results do not depend on it.
torch.set_num_threads(1)


def _rand(shape, seed, scale=50.0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32) * scale


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("k", [1, 4, 6])
@pytest.mark.parametrize("shape", [(2, 30, 61), (1, 16, 128)])
def test_rb_sweeps_plain_matches_pallas(shape, k):
    """Bit-exact against the Pallas kernel (ceil(k / 4) strip launches); the
    wrapper on a CPU tensor runs the twin and counts no launch."""
    u, g = _rand(shape, k, 10.0), _rand(shape, k + 1)
    want = np.asarray(PK.rb_sweeps_pallas(jnp.asarray(u), jnp.asarray(g), k, interpret=True))
    got = K.rb_sweeps_plain(_t(u), _t(g), k)
    np.testing.assert_array_equal(got.numpy(), want)
    K.reset_launches()
    assert torch.equal(K.rb_sweeps(_t(u), _t(g), k), got)
    assert K.LAUNCHES["rb_sweeps"] == 0


def test_rb_sweeps_validates_inputs():
    u = torch.zeros((2, 30, 61))
    assert K.rb_sweeps(u, u, 0) is u
    for bad in (lambda: K.rb_sweeps(u, u, -1),
                lambda: K.rb_sweeps(u, torch.zeros((2, 30, 60)), 2),
                lambda: K.rb_sweeps(u[:, :, ::2], u[:, :, ::2], 2)):
        with pytest.raises(ValueError):
            bad()
    with pytest.raises(TypeError):
        K.rb_sweeps(u.double(), u.double(), 2)


@functools.lru_cache(maxsize=None)
def _jax_redblack(seed, warm, tol, max_iters):
    """JAX's solve_redblack on the (3, 40, 56) RHS of ``seed``, from zero or
    from a warm start, with its info."""
    g = _rand((3, 40, 56), seed)
    u0 = _rand(g.shape, seed + 1, 5.0) if warm else None
    u, info = JJ.solve_redblack(jnp.asarray(g), None if u0 is None else jnp.asarray(u0),
                                tol=tol, max_iters=max_iters, return_info=True)
    return g, u0, np.asarray(u), int(info["iterations"]), float(info["residual"])


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("warm", [False, True])
def test_solve_redblack_matches_jax(warm, use_pallas):
    """tol 1e-5, max_iters 20000 (tests/test_solvers.py's setting): equal
    iterations, the iterate within 1e-6 of max |u|, the residual within tol;
    ``use_pallas`` on the CPU runs the same plain sweeps through the wrapper."""
    g, u0, want, iters, _ = _jax_redblack(1, warm, 1e-5, 20000)
    got, info = TJ.solve_redblack(_t(g), None if u0 is None else _t(u0), tol=1e-5,
                                  max_iters=20000, return_info=True, use_pallas=use_pallas)
    assert info["iterations"] == iters and iters % 50 == 0 and 0 < iters < 20000
    assert np.abs(got.numpy() - want).max() <= 1e-6 * np.abs(want).max()
    assert info["residual"] <= 1e-5 * np.abs(g).max()
    assert info["residual"] == pytest.approx(TJ.residual(got, _t(g)).abs().max().item())


def test_solve_redblack_stops_at_max_iters():
    """A cap below convergence: whole bursts, the same count and iterate as
    JAX (tol 1e-9 is out of reach in 300 sweeps)."""
    g, _, want, iters, res = _jax_redblack(2, False, 1e-9, 300)
    got, info = TJ.solve_redblack(_t(g), tol=1e-9, max_iters=300, return_info=True)
    assert info["iterations"] == iters == 300
    assert np.abs(got.numpy() - want).max() <= 1e-6 * np.abs(want).max()
    assert info["residual"] == pytest.approx(res, rel=1e-5)
    # check_every need not divide max_iters: the last burst runs whole
    _, info = TJ.solve_redblack(_t(g), tol=1e-9, max_iters=120, check_every=50,
                                return_info=True)
    assert info["iterations"] == 150


def test_solve_redblack_rejects_bad_arguments():
    g = torch.zeros((1, 8, 8))
    with pytest.raises(ValueError, match="check_every"):
        TJ.solve_redblack(g, check_every=0)
    with pytest.raises(ValueError, match="u0"):
        TJ.solve_redblack(g, u0=torch.zeros((1, 8, 7)))
    u = TJ.solve_redblack(g, return_info=False)  # a zero RHS is solved by zero
    assert not u.any()


@pytest.mark.parametrize("mode", ["cycles", "tol"])
def test_element_path_sweeps_match_jax(mode, monkeypatch):
    """solve_multigrid(nu2=6, use_pallas=True) on (1, 512, 520): the fused
    chains refuse nu2 > 4, so the element V-cycles run, and the fine level's
    6-sweep ascent is one rb_sweeps burst (2 launches: ceil(6 / 4)); the
    coarse levels are below the 2^18 gate. Against JAX's interpreted solve,
    rel 1e-5 and equal cycles; a CPU rehearsal counts the launches."""
    g = _rand((1, 512, 520), 9)
    kw = dict(cycles=2) if mode == "cycles" else dict(tol=1e-4, return_info=True)
    want = JM.solve_multigrid(jnp.asarray(g), nu2=6, use_pallas=True, interpret=True, **kw)
    launches = []
    orig = K.rb_sweeps_plain

    def counted(u, g_, n):
        launches.append(-(-n // K.RB_SWEEPS_PER_LAUNCH))
        return orig(u, g_, n)

    monkeypatch.setattr(K, "rb_sweeps_plain", counted)
    got = TM.solve_multigrid(_t(g), nu2=6, use_pallas=True, **kw)
    if mode == "tol":
        (want, jinfo), (got, info) = want, got
        assert info["cycles"] == int(jinfo["cycles"]) >= 2
        assert info["residual"] <= 1e-4 * np.abs(g).max()
        cycles = info["cycles"]
    else:
        cycles = 2
    want = np.asarray(want)
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()
    assert launches == [2] * cycles
    assert not TM.quarter_path_applies(512, 520, 1, 6)
