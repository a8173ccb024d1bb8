"""The port's runtime-domain multigrid (``solvers/multigrid_dyn.py``) against
the JAX package's on the CPU.

The transfers that the port's dyn levels share with its element path
against JAX's select-form ``_restrict_axis_dyn`` / ``_restrict_rows_dyn`` /
``_prolong_axis_dyn`` / ``_prolong_rows_dyn`` at every parity (as
tests/test_solvers.py holds JAX's own to its static operators);
``solve_multigrid_dyn`` against JAX's at fixed cycles (relative 1e-5) and
at a tolerance (relative 5e-5, equal cycles), with garbage outside the
domain and true sides far below the padded ones, whose hierarchy follows
the padded shape; and one grid of at least 2^18 points, whose fine level
runs the ``mg_down`` / ``mg_up`` twins. Each JAX solve is computed once
per module (one compile per padded shape and mode).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seamlesscloneoptimization_tpu.solvers import multigrid_dyn as JD
from seamlesscloneoptimization_tpu_torch.ops import kernels as K
from seamlesscloneoptimization_tpu_torch.solvers import multigrid as TM
from seamlesscloneoptimization_tpu_torch.solvers import solve_multigrid_dyn
from seamlesscloneoptimization_tpu_torch.solvers.multigrid_dyn import solve_dyn_window

# Several pytest-xdist workers share the cores: one intra-op thread each.
torch.set_num_threads(1)

NP = 70  # the transfers' padded length


@pytest.mark.parametrize("n", [3, 4, 5, 17, 31, 32, 63, 64])
@pytest.mark.parametrize("beta", [1.0, 0.8, 1.37])
@pytest.mark.parametrize("op", ["restrict_axis", "restrict_rows", "prolong_axis",
                                "prolong_rows"])
def test_transfers_match_jax_dyn(op, n, beta):
    """The port's exact-size transfer on the true n lines against JAX's on
    the padded NP: equal where JAX's is live, JAX's zero beyond (JAX takes
    beta as a float32 scalar, the port as a Python float)."""
    rng = np.random.default_rng(n)
    nc = (n - 1) // 2
    nj, bj = jnp.int32(n), jnp.float32(beta)
    rows = op.endswith("rows")
    if op.startswith("restrict"):
        x = np.zeros((2, 5, NP), np.float32)
        x[..., :n] = rng.normal(size=(2, 5, n)).astype(np.float32)
        live, want_len = n, nc
    else:
        x = np.zeros((2, 5, (NP - 1) // 2), np.float32)
        x[..., :nc] = rng.normal(size=(2, 5, nc)).astype(np.float32)
        live, want_len = nc, n
    if rows:
        x = np.swapaxes(x, -1, -2).copy()
    jax_fn = {"restrict_axis": lambda a: JD._restrict_axis_dyn(a, nj, bj),
              "restrict_rows": lambda a: JD._restrict_rows_dyn(a, nj, bj),
              "prolong_axis": lambda a: JD._prolong_axis_dyn(a, NP, nj, bj),
              "prolong_rows": lambda a: JD._prolong_rows_dyn(a, NP, nj, bj)}[op]
    port_fn = {"restrict_axis": lambda a: TM._restrict_axis(a, beta),
               "restrict_rows": lambda a: TM._restrict_rows(a, beta),
               "prolong_axis": lambda a: TM._prolong_axis(a, n, beta),
               "prolong_rows": lambda a: TM._prolong_rows(a, n, beta)}[op]
    want = np.asarray(jax_fn(jnp.asarray(x)))
    got = port_fn(torch.from_numpy(x[:, :live] if rows else x[..., :live])).numpy()
    if rows:
        want, got = np.swapaxes(want, -1, -2), np.swapaxes(got, -1, -2)
    assert got.shape[-1] == want_len
    np.testing.assert_allclose(got, want[..., :want_len], rtol=0, atol=2e-6)
    assert np.abs(want[..., want_len:]).max() == 0.0


# (padded shape, true (h, w)) of the solve cases; g is random everywhere,
# so everything outside the domain is garbage the solve must ignore
SOLVE_CASES = [
    ((3, 126, 126), (100, 90)),
    ((3, 126, 126), (126, 126)),
    ((3, 126, 126), (5, 126)),  # one side far below the padded one
    ((3, 126, 126), (126, 3)),
    ((3, 126, 126), (61, 2)),   # the coarse domain is empty from the first level
    ((3, 126, 126), (1, 1)),
    ((3, 70, 130), (70, 130)),  # unequal padded sides: a hierarchy of its own
    ((3, 70, 130), (33, 97)),
]
MODES = {"cycles=2": dict(cycles=2), "tol=2e-5": dict(tol=2e-5)}


def _rhs(shape, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=shape).astype(np.float32) * 50


@functools.lru_cache(maxsize=None)
def _jax_solve(case: int, mode: str):
    shape, hw = SOLVE_CASES[case]
    u, info = JD.solve_multigrid_dyn(jnp.asarray(_rhs(shape, case)), hw, return_info=True,
                                     **MODES[mode])
    return np.asarray(u), int(info["cycles"]), float(info["residual"])


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("case", range(len(SOLVE_CASES)))
def test_solve_matches_jax(case, mode):
    """Relative 1e-5 at fixed cycles, 5e-5 with equal cycles at a tolerance;
    exact zeros outside the domain; the residual JAX reports."""
    shape, (h, w) = SOLVE_CASES[case]
    want, cycles, res = _jax_solve(case, mode)
    got, info = solve_multigrid_dyn(torch.from_numpy(_rhs(shape, case)), (h, w),
                                    return_info=True, **MODES[mode])
    got = got.numpy()
    assert got.shape == shape
    assert info["cycles"] == cycles
    scale = max(np.abs(want).max(), 1e-30)
    bar = 1e-5 if mode == "cycles=2" else 5e-5
    assert np.abs(got - want).max() <= bar * scale
    assert np.abs(got[:, h:]).max(initial=0.0) == 0.0
    assert np.abs(got[:, :, w:]).max(initial=0.0) == 0.0
    gmax = np.abs(_rhs(shape, case)[:, :h, :w]).max(initial=0.0)
    assert abs(info["residual"] - res) <= 1e-6 * gmax


@functools.lru_cache(maxsize=None)
def _jax_big():
    g = _rhs((1, 522, 530), 99)
    u = JD.solve_multigrid_dyn(jnp.asarray(g), (520, 524), cycles=2)
    return g, np.asarray(u)


def test_fused_level_twins_match_jax(monkeypatch):
    """A 520 x 524 domain in a 522 x 530 grid (272 480 points, >= 2^18): the
    fine level is the fused one, mg_down and mg_up once a cycle (their
    twins on the CPU); JAX's answer to relative 1e-5."""
    calls = {"mg_down": 0, "mg_up": 0}
    for name in calls:
        orig = getattr(K, f"{name}_plain")

        def counted(*a, _orig=orig, _name=name, **k):
            calls[_name] += 1
            return _orig(*a, **k)

        monkeypatch.setattr(K, f"{name}_plain", counted)
    g, want = _jax_big()
    got = solve_multigrid_dyn(torch.from_numpy(g), (520, 524), cycles=2).numpy()
    assert calls == {"mg_down": 2, "mg_up": 2}
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    assert np.abs(got[:, 520:]).max() == 0.0 and np.abs(got[:, :, 524:]).max() == 0.0
    # use_pallas=False: the element levels all the way down, the same answer
    plain = solve_multigrid_dyn(torch.from_numpy(g), (520, 524), cycles=2,
                                use_pallas=False).numpy()
    assert calls == {"mg_down": 2, "mg_up": 2}
    assert np.abs(plain - want).max() <= 1e-5 * np.abs(want).max()


def test_window_solve_is_the_padded_solve_cropped():
    """solve_dyn_window on the true-size RHS (clone_roi_dyn's entry) is
    solve_multigrid_dyn on the padded grid, cropped, bit for bit; the
    hierarchy follows the padded shape, so another padded shape gives
    another answer; invalid sizes raise."""
    g = torch.from_numpy(_rhs((3, 126, 126), 5))
    full, info = solve_multigrid_dyn(g, (40, 50), tol=1e-5, return_info=True)
    win, winfo = solve_dyn_window(g[:, :40, :50], (126, 126), tol=1e-5, return_info=True)
    assert torch.equal(full[:, :40, :50], win) and info == winfo
    other = solve_dyn_window(g[:, :40, :50], (60, 60), cycles=1)
    assert not torch.equal(other, solve_dyn_window(g[:, :40, :50], (126, 126), cycles=1))
    with pytest.raises(ValueError, match="exceeds"):
        solve_dyn_window(g, (100, 126))
    assert not solve_multigrid_dyn(g, (0, 50)).abs().max().item()
