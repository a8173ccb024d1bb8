"""Runtime-domain geometric multigrid: the exact tight system inside a bucket.

Port of ``seamlesscloneoptimization_tpu/solvers/multigrid_dyn.py``. With
``CloneConfig(bbox_bucket=..., bucket_exact=True)`` the ROI is rounded up to
a bucket, but the solve is the tight bbox's own Poisson system: its
Dirichlet frame at the tight bbox's edge, the true (h, w) inside a padded
(Hp, Wp) grid. In the JAX package (h, w) are traced scalars and every
operator is a select on the padded grid, so one compiled program serves
every mask size in the bucket. Here sizes are host ints, so the levels
compute on their true-size (C, h, w) arrays; what stays of the padded shape
is the depth of the hierarchy, which follows the padded levels
(Hp' = (Hp - 1) // 2), not the true ones:

- a level recurses while its PADDED shape is not small (``_small`` with
  ``COARSEST = 5``) and ends in ``BOTTOM_SWEEPS`` red-black sweeps, not in an
  exact solve. A true size that reaches 0 on the way down gives an empty
  level, whose correction is exact zeros;
- the operator pieces are ``solvers/multigrid.py``'s beta-level ones, with
  the Shortley-Weller weights rounded in float32 as the JAX package rounds
  them from its traced betas, and the residual ``g - (nsum(u) - diag u)``;
  the transfers are the same module's, the lanes before the rows;
- a level of at least 2^18 true points (``FUSE_MIN``, with ``use_pallas``,
  nu1 <= 2, nu2 <= 4) runs ``multigrid.fused_level``: the ``mg_down`` and
  ``mg_up`` kernels on the exact-size level, the lane halves of the
  transfers in torch (so the rows are restricted before the lanes there).

The tolerance loop checks max |g - A u| > tol * max(max |g|, 1e-30) before
every cycle, with one host read per check and no check-free burst, as the
JAX package's while loop does. Cycles and checks count in
``solvers.multigrid.COUNTS``, as the other multigrid paths count them.
"""

from __future__ import annotations

import torch

from seamlesscloneoptimization_tpu_torch.solvers.jacobi import exceeds, read_residual
from seamlesscloneoptimization_tpu_torch.solvers.multigrid import (
    _coarsen,
    _cycle,
    _fused_level,
    _ops_b,
    _pad_to,
    _small,
    _sweeps_b,
    fused_level,
    prolong_bilinear,
    restrict_fw,
)

COARSEST = 5  # a padded level this small (or smaller) is the bottom
BOTTOM_SWEEPS = 16  # the bottom's red-black sweeps


def _residual_dyn(u: torch.Tensor, g: torch.Tensor, bh: float, bw: float) -> torch.Tensor:
    """g - A_beta u, the diagonal applied as a product (JAX's ``_residual_dyn``)."""
    _, h, w = u.shape
    nsum, _, diag = _ops_b(h, w, bh, bw, u.device, f32=True)
    return g - (nsum(u) - diag * u)


def vcycle_dyn(u: torch.Tensor | None, g: torch.Tensor, hp: int, wp: int, bh: float = 1.0,
               bw: float = 1.0, nu1: int = 1, nu2: int = 2,
               use_pallas: bool = True) -> torch.Tensor:
    """One V-cycle on the true-size (C, h, w) level g of a padded (hp, wp)
    level; ``u=None`` is a known-zero guess (every coarse level). Returns
    the level's (C, h, w) u."""
    _, h, w = g.shape
    if _small(hp, wp, COARSEST):
        u = torch.zeros_like(g) if u is None else u
        return _sweeps_b(u, g, BOTTOM_SWEEPS, bh, bw, f32=True)
    hpc, wpc = (hp - 1) // 2, (wp - 1) // 2

    def coarse(rc, bh_c, bw_c):
        return vcycle_dyn(None, rc, hpc, wpc, bh_c, bw_c, nu1, nu2, use_pallas)

    if _fused_level(h, w, nu1, nu2, use_pallas):
        return fused_level(u, g, nu1, nu2, bh, bw, u is None, coarse)
    u = _sweeps_b(torch.zeros_like(g) if u is None else u, g, nu1, bh, bw, f32=True)
    (hc, bh_c), (wc, bw_c) = _coarsen(h, bh), _coarsen(w, bw)
    if hc >= 1 and wc >= 1:  # else the coarse domain is empty: a zero correction
        rc = 4.0 * restrict_fw(_residual_dyn(u, g, bh, bw), bh, bw)
        u = u + prolong_bilinear(coarse(rc, bh_c, bw_c), h, w, bh, bw)
    return _sweeps_b(u, g, nu2, bh, bw, f32=True)


def solve_dyn_window(g: torch.Tensor, padded_hw: tuple[int, int], tol: float = 1e-4,
                     cycles: int | None = None, max_cycles: int = 60, nu1: int = 1,
                     nu2: int = 2, return_info: bool = False, use_pallas: bool = True):
    """``solve_multigrid_dyn`` on the true-size RHS: g is (C, h, w), the
    hierarchy's depth follows ``padded_hw`` = (Hp, Wp) >= (h, w). Returns
    the (C, h, w) u, with ``return_info`` also {"cycles", "residual"}."""
    _, h, w = g.shape
    hp, wp = (int(x) for x in padded_hw)
    if h > hp or w > wp:
        raise ValueError(f"true size {(h, w)} exceeds the padded {(hp, wp)}")
    tol = float(tol)
    u, it = None, 0
    r = g  # the residual of the zero start
    if h > 0 and w > 0:
        if cycles is not None:
            for _ in range(int(cycles)):
                with _cycle():
                    u = vcycle_dyn(u, g, hp, wp, nu1=nu1, nu2=nu2, use_pallas=use_pallas)
            it = int(cycles)
            if return_info and it:
                r = _residual_dyn(u, g, 1.0, 1.0)
        else:
            thresh = tol * torch.clamp(g.abs().max(), min=1e-30)
            # checked before every cycle; one host read per check
            while it < max_cycles and exceeds(r.abs().max(), thresh):
                with _cycle():
                    u = vcycle_dyn(u, g, hp, wp, nu1=nu1, nu2=nu2, use_pallas=use_pallas)
                it += 1
                r = _residual_dyn(u, g, 1.0, 1.0)
    if u is None:
        u = torch.zeros_like(g)
    if return_info:
        return u, {"cycles": it,
                   "residual": read_residual(r.abs().max()) if r.numel() else 0.0}
    return u


def solve_multigrid_dyn(g: torch.Tensor, hw, tol: float = 1e-4, cycles: int | None = None,
                        max_cycles: int = 60, nu1: int = 1, nu2: int = 2,
                        return_info: bool = False, use_pallas: bool = True):
    """Solve the 5-point Dirichlet system on a runtime (h, w) domain.

    g: (C, Hp, Wp) f32, the RHS of the (h, w) interior system at [0, h) x
    [0, w); anything outside is ignored. hw = (h, w) with h <= Hp, w <= Wp.
    Returns (C, Hp, Wp) with the solution inside and exact zeros outside;
    ``return_info`` adds {"cycles": int, "residual": max |g - A u|}.
    ``cycles=k``: k V-cycles, no checks; else V-cycles while the residual
    exceeds tol * max |g|, up to ``max_cycles``.
    """
    _, hp, wp = g.shape
    h, w = (max(int(x), 0) for x in hw)
    res = solve_dyn_window(g[:, :h, :w], (hp, wp), tol, cycles, max_cycles, nu1, nu2,
                           return_info, use_pallas)
    u, info = res if return_info else (res, None)
    out = _pad_to(u, g.shape)
    return (out, info) if return_info else out
