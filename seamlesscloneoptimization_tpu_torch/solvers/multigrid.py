"""Geometric multigrid V-cycles for the 5-point Dirichlet Laplacian.

Port of ``seamlesscloneoptimization_tpu/solvers/multigrid.py`` for
``padded="q"`` (the quarter-plane finest level), ``padded="t"`` (the
transpose-fused chain) and the element path.

Scheme (vertex-centred, unscaled operators, boundary-consistent hierarchy):
red-black Gauss-Seidel smoothing; separable full-weighting restriction to
the odd fine points, coarse size (n-1)//2, the coarse RHS scaled by 4;
bilinear prolongation, its transpose. Every level tracks a boundary-gap
parameter beta per axis (``_coarsen``): the right / bottom wall sits
beta * h beyond the last line, and the coarse operator, smoother and the
edge transfer weights use the Shortley-Weller coefficients of that gap,
which keeps the contraction near 0.1 per cycle at every size. The coarsest
level is solved exactly in the beta-modified separable eigenbasis
(``dst_gemm.solve_sep_eig``: four FP32 GEMMs).

Four chains:

- the quarter-plane chain (``padded="q"``, the default, fine grids with
  ``use_pallas``): the finest level lives as four quarter planes (C, 4, hq,
  wq2) (``ops/kernels.py:mg_geometry_q``), the RHS born so by the pipeline
  (``preprocess_rhs_q``) or split by ``to_quarters`` from a dense g, the
  result interleaved back by ``from_quarters`` unless the caller takes the
  planes. One launch per cycle boundary, ``mg_ud_q``: cycle k's ascent and
  cycle k+1's descent, with the transposed restriction into the coarse RHS
  fused in; ``mg_down_q`` opens the solve and ``mg_up_q`` closes a
  fixed-cycle one. The coarse levels are ``vcycle_t``'s, whose correction
  ``mg_prolong_tq`` splits back into the even / odd column planes. In
  tolerance mode the boundary launch also returns the residual max of the
  state it writes, so a check costs one host read. Where no check-free
  cycle comes first (tol >= 0.0225, a warm start) the check-first loop runs
  ``vcycle_q``, the unfused cycle: the split ``mg_down_q``,
  ``mg_restrict_tq``, the coarse levels, ``mg_up_q`` with its residual.
- ``vcycle_t`` (``padded="t"``, fine grids with ``use_pallas``): every
  level lives in a zero-padded slab (``ops/kernels.py:mg_geometry_t``) and
  runs as two kernels, ``mg_down_t`` (sweeps + residual + row restriction
  + the lane restriction, emitted transposed) and ``mg_up_t`` (the lane
  prolongation of the transposed correction + row prolongation +
  correction + sweeps), so each coarser level lives transposed (the
  operator is symmetric under transposition with bh and bw swapped).
  Levels below 2^16 points solve exactly with ``solve_sep_eig``.
- ``vcycle_p`` (``padded=True``, and ``"q"`` where the quarter gate fails:
  nu1 = 0), the dense rounded chain: every fused level lives in the
  zero-padded slab of ``ops/kernels.py:mg_geometry`` and runs ``mg_down``
  and ``mg_up`` on it, the lane halves of the transfers in torch on the
  cropped half-height arrays; a level below 2^18 points runs ``vcycle``
  on its interior. The solve pads once on the way in and crops once out.
- ``vcycle`` (the element path: small grids, ``use_pallas=False``, or
  ``padded=False``): PyTorch sweeps and transfers on exact-size arrays, as
  XLA ran them, except that a level of at least 2^18 points with
  ``use_pallas`` is the fused level: ``mg_down`` and ``mg_up`` on the level
  padded to an even height, the lane halves of the transfers in torch.

``solve_multigrid`` drives each, in tolerance mode (check-free burst,
then a residual check per further cycle) or fixed-work mode (``cycles``),
from zero, from a warm start ``u0`` or from the full-multigrid cascade
``fmg`` (``fmg_start``); ``pcg`` wraps the element V-cycle as the
preconditioner of a flexible CG. The tolerance check reads max |residual|
to the host once per check. On the element path a fine level's burst of
sweeps (``use_pallas``, n > 1, >= 2^18 points: smoothing that the fused
chains refuse, nu1 > 2 or nu2 > 4) is the ``rb_sweeps`` kernel. The JAX
package's ``SCL_MG_*`` environment knobs are constants here.

``COUNTS`` (``solvers/jacobi.py``'s dict) counts every V-cycle of a solve,
fixed or tolerance mode, on every chain and as pcg's preconditioner (not
``fmg``'s cascade, a start), each enqueued in a ``solver.cycle`` span, and
every host read of a residual (``"checks"``). On the quarter chain a cycle
is one ascent: an ``mg_ud_q``, or the closing ``mg_up_q``, or a check-first
``vcycle_q``, so ``"cycles"`` equals ``return_info``'s count.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from seamlesscloneoptimization_tpu_torch.core.trace import span
from seamlesscloneoptimization_tpu_torch.ops import kernels as K
from seamlesscloneoptimization_tpu_torch.solvers.dst_gemm import sep_eig_basis, solve_sep_eig
from seamlesscloneoptimization_tpu_torch.solvers.jacobi import (
    COUNTS,
    checkerboard,
    exceeds,
    read_residual,
    redblack_sweep,
    residual,
)

FUSE_MIN = 1 << 18    # a fine level runs fused from this many points
FUSE_MIN_T = 1 << 16  # vcycle_t's coarse levels run fused from this many


def _cycle():
    """Count one V-cycle and return the span of its enqueue."""
    COUNTS["cycles"] += 1
    return span("solver.cycle")


def _coarsen(m: int, beta: float) -> tuple[int, float]:
    """Coarse size and boundary-gap parameter of one axis: mc = (m-1)//2
    (the odd fine points), gap (m - 2 mc + beta) / 2 coarse spacings."""
    mc = (m - 1) // 2
    return mc, (m - 2 * mc + beta) / 2.0


def _restrict_axis(r: torch.Tensor, beta: float = 1.0) -> torch.Tensor:
    """1-D full weighting along the last axis: (..., n) -> (..., (n-1)//2),
    out[j] = r[2j]/4 + r[2j+1]/2 + r[2j+2]/4; for even n the last coarse
    point is the transpose of the beta-gap edge prolongation."""
    n = r.shape[-1]
    nc = (n - 1) // 2
    m = 2 * nc + 2
    rp = F.pad(r, (0, m - n)) if m != n else r
    pairs = rp.reshape(r.shape[:-1] + (nc + 1, 2))
    a, b = pairs[..., 0], pairs[..., 1]
    out = 0.25 * a[..., :nc] + 0.5 * b[..., :nc] + 0.25 * a[..., 1 : nc + 1]
    if n % 2 == 0:
        gap = 2.0 + beta
        edge = (0.25 * a[..., nc - 1] + 0.5 * b[..., nc - 1]
                + ((1.0 + beta) / gap * 0.5) * a[..., nc] + (beta / gap * 0.5) * b[..., nc])
        out = torch.cat([out[..., : nc - 1], edge[..., None]], dim=-1)
    return out


def _restrict_rows(r: torch.Tensor, beta: float = 1.0) -> torch.Tensor:
    """The same 1-D full weighting along axis -2."""
    n = r.shape[-2]
    nc = (n - 1) // 2
    out = (0.25 * r[..., 0 : 2 * nc - 1 : 2, :] + 0.5 * r[..., 1 : 2 * nc : 2, :]
           + 0.25 * r[..., 2 : 2 * nc + 1 : 2, :])
    if n % 2 == 0:
        gap = 2.0 + beta
        edge = (0.25 * r[..., n - 4, :] + 0.5 * r[..., n - 3, :]
                + ((1.0 + beta) / gap * 0.5) * r[..., n - 2, :]
                + (beta / gap * 0.5) * r[..., n - 1, :])
        out = torch.cat([out[..., : nc - 1, :], edge[..., None, :]], dim=-2)
    return out


def restrict_fw(r: torch.Tensor, bh: float = 1.0, bw: float = 1.0) -> torch.Tensor:
    """Full-weighting restriction (C, h, w) -> (C, (h-1)//2, (w-1)//2):
    columns, then rows (1/4 of the transpose of ``prolong_bilinear``)."""
    return _restrict_rows(_restrict_axis(r, bw), bh)


def _prolong_axis(e: torch.Tensor, n: int, beta: float = 1.0) -> torch.Tensor:
    """Bilinear prolongation along the last axis: (..., nc) -> (..., n).
    Fine 2j takes the mean of its coarse neighbours, fine 2j+1 coarse j; for
    even n the last two fine points take the beta-gap weights of the last
    coarse point."""
    nc = e.shape[-1]
    ep = F.pad(e, (1, 1))  # zero Dirichlet pad
    mids = 0.5 * (ep[..., : nc + 1] + ep[..., 1 : nc + 2])
    pairs = torch.stack([mids[..., :nc], e], dim=-1).reshape(e.shape[:-1] + (2 * nc,))
    if n % 2 == 1:
        return torch.cat([pairs, mids[..., nc:]], dim=-1)
    gap = 2.0 + beta
    last = e[..., nc - 1 :]
    return torch.cat([pairs[..., : n - 2], last * ((1.0 + beta) / gap),
                      last * (beta / gap)], dim=-1)


def _prolong_rows(e: torch.Tensor, n: int, beta: float = 1.0) -> torch.Tensor:
    """Bilinear prolongation along axis -2: (..., nc, w) -> (..., n, w)."""
    nc = e.shape[-2]
    ep = F.pad(e, (0, 0, 1, 1))
    mids = 0.5 * (ep[..., : nc + 1, :] + ep[..., 1 : nc + 2, :])
    pairs = torch.stack([mids[..., :nc, :], e], dim=-2).reshape(
        e.shape[:-2] + (2 * nc,) + e.shape[-1:])
    if n % 2 == 1:
        return torch.cat([pairs, mids[..., nc:, :]], dim=-2)
    gap = 2.0 + beta
    last = e[..., nc - 1 :, :]
    return torch.cat([pairs[..., : n - 2, :], last * ((1.0 + beta) / gap),
                      last * (beta / gap)], dim=-2)


def prolong_bilinear(e: torch.Tensor, h: int, w: int,
                     bh: float = 1.0, bw: float = 1.0) -> torch.Tensor:
    """Bilinear prolongation (C, hc, wc) -> (C, h, w): columns, then rows."""
    return _prolong_rows(_prolong_axis(e, w, bw), h, bh)


def _edge_weight(beta: float, f32: bool = False) -> float:
    """2 / (1 + beta) - 1: the Shortley-Weller weight of a last line's
    up / left neighbour, less the bulk weight 1. ``f32``: computed in float32
    a step at a time, as the JAX package's runtime-domain operators compute
    it from a traced beta (``multigrid_dyn``); else in float64, as its
    static operators do."""
    if not f32:
        return 2.0 / (1.0 + beta) - 1.0
    one = np.float32(1.0)
    return float(np.float32(2.0) / (one + np.float32(beta)) - one)


def _ops_b(h: int, w: int, bh: float, bw: float, device, f32: bool = False,
           origin: tuple[int, int] = (0, 0), local_hw: tuple[int, int] | None = None):
    """Neighbour sum, inverse diagonal and diagonal of a beta-level operator:
    the 5-point stencil with the Shortley-Weller last row / column (up / left
    neighbour 2/(1+beta), diagonal half 2/beta). ``f32``: see
    ``_edge_weight``. ``origin`` / ``local_hw``: the operator on a (hl, wl)
    window of the (h, w) level whose (0, 0) is the level's ``origin`` (a
    ghosted tile of ``parallel/tiled.py:solve_multigrid_sharded``); the
    neighbour sum reads zeros past the window."""
    hl, wl = local_hw if local_hw is not None else (h, w)
    rows = origin[0] + torch.arange(hl, device=device)[:, None]
    cols = origin[1] + torch.arange(wl, device=device)[None, :]
    f32_ = torch.float32
    dh = torch.where(rows == h - 1, torch.tensor(2.0 / bh, dtype=f32_, device=device),
                     torch.tensor(2.0, dtype=f32_, device=device))
    dw = torch.where(cols == w - 1, torch.tensor(2.0 / bw, dtype=f32_, device=device),
                     torch.tensor(2.0, dtype=f32_, device=device))
    diag = (dh + dw)[None]
    inv_d = 1.0 / diag
    lrow = (rows == h - 1).to(f32_)[None] * _edge_weight(bh, f32)
    lcol = (cols == w - 1).to(f32_)[None] * _edge_weight(bw, f32)

    def nsum(x):
        xp = F.pad(x, (1, 1, 1, 1))
        up, dn = xp[:, :-2, 1:-1], xp[:, 2:, 1:-1]
        lf, rt = xp[:, 1:-1, :-2], xp[:, 1:-1, 2:]
        return up + dn + lf + rt + lrow * up + lcol * lf

    return nsum, inv_d, diag


def _sweeps_b(u: torch.Tensor, g: torch.Tensor, n: int, bh: float, bw: float,
              f32: bool = False) -> torch.Tensor:
    """n red-black sweeps of the beta-level operator (small coarse grids)."""
    _, h, w = u.shape
    nsum, inv_d, _ = _ops_b(h, w, bh, bw, u.device, f32)
    red = checkerboard(h, w, u.device)[None]
    for _ in range(n):
        u = torch.where(red, (nsum(u) - g) * inv_d, u)
        u = torch.where(red, u, (nsum(u) - g) * inv_d)
    return u


def _residual_b(u: torch.Tensor, g: torch.Tensor, bh: float, bw: float) -> torch.Tensor:
    """g - A_beta u for the beta-level operator."""
    _, h, w = u.shape
    nsum, inv_d, _ = _ops_b(h, w, bh, bw, u.device)
    return g - (nsum(u) - u / inv_d)


def _sweeps(u: torch.Tensor, g: torch.Tensor, n: int, use_pallas: bool = False) -> torch.Tensor:
    """n red-black sweeps. A fine burst (``use_pallas``, n > 1, >= 2^18
    points) goes through ``K.rb_sweeps`` (the kernel on the card, ceil(n/4)
    launches; its plain twin on the CPU), as the JAX package sends it
    through its rb_sweeps kernel."""
    if use_pallas and n > 1 and u.shape[-1] * u.shape[-2] >= FUSE_MIN:
        return K.rb_sweeps(u.contiguous(), g.contiguous(), n)
    for _ in range(n):
        u = redblack_sweep(u, g)
    return u


def _fused_level(h: int, w: int, nu1: int, nu2: int, use_pallas: bool,
                 fuse_min: int = FUSE_MIN) -> bool:
    """Whether this level runs as the fused level kernels."""
    return bool(use_pallas) and h * w >= fuse_min and nu1 <= 2 and nu2 <= 4


def _small(h: int, w: int, coarsest: int) -> bool:
    return min(h, w) <= coarsest or min((h - 1) // 2, (w - 1) // 2) < 1


def t_chain_applies(h: int, w: int, nu1: int = 1, nu2: int = 2, coarsest: int = 63,
                    use_pallas: bool = True) -> bool:
    """Whether ``solve_multigrid(padded="t")`` runs ``vcycle_t`` on an (h, w)
    grid: the one gate shared with the pipeline, which then makes the RHS
    in the fine level's slab."""
    return not _small(h, w, coarsest) and _fused_level(h, w, nu1, nu2, use_pallas)


def quarter_path_applies(h: int, w: int, nu1: int = 1, nu2: int = 2, coarsest: int = 63,
                         use_pallas: bool = True) -> bool:
    """Whether ``solve_multigrid(padded="q")`` runs the quarter-plane chain on
    an (h, w) grid: the one gate shared with the pipeline, which then makes
    the RHS as quarter planes. The quarter descent restricts the red cells'
    residual only, exact after a black half-sweep: nu1 >= 1."""
    return nu1 >= 1 and t_chain_applies(h, w, nu1, nu2, coarsest, use_pallas)


def _tol_burst(tol: float, max_cycles: int, nu1: int = 1, nu2: int = 2) -> int:
    """Check-free V-cycles before the first residual check (zero start).

    From a zero start the first checks cannot pass: assuming a conservative
    0.15 contraction per cycle, the first that can is after
    ceil(log tol / log 0.15) cycles; the burst runs two fewer. Halved for
    weaker smoothing (nu1 + nu2 < 3). The loop re-checks from wherever the
    burst lands, so the tolerance contract holds either way.
    """
    if not 0.0 < tol < 0.15:
        return 0
    pred = math.ceil(math.log(tol) / math.log(0.15))
    burst = max(0, min(max_cycles, pred - 2))
    if nu1 + nu2 < 3:
        burst //= 2
    return burst


def _pad_to(x: torch.Tensor, shape) -> torch.Tensor:
    return F.pad(x, (0, shape[-1] - x.shape[-1], 0, shape[-2] - x.shape[-2]))


def coarse_solve(g: torch.Tensor, bh: float, bw: float, eig_cache=None) -> torch.Tensor:
    """Exact solve of a coarsest level (``solve_sep_eig``). ``eig_cache``: a
    dict holding each geometry's device basis (the engine keeps one), or
    None."""
    bh, bw = round(bh, 9), round(bw, 9)
    if eig_cache is None:
        return solve_sep_eig(g, bh, bw)
    _, h, w = g.shape
    key = (h, w, bh, bw, str(g.device))
    basis = eig_cache.get(key)
    if basis is None:
        with span("solver.basis_build"):
            basis = sep_eig_basis(h, w, bh, bw, g.device)
        eig_cache[key] = basis
    return solve_sep_eig(g, bh, bw, basis=basis)


def fused_level(u: torch.Tensor | None, g: torch.Tensor, nu1: int, nu2: int, bh: float,
                bw: float, u_zero: bool, coarse) -> torch.Tensor:
    """One exact-size level as the fused level kernels, the JAX package's
    ``mg_down_pallas`` / ``mg_up_pallas`` on an exact-size level: u and g
    (C, h, w) padded to an even-height (C, h + h % 2, w) slab for
    ``K.mg_down`` (sweeps + residual + row restriction) and ``K.mg_up`` (row
    prolongation + correction + sweeps), the lane halves of the transfers in
    torch (``_restrict_axis``, ``_prolong_axis``). ``coarse(rc, bh_c,
    bw_c)`` returns the (C, hc, wc) correction of the coarse level whose RHS
    is rc. ``u_zero``: u is known zero, so the descent synthesizes the guess
    instead of reading it. Returns the level's (C, h, w) u."""
    c, h, w = g.shape
    hc, bh_c = _coarsen(h, bh)
    _, bw_c = _coarsen(w, bw)
    slab = (c, h + h % 2, w)  # the level kernels take an even-height slab
    g_p = _pad_to(g, slab).contiguous()
    u_p = None if u_zero else _pad_to(u, slab).contiguous()
    u_s, rh = K.mg_down(u_p, g_p, nu1, h, w, bh, bw)
    ec = coarse(4.0 * _restrict_axis(rh[:, :hc], bw), bh_c, bw_c)
    # rows [hc, h/2) of the lane-prolonged correction are zero to mg_up
    e_lane = _pad_to(_prolong_axis(ec, w, bw), (c, slab[1] // 2, w)).contiguous()
    return K.mg_up(u_s, g_p, e_lane, nu2, h, w, bh, bw)[:, :h, :w]


def vcycle(u: torch.Tensor, g: torch.Tensor, nu1: int = 2, nu2: int = 2, coarsest: int = 63,
           use_pallas: bool = False, bh: float = 1.0, bw: float = 1.0,
           eig_cache=None, u_zero: bool = False) -> torch.Tensor:
    """One V-cycle on exact-size (C, h, w) arrays (the element path).

    A level of at least 2^18 points with ``use_pallas`` (nu1 <= 2, nu2 <= 4)
    is the fused level (``fused_level``). ``u_zero``: u is known zero (every
    coarse level), so the fused descent synthesizes the guess instead of
    reading it.
    """
    c, h, w = g.shape
    if _small(h, w, coarsest):
        return coarse_solve(g, bh, bw, eig_cache)

    def coarse(rc, bh_c, bw_c):  # from a known-zero guess
        return vcycle(torch.zeros_like(rc), rc, nu1, nu2, coarsest, use_pallas, bh_c, bw_c,
                      eig_cache, u_zero=True)

    if _fused_level(h, w, nu1, nu2, use_pallas):
        return fused_level(u, g, nu1, nu2, bh, bw, u_zero, coarse)
    if bh == 1.0 and bw == 1.0:
        u = _sweeps(u, g, nu1, use_pallas)
        r = residual(u, g)
    else:
        u = _sweeps_b(u, g, nu1, bh, bw)
        r = _residual_b(u, g, bh, bw)
    (_, bh_c), (_, bw_c) = _coarsen(h, bh), _coarsen(w, bw)
    u = u + prolong_bilinear(coarse(4.0 * restrict_fw(r, bh, bw), bh_c, bw_c), h, w, bh, bw)
    if bh == 1.0 and bw == 1.0:
        return _sweeps(u, g, nu2, use_pallas)
    return _sweeps_b(u, g, nu2, bh, bw)


def vcycle_p(u_p: torch.Tensor | None, g_p: torch.Tensor, h: int, w: int, nu1: int = 1,
             nu2: int = 2, coarsest: int = 63, bh: float = 1.0, bw: float = 1.0,
             eig_cache=None) -> torch.Tensor:
    """One V-cycle in the dense rounded space (the JAX package's ``vcycle_p``).

    g_p, u_p: (C, hp, wp) per ``mg_geometry(h, w)``, the true (h, w) domain
    at the origin, exact zeros elsewhere; ``u_p=None`` is a known-zero guess
    (every coarse level). A fused level: ``mg_down`` on the slab -> the lane
    restriction of the cropped rh -> the coarse level in its own
    ``mg_geometry`` slab -> the lane prolongation, padded to (C, hp // 2,
    wp) -> ``mg_up``. A level below the fused gate runs ``vcycle`` on the
    cropped interior and pads back. Returns (C, hp, wp), exact zeros outside
    the domain.
    """
    c, hp, wp = g_p.shape
    if _small(h, w, coarsest) or not _fused_level(h, w, nu1, nu2, True):
        g = g_p[:, :h, :w]
        u = torch.zeros_like(g) if u_p is None else u_p[:, :h, :w]
        u = vcycle(u, g, nu1, nu2, coarsest, True, bh, bw, eig_cache, u_zero=u_p is None)
        return _pad_to(u, g_p.shape)
    hc, bh_c = _coarsen(h, bh)
    wc, bw_c = _coarsen(w, bw)
    u_s, rh = K.mg_down(u_p, g_p, nu1, h, w, bh, bw)
    rc = 4.0 * _restrict_axis(rh[:, :hc, :w], bw)
    _, hpc, wpc = K.mg_geometry(hc, wc)
    ec_p = vcycle_p(None, _pad_to(rc, (c, hpc, wpc)).contiguous(), hc, wc, nu1, nu2, coarsest,
                    bh_c, bw_c, eig_cache)
    e_lane = _pad_to(_prolong_axis(ec_p[:, :hc, :wc], w, bw), (c, hp // 2, wp)).contiguous()
    return K.mg_up(u_s, g_p, e_lane, nu2, h, w, bh, bw)


def fmg(g: torch.Tensor, nu1: int = 2, nu2: int = 2, coarsest: int = 63,
        use_pallas: bool = False, bh: float = 1.0, bw: float = 1.0,
        eig_cache=None) -> torch.Tensor:
    """Full multigrid: a near-converged start from the coarse-to-fine
    cascade. The RHS is restricted down the hierarchy (scaled by 4, as the
    residual equation is), the coarsest level solved exactly
    (``coarse_solve``), then each level's solution is prolonged to the next
    finer one and polished there by one element ``vcycle``."""
    _, h, w = g.shape
    if _small(h, w, coarsest):
        return coarse_solve(g, bh, bw, eig_cache)
    hc, bh_c = _coarsen(h, bh)
    wc, bw_c = _coarsen(w, bw)
    gc = 4.0 * restrict_fw(g, bh, bw)
    uc = fmg(gc, nu1, nu2, coarsest, use_pallas, bh_c, bw_c, eig_cache)
    u = prolong_bilinear(uc, h, w, bh, bw)
    return vcycle(u, g, nu1, nu2, coarsest, use_pallas, bh, bw, eig_cache)


def _small_t_level(u_p, g_p, h, w, nu1, nu2, coarsest, bh, bw, eig_cache) -> torch.Tensor:
    """A ``vcycle_t`` level below the fused gate, padded back to its slab.
    Only a coarse level lands here (solve_multigrid takes this chain when
    the fine level fuses), and it always starts from zero: the exact solve
    replaces the correction."""
    if u_p is None:
        u = coarse_solve(g_p[:, :h, :w], bh, bw, eig_cache)
    else:
        u = vcycle(u_p[:, :h, :w], g_p[:, :h, :w], nu1, nu2, coarsest, True, bh, bw, eig_cache)
    return _pad_to(u, g_p.shape)


def vcycle_t(u_p: torch.Tensor | None, g_p: torch.Tensor, h: int, w: int, nu1: int = 1,
             nu2: int = 2, coarsest: int = 63, bh: float = 1.0, bw: float = 1.0,
             geom: tuple[int, int, int, int] | None = None, eig_cache=None) -> torch.Tensor:
    """One V-cycle in alternating-orientation padded space.

    g_p, u_p: (C, hp, wp) per ``mg_geometry_t(h, w)`` (or ``geom``), the
    true (h, w) domain at the origin, exact zeros elsewhere; ``u_p=None`` is
    a known-zero guess (every coarse level). Per level: ``mg_down_t``
    (the JAX package's ``mg_down`` + ``mg_restrict_t`` in one launch) -> the
    transposed child level (logical (wc, hc), betas swapped, its width the
    parent's hp2) -> ``mg_up_t`` (``mg_prolong_t`` + ``mg_up``). A level
    below the fused gate solves exactly (``coarse_solve``). Returns (C, hp,
    wp) with the same zero invariant.
    """
    c = g_p.shape[0]
    th, hp, wp, hp2 = geom if geom is not None else K.mg_geometry_t(h, w)
    if _small(h, w, coarsest) or not _fused_level(h, w, nu1, nu2, True, FUSE_MIN_T):
        return _small_t_level(u_p, g_p, h, w, nu1, nu2, coarsest, bh, bw, eig_cache)
    hc, bh_c = _coarsen(h, bh)
    wc, bw_c = _coarsen(w, bw)
    cgeom = K.mg_geometry_t(wc, hc, wp_min=hp2)
    u_s, rc_t = K.mg_down_t(u_p, g_p, nu1, h, w, bh, bw, out_rows=cgeom[1])
    ec_t = vcycle_t(None, rc_t, wc, hc, nu1, nu2, coarsest, bw_c, bh_c, cgeom, eig_cache)
    return K.mg_up_t(u_s, g_p, ec_t, nu2, h, w, bh, bw)


def vcycle_t_unfused(u_p: torch.Tensor | None, g_p: torch.Tensor, h: int, w: int,
                     nu1: int = 1, nu2: int = 2, coarsest: int = 63, bh: float = 1.0,
                     bw: float = 1.0, geom: tuple[int, int, int, int] | None = None,
                     eig_cache=None) -> torch.Tensor:
    """``vcycle_t`` as the four kernels a level that ``mg_down_t`` /
    ``mg_up_t`` fold (``mg_down`` -> ``mg_restrict_t`` -> the child level ->
    ``mg_prolong_t`` -> ``mg_up``), the JAX package's chain: the same
    arithmetic, bit for bit. No solve runs it; it is the reference that the
    card checks (``tests/test_torch_cuda.py``, ``chip_smoke.py``) hold the
    fused chain against."""
    th, hp, wp, hp2 = geom if geom is not None else K.mg_geometry_t(h, w)
    if _small(h, w, coarsest) or not _fused_level(h, w, nu1, nu2, True, FUSE_MIN_T):
        return _small_t_level(u_p, g_p, h, w, nu1, nu2, coarsest, bh, bw, eig_cache)
    hc, bh_c = _coarsen(h, bh)
    wc, bw_c = _coarsen(w, bw)
    u_s, rh = K.mg_down(u_p, g_p, nu1, h, w, bh, bw, rh_rows=hp2)
    cgeom = K.mg_geometry_t(wc, hc, wp_min=hp2)
    rc_t = K.mg_restrict_t(rh, h, w, bw, out_rows=cgeom[1])
    ec_t = vcycle_t_unfused(None, rc_t, wc, hc, nu1, nu2, coarsest, bw_c, bh_c, cgeom,
                            eig_cache)
    e_lane = K.mg_prolong_t(ec_t, w, bw, out_rows=hp2, wp=wp)
    return K.mg_up(u_s, g_p, e_lane, nu2, h, w, bh, bw)


def _coarse_q(rc_t: torch.Tensor, h: int, w: int, nu1: int, nu2: int, coarsest: int,
              qgeom, cgeom, eig_cache) -> tuple[torch.Tensor, torch.Tensor]:
    """The coarse side of one quarter-plane V-cycle: ``vcycle_t`` on the
    transposed (wc, hc) level from the fused restriction's rc_t (a known-zero
    guess, betas swapped), then ``mg_prolong_tq`` back to the even / odd
    column planes that the next ascent adds."""
    hc, bh_c = _coarsen(h, 1.0)
    wc, bw_c = _coarsen(w, 1.0)
    ec_t = vcycle_t(None, rc_t, wc, hc, nu1, nu2, coarsest, bw_c, bh_c, cgeom, eig_cache)
    return K.mg_prolong_tq(ec_t, w, out_rows=qgeom[3], wq2=qgeom[2])


def _q_geoms(h: int, w: int):
    """(qgeom, cgeom): the quarter level's geometry and its first (transposed)
    coarse level's."""
    qgeom = K.mg_geometry_q(h, w)
    return qgeom, K.mg_geometry_t((w - 1) // 2, (h - 1) // 2, wp_min=qgeom[3])


def _t_levels_from(h, w, bh, bw, geom, nu1, nu2, coarsest) -> list[tuple]:
    """The fused levels ``vcycle_t`` runs from the level (h, w, bh, bw,
    geom) down, in descent order: (h, w, bh, bw, geom) per level, each the
    transposed child of the one before (logical (wc, hc), betas swapped,
    its slab per ``geom = (th, hp, wp, hp2)``)."""
    levels = []
    while not _small(h, w, coarsest) and _fused_level(h, w, nu1, nu2, True, FUSE_MIN_T):
        levels.append((h, w, bh, bw, geom))
        (hc, bh_c), (wc, bw_c) = _coarsen(h, bh), _coarsen(w, bw)
        h, w, bh, bw, geom = wc, hc, bw_c, bh_c, K.mg_geometry_t(wc, hc, wp_min=geom[3])
    return levels


def t_levels(h: int, w: int, nu1: int = 1, nu2: int = 2, coarsest: int = 63) -> list[tuple]:
    """The fused levels of a ``vcycle_t`` on an (h, w) fine level (the
    ``"t"`` chain), as ``q_coarse_levels`` lists them."""
    return _t_levels_from(h, w, 1.0, 1.0, K.mg_geometry_t(h, w), nu1, nu2, coarsest)


def p_levels(h: int, w: int, nu1: int = 1, nu2: int = 2, coarsest: int = 63) -> list[tuple]:
    """The fused levels of a ``vcycle_p`` on an (h, w) fine level (the dense
    rounded chain; the element ``vcycle`` fuses the same levels), in descent
    order: (h, w, bh, bw, geom) per level, its slab per ``geom = (th, hp,
    wp)`` of ``mg_geometry``."""
    levels, bh, bw = [], 1.0, 1.0
    while not _small(h, w, coarsest) and _fused_level(h, w, nu1, nu2, True):
        levels.append((h, w, bh, bw, K.mg_geometry(h, w)))
        (h, bh), (w, bw) = _coarsen(h, bh), _coarsen(w, bw)
    return levels


def q_coarse_levels(h: int, w: int, nu1: int = 1, nu2: int = 2,
                    coarsest: int = 63) -> list[tuple]:
    """The fused coarse levels that ``vcycle_t`` runs below an (h, w)
    quarter level, in descent order: (h, w, bh, bw, geom) per level, each
    the transposed child of the one before (logical (wc, hc), betas
    swapped, its slab per ``geom = (th, hp, wp, hp2)``)."""
    (hc, bh_c), (wc, bw_c) = _coarsen(h, 1.0), _coarsen(w, 1.0)
    return _t_levels_from(wc, hc, bw_c, bh_c, _q_geoms(h, w)[1], nu1, nu2, coarsest)


def vcycle_q(uq: torch.Tensor | None, gq: torch.Tensor, h: int, w: int, nu1: int = 1,
             nu2: int = 2, coarsest: int = 63, with_residual: bool = False,
             eig_cache=None):
    """One V-cycle with the finest level as quarter planes, unfused: the
    split ``mg_down_q`` -> ``mg_restrict_tq`` -> ``vcycle_t`` on the
    transposed coarse level -> ``mg_prolong_tq`` -> ``mg_up_q``.

    uq, gq: (C, 4, hq, wq2) per ``mg_geometry_q(h, w)``, exact zeros outside
    the domain; ``uq=None`` is a known-zero guess. Returns the swept uq, and
    with ``with_residual`` also max |g - A u| of it (a 0-dim device tensor),
    which the ascent computes on the fly.
    """
    qgeom, cgeom = _q_geoms(h, w)
    u, rh_e, rh_o = K.mg_down_q(uq, gq, nu1, h, w)
    rc_t = K.mg_restrict_tq(rh_e, rh_o, h, w, cgeom[1])
    e_even, e_odd = _coarse_q(rc_t, h, w, nu1, nu2, coarsest, qgeom, cgeom, eig_cache)
    return K.mg_up_q(u, gq, e_even, e_odd, nu2, h, w, with_residual=with_residual)


def _solve_q(g_q: torch.Tensor, h: int, w: int, nu1: int, nu2: int, coarsest: int,
             cycles: int | None, tol: float, max_cycles: int, uq0: torch.Tensor | None = None,
             rmax0: torch.Tensor | None = None, eig_cache=None) -> tuple[torch.Tensor, int]:
    """The quarter-plane solve from ``uq0`` (None: a zero start). Returns
    (uq, V-cycles run).

    Fixed mode: down -> (cycles-1) x [coarse -> ud] -> coarse -> up, every
    cycle boundary one ``mg_ud_q`` launch.
    Tolerance mode from a zero start with a check-free burst (``_tol_burst``
    >= 1): down -> (burst-1) x [coarse -> ud], then [coarse -> ud with the
    residual] while max |r| > thresh and fewer than ``max_cycles`` ascents;
    the result has already had the next descent's nu1 sweeps. With no burst
    (tol >= 0.0225, ``max_cycles`` 0, or a warm start) the check-first loop:
    while ``rmax0`` (max |g| from zero, else the caller's max |residual(u0)|)
    or the last ascent's max |r| exceeds thresh and fewer than ``max_cycles``
    cycles ran, one ``vcycle_q`` reporting its residual. Either way one host
    read per check, and the count is of completed ascents. The threshold is
    shaved, gnorm * min(tol * 0.995, tol - 4e-7), so that the in-kernel
    red-cell check implies the dense residual meets tol (the JAX package's
    rule).
    """
    qgeom, cgeom = _q_geoms(h, w)
    chp = cgeom[1]

    def coarse(rc_t):
        return _coarse_q(rc_t, h, w, nu1, nu2, coarsest, qgeom, cgeom, eig_cache)

    if cycles is not None:
        if cycles < 1:
            return (torch.zeros_like(g_q) if uq0 is None else uq0), 0
        u, rc_t = K.mg_down_q(uq0, g_q, nu1, h, w, chp)
        for _ in range(cycles - 1):
            with _cycle():
                u, rc_t = K.mg_ud_q(u, g_q, *coarse(rc_t), nu2, nu1, h, w, chp)
        with _cycle():
            return K.mg_up_q(u, g_q, *coarse(rc_t), nu2, h, w), cycles
    gmax = torch.linalg.vector_norm(g_q, float("inf"))  # one pass
    thresh = torch.clamp(gmax, min=1e-30) * min(tol * 0.995, tol - 4.0e-7)
    rmax = gmax if uq0 is None else rmax0
    burst = 0 if uq0 is not None else _tol_burst(tol, max_cycles, nu1, nu2)
    if burst < 1:  # check first: the start's residual, then one per cycle
        u, it = uq0, 0
        while it < max_cycles and exceeds(rmax, thresh):  # one host read per check
            with _cycle():
                u, rmax = vcycle_q(u, g_q, h, w, nu1, nu2, coarsest, with_residual=True,
                                   eig_cache=eig_cache)
            it += 1
        return (torch.zeros_like(g_q) if u is None else u), it
    u, rc_t = K.mg_down_q(None, g_q, nu1, h, w, chp)
    for _ in range(burst - 1):
        with _cycle():
            u, rc_t = K.mg_ud_q(u, g_q, *coarse(rc_t), nu2, nu1, h, w, chp)
    it = burst - 1
    while True:
        with _cycle():
            u, rc_t, rmax = K.mg_ud_q(u, g_q, *coarse(rc_t), nu2, nu1, h, w, chp,
                                      with_residual=True)
        it += 1
        if not (exceeds(rmax, thresh) and it < max_cycles):  # one host read per check
            return u, it


def _apply_a(p: torch.Tensor) -> torch.Tensor:
    """A p: the plain 5-point operator, zero outside the grid (pcg's)."""
    pp = F.pad(p, (1, 1, 1, 1))
    return (pp[:, :-2, 1:-1] + pp[:, 2:, 1:-1] + pp[:, 1:-1, :-2] + pp[:, 1:-1, 2:]) - 4.0 * p


def _vdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Over every channel at once, as ``jnp.vdot`` flattens."""
    return torch.dot(a.reshape(-1), b.reshape(-1))


def _pcg(g: torch.Tensor, u: torch.Tensor, tol: float, max_cycles: int, nu1: int, nu2: int,
         coarsest: int, use_pallas: bool, eig_cache) -> tuple[torch.Tensor, int, torch.Tensor]:
    """Flexible CG from u, preconditioned by one element V-cycle from zero,
    until max |r| <= tol * max |g| or ``max_cycles`` iterations (one host
    read per check). Returns (u, iterations, max |r|) with r the
    recurrence's residual."""

    def precond(r):
        with _cycle():
            return vcycle(torch.zeros_like(r), r, nu1, nu2, coarsest, use_pallas,
                          eig_cache=eig_cache)

    thresh = tol * torch.clamp(g.abs().max(), min=1e-30)
    r = residual(u, g)
    p = precond(r)
    rz = _vdot(r, p)
    it = 0
    while it < max_cycles and exceeds(r.abs().max(), thresh):  # one host read per check
        ap = _apply_a(p)
        alpha = rz / _vdot(p, ap)
        u = u + alpha * p
        r = r - alpha * ap
        z = precond(r)
        rz_new = _vdot(r, z)
        p = z + (rz_new / rz) * p  # flexible: the V-cycle is not symmetric
        rz = rz_new
        it += 1
    return u, it, r.abs().max()


def solve_multigrid(g: torch.Tensor, u0=None, tol: float = 1e-4, max_cycles: int = 60,
                    nu1: int = 1, nu2: int = 2, return_info: bool = False,
                    use_pallas: bool = False, cycles: int | None = None, pcg: bool = False,
                    coarsest: int = 63, fmg_start: bool = False, padded: bool | str = "q",
                    padded_output: bool | str = False,
                    true_hw: tuple[int, int] | None = None, eig_cache=None):
    """V-cycles until max |r| <= tol * max |g| (or ``cycles`` of them).

    g: (C, h, w) f32, or with ``true_hw=(h, w)`` pre-padded: for
    ``padded="t"`` the (C, hp, wp) slab of ``mg_geometry_t(h, w)``
    (``preprocess_rhs_p``'s output); for ``padded="q"`` the born-quartered
    (C, 4, hq, wq2) planes of ``mg_geometry_q(h, w)`` (``preprocess_rhs_q``'s
    output) or the dense (C, 2 hq, 2 wq2) slab; the RHS at the origin, exact
    zeros elsewhere. With ``use_pallas`` on a grid of at least 2^18 points,
    ``padded="q"`` runs the quarter-plane chain (``_solve_q``; a dense g is
    split by ``to_quarters``), ``padded="t"`` runs ``vcycle_t``, and
    ``padded=True``, or ``"q"`` with nu1 = 0, runs ``vcycle_p`` on
    ``mg_geometry``'s slab; small grids, and any grid with
    ``use_pallas=False``, run the element path (as in the JAX package,
    whatever ``padded`` says; a quartered g is then interleaved back first).
    ``cycles=k``: fixed work, k cycles, no checks. Else the tolerance loop:
    ``_tol_burst`` check-free cycles, then a residual check (one host read)
    per further cycle, up to ``max_cycles``. ``u0``: a warm start (C, h,
    w), checked before its first cycle (no check-free burst);
    ``fmg_start`` (without ``u0``) starts from ``fmg(g)`` the same way.
    ``pcg`` (tolerance mode only, as in the JAX package: ``cycles`` runs the
    V-cycles) runs the flexible CG of ``_pcg`` on the exact-size grid
    instead, ``cycles`` reporting its iterations and ``residual`` its
    recurrence's max |r|. ``padded_output``: ``"quarters"`` returns the
    quarter chain's planes; True the quarter chain's (C, 2 hq, 2 wq2), the
    ``"t"`` chain's or the dense chain's (C, hp, wp) slab (zeros outside
    the domain); the element path and pcg return the exact size either
    way. ``return_info`` (exclusive with ``padded_output``; not with a
    quartered g) adds {"cycles": int, "residual": max |g - A u|}.
    ``eig_cache``: see ``coarse_solve``; without one, the solve keeps its
    own, so each geometry's coarsest basis is built once a call.
    """
    tol = float(tol)
    if padded_output and return_info:
        raise ValueError("padded_output is exclusive with return_info")
    quartered = true_hw is not None and g.dim() == 4
    if quartered and (u0 is not None or fmg_start or pcg or return_info):
        raise ValueError("a quartered g supports only the zero-start padded='q' modes "
                         "(no u0/fmg_start/pcg/return_info)")
    c = g.shape[0]
    if true_hw is not None:
        h, w = (int(x) for x in true_hw)
        if padded == "q":
            _, hq, wq2, _ = K.mg_geometry_q(h, w)
            want = (4, hq, wq2) if quartered else (2 * hq, 2 * wq2)
        elif padded == "t" and not quartered:
            want = K.mg_geometry_t(h, w)[1:3]
        else:
            raise ValueError("true_hw (a pre-padded g) needs padded='t' or 'q', and a "
                             "quartered g padded='q'")
        if tuple(g.shape[1:]) != tuple(want):
            raise ValueError(f"pre-padded g {tuple(g.shape)} does not match the level "
                             f"geometry {tuple(want)} for true_hw={(h, w)}")
        g_pre, g = g, (None if quartered else g[:, :h, :w])
    else:
        _, h, w = g.shape
        g_pre = None
    if u0 is not None and tuple(u0.shape) != (c, h, w):
        raise ValueError(f"u0 {tuple(u0.shape)} is not the true-size {(c, h, w)}")
    if eig_cache is None:
        eig_cache = {}
    if u0 is None and fmg_start:  # the cascade's result is a warm start, as in JAX
        u0 = fmg(g, nu1, nu2, coarsest, use_pallas, eig_cache=eig_cache)
    if pcg and cycles is None:
        u, it, rmax = _pcg(g, torch.zeros_like(g) if u0 is None else u0, tol, max_cycles, nu1,
                           nu2, coarsest, use_pallas, eig_cache)
        if return_info:
            return u, {"cycles": it, "residual": read_residual(rmax)}
        return u
    if padded == "q" and quarter_path_applies(h, w, nu1, nu2, coarsest, use_pallas):
        _, hq, wq2, _ = K.mg_geometry_q(h, w)
        dense = (c, 2 * hq, 2 * wq2)
        if quartered:
            g_q = g_pre
        else:
            g_q = K.to_quarters(g_pre.contiguous() if g_pre is not None else _pad_to(g, dense))
        uq0 = rmax0 = None
        if u0 is not None:
            uq0 = K.to_quarters(_pad_to(u0, dense))
            rmax0 = residual(u0, g).abs().max()
        uq, it = _solve_q(g_q, h, w, nu1, nu2, coarsest, cycles, tol, max_cycles, uq0, rmax0,
                          eig_cache)
        if padded_output == "quarters":
            return uq
        u = K.from_quarters(uq)
        out = u if padded_output else u[:, :h, :w]
        if return_info:
            return out, {"cycles": it, "residual": read_residual(residual(out, g).abs().max())}
        return out
    if quartered:  # a grid the quarter chain does not take: its dense view
        g = K.from_quarters_plain(g_pre)[:, :h, :w]
    small = _small(h, w, coarsest)
    # padded=False: the element vcycle, whose large levels fuse on their own
    fused = padded is not False and t_chain_applies(h, w, nu1, nu2, coarsest, use_pallas)
    if fused and padded == "t":
        geom = K.mg_geometry_t(h, w)
        g_p = g_pre if g_pre is not None else _pad_to(g, (c, geom[1], geom[2]))

        def cycle(u):
            return vcycle_t(u, g_p, h, w, nu1, nu2, coarsest, geom=geom, eig_cache=eig_cache)
    elif fused:  # True, and "q" where the quarter gate fails: the dense rounded chain
        g_p = _pad_to(g, (c, *K.mg_geometry(h, w)[1:])).contiguous()

        def cycle(u):
            return vcycle_p(u, g_p, h, w, nu1, nu2, coarsest, eig_cache=eig_cache)
    else:
        g = g.contiguous()

        def cycle(u):
            return vcycle(torch.zeros_like(g) if u is None else u, g, nu1, nu2, coarsest,
                          use_pallas, eig_cache=eig_cache)

    def crop(u):  # once per check and once at the end: the slabs pad once on the way in
        return u[:, :h, :w] if fused else u

    u = None  # a known-zero start
    if u0 is not None:
        u = _pad_to(u0, g_p.shape).contiguous() if fused else u0
    if cycles is not None:
        it = int(cycles)
        for _ in range(it):
            with _cycle():
                u = cycle(u)
    else:
        gnorm = torch.clamp(g.abs().max(), min=1e-30)
        thresh = tol * gnorm
        # a warm start is checked first (no check-free burst), as in JAX
        burst = 0 if u0 is not None else _tol_burst(tol, max_cycles, nu1, nu2)
        if small:
            burst = min(burst, 1)
        for _ in range(burst):
            with _cycle():
                u = cycle(u)
        it = burst
        while it < max_cycles:
            r = g if u is None else residual(crop(u), g)
            if not exceeds(r.abs().max(), thresh):  # one host read per check
                break
            with _cycle():
                u = cycle(u)
            it += 1
    if u is None:
        u = torch.zeros_like(g_p if fused else g)
    out = u if (fused and padded_output) else crop(u)
    if return_info:
        return out, {"cycles": it, "residual": read_residual(residual(crop(u), g).abs().max())}
    return out
