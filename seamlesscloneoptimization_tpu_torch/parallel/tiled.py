"""Tile-based domain decomposition: halo exchange and the distributed solvers.

Port of ``seamlesscloneoptimization_tpu/parallel/tiled.py``. The interior
grid (C, H, W) is split into a (ty, tx) grid of tiles over a ``TileMesh``
(``parallel/mesh.py``); one process drives every tile, as JAX's single
controller drives every device of its mesh.

- ``halo_exchange`` pads each tile with k-px ghosts copied from its eight
  neighbours' edge strips (zeros past the grid: the Dirichlet frame). A
  strip crosses to its neighbour's device by a copy; the assembled global
  array is never formed.
- ``solve_redblack_tiled``: communication-avoiding red-black relaxation. One
  exchange of k ghosts feeds k/2 full sweeps on each ghosted tile (the
  staleness front never reaches the owned cells), colours and the Dirichlet
  domain in global coordinates. The per-tile sweeps are the
  ``rb_sweeps_tile`` kernel on CUDA tiles, its plain twin on CPU tiles.
- ``solve_multigrid_dd``: the finest level tile-local (CA sweeps through
  ``rb_sweeps_tile``, the residual from the still-exact ghost band,
  restriction and prolongation in global coordinates), everything below it
  gathered and solved by the element ``vcycle`` once per distinct device of
  the mesh (once on a one-card mesh), each tile taking its window of the
  coarse correction.
- ``solve_poisson_dd``: the arbitrary-size front door, padding to tiles the
  CA band fits and cropping.

Cells outside the true (Ht, Wt) domain of a padded grid are pinned to zero,
which is the Dirichlet frame of the interior system, so the embedded
solution restricted to the true cells is exact. A tolerance check reads the
max over the tiles to the host once (the counterpart of ``lax.pmax``).
Everything runs on each device's current stream in program order.

Not ported: ``solve_multigrid_sharded`` (the GSPMD path: torch has no SPMD
partitioner; ROADMAP §1 item 7).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from seamlesscloneoptimization_tpu_torch.ops import kernels as K
from seamlesscloneoptimization_tpu_torch.parallel.mesh import TileMesh, gather_tiles, shard_tiles
from seamlesscloneoptimization_tpu_torch.solvers.multigrid import _coarsen, _tol_burst, vcycle


def halo_exchange(tiles, k: int = 1):
    """Pad every (C, th, tw) tile of a (ty, tx) grid with k-px ghosts.

    The ghosts are the neighbours' edge strips; corners come from the
    diagonal neighbours, as JAX's rows-then-columns exchange of the
    row-extended tiles gives them. Tiles on the grid's edge get zeros there
    (the Dirichlet frame). Returns the grid of (C, th + 2k, tw + 2k) tiles,
    each on its tile's device; equal to the windows of the globally
    zero-padded array.
    """
    ty, tx = len(tiles), len(tiles[0])
    out = []
    for iy in range(ty):
        row = []
        for ix in range(tx):
            t = tiles[iy][ix]
            c, th, tw = t.shape
            if min(th, tw) < k:
                raise ValueError(f"tile {th}x{tw} smaller than the halo {k}")
            x = t.new_empty((c, th + 2 * k, tw + 2 * k))
            x[:, k : k + th, k : k + tw] = t
            for dy, rows_dst, rows_src in ((-1, slice(0, k), slice(th - k, th)),
                                           (0, slice(k, k + th), slice(0, th)),
                                           (1, slice(k + th, th + 2 * k), slice(0, k))):
                for dx, cols_dst, cols_src in ((-1, slice(0, k), slice(tw - k, tw)),
                                               (0, slice(k, k + tw), slice(0, tw)),
                                               (1, slice(k + tw, tw + 2 * k), slice(0, k))):
                    if dy == 0 and dx == 0:
                        continue
                    ny, nx = iy + dy, ix + dx
                    if 0 <= ny < ty and 0 <= nx < tx:  # a strip from the neighbour's device
                        x[:, rows_dst, cols_dst].copy_(tiles[ny][nx][:, rows_src, cols_src])
                    else:
                        x[:, rows_dst, cols_dst].zero_()
            row.append(x)
        out.append(row)
    return out


def _neighbor_sum_padded(up: torch.Tensor) -> torch.Tensor:
    return up[:, :-2, 1:-1] + up[:, 2:, 1:-1] + up[:, 1:-1, :-2] + up[:, 1:-1, 2:]


def _domain(hl: int, wl: int, org_r: int, org_c: int, ht: int, wt: int, device):
    """(hl, wl) bool: which cells of a local region at global (org_r, org_c)
    lie inside the true [0, Ht) x [0, Wt) domain."""
    rows = org_r + torch.arange(hl, device=device)[:, None]
    cols = org_c + torch.arange(wl, device=device)[None, :]
    return (rows >= 0) & (rows < ht) & (cols >= 0) & (cols < wt)


def _grid_max(vals, device) -> torch.Tensor:
    """The max of per-tile 0-dim tensors, on ``device`` (no host read)."""
    return torch.stack([v.to(device) for v in vals]).max()


class _Tiles:
    """A (ty, tx) tile grid's fixed geometry: the tile size, each tile's
    global origin and owned-cell mask, the true domain."""

    def __init__(self, mesh: TileMesh, hw: tuple[int, int], true_hw):
        self.ty, self.tx = mesh.shape
        h, w = hw
        self.th, self.tw = h // self.ty, w // self.tx
        self.ht, self.wt = true_hw if true_hw is not None else (h, w)
        self.dev0 = mesh.devices[0][0]
        self.cells = [(iy, ix) for iy in range(self.ty) for ix in range(self.tx)]
        self.own = {(iy, ix): _domain(self.th, self.tw, iy * self.th, ix * self.tw, self.ht,
                                      self.wt, mesh.devices[iy][ix])[None]
                    for iy, ix in self.cells}

    def origin(self, iy: int, ix: int) -> tuple[int, int]:
        return iy * self.th, ix * self.tw

    def map(self, fn, *grids):
        """[[fn(iy, ix, *cells)]] over the grid."""
        return [[fn(iy, ix, *(g[iy][ix] for g in grids)) for ix in range(self.tx)]
                for iy in range(self.ty)]

    def masked_rhs(self, g: torch.Tensor, mesh: TileMesh):
        """g's tiles, zero outside the true domain."""
        return self.map(lambda iy, ix, t: torch.where(self.own[iy, ix], t, 0.0),
                        shard_tiles(g, mesh))

    def gnorm(self, g_loc) -> torch.Tensor:
        m = _grid_max([g_loc[iy][ix].abs().max() for iy, ix in self.cells], self.dev0)
        return torch.clamp(m, min=1e-30)

    def res_norm(self, u, g_loc) -> torch.Tensor:
        """max |g - A u| over the owned true cells of every tile, on the
        first device (a 1-ghost exchange)."""
        up = halo_exchange(u, 1)

        def tile_max(iy, ix, x, xp, gl):
            r = torch.where(self.own[iy, ix], gl - (_neighbor_sum_padded(xp) - 4.0 * x), 0.0)
            return r.abs().max()

        return _grid_max([m for row in self.map(tile_max, u, up, g_loc) for m in row],
                         self.dev0)


def solve_redblack_tiled(g: torch.Tensor, mesh: TileMesh, true_hw: tuple[int, int] | None = None,
                         tol: float = 1e-4, max_iters: int = 20000, check_every: int = 50,
                         halo: int = 4, use_pallas: bool | None = None, overlap: bool = False,
                         return_info: bool = False):
    """Distributed red-black solve of A u = g on a (ty, tx) tile mesh.

    g: (C, H, W) with H % ty == 0 and W % tx == 0 (zero-pad to fit and pass
    the unpadded size as ``true_hw``: padded cells stay zero). ``halo``: the
    ghost band (even, >= 2, clipped to the tile); one exchange feeds
    halo // 2 full sweeps. ``use_pallas``: True or None sweeps each tile with
    ``K.rb_sweeps_tile`` (the kernel on a CUDA tile, its twin on a CPU
    tile), False with the plain select-form twin. ``overlap``: accepted for
    the JAX package's signature and runs the plain schedule: JAX's
    interior-first schedule is the same arithmetic, bit for bit, and pays
    only once the interior runs on a side stream (ROADMAP §1 item 7). Before
    each ``check_every`` sweeps the loop reads max |r| over the tiles to the
    host once and stops at ``tol`` * max |g| or ``max_iters`` sweeps. Returns u (C, H, W) on g's
    device; ``return_info`` adds {"iterations", "residual"}.
    """
    if halo < 2 or halo % 2:
        raise ValueError("halo must be an even integer >= 2")
    ty, tx = mesh.shape
    _, h, w = g.shape
    if h % ty or w % tx:
        raise ValueError(f"grid {h}x{w} not divisible by mesh {ty}x{tx}; pad first")
    geo = _Tiles(mesh, (h, w), true_hw)
    th, tw = geo.th, geo.tw
    if min(th, tw) < 2:
        raise ValueError(f"tile {th}x{tw} too small for halo exchange; use fewer devices "
                         f"or a bigger grid")
    k = min(halo, th, tw)  # the halo cannot exceed the tile itself
    k -= k % 2
    s = k // 2  # full sweeps per exchange
    domain = (geo.ht, geo.wt)
    sweep = K.rb_sweeps_tile if use_pallas is not False else K.rb_sweeps_tile_plain

    g_loc = geo.masked_rhs(g, mesh)
    gp = halo_exchange(g_loc, k)  # g is static: one exchange
    gnorm = geo.gnorm(g_loc)

    def ca_round(u):
        """One exchange + s full sweeps on each ghosted tile."""
        up = halo_exchange(u, k)

        def tile(iy, ix, x, gx):
            r0, c0 = geo.origin(iy, ix)
            return sweep(x, gx, s, (r0 - k, c0 - k), domain)[:, k : k + th, k : k + tw]

        return geo.map(tile, up, gp)

    rounds_per_check = max(check_every // s, 1)
    u = geo.map(lambda iy, ix, gl: torch.zeros_like(gl), g_loc)
    thresh = tol * gnorm
    it = 0
    while it < max_iters and bool(geo.res_norm(u, g_loc) > thresh):  # one host read
        for _ in range(rounds_per_check):
            u = ca_round(u)
        it += rounds_per_check * s
    out = gather_tiles(u, g.device)
    if return_info:
        return out, {"iterations": it, "residual": geo.res_norm(u, g_loc).item()}
    return out


def _restrict_2g(x: torch.Tensor, n_true: int, beta: float, org: int) -> torch.Tensor:
    """Full-weighting rows of a 2-ghosted local block (row 0 = global org-2)
    -> m = rows//2 - 2 local coarse rows, with the global even-size
    Shortley-Weller edge weights applied by mask."""
    m = (x.shape[1] - 4) // 2
    a0 = x[:, 2 : 2 * m + 1 : 2, :]    # fine 2jc   (global)
    a1 = x[:, 3 : 2 * m + 2 : 2, :]    # fine 2jc+1
    a2 = x[:, 4 : 2 * m + 3 : 2, :]    # fine 2jc+2
    out = 0.25 * a0 + 0.5 * a1 + 0.25 * a2
    if n_true % 2 == 0:
        a3 = x[:, 5 : 2 * m + 4 : 2, :]  # fine 2jc+3 (always m rows)
        gap = 2.0 + beta
        edge = (0.25 * a0 + 0.5 * a1 + ((1.0 + beta) / gap * 0.5) * a2
                + (beta / gap * 0.5) * a3)
        jc = org // 2 + torch.arange(m, device=x.device)[:, None]
        out = torch.where(jc == (n_true - 1) // 2 - 1, edge, out)
    return out


def _prolong_1g(e: torch.Tensor, n_true: int, beta: float, org: int) -> torch.Tensor:
    """Bilinear row prolongation of a 1-ghosted local coarse block (row 0 =
    global coarse org//2 - 1) -> 2m local fine rows, with the global
    even-size edge weights by mask. Coarse cells beyond the true grid are
    zero in ``e``."""
    c, rows, width = e.shape
    m = rows - 2
    mids = 0.5 * (e[:, : m + 1, :] + e[:, 1 : m + 2, :])
    pairs = torch.stack([mids[:, :m, :], e[:, 1 : m + 1, :]], dim=2).reshape(c, 2 * m, width)
    if n_true % 2 == 0:
        gap = 2.0 + beta
        gidx = org + torch.arange(2 * m, device=e.device)[:, None]
        # fine n-2 (even): the bulk mid 0.5 e[nc-1] (e[nc] = 0) rescaled to
        # (1+b)/gap e[nc-1]; fine n-1 (odd): the bulk e[nc] = 0 replaced by
        # (b/gap) e[nc-1] = 2b/gap times that row's mid
        pairs = torch.where(gidx == n_true - 2, pairs * (2.0 * (1.0 + beta) / gap), pairs)
        mids_rep = torch.stack([mids[:, :m, :]] * 2, dim=2).reshape(pairs.shape)
        pairs = torch.where(gidx == n_true - 1, mids_rep * (2.0 * beta / gap), pairs)
    return pairs


def solve_multigrid_dd(g: torch.Tensor, mesh: TileMesh, true_hw: tuple[int, int] | None = None,
                       cycles: int = 4, nu1: int = 1, nu2: int = 2,
                       use_pallas: bool | None = None, tol: float | None = None,
                       max_cycles: int = 60, return_info: bool = False, eig_cache=None):
    """Domain-decomposed multigrid: the tile-local finest level, a replicated
    coarse solve.

    The finest level runs per tile with a communication-avoiding ghost band
    k = max(2 max(nu1, nu2) + 2, 2 nu1 + 3): one exchange, then nu1 sweeps
    (``K.rb_sweeps_tile``); the residual on a 2-ghost window from the still
    exact band; full weighting in global coordinates (``_restrict_2g``, the
    even-size edge's fourth term inside the window); the coarse RHS gathered
    from the tiles and solved by the element ``vcycle`` on the true coarse
    grid once per distinct device of the mesh (its levels of at least 2^18
    points fused: ``mg_down`` / ``mg_up``); each tile's (thc + 2, twc + 2)
    window of the correction prolonged (``_prolong_1g``) and added; one
    more exchange and nu2 sweeps. Mathematically the single-device
    V(nu1, nu2) cycle.

    g: (C, H, W) with H % (2 ty) == W % (2 tx) == 0 and tiles at least k on
    a side (zero-pad and pass ``true_hw``; ``solve_poisson_dd`` does). Fixed
    ``cycles``, or with ``tol`` the check-free burst (``_tol_burst``) and
    then one max |r| host read per further cycle until max |r| <= tol max |g|
    or ``max_cycles``. ``use_pallas`` True or None: the kernels on CUDA tiles
    and their twins on CPU tiles; False: the plain twins and the element
    coarse path. ``eig_cache``: the coarsest level's basis cache
    (``solvers/multigrid.py:coarse_solve``). Returns u (C, H, W) on g's
    device, zero outside the true domain; ``return_info`` adds
    {"cycles", "residual"}.
    """
    ty, tx = mesh.shape
    _, h, w = g.shape
    if h % (2 * ty) or w % (2 * tx):
        raise ValueError(f"grid {h}x{w} must be divisible by 2*mesh {ty}x{tx}")
    geo = _Tiles(mesh, (h, w), true_hw)
    th, tw, ht, wt = geo.th, geo.tw, geo.ht, geo.wt
    hc, bh_c = _coarsen(ht, 1.0)
    wc, bw_c = _coarsen(wt, 1.0)
    hcp, wcp = h // 2, w // 2  # the padded coarse grid (tile-divisible)
    thc, twc = th // 2, tw // 2
    pallas = use_pallas is not False
    sweep = K.rb_sweeps_tile if pallas else K.rb_sweeps_tile_plain
    # CA ghosts: sweep staleness (2 nu1 after the descent) + 3 exact layers;
    # the residual is taken on a 2-ghost window (its neighbour sum touches
    # layer 3) so the even-size restriction's fourth Shortley-Weller term
    # (fine 2jc+3) exists even when the global edge coarse row is the last
    # local coarse row of a tile
    k = max(2 * max(nu1, nu2) + 2, 2 * nu1 + 3)
    if min(th, tw) < k:
        raise ValueError(f"tile {th}x{tw} smaller than the ghost band {k}")

    g_loc = geo.masked_rhs(g, mesh)
    gp = halo_exchange(g_loc, k)

    def sweeps(u, n):
        """One exchange + n CA sweeps; the ghosted tiles (outer 2n layers
        stale, the rest exact)."""
        up = halo_exchange(u, k)

        def tile(iy, ix, x, gx):
            r0, c0 = geo.origin(iy, ix)
            return sweep(x, gx, n, (r0 - k, c0 - k), (ht, wt))

        return geo.map(tile, up, gp)

    def coarse_rhs(iy, ix, us, gx):
        """The tile's restricted residual (thc, twc), x4."""
        r0, c0 = geo.origin(iy, ix)
        b = k - 2
        u1 = us[:, b : b + th + 4, b : b + tw + 4]
        u2 = us[:, b - 1 : b + th + 5, b - 1 : b + tw + 5]
        g1 = gx[:, b : b + th + 4, b : b + tw + 4]
        dom2 = _domain(th + 4, tw + 4, r0 - 2, c0 - 2, ht, wt, us.device)[None]
        r = torch.where(dom2, g1 - (_neighbor_sum_padded(u2) - 4.0 * u1), 0.0)
        rr = _restrict_2g(r, ht, 1.0, r0)
        return 4.0 * _restrict_2g(rr.transpose(1, 2), wt, 1.0, c0).transpose(1, 2)

    def vcycle_local(u):
        us = sweeps(u, nu1)
        rc_loc = geo.map(coarse_rhs, us, gp)
        # the replicated coarse solve on the true coarse grid, once per device
        ecp = {}
        for dev in mesh.distinct():
            rc = gather_tiles(rc_loc, dev)[:, :hc, :wc]
            ec = vcycle(torch.zeros_like(rc), rc, nu1, nu2, use_pallas=pallas, bh=bh_c,
                        bw=bw_c, eig_cache=eig_cache, u_zero=True)
            ecp[dev] = F.pad(ec, (1, wcp - wc + 1, 1, hcp - hc + 1))

        def correct(iy, ix, x):
            r0, c0 = geo.origin(iy, ix)
            e1 = ecp[x.device][:, iy * thc : iy * thc + thc + 2, ix * twc : ix * twc + twc + 2]
            ef = _prolong_1g(e1, ht, 1.0, r0)
            ef = _prolong_1g(ef.transpose(1, 2), wt, 1.0, c0).transpose(1, 2)
            return x[:, k : k + th, k : k + tw] + torch.where(geo.own[iy, ix], ef, 0.0)

        u = geo.map(correct, us)
        return [[x[:, k : k + th, k : k + tw] for x in row] for row in sweeps(u, nu2)]

    u = geo.map(lambda iy, ix, gl: torch.zeros_like(gl), g_loc)
    if tol is None:
        it = int(cycles)
        for _ in range(it):
            u = vcycle_local(u)
    else:
        # the single-device solver's protocol: a check-free burst, then one
        # check per cycle (the DD cycle has the same contraction)
        thresh = tol * geo.gnorm(g_loc)
        it = _tol_burst(tol, max_cycles, nu1, nu2)
        for _ in range(it):
            u = vcycle_local(u)
        while it < max_cycles and bool(geo.res_norm(u, g_loc) > thresh):  # one host read
            u = vcycle_local(u)
            it += 1
    out = gather_tiles(u, g.device)
    if return_info:
        return out, {"cycles": it, "residual": geo.res_norm(u, g_loc).item()}
    return out


def solve_poisson_dd(g: torch.Tensor, mesh: TileMesh, tol: float | None = None, cycles: int = 4,
                     max_cycles: int = 60, use_pallas: bool | None = None,
                     return_info: bool = False, eig_cache=None):
    """The arbitrary-size front door of the DD multigrid.

    Zero-pads (C, H, W) to a 2 x mesh-divisible grid whose tiles are even
    and at least 8 (the default CA band is 6), runs
    :func:`solve_multigrid_dd` with ``true_hw=(H, W)`` (the padded cells pin
    to zero: the Dirichlet frame) and crops.
    """
    ty, tx = mesh.shape
    _, h, w = g.shape
    hp = ty * max(2 * (-(-h // (2 * ty))), 8)
    wp = tx * max(2 * (-(-w // (2 * tx))), 8)
    res = solve_multigrid_dd(F.pad(g, (0, wp - w, 0, hp - h)), mesh, true_hw=(h, w),
                             cycles=cycles, use_pallas=use_pallas, tol=tol,
                             max_cycles=max_cycles, return_info=return_info,
                             eig_cache=eig_cache)
    if return_info:
        return res[0][:, :h, :w], res[1]
    return res[:, :h, :w]
