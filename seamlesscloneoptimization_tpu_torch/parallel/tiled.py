"""Tile-based domain decomposition: halo exchange and the distributed solvers.

Port of ``seamlesscloneoptimization_tpu/parallel/tiled.py``. The interior
grid (C, H, W) is split into a (ty, tx) grid of tiles over a ``TileMesh``
(``parallel/mesh.py``). One process may drive every tile, as JAX's single
controller drives every device of its mesh, or the mesh may span processes
(``init_distributed``): each process then holds its own cells' tiles, every
process passes the same global g, and each gets the whole u back, bit-equal
to the same call on a single-process mesh of that shape.

- ``halo_exchange`` pads each tile with k-px ghosts from its eight
  neighbours' edge strips (zeros past the grid: the Dirichlet frame): a copy
  inside this process, a point-to-point transfer across processes
  (``parallel/transport.py``). The assembled global array is never formed.
- ``solve_redblack_tiled``: communication-avoiding red-black relaxation. One
  exchange of k ghosts feeds k/2 full sweeps on each ghosted tile (the
  staleness front never reaches the owned cells), colours and the Dirichlet
  domain in global coordinates. The per-tile sweeps are the
  ``rb_sweeps_tile`` kernel on CUDA tiles, its plain twin on CPU tiles.
  ``overlap=True`` is JAX's interior-first schedule: each tile's deep
  interior is swept before its ghosts arrive, while the exchange runs on
  side streams (``transport.halo_exchange_start``), and four rim bands,
  swept where they lie in the ghosted tile, finish it.
- ``solve_multigrid_dd``: the finest level tile-local (CA sweeps through
  ``rb_sweeps_tile``, the residual from the still-exact ghost band,
  restriction and prolongation in global coordinates), everything below it
  gathered (an ``all_gather`` across processes) and solved by the element
  ``vcycle`` once per distinct device of this process, each tile taking its
  window of the coarse correction.
- ``solve_poisson_dd``: the arbitrary-size front door, padding to tiles the
  CA band fits and cropping.
- ``solve_multigrid_sharded``: JAX's GSPMD path, the element V-cycle with
  every level partitioned by hand (XLA partitions it in JAX): uneven tiles,
  a ghost exchange per stencil, global-coordinate colours and edges, the
  small levels gathered; bit-equal to the single-device element solve.

Cells outside the true (Ht, Wt) domain of a padded grid are pinned to zero,
which is the Dirichlet frame of the interior system, so the embedded
solution restricted to the true cells is exact. A tolerance check reads the
max over the tiles (all-reduced across processes, the counterpart of
``lax.pmax``) to the host once, on every rank, so the ranks' loops stay in
lockstep. Everything runs on each device's current stream in program
order, but for the halo exchanges of ``solve_redblack_tiled(overlap=True)``,
which run on a side stream of each device (on CPU tiles in program order).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from seamlesscloneoptimization_tpu_torch.ops import kernels as K
from seamlesscloneoptimization_tpu_torch.parallel import transport
from seamlesscloneoptimization_tpu_torch.parallel.mesh import TileMesh, shard_tiles
from seamlesscloneoptimization_tpu_torch.parallel.transport import (
    grid_max,
    halo_exchange,
    map_local,
    replicate,
)
from seamlesscloneoptimization_tpu_torch.solvers.multigrid import (
    _coarsen,
    _ops_b,
    _pad_to,
    _small,
    _tol_burst,
    solve_multigrid,
    vcycle,
)
from seamlesscloneoptimization_tpu_torch.solvers.multigrid_dyn import (
    COARSEST as DYN_COARSEST,
    solve_dyn_window,
    vcycle_dyn,
)


def _neighbor_sum_padded(up: torch.Tensor) -> torch.Tensor:
    return up[:, :-2, 1:-1] + up[:, 2:, 1:-1] + up[:, 1:-1, :-2] + up[:, 1:-1, 2:]


def _domain(hl: int, wl: int, org_r: int, org_c: int, ht: int, wt: int, device):
    """(hl, wl) bool: which cells of a local region at global (org_r, org_c)
    lie inside the true [0, Ht) x [0, Wt) domain."""
    rows = org_r + torch.arange(hl, device=device)[:, None]
    cols = org_c + torch.arange(wl, device=device)[None, :]
    return (rows >= 0) & (rows < ht) & (cols >= 0) & (cols < wt)


class Tiling:
    """Row and column boundaries of a tile grid in the global coordinates of
    the array it splits: tile (iy, ix) is rows[iy] .. rows[iy + 1] by
    cols[ix] .. cols[ix + 1]. Each solver's tile form takes g split by its
    own tiling (``dd_tiling``, ``sharded_tiling``), so that the stages give
    birth to each tile of g on the device that solves it."""

    def __init__(self, rows, cols):
        self.rows, self.cols = tuple(rows), tuple(cols)

    def box(self, iy: int, ix: int) -> tuple[int, int, int, int]:
        return self.rows[iy], self.rows[iy + 1], self.cols[ix], self.cols[ix + 1]

    def shape_of(self, c: int):
        def shape(iy, ix):
            r0, r1, c0, c1 = self.box(iy, ix)
            return (c, r1 - r0, c1 - c0)

        return shape

    def split(self, x: torch.Tensor, mesh: TileMesh):
        """This process's tiles of a whole (C, H, W) ``x``, each a contiguous
        copy on its cell's device (None for the other ranks' cells)."""
        def tile(iy, ix, _):
            r0, r1, c0, c1 = self.box(iy, ix)
            return x[:, r0:r1, c0:c1].to(mesh.devices[iy][ix], copy=True).contiguous()

        ty, tx = mesh.shape
        return map_local(mesh, tile, [[None] * tx for _ in range(ty)])

    def windows_of(self, whole: dict, mesh: TileMesh):
        """Each local cell's tile of a whole array held on every device of
        this process (``whole``: device -> (C, H, W))."""
        def tile(iy, ix, _):
            r0, r1, c0, c1 = self.box(iy, ix)
            return whole[mesh.devices[iy][ix]][:, r0:r1, c0:c1].contiguous()

        ty, tx = mesh.shape
        return map_local(mesh, tile, [[None] * tx for _ in range(ty)])


def _check_tiles(g_tiles, tiling: Tiling, mesh: TileMesh) -> None:
    for iy, ix in mesh.local_cells():
        r0, r1, c0, c1 = tiling.box(iy, ix)
        if tuple(g_tiles[iy][ix].shape[1:]) != (r1 - r0, c1 - c0):
            raise ValueError(f"tile ({iy}, {ix}) {tuple(g_tiles[iy][ix].shape)} is not the "
                             f"tiling's {(r1 - r0, c1 - c0)}")


def _even(n: int, parts: int) -> tuple[int, ...]:
    t = n // parts
    return tuple(i * t for i in range(parts + 1))


class _Tiles:
    """A (ty, tx) tile grid's fixed geometry: the tile size, each tile's
    global origin and owned-cell mask, the true domain. Grids hold this
    process's tiles; the other ranks' cells are None."""

    def __init__(self, mesh: TileMesh, hw: tuple[int, int], true_hw):
        self.mesh = mesh
        self.ty, self.tx = mesh.shape
        h, w = hw
        self.th, self.tw = h // self.ty, w // self.tx
        self.ht, self.wt = true_hw if true_hw is not None else (h, w)
        self.dev0 = mesh.distinct()[0]
        self.cells = mesh.local_cells()
        self.own = {(iy, ix): _domain(self.th, self.tw, iy * self.th, ix * self.tw, self.ht,
                                      self.wt, mesh.devices[iy][ix])[None]
                    for iy, ix in self.cells}

    def origin(self, iy: int, ix: int) -> tuple[int, int]:
        return iy * self.th, ix * self.tw

    def map(self, fn, *grids):
        return map_local(self.mesh, fn, *grids)

    def exchange(self, tiles, k: int):
        return halo_exchange(tiles, k, self.mesh)

    def max(self, vals) -> torch.Tensor:
        """The max of this process's per-tile 0-dim tensors over every
        rank, on the first device (no host read)."""
        return grid_max(vals, self.dev0, self.mesh)

    def gather(self, tiles, device, tile_hw=None) -> torch.Tensor:
        """The whole array of a grid of (C, *tile_hw) tiles (default the
        tile size) on ``device``, in every process."""
        c = next(t for row in tiles for t in row if t is not None).shape[0]
        th, tw = tile_hw or (self.th, self.tw)
        return transport.gather(tiles, device, self.mesh, lambda iy, ix: (c, th, tw))

    def masked_rhs(self, g: torch.Tensor, mesh: TileMesh):
        """g's tiles, zero outside the true domain."""
        return self.map(lambda iy, ix, t: torch.where(self.own[iy, ix], t, 0.0),
                        shard_tiles(g, mesh))

    def gnorm(self, g_loc) -> torch.Tensor:
        m = self.max([g_loc[iy][ix].abs().max() for iy, ix in self.cells])
        return torch.clamp(m, min=1e-30)

    def res_norm(self, u, g_loc) -> torch.Tensor:
        """max |g - A u| over the owned true cells of every tile, on the
        first device (a 1-ghost exchange)."""
        up = self.exchange(u, 1)

        def tile_max(iy, ix, x, xp, gl):
            r = torch.where(self.own[iy, ix], gl - (_neighbor_sum_padded(xp) - 4.0 * x), 0.0)
            return r.abs().max()

        maxima = self.map(tile_max, u, up, g_loc)
        return self.max([maxima[iy][ix] for iy, ix in self.cells])


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
    tile), False with the plain select-form twin. ``overlap``: JAX's
    interior-first schedule, where tiles exceed 4 (halo // 2) on both
    sides (the plain one otherwise): per round each tile's unghosted
    interior is swept first, on the current stream, while the exchange's
    copies (and over gloo its host staging and transfers) run on each
    device's side stream; then four bands of halo + 2 halo rows or columns
    of the ghosted tile, swept in place by the kernel's window form, give
    the tile's outer 2 (halo // 2) rows and columns; bit-equal to the plain
    schedule, 5 ``rb_sweeps_tile`` calls a tile a round instead of 1. Before
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
    gp = geo.exchange(g_loc, k)  # g is static: one exchange
    gnorm = geo.gnorm(g_loc)

    def ca_round(u):
        """One exchange + s full sweeps on each ghosted tile."""
        up = geo.exchange(u, k)

        def tile(iy, ix, x, gx):
            r0, c0 = geo.origin(iy, ix)
            return sweep(x, gx, s, (r0 - k, c0 - k), domain)[:, k : k + th, k : k + tw]

        return geo.map(tile, up, gp)

    def ca_round_overlap(u):
        """JAX's ``ca_round_overlap``: the interior (the cells >= 2s from
        the tile's edge need no ghost) swept while the exchange runs, then
        four bands of b = k + 4s rows or columns of the ghosted tile for
        its w = 2s outer rows and columns, written over the interior's."""
        w_, b = 2 * s, k + 4 * s
        ready = transport.ready_events(u)
        ui = geo.map(lambda iy, ix, x, gl: sweep(x, gl, s, geo.origin(iy, ix), domain),
                     u, g_loc)
        up = transport.halo_exchange_finish(transport.halo_exchange_start(u, k, mesh, ready))

        def tile(iy, ix, x, gx, out):
            r0, c0 = geo.origin(iy, ix)
            top = sweep(x[:, :b], gx[:, :b], s, (r0 - k, c0 - k), domain)
            bot = sweep(x[:, -b:], gx[:, -b:], s, (r0 + th + k - b, c0 - k), domain)
            lef = sweep(x[:, :, :b], gx[:, :, :b], s, (r0 - k, c0 - k), domain)
            rig = sweep(x[:, :, -b:], gx[:, :, -b:], s, (r0 - k, c0 + tw + k - b), domain)
            out[:, :w_] = top[:, k : k + w_, k : k + tw]
            out[:, th - w_ :] = bot[:, b - k - w_ : b - k, k : k + tw]
            out[:, w_ : th - w_, :w_] = lef[:, k + w_ : k + th - w_, k : k + w_]
            out[:, w_ : th - w_, tw - w_ :] = rig[:, k + w_ : k + th - w_, b - k - w_ : b - k]
            return out

        return geo.map(tile, up, gp, ui)

    step = ca_round_overlap if overlap and th > 4 * s and tw > 4 * s else ca_round
    rounds_per_check = max(check_every // s, 1)
    u = geo.map(lambda iy, ix, gl: torch.zeros_like(gl), g_loc)
    thresh = tol * gnorm
    it = 0
    while it < max_iters and bool(geo.res_norm(u, g_loc) > thresh):  # one host read
        for _ in range(rounds_per_check):
            u = step(u)
        it += rounds_per_check * s
    out = geo.gather(u, g.device)
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
    g_loc = geo.masked_rhs(g, mesh)
    u, it = _dd_tiles(geo, g_loc, cycles, nu1, nu2, use_pallas, tol, max_cycles, eig_cache)
    out = geo.gather(u, g.device)
    if return_info:
        return out, {"cycles": it, "residual": geo.res_norm(u, g_loc).item()}
    return out


def _dd_tiles(geo: _Tiles, g_loc, cycles: int, nu1: int, nu2: int, use_pallas: bool | None,
              tol: float | None, max_cycles: int, eig_cache):
    """``solve_multigrid_dd`` on this process's tiles of g (zero outside the
    true domain): returns (the tiles of u, the cycles run)."""
    mesh = geo.mesh
    th, tw, ht, wt = geo.th, geo.tw, geo.ht, geo.wt
    hc, bh_c = _coarsen(ht, 1.0)
    wc, bw_c = _coarsen(wt, 1.0)
    hcp, wcp = geo.ty * th // 2, geo.tx * tw // 2  # the padded coarse grid (tile-divisible)
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
    gp = geo.exchange(g_loc, k)
    coarse_tiling = Tiling(_even(hcp, geo.ty), _even(wcp, geo.tx))

    def sweeps(u, n):
        """One exchange + n CA sweeps; the ghosted tiles (outer 2n layers
        stale, the rest exact)."""
        up = geo.exchange(u, k)

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
        c = next(t for row in rc_loc for t in row if t is not None).shape[0]
        ecp = {}
        for dev, rc_all in replicate(rc_loc, mesh, coarse_tiling.shape_of(c)).items():
            rc = rc_all[:, :hc, :wc]
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
        return geo.map(lambda iy, ix, x: x[:, k : k + th, k : k + tw], sweeps(u, nu2))

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
    return u, it


def dd_tiling(h: int, w: int, mesh: TileMesh) -> Tiling:
    """The tiles of ``solve_poisson_dd``'s padded grid for an (h, w) g: even
    tiles of at least 8 on a side over a 2 x mesh-divisible grid whose cells
    past (h, w) pin to zero."""
    ty, tx = mesh.shape
    hp = ty * max(2 * (-(-h // (2 * ty))), 8)
    wp = tx * max(2 * (-(-w // (2 * tx))), 8)
    return Tiling(_even(hp, ty), _even(wp, tx))


def solve_poisson_dd(g: torch.Tensor, mesh: TileMesh, tol: float | None = None, cycles: int = 4,
                     max_cycles: int = 60, use_pallas: bool | None = None,
                     return_info: bool = False, eig_cache=None):
    """The arbitrary-size front door of the DD multigrid.

    Zero-pads (C, H, W) to a 2 x mesh-divisible grid whose tiles are even
    and at least 8 (the default CA band is 6; ``dd_tiling``), runs
    :func:`solve_multigrid_dd` with ``true_hw=(H, W)`` (the padded cells pin
    to zero: the Dirichlet frame) and crops.
    """
    _, h, w = g.shape
    tiling = dd_tiling(h, w, mesh)
    hp, wp = tiling.rows[-1], tiling.cols[-1]
    res = solve_multigrid_dd(F.pad(g, (0, wp - w, 0, hp - h)), mesh, true_hw=(h, w),
                             cycles=cycles, use_pallas=use_pallas, tol=tol,
                             max_cycles=max_cycles, return_info=return_info,
                             eig_cache=eig_cache)
    if return_info:
        return res[0][:, :h, :w], res[1]
    return res[:, :h, :w]


def solve_poisson_dd_tiles(g_tiles, hw: tuple[int, int], mesh: TileMesh,
                           tol: float | None = None, cycles: int = 4, max_cycles: int = 60,
                           use_pallas: bool | None = None, return_info: bool = False,
                           eig_cache=None):
    """``solve_poisson_dd`` with g as this process's tiles of ``dd_tiling(h,
    w, mesh)`` (None for the other ranks' cells; cells past (h, w) ignored)
    and u returned as tiles of the same tiling, zero past (h, w): the same
    arithmetic, bit for bit, without the whole g or u anywhere."""
    tiling = dd_tiling(*hw, mesh)
    _check_tiles(g_tiles, tiling, mesh)
    geo = _Tiles(mesh, (tiling.rows[-1], tiling.cols[-1]), hw)
    g_loc = geo.map(lambda iy, ix, t: torch.where(geo.own[iy, ix], t, 0.0), g_tiles)
    u, it = _dd_tiles(geo, g_loc, cycles, 1, 2, use_pallas, tol, max_cycles, eig_cache)
    if return_info:
        return u, {"cycles": it, "residual": geo.res_norm(u, g_loc).item()}
    return u


# ---------------------------------------------------------------------------
# solve_multigrid_sharded: the element V-cycle partitioned over the mesh, and
# solve_multigrid_dyn_sharded: the runtime-domain V-cycle partitioned the same way
# ---------------------------------------------------------------------------

SHARD_MIN = 128  # a level whose smallest tile is shorter than this on a side is gathered
_NU1, _NU2, _COARSEST = 1, 2, 63  # solve_multigrid's defaults, which JAX's GSPMD path runs
_KG = max(2 * _NU1 + 2, 2 * _NU2)  # ghosts: nu1 sweeps + the residual's window; nu2 sweeps


def _split(n: int, parts: int) -> tuple[int, ...]:
    """Tile boundaries along an axis: ceil(n / parts) each, the last shorter."""
    t = -(-n // parts)
    return tuple(min(i * t, n) for i in range(parts + 1))


def _halve(bounds: tuple[int, ...], nc: int) -> tuple[int, ...]:
    """The coarse level's boundaries: coarse j lies in the tile whose fine
    rows hold its fine point 2j + 1."""
    return tuple(min(b // 2, nc) for b in bounds[:-1]) + (nc,)


def sharded_tiling(h: int, w: int, mesh: TileMesh) -> Tiling:
    """The tiles of the partitioned V-cycles' fine level (element and
    runtime-domain) for an (h, w) g: ceil(n / t) rows and columns, the last
    tile shorter."""
    return Tiling(_split(h, mesh.shape[0]), _split(w, mesh.shape[1]))


class _Level(Tiling):
    """One level of the partitioned V-cycle: its global (h, w), its betas
    and its tile boundaries. ``sharded``: the level runs tile by tile;
    otherwise it is gathered and solved by the element ``vcycle``.
    ``padded_hw``: the runtime-domain V-cycle's padded level, whose size
    sets the depth (``vcycle_dyn``); None for the element V-cycle."""

    def __init__(self, h: int, w: int, bh: float, bw: float, rows, cols, padded_hw=None):
        super().__init__(rows, cols)
        self.h, self.w, self.bh, self.bw = h, w, bh, bw
        self.padded_hw = padded_hw
        sides = [b - a for bounds in (self.rows, self.cols) for a, b in zip(bounds, bounds[1:])]
        if padded_hw is None:
            self.sharded = not _small(h, w, _COARSEST) and min(sides) >= max(SHARD_MIN, _KG)
        else:
            self.sharded = (not _small(*padded_hw, DYN_COARSEST) and min(h, w) >= 1
                            and min(sides) >= max(SHARD_MIN, _KG))
        self.unit = bh == 1.0 and bw == 1.0  # the plain operator: rb_sweeps_tile

    @property
    def dyn(self) -> bool:
        return self.padded_hw is not None

    def coarser(self) -> _Level:
        hc, bh_c = _coarsen(self.h, self.bh)
        wc, bw_c = _coarsen(self.w, self.bw)
        pad = None if self.padded_hw is None else tuple((p - 1) // 2 for p in self.padded_hw)
        return _Level(hc, wc, bh_c, bw_c, _halve(self.rows, hc), _halve(self.cols, wc), pad)


def _sweeps_b_tile(u: torch.Tensor, g: torch.Tensor, n: int, lv: _Level, org) -> torch.Tensor:
    """``solvers/multigrid.py:_sweeps_b`` on a ghosted tile whose (0, 0) is
    the level's ``org``: the colours and the Shortley-Weller edge from global
    coordinates; only cells inside the level are updated. A runtime-domain
    level rounds the Shortley-Weller weights in float32 (``_ops_b``'s
    ``f32``), as ``solvers/multigrid_dyn.py`` does."""
    _, hl, wl = u.shape
    nsum, inv_d, _ = _ops_b(lv.h, lv.w, lv.bh, lv.bw, u.device, f32=lv.dyn, origin=org,
                            local_hw=(hl, wl))
    dom = _domain(hl, wl, org[0], org[1], lv.h, lv.w, u.device)
    rows = org[0] + torch.arange(hl, device=u.device)[:, None]
    cols = org[1] + torch.arange(wl, device=u.device)[None, :]
    par = (rows + cols) % 2 == 0
    red, black = (par & dom)[None], (~par & dom)[None]
    for _ in range(n):
        u = torch.where(red, (nsum(u) - g) * inv_d, u)
        u = torch.where(black, (nsum(u) - g) * inv_d, u)
    return u


def _smooth(lv: _Level, iy: int, ix: int, x: torch.Tensor, gx: torch.Tensor, n: int):
    """n red-black sweeps of a _KG-ghosted tile; its outer 2n rings go stale.
    The plain level's sweeps are ``K.rb_sweeps_tile`` (one launch for n <= 4:
    the kernel on a CUDA tile, its twin on a CPU tile)."""
    r0, _, c0, _ = lv.box(iy, ix)
    org = (r0 - _KG, c0 - _KG)
    if lv.unit:
        return K.rb_sweeps_tile(x, gx, n, org, (lv.h, lv.w))
    return _sweeps_b_tile(x, gx, n, lv, org)


def _residual_window(lv: _Level, iy: int, ix: int, us: torch.Tensor, gp: torch.Tensor):
    """g - A u on the tile's 1-ghost window (``residual`` / ``_residual_b``,
    or on a runtime-domain level ``_residual_dyn``, elementwise), zero past
    the level. us: the tile after nu1 sweeps, exact but for its outer 2 nu1
    rings."""
    r0, r1, c0, c1 = lv.box(iy, ix)
    th, tw, k = r1 - r0, c1 - c0, _KG
    u2 = us[:, k - 2 : k + th + 2, k - 2 : k + tw + 2]
    u1 = u2[:, 1:-1, 1:-1]
    g1 = gp[:, k - 1 : k + th + 1, k - 1 : k + tw + 1]
    if lv.unit:
        r = g1 - (_neighbor_sum_padded(u2) - 4.0 * u1)
    else:
        nsum, inv_d, diag = _ops_b(lv.h, lv.w, lv.bh, lv.bw, us.device, f32=lv.dyn,
                                   origin=(r0 - 2, c0 - 2), local_hw=(th + 4, tw + 4))
        a_u = (diag[:, 1:-1, 1:-1] * u1) if lv.dyn else (u1 / inv_d[:, 1:-1, 1:-1])
        r = g1 - (nsum(u2)[:, 1:-1, 1:-1] - a_u)
    return torch.where(_domain(th + 2, tw + 2, r0 - 1, c0 - 1, lv.h, lv.w, us.device)[None],
                       r, 0.0)


def _along(x: torch.Tensor, dim: int, start: int, stop: int, step: int = 1) -> torch.Tensor:
    idx = [slice(None)] * x.dim()
    idx[dim] = slice(start, stop, step)
    return x[tuple(idx)]


def _restrict_win(r: torch.Tensor, dim: int, n: int, beta: float, s0: int, a: int,
                  b: int) -> torch.Tensor:
    """Full weighting along ``dim`` (-1 or -2) of a window whose index 0 is
    fine point s0, into coarse [a, b): ``_restrict_axis`` / ``_restrict_rows``
    elementwise, the even-size edge where the window holds coarse nc - 1."""
    m, o = b - a, 2 * a - s0
    out = (0.25 * _along(r, dim, o, o + 2 * m - 1, 2) + 0.5 * _along(r, dim, o + 1, o + 2 * m, 2)
           + 0.25 * _along(r, dim, o + 2, o + 2 * m + 1, 2))
    if n % 2 == 0 and b == (n - 1) // 2:
        gap, q = 2.0 + beta, n - 4 - s0
        edge = (0.25 * _along(r, dim, q, q + 1) + 0.5 * _along(r, dim, q + 1, q + 2)
                + ((1.0 + beta) / gap * 0.5) * _along(r, dim, q + 2, q + 3)
                + (beta / gap * 0.5) * _along(r, dim, q + 3, q + 4))
        out = torch.cat([_along(out, dim, 0, m - 1), edge], dim=dim)
    return out


def _prolong_win(e: torch.Tensor, dim: int, n: int, beta: float, a: int, f0: int,
                 f1: int) -> torch.Tensor:
    """Bilinear prolongation along ``dim`` of a coarse window whose index 0 is
    coarse point a - 1 (zeros past the coarse grid), into fine [f0, f1):
    ``_prolong_axis`` / ``_prolong_rows`` elementwise, the even-size edge
    where the window holds fine n - 1."""
    length = e.shape[dim]
    mids = 0.5 * (_along(e, dim, 0, length - 1) + _along(e, dim, 1, length))
    pairs = torch.stack([mids, _along(e, dim, 1, length)], dim=dim)
    shape = list(mids.shape)
    shape[dim] = 2 * (length - 1)
    out = _along(pairs.reshape(shape), dim, f0 - 2 * a, f1 - 2 * a)
    if n % 2 == 0 and f1 == n:
        gap, nc = 2.0 + beta, (n - 1) // 2
        last = _along(e, dim, nc - a, nc - a + 1)
        out = torch.cat([_along(out, dim, 0, n - 2 - f0), last * ((1.0 + beta) / gap),
                         last * (beta / gap)], dim=dim)
    return out


class _Sharded:
    """A partitioned V-cycle over a mesh: its levels (element, or
    runtime-domain when the levels carry ``padded_hw``), the first local
    device and the coarsest levels' basis cache."""

    def __init__(self, mesh: TileMesh, levels: list[_Level], eig_cache: dict | None):
        self.mesh, self.levels, self.eig_cache = mesh, levels, eig_cache
        self.dev0 = mesh.distinct()[0]

    def map(self, fn, *grids):
        return map_local(self.mesh, fn, *grids)

    def _gathered(self, nxt: _Level, rc_all: torch.Tensor) -> torch.Tensor:
        """The rest of the V-cycle below the partitioned levels, on one
        device's whole coarse RHS: the element ``vcycle`` or ``vcycle_dyn``."""
        if nxt.dyn:
            return vcycle_dyn(None, rc_all, *nxt.padded_hw, nxt.bh, nxt.bw, _NU1, _NU2,
                              use_pallas=False)
        return vcycle(torch.zeros_like(rc_all), rc_all, _NU1, _NU2, _COARSEST, False, nxt.bh,
                      nxt.bw, self.eig_cache, u_zero=True)

    def cycle(self, l: int, u, g, gp):
        """One V-cycle at level l from u (a tile grid, or None: zero) on the
        RHS tiles g (gp: their _KG-ghosted windows, or None: exchanged
        here). Returns the level's tiles."""
        lv, nxt, k, mesh = self.levels[l], self.levels[l + 1], _KG, self.mesh
        if gp is None:
            gp = halo_exchange(g, k, mesh)
        if u is None:
            up = self.map(lambda iy, ix, x: torch.zeros_like(x), gp)
        else:
            up = halo_exchange(u, k, mesh)
        us = self.map(lambda iy, ix, x, gx: _smooth(lv, iy, ix, x, gx, _NU1), up, gp)

        def post(iy, ix, x, gx):
            r0, r1, c0, c1 = lv.box(iy, ix)
            return _smooth(lv, iy, ix, x, gx, _NU2)[:, k : k + r1 - r0, k : k + c1 - c0]

        if nxt.h < 1 or nxt.w < 1:  # an empty coarse level: a zero correction
            return self.map(post, us, gp)

        def coarse_rhs(iy, ix, x, gx):
            r0, r1, c0, c1 = lv.box(iy, ix)
            a, b, ac, bc = nxt.box(iy, ix)
            r = _restrict_win(_residual_window(lv, iy, ix, x, gx), -1, lv.w, lv.bw, c0 - 1, ac,
                              bc)
            return 4.0 * _restrict_win(r, -2, lv.h, lv.bh, r0 - 1, a, b)

        rc = self.map(coarse_rhs, us, gp)
        if nxt.sharded:
            ecw = halo_exchange(self.cycle(l + 1, None, rc, None), 1, mesh)
        else:  # gathered: the rest of the cycle once per device of this process
            c = next(t for row in rc for t in row if t is not None).shape[0]
            ecp = {dev: F.pad(self._gathered(nxt, rc_all), (1, 1, 1, 1))
                   for dev, rc_all in replicate(rc, mesh, nxt.shape_of(c)).items()}

            def window(iy, ix, x):
                a, b, ac, bc = nxt.box(iy, ix)
                return ecp[x.device][:, a : b + 2, ac : bc + 2]

            ecw = self.map(window, us)

        def correct(iy, ix, x, e):
            r0, r1, c0, c1 = lv.box(iy, ix)
            a, _, ac, _ = nxt.box(iy, ix)
            ef = _prolong_win(_prolong_win(e, -1, lv.w, lv.bw, ac, c0, c1), -2, lv.h, lv.bh, a,
                              r0, r1)
            return x[:, k : k + r1 - r0, k : k + c1 - c0] + ef

        up = halo_exchange(self.map(correct, us, ecw), k, mesh)
        return self.map(post, up, gp)

    def residual_max(self, u, g_own) -> torch.Tensor:
        """max |g - A u| of the finest level over every tile (a 1-ghost
        exchange; ``residual`` elementwise), on the first device."""
        up = halo_exchange(u, 1, self.mesh)
        maxima = self.map(lambda iy, ix, x, xp, gl: (
            gl - (_neighbor_sum_padded(xp) - 4.0 * x)).abs().max(), u, up, g_own)
        return grid_max([m for row in maxima for m in row if m is not None], self.dev0,
                        self.mesh)

    def gmax(self, g_own) -> torch.Tensor:
        """max |g| over every tile, on the first device."""
        return grid_max([t.abs().max() for row in g_own for t in row if t is not None],
                        self.dev0, self.mesh)


def _levels(lv0: _Level) -> list[_Level]:
    """The partitioned levels from lv0 down, and the first gathered one."""
    levels = [lv0]
    while levels[-1].sharded:
        levels.append(levels[-1].coarser())
    return levels


def _solve_whole(g_tiles, tiling: Tiling, mesh: TileMesh, return_info: bool, solve):
    """A grid too small to partition: g joined on every device of this
    process (``transport.replicate``), ``solve`` there, each tile its window
    of u (and the info of the solve)."""
    c = next(t for row in g_tiles for t in row if t is not None).shape[0]
    whole, info = {}, None
    for dev, g in replicate(g_tiles, mesh, tiling.shape_of(c)).items():
        res = solve(g)
        whole[dev], info = res if return_info else (res, None)
    u = tiling.windows_of(whole, mesh)
    return (u, info) if return_info else u


def _zeros_like_tiles(g_tiles, mesh: TileMesh):
    return map_local(mesh, lambda iy, ix, t: torch.zeros_like(t), g_tiles)


def solve_multigrid_sharded(g: torch.Tensor, mesh: TileMesh, tol: float = 1e-4,
                            max_cycles: int = 60, cycles: int | None = None,
                            return_info: bool = False, eig_cache=None):
    """Multigrid V-cycles with every level partitioned over ``mesh`` (JAX's
    GSPMD path, partitioned by hand).

    JAX jits ``solve_multigrid(g, tol, max_cycles, cycles)`` with tile
    shardings, which runs its element path (``use_pallas=False``: V(1, 2),
    coarsest 63) and lets XLA partition every stencil. This is that solve
    with the partitioning written out, bit-equal to the port's
    ``solve_multigrid(g, tol, max_cycles, cycles=cycles, use_pallas=False)``
    on one device, with the same cycle count, on any mesh shape:

    - each level's u, g and residual stay tiled: the finest level split in
      ceil(n / t) rows and columns (``sharded_tiling``: the last tile
      shorter), each coarse tile the coarse points whose fine point 2j + 1
      its fine tile owns;
    - each stencil reads its neighbours through a ghost exchange
      (``parallel/transport.py``): one of 4 rings before the nu1 sweeps and
      the residual window, one of 1 ring for the coarse correction's window,
      one of 4 before the nu2 sweeps (one ``rb_sweeps_tile`` launch each on
      a plain level, its twin on CPU tiles; the beta levels' sweeps and
      every transfer are per-tile torch ops), colours and the
      Shortley-Weller edges from global coordinates;
    - a level whose tiles are shorter than ``SHARD_MIN`` on a side, and the
      coarsest (``_small``) level, is gathered (``transport.replicate``) and
      solved by the element ``vcycle`` once per device of this process;
      each tile takes its window of the correction (XLA's resharding of the
      coarse levels).

    Fixed ``cycles``, or the tolerance loop: ``_tol_burst`` check-free
    cycles, then one max |g - A u| a check (all-reduced over the mesh, one
    host read on every rank) until it is <= tol max |g| or ``max_cycles``.
    A grid too small to partition is joined and solved whole on each device
    of this process (``solve_multigrid_sharded_tiles``). On a mesh that spans processes every process passes the
    same global g and gets the whole u. Returns u (C, H, W) on g's device;
    ``return_info`` adds {"cycles", "residual"}. ``eig_cache``: see
    ``solvers/multigrid.py:coarse_solve``. ``solve_multigrid_sharded_tiles``
    is the same solve on tiles.
    """
    c, h, w = g.shape
    tiling = sharded_tiling(h, w, mesh)
    res = solve_multigrid_sharded_tiles(tiling.split(g, mesh), (h, w), mesh, tol, max_cycles,
                                        cycles, return_info, eig_cache)
    u, info = res if return_info else (res, None)
    out = transport.gather(u, g.device, mesh, tiling.shape_of(c))
    return (out, info) if return_info else out


def solve_multigrid_sharded_tiles(g_tiles, hw: tuple[int, int], mesh: TileMesh,
                                  tol: float = 1e-4, max_cycles: int = 60,
                                  cycles: int | None = None, return_info: bool = False,
                                  eig_cache=None):
    """``solve_multigrid_sharded`` with g as this process's tiles of
    ``sharded_tiling(h, w, mesh)`` and u returned as tiles of the same
    tiling: bit for bit the same solve. A grid too small to partition is
    joined on every device of this process (``transport.replicate``),
    solved whole there, and each tile takes its window."""
    tol = float(tol)
    h, w = hw
    tiling = sharded_tiling(h, w, mesh)
    _check_tiles(g_tiles, tiling, mesh)
    if eig_cache is None:
        eig_cache = {}
    levels = _levels(_Level(h, w, 1.0, 1.0, tiling.rows, tiling.cols))
    if len(levels) == 1:
        return _solve_whole(g_tiles, tiling, mesh, return_info, lambda g: solve_multigrid(
            g, tol=tol, max_cycles=max_cycles, cycles=cycles, use_pallas=False,
            return_info=return_info, eig_cache=eig_cache))
    run = _Sharded(mesh, levels, eig_cache)
    gp = halo_exchange(g_tiles, _KG, mesh)
    g_own = g_tiles
    u = None  # a known-zero start
    if cycles is not None:
        it = int(cycles)
        for _ in range(it):
            u = run.cycle(0, u, g_own, gp)
    else:
        gmax = run.gmax(g_own)
        thresh = tol * torch.clamp(gmax, min=1e-30)
        it = _tol_burst(tol, max_cycles, _NU1, _NU2)
        for _ in range(it):
            u = run.cycle(0, u, g_own, gp)
        while it < max_cycles:
            rmax = gmax if u is None else run.residual_max(u, g_own)
            if not bool(rmax > thresh):  # one host read per check, on every rank
                break
            u = run.cycle(0, u, g_own, gp)
            it += 1
    out = _zeros_like_tiles(g_tiles, mesh) if u is None else u
    if return_info:
        rmax = (run.gmax(g_own) if u is None else run.residual_max(u, g_own)).item()
        return out, {"cycles": it, "residual": rmax}
    return out


def solve_multigrid_dyn_sharded(g: torch.Tensor, hw, mesh: TileMesh, tol: float = 1e-4,
                                cycles: int | None = None, max_cycles: int = 60,
                                return_info: bool = False):
    """``solve_multigrid_dyn`` partitioned over ``mesh`` (JAX's
    ``solve_multigrid_dyn`` jitted with tile shardings, partitioned by hand).

    g: (C, Hp, Wp) f32, the RHS of the (h, w) interior system at [0, h) x
    [0, w), hw = (h, w). The true-size levels are split as
    ``solve_multigrid_sharded`` splits its levels (``sharded_tiling`` of (h,
    w), coarse tiles by the fine point 2j + 1), and each cycle is
    ``vcycle_dyn`` with the partitioning written out:

    - the depth follows the padded levels ((Hp - 1) // 2, ...); a level
      whose padded size is small is the bottom;
    - the operator pieces are the runtime-domain ones: the Shortley-Weller
      weights rounded in float32, the residual g - (nsum(u) - diag u); the
      plain (betas 1) level's sweeps are ``K.rb_sweeps_tile`` at the global
      origin (the kernel on CUDA tiles, its twin on CPU tiles);
    - a level whose tiles are shorter than ``SHARD_MIN`` on a side, and the
      bottom, is gathered (``transport.replicate``) and the rest of the
      cycle is ``vcycle_dyn`` on each device of this process: the bottom's
      ``BOTTOM_SWEEPS`` red-black sweeps, an empty level's zero correction;
    - the tolerance check runs before every cycle (one host read on every
      rank), no check-free burst; ``cycles=k`` runs k cycles unchecked.

    Bit-equal to the port's ``solve_multigrid_dyn(g, hw, tol, cycles,
    max_cycles, use_pallas=False)`` on one device, with the same cycle
    count, on any mesh shape; a mesh that spans processes gives every rank
    the whole u. Returns (C, Hp, Wp), exact zeros outside the true domain,
    on g's device; ``return_info`` adds {"cycles", "residual"}.
    """
    c, hp, wp = g.shape
    h, w = (max(int(x), 0) for x in hw)
    if h > hp or w > wp:
        raise ValueError(f"true size {(h, w)} exceeds the padded {(hp, wp)}")
    tiling = sharded_tiling(h, w, mesh)
    res = solve_multigrid_dyn_sharded_tiles(tiling.split(g[:, :h, :w], mesh), (h, w), (hp, wp),
                                            mesh, tol, cycles, max_cycles, return_info)
    u, info = res if return_info else (res, None)
    out = _pad_to(transport.gather(u, g.device, mesh, tiling.shape_of(c)), g.shape)
    return (out, info) if return_info else out


def solve_multigrid_dyn_sharded_tiles(g_tiles, hw: tuple[int, int], padded_hw,
                                      mesh: TileMesh, tol: float = 1e-4,
                                      cycles: int | None = None, max_cycles: int = 60,
                                      return_info: bool = False):
    """``solve_multigrid_dyn_sharded`` on the true-size RHS as this
    process's tiles of ``sharded_tiling(h, w, mesh)``; returns u as tiles of
    the same tiling (``solve_dyn_window``'s u, partitioned). A grid too
    small to partition is joined on every device of this process
    (``transport.replicate``), solved whole there by ``solve_dyn_window``,
    and each tile takes its window."""
    tol = float(tol)
    h, w = hw
    hp, wp = (int(x) for x in padded_hw)
    tiling = sharded_tiling(h, w, mesh)
    _check_tiles(g_tiles, tiling, mesh)
    lv0 = _Level(h, w, 1.0, 1.0, tiling.rows, tiling.cols, (hp, wp))
    if not lv0.sharded:
        return _solve_whole(g_tiles, tiling, mesh, return_info, lambda g: solve_dyn_window(
            g, (hp, wp), tol, cycles, max_cycles, return_info=return_info, use_pallas=False))
    run = _Sharded(mesh, _levels(lv0), None)
    gp = halo_exchange(g_tiles, _KG, mesh)
    u, it = None, 0
    gmax = run.gmax(g_tiles)
    rmax = gmax  # the residual of the zero start
    if cycles is not None:
        it = int(cycles)
        for _ in range(it):
            u = run.cycle(0, u, g_tiles, gp)
        if return_info and it:
            rmax = run.residual_max(u, g_tiles)
    else:
        thresh = tol * torch.clamp(gmax, min=1e-30)
        # checked before every cycle; one host read per check, on every rank
        while it < max_cycles and bool(rmax > thresh):
            u = run.cycle(0, u, g_tiles, gp)
            it += 1
            rmax = run.residual_max(u, g_tiles)
    out = _zeros_like_tiles(g_tiles, mesh) if u is None else u
    return (out, {"cycles": it, "residual": rmax.item()}) if return_info else out
