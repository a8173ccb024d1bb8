"""The fused transfers of the transposed multigrid chain on the CPU.

``vcycle_t`` runs each level as two kernels: ``mg_down_t`` (csrc/mg_down.cu:
the level's sweeps, residual and row restriction with the transposed lane
restriction of ``mg_restrict_t`` folded in) and ``mg_up_t`` (csrc/mg_up.cu:
the lane prolongation of ``mg_prolong_t`` folded in front of the ascent).
The kernels do not run here, so this file

- replays ``mg_down_t``'s blocks in numpy float32 (the rings and the band's
  reach parsed from the source, the same rectangles and operation order):
  every element of u and rc_t written exactly once, the band of rc_t that
  no tile covers included; u exact, after the sweeps, on every column the
  restriction reads, for every nu1; each replayed block's outputs equal to
  the plain twin's bit for bit; and the band of the standalone descent is
  one column too narrow for it;
- replays ``mg_up_t``'s window of ec_t: it holds every (k, l) that the
  block's rows of e read, and the rows of e it computes equal, bit for bit,
  the rows the standalone ascent stages from ``mg_prolong_t``'s output;
- checks that the fused kernels' shared-memory reads and writes are free
  of bank conflicts;
- holds ``K.mg_down_t`` / ``K.mg_up_t`` on the CPU against the JAX
  package's ``mg_down_pallas`` -> ``mg_restrict_t_pallas`` and
  ``mg_prolong_t_pallas`` -> ``mg_up_pallas`` run with ``interpret=True``,
  and ``vcycle_t`` against JAX's ``vcycle_t``.

The replays run at the 8K frame's ``"t"`` levels and ``"q"`` coarse levels,
the headline's, and small levels with odd and even sides and betas != 1.
Tolerances against JAX are those of ``tests/test_torch_multigrid.py``: rtol
3e-6 with an absolute floor of 1e-6 max |ref| for the kernels (XLA may
contract a multiply and an add into one FMA), rel 1e-5 for a whole V-cycle
(the coarsest level's GEMM summation order). Inputs are numpy-seeded.
"""

import functools
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seamlesscloneoptimization_tpu.ops import pallas_kernels as PK
from seamlesscloneoptimization_tpu.solvers import multigrid as JM
from seamlesscloneoptimization_tpu_torch.ops import kernels as K
from seamlesscloneoptimization_tpu_torch.solvers import multigrid as TM

torch.set_num_threads(1)

F32 = np.float32
CSRC = Path(K.__file__).resolve().parent.parent / "csrc"
DOWN_SRC = (CSRC / "mg_down.cu").read_text()
UP_SRC = (CSRC / "mg_up.cu").read_text()
THREADS = 256
WARP = 32
DTH, DTW = 32, 64  # DownTile's owned tile
RINGS = {name: tuple(int(v) for v in re.search(
    rf"using {name} = DownTile<(\d+), (\d+), (\d+), (\d+)>;", DOWN_SRC).groups())
    for name in ("Shallow", "Deep")}
# N's reach right of the owned tile in the fused descent's half-sweeps
K_RIGHT = int(re.search(r"mg_down_t_kernel.*?sweeps_down<T, (\d+)>", DOWN_SRC, re.S).group(1))
RH_W = int(re.search(r"constexpr int kRhW = (\d+);", DOWN_SRC).group(1))
_odd = re.search(r"constexpr int kOdd = (\d+) \* kRhW \+ (\d+);", DOWN_SRC).groups()
RH_ODD = int(_odd[0]) * RH_W + int(_odd[1])
UP_RINGS = [int(v) for v in re.findall(r"return launch_ring_t<(\d+)>", UP_SRC)]  # nu2 <= 2, else


def down_ring(nu1):
    return RINGS["Shallow"] if nu1 <= 1 else RINGS["Deep"]


# the frames' levels: 8K (interior 2798 x 3798), the headline (1548 x 2396)
FRAME_LEVELS = [(f"{frame} {chain} {i}", lv)
                for frame, hw in (("8K", (2798, 3798)), ("headline", (1548, 2396)))
                for chain, levels in (("t", TM.t_levels(*hw)), ("q", TM.q_coarse_levels(*hw)))
                for i, lv in enumerate(levels)]
# small levels: even h and w; odd h and w; even h, odd w; w - 1 = 65 and
# 129, the even-w edge column at a tile's right end; rc_t rows past the
# tiles (256 > 192)
SMALL_LEVELS = [(f"small {h}x{w}", (h, w, bh, bw, K.mg_geometry_t(h, w))) for h, w, bh, bw in (
    (70, 200, 1.0, 2.0), (129, 257, 2.0, 1.0), (134, 99, 1.9375, 1.4375), (63, 66, 1.5, 1.25),
    (33, 130, 1.25, 1.75), (150, 300, 1.75, 1.5))]
ALL_LEVELS = FRAME_LEVELS + SMALL_LEVELS


def test_the_frames_have_their_levels():
    assert [n for n, _ in FRAME_LEVELS] == ["8K t 0", "8K t 1", "8K t 2", "8K t 3", "8K q 0",
                                            "8K q 1", "8K q 2", "headline t 0", "headline t 1",
                                            "headline t 2", "headline q 0", "headline q 1"]


def _out_rows(lv):
    h, w, _, _, (_, _, _, hp2) = lv
    return K.mg_geometry_t((w - 1) // 2, (h - 1) // 2, wp_min=hp2)[1]


def _stage(x, gr0, gc0, rows, cols):
    """x (H, W) -> the (rows, cols) window at (gr0, gc0), zeros off x."""
    out = np.zeros((rows, cols), F32)
    hh, ww = x.shape
    a0, a1 = max(gr0, 0), min(gr0 + rows, hh)
    b0, b1 = max(gc0, 0), min(gc0 + cols, ww)
    if a0 < a1 and b0 < b1:
        out[a0 - gr0 : a1 - gr0, b0 - gc0 : b1 - gc0] = x[a0:a1, b0:b1]
    return out


def _band(g_lo, g_hi, n, g0, k):
    return max(max(g_lo, 0) - g0, 1), min(min(g_hi, n) - g0, k - 1)


class Op:
    """The level operator on a staged tile, in mg_level.cuh's order."""

    def __init__(self, h, w, bh, bw):
        self.h, self.w = h, w
        self.uniform, *consts = K._level_consts(bh, bw)
        self.cuh, self.cuw, self.dh, self.dw = (F32(v) for v in consts)

    def nsum(self, s, lr, lc, gr, gc):
        up, dn, lf, rt = s[lr - 1, lc], s[lr + 1, lc], s[lr, lc - 1], s[lr, lc + 1]
        n = ((up + dn) + lf) + rt
        if not self.uniform:
            n = ((n + np.where(gr == self.h - 1, self.cuh, F32(0)) * up)
                 + np.where(gc == self.w - 1, self.cuw, F32(0)) * lf)
        return n

    def diag(self, gr, gc):
        if self.uniform:
            return np.full(np.broadcast(gr, gc).shape, 4, F32)
        return (np.where(gr == self.h - 1, self.dh, F32(2))
                + np.where(gc == self.w - 1, self.dw, F32(2)))


def _slabs(lv, c, seed):
    h, w, _, _, (_, hp, wp, _) = lv
    rng = np.random.default_rng(seed)
    g = np.zeros((c, hp, wp), F32)
    u = np.zeros((c, hp, wp), F32)
    g[:, :h, :w] = rng.normal(size=(c, h, w)) * 50
    u[:, :h, :w] = rng.normal(size=(c, h, w)) * 10
    return g, u


# ---------------------------------------------------------------------------
# mg_down_t
# ---------------------------------------------------------------------------


def down_t_block(u, g, ch, by, bx, nu1, lv, out_rows, ring, k_right, u_swept):
    """One block of mg_down_t_kernel<DownTile<ring>>, replayed. Returns
    (the owned tile of u, the block's (32, 16) tile of rc_t, whether u was
    exact on N after the sweeps)."""
    h, w, bh, bw, _ = lv
    t, b, l, r = ring
    rows, cols = DTH + t + b, DTW + l + r
    op = Op(h, w, bh, bw)
    r0, c0 = by * DTH, bx * DTW
    gr0, gc0 = r0 - t, c0 - l
    sg = _stage(g[ch], gr0, gc0, rows, cols)
    su = np.zeros((rows, cols), F32) if u is None else _stage(u[ch], gr0, gc0, rows, cols)
    d = 2 * nu1
    for s in range(nu1):
        for color in (0, 1):
            d -= 1
            rlo, rhi = _band(r0 - 1 - d, r0 + DTH + 2 + d, h, gr0, rows)
            clo, chi = _band(c0 - 1 - d, c0 + DTW + k_right + d, w, gc0, cols)
            if rlo >= rhi or clo >= chi:
                continue
            lr, lc = np.arange(rlo, rhi)[:, None], np.arange(clo, chi)[None, :]
            gr, gc = gr0 + lr, gc0 + lc
            zero = u is None and s == 0 and color == 0
            n = F32(0) if zero else op.nsum(su, lr, lc, gr, gc)
            new = (n - sg[lr, lc]) * (F32(1) / op.diag(gr, gc))
            su[lr, lc] = np.where((lr + lc) % 2 == color, new, su[lr, lc])
    # N: the owned rows widened by one above and two below, the owned
    # columns by one left and K_RIGHT right, cut to the domain
    n_r = slice(max(r0 - 1, 0), min(r0 + DTH + 2, h))
    n_c = slice(max(c0 - 1, 0), min(c0 + DTW + K_RIGHT, w))
    exact = np.array_equal(
        su[n_r.start - gr0 : n_r.stop - gr0, n_c.start - gc0 : n_c.stop - gc0],
        u_swept[ch, n_r, n_c]) if n_r.start < n_r.stop and n_c.start < n_c.stop else True
    # the residual of rows r0 .. r0 + 33 and columns c0 .. c0 + 65
    rr, cc = np.arange(DTH + 2)[:, None], np.arange(DTW + 2)[None, :]
    lr, lc, gr, gc = t + rr, l + cc, r0 + rr, c0 + cc
    res = sg[lr, lc] - (op.nsum(su, lr, lc, gr, gc) - op.diag(gr, gc) * su[lr, lc])
    res = np.where((gr < h) & (gc < w), res, F32(0))
    rh = (F32(0.25) * res[0:32:2] + F32(0.5) * res[1:32:2]) + F32(0.25) * res[2:33:2]
    hc, wc = (h - 1) // 2, (w - 1) // 2
    gap = 2.0 + bh
    c1, c2 = F32(K._f32((1.0 + bh) / gap * 0.5 - 0.25)), F32(K._f32(bh / gap * 0.5))
    if h % 2 == 0 and 0 <= hc - 1 - r0 // 2 < 16:
        k = hc - 1 - r0 // 2
        rh[k] = (rh[k] + c1 * res[2 * k + 2]) + c2 * res[2 * k + 3]
    # the lane restriction, transposed
    c5, c6, _, _ = (F32(v) for v in K._edge_weights_w(bw))
    jj, ll = np.arange(DTW // 2)[:, None], np.arange(DTH // 2)[None, :]
    a, bb = rh[ll, 2 * jj], rh[ll, 2 * jj + 1]
    a1, b1 = rh[ll, 2 * jj + 2], rh[ll, 2 * jj + 3]
    ab = a + F32(2) * bb
    j, lane = c0 // 2 + jj, r0 // 2 + ll
    v = np.where((w % 2 == 0) & (j == wc - 1), (ab + c5 * a1) + c6 * b1, ab + a1)
    v = np.where((j < wc) & (lane < hc), v, F32(0))
    return su[t : t + DTH, l : l + DTW], v, exact


def down_t_writes(c, hp, wp, hp2, out_rows):
    """The writes of every block of mg_down_t_kernel, counted: (u_out
    counts, rc_t counts, rc_t's uncovered band as a mask)."""
    gx, gy = -(-wp // DTW), -(-hp // DTH)
    n_u = np.zeros((c, hp, wp), np.int32)
    n_rc = np.zeros((c, out_rows, hp2), np.int32)
    for by in range(gy):
        for bx in range(gx):
            n_u[:, by * DTH : (by + 1) * DTH, bx * DTW : (bx + 1) * DTW] += 1
            n_rc[:, bx * DTW // 2 : (bx + 1) * DTW // 2, by * DTH // 2 : (by + 1) * DTH // 2] += 1
    # the zero band, as the kernel's grid-stride loops write it: float4 i of
    # the whole rows j >= jc, then float4 i of lanes l >= lz of rows j < jc
    jc, lz = min(gx * DTW // 2, out_rows), min(gy * DTH // 2, hp2)
    band = np.zeros((out_rows, hp2), bool)
    flat = n_rc.reshape(c, -1)
    i = np.arange((out_rows - jc) * hp2 // 4)
    for k in range(4):
        flat[:, jc * hp2 + 4 * i + k] += 1
    lanes4 = (hp2 - lz) // 4
    i = np.arange(jc * lanes4)
    for k in range(4):
        flat[:, (i // lanes4) * hp2 + lz + 4 * (i % lanes4) + k] += 1
    band[jc:] = True
    band[:jc, lz:] = True
    return n_u, n_rc, band


@pytest.mark.parametrize("name,lv", ALL_LEVELS)
def test_down_t_writes_every_element_once(name, lv):
    """Every element of u and of rc_t (C, out_rows, hp2) written exactly
    once, the uncovered band included; the band lies where rc_t is zero
    (j >= wc or l >= hc)."""
    h, w, _, _, (_, hp, wp, hp2) = lv
    out_rows = _out_rows(lv)
    n_u, n_rc, band = down_t_writes(1, hp, wp, hp2, out_rows)
    assert (n_u == 1).all() and (n_rc == 1).all()
    j, lane = np.nonzero(band)
    assert ((j >= (w - 1) // 2) | (lane >= (h - 1) // 2)).all()
    if name in ("8K q 0", "small 150x300"):  # the levels whose rc_t overhangs the tiles
        assert band.any()


def _blocks(lv, every):
    """The blocks to replay: all of them, or the tile rows and columns at
    the slab's edges and around the domain's last row and column."""
    h, w, _, _, (_, hp, wp, _) = lv
    gx, gy = -(-wp // DTW), -(-hp // DTH)
    if every:
        return [(by, bx) for by in range(gy) for bx in range(gx)]
    rows = {0, 1, gy - 1} | {min(max((h - 1) // DTH + k, 0), gy - 1) for k in (-1, 0, 1)}
    cols = {0, 1, gx - 1} | {min(max((w - 1) // DTW + k, 0), gx - 1) for k in (-1, 0, 1)}
    return [(by, bx) for by in sorted(rows) for bx in sorted(cols)]


@functools.lru_cache(maxsize=None)
def _down_t_twin(name, nu1, zero_guess):
    lv = dict(ALL_LEVELS)[name]
    h, w, bh, bw, _ = lv
    c = 2 if name.startswith("small") else 1
    g, u = _slabs(lv, c, h * w + nu1)
    u_in = None if zero_guess else u
    u_t = None if zero_guess else torch.from_numpy(u)
    uo, rc = K.mg_down_t_plain(u_t, torch.from_numpy(g), nu1, h, w, bh, bw, _out_rows(lv))
    return g, u_in, uo.numpy(), rc.numpy()


def _check_down_t(name, nu1, zero_guess, k_right=K_RIGHT):
    """(u exact on N in every replayed block, every replayed output equal to
    the twin's)."""
    lv = dict(ALL_LEVELS)[name]
    g, u, u_want, rc_want = _down_t_twin(name, nu1, zero_guess)
    _, _, _, _, (_, hp, wp, hp2) = lv
    out_rows = _out_rows(lv)
    exact = equal = True
    for ch in range(g.shape[0]):
        for by, bx in _blocks(lv, name.startswith("small")):
            u_t, rc_t, ok = down_t_block(u, g, ch, by, bx, nu1, lv, out_rows, down_ring(nu1),
                                         k_right, u_want)
            r0, c0, j0, l0 = by * DTH, bx * DTW, bx * DTW // 2, by * DTH // 2
            hh, ww = min(DTH, hp - r0), min(DTW, wp - c0)
            jn, ln = max(min(DTW // 2, out_rows - j0), 0), max(min(DTH // 2, hp2 - l0), 0)
            exact &= ok
            equal &= (np.array_equal(u_t[:hh, :ww].view(np.uint32),
                                     u_want[ch, r0 : r0 + hh, c0 : c0 + ww].view(np.uint32))
                      and np.array_equal(rc_t[:jn, :ln].view(np.uint32),
                                         rc_want[ch, j0 : j0 + jn, l0 : l0 + ln].view(np.uint32)))
    return exact, equal


@pytest.mark.parametrize("zero_guess", [True, False])
@pytest.mark.parametrize("nu1", [0, 1, 2])
@pytest.mark.parametrize("name", [n for n, _ in SMALL_LEVELS])
def test_down_t_small_levels_match_plain(name, nu1, zero_guess):
    """Every block: u exact on every column the restriction reads, u and
    rc_t bit-equal to mg_down_t_plain (= mg_restrict_t_plain of
    mg_down_plain's rh)."""
    assert _check_down_t(name, nu1, zero_guess) == (True, True)


@pytest.mark.parametrize("nu1", [1, 2])
@pytest.mark.parametrize("name", [n for n, _ in FRAME_LEVELS])
def test_down_t_frame_levels_match_plain(name, nu1):
    """The frames' levels (the blocks at the edges of the slab and of the
    domain), each with the guess the chain gives it: the fine "t" level a
    given one, the coarse levels a known-zero one."""
    assert _check_down_t(name, nu1, not name.endswith("t 0")) == (True, True)


def test_down_t_needs_the_wider_band():
    """With the standalone descent's band (one column right of the tile),
    u goes stale on the column the restriction's last coarse column reads."""
    assert _check_down_t("small 63x66", 1, False, k_right=K_RIGHT - 1) != (True, True)


def test_down_t_rings_cover_the_sweeps():
    """Both rings keep their half-sweeps exact on the wider N: depth
    min(T - 1, B - 2, L - 1, R - K_RIGHT)."""
    for name, half_sweeps in (("Shallow", 2), ("Deep", 4)):
        t, b, l, r = RINGS[name]
        assert min(t - 1, b - 2, l - 1, r - K_RIGHT) >= half_sweeps


def _banks(addrs):
    """Whether a warp's shared accesses (word addresses) are conflict-free:
    lanes on one bank read one word."""
    by_bank = {}
    for a in addrs:
        by_bank.setdefault(a % 32, set()).add(a)
    return all(len(s) == 1 for s in by_bank.values())


def test_down_t_shared_rh_is_free_of_bank_conflicts():
    """The residual walk's writes (a warp: 32 columns of one rh row) and the
    restriction's reads (a half-warp along l for each of two coarse
    columns) each touch 32 distinct banks."""
    for warp in range(THREADS // WARP):
        t = np.arange(warp * WARP, (warp + 1) * WARP)
        cc, q = t % DTW, t // DTW
        for k in range(4):
            assert _banks(np.where(cc & 1, RH_ODD, 0) + (4 * q + k) * RH_W + (cc >> 1))
    for warp in range(DTW // 2 * DTH // 2 // WARP):
        i = np.arange(warp * WARP, (warp + 1) * WARP)
        jj, ll = i // (DTH // 2), i % (DTH // 2)
        for base in (0, RH_ODD):
            for dj in (0, 1):
                assert _banks(base + ll * RH_W + jj + dj)
    assert RH_ODD >= 16 * RH_W and RH_W >= DTW // 2 + 1


# ---------------------------------------------------------------------------
# mg_up_t
# ---------------------------------------------------------------------------


def _up_tile(ring):
    k_tw, k_rows = 64 - 2 * ring, DTH + 2 * ring
    return k_tw, k_rows // 2 + 1  # owned columns, rows of e


def up_t_window(ec, ch, by, bx, ring, lv, hp_c, lanes):
    """One block of mg_up_t_kernel<UpTile<ring>>: the rows of e it computes
    from its window of ec_t, and whether the window held every (k, l) they
    read."""
    h, w, _, bw, (_, _, wp, _) = lv
    k_tw, k_erows = _up_tile(ring)
    k_k = 64 // 2 + 1
    r0, c0 = by * DTH, bx * k_tw
    gr0, gc0 = r0 - ring, c0 - ring
    qa, kb = gr0 // 2 - 1, gc0 // 2 - 1
    hc, wc = (h - 1) // 2, (w - 1) // 2
    k, lane = kb + np.arange(k_k)[:, None], qa + np.arange(k_erows)[None, :]
    ok = (k >= 0) & (k < hp_c) & (lane >= 0) & (lane < min(hc, lanes))
    sw = np.where(ok, ec[ch][np.clip(k, 0, hp_c - 1), np.clip(lane, 0, lanes - 1)], F32(0))
    x = gc0 + np.arange(64)[None, :]
    qq = np.arange(k_erows)[:, None]
    valid = (x >= 0) & (x < w)
    kk = x // 2 - kb
    edge = (w % 2 == 0) & (x >= w - 2)
    even = (x % 2 == 0) & ~edge
    need = np.concatenate([kk[valid & ~edge], kk[valid & even] - 1,
                           np.full(int((valid & edge).sum()), wc - 1 - kb)])
    held = need.size == 0 or (need.min() >= 0 and need.max() < k_k)
    kk = np.clip(kk, 1, k_k - 1)
    _, _, c7, c8 = (F32(v) for v in K._edge_weights_w(bw))
    last = sw[min(max(wc - 1 - kb, 0), k_k - 1)][:, None]
    v = np.where(edge, np.where(x == w - 2, last * c7, last * c8),
                 np.where(x % 2 == 0, F32(0.5) * (sw[kk - 1, qq] + sw[kk, qq]), sw[kk, qq]))
    return np.where(valid, v, F32(0)), held, (qa, gc0)


@functools.lru_cache(maxsize=None)
def _up_t_inputs(name):
    """ec_t as the child level leaves it (the coarse solution (wc, hc) at
    the origin), with junk on lanes >= hc, which both forms ignore; and the
    lane-prolonged e of the standalone chain."""
    lv = dict(ALL_LEVELS)[name]
    h, w, _, bw, (_, hp, wp, hp2) = lv
    hc, wc = (h - 1) // 2, (w - 1) // 2
    chp, cwp = K.mg_geometry_t(wc, hc, wp_min=hp2)[1:3]
    c = 2 if name.startswith("small") else 1
    rng = np.random.default_rng(h + w)
    ec = np.zeros((c, chp, cwp), F32)
    ec[:, :wc, :hc] = rng.normal(size=(c, wc, hc)) * 5
    ec[:, :wc, hc:] = rng.normal(size=(c, wc, cwp - hc))
    e = K.mg_prolong_t_plain(torch.from_numpy(ec), w, bw, hp // 2, wp).numpy()
    return ec, e


@pytest.mark.parametrize("ring", UP_RINGS)
@pytest.mark.parametrize("name,lv", ALL_LEVELS)
def test_up_t_window_holds_the_rows_of_e(name, lv, ring):
    """Every block's window of ec_t holds every (k, l) its rows of e read,
    and the rows it computes are bit-equal to those the standalone ascent
    stages from mg_prolong_t's e (rows l >= hc and columns off the slab
    zero)."""
    h, w, _, _, (_, hp, wp, _) = lv
    ec, e = _up_t_inputs(name)
    k_tw, k_erows = _up_tile(ring)
    hc = (h - 1) // 2
    held = equal = True
    for ch in range(ec.shape[0]):
        for by in range(-(-hp // DTH)):
            for bx in range(-(-wp // k_tw)):
                se, ok, (qa, gc0) = up_t_window(ec, ch, by, bx, ring, lv, *ec.shape[1:])
                want = _stage(e[ch, :hc], qa, gc0, k_erows, 64)
                held &= ok
                equal &= np.array_equal(se.view(np.uint32), want.view(np.uint32))
    assert held and equal


def test_up_t_window_reads_are_free_of_bank_conflicts():
    """The rows of e are computed a warp a window lane: a thread the column
    pair x = gc0 + 2m, x + 1 (m the lane), reading coarse rows m and m + 1
    (kb = gc0 / 2 - 1); 32 rows of one lane fall on distinct banks, since
    the window's row stride is odd."""
    for ring in UP_RINGS:
        _, k_erows = _up_tile(ring)
        stride = k_erows | 1
        assert stride % 2 == 1
        m = np.arange(WARP)
        for qq in range(k_erows):
            for kk in (m, m + 1):
                assert _banks(kk * stride + qq)


@pytest.mark.parametrize("name", [n for n, _ in SMALL_LEVELS[:3]])
def test_up_t_twin_is_the_chain(name):
    """mg_up_t_plain = mg_up_plain of mg_prolong_t_plain for any out_rows in
    [hp // 2, lanes], bit for bit."""
    lv = dict(ALL_LEVELS)[name]
    h, w, bh, bw, (_, hp, wp, hp2) = lv
    ec, _ = _up_t_inputs(name)
    g, u = (torch.from_numpy(x) for x in _slabs(lv, ec.shape[0], 7))
    got = K.mg_up_t(u, g, torch.from_numpy(ec), 2, h, w, bh, bw)
    for rows in (hp // 2, hp2):
        e = K.mg_prolong_t_plain(torch.from_numpy(ec), w, bw, rows, wp)
        assert torch.equal(got, K.mg_up_plain(u, g, e, 2, h, w, bh, bw))


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------

JAX_CASES = [((70, 200), (1.0, 2.0)), ((63, 130), (1.5, 1.25))]


def _close(got, want, rtol=3e-6):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-6 * np.abs(want).max())


def _jax_level(hw, beta, seed):
    (h, w), (bh, bw) = hw, beta
    lv = (h, w, bh, bw, K.mg_geometry_t(h, w))
    g, u = _slabs(lv, 3, seed)
    return lv, g, u


@functools.lru_cache(maxsize=None)
def _jax_down_t(case, u_zero):
    hw, beta = JAX_CASES[case]
    lv, g, u = _jax_level(hw, beta, 31 + case)
    h, w, bh, bw, geom = lv
    ju, jrh = PK.mg_down_pallas(None if u_zero else jnp.asarray(u), jnp.asarray(g), 1, bh=bh,
                                bw=bw, interpret=True, blocked=True, padded_io=True,
                                true_hw=(h, w), u_zero=u_zero, geom=geom[:3], rh_rows=geom[3])
    jrc = PK.mg_restrict_t_pallas(jrh, h, w, bw, out_rows=_out_rows(lv), interpret=True)
    return np.asarray(ju), np.asarray(jrc)


@pytest.mark.parametrize("u_zero", [False, True])
@pytest.mark.parametrize("case", range(len(JAX_CASES)))
def test_mg_down_t_matches_pallas(case, u_zero):
    hw, beta = JAX_CASES[case]
    lv, g, u = _jax_level(hw, beta, 31 + case)
    h, w, bh, bw, _ = lv
    ju, jrc = _jax_down_t(case, u_zero)
    tu, trc = K.mg_down_t(None if u_zero else torch.from_numpy(u), torch.from_numpy(g), 1, h,
                          w, bh, bw, _out_rows(lv))
    _close(tu[:, :h, :w], ju[:, :h, :w])
    _close(trc, jrc)
    zm = np.ones(tu.shape, bool)
    zm[:, :h, :w] = False
    assert not tu.numpy()[zm].any()
    assert not trc[:, (w - 1) // 2 :].any() and not trc[:, :, (h - 1) // 2 :].any()


@pytest.mark.parametrize("case", range(len(JAX_CASES)))
def test_mg_up_t_matches_pallas(case):
    hw, beta = JAX_CASES[case]
    lv, g, u = _jax_level(hw, beta, 41 + case)
    h, w, bh, bw, geom = lv
    hc, wc = (h - 1) // 2, (w - 1) // 2
    chp, cwp = K.mg_geometry_t(wc, hc, wp_min=geom[3])[1:3]
    ec = np.zeros((3, chp, cwp), F32)
    ec[:, :wc, :hc] = np.random.default_rng(case).normal(size=(3, wc, hc)) * 5
    je = PK.mg_prolong_t_pallas(jnp.asarray(ec), h, w, bw, out_rows=geom[3], wp=geom[2],
                                interpret=True)
    ju = np.asarray(PK.mg_up_pallas(jnp.asarray(u), jnp.asarray(g), je, 2, bh=bh, bw=bw,
                                    interpret=True, blocked=True, padded_io=True,
                                    true_hw=(h, w), geom=geom[:3]))
    tu = K.mg_up_t(torch.from_numpy(u), torch.from_numpy(g), torch.from_numpy(ec), 2, h, w,
                   bh, bw)
    _close(tu[:, :h, :w], ju[:, :h, :w])
    zm = np.ones(tu.shape, bool)
    zm[:, :h, :w] = False
    assert not tu.numpy()[zm].any()


def test_vcycle_t_unfused_is_the_same_chain(monkeypatch):
    """The four-kernel reference chain (``vcycle_t_unfused``: the card
    checks hold the fused chain against it) runs the standalone level
    kernels and transfers, once a fused level each, and gives vcycle_t's
    bits."""
    h, w, bh, bw = 300, 257, 1.5, 1.25
    geom = K.mg_geometry_t(h, w)
    g, u = (torch.from_numpy(x) for x in _slabs((h, w, bh, bw, geom), 2, 5))
    calls = dict.fromkeys(("mg_down", "mg_up", "mg_restrict_t", "mg_prolong_t", "mg_down_t",
                           "mg_up_t"), 0)
    for name in calls:
        orig = getattr(K, name)

        def counted(*a, _orig=orig, _name=name, **k):
            calls[_name] += 1
            return _orig(*a, **k)

        monkeypatch.setattr(K, name, counted)
    got = TM.vcycle_t_unfused(u, g, h, w, 1, 2, 63, bh, bw, geom, {})
    assert calls == {"mg_down": 1, "mg_up": 1, "mg_restrict_t": 1, "mg_prolong_t": 1,
                     "mg_down_t": 0, "mg_up_t": 0}
    assert torch.equal(got, TM.vcycle_t(u, g, h, w, 1, 2, 63, bh, bw, geom, {}))


@pytest.mark.parametrize("hw,beta,c,levels", [((520, 528), (1.0, 1.0), 1, 2),
                                              ((300, 257), (1.5, 1.25), 2, 1)])
def test_vcycle_t_matches_jax(hw, beta, c, levels, monkeypatch):
    """One V-cycle from a given guess: the fused forms once per fused level,
    the standalone transfers never; the result within rel 1e-5 of JAX's
    vcycle_t, exact zeros outside the domain."""
    (h, w), (bh, bw) = hw, beta
    lv = (h, w, bh, bw, K.mg_geometry_t(h, w))
    g, u = _slabs(lv, c, h + w)
    calls = dict.fromkeys(("mg_down_t", "mg_up_t", "mg_restrict_t", "mg_prolong_t"), 0)
    for name in calls:
        orig = getattr(K, name)

        def counted(*a, _orig=orig, _name=name, **k):
            calls[_name] += 1
            return _orig(*a, **k)

        monkeypatch.setattr(K, name, counted)
    got = TM.vcycle_t(torch.from_numpy(u), torch.from_numpy(g), h, w, 1, 2, 63, bh, bw,
                      lv[4], {})
    assert calls == {"mg_down_t": levels, "mg_up_t": levels, "mg_restrict_t": 0,
                     "mg_prolong_t": 0}
    want = np.asarray(JM.vcycle_t(jnp.asarray(u), jnp.asarray(g), h, w, 1, 2, 63, True, bh, bw,
                                  geom=lv[4]))
    assert got.shape == want.shape
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()
    zm = np.ones(got.shape, bool)
    zm[:, :h, :w] = False
    assert not got.numpy()[zm].any()
