"""A numpy rehearsal of the level kernels' block schedules, on the CPU.

The quarter-plane level kernel (csrc/mg_level_q.cuh: mg_down_q, mg_up_q,
mg_ud_q) and the level ascent (csrc/mg_up.cu on mg_level.cuh's UpTile) run
one block per tile: they stage the tile with a ring, correct, and sweep a
region that shrinks by one dense layer (one point) a half-sweep, then write
only the owned tile and the restriction. Neither kernel runs here, so this
file replays each block's walk in numpy float32, with the same ring, the
same rectangles and the same operation order, and holds the assembled
outputs equal to the plain twins (ops/kernels.py) bit for bit. That checks
the exactness argument of the shrinking regions (the deepest gate,
nu1 + nu2 = 6, and tiles cut by the domain at every corner) before the card
runs the kernels themselves (tests/test_torch_cuda.py).
"""

import numpy as np
import pytest
import torch

from seamlesscloneoptimization_tpu_torch.ops import kernels as K

torch.set_num_threads(1)

F32 = np.float32
EE, EO, OE, OO = 0, 1, 2, 3

# -- the quarter-plane level kernel ---------------------------------------------

Q_TH, Q_TW = K.Q_TILE
SHALLOW = (4, 5, 4, 8)  # ring rows above / below, columns left / right
DEEP = (8, 8, 8, 8)


def ring_depth(ring):
    t, b, l, r = ring
    return min(2 * t - 1, 2 * b - 3, 2 * l - 1, 2 * r - 3)


def ceil_half(x):
    return (x + 1) >> 1  # an arithmetic shift, as in the kernel


def plane_rect(ring, p, dr0, dr1, dc0, dc1, h, w, r0, c0):
    """mg_level_q.cuh: plane_rect, local (row0, row1, col0, col1)."""
    t, b, l, r = ring
    rows, cols = Q_TH + t + b, Q_TW + l + r
    rp, cp = p >> 1, p & 1
    q0 = max(ceil_half(dr0 - rp), -r0)
    q1 = min(ceil_half(dr1 - rp), ceil_half(h - rp) - r0)
    k0 = max(ceil_half(dc0 - cp), -c0)
    k1 = min(ceil_half(dc1 - cp), ceil_half(w - cp) - c0)
    top, bot = (1, 0) if rp == 0 else (0, 1)
    lft = 1 if p in (EE, OE) else 0
    return (max(q0 + t, top), min(q1 + t, rows - bot), max(k0 + l, lft),
            min(k1 + l, cols - (1 - lft)))


def need_rect(ring, p, resid, d, h, w, r0, c0):
    lo, extra = (-1, 3) if resid else (0, 0)
    return plane_rect(ring, p, lo - d, 2 * Q_TH + extra + d, lo - d, 2 * Q_TW + extra + d,
                      h, w, r0, c0)


def _stage(x, gr0, gc0, rows, cols):
    """x (..., H, W) -> the (..., rows, cols) window at (gr0, gc0), zeros off x."""
    out = np.zeros(x.shape[:-2] + (rows, cols), F32)
    hh, ww = x.shape[-2:]
    a0, a1 = max(gr0, 0), min(gr0 + rows, hh)
    b0, b1 = max(gc0, 0), min(gc0 + cols, ww)
    if a0 < a1 and b0 < b1:
        out[..., a0 - gr0 : a1 - gr0, b0 - gc0 : b1 - gc0] = x[..., a0:a1, b0:b1]
    return out


def _q_stencil(u, p, r0_, r1_, c0_, c1_):
    """The neighbour sum of plane p over local rows [r0_, r1_) x cols [c0_, c1_)."""
    rs, cs = slice(r0_, r1_), slice(c0_, c1_)
    up, dn = slice(r0_ - 1, r1_ - 1), slice(r0_ + 1, r1_ + 1)
    lf, rt = slice(c0_ - 1, c1_ - 1), slice(c0_ + 1, c1_ + 1)
    if p == EE:
        return ((u[OE, up, cs] + u[OE, rs, cs]) + u[EO, rs, lf]) + u[EO, rs, cs]
    if p == OO:
        return ((u[EO, rs, cs] + u[EO, dn, cs]) + u[OE, rs, cs]) + u[OE, rs, rt]
    if p == EO:
        return ((u[OO, up, cs] + u[OO, rs, cs]) + u[EE, rs, cs]) + u[EE, rs, rt]
    return ((u[EE, rs, cs] + u[EE, dn, cs]) + u[OO, rs, lf]) + u[OO, rs, cs]


def q_level_blocks(u, g, e_even, e_odd, h, w, nu2, nu1, ascend, descend, split=False,
                   chp=0, with_rmax=False):
    """Every block of level_q_kernel<ascend, descend, split>, replayed.
    Returns (u_out, rc_t or (rh_e, rh_o) or None, rmax or None)."""
    wt = K._q_weights()
    up_a, up_b, dn_e, dn_o, rc_a, rc_b = (F32(wt[k]) for k in
                                          ("up_a", "up_b", "dn_e", "dn_o", "rc_a", "rc_b"))
    c, _, hq, wq2 = g.shape
    halves = 2 * ((nu2 if ascend else 0) + (nu1 if descend else 0))
    assert halves <= ring_depth(DEEP)
    ring = SHALLOW if halves <= ring_depth(SHALLOW) else DEEP
    t, b, l, r = ring
    rows, cols = Q_TH + t + b, Q_TW + l + r
    hc, wc = (h - 1) // 2, (w - 1) // 2
    h_even, w_even = h % 2 == 0, w % 2 == 0
    resid = descend or with_rmax
    u_out = np.zeros_like(g)
    rc_t = np.zeros((c, chp, hq), F32) if descend and not split else None
    rh = (np.zeros((c, hq, wq2), F32), np.zeros((c, hq, wq2), F32)) if split else None
    tiles = []
    for ch in range(c):
        for by in range(hq // Q_TH):
            for bx in range(wq2 // Q_TW):
                r0, c0 = by * Q_TH, bx * Q_TW
                gr0, gc0 = r0 - t, c0 - l
                su = (np.zeros((4, rows, cols), F32) if u is None
                      else _stage(u[ch], gr0, gc0, rows, cols))
                sg = _stage(g[ch], gr0, gc0, rows, cols)
                d = halves
                if ascend:
                    for p in range(4):
                        ra, rb, ca, cb = need_rect(ring, p, resid, d, h, w, r0, c0)
                        if ra >= rb or ca >= cb:
                            continue
                        gr = gr0 + np.arange(ra, rb)
                        src = (e_even if p in (EE, OE) else e_odd)[ch, :, gc0 + ca : gc0 + cb]

                        def e_rows(q, src=src):  # E(q): rows [0, hc), 0 elsewhere
                            ok = ((q >= 0) & (q < hc))[:, None]
                            return np.where(ok, src[np.clip(q, 0, hq - 1)], F32(0))

                        e0, em = e_rows(gr), e_rows(gr - 1)
                        mid = F32(0.5) * (em + e0)
                        corr = mid if p in (EE, EO) else e0
                        if h_even:
                            edge = (gr == hc)[:, None]
                            corr = np.where(edge, mid * (up_a if p in (EE, EO) else up_b), corr)
                        su[p, ra:rb, ca:cb] = su[p, ra:rb, ca:cb] + corr
                for s in range(nu2 * ascend + nu1 * descend):
                    for color in (0, 1):
                        d -= 1
                        zero = color == 0 and s == 0 and not ascend and u is None
                        for p in ((EE, OO) if color == 0 else (EO, OE)):
                            ra, rb, ca, cb = need_rect(ring, p, resid, d, h, w, r0, c0)
                            if ra >= rb or ca >= cb:
                                continue
                            n = (F32(0) if zero else _q_stencil(su, p, ra, rb, ca, cb))
                            su[p, ra:rb, ca:cb] = (n - sg[p, ra:rb, ca:cb]) * F32(0.25)
                u_out[ch, :, r0 : r0 + Q_TH, c0 : c0 + Q_TW] = su[:, t : t + Q_TH, l : l + Q_TW]
                if not resid:
                    continue
                # the residual over quarter rows [r0, r0 + TH], columns [c0, c0 + TW]
                ra, rb, ca, cb = t, t + Q_TH + 1, l, l + Q_TW + 1
                gr = r0 + np.arange(Q_TH + 1)[:, None]
                gc = c0 + np.arange(Q_TW + 1)[None, :]
                dee = (2 * gr < h) & (2 * gc < w)
                doo = (2 * gr + 1 < h) & (2 * gc + 1 < w)
                re, ro = (np.where(dom, sg[p, ra:rb, ca:cb] - (
                    _q_stencil(su, p, ra, rb, ca, cb) - F32(4) * su[p, ra:rb, ca:cb]), F32(0))
                    for p, dom in ((EE, dee), (OO, doo)))
                if with_rmax:
                    tiles.append(max(np.abs(re[:Q_TH, :Q_TW]).max(),
                                     np.abs(ro[:Q_TH, :Q_TW]).max()))
                jc = r0 + np.arange(Q_TH)[:, None]
                last = h_even & (jc == hc - 1)
                wd = np.where(last, dn_e, F32(0.25))
                wo = np.where(last, dn_o, F32(0))
                he = F32(0.25) * re[:-1] + wd * re[1:]
                ho = (F32(0.5) * ro[:-1] + wo * ro[1:]) if h_even else F32(0.5) * ro[:-1]
                if split:
                    ok = jc < hc
                    rh[0][ch, r0 : r0 + Q_TH, c0 : c0 + Q_TW] = np.where(ok, he[:, :Q_TW], F32(0))
                    rh[1][ch, r0 : r0 + Q_TH, c0 : c0 + Q_TW] = np.where(ok, ho[:, :Q_TW], F32(0))
                elif descend:
                    jw = c0 + np.arange(Q_TW)[None, :]
                    v = (he[:, :Q_TW] + F32(2) * ho[:, :Q_TW]) + he[:, 1:]
                    if w_even:
                        ve = ((he[:, :Q_TW] + F32(2) * ho[:, :Q_TW]) + rc_a * he[:, 1:]) \
                            + rc_b * ho[:, 1:]
                        v = np.where(jw == wc - 1, ve, v)
                    v = np.where((jw < wc) & (jc < hc), v, F32(0))
                    n_w = max(0, min(Q_TW, chp - c0))
                    rc_t[ch, c0 : c0 + n_w, r0 : r0 + Q_TH] = v[:, :n_w].T
    rmax = F32(max(tiles)) if with_rmax else None
    return u_out, (rh if split else rc_t), rmax


def _q_inputs(h, w, seed):
    rng = np.random.default_rng(seed)
    _, hq, wq2, hp2 = K.mg_geometry_q(h, w)
    hc, wc = (h - 1) // 2, (w - 1) // 2
    chp = K.mg_geometry_t(wc, hc, wp_min=hp2)[1]
    doms = torch.stack(K._q_doms(hq, wq2, h, w, "cpu")).numpy()

    def planes(scale):
        return (rng.normal(size=(2, 4, hq, wq2)) * scale).astype(F32) * doms

    ee = np.zeros((2, hq, wq2), F32)
    eo = np.zeros((2, hq, wq2), F32)
    ee[:, :hc, : (w + 1) // 2] = rng.normal(size=(2, hc, (w + 1) // 2)) * 5
    eo[:, :hc, : w // 2] = rng.normal(size=(2, hc, w // 2)) * 5
    return planes(50.0), planes(10.0), ee, eo, chp


# (h, w): the domain ends inside a tile at the bottom-right corner, odd and
# even each way; (256, 256) fills the planes' last tile row and column
Q_DOMAINS = [(201, 157), (200, 158), (199, 256), (256, 255), (256, 256)]


def _t(x):
    return torch.from_numpy(x)


@pytest.mark.parametrize("nu2,nu1", [(0, 1), (2, 1), (1, 2), (3, 3), (4, 2), (5, 1)])
@pytest.mark.parametrize("hw", Q_DOMAINS[:3])
def test_ud_q_schedule_matches_plain(hw, nu2, nu1):
    """mg_ud_q's blocks (both rings: nu1 + nu2 = 6 is the Deep ring's
    12 half-sweeps) against mg_ud_q_plain, with the residual max."""
    h, w = hw
    g, u, ee, eo, chp = _q_inputs(h, w, h * w + nu2)
    got_u, got_rc, got_max = q_level_blocks(u, g, ee, eo, h, w, nu2, nu1, True, True,
                                            chp=chp, with_rmax=True)
    want_u, want_rc, want_max = K.mg_ud_q_plain(_t(u), _t(g), _t(ee), _t(eo), nu2, nu1, h, w,
                                                chp, True)
    assert np.array_equal(got_u, want_u.numpy())
    assert np.array_equal(got_rc, want_rc.numpy())
    assert got_max == want_max.item()


@pytest.mark.parametrize("zero_guess", [True, False])
@pytest.mark.parametrize("nu1", [1, 2])
@pytest.mark.parametrize("hw", Q_DOMAINS[2:])
def test_down_q_schedule_matches_plain(hw, nu1, zero_guess):
    """mg_down_q's blocks, fused and split, against mg_down_q_plain."""
    h, w = hw
    g, u, ee, eo, chp = _q_inputs(h, w, h + w + nu1)
    u_in = None if zero_guess else u
    got_u, got_rc, _ = q_level_blocks(u_in, g, ee, eo, h, w, 0, nu1, False, True, chp=chp)
    want_u, want_rc = K.mg_down_q_plain(None if zero_guess else _t(u), _t(g), nu1, h, w, chp)
    assert np.array_equal(got_u, want_u.numpy()) and np.array_equal(got_rc, want_rc.numpy())
    got_u, (rh_e, rh_o), _ = q_level_blocks(u_in, g, ee, eo, h, w, 0, nu1, False, True,
                                            split=True)
    want = K.mg_down_q_plain(None if zero_guess else _t(u), _t(g), nu1, h, w)
    assert all(np.array_equal(a, b.numpy()) for a, b in zip((got_u, rh_e, rh_o), want))


@pytest.mark.parametrize("with_residual", [False, True])
@pytest.mark.parametrize("nu2", [0, 2, 4])
@pytest.mark.parametrize("hw", [Q_DOMAINS[0], Q_DOMAINS[3]])
def test_up_q_schedule_matches_plain(hw, nu2, with_residual):
    """mg_up_q's blocks (nu2 = 4 on the Deep ring) against mg_up_q_plain."""
    h, w = hw
    g, u, ee, eo, _ = _q_inputs(h, w, 3 * h + w + nu2)
    got_u, _, got_max = q_level_blocks(u, g, ee, eo, h, w, nu2, 0, True, False,
                                       with_rmax=with_residual)
    want = K.mg_up_q_plain(_t(u), _t(g), _t(ee), _t(eo), nu2, h, w, with_residual)
    if with_residual:
        assert np.array_equal(got_u, want[0].numpy()) and got_max == want[1].item()
    else:
        assert np.array_equal(got_u, want.numpy())


def test_ring_depths_cover_the_gates():
    """The Shallow ring takes the default fused boundary (nu2 = 2, nu1 = 1:
    6 half-sweeps) and mg_up_q up to nu2 = 3; the Deep one every gate up to
    nu1 + nu2 = 6."""
    assert ring_depth(SHALLOW) == 7 and ring_depth(DEEP) == 13
    assert 2 * (K.Q_GHOST - 2) <= ring_depth(DEEP)


# -- the level ascent -----------------------------------------------------------


UP_TH, UP_COLS = 32, 64  # mg_level.cuh: UpTile's owned rows and staged columns


def up_blocks(u, g, e, nu2, h, w, bh, bw, ring):
    """Every block of mg_up.cu's mg_up_kernel<UpTile<ring>>, replayed."""
    th, ncols = UP_TH, UP_COLS
    tw, nrows = ncols - 2 * ring, th + 2 * ring
    c, hp, wp = u.shape
    e_rows = e.shape[1]
    uniform, cuh, cuw, dh, dw = K._level_consts(bh, bw)
    cuh, cuw, dh, dw = F32(cuh), F32(cuw), F32(dh), F32(dw)
    gap = 2.0 + bh
    c3, c4 = F32(K._f32(2.0 * (1.0 + bh) / gap)), F32(K._f32(2.0 * bh / gap))
    hc = (h - 1) // 2
    krows = min(hc, e_rows)
    out = np.zeros_like(u)
    for ch in range(c):
        for by in range(-(-hp // th)):
            for bx in range(-(-wp // tw)):
                r0, c0 = by * th, bx * tw
                gr0, gc0 = r0 - ring, c0 - ring
                qa = gr0 // 2 - 1
                su = _stage(u[ch], gr0, gc0, nrows, ncols)
                sg = _stage(g[ch], gr0, gc0, nrows, ncols)
                se = _stage(e[ch, :krows, :], qa, gc0, nrows // 2 + 1, ncols)
                d = 2 * nu2
                ra = max(max(r0 - d, 0) - gr0, 0)
                rb = min(min(r0 + th + d, h) - gr0, nrows)
                ca = max(max(c0 - d, 0) - gc0, 0)
                cb = min(min(c0 + tw + d, w) - gc0, ncols)
                for lr in range(ra, rb if ca < cb else ra):
                    gr = gr0 + lr
                    q = gr >> 1
                    eq = se[q - qa, ca:cb]
                    corr = eq if gr & 1 else F32(0.5) * (se[q - 1 - qa, ca:cb] + eq)
                    if h % 2 == 0 and gr >= h - 2:
                        mid = F32(0.5) * (se[hc - 1 - qa, ca:cb] + F32(0))
                        corr = mid * (c3 if gr == h - 2 else c4)
                    su[lr, ca:cb] = su[lr, ca:cb] + corr
                for _ in range(nu2):
                    for color in (0, 1):
                        d -= 1
                        lo = max(max(r0 - d, 0) - gr0, 1)
                        hi = min(min(r0 + th + d, h) - gr0, nrows - 1)
                        clo = max(max(c0 - d, 0) - gc0, 1)
                        chi = min(min(c0 + tw + d, w) - gc0, ncols - 1)
                        for lr in range(lo, hi):
                            lc = np.arange((color + lr) & 1, ncols, 2)  # gr0, gc0 even
                            lc = lc[(lc >= clo) & (lc < chi)]
                            if lc.size == 0:
                                continue
                            gr, gc = gr0 + lr, gc0 + lc
                            up, dn = su[lr - 1, lc], su[lr + 1, lc]
                            lf, rt = su[lr, lc - 1], su[lr, lc + 1]
                            n = ((up + dn) + lf) + rt
                            if not uniform:
                                lrow = cuh if gr == h - 1 else F32(0)
                                lcol = np.where(gc == w - 1, cuw, F32(0))
                                n = (n + lrow * up) + lcol * lf
                                diag = (dh if gr == h - 1 else F32(2)) + np.where(
                                    gc == w - 1, dw, F32(2))
                                inv = F32(1) / diag
                            else:
                                inv = F32(0.25)
                            su[lr, lc] = (n - sg[lr, lc]) * inv
                hh, ww = min(th, hp - r0), min(tw, wp - c0)
                out[ch, r0 : r0 + hh, c0 : c0 + ww] = su[ring : ring + hh, ring : ring + ww]
    return out


# (h, w, beta, slab): a padded level, beta != 1 on either axis, even / odd
# h, an exact-size level (odd width, slab height h + h % 2), and an 8K
# coarse level's betas; e_rows past hp / 2 on the padded slabs; a level of
# one tile, a domain of whole tiles (ring 4: 32 x 56), tiles cut by the
# domain at odd and even h and w on both slabs
UP_CASES = [
    (70, 200, (1.0, 2.0), None),
    (129, 257, (2.0, 1.0), None),
    (40, 57, (1.5, 0.5), "exact"),
    (63, 45, (1.0, 1.0), "exact"),
    (134, 99, (1.9375, 1.4375), None),
    (20, 30, (1.5, 1.5), "exact"),
    (64, 112, (1.0, 1.0), "exact"),
    (33, 57, (1.25, 1.75), None),
    (96, 113, (1.5, 1.0), "exact"),
    (127, 170, (1.0, 1.5), None),
]


@pytest.mark.parametrize("nu2", [1, 2, 4])
@pytest.mark.parametrize("case", UP_CASES)
def test_up_schedule_matches_plain(case, nu2):
    h, w, (bh, bw), slab = case
    if slab == "exact":
        hp, wp, e_rows = h + h % 2, w, (h + h % 2) // 2
    else:
        _, hp, wp, e_rows = K.mg_geometry_t(h, w)
    rng = np.random.default_rng(h * w + nu2)
    u = np.zeros((2, hp, wp), F32)
    g = np.zeros((2, hp, wp), F32)
    e = np.zeros((2, e_rows, wp), F32)
    u[:, :h, :w] = rng.normal(size=(2, h, w)) * 10
    g[:, :h, :w] = rng.normal(size=(2, h, w)) * 50
    e[:, : (h - 1) // 2] = rng.normal(size=(2, (h - 1) // 2, wp)) * 5
    got = up_blocks(u, g, e, nu2, h, w, bh, bw, 4 if nu2 <= 2 else 8)
    want = K.mg_up_plain(_t(u), _t(g), _t(e), nu2, h, w, bh, bw)
    assert np.array_equal(got, want.numpy())


# -- the chain's coarse levels ----------------------------------------------------


@pytest.mark.parametrize("hw,levels", [((518, 526), 1), ((1030, 1062), 2)])
def test_q_coarse_levels_are_the_levels_the_cycle_runs(hw, levels, monkeypatch):
    """``q_coarse_levels`` (the levels chip_smoke.py and the card tests time
    the coarse kernels at) names the levels on which one quarter-plane
    V-cycle launches the fused ascent, with their betas and slabs."""
    from seamlesscloneoptimization_tpu_torch.solvers import multigrid as TM

    h, w = hw
    calls = []
    mg_up_t = K.mg_up_t

    def recorded(u, g, ec_t, nu2, lh, lw, bh=1.0, bw=1.0):
        calls.append((lh, lw, bh, bw, tuple(u.shape)))
        return mg_up_t(u, g, ec_t, nu2, lh, lw, bh, bw)

    monkeypatch.setattr(K, "mg_up_t", recorded)
    _, hq, wq2, _ = K.mg_geometry_q(h, w)
    TM.vcycle_q(None, torch.zeros((1, 4, hq, wq2)), h, w)
    want = [(lh, lw, bh, bw, (1, geom[1], geom[2]))
            for lh, lw, bh, bw, geom in TM.q_coarse_levels(h, w)]
    assert len(want) == levels
    assert calls[::-1] == want
