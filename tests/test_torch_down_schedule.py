"""A numpy rehearsal of mg_down's block walk (csrc/mg_down.cu), on the CPU.

The level descent's kernel runs one block per (channel, 32 x 64 tile): it
stages g (and u, unless the guess is known zero) with a ring as deep as its
sweeps need, sweeps a region that shrinks by one point a half-sweep, walks
the residual down each owned column in four groups of rows and writes the
tile's rows of the restriction, and spreads the zero rows of rh below hp/2
over the grid's tile rows. The kernel does not run here, so this file
replays every block in numpy float32 with the rings read from the source,
the same rectangles and the same operation order, counts the writes to
each output element (exactly one each), and holds the outputs equal to the
plain twin (``K.mg_down_plain``) bit for bit.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from seamlesscloneoptimization_tpu_torch.ops import kernels as K

torch.set_num_threads(1)

F32 = np.float32
TH, TW = 32, 64  # DownTile's owned tile
THREADS = 256
SOURCE = Path(K.__file__).resolve().parent.parent / "csrc" / "mg_down.cu"


def _rings():
    text = SOURCE.read_text()
    return {name: tuple(int(v) for v in re.search(
        rf"using {name} = DownTile<(\d+), (\d+), (\d+), (\d+)>;", text).groups())
        for name in ("Shallow", "Deep")}


RINGS = _rings()


def ring_depth(ring):
    t, b, l, r = ring
    return min(t - 1, b - 2, l - 1, r - 1)


def ring_for(nu1):
    return RINGS["Shallow"] if nu1 <= 1 else RINGS["Deep"]


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


def down_blocks(u, g, nu1, h, w, bh, bw, rh_rows, ring):
    """Every block of mg_down_kernel<DownTile<ring>>, replayed. Returns
    (u_out, rh, writes to u_out, writes to rh)."""
    t, b, l, r = ring
    rows, cols = TH + t + b, TW + l + r
    c, hp, wp = g.shape
    uniform, cuh, cuw, dh, dw = K._level_consts(bh, bw)
    cuh, cuw, dh, dw = F32(cuh), F32(cuw), F32(dh), F32(dw)
    gap = 2.0 + bh
    c1 = F32(K._f32((1.0 + bh) / gap * 0.5 - 0.25))
    c2 = F32(K._f32(bh / gap * 0.5))
    two = F32(2)
    diag_of = {(lr_, lc_): (dh if lr_ else two) + (dw if lc_ else two)
               for lr_ in (False, True) for lc_ in (False, True)}
    hc = (h - 1) // 2
    u_out = np.full_like(g, np.nan)
    rh = np.full((c, rh_rows, wp), np.nan, F32)
    n_u = np.zeros(u_out.shape, np.int32)
    n_rh = np.zeros(rh.shape, np.int32)
    grid_y, grid_x = -(-hp // TH), -(-wp // TW)

    def nsum(su, lr, lc, gr, gc):
        up, dn = su[lr - 1, lc], su[lr + 1, lc]
        lf, rt = su[lr, lc - 1], su[lr, lc + 1]
        n = ((up + dn) + lf) + rt
        if not uniform:
            lrow = np.where(gr == h - 1, cuh, F32(0))
            lcol = np.where(gc == w - 1, cuw, F32(0))
            n = (n + lrow * up) + lcol * lf
        return n

    def diag(gr, gc):
        if uniform:
            return F32(4)
        return np.where(gr == h - 1, np.where(gc == w - 1, diag_of[True, True],
                                              diag_of[True, False]),
                        np.where(gc == w - 1, diag_of[False, True], diag_of[False, False]))

    for ch in range(c):
        for by in range(grid_y):
            for bx in range(grid_x):
                r0, c0 = by * TH, bx * TW
                gr0, gc0 = r0 - t, c0 - l
                sg = _stage(g[ch], gr0, gc0, rows, cols)
                su = np.zeros((rows, cols), F32) if u is None else _stage(u[ch], gr0, gc0,
                                                                          rows, cols)
                # the zero rows of rh, thread group q of THREADS // TW
                for q in range(THREADS // TW):
                    k = by + grid_y * q
                    while k < rh_rows - hp // 2:
                        cs = slice(c0, min(c0 + TW, wp))
                        rh[ch, hp // 2 + k, cs] = 0.0
                        n_rh[ch, hp // 2 + k, cs] += 1
                        k += grid_y * (THREADS // TW)
                d = 2 * nu1
                for s in range(nu1):
                    for color in (0, 1):
                        d -= 1
                        zero = color == 0 and s == 0 and u is None
                        rlo, rhi = _band(r0 - 1 - d, r0 + TH + 2 + d, h, gr0, rows)
                        clo, chi = _band(c0 - 1 - d, c0 + TW + 1 + d, w, gc0, cols)
                        for lr in range(rlo, rhi):
                            lc = np.arange(clo, chi)
                            lc = lc[(gr0 + lr + gc0 + lc) % 2 == color]
                            if lc.size == 0:
                                continue
                            gr, gc = gr0 + lr, gc0 + lc
                            n = F32(0) if zero else nsum(su, lr, lc, gr, gc)
                            inv = F32(0.25) if uniform else F32(1) / diag(gr, gc)
                            su[lr, lc] = (n - sg[lr, lc]) * inv
                # the residual down each column, groups of 8 rows (+ 2 read)
                cc = np.arange(TW)
                gc = c0 + cc
                lc = l + cc
                for q in range(THREADS // TW):
                    res = []
                    for i in range(10):
                        rr = 8 * q + i
                        gr, lr = r0 + rr, t + rr
                        ok = (gc < w) & (gr < h)
                        v = sg[lr, lc] - (nsum(su, lr, lc, gr, gc) - diag(gr, gc) * su[lr, lc])
                        res.append(np.where(ok, v, F32(0)))
                    for k in range(4):
                        j = r0 // 2 + 4 * q + k
                        if j >= hp // 2:
                            break
                        v = (F32(0.25) * res[2 * k] + F32(0.5) * res[2 * k + 1]) \
                            + F32(0.25) * res[2 * k + 2]
                        if h % 2 == 0 and j == hc - 1:
                            v = (v + c1 * res[2 * k + 2]) + c2 * res[2 * k + 3]
                        keep = gc < wp
                        rh[ch, j, gc[keep]] = v[keep]
                        n_rh[ch, j, gc[keep]] += 1
                hh, ww = min(TH, hp - r0), min(TW, wp - c0)
                u_out[ch, r0 : r0 + hh, c0 : c0 + ww] = su[t : t + hh, l : l + ww]
                n_u[ch, r0 : r0 + hh, c0 : c0 + ww] += 1
    return u_out, rh, n_u, n_rh


# (h, w, (bh, bw), slab, extra rh rows): padded "t" levels (their hp2 rows
# of rh, past hp / 2 where hp2 rounds up), beta != 1 on either axis, the 8K
# "q" chain's coarse betas, even and odd h, exact-size slabs (odd width,
# height h + h % 2), tiles cut by the domain at every corner, a level of
# one tile, whole tiles, an explicit rh_rows past hp / 2, and h = 32 k + 2,
# where the even-h edge row of rh reads the residual two rows below a tile
DOWN_CASES = [
    (70, 200, (1.0, 2.0), None, 0),
    (129, 257, (2.0, 1.0), None, 0),
    (134, 99, (1.9375, 1.4375), None, 0),
    (40, 57, (1.5, 0.5), "exact", 0),
    (63, 45, (1.0, 1.0), "exact", 0),
    (20, 30, (1.5, 1.5), "exact", 3),
    (64, 128, (1.0, 1.0), "exact", 0),
    (33, 57, (1.25, 1.75), None, 0),
    (96, 113, (1.4375, 1.9375), "exact", 0),
    (127, 170, (1.0, 1.5), None, 5),
    (66, 150, (1.5, 1.0), None, 0),
    (34, 71, (1.9375, 1.4375), "exact", 0),
]


def _down_inputs(case, seed):
    h, w, _, slab, extra = case
    if slab == "exact":
        hp, wp = h + h % 2, w
        rh_rows = hp // 2 + extra
    else:
        _, hp, wp, hp2 = K.mg_geometry_t(h, w)
        rh_rows = hp2 + extra
    rng = np.random.default_rng(seed)
    g = np.zeros((2, hp, wp), F32)
    u = np.zeros((2, hp, wp), F32)
    g[:, :h, :w] = rng.normal(size=(2, h, w)) * 50
    u[:, :h, :w] = rng.normal(size=(2, h, w)) * 10
    return g, u, rh_rows


def _check(case, nu1, zero_guess, ring):
    h, w, (bh, bw), _, _ = case
    g, u, rh_rows = _down_inputs(case, h * w + nu1)
    u_in = None if zero_guess else u
    got_u, got_rh, n_u, n_rh = down_blocks(u_in, g, nu1, h, w, bh, bw, rh_rows, ring)
    want_u, want_rh = K.mg_down_plain(None if zero_guess else torch.from_numpy(u),
                                      torch.from_numpy(g), nu1, h, w, bh, bw, rh_rows)
    return (n_u == 1).all() and (n_rh == 1).all(), (
        np.array_equal(got_u, want_u.numpy()) and np.array_equal(got_rh, want_rh.numpy()))


@pytest.mark.parametrize("zero_guess", [True, False])
@pytest.mark.parametrize("nu1", [0, 1, 2])
@pytest.mark.parametrize("case", DOWN_CASES)
def test_down_schedule_matches_plain(case, nu1, zero_guess):
    """Every element of u and rh written once, and equal to mg_down_plain."""
    once, equal = _check(case, nu1, zero_guess, ring_for(nu1))
    assert once and equal


def test_down_rings_cover_the_sweeps():
    """The Shallow ring keeps the 2 half-sweeps of nu1 = 1 exact and the
    Deep one the 4 of nu1 = 2; both start at even rows and at columns that
    keep 16-byte copies aligned."""
    assert ring_depth(RINGS["Shallow"]) >= 2 and ring_depth(RINGS["Deep"]) >= 4
    for t, _, l, r in RINGS.values():
        assert t % 2 == 0 and l % 4 == 0 and (TW + l + r) % 4 == 0
