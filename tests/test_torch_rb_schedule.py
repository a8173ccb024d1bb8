"""A numpy rehearsal of rb_sweeps_tile's block and warp walk
(csrc/rb_sweeps_tile.cu), on the CPU.

A block of the n-sweep kernel stages kRows x kCols points of u of one
channel (a ring of kRr = 2 n rows and kRc = 2 n rounded up to 4 columns
around the owned kRows - 2 kRr rows x kCols - 2 kRc columns) with 16-byte
copies where the row width is a multiple of 4 floats and the bases are
aligned, 4-byte copies otherwise, zeros off the buffer. Warp w keeps the
fixed strip of staged rows [1 + kL w, 1 + kL (w + 1)) in registers, with
the rows above and below; lane j the column pairs (2 j, + 1) and
(64 + 2 j, + 1), and g of its strip's points, loaded from device memory.
Half-sweep k of 2 n updates the points of its colour within 2 n - k of the
owned tile, cut by the rectangle of updatable points and by the staged
points whose neighbours are staged: up and dn from the rows above and
below, one side from the lane's own pair, the other from the neighbour
lane (two shuffles a row; the pairs' seam at columns 63 / 64 from lanes
31 and 0 of the same shuffles). Between half-sweeps the strips swap their
first and last rows through shared memory. The store writes the strips
back and the owned rows out, a float4 a lane where aligned.

The kernel does not run here, so this file replays every block of every
launch literally (a shuffle as a roll across the lanes) and checks that
each copy and each g load stays inside its channel's plane (a 16-byte copy
inside its row), that a half-sweep writes exactly its colour's points of
the band, each once, and reads none of them, that every output element is
stored exactly once, and that the result equals the plain twins
(``K.rb_sweeps_tile_plain`` and ``K.rb_sweeps_plain``) bit for bit.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from seamlesscloneoptimization_tpu_torch.ops import kernels as K

torch.set_num_threads(1)

F32 = np.float32
SOURCE = Path(K.__file__).resolve().parent.parent / "csrc" / "rb_sweeps_tile.cu"


def _consts():
    text = SOURCE.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))

    rr, rc = (re.search(rf"static constexpr int {k} = ([^;]+);", text).group(1)
              for k in ("kRr", "kRc"))
    return const("kThreads"), const("kCols"), const("kL"), rr, rc


THREADS, COLS, L, RR_EXPR, RC_EXPR = _consts()
WARPS = THREADS // 32
ROWS = WARPS * L + 2
LANE = np.arange(32)


def _c_int(expr, n):
    """A Geom constant for kN = n (C integer arithmetic on non-negatives)."""
    return int(eval(expr.replace("kN", str(n)).replace("/", "//"), {}))


def geom(n):
    """(kRr, kRc, kTH, kTW) of the n-sweep launch."""
    rr, rc = _c_int(RR_EXPR, n), _c_int(RC_EXPR, n)
    return rr, rc, ROWS - 2 * rr, COLS - 2 * rc


def stage(x, rows, gr0, gc0, vec):
    """stage_async of plane x (hl, wl) into a (rows, COLS) window at local
    (gr0, gc0), zeros off the plane; every copy is checked to stay in it
    (a 16-byte copy inside its row, from an element index that is a
    multiple of 4)."""
    hl, wl = x.shape
    out = np.zeros((rows, COLS), F32)
    gr = gr0 + np.arange(rows)[:, None]
    step = 4 if vec else 1
    gc = gc0 + step * np.arange(COLS // step)[None, :]
    ok = (gr >= 0) & (gr < hl) & (gc >= 0) & (gc < wl)
    at_r, at_c = np.broadcast_to(gr, ok.shape)[ok], np.broadcast_to(gc, ok.shape)[ok]
    assert (at_c + step <= wl).all() and ((at_r * wl + at_c) % step == 0).all()
    for e in range(step):
        part = out[:, e::step]
        part[ok] = x[at_r, at_c + e]
    return out


def load_g(x, lr, lc, vec):
    """load_g for every lane's pair (lr, lc + 2 j .. + 1) at once: zeros off
    the plane, every load inside it (a float2 at an even element)."""
    hl, wl = x.shape
    out = np.zeros((lc.size, 2), F32)
    if not 0 <= lr < hl:
        return out.reshape(-1)
    ok = (lc >= 0) & (lc < wl)
    if vec:
        assert (lc[ok] + 2 <= wl).all() and ((lr * wl + lc[ok]) % 2 == 0).all()
    for e in range(2):
        got = ok & (lc + e < wl)
        out[got, e] = x[lr, lc[got] + e]
    return out.reshape(-1)


def sweep_rows(rv, gv, a, rlo, rhi, ok, p0):
    """sweep_rows<p0> of one warp: rv (L + 2, COLS) its rows a - 1 .. a + L,
    gv (L, COLS) g of rows a .. a + L - 1, ok (COLS,) the band's columns.
    Returns the staged (row, col) points it wrote and those their updates
    read."""
    wrote, read = [], []
    for i in range(L):
        p = p0 ^ (i & 1)
        r = a + i
        if r < rlo or r >= rhi:
            continue
        row = rv[i + 1]
        if p == 0:  # lf: lane j - 1's y; lane 0's B: lane 31's A.y
            sa = np.roll(row[1:64:2], 1)
            sb = np.roll(row[65:128:2], 1)
            side = (sa, np.where(LANE == 0, sa, sb))
        else:       # rt: lane j + 1's x; lane 31's A: lane 0's B.x
            sa = np.roll(row[0:64:2], -1)
            sb = np.roll(row[64:128:2], -1)
            side = (np.where(LANE == 31, sb, sa), sb)
        for q in range(2):
            c = 64 * q + 2 * LANE + p
            up, dn = rv[i, c], rv[i + 2, c]
            lf = row[c - 1] if p else side[q]
            rt = side[q] if p else row[c + 1]
            v = ((((up + dn) + lf) + rt) - gv[i, c]) * F32(0.25)
            m = ok[c]
            rv[i + 1, c[m]] = v[m]
            wrote.append(r * COLS + c[m])
            for dr, dc in ((-1, 0), (1, 0), (0, -1), (0, 1)):
                read.append((r + dr) * COLS + c[m] + dc)
    return wrote, read


def launch(u, g, out, n, rect, parity, offsets=(0, 0, 0)):
    """One rb_sweeps_tile_kernel<n> launch, every block replayed; out is
    written, and the stores to each element are counted."""
    c, hl, wl = u.shape
    rr_, rc_, th, tw = geom(n)
    r_lo, r_hi, c_lo, c_hi = rect
    vec = wl % 4 == 0 and all(o % 4 == 0 for o in offsets)
    n_out = np.zeros(out.shape, np.int32)
    for ch in range(c):
        for by in range(-(-hl // th)):
            for bx in range(-(-wl // tw)):
                r0, c0 = by * th, bx * tw
                lr0, lc0 = r0 - rr_, c0 - rc_
                assert (lr0 + lc0) % 2 == 0
                su = stage(u[ch], ROWS, lr0, lc0, vec)
                strips = [1 + L * w for w in range(WARPS)]
                gv = [np.stack([np.concatenate([load_g(g[ch], lr0 + a + i, lc0 + 64 * q
                                                       + 2 * LANE, vec) for q in range(2)])
                                for i in range(L)]) for a in strips]
                rv = [su[a - 1 : a + L + 1].copy() for a in strips]
                for k in range(1, 2 * n + 1):
                    want, d = (k - 1) & 1, 2 * n - k
                    rlo = max(rr_ - d, r_lo - lr0, 1)
                    rhi = min(rr_ + th + d, r_hi - lr0, ROWS - 1)
                    clo = max(rc_ - d, c_lo - lc0, 1)
                    chi = min(rc_ + tw + d, c_hi - lc0, COLS - 1)
                    cols = np.arange(COLS)
                    ok = (cols >= clo) & (cols < chi)
                    wrote, read = [], []
                    for w, a in enumerate(strips):
                        assert a % 2 == 1
                        wr_, rd_ = sweep_rows(rv[w], gv[w], a, rlo, rhi, ok,
                                              (want ^ parity ^ a) & 1)
                        wrote += wr_
                        read += rd_
                    keys = np.concatenate(wrote + [np.zeros(0, int)])
                    # exactly the colour's points of the band, each once
                    er, ec = np.meshgrid(np.arange(rlo, rhi), np.arange(clo, chi),
                                         indexing="ij")
                    colour = ((er + ec + parity) & 1) == want
                    assert keys.size == np.unique(keys).size
                    assert np.array_equal(np.sort(keys), np.sort((er * COLS + ec)[colour]))
                    # the updates read none of the points the half-sweep writes
                    assert not np.isin(np.concatenate(read + [np.zeros(0, int)]), keys).any()
                    if k < 2 * n:  # the strips swap their first and last rows
                        ex = [(x[1].copy(), x[L].copy()) for x in rv]
                        for w in range(WARPS):
                            if w > 0:
                                rv[w][0] = ex[w - 1][1]
                            if w < WARPS - 1:
                                rv[w][L + 1] = ex[w + 1][0]
                for w, a in enumerate(strips):
                    su[a : a + L] = rv[w][1 : L + 1]
                for rr in range(th):  # a warp a row, rows strided by warps
                    gr = r0 + rr
                    if gr >= hl:
                        break
                    srow = su[rr_ + rr, rc_ : rc_ + tw]
                    if vec:
                        for lane in range(min(32, tw // 4)):
                            gc = c0 + 4 * lane
                            if gc < wl:
                                out[ch, gr, gc : gc + 4] = srow[4 * lane : 4 * lane + 4]
                                n_out[ch, gr, gc : gc + 4] += 1
                    else:
                        m = min(tw, wl - c0)
                        out[ch, gr, c0 : c0 + m] = srow[:m]
                        n_out[ch, gr, c0 : c0 + m] += 1
    assert (n_out == 1).all()  # every element stored exactly once


def burst(u, g, n, origin, domain, offsets=(0, 0, 0)):
    """ops/kernels.py's rb_sweeps_tile: ceil(n / 4) launches between two
    buffers, each filled with NaN first."""
    _, hl, wl = u.shape
    org_r, org_c = origin
    ht, wt = domain
    rect = (max(0, -org_r), min(hl, ht - org_r), max(0, -org_c), min(wl, wt - org_c))
    parity = (org_r + org_c) % 2
    src = u
    for done in range(0, n, K.RB_SWEEPS_PER_LAUNCH):
        out = np.full(u.shape, np.nan, F32)
        launch(src, g, out, min(K.RB_SWEEPS_PER_LAUNCH, n - done), rect, parity, offsets)
        src = out
    return src


def _data(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape).astype(F32) * 10, rng.normal(size=shape).astype(F32) * 50)


def _check_tile(shape, origin, domain, n, seed, offsets=(0, 0, 0)):
    u, g = _data(shape, seed)
    got = burst(u, g, n, origin, domain, offsets)
    want = K.rb_sweeps_tile_plain(torch.from_numpy(u), torch.from_numpy(g), n, origin,
                                  domain).numpy()
    assert np.array_equal(got, want)


def test_geometry_rings_follow_the_launch():
    """A ring of 2 n rows, 2 n rounded up to whole 16-byte chunks of
    columns; strips that start on odd rows; the staged tile and the
    exchange slots within 48 KB of static shared memory."""
    for n in range(1, 5):
        rr_, rc_, th, tw = geom(n)
        assert rr_ == 2 * n and rc_ >= 2 * n and rc_ % 4 == 0 and rc_ < 2 * n + 4
        assert tw % 4 == 0 and th > 0 and (th + tw) % 2 == 0 and L % 2 == 0
        assert 4 * COLS * ROWS + 8 * 2 * WARPS * 2 * (COLS // 2) <= 48 * 1024


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("origin", [(0, 0), (-6, -6), (17, -3), (-5, 122)])
def test_rb_tile_schedule_sweeps_and_origins(n, origin):
    """n = 1 .. 4 sweeps (one launch) and 5 (two launches) at even and odd
    origins, the domain cutting the tile on its right and bottom."""
    _check_tile((2, 45, 140), origin, (60, 250), n, 10 * n + origin[0] % 7)


@pytest.mark.parametrize("wl_mod", [0, 1, 2, 3])
@pytest.mark.parametrize("n", [1, 4])
def test_rb_tile_schedule_row_widths(wl_mod, n):
    """Widths 4k .. 4k + 3: 16-byte staging and float4 stores at 4k, 4-byte
    copies and scalar stores otherwise, the last block's columns cut."""
    _check_tile((1, 37, 4 * 29 + wl_mod), (-2, 3), (40, 200), n, 7 * wl_mod + n)


@pytest.mark.parametrize("side", ["top", "bottom", "left", "right", "empty"])
def test_rb_tile_schedule_rect_cuts(side):
    """The rectangle of updatable points cut on each side (a ghost band
    outside the domain), and empty (the tile wholly outside: a copy)."""
    case = {"top": ((-9, 0), (200, 300)), "bottom": ((0, 0), (30, 300)),
            "left": ((0, -11), (200, 300)), "right": ((0, 0), (200, 95)),
            "empty": ((100, 100), (50, 50))}[side]
    for n in (2, 3):
        _check_tile((2, 40, 132), *case, n, n + len(side))


@pytest.mark.parametrize("shape", [(1, 1, 1), (3, 9, 9), (1, 5, 130), (2, 70, 3)])
def test_rb_tile_schedule_small_tiles(shape):
    """Tiles smaller than a block, and a block's row or column only."""
    for n in (1, 4, 5):
        _check_tile(shape, (1, 0), (shape[1], shape[2] + 3), n, shape[1] + n)


def test_rb_tile_schedule_misaligned_bases():
    """A width 4k whose buffers do not start on 16 bytes: 4-byte copies."""
    _check_tile((1, 33, 124), (-6, -6), (30, 110), 2, 5, offsets=(1, 0, 0))


@pytest.mark.parametrize("n", [1, 2, 3, 4, 6])
def test_rb_sweeps_schedule_matches_plain(n):
    """K.rb_sweeps's launches: origin (0, 0), the whole array the domain,
    bit-equal to n redblack_sweep calls, on an odd and an even grid."""
    for shape in ((1, 97, 131), (2, 34, 256)):
        u, g = _data(shape, n + shape[1])
        got = burst(u, g, n, (0, 0), shape[1:])
        want = K.rb_sweeps_plain(torch.from_numpy(u), torch.from_numpy(g), n).numpy()
        assert np.array_equal(got, want)
