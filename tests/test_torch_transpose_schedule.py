"""A numpy rehearsal of transpose_pair's whole-tile kernel
(csrc/transpose_pair.cu), on the CPU.

A block of kThreads threads owns a kT x kT tile of the window (rows r,
columns p), which lies wholly in a or in b. Thread t loads the float4
units (t / kQ + kPass i, t % kQ) of the tile and writes each to the shared
tile at column unit q ^ ((row >> 2) & 7); after the barrier it reads tile
rows 4 (t % 16) .. + 3 at unit t / 16, transposes the 4 x 4 block in
registers, divides by lam_p[p] + lam_r[row_start + r] when asked, and
stores four float4 along r. The kernel does not run here, so this file
replays the tile's index maps: every unit of the shared tile written once
and read once, the value read the one written for the same logical unit,
no two lanes of a quarter-warp (the eight lanes a 16-byte access serves
together) on one bank group in either direction, and every block of small
whole-tile shapes replayed against ``K.transpose_pair_plain`` bit for bit
(every output element written once). A strip's divide (the same kernel
with 0 / x as the product 0 x x) is replayed on the chain's zeros, bit for
bit (the zeros' signs too). The constants are parsed from the source.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from seamlesscloneoptimization_tpu_torch.ops import kernels as K

torch.set_num_threads(1)

SOURCE = Path(K.__file__).resolve().parent.parent / "csrc" / "transpose_pair.cu"


def _consts():
    text = SOURCE.read_text()
    return tuple(int(re.search(rf"constexpr int {k} = (\d+);", text).group(1))
                 for k in ("kT", "kThreads"))


T, THREADS = _consts()
Q = T // 4
PASS = THREADS // Q
THREAD = np.arange(THREADS)


def swizzle(row, q):
    return q ^ ((row >> 2) & 7)


def writes():
    """(instruction, thread) -> (tile row, logical unit, stored unit)."""
    rows = np.stack([THREAD // Q + PASS * i for i in range(T // PASS)])
    q = np.broadcast_to(THREAD % Q, rows.shape)
    return rows, q, swizzle(rows, q)


def reads():
    rows = np.stack([4 * (THREAD % 16) + j for j in range(4)])
    q = np.broadcast_to(THREAD // 16, rows.shape)
    return rows, q, swizzle(rows, q)


@pytest.mark.parametrize("phase", [writes, reads])
def test_transpose_tile_units_once(phase):
    rows, q, stored = phase()
    hits = np.zeros((T, Q), np.int64)
    np.add.at(hits, (rows, stored), 1)
    assert (hits == 1).all()
    # the unit stored for (row, q) is the unit read back for (row, q)
    wr, wq, ws = writes()
    where = np.full((T, Q), -1)
    where[wr, wq] = ws
    assert (where[rows, q] == stored).all()


@pytest.mark.parametrize("phase", [writes, reads])
def test_transpose_tile_no_bank_conflicts(phase):
    """A 16-byte shared access is served eight lanes at a time; each of
    the eight must fall in its own group of four banks."""
    rows, _, stored = phase()
    group = (rows * T + 4 * stored) // 4 % 8  # the 4-bank group of the unit
    for instr in group:
        for quarter in instr.reshape(-1, 8):
            assert len(set(quarter.tolist())) == 8


def replay(a, b, lam_p, lam_r, row_start, rc, zeros=False):
    """Every block of the whole-tile kernel, on numpy arrays; ``zeros``:
    the strip's divide, 0 / x as 0 x x for a finite nonzero x."""
    c, m, pa = a.shape
    pb = b.shape[2]
    out = np.full((c, pa + pb, rc), np.nan, np.float32)
    hits = np.zeros(out.shape, np.int64)
    wr, wq, ws = writes()
    rr, rq, rs = reads()
    for ci in range(c):
        for bx in range((pa + pb) // T):
            for by in range(rc // T):
                p0, r0 = bx * T, by * T
                x, p = (a, p0) if p0 < pa else (b, p0 - pa)
                src = x[ci, row_start + r0 : row_start + r0 + T, p : p + T]
                tile = np.zeros((T, Q, 4), np.float32)
                tile[wr, ws] = src.reshape(T, Q, 4)[wr, wq]
                s = tile[rr, rs]  # (4 j, thread, 4 i)
                r4, p4 = THREAD % 16, THREAD // 16
                for i in range(4):
                    o = s[:, :, i].T  # (thread, j)
                    if lam_p is not None:
                        den = (lam_p[p0 + 4 * p4 + i][:, None]
                               + lam_r[row_start + r0 + 4 * r4[:, None] + np.arange(4)])
                        if zeros:
                            with np.errstate(divide="ignore", invalid="ignore"):
                                o = np.where((o == 0) & (den != 0) & np.isfinite(den),
                                             o * den, o / den)
                        else:
                            o = o / den
                    for j in range(4):
                        pos = (ci, p0 + 4 * p4 + i, r0 + 4 * r4 + j)
                        out[pos] = o[:, j]
                        np.add.at(hits, pos, 1)
    assert (hits == 1).all()
    return out


@pytest.mark.parametrize("pab,m,windows", [((64, 128), 192, ((0, 192), (0, 128), (64, 64))),
                                           ((128, 64), 128, ((0, 128), (4, 64)))])
def test_transpose_pair_tiles_match_plain(pab, m, windows):
    pa, pb = pab
    rng = np.random.default_rng(pa + m)
    a = (rng.normal(size=(2, m, pa)) * 40).astype(np.float32)
    b = (rng.normal(size=(2, m, pb)) * 40).astype(np.float32)
    lam_p = (rng.random(pa + pb) * 4 + 0.5).astype(np.float32)
    lam_r = (rng.random(m) * 4 + 0.5).astype(np.float32)
    ta, tb, tlp, tlr = (torch.from_numpy(x) for x in (a, b, lam_p, lam_r))
    for rs, rc in windows:
        assert np.array_equal(replay(a, b, None, None, rs, rc),
                              K.transpose_pair_plain(ta, tb, row_start=rs, row_count=rc).numpy())
        assert np.array_equal(replay(a, b, lam_p, lam_r, rs, rc),
                              K.transpose_pair_plain(ta, tb, tlp, tlr, rs, rc).numpy())


def test_strip_choice_is_the_sources():
    """The host takes the zero-product divide for a whole-tile window whose
    grid leaves fewer than two blocks an SM."""
    text = SOURCE.read_text()
    assert "if ((long long)grid.x * grid.y * c < 2LL * sms) {  // a strip" in text
    assert "if (kDiv && kZeros) o[j] = quotient(o[j], at(lp, i) + at(lr, j));" in text
    assert ("return v == 0.0f && den != 0.0f && fabsf(den) <= 3.402823466e38f ? v * den : "
            "v / den;") in text


def _bits(x):
    return np.ascontiguousarray(x, np.float32).view(np.int32)


@pytest.mark.parametrize("n_pab,m,windows", [
    ((2396, (1280, 1280)), 128, ((0, 128), (64, 64), (4, 64))),  # the strips' shapes
    ((255, (128, 128)), 128, ((0, 128), (64, 64)))])
def test_transpose_pair_strip_divide_matches_plain(n_pab, m, windows):
    """The strip's divide on the chain's zeros (the other side's padding
    rows, the fold's padding lanes) with the grouped eigenvalues of n along
    p and padded ones along r: the twin's values and zero signs."""
    from seamlesscloneoptimization_tpu_torch.solvers.dst_gemm import (
        dst_eigenvalues_grouped,
        dst_eigenvalues_padded,
    )

    n, (pa, pb) = n_pab
    rng = np.random.default_rng(n + m)
    a = (rng.normal(size=(3, m, pa)) * 40).astype(np.float32)
    b = (rng.normal(size=(3, m, pb)) * 40).astype(np.float32)
    for x, lanes in ((a, n - n // 2), (b, n // 2)):
        x[:, m - 6 :] = 0
        x[..., lanes:] = 0
    a[0, :3, :5] = 0.0  # 0 / a negative sum: -0
    lam_p = dst_eigenvalues_grouped(n)
    lam_r = dst_eigenvalues_padded(m - 6, m)
    ta, tb, tlp, tlr = (torch.from_numpy(x.copy()) for x in (a, b, lam_p, lam_r))
    for rs, rc in windows:
        want = K.transpose_pair_plain(ta, tb, tlp, tlr, rs, rc).numpy()
        got = replay(a, b, lam_p, lam_r, rs, rc, zeros=True)
        assert np.array_equal(_bits(got), _bits(want)), (rs, rc)
        if rs == 0:  # the signed zeros of 0 / a negative sum are there
            assert np.signbit(got[0, :5, :3]).all()
