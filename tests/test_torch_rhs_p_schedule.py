"""A numpy rehearsal of preprocess_rhs_p's block and thread walk
(csrc/preprocess_rhs_p.cu on csrc/rhs_wide.cuh), on the CPU.

The kernel is preprocess_rhs_q's walk with a natural store: one block of
kTX x kTY threads for all channels (up to kMaxC) of a 16 x 256 dense tile,
the windows of the mask and of every channel's destination and patch
staged as stage_rows stages them (16-byte chunks from the aligned chunk
below each row's first pixel, bytes for other strides), two row passes of
a 2 x 4 patch a thread (NORMAL interiors in 16-bit lanes), each patch
stored as two float4 rows where the slab's width is a multiple of 4, else
as scalars cut at the slab's edge; blocks wholly in the zero padding
(first dense row >= h - 2 or column >= w - 2) stage nothing and store
zeros. The kernel does not run here, so this file replays every block on
the inputs' bytes with test_torch_rhs_schedule.py's helpers (each copy
checked to stay in its buffer), counts the writes to every slab element
(exactly one each; the slab starts as NaN) and holds the slab equal to the
plain twin (``K.preprocess_rhs_p_plain``) bit for bit.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch
from test_torch_rhs_schedule import (
    CHUNKS,
    MAX_C,
    PASS_R,
    PASSES,
    TILE_C,
    TILE_R,
    TX,
    TY,
    WIN_R,
    View,
    _contiguous_view,
    _image_view,
    _padded,
    lane_mask,
    lanes,
    rhs_patch,
    rhs_patch_packed,
    stage_row,
    thread_words,
)

from seamlesscloneoptimization_tpu_torch.ops import kernels as K

torch.set_num_threads(1)

SOURCE = Path(K.__file__).resolve().parent.parent / "csrc" / "preprocess_rhs_p.cu"


def test_the_kernel_runs_on_rhs_wide():
    """The source includes rhs_wide.cuh (whose constants the helpers parse)
    and uses its window and staging."""
    text = SOURCE.read_text()
    assert re.search(r'#include "rhs_wide.cuh"', text)
    assert "stage_rows<" in text and "Window" in text and "rhs_patch_packed" in text
    assert CHUNKS * 16 >= 4 * TX + 8 + 15  # a row's pixels from any byte shift


def _store(out, n_out, k, r, j, lap, ok, vec, hpo, wpo):
    """store_patch for every thread of a pass (arrays of (TY, TX))."""
    for i in range(2):
        for kk in range(4):
            rr, jj = r + i, j + kk
            put = ok & (rr < hpo) & (jj < wpo)
            if vec:
                assert ((jj[ok & (r + i < hpo)] < wpo)).all()  # whole float4 rows
            out[k, rr[put], jj[put]] = lap[i, kk][put]
            np.add.at(n_out, (k, rr[put], jj[put]), 1)


def _pass(staged, q, r0, j0, ty, tx, c_lo, nc, h, w, hpo, wpo, mode, vec, out, n_out):
    """Row pass q of one tile (rhs_pass); staged None: a padding block."""
    wr0 = PASS_R * q
    y0, x0 = r0 + wr0 + 2 * ty, j0 + 4 * tx
    active = (y0 < hpo) & (x0 < wpo)
    if staged is None:
        zero = {(i, kk): np.zeros(ty.shape, np.float32) for i in range(2) for kk in range(4)}
        for k in range(nc):
            _store(out, n_out, c_lo + k, y0, x0, zero, active, vec, hpo, wpo)
        return

    def rows(a_idx, n):
        return [thread_words(staged[a_idx], ty, tx, wr0, a) for a in range(n)]

    M = rows(0, 3)
    mm = [[lane_mask(lanes(M[a], f)) for f in range(3)] for a in range(3)]
    packed = (mode == 0) & (y0 >= 1) & (y0 + 2 < h - 2) & (x0 >= 1) & (x0 + 4 < w - 2)
    for k in range(nc):
        D, P = rows(1 + k, 4), rows(1 + nc + k, 4)
        slow = rhs_patch(D, P, M, y0, x0, h, w, mode)
        fast = rhs_patch_packed(D, P, mm) if mode == 0 else slow
        lap = {key: np.where(packed, fast[key], slow[key]) for key in slow}
        _store(out, n_out, c_lo + k, y0, x0, lap, active, vec, hpo, wpo)


def rhs_p_blocks(dest: View, patch: View, me: View, c, h, w, out_hw, mode, out_off=0):
    """Every block of preprocess_rhs_p_kernel<mode>, replayed. Returns the
    slab (c, hpo, wpo) and the writes to each element. out_off: the slab's
    byte offset mod 16 (the float4 stores need 0)."""
    hpo, wpo = out_hw
    vec = wpo % 4 == 0 and out_off % 16 == 0
    out = np.full((c, hpo, wpo), np.nan, np.float32)
    n_out = np.zeros(out.shape, np.int32)
    ty, tx = np.meshgrid(np.arange(TY), np.arange(TX), indexing="ij")
    for bz in range(-(-c // MAX_C)):
        c_lo = bz * MAX_C
        nc = min(MAX_C, c - c_lo)
        arrays = [(me.buf, me.off, w, 1)]
        arrays += [(dest.buf, dest.off + (c_lo + k) * dest.strides[0], *dest.strides[1:])
                   for k in range(nc)]
        arrays += [(patch.buf, patch.off + (c_lo + k) * patch.strides[0], *patch.strides[1:])
                   for k in range(nc)]
        for by in range(-(-hpo // TILE_R)):
            for bx in range(-(-wpo // TILE_C)):
                r0, j0 = by * TILE_R, bx * TILE_C
                staged = None
                if r0 < h - 2 and j0 < w - 2:
                    staged = [[stage_row(buf, base, sh, sw, r0 + ry, j0, w, h)
                               for ry in range(WIN_R)] for buf, base, sh, sw in arrays]
                for q in range(PASSES):
                    _pass(staged, q, r0, j0, ty, tx, c_lo, nc, h, w, hpo, wpo, mode, vec,
                          out, n_out)
    return out, n_out


def _case(h, w, left, out_pad, interleaved, gray, mode, seed, c=3, out_off=0):
    rng = np.random.default_rng(seed)
    dest = _image_view(rng, c, h, w, left, interleaved)
    if gray:
        g = rng.integers(0, 256, (h, w), np.uint8)
        buf = _padded(g.size + 5)
        buf[5 : 5 + g.size] = g.reshape(-1)
        patch = View(buf, 5, (0, w, 1))
    else:
        patch = _contiguous_view(rng.integers(0, 256, (c, h, w), np.uint8), (left + 3) % 16)
    me = _contiguous_view((rng.random((h, w)) < 0.7).astype(np.uint8), (left + 9) % 16)
    out_hw = (h - 2 + out_pad[0], w - 2 + out_pad[1])
    got, n_out = rhs_p_blocks(dest, patch, me, c, h, w, out_hw, mode, out_off)
    flags, rule = {0: (1, "opencv"), 1: (2, "opencv"), 2: (2, "norm")}[mode]
    want = K.preprocess_rhs_p_plain(dest.tensor((c, h, w)), patch.tensor((c, h, w)),
                                    me.tensor((h, w)), out_hw, flags, rule)
    return got, n_out, want.numpy()


@pytest.mark.parametrize("left", range(16))
def test_rhs_p_schedule_every_origin(left):
    """ROI origins at every byte offset mod 16 of a planar destination; the
    exact slab of a width 4k + 3 (wpo % 4 = 1) and of 16k + 6 (wpo % 4 = 0,
    float4 stores), and a slab padded past the interior on both axes."""
    for h, w, pad in ((23, 4 * 37 + 3, (0, 0)), (21, 16 * 9 + 6, (0, 0)),
                      (37, 16 * 9 + 3, (6, 131))):
        got, n_out, want = _case(h, w, left, pad, False, False, 0, 16 * left + w)
        assert (n_out == 1).all() and np.array_equal(got, want)


@pytest.mark.parametrize("wpo_mod", [0, 1, 2, 3])
def test_rhs_p_schedule_slab_widths(wpo_mod):
    """wpo % 4 = 0 .. 3 on the exact and on a padded slab (odd heights too);
    a slab whose base is not 16-byte aligned takes the scalar stores."""
    for h, pad_h in ((30, 0), (31, 3)):
        w = 4 * 40 + 2 + wpo_mod
        got, n_out, want = _case(h, w, 5, (pad_h, 0), False, False, 0, w + h)
        assert (n_out == 1).all() and np.array_equal(got, want)
        got, n_out, want = _case(h, w - 1, 6, (pad_h, 1), False, False, 0, w + h + 1)
        assert (n_out == 1).all() and np.array_equal(got, want)
    got, n_out, want = _case(20, 4 * 40 + 2, 5, (0, 0), False, False, 0, 3, out_off=8)
    assert (n_out == 1).all() and np.array_equal(got, want)


def test_rhs_p_schedule_zero_blocks():
    """A slab with whole blocks in the padding, below the interior and right
    of it (the 8K slab's last block row is one): exact zeros, each element
    written once, nothing staged for them."""
    for h, w, pad in ((19, 70, (2 * TILE_R + 5, 0)), (18, 40, (0, TILE_C + 9)),
                      (34, 258, (TILE_R, 2 * TILE_C))):
        got, n_out, want = _case(h, w, 3, pad, False, False, 0, h * w)
        assert (n_out == 1).all() and np.array_equal(got, want)
        assert not got[:, h - 2 :].any() and not got[:, :, w - 2 :].any()


@pytest.mark.parametrize("mode", [0, 1, 2])
@pytest.mark.parametrize("interleaved,gray", [(False, False), (True, False), (False, True),
                                              (True, True)])
def test_rhs_p_schedule_modes_and_strides(interleaved, gray, mode):
    """NORMAL, MIXED "opencv" and "norm" on the planar and the interleaved
    destination, with a patch of its own or the stride-0 gray patch, exact
    and padded slabs."""
    for h, w, left, pad in ((3, 3, 5, (0, 0)), (41, 131, 7, (10, 0)), (18, 262, 13, (0, 4)),
                            (25, 100, 0, (0, 0))):
        got, n_out, want = _case(h, w, left, pad, interleaved, gray, mode, h * w + mode)
        assert (n_out == 1).all() and np.array_equal(got, want)


@pytest.mark.parametrize("c", [1, 4])
def test_rhs_p_schedule_channel_groups(c):
    """One channel, and more channels than a block takes (two groups)."""
    got, n_out, want = _case(29, 150, 9, (2, 8), False, False, 0, 7 * c, c)
    assert (n_out == 1).all() and np.array_equal(got, want)
