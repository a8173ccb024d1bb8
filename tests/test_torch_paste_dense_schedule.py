"""A numpy rehearsal of clamp_cast_paste's warp walk (csrc/clamp_cast_paste.cu
on csrc/paste_words.cuh's paste_run), on the CPU.

A warp owns kSpan columns of one destination row; lane l reads kParts
8-pixel chunks of the dense source row (chunk n = 32 p + l, 256 columns
apart) with loads whose width the row's address picks (float4 where it is
16-byte aligned, float2 where it is 8-byte aligned, scalars otherwise; a
load that w2 cuts takes scalars, nothing past w2 is read), clamps,
truncates and packs them into two 32-bit words, and ``paste_run`` writes
the run: a planar row as aligned 8-byte words joined across lanes at the
row's byte offset, pieces at the ends; an interleaved row a byte a lane.
The kernel does not run here, so this file replays every warp on u's
floats and on the destination's bytes (each an address into a flat buffer
whose index 0 is 16-byte aligned, as device allocations are), checks that
every vector load is aligned and reads inside u, that every store is
aligned to its size and stays in the buffer, that every byte of the
rectangle is written exactly once and no other byte at all, and holds the
buffer equal to the plain twin's (``K.clamp_cast_paste_plain``) bit for bit.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch
from test_torch_paste_schedule import Dest, pack4, paste_run

from seamlesscloneoptimization_tpu_torch.ops import kernels as K

torch.set_num_threads(1)

SOURCE = Path(K.__file__).resolve().parent.parent / "csrc" / "clamp_cast_paste.cu"


def _consts():
    text = SOURCE.read_text()
    return tuple(int(re.search(rf"constexpr int {k} = (\d+);", text).group(1))
                 for k in ("kParts", "kRows"))


PARTS, ROWS = _consts()
SPAN = 32 * 8 * PARTS
SPECIAL = np.array([254.9999, -0.0, 255.0, 255.5, 256.0, -0.5, -3.7, 0.0, 0.9999, 1e9, -1e9,
                    127.5], np.float32)


class Source:
    """A flat f32 buffer (index 0 16-byte aligned), the float offset of the
    array's element 0 and its extent; ``loads`` counts loads by width."""

    def __init__(self, buf, off, size):
        self.buf, self.off, self.size = buf, off, size
        self.loads = {1: 0, 2: 0, 4: 0}

    def load(self, at, width):
        assert at % width == 0, (at, width)  # 4 width-byte alignment
        assert self.off <= at and at + width <= self.off + self.size, (at, width)
        self.loads[width] += 1
        return list(self.buf[at : at + width])


def load8(src, row, j0, w2, width):
    """load8<width>: row[j0 .. j0 + 8) below w2 (0 past it); ``row`` the
    float address of the row's column 0."""
    v = []
    for k in range(0, 8, width):
        j = j0 + k
        if j + width <= w2:
            v += src.load(row + j, width)
        else:
            v += [src.load(row + j + i, 1)[0] if j + i < w2 else 0.0 for i in range(width)]
    return v


def paste_blocks(src, shape, dst, top1, left1, h2, w2):
    """Every warp of clamp_cast_paste_kernel, replayed."""
    c, hu, wu = shape
    sc, sh, sw = dst.strides
    nz = -(-h2 // ROWS)
    for cz in range(c):
        for bz, y in np.ndindex(nz, ROWS):
            r = (nz - 1 - bz) * ROWS + y  # the grid walks the rows from the last
            if r >= h2:
                continue  # the warp returns
            row = src.off + (cz * hu + r) * wu
            width = {0: 4, 2: 2}.get(row % 4, 1)
            for bx in range(-(-w2 // SPAN)):
                span0 = SPAN * bx
                own = [[None] * 32 for _ in range(PARTS)]
                for p in range(PARTS):
                    for lane in range(32):
                        v = load8(src, row, span0 + 8 * (32 * p + lane), w2, width)
                        own[p][lane] = (pack4(*v[:4]), pack4(*v[4:]))
                paste_run(dst, dst.off + cz * sc + (top1 + r) * sh + left1 * sw, sw, span0, w2,
                          own)


def _case(h2, w2, wu, top1, left1, base, interleaved, seed, c=3, hu=None, uoff=0,
          margin=(1, 5)):
    rng = np.random.default_rng(seed)
    hu = h2 + 1 if hu is None else hu
    u = (rng.normal(size=(c, hu, wu)) * 160 + 90).astype(np.float32)
    pick = rng.random(u.shape) < 0.15
    u[pick] = rng.choice(SPECIAL, int(pick.sum()))
    ubuf = np.full(-(-(uoff + u.size) // 4) * 4, np.nan, np.float32)
    ubuf[uoff : uoff + u.size] = u.ravel()
    src = Source(ubuf, uoff, u.size)
    hh, ww = top1 + h2 + margin[0], left1 + w2 + margin[1]
    buf = rng.integers(0, 256, -(-(base + c * hh * ww) // 16) * 16).astype(np.uint8)
    strides = (1, ww * c, c) if interleaved else (hh * ww, ww, 1)
    dst = Dest(buf.copy(), base, strides)
    paste_blocks(src, (c, hu, wu), dst, top1, left1, h2, w2)
    want = Dest(buf.copy(), base, strides)
    K.clamp_cast_paste_plain(torch.from_numpy(u), want.tensor((c, hh, ww)), top1, left1, h2, w2)
    inside = np.zeros(buf.size, bool)
    idx = (base + np.arange(c)[:, None, None] * strides[0]
           + (top1 + np.arange(h2))[None, :, None] * strides[1]
           + (left1 + np.arange(w2))[None, None, :] * strides[2])
    inside[idx.ravel()] = True
    assert (dst.writes[inside] == 1).all(), "a byte of the rectangle not written exactly once"
    assert (dst.writes[~inside] == 0).all(), "a byte outside the rectangle written"
    assert np.array_equal(dst.buf, want.buf)
    return src.loads


@pytest.mark.parametrize("wu_mod", range(4))
@pytest.mark.parametrize("left1", range(8))
def test_dense_paste_every_offset(left1, wu_mod):
    """left1 at every residue mod 8 of a planar destination whose base is
    not 8-byte aligned, u's width at every residue mod 4 (rows that start
    at every float offset mod 4), a run past one warp's span cut by w2."""
    w2 = SPAN + 37 + 2 * left1
    wu = w2 + (wu_mod - w2) % 4 + 4 * (left1 % 2)
    loads = _case(5, w2, wu, 2, left1, 3, False, 8 * left1 + wu_mod)
    assert loads[4] and (loads[2] > 0) == (wu_mod != 0) and loads[1]


@pytest.mark.parametrize("wu_mod", range(4))
def test_dense_paste_exact_size(wu_mod):
    """An exact-size solution, w2 == wu (as the jacobi, dst_fft, DD and
    mg_padded=False frames paste it), at every residue mod 4, planar and
    interleaved, odd top1."""
    w2 = 300 + wu_mod
    for interleaved in (False, True):
        _case(4, w2, w2, 3, 5 + wu_mod, 1, interleaved, 40 + wu_mod, hu=4)


def test_dense_paste_8k_exact_width():
    """The 8K exact-size rows, wu = w2 = 3798 (2 mod 4): every other row's
    start 8 bytes past a 16-byte boundary takes float2 loads, the others
    float4, and no vector load is misaligned."""
    loads = _case(2, 3798, 3798, 1, 1, 0, False, 3798, c=1, hu=2, margin=(0, 0))
    assert loads[4] > 0 and loads[2] > 0


@pytest.mark.parametrize("uoff", range(4))
def test_dense_paste_unaligned_source(uoff):
    """u a contiguous view at float offsets 0 .. 3 of a 16-byte aligned
    buffer (a storage offset), planar and interleaved."""
    for interleaved in (False, True):
        _case(3, 70, 72, 1, 9, 5, interleaved, 60 + uoff, uoff=uoff)


@pytest.mark.parametrize("interleaved", [False, True])
@pytest.mark.parametrize("hw", [(1, 1), (1, 300), (12, 1), (9, 2 * SPAN + 3), (3, 37),
                                (2, 8)])
def test_dense_paste_shapes(hw, interleaved):
    """A one-pixel, a one-row and a one-column rectangle, a run across
    three spans, w2 below one warp's span, a single chunk."""
    h2, w2 = hw
    _case(h2, w2, w2 + 3, 4, 11, 7, interleaved, h2 * w2, margin=(2, 11))


@pytest.mark.parametrize("c", [1, 4])
def test_dense_paste_channels(c):
    """One channel, and more than three."""
    _case(6, 300, 304, 1, 6, 5, False, 31 * c, c=c)
