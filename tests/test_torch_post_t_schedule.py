"""A numpy rehearsal of postprocess_transposed's tiles
(csrc/postprocess_transposed.cu on csrc/paste_words.cuh's paste_run), on
the CPU.

Where h2 % 4 == 0 and u_t is 16-byte aligned, a block of kThreads threads
owns kTR destination rows x kTJ destination columns: each thread issues its
16-byte cp.async copies along u_t's rows into a shared [j][r] tile of
float4 units, XOR-swizzled (unit (j, q) at column q ^ ((j >> 3) & 7)); a
copy past u_t's rows or columns reads nothing and fills zeros. Then warp w
reads the 4 x 8 block of rows 4 w .. 4 w + 3 and columns 8 lane .. 8 lane + 7,
packs each row's 8 bytes into two words and writes the row's run with
``paste_run`` (planar: aligned 8-byte words joined across lanes;
interleaved: a byte a lane). Any other shape takes the first design,
``postprocess_transposed_ragged``, a byte store per pixel. The kernel does
not run here, so this file replays every block on u_t's floats and on the
destination's bytes (addresses into flat buffers whose index 0 is 16-byte
aligned), checks that every 16-byte copy is aligned and reads inside u_t,
that the shared tile's float4 writes and reads are free of bank conflicts
(8 lanes a phase on 8 different 16-byte columns of a 128-byte row) and
each cell written once, that every store is aligned to its size and stays
in the buffer, that every byte of the interior is written exactly once and
no other byte at all, and holds the buffer equal to the plain twin's
(``K.postprocess_transposed_plain``) bit for bit.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch
from test_torch_paste_dense_schedule import SPECIAL, Source
from test_torch_paste_schedule import Dest, cast_byte, pack4, paste_run

from seamlesscloneoptimization_tpu_torch.ops import kernels as K

torch.set_num_threads(1)

SOURCE = Path(K.__file__).resolve().parent.parent / "csrc" / "postprocess_transposed.cu"


def _consts():
    text = SOURCE.read_text()
    return tuple(int(re.search(rf"constexpr int {k} = (\d+);", text).group(1))
                 for k in ("kTR", "kTJ"))


TR, TJ = _consts()
Q = TR // 4  # float4 units a u_t row of the tile
THREADS = 32 * TR // 4
LOADS = TJ * Q // THREADS
LOAD_ROWS = THREADS // Q


def swizzle(j, q):
    return q ^ ((j >> 3) & 7)


def _phases_distinct(cols):
    """A warp's float4 shared access, 8 lanes a phase: conflict-free when
    the 8 lanes of each phase hit 8 different 16-byte columns of the
    128-byte tile row."""
    for ph in range(4):
        assert len(set(cols[8 * ph : 8 * ph + 8])) == 8, cols


def tile_blocks(src, c, h2, w2, dst, top1, left1):
    """Every block of postprocess_transposed_kernel, replayed."""
    sc, sh, sw = dst.strides
    assert Q == 8 and TJ == 256  # one 128-byte row a tile row, one chunk a lane
    ny, nz = -(-h2 // TR), -(-w2 // TJ)
    for cz in range(c):
        for by in range(ny):
            for bz in range(nz):
                r0, j0 = TR * (ny - 1 - by), TJ * (nz - 1 - bz)  # from u_t's end
                tile = np.zeros((TJ, Q, 4), np.float32)
                written = np.zeros((TJ, Q), np.int32)
                for i in range(LOADS):
                    cols = []
                    for t in range(THREADS):
                        q, jr = t % Q, t // Q
                        j = jr + LOAD_ROWS * i
                        if r0 + 4 * q < h2 and j0 + j < w2:
                            at = src.off + (cz * w2 + j0 + j) * h2 + r0 + 4 * q
                            v = src.load(at, 4)
                        else:  # the copy's zero fill
                            v = [0.0] * 4
                        tile[j, swizzle(j, q)] = v
                        written[j, swizzle(j, q)] += 1
                        cols.append(swizzle(j, q))
                        if t % 32 == 31:
                            _phases_distinct(cols[-32:])
                assert (written == 1).all()
                for w in range(THREADS // 32):
                    if r0 + 4 * w >= h2:
                        continue  # the warp returns
                    s = []
                    for k in range(8):
                        cols = [swizzle(8 * lane + k, w) for lane in range(32)]
                        _phases_distinct(cols)
                        s.append([tile[8 * lane + k, cols[lane]] for lane in range(32)])
                    for i in range(4):
                        own = [[(pack4(*(s[k][lane][i] for k in range(4))),
                                 pack4(*(s[k][lane][i] for k in range(4, 8))))
                                for lane in range(32)]]
                        row = dst.off + cz * sc + (top1 + r0 + 4 * w + i) * sh + left1 * sw
                        paste_run(dst, row, sw, j0, w2, own)


def ragged_blocks(src, c, h2, w2, dst, top1, left1):
    """postprocess_transposed_ragged: a scalar load and a byte store per pixel."""
    sc, sh, sw = dst.strides
    for cz in range(c):
        for j in range(w2):
            for r in range(h2):
                v = src.load(src.off + (cz * w2 + j) * h2 + r, 1)[0]
                dst.store(dst.off + cz * sc + (top1 + r) * sh + (left1 + j) * sw, 1, cast_byte(v))


def _case(h2, w2, top1, left1, base, interleaved, seed, c=3, uoff=0, margin=(2, 3)):
    rng = np.random.default_rng(seed)
    u_t = rng.uniform(-60.0, 320.0, (c, w2, h2)).astype(np.float32)
    pick = rng.random(u_t.shape) < 0.15
    u_t[pick] = rng.choice(SPECIAL, int(pick.sum()))
    ubuf = np.full(-(-(uoff + u_t.size) // 4) * 4 + 4, np.nan, np.float32)
    ubuf[uoff : uoff + u_t.size] = u_t.ravel()
    src = Source(ubuf, uoff, u_t.size)
    hh, ww = top1 + h2 + margin[0], left1 + w2 + margin[1]
    buf = rng.integers(0, 256, -(-(base + c * hh * ww) // 16) * 16).astype(np.uint8)
    strides = (1, ww * c, c) if interleaved else (hh * ww, ww, 1)
    dst = Dest(buf.copy(), base, strides)
    whole = h2 % 4 == 0 and uoff % 4 == 0
    (tile_blocks if whole else ragged_blocks)(src, c, h2, w2, dst, top1, left1)
    want = Dest(buf.copy(), base, strides)
    K.postprocess_transposed_plain(torch.from_numpy(u_t), want.tensor((c, hh, ww)), top1, left1)
    inside = np.zeros(buf.size, bool)
    idx = (base + np.arange(c)[:, None, None] * strides[0]
           + (top1 + np.arange(h2))[None, :, None] * strides[1]
           + (left1 + np.arange(w2))[None, None, :] * strides[2])
    inside[idx.ravel()] = True
    assert (dst.writes[inside] == 1).all(), "a byte of the interior not written exactly once"
    assert (dst.writes[~inside] == 0).all(), "a byte outside the interior written"
    assert np.array_equal(dst.buf, want.buf)
    return src.loads


@pytest.mark.parametrize("left1", range(1, 9))
def test_post_t_every_offset(left1):
    """left1 at every residue mod 8 of a planar destination whose base is
    not 8-byte aligned, odd and even top1; a tile row cut by h2 and a
    column tile cut by w2."""
    loads = _case(36, TJ + 29 + left1, 1 + left1 % 2, left1, 5, False, left1, c=2)
    assert loads[4] and not loads[1]


@pytest.mark.parametrize("interleaved", [False, True])
@pytest.mark.parametrize("hw", [(4, 1), (8, 9), (TR, TJ), (44, 40), (4, 2 * TJ + 3)])
def test_post_t_shapes(hw, interleaved):
    """Whole tiles and cut ones, a single float4 unit, one column, a run
    across three column tiles; planar and interleaved."""
    h2, w2 = hw
    _case(h2, w2, 3, 7, 3, interleaved, h2 * w2, c=2)


@pytest.mark.parametrize("interleaved", [False, True])
@pytest.mark.parametrize("h2, uoff", [(37, 0), (6, 0), (1, 0), (3, 0), (12, 2), (8, 1)])
def test_post_t_ragged_route(h2, uoff, interleaved):
    """h2 % 4 != 0, or u_t not 16-byte aligned: the first design's byte
    stores, no vector load."""
    loads = _case(h2, 21, 5, 3, 1, interleaved, 100 * h2 + uoff, uoff=uoff)
    assert not loads[4] and loads[1]
