"""A numpy rehearsal of clamp_cast_paste_q's warp walk
(csrc/clamp_cast_paste_q.cu), on the CPU.

A warp owns kSpan dense columns of one destination row; lane l packs the
clamped, truncated bytes of kParts 8-byte chunks (chunk n = 32 p + l, 256
columns apart) from one float4 of the row's even and one of its odd
quarter plane. On a planar row, which starts at any byte offset e (its
address mod 8), the thread of chunk n writes the aligned 8-byte word that
holds the last e bytes of chunk n - 1 (its neighbour lane's, by a shuffle)
and the first 8 - e of its own; a word that is not whole inside the row's
[0, w2) goes out in aligned pieces of 4, 2 and 1 bytes, and lane 31 writes
the tail of the warp's last chunk. An interleaved destination takes byte
stores, a pixel a lane. The kernel does not run here, so this file
replays every warp on the destination's bytes (each view an address into
a flat buffer whose length rounds up to 16 bytes and whose index 0 is
16-byte aligned, as device allocations are), checks that every store is
aligned to its size and stays in the buffer, that every byte of the
rectangle is written exactly once and no other byte at all, and holds the
buffer equal to the plain twin's (``K.clamp_cast_paste_q_plain``) bit for
bit. The store walk is ``paste_run`` (csrc/paste_words.cuh's, which
clamp_cast_paste and postprocess_transposed share: their replays import
it from here).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from seamlesscloneoptimization_tpu_torch.ops import kernels as K

torch.set_num_threads(1)

SOURCE = Path(K.__file__).resolve().parent.parent / "csrc" / "clamp_cast_paste_q.cu"


def _consts():
    text = SOURCE.read_text()
    return tuple(int(re.search(rf"constexpr int {k} = (\d+);", text).group(1))
                 for k in ("kParts", "kRows"))


PARTS, ROWS = _consts()
SPAN = 32 * 8 * PARTS
M32 = 0xFFFFFFFF


def funnel(lo, hi, shift):
    """__funnelshift_r: the low 32 bits of hi:lo >> (shift & 31)."""
    return ((hi << 32 | lo) >> (shift & 31)) & M32


def cast_byte(v):
    return int(np.fmin(np.fmax(np.float32(v), np.float32(0)), np.float32(255)))


def pack4(a, b, c, d):
    return cast_byte(a) | cast_byte(b) << 8 | cast_byte(c) << 16 | cast_byte(d) << 24


def load4(row, m0, need, vec):
    """Quarter columns m0 .. m0 + 3 of a plane row, 0 past ``need``."""
    if vec:
        if m0 >= need:
            return [0.0] * 4
        assert m0 % 4 == 0 and m0 + 4 <= row.size  # one aligned float4 in the row
        return list(row[m0 : m0 + 4])
    return [row[m0 + k] if m0 + k < need else 0.0 for k in range(4)]


def join(p0, p1, q0, q1, e):
    sb = 8 - e
    wq, bs = sb >> 2, 8 * (sb & 3)
    x0 = p0 if wq == 0 else p1 if wq == 1 else q0
    x1 = p1 if wq == 0 else q0 if wq == 1 else q1
    x2 = q0 if wq == 0 else q1
    return funnel(x0, x1, bs), funnel(x1, x2, bs)


class Dest:
    """The destination's flat buffer, the byte address of element (0, 0, 0)
    of its (C, H, W) view and the view's element strides; ``writes`` counts
    the stores to each byte."""

    def __init__(self, buf, off, strides):
        self.buf, self.off, self.strides = buf, off, strides
        self.writes = np.zeros(buf.size, np.int32)

    def store(self, addr, nbytes, value):
        assert addr % nbytes == 0, (addr, nbytes)
        assert 0 <= addr and addr + nbytes <= self.buf.size
        for b in range(nbytes):
            self.buf[addr + b] = (value >> (8 * b)) & 0xFF
            self.writes[addr + b] += 1

    def tensor(self, shape):
        return torch.as_strided(torch.from_numpy(self.buf), shape, self.strides, self.off)


def store_part(dst, a, v, lo, hi):
    x = v[0] | v[1] << 32
    o = lo
    while o < hi:
        if o & 3 == 0 and o + 4 <= hi:
            dst.store(a + o, 4, x >> (8 * o))
            o += 4
        elif o & 1 == 0 and o + 2 <= hi:
            dst.store(a + o, 2, x >> (8 * o))
            o += 2
        else:
            dst.store(a + o, 1, x >> (8 * o))
            o += 1


def store_word(dst, row, j, e, v, lo, w2):
    at = j - e
    hi = min(w2, at + 8)
    lo = max(lo, 0)
    if lo >= hi:
        return
    if lo == at and hi == at + 8:
        dst.store(row + at, 8, v[0] | v[1] << 32)
    else:
        store_part(dst, row + at, v, lo - at, hi - at)


def paste_run(dst, row, sw, span0, w2, own):
    """paste_words.cuh's paste_run for one warp: own[p][lane] is the words
    (w0, w1) of chunk 32 p + lane; ``row`` the byte address of the row's
    column 0."""
    parts = len(own)
    if sw != 1:  # a pixel a lane: byte lane % 8 of lane 4 t + lane / 8's chunk
        for p in range(parts):
            for t in range(8):
                for lane in range(32):
                    j, b = span0 + 256 * p + 32 * t + lane, lane & 7
                    if j < w2:
                        dst.store(row + j * sw, 1, own[p][4 * t + (lane >> 3)][b >> 2]
                                  >> (8 * (b & 3)))
        return
    e = row % 8
    for p in range(parts):
        for lane in range(32):
            j0 = span0 + 8 * (32 * p + lane)
            # the previous lane's words (lane 0: lane 31's, of the previous part;
            # of part 0, the shuffle's wrap, whose bytes are not stored)
            q = own[p - 1][31] if lane == 0 and p > 0 else own[p][(lane + 31) % 32]
            v = join(*q, *own[p][lane], e)
            store_word(dst, row, j0, e, v, j0 if lane == 0 and p == 0 else j0 - e, w2)
    if e != 0:  # lane 31: the tail of the warp's last chunk
        j1 = span0 + 256 * parts
        store_word(dst, row, j1, e, join(*own[parts - 1][31], 0, 0, e), j1 - e, min(w2, j1))


def paste_blocks(uq, dst, top1, left1, h2, w2, vec):
    """Every warp of clamp_cast_paste_q_kernel<vec>, replayed."""
    c, _, hq, wq2 = uq.shape
    sc, sh, sw = dst.strides
    need = (w2 + 1) >> 1
    for cz in range(c):
        for r in range(-(-h2 // ROWS) * ROWS):
            if r >= h2:
                continue  # the warp returns
            ev, od = uq[cz, 2 * (r & 1), r >> 1], uq[cz, 2 * (r & 1) + 1, r >> 1]
            for bx in range(-(-w2 // SPAN)):
                span0 = SPAN * bx
                own = [[None] * 32 for _ in range(PARTS)]
                for p in range(PARTS):
                    for lane in range(32):
                        m0 = (span0 >> 1) + 4 * (32 * p + lane)
                        a, b = load4(ev, m0, need, vec), load4(od, m0, need, vec)
                        own[p][lane] = (pack4(a[0], b[0], a[1], b[1]),
                                        pack4(a[2], b[2], a[3], b[3]))
                paste_run(dst, dst.off + cz * sc + (top1 + r) * sh + left1 * sw, sw, span0, w2,
                          own)


def _case(h2, w2, top1, left1, base, interleaved, seed, c=3, vec=True, margin=(1, 5)):
    rng = np.random.default_rng(seed)
    hh, ww = top1 + h2 + margin[0], left1 + w2 + margin[1]
    if vec:
        _, hq, wq2, _ = K.mg_geometry_q(h2, w2)
    else:  # a plane width that is no multiple of 4: the scalar loads
        hq, wq2 = (h2 + 1) // 2, (w2 + 1) // 2 + 1 + ((w2 + 1) // 2) % 2
    uq = (rng.normal(size=(c, 4, hq, wq2)) * 160 + 90).astype(np.float32)
    special = np.array([254.9999, -0.0, 255.0, 255.5, 256.0, -0.5, -3.7, 0.0, 0.9999, 1e9,
                        -1e9, 127.5], np.float32)
    pick = rng.random(uq.shape) < 0.15
    uq[pick] = rng.choice(special, int(pick.sum()))
    size = c * hh * ww
    buf = np.zeros(-(-(base + size) // 16) * 16, np.uint8)
    buf[:] = rng.integers(0, 256, buf.size, np.uint8)
    strides = (1, ww * c, c) if interleaved else (hh * ww, ww, 1)
    dst = Dest(buf.copy(), base, strides)
    paste_blocks(uq, dst, top1, left1, h2, w2, vec)
    want = Dest(buf.copy(), base, strides)
    K.clamp_cast_paste_q_plain(torch.from_numpy(uq), want.tensor((c, hh, ww)), top1, left1,
                               h2, w2)
    inside = np.zeros(buf.size, bool)
    idx = (base + np.arange(c)[:, None, None] * strides[0]
           + (top1 + np.arange(h2))[None, :, None] * strides[1]
           + (left1 + np.arange(w2))[None, None, :] * strides[2])
    inside[idx.ravel()] = True
    return dst, want, inside


def _holds(dst, want, inside):
    assert (dst.writes[inside] == 1).all(), "a byte of the rectangle not written exactly once"
    assert (dst.writes[~inside] == 0).all(), "a byte outside the rectangle written"
    assert np.array_equal(dst.buf, want.buf)


@pytest.mark.parametrize("left1", range(16))
def test_paste_schedule_every_offset(left1):
    """left1 at every offset mod 16 of a planar destination whose base is
    not 16-byte aligned; top1 even and odd, h2 and w2 odd and even, a w2
    past one warp's span."""
    for h2, w2, top1, base in ((7, 37, 2, 3), (6, SPAN + 19, 1, 0), (5, 8, 3, 13)):
        _holds(*_case(h2, w2, top1, left1, base, False, 16 * left1 + w2))


@pytest.mark.parametrize("interleaved", [False, True])
@pytest.mark.parametrize("vec", [True, False])
def test_paste_schedule_layouts(interleaved, vec):
    """Planar and interleaved, the float4 and the scalar loads, rows whose
    starts fall at every offset mod 8 (an odd image width), a one-column
    and a one-row rectangle."""
    for h2, w2, top1, left1, base in ((9, 2 * SPAN + 3, 0, 5, 7), (1, 1, 4, 9, 1),
                                      (12, 1, 1, 0, 0), (3, 250, 5, 11, 6)):
        _holds(*_case(h2, w2, top1, left1, base, interleaved, h2 * w2 + left1, vec=vec,
                      margin=(2, 11)))


@pytest.mark.parametrize("c", [1, 4])
def test_paste_schedule_channels(c):
    """One channel, and more than three."""
    _holds(*_case(6, 300, 1, 6, 5, False, 31 * c, c=c))
