"""A numpy rehearsal of erode3's block and lane walk (csrc/erode3.cu), on
the CPU.

Each warp of a block stages the input rows its kRW output rows need (the
launcher picks kRW = 8, 4 or 2, the most that still fills the card) as
16-byte chunks from the aligned chunk that holds column x_span - kLead of
each row (a row starts at any byte offset), zero-filling chunks that hold
no pixel of the row and rows outside the mask. Lane l packs staged chunk l
of a row into 16 bits (bit j = byte j != 0), shifts them across the row's
byte shift with its right neighbour's bits (a shuffle) so that they are
the columns [x_span - kLead + 16 l, + 16) of every row, zeroes the columns
outside the row, ANDs 7 rows, takes the horizontal radius-3 min on its own
and its neighbours' bits (shuffles), and writes the row's aligned output
chunk lane - 1 from bits 24 - so .. of those 48 (so = the output row's
byte shift), whole or in aligned 8/4/2/1-byte pieces where the row's ends
cut it. The kernel does not run here, so this file replays every block on
the 32-bit words (each array an address into a flat buffer whose length
rounds up to 16 bytes, as device allocations do), checks that every copy
stays in its buffer and every store is aligned, counts the writes to every
output byte (exactly one each, none outside the mask's bytes) and holds
the result equal to ``K.erode3_plain`` and, at one shape, to the JAX
package's ``erode3_pallas`` in interpret mode. The tile constants are
parsed from the source.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seamlesscloneoptimization_tpu.ops import pallas_kernels as PK
from seamlesscloneoptimization_tpu_torch.ops import kernels as K

torch.set_num_threads(1)

SOURCE = Path(K.__file__).resolve().parent.parent / "csrc" / "erode3.cu"


def _consts():
    text = SOURCE.read_text()
    consts = tuple(int(re.search(rf"constexpr int {k} = (\d+);", text).group(1))
                   for k in ("kWarps", "kR", "kSpan", "kLead", "kChunks", "kFillBlocks"))
    return consts, tuple(int(v) for v in re.findall(r"launch<(\d+)>\(in, o,", text))


(WARPS, R, SPAN, LEAD, CHUNKS, FILL), RWS = _consts()


def rows_per_warp(h, w):
    """erode3_launch's choice: the first kRW whose grid fills the card."""
    gx = -(-(w + 15) // SPAN)
    return next((rw for rw in RWS[:-1] if gx * -(-h // (WARPS * rw)) >= FILL), RWS[-1])
M32 = np.uint64(0xFFFFFFFF)


def _padded(n):
    return -(-n // 16) * 16


def funnel_r(lo, hi, s):
    x = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
    return ((x >> np.asarray(s, np.uint64)) & M32).astype(np.uint32)


def funnel_l(lo, hi, s):
    x = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
    return (((x << np.asarray(s, np.uint64)) >> np.uint64(32)) & M32).astype(np.uint32)


def inside(v):
    return (((v & np.uint32(0x7F7F7F7F)) + np.uint32(0x7F7F7F7F)) | v) & np.uint32(0x80808080)


def pack16(x):
    """pack16 on (..., 4) words: 16 bits, bit j = (byte j != 0)."""
    n = (inside(x) * np.uint32(0x00204081)) >> np.uint32(28)
    return (n[..., 0] | (n[..., 1] << 4)) | ((n[..., 2] | (n[..., 3] << 4)) << 8)


def unpack4(bits, at):
    return (((bits >> np.uint32(at)) & np.uint32(0xF)) * np.uint32(0x00204081)
            & np.uint32(0x01010101))


def shfl(x, src):
    """__shfl_sync over the lane axis (-1): lane l gets lane src[l]'s x."""
    return np.take_along_axis(x, np.broadcast_to(src, x.shape), axis=-1)


def stage(ibuf, base, ys, rows, xs, h, w):
    """A warp's band: (rows, CHUNKS * 16) bytes from image row ys, and the
    shift of each staged row."""
    band = np.zeros((rows, 16 * CHUNKS), np.uint8)
    shifts = np.zeros(rows, np.int64)
    for r in range(rows):
        y = ys + r
        row = base + y * w
        shifts[r] = (row + xs) % 16
        first = (row + xs) // 16 * 16
        for k in range(CHUNKS):
            chunk = first + 16 * k
            if 0 <= y < h and chunk < row + w and chunk + 16 > row:
                assert 0 <= chunk and chunk + 16 <= ibuf.size, "a copy leaves the buffer"
                band[r, 16 * k : 16 * k + 16] = ibuf[chunk : chunk + 16]
    return band, shifts


def store(obuf, writes, at, o, lo, hi):
    """The 16-byte word o (4 words) at the 16-aligned address at: bytes
    [lo, hi), whole or in aligned pieces of 8, 4, 2 and 1 bytes."""
    assert at % 16 == 0
    data = o.astype("<u4").tobytes()
    pos = lo
    while pos < hi:
        size = next(s for s in (8, 4, 2, 1) if pos % s == 0 and pos + s <= hi)
        if lo == 0 and hi == 16:
            size = 16
        obuf[at + pos : at + pos + size] = np.frombuffer(data[pos : pos + size], np.uint8)
        writes[at + pos : at + pos + size] += 1
        pos += size


def erode3_blocks(m, in_off, out_off, rw=None):
    """Replay every block of erode3 (kRW = rw, by default the launcher's)
    on mask m (h, w) whose bytes start in_off bytes into their buffer; the
    output starts out_off bytes into its own. Returns the (h, w) output."""
    h, w = m.shape
    rw = rw or rows_per_warp(h, w)
    ibuf = np.zeros(_padded(in_off + h * w), np.uint8)
    ibuf[in_off : in_off + h * w] = m.ravel()
    obuf = np.full(_padded(out_off + h * w), 0xA5, np.uint8)
    writes = np.zeros(obuf.size, np.int64)
    lanes = np.arange(32)
    up, down = np.maximum(lanes - 1, 0), np.minimum(lanes + 1, 31)
    for by in range(-(-h // (WARPS * rw))):
        ys = (by * WARPS + np.arange(WARPS)) * rw - R  # each warp's staged row 0
        for bx in range(-(-(w + 15) // SPAN)):
            x_span = bx * SPAN
            xs = x_span - LEAD
            staged = [stage(ibuf, in_off, y, rw + 2 * R, xs, h, w) for y in ys]
            words = np.stack([b.view("<u4").reshape(rw + 2 * R, CHUNKS, 4) for b, _ in staged])
            shifts = np.stack([sh for _, sh in staged])
            xl = xs + 16 * lanes
            lo_c, hi_c = np.maximum(0, -xl), np.minimum(16, w - xl)
            keep = np.array([sum(1 << j for j in range(a, b)) for a, b in zip(lo_c, hi_c)],
                            np.uint32)
            win = np.zeros((2 * R + 1, WARPS, 32), np.uint32)
            for t in range(rw + 2 * R):
                p = pack16(words[:, t])  # (WARPS, 32)
                q = shfl(p, down)
                v = ((p | (q << np.uint32(16))) >> shifts[:, t, None].astype(np.uint32)) & keep
                win = np.concatenate([win[1:], v[None]])
                if t < 2 * R:
                    continue
                yo = ys + t - R  # the warps' output rows
                c = np.bitwise_and.reduce(win, axis=0)
                lo = (shfl(c, up) & np.uint32(0xFFFF)) | ((c & np.uint32(0xFFFF)) << np.uint32(16))
                hi = shfl(c, down)
                m1l = lo & funnel_r(lo, hi, 1) & (lo << np.uint32(1))
                m1h = hi & (hi >> np.uint32(1)) & funnel_l(lo, hi, 1)
                m3l = m1l & funnel_r(m1l, m1h, 2) & (m1l << np.uint32(2))
                m3h = m1h & (m1h >> np.uint32(2)) & funnel_l(m1l, m1h, 2)
                so = (out_off + yo * w + x_span) % 16  # (WARPS,)
                bits = funnel_r(m3l, m3h, (24 - so)[:, None])
                o = np.stack([unpack4(bits, 4 * i) for i in range(4)], axis=-1)
                for wi in range(WARPS):
                    if yo[wi] >= h:
                        continue
                    for ln in range(1, 30):
                        c0 = x_span - so[wi] + 16 * (ln - 1)
                        lo_b, hi_b = max(0, -c0), min(16, w - c0)
                        if lo_b < hi_b:
                            store(obuf, writes, out_off + yo[wi] * w + c0, o[wi, ln], lo_b, hi_b)
    inside_bytes = np.zeros(obuf.size, bool)
    inside_bytes[out_off : out_off + h * w] = True
    assert (writes[inside_bytes] == 1).all(), "an output byte not written exactly once"
    assert (writes[~inside_bytes] == 0).all(), "a byte outside the output written"
    return obuf[out_off : out_off + h * w].reshape(h, w)


def _mask(rng, shape, kind):
    """A mask with a few holes (most 7x7 windows whole, so the erosion
    keeps pixels): kind 1 {0,1}, 255 {0,255}, 0 any nonzero byte inside."""
    holes = rng.random(shape) < 0.015
    if kind == 0:
        m = rng.integers(1, 256, shape).astype(np.uint8)
    else:
        m = np.full(shape, kind, np.uint8)
    m[holes] = 0
    return m


def _check(m, in_off, out_off):
    got = erode3_blocks(m, in_off, out_off)
    want = K.erode3_plain(torch.from_numpy(m)).numpy()
    assert np.array_equal(got, want), (m.shape, in_off, out_off)
    return got


WIDTHS = list(range(1, 41)) + [124]


@pytest.mark.parametrize("off", range(16))
def test_erode3_schedule_every_offset(off):
    """Widths 1-40 and 124 at every byte offset mod 16 of the mask (the
    output at another), {0,1} and {0,255} masks; heights that leave a
    partial block of rows."""
    rng = np.random.default_rng(off)
    for w in WIDTHS:
        h = (5, 21, 37)[w % 3]
        for kind in (1, 255):
            _check(_mask(rng, (h, w), kind), off, (5 * off + 3) % 16)


def test_erode3_rows_per_warp():
    """The launcher fills the card: 8 rows a warp at the headline ROI and at
    8K, 2 on the per-axis strips' ROIs."""
    assert RWS == (8, 4, 2)
    assert rows_per_warp(1550, 2398) == rows_per_warp(2800, 3800) == 8
    assert rows_per_warp(124, 2398) == rows_per_warp(2398, 124) == 2
    assert rows_per_warp(1550, 1400) == 4


@pytest.mark.parametrize("rw", [2, 4, 8])
def test_erode3_schedule_rows_per_warp(rw):
    """Each kRW template, with a partial last block of rows."""
    rng = np.random.default_rng(rw)
    for h, w, off in ((75, 57, 3), (40, 124, 14), (9, 500, 6)):
        m = _mask(rng, (h, w), 255)
        want = K.erode3_plain(torch.from_numpy(m)).numpy()
        assert np.array_equal(erode3_blocks(m, off, 16 - off, rw), want)


@pytest.mark.parametrize("w", [463, 464, 465, 929, 2398])
def test_erode3_schedule_span_edges(w):
    """Rows of several blocks' spans: each output chunk of a row belongs to
    one block whatever the row's offset; any nonzero byte is inside."""
    rng = np.random.default_rng(w)
    for off in (0, 2, 7, 15):
        _check(_mask(rng, (9, w), (0, 1, 255)[off % 3]), off, off)


def test_erode3_schedule_empty_and_full():
    for h, w in ((1, 1), (6, 7), (7, 7), (40, 33)):
        _check(np.zeros((h, w), np.uint8), 3, 0)
        got = _check(np.full((h, w), 255, np.uint8), 0, 9)
        assert got[3 : h - 3, 3 : w - 3].all() and got.sum() == max(h - 6, 0) * max(w - 6, 0)


def test_erode3_schedule_matches_pallas():
    m = _mask(np.random.default_rng(11), (37, 70), 1)
    want = np.asarray(PK.erode3_pallas(jnp.asarray(m), interpret=True))
    assert np.array_equal(erode3_blocks(m, 5, 0), want)
