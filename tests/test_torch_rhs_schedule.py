"""A numpy rehearsal of preprocess_rhs_q's block and thread walk
(csrc/preprocess_rhs_q.cu on csrc/rhs_wide.cuh), on the CPU.

A block stages the windows of the mask and of every channel's destination
and patch: where a row's pixels are contiguous, as 16-byte chunks from the
aligned chunk below the row's first pixel (the ROI's origin at any byte
offset, so the row starts at a shift), else byte by byte. A thread reads
its two words of a row at the row's shift, computes the integer RHS of a
2 x 4 dense patch (a NORMAL patch inside the interior two columns at a time in
16-bit lanes of 32-bit words, any other one pixel at a time with every
edge test), and writes two floats to each quarter plane. The kernel does
not run here, so this file replays every block on the inputs' bytes (each
view an address into a flat buffer whose length rounds up to 16 bytes, as
device allocations do), checks that every copy stays in its buffer and
holds a pixel of its row, counts the writes to every output element
(exactly one each) and holds the planes equal to the plain twin
(``K.preprocess_rhs_q_plain``) bit for bit.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from seamlesscloneoptimization_tpu_torch.ops import kernels as K

torch.set_num_threads(1)

HEADER = Path(K.__file__).resolve().parent.parent / "csrc" / "rhs_wide.cuh"


def _consts():
    text = HEADER.read_text()
    tx, ty = (int(v) for v in re.search(r"constexpr int kTX = (\d+), kTY = (\d+);",
                                        text).groups())
    passes, chunks, max_c = (int(re.search(rf"constexpr int {k} = (\d+);", text).group(1))
                             for k in ("kPasses", "kChunks", "kMaxC"))
    return tx, ty, passes, chunks, max_c


TX, TY, PASSES, CHUNKS, MAX_C = _consts()
PASS_R, TILE_C = 2 * TY, 4 * TX
TILE_R = PASSES * PASS_R
WIN_R = TILE_R + 2


class View:
    """A u8 (C, H, W) view: a flat buffer, the byte address of element
    (0, 0, 0) and element strides, as the kernel receives it."""

    def __init__(self, buf, off, strides):
        self.buf, self.off, self.strides = buf, off, strides

    def tensor(self, shape):
        return torch.as_strided(torch.from_numpy(self.buf), shape, self.strides, self.off)


def _padded(n):
    return np.zeros(-(-n // 16) * 16, np.uint8)


def stage_row(buf, base, sh, sw, y, j0, w, h, chunks=CHUNKS):
    """stage_rows for one row: (its chunks * 16 staged bytes, its shift)."""
    out = np.zeros(16 * chunks, np.uint8)
    if y >= h:
        return out, (base + y * sh + j0) % 16 if sw == 1 else 0
    if sw == 1:
        p = base + y * sh + j0
        shift = p % 16
        for k in range(chunks):
            if j0 - shift + 16 * k < w:  # the chunk holds a pixel of the row
                at = p - shift + 16 * k
                assert 0 <= at and at + 16 <= buf.size
                out[16 * k : 16 * k + 16] = buf[at : at + 16]
        return out, shift
    x = j0 + np.arange(16 * chunks)
    ok = x < w
    out[ok] = buf[base + y * sh + x[ok] * sw]
    return out, 0


def thread_words(rows, ty, tx, wr0, a):
    """row_words: each thread's two words (pixels x0 .. x0 + 7) of window row
    wr0 + 2 ty + a, as uint64 arrays of (TY, TX)."""
    b = np.zeros((2,) + ty.shape, np.uint64)
    for t_y in range(TY):
        row, shift = rows[wr0 + 2 * t_y + a]
        for t_x in range(TX):
            v = row[shift + 4 * t_x : shift + 4 * t_x + 8].astype(np.uint64)
            b[0, t_y, t_x] = sum(int(v[m]) << (8 * m) for m in range(4))
            b[1, t_y, t_x] = sum(int(v[4 + m]) << (8 * m) for m in range(4))
    return b


def byte_at(words, b):
    """Byte b (0 .. 7) of a thread's two words (arrays of (TY, TX))."""
    return ((words[b >> 2] >> np.uint64(8 * (b & 3))) & np.uint64(0xFF)).astype(np.int64)


def rhs_patch(D, P, M, y0, x0, h, w, mode):
    """rhs_patch<mode>, one pixel at a time with every edge test: lap[i, k]
    for every thread, (TY, TX) each."""
    gx, gy = {}, {}
    for a in range(3):
        for b in range(5):
            if a == 0 and b == 0:
                continue
            dx = byte_at(D[a], b + 1) - byte_at(D[a], b)
            dy = byte_at(D[a + 1], b) - byte_at(D[a], b)
            px = byte_at(P[a], b + 1) - byte_at(P[a], b)
            py = byte_at(P[a + 1], b) - byte_at(P[a], b)
            xo, yo = x0 + b >= w - 1, y0 + a >= h - 1
            dx, px = np.where(xo, 0, dx), np.where(xo, 0, px)
            dy, py = np.where(yo, 0, dy), np.where(yo, 0, py)
            if mode:
                take = (px * px + py * py < dx * dx + dy * dy if mode == 2
                        else np.abs(px - py) <= np.abs(dx - dy))
                px, py = np.where(take, dx, px), np.where(take, dy, py)
            m = byte_at(M[a], b) != 0
            gx[a, b] = np.where(m, px, dx)
            gy[a, b] = np.where(m, py, dy)
    lap = {}
    for i in range(2):
        for k in range(4):
            a, b = i + 1, k + 1
            v = (gx[a, b] - gx[a, b - 1]) + (gy[a, b] - gy[a - 1, b])
            y, x = y0 + a, x0 + b
            v = np.where(y == 1, v - byte_at(D[a - 1], b), v)
            v = np.where(y == h - 2, v - byte_at(D[a + 1], b), v)
            v = np.where(x == 1, v - byte_at(D[a], b - 1), v)
            v = np.where(x == w - 2, v - byte_at(D[a], b + 1), v)
            lap[i, k] = np.where((y > h - 2) | (x > w - 2), 0, v).astype(np.float32)
    return lap


U32 = np.uint64(0xFFFFFFFF)


def lanes(v, f):
    """Bytes f and f + 2 of a thread's 8 bytes as two 16-bit lanes."""
    both = v[0] | (v[1] << np.uint64(32))
    return (both >> np.uint64(8 * f)) & np.uint64(0x00FF00FF)


def lane_mask(q):
    return ((((q + np.uint64(0x00FF00FF)) >> np.uint64(8)) & np.uint64(0x00010001))
            * np.uint64(0xFFFF)) & U32


def blend(m, p, d):
    return (p & m) | (d & (~m & U32))


def rhs_patch_packed(D, P, mm):
    """rhs_patch_packed in 32-bit words (every sum taken mod 2^32, as the
    card does): lap[i, k] for every thread."""
    kb, kl = np.uint64(0x01000100), np.uint64(0x04000400)

    def diff(x, y):
        return (x + kb - y) & U32

    gy13 = [blend(mm[a][1], diff(lanes(P[a + 1], 1), lanes(P[a], 1)),
                  diff(lanes(D[a + 1], 1), lanes(D[a], 1))) for a in range(3)]
    gy24 = [blend(mm[a][2], diff(lanes(P[a + 1], 2), lanes(P[a], 2)),
                  diff(lanes(D[a + 1], 2), lanes(D[a], 2))) for a in range(3)]
    lap = {}
    for i in range(2):
        a = i + 1
        pq = [lanes(P[a], f) for f in range(4)]
        dq = [lanes(D[a], f) for f in range(4)]
        gx = [blend(mm[a][f], diff(pq[f + 1], pq[f]), diff(dq[f + 1], dq[f])) for f in range(3)]
        l13 = ((((gx[1] + gy13[a] + kl) & U32) - gx[0]) & U32) - gy13[a - 1] & U32
        l24 = ((((gx[2] + gy24[a] + kl) & U32) - gx[1]) & U32) - gy24[a - 1] & U32
        for k, (word, half) in enumerate(((l13, 0), (l24, 0), (l13, 1), (l24, 1))):
            lane = (word >> np.uint64(16 * half)) & np.uint64(0xFFFF)
            lap[i, k] = (lane.astype(np.int64) - 1024).astype(np.float32)
    return lap


def _pass(staged, q, r0, j0, ty, tx, c_lo, nc, h, w, hpo, wpo, mode, out, n_out):
    """Row pass q of one tile (rhs_pass)."""
    wr0 = PASS_R * q
    y0, x0 = r0 + wr0 + 2 * ty, j0 + 4 * tx
    active = (y0 < hpo) & (x0 < wpo)

    def rows(a_idx, n):
        return [thread_words(staged[a_idx], ty, tx, wr0, a) for a in range(n)]

    M = rows(0, 3)
    mm = [[lane_mask(lanes(M[a], f)) for f in range(3)] for a in range(3)]
    packed = (mode == 0) & (y0 >= 1) & (y0 + 2 < h - 2) & (x0 >= 1) \
        & (x0 + 4 < w - 2)
    full = x0 + 4 <= wpo
    for k in range(nc):
        D, P = rows(1 + k, 4), rows(1 + nc + k, 4)
        slow = rhs_patch(D, P, M, y0, x0, h, w, mode)
        fast = rhs_patch_packed(D, P, mm) if mode == 0 else slow
        for p in range(4):
            i, kk = p >> 1, p & 1
            a = np.where(packed, fast[i, kk], slow[i, kk])
            b = np.where(packed, fast[i, kk + 2], slow[i, kk + 2])
            rr, jj = y0 >> 1, x0 >> 1
            for val, dj, ok in ((a, 0, active), (b, 1, active & full)):
                out[c_lo + k, p, rr[ok], jj[ok] + dj] = val[ok]
                np.add.at(n_out, (c_lo + k, p, rr[ok], jj[ok] + dj), 1)


def rhs_q_blocks(dest: View, patch: View, me: View, c, h, w, out_hw, mode):
    """Every block of preprocess_rhs_q_kernel<mode>, replayed. Returns the
    planes (c, 4, hpo/2, wpo/2) and the writes to each element."""
    hpo, wpo = out_hw
    hq, wq = hpo // 2, wpo // 2
    out = np.full((c, 4, hq, wq), np.nan, np.float32)
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
                staged = [[stage_row(buf, base, sh, sw, r0 + ry, j0, w, h)
                           for ry in range(WIN_R)] for buf, base, sh, sw in arrays]
                for q in range(PASSES):
                    _pass(staged, q, r0, j0, ty, tx, c_lo, nc, h, w, hpo, wpo, mode, out,
                          n_out)
    return out, n_out


def _image_view(rng, c, h, w, left, interleaved, wide=3):
    """A (c, h, w) u8 view at column `left` of a (c, h + 2, w + left + wide)
    image, planar or interleaved, in a buffer whose own origin is aligned."""
    hh, ww = h + 2, w + left + wide
    img = rng.integers(0, 256, (hh * ww * c,), np.uint8)
    buf = _padded(img.size)
    buf[: img.size] = img
    if interleaved:
        return View(buf, (1 * ww + left) * c, (1, ww * c, c))
    return View(buf, 1 * ww + left, (hh * ww, ww, 1))


def _contiguous_view(arr, off):
    buf = _padded(arr.size + off)
    buf[off : off + arr.size] = arr.reshape(-1)
    strides = tuple(s // arr.itemsize for s in arr.strides)
    return View(buf, off, strides)


def _case(h, w, left, out_pad, interleaved, gray, mode, seed, c=3):
    rng = np.random.default_rng(seed)
    dest = _image_view(rng, c, h, w, left, interleaved)
    if gray:
        g = rng.integers(0, 256, (h, w), np.uint8)
        buf = _padded(g.size + 1)
        buf[1 : 1 + g.size] = g.reshape(-1)
        patch = View(buf, 1, (0, w, 1))
    else:
        patch = _contiguous_view(rng.integers(0, 256, (c, h, w), np.uint8), left % 4)
    me = _contiguous_view((rng.random((h, w)) < 0.7).astype(np.uint8), (left + 1) % 4)
    hpo = (h - 2) + (h - 2) % 2 + out_pad[0]
    wpo = (w - 2) + (w - 2) % 2 + out_pad[1]
    got, n_out = rhs_q_blocks(dest, patch, me, c, h, w, (hpo, wpo), mode)
    flags, rule = {0: (1, "opencv"), 1: (2, "opencv"), 2: (2, "norm")}[mode]
    want = K.preprocess_rhs_q_plain(dest.tensor((c, h, w)), patch.tensor((c, h, w)),
                                    me.tensor((h, w)), (hpo, wpo), flags, rule)
    return got, n_out, want.numpy()


@pytest.mark.parametrize("left", range(16))
def test_rhs_q_schedule_every_origin(left):
    """ROI origins at every byte offset mod 16 of a planar destination, a
    width 4k + 1 and one 16k + 3, the interior padded past on both axes."""
    for h, w, pad in ((23, 4 * 37 + 1, (0, 0)), (37, 16 * 9 + 3, (6, 130))):
        got, n_out, want = _case(h, w, left, pad, False, False, 0, 16 * left + w)
        assert (n_out == 1).all() and np.array_equal(got, want)


@pytest.mark.parametrize("mode", [0, 1, 2])
@pytest.mark.parametrize("interleaved,gray", [(False, False), (True, False), (False, True),
                                              (True, True)])
def test_rhs_q_schedule_modes_and_strides(interleaved, gray, mode):
    """NORMAL, MIXED "opencv" and "norm" on the planar and the interleaved
    destination, with a patch of its own or the stride-0 gray patch."""
    for h, w, left, pad in ((3, 3, 5, (0, 0)), (41, 131, 7, (10, 0)), (18, 262, 13, (0, 4))):
        got, n_out, want = _case(h, w, left, pad, interleaved, gray, mode, h * w + mode)
        assert (n_out == 1).all() and np.array_equal(got, want)


@pytest.mark.parametrize("c", [1, 4])
def test_rhs_q_schedule_channel_groups(c):
    """One channel, and more channels than a block takes (two groups)."""
    got, n_out, want = _case(29, 150, 9, (2, 8), False, False, 0, 7 * c, c)
    assert (n_out == 1).all() and np.array_equal(got, want)


# -- preprocess_rhs_t (csrc/preprocess_rhs_t.cu): the transposed walk --------
#
# One block of kBX x kBY threads for every channel (or, on a small grid, one
# channel) of a kTR-row x 4 kBX-column dense tile: the window rows of the
# mask are staged once and each channel's destination and patch into one
# of two channel buffers (one array a window, as stage_rows stages them;
# channel k + 2's rows go into the buffer channel k leaves); in each of two
# row passes a thread computes the RHS of a 2 x 4 patch and writes it as
# two floats of one column into a shared [x][y] tile whose rows are
# XOR-swizzled by pairs; the store reads the tile a float4 granule at a
# time, undoes the swizzle, and writes each output line (fixed x) of the
# tile as one run of kTR floats. Tiles wholly in the padding write zeros.

T_SOURCE = HEADER.parent / "preprocess_rhs_t.cu"


def _t_consts():
    text = T_SOURCE.read_text()
    bx, by = (int(v) for v in re.search(r"constexpr int kBX = (\d+), kBY = (\d+);",
                                        text).groups())
    tr = int(re.search(r"constexpr int kTR = (\d+);", text).group(1))
    chunks = int(re.search(r"using Win = Rows<kTR \+ 2, (\d+)>;", text).group(1))
    return bx, by, tr, chunks


T_BX, T_BY, T_TR, T_CHUNKS = _t_consts()
T_TC, T_PASS, T_WIN = 4 * T_BX, 2 * T_BY, T_TR + 2


def t_words(rows, wr0, a):
    """row_words on a one-array window: each thread's two words of window
    row wr0 + 2 ty + a, as uint64 arrays of (T_BY, T_BX)."""
    out = np.zeros((2, T_BY, T_BX), np.uint64)
    sh = (8 * np.arange(4)).astype(np.uint64)
    for t_y in range(T_BY):
        row, shift = rows[wr0 + 2 * t_y + a]
        # the kernel reads words shift / 4 + tx .. + 2 of the staged row
        assert 4 * ((shift >> 2) + T_BX - 1 + 2) + 3 < 16 * T_CHUNKS
        v = row[shift + 4 * np.arange(T_BX)[:, None] + np.arange(8)[None, :]].astype(np.uint64)
        out[0, t_y] = (v[:, :4] << sh).sum(1)
        out[1, t_y] = (v[:, 4:] << sh).sum(1)
    return out


def t_swizzle(jj):
    return ((jj >> 2) & 15) << 1


def t_store(tile, out, n_out, k, r0, j0, wpo, hpo):
    """store_tile: granule i = line i // 8, rows 4 (i % 8) .. + 3, from the
    swizzled tile (zeros when tile is None)."""
    jj = np.arange(T_TC)[:, None]
    g = np.arange(T_TR // 4)[None, :]
    if tile is None:
        v = np.zeros((T_TC, T_TR // 4, 4), np.float32)
    else:
        gp = g ^ ((jj >> 3) & 7)
        v = tile[jj[..., None], 4 * gp[..., None] + np.arange(4)]
        swap = ((jj >> 2) & 1).astype(bool)[:, 0]
        v[swap] = v[swap][..., [2, 3, 0, 1]]
    j = j0 + jj + 0 * g
    r = r0 + 4 * g + 0 * jj
    ok = (j < wpo) & (r < hpo)
    for e in range(4):
        out[k, j[ok], r[ok] + e] = v[..., e][ok]
        np.add.at(n_out, (k, j[ok], r[ok] + e), 1)


def t_compute(mrows, drows, prows, r0, j0, h, w, mode, ty, tx):
    """A channel's two row passes (rhs_pass_t) into the swizzled shared tile."""
    tile = np.full((T_TC, T_TR), np.nan, np.float32)
    n_tile = np.zeros(tile.shape, np.int32)
    for q in range(T_TR // T_PASS):
        wr0 = T_PASS * q
        wr = wr0 + 2 * ty
        y0, x0 = r0 + wr, j0 + 4 * tx
        M = [t_words(mrows, wr0, a) for a in range(3)]
        D = [t_words(drows, wr0, a) for a in range(4)]
        P = [t_words(prows, wr0, a) for a in range(4)]
        mm = [[lane_mask(lanes(M[a], f)) for f in range(3)] for a in range(3)]
        packed = (mode == 0) & (y0 >= 1) & (y0 + 2 < h - 2) & (x0 >= 1) & (x0 + 4 < w - 2)
        slow = rhs_patch(D, P, M, y0, x0, h, w, mode)
        fast = rhs_patch_packed(D, P, mm) if mode == 0 else slow
        for kk in range(4):
            jj = 4 * tx + kk
            at = wr ^ t_swizzle(jj)
            assert (at % 2 == 0).all()  # an aligned float2
            for i in range(2):
                tile[jj, at + i] = np.where(packed, fast[i, kk], slow[i, kk])
                np.add.at(n_tile, (jj, at + i), 1)
    assert (n_tile == 1).all()  # every element of the shared tile, once
    return tile


def rhs_t_blocks(dest: View, patch: View, me: View, c, h, w, mode, sms):
    """Every block of preprocess_rhs_t_kernel<mode> as the launcher grids it
    on a card of ``sms`` SMs (every channel in one block, or one channel a
    block when the tiles number fewer than 2 sms), replayed with its two
    channel buffers (a block's k-th channel's windows in buffer k & 1, the
    (k + 2)-th's copied there once the k-th is computed). Returns the slab
    (c, ru128(w - 2), ru128(h - 2)) and the writes to each element."""
    wpo, hpo = K.ru128(w - 2), K.ru128(h - 2)
    out = np.full((c, wpo, hpo), np.nan, np.float32)
    n_out = np.zeros(out.shape, np.int32)
    ty, tx = np.meshgrid(np.arange(T_BY), np.arange(T_BX), indexing="ij")
    gy, gx = -(-hpo // T_TR), -(-wpo // T_TC)
    cpb = c if gy * gx >= 2 * sms else 1
    for bz, by, bx in np.ndindex(-(-c // cpb), gy, gx):
        r0, j0, c0 = by * T_TR, bx * T_TC, bz * cpb
        nc = min(cpb, c - c0)
        if r0 >= h - 2 or j0 >= w - 2:
            for k in range(nc):
                t_store(None, out, n_out, c0 + k, r0, j0, wpo, hpo)
            continue
        mrows = [stage_row(me.buf, me.off, w, 1, r0 + ry, j0, w, h, T_CHUNKS)
                 for ry in range(T_WIN)]
        wins = [None, None]

        def stage(k, r0=r0, j0=j0, c0=c0, wins=wins):
            wins[k & 1] = [[stage_row(v.buf, v.off + (c0 + k) * v.strides[0], *v.strides[1:],
                                      r0 + ry, j0, w, h, T_CHUNKS) for ry in range(T_WIN)]
                           for v in (dest, patch)]

        for k in range(min(nc, 2)):
            stage(k)
        for k in range(nc):
            tile = t_compute(mrows, *wins[k & 1], r0, j0, h, w, mode, ty, tx)
            if k + 2 < nc:
                stage(k + 2)
            t_store(tile, out, n_out, c0 + k, r0, j0, wpo, hpo)
    return out, n_out


def _t_case(h, w, left, interleaved, gray, mode, seed, c=3, sms=1):
    rng = np.random.default_rng(seed)
    dest = _image_view(rng, c, h, w, left, interleaved)
    if gray:
        g = rng.integers(0, 256, (h, w), np.uint8)
        buf = _padded(g.size + 3)
        buf[3 : 3 + g.size] = g.reshape(-1)
        patch = View(buf, 3, (0, w, 1))
    else:
        patch = _contiguous_view(rng.integers(0, 256, (c, h, w), np.uint8), (left + 2) % 16)
    me = _contiguous_view((rng.random((h, w)) < 0.7).astype(np.uint8), (left + 5) % 16)
    got, n_out = rhs_t_blocks(dest, patch, me, c, h, w, mode, sms)
    flags, rule = {0: (1, "opencv"), 1: (2, "opencv"), 2: (2, "norm")}[mode]
    want = K.preprocess_rhs_t_plain(dest.tensor((c, h, w)), patch.tensor((c, h, w)),
                                    me.tensor((h, w)), flags, rule)
    return got, n_out, want.numpy()


@pytest.mark.parametrize("left", range(16))
def test_rhs_t_schedule_every_origin(left):
    """ROI origins at every byte offset mod 16 of a planar destination, a
    width 4k + 1 and one 16k + 3."""
    for h, w in ((23, 4 * 37 + 1), (37, 16 * 9 + 3)):
        got, n_out, want = _t_case(h, w, left, False, False, 0, 16 * left + w + 1)
        assert (n_out == 1).all() and np.array_equal(got, want)


@pytest.mark.parametrize("hw", [(130, 130), (131, 131), (35, 258)])
def test_rhs_t_schedule_slab_edges(hw):
    """W - 2 and H - 2 a multiple of 128 and one past it (a slab of one
    tile column and row, and one whose last tiles hold one interior line),
    and a tile row that holds one interior row."""
    h, w = hw
    got, n_out, want = _t_case(h, w, 7, False, False, 0, h * w)
    assert (n_out == 1).all() and np.array_equal(got, want)


@pytest.mark.parametrize("mode", [0, 1, 2])
@pytest.mark.parametrize("interleaved,gray", [(False, False), (True, False), (False, True),
                                              (True, True)])
def test_rhs_t_schedule_modes_and_strides(interleaved, gray, mode):
    """NORMAL, MIXED "opencv" and "norm" on the planar and the interleaved
    destination, with a patch of its own or the stride-0 gray patch."""
    for h, w, left in ((3, 3, 5), (41, 131, 9), (18, 262, 14)):
        got, n_out, want = _t_case(h, w, left, interleaved, gray, mode, h * w + mode + 1)
        assert (n_out == 1).all() and np.array_equal(got, want)


@pytest.mark.parametrize("c", [1, 2, 4])
def test_rhs_t_schedule_channels(c):
    """One, two and four channels: the channel buffers alternate past two."""
    got, n_out, want = _t_case(70, 150, 9, False, False, 0, 7 * c + 1, c)
    assert (n_out == 1).all() and np.array_equal(got, want)


@pytest.mark.parametrize("mode", [0, 2])
def test_rhs_t_schedule_channel_a_block(mode):
    """A grid of fewer tiles than two an SM (on a card of 132 SMs, a per-axis
    strip): one channel a block, the mask copied by each."""
    for h, w, left in ((36, 300, 4), (300, 40, 11)):
        got, n_out, want = _t_case(h, w, left, False, False, mode, h + w + mode, sms=132)
        assert (n_out == 1).all() and np.array_equal(got, want)
