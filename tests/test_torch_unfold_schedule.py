"""A numpy rehearsal of the pair chain's two unfold kernels
(csrc/unfold_transpose.cu, csrc/unfold_clamp_paste.cu), on the CPU.

unfold_transpose's whole-tile kernel: a block of kThreads threads owns
source lanes [k0, k0 + kT) of kT window rows; thread t loads the float4
units (t / kQ + kPass i, t % kQ) of e and of o once (lanes from he on read
as 0), stores s = e + o and d = e - o into two shared tiles at column unit
q ^ ((row >> 2) & 7), and after the barrier reads tile rows 4 (t % 16) ..
+ 3 at unit t / 16, transposes the 4 x 4 blocks in registers and stores
the s rows x = k (k < he) and the d rows x = n - 1 - k (k < n / 2) as
float4 along r; blocks past the lane tiles zero the rows [n, out_pad).
Windows that are not whole tiles take the ragged kernel (a 32 x 32 tile,
one output element a thread). unfold_clamp_paste: a warp owns kSpan source
lanes of one row, a thread kParts 8-lane chunks 256 lanes apart, packed
into a forward chunk (x = 8 n ..) and a byte-reversed mirrored chunk (x =
w2 - 8 - 8 n ..); a planar row writes aligned 8-byte words joined across
lanes (the forward run with the lower neighbour lane, the mirrored run
with the upper one), clipped to [0, he) and [he, w2) in aligned pieces; an
interleaved row takes byte stores, a pixel a lane. On a strip (a grid of
fewer than two blocks an SM) unfold_transpose_strip walks kTS-row tiles,
its first 128 threads storing the s tile and the others the d tile, and
unfold_clamp_paste runs with kStripParts chunks a thread; both are
replayed the same way.

The kernels do not run here, so this file replays their index maps: every
unit of the shared tiles written once and read once, no two lanes of a
quarter-warp on one bank group, each lane of e and o loaded once on the
whole-tile paths, every output element or byte written exactly once (the
zero rows and the word at x = he included), no byte outside the rectangle
written, every store aligned to its size, and the result bit-equal to
``K.unfold_transpose_plain`` / ``K.unfold_clamp_paste_plain``. The
constants are parsed from the sources; the word helpers shared with
clamp_cast_paste_q (csrc/paste_words.cuh) are replayed by
``test_torch_paste_schedule``.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch
from test_torch_paste_schedule import Dest, join, pack4, store_part

from seamlesscloneoptimization_tpu_torch.ops import kernels as K

torch.set_num_threads(1)

CSRC = Path(K.__file__).resolve().parent.parent / "csrc"


def _consts(source, keys):
    text = (CSRC / source).read_text()
    return tuple(int(re.search(rf"constexpr int {k} = (\d+);", text).group(1)) for k in keys)


T, THREADS, RAGGED, RAGGED_ROWS = _consts("unfold_transpose.cu",
                                          ("kT", "kThreads", "kRagged", "kRaggedRows"))
PARTS, STRIP_PARTS, ROWS = _consts("unfold_clamp_paste.cu", ("kParts", "kStripParts", "kRows"))
(TS,) = _consts("unfold_transpose.cu", ("kTS",))
Q = T // 4
PASS = THREADS // Q
SPAN = 32 * 8 * PARTS
THREAD = np.arange(THREADS)
SPECIAL = np.array([254.9999, -0.0, 255.0, 255.5, 256.0, -0.5, -3.7, 0.0, 0.9999, 1e9, -1e9,
                    127.5], np.float32)


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


def whole_tile(rc, ep):
    """unfold_transpose_launch's choice (every pointer 16-byte aligned, as
    torch allocates)."""
    return rc % T == 0 and ep % 4 == 0


def test_unfold_transpose_choice_is_the_sources():
    assert "rc % kT == 0 && ep % 4 == 0 && aligned16(e) && aligned16(o) && aligned16(out)" in (
        CSRC / "unfold_transpose.cu").read_text()


@pytest.mark.parametrize("phase", [writes, reads])
def test_unfold_tile_units_once(phase):
    rows, q, stored = phase()
    hits = np.zeros((T, Q), np.int64)
    np.add.at(hits, (rows, stored), 1)
    assert (hits == 1).all()
    wr, wq, ws = writes()
    where = np.full((T, Q), -1)
    where[wr, wq] = ws
    assert (where[rows, q] == stored).all()


@pytest.mark.parametrize("phase", [writes, reads])
def test_unfold_tile_no_bank_conflicts(phase):
    """A 16-byte shared access is served eight lanes at a time; each of
    the eight must fall in its own group of four banks."""
    rows, _, stored = phase()
    group = (rows * T + 4 * stored) // 4 % 8
    for instr in group:
        for quarter in instr.reshape(-1, 8):
            assert len(set(quarter.tolist())) == 8


def _eo(rng, c, m, n, ep, garbage=np.nan):
    """Half-GEMM outputs: data on lanes [0, he), clamp edges among them
    (o = 0 there, so s = d = the edge value), ``garbage`` on the padding
    lanes, which no result may read."""
    he = n - n // 2
    e = np.full((c, m, ep), garbage, np.float32)
    o = np.full((c, m, ep), garbage, np.float32)
    e[..., :he] = rng.normal(size=(c, m, he)) * 160 + 90
    o[..., :he] = rng.normal(size=(c, m, he)) * 60
    pick = rng.random((c, m, he)) < 0.15
    e[..., :he][pick] = rng.choice(SPECIAL, int(pick.sum()))
    o[..., :he][pick] = 0.0
    return e, o


def _transpose_blocks(e, o, n, out_pad, rs, rc):
    """Every block of unfold_transpose_kernel: (out, stores per element,
    loads per element of e and of o)."""
    c, m, ep = e.shape
    he, ho = n - n // 2, n // 2
    lane_tiles, zero_tiles = -(-he // T), -(-(out_pad - n) // T)
    out = np.full((c, out_pad, rc), np.nan, np.float32)
    hits = np.zeros(out.shape, np.int64)
    loads = np.zeros((2, c, m, ep), np.int64)
    wr, wq, ws = writes()
    rr, _, rsw = reads()
    r4, p4 = THREAD % 16, THREAD // 16
    four = np.arange(4)
    for ci in range(c):
        for by in range(rc // T):
            r0 = by * T
            cols = r0 + 4 * r4[:, None] + four  # the store phase's columns
            for bx in range(lane_tiles + zero_tiles):
                if bx >= lane_tiles:  # the zero band, store-only
                    x = n + T * (bx - lane_tiles) + wr
                    zc = r0 + 4 * wq[..., None] + four
                    live = np.broadcast_to((x < out_pad)[..., None], zc.shape)
                    pos = (ci, np.broadcast_to(x[..., None], zc.shape)[live], zc[live])
                    out[pos] = 0.0
                    np.add.at(hits, pos, 1)
                    continue
                k0 = bx * T
                k = k0 + 4 * wq  # (instruction, thread)
                live = k < he
                assert (k[live] + 4 <= ep).all()  # one float4 inside the row
                rows = rs + r0 + wr
                a = np.zeros(k.shape + (4,), np.float32)
                b = np.zeros(k.shape + (4,), np.float32)
                lanes = k[live][:, None] + four
                a[live] = e[ci, rows[live][:, None], lanes]
                b[live] = o[ci, rows[live][:, None], lanes]
                for which in (0, 1):
                    np.add.at(loads[which, ci], (rows[live][:, None], lanes), 1)
                tiles = []
                for v in (a + b, a - b):
                    tile = np.full((T, Q, 4), np.nan, np.float32)
                    tile[wr, ws] = v
                    tiles.append(tile[rr, rsw])  # (4 j, thread, 4 i)
                for i in range(4):
                    kk = k0 + 4 * p4 + i
                    for tile, x, keep in ((tiles[0], kk, kk < he), (tiles[1], n - 1 - kk, kk < ho)):
                        pos = (ci, np.broadcast_to(x[:, None], cols.shape)[keep], cols[keep])
                        out[pos] = tile[:, :, i].T[keep]
                        np.add.at(hits, pos, 1)
    return out, hits, loads


def _transpose_ragged(e, o, n, out_pad, rs, rc):
    """Every block of unfold_transpose_ragged: unfold_at per element."""
    c = e.shape[0]
    he = n - n // 2
    out = np.full((c, out_pad, rc), np.nan, np.float32)
    hits = np.zeros(out.shape, np.int64)
    for ci in range(c):
        for by in range(-(-rc // RAGGED)):
            for bx in range(-(-out_pad // RAGGED)):
                x = bx * RAGGED + np.arange(RAGGED)
                r = by * RAGGED + np.arange(RAGGED)
                x, r = x[x < out_pad], r[r < rc]
                er, orow = e[ci, rs + r], o[ci, rs + r]
                kx = np.where(x < he, x, n - 1 - x).clip(0)
                v = np.where(x < he, er[:, kx] + orow[:, kx], er[:, kx] - orow[:, kx])
                v = np.where(x < n, v, np.float32(0))
                out[ci, x[:, None], r[None]] = v.T
                np.add.at(hits, (ci, x[:, None], r[None]), 1)
    return out, hits


@pytest.mark.parametrize("n", [1, 2, 3, 4, 128, 129, 130, 131, 301])
def test_unfold_transpose_blocks_match_plain(n):
    """n even and odd, n % 4 = 0..3; the chain's padded ep and the
    tightest whole-float4 one, an ep that is no multiple of 4 (the ragged
    kernel); windows whole and ragged, at row offsets that are no multiple
    of kT; out_pad = n (no zero rows), the chain's 128-roundup and several
    zero tiles."""
    he = n - n // 2
    m = 3 * T + 9
    rng = np.random.default_rng(n)
    for ep in sorted({K.ru128(he), -(-he // 4) * 4, he + 1 + (he % 4 == 3)}):
        e, o = _eo(rng, 2, m, n, ep)
        te, to = torch.from_numpy(e), torch.from_numpy(o)
        for out_pad in (n, K.ru128(n), n + 2 * T + 5):
            for rs, rc in ((0, T), (T, 2 * T), (9, 3 * T), (37, 101), (0, m)):
                want = K.unfold_transpose_plain(te, to, n, out_pad, rs, rc).numpy()
                if whole_tile(rc, ep):
                    got, hits, loads = _transpose_blocks(e, o, n, out_pad, rs, rc)
                    win = loads[:, :, rs : rs + rc]
                    assert (win[..., :he] == 1).all(), "a data lane loaded twice or never"
                    assert (win[..., -(-he // 4) * 4 :] == 0).all()
                    assert loads.sum() == win.sum(), "a row outside the window loaded"
                else:
                    got, hits = _transpose_ragged(e, o, n, out_pad, rs, rc)
                assert (hits == 1).all(), "an output element not written exactly once"
                assert np.array_equal(got, want), (ep, out_pad, rs, rc)


def _byte(word, b):
    return (word[0] if b < 4 else word[1]) >> (8 * (b & 3)) & 0xFF


def _lanes4(row_e, row_o, k, he, vec, loads):
    """fold.cuh's unfold_lanes4: (s, d) of lanes k .. k + 3, 0 from he on."""
    if vec:
        if k >= he:
            a = b = np.zeros(4, np.float32)
        else:
            assert k % 4 == 0 and k + 4 <= row_e.size  # one aligned float4 in the row
            a, b = row_e[k : k + 4], row_o[k : k + 4]
            loads[k : k + 4] += 1
    else:
        lanes = k + np.arange(4)
        lanes = lanes[lanes < he]
        a, b = np.zeros(4, np.float32), np.zeros(4, np.float32)
        a[: lanes.size], b[: lanes.size] = row_e[lanes], row_o[lanes]
        loads[lanes] += 1
    return a + b, a - b


def _store_clip(dst, row, at, v, lo, hi):
    lo, hi = max(lo, at), min(hi, at + 8)
    if lo >= hi:
        return
    if lo == at and hi == at + 8:
        dst.store(row + at, 8, v[0] | v[1] << 32)
    else:
        store_part(dst, row + at, v, lo - at, hi - at)


def _paste_blocks(e, o, dst, top1, left1, h2, w2, vec, parts=PARTS):
    """Every warp of unfold_clamp_paste_kernel<vec, parts>; returns the
    loads per element of e (o's are the same)."""
    PARTS, SPAN = parts, 32 * 8 * parts  # noqa: N806
    c, hu, ep = e.shape
    sc, sh, sw = dst.strides
    he, ho = w2 - w2 // 2, w2 // 2
    loads = np.zeros((c, hu, ep), np.int64)
    for cz in range(c):
        for r in range(-(-h2 // ROWS) * ROWS):
            if r >= h2:
                continue  # the warp returns
            for by in range(-(-he // SPAN)):
                span0 = SPAN * by
                fw = [[None] * 32 for _ in range(PARTS)]
                mw = [[None] * 32 for _ in range(PARTS)]
                for p in range(PARTS):
                    for lane in range(32):
                        k = span0 + 8 * (32 * p + lane)
                        s0, d0 = _lanes4(e[cz, r], o[cz, r], k, he, vec, loads[cz, r])
                        s1, d1 = _lanes4(e[cz, r], o[cz, r], k + 4, he, vec, loads[cz, r])
                        fw[p][lane] = (pack4(*s0), pack4(*s1))
                        mw[p][lane] = (pack4(*d1[::-1]), pack4(*d0[::-1]))
                if sw != 1:  # a pixel a lane
                    row = dst.off + cz * sc + (top1 + r) * sh + left1 * sw
                    for p in range(PARTS):
                        for t in range(8):
                            for lane in range(32):
                                src, b = 4 * t + (lane >> 3), lane & 7
                                k = span0 + 256 * p + 32 * t + lane
                                if k < he:
                                    dst.store(row + k * sw, 1, _byte(fw[p][src], b))
                                if k < ho:
                                    dst.store(row + (w2 - 1 - k) * sw, 1, _byte(mw[p][src], 7 - b))
                    continue
                row = dst.off + cz * sc + (top1 + r) * sh + left1
                ef = row % 8
                em = (ef + w2) % 8
                for p in range(PARTS):
                    for lane in range(32):
                        j = span0 + 8 * (32 * p + lane)
                        prev = fw[p - 1][31] if lane == 0 and p > 0 else fw[p][(lane + 31) % 32]
                        nxt = (mw[p + 1][0] if lane == 31 and p < PARTS - 1
                               else mw[p][(lane + 1) % 32])
                        first = lane == 0 and p == 0
                        last = lane == 31 and p == PARTS - 1
                        _store_clip(dst, row, j - ef, join(*prev, *fw[p][lane], ef),
                                    j if first else 0, he)
                        y = w2 - 8 - j
                        _store_clip(dst, row, y - em, join(*nxt, *mw[p][lane], em),
                                    max(he, y) if last else he, w2)
                if ef:  # lane 31: the last forward chunk's tail
                    j1 = span0 + SPAN
                    _store_clip(dst, row, j1 - ef, join(*fw[PARTS - 1][31], 0, 0, ef), 0,
                                min(he, j1))
                if em:  # lane 0: the first mirrored chunk's tail
                    y1 = w2 - span0
                    _store_clip(dst, row, y1 - em, join(*mw[0][0], 0, 0, em), he, y1)
    return loads


def _paste_case(h2, w2, top1, left1, base, interleaved, seed, c=3, vec=True, margin=(1, 5),
                parts=PARTS):
    rng = np.random.default_rng(seed)
    he = w2 - w2 // 2
    ep = K.ru128(he) if vec else he + 1 + (he % 4 == 3)  # scalar: ep % 4 != 0
    e, o = _eo(rng, c, h2 + 3, w2, ep)
    hh, ww = top1 + h2 + margin[0], left1 + w2 + margin[1]
    buf = rng.integers(0, 256, -(-(base + c * hh * ww) // 16) * 16).astype(np.uint8)
    strides = (1, ww * c, c) if interleaved else (hh * ww, ww, 1)
    dst = Dest(buf.copy(), base, strides)
    loads = _paste_blocks(e, o, dst, top1, left1, h2, w2, vec, parts)
    assert (loads[:, :h2, :he] == 1).all(), "a data lane loaded twice or never"
    assert loads[:, :h2, -(-he // 4) * 4 :].sum() == 0 and loads[:, h2:].sum() == 0
    want = Dest(buf.copy(), base, strides)
    K.unfold_clamp_paste_plain(torch.from_numpy(e), torch.from_numpy(o),
                               want.tensor((c, hh, ww)), top1, left1, h2, w2)
    idx = (base + np.arange(c)[:, None, None] * strides[0]
           + (top1 + np.arange(h2))[None, :, None] * strides[1]
           + (left1 + np.arange(w2))[None, None, :] * strides[2])
    inside = np.zeros(buf.size, bool)
    inside[idx.ravel()] = True
    assert (dst.writes[inside] == 1).all(), "a byte of the rectangle not written exactly once"
    assert (dst.writes[~inside] == 0).all(), "a byte outside the rectangle written"
    assert np.array_equal(dst.buf, want.buf)


@pytest.mark.parametrize("left1", range(8))
def test_unfold_paste_every_offset(left1):
    """A planar destination at every left1 mod 8 (the forward run's word
    offset), w2 % 4 = 0..3 (so the mirrored run's offset and the word at he
    take every phase), a base that is not 16-byte aligned, a row past one
    warp's span."""
    for h2, w2, top1, base in ((3, 36, 2, 3), (2, 37, 1, 0), (3, 38, 3, 13), (2, 39, 0, 7),
                               (2, 2 * SPAN + 19, 1, 5)):
        _paste_case(h2, w2, top1, left1, base, False, 8 * w2 + left1)


@pytest.mark.parametrize("interleaved", [False, True])
@pytest.mark.parametrize("vec", [True, False])
def test_unfold_paste_layouts(interleaved, vec):
    """Planar and interleaved, the float4 and the scalar loads; one to three
    columns, a one-row rectangle, rows whose starts fall at every offset
    mod 8 (an odd image width), he = kSpan (one warp's run exactly) and
    one lane past it."""
    for h2, w2, top1, left1, base in ((3, 1, 1, 4, 1), (2, 2, 0, 7, 2), (2, 3, 2, 1, 0),
                                      (1, 250, 4, 9, 5), (9, 77, 0, 5, 7),
                                      (2, 2 * SPAN, 1, 3, 0), (2, 2 * SPAN + 1, 0, 6, 9)):
        _paste_case(h2, w2, top1, left1, base, interleaved, w2 + left1, vec=vec,
                    margin=(2, 11))


@pytest.mark.parametrize("c", [1, 4])
def test_unfold_paste_channels(c):
    """One channel, and more than three."""
    _paste_case(5, 301, 1, 6, 5, False, 31 * c, c=c)


# ---------------------------------------------------------------------------
# the strip forms
# ---------------------------------------------------------------------------


def test_strip_choices_are_the_sources():
    """Each host takes its strip form where the headline grid leaves fewer
    than two blocks an SM."""
    text = (CSRC / "unfold_transpose.cu").read_text()
    assert "if ((long long)(lane_tiles + zero_tiles) * (rc / kT) * c < 2LL * sms) {" in text
    assert "const dim3 grid(lane_tiles + zero_tiles, rc / kTS, c);  // a strip" in text
    text = (CSRC / "unfold_clamp_paste.cu").read_text()
    assert ("const bool strip = (long long)c * ((he + kSpan - 1) / kSpan) * row_blocks "
            "< 2LL * sms;") in text
    assert "const int span = strip ? 32 * 8 * kStripParts : kSpan;" in text


def strip_writes():
    rows = np.stack([THREAD // Q + PASS * i for i in range(TS // PASS)])
    q = np.broadcast_to(THREAD % Q, rows.shape)
    return rows, q, swizzle(rows, q)


def strip_reads():
    """(instruction, thread) -> (tile, row, logical unit, stored unit): the
    first 128 threads read the s tile, the others the d tile."""
    tt = THREAD % 128
    rows = np.stack([4 * (tt % (TS // 4)) + j for j in range(4)])
    q = np.broadcast_to(tt // (TS // 4), rows.shape)
    return np.broadcast_to(THREAD // 128, rows.shape), rows, q, swizzle(rows, q)


def test_strip_tiles_units_once_no_bank_conflicts():
    wr, wq, ws = strip_writes()
    hits = np.zeros((TS, Q), np.int64)
    np.add.at(hits, (wr, ws), 1)
    assert (hits == 1).all()
    half, rr, rq, rs = strip_reads()
    for h in (0, 1):
        mine = half == h
        hits = np.zeros((TS, Q), np.int64)
        np.add.at(hits, (rr[mine], rs[mine]), 1)
        assert (hits == 1).all()
    where = np.full((TS, Q), -1)
    where[wr, wq] = ws
    assert (where[rr, rq] == rs).all()
    for rows, stored in ((wr, ws), (rr, rs)):
        group = (rows * T + 4 * stored) // 4 % 8
        for instr in group:
            for quarter in instr.reshape(-1, 8):
                assert len(set(quarter.tolist())) == 8


def _transpose_strip_blocks(e, o, n, out_pad, rs, rc):
    """Every block of unfold_transpose_strip: (out, stores per element,
    loads per element of e and of o)."""
    c, m, ep = e.shape
    he, ho = n - n // 2, n // 2
    lane_tiles, zero_tiles = -(-he // T), -(-(out_pad - n) // T)
    out = np.full((c, out_pad, rc), np.nan, np.float32)
    hits = np.zeros(out.shape, np.int64)
    loads = np.zeros((2, c, m, ep), np.int64)
    wr, wq, ws = strip_writes()
    half, rr, _, rsw = strip_reads()
    tt = THREAD % 128
    r4, p4 = tt % (TS // 4), tt // (TS // 4)
    four = np.arange(4)
    zq, zr = THREAD % (TS // 4), THREAD // (TS // 4)
    zpass = THREADS // (TS // 4)
    for ci in range(c):
        for by in range(rc // TS):
            r0 = by * TS
            cols = r0 + 4 * r4[:, None] + four
            for bx in range(lane_tiles + zero_tiles):
                if bx >= lane_tiles:  # the zero band, store-only
                    for i in range(T // zpass):
                        x = n + T * (bx - lane_tiles) + zr + zpass * i
                        zc = r0 + 4 * zq[:, None] + four
                        live = x < out_pad
                        pos = (ci, np.broadcast_to(x[:, None], zc.shape)[live], zc[live])
                        out[pos] = 0.0
                        np.add.at(hits, pos, 1)
                    continue
                k0 = bx * T
                k = k0 + 4 * wq
                live = k < he
                assert (k[live] + 4 <= ep).all()
                rows = rs + r0 + wr
                a = np.zeros(k.shape + (4,), np.float32)
                b = np.zeros(k.shape + (4,), np.float32)
                lanes = k[live][:, None] + four
                a[live] = e[ci, rows[live][:, None], lanes]
                b[live] = o[ci, rows[live][:, None], lanes]
                for which in (0, 1):
                    np.add.at(loads[which, ci], (rows[live][:, None], lanes), 1)
                tiles = np.full((2, TS, Q, 4), np.nan, np.float32)
                tiles[0][wr, ws] = a + b
                tiles[1][wr, ws] = a - b
                v = tiles[half, rr, rsw]  # (4 j, thread, 4 i)
                for i in range(4):
                    kk = k0 + 4 * p4 + i
                    for h, x, keep in ((0, kk, kk < he), (1, n - 1 - kk, kk < ho)):
                        keep = keep & (THREAD // 128 == h)
                        pos = (ci, np.broadcast_to(x[:, None], cols.shape)[keep], cols[keep])
                        out[pos] = v[:, :, i].T[keep]
                        np.add.at(hits, pos, 1)
    return out, hits, loads


@pytest.mark.parametrize("n", [1, 2, 3, 4, 129, 131, 301, 2396, 2397])
def test_unfold_transpose_strip_blocks_match_plain(n):
    """The strip form: n even and odd, n % 4 = 0..3 and the strips' 2396 /
    2397; windows of kTS multiples at offsets; out_pad = n, the 128-roundup
    and several zero tiles."""
    he = n - n // 2
    m = 2 * T + 9
    rng = np.random.default_rng(n)
    e, o = _eo(rng, 2 if n < 2000 else 1, m, n, K.ru128(he))
    te, to = torch.from_numpy(e), torch.from_numpy(o)
    for out_pad in (n, K.ru128(n), n + 2 * T + 5):
        for rs, rc in ((0, T), (9, 2 * T), (37, T)):
            want = K.unfold_transpose_plain(te, to, n, out_pad, rs, rc).numpy()
            got, hits, loads = _transpose_strip_blocks(e, o, n, out_pad, rs, rc)
            win = loads[:, :, rs : rs + rc]
            assert (win[..., :he] == 1).all(), "a data lane loaded twice or never"
            assert loads.sum() == win.sum(), "a row outside the window loaded"
            assert (hits == 1).all(), "an output element not written exactly once"
            assert np.array_equal(got, want), (out_pad, rs, rc)


@pytest.mark.parametrize("interleaved", [False, True])
@pytest.mark.parametrize("vec", [True, False])
def test_unfold_paste_strip(interleaved, vec):
    """unfold_clamp_paste with kStripParts chunks a thread: the cases of
    test_unfold_paste_layouts at that span, a strip row (w2 = 2396) and
    every left1 mod 8 on a planar row past one warp's span."""
    span = 32 * 8 * STRIP_PARTS
    cases = [(3, 1, 1, 4, 1), (2, 3, 2, 1, 0), (9, 77, 0, 5, 7), (2, 2 * span, 1, 3, 0),
             (2, 2 * span + 1, 0, 6, 9), (2, 2396, 1, 3, 5)]
    if not interleaved:
        cases += [(2, 2 * span + 19, 1, left1, 5) for left1 in range(8)]
    for h2, w2, top1, left1, base in cases:
        _paste_case(h2, w2, top1, left1, base, interleaved, w2 + left1, vec=vec,
                    margin=(2, 11), parts=STRIP_PARTS)
