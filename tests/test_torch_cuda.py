"""The port's CUDA kernels against their plain PyTorch twins, on the card.

CUDA kernels have no CPU mode, so every test here needs an NVIDIA card
(with nvcc to build the kernels) and skips elsewhere. This file imports
neither JAX nor the JAX package, so it also runs on a machine without JAX:

    python -m pytest tests/test_torch_cuda.py -q --noconftest

Every kernel must be bit-exact against its twin.
"""

import numpy as np
import pytest
import torch

from seamlesscloneoptimization_tpu_torch.core.config import CloneConfig
from seamlesscloneoptimization_tpu_torch.core.engine import SeamlessClone
from seamlesscloneoptimization_tpu_torch.ops import kernels as K
from seamlesscloneoptimization_tpu_torch.solvers import jacobi as TJ
from seamlesscloneoptimization_tpu_torch.solvers import multigrid as TM
from seamlesscloneoptimization_tpu_torch.solvers.dst_gemm import (
    dst_eigenvalues_grouped,
    dst_eigenvalues_padded,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _u8(rng, shape):
    return rng.integers(0, 256, shape).astype(np.uint8)


@pytest.fixture
def nan_outputs(monkeypatch):
    """Float tensors that torch.empty / empty_like allocate start as NaN, so
    an output element a kernel leaves unwritten shows."""
    empty, empty_like = torch.empty, torch.empty_like

    def poison(t):
        return t.fill_(float("nan")) if t.is_floating_point() else t

    monkeypatch.setattr(torch, "empty", lambda *a, **kw: poison(empty(*a, **kw)))
    monkeypatch.setattr(torch, "empty_like", lambda *a, **kw: poison(empty_like(*a, **kw)))


@pytest.mark.parametrize("hw", [(1, 1), (5, 7), (37, 70), (130, 257), (1550, 2398),
                                (2800, 3800), (124, 2398), (2398, 124)])
def test_erode3_matches_plain(cuda, hw):
    """{0,1} masks, then {0,255} and any-nonzero masks with a few holes;
    the shapes include the headline ROI, the 8K ROI and the per-axis
    strips' ROIs."""
    rng = np.random.default_rng(hw[0])
    m = torch.from_numpy((rng.random(hw) < 0.9).astype(np.uint8))
    got = K.erode3(m.to(cuda))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), K.erode3_plain(m))
    holes = torch.from_numpy(rng.random(hw) < 0.002)
    for inside in (torch.full(hw, 255, dtype=torch.uint8),
                   torch.from_numpy(rng.integers(1, 256, hw).astype(np.uint8))):
        m = inside.masked_fill(holes, 0)
        assert torch.equal(K.erode3(m.to(cuda)).cpu(), K.erode3_plain(m))


@pytest.mark.parametrize("w", list(range(1, 41)) + [124, 463, 465, 929, 2398])
def test_erode3_every_offset(cuda, w):
    """The mask a contiguous view at byte offsets 0 .. 15 of a buffer on the
    card, so its rows start at every offset mod 16."""
    rng = np.random.default_rng(w)
    h = 37
    buf = torch.from_numpy(rng.integers(0, 256, h * w + 16).astype(np.uint8))
    buf[torch.from_numpy(rng.random(h * w + 16) < 0.97)] = 255
    buf_c = buf.to(cuda)
    for off in range(16):
        got = K.erode3(buf_c[off : off + h * w].view(h, w))
        assert torch.equal(got.cpu(), K.erode3_plain(buf[off : off + h * w].view(h, w)))
    torch.cuda.synchronize()


@pytest.mark.parametrize("hw", [(3, 3), (5, 9), (40, 57), (131, 260), (37, 4 * 37 + 1),
                                (23, 16 * 9 + 3), (1550, 2398)])
@pytest.mark.parametrize("mode", [(1, "opencv"), (2, "opencv"), (2, "norm"), (3, "opencv")])
def test_preprocess_rhs_t_matches_plain(cuda, hw, mode):
    """The destination a view at byte offsets 0 .. 15 of a wider image on the
    card, planar and interleaved (like run()); MONOCHROME's gray patch a
    stride-0 view; the headline ROI (1550 x 2398) among the shapes. The
    twin runs on the card's copies (integer-valued floats: exact)."""
    flags, rule = mode
    h, w = hw
    rng = np.random.default_rng(h * w)
    img = torch.from_numpy(_u8(rng, (h + 4, w + 22, 3)))
    img_d = {"interleaved": img.to(cuda), "planar": img.permute(2, 0, 1).contiguous().to(cuda)}
    patch = torch.from_numpy(_u8(rng, (3, h, w))).to(cuda)
    kflags = flags
    if flags == 3:  # MONOCHROME: gray patch broadcast with a stride-0 view
        patch = patch[0][None].expand(3, h, w)
        kflags = 1
    me = torch.from_numpy((rng.random((h, w)) < 0.7).astype(np.uint8)).to(cuda)
    for left in range(16):
        for layout, x in img_d.items():
            dest = (x[2 : 2 + h, left : left + w, :].permute(2, 0, 1)
                    if layout == "interleaved" else x[:, 2 : 2 + h, left : left + w])
            want = K.preprocess_rhs_t_plain(dest, patch, me, kflags, rule)
            got = K.preprocess_rhs_t(dest, patch, me, kflags, rule)
            torch.cuda.synchronize()
            # bit-exact, padding included (torch.empty output: every element written)
            assert torch.equal(got, want), (left, layout)


@pytest.mark.parametrize("ab", [(60, 90), (130, 61), (128, 256)])
def test_transpose_matches_plain(cuda, ab):
    a, b = ab
    rng = np.random.default_rng(a)
    x = torch.from_numpy(rng.normal(size=(3, a, b)).astype(np.float32) * 40)
    xd = x.to(cuda)
    got = K.transpose(xd)
    assert torch.equal(got.cpu(), K.transpose_plain(x))
    la = torch.from_numpy(dst_eigenvalues_padded(a - 5, a).copy()).to(cuda)
    lb = torch.from_numpy(dst_eigenvalues_padded(b - 3, b).copy()).to(cuda)
    got_d = K.transpose(xd, la, lb)
    want_d = K.transpose_plain(xd, la, lb)  # the twin on the card: IEEE divide
    torch.cuda.synchronize()
    assert torch.equal(got_d, want_d)


# (u's shape, h2, w2, top1, first left1, the destination's (H, W)): u's
# width at every residue mod 4, exact-size solutions (w2 == wu), runs below
# and past one warp's span, the headline slab, and both 8K pastes: the "t"
# chain's slab and the exact-size solve of the DD and mg_padded=False
# frames, wu = 3798 (2 mod 4: every other row 8 bytes off 16)
PASTE_CASES = {
    "wu0": ((3, 256, 384), 130, 260, 1, 1, (300, 520)),
    "wu1_exact": ((3, 140, 261), 140, 261, 7, 127, (300, 520)),
    "wu2": ((3, 131, 518), 131, 515, 55, 3, (300, 560)),
    "wu3_exact": ((3, 77, 515), 77, 515, 2, 17, (90, 560)),
    "one_row_short": ((3, 1, 37), 1, 37, 0, 0, (4, 60)),
    "headline_slab": ((3, 1664, 2432), 1548, 2396, 572, 1201, (2694, 4800)),
    "8k_slab": ((3, 2816, 3840), 2798, 3798, 760, 1940, (4320, 7680)),
    "8k_exact": ((3, 2798, 3798), 2798, 3798, 760, 1940, (4320, 7680)),
}


@pytest.mark.parametrize("planar", [True, False])
@pytest.mark.parametrize("case", list(PASTE_CASES))
def test_clamp_cast_paste_matches_plain(cuda, planar, case):
    """left1 at 8 consecutive offsets (every residue mod 8), values below
    0, above 255 and just under an integer; one launch a paste, the whole
    destination compared (the twin on the card's copy), so a stray byte
    fails."""
    shape, h2, w2, top1, left1, (hd, wd) = PASTE_CASES[case]
    gen = torch.Generator(cuda).manual_seed(shape[2] + h2)
    u = torch.randn(shape, generator=gen, device=cuda) * 160 + 90
    special = torch.tensor([254.9999, -0.0, 255.0, 255.5, -0.5, 0.9999, 1e9, -1e9], device=cuda)
    pick = torch.rand(shape, generator=gen, device=cuda) < 0.1
    u[pick] = special[torch.randint(0, 8, (int(pick.sum()),), generator=gen, device=cuda)]
    base = torch.randint(0, 256, (3, hd, wd) if planar else (hd, wd, 3), generator=gen,
                         device=cuda, dtype=torch.uint8)
    for left in range(left1, left1 + 8):
        want, got = base.clone(), base.clone()
        K.clamp_cast_paste_plain(u, want if planar else want.permute(2, 0, 1), top1, left, h2,
                                 w2)
        K.reset_launches()
        K.clamp_cast_paste(u, got if planar else got.permute(2, 0, 1), top1, left, h2, w2)
        torch.cuda.synchronize()
        assert K.LAUNCHES["clamp_cast_paste"] == 1
        assert torch.equal(got, want), left


@pytest.mark.parametrize("flags", [1, 2, 3])
def test_engine_card_matches_cpu(cuda, flags):
    rng = np.random.default_rng(flags)
    src = _u8(rng, (90, 130, 3))
    dst = _u8(rng, (200, 260, 3))
    yy, xx = np.mgrid[:90, :130]
    mask = (((yy - 45) ** 2 + (xx - 60) ** 2 < 35 ** 2)
            | ((yy > 20) & (yy < 50) & (xx > 10) & (xx < 120))).astype(np.uint8) * 255
    cfg = CloneConfig(flags=flags)
    got = SeamlessClone(cfg, device=cuda).run(src, dst, mask, (120, 100)).cpu().numpy()
    want = SeamlessClone(cfg, device="cpu").run(src, dst, mask, (120, 100)).numpy()
    assert np.abs(got.astype(np.int16) - want).max() <= 1


def _halves(n):
    he, ho = (n + 1) // 2, n // 2
    return he, ho, K.ru128(he), K.ru128(ho)


def _eo(rng, c, rows, n, scale=1.0, ep=None, pad=0.0):
    """Inverse half-GEMM outputs: data on lanes [0, he), ``pad`` on the
    padding lanes up to ``ep`` (default the 128-roundup of he)."""
    he, _, ep128, _ = _halves(n)
    ep = ep128 if ep is None else ep
    e = np.full((c, rows, ep), pad, np.float32)
    o = np.full((c, rows, ep), pad, np.float32)
    e[..., :he] = rng.normal(size=(c, rows, he)) * scale
    o[..., :he] = rng.normal(size=(c, rows, he)) * scale
    return torch.from_numpy(e), torch.from_numpy(o)


@pytest.mark.parametrize("n", [1, 2, 127, 128, 129, 301, 775, 1548])
def test_fold_minor_matches_plain(cuda, n):
    rng = np.random.default_rng(n)
    # lanes >= n hold data too: the kernel must not read them
    x = torch.from_numpy(rng.normal(size=(3, 70, K.ru128(n))).astype(np.float32) * 50)
    s, d = K.fold_minor(x.to(cuda), n)
    ws, wd = K.fold_minor_plain(x, n)
    torch.cuda.synchronize()
    # bit-exact over the whole buffer: the zero lanes come from torch.empty
    assert torch.equal(s.cpu(), ws) and torch.equal(d.cpu(), wd)


@pytest.mark.parametrize("n", [1, 127, 128, 300, 775])
def test_unfold_minor_matches_plain(cuda, n):
    e, o = _eo(np.random.default_rng(n), 3, 50, n)
    out_pad = K.ru128(n) + 128
    got = K.unfold_minor(e.to(cuda), o.to(cuda), n, out_pad)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), K.unfold_minor_plain(e, o, n, out_pad))


# the pair chain's headline slabs (pa, pb, m, windows): the plain pair
# (3, 2432, 896) x 2 and the divide's windows 0+896, 896+896 of
# (3, 1792, 1280) x 2, whole 64 x 64 tiles
HEADLINE_PAIRS = [(896, 896, 2432, ((0, 2432),)), (1280, 1280, 1792, ((0, 896), (896, 896)))]


@pytest.mark.parametrize("pab", [(128, 128), (896, 896), (100, 37), *HEADLINE_PAIRS])
def test_transpose_pair_matches_plain(cuda, pab):
    pa, pb = pab[:2]
    rng = np.random.default_rng(pa)
    m = 300 if len(pab) == 2 else pab[2]
    a = torch.from_numpy(rng.normal(size=(3, m, pa)).astype(np.float32) * 40).to(cuda)
    b = torch.from_numpy(rng.normal(size=(3, m, pb)).astype(np.float32) * 40).to(cuda)
    lam_p = torch.from_numpy(dst_eigenvalues_padded(pa + pb - 9, pa + pb).copy()).to(cuda)
    lam_r = torch.from_numpy(dst_eigenvalues_grouped(2 * m - 300)[:m].copy()).to(cuda)
    assert torch.equal(K.transpose_pair(a, b), K.transpose_pair_plain(a, b))
    windows = ((0, 131), (131, m - 131)) if len(pab) == 2 else pab[3]
    for rs, rc in windows:  # every row once
        assert torch.equal(K.transpose_pair(a, b, row_start=rs, row_count=rc),
                           K.transpose_pair_plain(a, b, row_start=rs, row_count=rc))
        # the twin on the card: the same sum, then an IEEE divide
        assert torch.equal(K.transpose_pair(a, b, lam_p, lam_r, rs, rc),
                           K.transpose_pair_plain(a, b, lam_p, lam_r, rs, rc))
    torch.cuda.synchronize()


@pytest.mark.parametrize("n", [127, 300, 1548])
def test_unfold_transpose_matches_plain(cuda, n):
    e, o = _eo(np.random.default_rng(n), 3, 256, n)
    e, o = e.to(cuda), o.to(cuda)
    out_pad = K.ru128(n)
    for rs, rc in ((0, 128), (128, 128), (0, 256), (37, 101)):
        assert torch.equal(K.unfold_transpose(e, o, n, out_pad, rs, rc),
                           K.unfold_transpose_plain(e, o, n, out_pad, rs, rc))
    torch.cuda.synchronize()


# the pair chain's headline unfold_transpose: n = 1548 on the inverse-h
# outputs (3, 2560, 896), the w spectrum's two 1280-row windows, out_pad
# 1664; then n % 4 = 1, 2, 3 on tight and padded ep, whole-tile windows at
# offsets that are no multiple of 64, a ragged window, and an ep that is no
# multiple of 4 (the ragged kernel)
@pytest.mark.parametrize("n, ep, windows", [
    (1548, 896, ((0, 1280), (1280, 1280))),
    (1549, 896, ((0, 1280), (64, 640))),
    (1550, 776, ((1280, 1280), (9, 64))),
    (1551, 776, ((0, 1280), (37, 101))),
    (301, 151, ((0, 128), (5, 2555)))])
def test_unfold_transpose_headline(cuda, n, ep, windows):
    """NaN on the padding lanes [he, ep), which no output may read; out_pad
    the 128-roundup (zero rows) and n (none)."""
    e, o = _eo(np.random.default_rng(n), 3, 2560, n, 160.0, ep=ep, pad=np.nan)
    e, o = e.to(cuda), o.to(cuda)
    for out_pad in (K.ru128(n), n):
        for rs, rc in windows:
            assert torch.equal(K.unfold_transpose(e, o, n, out_pad, rs, rc),
                               K.unfold_transpose_plain(e, o, n, out_pad, rs, rc)), (out_pad, rs)
    torch.cuda.synchronize()


@pytest.mark.parametrize("planar", [True, False])
@pytest.mark.parametrize("w2, ep", [(2396, 1280), (2397, 1280), (2398, 1200), (2399, 1201)])
def test_unfold_clamp_paste_headline(cuda, planar, w2, ep):
    """The headline paste (w2 = 2396, 1548 rows of (3, 1664, 1280)) into the
    serve buffer (3, 2694, 4800) or an interleaved (2694, 4800, 3) image at
    8 consecutive left1 (every offset mod 8, so the forward, the mirrored
    run and the word at he take every phase), then w2 % 4 = 1, 2, 3 on 67
    rows, a tight ep and one that is no multiple of 4 (the scalar loads);
    NaN on the padding lanes; the whole buffer against the twin's, so no
    byte outside the rectangle changed."""
    h2 = 1548 if w2 == 2396 else 67
    rng = np.random.default_rng(w2)
    e, o = _eo(rng, 3, 1664, w2, 160.0, ep=ep, pad=np.nan)
    e, o = (e + 90.0).to(cuda), o.to(cuda)
    base = torch.from_numpy(_u8(rng, (3, 2694, 4800) if planar else (2694, 4800, 3))).to(cuda)
    for left1 in range(1201, 1209):
        want, got = base.clone(), base.clone()
        K.unfold_clamp_paste_plain(e, o, want if planar else want.permute(2, 0, 1), 573, left1,
                                   h2, w2)
        K.unfold_clamp_paste(e, o, got if planar else got.permute(2, 0, 1), 573, left1, h2, w2)
        torch.cuda.synchronize()
        assert torch.equal(got, want), left1


@pytest.mark.parametrize("planar", [True, False])
@pytest.mark.parametrize("n, off", [(259, (1, 1)), (260, (7, 127)), (301, (55, 201))])
def test_unfold_clamp_paste_matches_plain(cuda, planar, n, off):
    top1, left1 = off
    h2 = 130
    rng = np.random.default_rng(n)
    e, o = _eo(rng, 3, 256, n, scale=160)
    base = _u8(rng, (3, 300, 520) if planar else (300, 520, 3))
    want = torch.from_numpy(base.copy())
    want_v = want if planar else want.permute(2, 0, 1)
    K.unfold_clamp_paste_plain(e, o, want_v, top1, left1, h2, n)
    got = torch.from_numpy(base.copy()).to(cuda)
    got_v = got if planar else got.permute(2, 0, 1)
    K.unfold_clamp_paste(e.to(cuda), o.to(cuda), got_v, top1, left1, h2, n)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)


# the per-axis strips' launches: the folded side n (2396 at chip_smoke.py's
# 126 x 2400 strips; 2397 and 2398 beside it) on slabs of 128 rows, the
# other side's 128-roundup
STRIP_N = [2396, 2397, 2398]


@pytest.mark.parametrize("n", STRIP_N)
def test_transpose_pair_strips(cuda, nan_outputs, n):
    """Strip H's forward pair (3, 128, ep) + (3, 128, op) -> (3, ep + op,
    128) and strip W's divide (grouped w eigenvalues along p, the padded h
    ones along r) on the chain's zeros (the padding rows from 122, the
    fold's padding lanes, and zeros among the data, whose quotients are
    -0), bit for bit; whole, then windows at an offset and one that is no
    whole tile (the ragged route)."""
    he, ho, ep, op = _halves(n)
    rng = np.random.default_rng(n)
    a = rng.normal(size=(3, 128, ep)).astype(np.float32) * 40
    b = rng.normal(size=(3, 128, op)).astype(np.float32) * 40
    for x, lanes in ((a, he), (b, ho)):
        x[:, 122:] = 0
        x[..., lanes:] = 0
        x[rng.random(x.shape) < 0.01] = 0
    a, b = torch.from_numpy(a).to(cuda), torch.from_numpy(b).to(cuda)
    lam_p = torch.from_numpy(dst_eigenvalues_grouped(n).copy()).to(cuda)
    lam_r = torch.from_numpy(dst_eigenvalues_padded(122, 128).copy()).to(cuda)

    def bits(x):
        return x.contiguous().view(torch.int32)

    for rs, rc in ((0, 128), (64, 64), (5, 101)):
        assert torch.equal(K.transpose_pair(a, b, row_start=rs, row_count=rc),
                           K.transpose_pair_plain(a, b, row_start=rs, row_count=rc)), rs
        got = K.transpose_pair(a, b, lam_p, lam_r, rs, rc)
        want = K.transpose_pair_plain(a, b, lam_p, lam_r, rs, rc)
        assert torch.equal(bits(got), bits(want)), rs
        assert bool((bits(want) == -(2 ** 31)).any())  # some -0 quotients
    torch.cuda.synchronize()


@pytest.mark.parametrize("n", STRIP_N)
def test_unfold_transpose_strips(cuda, nan_outputs, n):
    """Strip H's inverse: (3, 128, ep) x 2 -> (3, ru128(n), 128), NaN on the
    padding lanes; out_pad the roundup (zero rows) and n; windows at an
    offset and one that is no whole tile (the ragged route)."""
    e, o = _eo(np.random.default_rng(n), 3, 128, n, 160.0, pad=np.nan)
    e, o = e.to(cuda), o.to(cuda)
    for out_pad in (K.ru128(n), n):
        for rs, rc in ((0, 128), (64, 64), (5, 101)):
            assert torch.equal(K.unfold_transpose(e, o, n, out_pad, rs, rc),
                               K.unfold_transpose_plain(e, o, n, out_pad, rs, rc)), (out_pad, rs)
    torch.cuda.synchronize()


@pytest.mark.parametrize("planar", [True, False])
@pytest.mark.parametrize("n", STRIP_N)
def test_unfold_clamp_paste_strips(cuda, planar, n):
    """Strip W's paste: 122 and 124 rows of (3, 128, ep), w2 = n, into the
    serve buffer (3, 2694, 4800) or an interleaved image at 8 consecutive
    left1; NaN on the padding lanes; the whole buffer against the twin's."""
    rng = np.random.default_rng(n + 1)
    e, o = _eo(rng, 3, 128, n, 160.0, pad=np.nan)
    e, o = (e + 90.0).to(cuda), o.to(cuda)
    base = torch.from_numpy(_u8(rng, (3, 2694, 4800) if planar else (2694, 4800, 3))).to(cuda)
    for h2 in (122, 124):
        for left1 in range(1201, 1209):
            want, got = base.clone(), base.clone()
            K.unfold_clamp_paste_plain(e, o, want if planar else want.permute(2, 0, 1), 1285,
                                       left1, h2, n)
            K.unfold_clamp_paste(e, o, got if planar else got.permute(2, 0, 1), 1285, left1, h2,
                                 n)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (h2, left1)


def _per_frame(**counts):
    """Per-frame launches of every kernel: those given, 0 for the rest."""
    return {k: counts.get(k, 0) for k in K.LAUNCHES}


PAIR_CHAIN = _per_frame(erode3=1, preprocess_rhs_t=1, fold_minor=2, transpose_pair=3,
                        unfold_transpose=2, unfold_clamp_paste=1)
UNFOLDED = _per_frame(erode3=1, preprocess_rhs_t=1, transpose=3, clamp_cast_paste=1)
# the per-axis route: the long side folds, joined through the pair chain's
# kernels; strip W (w folds) ends in unfold_clamp_paste, strip H (h folds)
# runs unfold_transpose and clamp_cast_paste
PER_AXIS_W = _per_frame(erode3=1, preprocess_rhs_t=1, fold_minor=1, transpose=2,
                        transpose_pair=1, unfold_clamp_paste=1)
PER_AXIS_H = _per_frame(erode3=1, preprocess_rhs_t=1, fold_minor=1, transpose_pair=1,
                        transpose=1, unfold_transpose=1, clamp_cast_paste=1)


def _serve_counts(cuda, cfg, src_hw, per_frame):
    """Serve 1 warm-up + 3 frames of a full-mask patch: launch counts per
    frame as given, one prep_mask for the request, and the card within 1
    of the CPU."""
    rng = np.random.default_rng(sum(src_hw))
    src = _u8(rng, src_hw + (3,))
    dst = _u8(rng, (src_hw[0] + 60, src_hw[1] + 80, 3))
    mask = np.full(src_hw, 255, np.uint8)
    center = (dst.shape[1] // 2, dst.shape[0] // 2)
    K.reset_launches()
    out, ms = SeamlessClone(cfg, device=cuda).timed_serve(src, dst, mask, center, loops=3)
    torch.cuda.synchronize()
    assert K.LAUNCHES == {k: v * 4 for k, v in per_frame.items()} | {"prep_mask": 1}
    assert ms > 0
    want, _ = SeamlessClone(cfg, device="cpu").timed_serve(src, dst, mask, center, loops=3)
    assert np.abs(out.cpu().numpy().astype(np.int16) - want.numpy()).max() <= 1


def test_serve_goes_through_every_kernel(cuda):
    """The default config on a patch whose interior folds on both sides
    (146 x 196): the pair chain."""
    _serve_counts(cuda, CloneConfig(), (150, 200), PAIR_CHAIN)


def test_serve_unfolded_chain(cuda):
    _serve_counts(cuda, CloneConfig(dst_folded=False), (150, 200), UNFOLDED)


@pytest.mark.parametrize("src_hw", [(60, 200), (200, 60)])
def test_serve_per_axis_strip(cuda, src_hw):
    """A strip whose short side does not fold: one fold, the fused kernels
    for the rest, no unfold_minor."""
    _serve_counts(cuda, CloneConfig(), src_hw, PER_AXIS_W if src_hw[1] > src_hw[0] else PER_AXIS_H)


@pytest.mark.parametrize("src_hw", [(126, 2400), (2400, 126)])
def test_serve_per_axis_full_strips(cuda, src_hw):
    """chip_smoke.py's two strips at full size, the card within 1 of the CPU."""
    _serve_counts(cuda, CloneConfig(), src_hw, PER_AXIS_W if src_hw[1] > src_hw[0] else PER_AXIS_H)


# ---------------------------------------------------------------------------
# the transpose-fused multigrid chain
# ---------------------------------------------------------------------------

MG_CASES = [
    ((64, 130), (1.0, 1.0)),
    ((63, 127), (1.5, 1.25)),
    ((70, 200), (1.0, 2.0)),
    ((129, 257), (2.0, 1.0)),
    ((40, 256), (1.0, 1.5)),
    ((518, 526), (1.0, 1.0)),     # many tiles each way
    ((263, 259), (1.9375, 1.4375)),  # an 8K coarse level's betas
]


def _level_slab(rng, h, w, hp, wp, scale=50.0):
    x = np.zeros((3, hp, wp), np.float32)
    x[:, :h, :w] = rng.normal(size=(3, h, w)) * scale
    return torch.from_numpy(x)


# (hw, beta, slab): every MG_CASES level on its padded slab (th 128 and
# 16), exact-size slabs (an odd width, the height padded to even, h = 32 k +
# 2 where the even-h edge row reads two rows below a tile, rh_rows past hp
# / 2) and the 8K "q" chain's three coarse levels on their slabs
DOWN_CASES = [(hw, beta, th) for th in (None, 16) for hw, beta in MG_CASES] + [
    ((41, 57), (1.5, 0.5), "exact"),
    ((34, 71), (1.9375, 1.4375), "exact"),
    ((698, 949), (1.75, 1.25), "exact"),
    ((1398, 1898), (1.5, 1.5), "exact + 3"),
] + [((h, w), (bh, bw), "8K coarse") for h, w, bh, bw, _ in TM.q_coarse_levels(2798, 3798)]


@pytest.mark.parametrize("hw,beta,slab", DOWN_CASES)
def test_mg_down_matches_plain(cuda, hw, beta, slab):
    (h, w), (bh, bw) = hw, beta
    if slab in ("exact", "exact + 3"):
        hp, wp = h + h % 2, w
        hp2 = hp // 2 + (3 if slab == "exact + 3" else 0)
    elif slab == "8K coarse":
        hp, wp, hp2 = next(geom[1:] for lh, lw, *_, geom in TM.q_coarse_levels(2798, 3798)
                           if (lh, lw) == (h, w))
    else:
        _, hp, wp, hp2 = K.mg_geometry_t(h, w, th=slab)
    rng = np.random.default_rng(h * w)
    g = _level_slab(rng, h, w, hp, wp)
    u = _level_slab(rng, h, w, hp, wp, 10.0)
    for nu1 in (0, 1, 2):
        for uz in (False, True):
            u_in = None if uz else u
            wu, wrh = K.mg_down_plain(u_in, g, nu1, h, w, bh, bw, hp2)
            gu, grh = K.mg_down(None if uz else u.to(cuda), g.to(cuda), nu1, h, w, bh, bw,
                                hp2)
            torch.cuda.synchronize()
            # every element: the kernel writes rh's rows past hp // 2 as zeros
            assert torch.equal(gu.cpu(), wu) and torch.equal(grh.cpu(), wrh), (nu1, uz)


@pytest.mark.parametrize("hw,beta", MG_CASES)
def test_mg_up_matches_plain(cuda, hw, beta):
    (h, w), (bh, bw) = hw, beta
    _, hp, wp, hp2 = K.mg_geometry_t(h, w)
    hc = (h - 1) // 2
    rng = np.random.default_rng(h + w)
    g = _level_slab(rng, h, w, hp, wp)
    u = _level_slab(rng, h, w, hp, wp, 10.0)
    e = _level_slab(rng, hc, w, hp2, wp, 5.0)
    for nu2 in (0, 2, 4):
        got = K.mg_up(u.to(cuda), g.to(cuda), e.to(cuda), nu2, h, w, bh, bw)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), K.mg_up_plain(u, g, e, nu2, h, w, bh, bw)), nu2


@pytest.mark.parametrize("hw,beta", MG_CASES)
def test_mg_transfers_match_plain(cuda, hw, beta):
    (h, w), (_, bw) = hw, beta
    _, hp, wp, hp2 = K.mg_geometry_t(h, w)
    hc, wc = (h - 1) // 2, (w - 1) // 2
    _, chp, cwp, _ = K.mg_geometry_t(wc, hc, wp_min=hp2)
    rng = np.random.default_rng(h * 3 + w)
    rh = _level_slab(rng, hp // 2, w, hp2, wp)  # leftovers past hc: masked
    got = K.mg_restrict_t(rh.to(cuda), h, w, bw, chp)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), K.mg_restrict_t_plain(rh, h, w, bw, chp))
    ec = _level_slab(rng, wc, hc, chp, cwp, 5.0)
    got = K.mg_prolong_t(ec.to(cuda), w, bw, hp2, wp)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), K.mg_prolong_t_plain(ec, w, bw, hp2, wp))


@pytest.mark.parametrize("hw", [(3, 3), (40, 57), (131, 260)])
@pytest.mark.parametrize("mode", [(1, "opencv"), (2, "opencv"), (2, "norm"), (3, "opencv")])
def test_preprocess_rhs_p_matches_plain(cuda, hw, mode):
    flags, rule = mode
    h, w = hw
    rng = np.random.default_rng(h * w + 1)
    img = torch.from_numpy(_u8(rng, (h + 4, w + 6, 3)))
    dest = img[2 : 2 + h, 3 : 3 + w, :].permute(2, 0, 1)
    patch = torch.from_numpy(_u8(rng, (3, h, w)))
    kflags = flags
    if flags == 3:
        patch = patch[0][None].expand(3, h, w)
        kflags = 1
    me = torch.from_numpy((rng.random((h, w)) < 0.7).astype(np.uint8))
    for out_hw in ((h - 2, w - 2), (h + 30, w + 131)):
        want = K.preprocess_rhs_p_plain(dest, patch, me, out_hw, kflags, rule)
        got = K.preprocess_rhs_p(dest.to(cuda), patch.to(cuda), me.to(cuda), out_hw, kflags,
                                 rule)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want)


def _rhs_p_on_card(cuda, c, h, w, out_hw, flags, rule, left, planar, gray, seed):
    """preprocess_rhs_p of a view at column ``left`` of a destination on the
    card (planar or interleaved) against its twin on the card's copies
    (integer-valued floats: exact), one launch."""
    gen = torch.Generator(cuda).manual_seed(seed)
    shape = (c, h + 3, w + left + 5) if planar else (h + 3, w + left + 5, c)
    img = torch.randint(0, 256, shape, generator=gen, device=cuda, dtype=torch.uint8)
    dest = (img[:, 2 : 2 + h, left : left + w] if planar
            else img[2 : 2 + h, left : left + w, :].permute(2, 0, 1))
    patch = torch.randint(0, 256, (c, h, w), generator=gen, device=cuda, dtype=torch.uint8)
    if gray:
        patch = patch[0][None].expand(c, h, w)
    me = (torch.rand((h, w), generator=gen, device=cuda) < 0.7).to(torch.uint8)
    K.reset_launches()
    got = K.preprocess_rhs_p(dest, patch, me, out_hw, flags, rule)
    torch.cuda.synchronize()
    assert K.LAUNCHES["preprocess_rhs_p"] == 1
    assert torch.equal(got, K.preprocess_rhs_p_plain(dest, patch, me, out_hw, flags, rule))


@pytest.mark.parametrize("mode", [(1, "opencv", False), (2, "opencv", False),
                                  (2, "norm", False), (1, "opencv", True)])
@pytest.mark.parametrize("case", ["8K slab", "8K exact", "headline exact"])
def test_preprocess_rhs_p_full_size(cuda, nan_outputs, case, mode):
    """The 8K ROI (3, 2800, 3800) into the "t" chain's level-0 slab
    (3, 2816, 3840; its last block row wholly padding) and exactly
    (3, 2798, 3798: scalar stores), the headline ROI (3, 1550, 2398) into
    (3, 1548, 2396); NORMAL, MIXED opencv and norm, and the stride-0 gray
    patch; outputs start as NaN."""
    flags, rule, gray = mode
    h, w = (2800, 3800) if case.startswith("8K") else (1550, 2398)
    out_hw = (h - 2, w - 2)
    if case == "8K slab":
        _, hp, wp, _ = K.mg_geometry_t(h - 2, w - 2)
        out_hw = (hp, wp)
    _rhs_p_on_card(cuda, 3, h, w, out_hw, flags, rule, 1 + 7 * len(case) % 16, True, gray,
                   h + flags)


@pytest.mark.parametrize("planar", [True, False])
@pytest.mark.parametrize("hw,pad", [((37, 4 * 37 + 3), (0, 0)), ((23, 16 * 9 + 6), (0, 0)),
                                    ((41, 131), (0, 1)), ((18, 262), (3, 2)),
                                    ((19, 70), (37, 300))])
def test_preprocess_rhs_p_every_offset(cuda, nan_outputs, hw, pad, planar):
    """The destination a view at byte offsets 0 .. 15 of a wider image on the
    card, planar and interleaved; slab widths wpo % 4 = 0 .. 3; a slab with
    whole blocks of padding below and right of the interior; outputs start
    as NaN."""
    h, w = hw
    for left in range(16):
        _rhs_p_on_card(cuda, 3, h, w, (h - 2 + pad[0], w - 2 + pad[1]), 1, "opencv", left,
                       planar, left % 5 == 0, 16 * h + left)
        _rhs_p_on_card(cuda, 3, h, w, (h - 2 + pad[0], w - 2 + pad[1]), 2, "norm", left,
                       planar, False, 16 * w + left)


MG_T_FIXED = _per_frame(erode3=1, preprocess_rhs_p=1, clamp_cast_paste=1, mg_down_t=4,
                        mg_up_t=4)


def test_serve_mg_t_fixed_counts(cuda):
    """mg_padded="t", 2 fixed cycles, interior 518 x 526: 2 fused levels,
    so each V-cycle kernel (the fused descent and ascent) runs 2 x 2 times
    a frame."""
    _serve_counts(cuda, CloneConfig(solver="multigrid", mg_padded="t", mg_cycles=2),
                  (520, 528), MG_T_FIXED)


def test_serve_mg_t_tol_counts(cuda):
    """Tolerance mode: both V-cycle kernels a multiple of the 2 levels, the
    same for both, no standalone level kernel or transfer, and the card
    within 1 of the CPU."""
    rng = np.random.default_rng(0)
    src = _u8(rng, (520, 528, 3))
    dst = _u8(rng, (580, 600, 3))
    mask = np.full((520, 528), 255, np.uint8)
    cfg = CloneConfig(solver="multigrid", mg_padded="t")
    K.reset_launches()
    out = SeamlessClone(cfg, device=cuda).run(src, dst, mask, (300, 290)).cpu().numpy()
    torch.cuda.synchronize()
    n = K.LAUNCHES["mg_down_t"]
    assert n > 0 and n % 2 == 0
    assert K.LAUNCHES == _per_frame(erode3=1, preprocess_rhs_p=1, clamp_cast_paste=1,
                                    mg_down_t=n, mg_up_t=n, prep_mask=1)
    want = SeamlessClone(cfg, device="cpu").run(src, dst, mask, (300, 290)).numpy()
    assert np.abs(out.astype(np.int16) - want).max() <= 1


# ---------------------------------------------------------------------------
# the fused transfers: mg_down_t (mg_down + mg_restrict_t) and mg_up_t
# (mg_prolong_t + mg_up), vcycle_t's two kernels a level
# ---------------------------------------------------------------------------


# (label, (h, w, bh, bw, geom)): the 8K frame's "t" levels and "q" coarse
# levels, the headline's, and small levels (betas != 1, odd and even sides,
# w - 1 = 65 and 129: the even-w edge column at a tile's right end; rc_t
# rows past the tiles)
FUSED_LEVELS = [(f"{frame} {chain} {i}", lv)
                for frame, hw in (("8K", (2798, 3798)), ("headline", (1548, 2396)))
                for chain, levels in (("t", TM.t_levels(*hw)), ("q", TM.q_coarse_levels(*hw)))
                for i, lv in enumerate(levels)] + [
    (f"{h}x{w}", (h, w, bh, bw, K.mg_geometry_t(h, w))) for h, w, bh, bw in (
        (70, 200, 1.0, 2.0), (129, 257, 2.0, 1.0), (134, 99, 1.9375, 1.4375),
        (63, 66, 1.5, 1.25), (33, 130, 1.25, 1.75), (150, 300, 1.75, 1.5))]


def _child_geom(lv):
    h, w, _, _, geom = lv
    return K.mg_geometry_t((w - 1) // 2, (h - 1) // 2, wp_min=geom[3])


@pytest.mark.parametrize("label,lv", FUSED_LEVELS)
def test_mg_down_t_matches_plain_and_chain(cuda, label, lv):
    """Every nu1 with a given and a known-zero guess: u and rc_t bit-exact
    against mg_down_t_plain (on the card) and against the unfused chain
    mg_restrict_t(mg_down(..., rh_rows=hp2)[1]) on the card, over every
    element (rc_t's uncovered band of zeros included)."""
    h, w, bh, bw, (_, hp, wp, hp2) = lv
    out_rows = _child_geom(lv)[1]
    gen = torch.Generator(cuda).manual_seed(h * w)
    g = torch.zeros((3, hp, wp), device=cuda)
    u = torch.zeros((3, hp, wp), device=cuda)
    g[:, :h, :w] = torch.randn((3, h, w), generator=gen, device=cuda) * 50
    u[:, :h, :w] = torch.randn((3, h, w), generator=gen, device=cuda) * 10
    for nu1 in (0, 1, 2):
        for guess in (u, None):
            got = K.mg_down_t(guess, g, nu1, h, w, bh, bw, out_rows)
            want = K.mg_down_t_plain(guess, g, nu1, h, w, bh, bw, out_rows)
            u_c, rh = K.mg_down(guess, g, nu1, h, w, bh, bw, hp2)
            chain = (u_c, K.mg_restrict_t(rh, h, w, bw, out_rows))
            torch.cuda.synchronize()
            assert got[1].shape == (3, out_rows, hp2)
            for a, b, c in zip(got, want, chain):
                assert torch.equal(a, b) and torch.equal(a, c), (nu1, guess is None)


@pytest.mark.parametrize("label,lv", FUSED_LEVELS)
def test_mg_up_t_matches_plain_and_chain(cuda, label, lv):
    """nu2 in {0, 2, 4} (both rings): bit-exact against mg_up_t_plain (on the
    card) and against the unfused chain mg_up(mg_prolong_t(ec_t, out_rows =
    hp2)) on the card; ec_t carries junk on lanes >= hc, which both ignore."""
    h, w, bh, bw, (_, hp, wp, hp2) = lv
    hc, wc = (h - 1) // 2, (w - 1) // 2
    _, chp, cwp, _ = _child_geom(lv)
    gen = torch.Generator(cuda).manual_seed(h + w)
    g = torch.zeros((3, hp, wp), device=cuda)
    u = torch.zeros((3, hp, wp), device=cuda)
    ec = torch.zeros((3, chp, cwp), device=cuda)
    g[:, :h, :w] = torch.randn((3, h, w), generator=gen, device=cuda) * 50
    u[:, :h, :w] = torch.randn((3, h, w), generator=gen, device=cuda) * 10
    ec[:, :wc, :hc] = torch.randn((3, wc, hc), generator=gen, device=cuda) * 5
    ec[:, :wc, hc:] = torch.randn((3, wc, cwp - hc), generator=gen, device=cuda)
    for nu2 in (0, 2, 4):
        got = K.mg_up_t(u, g, ec, nu2, h, w, bh, bw)
        want = K.mg_up_t_plain(u, g, ec, nu2, h, w, bh, bw)
        chain = K.mg_up(u, g, K.mg_prolong_t(ec, w, bw, hp2, wp), nu2, h, w, bh, bw)
        torch.cuda.synchronize()
        assert torch.equal(got, want) and torch.equal(got, chain), nu2


def test_vcycle_t_fused_equals_unfused(cuda):
    """Whole V-cycles at the headline's "t" fine level (3 fused levels, a
    given guess) and at its "q" chain's first coarse level (2, a known-zero
    guess): the fused chain bit-equal to the four-kernel chain
    (``vcycle_t_unfused``), with 2 launches a level against 4."""
    for (h, w, bh, bw, geom), given, levels in ((TM.t_levels(1548, 2396)[0], True, 3),
                                                (TM.q_coarse_levels(1548, 2396)[0], False, 2)):
        gen = torch.Generator(cuda).manual_seed(h)
        g = torch.zeros((3,) + geom[1:3], device=cuda)
        g[:, :h, :w] = torch.randn((3, h, w), generator=gen, device=cuda) * 50
        u = g * 0.1 if given else None
        K.reset_launches()
        got = TM.vcycle_t(u, g, h, w, 1, 2, 63, bh, bw, geom, {})
        torch.cuda.synchronize()
        assert K.LAUNCHES == _per_frame(mg_down_t=levels, mg_up_t=levels)
        K.reset_launches()
        want = TM.vcycle_t_unfused(u, g, h, w, 1, 2, 63, bh, bw, geom, {})
        torch.cuda.synchronize()
        assert K.LAUNCHES == _per_frame(mg_down=levels, mg_up=levels, mg_restrict_t=levels,
                                        mg_prolong_t=levels)
        assert torch.equal(got, want)


@pytest.mark.parametrize("padded", ["q", "t"])
def test_solve_cycles_unchanged_by_fusion(cuda, padded, monkeypatch):
    """solve_multigrid to tol 1e-4 on a (3, 1548, 2396) RHS: the fused chain
    and the four-kernel chain run the same cycles and give the same bits."""
    gen = torch.Generator(cuda).manual_seed(3)
    g = torch.randn((3, 1548, 2396), generator=gen, device=cuda) * 50
    got, info = TM.solve_multigrid(g, padded=padded, use_pallas=True, tol=1e-4,
                                   return_info=True)
    monkeypatch.setattr(TM, "vcycle_t", TM.vcycle_t_unfused)
    want, winfo = TM.solve_multigrid(g, padded=padded, use_pallas=True, tol=1e-4,
                                     return_info=True)
    torch.cuda.synchronize()
    assert info["cycles"] == winfo["cycles"] >= 2
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# the quarter-plane finest level (mg_padded="q")
# ---------------------------------------------------------------------------

# (h, w): even/even, odd/odd, even/odd, odd/even, two strips, many tiles; the
# rc_t of (250, 129) and (300, 257) has fewer rows (chp) than the planes'
# width (wq2), so tiles past chp write no coarse RHS
Q_CASES = [(200, 230), (201, 231), (250, 129), (129, 300), (300, 257), (518, 526)]


def _q_planes(rng, h, w, scale=50.0):
    _, hq, wq2, _ = K.mg_geometry_q(h, w)
    x = np.zeros((3, 2 * hq, 2 * wq2), np.float32)
    x[:, :h, :w] = rng.normal(size=(3, h, w)) * scale
    return K.to_quarters(torch.from_numpy(x))


def _q_corr(rng, h, w):
    _, hq, wq2, _ = K.mg_geometry_q(h, w)
    hc = (h - 1) // 2
    ee = np.zeros((3, hq, wq2), np.float32)
    eo = np.zeros((3, hq, wq2), np.float32)
    ee[:, :hc, : (w + 1) // 2] = rng.normal(size=(3, hc, (w + 1) // 2)) * 5
    eo[:, :hc, : w // 2] = rng.normal(size=(3, hc, w // 2)) * 5
    return torch.from_numpy(ee), torch.from_numpy(eo)


@pytest.mark.parametrize("hw", Q_CASES)
def test_mg_q_level_kernels_match_plain(cuda, hw):
    """mg_down_q (both forms), mg_up_q, mg_ud_q (with and without its
    residual) and mg_prolong_tq, bit-exact over every output element."""
    h, w = hw
    _, hq, wq2, hp2 = K.mg_geometry_q(h, w)
    hc, wc = (h - 1) // 2, (w - 1) // 2
    _, chp, cwp, _ = K.mg_geometry_t(wc, hc, wp_min=hp2)
    rng = np.random.default_rng(h * w + 7)
    g, u = _q_planes(rng, h, w), _q_planes(rng, h, w, 10.0)
    ee, eo = _q_corr(rng, h, w)
    gd, ud, eed, eod = (x.to(cuda) for x in (g, u, ee, eo))
    for nu1 in (1, 2):
        for uz in (True, False):
            want = K.mg_down_q_plain(None if uz else u, g, nu1, h, w, chp)
            got = K.mg_down_q(None if uz else ud, gd, nu1, h, w, chp)
            torch.cuda.synchronize()
            assert all(torch.equal(a.cpu(), b) for a, b in zip(got, want)), (nu1, uz)
    for nu2 in (0, 2, 4):
        got = K.mg_up_q(ud, gd, eed, eod, nu2, h, w)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), K.mg_up_q_plain(u, g, ee, eo, nu2, h, w)), nu2
    for nu2, nu1 in ((2, 1), (4, 2), (0, 1)):
        for with_residual in (False, True):
            want = K.mg_ud_q_plain(u, g, ee, eo, nu2, nu1, h, w, chp, with_residual)
            got = K.mg_ud_q(ud, gd, eed, eod, nu2, nu1, h, w, chp, with_residual)
            torch.cuda.synchronize()
            assert len(got) == len(want) == 2 + with_residual
            assert all(torch.equal(a.cpu(), b) for a, b in zip(got, want)), (nu2, nu1)
    ec = np.zeros((3, chp, cwp), np.float32)
    ec[:, :wc, :hc] = rng.normal(size=(3, wc, hc)) * 5
    ec = torch.from_numpy(ec)
    got = K.mg_prolong_tq(ec.to(cuda), w, hp2, wq2)
    torch.cuda.synchronize()
    assert all(torch.equal(a.cpu(), b) for a, b in zip(got, K.mg_prolong_tq_plain(ec, w, hp2,
                                                                                    wq2)))


@pytest.mark.parametrize("hw", [(3, 3), (40, 57), (131, 260), (37, 4 * 37 + 1),
                                (23, 16 * 9 + 3)])
@pytest.mark.parametrize("mode", [(1, "opencv"), (2, "opencv"), (2, "norm"), (3, "opencv")])
def test_preprocess_rhs_q_matches_plain(cuda, hw, mode):
    """The destination a view at byte offsets 0 .. 15 of a wider image on the
    card, planar and interleaved; MONOCHROME's gray patch a stride-0 view."""
    flags, rule = mode
    h, w = hw
    rng = np.random.default_rng(h * w + 2)
    img = torch.from_numpy(_u8(rng, (h + 4, w + 22, 3)))
    img_d = {"interleaved": img.to(cuda), "planar": img.permute(2, 0, 1).contiguous().to(cuda)}
    patch = torch.from_numpy(_u8(rng, (3, h, w)))
    kflags = flags
    if flags == 3:
        patch = patch[0][None].expand(3, h, w)
        kflags = 1
    patch_d = patch.to(cuda) if flags != 3 else patch[0].to(cuda)[None].expand(3, h, w)
    me = torch.from_numpy((rng.random((h, w)) < 0.7).astype(np.uint8))
    _, hq, wq2, _ = K.mg_geometry_q(max(h - 2, 1), max(w - 2, 1))
    for left in range(16):
        dest = img[2 : 2 + h, left : left + w, :].permute(2, 0, 1)
        for layout, x in img_d.items():
            dest_d = (x[2 : 2 + h, left : left + w, :].permute(2, 0, 1)
                      if layout == "interleaved" else x[:, 2 : 2 + h, left : left + w])
            for out_hw in ((2 * hq, 2 * wq2), (h + (h % 2), w + 130 + (w % 2))):
                want = K.preprocess_rhs_q_plain(dest, patch, me, out_hw, kflags, rule)
                got = K.preprocess_rhs_q(dest_d, patch_d, me.to(cuda), out_hw, kflags, rule)
                torch.cuda.synchronize()
                assert torch.equal(got.cpu(), want), (left, layout, out_hw)


@pytest.mark.parametrize("planar", [True, False])
@pytest.mark.parametrize("off, hw", [((1, 1), (255, 256)), ((7, 127), (130, 259)),
                                     ((55, 201), (200, 311)), ((2, 0), (1, 1)),
                                     ((0, 3), (77, 385))])
def test_clamp_cast_paste_q_matches_plain(cuda, planar, off, hw):
    """left1 at 16 consecutive offsets from each case's, odd and even h2 and
    w2, values below 0, above 255 and just under an integer; the last
    offset also from planes of an odd width (the kernel's scalar loads)."""
    top1, left1 = off
    h2, w2 = hw
    _, hq, wq2, _ = K.mg_geometry_q(h2, w2)
    rng = np.random.default_rng(top1 + w2)
    uq = rng.normal(size=(3, 4, hq, wq2)).astype(np.float32) * 160 + 90
    special = np.array([254.9999, -0.0, 255.0, 255.5, -0.5, 0.9999, 1e9, -1e9], np.float32)
    pick = rng.random(uq.shape) < 0.1
    uq[pick] = rng.choice(special, int(pick.sum()))
    need = (w2 + 1) // 2  # quarter columns that hold a pixel
    uq_odd = np.zeros((3, 4, hq, need + 1 - need % 2), np.float32)
    uq_odd[..., :need] = uq[..., :need]
    uq_odd = torch.from_numpy(uq_odd)
    uq = torch.from_numpy(uq)
    base = _u8(rng, (3, 300, 560) if planar else (300, 560, 3))
    for left in list(range(left1, left1 + 16)) + [-1]:
        if left < 0:
            left, uq = left1 + 15, uq_odd
        want = torch.from_numpy(base.copy())
        K.clamp_cast_paste_q_plain(uq, want if planar else want.permute(2, 0, 1), top1, left,
                                   h2, w2)
        got = torch.from_numpy(base.copy()).to(cuda)
        K.clamp_cast_paste_q(uq.to(cuda), got if planar else got.permute(2, 0, 1), top1, left,
                             h2, w2)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want), left


MG_Q_FIXED = _per_frame(erode3=1, preprocess_rhs_q=1, clamp_cast_paste_q=1, mg_down_q=1,
                        mg_ud_q=1, mg_up_q=1, mg_prolong_tq=2, mg_down_t=2, mg_up_t=2)


def test_serve_mg_q_fixed_counts(cuda):
    """The default mg_padded="q", 2 fixed cycles, interior 518 x 526 (one
    fused coarse level): a frame is mg_down_q, one mg_ud_q, mg_up_q, and per
    cycle mg_prolong_tq and the coarse level's two kernels."""
    _serve_counts(cuda, CloneConfig(solver="multigrid", mg_cycles=2), (520, 528), MG_Q_FIXED)


def test_serve_mg_q_tol_counts(cuda):
    """Tolerance mode: mg_ud_q once per cycle (the burst of 3 and each
    checked cycle), mg_prolong_tq and each coarse kernel as often, one
    mg_down_q, no mg_up_q; the card within 1 of the CPU."""
    rng = np.random.default_rng(1)
    src = _u8(rng, (520, 528, 3))
    dst = _u8(rng, (580, 600, 3))
    mask = np.full((520, 528), 255, np.uint8)
    cfg = CloneConfig(solver="multigrid")
    K.reset_launches()
    out = SeamlessClone(cfg, device=cuda).run(src, dst, mask, (300, 290)).cpu().numpy()
    torch.cuda.synchronize()
    n = K.LAUNCHES["mg_ud_q"]
    assert n >= 3
    assert K.LAUNCHES == _per_frame(erode3=1, preprocess_rhs_q=1, clamp_cast_paste_q=1,
                                    mg_down_q=1, mg_ud_q=n, mg_prolong_tq=n, mg_down_t=n,
                                    mg_up_t=n, prep_mask=1)
    want = SeamlessClone(cfg, device="cpu").run(src, dst, mask, (300, 290)).numpy()
    assert np.abs(out.astype(np.int16) - want).max() <= 1


# ---------------------------------------------------------------------------
# the rest of the quarter-plane chain: the conversions, the split descent and
# its restriction, the ascent with its residual, dense solves
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(1, 2, 2), (3, 256, 256), (2, 512, 768), (3, 2, 2050)])
def test_quarter_conversions_match_plain(cuda, shape):
    """to_quarters and from_quarters bit-exact against their twins, and each
    other's inverse; a misaligned dense view is refused (float2 pairs)."""
    rng = np.random.default_rng(sum(shape))
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    q = K.to_quarters(x.to(cuda))
    d = K.from_quarters(q)
    torch.cuda.synchronize()
    assert torch.equal(q.cpu(), K.to_quarters_plain(x))
    assert torch.equal(d.cpu(), x)
    qc = torch.from_numpy(rng.normal(size=q.shape).astype(np.float32))
    assert torch.equal(K.from_quarters(qc.to(cuda)).cpu(), K.from_quarters_plain(qc))
    flat = torch.zeros(x.numel() + 1, device=cuda)
    with pytest.raises(ValueError, match="aligned"):
        K.to_quarters(flat[1:].view(shape))


@pytest.mark.parametrize("hw", Q_CASES)
def test_mg_q_split_and_residual_forms_match_plain(cuda, hw):
    """The split mg_down_q (both guesses, nu1 1 and 2), mg_restrict_tq (on
    its output, and on planes with NaN where it must not read) and mg_up_q
    with its residual (nu2 0, 2, 4), bit-exact; split + restrict equals the
    fused descent's rc_t."""
    h, w = hw
    _, hq, wq2, hp2 = K.mg_geometry_q(h, w)
    hc, wc = (h - 1) // 2, (w - 1) // 2
    chp = K.mg_geometry_t(wc, hc, wp_min=hp2)[1]
    rng = np.random.default_rng(h * w + 11)
    g, u = _q_planes(rng, h, w), _q_planes(rng, h, w, 10.0)
    ee, eo = _q_corr(rng, h, w)
    gd, ud, eed, eod = (x.to(cuda) for x in (g, u, ee, eo))
    for nu1 in (1, 2):
        for uz in (True, False):
            want = K.mg_down_q_plain(None if uz else u, g, nu1, h, w)
            got = K.mg_down_q(None if uz else ud, gd, nu1, h, w)
            torch.cuda.synchronize()
            assert len(got) == 3
            assert all(torch.equal(a.cpu(), b) for a, b in zip(got, want)), (nu1, uz)
            rc = K.mg_restrict_tq(got[1], got[2], h, w, chp)
            torch.cuda.synchronize()
            assert torch.equal(rc.cpu(), K.mg_restrict_tq_plain(want[1], want[2], h, w, chp))
            assert torch.equal(rc, K.mg_down_q(None if uz else ud, gd, nu1, h, w, chp)[1])
    poisoned = [x.clone() for x in got[1:]]
    for x in poisoned:
        x[:, hc:] = float("nan")
        x[:, :, wc + 1 :] = float("nan")
    assert torch.equal(K.mg_restrict_tq(*poisoned, h, w, chp), rc)
    for nu2 in (0, 2, 4):
        got = K.mg_up_q(ud, gd, eed, eod, nu2, h, w, with_residual=True)
        torch.cuda.synchronize()
        want = K.mg_up_q_plain(u, g, ee, eo, nu2, h, w, with_residual=True)
        assert got[1].dim() == 0
        assert all(torch.equal(a.cpu(), b) for a, b in zip(got, want)), nu2


# the redesigned level kernels' edges: every (nu2, nu1) the fused boundary
# takes (nu1 + nu2 <= 6: the Shallow ring up to 3, the Deep one beyond), a
# domain inside one tile, and domains that cut the last tile row and column
# at odd and even h / w
Q_NU_PAIRS = [(nu2, nu1) for nu2 in range(5) for nu1 in range(1, 7 - nu2)]
Q_EDGE_CASES = [(5, 7), (201, 157), (256, 255), (199, 256)]


@pytest.mark.parametrize("hw", Q_EDGE_CASES)
def test_mg_ud_q_every_nu_pair(cuda, hw):
    h, w = hw
    hp2 = K.mg_geometry_q(h, w)[3]
    chp = K.mg_geometry_t((w - 1) // 2, (h - 1) // 2, wp_min=hp2)[1]
    rng = np.random.default_rng(h * w + 13)
    g, u = _q_planes(rng, h, w), _q_planes(rng, h, w, 10.0)
    ee, eo = _q_corr(rng, h, w)
    gd, ud, eed, eod = (x.to(cuda) for x in (g, u, ee, eo))
    for nu2, nu1 in Q_NU_PAIRS:
        for with_residual in (False, True):
            want = K.mg_ud_q_plain(u, g, ee, eo, nu2, nu1, h, w, chp, with_residual)
            got = K.mg_ud_q(ud, gd, eed, eod, nu2, nu1, h, w, chp, with_residual)
            torch.cuda.synchronize()
            assert all(torch.equal(a.cpu(), b) for a, b in zip(got, want)), (nu2, nu1)


@pytest.mark.parametrize("hw", Q_EDGE_CASES)
def test_mg_down_up_q_edges(cuda, hw):
    """mg_down_q fused and split (both guesses) and mg_up_q (nu2 0 to 4, the
    Deep ring at 4, with and without the residual) on the edge domains."""
    h, w = hw
    hp2 = K.mg_geometry_q(h, w)[3]
    chp = K.mg_geometry_t((w - 1) // 2, (h - 1) // 2, wp_min=hp2)[1]
    rng = np.random.default_rng(h * w + 17)
    g, u = _q_planes(rng, h, w), _q_planes(rng, h, w, 10.0)
    ee, eo = _q_corr(rng, h, w)
    gd, ud, eed, eod = (x.to(cuda) for x in (g, u, ee, eo))
    for nu1 in (1, 2):
        for guess, guess_d in ((None, None), (u, ud)):
            for rows in (chp, None):
                want = K.mg_down_q_plain(guess, g, nu1, h, w, rows)
                got = K.mg_down_q(guess_d, gd, nu1, h, w, rows)
                torch.cuda.synchronize()
                assert all(torch.equal(a.cpu(), b) for a, b in zip(got, want)), (nu1, rows)
    for nu2 in range(5):
        for with_residual in (False, True):
            want = K.mg_up_q_plain(u, g, ee, eo, nu2, h, w, with_residual)
            got = K.mg_up_q(ud, gd, eed, eod, nu2, h, w, with_residual)
            torch.cuda.synchronize()
            got, want = (got, want) if with_residual else ((got,), (want,))
            assert all(torch.equal(a.cpu(), b) for a, b in zip(got, want)), nu2


# (h, w, beta, slab): beta != 1 on either axis, even / odd h, a level of
# one tile, e_rows past hp / 2, the exact-size entry (an odd width, the
# slab padded to an even height), and the 8K "q" chain's three coarse levels
UP_EDGE_CASES = [
    (70, 200, (1.0, 2.0), "padded"),
    (129, 257, (2.0, 1.0), "padded"),
    (20, 30, (1.5, 1.5), "padded"),
    (134, 99, (1.9375, 1.4375), "more e rows"),
    (41, 57, (1.5, 0.5), "exact"),
    (698, 949, (1.75, 1.25), "exact"),
] + [(h, w, (bh, bw), "8K coarse") for h, w, bh, bw, _ in TM.q_coarse_levels(2798, 3798)]


@pytest.mark.parametrize("case", UP_EDGE_CASES)
def test_mg_up_edges(cuda, case):
    h, w, (bh, bw), kind = case
    if kind == "exact":
        hp, wp, e_rows = h + h % 2, w, (h + h % 2) // 2
    else:
        _, hp, wp, e_rows = K.mg_geometry_t(h, w)
        e_rows += 5 if kind == "more e rows" else 0
    rng = np.random.default_rng(h * w + 19)
    u = torch.zeros((3, hp, wp))
    g = torch.zeros((3, hp, wp))
    e = torch.zeros((3, e_rows, wp))
    u[:, :h, :w] = torch.from_numpy(rng.normal(size=(3, h, w)).astype(np.float32) * 10)
    g[:, :h, :w] = torch.from_numpy(rng.normal(size=(3, h, w)).astype(np.float32) * 50)
    e[:, : (h - 1) // 2] = torch.from_numpy(
        rng.normal(size=(3, (h - 1) // 2, wp)).astype(np.float32) * 5)
    ud, gd, ed = u.to(cuda), g.to(cuda), e.to(cuda)
    for nu2 in range(5):
        got = K.mg_up(ud, gd, ed, nu2, h, w, bh, bw)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), K.mg_up_plain(u, g, e, nu2, h, w, bh, bw)), nu2


@pytest.mark.parametrize("mode", ["cycles", "tol", "coarse tol", "warm start"])
def test_dense_solve_on_card_matches_cpu(cuda, mode):
    """solve_multigrid on a dense (3, 518, 526) RHS, the quarter chain end to
    end on the card (to_quarters in, from_quarters out; the check-first loop
    at tol 0.05; u0 split by a second to_quarters): the same cycles as the
    CPU run and the same result up to the coarsest level's GEMM summation
    order."""
    rng = np.random.default_rng(5)
    g = torch.from_numpy(rng.normal(size=(3, 518, 526)).astype(np.float32) * 50)
    kw = {"cycles": dict(cycles=2), "tol": dict(tol=1e-4), "coarse tol": dict(tol=0.05),
          "warm start": dict(tol=1e-4)}[mode]
    if mode == "warm start":
        kw["u0"] = TM.solve_multigrid(g, padded="q", use_pallas=True, tol=0.05)
    want, winfo = TM.solve_multigrid(g, padded="q", use_pallas=True, return_info=True, **kw)
    K.reset_launches()
    got, info = TM.solve_multigrid(g.to(cuda), padded="q", use_pallas=True, return_info=True,
                                   **{k: v.to(cuda) if k == "u0" else v for k, v in kw.items()})
    torch.cuda.synchronize()
    assert K.LAUNCHES["to_quarters"] == (2 if mode == "warm start" else 1)
    assert K.LAUNCHES["from_quarters"] == 1
    assert info["cycles"] == winfo["cycles"]
    rel = (got.cpu() - want).abs().max().item() / want.abs().max().item()
    assert rel <= (1e-5 if mode == "cycles" else 5e-5)
    if mode != "cycles":
        assert info["residual"] <= kw["tol"] * g.abs().max().item()


def test_serve_mg_q_coarse_tol_counts(cuda):
    """tol 0.05, no check-free cycle: per cycle the split mg_down_q,
    mg_restrict_tq, the coarse level's two kernels, mg_prolong_tq and
    mg_up_q with its residual; no mg_ud_q; the card within 1 of the CPU."""
    rng = np.random.default_rng(2)
    src = _u8(rng, (520, 528, 3))
    dst = _u8(rng, (580, 600, 3))
    mask = np.full((520, 528), 255, np.uint8)
    cfg = CloneConfig(solver="multigrid", tol=0.05)
    K.reset_launches()
    out = SeamlessClone(cfg, device=cuda).run(src, dst, mask, (300, 290)).cpu().numpy()
    torch.cuda.synchronize()
    n = K.LAUNCHES["mg_up_q"]
    assert n >= 1
    assert K.LAUNCHES == _per_frame(
        erode3=1, preprocess_rhs_q=1, clamp_cast_paste_q=1, prep_mask=1,
        **{k: n for k in ("mg_down_q", "mg_restrict_tq", "mg_prolong_tq", "mg_up_q",
                          "mg_down_t", "mg_up_t")})
    want = SeamlessClone(cfg, device="cpu").run(src, dst, mask, (300, 290)).numpy()
    assert np.abs(out.astype(np.int16) - want).max() <= 1


# ---------------------------------------------------------------------------
# slice 4a: rb_sweeps, postprocess_transposed, the jacobi / dst_fft engines
# and the routes the two use_pallas_* fields select
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [1, 2, 3, 4, 6, 9])
@pytest.mark.parametrize("shape", [(1, 1, 1), (2, 30, 61), (3, 97, 131), (1, 64, 128)])
def test_rb_sweeps_matches_plain(cuda, shape, k):
    """Bit-exact against k redblack_sweep calls: odd and even sides, tiles
    cut by the edge, ceil(k / 4) launches ping-ponging between buffers; the
    input is not written."""
    rng = np.random.default_rng(k + shape[1])
    u = torch.from_numpy(rng.normal(size=shape).astype(np.float32) * 10)
    g = torch.from_numpy(rng.normal(size=shape).astype(np.float32) * 50)
    ud, gd = u.to(cuda), g.to(cuda)
    K.reset_launches()
    got = K.rb_sweeps(ud, gd, k)
    torch.cuda.synchronize()
    assert K.LAUNCHES["rb_sweeps"] == -(-k // 4)
    assert torch.equal(got.cpu(), K.rb_sweeps_plain(u, g, k))
    assert torch.equal(ud.cpu(), u)


@pytest.mark.parametrize("case", ["headline 4", "headline 50", "headline 1", "8K 4",
                                  "8K 3"])
def test_rb_sweeps_full_size(cuda, nan_outputs, case):
    """The headline jacobi burst on u, g (3, 1548, 2396): one 4-sweep launch,
    a 50-sweep burst (13 launches), one sweep; the 8K interior
    (3, 2798, 3798: 4-byte staging, scalar stores) at 4 and 3 sweeps. The
    twin runs on the card (the same f32 operations, bit-equal); outputs
    start as NaN."""
    where, k = case.split()
    k = int(k)
    shape = (3, 1548, 2396) if where == "headline" else (3, 2798, 3798)
    gen = torch.Generator(cuda).manual_seed(k)
    u = torch.randn(shape, generator=gen, device=cuda) * 10
    g = torch.randn(shape, generator=gen, device=cuda) * 50
    u0 = u.clone()
    K.reset_launches()
    got = K.rb_sweeps(u, g, k)
    torch.cuda.synchronize()
    assert K.LAUNCHES["rb_sweeps"] == -(-k // 4)
    assert torch.equal(got, K.rb_sweeps_plain(u, g, k))
    assert torch.equal(u, u0)


@pytest.mark.parametrize("planar", [True, False])
@pytest.mark.parametrize("hw", [(64, 90), (64, 127), (64, 256), (150, 260), (3, 3), (66, 300),
                                (6, 3), (39, 517), (1550, 2398), (1549, 2398)])
def test_postprocess_transposed_matches_plain(cuda, planar, hw):
    """The interior of the ROI at 8 consecutive left offsets (every residue
    mod 8) and odd and even top offsets inside a planar or interleaved
    destination, bit-exact against the twin over the whole buffer: nothing
    else changes. ROI heights with h2 % 4 == 0 (the tiles: (66, 300),
    (150, 260), the headline (1550, 2398)) and != 0 (the ragged route), and
    u_t a view 4 bytes past a 16-byte boundary (the ragged route too)."""
    bh, bw = hw
    rng = np.random.default_rng(bh + bw)
    flat = torch.from_numpy(rng.uniform(-60.0, 320.0, 3 * (bw - 2) * (bh - 2) + 1)
                            .astype(np.float32))
    flat[torch.from_numpy(rng.random(flat.numel()) < 0.05)] = 254.9999
    base = torch.from_numpy(_u8(rng, (3, bh + 9, bw + 12) if planar else (bh + 9, bw + 12, 3)))
    flat_d = flat.to(cuda)
    for i, left in enumerate(range(4, 12)):
        top = 5 + i % 2
        for off in (0, 1) if i == 0 else (0,):
            u_t = flat[off : off + 3 * (bw - 2) * (bh - 2)].view(3, bw - 2, bh - 2)
            want = base.clone()
            K.postprocess_transposed_plain(u_t, want if planar else want.permute(2, 0, 1), top,
                                           left)
            got = base.to(cuda)
            K.reset_launches()
            K.postprocess_transposed(flat_d[off : off + u_t.numel()].view(u_t.shape),
                                     got if planar else got.permute(2, 0, 1), top, left)
            torch.cuda.synchronize()
            assert K.LAUNCHES["postprocess_transposed"] == 1
            assert torch.equal(got.cpu(), want), (left, off)


def test_solve_redblack_on_card_matches_plain_sweeps(cuda):
    """use_pallas=True (rb_sweeps bursts) against use_pallas=False (the plain
    sweeps, on the card too): bit-equal iterates and equal iterations."""
    rng = np.random.default_rng(3)
    g = torch.from_numpy(rng.normal(size=(3, 40, 56)).astype(np.float32) * 50).to(cuda)
    K.reset_launches()
    got, info = TJ.solve_redblack(g, tol=1e-5, max_iters=20000, return_info=True,
                                  use_pallas=True)
    torch.cuda.synchronize()
    want, winfo = TJ.solve_redblack(g, tol=1e-5, max_iters=20000, return_info=True)
    assert info["iterations"] == winfo["iterations"] > 0
    assert K.LAUNCHES["rb_sweeps"] == info["iterations"] // 50 * 13
    assert torch.equal(got, want)


def test_element_path_sweeps_on_card(cuda):
    """nu2 = 6 on (1, 512, 520): the element V-cycles, the fine ascent one
    rb_sweeps burst of 2 launches a cycle; the card's cycles equal the CPU's."""
    rng = np.random.default_rng(9)
    g = torch.from_numpy(rng.normal(size=(1, 512, 520)).astype(np.float32) * 50)
    want, winfo = TM.solve_multigrid(g, nu2=6, use_pallas=True, tol=1e-4, return_info=True)
    K.reset_launches()
    got, info = TM.solve_multigrid(g.to(cuda), nu2=6, use_pallas=True, tol=1e-4,
                                   return_info=True)
    torch.cuda.synchronize()
    assert info["cycles"] == winfo["cycles"] >= 2
    assert K.LAUNCHES == _per_frame(rb_sweeps=2 * info["cycles"])
    assert (got.cpu() - want).abs().max().item() <= 1e-5 * want.abs().max().item()


@pytest.mark.parametrize("cfg", [CloneConfig(solver="jacobi"), CloneConfig(solver="dst_fft"),
                                 CloneConfig(use_pallas_preprocess=False),
                                 CloneConfig(use_pallas_postprocess=False),
                                 CloneConfig(use_pallas_preprocess=False,
                                             use_pallas_postprocess=False)])
def test_new_routes_on_card_match_cpu(cuda, cfg):
    """Each new route on a 44 x 60 full-mask patch (interior 40 x 56): its
    kernels a frame, and the card within 1 of the CPU."""
    rng = np.random.default_rng(4)
    src = _u8(rng, (44, 60, 3))
    dst = _u8(rng, (100, 120, 3))
    mask = np.full((44, 60), 255, np.uint8)
    K.reset_launches()
    out = SeamlessClone(cfg, device=cuda).run(src, dst, mask, (60, 50)).cpu().numpy()
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    pre = {"erode3": 1, "preprocess_rhs_p": 1} if cfg.use_pallas_preprocess else {}
    if cfg.solver == "jacobi":
        assert launches["rb_sweeps"] % 13 == 0 and launches["rb_sweeps"] > 0
        pre["rb_sweeps"] = launches["rb_sweeps"]
    paste = ({"postprocess_transposed": 1} if cfg.use_pallas_postprocess
             and not cfg.use_pallas_preprocess and cfg.solver == "auto"
             else {"clamp_cast_paste": 1})
    assert launches == _per_frame(**pre, **paste, prep_mask=1)
    want = SeamlessClone(cfg, device="cpu").run(src, dst, mask, (60, 50)).numpy()
    assert np.abs(out.astype(np.int16) - want).max() <= 1


# ---------------------------------------------------------------------------
# slice 8a: rb_sweeps_tile, the element V-cycle's fused level, the tiled
# solvers and the tiled engine on a mesh of the one card
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [1, 2, 4, 5, 9])
@pytest.mark.parametrize("case", [
    ((3, 76, 140), (-6, -6), (128, 256)),      # a top-left tile: negative origin
    ((3, 76, 140), (58, 122), (128, 256)),     # a bottom-right tile, domain edge inside
    ((1, 21, 33), (17, -3), (30, 25)),         # odd origin, domain cutting the tile
    ((2, 9, 9), (3, 3), (5, 6)),               # smaller than a CUDA tile
    ((1, 40, 70), (100, 100), (50, 50)),       # wholly outside the domain: a copy
])
def test_rb_sweeps_tile_matches_plain(cuda, case, k):
    """Bit-exact against the select-form twin over the whole tile, ceil(k / 4)
    launches; the input is not written."""
    shape, origin, dom = case
    rng = np.random.default_rng(k + shape[1])
    u = torch.from_numpy(rng.normal(size=shape).astype(np.float32) * 10)
    g = torch.from_numpy(rng.normal(size=shape).astype(np.float32) * 50)
    ud, gd = u.to(cuda), g.to(cuda)
    K.reset_launches()
    got = K.rb_sweeps_tile(ud, gd, k, origin, dom)
    torch.cuda.synchronize()
    assert K.LAUNCHES["rb_sweeps_tile"] == -(-k // 4)
    assert torch.equal(got.cpu(), K.rb_sweeps_tile_plain(u, g, k, origin, dom))
    assert torch.equal(ud.cpu(), u)


DD_8K_TILE = (3, 1412, 1912)  # a 2x2 mesh over the 2798 x 3798 interior, 6-px band
DD_8K_ORIGINS = [(-6, -6), (-6, 1894), (1394, -6), (1394, 1894)]


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("origin", DD_8K_ORIGINS + [(1393, -5)])
def test_rb_sweeps_tile_8k_dd_tiles(cuda, nan_outputs, origin, k):
    """The 8K DD tiles at the four origins of a 2x2 mesh (even parity) and an
    odd one, the ascent's 1 and 2 sweeps (one launch); the twin on the
    card; outputs start as NaN."""
    gen = torch.Generator(cuda).manual_seed(origin[0] + origin[1] + k)
    u = torch.randn(DD_8K_TILE, generator=gen, device=cuda) * 10
    g = torch.randn(DD_8K_TILE, generator=gen, device=cuda) * 50
    K.reset_launches()
    got = K.rb_sweeps_tile(u, g, k, origin, (2798, 3798))
    torch.cuda.synchronize()
    assert K.LAUNCHES["rb_sweeps_tile"] == 1
    assert torch.equal(got, K.rb_sweeps_tile_plain(u, g, k, origin, (2798, 3798)))


@pytest.mark.parametrize("k", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("wl", [117, 118, 119, 120, 241])
def test_rb_sweeps_tile_widths_and_cuts(cuda, nan_outputs, wl, k):
    """Widths 4k .. 4k + 3 (16-byte and 4-byte staging), odd and even
    origins, the domain cutting the tile on each side and missing it."""
    rng = np.random.default_rng(wl + k)
    shape = (2, 75, wl)
    u = torch.from_numpy(rng.normal(size=shape).astype(np.float32) * 10)
    g = torch.from_numpy(rng.normal(size=shape).astype(np.float32) * 50)
    for origin, dom in (((-5, -3), (60, wl - 9)), ((7, 10), (70, 2 * wl)),
                        ((-1, 0), (200, 40)), ((100, 0), (50, 50))):
        K.reset_launches()
        got = K.rb_sweeps_tile(u.to(cuda), g.to(cuda), k, origin, dom)
        torch.cuda.synchronize()
        assert K.LAUNCHES["rb_sweeps_tile"] == -(-k // 4)
        assert torch.equal(got.cpu(), K.rb_sweeps_tile_plain(u, g, k, origin, dom))


def _bands(x: torch.Tensor, b: int) -> dict:
    """The four bands of b rows or columns of a ghosted tile, as views."""
    return {"top": x[:, :b], "bottom": x[:, -b:], "left": x[:, :, :b], "right": x[:, :, -b:]}


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("b", [6, 12, 24])
@pytest.mark.parametrize("tile_w", [112, 115])  # ghosted rows 16-byte aligned, and not
def test_rb_sweeps_tile_window_matches_plain(cuda, nan_outputs, tile_w, b, n):
    """The window form on the four bands of a ghosted (3, 90, tile_w + 8)
    tile, read where they lie: bit-exact against the twin on the same
    views at negative, odd and even origins, a domain that holds the band
    and one that clips it; ceil(n / 4) launches, all of the window form;
    nothing outside the window is read, and the tile is not written."""
    gen = torch.Generator(cuda).manual_seed(b * 10 + n + tile_w)
    x = torch.randn((3, 90, tile_w + 8), generator=gen, device=cuda) * 10
    gx = torch.randn((3, 90, tile_w + 8), generator=gen, device=cuda) * 50
    keep = x.clone()
    for origin, dom in (((-4, -4), (400, 400)), ((-3, 36), (40, 60)), ((81, -5), (86, 100)),
                        ((10, 11), (2000, 2000))):
        for name, view in _bands(x, b).items():
            gv = _bands(gx, b)[name]
            assert not view.is_contiguous()
            K.reset_launches()
            got = K.rb_sweeps_tile(view, gv, n, origin, dom)
            torch.cuda.synchronize()
            assert K.LAUNCHES["rb_sweeps_tile"] == K.WINDOW_LAUNCHES["rb_sweeps_tile"] == -(-n // 4)
            want = K.rb_sweeps_tile_plain(view, gv, n, origin, dom)
            assert torch.equal(got, want), (name, origin, dom)
            # what lies outside the window does not matter
            y, gy = torch.full_like(x, float("nan")), torch.full_like(gx, float("nan"))
            _bands(y, b)[name].copy_(view)
            _bands(gy, b)[name].copy_(gv)
            assert torch.equal(K.rb_sweeps_tile(_bands(y, b)[name], _bands(gy, b)[name], n,
                                                origin, dom), want)
    assert torch.equal(x, keep)


@pytest.mark.parametrize("halo", [2, 4, 8, 10])
def test_redblack_tiled_overlap_on_card(cuda, halo):
    """solve_redblack_tiled(overlap=True) on the 2x2 mesh of the card,
    tiles 49x83 and a padded true_hw, tol 0: bit-equal to overlap=False on
    the card and to overlap=True on the CPU mesh; rb_sweeps_tile rounds x
    4 tiles x 5 x ceil(s / 4) launches, four fifths of them the window
    form (halo 10: two launches a region)."""
    from seamlesscloneoptimization_tpu_torch.parallel import make_tile_mesh, solve_redblack_tiled

    rng = np.random.default_rng(halo)
    g = np.zeros((3, 98, 166), np.float32)
    g[:, :95, :160] = rng.normal(size=(3, 95, 160)) * 50
    g = torch.from_numpy(g)
    s = halo // 2
    kw = dict(true_hw=(95, 160), tol=0.0, max_iters=40, halo=halo, return_info=True)
    K.reset_launches()
    got, info = solve_redblack_tiled(g.to(cuda), _card_mesh(cuda), overlap=True, **kw)
    torch.cuda.synchronize()
    rounds = info["iterations"] // s
    per = 4 * -(-s // 4)
    assert K.LAUNCHES == _per_frame(rb_sweeps_tile=rounds * 5 * per)
    assert K.WINDOW_LAUNCHES["rb_sweeps_tile"] == rounds * 4 * per
    plain, info_p = solve_redblack_tiled(g.to(cuda), _card_mesh(cuda), overlap=False, **kw)
    assert info_p["iterations"] == info["iterations"] and torch.equal(got, plain)
    cpu = make_tile_mesh([torch.device("cpu")] * 4, (2, 2))
    assert torch.equal(got.cpu(), solve_redblack_tiled(g, cpu, overlap=True, **kw)[0])


@pytest.mark.parametrize("hw,beta", [((21, 33), (1.0, 1.0)), ((20, 34), (1.0, 1.0)),
                                     ((513, 700), (1.0, 1.0)), ((40, 57), (1.5, 0.5))])
def test_exact_size_level_matches_plain(cuda, hw, beta):
    """The element V-cycle's fused level: an exact-size level padded to an
    even height, mg_down (given and known-zero guess) and mg_up bit-exact
    against their twins."""
    (h, w), (bh, bw) = hw, beta
    rng = np.random.default_rng(h)
    slab = (2, h + h % 2, w)
    g = torch.zeros(slab)
    u = torch.zeros(slab)
    g[:, :h] = torch.from_numpy(rng.normal(size=(2, h, w)).astype(np.float32) * 50)
    u[:, :h] = torch.from_numpy(rng.normal(size=(2, h, w)).astype(np.float32) * 10)
    e = torch.zeros((2, slab[1] // 2, w))
    e[:, : (h - 1) // 2] = torch.from_numpy(
        rng.normal(size=(2, (h - 1) // 2, w)).astype(np.float32) * 5)
    for guess in (u, None):
        got = K.mg_down(None if guess is None else guess.to(cuda), g.to(cuda), 1, h, w, bh, bw)
        want = K.mg_down_plain(guess, g, 1, h, w, bh, bw)
        torch.cuda.synchronize()
        assert all(torch.equal(a.cpu(), b) for a, b in zip(got, want))
    got = K.mg_up(u.to(cuda), g.to(cuda), e.to(cuda), 2, h, w, bh, bw)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), K.mg_up_plain(u, g, e, 2, h, w, bh, bw))


def test_unpadded_solve_on_card_matches_cpu(cuda):
    """solve_multigrid(padded=False) on (1, 512, 520): the fused fine level
    once a cycle (mg_down and mg_up), the card's cycles equal the CPU's."""
    rng = np.random.default_rng(10)
    g = torch.from_numpy(rng.normal(size=(1, 512, 520)).astype(np.float32) * 50)
    want, winfo = TM.solve_multigrid(g, use_pallas=True, padded=False, tol=1e-4,
                                     return_info=True)
    K.reset_launches()
    got, info = TM.solve_multigrid(g.to(cuda), use_pallas=True, padded=False, tol=1e-4,
                                   return_info=True)
    torch.cuda.synchronize()
    assert info["cycles"] == winfo["cycles"] >= 2
    assert K.LAUNCHES == _per_frame(mg_down=info["cycles"], mg_up=info["cycles"])
    assert (got.cpu() - want).abs().max().item() <= 1e-5 * want.abs().max().item()


def _card_mesh(cuda, n=4):
    from seamlesscloneoptimization_tpu_torch.parallel import make_tile_mesh

    return make_tile_mesh([cuda] * n, (2, n // 2))


def test_tiled_solvers_on_card_match_cpu(cuda):
    """On a 2x2 mesh of the one card: solve_redblack_tiled at a fixed sweep
    count bit-equal to the CPU mesh's (rounds x tiles launches), and the DD
    multigrid within rel 1e-5 of it with equal cycles (2 rb_sweeps_tile
    launches a tile a cycle)."""
    from seamlesscloneoptimization_tpu_torch.parallel import (
        make_tile_mesh,
        solve_multigrid_dd,
        solve_redblack_tiled,
    )

    cpu = make_tile_mesh([torch.device("cpu")] * 4, (2, 2))
    rng = np.random.default_rng(11)
    g = torch.from_numpy(rng.normal(size=(3, 64, 96)).astype(np.float32) * 50)
    K.reset_launches()
    got = solve_redblack_tiled(g.to(cuda), _card_mesh(cuda), tol=0.0, max_iters=100)
    torch.cuda.synchronize()
    assert K.LAUNCHES == _per_frame(rb_sweeps_tile=50 * 4)  # 2 sweeps a round, 100 sweeps
    assert torch.equal(got.cpu(), solve_redblack_tiled(g, cpu, tol=0.0, max_iters=100))
    want, winfo = solve_multigrid_dd(g, cpu, true_hw=(61, 90), tol=1e-5, return_info=True)
    K.reset_launches()
    got, info = solve_multigrid_dd(g.to(cuda), _card_mesh(cuda), true_hw=(61, 90), tol=1e-5,
                                   return_info=True)
    torch.cuda.synchronize()
    assert info["cycles"] == winfo["cycles"] >= 2
    assert K.LAUNCHES == _per_frame(rb_sweeps_tile=2 * 4 * info["cycles"])
    assert (got.cpu() - want).abs().max().item() <= 1e-5 * want.abs().max().item()


def test_tiled_engine_on_card_matches_cpu(cuda):
    """TiledSeamlessClone on a 2x2 mesh of the card against the CPU mesh
    (diff_max <= 1, clamp_cast_paste once a tile, 2 rb_sweeps_tile a tile a
    cycle),
    and the 1x1 mesh byte for byte the single-device engine."""
    from seamlesscloneoptimization_tpu_torch.parallel import TiledSeamlessClone, make_tile_mesh

    rng = np.random.default_rng(12)
    src = _u8(rng, (90, 130, 3))
    dst = _u8(rng, (120, 200, 3))
    mask = np.full((90, 130), 255, np.uint8)
    cfg = CloneConfig(mg_cycles=3)
    K.reset_launches()
    out = TiledSeamlessClone(cfg, mesh=_card_mesh(cuda)).run(src, dst, mask, (100, 60))
    torch.cuda.synchronize()
    assert K.LAUNCHES == _per_frame(clamp_cast_paste=4, rb_sweeps_tile=2 * 4 * 3)
    cpu = TiledSeamlessClone(cfg, mesh=make_tile_mesh([torch.device("cpu")] * 4, (2, 2)))
    want = cpu.run(src, dst, mask, (100, 60)).numpy()
    assert np.abs(out.cpu().numpy().astype(np.int16) - want).max() <= 1
    one = TiledSeamlessClone(CloneConfig(), mesh=make_tile_mesh([cuda], (1, 1)))
    assert torch.equal(one.run(src, dst, mask, (100, 60)),
                       SeamlessClone(CloneConfig(), device=cuda).run(src, dst, mask, (100, 60)))


# mg_geometry's slabs (the dense rounded chain, vcycle_p): th 160 up to wp
# 2560 (hp a multiple of 160), 128 above; each the fine level or a coarse
# level (betas from _coarsen) of the headline and 8K dense chains
DENSE_LEVELS = [((512, 520), (1.0, 1.0)), ((1548, 2396), (1.0, 1.0)),
                ((773, 1197), (1.5, 1.5)), ((2798, 3798), (1.0, 1.0)),
                ((1398, 1898), (1.5, 1.5)), ((698, 948), (1.75, 1.75))]


@pytest.mark.parametrize("hw,beta", DENSE_LEVELS)
def test_mg_level_on_mg_geometry_slabs(cuda, nan_outputs, hw, beta):
    """mg_down (nu1 0-2, given and known-zero guess) and mg_up (nu2 0, 2,
    4) on mg_geometry's slab, bit-exact against their twins over the whole
    outputs."""
    (h, w), (bh, bw) = hw, beta
    th, hp, wp = K.mg_geometry(h, w)
    assert hp % th == 0 and th in (128, 160) and hp % 2 == 0
    rng = np.random.default_rng(h + 7 * w)
    g = _level_slab(rng, h, w, hp, wp)
    u = _level_slab(rng, h, w, hp, wp, 10.0)
    e = _level_slab(rng, (h - 1) // 2, w, hp // 2, wp, 5.0)
    g_c, u_c, e_c = g.to(cuda), u.to(cuda), e.to(cuda)
    for nu1 in (0, 1, 2):
        for guess in (u, None):
            got = K.mg_down(None if guess is None else u_c, g_c, nu1, h, w, bh, bw)
            want = K.mg_down_plain(guess, g, nu1, h, w, bh, bw)
            torch.cuda.synchronize()
            assert all(torch.equal(a.cpu(), b) for a, b in zip(got, want)), (nu1, guess is None)
    for nu2 in (0, 2, 4):
        got = K.mg_up(u_c, g_c, e_c, nu2, h, w, bh, bw)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), K.mg_up_plain(u, g, e, nu2, h, w, bh, bw)), nu2


def test_dense_solve_on_card(cuda):
    """solve_multigrid(padded=True) on (1, 512, 520): one fused level (mg_down
    and mg_up once a cycle), bit-equal to padded=False on the card, the
    CPU's cycles, rel 1e-5; "q" with nu1 = 0 the same chain; fmg_start and
    pcg with the CPU's cycles and iterations."""
    rng = np.random.default_rng(13)
    g = torch.from_numpy(rng.normal(size=(1, 512, 520)).astype(np.float32) * 50)
    g_c = g.to(cuda)
    want, winfo = TM.solve_multigrid(g, use_pallas=True, padded=True, return_info=True)
    K.reset_launches()
    got, info = TM.solve_multigrid(g_c, use_pallas=True, padded=True, return_info=True)
    torch.cuda.synchronize()
    assert info["cycles"] == winfo["cycles"] >= 2
    assert K.LAUNCHES == _per_frame(mg_down=info["cycles"], mg_up=info["cycles"])
    assert (got.cpu() - want).abs().max().item() <= 1e-5 * want.abs().max().item()
    unp = TM.solve_multigrid(g_c, use_pallas=True, padded=False, return_info=True)
    assert torch.equal(unp[0], got) and unp[1] == info
    nu0 = TM.solve_multigrid(g_c, use_pallas=True, padded="q", nu1=0, cycles=2)
    assert torch.equal(nu0, TM.solve_multigrid(g_c, use_pallas=True, padded=True, nu1=0,
                                               cycles=2))
    for kw in ({"fmg_start": True, "padded": True}, {"fmg_start": True, "padded": "q"},
               {"pcg": True}):
        want, winfo = TM.solve_multigrid(g, use_pallas=True, return_info=True, **kw)
        got, info = TM.solve_multigrid(g_c, use_pallas=True, return_info=True, **kw)
        assert info["cycles"] == winfo["cycles"], kw
        assert (got.cpu() - want).abs().max().item() <= 5e-5 * want.abs().max().item(), kw


@pytest.mark.parametrize("mode", ["bf16", "2x_img", "2x_v"])
def test_precision_gemm_route_matches_cpu(cuda, mode):
    """The card's bf16 GEMM (one cuBLAS bf16 GEMM with an FP32 output a
    pass) against the CPU route (the widened operands' FP32 product), on the
    headline pair chain's first GEMM: relative 1e-5 of max |out|."""
    from seamlesscloneoptimization_tpu_torch.solvers import dst_gemm as TD

    rng = np.random.default_rng(14)
    a = torch.from_numpy(rng.normal(size=(3, 2432, 896)).astype(np.float32) * 50)
    v = torch.from_numpy(np.array(TD.dst_matrices_folded(1548)[0]))
    want = TD._mm(a, v, TD._split_bf16(v), mode)
    v_c = v.to(cuda)
    got = TD._mm(a.to(cuda), v_c, TD._split_bf16(v_c), mode)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert (got.cpu() - want).abs().max().item() <= 1e-5 * want.abs().max().item()


@pytest.mark.parametrize("precision", ["default", "2x_img", "2x_v", "fwd2x", "inv2x"])
def test_precision_engine_on_card(cuda, precision):
    """The pair-chain frame in each bf16 mode on the card: the same kernels
    a frame as in FP32, the image within 1 of the CPU path's in the same
    mode."""
    rng = np.random.default_rng(15)
    src = _u8(rng, (300, 400, 3))
    dst = _u8(rng, (360, 480, 3))
    mask = np.full((300, 400), 255, np.uint8)
    cfg = CloneConfig(precision=precision)
    K.reset_launches()
    out = SeamlessClone(cfg, device=cuda).run(src, dst, mask, (240, 180))
    torch.cuda.synchronize()
    assert K.LAUNCHES == _per_frame(erode3=1, preprocess_rhs_t=1, fold_minor=2,
                                    transpose_pair=3, unfold_transpose=2,
                                    unfold_clamp_paste=1, prep_mask=1)
    want = SeamlessClone(cfg, device="cpu").run(src, dst, mask, (240, 180)).numpy()
    assert np.abs(out.cpu().numpy().astype(np.int16) - want).max() <= 1


# ---------------------------------------------------------------------------
# slice 5: bucketed serving (the runtime-domain multigrid, bucket_exact and
# the grown bucket)
# ---------------------------------------------------------------------------


def test_dyn_solve_kernel_route_matches_twins_on_card(cuda, monkeypatch):
    """solve_multigrid_dyn on a 520 x 524 domain of a (3, 600, 640) grid at
    tol 1e-4: its fused fine level (272 480 points) is mg_down and mg_up once
    a cycle; the same solve with the two wrappers swapped for their twins,
    on the card, runs as many cycles to relative 1e-5."""
    from seamlesscloneoptimization_tpu_torch.solvers import solve_multigrid_dyn

    rng = np.random.default_rng(16)
    g = torch.from_numpy(rng.normal(size=(3, 600, 640)).astype(np.float32) * 50).to(cuda)
    K.reset_launches()
    got, info = solve_multigrid_dyn(g, (520, 524), tol=1e-4, return_info=True)
    torch.cuda.synchronize()
    assert K.LAUNCHES == _per_frame(mg_down=info["cycles"], mg_up=info["cycles"])
    monkeypatch.setattr(K, "mg_down", K.mg_down_plain)
    monkeypatch.setattr(K, "mg_up", K.mg_up_plain)
    want, winfo = solve_multigrid_dyn(g, (520, 524), tol=1e-4, return_info=True)
    assert info["cycles"] == winfo["cycles"] >= 2
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()
    assert got[:, 520:].abs().max().item() == 0.0 and got[:, :, 524:].abs().max().item() == 0.0


def _ellipse_mask(hw, bbox_hw):
    ry, rx = (bbox_hw[0] - 1) // 2, (bbox_hw[1] - 1) // 2
    yy, xx = np.mgrid[: hw[0], : hw[1]]
    inside = ((yy - hw[0] // 2) / ry) ** 2 + ((xx - hw[1] // 2) / rx) ** 2 <= 1
    return inside.astype(np.uint8) * 255


@pytest.mark.parametrize("flags", [1, 2, 3])
@pytest.mark.parametrize("exact", [False, True])
def test_bucket_engine_on_card_matches_cpu(cuda, exact, flags):
    """bbox_bucket=128 on a 521 x 601 ellipse (bucket 640 x 640), NORMAL,
    MIXED and MONOCHROME: the grown bucket runs the pair chain on the
    bucket, bucket_exact the tight system (erode3, preprocess_rhs_p and
    clamp_cast_paste once, mg_down / mg_up once a cycle on its one fused
    level); the card within 1 of the CPU, and a served frame equal to run()
    on the card."""
    rng = np.random.default_rng(17)
    src = _u8(rng, (700, 800, 3))
    dst = _u8(rng, (800, 900, 3))
    mask = _ellipse_mask((700, 800), (521, 601))
    cfg = CloneConfig(bbox_bucket=128, bucket_exact=exact, flags=flags)
    eng = SeamlessClone(cfg, device=cuda)
    K.reset_launches()
    out = eng.run(src, dst, mask, (450, 400)).cpu().numpy()
    torch.cuda.synchronize()
    assert eng.metrics["bbox"][2:] == (640, 640)
    if exact:
        n = K.LAUNCHES["mg_down"]
        assert n >= 2 and K.LAUNCHES == _per_frame(erode3=1, preprocess_rhs_p=1,
                                                   clamp_cast_paste=1, mg_down=n, mg_up=n,
                                                   prep_mask=1)
    else:
        assert K.LAUNCHES == _per_frame(erode3=1, preprocess_rhs_t=1, fold_minor=2,
                                        transpose_pair=3, unfold_transpose=2,
                                        unfold_clamp_paste=1, prep_mask=1)
    want = SeamlessClone(cfg, device="cpu").run(src, dst, mask, (450, 400)).numpy()
    assert np.abs(out.astype(np.int16) - want).max() <= 1
    served, _ = eng.timed_serve(src, dst, mask, (450, 400), loops=0)
    assert np.array_equal(served.cpu().numpy(), out)


def test_engine_profile_and_destroy_on_card(cuda, tmp_path):
    """profile() on the card writes a Chrome trace that holds the port's
    kernels; destroy() leaves the engine holding no device tensor."""
    import json

    rng = np.random.default_rng(18)
    src = _u8(rng, (44, 60, 3))
    dst = _u8(rng, (100, 120, 3))
    mask = np.full((44, 60), 255, np.uint8)
    eng = SeamlessClone(device=cuda)
    eng.run(src, dst, mask, (60, 50))
    with eng.profile(str(tmp_path)) as d:
        eng.run(src, dst, mask, (60, 50))
    (trace,) = list(tmp_path.glob("trace_*.json"))
    names = {str(e.get("name", "")) for e in json.loads(trace.read_text())["traceEvents"]}
    assert d == str(tmp_path) and any("erode3_kernel" in n for n in names)
    assert eng.device_memory_bytes() > 0
    eng.destroy()
    assert eng.device_memory_bytes() == 0


# ---------------------------------------------------------------------------
# slice 6: the batch and the edits
# ---------------------------------------------------------------------------


def test_clamp_cast_paste_on_a_job_stack(cuda, nan_outputs):
    """The batch step's one paste: a (192, 126, 126) solution, 64 jobs x 3
    channels, into the gathered (192, 128, 128) u8 stack at (1, 1),
    bit-exact against the twin, the ring untouched."""
    rng = np.random.default_rng(19)
    u = torch.from_numpy(rng.uniform(-40, 300, (192, 126, 126)).astype(np.float32))
    dst = torch.from_numpy(_u8(rng, (192, 128, 128)))
    K.reset_launches()
    got = K.clamp_cast_paste(u.to(cuda), dst.to(cuda), 1, 1, 126, 126)
    torch.cuda.synchronize()
    assert K.LAUNCHES["clamp_cast_paste"] == 1
    want = K.clamp_cast_paste_plain(u, dst.clone(), 1, 1, 126, 126)
    assert torch.equal(got.cpu(), want)
    assert torch.equal(want[:, 0], dst[:, 0]) and torch.equal(want[:, :, -1], dst[:, :, -1])


def _batch_jobs(rng, n, sizes):
    """n seeded jobs on a grid without overlap in a 400 x 640 destination."""
    dst = _u8(rng, (400, 640, 3))
    srcs, masks, centers = [], [], []
    for i in range(n):
        hw = sizes[i % len(sizes)]
        srcs.append(_u8(rng, (hw[0] + 8, hw[1] + 8, 3)))
        masks.append(_ellipse_mask((hw[0] + 8, hw[1] + 8), hw))
        centers.append((70 + 125 * (i % 5), 70 + 130 * (i // 5)))
    return dst, srcs, masks, centers


@pytest.mark.parametrize("route", ["plain", "kernels", "pad_exact"])
def test_batch_on_card_matches_cpu(cuda, route):
    """seamless_clone_batch_fused on 10 jobs: one group of one shape (plain
    RHS, or the per-job erode3 + preprocess_rhs_p kernels; clamp_cast_paste
    once), or mixed sizes in one pad_exact bucket (each job's tight system:
    erode3, preprocess_rhs_p, clamp_cast_paste once a job); card within 1
    of the CPU."""
    from seamlesscloneoptimization_tpu_torch.parallel import seamless_clone_batch_fused

    rng = np.random.default_rng(20)
    sizes = [(101, 101)] if route != "pad_exact" else [(101, 101), (87, 95), (64, 110)]
    dst, srcs, masks, centers = _batch_jobs(rng, 10, sizes)
    kw = dict(bucket="pad_exact", tol=1e-6) if route == "pad_exact" else dict(
        use_pallas=route == "kernels")
    K.reset_launches()
    out = seamless_clone_batch_fused(dst, srcs, masks, centers, **kw, device=cuda)
    per_job = 10 if route != "plain" else 0
    assert K.LAUNCHES["erode3"] == K.LAUNCHES["preprocess_rhs_p"] == per_job
    assert K.LAUNCHES["clamp_cast_paste"] == (10 if route == "pad_exact" else 1)
    want = seamless_clone_batch_fused(dst, srcs, masks, centers, **kw, device="cpu")
    assert np.abs(out.astype(np.int16) - want).max() <= 1 and not np.array_equal(out, dst)


@pytest.mark.parametrize("kind", ["color", "illumination", "texture"])
def test_edits_1080p_on_card_match_cpu(cuda, kind):
    """The 1080p edits (the direct DST-GEMM route, clamp_cast_paste once):
    card within 1 of the CPU."""
    from seamlesscloneoptimization_tpu_torch import api

    rng = np.random.default_rng(21)
    src = np.clip(np.kron(_u8(rng, (23, 41, 3)), np.ones((48, 48, 1)))[:1080, :1920]
                  + rng.normal(0, 6, (1080, 1920, 3)), 0, 255).astype(np.uint8)
    mask = _ellipse_mask((1080, 1920), (601, 901))
    fn, args = {"color": (api.color_change, (1.7, 0.6, 1.2)),
                "illumination": (api.illumination_change, (0.2, 0.4)),
                "texture": (api.texture_flattening, (30, 45, 3))}[kind]
    K.reset_launches()
    out = fn(src, mask, *args, device=cuda)
    assert K.LAUNCHES == _per_frame(clamp_cast_paste=1)
    want = fn(src, mask, *args, device="cpu")
    assert np.abs(out.astype(np.int16) - want).max() <= 1 and not np.array_equal(out, src)


def _cli_images(rng):
    """A 200 x 300 full-mask patch into a 400 x 600 destination: both
    interior sides above 128, the folded pair chain."""
    return _u8(rng, (200, 300, 3)), _u8(rng, (400, 600, 3)), np.full((200, 300), 255, np.uint8)


def test_cli_on_card_equals_engine(cuda, tmp_path, capsys):
    """The CLI on cuda:0 (one warm-up and 2 timed runs: the pair chain's
    kernels and prep_mask 3 times each), its BMP and result.yml bit-equal to the engine's
    run on the card, within 1 of the CPU path."""
    from seamlesscloneoptimization_tpu_torch import native
    from seamlesscloneoptimization_tpu_torch.cli import main

    src, dst, mask = _cli_images(np.random.default_rng(30))
    for name, a in (("src", src), ("dst", dst), ("mask", mask)):
        native.write_yaml_mat(tmp_path / f"{name}.yml", a, name=name)
    K.reset_launches()
    assert main([str(tmp_path / "src.yml"), str(tmp_path / "dst.yml"),
                 str(tmp_path / "mask.yml"), "300", "200", "0", "--loops", "2",
                 "--output-dir", str(tmp_path / "out")]) == 0
    torch.cuda.synchronize()
    assert K.LAUNCHES == {k: 3 * v for k, v in PAIR_CHAIN.items()} | {"prep_mask": 3}
    assert "patch size=298x198" in capsys.readouterr().out  # the bbox inside the zeroed frame
    image = native.read_bmp(tmp_path / "out" / "ucRGB_Output.bmp")
    want = SeamlessClone(CloneConfig(), device=cuda).run(src, dst, mask, (300, 200)).cpu().numpy()
    assert np.array_equal(image, want)
    assert np.array_equal(native.read_yaml_mat(tmp_path / "out" / "result.yml"), want)
    cpu = SeamlessClone(CloneConfig(), device="cpu").run(src, dst, mask, (300, 200)).numpy()
    assert np.abs(image.astype(np.int16) - cpu).max() <= 1


def test_capi_on_card_equals_engine(cuda, tmp_path):
    """The C ABI program on cuda:0 (the second run from another pthread):
    both outputs bit-equal to the engine's run on the card."""
    import os
    import subprocess

    from seamlesscloneoptimization_tpu_torch import capi_host

    src, dst, mask = _cli_images(np.random.default_rng(31))
    for name, a in (("face", src), ("body", dst), ("mask", mask)):
        a.tofile(tmp_path / f"{name}.raw")
    prog = capi_host.build_test_program()
    r = subprocess.run([str(prog), str(tmp_path / "face.raw"), "200", "300",
                        str(tmp_path / "body.raw"), "400", "600", str(tmp_path / "mask.raw"),
                        "300", "200", "0", "", str(tmp_path / "o1.raw"), str(tmp_path / "o2.raw")],
                       capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, SC_TPU_PYTHONPATH=capi_host.embedded_path()))
    assert r.returncode == 0, r.stdout + r.stderr
    want = SeamlessClone(CloneConfig(), device=cuda).run(src, dst, mask, (300, 200)).cpu().numpy()
    for out in ("o1.raw", "o2.raw"):
        assert np.array_equal(np.fromfile(tmp_path / out, np.uint8).reshape(want.shape), want)


# slice 8: solve_multigrid_sharded (the partitioned element V-cycle) and
# path="gspmd" on a mesh of the one card; two processes on the card


@pytest.mark.parametrize("shape", [(2, 2), (1, 3)])
def test_sharded_solve_on_card_bit_equal(cuda, shape, monkeypatch):
    """Three partitioned levels over CUDA tiles: u bit-equal to the card's
    single-device element solve, equal cycles (tolerance and fixed), and
    within the solves' bars of the CPU mesh's; rb_sweeps_tile 2 launches a
    tile a cycle on the plain level, nothing else."""
    from seamlesscloneoptimization_tpu_torch.parallel import (
        make_tile_mesh,
        solve_multigrid_sharded,
        tiled,
    )

    monkeypatch.setattr(tiled, "SHARD_MIN", 16)
    n = shape[0] * shape[1]
    rng = np.random.default_rng(41)
    g = torch.from_numpy(rng.normal(size=(3, 300, 421)).astype(np.float32) * 30)
    for cycles in (None, 3):
        want, winfo = TM.solve_multigrid(g.to(cuda), cycles=cycles, use_pallas=False,
                                         return_info=True)
        K.reset_launches()
        got, info = solve_multigrid_sharded(g.to(cuda), make_tile_mesh([cuda] * n, shape),
                                            cycles=cycles, return_info=True)
        torch.cuda.synchronize()
        assert torch.equal(got, want) and info == winfo
        assert K.LAUNCHES == _per_frame(rb_sweeps_tile=2 * n * info["cycles"])
        cpu = solve_multigrid_sharded(g, make_tile_mesh([torch.device("cpu")] * n, shape),
                                      cycles=cycles)
        # the coarsest level's GEMMs sum in another order on the CPU, and a
        # multi-cycle solve moves by up to 1.7e-5 under a one-ulp change
        # (ROADMAP §3): 5e-5 (measured 1.46e-5 after 3 cycles)
        assert (got.cpu() - cpu).abs().max().item() <= 5e-5 * cpu.abs().max().item()


def test_gspmd_engine_on_card_matches_cpu(cuda, monkeypatch):
    """TiledSeamlessClone(path="gspmd") on a 2x2 mesh of the card against the
    CPU mesh (diff_max <= 1, clamp_cast_paste once a tile, rb_sweeps_tile 2
    a tile a cycle)."""
    from seamlesscloneoptimization_tpu_torch.parallel import (
        TiledSeamlessClone,
        make_tile_mesh,
        tiled,
    )

    monkeypatch.setattr(tiled, "SHARD_MIN", 16)
    rng = np.random.default_rng(42)
    src = _u8(rng, (150, 230, 3))
    dst = _u8(rng, (200, 300, 3))
    mask = np.full((150, 230), 255, np.uint8)
    cfg = CloneConfig(mg_cycles=3)
    K.reset_launches()
    eng = TiledSeamlessClone(cfg, mesh=_card_mesh(cuda), path="gspmd")
    out = eng.run(src, dst, mask, (150, 100))
    torch.cuda.synchronize()
    assert K.LAUNCHES == _per_frame(clamp_cast_paste=4, rb_sweeps_tile=2 * 4 * 3)
    assert eng.metrics["solver_resolved"] == "multigrid_gspmd"
    cpu = TiledSeamlessClone(cfg, mesh=make_tile_mesh([torch.device("cpu")] * 4, (2, 2)),
                             path="gspmd")
    want = cpu.run(src, dst, mask, (150, 100)).numpy()
    assert np.abs(out.cpu().numpy().astype(np.int16) - want).max() <= 1


def test_two_processes_on_the_card(cuda, tmp_path):
    """Two processes on cuda:0, joined by init_distributed over gloo (they
    share the card), two tiles each of a 2x2 mesh: solve_poisson_dd,
    solve_multigrid_sharded, solve_redblack_tiled and the mesh-resident
    TiledSeamlessClone (timed_serve on the DD path, run on the gspmd path)
    bit-equal to the single-process 2x2 mesh of the card, the strips staged
    through pinned host buffers; no gather in the engine's timed frames."""
    from seamlesscloneoptimization_tpu_torch.parallel import dist_check, tiled

    rng = np.random.default_rng(43)
    g = torch.from_numpy(rng.normal(size=(3, 264, 392)).astype(np.float32) * 30)
    src, dst = torch.from_numpy(_u8(rng, (150, 230, 3))), torch.from_numpy(_u8(rng, (200, 300, 3)))
    mask = torch.full((150, 230), 255, dtype=torch.uint8)
    runs = {"dd": {"g": g, "kwargs": {"tol": 1e-5}},
            "sharded": {"g": g, "kwargs": {"tol": 1e-4}},
            "rb": {"g": g, "kwargs": {"tol": 0.0, "max_iters": 100, "halo": 4}},
            "engine": {"args": (src, dst, mask, (150, 100)), "loops": 2},
            "engine_gspmd": {"args": (src, dst, mask, (150, 100)), "path": "gspmd"}}
    saved, tiled.SHARD_MIN = tiled.SHARD_MIN, 16
    try:
        want = {name: dist_check.run_one(name, run, _card_mesh(cuda), cuda)[0]
                for name, run in runs.items()}
    finally:
        tiled.SHARD_MIN = saved
    torch.save(runs, tmp_path / "in.pt")
    torch.save(want, tmp_path / "expect.pt")
    ranks = dist_check.spawn(2, ["--device", "cuda", "--tiles", "2", "--shape", "2", "2",
                                 "--input", str(tmp_path / "in.pt"), "--expect",
                                 str(tmp_path / "expect.pt"), "--shard-min", "16"], 300)
    assert all(rc == 0 for rc, _ in ranks), "\n---\n".join(out[-3000:] for _, out in ranks)
    for rep in (dist_check.report_of(out) for _, out in ranks):
        assert rep["backend"] == "gloo" and rep["reinit_noop"]
        assert all(row["equal"] for row in rep["solves"].values()), rep
        assert rep["solves"]["rb"]["rb_sweeps_tile"] == 50 * 2  # 2 sweeps a round, 2 tiles
        assert rep["solves"]["engine"]["gathers_per_frame"] == 0
        assert rep["solves"]["engine_gspmd"]["clamp_cast_paste"] == 2  # this rank's two tiles


def _composition(cuda, src, dst, mask, center, solver, frames, dyn_kw=None, bucket=0):
    """``frames`` chained single-device frames on the card: the plain RHS,
    ``solver`` (or bucket_exact's dyn solve of ``dyn_kw``), clamp_cast_paste."""
    from seamlesscloneoptimization_tpu_torch.core.engine import prepare_inputs
    from seamlesscloneoptimization_tpu_torch.models.pipeline import clone_pipeline

    m, xy, lt, hw, *tight = prepare_inputs(mask, src.shape, dst.shape, center, bucket=bucket,
                                           return_tight=dyn_kw is not None)
    buf = torch.from_numpy(dst).to(cuda).permute(2, 0, 1).contiguous()
    for _ in range(frames):
        clone_pipeline(torch.from_numpy(src).to(cuda), buf, torch.from_numpy(m).to(cuda), xy,
                       lt, tight[0] if tight else None, bbox_hw=hw, flags=1, solver=solver,
                       solver_kwargs=dyn_kw, planar_dst=True, use_pallas_pre=False,
                       use_pallas_post=False)
    return buf.permute(1, 2, 0).cpu().numpy()


@pytest.mark.parametrize("path", ["dd", "gspmd"])
def test_resident_engine_on_card(cuda, monkeypatch, path):
    """The mesh-resident TiledSeamlessClone on a 2x2 mesh of the card: three
    chained frames bit-equal to the single-device composition on the card
    (the plain RHS, the whole-g DD solve on the same mesh or the element
    V-cycle, clamp_cast_paste), clamp_cast_paste once a tile a frame, no
    gather in the timed frames; the bucket_exact frame (the partitioned dyn
    solve) bit-equal to its single-device composition."""
    from seamlesscloneoptimization_tpu_torch.parallel import (
        TiledSeamlessClone,
        mesh,
        solve_poisson_dd,
        tiled,
    )

    monkeypatch.setattr(tiled, "SHARD_MIN", 16)
    rng = np.random.default_rng(44)
    src, dst = _u8(rng, (150, 230, 3)), _u8(rng, (200, 300, 3))
    yy, xx = np.mgrid[:150, :230]
    mask = ((((yy - 75) / 70.0) ** 2 + ((xx - 115) / 110.0) ** 2) <= 1).astype(np.uint8) * 255
    center, card = (150, 100), _card_mesh(cuda)
    eng = TiledSeamlessClone(CloneConfig(), mesh=card, path=path)
    mesh.reset_gathers()
    K.reset_launches()
    out, _ = eng.timed_serve(src, dst, mask, center, loops=2)
    torch.cuda.synchronize()
    assert K.LAUNCHES["clamp_cast_paste"] == 4 * 3 and mesh.GATHERS["calls"] == 1
    assert eng.metrics["gathers_per_frame"] == 0
    if path == "dd":
        solver = lambda g: solve_poisson_dd(g, card, tol=1e-4)  # noqa: E731
    else:
        solver = lambda g: TM.solve_multigrid(g, tol=1e-4, use_pallas=False)  # noqa: E731
    assert np.array_equal(out.cpu().numpy(), _composition(cuda, src, dst, mask, center, solver,
                                                          3))
    cfg = CloneConfig(bbox_bucket=32, bucket_exact=True)
    got = TiledSeamlessClone(cfg, mesh=card, path=path).run(src, dst, mask, center)
    want = _composition(cuda, src, dst, mask, center, None, 1, bucket=32, dyn_kw=dict(
        tol=1e-4, cycles=None, max_cycles=60, use_pallas=False))
    assert np.array_equal(got.cpu().numpy(), want)


def test_dyn_sharded_on_card(cuda, monkeypatch):
    """solve_multigrid_dyn_sharded on a 2x2 mesh of the card bit-equal to
    the card's single-device solve_multigrid_dyn(use_pallas=False), equal
    cycles, fixed and tolerance mode; rb_sweeps_tile 2 a tile a cycle on
    each partitioned plain level."""
    from seamlesscloneoptimization_tpu_torch.parallel import solve_multigrid_dyn_sharded, tiled
    from seamlesscloneoptimization_tpu_torch.solvers.multigrid_dyn import solve_multigrid_dyn

    monkeypatch.setattr(tiled, "SHARD_MIN", 16)
    rng = np.random.default_rng(45)
    g = torch.zeros((3, 256, 384), device=cuda)
    g[:, :201, :281] = torch.from_numpy(rng.normal(size=(3, 201, 281)).astype(np.float32) * 20)
    lv = tiled._Level(201, 281, 1.0, 1.0, tiled._split(201, 2), tiled._split(281, 2), (256, 384))
    plain = sum(1 for x in tiled._levels(lv)[:-1] if x.unit)
    assert plain >= 1
    for cycles in (3, None):
        want, winfo = solve_multigrid_dyn(g, (201, 281), cycles=cycles, use_pallas=False,
                                          return_info=True)
        K.reset_launches()
        got, info = solve_multigrid_dyn_sharded(g, (201, 281), _card_mesh(cuda), cycles=cycles,
                                                return_info=True)
        torch.cuda.synchronize()
        assert torch.equal(got, want) and info == winfo
        assert K.LAUNCHES == _per_frame(rb_sweeps_tile=2 * 4 * plain * info["cycles"])


@pytest.mark.parametrize("use_pallas", [False, True])
def test_batch_over_mesh_on_card(cuda, use_pallas):
    """clone_roi_batch with its 16 jobs split over a 2x2 mesh of the card
    bit-equal to the call without a mesh (one paste a block)."""
    from seamlesscloneoptimization_tpu_torch.parallel import batch as TB

    rng = np.random.default_rng(46)
    dests = torch.from_numpy(_u8(rng, (16, 3, 66, 70))).to(cuda)
    patches = torch.from_numpy(_u8(rng, (16, 3, 66, 70))).to(cuda)
    masks = torch.full((16, 66, 70), 255, dtype=torch.uint8, device=cuda)
    masks[:, :3] = 0
    want = TB.clone_roi_batch(dests, patches, masks, 1, TB.fast_dst_solver(), use_pallas)
    K.reset_launches()
    got = TB.clone_roi_batch(dests, patches, masks, 1, TB.fast_dst_solver(), use_pallas,
                             mesh=_card_mesh(cuda))
    torch.cuda.synchronize()
    assert K.LAUNCHES["clamp_cast_paste"] == 4 and torch.equal(got, want)


@pytest.mark.parametrize("mg_cycles", [None, 3])
def test_solver_counts_match_launches(cuda, mg_cycles):
    """``solvers.multigrid.COUNTS`` against ``LAUNCHES`` on the quarter
    chain's served frames: in tolerance mode one ``mg_ud_q`` a cycle, in
    fixed mode ``mg_down_q`` + ``mg_ud_q`` a frame; ``timed_serve``'s
    ``cycles_per_frame`` / ``checks_per_frame`` from the same counter."""
    rng = np.random.default_rng(5)
    src, dst = _u8(rng, (1024, 1280, 3)), _u8(rng, (1200, 1600, 3))
    mask = np.zeros(src.shape[:2], np.uint8)
    mask[1:-1, 1:-1] = 255
    eng = SeamlessClone(CloneConfig(solver="multigrid", mg_cycles=mg_cycles), device=cuda)
    eng.timed_serve(src, dst, mask, (800, 600), loops=1)  # the build, the coarse basis
    K.reset_launches()
    before = dict(TM.COUNTS)
    eng.timed_serve(src, dst, mask, (800, 600), loops=3)
    cycles = TM.COUNTS["cycles"] - before["cycles"]
    checks = TM.COUNTS["checks"] - before["checks"]
    if mg_cycles is None:
        assert cycles == K.LAUNCHES["mg_ud_q"] > 0 and K.LAUNCHES["mg_up_q"] == 0
        assert checks >= K.LAUNCHES["mg_down_q"] == 4
    else:
        assert cycles == K.LAUNCHES["mg_down_q"] + K.LAUNCHES["mg_ud_q"] == 4 * mg_cycles
        assert checks == 0 and eng.metrics["cycles_per_frame"] == mg_cycles
    assert 3 * eng.metrics["cycles_per_frame"] <= cycles
    assert 3 * eng.metrics["checks_per_frame"] <= checks


# the mask prep on the card: prep_mask (no TPU counterpart) and the engine's
# device-side prepare on a side stream


def _prep_cases():
    rng = np.random.default_rng(27)
    headline, patch8k = (1552, 2400), (2802, 3802)
    cases = {
        "headline_full": np.full(headline, 255, np.uint8),
        "headline_ellipse": _ellipse_mask(headline, (1550, 2398)),
        "8k_full": np.full(patch8k, 255, np.uint8),
        "8k_ellipse": _ellipse_mask(patch8k, (2000, 3001)),
        "ellipse": _ellipse_mask((701, 803), (521, 601)),
        "random_1pct": ((rng.random((333, 517)) < 0.01) * 128).astype(np.uint8),
        "random_50pct": (rng.random((300, 401)) < 0.5).astype(np.uint8),
        "empty": np.zeros((64, 80), np.uint8),
        "border_only": np.pad(np.zeros((62, 77), np.uint8), 1, constant_values=9),
        "single_pixel": np.pad(np.full((1, 1), 1, np.uint8), ((700, 11), (9, 3000))),
    }
    for w in list(range(3, 34)) + [2399, 3801]:
        cases[f"width_{w}"] = _u8(rng, (37, w)) * (rng.random((37, w)) < 0.3)
    return cases


PREP_CASES = _prep_cases()


@pytest.mark.parametrize("case", sorted(PREP_CASES))
def test_prep_mask_matches_native(cuda, case):
    """Mask bytes and bbox bit-equal to ``native.prep_mask``'s, 5 launches
    each (the atomics must not change a bit), into a new tensor and in
    place; the mask also read from views at byte offsets 1 .. 15."""
    from seamlesscloneoptimization_tpu_torch import native

    m = PREP_CASES[case]
    want, want_bbox = native.prep_mask(m)
    md = torch.from_numpy(m).to(cuda)
    for _ in range(5):
        K.reset_launches()
        got, bbox = K.prep_mask(md)
        assert K.LAUNCHES["prep_mask"] == 1
        assert tuple(bbox.tolist()) == want_bbox
        assert np.array_equal(got.cpu().numpy(), want)
    assert torch.equal(md.cpu(), torch.from_numpy(m))  # the input is not written
    own = md.clone()
    got, bbox = K.prep_mask(own, out=own)
    assert got is own and np.array_equal(own.cpu().numpy(), want)
    assert tuple(bbox.tolist()) == want_bbox
    if m.size <= 1 << 20:
        buf = torch.zeros(m.size + 16, dtype=torch.uint8, device=cuda)
        for off in range(1, 16):
            view = buf[off : off + m.size].view(m.shape)
            view.copy_(md)
            got, bbox = K.prep_mask(view)
            assert tuple(bbox.tolist()) == want_bbox, off
            assert np.array_equal(got.cpu().numpy(), want), off


def _prep_images(rng, src_hw=(300, 400), dst_hw=(360, 480)):
    return _u8(rng, src_hw + (3,)), _u8(rng, dst_hw + (3,)), _ellipse_mask(src_hw, (281, 361))


@pytest.mark.parametrize("cfg", [dict(), dict(flags=2), dict(bbox_bucket=128),
                                 dict(bbox_bucket=128, bucket_exact=True),
                                 dict(solver="multigrid")])
def test_device_prep_equals_host_route(cuda, monkeypatch, cfg):
    """``run`` and ``timed_serve`` with the mask prepared on the card: one
    prep_mask a call, and outputs bit-equal to the host route's
    (``native.prep_mask``, the prepared mask uploaded); a u8 mask tensor on
    the card and ``mask=None`` the same, the caller's tensor unmodified."""
    src, dst, mask = _prep_images(np.random.default_rng(28))
    center = (240, 180)
    config = CloneConfig(**cfg)
    eng = SeamlessClone(config, device=cuda)
    K.reset_launches()
    run = eng.run(src, dst, mask, center).cpu().numpy()
    assert K.LAUNCHES["prep_mask"] == 1
    K.reset_launches()
    served, _ = eng.timed_serve(src, dst, mask, center, loops=2)
    assert K.LAUNCHES["prep_mask"] == 1
    m_d = torch.from_numpy(mask).to(cuda)
    m_d[0, :] = 7  # a border the prep zeroes: the caller's tensor must keep it
    kept = m_d.clone()
    by_tensor = eng.run(src, dst, m_d, center).cpu().numpy()
    torch.cuda.synchronize()
    assert torch.equal(m_d, kept)
    full = eng.run(src, dst, None, center).cpu().numpy()
    monkeypatch.setattr(SeamlessClone, "_preps_on_device", staticmethod(lambda m: False))
    host = SeamlessClone(config, device=cuda)
    K.reset_launches()
    assert np.array_equal(run, host.run(src, dst, mask, center).cpu().numpy())
    assert np.array_equal(served.cpu().numpy(),
                          host.timed_serve(src, dst, mask, center, loops=2)[0].cpu().numpy())
    assert K.LAUNCHES["prep_mask"] == 0
    assert np.array_equal(by_tensor, run)
    assert np.array_equal(full, host.run(src, dst, np.full(mask.shape, 255, np.uint8),
                                         center).cpu().numpy())


MASK_HOMES = ["cpu", "cuda", "cuda:0"] + (["cuda:1"] if torch.cuda.device_count() > 1 else [])


@pytest.mark.parametrize("home", MASK_HOMES)
def test_device_prep_mask_on_any_device(cuda, monkeypatch, home):
    """A u8 mask tensor on the engine's card (``cuda`` or ``cuda:0`` for an
    engine on ``cuda``) is read where it lies; one on the CPU or another
    card is copied to the engine's card and prepared in place there. Every
    way the output equals the host array's, and the caller's tensor keeps
    its bytes."""
    src, dst, mask = _prep_images(np.random.default_rng(30))
    center = (240, 180)
    eng = SeamlessClone(CloneConfig(), device=cuda)
    want = eng.run(src, dst, mask, center).cpu().numpy()
    m_t = torch.from_numpy(mask).to(home)
    m_t[:, 0] = 9  # a border the prep zeroes
    kept = m_t.clone()
    calls = []
    real = K.prep_mask

    def spy(m, out=None):
        calls.append((m, out))
        return real(m, out)

    monkeypatch.setattr(K, "prep_mask", spy)
    got = eng.run(src, dst, m_t, center).cpu().numpy()
    torch.cuda.synchronize()
    (given, out), = calls
    here = torch.device(home).type == "cuda" and torch.device(home).index in (None, 0)
    assert given.device == torch.device("cuda", torch.cuda.current_device())
    if here:
        assert given is m_t and out is None
    else:
        assert out is given and given.data_ptr() != m_t.data_ptr()
    assert np.array_equal(got, want)
    assert torch.equal(m_t, kept)


def test_run_prep_does_not_wait_for_queued_frames(cuda):
    """Back-to-back ``run`` calls: the bbox read waits on the engine's side
    stream only. With ~0.3 s of work queued on the current stream ahead of
    it, ``run`` returns while that work still runs, and its output equals a
    synchronised run's."""
    rng = np.random.default_rng(29)
    src, dst, mask = _prep_images(rng)
    src_d, dst_d = torch.from_numpy(src).to(cuda), torch.from_numpy(dst).to(cuda)
    eng = SeamlessClone(CloneConfig(), device=cuda)
    want = eng.run(src_d, dst_d, mask, (240, 180)).cpu().numpy()  # warm: bases, build
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    torch.cuda._sleep(1 << 28)
    e.record()
    e.synchronize()
    cycles = int((1 << 28) * 300 / s.elapsed_time(e))  # ~300 ms of spinning
    torch.cuda.synchronize()
    main = torch.cuda.current_stream()
    torch.cuda._sleep(cycles)
    out = eng.run(src_d, dst_d, mask, (240, 180))
    assert not main.query()  # the spin and the frame still queued: run did not wait
    assert eng.metrics["bbox"] == (20, 10, 361, 281)
    assert np.array_equal(out.cpu().numpy(), want)
