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
from seamlesscloneoptimization_tpu_torch.solvers.dst_gemm import dst_eigenvalues_padded

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _u8(rng, shape):
    return rng.integers(0, 256, shape).astype(np.uint8)


@pytest.mark.parametrize("hw", [(1, 1), (5, 7), (37, 70), (130, 257)])
def test_erode3_matches_plain(cuda, hw):
    rng = np.random.default_rng(hw[0])
    m = torch.from_numpy((rng.random(hw) < 0.9).astype(np.uint8))
    got = K.erode3(m.to(cuda))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), K.erode3_plain(m))


@pytest.mark.parametrize("hw", [(3, 3), (5, 9), (40, 57), (131, 260)])
@pytest.mark.parametrize("mode", [(1, "opencv"), (2, "opencv"), (2, "norm"), (3, "opencv")])
def test_preprocess_rhs_t_matches_plain(cuda, hw, mode):
    flags, rule = mode
    h, w = hw
    rng = np.random.default_rng(h * w)
    # dest as a strided view into a larger interleaved image, like run()
    img = torch.from_numpy(_u8(rng, (h + 4, w + 6, 3)))
    dest = img[2 : 2 + h, 3 : 3 + w, :].permute(2, 0, 1)
    patch = torch.from_numpy(_u8(rng, (3, h, w)))
    kflags = flags
    if flags == 3:  # MONOCHROME: gray patch broadcast with a stride-0 view
        patch = patch[0][None].expand(3, h, w)
        kflags = 1
    me = torch.from_numpy((rng.random((h, w)) < 0.7).astype(np.uint8))
    want = K.preprocess_rhs_t_plain(dest, patch, me, kflags, rule)
    got = K.preprocess_rhs_t(dest.to(cuda), patch.to(cuda), me.to(cuda), kflags, rule)
    torch.cuda.synchronize()
    # bit-exact, padding included (torch.empty output: every element written)
    assert torch.equal(got.cpu(), want)


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


@pytest.mark.parametrize("planar", [True, False])
@pytest.mark.parametrize("off", [(1, 1), (7, 127), (55, 201)])
def test_clamp_cast_paste_matches_plain(cuda, planar, off):
    top1, left1 = off
    h2, w2 = 130, 260
    rng = np.random.default_rng(top1)
    u = torch.from_numpy(rng.normal(size=(3, 256, 384)).astype(np.float32) * 160 + 90)
    base = _u8(rng, (3, 300, 520) if planar else (300, 520, 3))
    want = torch.from_numpy(base.copy())
    want_v = want if planar else want.permute(2, 0, 1)
    K.clamp_cast_paste_plain(u, want_v, top1, left1, h2, w2)
    got = torch.from_numpy(base.copy()).to(cuda)
    got_v = got if planar else got.permute(2, 0, 1)
    K.clamp_cast_paste(u.to(cuda), got_v, top1, left1, h2, w2)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)


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


def test_serve_goes_through_every_kernel(cuda):
    rng = np.random.default_rng(9)
    src = _u8(rng, (70, 100, 3))
    dst = _u8(rng, (150, 180, 3))
    mask = np.full(src.shape[:2], 255, np.uint8)
    eng = SeamlessClone(CloneConfig(), device=cuda)
    K.reset_launches()
    out, ms = eng.timed_serve(src, dst, mask, (90, 75), loops=3)
    frames = 1 + 3  # warm-up + timed
    assert K.LAUNCHES == {"erode3": frames, "preprocess_rhs_t": frames,
                          "transpose": 3 * frames, "clamp_cast_paste": frames}
    assert ms > 0
    ref = SeamlessClone(CloneConfig(), device="cpu")
    want, _ = ref.timed_serve(src, dst, mask, (90, 75), loops=3)
    assert np.abs(out.cpu().numpy().astype(np.int16) - want.numpy()).max() <= 1
