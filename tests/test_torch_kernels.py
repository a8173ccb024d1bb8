"""Each kernel wrapper of the port, on CPU tensors (where it runs its plain
twin), against the TPU Pallas kernel it replaces run in interpret mode.

The kernels themselves run only on the card: tests/test_torch_cuda.py holds
each against its twin there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seamlesscloneoptimization_tpu.ops import pallas_kernels as PK
from seamlesscloneoptimization_tpu.ops.guidance import bgr_to_gray_u8 as jax_gray
from seamlesscloneoptimization_tpu.solvers.dst_gemm import dst_eigenvalues
from seamlesscloneoptimization_tpu_torch.ops import kernels as K

# Several pytest-xdist workers share the cores: one intra-op thread each keeps
# torch's OpenMP pools from oversubscribing them (it cut this suite's CPU time
# about 3.5x). Results do not depend on it.
torch.set_num_threads(1)


def _u8(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(np.uint8)


def _mask01(seed, shape, p=0.85):
    return (np.random.default_rng(seed).random(shape) < p).astype(np.uint8)


@pytest.mark.parametrize("shape", [(9, 13), (90, 170), (131, 60)])
def test_erode3_matches_pallas(shape):
    m = _mask01(shape[1], shape)
    want = np.asarray(PK.erode3_pallas(jnp.asarray(m), interpret=True))
    assert np.array_equal(K.erode3(torch.from_numpy(m)).numpy(), want)


@pytest.mark.parametrize("hw", [(40, 57), (61, 130), (131, 60)])
@pytest.mark.parametrize("mode", [(1, "opencv"), (2, "opencv"), (2, "norm"), (3, "opencv")])
def test_preprocess_rhs_t_matches_pallas(hw, mode):
    flags, rule = mode
    h, w = hw
    dest = _u8(h, (3, h, w))
    patch = _u8(w, (3, h, w))
    mask = _mask01(h + w, (h, w)) * 255
    kflags, patch_j = flags, jnp.asarray(patch)
    patch_t = torch.from_numpy(patch)
    if flags == 3:  # MONOCHROME: the pipeline hands the kernel the gray patch
        gray = jax_gray(jnp.asarray(patch, jnp.float32))
        patch_j = jnp.broadcast_to(gray[None], patch.shape)
        patch_t = torch.from_numpy(np.asarray(gray).astype(np.uint8))[None].expand(3, h, w)
        kflags = 1
    want = np.asarray(PK.preprocess_rhs_transposed_pallas(
        jnp.asarray(dest), patch_j, jnp.asarray(mask), kflags, rule, interpret=True))
    me = K.erode3(torch.from_numpy((mask != 0).astype(np.uint8)))
    got = K.preprocess_rhs_t(torch.from_numpy(dest), patch_t, me, kflags, rule).numpy()
    assert got.shape == want.shape == (3, K.ru128(w - 2), K.ru128(h - 2))
    assert np.array_equal(got, want)
    pad = np.ones(got.shape, bool)
    pad[:, : w - 2, : h - 2] = False
    assert not got[pad].any()  # the padding is exactly zero


def test_preprocess_rhs_t_reads_strided_views():
    """A view into an interleaved image gives the same RHS as a copy."""
    img = _u8(11, (50, 70, 3))
    dest = torch.from_numpy(img)[5:45, 3:60].permute(2, 0, 1)
    patch = torch.from_numpy(_u8(12, (3, 40, 57)))
    me = K.erode3(torch.from_numpy(_mask01(13, (40, 57))))
    assert torch.equal(K.preprocess_rhs_t(dest, patch, me),
                       K.preprocess_rhs_t(dest.contiguous(), patch, me))


@pytest.mark.parametrize("ab", [(60, 90), (128, 256), (130, 61)])
def test_transpose_matches_pallas(ab):
    a, b = ab
    x = np.random.default_rng(a).normal(size=(3, a, b)).astype(np.float32) * 40
    got = K.transpose(torch.from_numpy(x)).numpy()
    assert np.array_equal(got, np.asarray(PK.transpose_pallas(jnp.asarray(x), interpret=True)))
    la, lb = dst_eigenvalues(a), dst_eigenvalues(b)
    want_d = np.asarray(PK.transpose_pallas(jnp.asarray(x), lam_a=la, lam_b=lb,
                                            interpret=True))
    got_d = K.transpose(torch.from_numpy(x), torch.from_numpy(la.copy()),
                        torch.from_numpy(lb.copy())).numpy()
    np.testing.assert_allclose(got_d, want_d, rtol=1e-6)


@pytest.mark.parametrize("off", [(55, 201), (128, 256), (1, 1), (7, 127)])
def test_clamp_cast_paste_planar_matches_guarded_paste(off):
    top1, left1 = off
    h2, w2 = 130, 260
    rng = np.random.default_rng(top1)
    dst = rng.integers(0, 256, (3, 300, 520)).astype(np.uint8)
    u = rng.normal(size=(3, h2, w2)).astype(np.float32) * 160 + 90
    up = np.pad(u, ((0, 0), (0, K.ru128(h2) - h2), (0, K.ru128(w2) - w2)))
    guarded = PK.clamp_cast_guarded_pallas(jnp.asarray(up), interpret=True)
    want = np.asarray(PK.paste_interior_pallas(
        jnp.asarray(dst), guarded, jnp.int32(top1), jnp.int32(left1), h2, w2,
        interpret=True))
    got = torch.from_numpy(dst.copy())
    assert K.clamp_cast_paste(torch.from_numpy(up), got, top1, left1, h2, w2) is got
    assert np.array_equal(got.numpy(), want)


def test_clamp_cast_paste_interleaved_matches_clamp_cast():
    """Single-shot path: clamp_cast_pallas with its crop, then the
    interleaved update, equals one in-place paste through a permuted view."""
    rng = np.random.default_rng(7)
    h2, w2, top1, left1 = 70, 140, 11, 23
    u = rng.normal(size=(3, 128, 256)).astype(np.float32) * 160 + 90
    dst = rng.integers(0, 256, (100, 200, 3)).astype(np.uint8)
    interior = np.asarray(PK.clamp_cast_pallas(jnp.asarray(u), out_hw=(h2, w2),
                                               interpret=True))
    want = dst.copy()
    want[top1 : top1 + h2, left1 : left1 + w2] = interior.transpose(1, 2, 0)
    got = torch.from_numpy(dst.copy())
    K.clamp_cast_paste(torch.from_numpy(u), got.permute(2, 0, 1), top1, left1, h2, w2)
    assert np.array_equal(got.numpy(), want)


def test_cpu_twins_do_not_count_launches():
    K.reset_launches()
    m = torch.from_numpy(_mask01(1, (20, 30)))
    me = K.erode3(m)
    g = K.preprocess_rhs_t(torch.from_numpy(_u8(2, (3, 20, 30))),
                           torch.from_numpy(_u8(3, (3, 20, 30))), me)
    K.clamp_cast_paste(K.transpose(K.transpose(g)), torch.zeros((3, 20, 30), dtype=torch.uint8),
                       1, 1, 18, 28)
    s, d = K.fold_minor(g, 20)
    tp = K.transpose_pair(s, d)
    e = K.unfold_transpose(tp[:, :128].contiguous(), tp[:, 128:].contiguous(), 20, 128)
    K.unfold_clamp_paste(e, K.unfold_minor(e, e, 20, 128), torch.zeros((3, 20, 30),
                         dtype=torch.uint8), 1, 1, 18, 20)
    gp = K.preprocess_rhs_p(torch.from_numpy(_u8(2, (3, 20, 30))),
                            torch.from_numpy(_u8(3, (3, 20, 30))), me, (32, 128))
    u, rh = K.mg_down(None, gp, 1, 18, 28, rh_rows=128)
    ec = K.mg_restrict_t(rh, 18, 28, 1.0, 16)
    K.mg_up(u, gp, K.mg_prolong_t(ec, 28, 1.0, 128, 128), 2, 18, 28)
    u, rc_t = K.mg_down_t(None, gp, 1, 18, 28, 1.0, 1.0, 16)
    K.mg_up_t(u, gp, rc_t[:, :, :16].contiguous(), 2, 18, 28)
    gq = K.preprocess_rhs_q(torch.from_numpy(_u8(2, (3, 20, 30))),
                            torch.from_numpy(_u8(3, (3, 20, 30))), me, (256, 256))
    uq, rc_t = K.mg_down_q(None, gq, 1, 18, 28, 128)
    e_even, e_odd = K.mg_prolong_tq(rc_t, 28, 128, 128)
    uq = K.mg_ud_q(uq, gq, e_even, e_odd, 2, 1, 18, 28, 128, with_residual=True)[0]
    uq = K.mg_up_q(uq, gq, e_even, e_odd, 2, 18, 28)
    K.clamp_cast_paste_q(uq, torch.zeros((3, 20, 30), dtype=torch.uint8), 1, 1, 18, 28)
    uq, rh_e, rh_o = K.mg_down_q(K.to_quarters(K.from_quarters(uq)), gq, 1, 18, 28)
    K.mg_restrict_tq(rh_e, rh_o, 18, 28, 128)
    K.mg_up_q(uq, gq, e_even, e_odd, 2, 18, 28, with_residual=True)
    K.rb_sweeps(gp[:, :18, :28].contiguous(), gp[:, :18, :28].contiguous(), 6)
    K.postprocess_transposed(g[:, :28, :18].contiguous(),
                             torch.zeros((3, 20, 30), dtype=torch.uint8), 1, 1)
    K.rb_sweeps_tile(gp[:, :18, :28].contiguous(), gp[:, :18, :28].contiguous(), 6, (-3, 5),
                     (12, 30))
    K.prep_mask(m, out=m)
    assert set(K.LAUNCHES) == {"erode3", "preprocess_rhs_t", "transpose", "clamp_cast_paste",
                               "fold_minor", "unfold_minor", "transpose_pair",
                               "unfold_transpose", "unfold_clamp_paste", "preprocess_rhs_p",
                               "mg_down", "mg_up", "mg_restrict_t", "mg_prolong_t",
                               "mg_down_t", "mg_up_t", "preprocess_rhs_q", "mg_down_q",
                               "mg_up_q", "mg_ud_q", "mg_prolong_tq", "clamp_cast_paste_q",
                               "to_quarters",
                               "from_quarters", "mg_restrict_tq", "rb_sweeps",
                               "postprocess_transposed", "rb_sweeps_tile", "prep_mask"}
    assert set(K.LAUNCHES.values()) == {0}


def test_wrappers_validate_inputs():
    u8 = torch.zeros((3, 20, 30), dtype=torch.uint8)
    me = torch.zeros((20, 30), dtype=torch.uint8)
    with pytest.raises(TypeError, match="uint8"):
        K.erode3(me.float())
    with pytest.raises(ValueError, match="contiguous"):
        K.erode3(me.t())
    with pytest.raises(ValueError, match="flags"):
        K.preprocess_rhs_t(u8, u8, me, 3)
    with pytest.raises(ValueError, match="mixed_rule"):
        K.preprocess_rhs_t(u8, u8, me, 2, "max")
    with pytest.raises(ValueError, match="shape mismatch"):
        K.preprocess_rhs_t(u8, u8[:, :10], me)
    with pytest.raises(ValueError, match="no interior"):
        K.preprocess_rhs_t(u8[:, :2], u8[:, :2], me[:2])
    x = torch.zeros((3, 8, 16))
    with pytest.raises(ValueError, match="together"):
        K.transpose(x, torch.zeros(8))
    with pytest.raises(ValueError, match="lengths"):
        K.transpose(x, torch.zeros(8), torch.zeros(8))
    with pytest.raises(ValueError, match="outside"):
        K.clamp_cast_paste(torch.zeros((3, 18, 28)), u8, 3, 3, 18, 28)
