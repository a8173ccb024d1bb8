"""The folded chain's five kernel wrappers on CPU tensors (their plain twins)
against the TPU Pallas kernels they replace, run in interpret mode, and the
folded host bases against the JAX package's.

Bars: bit-exact for the fold, the unfolds and the plain transpose (every
value is one IEEE add or subtract of the same operands); rtol 1e-6 for the
divide against XLA on the CPU, as tests/test_torch_kernels.py holds
``transpose``. The twins write exact zeros where the TPU fold leaves
finite garbage, and the tests compare the whole buffer.
The kernels themselves run only on the card: tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seamlesscloneoptimization_tpu.ops import pallas_kernels as PK
from seamlesscloneoptimization_tpu.solvers import dst_gemm as JD
from seamlesscloneoptimization_tpu_torch.ops import kernels as K
from seamlesscloneoptimization_tpu_torch.solvers import dst_gemm as TD

# Several pytest-xdist workers share the cores: one intra-op thread each keeps
# torch's OpenMP pools from oversubscribing them (it cut this suite's CPU time
# about 3.5x). Results do not depend on it.
torch.set_num_threads(1)


def _halves(n):
    he, ho = (n + 1) // 2, n // 2
    return he, ho, K.ru128(he), K.ru128(ho)


def _eo(seed, rows, n, scale=1.0, c=2):
    """Inverse half-GEMM outputs: data on lanes [0, he), exact zeros beyond."""
    he, _, ep, _ = _halves(n)
    rng = np.random.default_rng(seed)
    e = np.zeros((c, rows, ep), np.float32)
    o = np.zeros((c, rows, ep), np.float32)
    e[:, :, :he] = rng.normal(size=(c, rows, he)).astype(np.float32) * scale
    o[:, :, :he] = rng.normal(size=(c, rows, he)).astype(np.float32) * scale
    return e, o


@pytest.mark.parametrize("n", [126, 127, 128, 129, 255, 256, 300, 775])
def test_fold_minor_matches_pallas(n):
    he, ho, ep, op = _halves(n)
    npad = K.ru128(n)
    x = np.zeros((2, 256, npad), np.float32)
    x[:, :, :n] = np.random.default_rng(n).normal(size=(2, 256, n)).astype(np.float32) * 50
    js, jd = (np.asarray(a) for a in PK.fold_minor_pallas(jnp.asarray(x), n, interpret=True))
    s, d = (a.numpy() for a in K.fold_minor(torch.from_numpy(x), n))
    assert s.shape == js.shape == (2, 256, ep) and d.shape == jd.shape == (2, 256, op)
    # exact on the lanes the TPU kernel defines
    assert np.array_equal(s[..., :ho], js[..., :ho])
    assert np.array_equal(d[..., :ho], jd[..., :ho])
    if n % 2:  # the middle element counted once
        assert np.array_equal(s[..., he - 1], js[..., he - 1])
        assert np.array_equal(s[..., he - 1], x[..., he - 1])
    # exactly 0 everywhere else, d's middle lane included
    assert not s[..., he:].any() and not d[..., ho:].any()


def test_fold_minor_reads_only_the_data_lanes():
    """Lanes >= n of the input never reach the output (the pair chain's
    second fold reads a slab whose padding the GEMMs made)."""
    x = np.random.default_rng(1).normal(size=(3, 128, 256)).astype(np.float32)
    clean = x.copy()
    clean[..., 201:] = 0
    for a, b in zip(K.fold_minor(torch.from_numpy(x), 201),
                    K.fold_minor(torch.from_numpy(clean), 201)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("n", [126, 127, 128, 129, 300])
def test_unfold_minor_matches_pallas(n):
    _, _, ep, _ = _halves(n)
    out_pad = max(K.ru128(n), ep)
    e, o = _eo(n, 128, n)
    want = np.asarray(PK.unfold_minor_pallas(jnp.asarray(e), jnp.asarray(o), n, out_pad,
                                              interpret=True))
    got = K.unfold_minor(torch.from_numpy(e), torch.from_numpy(o), n, out_pad).numpy()
    assert got.shape == want.shape == (2, 128, out_pad)
    assert np.array_equal(got, want)
    assert not got[..., n:].any()


@pytest.mark.parametrize("n", [127, 128, 300])
def test_unfold_transpose_matches_pallas(n):
    _, _, ep, _ = _halves(n)
    out_pad = max(K.ru128(n), ep)
    e, o = (torch.from_numpy(a) for a in _eo(n, 256, n))
    for rs in (0, 128):  # both windows: together every row once
        want = np.asarray(PK.unfold_transpose_pallas(
            jnp.asarray(e.numpy()), jnp.asarray(o.numpy()), n, out_pad, row_start=rs,
            row_count=128, interpret=True))
        got = K.unfold_transpose(e, o, n, out_pad, rs, 128).numpy()
        assert got.shape == want.shape == (2, out_pad, 128)
        assert np.array_equal(got, want)


@pytest.mark.parametrize("pab", [(128, 128), (256, 128), (128, 384)])
def test_transpose_pair_matches_pallas(pab):
    pa, pb = pab
    m = 384
    rng = np.random.default_rng(pa + pb)
    a = rng.normal(size=(3, m, pa)).astype(np.float32) * 40
    b = rng.normal(size=(3, m, pb)).astype(np.float32) * 40
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    want = np.asarray(PK.transpose_pair_pallas(ja, jb, interpret=True))
    got = K.transpose_pair(ta, tb).numpy()
    assert got.shape == want.shape == (3, pa + pb, m)
    assert np.array_equal(got, want)
    lam_p = JD.dst_eigenvalues_padded(pa + pb - 40, pa + pb).copy()
    lam_r = JD.dst_eigenvalues_padded(m - 70, m).copy()
    for rs, rc in ((0, 256), (256, 128)):  # the two windows of the spectral slab
        want_d = np.asarray(PK.transpose_pair_pallas(
            ja, jb, lam_p=lam_p, lam_r=lam_r, row_start=rs, row_count=rc, interpret=True))
        got_d = K.transpose_pair(ta, tb, torch.from_numpy(lam_p), torch.from_numpy(lam_r),
                                 rs, rc).numpy()
        assert got_d.shape == want_d.shape == (3, pa + pb, rc)
        np.testing.assert_allclose(got_d, want_d, rtol=1e-6)
        want_n = np.asarray(PK.transpose_pair_pallas(ja, jb, row_start=rs, row_count=rc,
                                                     interpret=True))
        assert np.array_equal(K.transpose_pair(ta, tb, row_start=rs, row_count=rc).numpy(),
                              want_n)


@pytest.mark.parametrize("n", [127, 300])
def test_unfold_clamp_paste_matches_guarded_pallas(n):
    """The planar paste at (top1, left1) equals the data region of the TPU's
    guarded slab for the interior (h2, n)."""
    _, _, ep, _ = _halves(n)
    out_pad = max(K.ru128(n), ep)
    h2, top1, left1 = 200, 9, 21
    e, o = _eo(n, 256, n, scale=120, c=3)
    e[:, h2:] = 0  # the chain's rows beyond h2 are zero
    o[:, h2:] = 0
    g = np.asarray(PK.unfold_clamp_guarded_pallas(jnp.asarray(e), jnp.asarray(o), n,
                                                  out_pad, interpret=True))
    th, cw = 128, PK._PASTE_CW
    dst = np.random.default_rng(n).integers(0, 256, (3, 240, 360)).astype(np.uint8)
    want = dst.copy()
    want[:, top1 : top1 + h2, left1 : left1 + n] = g[:, th : th + h2, cw : cw + n]
    got = torch.from_numpy(dst.copy())
    assert K.unfold_clamp_paste(torch.from_numpy(e), torch.from_numpy(o), got, top1, left1,
                                h2, n) is got
    assert np.array_equal(got.numpy(), want)


def test_unfold_clamp_paste_interleaved_matches_unfold_clamp_cast():
    """Single-shot path: the TPU's unfold_minor + clamp_cast (cropped), then
    the interleaved update, equals one paste through a permuted view."""
    n, h2, top1, left1 = 301, 140, 5, 17
    e, o = _eo(3, 256, n, scale=120, c=3)
    u = PK.unfold_minor_pallas(jnp.asarray(e), jnp.asarray(o), n, K.ru128(n), interpret=True)
    interior = np.asarray(PK.clamp_cast_pallas(u, out_hw=(h2, n), interpret=True))
    dst = np.random.default_rng(5).integers(0, 256, (200, 340, 3)).astype(np.uint8)
    want = dst.copy()
    want[top1 : top1 + h2, left1 : left1 + n] = interior.transpose(1, 2, 0)
    got = torch.from_numpy(dst.copy())
    K.unfold_clamp_paste(torch.from_numpy(e), torch.from_numpy(o), got.permute(2, 0, 1),
                         top1, left1, h2, n)
    assert np.array_equal(got.numpy(), want)


def test_folded_wrappers_validate_inputs():
    x = torch.zeros((3, 8, 128))
    with pytest.raises(ValueError, match="fold size"):
        K.fold_minor(x, 129)
    with pytest.raises(TypeError, match="float32"):
        K.fold_minor(x.double(), 100)
    e = torch.zeros((3, 8, 128))
    with pytest.raises(ValueError, match="differ"):
        K.unfold_minor(e, e[:, :4].contiguous(), 100, 128)
    with pytest.raises(ValueError, match="too narrow"):
        K.unfold_minor(e, e, 300, 384)
    with pytest.raises(ValueError, match="out_pad"):
        K.unfold_minor(e, e, 200, 128)
    with pytest.raises(ValueError, match="window"):
        K.unfold_transpose(e, e, 200, 256, row_start=4, row_count=8)
    with pytest.raises(ValueError, match="together"):
        K.transpose_pair(e, e, torch.zeros(256))
    with pytest.raises(ValueError, match="lengths"):
        K.transpose_pair(e, e, torch.zeros(128), torch.zeros(8))
    with pytest.raises(ValueError, match="rows"):
        K.transpose_pair(e, e[:, :4].contiguous())
    dst = torch.zeros((3, 20, 30), dtype=torch.uint8)
    with pytest.raises(ValueError, match="outside"):
        K.unfold_clamp_paste(e, e, dst, 3, 3, 8, 28)


# ---------------------------------------------------------------------------
# Host bases and gates: bit-equal to the JAX package
# ---------------------------------------------------------------------------


def test_fold_gates_match_jax():
    assert [TD.fold_pays(n) for n in range(1, 3001)] == [JD.fold_pays(n)
                                                        for n in range(1, 3001)]
    # every n above 128 folds, none at or below
    assert all(TD.fold_pays(n) == (n > 128) for n in range(1, 3001))
    for h2, w2 in ((61, 93), (130, 61), (61, 130), (200, 300), (1548, 2396)):
        assert TD.pair_chain_applies(h2, w2) == JD.pallas_pair_chain_applies(h2, w2)


@pytest.mark.parametrize("n", [1, 2, 7, 127, 128, 129, 300, 775, 1548])
def test_folded_bases_bit_equal(n):
    for want, got in zip(JD.dst_matrices_folded(n), TD.dst_matrices_folded(n)):
        assert want.dtype == got.dtype and want.shape == got.shape
        assert np.array_equal(want, got)
    want, got = JD.dst_eigenvalues_grouped(n), TD.dst_eigenvalues_grouped(n)
    assert want.dtype == got.dtype and np.array_equal(want, got)


def test_dst_bases_hold_the_folded_factors_of_folding_axes():
    bh, bw = TD.dst_bases(130, 61, 256, 128, torch.device("cpu"), folded=True)
    assert bh.folded and not bw.folded
    for want, got in zip(JD.dst_matrices_folded(130), bh.mats):
        assert np.array_equal(got.numpy(), want)
    assert np.array_equal(bh.lam.numpy(), JD.dst_eigenvalues_grouped(130))
    assert np.array_equal(bw.mats[0].numpy(), JD.dst_matrix_padded(61, 128))
    assert np.array_equal(bw.lam.numpy(), JD.dst_eigenvalues_padded(61, 128))
    # folded=False keeps both axes plain
    assert not any(b.folded for b in TD.dst_bases(130, 300, 256, 384, "cpu"))
