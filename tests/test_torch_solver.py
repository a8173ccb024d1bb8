"""The port's DST-GEMM solver against the JAX package's, on the CPU: the host
DST bases bit-equal, the solves within float32 rounding (relative max error
< 1e-5: the GEMMs sum in another order than XLA)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seamlesscloneoptimization_tpu.solvers import dst_gemm as JD
from seamlesscloneoptimization_tpu_torch import solvers as TS
from seamlesscloneoptimization_tpu_torch.solvers import dst_gemm as TD


def _rel(got, want):
    return float(np.abs(np.asarray(got) - np.asarray(want)).max() / np.abs(want).max())


@pytest.mark.parametrize("n", [1, 2, 7, 61, 128, 130])
def test_dst_bases_bit_equal(n):
    n_pad = (n + 127) // 128 * 128
    pairs = ((JD.dst_matrix(n), TD.dst_matrix(n)),
             (JD.dst_eigenvalues(n), TD.dst_eigenvalues(n)),
             (JD.dst_matrix_padded(n, n_pad), TD.dst_matrix_padded(n, n_pad)),
             (JD.dst_eigenvalues_padded(n, n_pad), TD.dst_eigenvalues_padded(n, n_pad)))
    for want, got in pairs:
        assert want.dtype == got.dtype and np.array_equal(want, got)


def test_bases_on_device_equal_host():
    vh, vw, lh, lw = TD.dst_bases(61, 93, 128, 128, torch.device("cpu"))
    assert np.array_equal(vh.numpy(), JD.dst_matrix_padded(61, 128))
    assert np.array_equal(lw.numpy(), JD.dst_eigenvalues_padded(93, 128))


def test_fold_pays_is_false_until_the_pair_chain():
    assert not any(TD.fold_pays(n) for n in (127, 1548, 2396, 4000))


def test_folded_axes_follow_fold_pays(monkeypatch):
    # where fold_pays holds and folded=True the folded transform would run:
    # not ported yet, so it raises; folded=False or transform_only never asks
    monkeypatch.setattr(TD, "fold_pays", lambda n: n == 8)
    g = torch.ones((3, 8, 6))
    g_tp = torch.zeros((3, 128, 128))
    with pytest.raises(NotImplementedError, match="axis size 8.*slice 2"):
        TD.solve_dst_gemm(g, folded=True)
    with pytest.raises(NotImplementedError, match="slice 2"):
        TD.solve_dst_gemm(g, folded=True, transposed_output=True)
    with pytest.raises(NotImplementedError, match="slice 2"):
        TD.solve_dst_gemm_pl(g_tp, 8, 6, folded=True)
    assert TD.solve_dst_gemm(g, folded=True, transform_only=True).shape == (3, 8, 6)
    assert TD.solve_dst_gemm(g, folded=False).shape == (3, 8, 6)
    assert TD.solve_dst_gemm_pl(g_tp, 8, 6, folded=False).shape == (3, 128, 128)
    assert TD.solve_dst_gemm_pl(g_tp, 6, 7, folded=True).shape == (3, 128, 128)


@pytest.mark.parametrize("hw", [(61, 93), (130, 61)])
def test_solve_dst_gemm_pl_matches_jax(hw):
    h2, w2 = hw
    hp, wp = (h2 + 127) // 128 * 128, (w2 + 127) // 128 * 128
    g = np.random.default_rng(h2).normal(size=(3, h2, w2)).astype(np.float32) * 50
    g_tp = np.zeros((3, wp, hp), np.float32)
    g_tp[:, :w2, :h2] = g.transpose(0, 2, 1)
    want = np.asarray(JD.solve_dst_gemm_pl(jnp.asarray(g_tp), h2=h2, w2=w2,
                                           precision="highest", folded=False,
                                           interpret=True))
    got = TD.solve_dst_gemm_pl(torch.from_numpy(g_tp), h2, w2).numpy()
    assert got.shape == want.shape == (3, hp, wp)
    scale = np.abs(want).max()
    assert _rel(got[:, :h2, :w2], want[:, :h2, :w2]) < 1e-5
    pad = np.ones(got.shape, bool)
    pad[:, :h2, :w2] = False
    assert np.abs(got[pad]).max() < 1e-4 * scale
    # folded=True runs the same unfolded chain: the same output
    folded = TD.solve_dst_gemm_pl(torch.from_numpy(g_tp), h2, w2, precision="high",
                                  folded=True).numpy()
    assert np.array_equal(folded, got)
    # and it solves the same system as the plain solver
    plain = TD.solve_dst_gemm(torch.from_numpy(g)).numpy()
    assert _rel(got[:, :h2, :w2], plain) < 1e-5


@pytest.mark.parametrize("kw", [{}, {"transposed_output": True}, {"transposed_input": True},
                                {"transform_only": True}, {"folded": True}])
def test_solve_dst_gemm_matches_jax(kw):
    g = np.random.default_rng(4).normal(size=(3, 60, 90)).astype(np.float32) * 50
    if kw.get("transposed_input"):
        g = np.ascontiguousarray(g.transpose(0, 2, 1))
    want = np.asarray(JD.solve_dst_gemm(jnp.asarray(g), **kw))
    got = TD.solve_dst_gemm(torch.from_numpy(g), **kw).numpy()
    assert got.shape == want.shape
    assert _rel(got, want) < 1e-5


def test_unported_precision_raises():
    g = torch.zeros((3, 8, 8))
    with pytest.raises(NotImplementedError, match="precision"):
        TD.solve_dst_gemm(g, precision="default")
    with pytest.raises(NotImplementedError, match="precision"):
        TD.solve_dst_gemm_pl(torch.zeros((3, 128, 128)), 8, 8, precision="2x_v")


def test_solver_registry():
    assert TS.get_solver("dst_gemm") is TS.solve_dst_gemm
    for name, slice_ in (("multigrid", "slice 3"), ("jacobi", "slice 4"), ("dst_fft", "slice 4")):
        with pytest.raises(NotImplementedError, match=slice_):
            TS.get_solver(name)
    with pytest.raises(ValueError, match="unknown"):
        TS.get_solver("lu")
    assert TS.auto_solver_name((3, 1548, 2396)) == "dst_gemm"
    assert TS.auto_solver_name((3, 3000, 3000)) == "multigrid"
    assert TS.auto_solver_name((3, 20, 30), crossover=100) == "multigrid"
    # "auto" is resolved by the engine per geometry, never fetched as a solver
    with pytest.raises(ValueError, match="unknown"):
        TS.get_solver("auto")
