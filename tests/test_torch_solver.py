"""The port's DST-GEMM solver against the JAX package's, on the CPU: the host
DST bases bit-equal, the solves within float32 rounding (relative max error
< 1e-5: the GEMMs sum in another order than XLA)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seamlesscloneoptimization_tpu.solvers import dst_gemm as JD
from seamlesscloneoptimization_tpu_torch import solvers as TS
from seamlesscloneoptimization_tpu_torch.ops import kernels as K
from seamlesscloneoptimization_tpu_torch.solvers import dst_gemm as TD

# Several pytest-xdist workers share the cores: one intra-op thread each keeps
# torch's OpenMP pools from oversubscribing them (it cut this suite's CPU time
# about 3.5x). Results do not depend on it.
torch.set_num_threads(1)


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
    bh, bw = TD.dst_bases(61, 93, 128, 128, torch.device("cpu"))
    assert np.array_equal(bh.mats[0].numpy(), JD.dst_matrix_padded(61, 128))
    assert np.array_equal(bw.lam.numpy(), JD.dst_eigenvalues_padded(93, 128))


def test_fold_pays_is_false_until_the_pair_chain():
    """fold_pays is False up to 128 px and True above, where the folded
    chains begin; the pair chain needs both sides above 128."""
    assert not any(TD.fold_pays(n) for n in (1, 61, 127, 128))
    assert all(TD.fold_pays(n) for n in (129, 130, 1548, 2396, 4000))
    assert TD.pair_chain_applies(1548, 2396)
    assert not TD.pair_chain_applies(124, 2398) and not TD.pair_chain_applies(2398, 124)


@pytest.mark.parametrize("hw, calls", [
    ((61, 93), {"transpose": 3}),                             # neither axis folds
    ((130, 61), {"fold_minor": 1, "transpose_pair": 1,        # h only
                 "transpose": 1, "unfold_transpose": 1}),
    ((61, 130), {"fold_minor": 1, "transpose": 2,             # w only
                 "transpose_pair": 1, "unfold_minor": 1}),
    ((200, 300), {"fold_minor": 2, "transpose_pair": 3,       # the pair chain
                  "unfold_transpose": 2, "unfold_minor": 1}),
])
def test_folded_axes_follow_fold_pays(monkeypatch, hw, calls):
    """solve_dst_gemm_pl folds exactly the axes where folded and fold_pays:
    the pair chain when both fold, else per axis, a folded axis joined
    through the pair chain's kernels; folded=False never folds. return_parts
    holds wherever w folds (parts_apply) and skips the last unfold."""
    seen = {}

    def counting(name):
        orig = getattr(TD, name)

        def f(*a, **k):
            seen[name] = seen.get(name, 0) + 1
            return orig(*a, **k)
        return f

    for name in ("fold_minor", "unfold_minor", "transpose_pair", "unfold_transpose",
                 "transpose"):
        monkeypatch.setattr(TD, name, counting(name))
    h2, w2 = hw
    g_tp = torch.zeros((3, K.ru128(w2), K.ru128(h2)))
    assert TD.solve_dst_gemm_pl(g_tp, h2, w2, folded=True).shape == (3, K.ru128(h2),
                                                                      K.ru128(w2))
    assert seen == calls
    seen.clear()
    TD.solve_dst_gemm_pl(g_tp, h2, w2, folded=False)
    assert seen == {"transpose": 3}
    if TD.parts_apply(w2, True):
        seen.clear()
        e_w, o_w = TD.solve_dst_gemm_pl(g_tp, h2, w2, folded=True, return_parts=True)
        assert e_w.shape == o_w.shape == (3, K.ru128(h2), K.ru128((w2 + 1) // 2))
        assert seen == {k: v for k, v in calls.items() if k != "unfold_minor"}
    else:
        with pytest.raises(ValueError, match="folded w axis"):
            TD.solve_dst_gemm_pl(g_tp, h2, w2, folded=True, return_parts=True)
    with pytest.raises(ValueError, match="folded w axis"):
        TD.solve_dst_gemm_pl(g_tp, h2, w2, folded=False, return_parts=True)
    if len(calls) > 1:  # unfolded bases cannot drive an axis that folds
        with pytest.raises(ValueError, match="bases do not match"):
            TD.solve_dst_gemm_pl(g_tp, h2, w2, folded=True,
                                 bases=TD.dst_bases(h2, w2, K.ru128(h2), K.ru128(w2), "cpu"))


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
    # folded=True (h folds at 130) solves the same system within rounding
    folded = TD.solve_dst_gemm_pl(torch.from_numpy(g_tp), h2, w2, precision="high",
                                  folded=True).numpy()
    assert _rel(folded[:, :h2, :w2], got[:, :h2, :w2]) < 1e-5
    assert np.abs(folded[pad]).max() < 1e-4 * scale
    # and it solves the same system as the plain solver
    plain = TD.solve_dst_gemm(torch.from_numpy(g)).numpy()
    assert _rel(got[:, :h2, :w2], plain) < 1e-5


@pytest.mark.parametrize("hw", [(61, 93), (130, 61), (61, 130), (200, 300), (257, 301)])
def test_solve_dst_gemm_pl_folded_matches_jax(hw):
    """The folded chain against JAX's Pallas-fold chain in interpret mode:
    neither axis, h only, w only, the pair chain, the pair chain odd."""
    h2, w2 = hw
    hp, wp = K.ru128(h2), K.ru128(w2)
    g_tp = np.zeros((3, wp, hp), np.float32)
    g_tp[:, :w2, :h2] = np.random.default_rng(h2 + w2).normal(
        size=(3, w2, h2)).astype(np.float32) * 50
    want = np.asarray(JD.solve_dst_gemm_pl(jnp.asarray(g_tp), h2=h2, w2=w2, folded=True,
                                           pallas_fold=True, interpret=True))
    got = TD.solve_dst_gemm_pl(torch.from_numpy(g_tp), h2, w2, folded=True).numpy()
    assert got.shape == want.shape == (3, hp, wp)
    scale = np.abs(want).max()
    assert _rel(got[:, :h2, :w2], want[:, :h2, :w2]) < 1e-5
    pad = np.ones(got.shape, bool)
    pad[:, :h2, :w2] = False
    assert np.abs(got[pad]).max() < 1e-4 * scale
    if TD.pair_chain_applies(h2, w2):
        want_p = JD.solve_dst_gemm_pl(jnp.asarray(g_tp), h2=h2, w2=w2, folded=True,
                                      pallas_fold=True, interpret=True, return_parts=True)
        got_p = TD.solve_dst_gemm_pl(torch.from_numpy(g_tp), h2, w2, folded=True,
                                     return_parts=True)
        for g_, w_ in zip(got_p, want_p):
            assert g_.shape == w_.shape == (3, hp, K.ru128((w2 + 1) // 2))
            assert _rel(g_.numpy(), w_) < 1e-5


@pytest.mark.parametrize("kw", [{"folded": True}, {"folded": True, "transposed_output": True},
                                {"folded": True, "transposed_input": True},
                                {"folded": True, "transform_only": True}])
def test_solve_dst_gemm_folded_matches_jax(kw):
    """The plain folded solver where both axes fold (140 x 261), in all three
    orientations; transform_only keeps the natural-order spectrum."""
    g = np.random.default_rng(5).normal(size=(3, 140, 261)).astype(np.float32) * 50
    if kw.get("transposed_input"):
        g = np.ascontiguousarray(g.transpose(0, 2, 1))
    want = np.asarray(JD.solve_dst_gemm(jnp.asarray(g), **kw))
    got = TD.solve_dst_gemm(torch.from_numpy(g), **kw).numpy()
    assert got.shape == want.shape
    assert _rel(got, want) < 1e-5


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
    """Every mode of the JAX package runs (held against it in
    tests/test_torch_precision_modes.py); a two-pass mode in the plain solve
    and an unknown name raise ValueError."""
    g = torch.from_numpy(np.random.default_rng(6).normal(size=(3, 8, 8)).astype(np.float32))
    fp32 = TD.solve_dst_gemm(g, precision="highest")
    default = TD.solve_dst_gemm(g, precision="default")
    assert default.shape == fp32.shape and not torch.equal(default, fp32)
    assert (default - fp32).abs().max() <= 2.0 ** -6 * fp32.abs().max()
    g_tp = torch.zeros((3, 128, 128))
    g_tp[:, :8, :8] = g.transpose(1, 2)
    u = TD.solve_dst_gemm_pl(g_tp, 8, 8, precision="2x_v")
    assert (u[:, :8, :8] - fp32).abs().max() <= 2.0 ** -6 * fp32.abs().max()
    with pytest.raises(ValueError, match="precision"):
        TD.solve_dst_gemm(g, precision="2x_v")
    with pytest.raises(ValueError, match="precision"):
        TD.solve_dst_gemm_pl(g_tp, 8, 8, precision="bf16_3x")


def test_solver_registry():
    assert TS.get_solver("dst_gemm") is TS.solve_dst_gemm
    assert TS.get_solver("multigrid") is TS.solve_multigrid
    assert TS.get_solver("jacobi") is TS.solve_redblack
    assert TS.get_solver("dst_fft") is TS.solve_dst_fft
    assert set(TS.SOLVERS) == {"dst_gemm", "dst_fft", "jacobi", "multigrid"}
    with pytest.raises(ValueError, match="unknown"):
        TS.get_solver("lu")
    assert TS.auto_solver_name((3, 1548, 2396)) == "dst_gemm"
    assert TS.auto_solver_name((3, 3000, 3000)) == "multigrid"
    assert TS.auto_solver_name((3, 20, 30), crossover=100) == "multigrid"
    # "auto" is resolved by the engine per geometry, never fetched as a solver
    with pytest.raises(ValueError, match="unknown"):
        TS.get_solver("auto")
