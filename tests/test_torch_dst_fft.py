"""The port's DST-FFT solver against the JAX package's on the CPU.

Both run an FFT of the odd extension (XLA's and torch's), in different
summation orders: the solves agree to rel 1e-5 of max |u|; against the
port's own DST-GEMM solve, JAX's cross-check bar of rel 1e-4
(``tests/test_solvers.py:44-49``). Inputs are numpy-seeded.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seamlesscloneoptimization_tpu.solvers import dst_fft as JF
from seamlesscloneoptimization_tpu_torch.solvers import dst_fft as TF
from seamlesscloneoptimization_tpu_torch.solvers import get_solver, solve_dst_gemm
from seamlesscloneoptimization_tpu_torch.solvers import dst_gemm as TD
from seamlesscloneoptimization_tpu_torch.solvers.dst_gemm import dst_matrix

# Several pytest-xdist workers share the cores: one intra-op thread each keeps
# torch's OpenMP pools from oversubscribing them (it cut this suite's CPU time
# about 3.5x). Results do not depend on it.
torch.set_num_threads(1)


def _rand(shape, seed, scale=50.0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32) * scale


@pytest.mark.parametrize("shape", [(3, 61, 90), (2, 128, 257)])
def test_solve_dst_fft_matches_jax_and_dst_gemm(shape):
    g = _rand(shape, shape[1])
    want = np.asarray(JF.solve_dst_fft(jnp.asarray(g)))
    got = TF.solve_dst_fft(torch.from_numpy(g))
    assert got.shape == shape and got.dtype == torch.float32 and got.is_contiguous()
    scale = np.abs(want).max()
    assert np.abs(got.numpy() - want).max() <= 1e-5 * scale
    gemm = solve_dst_gemm(torch.from_numpy(g)).numpy()
    assert np.abs(got.numpy() - gemm).max() <= 1e-4 * np.abs(gemm).max()
    assert get_solver("dst_fft") is TF.solve_dst_fft


@pytest.mark.parametrize("n", [1, 7, 61, 130])
def test_dst1_is_orthonormal(n):
    """dst1_lastaxis is the orthonormal DST-I matrix (its own inverse), and
    dst1_2d applies it on both axes, as JAX's does."""
    x = _rand((2, 5, n), n)
    t = TF.dst1_lastaxis(torch.from_numpy(x))
    np.testing.assert_allclose(t.numpy(), x @ dst_matrix(n), rtol=1e-4,
                               atol=1e-5 * np.abs(x).max() * np.sqrt(n))
    back = TF.dst1_lastaxis(t).numpy()
    assert np.abs(back - x).max() <= 1e-5 * np.abs(x).max() * max(1.0, np.sqrt(n) / 4)
    x2 = _rand((2, n + 3, n), n + 1)
    want = np.asarray(JF.dst1_2d(jnp.asarray(x2)))
    got = TF.dst1_2d(torch.from_numpy(x2)).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("solve", ["dst_fft", "gemm_t", "gemm_t_folded"])
def test_plain_solves_upload_their_constants_once(solve):
    """A second solve of the same shape makes no new device constant (the
    eigenvalue sum and the DST factors are cached per shape and device) and
    returns the first solve's result: nothing mutates the cached tensors."""
    run = {"dst_fft": TF.solve_dst_fft,
           "gemm_t": lambda g: solve_dst_gemm(g, transposed_output=True),
           "gemm_t_folded": lambda g: solve_dst_gemm(g, transposed_output=True,
                                                     folded=True)}[solve]
    g = torch.from_numpy(_rand((2, 150, 139), 11))
    first = run(g)
    caches = (TD.eig_sum_on, TD._dst_matrix_on, TD._folded_mats)
    misses = [f.cache_info().misses for f in caches]
    second = run(g)
    assert [f.cache_info().misses for f in caches] == misses
    assert torch.equal(first, second)
