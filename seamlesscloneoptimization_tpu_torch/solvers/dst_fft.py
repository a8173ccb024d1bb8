"""Exact Poisson solve via FFT-based DST (odd extension).

Port of ``seamlesscloneoptimization_tpu/solvers/dst_fft.py`` (ref cuFFT
path, seamlessClone_imp.cpp:1694-1918). DST-I of x[0..n-1] along an axis,
via the odd extension ``y = [0, x0..x_{n-1}, 0, -x_{n-1}..-x0]`` (length
2n+2): ``DST(x)[k-1] = -imag(rfft(y)[k]) / 2`` for k = 1..n, times
sqrt(2/(n+1)) for the orthonormal scaling, so the transform is its own
inverse. ``u = DST2(DST2(g) / (lam_i + lam_j))`` per channel, with the
eigenvalues of ``solvers/dst_gemm.py:dst_eigenvalues``
(``eig_sum_on``: on the device once per shape).

The JAX package has no Pallas kernel here: XLA ran the FFT. So the port runs
it with ``torch.fft.rfft`` (cuFFT on the card), a library FFT and not a
kernel port, with the packing and the extraction as torch ops around it.
"""

from __future__ import annotations

import numpy as np
import torch

from seamlesscloneoptimization_tpu_torch.solvers.dst_gemm import eig_sum_on


def dst1_lastaxis(x: torch.Tensor) -> torch.Tensor:
    """Orthonormal DST-I along the last axis via rfft of the odd extension."""
    n = x.shape[-1]
    zeros = x.new_zeros(x.shape[:-1] + (1,))
    y = torch.cat([zeros, x, zeros, -torch.flip(x, (-1,))], dim=-1)  # (..., 2n+2)
    spec = torch.fft.rfft(y, dim=-1)  # (..., n+2)
    scale = float(np.float32(0.5) * np.sqrt(np.float32(2.0 / (n + 1))))  # f32, as in JAX
    return (-spec.imag[..., 1 : n + 1]) * scale


def dst1_2d(x: torch.Tensor) -> torch.Tensor:
    """Orthonormal 2-D DST-I over the last two axes of (C, H, W)."""
    x = dst1_lastaxis(x)
    x = dst1_lastaxis(x.transpose(-1, -2))
    return x.transpose(-1, -2)


def solve_dst_fft(g: torch.Tensor) -> torch.Tensor:
    """Solve A u = g for g: (C, H, W) f32 via forward / inverse FFT-DST.
    Returns a contiguous (C, H, W) f32 tensor."""
    _, h, w = g.shape
    uhat = dst1_2d(g) / eig_sum_on(h, w, g.device)  # uploaded once per (h, w, device)
    return dst1_2d(uhat).contiguous()  # DST-I is its own inverse (orthonormal)
