"""Exact Poisson solve in the DST eigenbasis via batched GEMMs.

Port of ``seamlesscloneoptimization_tpu/solvers/dst_gemm.py`` (ref cuBLAS
solver, seamlessClone_imp.cpp:1322-1334). With the orthonormal symmetric
DST-I matrix ``V_n[i,j] = sin((i+1)(j+1)pi/(n+1)) * sqrt(2/(n+1))`` and
eigenvalues ``lam_k = 2(cos((k+1)pi/(n+1)) - 1)``,
``u = Vh @ ((Vh @ g @ Vw) / (lam_i + lam_j)) @ Vw`` per channel.

The GEMMs are plain ``torch.matmul`` in FP32: the port sets neither
``allow_tf32`` nor ``set_float32_matmul_precision``. ``precision="high"``
(bf16_3x on the TPU) and ``"highest"`` both map to FP32 here.

Folding: the JAX package's even/odd-folded transforms (half the GEMM FLOPs)
are ROADMAP slice 2. An axis folds where ``folded and fold_pays(n)``
(``check_fold``); until slice 2 the port's ``fold_pays`` is False, so
``folded=True`` runs the unfolded chain — exactly what the JAX package runs
wherever its own ``fold_pays`` is false; the results agree within float32
rounding.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from seamlesscloneoptimization_tpu_torch.ops.kernels import transpose

PRECISIONS = ("highest", "high")  # both FP32 on the card


def _frozen(a: np.ndarray) -> np.ndarray:
    a.setflags(write=False)  # lru_cache hands the same array to every caller
    return a


@lru_cache(maxsize=64)
def dst_matrix(n: int) -> np.ndarray:
    """Orthonormal DST-I matrix, (n, n) f32, computed in f64 on the host."""
    i = np.arange(1, n + 1, dtype=np.float64)
    return _frozen((np.sin(np.outer(i, i) * (np.pi / (n + 1))) * np.sqrt(2.0 / (n + 1))).astype(
        np.float32
    ))


@lru_cache(maxsize=256)
def dst_eigenvalues(n: int) -> np.ndarray:
    """Eigenvalues 2(cos(k pi/(n+1)) - 1), k = 1..n, (n,) f32."""
    k = np.arange(1, n + 1, dtype=np.float64)
    return _frozen((2.0 * (np.cos(k * np.pi / (n + 1)) - 1.0)).astype(np.float32))


@lru_cache(maxsize=64)
def dst_matrix_padded(n: int, n_pad: int) -> np.ndarray:
    """dst_matrix(n) zero-padded to (n_pad, n_pad): every GEMM of the padded
    chain stays exact, the padding only ever meets the operand's zeros."""
    v = np.zeros((n_pad, n_pad), np.float32)
    v[:n, :n] = dst_matrix(n)
    return _frozen(v)


@lru_cache(maxsize=256)
def dst_eigenvalues_padded(n: int, n_pad: int) -> np.ndarray:
    """dst_eigenvalues(n) padded to n_pad with 1e9: a padding lane divides
    0 by a sum of at least 1e9 - 4, never 0/0."""
    lam = np.full(n_pad, 1e9, np.float32)
    lam[:n] = dst_eigenvalues(n)
    return _frozen(lam)


def fold_pays(n: int) -> bool:
    """Whether the folded transform runs for axis size n: never, until the
    folded pair chain is ported (ROADMAP slice 2)."""
    return False


def check_fold(folded: bool, *sizes: int) -> None:
    """The per-axis fold decision of the JAX package's ``axis_ops``: an axis
    of size n folds where ``folded and fold_pays(n)``. The folded transforms
    are ROADMAP slice 2, so such an axis raises; every other axis runs the
    unfolded transform."""
    for n in sizes:
        if folded and fold_pays(n):
            raise NotImplementedError(
                f"the folded DST transform (axis size {n}) is not ported yet: "
                "ROADMAP slice 2")


def check_precision(precision: str) -> None:
    if precision not in PRECISIONS:
        raise NotImplementedError(
            f"precision={precision!r} is not ported: {PRECISIONS} run FP32")


def _t(a: np.ndarray, device) -> torch.Tensor:
    return torch.tensor(a, device=device)


def dst_bases(h2: int, w2: int, hp: int, wp: int, device):
    """Device copies (Vh, Vw, lam_h, lam_w) of the padded bases for an
    (h2, w2) interior on an (hp, wp) slab. The engine caches them per shape,
    so a serve frame uploads nothing."""
    return (_t(dst_matrix_padded(h2, hp), device), _t(dst_matrix_padded(w2, wp), device),
            _t(dst_eigenvalues_padded(h2, hp), device),
            _t(dst_eigenvalues_padded(w2, wp), device))


def solve_dst_gemm_pl(g_tp: torch.Tensor, h2: int, w2: int,
                      precision: str = "highest", folded: bool = False,
                      bases=None) -> torch.Tensor:
    """DST solve in PADDED space with the ``transpose`` kernel between GEMMs.

    In: g_tp (C, WP, HP) f32, the transposed RHS at the origin of a slab
    that is exactly zero elsewhere (``preprocess_rhs_t``). Out: (C, HP, WP)
    f32, the natural-orientation solution at the origin; the padding comes
    out (near) zero. Each GEMM is a right-multiply of the slab by a
    zero-padded V, so nothing is sliced or re-padded between stages; the
    middle transpose divides by the 1e9-padded eigenvalue sums.
    ``folded``: fold the axes where ``fold_pays`` (``check_fold``); until
    slice 2 that is none, and this unfolded chain runs.
    ``bases``: ``dst_bases(h2, w2, HP, WP, device)``, or None to build them.
    """
    check_precision(precision)
    check_fold(folded, h2, w2)
    c, wp, hp = g_tp.shape
    vh, vw, lam_h, lam_w = bases if bases is not None else dst_bases(
        h2, w2, hp, wp, g_tp.device)
    s1 = torch.matmul(g_tp, vh)                    # (C,WP,HP) = (Vh G)^T
    tr1 = transpose(s1)                            # (C,HP,WP) = Vh G
    s2 = torch.matmul(tr1, vw)                     # (C,HP,WP) = ghat
    tr2 = transpose(s2, lam_a=lam_h, lam_b=lam_w)  # (C,WP,HP) = uhat^T
    s4 = torch.matmul(tr2, vh)                     # (C,WP,HP) = (Vh uhat)^T
    tr3 = transpose(s4)                            # (C,HP,WP) = Vh uhat
    return torch.matmul(tr3, vw)                   # (C,HP,WP) = u (padded)


def solve_dst_gemm(
    g: torch.Tensor,
    transform_only: bool = False,
    precision: str = "highest",
    transposed_output: bool = False,
    transposed_input: bool = False,
    folded: bool = False,
) -> torch.Tensor:
    """Solve A u = g for g: (C, H, W) f32 via 4 batched GEMMs (plain torch).

    ``transposed_input=True``: g arrives as (C, W, H) and the output is
    transposed too. ``transposed_output=True``: the output is (C, W, H).
    ``transform_only`` returns the spectrum Vh g Vw. ``folded``: fold the
    axes where ``fold_pays`` (``check_fold``; ignored for the natural-order
    spectrum of ``transform_only``, as in the JAX package).
    """
    check_precision(precision)
    transposed = transposed_input or transposed_output
    if transposed or not transform_only:
        check_fold(folded, *g.shape[1:])
    dev = g.device
    if transposed:
        g_t = g if transposed_input else g.transpose(1, 2)
        _, w, h = g_t.shape
        vh, vw = _t(dst_matrix(h), dev), _t(dst_matrix(w), dev)
        lam_t = _t(dst_eigenvalues(w)[:, None] + dst_eigenvalues(h)[None, :], dev)
        ghat_t = torch.matmul(torch.matmul(vw, g_t), vh)
        return torch.matmul(torch.matmul(vw, ghat_t / lam_t), vh)
    _, h, w = g.shape
    vh, vw = _t(dst_matrix(h), dev), _t(dst_matrix(w), dev)
    ghat = torch.matmul(torch.matmul(vh, g), vw)
    if transform_only:
        return ghat
    lam = _t(dst_eigenvalues(h)[:, None] + dst_eigenvalues(w)[None, :], dev)
    return torch.matmul(torch.matmul(vh, ghat / lam), vw)
