"""Exact Poisson solve in the DST eigenbasis via batched GEMMs.

Port of ``seamlesscloneoptimization_tpu/solvers/dst_gemm.py`` (ref cuBLAS
solver, seamlessClone_imp.cpp:1322-1334). With the orthonormal symmetric
DST-I matrix ``V_n[i,j] = sin((i+1)(j+1)pi/(n+1)) * sqrt(2/(n+1))`` and
eigenvalues ``lam_k = 2(cos((k+1)pi/(n+1)) - 1)``,
``u = Vh @ ((Vh @ g @ Vw) / (lam_i + lam_j)) @ Vw`` per channel.

Precision (the JAX package's modes, GEMM by GEMM): ``"highest"`` and
``"high"`` (bf16_3x on the TPU) are plain FP32 ``torch.matmul`` (the port
sets neither ``allow_tf32`` nor ``set_float32_matmul_precision``);
``"default"`` rounds both operands to bf16 once; ``"2x_img"`` splits the
image operand into bf16 hi + lo and rounds the DST factor once; ``"2x_v"``
rounds the image once and splits the factor; ``"fwd2x"`` / ``"inv2x"`` put
the ``"2x_v"`` product on the forward / inverse GEMMs and FP32 on the
others. Every bf16 pass sums its products in FP32 and the two passes of a
split add as hi pass + lo pass (``_mm``). ``solve_dst_gemm_pl`` takes every
mode, ``solve_dst_gemm`` and ``solve_sep_eig`` the single-pass ones
(``PLAIN_PRECISIONS``).

Folding (half the GEMM FLOPs per axis): the DST-I matrix has the reflection
symmetry V[n-1-j, i] = (-1)^i V[j, i], so every even output depends only on
s_j = x_j + x_{n-1-j} and every odd one only on d_j = x_j - x_{n-1-j}. One
n x n GEMM becomes two half-size GEMMs around an elementwise fold; the
inverse combines out_x = E_x + O_x, out_{n-1-x} = E_x - O_x. The spectral
axis stays in grouped order (even block, then odd block) between forward
and inverse, so only the eigenvalue vector changes. An axis of size n folds
where ``folded and fold_pays(n)`` (the JAX package's rule, 128-padding
aware), so both packages take the same branch at every geometry.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from seamlesscloneoptimization_tpu_torch.ops.kernels import (
    fold_halves,
    fold_minor,
    ru128,
    transpose,
    transpose_pair,
    unfold_minor,
    unfold_transpose,
)

# precision -> (the forward GEMMs' product, the inverse GEMMs'): "f32",
# "bf16" (both operands rounded once), "2x_img" or "2x_v" (see _mm)
PRECISION_MODES = {"highest": ("f32", "f32"), "high": ("f32", "f32"),
                   "default": ("bf16", "bf16"), "2x_img": ("2x_img", "2x_img"),
                   "2x_v": ("2x_v", "2x_v"), "fwd2x": ("2x_v", "f32"),
                   "inv2x": ("f32", "2x_v")}
PRECISIONS = tuple(PRECISION_MODES)
PLAIN_PRECISIONS = ("highest", "high", "default")  # the JAX package's _PRECISIONS


def _frozen(a: np.ndarray) -> np.ndarray:
    a.setflags(write=False)  # lru_cache hands the same array to every caller
    return a


def _dst_f64(n: int) -> np.ndarray:
    i = np.arange(1, n + 1, dtype=np.float64)
    return np.sin(np.outer(i, i) * (np.pi / (n + 1))) * np.sqrt(2.0 / (n + 1))


@lru_cache(maxsize=64)
def dst_matrix(n: int) -> np.ndarray:
    """Orthonormal DST-I matrix, (n, n) f32, computed in f64 on the host."""
    return _frozen(_dst_f64(n).astype(np.float32))


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
    """Whether axis size n folds: two half-size 128-padded GEMMs against
    one full-size one (the port pads its slabs to 128 as well)."""
    _, _, ep, op = fold_halves(n)
    return ep * ep + op * op < ru128(n) ** 2


def pair_chain_applies(h2: int, w2: int) -> bool:
    """Whether ``solve_dst_gemm_pl(folded=True)`` runs the folded pair chain
    (both axes fold); otherwise it runs the per-axis route."""
    return fold_pays(h2) and fold_pays(w2)


def parts_apply(w2: int, folded: bool) -> bool:
    """Whether ``solve_dst_gemm_pl(folded=folded)`` can stop before its last
    unfold and return the w axis's halves (``return_parts``): wherever w
    folds, on the pair chain and on the per-axis route. The one gate shared
    with the pipeline, whose ``unfold_clamp_paste`` tail needs those halves."""
    return folded and fold_pays(w2)


@lru_cache(maxsize=64)
def dst_matrices_folded(n: int):
    """Padded folded DST-I factors (Vep, Vop, Ve2p, Vo2p) f32, from f64.

    he = ceil(n/2), ho = n//2, ep/op their 128-roundups:
    Vep (ep, ep)[j, r] = V[j, 2r] (forward even; for odd n row he-1 is the
    self-paired middle element, counted once in the fold),
    Vop (op, op)[j, r] = V[j, 2r+1] (forward odd),
    Ve2p (ep, ep)[r, x] = V[2r, x] (inverse even, x < he),
    Vo2p (op, ep)[r, x] = V[2r+1, x] (inverse odd). Zero elsewhere.
    """
    v = _dst_f64(n)
    he, ho, ep, op = fold_halves(n)
    vep = np.zeros((ep, ep), np.float32)
    vep[:he, :he] = v[:he, 0::2]
    vop = np.zeros((op, op), np.float32)
    vop[:ho, :ho] = v[:ho, 1::2]
    ve2p = np.zeros((ep, ep), np.float32)
    ve2p[:he, :he] = v[0::2, :he]
    vo2p = np.zeros((op, ep), np.float32)
    vo2p[:ho, :he] = v[1::2, :he]
    return tuple(_frozen(m) for m in (vep, vop, ve2p, vo2p))


@lru_cache(maxsize=256)
def dst_eigenvalues_grouped(n: int) -> np.ndarray:
    """dst_eigenvalues(n) in grouped spectral order:
    [even-index eigenvalues | 1e9 to ep | odd-index | 1e9 to op]."""
    he, ho, ep, op = fold_halves(n)
    lam = dst_eigenvalues(n)
    out = np.full(ep + op, 1e9, np.float32)
    out[:he] = lam[0::2]
    out[ep : ep + ho] = lam[1::2]
    return _frozen(out)


def check_precision(precision: str, allowed: tuple = PRECISIONS) -> None:
    if precision not in allowed:
        raise ValueError(f"precision={precision!r} is not one of {allowed}")


def uses_bf16(precision: str) -> bool:
    """Whether a mode runs bf16 passes (and so needs the factors' bf16 forms)."""
    return PRECISION_MODES[precision] != ("f32", "f32")


def _t(a: np.ndarray, device) -> torch.Tensor:
    return torch.tensor(a, device=device)


def _split_bf16(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) bf16 with hi = bf16(x), lo = bf16(x - hi): x to about 2^-17."""
    hi = x.to(torch.bfloat16)
    return hi, (x - hi.float()).to(torch.bfloat16)


def _mm_bf16(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (..., k) @ b (k, n), both bf16, the products summed in FP32, an
    FP32 result. On the card one bf16 GEMM with an FP32 output (cuBLAS,
    FP32 accumulation) on a flattened to 2-D; elsewhere the FP32 product of
    the operands widened back to FP32 (exact: bf16 products fit FP32's
    mantissa), which is what the card's GEMM computes up to the order of
    its sums."""
    if a.device.type == "cuda":
        k = a.shape[-1]
        out = torch.mm(a.reshape(-1, k), b, out_dtype=torch.float32)
        return out.reshape(*a.shape[:-1], b.shape[1])
    return torch.matmul(a.float(), b.float())


def _mm(a: torch.Tensor, v: torch.Tensor, v_bf16, mode: str) -> torch.Tensor:
    """a (..., k) f32 @ the factor v (k, n) f32 in one precision mode.
    ``v_bf16``: v's (hi, lo) bf16 forms (``_split_bf16``), for the bf16
    modes. "f32": FP32; "bf16": a and v rounded once; "2x_img": a's hi pass
    + a's lo pass, v rounded once; "2x_v": a rounded once, v's hi pass +
    v's lo pass (the JAX package's ``_mm_2x``)."""
    if mode == "f32":
        return torch.matmul(a, v)
    v_hi, v_lo = v_bf16
    if mode == "2x_img":
        a_hi, a_lo = _split_bf16(a)
        return _mm_bf16(a_hi, v_hi) + _mm_bf16(a_lo, v_hi)
    a_b = a.to(torch.bfloat16)
    if mode == "bf16":
        return _mm_bf16(a_b, v_hi)
    return _mm_bf16(a_b, v_hi) + _mm_bf16(a_b, v_lo)


@dataclass(frozen=True)
class AxisBasis:
    """Device factors of one axis: size n on an n_pad slab. ``mats`` is
    (Vp,) for the plain transform or (Vep, Vop, Ve2p, Vo2p) where the axis
    folds; ``lam`` the padded, or grouped, eigenvalues; ``bf16`` each
    factor's (hi, lo) bf16 forms for a mode with bf16 passes, else ()."""

    n: int
    n_pad: int
    mats: tuple
    lam: torch.Tensor
    bf16: tuple = ()

    @property
    def folded(self) -> bool:
        return len(self.mats) == 4

    def tensors(self) -> tuple:
        return (*self.mats, self.lam, *(t for pair in self.bf16 for t in pair))


def axis_basis(n: int, n_pad: int, fold: bool, device, precision: str = "highest") -> AxisBasis:
    if fold:
        mats = tuple(_t(m, device) for m in dst_matrices_folded(n))
        lam = _t(dst_eigenvalues_grouped(n), device)
    else:
        mats = (_t(dst_matrix_padded(n, n_pad), device),)
        lam = _t(dst_eigenvalues_padded(n, n_pad), device)
    bf16 = tuple(_split_bf16(m) for m in mats) if uses_bf16(precision) else ()
    return AxisBasis(n, n_pad, mats, lam, bf16)


def dst_bases(h2: int, w2: int, hp: int, wp: int, device, folded: bool = False,
              precision: str = "highest"):
    """(h, w) AxisBasis of an (h2, w2) interior on an (hp, wp) slab, each
    folded where ``folded and fold_pays(n)``, with the factors' bf16 forms
    where ``precision`` runs bf16 passes. The engine caches them per shape,
    so a serve frame uploads and splits nothing."""
    check_precision(precision)
    return (axis_basis(h2, hp, folded and fold_pays(h2), device, precision),
            axis_basis(w2, wp, folded and fold_pays(w2), device, precision))


def solve_dst_gemm_pl(g_tp: torch.Tensor, h2: int, w2: int,
                      precision: str = "highest", folded: bool = False,
                      bases=None, return_parts: bool = False):
    """DST solve in PADDED space with kernels between the GEMMs.

    In: g_tp (C, WP, HP) f32, the transposed RHS at the origin of a slab
    that is exactly zero elsewhere (``preprocess_rhs_t``). Out: (C, HP, WP)
    f32, the natural-orientation solution at the origin; the padding comes
    out (near) zero. Each GEMM is a right-multiply of the slab by a
    zero-padded factor, so nothing is sliced or re-padded between stages.

    Two branches, as in the JAX function, with the same GEMMs and the same
    arithmetic; the per-axis one joins them through the pair chain's fused
    kernels (layout only: the JAX function concatenates and unfolds there):
    - ``folded and pair_chain_applies(h2, w2)``: the pair chain,
      fold_minor -> 2 GEMMs -> transpose_pair -> fold_minor -> 2 GEMMs ->
      transpose_pair(÷) x2 (row windows) -> 2 GEMMs -> unfold_transpose x2
      -> 2 GEMMs -> unfold_minor.
    - otherwise per axis: an axis folds where ``folded and fold_pays(n)``,
      else it is one plain GEMM each way. A folded h runs fold_minor -> 2
      half-GEMMs -> transpose_pair forward and 2 half-GEMMs ->
      unfold_transpose back; a folded w fold_minor -> 2 half-GEMMs ->
      transpose_pair(÷) forward and 2 half-GEMMs -> unfold_minor back; the
      other transposes are ``transpose`` launches, the middle one dividing.
    ``precision`` (any of ``PRECISIONS``) sets each forward GEMM's product
    and each inverse GEMM's (``PRECISION_MODES``, ``_mm``).
    With ``return_parts`` (``parts_apply(w2, folded)``: w folds) either
    branch stops before its last unfold and returns (e_w, o_w), each
    (C, HP, ep_w), for ``unfold_clamp_paste``.
    ``bases``: ``dst_bases(h2, w2, HP, WP, device, folded, precision)``, or
    None to build them.
    """
    check_precision(precision)
    c, wp, hp = g_tp.shape
    bh, bw = (bases if bases is not None
              else dst_bases(h2, w2, hp, wp, g_tp.device, folded, precision))
    want = (h2, hp, folded and fold_pays(h2), w2, wp, folded and fold_pays(w2))
    if (bh.n, bh.n_pad, bh.folded, bw.n, bw.n_pad, bw.folded) != want:
        raise ValueError(f"bases do not match (h2, hp, fold_h, w2, wp, fold_w) = {want}")
    if uses_bf16(precision) and not (bh.bf16 and bw.bf16):
        raise ValueError(f"precision={precision!r} needs bases with the factors' bf16 forms: "
                         f"dst_bases(..., precision={precision!r})")
    fwd_mode, inv_mode = PRECISION_MODES[precision]

    def fwd(a, basis, k):  # a @ the axis's forward factor k (Vp, or Vep / Vop)
        return _mm(a, basis.mats[k], basis.bf16[k] if basis.bf16 else None, fwd_mode)

    def inv(a, basis, k):  # a @ the axis's inverse factor k (Vp, or Ve2p / Vo2p)
        return _mm(a, basis.mats[k], basis.bf16[k] if basis.bf16 else None, inv_mode)

    if bh.folded and bw.folded:
        ep_h, op_h = bh.mats[0].shape[0], bh.mats[1].shape[0]
        ep_w, op_w = bw.mats[0].shape[0], bw.mats[1].shape[0]
        # forward h: fold the minor (H) axis, two half-GEMMs, pair transpose
        s, d = fold_minor(g_tp, h2)
        tr1 = transpose_pair(fwd(s, bh, 0), fwd(d, bh, 1))  # (C,GH,WP)
        # forward w on the transposed slab
        s, d = fold_minor(tr1, w2)
        ge, go = fwd(s, bw, 0), fwd(d, bw, 1)   # (C,GH,ep_w|op_w)
        # spectral divide fused into the transposes back, one per h window
        e_h = inv(transpose_pair(ge, go, bw.lam, bh.lam, 0, ep_h), bh, 2)
        o_h = inv(transpose_pair(ge, go, bw.lam, bh.lam, ep_h, op_h), bh, 3)
        # unfold along h fused into the transposes back, one per w window
        e_w = inv(unfold_transpose(e_h, o_h, h2, hp, 0, ep_w), bw, 2)
        o_w = inv(unfold_transpose(e_h, o_h, h2, hp, ep_w, op_w), bw, 3)
        if return_parts:
            return e_w, o_w
        return unfold_minor(e_w, o_w, w2, wp)

    if return_parts and not bw.folded:
        raise ValueError(f"return_parts needs a folded w axis: parts_apply({w2}, {folded}) "
                         f"is False")
    # forward h: (C,WP,HP) -> tr1 (C,HG,WP) = Vh G
    if bh.folded:
        s, d = fold_minor(g_tp, h2)
        tr1 = transpose_pair(fwd(s, bh, 0), fwd(d, bh, 1))
    else:
        tr1 = transpose(fwd(g_tp, bh, 0))
    # forward w, the spectral divide fused into the transpose back:
    # tr2 (C,WG,HG) = uhat^T
    if bw.folded:
        s, d = fold_minor(tr1, w2)
        tr2 = transpose_pair(fwd(s, bw, 0), fwd(d, bw, 1), bw.lam, bh.lam)
    else:
        tr2 = transpose(fwd(tr1, bw, 0), lam_a=bh.lam, lam_b=bw.lam)
    # inverse h, the unfold fused into the transpose back: tr3 (C,HP,WG) = Vh uhat
    if bh.folded:
        ep_h = bh.mats[2].shape[0]
        tr3 = unfold_transpose(inv(tr2[..., :ep_h], bh, 2), inv(tr2[..., ep_h:], bh, 3), h2, hp)
    else:
        tr3 = transpose(inv(tr2, bh, 0))
    # inverse w: (C,HP,WP) = u (padded)
    if not bw.folded:
        return inv(tr3, bw, 0)
    ep_w = bw.mats[2].shape[0]
    e_w, o_w = inv(tr3[..., :ep_w], bw, 2), inv(tr3[..., ep_w:], bw, 3)
    if return_parts:
        return e_w, o_w
    return unfold_minor(e_w, o_w, w2, wp)


# ---------------------------------------------------------------------------
# The plain folded forms (solve_dst_gemm, the plain pipeline branch)
# ---------------------------------------------------------------------------


# The plain solves' factors, uploaded once per (shape, device): a frame of
# the transposed tail or of solve_dst_fft then uploads nothing. A few shapes'
# worth, so the device memory they hold stays bounded.
@lru_cache(maxsize=8)
def _folded_mats(n: int, device: torch.device) -> tuple:
    return tuple(_t(m, device) for m in dst_matrices_folded(n))


@lru_cache(maxsize=8)
def _dst_matrix_on(n: int, device: torch.device) -> torch.Tensor:
    return _t(dst_matrix(n), device)


@lru_cache(maxsize=8)
def eig_sum_on(nr: int, nc: int, device: torch.device, grouped_r: bool = False,
               grouped_c: bool = False) -> torch.Tensor:
    """lam_r[:, None] + lam_c[None, :] on ``device`` (natural, or grouped
    spectral order on a folded axis), the spectral divisor of an (nr, nc)
    solve."""
    lr = dst_eigenvalues_grouped(nr) if grouped_r else dst_eigenvalues(nr)
    lc = dst_eigenvalues_grouped(nc) if grouped_c else dst_eigenvalues(nc)
    return _t(lr[:, None] + lc[None, :], device)


def dst_fwd_folded_minor(a: torch.Tensor, n: int, mm=torch.matmul) -> torch.Tensor:
    """Folded DST along the minor axis: (..., KP >= n, zero beyond n) ->
    (..., ep + op) spectral in grouped even/odd order (zero-padded)."""
    he, ho, ep, op = fold_halves(n)
    vep, vop, _, _ = _folded_mats(n, a.device)
    head = a[..., :ho]
    tail = torch.flip(a[..., n - ho : n], (-1,))  # a_{n-1-j}, j = 0..ho-1
    s, d = head + tail, head - tail
    if n % 2:
        s = torch.cat([s, a[..., ho : ho + 1]], dim=-1)
    s = F.pad(s, (0, ep - he))
    d = F.pad(d, (0, op - ho))
    return torch.cat([mm(s, vep), mm(d, vop)], dim=-1)


def dst_inv_folded_minor(a: torch.Tensor, n: int, out_pad: int,
                         mm=torch.matmul) -> torch.Tensor:
    """Inverse folded DST along the minor axis: grouped spectral (..., ep+op)
    -> natural (..., out_pad) with exact zeros beyond n."""
    he, ho, ep, op = fold_halves(n)
    _, _, ve2p, vo2p = _folded_mats(n, a.device)
    e = mm(a[..., :ep], ve2p)
    o = mm(a[..., ep : ep + op], vo2p)
    first = (e + o)[..., :he]                                # out_x,       x < he
    second = torch.flip((e - o)[..., :ho], (-1,))            # out_{n-1-x}, x = ho-1..0
    return F.pad(torch.cat([first, second], dim=-1), (0, out_pad - n))


def dst_fwd_folded_rows(a: torch.Tensor, n: int, mm=torch.matmul) -> torch.Tensor:
    """Folded DST along axis -2 (left-multiply): (..., n, M) ->
    (..., ep + op, M) spectral in grouped even/odd order."""
    he, ho, ep, op = fold_halves(n)
    vep, vop, _, _ = _folded_mats(n, a.device)
    head = a[..., :ho, :]
    tail = torch.flip(a[..., n - ho : n, :], (-2,))
    s, d = head + tail, head - tail
    if n % 2:
        s = torch.cat([s, a[..., ho : ho + 1, :]], dim=-2)
    s = F.pad(s, (0, 0, 0, ep - he))
    d = F.pad(d, (0, 0, 0, op - ho))
    return torch.cat([mm(vep.T, s), mm(vop.T, d)], dim=-2)


def dst_inv_folded_rows(a: torch.Tensor, n: int, mm=torch.matmul) -> torch.Tensor:
    """Inverse folded DST along axis -2: grouped spectral (..., ep+op, M) ->
    natural (..., n, M)."""
    he, ho, ep, op = fold_halves(n)
    _, _, ve2p, vo2p = _folded_mats(n, a.device)
    e = mm(ve2p.T, a[..., :ep, :])
    o = mm(vo2p.T, a[..., ep : ep + op, :])
    first = (e + o)[..., :he, :]
    second = torch.flip((e - o)[..., :ho, :], (-2,))
    return torch.cat([first, second], dim=-2)


def _solve_folded(g2: torch.Tensor, nr: int, nc: int, mm=torch.matmul) -> torch.Tensor:
    """Folded solve of the (C, nr, nc) system, each axis folded where
    ``fold_pays``: rows through the left-multiply folds, columns through
    the minor-axis folds, grouped eigenvalues on each folded axis."""
    dev = g2.device
    fr, fc = fold_pays(nr), fold_pays(nc)
    x = dst_fwd_folded_rows(g2, nr, mm) if fr else mm(_dst_matrix_on(nr, dev), g2)
    x = dst_fwd_folded_minor(x, nc, mm) if fc else mm(x, _dst_matrix_on(nc, dev))
    x = x / eig_sum_on(nr, nc, dev, fr, fc)
    x = dst_inv_folded_rows(x, nr, mm) if fr else mm(_dst_matrix_on(nr, dev), x)
    return (dst_inv_folded_minor(x, nc, nc, mm) if fc
            else mm(x, _dst_matrix_on(nc, dev)))


def _plain_mm(precision: str):
    """The GEMM of the plain solves (``solve_dst_gemm``, ``solve_sep_eig``):
    FP32 ``torch.matmul``, or for ``"default"`` the FP32 product of both
    operands rounded to bf16 once (exact products, FP32 sums: what a bf16
    GEMM with FP32 accumulation computes, on any device)."""
    check_precision(precision, PLAIN_PRECISIONS)
    if precision == "default":
        return lambda x, y: torch.matmul(x.to(torch.bfloat16).float(),
                                         y.to(torch.bfloat16).float())
    return torch.matmul


@lru_cache(maxsize=64)
def beta_eigenbasis(n: int, beta: float):
    """Eigenbasis of the 1-D Dirichlet tridiagonal with a short last gap.

    The multigrid coarse levels (``solvers/multigrid.py``) put the right
    wall ``beta * h`` beyond the last point (Shortley-Weller): row n-1 has
    the left coefficient 2/(1+beta) and the diagonal -2/beta instead of
    (1, -2). That T is similar to a symmetric tridiagonal through a
    diagonal scaling, so host float64 ``eigh`` of the symmetric form is
    exact. Returns (lam (n,), V (n, n), Vi (n, n)) f32 with
    T = V diag(lam) Vi; beta == 1 gives the DST (V = Vi = dst_matrix(n)).
    """
    if beta == 1.0:
        return dst_eigenvalues(n), dst_matrix(n), dst_matrix(n)
    a_last = 2.0 / (1.0 + beta)
    d = np.full(n, -2.0)
    d[-1] = -2.0 / beta
    # D T D^-1 with delta_{n-1} = sqrt((1+beta)/2) makes the off-diagonal
    # sqrt(a_last) symmetric
    off = np.ones(n - 1)
    off[-1] = np.sqrt(a_last)
    s = np.diag(d) + np.diag(off, 1) + np.diag(off, -1)
    lam, q = np.linalg.eigh(s)
    delta = np.ones(n)
    delta[-1] = np.sqrt((1.0 + beta) / 2.0)
    v = q / delta[:, None]       # V = D^-1 Q
    vi = q.T * delta[None, :]    # V^-1 = Q^T D
    return tuple(_frozen(a.astype(np.float32)) for a in (lam, v, vi))


def sep_eig_basis(h: int, w: int, bh: float, bw: float, device) -> tuple:
    """Device operands of ``solve_sep_eig`` on an (h, w) grid:
    (Vh^-1, Vw^-T, lam_h[:, None] + lam_w[None, :], Vh, Vw^T)."""
    lh, vh, vhi = beta_eigenbasis(h, round(bh, 9))
    lw, vw, vwi = beta_eigenbasis(w, round(bw, 9))
    return tuple(_t(np.ascontiguousarray(a), device)
                 for a in (vhi, vwi.T, lh[:, None] + lw[None, :], vh, vw.T))


def solve_sep_eig(g: torch.Tensor, bh: float = 1.0, bw: float = 1.0,
                  precision: str = "highest", basis: tuple | None = None) -> torch.Tensor:
    """Exact solve of the beta-modified separable Poisson operator.

    A = Th (x) I + I (x) Tw with Th, Tw from ``beta_eigenbasis``: per
    channel U = Vh ((Vh^-1 G Vw^-T) / (lam_h_i + lam_w_j)) Vw^T, four GEMMs
    (``_plain_mm(precision)``) and a divide (the multigrid's coarsest
    level, FP32). ``basis`` is
    ``sep_eig_basis(h, w, bh, bw, device)`` (the engine caches it on the
    device per geometry), or None: then beta == 1 goes through
    ``solve_dst_gemm`` and any other beta builds the basis.
    """
    mm = _plain_mm(precision)
    _, h, w = g.shape
    if basis is None:
        if bh == 1.0 and bw == 1.0:
            return solve_dst_gemm(g, precision=precision)
        basis = sep_eig_basis(h, w, bh, bw, g.device)
    vhi, vwi_t, lam, vh, vw_t = basis
    x = mm(mm(vhi, g), vwi_t) / lam
    return mm(mm(vh, x), vw_t)


def solve_dst_gemm(
    g: torch.Tensor,
    transform_only: bool = False,
    precision: str = "highest",
    transposed_output: bool = False,
    transposed_input: bool = False,
    folded: bool = False,
) -> torch.Tensor:
    """Solve A u = g for g: (C, H, W) f32 via batched GEMMs (plain torch).

    ``transposed_input=True``: g arrives as (C, W, H) and the output is
    transposed too. ``transposed_output=True``: the output is (C, W, H).
    ``transform_only`` returns the spectrum Vh g Vw. ``folded``: fold each
    axis where ``fold_pays`` (ignored for the natural-order spectrum of
    ``transform_only``, as in the JAX package). ``precision``: one of
    ``PLAIN_PRECISIONS`` (``_plain_mm``); a two-pass mode raises ValueError.
    """
    mm = _plain_mm(precision)
    dev = g.device
    if transposed_input or transposed_output:
        g_t = g if transposed_input else g.transpose(1, 2)
        _, w, h = g_t.shape
        if folded:
            return _solve_folded(g_t, w, h, mm)
        vh, vw = _dst_matrix_on(h, dev), _dst_matrix_on(w, dev)
        ghat_t = mm(mm(vw, g_t), vh)
        return mm(mm(vw, ghat_t / eig_sum_on(w, h, dev)), vh)
    _, h, w = g.shape
    if folded and not transform_only:
        return _solve_folded(g, h, w, mm)
    vh, vw = _dst_matrix_on(h, dev), _dst_matrix_on(w, dev)
    ghat = mm(mm(vh, g), vw)
    if transform_only:
        return ghat
    return mm(mm(vh, ghat / eig_sum_on(h, w, dev)), vw)
