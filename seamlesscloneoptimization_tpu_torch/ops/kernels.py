"""The four hand-written CUDA kernels of the DST-GEMM serve path, with their
plain PyTorch twins and launch counters.

The port's counterpart of ``seamlesscloneoptimization_tpu/ops/pallas_kernels.py``
for ROADMAP slice 1:

============================  =============================================
wrapper                       replaces (pallas_kernels.py)
============================  =============================================
``erode3``                    ``erode3_pallas``
``preprocess_rhs_t``          ``preprocess_rhs_transposed_pallas``
``transpose``                 ``transpose_pallas`` (with the fused divide)
``clamp_cast_paste``          ``clamp_cast_guarded_pallas`` +
                              ``paste_interior_pallas``, ``clamp_cast_pallas``
============================  =============================================

Each wrapper checks device, dtype, shape and layout, allocates its output
with ``torch.empty``, launches on the current stream and raises when the
launch returns a non-zero ``cudaError_t``. Given a CPU tensor it runs its
``*_plain`` twin instead — only then: a CUDA tensor launches the kernel or
raises, never falls back. ``LAUNCHES[name]`` counts kernel launches (the
twins do not count), so a run can show that it went through the kernels.
The sources are ``csrc/<name>.cu``, built by ``ops/_build.py``.
"""

from __future__ import annotations

import torch

from seamlesscloneoptimization_tpu_torch.ops._build import kernel_function
from seamlesscloneoptimization_tpu_torch.ops.guidance import guidance_field
from seamlesscloneoptimization_tpu_torch.ops.mask import erode3x3
from seamlesscloneoptimization_tpu_torch.ops.postprocess import clamp_truncate_u8
from seamlesscloneoptimization_tpu_torch.ops.rhs import poisson_rhs

LAUNCHES = {"erode3": 0, "preprocess_rhs_t": 0, "transpose": 0,
            "clamp_cast_paste": 0}

_MIXED_RULES = {"opencv": 0, "norm": 1}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def ru128(n: int) -> int:
    return (n + 127) // 128 * 128


def _require(t: torch.Tensor, what: str, dtype: torch.dtype, ndim: int,
             contiguous: bool = True) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{what} must be a torch.Tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{what} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{what} must have {ndim} dims, got shape {tuple(t.shape)}")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} is on unsupported device {t.device}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


def _same_device(ref: torch.Tensor, *others: torch.Tensor) -> None:
    for o in others:
        if o.device != ref.device:
            raise ValueError(f"tensors on different devices: {ref.device} and {o.device}")


def _launch(name: str, t: torch.Tensor, *args) -> None:
    """Launch kernel ``name`` on ``t``'s device and current stream."""
    with torch.cuda.device(t.device):
        stream = torch.cuda.current_stream(t.device).cuda_stream
        rc = kernel_function(name)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError_t {rc}")
    LAUNCHES[name] += 1


# ---------------------------------------------------------------------------
# erode3
# ---------------------------------------------------------------------------


def erode3_plain(mask01: torch.Tensor) -> torch.Tensor:
    """Three 3x3 erosions with a zero border of a {0,1} u8 mask."""
    return erode3x3(mask01)


def erode3(mask01: torch.Tensor) -> torch.Tensor:
    """(H, W) u8 {0,1} mask -> 3x-eroded {0,1} u8 (one 7x7 min, zero border)."""
    _require(mask01, "mask01", torch.uint8, 2)
    if mask01.device.type == "cpu":
        return erode3_plain(mask01)
    h, w = mask01.shape
    out = torch.empty_like(mask01)
    _launch("erode3", mask01, mask01.data_ptr(), out.data_ptr(), h, w)
    return out


# ---------------------------------------------------------------------------
# preprocess_rhs_t
# ---------------------------------------------------------------------------


def preprocess_rhs_t_plain(dest: torch.Tensor, patch: torch.Tensor,
                           mask_eroded: torch.Tensor, flags: int = 1,
                           mixed_rule: str = "opencv") -> torch.Tensor:
    """guidance_field -> poisson_rhs, transposed to the origin of a zero slab."""
    c, h, w = dest.shape
    dest_f = dest.to(torch.float32)
    gx, gy = guidance_field(dest_f, patch.to(torch.float32), mask_eroded * 255,
                            flags, mixed_rule)
    g = poisson_rhs(gx, gy, dest_f)
    out = torch.zeros((c, ru128(w - 2), ru128(h - 2)), dtype=torch.float32,
                      device=dest.device)
    out[:, : w - 2, : h - 2] = g.transpose(1, 2)
    return out


def preprocess_rhs_t(dest: torch.Tensor, patch: torch.Tensor,
                     mask_eroded: torch.Tensor, flags: int = 1,
                     mixed_rule: str = "opencv") -> torch.Tensor:
    """Fused guidance + divergence + Dirichlet fold, transposed and padded.

    dest, patch: (C, H, W) u8 (any non-negative strides: a view into the
    destination, or a broadcast gray patch); mask_eroded: (H, W) u8 {0,1}
    contiguous. flags: 1 NORMAL or 2 MIXED (MONOCHROME passes its gray patch
    with flags 1). Returns (C, ru128(W-2), ru128(H-2)) f32: the transposed
    interior RHS at the origin, exact zeros elsewhere.
    """
    _require(dest, "dest", torch.uint8, 3, contiguous=False)
    _require(patch, "patch", torch.uint8, 3, contiguous=False)
    _require(mask_eroded, "mask_eroded", torch.uint8, 2)
    _same_device(dest, patch, mask_eroded)
    c, h, w = dest.shape
    if patch.shape != dest.shape or mask_eroded.shape != (h, w):
        raise ValueError(f"shape mismatch: dest {tuple(dest.shape)}, patch "
                         f"{tuple(patch.shape)}, mask {tuple(mask_eroded.shape)}")
    if h < 3 or w < 3:
        raise ValueError(f"ROI {h}x{w} has no interior")
    if flags not in (1, 2):
        raise ValueError(f"kernel flags must be 1 or 2, got {flags}")
    if mixed_rule not in _MIXED_RULES:
        raise ValueError(f"unknown mixed_rule {mixed_rule!r}")
    if min(dest.stride()) < 0 or min(patch.stride()) < 0:
        raise ValueError("negative strides are not supported")
    if dest.device.type == "cpu":
        return preprocess_rhs_t_plain(dest, patch, mask_eroded, flags, mixed_rule)
    wpo, hpo = ru128(w - 2), ru128(h - 2)
    out = torch.empty((c, wpo, hpo), dtype=torch.float32, device=dest.device)
    _launch("preprocess_rhs_t", dest,
            dest.data_ptr(), *dest.stride(), patch.data_ptr(), *patch.stride(),
            mask_eroded.data_ptr(), out.data_ptr(), c, h, w, wpo, hpo, flags,
            _MIXED_RULES[mixed_rule])
    return out


# ---------------------------------------------------------------------------
# transpose
# ---------------------------------------------------------------------------


def transpose_plain(x: torch.Tensor, lam_a: torch.Tensor | None = None,
                    lam_b: torch.Tensor | None = None) -> torch.Tensor:
    xt = x.transpose(1, 2)
    if lam_a is None:
        return xt.contiguous()
    return xt / (lam_b[:, None] + lam_a[None, :])


def transpose(x: torch.Tensor, lam_a: torch.Tensor | None = None,
              lam_b: torch.Tensor | None = None) -> torch.Tensor:
    """(C, A, B) f32 -> (C, B, A); with ``lam_a`` (A,) and ``lam_b`` (B,)
    also divides: out[c, b, a] = x[c, a, b] / (lam_b[b] + lam_a[a])."""
    _require(x, "x", torch.float32, 3)
    c, a, b = x.shape
    if (lam_a is None) != (lam_b is None):
        raise ValueError("lam_a and lam_b go together")
    if lam_a is not None:
        _require(lam_a, "lam_a", torch.float32, 1)
        _require(lam_b, "lam_b", torch.float32, 1)
        _same_device(x, lam_a, lam_b)
        if lam_a.shape[0] != a or lam_b.shape[0] != b:
            raise ValueError(f"eigenvalue lengths {lam_a.shape[0]}, {lam_b.shape[0]} "
                             f"!= ({a}, {b})")
    if x.device.type == "cpu":
        return transpose_plain(x, lam_a, lam_b)
    out = torch.empty((c, b, a), dtype=torch.float32, device=x.device)
    _launch("transpose", x, x.data_ptr(), out.data_ptr(),
            None if lam_a is None else lam_a.data_ptr(),
            None if lam_b is None else lam_b.data_ptr(), c, a, b)
    return out


# ---------------------------------------------------------------------------
# clamp_cast_paste
# ---------------------------------------------------------------------------


def clamp_cast_paste_plain(u: torch.Tensor, dst: torch.Tensor, top1: int,
                           left1: int, h2: int, w2: int) -> torch.Tensor:
    dst[:, top1 : top1 + h2, left1 : left1 + w2] = clamp_truncate_u8(u[:, :h2, :w2])
    return dst


def clamp_cast_paste(u: torch.Tensor, dst: torch.Tensor, top1: int, left1: int,
                     h2: int, w2: int) -> torch.Tensor:
    """Clamp u[:, :h2, :w2] to [0, 255], truncate to u8 and write it in place
    into ``dst`` at (top1, left1). ``dst`` is a (C, H, W) u8 view with any
    positive strides: the planar serve buffer, or ``img.permute(2, 0, 1)``
    of an interleaved image. Returns ``dst``."""
    _require(u, "u", torch.float32, 3)
    _require(dst, "dst", torch.uint8, 3, contiguous=False)
    _same_device(u, dst)
    c, hu, wu = u.shape
    cd, hd, wd = dst.shape
    top1, left1, h2, w2 = int(top1), int(left1), int(h2), int(w2)
    if cd != c or h2 > hu or w2 > wu or h2 < 0 or w2 < 0:
        raise ValueError(f"u {tuple(u.shape)} cannot fill ({cd}, {h2}, {w2})")
    if top1 < 0 or left1 < 0 or top1 + h2 > hd or left1 + w2 > wd:
        raise ValueError(f"interior ({top1},{left1})+({h2}x{w2}) outside "
                         f"destination {(hd, wd)}")
    if min(dst.stride()) < 1:
        raise ValueError("dst strides must be positive")
    if u.device.type == "cpu":
        return clamp_cast_paste_plain(u, dst, top1, left1, h2, w2)
    _launch("clamp_cast_paste", u, u.data_ptr(), c, hu, wu, dst.data_ptr(),
            *dst.stride(), top1, left1, h2, w2)
    return dst
