"""The port's hand-written CUDA kernels, with their plain PyTorch twins and
launch counters.

The port's counterpart of ``seamlesscloneoptimization_tpu/ops/pallas_kernels.py``
and ``pallas_mg_quarter.py`` for ROADMAP slices 1 to 4c and 8a:

============================  =============================================
wrapper                       replaces (pallas_kernels.py,
                              pallas_mg_quarter.py)
============================  =============================================
``erode3``                    ``erode3_pallas``
``preprocess_rhs_t``          ``preprocess_rhs_transposed_pallas``
``transpose``                 ``transpose_pallas`` (with the fused divide)
``clamp_cast_paste``          ``clamp_cast_guarded_pallas`` +
                              ``paste_interior_pallas``, ``clamp_cast_pallas``
``fold_minor``                ``fold_minor_pallas``
``unfold_minor``              ``unfold_minor_pallas``
``transpose_pair``            ``transpose_pair_pallas`` (with the divide)
``unfold_transpose``          ``unfold_transpose_pallas``
``unfold_clamp_paste``        ``unfold_clamp_guarded_pallas`` + the paste
``preprocess_rhs_p``          ``preprocess_rhs_padded_pallas`` (and the
                              role of ``preprocess_rhs_pallas``)
``mg_down``                   ``mg_down_pallas`` (padded_io form on
                              ``mg_geometry``'s slab, ``vcycle_p``; its
                              exact-size entry on a padded slab,
                              ``solvers/multigrid.py:vcycle``)
``mg_up``                     ``mg_up_pallas`` (the same two forms)
``mg_restrict_t``             ``mg_restrict_t_pallas``
``mg_prolong_t``              ``mg_prolong_t_pallas``
``mg_down_t``                 ``mg_down_pallas`` + ``mg_restrict_t_pallas``,
                              fused (``vcycle_t``'s descent)
``mg_up_t``                   ``mg_prolong_t_pallas`` + ``mg_up_pallas``,
                              fused (``vcycle_t``'s ascent)
``preprocess_rhs_q``          ``preprocess_rhs_quarters_pallas``
``to_quarters``               ``to_quarters_pallas``
``from_quarters``             ``from_quarters_pallas``
``mg_down_q``                 ``mg_down_q_pallas`` (fused-restrict and
                              split forms)
``mg_restrict_tq``            ``mg_restrict_tq_pallas``
``mg_up_q``                   ``mg_up_q_pallas`` (with its residual option)
``mg_ud_q``                   ``mg_ud_q_pallas`` (fused-restrict form)
``mg_prolong_tq``             ``mg_prolong_tq_pallas``
``clamp_cast_paste_q``        ``clamp_cast_guarded_quarters_pallas`` + the
                              paste
``rb_sweeps``                 ``rb_sweeps_pallas``
``rb_sweeps_tile``            ``rb_sweeps_tile_pallas`` (also on a window
                              of a larger array, read where it lies)
``postprocess_transposed``    ``postprocess_transposed_pallas`` (in place)
``prep_mask``                 none: the JAX package preps the mask on the
                              host (``native.prep_mask``)
============================  =============================================

Each wrapper checks device, dtype, shape and layout, allocates its output
with ``torch.empty``, launches on the current stream and raises when the
launch returns a non-zero ``cudaError_t``. Given a CPU tensor it runs its
``*_plain`` twin instead — only then: a CUDA tensor launches the kernel or
raises, never falls back. ``LAUNCHES[name]`` counts kernel launches (the
twins do not count), so a run can show that it went through the kernels;
``WINDOW_LAUNCHES`` counts the part of ``rb_sweeps_tile``'s that read a
window (also in ``LAUNCHES``).
The sources are ``csrc/<name>.cu`` (``rb_sweeps`` launches
``csrc/rb_sweeps_tile.cu`` at origin (0, 0); the three unfold kernels share
``csrc/fold.cuh``, the four paste kernels (clamp_cast_paste,
clamp_cast_paste_q, postprocess_transposed, unfold_clamp_paste) the word
stores of ``csrc/paste_words.cuh``, preprocess_rhs_p, preprocess_rhs_q and
preprocess_rhs_t ``csrc/rhs_wide.cuh``, the two dense multigrid level
kernels and ``rb_sweeps_tile`` (its staging) ``csrc/mg_level.cuh``,
the three quarter-plane ones ``csrc/mg_level_q.cuh``; ``mg_down_t`` and
``mg_up_t`` are the fused forms in ``csrc/mg_down.cu`` and ``csrc/mg_up.cu``),
built by ``ops/_build.py``.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from seamlesscloneoptimization_tpu_torch.ops._build import kernel_function
from seamlesscloneoptimization_tpu_torch.ops.guidance import guidance_field
from seamlesscloneoptimization_tpu_torch.ops.mask import erode3x3
from seamlesscloneoptimization_tpu_torch.ops.postprocess import clamp_truncate_u8, postprocess_roi
from seamlesscloneoptimization_tpu_torch.ops.rhs import poisson_rhs

LAUNCHES = {"erode3": 0, "preprocess_rhs_t": 0, "transpose": 0,
            "clamp_cast_paste": 0, "fold_minor": 0, "unfold_minor": 0,
            "transpose_pair": 0, "unfold_transpose": 0, "unfold_clamp_paste": 0,
            "preprocess_rhs_p": 0, "mg_down": 0, "mg_up": 0, "mg_restrict_t": 0,
            "mg_prolong_t": 0, "mg_down_t": 0, "mg_up_t": 0, "preprocess_rhs_q": 0,
            "mg_down_q": 0, "mg_up_q": 0, "mg_ud_q": 0, "mg_prolong_tq": 0,
            "clamp_cast_paste_q": 0, "to_quarters": 0, "from_quarters": 0, "mg_restrict_tq": 0, "rb_sweeps": 0,
            "postprocess_transposed": 0, "rb_sweeps_tile": 0, "prep_mask": 0}
WINDOW_LAUNCHES = {"rb_sweeps_tile": 0}

_MIXED_RULES = {"opencv": 0, "norm": 1}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    WINDOW_LAUNCHES["rb_sweeps_tile"] = 0


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


def _launch(name: str, t: torch.Tensor, *args, count_as: str | None = None) -> None:
    """Launch kernel ``name`` on ``t``'s device and current stream; counted
    under ``count_as`` (default ``name``) when one library serves two
    wrappers."""
    with torch.cuda.device(t.device):
        stream = torch.cuda.current_stream(t.device).cuda_stream
        rc = kernel_function(name)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError_t {rc}")
    LAUNCHES[count_as or name] += 1


# ---------------------------------------------------------------------------
# erode3
# ---------------------------------------------------------------------------


def erode3_plain(mask: torch.Tensor) -> torch.Tensor:
    """Three 3x3 erosions with a zero border of a u8 mask, any nonzero byte
    inside: ``erode3x3((mask != 0).to(torch.uint8))``, {0,1} u8."""
    return erode3x3((mask != 0).to(torch.uint8))


def erode3(mask: torch.Tensor) -> torch.Tensor:
    """(H, W) u8 mask (any nonzero byte inside) -> 3x-eroded {0,1} u8 (one
    7x7 min, zero border); equal to ``erode3_plain``, which is
    ``erode3x3((mask != 0).to(torch.uint8))``."""
    _require(mask, "mask", torch.uint8, 2)
    if mask.device.type == "cpu":
        return erode3_plain(mask)
    h, w = mask.shape
    out = torch.empty_like(mask)
    _launch("erode3", mask, mask.data_ptr(), out.data_ptr(), h, w)
    return out


# ---------------------------------------------------------------------------
# prep_mask
# ---------------------------------------------------------------------------


def prep_mask_plain(mask: torch.Tensor, out: torch.Tensor | None = None):
    """``native.prep_mask`` in torch ops: any nonzero byte of the (H, W) u8
    ``mask`` inside, the 1-px border zeroed, written as {0, 255} into
    ``out`` (default a new tensor; it may be ``mask`` itself), and the int32
    bbox (x0, y0, bw, bh) of what is inside, all 0 for an empty mask.
    Returns (out, bbox)."""
    inside = mask[1:-1, 1:-1] != 0
    out = torch.empty_like(mask) if out is None else out
    out.zero_()[1:-1, 1:-1].masked_fill_(inside, 255)
    rows = torch.nonzero(inside.any(dim=1)).flatten()
    if rows.numel() == 0:
        return out, torch.zeros(4, dtype=torch.int32, device=mask.device)
    cols = torch.nonzero(inside.any(dim=0)).flatten()
    bbox = torch.stack([cols[0] + 1, rows[0] + 1, cols[-1] - cols[0] + 1, rows[-1] - rows[0] + 1])
    return out, bbox.to(torch.int32)


def prep_mask(mask: torch.Tensor, out: torch.Tensor | None = None):
    """(H, W) u8 mask (any nonzero byte inside) -> ((H, W) u8 {0, 255} with
    its 1-px border zeroed, int32 (x0, y0, bw, bh) on the same device), one
    launch; equal to ``prep_mask_plain`` and to ``native.prep_mask``.
    ``out`` (contiguous, 16-byte aligned) may be ``mask`` itself: the kernel
    reads each 16-byte chunk before it writes it. A mask at an unaligned
    address is read from an aligned copy."""
    _require(mask, "mask", torch.uint8, 2)
    if out is not None:
        _require(out, "out", torch.uint8, 2)
        _same_device(mask, out)
        if out.shape != mask.shape:
            raise ValueError(f"out {tuple(out.shape)} != mask {tuple(mask.shape)}")
    if mask.device.type == "cpu":
        return prep_mask_plain(mask, out)
    h, w = mask.shape
    if h * w >= (1 << 31) - 16:
        raise ValueError(f"mask {h}x{w} has more than 2^31 - 17 pixels")
    if out is None:
        out = torch.empty_like(mask)
    elif out.data_ptr() % 16:
        raise ValueError("out must be 16-byte aligned")
    if mask.data_ptr() % 16:
        mask = mask.clone()
    buf = torch.empty(9, dtype=torch.int32, device=mask.device)  # bbox, then scratch
    _launch("prep_mask", mask, mask.data_ptr(), out.data_ptr(), buf.data_ptr(), h, w)
    return out, buf[:4]


# ---------------------------------------------------------------------------
# preprocess_rhs_t
# ---------------------------------------------------------------------------


def _rhs_plain(dest, patch, mask_eroded, flags, mixed_rule) -> torch.Tensor:
    """guidance_field -> poisson_rhs: the (C, H-2, W-2) interior RHS."""
    dest_f = dest.to(torch.float32)
    gx, gy = guidance_field(dest_f, patch.to(torch.float32), mask_eroded * 255,
                            flags, mixed_rule)
    return poisson_rhs(gx, gy, dest_f)


def preprocess_rhs_t_plain(dest: torch.Tensor, patch: torch.Tensor,
                           mask_eroded: torch.Tensor, flags: int = 1,
                           mixed_rule: str = "opencv") -> torch.Tensor:
    """guidance_field -> poisson_rhs, transposed to the origin of a zero slab."""
    c, h, w = dest.shape
    out = torch.zeros((c, ru128(w - 2), ru128(h - 2)), dtype=torch.float32,
                      device=dest.device)
    out[:, : w - 2, : h - 2] = _rhs_plain(dest, patch, mask_eroded, flags,
                                          mixed_rule).transpose(1, 2)
    return out


def _check_rhs_inputs(dest, patch, mask_eroded, flags, mixed_rule) -> None:
    """The input contract shared by preprocess_rhs_t and preprocess_rhs_p."""
    _require(dest, "dest", torch.uint8, 3, contiguous=False)
    _require(patch, "patch", torch.uint8, 3, contiguous=False)
    _require(mask_eroded, "mask_eroded", torch.uint8, 2)
    _same_device(dest, patch, mask_eroded)
    _, h, w = dest.shape
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
    _check_rhs_inputs(dest, patch, mask_eroded, flags, mixed_rule)
    if dest.device.type == "cpu":
        return preprocess_rhs_t_plain(dest, patch, mask_eroded, flags, mixed_rule)
    c, h, w = dest.shape
    wpo, hpo = ru128(w - 2), ru128(h - 2)
    out = torch.empty((c, wpo, hpo), dtype=torch.float32, device=dest.device)
    _launch("preprocess_rhs_t", dest,
            dest.data_ptr(), *dest.stride(), patch.data_ptr(), *patch.stride(),
            mask_eroded.data_ptr(), out.data_ptr(), c, h, w, wpo, hpo, flags,
            _MIXED_RULES[mixed_rule])
    return out


# ---------------------------------------------------------------------------
# preprocess_rhs_p
# ---------------------------------------------------------------------------


def preprocess_rhs_p_plain(dest: torch.Tensor, patch: torch.Tensor,
                           mask_eroded: torch.Tensor, out_hw: tuple[int, int],
                           flags: int = 1, mixed_rule: str = "opencv") -> torch.Tensor:
    """guidance_field -> poisson_rhs at the origin of a zero (C, *out_hw) slab."""
    c, h, w = dest.shape
    out = torch.zeros((c, *out_hw), dtype=torch.float32, device=dest.device)
    out[:, : h - 2, : w - 2] = _rhs_plain(dest, patch, mask_eroded, flags, mixed_rule)
    return out


def preprocess_rhs_p(dest: torch.Tensor, patch: torch.Tensor,
                     mask_eroded: torch.Tensor, out_hw: tuple[int, int],
                     flags: int = 1, mixed_rule: str = "opencv") -> torch.Tensor:
    """Fused guidance + divergence + Dirichlet fold, NATURAL orientation.

    Inputs as ``preprocess_rhs_t``. Returns (C, HPo, WPo) f32 with
    (HPo, WPo) = ``out_hw`` >= (H-2, W-2): the interior RHS at the origin,
    exact zeros elsewhere. ``out_hw = (H-2, W-2)`` gives the exact RHS
    (``preprocess_rhs_pallas``'s result); the multigrid serve tail asks for
    the level geometry's (hp, wp) slab, which the solver then starts from.
    """
    _check_rhs_inputs(dest, patch, mask_eroded, flags, mixed_rule)
    c, h, w = dest.shape
    hpo, wpo = int(out_hw[0]), int(out_hw[1])
    if hpo < h - 2 or wpo < w - 2:
        raise ValueError(f"out_hw {out_hw} smaller than the interior {(h - 2, w - 2)}")
    if dest.device.type == "cpu":
        return preprocess_rhs_p_plain(dest, patch, mask_eroded, (hpo, wpo), flags,
                                      mixed_rule)
    out = torch.empty((c, hpo, wpo), dtype=torch.float32, device=dest.device)
    _launch("preprocess_rhs_p", dest,
            dest.data_ptr(), *dest.stride(), patch.data_ptr(), *patch.stride(),
            mask_eroded.data_ptr(), out.data_ptr(), c, h, w, hpo, wpo, flags,
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
    c, hu, wu = u.shape
    top1, left1, h2, w2 = _check_paste(u, dst, top1, left1, h2, w2)
    if w2 > wu:
        raise ValueError(f"u {tuple(u.shape)} cannot fill ({c}, {h2}, {w2})")
    if u.device.type == "cpu":
        return clamp_cast_paste_plain(u, dst, top1, left1, h2, w2)
    _launch("clamp_cast_paste", u, u.data_ptr(), c, hu, wu, dst.data_ptr(),
            *dst.stride(), top1, left1, h2, w2)
    return dst


def _check_paste(u: torch.Tensor, dst: torch.Tensor, top1, left1, h2, w2,
                 rows: int | None = None):
    """The paste contract shared by the paste kernels: ``dst`` a (C, H, W)
    u8 view with positive strides, u's channels and rows (``rows``, or
    u.shape[1]) cover (C, h2), the interior lies inside ``dst``. Returns
    the ints."""
    _require(dst, "dst", torch.uint8, 3, contiguous=False)
    _same_device(u, dst)
    c, hu = u.shape[0], u.shape[1] if rows is None else rows
    cd, hd, wd = dst.shape
    top1, left1, h2, w2 = int(top1), int(left1), int(h2), int(w2)
    if cd != c or h2 > hu or h2 < 0 or w2 < 0:
        raise ValueError(f"u {tuple(u.shape)} cannot fill ({cd}, {h2}, {w2})")
    if top1 < 0 or left1 < 0 or top1 + h2 > hd or left1 + w2 > wd:
        raise ValueError(f"interior ({top1},{left1})+({h2}x{w2}) outside "
                         f"destination {(hd, wd)}")
    if min(dst.stride()) < 1:
        raise ValueError("dst strides must be positive")
    return top1, left1, h2, w2


# ---------------------------------------------------------------------------
# postprocess_transposed
# ---------------------------------------------------------------------------


def postprocess_transposed_plain(u_t: torch.Tensor, dst: torch.Tensor, top1: int,
                                 left1: int) -> torch.Tensor:
    """``postprocess_roi`` of the un-transposed solve into the ROI of ``dst``
    whose interior starts at (top1, left1)."""
    _, w2, h2 = u_t.shape
    roi = dst[:, top1 - 1 : top1 + h2 + 1, left1 - 1 : left1 + w2 + 1]
    roi.copy_(postprocess_roi(u_t.transpose(1, 2), roi))
    return dst


def postprocess_transposed(u_t: torch.Tensor, dst: torch.Tensor, top1: int,
                           left1: int) -> torch.Tensor:
    """Blend a TRANSPOSED interior solution into the destination, in place.

    u_t: (C, W-2, H-2) f32 contiguous, the solve in transposed orientation
    (``solve_dst_gemm(transposed_output=True)``). ``dst``: a (C, Hd, Wd) u8
    view with positive strides (the planar serve buffer or an interleaved
    image's ``permute(2, 0, 1)``) holding the (C, H, W) ROI with its
    interior at (top1, left1). The interior becomes clamp(u_t^T, 0, 255)
    truncated to u8; the ROI's one-pixel border keeps dest's values, so the
    ROI is the blended ROI of ``postprocess_transposed_pallas``. Returns
    ``dst``."""
    _require(u_t, "u_t", torch.float32, 3)
    _, w2, h2 = u_t.shape
    top1, left1, _, _ = _check_paste(u_t, dst, top1, left1, h2, w2, rows=h2)
    if top1 < 1 or left1 < 1 or top1 + h2 + 1 > dst.shape[1] or left1 + w2 + 1 > dst.shape[2]:
        raise ValueError(f"the ROI around ({top1},{left1})+({h2}x{w2}) is not inside "
                         f"the destination {tuple(dst.shape[1:])}")
    if u_t.device.type == "cpu":
        return postprocess_transposed_plain(u_t, dst, top1, left1)
    _launch("postprocess_transposed", u_t, u_t.data_ptr(), u_t.shape[0], h2, w2,
            dst.data_ptr(), *dst.stride(), top1, left1)
    return dst


# ---------------------------------------------------------------------------
# The folded chain: fold_minor, unfold_minor, transpose_pair,
# unfold_transpose, unfold_clamp_paste
# ---------------------------------------------------------------------------


def fold_halves(n: int) -> tuple[int, int, int, int]:
    """(he, ho, ep, op) of axis size n: the even/odd half sizes and their
    128-roundups, the widths of the folded GEMM operands."""
    he, ho = (n + 1) // 2, n // 2
    return he, ho, ru128(he), ru128(ho)


def fold_minor_plain(x: torch.Tensor, n: int) -> tuple[torch.Tensor, torch.Tensor]:
    he, ho, ep, op = fold_halves(n)
    head = x[..., :ho]
    tail = torch.flip(x[..., n - ho : n], (-1,))
    s = x.new_zeros(x.shape[:-1] + (ep,))
    d = x.new_zeros(x.shape[:-1] + (op,))
    s[..., :ho] = head + tail
    if n % 2:
        s[..., ho] = x[..., ho]  # the self-paired middle element, once
    d[..., :ho] = head - tail
    return s, d


def fold_minor(x: torch.Tensor, n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Even/odd DST fold along the minor axis of (C, M, NP) f32, n <= NP.

    Returns s (C, M, ep) and d (C, M, op): for j < ho, s[j] = x[j] +
    x[n-1-j] and d[j] = x[j] - x[n-1-j]; for odd n, s[he-1] = x[he-1] (the
    middle counted once). Every other lane is an exact 0 (the TPU kernel
    leaves finite garbage there; from ``torch.empty`` it could be NaN,
    which the next GEMM would spread). Lanes >= n of x are never read.
    """
    _require(x, "x", torch.float32, 3)
    c, m, npad = x.shape
    n = int(n)
    if not 1 <= n <= npad:
        raise ValueError(f"fold size n={n} outside [1, {npad}]")
    if x.device.type == "cpu":
        return fold_minor_plain(x, n)
    _, _, ep, op = fold_halves(n)
    s = torch.empty((c, m, ep), dtype=torch.float32, device=x.device)
    d = torch.empty((c, m, op), dtype=torch.float32, device=x.device)
    _launch("fold_minor", x, x.data_ptr(), s.data_ptr(), d.data_ptr(), c * m, npad,
            n, ep, op)
    return s, d


def unfold_minor_plain(e: torch.Tensor, o: torch.Tensor, n: int,
                       out_pad: int) -> torch.Tensor:
    """(..., out_pad): E+O on lanes [0, he), E-O reversed on [he, n), 0 beyond
    (out_pad >= n; the paste twin takes out_pad = n)."""
    he, ho, _, _ = fold_halves(n)
    out = e.new_zeros(e.shape[:-1] + (out_pad,))
    out[..., :he] = e[..., :he] + o[..., :he]
    out[..., he:n] = torch.flip(e[..., :ho] - o[..., :ho], (-1,))
    return out


def _check_unfold(e: torch.Tensor, o: torch.Tensor, n: int) -> int:
    _require(e, "e", torch.float32, 3)
    _require(o, "o", torch.float32, 3)
    _same_device(e, o)
    if e.shape != o.shape:
        raise ValueError(f"e {tuple(e.shape)} and o {tuple(o.shape)} differ")
    n = int(n)
    if n < 1 or e.shape[-1] < (n + 1) // 2:
        raise ValueError(f"e {tuple(e.shape)} too narrow for unfold size n={n}")
    return n


def unfold_minor(e: torch.Tensor, o: torch.Tensor, n: int, out_pad: int) -> torch.Tensor:
    """Inverse even/odd combine along the minor axis: e, o (C, M, ep) f32,
    the inverse half-GEMM outputs. Returns (C, M, out_pad): out[x] = e[x] +
    o[x] for x < he, out[n-1-x] = e[x] - o[x] for x < ho, exact 0 beyond n."""
    n = _check_unfold(e, o, n)
    c, m, ep = e.shape
    out_pad = int(out_pad)
    if out_pad < n:
        raise ValueError(f"out_pad {out_pad} < n={n}")
    if e.device.type == "cpu":
        return unfold_minor_plain(e, o, n, out_pad)
    out = torch.empty((c, m, out_pad), dtype=torch.float32, device=e.device)
    _launch("unfold_minor", e, e.data_ptr(), o.data_ptr(), out.data_ptr(), c * m, ep,
            n, out_pad)
    return out


def _window(m: int, row_start, row_count) -> tuple[int, int]:
    rs = int(row_start)
    rc = m - rs if row_count is None else int(row_count)
    if rs < 0 or rc < 0 or rs + rc > m:
        raise ValueError(f"row window [{rs}, {rs + rc}) outside [0, {m})")
    return rs, rc


def transpose_pair_plain(a: torch.Tensor, b: torch.Tensor,
                         lam_p: torch.Tensor | None = None,
                         lam_r: torch.Tensor | None = None, row_start: int = 0,
                         row_count: int | None = None) -> torch.Tensor:
    rs, rc = _window(a.shape[1], row_start, row_count)
    xt = torch.cat([a, b], dim=-1)[:, rs : rs + rc].transpose(1, 2)
    if lam_p is None:
        return xt.contiguous()
    return xt / (lam_p[:, None] + lam_r[None, rs : rs + rc])


def transpose_pair(a: torch.Tensor, b: torch.Tensor,
                   lam_p: torch.Tensor | None = None, lam_r: torch.Tensor | None = None,
                   row_start: int = 0, row_count: int | None = None) -> torch.Tensor:
    """Transpose of x = [a | b] (lane concat of (C, M, PA) and (C, M, PB))
    over the row window [row_start, row_start + row_count): (C, PA+PB, rc),
    out[c, p, r] = x[c, row_start + r, p]. With ``lam_p`` (PA+PB,) and
    ``lam_r`` (M,) also divides by lam_p[p] + lam_r[row_start + r]."""
    _require(a, "a", torch.float32, 3)
    _require(b, "b", torch.float32, 3)
    _same_device(a, b)
    c, m, pa = a.shape
    pb = b.shape[2]
    if b.shape[:2] != (c, m):
        raise ValueError(f"a {tuple(a.shape)} and b {tuple(b.shape)} differ in rows")
    rs, rc = _window(m, row_start, row_count)
    if (lam_p is None) != (lam_r is None):
        raise ValueError("lam_p and lam_r go together")
    if lam_p is not None:
        _require(lam_p, "lam_p", torch.float32, 1)
        _require(lam_r, "lam_r", torch.float32, 1)
        _same_device(a, lam_p, lam_r)
        if lam_p.shape[0] != pa + pb or lam_r.shape[0] != m:
            raise ValueError(f"eigenvalue lengths {lam_p.shape[0]}, {lam_r.shape[0]} "
                             f"!= ({pa + pb}, {m})")
    if a.device.type == "cpu":
        return transpose_pair_plain(a, b, lam_p, lam_r, rs, rc)
    out = torch.empty((c, pa + pb, rc), dtype=torch.float32, device=a.device)
    _launch("transpose_pair", a, a.data_ptr(), b.data_ptr(), out.data_ptr(),
            None if lam_p is None else lam_p.data_ptr(),
            None if lam_r is None else lam_r.data_ptr(), c, m, pa, pb, rs, rc)
    return out


def unfold_transpose_plain(e: torch.Tensor, o: torch.Tensor, n: int, out_pad: int,
                           row_start: int = 0, row_count: int | None = None) -> torch.Tensor:
    rs, rc = _window(e.shape[1], row_start, row_count)
    u = unfold_minor_plain(e[:, rs : rs + rc], o[:, rs : rs + rc], n, out_pad)
    return u.transpose(1, 2).contiguous()


def unfold_transpose(e: torch.Tensor, o: torch.Tensor, n: int, out_pad: int,
                     row_start: int = 0, row_count: int | None = None) -> torch.Tensor:
    """``unfold_minor`` fused with a windowed transpose: (C, out_pad, rc),
    out[c, x, r] = unfold_minor(e, o, n, out_pad)[c, row_start + r, x],
    without the unfolded slab ever reaching memory."""
    n = _check_unfold(e, o, n)
    c, m, ep = e.shape
    rs, rc = _window(m, row_start, row_count)
    out_pad = int(out_pad)
    if out_pad < n:
        raise ValueError(f"out_pad {out_pad} < n={n}")
    if e.device.type == "cpu":
        return unfold_transpose_plain(e, o, n, out_pad, rs, rc)
    out = torch.empty((c, out_pad, rc), dtype=torch.float32, device=e.device)
    _launch("unfold_transpose", e, e.data_ptr(), o.data_ptr(), out.data_ptr(), c, m, ep,
            n, out_pad, rs, rc)
    return out


def unfold_clamp_paste_plain(e: torch.Tensor, o: torch.Tensor, dst: torch.Tensor,
                             top1: int, left1: int, h2: int, w2: int) -> torch.Tensor:
    u = unfold_minor_plain(e[:, :h2], o[:, :h2], w2, w2)
    dst[:, top1 : top1 + h2, left1 : left1 + w2] = clamp_truncate_u8(u)
    return dst


def unfold_clamp_paste(e: torch.Tensor, o: torch.Tensor, dst: torch.Tensor,
                       top1: int, left1: int, h2: int, w2: int) -> torch.Tensor:
    """``unfold_minor`` (n = w2) of rows [0, h2) of e, o (C, HU, ep), then
    clamp to [0, 255], truncate to u8 and write in place into ``dst`` at
    (top1, left1) — ``clamp_cast_paste``'s destination contract. Returns
    ``dst``."""
    w2 = _check_unfold(e, o, w2)
    top1, left1, h2, w2 = _check_paste(e, dst, top1, left1, h2, w2)
    c, hu, ep = e.shape
    if e.device.type == "cpu":
        return unfold_clamp_paste_plain(e, o, dst, top1, left1, h2, w2)
    _launch("unfold_clamp_paste", e, e.data_ptr(), o.data_ptr(), c, hu, ep,
            dst.data_ptr(), *dst.stride(), top1, left1, h2, w2)
    return dst


# ---------------------------------------------------------------------------
# The transpose-fused multigrid chain (solvers/multigrid.py:vcycle_t): the
# level kernels mg_down, mg_up, the transfers mg_restrict_t, mg_prolong_t,
# and the fused forms vcycle_t runs, mg_down_t (mg_down + mg_restrict_t) and
# mg_up_t (mg_prolong_t + mg_up)
# ---------------------------------------------------------------------------


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def mg_geometry_t(h: int, w: int, wp_min: int = 0,
                  th: int | None = None) -> tuple[int, int, int, int]:
    """(th, hp, wp, hp2) of one level of the transpose-fused chain.

    A level of true size (h, w) lives in a (C, hp, wp) slab: hp = h rounded
    up to the strip height th (a power of two in [16, 256], 128 unless the
    level is shorter), wp = w rounded up to 128, raised to ``wp_min`` (the
    coarse level inherits the fine level's hp2 as its width, so the
    transposed transfers read and write whole slabs). hp2 = hp // 2 rounded
    up to 128 is the row extent of the half-height arrays (rh, e_lane).
    """
    wp = max(_round_up(w, 128), wp_min)
    if th is None:
        th = min(128, _round_up(max(h, 16), 16))
        if th & (th - 1):  # the height clamp broke the power of two
            th = 1 << (th.bit_length() - 1)
        th = max(16, th)
    if th not in (16, 32, 64, 128, 256):
        raise ValueError(f"strip height {th} not a power of two in [16, 256]")
    hp = _round_up(h, th)
    return th, hp, wp, _round_up(hp // 2, 128)


_M = 8  # the JAX package's ghost rows a strip window carries above and below
MG_TH = (160, 128)  # mg_geometry's strip height up to wp = 2560, and above


def _strip_height(wp: int, n_windows: int, budget_bytes: int = 6 << 20) -> int:
    """Largest multiple-of-8 strip height whose n_windows double-buffered
    (th + 2 _M, wp) windows and their headroom fit budget_bytes (the JAX
    package's VMEM rule, kept so that mg_geometry's slabs equal its own)."""
    th = (budget_bytes // (4 * n_windows * 4 * wp)) - 2 * _M
    th = max(8, (th // 8) * 8)
    return min(th, 512)


def mg_geometry(h: int, w: int) -> tuple[int, int, int]:
    """(th, hp, wp) of one level of the dense rounded chain (``vcycle_p``).

    A level of true size (h, w) lives in a (C, hp, wp) slab: wp = w rounded
    up to 128, hp = h rounded up to the strip height th: ``MG_TH`` (the JAX
    package's ``SCL_MG_TH`` default, 160 for wp <= 2560, 128 above),
    clamped by the level's height rounded up to 16 and by
    ``_strip_height(wp, 3, 48 MiB)``. th is a multiple of 16, so hp is
    even, as ``mg_down`` / ``mg_up`` need.
    """
    wp = _round_up(w, 128)
    th = MG_TH[0] if wp <= 2560 else MG_TH[1]
    th = min(th, _round_up(max(h, 16), 16))
    th = min(th, max(16, _strip_height(wp, n_windows=3, budget_bytes=48 << 20) // 16 * 16))
    return th, _round_up(h, th), wp


@functools.lru_cache(maxsize=1024)
def _f32(x: float) -> float:
    """A Python double rounded once to float32 (the JAX package rounds its
    double-precision beta coefficients once, as weak-typed constants)."""
    return torch.tensor(x, dtype=torch.float32).item()


def _level_consts(bh: float, bw: float) -> tuple[bool, float, float, float, float]:
    """(uniform, cuh, cuw, dh, dw) of a level operator: the Shortley-Weller
    last-row / last-column neighbour weights 2/(1+beta) - 1 and diagonal
    halves 2/beta, each rounded once to f32; uniform when both betas are 1."""
    return (bh == 1.0 and bw == 1.0, _f32(2.0 / (1.0 + bh) - 1.0),
            _f32(2.0 / (1.0 + bw) - 1.0), _f32(2.0 / bh), _f32(2.0 / bw))


def _edge_weights_w(bw: float) -> tuple[float, float, float, float]:
    """(c5, c6, c7, c8): the even-w edge weights of the lane restriction
    (mg_restrict_t) and of the lane prolongation (mg_prolong_t)."""
    gap = 2.0 + bw
    return (_f32(2.0 * (1.0 + bw) / gap), _f32(2.0 * bw / gap), _f32((1.0 + bw) / gap),
            _f32(bw / gap))


def _level_ops(hp: int, wp: int, h: int, w: int, bh: float, bw: float, device):
    """(nsum, inv_d, diag, red, black) of the level operator on a (hp, wp)
    slab whose true domain is (h, w): the plain twin of csrc/mg_level.cuh.
    Neighbours beyond the slab are zero; red/black are the colours inside
    the domain."""
    uniform, cuh, cuw, dh, dw = _level_consts(bh, bw)
    rows = torch.arange(hp, device=device)[:, None]
    cols = torch.arange(wp, device=device)[None, :]
    in_dom = (rows < h) & (cols < w)
    par = (rows + cols) % 2 == 0
    red, black = par & in_dom, ~par & in_dom

    def shifts(x):
        xp = F.pad(x, (1, 1, 1, 1))
        return xp[:, :-2, 1:-1], xp[:, 2:, 1:-1], xp[:, 1:-1, :-2], xp[:, 1:-1, 2:]

    if uniform:
        def nsum(x):
            up, dn, lf, rt = shifts(x)
            return up + dn + lf + rt
        return nsum, 0.25, 4.0, red, black
    zero = torch.zeros((), dtype=torch.float32, device=device)

    def full(v):
        return torch.full((), v, dtype=torch.float32, device=device)

    lrow = torch.where(rows == h - 1, full(cuh), zero)
    lcol = torch.where(cols == w - 1, full(cuw), zero)
    diag = (torch.where(rows == h - 1, full(dh), full(2.0))
            + torch.where(cols == w - 1, full(dw), full(2.0)))

    def nsum(x):
        up, dn, lf, rt = shifts(x)
        return up + dn + lf + rt + lrow * up + lcol * lf

    return nsum, 1.0 / diag, diag, red, black


def _rb_sweeps(u, g, n, nsum, inv_d, red, black, u_zero=False):
    """n red-black sweeps in the select form; ``u_zero``: u is known zero,
    so the first red half-sweep is (0 - g) * inv_d."""
    for s in range(n):
        upd = (0.0 - g) * inv_d if (s == 0 and u_zero) else (nsum(u) - g) * inv_d
        u = torch.where(red, upd, u)
        u = torch.where(black, (nsum(u) - g) * inv_d, u)
    return u


def _check_level(name: str, x: torch.Tensor, c: int, hp: int, wp: int) -> None:
    _require(x, name, torch.float32, 3)
    if tuple(x.shape) != (c, hp, wp):
        raise ValueError(f"{name} {tuple(x.shape)} != {(c, hp, wp)}")


def _check_nu(nu: int, lo: int, hi: int, what: str) -> int:
    nu = int(nu)
    if not lo <= nu <= hi:
        raise ValueError(f"{what}={nu} outside [{lo}, {hi}] (the halo's staleness budget)")
    return nu


def _check_hw(h: int, w: int, hp: int, wp: int) -> tuple[int, int]:
    h, w = int(h), int(w)
    if not (3 <= h <= hp and 3 <= w <= wp):
        raise ValueError(f"true size {(h, w)} outside [3, {(hp, wp)}]")
    if hp % 2:
        raise ValueError(f"slab height {hp} is odd")
    return h, w


def _check_descent(u, g, h, w, nu1) -> tuple[int, int, int, int, int, int]:
    """The input contract of mg_down and mg_down_t: (c, hp, wp, h, w, nu1)."""
    _require(g, "g", torch.float32, 3)
    c, hp, wp = g.shape
    if u is not None:
        _check_level("u", u, c, hp, wp)
        _same_device(g, u)
    h, w = _check_hw(h, w, hp, wp)
    return c, hp, wp, h, w, _check_nu(nu1, 0, 2, "nu1")


def _check_ascent(u, g, e, e_name: str, h, w) -> tuple[int, int, int, int, int]:
    """The slab contract of mg_up and mg_up_t (e: the correction operand
    ``e_name``): (c, hp, wp, h, w)."""
    _require(u, "u", torch.float32, 3)
    c, hp, wp = u.shape
    _check_level("g", g, c, hp, wp)
    _require(e, e_name, torch.float32, 3)
    _same_device(u, g, e)
    h, w = _check_hw(h, w, hp, wp)
    return c, hp, wp, h, w


def mg_down_plain(u: torch.Tensor | None, g: torch.Tensor, nu1: int, h: int, w: int,
                  bh: float = 1.0, bw: float = 1.0, rh_rows: int | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    c, hp, wp = g.shape
    rh_rows = hp // 2 if rh_rows is None else rh_rows
    nsum, inv_d, diag, red, black = _level_ops(hp, wp, h, w, bh, bw, g.device)
    u_zero = u is None
    u = _rb_sweeps(torch.zeros_like(g) if u_zero else u, g, nu1, nsum, inv_d, red, black,
                   u_zero)
    r = torch.where(red | black, g - (nsum(u) - diag * u), 0.0)
    rp = F.pad(r, (0, 0, 0, 2))               # r rows hp, hp+1: zero
    a, b, a1 = rp[:, 0:hp:2], rp[:, 1:hp:2], rp[:, 2 : hp + 1 : 2]
    rh = 0.25 * a + 0.5 * b + 0.25 * a1       # (C, hp//2, wp)
    hc = (h - 1) // 2
    if h % 2 == 0:
        # the last coarse row takes the transpose of the beta-gap edge
        # prolongation: top up fine h-2 to wA/2 and add wB/2 of fine h-1
        gap = 2.0 + bh
        j = hc - 1
        edge = (rh[:, j] + _f32((1.0 + bh) / gap * 0.5 - 0.25) * rp[:, 2 * j + 2]
                + _f32(bh / gap * 0.5) * rp[:, 2 * j + 3])
        rh = rh.clone()
        rh[:, j] = edge
    return u, F.pad(rh, (0, 0, 0, rh_rows - hp // 2))


def mg_down(u: torch.Tensor | None, g: torch.Tensor, nu1: int, h: int, w: int,
            bh: float = 1.0, bw: float = 1.0, rh_rows: int | None = None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """V-cycle descent on one level: ``nu1`` red-black sweeps, the residual
    and its (1/4, 1/2, 1/4) row restriction, in one pass.

    g, u: (C, hp, wp) f32 slabs, true domain (h, w) at the origin, exact
    zeros elsewhere; ``u=None`` is a known-zero guess (every coarse level),
    which the kernel synthesizes instead of reading. bh, bw: the level's
    boundary-gap parameters (Shortley-Weller last row / column when != 1).
    Returns (swept u (C, hp, wp), rh (C, rh_rows, wp)): rh rows [0, hc)
    hold the row-restricted residual (hc = (h-1)//2; an even h puts the
    beta-gap weights on row hc-1), rows from hp//2 on are exact zeros.
    """
    c, hp, wp, h, w, nu1 = _check_descent(u, g, h, w, nu1)
    rh_rows = hp // 2 if rh_rows is None else int(rh_rows)
    if rh_rows < hp // 2:
        raise ValueError(f"rh_rows {rh_rows} < hp // 2 = {hp // 2}")
    if g.device.type == "cpu":
        return mg_down_plain(u, g, nu1, h, w, bh, bw, rh_rows)
    uniform, cuh, cuw, dh, dw = _level_consts(bh, bw)
    gap = 2.0 + bh
    u_out = torch.empty_like(g)
    rh = torch.empty((c, rh_rows, wp), dtype=torch.float32, device=g.device)
    _launch("mg_down", g, None if u is None else u.data_ptr(), g.data_ptr(),
            u_out.data_ptr(), rh.data_ptr(), c, hp, wp, rh_rows, h, w, nu1, int(uniform),
            cuh, cuw, dh, dw, _f32((1.0 + bh) / gap * 0.5 - 0.25), _f32(bh / gap * 0.5))
    return u_out, rh


def mg_up_plain(u: torch.Tensor, g: torch.Tensor, e_lane: torch.Tensor, nu2: int,
                h: int, w: int, bh: float = 1.0, bw: float = 1.0) -> torch.Tensor:
    c, hp, wp = u.shape
    hc = (h - 1) // 2
    # E[k + 1] = e_lane[k] for k < hc, zero elsewhere (E[0] is e[-1] = 0)
    ez = u.new_zeros((c, hp // 2 + 2, wp))
    ez[:, 1 : hc + 1] = e_lane[:, :hc]
    mids = 0.5 * (ez[:, : hp // 2 + 1] + ez[:, 1 : hp // 2 + 2])  # 0.5 (e[q-1] + e[q])
    corr = torch.stack([mids[:, : hp // 2], ez[:, 1 : hp // 2 + 1]], dim=2).reshape(c, hp, wp)
    if h % 2 == 0:
        # fine rows h-2, h-1 take (wA, wB) of the last coarse row: rescale
        # row h-2 and give row h-1 its own share of the same mid value
        gap = 2.0 + bh
        corr = corr.clone()
        corr[:, h - 2] = corr[:, h - 2] * _f32(2.0 * (1.0 + bh) / gap)
        corr[:, h - 1] = mids[:, hc] * _f32(2.0 * bh / gap)
    nsum, inv_d, _, red, black = _level_ops(hp, wp, h, w, bh, bw, u.device)
    u = torch.where(red | black, u + corr, u)
    return _rb_sweeps(u, g, nu2, nsum, inv_d, red, black)


def mg_up(u: torch.Tensor, g: torch.Tensor, e_lane: torch.Tensor, nu2: int, h: int,
          w: int, bh: float = 1.0, bw: float = 1.0) -> torch.Tensor:
    """V-cycle ascent on one level: the row prolongation of the
    lane-prolonged coarse correction ``e_lane`` (C, >= hp//2, wp) (rows
    [0, hc) used, the rest taken as zero), added inside the domain, then
    ``nu2`` red-black sweeps. u, g: (C, hp, wp) as for ``mg_down``.
    Returns the swept (C, hp, wp) u, exact zeros outside the domain."""
    c, hp, wp, h, w = _check_ascent(u, g, e_lane, "e_lane", h, w)
    if e_lane.shape[0] != c or e_lane.shape[2] != wp or e_lane.shape[1] < hp // 2:
        raise ValueError(f"e_lane {tuple(e_lane.shape)} does not cover {(c, hp // 2, wp)}")
    nu2 = _check_nu(nu2, 0, 4, "nu2")
    if u.device.type == "cpu":
        return mg_up_plain(u, g, e_lane, nu2, h, w, bh, bw)
    uniform, cuh, cuw, dh, dw = _level_consts(bh, bw)
    gap = 2.0 + bh
    out = torch.empty_like(u)
    _launch("mg_up", u, u.data_ptr(), g.data_ptr(), e_lane.data_ptr(), out.data_ptr(),
            c, hp, wp, e_lane.shape[1], h, w, nu2, int(uniform), cuh, cuw, dh, dw,
            _f32(2.0 * (1.0 + bh) / gap), _f32(2.0 * bh / gap))
    return out


def mg_restrict_t_plain(rh: torch.Tensor, h: int, w: int, bw: float,
                        out_rows: int) -> torch.Tensor:
    c, hp2, wp = rh.shape
    hc, wc = (h - 1) // 2, (w - 1) // 2
    a, b = rh[:, :, 0 : 2 * wc + 2 : 2], rh[:, :, 1 : 2 * wc + 2 : 2]  # (C, hp2, wc+1)
    out = (a[..., :wc] + 2.0 * b[..., :wc]) + a[..., 1 : wc + 1]
    if w % 2 == 0:
        gap = 2.0 + bw
        edge = (((a[..., wc - 1] + 2.0 * b[..., wc - 1])
                 + _f32(2.0 * (1.0 + bw) / gap) * a[..., wc])
                + _f32(2.0 * bw / gap) * b[..., wc])
        out = torch.cat([out[..., : wc - 1], edge[..., None]], dim=-1)
    lanes = torch.arange(hp2, device=rh.device)[:, None]
    out = torch.where(lanes < hc, out, 0.0)  # rh rows >= hc: leftovers, zeroed
    # contiguous as the kernel's output, also where the pad adds no row
    return F.pad(out.transpose(1, 2), (0, 0, 0, out_rows - wc)).contiguous()


def mg_restrict_t(rh: torch.Tensor, h: int, w: int, bw: float, out_rows: int) -> torch.Tensor:
    """4x lane restriction of the row-restricted residual, emitted TRANSPOSED.

    rh: (C, hp2, wp) from ``mg_down(rh_rows=hp2)``, rows [0, hc) valid.
    Returns (C, out_rows, hp2): out[c, j, l] = 4 * restrict_w(rh)[c, l, j]
    for j < wc, l < hc — the x4 folded into the (1, 2, 1) weights, the
    beta-gap edge on column wc-1 for even w — and exact zeros elsewhere:
    the RHS of the coarse level, which lives transposed.
    """
    _require(rh, "rh", torch.float32, 3)
    c, hp2, wp = rh.shape
    h, w, out_rows = int(h), int(w), int(out_rows)
    hc, wc = (h - 1) // 2, (w - 1) // 2
    if hc < 1 or wc < 1 or wp < 2 * wc + 2 or hp2 < hc or out_rows < wc:
        raise ValueError(f"rh {tuple(rh.shape)} cannot restrict true size {(h, w)} "
                         f"into {out_rows} rows")
    if rh.device.type == "cpu":
        return mg_restrict_t_plain(rh, h, w, bw, out_rows)
    c5, c6, _, _ = _edge_weights_w(bw)
    out = torch.empty((c, out_rows, hp2), dtype=torch.float32, device=rh.device)
    _launch("mg_restrict_t", rh, rh.data_ptr(), out.data_ptr(), c, hp2, wp, out_rows, h, w,
            c5, c6)
    return out


def mg_prolong_t_plain(ec_t: torch.Tensor, w: int, bw: float, out_rows: int,
                       wp: int) -> torch.Tensor:
    c, hp_c, _ = ec_t.shape
    wc = (w - 1) // 2
    e = ec_t[:, :, :out_rows]                    # (C, hp_c, L): rows = coarse w
    ep = F.pad(e, (0, 0, 1, 1))                  # zero Dirichlet rows
    mids = 0.5 * (ep[:, : wc + 1] + ep[:, 1 : wc + 2])
    pairs = torch.stack([mids[:, :wc], e[:, :wc]], dim=2).reshape(c, 2 * wc, out_rows)
    if w % 2:
        res = torch.cat([pairs, mids[:, wc : wc + 1]], dim=1)
    else:
        gap = 2.0 + bw
        last = e[:, wc - 1 : wc]
        res = torch.cat([pairs[:, : w - 2], last * _f32((1.0 + bw) / gap),
                         last * _f32(bw / gap)], dim=1)
    return F.pad(res, (0, 0, 0, wp - w)).transpose(1, 2).contiguous()


def mg_prolong_t(ec_t: torch.Tensor, w: int, bw: float, out_rows: int,
                 wp: int) -> torch.Tensor:
    """Lane prolongation of the TRANSPOSED coarse correction, back to natural.

    ec_t: (C, hp_c, lanes) f32, the coarse solution (wc, hc) at the origin,
    exact zeros elsewhere. Returns (C, out_rows, wp): the bilinear
    prolongation along the fine w axis (the beta-gap (wA, wB) on the last
    two columns for even w), columns >= w exact zeros — ``mg_up``'s
    e_lane."""
    _require(ec_t, "ec_t", torch.float32, 3)
    c, hp_c, lanes = ec_t.shape
    w, out_rows, wp = int(w), int(out_rows), int(wp)
    wc = (w - 1) // 2
    if wc < 1 or hp_c < wc or lanes < out_rows or wp < w:
        raise ValueError(f"ec_t {tuple(ec_t.shape)} cannot prolong to w={w}, "
                         f"({out_rows}, {wp})")
    if ec_t.device.type == "cpu":
        return mg_prolong_t_plain(ec_t, w, bw, out_rows, wp)
    _, _, c7, c8 = _edge_weights_w(bw)
    out = torch.empty((c, out_rows, wp), dtype=torch.float32, device=ec_t.device)
    _launch("mg_prolong_t", ec_t, ec_t.data_ptr(), out.data_ptr(), c, hp_c, lanes, out_rows,
            wp, w, c7, c8)
    return out


def mg_down_t_plain(u: torch.Tensor | None, g: torch.Tensor, nu1: int, h: int, w: int,
                    bh: float, bw: float, out_rows: int) -> tuple[torch.Tensor, torch.Tensor]:
    u, rh = mg_down_plain(u, g, nu1, h, w, bh, bw, _round_up(g.shape[1] // 2, 128))
    return u, mg_restrict_t_plain(rh, h, w, bw, out_rows)


def mg_down_t(u: torch.Tensor | None, g: torch.Tensor, nu1: int, h: int, w: int, bh: float,
              bw: float, out_rows: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``vcycle_t``'s descent in one launch: ``mg_down`` and the transposed
    lane restriction ``mg_restrict_t`` of its rh, which stays on chip.

    u, g as for ``mg_down``. Returns (swept u (C, hp, wp), rc_t (C,
    out_rows, hp2)), hp2 = hp // 2 rounded up to 128, bit-equal to
    ``mg_restrict_t(mg_down(u, g, nu1, h, w, bh, bw, rh_rows=hp2)[1], h, w,
    bw, out_rows)``: the transposed coarse RHS at the origin, exact zeros
    outside [0, wc) x [0, hc).
    """
    c, hp, wp, h, w, nu1 = _check_descent(u, g, h, w, nu1)
    out_rows = int(out_rows)
    hc, wc = (h - 1) // 2, (w - 1) // 2
    if hc < 1 or wc < 1 or wp < 2 * wc + 2 or out_rows < wc:
        raise ValueError(f"slab {(hp, wp)} cannot restrict true size {(h, w)} into "
                         f"{out_rows} rows")
    if g.device.type == "cpu":
        return mg_down_t_plain(u, g, nu1, h, w, bh, bw, out_rows)
    uniform, cuh, cuw, dh, dw = _level_consts(bh, bw)
    gap = 2.0 + bh
    c5, c6, _, _ = _edge_weights_w(bw)
    hp2 = _round_up(hp // 2, 128)
    u_out = torch.empty_like(g)
    rc_t = torch.empty((c, out_rows, hp2), dtype=torch.float32, device=g.device)
    _launch("mg_down_t", g, None if u is None else u.data_ptr(), g.data_ptr(),
            u_out.data_ptr(), rc_t.data_ptr(), c, hp, wp, hp2, out_rows, h, w, nu1,
            int(uniform), cuh, cuw, dh, dw, _f32((1.0 + bh) / gap * 0.5 - 0.25),
            _f32(bh / gap * 0.5), c5, c6)
    return u_out, rc_t


def mg_up_t_plain(u: torch.Tensor, g: torch.Tensor, ec_t: torch.Tensor, nu2: int, h: int,
                  w: int, bh: float = 1.0, bw: float = 1.0) -> torch.Tensor:
    e_lane = mg_prolong_t_plain(ec_t, w, bw, u.shape[1] // 2, u.shape[2])
    return mg_up_plain(u, g, e_lane, nu2, h, w, bh, bw)


def mg_up_t(u: torch.Tensor, g: torch.Tensor, ec_t: torch.Tensor, nu2: int, h: int, w: int,
            bh: float = 1.0, bw: float = 1.0) -> torch.Tensor:
    """``vcycle_t``'s ascent in one launch: the lane prolongation
    ``mg_prolong_t`` of the transposed coarse correction ec_t (C, hp_c,
    lanes >= hp // 2), which stays on chip, then ``mg_up``. u, g as for
    ``mg_up``. Bit-equal to ``mg_up(u, g, mg_prolong_t(ec_t, w, bw,
    out_rows, wp), nu2, h, w, bh, bw)`` for any out_rows in [hp // 2,
    lanes]."""
    c, hp, wp, h, w = _check_ascent(u, g, ec_t, "ec_t", h, w)
    nu2 = _check_nu(nu2, 0, 4, "nu2")
    _, hp_c, lanes = ec_t.shape
    wc = (w - 1) // 2
    if ec_t.shape[0] != c or wc < 1 or hp_c < wc or lanes < hp // 2:
        raise ValueError(f"ec_t {tuple(ec_t.shape)} cannot prolong to w={w}, "
                         f"({hp // 2}, {wp})")
    if u.device.type == "cpu":
        return mg_up_t_plain(u, g, ec_t, nu2, h, w, bh, bw)
    uniform, cuh, cuw, dh, dw = _level_consts(bh, bw)
    gap = 2.0 + bh
    _, _, c7, c8 = _edge_weights_w(bw)
    out = torch.empty_like(u)
    _launch("mg_up_t", u, u.data_ptr(), g.data_ptr(), ec_t.data_ptr(), out.data_ptr(), c, hp,
            wp, hp_c, lanes, h, w, nu2, int(uniform), cuh, cuw, dh, dw,
            _f32(2.0 * (1.0 + bh) / gap), _f32(2.0 * bh / gap), c7, c8)
    return out


# ---------------------------------------------------------------------------
# rb_sweeps / rb_sweeps_tile: red-black bursts, one kernel
# (csrc/rb_sweeps_tile.cu). rb_sweeps on exact-size arrays (solve_redblack,
# the element path's fine-level sweeps); rb_sweeps_tile on one ghosted tile
# of a domain decomposition, colours and domain in global coordinates
# (parallel/tiled.py's per-tile sweeps)
# ---------------------------------------------------------------------------

RB_SWEEPS_PER_LAUNCH = 4  # the kernel is templated on 1 to 4 sweeps (a ring of 2 n)


def _plane(t: torch.Tensor) -> int:
    """A window's channel stride (a single channel's: its rows')."""
    return t.stride(0) if t.shape[0] > 1 else t.shape[1] * t.stride(1)


def _rb_burst(counter: str, u: torch.Tensor, g: torch.Tensor, n: int, rect, parity: int):
    """n >= 1 sweeps of the rb_sweeps_tile kernel updating the local
    rectangle ``rect`` = (r_lo, r_hi, c_lo, c_hi): ceil(n / 4) launches
    ping-ponging between two new dense buffers, each counted under
    ``counter``. Where u or g is a window of a larger array (not
    contiguous), every launch is the window form, reading g, and the first
    launch u, where they lie."""
    c, hl, wl = u.shape
    window = not (u.is_contiguous() and g.is_contiguous())
    bufs = [torch.empty((c, hl, wl), dtype=u.dtype, device=u.device)]
    if n > RB_SWEEPS_PER_LAUNCH:
        bufs.append(torch.empty((c, hl, wl), dtype=u.dtype, device=u.device))
    src = u
    for i, done in enumerate(range(0, n, RB_SWEEPS_PER_LAUNCH)):
        out = bufs[i % 2]  # a launch reads its neighbours' rows of src: never in place
        args = (src.data_ptr(), g.data_ptr(), out.data_ptr(), c, hl, wl,
                min(RB_SWEEPS_PER_LAUNCH, n - done), *rect, parity)
        if window:
            _launch("rb_sweeps_tile_window", u, *args, _plane(src), src.stride(1), _plane(g),
                    g.stride(1), count_as=counter)
            WINDOW_LAUNCHES[counter] += 1
        else:
            _launch("rb_sweeps_tile", u, *args, count_as=counter)
        src = out
    return src


def _check_window(name: str, x: torch.Tensor, c: int, hl: int, wl: int) -> None:
    """x: a (c, hl, wl) f32 window of a larger array, rows of unit stride
    that do not overlap (a contiguous array is one)."""
    _require(x, name, torch.float32, 3, contiguous=False)
    if tuple(x.shape) != (c, hl, wl):
        raise ValueError(f"{name} {tuple(x.shape)} != {(c, hl, wl)}")
    if x.is_contiguous():
        return
    sc, sr, sw = x.stride()
    if sw != 1 or sr < wl or (c > 1 and sc < hl * sr):
        raise ValueError(f"{name} strides {x.stride()} are not a window's (rows of unit "
                         f"stride that do not overlap)")


def rb_sweeps_plain(u: torch.Tensor, g: torch.Tensor, n_sweeps: int) -> torch.Tensor:
    """``n_sweeps`` calls of ``solvers/jacobi.py:redblack_sweep``."""
    from seamlesscloneoptimization_tpu_torch.solvers.jacobi import redblack_sweep

    for _ in range(n_sweeps):
        u = redblack_sweep(u, g)
    return u


def rb_sweeps(u: torch.Tensor, g: torch.Tensor, n_sweeps: int) -> torch.Tensor:
    """``n_sweeps`` red-black Gauss-Seidel sweeps of the 5-point operator on
    (C, H, W) f32 with a zero Dirichlet frame (red half, then black half,
    each ``u <- (N4(u) - g) * 0.25``), bit-equal to as many
    ``redblack_sweep`` calls: the rb_sweeps_tile kernel at origin (0, 0)
    with the whole array as its domain. ceil(n / 4) launches; ``u`` is not
    written, and ``n_sweeps=0`` returns it."""
    _require(u, "u", torch.float32, 3)
    c, h, w = u.shape
    _check_level("g", g, c, h, w)
    _same_device(u, g)
    n = int(n_sweeps)
    if n < 0:
        raise ValueError(f"n_sweeps={n} < 0")
    if n == 0:
        return u
    if u.device.type == "cpu":
        return rb_sweeps_plain(u, g, n)
    return _rb_burst("rb_sweeps", u, g, n, (0, h, 0, w), 0)


def rb_sweeps_tile_plain(u: torch.Tensor, g: torch.Tensor, n_sweeps: int, origin,
                         domain_hw) -> torch.Tensor:
    """The select form of the JAX package's per-tile sweeps
    (``parallel/tiled.py:sweep_region``): the colours from global (row +
    col) parity inside [0, Ht) x [0, Wt) only; per half-sweep the
    zero-padded neighbour sum, ``(nsum - g) * 0.25`` written on one colour."""
    _, hl, wl = u.shape
    rows = int(origin[0]) + torch.arange(hl, device=u.device)[:, None]
    cols = int(origin[1]) + torch.arange(wl, device=u.device)[None, :]
    ht, wt = domain_hw
    in_dom = (rows >= 0) & (rows < ht) & (cols >= 0) & (cols < wt)
    par = (rows + cols) % 2 == 0
    red, black = par & in_dom, ~par & in_dom
    for _ in range(n_sweeps):
        for colour in (red, black):
            up = F.pad(u, (1, 1, 1, 1))
            nsum = up[:, :-2, 1:-1] + up[:, 2:, 1:-1] + up[:, 1:-1, :-2] + up[:, 1:-1, 2:]
            u = torch.where(colour, (nsum - g) * 0.25, u)
    return u


def rb_sweeps_tile(u: torch.Tensor, g: torch.Tensor, n_sweeps: int, origin,
                   domain_hw) -> torch.Tensor:
    """``n_sweeps`` red-black sweeps on a halo-exchanged (C, hl, wl) f32 tile.

    ``origin``: the global (row, col) of local (0, 0), ints, negative where
    the ghost band lies above or left of the domain; ``domain_hw``: the
    global (Ht, Wt). A point is updated only inside the tile and inside
    [0, Ht) x [0, Wt); its colour is the parity of its global row + col;
    points beyond the tile read as 0. ceil(n / 4) launches, bit-equal to
    ``rb_sweeps_tile_plain``; ``u`` is not written, and ``n_sweeps=0``
    returns it. ``u`` and ``g`` may be windows of larger arrays (a band of
    a ghosted tile: rows of unit stride, any row and channel strides): the
    kernel's window form reads them where they lie, and the result is a
    new dense array."""
    _require(u, "u", torch.float32, 3, contiguous=False)
    c, hl, wl = u.shape
    _check_window("u", u, c, hl, wl)
    _check_window("g", g, c, hl, wl)
    _same_device(u, g)
    n = int(n_sweeps)
    if n < 0:
        raise ValueError(f"n_sweeps={n} < 0")
    org_r, org_c = (int(x) for x in origin)
    ht, wt = (int(x) for x in domain_hw)
    if n == 0:
        return u
    if u.device.type == "cpu":
        return rb_sweeps_tile_plain(u, g, n, (org_r, org_c), (ht, wt))
    # the update rectangle in local coordinates: inside the tile and the domain
    rect = (max(0, -org_r), min(hl, ht - org_r), max(0, -org_c), min(wl, wt - org_c))
    return _rb_burst("rb_sweeps_tile", u, g, n, rect, (org_r + org_c) % 2)


# ---------------------------------------------------------------------------
# The quarter-plane finest level: to_quarters, from_quarters,
# preprocess_rhs_q, mg_down_q, mg_restrict_tq, mg_ud_q, mg_up_q,
# mg_prolong_tq, clamp_cast_paste_q (solvers/multigrid.py's "q" path). A
# dense (C, 2 hq, 2 wq2) level lives as four quarter planes (C, 4, hq, wq2):
# plane 2 rp + cp holds dense (2 i + rp, 2 j + cp) at (i, j)
# (csrc/mg_level_q.cuh).
# ---------------------------------------------------------------------------

Q_GHOST = 8  # quarter cells of ring the fused level's staleness may use


def mg_geometry_q(h: int, w: int) -> tuple[int, int, int, int]:
    """(th, hq, wq2, hp2) of the quarter-plane finest level of a true (h, w)
    grid: th = 128 (the TPU strip height, so the fused restriction owns
    whole 128-lane blocks of the coarse RHS), hq and wq2 = ceil(h/2) and
    ceil(w/2) rounded up to 128, hp2 = hq (the coarse level's width)."""
    hq = _round_up((h + 1) // 2, 128)
    return 128, hq, _round_up((w + 1) // 2, 128), _round_up(hq, 128)


def to_quarters_plain(x: torch.Tensor) -> torch.Tensor:
    c, hp, wp = x.shape
    q = x.reshape(c, hp // 2, 2, wp // 2, 2)
    return q.permute(0, 2, 4, 1, 3).reshape(c, 4, hp // 2, wp // 2)


def from_quarters_plain(uq: torch.Tensor) -> torch.Tensor:
    c, _, hq, wq = uq.shape
    return uq.reshape(c, 2, 2, hq, wq).permute(0, 3, 1, 4, 2).reshape(c, 2 * hq, 2 * wq)


def to_quarters(x: torch.Tensor) -> torch.Tensor:
    """(C, 2 HQ, 2 WQ) dense -> (C, 4, HQ, WQ) quarter planes, plane 2 a + b
    holding x[2 i + a, 2 j + b] at (i, j): EE, EO, OE, OO. Moves data only."""
    _require(x, "x", torch.float32, 3)
    c, hp, wp = x.shape
    if hp % 2 or wp % 2 or hp == 0 or wp == 0:
        raise ValueError(f"x {tuple(x.shape)} is not (C, 2 HQ, 2 WQ) with HQ, WQ >= 1")
    if x.device.type == "cpu":
        return to_quarters_plain(x)
    if x.data_ptr() % 8:
        raise ValueError("x must be 8-byte aligned (its kernel moves float2 pairs)")
    out = torch.empty((c, 4, hp // 2, wp // 2), dtype=torch.float32, device=x.device)
    _launch("to_quarters", x, x.data_ptr(), out.data_ptr(), c, hp // 2, wp // 2)
    return out


def from_quarters(uq: torch.Tensor) -> torch.Tensor:
    """(C, 4, HQ, WQ) quarter planes -> (C, 2 HQ, 2 WQ) dense: the inverse of
    ``to_quarters``."""
    _require(uq, "uq", torch.float32, 4)
    c, four, hq, wq = uq.shape
    if four != 4 or hq == 0 or wq == 0:
        raise ValueError(f"uq {tuple(uq.shape)} is not (C, 4, HQ, WQ) quarter planes")
    if uq.device.type == "cpu":
        return from_quarters_plain(uq)
    out = torch.empty((c, 2 * hq, 2 * wq), dtype=torch.float32, device=uq.device)
    _launch("from_quarters", uq, uq.data_ptr(), out.data_ptr(), c, hq, wq)
    return out


def preprocess_rhs_q_plain(dest: torch.Tensor, patch: torch.Tensor,
                           mask_eroded: torch.Tensor, out_hw: tuple[int, int],
                           flags: int = 1, mixed_rule: str = "opencv") -> torch.Tensor:
    c, h, w = dest.shape
    out = torch.zeros((c, *out_hw), dtype=torch.float32, device=dest.device)
    out[:, : h - 2, : w - 2] = _rhs_plain(dest, patch, mask_eroded, flags, mixed_rule)
    return to_quarters_plain(out)


def preprocess_rhs_q(dest: torch.Tensor, patch: torch.Tensor,
                     mask_eroded: torch.Tensor, out_hw: tuple[int, int],
                     flags: int = 1, mixed_rule: str = "opencv") -> torch.Tensor:
    """Fused guidance + divergence + Dirichlet fold, born as quarter planes.

    Inputs as ``preprocess_rhs_p``; ``out_hw`` = (HPo, WPo), both even, is
    the dense footprint (2 hq, 2 wq2) of ``mg_geometry_q``. Returns
    (C, 4, HPo/2, WPo/2) f32: ``to_quarters`` of ``preprocess_rhs_p``'s slab
    (the interior RHS at each plane's origin, exact zeros elsewhere), which
    ``solve_multigrid(padded="q", true_hw=(H-2, W-2))`` starts from.
    """
    _check_rhs_inputs(dest, patch, mask_eroded, flags, mixed_rule)
    c, h, w = dest.shape
    hpo, wpo = int(out_hw[0]), int(out_hw[1])
    if hpo < h - 2 or wpo < w - 2 or hpo % 2 or wpo % 2:
        raise ValueError(f"out_hw {out_hw} is odd or smaller than the interior "
                         f"{(h - 2, w - 2)}")
    if dest.device.type == "cpu":
        return preprocess_rhs_q_plain(dest, patch, mask_eroded, (hpo, wpo), flags,
                                      mixed_rule)
    out = torch.empty((c, 4, hpo // 2, wpo // 2), dtype=torch.float32, device=dest.device)
    _launch("preprocess_rhs_q", dest,
            dest.data_ptr(), *dest.stride(), patch.data_ptr(), *patch.stride(),
            mask_eroded.data_ptr(), out.data_ptr(), c, h, w, hpo, wpo, flags,
            _MIXED_RULES[mixed_rule])
    return out


# -- the plain twins of csrc/mg_level_q.cuh --------------------------------------


def _q_weights() -> dict:
    """The finest level's edge weights (beta = 1), each rounded once to f32:
    the even-h ascent rows (up_a, up_b), the even-h descent row (dn_e,
    dn_o), the even-w lane restriction column (rc_a, rc_b) and the even-w
    lane prolongation column (pr_a, pr_b)."""
    gap = 3.0
    return dict(up_a=_f32(2.0 * 2.0 / gap), up_b=_f32(2.0 / gap),
                dn_e=_f32(2.0 / gap * 0.5), dn_o=_f32(1.0 / gap * 0.5),
                rc_a=_f32(2.0 * 2.0 / gap), rc_b=_f32(2.0 / gap),
                pr_a=_f32(2.0 / gap), pr_b=_f32(1.0 / gap))


def _sh(x: torch.Tensor, di: int, dj: int) -> torch.Tensor:
    """y[..., i, j] = x[..., i + di, j + dj], 0 beyond the array (|di|, |dj| <= 1)."""
    hq, wq = x.shape[-2:]
    return F.pad(x, (1, 1, 1, 1))[..., 1 + di : 1 + di + hq, 1 + dj : 1 + dj + wq]


def _q_doms(hq: int, wq: int, h: int, w: int, device) -> list[torch.Tensor]:
    """The four planes' domain masks, EE, EO, OE, OO."""
    i = torch.arange(hq, device=device)[:, None]
    j = torch.arange(wq, device=device)[None, :]
    return [(2 * i + rp < h) & (2 * j + cp < w) for rp in (0, 1) for cp in (0, 1)]


def _q_sweeps(planes, gq, doms, n: int, u_zero: bool = False):
    """n red-black sweeps on the quarter planes (EE, EO, OE, OO); ``u_zero``:
    the planes are known zero, so the first red half-sweep is (0 - g) * 0.25."""
    ee, eo, oe, oo = planes
    gee, geo, goe, goo = gq
    dee, deo, doe, doo = doms
    for s in range(n):
        if s == 0 and u_zero:
            ee = torch.where(dee, (0.0 - gee) * 0.25, ee)
            oo = torch.where(doo, (0.0 - goo) * 0.25, oo)
        else:
            ns = ((_sh(oe, -1, 0) + oe) + _sh(eo, 0, -1)) + eo
            ee = torch.where(dee, (ns - gee) * 0.25, ee)
            ns = ((eo + _sh(eo, 1, 0)) + oe) + _sh(oe, 0, 1)
            oo = torch.where(doo, (ns - goo) * 0.25, oo)
        ns = ((_sh(oo, -1, 0) + oo) + ee) + _sh(ee, 0, 1)
        eo = torch.where(deo, (ns - geo) * 0.25, eo)
        ns = ((ee + _sh(ee, 1, 0)) + _sh(oo, 0, -1)) + oo
        oe = torch.where(doe, (ns - goe) * 0.25, oe)
    return ee, eo, oe, oo


def _q_residual(planes, gq, doms):
    """The red cells' residual g - (ns - 4 u), 0 outside the domain."""
    ee, eo, oe, oo = planes
    ns = ((_sh(oe, -1, 0) + oe) + _sh(eo, 0, -1)) + eo
    ree = torch.where(doms[0], gq[0] - (ns - 4.0 * ee), 0.0)
    ns = ((eo + _sh(eo, 1, 0)) + oe) + _sh(oe, 0, 1)
    roo = torch.where(doms[3], gq[3] - (ns - 4.0 * oo), 0.0)
    return ree, roo


def _q_rh(ree, roo, h: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Row restriction of the red residual, split into the even / odd dense
    columns: rh_e, rh_o (C, hq, wq2), rows [0, hc) data, zeros beyond."""
    wt = _q_weights()
    hq = ree.shape[1]
    hc = (h - 1) // 2
    ree_dn, roo_dn = _sh(ree, 1, 0), _sh(roo, 1, 0)
    if h % 2 == 0:  # coarse row hc-1 takes the beta-gap weights of fine h-2, h-1
        w_e = torch.full((hq, 1), 0.25, device=ree.device)
        w_o = torch.zeros((hq, 1), device=ree.device)
        w_e[hc - 1], w_o[hc - 1] = wt["dn_e"], wt["dn_o"]
        rh_e = 0.25 * ree + w_e * ree_dn
        rh_o = 0.5 * roo + w_o * roo_dn
    else:
        rh_e = 0.25 * ree + 0.25 * ree_dn
        rh_o = 0.5 * roo
    data = (torch.arange(hq, device=ree.device) < hc)[:, None]
    return torch.where(data, rh_e, 0.0), torch.where(data, rh_o, 0.0)


def mg_restrict_tq_plain(rh_e: torch.Tensor, rh_o: torch.Tensor, h: int, w: int,
                         out_rows: int) -> torch.Tensor:
    """The transposed x4 lane restriction of the split rh planes: (C,
    out_rows, rh rows), zeros for rows >= wc and lanes >= hc (whatever the
    rh planes hold there)."""
    wt = _q_weights()
    hc, wc = (h - 1) // 2, (w - 1) // 2
    out = (rh_e[..., :wc] + 2.0 * rh_o[..., :wc]) + rh_e[..., 1 : wc + 1]
    if w % 2 == 0:
        edge = (((rh_e[..., wc - 1] + 2.0 * rh_o[..., wc - 1]) + wt["rc_a"] * rh_e[..., wc])
                + wt["rc_b"] * rh_o[..., wc])
        out = torch.cat([out[..., : wc - 1], edge[..., None]], dim=-1)
    out = torch.where((torch.arange(rh_e.shape[1], device=rh_e.device) < hc)[:, None], out, 0.0)
    return F.pad(out.transpose(1, 2), (0, 0, 0, out_rows - wc)).contiguous()


def _q_correct(planes, e_even, e_odd, doms, h: int):
    """The ascent's correction: dense row 2q += 0.5 (E(q-1) + E(q)), row 2q+1
    += E(q), E = the split planes' rows [0, hc) and 0 beyond; for even h,
    quarter row hc takes mids * up_a and mids * up_b."""
    wt = _q_weights()
    hq = planes[0].shape[1]
    hc = (h - 1) // 2
    rows = torch.arange(hq, device=e_even.device)[:, None]
    e0 = torch.where(rows < hc, e_even[:, :hq], 0.0)
    o0 = torch.where(rows < hc, e_odd[:, :hq], 0.0)
    mid_e = 0.5 * (_sh(e0, -1, 0) + e0)
    mid_o = 0.5 * (_sh(o0, -1, 0) + o0)
    corr = [mid_e, mid_o, e0, o0]
    if h % 2 == 0:
        edge = rows == hc
        corr = [torch.where(edge, mid_e * wt["up_a"], mid_e),
                torch.where(edge, mid_o * wt["up_a"], mid_o),
                torch.where(edge, mid_e * wt["up_b"], e0),
                torch.where(edge, mid_o * wt["up_b"], o0)]
    return tuple(torch.where(d, p + cq, p) for p, cq, d in zip(planes, corr, doms))


def _q_rmax(ree, roo) -> torch.Tensor:
    return torch.maximum(ree.abs().amax(), roo.abs().amax())


def _q_down(planes, gq, doms, nu1, h, w, chp, u_zero=False):
    planes = _q_sweeps(planes, gq, doms, nu1, u_zero)
    ree, roo = _q_residual(planes, gq, doms)
    return planes, mg_restrict_tq_plain(*_q_rh(ree, roo, h), h, w, chp), ree, roo


def mg_down_q_plain(uq: torch.Tensor | None, gq: torch.Tensor, nu1: int, h: int, w: int,
                    rct_rows: int | None = None) -> tuple[torch.Tensor, ...]:
    _, _, hq, wq2 = gq.shape
    doms = _q_doms(hq, wq2, h, w, gq.device)
    planes = tuple(gq.new_zeros(gq.shape[:1] + gq.shape[2:]) for _ in range(4)) \
        if uq is None else uq.unbind(1)
    planes = _q_sweeps(planes, gq.unbind(1), doms, nu1, uq is None)
    rh = _q_rh(*_q_residual(planes, gq.unbind(1), doms), h)
    if rct_rows is None:
        return (torch.stack(planes, 1),) + rh
    return torch.stack(planes, 1), mg_restrict_tq_plain(*rh, h, w, rct_rows)


def mg_up_q_plain(uq: torch.Tensor, gq: torch.Tensor, e_even: torch.Tensor,
                  e_odd: torch.Tensor, nu2: int, h: int, w: int,
                  with_residual: bool = False):
    _, _, hq, wq2 = gq.shape
    g4 = gq.unbind(1)
    doms = _q_doms(hq, wq2, h, w, gq.device)
    planes = _q_sweeps(_q_correct(uq.unbind(1), e_even, e_odd, doms, h), g4, doms, nu2)
    if with_residual:
        return torch.stack(planes, 1), _q_rmax(*_q_residual(planes, g4, doms))
    return torch.stack(planes, 1)


def mg_ud_q_plain(uq: torch.Tensor, gq: torch.Tensor, e_even: torch.Tensor,
                  e_odd: torch.Tensor, nu2: int, nu1: int, h: int, w: int, rct_rows: int,
                  with_residual: bool = False):
    _, _, hq, wq2 = gq.shape
    g4 = gq.unbind(1)
    doms = _q_doms(hq, wq2, h, w, gq.device)
    planes = _q_sweeps(_q_correct(uq.unbind(1), e_even, e_odd, doms, h), g4, doms, nu2)
    planes, rc_t, ree, roo = _q_down(planes, g4, doms, nu1, h, w, rct_rows)
    out = (torch.stack(planes, 1), rc_t)
    if with_residual:
        return out + (_q_rmax(ree, roo),)
    return out


def _check_q(name: str, x: torch.Tensor, shape: tuple[int, ...]) -> None:
    _require(x, name, torch.float32, len(shape))
    if tuple(x.shape) != shape:
        raise ValueError(f"{name} {tuple(x.shape)} != {shape}")


def _check_q_level(gq: torch.Tensor, h: int, w: int) -> tuple[int, int, int, int, int]:
    """(c, hq, wq2, h, w) of a quarter level: g (C, 4, hq, wq2) with hq and
    wq2 multiples of 128 covering the true (h, w) domain."""
    _require(gq, "gq", torch.float32, 4)
    c, four, hq, wq2 = gq.shape
    h, w = int(h), int(w)
    if four != 4 or hq % 128 or wq2 % 128:
        raise ValueError(f"gq {tuple(gq.shape)} is not (C, 4, 128k, 128m) quarter planes")
    if not (3 <= h <= 2 * hq and 3 <= w <= 2 * wq2):
        raise ValueError(f"true size {(h, w)} outside [3, {(2 * hq, 2 * wq2)}]")
    return c, hq, wq2, h, w


def _check_rct(rct_rows: int, w: int, wq2: int) -> int:
    rct_rows = int(rct_rows)
    if not (w - 1) // 2 <= rct_rows <= wq2:
        raise ValueError(f"rct_rows {rct_rows} outside [wc, wq2] = [{(w - 1) // 2}, {wq2}]")
    return rct_rows


def mg_down_q(uq: torch.Tensor | None, gq: torch.Tensor, nu1: int, h: int, w: int,
              rct_rows: int | None = None) -> tuple[torch.Tensor, ...]:
    """Quarter-plane descent at the finest level (beta = 1): ``nu1``
    red-black sweeps, the red-cell residual and its row restriction, in one
    pass; with ``rct_rows`` also the transposed x4 lane restriction.

    gq, uq: (C, 4, hq, wq2) per ``mg_geometry_q(h, w)``, exact zeros outside
    the true (h, w) domain; ``uq=None`` is a known-zero guess. rct_rows: the
    coarse level's row extent chp (``mg_geometry_t(wc, hc, wp_min=hq)[1]``).
    Returns (swept uq, rc_t (C, chp, hq)): the coarse RHS of the (wc, hc)
    level in transposed orientation, exact zeros outside it. ``rct_rows=
    None`` is the split form: (swept uq, rh_e, rh_o), the row-restricted
    residual's even / odd dense columns (C, hq, wq2), rows [0, hc) data and
    exact zeros beyond, which ``mg_restrict_tq`` restricts.
    """
    c, hq, wq2, h, w = _check_q_level(gq, h, w)
    if uq is not None:
        _check_q("uq", uq, (c, 4, hq, wq2))
        _same_device(gq, uq)
    nu1 = _check_nu(nu1, 1, 2, "nu1")
    if rct_rows is not None:
        rct_rows = _check_rct(rct_rows, w, wq2)
    if gq.device.type == "cpu":
        return mg_down_q_plain(uq, gq, nu1, h, w, rct_rows)
    wt = _q_weights()
    u_out = torch.empty_like(gq)
    if rct_rows is None:
        outs = (torch.empty((c, hq, wq2), dtype=torch.float32, device=gq.device),
                torch.empty((c, hq, wq2), dtype=torch.float32, device=gq.device))
        ptrs = (None, outs[0].data_ptr(), outs[1].data_ptr())
    else:
        outs = (torch.empty((c, rct_rows, hq), dtype=torch.float32, device=gq.device),)
        ptrs = (outs[0].data_ptr(), None, None)
    _launch("mg_down_q", gq, None if uq is None else uq.data_ptr(), gq.data_ptr(),
            u_out.data_ptr(), *ptrs, c, hq, wq2, rct_rows or 0, h, w, nu1,
            wt["dn_e"], wt["dn_o"], wt["rc_a"], wt["rc_b"])
    return (u_out,) + outs


def mg_restrict_tq(rh_e: torch.Tensor, rh_o: torch.Tensor, h: int, w: int,
                   out_rows: int) -> torch.Tensor:
    """Transposed x4 lane restriction of the split row-restricted residual.

    rh_e, rh_o: (C, hp2, wq2) f32 (the split ``mg_down_q``'s), rows [0, hc)
    read; anything else in them is never read into the result. Returns
    (C, out_rows, hp2): the coarse RHS of the (wc, hc) level in transposed
    orientation, exact zeros for rows >= wc and lanes >= hc; equal to the
    fused ``mg_down_q``'s rc_t.
    """
    _require(rh_e, "rh_e", torch.float32, 3)
    _check_q("rh_o", rh_o, tuple(rh_e.shape))
    _same_device(rh_e, rh_o)
    c, hp2, wq2 = rh_e.shape
    h, w, out_rows = int(h), int(w), int(out_rows)
    hc, wc = (h - 1) // 2, (w - 1) // 2
    if hc < 1 or wc < 1 or hp2 < hc or wq2 < wc + 1 or out_rows < wc:
        raise ValueError(f"rh planes {tuple(rh_e.shape)} cannot restrict a {h}x{w} level "
                         f"into {out_rows} rows")
    if rh_e.device.type == "cpu":
        return mg_restrict_tq_plain(rh_e, rh_o, h, w, out_rows)
    wt = _q_weights()
    out = torch.empty((c, out_rows, hp2), dtype=torch.float32, device=rh_e.device)
    _launch("mg_restrict_tq", rh_e, rh_e.data_ptr(), rh_o.data_ptr(), out.data_ptr(), c, hp2,
            wq2, out_rows, h, w, wt["rc_a"], wt["rc_b"])
    return out


def _check_up_inputs(uq, gq, e_even, e_odd, h, w):
    c, hq, wq2, h, w = _check_q_level(gq, h, w)
    _check_q("uq", uq, (c, 4, hq, wq2))
    _check_q("e_even", e_even, (c, hq, wq2))
    _check_q("e_odd", e_odd, (c, hq, wq2))
    _same_device(gq, uq, e_even, e_odd)
    return c, hq, wq2, h, w


Q_TILE = (32, 64)  # the quarter level kernel's owned tile (csrc/mg_level_q.cuh: kTH, kTW)


def _tile_maxima(c: int, hq: int, wq2: int, device) -> torch.Tensor:
    """The per-tile max |r| buffer of a residual-reporting level launch: one
    float per (channel, Q_TILE quarter tile)."""
    return torch.empty((c * (hq // Q_TILE[0]) * (wq2 // Q_TILE[1]),), dtype=torch.float32,
                       device=device)


def mg_up_q(uq: torch.Tensor, gq: torch.Tensor, e_even: torch.Tensor, e_odd: torch.Tensor,
            nu2: int, h: int, w: int, with_residual: bool = False):
    """Quarter-plane ascent at the finest level: the row prolongation of the
    split coarse correction (``mg_prolong_tq``'s e_even, e_odd (C, hq, wq2),
    rows [0, hc) used), added inside the domain, then ``nu2`` red-black
    sweeps. uq, gq as for ``mg_down_q``. Returns the swept uq;
    ``with_residual`` returns (uq, max |g - A u| of it as a 0-dim device
    tensor: the red cells' residual; black cells are 0)."""
    c, hq, wq2, h, w = _check_up_inputs(uq, gq, e_even, e_odd, h, w)
    nu2 = _check_nu(nu2, 0, 4, "nu2")
    if gq.device.type == "cpu":
        return mg_up_q_plain(uq, gq, e_even, e_odd, nu2, h, w, with_residual)
    wt = _q_weights()
    u_out = torch.empty_like(gq)
    tiles = _tile_maxima(c, hq, wq2, gq.device) if with_residual else None
    _launch("mg_up_q", gq, uq.data_ptr(), gq.data_ptr(), e_even.data_ptr(), e_odd.data_ptr(),
            u_out.data_ptr(), None if tiles is None else tiles.data_ptr(), c, hq, wq2, h, w,
            nu2, wt["up_a"], wt["up_b"])
    if with_residual:
        return u_out, tiles.amax()
    return u_out


def mg_ud_q(uq: torch.Tensor, gq: torch.Tensor, e_even: torch.Tensor, e_odd: torch.Tensor,
            nu2: int, nu1: int, h: int, w: int, rct_rows: int, with_residual: bool = False):
    """One V-cycle boundary in one pass: ``mg_up_q`` (cycle k's ascent), then
    ``mg_down_q`` (cycle k+1's descent) on the same tile, the post-ascent
    state never leaving shared memory. Inputs as ``mg_up_q``, outputs as
    ``mg_down_q``: (swept uq, rc_t); ``with_residual`` appends max |g - A u|
    of the returned uq as a 0-dim device tensor (the red cells' residual
    that the restriction already computes; black cells are 0)."""
    c, hq, wq2, h, w = _check_up_inputs(uq, gq, e_even, e_odd, h, w)
    nu2 = _check_nu(nu2, 0, 4, "nu2")
    nu1 = _check_nu(nu1, 1, Q_GHOST - 2 - nu2, "nu1")
    rct_rows = _check_rct(rct_rows, w, wq2)
    if gq.device.type == "cpu":
        return mg_ud_q_plain(uq, gq, e_even, e_odd, nu2, nu1, h, w, rct_rows, with_residual)
    wt = _q_weights()
    u_out = torch.empty_like(gq)
    rc_t = torch.empty((c, rct_rows, hq), dtype=torch.float32, device=gq.device)
    tiles = _tile_maxima(c, hq, wq2, gq.device) if with_residual else None
    _launch("mg_ud_q", gq, uq.data_ptr(), gq.data_ptr(), e_even.data_ptr(), e_odd.data_ptr(),
            u_out.data_ptr(), rc_t.data_ptr(), None if tiles is None else tiles.data_ptr(),
            c, hq, wq2, rct_rows, h, w, nu2, nu1, wt["up_a"], wt["up_b"], wt["dn_e"],
            wt["dn_o"], wt["rc_a"], wt["rc_b"])
    if with_residual:
        return u_out, rc_t, tiles.amax()
    return u_out, rc_t


def mg_prolong_tq_plain(ec_t: torch.Tensor, w: int, out_rows: int,
                        wq2: int) -> tuple[torch.Tensor, torch.Tensor]:
    wt = _q_weights()
    c, hp_c, _ = ec_t.shape
    wc = (w - 1) // 2
    e = ec_t[:, :, :out_rows]                     # (C, hp_c, L): rows = coarse w
    ep = F.pad(e, (0, 0, 1, 1))                   # zero Dirichlet rows
    mids = 0.5 * (ep[:, : wc + 1] + ep[:, 1 : wc + 2])
    if w % 2:
        ev, od = mids[:, : wc + 1], e[:, :wc]
    else:
        last = e[:, wc - 1 : wc]
        ev = torch.cat([mids[:, :wc], last * wt["pr_a"]], dim=1)
        od = torch.cat([e[:, :wc], last * wt["pr_b"]], dim=1)

    def plane(x):
        return F.pad(x, (0, 0, 0, wq2 - x.shape[1])).transpose(1, 2).contiguous()

    return plane(ev), plane(od)


def mg_prolong_tq(ec_t: torch.Tensor, w: int, out_rows: int,
                  wq2: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Lane prolongation of the TRANSPOSED coarse correction, split form.

    ec_t: (C, hp_c, lanes) f32, the coarse solution ((wc, hc) at the origin,
    exact zeros elsewhere). Returns (e_even, e_odd), each (C, out_rows, wq2):
    the even / odd dense-column planes of the bilinear prolongation along
    the fine w axis (the beta-gap weights on column wc for even w), every
    other element an exact 0 — ``mg_up_q``'s correction operands.
    """
    _require(ec_t, "ec_t", torch.float32, 3)
    c, hp_c, lanes = ec_t.shape
    w, out_rows, wq2 = int(w), int(out_rows), int(wq2)
    wc = (w - 1) // 2
    if wc < 1 or hp_c < wc or lanes < out_rows or wq2 < (w + 1) // 2:
        raise ValueError(f"ec_t {tuple(ec_t.shape)} cannot prolong to w={w}, "
                         f"({out_rows}, {wq2})")
    if ec_t.device.type == "cpu":
        return mg_prolong_tq_plain(ec_t, w, out_rows, wq2)
    wt = _q_weights()
    e_e = torch.empty((c, out_rows, wq2), dtype=torch.float32, device=ec_t.device)
    e_o = torch.empty_like(e_e)
    _launch("mg_prolong_tq", ec_t, ec_t.data_ptr(), e_e.data_ptr(), e_o.data_ptr(), c, hp_c,
            lanes, out_rows, wq2, w, wt["pr_a"], wt["pr_b"])
    return e_e, e_o


def clamp_cast_paste_q_plain(uq: torch.Tensor, dst: torch.Tensor, top1: int, left1: int,
                             h2: int, w2: int) -> torch.Tensor:
    u = from_quarters_plain(uq)[:, :h2, :w2]
    dst[:, top1 : top1 + h2, left1 : left1 + w2] = clamp_truncate_u8(u)
    return dst


def clamp_cast_paste_q(uq: torch.Tensor, dst: torch.Tensor, top1: int, left1: int,
                       h2: int, w2: int) -> torch.Tensor:
    """``clamp_cast_paste`` straight from quarter planes: uq (C, 4, hq, wq2),
    the dense interior (h2, w2) at the origin of ``from_quarters(uq)``,
    clamped, truncated to u8 and written in place into ``dst`` at (top1,
    left1); ``dst`` as for ``clamp_cast_paste``. Returns ``dst``."""
    _require(uq, "uq", torch.float32, 4)
    c, four, hq, wq2 = uq.shape
    if four != 4:
        raise ValueError(f"uq {tuple(uq.shape)} is not (C, 4, hq, wq2) quarter planes")
    top1, left1, h2, w2 = _check_paste(uq, dst, top1, left1, h2, w2, rows=2 * hq)
    if w2 > 2 * wq2:
        raise ValueError(f"uq {tuple(uq.shape)} cannot fill ({c}, {h2}, {w2})")
    if uq.device.type == "cpu":
        return clamp_cast_paste_q_plain(uq, dst, top1, left1, h2, w2)
    _launch("clamp_cast_paste_q", uq, uq.data_ptr(), c, hq, wq2, dst.data_ptr(),
            *dst.stride(), top1, left1, h2, w2)
    return dst
