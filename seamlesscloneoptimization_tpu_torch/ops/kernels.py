"""The hand-written CUDA kernels of the DST-GEMM serve path, with their
plain PyTorch twins and launch counters.

The port's counterpart of ``seamlesscloneoptimization_tpu/ops/pallas_kernels.py``
for ROADMAP slices 1 and 2:

============================  =============================================
wrapper                       replaces (pallas_kernels.py)
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
============================  =============================================

Each wrapper checks device, dtype, shape and layout, allocates its output
with ``torch.empty``, launches on the current stream and raises when the
launch returns a non-zero ``cudaError_t``. Given a CPU tensor it runs its
``*_plain`` twin instead — only then: a CUDA tensor launches the kernel or
raises, never falls back. ``LAUNCHES[name]`` counts kernel launches (the
twins do not count), so a run can show that it went through the kernels.
The sources are ``csrc/<name>.cu`` (the three unfold kernels share
``csrc/fold.cuh``), built by ``ops/_build.py``.
"""

from __future__ import annotations

import torch

from seamlesscloneoptimization_tpu_torch.ops._build import kernel_function
from seamlesscloneoptimization_tpu_torch.ops.guidance import guidance_field
from seamlesscloneoptimization_tpu_torch.ops.mask import erode3x3
from seamlesscloneoptimization_tpu_torch.ops.postprocess import clamp_truncate_u8
from seamlesscloneoptimization_tpu_torch.ops.rhs import poisson_rhs

LAUNCHES = {"erode3": 0, "preprocess_rhs_t": 0, "transpose": 0,
            "clamp_cast_paste": 0, "fold_minor": 0, "unfold_minor": 0,
            "transpose_pair": 0, "unfold_transpose": 0, "unfold_clamp_paste": 0}

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
    c, hu, wu = u.shape
    top1, left1, h2, w2 = _check_paste(u, dst, top1, left1, h2, w2)
    if w2 > wu:
        raise ValueError(f"u {tuple(u.shape)} cannot fill ({c}, {h2}, {w2})")
    if u.device.type == "cpu":
        return clamp_cast_paste_plain(u, dst, top1, left1, h2, w2)
    _launch("clamp_cast_paste", u, u.data_ptr(), c, hu, wu, dst.data_ptr(),
            *dst.stride(), top1, left1, h2, w2)
    return dst


def _check_paste(u: torch.Tensor, dst: torch.Tensor, top1, left1, h2, w2):
    """The paste contract shared by clamp_cast_paste and unfold_clamp_paste:
    ``dst`` a (C, H, W) u8 view with positive strides, u's channels and rows
    cover (C, h2), the interior lies inside ``dst``. Returns the ints."""
    _require(dst, "dst", torch.uint8, 3, contiguous=False)
    _same_device(u, dst)
    c, hu = u.shape[:2]
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
