"""Plain-PyTorch reference of one served request: seamless cloning (Poisson
image editing, Perez et al. 2003, in OpenCV's ``seamlessClone`` form)
replayed over the request's chained frames.

Written from the algorithm, independent of the program under test: it
imports torch alone and takes only the inputs the benchmark made (source,
destination, host mask, centre, flags). Each frame:

1. binarize the mask, zero its 1-px frame, take its bounding box; the ROI
   is centred at ``center`` (left = cx - bw // 2, top = cy - bh // 2);
2. the patch is the source's bbox window zeroed outside the mask;
3. the mask window eroded three times by a 3x3 box, zero outside it;
4. the guidance: forward differences of destination ROI and patch (last
   column / row zero), blended by the eroded mask; MIXED keeps the
   destination's where |gx_p - gy_p| <= |gx_d - gy_d| (OpenCV's rule),
   MONOCHROME takes the patch's gray (BGR2GRAY in shift-15 fixed point);
5. the RHS: backward divergence on the interior minus the Dirichlet ring of
   the destination ROI;
6. the exact solve in the DST-I eigenbasis, ``u = V_h ((V_h g V_w) /
   (lam_h + lam_w)) V_w``;
7. clamp to [0, 255], truncate to u8, write the interior in place.

The next frame reads the destination this frame wrote (the serve loop's
chaining), so the whole (H, W, 3) image after F frames is the answer.

``precision="float64"`` is the reference. ``precision="tf32"`` is the
control: the same steps in float32 with every GEMM operand rounded to
TF32 (10 mantissa bits, round to nearest, ties away, as the tensor cores
convert), the step below the float32 with TF32 off that the configurations
state. ``precision="float32"`` (TF32 off) is the configurations' own
precision, for the witness of chained frames (``witness.py``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

NORMAL_CLONE, MIXED_CLONE, MONOCHROME_TRANSFER = 1, 2, 3
PRECISIONS = ("float64", "float32", "tf32")


def prep_mask(mask: torch.Tensor):
    """(bool mask with a zeroed 1-px frame, (x0, y0, bw, bh) or None)."""
    m = mask != 0
    m[0, :] = False
    m[-1, :] = False
    m[:, 0] = False
    m[:, -1] = False
    rows = torch.nonzero(m.any(dim=1)).flatten()
    cols = torch.nonzero(m.any(dim=0)).flatten()
    if rows.numel() == 0:
        return m, None
    y0, y1 = int(rows[0]), int(rows[-1])
    x0, x1 = int(cols[0]), int(cols[-1])
    return m, (x0, y0, x1 - x0 + 1, y1 - y0 + 1)


def roi_placement(bbox, dst_hw, center) -> tuple[int, int]:
    """(left, top) of the ROI of ``bbox`` (x0, y0, bw, bh) centred at
    ``center``; raises where it leaves the destination."""
    _, _, bw, bh = bbox
    left, top = center[0] - bw // 2, center[1] - bh // 2
    if left < 0 or top < 0 or left + bw > dst_hw[1] or top + bh > dst_hw[0]:
        raise ValueError(f"ROI ({left},{top})+({bw}x{bh}) outside the destination {dst_hw}")
    return left, top


def erode3x3(m: torch.Tensor, iterations: int = 3) -> torch.Tensor:
    """Binary 3x3 erosion, everything outside the window counting as 0."""
    h, w = m.shape
    x = m.to(torch.uint8)
    for _ in range(iterations):
        p = F.pad(x, (1, 1, 1, 1))
        acc = torch.ones_like(x)
        for dy in range(3):
            for dx in range(3):
                acc = acc & p[dy:dy + h, dx:dx + w]
        x = acc
    return x.bool()


def _grad_x(a: torch.Tensor) -> torch.Tensor:
    g = torch.zeros_like(a)
    g[..., :, :-1] = a[..., :, 1:] - a[..., :, :-1]
    return g


def _grad_y(a: torch.Tensor) -> torch.Tensor:
    g = torch.zeros_like(a)
    g[..., :-1, :] = a[..., 1:, :] - a[..., :-1, :]
    return g


def _gray(patch_u8: torch.Tensor) -> torch.Tensor:
    """OpenCV BGR2GRAY of a planar (3, H, W) u8 patch, shift-15 fixed point."""
    b, g, r = (patch_u8[i].to(torch.int64) for i in range(3))
    return (b * 3735 + g * 19235 + r * 9798 + (1 << 14)) >> 15


def rhs(dest: torch.Tensor, patch_u8: torch.Tensor, eroded: torch.Tensor, flags: int,
        dtype: torch.dtype) -> torch.Tensor:
    """The Poisson RHS on the interior, (3, h - 2, w - 2), from a planar
    destination ROI and patch (u8) and the eroded mask (bool)."""
    d = dest.to(dtype)
    m = eroded.to(dtype)
    gx_d, gy_d = _grad_x(d), _grad_y(d)
    if flags == MONOCHROME_TRANSFER:
        gray = _gray(patch_u8).to(dtype)
        gx_p, gy_p = _grad_x(gray).expand_as(d), _grad_y(gray).expand_as(d)
    elif flags in (NORMAL_CLONE, MIXED_CLONE):
        p = patch_u8.to(dtype)
        gx_p, gy_p = _grad_x(p), _grad_y(p)
        if flags == MIXED_CLONE:
            take_d = (gx_p - gy_p).abs() <= (gx_d - gy_d).abs()
            gx_p = torch.where(take_d, gx_d, gx_p)
            gy_p = torch.where(take_d, gy_d, gy_p)
    else:
        raise ValueError(f"unknown flags {flags}")
    gx = (1 - m) * gx_d + m * gx_p
    gy = (1 - m) * gy_d + m * gy_p
    lap = torch.zeros_like(gx)
    lap[..., :, 1:] += gx[..., :, 1:] - gx[..., :, :-1]
    lap[..., 1:, :] += gy[..., 1:, :] - gy[..., :-1, :]
    g = lap[:, 1:-1, 1:-1].clone()
    g[:, 0, :] -= d[:, 0, 1:-1]
    g[:, -1, :] -= d[:, -1, 1:-1]
    g[:, :, 0] -= d[:, 1:-1, 0]
    g[:, :, -1] -= d[:, 1:-1, -1]
    return g


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits, to nearest, ties away."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


class DstSolver:
    """Exact Poisson solve (5-point Laplacian, Dirichlet frame) by the
    orthonormal DST-I basis, its matrices built once per size."""

    def __init__(self, precision: str, device):
        if precision not in PRECISIONS:
            raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
        self.precision = precision
        self.dtype = torch.float64 if precision == "float64" else torch.float32
        self.device = device
        self._cache: dict[int, tuple[torch.Tensor, torch.Tensor]] = {}

    def _basis(self, n: int):
        if n not in self._cache:
            i = torch.arange(1, n + 1, dtype=torch.float64, device=self.device)
            v = torch.sin(torch.outer(i, i) * (math.pi / (n + 1))) * math.sqrt(2.0 / (n + 1))
            lam = 2.0 * (torch.cos(i * (math.pi / (n + 1))) - 1.0)
            self._cache[n] = (v.to(self.dtype), lam.to(self.dtype))
        return self._cache[n]

    def _mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.precision == "tf32":
            a, b = round_tf32(a), round_tf32(b)
        return torch.matmul(a, b)

    def solve(self, g: torch.Tensor) -> torch.Tensor:
        """u with A u = g, g (C, h, w) in this solver's dtype."""
        _, h, w = g.shape
        vh, lh = self._basis(h)
        vw, lw = self._basis(w)
        ghat = self._mm(self._mm(vh, g), vw)
        return self._mm(self._mm(vh, ghat / (lh[:, None] + lw[None, :])), vw)


def serve_request(src: torch.Tensor, dst: torch.Tensor, mask: torch.Tensor, center,
                  flags: int, frames: int, solver: DstSolver) -> torch.Tensor:
    """The (H, W, 3) u8 image after ``frames`` chained frames of one request.

    src (hs, ws, 3) u8, dst (hd, wd, 3) u8 (left unchanged), mask (hs, ws)
    u8, center (x, y), all on ``solver.device``."""
    m, bbox = prep_mask(mask.to(solver.device).clone())
    if bbox is None:
        return dst.clone()
    x0, y0, bw, bh = bbox
    left, top = roi_placement(bbox, dst.shape[:2], center)
    mask_roi = m[y0:y0 + bh, x0:x0 + bw]
    src_roi = src[y0:y0 + bh, x0:x0 + bw].permute(2, 0, 1)
    patch = torch.where(mask_roi[None], src_roi, torch.zeros_like(src_roi))
    eroded = erode3x3(mask_roi)
    cur = dst.permute(2, 0, 1).contiguous()
    for _ in range(frames):
        dest = cur[:, top:top + bh, left:left + bw]
        u = solver.solve(rhs(dest, patch, eroded, flags, solver.dtype))
        cur[:, top + 1:top + bh - 1, left + 1:left + bw - 1] = (
            torch.floor(u.clamp(0.0, 255.0)).to(torch.uint8))
    return cur.permute(1, 2, 0).contiguous()
