"""Local gradient-domain editing: OpenCV's photo-module family.

Port of ``seamlesscloneoptimization_tpu/ops/edit.py``. cv2's
``colorChange`` / ``illuminationChange`` / ``textureFlattening`` share the
seamless-clone machinery (the same Poisson solve, the same Dirichlet
treatment) but run on the WHOLE image: interior (H-2, W-2), boundary the
image border, the guidance gradients modified only inside the 3x-eroded
mask. The rules are the JAX package's, pinned against cv2 to diff_max <= 1.

The edit parameters (channel factors, alpha / beta) are tensors, so a sweep
over them reuses the cached DST bases of the image's shape.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from seamlesscloneoptimization_tpu_torch.ops.guidance import gradient_x, gradient_y
from seamlesscloneoptimization_tpu_torch.ops.kernels import clamp_cast_paste
from seamlesscloneoptimization_tpu_torch.ops.rhs import poisson_rhs

COLOR_CHANGE = "color_change"
ILLUMINATION_CHANGE = "illumination_change"
TEXTURE_FLATTENING = "texture_flattening"


def erode3x3_replicate(mask01: torch.Tensor, iterations: int = 3) -> torch.Tensor:
    """(H, W) {0,1} -> 3x3-eroded {0,1} f32, out-of-bounds counting as SET.

    cv2.erode's default border for erosion (replicate-max): border pixels
    survive unless an in-image neighbour is zero, unlike seamlessClone's
    zero-border erosion (``ops/mask.py``, the ``erode3`` kernel), because
    the local-edit path never border-zeroes its mask. Plain torch.
    """
    return erode3x3_replicate_window(mask01, None, iterations)


def erode3x3_replicate_window(mask01: torch.Tensor, inside: torch.Tensor | None,
                              iterations: int = 3) -> torch.Tensor:
    """``erode3x3_replicate`` on a window of the mask: the cells where the
    bool ``inside`` (the window's shape) is False lie past the image and are
    held set at every erosion (the replicate border); the window's own edge
    goes stale a ring an erosion. ``inside=None``: the whole mask."""
    m = mask01.to(torch.float32)
    h, w = m.shape
    for _ in range(iterations):
        p = F.pad(m, (1, 1, 1, 1), value=1.0)
        acc = m
        for dy in range(3):
            for dx in range(3):
                acc = torch.minimum(acc, p[dy : dy + h, dx : dx + w])
        m = acc if inside is None else torch.where(inside, acc, 1.0)
    return m


def edit_inputs(src, mask, params, edge_mask, device):
    """An edit's host inputs as the tensors the edit takes, on ``device``:
    (the planar (C, H, W) u8 source, the 3x-eroded mask, the params f32,
    the edge mask f32 {0,1} or None). src: (H, W, C) u8; mask: (H, W), any
    nonzero byte inside, or None (everything); edge_mask: (H, W) u8
    {0,255} or None."""
    src = np.asarray(src)
    if mask is None:
        mask = np.full(src.shape[:2], 255, np.uint8)
    m01 = torch.from_numpy((np.asarray(mask) != 0).astype(np.float32)).to(device)
    src_p = torch.from_numpy(np.ascontiguousarray(np.transpose(src, (2, 0, 1)))).to(device)
    edge = (None if edge_mask is None else
            torch.from_numpy(np.asarray(edge_mask, np.float32) / 255.0).to(device))
    return (src_p, erode3x3_replicate(m01),
            torch.as_tensor(np.asarray(params, np.float32), device=device), edge)


def edit_guidance(src_f, me, params, edge_mask, *, kind):
    """The per-kind guidance-field modification, the one source of its rules:
    ``local_edit_planar`` and ``parallel/clone_tiled.py:local_edit_tiled``
    both call it.

    src_f: (C, H, W) f32 image. me: (H, W) f32 {0,1} eroded mask. params:
    (C,) factors (COLOR_CHANGE), (2,) [alpha, beta] (ILLUMINATION_CHANGE),
    unused (TEXTURE_FLATTENING, whose ``edge_mask`` (H, W) f32 {0,1} keeps
    the gradients at edges). Returns (gx, gy): outside the mask the
    source's gradients, inside them transformed per ``kind``.
    """
    gx_d = gradient_x(src_f)
    gy_d = gradient_y(src_f)
    me = me[None, :, :] if me.dim() == 2 else me
    gxm = gx_d * me
    gym = gy_d * me
    if kind == COLOR_CHANGE:
        fac = params[:, None, None]
        gxm, gym = gxm * fac, gym * fac
    elif kind == ILLUMINATION_CHANGE:
        alpha, beta = params[0], params[1]
        mag = torch.sqrt(gxm * gxm + gym * gym)
        # alpha^beta * |g|^-beta; zero gradients stay zero (cv2's patchNaNs)
        scale = torch.where(mag > 0.0, (alpha**beta) * mag ** (-beta), 0.0)
        gxm, gym = gxm * scale, gym * scale
    elif kind == TEXTURE_FLATTENING:
        e = edge_mask[None, :, :]
        gxm, gym = gxm * e, gym * e
    else:
        raise ValueError(f"unknown edit kind={kind!r}")
    gx = gx_d * (1.0 - me) + gxm
    gy = gy_d * (1.0 - me) + gym
    return gx, gy


def local_edit_planar(
    src_p: torch.Tensor,
    mask_eroded: torch.Tensor,
    params: torch.Tensor,
    edge_mask: torch.Tensor | None = None,
    *,
    kind: str,
    crossover: int | None = None,
) -> torch.Tensor:
    """Gradient-domain edit of a planar (C, H, W) u8 image, full-image solve.

    mask_eroded: (H, W) f32 {0, 1}, the 3x-eroded (replicate-border) edit
    mask; params and edge_mask as ``edit_guidance`` takes them, on
    ``src_p``'s device. The solver follows the size rule of JAX's
    ``solve_auto`` (``auto_solver_name`` on the (C, H-2, W-2) RHS against
    ``crossover``, default ``AUTO_CROSSOVER_PIXELS``): below it the exact
    ``solve_dst_gemm(precision="highest", folded=False)``, above it the
    quarter-plane multigrid to tol 1e-5 on the dense RHS
    (``solve_multigrid(padded="q", use_pallas=True)``: ``to_quarters``,
    the ``"q"`` chain's kernels, ``from_quarters`` on the card, their twins
    on the CPU). Then ``clamp_cast_paste`` of the interior into a copy of
    ``src_p``: the image border stays the source's. Returns the edited
    planar u8 image.
    """
    from seamlesscloneoptimization_tpu_torch.solvers import (
        AUTO_CROSSOVER_PIXELS,
        auto_solver_name,
        solve_dst_gemm,
        solve_multigrid,
    )

    src_f = src_p.to(torch.float32)
    gx, gy = edit_guidance(src_f, mask_eroded, params, edge_mask, kind=kind)
    g = poisson_rhs(gx, gy, src_f)
    _, h2, w2 = g.shape
    crossover = AUTO_CROSSOVER_PIXELS if crossover is None else crossover
    if auto_solver_name(g.shape, crossover) == "multigrid":
        u = solve_multigrid(g, tol=1e-5, padded="q", use_pallas=True)
    else:
        u = solve_dst_gemm(g, precision="highest", folded=False)
    return clamp_cast_paste(u.contiguous(), src_p.clone(), 1, 1, h2, w2)
