"""Mask pipeline: binarize, 3x3 erosion with a zero border (plain torch).

Port of ``seamlesscloneoptimization_tpu/ops/mask.py`` (ref
``setMaskBoundaryToConstant`` and ``myErode`` x3, seamlessClone_imp.cpp:
892-976). The serve path erodes with the ``erode3`` kernel
(``ops/kernels.py``); these are the plain stages it is held against.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def binarize_mask(mask: torch.Tensor) -> torch.Tensor:
    """uint8 mask -> {0,255} uint8 (nonzero -> 255)."""
    return torch.where(mask != 0, 255, 0).to(torch.uint8)


def roi_mask(mask: torch.Tensor, bbox_xy, bbox_hw) -> torch.Tensor:
    """The (bh, bw) ROI at bbox_xy = (x0, y0) of an (hs, ws) uint8 mask,
    binarized, and zero on the rows and columns where the ROI meets the
    mask's frame (ref ``setMaskBoundaryToConstant``, in global
    coordinates)."""
    (x0, y0), (bh, bw) = bbox_xy, bbox_hw
    hs, ws = mask.shape
    out = binarize_mask(mask[y0 : y0 + bh, x0 : x0 + bw])
    if y0 == 0:
        out[0, :] = 0
    if y0 + bh == hs:
        out[-1, :] = 0
    if x0 == 0:
        out[:, 0] = 0
    if x0 + bw == ws:
        out[:, -1] = 0
    return out


def erode3x3(mask: torch.Tensor, iterations: int = 3) -> torch.Tensor:
    """Binary 3x3 erosion with a ZERO border, ``iterations`` times.

    mask: (..., H, W) uint8: one mask, or a stack of them (a batch
    group's, eroded as one set of ops); only the last two dimensions are
    padded. The zero border erodes the mask inward from the bbox edge,
    matching the reference ``myErode`` (border forced 0).
    """
    m = mask
    h, w = m.shape[-2:]
    for _ in range(iterations):
        p = F.pad(m, (1, 1, 1, 1))
        out = p[..., 0:h, 0:w]
        for dy in range(3):
            for dx in range(3):
                out = torch.minimum(out, p[..., dy:dy + h, dx:dx + w])
        m = out
    return m
