"""Poisson right-hand side: divergence of the guidance field + Dirichlet terms.

Port of ``seamlesscloneoptimization_tpu/ops/rhs.py`` (ref
``pre_process_kernel_lapXY``, seamlessClone_imp.cpp:1966-2018).
"""

from __future__ import annotations

import torch


def poisson_rhs(gx: torch.Tensor, gy: torch.Tensor, dest_roi: torch.Tensor,
                folds=(True, True, True, True)) -> torch.Tensor:
    """RHS g on the interior grid.

    gx, gy, dest_roi: (..., C, H, W) float32. Returns (..., C, H-2, W-2)
    float32. ``folds`` = (top, bottom, left, right): the sides whose
    Dirichlet values fold into g, all four for a whole ROI; a tile's window
    (``parallel/stages.py``) folds only where it meets the ROI's frame.
    """
    g = ((gx[..., 1:-1, 1:-1] - gx[..., 1:-1, 0:-2])
         + (gy[..., 1:-1, 1:-1] - gy[..., 0:-2, 1:-1]))
    d = dest_roi
    top, bottom, left, right = folds
    if top:
        g[..., 0, :] += -d[..., 0, 1:-1]
    if bottom:
        g[..., -1, :] += -d[..., -1, 1:-1]
    if left:
        g[..., :, 0] += -d[..., 1:-1, 0]
    if right:
        g[..., :, -1] += -d[..., 1:-1, -1]
    return g
