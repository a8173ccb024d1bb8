"""Post-processing: clamp, truncate-cast, insert the solved interior.

Port of ``seamlesscloneoptimization_tpu/ops/postprocess.py`` (ref fused
``post_processing``, seamlessClone_imp.cpp:2078-2103). Clamp to [0, 255],
then truncate — never round — as OpenCV's ``Cloning::solve`` does.
"""

from __future__ import annotations

import torch


def clamp_truncate_u8(u: torch.Tensor) -> torch.Tensor:
    """f32 -> u8: clamp to [0, 255], then truncate toward zero."""
    return torch.clamp(u, 0.0, 255.0).to(torch.int32).to(torch.uint8)


def postprocess_roi(u: torch.Tensor, dest_roi_u8: torch.Tensor) -> torch.Tensor:
    """u: (C, H-2, W-2) f32 solution, dest_roi_u8: (C, H, W) u8 -> blended ROI."""
    out = dest_roi_u8.clone()
    out[:, 1:-1, 1:-1] = clamp_truncate_u8(u)
    return out
