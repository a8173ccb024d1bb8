"""Layout conversion: interleaved HWC uint8 <-> planar CHW.

Port of ``seamlesscloneoptimization_tpu/ops/layout.py``. All internal
compute is planar, channels leading, so the per-channel Poisson solves
batch as one GEMM.
"""

from __future__ import annotations

import torch


def interleaved_to_planar(img: torch.Tensor) -> torch.Tensor:
    """(H, W, C) uint8 -> (C, H, W) float32."""
    return img.permute(2, 0, 1).to(torch.float32)


def planar_to_interleaved(img: torch.Tensor) -> torch.Tensor:
    """(C, H, W) -> (H, W, C) view, dtype preserved."""
    return img.permute(1, 2, 0)
