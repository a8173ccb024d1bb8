"""Guidance gradient field for Poisson image editing (planar CHW f32).

Port of ``seamlesscloneoptimization_tpu/ops/guidance.py`` (ref
``pre_process_kernel_gradient``, seamlessClone_imp.cpp:1920-1964; MIXED and
MONOCHROME follow OpenCV 3.4.5). The serve path computes this inside the
``preprocess_rhs_t`` kernel; these are the plain stages it is held against.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

NORMAL_CLONE = 1
MIXED_CLONE = 2
MONOCHROME_TRANSFER = 3


def gradient_x(img: torch.Tensor) -> torch.Tensor:
    """Forward difference along the last axis; last column zero."""
    return F.pad(img[..., :, 1:] - img[..., :, :-1], (0, 1))


def gradient_y(img: torch.Tensor) -> torch.Tensor:
    """Forward difference along the second-to-last axis; last row zero."""
    return F.pad(img[..., 1:, :] - img[..., :-1, :], (0, 0, 0, 1))


def bgr_to_gray_u8(img_chw: torch.Tensor) -> torch.Tensor:
    """OpenCV BGR2GRAY with shift-15 fixed-point rounding, (..., 3, H, W)
    -> (..., H, W) f32.

    gray = (B*3735 + G*19235 + R*9798 + 2^14) >> 15 on u8 (or integral f32)
    inputs: integer values in [0, 255].
    """
    b = img_chw[..., 0, :, :].to(torch.int32)
    g = img_chw[..., 1, :, :].to(torch.int32)
    r = img_chw[..., 2, :, :].to(torch.int32)
    gray = (b * 3735 + g * 19235 + r * 9798 + (1 << 14)) >> 15
    return gray.to(torch.float32)


def guidance_field(
    dest_roi: torch.Tensor,
    patch: torch.Tensor,
    mask_eroded: torch.Tensor,
    flags: int = NORMAL_CLONE,
    mixed_rule: str = "opencv",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Blended guidance gradients (gx, gy), each (..., C, H, W) f32.

    dest_roi, patch: (..., C, H, W) float32. mask_eroded: (..., H, W)
    uint8 {0,255} (a batch group's leading job dimension goes with each).
    mixed_rule: "opencv" (take dest where |gx_p-gy_p| <= |gx_d-gy_d|) or
    "norm" (take dest where |grad_p|^2 < |grad_d|^2).
    """
    m = (mask_eroded.to(torch.float32) / 255.0).unsqueeze(-3)
    gx_d, gy_d = gradient_x(dest_roi), gradient_y(dest_roi)
    if flags == NORMAL_CLONE:
        gx_p, gy_p = gradient_x(patch), gradient_y(patch)
    elif flags == MIXED_CLONE:
        gx_p, gy_p = gradient_x(patch), gradient_y(patch)
        if mixed_rule == "norm":
            take_d = (gx_p * gx_p + gy_p * gy_p) < (gx_d * gx_d + gy_d * gy_d)
        else:
            take_d = torch.abs(gx_p - gy_p) <= torch.abs(gx_d - gy_d)
        gx_p = torch.where(take_d, gx_d, gx_p)
        gy_p = torch.where(take_d, gy_d, gy_p)
    elif flags == MONOCHROME_TRANSFER:
        gray = bgr_to_gray_u8(patch)
        gx_p = gradient_x(gray).unsqueeze(-3).expand(patch.shape)
        gy_p = gradient_y(gray).unsqueeze(-3).expand(patch.shape)
    else:
        raise ValueError(f"unknown clone flags={flags}")
    gx = (1.0 - m) * gx_d + m * gx_p
    gy = (1.0 - m) * gy_d + m * gy_p
    return gx, gy
