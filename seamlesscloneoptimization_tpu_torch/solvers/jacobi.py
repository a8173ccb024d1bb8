"""Red-black Gauss-Seidel relaxation for the 5-point Dirichlet Laplacian.

Port of the sweep and residual of ``seamlesscloneoptimization_tpu/solvers/
jacobi.py`` (the multigrid smoother, plain PyTorch). System: A u = g with
A u = sum of the 4 neighbours - 4u and a zero Dirichlet frame. A half-sweep
updates one colour, ``u <- (N4(u) - g) / 4``, in the select form (``where``
on a boolean checkerboard), so the written value is exactly the update.
The solver ``solve_redblack`` comes with ROADMAP slice 4.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _neighbor_sum(u: torch.Tensor) -> torch.Tensor:
    """Sum of the 4 neighbours with an implicit zero frame. u: (C, H, W)."""
    up = F.pad(u, (1, 1, 1, 1))
    return up[:, :-2, 1:-1] + up[:, 2:, 1:-1] + up[:, 1:-1, :-2] + up[:, 1:-1, 2:]


def checkerboard(h: int, w: int, device) -> torch.Tensor:
    """(h, w) bool, True where (row + col) is even (the red cells)."""
    r = torch.arange(h, device=device)[:, None]
    c = torch.arange(w, device=device)[None, :]
    return (r + c) % 2 == 0


def redblack_sweep(u: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """One red-black Gauss-Seidel sweep (red half, then black half)."""
    _, h, w = u.shape
    red = checkerboard(h, w, u.device)[None]
    u = torch.where(red, (_neighbor_sum(u) - g) * 0.25, u)
    return torch.where(~red, (_neighbor_sum(u) - g) * 0.25, u)


def residual(u: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """r = g - A u."""
    return g - (_neighbor_sum(u) - 4.0 * u)
