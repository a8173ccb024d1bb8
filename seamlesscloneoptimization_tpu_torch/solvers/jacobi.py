"""Red-black Gauss-Seidel relaxation for the 5-point Dirichlet Laplacian.

Port of ``seamlesscloneoptimization_tpu/solvers/jacobi.py``: the sweep and
residual (also the multigrid smoother) and the solver ``solve_redblack``.
System: A u = g with A u = sum of the 4 neighbours - 4u and a zero
Dirichlet frame. A half-sweep updates one colour, ``u <- (N4(u) - g) / 4``,
in the select form (``where`` on a boolean checkerboard), so the written
value is exactly the update. On the card a burst of sweeps is the
``rb_sweeps`` kernel (``ops/kernels.py``), bit-equal to the plain sweeps.

``COUNTS`` is the solvers' counter, in the style of ``ops.kernels.LAUNCHES``
(``solvers.multigrid.COUNTS`` is the same dict): ``"checks"``, every host
read of a residual (``exceeds``, ``read_residual``: the host waits for the
card), each in a ``solver.check`` span; ``"cycles"``, the multigrid
V-cycles (``solvers/multigrid.py``, ``solvers/multigrid_dyn.py``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from seamlesscloneoptimization_tpu_torch.core.trace import span
from seamlesscloneoptimization_tpu_torch.ops import kernels as K

COUNTS = {"cycles": 0, "checks": 0}


def exceeds(rmax: torch.Tensor, thresh) -> bool:
    """One tolerance check: max |r| > thresh, read on the host."""
    COUNTS["checks"] += 1
    with span("solver.check"):
        return bool(rmax > thresh)


def read_residual(rmax: torch.Tensor) -> float:
    """``return_info``'s max |r|, read on the host (a check too)."""
    COUNTS["checks"] += 1
    with span("solver.check"):
        return rmax.item()


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


def solve_redblack(g: torch.Tensor, u0: torch.Tensor | None = None, tol: float = 1e-3,
                   max_iters: int = 10000, check_every: int = 50, return_info: bool = False,
                   use_pallas: bool = False):
    """Red-black sweeps until max |r| <= tol * max |g| (or ``max_iters``).

    g: (C, H, W) f32; ``u0`` a warm start (zeros by default). Before each
    burst of ``check_every`` sweeps the loop checks the residual (one host
    read) and that fewer than ``max_iters`` sweeps ran, as the JAX
    package's while loop does, so the sweeps run come in whole bursts.
    ``use_pallas`` runs each burst as ``K.rb_sweeps`` (the kernel on a CUDA
    tensor, ceil(check_every / 4) launches), else as plain sweeps.
    ``return_info`` adds {"iterations": sweeps run, "residual": max |g - A u|}.
    """
    if check_every < 1:
        raise ValueError(f"check_every must be >= 1, got {check_every}")
    g = g.contiguous()
    if u0 is not None and tuple(u0.shape) != tuple(g.shape):
        raise ValueError(f"u0 {tuple(u0.shape)} does not match g {tuple(g.shape)}")
    u = torch.zeros_like(g) if u0 is None else u0.to(g.dtype).contiguous()
    thresh = tol * torch.clamp(g.abs().max(), min=1e-30)
    it = 0
    while it < max_iters and exceeds(residual(u, g).abs().max(), thresh):  # one host read
        if use_pallas:
            u = K.rb_sweeps(u, g, check_every)
        else:
            for _ in range(check_every):
                u = redblack_sweep(u, g)
        it += check_every
    if return_info:
        return u, {"iterations": it, "residual": read_residual(residual(u, g).abs().max())}
    return u
