"""Functional API mirroring OpenCV's signature.

Port of ``seamlesscloneoptimization_tpu/api.py``: ``seamless_clone(src, dst,
mask, center, flags)`` is a drop-in for ``cv2.seamlessClone`` (returns u8
HWC). A small LRU of engines keeps the device-resident DST bases across
calls (ref lazy instance creation, SeamlessClone.cpp:108-118). Each engine
has the default ``CloneConfig`` (``dst_folded=True``), so a patch whose
interior exceeds 128 px on both sides runs the folded pair chain, and one
above the 7 MP crossover the quarter-plane multigrid (``mg_padded="q"``);
``solver=`` picks any of dst_gemm | dst_fft | jacobi | multigrid instead.
The solvers ``solve_redblack`` and ``solve_dst_fft`` are exported here too.
The batch and edit functions come with later ROADMAP slices.
"""

from __future__ import annotations

from seamlesscloneoptimization_tpu_torch import resolve_device
from seamlesscloneoptimization_tpu_torch.core.config import (
    MIXED_CLONE,
    MONOCHROME_TRANSFER,
    NORMAL_CLONE,
    CloneConfig,
)
from seamlesscloneoptimization_tpu_torch.core.engine import BoundedCache, SeamlessClone
from seamlesscloneoptimization_tpu_torch.solvers import solve_dst_fft, solve_redblack

_engines: dict = BoundedCache(maxsize=16)


def _engine(solver: str, tol: float, device) -> SeamlessClone:
    dev = resolve_device(device)
    key = (solver, tol, str(dev))
    eng = _engines.get(key)
    if eng is None:
        eng = SeamlessClone(CloneConfig(solver=solver, tol=tol), device=dev)
        _engines[key] = eng
    return eng


def seamless_clone(
    src,
    dst,
    mask,
    center: tuple[int, int],
    flags: int = NORMAL_CLONE,
    *,
    solver: str = "auto",  # auto | dst_gemm | dst_fft | jacobi | multigrid
    tol: float = 1e-4,
    to_numpy: bool = True,
    device=None,
):
    """Seamlessly clone ``src`` (under ``mask``) into ``dst`` centred at ``center``.

    Arguments mirror cv2.seamlessClone; ``solver`` selects the Poisson
    solver and ``device`` where it runs (default ``cuda``; ``"cpu"`` runs
    the plain PyTorch twins). Returns u8 HWC: numpy if ``to_numpy``, else
    the device tensor.
    """
    out = _engine(solver, tol, device).run(src, dst, mask, center, flags)
    return out.cpu().numpy() if to_numpy else out


__all__ = [
    "seamless_clone",
    "solve_dst_fft",
    "solve_redblack",
    "NORMAL_CLONE",
    "MIXED_CLONE",
    "MONOCHROME_TRANSFER",
]
