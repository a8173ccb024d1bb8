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

The batch: ``seamless_clone_batch`` runs N jobs in order through one
engine, the destination staying on the device between them;
``seamless_clone_batch_fused`` solves each group of same-shape jobs in one
batched step (``parallel/batch.py``). The edits: ``color_change``,
``illumination_change`` and ``texture_flattening``, drop-ins for cv2's
photo functions (``ops/edit.py``; the Canny map of ``texture_flattening``
from ``ops/canny.py``, equal to ``cv2.Canny``).
"""

from __future__ import annotations

import numpy as np
import torch

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


def seamless_clone_batch(
    srcs,
    dst,
    masks,
    centers,
    flags: int = NORMAL_CLONE,
    *,
    solver: str = "auto",
    tol: float = 1e-4,
    device=None,
):
    """Composite N (src, mask, center) jobs into one destination in order.

    Non-overlapping ROIs compose exactly; overlapping ROIs apply in order.
    The destination is uploaded once and each job's output, a device
    tensor, is the next job's destination. Returns u8 HWC numpy. (The
    batched solve of same-shape jobs is ``seamless_clone_batch_fused``.)
    """
    eng = _engine(solver, tol, device)
    out = dst
    for src, mask, center in zip(srcs, masks, centers):
        out = eng.run(src, out, mask, center, flags)
    return out.cpu().numpy() if isinstance(out, torch.Tensor) else np.array(out)


def seamless_clone_batch_fused(dst, srcs, masks, centers, flags: int = NORMAL_CLONE, *,
                               device=None):
    """Fused batch: N jobs grouped by shape, each group solved as ONE
    batched step; see ``parallel/batch.py:seamless_clone_batch_fused``."""
    from seamlesscloneoptimization_tpu_torch.parallel.batch import (
        seamless_clone_batch_fused as _fused,
    )

    return _fused(dst, srcs, masks, centers, flags, device=device)


def _local_edit(src, mask, kind, params, edge_mask=None, to_numpy=True, device=None):
    """The edit of a (H, W, C) u8 image on ``device``: the replicate-border
    erosion of the mask, ``local_edit_planar`` on the planar image. Returns
    u8 HWC, numpy if ``to_numpy`` else the device tensor."""
    from seamlesscloneoptimization_tpu_torch.ops.edit import edit_inputs, local_edit_planar

    src_p, me, params_t, edge = edit_inputs(src, mask, params, edge_mask,
                                            resolve_device(device))
    out = local_edit_planar(src_p, me, params_t, edge, kind=kind).permute(1, 2, 0)
    return out.cpu().numpy() if to_numpy else out.contiguous()


def color_change(src, mask=None, red_mul: float = 1.0, green_mul: float = 1.0,
                 blue_mul: float = 1.0, *, to_numpy: bool = True, device=None):
    """Drop-in for ``cv2.colorChange(src, mask, red_mul, green_mul, blue_mul)``:
    multiplies the gradient field inside ``mask`` per channel and re-solves."""
    from seamlesscloneoptimization_tpu_torch.ops.edit import COLOR_CHANGE

    return _local_edit(src, mask, COLOR_CHANGE, [blue_mul, green_mul, red_mul],
                       to_numpy=to_numpy, device=device)


def illumination_change(src, mask=None, alpha: float = 0.2, beta: float = 0.4,
                        *, to_numpy: bool = True, device=None):
    """Drop-in for ``cv2.illuminationChange``: scales gradients inside
    ``mask`` by ``alpha^beta * |g|^-beta`` (Perez et al. section 4, local
    illumination changes) and re-solves."""
    from seamlesscloneoptimization_tpu_torch.ops.edit import ILLUMINATION_CHANGE

    return _local_edit(src, mask, ILLUMINATION_CHANGE, [alpha, beta], to_numpy=to_numpy,
                       device=device)


def texture_flattening(src, mask=None, low_threshold: float = 30.0,
                       high_threshold: float = 45.0, kernel_size: int = 3,
                       *, to_numpy: bool = True, device=None):
    """Drop-in for ``cv2.textureFlattening``: keeps only the gradients at
    Canny edges inside ``mask`` (washes out texture, keeps structure). The
    edge map of the masked source is host-side input prep
    (``ops/canny.py``, equal to ``cv2.Canny``)."""
    from seamlesscloneoptimization_tpu_torch.ops.canny import canny
    from seamlesscloneoptimization_tpu_torch.ops.edit import TEXTURE_FLATTENING

    src = np.asarray(src)
    m = (np.full(src.shape[:2], 255, np.uint8) if mask is None else np.asarray(mask))
    masked = np.where(m[..., None] != 0, src, 0).astype(np.uint8)
    edges = canny(masked, low_threshold, high_threshold, kernel_size)
    return _local_edit(src, m, TEXTURE_FLATTENING, [0.0], edge_mask=edges, to_numpy=to_numpy,
                       device=device)


__all__ = [
    "seamless_clone",
    "seamless_clone_batch",
    "seamless_clone_batch_fused",
    "color_change",
    "illumination_change",
    "texture_flattening",
    "solve_dst_fft",
    "solve_redblack",
    "NORMAL_CLONE",
    "MIXED_CLONE",
    "MONOCHROME_TRANSFER",
]
