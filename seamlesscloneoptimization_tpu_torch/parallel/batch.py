"""Batched clone: N (patch, mask, center) jobs into one destination a step.

Port of ``seamlesscloneoptimization_tpu/parallel/batch.py`` (BASELINE's "64
masks/patches composited into one 4K destination per step"). The jobs'
ROIs are bucketed to a common shape and all N Poisson problems solve in ONE
solver call: the (N, C, h2, w2) right-hand sides stacked as (N*C, h2, w2),
so the DST GEMMs run batched over N*C channels, as the JAX package's
channel batch grows under ``vmap``. One ``clamp_cast_paste`` launch then
writes every job's interior into the gathered (N*C, bh, bw) stack.

Semantics, the JAX package's: every job's ROI is gathered from the
destination BEFORE any job is pasted, and each blended (bh, bw) window,
its ring included, is then written whole, in job order. Jobs whose windows
overlap therefore composite in order (the later window wins where both
wrote); jobs that do not overlap match N independent ``seamless_clone``
calls.

The preprocess runs as one set of torch ops over the group with a leading
job dimension, or (``use_pallas=True``) through the ``erode3`` and
``preprocess_rhs_p`` kernels once per job: the kernels take one (C, H, W)
job, and the jobs' masks differ. On CPU tensors the kernels' twins run.
"""

from __future__ import annotations

from functools import partial
from typing import Callable

import numpy as np
import torch

from seamlesscloneoptimization_tpu_torch import native, resolve_device
from seamlesscloneoptimization_tpu_torch.models.pipeline import (
    _kernel_rhs_inputs,
    _plain_rhs,
    clone_roi_dyn,
)
from seamlesscloneoptimization_tpu_torch.ops.kernels import clamp_cast_paste, preprocess_rhs_p
from seamlesscloneoptimization_tpu_torch.parallel.mesh import TileMesh
from seamlesscloneoptimization_tpu_torch.parallel.transport import all_cells, map_local

_FAST_SOLVERS: dict = {}


def fast_dst_solver(precision: str = "high", folded: bool = True):
    """Memoized ``solve_dst_gemm`` partial carrying the fast configuration
    (the engine's defaults: ``"high"``, which the port runs as FP32 GEMMs,
    and even/odd folding). One long-lived object per configuration, as in
    the JAX package, where the batch programs key their compiles on it."""
    key = (precision, folded)
    fn = _FAST_SOLVERS.get(key)
    if fn is None:
        from seamlesscloneoptimization_tpu_torch.solvers import solve_dst_gemm

        fn = partial(solve_dst_gemm, precision=precision, folded=folded)
        _FAST_SOLVERS[key] = fn
    return fn


def clone_roi_batch(
    dest_rois: torch.Tensor,
    patches: torch.Tensor,
    mask_rois: torch.Tensor,
    flags: int,
    solver: Callable[..., torch.Tensor],
    use_pallas: bool = False,
    mesh: TileMesh | None = None,
):
    """Clone over (N, C, bh, bw) u8 ROI stacks; returns (N, C, bh, bw) u8.

    ``patches`` must already be zeroed outside the (pre-erosion) masks,
    ``mask_rois`` is (N, bh, bw) u8. Each job's result equals JAX's
    ``clone_roi`` under ``vmap``: the ROI with its interior replaced by the
    clamped, truncated solution. The RHS: with ``use_pallas`` the
    ``erode3`` and ``preprocess_rhs_p`` kernels once per job, else the
    plain stages once over the group. The solve: ONE ``solver`` call on the
    stacked (N*C, bh-2, bw-2) RHS. The paste: ONE ``clamp_cast_paste``
    launch into a copy of the ROI stack.

    ``mesh``: the jobs split over a ``TileMesh``, the port's counterpart of
    JAX's job-axis sharding ``P(('ty', 'tx'))``: contiguous blocks of N /
    size jobs, row-major over the mesh's cells, each block the call above
    on its cell's device; the stack comes back on ``dest_rois``' device (on
    every rank of a mesh that spans processes: an all-gather of the
    blocks). N not divisible by the mesh's size raises ValueError, as
    JAX's ``device_put`` does.
    """
    if mesh is not None:
        return _batch_over_mesh(dest_rois, patches, mask_rois, flags, solver, use_pallas,
                                mesh)
    n, c, bh, bw = dest_rois.shape
    h2, w2 = bh - 2, bw - 2
    if use_pallas:
        parts = []
        for i in range(n):
            me, patch_in, kflags = _kernel_rhs_inputs(patches[i], mask_rois[i].contiguous(),
                                                      flags)
            parts.append(preprocess_rhs_p(dest_rois[i], patch_in, me, (h2, w2), kflags))
        g = torch.stack(parts)
    else:
        g = _plain_rhs(dest_rois, patches, mask_rois, flags, "opencv")[0]
    u = solver(g.reshape(n * c, h2, w2))
    out = dest_rois.clone(memory_format=torch.contiguous_format)
    clamp_cast_paste(u.contiguous(), out.view(n * c, bh, bw), 1, 1, h2, w2)
    return out


def _batch_over_mesh(dest_rois, patches, mask_rois, flags, solver, use_pallas,
                     mesh: TileMesh) -> torch.Tensor:
    n = dest_rois.shape[0]
    ty, tx = mesh.shape
    if n % mesh.size:
        raise ValueError(f"{n} jobs do not split over the mesh's {mesh.size} cells")
    per = n // mesh.size

    def block(iy, ix, _):
        jobs = slice((iy * tx + ix) * per, (iy * tx + ix + 1) * per)
        dev = mesh.devices[iy][ix]
        return clone_roi_batch(dest_rois[jobs].to(dev), patches[jobs].to(dev),
                               mask_rois[jobs].to(dev), flags, solver, use_pallas)

    blocks = map_local(mesh, block, [[None] * tx for _ in range(ty)])
    shape = (per,) + tuple(dest_rois.shape[1:])
    grid = all_cells(blocks, dest_rois.device, mesh, lambda iy, ix: shape)
    return torch.cat([t for row in grid for t in row])


def _lefttops(left_tops) -> list[tuple[int, int]]:
    return [(int(a), int(b)) for a, b in np.asarray(
        left_tops.cpu() if isinstance(left_tops, torch.Tensor) else left_tops).reshape(-1, 2)]


def _gather(dst_p: torch.Tensor, lts, bh: int, bw: int) -> torch.Tensor:
    """The (N, C, bh, bw) windows of ``dst_p`` at (left, top) each."""
    return torch.stack([dst_p[:, t : t + bh, lf : lf + bw] for lf, t in lts])


def _composite(dst_p: torch.Tensor, blended: torch.Tensor, lts) -> torch.Tensor:
    """A copy of ``dst_p`` with each whole blended window written in job order."""
    out = dst_p.clone()
    _, bh, bw = blended.shape[1:]
    for i, (lf, t) in enumerate(lts):
        out[:, t : t + bh, lf : lf + bw] = blended[i]
    return out


def _masked_planar(srcs: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
    """(N, bh, bw, C) patches -> planar (N, C, bh, bw), zero outside the masks."""
    return torch.where(masks[:, None] != 0, srcs.permute(0, 3, 1, 2), 0).to(torch.uint8)


def clone_batch_composite_p(
    dst_p: torch.Tensor,
    srcs: torch.Tensor,
    masks: torch.Tensor,
    left_tops,
    flags: int,
    solver: Callable[..., torch.Tensor],
    roi_hw: tuple[int, int],
    use_pallas: bool = False,
):
    """PLANAR batch step: N patches into one (C, H, W) u8 destination (any
    strides). srcs: (N, bh, bw, C) u8, masks: (N, bh, bw) u8, left_tops:
    (N, 2) (left, top) ints. Every job's window is gathered from ``dst_p``
    first; the blended windows are then written whole in job order into a
    copy of ``dst_p``, which is returned (with ``dst_p``'s strides)."""
    bh, bw = roi_hw
    lts = _lefttops(left_tops)
    d_p = _gather(dst_p, lts, bh, bw)
    blended = clone_roi_batch(d_p, _masked_planar(srcs, masks), masks, flags, solver,
                              use_pallas)
    return _composite(dst_p, blended, lts)


def clone_batch_composite(
    dst: torch.Tensor,
    srcs: torch.Tensor,
    masks: torch.Tensor,
    left_tops,
    flags: int,
    solver: Callable[..., torch.Tensor],
    roi_hw: tuple[int, int],
    use_pallas: bool = False,
):
    """The batch step on an interleaved (H, W, C) u8 destination; returns
    (H, W, C) u8. The planar core runs on the destination's (C, H, W)
    view, so nothing is transposed."""
    out_p = clone_batch_composite_p(dst.permute(2, 0, 1), srcs, masks, left_tops, flags,
                                    solver, roi_hw, use_pallas)
    return out_p.permute(1, 2, 0)


def clone_batch_composite_dyn(
    dst_p: torch.Tensor,
    srcs: torch.Tensor,
    masks: torch.Tensor,
    left_tops,
    tights,
    flags: int,
    roi_hw: tuple[int, int],
    tol: float = 1e-4,
    cycles: int | None = None,
):
    """Mixed-size batch step: every job padded into one (bh, bw) bucket, each
    solving its TIGHT Poisson system (``bucket="pad_exact"``).

    The JAX package vmaps ``clone_roi_dyn`` over traced sizes; the port
    runs ``models/pipeline.py:clone_roi_dyn`` job by job on the gathered
    windows (``erode3``, ``preprocess_rhs_p`` on the tight window, the
    runtime-domain multigrid to ``tol`` or for ``cycles``, ``clamp_cast_
    paste``), then writes the windows in job order as
    ``clone_batch_composite_p`` does. tights: (N, 4) [dy, dx, th, tw], each
    job's tight bbox inside its window. Returns (C, H, W) u8.
    """
    bh, bw = roi_hw
    lts = _lefttops(left_tops)
    tl = np.asarray(tights.cpu() if isinstance(tights, torch.Tensor) else tights).reshape(-1, 4)
    d_p = _gather(dst_p, lts, bh, bw)  # a fresh stack: each job pastes into its window
    s_p = _masked_planar(srcs, masks)
    for i in range(len(lts)):
        clone_roi_dyn(d_p[i], s_p[i], masks[i], flags, tuple(int(v) for v in tl[i]), tol=tol,
                      cycles=cycles, out=d_p[i], out_offset=(1, 1))
    return _composite(dst_p, d_p, lts)


def seamless_clone_batch_fused(
    dst,
    srcs,
    masks,
    centers,
    flags: int = 1,
    solver=None,
    bucket: str = "exact",
    precision: str = "high",
    folded: bool = True,
    use_pallas: bool = False,
    tol: float = 1e-4,
    mg_cycles: int | None = None,
    device=None,
):
    """Host-facing batch: N (src, mask, center) jobs into one destination.

    Jobs are grouped on the host by their bbox shape (``bucket="exact"``)
    and each group runs as one batch step (``clone_batch_composite``), its
    N*C channels in one batched DST-GEMM solve, so same-shape jobs match N
    independent ``seamless_clone`` calls. ``bucket="pad"`` pads every job
    to one max-shape bucket: the pad band has mask 0 and keeps the
    destination, but the Dirichlet frame moves to the bucket's edge, so
    the result differs from per-call ones (an equally seamless membrane).
    ``bucket="pad_exact"`` keeps the one bucket and solves each job's
    TIGHT system inside it with the runtime-domain multigrid
    (``clone_batch_composite_dyn``, ``tol`` / ``mg_cycles``); an explicit
    ``solver`` cannot apply there and raises.

    Args:
      dst: (H, W, C) uint8 destination.
      srcs: sequence of (hi, wi, C) uint8 patches.
      masks: sequence of (hi, wi) uint8 masks (None = full 255).
      centers: sequence of (cx, cy) paste centers.
      precision / folded: the DST-GEMM knobs of ``fast_dst_solver`` (the
        port runs ``"high"`` as FP32); ignored with an explicit ``solver``.
      use_pallas: the ``erode3`` + ``preprocess_rhs_p`` kernels per job
        instead of the group's plain stages.
      device: where it runs, ``cuda`` by default (``resolve_device``); the
        destination stays there from group to group.
    Returns (H, W, C) uint8 numpy, overlapping jobs composited in group
    order, and in job order within a group.
    """
    if bucket == "pad_exact" and solver is not None:
        raise ValueError(
            "bucket='pad_exact' always solves each job's tight system with "
            "the runtime-domain multigrid (clone_batch_composite_dyn); an "
            "explicit solver cannot apply — pass bucket='exact'/'pad' with "
            "your solver, or drop the solver argument")
    if solver is None:
        solver = fast_dst_solver(precision, folded)
    dev = resolve_device(device)
    dst = np.asarray(dst)
    groups = plan_groups(dst.shape, srcs, masks, centers, bucket, device=dev)
    if not groups:
        return dst.copy()
    out = composite_groups(torch.from_numpy(dst).to(dev, copy=True), groups, flags, solver,
                           bucket, use_pallas, tol, mg_cycles)
    return out.cpu().numpy()


def composite_groups(dst, groups, flags: int, solver, bucket: str, use_pallas: bool = False,
                     tol: float = 1e-4, mg_cycles: int | None = None) -> torch.Tensor:
    """The device part of ``seamless_clone_batch_fused``: each group of
    ``plan_groups`` (with its ``device``) composited in turn into the
    (H, W, C) u8 destination, the next group gathering from the last one's
    result. Returns the new destination."""
    for (bh, bw), srcs_d, masks_d, lts, tights in groups:
        if bucket == "pad_exact":
            dst = clone_batch_composite_dyn(dst.permute(2, 0, 1), srcs_d, masks_d, lts, tights,
                                            flags, (bh, bw), tol, mg_cycles).permute(1, 2, 0)
        else:
            dst = clone_batch_composite(dst, srcs_d, masks_d, lts, flags, solver, (bh, bw),
                                        use_pallas)
    return dst


def plan_groups(dst_shape, srcs, masks, centers, bucket: str = "exact", device=None) -> list:
    """The host prep of ``seamless_clone_batch_fused``: each job's mask
    binarized and border-zeroed, its bbox, and the jobs grouped by bbox
    shape (``"exact"``) or into one max-shape bucket (``"pad"``,
    ``"pad_exact"``). Returns, group by group in composite order, ((bh, bw),
    srcs (N, bh, bw, C) u8 zero outside the masks, masks (N, bh, bw) u8,
    left_tops (N, 2), tights (N, 4) [dy, dx, th, tw]); srcs and masks as
    tensors on ``device`` when one is given, else all numpy. An empty list
    when no job has a mask pixel. Raises the JAX package's ValueErrors."""
    H, W, C = dst_shape
    n = len(srcs)
    if len(masks) != n or len(centers) != n:
        raise ValueError(f"{n} srcs, {len(masks)} masks and {len(centers)} centers")

    jobs = []
    for src, mask, (cx, cy) in zip(srcs, masks, centers):
        src = np.asarray(src)
        mask = (np.full(src.shape[:2], 255, np.uint8) if mask is None else np.asarray(mask))
        if mask.ndim == 3:
            mask = mask[..., 0]
        m, (x0, y0, bw, bh) = native.prep_mask(mask)
        if bw == 0:
            continue
        jobs.append((src, m, (x0, y0, bw, bh), (cx, cy)))
    if not jobs:
        return []

    if bucket in ("pad", "pad_exact"):
        groups = [((min(max(j[2][3] for j in jobs), H),
                    min(max(j[2][2] for j in jobs), W)), jobs)]
    elif bucket == "exact":
        by_shape: dict = {}
        for j in jobs:
            by_shape.setdefault((j[2][3], j[2][2]), []).append(j)
        groups = sorted(by_shape.items())
    else:
        raise ValueError(
            f"bucket must be 'exact', 'pad' or 'pad_exact', got {bucket!r}")

    planned = []
    for (bh, bw), group in groups:
        srcs_b = np.zeros((len(group), bh, bw, C), np.uint8)
        masks_b = np.zeros((len(group), bh, bw), np.uint8)
        lts = np.zeros((len(group), 2), np.int32)
        tights = np.zeros((len(group), 4), np.int32)
        for i, (src, m, (x0, y0, w_i, h_i), (cx, cy)) in enumerate(group):
            # the tight ROI lands at (cx - w/2, cy - h/2); in pad mode the
            # bucket window is clamped into the image and the ROI offset in
            # it, so its paste position is kept
            left_t, top_t = cx - w_i // 2, cy - h_i // 2
            if left_t < 0 or top_t < 0 or left_t + w_i > W or top_t + h_i > H:
                raise ValueError(f"job at ({cx},{cy}): ROI outside destination")
            left = min(max(left_t, 0), W - bw)
            top = min(max(top_t, 0), H - bh)
            if left < 0 or top < 0:
                raise ValueError("bucket larger than destination")
            ox, oy = left_t - left, top_t - top
            srcs_b[i, oy : oy + h_i, ox : ox + w_i] = np.where(
                m[y0 : y0 + h_i, x0 : x0 + w_i, None] != 0,
                src[y0 : y0 + h_i, x0 : x0 + w_i],
                0,
            )
            masks_b[i, oy : oy + h_i, ox : ox + w_i] = m[y0 : y0 + h_i, x0 : x0 + w_i]
            lts[i] = (left, top)
            tights[i] = (oy, ox, h_i, w_i)
        if device is not None:
            srcs_b = torch.from_numpy(srcs_b).to(device)
            masks_b = torch.from_numpy(masks_b).to(device)
        planned.append(((bh, bw), srcs_b, masks_b, lts, tights))
    return planned
