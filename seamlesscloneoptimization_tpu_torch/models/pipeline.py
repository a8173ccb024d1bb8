"""The seamless-clone pipeline: ROI slicing, the kernel chain, the paste.

Port of ``seamlesscloneoptimization_tpu/models/pipeline.py`` (ref
``SeamlessClone::run``, seamlessClone_imp.cpp:2105-2135). The bbox is
computed on the host before the call (``core/engine.py:prepare_inputs``),
so offsets and sizes are plain ints and the ROI is a strided view: nothing
outside it is converted or copied.

The kernel branch of ``clone_roi`` is the serve path. With ``folded`` (the
config's default ``dst_folded=True``) and both interior sides folding
(``pair_chain_applies``: every side above 128 px), one frame is

    erode3 -> preprocess_rhs_t -> fold_minor -> 2 GEMMs -> transpose_pair
    -> fold_minor -> 2 GEMMs -> transpose_pair(÷) x2 -> 2 GEMMs
    -> unfold_transpose x2 -> 2 GEMMs -> unfold_clamp_paste

and otherwise (the per-axis route; ``dst_folded=False``, or one side of at
most 128 px)

    erode3 -> preprocess_rhs_t -> GEMM -> transpose -> GEMM -> transpose(÷)
    -> GEMM -> transpose -> GEMM -> clamp_cast_paste

where an axis that folds (``folded and fold_pays(n)``) joins its half-GEMMs
through the pair chain's kernels: a folded h runs fold_minor -> 2
half-GEMMs -> transpose_pair forward and 2 half-GEMMs -> unfold_transpose
back; a folded w fold_minor -> 2 half-GEMMs -> transpose_pair(÷) forward
and ends in 2 half-GEMMs -> unfold_clamp_paste (``parts_apply``: the
solve returns the w halves wherever w folds). With
``solver_name="multigrid"`` (the multigrid serve tail, ref
``pipeline.py:152-237``) and ``mg_padded="q"`` (the default) on a grid the
quarter-plane chain takes (``quarter_path_applies``), a frame is

    erode3 -> preprocess_rhs_q -> mg_down_q -> [coarse -> mg_ud_q] x k
    -> coarse (-> mg_up_q in fixed mode) -> clamp_cast_paste_q

with the RHS born as the finest level's four quarter planes and "coarse"
the transposed ``vcycle_t`` levels, then mg_prolong_tq. With
``mg_padded="t"`` on a grid the ``"t"`` chain takes (``t_chain_applies``)
it is

    erode3 -> preprocess_rhs_p -> solve_multigrid(padded_output=True)
    -> clamp_cast_paste

with the RHS born in the level geometry's (hp, wp) slab and each V-cycle
level mg_down_t -> (coarser level) -> mg_up_t (each a level kernel with
its transposed transfer folded in); smaller grids take the same tail on the exact-size RHS and the
element path. With ``mg_padded=True`` the RHS is exact-size and the solve
pads it once into ``mg_geometry``'s slab, whose fused levels each run
mg_down -> (coarser level) -> mg_up (``vcycle_p``), and hands the slab to
``clamp_cast_paste``. ``solver_name`` "jacobi" or "dst_fft", and any solver with
``use_pallas_postprocess=False``, take the generic tail

    erode3 -> preprocess_rhs_p (exact size) -> solver -> clamp_cast_paste

(``solve_redblack``'s bursts are ``rb_sweeps`` launches). With
``use_pallas_preprocess=False`` the RHS is the plain torch stages instead,
and ``dst_gemm`` with the post-process on ends

    solve_dst_gemm(transposed_output=True) -> postprocess_transposed

A bucketed ROI with ``bucket_exact`` (``clone_pipeline``'s ``true_bbox``)
solves the tight bbox's own system inside the bucket (``clone_roi_dyn``):

    erode3 -> preprocess_rhs_p (the tight window, exact size)
    -> solve_dyn_window (mg_down / mg_up on each level of >= 2^18 points)
    -> clamp_cast_paste (the tight interior)

Either way the interior is written in place into the destination at
(top+1, left+1), planar or interleaved, by one strided kernel.
On CPU tensors each kernel wrapper runs its plain twin. Everything runs on
the current stream, in order: the next chained frame's preprocess reads the
ROI this frame's paste wrote.

A frame's host time falls into spans (``core/trace.py``): ``pipeline.frame``
around ``clone_pipeline``, and inside it ``pipeline.glue`` (the ROI views,
``roi_mask``, the patch), ``pipeline.rhs`` (the erosion and the RHS),
``pipeline.solve`` (the solver's name in its ``args``) and
``pipeline.paste``.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from seamlesscloneoptimization_tpu_torch.core.trace import span
from seamlesscloneoptimization_tpu_torch.ops.guidance import (
    MONOCHROME_TRANSFER,
    bgr_to_gray_u8,
    guidance_field,
)
from seamlesscloneoptimization_tpu_torch.ops.kernels import (
    clamp_cast_paste,
    clamp_cast_paste_q,
    erode3,
    mg_geometry_q,
    mg_geometry_t,
    postprocess_transposed,
    preprocess_rhs_p,
    preprocess_rhs_q,
    preprocess_rhs_t,
    unfold_clamp_paste,
)
from seamlesscloneoptimization_tpu_torch.ops.mask import binarize_mask, erode3x3, roi_mask
from seamlesscloneoptimization_tpu_torch.ops.postprocess import postprocess_roi
from seamlesscloneoptimization_tpu_torch.ops.rhs import poisson_rhs
from seamlesscloneoptimization_tpu_torch.solvers import get_solver
from seamlesscloneoptimization_tpu_torch.solvers.dst_gemm import (
    parts_apply,
    solve_dst_gemm_pl,
)
from seamlesscloneoptimization_tpu_torch.solvers.multigrid import (
    quarter_path_applies,
    t_chain_applies,
)
from seamlesscloneoptimization_tpu_torch.solvers.multigrid_dyn import solve_dyn_window


def _plain_rhs(dest_roi_u8, patch_u8, mask_roi, flags, mixed_rule):
    """erode3x3 -> guidance_field -> poisson_rhs in torch ops (XLA's ops in
    the JAX package): (g (C, H-2, W-2), stages)."""
    dest_f = dest_roi_u8.to(torch.float32)
    mask_eroded = erode3x3(binarize_mask(mask_roi))
    gx, gy = guidance_field(dest_f, patch_u8.to(torch.float32), mask_eroded, flags,
                            mixed_rule)
    g = poisson_rhs(gx, gy, dest_f)
    return g, {"mask_eroded": mask_eroded, "gx": gx, "gy": gy, "rhs": g}


def _kernel_rhs_inputs(patch_u8: torch.Tensor, mask_roi: torch.Tensor, flags: int):
    """What the RHS kernels read besides the destination: the ``erode3`` of
    the (contiguous) mask, the patch and the kernel's flags. MONOCHROME
    passes the integer gray in [0, 255] as u8, broadcast over the channels by
    a stride-0 view, with flags 1."""
    me = erode3(mask_roi)
    if flags == MONOCHROME_TRANSFER:
        gray = bgr_to_gray_u8(patch_u8).to(torch.uint8)
        return me, gray[None].expand(patch_u8.shape), 1
    return me, patch_u8, flags


def clone_roi(
    dest_roi_u8: torch.Tensor,
    patch_u8: torch.Tensor,
    mask_roi: torch.Tensor,
    flags: int,
    solver: Callable[..., torch.Tensor] | None = None,
    solver_kwargs: dict[str, Any] | None = None,
    return_stages: bool = False,
    mixed_rule: str = "opencv",
    out: torch.Tensor | None = None,
    out_offset: tuple[int, int] | None = None,
    bases=None,
    solver_name: str | None = None,
    use_pallas_pre: bool = True,
    use_pallas_post: bool = True,
):
    """Clone on a pre-cropped ROI. Planar (C, H, W) u8 images, (H, W) u8 mask.

    ``patch_u8`` must already be zeroed outside the (pre-erosion) mask.

    Kernel branch (the default), routed as the JAX package routes it by
    ``solver_name`` and the config's ``use_pallas_preprocess`` /
    ``use_pallas_postprocess`` (``use_pallas_pre`` / ``use_pallas_post``):

    - Without ``use_pallas_post`` (the engine's gate for ``"jacobi"`` and
      ``"dst_fft"``, which have no post-process tail: with it they raise):
      the generic tail. The exact-size RHS (``preprocess_rhs_p`` with
      ``out_hw = (H-2, W-2)``, or the plain torch stages without
      ``use_pallas_pre``) -> ``solver(g, **solver_kwargs)`` ->
      ``clamp_cast_paste``.
    - ``"multigrid"``: the multigrid serve tail, ``solver`` being
      ``solve_multigrid`` with ``solver_kwargs``
      (``CloneConfig.solver_kwargs()``) and ``bases`` the engine's
      coarse-basis cache (a dict, or None); without ``use_pallas_pre`` the
      plain RHS feeds ``solver(g, padded_output=True)``.
    - ``"dst_gemm"`` or None: the DST-GEMM serve chain, which ignores
      ``solver`` (``solver_kwargs`` gives ``precision`` and ``folded``), and
      ``bases`` are the device-resident DST bases (``dst_bases`` with the
      same ``folded``), or None. Wherever w folds (``parts_apply``) the last
      unfold is fused into ``unfold_clamp_paste``. Without
      ``use_pallas_pre``: the plain RHS -> ``solver(g,
      transposed_output=True, **solver_kwargs)`` -> ``postprocess_transposed``.

    ``solver=None`` takes ``SOLVERS[solver_name]``.

    With ``out`` (a (C, Hd, Wd) u8 destination view) and ``out_offset`` =
    (top1, left1), the solved interior is pasted in place there and ``out``
    is returned; else a new blended (C, H, W) ROI is returned.

    Plain branch (``return_stages``): erode3x3 -> guidance_field ->
    poisson_rhs -> ``solver`` -> postprocess_roi; returns (blended, stages).
    """
    solver_kwargs = dict(solver_kwargs or {})
    _, h, w = dest_roi_u8.shape
    if return_stages:
        g, stages = _plain_rhs(dest_roi_u8, patch_u8, mask_roi, flags, mixed_rule)
        u = solver(g, **solver_kwargs)
        return postprocess_roi(u, dest_roi_u8), {**stages, "u": u}
    h2, w2 = h - 2, w - 2
    if out is None:
        out, out_offset = dest_roi_u8.clone(), (1, 1)
    top1, left1 = out_offset
    name = solver_name or "dst_gemm"
    solver = solver or get_solver(name)
    if use_pallas_post and name not in ("dst_gemm", "multigrid"):
        # the engine gates the post-process (JAX's _pallas_gates); a direct
        # caller must not get another solver's chain silently
        raise ValueError(f"use_pallas_post has no tail for solver {name!r}")
    if use_pallas_pre and use_pallas_post and name == "dst_gemm":
        precision = solver_kwargs.get("precision", "highest")
        folded = bool(solver_kwargs.get("folded", False))
        parts = parts_apply(w2, folded)
        with span("pipeline.rhs"):
            me, patch_in, kflags = _kernel_rhs_inputs(patch_u8, mask_roi, flags)
            g_tp = preprocess_rhs_t(dest_roi_u8, patch_in, me, kflags, mixed_rule)
        with span("pipeline.solve", name):
            u = solve_dst_gemm_pl(g_tp, h2=h2, w2=w2, precision=precision, folded=folded,
                                  bases=bases, return_parts=parts)
        with span("pipeline.paste"):
            if parts:
                return unfold_clamp_paste(*u, out, top1, left1, h2, w2)
            return clamp_cast_paste(u, out, top1, left1, h2, w2)

    kw = dict(solver_kwargs, eig_cache=bases) if name == "multigrid" else dict(solver_kwargs)
    out_hw, quarters = (h2, w2), False
    if use_pallas_post and name == "multigrid":
        use_pallas, padded = kw.get("use_pallas", False), kw.get("padded")
        # the plain RHS is exact-size: only the kernels give birth to padded layouts
        if use_pallas_pre and padded == "q" and quarter_path_applies(h2, w2,
                                                                     use_pallas=use_pallas):
            # the RHS is born as quarter planes, the solve stays in them and
            # the paste interleaves them: no conversion pass
            _, hq, wq2, _ = mg_geometry_q(h2, w2)
            out_hw, quarters = (2 * hq, 2 * wq2), True
            kw["padded_output"], kw["true_hw"] = "quarters", (h2, w2)
        else:
            if use_pallas_pre and padded == "t" and t_chain_applies(h2, w2,
                                                                    use_pallas=use_pallas):
                # the RHS is born in the fine level's slab: no pad pass
                _, hp, wp, _ = mg_geometry_t(h2, w2)
                out_hw, kw["true_hw"] = (hp, wp), (h2, w2)
            kw["padded_output"] = True
    with span("pipeline.rhs"):
        if use_pallas_pre:
            me, patch_in, kflags = _kernel_rhs_inputs(patch_u8, mask_roi, flags)
            preprocess = preprocess_rhs_q if quarters else preprocess_rhs_p
            g = preprocess(dest_roi_u8, patch_in, me, out_hw, kflags, mixed_rule)
        else:
            g = _plain_rhs(dest_roi_u8, patch_u8, mask_roi, flags, mixed_rule)[0]
    transposed = use_pallas_post and name == "dst_gemm"
    with span("pipeline.solve", name):
        # the DST solve ends transposed; one kernel transposes, clamps and pastes
        u = solver(g, transposed_output=True, **kw) if transposed else solver(g, **kw)
    with span("pipeline.paste"):
        if quarters:
            return clamp_cast_paste_q(u, out, top1, left1, h2, w2)
        if transposed:
            return postprocess_transposed(u.contiguous(), out, top1, left1)
        return clamp_cast_paste(u.contiguous(), out, top1, left1, h2, w2)


def clone_roi_dyn(
    dest_roi_u8: torch.Tensor,
    patch_u8: torch.Tensor,
    mask_roi: torch.Tensor,
    flags: int,
    tight: tuple[int, int, int, int],
    mixed_rule: str = "opencv",
    tol: float = 1e-4,
    cycles: int | None = None,
    max_cycles: int = 60,
    out: torch.Tensor | None = None,
    out_offset: tuple[int, int] | None = None,
    use_pallas_pre: bool = True,
    use_pallas: bool = True,
) -> torch.Tensor:
    """Exact TIGHT-bbox clone inside a bucketed ROI (``bucket_exact``).

    dest_roi_u8, patch_u8: (C, bh, bw) u8, mask_roi: (bh, bw) u8, the
    bucketed ROI as ``clone_roi`` takes it. tight = (dy, dx, th, tw): the
    tight bbox's offset and size inside it. Solves the Poisson system that
    the tight pipeline solves, its Dirichlet frame at the tight bbox's edge:
    the RHS of the tight window (the guidance is local, and the mask is zero
    outside the tight bbox, so the tight window's erosion and RHS are the
    bucket's, windowed), then ``solve_dyn_window`` with the hierarchy of the
    bucket's (bh-2, bw-2) interior, then the (th-2, tw-2) interior pasted at
    (dy, dx) past ``out_offset``. Kernels: ``erode3`` of the tight mask and
    ``preprocess_rhs_p`` on the tight window's views (the plain torch
    stages without ``use_pallas_pre``), the fused levels of the solve
    (``use_pallas``), ``clamp_cast_paste``. ``out`` and ``out_offset`` as
    for ``clone_roi``; a tight bbox without interior writes nothing.
    """
    dy, dx, th, tw = (int(v) for v in tight)
    _, bh, bw = dest_roi_u8.shape
    if out is None:
        out, out_offset = dest_roi_u8.clone(), (1, 1)
    h2, w2 = th - 2, tw - 2
    if h2 < 1 or w2 < 1:
        return out
    dest_w = dest_roi_u8[:, dy : dy + th, dx : dx + tw]
    patch_w = patch_u8[:, dy : dy + th, dx : dx + tw]
    mask_w = mask_roi[dy : dy + th, dx : dx + tw].contiguous()
    with span("pipeline.rhs"):
        if use_pallas_pre:
            me, patch_in, kflags = _kernel_rhs_inputs(patch_w, mask_w, flags)
            g = preprocess_rhs_p(dest_w, patch_in, me, (h2, w2), kflags, mixed_rule)
        else:
            g = _plain_rhs(dest_w, patch_w, mask_w, flags, mixed_rule)[0]
    with span("pipeline.solve", "multigrid_dyn"):
        u = solve_dyn_window(g, (bh - 2, bw - 2), tol=tol, cycles=cycles,
                             max_cycles=max_cycles, use_pallas=use_pallas)
    top1, left1 = out_offset
    with span("pipeline.paste"):
        return clamp_cast_paste(u.contiguous(), out, top1 + dy, left1 + dx, h2, w2)


def clone_pipeline(
    src: torch.Tensor,
    dst: torch.Tensor,
    mask: torch.Tensor,
    bbox_xy: tuple[int, int],
    left_top: tuple[int, int],
    true_bbox: tuple[int, int, int, int] | None = None,
    *,
    bbox_hw: tuple[int, int],
    flags: int,
    solver: Callable[..., torch.Tensor] | None = None,
    solver_kwargs: dict[str, Any] | None = None,
    mixed_rule: str = "opencv",
    planar_dst: bool = False,
    bases=None,
    solver_name: str | None = None,
    use_pallas_pre: bool = True,
    use_pallas_post: bool = True,
) -> torch.Tensor:
    """Full-image clone, IN PLACE into ``dst``; returns ``dst``.

    src: (hs, ws, C) u8 interleaved. dst: (hd, wd, C) u8 interleaved, or
    with ``planar_dst=True`` (C, hd, wd) planar (the serve loop's chained
    buffer). mask: (hs, ws) u8. bbox_xy = (x0, y0) of the mask bbox,
    left_top = (left, top) of the paste in dst, bbox_hw = (bh, bw).
    Only the ROI interior of dst, (top+1 .. top+bh-2, left+1 .. left+bw-2),
    is written. The remaining keywords are ``clone_roi``'s.

    true_bbox = (dy, dx, th, tw): the ``bucket_exact`` mode. The ROI is a
    bucket and ``clone_roi_dyn`` solves the TIGHT system at that offset and
    size inside it, ``solver_kwargs`` giving ``tol``, ``cycles``,
    ``max_cycles`` and ``use_pallas``; ``solver``, ``bases`` and
    ``use_pallas_post`` are unused.
    """
    bh, bw = bbox_hw
    x0, y0 = bbox_xy
    left, top = left_top
    with span("pipeline.frame"):
        with span("pipeline.glue"):
            # ROI-first: strided views, no full-image conversion
            src_p = src[y0 : y0 + bh, x0 : x0 + bw, :].permute(2, 0, 1)
            dst_chw = dst if planar_dst else dst.permute(2, 0, 1)
            dest_p = dst_chw[:, top : top + bh, left : left + bw]

            # binarize + 1-px frame-zero of the mask (ref setMaskBoundaryToConstant),
            # on the ROI slice in global coordinates — the host prep usually did
            # this already; re-applying keeps raw-mask callers right at ROI cost
            mask_roi = roi_mask(mask, (x0, y0), (bh, bw))
            patch = torch.where(mask_roi[None] != 0, src_p, 0).to(torch.uint8)

        if true_bbox is not None:
            kw = solver_kwargs or {}
            clone_roi_dyn(dest_p, patch, mask_roi, flags, true_bbox, mixed_rule,
                          tol=kw.get("tol", 1e-4), cycles=kw.get("cycles"),
                          max_cycles=kw.get("max_cycles", 60), out=dst_chw,
                          out_offset=(top + 1, left + 1), use_pallas_pre=use_pallas_pre,
                          use_pallas=kw.get("use_pallas", True))
            return dst
        clone_roi(dest_p, patch, mask_roi, flags, solver, solver_kwargs,
                  mixed_rule=mixed_rule, out=dst_chw, out_offset=(top + 1, left + 1),
                  bases=bases, solver_name=solver_name, use_pallas_pre=use_pallas_pre,
                  use_pallas_post=use_pallas_post)
    return dst
