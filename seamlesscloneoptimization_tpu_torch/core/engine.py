"""SeamlessClone engine: a reusable instance whose destination stays on the
device from frame to frame.

Port of ``seamlesscloneoptimization_tpu/core/engine.py`` (ref instance
lifecycle ``seamlessClone_imp_create_instance/run/destroy/sync``,
seamlessClone-CUDA/seamlessClone_imp.cu:239-370):

- ``run(...)`` is asynchronous on the current CUDA stream; ``sync()``
  blocks. It writes a copy of the destination unless ``donate_dst=True``
  and the destination is already a device tensor, which is then updated in
  place.
- ``timed_serve`` uploads once and chains frames in place on a planar
  buffer it owns, timed with CUDA events after one warm-up frame.
- The DST bases of the DST-GEMM serve chain live on the device, cached per
  shape, so a frame uploads nothing: the padded matrix and eigenvalues of
  an axis that stays plain, the four folded factors and the grouped
  eigenvalues of an axis that folds (``dst_folded and fold_pays(n)``),
  and for a ``precision`` with bf16 passes each factor's bf16 hi and lo. A
  multigrid engine builds none of them; it caches the coarsest level's
  eigenbasis per geometry instead (``solvers/multigrid.py:coarse_solve``).
  The ``jacobi`` and ``dst_fft`` engines, and the tails that the two
  ``use_pallas_*`` fields select (``models/pipeline.py:clone_roi``), build
  none either.
- ``solver="auto"`` resolves per geometry: dst_gemm up to the crossover,
  multigrid above it (the default ``mg_padded="q"`` at any ``tol``, ``"t"``,
  True, the dense rounded V-cycles, or False, the element V-cycle with its
  fused levels).
- ``bbox_bucket > 0`` rounds the ROI up to a multiple (``prepare_inputs``):
  the grown bucket is solved as the ROI, ``auto`` resolving on the bucket
  and the DST bases cached per bucket. With ``bucket_exact`` the frame
  solves the tight bbox's own system inside the bucket
  (``models/pipeline.py:clone_roi_dyn``, the runtime-domain multigrid to
  the config's ``tol``, or ``mg_cycles`` cycles, up to ``max_cycles``;
  ``metrics["solver_resolved"] == "multigrid_dyn"``).
- ``dump_stages`` writes one clone's stages into ``debug_dir``; ``profile``
  is a ``torch.profiler`` context writing a Chrome trace; ``destroy`` drops
  the caches and the tensors the engine holds.
- ``run`` and ``timed_serve`` prepare a 2-D u8 mask (or None, the full
  mask) on the device: the raw mask uploaded, one ``prep_mask`` launch
  (binarize, zero the 1-px border, the bbox), the bbox's four ints read
  back for the ROI's placement (``place_roi``), all on a side stream the
  engine owns, so an asynchronous ``run`` does not wait for the frames it
  queued before. Any other mask takes ``native.prep_mask`` on the host
  (``prepare_inputs``), as ``dump_stages`` and the tiled engine's mesh
  frames do.
- Under a profiler, ``run`` and ``timed_serve`` are each one
  ``engine.request`` span (the engine's request number and its configured
  solver in ``args``) holding ``engine.prepare`` (validation, mask prep
  with its upload, ``auto``, the cache lookups), ``engine.bases_build`` (a
  DST-basis miss), ``engine.upload`` (src, dst, a host-prepared mask), the
  frames' ``pipeline.*`` spans, ``engine.sync`` (the
  host waiting on the card) and ``engine.finish``. ``timed_serve`` also
  puts the solver's V-cycles and host reads a timed frame
  (``solvers.multigrid.COUNTS``) into ``metrics["cycles_per_frame"]`` and
  ``metrics["checks_per_frame"]``.

Not ported here (TPU-only): the layout pin and self-heal, and the
sync-overhead subtraction.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import tempfile
import time
import weakref
from pathlib import Path
from typing import Any

import numpy as np
import torch
from torch.profiler import ProfilerActivity
from torch.profiler import profile as torch_profile

from seamlesscloneoptimization_tpu_torch import native, resolve_device
from seamlesscloneoptimization_tpu_torch.core.config import CloneConfig
from seamlesscloneoptimization_tpu_torch.core.trace import span
from seamlesscloneoptimization_tpu_torch.models.pipeline import clone_pipeline, clone_roi
from seamlesscloneoptimization_tpu_torch.ops import kernels as K
from seamlesscloneoptimization_tpu_torch.ops.kernels import ru128
from seamlesscloneoptimization_tpu_torch.solvers import (
    AUTO_CROSSOVER_PIXELS,
    SERVE_CROSSOVER_PIXELS,
    auto_solver_name,
    get_solver,
)
from seamlesscloneoptimization_tpu_torch.solvers.dst_gemm import check_precision, dst_bases
from seamlesscloneoptimization_tpu_torch.solvers.multigrid import COUNTS

DYN_SOLVER_NAME = "multigrid_dyn"  # bucket_exact's solve, as metrics record it


class BoundedCache(dict):
    """Recency-ordered dict evicting the least-recently-used entry past
    ``maxsize``."""

    def __init__(self, maxsize: int = 32):
        super().__init__()
        self.maxsize = maxsize

    def get(self, key, default=None):
        if key in self:
            val = super().pop(key)
            super().__setitem__(key, val)  # refresh recency
            return val
        return default

    def __setitem__(self, key, value):
        if key in self:
            super().pop(key)
        elif len(self) >= self.maxsize:
            super().pop(next(iter(self)))  # least recently used
        super().__setitem__(key, value)


def prepare_inputs(mask: np.ndarray, src_shape, dst_shape, center, bucket: int = 0,
                   return_tight: bool = False):
    """Host-side mask prep: binarize + border-zero + bbox (``native.prep_mask``),
    then the ROI's placement (``place_roi``).

    Returns None for an empty mask, else (prepared_mask, (x0, y0),
    (left, top), (bh, bw)) — plus, with ``return_tight``, (dy, dx,
    tight_bh, tight_bw): the tight bbox inside the returned ROI.
    """
    if bucket < 0:
        raise ValueError(f"bbox_bucket must be >= 0, got {bucket}")
    mask = np.asarray(mask)
    if mask.ndim == 3:
        mask = mask[..., 0]
    if mask.shape != tuple(src_shape[:2]):
        raise ValueError(f"mask shape {mask.shape} != source {tuple(src_shape[:2])}")
    m, bbox = native.prep_mask(mask)
    placed = place_roi(bbox, src_shape, dst_shape, center, bucket, return_tight)
    return None if placed is None else (m, *placed)


def place_roi(bbox, src_shape, dst_shape, center, bucket: int = 0, return_tight: bool = False):
    """The ROI of a prepared mask's bbox (x0, y0, bw, bh): None for an empty
    bbox, else ((x0, y0), (left, top), (bh, bw)) — plus, with
    ``return_tight``, (dy, dx, tight_bh, tight_bw). bucket > 0 rounds the
    ROI up to a multiple, placing the tight bbox inside it from the
    feasibility interval (bucket inside src AND its paste target inside dst,
    paste position preserved), or keeps the exact bbox when that interval is
    empty. Raises ValueError when the ROI leaves the destination.
    """
    x0, y0, bw, bh = bbox
    if bw == 0 or bh == 0:
        return None
    cx, cy = center
    left, top = cx - bw // 2, cy - bh // 2
    if left < 0 or top < 0 or left + bw > dst_shape[1] or top + bh > dst_shape[0]:
        raise ValueError(
            f"patch ROI ({left},{top})+({bw}x{bh}) outside destination {dst_shape[:2]}"
        )
    if bucket:
        tb = min(-(-bh // bucket) * bucket, src_shape[0], dst_shape[0])
        tw = min(-(-bw // bucket) * bucket, src_shape[1], dst_shape[1])
        lo_y = max(0, y0 - (src_shape[0] - tb), top - (dst_shape[0] - tb))
        hi_y = min(y0, top, tb - bh)
        lo_x = max(0, x0 - (src_shape[1] - tw), left - (dst_shape[1] - tw))
        hi_x = min(x0, left, tw - bw)
        if lo_y <= hi_y and lo_x <= hi_x:
            dy = min(max((tb - bh) // 2, lo_y), hi_y)
            dx = min(max((tw - bw) // 2, lo_x), hi_x)
            out = (x0 - dx, y0 - dy), (left - dx, top - dy), (tb, tw)
            return out + ((dy, dx, bh, bw),) if return_tight else out
    out = (x0, y0), (left, top), (bh, bw)
    return out + ((0, 0, bh, bw),) if return_tight else out


def _effective_solver(solver: str, bbox_hw, planar_dst: bool) -> str:
    """Resolve "auto" for one geometry: dst_gemm up to the crossover (the
    serve crossover for the planar serve loop), multigrid above it."""
    if solver != "auto":
        return solver
    crossover = SERVE_CROSSOVER_PIXELS if planar_dst else AUTO_CROSSOVER_PIXELS
    return auto_solver_name((3, bbox_hw[0] - 2, bbox_hw[1] - 2), crossover)


def _is_uint8(img) -> bool:
    if isinstance(img, torch.Tensor):
        return img.dtype == torch.uint8
    return np.dtype(img.dtype) == np.uint8


class SeamlessClone:
    """Reusable seamless-clone instance.

        engine = SeamlessClone(CloneConfig())             # runs on cuda
        out = engine.run(src, dst, mask, (800, 150))      # async
        engine.sync()
        out_np = out.cpu().numpy()

    ``device="cpu"`` runs the plain PyTorch twins of the kernels.
    """

    def __init__(self, config: CloneConfig | None = None, device=None):
        self.config = config or CloneConfig()
        cfg = self.config
        if cfg.solver != "auto":  # "auto" is resolved per geometry at run time
            get_solver(cfg.solver)  # ValueError if unknown
        if cfg.mg_padded not in ("q", "t", True, False):
            raise ValueError(f"unknown mg_padded {cfg.mg_padded!r}")
        check_precision(cfg.precision)
        if cfg.bbox_bucket < 0:
            raise ValueError(f"bbox_bucket must be >= 0, got {cfg.bbox_bucket}")
        if cfg.flags not in (1, 2, 3):
            raise ValueError(f"unknown clone flags={cfg.flags}")
        if cfg.mixed_rule not in ("opencv", "norm"):
            raise ValueError(f"unknown mixed_rule {cfg.mixed_rule!r}")
        self.device = resolve_device(device)
        self._bases = BoundedCache(maxsize=8)
        self._eig_cache = BoundedCache(maxsize=8)  # multigrid coarsest-level bases
        self._held: dict[int, Any] = {}  # id -> weakref of tensors THIS engine made
        self._last_out: torch.Tensor | None = None
        self._requests = 0  # run / timed_serve calls: engine.request's number
        self._side: torch.cuda.Stream | None = None  # the mask prep's stream on the card
        self.metrics: dict[str, Any] = {}

    def _request_span(self):
        """The ``engine.request`` span of the next call."""
        self._requests += 1
        return span("engine.request", f"seq={self._requests} solver={self.config.solver}")

    def _track(self, x: torch.Tensor) -> torch.Tensor:
        """Count a device tensor in this instance's memory accounting."""
        self._held[id(x)] = weakref.ref(x)
        return x

    def _upload(self, x) -> torch.Tensor:
        """A device copy of a host array (a copy on the CPU too: the
        pipeline writes in place and must never touch the caller's array)."""
        return self._track(
            torch.from_numpy(np.ascontiguousarray(x)).to(self.device, copy=True))

    def _device_bases(self, h2: int, w2: int):
        key = (h2, w2)
        b = self._bases.get(key)
        if b is None:
            with span("engine.bases_build"):
                b = dst_bases(h2, w2, ru128(h2), ru128(w2), self.device,
                              self.config.dst_folded, self.config.precision)
            for axis in b:
                for t in axis.tensors():
                    self._track(t)
            self._bases[key] = b
        return b

    @staticmethod
    def _validate(src, dst):
        """3-channel uint8 images, dst area >= src area (the reference's
        asserts, imp.cpp:432-436, as exceptions)."""
        for name, img in (("src", src), ("dst", dst)):
            if getattr(img, "ndim", None) != 3 or img.shape[2] != 3:
                raise ValueError(f"{name} must be (H, W, 3), got {getattr(img, 'shape', None)}")
            if not _is_uint8(img):
                raise TypeError(f"{name} must be uint8, got {img.dtype}")
        if dst.shape[0] * dst.shape[1] < src.shape[0] * src.shape[1]:
            raise ValueError(
                f"destination area {tuple(dst.shape[:2])} smaller than source "
                f"{tuple(src.shape[:2])}")

    def _bucket_exact(self) -> bool:
        return bool(self.config.bucket_exact and self.config.bbox_bucket)

    def _prepare(self, mask, src, dst, center):
        """``prepare_inputs`` with the config's bucket, on the host; in
        bucket_exact mode the tight bbox inside the ROI comes fifth
        (``_unpack_prep``). The callers that need the prepared mask on the
        host keep it: ``dump_stages`` and the tiled engine's mesh frames."""
        if mask is None:
            mask = np.full(tuple(src.shape[:2]), 255, np.uint8)
        elif isinstance(mask, torch.Tensor):
            mask = mask.cpu().numpy()
        return prepare_inputs(mask, tuple(src.shape), tuple(dst.shape), center,
                              bucket=self.config.bbox_bucket, return_tight=self._bucket_exact())

    @staticmethod
    def _preps_on_device(mask) -> bool:
        """The route of ``run``'s and ``timed_serve``'s mask prep, by the
        input: None (the full mask) and a 2-D u8 mask, a host array or a
        tensor, are prepared on the engine's device (``_prepare_request``);
        any other mask (3-D, another dtype) by ``_prepare`` on the host,
        where ``native.prep_mask`` compares it with 0 before any cast."""
        return mask is None or (getattr(mask, "ndim", None) == 2 and _is_uint8(mask))

    def _prepare_request(self, mask, src, dst, center):
        """``_prepare`` for ``run`` and ``timed_serve``. On the device route
        (``_preps_on_device``) the prepared mask is a tensor on the device
        and only its bbox's four ints come to the host, for ``place_roi``;
        otherwise ``_prepare``'s host array."""
        if not self._preps_on_device(mask):
            return self._prepare(mask, src, dst, center)
        hw = tuple(src.shape[:2])
        if mask is not None and tuple(mask.shape) != hw:
            raise ValueError(f"mask shape {tuple(mask.shape)} != source {hw}")
        m, bbox = self._device_prep(mask, hw)
        placed = place_roi(bbox, tuple(src.shape), tuple(dst.shape), center,
                           self.config.bbox_bucket, self._bucket_exact())
        return None if placed is None else (m, *placed)

    def _device_prep(self, mask, hw):
        """(the prepared (H, W) u8 mask on the device, its bbox as four ints),
        from one ``K.prep_mask`` (``_prep_kernel``). On the card the upload,
        the kernel and the bbox's read run on the engine's side stream: the
        read waits on that stream alone, not on frames still queued on the
        current stream (``run`` is asynchronous; a tensor mask on the
        engine's card waits for the current stream's queue first, which may
        still write it), and the current stream waits on the side stream's event before
        anything reads the mask."""
        here = isinstance(mask, torch.Tensor) and mask.device == self._concrete_device()
        if self.device.type != "cuda":
            m, bbox = self._prep_kernel(mask, hw, here)
            return self._track(m), bbox.tolist()
        if self._side is None:  # made on first use
            self._side = torch.cuda.Stream(device=self.device)
        main, side = torch.cuda.current_stream(self.device), self._side
        with torch.cuda.stream(side):
            if here:
                side.wait_stream(main)
            m, bbox = self._prep_kernel(mask, hw, here)
            done = side.record_event()
            bbox = bbox.tolist()  # a copy on the side stream, then its sync
        main.wait_event(done)
        m.record_stream(main)  # made on the side stream, read on this one
        return self._track(m), bbox

    def _concrete_device(self) -> torch.device:
        """The engine's device with its index: ``cuda`` is the current card."""
        if self.device.type == "cuda" and self.device.index is None:
            return torch.device("cuda", torch.cuda.current_device())
        return self.device

    def _prep_kernel(self, mask, hw, here: bool):
        """``K.prep_mask`` in place on the engine's own copy of the mask (a
        host mask uploaded, a tensor on another device, the CPU or another
        card, copied; the full mask made on the device for None); a tensor
        on the engine's device (``here``) is read where it lies and never
        written."""
        if here:
            return K.prep_mask(mask.contiguous())
        if mask is None:
            m = torch.full(hw, 255, dtype=torch.uint8, device=self.device)
        else:
            if not isinstance(mask, torch.Tensor):
                mask = torch.from_numpy(np.ascontiguousarray(mask))
            m = mask.to(self.device, memory_format=torch.contiguous_format, copy=True)
        return K.prep_mask(m, out=m)

    @staticmethod
    def _unpack_prep(prep):
        """(mask, bbox_xy, left_top, bbox_hw, tight bbox or None)."""
        m, xy, lt, hw = prep[:4]
        return m, xy, lt, hw, (prep[4] if len(prep) > 4 else None)

    @staticmethod
    def _has_interior(bbox_hw, tight) -> bool:
        """A pixel to solve for: in the tight bbox in bucket_exact mode, else
        in the ROI."""
        h, w = (tight[2], tight[3]) if tight is not None else bbox_hw
        return h >= 3 and w >= 3

    def _pipeline_kwargs(self, bbox_hw, flags: int, planar_dst: bool) -> dict:
        cfg = self.config
        if self._bucket_exact():
            self.metrics["solver_resolved"] = DYN_SOLVER_NAME
            return dict(bbox_hw=bbox_hw, flags=flags, solver=None,
                        solver_kwargs=dict(tol=cfg.tol, cycles=cfg.mg_cycles,
                                           max_cycles=cfg.max_cycles,
                                           use_pallas=cfg.use_pallas_smoother),
                        mixed_rule=cfg.mixed_rule, bases=None, solver_name=DYN_SOLVER_NAME,
                        use_pallas_pre=cfg.use_pallas_preprocess, use_pallas_post=False)
        eff = _effective_solver(self.config.solver, bbox_hw, planar_dst)
        self.metrics["solver_resolved"] = eff
        cfg = dataclasses.replace(self.config, solver=eff)
        # the JAX engine's _pallas_gates: the post-process only for these two
        pre = cfg.use_pallas_preprocess
        post = cfg.use_pallas_postprocess and eff in ("dst_gemm", "multigrid")
        bases = None  # the generic and transposed tails' solvers take none
        if eff == "multigrid":
            bases = self._eig_cache
        elif eff == "dst_gemm" and pre and post:
            bases = self._device_bases(bbox_hw[0] - 2, bbox_hw[1] - 2)
        return dict(bbox_hw=bbox_hw, flags=flags, solver=get_solver(eff),
                    solver_kwargs=cfg.solver_kwargs(), mixed_rule=cfg.mixed_rule,
                    bases=bases, solver_name=eff, use_pallas_pre=pre, use_pallas_post=post)

    def _to_device(self, x) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return x if x.device == self.device else self._track(x.to(self.device))
        return self._upload(x)

    # -- public API -----------------------------------------------------------

    def run(self, src, dst, mask, center, flags: int | None = None) -> torch.Tensor:
        """Dispatch one clone; returns the (H, W, 3) u8 device tensor (async).

        ``src``/``dst`` may be host numpy arrays or tensors; a device tensor
        is used without a host round trip. The caller's ``dst`` tensor is left
        unmodified unless ``donate_dst=True``.
        """
        with self._request_span():
            flags = self.config.flags if flags is None else flags
            with span("engine.prepare"):
                self._validate(src, dst)
                prep = self._prepare_request(mask, src, dst, center)
                if prep is not None:
                    m, (x0, y0), (left, top), (bh, bw), tight = self._unpack_prep(prep)
                    if self._has_interior((bh, bw), tight):
                        kw = self._pipeline_kwargs((bh, bw), flags, planar_dst=False)
                    else:
                        prep = None
            if prep is None:  # nothing to solve: the destination as it is
                with span("engine.upload"):
                    self._last_out = self._to_device(dst)
                return self._last_out
            with span("engine.upload"):
                src_d = self._to_device(src)
                dst_d = self._to_device(dst)
                if dst_d is dst and not self.config.donate_dst:
                    dst_d = self._track(dst_d.clone())
                m_d = self._to_device(m)
            out = clone_pipeline(src_d, dst_d, m_d, (x0, y0), (left, top), tight, **kw)
            with span("engine.finish"):
                self._last_out = out
                self.metrics["bbox"] = (x0, y0, bw, bh)
                self.metrics["left_top"] = (left, top)
            return out

    def sync(self):
        """Block until the last dispatched clone is done (ref: _sync)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def device_memory_bytes(self, process_wide: bool = False) -> int:
        """Live device bytes of tensors THIS instance created (ref:
        SCImage::mOccupy, imp.cu:346); ``process_wide=True`` gives the
        caching allocator's allocated bytes on the device instead."""
        if process_wide:
            if self.device.type == "cuda":
                return int(torch.cuda.memory_allocated(self.device))
            return 0
        total = 0
        for k, ref in list(self._held.items()):
            x = ref()
            if x is None:
                del self._held[k]
                continue
            total += x.numel() * x.element_size()
        return total

    def _timer(self):
        """(start, stop -> ms) on the device's clock: CUDA events on the
        card, the host clock for the CPU twins."""
        if self.device.type == "cuda":
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)

            def stop():
                e.record()
                e.synchronize()
                return s.elapsed_time(e)

            s.record()
            return stop
        t0 = time.perf_counter()
        return lambda: (time.perf_counter() - t0) * 1e3

    def timed_run(self, src, dst, mask, center, loops: int = 10, warmup: int = 1):
        """Warm-up + ``loops`` timed single-shot runs (each re-uploads the
        host inputs, like the reference's per-call H2D copies). Returns
        (out, mean_ms)."""
        for _ in range(warmup):
            self.run(src, dst, mask, center)
        self.sync()
        stop = self._timer()
        for _ in range(loops):
            out = self.run(src, dst, mask, center)
        mean_ms = stop() / loops
        self.metrics["compute_ms"] = mean_ms
        self.metrics["device_memory_bytes"] = self.device_memory_bytes()
        return out, mean_ms

    def timed_serve(self, src, dst, mask, center, loops: int = 20,
                    flags: int | None = None):
        """Steady-state serve: upload once, chain ``loops`` frames in place.

        Each frame's output is the next frame's destination, kept planar
        (C, H, W) on the device; one warm-up frame runs outside the timed
        window. Returns ((H, W, 3) u8 device tensor, mean ms per frame).
        """
        with self._request_span():
            flags = self.config.flags if flags is None else flags
            with span("engine.prepare"):
                self._validate(src, dst)
                prep = self._prepare_request(mask, src, dst, center)
                if prep is None:
                    raise ValueError("empty mask")
                m, (x0, y0), (left, top), (bh, bw), tight = self._unpack_prep(prep)
                if not self._has_interior((bh, bw), tight):
                    raise ValueError(
                        f"mask bbox {tight[2:] if tight else (bh, bw)} has no interior")
                kw = self._pipeline_kwargs((bh, bw), flags, planar_dst=True)
            with span("engine.upload"):
                src_d = self._to_device(src)
                buf = self._track(self._to_device(dst).permute(2, 0, 1).contiguous())
                m_d = self._to_device(m)

            def frame():  # bucket_exact: the tight bbox rides along every frame
                clone_pipeline(src_d, buf, m_d, (x0, y0), (left, top), tight,
                               planar_dst=True, **kw)

            frame()  # warm-up: kernel build/load, allocator, cuBLAS handles
            with span("engine.sync"):
                self.sync()
            before = dict(COUNTS)
            stop = self._timer()
            for _ in range(loops):
                frame()
            with span("engine.sync"):
                mean_ms = stop() / max(loops, 1)
            with span("engine.finish"):
                out = self._track(buf.permute(1, 2, 0).contiguous())
                self._last_out = out
                self.metrics["compute_ms"] = mean_ms
                for key in ("cycles", "checks"):
                    self.metrics[f"{key}_per_frame"] = (COUNTS[key] - before[key]) / max(loops, 1)
                self.metrics["bbox"] = (x0, y0, bw, bh)
                self.metrics["left_top"] = (left, top)
                self.metrics["device_memory_bytes"] = self.device_memory_bytes()
            return out, mean_ms

    def dump_stages(self, src, dst, mask, center, flags: int | None = None):
        """Run one clone keeping every intermediate stage (ref: SCDEBUG mode).

        The reference dumps per-stage tensors under ``#define SCDEBUG``
        (write2Yaml2, imp.h:306-366; the RHS channels as g{0,1,2}.yml,
        imp.cpp:2116) for the g-vs-mod_diff debugging method (compare/vs.py:
        81-86). This writes the same artifacts into ``config.debug_dir``:
        mask_eroded.yml, g{0,1,2}.yml, output.bmp and gx / gy / u / rhs .npy,
        through the plain stages (``clone_roi(return_stages=True)``) on the
        ROI that ``run`` takes (bucketed with ``bbox_bucket``), ``auto``
        resolved with the single-shot crossover. A write that fails raises.
        Returns ((H, W, 3) u8 numpy output, dict of numpy stages).
        """
        flags = self.config.flags if flags is None else flags
        src, dst = (x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
                    for x in (src, dst))
        self._validate(src, dst)
        prep = self._prepare(mask, src, dst, center)
        if prep is None:
            raise ValueError("empty mask")
        m, (x0, y0), (left, top), (bh, bw), _ = self._unpack_prep(prep)
        mask_roi = m[y0 : y0 + bh, x0 : x0 + bw]
        src_roi = np.where(mask_roi[..., None] != 0, src[y0 : y0 + bh, x0 : x0 + bw], 0)
        dest_roi = dst[top : top + bh, left : left + bw]
        eff = _effective_solver(self.config.solver, (bh, bw), planar_dst=False)
        cfg = dataclasses.replace(self.config, solver=eff)

        def planar(a):
            return self._upload(a).permute(2, 0, 1)

        blended, stages = clone_roi(planar(dest_roi), planar(src_roi.astype(np.uint8)),
                                    self._upload(mask_roi), flags, get_solver(eff),
                                    cfg.solver_kwargs(), return_stages=True,
                                    mixed_rule=cfg.mixed_rule)
        out = dst.copy()
        out[top : top + bh, left : left + bw] = blended.permute(1, 2, 0).cpu().numpy()
        stages = {k: v.cpu().numpy() for k, v in stages.items()}
        stages.update(mask_roi=mask_roi, bbox=np.array([x0, y0, bw, bh]),
                      left_top=np.array([left, top]))
        d = Path(self.config.debug_dir)
        d.mkdir(parents=True, exist_ok=True)
        native.write_yaml_mat(d / "mask_eroded.yml", stages["mask_eroded"], "mask_eroded")
        for ch in range(stages["rhs"].shape[0]):
            native.write_yaml_mat(d / f"g{ch}.yml", stages["rhs"][ch], f"g{ch}")
        native.write_bmp(d / "output.bmp", out)
        for k in ("gx", "gy", "u", "rhs"):
            np.save(d / f"{k}.npy", stages[k])
        return out, stages

    @contextlib.contextmanager
    def profile(self, logdir: str | None = None):
        """Context manager: ``torch.profiler`` over its body, written as a
        Chrome trace (``trace_<pid>_<ns>.json``, chrome://tracing or
        Perfetto) into ``logdir`` (default ``<tempdir>/scl_profile``), which
        it yields. On ``cuda`` it records the device's kernels too, the
        counterpart of the reference's nvprof / NVVP workflow
        (README.md:133-136). A body that raises writes no trace.

            with eng.profile("traces") as d:
                eng.timed_serve(...)
        """
        logdir = logdir or os.path.join(tempfile.gettempdir(), "scl_profile")
        os.makedirs(logdir, exist_ok=True)
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        with torch_profile(activities=acts) as prof:
            yield logdir
            self.sync()
        prof.export_chrome_trace(
            os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))

    def destroy(self):
        """Drop the cached bases and the tensors this engine holds (ref:
        _destroy); ``device_memory_bytes()`` is 0 afterwards."""
        self._bases.clear()
        self._eig_cache.clear()
        self._held.clear()
        self._last_out = None
