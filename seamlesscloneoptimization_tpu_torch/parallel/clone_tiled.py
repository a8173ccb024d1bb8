"""Seamless clone with the pipeline decomposed over a tile mesh.

Port of ``seamlesscloneoptimization_tpu/parallel/clone_tiled.py``
(BASELINE config[4]: 8K panorama destinations). ``TiledSeamlessClone`` is
the serve engine (``core/engine.py:SeamlessClone``) over a ``TileMesh``;
``seamless_clone_tiled`` the one-shot function, ``local_edit_tiled`` the
edits.

On a mesh of one device the engine IS the single-device engine, byte for
byte. On a larger mesh every stage runs per tile (``parallel/stages.py``):
each cell's windows of src, dst and mask are uploaded from the host, each
tile of g is born on the device that solves it, the solve runs on tiles and
returns tiles, and each tile's interior is pasted into the destination
tile that its device holds (``clamp_cast_paste``, one launch a tile). The
destination stays on the mesh as tiles from frame to frame
(``timed_serve``); no frame gathers it, g or u. ``run`` returns the whole
(H, W, 3) u8 image, gathered once: on the mesh's first device of this
process, on every rank of a mesh that spans processes (``init_distributed``;
every rank passes the same host images).

``path`` picks the solve: ``"dd"`` (the default) ``solve_poisson_dd``, the
domain-decomposed multigrid with its communication-avoiding tiles and a
replicated coarse solve; ``"gspmd"`` ``solve_multigrid_sharded``, the
element V-cycle with every level partitioned over the mesh (JAX's
XLA-partitioned path, bit-equal to the single-device element solve;
``parallel/tiled.py``). The stages take the generic tail, as JAX's mesh
gates (``_pallas_gates``) send them: the plain RHS, the decomposed solve,
the ``clamp_cast_paste`` kernel. Both paths honour ``mg_cycles`` and
``max_cycles``; JAX's ``"gspmd"`` solver takes ``tol`` only (ROADMAP §3).

``bbox_bucket`` works as in the single-device engine: the grown bucket is
the decomposed solve's ROI; with ``bucket_exact`` the frame solves the tight
bbox's system, ``solve_multigrid_dyn_sharded`` over the tight interior's
tiles (the plain RHS of the tight window, the runtime-domain multigrid
partitioned, the paste), to the config's ``tol``, or for ``mg_cycles``
cycles, up to ``max_cycles``. The JAX package's tiled engine drops those
three on a real mesh and solves to tol 1e-4; the port keeps them on purpose
(ROADMAP §3).
"""

from __future__ import annotations

import numpy as np
import torch

from seamlesscloneoptimization_tpu_torch.core.config import CloneConfig
from seamlesscloneoptimization_tpu_torch.core.engine import DYN_SOLVER_NAME, SeamlessClone
from seamlesscloneoptimization_tpu_torch.core.trace import span
from seamlesscloneoptimization_tpu_torch.ops.mask import roi_mask
from seamlesscloneoptimization_tpu_torch.parallel.mesh import GATHERS, TileMesh, make_tile_mesh
from seamlesscloneoptimization_tpu_torch.parallel.transport import CROSSED, REPLICATED
from seamlesscloneoptimization_tpu_torch.parallel.stages import ResidentFrame
from seamlesscloneoptimization_tpu_torch.parallel.tiled import (
    dd_tiling,
    sharded_tiling,
    solve_multigrid_dyn_sharded_tiles,
    solve_multigrid_sharded_tiles,
    solve_poisson_dd_tiles,
)

DD_SOLVER_NAME = "multigrid_dd"
GSPMD_SOLVER_NAME = "multigrid_gspmd"


def _check_path(path: str) -> None:
    if path not in ("dd", "gspmd"):
        raise ValueError(f"path must be 'dd' or 'gspmd', got {path!r}")


def _tile_solver(path: str, mesh: TileMesh, hw2, tol: float, cycles: int | None,
                 max_cycles: int = 60, eig_cache=None):
    """(the g tiling, solve(g_tiles) -> u_tiles) of ``path`` for an hw2
    interior: ``solve_poisson_dd`` to ``tol``, or for ``cycles`` (4 when
    both are None, as in the JAX package), or ``solve_multigrid_sharded``
    to ``tol``, or for ``cycles`` when given (JAX's ``_gspmd_solver``)."""
    if path == "dd":
        dd_tol = None if cycles else tol

        def solve(g_tiles):
            return solve_poisson_dd_tiles(g_tiles, hw2, mesh, tol=dd_tol, cycles=cycles or 4,
                                          max_cycles=max_cycles, eig_cache=eig_cache)

        return dd_tiling(*hw2, mesh), solve

    def solve(g_tiles):
        return solve_multigrid_sharded_tiles(g_tiles, hw2, mesh, tol=tol, max_cycles=max_cycles,
                                             cycles=cycles, eig_cache=eig_cache)

    return sharded_tiling(*hw2, mesh), solve


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class TiledSeamlessClone(SeamlessClone):
    """The serve engine (``run`` / ``sync`` / ``timed_serve``) with its
    pipeline decomposed over a ``TileMesh``.

        mesh = make_tile_mesh([torch.device("cuda")] * 4, (2, 2))  # one card
        engine = TiledSeamlessClone(CloneConfig(), mesh=mesh)
        out, ms = engine.timed_serve(src, dst, mask, center)

    A mesh of one device degenerates to ``SeamlessClone`` on that device.
    On a larger mesh the stages run per tile and the destination stays on
    the mesh as tiles (module docstring); the solve is the DD multigrid
    (``path="dd"``, ``metrics["solver_resolved"] == "multigrid_dd"``) or
    the partitioned element V-cycle (``path="gspmd"``,
    ``"multigrid_gspmd"``) to ``config.tol``, or for ``config.mg_cycles``
    cycles, up to ``config.max_cycles``. With ``bucket_exact`` the frame
    solves the tight system partitioned (``metrics["solver_resolved"] ==
    "multigrid_dyn"``). ``metrics`` also records, over ``timed_serve``'s
    timed frames, the whole-array gathers (``gathers_per_frame``: 0), the
    bytes this process sent to other ranks (``crossed_bytes_per_frame``)
    and the bytes of the levels the solvers replicate
    (``replicated_bytes_per_frame``), and each local cell's resident bytes
    (``resident_bytes``).
    """

    def __init__(self, config: CloneConfig | None = None, mesh: TileMesh | None = None,
                 path: str = "dd"):
        _check_path(path)
        self.mesh = mesh if mesh is not None else make_tile_mesh()
        self.path = path
        self._single = self.mesh.size == 1
        super().__init__(config, device=self.mesh.distinct()[0])

    # -- the mesh-resident frame ----------------------------------------------

    def _frame(self, src, dst, prep, flags: int) -> ResidentFrame:
        """The resident frame of one clone: the geometry, the solver, the
        uploaded destination tiles and input windows."""
        cfg = self.config
        m, (x0, y0), (left, top), (bh, bw), tight = self._unpack_prep(prep)
        mask_roi = roi_mask(torch.from_numpy(_host(m)), (x0, y0), (bh, bw)).numpy()
        src_h = _host(src)
        if tight is not None:  # the tight window's own system in the bucket
            dy, dx, th, tw = tight
            hw2 = (th - 2, tw - 2)
            tiling = sharded_tiling(*hw2, self.mesh)
            padded = (bh - 2, bw - 2)

            def solve(g_tiles):
                return solve_multigrid_dyn_sharded_tiles(
                    g_tiles, hw2, padded, self.mesh, tol=cfg.tol, cycles=cfg.mg_cycles,
                    max_cycles=cfg.max_cycles)

            self.metrics["solver_resolved"] = DYN_SOLVER_NAME
            roi = (y0 + dy, x0 + dx, top + dy, left + dx, th, tw)
            mask_w = mask_roi[dy : dy + th, dx : dx + tw]
        else:
            hw2 = (bh - 2, bw - 2)
            tiling, solve = _tile_solver(self.path, self.mesh, hw2, cfg.tol, cfg.mg_cycles,
                                         cfg.max_cycles, self._eig_cache)
            self.metrics["solver_resolved"] = (GSPMD_SOLVER_NAME if self.path == "gspmd"
                                               else DD_SOLVER_NAME)
            roi = (y0, x0, top, left, bh, bw)
            mask_w = mask_roi
        sy, sx, dt, dl, h, w = roi
        frame = ResidentFrame(self.mesh, tiling, hw2, (dt, dl), tuple(dst.shape[:2]), solve,
                              track=self._track)
        frame.upload_dest(dst)
        frame.set_clone_inputs(src_h[sy : sy + h, sx : sx + w], mask_w, flags,
                               cfg.mixed_rule)
        self.metrics["bbox"] = (x0, y0, bw, bh)
        self.metrics["left_top"] = (left, top)
        self.metrics["resident_bytes"] = frame.resident_bytes()
        return frame

    def _prepared(self, src, dst, mask, center, flags):
        """(flags, prep or None when nothing is to be solved)."""
        flags = self.config.flags if flags is None else flags
        self._validate(src, dst)
        prep = self._prepare(mask, src, dst, center)
        if prep is None:
            return flags, None
        _, _, _, hw, tight = self._unpack_prep(prep)
        return flags, (prep if self._has_interior(hw, tight) else None)

    def sync(self):
        for d in self.mesh.distinct():
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    def _timer(self):
        stop = super()._timer()
        if self._single:
            return stop

        def stop_all():  # every device of this process, then the first's clock
            self.sync()
            return stop()

        return stop_all

    # -- public API -----------------------------------------------------------

    def run(self, src, dst, mask, center, flags: int | None = None) -> torch.Tensor:
        """One clone; returns the (H, W, 3) u8 tensor on this process's first
        mesh device (async). On a larger mesh: the per-tile frame, then one
        gather of the destination (on every rank of a process-spanning
        mesh). The caller's ``dst`` is never modified there."""
        if self._single:
            return super().run(src, dst, mask, center, flags)
        with self._request_span():
            with span("engine.prepare"):
                flags, prep = self._prepared(src, dst, mask, center, flags)
            if prep is None:
                self._last_out = self._to_device(dst)
                return self._last_out
            frame = self._frame(src, dst, prep, flags)
            frame.step()
            out = self._track(frame.result(self.device))
            self._last_out = out
            return out

    def timed_serve(self, src, dst, mask, center, loops: int = 20, flags: int | None = None):
        """Steady-state serve: upload once, chain ``loops`` frames on the
        mesh-resident destination tiles, gather once. One warm-up frame runs
        outside the timed window. Returns ((H, W, 3) u8 tensor on the first
        device, mean ms per frame)."""
        if self._single:
            return super().timed_serve(src, dst, mask, center, loops, flags)
        with self._request_span():
            with span("engine.prepare"):
                flags, prep = self._prepared(src, dst, mask, center, flags)
            if prep is None:
                raise ValueError("empty mask, or a mask bbox without interior")
            frame = self._frame(src, dst, prep, flags)
            frame.step()  # warm-up: kernel build/load, allocator
            self.sync()
            before = GATHERS["calls"], CROSSED["bytes"], REPLICATED["bytes"]
            stop = self._timer()
            for _ in range(loops):
                frame.step()
            mean_ms = stop() / max(loops, 1)
            after = GATHERS["calls"], CROSSED["bytes"], REPLICATED["bytes"]
            for key, a, b in zip(("gathers", "crossed_bytes", "replicated_bytes"), before,
                                 after):
                self.metrics[f"{key}_per_frame"] = (b - a) / max(loops, 1)
            out = self._track(frame.result(self.device))
            self._last_out = out
            self.metrics["compute_ms"] = mean_ms
            self.metrics["device_memory_bytes"] = self.device_memory_bytes()
            return out, mean_ms


def seamless_clone_tiled(src, dst, mask, center, mesh: TileMesh | None = None, flags: int = 1,
                         tol: float = 1e-4, path: str = "dd", mg_cycles: int | None = None):
    """``seamless_clone`` with the pipeline decomposed over ``mesh``
    (default: every visible CUDA device, most-square). On any mesh, one
    device included, the stages run per tile and the solve is
    ``solve_poisson_dd`` (``path="dd"``) or ``solve_multigrid_sharded``
    (``path="gspmd"``) to ``tol``, or ``mg_cycles`` fixed cycles (the
    generic tail). Returns u8 HWC numpy (on every rank of a mesh that spans
    processes)."""
    engine = TiledSeamlessClone(CloneConfig(flags=flags, tol=tol, mg_cycles=mg_cycles),
                                mesh=mesh, path=path)
    engine._single = False  # the tiled pipeline on a 1x1 mesh too
    return engine.run(src, dst, mask, center).cpu().numpy()


def local_edit_tiled(src, mask, kind: str, params, edge_mask=None, mesh: TileMesh | None = None,
                     tol: float = 1e-5, path: str = "dd"):
    """Gradient-domain edit (``ops/edit.py``'s kinds) with the pipeline
    decomposed over ``mesh`` (default: every visible CUDA device).

    Per tile of the solve's tiling (``parallel/stages.py``), on the cell's
    device: ``erode3x3_replicate`` of the mask's window, ``edit_guidance``,
    the divergence and the image border's fold. Then over the mesh to
    ``tol`` ``solve_poisson_dd`` (``path="dd"``) or
    ``solve_multigrid_sharded`` (``path="gspmd"``) on the tiles, whose
    tiles' plain sweeps are the ``rb_sweeps_tile`` kernel, and
    ``clamp_cast_paste`` of each tile's interior into that cell's tile of a
    copy of the source: the image border stays the source's. src: (H, W,
    C) u8; mask: (H, W) or None (everything); params as ``edit_guidance``
    takes them; edge_mask: (H, W) u8 {0, 255} (the Canny map of
    ``texture_flattening``). Returns (H, W, C) u8 numpy (on every rank of a
    mesh that spans processes).
    """
    _check_path(path)
    mesh = mesh if mesh is not None else make_tile_mesh()
    src = np.asarray(src)
    h, w = src.shape[:2]
    if mask is None:
        mask = np.full((h, w), 255, np.uint8)
    m01 = (np.asarray(mask) != 0).astype(np.float32)
    edge = None if edge_mask is None else np.asarray(edge_mask, np.float32) / 255.0
    hw2 = (h - 2, w - 2)
    tiling, solve = _tile_solver(path, mesh, hw2, tol, None)
    frame = ResidentFrame(mesh, tiling, hw2, (0, 0), (h, w), solve)
    frame.upload_dest(src)
    frame.set_edit_inputs(src, m01, params, edge, kind)
    frame.step()
    return frame.result(mesh.distinct()[0]).cpu().numpy()
