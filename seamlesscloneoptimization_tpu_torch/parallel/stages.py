"""The tiled clone's stages, tile by tile, on a mesh-resident destination.

The counterpart of GSPMD's partitioning of ``clone_roi`` / ``clone_roi_dyn``
(JAX ``models/pipeline.py``) and of ``_local_edit_sharded`` under JAX's
``parallel/clone_tiled.py`` shardings. JAX's mesh gates (``_pallas_gates``)
turn the Pallas RHS off on a real mesh, so each tile's RHS is the plain one
(``erode3x3`` x3, ``guidance_field`` and ``poisson_rhs`` folding the
Dirichlet values only on the sides where the tile meets the ROI's frame, or
the edits' ``erode3x3_replicate`` and ``edit_guidance``), in torch ops on
the tile's window; the paste is the
``clamp_cast_paste`` kernel, one launch per tile into the destination tile
that its device holds. Every term is local to a point, so each tile's RHS
is bit-equal to the whole RHS's window.

Geometry (``ResidentFrame``). The solve's own tiling of the interior
(``parallel/tiled.py``: ``dd_tiling`` or ``sharded_tiling`` of (h - 2, w -
2)) sets every split, so that a tile of g is born on the device that solves
it: tile (iy, ix) computes g on its box clipped to the true interior (the
DD tiling's cells past it are zero). The destination is split at the same
boundaries moved out by the ROI's offset (interior row r is destination row
top + 1 + r), the first and last tiles running to the image's edges, so
each solve tile lies inside one destination tile.

Rings, from ``ops/rhs.py``, ``ops/guidance.py`` and ``ops/mask.py``. g at
ROI pixel (p, q) reads gx at (p, q - 1), (p, q) and gy at (p - 1, q), (p, q)
(the divergence's backward differences) and the destination at the ROI's
frame (the fold); gx(p, q) reads the destination and the patch at (p, q),
(p, q + 1) and the eroded mask at (p, q), gy(p, q) at (p, q), (p + 1, q)
(the forward differences). So the destination and the patch take a ring of
``DEST_RING`` = 1 pixel around the tile's ROI pixels, which never leaves the
ROI, and the eroded mask one too; each of the three 3x3 erosions reads one
more ring, so the mask takes ``MASK_RING`` = 4, zero past the ROI (the
erosion's zero border) or, for the edits, set past the image (the
replicate border, held set at every erosion). The destination's ring comes
from the neighbouring tiles each frame (``transport.windows``); the patch
and mask windows are uploaded once from the host.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from seamlesscloneoptimization_tpu_torch.ops.edit import edit_guidance, erode3x3_replicate_window
from seamlesscloneoptimization_tpu_torch.ops.guidance import guidance_field
from seamlesscloneoptimization_tpu_torch.ops.kernels import clamp_cast_paste
from seamlesscloneoptimization_tpu_torch.ops.mask import binarize_mask, erode3x3
from seamlesscloneoptimization_tpu_torch.ops.rhs import poisson_rhs
from seamlesscloneoptimization_tpu_torch.parallel import transport
from seamlesscloneoptimization_tpu_torch.parallel.mesh import TileMesh
from seamlesscloneoptimization_tpu_torch.parallel.tiled import Tiling
from seamlesscloneoptimization_tpu_torch.parallel.transport import map_local, windows

DEST_RING = 1  # forward differences, then the divergence's backward ones
ERODE_ITERS = 3
MASK_RING = DEST_RING + ERODE_ITERS


def clone_tile_rhs(dest_w: torch.Tensor, patch_w: torch.Tensor, mask_w: torch.Tensor, folds,
                   flags: int, mixed_rule: str) -> torch.Tensor:
    """A tile's plain clone RHS (``models/pipeline.py:_plain_rhs`` on its
    window): dest_w, patch_w (C, hb + 2, wb + 2) u8, mask_w (hb + 8, wb + 8)
    u8, zero past the ROI. Returns (C, hb, wb) f32."""
    r = ERODE_ITERS
    me = erode3x3(binarize_mask(mask_w), ERODE_ITERS)[r:-r, r:-r]
    dest_f = dest_w.to(torch.float32)
    gx, gy = guidance_field(dest_f, patch_w.to(torch.float32), me, flags, mixed_rule)
    return poisson_rhs(gx, gy, dest_f, folds)


def edit_tile_rhs(src_w: torch.Tensor, m01_w: torch.Tensor, inside_w: torch.Tensor, params,
                  edge_w, folds, kind: str) -> torch.Tensor:
    """A tile's edit RHS (``local_edit_tiled``'s on its window): src_w (C,
    hb + 2, wb + 2) u8, m01_w / inside_w (hb + 8, wb + 8) f32 / bool (the
    mask, set past the image; which cells lie in it), edge_w (hb + 2, wb +
    2) f32 or None. Returns (C, hb, wb) f32."""
    r = ERODE_ITERS
    me = erode3x3_replicate_window(m01_w, inside_w, ERODE_ITERS)[r:-r, r:-r]
    src_f = src_w.to(torch.float32)
    gx, gy = edit_guidance(src_f, me, params, edge_w, kind=kind)
    return poisson_rhs(gx, gy, src_f, folds)


def host_window(a: np.ndarray, r0: int, r1: int, c0: int, c1: int, fill=0) -> np.ndarray:
    """a[r0:r1, c0:c1] (any trailing axes), ``fill`` where it leaves a."""
    out = np.full((r1 - r0, c1 - c0) + a.shape[2:], fill, a.dtype)
    h, w = a.shape[:2]
    y0, y1, x0, x1 = max(r0, 0), min(r1, h), max(c0, 0), min(c1, w)
    if y0 < y1 and x0 < x1:
        out[y0 - r0 : y1 - r0, x0 - c0 : x1 - c0] = a[y0:y1, x0:x1]
    return out


def _split_at(bounds, offset: int, n: int) -> tuple[int, ...]:
    """The destination's boundaries along an axis of length n: the solve
    tiling's inner ones moved by ``offset``, the outer ones at 0 and n."""
    inner = [min(max(b + offset, 0), n) for b in bounds[1:-1]]
    return (0, *inner, n)


class ResidentFrame:
    """One clone's geometry on a mesh, and its mesh-resident state.

    ``tiling``: the solve's tiling of the interior (hw2 = (h - 2, w - 2)),
    ``roi_at``: the destination's (top, left) of ROI pixel (0, 0);
    ``dst_hw``: the destination's (H, W). ``solve(g_tiles) -> u_tiles`` on
    the tiling. Holds this process's destination tiles (``dest``, planar
    (C, rows, cols) u8 on each cell's device) and each cell's inputs; a
    frame (``step``) exchanges the destination's rings, computes each
    tile's RHS, solves and pastes into the destination tiles. ``result``
    gathers the whole destination once."""

    def __init__(self, mesh: TileMesh, tiling: Tiling, hw2, roi_at, dst_hw, solve, track=None):
        self.mesh, self.tiling, self.solve = mesh, tiling, solve
        self.h2, self.w2 = hw2
        self.top, self.left = roi_at
        self.dst_hw = tuple(dst_hw)
        self.dtiling = Tiling(_split_at(tiling.rows, self.top + 1, self.dst_hw[0]),
                              _split_at(tiling.cols, self.left + 1, self.dst_hw[1]))
        self.track = track or (lambda x: x)
        self.dest = None
        self.inputs = None
        self.rhs = None
        self.reads_dest = True  # the clone's RHS reads the destination's ring

    # -- geometry -------------------------------------------------------------

    def box(self, iy: int, ix: int) -> tuple[int, int, int, int]:
        """The cell's g box clipped to the true interior (may be empty)."""
        r0, r1, c0, c1 = self.tiling.box(iy, ix)
        return r0, min(r1, self.h2), c0, min(c1, self.w2)

    def has_box(self, iy: int, ix: int) -> bool:
        r0, r1, c0, c1 = self.box(iy, ix)
        return r0 < r1 and c0 < c1

    def folds(self, iy: int, ix: int):
        r0, r1, c0, c1 = self.box(iy, ix)
        return r0 == 0, r1 == self.h2, c0 == 0, c1 == self.w2

    def roi_window(self, iy: int, ix: int, ring: int) -> tuple[int, int, int, int]:
        """The cell's ROI pixels with a ring, in ROI coordinates."""
        r0, r1, c0, c1 = self.box(iy, ix)
        return r0 + 1 - ring, r1 + 1 + ring, c0 + 1 - ring, c1 + 1 + ring

    def _dest_want(self, iy: int, ix: int):
        if not self.has_box(iy, ix):
            return (0, 0, 0, 0)
        r0, r1, c0, c1 = self.roi_window(iy, ix, DEST_RING)
        return self.top + r0, self.top + r1, self.left + c0, self.left + c1

    def cells(self):
        return self.mesh.local_cells()

    def device(self, iy: int, ix: int) -> torch.device:
        return self.mesh.devices[iy][ix]

    # -- inputs ---------------------------------------------------------------

    def upload_dest(self, dst) -> None:
        """This process's destination tiles from the whole (H, W, C) u8
        ``dst`` (host numpy, or a tensor whose tiles are copied from where it
        lies): each uploaded as it lies, then made planar on its device."""
        def tile(iy, ix, _):
            r0, r1, c0, c1 = self.dtiling.box(iy, ix)
            part = dst[r0:r1, c0:c1]
            part = (torch.from_numpy(np.ascontiguousarray(part)) if isinstance(part, np.ndarray)
                    else part)
            return self.track(part.to(self.device(iy, ix), copy=True).permute(2, 0, 1)
                              .contiguous())

        ty, tx = self.mesh.shape
        self.dest = map_local(self.mesh, tile, [[None] * tx for _ in range(ty)])

    def set_clone_inputs(self, src_roi: np.ndarray, mask_roi: np.ndarray, flags: int,
                         mixed_rule: str) -> None:
        """Each cell's patch window (DEST_RING) and mask window (MASK_RING)
        from the host ROI: src_roi (h, w, C) u8, mask_roi (h, w) u8 as the
        pipeline prepares it (binarized, the frame rule applied)."""
        patch = np.where(mask_roi[..., None] != 0, src_roi, 0).astype(np.uint8)

        def cell(iy, ix, _):
            if not self.has_box(iy, ix):
                return None
            dev = self.device(iy, ix)
            pw = host_window(patch, *self.roi_window(iy, ix, DEST_RING))
            mw = host_window(mask_roi, *self.roi_window(iy, ix, MASK_RING))
            return (self.track(torch.from_numpy(np.ascontiguousarray(pw.transpose(2, 0, 1)))
                               .to(dev)),
                    self.track(torch.from_numpy(mw).to(dev)))

        ty, tx = self.mesh.shape
        self.inputs = map_local(self.mesh, cell, [[None] * tx for _ in range(ty)])

        def rhs(iy, ix, dest_w, inp):
            return clone_tile_rhs(dest_w, inp[0], inp[1], self.folds(iy, ix), flags, mixed_rule)

        self.rhs = rhs

    def set_edit_inputs(self, src: np.ndarray, m01: np.ndarray, params, edge, kind: str):
        """Each cell's windows of an edit's host inputs: src (H, W, C) u8 as
        the DEST_RING window of the image the edit writes into, the mask
        m01 (H, W) f32 {0, 1} (set past the image) and which cells lie in
        the image (MASK_RING), the edge mask (H, W) f32 or None
        (DEST_RING); ``params`` a host array."""
        inside = np.ones(m01.shape, bool)

        def cell(iy, ix, _):
            if not self.has_box(iy, ix):
                return None
            dev = self.device(iy, ix)
            win1, win4 = self.roi_window(iy, ix, DEST_RING), self.roi_window(iy, ix, MASK_RING)
            sw = host_window(src, *win1)
            out = [torch.from_numpy(np.ascontiguousarray(sw.transpose(2, 0, 1))).to(dev),
                   torch.from_numpy(host_window(m01, *win4, fill=1.0)).to(dev),
                   torch.from_numpy(host_window(inside, *win4, fill=False)).to(dev),
                   torch.as_tensor(np.asarray(params, np.float32), device=dev),
                   None if edge is None else torch.from_numpy(host_window(edge, *win1)).to(dev)]
            return tuple(self.track(t) if t is not None else None for t in out)

        ty, tx = self.mesh.shape
        self.inputs = map_local(self.mesh, cell, [[None] * tx for _ in range(ty)])
        self.reads_dest = False

        def rhs(iy, ix, _dest_w, inp):
            return edit_tile_rhs(inp[0], inp[1], inp[2], inp[3], inp[4], self.folds(iy, ix),
                                 kind)

        self.rhs = rhs

    def resident_bytes(self) -> dict:
        """{"iy,ix": bytes} of each local cell's destination tile and inputs."""
        out = {}
        for iy, ix in self.cells():
            ts = [self.dest[iy][ix], *(self.inputs[iy][ix] or ())]
            out[f"{iy},{ix}"] = sum(t.numel() * t.element_size() for t in ts if t is not None)
        return out

    # -- a frame --------------------------------------------------------------

    def g_tiles(self):
        """Each local cell's tile of g on its device, the tiling's shape."""
        ty, tx = self.mesh.shape
        dwin = (windows(self.dest, self.dtiling.rows, self.dtiling.cols, self._dest_want,
                        self.mesh) if self.reads_dest else [[None] * tx for _ in range(ty)])
        c = next(t for row in self.dest for t in row if t is not None).shape[0]

        def tile(iy, ix, dest_w, inp):
            t0, t1, s0, s1 = self.tiling.box(iy, ix)
            if inp is None:
                return torch.zeros((c, t1 - t0, s1 - s0), dtype=torch.float32,
                                   device=self.device(iy, ix))
            g = self.rhs(iy, ix, dest_w, inp)
            return F.pad(g, (0, s1 - s0 - g.shape[2], 0, t1 - t0 - g.shape[1]))

        return map_local(self.mesh, tile, dwin, self.inputs)

    def paste(self, u_tiles) -> None:
        """``clamp_cast_paste`` of each local cell's true interior into its
        destination tile: one launch a tile."""
        for iy, ix in self.cells():
            if not self.has_box(iy, ix):
                continue
            r0, r1, c0, c1 = self.box(iy, ix)
            d0, _, e0, _ = self.dtiling.box(iy, ix)
            clamp_cast_paste(u_tiles[iy][ix].contiguous(), self.dest[iy][ix],
                             self.top + 1 + r0 - d0, self.left + 1 + c0 - e0, r1 - r0, c1 - c0)

    def step(self) -> None:
        """One frame: the RHS tiles, the solve, the paste."""
        self.paste(self.solve(self.g_tiles()))

    def result(self, device) -> torch.Tensor:
        """The whole (H, W, C) u8 destination on ``device``: one gather (on
        a mesh that spans processes, every rank gets it)."""
        c = next(t for row in self.dest for t in row if t is not None).shape[0]
        whole = transport.gather(self.dest, device, self.mesh, self.dtiling.shape_of(c))
        return whole.permute(1, 2, 0).contiguous()
