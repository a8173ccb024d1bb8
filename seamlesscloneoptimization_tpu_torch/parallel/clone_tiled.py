"""Seamless clone with the Poisson solve decomposed over a tile mesh.

Port of ``seamlesscloneoptimization_tpu/parallel/clone_tiled.py``
(BASELINE config[4]: 8K panorama destinations). ``TiledSeamlessClone`` is
the serve engine (``core/engine.py:SeamlessClone``) over a ``TileMesh``;
``seamless_clone_tiled`` the one-shot function.

On a mesh of one device the engine IS the single-device engine, byte for
byte. On a larger mesh the pipeline's stages (ROI views, the RHS, the
paste) run on the mesh's first device and only the Poisson solve is
decomposed: ``solve_poisson_dd`` (``parallel/tiled.py``), where nearly all
the work is. The stages take the generic tail, as JAX's mesh gates
(``_pallas_gates``) send them: the plain RHS, the DD solve, the
``clamp_cast_paste`` kernel. Sharding the stages themselves over several
cards waits for a machine with several cards (ROADMAP §1 item 7, slice 8).

``bbox_bucket`` works as in the single-device engine: the grown bucket is
the DD solve's ROI; with ``bucket_exact`` the frame is ``clone_roi_dyn``
on the first device (the plain RHS, the runtime-domain multigrid, the
paste) to the config's ``tol``, or for ``mg_cycles`` cycles, up to
``max_cycles``. The JAX package's tiled engine drops those three on a real
mesh and solves to tol 1e-4; the port keeps them on purpose (ROADMAP §3).

``local_edit_tiled`` runs the gradient-domain edits (``ops/edit.py``) with
the same split: the RHS on the first device, the DD solve over the mesh,
the paste on the first device.

Not ported (NotImplementedError naming the ROADMAP item): ``path="gspmd"``
(torch has no SPMD partitioner; ``solve_multigrid_sharded`` needs a design
of its own).
"""

from __future__ import annotations

import torch

from seamlesscloneoptimization_tpu_torch.core.config import CloneConfig
from seamlesscloneoptimization_tpu_torch.core.engine import SeamlessClone
from seamlesscloneoptimization_tpu_torch.ops.edit import edit_guidance, edit_inputs
from seamlesscloneoptimization_tpu_torch.ops.kernels import clamp_cast_paste
from seamlesscloneoptimization_tpu_torch.ops.rhs import poisson_rhs
from seamlesscloneoptimization_tpu_torch.parallel.mesh import TileMesh, make_tile_mesh
from seamlesscloneoptimization_tpu_torch.parallel.tiled import solve_poisson_dd

DD_SOLVER_NAME = "multigrid_dd"


def _check_path(path: str) -> None:
    if path not in ("dd", "gspmd"):
        raise ValueError(f"path must be 'dd' or 'gspmd', got {path!r}")
    if path == "gspmd":
        raise NotImplementedError(
            "path='gspmd' (solve_multigrid_sharded) is not ported yet: torch has no SPMD "
            "partitioner; ROADMAP §1 item 7 (slice 8)")


def _dd_solver(mesh: TileMesh, tol: float | None, cycles: int | None,
               max_cycles: int = 60, eig_cache=None):
    """The pipeline's solver: ``solve_poisson_dd`` on ``mesh``, to ``tol`` or
    for ``cycles`` (4 when both are None, as in the JAX package)."""

    def solver(g: torch.Tensor) -> torch.Tensor:
        return solve_poisson_dd(g, mesh, tol=tol, cycles=cycles or 4, max_cycles=max_cycles,
                                eig_cache=eig_cache)

    return solver


class TiledSeamlessClone(SeamlessClone):
    """The serve engine (``run`` / ``sync`` / ``timed_serve``) with its
    Poisson solve decomposed over a ``TileMesh``.

        mesh = make_tile_mesh([torch.device("cuda")] * 4, (2, 2))  # one card
        engine = TiledSeamlessClone(CloneConfig(), mesh=mesh)
        out, ms = engine.timed_serve(src, dst, mask, center)

    A mesh of one device degenerates to ``SeamlessClone`` on that device.
    On a larger mesh the solve is the DD multigrid (``metrics
    ["solver_resolved"] == "multigrid_dd"``) to ``config.tol``, or for
    ``config.mg_cycles`` cycles, up to ``config.max_cycles``; the RHS and
    the paste run on the mesh's first device (module docstring). With
    ``bucket_exact`` the frame solves the tight system on the first device
    (``metrics["solver_resolved"] == "multigrid_dyn"``).
    """

    def __init__(self, config: CloneConfig | None = None, mesh: TileMesh | None = None,
                 path: str = "dd"):
        _check_path(path)
        self.mesh = mesh if mesh is not None else make_tile_mesh()
        self._single = self.mesh.size == 1
        super().__init__(config, device=self.mesh.devices[0][0])

    def _pipeline_kwargs(self, bbox_hw, flags: int, planar_dst: bool) -> dict:
        if self._single:
            return super()._pipeline_kwargs(bbox_hw, flags, planar_dst)
        if self._bucket_exact():  # the mesh's generic tail: the plain RHS
            return dict(super()._pipeline_kwargs(bbox_hw, flags, planar_dst),
                        use_pallas_pre=False)
        self.metrics["solver_resolved"] = DD_SOLVER_NAME
        cycles = self.config.mg_cycles
        solver = _dd_solver(self.mesh, None if cycles else self.config.tol, cycles,
                            self.config.max_cycles, self._eig_cache)
        return dict(bbox_hw=bbox_hw, flags=flags, solver=solver, solver_kwargs={},
                    mixed_rule=self.config.mixed_rule, bases=None, solver_name=DD_SOLVER_NAME,
                    use_pallas_pre=False, use_pallas_post=False)


def seamless_clone_tiled(src, dst, mask, center, mesh: TileMesh | None = None, flags: int = 1,
                         tol: float = 1e-4, path: str = "dd", mg_cycles: int | None = None):
    """``seamless_clone`` with the Poisson solve decomposed over ``mesh``
    (default: every visible CUDA device, most-square). On any mesh, one
    device included, the solve is ``solve_poisson_dd`` to ``tol``, or
    ``mg_cycles`` fixed cycles; the stages run on the mesh's first device
    (the generic tail). Returns u8 HWC numpy."""
    engine = TiledSeamlessClone(CloneConfig(flags=flags, tol=tol, mg_cycles=mg_cycles),
                                mesh=mesh, path=path)
    engine._single = False  # the DD solve on a 1x1 mesh too
    return engine.run(src, dst, mask, center).cpu().numpy()


def local_edit_tiled(src, mask, kind: str, params, edge_mask=None, mesh: TileMesh | None = None,
                     tol: float = 1e-5, path: str = "dd"):
    """Gradient-domain edit (``ops/edit.py``'s kinds) with the Poisson solve
    decomposed over ``mesh`` (default: every visible CUDA device).

    On the mesh's first device: ``erode3x3_replicate`` of the mask,
    ``edit_guidance``, ``poisson_rhs`` on the whole image. Then
    ``solve_poisson_dd`` over the mesh to ``tol`` (the tiles' sweeps are
    the ``rb_sweeps_tile`` kernel), and ``clamp_cast_paste`` of the
    interior into a copy of the source: the image border stays the
    source's. src: (H, W, C) u8; mask: (H, W) or None (everything);
    params as ``edit_guidance`` takes them; edge_mask: (H, W) u8 {0, 255}
    (the Canny map of ``texture_flattening``). Returns (H, W, C) u8 numpy.
    """
    _check_path(path)
    mesh = mesh if mesh is not None else make_tile_mesh()
    src_p, me, params_t, edge = edit_inputs(src, mask, params, edge_mask, mesh.devices[0][0])
    src_f = src_p.to(torch.float32)
    gx, gy = edit_guidance(src_f, me, params_t, edge, kind=kind)
    g = poisson_rhs(gx, gy, src_f)
    u = solve_poisson_dd(g, mesh, tol=tol)
    _, h2, w2 = g.shape
    out = clamp_cast_paste(u.contiguous(), src_p.clone(), 1, 1, h2, w2)
    return out.permute(1, 2, 0).cpu().numpy()
