"""Seamless clone with the Poisson solve decomposed over a tile mesh.

Port of ``seamlesscloneoptimization_tpu/parallel/clone_tiled.py``
(BASELINE config[4]: 8K panorama destinations). ``TiledSeamlessClone`` is
the serve engine (``core/engine.py:SeamlessClone``) over a ``TileMesh``;
``seamless_clone_tiled`` the one-shot function.

On a mesh of one device the engine IS the single-device engine, byte for
byte. On a larger mesh the pipeline's stages (ROI views, the RHS, the
paste) run on the mesh's first device and only the Poisson solve is
decomposed, where nearly all the work is. ``path`` picks the solve:
``"dd"`` (the default) ``solve_poisson_dd``, the domain-decomposed
multigrid with its communication-avoiding tiles and a replicated coarse
solve; ``"gspmd"`` ``solve_multigrid_sharded``, the element V-cycle with
every level partitioned over the mesh (JAX's XLA-partitioned path, bit-equal
to the single-device element solve; ``parallel/tiled.py``). The stages take
the generic tail, as JAX's mesh gates (``_pallas_gates``) send them: the
plain RHS, the decomposed solve, the ``clamp_cast_paste`` kernel. Both
paths honour ``mg_cycles`` and ``max_cycles``; JAX's ``"gspmd"`` solver
takes ``tol`` only (ROADMAP §3).

``bbox_bucket`` works as in the single-device engine: the grown bucket is
the decomposed solve's ROI; with ``bucket_exact`` the frame is
``clone_roi_dyn`` on the first device (the plain RHS, the runtime-domain
multigrid, the paste) to the config's ``tol``, or for ``mg_cycles``
cycles, up to ``max_cycles``. The JAX package's tiled engine drops those
three on a real mesh and solves to tol 1e-4; the port keeps them on purpose
(ROADMAP §3).

``local_edit_tiled`` runs the gradient-domain edits (``ops/edit.py``) with
the same split: the RHS on the first device, the decomposed solve over the
mesh, the paste on the first device.

The engine and the one-shot functions run in one process: a mesh that
spans processes (``init_distributed``) raises NotImplementedError naming
ROADMAP §1 item 7; the solvers themselves take one.
"""

from __future__ import annotations

import torch

from seamlesscloneoptimization_tpu_torch.core.config import CloneConfig
from seamlesscloneoptimization_tpu_torch.core.engine import SeamlessClone
from seamlesscloneoptimization_tpu_torch.ops.edit import edit_guidance, edit_inputs
from seamlesscloneoptimization_tpu_torch.ops.kernels import clamp_cast_paste
from seamlesscloneoptimization_tpu_torch.ops.rhs import poisson_rhs
from seamlesscloneoptimization_tpu_torch.parallel.mesh import TileMesh, make_tile_mesh
from seamlesscloneoptimization_tpu_torch.parallel.tiled import (
    solve_multigrid_sharded,
    solve_poisson_dd,
)

DD_SOLVER_NAME = "multigrid_dd"
GSPMD_SOLVER_NAME = "multigrid_gspmd"


def _check_path(path: str) -> None:
    if path not in ("dd", "gspmd"):
        raise ValueError(f"path must be 'dd' or 'gspmd', got {path!r}")


def _check_one_process(mesh: TileMesh) -> None:
    if mesh.spans_processes:
        raise NotImplementedError(
            "the tiled engine and the one-shot functions run in one process; a mesh that "
            "spans processes is for the solvers only (ROADMAP §1 item 7)")


def _dd_solver(mesh: TileMesh, tol: float | None, cycles: int | None,
               max_cycles: int = 60, eig_cache=None):
    """The pipeline's solver: ``solve_poisson_dd`` on ``mesh``, to ``tol`` or
    for ``cycles`` (4 when both are None, as in the JAX package)."""

    def solver(g: torch.Tensor) -> torch.Tensor:
        return solve_poisson_dd(g, mesh, tol=tol, cycles=cycles or 4, max_cycles=max_cycles,
                                eig_cache=eig_cache)

    return solver


def _solver(path: str, mesh: TileMesh, tol: float, cycles: int | None, max_cycles: int = 60,
            eig_cache=None):
    """The pipeline's solver for ``path``: ``_dd_solver``'s, or for
    ``"gspmd"`` (JAX's ``_gspmd_solver``) ``solve_multigrid_sharded`` on
    ``mesh`` to ``tol``, or for ``cycles`` when given."""
    if path == "dd":
        return _dd_solver(mesh, None if cycles else tol, cycles, max_cycles, eig_cache)

    def solver(g: torch.Tensor) -> torch.Tensor:
        return solve_multigrid_sharded(g, mesh, tol=tol, max_cycles=max_cycles, cycles=cycles,
                                       eig_cache=eig_cache)

    return solver


class TiledSeamlessClone(SeamlessClone):
    """The serve engine (``run`` / ``sync`` / ``timed_serve``) with its
    Poisson solve decomposed over a ``TileMesh``.

        mesh = make_tile_mesh([torch.device("cuda")] * 4, (2, 2))  # one card
        engine = TiledSeamlessClone(CloneConfig(), mesh=mesh)
        out, ms = engine.timed_serve(src, dst, mask, center)

    A mesh of one device degenerates to ``SeamlessClone`` on that device.
    On a larger mesh the solve is the DD multigrid (``path="dd"``,
    ``metrics["solver_resolved"] == "multigrid_dd"``) or the partitioned
    element V-cycle (``path="gspmd"``, ``"multigrid_gspmd"``) to
    ``config.tol``, or for ``config.mg_cycles`` cycles, up to
    ``config.max_cycles``; the RHS and the paste run on the mesh's first
    device (module docstring). With ``bucket_exact`` the frame solves the
    tight system on the first device (``metrics["solver_resolved"] ==
    "multigrid_dyn"``).
    """

    def __init__(self, config: CloneConfig | None = None, mesh: TileMesh | None = None,
                 path: str = "dd"):
        _check_path(path)
        self.mesh = mesh if mesh is not None else make_tile_mesh()
        _check_one_process(self.mesh)
        self.path = path
        self._single = self.mesh.size == 1
        super().__init__(config, device=self.mesh.devices[0][0])

    def _pipeline_kwargs(self, bbox_hw, flags: int, planar_dst: bool) -> dict:
        if self._single:
            return super()._pipeline_kwargs(bbox_hw, flags, planar_dst)
        if self._bucket_exact():  # the mesh's generic tail: the plain RHS
            return dict(super()._pipeline_kwargs(bbox_hw, flags, planar_dst),
                        use_pallas_pre=False)
        name = GSPMD_SOLVER_NAME if self.path == "gspmd" else DD_SOLVER_NAME
        self.metrics["solver_resolved"] = name
        solver = _solver(self.path, self.mesh, self.config.tol, self.config.mg_cycles,
                         self.config.max_cycles, self._eig_cache)
        return dict(bbox_hw=bbox_hw, flags=flags, solver=solver, solver_kwargs={},
                    mixed_rule=self.config.mixed_rule, bases=None, solver_name=name,
                    use_pallas_pre=False, use_pallas_post=False)


def seamless_clone_tiled(src, dst, mask, center, mesh: TileMesh | None = None, flags: int = 1,
                         tol: float = 1e-4, path: str = "dd", mg_cycles: int | None = None):
    """``seamless_clone`` with the Poisson solve decomposed over ``mesh``
    (default: every visible CUDA device, most-square). On any mesh, one
    device included, the solve is ``solve_poisson_dd`` (``path="dd"``) or
    ``solve_multigrid_sharded`` (``path="gspmd"``) to ``tol``, or
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
    ``edit_guidance``, ``poisson_rhs`` on the whole image. Then over the
    mesh to ``tol`` ``solve_poisson_dd`` (``path="dd"``) or
    ``solve_multigrid_sharded`` (``path="gspmd"``), whose tiles' plain
    sweeps are the ``rb_sweeps_tile`` kernel, and ``clamp_cast_paste`` of the
    interior into a copy of the source: the image border stays the
    source's. src: (H, W, C) u8; mask: (H, W) or None (everything);
    params as ``edit_guidance`` takes them; edge_mask: (H, W) u8 {0, 255}
    (the Canny map of ``texture_flattening``). Returns (H, W, C) u8 numpy.
    """
    _check_path(path)
    mesh = mesh if mesh is not None else make_tile_mesh()
    _check_one_process(mesh)
    src_p, me, params_t, edge = edit_inputs(src, mask, params, edge_mask, mesh.devices[0][0])
    src_f = src_p.to(torch.float32)
    gx, gy = edit_guidance(src_f, me, params_t, edge, kind=kind)
    g = poisson_rhs(gx, gy, src_f)
    u = _solver(path, mesh, tol, None)(g)
    _, h2, w2 = g.shape
    out = clamp_cast_paste(u.contiguous(), src_p.clone(), 1, 1, h2, w2)
    return out.permute(1, 2, 0).cpu().numpy()
