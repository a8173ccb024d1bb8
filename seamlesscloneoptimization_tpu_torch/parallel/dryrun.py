"""The multi-device dry run: one step of each distributed program on a mesh.

Port of ``__graft_entry__.py:dryrun_multichip``'s eight sub-checks, with
the same geometry (sized by the mesh's (ty, tx)) and the same bars, on the
port's ``TileMesh``:

1. ``solve_redblack_tiled`` at halos 2 and 8, and 8 with ``overlap=True``
   (bit-equal to halo 8; the 16 x 16 tiles are not above 4 (halo // 2),
   so this is the plain round, as in JAX); each, and
   ``solve_multigrid_sharded``, within 1e-3 of the exact DST-GEMM solve;
   the interior-first schedule itself at halo 4, 100 sweeps at tol 0,
   bit-equal to the plain schedule.
2. ``solve_multigrid_sharded`` on a grid deep enough for 4 levels
   (384 x 768, rounded up to the mesh), relative residual < 2e-3.
3. ``clone_roi_batch`` with its 2 x size jobs split over the mesh
   (``mesh=``): bit-equal to the call without a mesh, job 0 within 1 of a
   single ``clone_roi``.
4. ``solve_multigrid_dyn_sharded``: 150 x 300 inside 192 x 384 (rounded up
   to the mesh), 6 cycles: relative residual < 1e-3, zeros outside the true
   domain, bit-equal to the single-device ``solve_multigrid_dyn``.
5. ``seamless_clone_tiled`` end to end: the destination changed.
6. ``solve_multigrid_dd`` for 8 cycles within 1e-3 of the exact solve; the
   tolerance contract of ``solve_poisson_dd`` at a size the mesh does not
   divide (1 % slack, as JAX's); ``local_edit_tiled`` runs.
7. The quartered serve path on the first device: ``to_quarters`` ->
   ``solve_multigrid(padded="q", use_pallas=True)`` -> ``from_quarters``,
   relative residual < 1e-3.
8. ``TiledSeamlessClone`` chaining two frames on the mesh against the
   single-device engine's multigrid: diff_max <= 2.

``dryrun_multichip(mesh)`` returns the measured figures; a sub-check that
misses its bar raises AssertionError naming it.
"""

from __future__ import annotations

import numpy as np
import torch

from seamlesscloneoptimization_tpu_torch.core.config import CloneConfig
from seamlesscloneoptimization_tpu_torch.core.engine import SeamlessClone
from seamlesscloneoptimization_tpu_torch.models.pipeline import clone_roi
from seamlesscloneoptimization_tpu_torch.ops import kernels as K
from seamlesscloneoptimization_tpu_torch.parallel.batch import clone_roi_batch
from seamlesscloneoptimization_tpu_torch.parallel.clone_tiled import (
    TiledSeamlessClone,
    local_edit_tiled,
    seamless_clone_tiled,
)
from seamlesscloneoptimization_tpu_torch.parallel.mesh import TileMesh
from seamlesscloneoptimization_tpu_torch.parallel.tiled import (
    solve_multigrid_dd,
    solve_multigrid_dyn_sharded,
    solve_multigrid_sharded,
    solve_poisson_dd,
    solve_redblack_tiled,
)
from seamlesscloneoptimization_tpu_torch.solvers.dst_gemm import solve_dst_gemm
from seamlesscloneoptimization_tpu_torch.solvers.jacobi import residual
from seamlesscloneoptimization_tpu_torch.solvers.multigrid import solve_multigrid
from seamlesscloneoptimization_tpu_torch.solvers.multigrid_dyn import solve_multigrid_dyn


def _check(ok: bool, which: int, what: str) -> None:
    if not ok:
        raise AssertionError(f"dryrun_multichip sub-check {which}: {what}")


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max() / b.abs().max())


def _rel_residual(u: torch.Tensor, g: torch.Tensor) -> float:
    return float(residual(u, g).abs().max() / g.abs().max())


def _up(n: int, t: int) -> int:
    return (n + t - 1) // t * t


def dryrun_multichip(mesh: TileMesh) -> dict:
    """Run the eight sub-checks on ``mesh`` (module docstring); returns
    {"mesh": [ty, tx], "1": {...}, ..., "8": {...}} of measured figures."""
    ty, tx = mesh.shape
    dev = mesh.distinct()[0]
    rng = np.random.default_rng(0)
    rng2 = np.random.default_rng(1)
    out = {"mesh": [ty, tx]}

    def normal(shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32) * 10).to(dev)

    def u8(shape):
        return rng2.integers(0, 256, shape, dtype=np.uint8)

    # 1. tiled red-black: halo widths, the overlap schedule, agreement
    g = normal((3, 16 * ty, 16 * tx))
    rb2 = solve_redblack_tiled(g, mesh, tol=1e-5, max_iters=40000, halo=2)
    rb8 = solve_redblack_tiled(g, mesh, tol=1e-5, max_iters=40000, halo=8)
    rb8o = solve_redblack_tiled(g, mesh, tol=1e-5, max_iters=40000, halo=8, overlap=True)
    _check(torch.equal(rb8o, rb8), 1, "the overlap schedule diverged (must be bit-equal)")
    fixed = dict(tol=0.0, max_iters=100, halo=4)
    _check(torch.equal(solve_redblack_tiled(g, mesh, overlap=True, **fixed),
                       solve_redblack_tiled(g, mesh, **fixed)), 1,
           "the interior-first schedule diverged at halo 4 (must be bit-equal)")
    mg_small = solve_multigrid_sharded(g, mesh, tol=1e-5, max_cycles=30)
    exact = solve_dst_gemm(g)
    rels = {name: _rel(u, exact) for name, u in (("rb_halo2", rb2), ("rb_halo8", rb8),
                                                 ("sharded_mg", mg_small))}
    for name, rel in rels.items():
        _check(rel < 1e-3, 1, f"{name} vs exact rel {rel}")
    out["1"] = {"rel_vs_exact": rels, "overlap_bit_equal": True}

    # 2. the partitioned V-cycle on a grid deep enough for 4 levels
    h2, w2 = _up(384, ty), _up(768, tx)
    g4 = normal((3, h2, w2))
    mg4 = solve_multigrid_sharded(g4, mesh, tol=1e-3, max_cycles=20)
    r4 = _rel_residual(mg4, g4)
    _check(r4 < 2e-3, 2, f"deep sharded-mg residual {r4}")
    out["2"] = {"hw": [h2, w2], "rel_residual": r4}

    # 3. the batch's jobs split over the mesh
    n_jobs, bhw = 2 * mesh.size, 34
    dests = torch.from_numpy(u8((n_jobs, 3, bhw, bhw))).to(dev)
    patches = torch.from_numpy(u8((n_jobs, 3, bhw, bhw))).to(dev)
    masks = torch.full((n_jobs, bhw, bhw), 255, dtype=torch.uint8, device=dev)
    bout = clone_roi_batch(dests, patches, masks, 1, solve_dst_gemm, mesh=mesh)
    same = torch.equal(bout, clone_roi_batch(dests, patches, masks, 1, solve_dst_gemm))
    _check(same, 3, "the batch over the mesh differs from the batch on one device")
    one = clone_roi(dests[0], patches[0], masks[0], 1, solve_dst_gemm)
    bdiff = int((bout[0].int() - one.int()).abs().max())
    _check(bdiff <= 1, 3, f"sharded batch vs single-job diff {bdiff}")
    out["3"] = {"jobs": n_jobs, "bit_equal_unsplit": same, "diff_vs_single_job": bdiff}

    # 4. bucket_exact's runtime-domain solve, partitioned
    hp, wp, ht, wt = _up(192, ty), _up(384, tx), 150, 300
    gd = torch.zeros((3, hp, wp), device=dev)
    gd[:, :ht, :wt] = normal((3, ht, wt))
    ud = solve_multigrid_dyn_sharded(gd, (ht, wt), mesh, cycles=6)
    rd = _rel_residual(ud[:, :ht, :wt], gd[:, :ht, :wt])
    _check(rd < 1e-3, 4, f"sharded dyn (bucket_exact) residual {rd}")
    _check(not ud[:, ht:, :].any() and not ud[:, :, wt:].any(), 4,
           "nonzero outside the true domain")
    same_d = torch.equal(ud, solve_multigrid_dyn(gd, (ht, wt), cycles=6, use_pallas=False))
    _check(same_d, 4, "not bit-equal to the single-device solve_multigrid_dyn")
    out["4"] = {"true_hw": [ht, wt], "padded_hw": [hp, wp], "rel_residual": rd,
                "bit_equal_single_device": same_d}

    # 5. the tiled clone end to end
    hs, ws, hd, wd = 8 * ty, 8 * tx, 24 * ty, 24 * tx
    src, dst = u8((hs, ws, 3)), u8((hd, wd, 3))
    mask = np.zeros((hs, ws), np.uint8)
    mask[2:-2, 2:-2] = 255
    res = seamless_clone_tiled(src, dst, mask, (wd // 2, hd // 2), mesh=mesh, tol=1e-3)
    _check(res.shape == dst.shape and res.dtype == np.uint8, 5, f"result {res.shape}")
    _check(not np.array_equal(res, dst), 5, "the clone did not change the destination")
    out["5"] = {"src_hw": [hs, ws], "dst_hw": [hd, wd], "changed": True}

    # 6. the DD multigrid: fixed cycles vs exact, the tolerance contract at a
    # size the mesh does not divide, an edit on the same mesh
    hdd, wdd = 16 * ty, 16 * tx
    gdd = normal((3, hdd, wdd))
    rel_dd = _rel(solve_multigrid_dd(gdd, mesh, cycles=8), solve_dst_gemm(gdd))
    _check(rel_dd < 1e-3, 6, f"DD multigrid vs exact rel {rel_dd}")
    godd = normal((3, hdd + 3, wdd + 5))
    tol_dd = 1e-4
    r_tol = _rel_residual(solve_poisson_dd(godd, mesh, tol=tol_dd), godd)
    # 1% slack: the in-loop check and this re-check associate the same sums
    # differently
    _check(r_tol <= tol_dd * 1.01, 6, f"DD tol contract violated: {r_tol} > {tol_dd}")
    eimg = u8((hdd, wdd, 3))
    emask = np.zeros((hdd, wdd), np.uint8)
    emask[4:-4, 4:-4] = 255
    eout = local_edit_tiled(eimg, emask, "color_change", [1.3, 1.0, 0.8], mesh=mesh, tol=1e-4)
    _check(eout.shape == eimg.shape and eout.dtype == np.uint8, 6, f"edit {eout.shape}")
    out["6"] = {"dd_rel_vs_exact": rel_dd, "tol_hw": [hdd + 3, wdd + 5],
                "tol_rel_residual": r_tol}

    # 7. the quartered serve path on the first device
    hq7, wq7 = 511, 517
    g7 = normal((1, hq7, wq7))
    _, hqq, wqq2, _ = K.mg_geometry_q(hq7, wq7)
    g7p = torch.zeros((1, 2 * hqq, 2 * wqq2), device=dev)
    g7p[:, :hq7, :wq7] = g7
    uq7 = solve_multigrid(K.to_quarters(g7p), cycles=4, use_pallas=True, padded="q",
                          true_hw=(hq7, wq7), padded_output="quarters")
    _check(uq7.dim() == 4, 7, f"quarters {tuple(uq7.shape)}")
    r7 = _rel_residual(K.from_quarters(uq7)[:, :hq7, :wq7], g7)
    _check(r7 < 1e-3, 7, f"quartered serve path residual {r7}")
    out["7"] = {"hw": [hq7, wq7], "rel_residual": r7}

    # 8. the mesh-resident engine: two chained frames against one device
    hs8, ws8, hd8, wd8 = 10 * ty, 10 * tx, 20 * ty, 20 * tx
    src8, dst8 = u8((hs8, ws8, 3)), u8((hd8, wd8, 3))
    mask8 = np.zeros((hs8, ws8), np.uint8)
    mask8[2:-2, 2:-2] = 255
    center8 = (wd8 // 2, hd8 // 2)
    tse = TiledSeamlessClone(CloneConfig(tol=1e-7), mesh=mesh)
    f2 = tse.run(src8, tse.run(src8, dst8, mask8, center8), mask8, center8)
    tse.sync()
    sref = SeamlessClone(CloneConfig(solver="multigrid", tol=1e-7), device=dev)
    r2 = sref.run(src8, sref.run(src8, dst8, mask8, center8), mask8, center8)
    d8 = int((f2.cpu().int() - r2.cpu().int()).abs().max())
    _check(d8 <= 2, 8, f"chained mesh serve vs single-device diff {d8}")
    out["8"] = {"diff_max_vs_single_device": d8}
    return out
