"""Slice 8b's mesh-resident tiled pipeline on the CPU: ``TiledSeamlessClone``,
``seamless_clone_tiled`` and ``local_edit_tiled`` with their stages per tile
(``parallel/stages.py``) and the destination held as tiles.

- Against JAX's tiled engine / one-shot function / edits on a JAX mesh of
  the same shape (2x2, 2x4, and the uneven 1x3 / 3x1; the 8 virtual CPU
  devices of ``tests/conftest.py``): within 1 grey level, paths ``"dd"``
  and ``"gspmd"``, NORMAL / MIXED / MONOCHROME; two chained frames within 2
  of JAX's single-chip engine (``dryrun_multichip``'s sub-check 8 bar).
- Bit-equal to the whole-g compositions on one device: the plain RHS, the
  whole-g ``solve_poisson_dd`` on the same mesh (``"dd"``) or the element
  V-cycle ``solve_multigrid(use_pallas=False)`` (``"gspmd"``), the paste;
  the bucket_exact frame to the plain RHS of the tight window, the
  single-device ``solve_multigrid_dyn(use_pallas=False)`` and the paste;
  the edits to the whole-image RHS, the whole-g solve and the paste.
- ``transport.gather`` and ``gather_tiles`` raise inside ``timed_serve``'s
  timed frames: no frame gathers the destination, g or u.

Images are numpy-seeded; ``SHARD_MIN`` is lowered where a test grid is small
so the partitioned levels are partitioned; each JAX result is computed once
per module.
"""
import functools

import jax
import numpy as np
import pytest
import torch

from seamlesscloneoptimization_tpu.core.config import CloneConfig as JaxConfig
from seamlesscloneoptimization_tpu.core.engine import SeamlessClone as JaxEngine
from seamlesscloneoptimization_tpu.parallel import TiledSeamlessClone as JaxTiled
from seamlesscloneoptimization_tpu.parallel import local_edit_tiled as jax_edit_tiled
from seamlesscloneoptimization_tpu.parallel import make_tile_mesh as jax_mesh
from seamlesscloneoptimization_tpu.parallel import seamless_clone_tiled as jax_clone_tiled
from seamlesscloneoptimization_tpu_torch.core.config import CloneConfig
from seamlesscloneoptimization_tpu_torch.core.engine import prepare_inputs
from seamlesscloneoptimization_tpu_torch.models.pipeline import clone_pipeline
from seamlesscloneoptimization_tpu_torch.ops.edit import (
    COLOR_CHANGE,
    ILLUMINATION_CHANGE,
    TEXTURE_FLATTENING,
    edit_guidance,
    edit_inputs,
)
from seamlesscloneoptimization_tpu_torch.ops.kernels import clamp_cast_paste
from seamlesscloneoptimization_tpu_torch.ops.rhs import poisson_rhs
from seamlesscloneoptimization_tpu_torch.parallel import (
    TiledSeamlessClone,
    local_edit_tiled,
    make_tile_mesh,
    seamless_clone_tiled,
    solve_poisson_dd,
    stages,
    tiled,
    transport,
)
from seamlesscloneoptimization_tpu_torch.parallel import mesh as mesh_mod
from seamlesscloneoptimization_tpu_torch.solvers.multigrid import solve_multigrid

# Several pytest-xdist workers share the cores: one intra-op thread each keeps
# torch's OpenMP pools from oversubscribing them. Results do not depend on it.
torch.set_num_threads(1)

SHAPES = [(2, 2), (2, 4), (1, 3), (3, 1)]
CENTER = (96, 48)


def _port(shape):
    return make_tile_mesh([torch.device("cpu")] * (shape[0] * shape[1]), shape)


@functools.lru_cache(maxsize=None)
def _jmesh(shape):
    return jax_mesh(jax.devices()[: shape[0] * shape[1]], shape)


def _images(seed):
    """Synthetic u8 images whose sides every mesh shape here divides (JAX's
    sharded inputs need it) and a disc-and-bar mask."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, 256, (72, 120, 3)).astype(np.uint8)
    dst = rng.integers(0, 256, (96, 192, 3)).astype(np.uint8)
    yy, xx = np.mgrid[:72, :120]
    mask = ((yy - 35) ** 2 + (xx - 62) ** 2 < 27 ** 2) | ((yy > 30) & (yy < 40) & (xx > 8))
    return src, dst, mask.astype(np.uint8) * 255


def _diff_max(a, b):
    return int(np.abs(np.asarray(a).astype(np.int16) - np.asarray(b)).max())


def _composition(src, dst, mask, path, mesh, flags=1, frames=1, bucket=0, cfg=None,
                 center=CENTER):
    """``frames`` chained single-device frames: the plain RHS, the whole-g
    solve of ``path``, the paste; with ``bucket``, bucket_exact's tight
    system (the plain RHS, ``solve_multigrid_dyn(use_pallas=False)``)."""
    cfg = cfg or CloneConfig()
    m, xy, lt, hw, *tight = prepare_inputs(mask, src.shape, dst.shape, center, bucket=bucket,
                                           return_tight=bool(bucket))
    if path == "dd":
        def solver(g):
            return solve_poisson_dd(g, mesh, tol=None if cfg.mg_cycles else cfg.tol,
                                    cycles=cfg.mg_cycles or 4, max_cycles=cfg.max_cycles)
    else:
        def solver(g):
            return solve_multigrid(g, tol=cfg.tol, max_cycles=cfg.max_cycles,
                                   cycles=cfg.mg_cycles, use_pallas=False)
    buf = torch.from_numpy(dst).permute(2, 0, 1).contiguous()
    for _ in range(frames):
        clone_pipeline(torch.from_numpy(src), buf, torch.from_numpy(m), xy, lt,
                       tight[0] if bucket else None, bbox_hw=hw, flags=flags, solver=solver,
                       solver_kwargs=dict(tol=cfg.tol, cycles=cfg.mg_cycles,
                                          max_cycles=cfg.max_cycles, use_pallas=False)
                       if bucket else None,
                       planar_dst=True, use_pallas_pre=False, use_pallas_post=False)
    return buf.permute(1, 2, 0).numpy()


# ---------------------------------------------------------------------------
# bit-equal to the whole-g compositions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("flags", [1, 2, 3])
@pytest.mark.parametrize("path", ["dd", "gspmd"])
@pytest.mark.parametrize("shape", SHAPES)
def test_resident_engine_bit_equal_to_composition(shape, path, flags, monkeypatch):
    """run, a chained run and a 2-frame serve: byte for byte the
    single-device composition's 1, 2 and 3 chained frames."""
    monkeypatch.setattr(tiled, "SHARD_MIN", 8)
    src, dst, mask = _images(flags)
    mesh = _port(shape)
    eng = TiledSeamlessClone(CloneConfig(flags=flags), mesh=mesh, path=path)
    one = eng.run(src, dst, mask, CENTER).numpy()
    two = eng.run(src, one, mask, CENTER).numpy()
    served, _ = eng.timed_serve(src, dst, mask, CENTER, loops=2)
    want = [_composition(src, dst, mask, path, mesh, flags, n) for n in (1, 2, 3)]
    assert np.array_equal(one, want[0]) and np.array_equal(two, want[1])
    assert np.array_equal(served.numpy(), want[2])
    assert eng.metrics["gathers_per_frame"] == 0 and eng.metrics["crossed_bytes_per_frame"] == 0
    assert set(eng.metrics["resident_bytes"]) == {f"{iy},{ix}" for iy in range(shape[0])
                                                  for ix in range(shape[1])}


@pytest.mark.parametrize("cfg", [dict(mg_cycles=3), dict(tol=1e-5, max_cycles=4)],
                         ids=["mg_cycles", "max_cycles"])
@pytest.mark.parametrize("path", ["dd", "gspmd"])
def test_resident_engine_honours_cycles(path, cfg, monkeypatch):
    """mg_cycles and max_cycles reach the tile solves: bit-equal to the
    composition with the same solver settings, and the cycles they set (2
    rb_sweeps_tile twin calls a tile a cycle on the one plain level)."""
    from seamlesscloneoptimization_tpu_torch.ops import kernels as K

    monkeypatch.setattr(tiled, "SHARD_MIN", 8)
    rng = np.random.default_rng(7)
    src = rng.integers(0, 256, (150, 240, 3)).astype(np.uint8)
    dst = rng.integers(0, 256, (200, 300, 3)).astype(np.uint8)
    mask = np.full((150, 240), 255, np.uint8)  # interior 146 x 236: level 0 partitioned
    mesh = _port((2, 2))
    config = CloneConfig(**cfg)
    calls = []
    orig = K.rb_sweeps_tile_plain
    monkeypatch.setattr(K, "rb_sweeps_tile_plain",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    got = TiledSeamlessClone(config, mesh=mesh, path=path).run(src, dst, mask,
                                                               (150, 100)).numpy()
    assert len(calls) == 2 * 4 * (config.mg_cycles or config.max_cycles)
    calls.clear()
    assert np.array_equal(got, _composition(src, dst, mask, path, mesh, cfg=config,
                                            center=(150, 100)))


@pytest.mark.parametrize("cycles", [None, 2])
@pytest.mark.parametrize("shape", [(2, 2), (1, 3)])
def test_resident_bucket_exact_bit_equal(shape, cycles, monkeypatch):
    """bucket_exact on the mesh: the tight window's plain RHS per tile, the
    partitioned dyn solve, the paste: bit-equal to the single-device
    composition, to tol or for mg_cycles."""
    monkeypatch.setattr(tiled, "SHARD_MIN", 8)
    src, dst, mask = _images(8)
    cfg = CloneConfig(bbox_bucket=32, bucket_exact=True, mg_cycles=cycles)
    eng = TiledSeamlessClone(cfg, mesh=_port(shape))
    got = eng.run(src, dst, mask, CENTER).numpy()
    assert eng.metrics["solver_resolved"] == "multigrid_dyn"
    assert np.array_equal(got, _composition(src, dst, mask, "dd", None, bucket=32, cfg=cfg))


# ---------------------------------------------------------------------------
# against JAX's tiled engine, one-shot function and edits
# ---------------------------------------------------------------------------

JAX_CASES = [("dd", 1, (2, 2)), ("dd", 2, (1, 3)), ("dd", 3, (3, 1)), ("dd", 1, (2, 4)),
             ("gspmd", 1, (3, 1)), ("gspmd", 2, (2, 2)), ("gspmd", 3, (1, 3)),
             ("gspmd", 2, (2, 4))]


@functools.lru_cache(maxsize=None)
def _jax_engine_frames(path, flags, shape):
    """JAX's tiled engine: a frame and a chained second one."""
    src, dst, mask = _images(10 + flags)
    eng = JaxTiled(JaxConfig(flags=flags), mesh=_jmesh(shape), path=path)
    one = np.asarray(eng.run(src, dst, mask, CENTER))
    return one, np.asarray(eng.run(src, one, mask, CENTER))


@pytest.mark.parametrize("path,flags,shape", JAX_CASES)
def test_resident_engine_matches_jax(path, flags, shape, monkeypatch):
    """Within 1 grey level of JAX's engine on a mesh of the same shape, a
    frame and a chained second frame; the solver the metrics name."""
    monkeypatch.setattr(tiled, "SHARD_MIN", 8)
    src, dst, mask = _images(10 + flags)
    want1, want2 = _jax_engine_frames(path, flags, shape)
    eng = TiledSeamlessClone(CloneConfig(flags=flags), mesh=_port(shape), path=path)
    got1 = eng.run(src, dst, mask, CENTER).numpy()
    assert eng.metrics["solver_resolved"] == f"multigrid_{path}"
    assert _diff_max(got1, want1) <= 1 and not np.array_equal(got1, dst)
    assert _diff_max(eng.run(src, got1, mask, CENTER).numpy(), want2) <= 1


@functools.lru_cache(maxsize=None)
def _jax_single_chip_two_frames():
    src, dst, mask = _images(20)
    eng = JaxEngine(JaxConfig(solver="multigrid", tol=1e-7))
    one = np.asarray(eng.run(src, dst, mask, CENTER))
    return np.asarray(eng.run(src, one, mask, CENTER))


@pytest.mark.parametrize("path", ["dd", "gspmd"])
def test_two_chained_frames_within_2_of_jax_single_chip(path, monkeypatch):
    """Sub-check 8's bar: two chained frames of the resident engine on the
    2x4 mesh within 2 of JAX's single-chip engine's."""
    monkeypatch.setattr(tiled, "SHARD_MIN", 8)
    src, dst, mask = _images(20)
    eng = TiledSeamlessClone(CloneConfig(tol=1e-7), mesh=_port((2, 4)), path=path)
    two = eng.run(src, eng.run(src, dst, mask, CENTER), mask, CENTER).numpy()
    assert _diff_max(two, _jax_single_chip_two_frames()) <= 2


@functools.lru_cache(maxsize=None)
def _jax_one_shot(path, shape, mg_cycles):
    src, dst, mask = _images(30)
    return jax_clone_tiled(src, dst, mask, CENTER, mesh=_jmesh(shape), path=path,
                           mg_cycles=mg_cycles)


@pytest.mark.parametrize("path,shape,mg_cycles", [("dd", (2, 4), None), ("dd", (3, 1), 4),
                                                  ("gspmd", (1, 3), None)])
def test_seamless_clone_tiled_resident(path, shape, mg_cycles, monkeypatch):
    """The one-shot function: within 1 of JAX's on the same mesh shape,
    bit-equal to the composition; the empty mask returns dst."""
    monkeypatch.setattr(tiled, "SHARD_MIN", 8)
    src, dst, mask = _images(30)
    mesh = _port(shape)
    got = seamless_clone_tiled(src, dst, mask, CENTER, mesh=mesh, path=path,
                               mg_cycles=mg_cycles)
    assert _diff_max(got, _jax_one_shot(path, shape, mg_cycles)) <= 1
    cfg = CloneConfig(mg_cycles=mg_cycles)
    assert np.array_equal(got, _composition(src, dst, mask, path, mesh, cfg=cfg))
    assert np.array_equal(seamless_clone_tiled(src, dst, np.zeros_like(mask), CENTER, mesh=mesh,
                                               path=path), dst)


EDIT_PARAMS = {COLOR_CHANGE: (1.5, 0.5, 1.0), ILLUMINATION_CHANGE: (0.2, 0.4),
               TEXTURE_FLATTENING: (0.0, 0.0)}


def _edit_images(seed=40):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (96, 192, 3)).astype(np.uint8)
    mask = np.zeros((96, 192), np.uint8)
    mask[20:80, 0:130] = 255  # touches the image's left edge: the replicate border
    edge = ((rng.random((96, 192)) < 0.2) * 255).astype(np.uint8)
    return img, mask, edge


@functools.lru_cache(maxsize=None)
def _jax_edit(kind, path, shape):
    img, mask, edge = _edit_images()
    return jax_edit_tiled(img, mask, kind, EDIT_PARAMS[kind],
                          edge if kind == TEXTURE_FLATTENING else None, mesh=_jmesh(shape),
                          path=path)


def _edit_composition(img, mask, kind, edge, path, mesh, tol=1e-5):
    """The edit's whole-image stages on one device, the whole-g solve, the
    paste into a copy of the source."""
    src_p, me, params, edge_t = edit_inputs(img, mask, EDIT_PARAMS[kind], edge,
                                            torch.device("cpu"))
    src_f = src_p.to(torch.float32)
    g = poisson_rhs(*edit_guidance(src_f, me, params, edge_t, kind=kind), src_f)
    u = (solve_poisson_dd(g, mesh, tol=tol) if path == "dd"
         else solve_multigrid(g, tol=tol, use_pallas=False))
    _, h2, w2 = g.shape
    return clamp_cast_paste(u.contiguous(), src_p.clone(), 1, 1, h2, w2).permute(1, 2, 0).numpy()


@pytest.mark.parametrize("kind,path,shape", [(COLOR_CHANGE, "dd", (2, 2)),
                                             (ILLUMINATION_CHANGE, "gspmd", (3, 1)),
                                             (TEXTURE_FLATTENING, "dd", (1, 3))])
def test_local_edit_tiled_resident(kind, path, shape, monkeypatch):
    """Per-tile edit stages (the replicate-border erosion on a window, the
    guidance, the divergence): within 1 of JAX's local_edit_tiled on the
    same mesh shape, bit-equal to the whole-image composition."""
    monkeypatch.setattr(tiled, "SHARD_MIN", 8)
    img, mask, edge = _edit_images()
    edge = edge if kind == TEXTURE_FLATTENING else None
    mesh = _port(shape)
    got = local_edit_tiled(img, mask, kind, EDIT_PARAMS[kind], edge, mesh=mesh, path=path)
    assert got.shape == img.shape and _diff_max(got, _jax_edit(kind, path, shape)) <= 1
    assert np.array_equal(got, _edit_composition(img, mask, kind, edge, path, mesh))


# ---------------------------------------------------------------------------
# the frames gather nothing; the stages' geometry
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["dd", "gspmd", "bucket_exact"])
def test_timed_frames_do_not_gather(mode, monkeypatch):
    """``transport.gather`` and ``gather_tiles`` raise inside every timed
    frame of timed_serve (the warm-up frame and the result's one gather
    after the loop run as they are): the frames run, and the served image
    equals the composition."""
    monkeypatch.setattr(tiled, "SHARD_MIN", 8)
    src, dst, mask = _images(50)
    bucket = 32 if mode == "bucket_exact" else 0
    path = "gspmd" if mode == "gspmd" else "dd"
    cfg = CloneConfig(bbox_bucket=bucket, bucket_exact=bool(bucket))
    eng = TiledSeamlessClone(cfg, mesh=_port((2, 2)), path=path)
    steps = []
    step = stages.ResidentFrame.step

    def forbidden(*a, **k):
        raise AssertionError("a timed frame gathered")

    def guarded(self):
        steps.append(1)
        if len(steps) == 1:  # the warm-up
            return step(self)
        with monkeypatch.context() as m:
            m.setattr(transport, "gather", forbidden)
            m.setattr(mesh_mod, "gather_tiles", forbidden)
            return step(self)

    monkeypatch.setattr(stages.ResidentFrame, "step", guarded)
    served, _ = eng.timed_serve(src, dst, mask, CENTER, loops=2)
    assert len(steps) == 3
    want = _composition(src, dst, mask, path, _port((2, 2)), frames=3, bucket=bucket, cfg=cfg)
    assert np.array_equal(served.numpy(), want)


def test_stage_geometry_and_windows():
    """The destination splits at the solve tiling's boundaries moved by the
    ROI's offset; DD tiles past the true interior get no box (zeros in g,
    no paste); a window past the array is zero-filled; the RHS window of a
    corner tile folds only on the ROI's frame sides."""
    mesh = _port((2, 2))
    tiling = tiled.dd_tiling(10, 30, mesh)  # padded to 16 x 32: tiles 8 x 16
    frame = stages.ResidentFrame(mesh, tiling, (10, 30), (5, 7), (40, 60), None)
    assert frame.dtiling.rows == (0, 14, 40) and frame.dtiling.cols == (0, 24, 60)
    assert frame.box(1, 1) == (8, 10, 16, 30) and frame.folds(0, 0) == (True, False, True, False)
    assert frame.folds(1, 1) == (False, True, False, True)
    assert frame.roi_window(0, 0, stages.MASK_RING) == (-3, 13, -3, 21)
    tiny = stages.ResidentFrame(mesh, tiled.dd_tiling(5, 5, mesh), (5, 5), (0, 0), (9, 9), None)
    assert tiny.has_box(0, 0) and not tiny.has_box(1, 1)  # the DD tiling's 8 x 8 tiles
    x = torch.arange(2 * 6 * 8, dtype=torch.float32).reshape(2, 6, 8)
    tiles = tiled.Tiling((0, 2, 6), (0, 5, 8)).split(x, mesh)
    win = transport.windows(tiles, (0, 2, 6), (0, 5, 8),
                            lambda iy, ix: (iy * 3 - 1, iy * 3 + 4, ix * 4 - 2, ix * 4 + 3), mesh)
    want = torch.nn.functional.pad(x, (2, 2, 1, 1))
    for iy in range(2):
        for ix in range(2):
            assert torch.equal(win[iy][ix], want[:, iy * 3 : iy * 3 + 5, ix * 4 : ix * 4 + 5])
    np.testing.assert_array_equal(stages.host_window(np.arange(12).reshape(3, 4), -1, 2, 2, 5,
                                                     fill=-7),
                                  [[-7, -7, -7], [2, 3, -7], [6, 7, -7]])

