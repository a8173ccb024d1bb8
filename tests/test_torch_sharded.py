"""The port's partitioned element V-cycle (``solve_multigrid_sharded``) and
``path="gspmd"`` on the CPU.

- Against the port's own single-device element solve,
  ``solve_multigrid(g, tol, max_cycles, cycles=cycles, use_pallas=False)``:
  bit-equal, with the same cycle count and residual, on CPU meshes of 1x1,
  2x2, 2x4 and the uneven 1x3 / 3x1 and 3x3, in fixed-cycle and tolerance
  mode, with the gather cut forced at each level through the module
  constant ``SHARD_MIN``. The partition changes where each element is
  computed, never how: the sums run in the same order, the colours and the
  Shortley-Weller edges come from global coordinates, max is exact.
- Against JAX's ``solve_multigrid_sharded`` on its 8-device virtual mesh
  (``tests/conftest.py``): relative 1e-5 with fixed cycles, 5e-5 in
  tolerance mode (ROADMAP §3's measured bar: a one-ulp change of g moves the
  tolerance-mode result by up to 1.7e-5), equal cycles where both report.
- ``TiledSeamlessClone`` / ``seamless_clone_tiled`` / ``local_edit_tiled``
  with ``path="gspmd"`` within 1 grey level of JAX's ``path="gspmd"`` on
  seeded synthetic images; the engine builds on a mesh that spans
  processes.

Inputs are numpy-seeded. ``SHARD_MIN`` is lowered where a test grid is
small, so the tiles are partitioned and not gathered whole.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seamlesscloneoptimization_tpu.core.config import CloneConfig as JaxConfig
from seamlesscloneoptimization_tpu.parallel import TiledSeamlessClone as JaxTiled
from seamlesscloneoptimization_tpu.parallel import local_edit_tiled as jax_edit_tiled
from seamlesscloneoptimization_tpu.parallel import make_tile_mesh as jax_mesh
from seamlesscloneoptimization_tpu.parallel import seamless_clone_tiled as jax_clone_tiled
from seamlesscloneoptimization_tpu.parallel import solve_multigrid_sharded as jax_sharded
from seamlesscloneoptimization_tpu_torch.core.config import CloneConfig
from seamlesscloneoptimization_tpu_torch.core.engine import SeamlessClone
from seamlesscloneoptimization_tpu_torch.ops import kernels as K
from seamlesscloneoptimization_tpu_torch.ops.edit import COLOR_CHANGE, ILLUMINATION_CHANGE
from seamlesscloneoptimization_tpu_torch.parallel import (
    TileMesh,
    TiledSeamlessClone,
    local_edit_tiled,
    make_tile_mesh,
    seamless_clone_tiled,
    solve_multigrid_sharded,
    tiled,
)
from seamlesscloneoptimization_tpu_torch.solvers.multigrid import solve_multigrid

# Several pytest-xdist workers share the cores: one intra-op thread each keeps
# torch's OpenMP pools from oversubscribing them. Results do not depend on it.
torch.set_num_threads(1)


def _rand(shape, seed, scale=30.0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32) * scale


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _port(shape=(2, 4)):
    return make_tile_mesh([torch.device("cpu")] * (shape[0] * shape[1]), shape)


@functools.lru_cache(maxsize=None)
def _mesh24():
    return jax_mesh(jax.devices()[:8], (2, 4))


def _rel(got, want):
    return float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())


def _levels(h, w, shape):
    """(h, w, bh, bw) of each partitioned level."""
    lv = tiled._Level(h, w, 1.0, 1.0, tiled._split(h, shape[0]), tiled._split(w, shape[1]))
    out = []
    while lv.sharded:
        out.append((lv.h, lv.w, lv.bh, lv.bw))
        lv = lv.coarser()
    return out


G300 = _rand((2, 300, 421), 0)


@functools.lru_cache(maxsize=None)
def _single(cycles):
    """The port's single-device element solve of G300 (u, info)."""
    return solve_multigrid(_t(G300), tol=1e-4, cycles=cycles, use_pallas=False,
                           return_info=True)


# ---------------------------------------------------------------------------
# bit-equal to the single-device element solve
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cycles", [2, None], ids=["fixed", "tol"])
@pytest.mark.parametrize("shape", [(1, 1), (2, 2), (2, 4), (1, 3), (3, 1), (3, 3)])
def test_sharded_bit_equal_to_single_device(shape, cycles, monkeypatch):
    """Three partitioned levels (the plain one, then betas 1.5 / 1.0 and
    1.25 / 1.5), the coarsest gathered: u, cycles and residual equal."""
    monkeypatch.setattr(tiled, "SHARD_MIN", 16)
    assert len(_levels(300, 421, shape)) == 3
    want, info_w = _single(cycles)
    got, info = solve_multigrid_sharded(_t(G300), _port(shape), tol=1e-4, cycles=cycles,
                                        return_info=True)
    assert torch.equal(got, want)
    assert info == info_w
    assert info["cycles"] == (2 if cycles else 4)


@pytest.mark.parametrize("cut", [0, 1, 2, 3])
def test_gather_cut_at_each_level(cut, monkeypatch):
    """``SHARD_MIN`` between the tile sides of two levels gathers every level
    from there on (2x2 mesh: tile sides 150, 74, 37 on levels 0-2; level 3
    is the coarsest): bit-equal wherever the cut falls, tolerance mode."""
    monkeypatch.setattr(tiled, "SHARD_MIN", {0: 1000, 1: 100, 2: 50, 3: 8}[cut])
    assert len(_levels(300, 421, (2, 2))) == cut
    want, info_w = _single(None)
    got, info = solve_multigrid_sharded(_t(G300), _port((2, 2)), return_info=True)
    assert torch.equal(got, want) and info == info_w


@pytest.mark.parametrize("hw", [(517, 262), (130, 173), (70, 126)])
def test_sharded_odd_sizes_and_small_grids(hw, monkeypatch):
    """An odd fine size (betas 1.0 / 1.5, then 1.5 / 1.75), a 1-level
    partition and a grid whose level 0 is partitioned and level 1 the
    coarsest: bit-equal on the uneven 3x1 and the 2x4 mesh; the module
    default ``SHARD_MIN`` solves the small grids whole, bit-equal too."""
    g = _t(_rand((1,) + hw, hw[0]))
    want, info_w = solve_multigrid(g, tol=1e-4, use_pallas=False, return_info=True)
    for shape in ((3, 1), (2, 4)):
        assert torch.equal(solve_multigrid_sharded(g, _port(shape)), want)
    monkeypatch.setattr(tiled, "SHARD_MIN", 8)
    for shape in ((3, 1), (2, 4)):
        assert _levels(*hw, shape)
        got, info = solve_multigrid_sharded(g, _port(shape), return_info=True)
        assert torch.equal(got, want) and info == info_w


def test_sharded_launches_and_edges(monkeypatch):
    """On CPU tiles the plain level's sweeps go through ``K.rb_sweeps_tile``'s
    twin (2 calls a tile a cycle: nu1 and nu2 on a 4-ring band), the beta
    levels through torch ops; zero g gives zero u after the check-free
    burst, as on one device; the level boundaries halve, the last tile
    shorter."""
    monkeypatch.setattr(tiled, "SHARD_MIN", 16)
    calls = []
    orig = K.rb_sweeps_tile_plain
    monkeypatch.setattr(K, "rb_sweeps_tile_plain",
                        lambda *a, **k: calls.append(a[2]) or orig(*a, **k))
    solve_multigrid_sharded(_t(G300), _port((2, 2)), cycles=3)
    assert calls == ([1] * 4 + [2] * 4) * 3  # level 0 is the only plain level of 300x421
    zero = torch.zeros((1, 300, 421))
    z, info = solve_multigrid_sharded(zero, _port((2, 2)), return_info=True)
    assert not z.any() and info == solve_multigrid(zero, use_pallas=False, return_info=True)[1]
    assert tiled._split(10, 3) == (0, 4, 8, 10)
    assert tiled._halve((0, 150, 300), 149) == (0, 75, 149)


def test_sharded_returns_on_g_device():
    """A grid no tile of which reaches the module's ``SHARD_MIN`` is solved
    whole, on g's device, as the single-device solve."""
    g = _t(_rand((1, 96, 96), 3))
    out = solve_multigrid_sharded(g, _port((2, 2)), cycles=1)
    assert out.device == g.device and out.shape == g.shape
    assert torch.equal(out, solve_multigrid(g, cycles=1, use_pallas=False))


# ---------------------------------------------------------------------------
# against JAX's solve_multigrid_sharded on the 8-device virtual mesh
# ---------------------------------------------------------------------------

GJ = _rand((3, 264, 392), 7)  # divisible by the 2x4 mesh, as JAX's sharded input must be


@functools.lru_cache(maxsize=None)
def _jax_sharded(cycles):
    return np.asarray(jax_sharded(jnp.asarray(GJ), _mesh24(), tol=1e-4, cycles=cycles))


@pytest.mark.parametrize("cycles", [3, None], ids=["fixed", "tol"])
def test_sharded_matches_jax(cycles, monkeypatch):
    """The port partitioned over 2x4 CPU tiles (three partitioned levels)
    against XLA's partitioning of the same solve: 1e-5 fixed, 5e-5 tol."""
    monkeypatch.setattr(tiled, "SHARD_MIN", 16)
    assert len(_levels(264, 392, (2, 4))) == 3
    got, info = solve_multigrid_sharded(_t(GJ), _port(), tol=1e-4, cycles=cycles,
                                        return_info=True)
    assert _rel(got, _jax_sharded(cycles)) <= (1e-5 if cycles else 5e-5)
    if cycles is None:
        assert info["residual"] <= 1e-4 * np.abs(GJ).max()


# ---------------------------------------------------------------------------
# path="gspmd" against JAX's
# ---------------------------------------------------------------------------


def _images(seed=0, src_hw=(72, 128), dst_hw=(100, 200)):
    """Synthetic u8 images (H, W divisible by the 2x4 mesh, which JAX's
    sharded inputs need) and a disc-and-bar mask."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, 256, src_hw + (3,)).astype(np.uint8)
    dst = rng.integers(0, 256, dst_hw + (3,)).astype(np.uint8)
    yy, xx = np.mgrid[: src_hw[0], : src_hw[1]]
    mask = ((yy - 35) ** 2 + (xx - 65) ** 2 < 28 ** 2) | ((yy > 30) & (yy < 40) & (xx > 8))
    return src, dst, mask.astype(np.uint8) * 255


CENTER = (100, 50)


def _diff_max(a, b):
    return int(np.abs(np.asarray(a).astype(np.int16) - np.asarray(b)).max())


@pytest.mark.parametrize("flags", [1, 2])
def test_gspmd_engine_matches_jax(flags, monkeypatch):
    """NORMAL and MIXED on the 2x4 mesh, two chained frames: within 1 grey
    level of JAX's engine; the solve is the partitioned V-cycle."""
    monkeypatch.setattr(tiled, "SHARD_MIN", 8)
    src, dst, mask = _images(flags)
    jax_eng = JaxTiled(JaxConfig(flags=flags), mesh=_mesh24(), path="gspmd")
    eng = TiledSeamlessClone(CloneConfig(flags=flags), mesh=_port(), path="gspmd")
    want = np.asarray(jax_eng.run(src, dst, mask, CENTER))
    got = eng.run(src, dst, mask, CENTER).numpy()
    assert (eng.metrics["solver_resolved"] == jax_eng.metrics["solver_resolved"]
            == "multigrid_gspmd")
    assert _diff_max(got, want) <= 1 and not np.array_equal(got, dst)
    want2 = np.asarray(jax_eng.run(src, want, mask, CENTER))
    assert _diff_max(eng.run(src, got, mask, CENTER).numpy(), want2) <= 1


def test_gspmd_one_shot_matches_jax(monkeypatch):
    """``seamless_clone_tiled(path="gspmd")`` on the 2x4 and 1x1 meshes, the
    empty mask; mg_cycles fixes the work (the port honours it on this path;
    JAX's takes tol only): within 1 of the single-device element V-cycle's
    two cycles."""
    monkeypatch.setattr(tiled, "SHARD_MIN", 8)
    src, dst, mask = _images(4)
    want = jax_clone_tiled(src, dst, mask, CENTER, mesh=_mesh24(), path="gspmd")
    got = seamless_clone_tiled(src, dst, mask, CENTER, mesh=_port(), path="gspmd")
    assert _diff_max(got, want) <= 1
    assert _diff_max(seamless_clone_tiled(src, dst, mask, CENTER, mesh=_port((1, 1)),
                                          path="gspmd"), want) <= 1
    assert np.array_equal(seamless_clone_tiled(src, dst, np.zeros_like(mask), CENTER,
                                               mesh=_port(), path="gspmd"), dst)
    eng = TiledSeamlessClone(CloneConfig(mg_cycles=2), mesh=_port(), path="gspmd")
    one = SeamlessClone(CloneConfig(solver="multigrid", mg_cycles=2, mg_padded=False),
                        device="cpu")
    assert _diff_max(eng.run(src, dst, mask, CENTER), one.run(src, dst, mask, CENTER)) <= 1
    served, _ = eng.timed_serve(src, dst, mask, CENTER, loops=1)
    assert served.shape == dst.shape and eng.metrics["solver_resolved"] == "multigrid_gspmd"


@pytest.mark.parametrize("kind,params", [(COLOR_CHANGE, (1.5, 0.5, 1.0)),
                                         (ILLUMINATION_CHANGE, (0.2, 0.4))])
def test_gspmd_edit_matches_jax(kind, params, monkeypatch):
    """``local_edit_tiled(path="gspmd")`` within 1 of JAX's, and of the DD
    path's."""
    monkeypatch.setattr(tiled, "SHARD_MIN", 8)
    rng = np.random.default_rng(9)
    img = rng.integers(0, 256, (96, 160, 3)).astype(np.uint8)
    mask = np.zeros((96, 160), np.uint8)
    mask[20:80, 30:130] = 255
    want = jax_edit_tiled(img, mask, kind, params, mesh=_mesh24(), path="gspmd")
    got = local_edit_tiled(img, mask, kind, params, mesh=_port(), path="gspmd")
    assert got.shape == img.shape and _diff_max(got, want) <= 1
    assert _diff_max(got, local_edit_tiled(img, mask, kind, params, mesh=_port())) <= 1


def test_process_spanning_mesh_runs_the_engine():
    """Rewritten from ``test_process_spanning_mesh_is_for_the_solvers``: the
    engine and the one-shot functions no longer refuse a mesh whose cells
    another rank owns. The engine builds on both paths, on this rank's
    device, as a tiled (not single-device) engine, and its resident frame
    holds this rank's destination tiles and input windows only (the runs
    across processes, bit-equal on every rank to one process, are in
    tests/test_torch_distributed.py)."""
    cpu = torch.device("cpu")
    mesh = TileMesh(((cpu, cpu),), owners=((0, 1),), rank=0)
    assert mesh.spans_processes and mesh.local_cells() == [(0, 0)]
    src, dst, mask = _images(6)
    for path in ("dd", "gspmd"):
        eng = TiledSeamlessClone(mesh=mesh, path=path)
        assert eng.device == cpu and not eng._single
        flags, prep = eng._prepared(src, dst, mask, CENTER, None)
        frame = eng._frame(src, dst, prep, flags)
        assert frame.dest[0][0] is not None and frame.dest[0][1] is None
        assert frame.inputs[0][0] is not None and frame.inputs[0][1] is None
        assert set(eng.metrics["resident_bytes"]) == {"0,0"}
