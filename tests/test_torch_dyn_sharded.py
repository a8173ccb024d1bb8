"""Slice 8b's partitioned solves and splits on the CPU: the runtime-domain
multigrid over a mesh (``solve_multigrid_dyn_sharded``), the batch's jobs
split over a mesh (``clone_roi_batch(mesh=...)``) and ``dryrun_multichip``.

- ``solve_multigrid_dyn_sharded`` against the port's single-device
  ``solve_multigrid_dyn(use_pallas=False)``: bit-equal, with the same cycle
  count and residual, on CPU meshes of 1x1, 2x2, 2x4 and the uneven 1x3 /
  3x1, in fixed-cycle and tolerance mode, on odd true sizes inside a bucket
  (betas 1.5 / 1.75 levels), with a true size that empties a level, and on
  tiles too small to partition (solved whole); ``SHARD_MIN`` is lowered so
  the small test grids are partitioned. Against JAX's
  ``solve_multigrid_dyn`` jitted with tile shardings on its 8-device
  virtual mesh (``__graft_entry__.py``'s sub-check 4): relative 1e-5 with
  fixed cycles, 5e-5 in tolerance mode (ROADMAP §3's measured bar).
- ``clone_roi_batch(mesh=...)`` bit-equal to the call without a mesh, on
  the plain and the kernel route; within 1 of JAX's ``clone_roi_batch``
  with its job axis sharded over the flattened 2x4 mesh (sub-check 3's
  setup); N not divisible by the mesh's size raises ValueError.
- ``dryrun_multichip`` passes its eight sub-checks on a 2x4 CPU mesh.

Inputs are numpy-seeded; each JAX result is computed once per module.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from seamlesscloneoptimization_tpu.parallel import batch as JB
from seamlesscloneoptimization_tpu.parallel import make_tile_mesh as jax_mesh
from seamlesscloneoptimization_tpu.parallel.mesh import tile_sharding
from seamlesscloneoptimization_tpu.solvers import solve_dst_gemm as jax_dst_gemm
from seamlesscloneoptimization_tpu.solvers.multigrid_dyn import (
    solve_multigrid_dyn as jax_dyn,
)
from seamlesscloneoptimization_tpu_torch.parallel import (
    batch as TB,
)
from seamlesscloneoptimization_tpu_torch.parallel import (
    dryrun_multichip,
    make_tile_mesh,
    solve_multigrid_dyn_sharded,
    tiled,
)
from seamlesscloneoptimization_tpu_torch.solvers import solve_dst_gemm
from seamlesscloneoptimization_tpu_torch.solvers.multigrid_dyn import solve_multigrid_dyn

# Several pytest-xdist workers share the cores: one intra-op thread each keeps
# torch's OpenMP pools from oversubscribing them. Results do not depend on it.
torch.set_num_threads(1)


def _port(shape=(2, 4)):
    return make_tile_mesh([torch.device("cpu")] * (shape[0] * shape[1]), shape)


@functools.lru_cache(maxsize=None)
def _mesh24():
    return jax_mesh(jax.devices()[:8], (2, 4))


def _rhs(padded, true_hw, seed, garbage=True):
    """(C, Hp, Wp) f32: the RHS on [0, h) x [0, w), garbage or zeros past it
    (the solver ignores it)."""
    rng = np.random.default_rng(seed)
    g = (rng.normal(size=(3,) + padded) * (30.0 if garbage else 0.0)).astype(np.float32)
    h, w = true_hw
    g[:, :h, :w] = rng.normal(size=(3, h, w)).astype(np.float32) * 10
    return g


def _partitioned(true_hw, padded, shape):
    """The partitioned levels of the dyn solve on a mesh of ``shape``."""
    lv = tiled._Level(*true_hw, 1.0, 1.0, tiled._split(true_hw[0], shape[0]),
                      tiled._split(true_hw[1], shape[1]), padded)
    return len(tiled._levels(lv)) - 1


# (padded, true): an odd true size inside a bucket (betas 1.0 / 1.5, 1.75),
# a bucket's even interior, and a narrow domain whose sixth level is empty
CASES = {"bucket_odd": ((256, 384), (201, 281)), "bucket_even": ((192, 384), (150, 300)),
         "empties": ((256, 1024), (200, 40))}


@functools.lru_cache(maxsize=None)
def _single(case, cycles):
    padded, true_hw = CASES[case]
    return solve_multigrid_dyn(torch.from_numpy(_rhs(padded, true_hw, 1)), true_hw,
                               cycles=cycles, use_pallas=False, return_info=True)


@pytest.mark.parametrize("cycles", [3, None], ids=["fixed", "tol"])
@pytest.mark.parametrize("shape", [(1, 1), (2, 2), (2, 4), (1, 3), (3, 1)])
@pytest.mark.parametrize("case", sorted(CASES))
def test_dyn_sharded_bit_equal_to_single_device(case, shape, cycles, monkeypatch):
    """u (zeros past the true domain), cycles and residual equal; at least
    one partitioned level on every mesh (``SHARD_MIN`` 8)."""
    monkeypatch.setattr(tiled, "SHARD_MIN", 8)
    padded, true_hw = CASES[case]
    assert _partitioned(true_hw, padded, shape) >= 1
    want, info_w = _single(case, cycles)
    got, info = solve_multigrid_dyn_sharded(torch.from_numpy(_rhs(padded, true_hw, 1)),
                                            true_hw, _port(shape), cycles=cycles,
                                            return_info=True)
    assert torch.equal(got, want) and info == info_w
    assert not got[:, true_hw[0]:].any() and not got[:, :, true_hw[1]:].any()


def test_dyn_sharded_empty_level_and_small_grids(monkeypatch):
    """The narrow case's coarse widths run 40, 19, 9, 4, 1, 0 while the
    padded levels are not yet the bottom: the empty level's correction is
    zero, as on one device; with the module's ``SHARD_MIN``
    no tile of these grids is partitioned and the solve runs whole, still
    bit-equal; a zero true size gives zeros."""
    monkeypatch.setattr(tiled, "SHARD_MIN", 8)
    lv = tiled._Level(200, 40, 1.0, 1.0, tiled._split(200, 2), tiled._split(40, 2), (256, 1024))
    widths = []
    while lv.w > 0:
        widths.append(lv.w)
        lv = lv.coarser()
    assert widths == [40, 19, 9, 4, 1] and min(lv.padded_hw) > 5  # empty, not the bottom
    monkeypatch.setattr(tiled, "SHARD_MIN", 128)
    for case in ("bucket_odd", "empties"):
        padded, true_hw = CASES[case]
        assert _partitioned(true_hw, padded, (2, 2)) == 0
        got, info = solve_multigrid_dyn_sharded(torch.from_numpy(_rhs(padded, true_hw, 1)),
                                                true_hw, _port((2, 2)), return_info=True)
        want, info_w = _single(case, None)
        assert torch.equal(got, want) and info == info_w
    z = solve_multigrid_dyn_sharded(torch.ones((1, 40, 40)), (0, 12), _port((2, 2)))
    assert z.shape == (1, 40, 40) and not z.any()


def test_dyn_sharded_launches_and_tile_form(monkeypatch):
    """The plain levels' sweeps go through ``K.rb_sweeps_tile``'s twin (2
    calls a tile a cycle on each plain partitioned level); the tile form
    takes and returns the ``sharded_tiling``'s tiles and rejects others."""
    from seamlesscloneoptimization_tpu_torch.ops import kernels as K

    monkeypatch.setattr(tiled, "SHARD_MIN", 16)
    calls = []
    orig = K.rb_sweeps_tile_plain
    monkeypatch.setattr(K, "rb_sweeps_tile_plain",
                        lambda *a, **k: calls.append(a[2]) or orig(*a, **k))
    padded, true_hw = CASES["bucket_odd"]
    g = torch.from_numpy(_rhs(padded, true_hw, 1))
    mesh = _port((2, 2))
    lv = tiled._Level(*true_hw, 1.0, 1.0, tiled._split(201, 2), tiled._split(281, 2), padded)
    plain = sum(1 for x in tiled._levels(lv)[:-1] if x.unit)
    solve_multigrid_dyn_sharded(g, true_hw, mesh, cycles=2)
    assert plain >= 1 and sorted(calls) == sorted([1, 2] * 4 * plain * 2)
    tiling = tiled.sharded_tiling(*true_hw, mesh)
    u = tiled.solve_multigrid_dyn_sharded_tiles(tiling.split(g[:, :201, :281], mesh), true_hw,
                                                padded, mesh, cycles=2)
    assert [[t.shape for t in row] for row in u] == [
        [(3, 101, 141), (3, 101, 140)], [(3, 100, 141), (3, 100, 140)]]
    with pytest.raises(ValueError, match="tiling"):
        tiled.solve_multigrid_dyn_sharded_tiles(tiled.Tiling((0, 101, 201), (0, 100, 281)).split(
            g[:, :201, :281], mesh), true_hw, padded, mesh)


@functools.lru_cache(maxsize=None)
def _jax_dyn(cycles):
    padded, true_hw = (192, 384), (150, 300)
    mesh = _mesh24()
    sh = tile_sharding(mesh)
    fn = jax.jit(lambda gg, hw: jax_dyn(gg, hw, cycles=cycles),
                 in_shardings=(sh, NamedSharding(mesh, P())), out_shardings=sh)
    g = jax.device_put(jnp.asarray(_rhs(padded, true_hw, 2, garbage=False)), sh)
    return np.asarray(fn(g, jnp.asarray(true_hw, jnp.int32)))


@pytest.mark.parametrize("cycles", [6, None], ids=["fixed", "tol"])
def test_dyn_sharded_matches_jax(cycles, monkeypatch):
    """The port partitioned over 2x4 CPU tiles against XLA's partitioning of
    JAX's solve_multigrid_dyn (sub-check 4's geometry): 1e-5 fixed, 5e-5
    tolerance."""
    monkeypatch.setattr(tiled, "SHARD_MIN", 16)
    padded, true_hw = (192, 384), (150, 300)
    assert _partitioned(true_hw, padded, (2, 4)) >= 2
    got = solve_multigrid_dyn_sharded(torch.from_numpy(_rhs(padded, true_hw, 2, garbage=False)),
                                      true_hw, _port(), cycles=cycles).numpy()
    want = _jax_dyn(cycles)
    rel = np.abs(got - want).max() / np.abs(want).max()
    assert rel <= (1e-5 if cycles else 5e-5), rel


# ---------------------------------------------------------------------------
# clone_roi_batch with its jobs split over a mesh
# ---------------------------------------------------------------------------


def _jobs(n, seed=3, bhw=34):
    rng = np.random.default_rng(seed)
    dests = rng.integers(0, 256, (n, 3, bhw, bhw)).astype(np.uint8)
    patches = rng.integers(0, 256, (n, 3, bhw, bhw)).astype(np.uint8)
    masks = np.zeros((n, bhw, bhw), np.uint8)
    masks[:, 3:-3, 2:-4] = 255
    return dests, patches, masks


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("shape", [(2, 4), (2, 2), (1, 3), (1, 1)])
def test_batch_over_mesh_bit_equal(shape, use_pallas):
    """Blocks of N / size jobs, row-major over the cells: bit-equal to the
    call without a mesh, back on the input's device."""
    n = 2 * shape[0] * shape[1]
    d, p, m = (torch.from_numpy(x) for x in _jobs(n))
    want = TB.clone_roi_batch(d, p, m, 2, TB.fast_dst_solver(), use_pallas)
    got = TB.clone_roi_batch(d, p, m, 2, TB.fast_dst_solver(), use_pallas, mesh=_port(shape))
    assert got.device == d.device and torch.equal(got, want)


@functools.lru_cache(maxsize=None)
def _jax_batch():
    mesh = _mesh24()
    shard = NamedSharding(mesh, P(("ty", "tx")))
    fn = jax.jit(functools.partial(JB.clone_roi_batch, flags=1, solver=jax_dst_gemm))
    return np.asarray(fn(*(jax.device_put(jnp.asarray(x), shard) for x in _jobs(16, seed=4))))


def test_batch_over_mesh_matches_jax_and_checks_n():
    """Sub-check 3's setup: 16 jobs over the 2x4 mesh within 1 of JAX's
    sharded batch; 15 jobs over 8 cells raise, as JAX's device_put does."""
    d, p, m = (torch.from_numpy(x) for x in _jobs(16, seed=4))
    got = TB.clone_roi_batch(d, p, m, 1, solve_dst_gemm, mesh=_port()).numpy()
    assert np.abs(got.astype(np.int16) - _jax_batch()).max() <= 1
    with pytest.raises(ValueError, match="do not split"):
        TB.clone_roi_batch(d[:15], p[:15], m[:15], 1, solve_dst_gemm, mesh=_port())


def test_dryrun_multichip_on_a_2x4_cpu_mesh():
    """The eight sub-checks pass; their figures come back."""
    fig = dryrun_multichip(_port())
    assert fig["mesh"] == [2, 4] and set(fig) == {"mesh", *map(str, range(1, 9))}
    assert fig["3"]["bit_equal_unsplit"] and fig["4"]["bit_equal_single_device"]
    assert fig["8"]["diff_max_vs_single_device"] <= 2 and fig["2"]["rel_residual"] < 2e-3
