"""The port's process-spanning tile meshes on ``torch.distributed`` (gloo, CPU).

JAX's two-process test (``tests/test_distributed_2proc.py``) spawns two
local processes, joins them with ``init_distributed`` and runs one
``solve_poisson_dd`` over a 2x4 mesh that spans both. These spawn the
port's ranks (``python -m seamlesscloneoptimization_tpu_torch.parallel.
dist_check``, each with a timeout) in the same layout, two processes of
four CPU tiles, and in four processes of one tile on a 2x2 mesh. Every
rank passes the same global g and gets the whole u back, and each result
must be bit-equal to the same call on a single-process mesh of that shape
(computed here): ``solve_poisson_dd`` at tol 1e-6 on (1, 40, 56), also
within 1e-4 of the NumPy DST oracle (JAX's bar);
``solve_multigrid_sharded`` (tolerance and fixed cycles, three partitioned
levels: ``--shard-min 16``); ``solve_redblack_tiled`` with halos 2 and 8,
and with halo 4 in both schedules (``overlap=True``: the split exchange,
its transfers posted before the interior's sweeps end, bit-equal to
``overlap=False`` as well);
and slice 8b's: the mesh-resident ``TiledSeamlessClone`` (``run`` on both
paths, ``timed_serve`` of two frames with no gather in them),
``seamless_clone_tiled``, ``local_edit_tiled``,
``solve_multigrid_dyn_sharded`` (three partitioned levels) and
``clone_roi_batch(mesh=...)``, each rank's whole result bit-equal to the
one-process mesh's. Each rank calls ``init_distributed`` a second time,
which must do nothing.

Skipped only when localhost sockets are refused, as the JAX test is; any
failure inside the protocol fails.
"""
import functools

import numpy as np
import pytest
import torch

from seamlesscloneoptimization_tpu.core.reference import poisson_solve_dst
from seamlesscloneoptimization_tpu_torch.parallel import dist_check, make_tile_mesh, tiled

# Several pytest-xdist workers share the cores: one intra-op thread each keeps
# torch's OpenMP pools from oversubscribing them (the ranks take one too).
torch.set_num_threads(1)

G_DD = (np.random.default_rng(0).normal(size=(1, 40, 56)) * 10).astype(np.float32)
G_MG = (np.random.default_rng(1).normal(size=(1, 264, 392)) * 10).astype(np.float32)
_RNG = np.random.default_rng(2)
SRC = torch.from_numpy(_RNG.integers(0, 256, (150, 240, 3)).astype(np.uint8))
DST = torch.from_numpy(_RNG.integers(0, 256, (200, 300, 3)).astype(np.uint8))
_YY, _XX = np.mgrid[:150, :240]
MASK = torch.from_numpy(((((_YY - 75) / 70.0) ** 2 + ((_XX - 120) / 115.0) ** 2 <= 1)
                         * 255).astype(np.uint8))
G_DYN = np.zeros((3, 192, 384), np.float32)
G_DYN[:, :150, :300] = _RNG.normal(size=(3, 150, 300)) * 10
JOBS = tuple(torch.from_numpy(x) for x in (
    _RNG.integers(0, 256, (8, 3, 34, 34)).astype(np.uint8),
    _RNG.integers(0, 256, (8, 3, 34, 34)).astype(np.uint8), np.full((8, 34, 34), 255, np.uint8)))
RUNS = {
    "dd": {"g": torch.from_numpy(G_DD), "kwargs": {"tol": 1e-6}},
    "sharded": {"g": torch.from_numpy(G_MG), "kwargs": {"tol": 1e-4}},
    "sharded_fixed": {"g": torch.from_numpy(G_MG), "kwargs": {"cycles": 3}},
    "rb_halo2": {"g": torch.from_numpy(G_DD), "kwargs": {"tol": 1e-4, "max_iters": 300,
                                                         "halo": 2}},
    "rb_halo8": {"g": torch.from_numpy(G_DD), "kwargs": {"tol": 1e-4, "max_iters": 300,
                                                         "halo": 8}},
    "rb_halo4": {"g": torch.from_numpy(G_DD), "kwargs": {"tol": 1e-4, "max_iters": 300}},
    "rb_overlap": {"g": torch.from_numpy(G_DD), "kwargs": {"tol": 1e-4, "max_iters": 300,
                                                           "overlap": True}},
    "engine": {"args": (SRC, DST, MASK, (150, 100)), "config": {"tol": 1e-5}},
    "engine_gspmd": {"args": (SRC, DST, MASK, (150, 100)), "path": "gspmd"},
    "engine_serve": {"args": (SRC, DST, MASK, (150, 100)), "config": {"mg_cycles": 3},
                     "loops": 2},
    "clone_tiled": {"args": (SRC, DST, MASK, (150, 100)), "kwargs": {"path": "gspmd"}},
    "edit_tiled": {"args": (DST, None, "illumination_change", (0.2, 0.4))},
    "dyn": {"g": torch.from_numpy(G_DYN), "hw": (150, 300), "kwargs": {"tol": 1e-4}},
    "batch": {"args": JOBS},
}
SHARD_MIN = 16
TIMEOUT = 240  # seconds for every rank of a run


@functools.lru_cache(maxsize=None)
def _single_process(shape):
    """Each run's u on a single-process CPU mesh of ``shape``."""
    saved, tiled.SHARD_MIN = tiled.SHARD_MIN, SHARD_MIN
    try:
        mesh = make_tile_mesh([torch.device("cpu")] * (shape[0] * shape[1]), shape)
        return {name: dist_check.run_one(name, run, mesh, "cpu")[0]
                for name, run in RUNS.items()}
    finally:
        tiled.SHARD_MIN = saved


def _spawn(world, tiles, shape, tmp_path):
    try:
        dist_check.free_port()
    except OSError as e:  # the environment forbids sockets entirely
        pytest.skip(f"no localhost sockets: {e}")
    torch.save(RUNS, tmp_path / "in.pt")
    torch.save(_single_process(shape), tmp_path / "expect.pt")
    ranks = dist_check.spawn(world, [
        "--device", "cpu", "--tiles", str(tiles), "--shape", *map(str, shape),
        "--input", str(tmp_path / "in.pt"), "--expect", str(tmp_path / "expect.pt"),
        "--shard-min", str(SHARD_MIN)], TIMEOUT)
    joined = "\n---\n".join(out for _, out in ranks)
    if any(rc != 0 for rc, _ in ranks):
        low = joined.lower()
        for marker in ("permission denied", "address already in use",
                       "connection refused"):  # localhost sockets refused
            if marker in low:
                pytest.skip(f"localhost sockets refused: {marker}")
        pytest.fail(joined[-6000:])
    return [dist_check.report_of(out) for _, out in ranks]


@pytest.mark.parametrize("world,tiles,shape", [(2, 4, (2, 4)), (4, 1, (2, 2))],
                         ids=["2proc_2x4", "4proc_2x2"])
def test_process_spanning_solves_bit_equal(world, tiles, shape, tmp_path):
    reports = _spawn(world, tiles, shape, tmp_path)
    want = _single_process(shape)
    tx = shape[1]
    for rank, rep in enumerate(reports):
        assert rep["rank"] == rank and rep["backend"] == "gloo" and rep["mesh"] == list(shape)
        assert rep["reinit_noop"]
        # the processes' devices joined in rank order: rank r owns its tiles' cells
        assert [tuple(c) for c in rep["cells"]] == [divmod(i, tx) for i in range(
            rank * tiles, (rank + 1) * tiles)]
        for name in RUNS:
            row = rep["solves"][name]
            assert row["equal"], (rank, name, row)  # the rank's whole u, bit for bit
            assert row["crossed_transfers"] > 0  # strips and collectives crossed ranks
        assert rep["solves"]["sharded_fixed"]["cycles"] == 3
        assert rep["solves"]["rb_halo2"]["iterations"] == 300
        # 20x14 / 20x28 tiles > 4s = 8: the interior-first schedule, 5 sweeps a tile a round
        assert rep["solves"]["rb_overlap"]["iterations"] == rep["solves"]["rb_halo4"][
            "iterations"]
        serve = rep["solves"]["engine_serve"]
        assert serve["gathers_per_frame"] == 0 and serve["crossed_bytes_per_frame"] > 0
        assert set(serve["resident_bytes"]) == {f"{iy},{ix}" for iy, ix in rep["cells"]}
    assert torch.equal(want["rb_overlap"], want["rb_halo4"])  # the schedules agree
    # every rank's DD result is bit-equal to this one: JAX's bar against the oracle
    u_ref = poisson_solve_dst(np.transpose(G_DD, (1, 2, 0)))[:, :, 0]
    err = np.abs(want["dd"].numpy()[0] - u_ref).max() / np.abs(u_ref).max()
    assert err < 1e-4, err
