"""One rank of a multi-process tile-mesh run: the solves, the tiled clone and
the batch on a process-spanning mesh.

    python -m seamlesscloneoptimization_tpu_torch.parallel.dist_check \\
        --rank R --world N --port P --device cpu|cuda --tiles T --shape TY TX \\
        --input IN.pt [--expect EXPECT.pt] [--repeat 1] [--shard-min M]

Every rank joins the group with ``init_distributed("127.0.0.1:P", N, R)``
(and calls it a second time, which must do nothing), builds
``make_tile_mesh([device] * T, (TY, TX))`` over all N processes and runs
the solves of ``IN.pt``: a dict name -> {"g": (C, H, W) f32, "kwargs": {...}},
the solver chosen by the name's prefix (``dd``: ``solve_poisson_dd``,
``sharded``: ``solve_multigrid_sharded``, ``rb``: ``solve_redblack_tiled``),
each with ``return_info=True``, ``--repeat`` times; or, by the same rule,
one of the other runs of ``RUNS``: ``dyn`` ({"g", "hw", "kwargs"}:
``solve_multigrid_dyn_sharded``), ``engine`` ({"args": (src, dst, mask,
center), "config": CloneConfig's fields, "path", "loops"}:
``TiledSeamlessClone.run``, or ``timed_serve`` for ``loops`` frames),
``clone_tiled`` / ``edit_tiled`` ({"args", "kwargs"}:
``seamless_clone_tiled`` / ``local_edit_tiled``), ``batch`` ({"args":
(dests, patches, masks), "flags"}: ``clone_roi_batch(mesh=...)`` with the
fast DST solver). Every rank passes the same global inputs and gets the
whole result back. A run with ``"profile": True`` on CUDA is called once
more under ``torch.profiler``, and its row gets ``streams``: the device ops
of that call by stream (``stream_ops``). ``--expect`` holds name -> the result of the same run on
a single-process mesh (``run_one``): each rank's is held against it bit for
bit. ``--shard-min`` sets ``parallel/tiled.py:SHARD_MIN`` (small test grids).

Prints one JSON line: the rank, the transport's backend, whether the
second ``init_distributed`` left the group as it was, and per solve the
ms of the last run (host clock, the device synchronized), its cycles or
sweeps, the transfers and bytes this rank sent to other ranks in the last
run and a cycle, the ``rb_sweeps_tile`` and ``clamp_cast_paste`` launches,
the engine's metrics (ms a frame, bytes sent to other ranks a frame,
gathers a frame), and whether the result was equal to the expected one. Exits 1 when a result differs. ``spawn`` starts the
N ranks of such a run on this machine and collects them.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.distributed as dist

from seamlesscloneoptimization_tpu_torch.core.config import CloneConfig
from seamlesscloneoptimization_tpu_torch.ops import kernels as K
from seamlesscloneoptimization_tpu_torch.parallel import tiled
from seamlesscloneoptimization_tpu_torch.parallel import transport
from seamlesscloneoptimization_tpu_torch.parallel.batch import clone_roi_batch, fast_dst_solver
from seamlesscloneoptimization_tpu_torch.parallel.clone_tiled import (
    TiledSeamlessClone,
    local_edit_tiled,
    seamless_clone_tiled,
)
from seamlesscloneoptimization_tpu_torch.parallel.mesh import (
    init_distributed,
    make_tile_mesh,
    transport_backend,
)

SOLVERS = {"dd": tiled.solve_poisson_dd, "sharded": tiled.solve_multigrid_sharded,
           "rb": tiled.solve_redblack_tiled}


def solver_for(name: str):
    """The solve a run's name selects, by its prefix."""
    for prefix, fn in SOLVERS.items():
        if name.startswith(prefix):
            return fn
    raise ValueError(f"no solver for {name!r}: names start with one of {sorted(SOLVERS)}")


def _host(args) -> tuple:
    """A run's arguments with its tensors (the input file holds the images
    as tensors) as host numpy arrays, as the entry points take them."""
    return tuple(a.numpy() if isinstance(a, torch.Tensor) else a for a in args)


def _engine(run, mesh, device):
    eng = TiledSeamlessClone(CloneConfig(**run.get("config", {})), mesh=mesh,
                             path=run.get("path", "dd"))
    if run.get("loops") is None:
        out = eng.run(*_host(run["args"]))
        info = {}
    else:
        out, ms = eng.timed_serve(*_host(run["args"]), loops=run["loops"])
        info = {"ms_per_frame": ms, **{k: eng.metrics[k] for k in (
            "gathers_per_frame", "crossed_bytes_per_frame", "replicated_bytes_per_frame",
            "resident_bytes")}}
    return out, info


def _batch(run, mesh, device):
    args = [torch.as_tensor(x).to(device) for x in run["args"]]
    return clone_roi_batch(*args, run.get("flags", 1), fast_dst_solver(), mesh=mesh), {}


RUNNERS = {
    "dyn": lambda run, mesh, device: tiled.solve_multigrid_dyn_sharded(
        run["g"].to(device), run["hw"], mesh, return_info=True, **run.get("kwargs", {})),
    "engine": _engine,
    "clone_tiled": lambda run, mesh, device: (torch.from_numpy(seamless_clone_tiled(
        *_host(run["args"]), mesh=mesh, **run.get("kwargs", {}))), {}),
    "edit_tiled": lambda run, mesh, device: (torch.from_numpy(local_edit_tiled(
        *_host(run["args"]), mesh=mesh, **run.get("kwargs", {}))), {}),
    "batch": _batch,
}


def _op_kind(name: str) -> str:
    if "rb_sweeps_tile_kernel" in name:
        return "rb_sweeps_tile"
    for kind in ("DtoH", "HtoD", "DtoD", "Memset"):
        if kind in name:
            return kind
    low = name.lower()
    return "copy" if "copy" in low else "fill" if "fill" in low else "other"


def stream_ops(fn) -> dict:
    """{stream id: {kind: count}} of the device ops of one call of ``fn``
    under ``torch.profiler``: the ``rb_sweeps_tile`` kernels, the memcpys
    (``DtoH``, ``HtoD``, ``DtoD``), memsets, copy and fill kernels, the
    rest as ``other``. Empty when the profiler records no device op."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.events():
        if str(getattr(ev, "device_type", "")).endswith("CUDA"):
            per = out.setdefault(str(ev.device_resource_id), {})
            kind = _op_kind(ev.name)
            per[kind] = per.get(kind, 0) + 1
    return out


def run_one(name: str, run: dict, mesh, device) -> tuple:
    """(the result on the CPU, info) of one run of an input file on
    ``mesh``, chosen by the name's prefix (module docstring)."""
    for prefix, fn in RUNNERS.items():
        if name.startswith(prefix):
            out, info = fn(run, mesh, torch.device(device))
            return out.cpu(), info
    u, info = solver_for(name)(run["g"].to(device), mesh, return_info=True,
                               **run.get("kwargs", {}))
    return u.cpu(), info


def free_port() -> int:
    """A free localhost TCP port (OSError where sockets are refused)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(world: int, args: list[str], timeout: float) -> list[tuple[int, str]]:
    """Run ranks 0 .. world - 1 of this module with ``args`` on a free
    localhost port; returns each rank's (exit code, output). A rank still
    running after ``timeout`` seconds: every rank is killed and
    TimeoutError raised with their output so far."""
    root = Path(__file__).resolve().parents[2]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(root)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "seamlesscloneoptimization_tpu_torch.parallel.dist_check",
         "--rank", str(r), "--world", str(world), "--port", str(port), *args],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=root, env=env)
        for r in range(world)]
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(deadline - time.monotonic(), 0.1))[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        rest = [p.communicate()[0] for p in procs[len(outs):]]
        raise TimeoutError(f"ranks still running after {timeout} s:\n" + "\n---\n".join(
            outs + rest)) from None
    return [(p.returncode, out) for p, out in zip(procs, outs)]


def report_of(out: str) -> dict:
    """The JSON report line of a rank's output."""
    for line in reversed(out.splitlines()):
        if line.startswith("{"):
            return json.loads(line)
    raise ValueError(f"no report in the rank's output:\n{out[-4000:]}")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    ap.add_argument("--tiles", type=int, default=1)
    ap.add_argument("--shape", type=int, nargs=2, required=True)
    ap.add_argument("--input", required=True)
    ap.add_argument("--expect")
    ap.add_argument("--repeat", type=int, default=1)
    ap.add_argument("--shard-min", type=int)
    args = ap.parse_args(argv)
    torch.set_num_threads(1)  # ranks share the machine's cores
    if args.shard_min is not None:
        tiled.SHARD_MIN = args.shard_min
    init_distributed(f"127.0.0.1:{args.port}", args.world, args.rank)
    world = dist.group.WORLD
    init_distributed()  # the group is up: a no-op
    reinit_noop = dist.group.WORLD is world and dist.get_world_size() == args.world
    device = torch.device("cuda", 0) if args.device == "cuda" else torch.device("cpu")
    mesh = make_tile_mesh([device] * args.tiles, tuple(args.shape))
    runs = torch.load(args.input)
    expect = torch.load(args.expect) if args.expect else {}
    report = {"rank": args.rank, "backend": transport_backend(), "reinit_noop": reinit_noop,
              "mesh": list(mesh.shape), "cells": [list(c) for c in mesh.local_cells()],
              "solves": {}}
    ok = True
    for name, run in runs.items():
        for _ in range(args.repeat):
            dist.barrier()
            transport.reset_crossed()
            K.reset_launches()
            _sync(device)
            t0 = time.perf_counter()
            u, info = run_one(name, run, mesh, device)
            _sync(device)
            ms = (time.perf_counter() - t0) * 1e3
            row = {"ms": ms, **info, **{f"crossed_{k}": v for k, v in transport.CROSSED.items()},
                   "rb_sweeps_tile": K.LAUNCHES["rb_sweeps_tile"],
                   "clamp_cast_paste": K.LAUNCHES["clamp_cast_paste"]}
            steps = info.get("cycles", info.get("iterations"))
            if steps:
                row.update({f"crossed_{k}_per_step": v / steps
                            for k, v in transport.CROSSED.items()})
            if name in expect:
                row["equal"] = bool(torch.equal(u, expect[name]))
                row["max_abs_diff"] = float((u.double() - expect[name].double()).abs().max())
                ok &= row["equal"]
        if run.get("profile") and device.type == "cuda":
            dist.barrier()
            row["streams"] = stream_ops(lambda: run_one(name, run, mesh, device))
        report["solves"][name] = row
    print(json.dumps(report), flush=True)
    dist.barrier()
    dist.destroy_process_group()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
