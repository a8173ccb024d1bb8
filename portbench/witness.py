"""Chained frames against the reference in three precisions: does a clone
mode's chain have one answer that an independent reference can hold the
program to?

    python3 portbench/witness.py --workload headline-modes16 --seeds 21,22,23 \
        --flags 2 --frames 16

For each seed, on each (src, dst) pair of the cell's pool, with the cell's
mask and centre, one request of ``--frames`` chained frames in clone mode
``--flags``:

- the program's output after k frames (``timed_serve(loops=k - 1)``), k = 1
  to F;
- the reference's after k frames in float64, float32 and TF32
  (``reference.DstSolver``);
- the serve driver's ``compare`` of the program and of the float32 and
  TF32 references against the float64 reference at k = 1, 2, 4, 8, ..., F: if
  the references split from each other as far as the program splits from
  them, the chain has no answer to hold the program to beyond its first
  frames;
- the one-step check: the program's frame k + 1 against one float64
  reference frame run on the program's own frame k (the chain's rule read
  from the destination the frame before wrote), the worst over k.

One JSON line a seed. Needs the card, as a run does (``--device cpu`` for a
tiny rehearsal with ``--src-hw``/``--dst-hw``).
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import harness, load, reference  # noqa: E402
from portbench.drivers.serve import compare  # noqa: E402


def chain(src, dst, mask, center, flags, frames, solver) -> list:
    """The reference's image after each of ``frames`` chained frames."""
    out, cur = [], dst
    for _ in range(frames):
        cur = reference.serve_request(src, cur, mask, center, flags, 1, solver)
        out.append(cur)
    return out


def readings(name: str, seed: int, flags: int, frames: int, device: str, cfg=None) -> dict:
    import torch

    cell = harness.prepare(name, seed, device, cfg=cfg)
    mask = torch.from_numpy(cell.mask).to(cell.device)
    solvers = {p: reference.DstSolver(p, cell.device) for p in ("float64", "float32", "tf32")}
    ks = sorted({k for k in (1, 2, 4, 8, 16, 32, 64) if k < frames} | {frames})
    row = {"seed": seed, "flags": flags, "frames": frames, "pairs": []}
    for src, dst in cell.pool:
        prog = [cell.engine.timed_serve(src, dst, cell.mask, cell.center, loops=k - 1,
                                        flags=flags)[0] for k in range(1, frames + 1)]
        refs = {p: chain(src, dst, mask, cell.center, flags, frames, s)
                for p, s in solvers.items()}
        pair = {}
        for k in ks:
            r64 = refs["float64"][k - 1]
            pair[k] = {"program": compare(prog[k - 1], r64, cell.geom),
                       "ref_float32": compare(refs["float32"][k - 1], r64, cell.geom),
                       "ref_tf32": compare(refs["tf32"][k - 1], r64, cell.geom)}
        steps = [compare(prog[k], reference.serve_request(
            src, prog[k - 1], mask, cell.center, flags, 1, solvers["float64"]), cell.geom)
            for k in range(1, frames)]
        pair["one_step_worst"] = harness.worst(steps) if steps else None
        row["pairs"].append(pair)
    cell.engine.destroy()
    return row


def main(argv) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--flags", type=int, required=True)
    p.add_argument("--frames", type=int, required=True)
    p.add_argument("--device", default="cuda")
    p.add_argument("--src-hw", default=None, help="H,W: a smaller patch (rehearsal)")
    p.add_argument("--dst-hw", default=None, help="H,W: a smaller destination (rehearsal)")
    args = p.parse_args(argv)
    cfg = None
    if args.src_hw or args.dst_hw:
        cfg = dict(load.config(load.cell(args.workload)["config"]))
        for key, val in (("src_hw", args.src_hw), ("dst_hw", args.dst_hw)):
            if val:
                cfg[key] = [int(x) for x in val.split(",")]
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        row = readings(args.workload, seed, args.flags, args.frames, args.device, cfg)
        row["seconds"] = time.perf_counter() - t
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
