"""The readings that the limits in ``limits/<cell>.json`` are set from.

    python3 portbench/calibrate.py --workload <cell> --seeds 11,12,13 --seconds 2

In one process, for each seed: a short window of the cell's traffic on the
program, the reference's answers to the sampled requests, and the numbers
of the driver's ``compare`` (the worst over the sample) for

- ``program``: the program as the configuration states it (the lower
  reading);
- ``control_ref_tf32``: the reference itself, computed with TF32 GEMMs
  (``reference.DstSolver("tf32")``), put in the program's place: the
  control of every cell (the upper reading);
- on a DST-GEMM configuration also the program's own lower paths on the
  same requests: ``control_prog_tf32`` (``allow_tf32`` on: its FP32 GEMMs
  in TF32) and ``control_prog_bf16`` (``CloneConfig(precision="default")``,
  where the driver's entry point takes a precision: the API does not).

One JSON line a seed. Needs the card, as a run does.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import harness, load  # noqa: E402
from portbench.traffic import Reservoir  # noqa: E402


def controls(cell, samples, refs) -> dict:
    """The controls' worst numbers on the sampled requests, each request
    sent through the cell's driver again."""
    import torch

    out = {"control_ref_tf32": harness.worst(harness.judge(
        cell, harness.references(cell, samples, "tf32"), refs))}
    if cell.cfg["path"] != "dst_pair":
        return out
    if cell.device.type == "cuda":  # TF32 exists on the card alone
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            got = [cell.call(req)[0] for req, _ in samples]
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        out["control_prog_tf32"] = harness.worst(harness.judge(cell, got, refs))
    try:
        bf16 = cell.driver.engine({**cell.cfg["clone_config"], "precision": "default"},
                                  cell.device)
    except ValueError:  # an entry point with no precision setting (the API)
        return out
    got = [cell.call(req, bf16)[0] for req, _ in samples]
    out["control_prog_bf16"] = harness.worst(harness.judge(cell, got, refs))
    bf16.destroy()
    return out


def readings(name: str, seed: int, seconds: float, device="cuda", engine=None) -> dict:
    """One seed's readings: the program's and the controls'."""
    cell = harness.prepare(name, seed, device, engine=engine)
    sampler = Reservoir(cell.traffic.sample, seed)
    window = harness.serve(cell, seconds, sampler)
    refs = harness.references(cell, sampler.items)
    row = {"seed": seed, "requests": window["attempted"], "failed": window["failed"],
           "program": harness.worst(harness.judge(cell, [o for _, o in sampler.items], refs))}
    row.update(controls(cell, sampler.items, refs))
    return row, cell.engine


def main(argv) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)
    limits = load.limits(args.workload)
    engine = None
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        row, engine = readings(args.workload, seed, args.seconds, engine=engine)
        row["verdicts"] = {k: harness.verdict(v, limits)[0] for k, v in row.items()
                           if k == "program" or k.startswith("control")}
        row["seconds"] = time.perf_counter() - t
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
