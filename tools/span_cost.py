"""The host's cost of one of the port's spans, with torch's profiler off and on.

    python3 tools/span_cost.py [--n 200000] [--n-on 20000]

Prints one JSON line, in us a span less an empty loop's us a step, the
least of 5 repeats: ``off``, ``core.trace.span`` with no profiler (the
shared no-op after one check); ``record_function_off``, an ungated
``torch.profiler.record_function`` with no profiler; ``on``, ``span``
under a profiler recording the CPU, and the card where there is one, as a
traced benchmark run records; with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile, record_function  # noqa: E402

from seamlesscloneoptimization_tpu_torch.core.trace import span  # noqa: E402


def _empty(n):
    for _ in range(n):
        pass


def _spans(n):
    for _ in range(n):
        with span("engine.request"):
            pass


def _record_functions(n):
    for _ in range(n):
        with record_function("engine.request"):
            pass


def _us_a_step(loop, n, repeats=5) -> float:
    best = float("inf")
    for _ in range(repeats):
        t = time.perf_counter()
        loop(n)
        best = min(best, time.perf_counter() - t)
    return best / n * 1e6


def _card() -> dict:
    if not torch.cuda.is_available():
        return {"card": None}
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True, timeout=20).stdout.strip()
    return {"card": out}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--n", type=int, default=200_000)
    p.add_argument("--n-on", type=int, default=20_000)
    args = p.parse_args(argv)
    empty = _us_a_step(_empty, args.n)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available()
                                     else [])
    on = float("inf")
    for _ in range(5):
        with profile(activities=acts):
            on = min(on, _us_a_step(_spans, args.n_on, repeats=1))
    print(json.dumps({"off": _us_a_step(_spans, args.n) - empty,
                      "record_function_off": _us_a_step(_record_functions, args.n) - empty,
                      "on": on - _us_a_step(_empty, args.n_on),
                      "empty_loop": empty, "n": args.n, "n_on": args.n_on,
                      "torch": torch.__version__, **_card()}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
