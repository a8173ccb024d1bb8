"""The program's own spans and counters in a profile of a cell's requests.

``trace.summarize`` reads torch ops, runtime calls and device ops under the
harness's ``portbench.request`` span. This module reads what the port adds
inside it: its spans (``engine.*``, ``pipeline.*``, ``solver.*``; the port's
``core/trace.py``) and its solver counter (``solvers.multigrid.COUNTS``).
``summarize_program(events, requests, frames, counters)`` returns

- ``spans``: {span name: {"us", "count", "us_per_request"}};
- ``idle_by_span``: {innermost program span open, or None: the device's
  idle us inside the window}, each idle piece named as ``trace`` names it
  by host event;
- ``counters``: the ``COUNTS`` delta over the requests, or None where the
  program has no such counter;

and ``readings(program)`` the five per-layer numbers of ``READERS``, each
None where its span or counter is absent (a program without them).
``frames`` counts every frame of the requests, warm-up frames included.

Run as a script, it profiles one cell's ``trace_requests`` requests as
``harness.serve_traced`` does, with ``COUNTS`` read before and after, and
prints one JSON line (the readings, the tables, the cell's per-layer
metrics of ``metrics/`` and the breakdown):

    python3 -m portbench.spans --workload <cell> --seed <n> [--out <file>]

from the root of a checkout that holds the port.
"""

from __future__ import annotations

import importlib

from portbench import trace

PREFIXES = ("engine.", "pipeline.", "solver.")
REQUEST = "engine.request"


def program_spans(events: list) -> list:
    """The program's spans: ``user_annotation`` events named with one of
    ``PREFIXES``."""
    return [e for e in events if e.get("cat") == "user_annotation" and "dur" in e
            and e.get("name", "").startswith(PREFIXES)]


def span_table(spans: list, requests: int) -> dict:
    table: dict = {}
    for e in spans:
        row = table.setdefault(e["name"], {"us": 0.0, "count": 0})
        row["us"] += e["dur"]
        row["count"] += 1
    for row in table.values():
        row["us_per_request"] = row["us"] / max(requests, 1)
    return table


def _window_and_gaps(events: list):
    """(w0, w1, idle gaps) as ``trace.summarize`` takes them: the window from
    the first request span's start to the last one's end, the gaps between
    the union of device ops inside it."""
    reqs = sorted((e["ts"], e["dur"]) for e in events
                  if e.get("cat") == "user_annotation" and e.get("name") == trace.SPAN)
    if not reqs:
        raise ValueError(f"no {trace.SPAN} span in the trace")
    w0, w1 = reqs[0][0], max(s + d for s, d in reqs)
    busy = trace._union((max(e["ts"], w0), min(e["ts"] + e["dur"], w1)) for e in events
                        if e.get("cat") in trace.DEVICE_CATS and "dur" in e
                        and e["ts"] < w1 and e["ts"] + e["dur"] > w0)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    return w0, w1, [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]


def idle_by_span(events: list, spans: list) -> dict:
    """{innermost program span open, or None: idle us}."""
    w0, w1, gaps = _window_and_gaps(events)
    inside = [e for e in spans if e["ts"] < w1 and e["ts"] + e["dur"] > w0]
    idle = trace._idle_by_host(gaps, inside, w0, w1)
    return {(None if k == "(no host event)" else k): v for k, v in idle.items()}


def summarize_program(events: list, requests: int, frames: int,
                      counters: dict | None) -> dict:
    spans = program_spans(events)
    return {"requests": requests, "frames": frames,
            "spans": span_table(spans, requests),
            "idle_by_span": idle_by_span(events, spans),
            "checks_in_frames_us": _checks_in_frames_us(spans),
            "counters": counters}


def _checks_in_frames_us(spans: list) -> float:
    """The ``solver.check`` spans' us that lie inside a ``pipeline.frame``."""
    frames = [(e["ts"], e["ts"] + e["dur"]) for e in spans if e["name"] == "pipeline.frame"]
    return sum(e["dur"] for e in spans if e["name"] == "solver.check"
               and any(a <= e["ts"] and e["ts"] + e["dur"] <= b for a, b in frames))


def _prep_ms_per_request(p: dict):
    """``engine.prepare``'s ms a request: validation, mask prep, ``auto``
    and the cache lookups on the host."""
    row = p["spans"].get("engine.prepare")
    return None if row is None or not p["requests"] else row["us"] / p["requests"] * 1e-3


def _host_ms_per_frame(p: dict):
    """The host's enqueue time a frame: ``pipeline.frame`` less the
    ``solver.check`` waits inside it, in ms."""
    row = p["spans"].get("pipeline.frame")
    if row is None or not p["frames"]:
        return None
    return (row["us"] - p["checks_in_frames_us"]) / p["frames"] * 1e-3


def _per_frame(key: str):
    def read(p: dict):
        c = p["counters"]
        return None if c is None or key not in c or not p["frames"] else c[key] / p["frames"]
    return read


def _idle_unattributed_pct(p: dict):
    """% of the device's idle time with no program span below
    ``engine.request`` open: under the request span alone, or outside it."""
    idle = p["idle_by_span"]
    total = sum(idle.values())
    if REQUEST not in p["spans"] or total <= 0:
        return None
    return 100.0 * (idle.get(None, 0.0) + idle.get(REQUEST, 0.0)) / total


READERS = {
    "engine.prep_ms_per_request": _prep_ms_per_request,
    "pipeline.host_ms_per_frame": _host_ms_per_frame,
    "solver.cycles_per_frame": _per_frame("cycles"),
    "solver.checks_per_frame": _per_frame("checks"),
    "device.idle_unattributed_pct": _idle_unattributed_pct,
}


def readings(program: dict) -> dict:
    return {name: read(program) for name, read in READERS.items()}


def program_counts() -> dict | None:
    """The program's ``solvers.multigrid.COUNTS``, or None where it has none."""
    try:
        mod = importlib.import_module("seamlesscloneoptimization_tpu_torch.solvers.multigrid")
    except ImportError:
        return None
    return getattr(mod, "COUNTS", None)


def profile_cell(name: str, seed: int, device, tmpdir: str, cfg: dict | None = None,
                 spec: dict | None = None) -> dict:
    """One cell's traced requests, profiled as ``harness.serve_traced``
    profiles them: {"summary": trace's, "program": ``summarize_program``'s,
    "readings", "metrics": the cell's per-layer metrics}."""
    import json
    import os

    from torch.profiler import ProfilerActivity, profile, record_function

    from portbench import harness, load
    from seamlesscloneoptimization_tpu_torch.ops import kernels as K

    cell = harness.prepare(name, seed, device, cfg, spec)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cell.device.type == "cuda"
                                     else [])
    counts = program_counts()
    before = None if counts is None else dict(counts)
    K.reset_launches()
    frames = 0
    with profile(activities=acts) as prof:
        for i in range(cell.traffic.trace_requests):
            req = cell.traffic.request(i)
            with record_function(trace.SPAN):
                cell.call(req)
            frames += req.frames
    launches = dict(K.LAUNCHES)
    delta = None if counts is None else {k: counts[k] - before[k] for k in before}
    path = os.path.join(tmpdir, f"portbench_spans_{os.getpid()}.json")
    prof.export_chrome_trace(path)
    try:
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    s = trace.summarize(events, frames, cell.geom, load.kernel_costs(), load.peaks(), launches)
    program = summarize_program(events, s["requests"], frames, delta)
    metrics = {m["name"]: load.metric_reader(m["name"]).read(s)
               for m in load.cell(name)["per_layer"]}
    cell.engine.destroy()
    return {"summary": s, "program": program, "readings": readings(program),
            "metrics": metrics}


def main(argv=None) -> int:
    import argparse
    import json
    import tempfile

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", help="also write the line to this file")
    args = p.parse_args(argv)
    r = profile_cell(args.workload, args.seed, args.device, tempfile.gettempdir())
    s = r["summary"]
    line = json.dumps({"workload": args.workload, "seed": args.seed,
                       "readings": r["readings"], "metrics": r["metrics"],
                       "spans": r["program"]["spans"],
                       "idle_by_span": {str(k): v for k, v in
                                        r["program"]["idle_by_span"].items()},
                       "counters": r["program"]["counters"],
                       "window_us": s["window_us"], "busy_us": s["busy_us"],
                       "launches": {k: v for k, v in s["launches"].items() if v},
                       "breakdown": trace.breakdown(s)})
    print(line, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
