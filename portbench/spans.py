"""The program's own spans and counters in a profile of a cell's requests.

``trace.summarize`` reads torch ops, runtime calls and device ops under the
harness's ``portbench.request`` span. This module reads what the port adds
inside it, found by rule and not by a list, so that a span or a counter a
later change adds to the port reaches the readers with no edit here:

- its spans: every ``user_annotation`` span whose name holds a dot, less
  the harness's own ``portbench.*`` (the port's ``core/trace.py`` names
  them ``<layer>.<what>``: ``engine.*``, ``pipeline.*``, ``solver.*``);
- its counters: every dict named ``COUNTS`` on a loaded module of the port
  (``program_counts``), each key as ``<module below the package>.<key>``:
  ``solvers.multigrid.COUNTS["cycles"]`` is ``solvers.multigrid.cycles``.
  A dict that several modules import is read under each of their names.

``summarize_program(events, requests, frames, counters)`` returns

- ``spans``: {span name: {"us", "count", "us_per_request"}};
- ``idle_by_span``: {innermost program span open, or None: the device's
  idle us inside the window}, each idle piece named as ``trace`` names it
  by host event;
- ``checks_in_frames_us``: the ``solver.check`` spans' us inside a
  ``pipeline.frame``;
- ``counters``: the counters' delta over the requests (``counts_delta``).

``harness.serve_traced`` puts it under the summary's ``"program"`` key,
where the readers in ``metrics/`` find it. ``frames`` counts every frame of
the requests, warm-up frames included.

Run as a script, it profiles one cell's ``trace_requests`` requests through
``harness.serve_traced`` and prints one JSON line (the program's readings,
the tables, the cell's per-layer metrics, the device ops and the
breakdown):

    python3 -m portbench.spans --workload <cell> --seed <n> [--out <file>]

from the root of a checkout that holds the port.
"""

from __future__ import annotations

import sys

from portbench import trace

PACKAGE = "seamlesscloneoptimization_tpu_torch"
HARNESS = "portbench."
PROGRAM_SOURCES = ("program_span", "program_counter")


def program_spans(events: list) -> list:
    """The program's spans: ``user_annotation`` events whose name holds a
    dot, less the harness's own."""
    return [e for e in events if e.get("cat") == "user_annotation" and "dur" in e
            and "." in e.get("name", "") and not e["name"].startswith(HARNESS)]


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


def _checks_in_frames_us(spans: list) -> float:
    """The ``solver.check`` spans' us that lie inside a ``pipeline.frame``."""
    frames = [(e["ts"], e["ts"] + e["dur"]) for e in spans if e["name"] == "pipeline.frame"]
    return sum(e["dur"] for e in spans if e["name"] == "solver.check"
               and any(a <= e["ts"] and e["ts"] + e["dur"] <= b for a, b in frames))


def summarize_program(events: list, requests: int, frames: int, counters: dict) -> dict:
    spans = program_spans(events)
    return {"requests": requests, "frames": frames,
            "spans": span_table(spans, requests),
            "idle_by_span": idle_by_span(events, spans),
            "checks_in_frames_us": _checks_in_frames_us(spans),
            "counters": counters}


def program_counts() -> dict:
    """A snapshot of every ``COUNTS`` dict on a loaded module of the port:
    {"<module below the package>.<key>": value} for each numeric value."""
    out = {}
    for name, mod in list(sys.modules.items()):
        if not name.startswith(PACKAGE + "."):
            continue
        counts = getattr(mod, "__dict__", {}).get("COUNTS")
        if isinstance(counts, dict):
            sub = name[len(PACKAGE) + 1:]
            out.update({f"{sub}.{k}": v for k, v in counts.items()
                        if isinstance(v, int | float) and not isinstance(v, bool)})
    return out


def counts_delta(before: dict, after: dict) -> dict:
    """Each counter's growth from ``before`` to ``after``; a counter that
    first appears in ``after`` (its module loaded meanwhile) from 0."""
    return {k: v - before.get(k, 0) for k, v in after.items()}


def readings(summary: dict) -> dict:
    """Every per-layer metric that ``BENCHMARK.json`` takes from the
    program's spans or counters, read from a summary, None where absent."""
    from portbench import load

    return {m["name"]: load.metric_reader(m["name"]).read(summary)
            for m in load.benchmark()["per_layer"] if m["source"] in PROGRAM_SOURCES}


def profile_cell(name: str, seed: int, device, tmpdir: str, cfg: dict | None = None,
                 spec: dict | None = None) -> dict:
    """One cell's traced requests through ``harness.serve_traced``:
    {"summary": its summary, "program": the summary's ``"program"``,
    "readings", "metrics": the cell's per-layer metrics}."""
    from portbench import harness, load
    from portbench.traffic import Reservoir

    cell = harness.prepare(name, seed, device, cfg, spec)
    s, _, _ = harness.serve_traced(cell, Reservoir(cell.traffic.sample, seed), tmpdir)
    metrics = {m["name"]: load.metric_reader(m["name"]).read(s)
               for m in load.cell(name)["per_layer"]}
    harness.free_program(cell)
    return {"summary": s, "program": s["program"], "readings": readings(s),
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
                       "device_ops": s["device_ops"],
                       "breakdown": trace.breakdown(s)})
    print(line, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
