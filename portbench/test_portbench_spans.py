"""``spans.py``: the program's spans and counters in a profile, on a
hand-made trace whose answers are worked out below, and on a tiny cell
profiled on the CPU, with the program's spans and counter and without them
(as a program that has neither reads: every reading None); a span and a
``COUNTS`` that the port does not have reach the summary by rule; the
readers of ``trace.summarize``'s keys read the same with the program's
summary beside them."""

import json
import sys
import tempfile
import types
from pathlib import Path

import pytest
import torch

from portbench import harness, load, spans, trace
from portbench.test_portbench_run import SEED, _cfg, _spec
from portbench.traffic import Reservoir

torch.set_num_threads(1)  # several test workers share the cores


def _ev(cat, name, ts, dur, tid=1, pid=1):
    return {"cat": cat, "name": name, "ts": ts, "dur": dur, "pid": pid, "tid": tid}


def _span(name, ts, dur):
    return _ev("user_annotation", name, ts, dur)


# One request of 2 frames, 0-100, each frame two V-cycles and a check. The
# device is busy 22-30, 36-48, 52-58, 67-78 and 81-88.
PROGRAM = [
    _span("engine.request", 2, 96), _span("engine.prepare", 2, 16),
    _span("engine.upload", 20, 5),
    _span("pipeline.frame", 25, 35), _span("pipeline.glue", 25, 3),
    _span("pipeline.rhs", 28, 7), _span("pipeline.solve", 35, 20),
    _span("solver.cycle", 36, 4), _span("solver.check", 40, 10), _span("solver.cycle", 50, 4),
    _span("pipeline.paste", 55, 5),
    _span("pipeline.frame", 60, 30), _span("pipeline.glue", 60, 2),
    _span("pipeline.rhs", 62, 4), _span("pipeline.solve", 66, 20),
    _span("solver.cycle", 67, 3), _span("solver.check", 70, 10), _span("solver.cycle", 80, 5),
    _span("pipeline.paste", 86, 4),
    _span("engine.sync", 90, 5), _span("engine.finish", 95, 3),
]
OTHER = [
    _span(trace.SPAN, 0, 100),
    _ev("cpu_op", "aten::copy_", 21, 3),
    _ev("cuda_runtime", "cudaStreamSynchronize", 41, 9),
    _ev("cuda_runtime", "cudaStreamSynchronize", 71, 9),
] + [_ev("kernel", "k", s, e - s, 7, 0) for s, e in
     ((22, 30), (36, 48), (52, 58), (67, 78), (81, 88))]
COUNTERS = {"solvers.multigrid.cycles": 4, "solvers.multigrid.checks": 2}
FRAMES = 2
# the readers of the program's spans and counters
PROGRAM_METRICS = ["engine.prep_ms_per_request", "engine.upload_ms_per_request",
                   "pipeline.host_ms_per_frame", "solver.cycles_per_frame",
                   "solver.checks_per_frame", "device.idle_unattributed_pct"]


def _program(events, counters):
    return spans.summarize_program(events, 1, FRAMES, counters)


def _read(name, summary):
    return load.metric_reader(name).read(summary)


def test_spans_and_idle_by_span():
    p = _program(OTHER + PROGRAM, COUNTERS)
    assert p["spans"]["pipeline.frame"] == {"us": 65.0, "count": 2, "us_per_request": 65.0}
    assert p["spans"]["solver.check"]["count"] == 2 and p["counters"] == COUNTERS
    assert p["checks_in_frames_us"] == 20
    # idle 0-22, 30-36, 48-52, 58-67, 78-81, 88-100, each piece under the
    # innermost program span open (None: none)
    assert p["idle_by_span"] == {
        None: 2 + 2, "engine.prepare": 16, "engine.request": 2, "engine.upload": 2,
        "pipeline.rhs": 5 + 4, "pipeline.solve": 1 + 1, "solver.check": 2 + 2,
        "solver.cycle": 2 + 1, "pipeline.paste": 2 + 2, "pipeline.glue": 2,
        "engine.sync": 5, "engine.finish": 3}
    s = trace.summarize(OTHER + PROGRAM, FRAMES, {"c": 3, "h": 9, "w": 9, "path": "mg_q"},
                        {}, {}, {})
    assert sum(p["idle_by_span"].values()) == s["window_us"] - s["busy_us"] == 56


@pytest.mark.parametrize("name,want", [
    ("engine.prep_ms_per_request", 0.016),
    ("engine.upload_ms_per_request", 0.005),
    ("pipeline.host_ms_per_frame", (65 - 20) / FRAMES * 1e-3),
    ("solver.cycles_per_frame", 2.0),
    ("solver.checks_per_frame", 1.0),
    ("device.idle_unattributed_pct", 100.0 * (4 + 2) / 56),
])
def test_readings_with_and_without_the_programs_spans(name, want):
    assert _read(name, {"program": _program(OTHER + PROGRAM, COUNTERS)}) == pytest.approx(want)
    # a program with neither spans nor counter, as before they existed
    assert _read(name, {"program": _program(OTHER, {})}) is None
    # a summary from before the program's was added to it
    assert _read(name, {}) is None


@pytest.mark.parametrize("cell", ["headline-clip16", "pano8k-clip16"])
def test_a_tiny_cell_profiled_on_the_cpu(cell, monkeypatch):
    """The readings of a profile of the port's CPU path; then the same cell
    with the spans off and no counter, as a program without them: every
    reading None, the cell's per-layer metrics unchanged in kind."""
    from seamlesscloneoptimization_tpu_torch.core import trace as port_trace

    run = spans.profile_cell(cell, SEED, "cpu", tempfile.gettempdir(), _cfg(cell), _spec(cell))
    frames = run["program"]["frames"]
    r = run["readings"]
    assert set(PROGRAM_METRICS) <= set(r)
    assert r["engine.prep_ms_per_request"] > 0 and r["pipeline.host_ms_per_frame"] > 0
    assert 0 <= r["device.idle_unattributed_pct"] <= 100
    assert run["program"]["spans"]["pipeline.frame"]["count"] == frames
    assert run["program"]["spans"]["engine.request"]["count"] == run["summary"]["requests"]
    if cell == "pano8k-clip16":  # the tiny grid's element multigrid: a cycle and a check
        assert r["solver.cycles_per_frame"] == r["solver.checks_per_frame"] == 1.0
    else:
        assert r["solver.cycles_per_frame"] == r["solver.checks_per_frame"] == 0.0
    monkeypatch.setattr(port_trace, "_recording", lambda: False)
    monkeypatch.setattr(spans, "program_counts", dict)
    bare = spans.profile_cell(cell, SEED, "cpu", tempfile.gettempdir(), _cfg(cell), _spec(cell))
    assert bare["program"]["spans"] == {} and bare["program"]["counters"] == {}
    assert all(bare["readings"][k] is None for k in PROGRAM_METRICS)
    assert bare["metrics"].keys() == run["metrics"].keys()
    assert bare["summary"]["aten_ops"] == run["summary"]["aten_ops"]


def test_spans_and_counters_the_program_adds_reach_the_summary():
    """A span with a new prefix and a ``COUNTS`` on a module the port does
    not have reach ``summarize_program`` by rule; the harness's own
    ``portbench.*`` spans and names without a dot do not."""
    events = OTHER + PROGRAM + [_span("batch.step", 99, 1), _span("portbench.warmup", 0, 3),
                                _span("ProfilerStep", 0, 99)]
    p = _program(events, COUNTERS)
    assert p["spans"]["batch.step"] == {"us": 1.0, "count": 1, "us_per_request": 1.0}
    assert not {"portbench.request", "portbench.warmup", "ProfilerStep"} & set(p["spans"])
    # the device idles 98-100 after engine.request: 99-100 under the new span
    assert p["idle_by_span"]["batch.step"] == 1 and p["idle_by_span"][None] == 2 + 1
    assert p == {**_program(OTHER + PROGRAM, COUNTERS), "spans": p["spans"],
                 "idle_by_span": p["idle_by_span"]}


def test_a_new_counts_module_is_found_by_rule(monkeypatch):
    name = spans.PACKAGE + ".parallel.made_up_batch"
    mod = types.ModuleType(name)
    mod.COUNTS = {"groups": 3, "jobs": 192, "flag": True, "label": "x"}
    monkeypatch.setitem(sys.modules, name, mod)
    monkeypatch.setitem(sys.modules, "made_up_outside.parallel", types.SimpleNamespace(
        COUNTS={"groups": 1}))
    before = spans.program_counts()
    assert before["parallel.made_up_batch.groups"] == 3
    assert before["parallel.made_up_batch.jobs"] == 192
    assert "parallel.made_up_batch.flag" not in before
    assert "parallel.made_up_batch.label" not in before
    assert not [k for k in before if k.startswith("made_up_outside")]
    mod.COUNTS["groups"] += 2
    delta = spans.counts_delta(before, spans.program_counts())
    assert delta["parallel.made_up_batch.groups"] == 2
    assert delta["parallel.made_up_batch.jobs"] == 0
    assert spans.counts_delta({}, {"a.b": 5}) == {"a.b": 5}


def test_a_new_span_and_counter_reach_a_profiled_cell(monkeypatch):
    """A tiny cell profiled through ``harness.serve_traced`` on the CPU, its
    requests wrapped in a ``batch.step`` span of the port's ``span`` that
    counts on a ``COUNTS`` of a module loaded for the test: both reach
    ``summary["program"]`` with no edit to the harness or to ``spans.py``."""
    from seamlesscloneoptimization_tpu_torch.core.engine import SeamlessClone
    from seamlesscloneoptimization_tpu_torch.core.trace import span

    name = spans.PACKAGE + ".parallel.made_up_batch"
    mod = types.ModuleType(name)
    mod.COUNTS = {"steps": 0}
    monkeypatch.setitem(sys.modules, name, mod)
    real = SeamlessClone.timed_serve

    def step(self, *a, **k):
        with span("batch.step"):
            mod.COUNTS["steps"] += 1
            return real(self, *a, **k)

    monkeypatch.setattr(SeamlessClone, "timed_serve", step)
    cell = harness.prepare("headline-clip16", SEED, "cpu", _cfg("headline-clip16"),
                           _spec("headline-clip16"))
    s, attempted, failed = harness.serve_traced(cell, Reservoir(1, SEED),
                                                tempfile.gettempdir())
    assert failed == 0
    assert s["program"]["spans"]["batch.step"]["count"] == attempted
    assert s["program"]["counters"]["parallel.made_up_batch.steps"] == attempted
    assert s["program"]["spans"]["engine.request"]["count"] == attempted


# -- the readers of trace.summarize's keys, with the program's summary beside


def _old_kernel_table(device_ops, costs, geom, peaks):
    """``trace.kernel_table`` before costs resolved per geometry: the first
    file whose names match owns a kernel."""
    import re

    compiled = {k: [re.compile(p) for p in mod.NAMES] for k, mod in costs.items()}
    table, unmatched = {}, {}
    for name, (us, n, cat) in device_ops.items():
        if cat != "kernel" or trace.GEMM.search(name):
            continue
        owner = next((k for k, pats in compiled.items() if any(p.search(name) for p in pats)),
                     None)
        if owner is None:
            unmatched[name] = unmatched.get(name, 0.0) + us
            continue
        row = table.setdefault(owner, {"us": 0.0, "launches": 0})
        row["us"] += us
        row["launches"] += n
    for k, row in table.items():
        c = costs[k].cost(geom, row["launches"])
        row["bound_us"] = None if c is None else 1e6 * max(
            c[1] / peaks["hbm_bytes_per_s"], c[0] / peaks["fp32_flops_per_s"])
    return table, unmatched


def _recorded_headline():
    doc = json.loads((Path(__file__).resolve().parent / "fixtures" / "headline_request.json")
                     .read_text())
    return doc["traceEvents"], doc["frames"], doc["geom"], doc["launches"]


def _hand_made():
    return OTHER + PROGRAM, FRAMES, {"c": 3, "bh": 11, "bw": 11, "h": 9, "w": 9,
                                     "path": "mg_q"}, {"mg_ud_q": 4}


def _profiled_on_the_cpu():
    cell = harness.prepare("pano8k-clip16", SEED, "cpu", _cfg("pano8k-clip16"),
                           _spec("pano8k-clip16"))
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(2):
            with record_function(trace.SPAN):
                cell.call(cell.traffic.request(i))
    path = Path(tempfile.mkdtemp()) / "t.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    path.unlink()
    path.parent.rmdir()
    return events, 32, cell.geom, {"mg_ud_q": 8}


@pytest.mark.parametrize("events_of", [_recorded_headline, _hand_made, _profiled_on_the_cpu])
def test_existing_readers_read_the_same_beside_the_programs_summary(events_of, monkeypatch):
    events, frames, geom, launches = events_of()
    args = (events, frames, geom, load.kernel_costs(), load.peaks(), launches)
    new = trace.summarize(*args)
    new["program"] = spans.summarize_program(events, new["requests"], frames, COUNTERS)
    monkeypatch.setattr(trace, "kernel_table", _old_kernel_table)
    old = trace.summarize(*args)
    assert set(old) < set(new) and all(old[k] == new[k] for k in old)
    existing = [m["name"] for m in load.benchmark()["per_layer"]
                if m["name"] not in PROGRAM_METRICS]
    assert len(existing) == 7
    for name in existing:
        assert _read(name, old) == _read(name, new), name
