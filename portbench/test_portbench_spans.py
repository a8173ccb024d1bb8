"""``spans.py``: the program's spans and counters in a profile, on a
hand-made trace whose answers are worked out below, and on a tiny cell
profiled on the CPU, with the program's spans and counter and without them
(as a program that has neither reads: every reading None)."""

import tempfile

import pytest
import torch

from portbench import spans, trace
from portbench.test_portbench_run import SEED, _cfg, _spec

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
COUNTERS = {"cycles": 4, "checks": 2}
FRAMES = 2


def _program(events, counters):
    return spans.summarize_program(events, 1, FRAMES, counters)


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
    ("pipeline.host_ms_per_frame", (65 - 20) / FRAMES * 1e-3),
    ("solver.cycles_per_frame", 2.0),
    ("solver.checks_per_frame", 1.0),
    ("device.idle_unattributed_pct", 100.0 * (4 + 2) / 56),
])
def test_readings_with_and_without_the_programs_spans(name, want):
    assert spans.readings(_program(OTHER + PROGRAM, COUNTERS))[name] == pytest.approx(want)
    # a program with neither spans nor counter, as before they existed
    assert spans.readings(_program(OTHER, None))[name] is None


@pytest.mark.parametrize("cell", ["headline-clip16", "pano8k-clip16"])
def test_a_tiny_cell_profiled_on_the_cpu(cell, monkeypatch):
    """The readings of a profile of the port's CPU path; then the same cell
    with the spans off and no counter, as a program without them: every
    reading None, the cell's per-layer metrics unchanged in kind."""
    from seamlesscloneoptimization_tpu_torch.core import trace as port_trace

    run = spans.profile_cell(cell, SEED, "cpu", tempfile.gettempdir(), _cfg(cell), _spec(cell))
    frames = run["program"]["frames"]
    r = run["readings"]
    assert r["engine.prep_ms_per_request"] > 0 and r["pipeline.host_ms_per_frame"] > 0
    assert 0 <= r["device.idle_unattributed_pct"] <= 100
    assert run["program"]["spans"]["pipeline.frame"]["count"] == frames
    assert run["program"]["spans"]["engine.request"]["count"] == run["summary"]["requests"]
    if cell == "pano8k-clip16":  # the tiny grid's element multigrid: a cycle and a check
        assert r["solver.cycles_per_frame"] == r["solver.checks_per_frame"] == 1.0
    else:
        assert r["solver.cycles_per_frame"] == r["solver.checks_per_frame"] == 0.0
    monkeypatch.setattr(port_trace, "_recording", lambda: False)
    monkeypatch.setattr(spans, "program_counts", lambda: None)
    bare = spans.profile_cell(cell, SEED, "cpu", tempfile.gettempdir(), _cfg(cell), _spec(cell))
    assert bare["program"]["spans"] == {} and bare["program"]["counters"] is None
    assert all(v is None for v in bare["readings"].values())
    assert bare["metrics"].keys() == run["metrics"].keys()
    assert bare["summary"]["aten_ops"] == run["summary"]["aten_ops"]
