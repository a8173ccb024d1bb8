"""The port's spans and its solver counter, on the CPU.

A ``timed_serve`` and a ``run`` under ``torch.profiler`` on a DST-GEMM and a
quarter-plane multigrid engine: the span names and their nesting, one
``engine.request`` a call and a ``pipeline.frame`` a frame; the spans add
no torch op and leave ``portbench/trace.py``'s summary as it was. Without
a profiler ``span`` is the shared no-op and never enters
``record_function``. ``solvers.multigrid.COUNTS`` against ``return_info``
on every multigrid path and against the quarter chain's kernel calls
(what ``LAUNCHES`` counts on the card, where ``tests/test_torch_cuda.py``
holds it to the counter itself).
"""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from portbench import load
from portbench import trace as bench_trace
from seamlesscloneoptimization_tpu_torch.core import trace
from seamlesscloneoptimization_tpu_torch.core.config import CloneConfig
from seamlesscloneoptimization_tpu_torch.core.engine import SeamlessClone
from seamlesscloneoptimization_tpu_torch.ops import kernels as K
from seamlesscloneoptimization_tpu_torch.solvers import jacobi as TJ
from seamlesscloneoptimization_tpu_torch.solvers import multigrid as TM
from seamlesscloneoptimization_tpu_torch.solvers.multigrid_dyn import solve_dyn_window

# Several pytest-xdist workers share the cores: one intra-op thread each keeps
# torch's OpenMP pools from oversubscribing them. Results do not depend on it.
torch.set_num_threads(1)

# (src_hw, dst_hw, center, config, timed loops): a DST-GEMM ROI, and a ROI
# whose 520 x 528 interior is above the 2^18-point gate of the quarter chain
ENGINES = {
    "dst_gemm": ((60, 80), (120, 160), (80, 60), CloneConfig(), 2),
    "mg_q": ((524, 532), (600, 640), (320, 300), CloneConfig(solver="multigrid"), 1),
}
PARENT = {
    "engine.prepare": "engine.request", "engine.upload": "engine.request",
    "engine.sync": "engine.request", "engine.finish": "engine.request",
    "engine.bases_build": "engine.prepare", "pipeline.frame": "engine.request",
    "pipeline.glue": "pipeline.frame", "pipeline.rhs": "pipeline.frame",
    "pipeline.solve": "pipeline.frame", "pipeline.paste": "pipeline.frame",
    "solver.cycle": "pipeline.solve", "solver.check": "pipeline.solve",
    "solver.basis_build": "solver.cycle", "engine.request": None,
}


def _inputs(kind):
    (hs, ws), (hd, wd), center, cfg, loops = ENGINES[kind]
    rng = np.random.default_rng(7)
    src = rng.integers(0, 256, (hs, ws, 3), dtype=np.uint8)
    dst = rng.integers(0, 256, (hd, wd, 3), dtype=np.uint8)
    mask = np.zeros((hs, ws), np.uint8)
    mask[1:-1, 1:-1] = 255
    return src, dst, mask, center, cfg, loops


def _events(prof, tmp_path):
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return json.loads(path.read_text())["traceEvents"]


def _program(events):
    return sorted((e for e in events if e.get("cat") == "user_annotation"
                   and e["name"].split(".")[0] in ("engine", "pipeline", "solver")),
                  key=lambda e: (e["ts"], -e["dur"]))


def _parent(e, spans):
    """The innermost other span around ``e``."""
    around = [p for p in spans if p is not e and p["ts"] <= e["ts"]
              and e["ts"] + e["dur"] <= p["ts"] + p["dur"]]
    return min(around, key=lambda p: p["dur"])["name"] if around else None


def _profiled(kind, tmp_path, spans_on=True):
    """A fresh engine's ``timed_serve`` and ``run`` under the profiler, each
    inside the benchmark's request span: (events, engine, frames served)."""
    src, dst, mask, center, cfg, loops = _inputs(kind)
    eng = SeamlessClone(cfg, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        if not spans_on:
            trace._recording = lambda: False
        try:
            with record_function(bench_trace.SPAN):
                eng.timed_serve(src, dst, mask, center, loops=loops)
            with record_function(bench_trace.SPAN):
                eng.run(src, dst, mask, center)
        finally:
            trace._recording = torch._C._autograd._profiler_enabled
    return _events(prof, tmp_path), eng, loops + 1


def test_span_without_a_profiler_is_the_shared_noop(monkeypatch):
    assert trace.span("engine.request", "seq=1") is trace.span("pipeline.frame") is trace._OFF

    def refuse(*a, **k):
        raise AssertionError("record_function entered without a profiler")

    monkeypatch.setattr(trace, "record_function", refuse)
    src, dst, mask, center, cfg, loops = _inputs("dst_gemm")
    eng = SeamlessClone(cfg, device="cpu")
    eng.timed_serve(src, dst, mask, center, loops=loops)
    eng.run(src, dst, mask, center)


def test_span_under_a_profiler_records():
    with profile(activities=[ProfilerActivity.CPU]):
        s = trace.span("engine.request", "seq=1")
        assert isinstance(s, record_function) and s is not trace._OFF


@pytest.mark.parametrize("kind", sorted(ENGINES))
def test_spans_and_their_nesting(kind, tmp_path):
    events, eng, frames = _profiled(kind, tmp_path)
    spans = _program(events)
    names = [e["name"] for e in spans]
    assert names.count("engine.request") == 2  # one a call
    assert names.count("pipeline.frame") == frames + 1  # F served, 1 run
    for name in ("pipeline.glue", "pipeline.rhs", "pipeline.solve", "pipeline.paste"):
        assert names.count(name) == frames + 1
    assert names.count("engine.prepare") == names.count("engine.upload") == 2
    assert names.count("engine.finish") == 2 and names.count("engine.sync") == 2
    for e in spans:
        assert _parent(e, spans) == PARENT[e["name"]], e["name"]
    reqs = [e for e in spans if e["name"] == "engine.request"]
    first_frames = [e for e in spans if e["name"] == "pipeline.frame"
                    and reqs[0]["ts"] <= e["ts"] <= reqs[0]["ts"] + reqs[0]["dur"]]
    assert len(first_frames) == frames
    if kind == "dst_gemm":
        assert names.count("engine.bases_build") == 1  # the first request's miss
        assert "solver.cycle" not in names and "solver.check" not in names
    else:
        assert names.count("solver.basis_build") == 1
        assert names.count("solver.cycle") == 4 * (frames + 1)
        assert names.count("solver.check") == 2 * (frames + 1)
        assert eng.metrics["solver_resolved"] == "multigrid"


@pytest.mark.parametrize("kind", sorted(ENGINES))
def test_spans_add_no_torch_op(kind, tmp_path):
    """The same torch ops, in the same order, with the spans on and off."""

    def ops(events):
        cpu_ops = [e for e in events if e.get("cat") == "cpu_op"]
        return [e["name"] for e in sorted(cpu_ops, key=lambda e: (e["ts"], -e["dur"]))]

    on, _, _ = _profiled(kind, tmp_path)
    off, _, _ = _profiled(kind, tmp_path, spans_on=False)
    assert not _program(off) and _program(on)
    assert ops(on) == ops(off)


def test_spans_leave_the_benchmark_summary_as_it_was(tmp_path):
    """``summarize`` of a trace with the program's spans and of the same
    trace without them: busy_us, aten_ops, host_us and launches agree, and
    the idle time is the same in all."""
    events, _, frames = _profiled("mg_q", tmp_path)
    program = {id(e) for e in _program(events)}
    bare = [e for e in events if id(e) not in program]

    def summary(evs):
        return bench_trace.summarize(evs, frames + 1, {"c": 3, "h": 520, "w": 528,
                                                       "path": "mg_q"},
                                     load.kernel_costs(), load.peaks(), {"mg_ud_q": 8})

    a, b = summary(events), summary(bare)
    for key in ("busy_us", "aten_ops", "host_us", "launches", "window_us", "requests"):
        assert a[key] == b[key], key
    assert sum(a["idle_by_host"].values()) == pytest.approx(sum(b["idle_by_host"].values()))


@pytest.mark.parametrize("kind", sorted(ENGINES))
def test_timed_serve_publishes_cycles_and_checks(kind):
    src, dst, mask, center, cfg, loops = _inputs(kind)
    eng = SeamlessClone(cfg, device="cpu")
    eng.timed_serve(src, dst, mask, center, loops=loops)  # the first request: bases
    before = dict(TM.COUNTS)
    eng.timed_serve(src, dst, mask, center, loops=loops)
    delta = {k: TM.COUNTS[k] - before[k] for k in before}
    want = (0.0, 0.0) if kind == "dst_gemm" else (4.0, 2.0)
    assert (eng.metrics["cycles_per_frame"], eng.metrics["checks_per_frame"]) == want
    # the warm-up frame counts in the request, not in the timed frames
    assert delta == {"cycles": want[0] * (loops + 1), "checks": want[1] * (loops + 1)}


def _rhs(h, w, seed=3):
    return torch.from_numpy(np.random.default_rng(seed).normal(size=(3, h, w))
                            .astype(np.float32) * 40)


# (h, w, solve_multigrid keywords): every chain, tolerance and fixed mode
SOLVES = {
    "q tol": (520, 528, dict(padded="q", use_pallas=True)),
    "q fixed": (520, 528, dict(padded="q", use_pallas=True, cycles=3)),
    "q check-first": (520, 528, dict(padded="q", use_pallas=True, tol=0.05)),
    "q warm": (520, 528, dict(padded="q", use_pallas=True, u0="warm")),
    "t tol": (520, 528, dict(padded="t", use_pallas=True)),
    "dense tol": (520, 528, dict(padded=True, use_pallas=True)),
    "element tol": (150, 170, dict(use_pallas=False)),
    "element fixed": (150, 170, dict(use_pallas=False, cycles=2)),
    "pcg": (150, 170, dict(use_pallas=False, pcg=True)),
    "fmg": (150, 170, dict(use_pallas=False, fmg_start=True)),
}


@pytest.mark.parametrize("name", sorted(SOLVES))
def test_counts_match_return_info(name):
    h, w, kw = SOLVES[name]
    g = _rhs(h, w)
    if kw.get("u0") == "warm":
        kw = dict(kw, u0=TM.solve_multigrid(g, padded="q", use_pallas=True, tol=0.05))
    before = dict(TM.COUNTS)
    spans = []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _, info = TM.solve_multigrid(g, return_info=True, **kw)
    spans = [e.name for e in prof.events() if e.name.startswith("solver.")]
    cycles, checks = (TM.COUNTS[k] - before[k] for k in ("cycles", "checks"))
    # pcg counts its preconditioner's V-cycles: one before the first iteration
    assert cycles == info["cycles"] + (1 if name == "pcg" else 0)
    assert spans.count("solver.cycle") == cycles and spans.count("solver.check") == checks
    if "fixed" in name:
        assert checks == 1  # return_info's read alone
    elif name == "q tol":  # the check-free burst, a check a cycle after it, then the read
        assert checks == cycles - TM._tol_burst(1e-4, 60) + 1 + 1
        assert (cycles, checks) == (4, 3)
    else:
        assert checks >= 2


def test_dyn_window_counts():
    g = _rhs(100, 120)
    before = dict(TM.COUNTS)
    _, info = solve_dyn_window(g, (127, 127), return_info=True, use_pallas=False)
    # a check before every cycle, the last one passing, then return_info's read
    assert TM.COUNTS["cycles"] - before["cycles"] == info["cycles"] > 0
    assert TM.COUNTS["checks"] - before["checks"] == info["cycles"] + 2


def test_redblack_checks():
    g = _rhs(40, 50)
    before = dict(TM.COUNTS)
    _, info = TJ.solve_redblack(g, tol=1e-2, check_every=20, return_info=True)
    assert TJ.COUNTS is TM.COUNTS and TM.COUNTS["cycles"] == before["cycles"]
    assert TM.COUNTS["checks"] - before["checks"] == info["iterations"] // 20 + 2


@pytest.mark.parametrize("mode", ["tol", "fixed"])
def test_counts_match_the_quarter_chains_kernel_calls(mode, monkeypatch):
    """In tolerance mode one ``mg_ud_q`` a cycle; in fixed mode ``mg_down_q``
    + ``mg_ud_q`` a frame: the calls of the wrappers that count in
    ``LAUNCHES`` on the card."""
    calls = dict.fromkeys(("mg_down_q", "mg_ud_q", "mg_up_q"), 0)
    for name in calls:
        def counted(*a, _f=getattr(K, name), _n=name, **k):
            calls[_n] += 1
            return _f(*a, **k)
        monkeypatch.setattr(K, name, counted)
    src, dst, mask, center, cfg, _ = _inputs("mg_q")
    if mode == "fixed":
        cfg = CloneConfig(solver="multigrid", mg_cycles=3)
    eng = SeamlessClone(cfg, device="cpu")
    before = dict(TM.COUNTS)
    eng.timed_serve(src, dst, mask, center, loops=1)
    cycles = TM.COUNTS["cycles"] - before["cycles"]
    if mode == "tol":
        assert cycles == calls["mg_ud_q"] == 8 and calls["mg_up_q"] == 0
    else:
        assert cycles == calls["mg_down_q"] + calls["mg_ud_q"] == 6
        assert eng.metrics["cycles_per_frame"] == 3.0 and eng.metrics["checks_per_frame"] == 0
