"""One run of one cell: set-up, the measured window (or the profiled
requests), the check against the reference, the result line.

What the window drives is the cell's driver (``drivers/<name>.py``, named
by the traffic file's ``"driver"``, ``"serve"`` where it names none): the
entry point a request goes through, its inputs, its reference and its
comparison. ``drivers/serve.py``: each request is one call of the port's
``SeamlessClone.timed_serve`` of F chained frames, then a synchronise;
``drivers/run.py``: each request is F ``SeamlessClone.run`` calls, each
into a new destination frame, then a synchronise. One client sends the
requests back to back (a closed loop) until ``--seconds`` have passed; the
window runs from the first request's call to the last one's return.
"""

from __future__ import annotations

import gc
import json
import subprocess
import sys
import time
import traceback
from dataclasses import dataclass, field
from types import ModuleType

from portbench import load, reference, spans, trace
from portbench.traffic import Reservoir, Traffic

FORBIDDEN = ("jax", "jaxlib", "flax", "seamlesscloneoptimization_tpu")


def log(*parts) -> None:
    print("portbench:", *parts, flush=True)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name (before the first dot), compared
    whole, is JAX's or the JAX package's."""
    return sorted(n for n in list(sys.modules) if n.split(".")[0] in FORBIDDEN)


def card() -> dict:
    """Name and power limit of card 0 as ``nvidia-smi`` reads them. Raises
    where it cannot read them: a result without the power limit is no
    result."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader,nounits", "-i", "0"],
                         capture_output=True, text=True, timeout=20, check=True).stdout
    name, limit = (x.strip() for x in out.strip().split(","))
    return {"smi_name": name, "power_limit_w": float(limit)}


@dataclass
class Cell:
    """A cell made ready: its files, driver, inputs and engine (the
    driver's ``inputs`` give ``pool``, ``mask``, ``center`` and ``geom``)."""

    name: str
    cfg: dict
    traffic: Traffic
    driver: ModuleType
    pool: list
    mask: object
    center: tuple[int, int]
    geom: dict
    device: object
    engine: object = None
    times: dict = field(default_factory=dict)

    def mpix(self, frames: int) -> float:
        """Interior megapixels that ``frames`` frames complete."""
        return self.driver.mpix(self, frames)

    def sync(self) -> None:
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def call(self, req, engine=None):
        """One request through the driver: (answer, seconds from the call to
        the sync)."""
        return self.driver.call(self, req, engine)


def prepare(name: str, seed: int, device, cfg: dict | None = None, spec: dict | None = None,
            engine=None) -> Cell:
    """The driver's inputs, engine (or ``engine``, kept warm) and warm-up."""
    import torch

    from seamlesscloneoptimization_tpu_torch.ops import _build

    entry = load.cell(name)
    cfg = cfg or load.config(entry["config"])
    spec = spec or load.traffic(entry["traffic"])
    device = torch.device(device)
    times = {}
    if device.type == "cuda":
        t = time.perf_counter()
        _build.build_all()  # what the first launch would build
        times["build_s"] = time.perf_counter() - t
    t = time.perf_counter()
    tr = Traffic(spec, seed)
    driver = load.driver(tr.driver)
    cell = Cell(name, cfg, tr, driver, device=device, **driver.inputs(cfg, tr, seed, device))
    cell.sync()
    times["pool_s"] = time.perf_counter() - t
    t = time.perf_counter()
    cell.engine = engine or driver.engine(cfg["clone_config"], device)
    driver.warm(cell)
    times["warmup_s"] = time.perf_counter() - t
    cell.times = times
    return cell


def serve(cell: Cell, seconds: float, sampler: Reservoir) -> dict:
    """The measured window: requests back to back until ``seconds`` have
    passed. Returns what the end-to-end readers see."""
    from seamlesscloneoptimization_tpu_torch.ops import kernels as K

    K.reset_launches()
    lat, failed, frames = [], 0, 0
    t0 = time.perf_counter()
    deadline = t0 + seconds
    i = 0
    while True:
        req = cell.traffic.request(i)
        t = time.perf_counter()
        try:
            out, dt = cell.call(req)
            frames += req.frames
        except Exception:  # a request that fails is counted and the loop goes on
            traceback.print_exc()
            out, dt = None, time.perf_counter() - t
            failed += 1
        lat.append(dt)
        sampler.offer((req, out))
        i += 1
        if time.perf_counter() >= deadline:
            break
    window = time.perf_counter() - t0
    return {"latencies_s": lat, "window_s": window, "attempted": i, "failed": failed,
            "mpix": cell.mpix(frames), "frames": frames,
            "launches": dict(K.LAUNCHES)}


def serve_traced(cell: Cell, sampler: Reservoir, tmpdir: str) -> tuple[dict, int, int]:
    """``trace_requests`` requests under ``torch.profiler``, each in a
    ``portbench.request`` span. Returns (summary, attempted, failed): the
    summary is ``trace.summarize``'s, with the program's own spans and
    counters (``spans.summarize_program``) under ``"program"``."""
    import os

    from torch.profiler import ProfilerActivity, profile, record_function

    from seamlesscloneoptimization_tpu_torch.ops import kernels as K

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cell.device.type == "cuda"
                                     else [])
    K.reset_launches()
    counts = spans.program_counts()
    failed = frames = 0
    with profile(activities=acts) as prof:
        for i in range(cell.traffic.trace_requests):
            req = cell.traffic.request(i)
            try:
                with record_function(trace.SPAN):
                    out, _ = cell.call(req)
                frames += req.frames
            except Exception:
                traceback.print_exc()
                out = None
                failed += 1
            sampler.offer((req, out))
    launches = dict(K.LAUNCHES)
    counts = spans.counts_delta(counts, spans.program_counts())
    path = os.path.join(tmpdir, f"portbench_trace_{os.getpid()}.json")
    prof.export_chrome_trace(path)
    try:
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    summary = trace.summarize(events, frames, cell.geom, load.kernel_costs(), load.peaks(),
                              launches)
    summary["program"] = spans.summarize_program(events, summary["requests"], frames, counts)
    return summary, cell.traffic.trace_requests, failed


def references(cell: Cell, samples: list, precision: str = "float64") -> list:
    """The reference's answer to each sampled request (None where the
    program's never came), computed on the cell's device."""
    solver = reference.DstSolver(precision, cell.device)
    return [None if got is None else cell.driver.reference(cell, req, solver)
            for req, got in samples]


def judge(cell: Cell, outputs: list, refs: list) -> list:
    """The driver's ``compare`` of each answer with the reference's; None
    where an answer never came."""
    return [None if o is None or r is None else cell.driver.compare(o, r, cell.geom)
            for o, r in zip(outputs, refs)]


def worst(rows: list) -> dict | None:
    """The worst reading of each number over the sample; None when an
    answer is missing."""
    if not rows or any(r is None for r in rows):
        return None
    return {k: max(r[k] for r in rows) for k in rows[0]}


def verdict(numbers: dict | None, limits: dict) -> tuple[bool, dict]:
    """(correct, {number: {"value", "limit"}}) for the numbers with a limit."""
    checks = {k: {"value": None if numbers is None else numbers[k], "limit": v["limit"]}
              for k, v in limits["numbers"].items()}
    ok = numbers is not None and all(c["value"] <= c["limit"] for c in checks.values())
    return ok, checks


def free_program(cell: Cell) -> None:
    """Drop the program's state before the reference runs on the card."""
    import torch

    cell.engine.destroy()
    cell.engine = None
    gc.collect()
    if cell.device.type == "cuda":
        torch.cuda.empty_cache()


def run_cell(name: str, seed: int, seconds: float, traced: bool, device, t_start: float,
             tmpdir: str, cfg: dict | None = None, spec: dict | None = None) -> dict:
    """One run. Returns the result line's dict, ``checks`` last."""
    import torch

    entry = load.cell(name)
    limits = load.limits(name)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    imports_s = time.perf_counter() - t_start  # the interpreter, torch, the CUDA context
    cell = prepare(name, seed, device, cfg, spec)
    setup_s = time.perf_counter() - t_start
    cell.times.update(imports_s=imports_s, setup_s=setup_s)
    log("setup split (s):", json.dumps(cell.times))
    sampler = Reservoir(cell.traffic.sample, seed)
    if traced:
        summary, attempted, failed = serve_traced(cell, sampler, tmpdir)
        source, metrics_entries = summary, entry["per_layer"]
    else:
        window = serve(cell, seconds, sampler)
        window["setup_s"] = setup_s
        attempted, failed = window["attempted"], window["failed"]
        source, metrics_entries = window, entry["end_to_end"]
        frames = max(window["frames"], 1)
        log("window:", json.dumps({"seconds": window["window_s"], "requests": attempted,
                                   "failed": failed, "frames": window["frames"]}))
        log("launches a frame by kernel:", json.dumps(
            {k: v / frames for k, v in window["launches"].items() if v}))
    log("engine:", json.dumps({"solver": cell.engine.metrics.get("solver_resolved"),
                               "resident_bytes": cell.engine.device_memory_bytes()}))
    peak = int(torch.cuda.max_memory_allocated()) if cell.device.type == "cuda" else 0
    free_program(cell)
    t = time.perf_counter()
    rows = judge(cell, [out for _, out in sampler.items], references(cell, sampler.items))
    log("reference:", json.dumps({"seconds": time.perf_counter() - t, "requests": len(rows),
                                  "indices": [r.index for r, _ in sampler.items]}))
    for (req, _), row in zip(sampler.items, rows):
        log(f"request {req.index} flags {req.flags} frames {req.frames}:", json.dumps(row))
    numbers = worst(rows)
    correct, checks = verdict(numbers, limits)
    correct = correct and failed == 0
    log("compared numbers (worst over the sample):", json.dumps(numbers))
    metrics = {}
    for m in metrics_entries:
        value = load.metric_reader(m["name"]).read(source)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_info = {"platform": "gpu" if cell.device.type == "cuda" else cell.device.type,
                   "kind": torch.cuda.get_device_name(cell.device)
                   if cell.device.type == "cuda" else "cpu",
                   "count": 1, "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": device_info}
    if traced:
        device_info["busy_s"] = summary["busy_us"] * 1e-6
        device_info["window_s"] = summary["window_us"] * 1e-6
        result["breakdown"] = trace.breakdown(summary)
        log("kernels vs bound:", json.dumps(summary["kernels"]))
        log("kernels without a cost file (us):", json.dumps(summary["unmatched"]))
        log("launches by kernel:", json.dumps({k: v for k, v in summary["launches"].items() if v}))
        program = summary["program"]
        log("program spans (us a request), idle by span (us), counters:", json.dumps(
            {"spans": {k: v["us_per_request"] for k, v in program["spans"].items()},
             "idle_by_span": {str(k): v for k, v in program["idle_by_span"].items()},
             "counters": {k: v for k, v in program["counters"].items() if v}}))
        log("device ops (us, count):", json.dumps(summary["device_ops"]))
    if cell.device.type == "cuda":
        device_info.update(card())
    result["checks"] = checks
    return result
