"""One run of one cell: set-up, the measured window (or the profiled
requests), the check against the reference, the result line.

What the window drives: each request is one call of the port's public
``SeamlessClone(cfg).timed_serve(src, dst, mask, center, loops=F - 1,
flags=...)`` followed by a synchronise, F chained frames (the warm-up frame
and F - 1 timed ones) on the engine's own planar copy of the destination.
``src`` and ``dst`` come from a pool of seeded pairs resident on the card,
the mask is a host u8 array, as the API takes it. One client sends the
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

import numpy as np

from portbench import load, reference, trace
from portbench.inputs import make_mask, make_pool
from portbench.traffic import Request, Reservoir, Traffic

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


def center_of(cfg: dict) -> tuple[int, int]:
    if cfg["center"] == "middle":
        return cfg["dst_hw"][1] // 2, cfg["dst_hw"][0] // 2
    return tuple(cfg["center"])


def geometry(cfg: dict, mask: np.ndarray) -> dict:
    """The cell's sizes (``geometry.py``): the ROI is the mask's bbox."""
    import torch

    _, (x0, y0, bw, bh) = reference.prep_mask(torch.from_numpy(mask))
    left, top = reference.roi_placement((x0, y0, bw, bh), cfg["dst_hw"], center_of(cfg))
    return {"c": 3, "bh": bh, "bw": bw, "h": bh - 2, "w": bw - 2, "path": cfg["path"],
            "left": left, "top": top}


@dataclass
class Cell:
    """A cell made ready: its files, inputs and engine."""

    name: str
    cfg: dict
    traffic: Traffic
    pool: list
    mask: np.ndarray
    center: tuple[int, int]
    geom: dict
    device: object
    engine: object = None
    times: dict = field(default_factory=dict)

    def mpix(self, frames: int) -> float:
        """Interior megapixels that ``frames`` frames solve and paste."""
        return frames * self.geom["h"] * self.geom["w"] * 1e-6

    def sync(self) -> None:
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def call(self, req: Request, engine=None):
        """One request: (output image, seconds from the call to the sync)."""
        src, dst = self.pool[req.pair]
        t = time.perf_counter()
        out, _ = (engine or self.engine).timed_serve(src, dst, self.mask, self.center,
                                                     loops=req.frames - 1, flags=req.flags)
        self.sync()
        return out, time.perf_counter() - t


def prepare(name: str, seed: int, device, cfg: dict | None = None, spec: dict | None = None,
            engine=None) -> Cell:
    """Inputs, the engine (or ``engine``, kept warm) and its warm-up: one
    request of each kind the traffic sends, on the traffic's shapes only."""
    import torch

    from seamlesscloneoptimization_tpu_torch.core.config import CloneConfig
    from seamlesscloneoptimization_tpu_torch.core.engine import SeamlessClone
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
    pool = make_pool(seed, tr.pool, cfg["src_hw"], cfg["dst_hw"], device)
    mask = make_mask(spec["mask"], cfg["src_hw"], seed)
    cell = Cell(name, cfg, tr, pool, mask, center_of(cfg), geometry(cfg, mask), device)
    cell.sync()
    times["pool_s"] = time.perf_counter() - t
    t = time.perf_counter()
    cell.engine = engine or SeamlessClone(CloneConfig(**cfg["clone_config"]), device=device)
    for flags, frames in tr.kinds:
        cell.call(Request(-1, 0, flags, frames))
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
    ``portbench.request`` span. Returns (summary, attempted, failed)."""
    import os

    from torch.profiler import ProfilerActivity, profile, record_function

    from seamlesscloneoptimization_tpu_torch.ops import kernels as K

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cell.device.type == "cuda"
                                     else [])
    K.reset_launches()
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
    path = os.path.join(tmpdir, "portbench_trace.json")
    prof.export_chrome_trace(path)
    try:
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    summary = trace.summarize(events, frames, cell.geom, load.kernel_costs(), load.peaks(),
                              launches)
    return summary, cell.traffic.trace_requests, failed


def compare(out, ref, geom: dict) -> dict:
    """The numbers one request is judged by: the widest gap over the whole
    image (grey levels; outside the ROI's interior the answer must equal the
    destination), and over the solved interior the mean gap and the share
    of values off by more than one level (%)."""
    d = (out.to(ref.device).short() - ref.short()).abs()
    t, l, h, w = geom["top"] + 1, geom["left"] + 1, geom["h"], geom["w"]
    inner = d[t:t + h, l:l + w].double()
    return {"max_abs_diff": int(d.max()), "mean_abs_diff": float(inner.mean()),
            "pct_off_by_2": float((inner > 1).double().mean()) * 100.0}


def references(cell: Cell, samples: list, precision: str = "float64") -> list:
    """The reference's answer to each sampled request (None where the
    program's never came), computed on the cell's device."""
    import torch

    solver = reference.DstSolver(precision, cell.device)
    mask = torch.from_numpy(cell.mask).to(cell.device)
    out = []
    for req, got in samples:
        src, dst = cell.pool[req.pair]
        out.append(None if got is None else reference.serve_request(
            src, dst, mask, cell.center, req.flags, req.frames, solver))
    return out


def judge(cell: Cell, outputs: list, refs: list) -> list:
    """``compare`` of each answer with the reference's; None where an answer
    never came."""
    return [None if o is None or r is None else compare(o, r, cell.geom)
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
    if cell.device.type == "cuda":
        device_info.update(card())
    result["checks"] = checks
    return result
