"""The reduction from a profiler trace to what the per-layer metrics read.

Input: the ``traceEvents`` of ``torch.profiler``'s Chrome trace over the
profiled requests, each wrapped in a ``portbench.request`` span by the
harness. Output: a plain dict (``summarize``), the only thing the readers
in ``metrics/`` see:

- ``requests``, ``frames``: profiled requests and their chained frames
  (``frames`` as the harness counted them);
- ``window_us``: first request span's start to the last one's end;
- ``busy_us``: the union of device operations (kernels, copies, fills)
  inside the window;
- ``host_us``: per request, its span's start to its first device op;
- ``aten_ops``: top-level ``aten::`` ops inside the spans (an op inside
  another ``aten::`` op is not counted again);
- ``device_ops``: {name: [us, count]} inside the window; ``gemm_us`` the
  part whose kernels are cuBLAS GEMMs;
- ``kernels``: {port kernel: {us, launches, bound_us}} for each file under
  ``kernels/`` that owns a device kernel (``kernel_owner``: the first file
  whose names match and that counts this geometry, else the first whose
  names match); ``bound_us`` is None where the file has no count for this
  geometry;
- ``unmatched``: {name: us} of non-GEMM kernels no file claims;
- ``idle_by_host``: {host activity: us} of the device's idle gaps inside
  the window, each piece of a gap named by the deepest host event open
  then;
- ``launches``: the program's own launch counter over the requests.
"""

from __future__ import annotations

import re

SPAN = "portbench.request"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver", "python_function")
GEMM = re.compile(r"gemm|cutlass|xmma|nvjet|cublas|sm90_", re.IGNORECASE)


def short_name(name: str, limit: int = 96) -> str:
    """A device op's name without its argument list."""
    name = name.removeprefix("void ")
    depth = 0
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0 and i > 0:
            name = name[:i]
            break
    return name[:limit].strip()


def _union(intervals):
    """Merged (start, end) intervals, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _top_level_aten(cpu_ops, spans) -> int:
    """``aten::`` ops inside the spans with no enclosing ``aten::`` op on
    their thread."""
    n = 0
    by_tid: dict = {}
    for e in cpu_ops:
        by_tid.setdefault((e["pid"], e["tid"]), []).append(e)
    for evs in by_tid.values():
        evs.sort(key=lambda e: (e["ts"], -e["dur"]))
        stack: list[float] = []  # ends of the open aten ops
        for e in evs:
            while stack and stack[-1] <= e["ts"]:
                stack.pop()
            if not e["name"].startswith("aten::"):
                continue
            if not stack and any(s <= e["ts"] < s + d for s, d in spans):
                n += 1
            stack.append(e["ts"] + e["dur"])
    return n


def _host_labels(host, times) -> list[str]:
    """For each of the sorted ``times``, the deepest host event open then
    (host events of one thread nest)."""
    evs = sorted(host, key=lambda e: (e["ts"], -e["dur"]))
    labels, stack, i = [], [], 0
    for t in times:
        while i < len(evs) and evs[i]["ts"] <= t:
            e = evs[i]
            i += 1
            while stack and stack[-1]["ts"] + stack[-1]["dur"] <= e["ts"]:
                stack.pop()
            stack.append(e)
        while stack and stack[-1]["ts"] + stack[-1]["dur"] <= t:
            stack.pop()
        if not stack:
            labels.append("(no host event)")
        else:
            name = stack[-1]["name"]
            labels.append(name + (" (host code outside torch ops)" if name == SPAN else ""))
    return labels


def _idle_by_host(gaps, host, w0: float, w1: float) -> dict:
    """{host activity: us} of the device's idle ``gaps``: each piece of a gap
    goes to the deepest host event open then."""
    points = sorted({w0, w1} | {min(max(t, w0), w1) for e in host
                                for t in (e["ts"], e["ts"] + e["dur"])})
    pieces = list(zip(points, points[1:]))
    labels = _host_labels(host, [(p + q) / 2 for p, q in pieces])
    idle: dict = {}
    i = 0
    for a, b in gaps:
        while i < len(pieces) and pieces[i][1] <= a:
            i += 1
        j = i
        while j < len(pieces) and pieces[j][0] < b:
            overlap = min(b, pieces[j][1]) - max(a, pieces[j][0])
            if overlap > 0:
                idle[labels[j]] = idle.get(labels[j], 0.0) + overlap
            j += 1
    return idle


def kernel_owner(name: str, n: int, costs: dict, compiled: dict, geom: dict) -> str | None:
    """The cost file a device kernel belongs to: the first, in name order,
    whose ``NAMES`` match and which counts this geometry (``cost`` not
    None); where every matching file returns None, the first match; None
    where no file matches. So a new path brings its own cost file for a
    kernel that an existing file counts on another path."""
    matches = [k for k, pats in compiled.items() if any(p.search(name) for p in pats)]
    return next((k for k in matches if costs[k].cost(geom, n) is not None),
                matches[0] if matches else None)


def kernel_table(device_ops, costs: dict, geom: dict, peaks: dict) -> tuple[dict, dict]:
    """({port kernel: {us, launches, bound_us}}, {unclaimed non-GEMM kernel: us})."""
    compiled = {k: [re.compile(p) for p in costs[k].NAMES] for k in sorted(costs)}
    table: dict = {}
    unmatched: dict = {}
    for name, (us, n, cat) in device_ops.items():
        if cat != "kernel" or GEMM.search(name):
            continue
        owner = kernel_owner(name, n, costs, compiled, geom)
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


def summarize(events: list, frames: int, geom: dict, costs: dict, peaks: dict,
              launches: dict) -> dict:
    spans = sorted((e["ts"], e["dur"]) for e in events
                   if e.get("cat") == "user_annotation" and e.get("name") == SPAN)
    if not spans:
        raise ValueError(f"no {SPAN} span in the trace")
    w0 = spans[0][0]
    w1 = max(s + d for s, d in spans)
    dev = [e for e in events if e.get("cat") in DEVICE_CATS and "dur" in e
           and e["ts"] < w1 and e["ts"] + e["dur"] > w0]
    busy = _union((max(e["ts"], w0), min(e["ts"] + e["dur"], w1)) for e in dev)
    busy_us = sum(e - s for s, e in busy)
    starts = sorted(e["ts"] for e in dev)
    host_us = []
    for s, d in spans:
        first = next((t for t in starts if t >= s), None)
        if first is not None and first < s + d:
            host_us.append(first - s)
    device_ops: dict = {}
    gemm_us = 0.0
    for e in dev:
        name = short_name(e["name"])
        row = device_ops.setdefault(name, [0.0, 0, e["cat"]])
        row[0] += e["dur"]
        row[1] += 1
        if e["cat"] == "kernel" and GEMM.search(e["name"]):
            gemm_us += e["dur"]
    span_tids = {(e["pid"], e["tid"]) for e in events
                 if e.get("cat") == "user_annotation" and e.get("name") == SPAN}
    host = [e for e in events if e.get("cat") in HOST_CATS and "dur" in e
            and (e["pid"], e["tid"]) in span_tids and e["ts"] < w1 and e["ts"] + e["dur"] > w0]
    cpu_ops = [e for e in host if e["cat"] == "cpu_op"]
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
    idle = _idle_by_host(gaps, host, w0, w1)
    table, unmatched = kernel_table(device_ops, costs, geom, peaks)
    return {
        "requests": len(spans),
        "frames": frames,
        "window_us": w1 - w0,
        "busy_us": busy_us,
        "host_us": host_us,
        "aten_ops": _top_level_aten(cpu_ops, spans),
        "device_ops": {k: v[:2] for k, v in device_ops.items()},
        "gemm_us": gemm_us,
        "kernels": table,
        "unmatched": unmatched,
        "idle_by_host": idle,
        "launches": dict(launches),
    }


def breakdown(summary: dict, top: int = 10) -> dict:
    """The result line's ``breakdown``: the device ops that took most time
    and the idle time by what the host was doing, in seconds."""
    ops = sorted(summary["device_ops"].items(), key=lambda kv: -kv[1][0])[:top]
    idle = sorted(summary["idle_by_host"].items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[k, v[0] * 1e-6] for k, v in ops],
            "idle_gaps": [[k, v * 1e-6] for k, v in idle]}
