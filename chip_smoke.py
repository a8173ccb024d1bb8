#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

1. Prints the card (nvidia-smi name and power limit), builds the kernels
   from ``seamlesscloneoptimization_tpu_torch/csrc`` and prints the build
   time, ptxas's resource report and both TF32 flags.
2. Holds each kernel against its plain PyTorch twin on the card, at the
   shapes of the headline serve frame (a 2400x1552 full-mask patch into a
   4800x2694 destination, bench.py's geometry): every kernel bit-exact
   (``transpose`` with the fused divide too: the twin's divide is IEEE on
   the card as well). Times kernel, twin and, where one PyTorch call
   computes the same function, that call (``library_ms``; the port never
   calls it), each launch cold in L2.
3. Drives the serve path, ``SeamlessClone(CloneConfig(), device="cuda")
   .timed_serve(...)``, for 20 chained frames with the launch counters set
   to 0 just before, and checks that every kernel ran its per-frame count,
   that nothing outside the ROI interior changed, and the Poisson residual;
   then profiles 5 serve frames (device time by kernel, idle share).
4. Drives the single-shot path, ``SeamlessClone.run`` into the interleaved
   destination, once at the headline geometry with the launch counters set
   to 0 just before, checks its per-frame counts and the untouched
   outside, and holds it against the same port on the CPU (the plain
   twins); then two serve frames, and ``seamless_clone`` on a small
   irregular mask in all three modes, card against CPU, diff_max <= 1.

Prints the kernel table as one JSON line (one entry per kernel and path:
``clamp_cast_paste_interleaved`` is the same kernel on the single-shot
path's interleaved destination; ``run_launches`` are the single-shot
path's counts), then, as the last line,
``{"ok": true, "device": {...}}``. Every phase raises on failure; the
script exits non-zero, printing no result, when there is no CUDA card or
the port's package is missing. Images are synthetic, made from a seed.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

SEED = 0
SRC_HW = (1552, 2400)
DST_HW = (2694, 4800)
SERVE_LOOPS = 20
REPS = 10
HBM_BYTES_PER_S = 3.35e12  # H100 SXM published peak HBM3 bandwidth
FP32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
PER_FRAME = {"erode3": 1, "preprocess_rhs_t": 1, "transpose": 3, "clamp_cast_paste": 1}
REPLACES = {
    "erode3": ["seamlesscloneoptimization_tpu/ops/pallas_kernels.py:1164"],
    "preprocess_rhs_t": ["seamlesscloneoptimization_tpu/ops/pallas_kernels.py:1288"],
    "transpose": ["seamlesscloneoptimization_tpu/ops/pallas_kernels.py:1557"],
    "clamp_cast_paste": ["seamlesscloneoptimization_tpu/ops/pallas_kernels.py:1785",
                         "seamlesscloneoptimization_tpu/ops/pallas_kernels.py:1656"],
    "clamp_cast_paste_interleaved": [
        "seamlesscloneoptimization_tpu/ops/pallas_kernels.py:1614"],
}
SOURCE = {"clamp_cast_paste_interleaved": "clamp_cast_paste"}


def synthetic_image(rng, hw, cell=48):
    """Smooth random colour field plus noise, u8 (H, W, 3)."""
    import numpy as np

    h, w = hw
    coarse = rng.integers(0, 256, (h // cell + 2, w // cell + 2, 3)).astype(np.float32)
    img = np.kron(coarse, np.ones((cell, cell, 1), np.float32))[:h, :w]
    img += rng.normal(0.0, 6.0, img.shape).astype(np.float32)
    return np.clip(img, 0, 255).astype(np.uint8)


def check_counts(path: str, launches: dict, frames: int) -> None:
    for name, per in PER_FRAME.items():
        if launches[name] != per * frames:
            raise AssertionError(f"{path} path launched {name} {launches[name]} times, "
                                 f"expected {per} x {frames} frames")


def check_outside(out, dst, interior) -> None:
    """out == dst outside the ROI interior (top1, left1, h2, w2), and changed
    inside it."""
    import numpy as np

    top1, left1, h2, w2 = interior
    outside = np.ones(dst.shape[:2], bool)
    outside[top1 : top1 + h2, left1 : left1 + w2] = False
    if not np.array_equal(out[outside], dst[outside]):
        raise AssertionError("pixels outside the ROI interior changed")
    if np.array_equal(out[~outside], dst[~outside]):
        raise AssertionError("the ROI interior is unchanged")


def diff_max(a, b) -> int:
    import numpy as np

    return int(np.abs(np.asarray(a).astype(np.int16) - np.asarray(b)).max())


def profile_frames(clone_pipeline, kwargs, frames: int = 5) -> None:
    """Where a serve frame's device time goes: torch.profiler over
    ``frames`` chained frames of the serve pipeline, kernel time per frame
    by name and by group, and the busy share of the device's span (CUDA
    events around the window). Prints; measures nothing the checks use."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    clone_pipeline(**kwargs)
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        s.record()
        for _ in range(frames):
            clone_pipeline(**kwargs)
        e.record()
        e.synchronize()
    span_us = s.elapsed_time(e) * 1e3 / frames
    per_kernel = {}
    for ev in prof.key_averages():
        if str(getattr(ev, "device_type", "")).endswith("CUDA"):
            t = getattr(ev, "self_device_time_total", None)
            if t is None:
                t = getattr(ev, "self_cuda_time_total", 0.0)
            per_kernel[ev.key] = per_kernel.get(ev.key, 0.0) + t / frames
    busy = sum(per_kernel.values())
    if busy == 0:
        print(f"profile: no device time recorded; frame span {span_us:.1f} us")
        return
    ours = ("erode3", "preprocess_rhs_t", "transpose_kernel", "clamp_cast_paste")
    groups = {"gemm": 0.0, "port kernels": 0.0, "other": 0.0}
    for k, t in per_kernel.items():
        g = ("gemm" if "gemm" in k.lower() or "cutlass" in k.lower()
             else "port kernels" if any(o in k for o in ours) else "other")
        groups[g] += t
    print(f"profile ({frames} frames, profiler on): device span {span_us:.1f} us/frame, "
          f"kernels busy {busy:.1f} us/frame, idle share {1 - busy / span_us:.3f}")
    for g, t in groups.items():
        print(f"profile group {g}: {t:.1f} us/frame ({t / busy:.3f} of busy)")
    for k, t in sorted(per_kernel.items(), key=lambda kv: -kv[1])[:12]:
        print(f"profile kernel {t:9.1f} us/frame  {k[:110]}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import numpy as np

    from seamlesscloneoptimization_tpu_torch.api import seamless_clone
    from seamlesscloneoptimization_tpu_torch.core.config import CloneConfig
    from seamlesscloneoptimization_tpu_torch.core.engine import SeamlessClone, prepare_inputs
    from seamlesscloneoptimization_tpu_torch.models.pipeline import clone_pipeline
    from seamlesscloneoptimization_tpu_torch.ops import _build
    from seamlesscloneoptimization_tpu_torch.ops import kernels as K
    from seamlesscloneoptimization_tpu_torch.ops.guidance import bgr_to_gray_u8
    from seamlesscloneoptimization_tpu_torch.ops.kernels import ru128
    from seamlesscloneoptimization_tpu_torch.solvers.dst_gemm import dst_bases

    dev = torch.device("cuda")

    # -- 1. the card and the build ---------------------------------------------
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(card)
    build_s = _build.build_all()
    print(f"kernel build: {build_s:.2f} s")
    for name, report in _build.ptxas_report().items():
        print(f"ptxas {name}: {report}")
    print("tf32: matmul", torch.backends.cuda.matmul.allow_tf32,
          "cudnn", torch.backends.cudnn.allow_tf32,
          "float32_matmul_precision", torch.get_float32_matmul_precision())

    # -- the headline frame's tensors, exactly as the serve pipeline makes them
    rng = np.random.default_rng(SEED)
    src = synthetic_image(rng, SRC_HW)
    dst = synthetic_image(rng, DST_HW)
    mask = np.full(SRC_HW, 255, np.uint8)
    center = (DST_HW[1] // 2, DST_HW[0] // 2)
    m, (x0, y0), (left, top), (bh, bw) = prepare_inputs(mask, src.shape, dst.shape, center)
    h2, w2 = bh - 2, bw - 2
    hp, wp = ru128(h2), ru128(w2)
    c = 3
    dst_p = torch.from_numpy(dst).to(dev).permute(2, 0, 1).contiguous()
    dest_roi = dst_p[:, top : top + bh, left : left + bw]
    src_roi = torch.from_numpy(src).to(dev)[y0 : y0 + bh, x0 : x0 + bw].permute(2, 0, 1)
    mask_roi = torch.from_numpy(m[y0 : y0 + bh, x0 : x0 + bw]).to(dev)
    patch = torch.where(mask_roi[None] != 0, src_roi, 0).to(torch.uint8)
    m01 = (mask_roi != 0).to(torch.uint8)
    vh, vw, lam_h, lam_w = dst_bases(h2, w2, hp, wp, dev)
    print(f"geometry: roi {bh}x{bw}, interior {h2}x{w2}, slab ({c}, {wp}, {hp})")

    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)  # > 50 MB L2

    def time_ms(fn) -> float:
        fn()
        torch.cuda.synchronize()
        total = 0.0
        for _ in range(REPS):
            flush.zero_()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            e.synchronize()
            total += s.elapsed_time(e)
        return total / REPS

    def bound(nbytes: float, nops: float):
        tb, to = nbytes / HBM_BYTES_PER_S * 1e3, nops / FP32_FLOPS * 1e3
        return (tb, "bytes") if tb >= to else (to, "operations")

    errs = {}

    def require_equal(name, got, want):
        """Bit-exact or raise; records the kernel's max |kernel - twin|."""
        err = (got.double() - want.double()).abs().max().item()
        kernel = name.split()[0]
        errs[kernel] = max(errs.get(kernel, 0.0), err)
        if not torch.equal(got, want):
            raise AssertionError(f"{name}: kernel differs from its twin, max |diff| {err}")

    rows = {}

    def row(name, nbytes, nops, ms, plain_ms, library_ms=None, **extra):
        b_ms, b_by = bound(nbytes, nops)
        rows[name] = dict(name=name, route="cuda",
                          source="seamlesscloneoptimization_tpu_torch/csrc/"
                                 f"{SOURCE.get(name, name)}.cu",
                          replaces=REPLACES[name][0], launches=None, max_abs_err=errs[name],
                          ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                          library_ms=library_ms, **extra)
        if len(REPLACES[name]) > 1:
            rows[name]["also_replaces"] = REPLACES[name][1:]

    # -- 2. every kernel against its twin, on the card ---------------------------
    me = K.erode3(m01)
    require_equal("erode3", me, K.erode3_plain(m01))
    row("erode3", 2 * bh * bw, 12 * bh * bw,
        time_ms(lambda: K.erode3(m01)), time_ms(lambda: K.erode3_plain(m01)))

    gray = bgr_to_gray_u8(patch).to(torch.uint8)[None].expand(c, bh, bw)
    for flags, rule, p_in in ((1, "opencv", patch), (2, "opencv", patch),
                              (2, "norm", patch), (1, "opencv", gray)):
        require_equal(f"preprocess_rhs_t flags={flags} {rule}",
                      K.preprocess_rhs_t(dest_roi, p_in, me, flags, rule),
                      K.preprocess_rhs_t_plain(dest_roi, p_in, me, flags, rule))
    g_tp = K.preprocess_rhs_t(dest_roi, patch, me)
    row("preprocess_rhs_t", 2 * c * bh * bw + bh * bw + 4 * c * wp * hp, 30 * c * bh * bw,
        time_ms(lambda: K.preprocess_rhs_t(dest_roi, patch, me)),
        time_ms(lambda: K.preprocess_rhs_t_plain(dest_roi, patch, me)))

    s1 = torch.matmul(g_tp, vh)
    require_equal("transpose", K.transpose(s1), K.transpose_plain(s1))
    s2 = torch.matmul(K.transpose(s1), vw)
    tr2 = K.transpose(s2, lam_h, lam_w)
    tr2_plain = K.transpose_plain(s2, lam_h, lam_w)
    require_equal("transpose (divide)", tr2, tr2_plain)
    row("transpose", 8 * c * wp * hp, 0,
        time_ms(lambda: K.transpose(s1)), time_ms(lambda: K.transpose_plain(s1)),
        time_ms(lambda: s1.transpose(1, 2).contiguous()),
        divide_ms=time_ms(lambda: K.transpose(s2, lam_h, lam_w)),
        divide_plain_ms=time_ms(lambda: K.transpose_plain(s2, lam_h, lam_w)),
        divide_bound_ms=bound(8 * c * wp * hp + 4 * (wp + hp), 2 * c * wp * hp)[0])

    u = torch.matmul(K.transpose(torch.matmul(tr2, vh)), vw)
    d_k, d_p = dst_p.clone(), dst_p.clone()
    K.clamp_cast_paste(u, d_k, top + 1, left + 1, h2, w2)
    K.clamp_cast_paste_plain(u, d_p, top + 1, left + 1, h2, w2)
    require_equal("clamp_cast_paste (planar)", d_k, d_p)
    i_k = torch.from_numpy(dst).to(dev)
    i_p = i_k.clone()
    K.clamp_cast_paste(u, i_k.permute(2, 0, 1), top + 1, left + 1, h2, w2)
    K.clamp_cast_paste_plain(u, i_p.permute(2, 0, 1), top + 1, left + 1, h2, w2)
    require_equal("clamp_cast_paste_interleaved", i_k, i_p)
    row("clamp_cast_paste", 5 * c * h2 * w2, 2 * c * h2 * w2,
        time_ms(lambda: K.clamp_cast_paste(u, d_k, top + 1, left + 1, h2, w2)),
        time_ms(lambda: K.clamp_cast_paste_plain(u, d_p, top + 1, left + 1, h2, w2)))
    row("clamp_cast_paste_interleaved", 5 * c * h2 * w2, 2 * c * h2 * w2,
        time_ms(lambda: K.clamp_cast_paste(u, i_k.permute(2, 0, 1), top + 1, left + 1,
                                           h2, w2)),
        time_ms(lambda: K.clamp_cast_paste_plain(u, i_p.permute(2, 0, 1), top + 1,
                                                 left + 1, h2, w2)))
    gemm_ms = time_ms(lambda: torch.matmul(g_tp, vh))
    del s1, s2, tr2, tr2_plain, u, d_k, d_p, i_k, i_p, flush
    print(f"one FP32 GEMM of the chain ({c}x{wp}x{hp} @ {hp}x{hp}): {gemm_ms:.4f} ms")

    # -- 3. the serve path through the kernels ------------------------------------
    eng = SeamlessClone(CloneConfig(), device="cuda")
    K.reset_launches()
    out, serve_ms = eng.timed_serve(src, dst, mask, center, loops=SERVE_LOOPS)
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    check_counts("serve", launches, SERVE_LOOPS + 1)  # warm-up + timed frames
    for name in PER_FRAME:
        rows[name]["launches"] = launches[name]
    if eng.metrics["solver_resolved"] != "dst_gemm":
        raise AssertionError(f"solver resolved to {eng.metrics['solver_resolved']}")
    out_np = out.cpu().numpy()
    if out_np.shape != dst.shape or out_np.dtype != np.uint8:
        raise AssertionError(f"serve output {out_np.shape} {out_np.dtype}")
    check_outside(out_np, dst, (top + 1, left + 1, h2, w2))
    mps = SRC_HW[0] * SRC_HW[1] / (serve_ms * 1e3)
    print(f"serve: {serve_ms:.4f} ms/frame, {mps:.1f} MP/s over {SERVE_LOOPS} chained "
          f"frames at {SRC_HW[1]}x{SRC_HW[0]} into {DST_HW[1]}x{DST_HW[0]} "
          f"({card}); device memory {eng.metrics['device_memory_bytes']} B")

    # Poisson residual of one card solve, in float64: A u = g on the interior
    g = K.preprocess_rhs_t(dest_roi, patch, me)[:, :w2, :h2].transpose(1, 2).double()
    u = torch.matmul(K.transpose(torch.matmul(K.transpose(torch.matmul(
        K.transpose(torch.matmul(g_tp, vh)), vw), lam_h, lam_w), vh)), vw)
    up = torch.nn.functional.pad(u[:, :h2, :w2].double(), (1, 1, 1, 1))
    lap = (up[:, :-2, 1:-1] + up[:, 2:, 1:-1] + up[:, 1:-1, :-2] + up[:, 1:-1, 2:]
           - 4 * up[:, 1:-1, 1:-1])
    rel_res = ((lap - g).abs().max() / g.abs().max()).item()
    print(f"solve: max |A u - g| / max |g| = {rel_res:.3e}")
    if not rel_res < 1e-2:
        raise AssertionError(f"Poisson residual {rel_res} too large")
    del g, u, up, lap
    profile_frames(clone_pipeline, dict(
        src=torch.from_numpy(src).to(dev), dst=dst_p.clone(),
        mask=torch.from_numpy(m).to(dev), bbox_xy=(x0, y0), left_top=(left, top),
        bbox_hw=(bh, bw), flags=1, solver_kwargs={"precision": "high", "folded": True},
        bases=(vh, vw, lam_h, lam_w), planar_dst=True))

    # -- 4. the single-shot path through the kernels, and the card against the CPU
    K.reset_launches()
    run_out = eng.run(src, dst, mask, center)
    eng.sync()
    run_launches = dict(K.LAUNCHES)
    check_counts("single-shot", run_launches, 1)
    for name in PER_FRAME:
        rows[name]["run_launches"] = run_launches[name]
    rows["clamp_cast_paste_interleaved"]["launches"] = run_launches["clamp_cast_paste"]
    if eng.metrics["solver_resolved"] != "dst_gemm":
        raise AssertionError(f"solver resolved to {eng.metrics['solver_resolved']}")
    run_np = run_out.cpu().numpy()
    check_outside(run_np, dst, (top + 1, left + 1, h2, w2))
    print(f"single-shot run: launches {json.dumps(run_launches)}")
    cpu = SeamlessClone(CloneConfig(), device="cpu")
    d_run = diff_max(run_np, cpu.run(src, dst, mask, center).numpy())
    a, _ = eng.timed_serve(src, dst, mask, center, loops=1)
    b, _ = cpu.timed_serve(src, dst, mask, center, loops=1)
    d_serve = diff_max(a.cpu().numpy(), b.numpy())
    print(f"card vs cpu at {SRC_HW[1]}x{SRC_HW[0]}: run diff_max {d_run}, "
          f"2-frame serve diff_max {d_serve}")
    if d_run > 1 or d_serve > 1:
        raise AssertionError("card and CPU disagree by more than 1")
    s_src = synthetic_image(rng, (194, 300))
    s_dst = synthetic_image(rng, (449, 800))
    yy, xx = np.mgrid[:194, :300]
    s_mask = (((yy - 97) ** 2 + (xx - 150) ** 2 < 80 ** 2)
              | ((yy >= 30) & (yy <= 120) & (xx >= 40) & (xx <= 260))).astype(np.uint8) * 255
    for flags in (1, 2, 3):
        dm = diff_max(seamless_clone(s_src, s_dst, s_mask, (400, 200), flags),
                      seamless_clone(s_src, s_dst, s_mask, (400, 200), flags, device="cpu"))
        print(f"card vs cpu, irregular mask 300x194, flags={flags}: diff_max {dm}")
        if dm > 1:
            raise AssertionError(f"flags={flags}: card and CPU disagree by {dm}")

    print(json.dumps({"kernels": list(rows.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
