"""The port's tiled engine and tiled edit in two checkouts, in turns.

Times ``TiledSeamlessClone.timed_serve`` at 8K (a 3802x2802 full-mask
source into a 7680x4320 destination) on a 2x2 mesh of one CUDA card, paths
``"dd"`` and ``"gspmd"``, to tol 1e-4 and with ``mg_cycles=4``, and
``local_edit_tiled``'s colour change at 1080p on the same mesh, both paths,
in this checkout and in another (for example the parent commit unpacked
with ``git archive`` into a git-ignored directory). Each turn is a process
of its own that imports the package of one checkout; the turns run other,
this, this, other, and each case reports both checkouts' times side by
side, with a digest of each output and, per frame, the device kernels
launched and the device-busy microseconds (torch.profiler over the
difference of two serves of different lengths). Imports torch and numpy
only.

    python3 tools/torch_tiled_frames.py --other OTHER_ROOT [--out FILE]
    python3 tools/torch_tiled_frames.py --one ROOT   # one turn, one JSON line
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
SEED = 0
SRC_8K, DST_8K = (2802, 3802), (4320, 7680)
EDIT_1080P, EDIT_BBOX_1080P = (1080, 1920), (701, 1201)
EDIT_FACTORS = (1.7, 0.6, 1.2)  # colorChange's red, green, blue
MESH = (2, 2)
TOL = 1e-4
SERVES = (("tiled_dd", "dd", None, 10), ("tiled_dd_fixed", "dd", 4, 10),
          ("tiled_gspmd", "gspmd", None, 3), ("tiled_gspmd_fixed", "gspmd", 4, 3))
EDITS = (("edit_tiled", "dd"), ("edit_tiled_gspmd", "gspmd"))
EDIT_CALLS = 3
TURNS = ("other", "this", "this", "other")
TURN_TIMEOUT = 900


def synthetic_image(rng, hw, cell=48):
    """Smooth random colour field plus noise, u8 (H, W, 3)."""
    import numpy as np

    h, w = hw
    coarse = rng.integers(0, 256, (h // cell + 2, w // cell + 2, 3)).astype(np.float32)
    img = np.kron(coarse, np.ones((cell, cell, 1), np.float32))[:h, :w]
    img += rng.normal(0.0, 6.0, img.shape).astype(np.float32)
    return np.clip(img, 0, 255).astype(np.uint8)


def ellipse_mask(hw, bbox_hw):
    """A u8 {0,255} ellipse whose bbox is ``bbox_hw``, centred."""
    import numpy as np

    bh, bw = bbox_hw
    y0, x0 = (hw[0] - bh) // 2, (hw[1] - bw) // 2
    cy, cx = y0 + (bh - 1) / 2, x0 + (bw - 1) / 2
    yy, xx = np.ogrid[: hw[0], : hw[1]]
    return ((((yy - cy) / (bh / 2)) ** 2 + ((xx - cx) / (bw / 2)) ** 2 <= 1)
            .astype(np.uint8) * 255)


def digest(a) -> str:
    return hashlib.sha1(a.tobytes()).hexdigest()[:16]


def device_work(fn) -> tuple[int, float]:
    """(device kernels launched, device-busy us) while ``fn`` runs."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    n, us = 0, 0.0
    for ev in prof.key_averages():
        if str(getattr(ev, "device_type", "")).endswith("CUDA"):
            t = getattr(ev, "self_device_time_total", None)
            us += getattr(ev, "self_cuda_time_total", 0.0) if t is None else t
            n += ev.count
    return n, us


def one_turn(root: Path) -> dict:
    """Every case in the package of ``root``, on cuda:0."""
    sys.path.insert(0, str(root))
    import numpy as np
    import torch

    import seamlesscloneoptimization_tpu_torch as pkg
    from seamlesscloneoptimization_tpu_torch.core.config import CloneConfig
    from seamlesscloneoptimization_tpu_torch.ops import edit as TE
    from seamlesscloneoptimization_tpu_torch.parallel.clone_tiled import (
        TiledSeamlessClone,
        local_edit_tiled,
    )
    from seamlesscloneoptimization_tpu_torch.parallel.mesh import make_tile_mesh

    if not Path(pkg.__file__).resolve().is_relative_to(root.resolve()):
        raise RuntimeError(f"imported {pkg.__file__}, not the package of {root}")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device")
    rng = np.random.default_rng(SEED)
    src, dst = synthetic_image(rng, SRC_8K), synthetic_image(rng, DST_8K)
    mask = np.full(SRC_8K, 255, np.uint8)
    ctr = (DST_8K[1] // 2, DST_8K[0] // 2)
    img = synthetic_image(rng, EDIT_1080P)
    emask = ellipse_mask(EDIT_1080P, EDIT_BBOX_1080P)
    red, green, blue = EDIT_FACTORS
    mesh = make_tile_mesh([torch.device("cuda")] * (MESH[0] * MESH[1]), MESH)
    out = {}
    for name, path, cycles, loops in SERVES:
        eng = TiledSeamlessClone(CloneConfig(tol=TOL, mg_cycles=cycles), mesh=mesh, path=path)
        res, ms = eng.timed_serve(src, dst, mask, ctr, loops=loops)
        d = digest(res.cpu().numpy())
        # a frame's device work: serves of 4 and of 2 frames (each with its
        # upload, warm-up frame and result) differ by two frames
        n4, us4 = device_work(lambda: eng.timed_serve(src, dst, mask, ctr, loops=4))
        n2, us2 = device_work(lambda: eng.timed_serve(src, dst, mask, ctr, loops=2))
        out[name] = dict(ms_per_frame=ms, loops=loops, digest=d,
                         kernels_per_frame=(n4 - n2) / 2, busy_us_per_frame=(us4 - us2) / 2)
        del eng, res
    for name, path in EDITS:
        def call():
            return local_edit_tiled(img, emask, TE.COLOR_CHANGE, (blue, green, red), mesh=mesh,
                                    path=path)

        res = call()  # warm-up
        times = []
        for _ in range(EDIT_CALLS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        n, us = device_work(call)
        out[name] = dict(ms_per_call=sum(times) / len(times), calls_ms=times,
                         digest=digest(res), kernels_per_call=n, busy_us_per_call=us)
    return out


def card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", type=Path, help="the other checkout's root")
    ap.add_argument("--one", type=Path, help="run one turn in this checkout's root")
    ap.add_argument("--out", type=Path, help="also write the report here")
    args = ap.parse_args()
    if args.one is not None:
        print(json.dumps(one_turn(args.one)))
        return 0
    if args.other is None:
        ap.error("--other or --one is required")
    roots = {"other": args.other.resolve(), "this": HERE}
    print(f"card: {card()}")
    turns = []
    for who in TURNS:
        t0 = time.perf_counter()
        p = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--one",
                            str(roots[who])], capture_output=True, text=True,
                           timeout=TURN_TIMEOUT, cwd=roots[who])
        if p.returncode != 0:
            print(p.stdout[-3000:], p.stderr[-6000:], file=sys.stderr)
            raise SystemExit(f"the {who} turn failed ({roots[who]}): rc {p.returncode}")
        turns.append((who, json.loads(p.stdout.strip().splitlines()[-1])))
        print(f"turn {who}: {time.perf_counter() - t0:.1f} s")
    report = {"card": card(), "turns": [w for w, _ in turns], "cases": {}}
    for name in [s[0] for s in SERVES] + [e[0] for e in EDITS]:
        row = {who: [t[name] for w, t in turns if w == who] for who in ("other", "this")}
        key = "ms_per_frame" if name.startswith("tiled") else "ms_per_call"
        mean = {who: sum(r[key] for r in rs) / len(rs) for who, rs in row.items()}
        row["mean_" + key] = mean
        row["same_output"] = len({r["digest"] for rs in row.values() if isinstance(rs, list)
                                  for r in rs}) == 1
        report["cases"][name] = row
        work = {who: {k: v for k, v in rs[0].items() if k.startswith(("kernels", "busy"))}
                for who, rs in row.items() if isinstance(rs, list)}
        print(f"{name}: {key} other {mean['other']:.4f} "
              f"({[round(r[key], 4) for r in row['other']]}), this {mean['this']:.4f} "
              f"({[round(r[key], 4) for r in row['this']]}), this / other "
              f"{mean['this'] / mean['other']:.4f}; outputs equal {row['same_output']}; "
              f"device work {json.dumps(work)}")
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(report, indent=1))
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
