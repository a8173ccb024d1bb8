"""The engine's serve loop: each request is one call of the port's public
``SeamlessClone(cfg).timed_serve(src, dst, mask, center, loops=F - 1,
flags=...)`` followed by a synchronise, F chained frames (the warm-up frame
and F - 1 timed ones) on the engine's own planar copy of the destination.
``src`` and ``dst`` come from a pool of seeded pairs resident on the card,
the mask is a host u8 array, as the API takes it. The reference replays the
F chained frames (``reference.serve_request``).
"""

from __future__ import annotations

import time

import numpy as np

from portbench import reference as plain
from portbench.inputs import make_mask, make_pool
from portbench.traffic import Request


def center_of(cfg: dict) -> tuple[int, int]:
    if cfg["center"] == "middle":
        return cfg["dst_hw"][1] // 2, cfg["dst_hw"][0] // 2
    return tuple(cfg["center"])


def geometry(cfg: dict, mask: np.ndarray) -> dict:
    """The cell's sizes (``geometry.py``): the ROI is the mask's bbox."""
    import torch

    _, (x0, y0, bw, bh) = plain.prep_mask(torch.from_numpy(mask))
    left, top = plain.roi_placement((x0, y0, bw, bh), cfg["dst_hw"], center_of(cfg))
    return {"c": 3, "bh": bh, "bw": bw, "h": bh - 2, "w": bw - 2, "path": cfg["path"],
            "left": left, "top": top}


def inputs(cfg: dict, traffic, seed: int, device) -> dict:
    """``traffic.pool`` seeded (src, dst) pairs on ``device``, the traffic's
    host mask, the centre and the sizes."""
    pool = make_pool(seed, traffic.pool, cfg["src_hw"], cfg["dst_hw"], device)
    mask = make_mask(traffic.mask, cfg["src_hw"], seed)
    return {"pool": pool, "mask": mask, "center": center_of(cfg), "geom": geometry(cfg, mask)}


def engine(clone_config: dict, device):
    from seamlesscloneoptimization_tpu_torch.core.config import CloneConfig
    from seamlesscloneoptimization_tpu_torch.core.engine import SeamlessClone

    return SeamlessClone(CloneConfig(**clone_config), device=device)


def warm(cell) -> None:
    """One request of each kind the traffic sends, on the traffic's shapes
    only."""
    for flags, frames in cell.traffic.kinds:
        cell.call(Request(-1, 0, flags, frames))


def call(cell, req: Request, engine=None):
    """One request: (output image, seconds from the call to the sync)."""
    src, dst = cell.pool[req.pair]
    t = time.perf_counter()
    out, _ = (engine or cell.engine).timed_serve(src, dst, cell.mask, cell.center,
                                                 loops=req.frames - 1, flags=req.flags)
    cell.sync()
    return out, time.perf_counter() - t


def mpix(cell, frames: int) -> float:
    """Interior megapixels that ``frames`` frames solve and paste."""
    return frames * cell.geom["h"] * cell.geom["w"] * 1e-6


def reference(cell, req: Request, solver):
    """The image after the request's F chained frames, in ``solver``'s
    precision, on the cell's device."""
    import torch

    src, dst = cell.pool[req.pair]
    mask = torch.from_numpy(cell.mask).to(cell.device)
    return plain.serve_request(src, dst, mask, cell.center, req.flags, req.frames, solver)


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
