"""The engine's single-shot ``run``, a video insert: each request is F calls
of the port's public ``SeamlessClone(cfg).run(src, dst_k, mask, center,
flags=...)`` back to back, with no synchronise between them, then one
synchronise after the F-th. Call k composites the patch of pool pair p (the
request's pair) into the destination of pool pair (p + k) % pool: a new
resident frame each call, as a decoded video gives one. ``run`` clones the
destination (``donate_dst`` is off), so the pool is never written. The
answer is the F outputs, (H, W, 3) each; the reference solves each frame
once from its own fresh destination (``reference.serve_request`` of one
frame), and a request reads the worst of its frames.

The inputs, the engine and the image comparison are the serve driver's
(``serve.py``).
"""

from __future__ import annotations

import time

from portbench import reference as plain
from portbench.drivers import serve
from portbench.traffic import Request

inputs, engine, mpix = serve.inputs, serve.engine, serve.mpix


def warm(cell) -> None:
    """One request of each kind the traffic sends, and, with their answers
    held, more of the longest kind up to as many answers as the window holds
    at once (the sample, the last request's and the one in flight). The
    caching allocator then keeps the blocks of the 16 images a request
    returns, and no ``cudaMalloc`` (which stalls the card for tens of ms
    over a request's 16 images) falls inside the window."""
    kinds = cell.traffic.kinds
    longest = max(kinds, key=lambda k: k[1])
    held = [cell.call(Request(-1, 0, *k))[0] for k in kinds]
    held += [cell.call(Request(-1, 0, *longest))[0]
             for _ in range(cell.traffic.sample + 2 - len(kinds))]
    del held  # into the allocator's cache


def dst_of(cell, req: Request, k: int):
    """The destination of a request's call k."""
    return cell.pool[(req.pair + k) % len(cell.pool)][1]


def call(cell, req: Request, engine=None):
    """One request: (the F output images, seconds from the first call to the
    sync after the last)."""
    eng = engine or cell.engine
    src = cell.pool[req.pair][0]
    t = time.perf_counter()
    outs = [eng.run(src, dst_of(cell, req, k), cell.mask, cell.center, flags=req.flags)
            for k in range(req.frames)]
    cell.sync()
    return outs, time.perf_counter() - t


def reference(cell, req: Request, solver) -> list:
    """Each call's image: one frame from its own destination."""
    import torch

    src = cell.pool[req.pair][0]
    mask = torch.from_numpy(cell.mask).to(cell.device)
    return [plain.serve_request(src, dst_of(cell, req, k), mask, cell.center, req.flags, 1,
                                solver) for k in range(req.frames)]


def compare(outs: list, refs: list, geom: dict) -> dict:
    """``serve.compare`` of each frame; each number the worst over the
    frames."""
    if len(outs) != len(refs):
        raise ValueError(f"{len(outs)} frames against the reference's {len(refs)}")
    rows = [serve.compare(o, r, geom) for o, r in zip(outs, refs)]
    return {k: max(r[k] for r in rows) for k in rows[0]}
