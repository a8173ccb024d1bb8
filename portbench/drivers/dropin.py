"""The public drop-in, one clone a call: each request is one
``api.seamless_clone(src, dst, mask, center, flags)`` on host numpy
arrays, with the (H, W, 3) u8 image copied back into host memory (the
API's ``to_numpy=True``), timed from the call to its return. This is
upstream's own use, one create-run-destroy call a clone (``SURVEY.md``
2.12-2.13): the API uploads the source, the destination and the mask
from pageable host memory, runs its cached engine and downloads the
answer; the copy back waits for the card, so no other synchronise is
needed.

The pool's pairs are made on the device from the seed, as the serve
driver's are, and kept in host memory. The engine is the API's own, cached
by the API under its settings (``ApiEngine``). Each answer is one unchained
frame: the reference solves it once from its own destination and the
comparison is the serve driver's, as the run driver's for one frame.
"""

from __future__ import annotations

import time

from portbench import reference as plain
from portbench.drivers import serve
from portbench.traffic import Request

mpix = serve.mpix


def inputs(cfg: dict, traffic, seed: int, device) -> dict:
    """The serve driver's seeded inputs, the pool copied to host memory."""
    got = serve.inputs(cfg, traffic, seed, device)
    got["pool"] = [(s.cpu().numpy(), d.cpu().numpy()) for s, d in got["pool"]]
    return got


class ApiEngine:
    """The API's cached engine, reached through ``api.seamless_clone``. The
    API takes a solver and a tolerance alone, so a ``clone_config`` that
    sets anything else is refused (ValueError). ``destroy()`` empties the
    API's engine cache."""

    def __init__(self, clone_config: dict, device):
        from seamlesscloneoptimization_tpu_torch.core.config import CloneConfig

        cfg = CloneConfig(**clone_config)
        if cfg != CloneConfig(solver=cfg.solver, tol=cfg.tol):
            raise ValueError(f"the API takes solver and tol alone, not {clone_config}")
        self.kwargs = {"solver": cfg.solver, "tol": cfg.tol, "device": device}

    def clone(self, src, dst, mask, center, flags: int):
        from seamlesscloneoptimization_tpu_torch import api

        return api.seamless_clone(src, dst, mask, center, flags, **self.kwargs)

    def _cached(self):
        from seamlesscloneoptimization_tpu_torch import api

        k = self.kwargs
        return api._engines.get((k["solver"], k["tol"], str(k["device"])))

    @property
    def metrics(self) -> dict:
        eng = self._cached()
        return {} if eng is None else eng.metrics

    def device_memory_bytes(self) -> int:
        eng = self._cached()
        return 0 if eng is None else eng.device_memory_bytes()

    def destroy(self) -> None:
        from seamlesscloneoptimization_tpu_torch import api

        for eng in api._engines.values():
            eng.destroy()
        api._engines.clear()


def engine(clone_config: dict, device) -> ApiEngine:
    return ApiEngine(clone_config, device)


def warm(cell) -> None:
    """One call of each kind the traffic sends: the API builds its engine
    and the DST bases."""
    for flags, frames in cell.traffic.kinds:
        cell.call(Request(-1, 0, flags, frames))


def call(cell, req: Request, engine=None):
    """One request: (host image, seconds from the call to its return)."""
    if req.frames != 1:
        raise ValueError(f"a drop-in call is one frame, not {req.frames}")
    src, dst = cell.pool[req.pair]
    t = time.perf_counter()
    out = (engine or cell.engine).clone(src, dst, cell.mask, cell.center, req.flags)
    return out, time.perf_counter() - t


def reference(cell, req: Request, solver):
    """The image of one frame solved from the request's own destination, in
    ``solver``'s precision, on the cell's device."""
    import torch

    src, dst = (torch.from_numpy(a).to(cell.device) for a in cell.pool[req.pair])
    mask = torch.from_numpy(cell.mask).to(cell.device)
    return plain.serve_request(src, dst, mask, cell.center, req.flags, 1, solver)


def compare(out, ref, geom: dict) -> dict:
    """``serve.compare`` of the host image."""
    import torch

    return serve.compare(torch.as_tensor(out), ref, geom)
