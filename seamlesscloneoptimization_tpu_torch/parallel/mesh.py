"""A (ty, tx) grid of devices for the tile-based domain decomposition.

Port of ``seamlesscloneoptimization_tpu/parallel/mesh.py``. The JAX package
runs its meshes from one controller: one program drives every device of a
``jax.sharding.Mesh`` (its tests use 8 virtual CPU devices). The port keeps
that model: a ``TileMesh`` is a (ty, tx) grid of ``torch.device``s, one
process drives all of them, each tile of a sharded (C, H, W) array lives on
its grid cell's device, and a halo exchange copies edge strips between
neighbouring tiles (``parallel/tiled.py``).

The same device may appear more than once. Four entries of ``cuda:0`` in a
2x2 mesh run the whole decomposition on one card: four tiles, halo copies,
global-coordinate colours and the replicated coarse solve. That is the
counterpart of JAX's virtual mesh and what a one-card machine can measure
(the decomposition's overhead, not its scaling). A mesh of CPU devices runs
the kernels' plain twins; the port's tests build one.

Not ported: ``init_distributed`` (a multi-process mesh on
``torch.distributed``; ROADMAP §1 item 7).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class TileMesh:
    """A (ty, tx) grid of devices; ``devices[iy][ix]`` holds tile (iy, ix)."""

    devices: tuple[tuple[torch.device, ...], ...]

    @property
    def shape(self) -> tuple[int, int]:
        return len(self.devices), len(self.devices[0])

    @property
    def size(self) -> int:
        ty, tx = self.shape
        return ty * tx

    def distinct(self) -> list[torch.device]:
        """Each device once, in row-major order of first appearance."""
        seen: list[torch.device] = []
        for d in (d for row in self.devices for d in row):
            if d not in seen:
                seen.append(d)
        return seen


def _resolve(d) -> torch.device:
    """A device with its index: ``cuda`` means the current CUDA device (so
    that repeated entries compare equal); a CUDA device without a card
    raises."""
    d = torch.device(d)
    if d.type == "cpu":
        return d
    if d.type != "cuda":
        raise ValueError(f"unsupported device {d}")
    if not torch.cuda.is_available():
        raise RuntimeError(f"CUDA is not available for mesh device {d}")
    return d if d.index is not None else torch.device("cuda", torch.cuda.current_device())


def make_tile_mesh(devices=None, shape: tuple[int, int] | None = None) -> TileMesh:
    """A (ty, tx) ``TileMesh`` over ``devices``.

    ``devices=None`` means every visible CUDA device, and raises when there
    is none: the CPU is used only when the caller passes CPU devices. With
    ``shape=None`` the most-square factorisation of the device count is
    taken, which minimises the halo perimeter (as in the JAX package).
    Entries may repeat (see the module docstring).
    """
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device for a tile mesh; pass devices "
                               "(e.g. [torch.device('cpu')] * 8) to build a CPU mesh")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [_resolve(d) for d in devices]
    n = len(devices)
    if n == 0:
        raise ValueError("a tile mesh needs at least one device")
    if shape is None:
        ty = int(math.sqrt(n))
        while n % ty:
            ty -= 1
        shape = (ty, n // ty)
    ty, tx = (int(x) for x in shape)
    if ty < 1 or tx < 1 or ty * tx != n:
        raise ValueError(f"mesh shape {tuple(shape)} != device count {n}")
    return TileMesh(tuple(tuple(devices[iy * tx : (iy + 1) * tx]) for iy in range(ty)))


def shard_tiles(x: torch.Tensor, mesh: TileMesh) -> list[list[torch.Tensor]]:
    """Split (C, H, W) into the mesh's (C, H/ty, W/tx) tiles, each a
    contiguous tensor on its grid cell's device (the counterpart of
    ``tile_sharding``: channels replicated, H and W tiled)."""
    ty, tx = mesh.shape
    _, h, w = x.shape
    if h % ty or w % tx:
        raise ValueError(f"grid {h}x{w} not divisible by mesh {ty}x{tx}; pad first")
    th, tw = h // ty, w // tx
    return [[x[:, iy * th : (iy + 1) * th, ix * tw : (ix + 1) * tw].to(
        mesh.devices[iy][ix], copy=True).contiguous() for ix in range(tx)]
        for iy in range(ty)]


def gather_tiles(tiles, device=None) -> torch.Tensor:
    """Join a (ty, tx) grid of (C, th, tw) tiles into one (C, H, W) tensor on
    ``device`` (default: tile (0, 0)'s device)."""
    device = tiles[0][0].device if device is None else torch.device(device)
    return torch.cat([torch.cat([t.to(device) for t in row], dim=2) for row in tiles], dim=1)
