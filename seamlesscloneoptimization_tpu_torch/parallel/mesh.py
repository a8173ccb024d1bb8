"""A (ty, tx) grid of devices for the tile-based domain decomposition.

Port of ``seamlesscloneoptimization_tpu/parallel/mesh.py``. A ``TileMesh``
is a (ty, tx) grid of ``torch.device``s; each tile of a sharded (C, H, W)
array lives on its grid cell's device, and a halo exchange moves edge
strips between neighbouring tiles (``parallel/transport.py``).

One process may drive every cell, as JAX's single controller drives every
device of a ``jax.sharding.Mesh`` (its tests use 8 virtual CPU devices).
The same device may appear more than once: four entries of ``cuda:0`` in a
2x2 mesh run the whole decomposition on one card (the decomposition's
overhead, not its scaling). A mesh of CPU devices runs the kernels' plain
twins; the port's tests build one.

After ``init_distributed`` a mesh may span processes, as JAX's mesh spans
hosts after ``jax.distributed.initialize``: ``make_tile_mesh`` joins every
process's devices in rank order, and the mesh records which rank owns each
cell. A process holds the tiles of its own cells only; strips, maxima and
gathers cross to the other ranks through ``torch.distributed``. A
single-process mesh is the case where every cell is this process's.
"""

from __future__ import annotations

import math
import os
import socket
from dataclasses import dataclass

import torch
import torch.distributed as dist

# the transport's process group: None is the default group (gloo); an NCCL
# group when every process has a card of its own (``init_distributed``)
_TRANSPORT = {"group": None}

# whole-array gathers: ``gather_tiles`` and ``parallel/transport.py:gather``
# count each call here (the mesh-resident engine's frames make none)
GATHERS = {"calls": 0}


def reset_gathers() -> None:
    GATHERS["calls"] = 0


def init_distributed(coordinator_address=None, num_processes=None, process_id=None):
    """Join this process to a multi-process mesh (JAX's ``init_distributed``).

    ``torch.distributed.init_process_group`` over gloo: with every argument
    None from the environment (``env://``: ``MASTER_ADDR``,
    ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``), else at
    ``tcp://coordinator_address`` with ``num_processes`` ranks as
    ``process_id`` (an argument left None is read from ``WORLD_SIZE`` /
    ``RANK``). Then the processes compare their CUDA devices: when every
    process has one and no card is another process's too, the strips,
    maxima and gathers go over an NCCL group; otherwise (CPU meshes, or
    several processes on one card, which NCCL refuses) over gloo, with CUDA
    tensors staged through pinned host buffers. Afterwards
    ``make_tile_mesh()`` spans every process. A no-op when the process group
    is already up. Single-process setups never need to call this.
    """
    if dist.is_initialized():
        return
    if coordinator_address is None and num_processes is None and process_id is None:
        dist.init_process_group("gloo", init_method="env://")
    else:
        world = int(os.environ["WORLD_SIZE"] if num_processes is None else num_processes)
        rank = int(os.environ["RANK"] if process_id is None else process_id)
        addr = coordinator_address or (f"{os.environ['MASTER_ADDR']}:"
                                       f"{os.environ['MASTER_PORT']}")
        dist.init_process_group("gloo", init_method=f"tcp://{addr}", world_size=world,
                                rank=rank)
    cards = [None] * dist.get_world_size()
    dist.all_gather_object(cards, _local_cards())
    flat = [c for mine in cards for c in mine]
    if (dist.is_nccl_available() and all(cards) and len(set(flat)) == len(flat)
            and dist.get_world_size() > 1):
        _TRANSPORT["group"] = dist.new_group(backend="nccl")


def _local_cards() -> list[str]:
    """This process's CUDA devices, each as a host-wide name."""
    if not torch.cuda.is_available():
        return []
    host = socket.gethostname()
    out = []
    for i in range(torch.cuda.device_count()):
        uuid = getattr(torch.cuda.get_device_properties(i), "uuid", None)
        out.append(f"{host}/{uuid if uuid is not None else i}")
    return out


def transport_group():
    """The process group the mesh's transfers use (None: the default group)."""
    return _TRANSPORT["group"]


def transport_backend() -> str | None:
    """``"nccl"`` or ``"gloo"`` once the process group is up, else None."""
    if not (dist.is_available() and dist.is_initialized()):
        return None
    return str(dist.get_backend(_TRANSPORT["group"]))


@dataclass(frozen=True)
class TileMesh:
    """A (ty, tx) grid of devices; ``devices[iy][ix]`` holds tile (iy, ix).

    ``owners[iy][ix]`` is the rank of the process that holds that tile, and
    ``rank`` this process's; ``owners=None`` (a single-process mesh) means
    every cell is this process's."""

    devices: tuple[tuple[torch.device, ...], ...]
    owners: tuple[tuple[int, ...], ...] | None = None
    rank: int = 0

    @property
    def shape(self) -> tuple[int, int]:
        return len(self.devices), len(self.devices[0])

    @property
    def size(self) -> int:
        ty, tx = self.shape
        return ty * tx

    @property
    def spans_processes(self) -> bool:
        return self.owners is not None

    def owner(self, iy: int, ix: int) -> int:
        return self.rank if self.owners is None else self.owners[iy][ix]

    def is_local(self, iy: int, ix: int) -> bool:
        return self.owner(iy, ix) == self.rank

    def local_cells(self) -> list[tuple[int, int]]:
        ty, tx = self.shape
        return [(iy, ix) for iy in range(ty) for ix in range(tx) if self.is_local(iy, ix)]

    def distinct(self) -> list[torch.device]:
        """This process's devices, each once, in row-major order of first
        appearance."""
        seen: list[torch.device] = []
        for d in (self.devices[iy][ix] for iy, ix in self.local_cells()):
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

    ``devices`` names this process's devices; ``None`` means every visible
    CUDA device, and raises when there is none: the CPU is used only when
    the caller passes CPU devices. After ``init_distributed`` with more than
    one process, the processes' lists are joined in rank order (every
    process calls this) and the mesh spans them all, as ``jax.devices()``
    does. With ``shape=None`` the most-square factorisation of the device
    count is taken, which minimises the halo perimeter (as in the JAX
    package). Entries may repeat (see the module docstring).
    """
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device for a tile mesh; pass devices "
                               "(e.g. [torch.device('cpu')] * 8) to build a CPU mesh")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [_resolve(d) for d in devices]
    owners, rank = None, 0
    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        lists = [None] * dist.get_world_size()
        dist.all_gather_object(lists, [str(d) for d in devices])
        if not all(lists):
            raise ValueError("every process of a mesh needs at least one device")
        rank = dist.get_rank()
        owners = [r for r, mine in enumerate(lists) for _ in mine]
        devices = [torch.device(d) for mine in lists for d in mine]
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

    def grid(xs):
        return tuple(tuple(xs[iy * tx : (iy + 1) * tx]) for iy in range(ty))

    return TileMesh(grid(devices), None if owners is None else grid(owners), rank)


def shard_tiles(x: torch.Tensor, mesh: TileMesh) -> list[list[torch.Tensor | None]]:
    """Split (C, H, W) into the mesh's (C, H/ty, W/tx) tiles, each a
    contiguous tensor on its grid cell's device (the counterpart of
    ``tile_sharding``: channels replicated, H and W tiled). On a mesh that
    spans processes, the other ranks' cells are None."""
    ty, tx = mesh.shape
    _, h, w = x.shape
    if h % ty or w % tx:
        raise ValueError(f"grid {h}x{w} not divisible by mesh {ty}x{tx}; pad first")
    th, tw = h // ty, w // tx
    return [[x[:, iy * th : (iy + 1) * th, ix * tw : (ix + 1) * tw].to(
        mesh.devices[iy][ix], copy=True).contiguous() if mesh.is_local(iy, ix) else None
        for ix in range(tx)] for iy in range(ty)]


def gather_tiles(tiles, device=None) -> torch.Tensor:
    """Join a (ty, tx) grid of (C, th, tw) tiles into one (C, H, W) tensor on
    ``device`` (default: tile (0, 0)'s device). Every tile must be present:
    a process-spanning grid is joined by ``parallel/transport.py:gather``."""
    GATHERS["calls"] += 1
    device = tiles[0][0].device if device is None else torch.device(device)
    return torch.cat([torch.cat([t.to(device) for t in row], dim=2) for row in tiles], dim=1)
