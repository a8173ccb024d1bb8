"""The tile grid's transport: halo strips, maxima and gathers over a ``TileMesh``.

One layer decides, per transfer, between a copy inside this process and a
transfer to or from the rank that owns the other cell (``torch.distributed``
on the group ``parallel/mesh.py:transport_group`` names). A tile grid is a
(ty, tx) list of lists holding this process's tiles; the other ranks' cells
are None. Tiles may be uneven (the last row or column of tiles shorter),
as long as the tiles of one grid row share their height and those of one
grid column their width.

- ``halo_exchange``: each local tile padded with k ghosts from its eight
  neighbours (zeros past the grid). Every rank walks the same global list
  of (receiving cell, direction) pairs, edges then corners, and posts a
  receive where it owns the receiver and a send where it owns the sender
  of a strip that crosses processes, all in one ``batch_isend_irecv``; the
  pair's index is the tag. So every rank posts matching operations in the
  same order. Everything runs on each device's current stream.
- ``halo_exchange_start`` / ``halo_exchange_finish``: the same exchange
  split in two, off the current stream. On CUDA tiles the copies run on a
  side stream of each device, which first waits for the
  ``ready_events`` the caller recorded once the tiles were produced; over
  gloo the strips go to pinned host buffers on the side stream, which the
  host waits for alone before it posts the transfers, and the landings go
  back to the card on it. ``start`` posts everything and returns; work
  queued on the current stream between the two (the interior sweeps of
  ``parallel/tiled.py:solve_redblack_tiled(overlap=True)``) runs
  meanwhile. ``finish`` waits for the transfers, lands the strips and
  makes each current stream wait for its side stream. The tags and the
  order of the posted operations are ``halo_exchange``'s. On CPU tiles the
  same steps run in program order.
- ``grid_max``: the local max, then ``all_reduce(MAX)``. max is exact, so
  every rank takes the same decision from it.
- ``gather``: the whole array on a device of this process: one
  ``all_gather`` of each rank's tiles, packed flat and padded to the
  longest rank's. Each call counts in ``mesh.GATHERS``.
- ``replicate``: the same join, put on each of this process's devices: a
  level that the solvers solve whole on every device (a coarse level, a
  grid too small to partition). Not a gather of the frame: it counts in
  ``REPLICATED`` instead.
- ``windows``: for each local cell a rectangle of the global array,
  assembled from the tiles that overlap it (a copy inside this process, a
  point-to-point transfer across processes, zeros past the array): the
  ghost rings of the mesh-resident destination. Tiles follow any row and
  column boundaries, empty tiles included.

``CROSSED`` counts what this process sends to other ranks: point-to-point
strips and collective contributions (``transfers``) and their ``bytes``;
``reset_crossed`` sets both to 0.

Over gloo, CUDA tensors are staged through pinned host buffers (gloo's
point-to-point transfers take host memory); over NCCL every tile must be a
CUDA tensor. A failed transfer raises.
"""

from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist

from seamlesscloneoptimization_tpu_torch.parallel.mesh import GATHERS, TileMesh, transport_group

# the eight neighbours of a cell: edges, then corners
DIRS = ((-1, 0), (1, 0), (0, -1), (0, 1), (-1, -1), (-1, 1), (1, -1), (1, 1))

CROSSED = {"transfers": 0, "bytes": 0}
# what ``replicate`` joined: calls, and the bytes of the joined arrays
REPLICATED = {"calls": 0, "bytes": 0}


def reset_crossed() -> None:
    for key in CROSSED:
        CROSSED[key] = 0
    for key in REPLICATED:
        REPLICATED[key] = 0


def _crossed(t: torch.Tensor) -> None:
    CROSSED["transfers"] += 1
    CROSSED["bytes"] += t.numel() * t.element_size()


def _spans(mesh: TileMesh | None) -> bool:
    return mesh is not None and mesh.spans_processes


def _gloo() -> bool:
    return dist.get_backend(transport_group()) == "gloo"


def _wire(t: torch.Tensor, non_blocking: bool = False) -> torch.Tensor:
    """``t`` as the transport sends it: contiguous, and over gloo on the host
    (a pinned copy of a CUDA tensor; ``non_blocking``: queued on the current
    stream, which the caller synchronizes before the transfer reads it)."""
    if t.is_cuda and _gloo():
        buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        buf.copy_(t, non_blocking=non_blocking)
        return buf
    if not t.is_cuda and not _gloo():
        raise ValueError("an NCCL transport moves CUDA tensors only; got a CPU tile")
    return t.contiguous()


def _landing(shape, like: torch.Tensor) -> torch.Tensor:
    """A buffer to receive into, for a tensor that ends on ``like``'s device."""
    if like.is_cuda and _gloo():
        return torch.empty(shape, dtype=like.dtype, pin_memory=True)
    return torch.empty(shape, dtype=like.dtype, device=like.device)


def _wait(ops: list) -> None:
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()


_SIDE: dict = {}  # torch.device -> this process's side stream on it


def _side_stream(device: torch.device) -> torch.cuda.Stream:
    """The side stream of ``halo_exchange_start`` on a CUDA device (a
    tensor's, with its index), made on first use (the creation's error is
    raised)."""
    stream = _SIDE.get(device)
    if stream is None:
        stream = _SIDE[device] = torch.cuda.Stream(device=device)
    return stream


def _cuda_devices(tiles) -> list:
    """The distinct CUDA devices of a grid's local tiles, in grid order."""
    devs = []
    for row in tiles:
        for t in row:
            if t is not None and t.is_cuda and t.device not in devs:
                devs.append(t.device)
    return devs


def ready_events(tiles) -> dict:
    """{device: an event recorded now on its current stream} for each CUDA
    device of the grid's local tiles: the point after which they are
    produced. Record it before queuing work that the exchange need not
    wait for, and pass it to ``halo_exchange_start``."""
    out = {}
    for d in _cuda_devices(tiles):
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(d))
        out[d] = ev
    return out


class Exchange:
    """A posted halo exchange (``halo_exchange_start``): the ghosted tiles
    being filled, the transfers in flight and their landings, the side
    streams."""

    __slots__ = ("out", "works", "landed", "sides")

    def __init__(self, out, works, landed, sides):
        self.out, self.works, self.landed, self.sides = out, works, landed, sides


def _on(streams: dict) -> contextlib.ExitStack:
    """A context making each stream its device's current stream."""
    stack = contextlib.ExitStack()
    for stream in streams.values():
        stack.enter_context(torch.cuda.stream(stream))
    return stack


def _ghost(d: int, n: int, k: int) -> slice:
    """Where the strip from direction d lands along an axis of length n."""
    return {-1: slice(0, k), 0: slice(k, k + n), 1: slice(k + n, n + 2 * k)}[d]


def _strip(d: int, k: int) -> slice:
    """Which part of the neighbour in direction d is the strip, along an axis."""
    return {-1: slice(-k, None), 0: slice(None), 1: slice(0, k)}[d]


def halo_exchange(tiles, k: int = 1, mesh: TileMesh | None = None):
    """Pad every local (C, th, tw) tile of a (ty, tx) grid with k-px ghosts.

    The ghosts are the neighbours' edge strips; corners come from the
    diagonal neighbours, as JAX's rows-then-columns exchange of the
    row-extended tiles gives them. Tiles on the grid's edge get zeros there
    (the Dirichlet frame). Returns the grid of (C, th + 2k, tw + 2k) tiles,
    each on its tile's device (None for the other ranks' cells): the
    windows of the globally zero-padded array. ``mesh``: needed when the
    grid spans processes (who owns each None cell); without it every tile
    must be present.
    """
    out, ops, landed = _post(tiles, k, mesh, non_blocking=False)
    _wait(ops)
    for x, dst, buf in landed:
        x[dst].copy_(buf)
    return out


def halo_exchange_start(tiles, k: int, mesh: TileMesh | None, ready: dict) -> Exchange:
    """Post ``halo_exchange(tiles, k, mesh)`` off the current stream and
    return its handle for ``halo_exchange_finish``. ``ready``: the
    ``ready_events`` of ``tiles``. On CUDA tiles each device's side stream
    waits for its event, then makes the ghosted tiles, copies the strips
    inside this process, zero-fills the frame's ghosts and, over gloo,
    copies the strips for other ranks to pinned buffers; the host waits
    for the side streams only, then posts the transfers."""
    sides = {d: _side_stream(d) for d in _cuda_devices(tiles)}
    for d, stream in sides.items():
        stream.wait_event(ready[d])
    for row in tiles:  # read on the side streams: not reused before they are done
        for t in row:
            if t is not None and t.is_cuda:
                t.record_stream(sides[t.device])
    with _on(sides):
        out, ops, landed = _post(tiles, k, mesh, non_blocking=True)
        if ops and sides and _gloo():
            for stream in sides.values():  # the pinned strips are written
                stream.synchronize()
        works = dist.batch_isend_irecv(ops) if ops else []
    return Exchange(out, works, landed, sides)


def halo_exchange_finish(ex: Exchange):
    """Wait for a posted exchange's transfers, land the strips (on the side
    streams) and make each device's current stream wait for its side
    stream. Returns the grid of ghosted tiles, as ``halo_exchange`` does."""
    with _on(ex.sides):
        for work in ex.works:
            work.wait()
        for x, dst, buf in ex.landed:
            x[dst].copy_(buf, non_blocking=True)
    for d, stream in ex.sides.items():
        torch.cuda.current_stream(d).wait_stream(stream)
    for row in ex.out:  # made on a side stream, used on the current one
        for x in row:
            if x is not None and x.is_cuda:
                x.record_stream(torch.cuda.current_stream(x.device))
    return ex.out


def _post(tiles, k: int, mesh: TileMesh | None, non_blocking: bool):
    """The ghosted tiles with their centres, the strips from this process's
    tiles and the zeros past the grid in place; the transfers to post, each
    strip for another rank through ``_wire(strip, non_blocking)``; and
    (tile, ghost slice, buffer) for each strip that lands from another
    rank."""
    ty, tx = len(tiles), len(tiles[0])
    spans = _spans(mesh)
    local = mesh.is_local if spans else (lambda iy, ix: True)
    group = transport_group() if spans else None
    out = [[None] * tx for _ in range(ty)]
    for iy in range(ty):
        for ix in range(tx):
            if local(iy, ix):
                t = tiles[iy][ix]
                c, th, tw = t.shape
                if min(th, tw) < k:
                    raise ValueError(f"tile {th}x{tw} smaller than the halo {k}")
                x = t.new_empty((c, th + 2 * k, tw + 2 * k))
                x[:, k : k + th, k : k + tw] = t
                out[iy][ix] = x
    ops, landed = [], []
    for iy in range(ty):
        for ix in range(tx):
            for d, (dy, dx) in enumerate(DIRS):
                ny, nx = iy + dy, ix + dx
                inside = 0 <= ny < ty and 0 <= nx < tx
                tag = (iy * tx + ix) * len(DIRS) + d
                if local(iy, ix):
                    x = out[iy][ix]
                    c, th, tw = tiles[iy][ix].shape
                    dst = (slice(None), _ghost(dy, th, k), _ghost(dx, tw, k))
                    if not inside:
                        x[dst].zero_()
                    elif local(ny, nx):  # a strip from a neighbour in this process
                        x[dst].copy_(tiles[ny][nx][:, _strip(dy, k), _strip(dx, k)])
                    else:
                        buf = _landing((c, k if dy else th, k if dx else tw), x)
                        ops.append(dist.P2POp(dist.irecv, buf, mesh.owner(ny, nx), group, tag))
                        landed.append((x, dst, buf))
                elif inside and local(ny, nx):  # this process's strip for another rank
                    strip = _wire(tiles[ny][nx][:, _strip(dy, k), _strip(dx, k)], non_blocking)
                    _crossed(strip)
                    ops.append(dist.P2POp(dist.isend, strip, mesh.owner(iy, ix), group, tag))
    return out, ops, landed


def map_local(mesh: TileMesh, fn, *grids):
    """[[fn(iy, ix, *cells)]] over this process's cells of the grids, None
    elsewhere."""
    ty, tx = mesh.shape
    return [[fn(iy, ix, *(g[iy][ix] for g in grids)) if mesh.is_local(iy, ix) else None
             for ix in range(tx)] for iy in range(ty)]


def grid_max(vals, device, mesh: TileMesh | None = None) -> torch.Tensor:
    """The max of this process's 0-dim tensors, over every rank of a
    process-spanning mesh, as a 0-dim tensor on ``device`` (no host read)."""
    m = torch.stack([v.to(device) for v in vals]).max()
    if not _spans(mesh):
        return m
    w = _wire(m.reshape(1))
    _crossed(w)
    dist.all_reduce(w, op=dist.ReduceOp.MAX, group=transport_group())
    return w.to(device).reshape(())


def gather(tiles, device, mesh: TileMesh | None = None, shape_of=None) -> torch.Tensor:
    """The (C, H, W) array of a tile grid on ``device``. On a mesh that spans
    processes every rank calls this and gets the whole array;
    ``shape_of(iy, ix)`` gives the other ranks' tile shapes."""
    GATHERS["calls"] += 1
    return _join(tiles, torch.device(device), mesh, shape_of)


def replicate(tiles, mesh: TileMesh, shape_of) -> dict:
    """{device: the (C, H, W) array of the grid} for each of this process's
    devices: the join of ``gather`` on the first, copied to the others."""
    devs = mesh.distinct()
    whole = _join(tiles, devs[0], mesh, shape_of)
    REPLICATED["calls"] += 1
    REPLICATED["bytes"] += whole.numel() * whole.element_size()
    return {d: whole if d == devs[0] else whole.to(d) for d in devs}


def _join(tiles, device: torch.device, mesh: TileMesh | None, shape_of) -> torch.Tensor:
    if _spans(mesh):
        tiles = _all_tiles(tiles, mesh, shape_of, device)
    return torch.cat([torch.cat([t.to(device) for t in row], dim=2) for row in tiles], dim=1)


def all_cells(tiles, device, mesh: TileMesh, shape_of):
    """Every cell's tensor of a grid in this process, on ``device``: the
    local ones copied, the other ranks' by one ``all_gather`` (the batch's
    job blocks, any number of dimensions); ``shape_of(iy, ix)`` gives each
    cell's shape."""
    device = torch.device(device)
    if _spans(mesh):
        tiles = _all_tiles(tiles, mesh, shape_of, device)
    return [[t.to(device) for t in row] for row in tiles]


def _overlap(a: tuple, b: tuple):
    """The intersection of two (r0, r1, c0, c1) rectangles, or None."""
    r0, r1, c0, c1 = max(a[0], b[0]), min(a[1], b[1]), max(a[2], b[2]), min(a[3], b[3])
    return (r0, r1, c0, c1) if r0 < r1 and c0 < c1 else None


def windows(tiles, rows, cols, want, mesh: TileMesh, like: torch.Tensor | None = None):
    """Each local cell's window ``want(iy, ix)`` = (r0, r1, c0, c1), in the
    global coordinates of the array whose tile (iy, ix) is rows[iy] ..
    rows[iy + 1] by cols[ix] .. cols[ix + 1] (``tiles`` holds this
    process's, (C, rows, cols) each, on its cell's device; a tile may be
    empty). Parts past the array are zero. Every rank walks the same list
    of (receiving cell, sending cell) pairs in row-major order and posts
    its receives and sends of the pairs that cross processes in one
    ``batch_isend_irecv``, the pair's index the tag. ``like``: a tensor of
    the grid's dtype and channels, for a process with no tile of its own
    that is not empty. Returns the grid of windows (None for the other
    ranks' cells)."""
    ty, tx = mesh.shape
    spans = _spans(mesh)
    group = transport_group() if spans else None
    cells = [(iy, ix) for iy in range(ty) for ix in range(tx)]
    box = {(iy, ix): (rows[iy], rows[iy + 1], cols[ix], cols[ix + 1]) for iy, ix in cells}
    ref = like if like is not None else next(t for row in tiles for t in row if t is not None)
    c = ref.shape[0]
    out = [[None] * tx for _ in range(ty)]
    for cell in mesh.local_cells():
        r0, r1, c0, c1 = want(*cell)
        out[cell[0]][cell[1]] = torch.zeros((c, r1 - r0, c1 - c0), dtype=ref.dtype,
                                            device=mesh.devices[cell[0]][cell[1]])
    ops, landed = [], []
    for a_i, a in enumerate(cells):
        wa = want(*a)
        for b_i, b in enumerate(cells):
            part = _overlap(wa, box[b])
            if part is None:
                continue
            r0, r1, c0, c1 = part
            dst = (slice(None), slice(r0 - wa[0], r1 - wa[0]), slice(c0 - wa[2], c1 - wa[2]))
            src = (slice(None), slice(r0 - box[b][0], r1 - box[b][0]),
                   slice(c0 - box[b][2], c1 - box[b][2]))
            tag = a_i * len(cells) + b_i
            if mesh.is_local(*a):
                x = out[a[0]][a[1]]
                if mesh.is_local(*b):
                    x[dst].copy_(tiles[b[0]][b[1]][src])
                else:
                    buf = _landing((c, r1 - r0, c1 - c0), x)
                    ops.append(dist.P2POp(dist.irecv, buf, mesh.owner(*b), group, tag))
                    landed.append((x, dst, buf))
            elif mesh.is_local(*b):
                part_t = _wire(tiles[b[0]][b[1]][src])
                _crossed(part_t)
                ops.append(dist.P2POp(dist.isend, part_t, mesh.owner(*a), group, tag))
    _wait(ops)
    for x, dst, buf in landed:
        x[dst].copy_(buf)
    return out


def _all_tiles(tiles, mesh: TileMesh, shape_of, device):
    """Every tile of the grid in this process: one ``all_gather`` of each
    rank's tiles, flat in row-major order, padded to the longest rank's."""
    ty, tx = mesh.shape
    cells = [(iy, ix) for iy in range(ty) for ix in range(tx)]
    world = dist.get_world_size()
    numel = {c: int(torch.Size(shape_of(*c)).numel()) for c in cells}
    totals = [sum(numel[c] for c in cells if mesh.owner(*c) == r) for r in range(world)]
    mine = [tiles[iy][ix] for iy, ix in mesh.local_cells()]
    lead = mine[0]
    wire_dev = torch.device("cpu") if _gloo() else lead.device
    buf = torch.zeros(max(totals), dtype=lead.dtype, device=wire_dev)
    flat = torch.cat([t.reshape(-1).to(wire_dev) for t in mine])
    buf[: flat.numel()] = flat
    got = [torch.empty_like(buf) for _ in range(world)]
    _crossed(buf)
    dist.all_gather(got, buf, group=transport_group())
    out = [[None] * tx for _ in range(ty)]
    offset = [0] * world
    for iy, ix in cells:
        r = mesh.owner(iy, ix)
        if r == mesh.rank:
            out[iy][ix] = tiles[iy][ix]
        else:
            n = numel[iy, ix]
            out[iy][ix] = got[r][offset[r] : offset[r] + n].reshape(shape_of(iy, ix)).to(device)
        offset[r] += numel[iy, ix]
    return out
