"""The one traffic generator: it reads a mix's parameters
(``traffic/<name>.json``) and turns a seed into the request stream.

A mix gives:

- ``driver``: the entry point its requests go through,
  ``drivers/<driver>.py`` (``"serve"`` where the mix gives none): ``serve``
  sends each request as one ``timed_serve`` call of chained frames, ``run``
  as back-to-back ``run`` calls, one a frame, each into a new destination;
- ``request_kinds`` (``block`` in the mixes written before drivers, which
  the serve driver alone reads): the kinds of request in a block of
  requests, each ``{"flags": clone flag, "frames": frames, "count": n}``
  (a request's frames as its driver counts them: serve's are the warm-up
  frame and frames - 1 timed ones of one ``timed_serve`` call, run's its
  ``run`` calls); every block holds exactly these requests, shuffled by the
  seed, so every seed sends the same mix in another order. A mix with a
  driver lists them under ``request_kinds``, so that a harness older than
  the drivers, which reads ``block``, refuses it in its set-up instead of
  sending its requests through ``timed_serve``;
- ``mask``: ``"full"`` or an ellipse spec (``inputs.make_mask``);
- ``pool``: how many seeded (src, dst) pairs live on the device; each
  request draws its pair from the seed;
- ``sample``: how many finished requests are compared with the reference
  once the window has closed (a reservoir sample drawn from the seed);
- ``trace_requests``: the requests a ``--trace 1`` run profiles;
- ``why``, ``source``, ``assumed``: prose, not read: what the mix stands
  for, and where each of its numbers comes from.

The loop is closed with one client: a request is sent when the one before
it has returned.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from portbench.inputs import MASK64

FLAG_NAMES = {1: "NORMAL_CLONE", 2: "MIXED_CLONE", 3: "MONOCHROME_TRANSFER"}


@dataclass(frozen=True)
class Request:
    index: int
    pair: int
    flags: int
    frames: int


class Traffic:
    def __init__(self, spec: dict, seed: int):
        self.driver = spec.get("driver", "serve")
        if ("block" in spec) == ("request_kinds" in spec):
            raise ValueError(f"bad traffic spec {spec}: give one of block, request_kinds")
        if "block" in spec and self.driver != "serve":
            raise ValueError(f"the {self.driver} driver's kinds go under request_kinds")
        kinds = spec["block"] if "block" in spec else spec["request_kinds"]
        self.pool = int(spec["pool"])
        self.mask = spec["mask"]
        self.sample = int(spec["sample"])
        self.trace_requests = int(spec["trace_requests"])
        self.block = [(int(k["flags"]), int(k["frames"])) for k in kinds
                      for _ in range(int(k["count"]))]
        if self.pool < 1 or not self.block:
            raise ValueError(f"bad traffic spec {spec}")
        for f, n in self.block:
            if f not in FLAG_NAMES or n < 1:
                raise ValueError(f"bad request kind: flags {f}, frames {n}")
        self.seed = seed & MASK64
        self._blocks: dict[int, list[Request]] = {}

    @property
    def kinds(self) -> list[tuple[int, int]]:
        """The distinct (flags, frames) the mix sends."""
        return sorted(set(self.block))

    def request(self, i: int) -> Request:
        b, k = divmod(i, len(self.block))
        if b not in self._blocks:
            rng = np.random.default_rng([self.seed, 3, b])
            order = rng.permutation(len(self.block))
            pairs = rng.integers(0, self.pool, len(self.block))
            self._blocks = {b: [Request(b * len(self.block) + j, int(p), *self.block[o])
                                for j, (p, o) in enumerate(zip(pairs, order))]}
        return self._blocks[b][k]


class Reservoir:
    """A uniform sample of ``k`` items from a stream of unknown length,
    decided by the seed (Algorithm R)."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = np.random.default_rng([seed & MASK64, 4])
        self.items: list = []
        self.seen = 0

    def offer(self, item) -> None:
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(item)
            return
        j = int(self.rng.integers(0, self.seen))
        if j < self.k:
            self.items[j] = item
