"""The entry points a cell's requests go through, one module a driver,
found by the name that the cell's traffic file gives under ``"driver"``
(``"serve"`` where it gives none; ``load.driver``).

A driver owns everything that depends on the entry point; the harness
(``harness.py``) owns the rest: the closed-loop window, the reservoir
sample, ``worst`` and ``verdict``, the traced run, freeing the program and
the result line. A driver module gives:

- ``inputs(cfg, traffic, seed, device) -> dict``: the cell's seeded inputs
  and sizes, ``Cell``'s ``pool``, ``mask``, ``center`` and ``geom`` (the
  sizes the cost files under ``kernels/`` read, and ``compare``);
- ``engine(clone_config, device)``: the program's object that serves the
  requests, with ``destroy()``, ``metrics`` and ``device_memory_bytes()``;
- ``warm(cell)``: the warm-up, one request of each kind the traffic sends;
- ``call(cell, req, engine=None) -> (answer, seconds)``: one request on
  ``engine`` (the cell's own where None), the seconds from the call to the
  synchronise after it;
- ``mpix(cell, frames) -> float``: the interior megapixels that ``frames``
  of the traffic's frames complete (a request completes ``req.frames``);
- ``reference(cell, req, solver)``: the reference's answer to a request
  (``solver`` a ``reference.DstSolver``);
- ``compare(answer, ref, geom) -> dict``: the numbers an answer is judged by,
  each the larger the worse (the names ``limits/<cell>.json`` gives).
"""
