"""Logical sizes of a cell's stages, for the cost files under ``kernels/``.

``geom`` (``harness.geometry``) is a dict: ``c`` channels, ``bh`` x ``bw``
the ROI (the mask's bbox), ``h`` x ``w`` its interior (the Poisson
grid), ``path`` the solver chain the configuration runs (``"dst_pair"``:
the folded DST-GEMM pair chain; ``"mg_q"``: the multigrid with its finest
level as quarter planes). The level rule below is the multigrid's own
(coarse size (m - 1) // 2 an axis; each coarse level transposed; levels of
at least 2^16 points and a side above 63 run the fused level kernels), a
copy of its arithmetic and not an import.
"""

from __future__ import annotations

FUSE_MIN_T = 1 << 16
COARSEST = 63


def coarse(m: int) -> int:
    return (m - 1) // 2


def mg_q_coarse_levels(h: int, w: int) -> list[tuple[int, int]]:
    """The fused coarse levels (h, w) below an (h, w) quarter-plane level,
    in descent order, each the transposed child of the one before."""
    levels = []
    lh, lw = coarse(w), coarse(h)
    while (min(lh, lw) > COARSEST and min(coarse(lh), coarse(lw)) >= 1
           and lh * lw >= FUSE_MIN_T):
        levels.append((lh, lw))
        lh, lw = coarse(lw), coarse(lh)
    return levels


def for_launches(launches: int, per: int, ops: float, nbytes: float) -> tuple[float, float]:
    """(ops, bytes) of ``launches`` launches of a stage whose ``per``
    launches do ``ops`` and move ``nbytes``."""
    k = launches / per
    return k * ops, k * nbytes
