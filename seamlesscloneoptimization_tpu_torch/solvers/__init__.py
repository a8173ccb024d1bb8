"""Poisson solvers on the interior grid: ``solve(g: f32[C, H, W]) -> f32[C, H, W]``
for the 5-point Dirichlet system (boundary values folded into g).

Ported: ``dst_gemm`` (exact direct solve, DST eigenbasis as GEMMs) and
``multigrid`` with ``padded="q"`` (the quarter-plane finest level, from a
quartered or a dense RHS, zero or warm start) or ``padded="t"`` (the
transpose-fused V-cycles), or on its element path; its dense fused modes,
``fmg_start`` and ``pcg`` raise NotImplementedError naming their ROADMAP
slice (``solvers/multigrid.py``). The other solvers raise likewise.
``auto`` is not a solver here: the engine resolves it per geometry with
``auto_solver_name`` (``core/engine.py:_effective_solver``).
"""

from seamlesscloneoptimization_tpu_torch.solvers.dst_gemm import solve_dst_gemm
from seamlesscloneoptimization_tpu_torch.solvers.multigrid import (
    MG_PADDED_NOT_PORTED,
    mg_padded_not_ported,
    solve_multigrid,
)

# Size-based selection between the direct DST-GEMM solve and the O(N)
# multigrid. Both constants were measured on a TPU v5e: 7 MP for a
# single-shot solve, 9 MP for the chained serve programs. PERF.md has the
# H100 data points beside them; the constants stay as the JAX package has them.
AUTO_CROSSOVER_PIXELS = 7_000_000
SERVE_CROSSOVER_PIXELS = 9_000_000

NOT_PORTED = {
    "jacobi": "ROADMAP slice 4 (red-black solver)",
    "dst_fft": "ROADMAP slice 4 (DST-FFT solver)",
}


def auto_solver_name(shape, crossover: int = AUTO_CROSSOVER_PIXELS) -> str:
    """The size-based selection rule: (C, H, W) -> solver name."""
    _, h, w = shape
    return "multigrid" if h * w > crossover else "dst_gemm"


def not_ported(name: str, why: str = "") -> NotImplementedError:
    return NotImplementedError(
        f"solver {name!r}{why} is not ported yet: {NOT_PORTED[name]}")


SOLVERS = {
    "dst_gemm": solve_dst_gemm,
    "multigrid": solve_multigrid,
}


def get_solver(name: str):
    """SOLVERS[name]; NotImplementedError for a solver of a later slice."""
    if name in SOLVERS:
        return SOLVERS[name]
    if name in NOT_PORTED:
        raise not_ported(name)
    raise ValueError(f"unknown solver {name!r}")


__all__ = [
    "MG_PADDED_NOT_PORTED",
    "SOLVERS",
    "AUTO_CROSSOVER_PIXELS",
    "SERVE_CROSSOVER_PIXELS",
    "auto_solver_name",
    "get_solver",
    "mg_padded_not_ported",
    "solve_dst_gemm",
    "solve_multigrid",
]
