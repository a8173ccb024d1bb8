"""Poisson solvers on the interior grid: ``solve(g: f32[C, H, W]) -> f32[C, H, W]``
for the 5-point Dirichlet system (boundary values folded into g).

- ``dst_gemm``: exact direct solve, DST eigenbasis as FP32 GEMMs.
- ``dst_fft``: exact direct solve, DST through ``torch.fft`` (no kernel).
- ``jacobi``: red-black Gauss-Seidel (``solve_redblack``; one sweep,
  ``redblack_sweep``), its bursts of sweeps on the card the ``rb_sweeps``
  kernel.
- ``multigrid``: V-cycles with ``padded="q"`` (the quarter-plane finest
  level, from a quartered or a dense RHS, zero or warm start),
  ``padded="t"`` (the transpose-fused V-cycles), ``padded=True`` (the
  dense rounded V-cycles), or on its element path; from zero, a warm start
  or ``fmg_start``, or as the V-cycle preconditioner of ``pcg``
  (``solvers/multigrid.py``).
- ``solve_multigrid_dyn``: the same V-cycles on a runtime (h, w) domain
  inside a padded grid, the ``bucket_exact`` solve
  (``solvers/multigrid_dyn.py``).

``auto`` is not a solver here: the engine resolves it per geometry with
``auto_solver_name`` (``core/engine.py:_effective_solver``).
"""

from seamlesscloneoptimization_tpu_torch.solvers.dst_fft import solve_dst_fft
from seamlesscloneoptimization_tpu_torch.solvers.dst_gemm import solve_dst_gemm
from seamlesscloneoptimization_tpu_torch.solvers.jacobi import redblack_sweep, solve_redblack
from seamlesscloneoptimization_tpu_torch.solvers.multigrid import solve_multigrid
from seamlesscloneoptimization_tpu_torch.solvers.multigrid_dyn import solve_multigrid_dyn

# Size-based selection between the direct DST-GEMM solve and the O(N)
# multigrid. Both constants were measured on a TPU v5e: 7 MP for a
# single-shot solve, 9 MP for the chained serve programs. PERF.md has the
# H100 data points beside them; the constants stay as the JAX package has them.
AUTO_CROSSOVER_PIXELS = 7_000_000
SERVE_CROSSOVER_PIXELS = 9_000_000


def auto_solver_name(shape, crossover: int = AUTO_CROSSOVER_PIXELS) -> str:
    """The size-based selection rule: (C, H, W) -> solver name."""
    _, h, w = shape
    return "multigrid" if h * w > crossover else "dst_gemm"


SOLVERS = {
    "dst_gemm": solve_dst_gemm,
    "dst_fft": solve_dst_fft,
    "jacobi": solve_redblack,
    "multigrid": solve_multigrid,
}


def get_solver(name: str):
    """SOLVERS[name]; ValueError for an unknown name (``auto`` included)."""
    if name in SOLVERS:
        return SOLVERS[name]
    raise ValueError(f"unknown solver {name!r}")


__all__ = [
    "SOLVERS",
    "AUTO_CROSSOVER_PIXELS",
    "SERVE_CROSSOVER_PIXELS",
    "auto_solver_name",
    "get_solver",
    "solve_dst_fft",
    "solve_dst_gemm",
    "solve_multigrid",
    "solve_multigrid_dyn",
    "solve_redblack",
    "redblack_sweep",
]
