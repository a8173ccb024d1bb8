"""Runtime configuration: a field-for-field mirror of the JAX ``CloneConfig``.

Same fields, same defaults (``seamlesscloneoptimization_tpu/core/config.py``),
so a configuration carries across with ``config_from_jax``. This system has
no weights: the only other carried state is the DST basis, which the port
rebuilds bit-equal on the host (``solvers/dst_gemm.py``).

What the port runs of it (ROADMAP slices 1 to 4c and 8a): every ``solver``
("auto", "dst_gemm", "dst_fft", "jacobi", "multigrid"), every ``flags``
mode and ``mixed_rule``, every ``precision`` of the JAX package ("high" and
"highest" FP32 on the card, TF32 off; "default", "2x_img", "2x_v", "fwd2x"
and "inv2x" the bf16 passes of ``solvers/dst_gemm.py``), ``dst_folded``,
``donate_dst``, for jacobi ``tol`` and ``max_iters``, for multigrid
``tol``, ``max_cycles``, ``mg_cycles`` and ``mg_padded`` "q" (the default,
the quarter-plane finest level), "t", True (the dense rounded V-cycles) or
False, and for both ``use_pallas_smoother``.
``dst_folded=True`` folds each axis where the JAX package does
(``solvers/dst_gemm.py:fold_pays``, every side above 128 px): the folded
pair chain when both sides fold, the per-axis branch when one does. "auto"
picks multigrid above the crossover, as in the JAX package.
``use_pallas_preprocess`` and ``use_pallas_postprocess`` select the route
on the card as they select it on the TPU (``core/engine.py``,
``models/pipeline.py:clone_roi``): without the pre-process the RHS is the
plain torch stages, without the post-process (or for jacobi and dst_fft)
the exact-size solve is pasted by ``clamp_cast_paste``, and dst_gemm with
the post-process but not the pre-process ends in the
``postprocess_transposed`` kernel. ``bbox_bucket`` rounds the ROI up to a
multiple, solving the grown bucket, or with ``bucket_exact`` the tight bbox's
own system inside it (``solvers/multigrid_dyn.py``, to ``tol`` or for
``mg_cycles`` cycles, up to ``max_cycles``). ``debug_dump`` and
``debug_dir`` are carried for the CLI, which reads the first; the engine's
``dump_stages`` writes into the second.
"""

from __future__ import annotations

import dataclasses
import os

_DEFAULT_CACHE_DIR = os.environ.get(
    "SCL_TPU_CACHE_DIR",
    os.path.join(os.path.expanduser("~"), ".cache", "seamlessclone_tpu", "jax"),
)

NORMAL_CLONE = 1
MIXED_CLONE = 2
MONOCHROME_TRANSFER = 3


@dataclasses.dataclass(frozen=True)
class CloneConfig:
    """Configuration for a SeamlessClone engine instance."""

    solver: str = "auto"  # auto | dst_gemm | dst_fft | jacobi | multigrid
    precision: str = "high"  # DST-GEMM passes: "high"/"highest" FP32 (TF32 off), or bf16
    dst_folded: bool = True  # even/odd-folded DST GEMMs where fold_pays(n)
    flags: int = NORMAL_CLONE
    mixed_rule: str = "opencv"  # MIXED_CLONE comparison: "opencv" | "norm"
    tol: float = 1e-4  # relative residual tolerance (iterative solvers)
    max_iters: int = 10000  # jacobi sweep cap
    max_cycles: int = 60  # multigrid V-cycle cap
    mg_cycles: int | None = None  # fixed-work multigrid cycles
    # For multigrid these two select the chain, as in the JAX package:
    # use_pallas_smoother=True with mg_padded="q" (the quarter-plane finest
    # level, at any tol: one with no check-free cycle, >= 0.0225, runs the
    # check-first loop) or "t" (the transpose-fused V-cycle) runs the fused
    # kernels on grids of at least 2^18 points (smaller grids, or
    # use_pallas_smoother=False, run the plain element path); False runs the
    # element V-cycle with its levels of at least 2^18 points fused; True
    # the dense rounded V-cycles (vcycle_p). For jacobi,
    # use_pallas_smoother runs each burst of sweeps as the rb_sweeps kernel.
    use_pallas_smoother: bool = True
    mg_padded: bool | str = "q"
    # The route on the card, as on the TPU: False for the pre-process makes
    # the RHS in plain torch ops; False for the post-process (which only
    # dst_gemm and multigrid use) pastes the exact-size solve; dst_gemm with
    # the post-process but not the pre-process ends in postprocess_transposed.
    use_pallas_preprocess: bool = True
    use_pallas_postprocess: bool = True
    debug_dump: bool = False  # the CLI's per-stage dumps (the engine does not read it)
    debug_dir: str = "/tmp/scl_debug"
    donate_dst: bool = False  # run() updates a caller's device tensor in place
    bbox_bucket: int = 0  # round the ROI up to this multiple (0 = the exact bbox)
    bucket_exact: bool = False  # with bbox_bucket: solve the TIGHT system in the bucket
    # the TPU's persistent XLA cache: kept so configs carry across; unused here
    compilation_cache_dir: str | None = _DEFAULT_CACHE_DIR

    def solver_kwargs(self) -> dict:
        if self.solver == "jacobi":
            return {"tol": self.tol, "max_iters": self.max_iters,
                    "use_pallas": self.use_pallas_smoother}
        if self.solver == "multigrid":
            return {"tol": self.tol, "max_cycles": self.max_cycles,
                    "use_pallas": self.use_pallas_smoother,
                    "cycles": self.mg_cycles, "padded": self.mg_padded}
        if self.solver == "dst_gemm":
            return {"precision": self.precision, "folded": self.dst_folded}
        if self.solver == "auto":
            return {"precision": self.precision, "tol": self.tol,
                    "folded": self.dst_folded, "padded": self.mg_padded,
                    "cycles": self.mg_cycles}
        return {}


def config_from_jax(fields: dict) -> CloneConfig:
    """The port's CloneConfig from ``dataclasses.asdict()`` of a JAX one.

    Raises ValueError on a field the port does not know.
    """
    known = {f.name for f in dataclasses.fields(CloneConfig)}
    unknown = sorted(set(fields) - known)
    if unknown:
        raise ValueError(f"unknown CloneConfig fields: {unknown}")
    return CloneConfig(**fields)
