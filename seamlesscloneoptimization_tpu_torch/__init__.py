"""PyTorch/CUDA port of the seamless-clone (Poisson image editing) engine.

A second package beside the JAX one (``seamlesscloneoptimization_tpu``,
which stays the reference): the same public surface, with every TPU Pallas
kernel on the ported path replaced by a kernel written by hand in CUDA C++
for Hopper (``csrc/``, built with nvcc on first use, bound through ctypes).

The port imports torch and numpy only. Its entry points run on ``cuda``
unless the caller passes ``device="cpu"``, which runs the plain PyTorch
twins of the kernels; without a card and without ``device="cpu"`` they
raise rather than quietly fall back.

What runs (ROADMAP slices 1 to 7 and 8a), through ``SeamlessClone.run`` /
``timed_serve`` and ``seamless_clone``, in the NORMAL, MIXED and
MONOCHROME modes:

- ``CloneConfig()`` for patches up to the ``auto`` crossover: the DST-GEMM
  serve path. With the default ``dst_folded=True`` it runs the folded pair
  chain where both interior sides exceed 128 px, folds the one side that
  does otherwise, and runs the unfolded chain on small patches or with
  ``dst_folded=False``.
- ``CloneConfig()`` above the crossover, and ``CloneConfig(solver=
  "multigrid")`` at any size: the multigrid with its finest level in
  quarter planes (``mg_padded="q"``, the default) and transpose-fused
  coarse levels, in tolerance mode at any ``tol`` (a coarse one runs the
  check-first loop) or fixed-cycle mode; ``mg_padded="t"`` runs the
  transpose-fused V-cycle on every level, ``mg_padded=False`` the element
  V-cycle, its levels of at least 2^18 points fused (``mg_down`` /
  ``mg_up`` on exact-size levels). Small interiors run the plain element
  path. ``mg_padded=True`` runs the dense rounded V-cycle (``vcycle_p``,
  ``mg_down`` / ``mg_up`` on ``mg_geometry``'s slabs).
  ``solvers.multigrid.solve_multigrid`` also takes a dense RHS, returns
  dense results and ``return_info``, starts warm from ``u0`` or from the
  full-multigrid cascade (``fmg_start``), and runs ``pcg``.
- ``CloneConfig(precision=...)``: every DST-GEMM mode of the JAX package,
  the bf16 ones as cuBLAS bf16 GEMMs with an FP32 output.
- ``CloneConfig(solver="jacobi")``: red-black Gauss-Seidel
  (``solve_redblack``), its bursts of sweeps the ``rb_sweeps`` kernel;
  ``CloneConfig(solver="dst_fft")``: the exact solve through ``torch.fft``.
- ``use_pallas_preprocess`` / ``use_pallas_postprocess`` select the same
  routes as in the JAX package; ``CloneConfig(use_pallas_preprocess=False)``
  ends the DST-GEMM solve in the ``postprocess_transposed`` kernel.
- ``parallel``: a ``TileMesh`` of devices (``make_tile_mesh``; one card
  may appear several times), ``TiledSeamlessClone`` and
  ``seamless_clone_tiled`` with the Poisson solve decomposed over it
  (``solve_poisson_dd``: per-tile sweeps through the ``rb_sweeps_tile``
  kernel, a replicated coarse solve), ``solve_redblack_tiled`` and
  ``local_edit_tiled``.
- The batch (``seamless_clone_batch``, ``seamless_clone_batch_fused``:
  each group of jobs one batched DST-GEMM solve, or with
  ``bucket="pad_exact"`` each job's tight system in a shared bucket) and
  the edits (``color_change``, ``illumination_change``,
  ``texture_flattening``, with a Canny of the port's own).
- The user surface over the engine: ``cli`` (the reference's argv,
  ``python -m seamlesscloneoptimization_tpu_torch.cli``, the scripts
  ``seamlessclone-tpu-torch``), ``compare`` (the golden-diff harness,
  ``seamlessclone-tpu-torch-compare``), ``native`` (YAML / BMP IO and
  ``prep_mask``) and the C ABI (``capi/``: the JAX ABI's five ``sc_tpu_``
  entry points, embedding CPython over ``capi_host``; built by
  ``capi_host.build_library()`` on first call, never at import).
"""

from __future__ import annotations

import torch

NORMAL_CLONE = 1
MIXED_CLONE = 2
MONOCHROME_TRANSFER = 3

__version__ = "0.1.0"

__all__ = [
    "NORMAL_CLONE",
    "MIXED_CLONE",
    "MONOCHROME_TRANSFER",
    "CloneConfig",
    "SeamlessClone",
    "seamless_clone",
    "seamless_clone_batch",
    "seamless_clone_batch_fused",
    "color_change",
    "illumination_change",
    "texture_flattening",
    "solve_dst_fft",
    "solve_redblack",
    "resolve_device",
    "TiledSeamlessClone",
    "seamless_clone_tiled",
    "make_tile_mesh",
    "local_edit_tiled",
]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` by default.

    Raises RuntimeError when CUDA is asked for (explicitly or by default)
    and is not available — the port never silently runs on the CPU; pass
    ``device="cpu"`` for the plain PyTorch versions.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def __getattr__(name):
    # lazy: the engine modules import this one for resolve_device
    if name == "CloneConfig":
        from seamlesscloneoptimization_tpu_torch.core.config import CloneConfig

        return CloneConfig
    if name == "SeamlessClone":
        from seamlesscloneoptimization_tpu_torch.core.engine import SeamlessClone

        return SeamlessClone
    if name in ("seamless_clone", "seamless_clone_batch", "seamless_clone_batch_fused",
                "color_change", "illumination_change", "texture_flattening"):
        from seamlesscloneoptimization_tpu_torch import api

        return getattr(api, name)
    if name in ("solve_redblack", "solve_dst_fft"):
        from seamlesscloneoptimization_tpu_torch import solvers

        return getattr(solvers, name)
    if name in ("TiledSeamlessClone", "seamless_clone_tiled", "make_tile_mesh",
                "local_edit_tiled"):
        from seamlesscloneoptimization_tpu_torch import parallel

        return getattr(parallel, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
