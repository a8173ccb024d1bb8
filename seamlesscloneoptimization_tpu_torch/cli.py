"""CLI mirroring the reference's ``seamlessClone_main``, over the port's engine.

The port's own copy of the JAX package's ``cli.py``. Reference argv
(seamlessClone-CUDA/seamlessClone_main.cu:74-80):

    ./seamlessClone_main src.yml dst.yml mask.yml centerX centerY gpu_id

Here:

    python -m seamlesscloneoptimization_tpu_torch.cli src.yml dst.yml mask.yml \\
        centerX centerY [device_id] [--device {cuda,cpu}] [--solver S] [--flags F] \\
        [--loops N] [--output-dir DIR] [--debug-dump] [--precision P] \\
        [--[no-]folded] [--[no-]pallas] [--tol T] [--mg-cycles N]

Inputs are OpenCV-FileStorage YAML matrices (the reference's fixture
format, ``native.read_yaml_mat``). ``device_id`` indexes the CUDA devices;
``--device cpu`` runs the plain PyTorch path on the CPU instead, and
without a card and without it the CLI raises. After one warm-up run it
times ``--loops`` single-shot runs (``SeamlessClone.timed_run``) and
writes the blended image as ``ucRGB_Output.bmp`` (the reference's artifact
name, seamlessClone_imp.cu:206-216) and ``result.yml`` into
``--output-dir``; ``--debug-dump`` also writes one clone's stages
(``SeamlessClone.dump_stages``: g{0,1,2}.yml, mask_eroded.yml, ...) into
``<output-dir>/debug``. It prints the reference's two lines
(imp.cu:343-346), then, with ``--solver auto``, the solver it resolved to.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="seamlessclone-tpu-torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("src_yml")
    p.add_argument("dst_yml")
    p.add_argument("mask_yml")
    p.add_argument("center_x", type=int)
    p.add_argument("center_y", type=int)
    p.add_argument("device_id", type=int, nargs="?", default=0,
                   help="index of the CUDA device (default 0)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda (default) runs the kernels on the card; cpu the plain "
                        "PyTorch path")
    p.add_argument("--solver", default="auto",
                   choices=["auto", "dst_gemm", "dst_fft", "jacobi", "multigrid"],
                   help="Poisson solver; auto (default) resolves per patch size: "
                        "dst_gemm up to the crossover, multigrid above it")
    p.add_argument("--flags", type=int, default=1,
                   help="1=NORMAL_CLONE 2=MIXED_CLONE 3=MONOCHROME_TRANSFER")
    p.add_argument("--loops", type=int, default=1,
                   help="timed loops after warm-up (ref LOOPS, imp.cu:290)")
    p.add_argument("--output-dir", default="./output")
    p.add_argument("--debug-dump", action="store_true",
                   help="also write one clone's stages into <output-dir>/debug (ref SCDEBUG)")
    p.add_argument("--precision", default=None, choices=["highest", "high"],
                   help="DST-GEMM passes (both FP32 on the card, TF32 off)")
    p.add_argument("--folded", dest="folded", default=None, action="store_true",
                   help="even/odd-folded DST GEMMs (default on)")
    p.add_argument("--no-folded", dest="folded", action="store_false")
    p.add_argument("--pallas", dest="pallas", default=None, action="store_true",
                   help="the pre/post-process and smoother kernels (default on; the "
                        "JAX package's name for them)")
    p.add_argument("--no-pallas", dest="pallas", action="store_false")
    p.add_argument("--tol", type=float, default=None,
                   help="iterative-solver relative residual tolerance")
    p.add_argument("--mg-cycles", type=int, default=None,
                   help="fixed-work multigrid: exactly N V-cycles, no checks")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import torch

    from seamlesscloneoptimization_tpu_torch import native, resolve_device
    from seamlesscloneoptimization_tpu_torch.core.config import CloneConfig
    from seamlesscloneoptimization_tpu_torch.core.engine import SeamlessClone

    resolve_device(args.device)  # raises for cuda without a card
    count = torch.cuda.device_count() if args.device == "cuda" else 1
    if not 0 <= args.device_id < count:
        print(f"device {args.device_id} not available (have {count})", file=sys.stderr)
        return 2
    device = torch.device(args.device, args.device_id)
    print(f"using device {device} ({count} visible)")

    src = native.read_yaml_mat(args.src_yml)
    dst = native.read_yaml_mat(args.dst_yml)
    mask = native.read_yaml_mat(args.mask_yml)
    print(f"src {src.shape} dst {dst.shape} mask {mask.shape}")

    outdir = Path(args.output_dir)
    overrides = {}
    if args.precision is not None:
        overrides["precision"] = args.precision
    if args.folded is not None:
        overrides["dst_folded"] = args.folded
    if args.pallas is not None:
        overrides.update(use_pallas_preprocess=args.pallas,
                         use_pallas_postprocess=args.pallas,
                         use_pallas_smoother=args.pallas)
    if args.tol is not None:
        overrides["tol"] = args.tol
    if args.mg_cycles is not None:
        overrides["mg_cycles"] = args.mg_cycles
    eng = SeamlessClone(
        CloneConfig(solver=args.solver, flags=args.flags, debug_dump=args.debug_dump,
                    debug_dir=str(outdir / "debug"), **overrides),
        device=device,
    )
    center = (args.center_x, args.center_y)
    out, ms = eng.timed_run(src, dst, mask, center, loops=args.loops, warmup=1)
    memory = eng.device_memory_bytes()

    outdir.mkdir(parents=True, exist_ok=True)
    out_np = out.cpu().numpy()
    native.write_bmp(outdir / "ucRGB_Output.bmp", out_np)
    native.write_yaml_mat(outdir / "result.yml", out_np, name="result")
    if args.debug_dump:
        eng.dump_stages(src, dst, mask, center)

    # The reference printout format (seamlessClone_imp.cu:343-346) first.
    _, _, bw, bh = eng.metrics.get("bbox", (0, 0, 0, 0))
    print(f"Compute stage performance time= {ms:.3f} msec, patch size={bw}x{bh}")
    print(f"total device memory used: {memory} bytes")
    if args.solver == "auto":
        print(f"solver: auto -> {eng.metrics.get('solver_resolved')}")
    print(f"wrote {outdir / 'ucRGB_Output.bmp'} and {outdir / 'result.yml'}"
          + (f"; stages in {eng.config.debug_dir}" if args.debug_dump else ""))
    return 0


if __name__ == "__main__":
    sys.exit(main())
