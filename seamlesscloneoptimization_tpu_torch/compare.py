"""Golden-diff harness: the reference ``compare/vs.py`` as a module.

The port's own copy of the JAX package's ``compare.py``, with the same two
modes:

1. Image diff (vs.py:36-79): per-pixel absolute difference of two images,
   printing sum / differing-channel count / min / max / percent differing,
   and with ``--out-dir`` writing a diff YAML (int32) plus an amplified
   diff BMP.
2. Intermediate-tensor diff (vs.py:12-34, ``compareYaml``): per-channel
   comparison of dumped stage tensors (e.g. the Poisson RHS ``g{0,1,2}.yml``
   of ``--debug-dump`` vs OpenCV's instrumented ``mod_diff{0,1,2}.yml``;
   the reference reverses channel order between the two, g0 <-> mod_diff2).

Images are read as YAML (``.yml`` / ``.yaml``) or 24-bit BMP (``.bmp``),
through the port's ``native``; other formats (which the JAX package reads
with cv2) raise ValueError.

Usage:
    python -m seamlesscloneoptimization_tpu_torch.compare A.bmp B.bmp [--amplify 30]
    python -m seamlesscloneoptimization_tpu_torch.compare --yaml g0.yml mod_diff2.yml
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

from seamlesscloneoptimization_tpu_torch import native


def _load(path) -> np.ndarray:
    p = Path(path)
    if p.suffix in (".yml", ".yaml"):
        return native.read_yaml_mat(p)
    if p.suffix == ".bmp":
        return native.read_bmp(p)
    raise ValueError(f"{p}: reads .yml, .yaml and .bmp (24-bit) only, not {p.suffix!r}")


def diff_stats(a: np.ndarray, b: np.ndarray) -> dict:
    """The vs.py:52-69 statistics over an absolute difference."""
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch: {a.shape} vs {b.shape}")
    d = np.abs(a.astype(np.float64) - b.astype(np.float64))
    nz = d != 0
    return {
        "diff_sum": float(d.sum()),
        "diff_channels": int(nz.sum()),
        "diff_min": float(d[nz].min()) if nz.any() else 0.0,
        "diff_max": float(d.max()),
        "percent_diff": float(nz.mean() * 100.0),
    }


def compare_images(path_a, path_b, amplify: int = 30, out_dir: str | None = None) -> dict:
    a, b = _load(path_a), _load(path_b)
    stats = diff_stats(a, b)
    if out_dir:
        out = Path(out_dir)
        out.mkdir(parents=True, exist_ok=True)
        d = np.abs(a.astype(np.int32) - b.astype(np.int32))
        native.write_yaml_mat(out / "diff.yml", d, name="diff")
        native.write_bmp(out / "diff.bmp", np.clip(d * amplify, 0, 255).astype(np.uint8))
    return stats


def compare_yaml_stage(path_ours, path_golden) -> dict:
    """Stage-tensor comparison (float), the g-vs-mod_diff debugging method."""
    a, b = _load(path_ours).astype(np.float64), _load(path_golden).astype(np.float64)
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch: {a.shape} vs {b.shape}")
    d = np.abs(a - b)
    return {
        "abs_max": float(d.max()),
        "abs_mean": float(d.mean()),
        "rel_max": float((d / np.maximum(np.abs(b), 1e-12)).max()),
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="seamlessclone-tpu-torch-compare", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("a", help="our output (bmp/yml)")
    p.add_argument("b", help="golden (bmp/yml)")
    p.add_argument("--yaml", action="store_true", help="float stage-tensor mode")
    p.add_argument("--amplify", type=int, default=30)
    p.add_argument("--out-dir", default=None, help="write diff.yml + diff.bmp here")
    args = p.parse_args(argv)

    if args.yaml:
        stats = compare_yaml_stage(args.a, args.b)
    else:
        stats = compare_images(args.a, args.b, args.amplify, args.out_dir)
    for k, v in stats.items():
        print(f"{k}: {v}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
