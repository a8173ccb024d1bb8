"""Build and load the port's CUDA kernels (``csrc/*.cu``) on first use.

Each source compiles with nvcc, all of them at once in parallel, into its
own shared library with a plain C interface (a source may export more than
one kernel, ``SHARED_SOURCE``):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false \\
         -shared -Xcompiler -fPIC -Xptxas=-v -o _build/lib<name>_<hash>.so csrc/<name>.cu

and is loaded through ctypes (seconds, against minutes for a source that
includes PyTorch's headers). No ``--use_fast_math``: the divide and the
casts stay IEEE. ``-fmad=false``: no multiply is fused into an add, so each
float operation rounds once, as in the plain twin's separate torch ops, and
the kernels are bit-equal to their twins. The file
name carries a hash of the source, of every shared header (``csrc/*.cuh``)
and of the flags, so an edited source or header rebuilds; ptxas's register
and shared-memory report is kept beside each library as
``lib<name>_<hash>.log``. Nothing is built when a module is
imported: the first kernel launch (or ``build_all()``) builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float

# kernel name -> (C symbol, argtypes); every pointer and the stream is c_void_p
SIGNATURES = {
    "erode3": ("erode3_launch", (_P, _P, _I, _I, _P)),
    "preprocess_rhs_t": ("preprocess_rhs_t_launch",
                         (_P, _L, _L, _L, _P, _L, _L, _L, _P, _P,
                          _I, _I, _I, _I, _I, _I, _I, _P)),
    "transpose": ("transpose_launch", (_P, _P, _P, _P, _I, _I, _I, _P)),
    "clamp_cast_paste": ("clamp_cast_paste_launch",
                         (_P, _I, _I, _I, _P, _L, _L, _L, _I, _I, _I, _I, _P)),
    "fold_minor": ("fold_minor_launch", (_P, _P, _P, _I, _I, _I, _I, _I, _P)),
    "unfold_minor": ("unfold_minor_launch", (_P, _P, _P, _I, _I, _I, _I, _P)),
    "transpose_pair": ("transpose_pair_launch",
                       (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P)),
    "unfold_transpose": ("unfold_transpose_launch",
                         (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P)),
    "unfold_clamp_paste": ("unfold_clamp_paste_launch",
                           (_P, _P, _I, _I, _I, _P, _L, _L, _L, _I, _I, _I, _I, _P)),
    "preprocess_rhs_p": ("preprocess_rhs_p_launch",
                         (_P, _L, _L, _L, _P, _L, _L, _L, _P, _P,
                          _I, _I, _I, _I, _I, _I, _I, _P)),
    "mg_down": ("mg_down_launch", (_P,) * 4 + (_I,) * 8 + (_F,) * 6 + (_P,)),
    "mg_up": ("mg_up_launch", (_P,) * 4 + (_I,) * 8 + (_F,) * 6 + (_P,)),
    "mg_down_t": ("mg_down_t_launch", (_P,) * 4 + (_I,) * 9 + (_F,) * 8 + (_P,)),
    "mg_up_t": ("mg_up_t_launch", (_P,) * 4 + (_I,) * 9 + (_F,) * 8 + (_P,)),
    "mg_restrict_t": ("mg_restrict_t_launch", (_P, _P) + (_I,) * 6 + (_F, _F, _P)),
    "mg_prolong_t": ("mg_prolong_t_launch", (_P, _P) + (_I,) * 6 + (_F, _F, _P)),
    "preprocess_rhs_q": ("preprocess_rhs_q_launch",
                         (_P, _L, _L, _L, _P, _L, _L, _L, _P, _P,
                          _I, _I, _I, _I, _I, _I, _I, _P)),
    "mg_down_q": ("mg_down_q_launch", (_P,) * 6 + (_I,) * 7 + (_F,) * 4 + (_P,)),
    "mg_up_q": ("mg_up_q_launch", (_P,) * 6 + (_I,) * 6 + (_F,) * 2 + (_P,)),
    "mg_ud_q": ("mg_ud_q_launch", (_P,) * 7 + (_I,) * 8 + (_F,) * 6 + (_P,)),
    "mg_prolong_tq": ("mg_prolong_tq_launch", (_P,) * 3 + (_I,) * 6 + (_F, _F, _P)),
    "clamp_cast_paste_q": ("clamp_cast_paste_q_launch",
                           (_P, _I, _I, _I, _P, _L, _L, _L, _I, _I, _I, _I, _P)),
    "to_quarters": ("to_quarters_launch", (_P, _P, _I, _I, _I, _P)),
    "from_quarters": ("from_quarters_launch", (_P, _P, _I, _I, _I, _P)),
    "mg_restrict_tq": ("mg_restrict_tq_launch", (_P,) * 3 + (_I,) * 6 + (_F, _F, _P)),
    # also K.rb_sweeps's kernel (origin (0, 0), the whole array as the domain)
    "rb_sweeps_tile": ("rb_sweeps_tile_launch", (_P,) * 3 + (_I,) * 9 + (_P,)),
    # its window form: u and g read where they lie, with their own strides
    "rb_sweeps_tile_window": ("rb_sweeps_tile_window_launch",
                              (_P,) * 3 + (_I,) * 9 + (_L, _I, _L, _I, _P)),
    "postprocess_transposed": ("postprocess_transposed_launch",
                               (_P, _I, _I, _I, _P, _L, _L, _L, _I, _I, _P)),
    "prep_mask": ("prep_mask_launch", (_P, _P, _P, _I, _I, _P)),
}

# kernels exported by another kernel's source: name -> that source's name
SHARED_SOURCE = {"mg_down_t": "mg_down", "mg_up_t": "mg_up",
                 "rb_sweeps_tile_window": "rb_sweeps_tile"}

_lock = threading.Lock()
_functions: dict[str, ctypes._CFuncPtr] = {}
_libs: list[ctypes.CDLL] = []  # kept alive with the functions


def source_name(name: str) -> str:
    return SHARED_SOURCE.get(name, name)


def source_path(name: str) -> Path:
    return CSRC_DIR / f"{source_name(name)}.cu"


def _sources() -> list[str]:
    """The sources to build, one for each library."""
    return [n for n in SIGNATURES if n not in SHARED_SOURCE]


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([str(Path(home) / "bin" / "nvcc")] if home else []) + [
            shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and Path(cand).is_file():
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _target(name: str) -> Path:
    h = hashlib.sha256(source_path(name).read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):  # shared headers: an edit rebuilds
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{source_name(name)}_{h.hexdigest()[:16]}.so"


def build_all() -> float:
    """Compile every kernel whose library is missing, all nvcc processes at
    once; returns the seconds spent. Raises RuntimeError with nvcc's output
    if any compile fails."""
    t0 = time.perf_counter()
    todo = [(n, _target(n)) for n in _sources() if not _target(n).is_file()]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name, target in todo:
        tmp = target.with_name(f"{target.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(source_path(name))]
        procs.append((name, target, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, target, tmp, proc in procs:
        log, _ = proc.communicate()
        target.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, target)  # atomic: concurrent processes agree
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def ptxas_report() -> dict[str, str]:
    """ptxas's resource lines (registers, shared memory, spills) per source,
    from the last build's logs."""
    out = {}
    for name in _sources():
        log = _target(name).with_suffix(".log")
        if log.is_file():
            lines = [ln.strip() for ln in log.read_text().splitlines()
                     if "Used" in ln or "spill" in ln]
            out[name] = " | ".join(lines)
    return out


def kernel_function(name: str):
    """The ctypes function of kernel ``name``, building all kernels first if
    needed. Thread-safe."""
    fn = _functions.get(name)
    if fn is not None:
        return fn
    with _lock:
        if not _functions:
            build_all()
            libs = {n: ctypes.CDLL(str(_target(n))) for n in _sources()}
            _libs.extend(libs.values())
            for kname, (symbol, argtypes) in SIGNATURES.items():
                f = getattr(libs[source_name(kname)], symbol)
                f.argtypes = list(argtypes)
                f.restype = ctypes.c_int
                _functions[kname] = f
    return _functions[name]
