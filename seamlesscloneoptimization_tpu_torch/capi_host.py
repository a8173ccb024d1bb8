"""Host side of the C ABI (``capi/``, libseamlessclone_tpu_torch).

The port's own copy of the JAX package's ``capi_host.py``: ``capi/capi.cpp``
embeds CPython and calls the functions here with memoryviews over the
caller's buffers (the counterpart of the reference's extern-C surface,
seamlessClone-CUDA/seamlessclone_cuda.h:6-62). This module wraps the
buffers as numpy arrays without a copy and runs the engine; the engine's
upload is the one copy of the inputs, and the result goes from the device
straight into the caller's ``out`` buffer before ``run`` returns (that copy
waits for the device, as the reference's D2H in seamlessCloneGPU does).

``build_library()`` and ``build_test_program()`` compile the C side with
the host's C / C++ compiler against this interpreter's libpython, into the
package's ``_build/`` under a name that carries a hash of the sources and
the flags. Nothing is built when this module is imported.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import sysconfig
import warnings
from pathlib import Path

import numpy as np
import torch

CAPI_DIR = Path(__file__).resolve().parent / "capi"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
HEADER = CAPI_DIR / "seamlessclone_tpu_torch.h"


def create_instance(device_id: int, config_json: str):
    """An engine: ``device_id`` indexes the CUDA devices, -1 = the default
    one. ``config_json``: a JSON object of CloneConfig fields, e.g.
    ``'{"solver": "dst_gemm", "flags": 1}'``, and optionally
    ``"platform": "cpu"`` (the plain PyTorch path on the CPU; ``device_id``
    is then not read) or ``"cuda"``. Without a card, a CUDA device raises."""
    from seamlesscloneoptimization_tpu_torch import resolve_device
    from seamlesscloneoptimization_tpu_torch.core.config import CloneConfig
    from seamlesscloneoptimization_tpu_torch.core.engine import SeamlessClone

    cfg = json.loads(config_json) if config_json else {}
    platform = cfg.pop("platform", "cuda")
    if platform == "cpu":
        device = resolve_device("cpu")
    elif platform == "cuda":
        device = resolve_device("cuda")  # raises without a card
        if device_id >= 0:
            if device_id >= torch.cuda.device_count():
                raise ValueError(f"device {device_id} not available "
                                 f"(have {torch.cuda.device_count()})")
            device = torch.device("cuda", device_id)
    else:
        raise ValueError(f"unknown platform {platform!r}: 'cuda' or 'cpu'")
    return SeamlessClone(CloneConfig(**cfg), device=device)


def run(engine, face_mv, fh, fw, body_mv, bh, bw, mask_mv, mh, mw, cx, cy, out_mv, sync):
    """One clone: face (the source patch) into body (the destination) at
    (cx, cy). Buffers are interleaved BGR uint8, the mask single-channel (or
    None: full); ``out_mv`` holds bh * bw * 3 bytes and receives the blended
    destination."""
    face = np.frombuffer(face_mv, np.uint8).reshape(fh, fw, 3)
    body = np.frombuffer(body_mv, np.uint8).reshape(bh, bw, 3)
    mask = np.frombuffer(mask_mv, np.uint8).reshape(mh, mw) if mask_mv is not None else None
    with warnings.catch_warnings():
        # the caller's read-only buffers: the engine copies them, never writes
        warnings.filterwarnings("ignore", "The given NumPy array is not writable")
        result = engine.run(face, body, mask, (cx, cy))
    torch.from_numpy(np.frombuffer(out_mv, np.uint8).reshape(bh, bw, 3)).copy_(result)
    if sync:
        engine.sync()
    return 0


def sync(engine):
    engine.sync()
    return 0


def destroy(engine):
    engine.destroy()
    return 0


def _embed_flags() -> list[str]:
    """Compile and link flags that embed this interpreter (what
    ``python3-config --embed`` gives, from this interpreter's sysconfig),
    with an rpath to its libpython."""
    libdir = sysconfig.get_config_var("LIBDIR")
    libs = " ".join(sysconfig.get_config_var(k) or "" for k in ("LIBS", "SYSLIBS")).split()
    return [f"-I{sysconfig.get_paths()['include']}", f"-L{libdir}",
            f"-lpython{sysconfig.get_config_var('LDVERSION')}", *libs, f"-Wl,-rpath,{libdir}"]


def _build(kind: str, compiler: str, source: Path, flags: list[str], inputs: list[Path],
           suffix: str = "") -> Path:
    """``compiler`` on ``source`` into ``_build/<kind>-<hash><suffix>``
    unless that file exists; the hash covers ``inputs`` and the command.
    Written under a temporary name and moved into place (concurrent builds
    agree)."""
    h = hashlib.sha256(" ".join([compiler, *flags]).encode())
    for p in inputs:
        h.update(p.read_bytes())
    target = BUILD_DIR / f"{kind}-{h.hexdigest()[:16]}{suffix}"
    if target.is_file():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp{suffix}")
    r = subprocess.run([compiler, str(source), "-o", str(tmp), *flags],
                       capture_output=True, text=True)
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{compiler} failed on {source.name} (exit {r.returncode}):\n"
                           f"{r.stdout}{r.stderr}")
    os.replace(tmp, target)
    return target


def build_library() -> Path:
    """Build libseamlessclone_tpu_torch (``capi/capi.cpp``, embedding this
    interpreter) if needed; returns its path."""
    flags = ["-O2", "-fPIC", "-shared", "-std=c++17", "-Wall", f"-I{CAPI_DIR}",
             *_embed_flags()]
    return _build("libseamlessclone_tpu_torch", os.environ.get("CXX", "g++"),
                  CAPI_DIR / "capi.cpp", flags, [CAPI_DIR / "capi.cpp", HEADER], ".so")


def build_test_program() -> Path:
    """Build ``capi/test_capi.c`` linked to the library (building it too if
    needed); returns the program's path."""
    lib = build_library()
    flags = ["-O2", "-Wall", f"-I{CAPI_DIR}", str(lib), "-lpthread"]
    return _build("test_capi", os.environ.get("CC", "cc"), CAPI_DIR / "test_capi.c", flags,
                  [CAPI_DIR / "test_capi.c", HEADER, lib])


def embedded_path(root: Path | str | None = None) -> str:
    """A ``SC_TPU_PYTHONPATH`` for a program that embeds this interpreter:
    ``root`` (default: the directory holding this package) and this
    interpreter's ``sys.path``."""
    root = Path(root) if root else Path(__file__).resolve().parent.parent
    return os.pathsep.join([str(root), *(p for p in sys.path if p)])
