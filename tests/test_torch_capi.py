"""The port's C ABI (``seamlesscloneoptimization_tpu_torch/capi``) on the CPU.

``capi_host.build_library()`` / ``build_test_program()`` compile with the
host's g++ / cc against this interpreter's libpython, into the package's
``_build/`` under hashed names (a second build is a no-op). The C program
runs the clone through the library on ``{"platform": "cpu"}``, once on its
main thread and once from another pthread: both outputs bit-equal to the
port's engine on the CPU. Creation without a card, and with an unknown
config key, returns NULL with Python's message. ``capi_host.run`` itself on
read-only buffers writes only ``out``.
"""

import json
import os
import subprocess

import numpy as np
import pytest
import torch

from seamlesscloneoptimization_tpu_torch import capi_host
from seamlesscloneoptimization_tpu_torch.core.config import CloneConfig
from seamlesscloneoptimization_tpu_torch.core.engine import SeamlessClone

# Several pytest-xdist workers share the cores: one intra-op thread each.
torch.set_num_threads(1)

FACE_HW, BODY_HW, CENTER = (60, 80), (120, 160), (84, 58)


@pytest.fixture(scope="module")
def program():
    return capi_host.build_test_program()


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    """(directory of the raw files, face, body, mask)."""
    d = tmp_path_factory.mktemp("capi")
    rng = np.random.default_rng(21)
    face = rng.integers(0, 256, FACE_HW + (3,)).astype(np.uint8)
    body = rng.integers(0, 256, BODY_HW + (3,)).astype(np.uint8)
    yy, xx = np.mgrid[: FACE_HW[0], : FACE_HW[1]]
    mask = (((yy - 30) / 25.0) ** 2 + ((xx - 40) / 35.0) ** 2 <= 1).astype(np.uint8) * 255
    for name, a in (("face", face), ("body", body), ("mask", mask)):
        a.tofile(d / f"{name}.raw")
    return d, face, body, mask


def _run(program, images, device_id, config, mask=True):
    d = images[0]
    cmd = [str(program), str(d / "face.raw"), *map(str, FACE_HW), str(d / "body.raw"),
           *map(str, BODY_HW), str(d / "mask.raw") if mask else "-", *map(str, CENTER),
           str(device_id), config, str(d / "out1.raw"), str(d / "out2.raw")]
    env = dict(os.environ, SC_TPU_PYTHONPATH=capi_host.embedded_path())
    return subprocess.run(cmd, capture_output=True, text=True, env=env, timeout=240)


@pytest.mark.parametrize("mask", [True, False])
@pytest.mark.parametrize("config", [{}, {"flags": 2, "solver": "multigrid"}])
def test_program_runs_bit_equal_to_engine(program, images, config, mask):
    """Both runs (the second from another thread) equal SeamlessClone on
    the CPU with the same config; a NULL mask is the full mask."""
    r = _run(program, images, 0, json.dumps({"platform": "cpu", **config}), mask)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "run on another thread" in r.stdout and r.stdout.rstrip().endswith("C ABI runs done")
    d, face, body, m = images
    want = SeamlessClone(CloneConfig(**config), device="cpu").run(
        face, body, m if mask else None, CENTER).numpy()
    assert not np.array_equal(want, body)
    for out in ("out1.raw", "out2.raw"):
        assert np.array_equal(np.fromfile(d / out, np.uint8).reshape(want.shape), want), out


def test_create_without_card_names_cuda(program, images):
    r = _run(program, images, -1, "")
    assert r.returncode == 1
    assert "create_instance failed: CUDA is not available" in r.stderr


def test_unknown_config_key_gives_type_error_text(program, images):
    r = _run(program, images, 0, '{"platform": "cpu", "nope": 1}')
    assert r.returncode == 1
    assert "unexpected keyword argument 'nope'" in r.stderr


def test_builds_are_hashed_and_built_once(program):
    """The library and the program live in the package's _build/ under
    names carrying a hash; building again compiles nothing."""
    lib = capi_host.build_library()
    assert lib.parent == capi_host.BUILD_DIR and program.parent == capi_host.BUILD_DIR
    assert lib.name.startswith("libseamlessclone_tpu_torch-") and lib.suffix == ".so"
    assert len(program.name.split("-")[1]) == 16
    stamps = lib.stat().st_mtime_ns, program.stat().st_mtime_ns
    assert capi_host.build_test_program() == program and capi_host.build_library() == lib
    assert (lib.stat().st_mtime_ns, program.stat().st_mtime_ns) == stamps
    assert not list(capi_host.BUILD_DIR.glob("*.tmp*"))


def test_host_run_writes_only_out(images):
    """capi_host.run on read-only views of the inputs, as capi.cpp passes
    them: ``out`` holds the engine's image; the inputs are untouched."""
    _, face, body, mask = images
    eng = capi_host.create_instance(0, '{"platform": "cpu"}')
    assert eng.device.type == "cpu"
    frozen = [a.copy() for a in (face, body, mask)]
    out = bytearray(body.nbytes)
    views = [memoryview(a.tobytes()) for a in (face, body, mask)]
    assert capi_host.run(eng, views[0], *FACE_HW, views[1], *BODY_HW, views[2], *FACE_HW,
                         *CENTER, memoryview(out), 1) == 0
    want = SeamlessClone(CloneConfig(), device="cpu").run(face, body, mask, CENTER).numpy()
    assert np.array_equal(np.frombuffer(out, np.uint8).reshape(want.shape), want)
    assert all(np.array_equal(a, b) for a, b in zip((face, body, mask), frozen))
    assert capi_host.sync(eng) == 0 and capi_host.destroy(eng) == 0
    assert eng.device_memory_bytes() == 0


def test_host_rejects_unknown_platform():
    with pytest.raises(ValueError, match="unknown platform"):
        capi_host.create_instance(0, '{"platform": "tpu"}')
