"""The port's pipeline, engine and API against the JAX package on the CPU.

The JAX side runs its full-Pallas serve path with every Pallas kernel in
interpret mode (the mocks of tests/test_pallas_kernels.py), with the same
``dst_folded`` as the port. The engine and serve comparisons use a patch
whose interior exceeds 128 px on both sides, so ``dst_folded=True`` runs
the folded pair chain on both sides. The GEMM chains may sum in different
orders, so the u8 results may differ by 1 where the truncation flips:
diff_max <= 1. The images are numpy-seeded or the in-repo docs/assets
pair, so no external fixture is needed.
"""

import ast
import contextlib
import dataclasses
import importlib
import inspect
import re
from pathlib import Path
from unittest import mock

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seamlesscloneoptimization_tpu.core.config import CloneConfig as JConfig
from seamlesscloneoptimization_tpu.core.engine import SeamlessClone as JEngine
from seamlesscloneoptimization_tpu.models import pipeline as JP
from seamlesscloneoptimization_tpu.ops import pallas_kernels as PK
from seamlesscloneoptimization_tpu.solvers import solve_dst_gemm as j_solve_dst_gemm
from seamlesscloneoptimization_tpu_torch import resolve_device
from seamlesscloneoptimization_tpu_torch.api import seamless_clone
from seamlesscloneoptimization_tpu_torch.core import engine as TE
from seamlesscloneoptimization_tpu_torch.core.config import CloneConfig, config_from_jax
from seamlesscloneoptimization_tpu_torch.core.engine import SeamlessClone, prepare_inputs
from seamlesscloneoptimization_tpu_torch.models import pipeline as TP
from seamlesscloneoptimization_tpu_torch.solvers import solve_dst_gemm

# Several pytest-xdist workers share the cores: one intra-op thread each keeps
# torch's OpenMP pools from oversubscribing them (it cut this suite's CPU time
# about 3.5x). Results do not depend on it.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
ASSETS = REPO / "docs" / "assets"
CENTER = (80, 60)


@contextlib.contextmanager
def jax_full_pallas():
    """Every Pallas kernel of the JAX serve chain in interpret mode, and the
    pipeline's backend gate open (as tests/test_pallas_kernels.py does)."""

    def force_interp(orig):
        return lambda *a, **k: orig(*a, **{**k, "interpret": True})

    with contextlib.ExitStack() as es:
        for name in ("preprocess_rhs_transposed_pallas", "erode3_pallas",
                     "transpose_pallas", "clamp_cast_pallas",
                     "clamp_cast_guarded_pallas", "paste_interior_pallas",
                     "fold_minor_pallas", "unfold_minor_pallas",
                     "transpose_pair_pallas", "unfold_transpose_pallas",
                     "unfold_clamp_guarded_pallas"):
            es.enter_context(mock.patch.object(PK, name, force_interp(getattr(PK, name))))
        es.enter_context(mock.patch.object(JP, "_pallas_backend_available", lambda: True))
        yield


def _images(seed=0, src_hw=(60, 90), dst_hw=(120, 160)):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, 256, src_hw + (3,)).astype(np.uint8)
    dst = rng.integers(0, 256, dst_hw + (3,)).astype(np.uint8)
    h, w = src_hw
    yy, xx = np.mgrid[:h, :w]
    mask = (((yy - h // 2) ** 2 + (xx - w // 2) ** 2 < (h // 3) ** 2)
            | ((yy > h // 5) & (yy < h // 2) & (xx > 4) & (xx < w - 6)))
    return src, dst, mask.astype(np.uint8) * 255


def _diff_max(a, b):
    return int(np.abs(np.asarray(a).astype(np.int16) - np.asarray(b)).max())


def _interior(shape, prep):
    _, _, (left, top), (bh, bw) = prep
    inside = np.zeros(shape[:2], bool)
    inside[top + 1 : top + bh - 1, left + 1 : left + bw - 1] = True
    return inside


MODES = [(1, "opencv"), (2, "opencv"), (2, "norm"), (3, "opencv")]
# a patch whose mask bbox is 139 x 169: interior 137 x 167, both sides fold
BIG_SRC, BIG_DST, BIG_CENTER = (210, 180), (260, 240), (120, 130)


@pytest.mark.parametrize("folded", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_engine_run_matches_jax_full_pallas(mode, folded):
    flags, rule = mode
    src, dst, mask = _images(flags, src_hw=BIG_SRC, dst_hw=BIG_DST)
    prep = prepare_inputs(mask, src.shape, dst.shape, BIG_CENTER)
    assert min(prep[3]) - 2 > 128
    with jax_full_pallas():
        want = np.asarray(JEngine(JConfig(dst_folded=folded, mixed_rule=rule)).run(
            src, dst, mask, BIG_CENTER, flags))
    eng = SeamlessClone(CloneConfig(dst_folded=folded, mixed_rule=rule), device="cpu")
    got = eng.run(src, dst, mask, BIG_CENTER, flags).numpy()
    assert got.shape == dst.shape and got.dtype == np.uint8
    assert _diff_max(got, want) <= 1
    inside = _interior(dst.shape, prep)
    assert np.array_equal(got[~inside], dst[~inside])
    assert not np.array_equal(got[inside], dst[inside])
    assert eng.metrics["solver_resolved"] == "dst_gemm"


@pytest.mark.parametrize("folded", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_planar_serve_step_matches_jax(mode, folded):
    """One chained serve frame (planar destination, in-place paste) of the
    port against one JAX serve-program step with the guarded Pallas paste
    (with ``folded``, the fused unfold + guarded clamp)."""
    flags, rule = mode
    src, dst, mask = _images(10 + flags, src_hw=BIG_SRC, dst_hw=BIG_DST)
    m, xy, lt, hw = prepare_inputs(mask, src.shape, dst.shape, BIG_CENTER)
    assert min(hw) - 2 > 128
    dst_p = np.ascontiguousarray(dst.transpose(2, 0, 1))
    kw = {"precision": "high", "folded": folded}
    with jax_full_pallas():
        want = np.asarray(JP.clone_pipeline(
            jnp.asarray(src), jnp.asarray(dst_p), jnp.asarray(m), jnp.asarray(xy, jnp.int32),
            jnp.asarray(lt, jnp.int32), bbox_hw=hw, flags=flags, solver=j_solve_dst_gemm,
            solver_kwargs=kw, use_pallas_pre=True, use_pallas_post=True, planar_dst=True,
            solver_name="dst_gemm", mixed_rule=rule))
    buf = torch.from_numpy(dst_p.copy())
    out = TP.clone_pipeline(torch.from_numpy(src), buf, torch.from_numpy(m), xy, lt,
                            bbox_hw=hw, flags=flags, solver_kwargs=kw, planar_dst=True,
                            mixed_rule=rule)
    assert out is buf
    assert _diff_max(out.numpy(), want) <= 1
    inside = _interior(dst.shape, (m, xy, lt, hw))
    assert np.array_equal(out.numpy()[:, ~inside], dst_p[:, ~inside])


def test_clone_roi_pair_chain_matches_jax_full_pallas():
    """clone_roi's standalone contract on the pair chain (140 x 170 ROI):
    the fused unfold_clamp_paste into a copy of the ROI, border ring = dest;
    JAX ends in unfold_minor + clamp_cast there."""
    rng = np.random.default_rng(8)
    dest = rng.integers(0, 256, (3, 140, 170)).astype(np.uint8)
    src = rng.integers(0, 256, (3, 140, 170)).astype(np.uint8)
    mask = np.zeros((140, 170), np.uint8)
    mask[5:133, 7:160] = 255
    patch = np.where(mask[None] != 0, src, 0).astype(np.uint8)
    kw = {"precision": "high", "folded": True}
    with jax_full_pallas():
        want = np.asarray(JP.clone_roi(jnp.asarray(dest), jnp.asarray(patch),
                                       jnp.asarray(mask), 1, j_solve_dst_gemm,
                                       solver_kwargs=kw, use_pallas_pre=True,
                                       use_pallas_post=True))
    got = TP.clone_roi(torch.from_numpy(dest), torch.from_numpy(patch),
                       torch.from_numpy(mask), 1, solver_kwargs=kw).numpy()
    assert _diff_max(got, want) <= 1
    ring = np.ones((140, 170), bool)
    ring[1:-1, 1:-1] = False
    assert np.array_equal(got[:, ring], dest[:, ring])
    # the plain branch (solve_dst_gemm folded) agrees
    tb, _ = TP.clone_roi(torch.from_numpy(dest), torch.from_numpy(patch),
                         torch.from_numpy(mask), 1, solve_dst_gemm, solver_kwargs=kw,
                         return_stages=True)
    assert _diff_max(got, tb.numpy()) <= 1


def test_clone_roi_kernel_branch_matches_jax_full_pallas():
    """clone_roi's standalone contract: the whole ROI, border ring = dest."""
    rng = np.random.default_rng(3)
    dest = rng.integers(0, 256, (3, 48, 70)).astype(np.uint8)
    src = rng.integers(0, 256, (3, 48, 70)).astype(np.uint8)
    mask = np.zeros((48, 70), np.uint8)
    mask[4:44, 6:66] = 255
    patch = np.where(mask[None] != 0, src, 0).astype(np.uint8)
    with jax_full_pallas():
        want = np.asarray(JP.clone_roi(jnp.asarray(dest), jnp.asarray(patch),
                                       jnp.asarray(mask), 1, j_solve_dst_gemm,
                                       use_pallas_pre=True, use_pallas_post=True))
    got = TP.clone_roi(torch.from_numpy(dest), torch.from_numpy(patch),
                       torch.from_numpy(mask), 1).numpy()
    assert _diff_max(got, want) <= 1
    ring = np.ones((48, 70), bool)
    ring[1:-1, 1:-1] = False
    assert np.array_equal(got[:, ring], dest[:, ring])


def test_clone_roi_plain_branch_stages_match_jax():
    rng = np.random.default_rng(4)
    dest = rng.integers(0, 256, (3, 40, 57)).astype(np.uint8)
    patch = rng.integers(0, 256, (3, 40, 57)).astype(np.uint8)
    mask = np.full((40, 57), 255, np.uint8)
    jb, js = JP.clone_roi(jnp.asarray(dest), jnp.asarray(patch), jnp.asarray(mask), 2,
                          j_solve_dst_gemm, return_stages=True)
    tb, ts = TP.clone_roi(torch.from_numpy(dest), torch.from_numpy(patch),
                          torch.from_numpy(mask), 2, solve_dst_gemm, return_stages=True)
    for k in ("mask_eroded", "gx", "gy", "rhs"):
        assert np.array_equal(np.asarray(js[k]), ts[k].numpy()), k
    u = np.asarray(js["u"])
    assert np.abs(ts["u"].numpy() - u).max() / np.abs(u).max() < 1e-5
    assert _diff_max(tb.numpy(), jb) <= 1
    # the plain branch and the kernel branch agree
    tk = TP.clone_roi(torch.from_numpy(dest), torch.from_numpy(patch),
                      torch.from_numpy(mask), 2)
    assert _diff_max(tk.numpy(), tb.numpy()) <= 1


def test_timed_serve_chains_frames_in_place():
    src, dst, mask = _images(5)
    eng = SeamlessClone(CloneConfig(), device="cpu")
    out, ms = eng.timed_serve(src, dst, mask, CENTER, loops=2)
    assert ms > 0 and eng.metrics["compute_ms"] == ms
    assert eng.metrics["device_memory_bytes"] > 0
    # the same three frames (warm-up + 2) chained by hand
    m, xy, lt, hw = prepare_inputs(mask, src.shape, dst.shape, CENTER)
    buf = torch.from_numpy(np.ascontiguousarray(dst.transpose(2, 0, 1)))
    for _ in range(3):
        TP.clone_pipeline(torch.from_numpy(src), buf, torch.from_numpy(m), xy, lt,
                          bbox_hw=hw, flags=1, solver_kwargs={"precision": "high"},
                          planar_dst=True)
    assert np.array_equal(out.numpy(), buf.permute(1, 2, 0).numpy())


def test_timed_run_reuploads_and_matches_run():
    src, dst, mask = _images(7)
    eng = SeamlessClone(CloneConfig(), device="cpu")
    out, ms = eng.timed_run(src, dst, mask, CENTER, loops=2)
    assert ms > 0 and eng.metrics["compute_ms"] == ms
    _, (x0, y0), _, (bh, bw) = prepare_inputs(mask, src.shape, dst.shape, CENTER)
    assert eng.metrics["bbox"] == (x0, y0, bw, bh)
    # every loop starts from the caller's dst again: equal to one run
    assert np.array_equal(out.numpy(), eng.run(src, dst, mask, CENTER).numpy())
    assert not np.array_equal(out.numpy(), dst)


def _assets():
    src = cv2.imread(str(ASSETS / "input_src.jpg"))
    dst = cv2.imread(str(ASSETS / "input_dst.jpg"))
    assert src is not None and dst is not None
    full = np.full(src.shape[:2], 255, np.uint8)
    irregular = np.zeros(src.shape[:2], np.uint8)
    cv2.circle(irregular, (150, 97), 80, 255, -1)
    cv2.rectangle(irregular, (40, 30), (260, 120), 255, -1)
    return src, dst, {"full": full, "irregular": irregular}


@pytest.mark.parametrize("mask_name", ["full", "irregular"])
@pytest.mark.parametrize("flags", [1, 2, 3])
def test_seamless_clone_vs_cv2_no_worse_than_jax(mask_name, flags):
    src, dst, masks = _assets()
    mask = masks[mask_name]
    golden = cv2.seamlessClone(src, dst, mask.copy(), (400, 200), flags)
    jax_out = np.asarray(JEngine(JConfig()).run(src, dst, mask, (400, 200), flags))
    port = seamless_clone(src, dst, mask, (400, 200), flags, device="cpu")
    assert port.shape == dst.shape and port.dtype == np.uint8
    assert _diff_max(port, golden) <= max(_diff_max(jax_out, golden), 1)


def test_config_from_jax_round_trips():
    for jcfg in (JConfig(), JConfig(solver="dst_gemm", flags=2, mixed_rule="norm",
                                    precision="highest", dst_folded=False, donate_dst=True,
                                    compilation_cache_dir=None)):
        fields = dataclasses.asdict(jcfg)
        cfg = config_from_jax(fields)
        assert isinstance(cfg, CloneConfig)
        assert dataclasses.asdict(cfg) == fields
    with pytest.raises(ValueError, match="unknown CloneConfig fields"):
        config_from_jax({**dataclasses.asdict(JConfig()), "mesh_shape": (2, 2)})


class TestValidation:
    """The JAX engine's input errors (tests/test_jax_pipeline.py TestValidation)."""

    def test_wrong_channel_count_raises(self):
        src, dst, _ = _images()
        with pytest.raises(ValueError, match="must be"):
            SeamlessClone(device="cpu").run(src[..., 0], dst, None, CENTER)

    def test_wrong_dtype_raises(self):
        src, dst, _ = _images()
        with pytest.raises(TypeError, match="uint8"):
            SeamlessClone(device="cpu").run(src.astype(np.float32), dst, None, CENTER)

    def test_dst_smaller_than_src_raises(self):
        src, dst, _ = _images()
        with pytest.raises(ValueError, match="smaller"):
            SeamlessClone(device="cpu").run(dst, src, None, (40, 30))

    def test_wide_src_into_tall_dst_allowed(self):
        rng = np.random.default_rng(0)
        src = rng.integers(0, 256, (40, 200, 3)).astype(np.uint8)
        dst = rng.integers(0, 256, (400, 100, 3)).astype(np.uint8)
        mask = np.zeros(src.shape[:2], np.uint8)
        mask[10:30, 80:120] = 255
        out = SeamlessClone(device="cpu").run(src, dst, mask, (50, 200)).numpy()
        assert out.shape == dst.shape
        assert not np.array_equal(out, dst)

    def test_mask_shape_mismatch_raises(self):
        src, dst, _ = _images()
        with pytest.raises(ValueError, match="mask shape"):
            SeamlessClone(device="cpu").run(src, dst, np.full((10, 10), 255, np.uint8), CENTER)

    def test_out_of_bounds_roi_raises(self):
        src, dst, mask = _images()
        with pytest.raises(ValueError, match="outside destination"):
            SeamlessClone(device="cpu").run(src, dst, mask, (5, 5))

    def test_mask_without_interior_returns_dst(self):
        """A 2-row bbox has no interior pixel (the JAX engine raises an
        IndexError there, cv2 an assertion): the port returns dst."""
        src, dst, _ = _images()
        mask = np.zeros(src.shape[:2], np.uint8)
        mask[10:12, 20:40] = 255
        out = SeamlessClone(device="cpu").run(src, dst, mask, CENTER)
        assert np.array_equal(out.numpy(), dst)

    def test_empty_mask_returns_dst(self):
        src, dst, _ = _images()
        out = SeamlessClone(device="cpu").run(src, dst, np.zeros(src.shape[:2], np.uint8),
                                              CENTER)
        assert np.array_equal(out.numpy(), dst)


def test_run_leaves_callers_tensor_unless_donated():
    src, dst, mask = _images(6)
    dst_t = torch.from_numpy(dst.copy())
    out = SeamlessClone(device="cpu").run(src, dst_t, mask, CENTER)
    assert np.array_equal(dst_t.numpy(), dst) and not np.array_equal(out.numpy(), dst)
    donated = SeamlessClone(CloneConfig(donate_dst=True), device="cpu").run(
        src, dst_t, mask, CENTER)
    assert donated is dst_t and np.array_equal(dst_t.numpy(), out.numpy())


def test_no_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SeamlessClone()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    src, dst, mask = _images()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        seamless_clone(src, dst, mask, CENTER)
    assert resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("cfg, match", [
    (CloneConfig(solver="multigrid", mg_padded=True), None),  # the dense modes (4b)
    (CloneConfig(precision="2x_img"), None),  # a DST-GEMM precision mode (4c)
    (CloneConfig(precision="fwd2x"), None),  # a DST-GEMM precision mode
    (CloneConfig(bbox_bucket=64), None),  # the grown bucket (slice 5)
    (CloneConfig(debug_dump=True), None),  # read by the CLI only (slice 5)
])
def test_unported_configs_raise(cfg, match):
    """What a later slice brings raises, naming its ROADMAP slice; slices
    4b, 4c and 5 run (each against the JAX engine in
    tests/test_torch_dense_modes.py, tests/test_torch_precision_modes.py and
    tests/test_torch_bucket.py), writing only the (bucketed) ROI interior."""
    if match is not None:
        with pytest.raises(NotImplementedError, match=match):
            SeamlessClone(cfg, device="cpu")
        return
    src, dst, mask = _images()
    prep = prepare_inputs(mask, src.shape, dst.shape, CENTER, bucket=cfg.bbox_bucket)
    out = SeamlessClone(cfg, device="cpu").run(src, dst, mask, CENTER).numpy()
    inside = _interior(dst.shape, prep)
    assert out.shape == dst.shape and out.dtype == np.uint8
    assert np.array_equal(out[~inside], dst[~inside])
    assert not np.array_equal(out[inside], dst[inside])


def test_auto_above_crossover_raises(monkeypatch):
    """Above the crossover the default mg_padded="q" runs (tests/
    test_torch_mg_pipeline.py), at any tolerance: one whose check-free burst
    is 0 runs the check-first loop, the serve frame landing where the run
    does. The dense mode mg_padded=True runs there too."""
    monkeypatch.setattr(TE, "AUTO_CROSSOVER_PIXELS", 100)
    monkeypatch.setattr(TE, "SERVE_CROSSOVER_PIXELS", 100)
    src, dst, _ = _images(src_hw=(522, 530), dst_hw=(560, 600))
    mask = np.full(src.shape[:2], 255, np.uint8)  # interior 518 x 526, above 2^18
    center = (300, 280)
    eng = SeamlessClone(CloneConfig(tol=0.05), device="cpu")
    run = eng.run(src, dst, mask, center).numpy()
    assert eng.metrics["solver_resolved"] == "multigrid"
    served, _ = eng.timed_serve(src, dst, mask, center, loops=0)
    assert np.array_equal(served.numpy(), run) and not np.array_equal(run, dst)
    eng = SeamlessClone(CloneConfig(mg_padded=True, tol=0.05), device="cpu")
    dense = eng.run(src, dst, mask, center).numpy()
    assert eng.metrics["solver_resolved"] == "multigrid"
    served, _ = eng.timed_serve(src, dst, mask, center, loops=0)
    assert np.array_equal(served.numpy(), dense) and not np.array_equal(dense, dst)


def test_port_imports_no_jax():
    """No file of the port, and not chip_smoke.py, imports jax or the JAX
    package, not even its JAX-free modules; nor cv2, which the card's
    machine does not have (the port's Canny is ``ops/canny.py``). The C
    ABI's ``capi.cpp`` imports the port's ``capi_host`` and names no JAX
    module."""
    banned = ("jax", "jaxlib", "seamlesscloneoptimization_tpu", "cv2")
    files = sorted((REPO / "seamlesscloneoptimization_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 10
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            for name in names:
                assert not any(name == b or name.startswith(b + ".") for b in banned), (
                    f"{path.relative_to(REPO)} imports {name}")
    # the C ABI's embedded interpreter imports the port's host module only
    capi = (REPO / "seamlesscloneoptimization_tpu_torch" / "capi" / "capi.cpp").read_text()
    imported = re.findall(r'PyImport_ImportModule\("([^"]+)"\)', capi)
    assert imported == ["seamlesscloneoptimization_tpu_torch.capi_host"]
    assert not re.search(r"seamlesscloneoptimization_tpu(?!_torch)|\bjax\b", capi)


def _params(fn, drop=("device",)):
    """(name, kind, default) of each parameter but the port's added ``device``."""
    return [(p.name, p.kind, p.default) for p in inspect.signature(fn).parameters.values()
            if p.name not in drop]


@pytest.mark.parametrize("name", [
    "api.seamless_clone_batch", "api.seamless_clone_batch_fused", "api.color_change",
    "api.illumination_change", "api.texture_flattening", "api._local_edit",
    "parallel.batch.fast_dst_solver", "parallel.batch.clone_roi_batch",
    "parallel.batch.clone_batch_composite", "parallel.batch.clone_batch_composite_p",
    "parallel.batch.clone_batch_composite_dyn", "parallel.batch.seamless_clone_batch_fused",
    "ops.edit.erode3x3_replicate", "ops.edit.edit_guidance", "ops.edit.local_edit_planar",
    "parallel.clone_tiled.local_edit_tiled"])
def test_batch_and_edit_signatures_match_jax(name):
    """Each public function of the batch and edit slice takes the JAX
    function's parameters (names, kinds, defaults), plus ``device`` where
    it chooses where to run and ``mesh`` where it splits its jobs over one."""
    mod, _, fn = name.rpartition(".")
    port = getattr(importlib.import_module(f"seamlesscloneoptimization_tpu_torch.{mod}"), fn)
    ref = getattr(importlib.import_module(f"seamlesscloneoptimization_tpu.{mod}"), fn)
    # clone_roi_batch's ``mesh`` is the port's counterpart of JAX's input
    # sharding of the job axis; every other function keeps JAX's own ``mesh``.
    drop = ("device", "mesh") if name == "parallel.batch.clone_roi_batch" else ("device",)
    assert _params(port, drop) == _params(ref, drop)


# ROADMAP "Not to port": JAX names the port leaves out on purpose
NOT_TO_PORT = {"solve_auto", "tile_sharding", "image_sharding"}


@pytest.mark.parametrize("pkg", ["ops", "solvers", "parallel"])
def test_package_exports_cover_jax(pkg):
    """Every name the JAX package exports from ``ops``, ``solvers`` and
    ``parallel`` (its ``__all__``), but those ROADMAP lists as not to port,
    is exported by the port's package of the same name, and every name the
    port exports resolves."""
    port = importlib.import_module(f"seamlesscloneoptimization_tpu_torch.{pkg}")
    ref = importlib.import_module(f"seamlesscloneoptimization_tpu.{pkg}")
    missing = set(ref.__all__) - NOT_TO_PORT - set(port.__all__)
    assert not missing, f"{pkg} does not export {sorted(missing)}"
    for name in port.__all__:
        assert getattr(port, name) is not None


def test_slice8_signatures_extend_jax():
    """``init_distributed`` takes JAX's parameters; ``solve_multigrid_sharded``
    JAX's, then the port's ``return_info`` and ``eig_cache``; the AST scan
    above covers the new modules and the ranks' script."""
    from seamlesscloneoptimization_tpu.parallel import init_distributed as j_init
    from seamlesscloneoptimization_tpu.parallel import solve_multigrid_sharded as j_sharded
    from seamlesscloneoptimization_tpu_torch.parallel import (
        init_distributed,
        solve_multigrid_sharded,
    )

    assert _params(init_distributed) == _params(j_init)
    got = _params(solve_multigrid_sharded)
    assert got[: len(_params(j_sharded))] == _params(j_sharded)
    assert [p[0] for p in got[len(_params(j_sharded)) :]] == ["return_info", "eig_cache"]
    scanned = {p.name for p in (REPO / "seamlesscloneoptimization_tpu_torch").rglob("*.py")}
    assert {"transport.py", "dist_check.py", "tiled.py", "mesh.py"} <= scanned
