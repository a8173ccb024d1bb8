"""The port's plain stage ops and host helpers against the JAX package, on
the CPU: every stage bit-exact on the same numpy-seeded inputs."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seamlesscloneoptimization_tpu.core import config as JC
from seamlesscloneoptimization_tpu.core import engine as JE
from seamlesscloneoptimization_tpu.core import reference as JR
from seamlesscloneoptimization_tpu.ops import guidance as JG
from seamlesscloneoptimization_tpu.ops import layout as JL
from seamlesscloneoptimization_tpu.ops import mask as JM
from seamlesscloneoptimization_tpu.ops import postprocess as JP
from seamlesscloneoptimization_tpu.ops import rhs as JRHS
from seamlesscloneoptimization_tpu_torch.core import config as TC
from seamlesscloneoptimization_tpu_torch.core import engine as TE
from seamlesscloneoptimization_tpu_torch.core import reference as TR
from seamlesscloneoptimization_tpu_torch.ops import guidance as TG
from seamlesscloneoptimization_tpu_torch.ops import layout as TL
from seamlesscloneoptimization_tpu_torch.ops import mask as TM
from seamlesscloneoptimization_tpu_torch.ops import postprocess as TP
from seamlesscloneoptimization_tpu_torch.ops import rhs as TRHS

# Several pytest-xdist workers share the cores: one intra-op thread each keeps
# torch's OpenMP pools from oversubscribing them (it cut this suite's CPU time
# about 3.5x). Results do not depend on it.
torch.set_num_threads(1)


def _u8(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(np.uint8)


def _mask(seed, shape, p=0.85):
    rng = np.random.default_rng(seed)
    return (rng.random(shape) < p).astype(np.uint8) * 255


def _eq(jax_out, torch_out):
    a, b = np.asarray(jax_out), torch_out.numpy()
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape, a.dtype, b.dtype)
    assert np.array_equal(a, b)


def test_layout_round_trip():
    img = _u8(0, (17, 23, 3))
    _eq(JL.interleaved_to_planar(jnp.asarray(img)), TL.interleaved_to_planar(torch.from_numpy(img)))
    p = _u8(1, (3, 17, 23))
    _eq(JL.planar_to_interleaved(jnp.asarray(p)),
        TL.planar_to_interleaved(torch.from_numpy(p)).contiguous())


def test_binarize_mask():
    m = _u8(2, (31, 45))
    m[::3] = 0
    _eq(JM.binarize_mask(jnp.asarray(m)), TM.binarize_mask(torch.from_numpy(m)))


@pytest.mark.parametrize("shape", [(1, 1), (6, 9), (40, 57)])
@pytest.mark.parametrize("iterations", [1, 3])
def test_erode3x3(shape, iterations):
    m = _mask(shape[0], shape, p=0.9)
    _eq(JM.erode3x3(jnp.asarray(m), iterations),
        TM.erode3x3(torch.from_numpy(m), iterations))


def test_gradients_and_gray():
    img = np.random.default_rng(3).normal(size=(3, 19, 26)).astype(np.float32) * 60
    _eq(JG.gradient_x(jnp.asarray(img)), TG.gradient_x(torch.from_numpy(img)))
    _eq(JG.gradient_y(jnp.asarray(img)), TG.gradient_y(torch.from_numpy(img)))
    u8 = _u8(4, (3, 19, 26)).astype(np.float32)
    _eq(JG.bgr_to_gray_u8(jnp.asarray(u8)), TG.bgr_to_gray_u8(torch.from_numpy(u8)))


@pytest.mark.parametrize("mode", [(1, "opencv"), (2, "opencv"), (2, "norm"), (3, "opencv")])
def test_guidance_rhs_postprocess(mode):
    flags, rule = mode
    d = _u8(5, (3, 33, 47)).astype(np.float32)
    p = _u8(6, (3, 33, 47)).astype(np.float32)
    me = np.array(JM.erode3x3(jnp.asarray(_mask(7, (33, 47)))))
    gx, gy = JG.guidance_field(jnp.asarray(d), jnp.asarray(p), jnp.asarray(me), flags, rule)
    tgx, tgy = TG.guidance_field(torch.from_numpy(d), torch.from_numpy(p),
                                 torch.from_numpy(me), flags, rule)
    _eq(gx, tgx.contiguous())
    _eq(gy, tgy.contiguous())
    g = JRHS.poisson_rhs(gx, gy, jnp.asarray(d))
    tg = TRHS.poisson_rhs(tgx, tgy, torch.from_numpy(d))
    _eq(g, tg)
    u = np.asarray(g) * 3.7 + 90.0  # spans below 0 and above 255
    _eq(JP.postprocess_roi(jnp.asarray(u), jnp.asarray(d.astype(np.uint8))),
        TP.postprocess_roi(torch.from_numpy(u), torch.from_numpy(d.astype(np.uint8))))


def test_guidance_unknown_flags_raises():
    x = torch.zeros((3, 4, 4))
    with pytest.raises(ValueError, match="flags"):
        TG.guidance_field(x, x, torch.zeros((4, 4), dtype=torch.uint8), 7)


def test_mask_helpers_match_reference():
    for seed, p in ((8, 0.3), (9, 0.0), (10, 1.0)):
        m = _mask(seed, (25, 38), p)
        assert np.array_equal(JR.zero_mask_border(m), TR.zero_mask_border(m))
        assert JR.mask_bounding_box(JR.zero_mask_border(m)) == TR.mask_bounding_box(
            TR.zero_mask_border(m))


@pytest.mark.parametrize("bucket", [0, 16, 64])
def test_prepare_inputs_matches_jax(bucket):
    src_shape, dst_shape = (60, 90, 3), (120, 160, 3)
    m = np.zeros(src_shape[:2], np.uint8)
    m[7:41, 12:70] = 200
    m[30:55, 60:88] = 1
    for center, tight in (((80, 60), False), ((50, 40), True)):
        want = JE.prepare_inputs(m, src_shape, dst_shape, center, bucket, tight)
        got = TE.prepare_inputs(m, src_shape, dst_shape, center, bucket, tight)
        assert np.array_equal(want[0], got[0])
        assert tuple(want[1:]) == tuple(got[1:])
    assert TE.prepare_inputs(np.zeros(src_shape[:2], np.uint8), src_shape, dst_shape,
                             (80, 60), bucket) is None


def test_prepare_inputs_errors_match_jax():
    src_shape, dst_shape = (60, 90, 3), (120, 160, 3)
    full = np.full(src_shape[:2], 255, np.uint8)
    for args, err in (((np.full((5, 5), 255, np.uint8), (80, 60), 0), "mask shape"),
                      ((full, (10, 10), 0), "outside destination"),
                      ((full, (80, 60), -1), "bbox_bucket")):
        m, center, bucket = args
        for mod in (JE, TE):
            with pytest.raises(ValueError, match=err):
                mod.prepare_inputs(m, src_shape, dst_shape, center, bucket)


def test_config_mirrors_jax_fields_and_defaults():
    jf = {f.name: f.default for f in dataclasses.fields(JC.CloneConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(TC.CloneConfig)}
    assert jf == tf
    assert (TC.NORMAL_CLONE, TC.MIXED_CLONE, TC.MONOCHROME_TRANSFER) == (
        JC.NORMAL_CLONE, JC.MIXED_CLONE, JC.MONOCHROME_TRANSFER)
    for solver in ("auto", "dst_gemm", "jacobi", "multigrid", "dst_fft"):
        assert (JC.CloneConfig(solver=solver).solver_kwargs()
                == TC.CloneConfig(solver=solver).solver_kwargs())
