"""The port's DST-GEMM precision modes against the JAX package on the CPU.

Modes (``solvers/dst_gemm.py``): ``highest`` / ``high`` FP32; ``default``
both operands rounded to bf16 once; ``2x_img`` the image split into bf16 hi
+ lo, the factor rounded once; ``2x_v`` the image rounded once, the factor
split; ``fwd2x`` / ``inv2x`` the ``2x_v`` product on the forward / inverse
GEMMs and FP32 on the others. JAX's CPU ignores ``Precision.DEFAULT`` (it
computes FP32), so its ``default`` reference is built here: the JAX chain
with ``_mm`` taking both operands to bf16 and summing in FP32
(``preferred_element_type=float32``).

Tolerances:
- one GEMM of each mode on the same inputs: relative 1e-6 of max |out|
  (the sums' order is the only difference);
- the whole ``solve_dst_gemm_pl`` chain, both branches, with the GEMMs'
  sums made order-free on both sides (each GEMM summed in float64 and
  rounded to FP32 once, ``_exact_sums``), so both take the same bf16
  roundings: relative 1e-5 of max |u|. This holds each mode's GEMMs in
  JAX's places and passes;
- the chains as they run, each held to the spread of JAX's own solve in
  that mode under a one-ulp change of g (measured on these shapes, ``AS_RUN``):
  1e-5 in FP32 (spread up to 5e-6: the low modes' conditioning), 3e-5 for
  ``2x_img`` (spread up to 1.1e-5: its lo pass and its once-rounded factor);
  the modes that round the image to bf16 once flip a rounding wherever the
  two implementations' FP32 sums differ by an ulp, and a flipped
  low-frequency coefficient moves u by up to a bf16 spacing of it (JAX's
  ``2x_v`` spread up to 6e-3 at 302x62): 2^-7, one bf16 spacing, of max |u|;
- the engines end to end: diff_max <= 1 (u8).
Inputs are numpy-seeded.
"""

import contextlib
import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seamlesscloneoptimization_tpu.core.config import CloneConfig as JConfig
from seamlesscloneoptimization_tpu.core.engine import SeamlessClone as JEngine
from seamlesscloneoptimization_tpu.models import pipeline as JP
from seamlesscloneoptimization_tpu.ops import pallas_kernels as PK
from seamlesscloneoptimization_tpu.solvers import dst_gemm as JD
from seamlesscloneoptimization_tpu_torch.core import engine as TE
from seamlesscloneoptimization_tpu_torch.core.config import CloneConfig
from seamlesscloneoptimization_tpu_torch.core.engine import SeamlessClone
from seamlesscloneoptimization_tpu_torch.ops import kernels as K
from seamlesscloneoptimization_tpu_torch.solvers import dst_gemm as TD

# Several pytest-xdist workers share the cores: one intra-op thread each keeps
# torch's OpenMP pools from oversubscribing them. Results do not depend on it.
torch.set_num_threads(1)

MODES = ["highest", "high", "default", "2x_img", "2x_v", "fwd2x", "inv2x"]
# the chains as they run: relative to max |u| (see the module docstring)
AS_RUN = {"highest": 1e-5, "high": 1e-5, "2x_img": 3e-5, "default": 2.0 ** -7,
          "2x_v": 2.0 ** -7, "fwd2x": 2.0 ** -7, "inv2x": 2.0 ** -7}
# (h2, w2): both sides fold (the pair chain); one side of at most 128 (the
# per-axis route, w folding, then h folding)
BRANCHES = {"pair": (150, 200), "per_axis_w": (62, 302), "per_axis_h": (302, 62)}
_STATIC = ("h2", "w2", "precision", "interpret", "folded", "pallas_fold", "return_parts")


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.abs(got - want).max() / np.abs(want).max()


def _rhs(h2, w2, seed):
    """The transposed RHS (C, WP, HP) at the origin of a zero slab."""
    hp, wp = K.ru128(h2), K.ru128(w2)
    g = np.zeros((3, wp, hp), np.float32)
    g[:, :w2, :h2] = np.random.default_rng(seed).normal(size=(3, w2, h2)) * 50
    return g


def _jax_default_mm(orig):
    """JD._mm with Precision.DEFAULT as the card runs it: both operands bf16,
    the products summed in FP32."""

    def mm(a, b, prec):
        if prec == jax.lax.Precision.DEFAULT:
            return jnp.einsum("...ij,jk->...ik", jnp.asarray(a).astype(jnp.bfloat16),
                              jnp.asarray(b).astype(jnp.bfloat16),
                              preferred_element_type=jnp.float32)
        return orig(a, b, prec)

    return mm


def _jax_chain(g, h2, w2, precision):
    """JAX's solve_dst_gemm_pl (interpret) in ``precision``, ``default``
    with its bf16 reference, traced afresh so that patched GEMMs apply."""
    fn = jax.jit(JD.solve_dst_gemm_pl.__wrapped__, static_argnames=_STATIC)
    with mock.patch.object(JD, "_mm", _jax_default_mm(JD._mm)):
        return np.asarray(fn(jnp.asarray(g), h2=h2, w2=w2, precision=precision,
                             interpret=True, folded=True))


def _f64_matmul(a, b):
    out = np.matmul(np.asarray(a, np.float64), np.asarray(b, np.float64))
    return out.astype(np.float32)


@contextlib.contextmanager
def _exact_sums():
    """Every GEMM of both chains summed in float64 and rounded to FP32 once:
    the same FP32 values on both sides whatever the summation order."""

    def jax_einsum(spec, a, b, precision=None, preferred_element_type=None):
        assert spec in ("...ij,jk->...ik", "ij,...jk->...ik"), spec
        shape = jnp.broadcast_shapes(a.shape[:-2], b.shape[:-2]) + (a.shape[-2], b.shape[-1])
        return jax.pure_callback(_f64_matmul, jax.ShapeDtypeStruct(shape, jnp.float32), a, b)

    torch_matmul = torch.matmul

    def matmul(a, b):
        return torch_matmul(a.double(), b.double()).float()

    with mock.patch.object(JD.jnp, "einsum", jax_einsum), \
            mock.patch.object(torch, "matmul", matmul):
        yield


@functools.lru_cache(maxsize=None)
def _want(branch, precision, exact):
    h2, w2 = BRANCHES[branch]
    g = _rhs(h2, w2, 7)
    with _exact_sums() if exact else contextlib.nullcontext():
        return _jax_chain(g, h2, w2, precision)


def _port(branch, precision):
    h2, w2 = BRANCHES[branch]
    return TD.solve_dst_gemm_pl(torch.from_numpy(_rhs(h2, w2, 7)), h2, w2,
                                precision=precision, folded=True).numpy()


@pytest.mark.parametrize("mode", ["bf16", "2x_img", "2x_v"])
def test_gemm_mode_matches_jax(mode):
    """One GEMM of each product (a fold-sized slab against a folded DST
    factor) against JAX's on the same inputs: the same roundings, the same
    passes, hi pass + lo pass."""
    a = np.random.default_rng(3).normal(size=(3, 256, 256)).astype(np.float32) * 50
    v = JD.dst_matrices_folded(300)[0]
    vt = torch.from_numpy(np.array(v))
    got = TD._mm(torch.from_numpy(a), vt, TD._split_bf16(vt), mode).numpy()
    if mode == "bf16":
        want = jnp.einsum("...ij,jk->...ik", jnp.asarray(a).astype(jnp.bfloat16),
                          jnp.asarray(v).astype(jnp.bfloat16), preferred_element_type=jnp.float32)
    else:
        want = JD._mm_2x(jnp.asarray(a), v, mode)
    assert got.dtype == np.float32
    assert _rel(got, want) < 1e-6
    assert _rel(got, TD._mm(torch.from_numpy(a), vt, None, "f32").numpy()) > 1e-4


@pytest.mark.parametrize("branch", list(BRANCHES))
@pytest.mark.parametrize("precision", MODES)
def test_chain_with_exact_sums_matches_jax(branch, precision):
    """The whole chain with order-free GEMM sums on both sides: each mode's
    products in JAX's places, to 1e-5 of max |u|."""
    h2, w2 = BRANCHES[branch]
    with _exact_sums():
        got = _port(branch, precision)
    want = _want(branch, precision, True)
    assert got.shape == want.shape
    assert _rel(got[:, :h2, :w2], want[:, :h2, :w2]) <= 1e-5


@pytest.mark.parametrize("branch", list(BRANCHES))
@pytest.mark.parametrize("precision", MODES)
def test_chain_matches_jax(branch, precision):
    """The chains as they run, to each mode's ``AS_RUN`` bound; every bf16
    mode differs from FP32, by more than it differs from JAX's."""
    h2, w2 = BRANCHES[branch]
    got = _port(branch, precision)[:, :h2, :w2]
    want = _want(branch, precision, False)[:, :h2, :w2]
    rel = _rel(got, want)
    assert rel <= AS_RUN[precision]
    fp32 = _port(branch, "highest")[:, :h2, :w2]
    if TD.uses_bf16(precision):
        assert _rel(got, fp32) > max(1e-4, rel)
    else:
        assert np.array_equal(got, fp32)


def test_bases_carry_the_bf16_forms():
    """dst_bases holds each factor's (hi, lo) bf16 forms for a bf16 mode
    only; a bf16 mode refuses bases without them; unknown names raise."""
    h2, w2 = BRANCHES["pair"]
    hp, wp = K.ru128(h2), K.ru128(w2)
    plain = TD.dst_bases(h2, w2, hp, wp, "cpu", folded=True)
    split = TD.dst_bases(h2, w2, hp, wp, "cpu", folded=True, precision="2x_v")
    assert plain[0].bf16 == () and len(split[0].bf16) == 4 and len(split[1].bf16) == 4
    for axis in split:
        for m, (hi, lo) in zip(axis.mats, axis.bf16):
            assert hi.dtype == lo.dtype == torch.bfloat16
            assert torch.equal(hi, m.to(torch.bfloat16))
            assert torch.equal(lo, (m - hi.float()).to(torch.bfloat16))
        assert len(axis.tensors()) == 5 + 8
    g = torch.from_numpy(_rhs(h2, w2, 7))
    assert torch.equal(TD.solve_dst_gemm_pl(g, h2, w2, "2x_v", True, bases=split),
                       TD.solve_dst_gemm_pl(g, h2, w2, "2x_v", True))
    with pytest.raises(ValueError, match="bf16 forms"):
        TD.solve_dst_gemm_pl(g, h2, w2, "2x_v", True, bases=plain)
    with pytest.raises(ValueError, match="precision"):
        TD.solve_dst_gemm_pl(g, h2, w2, "bf16_6x", True)
    with pytest.raises(ValueError, match="precision"):
        TD.dst_bases(h2, w2, hp, wp, "cpu", precision="tf32")


@pytest.mark.parametrize("kw", [{}, {"folded": True}, {"transposed_output": True}])
def test_plain_solve_default_matches_reference(kw):
    """solve_dst_gemm's "default" (both operands of every GEMM rounded to
    bf16 once) against JAX's chain with that rounding; it differs from
    "highest". The two-pass modes raise there, and in solve_sep_eig."""
    g = np.random.default_rng(4).normal(size=(3, 60, 150)).astype(np.float32) * 50
    fn = jax.jit(JD.solve_dst_gemm.__wrapped__,
                 static_argnames=("transform_only", "precision", "transposed_output",
                                  "transposed_input", "folded"))

    def default_mm(a, b, prec):  # JD._mm / JD._mm_left with DEFAULT in bf16
        return jnp.einsum("...ij,jk->...ik", jnp.asarray(a).astype(jnp.bfloat16),
                          jnp.asarray(b).astype(jnp.bfloat16), preferred_element_type=jnp.float32)

    def default_mm_left(m, a, prec):
        return jnp.einsum("ij,...jk->...ik", jnp.asarray(m).astype(jnp.bfloat16),
                          jnp.asarray(a).astype(jnp.bfloat16), preferred_element_type=jnp.float32)

    with mock.patch.object(JD, "_mm", default_mm), \
            mock.patch.object(JD, "_mm_left", default_mm_left):
        want = np.asarray(fn(jnp.asarray(g), precision="default", **kw))
    got = TD.solve_dst_gemm(torch.from_numpy(g), precision="default", **kw).numpy()
    fp32 = TD.solve_dst_gemm(torch.from_numpy(g), precision="highest", **kw).numpy()
    assert _rel(got, want) <= 2.0 ** -7
    assert _rel(got, fp32) > 1e-4
    assert np.array_equal(TD.solve_dst_gemm(torch.from_numpy(g), precision="high", **kw), fp32)
    for mode in ("2x_img", "2x_v", "fwd2x", "inv2x"):
        with pytest.raises(ValueError, match="precision"):
            TD.solve_dst_gemm(torch.from_numpy(g), precision=mode, **kw)
    with pytest.raises(ValueError, match="precision"):
        TD.solve_sep_eig(torch.from_numpy(g), 1.5, 1.0, precision="2x_v")


def test_sep_eig_default_rounds_every_gemm():
    """solve_sep_eig's "default" against its own FP32 GEMMs on bf16-rounded
    operands, step by step, with a beta != 1 basis."""
    g = torch.from_numpy(np.random.default_rng(5).normal(size=(2, 40, 50)).astype(np.float32))
    basis = TD.sep_eig_basis(40, 50, 1.5, 1.25, "cpu")

    def rb(x):
        return x.to(torch.bfloat16).float()

    vhi, vwi_t, lam, vh, vw_t = basis
    x = torch.matmul(rb(torch.matmul(rb(vhi), rb(g))), rb(vwi_t)) / lam
    want = torch.matmul(rb(torch.matmul(rb(vh), rb(x))), rb(vw_t))
    got = TD.solve_sep_eig(g, 1.5, 1.25, precision="default", basis=basis)
    assert torch.equal(got, want)


@contextlib.contextmanager
def _jax_full_pallas():
    """Every Pallas kernel of the JAX serve chain in interpret mode, and the
    pipeline's backend gate open (as tests/test_torch_pipeline.py does)."""

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


def _diff_max(a, b):
    return int(np.abs(np.asarray(a).astype(np.int16) - np.asarray(b)).max())


@pytest.mark.parametrize("precision", ["2x_v", "2x_img"])
def test_engine_matches_jax(precision):
    """SeamlessClone(CloneConfig(precision=...)) on the pair chain against
    the JAX engine's same mode (full-Pallas, interpreted): diff_max <= 1;
    the engine's cached bases hold the bf16 forms, so a frame splits
    nothing; timed_serve lands where run does."""
    rng = np.random.default_rng(11)
    src = rng.integers(0, 256, (210, 180, 3)).astype(np.uint8)
    dst = rng.integers(0, 256, (260, 240, 3)).astype(np.uint8)
    mask = np.zeros(src.shape[:2], np.uint8)
    mask[20:190, 10:170] = 255
    center = (120, 130)
    with _jax_full_pallas():
        want = np.asarray(JEngine(JConfig(precision=precision)).run(src, dst, mask, center))
    eng = SeamlessClone(CloneConfig(precision=precision), device="cpu")
    got = eng.run(src, dst, mask, center).numpy()
    assert eng.metrics["solver_resolved"] == "dst_gemm"
    assert _diff_max(got, want) <= 1 and not np.array_equal(got, dst)
    ((bases_h, bases_w),) = eng._bases.values()
    assert len(bases_h.bf16) == len(bases_h.mats) == 4 and len(bases_w.bf16) == 4
    no_build = AssertionError("a frame built bases")
    with mock.patch.object(TD, "dst_bases", side_effect=no_build), \
            mock.patch.object(TE, "dst_bases", side_effect=no_build):
        served, _ = eng.timed_serve(src, dst, mask, center, loops=0)  # the warm-up frame
    assert np.array_equal(served.numpy(), got)


def test_engine_refuses_unknown_precision():
    with pytest.raises(ValueError, match="precision"):
        SeamlessClone(CloneConfig(precision="tf32"), device="cpu")
