"""The per-axis DST route, where exactly one interior side folds, on the CPU.

A folded axis joins its half-GEMMs through the pair chain's fused kernels
(``transpose_pair``, ``unfold_transpose``, ``unfold_clamp_paste``) instead
of ``torch.cat``, ``transpose`` and ``unfold_minor``. On strips in both
orientations, with the folded side even and odd:

- ``solve_dst_gemm_pl(folded=True)`` (the twins) against the JAX
  package's with its Pallas fold in interpret mode: relative 1e-5;
- the pasted u8 of the fused route bit-equal to the route the port ran
  before, composed here from the twins (``fold_minor_plain``, ``torch.cat``,
  ``transpose_plain``, ``unfold_minor_plain``, ``clamp_cast_paste_plain``):
  the same GEMMs, the same sums;
- the kernels each route launches a frame, counted on the twins;
- the engine's frame against the JAX engine's: diff_max <= 1.

The kernels themselves run only on the card: tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_pipeline import jax_full_pallas

from seamlesscloneoptimization_tpu.core.config import CloneConfig as JConfig
from seamlesscloneoptimization_tpu.core.engine import SeamlessClone as JEngine
from seamlesscloneoptimization_tpu.solvers import dst_gemm as JD
from seamlesscloneoptimization_tpu_torch.core.config import CloneConfig
from seamlesscloneoptimization_tpu_torch.core.engine import SeamlessClone, prepare_inputs
from seamlesscloneoptimization_tpu_torch.models import pipeline as TP
from seamlesscloneoptimization_tpu_torch.ops import kernels as K
from seamlesscloneoptimization_tpu_torch.solvers import dst_gemm as TD

# Several pytest-xdist workers share the cores: one intra-op thread each keeps
# torch's OpenMP pools from oversubscribing them (it cut this suite's CPU time
# about 3.5x). Results do not depend on it.
torch.set_num_threads(1)

# interiors (h2, w2) where exactly one side folds: w, h, w odd, h odd
STRIPS = [(62, 302), (302, 62), (62, 301), (301, 62)]


def _rel(got, want):
    return float(np.abs(np.asarray(got) - np.asarray(want)).max() / np.abs(want).max())


def _diff_max(a, b):
    return int(np.abs(np.asarray(a).astype(np.int16) - np.asarray(b)).max())


def _g_tp(h2, w2, seed):
    g_tp = np.zeros((3, K.ru128(w2), K.ru128(h2)), np.float32)
    g_tp[:, :w2, :h2] = np.random.default_rng(seed).normal(size=(3, w2, h2)) * 50
    return g_tp


def _roi(h2, w2, seed):
    """dest, patch (3, h2 + 2, w2 + 2) u8 and a mask with holes whose
    bounding box is the whole ROI."""
    rng = np.random.default_rng(seed)
    h, w = h2 + 2, w2 + 2
    dest = rng.integers(0, 256, (3, h, w)).astype(np.uint8)
    src = rng.integers(0, 256, (3, h, w)).astype(np.uint8)
    mask = np.full((h, w), 255, np.uint8)
    yy, xx = np.mgrid[:h, :w]
    mask[((yy - h // 3) ** 2 + (xx - w // 3) ** 2) < (min(h, w) // 5) ** 2] = 0
    return dest, np.where(mask[None] != 0, src, 0).astype(np.uint8), mask


def parent_route(g_tp, h2, w2, bases):
    """The per-axis route before the fused kernels, on the twins: a folded
    axis concatenates its half-GEMM outputs and unfolds in its own pass."""
    bh, bw = bases

    def fwd(a, b):
        if not b.folded:
            return torch.matmul(a, b.mats[0])
        s, d = K.fold_minor_plain(a, b.n)
        return torch.cat([torch.matmul(s, b.mats[0]), torch.matmul(d, b.mats[1])], dim=-1)

    def inv(a, b):
        if not b.folded:
            return torch.matmul(a, b.mats[0])
        ep = b.mats[2].shape[0]
        return K.unfold_minor_plain(torch.matmul(a[..., :ep], b.mats[2]),
                                    torch.matmul(a[..., ep:], b.mats[3]), b.n, b.n_pad)

    tr1 = K.transpose_plain(fwd(g_tp, bh))
    tr2 = K.transpose_plain(fwd(tr1, bw), bh.lam, bw.lam)
    tr3 = K.transpose_plain(inv(tr2, bh))
    return inv(tr3, bw)


@pytest.mark.parametrize("hw", STRIPS)
def test_per_axis_solve_matches_jax(hw):
    """The solve against JAX's per-axis branch (Pallas fold, interpret
    mode); its w halves unfold to the same solution bit for bit."""
    h2, w2 = hw
    assert not TD.pair_chain_applies(h2, w2) and TD.fold_pays(max(hw))
    g_tp = _g_tp(h2, w2, h2 + w2)
    want = np.asarray(JD.solve_dst_gemm_pl(jnp.asarray(g_tp), h2=h2, w2=w2, folded=True,
                                           pallas_fold=True, interpret=True))
    got = TD.solve_dst_gemm_pl(torch.from_numpy(g_tp), h2, w2, folded=True)
    hp, wp = K.ru128(h2), K.ru128(w2)
    assert got.shape == want.shape == (3, hp, wp)
    assert _rel(got.numpy()[:, :h2, :w2], want[:, :h2, :w2]) < 1e-5
    pad = np.ones(got.shape, bool)
    pad[:, :h2, :w2] = False
    assert np.abs(got.numpy()[pad]).max() < 1e-4 * np.abs(want).max()
    if TD.parts_apply(w2, True):
        e_w, o_w = TD.solve_dst_gemm_pl(torch.from_numpy(g_tp), h2, w2, folded=True,
                                        return_parts=True)
        assert e_w.shape == o_w.shape == (3, hp, K.ru128((w2 + 1) // 2))
        assert torch.equal(K.unfold_minor_plain(e_w, o_w, w2, wp), got)
    else:
        with pytest.raises(ValueError, match="folded w axis"):
            TD.solve_dst_gemm_pl(torch.from_numpy(g_tp), h2, w2, folded=True,
                                 return_parts=True)


@pytest.mark.parametrize("planar", [True, False])
@pytest.mark.parametrize("hw", STRIPS)
def test_fused_route_pastes_what_the_parent_route_pasted(hw, planar):
    """clone_roi's kernel branch against the parent's composition, bit for
    bit, into a planar buffer and into an interleaved image (the
    single-shot run's destination, unfold_clamp_paste's byte stores)."""
    h2, w2 = hw
    dest, patch, mask = _roi(h2, w2, 7 * h2 + w2)
    dest_t, patch_t, mask_t = (torch.from_numpy(x) for x in (dest, patch, mask))
    g_tp = K.preprocess_rhs_t_plain(dest_t, patch_t, K.erode3_plain(mask_t))
    bases = TD.dst_bases(h2, w2, K.ru128(h2), K.ru128(w2), "cpu", folded=True)
    u = parent_route(g_tp, h2, w2, bases)
    img = np.random.default_rng(h2).integers(0, 256, (h2 + 9, w2 + 13, 3)).astype(np.uint8)
    at = (4, 5)  # the interior's top-left in the destination
    want = torch.from_numpy(img.transpose(2, 0, 1).copy() if planar else img.copy())
    got = want.clone()
    view = (lambda t: t) if planar else (lambda t: t.permute(2, 0, 1))
    K.clamp_cast_paste_plain(u, view(want), *at, h2, w2)
    out = TP.clone_roi(dest_t, patch_t, mask_t, 1, solver_kwargs={"folded": True},
                       out=view(got), out_offset=at, bases=bases)
    assert out.data_ptr() == got.data_ptr()
    assert torch.equal(got, want)
    outside = torch.ones(view(got).shape[1:], dtype=torch.bool)
    outside[at[0] : at[0] + h2, at[1] : at[1] + w2] = False
    base = torch.from_numpy(img.transpose(2, 0, 1).copy())
    assert torch.equal(view(got)[:, outside], base[:, outside])


@pytest.mark.parametrize("hw", STRIPS)
def test_per_axis_frame_launches(monkeypatch, hw):
    """The kernels a per-axis frame runs, each wrapper counted once a call
    (on the CPU it runs its twin): a folded w ends in unfold_clamp_paste,
    a folded h in unfold_transpose and clamp_cast_paste; unfold_minor never."""
    h2, w2 = hw
    names = ("fold_minor", "transpose", "transpose_pair", "unfold_transpose", "unfold_minor")
    seen = {}

    def counting(module, name):
        orig = getattr(module, name)

        def f(*a, **k):
            seen[name] = seen.get(name, 0) + 1
            return orig(*a, **k)
        monkeypatch.setattr(module, name, f)

    for name in names:
        counting(TD, name)
    for name in ("erode3", "preprocess_rhs_t", "unfold_clamp_paste", "clamp_cast_paste"):
        counting(TP, name)
    dest, patch, mask = _roi(h2, w2, h2 * w2)
    TP.clone_roi(*(torch.from_numpy(x) for x in (dest, patch, mask)), 1,
                 solver_kwargs={"folded": True})
    common = {"erode3": 1, "preprocess_rhs_t": 1, "fold_minor": 1, "transpose_pair": 1}
    if w2 > h2:  # strip W: only w folds
        want = dict(common, transpose=2, unfold_clamp_paste=1)
    else:        # strip H: only h folds
        want = dict(common, transpose=1, unfold_transpose=1, clamp_cast_paste=1)
    assert seen == want


@pytest.mark.parametrize("hw", STRIPS)
def test_engine_per_axis_matches_jax_engine(hw):
    """The engine's frame on a strip (its serve step, timed_serve with no
    timed frames, and its single-shot run into the interleaved destination)
    against the JAX engine's run with every Pallas kernel in interpret mode."""
    h2, w2 = hw
    rng = np.random.default_rng(h2 + 3 * w2)
    # a full mask loses the source's frame: the ROI is the source less 2 px
    src = rng.integers(0, 256, (h2 + 4, w2 + 4, 3)).astype(np.uint8)
    dst = rng.integers(0, 256, (h2 + 40, w2 + 50, 3)).astype(np.uint8)
    mask = np.full(src.shape[:2], 255, np.uint8)
    center = (dst.shape[1] // 2, dst.shape[0] // 2)
    prep = prepare_inputs(mask, src.shape, dst.shape, center)
    assert tuple(x - 2 for x in prep[3]) == hw
    with jax_full_pallas():
        want = np.asarray(JEngine(JConfig()).run(src, dst, mask, center))
    eng = SeamlessClone(CloneConfig(), device="cpu")
    served, _ = eng.timed_serve(src, dst, mask, center, loops=0)
    run = eng.run(src, dst, mask, center).numpy()
    assert eng.metrics["solver_resolved"] == "dst_gemm"
    assert _diff_max(served.numpy(), want) <= 1
    assert _diff_max(run, want) <= 1
    assert not np.array_equal(run, dst)
