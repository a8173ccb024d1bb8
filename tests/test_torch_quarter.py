"""The port's quarter-plane multigrid level against the JAX package on the CPU.

Each kernel twin of the ``"q"`` chain (``ops/kernels.py``) against its
Pallas kernel run with ``interpret=True``: the dense <-> quarter-plane
conversions, the descent in both forms, the fused cycle boundary and the
ascent with and without their residual, the split-plane prolongation at
odd and even sides and with two strips; the quarter RHS and the
quarters-consuming paste; the geometry and the path gate; and
``solve_multigrid(padded="q")``'s gaps and validation
(``tests/test_torch_quarter_dense.py`` has the split restriction and the
solves against JAX, the born-quartered one included).

Tolerances: the RHS, the paste and the conversions are integer-valued,
casts or moves, bit-exact.
The level twins run the same float operations in the same order as the
Pallas kernels, but XLA on the CPU may contract a multiply and an add into
one FMA (the even-h edge weights, 1/3 and 1/6, are not powers of two), so
they agree to rtol 3e-6 with an absolute floor of 1e-6 max |ref|, as in
``tests/test_torch_multigrid.py``; one cycle on a small grid to rel 1e-5.
Inputs are numpy-seeded.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seamlesscloneoptimization_tpu.ops import pallas_kernels as PK
from seamlesscloneoptimization_tpu.ops import pallas_mg_quarter as MQ
from seamlesscloneoptimization_tpu.solvers import multigrid as JM
from seamlesscloneoptimization_tpu_torch.ops import kernels as K
from seamlesscloneoptimization_tpu_torch.ops.guidance import bgr_to_gray_u8
from seamlesscloneoptimization_tpu_torch.solvers import jacobi as TJ
from seamlesscloneoptimization_tpu_torch.solvers import multigrid as TM

# Several pytest-xdist workers share the cores: one intra-op thread each keeps
# torch's OpenMP pools from oversubscribing them (it cut this suite's CPU time
# about 3.5x). Results do not depend on it.
torch.set_num_threads(1)

# (h, w): even/even, odd/odd, even/odd, odd/even, and two 128-row strips
CASES = [(200, 230), (201, 231), (250, 129), (129, 300), (300, 257)]


def _rand(shape, seed, scale=50.0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32) * scale


def _close(got, want, rtol=3e-6):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-6 * np.abs(want).max())


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _level(h, w, seed):
    """(geom, chp, g, u): quarter planes of a random RHS and guess, exact zeros
    outside the (h, w) domain."""
    geom = K.mg_geometry_q(h, w)
    _, hq, wq2, hp2 = geom
    chp = K.mg_geometry_t((w - 1) // 2, (h - 1) // 2, wp_min=hp2)[1]
    dense = []
    for k, scale in ((0, 50.0), (1, 10.0)):
        x = np.zeros((3, 2 * hq, 2 * wq2), np.float32)
        x[:, :h, :w] = _rand((3, h, w), seed + k, scale)
        dense.append(K.to_quarters(_t(x)))
    return geom, chp, dense[0], dense[1]


def _split_corr(h, w, hp2, wq2, seed):
    """e_even, e_odd as mg_prolong_tq leaves them: rows [0, hc) and the
    domain's even / odd columns hold data, zeros elsewhere."""
    hc = (h - 1) // 2
    ee = np.zeros((3, hp2, wq2), np.float32)
    eo = np.zeros((3, hp2, wq2), np.float32)
    ee[:, :hc, : (w + 1) // 2] = _rand((3, hc, (w + 1) // 2), seed, 5.0)
    eo[:, :hc, : w // 2] = _rand((3, hc, w // 2), seed + 1, 5.0)
    return _t(ee), _t(eo)


def _zero_outside(uq, h, w):
    d = K.from_quarters(uq).numpy()
    return not d[:, h:].any() and not d[:, :, w:].any()


# ---------------------------------------------------------------------------
# geometry, gate and the plain conversions
# ---------------------------------------------------------------------------


def test_geometry_and_gate_match_jax():
    for h in (3, 64, 127, 128, 255, 256, 257, 511, 512, 1548, 2798):
        for w in (3, 100, 255, 256, 257, 520, 2396, 3798):
            assert K.mg_geometry_q(h, w) == MQ.mg_geometry_q(h, w)
            for nu in ((1, 2), (0, 2), (2, 4), (2, 5), (3, 1)):
                for use_pallas in (True, False):
                    assert (TM.quarter_path_applies(h, w, *nu, use_pallas=use_pallas)
                            == JM.quarter_path_applies(h, w, *nu, use_pallas=use_pallas))
    assert TM.quarter_path_applies(512, 520) and not TM.quarter_path_applies(500, 500)


@pytest.mark.parametrize("hq, wq", [(128, 128), (256, 384)])
def test_to_and_from_quarters_match_jax(hq, wq):
    """Bit-exact against the XLA conversions and the Pallas kernels, and
    inverse to each other over the whole footprint."""
    x = _rand((3, 2 * hq, 2 * wq), 1)
    q = K.to_quarters(_t(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(MQ.to_quarters(jnp.asarray(x))))
    np.testing.assert_array_equal(q.numpy(), np.asarray(MQ.to_quarters_pallas(
        jnp.asarray(x), interpret=True)))
    d = K.from_quarters(q)
    np.testing.assert_array_equal(d.numpy(), np.asarray(MQ.from_quarters_pallas(
        jnp.asarray(q.numpy()), interpret=True)))
    np.testing.assert_array_equal(d.numpy(), x)
    assert np.array_equal(q[:, 1, :, :].numpy(), x[:, 0::2, 1::2])  # EO: even rows, odd cols


# ---------------------------------------------------------------------------
# the level twins against their Pallas kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hw", CASES)
def test_mg_down_q_matches_pallas(hw):
    """Both guesses, both forms: the fused restriction (rc_t) and the split
    one (rh_e, rh_o: the Pallas kernel's data rows [0, hc); the port's rows
    beyond are exact zeros where the Pallas kernel leaves residual
    leftovers), split + mg_restrict_tq bit-equal to the fused form."""
    h, w = hw
    geom, chp, g, u = _level(h, w, h + w)
    hc, wc = (h - 1) // 2, (w - 1) // 2
    for u_zero in (True, False):
        ju_arg = None if u_zero else jnp.asarray(u.numpy())
        ju, jrc = MQ.mg_down_q_pallas(ju_arg, jnp.asarray(g.numpy()), 1, (h, w), geom,
                                      u_zero=u_zero, interpret=True, rct_rows=chp)
        tu, trc = K.mg_down_q(None if u_zero else u, g, 1, h, w, chp)
        assert tu.shape == g.shape and trc.shape == (3, chp, geom[1])
        _close(tu, ju)
        _close(trc, jrc)
        assert _zero_outside(tu, h, w)
        assert not trc[:, wc:].any() and not trc[:, :, hc:].any()
        _, je, jo = MQ.mg_down_q_pallas(ju_arg, jnp.asarray(g.numpy()), 1, (h, w), geom,
                                        u_zero=u_zero, interpret=True)
        su, te, to = K.mg_down_q(None if u_zero else u, g, 1, h, w)
        assert torch.equal(su, tu) and te.shape == to.shape == (3, geom[1], geom[2])
        _close(te[:, :hc], np.asarray(je)[:, :hc])
        _close(to[:, :hc], np.asarray(jo)[:, :hc])
        assert not te[:, hc:].any() and not to[:, hc:].any()
        assert torch.equal(K.mg_restrict_tq(te, to, h, w, chp), trc)


@pytest.mark.parametrize("hw", CASES)
def test_mg_up_q_matches_pallas(hw):
    """With and without the residual max, which agrees with the Pallas
    kernel's to 3e-6 and with the dense residual of the result to 1e-5
    (black cells are 0 up to rounding)."""
    h, w = hw
    geom, _, g, u = _level(h, w, 3 * h + w)
    ee, eo = _split_corr(h, w, geom[3], geom[2], h)
    ju, jmax = MQ.mg_up_q_pallas(*(jnp.asarray(x.numpy()) for x in (u, g, ee, eo)), 2,
                                 (h, w), geom, interpret=True, with_residual=True)
    tu = K.mg_up_q(u, g, ee, eo, 2, h, w)
    _close(tu, ju)
    assert _zero_outside(tu, h, w)
    ru, rmax = K.mg_up_q(u, g, ee, eo, 2, h, w, with_residual=True)
    assert torch.equal(ru, tu) and rmax.dim() == 0
    assert abs(float(rmax) - float(jmax)) <= 3e-6 * float(jmax)
    r = TJ.residual(K.from_quarters(tu)[:, :h, :w], K.from_quarters(g)[:, :h, :w])
    assert abs(float(rmax) - r.abs().max().item()) <= 1e-5 * float(rmax)


@pytest.mark.parametrize("with_residual", [False, True])
@pytest.mark.parametrize("hw", CASES)
def test_mg_ud_q_matches_pallas(hw, with_residual):
    h, w = hw
    geom, chp, g, u = _level(h, w, h * w)
    ee, eo = _split_corr(h, w, geom[3], geom[2], w)
    want = MQ.mg_ud_q_pallas(*(jnp.asarray(x.numpy()) for x in (u, g, ee, eo)), 2, 1,
                             (h, w), geom, interpret=True, rct_rows=chp,
                             with_residual=with_residual)
    got = K.mg_ud_q(u, g, ee, eo, 2, 1, h, w, chp, with_residual=with_residual)
    assert len(got) == len(want) == 2 + with_residual
    _close(got[0], want[0])
    _close(got[1], want[1])
    if with_residual:
        rmax, jmax = float(got[2]), float(want[2])
        assert got[2].dim() == 0 and abs(rmax - jmax) <= 3e-6 * jmax
        # the red-cell max is the dense residual's (black cells are 0 up to rounding)
        dense = K.from_quarters(got[0])[:, :h, :w]
        r = TJ.residual(dense, K.from_quarters(g)[:, :h, :w]).abs().max().item()
        assert abs(rmax - r) <= 1e-5 * r


@pytest.mark.parametrize("hw", CASES)
def test_mg_prolong_tq_matches_pallas(hw):
    h, w = hw
    _, hq, wq2, hp2 = K.mg_geometry_q(h, w)
    hc, wc = (h - 1) // 2, (w - 1) // 2
    _, chp, cwp, _ = K.mg_geometry_t(wc, hc, wp_min=hp2)
    ec = np.zeros((3, chp, cwp), np.float32)
    ec[:, :wc, :hc] = _rand((3, wc, hc), 22, 5.0)
    je, jo = MQ.mg_prolong_tq_pallas(jnp.asarray(ec), h, w, 1.0, out_rows=hp2, wq2=wq2,
                                     interpret=True)
    te, to = K.mg_prolong_tq(_t(ec), w, hp2, wq2)
    assert te.shape == to.shape == (3, hp2, wq2)
    _close(te, je)
    _close(to, jo)
    assert not te[:, hc:].any() and not te[:, :, wc + 1 :].any()
    assert not to[:, hc:].any() and not to[:, :, w // 2 :].any()


# ---------------------------------------------------------------------------
# the quarter RHS and the quarters-consuming paste
# ---------------------------------------------------------------------------


def _rhs_inputs(h, w, seed):
    rng = np.random.default_rng(seed)
    dest = rng.integers(0, 256, (3, h, w)).astype(np.uint8)
    patch = rng.integers(0, 256, (3, h, w)).astype(np.uint8)
    mask = ((rng.random((h, w)) < 0.85) * 255).astype(np.uint8)
    mask[: h // 3, : w // 4] = 0
    return dest, patch, mask


@pytest.mark.parametrize("hw", [(40, 57), (131, 260)])
@pytest.mark.parametrize("mode", [(1, "opencv"), (2, "opencv"), (2, "norm"), (3, "opencv")])
def test_preprocess_rhs_q_matches_pallas(hw, mode):
    """Bit-exact against preprocess_rhs_quarters_pallas over all four planes;
    MONOCHROME passes its gray patch with flags 1, as the pipeline does."""
    flags, rule = mode
    h, w = hw
    dest, patch, mask = _rhs_inputs(h, w, h + flags)
    kflags = flags
    if flags == 3:
        gray = bgr_to_gray_u8(_t(patch)).numpy().astype(np.uint8)
        patch = np.broadcast_to(gray[None], patch.shape).copy()
        kflags = 1
    _, hq, wq2, _ = K.mg_geometry_q(h - 2, w - 2)
    out_hw = (2 * hq, 2 * wq2)
    me = K.erode3((_t(mask) != 0).to(torch.uint8))
    got = K.preprocess_rhs_q(_t(dest), _t(patch), me, out_hw, kflags, rule)
    want = np.asarray(PK.preprocess_rhs_quarters_pallas(
        jnp.asarray(dest), jnp.asarray(patch), jnp.asarray(mask), out_hw, kflags, rule,
        interpret=True))
    assert got.shape == (3, 4, hq, wq2)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("planar", [True, False])
@pytest.mark.parametrize("hw", [(255, 256), (200, 311)])
def test_clamp_cast_paste_q_matches_pallas(hw, planar):
    """The pasted interior equals clamp_cast_guarded_quarters_pallas's data
    region (row ring 256, column ring 512) and clamp_cast_paste of the dense
    solution, in a planar and an interleaved destination; nothing else of
    the destination changes."""
    h2, w2 = hw
    _, hq, wq2, _ = K.mg_geometry_q(h2, w2)
    uq = _t(_rand((3, 4, hq, wq2), 9, 160.0) + 90.0)
    slab = np.asarray(PK.clamp_cast_guarded_quarters_pallas(jnp.asarray(uq.numpy()),
                                                            interpret=True))
    rng = np.random.default_rng(h2)
    base = rng.integers(0, 256, (3, 300, 400) if planar else (300, 400, 3)).astype(np.uint8)
    top1, left1 = 7, 61
    got = torch.from_numpy(base.copy())
    got_v = got if planar else got.permute(2, 0, 1)
    assert K.clamp_cast_paste_q(uq, got_v, top1, left1, h2, w2) is got_v
    want = torch.from_numpy(base.copy())
    want_v = want if planar else want.permute(2, 0, 1)
    K.clamp_cast_paste(K.from_quarters(uq).contiguous(), want_v, top1, left1, h2, w2)
    assert torch.equal(got, want)
    np.testing.assert_array_equal(got_v[:, top1 : top1 + h2, left1 : left1 + w2].numpy(),
                                  slab[:, 256 : 256 + h2, 512 : 512 + w2])


# ---------------------------------------------------------------------------
# the solver
# ---------------------------------------------------------------------------


def _quartered(g):
    c, h, w = g.shape
    _, hq, wq2, _ = K.mg_geometry_q(h, w)
    gd = np.zeros((c, 2 * hq, 2 * wq2), np.float32)
    gd[:, :h, :w] = g
    return K.to_quarters(_t(gd))


def test_solve_multigrid_q_zero_cycles_and_small_grids():
    gq = _quartered(_rand((1, 512, 520), 3))
    z = TM.solve_multigrid(gq, true_hw=(512, 520), padded="q", use_pallas=True,
                           padded_output="quarters", cycles=0)
    assert z.shape == gq.shape and not z.any()
    # below the gate a dense pre-padded g runs the element path on its view
    g = _rand((1, 90, 100), 4)
    dense = K.from_quarters(_quartered(g))
    want = TM.solve_multigrid(_t(g), cycles=2, use_pallas=True, padded="t")
    got = TM.solve_multigrid(dense, cycles=2, use_pallas=True, padded="q", true_hw=(90, 100))
    assert torch.equal(got, want)


@pytest.mark.parametrize("what", ["dense g", "dense result", "burst 0", "small grid"])
def test_quarter_path_gaps_raise_slice_3c(what):
    """What raised until slice 3c brought its kernels (to_quarters,
    from_quarters, the check-first loop) now runs: a dense g is the
    born-quartered solve, a dense result its interleaved planes, a zero burst
    (tol 0.05) the check-first loop within tol, and a quartered g below the
    gate the element solve of its dense view."""
    g = _rand((1, 512, 520), 5)
    gq = _quartered(g)
    kw = dict(padded="q", use_pallas=True, true_hw=(512, 520), padded_output="quarters")
    planes = TM.solve_multigrid(gq, **kw, cycles=1)
    if what == "dense g":
        got = TM.solve_multigrid(_t(g), padded="q", use_pallas=True, cycles=1)
        assert torch.equal(got, K.from_quarters(planes)[:, :512, :520])
    elif what == "dense result":
        got = TM.solve_multigrid(gq, **dict(kw, padded_output=True), cycles=1)
        assert torch.equal(got, K.from_quarters(planes))
    elif what == "burst 0":
        assert TM._tol_burst(0.05, 60) == 0
        got = TM.solve_multigrid(gq, **kw, tol=0.05)
        u = K.from_quarters(got)[:, :512, :520]
        assert TJ.residual(u, _t(g)).abs().max().item() <= 0.05 * np.abs(g).max()
    else:  # JAX runs its XLA from_quarters there, and the element path
        small = _rand((1, 90, 100), 6)
        gqs = _quartered(small)
        got = TM.solve_multigrid(gqs, **dict(kw, true_hw=(90, 100)), cycles=1)
        assert torch.equal(got, TM.solve_multigrid(_t(small), use_pallas=True, cycles=1))
        want = JM.solve_multigrid(jnp.asarray(gqs.numpy()), **dict(kw, true_hw=(90, 100)),
                                  cycles=1, interpret=True)
        assert np.abs(got.numpy() - np.asarray(want)).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("kw", [dict(return_info=True), dict(u0=torch.zeros(1)),
                                dict(fmg_start=True), dict(pcg=True)])
def test_quartered_g_rejects_other_modes(kw):
    """As in the JAX package: a quartered g runs only the zero-start modes."""
    gq = _quartered(_rand((1, 512, 520), 7))
    with pytest.raises(ValueError, match="quartered g"):
        TM.solve_multigrid(gq, padded="q", use_pallas=True, true_hw=(512, 520), **kw)


def _bad_call(what):
    g = torch.zeros((3, 4, 128, 128))
    e = torch.zeros((3, 128, 128))
    u8 = torch.zeros((3, 20, 30), dtype=torch.uint8)
    me = torch.zeros((20, 30), dtype=torch.uint8)
    return {
        "odd out_hw": lambda: K.preprocess_rhs_q(u8, u8, me, (255, 256)),
        "small out_hw": lambda: K.preprocess_rhs_q(u8, u8, me, (16, 256)),
        "not 4 planes": lambda: K.mg_down_q(None, torch.zeros((3, 2, 128, 128)), 1, 200, 200,
                                            128),
        "domain too large": lambda: K.mg_down_q(None, g, 1, 257, 200, 128),
        "nu1 0": lambda: K.mg_down_q(None, g, 0, 200, 200, 128),
        "rct_rows": lambda: K.mg_down_q(None, g, 1, 200, 200, 64),
        "guess shape": lambda: K.mg_down_q(g[:, :, :64], g, 1, 200, 200, 128),
        "nu2 5": lambda: K.mg_up_q(g, g, e, e, 5, 200, 200),
        "staleness": lambda: K.mg_ud_q(g, g, e, e, 4, 3, 200, 200, 128),
        "correction shape": lambda: K.mg_ud_q(g, g, e[:, :64], e, 2, 1, 200, 200, 128),
        "prolong w": lambda: K.mg_prolong_tq(torch.zeros((3, 128, 128)), 2, 128, 128),
        "paste planes": lambda: K.clamp_cast_paste_q(torch.zeros((3, 2, 128, 128)), u8, 1, 1,
                                                     18, 28),
        "paste outside": lambda: K.clamp_cast_paste_q(g, u8, 3, 3, 18, 28),
        "odd dense": lambda: K.to_quarters(torch.zeros((3, 256, 255))),
        "not quarters": lambda: K.from_quarters(torch.zeros((3, 2, 128, 128))),
        "restrict shapes": lambda: K.mg_restrict_tq(e, e[:, :64], 200, 200, 128),
        "restrict rows": lambda: K.mg_restrict_tq(e, e, 200, 200, 64),
    }[what]


@pytest.mark.parametrize("what", ["odd out_hw", "small out_hw", "not 4 planes",
                                  "domain too large", "nu1 0", "rct_rows", "guess shape",
                                  "nu2 5", "staleness", "correction shape", "prolong w",
                                  "paste planes", "paste outside", "odd dense", "not quarters",
                                  "restrict shapes", "restrict rows"])
def test_quarter_wrappers_validate_inputs(what):
    """Each wrapper refuses what its kernel cannot run, on the CPU as on the
    card (the checks run before the device dispatch)."""
    with pytest.raises(ValueError):
        _bad_call(what)()
