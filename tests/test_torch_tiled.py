"""The port's tile decomposition against the JAX package on the CPU: the
``rb_sweeps_tile`` twin against ``rb_sweeps_tile_pallas`` run with
``interpret=True``, ``halo_exchange`` against the globally zero-padded
array, ``solve_redblack_tiled``, ``solve_multigrid_dd`` and
``solve_poisson_dd`` against JAX's on a 2x4 mesh (the port's of eight CPU
devices, JAX's of the eight virtual devices of conftest.py), the mesh
helpers, the element V-cycle's fused level (the exact-size ``mg_down`` /
``mg_up``) with ``solve_multigrid(padded=False)`` that reaches it, and
``TiledSeamlessClone`` / ``seamless_clone_tiled`` against the JAX engine
on that mesh and against the port's single-device engine, on synthetic
images.

Tolerances: the tile sweeps are a subtract, a multiply by 0.25 and a select,
the neighbour sum in the same order on both sides, so the twin is bit-exact
against the Pallas kernel and the tiled solve against JAX's at a fixed sweep
count (JAX's own tests hold its Pallas body bitwise equal to the XLA body we
compare with); at a tolerance only the residual check may differ by an ulp,
so equal sweep counts and max |du| <= 1e-6 max |u|. The fused level's
uniform-operator sweeps and ascent are bit-exact against the exact-size
Pallas kernels; the residual, the restriction and the beta-level operator
agree to rtol 3e-6 (floor 1e-6 max |ref|), as ``tests/test_torch_multigrid.py``
holds the padded forms: XLA on the CPU contracts multiply-adds into FMAs.
A fused V-cycle against JAX's element V-cycle: rel 1e-5 (measured 3.4e-7).
The DD cycle is the same arithmetic in the same order as JAX's XLA body
(the tile sweeps bit-exact), but its coarse solve ends in the coarsest
level's GEMMs, summed in another order: rel 1e-5 (measured 1.2e-6 to
2.3e-6), equal cycles in tolerance mode. End to end diff_max <= 1 (u8).
Inputs are numpy-seeded.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seamlesscloneoptimization_tpu.core.config import CloneConfig as JaxConfig
from seamlesscloneoptimization_tpu.ops import pallas_kernels as PK
from seamlesscloneoptimization_tpu.parallel import TiledSeamlessClone as JaxTiled
from seamlesscloneoptimization_tpu.parallel import make_tile_mesh as jax_mesh
from seamlesscloneoptimization_tpu.parallel import seamless_clone_tiled as jax_clone_tiled
from seamlesscloneoptimization_tpu.parallel import solve_multigrid_dd as jax_dd
from seamlesscloneoptimization_tpu.parallel import solve_poisson_dd as jax_poisson_dd
from seamlesscloneoptimization_tpu.parallel import solve_redblack_tiled as jax_rb_tiled
from seamlesscloneoptimization_tpu.solvers import multigrid as JM
from seamlesscloneoptimization_tpu_torch.core.config import CloneConfig
from seamlesscloneoptimization_tpu_torch.core.engine import SeamlessClone
from seamlesscloneoptimization_tpu_torch.ops import kernels as K
from seamlesscloneoptimization_tpu_torch.parallel import (
    TiledSeamlessClone,
    gather_tiles,
    halo_exchange,
    local_edit_tiled,
    make_tile_mesh,
    seamless_clone_tiled,
    shard_tiles,
    solve_multigrid_dd,
    solve_poisson_dd,
    solve_redblack_tiled,
)
from seamlesscloneoptimization_tpu_torch.solvers import multigrid as TM

# Several pytest-xdist workers share the cores: one intra-op thread each keeps
# torch's OpenMP pools from oversubscribing them. Results do not depend on it.
torch.set_num_threads(1)

CPU8 = [torch.device("cpu")] * 8


def _rand(shape, seed, scale=50.0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32) * scale


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@functools.lru_cache(maxsize=None)
def _mesh24():
    return jax_mesh(jax.devices()[:8], (2, 4))


def _port(shape=(2, 4)):
    return make_tile_mesh([torch.device("cpu")] * (shape[0] * shape[1]), shape)


def _rel(got, want):
    return float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())


# ---------------------------------------------------------------------------
# the rb_sweeps_tile twin against the Pallas kernel
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("origin", [(0, 0), (-4, -4), (17, -3), (5, 10)])
@pytest.mark.parametrize("shape", [(2, 20, 36), (1, 21, 33)])
def test_rb_sweeps_tile_plain_matches_pallas(shape, origin):
    """Bit-exact over the whole tile for odd and negative origins, a domain
    holding the tile and one cutting it, 1, 2 and 5 sweeps (5: two
    launches); the wrapper on a CPU tensor runs the twin and counts no
    launch."""
    for dom in ((200, 200), (14, 22)):
        for n in (1, 2, 5):
            u, g = _rand(shape, n, 10.0), _rand(shape, n + 7)
            want = np.asarray(PK.rb_sweeps_tile_pallas(
                jnp.asarray(u), jnp.asarray(g), n, jnp.asarray(origin, jnp.int32), dom,
                interpret=True))
            got = K.rb_sweeps_tile_plain(_t(u), _t(g), n, origin, dom)
            np.testing.assert_array_equal(got.numpy(), want)
            K.reset_launches()
            assert torch.equal(K.rb_sweeps_tile(_t(u), _t(g), n, origin, dom), got)
            assert K.LAUNCHES["rb_sweeps_tile"] == 0


def test_rb_sweeps_tile_validates_inputs():
    u = torch.zeros((2, 20, 36))
    assert K.rb_sweeps_tile(u, u, 0, (0, 0), (20, 36)) is u
    for bad in (lambda: K.rb_sweeps_tile(u, u, -1, (0, 0), (20, 36)),
                lambda: K.rb_sweeps_tile(u, torch.zeros((2, 20, 35)), 2, (0, 0), (20, 36)),
                lambda: K.rb_sweeps_tile(u[:, :, ::2], u[:, :, ::2], 2, (0, 0), (20, 36))):
        with pytest.raises(ValueError):
            bad()
    with pytest.raises(TypeError):
        K.rb_sweeps_tile(u.double(), u.double(), 2, (0, 0), (20, 36))


@pytest.mark.parametrize("band", ["top", "bottom", "left", "right"])
def test_rb_sweeps_tile_takes_band_windows(band):
    """A band of a ghosted tile (a strided view, as the interior-first
    schedule passes it) against the Pallas kernel on the band's values, at
    an odd origin with the domain clipping it; on a CPU tensor the twin,
    no launch. A view whose rows overlap or whose columns are strided
    raises."""
    x, gx = _rand((2, 28, 30), 41, 10.0), _rand((2, 28, 30), 42)
    cut = {"top": np.s_[:, :12], "bottom": np.s_[:, -12:], "left": np.s_[:, :, :12],
           "right": np.s_[:, :, -12:]}[band]
    want = np.asarray(PK.rb_sweeps_tile_pallas(
        jnp.asarray(x[cut]), jnp.asarray(gx[cut]), 3, jnp.asarray((-3, 6), jnp.int32), (20, 25),
        interpret=True))
    u, g = _t(x)[cut], _t(gx)[cut]
    assert not u.is_contiguous()
    K.reset_launches()
    got = K.rb_sweeps_tile(u, g, 3, (-3, 6), (20, 25))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.is_contiguous() and K.LAUNCHES["rb_sweeps_tile"] == 0
    rows = torch.zeros(100).as_strided((1, 4, 8), (100, 4, 1))  # rows overlap
    for bad in (rows, u[:, :, ::2]):
        with pytest.raises(ValueError):
            K.rb_sweeps_tile(bad, bad, 1, (0, 0), (8, 8))


# ---------------------------------------------------------------------------
# the mesh and the halo exchange
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [1, 4])
def test_halo_exchange_matches_global_pad(k):
    """Every ghosted tile is the window of the globally zero-padded array,
    corners included (JAX tests/test_parallel.py's check)."""
    x = _rand((2, 16, 32), 1)
    mesh = _port()
    tiles = halo_exchange(shard_tiles(_t(x), mesh), k)
    xg = np.pad(x, ((0, 0), (k, k), (k, k)))
    for iy in range(2):
        for ix in range(4):
            np.testing.assert_array_equal(
                tiles[iy][ix].numpy(), xg[:, iy * 8 : iy * 8 + 8 + 2 * k,
                                          ix * 8 : ix * 8 + 8 + 2 * k])


def test_mesh_shapes_shard_and_gather(monkeypatch):
    mesh = make_tile_mesh(CPU8)
    assert mesh.shape == (2, 4) and mesh.size == 8  # the most-square factorisation
    assert mesh.distinct() == [torch.device("cpu")]
    assert make_tile_mesh(CPU8[:6]).shape == (2, 3)
    assert make_tile_mesh(CPU8[:7]).shape == (1, 7)
    x = _t(_rand((3, 16, 32), 2))
    tiles = shard_tiles(x, mesh)
    assert tiles[1][3].shape == (3, 8, 8) and tiles[1][3].is_contiguous()
    assert torch.equal(gather_tiles(tiles), x)
    with pytest.raises(ValueError, match="not divisible"):
        shard_tiles(_t(_rand((3, 15, 32), 3)), mesh)
    for shape in ((3, 3), (0, 8), (8, 2)):
        with pytest.raises(ValueError, match="mesh shape"):
            make_tile_mesh(CPU8, shape)
    with pytest.raises(ValueError, match="at least one"):
        make_tile_mesh([])
    with pytest.raises(ValueError, match="unsupported"):
        make_tile_mesh(["meta"])
    # without a card: no default mesh, no CUDA mesh, no quiet CPU fallback
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_tile_mesh()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_tile_mesh([torch.device("cuda")] * 4, (2, 2))
    with pytest.raises(RuntimeError):
        TiledSeamlessClone()
    with pytest.raises(RuntimeError):
        seamless_clone_tiled(np.zeros((8, 8, 3), np.uint8), np.zeros((8, 8, 3), np.uint8),
                             None, (4, 4))


def test_unported_paths_raise():
    """The name is kept from when ``path="gspmd"`` raised NotImplementedError:
    it runs now, on the engine, the one-shot function and the edits (the
    partitioned V-cycle, ``tests/test_torch_sharded.py``); a path that is
    neither "dd" nor "gspmd" still raises ValueError."""
    mesh = _port()
    eng = TiledSeamlessClone(mesh=mesh, path="gspmd")
    src, dst, mask = _images(7)
    out = eng.run(src, dst, mask, CENTER).numpy()
    assert eng.metrics["solver_resolved"] == "multigrid_gspmd" and out.shape == dst.shape
    assert _diff_max(seamless_clone_tiled(src, dst, mask, CENTER, mesh=mesh, path="gspmd"),
                     out) <= 1
    edit = local_edit_tiled(np.zeros((8, 8, 3), np.uint8), None, "color_change", (1, 1, 1),
                            mesh=_port((1, 1)), path="gspmd")
    assert edit.shape == (8, 8, 3)
    with pytest.raises(ValueError, match="path"):
        TiledSeamlessClone(mesh=mesh, path="spmd")
    with pytest.raises(ValueError, match="path"):
        seamless_clone_tiled(src, dst, mask, CENTER, mesh=mesh, path="spmd")
    with pytest.raises(ValueError, match="path"):
        local_edit_tiled(np.zeros((8, 8, 3), np.uint8), None, "color_change", (1, 1, 1),
                         mesh=mesh, path="spmd")


# ---------------------------------------------------------------------------
# solve_redblack_tiled against JAX's on the 2x4 mesh
# ---------------------------------------------------------------------------


def _padded_rhs(h, w, th, tw, seed):
    g = np.zeros((3, h, w), np.float32)
    g[:, :th, :tw] = _rand((3, th, tw), seed)
    return g


@pytest.mark.parametrize("case", [
    dict(hw=(32, 64), halo=2), dict(hw=(32, 64), halo=4), dict(hw=(32, 64), halo=8),
    dict(hw=(32, 64), halo=4, true_hw=(30, 61)),
    dict(hw=(48, 96), halo=4, true_hw=(45, 90), overlap=True),
    # the interior-first schedule (24x24 tiles > 4s) against JAX's, its XLA
    # body and its Pallas kernel interpreted
    dict(hw=(48, 96), halo=2, true_hw=(45, 90), overlap=True),
    dict(hw=(48, 96), halo=8, true_hw=(45, 90), overlap=True),
    dict(hw=(48, 96), halo=2, true_hw=(45, 90), overlap=True, jax_pallas=True),
    dict(hw=(48, 96), halo=4, true_hw=(45, 90), overlap=True, jax_pallas=True),
    dict(hw=(48, 96), halo=8, true_hw=(45, 90), overlap=True, jax_pallas=True),
])
def test_redblack_tiled_bit_equal_to_jax(case):
    """tol 0 and a fixed sweep count: bit-equal u, padded cells exactly 0;
    ``overlap=True`` also bit-equal to the port's plain schedule."""
    h, w = case["hw"]
    thw = case.get("true_hw")
    g = _padded_rhs(h, w, *(thw or (h, w)), seed=h + case["halo"])
    kw = dict(true_hw=thw, tol=0.0, max_iters=40, halo=case["halo"],
              overlap=case.get("overlap", False))
    jax_pallas = case.get("jax_pallas", False)
    want = np.asarray(jax_rb_tiled(jnp.asarray(g), _mesh24(), use_pallas=jax_pallas,
                                   interpret=jax_pallas, **kw))
    got, info = solve_redblack_tiled(_t(g), _port(), return_info=True, **kw)
    np.testing.assert_array_equal(got.numpy(), want)
    s = case["halo"] // 2  # sweeps per exchange; a burst is whole rounds
    assert info["iterations"] == (50 // s) * s
    if thw:
        assert not got[:, thw[0]:].any() and not got[:, :, thw[1]:].any()
    if case.get("overlap"):  # the interior-first schedule is the same arithmetic
        kw["overlap"] = False
        assert torch.equal(solve_redblack_tiled(_t(g), _port(), **kw), got)


@pytest.mark.parametrize("case", [
    dict(shape=(3, 40, 80), halo=4, true_hw=None),      # 20x20 tiles > 4s = 8
    dict(shape=(2, 40, 80), halo=8, true_hw=(37, 75)),  # 20x20 tiles > 16
    dict(shape=(2, 32, 64), halo=8, true_hw=None),      # 16x16 tiles = 4s: the plain round
])
def test_redblack_tiled_overlap_runs_the_schedule(case, monkeypatch):
    """The regions that K.rb_sweeps_tile sweeps, a tile a round: the
    unghosted tile at its origin, then the top, bottom, left and right
    bands of the ghosted tile at theirs (JAX's ``ca_round_overlap``), with
    the shapes JAX's Pallas body sweeps (recorded at its trace); where a
    tile is not above 4s on a side, the one ghosted tile of the plain
    round. Port and JAX bit-equal."""
    c, h, w = case["shape"]
    k, s = case["halo"], case["halo"] // 2
    th, tw = h // 2, w // 4
    calls, jax_shapes = [], []
    port_sweep, jax_sweep = K.rb_sweeps_tile, PK.rb_sweeps_tile_pallas

    def port_record(u, g, n, origin, dom):
        calls.append((tuple(u.shape), tuple(origin), n))
        return port_sweep(u, g, n, origin, dom)

    def jax_record(x, gx, n, origin, dom, **kw):
        jax_shapes.append(tuple(x.shape))
        return jax_sweep(x, gx, n, origin, dom, **kw)

    monkeypatch.setattr(K, "rb_sweeps_tile", port_record)
    monkeypatch.setattr(PK, "rb_sweeps_tile_pallas", jax_record)
    g = _padded_rhs(h, w, *(case["true_hw"] or (h, w)), seed=h + w + k)[:c]
    kw = dict(true_hw=case["true_hw"], tol=0.0, max_iters=2 * s, check_every=2 * s, halo=k,
              overlap=True)
    want = np.asarray(jax_rb_tiled(jnp.asarray(g), _mesh24(), use_pallas=True, interpret=True,
                                   **kw))
    got = solve_redblack_tiled(_t(g), _port(), **kw)
    np.testing.assert_array_equal(got.numpy(), want)
    tiles = [(iy * th, ix * tw) for iy in range(2) for ix in range(4)]
    if th > 4 * s and tw > 4 * s:
        b = k + 4 * s
        interior = [((c, th, tw), (r0, c0), s) for r0, c0 in tiles]
        bands = [(shape, org, s) for r0, c0 in tiles for shape, org in (
            ((c, b, tw + 2 * k), (r0 - k, c0 - k)),
            ((c, b, tw + 2 * k), (r0 + th + k - b, c0 - k)),
            ((c, th + 2 * k, b), (r0 - k, c0 - k)),
            ((c, th + 2 * k, b), (r0 - k, c0 + tw + k - b)))]
        one_round = interior + bands
        assert jax_shapes[:5] == [(c, th, tw)] + [shape for shape, _, _ in bands[:4]]
    else:
        one_round = [((c, th + 2 * k, tw + 2 * k), (r0 - k, c0 - k), s) for r0, c0 in tiles]
        assert jax_shapes[:1] == [(c, th + 2 * k, tw + 2 * k)]
    assert calls == one_round * 2  # 2s sweeps: two rounds


@pytest.mark.parametrize("use_pallas", [None, False])
def test_redblack_tiled_tolerance_matches_jax(use_pallas):
    """tol 1e-5: JAX's result is its own fixed-count iterate at the port's
    sweep count (so the counts agree), within 1e-6 max |u| of the port's,
    and the port's residual meets tol."""
    g = _rand((3, 32, 64), 11)
    want = np.asarray(jax_rb_tiled(jnp.asarray(g), _mesh24(), tol=1e-5, max_iters=40000,
                                   use_pallas=False))
    got, info = solve_redblack_tiled(_t(g), _port(), tol=1e-5, max_iters=40000,
                                     use_pallas=use_pallas, return_info=True)
    at_count = np.asarray(jax_rb_tiled(jnp.asarray(g), _mesh24(), tol=0.0,
                                       max_iters=info["iterations"], use_pallas=False))
    np.testing.assert_array_equal(want, at_count)
    assert np.abs(got.numpy() - want).max() <= 1e-6 * np.abs(want).max()
    assert 0 < info["iterations"] < 40000 and info["residual"] <= 1e-5 * np.abs(g).max()


def test_redblack_tiled_validates_and_clips_the_halo():
    mesh = _port()
    g = _t(_rand((1, 16, 32), 12))
    for bad in (dict(halo=3), dict(halo=0)):
        with pytest.raises(ValueError, match="halo"):
            solve_redblack_tiled(g, mesh, **bad)
    with pytest.raises(ValueError, match="not divisible"):
        solve_redblack_tiled(_t(_rand((1, 15, 32), 13)), mesh)
    with pytest.raises(ValueError, match="too small"):
        solve_redblack_tiled(_t(_rand((1, 2, 4), 14)), mesh)
    # halo > tile: clipped to the 8-px tile, as in the JAX package
    want = solve_redblack_tiled(g, mesh, tol=0.0, max_iters=8, halo=8)
    assert torch.equal(solve_redblack_tiled(g, mesh, tol=0.0, max_iters=8, halo=16), want)


# ---------------------------------------------------------------------------
# the element V-cycle's fused level: exact-size mg_down / mg_up
# ---------------------------------------------------------------------------

FUSED_CASES = [((21, 33), (1.0, 1.0)), ((20, 34), (1.0, 1.0)), ((40, 57), (1.5, 0.5)),
               ((20, 34), (1.25, 1.5))]


def _close(got, want, rtol=3e-6):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("hw,beta", FUSED_CASES)
def test_exact_size_level_matches_pallas(hw, beta):
    """The exact-size level as the port runs it (the level padded to an even
    height for K.mg_down / K.mg_up, cropped after) against the exact-size
    entries of mg_down_pallas / mg_up_pallas, interpreted."""
    (h, w), (bh, bw) = hw, beta
    hc = (h - 1) // 2
    slab = (2, h + h % 2, w)
    g, u = _rand((2, h, w), h), _rand((2, h, w), w, 10.0)
    e = _rand((2, hc, w), h + w, 5.0)
    g_p = TM._pad_to(_t(g), slab).contiguous()
    for u_zero in (False, True):
        ju, jrh = PK.mg_down_pallas(None if u_zero else jnp.asarray(u), jnp.asarray(g), 1,
                                    bh=bh, bw=bw, interpret=True, u_zero=u_zero)
        tu, trh = K.mg_down(None if u_zero else TM._pad_to(_t(u), slab).contiguous(), g_p, 1,
                            h, w, bh, bw)
        if beta == (1.0, 1.0):
            np.testing.assert_array_equal(tu[:, :h, :w].numpy(), np.asarray(ju))
        _close(tu[:, :h, :w], ju)
        _close(trh[:, :hc], jrh)
    ju = PK.mg_up_pallas(jnp.asarray(u), jnp.asarray(g), jnp.asarray(e), 2, bh=bh, bw=bw,
                         interpret=True)
    tu = K.mg_up(TM._pad_to(_t(u), slab).contiguous(), g_p,
                 TM._pad_to(_t(e), (2, slab[1] // 2, w)).contiguous(), 2, h, w, bh, bw)
    if beta == (1.0, 1.0):
        np.testing.assert_array_equal(tu[:, :h, :w].numpy(), np.asarray(ju))
    _close(tu[:, :h, :w], ju)


def test_fused_vcycle_matches_jax(monkeypatch):
    """A fused V-cycle at (1, 512, 512) (2^18 points: one fused level, then
    the element levels) against JAX's element V-cycle: rel 1e-5. The
    fused level ran: its twins were called once each."""
    g = _rand((1, 512, 512), 21)
    want = np.asarray(JM.vcycle(jnp.zeros((1, 512, 512)), jnp.asarray(g), 1, 2,
                                use_pallas=False))
    calls = {"mg_down": 0, "mg_up": 0}
    for name in calls:
        orig = getattr(K, f"{name}_plain")

        def counted(*a, _orig=orig, _name=name, **k):
            calls[_name] += 1
            return _orig(*a, **k)

        monkeypatch.setattr(K, f"{name}_plain", counted)
    got = TM.vcycle(torch.zeros((1, 512, 512)), _t(g), 1, 2, use_pallas=True)
    assert calls == {"mg_down": 1, "mg_up": 1}
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()


@functools.lru_cache(maxsize=None)
def _jax_unpadded(mode):
    g = _rand((1, 512, 520), 22)
    kw = dict(cycles=3) if mode == "cycles" else dict(tol=1e-4)
    u, info = JM.solve_multigrid(jnp.asarray(g), use_pallas=True, padded=False,
                                 return_info=True, **kw)
    return g, np.asarray(u), int(info["cycles"])


@pytest.mark.parametrize("mode", ["cycles", "tol"])
def test_solve_multigrid_unpadded_matches_jax(mode):
    """mg_padded=False: the element path whose 2^18-point fine level fuses,
    against JAX's solve_multigrid(padded=False) on the CPU (its element
    path): rel 1e-5, equal cycles, tol met."""
    g, want, cycles = _jax_unpadded(mode)
    kw = dict(cycles=3) if mode == "cycles" else dict(tol=1e-4)
    got, info = TM.solve_multigrid(_t(g), use_pallas=True, padded=False, return_info=True,
                                   **kw)
    assert info["cycles"] == cycles
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()
    if mode == "tol":
        assert info["residual"] <= 1e-4 * np.abs(g).max()


# ---------------------------------------------------------------------------
# solve_multigrid_dd and solve_poisson_dd
# ---------------------------------------------------------------------------


def _dd_rhs(true_hw):
    """(3, 64, 128), the RHS on the true cells only (JAX test_parallel.py's
    setup)."""
    ht, wt = true_hw or (64, 128)
    g = np.zeros((3, 64, 128), np.float32)
    g[:, :ht, :wt] = _rand((3, ht, wt), 13)
    return g


# (34, 120): the global even-size edge coarse ROW is the last local coarse
# row of tile ty=0 (the restriction's fourth Shortley-Weller term lies in
# the 2-ghost window); (60, 98): the same in the lane direction
@pytest.mark.parametrize("true_hw", [None, (61, 121), (34, 120), (60, 98)])
@pytest.mark.parametrize("use_pallas", [None, False])
def test_multigrid_dd_fixed_cycles_match_jax(true_hw, use_pallas):
    """4 cycles: rel 1e-5 against JAX's XLA body, padded cells exactly 0;
    the kernel route (None: twins on CPU tiles) equals the plain one."""
    g = _dd_rhs(true_hw)
    want = np.asarray(jax_dd(jnp.asarray(g), _mesh24(), true_hw=true_hw, cycles=4,
                             use_pallas=False))
    got = solve_multigrid_dd(_t(g), _port(), true_hw=true_hw, cycles=4, use_pallas=use_pallas)
    assert _rel(got, want) <= 1e-5
    if true_hw:
        assert not got[:, true_hw[0]:].any() and not got[:, :, true_hw[1]:].any()


@functools.lru_cache(maxsize=None)
def _jax_dd_tol():
    """JAX's tolerance-mode solve at 1e-5, and its cycle count: the fixed
    count whose iterate equals it bitwise."""
    g = _dd_rhs((61, 121))
    u = np.asarray(jax_dd(jnp.asarray(g), _mesh24(), true_hw=(61, 121), tol=1e-5,
                          use_pallas=False))
    for n in range(1, 12):
        fixed = np.asarray(jax_dd(jnp.asarray(g), _mesh24(), true_hw=(61, 121), cycles=n,
                                  use_pallas=False))
        if np.array_equal(fixed, u):
            return g, u, n
    raise AssertionError("no fixed cycle count reproduces JAX's tolerance-mode solve")


def test_multigrid_dd_tolerance_matches_jax():
    g, want, cycles = _jax_dd_tol()
    got, info = solve_multigrid_dd(_t(g), _port(), true_hw=(61, 121), tol=1e-5,
                                   return_info=True)
    assert info["cycles"] == cycles
    assert info["residual"] <= 1e-5 * np.abs(g).max()
    assert _rel(got, want) <= 1e-5


def test_multigrid_dd_validates_its_grid():
    with pytest.raises(ValueError, match="divisible"):
        solve_multigrid_dd(_t(_rand((1, 62, 128), 1)), _port())  # 62 % (2 x 2) != 0
    with pytest.raises(ValueError, match="ghost band"):
        solve_multigrid_dd(_t(_rand((1, 8, 16), 2)), _port())  # 4 x 4 tiles, band 6


@pytest.mark.parametrize("hw", [(45, 90), (61, 121), (10, 17)])
def test_poisson_dd_matches_jax(hw):
    """The arbitrary-size front door (tiles padded to >= 8)."""
    g = _rand((3,) + hw, hw[0])
    want = np.asarray(jax_poisson_dd(jnp.asarray(g), _mesh24(), use_pallas=False))
    got = solve_poisson_dd(_t(g), _port())
    assert got.shape == g.shape
    assert _rel(got, want) <= 1e-5


# ---------------------------------------------------------------------------
# the tiled seamless clone
# ---------------------------------------------------------------------------


def _images(seed=0, src_hw=(72, 128), dst_hw=(100, 200)):
    """Synthetic u8 images (H, W divisible by the 2x4 mesh, which JAX's
    sharded inputs need) and a disc-and-bar mask."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, 256, src_hw + (3,)).astype(np.uint8)
    dst = rng.integers(0, 256, dst_hw + (3,)).astype(np.uint8)
    yy, xx = np.mgrid[: src_hw[0], : src_hw[1]]
    mask = ((yy - 35) ** 2 + (xx - 65) ** 2 < 28 ** 2) | ((yy > 30) & (yy < 40) & (xx > 8))
    return src, dst, mask.astype(np.uint8) * 255


CENTER = (100, 50)


def _diff_max(a, b):
    return int(np.abs(np.asarray(a).astype(np.int16) - np.asarray(b)).max())


@pytest.mark.parametrize("flags", [1, 2, 3])
def test_tiled_engine_matches_jax(flags):
    """NORMAL / MIXED / MONOCHROME on the 2x4 mesh: the JAX engine's DD
    result within 1 grey level; two chained frames (each frame's output the
    next one's destination) too; the solve is the DD multigrid."""
    src, dst, mask = _images(flags)
    jax_eng = JaxTiled(JaxConfig(flags=flags), mesh=_mesh24())
    eng = TiledSeamlessClone(CloneConfig(flags=flags), mesh=_port())
    want = np.asarray(jax_eng.run(src, dst, mask, CENTER))
    got = eng.run(src, dst, mask, CENTER).numpy()
    assert eng.metrics["solver_resolved"] == jax_eng.metrics["solver_resolved"] == "multigrid_dd"
    assert _diff_max(got, want) <= 1
    assert not np.array_equal(got, dst)
    want2 = np.asarray(jax_eng.run(src, want, mask, CENTER))
    got2 = eng.run(src, got, mask, CENTER).numpy()
    assert _diff_max(got2, want2) <= 1


def test_seamless_clone_tiled_matches_jax():
    """The one-shot function: DD on every mesh, the 1x1 one included, and
    mg_cycles (fixed work)."""
    src, dst, mask = _images(4)
    want = jax_clone_tiled(src, dst, mask, CENTER, mesh=_mesh24())
    assert _diff_max(seamless_clone_tiled(src, dst, mask, CENTER, mesh=_port()), want) <= 1
    assert _diff_max(seamless_clone_tiled(src, dst, mask, CENTER, mesh=_port((1, 1))),
                     want) <= 1
    want4 = jax_clone_tiled(src, dst, mask, CENTER, mesh=_mesh24(), mg_cycles=4)
    got4 = seamless_clone_tiled(src, dst, mask, CENTER, mesh=_port(), mg_cycles=4)
    assert _diff_max(got4, want4) <= 1
    assert np.array_equal(seamless_clone_tiled(src, dst, np.zeros_like(mask), CENTER,
                                               mesh=_port()), dst)


def test_1x1_mesh_is_the_single_device_engine():
    """Byte for byte, run and serve, and the metrics' solver."""
    src, dst, mask = _images(5)
    for cfg in (CloneConfig(), CloneConfig(solver="multigrid", mg_cycles=2)):
        one = TiledSeamlessClone(cfg, mesh=_port((1, 1)))
        ref = SeamlessClone(cfg, device="cpu")
        assert np.array_equal(one.run(src, dst, mask, CENTER).numpy(),
                              ref.run(src, dst, mask, CENTER).numpy())
        assert one.metrics["solver_resolved"] == ref.metrics["solver_resolved"]
        a, _ = one.timed_serve(src, dst, mask, CENTER, loops=1)
        b, _ = ref.timed_serve(src, dst, mask, CENTER, loops=1)
        assert torch.equal(a, b)


def test_tiled_serve_counts_and_config(monkeypatch):
    """A 2x2-mesh serve frame as the card runs it, each twin call counted as
    a launch: clamp_cast_paste once a tile (the per-tile paste into each
    cell's destination tile), rb_sweeps_tile 2 a tile a cycle
    (nu1 = 1 and nu2 = 2, one exchange each), nothing else on this small
    coarse grid; mg_cycles fixes the cycles, tol sets them."""
    counts = {}
    for name in ("clamp_cast_paste", "rb_sweeps_tile"):
        orig = getattr(K, f"{name}_plain")

        def counted(*a, _orig=orig, _name=name, **k):
            counts[_name] = counts.get(_name, 0) + 1
            return _orig(*a, **k)

        monkeypatch.setattr(K, f"{name}_plain", counted)
    src, dst, mask = _images(6)
    eng = TiledSeamlessClone(CloneConfig(mg_cycles=3), mesh=_port((2, 2)))
    out, _ = eng.timed_serve(src, dst, mask, CENTER, loops=1)
    assert counts == {"clamp_cast_paste": 2 * 4, "rb_sweeps_tile": 2 * 4 * 3 * 2}
    assert out.shape == dst.shape and eng.metrics["solver_resolved"] == "multigrid_dd"
    counts.clear()
    eng = TiledSeamlessClone(CloneConfig(tol=1e-5), mesh=_port((2, 2)))
    got = eng.run(src, dst, mask, CENTER).numpy()
    cycles = counts["rb_sweeps_tile"] // 8
    assert counts == {"clamp_cast_paste": 4, "rb_sweeps_tile": 8 * cycles} and cycles > 3
    assert _diff_max(got, SeamlessClone(CloneConfig(solver="multigrid", tol=1e-5),
                                        device="cpu").run(src, dst, mask, CENTER)) <= 1
