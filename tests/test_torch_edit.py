"""The port's edit family against the JAX package and cv2 on the CPU.

``ops/canny.py`` against ``cv2.Canny`` (bit-exact: seeded noise, block and
noisy-block images, 1 and 3 channels, apertures 3 / 5 / 7, low > high,
thresholds at 0); ``erode3x3_replicate`` (bit-exact) and ``edit_guidance``
against JAX's (bit-exact for the colour change and the texture flattening;
the illumination change's power, XLA's ``pow`` against torch's, to
relative 1e-6 of max |g|); ``local_edit_planar`` against JAX's on the
direct route and with the crossover forced on a 3x520x520 image, whose
518x518 interior (>= 2^18 points) takes the port's quarter-plane chain
(its kernels' twins here) where JAX's CPU run takes its element path; the
api functions against JAX's and against cv2's ``colorChange`` /
``illuminationChange`` / ``textureFlattening`` (cv2 gets ``mask.copy()``:
it writes into its mask); ``local_edit_tiled`` on a 2x2 CPU mesh against
JAX's on a 2x2 mesh of virtual devices. End to end diff_max <= 1 (u8).
Images are numpy-seeded; the ``airplane`` fixture is not used.
"""
import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seamlesscloneoptimization_tpu import api as JA
from seamlesscloneoptimization_tpu.ops import edit as JE
from seamlesscloneoptimization_tpu.parallel import make_tile_mesh as jax_mesh
from seamlesscloneoptimization_tpu.parallel.clone_tiled import local_edit_tiled as jax_edit_tiled
from seamlesscloneoptimization_tpu_torch import api as TA
from seamlesscloneoptimization_tpu_torch.ops import edit as TE
from seamlesscloneoptimization_tpu_torch.ops import kernels as K
from seamlesscloneoptimization_tpu_torch.ops.canny import canny
from seamlesscloneoptimization_tpu_torch.parallel import local_edit_tiled, make_tile_mesh
from seamlesscloneoptimization_tpu_torch.solvers import multigrid as TM

# Several pytest-xdist workers share the cores: one intra-op thread each keeps
# torch's OpenMP pools from oversubscribing them. Results do not depend on it.
torch.set_num_threads(1)

KINDS = (TE.COLOR_CHANGE, TE.ILLUMINATION_CHANGE, TE.TEXTURE_FLATTENING)
PARAMS = {TE.COLOR_CHANGE: [1.2, 0.6, 1.7], TE.ILLUMINATION_CHANGE: [0.25, 0.35],
          TE.TEXTURE_FLATTENING: [0.0]}


def _dmax(a, b) -> int:
    return int(np.abs(np.asarray(a).astype(np.int64) - np.asarray(b).astype(np.int64)).max())


def _image(kind: str, hw, ch: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    h, w = hw
    if kind == "noise":
        img = rng.integers(0, 256, (h, w, ch))
    else:
        cell = 7 if kind == "blocks" else 9
        img = np.kron(rng.integers(0, 256, (h // cell + 1, w // cell + 1, ch)),
                      np.ones((cell, cell, 1)))[:h, :w]
        if kind == "noisy_blocks":
            img = img + rng.normal(0.0, 12.0, img.shape)
    img = np.clip(img, 0, 255).astype(np.uint8)
    return img[..., 0] if ch == 1 else img


def _ellipse(hw, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    h, w = hw
    cy, cx = h / 2 + rng.uniform(-3, 3), w / 2 + rng.uniform(-3, 3)
    yy, xx = np.ogrid[:h, :w]
    inside = ((yy - cy) / (h * 0.33)) ** 2 + ((xx - cx) / (w * 0.36)) ** 2 <= 1
    return inside.astype(np.uint8) * 255


def _edges(src, mask, low=30.0, high=45.0, k=3):
    masked = np.where(mask[..., None] != 0, src, 0).astype(np.uint8)
    return cv2.Canny(masked, low, high, apertureSize=k)


# ---------------------------------------------------------------------------
# ops/canny.py against cv2.Canny
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("aperture", [3, 5, 7])
@pytest.mark.parametrize("ch", [1, 3])
@pytest.mark.parametrize("kind", ["noise", "blocks", "noisy_blocks"])
def test_canny_bit_exact_to_cv2(kind, ch, aperture):
    """Thresholds spanning the magnitudes of each aperture (the 7-tap
    derivatives are scaled by 1/16, the thresholds too), fractional ones
    (floored), low > high (swapped), and both at 0."""
    img = _image(kind, (43, 61), ch, seed=aperture * 10 + ch)
    scale = {3: 1.0, 5: 8.0, 7: 30.0}[aperture]
    for low, high in ((30.0, 45.0), (45.0, 30.0), (0.0, 0.0), (0.0, 90.5),
                      (20.7 * scale, 61.3 * scale), (150.0 * scale, 40.0 * scale)):
        want = cv2.Canny(img, low, high, apertureSize=aperture)
        got = canny(img, low, high, aperture)
        assert got.dtype == np.uint8 and got.shape == img.shape[:2]
        np.testing.assert_array_equal(got, want, err_msg=f"thresholds {low}, {high}")


@pytest.mark.parametrize("hw", [(1, 1), (2, 9), (97, 130)])
def test_canny_edge_shapes_and_masked_source(hw):
    """Tiny images, and the masked 3-channel source textureFlattening feeds it."""
    src = _image("noisy_blocks", hw, 3, seed=hw[1])
    mask = _ellipse(hw, seed=hw[0])
    masked = np.where(mask[..., None] != 0, src, 0).astype(np.uint8)
    for k in (3, 5, 7):
        np.testing.assert_array_equal(canny(masked, 30, 45, k),
                                      cv2.Canny(masked, 30, 45, apertureSize=k))


def test_canny_rejects_bad_inputs():
    with pytest.raises(ValueError, match="aperture"):
        canny(np.zeros((8, 8), np.uint8), 1, 2, 4)
    with pytest.raises(ValueError, match="uint8"):
        canny(np.zeros((8, 8), np.float32), 1, 2)


# ---------------------------------------------------------------------------
# erode3x3_replicate and edit_guidance against JAX's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hw", [(1, 1), (5, 9), (40, 57)])
def test_erode3x3_replicate_bit_exact(hw):
    rng = np.random.default_rng(hw[1])
    for m in ((rng.random(hw) < 0.85).astype(np.float32), np.ones(hw, np.float32),
              (_ellipse(hw, 3) != 0).astype(np.float32)):
        want = np.asarray(JE.erode3x3_replicate(jnp.asarray(m)))
        got = TE.erode3x3_replicate(torch.from_numpy(m))
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kind", KINDS)
def test_edit_guidance_matches_jax(kind):
    """Colour change and texture flattening bit-exact; the illumination
    change's alpha^beta * |g|^-beta to relative 1e-6 of max |g| (XLA's
    pow and torch's may differ in the last ulp), zero gradients zero."""
    hw = (37, 52)
    src = _image("noisy_blocks", hw, 3, seed=7).astype(np.float32).transpose(2, 0, 1).copy()
    me = np.array(JE.erode3x3_replicate(jnp.asarray((_ellipse(hw, 1) != 0)
                                                     .astype(np.float32))))
    edge = (_edges(src.transpose(1, 2, 0).astype(np.uint8), _ellipse(hw, 1)) / 255.0
            ).astype(np.float32)
    params = np.asarray(PARAMS[kind], np.float32)
    want = JE.edit_guidance(jnp.asarray(src), jnp.asarray(me), jnp.asarray(params),
                            jnp.asarray(edge), kind=kind)
    got = TE.edit_guidance(torch.from_numpy(src), torch.from_numpy(me),
                           torch.from_numpy(params), torch.from_numpy(edge), kind=kind)
    for w_, g_ in zip(want, got):
        w_ = np.asarray(w_)
        if kind == TE.ILLUMINATION_CHANGE:
            assert np.abs(g_.numpy() - w_).max() <= 1e-6 * np.abs(w_).max()
            np.testing.assert_array_equal(g_.numpy() == 0, w_ == 0)
        else:
            np.testing.assert_array_equal(g_.numpy(), w_)
    with pytest.raises(ValueError, match="edit kind"):
        TE.edit_guidance(torch.from_numpy(src), torch.from_numpy(me),
                         torch.from_numpy(params), None, kind="blur")


# ---------------------------------------------------------------------------
# local_edit_planar against JAX's
# ---------------------------------------------------------------------------


def _planar_pair(kind, hw, seed, crossover=None):
    src = _image("noisy_blocks", hw, 3, seed=seed)
    mask = _ellipse(hw, seed)
    me = JE.erode3x3_replicate(jnp.asarray((mask != 0).astype(np.float32)))
    edge = (_edges(src, mask) / 255.0).astype(np.float32)
    params = np.asarray(PARAMS[kind], np.float32)
    src_p = np.ascontiguousarray(src.transpose(2, 0, 1))
    want = JE.local_edit_planar(jnp.asarray(src_p), me, jnp.asarray(params),
                                jnp.asarray(edge) if kind == TE.TEXTURE_FLATTENING else None,
                                kind=kind, crossover=crossover)
    got = TE.local_edit_planar(torch.from_numpy(src_p), torch.from_numpy(np.array(me)),
                               torch.from_numpy(params),
                               torch.from_numpy(edge) if kind == TE.TEXTURE_FLATTENING
                               else None, kind=kind, crossover=crossover)
    return src_p, np.asarray(want), got.numpy()


@pytest.mark.parametrize("kind", KINDS)
def test_local_edit_planar_direct_route(kind):
    """Below the crossover: the exact DST-GEMM solve; the image border
    stays the source's."""
    src_p, want, got = _planar_pair(kind, (46, 63), seed=4)
    assert got.dtype == np.uint8 and _dmax(got, want) <= 1
    np.testing.assert_array_equal(got[:, [0, -1], :], src_p[:, [0, -1], :])
    np.testing.assert_array_equal(got[:, :, [0, -1]], src_p[:, :, [0, -1]])


def test_local_edit_planar_multigrid_route():
    """The crossover forced below a 518x518 interior: the port's quarter-
    plane chain on the dense RHS (to_quarters, the "q" twins,
    from_quarters; no kernel launch on the CPU) against JAX's element path
    at the same tol 1e-5."""
    assert TM.quarter_path_applies(518, 518, use_pallas=True)
    K.reset_launches()
    _, want, got = _planar_pair(TE.COLOR_CHANGE, (520, 520), seed=5, crossover=1000)
    assert _dmax(got, want) <= 1
    assert not any(K.LAUNCHES.values())


# ---------------------------------------------------------------------------
# the api functions against JAX's and cv2's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_color_change_matches_jax_and_cv2(seed):
    hw = (40 + 7 * seed, 58)
    src, mask = _image("noise", hw, 3, seed), _ellipse(hw, seed)
    got = TA.color_change(src, mask, 1.7, 0.6, 1.2, device="cpu")
    assert got.dtype == np.uint8 and got.shape == src.shape
    assert _dmax(got, JA.color_change(src, mask, 1.7, 0.6, 1.2)) <= 1
    assert _dmax(got, cv2.colorChange(src, mask.copy(), red_mul=1.7, green_mul=0.6,
                                      blue_mul=1.2)) <= 1


@pytest.mark.parametrize("seed", [0, 3])
def test_illumination_change_matches_jax_and_cv2(seed):
    hw = (50, 60)
    src, mask = _image("noisy_blocks", hw, 3, seed), _ellipse(hw, seed)
    got = TA.illumination_change(src, mask, 0.25, 0.35, device="cpu")
    assert _dmax(got, JA.illumination_change(src, mask, 0.25, 0.35)) <= 1
    assert _dmax(got, cv2.illuminationChange(src, mask.copy(), alpha=0.25, beta=0.35)) <= 1


@pytest.mark.parametrize("k", [3, 5])
def test_texture_flattening_matches_jax_and_cv2(k):
    hw = (64, 96)
    src, mask = _image("noisy_blocks", hw, 3, seed=k), _ellipse(hw, k)
    got = TA.texture_flattening(src, mask, 30, 45, k, device="cpu")
    assert _dmax(got, JA.texture_flattening(src, mask, 30, 45, k)) <= 1
    assert _dmax(got, cv2.textureFlattening(src, mask.copy(), low_threshold=30,
                                            high_threshold=45, kernel_size=k)) <= 1


def test_edit_api_defaults_device_and_tensor_output():
    """mask=None edits everything; to_numpy=False returns the device
    tensor; without a card the default device raises."""
    src = _image("noise", (30, 41), 3, seed=9)
    got = TA.color_change(src, None, 1.5, 1.0, 0.8, to_numpy=False, device="cpu")
    assert isinstance(got, torch.Tensor) and got.shape == src.shape
    assert _dmax(got.numpy(), JA.color_change(src, None, 1.5, 1.0, 0.8)) <= 1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            TA.illumination_change(src)


# ---------------------------------------------------------------------------
# local_edit_tiled on a 2x2 CPU mesh against JAX's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", [TE.COLOR_CHANGE, TE.TEXTURE_FLATTENING])
def test_local_edit_tiled_matches_jax(kind):
    """The DD solve to tol 1e-6 over a 2x2 mesh: against JAX's local_edit_tiled
    on a 2x2 mesh and against the port's single-device color_change."""
    hw = (60, 84)
    src, mask = _image("noisy_blocks", hw, 3, seed=11), _ellipse(hw, 11)
    edge = _edges(src, mask) if kind == TE.TEXTURE_FLATTENING else None
    want = jax_edit_tiled(src, mask, kind, PARAMS[kind], edge,
                          mesh=jax_mesh(jax.devices()[:4], (2, 2)), tol=1e-6)
    mesh = make_tile_mesh([torch.device("cpu")] * 4, (2, 2))
    K.reset_launches()
    got = local_edit_tiled(src, mask, kind, PARAMS[kind], edge, mesh=mesh, tol=1e-6)
    assert not any(K.LAUNCHES.values())
    assert got.dtype == np.uint8 and got.shape == src.shape
    assert _dmax(got, want) <= 1
    if kind == TE.COLOR_CHANGE:
        assert _dmax(got, TA.color_change(src, mask, 1.7, 0.6, 1.2, device="cpu")) <= 1
