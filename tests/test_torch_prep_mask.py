"""The mask prep of ``run`` and ``timed_serve`` on the device, on the CPU.

``K.prep_mask_plain`` (the CUDA kernel ``prep_mask``'s twin) is bit-equal
to ``native.prep_mask``, mask bytes and bbox, on full, elliptic, random,
empty, border-only, single-pixel, one-row and one-column masks, every width
from 3 to 33 and inside values 1, 128 and 255. The engine's device-side
prepare (``SeamlessClone._prepare_request``) on ``device="cpu"`` gives the
ROI, bbox and mask that ``prepare_inputs`` gives, with and without a bucket
and in ``bucket_exact`` mode; the route follows the input: None and 2-D u8
masks (host arrays or tensors) through ``K.prep_mask``, 3-D and float masks
through ``native.prep_mask``; a caller's tensor is never written. The
kernel itself is held to the twin on the card (``tests/test_torch_cuda.py``).
"""

import numpy as np
import pytest
import torch

from seamlesscloneoptimization_tpu_torch import native
from seamlesscloneoptimization_tpu_torch.core import engine as TE
from seamlesscloneoptimization_tpu_torch.core.config import CloneConfig
from seamlesscloneoptimization_tpu_torch.core.engine import SeamlessClone, prepare_inputs
from seamlesscloneoptimization_tpu_torch.ops import kernels as K

# Several pytest-xdist workers share the cores: one intra-op thread each.
torch.set_num_threads(1)


def _ellipse(hw, inside=255):
    yy, xx = np.ogrid[: hw[0], : hw[1]]
    cy, cx = (hw[0] - 1) / 2, (hw[1] - 1) / 2
    e = ((yy - cy) / (0.45 * hw[0])) ** 2 + ((xx - cx) / (0.4 * hw[1])) ** 2 <= 1
    return e.astype(np.uint8) * inside


def _random(hw, p, seed, inside=None):
    rng = np.random.default_rng(seed)
    vals = rng.integers(1, 256, hw) if inside is None else np.full(hw, inside)
    return ((rng.random(hw) < p) * vals).astype(np.uint8)


def _border_only(hw):
    m = np.zeros(hw, np.uint8)
    m[0], m[-1], m[:, 0], m[:, -1] = 255, 7, 1, 128
    return m


def _one(hw, at, inside=255):
    m = np.zeros(hw, np.uint8)
    m[at] = inside
    return m


def _cases():
    cases = {
        "full": np.full((40, 57), 255, np.uint8),
        "full_1": np.full((17, 16), 1, np.uint8),
        "ellipse": _ellipse((61, 90)),
        "ellipse_128": _ellipse((33, 48), 128),
        "random_1pct": _random((70, 83), 0.01, 1),
        "random_50pct": _random((45, 64), 0.5, 2),
        "random_50pct_1": _random((29, 35), 0.5, 3, inside=1),
        "empty": np.zeros((20, 31), np.uint8),
        "border_only": _border_only((19, 30)),
        "single_pixel": _one((23, 37), (11, 20)),
        "single_pixel_corner": _one((23, 37), (1, 1), 1),
        "single_pixel_last": _one((23, 37), (21, 35), 128),
        "one_row_interior": _random((3, 41), 0.6, 4),
        "one_column_interior": _random((41, 3), 0.6, 5),
        "row_17": np.pad(np.full((1, 40), 9, np.uint8), ((17, 30), (3, 0))),
        "column_9": np.pad(np.full((30, 1), 200, np.uint8), ((2, 5), (9, 20))),
        "tiny_1x1": np.full((1, 1), 255, np.uint8),
        "tiny_2x9": np.full((2, 9), 255, np.uint8),
        "tiny_9x2": np.full((9, 2), 255, np.uint8),
    }
    for w in range(3, 34):  # widths 3-33: rows start at every offset mod 16
        cases[f"width_{w}"] = _random((13, w), 0.3, 100 + w)
    for w in (47, 100, 129, 250):  # not multiples of 16
        cases[f"width_{w}_sparse"] = _random((9, w), 0.02, 200 + w, inside=128)
    return cases


CASES = _cases()


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_equals_native(case):
    """Mask bytes and bbox equal ``native.prep_mask``'s, into a new tensor
    and in place."""
    m = CASES[case]
    want, want_bbox = native.prep_mask(m)
    got, bbox = K.prep_mask(torch.from_numpy(m.copy()))
    assert got.dtype == torch.uint8 and bbox.dtype == torch.int32
    assert np.array_equal(got.numpy(), want) and tuple(bbox.tolist()) == want_bbox
    t = torch.from_numpy(m.copy())
    got, bbox = K.prep_mask(t, out=t)
    assert got is t and np.array_equal(t.numpy(), want)
    assert tuple(bbox.tolist()) == want_bbox


def _images(seed=0, src_hw=(60, 90), dst_hw=(120, 160)):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, src_hw + (3,)).astype(np.uint8),
            rng.integers(0, 256, dst_hw + (3,)).astype(np.uint8))


def _mask(src_hw=(60, 90)):
    m = np.zeros(src_hw, np.uint8)
    m[7:41, 12:70] = 200
    m[30:55, 60:88] = 1
    return m


@pytest.mark.parametrize("cfg", [dict(), dict(bbox_bucket=16), dict(bbox_bucket=64),
                                 dict(bbox_bucket=16, bucket_exact=True)])
@pytest.mark.parametrize("center", [(80, 60), (50, 40), (45, 31)])
def test_device_prepare_equals_prepare_inputs(cfg, center):
    """The ROI, bbox (the tight one too) and prepared mask of the device
    route equal ``prepare_inputs``'s with the same bucket."""
    src, dst = _images()
    mask = _mask()
    eng = SeamlessClone(CloneConfig(**cfg), device="cpu")
    exact = eng._bucket_exact()
    want = prepare_inputs(mask, src.shape, dst.shape, center, bucket=eng.config.bbox_bucket,
                          return_tight=exact)
    got = eng._prepare_request(mask, src, dst, center)
    assert isinstance(got[0], torch.Tensor)
    assert np.array_equal(got[0].numpy(), want[0])
    assert tuple(got[1:]) == tuple(want[1:])
    assert len(got) == (5 if exact else 4)


@pytest.mark.parametrize("kind", ["numpy", "tensor"])
def test_empty_mask_on_device_route(kind):
    """An empty mask (or one nonzero only on its border): ``run`` returns the
    destination, ``timed_serve`` raises the same ValueError as before."""
    src, dst = _images(1)
    eng = SeamlessClone(CloneConfig(), device="cpu")
    for m in (np.zeros(src.shape[:2], np.uint8), _border_only(src.shape[:2])):
        mask = torch.from_numpy(m) if kind == "tensor" else m
        assert eng._prepare_request(mask, src, dst, (80, 60)) is None
        assert np.array_equal(eng.run(src, dst, mask, (80, 60)).numpy(), dst)
        with pytest.raises(ValueError, match="empty mask"):
            eng.timed_serve(src, dst, mask, (80, 60), loops=1)


def test_device_route_errors_match_prepare_inputs():
    src, dst = _images(2)
    eng = SeamlessClone(CloneConfig(), device="cpu")
    with pytest.raises(ValueError, match="mask shape"):
        eng._prepare_request(np.full((5, 5), 255, np.uint8), src, dst, (80, 60))
    with pytest.raises(ValueError, match="outside destination"):
        eng._prepare_request(np.full(src.shape[:2], 255, np.uint8), src, dst, (10, 10))


@pytest.fixture
def routes(monkeypatch):
    """Counts of the two routes' calls: ``native.prep_mask`` (the host's) and
    ``K.prep_mask`` (the device's)."""
    calls = {"host": 0, "device": 0}
    host, device = native.prep_mask, K.prep_mask

    def count(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(native, "prep_mask", count("host", host))
    monkeypatch.setattr(K, "prep_mask", count("device", device))
    return calls


@pytest.mark.parametrize("call", ["run", "timed_serve"])
@pytest.mark.parametrize("kind", ["none", "u8_2d", "u8_tensor", "u8_3d", "f32_2d", "bool_2d"])
def test_route_follows_the_input(routes, call, kind):
    """None and 2-D u8 masks (host array or tensor) take ``K.prep_mask``;
    3-D, float and bool masks ``native.prep_mask`` on the host. Every route
    gives the output of the host route on the equivalent u8 mask."""
    src, dst = _images(3)
    full = kind == "none"
    base = np.full(src.shape[:2], 255, np.uint8) if full else _mask()
    mask = {"none": None, "u8_2d": base, "u8_tensor": torch.from_numpy(base.copy()),
            "u8_3d": np.repeat(base[..., None], 3, axis=2),
            "f32_2d": base.astype(np.float32) * 0.5 / 255, "bool_2d": base != 0}[kind]
    eng = SeamlessClone(CloneConfig(), device="cpu")
    on_device = kind in ("none", "u8_2d", "u8_tensor")
    assert eng._preps_on_device(mask) is on_device

    def clone(e, m):
        if call == "run":
            return e.run(src, dst, m, (80, 60)).numpy()
        return e.timed_serve(src, dst, m, (80, 60), loops=1)[0].numpy()

    got = clone(eng, mask)
    assert routes == {"host": 0 if on_device else 1, "device": 1 if on_device else 0}
    want = clone(SeamlessClone(CloneConfig(), device="cpu"), np.ascontiguousarray(
        prepare_inputs(base, src.shape, dst.shape, (80, 60))[0]))
    assert np.array_equal(got, want)


def test_callers_tensor_left_unmodified():
    """A tensor mask with values other than 255 and a nonzero border comes
    back as it went in; the engine's prepared mask is its own tensor."""
    src, dst = _images(4)
    m = _mask()
    m[0, :], m[:, -1] = 3, 77
    mask = torch.from_numpy(m.copy())
    eng = SeamlessClone(CloneConfig(), device="cpu")
    prep = eng._prepare_request(mask, src, dst, (80, 60))
    assert prep[0].data_ptr() != mask.data_ptr()
    eng.run(src, dst, mask, (80, 60))
    eng.timed_serve(src, dst, mask, (80, 60), loops=1)
    assert np.array_equal(mask.numpy(), m)


@pytest.fixture
def prep_calls(monkeypatch):
    """Each ``K.prep_mask`` call's (input, out) as the engine passes them."""
    calls = []
    real = K.prep_mask

    def spy(mask, out=None):
        calls.append((mask, out))
        return real(mask, out)

    monkeypatch.setattr(K, "prep_mask", spy)
    return calls


@pytest.mark.parametrize("kind", ["numpy", "cpu_tensor", "cpu_tensor_strided", "none"])
def test_mask_is_copied_unless_on_the_engines_device(prep_calls, kind):
    """A tensor on the engine's device is read where it lies (a strided one
    through a contiguous copy), with the kernel writing a tensor of its own;
    anything else (a host array, None, a tensor on another device) becomes
    the engine's own copy on its device, prepared in place. The ROI and
    mask equal ``prepare_inputs``'s every way."""
    src, dst = _images(8)
    m = _mask()
    mask = {"numpy": m.copy(), "cpu_tensor": torch.from_numpy(m.copy()),
            "cpu_tensor_strided": torch.from_numpy(np.ascontiguousarray(m.T)).T,
            "none": None}[kind]
    eng = SeamlessClone(CloneConfig(), device="cpu")
    assert eng._concrete_device() == torch.device("cpu")
    prep = eng._prepare_request(mask, src, dst, (80, 60))
    (given, out), = prep_calls
    if kind == "cpu_tensor":
        assert given is mask and out is None
    elif kind == "cpu_tensor_strided":
        assert given.data_ptr() != mask.data_ptr() and out is None
    else:
        assert out is given
    base = np.full(m.shape, 255, np.uint8) if mask is None else m
    want = prepare_inputs(base, src.shape, dst.shape, (80, 60))
    assert np.array_equal(prep[0].numpy(), want[0]) and prep[1:] == want[1:]
    if mask is not None:
        assert np.array_equal(np.asarray(mask), m)


def test_host_array_left_unmodified():
    src, dst = _images(5)
    m = _mask()
    m[-1, :] = 5
    mask = m.copy()
    SeamlessClone(CloneConfig(), device="cpu").run(src, dst, mask, (80, 60))
    assert np.array_equal(mask, m)


def test_no_cache_between_requests():
    """Each request preps its own mask: a second request with another mask in
    the same engine (same shape, same object) gets its own bbox."""
    src, dst = _images(6)
    eng = SeamlessClone(CloneConfig(), device="cpu")
    mask = _mask()
    eng.run(src, dst, mask, (80, 60))
    first = eng.metrics["bbox"]
    mask[:] = 0
    mask[20:30, 30:50] = 255
    eng.run(src, dst, mask, (80, 60))
    assert first == (12, 7, 76, 48) and eng.metrics["bbox"] == (30, 20, 20, 10)


def test_place_roi_is_prepare_inputs_placement():
    """``prepare_inputs`` is ``native.prep_mask`` then ``place_roi``."""
    src_shape, dst_shape = (60, 90, 3), (120, 160, 3)
    m = _mask()
    _, bbox = native.prep_mask(m)
    for bucket, tight in ((0, False), (16, True), (64, False)):
        want = prepare_inputs(m, src_shape, dst_shape, (50, 40), bucket, tight)
        assert TE.place_roi(bbox, src_shape, dst_shape, (50, 40), bucket, tight) == want[1:]
    assert TE.place_roi((0, 0, 0, 0), src_shape, dst_shape, (50, 40)) is None
