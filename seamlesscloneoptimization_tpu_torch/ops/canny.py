"""Canny edge detection on the host, equal to ``cv2.Canny`` bit for bit.

``texture_flattening`` keeps the guidance gradients at the Canny edges of
the masked source. The JAX package takes them from ``cv2.Canny``; the port
has its own (the card's machine has no cv2), in numpy with the hysteresis
on ``scipy.ndimage.label``. It reproduces ``cv2.Canny(img, low, high,
apertureSize=k)`` with ``L2gradient=False`` for 1- and 3-channel u8
images and k in {3, 5, 7}:

- the Sobel derivatives of each channel in integers, replicate border; for
  k = 7 scaled by 1/16 and rounded to nearest, ties to even, with the
  thresholds divided by 16 as well;
- the L1 magnitude |dx| + |dy|; on several channels each pixel takes the
  channel of largest magnitude, the first on a tie;
- the thresholds swapped when low > high, then floored;
- non-maximum suppression with cv2's integer tangent test
  (tan 22.5 deg * 2^15 = 13573) and its asymmetric comparisons (strict on
  one side, >= on the other), magnitude 0 outside the image;
- hysteresis: a local maximum above ``low`` is an edge when its
  8-connected component of such maxima holds one above ``high``.

Returns an (H, W) u8 map of 0 and 255.
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage

# cv2.getDerivKernels(1, 0, k): the derivative and the smoothing taps
_DERIV = {3: (-1, 0, 1), 5: (-1, -2, 0, 2, 1), 7: (-1, -4, -5, 0, 5, 4, 1)}
_SMOOTH = {3: (1, 2, 1), 5: (1, 4, 6, 4, 1), 7: (1, 6, 15, 20, 15, 6, 1)}
_TG22 = 13573  # tan(22.5 deg) * 2^15, rounded
_SHIFT = 15


def _correlate(x: np.ndarray, taps, axis: int) -> np.ndarray:
    """1-D correlation along ``axis`` (0 or 1) with a replicate border, in
    int32 (a 7-tap Sobel of u8 stays under 2^18)."""
    r = len(taps) // 2
    pad = [(0, 0)] * x.ndim
    pad[axis] = (r, r)
    xp = np.pad(x, pad, mode="edge")
    n = x.shape[axis]
    out = np.zeros(x.shape, np.int32)
    for i, t in enumerate(taps):
        if t:
            out += t * (xp[i : i + n] if axis == 0 else xp[:, i : i + n])
    return out


def _sobel(img: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """(dx, dy) of an (H, W, C) image, as cv2.Canny's 16-bit Sobel gives them."""
    x = img.astype(np.int32)
    dx = _correlate(_correlate(x, _DERIV[k], 1), _SMOOTH[k], 0)
    dy = _correlate(_correlate(x, _SMOOTH[k], 1), _DERIV[k], 0)
    if k == 7:  # cv2 scales the 7-tap derivatives by 1/16 to fit 16 bits
        dx = np.rint(dx / 16.0).astype(np.int32)
        dy = np.rint(dy / 16.0).astype(np.int32)
    return dx, dy


def canny(img_u8, low: float, high: float, aperture_size: int = 3) -> np.ndarray:
    """Edge map of a (H, W) or (H, W, C) u8 image: ``cv2.Canny(img_u8, low,
    high, apertureSize=aperture_size)`` with the L1 gradient."""
    img = np.asarray(img_u8)
    if img.dtype != np.uint8 or img.ndim not in (2, 3):
        raise ValueError(f"canny takes a 2-D or 3-D uint8 image, got {img.dtype} {img.shape}")
    if aperture_size not in _DERIV:
        raise ValueError(f"aperture_size must be 3, 5 or 7, got {aperture_size}")
    if img.ndim == 2:
        img = img[..., None]
    low, high = float(low), float(high)
    if low > high:
        low, high = high, low
    if aperture_size == 7:
        low, high = low / 16.0, high / 16.0
    lo, hi = int(np.floor(low)), int(np.floor(high))

    dx, dy = _sobel(img, aperture_size)
    mag = np.abs(dx) + np.abs(dy)
    best = np.argmax(mag, axis=2)[..., None]  # the first channel on a tie
    dx = np.take_along_axis(dx, best, 2)[..., 0]
    dy = np.take_along_axis(dy, best, 2)[..., 0]
    mag = np.take_along_axis(mag, best, 2)[..., 0]

    h, w = mag.shape
    mp = np.pad(mag, 1)

    def at(di: int, dj: int) -> np.ndarray:
        return mp[1 + di : 1 + di + h, 1 + dj : 1 + dj + w]

    ax = np.abs(dx).astype(np.int64)  # the tangent products in int64
    ay = np.abs(dy).astype(np.int64) << _SHIFT
    tg22 = ax * _TG22
    tg67 = tg22 + (ax << (_SHIFT + 1))
    horizontal = ay < tg22
    vertical = ~horizontal & (ay > tg67)
    diagonal = ~(horizontal | vertical)
    opposite = (dx ^ dy) < 0  # cv2's s = -1: the anti-diagonal
    peak = horizontal & (mag > at(0, -1)) & (mag >= at(0, 1))
    peak |= vertical & (mag > at(-1, 0)) & (mag >= at(1, 0))
    peak |= diagonal & np.where(opposite, (mag > at(-1, 1)) & (mag > at(1, -1)),
                                (mag > at(-1, -1)) & (mag > at(1, 1)))
    weak = peak & (mag > lo)
    strong = weak & (mag > hi)
    labels, n = ndimage.label(weak, structure=np.ones((3, 3), bool))
    keep = np.zeros(n + 1, bool)
    keep[labels[strong]] = True
    keep[0] = False
    return keep[labels].astype(np.uint8) * np.uint8(255)
