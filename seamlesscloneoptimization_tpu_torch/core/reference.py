"""Host mask helpers: the port's own copies of ``zero_mask_border`` and
``mask_bounding_box`` (``seamlesscloneoptimization_tpu/core/reference.py``).

The NumPy oracle itself stays in the JAX package, where the tests read it.
"""

from __future__ import annotations

import numpy as np


def zero_mask_border(mask: np.ndarray) -> np.ndarray:
    """Zero the 1-px frame of a mask (ref: seamlessClone_imp.cpp:967-976)."""
    out = mask.copy()
    out[0, :] = 0
    out[-1, :] = 0
    out[:, 0] = 0
    out[:, -1] = 0
    return out


def mask_bounding_box(mask: np.ndarray) -> tuple[int, int, int, int]:
    """(x0, y0, w, h) bounding box of non-zero pixels (like cv2.boundingRect)."""
    ys, xs = np.nonzero(mask)
    if ys.size == 0:
        return (0, 0, 0, 0)
    x0, x1 = int(xs.min()), int(xs.max())
    y0, y1 = int(ys.min()), int(ys.max())
    return (x0, y0, x1 - x0 + 1, y1 - y0 + 1)
