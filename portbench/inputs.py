"""Seeded inputs: the pool of (source, destination) pairs, made on the
device from the seed in a few large calls, and the host masks.

``synthetic_image`` follows ``chip_smoke.py:synthetic_image`` (a smooth
random colour field, one value per ``cell`` x ``cell`` block, plus
Gaussian noise of sigma 6), drawn with a ``torch.Generator`` on the device
instead of numpy on the host; ``ellipse_mask`` is ``chip_smoke.py``'s.
"""

from __future__ import annotations

import numpy as np
import torch

MASK64 = (1 << 64) - 1


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A device generator for one use of the seed (``stream`` keeps the uses
    apart)."""
    mixed = np.random.SeedSequence([seed & MASK64, stream]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(mixed))


def synthetic_image(gen: torch.Generator, hw, device, cell: int = 48) -> torch.Tensor:
    """(H, W, 3) u8 on ``device``: a smooth random colour field plus noise."""
    h, w = hw
    coarse = torch.randint(0, 256, (h // cell + 2, w // cell + 2, 3), generator=gen,
                           device=device).to(torch.float32)
    img = coarse.repeat_interleave(cell, 0).repeat_interleave(cell, 1)[:h, :w]
    img = img + 6.0 * torch.randn((h, w, 3), generator=gen, device=device)
    return img.clamp_(0, 255).to(torch.uint8)


def make_pool(seed: int, n: int, src_hw, dst_hw, device) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """``n`` seeded (src, dst) pairs resident on ``device``."""
    gen = generator(seed, 1, device)
    return [(synthetic_image(gen, src_hw, device), synthetic_image(gen, dst_hw, device))
            for _ in range(n)]


def full_mask(hw) -> np.ndarray:
    return np.full(tuple(hw), 255, np.uint8)


def ellipse_mask(rng: np.random.Generator, hw, bbox_hw, jitter: int = 8) -> np.ndarray:
    """A u8 {0,255} ellipse mask whose bbox is exactly ``bbox_hw``, placed up
    to ``jitter`` pixels (drawn from ``rng``) off the image's centre."""
    bh, bw = bbox_hw
    y0 = (hw[0] - bh) // 2 + int(rng.integers(-jitter, jitter + 1))
    x0 = (hw[1] - bw) // 2 + int(rng.integers(-jitter, jitter + 1))
    cy, cx = y0 + (bh - 1) / 2, x0 + (bw - 1) / 2
    yy, xx = np.ogrid[: hw[0], : hw[1]]
    inside = ((yy - cy) / (bh / 2)) ** 2 + ((xx - cx) / (bw / 2)) ** 2 <= 1
    return inside.astype(np.uint8) * 255


def make_mask(spec, src_hw, seed: int) -> np.ndarray:
    """The traffic's host mask: ``"full"``, or ``{"kind": "ellipse",
    "jitter": j}`` with the full mask's bbox (the source less its 1-px
    frame), so the solve keeps the full mask's shape."""
    if spec == "full":
        return full_mask(src_hw)
    if isinstance(spec, dict) and spec.get("kind") == "ellipse":
        rng = np.random.default_rng([seed & MASK64, 2])
        bbox = (src_hw[0] - 2, src_hw[1] - 2)
        return ellipse_mask(rng, src_hw, bbox, int(spec.get("jitter", 0)))
    raise ValueError(f"unknown mask spec {spec!r}")
