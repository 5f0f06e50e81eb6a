"""Inputs made from the seed: test images and a skewed codebook table.

`make_images` follows `make_image` of chip_smoke.py (flat 32-px cells,
a smooth ramp, noise on the busy cells, so that the router sees a spread of
patch entropies), made on the device for a whole pool at once, with cells
over the ceiling of the size and cut to it. `skewed_counts` is a copy of
chip_smoke.py's (phase 13's table at skew 20: codes of 7 to 19 bits, as a
trained codebook's usage is skewed).
"""
from __future__ import annotations

import math

import numpy as np
import torch


def make_images(n: int, h: int, w: int, gen: torch.Generator,
                device) -> torch.Tensor:
    """n distinct images [n, h, w, 3] uint8 on `device` (clipped to [0, 1],
    times 255, truncated)."""
    ch, cw = math.ceil(h / 32), math.ceil(w / 32)
    rand = lambda *s: torch.rand(s, generator=gen, device=device)
    cells = lambda t: t.repeat_interleave(32, 1).repeat_interleave(
        32, 2)[:, :h, :w]
    flat = cells(rand(n, ch, cw, 3))
    busy = cells(rand(n, ch, cw, 1))
    a, b = 0.5 + 1.5 * rand(2, n, 1, 1)
    yy = torch.arange(h, device=device)[None, :, None] / max(h, w)
    xx = torch.arange(w, device=device)[None, None, :] / max(h, w)
    ramp = (0.3 * torch.sin(2 * math.pi * (a * xx + b * yy)))[..., None]
    noise = 0.2 * torch.randn((n, h, w, 3), generator=gen, device=device)
    img = torch.clamp(0.6 * flat + ramp + noise * (busy > 0.5), 0.0, 1.0)
    return (img * 255).to(torch.uint8)


def skewed_counts(n: int, skew: float, seed: int) -> np.ndarray:
    """Poisson counts around 100 whose means spread over skew^[-1, 1]."""
    rng = np.random.default_rng(seed)
    return np.maximum(rng.poisson(100 * skew ** rng.uniform(-1, 1, n), n), 1)
