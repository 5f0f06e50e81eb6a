"""Partition-map drawing in numpy (port of control_gic_tpu/utils/draw.py).

Given images [B, H, W, 3] and the fine-grid partition indices [B, Hl, Wl]
(0 coarse, 1 medium, 2 fine), `draw_partition_map` paints cell borders at
`line_value`: the coarse 4x4-cell grid everywhere, medium borders where the
2x2 block's top-left fine index is 1, fine borders where the index is 2.
`draw_partition_map_color` blends a coarse-to-fine colour map over the
min-max-normalised image.
"""
from __future__ import annotations

import numpy as np

# named blend colours (the reference's draw.py)
COLOR_DICT = {
    "red": (255, 0, 0),
    "green": (0, 255, 0),
    "white": (255, 255, 255),
    "yellow": (255, 255, 0),
    "blue": (5, 39, 175),
}


def draw_partition_map(images: np.ndarray, indices: np.ndarray,
                       line_value: float = -1.0) -> np.ndarray:
    images = np.array(images, copy=True)
    b, h, w, _ = images.shape
    _, hl, wl = indices.shape
    sh, sw = h // hl, w // wl      # pixels per fine cell

    for bi in range(b):
        # coarse grid: every 4 fine cells
        images[bi, np.arange(0, hl // 4) * sh * 4, :, :] = line_value
        images[bi, :, np.arange(0, wl // 4) * sw * 4, :] = line_value
        # medium borders where the 2x2 block's top-left fine index is 1
        for i, j in zip(*np.nonzero(indices[bi, ::2, ::2] == 1)):
            y0, x0 = i * 2 * sh, j * 2 * sw
            images[bi, y0, x0:x0 + 2 * sw, :] = line_value
            images[bi, y0:y0 + 2 * sh, x0, :] = line_value
        # fine borders where the index is 2
        for i, j in zip(*np.nonzero(indices[bi] == 2)):
            y0, x0 = i * sh, j * sw
            images[bi, y0, x0:x0 + sw, :] = line_value
            images[bi, y0:y0 + sh, x0, :] = line_value
    return images


def _minmax_normalize(img: np.ndarray) -> np.ndarray:
    """Per-image min-max normalisation to [0, 1] (torchvision's
    save_image(normalize=True) rule)."""
    lo, hi = float(img.min()), float(img.max())
    return np.clip((img - lo) / max(hi - lo, 1e-5), 0.0, 1.0)


def draw_partition_map_color(images: np.ndarray, indices: np.ndarray,
                             low_color: str = "blue",
                             high_color: str = "red",
                             scaler: float = 0.9) -> np.ndarray:
    """out = (1 − scaler)·minmax(image) + scaler·colormap, the colour map
    linear in index/2 from low_color (coarse) to high_color (fine), cast
    through uint8 and nearest-upsampled per axis. images [B, H, W, 3] in any
    range, indices [B, hl, wl]; returns float32 [B, H, W, 3] in [0, 1]."""
    b, h, w, _ = images.shape
    _, hl, wl = indices.shape
    low = np.asarray(COLOR_DICT[low_color], np.float32)
    high = np.asarray(COLOR_DICT[high_color], np.float32)
    s = (indices.astype(np.float32) / 2.0)[..., None]
    cmap = np.floor(high * s + low * (1.0 - s)).astype(np.float32) / 255.0
    cmap = cmap.repeat(h // hl, axis=1).repeat(w // wl, axis=2)
    out = np.empty((b, h, w, 3), np.float32)
    for bi in range(b):
        out[bi] = ((1.0 - scaler) * _minmax_normalize(images[bi])
                   + scaler * cmap[bi])
    return out
