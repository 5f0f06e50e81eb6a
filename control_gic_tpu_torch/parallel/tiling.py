"""High-resolution tiled codec: pad -> tile -> batched per-tile codec ->
stitch (port of control_gic_tpu/parallel/tiling.py: `compress_tiled` and its
grid and window helpers).

  - center zero-pad to a /16-divisible size (`compute_padding`);
  - a non-overlapping grid of `tile`-px tiles plus remainder tiles
    (`tile_grid`), or with overlap > 0 equal-size tiles at stride
    tile - overlap, blended with the reference's Gaussian window
    (`overlapping_tile_grid`, `gaussian_tile_weights`);
  - every tile compressed independently; tiles of one shape go through
    `CGICCodec.encode_batch` / `decode_batch` as one batch, whose per-sample
    routing keeps each tile's streams equal to a solo encode;
  - bpp = the bits of all tiles / the original (unpadded) pixel count.
Not ported yet: JAX's `compress_tiled_device` (the threaded pipeline with
device packing) and `compress_tiled_many`, and the mesh and device-pack
options of `compress_tiled`.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..codec import CGICCodec, EncodedImage


def compute_padding(h: int, w: int, min_div: int = 16
                    ) -> Tuple[Tuple[int, int, int, int],
                               Tuple[int, int, int, int]]:
    """(left, right, top, bottom) center padding to /min_div, + unpad."""
    out_h = (h + min_div - 1) // min_div * min_div
    out_w = (w + min_div - 1) // min_div * min_div
    left = (out_w - w) // 2
    right = out_w - w - left
    top = (out_h - h) // 2
    bottom = out_h - h - top
    return (left, right, top, bottom), (-left, -right, -top, -bottom)


def tile_grid(h: int, w: int, tile: int) -> List[Tuple[int, int, int, int]]:
    """(y, x, th, tw) of `tile`-px tiles plus remainder tiles covering
    [h, w], row-major (the reference's grid)."""
    return [(y, x, min(tile, h - y), min(tile, w - x))
            for y in range(0, h, tile) for x in range(0, w, tile)]


def overlapping_tile_grid(h: int, w: int, tile: int, overlap: int
                          ) -> List[Tuple[int, int, int, int]]:
    """Equal-size tiles at stride tile - overlap, the last one snapped to
    the border; one tile along a dim no larger than `tile`."""
    def starts(dim):
        if dim <= tile:
            return [0]
        s = list(range(0, dim - tile + 1, tile - overlap))
        if s[-1] != dim - tile:
            s.append(dim - tile)
        return s

    return [(y, x, min(tile, h - y), min(tile, w - x))
            for y in starts(h) for x in starts(w)]


def gaussian_tile_weights(th: int, tw: int) -> np.ndarray:
    """Per-pixel blending weights of an overlapped tile (the reference's
    _gaussian_weights: variance 0.01 over the relative position), [th, tw]
    float32."""
    var = 0.01
    mid_w = (tw - 1) / 2
    xp = np.exp(-((np.arange(tw) - mid_w) ** 2) / (tw * tw) / (2 * var)) \
        / np.sqrt(2 * np.pi * var)
    mid_h = th / 2
    yp = np.exp(-((np.arange(th) - mid_h) ** 2) / (th * th) / (2 * var)) \
        / np.sqrt(2 * np.pi * var)
    return np.outer(yp, xp).astype(np.float32)


def compress_tiled(codec: CGICCodec, image: np.ndarray, coarse_ratio: float,
                   medium_ratio: float, tile: int = 768, overlap: int = 0
                   ) -> Tuple[np.ndarray, float, List[EncodedImage]]:
    """Compress an image of any size as independent tiles.

    image: [H, W, 3] in [0, 1]. overlap 0 is the reference's
    non-overlapping grid; a multiple of 16 above 0 overlaps the tiles and
    blends them with the Gaussian window (seams gone, more bits).

    Returns (reconstruction [H, W, 3] float32, bpp over the original pixels,
    the tiles' bundles in grid order).
    """
    if overlap % 16 or not 0 <= overlap < tile:
        raise ValueError(f"overlap must be a multiple of 16 in [0, {tile}), "
                         f"got {overlap}")
    h0, w0, _ = image.shape
    (pl, pr, pt, pb), _ = compute_padding(h0, w0)
    padded = np.pad(image, ((pt, pb), (pl, pr), (0, 0)))
    h, w, _ = padded.shape

    tiles = (tile_grid(h, w, tile) if overlap == 0
             else overlapping_tile_grid(h, w, tile, overlap))
    # group by shape so each group runs as one batch; every tile is /16,
    # as h, w are and tile boundaries fall on multiples of 16
    groups: Dict[Tuple[int, int], List[int]] = defaultdict(list)
    for i, (_, _, th, tw) in enumerate(tiles):
        groups[(th, tw)].append(i)

    recon = np.zeros(padded.shape, np.float32)
    weight = np.zeros(padded.shape[:2] + (1,), np.float32)
    bundles: List[Optional[EncodedImage]] = [None] * len(tiles)
    total_bits = 0.0
    for (th, tw), idxs in groups.items():
        batch = np.stack([padded[tiles[i][0]:tiles[i][0] + th,
                                 tiles[i][1]:tiles[i][1] + tw] for i in idxs])
        encs = codec.encode_batch(batch, coarse_ratio, medium_ratio)
        recs = codec.decode_batch(encs)
        wt = (gaussian_tile_weights(th, tw)[..., None] if overlap
              else np.ones((th, tw, 1), np.float32))
        for j, i in enumerate(idxs):
            y, x, _, _ = tiles[i]
            recon[y:y + th, x:x + tw] += recs[j] * wt
            weight[y:y + th, x:x + tw] += wt
            bundles[i] = encs[j]
            total_bits += encs[j].num_bytes * 8

    recon = recon / np.maximum(weight, 1e-12)
    recon = recon[pt:h - pb if pb else h, pl:w - pr if pr else w]
    return recon, total_bits / (h0 * w0), bundles
