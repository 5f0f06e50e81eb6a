"""DIV2K-class photos through the high-resolution path:
`compress_tiled_device` (tiles of `tile` px sliced, encoded, packed,
decoded and stitched on the device, the host entropy stage overlapped by
threads) on `images_per_call` pool images a call, back to back (closed
loop). An image counts when its stitched reconstruction is in host memory.
Each tile is an image of its own to the codec, so the comparison takes the
tiles of the kept images one by one, and checks each image's bpp against
its tiles' stream bytes.
"""
from __future__ import annotations

import numpy as np

from common.codec_cell import CodecCell


def tile_grid(h: int, w: int, tile: int):
    """(y, x, th, tw) of `tile`-px tiles and the remainders, row-major."""
    return [(y, x, min(tile, h - y), min(tile, w - x))
            for y in range(0, h, tile) for x in range(0, w, tile)]


class Driver(CodecCell):

    def __init__(self, cell):
        super().__init__(cell)
        self.items_per_request = self.t["images_per_call"]
        self.stats = []

    def make_pool(self) -> np.ndarray:
        """The pool cropped about its centre to a multiple of 16 px, as the
        tiled CLI crops its input."""
        imgs = super().make_pool()
        h, w = imgs.shape[1:3]
        ch, cw = h // 16 * 16, w // 16 * 16
        top, left = round((h - ch) / 2), round((w - cw) / 2)
        return np.ascontiguousarray(imgs[:, top:top + ch, left:left + cw])

    def request(self, keep: bool = True) -> None:
        from control_gic_tpu_torch.parallel.tiling import \
            compress_tiled_device
        t = self.t
        idx = self.next_images(self.items_per_request)
        out = compress_tiled_device(self.codec, [self.pool[i] for i in idx],
                                    *self.ratios, tile=t["tile"],
                                    out_uint8=True, threads=True)
        if not keep:
            return
        self.stats.append(dict(self.codec.last_pipeline_stats))
        for i, (rec, bpp, bundles) in zip(idx, out):
            img = self.pool[i]
            h, w = img.shape[:2]
            units = []
            for (y, x, th, tw), e in zip(tile_grid(h, w, t["tile"]), bundles):
                units.append({"image": img[y:y + th, x:x + tw],
                              "streams": e.streams, "mode": e.mode,
                              "bpp": e.bpp, "rec": rec[y:y + th, x:x + tw]})
            bits = sum(8 * len(s) for u in units
                       for s in u["streams"].values())
            units[0]["image_bpp_error"] = bpp != bits / (h * w)
            self.keep(i, units)

    def reset_window(self) -> None:
        super().reset_window()
        self.stats = []

    def end_to_end(self, window_s: float) -> dict:
        h, w = self.pool.shape[1:3]
        return {"codec_mpix_s": self.n_items * h * w / 1e6 / window_s}

    def layer_data(self) -> dict:
        from common import flops
        h, w = self.pool.shape[1:3]
        m = self.cell.config["model"]
        attn, work = [], 0.0
        for _, _, th, tw in tile_grid(h, w, self.t["tile"]):
            work += flops.codec_flops(m, th, tw)
            attn += flops.flash_attentions(m, th, tw)
        return dict(self.layer_common(), pipeline=self.stats,
                    flops_per_item=work, flash_fwd=attn, dtype=m["dtype"])
