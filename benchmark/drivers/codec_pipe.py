"""Offline batch compression: `CGICCodec.roundtrip_pipelined` over batches
of pool images, called back to back by one client (closed loop).

Traffic: `batch` images a batch, `batches_per_call` batches a call; device
packing, uint8 reconstructions, the threaded host stages and the host
receiver, as offline batch compression runs.
A request is one call; its images count when their reconstructions are in
host memory, which is when the call returns.
"""
from __future__ import annotations

import time

import numpy as np

from common.codec_cell import CodecCell


class Driver(CodecCell):

    def __init__(self, cell):
        super().__init__(cell)
        self.items_per_request = self.t["batch"] * self.t["batches_per_call"]
        self.stats = []

    def request(self, keep: bool = True) -> None:
        t = self.t
        idx = self.next_images(self.items_per_request)
        batches = [self.pool[idx[i:i + t["batch"]]]
                   for i in range(0, len(idx), t["batch"])]
        recs, encs = self.codec.roundtrip_pipelined(
            batches, *self.ratios, device_pack=True, out_uint8=True,
            threads=True)
        if not keep:
            return
        self.stats.append(dict(self.codec.last_pipeline_stats))
        for b, (rec, enc) in enumerate(zip(recs, encs)):
            for j, e in enumerate(enc):
                i = idx[b * t["batch"] + j]
                self.keep(i, [{"image": self.pool[i], "streams": e.streams,
                               "mode": e.mode, "bpp": e.bpp,
                               "rec": rec[j]}])

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
        return dict(self.layer_common(), pipeline=self.stats,
                    flops_per_item=flops.codec_flops(m, h, w),
                    flash_fwd=flops.flash_attentions(m, h, w),
                    dtype=m["dtype"])
