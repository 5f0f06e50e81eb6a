"""One user compressing one photo at a time: `CGICCodec.compress` with the
stream files written to a directory under the run's TMPDIR and read back,
the host receiver, one client (closed loop), a distinct pool image each
request. A request's latency is from the call to the reconstruction in
host memory.
"""
from __future__ import annotations

import os
import shutil
import tempfile
import time

import numpy as np

from common import harness
from common.codec_cell import CodecCell


class Driver(CodecCell):

    def __init__(self, cell):
        super().__init__(cell)
        self.latency = []
        self.host_s = []
        self.out_dir = tempfile.mkdtemp(prefix="cgic-streams-")

    def request(self, keep: bool = True) -> None:
        i = self.next_images(1)[0]
        st = {}
        t0 = time.perf_counter()
        rec, bpp, enc = self.codec.compress(
            self.pool[i], *self.ratios,
            out_dir=self.out_dir, stats=st)
        dt = time.perf_counter() - t0
        if not keep:
            return
        self.latency.append(dt)
        self.host_s.append(st.get("entropy_s", 0.0) + st.get("files_s", 0.0)
                           + st.get("rebuild_s", 0.0))
        self.keep(i, [{"image": self.pool[i], "streams": enc.streams,
                       "mode": enc.mode, "bpp": bpp, "rec": rec}])

    def reset_window(self) -> None:
        super().reset_window()
        self.latency, self.host_s = [], []

    def end_to_end(self, window_s: float) -> dict:
        return {"codec_ms_p95": 1e3 * harness.quantile(self.latency, 0.95)}

    def layer_data(self) -> dict:
        return dict(self.layer_common(), host_s=self.host_s)

    def release(self) -> None:
        super().release()
        shutil.rmtree(self.out_dir, ignore_errors=True)
