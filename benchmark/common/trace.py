"""Reading the device trace of a traced window (torch.profiler, CUPTI).

Busy time is the union of the device's operation intervals, as
chip_smoke.py's `device_profile` takes it (a user annotation spans its
kernels and the host gaps between them: not device work). The breakdown
names the device operations that took the most time and the longest idle
gaps, each by the host event that covered it most closely (the shortest
host event that overlaps the gap most).
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional, Tuple

import torch

TOP = 10


class Trace:
    """The profile of one window; `window_s` is the host clock's length of
    it, from a synchronise before to a synchronise after."""

    def __init__(self):
        self.prof = None
        self.window_s = 0.0
        self.device: List[Tuple[float, float, str]] = []   # µs, µs, name
        self.host: List[Tuple[float, float, str]] = []

    @contextlib.contextmanager
    def record(self):
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            yield self
            torch.cuda.synchronize()
            self.window_s = time.perf_counter() - t0
        self.prof = prof
        self._read()

    def _read(self) -> None:
        from torch.autograd import DeviceType
        for e in self.prof.events():
            span = (e.time_range.start, e.time_range.end, e.name)
            if e.device_type == DeviceType.CUDA:
                if not getattr(e, "is_user_annotation", False):
                    self.device.append(span)
            else:
                self.host.append(span)
        self.device.sort()

    @property
    def busy_s(self) -> Optional[float]:
        """The union of the device intervals, in seconds; None when the
        profiler saw no device operation."""
        if not self.device:
            return None
        busy, end = 0.0, float("-inf")
        for a, b, _ in self.device:
            if b > end:
                busy += b - max(a, end)
                end = b
        return busy * 1e-6

    def by_name(self) -> Dict[str, float]:
        """Device seconds by operation name."""
        out: Dict[str, float] = {}
        for a, b, name in self.device:
            out[name] = out.get(name, 0.0) + (b - a) * 1e-6
        return out

    def gaps(self) -> List[Tuple[float, float]]:
        """The idle intervals between device operations (µs)."""
        out, end = [], None
        for a, b, _ in self.device:
            if end is not None and a > end:
                out.append((end, a))
            end = b if end is None else max(end, b)
        return out

    def _host_at(self, a: float, b: float) -> str:
        best, key = "no host event", None
        for s, e, name in self.host:
            ov = min(b, e) - max(a, s)
            if ov <= 0:
                continue
            k = (ov, -(e - s))
            if key is None or k > key:
                best, key = name, k
        return best

    def breakdown(self) -> dict:
        ops = sorted(self.by_name().items(), key=lambda kv: -kv[1])[:TOP]
        gaps = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:TOP]
        return {"device_ops": [[n[:120], s] for n, s in ops],
                "idle_gaps": [[self._host_at(a, b)[:120], (b - a) * 1e-6]
                              for a, b in gaps]}


def seconds_matching(by_name: Dict[str, float], pattern: str) -> float:
    return sum(v for k, v in by_name.items() if pattern in k)
