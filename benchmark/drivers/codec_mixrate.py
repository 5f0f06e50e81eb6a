"""Offline batch compression at many bitrates with one model: kodak-pipe's
calls (drivers/codec_pipe.py), each at the operating point its caller
chose from the traffic's `points`, (coarse, medium) pairs with fine =
1 - coarse - medium, in modes 0-3. A call runs at one point.

The calls walk through a permutation of the points drawn from the seed,
and a new one for each round, so that any window holds every point within
one call of each other point. Set-up serves every point twice, with
`warm_up_batches` batches a call: the first call captures the point's
encode + pack program (keyed by the ratios themselves) and, where its mode
is new, the mode's decode program; the second replays them. So the window
replays only.

Each unit kept carries its point's ratios, at which the comparison routes
the reference; the comparison takes `check_per_point` images of each
point, drawn from the seed among those the window served at that point
(the last time it served each there). After the window on a card, a
line `mixrate {...}` on standard error gives each mode's rate over its
calls' own seconds, each point's mean bpp, and the programs captured in
set-up and in the window.
"""
from __future__ import annotations

import json
import sys
import time
from collections import defaultdict
from typing import Iterator, List

import numpy as np

from common import harness, weights
from reference.model import mode_of

Pipe = harness.load_module("drivers", "codec_pipe").Driver


def schedule(seed: int, n_points: int) -> Iterator[int]:
    """The points of the calls in turn, round after round: each round a
    permutation of range(n_points) drawn from the seed."""
    rng = np.random.default_rng(weights.derive(seed, weights.POINTS))
    while True:
        yield from (int(p) for p in rng.permutation(n_points))


class Driver(Pipe):

    def __init__(self, cell):
        super().__init__(cell)
        self.points = [tuple(float(r) for r in p) for p in self.t["points"]]
        self.reset_window()

    def warm_up(self) -> None:
        for p in range(len(self.points)):
            for _ in range(2):
                self.serve(p, self.t["warm_up_batches"], keep=False)
        self.programs_after_warm_up = self.codec._programs.captured

    def reset_window(self) -> None:
        super().reset_window()
        self.calls = schedule(self.cell.seed, len(self.points))
        self.by_point = defaultdict(lambda: {"calls": 0, "images": 0,
                                             "s": 0.0, "bits": 0})

    def request(self, keep: bool = True) -> None:
        self.serve(next(self.calls), self.t["batches_per_call"], keep)

    def serve(self, p: int, n_batches: int, keep: bool) -> None:
        """One roundtrip_pipelined call of n_batches pool batches at
        point p."""
        t, ratios = self.t, self.points[p]
        idx = self.next_images(n_batches * t["batch"])
        batches = [self.pool[idx[i:i + t["batch"]]]
                   for i in range(0, len(idx), t["batch"])]
        t0 = time.perf_counter()
        recs, encs = self.codec.roundtrip_pipelined(
            batches, *ratios, device_pack=True, out_uint8=True,
            threads=True)
        dt = time.perf_counter() - t0
        if not keep:
            return
        self.stats.append(dict(self.codec.last_pipeline_stats))
        rec_p = self.by_point[p]
        rec_p["calls"] += 1
        rec_p["s"] += dt
        for b, (rec, enc) in enumerate(zip(recs, encs)):
            for j, e in enumerate(enc):
                i = idx[b * t["batch"] + j]
                rec_p["images"] += 1
                rec_p["bits"] += 8 * e.num_bytes
                self.keep((p, i), [{"image": self.pool[i],
                                    "streams": e.streams, "mode": e.mode,
                                    "bpp": e.bpp, "rec": rec[j],
                                    "ratios": ratios}])

    def sample(self, keys) -> List[tuple]:
        """check_per_point keys (point, pool index) of each point, drawn
        from the seed among `keys`."""
        rng = np.random.default_rng(weights.derive(self.cell.seed,
                                                   weights.SAMPLE))
        out = []
        for p in range(len(self.points)):
            at = sorted(i for q, i in keys if q == p)
            n = min(self.t["check_per_point"], len(at))
            if n:
                out += [(p, at[k]) for k in
                        sorted(rng.choice(len(at), n, replace=False))]
        return out

    def control_items(self) -> List[tuple]:
        keys = [(p, i) for p in range(len(self.points))
                for i in range(len(self.pool))]
        return [(i, self.points[p]) for p, i in self.sample(keys)]

    def mixrate(self) -> dict:
        """Each mode's rate (Mpix/s over its calls' own seconds), each
        point's mean bpp, the programs captured in set-up and after it."""
        h, w = self.pool.shape[1:3]
        modes = defaultdict(lambda: [0, 0.0, 0])
        for p, r in self.by_point.items():
            m = modes[mode_of(*self.points[p])]
            m[0] += r["images"]
            m[1] += r["s"]
            m[2] += r["calls"]
        return {
            "mpix_s_by_mode": {str(k): v[0] * h * w / 1e6 / v[1]
                               for k, v in sorted(modes.items()) if v[1]},
            "calls_by_mode": {str(k): v[2] for k, v in sorted(modes.items())},
            "bpp_by_point": {",".join(map(str, self.points[p])):
                             r["bits"] / (r["images"] * h * w)
                             for p, r in sorted(self.by_point.items())},
            "programs_set_up": self.programs_after_warm_up,
            "programs_window": (self.codec._programs.captured
                                - self.programs_after_warm_up)}

    def end_to_end(self, window_s: float) -> dict:
        print("mixrate " + json.dumps(self.mixrate()), file=sys.stderr,
              flush=True)
        return super().end_to_end(window_s)
