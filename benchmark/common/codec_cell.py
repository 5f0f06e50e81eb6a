"""What the codec cells share: the model made from the configuration and
the seed, the codebook table, the pool of images, and the comparison of
what the window served with the reference.

The configuration file's `model` holds the CGICConfig as it is run, and
`table` the skew of the codebook counts the Huffman table is built from.
The traffic's `image_hw`, `pool` and `ratios` give the images and the
operating point (a driver that serves several points gives each unit it
keeps its own `ratios`); `check_images` how many distinct pool images the
comparison takes, drawn from the seed among those the window served (the
last time it served each).
"""
from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from reference import judge
from reference import model as R

from . import images, weights


def model_dict(config: dict) -> dict:
    return dict(config["model"])


def make_model(config: dict, seed: int, device: str):
    """The port's CGIC on `device` with the benchmark's weights."""
    from control_gic_tpu_torch.models import CGIC, CGICConfig
    m = model_dict(config)
    cfg = CGICConfig(**{k: tuple(v) if isinstance(v, list) else v
                        for k, v in m.items()})
    with torch.device(device):
        model = CGIC(cfg, generator=torch.Generator(device=device))
    params = weights.make_params([("gen", R.param_shapes(m))], seed,
                                 device)["gen"]
    model.load_state_dict(params, strict=True)
    return model


def reference_params(config: dict, seed: int, device: str) -> dict:
    return weights.make_params([("gen", R.param_shapes(model_dict(config)))],
                               seed, device)["gen"]


def table(config: dict, seed: int) -> np.ndarray:
    return images.skewed_counts(config["model"]["n_embed"],
                                config["table"]["skew"],
                                weights.derive(seed, weights.TABLE))


class CodecCell:
    """Set-up and comparison for a codec driver; subclasses serve the
    requests and record what they serve with `keep`."""

    items_per_request = 1

    def __init__(self, cell):
        self.cell = cell
        self.t = cell.traffic
        self.ratios = (tuple(float(r) for r in self.t["ratios"])
                       if "ratios" in self.t else None)
        self.served: Dict[object, List[dict]] = {}   # pool index -> units
        self.n_items = 0
        self.cursor = 0

    # ------------------------------------------------------------- set-up

    def setup(self, parts: dict) -> None:
        from control_gic_tpu_torch.codec import CGICCodec
        c = self.cell
        t0 = time.perf_counter()
        model = make_model(c.config, c.seed, c.device)
        if c.device.startswith("cuda"):
            torch.cuda.synchronize()
        parts["weights_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        self.make_inputs()
        parts["inputs_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        self.codec = CGICCodec(model, self.counts, device=c.device)
        parts["codec_s"] = time.perf_counter() - t0
        if c.device.startswith("cuda"):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        self.warm_up()
        self.capture_s = self.codec._programs.capture_s
        parts["capture_s"] = self.capture_s
        parts["programs"] = self.codec._programs.captured
        parts["warm_up_s"] = time.perf_counter() - t0 - self.capture_s
        self.reset_window()

    def warm_up(self) -> None:
        """Set-up's requests: the first captures each program, the second
        replays it."""
        for _ in range(2):
            self.request(keep=False)

    def make_inputs(self) -> None:
        """The codebook table, the pool and the order the requests take it
        in, all from the seed."""
        seed = self.cell.seed
        self.counts = table(self.cell.config, seed)
        self.pool = self.make_pool()
        rng = np.random.default_rng(weights.derive(seed, weights.ORDER))
        self.order = rng.permutation(len(self.pool))

    def sample(self, indices) -> List[int]:
        """The pool images the comparison takes, drawn from the seed."""
        indices = sorted(indices)
        n = min(self.t["check_images"], len(indices))
        pick = np.random.default_rng(weights.derive(
            self.cell.seed, weights.SAMPLE)).choice(len(indices), n,
                                                    replace=False)
        return [indices[i] for i in sorted(pick)]

    def control_items(self) -> List[tuple]:
        """(pool index, ratios) of each image the control in the program's
        place is judged on (checks/readings.py), drawn as `sample` draws."""
        return [(i, self.ratios) for i in self.sample(range(len(self.pool)))]

    def make_pool(self) -> np.ndarray:
        """[pool, H, W, 3] uint8 images, made on the device from the seed."""
        c = self.cell
        h, w = self.t["image_hw"]
        imgs = images.make_images(self.t["pool"], h, w,
                                  weights.generator(c.seed, weights.IMAGES,
                                                    c.device), c.device)
        return imgs.cpu().numpy()

    def reset_window(self) -> None:
        self.served.clear()
        self.n_items = 0

    def next_images(self, n: int) -> List[int]:
        """The pool indices of the next n images, in the seed's order."""
        idx = [int(self.order[(self.cursor + i) % len(self.order)])
               for i in range(n)]
        self.cursor += n
        return idx

    def keep(self, index: int, units: List[dict]) -> None:
        """Record what the program served for pool image `index` (the last
        time it served it)."""
        self.n_items += 1
        self.served[index] = units

    # ----------------------------------------------------------- release

    def release(self) -> None:
        self.codec = None

    def check(self) -> Dict[str, float]:
        """The comparison over the kept images, on the reference."""
        c = self.cell
        R.fp32_pipes(True)
        params = reference_params(c.config, c.seed, c.device)
        units = [u for i in self.sample(self.served) for u in self.served[i]]
        return judge.judge_codec(units, params, model_dict(c.config),
                                 self.counts, self.ratios, c.device)

    def layer_common(self) -> dict:
        return {"capture_s": self.capture_s, "items": self.n_items}
