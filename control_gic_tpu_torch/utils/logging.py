"""Training observability: scalar metrics as JSONL, and image grids on the
reference's schedule (port of control_gic_tpu/utils/logging.py).

Scalars go to `<out_dir>/metrics.jsonl` (and to wandb when asked for and
importable); grids of inputs, reconstructions and the partition map go to
PNG files at every power of two up to 1024 steps, then every 1024 steps.
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

import numpy as np


def log_schedule_hit(step: int, period: int = 1024) -> bool:
    if step < period:
        return step > 0 and (step & (step - 1)) == 0   # powers of two
    return step % period == 0


class MetricLogger:
    def __init__(self, out_dir: str, use_wandb: bool = False,
                 wandb_project: Optional[str] = None):
        os.makedirs(out_dir, exist_ok=True)
        self.path = os.path.join(out_dir, "metrics.jsonl")
        self._f = open(self.path, "a")
        self._wandb = None
        if use_wandb:
            try:
                import wandb
            except ImportError:
                print("wandb is not installed; metrics go to "
                      f"{self.path} only")
            else:
                wandb.init(project=wandb_project or "control_gic_tpu_torch")
                self._wandb = wandb

    def log(self, step: int, metrics: Dict[str, float]) -> None:
        rec = {"step": int(step), "time": time.time(),
               **{k: float(v) for k, v in metrics.items()}}
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)

    def close(self) -> None:
        self._f.close()


class ImageLogger:
    """Save input / reconstruction / partition-map grids ([-1, 1] NHWC) on
    the log schedule."""

    def __init__(self, out_dir: str, max_images: int = 4):
        self.dir = os.path.join(out_dir, "images")
        os.makedirs(self.dir, exist_ok=True)
        self.max_images = max_images

    def log(self, step: int, inputs: np.ndarray, recons: np.ndarray,
            grain_indices: Optional[np.ndarray] = None) -> None:
        from PIL import Image
        from .draw import draw_partition_map

        n = min(self.max_images, inputs.shape[0])
        rows = [np.concatenate(list(inputs[:n]), axis=1),
                np.concatenate(list(np.clip(recons[:n], -1, 1)), axis=1)]
        if grain_indices is not None:
            pm = draw_partition_map(np.asarray(inputs[:n]),
                                    np.asarray(grain_indices[:n]))
            rows.append(np.concatenate(list(pm), axis=1))
        grid = np.concatenate(rows, axis=0)
        grid = ((np.clip(grid, -1, 1) + 1) * 127.5).astype(np.uint8)
        Image.fromarray(grid).save(
            os.path.join(self.dir, f"step_{step:08d}.png"))
