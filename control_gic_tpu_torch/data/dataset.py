"""Evaluation images (port of control_gic_tpu/data/dataset.py::
EvalImageDataset): recursive glob of jpg/jpeg/png, each center-cropped to
the largest /16-divisible size (no resize), scaled to [0, 1], [H, W, 3]."""
from __future__ import annotations

import glob as globlib
import os
from typing import List, Tuple

import numpy as np


def _list_images(root: str) -> List[str]:
    out = []
    for ext in ("*.jpg", "*.jpeg", "*.png"):
        out += globlib.glob(os.path.join(root, "**", ext), recursive=True)
        out += globlib.glob(os.path.join(root, ext))
    return sorted(set(out))


class EvalImageDataset:
    def __init__(self, root: str, images_range: Tuple[int, int] = (0, -1)):
        self.paths = _list_images(root)
        if images_range[1] > 0:
            self.paths = self.paths[images_range[0]:images_range[1]]

    def __len__(self) -> int:
        return len(self.paths)

    def __getitem__(self, i: int) -> np.ndarray:
        from PIL import Image
        img = Image.open(self.paths[i]).convert("RGB")
        w, h = img.size
        tw, th = (w // 16) * 16, (h // 16) * 16
        # torchvision's center_crop rounds the origin with round() (banker's
        # rounding on a half pixel); the same crop gives the same streams
        left, top = round((w - tw) / 2), round((h - th) / 2)
        img = img.crop((left, top, left + tw, top + th))
        return np.asarray(img, np.float32) / 255.0
