"""Image datasets and the batch prefetcher (port of
control_gic_tpu/data/dataset.py). Images are found by a recursive glob of
jpg/jpeg/png and decoded with PIL, which is imported where an image is read.

  - training (`ImageFolderDataset`): square center crop, bicubic resize with
    reducing_gap=1 to image_size, scaled to [-1, 1], [H, W, 3] float32;
  - evaluation (`EvalImageDataset`): center crop to the largest
    /16-divisible size (no resize), scaled to [0, 1].
`prefetch_batches` yields NHWC numpy batches from a thread, with a per-epoch
shuffle drawn from (seed, epoch), so a resume at step N yields what a fresh
run yields from its (N+1)-th batch on.
"""
from __future__ import annotations

import glob as globlib
import os
import queue
import threading
from typing import Iterator, List, Optional, Tuple

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


def _center_crop_square(img):
    w, h = img.size
    s = min(w, h)
    left, top = (w - s) // 2, (h - s) // 2
    return img.crop((left, top, left + s, top + s))


class ImageFolderDataset:
    """Training images: square center crop + bicubic resize, [-1, 1]."""

    def __init__(self, root: str, image_size: int = 256):
        self.paths = _list_images(root)
        self.image_size = image_size

    def __len__(self) -> int:
        return len(self.paths)

    def __getitem__(self, i: int) -> np.ndarray:
        from PIL import Image
        img = _center_crop_square(Image.open(self.paths[i]).convert("RGB"))
        img = img.resize((self.image_size, self.image_size),
                         resample=Image.BICUBIC, reducing_gap=1)
        return np.asarray(img, np.float32) / 127.5 - 1.0


def prefetch_batches(dataset, batch_size: int, *, shuffle: bool = True,
                     seed: int = 0, drop_last: bool = True,
                     epochs: Optional[int] = None,
                     start_step: int = 0) -> Iterator[np.ndarray]:
    """Yield [B, H, W, 3] batches decoded by a thread ahead of the
    consumer (a bounded queue of 8). Each epoch's order comes from
    (seed, epoch), so start_step=N resumes the stream exactly; `epochs`
    counts absolute epochs. The thread stops when the generator is closed."""
    n = len(dataset)
    per_epoch = (n // batch_size) if drop_last else -(-n // batch_size)
    stop = threading.Event()
    q: "queue.Queue" = queue.Queue(maxsize=8)

    def order_iter():
        epoch, skip = divmod(start_step, max(per_epoch, 1))
        while epochs is None or epoch < epochs:
            idx = np.arange(n)
            if shuffle:
                np.random.default_rng((seed, epoch)).shuffle(idx)
            batches = [idx[i:i + batch_size] for i in range(0, n, batch_size)
                       if (not drop_last) or i + batch_size <= n]
            yield from batches[skip:]
            skip = 0
            epoch += 1

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for batch_idx in order_iter():
                if not put(np.stack([dataset[int(i)] for i in batch_idx])):
                    return
        except Exception as e:          # handed to the consumer, re-raised
            put(e)
            return
        put(None)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is None:
                return
            if isinstance(item, Exception):
                raise item
            yield item
    finally:
        stop.set()
        t.join(timeout=10)
