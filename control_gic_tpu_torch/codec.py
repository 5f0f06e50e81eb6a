"""End-to-end codec: the model on the device plus host entropy coding
(port of control_gic_tpu/codec.py: the serial sender and receiver).

  sender:   encode(image) -> index grid + grain masks (device)
            -> per-grain index streams and mask bitmaps (host)
            -> Huffman and bitmap frames
  receiver: read the frames -> rebuild the masks and the index grid (host)
            -> upload them -> decode_indices -> RGB (device)

Streams per compression mode:
  mode 0: indices coarse+medium+fine, masks coarse+medium
  mode 1: indices medium+fine, mask medium            (coarse ratio 0)
  mode 2: indices coarse+fine, mask coarse            (medium ratio 0)
  mode 3: indices coarse+medium, mask coarse          (fine ratio 0)
  mode 4/5/6: one all-{coarse,medium,fine} index stream, no masks
The fine mask is never sent: the receiver derives it as the complement.
bpp = total stream bytes (each with its pad header) * 8 / pixels.

Images at the public functions are numpy [H, W, 3] (or [N, H, W, 3]) in
[0, 1], float or uint8, as in the JAX package; reconstructions come back as
float32 numpy in the same layout.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .coding import BitmapCodec, HuffmanCodec
from .models.cgic import CGIC
from .utils.device import resolve_device

STREAM_FILES = {
    "indices_coarse": "indices_coarse.bin",
    "indices_medium": "indices_medium.bin",
    "indices_fine": "indices_fine.bin",
    "mask_coarse": "mask_coarse.bin",
    "mask_medium": "mask_medium.bin",
}

MODE_STREAMS = {
    0: ["indices_coarse", "indices_medium", "indices_fine",
        "mask_coarse", "mask_medium"],
    1: ["indices_medium", "indices_fine", "mask_medium"],
    2: ["indices_coarse", "indices_fine", "mask_coarse"],
    3: ["indices_coarse", "indices_medium", "mask_coarse"],
    4: ["indices_coarse"],
    5: ["indices_medium"],
    6: ["indices_fine"],
}


class CorruptStreamError(ValueError):
    """A bitstream decoded to a symbol count its mask does not select."""


def _acc(stats: Optional[dict], key: str, val: float) -> None:
    if stats is not None:
        stats[key] = stats.get(key, 0.0) + val


@dataclasses.dataclass
class EncodedImage:
    """The bitstream bundle for one image."""
    mode: int
    latent_hw: Tuple[int, int]       # (Hl, Wl) of the fine index grid
    image_hw: Tuple[int, int]        # original pixel dims (for bpp)
    streams: Dict[str, bytes]

    @property
    def num_bytes(self) -> int:
        return sum(len(v) for v in self.streams.values())

    @property
    def bpp(self) -> float:
        return self.num_bytes * 8 / (self.image_hw[0] * self.image_hw[1])

    def write(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        for name in MODE_STREAMS[self.mode]:
            with open(os.path.join(path, STREAM_FILES[name]), "wb") as f:
                f.write(self.streams.get(name, b""))

    @classmethod
    def read(cls, path: str, mode: int, latent_hw: Tuple[int, int],
             image_hw: Tuple[int, int]) -> "EncodedImage":
        streams = {}
        for name in MODE_STREAMS[mode]:
            with open(os.path.join(path, STREAM_FILES[name]), "rb") as f:
                streams[name] = f.read()
        return cls(mode=mode, latent_hw=tuple(latent_hw),
                   image_hw=tuple(image_hw), streams=streams)


def _up2(m: np.ndarray) -> np.ndarray:
    return m.repeat(2, axis=-2).repeat(2, axis=-1)


def _up4(m: np.ndarray) -> np.ndarray:
    return m.repeat(4, axis=-2).repeat(4, axis=-1)


class CGICCodec:
    """Binds a CGIC model on `device` to the host entropy coders. The model
    is moved to `device`; CUDA is the default and is never replaced by the
    CPU quietly."""

    def __init__(self, model: CGIC, counts: Sequence[int],
                 device: Union[str, torch.device] = "cuda"):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.huffman = HuffmanCodec.from_counts(np.asarray(counts))
        self.bitmap = BitmapCodec()

    # ---------------------------------------------------------------- encode

    def _to_input(self, images: np.ndarray) -> torch.Tensor:
        """[N, H, W, 3] numpy in [0, 1] (uint8 divided by 255 on the device)
        -> [N, 3, H, W] float32 on the device."""
        x = torch.from_numpy(np.ascontiguousarray(images)).to(self.device)
        x = x.float() / 255.0 if x.dtype == torch.uint8 else x.float()
        return x.permute(0, 3, 1, 2).contiguous()

    @torch.no_grad()
    def encode_arrays(self, images: np.ndarray, coarse_ratio: float,
                      medium_ratio: float, per_sample: bool = False):
        """Device half of the sender: [N, H, W, 3] -> numpy (indices, m_c,
        m_m, m_f) and the mode."""
        if images.ndim != 4 or images.shape[-1] != 3:
            raise ValueError(f"expected [N, H, W, 3] images, got "
                             f"{images.shape}")
        if images.shape[1] % 16 or images.shape[2] % 16:
            raise ValueError(f"image size {images.shape[1:3]} is not a "
                             "multiple of 16: pad or crop it first")
        enc = self.model.encode(self._to_input(images), float(coarse_ratio),
                                float(medium_ratio), per_sample=per_sample)
        arrays = [t.cpu().numpy() for t in (enc.indices, *enc.router.masks)]
        return arrays, enc.router.mode

    def streams_from_arrays(self, ind: np.ndarray, m_c: np.ndarray,
                            m_m: np.ndarray, m_f: np.ndarray, mode: int,
                            image_hw: Tuple[int, int]) -> EncodedImage:
        """Entropy-code one image's index grid + masks into a bundle: each
        grain's stream samples the fine grid at its stride, then gathers the
        masked positions in row-major order."""
        streams: Dict[str, bytes] = {}
        present = MODE_STREAMS[mode]
        if "indices_coarse" in present:
            streams["indices_coarse"] = self.huffman.encode(
                ind[::4, ::4][m_c == 1])
        if "indices_medium" in present:
            streams["indices_medium"] = self.huffman.encode(
                ind[::2, ::2][m_m == 1])
        if "indices_fine" in present:
            streams["indices_fine"] = self.huffman.encode(ind[m_f == 1])
        if "mask_coarse" in present:
            streams["mask_coarse"] = self.bitmap.encode(m_c.reshape(-1))
        if "mask_medium" in present:
            streams["mask_medium"] = self.bitmap.encode(m_m.reshape(-1))
        return EncodedImage(mode=mode, latent_hw=tuple(ind.shape),
                            image_hw=tuple(image_hw), streams=streams)

    def encode(self, image: np.ndarray, coarse_ratio: float,
               medium_ratio: float, *,
               stats: Optional[dict] = None) -> EncodedImage:
        """image: [H, W, 3] in [0, 1] -> its bundle. `stats` (optional dict)
        accumulates the seconds of the device encode ('encode_s') and of the
        entropy coding ('entropy_s')."""
        if image.ndim != 3:
            raise ValueError(f"expected one [H, W, 3] image, got "
                             f"{image.shape}")
        t0 = time.perf_counter()
        (ind, m_c, m_m, m_f), mode = self.encode_arrays(
            image[None], coarse_ratio, medium_ratio)
        t1 = time.perf_counter()
        out = self.streams_from_arrays(ind[0], m_c[0], m_m[0], m_f[0], mode,
                                       image.shape[:2])
        _acc(stats, "encode_s", t1 - t0)
        _acc(stats, "entropy_s", time.perf_counter() - t1)
        return out

    def encode_batch(self, images: np.ndarray, coarse_ratio: float,
                     medium_ratio: float) -> List[EncodedImage]:
        """Batched encode of same-shape images, each routed with its own
        thresholds, so every bundle equals a solo encode of its image."""
        (ind, m_c, m_m, m_f), mode = self.encode_arrays(
            images, coarse_ratio, medium_ratio, per_sample=True)
        return [self.streams_from_arrays(ind[i], m_c[i], m_m[i], m_f[i],
                                         mode, images.shape[1:3])
                for i in range(len(images))]

    # ---------------------------------------------------------------- decode

    def _rebuild(self, encoded: EncodedImage
                 ) -> Tuple[np.ndarray, List[np.ndarray]]:
        """The full index grid + mask triple from the bitstreams (all 7
        modes). Raises CorruptStreamError on a count mismatch."""
        hl, wl = encoded.latent_hw
        mode = encoded.mode
        get = lambda n: encoded.streams[n]

        def mask(name: str, h: int, w: int) -> np.ndarray:
            bits = self.bitmap.decode(get(name))
            if bits is None or len(bits) != h * w:
                raise CorruptStreamError(
                    f"stream '{name}' holds {0 if bits is None else len(bits)}"
                    f" bits for a {h}x{w} mask")
            return np.asarray(bits, np.int64).reshape(h, w)

        def scatter(m: np.ndarray, name: str) -> np.ndarray:
            data = self.huffman.decode_array(get(name))
            grid = np.zeros(m.shape, np.int64)
            sel = m == 1
            n = 0 if data is None else len(data)
            if int(sel.sum()) != n:
                raise CorruptStreamError(
                    f"stream '{name}' decoded {n} symbols but its mask "
                    f"selects {int(sel.sum())} positions")
            if data is not None:
                grid[sel] = data
            return grid

        def dense(name: str, h: int, w: int) -> np.ndarray:
            return scatter(np.ones((h, w), np.int64), name)

        zeros_c = np.zeros((hl // 4, wl // 4), np.int64)
        zeros_m = np.zeros((hl // 2, wl // 2), np.int64)
        zeros_f = np.zeros((hl, wl), np.int64)
        if mode == 0:
            m_c = mask("mask_coarse", hl // 4, wl // 4)
            m_m = mask("mask_medium", hl // 2, wl // 2)
            m_f = 1 - _up2(m_m) - _up4(m_c)
            ind = (scatter(m_f, "indices_fine")
                   + _up2(scatter(m_m, "indices_medium"))
                   + _up4(scatter(m_c, "indices_coarse")))
        elif mode == 1:
            m_m = mask("mask_medium", hl // 2, wl // 2)
            m_f = 1 - _up2(m_m)
            m_c = zeros_c
            ind = (scatter(m_f, "indices_fine")
                   + _up2(scatter(m_m, "indices_medium")))
        elif mode == 2:
            m_c = mask("mask_coarse", hl // 4, wl // 4)
            m_f = 1 - _up4(m_c)
            m_m = zeros_m
            ind = (scatter(m_f, "indices_fine")
                   + _up4(scatter(m_c, "indices_coarse")))
        elif mode == 3:
            m_c = mask("mask_coarse", hl // 4, wl // 4)
            m_m = 1 - _up2(m_c)
            m_f = zeros_f
            ind = (_up4(scatter(m_c, "indices_coarse"))
                   + _up2(scatter(m_m, "indices_medium")))
        elif mode == 4:
            ind = _up4(dense("indices_coarse", hl // 4, wl // 4))
            m_c, m_m, m_f = np.ones_like(zeros_c), zeros_m, zeros_f
        elif mode == 5:
            ind = _up2(dense("indices_medium", hl // 2, wl // 2))
            m_c, m_m, m_f = zeros_c, np.ones_like(zeros_m), zeros_f
        elif mode == 6:
            ind = dense("indices_fine", hl, wl)
            m_c, m_m, m_f = zeros_c, zeros_m, np.ones_like(zeros_f)
        else:
            raise ValueError(f"bad mode {mode}")
        return ind, [m_c, m_m, m_f]

    @torch.no_grad()
    def decode_batch(self, encoded: List[EncodedImage], *,
                     stats: Optional[dict] = None) -> np.ndarray:
        """Same-mode, same-shape bundles -> [N, H, W, 3] float32. `stats`
        accumulates the host rebuild ('rebuild_s') and the upload, device
        decode and download ('decode_s')."""
        mode, hl_wl = encoded[0].mode, encoded[0].latent_hw
        if not all(e.mode == mode and e.latent_hw == hl_wl
                   for e in encoded):
            raise ValueError("decode_batch needs same-mode, same-shape "
                             "bundles; split mixed batches first")
        t0 = time.perf_counter()
        rebuilt = [self._rebuild(e) for e in encoded]
        t1 = time.perf_counter()
        up = lambda arrs: torch.from_numpy(np.stack(arrs)).to(self.device)
        ind = up([r[0] for r in rebuilt])
        masks = tuple(up([r[1][j] for r in rebuilt]).to(torch.int32)
                      for j in range(3))
        rec = self.model.decode_indices(ind, masks)
        out = rec.float().permute(0, 2, 3, 1).cpu().numpy()
        _acc(stats, "rebuild_s", t1 - t0)
        _acc(stats, "decode_s", time.perf_counter() - t1)
        return out

    def decode(self, encoded: EncodedImage, *,
               stats: Optional[dict] = None) -> np.ndarray:
        """-> [H, W, 3] float32 reconstruction."""
        return self.decode_batch([encoded], stats=stats)[0]

    # ------------------------------------------------------------ round-trip

    def compress(self, image: np.ndarray, coarse_ratio: float,
                 medium_ratio: float, out_dir: Optional[str] = None, *,
                 stats: Optional[dict] = None
                 ) -> Tuple[np.ndarray, float, EncodedImage]:
        """Sender -> receiver round trip, through stream files in `out_dir`
        when given. Returns (reconstruction [H, W, 3], bpp, bundle)."""
        encoded = self.encode(image, coarse_ratio, medium_ratio, stats=stats)
        if out_dir is not None:
            t0 = time.perf_counter()
            encoded.write(out_dir)
            encoded = EncodedImage.read(out_dir, encoded.mode,
                                        encoded.latent_hw, encoded.image_hw)
            _acc(stats, "files_s", time.perf_counter() - t0)
        rec = self.decode(encoded, stats=stats)
        return rec, encoded.bpp, encoded
