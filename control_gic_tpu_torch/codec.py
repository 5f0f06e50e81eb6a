"""End-to-end codec: the model on the device plus host entropy coding
(port of control_gic_tpu/codec.py).

  sender:   encode(image) -> index grid + grain masks (device)
            -> per-grain index streams and mask bitmaps (host)
            -> Huffman and bitmap frames (the C++ coder, or Python)
            device_pack=True: the streams are compacted and Huffman-packed
            on the device (coding/stream_pack.py) and the host fetches one
            fused buffer per batch and frames its bytes
  receiver: read the frames -> rebuild the index grid (host)
            -> upload ONE compact buffer per batch: the grid as uint16 and
            the mask bitmaps as sent (split_compact_buf)
            -> masks unpacked, decode_indices -> RGB (device)
            device_unpack=True: ONE flat buffer of the frames' words goes
            up instead, and the Huffman decode and the grid rebuild run on
            the device too (make_rebuild_batch)

Streams per compression mode:
  mode 0: indices coarse+medium+fine, masks coarse+medium
  mode 1: indices medium+fine, mask medium            (coarse ratio 0)
  mode 2: indices coarse+fine, mask coarse            (medium ratio 0)
  mode 3: indices coarse+medium, mask coarse          (fine ratio 0)
  mode 4/5/6: one all-{coarse,medium,fine} index stream, no masks
The fine mask is never sent: the receiver derives it as the complement.
bpp = total stream bytes (each with its pad header) * 8 / pixels.

Images at the public functions are numpy [H, W, 3] (or [N, H, W, 3]) in
[0, 1], float or uint8 (divided by 255 on the device), as in the JAX
package; reconstructions come back as float32 numpy in the same layout, or
uint8 quantized as save_png does with out_uint8=True.

Device work is asynchronous up to a fetch: images go up from pinned memory
without waiting, results come down by a pinned copy enqueued behind the
work, with an event after the work and one after the copy
(`pipeline._Fetch`). All of it runs on the device's current stream, one
queue as in JAX, from whichever thread. `encode_batch_async` /
`encode_finish` and `decode_batch_async` split the two halves, and
`roundtrip_pipelined` runs them as three stages a batch on the one runner
of pipeline.py (`run_stages`), which the tiled codec shares: threaded,
batch i's host entropy stage runs while the device encodes batch i+1.

Timing is by spans (utils/trace.py): `compress` and `roundtrip_pipelined`
open a request's root span, each stage, upload, device wait and program
replay a span under it, and the seconds of `stats=` and
`last_pipeline_stats` are their sums.
"""
from __future__ import annotations

import dataclasses
import os
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .coding import BitmapCodec, HuffmanCodec
from .coding.huffman_decode_device import (bitmap_decode_bits,
                                           build_decode_lut,
                                           frame_body_words,
                                           huffman_decode_bits,
                                           huffman_decode_bits_scan,
                                           supports_decode_table,
                                           words_from_frame)
from .coding.huffman_device import pack_tables, supports_table
from .coding.stream_pack import (fuse_packed, fused_layout, fused_to_bytes,
                                 pack_streams_batch)
from .models.cgic import CGIC
from .ops.router import mode_from_ratios
from .pipeline import _Fetch, run_stages
from .utils.device import resolve_device
from .utils.programs import CUDAGraphs, Programs
from .utils.trace import span

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
    """A bitstream decoded to a symbol count its mask does not select, or to
    a symbol outside the codebook."""


@dataclasses.dataclass
class _PendingEncode:
    """An encode dispatched to the device and not yet fetched. Exactly one
    of `packed` (the fused stream buffer) and `enc` (the index grid and the
    three masks) is set."""
    mode: int
    latent_hw: Tuple[int, int]
    image_hw: Tuple[int, int]
    n: int
    packed: Optional[_Fetch] = None
    enc: Optional[_Fetch] = None


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


def _up2_t(g: torch.Tensor) -> torch.Tensor:
    return g.repeat_interleave(2, -2).repeat_interleave(2, -1)


def _up4_t(g: torch.Tensor) -> torch.Tensor:
    return g.repeat_interleave(4, -2).repeat_interleave(4, -1)


def unpack_caps(L: int, mode: int, hl: int, wl: int):
    """The device-unpack receiver's static layout of a mode's streams:
    [(name, symbols, word capacity, is_bitmap)]. A capacity bounds the
    block each stream reads from the flat upload and keeps one guard word
    past its last peek (L: the decode table's longest code)."""
    nc, nm, nf = (hl // 4) * (wl // 4), (hl // 2) * (wl // 2), hl * wl
    sizes = {
        "indices_coarse": (nc, nc * L // 32 + 2, False),
        "indices_medium": (nm, nm * L // 32 + 2, False),
        "indices_fine": (nf, nf * L // 32 + 2, False),
        "mask_coarse": (nc, nc // 32 + 2, True),
        "mask_medium": (nm, nm // 32 + 2, True),
    }
    return [(name,) + sizes[name] for name in MODE_STREAMS[mode]]


def unpack_impl() -> str:
    """The device receiver's Huffman decoder, CONTROL_GIC_UNPACK_IMPL (read
    at call time): 'scan' (the default, as in JAX), the lock-step walk, on
    CUDA the scan kernel; 'rank', the list-ranking decoder in tensor ops."""
    impl = os.environ.get("CONTROL_GIC_UNPACK_IMPL", "scan")
    if impl not in ("scan", "rank"):
        raise ValueError(f"CONTROL_GIC_UNPACK_IMPL must be 'scan' or "
                         f"'rank', got {impl!r}")
    return impl


def _receiver_masks(mode: int, m_c: Optional[torch.Tensor],
                    m_m: Optional[torch.Tensor], b: int, hl: int, wl: int,
                    dev: torch.device):
    """The decoder's mask triple (m_c, m_m, m_f), int32 [B, h, w], from the
    masks the mode sends (None where it sends none), as the host _rebuild
    derives them: the fine mask is the complement; all-one or all-zero
    masks in the one-grain modes."""
    zeros = lambda h, w: torch.zeros((b, h, w), dtype=torch.int32,
                                     device=dev)
    ones = lambda h, w: torch.ones((b, h, w), dtype=torch.int32, device=dev)
    hc, wc, hm, wm = hl // 4, wl // 4, hl // 2, wl // 2
    if mode == 0:
        m_f = 1 - _up2_t(m_m) - _up4_t(m_c)
    elif mode == 1:
        m_c, m_f = zeros(hc, wc), 1 - _up2_t(m_m)
    elif mode == 2:
        m_m, m_f = zeros(hm, wm), 1 - _up4_t(m_c)
    elif mode == 3:
        m_m, m_f = 1 - _up2_t(m_c), zeros(hl, wl)
    elif mode == 4:
        m_c, m_m, m_f = ones(hc, wc), zeros(hm, wm), zeros(hl, wl)
    elif mode == 5:
        m_c, m_m, m_f = zeros(hc, wc), ones(hm, wm), zeros(hl, wl)
    else:
        m_c, m_m, m_f = zeros(hc, wc), zeros(hm, wm), ones(hl, wl)
    return m_c, m_m, m_f


# each index stream: its mask in the triple, and its grid's upsampling
_GRAINS = {"indices_coarse": (0, _up4_t), "indices_medium": (1, _up2_t),
           "indices_fine": (2, lambda g: g)}


def make_rebuild_batch(L: int, mode: int, hl: int, wl: int,
                       impl: Optional[str] = None):
    """The batched device receiver: (flat words [N] int32, word offsets
    [B, S], lut_sym, lut_len) -> (index grids [B, hl, wl] int64, m_c, m_m,
    m_f int32), all on the device, as the host's _rebuild computes them:
    each stream's block cut from the flat upload, the mask bitmaps
    unpacked and the absent masks derived (_receiver_masks), each Huffman
    stream decoded (impl: see unpack_impl) with its mask's count, its
    front-packed symbols scattered to their mask positions (an all-one
    mask in the one-grain modes) and the grids interleaved. Shared by
    decode_batch(device_unpack=True) and the tiled decode + stitch."""
    impl = impl or unpack_impl()
    caps = unpack_caps(L, mode, hl, wl)

    def scatter_syms(mask_grid, syms):
        """Front-packed symbols [B, n] -> their positions in mask_grid
        [B, h, w] (the inverse of stream_pack.compact_masked), by the
        row-major rank of each set position."""
        b = mask_grid.shape[0]
        flat = mask_grid.reshape(b, -1)
        rank = torch.clamp(torch.cumsum(flat, -1) - 1, 0, syms.shape[-1] - 1)
        return torch.where(flat == 1, syms.gather(-1, rank),
                           0).reshape(mask_grid.shape)

    def rebuild_batch(flat, offs, lut_s, lut_l):
        b, dev = offs.shape[0], flat.device
        blocks = {}
        for s, (name, _, cw, _) in enumerate(caps):
            # dynamic_slice's start: clamped so the block lies in the buffer
            start = torch.clamp(offs[:, s].to(torch.int64), 0,
                                flat.shape[0] - cw)
            blocks[name] = flat[start[:, None]
                                + torch.arange(cw, device=dev)]  # [B, cw]
        def sent(name, h, w):
            """A mask the mode sends, unpacked; None where it sends none."""
            if name not in blocks:
                return None
            return bitmap_decode_bits(blocks[name], h * w).reshape(b, h, w)

        masks = _receiver_masks(mode, sent("mask_coarse", hl // 4, wl // 4),
                                sent("mask_medium", hl // 2, wl // 2), b, hl,
                                wl, dev)
        ind = torch.zeros((b, hl, wl), dtype=torch.int64, device=dev)
        for name, n, _, is_bitmap in caps:
            if is_bitmap:
                continue
            k, up = _GRAINS[name]
            counts = masks[k].sum((1, 2), dtype=torch.int32)
            if impl == "scan":
                syms = huffman_decode_bits_scan(blocks[name], counts, lut_s,
                                                lut_l, n, L)
            else:
                syms = huffman_decode_bits(blocks[name], counts, lut_s,
                                           lut_l, n, L)
            ind = ind + up(scatter_syms(masks[k], syms))
        return (ind, *masks)

    return rebuild_batch


class CGICCodec:
    """Binds a CGIC model on `device` to the entropy coders. The model is
    moved to `device`; CUDA is the default and is never replaced by the CPU
    quietly.

    The device half of each batch runs as one program per static key and
    input shape, as JAX jits it (`_encode_fns`, `_encode_pack_fns`,
    `_decode_fns`, `_tile_fns`; utils/programs.py): on CUDA a CUDA graph,
    captured at the key's first call and replayed after it. graphs=None
    means on for a CUDA codec; graphs=False runs every batch eagerly, as
    `jax.disable_jit()` does. A codec on the CPU makes no graph."""

    def __init__(self, model: CGIC, counts: Sequence[int],
                 device: Union[str, torch.device] = "cuda",
                 graphs: Optional[bool] = None):
        counts = np.asarray(counts)
        # the compact receiver ships index grids as uint16
        # (split_compact_buf); the reference codebook has 1024 entries
        if len(counts) > 65536:
            raise ValueError(f"codebook of {len(counts)} entries: the "
                             "compact receiver's uint16 grid takes at most "
                             "65536")
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.counts = counts
        self.huffman = HuffmanCodec.from_counts(counts)
        self.bitmap = BitmapCodec()
        # the device packer takes codes of at most 32 bits (any table
        # without a long zero-count tail)
        self._device_tables = (pack_tables(self.huffman.codes)
                               if supports_table(self.huffman.codes)
                               else None)
        self._device_tables_dev = None   # the same as int64 device tensors
        # the device-unpack receiver's decode table (code lengths in
        # [1, MAX_LUT_BITS]); without it decode_batch(device_unpack=True)
        # takes the host receiver
        self._decode_tables = (build_decode_lut(self.huffman.codes)
                               if supports_decode_table(self.huffman.codes)
                               else None)
        self._decode_tables_dev = None   # the same on the device, int32
        # per-stage seconds and bytes of the last roundtrip_pipelined or
        # compress_tiled_device run
        self.last_pipeline_stats: Dict[str, float] = {}
        # the receiver the last decode_batch used: 'device' or 'host'
        self.last_decode_path: Optional[str] = None
        self._programs = Programs(
            self.model, CUDAGraphs(self.device)
            if self.device.type == "cuda" and graphs is not False else None)
        self._encode_fns = self._programs.cache()
        self._encode_pack_fns = self._programs.cache()
        self._decode_fns = self._programs.cache()
        self._tile_fns = self._programs.cache()   # parallel/tiling.py

    # ------------------------------------------------------- host <-> device

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        """numpy -> the device, without waiting: staged in pinned memory and
        copied on the current stream (the host allocator keeps the pinned
        block until the copy is done)."""
        with span("cgic.codec.upload", bytes=arr.nbytes):
            t = torch.from_numpy(np.ascontiguousarray(arr))
            if self.device.type != "cuda":
                return t
            return t.pin_memory().to(self.device, non_blocking=True)

    def _to_input(self, images: np.ndarray) -> torch.Tensor:
        """[N, H, W, 3] numpy in [0, 1] (uint8 divided by 255 on the device)
        -> [N, 3, H, W] float32 on the device."""
        return self._input_from_device(self._upload(images))

    @staticmethod
    def _input_from_device(x: torch.Tensor) -> torch.Tensor:
        """[N, H, W, 3] on the device -> [N, 3, H, W] float32; uint8 / 255
        in f32, the same single rounding as the dataset's k / 255."""
        x = x.float() / 255.0 if x.dtype == torch.uint8 else x.float()
        return x.permute(0, 3, 1, 2).contiguous()

    @staticmethod
    def _check_images(images: np.ndarray) -> None:
        if images.ndim != 4 or images.shape[-1] != 3:
            raise ValueError(f"expected [N, H, W, 3] images, got "
                             f"{images.shape}")
        if images.shape[1] % 16 or images.shape[2] % 16:
            raise ValueError(f"image size {images.shape[1:3]} is not a "
                             "multiple of 16: pad or crop it first")

    # ---------------------------------------------------------------- encode

    @torch.no_grad()
    def encode_arrays(self, images: np.ndarray, coarse_ratio: float,
                      medium_ratio: float, per_sample: bool = False):
        """Device half of the sender: [N, H, W, 3] -> numpy (indices, m_c,
        m_m, m_f) and the mode."""
        self._check_images(images)
        rc, rm = float(coarse_ratio), float(medium_ratio)
        out = self._encode(self._upload(images), rc, rm, per_sample)
        return _Fetch(*out).arrays(), mode_from_ratios(rc, rm)

    def _encode(self, x: torch.Tensor, rc: float, rm: float,
                per_sample: bool):
        """The encode program (JAX `_encode_fn`): [N, H, W, 3] on the device
        (uint8 or float) -> (indices, m_c, m_m, m_f)."""
        def fn(x):
            enc = self.model.encode(self._input_from_device(x), rc, rm,
                                    per_sample=per_sample)
            return (enc.indices, *enc.router.masks)

        return self._programs.run(self._encode_fns, (rc, rm, per_sample),
                                  fn, x)

    def _tables_on_device(self) -> Tuple[torch.Tensor, torch.Tensor]:
        if self._device_tables_dev is None:
            self._device_tables_dev = tuple(
                torch.from_numpy(t.astype(np.int64)).to(self.device)
                for t in self._device_tables)
        return self._device_tables_dev

    def _encode_pack(self, x: torch.Tensor, rc: float, rm: float,
                     per_sample: bool) -> torch.Tensor:
        """The encode + pack program (JAX `_encode_pack_fn`): [N, H, W, 3]
        on the device (uint8 or float) -> _encode_pack_fn's buffer."""
        return self._programs.run(
            self._encode_pack_fns, (rc, rm, per_sample),
            lambda x: self._encode_pack_fn(self._input_from_device(x), rc,
                                           rm, per_sample), x)

    def _encode_pack_fn(self, x: torch.Tensor, rc: float, rm: float,
                        per_sample: bool) -> torch.Tensor:
        """Neural encode + on-device stream packing of a [N, 3, H, W] device
        batch -> the fused buffer [N, words] uint32 (coding/stream_pack.py::
        fuse_packed): the host fetches it once instead of the grids."""
        lens, words = self._tables_on_device()
        enc = self.model.encode(x, rc, rm, per_sample=per_sample)
        packed = pack_streams_batch(enc.indices, enc.router.masks,
                                    enc.router.mode, lens, words,
                                    self._max_code_len())
        return fuse_packed(packed, enc.router.mode)

    def _max_code_len(self) -> int:
        lens = self._device_tables[0]
        return int(lens.max()) if lens.size else 1

    def _frame_packed(self, buf: np.ndarray, mode: int,
                      image_hw: Tuple[int, int], n: int
                      ) -> List[EncodedImage]:
        """The bundles of the first n rows of a fetched fused buffer of
        image_hw images (encode_finish, and the tiled codec's stage b)."""
        h, w = image_hw
        layout = fused_layout(mode, h // 4, w // 4, self._max_code_len())
        return [EncodedImage(mode=mode, latent_hw=(h // 4, w // 4),
                             image_hw=(h, w),
                             streams=fused_to_bytes(buf, layout, i))
                for i in range(n)]

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
               medium_ratio: float, *, device_pack: bool = False,
               stats: Optional[dict] = None) -> EncodedImage:
        """image: [H, W, 3] in [0, 1] -> its bundle. device_pack=True packs
        the streams on the device (byte-identical; the host path when the
        table has codes above 32 bits). `stats` (optional dict) accumulates
        the seconds of the device encode with its fetch ('encode_s') and of
        the host entropy coding or framing ('entropy_s')."""
        if image.ndim != 3:
            raise ValueError(f"expected one [H, W, 3] image, got "
                             f"{image.shape}")
        st: Dict[str, float] = {}
        with span("cgic.codec.encode", stats, "encode_s"):
            pend = self.encode_batch_async(image[None], coarse_ratio,
                                           medium_ratio,
                                           device_pack=device_pack,
                                           per_sample=False)
            out = self.encode_finish(pend, stats=st)[0]
        if stats is not None:
            stats["encode_s"] -= st["b_frame_s"]
            stats["entropy_s"] = stats.get("entropy_s", 0.0) + st["b_frame_s"]
        return out

    def encode_batch(self, images: np.ndarray, coarse_ratio: float,
                     medium_ratio: float, *,
                     device_pack: bool = False) -> List[EncodedImage]:
        """Batched encode of same-shape images, each routed with its own
        thresholds, so every bundle equals a solo encode of its image."""
        return self.encode_finish(self.encode_batch_async(
            images, coarse_ratio, medium_ratio, device_pack=device_pack))

    # ---------------------------------------------------------------- decode

    def _rebuild(self, encoded: EncodedImage
                 ) -> Tuple[np.ndarray, List[np.ndarray]]:
        """The full index grid + mask triple from the bitstreams (all 7
        modes). Raises CorruptStreamError on a count mismatch or a symbol
        outside the codebook."""
        hl, wl = encoded.latent_hw
        mode = encoded.mode
        get = lambda n: encoded.streams[n]
        n_sym = self.huffman.n_sym

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
                if n and not 0 <= int(data.min()) <= int(data.max()) < n_sym:
                    raise CorruptStreamError(
                        f"stream '{name}' decoded a symbol outside the "
                        f"codebook of {n_sym}")
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

    @staticmethod
    def _mask_word_caps(hl: int, wl: int) -> Tuple[int, int]:
        """uint32 word capacities of the coarse and medium mask frame bodies
        (n bits plus the 1..8-bit pad can spill one word past
        ceil(n / 32))."""
        nc = (hl // 4) * (wl // 4)
        nm = (hl // 2) * (wl // 2)
        return (nc + 8 + 31) // 32, (nm + 8 + 31) // 32

    @staticmethod
    def split_compact_buf(buf: torch.Tensor, mode: int, hl: int, wl: int):
        """Unpack the compact receiver buffer, one 16-bit row per image
        ([B, ind as uint16 | mask_coarse frame words | mask_medium frame
        words], int16 or uint16 bits), into decode_indices' arguments,
        deriving the absent masks as the host rebuild does: the fine mask
        is the complement; all-one or all-zero masks in the one-grain
        modes. Each frame word is two 16-bit halves, low half first (the
        host wrote `w.view(np.uint16)` on a little-endian machine).

        Returns (ind [B, hl, wl] int64, (m_c, m_m, m_f) int32)."""
        b = buf.shape[0]
        nf = hl * wl
        hc, wc = hl // 4, wl // 4
        hm, wm = hl // 2, wl // 2
        wcw, wmw = CGICCodec._mask_word_caps(hl, wl)
        present = MODE_STREAMS[mode]
        dev = buf.device

        ind = (buf[:, :nf].to(torch.int64) & 0xFFFF).reshape(b, hl, wl)
        pos = nf

        def mask_at(p, nw, h, w):
            seg = buf[:, p:p + 2 * nw].reshape(b, nw, 2).contiguous()
            words = seg.view(torch.int32).reshape(b, nw)
            return bitmap_decode_bits(words, h * w).reshape(b, h, w)

        m_c = m_m = None
        if "mask_coarse" in present:
            m_c = mask_at(pos, wcw, hc, wc)
            pos += 2 * wcw
        if "mask_medium" in present:
            m_m = mask_at(pos, wmw, hm, wm)
            pos += 2 * wmw
        return ind, _receiver_masks(mode, m_c, m_m, b, hl, wl, dev)

    def _compact_decode_input(self, encoded: List[EncodedImage],
                              inds) -> np.ndarray:
        """Host half of the compact receiver upload: the index grids as
        uint16 and the mask frame bodies as sent, one row per image (see
        split_compact_buf)."""
        mode = encoded[0].mode
        hl, wl = encoded[0].latent_hw
        wcw, wmw = self._mask_word_caps(hl, wl)
        present = MODE_STREAMS[mode]
        rows = []
        for e, ind in zip(encoded, inds):
            parts = [np.asarray(ind, np.uint16).reshape(-1)]
            if "mask_coarse" in present:
                w, _ = words_from_frame(e.streams["mask_coarse"], wcw)
                parts.append(w.view(np.uint16))
            if "mask_medium" in present:
                w, _ = words_from_frame(e.streams["mask_medium"], wmw)
                parts.append(w.view(np.uint16))
            rows.append(np.concatenate(parts))
        return np.stack(rows)

    def _decode(self, buf: torch.Tensor, mode: int, hl: int, wl: int,
                out_uint8: bool) -> torch.Tensor:
        """The decode program (JAX `_decode_fused_fn`) of _decode_fused_fn."""
        return self._programs.run(
            self._decode_fns, (mode, hl, wl, out_uint8),
            lambda b: self._decode_fused_fn(b, mode, hl, wl, out_uint8), buf)

    def _decode_fused_fn(self, buf: torch.Tensor, mode: int, hl: int,
                         wl: int, out_uint8: bool) -> torch.Tensor:
        """The receiver's device half from ONE compact buffer per batch (one
        upload at near the wire format's size): [B, H, W, 3] float32, or
        uint8 with out_uint8, quantized as cli.common.save_png does (f32,
        clip, * 255, truncate), which cuts the fetch 4x."""
        ind, masks = self.split_compact_buf(buf, mode, hl, wl)
        return self._reconstruct(ind, masks, out_uint8)

    def _reconstruct(self, ind: torch.Tensor, masks,
                     out_uint8: bool) -> torch.Tensor:
        """decode_indices -> [B, H, W, 3] float32, or uint8 quantized as
        cli.common.save_png does (f32, clip, * 255, truncate)."""
        rec = self.model.decode_indices(ind, masks).float()
        if out_uint8:
            rec = (rec.clamp(0.0, 1.0) * 255).to(torch.uint8)
        return rec.permute(0, 2, 3, 1).contiguous()

    # ------------------------------------------- device-unpack receiver path

    def _unpack_caps(self, mode: int, hl: int, wl: int):
        return unpack_caps(self._decode_tables[2], mode, hl, wl)

    def _decode_luts_on_device(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The decode table on the device, uploaded once per codec (2^L
        entries: re-uploading it each batch would cost the wire)."""
        if self._decode_tables_dev is None:
            lut_sym, lut_len, _ = self._decode_tables
            self._decode_tables_dev = (
                torch.from_numpy(lut_sym).to(self.device),
                torch.from_numpy(lut_len).to(self.device))
        return self._decode_tables_dev

    def _decode_unpack(self, flat: torch.Tensor, offs: torch.Tensor,
                       mode: int, hl: int, wl: int,
                       out_uint8: bool) -> torch.Tensor:
        """The device-unpack decode program (JAX `_decode_unpack_fn`, under
        its key): the flat stream words and the offset table -> the
        reconstruction. The decode table is a constant of the program."""
        impl = unpack_impl()
        luts = self._decode_luts_on_device()
        return self._programs.run(
            self._decode_fns, ("unpack", mode, hl, wl, out_uint8, impl),
            lambda f, o: self._decode_unpack_fn(f, o, luts, mode, hl, wl,
                                                out_uint8, impl),
            flat, offs)

    def _decode_unpack_fn(self, flat: torch.Tensor, offs: torch.Tensor,
                          luts, mode: int, hl: int, wl: int,
                          out_uint8: bool, impl: str) -> torch.Tensor:
        """The whole receiver on the device from ONE flat buffer of every
        image's stream words (the compressed payload) and a per-(image,
        stream) word-offset table: Huffman decode, mask unpack, grid
        rebuild (make_rebuild_batch), then decode_indices. The upload is
        the compressed size, not the grids'."""
        rebuild = make_rebuild_batch(self._decode_tables[2], mode, hl, wl,
                                     impl)
        ind, m_c, m_m, m_f = rebuild(flat, offs, *luts)
        return self._reconstruct(ind, (m_c, m_m, m_f), out_uint8)

    def _flat_stream_upload(self, encoded: List[EncodedImage]
                            ) -> Tuple[np.ndarray, np.ndarray]:
        """Host half of the device-unpack upload: every bundle's frame words
        (pad headers stripped, MSB-first uint32) in one flat buffer, a guard
        of the largest capacity + 1 zero words, padded to a quarter-octave
        size bucket (at least 1024 words), and the [N, streams] int32 word
        offsets; byte for byte JAX's. The buffer's length follows the
        compressed size, so the buckets cap the programs captured for it at
        about four an octave, for at most 25% padding."""
        mode = encoded[0].mode
        caps = self._unpack_caps(mode, *encoded[0].latent_hw)
        offs = np.zeros((len(encoded), len(caps)), np.int32)
        blocks = []
        pos = 0
        for i, e in enumerate(encoded):
            for s, (name, _, cw, _) in enumerate(caps):
                words, _ = frame_body_words(e.streams[name])
                if words.size > cw:
                    raise ValueError(f"stream '{name}' holds {words.size} "
                                     f"words, more than its capacity {cw}")
                offs[i, s] = pos
                blocks.append(words)
                pos += words.size
        guard = max(cw for _, _, cw, _ in caps) + 1
        blocks.append(np.zeros(guard, np.uint32))
        flat = np.concatenate(blocks)
        n = max(int(flat.size), 1024)
        octave = 1 << (n.bit_length() - 1)
        step = max(octave // 4, 256)
        bucket = ((n + step - 1) // step) * step
        out = np.zeros(bucket, np.uint32)
        out[:flat.size] = flat
        return out, offs

    def _receiver_input(self, encoded: List[EncodedImage],
                        device_unpack: bool) -> Tuple[np.ndarray, ...]:
        """What goes up for the receiver, in the dtypes the decode programs
        take: for the device receiver the flat frame words (int32 bits) and
        their offset table (_flat_stream_upload); for the host receiver the
        rebuilt grids and the mask frames in one compact buffer (int16
        bits, _compact_decode_input). decode_batch_async,
        decode_batch_device_async and the tiled codec's stage b call it."""
        if device_unpack:
            flat, offs = self._flat_stream_upload(encoded)
            return flat.view(np.int32), offs
        inds = [self._rebuild(e)[0] for e in encoded]
        return (self._compact_decode_input(encoded, inds).view(np.int16),)

    def _unpack_engaged(self, device_unpack: bool,
                        strict: bool = False) -> bool:
        """Whether the device receiver runs: asked for, and the table is
        device-decodable; else the host receiver, or with strict=True a
        ValueError."""
        engaged = device_unpack and self._decode_tables is not None
        if device_unpack and not engaged and strict:
            raise ValueError(
                "device_unpack requested with strict=True but this codec's "
                "Huffman table is not device-decodable (code lengths "
                "outside [1, MAX_LUT_BITS])")
        return engaged

    def decode_batch(self, encoded: List[EncodedImage], *,
                     out_uint8: bool = False, device_unpack: bool = False,
                     strict: bool = False,
                     stats: Optional[dict] = None) -> np.ndarray:
        """Same-mode, same-shape bundles -> [N, H, W, 3] float32 (uint8 with
        out_uint8).

        device_unpack=True runs the whole receiver on the device (Huffman
        decode and grid rebuild, decode_batch_device_async): the upload is
        the compressed streams, not the rebuilt grids. Pixel-identical to
        the host receiver. It needs a device-decodable table and takes the
        host receiver otherwise, or raises with strict=True. Only the host
        receiver validates streams (CorruptStreamError). After the call
        self.last_decode_path says which receiver ran ('device' or 'host').
        `stats` accumulates the host half ('rebuild_s': the host rebuild, or
        the flat upload's framing) and the upload, device decode and
        download ('decode_s')."""
        engaged = self._unpack_engaged(device_unpack, strict)
        self.last_decode_path = "device" if engaged else "host"
        dispatch = (self.decode_batch_device_async if engaged
                    else self.decode_batch_async)
        st: Dict[str, float] = {}
        with span("cgic.codec.decode", stats, "decode_s"):
            out = _Fetch(dispatch(encoded, out_uint8=out_uint8,
                                  stats=st)).arrays()[0]
        if stats is not None:
            stats["decode_s"] -= st["b_rebuild_s"]
            stats["rebuild_s"] = (stats.get("rebuild_s", 0.0)
                                  + st["b_rebuild_s"])
        return out

    def decode(self, encoded: EncodedImage, *,
               stats: Optional[dict] = None) -> np.ndarray:
        """-> [H, W, 3] float32 reconstruction."""
        return self.decode_batch([encoded], stats=stats)[0]

    # ----------------------------------------------------- pipelined batches

    @torch.no_grad()
    def encode_batch_async(self, images: np.ndarray, coarse_ratio: float,
                           medium_ratio: float, *, device_pack: bool = False,
                           per_sample: bool = True) -> _PendingEncode:
        """Dispatch the device half of encode_batch and return at once: the
        handle owns the fetches in flight. encode_finish waits for them and
        frames the streams; between the two the host is free to run another
        batch's entropy stage (roundtrip_pipelined)."""
        self._check_images(images)
        n, h, w, _ = images.shape
        rc, rm = float(coarse_ratio), float(medium_ratio)
        x = self._upload(images)
        pend = _PendingEncode(mode_from_ratios(rc, rm), (h // 4, w // 4),
                              (h, w), n)
        if device_pack and self._device_tables is not None:
            pend.packed = _Fetch(self._encode_pack(x, rc, rm, per_sample))
        else:
            pend.enc = _Fetch(*self._encode(x, rc, rm, per_sample))
        return pend

    def encode_finish(self, pending: _PendingEncode,
                      stats: Optional[dict] = None) -> List[EncodedImage]:
        """Wait for a pending encode and frame its streams (the host entropy
        stage). `stats` accumulates 'b_sync_s' (waiting for the device
        encode), 'b_fetch_s' (waiting for the copy to the host),
        'b_frame_s' (host framing or entropy coding) and 'b_fetch_bytes'."""
        fetch = pending.packed if pending.packed is not None else pending.enc
        fetch.sync(stats, "b_sync_s")
        arrays = fetch.arrays(stats, "b_fetch_s")
        nbytes = sum(a.nbytes for a in arrays)
        with span("cgic.coding.frame", stats, "b_frame_s", bytes=nbytes,
                  images=pending.n):
            if pending.packed is not None:
                out = self._frame_packed(arrays[0], pending.mode,
                                         pending.image_hw, pending.n)
            else:
                ind, m_c, m_m, m_f = arrays
                out = [self.streams_from_arrays(ind[i], m_c[i], m_m[i],
                                                m_f[i], pending.mode,
                                                pending.image_hw)
                       for i in range(pending.n)]
        if stats is not None:
            stats["b_fetch_bytes"] = stats.get("b_fetch_bytes", 0.0) + nbytes
        return out

    @staticmethod
    def _batch_layout(encoded: List[EncodedImage]):
        """(mode, latent_hw) of a batch; every bundle's masks come from one
        mode, so a mixed batch raises."""
        mode, hl_wl = encoded[0].mode, encoded[0].latent_hw
        if not all(e.mode == mode and e.latent_hw == hl_wl
                   for e in encoded):
            raise ValueError("decode_batch needs same-mode, same-shape "
                             "bundles; split mixed batches first")
        return mode, hl_wl

    @torch.no_grad()
    def decode_batch_async(self, encoded: List[EncodedImage], *,
                           out_uint8: bool = False,
                           stats: Optional[dict] = None) -> torch.Tensor:
        """Host rebuild + the compact upload + the device decode, dispatched
        without waiting. Returns the device tensor [N, H, W, 3] (float32, or
        uint8 with out_uint8). `stats` accumulates 'b_rebuild_s' (host
        entropy decode and the compact buffer), 'b_h2d_dispatch_s' and
        'b_h2d_bytes'."""
        with span("cgic.coding.rebuild", stats, "b_rebuild_s",
                  images=len(encoded)):
            mode, hl_wl = self._batch_layout(encoded)
            (buf,) = self._receiver_input(encoded, device_unpack=False)
        with span("cgic.codec.dispatch", stats, "b_h2d_dispatch_s"):
            out = self._decode(self._upload(buf), mode, *hl_wl, out_uint8)
        if stats is not None:
            stats["b_h2d_bytes"] = stats.get("b_h2d_bytes", 0.0) + buf.nbytes
        return out

    @torch.no_grad()
    def decode_batch_device_async(self, encoded: List[EncodedImage], *,
                                  out_uint8: bool = False,
                                  stats: Optional[dict] = None
                                  ) -> torch.Tensor:
        """The device-unpack receiver (see decode_batch): the flat stream
        upload and the device decode, dispatched without waiting. Returns
        the device tensor [N, H, W, 3]. `stats` accumulates 'b_rebuild_s'
        (the flat buffer's framing), 'b_h2d_dispatch_s' and 'b_h2d_bytes'
        (the flat words and the offset table)."""
        if self._decode_tables is None:
            raise ValueError("this codec's Huffman table is not "
                             "device-decodable (code lengths outside "
                             "[1, MAX_LUT_BITS]); use decode_batch_async")
        mode, hl_wl = self._batch_layout(encoded)
        with span("cgic.coding.rebuild", stats, "b_rebuild_s",
                  images=len(encoded)):
            flat, offs = self._receiver_input(encoded, device_unpack=True)
        with span("cgic.codec.dispatch", stats, "b_h2d_dispatch_s"):
            out = self._decode_unpack(self._upload(flat), self._upload(offs),
                                      mode, *hl_wl, out_uint8)
        if stats is not None:
            stats["b_h2d_bytes"] = (stats.get("b_h2d_bytes", 0.0)
                                    + flat.nbytes + offs.nbytes)
        return out

    def roundtrip_pipelined(self, batches, coarse_ratio: float,
                            medium_ratio: float, *,
                            device_pack: bool = False,
                            out_uint8: bool = False,
                            device_unpack: bool = False,
                            threads: Optional[bool] = None
                            ) -> Tuple[List[np.ndarray],
                                       List[List[EncodedImage]]]:
        """The full codec over a sequence of same-shape image batches, as
        three stages a batch (pipeline.run_stages): a uploads and dispatches
        the encode, b frames the streams (the host entropy stage) and
        dispatches the receiver, c fetches the reconstruction. The results
        equal encode_batch / decode_batch per batch; only the schedule
        differs.

        threads=None: threaded when the codec's device is CUDA. Threaded,
        stage a runs on this thread and b and c on a worker each, with
        queues of two batches between them, so that the host entropy stage
        of batch i runs beside the device's encode of batch i+1 (the C++
        coder releases the interpreter lock); otherwise a, b and c run in
        turn, batch by batch. device_unpack=True decodes through the device
        receiver (decode_batch_device_async) where the table allows.

        A call is a request's root span, cgic.codec.roundtrip. After the
        call, self.last_pipeline_stats holds each stage's summed seconds and
        bytes (a_upload_s, b_sync_s, b_fetch_s, b_frame_s,
        b_rebuild_s, b_h2d_dispatch_s, b_h2d_bytes, c_sync_s, c_fetch_s,
        wall_s, threaded, device_unpack); the stage sums against wall_s say
        how much the stages overlapped.

        Returns (reconstructions per batch, bundles per batch)."""
        batches = list(batches)
        n = len(batches)
        if threads is None:
            threads = self.device.type == "cuda"
        engaged = self._unpack_engaged(device_unpack)
        dec_async = (self.decode_batch_device_async if engaged
                     else self.decode_batch_async)
        recs: List[Optional[np.ndarray]] = [None] * n
        encs_all: List[Optional[List[EncodedImage]]] = [None] * n
        stats = defaultdict(float)   # each stage writes its own keys
        stats["device_unpack"] = float(engaged)
        root = span("cgic.codec.roundtrip", stats, "wall_s", batches=n,
                    images=sum(len(b) for b in batches))

        def stage_a(i):
            with span("cgic.pipe.a", stats, "a_upload_s", parent=root,
                      batch=i, bytes=batches[i].nbytes):
                pend = self.encode_batch_async(batches[i], coarse_ratio,
                                               medium_ratio,
                                               device_pack=device_pack)
            stats["a_upload_bytes"] += batches[i].nbytes
            return pend

        def stage_b(i, pend):
            with torch.no_grad(), span("cgic.pipe.b", parent=root, batch=i):
                encs = self.encode_finish(pend, stats=stats)
                return encs, _Fetch(dec_async(encs, out_uint8=out_uint8,
                                              stats=stats))

        def stage_c(i, b):
            encs, rec = b
            with span("cgic.pipe.c", parent=root, batch=i):
                encs_all[i] = encs
                rec.sync(stats, "c_sync_s")
                recs[i] = rec.arrays(stats, "c_fetch_s")[0]

        try:
            with root:
                run_stages(n, stage_a, stage_b, stage_c, root=root,
                           threads=threads, depth=2, stats=stats)
        finally:
            self.last_pipeline_stats = dict(stats)
        return recs, encs_all

    # ------------------------------------------------------------ round-trip

    def compress(self, image: np.ndarray, coarse_ratio: float,
                 medium_ratio: float, out_dir: Optional[str] = None, *,
                 device_pack: bool = False, stats: Optional[dict] = None
                 ) -> Tuple[np.ndarray, float, EncodedImage]:
        """Sender -> receiver round trip, through stream files in `out_dir`
        when given: a request's root span, cgic.codec.compress. `stats`
        accumulates encode's and decode_batch's keys and 'files_s'. Returns
        (reconstruction [H, W, 3], bpp, bundle)."""
        with span("cgic.codec.compress", images=1):
            encoded = self.encode(image, coarse_ratio, medium_ratio,
                                  device_pack=device_pack, stats=stats)
            if out_dir is not None:
                with span("cgic.codec.files", stats, "files_s",
                          bytes=encoded.num_bytes):
                    encoded.write(out_dir)
                    encoded = EncodedImage.read(out_dir, encoded.mode,
                                                encoded.latent_hw,
                                                encoded.image_hw)
            rec = self.decode(encoded, stats=stats)
        return rec, encoded.bpp, encoded
