"""Batched stream extraction and entropy packing on the device (port of
control_gic_tpu/coding/stream_pack.py, in torch tensor ops).

After the encoder the sender's work stays on the device:
  1. subsample the fine index grid at each grain's stride,
  2. front-compact the masked symbols in row-major order (the order of a
     stable argsort of the inverted mask, which is numpy's boolean-gather
     order),
  3. Huffman-pack every stream with huffman_device's parallel-prefix packer,
     the masks too: a bitmap is the table {0: '0', 1: '1'},
  4. fuse every stream's words and bit counts into one buffer per batch,
     so that the host makes one fetch and frames bytes (fused_to_bytes).

Streams keep static shapes through fixed capacities (the whole subsampled
grid) and counts. The frames equal HuffmanCodec's and BitmapCodec's byte for
byte.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from .huffman_device import frame_from_words, pack_bits_i64

# the streams each mode sends (the codec's MODE_STREAMS, kept here so that
# this module needs nothing of the codec)
_MODE_STREAMS = {
    0: ("indices_coarse", "indices_medium", "indices_fine",
        "mask_coarse", "mask_medium"),
    1: ("indices_medium", "indices_fine", "mask_medium"),
    2: ("indices_coarse", "indices_fine", "mask_coarse"),
    3: ("indices_coarse", "indices_medium", "mask_coarse"),
    4: ("indices_coarse",),
    5: ("indices_medium",),
    6: ("indices_fine",),
}


def compact_masked(values: torch.Tensor, mask: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Front-pack values[..., mask == 1] in row-major order.

    values / mask: [..., N]. Returns (compacted [..., N]: the selected
    values first, then the others, each in their original order, as a
    stable argsort of 1 - mask orders them; count [...] int32). Each
    element's place is its rank among its kind (a prefix sum), so no sort
    runs."""
    keep = (mask == 1).long()
    count = keep.sum(-1, keepdim=True)
    rank_kept = torch.cumsum(keep, -1) - 1
    rank_rest = torch.cumsum(1 - keep, -1) - 1 + count
    dest = torch.where(keep == 1, rank_kept, rank_rest)
    out = torch.empty_like(values).scatter_(-1, dest, values)
    return out, count[..., 0].to(torch.int32)


def pack_streams_batch(ind: torch.Tensor, masks, mode: int, lens, words,
                       max_code_len: int):
    """The device half of the sender: index grid + masks -> packed words.

    ind: [B, Hl, Wl] integer fine-grid indices; masks: (mask_coarse
    [B, Hl/4, Wl/4], mask_medium [B, Hl/2, Wl/2], mask_fine [B, Hl, Wl]);
    mode: the static mode 0..6; lens / words: the pack_tables tables (or
    int64 tensors on ind's device), codes <= 32 bits; max_code_len:
    int(lens.max()).

    Returns {stream: (payload [B, max_words] uint32, total_bits [B]
    int32)} for the streams the mode sends."""
    m_c, m_m, m_f = masks
    b = ind.shape[0]
    dev = ind.device
    lens = torch.as_tensor(np.asarray(lens) if isinstance(lens, np.ndarray)
                           else lens, device=dev).long()
    words = torch.as_tensor(np.asarray(words, np.int64)
                            if isinstance(words, np.ndarray) else words,
                            device=dev).long()
    max_len = max(int(max_code_len), 1)
    present = _MODE_STREAMS[mode]
    out: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}

    def pack(sym, count, tl, tw, mw):
        payload, bits = pack_bits_i64(sym, count, tl, tw, mw)
        return payload.to(torch.uint32), bits.to(torch.int32)

    def index_stream(grid: torch.Tensor, mask):
        sym = grid.reshape(b, -1)
        n = sym.shape[-1]
        if mask is None:   # modes 4/5/6: the whole grid is one stream
            count = torch.full((b,), n, dtype=torch.int64, device=dev)
        else:
            sym, count = compact_masked(sym, mask.reshape(b, -1))
        return pack(sym, count, lens, words, (n * max_len + 31) // 32 + 1)

    bitmap_lens = torch.ones(2, dtype=torch.int64, device=dev)
    bitmap_words = torch.arange(2, dtype=torch.int64, device=dev)

    def bitmap_stream(mask: torch.Tensor):
        sym = mask.reshape(b, -1)
        n = sym.shape[-1]
        return pack(sym, torch.full((b,), n, dtype=torch.int64, device=dev),
                    bitmap_lens, bitmap_words, (n + 31) // 32 + 1)

    if "indices_coarse" in present:
        out["indices_coarse"] = index_stream(
            ind[:, ::4, ::4], m_c if mode != 4 else None)
    if "indices_medium" in present:
        out["indices_medium"] = index_stream(
            ind[:, ::2, ::2], m_m if mode != 5 else None)
    if "indices_fine" in present:
        out["indices_fine"] = index_stream(ind, m_f if mode != 6 else None)
    if "mask_coarse" in present:
        out["mask_coarse"] = bitmap_stream(m_c)
    if "mask_medium" in present:
        out["mask_medium"] = bitmap_stream(m_m)
    return out


def streams_to_bytes(packed: Dict[str, Tuple[np.ndarray, np.ndarray]],
                     i: int) -> Dict[str, bytes]:
    """Frame image i's streams from fetched (payload, bits) arrays."""
    return {name: frame_from_words(np.asarray(p[i]), int(bits[i]))
            for name, (p, bits) in packed.items()}


# ------------------------------------------------ the fused one-fetch form

def fused_layout(mode: int, hl: int, wl: int, max_code_len: int):
    """The fused buffer's static word layout for one mode:
    [(stream, word offset, words), ...] in _MODE_STREAMS order, with
    pack_streams_batch's capacities (index streams ceil(n * max_code_len /
    32) + 1 words, bitmaps ceil(n / 32) + 1)."""
    max_len = max(int(max_code_len), 1)
    sizes = {
        "indices_coarse": ((hl // 4) * (wl // 4) * max_len + 31) // 32 + 1,
        "indices_medium": ((hl // 2) * (wl // 2) * max_len + 31) // 32 + 1,
        "indices_fine": (hl * wl * max_len + 31) // 32 + 1,
        "mask_coarse": ((hl // 4) * (wl // 4) + 31) // 32 + 1,
        "mask_medium": ((hl // 2) * (wl // 2) + 31) // 32 + 1,
    }
    out = []
    off = 0
    for name in _MODE_STREAMS[mode]:
        out.append((name, off, sizes[name]))
        off += sizes[name]
    return out


def fuse_packed(packed: Dict[str, Tuple[torch.Tensor, torch.Tensor]],
                mode: int) -> torch.Tensor:
    """pack_streams_batch's output as ONE uint32 buffer [B, total_words +
    n_streams]: every stream's payload words, then a tail word per stream
    with its bit count. The host fetches it once per batch."""
    names = _MODE_STREAMS[mode]
    bits = torch.stack([packed[n][1].long() for n in names], -1)
    return torch.cat([packed[n][0].long() for n in names] + [bits],
                     -1).to(torch.uint32)


def fused_to_bytes(buf: np.ndarray, layout, i: int) -> Dict[str, bytes]:
    """Frame image i's streams from the fetched fused buffer (payload words,
    then the bit-count tail; see fuse_packed)."""
    total = layout[-1][1] + layout[-1][2]
    return {name: frame_from_words(buf[i, off:off + nw],
                                   int(buf[i, total + k]))
            for k, (name, off, nw) in enumerate(layout)}
