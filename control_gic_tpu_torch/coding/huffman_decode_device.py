"""Receiver-side stream helpers (port of the frame helpers of
control_gic_tpu/coding/huffman_decode_tpu.py): the mask bitmap unpacked on
the device, and the host inversion of the frame format into MSB-first
uint32 words. JAX's device Huffman decoders (the LUT walk and its list
ranking) are not ported yet (ROADMAP queue 1 item 11b)."""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def bitmap_decode_bits(payload: torch.Tensor, n: int) -> torch.Tensor:
    """Unpack n bits (one an element, MSB-first: the mask frame's body) from
    32-bit words [..., nw] (int32 or uint32 bits) to [..., n] int32."""
    p = torch.arange(n, device=payload.device)
    w = payload.to(torch.int64)[..., p >> 5]
    return ((w >> (31 - (p & 31))) & 1).to(torch.int32)


def frame_body_words(frame: bytes) -> Tuple[np.ndarray, int]:
    """Host: the frame without its pad header as MSB-first uint32 words (the
    big-endian byte swap of the body) and its total bits; the inverse of
    frame_from_words."""
    if len(frame) == 0:
        return np.zeros(0, np.uint32), 0
    pad = frame[0]
    if not 1 <= pad <= 8:
        raise ValueError(f"bad frame header: pad {pad}")
    body = frame[1:]
    total_bits = len(body) * 8 - pad
    raw = body + b"\x00" * (-len(body) % 4)
    return np.frombuffer(raw, np.uint32).byteswap(), total_bits


def words_from_frame(frame: bytes, cap_words: int) -> Tuple[np.ndarray, int]:
    """frame_body_words zero-padded to [cap_words]."""
    words, total_bits = frame_body_words(frame)
    if words.size > cap_words:
        raise ValueError(f"frame holds {words.size} words, more than its "
                         f"capacity {cap_words}")
    out = np.zeros(cap_words, np.uint32)
    out[:words.size] = words
    return out, total_bits
