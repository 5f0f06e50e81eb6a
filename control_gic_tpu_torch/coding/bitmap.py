"""Grain-mask bitmap codec: one bit per element in the Huffman streams' frame
format (port of control_gic_tpu/coding/bitmap.py, pure-Python path)."""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from .huffman import unframe_bits


class BitmapCodec:
    def encode(self, bits) -> bytes:
        """bits: array-like of 0/1. Empty -> b""."""
        arr = np.asarray(bits).reshape(-1).astype(np.uint8)
        if arr.size == 0:
            return b""
        pad = 8 - arr.size % 8
        framed = np.concatenate([np.unpackbits(np.array([pad], np.uint8)),
                                 arr, np.zeros(pad, np.uint8)])
        return np.packbits(framed).tobytes()

    def decode(self, data: bytes) -> Optional[List[int]]:
        bits = unframe_bits(data)
        return None if bits is None else bits.astype(int).tolist()
