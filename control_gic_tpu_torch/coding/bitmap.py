"""Grain-mask bitmap codec: one bit per element in the Huffman streams' frame
format (port of control_gic_tpu/coding/bitmap.py). The C++ coder does the
work when it builds; the pure-Python path is the fallback."""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from .huffman import unframe_bits
from .native_lib import get_native


class BitmapCodec:
    def __init__(self):
        self._native = get_native()

    def encode(self, bits) -> bytes:
        """bits: array-like of 0/1. Empty -> b""."""
        arr = np.asarray(bits).reshape(-1).astype(np.uint8)
        if arr.size == 0:
            return b""
        if self._native is not None:
            out = self._native.bitmap_encode(arr)
            if out is not None:
                return out
        return self.encode_python(arr)

    @staticmethod
    def encode_python(bits) -> bytes:
        arr = np.asarray(bits).reshape(-1).astype(np.uint8)
        if arr.size == 0:
            return b""
        pad = 8 - arr.size % 8
        framed = np.concatenate([np.unpackbits(np.array([pad], np.uint8)),
                                 arr, np.zeros(pad, np.uint8)])
        return np.packbits(framed).tobytes()

    def decode(self, data: bytes) -> Optional[List[int]]:
        if len(data) == 0:
            return None
        if self._native is not None:
            out = self._native.bitmap_decode(data)
            if out is not None:
                return out.tolist()
        return self.decode_python(data)

    @staticmethod
    def decode_python(data: bytes) -> Optional[List[int]]:
        bits = unframe_bits(data)
        return None if bits is None else bits.astype(int).tolist()
