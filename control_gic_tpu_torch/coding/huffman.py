"""Huffman index-stream codec with the reference's byte-exact framing
(port of control_gic_tpu/coding/huffman.py).

The tree is built as the reference builds it: nodes pushed into a binary
heap in table order with `<` comparing frequency only (Python's heapq, so
ties resolve by heap mechanics), repeated two-smallest merges, then a
right-first DFS assigning '0' left and '1' right. Every symbol in the table
gets a code, zero-frequency ones included, so codes can run past 256 bits.

The per-image work (packing code bits, walking the decode trie) runs in the
C++ coder (native/entropy_codec.cpp, `native_lib`) when it builds, with the
pure-Python path as the fallback and the oracle of the tests.

Frame: one pad-count byte (1..8; a byte-aligned payload still takes 8 pad
bits), then the MSB-first code bits zero-padded. An empty symbol stream
encodes to b"" and decodes to None.
"""
from __future__ import annotations

import heapq
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np

from .native_lib import get_native


class _Node:
    __slots__ = ("sym", "freq", "left", "right")

    def __init__(self, sym, freq):
        self.sym = sym
        self.freq = freq
        self.left = None
        self.right = None

    def __lt__(self, other):
        return self.freq < other.freq


def build_huffman_codes(frequencies: Mapping[int, int]) -> Dict[int, str]:
    """Symbol -> bitstring code. The iteration order of `frequencies` is the
    heap insertion order."""
    heap: List[_Node] = []
    for sym, freq in frequencies.items():
        heapq.heappush(heap, _Node(int(sym), int(freq)))
    if not heap:
        return {}
    if len(heap) == 1:
        return {heap[0].sym: ""}   # the reference gives a lone root ""
    while len(heap) > 1:
        a = heapq.heappop(heap)
        b = heapq.heappop(heap)
        merged = _Node(None, a.freq + b.freq)
        merged.left = a
        merged.right = b
        heapq.heappush(heap, merged)
    codes: Dict[int, str] = {}
    stack = [(heap[0], "")]
    while stack:
        node, code = stack.pop()
        if node is None:
            continue
        if node.sym is not None:
            codes[node.sym] = code
        stack.append((node.right, code + "1"))
        stack.append((node.left, code + "0"))
    return codes


def frame_bits(bits: str) -> bytes:
    """Pad-header framing shared by index and mask streams."""
    pad = 8 - len(bits) % 8
    bits = f"{pad:08b}" + bits + "0" * pad
    return np.packbits(
        np.frombuffer(bits.encode("ascii"), np.uint8) - ord("0")).tobytes()


def unframe_bits(data: bytes) -> Optional[np.ndarray]:
    """Payload bits of a frame as a uint8 0/1 array; None for b""."""
    if len(data) == 0:
        return None
    arr = np.unpackbits(np.frombuffer(data, np.uint8))
    pad = int(np.packbits(arr[:8])[0])
    payload = arr[8:]
    return payload[:len(payload) - pad]


class HuffmanCodec:
    """Encode/decode int symbol streams with a fixed code table."""

    MAX_CODE_BYTES = 32  # the C++ encoder's code stride: codes up to 256 bits

    def __init__(self, frequencies: Mapping[int, int]):
        self.codes = build_huffman_codes(frequencies)
        self.n_sym = (max(self.codes) + 1) if self.codes else 0
        self._native = get_native()
        self._lut = None  # the C++ decoder's LUT, built at the first decode
        self._prepare_tables()

    @classmethod
    def from_counts(cls, counts: Sequence[int]) -> "HuffmanCodec":
        """The table the reference builds at run time from its codebook
        counters, an nn.ParameterDict whose keys are iterated in
        LEXICOGRAPHIC order of the stringified symbol ("0", "1", "10", ...);
        heap ties depend on that order."""
        items = sorted((str(i), int(c)) for i, c in enumerate(counts))
        return cls({int(k): v for k, v in items})

    def _prepare_tables(self):
        """lens [n] uint16, code_bytes [n, code_stride] (MSB-first) and the
        flat decode trie: trie[2*node + bit] is a child node >= 0, ~symbol
        (< 0) at a leaf, or INT32_MIN where no code goes."""
        max_len = max((len(c) for c in self.codes.values()), default=0)
        # a table with a long zero tail (every codebook entry goes to the
        # heap) chains codes past the C++ encoder's 32-byte stride: size the
        # table to the longest code and encode through Python then
        self.code_stride = max(self.MAX_CODE_BYTES, (max_len + 7) // 8)
        self.lens = np.zeros(self.n_sym, np.uint16)
        self.code_bytes = np.zeros((self.n_sym, self.code_stride), np.uint8)
        for sym, code in self.codes.items():
            self.lens[sym] = len(code)
            for i, bit in enumerate(code):
                if bit == "1":
                    self.code_bytes[sym, i >> 3] |= 0x80 >> (i & 7)
        empty = np.iinfo(np.int32).min
        nodes = [[empty, empty]]
        for sym, code in self.codes.items():
            cur = 0
            for i, bit in enumerate(code):
                b = int(bit)
                if i == len(code) - 1:
                    nodes[cur][b] = ~sym
                else:
                    if nodes[cur][b] == empty:
                        nodes.append([empty, empty])
                        nodes[cur][b] = len(nodes) - 1
                    cur = nodes[cur][b]
        self.trie = np.asarray(nodes, np.int32).reshape(-1)

    def encode(self, symbols) -> bytes:
        symbols = np.asarray(symbols, np.int32).reshape(-1)
        if symbols.size == 0:
            return b""
        if self._native is not None and \
                self.code_stride == self.MAX_CODE_BYTES:
            out = self._native.huff_encode(symbols, self.lens,
                                           self.code_bytes)
            if out is not None:
                return out
        return self.encode_python(symbols)

    def encode_python(self, symbols) -> bytes:
        """The pure-Python encoder (the fallback, and the tests' oracle)."""
        return frame_bits("".join(self.codes[int(s)]
                                  for s in np.asarray(symbols).reshape(-1)))

    def decode(self, data: bytes) -> Optional[List[int]]:
        """None for an empty stream (the reference's contract)."""
        out = self.decode_array(data)
        return None if out is None else out.tolist()

    def decode_array(self, data: bytes) -> Optional[np.ndarray]:
        """decode() as an int32 array, without building a list (the
        receiver scatters the symbols straight into its grids)."""
        if len(data) == 0:
            return None
        if self._native is not None:
            if self._lut is None:
                self._lut = self._native.huff_build_lut(self.trie)
            out = self._native.huff_decode(data, self.trie, self._lut)
            if out is not None:
                return out
        return self.decode_python(data)

    def decode_python(self, data: bytes) -> Optional[np.ndarray]:
        """The pure-Python decoder: a bit-by-bit trie walk."""
        bits = unframe_bits(data)
        if bits is None:
            return None
        out: List[int] = []
        trie = self.trie.tolist()
        empty = np.iinfo(np.int32).min
        node = 0
        for b in bits.tolist():
            nxt = trie[2 * node + b]
            if nxt == empty:
                raise ValueError("bitstream holds a code outside the table")
            if nxt < 0:
                out.append(~nxt)
                node = 0
            else:
                node = nxt
        return np.asarray(out, np.int32)
