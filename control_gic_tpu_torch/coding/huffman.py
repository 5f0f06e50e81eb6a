"""Huffman index-stream codec with the reference's byte-exact framing
(port of control_gic_tpu/coding/huffman.py, pure-Python path).

The tree is built as the reference builds it: nodes pushed into a binary
heap in table order with `<` comparing frequency only (Python's heapq, so
ties resolve by heap mechanics), repeated two-smallest merges, then a
right-first DFS assigning '0' left and '1' right. Every symbol in the table
gets a code, zero-frequency ones included, so codes can run past 256 bits.

Frame: one pad-count byte (1..8; a byte-aligned payload still takes 8 pad
bits), then the MSB-first code bits zero-padded. An empty symbol stream
encodes to b"" and decodes to None.
"""
from __future__ import annotations

import heapq
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np


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

    def __init__(self, frequencies: Mapping[int, int]):
        self.codes = build_huffman_codes(frequencies)
        # decode trie: trie[node] = [child0, child1]; a child >= 0 is a node,
        # ~symbol (< 0) a leaf, None unreachable
        self._trie: List[list] = [[None, None]]
        for sym, code in self.codes.items():
            cur = 0
            for i, bit in enumerate(code):
                b = bit == "1"
                if i == len(code) - 1:
                    self._trie[cur][b] = ~sym
                else:
                    if self._trie[cur][b] is None:
                        self._trie.append([None, None])
                        self._trie[cur][b] = len(self._trie) - 1
                    cur = self._trie[cur][b]

    @classmethod
    def from_counts(cls, counts: Sequence[int]) -> "HuffmanCodec":
        """The table the reference builds at run time from its codebook
        counters, an nn.ParameterDict whose keys are iterated in
        LEXICOGRAPHIC order of the stringified symbol ("0", "1", "10", ...);
        heap ties depend on that order."""
        items = sorted((str(i), int(c)) for i, c in enumerate(counts))
        return cls({int(k): v for k, v in items})

    def encode(self, symbols) -> bytes:
        symbols = np.asarray(symbols).reshape(-1)
        if symbols.size == 0:
            return b""
        return frame_bits("".join(self.codes[int(s)] for s in symbols))

    def decode(self, data: bytes) -> Optional[List[int]]:
        """None for an empty stream (the reference's contract)."""
        out = self.decode_array(data)
        return None if out is None else out.tolist()

    def decode_array(self, data: bytes) -> Optional[np.ndarray]:
        bits = unframe_bits(data)
        if bits is None:
            return None
        out: List[int] = []
        trie = self._trie
        node = 0
        for b in bits.tolist():
            nxt = trie[node][b]
            if nxt is None:
                raise ValueError("bitstream holds a code outside the table")
            if nxt < 0:
                out.append(~nxt)
                node = 0
            else:
                node = nxt
        return np.asarray(out, np.int64)
