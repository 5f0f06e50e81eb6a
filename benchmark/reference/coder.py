"""The plain reference of Control-GIC's stream coder (numpy).

The Huffman table is built as the reference code builds it from its
codebook counters: symbols taken in the lexicographic order of their
decimal strings ("0", "1", "10", ...), pushed into Python's binary heap
compared by frequency alone, the two smallest merged until one tree is
left, then '0' to the left and '1' to the right. Every symbol gets a code,
zero counts included.

A frame is one pad-count byte (1-8: a whole payload still takes 8 pad bits)
then the payload bits MSB first, zero-padded to a byte. An empty stream is
b"". Index streams are the Huffman codes of the indices a grain's mask
selects, in row-major order on that grain's grid; mask streams are the
masks' bits. Which streams a compression mode sends is `MODE_STREAMS`; the
fine mask is never sent (it is what coarse and medium leave).
"""
from __future__ import annotations

import heapq
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

MODE_STREAMS = {
    0: ("indices_coarse", "indices_medium", "indices_fine", "mask_coarse",
        "mask_medium"),
    1: ("indices_medium", "indices_fine", "mask_medium"),
    2: ("indices_coarse", "indices_fine", "mask_coarse"),
    3: ("indices_coarse", "indices_medium", "mask_coarse"),
    4: ("indices_coarse",),
    5: ("indices_medium",),
    6: ("indices_fine",),
}


class StreamError(ValueError):
    """A stream that does not decode to what its mask selects."""


class _Node:
    __slots__ = ("sym", "freq", "left", "right")

    def __init__(self, sym, freq, left=None, right=None):
        self.sym, self.freq, self.left, self.right = sym, freq, left, right

    def __lt__(self, other):
        return self.freq < other.freq


def huffman_codes(counts: Sequence[int]) -> Dict[int, str]:
    """symbol -> code string, from the codebook's usage counts."""
    heap: List[_Node] = []
    for key in sorted(str(i) for i in range(len(counts))):
        heapq.heappush(heap, _Node(int(key), int(counts[int(key)])))
    if len(heap) == 1:
        return {heap[0].sym: ""}
    while len(heap) > 1:
        a, b = heapq.heappop(heap), heapq.heappop(heap)
        heapq.heappush(heap, _Node(None, a.freq + b.freq, a, b))
    codes: Dict[int, str] = {}
    stack = [(heap[0], "")]
    while stack:
        node, code = stack.pop()
        if node.sym is not None:
            codes[node.sym] = code
            continue
        stack.append((node.right, code + "1"))
        stack.append((node.left, code + "0"))
    return codes


def frame(bits: np.ndarray) -> bytes:
    """0/1 payload bits -> a frame; b"" for no bits."""
    bits = np.asarray(bits, np.uint8).reshape(-1)
    if bits.size == 0:
        return b""
    pad = 8 - bits.size % 8
    head = np.unpackbits(np.array([pad], np.uint8))
    return np.packbits(np.concatenate(
        [head, bits, np.zeros(pad, np.uint8)])).tobytes()


def unframe(data: bytes) -> np.ndarray:
    """A frame -> its payload bits (uint8 0/1); empty for b""."""
    if len(data) == 0:
        return np.zeros(0, np.uint8)
    bits = np.unpackbits(np.frombuffer(data, np.uint8))
    pad = int(np.packbits(bits[:8])[0])
    if not 1 <= pad <= 8 or bits.size - 8 < pad:
        raise StreamError(f"bad pad count {pad}")
    return bits[8:bits.size - pad]


class Coder:
    """Encodes and decodes index and mask streams with one Huffman table."""

    def __init__(self, counts: Sequence[int]):
        self.codes = huffman_codes(counts)
        self.n_sym = len(counts)
        self.max_len = max(len(c) for c in self.codes.values())
        # the code bits of each symbol, for encoding
        self._bits = [np.frombuffer(self.codes[s].encode(), np.uint8) - 48
                      for s in range(self.n_sym)]
        # decode table over max_len-bit windows: symbol and length
        L = self.max_len
        self._sym = np.full(1 << L, -1, np.int64)
        self._len = np.zeros(1 << L, np.int64)
        for s, c in self.codes.items():
            lo = int(c, 2) << (L - len(c)) if c else 0
            hi = lo + (1 << (L - len(c)))
            self._sym[lo:hi] = s
            self._len[lo:hi] = len(c)

    def encode(self, symbols) -> bytes:
        symbols = np.asarray(symbols).reshape(-1)
        if symbols.size == 0:
            return b""
        return frame(np.concatenate([self._bits[int(s)] for s in symbols]))

    def decode(self, data: bytes) -> np.ndarray:
        """A Huffman frame -> its symbols; raises StreamError on bits that
        are not a whole number of codes."""
        bits = unframe(data)
        if bits.size == 0:
            return np.zeros(0, np.int64)
        L = self.max_len
        padded = np.concatenate([bits, np.zeros(L, np.uint8)]).astype(np.int64)
        windows = np.lib.stride_tricks.sliding_window_view(padded, L)[
            :bits.size] @ (1 << np.arange(L - 1, -1, -1))
        sym_of, len_of = self._sym[windows], self._len[windows]
        out, pos, n = [], 0, bits.size
        while pos < n:
            ln = int(len_of[pos])
            if ln == 0 or pos + ln > n:
                raise StreamError("bits that are no code of the table")
            out.append(int(sym_of[pos]))
            pos += ln
        return np.asarray(out, np.int64)


def _up(m: np.ndarray, s: int) -> np.ndarray:
    return m.repeat(s, -2).repeat(s, -1)


def encode_streams(coder: Coder, ind: np.ndarray, masks, mode: int
                   ) -> Dict[str, bytes]:
    """One image's index grid [Hl, Wl] and masks (m_c, m_m, m_f) -> its
    streams: each grain samples the fine grid at its stride and keeps the
    positions its mask selects, row-major."""
    m_c, m_m, m_f = (np.asarray(m) for m in masks)
    grids = {"indices_coarse": (ind[::4, ::4], m_c),
             "indices_medium": (ind[::2, ::2], m_m),
             "indices_fine": (ind, m_f)}
    out = {}
    for name in MODE_STREAMS[mode]:
        if name.startswith("indices"):
            g, m = grids[name]
            out[name] = coder.encode(g[m == 1])
        else:
            m = m_c if name == "mask_coarse" else m_m
            out[name] = frame(m.reshape(-1))
    return out


def decode_streams(coder: Coder, streams: Dict[str, bytes], mode: int,
                   hl: int, wl: int) -> Tuple[np.ndarray, Tuple]:
    """Streams -> (index grid [Hl, Wl] int64, (m_c, m_m, m_f) int32), as
    the receiver rebuilds them. Raises StreamError where a stream is
    missing, a mask has the wrong size, or an index stream decodes to
    another number of symbols than its mask selects or to a symbol outside
    the codebook."""
    shapes = {"c": (hl // 4, wl // 4), "m": (hl // 2, wl // 2), "f": (hl, wl)}
    if set(streams) != set(MODE_STREAMS[mode]):
        raise StreamError(f"streams {sorted(streams)} for mode {mode}")

    def mask(name, shape):
        bits = unframe(streams[name])
        if bits.size != shape[0] * shape[1]:
            raise StreamError(f"{name}: {bits.size} bits for {shape}")
        return bits.astype(np.int32).reshape(shape)

    zeros = lambda k: np.zeros(shapes[k], np.int32)
    ones = lambda k: np.ones(shapes[k], np.int32)
    if mode == 0:
        m_c, m_m = mask("mask_coarse", shapes["c"]), mask("mask_medium",
                                                          shapes["m"])
        m_f = 1 - _up(m_m, 2) - _up(m_c, 4)
    elif mode == 1:
        m_m = mask("mask_medium", shapes["m"])
        m_c, m_f = zeros("c"), 1 - _up(m_m, 2)
    elif mode == 2:
        m_c = mask("mask_coarse", shapes["c"])
        m_m, m_f = zeros("m"), 1 - _up(m_c, 4)
    elif mode == 3:
        m_c = mask("mask_coarse", shapes["c"])
        m_m, m_f = 1 - _up(m_c, 2), zeros("f")
    else:
        m_c = ones("c") if mode == 4 else zeros("c")
        m_m = ones("m") if mode == 5 else zeros("m")
        m_f = ones("f") if mode == 6 else zeros("f")
    ind = np.zeros((hl, wl), np.int64)
    for name, m, s in (("indices_coarse", m_c, 4), ("indices_medium", m_m, 2),
                       ("indices_fine", m_f, 1)):
        if name not in streams:
            continue
        syms = coder.decode(streams[name])
        if syms.size != int(m.sum()):
            raise StreamError(f"{name}: {syms.size} symbols for "
                              f"{int(m.sum())} positions")
        if syms.size and not 0 <= syms.min() <= syms.max() < coder.n_sym:
            raise StreamError(f"{name}: a symbol outside the codebook")
        g = np.zeros(m.shape, np.int64)
        g[m == 1] = syms
        ind += _up(g, s)
    return ind, (m_c, m_m, m_f)
