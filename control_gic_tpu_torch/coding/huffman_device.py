"""Huffman encoding on the device as a parallel prefix scan (port of
control_gic_tpu/coding/huffman_tpu.py, in torch tensor ops):

  1. gather each symbol's code length and right-aligned codeword,
  2. exclusive prefix sum of the lengths: each symbol's bit offset,
  3. a code of at most 32 bits touches at most two 32-bit output words:
     split it into the part in its first word and the part in the next,
     each shifted to its place, and scatter-add both halves into the word
     buffer (the bits are disjoint, so the sum is an OR),
  4. the host byte-swaps the words to the frame's big-endian bit order.

The arithmetic runs in int64 (PyTorch's uint32 has no shifts or scatters);
every value is below 2^32, and the result is cast to uint32 at the end.
Ragged streams keep static shapes: a fixed capacity n and a count of valid
symbols, the tail contributing no bits. The frame equals
HuffmanCodec.encode's byte for byte. Codes above 32 bits (degenerate tables
only) are not supported here: `supports_table` says so, and callers use the
host coder then.
"""
from __future__ import annotations

from typing import Tuple, Union

import numpy as np
import torch


def pack_tables(codes: dict) -> Tuple[np.ndarray, np.ndarray]:
    """HuffmanCodec.codes ({symbol: bitstring}) -> (lens [n] int32,
    words [n] uint32 right-aligned)."""
    n = max(codes) + 1 if codes else 0
    lens = np.zeros(n, np.int32)
    words = np.zeros(n, np.uint32)
    for sym, code in codes.items():
        if len(code) > 32:
            raise ValueError(f"code of symbol {sym} has {len(code)} bits; "
                             "the device packer takes at most 32")
        lens[sym] = len(code)
        words[sym] = int(code, 2) if code else 0
    return lens, words


def supports_table(codes: dict) -> bool:
    return all(len(c) <= 32 for c in codes.values())


def _shl(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """x << s, and 0 where s >= 32 (as a 32-bit shift would be)."""
    return torch.where(s >= 32, 0, x << s.clamp(max=31))


def _shr(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    return torch.where(s >= 32, 0, x >> s.clamp(max=31))


def pack_bits_i64(symbols: torch.Tensor, count: torch.Tensor,
                  lens: torch.Tensor, words: torch.Tensor, max_words: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """huffman_pack_bits in int64, without the final casts: payload
    [..., max_words] int64 (each < 2^32) and total_bits [...] int64.
    lens / words: int64 tensors on symbols' device."""
    n = symbols.shape[-1]
    valid = torch.arange(n, device=symbols.device) < count[..., None]
    sym = torch.where(valid, symbols.long(), 0)
    l = torch.where(valid, lens[sym], 0)
    c = torch.where(valid, words[sym], 0)

    offsets = torch.cumsum(l, -1) - l                  # exclusive scan
    total_bits = l.sum(-1)
    word_idx = offsets >> 5
    bitpos = offsets & 31
    # the code covers bits [bitpos, bitpos + l) of a 64-bit window that
    # starts at word_idx, MSB first
    bits_hi = torch.minimum(32 - bitpos, l)            # bits in word 0
    bits_lo = l - bits_hi                              # bits in word 1
    mask_lo = torch.where(bits_lo >= 32, 0xFFFFFFFF,
                          _shl(torch.ones_like(bits_lo), bits_lo) - 1)
    hi = _shl(_shr(c, bits_lo), 32 - bitpos - bits_hi)
    lo = _shl(c & mask_lo, 32 - bits_lo)

    # disjoint bits: a sum is an OR (integer adds, so the order is free);
    # the tail's zero-bit codes may index one word past the capacity
    payload = torch.zeros(symbols.shape[:-1] + (max_words + 2,),
                          dtype=torch.int64, device=symbols.device)
    payload.scatter_add_(-1, torch.cat([word_idx, word_idx + 1], -1),
                         torch.cat([hi, lo], -1))
    return payload[..., :max_words], total_bits


def huffman_pack_bits(symbols: torch.Tensor,
                      count: Union[int, torch.Tensor],
                      lens, words, max_words: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pack `count` valid symbols into 32-bit words on symbols' device.

    symbols: [..., n] integer (entries at or past count are ignored);
    count: [...] (or an int); lens / words: the pack_tables tables;
    max_words: the output capacity (>= ceil(n * max_code_len / 32)).

    Returns (payload [..., max_words] uint32, MSB-first bit order in each
    word, and total_bits [...] int32)."""
    dev = symbols.device
    count = torch.as_tensor(count, device=dev)
    lens = torch.as_tensor(np.asarray(lens), device=dev).long()
    words = torch.as_tensor(np.asarray(words, np.int64), device=dev)
    payload, total = pack_bits_i64(symbols, count, lens, words, max_words)
    return payload.to(torch.uint32), total.to(torch.int32)


def frame_from_words(payload: np.ndarray, total_bits: int) -> bytes:
    """The reference frame (host): pad header + payload bytes. payload:
    uint32 words (or int32 of the same bits)."""
    total_bits = int(total_bits)
    if total_bits == 0:
        return b""
    pad = 8 - total_bits % 8           # 1..8 (the reference's rule)
    nbytes = (total_bits + pad) // 8
    raw = np.asarray(payload).view(np.uint32).byteswap().tobytes()
    return bytes([pad]) + raw[:nbytes]


def encode_on_device(symbols, lens: np.ndarray, words: np.ndarray,
                     device: Union[str, torch.device] = "cuda") -> bytes:
    """One stream packed on `device` and framed on the host; equal to
    HuffmanCodec.encode byte for byte."""
    symbols = np.asarray(symbols, np.int32).reshape(-1)
    if symbols.size == 0:
        return b""
    n = symbols.size
    max_words = (n * int(lens.max() if lens.size else 1) + 31) // 32 + 2
    payload, total_bits = huffman_pack_bits(
        torch.from_numpy(symbols).to(device), n, lens, words, max_words)
    return frame_from_words(payload.cpu().numpy(), int(total_bits))
