"""Huffman decoding on the device, and the receiver's stream helpers (port of
control_gic_tpu/coding/huffman_decode_tpu.py).

The sender packs code bits with a prefix scan of the code lengths
(huffman_device.py); decoding is the inverse and is serial in its textbook
form, since symbol k's bit offset depends on every code before it. Two
decoders, as in the JAX package, both driven by a 2^L-entry table that maps
every L-bit window to (symbol, code length), L the longest code
(`build_decode_lut`):

  - `huffman_decode_bits` ("rank"): list ranking by pointer doubling. Peek
    the window at EVERY bit position p and set f(p) = p + its code length,
    the next symbol boundary if a code started at p; log2(n_cap * L) rounds
    of gathers give, for each p, the number of symbols from p to the end,
    C[p], and the orbit of bit 0 under f, which is the set of true symbol
    boundaries. Boundary p holds symbol C[0] - C[p]: one scatter, then one
    table gather. Dense tensor ops, a few dozen launches a stream.
  - `huffman_decode_bits_scan` ("scan"): the lock-step walk, one lane a
    stream, one symbol a step. JAX runs it as one lax.scan; here the plain
    version is a Python loop of tensor ops (the CPU's path and the tests'),
    and a CUDA tensor goes to a hand-written kernel
    (kernels/huffman_scan.cu), one thread a lane, with no fallback.

Words are MSB-first 32-bit words (the big-endian byte swap of a frame body,
`frame_body_words`), given as int32 (or uint32 bits) and carried as int64
masked to 32 bits, since PyTorch's uint32 has no shifts or gathers. A peek
at bit p reads words p >> 5 and p >> 5 + 1, so a payload holds one guard
word past the last position it is peeked at. Streams are taken as
well-formed: byte validation (count mismatches, CorruptStreamError) lives
in the host receiver. Tables need every code length in [1, MAX_LUT_BITS]
(`supports_decode_table`); others stay on the host receiver.
"""
from __future__ import annotations

from typing import Tuple, Union

import numpy as np
import torch

from ..kernels import build

# the table has 2^L entries: 2^20 int32 pairs are 8 MB on the device
MAX_LUT_BITS = 20

# Launches of the scan kernel in this process (one per call on a CUDA
# tensor); a caller resets it to 0 and reads it back.
KERNEL_LAUNCHES = build.counter({"huffman_scan": 0})

_MASK32 = 0xFFFFFFFF


def build_decode_lut(codes: dict) -> Tuple[np.ndarray, np.ndarray, int]:
    """HuffmanCodec.codes ({symbol: bitstring}) -> (lut_sym [2^L] int32,
    lut_len [2^L] int32, L): every L-bit window that starts with symbol s's
    code maps to (s, len(code)); a window no code starts gets length 1, so
    that f(p) always advances."""
    max_len = max((len(c) for c in codes.values()), default=0)
    if not 1 <= max_len <= MAX_LUT_BITS:
        raise ValueError(f"longest code has {max_len} bits; the decode table "
                         f"takes 1 to {MAX_LUT_BITS}")
    size = 1 << max_len
    lut_sym = np.zeros(size, np.int32)
    lut_len = np.ones(size, np.int32)
    for sym, code in codes.items():
        l = len(code)
        if l < 1:
            raise ValueError(f"symbol {sym} has an empty code")
        base = int(code, 2) << (max_len - l)
        lut_sym[base:base + (1 << (max_len - l))] = sym
        lut_len[base:base + (1 << (max_len - l))] = l
    return lut_sym, lut_len, max_len


def supports_decode_table(codes: dict) -> bool:
    return (len(codes) > 0
            and all(1 <= len(c) <= MAX_LUT_BITS for c in codes.values()))


def _words64(payload: torch.Tensor) -> torch.Tensor:
    """32-bit words (int32, uint32 bits or int64) -> int64 in [0, 2^32)."""
    return payload.to(torch.int64) & _MASK32


def _peek(w0: torch.Tensor, w1: torch.Tensor, bo: torch.Tensor,
          nbits: int) -> torch.Tensor:
    """The nbits-bit window at bit bo (0..31) of the word pair (w0, w1), as
    JAX's _shl/_shr compute it: bo == 0 reads nothing of w1."""
    window = ((w0 << bo) & _MASK32) | torch.where(bo == 0, 0, w1 >> (32 - bo))
    return window >> (32 - nbits)


def peek_windows(payload: torch.Tensor, positions: torch.Tensor,
                 nbits: int) -> torch.Tensor:
    """The nbits-bit window at each bit position: payload [..., W] words,
    positions [..., P] (the same leading dims) -> [..., P] int64."""
    words = _words64(payload)
    positions = positions.to(torch.int64)
    wi = positions >> 5
    return _peek(words.gather(-1, wi), words.gather(-1, wi + 1),
                 positions & 31, nbits)


def huffman_decode_bits(payload: torch.Tensor,
                        count: Union[torch.Tensor, int],
                        lut_sym: torch.Tensor, lut_len: torch.Tensor,
                        n_cap: int, max_len: int) -> torch.Tensor:
    """The rank decoder: `count` symbols from each packed stream.

    payload: [W] or [B, W] words, MSB-first, with a guard word past
      n_cap * max_len // 32 + 1 (W >= n_cap * max_len // 32 + 2).
    count: valid symbols (<= n_cap), a scalar or [B].
    lut_sym / lut_len: build_decode_lut's tables on payload's device.
    Returns [n_cap] or [B, n_cap] int32, 0 from each stream's count on.

    The order within a round is JAX's: the orbit marks first (a max-scatter
    through f), then the counts (c += c[f]), then f = f[f]."""
    single = payload.dim() == 1
    if single:
        payload = payload[None]
    dev = payload.device
    b = payload.shape[0]
    count = torch.as_tensor(count, device=dev).reshape(-1).expand(b)
    if n_cap == 0:
        out = torch.zeros((b, 0), dtype=torch.int32, device=dev)
        return out[0] if single else out
    t = n_cap * max_len                              # bit-position space
    p = torch.arange(t, device=dev).expand(b, t)
    step = lut_len.to(torch.int64)[peek_windows(payload, p, max_len)]
    # the successor f with sink t (f[t] = t), symbols from p, orbit of 0
    sink = torch.full((b, 1), t, dtype=torch.int64, device=dev)
    f = torch.cat([torch.clamp(p + step, max=t), sink], 1)
    c = torch.ones((b, t + 1), dtype=torch.int64, device=dev)
    c[:, t] = 0
    a = torch.zeros((b, t + 1), dtype=torch.int64, device=dev)
    a[:, 0] = 1
    rounds = max(int(np.ceil(np.log2(max(t, 2)))), 1)
    for _ in range(rounds):
        a = a.scatter_reduce(1, f, a, "amax")
        c = c + c.gather(1, f)
        f = f.gather(1, f)

    # boundary p holds symbol k = C[0] - C[p]; the rest go to slot n_cap
    k = c[:, :1] - c
    valid = (a == 1) & (k >= 0) & (k < n_cap)
    valid[:, t] = False                              # the sink is no symbol
    slot = torch.where(valid, k, n_cap)
    pos = torch.arange(t + 1, device=dev).expand(b, t + 1)
    offsets = torch.zeros((b, n_cap + 1), dtype=torch.int64,
                          device=dev).scatter_(1, slot, pos)[:, :n_cap]
    syms = lut_sym.to(torch.int64)[peek_windows(payload, offsets, max_len)]
    keep = torch.arange(n_cap, device=dev) < count[:, None]
    out = torch.where(keep, syms, 0).to(torch.int32)
    return out[0] if single else out


def huffman_decode_bits_scan_reference(payloads: torch.Tensor,
                                       counts: torch.Tensor,
                                       lut_sym: torch.Tensor,
                                       lut_len: torch.Tensor, n_cap: int,
                                       max_len: int) -> torch.Tensor:
    """The plain version of the scan: S lanes walk their streams in lock
    step, one symbol a step, each step peeking the L-bit window at the
    lane's offset, emitting lut_sym there and advancing by lut_len,
    clamped to n_cap * L. payloads [S, W] words, counts [S] ->
    [S, n_cap] int32, 0 from each lane's count on."""
    s = payloads.shape[0]
    dev = payloads.device
    if n_cap == 0:
        return torch.zeros((s, 0), dtype=torch.int32, device=dev)
    words = _words64(payloads)
    lut_s = lut_sym.to(torch.int64)
    lut_l = lut_len.to(torch.int64)
    t_max = n_cap * max_len
    off = torch.zeros((s, 1), dtype=torch.int64, device=dev)
    out = torch.empty((s, n_cap), dtype=torch.int64, device=dev)
    for k in range(n_cap):
        wi = off >> 5
        idx = _peek(words.gather(1, wi), words.gather(1, wi + 1), off & 31,
                    max_len)
        out[:, k:k + 1] = lut_s[idx]
        off = torch.clamp(off + lut_l[idx], max=t_max)
    keep = torch.arange(n_cap, device=dev) < counts.to(dev)[:, None]
    return torch.where(keep, out, 0).to(torch.int32)


def huffman_decode_bits_scan(payloads: torch.Tensor, counts: torch.Tensor,
                             lut_sym: torch.Tensor, lut_len: torch.Tensor,
                             n_cap: int, max_len: int,
                             unroll: int = 8) -> torch.Tensor:
    """The scan decoder: S streams in lock-step lanes (see
    huffman_decode_bits_scan_reference). payloads [S, W] with
    W >= n_cap * max_len // 32 + 2, counts [S] -> [S, n_cap] int32, zero
    from each lane's count on. On CUDA tensors the scan kernel, on the CPU
    the plain loop. `unroll` is JAX's symbols per scan step; it changes no
    output and neither path reads it."""
    del unroll
    if payloads.is_cuda:
        return huffman_scan_kernel(payloads, counts, lut_sym, lut_len,
                                   n_cap, max_len)
    return huffman_decode_bits_scan_reference(payloads, counts, lut_sym,
                                              lut_len, n_cap, max_len)


def huffman_scan_kernel(payloads: torch.Tensor, counts: torch.Tensor,
                        lut_sym: torch.Tensor, lut_len: torch.Tensor,
                        n_cap: int, max_len: int) -> torch.Tensor:
    """Launch the scan kernel on the current stream, with no host sync (so
    a CUDA graph captures it). CUDA tensors only: payloads [S, W] int32,
    counts [S] int32, lut_sym / lut_len [2^max_len] int32, all contiguous
    on one device. Anything else raises, and so does a failed build or
    launch."""
    if not payloads.is_cuda:
        raise ValueError("huffman_scan_kernel launches a CUDA kernel and "
                         "takes CUDA tensors only; use "
                         "huffman_decode_bits_scan() for CPU tensors")
    if not 1 <= max_len <= MAX_LUT_BITS:
        raise ValueError(f"max_len {max_len} outside [1, {MAX_LUT_BITS}]")
    if payloads.dim() != 2:
        raise ValueError(f"expected [S, W] payloads, got "
                         f"{tuple(payloads.shape)}")
    s, w = payloads.shape
    if w < n_cap * max_len // 32 + 2:
        raise ValueError(f"payload rows of {w} words; {n_cap} symbols of up "
                         f"to {max_len} bits need "
                         f"{n_cap * max_len // 32 + 2} with the guard word")
    if n_cap * max_len >= 1 << 31 or s > 0x7FFFFFFF:
        raise ValueError(f"{s} lanes of {n_cap} symbols exceed the kernel's "
                         "32-bit offsets")
    for name, t, n in (("payloads", payloads, None), ("counts", counts, s),
                       ("lut_sym", lut_sym, 1 << max_len),
                       ("lut_len", lut_len, 1 << max_len)):
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise TypeError(f"{name} must be a contiguous int32 tensor, got "
                            f"{t.dtype}")
        if t.device != payloads.device:
            raise ValueError(f"{name} lies on {t.device}, the payloads on "
                             f"{payloads.device}")
        if n is not None and t.shape != (n,):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"({n},)")
    out = torch.empty((s, n_cap), dtype=torch.int32, device=payloads.device)
    if s == 0 or n_cap == 0:
        return out
    idx = payloads.get_device()
    fn = build.function("huffman_scan", "cgic_huffman_scan")
    with torch.cuda.device(idx):
        rc = fn(payloads.data_ptr(), counts.data_ptr(), lut_sym.data_ptr(),
                lut_len.data_ptr(), out.data_ptr(), s, w, n_cap, max_len,
                torch._C._cuda_getCurrentRawStream(idx))
    if rc:
        build.check(build.load("huffman_scan"), rc, "huffman_scan")
    build.count_launch(KERNEL_LAUNCHES, "huffman_scan")
    return out


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
