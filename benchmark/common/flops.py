"""Operations and bytes of the work, counted from shapes, and the card's
peaks.

A model's operations are those of its products, two per multiply-add: every
convolution (1x1 ones included; the decoder's x2 upsampling is counted as a
3x3 conv at the doubled size, as the model is written), both products of
each attention (4 Tq Tk C) and the VQ distance product (2 T N D). Norms,
activations, the entropy histogram and pooling are left out. The count
follows from the configuration and the image size, whatever implements it.

A training step counts, with F the forward of a network on the batch: the
generator 3F (forward, then gradients of activations and weights), LPIPS 3F
(forward on the reconstruction and on the target, gradients of activations
only: it is frozen), the discriminator 8F (forward and activation gradients
for the generator's adversarial term; two forwards and two backwards of
activations and weights for its own update).

The bound arithmetic and the peaks are chip_smoke.py's `bound_ms`,
`attn_bound_ms` and `PEAKS` (NVIDIA's data sheets, dense rates at the
card's full power limit).
"""
from __future__ import annotations

import os
import sys
from typing import List, Tuple

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from reference.model import decoder_levels, encoder_levels  # noqa: E402
from reference.train import VGG_BLOCKS  # noqa: E402

# (peak dense bf16 tensor FLOP/s, peak f32 FLOP/s outside the tensor cores,
# HBM bytes/s) of the H100 parts
PEAKS = {"PCIe": (756e12, 51e12, 2.0e12), "NVL": (835e12, 60e12, 3.9e12),
         "SXM": (989e12, 67e12, 3.35e12)}
# the port's rule for the flash kernels: at least this many keys, and both
# lengths divisible by a block of at least this many tokens
FLASH_MIN_TOKENS = 4096
FLASH_MIN_BLOCK = 256

Attn = Tuple[int, int, int, int]          # (batch, Tq, Tk, C)


def card_peaks(name: str) -> Tuple[float, float, float]:
    for key in ("PCIe", "NVL"):
        if key in name:
            return PEAKS[key]
    return PEAKS["SXM"]


def conv(cin: int, cout: int, k: int, h: int, w: int) -> float:
    """A k x k convolution with an h x w output."""
    return 2.0 * cin * cout * k * k * h * w


def attention(t: int, c: int) -> float:
    """The two products of single-head attention over t tokens."""
    return 4.0 * t * t * c


def _block(cin, cout, h, w, zq=None) -> float:
    f = conv(cin, cout, 3, h, w) + conv(cout, cout, 3, h, w)
    if cin != cout:
        f += conv(cin, cout, 1, h, w)
    if zq:                                  # SpatialNorm's two 1x1 convs
        f += 2 * conv(zq, cin, 1, h, w) + 2 * conv(zq, cout, 1, h, w)
    return f


def _attn(c, h, w, zq=None) -> float:
    f = 4 * conv(c, c, 1, h, w) + attention(h * w, c)
    if zq:
        f += 2 * conv(zq, c, 1, h, w)
    return f


def _mid(c, h, w, zq=None) -> float:
    return 2 * _block(c, c, h, w, zq) + _attn(c, h, w, zq)


def codec_attentions(cfg: dict, h: int, w: int) -> List[Attn]:
    """(1, T, T, C) of every attention of one image's encode and decode."""
    n = len(cfg["ch_mult"])
    out = []
    for i, _, cout, attn in encoder_levels(cfg):
        if attn:
            t = (h >> i) * (w >> i)
            out += [(1, t, t, cout)] * cfg["num_res_blocks"]
    for level, c in ((n - 3, cfg["ch"] * cfg["ch_mult"][-3]),
                     (n - 2, cfg["ch"] * cfg["ch_mult"][-2]),
                     (n - 1, cfg["ch"] * cfg["ch_mult"][-1])):
        t = (h >> level) * (w >> level)
        out.append((1, t, t, c))
    hl, wl = h // 4, w // 4
    out += [(1, hl * wl, hl * wl, cfg["ch"] * cfg["ch_mult"][-1])] * 3
    for i, _, cout, attn in decoder_levels(cfg):
        if attn:
            t = (h >> i) * (w >> i)
            out += [(1, t, t, cout)] * (cfg["num_res_blocks"] + 1)
    return out


def flash_attentions(cfg: dict, h: int, w: int, batch: int = 1
                     ) -> List[Attn]:
    """The attentions of codec_attentions that the flash kernels take."""
    return [(batch, tq, tk, c) for _, tq, tk, c in
            codec_attentions(cfg, h, w) if tk >= FLASH_MIN_TOKENS
            and tq % FLASH_MIN_BLOCK == 0 and tk % FLASH_MIN_BLOCK == 0]


def codec_flops(cfg: dict, h: int, w: int) -> float:
    """Operations of one image's encode and decode."""
    n, ch, nrb = len(cfg["ch_mult"]), cfg["ch"], cfg["num_res_blocks"]
    zc, zq = cfg["z_channels"], cfg["embed_dim"]
    hl, wl = h // 4, w // 4
    f = conv(3, ch, 3, h, w)
    for i, cin, cout, attn in encoder_levels(cfg):
        hi, wi = h >> i, w >> i
        for j in range(nrb):
            f += _block(cin if j == 0 else cout, cout, hi, wi)
            if attn:
                f += _attn(cout, hi, wi)
        if i != n - 1:
            f += conv(cout, cout, 3, hi // 2, wi // 2)
    for level, m in ((n - 3, cfg["ch_mult"][-3]), (n - 2, cfg["ch_mult"][-2]),
                     (n - 1, cfg["ch_mult"][-1])):
        hi, wi = h >> level, w >> level
        f += _mid(ch * m, hi, wi) + conv(ch * m, zc, 3, hi, wi)
    f += conv(zc, zq, 1, hl, wl) + 2.0 * hl * wl * cfg["n_embed"] * zq
    # decoder
    block_in = ch * cfg["ch_mult"][-1]
    f += conv(zq, zc, 1, hl, wl)
    f += 3 * (conv(zc, block_in, 3, hl, wl) + _mid(block_in, hl, wl, zq))
    for i, cin, cout, attn in decoder_levels(cfg):
        hi, wi = h >> i, w >> i
        for j in range(nrb + 1):
            f += _block(cin if j == 0 else cout, cout, hi, wi, zq)
            if attn:
                f += _attn(cout, hi, wi, zq)
        if i != 0:
            f += conv(cout, cout, 3, 2 * hi, 2 * wi)
    c0 = ch * cfg["ch_mult"][0]
    f += 2 * conv(zq, c0, 1, h, w) + conv(c0, cfg.get("out_ch", 3), 3, h, w)
    return f


def lpips_flops(h: int, w: int) -> float:
    """VGG16's convs up to relu5_3 on one image."""
    f, cin = 0.0, 3
    for b, block in enumerate(VGG_BLOCKS):
        hb, wb = h >> b, w >> b
        for c in block:
            f += conv(cin, c, 3, hb, wb)
            cin = c
    return f


def disc_flops(h: int, w: int, ndf: int = 64) -> float:
    """The PatchGAN discriminator on one image (k4 p1 convs)."""
    out = lambda s, stride: (s + 2 - 4) // stride + 1
    h1, w1 = out(h, 2), out(w, 2)
    h2, w2 = out(h1, 2), out(w1, 2)
    h3, w3 = out(h2, 1), out(w2, 1)
    h4, w4 = out(h3, 1), out(w3, 1)
    return (conv(3, ndf, 4, h1, w1) + conv(ndf, 2 * ndf, 4, h2, w2)
            + conv(2 * ndf, 4 * ndf, 4, h3, w3) + conv(4 * ndf, 1, 4, h4, w4))


def train_step_flops(cfg: dict, batch: int, h: int, w: int) -> float:
    return batch * (3 * codec_flops(cfg, h, w) + 3 * lpips_flops(h, w)
                    + 8 * disc_flops(h, w))


def bound_s(flops: float, nbytes: float, peak_ops: float,
            peak_bw: float) -> float:
    """The least time for the work: operations over the peak or bytes over
    the memory rate, whichever is larger."""
    return max(flops / peak_ops, nbytes / peak_bw)


def flash_fwd_bound_s(attns: List[Attn], itemsize: int, peak_ops: float,
                      peak_bw: float) -> float:
    """Each attention's bound: 4 B Tq Tk C operations, q, k, v read and o
    written once."""
    return sum(bound_s(4.0 * b * tq * tk * c,
                       itemsize * (2 * b * tq * c + 2 * b * tk * c),
                       peak_ops, peak_bw) for b, tq, tk, c in attns)


def flash_bwd_bound_s(attns: List[Attn], itemsize: int, peak_ops: float,
                      peak_bw: float) -> float:
    """Each attention's backward, as FlashAttention-2 counts the work it
    needs: the scores S once more, dP, dV, dK and dQ (10 B Tq Tk C, 2.5
    times the forward). A schedule that forms S or dP twice (the port's
    dq kernel does) does that work beyond the bound. q, o, dO, dQ and k,
    v, dK, dV cross memory once each."""
    return sum(bound_s(10.0 * b * tq * tk * c,
                       itemsize * (4 * b * tq * c + 4 * b * tk * c),
                       peak_ops, peak_bw) for b, tq, tk, c in attns)
