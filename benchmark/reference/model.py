"""The plain reference of the Control-GIC codec model, in float32.

A frozen copy of the model's math as the Control-GIC paper and its
reference code describe it (github.com/lianqi1008/Control-GIC): patch
entropy, the triple-grain router, the three-tap VQGAN encoder, grain
fusion, `quant_conv`, nearest-code VQ, and the mask-aware SpatialNorm
decoder. Written as functions over a flat parameter dict whose names and
shapes (`param_shapes`) are the model's state_dict, so that one set of
weights made by the benchmark loads into the program and into this file.

Plain torch only: no kernel, no chaining, no graphs, no cache. Attention is
a softmax over all keys, computed in blocks of query rows so that it fits.
Upsampling is nearest x2 then the 3x3 conv, as written. Every product
(convolution, attention, the VQ distance) goes through `Prec`: float32 for
the reference, or a lower precision for the control that has to fail the
comparison. TF32 must be off (`fp32_pipes`) for float32 to mean float32.

Images are NCHW float32 in [0, 1]; masks are int [B, h, w] grids.
"""
from __future__ import annotations

import math
from typing import Dict, Iterator, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

GROUPS = 32
GN_EPS = 1e-6
ATTN_BLOCK = 4096          # query rows per block of the plain softmax

Params = Dict[str, torch.Tensor]


def fp32_pipes(on: bool = True) -> None:
    """float32 products in float32 (on) or in TF32 (off)."""
    torch.backends.cuda.matmul.allow_tf32 = not on
    torch.backends.cudnn.allow_tf32 = not on


class Prec:
    """How the products round their operands. 'f32' leaves them as they are;
    'fp8' rounds each operand to float8 e4m3 with one scale per tensor (its
    largest magnitude mapped to 448), as an fp8 path of the program would."""

    def __init__(self, kind: str = "f32"):
        if kind not in ("f32", "fp8"):
            raise ValueError(f"unknown precision {kind!r}")
        self.kind = kind

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        t = t.float()
        if self.kind == "f32":
            return t
        scale = t.abs().amax().clamp_min(1e-30) / 448.0
        return (t / scale).to(torch.float8_e4m3fn).float() * scale


F32 = Prec("f32")


# ------------------------------------------------------------ parameters

def _conv(names: dict, name: str, cin: int, cout: int, k: int) -> None:
    names[f"{name}.weight"] = (cout, cin, k, k)
    names[f"{name}.bias"] = (cout,)


def _norm(names: dict, name: str, c: int, zq: Optional[int]) -> None:
    if zq:
        names[f"{name}.norm_layer.weight"] = (c,)
        names[f"{name}.norm_layer.bias"] = (c,)
        _conv(names, f"{name}.conv_y", zq, c, 1)
        _conv(names, f"{name}.conv_b", zq, c, 1)
    else:
        names[f"{name}.weight"] = (c,)
        names[f"{name}.bias"] = (c,)


def _block(names: dict, name: str, cin: int, cout: int,
           zq: Optional[int]) -> None:
    _norm(names, f"{name}.norm1", cin, zq)
    _conv(names, f"{name}.conv1", cin, cout, 3)
    _norm(names, f"{name}.norm2", cout, zq)
    _conv(names, f"{name}.conv2", cout, cout, 3)
    if cin != cout:
        _conv(names, f"{name}.nin_shortcut", cin, cout, 1)


def _attn(names: dict, name: str, c: int, zq: Optional[int]) -> None:
    _norm(names, f"{name}.norm", c, zq)
    for p in ("q", "k", "v", "proj_out"):
        _conv(names, f"{name}.{p}", c, c, 1)


def _mid(names: dict, name: str, c: int, zq: Optional[int]) -> None:
    _block(names, f"{name}.block_1", c, c, zq)
    _attn(names, f"{name}.attn_1", c, zq)
    _block(names, f"{name}.block_2", c, c, zq)


def encoder_levels(cfg: dict) -> Iterator[Tuple[int, int, int, bool]]:
    """(level, input channels, output channels, attention here) of the
    encoder's trunk; attention follows the config's `resolution`."""
    res, cur = cfg["resolution"], cfg["ch"]
    for i, m in enumerate(cfg["ch_mult"]):
        cout = cfg["ch"] * m
        yield i, cur, cout, res in cfg["attn_resolutions"]
        cur = cout
        if i != len(cfg["ch_mult"]) - 1:
            res //= 2


def decoder_levels(cfg: dict) -> Iterator[Tuple[int, int, int, bool]]:
    """(level, input channels, output channels, attention here) of the
    decoder's trunk, from the deepest level up."""
    n = len(cfg["ch_mult"])
    res = cfg["resolution"] // 2 ** (n - 1)
    cur = cfg["ch"] * cfg["ch_mult"][-1]
    for i in reversed(range(n)):
        cout = cfg["ch"] * cfg["ch_mult"][i]
        yield i, cur, cout, res in cfg["attn_resolutions"]
        cur = cout
        if i != 0:
            res *= 2


def param_shapes(cfg: dict) -> Dict[str, Tuple[int, ...]]:
    """Every parameter of the codec model: name -> shape (the model's
    state_dict)."""
    names: dict = {}
    ch, zc, zq = cfg["ch"], cfg["z_channels"], cfg["embed_dim"]
    nrb = cfg["num_res_blocks"]
    _conv(names, "encoder.conv_in", cfg.get("in_channels", 3), ch, 3)
    last = len(cfg["ch_mult"]) - 1
    for i, cin, cout, attn in encoder_levels(cfg):
        for j in range(nrb):
            _block(names, f"encoder.down.{i}.block.{j}", cin if j == 0
                   else cout, cout, None)
            if attn:
                _attn(names, f"encoder.down.{i}.attn.{j}", cout, None)
        if i != last:
            _conv(names, f"encoder.down.{i}.downsample.conv", cout, cout, 3)
    c_fine, c_med, c_coarse = (ch * m for m in cfg["ch_mult"][-3:])
    for suffix, c in (("_fine", c_fine), ("", c_med), ("_coarse", c_coarse)):
        _mid(names, f"encoder.mid{suffix}", c, None)
        _norm(names, f"encoder.norm_out{suffix}", c, None)
        _conv(names, f"encoder.conv_out{suffix}", c, zc, 3)
    block_in = ch * cfg["ch_mult"][-1]
    for suffix in ("_coarse", "", "_fine"):
        _conv(names, f"decoder.conv_in{suffix}", zc, block_in, 3)
        _mid(names, f"decoder.mid{suffix}", block_in, zq)
    for i, cin, cout, attn in decoder_levels(cfg):
        for j in range(nrb + 1):
            _block(names, f"decoder.up.{i}.block.{j}", cin if j == 0
                   else cout, cout, zq)
            if attn:
                _attn(names, f"decoder.up.{i}.attn.{j}", cout, zq)
        if i != 0:
            _conv(names, f"decoder.up.{i}.upsample.conv", cout, cout, 3)
    _norm(names, "decoder.norm_out", ch * cfg["ch_mult"][0], zq)
    _conv(names, "decoder.conv_out", ch * cfg["ch_mult"][0],
          cfg.get("out_ch", 3), 3)
    _conv(names, "quant_conv", zc, zq, 1)
    _conv(names, "post_quant_conv", zq, zc, 1)
    names["quantize.embedding.weight"] = (cfg["n_embed"], zq)
    return names


# ------------------------------------------------------------ operations

def conv(x: torch.Tensor, p: Params, name: str, prec: Prec = F32,
         stride: int = 1, padding: Optional[int] = None) -> torch.Tensor:
    w = p[f"{name}.weight"]
    pad = w.shape[-1] // 2 if padding is None else padding
    return F.conv2d(prec(x), prec(w), p[f"{name}.bias"].float(), stride, pad)


def swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def group_norm(x: torch.Tensor, weight: torch.Tensor,
               bias: torch.Tensor) -> torch.Tensor:
    """GroupNorm(32, eps 1e-6) with the biased variance."""
    b, c, h, w = x.shape
    xg = x.float().reshape(b, GROUPS, -1)
    mean = xg.mean(-1, keepdim=True)
    var = xg.var(-1, unbiased=False, keepdim=True)
    xn = ((xg - mean) / torch.sqrt(var + GN_EPS)).reshape(b, c, h, w)
    return xn * weight.float()[:, None, None] + bias.float()[:, None, None]


def nearest_resize(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Nearest resize of the last two dims, source index dst * in // out."""
    in_h, in_w = x.shape[-2:]
    ih = torch.arange(out_h, device=x.device) * in_h // out_h
    iw = torch.arange(out_w, device=x.device) * in_w // out_w
    return x.index_select(-2, ih).index_select(-1, iw)


def up(x: torch.Tensor, s: int) -> torch.Tensor:
    return x.repeat_interleave(s, -2).repeat_interleave(s, -1)


def avg_pool(x: torch.Tensor, s: int) -> torch.Tensor:
    return F.avg_pool2d(x, s)


def norm(x: torch.Tensor, p: Params, name: str, zq: Optional[torch.Tensor],
         prec: Prec = F32) -> torch.Tensor:
    """GroupNorm, or with zq the MoVQ SpatialNorm: GroupNorm(x) * conv_y(zq)
    + conv_b(zq), zq resized to x by nearest."""
    if zq is None:
        return group_norm(x, p[f"{name}.weight"], p[f"{name}.bias"])
    zr = nearest_resize(zq, x.shape[2], x.shape[3])
    xn = group_norm(x, p[f"{name}.norm_layer.weight"],
                    p[f"{name}.norm_layer.bias"])
    return (xn * conv(zr, p, f"{name}.conv_y", prec)
            + conv(zr, p, f"{name}.conv_b", prec))


def resnet_block(x, p, name, zq=None, prec: Prec = F32):
    h = conv(swish(norm(x, p, f"{name}.norm1", zq, prec)), p,
             f"{name}.conv1", prec)
    h = conv(swish(norm(h, p, f"{name}.norm2", zq, prec)), p,
             f"{name}.conv2", prec)
    if f"{name}.nin_shortcut.weight" in p:
        x = conv(x, p, f"{name}.nin_shortcut", prec)
    return x + h


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              prec: Prec = F32) -> torch.Tensor:
    """softmax(q k^T / sqrt(C)) v over [B, T, C] tokens, one head, in blocks
    of ATTN_BLOCK query rows."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    kt, vv = prec(k).transpose(1, 2), prec(v)
    qq = prec(q)
    out = []
    for s in range(0, q.shape[1], ATTN_BLOCK):
        w = torch.softmax(torch.matmul(qq[:, s:s + ATTN_BLOCK], kt) * scale,
                          dim=-1)
        out.append(torch.matmul(prec(w), vv))
    return torch.cat(out, dim=1)


def attn_block(x, p, name, zq=None, prec: Prec = F32):
    b, c, h, w = x.shape
    hn = norm(x, p, f"{name}.norm", zq, prec)
    tok = lambda t: t.reshape(b, c, h * w).transpose(1, 2)
    o = attention(tok(conv(hn, p, f"{name}.q", prec)),
                  tok(conv(hn, p, f"{name}.k", prec)),
                  tok(conv(hn, p, f"{name}.v", prec)), prec)
    return x + conv(o.transpose(1, 2).reshape(b, c, h, w), p,
                    f"{name}.proj_out", prec)


def mid(x, p, name, zq=None, prec: Prec = F32):
    x = resnet_block(x, p, f"{name}.block_1", zq, prec)
    x = attn_block(x, p, f"{name}.attn_1", zq, prec)
    return resnet_block(x, p, f"{name}.block_2", zq, prec)


# ------------------------------------------------------- entropy and router

_GRAY = (0.2989, 0.5870, 0.1140)


def patch_entropy(x: torch.Tensor, patch: int) -> torch.Tensor:
    """Shannon entropy of each non-overlapping patch of the gray image, from
    a Gaussian-kernel histogram (32 bins over [-1, 1], sigma 0.01, eps
    1e-40; terms with pdf <= 1e-37 count as 0). [B, H/p, W/p]."""
    b, _, h, w = x.shape
    x = x.float()
    gray = _GRAY[0] * x[:, 0] + _GRAY[1] * x[:, 1] + _GRAY[2] * x[:, 2]
    pt = gray.reshape(b, h // patch, patch, w // patch, patch).permute(
        0, 1, 3, 2, 4).reshape(b, h // patch, w // patch, patch * patch)
    bins = torch.linspace(-1.0, 1.0, 32, device=x.device)
    kern = torch.exp(-0.5 * torch.square((pt[..., None] - bins) / 0.01))
    pdf = kern.mean(dim=-2)
    pdf = pdf / (pdf.sum(dim=-1, keepdim=True) + 1e-40) + 1e-40
    plogp = torch.where(pdf > 1e-37, pdf * torch.log(pdf.clamp_min(1e-37)),
                        torch.zeros_like(pdf))
    return -plogp.sum(dim=-1)


def mode_of(coarse: float, medium: float) -> int:
    """Compression mode 0-6 from the ratios (fine = 1 - coarse - medium):
    0 all three grains; 1, 2, 3 without coarse, medium, fine; 4, 5, 6 all
    coarse, medium, fine."""
    fine = max(1.0 - coarse - medium, 0.0)
    zeros = (coarse == 0, medium == 0, fine == 0)
    if sum(zeros) == 0:
        return 0
    if sum(zeros) == 1:
        return 1 + zeros.index(True)
    return 4 + zeros.index(False)


def route(x: torch.Tensor, coarse: float, medium: float,
          per_sample: bool = True
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The triple-grain router: thresholds per image (per_sample) or over
    the whole batch, each the k-th smallest entropy (k = round(N * ratio)
    by Python's banker's rounding; sorted[k - 1], sorted[0] at k = 0) with
    strict `<`; in mode 0 the medium threshold runs over the 8-px entropy
    with the coarse area zeroed, at k = round(4 N16 r_c + N8 r_m).
    Returns (m_c, m_m, m_f) int32 at 1/16, 1/8 and 1/4 of the image."""
    e16, e8 = patch_entropy(x, 16), patch_entropy(x, 8)
    b = x.shape[0]
    rows = b if per_sample else 1
    n16, n8 = e16.numel() // rows, e8.numel() // rows

    def threshold(v, k):
        s = torch.sort(v.reshape(rows, -1), dim=-1).values[:, max(k - 1, 0)]
        return s.reshape(rows, 1, 1)

    full = lambda e, on, s: torch.full(
        (b, e.shape[1] * s, e.shape[2] * s), on, dtype=torch.bool,
        device=x.device)
    mode = mode_of(coarse, medium)
    gate_c = e16 < threshold(e16, round(n16 * coarse))
    if mode == 0:
        not_c = ~up(gate_c, 2)
        k_m = round(4 * n16 * coarse + n8 * medium)
        gate_m = (e8 < threshold(e8 * not_c.float(), k_m)) & not_c
        gate_f = ~(up(gate_c, 4) | up(gate_m, 2))
    elif mode == 1:
        gate_m = e8 < threshold(e8, round(n8 * medium))
        gate_f, gate_c = ~up(gate_m, 2), full(e16, False, 1)
    elif mode == 2:
        gate_f, gate_m = ~up(gate_c, 4), full(e8, False, 1)
    elif mode == 3:
        gate_m, gate_f = ~up(gate_c, 2), full(e8, False, 2)
    else:
        gate_c = full(e16, mode == 4, 1)
        gate_m = full(e8, mode == 5, 1)
        gate_f = full(e8, mode == 6, 2)
    return tuple(g.to(torch.int32) for g in (gate_c, gate_m, gate_f))


# ------------------------------------------------------- encoder, decoder

def encode_taps(x, p, cfg, prec: Prec = F32):
    """The encoder's three heads: (z_fine, z_medium, z_coarse)."""
    n = len(cfg["ch_mult"])
    h = conv(x, p, "encoder.conv_in", prec)
    taps = {}
    for i, _, _, attn in encoder_levels(cfg):
        for j in range(cfg["num_res_blocks"]):
            h = resnet_block(h, p, f"encoder.down.{i}.block.{j}", None, prec)
            if attn:
                h = attn_block(h, p, f"encoder.down.{i}.attn.{j}", None, prec)
        taps[i] = h
        if i != n - 1:
            h = conv(F.pad(h, (0, 1, 0, 1)), p,
                     f"encoder.down.{i}.downsample.conv", prec, stride=2,
                     padding=0)
    out = []
    for suffix, t in (("_fine", taps[n - 3]), ("", taps[n - 2]),
                      ("_coarse", h)):
        t = mid(t, p, f"encoder.mid{suffix}", None, prec)
        t = swish(norm(t, p, f"encoder.norm_out{suffix}", None, prec))
        out.append(conv(t, p, f"encoder.conv_out{suffix}", prec))
    return tuple(out)


def vq_distances(z: torch.Tensor, codebook: torch.Tensor,
                 prec: Prec = F32) -> torch.Tensor:
    """||z - e||^2 for every latent position and code: [B*H*W, N], as
    ||z||^2 + ||e||^2 - 2 z.e."""
    zf = z.float().permute(0, 2, 3, 1).reshape(-1, z.shape[1])
    cb = codebook.float()
    return ((zf * zf).sum(1, keepdim=True) + (cb * cb).sum(1)
            - 2.0 * torch.matmul(prec(zf), prec(cb).t()))


def encode(x, p, cfg, ratios, prec: Prec = F32, per_sample: bool = True):
    """Image [B, 3, H, W] in [0, 1] -> (indices [B, H/4, W/4] int64,
    (m_c, m_m, m_f), the fused latent [B, D, H/4, W/4])."""
    masks = route(x, *ratios, per_sample=per_sample)
    z_fine, z_medium, z_coarse = encode_taps(x, p, cfg, prec)
    m_c, m_m, m_f = (m.float()[:, None] for m in masks)
    h = (up(z_coarse, 4) * up(m_c, 4) + up(z_medium, 2) * up(m_m, 2)
         + z_fine * m_f)
    latent = conv(h, p, "quant_conv", prec)
    dist = vq_distances(latent, p["quantize.embedding.weight"], prec)
    b, _, hl, wl = latent.shape
    return torch.argmin(dist, dim=1).reshape(b, hl, wl), masks, latent


def decode(ind, masks, p, cfg, prec: Prec = F32) -> torch.Tensor:
    """Index grid [B, Hl, Wl] and masks -> the reconstruction [B, 3, H, W]
    (float32, not clipped)."""
    zq = p["quantize.embedding.weight"].float()[ind].permute(0, 3, 1, 2)
    return decode_latent(zq, masks, p, cfg, prec)


def decode_latent(zq, masks, p, cfg, prec: Prec = F32) -> torch.Tensor:
    """The decoder from a quantized latent zq [B, D, Hl, Wl]: post_quant_conv,
    three stems and mids conditioned on zq, the coarse path avg-pooled x4 and
    the medium x2, then the trunk, which re-injects each grain at its level
    under its mask; SpatialNorm, swish and conv_out at the end."""
    n = len(cfg["ch_mult"])
    z = conv(zq, p, "post_quant_conv", prec)
    m_c, m_m, m_f = (m.float()[:, None] for m in masks)
    hs = {s: mid(conv(z, p, f"decoder.conv_in{s}", prec), p,
                 f"decoder.mid{s}", zq, prec)
          for s in ("_coarse", "", "_fine")}
    h = avg_pool(hs["_coarse"], 4)
    h_medium = avg_pool(hs[""], 2)
    for i, _, _, attn in decoder_levels(cfg):
        if i == n - 2:
            h = h * up(m_c, 2) + h_medium * m_m
        elif i == n - 3:
            h = h * up(m_c, 4) + h * up(m_m, 2) + hs["_fine"] * m_f
        for j in range(cfg["num_res_blocks"] + 1):
            h = resnet_block(h, p, f"decoder.up.{i}.block.{j}", zq, prec)
            if attn:
                h = attn_block(h, p, f"decoder.up.{i}.attn.{j}", zq, prec)
        if i != 0:
            h = conv(up(h, 2), p, f"decoder.up.{i}.upsample.conv", prec)
    h = swish(norm(h, p, "decoder.norm_out", zq, prec))
    return conv(h, p, "decoder.conv_out", prec)


def to_uint8(rec: torch.Tensor) -> torch.Tensor:
    """[B, 3, H, W] float -> [B, H, W, 3] uint8: clip to [0, 1], times 255,
    truncated (how a PNG of the reconstruction is written)."""
    return (rec.clamp(0.0, 1.0) * 255).to(torch.uint8).permute(0, 2, 3, 1)


def grain_map(masks: Sequence[torch.Tensor]) -> torch.Tensor:
    """0 = coarse, 1 = medium, 2 = fine at each latent position."""
    m_c, m_m, m_f = masks
    return (up(m_m, 2) + 2 * m_f).to(torch.int32)
