"""H-sharded single-pass decoder: one latent decoded across the mesh with
the image height sharded, no tiles, no seams (port of
control_gic_tpu/parallel/spatial_decoder.py).

The body runs SPMD over a list of NCHW shards (parallel/halo.py), one per
device along the mesh's axis, each shard through the decoder's replica on
its device:

  - 3x3 convs       -> halo rows from the neighbours;
  - GroupNorm /     -> the shards' partial sums added (psum) for the global
    SpatialNorm        statistics (GroupNorm normalises over (H, W, C/g));
  - attention       -> queries stay local, keys and values all-gathered:
                       Tq = T/n against Tk = T, which the flash forward
                       kernel takes at any lengths (ops/attention.py);
  - resizes, pools  -> local: every factor is a power of two and the shards
    and mask gates     divide evenly, so each shard's rows map onto its own;
  - Upsample        -> the subpixel form with a 1-row halo
                       (halo_upsample2_conv3x3) under `subpixel_enabled`,
                       else nearest x2 and a halo conv.

It reads the port's `Decoder` module, whose structure (levels, attention
placement) is the config's. With one shard every layer calls the module's
own (unchained) forward: the collective-free specialisation of JAX's axis
size 1. The body stays plain, as JAX's does: the chained norm+conv kernels
of the single-device decoder do not engage here (their halo-row blocking
does not compose with the shard halo).

Constraint: the latent's H divisible by 4 * n_shards (mask alignment).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from ..models.blocks import SpatialNorm, swish
from ..ops.attention import attention
from ..ops.fused_norm import (EPS, GROUPS, gn_stats, group_norm_apply,
                              spatial_norm_apply_reference)
from ..ops.resample import (avg_pool, nearest_resize, subpixel_enabled,
                            upsample_nearest)
from .halo import (Shards, all_gather, halo_conv2d, halo_upsample2_conv3x3,
                   join_rows, psum, split_rows)
from .mesh import module_replicas

Mods = List[torch.nn.Module]


def subs(mods: Mods, name: str) -> Mods:
    """The submodule `name` of each shard's replica."""
    return [m.get_submodule(name) for m in mods]


# --------------------------------------------------------------------- ops

def conv(xs: Shards, convs: Mods) -> Shards:
    """Conv2d modules on the shards, in the convs' dtype: a 1x1 (or one
    shard) locally, an odd kh with kh//2 halo rows."""
    c = convs[0]
    if c.weight.shape[2] == 1 or len(xs) == 1:
        return [cv(x) for cv, x in zip(convs, xs)]
    dt = c.dtype
    return halo_conv2d([x.to(dt) for x in xs], c.weight.to(dt),
                       c.bias.to(dt))


def stats(xs: Shards, groups: int = GROUPS) -> list:
    """GroupNorm's (mean, rstd), [B, C, 1, 1] f32, of the whole (H-sharded)
    tensor, on each shard's device: the shards' sums and sums of squares
    over (H_s, W, C/g) added, then the port's gn_stats formulas."""
    if len(xs) == 1:
        return [gn_stats(xs[0], groups)]
    b, c = xs[0].shape[:2]
    cg = c // groups
    parts = []
    for x in xs:
        xg = x.float().reshape(b, groups, -1)
        parts.append(torch.stack([xg.sum(-1), torch.square(xg).sum(-1)]))
    n = sum(x.shape[2] for x in xs) * xs[0].shape[3] * cg
    out = []
    for t in psum(parts):
        mean = t[0] / n
        var = torch.clamp(t[1] / n - torch.square(mean), min=0.0)
        rstd = torch.rsqrt(var + EPS)
        out.append(tuple(s.repeat_interleave(cg, dim=1).reshape(b, c, 1, 1)
                         for s in (mean, rstd)))
    return out


def norm(xs: Shards, zqs: Optional[Shards], norms: Mods,
         act: Optional[str] = None) -> Shards:
    """GroupNorm32 or SpatialNorm modules (then swish with act="swish") on
    the shards, with the statistics of the whole tensor."""
    if len(xs) == 1:
        return [norms[0](xs[0], None if zqs is None else zqs[0], act=act)]
    if isinstance(norms[0], SpatialNorm):
        fs = [x.to(norms[0].dtype) for x in xs]
        return [spatial_norm_apply_reference(
                    f, nearest_resize(zq, f.shape[2], f.shape[3]), mean, rstd,
                    *nm.params(), act_swish=act == "swish")
                for f, zq, (mean, rstd), nm in zip(fs, zqs, stats(fs), norms)]
    out = [group_norm_apply(x, mean, rstd, nm.weight, nm.bias).to(nm.dtype)
           for x, (mean, rstd), nm in zip(xs, stats(xs), norms)]
    return [swish(h) for h in out] if act == "swish" else out


def resnet_block(xs: Shards, zqs: Optional[Shards], blocks: Mods) -> Shards:
    """ResnetBlock's unchained forward (deterministic) on the shards."""
    if len(xs) == 1:
        args = (xs[0],) if zqs is None else (xs[0], zqs[0])
        return [blocks[0](*args)]
    h = conv(norm(xs, zqs, subs(blocks, "norm1"), "swish"),
             subs(blocks, "conv1"))
    h = conv(norm(h, zqs, subs(blocks, "norm2"), "swish"),
             subs(blocks, "conv2"))
    if blocks[0].nin_shortcut is not None:
        xs = [b.nin_shortcut(x) for b, x in zip(blocks, xs)]
    return [x + hh for x, hh in zip(xs, h)]


def attn_block(xs: Shards, zqs: Optional[Shards], attns: Mods) -> Shards:
    """AttnBlock on the shards: local queries against the all-gathered keys
    and values."""
    if len(xs) == 1:
        return [attns[0](xs[0], None if zqs is None else zqs[0])]
    hn = norm(xs, zqs, subs(attns, "norm"))

    def tokens(t):   # [B, C, H, W] -> [B, H*W, C], row-major over (H, W)
        b, c, h, w = t.shape
        return t.reshape(b, c, h * w).transpose(1, 2).contiguous()

    q = [tokens(a.q(h)) for a, h in zip(attns, hn)]
    k = all_gather([tokens(a.k(h)) for a, h in zip(attns, hn)], 1)
    v = all_gather([tokens(a.v(h)) for a, h in zip(attns, hn)], 1)
    out = []
    for a, x, qi, ki, vi in zip(attns, xs, q, k, v):
        b, c, h, w = x.shape
        o = attention(qi, ki, vi).transpose(1, 2).reshape(b, c, h, w)
        out.append(x + a.proj_out(o))
    return out


def mid(xs: Shards, zqs: Optional[Shards], mids: Mods) -> Shards:
    xs = resnet_block(xs, zqs, subs(mids, "block_1"))
    xs = attn_block(xs, zqs, subs(mids, "attn_1"))
    return resnet_block(xs, zqs, subs(mids, "block_2"))


def _upsample(xs: Shards, ups: Mods) -> Shards:
    """Upsample on the shards (the module's path choice, read at call
    time): the subpixel form with a 1-row halo, or nearest x2 then a halo
    conv."""
    if len(xs) == 1:
        return [ups[0](xs[0])]
    c = ups[0].conv
    if subpixel_enabled():
        return halo_upsample2_conv3x3([x.to(c.dtype) for x in xs],
                                      c.weight.to(xs[0].device),
                                      c.bias.to(xs[0].device))
    return conv([upsample_nearest(x, 2) for x in xs], subs(ups, "conv"))


# ----------------------------------------------------------------- decoder

def decoder_shards(zs: Shards, zqs: Shards, m_cs: Shards, m_ms: Shards,
                   m_fs: Shards, decs: Mods) -> Shards:
    """The decoder body over the shards (its replicas `decs`), line for
    line models/decoder.py::Decoder.forward with sharded layers."""
    dec = decs[0]
    gate = lambda m: m.to(dec.dtype)[:, None]
    h_coarse = mid(conv(zs, subs(decs, "conv_in_coarse")), zqs,
                   subs(decs, "mid_coarse"))
    h_medium = mid(conv(zs, subs(decs, "conv_in")), zqs, subs(decs, "mid"))
    h_fine = mid(conv(zs, subs(decs, "conv_in_fine")), zqs,
                 subs(decs, "mid_fine"))
    h = [avg_pool(x, 4) for x in h_coarse]
    h_medium = [avg_pool(x, 2) for x in h_medium]

    for i_level in reversed(range(dec.num_res)):
        if i_level == dec.num_res - 2:
            h = [x * upsample_nearest(gate(mc), 2) + hm * gate(mm)
                 for x, hm, mc, mm in zip(h, h_medium, m_cs, m_ms)]
        elif i_level == dec.num_res - 3:
            h = [x * upsample_nearest(gate(mc), 4)
                 + x * upsample_nearest(gate(mm), 2) + hf * gate(mf)
                 for x, hf, mc, mm, mf in zip(h, h_fine, m_cs, m_ms, m_fs)]
        level = dec.up[i_level]
        for i_block in range(len(level.block)):
            h = resnet_block(h, zqs, subs(decs,
                                          f"up.{i_level}.block.{i_block}"))
            if len(level.attn):
                h = attn_block(h, zqs, subs(decs,
                                            f"up.{i_level}.attn.{i_block}"))
        if i_level != 0:
            h = _upsample(h, subs(decs, f"up.{i_level}.upsample"))
    h = norm(h, zqs, subs(decs, "norm_out"), "swish")
    return conv(h, subs(decs, "conv_out"))


@torch.no_grad()
def decode_spatial_sharded(mesh, decoder, z: torch.Tensor, zq: torch.Tensor,
                           masks: Sequence[torch.Tensor],
                           axis: str = "data") -> torch.Tensor:
    """Decode z [B, z_channels, Hl, Wl] (post_quant_conv's output) with zq
    [B, D, Hl, Wl] and the masks (coarse [B, Hl/4, Wl/4], medium, fine),
    Hl sharded over the mesh's `axis`; `decoder` is the port's Decoder.
    Returns the [B, out_ch, 4*Hl, 4*Wl] image on the first shard's
    device."""
    devices = mesh.axis_devices(axis)
    n = len(devices)
    if z.shape[2] % (4 * n):
        raise ValueError(f"latent H {z.shape[2]} does not divide by "
                         f"4 * {n} shards")
    decs = module_replicas(decoder, devices)
    m_c, m_m, m_f = (split_rows(m, devices, 1) for m in masks)
    out = decoder_shards(split_rows(z, devices), split_rows(zq, devices),
                         m_c, m_m, m_f, decs)
    return join_rows(out)
