"""Mask-aware VQGAN decoder with SpatialNorm conditioning, NCHW (port of
control_gic_tpu/models/decoder.py).

  - three 3x3 conv stems (z -> block_in) and three zq-conditioned mid stacks
    at the full latent resolution; the coarse path is then avg-pooled x4
    and the medium path x2;
  - the upsampling trunk (num_res_blocks+1 ResBlocks per level, attention at
    the configured resolutions) re-injects each grain at its level, gated
    by the masks:
      at H/8: h = h * up2(mask_c) + medium * mask_m
      at H/4: h = h * up4(mask_c) + h * up2(mask_m) + fine * mask_f
  - SpatialNorm -> swish -> 3x3 conv to out_ch.
Trunk blocks at levels without attention chain (SpatialNorm form, see
encoder.chain_step); mask injection, attention and Upsample end a chain. At
level 0 the last block's moments feed norm_out + conv_out, which then run as
one chain call with Cout = out_ch; where no moments come, they run as one
per-call norm+conv if `norm_conv_worthwhile` says so, unfused otherwise.
Under `remat` (or with deterministic=False) nothing chains, and the trunk's
blocks run through encoder.trunk_call, as in the encoder.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..ops.norm_conv import (admissible, norm_conv_worthwhile,
                             spatial_norm_conv, spatial_norm_conv_mom,
                             stats_from_moments)
from ..ops.resample import avg_pool, nearest_resize, upsample_nearest
from .blocks import AttnBlock, Conv2d, ResnetBlock, SpatialNorm, Upsample
from .encoder import Level, Mid, chain_consumes, chain_step, trunk_call


class Decoder(nn.Module):
    def __init__(self, ch: int = 128, out_ch: int = 3,
                 ch_mult: Sequence[int] = (1, 2, 2, 4, 4),
                 num_res_blocks: int = 2,
                 attn_resolutions: Sequence[int] = (32,),
                 resolution: int = 256, z_channels: int = 4,
                 zq_channels: int = 4, dtype: torch.dtype = torch.float32,
                 dropout: float = 0.0, remat: bool = False):
        super().__init__()
        num_res = len(ch_mult)
        self.num_res = num_res
        self.dtype = dtype
        self.remat = remat
        block_in = ch * ch_mult[-1]
        self.conv_in_coarse = Conv2d(z_channels, block_in, 3, dtype=dtype)
        self.conv_in = Conv2d(z_channels, block_in, 3, dtype=dtype)
        self.conv_in_fine = Conv2d(z_channels, block_in, 3, dtype=dtype)
        self.mid_coarse = Mid(block_in, zq_channels, dtype, dropout)
        self.mid = Mid(block_in, zq_channels, dtype, dropout)
        self.mid_fine = Mid(block_in, zq_channels, dtype, dropout)

        # attention schedule of the reference: curr_res starts at
        # resolution / 2^(num_res-1) and doubles per level, built in
        # reversed order
        curr_res = resolution // 2 ** (num_res - 1)
        levels = [None] * num_res
        cur = block_in
        for i_level in reversed(range(num_res)):
            level = Level()
            block_out = ch * ch_mult[i_level]
            attn_here = curr_res in attn_resolutions
            for _ in range(num_res_blocks + 1):
                level.block.append(ResnetBlock(cur, block_out, zq_channels,
                                               dtype, dropout))
                cur = block_out
                if attn_here:
                    level.attn.append(AttnBlock(cur, zq_channels, dtype))
            if i_level != 0:
                level.upsample = Upsample(cur, dtype)
                curr_res *= 2
            levels[i_level] = level
        self.up = nn.ModuleList(levels)
        self.norm_out = SpatialNorm(cur, zq_channels, dtype)
        self.conv_out = Conv2d(cur, out_ch, 3, dtype=dtype)

    def forward(self, z: torch.Tensor, zq: torch.Tensor, masks, *,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        """z: [B, z_channels, Hl, Wl] post-quant-conv latent; zq: [B, D, Hl,
        Wl] quantized latent; masks: (coarse [B,Hl/4,Wl/4], medium
        [B,Hl/2,Wl/2], fine [B,Hl,Wl]). Returns [B, out_ch, 4Hl, 4Wl]."""
        drop = dict(deterministic=deterministic, generator=generator)
        use_chain = not self.remat and deterministic
        m_c, m_m, m_f = masks
        gate = lambda m: m.to(self.dtype)[:, None]          # [B, 1, h, w]
        h_coarse = self.mid_coarse(self.conv_in_coarse(z), zq, **drop)
        h_medium = self.mid(self.conv_in(z), zq, **drop)
        h_fine = self.mid_fine(self.conv_in_fine(z), zq, **drop)
        h_coarse = avg_pool(h_coarse, 4)
        h_medium = avg_pool(h_medium, 2)

        out_ch = self.conv_out.weight.shape[0]
        # the last block of level 0 hands its moments to norm_out + conv_out
        to_out = lambda shape: admissible(shape, out_ch)
        h, mom = h_coarse, None
        for i_level in reversed(range(self.num_res)):
            if i_level == self.num_res - 2:
                h = h * upsample_nearest(gate(m_c), 2) + h_medium * gate(m_m)
                mom = None
            elif i_level == self.num_res - 3:
                h = (h * upsample_nearest(gate(m_c), 4)
                     + h * upsample_nearest(gate(m_m), 2)
                     + h_fine * gate(m_f))
                mom = None
            level = self.up[i_level]
            last = len(level.block) - 1
            for i_block, block in enumerate(level.block):
                consumes = (chain_consumes if i_block < last
                            else to_out if i_level == 0 else None)
                h, mom = chain_step(block, h, zq, mom,
                                    use_chain and not len(level.attn),
                                    consumes, self.remat, **drop)
                if len(level.attn):
                    h = trunk_call(self.remat, level.attn[i_block], h, zq)
            if i_level != 0:
                h = level.upsample(h)
                mom = None
        zq_r = lambda: nearest_resize(zq, h.shape[2], h.shape[3]).to(
            self.dtype)
        conv = self.conv_out
        if mom is not None:
            # norm_out + conv_out as one chain call, stats from the moments
            return spatial_norm_conv_mom(
                h.to(self.dtype), zq_r(), *self.norm_out.params(),
                conv.weight, conv.bias,
                stats=stats_from_moments(mom, h.shape[2] * h.shape[3]),
                emit_mom=False)
        if norm_conv_worthwhile(h.shape, out_ch):
            return spatial_norm_conv(h.to(self.dtype), zq_r(),
                                     *self.norm_out.params(), conv.weight,
                                     conv.bias)
        return conv(self.norm_out(h, zq, act="swish"))
