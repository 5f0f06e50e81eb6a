"""Triple-tap VQGAN encoder, NCHW (port of control_gic_tpu/models/encoder.py).

One downsampling trunk taps features at three depths:
  fine   = output of level num_res-3  (H/4,  ch*ch_mult[-3])
  medium = output of level num_res-2  (H/8,  ch*ch_mult[-2])
  coarse = trunk bottom               (H/16, ch*ch_mult[-1])
Each tap has its own mid stack (ResBlock + Attn + ResBlock), GroupNorm,
swish and 3x3 conv head down to z_channels. Attention placement follows the
config `resolution`, not the input's size.

Trunk blocks at levels without attention chain (GroupNorm form, see
`chain_step`): each block's epilogue moments feed the next block's norm.
Attention and Downsample end a chain. A head's norm_out + conv_out run as
one per-call norm+conv where `norm_conv_worthwhile` says so (JAX
`_MidHead`), unfused otherwise.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch
from torch import nn

from ..ops.norm_conv import (chain_admissible, group_norm_conv,
                             norm_conv_worthwhile)
from .blocks import (AttnBlock, Conv2d, Downsample, GroupNorm32, ResnetBlock,
                     swish)


def chain_consumes(out_shape) -> bool:
    """Whether a following trunk block chains on an output of this shape."""
    return chain_admissible(out_shape, out_shape[1])


def chain_step(block: ResnetBlock, h: torch.Tensor,
               zq: Optional[torch.Tensor], mom: Optional[torch.Tensor],
               may_chain: bool,
               consumes: Optional[Callable[[tuple], bool]]):
    """One trunk block under the JAX package's chain wiring: the block
    chains when `may_chain` (no attention at its level) and its shape is
    chain-admissible; it emits the moments of its output when
    `consumes(out_shape)` says that what follows takes them (None: nothing
    does). Returns (h, moments of h or None)."""
    out_ch = block.conv1.weight.shape[0]
    if not (may_chain and chain_admissible(h.shape, out_ch)):
        return block(h, zq), None
    emit = consumes is not None and consumes(
        (h.shape[0], out_ch, h.shape[2], h.shape[3]))
    out = block(h, zq, mom_in=mom, emit_mom=emit)
    return out if emit else (out, None)


class Level(nn.Module):
    """One trunk level: `block` and `attn` lists plus an optional resampler
    (`downsample` in the encoder, `upsample` in the decoder)."""

    def __init__(self):
        super().__init__()
        self.block = nn.ModuleList()
        self.attn = nn.ModuleList()


class Mid(nn.Module):
    def __init__(self, channels: int, zq_channels=None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.block_1 = ResnetBlock(channels, channels, zq_channels, dtype)
        self.attn_1 = AttnBlock(channels, zq_channels, dtype)
        self.block_2 = ResnetBlock(channels, channels, zq_channels, dtype)

    def forward(self, h: torch.Tensor, zq=None) -> torch.Tensor:
        return self.block_2(self.attn_1(self.block_1(h, zq), zq), zq)


class Encoder(nn.Module):
    def __init__(self, ch: int = 128, ch_mult: Sequence[int] = (1, 2, 2, 4, 4),
                 num_res_blocks: int = 2,
                 attn_resolutions: Sequence[int] = (32,),
                 resolution: int = 256, z_channels: int = 4,
                 in_channels: int = 3, dtype: torch.dtype = torch.float32):
        super().__init__()
        num_res = len(ch_mult)
        self.num_res = num_res
        self.conv_in = Conv2d(in_channels, ch, 3, dtype=dtype)
        self.down = nn.ModuleList()
        curr_res, cur = resolution, ch
        for i_level in range(num_res):
            level = Level()
            block_out = ch * ch_mult[i_level]
            for _ in range(num_res_blocks):
                level.block.append(ResnetBlock(cur, block_out, dtype=dtype))
                cur = block_out
                if curr_res in attn_resolutions:
                    level.attn.append(AttnBlock(cur, dtype=dtype))
            if i_level != num_res - 1:
                level.downsample = Downsample(cur, dtype)
                curr_res //= 2
            self.down.append(level)

        c_fine, c_med, c_coarse = (ch * m for m in ch_mult[-3:])
        self.mid_fine = Mid(c_fine, dtype=dtype)
        self.mid = Mid(c_med, dtype=dtype)
        self.mid_coarse = Mid(c_coarse, dtype=dtype)
        self.norm_out_fine = GroupNorm32(c_fine, dtype)
        self.norm_out = GroupNorm32(c_med, dtype)
        self.norm_out_coarse = GroupNorm32(c_coarse, dtype)
        self.conv_out_fine = Conv2d(c_fine, z_channels, 3, dtype=dtype)
        self.conv_out = Conv2d(c_med, z_channels, 3, dtype=dtype)
        self.conv_out_coarse = Conv2d(c_coarse, z_channels, 3, dtype=dtype)

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """x: [B, 3, H, W] -> (z_fine [B,zc,H/4,W/4], z_medium [.., H/8, ..],
        z_coarse [.., H/16, ..])."""
        h = self.conv_in(x)
        taps = {}
        mom = None
        for i_level, level in enumerate(self.down):
            last = len(level.block) - 1
            for i_block, block in enumerate(level.block):
                h, mom = chain_step(block, h, None, mom, not len(level.attn),
                                    chain_consumes if i_block < last else None)
                if len(level.attn):
                    h = level.attn[i_block](h)
            taps[i_level] = h
            if i_level != self.num_res - 1:
                h = level.downsample(h)
                mom = None
        heads = ((self.mid_fine, self.norm_out_fine, self.conv_out_fine,
                  taps[self.num_res - 3]),
                 (self.mid, self.norm_out, self.conv_out,
                  taps[self.num_res - 2]),
                 (self.mid_coarse, self.norm_out_coarse, self.conv_out_coarse,
                  h))
        return tuple(_head(*head) for head in heads)


def _head(mid: Mid, norm: GroupNorm32, conv: Conv2d,
          t: torch.Tensor) -> torch.Tensor:
    """mid -> GroupNorm -> swish -> conv_out (JAX `_MidHead`)."""
    h = mid(t)
    if norm_conv_worthwhile(h.shape, conv.weight.shape[0]):
        return group_norm_conv(h.to(conv.dtype), norm.weight, norm.bias,
                               conv.weight, conv.bias)
    return conv(swish(norm(h)))
