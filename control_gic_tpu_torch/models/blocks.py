"""VQGAN building blocks as nn.Modules, NCHW (port of
control_gic_tpu/models/blocks.py: the unfused branch, and the ResnetBlock's
chained and per-call fused branches through ops/norm_conv.py).

Parameters are kept in f32 and cast to the block's compute dtype at use, as
flax does. Module and parameter names follow the reference checkpoint's
state_dict keys (norm1.weight, norm1.norm_layer.weight, conv_y, q, k, v,
proj_out, nin_shortcut, downsample.conv, upsample.conv), weights OIHW.

  - GroupNorm32: 32 groups, eps 1e-6, computed in f32;
  - SpatialNorm: GroupNorm(f) * conv_y(zq) + conv_b(zq), zq nearest-resized,
    through ops.fused_norm.spatial_norm (the moment pass and the apply
    kernel on the card where no gradient is recorded, and under
    CONTROL_GIC_FUSED_NORM);
  - ResnetBlock: norm -> swish -> 3x3 conv, twice, 1x1 nin_shortcut on a
    channel change; SpatialNorm norms when zq_cond; dropout before conv2
    when not deterministic. It chains where the caller threads moments and
    chain_admissible holds, else runs each norm+conv pair as one per-call
    op where norm_conv_worthwhile holds (CONTROL_GIC_NORM_CONV), else
    unfused; an active dropout keeps it unfused, as in JAX;
  - AttnBlock: norm -> 1x1 q/k/v -> single-head attention over the tokens
    flattened row-major over (H, W) -> 1x1 proj_out, residual;
  - Downsample: pad (0,1,0,1), 3x3 conv stride 2;
  - Upsample: nearest x2 then 3x3 conv, computed in the subpixel form.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import attention
from ..ops.fused_norm import group_norm_reference, spatial_norm
from ..ops.norm_conv import (chain_admissible, group_norm_conv,
                             group_norm_conv_mom, norm_conv_worthwhile,
                             spatial_norm_conv, spatial_norm_conv_mom,
                             stats_from_moments)
from ..ops.resample import (nearest_resize, subpixel_enabled,
                            upsample2_conv3x3, upsample_nearest)


def swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax nn.Dropout when not deterministic: each element is kept with
    probability 1 - rate and scaled by 1 / (1 - rate), the rest are zeroed.
    The draws come from `generator` (on x's device); without one it raises,
    as flax raises without a 'dropout' rng."""
    if generator is None:
        raise ValueError("dropout > 0 with deterministic=False draws from a "
                         "torch.Generator: pass generator= (on the input's "
                         "device)")
    if rate >= 1.0:
        return torch.zeros_like(x)
    keep_prob = 1.0 - rate
    keep = torch.rand(x.shape, generator=generator,
                      device=x.device) < keep_prob
    return torch.where(keep, x / keep_prob, 0.0)


def lecun_normal_(w: torch.Tensor, generator: torch.Generator) -> None:
    """flax's lecun_normal, in place: a normal truncated at ±2 std,
    rescaled so that its std is sqrt(1 / fan_in)."""
    std = math.sqrt(1.0 / w[0].numel()) / .87962566103423978
    nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=generator)


class Conv2d(nn.Module):
    """Conv with f32 OIHW `weight` and `bias`, run in `dtype`. Parameters are
    left uninitialised here; CGIC.init_weights fills them."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 padding: Optional[int] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, kernel, kernel))
        self.bias = nn.Parameter(torch.empty(cout))
        self.stride = stride
        self.padding = kernel // 2 if padding is None else padding
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        return F.conv2d(x.to(dt), self.weight.to(dt), self.bias.to(dt),
                        self.stride, self.padding)


class GroupNorm32(nn.Module):
    """GroupNorm(32, eps 1e-6, affine) in f32, output in `dtype`."""

    def __init__(self, channels: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(channels))
        self.bias = nn.Parameter(torch.empty(channels))
        self.dtype = dtype

    def forward(self, x: torch.Tensor, zq=None,
                act: Optional[str] = None) -> torch.Tensor:
        h = group_norm_reference(x, self.weight, self.bias).to(self.dtype)
        return swish(h) if act == "swish" else h


class SpatialNorm(nn.Module):
    """MoVQ spatially modulated GroupNorm conditioned on zq [B, Z, h, w]."""

    def __init__(self, channels: int, zq_channels: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm_layer = GroupNorm32(channels, dtype)
        self.conv_y = Conv2d(zq_channels, channels, 1, dtype=dtype)
        self.conv_b = Conv2d(zq_channels, channels, 1, dtype=dtype)
        self.dtype = dtype

    def forward(self, f: torch.Tensor, zq: torch.Tensor,
                act: Optional[str] = None) -> torch.Tensor:
        zq_r = nearest_resize(zq, f.shape[2], f.shape[3])
        return spatial_norm(f.to(self.dtype), zq_r, *self.params(),
                            act_swish=(act == "swish"))

    def params(self):
        """(gs, gb, wy, by, wb, bb): the norm's scale and bias and the two
        1x1 convs as [C, Z] matrices with their biases."""
        return (self.norm_layer.weight, self.norm_layer.bias,
                self.conv_y.weight[:, :, 0, 0], self.conv_y.bias,
                self.conv_b.weight[:, :, 0, 0], self.conv_b.bias)


def make_norm(channels: int, zq_channels: Optional[int],
              dtype: torch.dtype) -> nn.Module:
    """SpatialNorm when conditioned on zq (zq_channels given), else
    GroupNorm32; both take (x, zq, act)."""
    if zq_channels:
        return SpatialNorm(channels, zq_channels, dtype)
    return GroupNorm32(channels, dtype)


class ResnetBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: Optional[int] = None,
                 zq_channels: Optional[int] = None,
                 dtype: torch.dtype = torch.float32, dropout: float = 0.0):
        super().__init__()
        out_channels = out_channels or in_channels
        self.dropout = dropout
        self.norm1 = make_norm(in_channels, zq_channels, dtype)
        self.conv1 = Conv2d(in_channels, out_channels, 3, dtype=dtype)
        self.norm2 = make_norm(out_channels, zq_channels, dtype)
        self.conv2 = Conv2d(out_channels, out_channels, 3, dtype=dtype)
        self.nin_shortcut = (Conv2d(in_channels, out_channels, 1, dtype=dtype)
                             if in_channels != out_channels else None)

    def forward(self, x: torch.Tensor, zq: Optional[torch.Tensor] = None,
                mom_in: Optional[torch.Tensor] = None,
                emit_mom: bool = False, *, deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        """mom_in / emit_mom thread the stats-in-epilogue chain through a
        trunk (ops/norm_conv.py): mom_in is the [B, 2, C] moments of x that
        the previous chained block emitted (norm1's stats pass is then
        skipped); emit_mom=True returns (out, moments of out). The caller
        decides chain membership with chain_admissible. With dropout > 0
        and deterministic=False, the dropout draws from `generator`."""
        b, _, hh, ww = x.shape
        out_ch = self.conv1.weight.shape[0]
        drop = self.dropout > 0.0 and not deterministic
        if (not drop and (emit_mom or mom_in is not None)
                and chain_admissible(x.shape, out_ch)):
            return self._chained(x, zq, mom_in, emit_mom)
        assert mom_in is None and not emit_mom, \
            "mom_in/emit_mom passed to a block that cannot chain " \
            "(the caller checks chain_admissible first)"
        if (not drop and norm_conv_worthwhile(x.shape, out_ch)
                and norm_conv_worthwhile((b, out_ch, hh, ww), out_ch)):
            # JAX's fuse / fuse_plain branches: each pair as one call
            op = self._pair_op(x, zq, spatial_norm_conv, group_norm_conv)
            h = op(op(x.to(self.conv1.dtype), self.norm1, self.conv1),
                   self.norm2, self.conv2)
        else:
            h = self.conv1(self.norm1(x, zq, act="swish"))
            h = self.norm2(h, zq, act="swish")
            if drop:
                h = dropout(h, self.dropout, generator)
            h = self.conv2(h)
        if self.nin_shortcut is not None:
            x = self.nin_shortcut(x)
        return x + h

    def _pair_op(self, x, zq, sn_op, gn_op):
        """op(h, norm, conv, **kw): a norm+conv pair of this block through
        sn_op (SpatialNorm form, zq resized to x and cast to the compute
        dtype) or gn_op (GroupNorm form)."""
        if isinstance(self.norm1, SpatialNorm):
            zq_r = nearest_resize(zq, x.shape[2], x.shape[3]).to(
                self.conv1.dtype)
            return lambda h, norm, conv, **kw: sn_op(
                h, zq_r, *norm.params(), conv.weight, conv.bias, **kw)
        return lambda h, norm, conv, **kw: gn_op(
            h, norm.weight, norm.bias, conv.weight, conv.bias, **kw)

    def _chained(self, x, zq, mom_in, emit_mom):
        """Both norm+conv pairs as chain calls (JAX ResnetBlock's chained
        branch): conv1 always emits its moments, which give conv2's stats;
        conv2 adds the residual."""
        hw = x.shape[2] * x.shape[3]
        xd = x.to(self.conv1.dtype)
        conv_mom = self._pair_op(x, zq, spatial_norm_conv_mom,
                                 group_norm_conv_mom)
        stats1 = stats_from_moments(mom_in, hw) if mom_in is not None else None
        h, mom1 = conv_mom(xd, self.norm1, self.conv1, stats=stats1,
                           emit_mom=True)
        res = self.nin_shortcut(x) if self.nin_shortcut is not None else xd
        return conv_mom(h, self.norm2, self.conv2, res=res,
                        stats=stats_from_moments(mom1, hw), emit_mom=emit_mom)


class AttnBlock(nn.Module):
    def __init__(self, channels: int, zq_channels: Optional[int] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm = make_norm(channels, zq_channels, dtype)
        self.q = Conv2d(channels, channels, 1, dtype=dtype)
        self.k = Conv2d(channels, channels, 1, dtype=dtype)
        self.v = Conv2d(channels, channels, 1, dtype=dtype)
        self.proj_out = Conv2d(channels, channels, 1, dtype=dtype)

    def forward(self, x: torch.Tensor,
                zq: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, c, h, w = x.shape
        hn = self.norm(x, zq)

        def tokens(t):   # [B, C, H, W] -> [B, H*W, C], row-major over (H, W)
            return t.reshape(b, c, h * w).transpose(1, 2).contiguous()

        out = attention(tokens(self.q(hn)), tokens(self.k(hn)),
                        tokens(self.v(hn)))
        out = out.transpose(1, 2).reshape(b, c, h, w)
        return x + self.proj_out(out)


class Downsample(nn.Module):
    """Asymmetric pad (0,1,0,1) then 3x3 stride-2 conv: halves H and W."""

    def __init__(self, channels: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, stride=2, padding=0,
                           dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class Upsample(nn.Module):
    """x2 nearest upsample then 3x3 conv: in the subpixel form (the four
    output phases as one 2x2 conv at low resolution) unless
    CONTROL_GIC_SUBPIXEL=0, which runs the two steps as written. Same
    parameters either way."""

    def __init__(self, channels: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if subpixel_enabled():
            return upsample2_conv3x3(x.to(self.conv.dtype), self.conv.weight,
                                     self.conv.bias)
        return self.conv(upsample_nearest(x, 2))
