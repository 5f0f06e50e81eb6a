"""GroupNorm and SpatialNorm formulas (the plain versions of
control_gic_tpu/ops/fused_norm.py; its Pallas kernels are later slices).

Statistics are taken in f32 as E[x^2] - E[x]^2 clamped at 0, with eps inside
the rsqrt: flax's nn.GroupNorm numerics, which F.group_norm does not share.
SpatialNorm (MoVQ) is GroupNorm(f) * conv_y(zq) + conv_b(zq) with the two
1x1 convs from the 4-channel zq written as a Z-term broadcast sum, and its
pointwise math runs in the activation dtype. Tensors are NCHW.
"""
from __future__ import annotations

from typing import Tuple

import torch

GROUPS = 32
EPS = 1e-6


def gn_stats(f: torch.Tensor, groups: int = GROUPS
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(batch, channel) mean and rstd in f32, [B, C, 1, 1] each, from
    the per-group statistics of f: [B, C, H, W]."""
    b, c, h, w = f.shape
    xg = f.float().reshape(b, groups, c // groups * h * w)
    mean = xg.mean(dim=-1)
    mean2 = torch.square(xg).mean(dim=-1)
    var = torch.clamp(mean2 - torch.square(mean), min=0.0)
    rstd = torch.rsqrt(var + EPS)
    cg = c // groups
    return (mean.repeat_interleave(cg, dim=1).reshape(b, c, 1, 1),
            rstd.repeat_interleave(cg, dim=1).reshape(b, c, 1, 1))


def group_norm_reference(f: torch.Tensor, scale: torch.Tensor,
                         bias: torch.Tensor, groups: int = GROUPS
                         ) -> torch.Tensor:
    """flax nn.GroupNorm(groups, eps=1e-6) on f's f32 values; f32 out."""
    mean, rstd = gn_stats(f, groups)
    mul = rstd * scale.float()[:, None, None]
    return (f.float() - mean) * mul + bias.float()[:, None, None]


def spatial_norm_reference(f: torch.Tensor, zq_r: torch.Tensor,
                           gn_scale: torch.Tensor, gn_bias: torch.Tensor,
                           wy: torch.Tensor, by: torch.Tensor,
                           wb: torch.Tensor, bb: torch.Tensor,
                           act_swish: bool) -> torch.Tensor:
    """f: [B, C, H, W]; zq_r: [B, Z, H, W] (nearest-resized to f); wy, wb:
    [C, Z] 1x1-conv weights; by, bb, gn_scale, gn_bias: [C]. Output in
    f's dtype."""
    dt = f.dtype
    mean, rstd = gn_stats(f)
    col = lambda t: t.to(dt)[:, None, None]
    normed = (f - mean.to(dt)) * (rstd.to(dt) * col(gn_scale)) + col(gn_bias)
    z4 = zq_r.to(dt)
    terms_y = [z4[:, z:z + 1] * col(wy[:, z]) for z in range(z4.shape[1])]
    terms_b = [z4[:, z:z + 1] * col(wb[:, z]) for z in range(z4.shape[1])]
    y = col(by) + _chain_sum(terms_y)
    bmod = col(bb) + _chain_sum(terms_b)
    out = normed * y + bmod
    if act_swish:
        out = out * torch.sigmoid(out)
    return out


def _chain_sum(terms):
    # left to right, as Python's sum() adds them in the JAX formula
    acc = terms[0]
    for t in terms[1:]:
        acc = acc + t
    return acc
