"""GroupNorm and SpatialNorm formulas, and the GroupNorm moment pass (port
of control_gic_tpu/ops/fused_norm.py; its apply kernel is a later slice).

Statistics are taken in f32 as E[x^2] - E[x]^2 clamped at 0, with eps inside
the rsqrt: flax's nn.GroupNorm numerics, which F.group_norm does not share.
SpatialNorm (MoVQ) is GroupNorm(f) * conv_y(zq) + conv_b(zq) with the two
1x1 convs from the 4-channel zq written as a Z-term broadcast sum, and its
pointwise math runs in the activation dtype. Tensors are NCHW.

The moment pass (JAX `_gn_stats_pallas`) is the per-channel sum and sum of
squares over H*W, [B, 2, C] f32, then a group fold to per-channel (mean,
rstd). `gn_moments` launches the CUDA kernel kernels/gn_moments.cu for CUDA
tensors and runs `gn_moments_reference` for CPU tensors.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import use_kernel

GROUPS = 32
EPS = 1e-6

# Launches of the CUDA moment kernel in this process (gn_moments_kernel adds
# one per launch). A caller resets it to 0 and reads it back.
KERNEL_LAUNCHES = {"gn_moments": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _row_block(hw: int, c: int, target_bytes: int = 1 << 21) -> int:
    """Largest divisor of hw, a multiple of 8 or hw itself, whose [rb, C] f32
    block fits target_bytes; 0 when there is none. The JAX package's row
    block, sized for TPU VMEM: the port keeps it only as part of the chain's
    engagement rule (ops/norm_conv.admissible), so that it engages where the
    JAX package does."""
    cap = max(1, target_bytes // (4 * c))
    if hw <= cap:
        return hw
    rb = cap - cap % 8
    while rb >= 8 and hw % rb:
        rb -= 8
    return rb if rb >= 8 else 0


def gn_moments_reference(x: torch.Tensor) -> torch.Tensor:
    """Per-channel (sum, sum of squares) over H*W of x's f32 values:
    x [B, C, H, W] -> [B, 2, C] f32."""
    xf = x.float()
    return torch.stack([xf.sum(dim=(2, 3)), (xf * xf).sum(dim=(2, 3))], dim=1)


def gn_moments_kernel(x: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA moment kernel. CUDA tensors only: anything the kernel
    does not take raises, and a failed build or launch raises."""
    if not x.is_cuda:
        raise ValueError("gn_moments_kernel launches a CUDA kernel and takes "
                         "CUDA tensors only; use gn_moments() or "
                         "gn_moments_reference() for CPU tensors")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"gn_moments_kernel takes float32 or bfloat16, got "
                        f"{x.dtype}")
    if x.dim() != 4 or x.numel() == 0:
        raise ValueError(f"expected a non-empty [B, C, H, W] tensor, got "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("gn_moments_kernel needs a contiguous NCHW tensor")
    b, c, h, w = x.shape
    if b > 65535:
        raise ValueError(f"batch {b} is above the kernel's grid limit 65535")
    from ..kernels import build
    lib = build.load("gn_moments")
    mom = torch.empty(b, 2, c, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.cgic_gn_moments(
            ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(mom.data_ptr()),
            ctypes.c_int(b), ctypes.c_int(c), ctypes.c_longlong(h * w),
            ctypes.c_int(_DTYPE_CODE[x.dtype]), ctypes.c_void_p(stream))
    build.check(lib, rc, "gn_moments")
    KERNEL_LAUNCHES["gn_moments"] += 1
    return mom


def gn_moments(x: torch.Tensor) -> torch.Tensor:
    """[B, 2, C] f32 moments of x: the kernel for CUDA tensors, the plain
    version for CPU tensors (and inside ops.plain_versions())."""
    if use_kernel(x):
        return gn_moments_kernel(x)
    return gn_moments_reference(x)


def gn_stats_from_moments(mom: torch.Tensor, hw: int, groups: int = GROUPS
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold per-channel moments [B, 2, C] (sum, sumsq over hw pixels) into
    per-channel-expanded GroupNorm (mean_c, rstd_c), [B, C] f32 each: the
    group fold of JAX `_gn_stats_pallas` (and `stats_from_moments`)."""
    b, _, c = mom.shape
    cg = c // groups
    n = hw * cg
    s1 = mom[:, 0].reshape(b, groups, cg).sum(-1)
    s2 = mom[:, 1].reshape(b, groups, cg).sum(-1)
    mean = s1 / n
    var = torch.clamp(s2 / n - torch.square(mean), min=0.0)
    rstd = torch.rsqrt(var + EPS)
    return (mean.repeat_interleave(cg, dim=1),
            rstd.repeat_interleave(cg, dim=1))


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
