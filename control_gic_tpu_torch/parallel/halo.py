"""Spatial (height-sharded) primitives: the shards, their collectives, and
the halo convs (port of control_gic_tpu/parallel/halo.py).

The H-sharded codec (spatial_encoder.py, spatial_decoder.py) runs in one
process over the devices of a `Mesh`, SPMD over a list of shards: shard i is
rows [i*H/n, (i+1)*H/n) of an NCHW tensor, on the mesh's i-th device along
the axis. Each layer function takes the list and does its collective
explicitly, where JAX's shard_map body calls lax:

  halo_exchange:  each shard gets `halo` rows of each neighbour (a copy to
                  its device; zeros at the global top and bottom), JAX's
                  ppermute pair;
  psum:           the shards' partial sums added on the first shard's
                  device and handed back to each shard's device;
  all_gather:     the shards concatenated, on each shard's device.

With one shard every collective is the identity and the layers call the
plain ops: the collective-free specialisation JAX takes at axis size 1.
"""
from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn.functional as F

from ..ops.resample import phase_conv_kernel, phase_unshuffle

Shards = List[torch.Tensor]


def split_rows(x: torch.Tensor, devices: Sequence[torch.device],
               dim: int = 2) -> Shards:
    """x split into len(devices) equal blocks along `dim` (H of NCHW by
    default), block i on devices[i]."""
    n = len(devices)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not divide "
                         f"into {n} shards")
    return [b.to(d) for b, d in zip(torch.chunk(x, n, dim), devices)]


def join_rows(xs: Shards, dim: int = 2) -> torch.Tensor:
    """The shards concatenated along `dim` on the first shard's device."""
    return torch.cat([x.to(xs[0].device) for x in xs], dim)


def psum(parts: Shards) -> Shards:
    """The sum of the shards' tensors, on each shard's device (added in
    shard order on the first one's)."""
    if len(parts) == 1:
        return parts
    total = parts[0]
    for p in parts[1:]:
        total = total + p.to(total.device)
    return [total.to(p.device) for p in parts]


def all_gather(xs: Shards, dim: int) -> Shards:
    """The shards concatenated along `dim`, on each shard's device."""
    if len(xs) == 1:
        return xs
    full = join_rows(xs, dim)
    return [full.to(x.device) for x in xs]


def halo_exchange(xs: Shards, halo: int) -> Shards:
    """Each shard [B, C, H_s, W] padded along H with `halo` rows of its
    neighbours (zeros at the global boundary): [B, C, H_s + 2*halo, W]."""
    out = []
    for i, x in enumerate(xs):
        zeros = x.new_zeros(x.shape[:2] + (halo, x.shape[3]))
        top = xs[i - 1][:, :, -halo:].to(x.device) if i > 0 else zeros
        bot = (xs[i + 1][:, :, :halo].to(x.device) if i < len(xs) - 1
               else zeros)
        out.append(torch.cat([top, x, bot], dim=2))
    return out


def halo_conv2d(xs: Shards, weight: torch.Tensor,
                bias: torch.Tensor) -> Shards:
    """SAME conv of an odd kernel (OIHW [Co, C, kh, kw]) over H-sharded
    NCHW shards: exchange kh//2 halo rows, conv VALID along H and SAME along
    W. The halo is exactly the receptive field the interior needs, so the
    result equals the unsharded conv's rows."""
    if len(xs) == 1:
        return [F.conv2d(xs[0], weight, bias,
                         padding=(weight.shape[2] // 2, weight.shape[3] // 2))]
    return [F.conv2d(xh, weight.to(xh.device), bias.to(xh.device),
                     padding=(0, weight.shape[3] // 2))
            for xh in halo_exchange(xs, weight.shape[2] // 2)]


def halo_upsample2_conv3x3(xs: Shards, weight: torch.Tensor,
                           bias: torch.Tensor) -> Shards:
    """H-sharded subpixel upsample + 3x3 conv, equal to the unsharded
    ops/resample.py::upsample2_conv3x3: the 4-phase 2x2 conv reads one row
    beyond each shard's boundary (the global form pads H by 1 on both
    sides), so a 1-row halo and a VALID-along-H conv give the global y's
    rows [s*H_s, s*H_s + H_s], which unshuffle with no index change.
    Shards [B, C, H_s, W] -> [B, Co, 2*H_s, 2*W]."""
    out = []
    for xh, x in zip(halo_exchange(xs, 1), xs):
        n, _, h, w = x.shape
        k4 = phase_conv_kernel(weight.to(x.device), x.dtype)
        y = F.conv2d(xh, k4, padding=(0, 1))    # [B, 4Co, H_s + 1, W + 1]
        out.append(phase_unshuffle(y, n, h, w, weight.shape[0],
                                   bias.to(x.device)))
    return out


def sharded_conv2d_same(mesh, x: torch.Tensor, weight: torch.Tensor,
                        bias: torch.Tensor, axis: str = "data"
                        ) -> torch.Tensor:
    """halo_conv2d with x [B, C, H, W] sharded on H over the mesh's `axis`;
    the result joined on x's first shard's device."""
    xs = split_rows(x, mesh.axis_devices(axis))
    return join_rows(halo_conv2d(xs, weight, bias))
