"""H-sharded single-pass encoder: the entropy maps, the routing, the
triple-tap trunk and the VQ with the image height sharded over the mesh
(port of control_gic_tpu/parallel/spatial_encoder.py).

On top of the decoder's sharded layers (halo convs, psum GroupNorm,
all-gathered attention; spatial_decoder.py):

  - the stride-2 Downsample with the reference's (0, 1) pad: each shard
    takes the first two rows of the next one (zeros below the last), so
    that its last window reaches across the boundary; H_s stays even and
    the shards' outputs stay aligned;
  - the router: the shards' entropy maps are all-gathered (one value per
    8 or 16 px patch), ops/router.py's triple_grain_router runs on the whole
    map (all 7 modes, its thresholds and ties), and each shard keeps its
    rows, so the masks equal the single-device router's exactly.

It reads the port's `Encoder`, the `quant_conv` and the codebook. With one
shard every layer is the module's own unchained forward.

Constraint: H divisible by 64 * n_shards (the 16 px entropy patches, four
downsamplings and the coarse mask's alignment).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from ..ops.entropy import patch_entropy
from ..ops.quantize import vq_lookup
from ..ops.resample import upsample_nearest
from ..ops.router import triple_grain_router
from .halo import Shards, join_rows, split_rows
from .mesh import module_replicas
from .spatial_decoder import (Mods, attn_block, conv, mid, norm, resnet_block,
                              subs)


def _downsample(xs: Shards, downs: Mods) -> Shards:
    """Downsample (pad (0, 1, 0, 1), 3x3 stride-2 VALID) on the shards:
    the rows below each shard come from the next one, zeros at the global
    bottom; W is padded (0, 1) locally."""
    if len(xs) == 1:
        return [downs[0](xs[0])]
    c = downs[0].conv
    dt = c.dtype
    xs = [x.to(dt) for x in xs]
    out = []
    for i, (x, d) in enumerate(zip(xs, downs)):
        below = (xs[i + 1][:, :, :2].to(x.device) if i < len(xs) - 1
                 else x.new_zeros(x.shape[:2] + (2, x.shape[3])))
        y = F.conv2d(F.pad(torch.cat([x, below], 2), (0, 1, 0, 0)),
                     d.conv.weight.to(dt), d.conv.bias.to(dt), 2)
        out.append(y[:, :, :x.shape[2] // 2])
    return out


def _route(e16s: Shards, e8s: Shards, coarse_ratio: float,
           medium_ratio: float) -> Tuple[Shards, Shards, Shards]:
    """The router on the gathered entropy maps; each shard's rows of the
    masks, on its device."""
    out = triple_grain_router(join_rows(e16s, 1), join_rows(e8s, 1),
                              coarse_ratio, medium_ratio)
    devices = [e.device for e in e16s]
    return tuple(split_rows(m, devices, 1) for m in out.masks)


def _head(ts: Shards, encs: Mods, suffix: str, mid_name: str) -> Shards:
    """mid -> GroupNorm -> swish -> conv_out (the encoder's `_head`)."""
    h = mid(ts, None, subs(encs, mid_name))
    h = norm(h, None, subs(encs, "norm_out" + suffix), "swish")
    return conv(h, subs(encs, "conv_out" + suffix))


def latent_shards(xs: Shards, encs: Mods, qcs: Mods, coarse_ratio: float,
                  medium_ratio: float,
                  patch_sizes: Tuple[int, int] = (8, 16)):
    """The pre-VQ latent over the shards (CGIC.route and CGIC.latent: the
    router, the trunk, the heads, the grain fusion and quant_conv):
    (latent, m_c, m_m, m_f), each a list of shards."""
    p_m, p_c = patch_sizes
    m_c, m_m, m_f = _route([patch_entropy(x, p_c) for x in xs],
                           [patch_entropy(x, p_m) for x in xs],
                           coarse_ratio, medium_ratio)
    enc = encs[0]
    dt = qcs[0].dtype
    h = conv([x.to(dt) for x in xs], subs(encs, "conv_in"))
    taps = {}
    for i_level, level in enumerate(enc.down):
        for i_block in range(len(level.block)):
            h = resnet_block(h, None,
                             subs(encs, f"down.{i_level}.block.{i_block}"))
            if len(level.attn):
                h = attn_block(h, None,
                               subs(encs, f"down.{i_level}.attn.{i_block}"))
        taps[i_level] = h
        if i_level != enc.num_res - 1:
            h = _downsample(h, subs(encs, f"down.{i_level}.downsample"))
    z_f = _head(taps[enc.num_res - 3], encs, "_fine", "mid_fine")
    z_m = _head(taps[enc.num_res - 2], encs, "", "mid")
    z_c = _head(h, encs, "_coarse", "mid_coarse")

    gate = lambda m, s: upsample_nearest(m.to(dt)[:, None], s)
    fused = [upsample_nearest(zc, 4) * gate(mc, 4)
             + upsample_nearest(zm, 2) * gate(mm, 2) + zf * gate(mf, 1)
             for zc, zm, zf, mc, mm, mf in zip(z_c, z_m, z_f, m_c, m_m, m_f)]
    return [qc(f) for qc, f in zip(qcs, fused)], m_c, m_m, m_f


@torch.no_grad()
def encode_spatial_sharded(mesh, encoder, quant_conv, codebook: torch.Tensor,
                           x: torch.Tensor, coarse_ratio: float,
                           medium_ratio: float, axis: str = "data",
                           patch_sizes: Sequence[int] = (8, 16)):
    """Encode x [B, 3, H, W] (float, [0, 1]) with H sharded over the mesh's
    `axis`: (indices [B, H/4, W/4], (m_c, m_m, m_f)) on the first shard's
    device. `encoder`, `quant_conv` and `codebook` are the port's CGIC's
    (model.encoder, model.quant_conv, model.codebook); patch_sizes its
    config's entropy_patch_sizes."""
    devices = mesh.axis_devices(axis)
    n = len(devices)
    if x.shape[2] % (64 * n):
        raise ValueError(f"H {x.shape[2]} does not divide by 64 * {n} "
                         "shards")
    lat, m_c, m_m, m_f = latent_shards(
        split_rows(x.float(), devices), module_replicas(encoder, devices),
        module_replicas(quant_conv, devices), float(coarse_ratio),
        float(medium_ratio), tuple(patch_sizes))
    idx = [vq_lookup(z.float(), codebook.to(z.device).float()) for z in lat]
    return join_rows(idx, 1), tuple(join_rows(m, 1) for m in (m_c, m_m, m_f))
