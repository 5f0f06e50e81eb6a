"""CGIC codec core: encoder + router fusion + VQ + mask-aware decoder
(port of control_gic_tpu/models/cgic.py).

  encode: entropy maps (p8, p16) -> router masks -> encoder taps -> fused
          latent up4(coarse)*m_c + up2(medium)*m_m + fine*m_f -> 1x1
          quant_conv -> VQ;
  decode: 1x1 post_quant_conv -> mask-aware decoder conditioned on zq.
Images are NCHW; the ratios are Python floats, so the mode is a Python int.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from ..ops.entropy import patch_entropy
from ..ops.quantize import codebook_gather, vq_quantize
from ..ops.resample import upsample_nearest
from ..ops.router import (RouterOutput, grain_indices_from_masks,
                          triple_grain_router)
from ..utils.trace import span
from .blocks import Conv2d, GroupNorm32, lecun_normal_
from .decoder import Decoder
from .encoder import Encoder


@dataclasses.dataclass(frozen=True)
class CGICConfig:
    n_embed: int = 1024
    embed_dim: int = 4
    z_channels: int = 4
    ch: int = 128
    ch_mult: Tuple[int, ...] = (1, 2, 2, 4, 4)
    num_res_blocks: int = 2
    attn_resolutions: Tuple[int, ...] = (32,)
    resolution: int = 256
    in_channels: int = 3
    out_ch: int = 3
    dropout: float = 0.0
    beta: float = 0.25
    entropy_patch_sizes: Tuple[int, int] = (8, 16)
    dtype: str = "float32"
    remat: bool = False   # recompute the trunk's blocks in the backward

    @property
    def compute_dtype(self) -> torch.dtype:
        dt = getattr(torch, self.dtype, None)
        if not isinstance(dt, torch.dtype):
            raise ValueError(f"unknown dtype {self.dtype!r}")
        return dt


class EncodeOutput(NamedTuple):
    quant: torch.Tensor          # [B, D, Hl, Wl] straight-through zq
    emb_loss: torch.Tensor       # scalar VQ commitment loss
    indices: torch.Tensor        # [B, Hl, Wl] int64 codebook indices
    router: RouterOutput         # grain masks + mode
    grain_indices: torch.Tensor  # [B, Hl, Wl] partition map (0/1/2)
    counts: torch.Tensor         # [n_embed] codebook usage of this batch


class Codebook(nn.Module):
    """The VQ embedding table (state_dict key quantize.embedding.weight)."""

    def __init__(self, n_embed: int, embed_dim: int):
        super().__init__()
        self.embedding = nn.Module()
        self.embedding.weight = nn.Parameter(torch.empty(n_embed, embed_dim))

    @property
    def weight(self) -> torch.Tensor:
        return self.embedding.weight


class CGIC(nn.Module):
    """Granularity-adaptive VQGAN codec. Weights are drawn from `generator`
    (a fixed seed when None): flax's initialisers, lecun-normal convs, zero
    biases, unit norm scales, a uniform(-1/n, 1/n) codebook."""

    def __init__(self, config: CGICConfig = CGICConfig(),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        c = config
        self.config = config
        dt = c.compute_dtype
        self.encoder = Encoder(ch=c.ch, ch_mult=c.ch_mult,
                               num_res_blocks=c.num_res_blocks,
                               attn_resolutions=c.attn_resolutions,
                               resolution=c.resolution,
                               z_channels=c.z_channels,
                               in_channels=c.in_channels, dtype=dt,
                               dropout=c.dropout, remat=c.remat)
        self.decoder = Decoder(ch=c.ch, out_ch=c.out_ch, ch_mult=c.ch_mult,
                               num_res_blocks=c.num_res_blocks,
                               attn_resolutions=c.attn_resolutions,
                               resolution=c.resolution,
                               z_channels=c.z_channels,
                               zq_channels=c.embed_dim, dtype=dt,
                               dropout=c.dropout, remat=c.remat)
        self.quant_conv = Conv2d(c.z_channels, c.embed_dim, 1, dtype=dt)
        self.post_quant_conv = Conv2d(c.embed_dim, c.z_channels, 1, dtype=dt)
        self.quantize = Codebook(c.n_embed, c.embed_dim)
        self.init_weights(generator if generator is not None
                          else torch.Generator().manual_seed(0))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        for mod in self.modules():
            if isinstance(mod, Conv2d):
                lecun_normal_(mod.weight, generator)
                mod.bias.zero_()
            elif isinstance(mod, GroupNorm32):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
        n = self.config.n_embed
        self.quantize.weight.uniform_(-1.0 / n, 1.0 / n, generator=generator)

    @property
    def codebook(self) -> torch.Tensor:
        return self.quantize.weight

    def route(self, x: torch.Tensor, coarse_ratio: float,
              medium_ratio: float, per_sample: bool = False,
              group=None) -> RouterOutput:
        """Entropy maps + router; x: [B, 3, H, W]. With a process group (a
        data-parallel step, whose ranks' batches make one global batch),
        the batch-wide thresholds are those of the global batch, as JAX's
        router computes them under a jit over the sharded batch: the
        entropy maps are all-gathered, routed, and this rank keeps its
        rows."""
        p_m, p_c = self.config.entropy_patch_sizes
        e16, e8 = patch_entropy(x, p_c), patch_entropy(x, p_m)
        if group is None or per_sample:
            return triple_grain_router(e16, e8, coarse_ratio, medium_ratio,
                                       per_sample=per_sample)
        from ..parallel.multihost import all_gather   # parallel/ imports us
        with span("cgic.dp.gather"):
            e16, e8 = all_gather(e16, group), all_gather(e8, group)
        out = triple_grain_router(e16, e8, coarse_ratio, medium_ratio)
        b, r = x.shape[0], dist.get_rank(group)
        return RouterOutput(*(m[r * b:(r + 1) * b] for m in out.masks),
                            out.mode)

    def latent(self, x: torch.Tensor, router: RouterOutput, **drop
               ) -> torch.Tensor:
        """The fused pre-VQ latent quant_conv(fuse(taps, masks)),
        [B, embed_dim, H/4, W/4] in the compute dtype. `drop`: the
        encoder's deterministic and generator arguments."""
        dt = self.config.compute_dtype
        z_fine, z_medium, z_coarse = self.encoder(x.to(dt), **drop)
        m_c, m_m, m_f = (m.to(dt)[:, None] for m in router.masks)
        h = (upsample_nearest(z_coarse, 4) * upsample_nearest(m_c, 4)
             + upsample_nearest(z_medium, 2) * upsample_nearest(m_m, 2)
             + z_fine * m_f)
        return self.quant_conv(h)

    def encode(self, x: torch.Tensor, coarse_ratio: float,
               medium_ratio: float, *, per_sample: bool = False,
               deterministic: bool = True,
               generator: Optional[torch.Generator] = None,
               group=None) -> EncodeOutput:
        """With dropout > 0 and deterministic=False the blocks' dropout
        draws from `generator` (JAX: the 'dropout' rng). `group`: see
        route."""
        router = self.route(x, coarse_ratio, medium_ratio,
                            per_sample=per_sample, group=group)
        latent = self.latent(x, router, deterministic=deterministic,
                             generator=generator)
        vq = vq_quantize(latent.float(), self.codebook.float(),
                         beta=self.config.beta)
        return EncodeOutput(quant=vq.z_q, emb_loss=vq.loss,
                            indices=vq.indices, router=router,
                            grain_indices=grain_indices_from_masks(router),
                            counts=vq.counts)

    def decode(self, quant: torch.Tensor, masks, *,
               deterministic: bool = True,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        quant = quant.to(self.config.compute_dtype)
        return self.decoder(self.post_quant_conv(quant), quant, masks,
                            deterministic=deterministic, generator=generator)

    def decode_indices(self, indices: torch.Tensor, masks) -> torch.Tensor:
        """Receiver-side decode from an index grid [B, Hl, Wl]."""
        return self.decode(codebook_gather(indices, self.codebook), masks)

    def forward(self, x: torch.Tensor, coarse_ratio: float = 0.1,
                medium_ratio: float = 0.4, *, deterministic: bool = True,
                generator: Optional[torch.Generator] = None, group=None):
        enc = self.encode(x, coarse_ratio, medium_ratio,
                          deterministic=deterministic, generator=generator,
                          group=group)
        return self.decode(enc.quant, enc.router.masks,
                           deterministic=deterministic,
                           generator=generator), enc
