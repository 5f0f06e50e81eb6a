"""Vector quantization (port of control_gic_tpu/ops/quantize.py).

  - distance d = ||z||^2 + ||e||^2 - 2 z.e^T in f32;
  - argmin keeps the first (lowest) index on ties;
  - loss = mean((sg(zq) - z)^2) + beta * mean((zq - sg(z))^2), beta 0.25;
  - straight-through zq = z + sg(zq - z);
  - codebook usage counts, a histogram of fixed length (jnp.bincount with
    length=): a scatter-add, as torch.bincount reads the largest index back
    to the host and so could not run inside a captured program.
The latent is NCHW [B, D, H, W]; indices are [B, H, W].
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class VQResult(NamedTuple):
    z_q: torch.Tensor       # [B, D, H, W] quantized (straight-through)
    loss: torch.Tensor      # scalar commitment loss
    indices: torch.Tensor   # [B, H, W] int64 codebook indices
    counts: torch.Tensor    # [n_codes] int64 usage histogram of this batch


def vq_lookup(z: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Nearest-code indices. z: [B, D, H, W], codebook: [N, D] -> [B, H, W]."""
    b, d, h, w = z.shape
    zf = z.float().permute(0, 2, 3, 1).reshape(-1, d)
    cb = codebook.float()
    dist = ((zf * zf).sum(dim=1, keepdim=True) + (cb * cb).sum(dim=1)
            - 2.0 * torch.matmul(zf, cb.t()))
    return torch.argmin(dist, dim=1).reshape(b, h, w)


def vq_quantize(z: torch.Tensor, codebook: torch.Tensor,
                beta: float = 0.25) -> VQResult:
    """Full VQ forward: lookup, straight-through, commitment loss, counts."""
    indices = vq_lookup(z, codebook)
    z_q = codebook_gather(indices, codebook).to(z.dtype)
    zf32 = z.float()
    qf32 = z_q.float()
    loss = (torch.mean(torch.square(qf32.detach() - zf32))
            + beta * torch.mean(torch.square(qf32 - zf32.detach())))
    z_q = z + (z_q - z).detach()
    flat = indices.reshape(-1)
    counts = torch.zeros(codebook.shape[0], dtype=torch.int64,
                         device=flat.device).index_add_(
                             0, flat, torch.ones_like(flat))
    return VQResult(z_q=z_q, loss=loss, indices=indices, counts=counts)


def codebook_gather(indices: torch.Tensor,
                    codebook: torch.Tensor) -> torch.Tensor:
    """Decode-side lookup: [B, H, W] int -> [B, D, H, W]."""
    return codebook[indices.long()].permute(0, 3, 1, 2).contiguous()
