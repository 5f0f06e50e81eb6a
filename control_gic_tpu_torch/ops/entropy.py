"""Per-patch Shannon entropy via a Gaussian-KDE soft histogram
(port of control_gic_tpu/ops/entropy.py).

gray = 0.2989 R + 0.5870 G + 0.1140 B over non-overlapping p x p patches,
32 bins spanning [-1, 1], sigma 0.01, eps 1e-40:
    pdf = mean over pixels of exp(-0.5 ((v - bin) / sigma)^2)
    pdf = pdf / (sum(pdf) + eps) + eps;   H = -sum(pdf log pdf)
Terms with pdf <= 1e-37 count as 0: both XLA and CUDA flush denormals, so
the reference's eps would not keep log(pdf) finite.
"""
from __future__ import annotations

import torch

_GRAY_WEIGHTS = (0.2989, 0.5870, 0.1140)
_NUM_BINS = 32
_SIGMA = 0.01
_EPS = 1e-40
_TINY = 1e-37


def patch_entropy(x: torch.Tensor, patch_size: int) -> torch.Tensor:
    """x: [B, 3, H, W] image batch -> [B, H // p, W // p] float32 entropy."""
    b, c, h, w = x.shape
    assert c == 3, f"expected RGB NCHW input, got {tuple(x.shape)}"
    p = patch_size
    assert h % p == 0 and w % p == 0, (tuple(x.shape), p)
    x = x.float()
    gray = (_GRAY_WEIGHTS[0] * x[:, 0] + _GRAY_WEIGHTS[1] * x[:, 1]
            + _GRAY_WEIGHTS[2] * x[:, 2])                        # [B, H, W]
    patches = gray.reshape(b, h // p, p, w // p, p).permute(0, 1, 3, 2, 4)
    patches = patches.reshape(b, h // p, w // p, p * p)
    # bin centres may differ from jnp.linspace's in the last bit; the
    # entropy agrees to well within 1e-5 (tests/test_torch_ops.py)
    bins = torch.linspace(-1.0, 1.0, _NUM_BINS, device=x.device)
    resid = patches[..., None] - bins                            # [..,P,32]
    kernel = torch.exp(-0.5 * torch.square(resid / _SIGMA))
    pdf = kernel.mean(dim=-2)                                     # [..,32]
    pdf = pdf / (pdf.sum(dim=-1, keepdim=True) + _EPS) + _EPS
    plogp = torch.where(pdf > _TINY, pdf * torch.log(pdf.clamp_min(_TINY)),
                        torch.zeros_like(pdf))
    return -plogp.sum(dim=-1)
