"""PatchGAN discriminator (pix2pix NLayerDiscriminator), NCHW (port of
control_gic_tpu/models/discriminator.py).

With ndf=64, n_layers=2 (the training recipe):
  conv(3->64, k4 s2 p1) + LeakyReLU(0.2)
  conv(64->128, k4 s2 p1, no bias) + BatchNorm + LeakyReLU
  conv(128->256, k4 s1 p1, no bias) + BatchNorm + LeakyReLU
  conv(256->1, k4 s1 p1) -> logit map

`BatchNorm` follows flax's nn.BatchNorm(momentum=0.9, epsilon=1e-5), not
torch's BatchNorm2d: in train mode it normalises with the batch's mean and
its biased variance E[x²] − E[x]² (clamped at 0) and updates
running = 0.9·running + 0.1·batch with that same biased variance, where
BatchNorm2d would store the unbiased one. In eval mode it uses the running
statistics. `use_actnorm=True` swaps every norm for ActNorm, and the inner
convs then keep their bias (the reference's rule).

Under data parallelism the batch statistics are those of the global batch,
as JAX computes them (its step is jitted over the global batch, and flax's
BatchNorm reduces over all of it): given a process group, the sums, sums of
squares and counts are added over the group before the mean and variance
(`parallel.multihost.all_reduce_sum`, whose gradient is added over the group
too). The running statistics keep the flax rule, which
torch.nn.SyncBatchNorm does not.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.trace import span
from .blocks import lecun_normal_


class BatchNorm(nn.Module):
    """flax nn.BatchNorm over the channels of an NCHW tensor, in f32."""

    def __init__(self, channels: int, momentum: float = 0.9,
                 eps: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))
        self.momentum = momentum
        self.eps = eps

    def forward(self, x: torch.Tensor, group=None) -> torch.Tensor:
        """group: the process group over which the batch is split (train
        mode: the statistics are the whole batch's), or None."""
        x = x.float()
        if self.training and group is not None:
            # here, not at the top: parallel/ imports the codec, which
            # imports the models
            from ..parallel.multihost import all_reduce_sum
            c = x.shape[1]
            with span("cgic.dp.bn"):
                sums = all_reduce_sum(torch.cat([
                    x.sum(dim=(0, 2, 3)), torch.square(x).sum(dim=(0, 2, 3)),
                    x.new_full((1,), x.numel() // c)]), group)
            mean = sums[:c] / sums[2 * c]
            var = torch.clamp(sums[c:2 * c] / sums[2 * c]
                              - torch.square(mean), min=0.0)
        elif self.training:
            mean = x.mean(dim=(0, 2, 3))
            var = torch.clamp(torch.square(x).mean(dim=(0, 2, 3))
                              - torch.square(mean), min=0.0)
        if self.training:
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(m).add_((1 - m) * mean.detach())
                self.running_var.mul_(m).add_((1 - m) * var.detach())
        else:
            mean, var = self.running_mean, self.running_var
        col = lambda t: t[None, :, None, None]
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - col(mean)) * col(mul) + col(self.bias)


class ActNorm(nn.Module):
    """Per-channel affine scale * (x + loc), identity at init; see
    `actnorm_data_init` for the reference's data-dependent init."""

    def __init__(self, channels: int):
        super().__init__()
        self.loc = nn.Parameter(torch.zeros(channels))
        self.scale = nn.Parameter(torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return (self.scale[None, :, None, None]
                * (x.float() + self.loc[None, :, None, None]))


def actnorm_data_init(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(loc, scale) from a representative NCHW batch: loc = −mean,
    scale = 1 / (std + 1e-6), with the Bessel-corrected std."""
    xf = x.float().transpose(0, 1).reshape(x.shape[1], -1)
    return -xf.mean(dim=1), 1.0 / (xf.std(dim=1, unbiased=True) + 1e-6)


class NLayerDiscriminator(nn.Module):
    def __init__(self, ndf: int = 64, n_layers: int = 2,
                 use_actnorm: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.n_layers = n_layers
        bias = use_actnorm
        norm = ActNorm if use_actnorm else BatchNorm
        self.conv0 = nn.Conv2d(3, ndf, 4, 2, 1)
        cin = ndf
        for n in range(1, n_layers + 1):
            nf = min(2 ** n, 8)
            stride = 2 if n < n_layers else 1
            setattr(self, f"conv{n}", nn.Conv2d(cin, ndf * nf, 4, stride, 1,
                                                bias=bias))
            setattr(self, f"bn{n}", norm(ndf * nf))
            cin = ndf * nf
        self.conv_out = nn.Conv2d(cin, 1, 4, 1, 1)
        self._init(generator if generator is not None
                   else torch.Generator().manual_seed(0))

    @torch.no_grad()
    def _init(self, generator: torch.Generator) -> None:
        for mod in self.modules():
            if isinstance(mod, nn.Conv2d):
                lecun_normal_(mod.weight, generator)
                if mod.bias is not None:
                    mod.bias.zero_()

    def forward(self, x: torch.Tensor, group=None) -> torch.Tensor:
        """group: the process group of a data-parallel step, whose ranks'
        batches make the BatchNorm statistics together (None: this
        batch alone)."""
        h = F.leaky_relu(self.conv0(x.float()), 0.2)
        for n in range(1, self.n_layers + 1):
            norm = getattr(self, f"bn{n}")
            h = getattr(self, f"conv{n}")(h)
            h = norm(h, group) if isinstance(norm, BatchNorm) else norm(h)
            h = F.leaky_relu(h, 0.2)
        return self.conv_out(h)
