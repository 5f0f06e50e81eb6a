"""LPIPS (net-lin: AlexNet / VGG16 / SqueezeNet) perceptual distance, NCHW
(port of control_gic_tpu/models/lpips.py).

  - with normalize=True the inputs are taken as [0, 1] and mapped to [-1, 1]
    (the training loss passes [-1, 1] tensors all the same: the reference's
    quirk, kept); then the v0.1 scaling layer (x - shift) / scale;
  - the backbone's taps: alex relu1..relu5 (64, 192, 384, 256, 256); vgg
    relu1_2..relu5_3 (64, 128, 256, 512, 512); squeeze the 7 taps of
    SqueezeNet 1.1 (64, 128, 256, 384, 384, 512, 512), with ceil-mode 3x3/2
    max pools;
  - per tap: unit-normalise over channels (eps 1e-10), squared difference,
    a bias-free 1x1 linear head, the spatial mean; the taps are summed.

The backbones are `nn.Sequential`s laid out as torchvision's `.features`, so
their state_dict keys (`net.<index>.weight`) are torchvision's. The lin
heads are `lin0`, `lin1`, ... of shape [channels]. The backbone is random,
drawn from a generator (the ImageNet weights need a download); the
reference's trained v0.1 lin heads ship with this package as npz data
(`lpips_weights/`) and `with_bundled_lin_heads` installs them.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
import torch
from torch import nn

from .blocks import lecun_normal_

_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)
CHNS = {
    "alex": (64, 192, 384, 256, 256),
    "vgg": (64, 128, 256, 512, 512),
    "squeeze": (64, 128, 256, 384, 384, 512, 512),
}
# the index after each tap in the `.features` stack (pretrained_networks.py)
TAP_ENDS = {"alex": (2, 5, 8, 10, 12), "vgg": (4, 9, 16, 23, 30),
            "squeeze": (2, 5, 8, 10, 11, 12, 13)}
_WEIGHTS_DIR = os.path.join(os.path.dirname(__file__), "lpips_weights")


class Fire(nn.Module):
    """SqueezeNet fire module: squeeze 1x1 -> relu -> (expand1x1 | expand3x3)
    -> relu -> concat over channels."""

    def __init__(self, cin: int, squeeze: int, expand: int):
        super().__init__()
        self.squeeze = nn.Conv2d(cin, squeeze, 1)
        self.expand1x1 = nn.Conv2d(squeeze, expand, 1)
        self.expand3x3 = nn.Conv2d(squeeze, expand, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = torch.relu(self.squeeze(x))
        return torch.cat([torch.relu(self.expand1x1(s)),
                          torch.relu(self.expand3x3(s))], dim=1)


def backbone(net: str) -> nn.Sequential:
    """torchvision's `<net>.features` stack (up to its last tap), built from
    plain modules."""
    conv, relu = nn.Conv2d, nn.ReLU
    if net == "alex":
        return nn.Sequential(
            conv(3, 64, 11, 4, 2), relu(), nn.MaxPool2d(3, 2),
            conv(64, 192, 5, padding=2), relu(), nn.MaxPool2d(3, 2),
            conv(192, 384, 3, padding=1), relu(),
            conv(384, 256, 3, padding=1), relu(),
            conv(256, 256, 3, padding=1), relu())
    if net == "vgg":
        layers, cin = [], 3
        for i, block in enumerate(((64, 64), (128, 128), (256, 256, 256),
                                   (512, 512, 512), (512, 512, 512))):
            if i:
                layers.append(nn.MaxPool2d(2, 2))
            for w in block:
                layers += [conv(cin, w, 3, padding=1), relu()]
                cin = w
        return nn.Sequential(*layers)
    if net == "squeeze":
        pool = lambda: nn.MaxPool2d(3, 2, ceil_mode=True)
        return nn.Sequential(
            conv(3, 64, 3, 2), relu(), pool(),
            Fire(64, 16, 64), Fire(128, 16, 64), pool(),
            Fire(128, 32, 128), Fire(256, 32, 128), pool(),
            Fire(256, 48, 192), Fire(384, 48, 192),
            Fire(384, 64, 256), Fire(512, 64, 256))
    raise ValueError(f"unknown LPIPS backbone {net!r}")


def _unit_normalize(x: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    return x / (torch.sqrt(torch.sum(torch.square(x), dim=1, keepdim=True))
                + eps)


def _canonical(net: str) -> str:
    return "vgg" if net == "vgg16" else net


class LPIPS(nn.Module):
    """Per-image LPIPS distance [B] between NCHW images. net: 'alex' (the
    training loss), 'vgg' / 'vgg16' or 'squeeze'. Weights are drawn from
    `generator` (flax's initialisers: lecun-normal convs, zero biases, unit
    lin heads)."""

    def __init__(self, net: str = "alex",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.net_name = _canonical(net)
        self.net = backbone(self.net_name)
        for k, c in enumerate(CHNS[self.net_name]):
            setattr(self, f"lin{k}", nn.Parameter(torch.ones(c)))
        self.register_buffer("shift", torch.tensor(_SHIFT)[None, :, None, None],
                             persistent=False)
        self.register_buffer("scale", torch.tensor(_SCALE)[None, :, None, None],
                             persistent=False)
        self._init_backbone(generator if generator is not None
                            else torch.Generator().manual_seed(0))

    @torch.no_grad()
    def _init_backbone(self, generator: torch.Generator) -> None:
        for mod in self.net.modules():
            if isinstance(mod, nn.Conv2d):
                lecun_normal_(mod.weight, generator)
                mod.bias.zero_()

    def taps(self, x: torch.Tensor) -> List[torch.Tensor]:
        out, i0 = [], 0
        for end in TAP_ENDS[self.net_name]:
            for i in range(i0, end):
                x = self.net[i](x)
            out.append(x)
            i0 = end
        return out

    def forward(self, pred: torch.Tensor, target: torch.Tensor,
                normalize: bool = True) -> torch.Tensor:
        if normalize:
            pred = 2.0 * pred - 1.0
            target = 2.0 * target - 1.0
        pred = (pred.float() - self.shift) / self.scale
        target = (target.float() - self.shift) / self.scale
        total = 0.0
        for k, (a, b) in enumerate(zip(self.taps(pred), self.taps(target))):
            diff = torch.square(_unit_normalize(a) - _unit_normalize(b))
            w = getattr(self, f"lin{k}")
            total = total + (diff * w[None, :, None, None]).sum(1).mean((1, 2))
        return total


def bundled_lin_heads(net: str = "alex") -> Dict[str, torch.Tensor]:
    """The reference's v0.1 lin-head weights as {'lin0': [chn], ...} (from
    the package's npz copies)."""
    with np.load(os.path.join(_WEIGHTS_DIR, f"{_canonical(net)}_lin.npz")) as z:
        return {k: torch.from_numpy(np.array(z[k], np.float32)) for k in z.files}


@torch.no_grad()
def with_bundled_lin_heads(model: LPIPS) -> LPIPS:
    """Install the bundled v0.1 lin heads into `model` (in place); returns
    it."""
    for k, v in bundled_lin_heads(model.net_name).items():
        param = getattr(model, k)
        if param.shape != v.shape:
            raise ValueError(f"{k}: head {tuple(v.shape)} does not fit "
                             f"{tuple(param.shape)}")
        param.copy_(v)
    return model
