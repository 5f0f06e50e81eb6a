"""Weights made on the device from the seed, in one draw.

Every 4-D weight (a convolution) is normal with std 1 / sqrt(fan_in)
(lecun, not truncated), 1-D weights (norm scales) are 1, biases and
running means 0, running variances 1. Assumed beside that, so that a
random model behaves as a trained one does where the comparison looks:
the VQ codebook is N(0, 1), the scale of the encoder's latent, so that the
nearest-code search has neighbours to choose from; the decoder's last conv
has std 0.25 / sqrt(fan_in) and bias 0.5, so that most of the
reconstruction lies in [0, 1] and its uint8 form is not clipped flat.

The same seed gives the same weights, so the harness makes them again for
the reference once the program's state is gone.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, Tuple

import numpy as np
import torch

# purposes of the numbers drawn from one seed
WEIGHTS, IMAGES, TABLE, SAMPLE, ORDER, POINTS = range(6)

SPECIAL_STD = {"decoder.conv_out.weight": 0.25}
SPECIAL_FILL = {"decoder.conv_out.bias": 0.5}


def derive(seed: int, purpose: int) -> int:
    """A 63-bit seed for one purpose, from any whole-number seed."""
    ss = np.random.SeedSequence([abs(int(seed)), int(seed < 0), purpose])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def generator(seed: int, purpose: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(derive(seed, purpose))


def make_params(groups: Iterable[Tuple[str, Dict[str, tuple]]], seed: int,
                device, dtype=torch.float32) -> Dict[str, Dict[str, torch.Tensor]]:
    """{group: {name: tensor}} for each (group, {name: shape}) given, all
    drawn from one generator in one call."""
    groups = list(groups)
    drawn = [(g, n, s) for g, shapes in groups for n, s in shapes.items()
             if len(s) == 4 or n.endswith("embedding.weight")]
    total = sum(math.prod(s) for _, _, s in drawn)
    flat = torch.randn(total, generator=generator(seed, WEIGHTS, device),
                       device=device, dtype=torch.float32)
    out: Dict[str, Dict[str, torch.Tensor]] = {g: {} for g, _ in groups}
    pos = 0
    for g, n, s in drawn:
        k = math.prod(s)
        t = flat[pos:pos + k].view(s)
        if len(s) == 4:
            t = t * (SPECIAL_STD.get(n, 1.0) / math.sqrt(math.prod(s[1:])))
        out[g][n] = t.to(dtype, copy=True)    # no view keeps `flat` alive
        pos += k
    for g, shapes in groups:
        for n, s in shapes.items():
            if n in out[g]:
                continue
            fill = 1.0 if (n.endswith("running_var") or (
                n.endswith(".weight") and len(s) == 1)) else 0.0
            out[g][n] = torch.full(s, SPECIAL_FILL.get(n, fill),
                                   device=device, dtype=dtype)
    return out
