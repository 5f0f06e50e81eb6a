"""Spatial resampling, NCHW (port of control_gic_tpu/ops/resample.py).

Nearest interpolation uses the floor rule src = (dst * in) // out, which is
torch's mode="nearest" (not "nearest-exact"). The functions also take
[B, H, W] grids such as the router masks.
"""
from __future__ import annotations

import os

import torch
import torch.nn.functional as F

# Row/col aliasing of a SAME 3x3 conv on a x2-nearest-upsampled grid: output
# row 2i+a reads low-res rows {i-1, i} (a=0, weights W0 | W1+W2) or {i, i+1}
# (a=1, W0+W1 | W2).
_PHASE = (((1.0, 0.0, 0.0), (0.0, 1.0, 1.0)),   # a=0: taps (i-1, i)
          ((1.0, 1.0, 0.0), (0.0, 0.0, 1.0)))   # a=1: taps (i, i+1)
# _PHASE on each device it was asked for: made on the first call, so that
# later calls (a captured program among them) copy nothing from the host
_PHASE_ON: dict = {}


def nearest_resize(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Nearest resize of the last two dims with the floor index rule."""
    in_h, in_w = x.shape[-2], x.shape[-1]
    if (in_h, in_w) == (out_h, out_w):
        return x
    idx_h = torch.arange(out_h, device=x.device) * in_h // out_h
    idx_w = torch.arange(out_w, device=x.device) * in_w // out_w
    return x.index_select(-2, idx_h).index_select(-1, idx_w)


def upsample_nearest(x: torch.Tensor, scale: int) -> torch.Tensor:
    """Integer-factor nearest upsample of the last two dims."""
    if scale == 1:
        return x
    return x.repeat_interleave(scale, dim=-2).repeat_interleave(scale, dim=-1)


def subpixel_enabled() -> bool:
    """The switch of `Upsample`'s subpixel form, read at call time: on unless
    CONTROL_GIC_SUBPIXEL is "0", which restores the direct nearest x2 then
    3x3 conv (JAX `subpixel_enabled`)."""
    return os.environ.get("CONTROL_GIC_SUBPIXEL", "1") != "0"


def phase_conv_kernel(weight: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Fold an OIHW [Co, C, 3, 3] kernel into the 2x2 four-phase kernel
    [4*Co, C, 2, 2] (output channel (a, b, o) = a*2*Co + b*Co + o), combined
    in f32 and cast to `dtype`."""
    co, c = weight.shape[:2]
    a = _PHASE_ON.get(weight.device)
    if a is None:
        a = _PHASE_ON[weight.device] = torch.tensor(
            _PHASE, dtype=torch.float32, device=weight.device)
    k4 = torch.einsum("aup,bvq,oipq->aboiuv", a, a, weight.float())
    return k4.reshape(4 * co, c, 2, 2).to(dtype)


def upsample2_conv3x3(x: torch.Tensor, weight: torch.Tensor,
                      bias: torch.Tensor) -> torch.Tensor:
    """conv3x3(SAME)(nearest_up2(x)) computed at low resolution: the four
    output phases as one 2x2 conv with 4*Co channels, then interleaved.

    x: [N, C, H, W]; weight: [Co, C, 3, 3]; bias: [Co] -> [N, Co, 2H, 2W].
    """
    n, _, h, w = x.shape
    co = weight.shape[0]
    y = F.conv2d(x, phase_conv_kernel(weight, x.dtype), padding=1)
    return phase_unshuffle(y, n, h, w, co, bias)


def phase_unshuffle(y: torch.Tensor, n: int, h: int, w: int, co: int,
                    bias: torch.Tensor) -> torch.Tensor:
    """The four phases of the 2x2 conv's output y [N, 4*Co, H+1, W+1]
    interleaved into [N, Co, 2H, 2W], plus the bias (JAX
    `phase_unshuffle`). An H-shard's y (its rows [s*H, s*H + H] of the
    global one, parallel/halo.py) unshuffles with no index change."""
    y = y.reshape(n, 2, 2, co, h + 1, w + 1)
    p00 = y[:, 0, 0, :, 0:h, 0:w]
    p01 = y[:, 0, 1, :, 0:h, 1:w + 1]
    p10 = y[:, 1, 0, :, 1:h + 1, 0:w]
    p11 = y[:, 1, 1, :, 1:h + 1, 1:w + 1]
    out = torch.stack([torch.stack([p00, p01], dim=-1),
                       torch.stack([p10, p11], dim=-1)], dim=3)
    out = out.reshape(n, co, 2 * h, 2 * w)
    return out + bias.to(out.dtype)[:, None, None]


def avg_pool(x: torch.Tensor, window: int) -> torch.Tensor:
    """Non-overlapping average pool of the last two dims. The window is
    summed in f32 in row-major order, then divided: bit for bit the JAX
    package's reshape-mean."""
    if window == 1:
        return x
    *lead, h, w = x.shape
    assert h % window == 0 and w % window == 0, (tuple(x.shape), window)
    xw = x.float().reshape(*lead, h // window, window, w // window, window)
    acc = xw[..., 0, :, 0]
    for i in range(window):
        for j in range(window):
            if i or j:
                acc = acc + xw[..., i, :, j]
    return (acc / (window * window)).to(x.dtype)
