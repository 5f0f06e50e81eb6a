"""The chained norm+conv building block of the ResnetBlocks, NCHW (port of
the chained path of control_gic_tpu/ops/norm_conv.py).

One call computes GroupNorm from given or freshly computed per-channel stats,
optionally the SpatialNorm modulation by the 4-channel zq (f32 dot form),
swish, a 3x3 SAME conv, the bias and optionally a residual, rounded to x's
dtype, and optionally the per-channel (sum, sumsq) moments [B, 2, Cout] f32
of that rounded output, which `stats_from_moments` folds into the next
norm's stats. That is the stats-in-epilogue chain: each block's conv2 hands
its moments to the next block's conv1, which skips its own stats pass.

  - `spatial_norm_conv_mom` / `group_norm_conv_mom`: the dispatch. Stats
    come from `gn_moments` when none are given; then the CUDA kernel
    kernels/norm_conv_chain.cu for CUDA tensors, or the plain versions
    `chain_reference` / `plain_chain_reference` for CPU tensors (and inside
    ops.plain_versions()). Where a gradient is needed the kernel runs inside
    `_ChainFn` (JAX `_chain_custom`), whose backward recomputes through the
    plain version and differentiates that.
  - `chain_admissible`: where the model takes the chained path, the JAX
    package's rule: both convs shape-admissible and at least CHAIN_MIN_ELEMS
    elements per sample.

Weights are the port's: conv weights OIHW [Cout, Cin, 3, 3], the SpatialNorm
1x1 convs as [C, Z] matrices, all f32 parameters.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from . import use_kernel
from .fused_norm import _row_block, gn_moments, gn_stats_from_moments

# The JAX package's element gate (_fuse_min_elems), tuned on a TPU and kept
# as the port's engagement rule so that the port chains where JAX does; it
# has not been re-derived on the H100. Tests set it to 0, as JAX's
# CONTROL_GIC_CHAIN=interpret bypasses its gate.
CHAIN_MIN_ELEMS = 9_000_000

# Launches of the CUDA chain kernel in this process, by norm form. A caller
# resets them to 0 and reads them back.
KERNEL_LAUNCHES = {"chain_gn": 0, "chain_sn": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
Stats = Tuple[torch.Tensor, torch.Tensor]


def stats_from_moments(mom: torch.Tensor, hw: int) -> Stats:
    """Per-channel (mean_c, rstd_c) [B, C] f32 from moments [B, 2, C] over
    hw pixels (JAX `stats_from_moments`)."""
    return gn_stats_from_moments(mom, hw)


# ---------------------------------------------------------------- plain path

def _col(t: torch.Tensor) -> torch.Tensor:
    return t[..., None, None]


def _normalize(x: torch.Tensor, gs: torch.Tensor, gb: torch.Tensor,
               stats: Stats) -> torch.Tensor:
    mean_c, rstd_c = stats[0].float(), stats[1].float()
    return ((x.float() - _col(mean_c)) * _col(rstd_c * gs.float())
            + _col(gb.float()))


def group_norm_kernel_act(x: torch.Tensor, gs: torch.Tensor, gb: torch.Tensor,
                          act_swish: bool, stats: Stats) -> torch.Tensor:
    """GroupNorm(+swish) in the kernel's numerics: f32 normalize with the
    given per-channel stats, cast to x's dtype."""
    out = _normalize(x, gs, gb, stats)
    if act_swish:
        out = out * torch.sigmoid(out)
    return out.to(x.dtype)


def spatial_norm_kernel_act(x: torch.Tensor, zq_r: torch.Tensor,
                            gs: torch.Tensor, gb: torch.Tensor,
                            wy: torch.Tensor, by: torch.Tensor,
                            wb: torch.Tensor, bb: torch.Tensor,
                            act_swish: bool, stats: Stats) -> torch.Tensor:
    """SpatialNorm(+swish) in the kernel's numerics: the f32 dot-form
    modulation (zq @ wy + by), not the broadcast form of
    fused_norm.spatial_norm_reference. zq_r: [B, Z, H, W]; wy, wb: [C, Z]."""
    out = _normalize(x, gs, gb, stats)
    zf = zq_r.float().permute(0, 2, 3, 1)                  # [B, H, W, Z]
    y = (zf @ wy.float().t() + by.float()).permute(0, 3, 1, 2)
    bm = (zf @ wb.float().t() + bb.float()).permute(0, 3, 1, 2)
    out = out * y + bm
    if act_swish:
        out = out * torch.sigmoid(out)
    return out.to(x.dtype)


def _conv3x3(a: torch.Tensor, cw: torch.Tensor, cb: torch.Tensor
             ) -> torch.Tensor:
    """3x3 SAME conv in a's dtype (f32 accumulation), bias added in the
    output dtype, as flax nn.Conv does."""
    out = F.conv2d(a, cw.to(a.dtype), padding=1)
    return out + _col(cb.to(out.dtype))


def _mom_epilogue(out: torch.Tensor, res: Optional[torch.Tensor],
                  x_dtype: torch.dtype, emit_mom: bool):
    if res is not None:
        out = out.float() + res.float()
    out = out.to(x_dtype)
    if not emit_mom:
        return out
    of = out.float()
    return out, torch.stack([of.sum(dim=(2, 3)), (of * of).sum(dim=(2, 3))],
                            dim=1)


def chain_reference(x, zq_r, gs, gb, wy, by, wb, bb, cw, cb, res=None, *,
                    stats: Stats, act_swish: bool = True,
                    emit_mom: bool = True):
    """Plain version of the SpatialNorm-form chain: SpatialNorm(+swish)
    from the given per-channel stats -> 3x3 conv [-> +residual], optional
    moments of the rounded output. Returns out, or (out, mom) with
    emit_mom."""
    a = spatial_norm_kernel_act(x, zq_r, gs, gb, wy, by, wb, bb, act_swish,
                                stats=stats)
    return _mom_epilogue(_conv3x3(a, cw, cb), res, x.dtype, emit_mom)


def plain_chain_reference(x, gs, gb, cw, cb, res=None, *, stats: Stats,
                          act_swish: bool = True, emit_mom: bool = True):
    """Plain version of the GroupNorm-form chain; see chain_reference."""
    a = group_norm_kernel_act(x, gs, gb, act_swish, stats=stats)
    return _mom_epilogue(_conv3x3(a, cw, cb), res, x.dtype, emit_mom)


# ---------------------------------------------------------------- the kernel

def _need(t: torch.Tensor, name: str, shape: Sequence[int],
          dtype: torch.dtype, device: torch.device) -> None:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name}: expected a tensor on {device}, got "
                         f"{t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: needs a contiguous tensor")


def chain_kernel(x: torch.Tensor, cw: torch.Tensor, cb: torch.Tensor,
                 gs: torch.Tensor, gb: torch.Tensor, stats: Stats,
                 res: Optional[torch.Tensor] = None, emit_mom: bool = True,
                 act_swish: bool = True, zq_r: Optional[torch.Tensor] = None,
                 wy=None, by=None, wb=None, bb=None):
    """Launch the CUDA chain kernel: the SpatialNorm form when zq_r is given
    (with wy [C, Z], by, wb [C, Z], bb), the GroupNorm form otherwise.
    CUDA tensors only: anything the kernel does not take raises, and a
    failed build or launch raises. Returns out, or (out, mom)."""
    if not x.is_cuda:
        raise ValueError("chain_kernel launches a CUDA kernel and takes CUDA "
                         "tensors only; use spatial_norm_conv_mom() or "
                         "group_norm_conv_mom() for CPU tensors")
    if _needs_grad(x, cw, cb, gs, gb, *stats, res, zq_r, wy, by, wb, bb):
        raise RuntimeError("chain_kernel records no gradient; under grad "
                           "call spatial_norm_conv_mom() or "
                           "group_norm_conv_mom()")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"chain_kernel takes float32 or bfloat16 x, got "
                        f"{x.dtype}")
    if x.dim() != 4:
        raise ValueError(f"expected x [B, Cin, H, W], got {tuple(x.shape)}")
    b, cin, h, w = x.shape
    cout = cw.shape[0]
    if cin % 32 or cin > 512 or b > 65535 or x.numel() == 0:
        raise ValueError(f"chain_kernel takes Cin a multiple of 32 up to "
                         f"512 and B up to 65535, got x {tuple(x.shape)}")
    dev = x.device
    _need(x, "x", (b, cin, h, w), x.dtype, dev)
    if tuple(cw.shape) != (cout, cin, 3, 3):
        raise ValueError(f"cw: expected [Cout, {cin}, 3, 3], got "
                         f"{tuple(cw.shape)}")
    if res is not None:
        _need(res, "res", (b, cout, h, w), x.dtype, dev)
    modulate = zq_r is not None
    if modulate:
        _need(zq_r, "zq_r", (b, 4, h, w), x.dtype, dev)
    from ..kernels import build
    lib = build.load("norm_conv_chain")
    bn = lib.cgic_norm_conv_chain_block_n(cout)
    coutp = -(-cout // bn) * bn
    f32 = lambda t: t.to(dev, torch.float32).contiguous()
    # [Cout, Cin, 3, 3] -> [9 taps (dy, dx), Cin, CoutP], zero-padded along N
    wpk = torch.zeros(9, cin, coutp, dtype=x.dtype, device=dev)
    wpk[:, :, :cout] = cw.to(dev).permute(2, 3, 1, 0).reshape(9, cin, cout)
    bias = torch.zeros(coutp, dtype=torch.float32, device=dev)
    bias[:cout] = cb.to(dev, torch.float32)
    # every tensor whose pointer the kernel gets stays referenced until the
    # launch is enqueued
    norm = [f32(stats[0]), f32(stats[1]), f32(gs), f32(gb)]
    for t, name in zip(norm, ("mean_c", "rstd_c")):
        _need(t, name, (b, cin), torch.float32, dev)
    mod = ([f32(wy.t()), f32(by), f32(wb.t()), f32(bb)] if modulate
           else [None] * 4)
    out = torch.empty(b, cout, h, w, dtype=x.dtype, device=dev)
    n_tiles = lib.cgic_norm_conv_chain_tiles(h, w, cout)
    part = (torch.empty(b, n_tiles, 2, cout, dtype=torch.float32, device=dev)
            if emit_mom else None)
    ptr = lambda t: ctypes.c_void_p(None if t is None else t.data_ptr())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.cgic_norm_conv_chain(
            ptr(x), ptr(zq_r), *map(ptr, norm), *map(ptr, mod), ptr(wpk),
            ptr(bias), ptr(res), ptr(out), ptr(part), ctypes.c_int(b),
            ctypes.c_int(cin),
            ctypes.c_int(cout), ctypes.c_int(coutp), ctypes.c_int(h),
            ctypes.c_int(w), ctypes.c_int(_DTYPE_CODE[x.dtype]),
            ctypes.c_int(int(modulate)), ctypes.c_int(int(act_swish)),
            ctypes.c_void_p(stream))
    build.check(lib, rc, "norm_conv_chain")
    KERNEL_LAUNCHES["chain_sn" if modulate else "chain_gn"] += 1
    if not emit_mom:
        return out
    # per-tile partials summed over the tile axis in a fixed order
    return out, part.sum(dim=1)


# ---------------------------------------------------------------- gradient

def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


class _ChainFn(torch.autograd.Function):
    """The chain kernel with a gradient (JAX `_chain_custom`): the forward
    launches the kernel; the backward reruns the plain version on the saved
    inputs under autograd and differentiates it, giving the cotangents of
    x, zq_r, the norm and modulation parameters, the conv weights, the
    residual and the given stats. Inputs: modulate, act_swish, emit_mom,
    then x, zq_r, gs, gb, wy, by, wb, bb, cw, cb, res, mean_c, rstd_c (the
    SpatialNorm-only and optional ones may be None)."""

    @staticmethod
    def forward(ctx, modulate, act_swish, emit_mom, x, zq_r, gs, gb, wy, by,
                wb, bb, cw, cb, res, mean_c, rstd_c):
        ctx.flags = (modulate, act_swish, emit_mom)
        ctx.save_for_backward(x, zq_r, gs, gb, wy, by, wb, bb, cw, cb, res,
                              mean_c, rstd_c)
        mod = (zq_r, wy, by, wb, bb) if modulate else (None,) * 5
        return chain_kernel(x, cw, cb, gs, gb, (mean_c, rstd_c), res,
                            emit_mom, act_swish, *mod)

    @staticmethod
    def backward(ctx, g_out, g_mom=None):
        modulate, act_swish, emit_mom = ctx.flags
        need = ctx.needs_input_grad[3:]
        leaves = [None if t is None else t.detach().requires_grad_(n)
                  for t, n in zip(ctx.saved_tensors, need)]
        x, zq_r, gs, gb, wy, by, wb, bb, cw, cb, res, mean_c, rstd_c = leaves
        kw = dict(res=res, stats=(mean_c, rstd_c), act_swish=act_swish,
                  emit_mom=emit_mom)
        with torch.enable_grad():
            if modulate:
                outs = chain_reference(x, zq_r, gs, gb, wy, by, wb, bb, cw,
                                       cb, **kw)
            else:
                outs = plain_chain_reference(x, gs, gb, cw, cb, **kw)
        outs, grads_out = ((outs, (g_out, g_mom)) if emit_mom
                           else ((outs,), (g_out,)))
        wanted = [t for t, n in zip(leaves, need) if n and t is not None]
        got = iter(torch.autograd.grad(outs, wanted, grads_out,
                                       allow_unused=True))
        return (None, None, None) + tuple(
            next(got) if n and t is not None else None
            for t, n in zip(leaves, need))


# ---------------------------------------------------------------- dispatch

def _stats_for(x: torch.Tensor, stats: Optional[Stats]) -> Stats:
    if stats is None:
        return stats_from_moments(gn_moments(x), x.shape[2] * x.shape[3])
    return stats


def _launch(x, zq_r, gs, gb, wy, by, wb, bb, cw, cb, res, stats, act_swish,
            emit_mom):
    """The kernel, inside _ChainFn where any input needs a gradient."""
    modulate = zq_r is not None
    if _needs_grad(x, zq_r, gs, gb, wy, by, wb, bb, cw, cb, res, *stats):
        return _ChainFn.apply(modulate, act_swish, emit_mom, x, zq_r, gs, gb,
                              wy, by, wb, bb, cw, cb, res, *stats)
    return chain_kernel(x, cw, cb, gs, gb, stats, res, emit_mom, act_swish,
                        zq_r, wy, by, wb, bb)


def spatial_norm_conv_mom(x, zq_r, gs, gb, wy, by, wb, bb, cw, cb, res=None,
                          stats: Optional[Stats] = None,
                          act_swish: bool = True, emit_mom: bool = True):
    """SpatialNorm(+swish) -> 3x3 conv [-> +residual] with stats in
    (computed by the moment pass when None) and optional moments out.
    x: [B, Cin, H, W]; zq_r: [B, 4, H, W] in x's dtype; wy, wb: [Cin, 4];
    cw: [Cout, Cin, 3, 3]. Returns out, or (out, mom [B, 2, Cout])."""
    stats = _stats_for(x, stats)
    if use_kernel(x):
        return _launch(x, zq_r, gs, gb, wy, by, wb, bb, cw, cb, res, stats,
                       act_swish, emit_mom)
    return chain_reference(x, zq_r, gs, gb, wy, by, wb, bb, cw, cb, res=res,
                           stats=stats, act_swish=act_swish,
                           emit_mom=emit_mom)


def group_norm_conv_mom(x, gs, gb, cw, cb, res=None,
                        stats: Optional[Stats] = None, act_swish: bool = True,
                        emit_mom: bool = True):
    """GroupNorm(+swish) -> 3x3 conv [-> +residual]; see
    spatial_norm_conv_mom."""
    stats = _stats_for(x, stats)
    if use_kernel(x):
        return _launch(x, None, gs, gb, None, None, None, None, cw, cb, res,
                       stats, act_swish, emit_mom)
    return plain_chain_reference(x, gs, gb, cw, cb, res=res, stats=stats,
                                 act_swish=act_swish, emit_mom=emit_mom)


# ---------------------------------------------------------------- the gate

def admissible(x_shape: Sequence[int], cout: int) -> bool:
    """JAX `admissible` for an NCHW shape: C a multiple of 128, W of 16,
    H >= 2, Cout <= 128 or a multiple of 128, and a row block for the stats
    pass."""
    _, c, h, w = x_shape
    if c % 128 or w % 16 or h < 2:
        return False
    if cout > 128 and cout % 128:
        return False
    return _row_block(h * w, c) > 0


def chain_admissible(x_shape: Sequence[int], cout: int) -> bool:
    """Whether a ResnetBlock chains (JAX `chain_admissible`): both of its
    convs admissible and at least CHAIN_MIN_ELEMS elements per sample."""
    b, c, h, w = x_shape
    if not (admissible(x_shape, cout) and admissible((b, cout, h, w), cout)):
        return False
    return c * h * w >= CHAIN_MIN_ELEMS
