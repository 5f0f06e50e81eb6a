"""The norm+conv building blocks of the ResnetBlocks, NCHW (port of
control_gic_tpu/ops/norm_conv.py).

One kernel call computes GroupNorm from given per-channel stats, optionally
the SpatialNorm modulation by the 4-channel zq (f32 dot form), swish, a 3x3
SAME conv, the bias and optionally a residual, rounded to x's dtype, and
optionally the per-channel (sum, sumsq) moments [B, 2, Cout] f32 of that
rounded output, which `stats_from_moments` folds into the next norm's stats.

  - The chain (JAX `_kernel_chain`): `spatial_norm_conv_mom` /
    `group_norm_conv_mom`. Stats come from `gn_moments` when none are given;
    then the CUDA kernel kernels/norm_conv_chain.cu (`chain_kernel_wgmma`
    in bf16, `chain_kernel` in f32) for CUDA tensors, or the plain versions
    `chain_reference` / `plain_chain_reference` for CPU tensors (and inside
    ops.plain_versions()). `chain_blocked_reference` replays the bf16
    kernel's tiles, chunks and moment partials on the CPU. Each chained
    block's conv2 hands its moments to the next block's conv1, which skips
    its own stats pass. Where a gradient
    is needed the kernel runs inside `_ChainFn` (JAX `_chain_custom`), whose
    backward recomputes through the plain version and differentiates that.
  - The per-call op (JAX `_kernel`): `spatial_norm_conv` /
    `group_norm_conv`, stats always from the moment pass, no residual, no
    moments. It is the same kernel in that configuration
    (`norm_conv_kernel`, counted apart from the chain). Its gradient
    (`_NormConvFn`, JAX `_make_norm_conv`) differentiates
    `norm_conv_reference` / `group_norm_conv_reference`, which recompute
    the stats from x, so the gradient flows through the stats.
  - The gates, JAX's rules read at call time with the H100 in the TPU's
    place: `chain_admissible` (CONTROL_GIC_CHAIN, on by default) and
    `norm_conv_worthwhile` (CONTROL_GIC_NORM_CONV, off by default), both
    behind the element gate `_fuse_min_elems` and `admissible`.

Weights are the port's: conv weights OIHW [Cout, Cin, 3, 3], the SpatialNorm
1x1 convs as [C, Z] matrices, all f32 parameters.
"""
from __future__ import annotations

import contextlib
import contextvars
import ctypes
import operator
import os
import threading
import weakref
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..kernels import build
from . import use_kernel
from .fused_norm import (_col, _row_block, gn_moments, gn_stats_from_moments,
                         group_norm_kernel_act, group_norm_reference,
                         spatial_norm_kernel_act, spatial_norm_reference)

# The JAX package's element gate (_fuse_min_elems), tuned on a TPU and kept
# as the port's engagement rule so that the port fuses where JAX does; it
# has not been re-derived on the H100. CONTROL_GIC_NORM_CONV_MIN_ELEMS moves
# it, as in JAX. Tests set it to 0, as JAX's interpret switches bypass its
# gate.
CHAIN_MIN_ELEMS = 9_000_000

# Launches of the CUDA kernel in this process, by use and norm form: the
# chain, and the per-call op. A caller resets them to 0 and reads them back.
KERNEL_LAUNCHES = build.counter({"chain_gn": 0, "chain_sn": 0,
                                 "norm_conv_gn": 0, "norm_conv_sn": 0})

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
Stats = Tuple[torch.Tensor, torch.Tensor]


def stats_from_moments(mom: torch.Tensor, hw: int) -> Stats:
    """Per-channel (mean_c, rstd_c) [B, C] f32 from moments [B, 2, C] over
    hw pixels (JAX `stats_from_moments`)."""
    return gn_stats_from_moments(mom, hw)


# ---------------------------------------------------------------- plain path

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
    """Plain version of the SpatialNorm-form kernel: SpatialNorm(+swish)
    from the given per-channel stats -> 3x3 conv [-> +residual], optional
    moments of the rounded output. Returns out, or (out, mom) with
    emit_mom."""
    a = spatial_norm_kernel_act(x, zq_r, gs, gb, wy, by, wb, bb, act_swish,
                                stats=stats)
    return _mom_epilogue(_conv3x3(a, cw, cb), res, x.dtype, emit_mom)


def plain_chain_reference(x, gs, gb, cw, cb, res=None, *, stats: Stats,
                          act_swish: bool = True, emit_mom: bool = True):
    """Plain version of the GroupNorm-form kernel; see chain_reference."""
    a = group_norm_kernel_act(x, gs, gb, act_swish, stats=stats)
    return _mom_epilogue(_conv3x3(a, cw, cb), res, x.dtype, emit_mom)


def norm_conv_reference(x, zq_r, gs, gb, wy, by, wb, bb, cw, cb,
                        act_swish: bool = True) -> torch.Tensor:
    """The unfused composition (JAX `norm_conv_reference`): the default
    path's SpatialNorm(+swish) in x's dtype, then the 3x3 SAME conv. What
    the per-call op's gradient differentiates."""
    a = spatial_norm_reference(x, zq_r, gs, gb, wy, by, wb, bb, act_swish)
    return _conv3x3(a, cw, cb)


def group_norm_conv_reference(x, gs, gb, cw, cb,
                              act_swish: bool = True) -> torch.Tensor:
    """GroupNorm(+swish) in f32, cast to x's dtype, then the 3x3 SAME conv
    (JAX `group_norm_conv_reference`)."""
    a = group_norm_reference(x, gs, gb)
    if act_swish:
        a = a * torch.sigmoid(a)
    return _conv3x3(a.to(x.dtype), cw, cb)


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


# The bf16 kernel's blocking (chain_kernel_wgmma in kernels/norm_conv_chain.cu),
# mirrored here for the weight packing and the CPU replay: chunks of KC input
# channels, tiles of TH rows x TW columns per block of BN output channels.
KC = 32
TW = 64


def bf16_tile(cout: int) -> Tuple[int, int]:
    """(BN, TH) of the bf16 kernel for this Cout (Cfg<BN> in the .cu)."""
    if cout <= 8:
        return 8, 8
    return (128, 4) if cout <= 128 else (256, 2)


def bf16_tiles(h: int, w: int, cout: int) -> int:
    """Spatial tiles per image of the bf16 kernel (the C entry point
    cgic_norm_conv_chain_tiles)."""
    th = bf16_tile(cout)[1]
    return -(-h // th) * -(-w // TW)


def pack_weights(cw: torch.Tensor, dtype: torch.dtype, bn: int
                 ) -> torch.Tensor:
    """[Cout, Cin, 3, 3] conv weights -> the kernel's layout, zero-padded to
    CoutP (a multiple of bn) output channels. float32 (the parity kernel):
    [9 taps (dy, dx), Cin, CoutP]. bfloat16: [CoutP/bn, 9, Cin/KC, KC/8, bn,
    8], one contiguous block of KC x bn per (N-block, tap, chunk): the
    no-swizzle K-major wgmma operand (8 input channels of one output channel
    in 16 bytes) that one bulk copy brings to shared memory."""
    cout, cin = cw.shape[:2]
    coutp = -(-cout // bn) * bn
    w = torch.zeros(coutp, cin, 3, 3, dtype=dtype, device=cw.device)
    w[:cout] = cw
    if dtype == torch.float32:
        return w.permute(2, 3, 1, 0).reshape(9, cin, coutp).contiguous()
    # [nb, n, chunk, j, k, dy, dx] -> [nb, dy, dx, chunk, j, n, k]
    w = w.reshape(coutp // bn, bn, cin // KC, KC // 8, 8, 3, 3)
    return w.permute(0, 5, 6, 2, 3, 1, 4).reshape(
        coutp // bn, 9, cin // KC, KC // 8, bn, 8).contiguous()


def unpack_weights(wpk: torch.Tensor, cout: int, cin: int) -> torch.Tensor:
    """The inverse of pack_weights: [Cout, Cin, 3, 3]."""
    if wpk.dim() == 3:
        return wpk.reshape(3, 3, cin, -1).permute(3, 2, 0, 1)[:cout]
    nb, bn = wpk.shape[0], wpk.shape[4]
    w = wpk.reshape(nb, 3, 3, cin // KC, KC // 8, bn, 8)
    return w.permute(0, 5, 3, 4, 6, 1, 2).reshape(nb * bn, cin, 3, 3)[:cout]


# Per-weight-version host work of the wrapper (packed weights, padded bias,
# the modulation weights transposed to [Z, Cin]), made once per version of
# the tensors it is built from:
# key -> (their _version counters, weak references, value). An in-place
# update (an optimizer step, load_state_dict) bumps _version and rebuilds;
# an entry goes when one of its tensors is freed. A hit reads one immutable
# entry and takes no lock; a miss builds under _CACHE_LOCK, so that threads
# launching at once build an entry once (the weakref callbacks only pop and
# take no lock).
#
# Inside uncached() every call makes its value: a captured training program
# computes its packs in the graph from the weights that its replays update
# in place, where a cached pack would be read as it was at capture.
_CACHE: dict = {}
_CACHE_LOCK = threading.RLock()   # a make() may itself look up
_UNCACHED = contextvars.ContextVar("control_gic_tpu_torch_uncached",
                                   default=False)


@contextlib.contextmanager
def uncached():
    """Inside this context `_cached` makes its value at every call."""
    token = _UNCACHED.set(True)
    try:
        yield
    finally:
        _UNCACHED.reset(token)


def _hit(key, tensors, versions):
    hit = _CACHE.get(key)
    if (hit is not None and hit[0] == versions
            and all(map(operator.is_, [r() for r in hit[1]], tensors))):
        return hit
    return None


def _cached(tensors: Sequence[torch.Tensor], extra: tuple, make):
    if _UNCACHED.get():
        return make()
    # on the launch path of every switched call: map and list
    # comprehensions, which cost a third of generator expressions
    key = (*map(id, tensors), *extra)
    versions = [t._version for t in tensors]
    hit = _hit(key, tensors, versions)
    if hit is not None:
        return hit[2]
    with _CACHE_LOCK:
        hit = _hit(key, tensors, versions)
        if hit is not None:
            return hit[2]
        value = make()
        refs = [weakref.ref(t, lambda _r, key=key: _CACHE.pop(key, None))
                for t in tensors]
        _CACHE[key] = (versions, refs, value)
        return value


def chain_blocked_reference(x, cw, cb, gs, gb, stats: Stats, res=None, *,
                            act_swish: bool = True, emit_mom: bool = True,
                            zq_r=None, wy=None, by=None, wb=None, bb=None):
    """CPU replay of the bf16 kernel's blocking (the SpatialNorm form when
    zq_r is given): the activation once per element in f32, rounded to x's
    dtype, zero outside the image AFTER the activation; the conv summed in
    f32 chunk by chunk (KC input channels) and tap by tap over the tile grid
    of bf16_tile(Cout) (the ragged edge computed on the zero halo and not
    stored); bias, residual, rounding; the moments as per-tile partials
    [B, n_tiles, 2, Cout] (tile = row of tiles * tiles per row + column)
    summed over the tile axis, as the wrapper sums the kernel's. Returns
    out, or (out, mom)."""
    b, cin, h, w = x.shape
    cout = cw.shape[0]
    th = bf16_tile(cout)[1]
    nty, ntx = -(-h // th), -(-w // TW)
    hp, wp = nty * th, ntx * TW
    if zq_r is not None:
        a = spatial_norm_kernel_act(x, zq_r, gs, gb, wy, by, wb, bb,
                                    act_swish, stats=stats)
    else:
        a = group_norm_kernel_act(x, gs, gb, act_swish, stats=stats)
    ap = F.pad(a.float(), (1, 1 + wp - w, 1, 1 + hp - h))
    wq = cw.to(x.dtype).float()
    acc = torch.zeros(b, cout, hp, wp, dtype=torch.float32, device=x.device)
    for c0 in range(0, cin, KC):
        for t in range(9):
            dy, dx = divmod(t, 3)
            acc += torch.einsum("bkhw,ok->bohw",
                                ap[:, c0:c0 + KC, dy:dy + hp, dx:dx + wp],
                                wq[:, c0:c0 + KC, dy, dx])
    out = acc[:, :, :h, :w] + _col(cb.float())
    if res is not None:
        out = out + res.float()
    out = out.to(x.dtype)
    if not emit_mom:
        return out
    of = F.pad(out.float(), (0, wp - w, 0, hp - h)).reshape(
        b, cout, nty, th, ntx, TW)
    part = torch.stack([of.sum(dim=(3, 5)), (of * of).sum(dim=(3, 5))], 1)
    part = part.permute(0, 3, 4, 1, 2).reshape(b, nty * ntx, 2, cout)
    return out, part.sum(dim=1)


def _launch(x: torch.Tensor, cw: torch.Tensor, cb: torch.Tensor,
            gs: torch.Tensor, gb: torch.Tensor, stats: Stats,
            res: Optional[torch.Tensor], emit_mom: bool, act_swish: bool,
            zq_r: Optional[torch.Tensor], wy, by, wb, bb, caller: str):
    """One launch of kernels/norm_conv_chain.cu, for the wrapper `caller`:
    checks what the kernel takes, packs the weights (once per weight
    version), launches, raises on a failed build or launch. Returns out, or
    (out, mom)."""
    if not x.is_cuda:
        raise ValueError(f"{caller} launches a CUDA kernel and takes CUDA "
                         "tensors only; use the dispatch (spatial_norm_conv"
                         "[_mom], group_norm_conv[_mom]) for CPU tensors")
    if _needs_grad(x, cw, cb, gs, gb, *stats, res, zq_r, wy, by, wb, bb):
        raise RuntimeError(f"{caller} records no gradient; under grad call "
                           "the dispatch (spatial_norm_conv[_mom], "
                           "group_norm_conv[_mom])")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"{caller} takes float32 or bfloat16 x, got "
                        f"{x.dtype}")
    if x.dim() != 4:
        raise ValueError(f"expected x [B, Cin, H, W], got {tuple(x.shape)}")
    b, cin, h, w = x.shape
    cout = cw.shape[0]
    if cin % 32 or cin > 512 or b > 65535 or x.numel() == 0:
        raise ValueError(f"{caller} takes Cin a multiple of 32 up to 512 and "
                         f"B up to 65535, got x {tuple(x.shape)}")
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
    code = _DTYPE_CODE[x.dtype]
    bn = lib.cgic_norm_conv_chain_block_n(cout, code)
    coutp = -(-cout // bn) * bn
    f32 = lambda t: t.to(dev, torch.float32).contiguous()

    def packed():
        bias = torch.zeros(coutp, dtype=torch.float32, device=dev)
        bias[:cout] = cb.to(dev, torch.float32)
        return pack_weights(cw.to(dev), x.dtype, bn), bias

    wpk, bias = _cached((cw, cb), (x.dtype, dev, bn), packed)
    # every tensor whose pointer the kernel gets stays referenced until the
    # launch is enqueued; f32 is no copy for the f32 parameters and stats
    norm = [f32(stats[0]), f32(stats[1]), f32(gs), f32(gb)]
    for t, name in zip(norm, ("mean_c", "rstd_c")):
        _need(t, name, (b, cin), torch.float32, dev)
    if modulate:
        wyt, wbt = _cached((wy, wb), (dev,),
                           lambda: (f32(wy.t()), f32(wb.t())))
        mod = [wyt, f32(by), wbt, f32(bb)]
    else:
        mod = [None] * 4
    out = torch.empty(b, cout, h, w, dtype=x.dtype, device=dev)
    n_tiles = lib.cgic_norm_conv_chain_tiles(h, w, cout, code)
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
            ctypes.c_int(w), ctypes.c_int(code),
            ctypes.c_int(int(modulate)), ctypes.c_int(int(act_swish)),
            ctypes.c_void_p(stream))
    build.check(lib, rc, "norm_conv_chain")
    if not emit_mom:
        return out
    # per-tile partials summed over the tile axis in a fixed order
    return out, part.sum(dim=1)


def chain_kernel(x: torch.Tensor, cw: torch.Tensor, cb: torch.Tensor,
                 gs: torch.Tensor, gb: torch.Tensor, stats: Stats,
                 res: Optional[torch.Tensor] = None, emit_mom: bool = True,
                 act_swish: bool = True, zq_r: Optional[torch.Tensor] = None,
                 wy=None, by=None, wb=None, bb=None):
    """Launch the CUDA kernel as the chain (JAX `_kernel_chain`): the
    SpatialNorm form when zq_r is given (with wy [C, Z], by, wb [C, Z], bb),
    the GroupNorm form otherwise. CUDA tensors only: anything the kernel
    does not take raises, and a failed build or launch raises. Returns out,
    or (out, mom)."""
    out = _launch(x, cw, cb, gs, gb, stats, res, emit_mom, act_swish, zq_r,
                  wy, by, wb, bb, "chain_kernel")
    build.count_launch(KERNEL_LAUNCHES,
                       "chain_sn" if zq_r is not None else "chain_gn")
    return out


def norm_conv_kernel(x: torch.Tensor, cw: torch.Tensor, cb: torch.Tensor,
                     gs: torch.Tensor, gb: torch.Tensor, stats: Stats,
                     act_swish: bool = True,
                     zq_r: Optional[torch.Tensor] = None,
                     wy=None, by=None, wb=None, bb=None) -> torch.Tensor:
    """Launch the CUDA kernel as the per-call op (JAX `_kernel`): the
    chain kernel with no residual and no moments, counted as norm_conv_sn /
    norm_conv_gn. CUDA tensors only, as chain_kernel."""
    out = _launch(x, cw, cb, gs, gb, stats, None, False, act_swish, zq_r,
                  wy, by, wb, bb, "norm_conv_kernel")
    build.count_launch(KERNEL_LAUNCHES, "norm_conv_sn" if zq_r is not None
                       else "norm_conv_gn")
    return out


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


class _NormConvFn(torch.autograd.Function):
    """The per-call op with a gradient (JAX `_make_norm_conv` /
    `_make_group_norm_conv`): the forward is `_norm_conv_forward`; the
    backward reruns norm_conv_reference / group_norm_conv_reference on the
    saved inputs under autograd, stats recomputed from x, and differentiates
    it. Inputs: modulate, act_swish, then x, zq_r, gs, gb, wy, by, wb, bb,
    cw, cb (the SpatialNorm-only ones None in the GroupNorm form)."""

    @staticmethod
    def forward(ctx, modulate, act_swish, x, zq_r, gs, gb, wy, by, wb, bb, cw,
                cb):
        ctx.flags = (modulate, act_swish)
        ctx.save_for_backward(x, zq_r, gs, gb, wy, by, wb, bb, cw, cb)
        return _norm_conv_forward(x, zq_r, gs, gb, wy, by, wb, bb, cw, cb,
                                  act_swish)

    @staticmethod
    def backward(ctx, g):
        modulate, act_swish = ctx.flags
        need = ctx.needs_input_grad[2:]
        leaves = [None if t is None else t.detach().requires_grad_(n)
                  for t, n in zip(ctx.saved_tensors, need)]
        x, zq_r, gs, gb, wy, by, wb, bb, cw, cb = leaves
        with torch.enable_grad():
            if modulate:
                out = norm_conv_reference(x, zq_r, gs, gb, wy, by, wb, bb, cw,
                                          cb, act_swish)
            else:
                out = group_norm_conv_reference(x, gs, gb, cw, cb, act_swish)
        wanted = [t for t, n in zip(leaves, need) if n and t is not None]
        got = iter(torch.autograd.grad(out, wanted, g, allow_unused=True))
        return (None, None) + tuple(
            next(got) if n and t is not None else None
            for t, n in zip(leaves, need))


# ---------------------------------------------------------------- dispatch

def _stats_for(x: torch.Tensor, stats: Optional[Stats]) -> Stats:
    if stats is None:
        return stats_from_moments(gn_moments(x), x.shape[2] * x.shape[3])
    return stats


def _chain(x, zq_r, gs, gb, wy, by, wb, bb, cw, cb, res, stats, act_swish,
           emit_mom):
    """The chain kernel, inside _ChainFn where any input needs a gradient."""
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
        return _chain(x, zq_r, gs, gb, wy, by, wb, bb, cw, cb, res, stats,
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
        return _chain(x, None, gs, gb, None, None, None, None, cw, cb, res,
                      stats, act_swish, emit_mom)
    return plain_chain_reference(x, gs, gb, cw, cb, res=res, stats=stats,
                                 act_swish=act_swish, emit_mom=emit_mom)


def _norm_conv_forward(x, zq_r, gs, gb, wy, by, wb, bb, cw, cb,
                       act_swish: bool) -> torch.Tensor:
    """JAX `_norm_conv_forward_impl`: stats from the moment pass, then the
    kernel for a CUDA tensor, its plain version for a CPU tensor. zq_r and
    the modulation weights are None in the GroupNorm form."""
    stats = _stats_for(x, None)
    if use_kernel(x):
        return norm_conv_kernel(x, cw, cb, gs, gb, stats, act_swish, zq_r,
                                wy, by, wb, bb)
    if zq_r is not None:
        return chain_reference(x, zq_r, gs, gb, wy, by, wb, bb, cw, cb,
                               stats=stats, act_swish=act_swish,
                               emit_mom=False)
    return plain_chain_reference(x, gs, gb, cw, cb, stats=stats,
                                 act_swish=act_swish, emit_mom=False)


def _norm_conv(x, zq_r, gs, gb, wy, by, wb, bb, cw, cb, act_swish):
    """The per-call op, inside _NormConvFn where any input needs a
    gradient."""
    args = (x, zq_r, gs, gb, wy, by, wb, bb, cw, cb)
    if _needs_grad(*args):
        return _NormConvFn.apply(zq_r is not None, act_swish, *args)
    return _norm_conv_forward(*args, act_swish)


def spatial_norm_conv(x, zq_r, gs, gb, wy, by, wb, bb, cw, cb,
                      act_swish: bool = True,
                      use_fused: Optional[bool] = None) -> torch.Tensor:
    """SpatialNorm(+swish) -> 3x3 SAME conv (JAX `spatial_norm_conv`): the
    per-call kernel where `norm_conv_worthwhile` (or use_fused=True) says
    so, the unfused composition norm_conv_reference otherwise. x:
    [B, Cin, H, W]; zq_r: [B, 4, H, W] in x's dtype; wy, wb: [Cin, 4]; cw:
    [Cout, Cin, 3, 3]."""
    if use_fused is None:
        use_fused = norm_conv_worthwhile(x.shape, cw.shape[0])
    if use_fused:
        return _norm_conv(x, zq_r, gs, gb, wy, by, wb, bb, cw, cb, act_swish)
    return norm_conv_reference(x, zq_r, gs, gb, wy, by, wb, bb, cw, cb,
                               act_swish)


def group_norm_conv(x, gs, gb, cw, cb, act_swish: bool = True,
                    use_fused: Optional[bool] = None) -> torch.Tensor:
    """GroupNorm(+swish) -> 3x3 SAME conv (JAX `group_norm_conv`); see
    spatial_norm_conv."""
    if use_fused is None:
        use_fused = norm_conv_worthwhile(x.shape, cw.shape[0])
    if use_fused:
        return _norm_conv(x, None, gs, gb, None, None, None, None, cw, cb,
                          act_swish)
    return group_norm_conv_reference(x, gs, gb, cw, cb, act_swish)


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


def _interpret_forced() -> bool:
    """JAX's interpret switches, which lift the element gate (and, in JAX,
    run the Pallas kernels in interpret mode: the port has no such mode and
    launches its kernel for CUDA tensors)."""
    return (os.environ.get("CONTROL_GIC_NORM_CONV") == "interpret"
            or os.environ.get("CONTROL_GIC_CHAIN") == "interpret")


def _fuse_min_elems() -> int:
    """The element gate: CONTROL_GIC_NORM_CONV_MIN_ELEMS, else
    CHAIN_MIN_ELEMS (JAX `_fuse_min_elems`)."""
    return int(os.environ.get("CONTROL_GIC_NORM_CONV_MIN_ELEMS",
                              CHAIN_MIN_ELEMS))


# An engagement predicate (x_shape NCHW, cout) -> bool that replaces the
# element gate of both gates (admissibility still applies), as JAX's
# set_engagement_rule; a ContextVar, so it holds in the context that sets it.
_RULE = contextvars.ContextVar("control_gic_tpu_torch_norm_conv_rule",
                               default=None)
_FORCED = contextvars.ContextVar("control_gic_tpu_torch_norm_conv_forced",
                                 default=False)


def set_engagement_rule(fn) -> None:
    """Replace the element gate by fn(x_shape, cout) (None restores it)."""
    _RULE.set(fn)


class force_norm_conv:
    """Engage the per-call op inside this context (still subject to
    `admissible` and the element gate) without CONTROL_GIC_NORM_CONV=1, as
    JAX's force_norm_conv; CONTROL_GIC_NORM_CONV=0 still turns it off."""

    def __enter__(self):
        self._tok = _FORCED.set(True)
        return self

    def __exit__(self, *exc):
        _FORCED.reset(self._tok)
        return False


def _gate(x_shape: Sequence[int], cout: int) -> bool:
    if _interpret_forced():
        return True
    rule = _RULE.get()
    if rule is not None:
        return bool(rule(x_shape, cout))
    _, c, h, w = x_shape
    return c * h * w >= _fuse_min_elems()


def chain_enabled() -> bool:
    """JAX `chain_enabled` with the H100 in the TPU's place: on unless
    CONTROL_GIC_CHAIN=0 ('interpret' also lifts the element gate)."""
    return os.environ.get("CONTROL_GIC_CHAIN", "") != "0"


def norm_conv_enabled() -> bool:
    """JAX `norm_conv_enabled` with the H100 in the TPU's place: on with
    CONTROL_GIC_NORM_CONV=1 or 'interpret' (which also lifts the element
    gate) or inside force_norm_conv, off with 0 and by default."""
    flag = os.environ.get("CONTROL_GIC_NORM_CONV", "")
    if flag == "interpret":
        return True
    if flag == "0":
        return False
    return flag == "1" or _FORCED.get()


def norm_conv_worthwhile(x_shape: Sequence[int], cout: int) -> bool:
    """Whether a norm+conv pair takes the per-call op (JAX
    `norm_conv_worthwhile`): enabled, its conv admissible, and the element
    gate. Module code branches on this, and keeps its unfused composition
    where it says no."""
    if not norm_conv_enabled() or not admissible(x_shape, cout):
        return False
    return _gate(x_shape, cout)


def chain_admissible(x_shape: Sequence[int], cout: int) -> bool:
    """Whether a ResnetBlock chains (JAX `chain_admissible`): the chain
    enabled, both of its convs admissible, and the element gate."""
    if not chain_enabled():
        return False
    b, c, h, w = x_shape
    if not (admissible(x_shape, cout) and admissible((b, cout, h, w), cout)):
        return False
    return _gate(x_shape, cout)
