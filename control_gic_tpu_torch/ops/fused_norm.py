"""GroupNorm and SpatialNorm formulas, the GroupNorm moment pass and the
SpatialNorm apply kernel (port of control_gic_tpu/ops/fused_norm.py).

Statistics are taken in f32 as E[x^2] - E[x]^2 clamped at 0, with eps inside
the rsqrt: flax's nn.GroupNorm numerics, which F.group_norm does not share.
SpatialNorm (MoVQ) is GroupNorm(f) * conv_y(zq) + conv_b(zq) with the two
1x1 convs from the 4-channel zq written as a Z-term broadcast sum, and its
pointwise math runs in the activation dtype (`spatial_norm_reference`, the
default path). Tensors are NCHW.

The moment pass (JAX `_gn_stats_pallas`) is the per-channel sum and sum of
squares over H*W, [B, 2, C] f32, then a group fold to per-channel (mean,
rstd). `gn_moments` launches the CUDA kernel kernels/gn_moments.cu for CUDA
tensors, inside `_GnMomentsFn` where x needs a gradient, and runs
`gn_moments_reference` for CPU tensors.

`spatial_norm` is JAX's dispatch, read at call time, with the H100 in the
TPU's place, and a default of its own on the card:
  - CONTROL_GIC_FUSED_NORM set: the moment pass, then the apply kernel
    kernels/spatial_norm_apply.cu (JAX `_fused_forward`), which folds the
    moments into the group stats itself (two launches in all). Its plain
    version is `spatial_norm_kernel_act` (f32, dot-form modulation) on
    `gn_stats_from_moments`; `spatial_norm_apply_replay` replays its order
    of operations on the CPU;
  - CONTROL_GIC_STATS_KERNEL set: the moment pass, then the torch fold and
    that torch apply (JAX `_stats_only_forward`);
  - otherwise, or where `_row_block` finds no block: the moment pass and
    the apply kernel for a CUDA tensor that records no gradient, where the
    two kernels take the shape (`kernels_take`); `spatial_norm_reference`
    for the rest. The reference is some 25 elementwise and reduce launches
    on the card, which XLA fuses into one pass on a TPU; the two kernels
    take 4.7-34x less device time at each of the 25 SpatialNorm shapes the
    codec's benchmark cells run (PERF.md §5). Under grad the backward
    reruns the reference, so the forward runs it too.
Both switched paths run inside `_SpatialNormFn` (JAX `_make_fused`) where a
gradient is needed; its backward differentiates `spatial_norm_reference`.
"""
from __future__ import annotations

import os
import struct
from typing import Tuple

import torch

from ..kernels import build
from . import use_kernel

GROUPS = 32
EPS = 1e-6

# Launches of the CUDA kernels in this process: the moment pass and the
# SpatialNorm apply (each wrapper adds one per launch). A caller resets them
# to 0 and reads them back.
KERNEL_LAUNCHES = {"gn_moments": 0, "spatial_norm_apply": 0}
# Calls of `spatial_norm` that ran spatial_norm_reference where
# `use_kernel` holds (a CUDA tensor outside plain_versions()): under grad,
# with use_fused=False, or a shape the kernels do not take. Counted as the
# launches are.
PLAIN_CALLS = {"spatial_norm": 0}

Stats = Tuple[torch.Tensor, torch.Tensor]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _row_block(hw: int, c: int, target_bytes: int = 1 << 21) -> int:
    """Largest divisor of hw, a multiple of 8 or hw itself, whose [rb, C] f32
    block fits target_bytes; 0 when there is none. The JAX package's row
    block, sized for TPU VMEM: the port keeps it only as part of the
    engagement rules (here and in ops/norm_conv.admissible), so that the
    kernels engage where the JAX package's do."""
    cap = max(1, target_bytes // (4 * c))
    if hw <= cap:
        return hw
    rb = cap - cap % 8
    while rb >= 8 and hw % rb:
        rb -= 8
    return rb if rb >= 8 else 0


def gn_moments_reference(x: torch.Tensor) -> torch.Tensor:
    """Per-channel (sum, sum of squares) over H*W of x's f32 values:
    x [B, C, H, W] -> [B, 2, C] f32."""
    xf = x.float()
    return torch.stack([xf.sum(dim=(2, 3)), (xf * xf).sum(dim=(2, 3))], dim=1)


def _launch(t: torch.Tensor, fn, args: struct.Struct, *values) -> int:
    """fn(block) on t's device, block the values and the raw current stream
    of that device packed as int64 (the launchers' one argument: ctypes then
    converts one argument, not eleven). The device is entered only when it
    is not the current one, so that the kernel always launches where t
    lies."""
    idx = t.get_device()
    if idx == torch._C._cuda_getDevice():
        return fn(args.pack(*values, torch._C._cuda_getCurrentRawStream(idx)))
    with torch.cuda.device(idx):
        return fn(args.pack(*values, torch._C._cuda_getCurrentRawStream(idx)))


_MOMENT_ARGS = struct.Struct("7q")     # x, mom, B, C, HW, dtype, stream
_APPLY_ARGS = struct.Struct("11q")     # f, zq, mom, par, out, B, C, HW,
                                       # dtype, swish, stream


def _refusal(f: torch.Tensor, zq_r=None):
    """The CUDA kernels' limits on their inputs, the one place they are
    stated: None where the moment pass (zq_r None) or the moment pass and
    the apply kernel take them, else the (exception type, message) their
    wrappers raise. f: f32 or bf16, a non-empty contiguous [B, C, H, W] with
    B up to 65535; for the apply, C a multiple of 32 up to 2048 and zq_r a
    contiguous [B, 4, H, W] in f's dtype on f's device, both 16-byte
    aligned."""
    if f.dtype not in _DTYPE_CODE:
        return TypeError, f"takes float32 or bfloat16, got {f.dtype}"
    if f.dim() != 4 or f.numel() == 0:
        return ValueError, (f"expected a non-empty [B, C, H, W] tensor, got "
                            f"{tuple(f.shape)}")
    b, c, h, w = f.shape
    if b > 65535:
        return ValueError, f"batch {b} is above the grid limit 65535"
    if not f.is_contiguous():
        return ValueError, "needs a contiguous NCHW tensor"
    if zq_r is None:
        return None
    if c % GROUPS or c > 64 * GROUPS:
        return ValueError, (f"takes C a multiple of 32 up to 2048, got "
                            f"{tuple(f.shape)}")
    if zq_r.shape != (b, 4, h, w) or zq_r.dtype != f.dtype:
        return ValueError, (f"zq_r: expected [{b}, 4, {h}, {w}] {f.dtype}, "
                            f"got {tuple(zq_r.shape)} {zq_r.dtype}")
    if (zq_r.device != f.device or not zq_r.is_contiguous()
            or (f.data_ptr() | zq_r.data_ptr()) % 16):
        return ValueError, (f"f and zq_r: need contiguous, 16-byte aligned "
                            f"tensors on {f.device}")
    return None


def gn_moments_kernel(x: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA moment kernel. CUDA tensors only: anything the kernel
    does not take raises, and a failed build or launch raises."""
    if not x.is_cuda:
        raise ValueError("gn_moments_kernel launches a CUDA kernel and takes "
                         "CUDA tensors only; use gn_moments() or "
                         "gn_moments_reference() for CPU tensors")
    if x.requires_grad and torch.is_grad_enabled():
        raise RuntimeError("gn_moments_kernel records no gradient; under "
                           "grad call gn_moments()")
    refusal = _refusal(x)
    if refusal:
        raise refusal[0](f"gn_moments_kernel: {refusal[1]}")
    b, c, h, w = x.shape
    mom = torch.empty((b, 2, c), dtype=torch.float32, device=x.device)
    rc = _launch(x, build.function("gn_moments", "cgic_gn_moments"),
                 _MOMENT_ARGS, x.data_ptr(), mom.data_ptr(), b, c, h * w,
                 _DTYPE_CODE[x.dtype])
    if rc:
        build.check(build.load("gn_moments"), rc, "gn_moments")
    build.count_launch(KERNEL_LAUNCHES, "gn_moments")
    return mom


class _GnMomentsFn(torch.autograd.Function):
    """The moment kernel with a gradient: d/dx of (sum, sumsq) over H*W is
    g_sum + 2·x·g_sumsq, broadcast over the pixels, in f32 and then cast to
    x's dtype (what XLA's differentiation of the JAX stats fold gives)."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return gn_moments_kernel(x)

    @staticmethod
    def backward(ctx, g):
        x, = ctx.saved_tensors
        g = g.float()[..., None, None]                  # [B, 2, C, 1, 1]
        return (g[:, 0] + 2.0 * x.float() * g[:, 1]).to(x.dtype)


def gn_moments(x: torch.Tensor) -> torch.Tensor:
    """[B, 2, C] f32 moments of x: the kernel for CUDA tensors (inside
    _GnMomentsFn where x needs a gradient), the plain version for CPU
    tensors (and inside ops.plain_versions())."""
    if use_kernel(x):
        if torch.is_grad_enabled() and x.requires_grad:
            return _GnMomentsFn.apply(x)
        return gn_moments_kernel(x)
    return gn_moments_reference(x)


def gn_stats_from_moments(mom: torch.Tensor, hw: int, groups: int = GROUPS
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold per-channel moments [B, 2, C] (sum, sumsq over hw pixels) into
    per-channel-expanded GroupNorm (mean_c, rstd_c), [B, C] f32 each: the
    group fold of JAX `_gn_stats_pallas` (and `stats_from_moments`)."""
    b, _, c = mom.shape
    cg = c // groups
    n = hw * cg
    s1 = mom[:, 0].reshape(b, groups, cg).sum(-1)
    s2 = mom[:, 1].reshape(b, groups, cg).sum(-1)
    mean = s1 / n
    var = torch.clamp(s2 / n - torch.square(mean), min=0.0)
    rstd = torch.rsqrt(var + EPS)
    return (mean.repeat_interleave(cg, dim=1),
            rstd.repeat_interleave(cg, dim=1))


def gn_stats(f: torch.Tensor, groups: int = GROUPS
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(batch, channel) mean and rstd in f32, [B, C, 1, 1] each, from
    the per-group statistics of f: [B, C, H, W]."""
    b, c, h, w = f.shape
    xg = f.float().reshape(b, groups, c // groups * h * w)
    mean = xg.mean(dim=-1)
    mean2 = torch.square(xg).mean(dim=-1)
    var = torch.clamp(mean2 - torch.square(mean), min=0.0)
    rstd = torch.rsqrt(var + EPS)
    cg = c // groups
    return (mean.repeat_interleave(cg, dim=1).reshape(b, c, 1, 1),
            rstd.repeat_interleave(cg, dim=1).reshape(b, c, 1, 1))


def group_norm_reference(f: torch.Tensor, scale: torch.Tensor,
                         bias: torch.Tensor, groups: int = GROUPS
                         ) -> torch.Tensor:
    """flax nn.GroupNorm(groups, eps=1e-6) on f's f32 values; f32 out."""
    return group_norm_apply(f, *gn_stats(f, groups), scale, bias)


def group_norm_apply(f: torch.Tensor, mean: torch.Tensor, rstd: torch.Tensor,
                     scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """group_norm_reference from given [B, C, 1, 1] statistics (the
    H-sharded codec's, summed over the shards)."""
    mul = rstd * scale.float()[:, None, None]
    return (f.float() - mean) * mul + bias.float()[:, None, None]


def spatial_norm_reference(f: torch.Tensor, zq_r: torch.Tensor,
                           gn_scale: torch.Tensor, gn_bias: torch.Tensor,
                           wy: torch.Tensor, by: torch.Tensor,
                           wb: torch.Tensor, bb: torch.Tensor,
                           act_swish: bool) -> torch.Tensor:
    """f: [B, C, H, W]; zq_r: [B, Z, H, W] (nearest-resized to f); wy, wb:
    [C, Z] 1x1-conv weights; by, bb, gn_scale, gn_bias: [C]. Output in
    f's dtype."""
    return spatial_norm_apply_reference(f, zq_r, *gn_stats(f), gn_scale,
                                        gn_bias, wy, by, wb, bb, act_swish)


def spatial_norm_apply_reference(f: torch.Tensor, zq_r: torch.Tensor,
                                 mean: torch.Tensor, rstd: torch.Tensor,
                                 gn_scale: torch.Tensor, gn_bias: torch.Tensor,
                                 wy: torch.Tensor, by: torch.Tensor,
                                 wb: torch.Tensor, bb: torch.Tensor,
                                 act_swish: bool) -> torch.Tensor:
    """spatial_norm_reference from given [B, C, 1, 1] statistics (the
    H-sharded codec's, summed over the shards)."""
    dt = f.dtype
    col = lambda t: t.to(dt)[:, None, None]
    normed = (f - mean.to(dt)) * (rstd.to(dt) * col(gn_scale)) + col(gn_bias)
    z4 = zq_r.to(dt)
    terms_y = [z4[:, z:z + 1] * col(wy[:, z]) for z in range(z4.shape[1])]
    terms_b = [z4[:, z:z + 1] * col(wb[:, z]) for z in range(z4.shape[1])]
    y = col(by) + _chain_sum(terms_y)
    bmod = col(bb) + _chain_sum(terms_b)
    out = normed * y + bmod
    if act_swish:
        out = out * torch.sigmoid(out)
    return out


def _chain_sum(terms):
    # left to right, as Python's sum() adds them in the JAX formula
    acc = terms[0]
    for t in terms[1:]:
        acc = acc + t
    return acc


# ------------------------------------------------- the kernels' numerics

def _col(t: torch.Tensor) -> torch.Tensor:
    return t[..., None, None]


def _normalize(x: torch.Tensor, gs: torch.Tensor, gb: torch.Tensor,
               stats: Stats) -> torch.Tensor:
    mean_c, rstd_c = stats[0].float(), stats[1].float()
    return ((x.float() - _col(mean_c)) * _col(rstd_c * gs.float())
            + _col(gb.float()))


def group_norm_kernel_act(x: torch.Tensor, gs: torch.Tensor, gb: torch.Tensor,
                          act_swish: bool, stats: Stats) -> torch.Tensor:
    """GroupNorm(+swish) in the kernels' numerics: f32 normalize with the
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
    """SpatialNorm(+swish) in the kernels' numerics: the f32 dot-form
    modulation (zq @ wy + by), not the broadcast form of
    spatial_norm_reference. The plain version of the apply kernel, and the
    activation of the chain's. zq_r: [B, Z, H, W]; wy, wb: [C, Z]."""
    out = _normalize(x, gs, gb, stats)
    zf = zq_r.float().permute(0, 2, 3, 1)                  # [B, H, W, Z]
    y = (zf @ wy.float().t() + by.float()).permute(0, 3, 1, 2)
    bm = (zf @ wb.float().t() + bb.float()).permute(0, 3, 1, 2)
    out = out * y + bm
    if act_swish:
        out = out * torch.sigmoid(out)
    return out.to(x.dtype)


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a*b + c rounded once to f32, as a CUDA fmaf (the product is exact in
    f64)."""
    return (a.double() * b.double() + c.double()).float()


def spatial_norm_apply_replay(f: torch.Tensor, zq_r: torch.Tensor,
                              gs: torch.Tensor, gb: torch.Tensor,
                              wy: torch.Tensor, by: torch.Tensor,
                              wb: torch.Tensor, bb: torch.Tensor,
                              mom: torch.Tensor, act_swish: bool
                              ) -> torch.Tensor:
    """CPU replay of kernels/spatial_norm_apply.cu's order of operations in
    f32: the group fold of the moments [B, 2, C] (the group's channels summed
    in channel order), the per-channel coefficients s = rstd*gamma, t = beta -
    mean*s, a = (s*by, s*wy), b = (t*by + bb, t*wy + wb), then per element
    x*(a0 + sum_z zq_z*a_z) + (b0 + sum_z zq_z*b_z) by FMAs, the swish with an
    exact sigmoid (the kernel's is fast), rounded to f's dtype. wy, wb:
    [C, Z]."""
    b, c, h, w = f.shape
    cg = c // GROUPS
    m = mom.float().reshape(b, 2, GROUPS, cg)
    s1, s2 = m[:, 0, :, 0], m[:, 1, :, 0]
    for j in range(1, cg):
        s1, s2 = s1 + m[:, 0, :, j], s2 + m[:, 1, :, j]
    n = float(h * w * cg)
    mean = s1 / n
    var = torch.clamp(s2 / n - mean * mean, min=0.0)
    rstd = torch.rsqrt(var + EPS)
    mean, rstd = (mean.repeat_interleave(cg, 1), rstd.repeat_interleave(cg, 1))
    f32 = lambda t: t.float().expand(b, c)
    s = rstd * f32(gs)
    t = _fma(-mean, s, f32(gb))
    ka = [s * f32(by)] + [s * f32(wy[:, z]) for z in range(4)]
    kb = [_fma(t, f32(by), f32(bb))] + [_fma(t, f32(wy[:, z]), f32(wb[:, z]))
                                        for z in range(4)]
    zf = zq_r.float()
    a, bm = _col(ka[0]), _col(kb[0])
    for z in range(4):
        a = _fma(zf[:, z:z + 1], _col(ka[1 + z]), a)
        bm = _fma(zf[:, z:z + 1], _col(kb[1 + z]), bm)
    out = _fma(f.float(), a, bm)
    if act_swish:
        out = out * torch.sigmoid(out)
    return out.to(f.dtype)


# ------------------------------------------------------ the apply kernel

def _packed_params(gs, gb, wy, by, wb, bb, dev) -> torch.Tensor:
    """The apply kernel's parameters, [4 + 2Z, C] f32 on dev: gamma, beta,
    by, bb, then wy and wb as [Z, C]; made once per version of the weights
    (norm_conv._cached: an in-place update, an optimizer step or
    load_state_dict, makes it anew). SpatialNorm passes its 1x1 conv weights
    as weight[:, :, 0, 0], a view made on every call, so a view is keyed by
    its base and where it lies in it."""
    from .norm_conv import _cached           # norm_conv imports this module

    def pack():
        c = gs.shape[0]
        for t, shape, name in ((gs, (c,), "gs"), (gb, (c,), "gb"),
                               (wy, (c, 4), "wy"), (by, (c,), "by"),
                               (wb, (c, 4), "wb"), (bb, (c,), "bb")):
            if tuple(t.shape) != shape:
                raise ValueError(f"{name}: expected shape {shape}, got "
                                 f"{tuple(t.shape)}")
        f32 = lambda t: t.detach().to(dev, torch.float32)
        return torch.cat([torch.stack([f32(gs), f32(gb), f32(by), f32(bb)]),
                          f32(wy).t(), f32(wb).t()]).contiguous()

    yb, bbase = wy._base, wb._base
    if yb is None and bbase is None:
        return _cached((gs, gb, wy, by, wb, bb), (dev,), pack)
    roots = (gs, gb, wy if yb is None else yb, by,
             wb if bbase is None else bbase, bb)
    return _cached(roots, (dev, wy.data_ptr(), wy.shape, wy.stride(),
                           wb.data_ptr(), wb.shape, wb.stride()), pack)


def spatial_norm_apply_kernel(f: torch.Tensor, zq_r: torch.Tensor,
                              gs: torch.Tensor, gb: torch.Tensor,
                              wy: torch.Tensor, by: torch.Tensor,
                              wb: torch.Tensor, bb: torch.Tensor,
                              mom: torch.Tensor, act_swish: bool
                              ) -> torch.Tensor:
    """Launch the CUDA SpatialNorm apply kernel, which folds the GroupNorm
    moments mom [B, 2, C] f32 (gn_moments) into the per-channel stats
    itself. f: [B, C, H, W] f32 or bf16, C a multiple of 32 up to 2048;
    zq_r: [B, 4, H, W] in f's dtype; wy, wb: [C, 4]. CUDA tensors only:
    anything the kernel does not take raises, and a failed build or launch
    raises."""
    if not f.is_cuda:
        raise ValueError("spatial_norm_apply_kernel launches a CUDA kernel and "
                         "takes CUDA tensors only; use spatial_norm() for CPU "
                         "tensors")
    if torch.is_grad_enabled() and (
            f.requires_grad or zq_r.requires_grad or mom.requires_grad
            or gs.requires_grad or gb.requires_grad or wy.requires_grad
            or by.requires_grad or wb.requires_grad or bb.requires_grad):
        raise RuntimeError("spatial_norm_apply_kernel records no gradient; "
                           "under grad call spatial_norm()")
    refusal = _refusal(f, zq_r)
    if refusal:
        raise refusal[0](f"spatial_norm_apply_kernel: {refusal[1]}")
    b, c, h, w = f.shape
    dev = f.device
    if (mom.shape != (b, 2, c) or mom.dtype != torch.float32
            or mom.device != dev or not mom.is_contiguous()):
        raise ValueError(f"mom: expected a contiguous [{b}, 2, {c}] float32 "
                         f"tensor on {dev}, got {tuple(mom.shape)} "
                         f"{mom.dtype} on {mom.device}")
    par = _packed_params(gs, gb, wy, by, wb, bb, dev)
    if par.shape[1] != c:
        raise ValueError(f"the norm parameters have {par.shape[1]} channels, "
                         f"f has {c}")
    out = torch.empty_like(f)
    rc = _launch(f, build.function("spatial_norm_apply",
                                   "cgic_spatial_norm_apply"), _APPLY_ARGS,
                 f.data_ptr(), zq_r.data_ptr(), mom.data_ptr(),
                 par.data_ptr(), out.data_ptr(), b, c, h * w,
                 _DTYPE_CODE[f.dtype], int(act_swish))
    if rc:
        build.check(build.load("spatial_norm_apply"), rc,
                    "spatial_norm_apply")
    build.count_launch(KERNEL_LAUNCHES, "spatial_norm_apply")
    return out


def _fused_forward(f, zq_r, gs, gb, wy, by, wb, bb, act_swish: bool,
                   stats_only: bool) -> torch.Tensor:
    """The moment pass, then the apply: for a CUDA tensor the kernel, which
    folds the moments itself (JAX `_fused_forward`: two launches), or with
    stats_only and on the CPU the torch fold and its plain version (JAX
    `_stats_only_forward`)."""
    mom = gn_moments(f)
    if use_kernel(f) and not stats_only:
        return spatial_norm_apply_kernel(f, zq_r, gs, gb, wy, by, wb, bb, mom,
                                         act_swish)
    stats = gn_stats_from_moments(mom, f.shape[2] * f.shape[3])
    return spatial_norm_kernel_act(f, zq_r, gs, gb, wy, by, wb, bb,
                                   act_swish, stats)


class _SpatialNormFn(torch.autograd.Function):
    """The switched SpatialNorm with a gradient (JAX `_make_fused`): the
    forward is `_fused_forward`; the backward reruns spatial_norm_reference
    on the saved inputs under autograd (the stats recomputed from f) and
    differentiates it. Inputs: act_swish, stats_only, then f, zq_r, gs, gb,
    wy, by, wb, bb."""

    @staticmethod
    def forward(ctx, act_swish, stats_only, f, zq_r, gs, gb, wy, by, wb, bb):
        ctx.act_swish = act_swish
        ctx.save_for_backward(f, zq_r, gs, gb, wy, by, wb, bb)
        return _fused_forward(f, zq_r, gs, gb, wy, by, wb, bb, act_swish,
                              stats_only)

    @staticmethod
    def backward(ctx, g):
        need = ctx.needs_input_grad[2:]
        leaves = [t.detach().requires_grad_(n)
                  for t, n in zip(ctx.saved_tensors, need)]
        with torch.enable_grad():
            out = spatial_norm_reference(*leaves, act_swish=ctx.act_swish)
        wanted = [t for t, n in zip(leaves, need) if n]
        got = iter(torch.autograd.grad(out, wanted, g, allow_unused=True))
        return (None, None) + tuple(next(got) if n else None for n in need)


# ---------------------------------------------------------- the dispatch

def fused_norms_enabled() -> bool:
    """JAX `fused_norms_enabled`: CONTROL_GIC_FUSED_NORM set to any
    non-empty value, read at call time. Off by default, as in JAX. On the
    card the default dispatch takes the same kernels where no gradient is
    recorded, so there the switch adds them under grad (_SpatialNormFn)."""
    return bool(os.environ.get("CONTROL_GIC_FUSED_NORM"))


def stats_kernel_enabled() -> bool:
    """JAX `stats_kernel_enabled`: CONTROL_GIC_STATS_KERNEL set to any
    non-empty value, read at call time; off by default."""
    return bool(os.environ.get("CONTROL_GIC_STATS_KERNEL"))


def kernels_take(f: torch.Tensor, zq_r: torch.Tensor) -> bool:
    """Whether the moment pass and the apply kernel take f and zq_r (zq_r
    already in f's dtype): `_refusal` finds nothing."""
    return _refusal(f, zq_r) is None


def spatial_norm(f: torch.Tensor, zq_r: torch.Tensor, gn_scale: torch.Tensor,
                 gn_bias: torch.Tensor, wy: torch.Tensor, by: torch.Tensor,
                 wb: torch.Tensor, bb: torch.Tensor, act_swish: bool = False,
                 use_fused=None) -> torch.Tensor:
    """SpatialNorm (+ optional swish), JAX `spatial_norm`: the apply kernel
    under CONTROL_GIC_FUSED_NORM (or use_fused=True), the moment pass with a
    torch apply under CONTROL_GIC_STATS_KERNEL, both where `_row_block`
    finds a block for f's shape. Otherwise, with use_fused=None, the moment
    pass and the apply kernel where `use_kernel(f)` holds, no gradient is
    recorded and `kernels_take` holds; spatial_norm_reference for the rest.
    f: [B, C, H, W]; zq_r: [B, Z, H, W], cast to f's dtype on the kernels'
    paths; wy, wb: [C, Z]."""
    admissible = _row_block(f.shape[2] * f.shape[3], f.shape[1]) > 0
    default = use_fused is None
    if default:
        use_fused = fused_norms_enabled() and admissible
    stats_only = not use_fused and stats_kernel_enabled() and admissible
    on_card = use_kernel(f)
    if use_fused or stats_only or (default and on_card):
        args = (f, zq_r.to(f.dtype), gn_scale, gn_bias, wy, by, wb, bb)
        grad = torch.is_grad_enabled() and any(t.requires_grad for t in args)
        if use_fused or stats_only:
            if grad:
                return _SpatialNormFn.apply(act_swish, stats_only, *args)
            return _fused_forward(*args, act_swish, stats_only)
        if not grad and kernels_take(f, args[1]):
            return _fused_forward(*args, act_swish, False)
    if on_card:
        build.count_launch(PLAIN_CALLS, "spatial_norm")
    return spatial_norm_reference(f, zq_r, gn_scale, gn_bias, wy, by, wb, bb,
                                  act_swish)
