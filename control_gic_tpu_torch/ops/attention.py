"""Single-head full self-attention over flattened spatial tokens, and its
gradient.

Port of control_gic_tpu/ops/attention.py: scale C^-0.5, softmax over keys,
no mask, one head. Inputs are [B, T, C] float32 or bfloat16; the output has
q's dtype. Tq may differ from Tk.

The forward:
  - `attention_reference`: the plain einsum path (JAX `attention_xla`);
  - `flash_attention_blocked_reference`: a torch replay of the flash kernel's
    online softmax over key blocks at the kernel's blocking, with its split
    KV combine, optionally with the per-row logsumexp, for the CPU tests (the
    analog of Pallas `interpret=True`);
  - `flash_attention`: the CUDA kernel (kernels/flash_attn_fwd.cu), with the
    logsumexp when `return_lse` (JAX `attention_flash_with_lse`), for CUDA
    tensors only.
The backward (FlashAttention-2, JAX `_flash_backward`):
  - `flash_attention_backward_blocked_reference`: a torch replay of the two
    backward kernels' loops;
  - `flash_attention_backward`: the CUDA kernels (kernels/flash_attn_bwd.cu).
`FlashAttentionFn` (JAX `_flash_diff`) puts the lse forward and the two
backward kernels in one autograd.Function.

`attention` takes the kernels from FLASH_MIN_TOKENS keys on. Where no
gradient is recorded the forward kernel runs at any Tq and Tk, since it
masks the key columns past Tk and stores only the query rows below Tq (a
rule re-derived on the H100: at lengths that JAX's blocks do not divide the
plain path is two f32 GEMMs over a materialised Tq×Tk matrix). Under grad
the dispatch keeps the JAX package's rule, the kernels only where JAX's
blocks divide both lengths, and takes FlashAttentionFn, or with
CONTROL_GIC_FLASH_BWD=xla the forward kernel and a backward through autograd
of `attention_reference` (JAX's einsum-recompute switch). Nothing selects
that switch on a failure.
"""
from __future__ import annotations

import ctypes
import os
from typing import Optional, Tuple

import torch

from ..kernels import build
from . import use_kernel

# The kernels engage from this many keys, the JAX package's threshold. Without
# a gradient the forward kernel then takes any length (re-derived on the
# H100); under grad the kernels also need JAX's blocks of _BLOCK_Q query rows
# and _BLOCK_K keys, or halves of them down to 256, to divide the lengths
# (the JAX package's rule, tuned on a TPU and kept as it is).
FLASH_MIN_TOKENS = 4096
_BLOCK_Q = 1024
_BLOCK_K = 512

# Launches of the CUDA kernels in this process, by kernel: the forward
# without and with the logsumexp, the dk/dv backward (with its delta
# pre-pass) and the dq backward. A wrapper adds one where it launches its
# kernel; a caller resets them to 0 and reads them back to see that a run
# went through the kernels.
KERNEL_LAUNCHES = build.counter({"flash_fwd": 0, "flash_fwd_lse": 0,
                                 "flash_bwd_dkdv": 0, "flash_bwd_dq": 0})
# Calls of `attention` that ran attention_reference where `use_kernel` holds
# (a CUDA tensor outside plain_versions()) with at least FLASH_MIN_TOKENS
# keys, which under grad are the lengths JAX's blocks do not divide.
# Counted as the launches are.
PLAIN_CALLS = build.counter({"attention": 0})

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# (device, B, Tq, Tk, C, dtype code) -> the forward's key splits on that card
_SPLITS = {}
_MAX_C = 512


def _scale(c: int) -> float:
    """jnp.asarray(c, float32) ** -0.5 in the JAX path: a float32 power,
    taken on the host (a Python float of the f32 value, which a multiply
    with an f32 tensor rounds to itself), so that no copy to the device
    syncs a captured program."""
    return (torch.tensor(float(c), dtype=torch.float32) ** -0.5).item()


def attention_reference(q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor) -> torch.Tensor:
    """softmax(q kᵀ · C^-0.5) v with both products accumulated in f32 and the
    weights cast to q's dtype before the second (JAX `attention_xla`)."""
    logits = torch.matmul(q.float(), k.float().transpose(1, 2)) * _scale(
        q.shape[-1])
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.matmul(w.float(), v.float()).to(q.dtype)


def kernel_blocks(dtype: torch.dtype, c: int) -> Tuple[int, int]:
    """The forward kernel's (query rows, keys) a tile: 64 query rows; in
    bf16 32 keys a stage where C rounded up to 128 is above 256, else 64; in
    f32 64 (kernels/flash_attn_fwd.cu, Bf16Cfg and F32Cfg)."""
    if dtype == torch.bfloat16 and -(-c // 128) * 128 > 256:
        return 64, 32
    return 64, 64


def flash_attention_blocked_reference(q: torch.Tensor, k: torch.Tensor,
                                      v: torch.Tensor,
                                      block_q: Optional[int] = None,
                                      block_k: Optional[int] = None,
                                      return_lse: bool = False,
                                      splits: int = 1):
    """The kernel's arithmetic replayed block by block: per query block a
    running max, denominator and f32 accumulator, rescaled by
    exp(m_prev - m_new) at each key block, p cast to v's dtype before PV.
    Blocks need not divide the lengths; they default to the kernel's
    (`kernel_blocks`). With splits > 1 the key blocks are cut into that many
    contiguous runs of ceil(blocks / splits) each, every run keeps its own
    (acc, m, l), and the runs are folded in order as the kernel's combine
    does: M = max m_s, w_s = exp(m_s - M), L = Σ l_s w_s, out = Σ acc_s w_s
    / L. With return_lse, also the per-row logsumexp m + log l of the scaled
    logits, [B, Tq] f32."""
    b, tq, c = q.shape
    tk = k.shape[1]
    dq, dk = kernel_blocks(q.dtype, c)
    block_q, block_k = block_q or dq, block_k or dk
    nkt = -(-tk // block_k)
    per = -(-nkt // splits)
    if splits < 1 or (splits - 1) * per >= nkt:
        raise ValueError(f"{splits} splits of {nkt} key blocks leave one "
                         f"empty")
    scale = float(c) ** -0.5
    out = torch.empty_like(q)
    lse = torch.empty(b, tq, dtype=torch.float32, device=q.device)
    for q0 in range(0, tq, block_q):
        qb = q[:, q0:q0 + block_q].float()
        rows = qb.shape[1]
        parts = []
        for t0 in range(0, nkt, per):
            m = torch.full((b, rows, 1), float("-inf"), device=q.device)
            l = torch.zeros((b, rows, 1), device=q.device)
            acc = torch.zeros((b, rows, c), device=q.device)
            for k0 in range(t0 * block_k, min(nkt, t0 + per) * block_k,
                            block_k):
                kb = k[:, k0:k0 + block_k].float()
                vb = v[:, k0:k0 + block_k]
                s = torch.matmul(qb, kb.transpose(1, 2)) * scale
                m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
                p = torch.exp(s - m_new)
                corr = torch.exp(m - m_new)
                l = l * corr + p.sum(dim=-1, keepdim=True)
                acc = acc * corr + torch.matmul(p.to(v.dtype).float(),
                                                vb.float())
                m = m_new
            parts.append((acc, m, l))
        if len(parts) == 1:
            acc, m, l = parts[0]
        else:
            m = torch.stack([pm for _, pm, _ in parts]).amax(dim=0)
            acc, l = torch.zeros_like(parts[0][0]), torch.zeros_like(m)
            for pa, pm, pl in parts:
                w = torch.exp(pm - m)
                l = l + pl * w
                acc = acc + pa * w
        out[:, q0:q0 + block_q] = (acc / l).to(q.dtype)
        lse[:, q0:q0 + block_q] = (m + torch.log(l))[..., 0]
    return (out, lse) if return_lse else out


def kernel_bwd_blocks(dtype: torch.dtype, c: int
                      ) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """The backward kernels' tiles, ((query rows a step, keys a CTA) of the
    dk/dv kernel, (query rows a CTA, keys a step) of the dq kernel): in bf16
    64 query rows and BK keys in both, BK = 32 where C rounded up to 128 is
    above 256, else 64 (kernels/flash_attn_bwd.cu, Bf16Cfg); in f32 a CTA
    owns 32 rows and walks the other side 64 at a time, at every C
    (F32Cfg)."""
    if dtype == torch.bfloat16:
        bk = 32 if -(-c // 128) * 128 > 256 else 64
        return (64, bk), (64, bk)
    return (64, 32), (32, 64)


def flash_attention_backward_blocked_reference(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
        lse: torch.Tensor, do: torch.Tensor, block_q: Optional[int] = None,
        block_k: Optional[int] = None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernels' arithmetic replayed block by block (JAX
    `_flash_backward`): delta = rowsum(do∘o) once in f32; per key block a
    walk over the query blocks for dk and dv, per query block a walk over
    the key blocks for dq. p = exp(s·scale − lse) in f32; ds = p∘(do vᵀ −
    delta). In bf16, p is rounded before pᵀ do, ds before dsᵀ q and ds k,
    and dk and dq sum the unscaled block products and are scaled once at
    the end, as the bf16 kernels do (JAX scales each block product); in
    f32 the scale is folded into ds (ds·scale), and dk and dq sum the
    unscaled block products of it, as the f32 kernels do. lse is [B, Tq]
    f32. The blocks default to the kernels' (`kernel_bwd_blocks`); given
    block_q and block_k serve both walks. They need not divide the
    lengths."""
    tq, c = q.shape[1], q.shape[2]
    tk = k.shape[1]
    scale = float(c) ** -0.5
    dt = q.dtype
    fold = dt == torch.float32
    post = 1.0 if fold else scale     # the scale of dk and dq after the sums
    (kv_bq, kv_bk), (q_bq, q_bk) = kernel_bwd_blocks(dt, c)
    if block_q or block_k:
        kv_bq = q_bq = block_q or kv_bq
        kv_bk = q_bk = block_k or kv_bk
    f = lambda t: t.float()
    delta = (f(do) * f(o)).sum(dim=-1, keepdim=True)          # [B, Tq, 1]
    lse = lse.float()[..., None]

    def block(q0, bq, k0, bk):
        """The block's q, do and k rows in f32, and p and ds (·scale under
        fold) rounded to dt."""
        qb, dob = f(q[:, q0:q0 + bq]), f(do[:, q0:q0 + bq])
        kb, vb = f(k[:, k0:k0 + bk]), f(v[:, k0:k0 + bk])
        s = torch.matmul(qb, kb.transpose(1, 2)) * scale
        p = torch.exp(s - lse[:, q0:q0 + bq])
        dp = torch.matmul(dob, vb.transpose(1, 2))
        ds = p * (dp - delta[:, q0:q0 + bq])
        if fold:
            ds = ds * scale
        return qb, dob, kb, f(p.to(dt)), f(ds.to(dt))

    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    for k0 in range(0, tk, kv_bk):
        rows = k[:, k0:k0 + kv_bk].shape[1]
        dk_acc = torch.zeros(k.shape[0], rows, c, device=q.device)
        dv_acc = torch.zeros_like(dk_acc)
        for q0 in range(0, tq, kv_bq):
            qb, dob, _, p, ds = block(q0, kv_bq, k0, kv_bk)
            dv_acc = dv_acc + torch.matmul(p.transpose(1, 2), dob)
            dk_acc = dk_acc + torch.matmul(ds.transpose(1, 2), qb)
        dk[:, k0:k0 + kv_bk] = (dk_acc * post).to(dt)
        dv[:, k0:k0 + kv_bk] = dv_acc.to(dt)
    dq = torch.empty_like(q)
    for q0 in range(0, tq, q_bq):
        rows = q[:, q0:q0 + q_bq].shape[1]
        dq_acc = torch.zeros(q.shape[0], rows, c, device=q.device)
        for k0 in range(0, tk, q_bk):
            _, _, kb, _, ds = block(q0, q_bq, k0, q_bk)
            dq_acc = dq_acc + torch.matmul(ds, kb)
        dq[:, q0:q0 + q_bq] = (dq_acc * post).to(dt)
    return dq, dk, dv


# ---------------------------------------------------------------- kernels

def _check(name: str, q: torch.Tensor, k: torch.Tensor,
           v: torch.Tensor, *like_q: torch.Tensor) -> None:
    """What the kernels take: CUDA, one dtype, q (and `like_q`) [B,Tq,C],
    k and v [B,Tk,C], C a multiple of 16 up to 512, contiguous, 16-byte
    aligned; and no tensor that autograd would need a gradient for, since a
    raw launch records none (FlashAttentionFn carries the gradient)."""
    ts = (q, k, v) + like_q
    if not all(t.is_cuda for t in ts):
        raise ValueError(f"{name} launches a CUDA kernel and takes CUDA "
                         f"tensors only; use attention() or "
                         f"attention_reference() for CPU tensors")
    if len({t.dtype for t in ts}) != 1 or q.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name} takes float32 or bfloat16 tensors of one "
                        f"dtype, got {[t.dtype for t in ts]}")
    if q.dim() != 3 or k.shape != v.shape or k.dim() != 3 \
            or q.shape[0] != k.shape[0] or q.shape[2] != k.shape[2] \
            or any(t.shape != q.shape for t in like_q):
        raise ValueError(f"expected q [B,Tq,C] and k, v [B,Tk,C], got "
                         f"{[tuple(t.shape) for t in ts]}")
    c = q.shape[2]
    if c % 16 or c > _MAX_C:
        raise ValueError(f"head dim {c} must be a multiple of 16, at most "
                         f"{_MAX_C}")
    if q.shape[0] > 65535:
        raise ValueError(f"batch {q.shape[0]} is above the grid limit 65535")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError(f"{name} needs contiguous tensors")
    if any(t.data_ptr() % 16 for t in ts):
        raise ValueError(f"{name} needs 16-byte aligned tensors")
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise RuntimeError(f"{name} records no gradient; under grad call "
                           f"attention() or FlashAttentionFn.apply()")


def _ptr(t: Optional[torch.Tensor]) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    return_lse: bool = False):
    """Launch the CUDA flash-attention forward; with return_lse also the
    per-row logsumexp [B, Tq] f32 (the training forward). CUDA tensors
    only: anything the kernel does not take raises, and a failed build or
    launch raises. Returns out, or (out, lse). Where the query tiles alone
    would not fill the card the kernel splits the keys: the f32 workspace
    for the splits' partials is allocated here, and the combine pass is part
    of the one launch that the count records."""
    _check("flash_attention", q, k, v)
    b, tq, c = q.shape
    tk, code = k.shape[1], _DTYPE_CODE[q.dtype]
    lib = build.load("flash_attn_fwd")
    out = torch.empty_like(q)
    lse = (torch.empty(b, tq, dtype=torch.float32, device=q.device)
           if return_lse else None)
    with torch.cuda.device(q.device):
        key = (q.device.index, b, tq, tk, c, code)
        splits = _SPLITS.get(key)
        if splits is None:
            splits = _SPLITS[key] = lib.cgic_flash_attn_splits(b, tq, tk, c,
                                                               code)
        if splits < 1:
            raise RuntimeError(f"flash_attn_fwd: no key split count for "
                               f"{tuple(q.shape)}, Tk={tk} ({splits})")
        ws = (torch.empty(splits * b * tq * (c + 2), dtype=torch.float32,
                          device=q.device) if splits > 1 else None)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.cgic_flash_attn_fwd(
            _ptr(q), _ptr(k), _ptr(v), _ptr(out), _ptr(lse), _ptr(ws),
            ctypes.c_int(b), ctypes.c_int(tq), ctypes.c_int(tk),
            ctypes.c_int(c), ctypes.c_int(code), ctypes.c_int(splits),
            ctypes.c_float(float(c) ** -0.5), ctypes.c_void_p(stream))
    build.check(lib, rc, "flash_attn_fwd")
    build.count_launch(KERNEL_LAUNCHES,
                       "flash_fwd_lse" if return_lse else "flash_fwd")
    return (out, lse) if return_lse else out


def _check_lse(q: torch.Tensor, lse: torch.Tensor, name: str) -> None:
    b, tq = q.shape[:2]
    if lse.dtype != torch.float32 or tuple(lse.shape) != (b, tq) \
            or lse.device != q.device or not lse.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous [{b}, {tq}] float32 "
                         f"tensor on {q.device}, got {tuple(lse.shape)} "
                         f"{lse.dtype} on {lse.device}")


def _bwd_args(q: torch.Tensor, k: torch.Tensor):
    b, tq, c = q.shape
    dims = [ctypes.c_int(x) for x in (b, tq, k.shape[1], c,
                                      _DTYPE_CODE[q.dtype])]
    stream = ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream)
    return dims + [ctypes.c_float(float(c) ** -0.5), stream]


def flash_attention_backward_dkdv(q, k, v, o, lse, do):
    """Launch the dk/dv backward kernel after its delta pre-pass. Returns
    (dk, dv, delta), delta = rowsum(do∘o) [B, Tq] f32 for the dq kernel."""
    _check("flash_attention_backward_dkdv", q, k, v, o, do)
    _check_lse(q, lse, "lse")
    lib = build.load("flash_attn_bwd")
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        rc = lib.cgic_flash_attn_bwd_dkdv(
            _ptr(q), _ptr(k), _ptr(v), _ptr(o), _ptr(do), _ptr(lse),
            _ptr(delta), _ptr(dk), _ptr(dv), *_bwd_args(q, k))
    build.check(lib, rc, "flash_attn_bwd (dk, dv)")
    build.count_launch(KERNEL_LAUNCHES, "flash_bwd_dkdv")
    return dk, dv, delta


def flash_attention_backward_dq(q, k, v, do, lse, delta):
    """Launch the dq backward kernel; delta comes from the dk/dv launch."""
    _check("flash_attention_backward_dq", q, k, v, do)
    _check_lse(q, lse, "lse")
    _check_lse(q, delta, "delta")
    lib = build.load("flash_attn_bwd")
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        rc = lib.cgic_flash_attn_bwd_dq(
            _ptr(q), _ptr(k), _ptr(v), _ptr(do), _ptr(lse), _ptr(delta),
            _ptr(dq), *_bwd_args(q, k))
    build.check(lib, rc, "flash_attn_bwd (dq)")
    build.count_launch(KERNEL_LAUNCHES, "flash_bwd_dq")
    return dq


def flash_attention_backward(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o: torch.Tensor,
                             lse: torch.Tensor, do: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """Launch the CUDA flash-attention backward: the dk/dv kernel (after
    its delta pre-pass), then the dq kernel. o and do are [B, Tq, C] in q's
    dtype, lse [B, Tq] f32 from flash_attention(..., return_lse=True).
    Returns (dq, dk, dv) in q's dtype."""
    dk, dv, delta = flash_attention_backward_dkdv(q, k, v, o, lse, do)
    return flash_attention_backward_dq(q, k, v, do, lse, delta), dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """Differentiable flash attention on the card (JAX `_flash_diff`): the
    forward kernel with the logsumexp, whose residuals (q, k, v, o, lse) the
    backward kernels read."""

    @staticmethod
    def forward(ctx, q, k, v):
        o, lse = flash_attention(q, k, v, return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        return flash_attention_backward(q, k, v, o, lse, do.contiguous())


class _FlashRecomputeFn(torch.autograd.Function):
    """The forward kernel without the logsumexp, and a backward through
    autograd of attention_reference recomputed from q, k, v (JAX's
    CONTROL_GIC_FLASH_BWD=xla path; it materialises the Tq×Tk scores)."""

    @staticmethod
    def forward(ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        return flash_attention(q, k, v)

    @staticmethod
    def backward(ctx, do):
        leaves = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = attention_reference(*leaves)
        return torch.autograd.grad(out, leaves, do)


def _use_reference_bwd() -> bool:
    return os.environ.get("CONTROL_GIC_FLASH_BWD", "").lower() == "xla"


def _pick_block(t: int, preferred: int) -> int:
    """Largest power-of-two block <= preferred that divides t (>= 256); 0
    when there is none (JAX `_pick_block`)."""
    b = preferred
    while b >= 256:
        if t % b == 0:
            return b
        b //= 2
    return 0


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              use_flash: Optional[bool] = None) -> torch.Tensor:
    """Flash kernels for CUDA tensors with at least FLASH_MIN_TOKENS keys:
    the forward kernel alone at any lengths where no gradient is recorded;
    under grad FlashAttentionFn (the lse forward, then the two backward
    kernels) where JAX's blocks divide both lengths (`_pick_block(Tq, 1024)`
    and `_pick_block(Tk, 512)` both non-zero, its engagement rule). The
    plain path otherwise and inside ops.plain_versions(). use_flash=True
    forces the kernels (and raises on CPU tensors); use_flash=False forces
    the plain path."""
    grad = torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad)
    if use_flash is None:
        on_card = use_kernel(q) and k.shape[1] >= FLASH_MIN_TOKENS
        use_flash = on_card and (not grad or (
            _pick_block(q.shape[1], _BLOCK_Q) > 0
            and _pick_block(k.shape[1], _BLOCK_K) > 0))
        if on_card and not use_flash:
            build.count_launch(PLAIN_CALLS, "attention")
    if not use_flash:
        return attention_reference(q, k, v)
    if grad:
        fn = _FlashRecomputeFn if _use_reference_bwd() else FlashAttentionFn
        return fn.apply(q, k, v)
    return flash_attention(q, k, v)
