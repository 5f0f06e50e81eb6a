"""Single-head full self-attention over flattened spatial tokens, and its
gradient.

Port of control_gic_tpu/ops/attention.py: scale C^-0.5, softmax over keys,
no mask, one head. Inputs are [B, T, C] float32 or bfloat16; the output has
q's dtype. Tq may differ from Tk.

The forward:
  - `attention_reference`: the plain einsum path (JAX `attention_xla`);
  - `flash_attention_blocked_reference`: a torch replay of the flash kernel's
    online softmax over key blocks, optionally with the per-row logsumexp,
    for the CPU tests (the analog of Pallas `interpret=True`);
  - `flash_attention`: the CUDA kernel (kernels/flash_attn_fwd.cu), with the
    logsumexp when `return_lse` (JAX `attention_flash_with_lse`), for CUDA
    tensors only.
The backward (FlashAttention-2, JAX `_flash_backward`):
  - `flash_attention_backward_blocked_reference`: a torch replay of the two
    backward kernels' loops;
  - `flash_attention_backward`: the CUDA kernels (kernels/flash_attn_bwd.cu).
`FlashAttentionFn` (JAX `_flash_diff`) puts the lse forward and the two
backward kernels in one autograd.Function.

`attention` dispatches the way the JAX package does: the kernels from
FLASH_MIN_TOKENS keys on, where JAX's blocks divide both lengths, the plain
path otherwise. Under grad it takes FlashAttentionFn, or with
CONTROL_GIC_FLASH_BWD=xla the forward kernel and a backward through autograd
of `attention_reference` (JAX's einsum-recompute switch). Nothing selects
that switch on a failure.
"""
from __future__ import annotations

import ctypes
import os
from typing import Optional, Tuple

import torch

from . import use_kernel

# The JAX package's engagement rule, tuned on a TPU and kept as it is so that
# the port engages where JAX does; it has not been re-derived on the H100.
FLASH_MIN_TOKENS = 4096
_BLOCK_Q = 1024
_BLOCK_K = 512

# Launches of the CUDA kernels in this process, by kernel: the forward
# without and with the logsumexp, the dk/dv backward (with its delta
# pre-pass) and the dq backward. A wrapper adds one where it launches its
# kernel; a caller resets them to 0 and reads them back to see that a run
# went through the kernels.
KERNEL_LAUNCHES = {"flash_fwd": 0, "flash_fwd_lse": 0, "flash_bwd_dkdv": 0,
                   "flash_bwd_dq": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_C = 512


def _scale(c: int) -> torch.Tensor:
    # jnp.asarray(c, float32) ** -0.5 in the JAX path: a float32 power
    return torch.tensor(float(c), dtype=torch.float32) ** -0.5


def attention_reference(q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor) -> torch.Tensor:
    """softmax(q kᵀ · C^-0.5) v with both products accumulated in f32 and the
    weights cast to q's dtype before the second (JAX `attention_xla`)."""
    scale = _scale(q.shape[-1]).to(q.device)
    logits = torch.matmul(q.float(), k.float().transpose(1, 2)) * scale
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.matmul(w.float(), v.float()).to(q.dtype)


def flash_attention_blocked_reference(q: torch.Tensor, k: torch.Tensor,
                                      v: torch.Tensor, block_q: int = 32,
                                      block_k: int = 64,
                                      return_lse: bool = False):
    """The kernel's arithmetic replayed block by block: per query block a
    running max, denominator and f32 accumulator, rescaled by
    exp(m_prev - m_new) at each key block, p cast to v's dtype before PV.
    Blocks need not divide the lengths. With return_lse, also the per-row
    logsumexp m + log l of the scaled logits, [B, Tq] f32."""
    b, tq, c = q.shape
    tk = k.shape[1]
    scale = float(c) ** -0.5
    out = torch.empty_like(q)
    lse = torch.empty(b, tq, dtype=torch.float32, device=q.device)
    for q0 in range(0, tq, block_q):
        qb = q[:, q0:q0 + block_q].float()
        rows = qb.shape[1]
        m = torch.full((b, rows, 1), float("-inf"), device=q.device)
        l = torch.zeros((b, rows, 1), device=q.device)
        acc = torch.zeros((b, rows, c), device=q.device)
        for k0 in range(0, tk, block_k):
            kb = k[:, k0:k0 + block_k].float()
            vb = v[:, k0:k0 + block_k]
            s = torch.matmul(qb, kb.transpose(1, 2)) * scale
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            p = torch.exp(s - m_new)
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1, keepdim=True)
            acc = acc * corr + torch.matmul(p.to(v.dtype).float(), vb.float())
            m = m_new
        out[:, q0:q0 + block_q] = (acc / l).to(q.dtype)
        lse[:, q0:q0 + block_q] = (m + torch.log(l))[..., 0]
    return (out, lse) if return_lse else out


def flash_attention_backward_blocked_reference(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
        lse: torch.Tensor, do: torch.Tensor, block_q: int = 32,
        block_k: int = 16) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernels' arithmetic replayed block by block (JAX
    `_flash_backward`): delta = rowsum(do∘o) once in f32; per key block a
    walk over the query blocks for dk and dv, per query block a walk over
    the key blocks for dq. p = exp(s·scale − lse) in f32, rounded to the
    operand dtype before pᵀ do; ds = p∘(do vᵀ − delta), rounded before dsᵀ q
    and ds k; each block product of dk and dq is scaled once. lse is
    [B, Tq] f32. Blocks need not divide the lengths."""
    tq, c = q.shape[1], q.shape[2]
    tk = k.shape[1]
    scale = float(c) ** -0.5
    dt = q.dtype
    f = lambda t: t.float()
    delta = (f(do) * f(o)).sum(dim=-1, keepdim=True)          # [B, Tq, 1]
    lse = lse.float()[..., None]

    def block(q0, k0):
        qb, dob = f(q[:, q0:q0 + block_q]), f(do[:, q0:q0 + block_q])
        kb, vb = f(k[:, k0:k0 + block_k]), f(v[:, k0:k0 + block_k])
        s = torch.matmul(qb, kb.transpose(1, 2)) * scale
        p = torch.exp(s - lse[:, q0:q0 + block_q])
        dp = torch.matmul(dob, vb.transpose(1, 2))
        ds = p * (dp - delta[:, q0:q0 + block_q])
        return qb, dob, kb, p, ds

    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    for k0 in range(0, tk, block_k):
        rows = k[:, k0:k0 + block_k].shape[1]
        dk_acc = torch.zeros(k.shape[0], rows, c, device=q.device)
        dv_acc = torch.zeros_like(dk_acc)
        for q0 in range(0, tq, block_q):
            qb, dob, _, p, ds = block(q0, k0)
            dv_acc = dv_acc + torch.matmul(f(p.to(dt)).transpose(1, 2), dob)
            dk_acc = dk_acc + torch.matmul(f(ds.to(dt)).transpose(1, 2),
                                           qb) * scale
        dk[:, k0:k0 + block_k] = dk_acc.to(dt)
        dv[:, k0:k0 + block_k] = dv_acc.to(dt)
    dq = torch.empty_like(q)
    for q0 in range(0, tq, block_q):
        rows = q[:, q0:q0 + block_q].shape[1]
        dq_acc = torch.zeros(q.shape[0], rows, c, device=q.device)
        for k0 in range(0, tk, block_k):
            _, _, kb, _, ds = block(q0, k0)
            dq_acc = dq_acc + torch.matmul(f(ds.to(dt)), kb) * scale
        dq[:, q0:q0 + block_q] = dq_acc.to(dt)
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
    launch raises. Returns out, or (out, lse)."""
    _check("flash_attention", q, k, v)
    b, tq, c = q.shape
    from ..kernels import build
    lib = build.load("flash_attn_fwd")
    out = torch.empty_like(q)
    lse = (torch.empty(b, tq, dtype=torch.float32, device=q.device)
           if return_lse else None)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.cgic_flash_attn_fwd(
            _ptr(q), _ptr(k), _ptr(v), _ptr(out), _ptr(lse),
            ctypes.c_int(b), ctypes.c_int(tq), ctypes.c_int(k.shape[1]),
            ctypes.c_int(c), ctypes.c_int(_DTYPE_CODE[q.dtype]),
            ctypes.c_float(float(c) ** -0.5), ctypes.c_void_p(stream))
    build.check(lib, rc, "flash_attn_fwd")
    KERNEL_LAUNCHES["flash_fwd_lse" if return_lse else "flash_fwd"] += 1
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
    from ..kernels import build
    lib = build.load("flash_attn_bwd")
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        rc = lib.cgic_flash_attn_bwd_dkdv(
            _ptr(q), _ptr(k), _ptr(v), _ptr(o), _ptr(do), _ptr(lse),
            _ptr(delta), _ptr(dk), _ptr(dv), *_bwd_args(q, k))
    build.check(lib, rc, "flash_attn_bwd (dk, dv)")
    KERNEL_LAUNCHES["flash_bwd_dkdv"] += 1
    return dk, dv, delta


def flash_attention_backward_dq(q, k, v, do, lse, delta):
    """Launch the dq backward kernel; delta comes from the dk/dv launch."""
    _check("flash_attention_backward_dq", q, k, v, do)
    _check_lse(q, lse, "lse")
    _check_lse(q, delta, "delta")
    from ..kernels import build
    lib = build.load("flash_attn_bwd")
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        rc = lib.cgic_flash_attn_bwd_dq(
            _ptr(q), _ptr(k), _ptr(v), _ptr(do), _ptr(lse), _ptr(delta),
            _ptr(dq), *_bwd_args(q, k))
    build.check(lib, rc, "flash_attn_bwd (dq)")
    KERNEL_LAUNCHES["flash_bwd_dq"] += 1
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
    """Flash kernels for CUDA tensors with at least FLASH_MIN_TOKENS keys and
    lengths that JAX's blocks divide (`_pick_block(Tq, 1024)` and
    `_pick_block(Tk, 512)` both non-zero, its engagement rule); the plain
    path otherwise and inside ops.plain_versions(). use_flash=True forces
    the kernels (and raises on CPU tensors); use_flash=False forces the plain
    path. Where a gradient is needed the kernels run as FlashAttentionFn
    (the lse forward, then the two backward kernels); elsewhere the forward
    kernel runs alone."""
    if use_flash is None:
        use_flash = (use_kernel(q) and k.shape[1] >= FLASH_MIN_TOKENS
                     and _pick_block(q.shape[1], _BLOCK_Q) > 0
                     and _pick_block(k.shape[1], _BLOCK_K) > 0)
    if not use_flash:
        return attention_reference(q, k, v)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        fn = _FlashRecomputeFn if _use_reference_bwd() else FlashAttentionFn
        return fn.apply(q, k, v)
    return flash_attention(q, k, v)
