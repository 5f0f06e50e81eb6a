"""Single-head full self-attention over flattened spatial tokens.

Port of control_gic_tpu/ops/attention.py (forward only): scale C^-0.5,
softmax over keys, no mask, one head. Inputs are [B, T, C] float32 or
bfloat16; the output has q's dtype. Tq may differ from Tk.

Three functions compute it:
  - `attention_reference`: the plain einsum path (JAX `attention_xla`);
  - `flash_attention_blocked_reference`: a torch replay of the flash kernel's
    online softmax over key blocks, for the CPU tests (the analog of Pallas
    `interpret=True`);
  - `flash_attention`: the CUDA kernel (kernels/flash_attn_fwd.cu), for CUDA
    tensors only.

`attention` dispatches between the kernel and the plain path the way the JAX
package does: the kernel from FLASH_MIN_TOKENS keys on, the plain path below.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

# The JAX package's engagement threshold, tuned on a TPU and kept as it is;
# it has not been re-derived on the H100.
FLASH_MIN_TOKENS = 4096

# Launches of the CUDA kernel in this process (flash_attention adds one per
# launch). A caller resets it to 0 and reads it back to see that a run went
# through the kernel.
KERNEL_LAUNCHES = 0

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
                                      block_k: int = 64) -> torch.Tensor:
    """The kernel's arithmetic replayed block by block: per query block a
    running max, denominator and f32 accumulator, rescaled by
    exp(m_prev - m_new) at each key block, p cast to v's dtype before PV.
    Blocks need not divide the lengths."""
    b, tq, c = q.shape
    tk = k.shape[1]
    scale = float(c) ** -0.5
    out = torch.empty_like(q)
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
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA flash-attention forward. CUDA tensors only: anything
    the kernel does not take raises, and a failed build or launch raises."""
    global KERNEL_LAUNCHES
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("flash_attention launches a CUDA kernel and takes "
                         "CUDA tensors only; use attention() or "
                         "attention_reference() for CPU tensors")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODE:
        raise TypeError(f"flash_attention takes float32 or bfloat16 q, k, v "
                        f"of one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 3 or k.shape != v.shape or k.dim() != 3 \
            or q.shape[0] != k.shape[0] or q.shape[2] != k.shape[2]:
        raise ValueError(f"expected q [B,Tq,C] and k, v [B,Tk,C], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, tq, c = q.shape
    tk = k.shape[1]
    if c % 16 or c > _MAX_C:
        raise ValueError(f"head dim {c} must be a multiple of 16, at most "
                         f"{_MAX_C}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention needs contiguous q, k, v")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention needs 16-byte aligned q, k, v")
    from ..kernels import build
    lib = build.load("flash_attn_fwd")
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.cgic_flash_attn_fwd(
            ctypes.c_void_p(q.data_ptr()), ctypes.c_void_p(k.data_ptr()),
            ctypes.c_void_p(v.data_ptr()), ctypes.c_void_p(out.data_ptr()),
            ctypes.c_int(b), ctypes.c_int(tq), ctypes.c_int(tk),
            ctypes.c_int(c), ctypes.c_int(_DTYPE_CODE[q.dtype]),
            ctypes.c_float(float(c) ** -0.5), ctypes.c_void_p(stream))
    if rc != 0:
        lib.cgic_cuda_error_string.restype = ctypes.c_char_p
        why = (lib.cgic_cuda_error_string(rc).decode() if rc > 0
               else "arguments refused")
        raise RuntimeError(f"flash_attn_fwd launch failed ({rc}): {why}")
    KERNEL_LAUNCHES += 1
    return out


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              use_flash: Optional[bool] = None) -> torch.Tensor:
    """Flash kernel for CUDA tensors with at least FLASH_MIN_TOKENS keys, the
    plain path otherwise. use_flash=True forces the kernel (and raises on CPU
    tensors); use_flash=False forces the plain path."""
    if use_flash is None:
        use_flash = q.is_cuda and k.shape[1] >= FLASH_MIN_TOKENS
    if use_flash:
        return flash_attention(q, k, v)
    return attention_reference(q, k, v)
