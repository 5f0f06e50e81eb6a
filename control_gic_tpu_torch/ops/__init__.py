"""Numerics on tensors; see each module for its JAX counterpart.

`plain_versions()` makes the dispatches of the kernel-backed ops (attention,
the chained norm+conv and the GroupNorm moments) take their plain PyTorch
versions even for CUDA tensors, so that a comparison can run the same model
twice on the card. Nothing on the main path enters it, and no failure falls
into it.
"""
from __future__ import annotations

import contextlib
import contextvars

_PLAIN = contextvars.ContextVar("control_gic_tpu_torch_plain_versions",
                                default=False)


@contextlib.contextmanager
def plain_versions():
    """Inside this context the dispatches run the plain versions."""
    token = _PLAIN.set(True)
    try:
        yield
    finally:
        _PLAIN.reset(token)


def use_kernel(t) -> bool:
    """Whether a dispatch launches its CUDA kernel for tensor `t`: a CUDA
    tensor outside plain_versions(). CPU tensors take the plain versions."""
    return t.is_cuda and not _PLAIN.get()
