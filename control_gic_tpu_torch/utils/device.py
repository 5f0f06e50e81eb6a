"""Device selection for the port's entry points: CUDA unless the caller asks
for the CPU, and never a quiet move to the CPU."""
from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    """torch.device for `device`; raises when a CUDA device is asked for and
    CUDA is not available."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but CUDA is not available; "
            "pass device='cpu' to run on the CPU")
    return dev


def use_fp32_pipes() -> None:
    """Turn TF32 off for float32 matrix products and cuDNN convolutions, so
    that float32 on the card means float32 arithmetic (the FP32 pipes), as
    in the JAX package and the training recipe. PyTorch's default runs f32
    convolutions in TF32, which keeps about three decimal digits. The flags
    touch only float32 work: bf16 paths compute the same as before."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
