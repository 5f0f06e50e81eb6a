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

