"""Training checkpoints with torch.save (port of
control_gic_tpu/utils/checkpoint.py, which uses orbax).

A checkpoint directory holds one file per saved step, `step_<08d>.pt`, the
TrainState's state_dict. Each is written to a temporary file in the same
directory and renamed into place, so a crash mid-save leaves no half file
under a checkpoint's name. The codebook counters ride in the state, so the
Huffman frequency table survives a restore.
"""
from __future__ import annotations

import os
import re
from typing import Optional

import torch

_NAME = re.compile(r"step_(\d{8})\.pt")


def checkpoint_path(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step:08d}.pt")


def save_checkpoint(directory: str, step: int, state) -> str:
    """Write `state.state_dict()` as the checkpoint of `step`; returns its
    path."""
    os.makedirs(directory, exist_ok=True)
    path = checkpoint_path(directory, step)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(state.state_dict(), tmp)
    os.replace(tmp, path)
    return path


def latest_step(directory: str) -> Optional[int]:
    """The highest saved step in `directory`, or None."""
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for m in map(_NAME.fullmatch,
                                          os.listdir(directory)) if m]
    return max(steps) if steps else None


def load_checkpoint(directory: str, step: Optional[int] = None,
                    map_location="cpu") -> dict:
    """The state_dict saved at `step` (the latest when None)."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    return torch.load(checkpoint_path(directory, step),
                      map_location=map_location, weights_only=True)


def restore_checkpoint(directory: str, state, step: Optional[int] = None):
    """Load the checkpoint of `step` (the latest when None) into `state`, on
    the state's device; returns the state."""
    state.load_state_dict(load_checkpoint(directory, step,
                                          map_location=state.device))
    return state
