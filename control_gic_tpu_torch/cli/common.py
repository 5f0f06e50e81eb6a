"""Shared CLI plumbing: the codec from a config and a checkpoint
(port of control_gic_tpu/cli/common.py)."""
from __future__ import annotations

import os
from typing import Optional, Union

import numpy as np
import torch

from ..codec import CGICCodec
from ..models import CGIC, CGICConfig
from ..utils.device import resolve_device, use_fp32_pipes


def build_codec(ckpt: Optional[str] = None,
                config: Optional[CGICConfig] = None, seed: int = 0,
                device: Union[str, torch.device] = "cuda",
                use_ema: bool = False) -> CGICCodec:
    """A CGICCodec on `device` (CUDA unless asked otherwise; raises when CUDA
    is missing) from a reference `.ckpt`, from the port's training-checkpoint
    directory (the generator's weights, or the EMA shadow with use_ema, and
    the codebook counters), or with random weights drawn from `seed` when no
    checkpoint is given.

    config=None is the flagship config with activations in bfloat16 on CUDA
    and float32 on the CPU; a training checkpoint needs the config it was
    trained with. TF32 is turned off (`use_fp32_pipes`)."""
    dev = resolve_device(device)
    use_fp32_pipes()
    if config is None:
        config = CGICConfig(
            dtype="float32" if dev.type == "cpu" else "bfloat16")
    model = CGIC(config, generator=torch.Generator().manual_seed(seed))
    counts = np.ones(config.n_embed, np.int64)
    if ckpt and os.path.isdir(ckpt):
        from ..utils.checkpoint import load_checkpoint
        saved = load_checkpoint(ckpt)
        model.load_state_dict(saved["ema" if use_ema else "gen"], strict=True)
        counts = saved["codebook_counts"].numpy().astype(np.int64)
    elif ckpt:
        if not (os.path.isfile(ckpt)
                and ckpt.endswith((".ckpt", ".pth", ".pt"))):
            raise FileNotFoundError(f"not a reference checkpoint: {ckpt}")
        from ..utils.from_jax import load_reference_checkpoint
        state, counts = load_reference_checkpoint(ckpt)
        model.load_state_dict(state, strict=True)
    else:
        print("WARNING: no checkpoint given — using random weights "
              "(pipeline demo only; reconstructions will be noise).")
    # counters can be all zero in a fresh checkpoint; keep Huffman valid
    if counts.sum() == 0:
        counts = np.ones_like(counts)
    return CGICCodec(model, counts, device=dev)


def save_png(path: str, img: np.ndarray) -> None:
    """[H, W, 3] float in [0, 1] (clipped, * 255, truncated) or uint8
    already quantized that way (out_uint8 on the device)."""
    from PIL import Image
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = (np.clip(img.astype(np.float32), 0.0, 1.0) * 255).astype(
            np.uint8)
    Image.fromarray(img).save(path)
