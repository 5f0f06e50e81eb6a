"""Weights carried into the port: from the JAX package's flax params, or
from a reference PyTorch checkpoint.

`state_dict_from_flax` is the inverse of
control_gic_tpu/utils/port_torch.py::port_cgic_state_dict: it maps the flax
params tree (numpy leaves) onto the reference state_dict key names that the
port's modules carry, with conv kernels HWIO -> OIHW and norm `scale` ->
`weight`. `load_reference_checkpoint` reads a reference `.ckpt` as is.
"""
from __future__ import annotations

import re
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

_HEADS = {"head_fine": ("mid_fine", "_fine"), "head_medium": ("mid", ""),
          "head_coarse": ("mid_coarse", "_coarse")}
_MODEL_PREFIXES = ("encoder.", "decoder.", "quant_conv.", "post_quant_conv.",
                   "quantize.embedding.")


def _leaves(tree: Mapping, prefix: Tuple[str, ...] = ()):
    for name, sub in tree.items():
        if isinstance(sub, Mapping):
            yield from _leaves(sub, prefix + (name,))
        else:
            yield prefix + (name,), sub


def _segments(path: Tuple[str, ...]) -> list:
    """Flax module path (without the leaf) -> reference key segments."""
    out = []
    for seg in path:
        if seg in ("group", "spatial"):          # flax-only wrappers
            continue
        m = re.fullmatch(r"(down|up)_(\d+)_(block|attn)_(\d+)", seg)
        if m:
            out += [m.group(1), m.group(2), m.group(3), m.group(4)]
            continue
        m = re.fullmatch(r"(down|up)_(\d+)_(downsample|upsample)", seg)
        if m:
            out += [m.group(1), m.group(2), m.group(3)]
            continue
        out.append(seg)
    # encoder heads: head_x/{block_1,attn_1,block_2} -> mid_x.*, and
    # head_x/{norm_out,conv_out} -> {norm_out,conv_out}<suffix>
    if len(out) >= 3 and out[0] == "encoder" and out[1] in _HEADS:
        mid, suffix = _HEADS[out[1]]
        if out[2] in ("norm_out", "conv_out"):
            out = ["encoder", out[2] + suffix] + out[3:]
        else:
            out = ["encoder", mid] + out[2:]
    # GroupNorm32 keeps its scale/bias one level down, under "norm"
    if len(out) >= 2 and out[-1] == "norm" and re.fullmatch(
            r"norm(1|2|_out\w*)?", out[-2]):
        out = out[:-1]
    return out


def state_dict_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """Flax CGIC params (numpy or array leaves) -> the port's state_dict."""
    sd: Dict[str, torch.Tensor] = {}
    for path, leaf in _leaves(params):
        val = np.array(leaf, np.float32)    # a writable copy
        if path == ("codebook",):
            key = "quantize.embedding.weight"
        else:
            leaf_name = path[-1]
            if leaf_name == "kernel":
                val = np.transpose(val, (3, 2, 0, 1))   # HWIO -> OIHW
            name = {"kernel": "weight", "scale": "weight"}.get(leaf_name,
                                                               leaf_name)
            key = ".".join(_segments(path[:-1]) + [name])
        sd[key] = torch.from_numpy(np.ascontiguousarray(val))
    return sd


def load_reference_checkpoint(path: str
                              ) -> Tuple[Dict[str, torch.Tensor], np.ndarray]:
    """A reference `.ckpt` -> (the model's state_dict entries in f32, the
    codebook usage counts from quantize.embedding_counter.{i}). Loss, EMA
    and discriminator entries are dropped. The file is unpickled: load only
    checkpoints you trust."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("state_dict", ckpt) if isinstance(ckpt, dict) else ckpt
    model_sd = {k: v.detach().float() for k, v in sd.items()
                if k.startswith(_MODEL_PREFIXES) and torch.is_tensor(v)}
    n_embed = model_sd["quantize.embedding.weight"].shape[0]
    counts = np.zeros(n_embed, np.int64)
    for k, v in sd.items():
        m = re.fullmatch(r"quantize\.embedding_counter\.(\d+)", k)
        if m:
            counts[int(m.group(1))] = int(float(v.reshape(-1)[0]))
    return model_sd, counts
