"""Weights carried into the port: from the JAX package's flax params, or
from a reference PyTorch checkpoint.

`state_dict_from_flax` is the inverse of
control_gic_tpu/utils/port_torch.py::port_cgic_state_dict: it maps the flax
params tree (numpy leaves) onto the reference state_dict key names that the
port's modules carry, with conv kernels HWIO -> OIHW and norm `scale` ->
`weight`. `lpips_state_dict_from_flax` (the inverse of
`load_lpips_backbone`, plus the lin heads) and `disc_state_dict_from_flax`
(params and BatchNorm `batch_stats`) do the same for the training losses'
modules; the tests use them. `load_reference_checkpoint` reads a reference
`.ckpt` as is.
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


# torchvision `features.<i>` conv index -> the JAX package's flax module name
_LPIPS_CONVS = {
    "alex": {0: "conv0", 3: "conv1", 6: "conv2", 8: "conv3", 10: "conv4"},
    "vgg": {i: f"conv{n}" for n, i in
            enumerate((0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28))},
}
_SQUEEZE_FIRES = (3, 4, 6, 7, 9, 10, 11, 12)


def _conv(prefix: str, leaf: Mapping) -> Dict[str, torch.Tensor]:
    kernel = np.transpose(np.array(leaf["kernel"], np.float32), (3, 2, 0, 1))
    out = {f"{prefix}.weight": torch.from_numpy(np.ascontiguousarray(kernel))}
    if "bias" in leaf:
        out[f"{prefix}.bias"] = torch.from_numpy(
            np.array(leaf["bias"], np.float32))
    return out


def lpips_state_dict_from_flax(params: Mapping, net: str = "alex"
                               ) -> Dict[str, torch.Tensor]:
    """Flax LPIPS params {'net': {...}, 'lin0': [c], ...} -> the port's
    LPIPS state_dict (torchvision `net.<index>` keys, `lin<k>` heads)."""
    net = "vgg" if net == "vgg16" else net
    backbone = params["net"]
    sd: Dict[str, torch.Tensor] = {}
    if net in _LPIPS_CONVS:
        for i, name in _LPIPS_CONVS[net].items():
            sd.update(_conv(f"net.{i}", backbone[name]))
    elif net == "squeeze":
        sd.update(_conv("net.0", backbone["conv0"]))
        for i in _SQUEEZE_FIRES:
            for sub in ("squeeze", "expand1x1", "expand3x3"):
                sd.update(_conv(f"net.{i}.{sub}", backbone[f"fire{i}"][sub]))
    else:
        raise ValueError(f"unknown LPIPS backbone {net!r}")
    for k, v in params.items():
        if k.startswith("lin"):
            sd[k] = torch.from_numpy(np.array(v, np.float32))
    return sd


def disc_state_dict_from_flax(variables: Mapping
                              ) -> Dict[str, torch.Tensor]:
    """Flax NLayerDiscriminator variables {'params': ..., 'batch_stats':
    ...} -> the port's state_dict: convs OIHW, BatchNorm scale/bias as
    weight/bias and its batch_stats mean/var as running_mean/running_var,
    ActNorm loc/scale as they are."""
    sd: Dict[str, torch.Tensor] = {}
    f32 = lambda a: torch.from_numpy(np.array(a, np.float32))
    for name, leaf in variables["params"].items():
        if "kernel" in leaf:
            sd.update(_conv(name, leaf))
        elif "loc" in leaf:                      # ActNorm
            sd[f"{name}.loc"] = f32(leaf["loc"])
            sd[f"{name}.scale"] = f32(leaf["scale"])
        else:                                    # BatchNorm
            sd[f"{name}.weight"] = f32(leaf["scale"])
            sd[f"{name}.bias"] = f32(leaf["bias"])
    for name, stats in variables.get("batch_stats", {}).items():
        sd[f"{name}.running_mean"] = f32(stats["mean"])
        sd[f"{name}.running_var"] = f32(stats["var"])
    return sd
