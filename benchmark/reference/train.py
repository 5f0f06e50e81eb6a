"""The plain reference of Control-GIC's training step, in float32.

The recipe of the reference code (configs/config_train.yaml): one batch
updates the generator with MSE + LPIPS + 0.1 * (-mean D(x_rec)) + the VQ
codebook loss, the PatchGAN discriminator (eval mode, its pre-update
weights) giving the adversarial term, then the discriminator with the
hinge loss on D(x) and D(sg(x_rec)) in train mode (its BatchNorm's running
statistics move twice, real then fake, by running = 0.9 running + 0.1
batch with the biased variance). Each gradient is clipped by value at 1.0,
then Adam (lr 5e-5, betas 0.5 / 0.9, eps 1e-8) steps, written out here.
The discriminator's loss counts from the first step (disc_start 0); the
adaptive weight is off.

LPIPS is VGG16's features (taps relu1_2 ... relu5_3) with the v0.1 linear
heads (vgg_lin.npz, a copy of the published heads), frozen; it is called
with normalize=True on [-1, 1] images, as the reference code does. The
router takes its thresholds over the whole batch.

Parameters are flat dicts named as the models' state_dicts. Batches are
NCHW float32 in [-1, 1].
"""
from __future__ import annotations

import os
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import model as M

LR, B1, B2, ADAM_EPS, CLIP = 5e-5, 0.5, 0.9, 1e-8, 1.0
BETA = 0.25                 # VQ commitment
G_WEIGHT = 0.1
BN_MOMENTUM, BN_EPS = 0.9, 1e-5
VGG_BLOCKS = ((64, 64), (128, 128), (256, 256, 256), (512, 512, 512),
              (512, 512, 512))
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


# ------------------------------------------------------------ parameters

def disc_shapes(ndf: int = 64) -> Dict[str, Tuple[int, ...]]:
    """The PatchGAN discriminator of the recipe (ndf 64, 2 inner layers):
    conv0 3->64 k4 s2 (bias), conv1 64->128 k4 s2 and conv2 128->256 k4 s1
    (no bias, BatchNorm after each), conv_out 256->1 k4 s1 (bias)."""
    return {"conv0.weight": (ndf, 3, 4, 4), "conv0.bias": (ndf,),
            "conv1.weight": (2 * ndf, ndf, 4, 4),
            "bn1.weight": (2 * ndf,), "bn1.bias": (2 * ndf,),
            "bn1.running_mean": (2 * ndf,), "bn1.running_var": (2 * ndf,),
            "conv2.weight": (4 * ndf, 2 * ndf, 4, 4),
            "bn2.weight": (4 * ndf,), "bn2.bias": (4 * ndf,),
            "bn2.running_mean": (4 * ndf,), "bn2.running_var": (4 * ndf,),
            "conv_out.weight": (1, 4 * ndf, 4, 4), "conv_out.bias": (1,)}


def vgg_layers() -> List[Tuple[int, int, int, bool]]:
    """(index in torchvision's vgg16.features, cin, cout, tap after it) of
    each 3x3 conv; a 2x2 max pool sits before blocks 2-5."""
    out, idx, cin = [], 0, 3
    for b, block in enumerate(VGG_BLOCKS):
        if b:
            idx += 1                       # the pool
        for j, c in enumerate(block):
            out.append((idx, cin, c, j == len(block) - 1))
            idx += 2                       # conv, relu
            cin = c
    return out


def lpips_shapes() -> Dict[str, Tuple[int, ...]]:
    shapes = {}
    for idx, cin, cout, _ in vgg_layers():
        shapes[f"net.{idx}.weight"] = (cout, cin, 3, 3)
        shapes[f"net.{idx}.bias"] = (cout,)
    for k, block in enumerate(VGG_BLOCKS):
        shapes[f"lin{k}"] = (block[-1],)
    return shapes


def lpips_heads() -> Dict[str, torch.Tensor]:
    """The published v0.1 VGG linear heads."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "vgg_lin.npz")
    with np.load(path) as z:
        return {k: torch.from_numpy(np.array(z[k], np.float32))
                for k in z.files}


# ------------------------------------------------------------- networks

def lpips(a: torch.Tensor, b: torch.Tensor, p) -> torch.Tensor:
    """LPIPS distance per image [B] (normalize=True)."""
    shift = torch.tensor(_SHIFT, device=a.device)[None, :, None, None]
    scale = torch.tensor(_SCALE, device=a.device)[None, :, None, None]
    xs = [((2.0 * t - 1.0).float() - shift) / scale for t in (a, b)]
    total = 0.0
    layers = vgg_layers()
    k = 0
    for n, (idx, _, _, tap) in enumerate(layers):
        if n and layers[n - 1][3]:
            xs = [F.max_pool2d(x, 2, 2) for x in xs]
        xs = [torch.relu(M.conv(x, p, f"net.{idx}")) for x in xs]
        if tap:
            na, nb = (x / (torch.sqrt(torch.sum(x * x, 1, keepdim=True))
                           + 1e-10) for x in xs)
            total = total + ((na - nb) ** 2 * p[f"lin{k}"][None, :, None,
                                                           None]
                             ).sum(1).mean((1, 2))
            k += 1
    return total


def batch_norm(x, p, name, train: bool):
    """flax BatchNorm over NCHW channels; in train mode the batch's mean
    and biased variance, and the running statistics move in place."""
    if train:
        mean = x.mean((0, 2, 3))
        var = torch.clamp((x * x).mean((0, 2, 3)) - mean * mean, min=0.0)
        with torch.no_grad():
            for key, v in (("running_mean", mean), ("running_var", var)):
                r = p[f"{name}.{key}"]
                r.copy_(BN_MOMENTUM * r + (1 - BN_MOMENTUM) * v.detach())
    else:
        mean, var = p[f"{name}.running_mean"], p[f"{name}.running_var"]
    col = lambda t: t[None, :, None, None]
    return ((x - col(mean)) * col(torch.rsqrt(var + BN_EPS)
                                  * p[f"{name}.weight"])
            + col(p[f"{name}.bias"]))


def disc(x, p, train: bool):
    def cv(h, name, stride):
        return F.conv2d(h, p[f"{name}.weight"], p.get(f"{name}.bias"), stride,
                        1)

    h = F.leaky_relu(cv(x.float(), "conv0", 2), 0.2)
    h = F.leaky_relu(batch_norm(cv(h, "conv1", 2), p, "bn1", train), 0.2)
    h = F.leaky_relu(batch_norm(cv(h, "conv2", 1), p, "bn2", train), 0.2)
    return cv(h, "conv_out", 1)


def generator(x, p, cfg, ratios):
    """(reconstruction, VQ loss, VQ indices) with the straight-through
    estimator."""
    masks = M.route(x, *ratios, per_sample=False)
    z_fine, z_medium, z_coarse = M.encode_taps(x, p, cfg)
    m_c, m_m, m_f = (m.float()[:, None] for m in masks)
    h = (M.up(z_coarse, 4) * M.up(m_c, 4) + M.up(z_medium, 2) * M.up(m_m, 2)
         + z_fine * m_f)
    z = M.conv(h, p, "quant_conv")
    cb = p["quantize.embedding.weight"]
    ind = torch.argmin(M.vq_distances(z.detach(), cb.detach()), dim=1)
    b, d, hl, wl = z.shape
    zq = cb[ind].reshape(b, hl, wl, d).permute(0, 3, 1, 2)
    vq_loss = (torch.mean((zq.detach() - z) ** 2)
               + BETA * torch.mean((zq - z.detach()) ** 2))
    zq_st = z + (zq - z).detach()
    return M.decode_latent(zq_st, masks, p, cfg), vq_loss, ind


# ------------------------------------------------------------ the step

class State:
    """Generator and discriminator parameters (trained leaves require
    grad; the BatchNorm running statistics do not), LPIPS, Adam's moments
    and its step count."""

    def __init__(self, gen: dict, dis: dict, lp: dict):
        self.gen = {k: v.detach().clone().float().requires_grad_(True)
                    for k, v in gen.items()}
        self.dis = {k: v.detach().clone().float().requires_grad_(
            "running" not in k) for k, v in dis.items()}
        self.lp = {k: v.detach().float() for k, v in lp.items()}
        self.m = {k: torch.zeros_like(v) for k, v in self.trained()}
        self.v = {k: torch.zeros_like(v) for k, v in self.trained()}
        self.t = 0

    @classmethod
    def resume(cls, snap: dict, lp: dict) -> "State":
        """The state after a step, from `judge.snapshot` (on the host),
        on the device of `lp`."""
        dev = next(iter(lp.values())).device
        to = lambda d: {k: v.to(dev) for k, v in d.items()}
        state = cls(to(snap["gen"]), to(snap["disc"]), lp)
        for k in state.m:
            state.m[k].copy_(snap["m"][k])
            state.v[k].copy_(snap["v"][k])
        state.t = snap["t"]
        return state

    def trained(self):
        yield from (("gen." + k, v) for k, v in self.gen.items())
        yield from (("disc." + k, v) for k, v in self.dis.items()
                    if v.requires_grad)


@torch.no_grad()
def adam(state: State, grads: Dict[str, torch.Tensor], names) -> None:
    """Clip each gradient to +-1, then Adam on the named leaves."""
    t = state.t
    for name, p in names:
        g = grads[name].clamp(-CLIP, CLIP)
        m, v = state.m[name], state.v[name]
        m.mul_(B1).add_((1 - B1) * g)
        v.mul_(B2).add_((1 - B2) * g * g)
        mhat = m / (1 - B1 ** t)
        vhat = v / (1 - B2 ** t)
        p.sub_(LR * mhat / (torch.sqrt(vhat) + ADAM_EPS))


def train_step(state: State, x: torch.Tensor, cfg: dict, ratios
               ) -> Dict[str, float]:
    """One step of the recipe on the batch x (NCHW, [-1, 1]); returns the
    generator's total loss ('aeloss'), the discriminator's ('discloss'),
    the generator's terms and the VQ index histogram ('counts')."""
    state.t += 1
    gen_names = [(k, v) for k, v in state.trained() if k.startswith("gen.")]
    dis_names = [(k, v) for k, v in state.trained() if k.startswith("disc.")]
    rec, vq_loss, ind = generator(x, state.gen, cfg, ratios)
    p_loss = torch.mean(lpips(rec, x, state.lp))
    logits_fake = disc(rec, state.dis, train=False)
    nll = torch.mean((x - rec) ** 2) + p_loss
    g_loss = -torch.mean(logits_fake)
    ae_loss = nll + G_WEIGHT * g_loss + vq_loss
    grads = torch.autograd.grad(ae_loss, [v for _, v in gen_names],
                                allow_unused=True)
    adam(state, {k: torch.zeros_like(v) if g is None else g
                 for (k, v), g in zip(gen_names, grads)}, gen_names)

    rec_sg = rec.detach()
    real = disc(x, state.dis, train=True)
    fake = disc(rec_sg, state.dis, train=True)
    d_loss = 0.5 * (torch.mean(F.relu(1.0 - real))
                    + torch.mean(F.relu(1.0 + fake)))
    d_grads = torch.autograd.grad(d_loss, [v for _, v in dis_names],
                                  allow_unused=True)
    adam(state, {k: torch.zeros_like(v) if g is None else g
                 for (k, v), g in zip(dis_names, d_grads)}, dis_names)
    return {"aeloss": ae_loss.item(), "discloss": d_loss.item(),
            "rec_loss": torch.mean((x - rec) ** 2).item(),
            "p_loss": p_loss.item(), "g_loss": g_loss.item(),
            "quant_loss": vq_loss.item(),
            "counts": torch.bincount(ind.flatten(), minlength=state.gen[
                "quantize.embedding.weight"].shape[0]).cpu()}
