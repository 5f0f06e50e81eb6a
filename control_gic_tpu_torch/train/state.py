"""Train state: the generator, the discriminator with its running stats, the
frozen LPIPS, two optimizers, the EMA shadow of the generator's parameters,
and the codebook-usage counters that feed the Huffman table (port of
control_gic_tpu/train/state.py).

The reference recipe: two Adam(lr 5e-5, betas (0.5, 0.9)) optimizers stepped
once each per batch, gradients clipped by value at 1.0 first, EMA decay
0.9999 with the (1+n)/(10+n) warm-up (LitEma). optax's
chain(clip(1.0), adam(lr, b1, b2)) is `clip_grad_value_` then
`torch.optim.Adam(eps=1e-8)`: both add eps to the square root of the
bias-corrected second moment. On CUDA the optimizers are
`capturable=True` (their step counts live on the device), so that a step
can run as a CUDA graph; the CPU keeps the host-side step count.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Union

import numpy as np
import torch
from torch import nn

from ..models.cgic import CGIC, CGICConfig
from ..models.discriminator import NLayerDiscriminator
from ..models.lpips import LPIPS, with_bundled_lin_heads
from ..utils.device import resolve_device, use_fp32_pipes
from .losses import LossConfig


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 5e-5
    b1: float = 0.5
    b2: float = 0.9
    grad_clip_value: float = 1.0
    ema_decay: float = 0.9999
    coarse_ratio: float = 0.1
    medium_ratio: float = 0.4
    loss: LossConfig = LossConfig()


def make_optimizer(params: Iterable[nn.Parameter], cfg: TrainConfig,
                   capturable: bool = False) -> torch.optim.Adam:
    """Adam(lr, (b1, b2), eps 1e-8); `apply_gradients` clips before it.
    capturable=True (CUDA parameters only) keeps the step count on the
    device, so that the step can be captured."""
    return torch.optim.Adam(list(params), lr=cfg.learning_rate,
                            betas=(cfg.b1, cfg.b2), eps=1e-8,
                            capturable=capturable)


def apply_gradients(opt: torch.optim.Optimizer,
                    params: Sequence[nn.Parameter],
                    grads: Sequence[Optional[torch.Tensor]],
                    cfg: TrainConfig) -> None:
    """One optimizer step from explicit gradients: a parameter without one
    gets zeros (as jax.grad gives), every gradient is clipped to
    ±grad_clip_value, then Adam steps."""
    for p, g in zip(params, grads):
        p.grad = torch.zeros_like(p) if g is None else g.detach()
    nn.utils.clip_grad_value_(params, cfg.grad_clip_value)
    opt.step()
    for p in params:
        p.grad = None


def ema_weight(num_updates: int, decay: float) -> float:
    """LitEma's 1 − d, with d = min(decay, (1+n)/(10+n)), computed on the
    host in float32 (the result is exact in f32)."""
    n = np.float32(num_updates)
    d = min(np.float32(decay), (np.float32(1) + n) / (np.float32(10) + n))
    return float(np.float32(1) - d)


@torch.no_grad()
def ema_apply(shadows: List[torch.Tensor], params: List[torch.Tensor],
              weight) -> None:
    """shadow -= weight·(shadow − param), in place, for each pair; weight is
    ema_weight's value as a float or as a 0-d f32 tensor on the device (a
    captured step's input), which give the same f32 products."""
    diffs = torch._foreach_sub(shadows, [p.to(s.dtype) for s, p in
                                         zip(shadows, params)])
    torch._foreach_mul_(diffs, weight)
    torch._foreach_sub_(shadows, diffs)


def ema_update(ema: Dict[str, torch.Tensor], named_params, num_updates: int,
               decay: float) -> int:
    """LitEma: shadow -= (1 − d)·(shadow − param) with
    d = min(decay, (1+n)/(10+n)) in float32. Returns num_updates + 1."""
    names, params = zip(*named_params)
    ema_apply([ema[n] for n in names], list(params),
              ema_weight(num_updates, decay))
    return num_updates + 1


class TrainState:
    """Everything a training run carries from step to step. `state_dict()`
    and `load_state_dict()` hold all of it, for checkpoints."""

    def __init__(self, gen: CGIC, disc: NLayerDiscriminator, lpips: LPIPS,
                 opt_gen: torch.optim.Optimizer,
                 opt_disc: torch.optim.Optimizer,
                 ema: Dict[str, torch.Tensor], step: int = 0,
                 ema_num_updates: int = 0,
                 codebook_counts: Optional[torch.Tensor] = None):
        self.gen, self.disc, self.lpips = gen, disc, lpips
        self.opt_gen, self.opt_disc = opt_gen, opt_disc
        self.ema = ema
        self.step = step
        self.ema_num_updates = ema_num_updates
        self.codebook_counts = (codebook_counts if codebook_counts is not None
                                else torch.zeros(gen.config.n_embed,
                                                 dtype=torch.int64,
                                                 device=self.device))

    @property
    def device(self) -> torch.device:
        return self.gen.codebook.device

    def written_tensors(self) -> List[torch.Tensor]:
        """Every tensor a training step writes in place: the generator's and
        the discriminator's parameters, the discriminator's running
        statistics, both optimizers' state, the EMA shadow and the codebook
        counters."""
        opt_state = [t for opt in (self.opt_gen, self.opt_disc)
                     for st in opt.state.values() for t in st.values()
                     if torch.is_tensor(t)]
        return [*self.gen.parameters(), *self.disc.parameters(),
                *self.disc.buffers(), *opt_state, *self.ema.values(),
                self.codebook_counts]

    def tensors(self) -> List[torch.Tensor]:
        """Every tensor a step reads or writes: written_tensors(), the
        generator's buffers and the frozen LPIPS."""
        return [*self.written_tensors(), *self.gen.buffers(),
                *self.lpips.parameters(), *self.lpips.buffers()]

    def state_dict(self) -> dict:
        return {"step": self.step, "ema_num_updates": self.ema_num_updates,
                "gen": self.gen.state_dict(), "disc": self.disc.state_dict(),
                "lpips": self.lpips.state_dict(),
                "opt_gen": self.opt_gen.state_dict(),
                "opt_disc": self.opt_disc.state_dict(),
                "ema": dict(self.ema),
                "codebook_counts": self.codebook_counts}

    @torch.no_grad()
    def load_state_dict(self, sd: dict) -> None:
        self.step = int(sd["step"])
        self.ema_num_updates = int(sd["ema_num_updates"])
        self.gen.load_state_dict(sd["gen"])
        self.disc.load_state_dict(sd["disc"])
        self.lpips.load_state_dict(sd["lpips"])
        self.opt_gen.load_state_dict(sd["opt_gen"])
        self.opt_disc.load_state_dict(sd["opt_disc"])
        if set(sd["ema"]) != set(self.ema):
            raise KeyError("EMA entries do not match the generator's "
                           "parameters")
        for k, v in sd["ema"].items():
            self.ema[k].copy_(v)
        self.codebook_counts.copy_(sd["codebook_counts"])


def create_train_state(model_cfg: CGICConfig, train_cfg: TrainConfig,
                       device: Union[str, torch.device] = "cuda",
                       seed: int = 0, lpips_net: str = "alex") -> TrainState:
    """A fresh state on `device` (CUDA unless asked otherwise; raises when
    CUDA is missing), every weight drawn from generators seeded by `seed`.
    LPIPS gets the bundled lin heads and is frozen. TF32 is turned off
    (`use_fp32_pipes`): the recipe trains in float32."""
    dev = resolve_device(device)
    use_fp32_pipes()
    gen = CGIC(model_cfg, generator=torch.Generator().manual_seed(seed))
    disc = NLayerDiscriminator(
        generator=torch.Generator().manual_seed(seed + 1))
    lpips = with_bundled_lin_heads(
        LPIPS(lpips_net, generator=torch.Generator().manual_seed(seed + 2)))
    gen, disc, lpips = gen.to(dev), disc.to(dev).eval(), lpips.to(dev).eval()
    lpips.requires_grad_(False)
    ema = {n: p.detach().clone() for n, p in gen.named_parameters()}
    capturable = dev.type == "cuda"
    return TrainState(gen, disc, lpips,
                      make_optimizer(gen.parameters(), train_cfg, capturable),
                      make_optimizer(disc.parameters(), train_cfg,
                                     capturable), ema)
