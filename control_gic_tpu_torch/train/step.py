"""Training and validation steps (port of control_gic_tpu/train/step.py).

One fused step per batch makes both updates that the reference makes as two
optimizer passes:
  1. generator: MSE + LPIPS + 0.1·(−mean D(x̂)) + codebook loss, with the
     discriminator in eval mode at its pre-update parameters; the gradient
     is taken with respect to the generator's parameters only, so nothing
     lands on the discriminator's;
  2. discriminator: hinge(D(x), D(sg(x̂))) in train mode, real then fake, so
     its running statistics update twice.
Then the EMA shadow follows the new generator parameters and the codebook
counters add this batch's usage. The reconstruction is computed once and
reused, as in JAX (one half-step of staleness on the discriminator's input).

Batches come as NHWC [-1, 1] arrays (numpy or tensors); the steps permute
them to NCHW on the state's device.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..models.cgic import CGICConfig
from .losses import discriminator_loss, generator_loss
from .state import TrainConfig, TrainState, apply_gradients, ema_update

Metrics = Dict[str, torch.Tensor]


class Trainer:
    """Binds the model and training configs to the step functions; the
    modules and optimizers live in the TrainState."""

    def __init__(self, model_cfg: CGICConfig, train_cfg: TrainConfig):
        if train_cfg.loss.adaptive_g_weight:
            raise NotImplementedError(
                "adaptive_g_weight is not ported yet (ROADMAP queue 1)")
        self.model_cfg = model_cfg
        self.train_cfg = train_cfg

    @staticmethod
    def to_input(state: TrainState, x) -> torch.Tensor:
        """NHWC batch -> NCHW float32 on the state's device."""
        x = torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x)
        return x.to(state.device, torch.float32).permute(0, 3, 1, 2
                                                          ).contiguous()

    def forward_losses(self, state: TrainState, x: torch.Tensor,
                       g_scale: float = 1.0):
        """The generator's loss on NCHW x (JAX `_forward_losses`): returns
        (loss, rec, enc, metrics)."""
        cfg = self.train_cfg
        rec, enc = state.gen(x, cfg.coarse_ratio, cfg.medium_ratio)
        p_loss = torch.mean(state.lpips(rec, x,
                                        normalize=cfg.loss.lpips_normalize))
        state.disc.eval()
        logits_fake = state.disc(rec)
        loss, metrics = generator_loss(x, rec, p_loss, logits_fake,
                                       enc.emb_loss, cfg.loss,
                                       g_scale=g_scale)
        return loss, rec, enc, metrics

    def _adversarial_on(self, state: TrainState) -> float:
        start = self.train_cfg.loss.disc_start
        return 1.0 if start <= 0 or state.step >= start else 0.0

    def train_step(self, state: TrainState, x) -> Tuple[TrainState, Metrics]:
        """One fused step; updates `state` in place and returns it with the
        step's metrics (detached scalar tensors, read on the host only when
        logged)."""
        cfg = self.train_cfg
        x = self.to_input(state, x)
        on = self._adversarial_on(state)

        # ---- generator update
        gen_params = list(state.gen.parameters())
        g_loss, rec, enc, g_metrics = self.forward_losses(state, x, on)
        grads = torch.autograd.grad(g_loss, gen_params, allow_unused=True)
        apply_gradients(state.opt_gen, gen_params, grads, cfg)

        # ---- discriminator update (reconstruction detached)
        disc_params = list(state.disc.parameters())
        rec_sg = rec.detach()
        state.disc.train()
        logits_real = state.disc(x)
        logits_fake = state.disc(rec_sg)
        state.disc.eval()
        d_loss, d_metrics = discriminator_loss(logits_real, logits_fake,
                                               cfg.loss)
        if cfg.loss.disc_start > 0:
            d_loss = d_loss * on
        d_grads = torch.autograd.grad(d_loss, disc_params, allow_unused=True)
        apply_gradients(state.opt_disc, disc_params, d_grads, cfg)

        # ---- EMA + counters
        state.ema_num_updates = ema_update(
            state.ema, state.gen.named_parameters(), state.ema_num_updates,
            cfg.ema_decay)
        state.codebook_counts += enc.counts.to(state.codebook_counts.dtype)
        state.step += 1

        metrics = {f"train/{k}": v.detach()
                   for k, v in {**g_metrics, **d_metrics}.items()}
        metrics["train/aeloss"] = g_loss.detach()
        metrics["train/discloss"] = d_loss.detach()
        return state, metrics

    @torch.no_grad()
    def eval_step(self, state: TrainState, x) -> Metrics:
        x = self.to_input(state, x)
        _, rec, _, g_metrics = self.forward_losses(state, x)
        logits_real = state.disc(x)
        logits_fake = state.disc(rec)
        _, d_metrics = discriminator_loss(logits_real, logits_fake,
                                          self.train_cfg.loss)
        out = {f"val/{k}": v for k, v in {**g_metrics, **d_metrics}.items()}
        out["val/psnr"] = -10.0 * torch.log10(
            torch.mean(torch.square(rec.float() - x)) / 4.0 + 1e-12)
        return out

    @torch.no_grad()
    def recon_step(self, state: TrainState, x):
        """Reconstruction (NHWC) and partition map, for image logging."""
        cfg = self.train_cfg
        rec, enc = state.gen(self.to_input(state, x), cfg.coarse_ratio,
                             cfg.medium_ratio)
        return rec.permute(0, 2, 3, 1), enc.grain_indices
