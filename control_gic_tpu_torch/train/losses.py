"""The VQ-LPIPS-GAN loss stack (port of control_gic_tpu/train/losses.py).

  generator:     loss = mean((x − x̂)² + pw·LPIPS) + g_weight·g_scale·(−mean D(x̂))
                        + codebook_weight·codebook_loss
  discriminator: hinge 0.5·(mean(relu(1 − D(x))) + mean(relu(1 + D(x̂)))),
                 or the vanilla softplus form.

The constants are the reference's effective ones (0.1 and 1.0). LPIPS is
called with normalize=True on [-1, 1] training tensors, the reference's
quirk, kept for training parity. With adaptive_g_weight the adversarial
term is also scaled by the reference's calculate_adaptive_weight
(`adaptive_weight`).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class LossConfig:
    codebook_weight: float = 1.0
    perceptual_weight: float = 1.0
    g_weight: float = 0.1
    disc_loss: str = "hinge"      # or "vanilla"
    lpips_normalize: bool = True  # the reference's convention
    # steps before the adversarial terms engage: the generator's g-term and
    # the discriminator's own loss are zeroed below this step
    disc_start: int = 0
    # scale the adversarial term by the reference's
    # calculate_adaptive_weight (`adaptive_weight`)
    adaptive_g_weight: bool = False


def hinge_d_loss(logits_real: torch.Tensor,
                 logits_fake: torch.Tensor) -> torch.Tensor:
    loss_real = torch.mean(F.relu(1.0 - logits_real))
    loss_fake = torch.mean(F.relu(1.0 + logits_fake))
    return 0.5 * (loss_real + loss_fake)


def vanilla_d_loss(logits_real: torch.Tensor,
                   logits_fake: torch.Tensor) -> torch.Tensor:
    return 0.5 * (torch.mean(F.softplus(-logits_real))
                  + torch.mean(F.softplus(logits_fake)))


def adaptive_weight(nll_loss: torch.Tensor, g_loss: torch.Tensor,
                    last_layer: torch.Tensor) -> torch.Tensor:
    """The reference's calculate_adaptive_weight (JAX Trainer.
    _adaptive_g_weight): ||d nll / dW|| / (||d g / dW|| + 1e-4), clamped to
    [0, 1e4] and detached, with W the decoder's conv_out weight. Both
    gradients come from the graph of the losses given (kept for the
    generator's own backward), which is the forward JAX recomputes."""
    g_nll, = torch.autograd.grad(nll_loss, last_layer, retain_graph=True)
    g_g, = torch.autograd.grad(g_loss, last_layer, retain_graph=True)
    w = torch.linalg.vector_norm(g_nll) / (torch.linalg.vector_norm(g_g)
                                           + 1e-4)
    return torch.clamp(w, 0.0, 1e4).detach()


def generator_loss(x, x_rec, p_loss, logits_fake, codebook_loss,
                   cfg: LossConfig, g_scale=1.0, last_layer=None
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(scalar loss, metrics). g_scale multiplies the adversarial term (the
    disc_start warm-up factor); given `last_layer`, so does
    adaptive_weight(nll, g, last_layer)."""
    rec_loss = torch.square(x.float() - x_rec.float())
    nll_loss = torch.mean(rec_loss + cfg.perceptual_weight * p_loss)
    g_loss = -torch.mean(logits_fake.float())
    if last_layer is not None:
        g_scale = g_scale * adaptive_weight(nll_loss, g_loss, last_layer)
    loss = (nll_loss + cfg.g_weight * g_scale * g_loss
            + cfg.codebook_weight * torch.mean(codebook_loss))
    metrics = {
        "total_loss": loss,
        "quant_loss": torch.mean(codebook_loss),
        "nll_loss": nll_loss,
        "rec_loss": torch.mean(rec_loss),
        "p_loss": torch.mean(p_loss),
        "g_loss": g_loss,
    }
    return loss, metrics


def discriminator_loss(logits_real, logits_fake, cfg: LossConfig
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    fn = hinge_d_loss if cfg.disc_loss == "hinge" else vanilla_d_loss
    d_loss = fn(logits_real.float(), logits_fake.float())
    metrics = {
        "disc_loss": d_loss,
        "logits_real": torch.mean(logits_real),
        "logits_fake": torch.mean(logits_fake),
    }
    return d_loss, metrics
