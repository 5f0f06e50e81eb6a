"""Training and validation steps (port of control_gic_tpu/train/step.py).

One fused step per batch makes both updates that the reference makes as two
optimizer passes:
  1. generator: MSE + LPIPS + 0.1·g_scale·(−mean D(x̂)) + codebook loss, with
     the discriminator in eval mode at its pre-update parameters; the
     gradient is taken with respect to the generator's parameters only, so
     nothing lands on the discriminator's. g_scale is the disc_start side
     (0 before it, 1 from it on), times the adaptive weight with
     adaptive_g_weight;
  2. discriminator: hinge(D(x), D(sg(x̂))) in train mode, real then fake, so
     its running statistics update twice.
Then the EMA shadow follows the new generator parameters and the codebook
counters add this batch's usage. The reconstruction is computed once and
reused, as in JAX (one half-step of staleness on the discriminator's input).

The three steps are programs (utils/programs.py), as JAX jits them: on CUDA
each is a CUDA graph by default, captured at its first call for each key
and replayed after it; `Trainer(..., graphs=False)` and a state on the CPU
run them eagerly. The keys: the input's shape, the call-time switches and,
for the training step, the side of the disc_start switch (a run that
crosses it captures two programs). What a capture cannot bake in stays
outside the program: the step counters are host ints advanced after it, and
the EMA's weight is computed on the host and copied into the program's
input. A captured step writes the state in place without bumping the
tensors' versions, so the trainer bumps them after each step, and inside its
programs the weight packs are made in the graph
(`ops.norm_conv.uncached`), not read from the version-keyed cache. The
programs hold the addresses of the state's tensors, so a state whose tensors
were replaced (`torch.optim.Adam.load_state_dict` replaces its state) drops
them and captures anew.

Batches come as NHWC [-1, 1] arrays (numpy or tensors); the steps permute
them to NCHW on the state's device.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..models.cgic import CGICConfig
from ..ops import norm_conv
from ..utils.programs import CUDAGraphs, Programs
from .losses import discriminator_loss, generator_loss
from .state import (TrainConfig, TrainState, apply_gradients, ema_apply,
                    ema_weight)

Metrics = Dict[str, torch.Tensor]


def _uncached(fn):
    """fn with the weight packs made at every call (ops.norm_conv.uncached)."""
    @functools.wraps(fn)
    def run(*args):
        with norm_conv.uncached():
            return fn(*args)
    return run


def forward_losses(cfg: TrainConfig, state: TrainState, x: torch.Tensor,
                   g_scale: float = 1.0, adaptive: bool = False):
    """Trainer.forward_losses under the training config `cfg`."""
    rec, enc = state.gen(x, cfg.coarse_ratio, cfg.medium_ratio)
    p_loss = torch.mean(state.lpips(rec, x,
                                    normalize=cfg.loss.lpips_normalize))
    state.disc.eval()
    logits_fake = state.disc(rec)
    last = state.gen.decoder.conv_out.weight if adaptive else None
    loss, metrics = generator_loss(x, rec, p_loss, logits_fake,
                                   enc.emb_loss, cfg.loss, g_scale=g_scale,
                                   last_layer=last)
    return loss, rec, enc, metrics


# The programs' functions take the config and the state, not the Trainer:
# a Trainer keeps its programs, and a program that kept the Trainer would
# make a reference cycle that holds the graphs' memory until a collection.

def _step(cfg: TrainConfig, state: TrainState, on: float, x: torch.Tensor,
          ema_w: torch.Tensor) -> Metrics:
    """The device side of one training step (everything but the host
    counters); on: the disc_start side, ema_w: ema_weight's value."""
    # ---- generator update
    gen_params = list(state.gen.parameters())
    adaptive = cfg.loss.adaptive_g_weight and on > 0.0
    g_loss, rec, enc, g_metrics = forward_losses(cfg, state, x, on, adaptive)
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
    ema_apply([state.ema[n] for n, _ in state.gen.named_parameters()],
              gen_params, ema_w)
    state.codebook_counts += enc.counts.to(state.codebook_counts.dtype)

    metrics = {f"train/{k}": v.detach()
               for k, v in {**g_metrics, **d_metrics}.items()}
    metrics["train/aeloss"] = g_loss.detach()
    metrics["train/discloss"] = d_loss.detach()
    return metrics


def _eval(cfg: TrainConfig, state: TrainState, x: torch.Tensor) -> Metrics:
    with torch.no_grad():
        _, rec, _, g_metrics = forward_losses(cfg, state, x)
        logits_real = state.disc(x)
        logits_fake = state.disc(rec)
        _, d_metrics = discriminator_loss(logits_real, logits_fake,
                                          cfg.loss)
        out = {f"val/{k}": v for k, v in {**g_metrics, **d_metrics}.items()}
        out["val/psnr"] = -10.0 * torch.log10(
            torch.mean(torch.square(rec.float() - x)) / 4.0 + 1e-12)
    return out


def _recon(cfg: TrainConfig, state: TrainState, x: torch.Tensor):
    with torch.no_grad():
        rec, enc = state.gen(x, cfg.coarse_ratio, cfg.medium_ratio)
    return rec.permute(0, 2, 3, 1), enc.grain_indices


class Trainer:
    """Binds the model and training configs to the step functions; the
    modules and optimizers live in the TrainState. graphs: None (the
    default) or True runs the steps as CUDA graphs on a CUDA state, False
    runs them eagerly; a CPU state always runs eagerly."""

    def __init__(self, model_cfg: CGICConfig, train_cfg: TrainConfig,
                 graphs: Optional[bool] = None):
        self.model_cfg = model_cfg
        self.train_cfg = train_cfg
        self.graphs = graphs
        self._programs: Optional[Programs] = None
        self._cache: dict = {}
        self._device: Optional[torch.device] = None
        self._stamp: Optional[tuple] = None

    @staticmethod
    def to_input(state: TrainState, x) -> torch.Tensor:
        """NHWC batch -> NCHW float32 on the state's device."""
        x = torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x)
        return x.to(state.device, torch.float32).permute(0, 3, 1, 2
                                                          ).contiguous()

    def forward_losses(self, state: TrainState, x: torch.Tensor,
                       g_scale: float = 1.0, adaptive: bool = False):
        """The generator's loss on NCHW x (JAX `_forward_losses`), with the
        adaptive weight in g_scale when `adaptive`: returns
        (loss, rec, enc, metrics)."""
        return forward_losses(self.train_cfg, state, x, g_scale, adaptive)

    def _adversarial_on(self, state: TrainState) -> float:
        start = self.train_cfg.loss.disc_start
        return 1.0 if start <= 0 or state.step >= start else 0.0

    # ------------------------------------------------------------ programs

    def _programs_for(self, state: TrainState) -> Programs:
        """The programs of the state's device, with their capture backend
        (None: eager)."""
        if self._programs is None or self._device != state.device:
            backend = (CUDAGraphs(state.device, side_stream_warm_up=True)
                       if state.device.type == "cuda"
                       and self.graphs is not False else None)
            self._programs = Programs(None, backend)
            self._cache = self._programs.cache()
            self._device = state.device
        return self._programs

    def _run(self, state: TrainState, key: tuple, fn, *inputs):
        """fn(*inputs) through the program of `key`: captured and
        replayed on a CUDA state (unless graphs=False), eager otherwise.
        Programs whose state tensors were replaced are dropped first."""
        programs = self._programs_for(state)
        if programs.backend is None:
            return fn(*inputs)
        stamp = lambda: tuple(t.data_ptr() for t in state.tensors())
        if stamp() != self._stamp:
            programs.clear()
        captured = programs.captured
        out = programs.run(self._cache, key, _uncached(fn), *inputs)
        if programs.captured != captured:
            # a first call's warm-up may have made the optimizers' state
            self._stamp = stamp()
        return out

    def program_stats(self) -> dict:
        """Programs captured, capture seconds and the pool's memory (empty
        before the first step or without graphs)."""
        if self._programs is None or self._programs.backend is None:
            return {}
        return self._programs.stats()

    # --------------------------------------------------------------- steps

    def train_step(self, state: TrainState, x) -> Tuple[TrainState, Metrics]:
        """One fused step; updates `state` in place and returns it with the
        step's metrics (detached scalar tensors, read on the host only when
        logged). Before disc_start the adaptive weight is not computed: it
        would multiply a zero."""
        x = self.to_input(state, x)
        on = self._adversarial_on(state)
        ema_w = torch.full((), ema_weight(state.ema_num_updates,
                                          self.train_cfg.ema_decay),
                           dtype=torch.float32, device=state.device)
        metrics = self._run(state, ("train", on),
                            functools.partial(_step, self.train_cfg, state,
                                              on),
                            x, ema_w)
        if self._programs_for(state).backend is not None:
            # a replay wrote these without bumping their versions
            torch.autograd.graph.increment_version(state.written_tensors())
        state.ema_num_updates += 1
        state.step += 1
        return state, metrics

    def eval_step(self, state: TrainState, x) -> Metrics:
        return self._run(state, ("eval",),
                         functools.partial(_eval, self.train_cfg, state),
                         self.to_input(state, x))

    def recon_step(self, state: TrainState, x):
        """Reconstruction (NHWC) and partition map, for image logging."""
        return self._run(state, ("recon",),
                         functools.partial(_recon, self.train_cfg, state),
                         self.to_input(state, x))
