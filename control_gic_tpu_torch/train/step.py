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

Data parallelism (`Trainer(group=)`, one process per card, each on its rows
of the global batch): JAX jits the step over the global batch and XLA puts
in the collectives; here they are written out at the same points
(parallel/multihost.py), so that N ranks make the step one process makes on
the whole batch. The router's batch-wide thresholds come from the
all-gathered entropy maps, the discriminator's BatchNorm statistics from
sums over the group, the adaptive weight's two gradients are averaged before
their norms, the gradients are averaged before the clip, the codebook
counters add every rank's counts, and the metrics are averaged (val/psnr
from the averaged error). NCCL's collectives are captured in the step's
CUDA graph; gloo's cannot be, so a gloo group runs the steps eagerly.
Spans (profiler ranges of a traced step, run where the step runs eagerly
or is captured): `cgic.dp.grads` over each gradient mean, `cgic.dp.metrics`
over the metrics' mean, `cgic.dp.gather` over the router's all-gathers
(models/cgic.py) and `cgic.dp.bn` over the discriminator's group sums
(models/discriminator.py).
"""
from __future__ import annotations

import functools
import logging
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..models.cgic import CGICConfig
from ..ops import norm_conv
from ..parallel.multihost import (all_reduce_, all_reduce_mean, capturable,
                                  group_key)
from ..utils.programs import CUDAGraphs, Programs
from ..utils.trace import span
from .losses import discriminator_loss, generator_loss
from .state import (TrainConfig, TrainState, apply_gradients, ema_apply,
                    ema_weight)

Metrics = Dict[str, torch.Tensor]
_LOG = logging.getLogger(__name__)


def _uncached(fn):
    """fn with the weight packs made at every call (ops.norm_conv.uncached)."""
    @functools.wraps(fn)
    def run(*args):
        with norm_conv.uncached():
            return fn(*args)
    return run


def forward_losses(cfg: TrainConfig, state: TrainState, x: torch.Tensor,
                   g_scale: float = 1.0, adaptive: bool = False, group=None):
    """Trainer.forward_losses under the training config `cfg`."""
    rec, enc = state.gen(x, cfg.coarse_ratio, cfg.medium_ratio, group=group)
    p_loss = torch.mean(state.lpips(rec, x,
                                    normalize=cfg.loss.lpips_normalize))
    state.disc.eval()
    logits_fake = state.disc(rec)
    last = state.gen.decoder.conv_out.weight if adaptive else None
    loss, metrics = generator_loss(x, rec, p_loss, logits_fake,
                                   enc.emb_loss, cfg.loss, g_scale=g_scale,
                                   last_layer=last, group=group)
    return loss, rec, enc, metrics


def _mean_metrics(metrics: Metrics, group) -> Metrics:
    """Each metric averaged over the group (one all-reduce)."""
    if group is None:
        return metrics
    with span("cgic.dp.metrics"):
        vals = all_reduce_mean([torch.stack([v.float() for v in
                                             metrics.values()])], group)[0]
        return dict(zip(metrics, vals.unbind()))


# The programs' functions take the config and the state, not the Trainer:
# a Trainer keeps its programs, and a program that kept the Trainer would
# make a reference cycle that holds the graphs' memory until a collection.

def _global_grads(params, grads, group):
    """The gradients of the global batch's loss: each rank's averaged over
    the group (one all-reduce), before the clip; a parameter without one
    gets zeros, as jax.grad gives."""
    if group is None:
        return grads
    with span("cgic.dp.grads"):
        return all_reduce_mean([torch.zeros_like(p) if g is None else g
                                for p, g in zip(params, grads)], group)


def _step(cfg: TrainConfig, state: TrainState, on: float, x: torch.Tensor,
          ema_w: torch.Tensor, group=None) -> Metrics:
    """The device side of one training step (everything but the host
    counters); on: the disc_start side, ema_w: ema_weight's value, group:
    the data-parallel process group (None: one process)."""
    # ---- generator update
    gen_params = list(state.gen.parameters())
    adaptive = cfg.loss.adaptive_g_weight and on > 0.0
    g_loss, rec, enc, g_metrics = forward_losses(cfg, state, x, on, adaptive,
                                                 group)
    grads = torch.autograd.grad(g_loss, gen_params, allow_unused=True)
    apply_gradients(state.opt_gen, gen_params,
                    _global_grads(gen_params, grads, group), cfg)

    # ---- discriminator update (reconstruction detached)
    disc_params = list(state.disc.parameters())
    rec_sg = rec.detach()
    state.disc.train()
    logits_real = state.disc(x, group)
    logits_fake = state.disc(rec_sg, group)
    state.disc.eval()
    d_loss, d_metrics = discriminator_loss(logits_real, logits_fake,
                                           cfg.loss)
    if cfg.loss.disc_start > 0:
        d_loss = d_loss * on
    d_grads = torch.autograd.grad(d_loss, disc_params, allow_unused=True)
    apply_gradients(state.opt_disc, disc_params,
                    _global_grads(disc_params, d_grads, group), cfg)

    # ---- EMA + counters
    ema_apply([state.ema[n] for n, _ in state.gen.named_parameters()],
              gen_params, ema_w)
    state.codebook_counts += all_reduce_(
        enc.counts.to(state.codebook_counts.dtype), group)

    metrics = {f"train/{k}": v.detach()
               for k, v in {**g_metrics, **d_metrics}.items()}
    metrics["train/aeloss"] = g_loss.detach()
    metrics["train/discloss"] = d_loss.detach()
    return _mean_metrics(metrics, group)


def _eval(cfg: TrainConfig, state: TrainState, x: torch.Tensor,
          group=None) -> Metrics:
    with torch.no_grad():
        _, rec, _, g_metrics = forward_losses(cfg, state, x, group=group)
        logits_real = state.disc(x)
        logits_fake = state.disc(rec)
        _, d_metrics = discriminator_loss(logits_real, logits_fake,
                                          cfg.loss)
        out = {f"val/{k}": v for k, v in {**g_metrics, **d_metrics}.items()}
        out["val/mse"] = torch.mean(torch.square(rec.float() - x))
        out = _mean_metrics(out, group)
        out["val/psnr"] = -10.0 * torch.log10(out.pop("val/mse") / 4.0
                                              + 1e-12)
    return out


def _recon(cfg: TrainConfig, state: TrainState, x: torch.Tensor,
           group=None):
    with torch.no_grad():
        rec, enc = state.gen(x, cfg.coarse_ratio, cfg.medium_ratio,
                             group=group)
    return rec.permute(0, 2, 3, 1), enc.grain_indices


class Trainer:
    """Binds the model and training configs to the step functions; the
    modules and optimizers live in the TrainState. graphs: None (the
    default) or True runs the steps as CUDA graphs on a CUDA state, False
    runs them eagerly; a CPU state always runs eagerly. group: the process
    group of a data-parallel run (parallel/multihost.py), each rank passing
    its rows of the global batch; None for one process. Under a gloo group
    graphs=True raises and graphs=None runs eagerly: gloo's collectives
    cannot be captured."""

    def __init__(self, model_cfg: CGICConfig, train_cfg: TrainConfig,
                 graphs: Optional[bool] = None, group=None):
        self.model_cfg = model_cfg
        self.train_cfg = train_cfg
        self.group = group
        if not capturable(group):
            if graphs:
                raise ValueError(
                    "graphs=True under a gloo group: gloo's collectives "
                    "cannot be captured in a CUDA graph; use NCCL (one "
                    "card per rank) or graphs=False")
            if graphs is None:
                _LOG.info("gloo group of %d ranks: the steps run eagerly",
                          group.size())
                graphs = False
        self.graphs = graphs
        self._programs: Optional[Programs] = None
        self._cache: dict = {}
        self._device: Optional[torch.device] = None
        self._stamp: Optional[tuple] = None

    @staticmethod
    def to_input(state: TrainState, x) -> torch.Tensor:
        """NHWC batch -> NCHW float32 on the state's device."""
        with span("cgic.train.input"):
            x = torch.as_tensor(np.asarray(x) if not torch.is_tensor(x)
                                else x)
            return x.to(state.device, torch.float32).permute(
                0, 3, 1, 2).contiguous()

    def forward_losses(self, state: TrainState, x: torch.Tensor,
                       g_scale: float = 1.0, adaptive: bool = False):
        """The generator's loss on NCHW x (JAX `_forward_losses`), with the
        adaptive weight in g_scale when `adaptive`: returns
        (loss, rec, enc, metrics)."""
        return forward_losses(self.train_cfg, state, x, g_scale, adaptive,
                              self.group)

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
        """fn(*inputs) through the program of `key` and the group that the
        step reads now (its rank, size and backend): captured and replayed
        on a CUDA state (unless graphs=False), eager otherwise. Programs
        whose state tensors were replaced are dropped first."""
        programs = self._programs_for(state)
        if programs.backend is None:
            return fn(*inputs)
        if not capturable(self.group):
            raise ValueError("a gloo group's collectives cannot be captured "
                             "in a CUDA graph: build the Trainer with the "
                             "group, or with graphs=False")
        stamp = lambda: tuple(t.data_ptr() for t in state.tensors())
        if stamp() != self._stamp:
            programs.clear()
        captured = programs.captured
        out = programs.run(self._cache, (*key, group_key(self.group)),
                           _uncached(fn), *inputs)
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
        would multiply a zero. The step is a root span, cgic.train.step."""
        with span("cgic.train.step", step=state.step):
            x = self.to_input(state, x)
            on = self._adversarial_on(state)
            ema_w = torch.full((), ema_weight(state.ema_num_updates,
                                              self.train_cfg.ema_decay),
                               dtype=torch.float32, device=state.device)
            metrics = self._run(state, ("train", on),
                                functools.partial(_step, self.train_cfg,
                                                  state, on,
                                                  group=self.group),
                                x, ema_w)
            if self._programs_for(state).backend is not None:
                # a replay wrote these without bumping their versions
                torch.autograd.graph.increment_version(
                    state.written_tensors())
            state.ema_num_updates += 1
            state.step += 1
        return state, metrics

    def eval_step(self, state: TrainState, x) -> Metrics:
        return self._run(state, ("eval",),
                         functools.partial(_eval, self.train_cfg, state,
                                           group=self.group),
                         self.to_input(state, x))

    def recon_step(self, state: TrainState, x):
        """Reconstruction (NHWC) and partition map, for image logging."""
        return self._run(state, ("recon",),
                         functools.partial(_recon, self.train_cfg, state,
                                           group=self.group),
                         self.to_input(state, x))
