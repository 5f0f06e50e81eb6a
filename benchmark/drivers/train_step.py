"""The training recipe's step on one card: `Trainer.train_step` (CUDA
graphs, the default) on batches of `batch` distinct crops from a pool made
from the seed, back to back (closed loop).

Set-up builds one train state with the benchmark's weights (the generator,
the discriminator, LPIPS with the published heads) and drives it through
its first four steps by the window's own call and feed. The first runs
eagerly and captures the step; the other three, like the window's, replay
the capture. Their readings (each step's losses, its gradient as Adam got
it, each leaf's change over it, the VQ index histogram) and the state after
each of steps 1-3, kept on the host, are what the reference is compared
with (`reference.judge`). The same trainer and state then serve the window.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from common import flops, images, weights
from reference import judge
from reference import model as R
from reference import train as T

STEPS_CHECKED = 4      # the warm-up, which captures, and three replays


def norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.float()))


def param_groups(config: dict):
    return [("gen", R.param_shapes(config["model"])),
            ("disc", T.disc_shapes()), ("lpips", T.lpips_shapes())]


def make_params(config: dict, seed: int, device: str) -> dict:
    params = weights.make_params(param_groups(config), seed, device)
    params["lpips"].update({k: v.to(device)
                            for k, v in T.lpips_heads().items()})
    return params


class Driver:

    def __init__(self, cell):
        self.cell = cell
        self.t = cell.traffic
        self.batch = self.t["batch"]
        self.items_per_request = self.batch
        self.steps = 0

    def setup(self, parts: dict) -> None:
        from control_gic_tpu_torch.models import CGIC, CGICConfig
        from control_gic_tpu_torch.models.discriminator import \
            NLayerDiscriminator
        from control_gic_tpu_torch.models.lpips import LPIPS
        from control_gic_tpu_torch.train import TrainConfig, Trainer
        from control_gic_tpu_torch.train.losses import LossConfig
        from control_gic_tpu_torch.train.state import (TrainState,
                                                       make_optimizer)
        from control_gic_tpu_torch.utils.device import use_fp32_pipes
        c, dev = self.cell, self.cell.device
        on_card = dev.startswith("cuda")
        t0 = time.perf_counter()
        use_fp32_pipes()
        m = c.config["model"]
        mcfg = CGICConfig(**{k: tuple(v) if isinstance(v, list) else v
                             for k, v in m.items()})
        rc, rm = c.config["ratios"]
        tcfg = TrainConfig(**c.config["train"],
                           loss=LossConfig(**c.config["loss"]),
                           coarse_ratio=rc, medium_ratio=rm)
        g = torch.Generator(device=dev)
        with torch.device(dev):
            gen = CGIC(mcfg, generator=g)
            disc = NLayerDiscriminator(generator=g)
            lpips = LPIPS(c.config["lpips"], generator=g)
        if on_card:
            torch.cuda.synchronize()
        parts["modules_s"] = time.perf_counter() - t0
        params = make_params(c.config, c.seed, dev)
        for module, key in ((gen, "gen"), (disc, "disc"), (lpips, "lpips")):
            module.load_state_dict(params[key], strict=True)
        del params
        disc.eval()
        lpips.eval().requires_grad_(False)
        ema = {n: p.detach().clone() for n, p in gen.named_parameters()}
        self.state = TrainState(
            gen, disc, lpips,
            make_optimizer(gen.parameters(), tcfg, capturable=on_card),
            make_optimizer(disc.parameters(), tcfg, capturable=on_card), ema)
        self.trainer = Trainer(mcfg, tcfg)
        if on_card:
            torch.cuda.synchronize()
        parts["weights_s"] = time.perf_counter() - t0 - parts["modules_s"]

        t0 = time.perf_counter()
        self.make_inputs()
        parts["inputs_s"] = time.perf_counter() - t0
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()

        t0 = time.perf_counter()
        self.readings = self.first_steps()
        self.capture_s = self.trainer.program_stats().get("capture_s", 0.0)
        parts["capture_s"] = self.capture_s
        parts["warm_up_s"] = time.perf_counter() - t0 - self.capture_s
        self.steps = 0

    def make_inputs(self) -> None:
        """The pool of crops (NHWC, [-1, 1]) and the order the steps take
        it in, from the seed."""
        c = self.cell
        h, w = self.t["image_hw"]
        pool = images.make_images(self.t["pool"], h, w, weights.generator(
            c.seed, weights.IMAGES, c.device), c.device)
        self.pool = pool.float() / 255.0 * 2.0 - 1.0
        self.order = torch.from_numpy(np.random.default_rng(weights.derive(
            c.seed, weights.ORDER)).permutation(self.t["pool"])).to(c.device)
        self.cursor = 0

    def first_batches(self):
        """The batches of the steps the comparison follows, NCHW."""
        self.cursor = 0
        return [self.next_batch().permute(0, 3, 1, 2).contiguous()
                for _ in range(STEPS_CHECKED)]

    def next_batch(self) -> torch.Tensor:
        n = self.t["pool"]
        idx = self.order[torch.arange(self.cursor, self.cursor + self.batch,
                                      device=self.order.device) % n]
        self.cursor += self.batch
        return self.pool[idx]

    def first_steps(self) -> dict:
        """Steps 1-4 through train_step, with the readings the comparison
        takes (see the module's docstring)."""
        st = self.state
        named = lambda: ([("gen." + n, p) for n, p in
                          st.gen.named_parameters()]
                         + [("disc." + n, p) for n, p in
                            st.disc.named_parameters()])

        def moments(key):
            # an optimizer that holds no moment got no gradient
            opt = {**st.opt_gen.state, **st.opt_disc.state}
            return {k: opt[p][key] if key in opt.get(p, {})
                    else torch.zeros_like(p) for k, p in named()}

        out = {k: [] for k in (*judge.STEP_READINGS, "states")}
        prev, counts = None, st.codebook_counts.clone()
        for i in range(STEPS_CHECKED):
            _, met = self.trainer.train_step(st, self.next_batch())
            out["losses"].append((float(met["train/aeloss"]),
                                  float(met["train/discloss"])))
            out["counts"].append((st.codebook_counts - counts).cpu())
            counts = st.codebook_counts.clone()
            m = moments("exp_avg")
            out["grads"].append({k: norm((g - T.B1 * (
                prev["m"][k].to(g.device) if prev else 0.0)) / (1 - T.B1))
                for k, g in m.items()})
            # the change over step 1 is read in `check`, from the weights
            # made again from the seed
            out["steps"].append(None if prev is None else {
                k: norm(p.detach() - prev[k.split(".", 1)[0]][
                    k.split(".", 1)[1]].to(p.device)) for k, p in named()})
            if i + 1 < STEPS_CHECKED:
                first = st.opt_gen.state.get(next(st.gen.parameters()), {})
                prev = judge.snapshot(st.gen.state_dict(),
                                      st.disc.state_dict(), m,
                                      moments("exp_avg_sq"),
                                      int(first.get("step", 0)))
                out["states"].append(prev)
        return out

    def request(self) -> None:
        self.trainer.train_step(self.state, self.next_batch())
        self.steps += 1

    def end_to_end(self, window_s: float) -> dict:
        return {"train_img_s": self.steps * self.batch / window_s}

    def layer_data(self) -> dict:
        h, w = self.t["image_hw"]
        m = self.cell.config["model"]
        return {"capture_s": self.capture_s, "items": self.steps,
                "flops_per_item": flops.train_step_flops(m, self.batch, h, w),
                "flash_bwd": flops.flash_attentions(m, h, w, self.batch),
                "dtype": m["dtype"]}

    def release(self) -> None:
        self.trainer = self.state = None

    def check(self) -> dict:
        c = self.cell
        R.fp32_pipes(True)
        params = make_params(c.config, c.seed, c.device)
        states = self.readings["states"]
        self.readings["steps"][0] = {
            f"{g}.{n}": norm(states[0][g][n].to(c.device) - params[g][n])
            for g in ("gen", "disc") for n in states[0][g]
            if "running" not in n}
        ref = judge.reference_readings(params, states,
                                       self.first_batches(),
                                       c.config["model"],
                                       tuple(c.config["ratios"]))
        return judge.judge_train(self.readings, ref)
