"""Training CLI (port of control_gic_tpu/cli/train.py).

The reference recipe: Adam lr 5e-5 betas (0.5, 0.9), gradients clipped by
value at 1.0, EMA 0.9999, 256x256 center-cropped [-1, 1] images, batch 2
per card, validation and a checkpoint every 2000 steps. One process drives
one card; --batch-size is that process's batch.

Failure handling:
  - SIGTERM / SIGINT finish the step in flight, write a checkpoint and exit;
  - non-finite metrics, checked at log steps, raise TrainFault;
  - a TrainFault restores from the latest checkpoint and continues, up to
    --max-restarts times; with no checkpoint yet the data shuffle seed moves
    on, so that a deterministic early fault is not replayed.

Usage:
  python -m control_gic_tpu_torch.cli.train --train-dir <imgs> [--val-dir <imgs>]
      [--config configs/train.yaml] [--steps 165000] [--batch-size 2]
      [--image-size 256] [--dtype float32|bfloat16] [--remat]
      [--ckpt-dir ./all_saves] [--resume] [--max-restarts 3]
      [--device cuda|cpu]

On CUDA each step runs as a CUDA graph (Trainer's default).

`train_loop` takes any iterator of NHWC [-1, 1] batches, so a caller can
drive the same loop with batches of its own.
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import signal
import threading
import time
from typing import Iterable, Optional

import numpy as np

from ..models.cgic import CGICConfig
from ..train import TrainConfig, Trainer, create_train_state
from ..utils.checkpoint import latest_step, restore_checkpoint, save_checkpoint
from ..utils.device import resolve_device, use_fp32_pipes
from ..utils.logging import ImageLogger, MetricLogger, log_schedule_hit


def get_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config", type=str, default=None,
                   help="YAML config (configs/train.yaml); its model and "
                        "train entries replace the flags' defaults")
    p.add_argument("--train-dir", type=str, required=True)
    p.add_argument("--val-dir", type=str, default=None)
    p.add_argument("--steps", type=int, default=165_000)
    p.add_argument("--batch-size", type=int, default=2,
                   help="batch of this process (the reference: 2 per card)")
    p.add_argument("--image-size", type=int, default=256)
    p.add_argument("--lr", type=float, default=5e-5)
    p.add_argument("--ratios", type=float, nargs=2, default=(0.1, 0.4))
    p.add_argument("--ckpt-dir", type=str, default="./all_saves")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--val-every", type=int, default=2000)
    p.add_argument("--ckpt-every", type=int, default=2000)
    p.add_argument("--log-every", type=int, default=30)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--remat", action="store_true",
                   help="recompute the trunk's blocks in the backward "
                        "instead of keeping their activations (less "
                        "memory, more compute); or model.remat in --config")
    p.add_argument("--dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--log-dir", type=str, default="./logs")
    p.add_argument("--wandb", action="store_true")
    p.add_argument("--debug-nans", action="store_true",
                   help="torch.autograd anomaly detection: fail at the "
                        "operation that made a NaN")
    p.add_argument("--profile-dir", type=str, default=None,
                   help="write a torch.profiler trace of steps 10..20 here")
    p.add_argument("--max-restarts", type=int, default=3,
                   help="restore from the latest checkpoint and continue "
                        "after a training fault, this many times")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    return p


class TrainFault(RuntimeError):
    """A recoverable training failure (non-finite metrics)."""


def _install_preemption_handler() -> threading.Event:
    """SIGTERM / SIGINT set the flag; the loop checkpoints and exits. A
    second signal falls through to the default handler."""
    flag = threading.Event()

    def _handler(signum, frame):
        if flag.is_set():
            signal.signal(signum, signal.SIG_DFL)
            signal.raise_signal(signum)
        print(f"signal {signum}: finishing step, checkpointing, exiting")
        flag.set()

    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            signal.signal(sig, _handler)
        except ValueError:          # not the main thread
            pass
    return flag


def run_configs(args):
    """(CGICConfig, TrainConfig) from --config, or from the flags."""
    if args.config:
        from ..config import load_config
        run_cfg = load_config(args.config)
        model_cfg = dataclasses.replace(
            run_cfg.model, resolution=args.image_size,
            remat=args.remat or run_cfg.model.remat)
        train_cfg = dataclasses.replace(run_cfg.train,
                                        coarse_ratio=args.ratios[0],
                                        medium_ratio=args.ratios[1])
    else:
        model_cfg = CGICConfig(resolution=args.image_size, dtype=args.dtype,
                               remat=args.remat)
        train_cfg = TrainConfig(learning_rate=args.lr,
                                coarse_ratio=args.ratios[0],
                                medium_ratio=args.ratios[1])
    return model_cfg, train_cfg


def main(argv=None):
    args = get_parser().parse_args(argv)
    resolve_device(args.device)
    use_fp32_pipes()
    if args.debug_nans:
        import torch
        torch.autograd.set_detect_anomaly(True)
    attempt = 0
    while True:
        try:
            return _run(args, resume=args.resume or attempt > 0,
                        attempt=attempt)
        except TrainFault as e:
            attempt += 1
            if attempt > args.max_restarts:
                raise
            print(f"training fault ({e}); restarting from the latest "
                  f"checkpoint [{attempt}/{args.max_restarts}]")


def _run(args, resume: bool, attempt: int = 0):
    from ..data import ImageFolderDataset, prefetch_batches

    model_cfg, train_cfg = run_configs(args)
    trainer = Trainer(model_cfg, train_cfg)
    state = create_train_state(model_cfg, train_cfg, device=args.device,
                               seed=args.seed)
    start = 0
    if resume and latest_step(args.ckpt_dir) is not None:
        restore_checkpoint(args.ckpt_dir, state)
        start = state.step
        print(f"resumed from step {start}")
    preempted = _install_preemption_handler()

    train_ds = ImageFolderDataset(args.train_dir, args.image_size)
    print(f"train images: {len(train_ds)}, device {state.device}, "
          f"batch {args.batch_size}")
    data_seed = args.seed
    if attempt and start == 0:
        data_seed = args.seed + attempt
        print(f"restart with no checkpoint: shuffle seed {args.seed} -> "
              f"{data_seed}, so as not to replay a deterministic fault")
    batches = prefetch_batches(train_ds, args.batch_size, shuffle=True,
                               seed=data_seed, start_step=start)
    val_batch = None
    if args.val_dir:
        val_ds = ImageFolderDataset(args.val_dir, args.image_size)
        val_batch = np.stack([val_ds[i] for i in
                              range(min(args.batch_size, len(val_ds)))])
    metric_log = MetricLogger(args.log_dir, use_wandb=args.wandb)
    try:
        return train_loop(args, trainer, state, batches, val_batch=val_batch,
                          preempted=preempted, metric_log=metric_log,
                          image_log=ImageLogger(args.log_dir))
    finally:
        batches.close()
        metric_log.close()


def train_loop(args, trainer: Trainer, state, batches: Iterable,
               val_batch=None, preempted: Optional[threading.Event] = None,
               metric_log: Optional[MetricLogger] = None,
               image_log: Optional[ImageLogger] = None):
    """Train from state.step to args.steps on `batches` (NHWC [-1, 1]),
    with the CLI's logging, validation, checkpoints and fault checks; a
    set `preempted` event checkpoints and returns after the step in flight.
    Returns the state."""
    start = state.step
    t0, seen, prof = time.time(), 0, None
    for step, batch in enumerate(batches, start=start):
        if step >= args.steps:
            break
        if args.profile_dir and step == start + 10:
            from torch.profiler import ProfilerActivity, profile
            prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA])
            prof.__enter__()
        state, metrics = trainer.train_step(state, batch)
        seen += len(batch)
        if prof is not None and step == start + 20:
            prof.__exit__(None, None, None)
            prof.export_chrome_trace(f"{args.profile_dir}/trace.json")
            prof = None

        if step % args.log_every == 0:
            metrics = {k: float(v) for k, v in metrics.items()}
            bad = [k for k, v in metrics.items() if not math.isfinite(v)]
            if bad:
                raise TrainFault(f"non-finite metrics at step {step}: {bad}")
            ips = seen / (time.time() - t0 + 1e-9)
            if metric_log is not None:
                metric_log.log(step, {**metrics, "images_per_sec": ips})
            print(f"step {step}: "
                  + " ".join(f"{k.split('/')[-1]}={v:.4f}"
                             for k, v in sorted(metrics.items()))
                  + f" ({ips:.2f} img/s)")
        if preempted is not None and preempted.is_set():
            save_checkpoint(args.ckpt_dir, state.step, state)
            print(f"preemption checkpoint @ {state.step}; exiting")
            return state
        if image_log is not None and log_schedule_hit(step):
            rec, gi = trainer.recon_step(state, batch)
            image_log.log(step, np.asarray(batch), rec.float().cpu().numpy(),
                          gi.cpu().numpy())
        if val_batch is not None and step and step % args.val_every == 0:
            vm = {k: float(v) for k, v in
                  trainer.eval_step(state, val_batch).items()}
            print(f"  val @ {step}: "
                  + " ".join(f"{k.split('/')[-1]}={v:.4f}"
                             for k, v in sorted(vm.items())))
        if step and step % args.ckpt_every == 0:
            save_checkpoint(args.ckpt_dir, step, state)
            print(f"  checkpoint @ {step}")
    save_checkpoint(args.ckpt_dir, state.step, state)
    print("done")
    return state


if __name__ == "__main__":
    main()
