"""The port's train CLI on the CPU, with the contracts of
tests/test_train_cli.py: a normal run checkpoints, an injected fault
restores from the latest checkpoint and continues, non-finite metrics raise
TrainFault, preemption exits with a checkpoint; and a resumed run equals an
uninterrupted one. Also the pieces around it against the JAX package: the
training dataset and its prefetch order, the YAML config, the partition-map
drawers, and the codec built from a training checkpoint."""
import glob
import json
import os
import threading

import numpy as np
import pytest
import torch
from PIL import Image

from control_gic_tpu.config import load_config as j_load_config
from control_gic_tpu.data.dataset import ImageFolderDataset as JDataset
from control_gic_tpu.data.dataset import prefetch_batches as j_prefetch
from control_gic_tpu.utils import draw as jdraw
from control_gic_tpu_torch.cli import train as train_cli
from control_gic_tpu_torch.cli.common import build_codec
from control_gic_tpu_torch.config import load_config
from control_gic_tpu_torch.data import ImageFolderDataset, prefetch_batches
from control_gic_tpu_torch.train import Trainer
from control_gic_tpu_torch.utils import draw as tdraw
from control_gic_tpu_torch.utils.checkpoint import latest_step, load_checkpoint
from control_gic_tpu_torch.utils.logging import MetricLogger, log_schedule_hit

torch.set_num_threads(2)

TINY_YAML = """
ratios: [0.1, 0.4]
model:
  n_embed: 32
  embed_dim: 4
  z_channels: 4
  ch: 32
  ch_mult: [1, 1, 2, 2, 2]
  num_res_blocks: 1
  attn_resolutions: [8]
  resolution: 64
train:
  learning_rate: 5.0e-5
"""


@pytest.fixture(scope="module")
def train_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("train_imgs")
    rng = np.random.default_rng(0)
    for i in range(8):
        size = (64 + 8 * (i % 3), 64 + 4 * (i % 2))     # non-square crops
        arr = rng.integers(0, 255, size + (3,), dtype=np.uint8)
        Image.fromarray(arr).save(d / f"{i}.png")
    return str(d)


@pytest.fixture(scope="module")
def tiny_cfg(tmp_path_factory):
    p = tmp_path_factory.mktemp("cfg") / "tiny.yaml"
    p.write_text(TINY_YAML)
    return str(p)


def _args(train_dir, tiny_cfg, tmp_path, steps, extra=()):
    return ["--config", tiny_cfg, "--train-dir", train_dir,
            "--steps", str(steps), "--batch-size", "2",
            "--image-size", "64", "--ckpt-dir", str(tmp_path / "ckpt"),
            "--log-dir", str(tmp_path / "logs"), "--device", "cpu",
            "--log-every", "1", "--ckpt-every", "2", *extra]


def _wrap_train_step(monkeypatch, wrapper):
    inner = Trainer.train_step
    monkeypatch.setattr(Trainer, "train_step",
                        lambda self, state, x: wrapper(
                            lambda s, b: inner(self, s, b), state, x))


def test_restart_recovers_from_fault(train_dir, tiny_cfg, tmp_path,
                                     monkeypatch):
    """An injected fault mid-run restarts in process from the latest
    checkpoint, and the run still reaches --steps."""
    calls = {"n": 0}

    def flaky(inner, state, x):
        calls["n"] += 1
        if calls["n"] == 4:  # after the step-2 checkpoint exists
            raise train_cli.TrainFault("injected fault")
        return inner(state, x)

    _wrap_train_step(monkeypatch, flaky)
    train_cli.main(_args(train_dir, tiny_cfg, tmp_path, steps=5))
    assert latest_step(str(tmp_path / "ckpt")) == 5
    # the restart re-ran steps 3 and 4 from the step-2 checkpoint
    assert calls["n"] == 6
    logs = glob.glob(str(tmp_path / "logs" / "*.jsonl"))
    assert logs and os.path.getsize(logs[0]) > 0
    assert glob.glob(str(tmp_path / "logs" / "images" / "*.png"))


def test_nonfinite_metrics_raise_train_fault(train_dir, tiny_cfg, tmp_path,
                                             monkeypatch):
    def poisoned(inner, state, x):
        state, metrics = inner(state, x)
        return state, {**metrics, "train/aeloss": torch.tensor(float("nan"))}

    _wrap_train_step(monkeypatch, poisoned)
    with pytest.raises(train_cli.TrainFault, match="non-finite"):
        train_cli.main(_args(train_dir, tiny_cfg, tmp_path, steps=3,
                             extra=("--max-restarts", "0")))


def test_preemption_checkpoints_and_exits(train_dir, tiny_cfg, tmp_path,
                                          monkeypatch):
    ev = threading.Event()
    monkeypatch.setattr(train_cli, "_install_preemption_handler", lambda: ev)

    def step_then_preempt(inner, state, x):
        out = inner(state, x)
        ev.set()
        return out

    _wrap_train_step(monkeypatch, step_then_preempt)
    train_cli.main(_args(train_dir, tiny_cfg, tmp_path, steps=500))
    saved = latest_step(str(tmp_path / "ckpt"))
    assert saved is not None and saved <= 2


def test_resume_equals_an_uninterrupted_run(train_dir, tiny_cfg, tmp_path):
    """Two steps, then --resume to four, give the weights, EMA, counters and
    optimizer state of four steps in one run."""
    straight, split = tmp_path / "straight", tmp_path / "split"
    train_cli.main(_args(train_dir, tiny_cfg, straight, steps=4))
    train_cli.main(_args(train_dir, tiny_cfg, split, steps=2))
    train_cli.main(_args(train_dir, tiny_cfg, split, steps=4,
                         extra=("--resume",)))
    a = load_checkpoint(str(straight / "ckpt"))
    b = load_checkpoint(str(split / "ckpt"))
    assert a["step"] == b["step"] == 4
    for key in ("gen", "disc", "ema"):
        for k in a[key]:
            assert torch.equal(a[key][k], b[key][k]), (key, k)
    assert torch.equal(a["codebook_counts"], b["codebook_counts"])
    assert a["opt_gen"]["state"][0]["step"] == b["opt_gen"]["state"][0]["step"]


def test_codec_from_training_checkpoint(train_dir, tiny_cfg, tmp_path):
    train_cli.main(_args(train_dir, tiny_cfg, tmp_path, steps=2))
    saved = load_checkpoint(str(tmp_path / "ckpt"))
    cfg = load_config(tiny_cfg).model
    for use_ema, key in ((False, "gen"), (True, "ema")):
        codec = build_codec(str(tmp_path / "ckpt"), config=cfg,
                            device="cpu", use_ema=use_ema)
        for k, v in codec.model.state_dict().items():
            assert torch.equal(v, saved[key][k]), (key, k)
    counts = saved["codebook_counts"].numpy()
    assert counts.sum() == 2 * 2 * 16 * 16
    img = np.random.default_rng(1).uniform(0, 1, (64, 64, 3)).astype(
        np.float32)
    rec, bpp, _ = codec.compress(img, 0.1, 0.4)
    assert bpp > 0 and np.isfinite(rec).all()


def test_config_matches_jax(tiny_cfg):
    for path in (tiny_cfg, os.path.join(os.path.dirname(__file__), "..",
                                        "configs", "train.yaml")):
        got, want = load_config(path), j_load_config(path)
        assert got.ratios == want.ratios and got.data == want.data
        assert got.trainer == want.trainer
        for name in ("n_embed", "ch", "ch_mult", "num_res_blocks",
                     "attn_resolutions", "resolution", "dtype"):
            assert getattr(got.model, name) == getattr(want.model, name)
        for name in ("learning_rate", "b1", "b2", "grad_clip_value",
                     "ema_decay", "coarse_ratio", "medium_ratio"):
            assert getattr(got.train, name) == getattr(want.train, name)
        assert vars(got.train.loss) == vars(want.train.loss)


def test_dataset_and_prefetch_match_jax(train_dir):
    ds, jds = ImageFolderDataset(train_dir, 64), JDataset(train_dir, 64)
    assert len(ds) == len(jds) == 8
    for i in range(len(ds)):
        np.testing.assert_array_equal(ds[i], jds[i])
    assert ds[0].shape == (64, 64, 3) and ds[0].min() >= -1
    for start in (0, 5):
        got = list(zip(range(6), prefetch_batches(ds, 3, seed=2,
                                                  start_step=start)))
        want = list(zip(range(6), j_prefetch(jds, 3, seed=2,
                                             start_step=start)))
        for (_, g), (_, w) in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_prefetch_hands_a_worker_error_to_the_consumer():
    class Broken:
        def __len__(self):
            return 4

        def __getitem__(self, i):
            raise OSError("unreadable image")

    with pytest.raises(OSError, match="unreadable"):
        next(prefetch_batches(Broken(), 2))


def test_drawers_match_jax():
    rng = np.random.default_rng(3)
    imgs = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    idx = rng.integers(0, 3, (2, 16, 16))
    np.testing.assert_array_equal(tdraw.draw_partition_map(imgs, idx),
                                  jdraw.draw_partition_map(imgs, idx))
    np.testing.assert_array_equal(
        tdraw.draw_partition_map_color(imgs, idx, scaler=0.7),
        jdraw.draw_partition_map_color(imgs, idx, scaler=0.7))


def test_metric_logger_and_schedule(tmp_path):
    assert [s for s in range(2100) if log_schedule_hit(s)] == [
        1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048]
    log = MetricLogger(str(tmp_path))
    log.log(3, {"train/aeloss": torch.tensor(0.5), "x": 1})
    log.close()
    with open(tmp_path / "metrics.jsonl") as f:
        rec = json.loads(f.readline())
    assert rec["step"] == 3 and rec["train/aeloss"] == 0.5
