"""The comparison sees `correct` come out false with the timed path broken
underneath (the harness's look for a card skipped, the rest of a run
driven on the CPU at the tiny size, with each cell's own limits): for the
codec cells an answer altered where it is produced (a reconstruction, a VQ
index); for the training cell a step that returns its state unchanged, a
step on half of the batch, and half of the batch in the steps after the
first alone (on a card, the replays of the captured step). One chip only:
no exchange between chips to leave out."""
import pytest
import torch

from conftest import tiny_run

CODEC_CELLS = ["kodak-pipe", "kodak-single", "div2k-tiled", "kodak-mixrate"]


@pytest.mark.parametrize("workload", CODEC_CELLS)
def test_altered_reconstruction(workload, monkeypatch):
    from control_gic_tpu_torch.models.cgic import CGIC
    decode = CGIC.decode_indices
    monkeypatch.setattr(CGIC, "decode_indices",
                        lambda self, ind, masks: decode(self, ind, masks)
                        + 0.1)
    r = tiny_run(workload)
    assert not r["correct"]
    assert r["checks"]["rec_vs_fp8"]["value"] > r["checks"]["rec_vs_fp8"][
        "limit"]


@pytest.mark.parametrize("workload", CODEC_CELLS)
def test_altered_index(workload, monkeypatch):
    from control_gic_tpu_torch.ops import quantize
    lookup = quantize.vq_lookup
    monkeypatch.setattr(quantize, "vq_lookup", lambda z, cb: (
        lookup(z, cb) + 1) % cb.shape[0])
    r = tiny_run(workload)
    assert not r["correct"]
    assert r["checks"]["index_diff"]["value"] > r["checks"]["index_diff"][
        "limit"]


def test_state_unchanged(monkeypatch):
    from control_gic_tpu_torch.train import step
    monkeypatch.setattr(step, "apply_gradients", lambda *a, **k: None)
    r = tiny_run("train-256")
    assert not r["correct"]
    assert r["checks"]["step_gap"]["value"] > 0.5


def test_half_batch(monkeypatch):
    from control_gic_tpu_torch.train import Trainer
    to_input = Trainer.to_input
    monkeypatch.setattr(Trainer, "to_input", staticmethod(
        lambda state, x: to_input(state, x)[: x.shape[0] // 2]))
    r = tiny_run("train-256")
    assert not r["correct"]
    assert any(c["value"] > c["limit"] for c in r["checks"].values())


def test_half_batch_in_replays(monkeypatch):
    """Half of the batch left out in the steps after the first, where the
    program on a card replays its captured step, the first step sound."""
    from control_gic_tpu_torch.train import Trainer
    to_input = Trainer.to_input
    calls = []

    def halved(state, x):
        calls.append(1)
        x = to_input(state, x)
        return x if len(calls) == 1 else x[: x.shape[0] // 2]

    monkeypatch.setattr(Trainer, "to_input", staticmethod(halved))
    r = tiny_run("train-256")
    assert not r["correct"]
    assert r["checks"]["loss_gap"]["value"] > r["checks"]["loss_gap"][
        "limit"]


def test_sound_runs_pass():
    for workload in CODEC_CELLS + ["train-256"]:
        assert tiny_run(workload, seed=11)["correct"], workload
