"""The port's entry points turn TF32 off: float32 on the card means the FP32
pipes, as in the JAX package. Each entry point is called on the CPU with
both TF32 flags set to True beforehand; the flags are global, so the CPU
run shows what a CUDA run would find."""
import pytest
import torch

from control_gic_tpu_torch.cli import train as train_cli
from control_gic_tpu_torch.cli.common import build_codec
from control_gic_tpu_torch.models import CGICConfig
from control_gic_tpu_torch.train import TrainConfig, create_train_state
from test_torch_train_cli import _args, tiny_cfg, train_dir  # noqa: F401

torch.set_num_threads(2)

TINY = dict(n_embed=32, embed_dim=4, z_channels=4, ch=32,
            ch_mult=(1, 1, 2, 2, 2), num_res_blocks=1,
            attn_resolutions=(8,), resolution=64)


@pytest.fixture
def tf32_on(monkeypatch):
    """Both TF32 flags True for the test (PyTorch's cuDNN default), put back
    as they were afterwards."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)


def _tf32_flags():
    return (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)


def test_use_fp32_pipes(tf32_on):
    from control_gic_tpu_torch.utils.device import use_fp32_pipes
    assert _tf32_flags() == (True, True)
    use_fp32_pipes()
    assert _tf32_flags() == (False, False)


def test_build_codec_turns_tf32_off(tf32_on):
    build_codec(config=CGICConfig(**TINY), device="cpu")
    assert _tf32_flags() == (False, False)


def test_create_train_state_turns_tf32_off(tf32_on):
    create_train_state(CGICConfig(**TINY), TrainConfig(), device="cpu")
    assert _tf32_flags() == (False, False)


def test_train_main_turns_tf32_off(tf32_on, train_dir, tiny_cfg,  # noqa: F811
                                   tmp_path, monkeypatch):
    """The train CLI's main turns them off before it builds anything: the
    training state it creates would turn them off too, so the state's
    constructor is wrapped to record the flags it finds."""
    seen = []
    inner = train_cli.create_train_state

    def recording(*args, **kw):
        seen.append(_tf32_flags())
        return inner(*args, **kw)

    monkeypatch.setattr(train_cli, "create_train_state", recording)
    train_cli.main(_args(train_dir, tiny_cfg, tmp_path, steps=1))
    assert seen and seen[0] == (False, False)
    assert _tf32_flags() == (False, False)
