"""The reader of sn_kernel_share.codec on the port's counters: its
arithmetic, and None where nothing was counted or where the port has no
PLAIN_CALLS (an older checkout)."""
from common import harness
from control_gic_tpu_torch.ops import fused_norm


def read():
    return harness.load_module("metrics", "sn_kernel_share.codec").read({})


def test_share_of_apply_launches(monkeypatch):
    monkeypatch.setattr(fused_norm, "KERNEL_LAUNCHES",
                        {"gn_moments": 40, "spatial_norm_apply": 36})
    monkeypatch.setattr(fused_norm, "PLAIN_CALLS", {"spatial_norm": 0})
    assert read() == 100.0
    monkeypatch.setattr(fused_norm, "PLAIN_CALLS", {"spatial_norm": 12})
    assert read() == 75.0


def test_none_where_nothing_was_counted(monkeypatch):
    monkeypatch.setattr(fused_norm, "KERNEL_LAUNCHES",
                        {"gn_moments": 4, "spatial_norm_apply": 0})
    monkeypatch.setattr(fused_norm, "PLAIN_CALLS", {"spatial_norm": 0})
    assert read() is None


def test_none_without_the_counter(monkeypatch):
    monkeypatch.delattr(fused_norm, "PLAIN_CALLS")
    assert read() is None
