"""The reader of flash_share.codec on the port's counters: its arithmetic,
and None where nothing was counted or where the port has no PLAIN_CALLS (an
older checkout)."""
from common import harness
from control_gic_tpu_torch.ops import attention


def read():
    return harness.load_module("metrics", "flash_share.codec").read({})


def _launches(fwd):
    return {"flash_fwd": fwd, "flash_fwd_lse": 3, "flash_bwd_dkdv": 3,
            "flash_bwd_dq": 3}


def test_share_of_forward_launches(monkeypatch):
    monkeypatch.setattr(attention, "KERNEL_LAUNCHES", _launches(24))
    monkeypatch.setattr(attention, "PLAIN_CALLS", {"attention": 0})
    assert read() == 100.0
    monkeypatch.setattr(attention, "PLAIN_CALLS", {"attention": 16})
    assert read() == 60.0


def test_none_where_nothing_was_counted(monkeypatch):
    monkeypatch.setattr(attention, "KERNEL_LAUNCHES", _launches(0))
    monkeypatch.setattr(attention, "PLAIN_CALLS", {"attention": 0})
    assert read() is None


def test_none_without_the_counter(monkeypatch):
    monkeypatch.delattr(attention, "PLAIN_CALLS")
    assert read() is None
