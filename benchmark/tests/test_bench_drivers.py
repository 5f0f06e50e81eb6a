"""Each driver through one tiny run on the CPU with the port's plain
versions: the result line's keys, `correct`, and no device metric."""
import pytest

from conftest import tiny_run


@pytest.mark.parametrize("workload", ["kodak-pipe", "kodak-single",
                                      "div2k-tiled", "train-256",
                                      "kodak-mixrate"])
def test_tiny_run(workload):
    r = tiny_run(workload)
    assert list(r) == ["correct", "attempted", "failed", "metrics", "device",
                       "checks"]
    assert r["correct"] and r["attempted"] > 0 and r["failed"] == 0
    assert r["metrics"] == {} and r["device"] == {"platform": "cpu"}
    assert all(c["value"] <= c["limit"] for c in r["checks"].values())


def test_run_refuses_without_the_devices(monkeypatch, capsys):
    import argparse

    import torch

    from common import harness
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = argparse.Namespace(workload="kodak-pipe", seed=1, seconds=1.0,
                              trace=0)
    assert harness.main(args) != 0
    out, _ = capsys.readouterr()
    assert out == ""
