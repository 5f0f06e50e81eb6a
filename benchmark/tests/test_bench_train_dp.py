"""The four-rank training cell's driver (drivers/train_dp.py) on the CPU,
with gloo and the small model: every rank runs rank 0's number of steps
and the replicas stay equal; a worker that dies makes rank 0 raise within
the timeouts, with no hang. The collectives' two readers on synthetic
data, and without the port's counters (the parent's port)."""
import time

import pytest

from conftest import TINY

TRAFFIC = {"image_hw": [64, 64], "pool": 16}


def make(seed: int, monkeypatch):
    """The driver's module and a Driver of the cell at the small size;
    its stall timer, which ends the process, far off (a loaded CPU may
    take minutes over a step here)."""
    from common import harness
    mod = harness.load_module("drivers", "train_dp")
    monkeypatch.setattr(mod, "STALL_S", 3600.0)
    m = harness.load_json(harness.ROOT, "BENCHMARK.json")
    w, entry = harness.find_cell(m, "train-dp4")
    config = {**harness.load_json(harness.ROOT, entry["file"]),
              "model": dict(TINY)}
    traffic = {**harness.load_json(harness.BENCH_DIR, "traffic",
                                   f"{w['traffic']}.json"), **TRAFFIC}
    return mod, mod.Driver(harness.Cell("train-dp4", config, traffic, seed,
                                        "cpu", False, w["chips"]))


def test_every_rank_runs_rank0s_steps(monkeypatch):
    """...and the workers' ends, once stop is posted, are no fault, however
    long rank 0's release takes after them (a traced run's state takes a
    while to free)."""
    from common import harness
    mod, d = make(2 ** 31 + 11, monkeypatch)
    exits = []
    d.watchdog.exit = exits.append
    monkeypatch.setattr(mod, "GRACE_S", 0.5)
    drop = mod.TS.Driver.release

    def slow(self):
        time.sleep(3.0)
        drop(self)

    monkeypatch.setattr(mod.TS.Driver, "release", slow)
    d.setup({})
    try:
        for _ in range(3):
            d.request()
    finally:
        d.release()
    assert d.rank_steps == [3] * 4
    assert d.replica_diff == 0.0
    assert all(p.returncode == 0 for p in d.workers) and not exits
    numbers = d.check()
    limits = harness.load_json(harness.BENCH_DIR, "limits",
                               "train-dp4.json")["limits"]
    assert all(numbers[k] <= limits[k] for k in limits), numbers


def test_a_dead_worker_makes_rank0_raise(monkeypatch):
    mod, d = make(5, monkeypatch)
    exits = []
    d.watchdog.exit = exits.append       # not this test process
    d.setup({})
    try:
        d.request()
        d.workers[0].kill()
        t0 = time.monotonic()
        with pytest.raises(Exception):
            for _ in range(20):         # a step, or the watchdog's look
                d.request()
        assert time.monotonic() - t0 < mod.WAIT_S
    finally:
        t0 = time.monotonic()
        d.release()
    assert time.monotonic() - t0 <= mod.EXIT_S + 10
    assert all(p.poll() is not None for p in d.workers)
    assert d.replica_diff == float("inf") and not exits


def test_readers_on_synthetic_data():
    from common import harness
    share = harness.load_module("metrics", "collective_share.dp").read
    roof = harness.load_module("metrics", "collective_roofline.dp").read
    # 521.4 MB all-reduced and 1 MB gathered over 4 ranks, at 450 GB/s a
    # direction: (1.5 * 521.4e6 + 0.75 * 1e6) / 450e9 = 1.7397 ms
    d = {"busy_s": 2.0, "ranks": 4, "link_bytes_s": 450e9,
         "collective_bytes": {"all_reduce": 521.4e6, "all_gather": 1e6},
         "device_ops": {"ncclDevKernel_AllReduce_Sum_f32_RING_LL": 0.003,
                        "ncclDevKernel_AllGather_RING_LL": 0.001,
                        "flash_bwd_dq": 1.0}}
    assert share(d) == pytest.approx(100.0 * 0.004 / 2.0)
    assert roof(d) == pytest.approx(100.0 * 1.7396667e-3 / 0.004, rel=1e-6)


def test_readers_without_counters():
    """The parent's port counts no collectives: both readers give None,
    whatever the trace holds; so does a trace with no NCCL kernel."""
    from common import harness
    d = {"busy_s": 2.0, "ranks": 4, "link_bytes_s": 450e9,
         "device_ops": {"ncclDevKernel_AllReduce_Sum_f32_RING_LL": 0.003}}
    quiet = {**d, "collective_bytes": {"all_reduce": 1e6},
             "device_ops": {"flash_bwd_dq": 1.0}}
    for name in ("collective_share.dp", "collective_roofline.dp"):
        read = harness.load_module("metrics", name).read
        assert read(d) is None and read(quiet) is None, name


def test_the_cell_reports_the_collectives_when_traced():
    from common import harness
    m = harness.load_json(harness.ROOT, "BENCHMARK.json")
    names = {x["name"] for x in harness.cell_metrics(m, "train-dp4", True)}
    assert {"collective_share.dp", "collective_roofline.dp", "mfu.train",
            "device_idle.train", "capture_s"} <= names
    assert {x["name"] for x in harness.cell_metrics(
        m, "train-dp4", False)} == {"train_img_s", "peak_mem_gib",
                                    "setup_s"}
