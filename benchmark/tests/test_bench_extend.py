"""A per-layer metric and a cell are added by new files alone: in a copy of
the benchmark, a new metric file and a new traffic and limits file (and
their entries in BENCHMARK.json) are found and run, with no file of the
copy edited."""
import json
import os
import shutil
import subprocess
import sys

from conftest import BENCH, ROOT

SCRIPT = r"""
import json, sys
sys.path[:0] = [sys.argv[1], sys.argv[1] + "/tests", sys.argv[2]]
from common import harness
from conftest import TINY, TINY_TRAFFIC
m = harness.load_json(harness.ROOT, "BENCHMARK.json")
names = [x["name"] for x in harness.cell_metrics(m, "kodak-pipe", True)]
assert "dummy_share" in names, names
value = harness.load_module("metrics", "dummy_share").read(
    {"busy_s": 1.0, "window_s": 4.0})
r = harness.run("kodak-pipe-b4", 3, 0.2, False, device="cpu",
                config_override={"model": dict(TINY)},
                traffic_override=dict(TINY_TRAFFIC["kodak-pipe"]),
                log=lambda s: None)
print(json.dumps({"value": value, "correct": r["correct"],
                  "attempted": r["attempted"]}))
"""


def test_new_metric_and_cell_by_files(tmp_path):
    copy = tmp_path / "checkout"
    shutil.copytree(BENCH, copy / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    manifest = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    before = {p: p.read_bytes() for p in (copy / "benchmark").rglob("*")
              if p.is_file()}
    # a metric: one new reader
    (copy / "benchmark" / "metrics" / "dummy_share.py").write_text(
        "def read(d):\n    return 100.0 * d['busy_s'] / d['window_s']\n")
    manifest["per_layer"].append(
        {"name": "dummy_share", "unit": "%", "better": "higher",
         "source": "device_trace", "layer": "device",
         "moves": "codec_mpix_s", "workloads": ["kodak-pipe"]})
    # a cell: kodak-pipe's traffic at batch 4, with its limits
    traffic = json.load(open(os.path.join(BENCH, "traffic",
                                          "kodak-pipe.json")))
    traffic["batch"] = 4
    (copy / "benchmark" / "traffic" / "kodak-pipe-b4.json").write_text(
        json.dumps(traffic))
    shutil.copy(os.path.join(BENCH, "limits", "kodak-pipe.json"),
                copy / "benchmark" / "limits" / "kodak-pipe-b4.json")
    manifest["workloads"].append(
        {"name": "kodak-pipe-b4", "config": "cgic-codec-bf16",
         "traffic": "kodak-pipe-b4", "chips": 1, "why": "batches of 4"})
    (copy / "BENCHMARK.json").write_text(json.dumps(manifest))
    out = subprocess.run(
        [sys.executable, "-c", SCRIPT, str(copy / "benchmark"), ROOT],
        capture_output=True, text=True, timeout=600, cwd=copy)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"value": 25.0, "correct": True, "attempted": got[
        "attempted"]} and got["attempted"] > 0
    after = {p: p.read_bytes() for p in before}
    assert after == before
