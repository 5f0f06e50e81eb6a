"""BENCHMARK.json against the benchmark's contract, and every part of each
cell found by name."""
import json
import os
import re

import pytest

from conftest import BENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def manifest():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_keys_and_sizes(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert manifest["paths"] == ["benchmark"]
    assert manifest["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= manifest["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 64 * 1024
    runs = 2 + 14 * 24
    assert runs * (manifest["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_names_units_and_lines(manifest):
    names = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in manifest[group]:
            assert NAME.match(entry["name"]), entry["name"]
            names.add((group, entry["name"]))
            for key in ("why", "layer", "source"):
                if key in entry:
                    assert 1 <= len(entry[key]) <= 200
                    assert "\n" not in entry[key] and "\t" not in entry[key]
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({e["name"] for e in manifest[group]}) == len(
            manifest[group])


def test_cells(manifest):
    configs = {c["name"] for c in manifest["configs"]}
    pairs = set()
    for w in manifest["workloads"]:
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    used = {w["config"] for w in manifest["workloads"]}
    assert used == configs
    assert four_chip_cells_allowed(
        len(manifest["workloads"]),
        sum(w["chips"] == 4 for w in manifest["workloads"]))


def four_chip_cells_allowed(cells: int, four_chip: int) -> bool:
    """At most 25% of the cells, rounded down, ask for 4 chips; one always
    may."""
    return four_chip <= max(1, cells // 4)


@pytest.mark.parametrize("cells, four_chip, allowed", [
    (5, 1, True), (6, 1, True), (6, 2, False), (7, 2, False),
    (8, 2, True)])
def test_four_chip_rule(cells, four_chip, allowed):
    assert four_chip_cells_allowed(cells, four_chip) == allowed


def test_metrics(manifest):
    from common import harness
    e2e = {m["name"] for m in manifest["end_to_end"]}
    assert "setup_s" in e2e
    for m in manifest["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in manifest["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    layers = {}
    for w in manifest["workloads"]:
        chosen = harness.cell_metrics(manifest, w["name"], False)
        names = {m["name"] for m in chosen}
        assert "setup_s" in names and len(names) >= 2, w["name"]
        per_layer = harness.cell_metrics(manifest, w["name"], True)
        assert per_layer, w["name"]
        for m in per_layer:
            assert m["moves"] in names, (w["name"], m["name"])
            layers.setdefault(m["layer"], set()).add(m["name"])


def test_every_part_is_found_by_name(manifest):
    from common import harness
    for c in manifest["configs"]:
        assert c["file"].startswith("benchmark/")
        with open(os.path.join(ROOT, c["file"])) as f:
            json.load(f)
    for w in manifest["workloads"]:
        traffic = harness.load_json(BENCH, "traffic", f"{w['traffic']}.json")
        driver = harness.load_module("drivers", traffic["driver"])
        assert hasattr(driver, "Driver")
        limits = harness.load_json(BENCH, "limits", f"{w['name']}.json")
        assert limits["limits"]
    for m in manifest["per_layer"]:
        assert callable(harness.load_module("metrics", m["name"]).read)


def test_files_under_paths_are_named_from_name_characters():
    for dirpath, _, files in os.walk(BENCH):
        if "__pycache__" in dirpath:
            continue
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), ROOT)
            assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel
