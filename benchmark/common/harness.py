"""One run of one cell: set-up, the measured window, the metrics, and the
comparison with the reference that decides `correct`.

Everything that belongs to one cell is found by name:
  BENCHMARK.json              the cell (config, traffic, chips), its metrics
  configs/<config>.json       the model as it is run (BENCHMARK.json names
                              the file)
  traffic/<traffic>.json      the traffic's parameters and its driver
  drivers/<driver>.py         the code that drives the program (`Driver`)
  limits/<cell>.json          the limit of each number the comparison reads
  metrics/<metric>.py         the reader of one per-layer metric (`read`)
so that a new configuration, traffic mix, cell or metric is a new file.

A driver (see drivers/) builds the program's objects in `setup`, serves one
closed-loop request in `request`, reports its end-to-end metrics and its
per-layer data, frees the program's state in `release`, and judges what the
window produced in `check`.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import os
import statistics
import sys
import time
from typing import Dict, List, Optional

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
FORBIDDEN = ("jax", "jaxlib", "flax", "control_gic_tpu")
GIB = float(1 << 30)


def process_start() -> float:
    """The wall-clock time at which this process started."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time()


def load_json(*parts: str) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """benchmark/<kind>/<name>.py as a module of its own."""
    path = os.path.join(BENCH_DIR, kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"bench_{kind}_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    """What a driver is given: the cell's name, its configuration file's
    contents, its traffic's parameters, the seed, the device, whether the
    window is traced, and the chips it takes."""
    name: str
    config: dict
    traffic: dict
    seed: int
    device: str
    trace: bool
    chips: int = 1


def find_cell(manifest: dict, name: str):
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; the cells are "
                         f"{sorted(cells)}")
    w = cells[name]
    config = {c["name"]: c for c in manifest["configs"]}[w["config"]]
    return w, config


def cell_metrics(manifest: dict, cell: str, trace: bool) -> List[dict]:
    """The cell's end-to-end metrics (trace off) or per-layer metrics (trace
    on): those that list the cell, or, without a list, every cell (an
    end-to-end metric) or every cell that reports the metric it moves (a
    per-layer one)."""
    e2e = [m for m in manifest["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in manifest["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in names
                             else [])]


def memory_peak_bytes() -> int:
    """The caching allocator's peak, graph pools included, read on the
    host (no trace reading: BENCHMARK.json gives `peak_mem_gib` the
    source host_clock, the host-side name an end-to-end metric may
    take)."""
    import torch
    return int(torch.cuda.max_memory_reserved())


def run(workload: str, seed: int, seconds: float, trace: bool, *,
        device: str = "cuda", manifest: Optional[dict] = None,
        config_override: Optional[dict] = None,
        traffic_override: Optional[dict] = None, log=print) -> dict:
    """One run of `workload`; returns the result line's object. On the CPU
    (device='cpu', tests only) it drives the plain versions and reports no
    device metric."""
    t_start = process_start()
    manifest = manifest or load_json(ROOT, "BENCHMARK.json")
    w, cfg_entry = find_cell(manifest, workload)
    config = load_json(ROOT, cfg_entry["file"])
    config.update(config_override or {})
    traffic = load_json(BENCH_DIR, "traffic", f"{w['traffic']}.json")
    traffic.update(traffic_override or {})
    limits = load_json(BENCH_DIR, "limits", f"{workload}.json")["limits"]
    cell = Cell(workload, config, traffic, seed, device, trace,
                w.get("chips", 1))
    on_card = device.startswith("cuda")

    import torch
    import control_gic_tpu_torch  # noqa: F401
    # from the process's start: the interpreter, torch and the port
    parts: Dict[str, float] = {"import_s": time.time() - t_start}
    if on_card:
        parts.update(load_libraries())
    driver = load_module("drivers", traffic["driver"]).Driver(cell)
    driver.setup(parts)
    setup_s = time.time() - t_start
    parts["setup_s"] = setup_s
    log("setup " + json.dumps(parts))

    attempted = failed = 0
    window = trace_obj = None
    if trace and on_card:
        from .trace import Trace
        trace_obj = Trace()
        with trace_obj.record():
            attempted, failed = serve(driver, traffic.get(
                "trace_seconds", seconds))
        window = trace_obj.window_s
    else:
        t0 = time.perf_counter()
        attempted, failed = serve(driver, seconds)
        if on_card:
            torch.cuda.synchronize()
        window = time.perf_counter() - t0

    metrics: Dict[str, dict] = {}
    dev: Dict[str, object] = {"platform": "gpu" if on_card else "cpu"}
    breakdown = None
    if on_card:
        peak = memory_peak_bytes()
        dev.update(kind=torch.cuda.get_device_name(0), count=cell.chips,
                   memory_peak_bytes=peak)
        values = dict(driver.end_to_end(window), setup_s=setup_s,
                      peak_mem_gib=peak / GIB)
        chosen = cell_metrics(manifest, workload, trace)
        if trace:
            data = dict(driver.layer_data(), window_s=window,
                        busy_s=trace_obj.busy_s,
                        device_ops=trace_obj.by_name(),
                        card=dev["kind"])
            values = {}
            for m in chosen:
                v = load_module("metrics", m["name"]).read(data)
                if v is not None:
                    values[m["name"]] = v
            dev.update(busy_s=trace_obj.busy_s, window_s=window)
            breakdown = trace_obj.breakdown()
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in chosen if m["name"] in values}

    driver.release()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    numbers = driver.check()
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    correct = failed == 0 and attempted > 0 and all(
        c["value"] <= c["limit"] for c in checks.values())
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result


def load_libraries() -> Dict[str, float]:
    """The kernels' libraries built (the first run in a checkout: nvcc, in
    parallel) and loaded, and the C++ entropy coder: 'library_s', and
    each build's seconds where one ran."""
    from concurrent.futures import ThreadPoolExecutor

    from control_gic_tpu_torch.coding.native_lib import get_native
    from control_gic_tpu_torch.kernels import build
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(build.SIGNATURES)) as ex:
        list(ex.map(build.load, build.SIGNATURES))
    if get_native() is None:
        raise RuntimeError("the C++ entropy coder did not build")
    out = {"library_s": time.perf_counter() - t0}
    out.update({f"nvcc_{k}_s": v[0] for k, v in build.BUILD_LOG.items()})
    return out


def serve(driver, seconds: float):
    """Closed loop: requests back to back until `seconds` have passed
    since the first began; (requests attempted, requests that raised)."""
    attempted = failed = 0
    t_end = time.perf_counter() + seconds
    while True:
        attempted += driver.items_per_request
        try:
            driver.request()
        except Exception as e:          # counted; the run is then not correct
            failed += driver.items_per_request
            print(f"request failed: {e!r}", file=sys.stderr)
        if time.perf_counter() >= t_end:
            return attempted, failed


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def main(args) -> int:
    import torch
    manifest = load_json(ROOT, "BENCHMARK.json")
    w, _ = find_cell(manifest, args.workload)
    chips = w.get("chips", 1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"this cell needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    log = lambda s: print(s, flush=True)
    result = run(args.workload, args.seed, args.seconds, bool(args.trace),
                 manifest=manifest, log=log)
    bad = forbidden_modules()
    if bad:
        print(f"the run loaded {bad}: the benchmark runs the PyTorch port "
              "alone", file=sys.stderr)
        return 3
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


def quantile(values, q: float) -> float:
    """The q-quantile (0 < q < 1) by linear interpolation."""
    v = sorted(values)
    if len(v) == 1:
        return v[0]
    return statistics.quantiles(v, n=100, method="inclusive")[round(q * 100)
                                                              - 1]
