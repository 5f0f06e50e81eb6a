#!/usr/bin/env python3
"""The readings that the limits of `correct` are set from, on the card.

    python3 benchmark/checks/readings.py --workload <cell> \
        --seeds 11 12 ... [--seconds 5] [--control-seeds 11 12 13] \
        [--fault half_batch | next_point]

For each of --seeds, one run of the cell in this process (set-up, a short
window at the cell's own load, the comparison), printing the numbers the
comparison read: the lower readings, from sound runs of the program. For
each of --control-seeds, the control in the program's place at the cell's
size, judged the same way: the reference computed a precision below the
configuration's (fp8 for the bf16 codec: each operand of every product
rounded to float8 e4m3 with one scale per tensor; TF32 for the f32
training step), and with --fault half_batch (training) the reference
stepped on half of each batch in the replayed steps 2-4; with --fault
next_point (a cell with several operating points) a run of the program
whose every unit is judged at the next point's ratios, the last point's at
the first's. Those are the upper readings. One JSON line per reading:
{"kind": "program" | "control" | "<fault>", "seed", "numbers"}.
"""
import argparse
import gc
import json
import os
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, BENCH)
sys.path.insert(1, os.path.dirname(BENCH))

import torch  # noqa: E402

from common import harness  # noqa: E402
from reference import coder as C  # noqa: E402
from reference import judge  # noqa: E402
from reference import model as R  # noqa: E402


def cell_for(workload: str, seed: int, device: str,
             config_override=None, traffic_override=None):
    manifest = harness.load_json(harness.ROOT, "BENCHMARK.json")
    w, entry = harness.find_cell(manifest, workload)
    config = harness.load_json(harness.ROOT, entry["file"])
    config.update(config_override or {})
    traffic = harness.load_json(harness.BENCH_DIR, "traffic",
                                f"{w['traffic']}.json")
    traffic.update(traffic_override or {})
    cell = harness.Cell(workload, config, traffic, seed, device, False)
    return harness.load_module("drivers", traffic["driver"]).Driver(cell)


def codec_control(driver, prec: R.Prec) -> dict:
    """The reference at `prec` in the program's place, over the images a
    run's comparison takes (the tiled cell's tiles one by one), judged
    against the reference in f32."""
    from common.codec_cell import model_dict, reference_params
    c = driver.cell
    driver.make_inputs()
    cfg = model_dict(c.config)
    params = reference_params(c.config, c.seed, c.device)
    coder = C.Coder(driver.counts)
    tile = driver.t.get("tile")
    grid = harness.load_module("drivers", "codec_tiled").tile_grid
    units = []
    R.fp32_pipes(True)
    for i, ratios in driver.control_items():
        mode = R.mode_of(*ratios)
        img = driver.pool[i]
        h, w = img.shape[:2]
        for y, x, th, tw in grid(h, w, tile) if tile else [(0, 0, h, w)]:
            part = img[y:y + th, x:x + tw]
            xt = torch.from_numpy(part).to(c.device).permute(2, 0, 1)[None]
            with torch.no_grad():
                ind, masks, _ = R.encode(xt.float() / 255.0, params, cfg,
                                         ratios, prec)
                rec = R.decode(ind, masks, params, cfg, prec)
            masks = [m[0].cpu().numpy() for m in masks]
            streams = C.encode_streams(coder, ind[0].cpu().numpy(), masks,
                                       mode)
            bits = 8 * sum(len(s) for s in streams.values())
            out = (rec[0].permute(1, 2, 0).cpu().numpy()
                   if driver.t["driver"] == "codec_single"
                   else R.to_uint8(rec)[0].cpu().numpy())
            units.append({"image": part, "streams": streams, "mode": mode,
                          "bpp": bits / (th * tw), "rec": out,
                          "ratios": ratios})
    return judge.judge_codec(units, params, cfg, driver.counts,
                             driver.ratios, c.device)


def judged_at_next_point(points):
    """judge.judge_codec with each unit's ratios replaced by the next
    point's: the control of a cell that serves several points."""
    points = [tuple(float(r) for r in p) for p in points]
    after = {p: points[(k + 1) % len(points)] for k, p in enumerate(points)}
    judge_codec = judge.judge_codec

    def shifted(units, *args, **kw):
        return judge_codec([dict(u, ratios=after[tuple(u["ratios"])])
                            for u in units], *args, **kw)
    return shifted


def train_control(driver, kind: str) -> dict:
    """The reference in TF32 ('control'), or on half of each batch in the
    replayed steps 2-4 ('half_batch'), in the program's place, judged
    against the reference in f32 as the program is: step 1 from the seed,
    each later step from the stepped side's own state before it. Also the
    numbers per step (`judge.step_numbers`)."""
    from reference import train as T
    make_params = harness.load_module("drivers", "train_step").make_params
    c = driver.cell
    driver.make_inputs()
    batches = driver.first_batches()
    cfg, ratios = c.config["model"], tuple(c.config["ratios"])
    params = make_params(c.config, c.seed, c.device)
    R.fp32_pipes(kind != "control")
    prog = judge.stepped_readings(
        T.State(params["gen"], params["disc"], params["lpips"]), batches,
        cfg, ratios, half_batch_replays=kind == "half_batch")
    R.fp32_pipes(True)
    ref = judge.reference_readings(params, prog["states"], batches, cfg,
                                   ratios)
    return {**judge.judge_train(prog, ref),
            "per_step": judge.step_numbers(prog, ref)}


def next_point_run(workload: str, seed: int, seconds: float,
                   device: str) -> dict:
    """A run of the program, every unit judged at the next point's ratios
    (judged_at_next_point)."""
    manifest = harness.load_json(harness.ROOT, "BENCHMARK.json")
    w, _ = harness.find_cell(manifest, workload)
    points = harness.load_json(harness.BENCH_DIR, "traffic",
                               f"{w['traffic']}.json")["points"]
    judge_codec = judge.judge_codec
    judge.judge_codec = judged_at_next_point(points)
    try:
        r = harness.run(workload, seed, seconds, False, device=device,
                        log=lambda s: None)
    finally:
        judge.judge_codec = judge_codec
    gc.collect()
    if device.startswith("cuda"):
        torch.cuda.empty_cache()
    return {"correct": r["correct"],
            **{k: v["value"] for k, v in r["checks"].items()}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fault", choices=("half_batch", "next_point"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    looks = {}
    judge_train = judge.judge_train

    def judged(prog, ref):
        # the training numbers per step, for sound runs
        looks["per_step"] = judge.step_numbers(prog, ref)
        return judge_train(prog, ref)

    judge.judge_train = judged
    for seed in args.seeds:
        looks.clear()
        r = harness.run(args.workload, seed, args.seconds, False,
                        device=args.device, log=lambda s: None)
        print(json.dumps({"kind": "program", "seed": seed,
                          "correct": r["correct"],
                          "numbers": {**{k: v["value"] for k, v in
                                         r["checks"].items()}, **looks},
                          "metrics": {k: v["value"] for k, v in
                                      r["metrics"].items()}}), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    kinds = ["control"] + ([args.fault] if args.fault else [])
    for seed in args.control_seeds:
        for kind in kinds:
            if kind == "next_point":
                numbers = next_point_run(args.workload, seed, args.seconds,
                                         args.device)
                print(json.dumps({"kind": kind, "seed": seed,
                                  "numbers": numbers}), flush=True)
                continue
            d = cell_for(args.workload, seed, args.device)
            if d.cell.traffic["driver"] == "train_step":
                numbers = train_control(d, kind)
            else:
                numbers = codec_control(d, R.Prec("fp8"))
            print(json.dumps({"kind": kind, "seed": seed,
                              "numbers": numbers}), flush=True)
            del d
            gc.collect()
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
