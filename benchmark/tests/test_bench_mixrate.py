"""kodak-mixrate on the CPU at the tiny size: the schedule of points, the
set-up that captures every point's programs so that the window captures
none, the comparison at each unit's own point, and its two controls (each
unit judged at the next point's ratios; the reference in fp8 in the
program's place)."""
import itertools

import pytest
import torch

from common import harness
from conftest import TINY, TINY_TRAFFIC, tiny_run
from reference import judge
from reference.model import mode_of

CELL = "kodak-mixrate"
POINTS = [tuple(p) for p in TINY_TRAFFIC[CELL]["points"]]


def driver_module():
    return harness.load_module("drivers", "codec_mixrate")


def tiny_driver(seed=2 ** 31 + 7):
    """The cell's driver at the tiny size, not yet set up."""
    readings = harness.load_module("checks", "readings")
    return readings.cell_for(CELL, seed, "cpu", {"model": dict(TINY)},
                             TINY_TRAFFIC[CELL])


def test_tiny_points_cover_modes_0_to_3():
    assert {mode_of(*p) for p in POINTS} == {0, 1, 2, 3}
    traffic = harness.load_json(harness.BENCH_DIR, "traffic",
                                f"{CELL}.json")
    assert {mode_of(*p) for p in traffic["points"]} == {0, 1, 2, 3}
    assert len(traffic["points"]) == 9


@pytest.mark.parametrize("seed", [0, 11, 2 ** 31 + 7, 2 ** 40 + 3])
def test_schedule_rounds_and_seed(seed):
    schedule = driver_module().schedule
    calls = list(itertools.islice(schedule(seed, 9), 45))
    for r in range(5):
        assert sorted(calls[9 * r:9 * r + 9]) == list(range(9))
    assert calls == list(itertools.islice(schedule(seed, 9), 45))
    assert calls != list(itertools.islice(schedule(seed + 1, 9), 45))


class Recorder:
    """A stand-in capture backend: a 'capture' runs the callable and keeps
    it, a 'replay' runs it again into the static outputs."""

    def capture(self, fn, inputs):
        out = fn(*inputs)
        return (fn, inputs, out), out

    def replay(self, graph):
        fn, inputs, out = graph
        new = fn(*inputs)
        for o, n in ([(out, new)] if isinstance(out, torch.Tensor)
                     else zip(out, new)):
            o.copy_(n)


def test_set_up_captures_every_program_and_the_window_none(monkeypatch):
    from control_gic_tpu_torch.codec import CGICCodec
    init = CGICCodec.__init__

    def recorded(self, *a, **k):
        init(self, *a, **k)
        self._programs.backend = Recorder()

    monkeypatch.setattr(CGICCodec, "__init__", recorded)
    d = tiny_driver()
    parts = {}
    d.setup(parts)
    # an encode + pack program a point, a decode program a mode
    assert parts["programs"] == len(POINTS) + len({mode_of(*p)
                                                   for p in POINTS})
    attempted, failed = harness.serve(d, 0.5)
    assert attempted > 0 and failed == 0
    assert d.codec._programs.captured == parts["programs"]
    assert d.mixrate()["programs_window"] == 0


def test_tiny_cell_judges_each_point_at_its_ratios(monkeypatch):
    seen = []
    judge_codec = judge.judge_codec

    def recording(units, *a, **k):
        seen.extend(units)
        return judge_codec(units, *a, **k)

    monkeypatch.setattr(judge, "judge_codec", recording)
    r = tiny_run(CELL)
    assert r["correct"], r["checks"]
    assert seen
    per_point = {}
    for u in seen:
        assert u["mode"] == mode_of(*u["ratios"])
        per_point[u["ratios"]] = per_point.get(u["ratios"], 0) + 1
    assert set(per_point) <= set(POINTS)
    assert max(per_point.values()) == TINY_TRAFFIC[CELL].get(
        "check_per_point", 1)


def test_sample_one_image_a_point_from_the_seed():
    d = tiny_driver(5)
    keys = [(p, i) for p in range(len(POINTS)) for i in range(6)]
    a, b = d.sample(keys), d.sample(list(reversed(keys)))
    assert a == b and [p for p, _ in a] == list(range(len(POINTS)))
    assert d.sample([(2, 4), (2, 1)]) in ([(2, 1)], [(2, 4)])


def test_units_judged_at_the_next_point_fail(monkeypatch):
    readings = harness.load_module("checks", "readings")
    monkeypatch.setattr(judge, "judge_codec",
                        readings.judged_at_next_point(POINTS))
    r = tiny_run(CELL)
    assert not r["correct"]
    c = r["checks"]
    assert (c["grain_diff"]["value"] > c["grain_diff"]["limit"]
            or c["stream_errors"]["value"] > c["stream_errors"]["limit"])


def test_fp8_control_fails():
    readings = harness.load_module("checks", "readings")
    from reference import model as R
    numbers = readings.codec_control(tiny_driver(3), R.Prec("fp8"))
    limits = harness.load_json(harness.BENCH_DIR, "limits",
                               f"{CELL}.json")["limits"]
    assert numbers["stream_errors"] == 0 and numbers["grain_diff"] == 0
    assert any(numbers[k] > v for k, v in limits.items()), numbers


def test_unit_without_ratios_is_judged_at_the_cells():
    from common import codec_cell, images, weights
    from control_gic_tpu_torch.codec import CGICCodec
    config = {"model": dict(TINY)}
    params = codec_cell.reference_params(config, 9, "cpu")
    counts = images.skewed_counts(TINY["n_embed"], 20.0, 1)
    codec = CGICCodec(codec_cell.make_model(config, 9, "cpu"), counts,
                      device="cpu")
    img = images.make_images(1, 64, 96, weights.generator(9, 1, "cpu"),
                             "cpu")[0].numpy()

    def unit(ratios):
        rec, bpp, enc = codec.compress(img, *ratios)
        return {"image": img, "streams": enc.streams, "mode": enc.mode,
                "bpp": bpp, "rec": rec}

    at = lambda units, ratios: judge.judge_codec(units, params, TINY, counts,
                                                 ratios, "cpu")
    plain = unit((0.1, 0.4))
    assert at([plain], (0.1, 0.4)) == at([dict(plain, ratios=(0.1, 0.4))],
                                         (0.5, 0.5))
    other = unit((0.3, 0.0))
    assert at([other], (0.3, 0.0)) == at([dict(other, ratios=(0.3, 0.0))],
                                         (0.1, 0.4))
    # judged at another point than served: not correct
    wrong = at([other], (0.1, 0.4))
    assert wrong["stream_errors"] >= 1 or wrong["grain_diff"] > 0
