"""The port's spans (utils/trace.py) on the CPU at a tiny config: nothing
kept while the profiler is off; under torch.profiler every stage span of
every batch or image of the threaded pipelines, on the worker threads, in
the root's request and under the root; the stats keys equal to the sums of
their spans; a span's start on the profiler's clock; the store cleared when
tracing turns on, and bounded; capture_s the sum of the capture spans."""
import sys
import threading
from collections import deque

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from control_gic_tpu_torch.codec import CGICCodec
from control_gic_tpu_torch.models import CGIC, CGICConfig
from control_gic_tpu_torch.parallel import tiling
from control_gic_tpu_torch.utils import trace
from control_gic_tpu_torch.utils.programs import Programs

torch.set_num_threads(2)

SMALL = dict(n_embed=32, embed_dim=4, z_channels=4, ch=32,
             ch_mult=(1, 1, 2, 2, 2), num_res_blocks=1,
             attn_resolutions=(8,), resolution=64)
TILE = 64


@pytest.fixture(scope="module")
def codec():
    torch.manual_seed(3)
    model = CGIC(CGICConfig(**SMALL))
    counts = np.random.default_rng(4).integers(1, 1000,
                                               size=SMALL["n_embed"])
    return CGICCodec(model, counts, device="cpu")


@pytest.fixture(scope="module")
def batches():
    rng = np.random.default_rng(8)
    return [rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
            for _ in range(3)]


@pytest.fixture(scope="module")
def images():
    """uint8 images of 128x96 (two tile shapes at TILE) and 100x120."""
    rng = np.random.default_rng(5)
    return [(rng.uniform(0, 1, (h, w, 3)) * 255).astype(np.uint8)
            for h, w in [(128, 96), (100, 120)]]


def traced(fn):
    """fn() under torch.profiler on this thread, after an untraced root
    (tracing then turns on, which clears the store): (result, the kept
    spans, the profiler)."""
    with trace.span("cgic.test.off"):
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, trace.spans(), prof


def by_name(spans, name):
    return [s for s in spans if s.name == name]


STAGES = ("cgic.pipe.a", "cgic.pipe.b", "cgic.pipe.c")
WAITS = ("cgic.codec.device_wait", "cgic.pipe.queue_wait",
         "cgic.programs.replay")


def stage_of(s, by_id):
    """The letter of the pipeline stage a span lies under, or None."""
    while s is not None and s.name not in STAGES:
        s = by_id.get(s.parent)
    return None if s is None else s.name[-1]


def test_nothing_kept_with_the_profiler_off(codec, batches, tmp_path):
    trace.clear()
    st = {}
    codec.compress(batches[0][0], 0.1, 0.4, out_dir=str(tmp_path), stats=st)
    codec.roundtrip_pipelined(batches, 0.1, 0.4, threads=True)
    assert trace.spans() == []
    # the stats are still taken
    assert st["entropy_s"] > 0 and st["files_s"] > 0
    assert codec.last_pipeline_stats["a_upload_s"] > 0


def _check_stages(spans, root_name, n):
    """Every stage span of each of the n batches (images), b and c on
    worker threads, in the root's request and under it; returns the
    root."""
    (root,) = by_name(spans, root_name)
    assert root.parent == 0 and root.attrs["images"] > 0
    main = threading.get_native_id()
    assert root.thread == main
    for stage in "abc":
        got = by_name(spans, f"cgic.pipe.{stage}")
        assert sorted(s.batch for s in got) == list(range(n)), stage
        for s in got:
            assert s.request == root.request and s.parent == root.id
            assert (s.thread == main) == (stage == "a"), stage
    ids = {s.id for s in spans}
    assert len(ids) == len(spans)
    for s in spans:
        assert s.request == root.request
        assert s is root or s.parent in ids
        assert root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns
    return root


def _check_sums(spans, stats):
    """Each seconds key of the stats equals the sum of the spans that
    feed it: a device wait by its stage and kind, the others by name."""
    by_id = {s.id: s for s in spans}

    def waits(stage, kind):
        return lambda s: (s.name == "cgic.codec.device_wait"
                          and s.attrs["wait"] == kind
                          and stage_of(s, by_id) == stage)

    def named(*names):
        return lambda s: s.name in names

    feeds = {"wall_s": named("cgic.codec.roundtrip", "cgic.tiling.compress"),
             "a_upload_s": named("cgic.pipe.a"),
             "b_sync_s": waits("b", "sync"), "b_fetch_s": waits("b", "copy"),
             "c_sync_s": waits("c", "sync"), "c_fetch_s": waits("c", "copy"),
             "b_frame_s": named("cgic.coding.frame"),
             "b_rebuild_s": named("cgic.coding.rebuild"),
             "b_h2d_dispatch_s": named("cgic.codec.dispatch")}
    keys = [k for k in stats if k.endswith("_s")]
    assert set(keys) <= set(feeds)
    for k in keys:
        got = [s.seconds for s in spans if feeds[k](s)]
        assert got, k
        assert stats[k] == pytest.approx(sum(got), rel=1e-9, abs=0), k


@pytest.mark.parametrize("device_pack", [False, True])
def test_roundtrip_threaded_spans(codec, batches, device_pack):
    (recs, encs), spans, _ = traced(lambda: codec.roundtrip_pipelined(
        batches, 0.1, 0.4, device_pack=device_pack, threads=True))
    assert len(recs) == len(batches)
    root = _check_stages(spans, "cgic.codec.roundtrip", len(batches))
    assert root.attrs == {"batches": 3, "images": 6}
    _check_sums(spans, codec.last_pipeline_stats)
    frames = by_name(spans, "cgic.coding.frame")
    assert sorted(s.batch for s in frames) == [0, 1, 2]
    assert sum(s.attrs["bytes"] for s in frames) == \
        codec.last_pipeline_stats["b_fetch_bytes"]
    by_id = {s.id: s for s in spans}
    waits = by_name(spans, "cgic.codec.device_wait")
    assert {(stage_of(s, by_id), s.attrs["wait"]) for s in waits} == {
        ("b", "sync"), ("b", "copy"), ("c", "sync"), ("c", "copy")}


def test_roundtrip_serial_spans(codec, batches):
    _, spans, _ = traced(lambda: codec.roundtrip_pipelined(
        batches, 0.1, 0.4, threads=False))
    (root,) = by_name(spans, "cgic.codec.roundtrip")
    assert {s.thread for s in spans} == {threading.get_native_id()}
    for stage in "abc":
        assert sorted(s.batch for s in by_name(spans, f"cgic.pipe.{stage}")
                      ) == [0, 1, 2]
    _check_sums(spans, codec.last_pipeline_stats)


@pytest.mark.parametrize("threads", [False, True])
def test_tiled_device_spans(codec, images, threads):
    out, spans, _ = traced(lambda: tiling.compress_tiled_device(
        codec, images, 0.1, 0.4, tile=TILE, out_uint8=True,
        threads=threads))
    assert len(out) == len(images)
    if threads:
        root = _check_stages(spans, "cgic.tiling.compress", len(images))
    else:
        (root,) = by_name(spans, "cgic.tiling.compress")
    assert root.attrs == {"images": 2}
    _check_sums(spans, codec.last_pipeline_stats)
    # each tile group's framing lies inside its rebuild
    rebuilds = {s.id for s in by_name(spans, "cgic.coding.rebuild")}
    frames = by_name(spans, "cgic.coding.frame")
    assert len(frames) == len(rebuilds) == 4
    assert all(s.parent in rebuilds for s in frames)
    uploads = by_name(spans, "cgic.codec.upload")
    assert sum(s.attrs["bytes"] for s in uploads
               if s.thread == threading.get_native_id()) > 0


def test_compress_stats_are_its_spans(codec, batches, tmp_path):
    st = {}
    _, spans, _ = traced(lambda: codec.compress(
        batches[0][0], 0.1, 0.4, out_dir=str(tmp_path), stats=st))
    (root,) = by_name(spans, "cgic.codec.compress")
    assert root.parent == 0
    one = lambda name: by_name(spans, name)[0].seconds
    assert st["entropy_s"] == one("cgic.coding.frame")
    assert st["files_s"] == one("cgic.codec.files")
    assert st["rebuild_s"] == one("cgic.coding.rebuild")
    assert st["encode_s"] == pytest.approx(
        one("cgic.codec.encode") - one("cgic.coding.frame"), rel=1e-9)
    assert st["decode_s"] == pytest.approx(
        one("cgic.codec.decode") - one("cgic.coding.rebuild"), rel=1e-9)
    # the request's host work: its seconds less the device waits under it
    (_, own), = trace.self_seconds(spans, "cgic.codec.compress", WAITS)
    waits = sum(s.seconds for s in by_name(spans, "cgic.codec.device_wait"))
    assert waits > 0
    assert own == pytest.approx(root.seconds - waits, rel=1e-9)
    assert own >= st["entropy_s"] + st["files_s"] + st["rebuild_s"]


def test_kept_under_a_profile_of_every_thread(codec, batches):
    """A profile of every thread leaves each thread's profiler state off,
    the caller's too: the request is traced all the same, and the workers'
    profiler ranges are in the profile."""
    from torch._C._profiler import _ExperimentalConfig
    with trace.span("cgic.test.off"):
        pass
    with profile(activities=[ProfilerActivity.CPU],
                 experimental_config=_ExperimentalConfig(
                     profile_all_threads=True)) as prof:
        codec.roundtrip_pipelined(batches, 0.1, 0.4, threads=True)
    spans = trace.spans()
    _check_stages(spans, "cgic.codec.roundtrip", len(batches))
    main = threading.get_native_id()
    workers = {s.thread for s in spans} - {main}
    assert len(workers) == 2
    names = [e.name for e in prof.events()]
    for stage in "abc":
        assert names.count(f"cgic.pipe.{stage}") == len(batches), stage


def test_span_start_on_the_profilers_clock(codec, batches):
    """A span's start lies within 1 ms of its range's event in the
    profile. The root opens no range."""
    _, spans, prof = traced(lambda: codec.compress(batches[0][0], 0.1, 0.4))
    (encode,) = by_name(spans, "cgic.codec.encode")
    events = prof.profiler.kineto_results.events()
    (event,) = [e for e in events if e.name() == "cgic.codec.encode"]
    assert abs(event.start_ns() - encode.start_ns) < 1_000_000
    assert not [e for e in events if e.name() == "cgic.codec.compress"]


def test_store_cleared_when_tracing_turns_on(codec, batches):
    _, first, _ = traced(lambda: codec.compress(batches[0][0], 0.1, 0.4))
    _, second, _ = traced(lambda: codec.compress(batches[1][0], 0.1, 0.4))
    assert len(first) == len(second) > 0
    assert len({s.request for s in second}) == 1
    assert {s.request for s in first}.isdisjoint(
        {s.request for s in second})


def test_store_bounded(codec, batches, monkeypatch):
    monkeypatch.setattr(trace, "_store", deque(maxlen=5))
    _, spans, _ = traced(lambda: codec.roundtrip_pipelined(
        batches, 0.1, 0.4, threads=True))
    assert len(spans) == 5
    # the newest are kept: the root ends last
    assert spans[-1].name == "cgic.codec.roundtrip"


class _Recorder:
    """A stand-in capture backend: capture and replay run the callable."""

    def capture(self, fn, inputs):
        return fn, fn(*inputs)

    def replay(self, graph):
        pass


def test_capture_s_is_the_capture_spans():
    programs = Programs(None, _Recorder())
    cache = programs.cache()

    def run(n):
        for k in range(n):
            programs.run(cache, (k % 2,), lambda x: x + 1, torch.zeros(2))

    _, spans, _ = traced(lambda: run(4))
    captures = by_name(spans, "cgic.programs.capture")
    replays = by_name(spans, "cgic.programs.replay")
    assert len(captures) == programs.captured == 2 and len(replays) == 2
    assert programs.capture_s == pytest.approx(
        sum(s.seconds for s in captures), rel=1e-9)


def test_threads_share_the_store():
    """Eight threads open spans under one traced root at once: every span
    kept once, with an id of its own."""
    root = trace.span("cgic.test.root")
    errors = []

    def worker(i):
        try:
            for j in range(200):
                with trace.span("cgic.test.child", parent=root, batch=i):
                    with trace.span("cgic.test.grandchild"):
                        pass
        except BaseException as e:   # reported on the test's thread
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with trace.span("cgic.test.off"):
            pass
        with profile(activities=[ProfilerActivity.CPU]):
            with root:
                threads = [threading.Thread(target=worker, args=(i,))
                           for i in range(8)]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(timeout=60)
                    assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert not errors
    spans = trace.spans()
    assert len(spans) == 8 * 200 * 2 + 1
    assert len({s.id for s in spans}) == len(spans)
    children = by_name(spans, "cgic.test.child")
    assert all(s.parent == root.id for s in children)
    ids = {s.id: s for s in children}
    for s in by_name(spans, "cgic.test.grandchild"):
        assert ids[s.parent].batch == s.batch


def test_self_seconds_nested_waits():
    S = lambda name, i, parent, sec: trace.Span(
        name, 1, 0, 0, sec, i, parent, 1, None, {})
    spans = [S("cgic.codec.compress", 1, 0, 10.0),
             S("cgic.codec.encode", 2, 1, 6.0),
             S("cgic.codec.device_wait", 3, 2, 2.0),
             # a wait inside a wait counts once
             S("cgic.pipe.queue_wait", 4, 3, 1.5),
             S("cgic.pipe.queue_wait", 5, 1, 1.0),
             S("cgic.coding.frame", 6, 1, 0.5)]
    (s, own), = trace.self_seconds(spans, "cgic.codec.compress", WAITS)
    assert s.id == 1 and own == pytest.approx(7.0)
    assert trace.self_seconds(spans, "cgic.coding.frame", WAITS)[0][1] == 0.5
    assert trace.self_seconds(spans, "cgic.pipe.b", WAITS) == []
    # only the names given are waits
    (_, own), = trace.self_seconds(spans, "cgic.codec.compress",
                                   ("cgic.pipe.queue_wait",))
    assert own == pytest.approx(10.0 - 1.5 - 1.0)
