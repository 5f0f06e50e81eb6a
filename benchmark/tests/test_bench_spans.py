"""The readers of the span metrics (host_path_ms.single,
host_stage_ms.codec, upload_ms.codec) on synthetic span lists: their
arithmetic, waits nested under waits and under other spans, and None on an
empty store or a program without spans."""
import sys

import pytest

from common import harness
from control_gic_tpu_torch import utils
from control_gic_tpu_torch.utils import trace

NAMES = ("host_path_ms.single", "host_stage_ms.codec", "upload_ms.codec")


def S(name, i, parent, seconds, batch=None, **attrs):
    return trace.Span(name, 1, 0, 0, seconds, i, parent, 1, batch, attrs)


def read(name, spans, monkeypatch):
    monkeypatch.setattr(trace, "spans", lambda: list(spans))
    return harness.load_module("metrics", name).read({})


@pytest.mark.parametrize("name", NAMES)
def test_none_on_an_empty_store(name):
    trace.clear()
    assert harness.load_module("metrics", name).read({}) is None


@pytest.mark.parametrize("name", NAMES)
def test_none_without_the_trace_module(name, monkeypatch):
    """A port without the trace module (an older checkout) reads
    None, where the spans would give a number."""
    spans = [S("cgic.codec.roundtrip", 1, 0, 1.0, images=1),
             S("cgic.codec.compress", 2, 0, 0.02),
             S("cgic.pipe.a", 3, 1, 0.01),
             S("cgic.codec.upload", 4, 3, 0.01)]
    assert read(name, spans, monkeypatch) is not None
    monkeypatch.delattr(utils, "trace")
    monkeypatch.setitem(sys.modules, "control_gic_tpu_torch.utils.trace",
                        None)
    assert harness.load_module("metrics", name).read({}) is None


def test_host_path_single(monkeypatch):
    spans = [
        # request 1: 30 ms, of which 15 held by the device
        S("cgic.codec.compress", 1, 0, 0.030),
        S("cgic.codec.encode", 2, 1, 0.020),
        S("cgic.codec.upload", 3, 2, 0.004),
        S("cgic.programs.key", 10, 2, 0.001),
        S("cgic.programs.replay", 11, 2, 0.003),    # a blocked launch
        S("cgic.codec.device_wait", 4, 2, 0.010, wait="sync"),
        S("cgic.codec.device_wait", 5, 4, 0.001),   # under a wait: once
        S("cgic.codec.device_wait", 6, 1, 0.002, wait="copy"),
        # request 2: 20 ms, no wait
        S("cgic.codec.compress", 7, 0, 0.020),
        S("cgic.coding.frame", 8, 7, 0.005),
        # another root's wait does not count
        S("cgic.codec.device_wait", 9, 0, 0.5),
    ]
    assert read("host_path_ms.single", spans, monkeypatch) == \
        pytest.approx((15.0 + 20.0) / 2)


def test_host_stage_codec(monkeypatch):
    spans = [
        S("cgic.codec.roundtrip", 1, 0, 1.0, batches=2, images=4),
        S("cgic.tiling.compress", 20, 0, 1.0, images=1),
        # stage a: 0.050 s of work
        S("cgic.pipe.a", 2, 1, 0.020, batch=0),
        S("cgic.pipe.a", 3, 1, 0.030, batch=1),
        # stage b: 0.170 s less 0.060 of device waits and 0.020 of
        # replays = 0.090
        S("cgic.pipe.b", 4, 1, 0.100, batch=0),
        S("cgic.codec.device_wait", 5, 4, 0.040),
        S("cgic.coding.rebuild", 6, 4, 0.030),
        S("cgic.pipe.queue_wait", 7, 6, 0.010),     # nested under a child
        S("cgic.pipe.b", 8, 1, 0.070, batch=1),
        S("cgic.codec.device_wait", 9, 8, 0.010),
        S("cgic.codec.dispatch", 13, 8, 0.025),
        S("cgic.programs.replay", 14, 13, 0.020),   # a blocked launch
        # stage c: all waiting
        S("cgic.pipe.c", 10, 1, 0.200, batch=0),
        S("cgic.codec.device_wait", 11, 10, 0.200),
        # the queue waits between stages belong to the root
        S("cgic.pipe.queue_wait", 12, 1, 0.300),
    ]
    assert read("host_stage_ms.codec", spans, monkeypatch) == \
        pytest.approx(1e3 * 0.090 / 5)


def test_upload_codec(monkeypatch):
    spans = [
        S("cgic.codec.roundtrip", 1, 0, 1.0, images=16),
        S("cgic.pipe.a", 2, 1, 0.1),
        S("cgic.codec.upload", 3, 2, 0.012, bytes=2359296),
        S("cgic.codec.upload", 4, 5, 0.004, bytes=1000),
    ]
    assert read("upload_ms.codec", spans, monkeypatch) == \
        pytest.approx(1e3 * 0.016 / 16)
    # no root, no images: nothing to divide by
    assert read("upload_ms.codec", spans[1:], monkeypatch) is None
    assert read("host_stage_ms.codec", spans[1:], monkeypatch) is None
