"""Spans: the port's one timing mechanism.

`with span(name, stats, key, **attrs):` times the block it encloses by two
reads of a monotonic clock and, given a stats dict and a key, adds the
seconds to stats[key]. Every seconds key of the codec's `stats=`, of
`last_pipeline_stats` and `Programs.capture_s` is such a sum.

A request is the tree of spans under a root: a span opened with no parent
on its thread and none given. It is traced when a profiler is on as the
root opens: torch.profiler's process-wide flag
(`torch.autograd.profiler._is_profiler_enabled`), or the profiler state of
the root's thread (`torch.autograd._profiler_enabled()`); that is one check
a request. (A profile of every thread, `profile_all_threads`, leaves each
thread's own state off, the caller's too, and sets the flag.) A traced
request's spans are kept in a bounded store in memory (`spans()`) with
their thread, start and end, id, parent's id, request id, batch or image
index and attributes (counts: bytes, images), and all but the root open a
profiler range of their name (`record_function`, in its cheaper form
`_RecordFunctionFast` where torch has it), so that a profiler trace shows
them. The root opens none: the store holds its extent, and a range over
the whole request would be the host event over every idle gap of the
device in a breakdown that names each gap by the host event over it. The
store is cleared when a root finds tracing on after one that found it off,
so that after a traced window it holds that window's spans alone.

Threads: a span's parent is the span open on its thread, or the one given
as `parent=`. A pipeline's worker thread gives its spans the request's root
as `parent=` and the batch index of the queue item it took; it reads no
profiler state of its own, since the profiler's callbacks are per thread
and `_profiler_enabled()` reads False on a thread started inside the
profiled window. A profile with `profile_all_threads` records the workers'
profiler ranges too.

Clock: a kept span's start and end are Unix-epoch nanoseconds, the clock
on which `torch.profiler` stamps its host and device events, so that a
span on any thread lines up with the device trace. They are its two reads
of the monotonic clock (whence its `seconds`, as the stats'), moved by the
epoch's offset from that clock as the request's root read it.
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import defaultdict, deque
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

MAX_SPANS = 1 << 16


class Span(NamedTuple):
    """A kept span. `parent` is 0 for a root."""
    name: str
    thread: int
    start_ns: int
    end_ns: int
    seconds: float
    id: int
    parent: int
    request: int
    batch: Optional[int]
    attrs: dict


class _Local(threading.local):
    span = None   # the span open on this thread

    def __init__(self):
        self.thread = threading.get_native_id()   # a system call: once


_store: deque = deque(maxlen=MAX_SPANS)
_local = _Local()
_ids = itertools.count(1)
_requests = itertools.count(1)
_was_on = False
_profiler_enabled = torch.autograd._profiler_enabled
_autograd_profiler = torch.autograd.profiler
_perf = time.perf_counter
# Unix-epoch ns less the monotonic clock's ns, read again at each traced
# root: a kept span's start and end are its monotonic reads moved by it
_epoch_ns = 0
# a profiler range: a RecordFunction of the span's name
_range = getattr(torch._C._profiler, "_RecordFunctionFast",
                 torch.profiler.record_function)


def _root_traced() -> bool:
    """Whether a profiler is on as a root opens on this thread; clears the
    store when it has turned on since the last root."""
    global _was_on, _epoch_ns
    on = _autograd_profiler._is_profiler_enabled or _profiler_enabled()
    if on:
        if not _was_on:
            _store.clear()
        _epoch_ns = time.time_ns() - int(_perf() * 1e9)
    _was_on = on
    return on


class span:
    """A timed block: see the module docstring. `parent`: the span this one
    belongs to, where it is not the one open on this thread (a worker's).
    `batch`: the batch or image index, else the parent's. Attributes may be
    set on `attrs` (and `batch`) before the block ends."""

    __slots__ = ("name", "stats", "key", "parent", "batch", "attrs",
                 "seconds", "traced", "id", "request", "_prev", "_t0", "_rf")

    def __init__(self, name: str, stats: Optional[dict] = None,
                 key: Optional[str] = None, *, parent: Optional["span"] = None,
                 batch: Optional[int] = None, **attrs):
        self.name = name
        self.stats = stats
        self.key = key
        self.parent = parent
        self.batch = batch
        self.attrs = attrs

    def __enter__(self) -> "span":
        prev = _local.span
        parent = self.parent if self.parent is not None else prev
        self._prev = prev
        _local.span = self
        if parent is None:
            self.traced = _root_traced()
            if self.traced:
                self.request = next(_requests)
        else:
            self.parent = parent
            self.traced = parent.traced
            if self.traced:
                self.request = parent.request
                if self.batch is None:
                    self.batch = parent.batch
                self._rf = _range(self.name)
                self._rf.__enter__()
        if self.traced:
            self.id = next(_ids)
        self._t0 = _perf()
        return self

    def __exit__(self, *exc) -> None:
        self.seconds = dt = _perf() - self._t0
        if self.stats is not None:
            self.stats[self.key] = self.stats.get(self.key, 0.0) + dt
        _local.span = self._prev
        if self.traced:
            parent = self.parent
            if parent is not None:
                self._rf.__exit__(None, None, None)
            start = _epoch_ns + int(self._t0 * 1e9)
            _store.append(Span(self.name, _local.thread, start,
                               start + int(dt * 1e9), dt, self.id,
                               0 if parent is None else parent.id,
                               self.request, self.batch, self.attrs))


def spans() -> List[Span]:
    """The kept spans, in the order they ended."""
    return list(_store)


def clear() -> None:
    _store.clear()


def self_seconds(records: List[Span], name: str, waits
                 ) -> List[Tuple[Span, float]]:
    """(span, self seconds) for each span named `name` in `records`: its
    seconds less those of the spans named in `waits` under it, at any
    depth. What lies under a wait is not subtracted again."""
    children: Dict[int, List[Span]] = defaultdict(list)
    for s in records:
        children[s.parent].append(s)
    out = []
    for s in records:
        if s.name != name:
            continue
        waited, todo = 0.0, list(children[s.id])
        while todo:
            c = todo.pop()
            if c.name in waits:
                waited += c.seconds
            else:
                todo.extend(children[c.id])
        out.append((s, s.seconds - waited))
    return out
