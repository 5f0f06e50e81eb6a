"""The host pipeline of the codec's batch paths: device results on their
way to the host (`_Fetch`) and the three-stage runner (`run_stages`) that
`CGICCodec.roundtrip_pipelined` and `parallel.tiling.compress_tiled_device`
both run on.

A batch (or an image) passes three stages: a uploads and dispatches the
device's encode, b waits for it, runs the host entropy stage and dispatches
the decode, c fetches the reconstruction. Threaded, stage a runs on the
caller's thread and b and c on a worker each, with bounded queues between
them, so that the host entropy stage of batch i runs beside the device's
encode of batch i+1; otherwise the stages run in turn on the caller's
thread, batch by batch.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, List, Optional

import numpy as np
import torch

from .utils.trace import span


def _put(q: "queue.Queue", name: str, item, root: span,
         batch: Optional[int] = None) -> None:
    """q.put(item); a put that blocks on a full queue is a queue_wait span
    of the pipeline `root`."""
    try:
        q.put_nowait(item)
    except queue.Full:
        with span("cgic.pipe.queue_wait", parent=root, batch=batch, queue=name,
                  op="put"):
            q.put(item)


def _get(q: "queue.Queue", name: str, root: span):
    """q.get(); a get that blocks on an empty queue is a queue_wait span of
    the pipeline `root`, with the batch index of the item it took."""
    try:
        return q.get_nowait()
    except queue.Empty:
        with span("cgic.pipe.queue_wait", parent=root, queue=name,
                  op="get") as sp:
            item = q.get()
            sp.batch = None if item is None else item[0]
        return item


class _Fetch:
    """Device tensors on their way to the host: pinned copies enqueued on
    the device's current stream behind the work that computes them, an
    event after that work (`sync`) and one after the copies (`arrays`). On
    the CPU, the tensors themselves. Both waits are device_wait spans, whose
    seconds go to stats[key] where given."""

    def __init__(self, *tensors: torch.Tensor):
        dev = tensors[0].device
        self.done = self.copied = None
        if dev.type != "cuda":
            self.host = tensors
            return
        stream = torch.cuda.current_stream(dev)
        self.done = torch.cuda.Event()
        self.done.record(stream)
        self.host = tuple(
            torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(
                t, non_blocking=True) for t in tensors)
        self.copied = torch.cuda.Event()
        self.copied.record(stream)

    def sync(self, stats: Optional[dict] = None,
             key: Optional[str] = None) -> None:
        """Wait for the work that computes the tensors."""
        with span("cgic.codec.device_wait", stats, key, wait="sync"):
            if self.done is not None:
                self.done.synchronize()

    def arrays(self, stats: Optional[dict] = None,
               key: Optional[str] = None) -> List[np.ndarray]:
        """Wait for the copies; the tensors as numpy arrays."""
        with span("cgic.codec.device_wait", stats, key, wait="copy"):
            if self.copied is not None:
                self.copied.synchronize()
            return [t.numpy() for t in self.host]


def run_stages(n: int, stage_a: Callable, stage_b: Callable,
               stage_c: Callable, *, root: span, threads: bool,
               depth: int, stats: dict) -> None:
    """Run items 0..n-1 through stage_a(i) -> stage_b(i, a) -> stage_c(i, b)
    inside the open span `root`. stats["threaded"] says which schedule ran
    (1.0 or 0.0); it is set before the first stage, so that it holds after
    an error too.

    Threaded (threads and n > 1): stage a on this thread, b and c on a
    daemon worker each, with queues of `depth` items between them, which
    bounds the device memory in flight. A None sentinel follows the last
    item down. The first error stops the dispatch of further items; the
    workers drain their queues so that no producer blocks on a dead
    consumer, are joined, and the error is raised here. Queue waits are
    cgic.pipe.queue_wait spans of `root`, each with the batch of its item.

    Otherwise stage_c(i, stage_b(i, stage_a(i))) for each i in turn."""
    threaded = bool(threads) and n > 1
    stats["threaded"] = float(threaded)
    if not threaded:
        for i in range(n):
            stage_c(i, stage_b(i, stage_a(i)))
        return
    qa: "queue.Queue" = queue.Queue(maxsize=depth)
    qb: "queue.Queue" = queue.Queue(maxsize=depth)
    errors: List[BaseException] = []

    def worker(q_in, name, stage, q_out):
        while True:
            item = _get(q_in, name, root)
            if item is None:
                if q_out is not None:
                    _put(q_out, "qb", None, root)
                return
            if errors:
                continue
            i, x = item
            try:
                y = stage(i, x)
                if q_out is not None:
                    _put(q_out, "qb", (i, y), root, i)
            except BaseException as e:   # raised on the caller's thread
                errors.append(e)

    tb = threading.Thread(target=worker, args=(qa, "qa", stage_b, qb),
                          daemon=True)
    tc = threading.Thread(target=worker, args=(qb, "qb", stage_c, None),
                          daemon=True)
    tb.start()
    tc.start()
    try:
        for i in range(n):
            if errors:
                break
            _put(qa, "qa", (i, stage_a(i)), root, i)
    finally:
        # unblock the workers even when stage a raised
        _put(qa, "qa", None, root)
        tb.join()
        tc.join()
    if errors:
        raise errors[0]
