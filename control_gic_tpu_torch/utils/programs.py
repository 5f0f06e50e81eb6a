"""Compiled programs: the port's counterpart of `jax.jit` and its cache.

The JAX package runs each batch of the codec (encode, encode + pack, decode,
the tile programs) as one compiled program, traced once for each static key
and input shape. Here a `Program` holds one callable for one such key and
input signature:

  - its first call runs the callable eagerly, as a warm-up: the kernels are
    built at first use, the launchers set their attributes and look up
    `cuTensorMapEncodeTiled`, cuDNN and cuBLAS make their workspaces and the
    weight packs are cached (ops/norm_conv._cached). It then captures the
    callable once more, on copies of the inputs (the static inputs), and
    returns the warm-up's outputs;
  - every later call copies its inputs into the static inputs on the
    current stream, replays the capture there and returns clones of the
    static outputs. Without the clones the pipelined codec's batch k+1
    would overwrite batch k's reconstruction before its fetch.

A capture that fails raises; nothing falls back to eager. The capture
backend is an object of its own (`CUDAGraphs`), so that a test on the CPU
can put a stand-in in its place. With no backend (`graphs=False`, or a codec
on the CPU) every call runs eagerly, as under `jax.disable_jit()`.

Launch counts: the kernel wrappers count at each call
(`kernels.build.count_launch`; so does `fused_norm.spatial_norm` where it
runs its reference on a CUDA tensor, and so do the process group's
collectives, `parallel.multihost.COLLECTIVE_CALLS` and `COLLECTIVE_BYTES`),
and a replay calls no wrapper. So a program records the delta of every
registered counter (`build.COUNTERS`) over its capture, takes it back (the
warm-up and the capture together are one call) and adds it at each replay
(`build.add_launches`): the counts with graphs equal the counts without.

Memory: the programs of one codec share one memory pool. A pool for each
graph would hold every graph's intermediates at once, and a codec that
serves several modes and image shapes of the 130M-parameter model holds
dozens of programs (mode x shape x encode/decode). Sharing is safe because
every replay runs on the one current stream under the programs' lock, so
replays are serialised, and a replay's outputs are cloned before another
replay can run: memory that two graphs share only ever holds the
intermediates of the graph that runs, or outputs already cloned. Each
program keeps its static outputs alive, so no other graph is given their
memory.

Threads: the pipelined codec dispatches from two threads. A first call
(warm-up and capture) and every replay hold the programs' lock; launches
are serialised by the interpreter lock anyway, and no other thread can
launch a program while one is being captured. The capture is thread-local
(`capture_error_mode="thread_local"`), so the other threads' uploads,
fetches and event waits go on meanwhile.

The key of a program: JAX's static key, the inputs' shapes and dtypes, the
state that the port reads at call time and a capture would bake in (the
engagement switches, `ops.plain_versions()`, norm_conv's engagement rule and
`force_norm_conv`, the element and token gates, PyTorch's deterministic
and cuDNN flags), and a generation of the model's weights (the key that
the Trainer gives its steps also carries the process group whose
collectives they run, its rank, size and backend: a program captured
without a group is never replayed with one). A captured graph reads the weight packs its warm-up built,
so an in-place change of the weights (`load_state_dict`, an EMA swap) must
capture anew, not replay stale packs; JAX passes the weights as an argument
and gets this for free. A new generation drops every program of the old
one.

The training steps (train/step.py) are programs too, through a backend and
a pool of their own (`CUDAGraphs(side_stream_warm_up=True)`) and without a
model: their replays are what changes the weights, so the weights'
generation is not part of their key (it would capture at every step).
"""
from __future__ import annotations

import logging
import os
import threading
from typing import Callable, List, Optional

import torch

from .. import ops
from ..kernels import build
from ..ops import attention, fused_norm, norm_conv
from .trace import span

_LOG = logging.getLogger(__name__)

# the environment switches that ops/ and models/ read at call time
SWITCHES = ("CONTROL_GIC_FUSED_NORM", "CONTROL_GIC_STATS_KERNEL",
            "CONTROL_GIC_CHAIN", "CONTROL_GIC_NORM_CONV",
            "CONTROL_GIC_NORM_CONV_MIN_ELEMS", "CONTROL_GIC_SUBPIXEL",
            "CONTROL_GIC_FLASH_BWD")


def call_state() -> tuple:
    """What the dispatches read at call time, beyond the inputs; and
    PyTorch's algorithm choice (deterministic algorithms, cuDNN's
    deterministic and benchmark flags), which a capture bakes in too."""
    env = os.environ
    cudnn = torch.backends.cudnn
    return (tuple(env.get(k) for k in SWITCHES), ops._PLAIN.get(),
            norm_conv._RULE.get(), norm_conv._FORCED.get(),
            norm_conv.CHAIN_MIN_ELEMS, attention.FLASH_MIN_TOKENS,
            torch.are_deterministic_algorithms_enabled(),
            cudnn.deterministic, cudnn.benchmark)


def _launches() -> List[dict]:
    return [dict(c) for c in build.COUNTERS]


def _add_launches(delta: List[dict], sign: int = 1) -> None:
    for counts, d in zip(build.COUNTERS, delta):
        if d:
            build.add_launches(counts, {k: sign * v for k, v in d.items()})


def _map(fn, out):
    """fn on a tensor, or on each tensor of a tuple, list or dict of
    tensors."""
    if isinstance(out, torch.Tensor):
        return fn(out)
    if isinstance(out, dict):
        return {k: fn(t) for k, t in out.items()}
    return type(out)(fn(t) for t in out)


class CUDAGraphs:
    """The capture backend: a CUDA graph per program, captured on a side
    stream of `device` into one memory pool that all its captures share,
    and replayed on the caller's current stream. With
    side_stream_warm_up (programs with a backward: the training step), the
    warm-up runs on the side stream too, as PyTorch's whole-network capture
    requires: the autograd engine runs a backward op on its forward op's
    stream, and what the first run sets up per stream must be the
    capture's."""

    def __init__(self, device: torch.device,
                 side_stream_warm_up: bool = False):
        self.device = device
        self.side_stream_warm_up = side_stream_warm_up
        self._stream = None
        self._pool = None

    def _side_stream(self):
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
            self._pool = torch.cuda.graph_pool_handle()
        return self._stream

    def warm_up(self, fn: Callable, inputs: list):
        """fn(*inputs) run for real before its capture: on the caller's
        stream, or on the side stream with side_stream_warm_up, after which
        the allocator's cached blocks are released (empty_cache): a
        training step's activations are a large share of the card's
        memory, the capture needs as much again in its pool, and the
        allocator cannot release cached blocks while a capture runs (it
        fails instead)."""
        if not self.side_stream_warm_up:
            return fn(*inputs)
        side = self._side_stream()
        current = torch.cuda.current_stream(self.device)
        side.wait_stream(current)
        with torch.cuda.device(self.device), torch.cuda.stream(side):
            out = fn(*inputs)
        current.wait_stream(side)
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()
        return out

    def capture(self, fn: Callable, inputs: list):
        """(graph, static outputs) of fn(*inputs); raises if it cannot be
        captured (a host sync inside fn, for one)."""
        self._side_stream()
        # no work of the static inputs' copies or of the warm-up still runs
        torch.cuda.synchronize(self.device)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(self.device), torch.cuda.stream(self._stream):
            graph.capture_begin(pool=self._pool,
                                capture_error_mode="thread_local")
            try:
                outputs = fn(*inputs)
            except BaseException:
                try:
                    graph.capture_end()
                except RuntimeError:
                    pass   # the capture is invalid; the error below says why
                raise
            graph.capture_end()
        return graph, outputs

    @staticmethod
    def replay(graph) -> None:
        graph.replay()

    def memory(self) -> dict:
        """The device memory the allocator holds on the device, and the
        part of it in the shared pool's segments."""
        pool = None if self._pool is None else tuple(self._pool)
        return {"memory_reserved_bytes": torch.cuda.memory_reserved(
                    self.device),
                "pool_bytes": sum(
                    seg["total_size"] for seg in torch.cuda.memory_snapshot()
                    if tuple(seg.get("segment_pool_id", ())) == pool)}


class Program:
    """One callable for one key and input signature: the first call warms
    up and captures, later calls replay (see the module docstring)."""

    def __init__(self, fn: Callable, backend):
        self.fn = fn
        self.backend = backend
        self.graph = None
        self.inputs: Optional[list] = None
        self.outputs = None
        self.launches: Optional[List[dict]] = None

    def __call__(self, *inputs):
        if self.graph is None:
            warm_up = getattr(self.backend, "warm_up", None)
            out = (self.fn(*inputs) if warm_up is None       # the warm-up
                   else warm_up(self.fn, inputs))
            self.inputs = [x.clone() for x in inputs]
            before = _launches()
            try:
                self.graph, self.outputs = self.backend.capture(self.fn,
                                                                self.inputs)
            finally:
                self.launches = [{k: a[k] - b[k] for k in a if a[k] != b[k]}
                                 for a, b in zip(_launches(), before)]
                _add_launches(self.launches, -1)
            return out
        for static, x in zip(self.inputs, inputs):
            static.copy_(x, non_blocking=True)
        self.backend.replay(self.graph)
        _add_launches(self.launches)
        return _map(torch.clone, self.outputs)


class Programs:
    """A codec's programs: one cache (dict) per kind, as JAX keeps
    `_encode_fns`, `_encode_pack_fns`, `_decode_fns` and the tile programs,
    the capture backend (None: every call runs eagerly), the lock, and what
    the captures took: `captured` programs and `capture_s` seconds (warm-up
    included), the sum of the cgic.programs.capture spans. A program's key
    (and its lookup) is a cgic.programs.key span, a replay a
    cgic.programs.replay span."""

    def __init__(self, model: Optional[torch.nn.Module], backend=None):
        self.model = model
        self.backend = backend
        self.lock = threading.RLock()
        self.caches: List[dict] = []
        self.captured = 0
        self.capture_s = 0.0
        self._weights = None
        self._generation = 0

    def cache(self) -> dict:
        """A new cache of programs, keyed (JAX's key, the inputs' shapes and
        dtypes, call_state(), the weights' generation)."""
        c: dict = {}
        self.caches.append(c)
        return c

    def run(self, cache: dict, key: tuple, fn: Callable, *inputs):
        """fn(*inputs) through the program of `key` in `cache`: eagerly
        without a backend, else captured at the first call and replayed
        after it. fn must be the same computation for the same key."""
        if self.backend is None:
            return fn(*inputs)
        with self.lock:
            with span("cgic.programs.key"):
                full = (key, tuple((tuple(x.shape), x.dtype)
                                   for x in inputs),
                        call_state(), self._weights_generation())
                prog = cache.get(full)
            if prog is not None:
                with span("cgic.programs.replay"):
                    return prog(*inputs)
            with span("cgic.programs.capture") as sp:
                prog = Program(fn, self.backend)
                out = prog(*inputs)
            cache[full] = prog
            self.captured += 1
            self.capture_s += sp.seconds
            if _LOG.isEnabledFor(logging.INFO):
                _LOG.info("captured program %s: %s", key, self.stats())
            return out

    def stats(self) -> dict:
        """Programs captured, their seconds (warm-up included), and the
        backend's memory (on CUDA: memory reserved, and the shared pool's
        bytes)."""
        memory = getattr(self.backend, "memory", None)
        return {"programs_captured": self.captured,
                "capture_s": self.capture_s,
                **(memory() if memory is not None else {})}

    def clear(self) -> None:
        """Drop every program."""
        for c in self.caches:
            c.clear()

    def _weights_generation(self) -> int:
        """A number that changes when a parameter or buffer of the model is
        replaced or changed in place; a change drops every program. Without
        a model (programs that take the weights' changes as their work, the
        training steps) it stays 0."""
        if self.model is None:
            return 0
        stamp = tuple((t.data_ptr(), t._version)
                      for t in (*self.model.parameters(),
                                *self.model.buffers()))
        if stamp != self._weights:
            if self._weights is not None:
                self.clear()
            self._weights = stamp
            self._generation += 1
        return self._generation
