"""The training recipe as published: `ranks` processes, one card each,
joined by NCCL, each running `Trainer(group=)`'s step as CUDA graphs (the
group's collectives captured in them) on its `batch_per_rank` rows of each
global batch, back to back (closed loop), paced by rank 0. The step, the
inputs and the readings are train_step's (drivers/train_step.py), which
this driver extends.

Ranks. The harness's process is rank 0 on cuda:0. `setup` starts ranks
1..n-1 as subprocesses on cuda:1..n-1 (after the harness has built and
loaded the kernels' libraries, so that one process builds them), waits for
them on a store of its own (a TCPStore on localhost: a rank that has not
joined within JOIN_S raises, a rank that exits first raises at once) and
joins them in the process group with `multihost.initialize_multihost`.
Every rank makes the same weights, pool and global order from the seed;
rank r takes rows [r b, (r + 1) b) of each global batch of n b.

Lockstep. Before each of the window's steps rank 0 posts `go` on the
store under the step's number, and `release` posts `stop`; the other ranks
wait for each post (`command`: a wait raises after WAIT_S and is taken up
again only while rank 0 runs), so that every rank runs rank 0's number of
steps, with no device synchronisation a step.

Nothing hangs. The group has torch's default timeout. On each rank a
watchdog (`Watchdog`) notices a rank that has gone (on rank 0: a worker
that exited before `stop`; on a worker: rank 0): `request` then raises,
and a process that has not begun `release` GRACE_S later exits with
status 1. A rank that makes no progress for STALL_S (its host
blocked on a card that waits inside a graph for a dead rank's collective,
which no timeout reaches) prints its threads' stacks and exits with status
1. `release` posts stop, drops the state with its captured steps before
the group, and kills the workers still running after EXIT_S.

`correct`. Rank 0's readings of the first four steps, as train_step takes
them (its Adam moments hold the global batch's gradient, its metrics and
codebook counts are the group's), against the reference on the global
batches in one process (`reference.judge`); and `replica_diff`: after the
window, the largest absolute difference of any rank's generator and
discriminator tensors (parameters and running statistics) from rank 0's.
"""
from __future__ import annotations

import dataclasses
import datetime
import faulthandler
import gc
import json
import os
import socket
import subprocess
import sys
import threading
import time
from typing import Callable, List, Optional

import torch
import torch.distributed as dist

from common import collectives, harness

TS = harness.load_module("drivers", "train_step")

JOIN_S = 300.0    # a rank that has not joined by then: setup raises
WAIT_S = 120.0    # a store wait longer than this raises
STALL_S = 300.0   # no progress for this long is a fault
GRACE_S = 30.0    # a fault's process exits this long after, unless released
EXIT_S = 30.0     # release kills the workers still running after this

WORKER = ("import sys; sys.path[:0] = sys.argv[1:3]; "
          "from common import harness; "
          "harness.load_module('drivers', 'train_dp').worker_main("
          "sys.argv[3:])")


def log(msg: str) -> None:
    print(f"train_dp: {msg}", file=sys.stderr, flush=True)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class Watchdog:
    """Two guards. A thread looks every second for a rank that has gone
    (`gone()` returning a message), keeps the first such fault in `fault`
    (which `check()` raises) and, unless `stop()` comes within GRACE_S,
    calls `exit(1)`. And `faulthandler`'s timer, re-armed at each `beat()`:
    no beat for STALL_S prints every thread's stack and exits with status
    1. The timer needs no interpreter lock, so it fires where a thread
    cannot: while the main thread blocks in a kernel launch on a card
    that waits for a dead rank."""

    def __init__(self, gone: Callable[[], Optional[str]],
                 exit: Callable[[int], None] = os._exit):
        self.gone = gone
        self.exit = exit
        self.fault: Optional[str] = None
        self._done = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="train_dp-watchdog")

    def start(self) -> None:
        self.beat()
        self._thread.start()

    def beat(self) -> None:
        faulthandler.dump_traceback_later(STALL_S, file=sys.__stderr__,
                                          exit=True)

    def check(self) -> None:
        if self.fault is not None:
            raise RuntimeError(self.fault)

    def stop(self) -> None:
        """The thread ends (the timer stays armed)."""
        self._done.set()
        if self._thread.is_alive():
            self._thread.join()

    @staticmethod
    def disarm() -> None:
        faulthandler.cancel_dump_traceback_later()

    def _run(self) -> None:
        while not self._done.wait(1.0):
            fault = self.gone()
            if fault is None:
                continue
            self.fault = fault
            if not self._done.wait(GRACE_S):
                log(f"{fault}; exiting")
                self.exit(1)
            return


class Driver(TS.Driver):

    def __init__(self, cell, rank: int = 0, ports: Optional[tuple] = None):
        t = cell.traffic
        super().__init__(dataclasses.replace(
            cell, traffic={**t, "batch": t["batch_per_rank"]}))
        self.ranks = t["ranks"]
        self.rank = rank
        self.ports = ports or (free_port(), free_port())
        self.items_per_request = self.batch * self.ranks
        self.on_card = cell.device.startswith("cuda")
        self.device = (torch.device("cuda", rank) if self.on_card
                       else torch.device(cell.device))
        self.workers: List[subprocess.Popen] = []
        self.store = self.group = None
        self.posted = 0
        self.sound = False     # set up, and no request has raised since
        self.counted = None
        self.replica_diff = float("inf")
        self.rank_steps: List[int] = []
        self.watchdog = Watchdog(self.gone)
        self._ppid = os.getppid()

    # ------------------------------------------------------------- ranks

    def gone(self) -> Optional[str]:
        if self.rank:
            return ("rank 0 is gone" if os.getppid() != self._ppid
                    else None)
        for r, p in enumerate(self.workers, start=1):
            if p.poll() is not None:
                return f"rank {r} exited with status {p.returncode}"
        return None

    def start_workers(self) -> None:
        for r in range(1, self.ranks):
            cell = dataclasses.replace(
                self.cell, device=f"cuda:{r}" if self.on_card
                else self.cell.device, trace=False)
            self.workers.append(subprocess.Popen(
                [sys.executable, "-c", WORKER, harness.BENCH_DIR,
                 harness.ROOT, str(r), json.dumps(dataclasses.asdict(cell)),
                 str(self.ports[0]), str(self.ports[1])],
                cwd=harness.ROOT, stdout=2))

    def join(self) -> None:
        """The store (every rank on it within JOIN_S), then the group."""
        from control_gic_tpu_torch.parallel import multihost
        self.store = dist.TCPStore(
            "localhost", self.ports[0], self.ranks, self.rank == 0,
            timeout=datetime.timedelta(seconds=JOIN_S),
            wait_for_workers=False)
        if self.rank:
            self.store.add("joined", 1)
        else:
            t_end = time.monotonic() + JOIN_S
            while self.store.add("joined", 0) < self.ranks - 1:
                fault = self.gone()
                if fault is not None:
                    raise RuntimeError(f"{fault} before joining")
                if time.monotonic() > t_end:
                    raise TimeoutError(f"the ranks did not join within "
                                       f"{JOIN_S:.0f} s")
                time.sleep(0.1)
        self.store.set_timeout(datetime.timedelta(seconds=WAIT_S))
        self.group = multihost.initialize_multihost(
            f"localhost:{self.ports[1]}", self.ranks, self.rank,
            backend="nccl" if self.on_card else "gloo", device=self.device)

    def setup(self, parts: dict) -> None:
        t0 = time.perf_counter()
        try:
            if self.rank == 0:
                self.start_workers()
            self.join()
            parts["join_s"] = time.perf_counter() - t0
            self.watchdog.start()
            super().setup(parts)
        except BaseException:
            self.release()
            raise
        self.counted = self.counters()
        self.sound = True
        self.watchdog.beat()
        log(f"rank {self.rank} set up")

    def first_steps(self):
        """train_step's first steps under the group; ranks other than 0
        take no readings."""
        from control_gic_tpu_torch.train import Trainer
        self.trainer = Trainer(self.trainer.model_cfg, self.trainer.train_cfg,
                               group=self.group)
        if self.rank == 0:
            return super().first_steps()
        for _ in range(TS.STEPS_CHECKED):
            self.trainer.train_step(self.state, self.next_batch())
        return None

    # ------------------------------------------------------------ inputs

    def rows(self, step: int, rank: int, rows: int) -> torch.Tensor:
        n, g = self.t["pool"], self.batch * self.ranks
        at = step * g + rank * self.batch
        return self.order[torch.arange(at, at + rows,
                                       device=self.order.device) % n]

    def next_batch(self) -> torch.Tensor:
        """This rank's rows of the next global batch (NHWC)."""
        x = self.pool[self.rows(self.cursor, self.rank, self.batch)]
        self.cursor += 1
        return x

    def first_batches(self):
        """The global batches of the steps the comparison follows, NCHW."""
        g = self.batch * self.ranks
        return [self.pool[self.rows(i, 0, g)].permute(0, 3, 1, 2)
                .contiguous() for i in range(TS.STEPS_CHECKED)]

    # ------------------------------------------------------------ window

    def request(self) -> None:
        try:
            self.watchdog.check()
            if self.rank == 0:
                self.store.set(f"cmd/{self.posted}", "go")
                self.posted += 1
            super().request()
        except BaseException:
            self.sound = False
            raise
        self.watchdog.beat()

    def command(self) -> bytes:
        """Rank 0's post for this rank's next step: `go` or `stop`. A wait
        raises after WAIT_S, and is taken up again while rank 0 still runs
        (the end of a traced window can keep it longer; rank 0 itself ends
        after STALL_S without progress)."""
        while True:
            try:
                return self.store.get(f"cmd/{self.steps}")
            except dist.DistStoreError:
                fault = self.gone()
                if fault is not None:
                    raise RuntimeError(fault) from None
                log(f"rank {self.rank} waits for rank 0 after step "
                    f"{self.steps}")
                self.watchdog.beat()

    def end_to_end(self, window_s: float) -> dict:
        log(f"{self.steps} steps in {window_s:.3f} s")
        return {"train_img_s": self.steps * self.items_per_request
                / window_s}

    @staticmethod
    def counters() -> Optional[tuple]:
        """The port's collective counters (None on a port without them)."""
        from control_gic_tpu_torch.parallel import multihost
        calls = getattr(multihost, "COLLECTIVE_CALLS", None)
        sent = getattr(multihost, "COLLECTIVE_BYTES", None)
        return None if calls is None else (dict(calls), dict(sent))

    def layer_data(self) -> dict:
        """train_step's, per rank at its batch, with the collectives that
        ran in the window (their calls and result bytes by op), the number
        of ranks and the card's link rate."""
        d = super().layer_data()
        d.update(ranks=self.ranks, link_bytes_s=collectives.link_bytes_s(
            torch.cuda.get_device_name(0) if self.on_card else None))
        now = self.counters()
        if now is not None and self.counted is not None:
            for key, a, b in zip(("collective_calls", "collective_bytes"),
                                 now, self.counted):
                d[key] = {k: a[k] - b.get(k, 0) for k in a}
        return d

    # ----------------------------------------------------------- the end

    def replicas_apart(self) -> float:
        """The largest absolute difference of this group's generator and
        discriminator tensors from rank 0's (a collective)."""
        st = self.state
        flat = torch.cat([t.detach().reshape(-1).float() for m in
                          (st.gen, st.disc) for t in
                          m.state_dict().values()])
        ref = flat.clone()
        dist.broadcast(ref, 0, group=self.group)
        gap = (flat - ref).abs().max().reshape(1)
        dist.all_reduce(gap, dist.ReduceOp.MAX, group=self.group)
        return float(gap)

    def release(self) -> None:
        """stop posted; the replicas compared (a sound run: every rank
        alive, every request served); the state dropped; the workers joined
        (killed after EXIT_S) and the group left."""
        try:
            if self.store is not None and self.rank == 0:
                self.store.set(f"cmd/{self.posted}", "stop")
            # from here on a rank that ends is no fault; the stall timer
            # still guards the collectives below
            self.watchdog.stop()
            self.watchdog.beat()
            if (self.sound and self.gone() is None
                    and self.watchdog.fault is None):
                self.replica_diff = self.replicas_apart()
                if self.rank:
                    self.store.set(f"steps/{self.rank}", str(self.steps))
                else:
                    self.rank_steps = [self.steps] + [
                        int(self.store.get(f"steps/{r}"))
                        for r in range(1, self.ranks)]
        finally:
            # the captured steps hold the group's communicator: they go
            # before it (NCCL does not destroy a communicator that live
            # CUDA graphs still use)
            super().release()
            gc.collect()
            t_end = time.monotonic() + EXIT_S
            for p in self.workers:
                try:
                    p.wait(max(0.0, t_end - time.monotonic()))
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait()
            if self.group is not None:
                if self.on_card:
                    torch.cuda.synchronize()
                dist.destroy_process_group()
                self.group = None
            self.store = None
            self.watchdog.disarm()
        if self.rank == 0 and self.rank_steps:
            log(f"steps by rank {self.rank_steps}, replicas apart by "
                f"{self.replica_diff!r}")

    def check(self) -> dict:
        return {**super().check(), "replica_diff": self.replica_diff}


def worker_main(argv: List[str]) -> None:
    """Rank argv[0]: the cell (argv[1], JSON), the store's and the group's
    ports (argv[2:4]); its steps as rank 0 posts them."""
    rank, cell = int(argv[0]), harness.Cell(**json.loads(argv[1]))
    torch.set_num_threads(max(1, torch.get_num_threads() // 4))
    d = Driver(cell, rank, (int(argv[2]), int(argv[3])))
    d.setup({})
    try:
        while d.command() == b"go":
            d.request()
    except BaseException:
        d.sound = False
        raise
    finally:
        d.release()
