"""Multi-process data parallelism: the process group and its collectives
(port of control_gic_tpu/parallel/multihost.py).

JAX jits the training step over the global batch sharded on a 'data' axis
and XLA inserts the psums; jax.distributed spans hosts. The port runs one
process per card (`python -m torch.distributed.run`, or any launcher that
names the coordinator), joined by a torch.distributed process group, and
the Trainer writes the collectives out where XLA puts them
(train/step.py). The helpers here are those collectives: a sum or mean
all-reduce (in place, and a differentiable sum for the discriminator's
BatchNorm), and an all-gather along dim 0. With group=None each is the
identity, so the single-process step runs the same code. `host_group`
gives a gloo group over the same ranks for host flags (the train loop's
preemption check), whose all-reduce does not wait for the card.

The backend is NCCL when each rank has a card of its own and gloo on the
CPU. Two ranks on one card (a check of the multi-rank semantics on a
one-card machine) take gloo with CUDA tensors, because NCCL refuses two
ranks on one device; gloo takes CUDA tensors for all_reduce and all_gather
(checked on the H100's torch 2.11 build), so the helpers hand them over as
they are.

Counters: `COLLECTIVE_CALLS` and `COLLECTIVE_BYTES`, keyed by op
(`all_reduce`, `all_gather`), count each collective that runs over a
group (with group=None nothing runs and nothing is counted) and the bytes
of its result on this rank: the whole tensor of an all-reduce (the
differentiable sum's forward and backward each count one), the gathered
tensor of an all-gather. They are registered with the kernels' launch
counters (`kernels.build.counter`) and taken under their lock, so that a
replayed CUDA graph adds its capture's counts (utils/programs.py).
"""
from __future__ import annotations

import os
from typing import List, Optional

import torch
import torch.distributed as dist

from ..kernels import build

COLLECTIVE_CALLS = build.counter({"all_reduce": 0, "all_gather": 0})
COLLECTIVE_BYTES = build.counter({"all_reduce": 0, "all_gather": 0})


def _count(op: str, t: torch.Tensor) -> None:
    build.add_launches(COLLECTIVE_CALLS, {op: 1})
    build.add_launches(COLLECTIVE_BYTES, {op: t.numel() * t.element_size()})


def _env_int(*names: str) -> Optional[int]:
    for n in names:
        if os.environ.get(n) is not None:
            return int(os.environ[n])
    return None


def launched() -> bool:
    """Whether a launcher named a coordinator for this process:
    COORDINATOR_ADDRESS (as for jax.distributed) or torchrun's
    MASTER_ADDR with RANK and WORLD_SIZE."""
    return bool(os.environ.get("COORDINATOR_ADDRESS")) or all(
        os.environ.get(k) is not None
        for k in ("MASTER_ADDR", "RANK", "WORLD_SIZE"))


def local_device(device: str = "cuda") -> torch.device:
    """This process's device: cuda:LOCAL_RANK (modulo the cards the host
    has) for a CUDA run, else `device` as given."""
    dev = torch.device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    local = _env_int("LOCAL_RANK") or 0
    return torch.device("cuda", local % max(torch.cuda.device_count(), 1))


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         backend: Optional[str] = None,
                         device: Optional[torch.device] = None
                         ) -> dist.ProcessGroup:
    """Join the process group and return it. The coordinator is
    `coordinator_address` (host:port), else COORDINATOR_ADDRESS, else
    torchrun's MASTER_ADDR:MASTER_PORT; the world size and rank are the
    arguments, else WORLD_SIZE and RANK. The backend is NCCL when `device`
    (default: local_device()) is a card that no other local rank shares,
    gloo otherwise."""
    addr = coordinator_address or os.environ.get("COORDINATOR_ADDRESS")
    if not addr:
        addr = (f"{os.environ['MASTER_ADDR']}:"
                f"{os.environ.get('MASTER_PORT', '29500')}")
    world = num_processes if num_processes is not None else _env_int(
        "WORLD_SIZE")
    rank = process_id if process_id is not None else _env_int("RANK")
    if world is None or rank is None:
        raise ValueError("the world size and the rank are neither given "
                         "nor in WORLD_SIZE / RANK")
    device = local_device() if device is None else torch.device(device)
    if backend is None:
        local_world = _env_int("LOCAL_WORLD_SIZE") or world
        backend = ("nccl" if device.type == "cuda"
                   and local_world <= torch.cuda.device_count() else "gloo")
    kw = {}
    if backend == "nccl":
        torch.cuda.set_device(device)
        kw["device_id"] = device
    dist.init_process_group(backend, init_method=f"tcp://{addr}",
                            world_size=world, rank=rank, **kw)
    return dist.group.WORLD


def is_primary() -> bool:
    """Rank 0, or a process outside any group."""
    return not dist.is_initialized() or dist.get_rank() == 0


def global_device_summary() -> str:
    rank = dist.get_rank() if dist.is_initialized() else 0
    world = dist.get_world_size() if dist.is_initialized() else 1
    local = torch.cuda.device_count() if torch.cuda.is_available() else 0
    backend = dist.get_backend() if dist.is_initialized() else "none"
    return (f"process {rank}/{world} ({backend}): {local} local cards, "
            f"{world} ranks")


# ------------------------------------------------------------- collectives

def group_key(group: Optional[dist.ProcessGroup]) -> Optional[tuple]:
    """(rank, size, backend) of a group, None without one: what a captured
    program that runs the group's collectives depends on."""
    if group is None:
        return None
    return (dist.get_rank(group), dist.get_world_size(group),
            str(dist.get_backend(group)))


def host_group(group: Optional[dist.ProcessGroup]
               ) -> Optional[dist.ProcessGroup]:
    """A gloo group over the ranks of `group` (None without one), for
    collectives of host tensors that must not wait on the card. Creating a
    group is collective: every rank of `group` calls this at the same
    point."""
    if group is None:
        return None
    return dist.new_group(ranks=dist.get_process_group_ranks(group),
                          backend="gloo")


def capturable(group: Optional[dist.ProcessGroup]) -> bool:
    """Whether the group's collectives can run inside a CUDA graph: NCCL's
    can, gloo's (host transport) cannot."""
    return group is None or dist.get_backend(group) == "nccl"


def all_reduce_(t: torch.Tensor, group: Optional[dist.ProcessGroup],
                op: str = "sum") -> torch.Tensor:
    """In-place sum (or mean) of `t` over the group; returns t."""
    if group is None:
        return t
    dist.all_reduce(t, group=group)
    _count("all_reduce", t)
    if op == "mean":
        t.div_(dist.get_world_size(group))
    return t


def all_reduce_mean(tensors: List[torch.Tensor],
                    group: Optional[dist.ProcessGroup]
                    ) -> List[torch.Tensor]:
    """The mean over the group of each tensor, through one all-reduce of
    their concatenation; new tensors, the inputs untouched."""
    if group is None:
        return tensors
    flat = torch.cat([t.reshape(-1) for t in tensors])
    all_reduce_(flat, group, "mean")
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].view_as(t))
        at += t.numel()
    return out


def all_gather(t: torch.Tensor, group: Optional[dist.ProcessGroup]
               ) -> torch.Tensor:
    """The group's tensors concatenated along dim 0, in rank order."""
    if group is None:
        return t
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    out = torch.cat(parts)
    _count("all_gather", out)
    return out


class _AllReduceSum(torch.autograd.Function):
    """Sum over the group whose gradient is the sum over the group of the
    gradients: each rank's loss reads every rank's input, so each input's
    gradient collects every rank's share. Each direction is one counted
    all_reduce_."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.clone(), ctx.group), None


def all_reduce_sum(x: torch.Tensor, group: Optional[dist.ProcessGroup]
                   ) -> torch.Tensor:
    """Differentiable sum of `x` over the group (x itself without one)."""
    return x if group is None else _AllReduceSum.apply(x, group)
