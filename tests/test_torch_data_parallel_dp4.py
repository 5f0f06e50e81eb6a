"""The training recipe's data parallelism at its published width of four
ranks, on the CPU, against the benchmark's plain reference
(benchmark/reference/train.py, loaded by path); and the process group's
collective counters.

Four ranks (subprocesses joined by a gloo group, the steps eager: gloo's
collectives cannot be captured) each take 2 rows of a global batch of 8
and make one step of the port's Trainer from the same weights. Rank 0's
readings are held against one reference step on the whole global batch in
this process: the generator's and the discriminator's loss, the gradient
each optimizer got (Adam's first moment after one step over 1 - b1), and
each leaf's change over the step. The same four ranks with the gradient
mean left out (each rank steps on the gradient of its own rows) must fail
the same comparison.

Two ranks on the CPU count one step's collectives:
`multihost.COLLECTIVE_CALLS` and `COLLECTIVE_BYTES` must equal the sizes
the step reduces and gathers, worked out here from the model's shapes. A
program's replay adds its capture's counts (a stand-in capture backend on
the CPU; a CUDA graph over an NCCL group of one rank on a card, which
skips here). A traced step opens the `cgic.dp.*` spans.
"""
import importlib
import os
import socket
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "benchmark")
# the benchmark's small model (benchmark/tests/conftest.py), in the
# reference's configuration keys
TINY = {"n_embed": 64, "embed_dim": 4, "z_channels": 4, "ch": 32,
        "ch_mult": [1, 1, 2, 2, 2], "num_res_blocks": 1,
        "attn_resolutions": [8], "resolution": 64, "dropout": 0.0,
        "dtype": "float32"}
RANKS, ROWS, HW = 4, 2, 64
# Tolerances: the ranks and the reference compute in float32 on the same
# CPU; they part by the order of reductions (a mean over each rank's rows,
# then over the ranks, against one mean over the batch; the BatchNorm
# sums over the group) and by the port's own formulation of the model
# (fused norms, its attention). LOSS: the relative gap of each loss (read:
# 0). GRAD: per leaf, the largest element gap over the leaf's largest
# reference element plus the model's largest one, times GRAD (read: 3e-5 of
# it; a conv bias before a GroupNorm has a true gradient of 0 and holds
# rounding). STEP: per leaf, the gap of the change's norm over the larger of
# its reference norm and the median leaf's, over the leaves the benchmark's
# judge keeps (`judge.kept_leaves`: a gradient at least a thousandth of the
# median leaf's). Adam's first step moves each element by the learning
# rate times g / (|g| + 1e-8), so an element whose gradient lies within
# rounding of 1e-8 moves by a share that rounding decides: read 4.2e-3 at
# worst, and 0.09 with the gradient mean left out.
LOSS, GRAD, STEP = 1e-5, 1e-3, 2e-2

WORKER = r"""
import sys, torch, torch.distributed as dist
sys.path.insert(0, {root!r})
torch.set_num_threads(1)
rank, world, port, out = (int(sys.argv[1]), int(sys.argv[2]),
                          int(sys.argv[3]), sys.argv[4])
dist.init_process_group("gloo", init_method=f"tcp://localhost:{{port}}",
                        world_size=world, rank=rank)
from control_gic_tpu_torch.models import CGICConfig
from control_gic_tpu_torch.parallel import multihost
from control_gic_tpu_torch.train import (TrainConfig, Trainer,
                                         create_train_state)
from control_gic_tpu_torch.train import step as step_mod
from control_gic_tpu_torch.utils.programs import Programs
group = dist.group.WORLD
cfg = CGICConfig(**{{k: tuple(v) if isinstance(v, list) else v
                    for k, v in {tiny!r}.items()}})
x = torch.load(out + "/batch.pt")[{rows} * rank:{rows} * (rank + 1)]
results = {{}}


def one_step():
    state = create_train_state(cfg, TrainConfig(), device="cpu", seed=0,
                               lpips_net="vgg")
    before = {{f"{{g}}.{{n}}": p.detach().clone() for g, m in
              (("gen", state.gen), ("disc", state.disc))
              for n, p in m.named_parameters()}}
    calls = dict(multihost.COLLECTIVE_CALLS)
    sent = dict(multihost.COLLECTIVE_BYTES)
    _, met = Trainer(cfg, TrainConfig(), group=group).train_step(state, x)
    moments = {{**state.opt_gen.state, **state.opt_disc.state}}
    params = {{f"{{g}}.{{n}}": p for g, m in
              (("gen", state.gen), ("disc", state.disc))
              for n, p in m.named_parameters()}}
    return {{"losses": (float(met["train/aeloss"]),
                        float(met["train/discloss"])),
            "grads": {{k: moments[p]["exp_avg"] / (1 - 0.5)
                      for k, p in params.items()}},
            "steps": {{k: p.detach() - before[k] for k, p in
                      params.items()}},
            "calls": {{k: v - calls[k] for k, v in
                      multihost.COLLECTIVE_CALLS.items()}},
            "bytes": {{k: v - sent[k] for k, v in
                      multihost.COLLECTIVE_BYTES.items()}}}}


results["mean"] = one_step()
if world == 2:
    # the cgic.dp spans of a traced step (a profiler on as its root opens)
    from torch.profiler import ProfilerActivity, profile
    from control_gic_tpu_torch.utils import trace
    with profile(activities=[ProfilerActivity.CPU]):
        one_step()
    results["spans"] = [s.name for s in trace.spans()
                        if s.name.startswith("cgic.dp.")]
    # a program's replay adds what its capture counted
    class Standin:
        def capture(self, fn, inputs):
            return "graph", fn(*inputs)

        def replay(self, graph):
            pass

    programs = Programs(None, Standin())
    cache = programs.cache()
    calls = dict(multihost.COLLECTIVE_CALLS)
    add = lambda t: multihost.all_reduce_(t.clone(), group)
    for _ in range(3):
        programs.run(cache, ("sum",), add, torch.ones(5))
    results["replays"] = {{k: v - calls[k] for k, v in
                          multihost.COLLECTIVE_CALLS.items()}}
else:
    step_mod._global_grads = lambda params, grads, group: [
        torch.zeros_like(p) if g is None else g
        for p, g in zip(params, grads)]
    results["no_mean"] = one_step()
if rank == 0:
    torch.save(results, out + "/rank0.pt")
dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _ranks(world: int, out) -> dict:
    """`world` gloo ranks of WORKER on the global batch saved in out;
    rank 0's results."""
    code = WORKER.format(root=ROOT, tiny=TINY, rows=ROWS)
    port = _free_port()
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r),
                               str(world), str(port), str(out)], cwd=ROOT,
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(world)]
    try:
        for p in procs:
            _, err = p.communicate(timeout=240)
            assert p.returncode == 0, err[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return torch.load(out / "rank0.pt")


def _reference(module: str = "train"):
    """A module of benchmark/reference/ (train.py, judge.py), loaded by
    path as the module of a package of its own (they import each other
    relatively)."""
    name = "_bench_reference"
    if name not in sys.modules:
        pkg = types.ModuleType(name)
        pkg.__path__ = [os.path.join(BENCH, "reference")]
        sys.modules[name] = pkg
    return importlib.import_module(f"{name}.{module}")


@pytest.fixture(scope="module")
def batch(tmp_path_factory):
    out = tmp_path_factory.mktemp("dp4")
    x = np.random.default_rng(4).uniform(
        -1, 1, (RANKS * ROWS, HW, HW, 3)).astype(np.float32)
    torch.save(torch.from_numpy(x), out / "batch.pt")
    return out, x


@pytest.fixture(scope="module")
def four_ranks(batch):
    return _ranks(RANKS, batch[0])


@pytest.fixture(scope="module")
def reference(batch):
    """One reference step on the global batch from the ranks' weights."""
    from control_gic_tpu_torch.models import CGICConfig
    from control_gic_tpu_torch.train import TrainConfig, create_train_state
    T = _reference()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cfg = CGICConfig(**{k: tuple(v) if isinstance(v, list) else v
                            for k, v in TINY.items()})
        st = create_train_state(cfg, TrainConfig(), device="cpu", seed=0,
                                lpips_net="vgg")
        state = T.State(st.gen.state_dict(), st.disc.state_dict(),
                        st.lpips.state_dict())
        before = {k: v.detach().clone() for k, v in state.trained()}
        x = torch.from_numpy(batch[1]).permute(0, 3, 1, 2).contiguous()
        r = T.train_step(state, x, TINY, (0.1, 0.4))
    finally:
        torch.set_num_threads(threads)
    return {"losses": (r["aeloss"], r["discloss"]),
            "grads": {k: m / (1 - T.B1) for k, m in state.m.items()},
            "steps": {k: v.detach() - before[k]
                      for k, v in state.trained()}}


def gaps(got: dict, want: dict) -> dict:
    """Each comparison's worst reading over its tolerance (≤ 1 holds)."""
    loss = max(abs(g - w) / abs(w) for g, w in zip(got["losses"],
                                                    want["losses"]))
    top = max(w.abs().max().item() for w in want["grads"].values())
    grad = max((g - want["grads"][k]).abs().max().item()
               / (GRAD * (want["grads"][k].abs().max().item() + top))
               for k, g in got["grads"].items())
    kept = _reference("judge").kept_leaves(
        {k: v.norm().item() for k, v in want["grads"].items()})
    norms = {k: want["steps"][k].norm().item() for k in kept}
    med = float(np.median(list(norms.values())))
    step = max(abs(got["steps"][k].norm().item() - norms[k])
               / max(norms[k], med) for k in kept)
    return {"loss": loss / LOSS, "grad": grad, "step": step / STEP}


def test_four_ranks_match_the_reference_on_the_global_batch(four_ranks,
                                                            reference):
    assert set(four_ranks["mean"]["grads"]) == set(reference["grads"])
    bad = {k: v for k, v in gaps(four_ranks["mean"], reference).items()
           if not v <= 1.0}
    assert not bad, bad


def test_without_the_gradient_mean_the_comparison_fails(four_ranks,
                                                        reference):
    """Each rank stepping on its own rows' gradient: the gradients Adam
    got are those of a quarter of the batch, far outside GRAD, and the
    change over the step outside STEP (the losses, averaged over the group
    before any update, are the batch's)."""
    got = gaps(four_ranks["no_mean"], reference)
    assert got["grad"] > 10.0 and got["step"] > 2.0, got


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("dp2")
    x = np.random.default_rng(5).uniform(
        -1, 1, (2 * ROWS, HW, HW, 3)).astype(np.float32)
    torch.save(torch.from_numpy(x), out / "batch.pt")
    return _ranks(2, out)


def expected_collectives(world: int) -> tuple:
    """(calls, result bytes) by op of one training step of the small model
    at ROWS rows a rank, from its shapes: the router's two all-gathers of
    the f32 entropy maps (patches of 16 and 8 px); all-reduces of the
    generator's gradients, of the discriminator's (each one concatenation
    of f32), of the BatchNorm sums (2 layers of 128 and 256 channels: sum,
    sum of squares and count, forward and backward, in the real and the
    fake call), of the int64 codebook counters and of the f32 metrics."""
    from control_gic_tpu_torch.models import CGICConfig
    from control_gic_tpu_torch.models.discriminator import \
        NLayerDiscriminator
    from control_gic_tpu_torch.train import TrainConfig, create_train_state
    cfg = CGICConfig(**{k: tuple(v) if isinstance(v, list) else v
                        for k, v in TINY.items()})
    st = create_train_state(cfg, TrainConfig(), device="cpu", seed=0,
                            lpips_net="vgg")
    gen = sum(p.numel() for p in st.gen.parameters())
    disc = sum(p.numel() for p in NLayerDiscriminator().parameters())
    maps = sum(world * ROWS * (HW // p) ** 2 for p in (16, 8))
    bn = 2 * 2 * sum(2 * c + 1 for c in (128, 256))
    # the generator's six terms, the discriminator's three, aeloss and
    # discloss
    metrics = 6 + 3 + 2
    calls = {"all_gather": 2, "all_reduce": 1 + 1 + 8 + 1 + 1}
    sent = {"all_gather": 4 * maps,
            "all_reduce": 4 * (gen + disc + bn + metrics)
            + 8 * cfg.n_embed}
    return calls, sent


def test_counters_equal_the_sizes_the_step_reduces_and_gathers(two_ranks):
    calls, sent = expected_collectives(2)
    got = two_ranks["mean"]
    assert got["calls"] == calls
    assert got["bytes"] == sent


def test_spans_of_a_traced_step(two_ranks):
    """Two gradient means (generator, discriminator), one span over the
    router's two gathers, one a BatchNorm layer and discriminator call
    (2 layers, the real and the fake call), one over the metrics' mean."""
    names = two_ranks["spans"]
    assert {n: names.count(n) for n in set(names)} == {
        "cgic.dp.grads": 2, "cgic.dp.gather": 1, "cgic.dp.bn": 4,
        "cgic.dp.metrics": 1}


def test_replays_add_the_capture_counts(two_ranks):
    """Three calls of one program (a warm-up with its capture, then two
    replays that run nothing) count three all-reduces."""
    assert two_ranks["replays"] == {"all_reduce": 3, "all_gather": 0}


CARD_WORKER = r"""
import sys, torch, torch.distributed as dist
sys.path.insert(0, {root!r})
from control_gic_tpu_torch.parallel import multihost
from control_gic_tpu_torch.utils.programs import CUDAGraphs, Programs
group = multihost.initialize_multihost(f"localhost:{{sys.argv[1]}}", 1, 0,
                                       backend="nccl", device="cuda:0")
programs = Programs(None, CUDAGraphs(torch.device("cuda:0")))
cache = programs.cache()
x = torch.ones(1 << 20, device="cuda:0")
add = lambda t: multihost.all_reduce_(t * 2.0, group)
before = dict(multihost.COLLECTIVE_BYTES)
outs = [programs.run(cache, ("sum",), add, x) for _ in range(4)]
torch.cuda.synchronize()
assert programs.captured == 1
assert all(torch.equal(o, x * 2.0) for o in outs)
got = multihost.COLLECTIVE_BYTES["all_reduce"] - before["all_reduce"]
assert got == 4 * x.numel() * 4, got
assert multihost.COLLECTIVE_CALLS["all_reduce"] == 4
dist.destroy_process_group()
print("ok")
"""


def test_cuda_graph_replays_add_the_capture_counts():
    """An NCCL all-reduce (a group of one rank) captured in a CUDA graph
    and replayed three times counts four calls and their bytes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the capture is a CUDA graph")
    out = subprocess.run([sys.executable, "-c",
                          CARD_WORKER.format(root=ROOT), str(_free_port())],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0 and "ok" in out.stdout, out.stderr[-3000:]
