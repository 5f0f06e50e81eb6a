"""Data-parallel training on the CPU: two processes joined by a gloo group,
each stepping on its half of a global batch of 4, against one process
stepping on the whole batch, and both against the JAX Trainer jitted over
the same global batch sharded on a mesh of the virtual CPU devices (the
batch of 4 does not divide the 8 devices, so the mesh takes 4 of them).

Held: the losses and metrics of both steps (1e-6 of max(1, |value|)),
every all-reduced gradient of step 1 (1e-5 of its tensor's max plus 1e-5
of the model's largest gradient), the codebook counters (equal), the
discriminator's running statistics after 2 steps (1e-6 of each tensor's
max), and the EMA shadow and both Adam states after 2 steps over the whole
model (1e-5 in the relative L2 norm: Adam turns a rounding-level gradient
into a step of up to the learning rate), with the default loss and with
adaptive_g_weight across disc_start = 1; the two ranks' states are equal
to the last bit; a config with dropout = 0.1 holds
as well, because the training step runs the model deterministically (as
JAX's does: no 'dropout' rng). Against JAX (its Trainer's first step on
the mesh, and jax.grad of its generator loss on the global batch on the
mesh): losses 1e-4 relative and gradients 1e-3 of each tensor's max, the
tolerances of tests/test_torch_train.py. graphs=True under a 2-rank gloo
group raises. The train loop's preemption check (cli/train.py `_stop`,
through multihost.host_group) stops both ranks when one rank's event is
set.

The ranks are subprocesses (`python -c` of WORKER): they import torch and
the port only."""
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from control_gic_tpu_torch.models import CGICConfig
from control_gic_tpu_torch.train import TrainConfig, Trainer, create_train_state
from control_gic_tpu_torch.train import step as step_mod
from control_gic_tpu_torch.train.losses import LossConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(n_embed=32, embed_dim=4, z_channels=4, ch=32,
            ch_mult=(1, 1, 2, 2, 2), num_res_blocks=1, attn_resolutions=(8,),
            resolution=64)
GLOBAL_BATCH = 4
STEPS = 2
# (name, model config changes, loss config changes)
SCENARIOS = [("default", {}, {}),
             ("adaptive_disc_start", {}, dict(adaptive_g_weight=True,
                                              disc_start=1)),
             ("dropout", dict(dropout=0.1), {})]


def batches():
    rng = np.random.default_rng(0)
    return [rng.uniform(-1, 1, (GLOBAL_BATCH, 64, 64, 3)).astype(np.float32)
            for _ in range(STEPS)]


def run(scenario, weights, group=None, rows=slice(None)):
    """STEPS steps from `weights` (a port state_dict) on the rows of the
    global batches: the metrics, the gradients given to the optimizers at
    step 1 (generator then discriminator), and the state after."""
    _, mcfg, lcfg = next(s for s in SCENARIOS if s[0] == scenario)
    cfg = CGICConfig(**{**TINY, **mcfg})
    tcfg = TrainConfig(loss=LossConfig(**lcfg))
    state = create_train_state(cfg, tcfg, device="cpu")
    state.load_state_dict(weights)
    trainer = Trainer(cfg, tcfg, group=group)
    grads, orig = [], step_mod.apply_gradients

    def record(opt, params, g, c):
        grads.append([torch.zeros_like(p) if t is None else t.detach().clone()
                      for p, t in zip(params, g)])
        orig(opt, params, g, c)

    step_mod.apply_gradients = record
    try:
        metrics = []
        for x in batches():
            state, m = trainer.train_step(state, x[rows])
            metrics.append({k: float(v) for k, v in m.items()})
    finally:
        step_mod.apply_gradients = orig
    sd = state.state_dict()
    out = {"metrics": metrics, "gen_grads": grads[0], "disc_grads": grads[1],
           "counts": sd["codebook_counts"].clone(),
           "disc_buffers": {k: v.clone() for k, v in sd["disc"].items()
                            if "running" in k},
           "ema": {k: v.clone() for k, v in sd["ema"].items()},
           "adam": [t.clone() for opt in (state.opt_gen, state.opt_disc)
                    for st in opt.state.values() for k, t in st.items()
                    if k != "step"]}
    return out


WORKER = r"""
import sys, torch, torch.distributed as dist
sys.path.insert(0, {root!r}); sys.path.insert(0, {tests!r})
torch.set_num_threads(1)
rank, port, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dist.init_process_group("gloo", init_method=f"tcp://localhost:{{port}}",
                        world_size=2, rank=rank)
import test_torch_data_parallel as T
from control_gic_tpu_torch.models import CGICConfig
from control_gic_tpu_torch.train import TrainConfig, Trainer
weights = torch.load(out + "/weights.pt")
results = {{name: T.run(name, weights, dist.group.WORLD,
                        slice(2 * rank, 2 * rank + 2))
            for name, _, _ in T.SCENARIOS}}
try:
    Trainer(CGICConfig(**T.TINY), TrainConfig(), graphs=True,
            group=dist.group.WORLD)
    results["graphs_raise"] = False
except ValueError:
    results["graphs_raise"] = True
import threading
from control_gic_tpu_torch.cli import train as train_cli
from control_gic_tpu_torch.parallel.multihost import host_group
flags, ev = host_group(dist.group.WORLD), threading.Event()
results["stop"] = [train_cli._stop(ev, flags)]
if rank == 1:
    ev.set()
results["stop"].append(train_cli._stop(ev, flags))
torch.save(results, f"{{out}}/rank{{rank}}.pt")
dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _np_tree(tree):
    import jax
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX state's params carried into a port state_dict; the two ranks
    started on it; meanwhile the JAX Trainer's first step on the mesh and
    jax.grad of its generator loss, then one process on the whole
    batch."""
    import jax
    from control_gic_tpu.models.cgic import CGICConfig as JConfig
    from control_gic_tpu.parallel.mesh import data_sharding, make_mesh
    from control_gic_tpu.parallel.mesh import shard_batch
    from control_gic_tpu.train import TrainConfig as JTrainConfig
    from control_gic_tpu.train import Trainer as JTrainer
    from control_gic_tpu.train import create_train_state as j_create_state
    from control_gic_tpu_torch.utils.from_jax import (
        disc_state_dict_from_flax, lpips_state_dict_from_flax,
        state_dict_from_flax)

    out = tmp_path_factory.mktemp("dp")
    jcfg, jtcfg = JConfig(**TINY), JTrainConfig()
    jstate = jax.jit(j_create_state, static_argnums=(1, 2, 3))(
        jax.random.PRNGKey(0), jcfg, jtcfg, 64)
    state = create_train_state(CGICConfig(**TINY), TrainConfig(),
                               device="cpu")
    gen = state_dict_from_flax(_np_tree(jstate.gen_params))
    state.gen.load_state_dict(gen, strict=True)
    disc_vars = {"params": jstate.disc_params,
                 "batch_stats": jstate.disc_batch_stats}
    state.disc.load_state_dict(disc_state_dict_from_flax(
        _np_tree(disc_vars)), strict=True)
    state.lpips.load_state_dict(lpips_state_dict_from_flax(
        _np_tree(jstate.lpips_params)), strict=True)
    for k, v in state.ema.items():
        v.copy_(gen[k])
    weights = state.state_dict()
    torch.save(weights, out / "weights.pt")

    port = _free_port()
    code = WORKER.format(root=ROOT, tests=os.path.join(ROOT, "tests"))
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r), str(port),
                               str(out)], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(2)]
    try:
        # JAX: the generator gradient on the global batch, then the
        # Trainer's first step over the mesh (which donates the state; its
        # second step would compile again, for 40 s on this CPU)
        mesh = make_mesh(4)
        x0 = batches()[0]
        _, jgrads = jax.jit(jax.value_and_grad(
            JTrainer(jcfg, jtcfg)._forward_losses, has_aux=True))(
            jstate.gen_params, disc_vars, jstate.lpips_params,
            shard_batch(mesh, x0))
        jgrads = _np_tree(jgrads)
        jtrainer = JTrainer(jcfg, jtcfg, mesh=mesh,
                            data_sharding=data_sharding(mesh))
        _, m = jtrainer.train_step(jstate, shard_batch(mesh, x0))
        jmetrics = [{k: float(v) for k, v in m.items()}]
        solo = {name: run(name, weights) for name, _, _ in SCENARIOS}
        for p in procs:
            stdout, stderr = p.communicate(timeout=300)
            assert p.returncode == 0, stderr[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    ranks = [torch.load(out / f"rank{r}.pt") for r in range(2)]
    return dict(solo=solo, ranks=ranks, jmetrics=jmetrics,
                jgrads=state_dict_from_flax(jgrads),
                gen_names=[n for n, _ in state.gen.named_parameters()])


def _rel(got, want) -> float:
    return abs(got - want) / max(abs(want), 1e-12)


def _close(got, want, tol):
    err = (got.double() - want.double()).abs().max().item()
    return err <= tol * max(want.double().abs().max().item(), 1e-30) + 1e-12


def _flat(tensors) -> torch.Tensor:
    return torch.cat([t.reshape(-1).double() for t in tensors])


@pytest.mark.parametrize("scenario", [s[0] for s in SCENARIOS])
@pytest.mark.parametrize("rank", [0, 1])
def test_two_ranks_equal_one_process(runs, scenario, rank):
    got, want = runs["ranks"][rank][scenario], runs["solo"][scenario]
    # every metric of both steps within 1e-6 of max(1, |value|)
    for gm, wm in zip(got["metrics"], want["metrics"]):
        assert set(gm) == set(wm)
        bad = {k: (gm[k], wm[k]) for k in wm
               if abs(gm[k] - wm[k]) > 1e-6 * max(1.0, abs(wm[k]))}
        assert not bad, bad
    for key in ("gen_grads", "disc_grads"):
        # within 1e-5 of each tensor's max, plus 1e-5 of the model's
        # largest gradient: the f32 rounding of a sum that cancels (the
        # discriminator's conv_out bias is a difference of two hinge
        # counts over the batch; a conv bias right before a GroupNorm has
        # a true gradient of 0 and holds only rounding)
        floor = 1e-5 * max(w.abs().max().item() for w in want[key])
        bad = [(i, (g - w).abs().max().item(), w.abs().max().item())
               for i, (g, w) in enumerate(zip(got[key], want[key]))
               if not (g - w).abs().max().item()
               <= 1e-5 * w.abs().max().item() + floor]
        assert not bad, (key, bad)
    assert torch.equal(got["counts"], want["counts"])
    assert int(got["counts"].sum()) == STEPS * GLOBAL_BATCH * 16 * 16
    for k, w in want["disc_buffers"].items():
        assert _close(got["disc_buffers"][k], w, 1e-6), k
    # Adam divides each element's first moment by the root of its second,
    # so an element whose gradient is rounding (the biases above) moves by
    # up to the learning rate either way: EMA and Adam are held over the
    # whole model, in the relative L2 norm
    for key in ("ema", "adam"):
        g, w = ((_flat(d.values()) if key == "ema" else _flat(d))
                for d in (got[key], want[key]))
        assert ((g - w).norm() / w.norm()).item() <= 1e-5, key


@pytest.mark.parametrize("scenario", [s[0] for s in SCENARIOS])
def test_replicas_stay_identical(runs, scenario):
    """Both ranks apply the same all-reduced gradients: their EMA, Adam
    state and running statistics are equal to the last bit."""
    r0, r1 = (runs["ranks"][r][scenario] for r in (0, 1))
    assert all(torch.equal(r0["ema"][k], r1["ema"][k]) for k in r0["ema"])
    assert all(torch.equal(a, b) for a, b in zip(r0["adam"], r1["adam"]))
    assert all(torch.equal(r0["disc_buffers"][k], r1["disc_buffers"][k])
               for k in r0["disc_buffers"])


def test_graphs_under_gloo_raise(runs):
    assert all(r["graphs_raise"] for r in runs["ranks"])


def test_preemption_on_one_rank_stops_every_rank(runs):
    """The train loop's check, through the host group: no rank stops while
    no event is set; once rank 1's is, both ranks stop."""
    assert [r["stop"] for r in runs["ranks"]] == [[False, True]] * 2


@pytest.mark.parametrize("rank", [0, 1])
def test_two_ranks_match_jax_mesh(runs, rank):
    """The ranks' step-1 metrics against JAX's Trainer on the mesh, their
    step-1 generator gradients against jax.grad on the global batch."""
    got = runs["ranks"][rank]["default"]
    for gm, jm in zip(got["metrics"], runs["jmetrics"]):
        assert set(gm) == set(jm)
        bad = {k: (gm[k], jm[k]) for k in jm
               if _rel(gm[k], jm[k]) > 1e-4 and abs(gm[k] - jm[k]) > 1e-6}
        assert not bad, bad
    want = runs["jgrads"]
    noise = 1e-6 * max(w.abs().max().item() for w in want.values())
    bad = {}
    for name, g in zip(runs["gen_names"], got["gen_grads"]):
        w = want[name]
        err = (g - w).abs().max().item()
        if not err <= 1e-3 * w.abs().max().item() + noise:
            bad[name] = (err, w.abs().max().item())
    assert not bad, bad


def test_process_group_helpers_without_group():
    """Without a group the collectives are the identity and the program key
    has no group, so the one-process step runs the same code."""
    from control_gic_tpu_torch.parallel import multihost
    t = torch.arange(4.0)
    assert multihost.all_reduce_(t, None) is t
    assert multihost.all_gather(t, None) is t
    assert multihost.all_reduce_sum(t, None) is t
    assert multihost.group_key(None) is None
    assert multihost.capturable(None)
    assert multihost.is_primary()
    assert json.dumps(multihost.global_device_summary())
