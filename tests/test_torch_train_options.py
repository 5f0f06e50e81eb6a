"""The training options the port took over from the JAX package, held against
it on the CPU at tests/test_remat.py's tiny config with remat,
adaptive_g_weight and disc_start=2 on both sides, from the same weights:

  - adaptive_g_weight: the weight itself against JAX
    `Trainer._adaptive_g_weight`, and three steps against JAX's losses and
    batch_stats (the discriminator bitwise frozen before step 2 and training
    from it on);
  - remat: tests/test_remat.py's contract on the port, the port's remat
    gradients against JAX's remat model, and no chained block under remat
    (or deterministic=False) where the chain is forced on;
  - dropout: rate 0.1 with deterministic=True (the training step's call)
    equal to JAX's model; deterministic=False zeroes about `rate` of the
    elements, scales the rest by exactly 1/(1 - rate), and raises without a
    generator; under remat its recompute draws the same numbers (JAX's
    remat cannot take dropout > 0: its gate branches on a traced
    `deterministic`);
  - the train CLI's --remat, combined with the config as JAX's CLI does.

The JAX side is one jitted program (the step, the generator's loss and
gradients, the adaptive weight, the dropout model's reconstruction),
compiled once for the three steps: JAX's
CPU compiles of this model take most of this file's time. Its generator
weights come from the port's (JAX's port_cgic_state_dict), its
discriminator and LPIPS from jitted inits carried into the port."""
import copy
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import yaml

from control_gic_tpu.cli import train as j_train_cli
from control_gic_tpu.config import load_config as j_load_config
from control_gic_tpu.models.cgic import CGIC as JCGIC
from control_gic_tpu.models.cgic import CGICConfig as JConfig
from control_gic_tpu.models.discriminator import NLayerDiscriminator
from control_gic_tpu.models.lpips import LPIPS as JLPIPS
from control_gic_tpu.models.lpips import with_bundled_lin_heads
from control_gic_tpu.train import TrainConfig as JTrainConfig
from control_gic_tpu.train import Trainer as JTrainer
from control_gic_tpu.train.losses import LossConfig as JLossConfig
from control_gic_tpu.train.state import TrainState as JTrainState
from control_gic_tpu.train.state import make_optimizer as j_make_optimizer
from control_gic_tpu.utils.port_torch import port_cgic_state_dict
from control_gic_tpu_torch.cli import train as train_cli
from control_gic_tpu_torch.models import CGIC, CGICConfig
from control_gic_tpu_torch.models.blocks import ResnetBlock
from control_gic_tpu_torch.ops import fused_norm as tfn
from control_gic_tpu_torch.ops import norm_conv as tnc
from control_gic_tpu_torch.train import TrainConfig, Trainer, create_train_state
from control_gic_tpu_torch.train.losses import LossConfig, adaptive_weight
from control_gic_tpu_torch.utils.from_jax import (disc_state_dict_from_flax,
                                                  lpips_state_dict_from_flax,
                                                  state_dict_from_flax)

torch.set_num_threads(2)

TINY = dict(n_embed=32, embed_dim=4, z_channels=4, ch=32,
            ch_mult=(1, 1, 2, 2, 2), num_res_blocks=1, attn_resolutions=(8,),
            resolution=64)
OPTIONS = dict(TINY, remat=True)
DROPOUT = dict(TINY, dropout=0.1)
ADAPTIVE = dict(disc_start=2, adaptive_g_weight=True)
LOSS_RTOL = 1e-4          # tests/test_torch_train.py's


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-12))


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


@pytest.fixture(scope="module")
def both():
    """The port's initial state (OPTIONS, ADAPTIVE) and JAX's from the same
    weights, three batches, and what JAX's program gave at each step: the
    new state and metrics, and at the initial state the generator's loss,
    reconstruction and gradients and the adaptive weight."""
    cfg = CGICConfig(**OPTIONS)
    tcfg = TrainConfig(loss=LossConfig(**ADAPTIVE))
    state = create_train_state(cfg, tcfg, device="cpu", seed=0)
    gen, _ = port_cgic_state_dict({k: v.numpy() for k, v in
                                   state.gen.state_dict().items()})
    gen = jax.tree_util.tree_map(jnp.asarray, gen)
    x0 = jnp.zeros((1, 64, 64, 3))
    disc = jax.jit(lambda k: NLayerDiscriminator().init(k, x0, train=False))(
        jax.random.PRNGKey(1))
    lpips = with_bundled_lin_heads(jax.jit(lambda k: JLPIPS().init(
        k, x0, x0))(jax.random.PRNGKey(2))["params"])
    state.disc.load_state_dict(disc_state_dict_from_flax(_np_tree(disc)),
                               strict=True)
    state.lpips.load_state_dict(lpips_state_dict_from_flax(_np_tree(lpips)),
                                strict=True)
    jt = JTrainConfig(loss=JLossConfig(**ADAPTIVE))
    opt = j_make_optimizer(jt)
    jstate = JTrainState(
        step=jnp.zeros((), jnp.int32), gen_params=gen,
        disc_params=disc["params"], disc_batch_stats=disc["batch_stats"],
        lpips_params=lpips, opt_gen=opt.init(gen),
        opt_disc=opt.init(disc["params"]),
        ema_params=jax.tree_util.tree_map(jnp.copy, gen),
        ema_num_updates=jnp.zeros((), jnp.int32),
        codebook_counts=jnp.zeros((TINY["n_embed"],), jnp.uint32))
    jtrainer = JTrainer(JConfig(**OPTIONS), jt)
    jdropout = JCGIC(JConfig(**DROPOUT))

    def program(s, x):
        dv = {"params": s.disc_params, "batch_stats": s.disc_batch_stats}
        (loss, _), grads = jax.value_and_grad(
            jtrainer._forward_losses, has_aux=True)(
            s.gen_params, dv, s.lpips_params, x)
        w = jtrainer._adaptive_g_weight(s.gen_params, dv, s.lpips_params, x)
        rec, _ = jdropout.apply({"params": s.gen_params}, x, 0.1, 0.4,
                                deterministic=True)
        return jtrainer._train_step(s, x), loss, rec, grads, w

    program = jax.jit(program)
    batches = np.random.default_rng(5).uniform(-1, 1, (3, 2, 64, 64, 3)
                                               ).astype(np.float32)
    steps, first = [], None
    for x in batches:
        (jstate, metrics), loss, rec, grads, w = program(jstate,
                                                         jnp.asarray(x))
        steps.append((_np_tree(jstate), _np_tree(metrics)))
        if first is None:
            grads = {k: v.numpy() for k, v in
                     state_dict_from_flax(_np_tree(grads)).items()}
            first = dict(loss=float(loss), rec=np.asarray(rec), w=float(w),
                         grads=grads)
    return dict(state=state, trainer=Trainer(cfg, tcfg), batches=batches,
                steps=steps, disc0=_np_tree(disc["params"]), **first)


# -------------------------------------------------------- adaptive weight

def test_adaptive_weight_matches_jax(both):
    state, trainer = both["state"], both["trainer"]
    _, _, _, metrics = trainer.forward_losses(
        state, trainer.to_input(state, both["batches"][0]))
    got = adaptive_weight(metrics["nll_loss"], metrics["g_loss"],
                          state.gen.decoder.conv_out.weight).item()
    want = both["w"]
    assert 0.0 < want < 1e4
    assert abs(got - want) <= 1e-4 * abs(want), (got, want)


def test_adaptive_steps_cross_disc_start_as_jax(both):
    """Three steps from the same state and batches: the losses, metrics and
    batch_stats of each against JAX's; before disc_start the
    discriminator's parameters do not move by a bit, from it on they do
    (on both sides)."""
    state, trainer = copy.deepcopy(both["state"]), both["trainer"]
    j_before = both["disc0"]
    for i, (x, (jstate, jm)) in enumerate(zip(both["batches"],
                                              both["steps"])):
        d_before = [p.detach().clone() for p in state.disc.parameters()]
        state, m = trainer.train_step(state, x)
        assert set(m) == set(jm)
        for k, v in jm.items():
            assert _rel(m[k].item(), float(v)) <= LOSS_RTOL, (i, k)
        for name, stats in jstate.disc_batch_stats.items():
            bn = getattr(state.disc, name)
            np.testing.assert_allclose(bn.running_mean.numpy(), stats["mean"],
                                       atol=1e-5)
            np.testing.assert_allclose(bn.running_var.numpy(), stats["var"],
                                       atol=1e-5)
        frozen = all(torch.equal(a, p) for a, p in
                     zip(d_before, state.disc.parameters()))
        j_frozen = jax.tree_util.tree_all(jax.tree_util.tree_map(
            np.array_equal, j_before, jstate.disc_params))
        j_before = jstate.disc_params
        assert frozen == j_frozen == (i < 2), i
    assert state.step == int(both["steps"][-1][0].step) == 3


# ------------------------------------------------------------------ remat

def _loss(model, x):
    rec, enc = model(x, 0.1, 0.4)
    return torch.mean(torch.square(rec - x)) + enc.emb_loss


def _grads(loss, model):
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return {n: (torch.zeros_like(p) if g is None else g).numpy()
            for n, p, g in zip(names, params, grads)}


def test_remat_same_forward_and_grad(both):
    """tests/test_remat.py's contract on the port (its loss, batch 1)."""
    x = _nchw(both["batches"][0][:1])
    models = {}
    for flag in (False, True):
        models[flag] = CGIC(CGICConfig(**dict(TINY, remat=flag)))
        models[flag].load_state_dict(both["state"].gen.state_dict(),
                                     strict=True)
    l0, l1 = (_loss(models[f], x) for f in (False, True))
    np.testing.assert_allclose(l0.item(), l1.item(), rtol=1e-6)
    g0, g1 = _grads(l0, models[False]), _grads(l1, models[True])
    for name, a in g0.items():
        np.testing.assert_allclose(a, g1[name], rtol=1e-4, atol=1e-5,
                                   err_msg=name)


def test_remat_grads_match_jax_remat(both):
    """The generator's loss and gradients through the port's remat model
    against JAX's remat model, within 1e-3 of each tensor's max."""
    state, trainer = both["state"], both["trainer"]
    loss, _, _, _ = trainer.forward_losses(
        state, trainer.to_input(state, both["batches"][0]))
    grads, want = _grads(loss, state.gen), both["grads"]
    assert abs(loss.item() - both["loss"]) <= LOSS_RTOL * abs(both["loss"])
    assert set(want) == set(grads)
    # plus f32 noise at 1e-6 of the largest gradient for tensors whose
    # true gradient is 0 (as tests/test_torch_train.py)
    noise = 1e-6 * max(np.abs(w).max() for w in want.values())
    bad = {n: float(np.abs(g - want[n]).max()) for n, g in grads.items()
           if not np.abs(g - want[n]).max()
           <= 1e-3 * np.abs(want[n]).max() + noise}
    assert not bad, bad


WIDE = dict(TINY, ch=128, ch_mult=(1, 1, 1, 1, 1), num_res_blocks=2)


@pytest.mark.parametrize("case, chained", [("plain", True),
                                           ("remat", False),
                                           ("nondeterministic", False)])
def test_no_chain_under_remat_or_dropout_mode(monkeypatch, case, chained):
    """With every shape engaged (set_engagement_rule) and the kernels
    replaced by counting plain versions, the 128-channel trunks chain in a
    plain forward and backward, and chain nowhere under remat or with
    deterministic=False (JAX `use_chain = not remat and deterministic`)."""
    calls = {"chain": 0}

    def chain(x, cw, cb, gs, gb, stats, res=None, emit_mom=True,
              act_swish=True, zq_r=None, wy=None, by=None, wb=None, bb=None):
        calls["chain"] += 1
        kw = dict(res=res, stats=stats, act_swish=act_swish,
                  emit_mom=emit_mom)
        if zq_r is not None:
            return tnc.chain_reference(x, zq_r, gs, gb, wy, by, wb, bb, cw,
                                       cb, **kw)
        return tnc.plain_chain_reference(x, gs, gb, cw, cb, **kw)

    monkeypatch.setattr(tnc, "use_kernel", lambda t: True)
    monkeypatch.setattr(tfn, "use_kernel", lambda t: True)
    monkeypatch.setattr(tnc, "chain_kernel", chain)
    monkeypatch.setattr(tfn, "gn_moments_kernel", tfn.gn_moments_reference)
    model = CGIC(CGICConfig(**WIDE, remat=case == "remat"))
    x = _nchw(np.random.default_rng(1).uniform(-1, 1, (1, 64, 64, 3)
                                               ).astype(np.float32))
    tnc.set_engagement_rule(lambda shape, cout: True)
    try:
        rec, enc = model(x, 0.1, 0.4,
                         deterministic=case != "nondeterministic")
        (rec.square().mean() + enc.emb_loss).backward()
    finally:
        tnc.set_engagement_rule(None)
    assert (calls["chain"] > 0) == chained, calls


# ---------------------------------------------------------------- dropout

def test_dropout_deterministic_matches_jax(both):
    """Rate 0.1 with deterministic=True (the training step's call): the
    reconstruction against JAX's model with the same rate."""
    model = CGIC(CGICConfig(**DROPOUT))
    model.load_state_dict(both["state"].gen.state_dict(), strict=True)
    with torch.no_grad():
        rec, _ = model(_nchw(both["batches"][0]), 0.1, 0.4)
    np.testing.assert_allclose(rec.numpy().transpose(0, 2, 3, 1),
                               both["rec"], atol=1e-4)


def test_dropout_draws_from_the_generator():
    """deterministic=False: conv2's input is norm2's output with about
    `rate` of it zeroed (within 4 sigma) and the rest divided by exactly
    1 - rate; the model raises without a generator."""
    rate = 0.1
    block = ResnetBlock(64, 64, dropout=rate)
    with torch.no_grad():
        for p in block.parameters():
            p.normal_(0, 0.2, generator=torch.Generator().manual_seed(3))
    seen = {}
    block.norm2.register_forward_hook(lambda m, a, out: seen.update(n=out))
    block.conv2.register_forward_pre_hook(
        lambda m, a: seen.update(c=a[0]))
    x = torch.randn(2, 64, 32, 32, generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        block(x, deterministic=False,
              generator=torch.Generator().manual_seed(5))
    norm, conv_in = seen["n"], seen["c"]
    dropped = conv_in == 0
    n = conv_in.numel()
    frac = dropped.float().mean().item()
    assert abs(frac - rate) <= 4 * (rate * (1 - rate) / n) ** 0.5, frac
    assert torch.equal(conv_in[~dropped], (norm / (1.0 - rate))[~dropped])

    model = CGIC(CGICConfig(**dict(TINY, dropout=rate)))
    img = torch.zeros(1, 3, 64, 64)
    with pytest.raises(ValueError, match="generator"), torch.no_grad():
        model(img, 0.1, 0.4, deterministic=False)
    with torch.no_grad():
        a, _ = model(img, 0.1, 0.4)
        b, _ = model(img, 0.1, 0.4, deterministic=False,
                     generator=torch.Generator().manual_seed(0))
    assert not torch.equal(a, b)


def test_remat_recompute_draws_the_same_dropout():
    """deterministic=False under remat: the backward's recompute draws the
    forward's numbers again (the generator's state is put back for it and
    restored after), so the gradients equal those without remat, and the
    generator ends where the forward left it."""
    x = _nchw(np.random.default_rng(6).uniform(-1, 1, (1, 64, 64, 3)
                                               ).astype(np.float32))
    out = {}
    for flag in (False, True):
        model = CGIC(CGICConfig(**dict(DROPOUT, remat=flag)))
        gen = torch.Generator().manual_seed(9)
        rec, enc = model(x, 0.1, 0.4, deterministic=False, generator=gen)
        after_forward = gen.get_state()
        loss = torch.mean(torch.square(rec - x)) + enc.emb_loss
        out[flag] = (loss.item(), _grads(loss, model))
        assert torch.equal(gen.get_state(), after_forward)
    assert out[False][0] == out[True][0]
    for name, a in out[False][1].items():
        np.testing.assert_allclose(a, out[True][1][name], rtol=1e-4,
                                   atol=1e-5, err_msg=name)


# -------------------------------------------------------------- --remat

@pytest.mark.parametrize("yaml_remat", [None, False, True])
@pytest.mark.parametrize("flag", [False, True])
def test_cli_remat_as_jax(tmp_path, yaml_remat, flag):
    """The model config the train CLI builds from --remat (and --config)
    equals what JAX's CLI builds (`cli/train.py` `_run`)."""
    argv = ["--train-dir", str(tmp_path)] + (["--remat"] if flag else [])
    if yaml_remat is not None:
        raw = {"model": dict(TINY, ch_mult=list(TINY["ch_mult"]),
                             attn_resolutions=[8], remat=yaml_remat)}
        path = tmp_path / "cfg.yaml"
        path.write_text(yaml.safe_dump(raw))
        argv += ["--config", str(path)]
    jargs = j_train_cli.get_parser().parse_args(argv)
    if yaml_remat is None:
        want = JConfig(resolution=jargs.image_size, dtype=jargs.dtype,
                       remat=jargs.remat)
    else:
        jmodel = j_load_config(jargs.config).model
        want = dataclasses.replace(jmodel, resolution=jargs.image_size,
                                   remat=jargs.remat or jmodel.remat)
    got, _ = train_cli.run_configs(train_cli.get_parser().parse_args(argv))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.remat == (flag or bool(yaml_remat))
