"""The port's training step against the JAX Trainer on the CPU, from the same
params and batch: the tiny config of tests/test_train_cli.py, batch 2. The
JAX side's create_train_state params (generator, discriminator with
batch_stats, LPIPS) are carried into the port; one step's losses, metrics,
generator gradients and updated batch_stats must agree, and so must the
optimizer and the EMA fed identical gradients. The chained ResnetBlock's
gradient is held against jax.grad under CONTROL_GIC_CHAIN=interpret, on the
port's plain path and through its autograd Functions (_ChainFn,
_GnMomentsFn) with the kernels replaced by their plain versions."""
import copy

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from control_gic_tpu.models.blocks import ResnetBlock as JResnetBlock
from control_gic_tpu.models.cgic import CGICConfig as JConfig
from control_gic_tpu.train import TrainConfig as JTrainConfig
from control_gic_tpu.train import Trainer as JTrainer
from control_gic_tpu.train import create_train_state as j_create_state
from control_gic_tpu.train.losses import discriminator_loss as j_disc_loss
from control_gic_tpu.train.state import ema_update as j_ema_update
from control_gic_tpu.train.state import make_optimizer as j_make_optimizer
from control_gic_tpu_torch.models import CGICConfig
from control_gic_tpu_torch.models.blocks import ResnetBlock
from control_gic_tpu_torch.ops import fused_norm as tfn
from control_gic_tpu_torch.ops import norm_conv as tnc
from control_gic_tpu_torch.train import TrainConfig, Trainer, create_train_state
from control_gic_tpu_torch.train.state import (apply_gradients, ema_update,
                                               make_optimizer)
from control_gic_tpu_torch.utils.from_jax import (disc_state_dict_from_flax,
                                                  lpips_state_dict_from_flax,
                                                  state_dict_from_flax)

torch.set_num_threads(2)

TINY = dict(n_embed=32, embed_dim=4, z_channels=4, ch=32,
            ch_mult=(1, 1, 2, 2, 2), num_res_blocks=1, attn_resolutions=(8,),
            resolution=64)
LOSS_RTOL = 1e-4


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-12))


@pytest.fixture(scope="module")
def both():
    """The JAX state and trainer, the port's state carrying its params, the
    batch, and the JAX side's generator loss, aux and gradients."""
    jcfg, tcfg = JConfig(**TINY), JTrainConfig()
    jstate = jax.jit(j_create_state, static_argnums=(1, 2, 3))(
        jax.random.PRNGKey(0), jcfg, tcfg, 64)
    jtrainer = JTrainer(jcfg, tcfg)
    x = np.random.default_rng(0).uniform(-1, 1, (2, 64, 64, 3)
                                         ).astype(np.float32)
    disc_vars = {"params": jstate.disc_params,
                 "batch_stats": jstate.disc_batch_stats}
    (loss, aux), grads = jax.jit(jax.value_and_grad(
        jtrainer._forward_losses, has_aux=True))(
        jstate.gen_params, disc_vars, jstate.lpips_params, jnp.asarray(x))

    cfg = CGICConfig(**TINY)
    state = create_train_state(cfg, TrainConfig(), device="cpu")
    gen_sd = state_dict_from_flax(_np_tree(jstate.gen_params))
    state.gen.load_state_dict(gen_sd, strict=True)
    state.disc.load_state_dict(disc_state_dict_from_flax(_np_tree(disc_vars)),
                               strict=True)
    state.lpips.load_state_dict(lpips_state_dict_from_flax(
        _np_tree(jstate.lpips_params)), strict=True)
    for k, v in state.ema.items():
        v.copy_(gen_sd[k])
    return dict(jstate=jstate, jtrainer=jtrainer, disc_vars=disc_vars, x=x,
                jloss=float(loss), jaux=aux, jgrads=_np_tree(grads),
                state=state, trainer=Trainer(cfg, TrainConfig()))


def test_carried_params_are_complete(both):
    """Every port parameter came from the JAX tree (strict loads), and the
    LPIPS heads are the bundled ones on both sides."""
    state = both["state"]
    n_jax = sum(np.size(v) for v in jax.tree_util.tree_leaves(
        both["jstate"].gen_params))
    assert n_jax == sum(p.numel() for p in state.gen.parameters())
    np.testing.assert_array_equal(
        state.lpips.lin0.numpy(), np.asarray(both["jstate"].lpips_params["lin0"]))
    assert not any(p.requires_grad for p in state.lpips.parameters())


def test_generator_losses_match_jax(both):
    state, trainer = both["state"], both["trainer"]
    with torch.no_grad():
        loss, rec, enc, metrics = trainer.forward_losses(
            state, trainer.to_input(state, both["x"]))
    _, jenc, jmetrics = both["jaux"]
    assert abs(loss.item() - both["jloss"]) <= LOSS_RTOL * abs(both["jloss"])
    assert set(metrics) == set(jmetrics)
    for k, v in jmetrics.items():
        assert _rel(metrics[k].item(), float(v)) <= LOSS_RTOL, k
    np.testing.assert_array_equal(enc.indices.numpy(),
                                  np.asarray(jenc.indices))
    np.testing.assert_array_equal(enc.counts.numpy(), np.asarray(jenc.counts))


def test_generator_gradients_match_jax(both):
    state, trainer = both["state"], both["trainer"]
    names, params = zip(*state.gen.named_parameters())
    loss, _, _, _ = trainer.forward_losses(state,
                                           trainer.to_input(state, both["x"]))
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    want = state_dict_from_flax(both["jgrads"])
    assert set(want) == set(names)
    # within 1e-3 of each tensor's max, plus f32 rounding noise at 1e-6 of
    # the model's largest gradient: a tensor whose true gradient is 0 (a
    # conv bias right before a GroupNorm, a key bias under the softmax)
    # holds only that noise
    noise = 1e-6 * max(np.abs(w.numpy()).max() for w in want.values())
    bad = {}
    for name, g in zip(names, grads):
        w = want[name].numpy()
        g = np.zeros_like(w) if g is None else g.numpy()
        err = np.abs(g - w).max()
        if not err <= 1e-3 * np.abs(w).max() + noise:
            bad[name] = (float(err), float(np.abs(w).max()))
    assert not bad, bad
    assert all(p.grad is None for p in state.disc.parameters())


def test_train_step_matches_jax_losses_and_batch_stats(both):
    """One full port step (on a copy of the state): its metrics against
    JAX's generator metrics and discriminator_loss, its discriminator's
    running stats against JAX's batch_stats after the real and the fake
    pass, and its bookkeeping."""
    state = copy.deepcopy(both["state"])
    before = {k: v.clone() for k, v in state.gen.state_dict().items()}
    state, metrics = both["trainer"].train_step(state, both["x"])

    jrec, jenc, jmetrics = both["jaux"]
    disc, dv = both["jtrainer"].disc, both["disc_vars"]
    real, m1 = disc.apply(dv, jnp.asarray(both["x"]), train=True,
                          mutable=["batch_stats"])
    fake, m2 = disc.apply({"params": dv["params"], **m1}, jrec, train=True,
                          mutable=["batch_stats"])
    jd_loss, jd_metrics = j_disc_loss(real, fake, JTrainConfig().loss)
    want = {**{f"train/{k}": float(v) for k, v in {**jmetrics,
                                                   **jd_metrics}.items()},
            "train/aeloss": both["jloss"], "train/discloss": float(jd_loss)}
    assert set(metrics) == set(want)
    for k, v in want.items():
        assert _rel(metrics[k].item(), v) <= LOSS_RTOL, k
    for name, stats in m2["batch_stats"].items():
        bn = getattr(state.disc, name)
        np.testing.assert_allclose(bn.running_mean.numpy(),
                                   np.asarray(stats["mean"]), atol=1e-5)
        np.testing.assert_allclose(bn.running_var.numpy(),
                                   np.asarray(stats["var"]), atol=1e-5)
    assert state.step == 1 and state.ema_num_updates == 1
    np.testing.assert_array_equal(state.codebook_counts.numpy(),
                                  np.asarray(jenc.counts))
    after = state.gen.state_dict()
    assert all(not torch.equal(before[k], after[k]) for k in before)
    assert all(p.grad is None for p in state.disc.parameters())


def test_optimizer_and_ema_match_optax():
    """Adam after clip-by-value and the LitEma shadow, fed the same numpy
    gradients (some beyond the clip) for 4 steps."""
    rng = np.random.default_rng(3)
    shapes = {"a": (5, 7), "b": (11,)}
    p0 = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (3 * rng.normal(size=s)).astype(np.float32)
              for k, s in shapes.items()} for _ in range(4)]
    jcfg, cfg = JTrainConfig(), TrainConfig()

    opt = j_make_optimizer(jcfg)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    jopt, jema, jn = opt.init(jp), dict(jp), jnp.zeros((), jnp.int32)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in p0.items()}
    topt = make_optimizer(tp.values(), cfg)
    tema = {k: v.detach().clone() for k, v in tp.items()}
    tn = 0
    for g in grads:
        updates, jopt = opt.update({k: jnp.asarray(v) for k, v in g.items()},
                                   jopt, jp)
        jp = optax.apply_updates(jp, updates)
        jema, jn = j_ema_update(jema, jp, jn, jcfg.ema_decay)
        apply_gradients(topt, list(tp.values()),
                        [torch.from_numpy(g[k]) for k in tp], cfg)
        tn = ema_update(tema, tp.items(), tn, cfg.ema_decay)
    assert tn == int(jn) == 4
    for k in shapes:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                   rtol=0, atol=1e-7)
        np.testing.assert_allclose(tema[k].numpy(), np.asarray(jema[k]),
                                   rtol=0, atol=1e-7)


def test_apply_gradients_clips_and_zero_fills():
    p = torch.nn.Parameter(torch.zeros(3))
    q = torch.nn.Parameter(torch.ones(2))
    cfg = TrainConfig(learning_rate=0.1)
    opt = make_optimizer([p, q], cfg)
    apply_gradients(opt, [p, q], [torch.tensor([5.0, -5.0, 0.5]), None], cfg)
    # a clipped gradient of ±1 and one of 0.5 move Adam's first step by lr
    np.testing.assert_allclose(p.detach().numpy(), [-0.1, 0.1, -0.1],
                               rtol=1e-5)
    np.testing.assert_array_equal(q.detach().numpy(), [1.0, 1.0])
    assert p.grad is None and q.grad is None


# ------------------------------------------------- chained ResnetBlock grad

def _fake_chain_kernel(x, cw, cb, gs, gb, stats, res=None, emit_mom=True,
                       act_swish=True, zq_r=None, wy=None, by=None, wb=None,
                       bb=None):
    """The chain kernel's plain version in its wrapper's signature."""
    kw = dict(res=res, stats=stats, act_swish=act_swish, emit_mom=emit_mom)
    if zq_r is not None:
        return tnc.chain_reference(x, zq_r, gs, gb, wy, by, wb, bb, cw, cb,
                                   **kw)
    return tnc.plain_chain_reference(x, gs, gb, cw, cb, **kw)


@pytest.mark.parametrize("through_functions", [False, True],
                         ids=["plain", "autograd_functions"])
@pytest.mark.parametrize("zq_cond", [True, False], ids=["sn", "gn"])
def test_chained_resnet_block_grad_matches_jax(monkeypatch, zq_cond,
                                               through_functions):
    monkeypatch.setenv("CONTROL_GIC_CHAIN", "interpret")
    monkeypatch.setattr(tnc, "CHAIN_MIN_ELEMS", 0)
    calls = {"chain": 0, "moments": 0}
    if through_functions:
        # the dispatch takes its kernel path on CPU tensors, with the
        # kernels replaced by their plain versions: the gradient then flows
        # through _ChainFn and _GnMomentsFn
        def chain(*a, **kw):
            calls["chain"] += 1
            assert not torch.is_grad_enabled()
            return _fake_chain_kernel(*a, **kw)

        def moments(x):
            calls["moments"] += 1
            return tfn.gn_moments_reference(x)

        monkeypatch.setattr(tnc, "use_kernel", lambda t: True)
        monkeypatch.setattr(tfn, "use_kernel", lambda t: True)
        monkeypatch.setattr(tnc, "chain_kernel", chain)
        monkeypatch.setattr(tfn, "gn_moments_kernel", moments)
    rng = np.random.default_rng(40 + zq_cond)
    x = jnp.asarray(rng.normal(size=(1, 16, 32, 128)), jnp.float32)
    zq = jnp.asarray(rng.normal(size=(1, 8, 16, 4)), jnp.float32)
    r = jnp.asarray(rng.normal(size=(1, 16, 32, 128)), jnp.float32)
    zarg = (zq,) if zq_cond else ()
    jblock = JResnetBlock(out_channels=128, zq_cond=zq_cond)
    variables = jblock.init(jax.random.PRNGKey(2), x, *zarg)

    def jloss(params, x):
        out, mom = jblock.apply({"params": params}, x, *zarg, emit_mom=True)
        return jnp.sum(out * r) + 1e-3 * jnp.sum(mom)

    jg_params, jg_x = jax.grad(jloss, argnums=(0, 1))(variables["params"], x)

    block = ResnetBlock(128, 128, 4 if zq_cond else None)
    block.load_state_dict(state_dict_from_flax(_np_tree(variables["params"])),
                          strict=True)
    tx = torch.from_numpy(np.asarray(x).transpose(0, 3, 1, 2).copy()
                          ).requires_grad_()
    tz = (torch.from_numpy(np.asarray(zq).transpose(0, 3, 1, 2).copy())
          if zq_cond else None)
    tr = torch.from_numpy(np.asarray(r).transpose(0, 3, 1, 2).copy())
    out, mom = block(tx, tz, emit_mom=True)
    loss = (out * tr).sum() + 1e-3 * mom.sum()
    names, params = zip(*block.named_parameters())
    grads = torch.autograd.grad(loss, (tx,) + params)
    if through_functions:
        assert calls == {"chain": 2, "moments": 1}
    want = state_dict_from_flax(_np_tree(jg_params))
    gx = grads[0].numpy().transpose(0, 2, 3, 1)
    assert np.abs(gx - np.asarray(jg_x)).max() <= 1e-4 * np.abs(
        np.asarray(jg_x)).max()
    for name, g in zip(names, grads[1:]):
        w = want[name].numpy()
        assert np.abs(g.numpy() - w).max() <= 1e-4 * np.abs(w).max(), name
