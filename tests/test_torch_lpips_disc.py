"""The port's training-loss modules against the JAX package's, on the CPU:
LPIPS for all three backbones (the squeeze net on an odd size, which
exercises its ceil-mode pools), the bundled lin heads, and the PatchGAN
discriminator in train and eval mode with flax's BatchNorm running stats,
and with ActNorm. Params are carried over by utils/from_jax."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from control_gic_tpu.models import discriminator as jdisc
from control_gic_tpu.models import lpips as jlpips
from control_gic_tpu_torch.models import discriminator as tdisc
from control_gic_tpu_torch.models import lpips as tlpips
from control_gic_tpu_torch.utils.from_jax import (disc_state_dict_from_flax,
                                                  lpips_state_dict_from_flax)

torch.set_num_threads(2)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("net, size", [("alex", 64), ("vgg", 32),
                                       ("squeeze", 66)])
def test_lpips_matches_jax(net, size):
    rng = np.random.default_rng(len(net))
    a = rng.uniform(0, 1, (2, size, size, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.2, a.shape), 0, 1).astype(np.float32)
    mod = jlpips.LPIPS(net=net)
    params = mod.init(jax.random.PRNGKey(4), jnp.asarray(a),
                      jnp.asarray(b))["params"]
    params = jlpips.with_bundled_lin_heads(params, net)
    port = tlpips.LPIPS(net)
    port.load_state_dict(lpips_state_dict_from_flax(_np_tree(params), net),
                         strict=True)
    for normalize in (True, False):
        want = np.asarray(mod.apply({"params": params}, jnp.asarray(a),
                                    jnp.asarray(b), normalize=normalize))
        with torch.no_grad():
            got = port(_nchw(a), _nchw(b), normalize=normalize).numpy()
        assert got.shape == (2,)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("net", ["alex", "vgg", "squeeze", "vgg16"])
def test_bundled_lin_heads_equal_jax(net):
    got = tlpips.bundled_lin_heads(net)
    want = jlpips.bundled_lin_heads(net)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    model = tlpips.with_bundled_lin_heads(tlpips.LPIPS(net))
    for k in want:
        np.testing.assert_array_equal(getattr(model, k).detach().numpy(),
                                      np.asarray(want[k]))


def test_lpips_of_an_image_with_itself_is_zero():
    x = torch.rand(1, 3, 64, 64, generator=torch.Generator().manual_seed(0))
    model = tlpips.with_bundled_lin_heads(tlpips.LPIPS())
    with torch.no_grad():
        assert float(model(x, x).abs().max()) <= 1e-6
    assert set(model.state_dict()) == (
        {f"lin{k}" for k in range(5)}
        | {f"net.{i}.{w}" for i in (0, 3, 6, 8, 10) for w in ("weight", "bias")})


def _disc_pair(use_actnorm, x):
    mod = jdisc.NLayerDiscriminator(use_actnorm=use_actnorm)
    variables = mod.init(jax.random.PRNGKey(5), jnp.asarray(x), train=False)
    port = tdisc.NLayerDiscriminator(use_actnorm=use_actnorm)
    port.load_state_dict(disc_state_dict_from_flax(_np_tree(variables)),
                         strict=True)
    return mod, variables, port


def test_discriminator_train_and_eval_match_jax():
    """Train mode normalises with the batch's stats and updates the running
    stats with the biased variance (flax), twice in a row as the training
    step does; eval mode then uses them."""
    rng = np.random.default_rng(1)
    x1 = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    x2 = (0.5 * rng.normal(size=(2, 64, 64, 3)) + 0.2).astype(np.float32)
    mod, variables, port = _disc_pair(False, x1)
    # scale and bias away from the identity, so that both are exercised
    params = jax.tree_util.tree_map(lambda p: p, variables["params"])
    for name in ("bn1", "bn2"):
        c = params[name]["scale"].shape[0]
        params[name] = {"scale": jnp.asarray(rng.uniform(0.5, 1.5, c),
                                             jnp.float32),
                        "bias": jnp.asarray(rng.normal(0, 0.1, c), jnp.float32)}
    variables = {"params": params, "batch_stats": variables["batch_stats"]}
    port.load_state_dict(disc_state_dict_from_flax(_np_tree(variables)),
                         strict=True)

    port.train()
    stats = variables["batch_stats"]
    for x in (x1, x2):
        want, mutated = mod.apply({"params": params, "batch_stats": stats},
                                  jnp.asarray(x), train=True,
                                  mutable=["batch_stats"])
        stats = mutated["batch_stats"]
        with torch.no_grad():
            got = port(_nchw(x))
        np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1),
                                   np.asarray(want), rtol=1e-4, atol=1e-5)
        for name, s in stats.items():
            bn = getattr(port, name)
            np.testing.assert_allclose(bn.running_mean.numpy(),
                                       np.asarray(s["mean"]), atol=1e-5)
            np.testing.assert_allclose(bn.running_var.numpy(),
                                       np.asarray(s["var"]), atol=1e-5)
    port.eval()
    want = mod.apply({"params": params, "batch_stats": stats},
                     jnp.asarray(x1), train=False)
    with torch.no_grad():
        got = port(_nchw(x1))
    assert got.shape == (2, 1, 14, 14)
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1),
                               np.asarray(want), rtol=1e-4, atol=1e-5)


def test_discriminator_gradient_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    mod, variables, port = _disc_pair(False, x)

    def loss(params):
        out, _ = mod.apply({"params": params,
                            "batch_stats": variables["batch_stats"]},
                           jnp.asarray(x), train=True,
                           mutable=["batch_stats"])
        return jnp.mean(jax.nn.relu(1.0 - out))

    want = disc_state_dict_from_flax({"params": _np_tree(
        jax.grad(loss)(variables["params"]))})
    port.train()
    names, params = zip(*port.named_parameters())
    got = torch.autograd.grad(torch.relu(1.0 - port(_nchw(x))).mean(),
                              params)
    assert set(names) == set(want)
    for name, g in zip(names, got):
        w = want[name].numpy()
        assert np.abs(g.numpy() - w).max() <= 1e-4 * np.abs(w).max(), name


def test_actnorm_discriminator_matches_jax():
    """ActNorm: the inner convs keep their bias, there are no running
    stats, and the data init agrees."""
    rng = np.random.default_rng(3)
    x = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    mod, variables, port = _disc_pair(True, x)
    assert "batch_stats" not in variables
    assert port.conv1.bias is not None and not list(port.buffers())
    want = mod.apply(variables, jnp.asarray(x), train=True)
    with torch.no_grad():
        got = port.train()(_nchw(x))
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1),
                               np.asarray(want), rtol=1e-4, atol=1e-5)

    h = (3.0 + 2.0 * rng.normal(size=(4, 8, 8, 5))).astype(np.float32)
    jloc, jscale = jdisc.actnorm_data_init(jnp.asarray(h))
    loc, scale = tdisc.actnorm_data_init(_nchw(h))
    np.testing.assert_allclose(loc.numpy(), np.asarray(jloc), rtol=1e-5)
    np.testing.assert_allclose(scale.numpy(), np.asarray(jscale), rtol=1e-4)
    norm = tdisc.ActNorm(5)
    with torch.no_grad():
        norm.loc.copy_(loc)
        norm.scale.copy_(scale)
        y = norm(_nchw(h)).transpose(0, 1).reshape(5, -1)
    np.testing.assert_allclose(y.mean(1).numpy(), 0.0, atol=1e-4)
    np.testing.assert_allclose(y.std(1).numpy(), 1.0, atol=1e-3)


def test_bias_rule_and_params():
    bn = tdisc.NLayerDiscriminator()
    assert bn.conv1.bias is None and bn.conv2.bias is None
    assert bn.conv0.bias is not None and bn.conv_out.bias is not None
    n_params = sum(p.numel() for p in bn.parameters())
    x = jnp.zeros((1, 32, 32, 3))
    want = jdisc.NLayerDiscriminator().init(jax.random.PRNGKey(0), x)
    assert n_params == sum(np.size(v) for v in
                           jax.tree_util.tree_leaves(want["params"]))
