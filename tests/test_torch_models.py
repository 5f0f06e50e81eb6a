"""The port's models against the JAX package's in float32 on the CPU, with
the JAX model's weights carried over by `state_dict_from_flax`."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from control_gic_tpu.models import CGIC as JCGIC
from control_gic_tpu.models import CGICConfig as JConfig
from control_gic_tpu.models import blocks as jblocks
from control_gic_tpu.ops.resample import upsample_nearest as jup
from control_gic_tpu.utils.port_torch import port_cgic_state_dict
from control_gic_tpu_torch.models import CGIC, CGICConfig
from control_gic_tpu_torch.utils.from_jax import state_dict_from_flax

torch.set_num_threads(2)

SMALL = dict(n_embed=64, embed_dim=4, z_channels=4, ch=32,
             ch_mult=(1, 1, 2, 2, 2), num_res_blocks=1,
             attn_resolutions=(8,), resolution=64)
TOL = dict(atol=1e-5, rtol=1e-4)


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


@pytest.fixture(scope="module")
def pair():
    """(JAX model, its variables, the port's model with the same weights)."""
    jmodel = JCGIC(JConfig(**SMALL))
    variables = jmodel.init(jax.random.PRNGKey(1),
                            jnp.zeros((1, 64, 64, 3)), 0.1, 0.4)
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    model = CGIC(CGICConfig(**SMALL)).eval()
    model.load_state_dict(state_dict_from_flax(params), strict=True)
    return jmodel, variables, params, model


def _image(seed, b=1):
    return np.random.default_rng(seed).uniform(0, 1, (b, 64, 64, 3)).astype(
        np.float32)


def test_full_width_param_count():
    model = CGIC(CGICConfig())
    count = lambda m: sum(p.numel() for p in m.parameters())
    assert count(model) == 130_358_967
    assert count(model.encoder) == 52_351_116
    assert count(model.decoder) == 78_003_715
    assert count(model.quant_conv) == count(model.post_quant_conv) == 20
    assert model.codebook.numel() == 4_096


def test_weights_round_trip_through_port_torch(pair):
    _, _, params, model = pair
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    back, counts = port_cgic_state_dict(sd)
    flat = lambda t: {jax.tree_util.keystr(p): v for p, v in
                      jax.tree_util.tree_flatten_with_path(t)[0]}
    got, want = flat(back), flat(params)
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert counts.shape == (SMALL["n_embed"],)


def _jax_block(cls, params, *args, **kw):
    return np.asarray(cls(dtype=jnp.float32, **kw).apply({"params": params},
                                                          *args))


# (flax params path, flax module, its kwargs, port submodule path, zq?, in ch,
#  spatial size)
BLOCKS = [
    (("encoder", "down_2_block_0"), jblocks.ResnetBlock,
     dict(out_channels=64), "encoder.down.2.block.0", False, 32, 16),
    (("encoder", "down_3_attn_0"), jblocks.AttnBlock, {},
     "encoder.down.3.attn.0", False, 64, 8),
    (("encoder", "down_0_downsample"), jblocks.Downsample, {},
     "encoder.down.0.downsample", False, 32, 64),
    (("decoder", "up_1_block_0"), jblocks.ResnetBlock,
     dict(out_channels=32, zq_cond=True), "decoder.up.1.block.0", True, 64, 32),
    (("decoder", "up_3_attn_0"), jblocks.AttnBlock, dict(zq_cond=True),
     "decoder.up.3.attn.0", True, 64, 8),
    (("decoder", "up_2_upsample"), jblocks.Upsample, {},
     "decoder.up.2.upsample", False, 64, 16),
    (("decoder", "norm_out"), jblocks.SpatialNorm, {},
     "decoder.norm_out", True, 32, 64),
]


@pytest.mark.parametrize("case", BLOCKS, ids=[b[3] for b in BLOCKS])
def test_block_parity(pair, case):
    path, cls, kw, port_path, with_zq, cin, hw = case
    _, _, params, model = pair
    sub = params
    for p in path:
        sub = sub[p]
    rng = np.random.default_rng(len(port_path))
    x = rng.normal(size=(2, hw, hw, cin)).astype(np.float32)
    zq = rng.uniform(-0.5, 0.5, (2, 16, 16, 4)).astype(np.float32)
    jargs = (jnp.asarray(x),) + ((jnp.asarray(zq),) if with_zq else ())
    want = _jax_block(cls, sub, *jargs, **kw)
    block = model.get_submodule(port_path)
    with torch.no_grad():
        got = block(nchw(x), *((nchw(zq),) if with_zq else ()))
    np.testing.assert_allclose(nhwc(got), want, **TOL)


def _jax_latent(m, x, rc, rm):
    """The JAX encode's pre-VQ latent (models/cgic.py encode, first half)."""
    router = m.route(x, rc, rm)
    z_f, z_m, z_c = m.encoder(x)
    m_c, m_m, m_f = (r.astype(jnp.float32)[..., None] for r in router.masks)
    h = (jup(z_c, 4) * jup(m_c, 4) + jup(z_m, 2) * jup(m_m, 2) + z_f * m_f)
    return m.quant_conv(h)


@pytest.mark.parametrize("ratios", [(0.1, 0.4), (0.0, 0.8), (0.3, 0.0)])
def test_encode_matches_jax(pair, ratios):
    jmodel, variables, params, model = pair
    x = _image(11, b=2)
    want = jmodel.apply(variables, jnp.asarray(x), *ratios,
                        method=JCGIC.encode)
    latent = np.asarray(jmodel.apply(variables, jnp.asarray(x), *ratios,
                                     method=_jax_latent))
    # tie-free seed: at every position the nearest code beats the next by
    # more than 1e-5 in the f32 distance
    cb = params["codebook"]
    d = np.sort(((latent.reshape(-1, 1, 4) - cb[None]) ** 2).sum(-1), axis=1)
    assert (d[:, 1] - d[:, 0]).min() > 1e-5
    with torch.no_grad():
        router = model.route(nchw(x), *ratios)
        got_latent = model.latent(nchw(x), router)
        got = model.encode(nchw(x), *ratios)
    assert got.router.mode == want.router.mode
    for g, w in zip(got.router.masks, want.router.masks):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_allclose(nhwc(got_latent), latent, atol=1e-4)
    np.testing.assert_array_equal(got.indices.numpy(),
                                  np.asarray(want.indices))
    np.testing.assert_array_equal(got.counts.numpy(), np.asarray(want.counts))
    np.testing.assert_array_equal(got.grain_indices.numpy(),
                                  np.asarray(want.grain_indices))


def test_decode_indices_matches_jax(pair):
    jmodel, variables, _, model = pair
    x = _image(12, b=2)
    enc = jmodel.apply(variables, jnp.asarray(x), 0.1, 0.4,
                       method=JCGIC.encode)
    want = np.asarray(jmodel.apply(variables, enc.indices, enc.router.masks,
                                   method=JCGIC.decode_indices))
    masks = tuple(torch.from_numpy(np.asarray(m)) for m in enc.router.masks)
    with torch.no_grad():
        got = model.decode_indices(torch.from_numpy(np.asarray(enc.indices)),
                                   masks)
    assert want.shape == (2, 64, 64, 3)
    np.testing.assert_allclose(nhwc(got), want, atol=1e-4)


def test_forward_round_trip_matches_jax(pair):
    jmodel, variables, _, model = pair
    x = _image(13)
    rec, enc = jmodel.apply(variables, jnp.asarray(x), 0.1, 0.4)
    with torch.no_grad():
        got, genc = model(nchw(x), 0.1, 0.4)
    np.testing.assert_array_equal(genc.indices.numpy(),
                                  np.asarray(enc.indices))
    np.testing.assert_allclose(nhwc(got), np.asarray(rec), atol=1e-4)
    np.testing.assert_allclose(genc.emb_loss.item(), float(enc.emb_loss),
                               rtol=1e-4)


@pytest.mark.parametrize("subpixel", ["0", "1"])
def test_upsample_switch_matches_jax(pair, monkeypatch, subpixel):
    """CONTROL_GIC_SUBPIXEL, read at call time by both packages: "0" runs
    nearest x2 then the 3x3 conv (the subpixel path, patched to raise, is
    not taken), "1" the subpixel form; same weights either way."""
    from control_gic_tpu_torch.models import blocks as tblocks
    monkeypatch.setenv("CONTROL_GIC_SUBPIXEL", subpixel)
    if subpixel == "0":
        def refuse(*args):
            raise AssertionError("the subpixel form ran with the switch off")
        monkeypatch.setattr(tblocks, "upsample2_conv3x3", refuse)
    _, _, params, model = pair
    x = np.random.default_rng(21).normal(size=(2, 16, 16, 64)).astype(
        np.float32)
    want = _jax_block(jblocks.Upsample, params["decoder"]["up_2_upsample"],
                      jnp.asarray(x))
    with torch.no_grad():
        got = nhwc(model.get_submodule("decoder.up.2.upsample")(nchw(x)))
    assert got.shape == want.shape == (2, 32, 32, 64)
    assert np.abs(got - want).max() <= 1e-5 * max(1.0, np.abs(want).max())
