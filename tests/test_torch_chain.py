"""The port's chained ResnetBlock path against the JAX package's, in float32
on the CPU: the JAX side runs its chain kernels in interpret mode
(CONTROL_GIC_CHAIN=interpret, which also lifts its element gate), the port
its plain versions with CHAIN_MIN_ELEMS = 0. Weights are carried over by
`state_dict_from_flax`. Engagement is counted on both sides: JAX's chain
calls (those without incoming stats run the moment pass on a chip) and the
port's calls of the plain versions that its dispatch takes on the CPU."""
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from control_gic_tpu.codec import CGICCodec as JCodec
from control_gic_tpu.models import CGIC as JCGIC
from control_gic_tpu.models import CGICConfig as JConfig
from control_gic_tpu.models.blocks import ResnetBlock as JResnetBlock
from control_gic_tpu.models.decoder import Decoder as JDecoder
from control_gic_tpu.models.encoder import Encoder as JEncoder
from control_gic_tpu.ops import norm_conv as jnc
from control_gic_tpu.ops.resample import upsample_nearest as jup
from control_gic_tpu_torch.codec import CGICCodec
from control_gic_tpu_torch.models import CGIC, CGICConfig
from control_gic_tpu_torch.models.blocks import ResnetBlock
from control_gic_tpu_torch.models.decoder import Decoder
from control_gic_tpu_torch.models.encoder import Encoder
from control_gic_tpu_torch.ops import fused_norm as tfn
from control_gic_tpu_torch.ops import norm_conv as tnc
from control_gic_tpu_torch.utils.from_jax import state_dict_from_flax

torch.set_num_threads(2)

TOL = dict(atol=5e-4, rtol=2e-4)


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def _port(module, params, prefix=None):
    """Load flax params into a port module; `prefix` nests a bare
    encoder/decoder tree the way CGIC's tree holds it."""
    tree = jax.tree_util.tree_map(np.asarray, params)
    sd = state_dict_from_flax({prefix: tree} if prefix else tree)
    if prefix:
        sd = {k[len(prefix) + 1:]: v for k, v in sd.items()}
    module.load_state_dict(sd, strict=True)
    return module.eval()


@pytest.fixture
def chained(monkeypatch):
    """Both sides chain every admissible shape; returns the counts:
    JAX chain calls by form and those without stats, and the port's
    plain-version calls by form and its moment passes."""
    monkeypatch.setenv("CONTROL_GIC_CHAIN", "interpret")
    monkeypatch.setattr(tnc, "CHAIN_MIN_ELEMS", 0)
    n = dict(jax_sn=0, jax_gn=0, jax_stats=0, sn=0, gn=0, moments=0)

    def counted(fn, *keys):
        def wrapped(*a, **kw):
            for k in keys:
                n[k] += 1
            return fn(*a, **kw)
        return wrapped

    impl = jnc._chain_forward_impl

    def jax_impl(*a, modulate, **kw):
        n["jax_sn" if modulate else "jax_gn"] += 1
        n["jax_stats"] += a[11] is None
        return impl(*a, modulate=modulate, **kw)

    monkeypatch.setattr(jnc, "_chain_forward_impl", jax_impl)
    monkeypatch.setattr(tnc, "chain_reference",
                        counted(tnc.chain_reference, "sn"))
    monkeypatch.setattr(tnc, "plain_chain_reference",
                        counted(tnc.plain_chain_reference, "gn"))
    monkeypatch.setattr(tfn, "gn_moments_reference",
                        counted(tfn.gn_moments_reference, "moments"))
    return n


def _assert_same_engagement(n, sn, gn, moments):
    assert (n["sn"], n["gn"], n["moments"]) == (sn, gn, moments), n
    assert (n["jax_sn"], n["jax_gn"], n["jax_stats"]) == (sn, gn, moments), n


@pytest.mark.parametrize("zq_cond", [True, False], ids=["sn", "gn"])
@pytest.mark.parametrize("cin, cout", [(128, 128), (256, 128), (128, 256)])
def test_resnet_block_chained(chained, zq_cond, cin, cout):
    rng = np.random.default_rng(cin + 2 * cout + zq_cond)
    x = jnp.asarray(rng.normal(size=(1, 16, 32, cin)), jnp.float32)
    zq = jnp.asarray(rng.normal(size=(1, 8, 16, 4)), jnp.float32)
    zarg = (zq,) if zq_cond else ()
    ja, jb = (JResnetBlock(out_channels=cout, zq_cond=zq_cond),
              JResnetBlock(out_channels=cout, zq_cond=zq_cond))
    pa = ja.init(jax.random.PRNGKey(0), x, *zarg)
    pb = jb.init(jax.random.PRNGKey(1), jnp.zeros(x.shape[:3] + (cout,)),
                 *zarg)
    zc = 4 if zq_cond else None
    ta = _port(ResnetBlock(cin, cout, zc), pa["params"])
    tb = _port(ResnetBlock(cout, cout, zc), pb["params"])
    tz = (nchw(zq),) if zq_cond else (None,)

    # block a emits its moments, block b consumes them
    jout, jmom = ja.apply(pa, x, *zarg, emit_mom=True)
    jout2 = jb.apply(pb, jout, *zarg, mom_in=jmom)
    with torch.no_grad():
        out, mom = ta(nchw(x), *tz, emit_mom=True)
        out2 = tb(out, *tz, mom_in=mom)
    np.testing.assert_allclose(nhwc(out), np.asarray(jout), **TOL)
    assert mom.shape == (1, 2, cout)
    np.testing.assert_allclose(mom.numpy(), np.asarray(jmom), **TOL)
    np.testing.assert_allclose(nhwc(out2), np.asarray(jout2), **TOL)
    # a: two chain calls, the first with the moment pass; b: two, none
    _assert_same_engagement(chained, 4 * zq_cond, 4 * (not zq_cond), 1)


def test_encoder_chained(chained):
    enc = JEncoder(ch=128, ch_mult=(1, 2, 2), num_res_blocks=2,
                   attn_resolutions=(), resolution=32, z_channels=4)
    x = jnp.asarray(np.random.default_rng(0).normal(size=(1, 32, 32, 3)),
                    jnp.float32)
    params = enc.init(jax.random.PRNGKey(0), x)
    chained.update(jax_sn=0, jax_gn=0, jax_stats=0)   # init traced it too
    want = enc.apply(params, x)
    port = _port(Encoder(ch=128, ch_mult=(1, 2, 2), num_res_blocks=2,
                         attn_resolutions=(), resolution=32, z_channels=4),
                 params["params"], "encoder")
    with torch.no_grad():
        got = port(nchw(x))
    for g, w in zip(got, want):
        np.testing.assert_allclose(nhwc(g), np.asarray(w), **TOL)
    # levels 0 (32x32) and 1 (16x16): two blocks each, block 0 emitting;
    # level 2 (8x8) is too narrow to chain
    _assert_same_engagement(chained, 0, 8, 2)


def _masks(rng, hl, wl):
    m_c = (rng.uniform(size=(1, hl // 4, wl // 4)) < 0.3).astype(np.int32)
    m_m = (rng.uniform(size=(1, hl // 2, wl // 2)) < 0.4).astype(np.int32)
    m_m = m_m * (1 - m_c.repeat(2, 1).repeat(2, 2))
    m_f = 1 - m_m.repeat(2, 1).repeat(2, 2) - m_c.repeat(4, 1).repeat(4, 2)
    return m_c, m_m, m_f


def test_decoder_chained(chained):
    kw = dict(ch=128, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(),
              resolution=32)
    dec = JDecoder(**kw)
    rng = np.random.default_rng(1)
    z = jnp.asarray(rng.normal(size=(1, 64, 64, 4)), jnp.float32)
    zq = jnp.asarray(rng.normal(size=(1, 64, 64, 4)), jnp.float32)
    masks = tuple(jnp.asarray(m) for m in _masks(rng, 64, 64))
    params = dec.init(jax.random.PRNGKey(1), z, zq, masks)
    chained.update(jax_sn=0, jax_gn=0, jax_stats=0)   # init traced it too
    want = dec.apply(params, z, zq, masks)
    port = _port(Decoder(**kw), params["params"], "decoder")
    with torch.no_grad():
        got = port(nchw(z), nchw(zq),
                   tuple(torch.from_numpy(np.array(m)) for m in masks))
    np.testing.assert_allclose(nhwc(got), np.asarray(want), **TOL)
    # level 1 (16x16) and level 0 (32x32): two blocks each, block 0
    # emitting; level 0's last block hands its moments to norm_out+conv_out
    _assert_same_engagement(chained, 9, 0, 2)


# ------------------------------------------------------------ small codec

CHAIN_CFG = dict(ch=128, ch_mult=(1, 1, 1, 1, 1), num_res_blocks=2,
                 attn_resolutions=(), n_embed=64, resolution=64)
RATIOS = {0: (0.1, 0.4), 6: (0.0, 0.0)}


@pytest.fixture(scope="module")
def codecs():
    jmodel = JCGIC(JConfig(**CHAIN_CFG))
    variables = jmodel.init(jax.random.PRNGKey(3),
                            jnp.zeros((1, 64, 64, 3)), 0.1, 0.4)
    counts = np.random.default_rng(8).integers(0, 1000, CHAIN_CFG["n_embed"])
    model = CGIC(CGICConfig(**CHAIN_CFG))
    model.load_state_dict(state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, variables["params"])), strict=True)
    return (JCodec(jmodel, variables, counts),
            CGICCodec(model, counts, device="cpu"))


def _jax_latent(m, x, rc, rm):
    """The JAX encode's pre-VQ latent (models/cgic.py encode, first half)."""
    router = m.route(x, rc, rm)
    z_f, z_m, z_c = m.encoder(x)
    m_c, m_m, m_f = (r.astype(jnp.float32)[..., None] for r in router.masks)
    h = (jup(z_c, 4) * jup(m_c, 4) + jup(z_m, 2) * jup(m_m, 2) + z_f * m_f)
    return m.quant_conv(h)


def _files(d):
    return {f: open(os.path.join(d, f), "rb").read()
            for f in sorted(os.listdir(d))}


@pytest.mark.parametrize("mode", sorted(RATIOS))
def test_chained_codec_streams_byte_identical(codecs, chained, mode,
                                              tmp_path):
    jcodec, codec = codecs
    rc, rm = RATIOS[mode]
    image = np.random.default_rng(30 + mode).uniform(0, 1, (64, 64, 3)
                                                     ).astype(np.float32)
    # tie-free seed: the nearest code beats the next by more than the
    # difference of the two sides' latents can move it
    latent = np.asarray(jcodec.model.apply(
        jcodec.variables, jnp.asarray(image)[None], rc, rm,
        method=_jax_latent))
    cb = np.asarray(jcodec.variables["params"]["codebook"])
    d = np.sort(((latent.reshape(-1, 1, 4) - cb[None]) ** 2).sum(-1), axis=1)
    with torch.no_grad():
        x = torch.from_numpy(image).permute(2, 0, 1)[None]
        got_latent = codec.model.latent(x, codec.model.route(x, rc, rm))
    lat_err = float(np.abs(nhwc(got_latent) - latent).max())
    assert lat_err <= 5e-4
    # a latent error delta moves the gap between codes i and j by exactly
    # 2 delta.(c_j - c_i), at most 16 * lat_err * max|c| over 4 dims
    assert (d[:, 1] - d[:, 0]).min() > 16 * lat_err * np.abs(cb).max()

    rec, bpp, enc = codec.compress(image, rc, rm,
                                   out_dir=str(tmp_path / "port"))
    jenc = jcodec.encode(image, rc, rm)
    jenc.write(str(tmp_path / "jax"))
    assert enc.mode == jenc.mode == mode and bpp > 0
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")
    ind, masks = codec._rebuild(enc)
    jind, jmasks = jcodec._rebuild(jenc)
    np.testing.assert_array_equal(ind, jind)
    for a, b in zip(masks, jmasks):
        np.testing.assert_array_equal(a, b)
    want = np.asarray(jcodec.model.apply(
        jcodec.variables, jnp.asarray(jind)[None],
        tuple(jnp.asarray(m)[None] for m in jmasks),
        method=JCGIC.decode_indices))
    np.testing.assert_allclose(rec, want[0], atol=5e-4)
    # the trunks chained on both sides: encoder levels 0-2 (64..16 px) and
    # decoder levels 2-0 plus norm_out, each time the latent, the encode
    # and the decode ran
    assert chained["gn"] > 0 and chained["sn"] > 0
