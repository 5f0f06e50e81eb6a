"""The port's H-sharded codec (parallel/spatial_encoder.py,
spatial_decoder.py, spatial_codec.py) on CPU meshes, mirroring
tests/test_spatial_encoder.py, test_spatial_decoder.py and
test_spatial_codec.py at their configs:

  - the sharded encoder on 2 shards against CGIC.encode: masks and indices
    equal;
  - the sharded decoder on 4 shards and on 1 (the collective-free
    specialisation) against the Decoder module, within JAX's 2e-4 abs /
    2e-3 rel;
  - compress_spatial on 1 and 2 shards against JAX's compress_spatial on
    make_mesh(1) and make_mesh(2) and against the port's single-device
    codec, from the same weights and counts: streams byte-identical, bpp
    equal, reconstructions within 2e-4 abs / 2e-3 rel; and an odd-size
    image (padded to the sharded encoder's alignment) against JAX's."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from control_gic_tpu.codec import CGICCodec as JCodec
from control_gic_tpu.models.cgic import CGIC as JCGIC
from control_gic_tpu.models.cgic import CGICConfig as JConfig
from control_gic_tpu.parallel.mesh import make_mesh as j_make_mesh
from control_gic_tpu.parallel.spatial_codec import (
    compress_spatial as j_compress_spatial)
from control_gic_tpu_torch.codec import CGICCodec
from control_gic_tpu_torch.models import CGIC, CGICConfig
from control_gic_tpu_torch.models.blocks import (Conv2d, GroupNorm32,
                                                 lecun_normal_)
from control_gic_tpu_torch.models.decoder import Decoder
from control_gic_tpu_torch.parallel.mesh import make_mesh
from control_gic_tpu_torch.parallel.spatial_codec import (compress_spatial,
                                                          decode_spatial)
from control_gic_tpu_torch.parallel.spatial_decoder import (
    decode_spatial_sharded)
from control_gic_tpu_torch.parallel.spatial_encoder import (
    encode_spatial_sharded)
from control_gic_tpu_torch.utils.from_jax import state_dict_from_flax

torch.set_num_threads(2)

CFG = dict(n_embed=32, embed_dim=4, z_channels=4, ch=32,
           ch_mult=(1, 2, 2, 4, 4), num_res_blocks=1, attn_resolutions=(8,),
           resolution=128)
TOL = dict(atol=2e-4, rtol=2e-3)


def cpu_mesh(n):
    return make_mesh(n, devices=["cpu"] * n)


@pytest.fixture(scope="module")
def codecs():
    """JAX's codec and the port's, same weights (JAX's init) and counts."""
    jmodel = JCGIC(JConfig(**CFG))
    variables = jax.jit(lambda k: jmodel.init(
        k, jnp.zeros((1, 128, 128, 3)), 0.1, 0.4))(jax.random.PRNGKey(0))
    counts = np.arange(1, CFG["n_embed"] + 1)
    model = CGIC(CGICConfig(**CFG))
    model.load_state_dict(state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, variables["params"])), strict=True)
    return JCodec(jmodel, variables, counts), CGICCodec(model, counts,
                                                        device="cpu")


@pytest.fixture(scope="module")
def image():
    return np.random.default_rng(0).uniform(0, 1, (128, 128, 3)).astype(
        np.float32)


def test_sharded_encoder_matches_unsharded(codecs):
    _, codec = codecs
    model = codec.model
    x = torch.from_numpy(np.random.default_rng(1).uniform(
        0, 1, (1, 3, 128, 128)).astype(np.float32))
    with torch.no_grad():
        enc = model.encode(x, 0.1, 0.4)
    idx, masks = encode_spatial_sharded(
        cpu_mesh(2), model.encoder, model.quant_conv, model.codebook, x,
        0.1, 0.4)
    for got, want in zip(masks, enc.router.masks):
        assert torch.equal(got, want)
    assert torch.equal(idx, enc.indices)


@pytest.mark.parametrize("n", [4, 1])
def test_sharded_decoder_matches_unsharded(n):
    rng = np.random.default_rng(2)
    dec = Decoder(ch=32, out_ch=3, ch_mult=(1, 2, 2, 4, 4), num_res_blocks=1,
                  attn_resolutions=(8,), resolution=64)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():     # lecun-normal convs, random biases and norms
        for mod in dec.modules():
            if isinstance(mod, Conv2d):
                lecun_normal_(mod.weight, gen)
                mod.bias.normal_(0.0, 0.1, generator=gen)
            elif isinstance(mod, GroupNorm32):
                mod.weight.normal_(1.0, 0.1, generator=gen)
                mod.bias.normal_(0.0, 0.1, generator=gen)
    hl = 16
    z = torch.from_numpy(rng.normal(size=(1, 4, hl, hl)).astype(np.float32))
    zq = torch.from_numpy(rng.normal(size=(1, 4, hl, hl)).astype(np.float32))
    m_c = (rng.random((1, hl // 4, hl // 4)) < 0.3).astype(np.int64)
    m_m = ((rng.random((1, hl // 2, hl // 2)) < 0.5).astype(np.int64)
           * (1 - m_c.repeat(2, 1).repeat(2, 2)))
    m_f = 1 - m_c.repeat(4, 1).repeat(4, 2) - m_m.repeat(2, 1).repeat(2, 2)
    masks = [torch.from_numpy(m) for m in (m_c, m_m, m_f)]
    with torch.no_grad():
        want = dec(z, zq, masks)
    got = decode_spatial_sharded(cpu_mesh(n), dec, z, zq, masks)
    assert got.shape == want.shape == (1, 3, 64, 64)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


@pytest.mark.parametrize("n", [1, 2])
def test_spatial_codec_matches_jax_and_unsharded(codecs, image, n):
    jcodec, codec = codecs
    solo = codec.encode(image, 0.1, 0.4)
    rec_solo = codec.decode(solo)
    rec, bpp, enc = compress_spatial(codec, image, 0.1, 0.4, cpu_mesh(n))
    jrec, jbpp, jenc = j_compress_spatial(jcodec, image, 0.1, 0.4,
                                          j_make_mesh(n))
    assert enc.streams == solo.streams == jenc.streams
    assert bpp == solo.bpp == jbpp
    np.testing.assert_allclose(rec, rec_solo, **TOL)
    np.testing.assert_allclose(rec, np.asarray(jrec), **TOL)
    # the receiver's sharded decode of the bundle alone
    np.testing.assert_allclose(decode_spatial(codec, enc, cpu_mesh(n)), rec,
                               atol=0)


def test_spatial_codec_pads_odd_sizes_like_jax(codecs):
    """100x120 pads to 128x128 at 2 shards (H to 64*2, W to 16); the
    reconstruction comes back unpadded and bpp is over the 100x120
    pixels."""
    jcodec, codec = codecs
    img = np.random.default_rng(3).uniform(0, 1, (100, 120, 3)).astype(
        np.float32)
    rec, bpp, enc = compress_spatial(codec, img, 0.1, 0.4, cpu_mesh(2))
    jrec, jbpp, jenc = j_compress_spatial(jcodec, img, 0.1, 0.4,
                                          j_make_mesh(2))
    assert rec.shape == img.shape and enc.image_hw == (128, 128)
    assert enc.streams == jenc.streams and bpp == jbpp
    assert bpp == enc.num_bytes * 8 / (100 * 120)
    np.testing.assert_allclose(rec, np.asarray(jrec), **TOL)
