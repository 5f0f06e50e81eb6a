"""The port's high-res tiled codec against the JAX package's, on the CPU at a
tiny config: the grid, padding and window helpers exactly equal, and
`compress_tiled` on a 100x140 image at tile 64 (padded to 112x144: 6 tiles in
4 shape groups, remainders of 48 and 16 px) with stream files byte-identical
to JAX `compress_tiled` given the same weights and Huffman counts, the same
bpp, and reconstructions within 1e-4, without and with overlap; each tile's
streams equal a solo encode of that tile."""
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from control_gic_tpu.codec import CGICCodec as JCodec
from control_gic_tpu.models import CGIC as JCGIC
from control_gic_tpu.models import CGICConfig as JConfig
from control_gic_tpu.parallel import tiling as jtiling
from control_gic_tpu_torch.codec import CGICCodec
from control_gic_tpu_torch.models import CGIC, CGICConfig
from control_gic_tpu_torch.parallel import tiling
from control_gic_tpu_torch.utils.from_jax import state_dict_from_flax

torch.set_num_threads(2)

SMALL = dict(n_embed=32, embed_dim=4, z_channels=4, ch=32,
             ch_mult=(1, 1, 2, 2, 2), num_res_blocks=1,
             attn_resolutions=(8,), resolution=64)
RATIOS = (0.1, 0.4)


@pytest.fixture(scope="module")
def codecs():
    """(JAX codec, the port's codec on the CPU), same weights and counts."""
    jmodel = JCGIC(JConfig(**SMALL))
    variables = jax.jit(lambda k: jmodel.init(
        k, jnp.zeros((1, 64, 64, 3)), *RATIOS))(jax.random.PRNGKey(5))
    counts = np.random.default_rng(7).integers(0, 1000, size=SMALL["n_embed"])
    model = CGIC(CGICConfig(**SMALL))
    model.load_state_dict(state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, variables["params"])), strict=True)
    return (JCodec(jmodel, variables, counts),
            CGICCodec(model, counts, device="cpu"))


@pytest.fixture(scope="module")
def image():
    rng = np.random.default_rng(12)
    yy, xx = np.mgrid[0:100, 0:140] / 140.0
    smooth = 0.5 + 0.3 * np.sin(6 * xx + 4 * yy)[..., None]
    busy = rng.uniform(0, 1, (100, 140, 3)) * (xx[..., None] > 0.5)
    return np.clip(0.7 * smooth + 0.3 * busy, 0, 1).astype(np.float32)


@pytest.fixture(scope="module")
def runs(codecs, image):
    """overlap -> (JAX result, port result)."""
    jcodec, codec = codecs
    return {overlap: (jtiling.compress_tiled(jcodec, image, *RATIOS, tile=64,
                                             overlap=overlap),
                      tiling.compress_tiled(codec, image, *RATIOS, tile=64,
                                            overlap=overlap))
            for overlap in (0, 32)}


@pytest.mark.parametrize("h, w", [(100, 130), (96, 128), (1356, 2040),
                                  (1, 1), (17, 33), (768, 769)])
def test_padding_matches_jax(h, w):
    assert tiling.compute_padding(h, w) == jtiling.compute_padding(h, w)


@pytest.mark.parametrize("h, w, tile", [(800, 768, 768), (112, 144, 64),
                                        (1360, 2048, 768), (1344, 2032, 768),
                                        (64, 64, 64), (16, 1000, 256)])
def test_tile_grid_matches_jax(h, w, tile):
    assert tiling.tile_grid(h, w, tile) == jtiling.tile_grid(h, w, tile)


@pytest.mark.parametrize("h, w, tile, overlap", [
    (1000, 700, 512, 64), (112, 144, 64, 32), (1360, 2048, 768, 128),
    (64, 500, 64, 16), (48, 48, 64, 32)])
def test_overlapping_grid_matches_jax(h, w, tile, overlap):
    assert (tiling.overlapping_tile_grid(h, w, tile, overlap)
            == jtiling.overlapping_tile_grid(h, w, tile, overlap))


@pytest.mark.parametrize("th, tw", [(64, 64), (48, 16), (768, 512),
                                    (592, 768)])
def test_gaussian_weights_match_jax(th, tw):
    np.testing.assert_array_equal(tiling.gaussian_tile_weights(th, tw),
                                  jtiling.gaussian_tile_weights(th, tw))


def _files(bundle, path):
    bundle.write(str(path))
    return {f: open(os.path.join(path, f), "rb").read()
            for f in sorted(os.listdir(path))}


@pytest.mark.parametrize("overlap", [0, 32])
def test_compress_tiled_matches_jax(runs, overlap, tmp_path):
    (jrec, jbpp, jbundles), (rec, bpp, bundles) = runs[overlap]
    assert len(bundles) == len(jbundles) == (6 if overlap == 0 else 12)
    for i, (b, jb) in enumerate(zip(bundles, jbundles)):
        assert (b.mode, b.latent_hw, b.image_hw) == (
            jb.mode, tuple(jb.latent_hw), tuple(jb.image_hw))
        assert _files(b, tmp_path / f"port{i}") == _files(
            jb, tmp_path / f"jax{i}"), i
    assert bpp == jbpp > 0
    assert rec.shape == jrec.shape == (100, 140, 3)
    np.testing.assert_allclose(rec, jrec, atol=1e-4)


def test_tile_streams_equal_solo_encodes(codecs, image, runs):
    _, codec = codecs
    _, (_, _, bundles) = runs[0]
    (pl, pr, pt, pb), _ = tiling.compute_padding(*image.shape[:2])
    padded = np.pad(image, ((pt, pb), (pl, pr), (0, 0)))
    tiles = tiling.tile_grid(*padded.shape[:2], 64)
    assert sorted({t[2:] for t in tiles}) == [(48, 16), (48, 64), (64, 16),
                                               (64, 64)]
    for (y, x, th, tw), b in zip(tiles, bundles):
        solo = codec.encode(padded[y:y + th, x:x + tw], *RATIOS)
        assert solo.streams == b.streams


def test_overlap_must_be_a_multiple_of_16(codecs, image):
    _, codec = codecs
    with pytest.raises(ValueError, match="multiple of 16"):
        tiling.compress_tiled(codec, image, *RATIOS, tile=64, overlap=8)
    with pytest.raises(ValueError, match="multiple of 16"):
        tiling.compress_tiled(codec, image, *RATIOS, tile=64, overlap=64)
