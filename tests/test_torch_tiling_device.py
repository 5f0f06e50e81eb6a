"""The port's wire-minimal tiled codec (parallel/tiling.py:
compress_tiled_device, compress_tiled_many, compress_tiled(device_pack=))
and the tiled CLI's default path against the JAX package's, on the CPU at a
tiny config with the same weights and counts: streams and bpp exact,
reconstructions within 1e-4, the uint8 output equal to save_png's
quantization, and a worker's error raised on the caller's thread."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import control_gic_tpu_torch.cli.infer_highres as cli
from control_gic_tpu.codec import CGICCodec as JCodec
from control_gic_tpu.models import CGIC as JCGIC
from control_gic_tpu.models import CGICConfig as JConfig
from control_gic_tpu.parallel import tiling as jtiling
from control_gic_tpu_torch.codec import CGICCodec
from control_gic_tpu_torch.models import CGIC, CGICConfig
from control_gic_tpu_torch.parallel import tiling
from control_gic_tpu_torch.parallel.mesh import make_mesh
from control_gic_tpu_torch.utils.from_jax import state_dict_from_flax

torch.set_num_threads(2)

SMALL = dict(n_embed=32, embed_dim=4, z_channels=4, ch=32,
             ch_mult=(1, 1, 2, 2, 2), num_res_blocks=1,
             attn_resolutions=(8,), resolution=64)
TILE = 64


@pytest.fixture(scope="module")
def codecs():
    jmodel = JCGIC(JConfig(**SMALL))
    variables = jax.jit(lambda k: jmodel.init(
        k, jnp.zeros((1, 64, 64, 3)), 0.1, 0.4))(jax.random.PRNGKey(3))
    counts = np.random.default_rng(4).integers(1, 1000, size=SMALL["n_embed"])
    model = CGIC(CGICConfig(**SMALL))
    model.load_state_dict(state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, variables["params"])), strict=True)
    return JCodec(jmodel, variables, counts), CGICCodec(model, counts,
                                                        device="cpu")


@pytest.fixture(scope="module")
def images():
    """uint8 images, as the CLI uploads them: 128x96 (tiles 64x64 and 64x32,
    two shape groups) and 100x120 (padded to 112x128: 64x64 and 48x64)."""
    rng = np.random.default_rng(5)
    out = []
    for h, w in [(128, 96), (100, 120)]:
        yy, xx = np.mgrid[0:h, 0:w] / w
        img = 0.5 + 0.4 * np.sin(7 * xx + 5 * yy)[..., None]
        img = img + 0.3 * rng.uniform(-1, 1, (h, w, 3)) * (xx[..., None] > .4)
        out.append((np.clip(img, 0, 1) * 255).astype(np.uint8))
    return out


@pytest.fixture(scope="module")
def jax_tiled(codecs, images):
    """JAX's compress_tiled_device on the first image (its programs compile
    per tile group, so one image keeps the test short)."""
    jcodec, _ = codecs
    return jtiling.compress_tiled_device(jcodec, images[:1], 0.1, 0.4,
                                         tile=TILE, out_uint8=False,
                                         threads=False)


def _float(img):
    return img.astype(np.float32) / 255.0


def _check(got, want, atol=1e-4):
    for (rec, bpp, bundles), (wrec, wbpp, wbundles) in zip(got, want):
        assert rec.shape == np.asarray(wrec).shape
        assert bpp == wbpp
        assert [b.streams for b in bundles] == [b.streams for b in wbundles]
        np.testing.assert_allclose(rec, np.asarray(wrec), atol=atol)


@pytest.mark.parametrize("threads", [False, True])
def test_tiled_device_matches_jax_and_compress_tiled(codecs, images,
                                                     jax_tiled, threads):
    _, codec = codecs
    got = tiling.compress_tiled_device(codec, images, 0.1, 0.4, tile=TILE,
                                       out_uint8=False, threads=threads)
    assert len(got) == len(images)
    assert got[0][0].dtype == np.float32
    _check(got, jax_tiled)
    per_tile = [tiling.compress_tiled(codec, _float(im), 0.1, 0.4, tile=TILE,
                                      device_pack=True) for im in images]
    _check(got, per_tile, atol=0)
    stats = codec.last_pipeline_stats
    assert stats["threaded"] == float(threads)
    assert stats["a_upload_bytes"] == sum(im.nbytes for im in images)
    # one f32 canvas down per image, at the padded size
    padded = lambda n: -(-n // 16) * 16
    assert stats["c_fetch_bytes"] == sum(
        3 * 4 * padded(im.shape[0]) * padded(im.shape[1]) for im in images)


def test_tiled_device_uint8_is_save_pngs_quantization(codecs, images):
    _, codec = codecs
    f32 = tiling.compress_tiled_device(codec, images, 0.1, 0.4, tile=TILE,
                                       out_uint8=False, threads=False)
    u8 = tiling.compress_tiled_device(codec, images, 0.1, 0.4, tile=TILE,
                                      threads=True)
    for (rec8, bpp8, b8), (rec, bpp, b) in zip(u8, f32):
        assert rec8.dtype == np.uint8 and bpp8 == bpp
        assert [x.streams for x in b8] == [x.streams for x in b]
        np.testing.assert_array_equal(
            rec8, (np.clip(rec, 0.0, 1.0) * 255).astype(np.uint8))


@pytest.mark.parametrize("device_pack", [False, True])
def test_tiled_many_matches_jax_and_compress_tiled(codecs, images, jax_tiled,
                                                   device_pack):
    _, codec = codecs
    floats = [_float(im) for im in images]
    got = tiling.compress_tiled_many(codec, floats, 0.1, 0.4, tile=TILE,
                                     device_pack=device_pack)
    _check(got, jax_tiled)
    _check(got, [tiling.compress_tiled(codec, im, 0.1, 0.4, tile=TILE)
                 for im in floats], atol=0)


def test_unported_options_raise(codecs, images):
    """mesh=, once refused, now splits each tile group over the mesh: on a
    2-device CPU mesh compress_tiled and compress_tiled_many give the
    streams of mesh=None, and reconstructions within 1e-5 (a chunk runs at
    another batch size than the whole group). A tile size off the /16 grid
    still raises."""
    _, codec = codecs
    mesh = make_mesh(2, devices=["cpu"] * 2)
    floats = [_float(im) for im in images]
    _check([tiling.compress_tiled(codec, floats[0], 0.1, 0.4, tile=TILE,
                                  mesh=mesh)],
           [tiling.compress_tiled(codec, floats[0], 0.1, 0.4, tile=TILE)],
           atol=1e-5)
    _check(tiling.compress_tiled_many(codec, floats, 0.1, 0.4, tile=TILE,
                                      mesh=mesh),
           tiling.compress_tiled_many(codec, floats, 0.1, 0.4, tile=TILE),
           atol=1e-5)
    with pytest.raises(ValueError, match="multiple of 16"):
        tiling.compress_tiled_device(codec, images, 0.1, 0.4, tile=72)


def test_tiled_device_worker_error_fails_the_call(codecs, images,
                                                  monkeypatch):
    _, codec = codecs

    def fail(encoded):
        raise RuntimeError("injected rebuild failure")

    monkeypatch.setattr(codec, "_rebuild", fail)
    with pytest.raises(RuntimeError, match="injected rebuild failure"):
        tiling.compress_tiled_device(codec, images * 2, 0.1, 0.4, tile=TILE,
                                     threads=True)


def test_table_the_device_packer_refuses(codecs, images):
    """A table with codes above 32 bits: compress_tiled_device raises, and
    the CLI's default falls back to the per-tile path."""
    _, codec = codecs
    counts = np.r_[np.arange(1, 41), np.zeros(984, np.int64)]
    long_codes = CGICCodec(codec.model, counts, device="cpu")
    assert long_codes._device_tables is None
    with pytest.raises(ValueError, match="codes <= 32 bits"):
        tiling.compress_tiled_device(long_codes, images, 0.1, 0.4,
                                     tile=TILE)
    # device_pack quietly takes the host coder there, as in JAX
    img = _float(images[0])[:64, :64]
    assert long_codes.encode(img, 0.1, 0.4, device_pack=True).streams == \
        long_codes.encode(img, 0.1, 0.4).streams


def _bpps(path):
    lines = path.read_text().splitlines()
    assert lines[-1].startswith("average: bpp=")
    return [line.split("bpp=")[1].split()[0] for line in lines[:-1]]


def test_tiled_cli_pipeline_equals_per_tile_and_jax(codecs, images, tmp_path,
                                                    jax_tiled):
    """The CLI's default (the pipeline) and --no-pipeline write the same bpp
    lines, with the bpp of JAX's compress_tiled_device (the JAX CLI's default,
    which writes f"{bpp:.5f}"; test_torch_infer_highres holds --no-pipeline
    against the JAX CLI itself); the PNGs agree within 1 of 255."""
    from PIL import Image
    _, codec = codecs
    src = tmp_path / "imgs"
    src.mkdir()
    for i, im in enumerate(images):
        Image.fromarray(im).save(src / f"{i}.png")
    args = ["-i", str(src), "--tile", str(TILE), "--ratios", "0.1", "0.4",
            "--device", "cpu"]
    cli.main(args + ["-o", str(tmp_path / "pipe")], codec=codec)
    cli.main(args + ["-o", str(tmp_path / "plain"), "--no-pipeline",
                     "--device_pack"], codec=codec)
    pipe = _bpps(tmp_path / "pipe" / "bpp.txt")
    assert len(pipe) == 2
    assert pipe == _bpps(tmp_path / "plain" / "bpp.txt")
    assert pipe[0] == f"{jax_tiled[0][1]:.5f}"
    names = sorted(p.name for p in (tmp_path / "pipe").glob("*.png"))
    assert names == sorted(p.name for p in (tmp_path / "plain").glob("*.png"))
    assert len(names) == 2
    for name in names:
        a = np.asarray(Image.open(tmp_path / "pipe" / name), np.int16)
        b = np.asarray(Image.open(tmp_path / "plain" / name), np.int16)
        assert np.abs(a - b).max() <= 1
