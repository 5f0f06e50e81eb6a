"""The port's high-res CLI on PNGs in a temp dir, at a tiny config on the
CPU: it writes the reconstructions and bpp.txt with the bpp of JAX's CLI
(run on its per-tile path, --no-pipeline, with the same weights and counts),
and --spatial and --mesh-devices run the H-sharded codec and the tile
mesh. The pipeline and
--device_pack are held in test_torch_tiling_device.py."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import control_gic_tpu.cli.infer_highres as jcli
import control_gic_tpu_torch.cli.infer_highres as cli
from control_gic_tpu.codec import CGICCodec as JCodec
from control_gic_tpu.models import CGIC as JCGIC
from control_gic_tpu.models import CGICConfig as JConfig
from control_gic_tpu_torch.codec import CGICCodec
from control_gic_tpu_torch.models import CGIC, CGICConfig
from control_gic_tpu_torch.utils.from_jax import state_dict_from_flax
from control_gic_tpu_torch.utils.metrics import psnr

torch.set_num_threads(2)

SMALL = dict(n_embed=32, embed_dim=4, z_channels=4, ch=32,
             ch_mult=(1, 1, 2, 2, 2), num_res_blocks=1,
             attn_resolutions=(8,), resolution=64)


@pytest.fixture(scope="module")
def codecs():
    jmodel = JCGIC(JConfig(**SMALL))
    variables = jax.jit(lambda k: jmodel.init(
        k, jnp.zeros((1, 64, 64, 3)), 0.1, 0.4))(jax.random.PRNGKey(2))
    counts = np.random.default_rng(3).integers(0, 1000, size=SMALL["n_embed"])
    model = CGIC(CGICConfig(**SMALL))
    model.load_state_dict(state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, variables["params"])), strict=True)
    return (JCodec(jmodel, variables, counts),
            CGICCodec(model, counts, device="cpu"))


@pytest.fixture(scope="module")
def pngs(tmp_path_factory):
    """Two PNGs: 70x128 (cropped to 64x128, two 64-px tiles) and 64x72
    (cropped to 64x64, one tile)."""
    from PIL import Image
    d = tmp_path_factory.mktemp("hr_imgs")
    rng = np.random.default_rng(4)
    for i, (h, w) in enumerate([(70, 128), (64, 72)]):
        yy, xx = np.mgrid[0:h, 0:w] / w
        img = 0.5 + 0.4 * np.sin(8 * xx + 5 * yy)[..., None]
        img = img + 0.2 * rng.uniform(-1, 1, (h, w, 3)) * (xx[..., None] > .5)
        Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8)).save(
            d / f"{i}.png")
    return d


def _bpps(path):
    lines = path.read_text().splitlines()
    assert lines[-1].startswith("average: bpp=")
    return [line.split("bpp=")[1].split()[0] for line in lines[:-1]]


def test_cli_writes_pngs_and_bpp_like_jax(codecs, pngs, tmp_path,
                                          monkeypatch):
    jcodec, codec = codecs
    args = ["-i", str(pngs), "--tile", "64", "--ratios", "0.1", "0.4"]
    records = cli.main(args + ["-o", str(tmp_path / "port"), "--device",
                               "cpu", "--no-pipeline"], codec=codec)
    assert [r[0] for r in records] == [0, 1]
    assert all(r[1] > 0 and np.isfinite(r[2]) for r in records)
    assert len(list((tmp_path / "port").glob("*.png"))) == 2
    lines = (tmp_path / "port" / "bpp.txt").read_text().splitlines()
    assert lines[0].startswith("000: 64x128 ") and lines[1].startswith(
        "001: 64x64 ")

    monkeypatch.setattr(jcli, "build_codec", lambda ckpt: jcodec)
    jcli.main(args + ["-o", str(tmp_path / "jax"), "--no-pipeline"])
    assert _bpps(tmp_path / "port" / "bpp.txt") == _bpps(
        tmp_path / "jax" / "bpp.txt")


@pytest.mark.parametrize("flag, item", [
    (["--spatial", "--mesh-devices", "2"], "item 14"),
    (["--mesh-devices", "4"], "13-14")])
def test_unported_options_raise(codecs, pngs, tmp_path, flag, item):
    """The options once refused (ROADMAP queue 1 `item`) now run: --spatial
    over a 2-device CPU mesh writes the bpp and the reconstruction of
    compress_spatial on the same image, and needs --mesh-devices (it still
    raises without); --mesh-devices 4 alone splits the tile groups over
    the mesh, with the bpp of the unsharded per-tile path."""
    from control_gic_tpu_torch.data import EvalImageDataset
    from control_gic_tpu_torch.parallel.mesh import make_mesh
    from control_gic_tpu_torch.parallel.spatial_codec import compress_spatial
    _, codec = codecs
    args = ["-i", str(pngs), "--tile", "64", "--ratios", "0.1", "0.4"]
    records = cli.main(args + ["-o", str(tmp_path / "opt")] + flag,
                       codec=codec)
    assert [r[0] for r in records] == [0, 1]
    if "--spatial" in flag:
        mesh = make_mesh(2, devices=["cpu"] * 2)
        for (k, bpp, p, _), img in zip(records, EvalImageDataset(str(pngs))):
            rec, want, _ = compress_spatial(codec, img, 0.1, 0.4, mesh)
            assert bpp == want
            assert p == pytest.approx(psnr(np.clip(rec, 0, 1), img),
                                      abs=1e-9)
        with pytest.raises(ValueError, match="--mesh-devices"):
            cli.main(args + ["-o", str(tmp_path / "no_mesh"), "--spatial"],
                     codec=codec)
    else:
        cli.main(args + ["-o", str(tmp_path / "plain"), "--no-pipeline"],
                 codec=codec)
        assert _bpps(tmp_path / "opt" / "bpp.txt") == _bpps(
            tmp_path / "plain" / "bpp.txt")


def test_cli_overlap_blends_tiles(codecs, pngs, tmp_path):
    _, codec = codecs
    records = cli.main(["-i", str(pngs), "-o", str(tmp_path), "--tile", "64",
                        "--overlap", "32", "-r", "0", "1"], codec=codec)
    assert len(records) == 1 and records[0][1] > 0
