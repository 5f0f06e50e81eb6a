"""The port's device mesh (parallel/mesh.py) and the tile mesh of the tiled
codec (compress_tiled(mesh=), compress_tiled_many(mesh=)) on CPU meshes:
the mesh shapes of tests/test_parallel.py::test_make_mesh_nd_nonsquare,
shard_batch's split, and the tiled codec on 2- and 4-device meshes against
mesh=None and against JAX's compress_tiled(mesh=make_mesh(2)) with the same
weights and counts: streams byte-identical, reconstructions within 1e-5. A
tile group whose batch the mesh does not divide runs unsharded, as in
JAX."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from control_gic_tpu.codec import CGICCodec as JCodec
from control_gic_tpu.models.cgic import CGIC as JCGIC
from control_gic_tpu.models.cgic import CGICConfig as JConfig
from control_gic_tpu.parallel.mesh import make_mesh as j_make_mesh
from control_gic_tpu.parallel.tiling import compress_tiled as j_compress_tiled
from control_gic_tpu_torch.codec import CGICCodec
from control_gic_tpu_torch.models import CGIC, CGICConfig
from control_gic_tpu_torch.parallel import mesh as M
from control_gic_tpu_torch.parallel import tiling
from control_gic_tpu_torch.utils.from_jax import state_dict_from_flax

torch.set_num_threads(2)

TINY = dict(n_embed=32, embed_dim=4, z_channels=4, ch=32,
            ch_mult=(1, 1, 2, 2, 2), num_res_blocks=1, attn_resolutions=(8,),
            resolution=64)


def cpu_mesh(n, axis_names=("data",)):
    return M.make_mesh(n, axis_names, devices=["cpu"] * n)


def test_make_mesh_nd_nonsquare():
    """The n-D shapes of JAX's test: 8 devices / 2 axes -> 4x2, and the
    other factorizations."""
    assert cpu_mesh(8, ("data", "model")).devices.shape == (4, 2)
    assert cpu_mesh(4, ("a", "b")).devices.shape == (2, 2)
    assert cpu_mesh(6, ("a", "b")).devices.shape == (3, 2)
    assert cpu_mesh(8, ("a", "b", "c")).devices.shape == (2, 2, 2)
    assert M._balanced_shape(7, 2) == (7, 1)
    assert M._balanced_shape(12, 2) == (4, 3)
    for n in range(1, 33):
        for k in (1, 2, 3):
            shape = M._balanced_shape(n, k)
            assert len(shape) == k and int(np.prod(shape)) == n, (n, k, shape)
    m = cpu_mesh(8, ("data", "model"))
    assert m.shape == {"data": 4, "model": 2} and m.size == 8
    assert m.axis_devices("data") == [torch.device("cpu")] * 4


def test_make_mesh_takes_the_first_devices():
    m = M.make_mesh(2, devices=["cpu", "meta", "cpu"])
    assert list(m.devices.flat) == [torch.device("cpu"), torch.device("meta")]
    with pytest.raises(ValueError, match="3 devices asked"):
        M.make_mesh(3, devices=["cpu"] * 2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            M.make_mesh(1)


def test_shard_batch_splits_dim0():
    batch = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
    shards = M.shard_batch(cpu_mesh(4), batch)
    assert [s.shape for s in shards] == [(2, 3)] * 4
    np.testing.assert_array_equal(torch.cat(shards).numpy(), batch)
    # a 4x2 mesh: the data axis splits, the other replicates
    shards = M.shard_batch(cpu_mesh(8, ("data", "model")), batch)
    assert len(shards) == 8
    for i, s in enumerate(shards):
        np.testing.assert_array_equal(s.numpy(), batch[2 * (i // 2):
                                                       2 * (i // 2) + 2])
    rep = M.replicated_sharding(cpu_mesh(2)).put(batch)
    assert all(np.array_equal(r.numpy(), batch) for r in rep)
    with pytest.raises(ValueError, match="does not divide"):
        M.shard_batch(cpu_mesh(3), batch)


def test_replicas_on_the_same_device_are_the_module():
    model = torch.nn.Linear(2, 2)
    assert M.module_replicas(model, [torch.device("cpu")] * 3) == [model] * 3
    assert M.same_device("cpu", torch.device("cpu"))


def test_replicas_on_another_device_are_cached_copies(monkeypatch):
    """With every device taken for another one (same_device stubbed), the
    module's replicas are one copy per device, kept until its weights
    change."""
    monkeypatch.setattr(M, "same_device", lambda a, b: False)
    model = torch.nn.Linear(2, 2)
    reps = M.module_replicas(model, ["cpu", torch.device("cpu")])
    assert reps[0] is reps[1] and reps[0] is not model
    assert torch.equal(reps[0].weight, model.weight)
    assert M.module_replicas(model, ["cpu"])[0] is reps[0]
    with torch.no_grad():
        model.weight.add_(1.0)
    again = M.module_replicas(model, ["cpu"])[0]
    assert again is not reps[0] and torch.equal(again.weight, model.weight)


@pytest.fixture(scope="module")
def codecs():
    jmodel = JCGIC(JConfig(**TINY))
    variables = jax.jit(lambda k: jmodel.init(
        k, jnp.zeros((1, 64, 64, 3)), 0.1, 0.4))(jax.random.PRNGKey(0))
    counts = np.random.default_rng(1).integers(1, 1000, TINY["n_embed"])
    model = CGIC(CGICConfig(**TINY))
    model.load_state_dict(state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, variables["params"])), strict=True)
    codec = CGICCodec(model, counts, device="cpu")
    assert tiling.codec_replica(codec, "cpu") is codec
    return JCodec(jmodel, variables, counts), codec


def _image(h, w, seed):
    return np.random.default_rng(seed).uniform(0, 1, (h, w, 3)).astype(
        np.float32)


def _check(got, want, atol=1e-5):
    rec, bpp, bundles = got
    wrec, wbpp, wbundles = want
    assert bpp == wbpp
    assert [b.streams for b in bundles] == [b.streams for b in wbundles]
    np.testing.assert_allclose(rec, np.asarray(wrec), atol=atol)


@pytest.mark.parametrize("n", [2, 4])
def test_compress_tiled_mesh_matches_unsharded_and_jax(codecs, n):
    """128x96 at 64-px tiles: two groups of two tiles, split over the
    2-device mesh and unsharded on the 4-device one (2 % 4 != 0); then
    128x128: one group of four, split over either."""
    jcodec, codec = codecs
    for img in (_image(128, 96, 2), _image(128, 128, 3)):
        got = tiling.compress_tiled(codec, img, 0.1, 0.4, tile=64,
                                    mesh=cpu_mesh(n))
        _check(got, tiling.compress_tiled(codec, img, 0.1, 0.4, tile=64))
        _check(got, j_compress_tiled(jcodec, img, 0.1, 0.4, tile=64,
                                     mesh=j_make_mesh(2)), atol=1e-4)


def test_mesh_splits_only_batches_it_divides(codecs, monkeypatch):
    _, codec = codecs
    calls = []
    orig = CGICCodec.encode_batch_async

    def spy(self, images, *a, **kw):
        calls.append(len(images))
        return orig(self, images, *a, **kw)

    monkeypatch.setattr(CGICCodec, "encode_batch_async", spy)
    tiling.compress_tiled(codec, _image(128, 96, 2), 0.1, 0.4, tile=64,
                          mesh=cpu_mesh(2))
    assert calls == [1, 1, 1, 1]          # two groups of 2, each split
    calls.clear()
    tiling.compress_tiled(codec, _image(128, 96, 2), 0.1, 0.4, tile=64,
                          mesh=cpu_mesh(4))
    assert calls == [2, 2]                # 2 does not divide over 4


@pytest.mark.parametrize("n", [2, 4])
def test_compress_tiled_many_mesh_matches_unsharded(codecs, n):
    _, codec = codecs
    imgs = [_image(128, 96, 2), _image(128, 128, 3)]
    got = tiling.compress_tiled_many(codec, imgs, 0.1, 0.4, tile=64,
                                     mesh=cpu_mesh(n))
    for g, w in zip(got, tiling.compress_tiled_many(codec, imgs, 0.1, 0.4,
                                                    tile=64)):
        _check(g, w)


def test_compress_tiled_mesh_through_codec_replicas(codecs, monkeypatch):
    """The tile mesh on codec replicas (same_device stubbed, so the codec's
    own device counts as another): a copy of the codec, made once, gives
    the streams of mesh=None."""
    _, codec = codecs
    monkeypatch.setattr(tiling, "same_device", lambda a, b: False)
    rep = tiling.codec_replica(codec, "cpu")
    assert rep is not codec and rep.model is not codec.model
    assert tiling.codec_replica(codec, torch.device("cpu")) is rep
    img = _image(128, 128, 3)
    got = tiling.compress_tiled(codec, img, 0.1, 0.4, tile=64,
                                mesh=cpu_mesh(2))
    assert tiling.codec_replica(codec, "cpu") is rep
    monkeypatch.undo()
    _check(got, tiling.compress_tiled(codec, img, 0.1, 0.4, tile=64))
