"""The port's H-sharded halo convs (parallel/halo.py) on 2 and 4 CPU shards
against the unsharded conv and against JAX's sharded_conv2d_same /
halo_upsample2_conv3x3 under shard_map on the virtual CPU devices, within
1e-5 (mirrors tests/test_halo.py; the port is NCHW / OIHW, JAX NHWC /
HWIO)."""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.sharding import PartitionSpec as P

from control_gic_tpu.ops.resample import upsample2_conv3x3 as j_up2conv
from control_gic_tpu.parallel.halo import halo_upsample2_conv3x3 as j_halo_up
from control_gic_tpu.parallel.halo import sharded_conv2d_same as j_sharded
from control_gic_tpu.parallel.mesh import make_mesh as j_make_mesh
from control_gic_tpu_torch.ops.resample import upsample2_conv3x3
from control_gic_tpu_torch.parallel import halo
from control_gic_tpu_torch.parallel.mesh import make_mesh

TOL = dict(atol=1e-5, rtol=1e-5)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _oihw(k):
    return torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1)))


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("shape, kshape", [
    ((2, 32, 16, 8), (3, 3, 8, 5)),     # NHWC, HWIO: test_halo's 3x3
    ((1, 64, 8, 4), (5, 5, 4, 4))])     # and its 5x5
def test_halo_conv_matches_unsharded_and_jax(n, shape, kshape):
    rng = np.random.default_rng(0)
    x = rng.normal(size=shape).astype(np.float32)
    k = rng.normal(size=kshape).astype(np.float32) * 0.1
    b = rng.normal(size=(kshape[-1],)).astype(np.float32)
    got = halo.sharded_conv2d_same(make_mesh(n, devices=["cpu"] * n),
                                   _nchw(x), _oihw(k), torch.from_numpy(b))
    want = F.conv2d(_nchw(x), _oihw(k), torch.from_numpy(b),
                    padding=kshape[0] // 2)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
    jgot = j_sharded(j_make_mesh(n), jnp.asarray(x), jnp.asarray(k),
                     jnp.asarray(b))
    np.testing.assert_allclose(_nhwc(got), np.asarray(jgot), **TOL)


@pytest.mark.parametrize("n", [2, 4])
def test_halo_subpixel_upsample_matches_unsharded_and_jax(n):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 16, 12, 8)).astype(np.float32)
    k = rng.normal(size=(3, 3, 8, 6)).astype(np.float32) * 0.1
    b = rng.normal(size=(6,)).astype(np.float32)
    xs = halo.split_rows(_nchw(x), [torch.device("cpu")] * n)
    got = halo.join_rows(halo.halo_upsample2_conv3x3(xs, _oihw(k),
                                                     torch.from_numpy(b)))
    assert got.shape == (2, 6, 32, 24)
    want = upsample2_conv3x3(_nchw(x), _oihw(k), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6,
                               rtol=1e-6)
    fn = jax.shard_map(partial(j_halo_up, axis_name="data"),
                       mesh=j_make_mesh(n, axis_names=("data",)),
                       in_specs=(P(None, "data", None, None), P(), P()),
                       out_specs=P(None, "data", None, None))
    jgot = fn(jnp.asarray(x), jnp.asarray(k), jnp.asarray(b))
    np.testing.assert_allclose(_nhwc(got), np.asarray(jgot), **TOL)
    np.testing.assert_allclose(_nhwc(want), np.asarray(
        j_up2conv(jnp.asarray(x), jnp.asarray(k), jnp.asarray(b))), **TOL)


def test_shard_collectives():
    """halo_exchange pads with the neighbours' rows (zeros at the ends),
    psum adds the shards' parts, all_gather concatenates them."""
    x = torch.arange(2 * 3 * 8 * 2, dtype=torch.float32).reshape(2, 3, 8, 2)
    xs = halo.split_rows(x, [torch.device("cpu")] * 4)
    ext = halo.halo_exchange(xs, 1)
    padded = F.pad(x, (0, 0, 1, 1))
    for i, e in enumerate(ext):
        torch.testing.assert_close(e, padded[:, :, 2 * i:2 * i + 4])
    assert all(torch.equal(s, x.sum(2, keepdim=True)) for s in halo.psum(
        [s.sum(2, keepdim=True) for s in xs]))
    assert all(torch.equal(g, x) for g in halo.all_gather(xs, 2))
    assert halo.psum(xs[:1]) == xs[:1]
