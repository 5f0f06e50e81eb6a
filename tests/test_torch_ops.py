"""The port's numerics ops against the JAX package's, on the same
numpy-seeded inputs (NHWC on the JAX side, NCHW in the port)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from control_gic_tpu.ops import entropy as jent
from control_gic_tpu.ops import fused_norm as jfn
from control_gic_tpu.ops import quantize as jq
from control_gic_tpu.ops import resample as jrs
from control_gic_tpu.ops import router as jrt
from control_gic_tpu_torch.ops import entropy as tent
from control_gic_tpu_torch.ops import fused_norm as tfn
from control_gic_tpu_torch.ops import quantize as tq
from control_gic_tpu_torch.ops import resample as trs
from control_gic_tpu_torch.ops import router as trt

torch.set_num_threads(2)

RATIOS = [(0.1, 0.4), (0.0, 0.8), (0.3, 0.0), (0.5, 0.5),
          (1.0, 0.0), (0.0, 1.0), (0.0, 0.0)]


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


# ---------------------------------------------------------------- entropy

@pytest.mark.parametrize("patch", [8, 16])
def test_patch_entropy_matches_jax(patch):
    x = np.random.default_rng(patch).uniform(0, 1, (2, 64, 96, 3))
    x = x.astype(np.float32)
    want = np.asarray(jent.patch_entropy(jnp.asarray(x), patch))
    got = tent.patch_entropy(nchw(x), patch).numpy()
    assert got.shape == want.shape == (2, 64 // patch, 96 // patch)
    np.testing.assert_allclose(got, want, atol=1e-5)


# ----------------------------------------------------------------- router

@pytest.mark.parametrize("per_sample", [False, True])
@pytest.mark.parametrize("mode", range(7))
def test_router_masks_exact(mode, per_sample):
    rc, rm = RATIOS[mode]
    rng = np.random.default_rng(mode)
    e16 = rng.uniform(0, 3, (3, 4, 6)).astype(np.float32)
    e8 = rng.uniform(0, 3, (3, 8, 12)).astype(np.float32)
    want = jrt.triple_grain_router(jnp.asarray(e16), jnp.asarray(e8), rc, rm,
                                   per_sample=per_sample)
    got = trt.triple_grain_router(torch.from_numpy(e16), torch.from_numpy(e8),
                                  rc, rm, per_sample=per_sample)
    assert got.mode == want.mode == mode
    for g, w in zip(got.masks, want.masks):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(
        trt.grain_indices_from_masks(got).numpy(),
        np.asarray(jrt.grain_indices_from_masks(want)))


@pytest.mark.parametrize("rc, rm", RATIOS + [(0.25, 0.75), (0.6, 0.2)])
def test_mode_from_ratios(rc, rm):
    assert trt.mode_from_ratios(rc, rm) == jrt.mode_from_ratios(rc, rm)


def test_router_rejects_bad_ratios():
    e16, e8 = torch.zeros(1, 2, 2), torch.zeros(1, 4, 4)
    with pytest.raises(ValueError):
        trt.triple_grain_router(e16, e8, 0.7, 0.7)


# --------------------------------------------------------------------- VQ

def test_vq_matches_jax():
    rng = np.random.default_rng(3)
    z = rng.normal(size=(2, 8, 8, 4)).astype(np.float32)
    cb = rng.uniform(-1, 1, (64, 4)).astype(np.float32)
    # tie-free inputs: the two nearest codes differ by more than 1e-5
    d = np.sort(((z.reshape(-1, 1, 4) - cb[None]) ** 2).sum(-1), axis=1)
    assert (d[:, 1] - d[:, 0]).min() > 1e-5
    want = jq.vq_quantize(jnp.asarray(z), jnp.asarray(cb))
    got = tq.vq_quantize(nchw(z), torch.from_numpy(cb))
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))
    np.testing.assert_array_equal(got.counts.numpy(), np.asarray(want.counts))
    np.testing.assert_allclose(got.loss.item(), float(want.loss), rtol=1e-6)
    np.testing.assert_array_equal(nhwc(got.z_q), np.asarray(want.z_q))
    np.testing.assert_array_equal(
        nhwc(tq.codebook_gather(got.indices, torch.from_numpy(cb))),
        np.asarray(jq.codebook_gather(want.indices, jnp.asarray(cb))))


def test_vq_first_index_on_ties():
    cb = torch.tensor([[1.0, 0.0], [0.0, 1.0], [1.0, 0.0]])
    z = torch.tensor([0.5, 0.5]).reshape(1, 2, 1, 1)
    assert tq.vq_lookup(z, cb).item() == 0


# --------------------------------------------------------------- resample

def test_nearest_resize_and_upsample_exact():
    x = np.random.default_rng(4).normal(size=(2, 16, 16, 3))
    x = x.astype(np.float32)
    for oh, ow in [(4, 4), (8, 8), (64, 64), (12, 20)]:
        np.testing.assert_array_equal(
            nhwc(trs.nearest_resize(nchw(x), oh, ow)),
            np.asarray(jrs.nearest_resize(jnp.asarray(x), oh, ow)))
    np.testing.assert_array_equal(
        nhwc(trs.upsample_nearest(nchw(x), 4)),
        np.asarray(jrs.upsample_nearest(jnp.asarray(x), 4)))
    m = np.random.default_rng(5).integers(0, 2, (2, 4, 4)).astype(np.int32)
    np.testing.assert_array_equal(
        trs.upsample_nearest(torch.from_numpy(m), 2).numpy(),
        np.asarray(jrs.upsample_nearest(jnp.asarray(m), 2)))


def test_avg_pool_exact():
    x = np.random.default_rng(6).normal(size=(2, 16, 16, 5))
    x = x.astype(np.float32)
    for w in (2, 4):
        np.testing.assert_array_equal(
            nhwc(trs.avg_pool(nchw(x), w)),
            np.asarray(jrs.avg_pool(jnp.asarray(x), w)))


def test_upsample2_conv3x3_matches_jax():
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 6, 5, 8)).astype(np.float32)
    k = (rng.normal(size=(3, 3, 8, 12)) * 0.2).astype(np.float32)   # HWIO
    b = rng.normal(size=(12,)).astype(np.float32)
    want = np.asarray(jrs.upsample2_conv3x3(jnp.asarray(x), jnp.asarray(k),
                                            jnp.asarray(b)))
    got = trs.upsample2_conv3x3(nchw(x),
                                torch.from_numpy(k.transpose(3, 2, 0, 1)),
                                torch.from_numpy(b))
    assert want.shape == (2, 12, 10, 12)
    np.testing.assert_allclose(nhwc(got), want, atol=1e-5)


# ------------------------------------------------------------------ norms

def test_norm_formulas_match_jax():
    rng = np.random.default_rng(8)
    f = rng.normal(1.0, 2.0, (2, 8, 8, 64)).astype(np.float32)
    zq = rng.normal(size=(2, 8, 8, 4)).astype(np.float32)
    gs, gb, by, bb = (rng.normal(size=(64,)).astype(np.float32)
                      for _ in range(4))
    wy, wb = (rng.normal(size=(4, 64)).astype(np.float32) for _ in range(2))
    want = np.asarray(jfn.group_norm_reference(jnp.asarray(f),
                                               jnp.asarray(gs),
                                               jnp.asarray(gb)))
    got = tfn.group_norm_reference(nchw(f), torch.from_numpy(gs),
                                   torch.from_numpy(gb))
    np.testing.assert_allclose(nhwc(got), want, atol=1e-5)
    for act in (False, True):
        want = np.asarray(jfn.spatial_norm_reference(
            *(jnp.asarray(a) for a in (f, zq, gs, gb, wy, by, wb, bb)), act))
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
        got = tfn.spatial_norm_reference(nchw(f), nchw(zq), t(gs), t(gb),
                                         t(wy.T), t(by), t(wb.T), t(bb), act)
        np.testing.assert_allclose(nhwc(got), want, atol=1e-5)
