"""The port's chained norm+conv and GroupNorm moment pass against the JAX
package's, in float32 on the CPU: the port's plain versions (what its
dispatch runs for CPU tensors) against the Pallas kernels run in interpret
mode, and the engagement rule against JAX's."""
import itertools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from control_gic_tpu.ops import fused_norm as jfn
from control_gic_tpu.ops import norm_conv as jnc
from control_gic_tpu_torch.ops import fused_norm as tfn
from control_gic_tpu_torch.ops import norm_conv as tnc

torch.set_num_threads(2)

OUT_TOL = dict(atol=2e-5, rtol=1e-5)     # JAX's own kernel-vs-reference
MOM_TOL = dict(atol=2e-3, rtol=1e-5)


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def _inputs(seed, b, h, w, cin, cout, z=4):
    """numpy NHWC / HWIO arrays, as tests/test_norm_conv.py draws them."""
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0, loc=0.0: (loc + scale * rng.normal(size=s)
                                        ).astype(np.float32)
    return dict(x=f(b, h, w, cin), zq=f(b, h, w, z), gs=f(cin, scale=0.1,
                                                          loc=1.0),
                gb=f(cin, scale=0.1), wy=f(z, cin, scale=0.3),
                by=f(cin, scale=0.1), wb=f(z, cin, scale=0.3),
                bb=f(cin, scale=0.1), cw=f(3, 3, cin, cout, scale=0.05),
                cb=f(cout, scale=0.1), res=f(b, h, w, cout))


def _jax_stats(x):
    mean, rstd = jfn._gn_stats(jnp.asarray(x), 32)
    cg = x.shape[-1] // 32
    return jnp.repeat(mean, cg, axis=1), jnp.repeat(rstd, cg, axis=1)


CONFIGS = list(itertools.product([True, False], [False, True], [False, True],
                                 [False, True]))
# (modulate, with res, with stats, emit_mom, H, W, Cin, Cout)
CASES = [c + ((16, 16) if i % 2 == 0 else (32, 16)) + (128, 128)
         for i, c in enumerate(CONFIGS)]
CASES += [(True, True, False, True, 16, 16, 256, 128),    # decoder level 0
          (False, True, False, True, 32, 16, 128, 256),   # encoder level 1
          (True, False, True, False, 16, 16, 128, 3),     # norm_out+conv_out
          (False, False, True, True, 16, 16, 256, 3)]


@pytest.mark.parametrize(
    "modulate, with_res, with_stats, emit, h, w, cin, cout", CASES,
    ids=[f"{'sn' if c[0] else 'gn'}-res{int(c[1])}-stats{int(c[2])}-"
         f"mom{int(c[3])}-{c[4]}x{c[5]}-{c[6]}to{c[7]}" for c in CASES])
def test_chain_matches_pallas_interpret(modulate, with_res, with_stats, emit,
                                        h, w, cin, cout):
    a = _inputs(h * 1000 + cin + cout, 2, h, w, cin, cout)
    j = {k: jnp.asarray(v) for k, v in a.items()}
    stats = _jax_stats(a["x"]) if with_stats else None
    res = j["res"] if with_res else None
    want = jnc._chain_forward_impl(
        j["x"], j["zq"] if modulate else None, j["gs"], j["gb"],
        *((j["wy"], j["by"], j["wb"], j["bb"]) if modulate else (None,) * 4),
        j["cw"], j["cb"], res, stats, act_swish=True, emit_mom=emit,
        modulate=modulate, interpret=True)

    t = {k: torch.from_numpy(v) for k, v in a.items()}
    tstats = (tuple(torch.from_numpy(np.array(s)) for s in stats)
              if with_stats else None)
    common = dict(res=nchw(a["res"]) if with_res else None, stats=tstats,
                  emit_mom=emit)
    cw = t["cw"].permute(3, 2, 0, 1)
    if modulate:
        got = tnc.spatial_norm_conv_mom(
            nchw(a["x"]), nchw(a["zq"]), t["gs"], t["gb"], t["wy"].t(),
            t["by"], t["wb"].t(), t["bb"], cw, t["cb"], **common)
    else:
        got = tnc.group_norm_conv_mom(nchw(a["x"]), t["gs"], t["gb"], cw,
                                      t["cb"], **common)
    if emit:
        np.testing.assert_allclose(nhwc(got[0]), np.asarray(want[0]),
                                   **OUT_TOL)
        assert got[1].shape == (2, 2, cout) and got[1].dtype == torch.float32
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                                   **MOM_TOL)
    else:
        assert got.shape == (2, cout, h, w)
        np.testing.assert_allclose(nhwc(got), np.asarray(want), **OUT_TOL)


@pytest.mark.parametrize("b, h, w, c", [(2, 16, 16, 128), (1, 32, 48, 256),
                                        (2, 8, 16, 64)])
def test_moments_and_fold_match_gn_stats_pallas(b, h, w, c):
    x = np.random.default_rng(c + h).normal(0.3, 1.5, (b, h, w, c)).astype(
        np.float32)
    rb = jfn._row_block(h * w, c)
    want = jfn._gn_stats_pallas(jnp.asarray(x).reshape(b, h * w, c), 32, rb,
                                interpret=True)
    mom = tfn.gn_moments(nchw(x))          # CPU tensor: the plain version
    assert mom.shape == (b, 2, c) and mom.dtype == torch.float32
    xt = x.reshape(b, h * w, c).astype(np.float64)
    np.testing.assert_allclose(mom[:, 0].numpy(), xt.sum(1), rtol=1e-5,
                               atol=1e-3)
    got = tfn.gn_stats_from_moments(mom, h * w)
    for g, wv in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wv), rtol=1e-5)


def test_stats_from_moments_matches_jax():
    rng = np.random.default_rng(4)
    of = rng.normal(0.5, 2.0, (3, 64, 256)).astype(np.float32)
    mom = np.stack([of.sum(1), (of * of).sum(1)], axis=1)
    want = jnc.stats_from_moments(jnp.asarray(mom), 64)
    got = tnc.stats_from_moments(torch.from_numpy(mom), 64)
    for g, wv in zip(got, want):
        assert g.shape == (3, 256)
        np.testing.assert_allclose(g.numpy(), np.asarray(wv), rtol=1e-6)


# NHWC shapes and Cout: every chain shape of the 512x768 (Kodak) path, the
# 256x256 path's largest, and shapes each rule refuses
SHAPES = [((1, 512, 768, 128), 128), ((1, 256, 384, 128), 256),
          ((1, 256, 384, 256), 256), ((1, 512, 768, 256), 128),
          ((1, 512, 768, 128), 3), ((1, 128, 192, 512), 256),
          ((1, 128, 192, 256), 256), ((1, 64, 96, 512), 512),
          ((1, 256, 256, 256), 128), ((1, 256, 256, 128), 128),
          ((2, 64, 64, 128), 128), ((1, 16, 12, 128), 128),
          ((1, 1, 16, 128), 128), ((1, 16, 16, 64), 64),
          ((1, 16, 16, 128), 200), ((1, 8, 8, 128), 128),
          ((1, 4104, 16, 128), 128)]


def _nchw_shape(s):
    return (s[0], s[3], s[1], s[2])


@pytest.mark.parametrize("shape, cout", SHAPES,
                         ids=[f"{s[1]}x{s[2]}x{s[3]}to{c}" for s, c in SHAPES])
def test_engagement_rule_matches_jax(shape, cout, monkeypatch):
    ns = _nchw_shape(shape)
    assert tnc.admissible(ns, cout) == jnc.admissible(shape, cout)
    both = (jnc.admissible(shape, cout)
            and jnc.admissible(shape[:3] + (cout,), cout))
    elems = shape[1] * shape[2] * shape[3]
    assert tnc.chain_admissible(ns, cout) == (
        both and elems >= jnc._fuse_min_elems())
    # the interpret bypass of JAX's element gate against a zero threshold
    monkeypatch.setenv("CONTROL_GIC_CHAIN", "interpret")
    monkeypatch.setattr(tnc, "CHAIN_MIN_ELEMS", 0)
    assert tnc.chain_admissible(ns, cout) == jnc.chain_admissible(shape, cout)


def test_gate_constants_match_jax():
    assert tnc.CHAIN_MIN_ELEMS == 9_000_000 == jnc._fuse_min_elems()
    for hw in (1, 64, 256, 4096, 4104, 16384, 49152, 98304, 393216):
        for c in (3, 64, 128, 256, 512):
            assert tfn._row_block(hw, c) == jfn._row_block(hw, c), (hw, c)
