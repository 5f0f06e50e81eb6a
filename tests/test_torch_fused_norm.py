"""The port's switched SpatialNorm (the apply kernel's path) against the JAX
package's, on the CPU: the port's plain versions (what its dispatch runs for
CPU tensors) against JAX's `_fused_forward` and `_make_fused` with the
Pallas kernels in interpret mode, the gradient of the autograd Function
against jax.vjp with the kernel launches replaced by their plain versions,
the switches against JAX's gates, and a decoder under
CONTROL_GIC_FUSED_NORM=1 against JAX's with its fused path in interpret
mode."""
import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from control_gic_tpu.models import blocks as jblocks
from control_gic_tpu.models.decoder import Decoder as JDecoder
from control_gic_tpu.ops import fused_norm as jfn
from control_gic_tpu_torch.models.decoder import Decoder
from control_gic_tpu_torch.ops import fused_norm as tfn
from control_gic_tpu_torch.utils.from_jax import state_dict_from_flax

torch.set_num_threads(2)


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(a, np.float32).transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.detach().float().numpy().transpose(0, 2, 3, 1)


def _inputs(seed, b, h, w, c):
    """numpy NHWC arrays, [Z, C] modulation weights as JAX holds them."""
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0, loc=0.0: (loc + scale * rng.normal(size=s)
                                        ).astype(np.float32)
    return dict(f=f(b, h, w, c, loc=0.3, scale=1.5), zq=f(b, h, w, 4),
                gs=f(c, scale=0.1, loc=1.0), gb=f(c, scale=0.1),
                wy=f(4, c, scale=0.3), by=f(c, scale=0.1),
                wb=f(4, c, scale=0.3), bb=f(c, scale=0.1),
                g=f(b, h, w, c))


NAMES = ("f", "zq", "gs", "gb", "wy", "by", "wb", "bb")


def _jax_args(a, dtype):
    dt = getattr(jnp, dtype)
    return [jnp.asarray(a[n], dt if n in ("f", "zq") else jnp.float32)
            for n in NAMES]


def _port_args(a, dtype):
    dt = getattr(torch, dtype)
    out = []
    for n in NAMES:
        t = (nchw(a[n]).to(dt) if n in ("f", "zq")
             else torch.from_numpy(a[n]))
        out.append(t.t().contiguous() if n in ("wy", "wb") else t)
    return out


def _close(got, want, dtype):
    """f32: within 1e-5 (of the output scale, at least 1); bf16: within one
    bf16 ulp of the output scale."""
    want = np.asarray(jnp.asarray(want, jnp.float32))
    scale = float(np.abs(want).max())
    tol = (1e-5 * max(1.0, scale) if dtype == "float32"
           else 2.0 ** (math.floor(math.log2(scale)) - 7))
    assert np.abs(nhwc(got) - want).max() <= tol


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act_swish", [True, False], ids=["swish", "plain"])
@pytest.mark.parametrize("b, h, w, c", [(2, 16, 16, 128), (1, 24, 40, 256)])
def test_apply_matches_fused_forward(b, h, w, c, act_swish, dtype):
    """CONTROL_GIC_FUSED_NORM's forward: the moment pass and the apply
    (JAX `_fused_forward`, Pallas interpret)."""
    a = _inputs(c + h + w, b, h, w, c)
    want = jfn._fused_forward(*_jax_args(a, dtype), act_swish,
                              interpret=True)
    got = tfn.spatial_norm(*_port_args(a, dtype), act_swish=act_swish,
                           use_fused=True)
    assert got.dtype == getattr(torch, dtype) and got.shape == (b, c, h, w)
    _close(got, want, dtype)


# the shapes above, and C = 32 (one channel a group)
REPLAY_SHAPES = [(2, 16, 16, 128), (1, 24, 40, 256), (1, 12, 20, 32)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act_swish", [True, False], ids=["swish", "plain"])
@pytest.mark.parametrize("b, h, w, c", REPLAY_SHAPES)
def test_apply_replay_matches_fused_forward(b, h, w, c, act_swish, dtype):
    """The apply kernel's order of operations (the group fold inside, the
    coefficient form) replayed on the CPU from the moments, against JAX
    `_fused_forward` (Pallas interpret)."""
    a = _inputs(c + h + w, b, h, w, c)
    want = jfn._fused_forward(*_jax_args(a, dtype), act_swish,
                              interpret=True)
    args = _port_args(a, dtype)
    mom = tfn.gn_moments_reference(args[0])
    got = tfn.spatial_norm_apply_replay(*args, mom, act_swish)
    assert got.dtype == getattr(torch, dtype) and got.shape == (b, c, h, w)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b, h, w, c", REPLAY_SHAPES)
def test_apply_replay_matches_plain_version(b, h, w, c, dtype):
    """The replay against the apply kernel's plain version,
    spatial_norm_kernel_act on the torch fold of the same moments."""
    a = _inputs(3 * c + h, b, h, w, c)
    args = _port_args(a, dtype)
    mom = tfn.gn_moments_reference(args[0])
    want = tfn.spatial_norm_kernel_act(
        *args, True, tfn.gn_stats_from_moments(mom, h * w))
    got = tfn.spatial_norm_apply_replay(*args, mom, True)
    _close(got, nhwc(want), dtype)


def test_parameter_pack_is_made_once_per_weight_version():
    """The apply kernel's packed parameters: the same weights (the 1x1 conv
    weights as the fresh [C, Z] views SpatialNorm passes) give the same
    packed tensor; an in-place update of a weight makes it anew."""
    from control_gic_tpu_torch.models.blocks import SpatialNorm

    norm = SpatialNorm(64, 4)
    with torch.no_grad():
        for p in norm.parameters():
            p.normal_()
    pack = lambda: tfn._packed_params(*norm.params(), torch.device("cpu"))
    first = pack()
    assert pack() is first
    gs, gb, wy, by, wb, bb = norm.params()
    assert torch.equal(first, torch.cat([torch.stack([gs, gb, by, bb]),
                                         wy.t(), wb.t()]))
    with torch.no_grad():
        norm.conv_y.weight.add_(1)
    second = pack()
    assert second is not first
    assert torch.equal(second[4:8], first[4:8] + 1)
    assert torch.equal(second[:4], first[:4])
    with torch.no_grad():
        norm.norm_layer.weight.add_(1)
    third = pack()
    assert third is not second and torch.equal(third[0], second[0] + 1)
    assert pack() is third


@pytest.mark.parametrize("stats_only", [False, True],
                         ids=["fused", "stats_only"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act_swish", [True, False], ids=["swish", "plain"])
def test_switched_paths_match_make_fused(act_swish, dtype, stats_only,
                                         monkeypatch):
    """Both switches through the dispatch against `_make_fused`, the JAX
    custom-VJP function each switch selects."""
    if stats_only:
        monkeypatch.setenv("CONTROL_GIC_STATS_KERNEL", "1")
    else:
        monkeypatch.setenv("CONTROL_GIC_FUSED_NORM", "1")
    a = _inputs(7, 2, 32, 16, 128)
    want = jfn._make_fused(act_swish, interpret=True, stats_only=stats_only)(
        *_jax_args(a, dtype))
    got = tfn.spatial_norm(*_port_args(a, dtype), act_swish=act_swish)
    _close(got, want, dtype)


@pytest.fixture
def cpu_kernels(monkeypatch):
    """The dispatch's kernel path on CPU tensors, with the moment and apply
    launches replaced by their plain versions, counted."""
    calls = {"gn_moments": 0, "spatial_norm_apply": 0}

    def moments(x):
        assert not torch.is_grad_enabled()
        calls["gn_moments"] += 1
        return tfn.gn_moments_reference(x)

    def apply(f, zq_r, gs, gb, wy, by, wb, bb, mom, act_swish):
        assert not torch.is_grad_enabled()
        calls["spatial_norm_apply"] += 1
        stats = tfn.gn_stats_from_moments(mom, f.shape[2] * f.shape[3])
        return tfn.spatial_norm_kernel_act(f, zq_r, gs, gb, wy, by, wb, bb,
                                           act_swish, stats)

    monkeypatch.setattr(tfn, "use_kernel", lambda t: True)
    monkeypatch.setattr(tfn, "gn_moments_kernel", moments)
    monkeypatch.setattr(tfn, "spatial_norm_apply_kernel", apply)
    return calls


@pytest.mark.parametrize("stats_only", [False, True],
                         ids=["fused", "stats_only"])
def test_function_gradient_matches_jax_vjp(cpu_kernels, stats_only,
                                           monkeypatch):
    """Under grad the dispatch takes _SpatialNormFn: the moment pass and
    (unless stats_only) the apply launch once, and gradients equal to
    jax.vjp of `_make_fused` (its backward differentiates
    spatial_norm_reference), within 1e-4 of each tensor's max."""
    monkeypatch.setenv("CONTROL_GIC_STATS_KERNEL", "1")
    a = _inputs(11, 2, 16, 32, 128)
    jargs = _jax_args(a, "float32")
    out, vjp = jax.vjp(jfn._make_fused(True, interpret=True,
                                       stats_only=stats_only), *jargs)
    want = vjp(jnp.asarray(a["g"]))
    leaves = [t.requires_grad_() for t in _port_args(a, "float32")]
    got_out = tfn.spatial_norm(*leaves, act_swish=True,
                               use_fused=not stats_only)
    assert type(got_out.grad_fn).__name__ == "_SpatialNormFnBackward"
    got = torch.autograd.grad(got_out, leaves, nchw(a["g"]))
    assert cpu_kernels == {"gn_moments": 1,
                           "spatial_norm_apply": int(not stats_only)}
    _close(got_out, out, "float32")
    for name, g, w in zip(NAMES, got, want):
        w = np.asarray(w)
        g = g.numpy()
        g = (g.transpose(0, 2, 3, 1) if g.ndim == 4
             else g.T if name in ("wy", "wb") else g)
        assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max(), name


@pytest.mark.parametrize("fused, stats", [("", ""), ("1", ""), ("0", ""),
                                          ("", "1"), ("1", "1"), ("", "0")])
def test_switches_match_jax(fused, stats, monkeypatch):
    """The port's switches against JAX's under its TPU branch (any non-empty
    value turns a switch on, "0" included, as in JAX)."""
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    for name, val in (("CONTROL_GIC_FUSED_NORM", fused),
                      ("CONTROL_GIC_STATS_KERNEL", stats)):
        if val:
            monkeypatch.setenv(name, val)
        else:
            monkeypatch.delenv(name, raising=False)
    assert tfn.fused_norms_enabled() == jfn.fused_norms_enabled()
    assert tfn.stats_kernel_enabled() == jfn.stats_kernel_enabled()


def test_dispatch_keeps_reference_without_a_row_block(monkeypatch):
    """Where _row_block finds no block the switches do not engage, as in
    JAX: the default path's broadcast-form formula runs."""
    monkeypatch.setenv("CONTROL_GIC_FUSED_NORM", "1")
    a = _inputs(3, 1, 65, 65, 128)
    assert tfn._row_block(65 * 65, 128) == jfn._row_block(65 * 65, 128) == 0
    args = _port_args(a, "float32")
    got = tfn.spatial_norm(*args, act_swish=True)
    want = tfn.spatial_norm_reference(*args, act_swish=True)
    assert torch.equal(got, want)


def _no_switch(monkeypatch):
    for name in ("CONTROL_GIC_FUSED_NORM", "CONTROL_GIC_STATS_KERNEL"):
        monkeypatch.delenv(name, raising=False)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act_swish", [True, False], ids=["swish", "plain"])
def test_default_takes_the_kernels_without_grad(cpu_kernels, act_swish,
                                                dtype, monkeypatch):
    """No switch set and no gradient recorded, with the kernel path taken
    as on the card: one moment pass and one apply, nothing counted as a
    reference call, and the output within the dtype's tolerance of
    spatial_norm_reference: f32 within 1e-5 of the output scale; bf16
    within one bf16 ulp of the output scale of the formula on f's f32
    values (the apply rounds once) and within the card tests' 2e-2 of the
    bf16 formula (which rounds at each of its steps)."""
    _no_switch(monkeypatch)
    a = _inputs(5, 2, 16, 24, 128)
    args = _port_args(a, dtype)
    plain = dict(tfn.PLAIN_CALLS)
    with torch.no_grad():
        got = tfn.spatial_norm(*args, act_swish=act_swish)
    assert cpu_kernels == {"gn_moments": 1, "spatial_norm_apply": 1}
    assert tfn.PLAIN_CALLS == plain
    assert got.dtype == getattr(torch, dtype) and got.shape == (2, 128, 16,
                                                                 24)
    exact = tfn.spatial_norm_reference(args[0].float(), args[1].float(),
                                       *args[2:], act_swish=act_swish)
    _close(got, nhwc(exact), dtype)
    want = tfn.spatial_norm_reference(*args, act_swish=act_swish)
    tol = 1e-5 if dtype == "float32" else 2e-2
    assert (got.float() - want.float()).abs().max() <= tol * max(
        1.0, float(want.float().abs().max()))


def test_default_keeps_the_reference_under_grad(cpu_kernels, monkeypatch):
    """Where a gradient is recorded the default dispatch runs
    spatial_norm_reference, launches nothing and counts one reference
    call; its gradient is the reference's own."""
    _no_switch(monkeypatch)
    a = _inputs(6, 1, 16, 16, 64)
    leaves = [t.requires_grad_() for t in _port_args(a, "float32")]
    plain = tfn.PLAIN_CALLS["spatial_norm"]
    got = tfn.spatial_norm(*leaves, act_swish=True)
    assert cpu_kernels == {"gn_moments": 0, "spatial_norm_apply": 0}
    assert tfn.PLAIN_CALLS["spatial_norm"] == plain + 1
    assert "SpatialNormFn" not in type(got.grad_fn).__name__
    want = tfn.spatial_norm_reference(*leaves, act_swish=True)
    assert torch.equal(got, want)
    g = nchw(a["g"])
    for x, y in zip(torch.autograd.grad(got, leaves, g),
                    torch.autograd.grad(want, leaves, g)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("case", ["c_above_2048", "z3", "strided"])
def test_default_keeps_the_reference_where_the_kernels_refuse(
        cpu_kernels, case, monkeypatch):
    """A shape the kernels do not take (C above their 2048, a zq of 3
    channels, an f that is not contiguous) runs spatial_norm_reference
    with no gradient too, launches nothing and counts one reference
    call."""
    _no_switch(monkeypatch)
    c, z = (2080, 4) if case == "c_above_2048" else (64, 4 - (case == "z3"))
    rng = np.random.default_rng(8)
    t = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    f, zq_r = t(1, c, 4, 6), t(1, z, 4, 6)
    if case == "strided":
        f = f.transpose(2, 3).contiguous().transpose(2, 3)
    params = (t(c), t(c), t(c, z), t(c), t(c, z), t(c))
    plain = tfn.PLAIN_CALLS["spatial_norm"]
    with torch.no_grad():
        got = tfn.spatial_norm(f, zq_r, *params, act_swish=True)
    assert cpu_kernels == {"gn_moments": 0, "spatial_norm_apply": 0}
    assert tfn.PLAIN_CALLS["spatial_norm"] == plain + 1
    assert torch.equal(got, tfn.spatial_norm_reference(f, zq_r, *params,
                                                       act_swish=True))


def _decoders(seed=2):
    """A small JAX decoder, its inputs (z, zq, masks) and initialised
    variables, and the port's decoder with the same weights."""
    kw = dict(ch=64, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,),
              resolution=16)
    dec = JDecoder(**kw)
    rng = np.random.default_rng(seed)
    z = jnp.asarray(rng.normal(size=(1, 8, 8, 4)), jnp.float32)
    zq = jnp.asarray(rng.normal(size=(1, 8, 8, 4)), jnp.float32)
    m_c = (rng.uniform(size=(1, 2, 2)) < 0.3).astype(np.int32)
    m_m = (rng.uniform(size=(1, 4, 4)) < 0.4).astype(np.int32)
    m_m = m_m * (1 - m_c.repeat(2, 1).repeat(2, 2))
    m_f = 1 - m_m.repeat(2, 1).repeat(2, 2) - m_c.repeat(4, 1).repeat(4, 2)
    masks = (m_c, m_m, m_f)
    params = dec.init(jax.random.PRNGKey(4), z, zq, masks)
    port = Decoder(**kw)
    sd = state_dict_from_flax({"decoder": jax.tree_util.tree_map(
        np.asarray, params["params"])})
    port.load_state_dict({k[len("decoder."):]: v for k, v in sd.items()},
                         strict=True)
    return dec, params, (z, zq, masks), port.eval()


def _port_decode(port, z, zq, masks):
    with torch.no_grad():
        return port(nchw(z), nchw(zq),
                    tuple(torch.from_numpy(m) for m in masks))


# 3 mids x (2 blocks x 2 norms + 1 attention norm), level 1 (8x8, with
# attention) 2 blocks x 2 + 2 attention norms, level 0 2 blocks x 2,
# norm_out
DECODER_NORMS = 15 + 6 + 4 + 1


def test_decoder_fused_norm_matches_jax(monkeypatch):
    """A small decoder under CONTROL_GIC_FUSED_NORM=1: every SpatialNorm
    outside a fused conv (ResnetBlock norms, attention norms, norm_out) goes
    through the switched path on both sides, in equal numbers; JAX's runs
    `_make_fused` in interpret mode."""
    monkeypatch.setenv("CONTROL_GIC_FUSED_NORM", "1")
    n = {"jax": 0, "port": 0}

    def jax_spatial_norm(f, zq_r, gs, gb, wy, by, wb, bb, act_swish=False):
        n["jax"] += 1
        return jfn._make_fused(act_swish, interpret=True)(
            f, zq_r, gs, gb, wy, by, wb, bb)

    fwd = tfn._fused_forward

    def port_fused(*args):
        n["port"] += 1
        return fwd(*args)

    monkeypatch.setattr(jblocks, "spatial_norm", jax_spatial_norm)
    monkeypatch.setattr(tfn, "_fused_forward", port_fused)
    dec, params, (z, zq, masks), port = _decoders()
    n["jax"] = 0                                     # init ran it too
    want = dec.apply(params, z, zq, masks)
    got = _port_decode(port, z, zq, masks)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=5e-4,
                               rtol=2e-4)
    assert n["port"] == n["jax"] == DECODER_NORMS


def test_decoder_default_takes_the_kernels_without_grad(cpu_kernels,
                                                        monkeypatch):
    """The same decoder with no switch set under torch.no_grad(), the
    dispatch's kernel path taken as on the card: every SpatialNorm outside
    a chain runs the moment pass and the apply, as many as under the switch
    above, none the reference formula; the output within that test's
    tolerance of JAX's default decoder (its reference formula)."""
    for name in ("CONTROL_GIC_FUSED_NORM", "CONTROL_GIC_STATS_KERNEL"):
        monkeypatch.delenv(name, raising=False)
    dec, params, (z, zq, masks), port = _decoders()
    want = dec.apply(params, z, zq, masks)
    plain = dict(tfn.PLAIN_CALLS)
    got = _port_decode(port, z, zq, masks)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=5e-4,
                               rtol=2e-4)
    assert cpu_kernels == {"gn_moments": DECODER_NORMS,
                           "spatial_norm_apply": DECODER_NORMS}
    assert tfn.PLAIN_CALLS == plain
