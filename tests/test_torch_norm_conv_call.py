"""The port's per-call norm+conv op (JAX `_kernel`'s path) and the norm+conv
gates against the JAX package's, in float32 on the CPU: the plain versions
(what the dispatch runs for CPU tensors) against `_norm_conv_forward` /
`_group_norm_conv_forward` with the Pallas kernel in interpret mode, the
gradients against JAX's custom VJPs, the gates against JAX's under its TPU
branch for every switch and every shape of the 768-px tile path, and the
ResnetBlock, Encoder and Decoder wiring under CONTROL_GIC_NORM_CONV=
interpret on both sides with equal engagement counts."""
import itertools
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from control_gic_tpu.models.blocks import ResnetBlock as JResnetBlock
from control_gic_tpu.models.decoder import Decoder as JDecoder
from control_gic_tpu.models.encoder import Encoder as JEncoder
from control_gic_tpu.ops import norm_conv as jnc
from control_gic_tpu_torch.models import blocks as tblocks
from control_gic_tpu_torch.models import decoder as tdecoder
from control_gic_tpu_torch.models.blocks import ResnetBlock
from control_gic_tpu_torch.models.decoder import Decoder
from control_gic_tpu_torch.models.encoder import Encoder, chain_consumes
from control_gic_tpu_torch.models.encoder import chain_step
from control_gic_tpu_torch.ops import norm_conv as tnc
from control_gic_tpu_torch.utils.from_jax import state_dict_from_flax

torch.set_num_threads(2)

TOL = dict(atol=5e-4, rtol=2e-4)


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(a, np.float32).transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def _inputs(seed, b, h, w, cin, cout):
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0, loc=0.0: (loc + scale * rng.normal(size=s)
                                        ).astype(np.float32)
    return dict(x=f(b, h, w, cin, loc=0.2, scale=1.3), zq=f(b, h, w, 4),
                gs=f(cin, scale=0.1, loc=1.0), gb=f(cin, scale=0.1),
                wy=f(4, cin, scale=0.3), by=f(cin, scale=0.1),
                wb=f(4, cin, scale=0.3), bb=f(cin, scale=0.1),
                cw=f(3, 3, cin, cout, scale=(9 * cin) ** -0.5),
                cb=f(cout, scale=0.1), g=f(b, h, w, cout))


def _args(a, modulate):
    """(JAX args, port args) of spatial_norm_conv / group_norm_conv."""
    names = (["x", "zq", "gs", "gb", "wy", "by", "wb", "bb", "cw", "cb"]
             if modulate else ["x", "gs", "gb", "cw", "cb"])
    port = {n: torch.from_numpy(a[n]) for n in names}
    port["x"] = nchw(a["x"])
    if modulate:
        port["zq"] = nchw(a["zq"])
        port["wy"], port["wb"] = port["wy"].t(), port["wb"].t()
    port["cw"] = port["cw"].permute(3, 2, 0, 1)
    return [jnp.asarray(a[n]) for n in names], [port[n] for n in names]


def _port_grad(g, name):
    g = g.numpy()
    if name == "cw":
        return g.transpose(2, 3, 1, 0)
    if g.ndim == 4:
        return g.transpose(0, 2, 3, 1)
    return g.T if name in ("wy", "wb") else g


# ragged H (no 16-row tile divides it), Cout 3 and 4 (decoder and encoder
# conv_out), 128 and 256
CASES = [(True, 13, 16, 128, 3), (False, 13, 16, 256, 4),
         (True, 16, 32, 128, 128), (False, 24, 16, 128, 256),
         (True, 20, 16, 256, 256), (False, 16, 16, 256, 128)]


@pytest.mark.parametrize("modulate, h, w, cin, cout", CASES,
                         ids=[f"{'sn' if c[0] else 'gn'}-{c[1]}x{c[2]}-"
                              f"{c[3]}to{c[4]}" for c in CASES])
def test_call_matches_pallas_interpret(modulate, h, w, cin, cout):
    a = _inputs(h * 7 + cin + cout, 2, h, w, cin, cout)
    jargs, targs = _args(a, modulate)
    if modulate:
        want = jnc._norm_conv_forward(*jargs, act_swish=True, interpret=True)
        got = tnc.spatial_norm_conv(*targs, use_fused=True)
    else:
        want = jnc._group_norm_conv_forward(*jargs, act_swish=True,
                                            interpret=True)
        got = tnc.group_norm_conv(*targs, use_fused=True)
    assert got.shape == (2, cout, h, w)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=1e-4,
                               rtol=1e-5)


@pytest.mark.parametrize("act_swish", [True, False], ids=["swish", "plain"])
@pytest.mark.parametrize("modulate", [True, False], ids=["sn", "gn"])
def test_call_gradients_match_custom_vjp(modulate, act_swish):
    """_NormConvFn against jax.vjp of `_make_norm_conv` /
    `_make_group_norm_conv` (both differentiate the reference composition,
    stats recomputed from x), within 1e-4 of each tensor's max."""
    a = _inputs(5 + modulate, 2, 16, 32, 128, 128)
    jargs, targs = _args(a, modulate)
    make = jnc._make_norm_conv if modulate else jnc._make_group_norm_conv
    out, vjp = jax.vjp(make(act_swish, interpret=True), *jargs)
    want = vjp(jnp.asarray(a["g"]))
    leaves = [t.clone().requires_grad_() for t in targs]
    op = tnc.spatial_norm_conv if modulate else tnc.group_norm_conv
    got_out = op(*leaves, act_swish=act_swish, use_fused=True)
    assert type(got_out.grad_fn).__name__ == "_NormConvFnBackward"
    got = torch.autograd.grad(got_out, leaves, nchw(a["g"]))
    np.testing.assert_allclose(nhwc(got_out), np.asarray(out), atol=1e-4)
    names = (["x", "zq", "gs", "gb", "wy", "by", "wb", "bb", "cw", "cb"]
             if modulate else ["x", "gs", "gb", "cw", "cb"])
    for name, g, w in zip(names, got, want):
        w = np.asarray(w)
        assert np.abs(_port_grad(g, name) - w).max() <= (
            1e-4 * np.abs(w).max()), name


def test_unfused_call_is_the_reference_composition():
    a = _inputs(9, 1, 16, 16, 128, 3)
    jargs, targs = _args(a, True)
    got = tnc.spatial_norm_conv(*targs, use_fused=False)
    want = jnc.norm_conv_reference(*jargs)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=1e-5)
    jargs, targs = _args(a, False)
    got = tnc.group_norm_conv(*targs, use_fused=False)
    want = jnc.group_norm_conv_reference(*jargs)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=1e-5)


# ------------------------------------------------------------------ gates

def tile_path_shapes(th: int, tw: int):
    """NHWC (x_shape, cout) of every norm+conv the full-width model (ch 128,
    ch_mult (1, 2, 2, 4, 4), 2 blocks a level) gates on a th x tw tile: each
    ResnetBlock's two convs, the encoder heads' conv_out and the decoder's
    norm_out + conv_out."""
    out = set()

    def block(h, w, cin, cout):
        out.add(((1, h, w, cin), cout))
        out.add(((1, h, w, cout), cout))

    chans = [128, 256, 256, 512, 512]
    cin = 128
    for lvl, c in enumerate(chans):                      # encoder trunk
        for _ in range(2):
            block(th >> lvl, tw >> lvl, cin, c)
            cin = c
    for lvl in (2, 3, 4):                                # encoder heads
        h, w, c = th >> lvl, tw >> lvl, chans[lvl]
        block(h, w, c, c)
        out.add(((1, h, w, c), 4))
    block(th >> 2, tw >> 2, 512, 512)                    # decoder mids
    cin = 512
    for lvl in reversed(range(5)):                       # decoder trunk
        for _ in range(3):
            block(th >> lvl, tw >> lvl, cin, chans[lvl])
            cin = chans[lvl]
    out.add(((1, th, tw, 128), 3))                       # norm_out
    return sorted(out)


# the DIV2K class of images: a 1356x2040 image padded to 1360x2048 gives
# 768-px tiles with remainders of 592 and 512 px; the CLI's /16 crop of it,
# 1344x2032, gives remainders of 576 and 496 px
TILES = [(768, 768), (768, 512), (592, 768), (592, 512), (576, 768),
         (768, 496), (576, 496)]
SHAPES = sorted({s for t in TILES for s in tile_path_shapes(*t)})
SWITCHES = list(itertools.product(["", "0", "1", "interpret"],
                                  ["", "0", "1", "interpret"],
                                  [None, "0", "20000000"]))


def _set_switches(monkeypatch, chain, norm_conv, min_elems):
    for name, val in (("CONTROL_GIC_CHAIN", chain),
                      ("CONTROL_GIC_NORM_CONV", norm_conv),
                      ("CONTROL_GIC_NORM_CONV_MIN_ELEMS", min_elems)):
        if val:
            monkeypatch.setenv(name, val)
        else:
            monkeypatch.delenv(name, raising=False)


def _nchw_shape(s):
    return (s[0], s[3], s[1], s[2])


@pytest.mark.parametrize("chain, norm_conv, min_elems", SWITCHES,
                         ids=[f"chain{c or '-'}-nc{n or '-'}-min{m or '-'}"
                              for c, n, m in SWITCHES])
def test_gates_match_jax_on_the_tile_path(chain, norm_conv, min_elems,
                                          monkeypatch):
    """chain_admissible and norm_conv_worthwhile against JAX's under its TPU
    branch, over every norm+conv shape of the tile path."""
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    _set_switches(monkeypatch, chain, norm_conv, min_elems)
    assert tnc.chain_enabled() == jnc.chain_enabled()
    assert tnc.norm_conv_enabled() == jnc.norm_conv_enabled()
    for shape, cout in SHAPES:
        ns = _nchw_shape(shape)
        assert tnc.chain_admissible(ns, cout) == jnc.chain_admissible(
            shape, cout), (shape, cout)
        assert tnc.norm_conv_worthwhile(ns, cout) == (
            jnc.norm_conv_worthwhile(shape, cout)), (shape, cout)


def test_tile_path_engages_both_sides_of_the_gate(monkeypatch):
    """With CONTROL_GIC_NORM_CONV=1 the encoder fine head's conv_out
    (192x192x256 -> 4, 9.4M elements) fuses, and the 592-px tile's
    (148x192x256, 7.3M) does not; the decoder mids of both do."""
    monkeypatch.setenv("CONTROL_GIC_NORM_CONV", "1")
    assert tnc.norm_conv_worthwhile((1, 256, 192, 192), 4)
    assert not tnc.norm_conv_worthwhile((1, 256, 148, 192), 4)
    assert tnc.norm_conv_worthwhile((1, 512, 148, 192), 512)
    assert tnc.norm_conv_worthwhile((1, 512, 148, 128), 512)


def test_force_and_engagement_rule_match_jax(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    _set_switches(monkeypatch, "", "", None)
    shapes = [s for s in SHAPES if s[1] in (3, 4, 512)]
    with tnc.force_norm_conv(), jnc.force_norm_conv():
        for shape, cout in shapes:
            assert tnc.norm_conv_worthwhile(_nchw_shape(shape), cout) == (
                jnc.norm_conv_worthwhile(shape, cout))
        assert any(tnc.norm_conv_worthwhile(_nchw_shape(s), c)
                   for s, c in shapes)
    rule = lambda s, cout: cout <= 4
    try:
        tnc.set_engagement_rule(rule)
        jnc.set_engagement_rule(rule)
        monkeypatch.setenv("CONTROL_GIC_NORM_CONV", "1")
        for shape, cout in SHAPES:
            ns = _nchw_shape(shape)
            assert tnc.norm_conv_worthwhile(ns, cout) == (
                jnc.norm_conv_worthwhile(shape, cout))
            assert tnc.chain_admissible(ns, cout) == jnc.chain_admissible(
                shape, cout)
    finally:
        tnc.set_engagement_rule(None)
        jnc.set_engagement_rule(None)


def test_min_elems_switch_moves_the_gate(monkeypatch):
    shape, cout = (1, 128, 16, 16), 128
    assert not tnc.chain_admissible(shape, cout)
    monkeypatch.setenv("CONTROL_GIC_NORM_CONV_MIN_ELEMS", "0")
    assert tnc.chain_admissible(shape, cout)
    monkeypatch.setenv("CONTROL_GIC_NORM_CONV_MIN_ELEMS", "80000000")
    assert not tnc.chain_admissible((1, 128, 768, 768), 128)


def test_chain_switch_off_keeps_an_admissible_block_unchained(monkeypatch):
    """CONTROL_GIC_CHAIN=0 turns the chain off (JAX `chain_admissible`
    under the TPU backend): a trunk block whose shape passes the gate takes
    the unchained branch, and no chain call runs."""
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(tnc, "CHAIN_MIN_ELEMS", 0)
    calls = {"chain": 0}

    def counted(fn):
        def wrapped(*a, **kw):
            calls["chain"] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(tnc, "chain_reference", counted(tnc.chain_reference))
    monkeypatch.setattr(tnc, "plain_chain_reference",
                        counted(tnc.plain_chain_reference))
    block = ResnetBlock(128, 128)
    torch.manual_seed(0)
    for p in block.parameters():
        torch.nn.init.normal_(p, 0.0, 0.05)
    x = torch.randn(1, 128, 16, 32)
    assert tnc.chain_admissible(x.shape, 128)
    monkeypatch.setenv("CONTROL_GIC_CHAIN", "0")
    assert not jnc.chain_admissible((1, 16, 32, 128), 128)
    assert not tnc.chain_admissible(x.shape, 128)
    with torch.no_grad():
        h, mom = chain_step(block, x, None, None, True, chain_consumes)
        want = block(x)
    assert mom is None and calls["chain"] == 0
    assert torch.equal(h, want)


# ------------------------------------------------------------ the wiring

def _port(module, params, prefix=None):
    tree = jax.tree_util.tree_map(np.asarray, params)
    sd = state_dict_from_flax({prefix: tree} if prefix else tree)
    if prefix:
        sd = {k[len(prefix) + 1:]: v for k, v in sd.items()}
    module.load_state_dict(sd, strict=True)
    return module.eval()


@pytest.fixture
def engaged(monkeypatch):
    """CONTROL_GIC_NORM_CONV=interpret on both sides; counts the per-call
    op and the chain calls, by norm form, on each side."""
    monkeypatch.setenv("CONTROL_GIC_NORM_CONV", "interpret")
    n = {k: 0 for k in ("jax_nc_sn", "jax_nc_gn", "jax_ch_sn", "jax_ch_gn",
                        "nc_sn", "nc_gn", "ch_sn", "ch_gn")}
    nc_impl, ch_impl = jnc._norm_conv_forward_impl, jnc._chain_forward_impl

    def jax_nc(*a, modulate, **kw):
        n["jax_nc_sn" if modulate else "jax_nc_gn"] += 1
        return nc_impl(*a, modulate=modulate, **kw)

    def jax_ch(*a, modulate, **kw):
        n["jax_ch_sn" if modulate else "jax_ch_gn"] += 1
        return ch_impl(*a, modulate=modulate, **kw)

    monkeypatch.setattr(jnc, "_norm_conv_forward_impl", jax_nc)
    monkeypatch.setattr(jnc, "_chain_forward_impl", jax_ch)
    fwd = tnc._norm_conv_forward

    def port_nc(x, zq_r, *a):
        n["nc_sn" if zq_r is not None else "nc_gn"] += 1
        return fwd(x, zq_r, *a)

    monkeypatch.setattr(tnc, "_norm_conv_forward", port_nc)
    for mod, name, key in ((tblocks, "spatial_norm_conv_mom", "ch_sn"),
                           (tblocks, "group_norm_conv_mom", "ch_gn"),
                           (tdecoder, "spatial_norm_conv_mom", "ch_sn")):
        def counted(*a, _fn=getattr(mod, name), _key=key, **kw):
            n[_key] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(mod, name, counted)

    def reset():
        for k in n:
            n[k] = 0

    return n, reset, monkeypatch


def _init_apply(module, mp, key, *args):
    """(params, jitted apply's output): init traced with the switches off
    (the param tree is the same on every branch, and interpret-mode tracing
    is slow), apply under the test's switches; the counts are reset after
    init."""
    switches = {k: os.environ.get(k) for k in ("CONTROL_GIC_NORM_CONV",
                                               "CONTROL_GIC_CHAIN")}
    for k in switches:
        mp.setenv(k, "0")
    params = module.init(jax.random.PRNGKey(key), *args)
    for k, v in switches.items():
        mp.setenv(k, v)
    return params, jax.jit(module.apply)(params, *args)


def _same_engagement(n, **want):
    for key, val in want.items():
        assert n[key] == n["jax_" + key] == val, n


@pytest.mark.parametrize("zq_cond", [True, False], ids=["sn", "gn"])
@pytest.mark.parametrize("cin, cout", [(128, 128), (256, 128), (128, 256)])
def test_resnet_block_per_call(engaged, zq_cond, cin, cout):
    n, reset, mp = engaged
    mp.setenv("CONTROL_GIC_CHAIN", "0")
    rng = np.random.default_rng(cin + 3 * cout + zq_cond)
    x = jnp.asarray(rng.normal(size=(1, 16, 32, cin)), jnp.float32)
    zq = jnp.asarray(rng.normal(size=(1, 8, 16, 4)), jnp.float32)
    zarg = (zq,) if zq_cond else ()
    jb = JResnetBlock(out_channels=cout, zq_cond=zq_cond)
    reset()
    params, want = _init_apply(jb, mp, 2, x, *zarg)
    port = _port(ResnetBlock(cin, cout, 4 if zq_cond else None),
                 params["params"])
    with torch.no_grad():
        got = port(nchw(x), nchw(zq) if zq_cond else None)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), **TOL)
    form = "sn" if zq_cond else "gn"
    _same_engagement(n, **{f"nc_{form}": 2, "ch_sn": 0, "ch_gn": 0})


@pytest.mark.parametrize("chain", ["0", "interpret"])
def test_encoder_per_call(engaged, chain):
    """Trunk blocks (chained or per call), the heads' ResnetBlocks and the
    _MidHead norm_out + conv_out (Cout = 4)."""
    n, reset, mp = engaged
    mp.setenv("CONTROL_GIC_CHAIN", chain)
    kw = dict(ch=128, ch_mult=(1, 2, 2), num_res_blocks=2,
              attn_resolutions=(), resolution=32, z_channels=4)
    enc = JEncoder(**kw)
    x = jnp.asarray(np.random.default_rng(0).normal(size=(1, 32, 32, 3)),
                    jnp.float32)
    reset()
    params, want = _init_apply(enc, mp, 0, x)
    port = _port(Encoder(**kw), params["params"], "encoder")
    with torch.no_grad():
        got = port(nchw(x))
    for g, w in zip(got, want):
        np.testing.assert_allclose(nhwc(g), np.asarray(w), **TOL)
    # levels 0 (32x32) and 1 (16x16): 2 blocks of 2 convs each, chained
    # (2 calls a block) or per call; the heads at 32x32 and 16x16: 2 blocks
    # and conv_out each; level 2 and the coarse head (8 px wide) stay
    # unfused
    trunk = 8
    _same_engagement(n, nc_gn=10 + (0 if chain == "interpret" else trunk),
                     ch_gn=trunk if chain == "interpret" else 0, nc_sn=0)


def _masks(rng, hl, wl):
    m_c = (rng.uniform(size=(1, hl // 4, wl // 4)) < 0.3).astype(np.int32)
    m_m = (rng.uniform(size=(1, hl // 2, wl // 2)) < 0.4).astype(np.int32)
    m_m = m_m * (1 - m_c.repeat(2, 1).repeat(2, 2))
    m_f = 1 - m_m.repeat(2, 1).repeat(2, 2) - m_c.repeat(4, 1).repeat(4, 2)
    return m_c, m_m, m_f


@pytest.mark.parametrize("chain", ["0", "interpret"])
def test_decoder_per_call(engaged, chain):
    """Mids, trunk blocks and norm_out + conv_out (Cout = 3), per call or,
    with the chain on, chained where the trunk threads its moments."""
    n, reset, mp = engaged
    mp.setenv("CONTROL_GIC_CHAIN", chain)
    kw = dict(ch=128, ch_mult=(1, 1), num_res_blocks=1, attn_resolutions=(),
              resolution=32)
    dec = JDecoder(**kw)
    rng = np.random.default_rng(1)
    z = jnp.asarray(rng.normal(size=(1, 64, 64, 4)), jnp.float32)
    zq = jnp.asarray(rng.normal(size=(1, 64, 64, 4)), jnp.float32)
    masks = tuple(jnp.asarray(m) for m in _masks(rng, 64, 64))
    reset()
    params, want = _init_apply(dec, mp, 1, z, zq, masks)
    port = _port(Decoder(**kw), params["params"], "decoder")
    with torch.no_grad():
        got = port(nchw(z), nchw(zq),
                   tuple(torch.from_numpy(np.array(m)) for m in masks))
    np.testing.assert_allclose(nhwc(got), np.asarray(want), **TOL)
    # 3 mids x 2 blocks x 2 convs (64x64x128); the trunk's 2 levels (16x16,
    # 32x32) x 2 blocks x 2 convs and norm_out + conv_out: per call, or
    # 8 + 1 chain calls
    if chain == "interpret":
        _same_engagement(n, nc_sn=12, ch_sn=9, nc_gn=0)
    else:
        _same_engagement(n, nc_sn=12 + 8 + 1, ch_sn=0, nc_gn=0)
