"""The CPU replay of the bf16 chain kernel's blocking (`chain_blocked_reference`:
its tiles, channel chunks, halo zeroed after the activation, bf16 activated
operand and per-tile moment partials) against the port's plain versions and
against the JAX package's Pallas kernels in interpret mode (`_kernel_chain`
through `_chain_forward_impl`, `_kernel` through `_norm_conv_forward` /
`_group_norm_conv_forward`); the weight packing and the per-version cache
of the wrapper."""
import gc

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from control_gic_tpu.ops import fused_norm as jfn
from control_gic_tpu.ops import norm_conv as jnc
from control_gic_tpu_torch.ops import fused_norm as tfn
from control_gic_tpu_torch.ops import norm_conv as tnc

torch.set_num_threads(2)

JAX_TOL = dict(atol=1e-4, rtol=1e-5)     # f32, the sums in another order
MOM_TOL = dict(atol=2e-3, rtol=1e-5)
BF16_TOL, BF16_MOM_TOL = 2e-2, 1e-2      # the card's tolerances


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(a, np.float32).transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.detach().float().numpy().transpose(0, 2, 3, 1)


def _inputs(seed, b, h, w, cin, cout):
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0, loc=0.0: (loc + scale * rng.normal(size=s)
                                        ).astype(np.float32)
    return dict(x=f(b, h, w, cin, loc=0.2, scale=1.3), zq=f(b, h, w, 4),
                gs=f(cin, scale=0.1, loc=1.0), gb=f(cin, scale=0.1),
                wy=f(4, cin, scale=0.3), by=f(cin, scale=0.1),
                wb=f(4, cin, scale=0.3), bb=f(cin, scale=0.1),
                cw=f(3, 3, cin, cout, scale=(9 * cin) ** -0.5),
                cb=f(cout, scale=0.1), res=f(b, h, w, cout))


def _port(a, dtype=torch.float32):
    """The port's arguments (NCHW, OIHW, [C, Z]) in x's dtype."""
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    return dict(x=nchw(a["x"]).to(dtype), zq_r=nchw(a["zq"]).to(dtype),
                gs=t["gs"], gb=t["gb"], wy=t["wy"].t(), by=t["by"],
                wb=t["wb"].t(), bb=t["bb"], cw=t["cw"].permute(3, 2, 0, 1),
                cb=t["cb"], res=nchw(a["res"]).to(dtype))


def _blocked(p, form, stats, with_res, emit):
    mod = ({k: p[k] for k in ("zq_r", "wy", "by", "wb", "bb")}
           if form == "sn" else {})
    return tnc.chain_blocked_reference(
        p["x"], p["cw"], p["cb"], p["gs"], p["gb"], stats,
        p["res"] if with_res else None, emit_mom=emit, **mod)


def _plain(p, form, stats, with_res, emit):
    kw = dict(res=p["res"] if with_res else None, stats=stats,
              emit_mom=emit)
    if form == "sn":
        return tnc.chain_reference(p["x"], p["zq_r"], p["gs"], p["gb"],
                                   p["wy"], p["by"], p["wb"], p["bb"],
                                   p["cw"], p["cb"], **kw)
    return tnc.plain_chain_reference(p["x"], p["gs"], p["gb"], p["cw"],
                                     p["cb"], **kw)


def _jax(a, form, with_res, emit, kind):
    """JAX's chain (`_kernel_chain`) with the stats of x given, or its
    per-call op (`_kernel`, stats from x inside), in interpret mode."""
    j = {k: jnp.asarray(v) for k, v in a.items()}
    sn = form == "sn"
    if kind == "call":
        norm = (j["zq"], j["gs"], j["gb"], j["wy"], j["by"], j["wb"],
                j["bb"]) if sn else (j["gs"], j["gb"])
        fn = jnc._norm_conv_forward if sn else jnc._group_norm_conv_forward
        return fn(j["x"], *norm, j["cw"], j["cb"], act_swish=True,
                  interpret=True)
    mean, rstd = jfn._gn_stats(j["x"], 32)
    cg = a["x"].shape[-1] // 32
    stats = jnp.repeat(mean, cg, axis=1), jnp.repeat(rstd, cg, axis=1)
    return jnc._chain_forward_impl(
        j["x"], j["zq"] if sn else None, j["gs"], j["gb"],
        *((j["wy"], j["by"], j["wb"], j["bb"]) if sn else (None,) * 4),
        j["cw"], j["cb"], j["res"] if with_res else None, stats,
        act_swish=True, emit_mom=emit, modulate=sn, interpret=True)


def _rel_err(got, want):
    got, want = got.float(), want.float()
    return ((got - want).abs().max()
            / max(1.0, want.abs().max().item())).item()


# (form, residual, moments, Cin, Cout, H, W, chain or per-call op): Cout 3,
# 128 and 256 (tile rows 8, 4 and 2), Cin 64 and 256 (2 and 8 chunks), H
# and W not multiples of the tile (64 columns)
CASES = [("sn", True, True, 256, 256, 11, 80, "chain"),
         ("gn", True, True, 256, 128, 13, 70, "chain"),
         ("sn", False, True, 64, 128, 9, 66, "chain"),
         ("gn", False, False, 64, 3, 10, 65, "chain"),
         ("sn", False, False, 256, 3, 7, 72, "chain"),
         ("gn", True, False, 64, 256, 5, 63, "chain"),
         ("sn", True, True, 64, 3, 9, 17, "chain"),
         ("gn", False, True, 256, 256, 3, 130, "chain"),
         ("sn", False, False, 256, 256, 13, 64, "call"),
         ("gn", False, False, 64, 3, 11, 65, "call"),
         ("gn", False, False, 256, 128, 9, 70, "call"),
         ("sn", False, False, 64, 3, 10, 40, "call")]


@pytest.mark.parametrize(
    "form, with_res, emit, cin, cout, h, w, kind", CASES,
    ids=[f"{c[7]}-{c[0]}-res{int(c[1])}-mom{int(c[2])}-{c[3]}to{c[4]}-"
         f"{c[5]}x{c[6]}" for c in CASES])
def test_blocked_replay_matches_plain_and_pallas(form, with_res, emit, cin,
                                                 cout, h, w, kind):
    a = _inputs(h * 131 + w + cin + cout, 2, h, w, cin, cout)
    # f32: against JAX's kernel in interpret mode and the plain version
    p = _port(a)
    stats = tnc.stats_from_moments(tfn.gn_moments(p["x"]), h * w)
    got = _blocked(p, form, stats, with_res, emit)
    want = _jax(a, form, with_res, emit, kind)
    plain = _plain(p, form, stats, with_res, emit)
    if emit:
        (got, mom), (want, want_mom), (plain, plain_mom) = got, want, plain
        assert mom.shape == (2, 2, cout) and mom.dtype == torch.float32
        np.testing.assert_allclose(mom.numpy(), np.asarray(want_mom),
                                   **MOM_TOL)
        np.testing.assert_allclose(mom.numpy(), plain_mom.numpy(), **MOM_TOL)
    assert got.shape == (2, cout, h, w) and got.dtype == torch.float32
    np.testing.assert_allclose(nhwc(got), np.asarray(want), **JAX_TOL)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **JAX_TOL)

    # bf16: the activated operand and the output rounded as the kernel
    # rounds them, against the plain version at the card's tolerance
    p16 = _port(a, torch.bfloat16)
    stats16 = tnc.stats_from_moments(tfn.gn_moments(p16["x"]), h * w)
    got = _blocked(p16, form, stats16, with_res, emit)
    want = _plain(p16, form, stats16, with_res, emit)
    if emit:
        (got, mom), (want, want_mom) = got, want
        assert _rel_err(mom, want_mom) <= BF16_MOM_TOL
    assert got.dtype == torch.bfloat16
    assert _rel_err(got, want) <= BF16_TOL


def test_blocked_replay_zeroes_the_halo_after_the_activation():
    """The halo of an image edge is act-zero, not act(0): with gb = 1 the
    activation of a zero input is swish(1) != 0, and the replay must not
    see it past the border."""
    a = _inputs(3, 1, 5, 9, 64, 8)
    p = _port(a)
    p["x"] = torch.zeros_like(p["x"])
    p["gb"] = torch.ones_like(p["gb"])
    p["cw"] = torch.ones_like(p["cw"])
    p["cb"] = torch.zeros_like(p["cb"])
    stats = (torch.zeros(1, 64), torch.ones(1, 64))
    out = _blocked(p, "gn", stats, False, False)
    act1 = 1.0 / (1.0 + np.exp(-1.0))
    # a corner sees 4 of its 9 taps inside the image, the centre all 9
    np.testing.assert_allclose(out[0, 0, 0, 0].item(), 4 * 64 * act1,
                               rtol=1e-5)
    np.testing.assert_allclose(out[0, 0, 2, 4].item(), 9 * 64 * act1,
                               rtol=1e-5)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("cout, cin", [(3, 128), (4, 256), (128, 64),
                                       (200, 96), (256, 256), (512, 512)])
def test_weight_packing_round_trips(dtype, cout, cin):
    cw = torch.from_numpy(np.random.default_rng(cout + cin).normal(
        size=(cout, cin, 3, 3)).astype(np.float32)).to(dtype)
    bn = tnc.bf16_tile(cout)[0] if dtype == torch.bfloat16 else (
        8 if cout <= 8 else 128)
    wpk = tnc.pack_weights(cw, dtype, bn)
    coutp = -(-cout // bn) * bn
    assert wpk.dtype == dtype and wpk.is_contiguous()
    assert wpk.numel() == 9 * cin * coutp
    if dtype == torch.bfloat16:
        assert wpk.shape == (coutp // bn, 9, cin // tnc.KC, tnc.KC // 8, bn,
                             8)
        # the block of (N-block 0, tap (1, 2), chunk 1): output channel n,
        # input channel 32 + 8 j + k
        if cin >= 64:
            blk = wpk[0, 5, 1]
            assert torch.equal(blk[2, min(bn, cout) - 1, 7],
                               cw[min(bn, cout) - 1, 32 + 16 + 7, 1, 2])
    assert torch.equal(tnc.unpack_weights(wpk, cout, cin), cw)
    # the padding along N is zero
    assert not tnc.unpack_weights(wpk, coutp, cin)[cout:].any()


@pytest.mark.parametrize("h, w, cout, tiles", [
    (512, 768, 128, 128 * 12), (256, 384, 256, 128 * 6),
    (512, 768, 3, 64 * 12), (768, 768, 3, 96 * 12), (192, 192, 512, 96 * 3),
    (13, 65, 128, 4 * 2), (3, 130, 256, 2 * 3), (10, 65, 4, 2 * 2)])
def test_tile_mirror(h, w, cout, tiles):
    """The bf16 kernel's tile grid as the wrapper sizes the moment partials
    (the card test holds it against cgic_norm_conv_chain_tiles)."""
    assert tnc.bf16_tiles(h, w, cout) == tiles
    bn, th = tnc.bf16_tile(cout)
    assert bn >= min(cout, 256) and bn * th * tnc.TW // 2 <= 256 * 128


def test_cache_rebuilds_after_an_in_place_update():
    """The wrapper's per-version cache: the same value while the tensors
    are unchanged, a new one after an in-place update, and no entry left
    once a tensor is freed."""
    w = torch.ones(4, 3)
    b = torch.zeros(4)
    made = []

    def make():
        made.append(1)
        return w.sum().item() + b.sum().item()

    assert tnc._cached((w, b), ("k",), make) == 12.0
    assert tnc._cached((w, b), ("k",), make) == 12.0 and len(made) == 1
    with torch.no_grad():
        w.add_(1.0)                       # as an optimizer step does
    assert tnc._cached((w, b), ("k",), make) == 24.0 and len(made) == 2
    b.copy_(torch.ones(4))                # as load_state_dict does
    assert tnc._cached((w, b), ("k",), make) == 28.0 and len(made) == 3
    key = (id(w), id(b), "k")
    assert key in tnc._CACHE
    del w
    gc.collect()
    assert key not in tnc._CACHE
