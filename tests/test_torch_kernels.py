"""The port's CUDA kernels against their plain versions on a card.

These need a CUDA card and nvcc; without them every test skips. On a card
(where JAX is not installed) run them without the JAX test harness:
    python -m pytest --noconftest -q tests/test_torch_kernels.py
"""
import itertools

import pytest
import torch

from control_gic_tpu_torch.ops import attention as A
from control_gic_tpu_torch.ops import fused_norm as FN
from control_gic_tpu_torch.ops import norm_conv as NC
from control_gic_tpu_torch.ops import plain_versions

# max |kernel - plain| <= tol * max(1, max |plain|)
OUT_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
MOM_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-5}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _qkv(device, b, tq, tk, c, dtype, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    q = 2 * torch.randn(b, tq, c, device=device, generator=g)
    k = torch.randn(b, tk, c, device=device, generator=g)
    v = torch.randn(b, tk, c, device=device, generator=g)
    return q.to(dtype), k.to(dtype), v.to(dtype)


@pytest.mark.parametrize("dtype, tol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("b, tq, tk, c", [(2, 100, 130, 64),
                                          (1, 4096, 4096, 256),
                                          (1, 33, 4096, 512),
                                          (3, 64, 65, 16),
                                          (1, 4096, 4096, 512),
                                          (1, 1024, 4096, 512),
                                          (1, 4100, 4100, 512),
                                          (1, 4100, 4100, 256),
                                          (2, 1000, 4100, 256),
                                          (1, 300, 4096, 384),
                                          # the tiled codec's edge tiles at
                                          # H/8: no 256-token block divides
                                          (1, 4464, 4464, 512),
                                          (1, 5952, 5952, 512)])
def test_flash_kernel_matches_plain(cuda, b, tq, tk, c, dtype, tol):
    q, k, v = _qkv(cuda, b, tq, tk, c, dtype, tq + tk + c)
    before = A.KERNEL_LAUNCHES["flash_fwd"]
    out = A.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert A.KERNEL_LAUNCHES["flash_fwd"] == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    err = (out.float() - A.attention_reference(q, k, v).float()).abs().max()
    assert err.item() <= tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_kernel_refuses_what_it_does_not_take(cuda, dtype):
    q, k, v = _qkv(cuda, 1, 64, 64, 32, dtype, 0)
    with pytest.raises(ValueError, match="contiguous"):
        A.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2),
                          k, v)
    with pytest.raises(TypeError):
        A.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(TypeError):
        A.flash_attention(q, k.float() if dtype != torch.float32
                          else k.bfloat16(), v)
    big = _qkv(cuda, 1, 16, 16, 528, dtype, 1)
    with pytest.raises(ValueError, match="head dim"):
        A.flash_attention(*big)
    odd = _qkv(cuda, 1, 16, 16, 40, dtype, 2)
    with pytest.raises(ValueError, match="head dim"):
        A.flash_attention(*odd)
    with pytest.raises(ValueError, match="aligned"):
        A.flash_attention(*(t.flatten()[1:1 + 63 * 32].view(1, 63, 32)
                            for t in _qkv(cuda, 1, 64, 64, 32, dtype, 3)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("b, tq, tk, c", [(1, 1024, 4096, 512),
                                          (1, 4096, 4096, 512),
                                          (2, 1000, 4100, 256)])
def test_flash_forward_is_bit_stable(cuda, dtype, b, tq, tk, c):
    """Two launches give the same bytes, split KV (its fixed-order
    combine) included: 1024 and 4096 query rows at B = 1 split the keys."""
    q, k, v = _qkv(cuda, b, tq, tk, c, dtype, 17 + c)
    first = A.flash_attention(q, k, v, return_lse=True)
    second = A.flash_attention(q, k, v, return_lse=True)
    assert all(torch.equal(x, y) for x, y in zip(first, second))
    assert torch.equal(A.flash_attention(q, k, v), first[0])


def test_dispatch_engages_the_kernel_from_4096_keys(cuda):
    before = A.KERNEL_LAUNCHES["flash_fwd"]
    A.attention(*_qkv(cuda, 1, 1024, 1024, 64, torch.bfloat16, 2))
    assert A.KERNEL_LAUNCHES["flash_fwd"] == before
    A.attention(*_qkv(cuda, 1, 256, 4096, 64, torch.bfloat16, 3))
    assert A.KERNEL_LAUNCHES["flash_fwd"] == before + 1


def test_dispatch_engages_at_lengths_jax_blocks_do_not_divide(cuda):
    """4112 tokens, which no 256-token block divides: without a gradient
    the forward kernel runs; under grad the plain path, counted in
    PLAIN_CALLS, and no kernel."""
    q, k, v = _qkv(cuda, 1, 4112, 4112, 64, torch.bfloat16, 4)
    before, plain = dict(A.KERNEL_LAUNCHES), dict(A.PLAIN_CALLS)
    with torch.no_grad():
        out = A.attention(q, k, v)
    assert A.KERNEL_LAUNCHES == {**before, "flash_fwd": before["flash_fwd"]
                                 + 1}
    assert A.PLAIN_CALLS == plain
    err = (out.float() - A.attention_reference(q, k, v).float()).abs().max()
    assert err.item() <= OUT_TOL[torch.bfloat16]
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    A.attention(*leaves).float().sum().backward()
    assert A.KERNEL_LAUNCHES == {**before, "flash_fwd": before["flash_fwd"]
                                 + 1}
    assert A.PLAIN_CALLS == {"attention": plain["attention"] + 1}
    assert all(t.grad is not None for t in leaves)


# ------------------------------------------------------- attention gradient

def _grads(fn, q, k, v, do):
    """(out, dq, dk, dv) of fn(q, k, v) for the output gradient do."""
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    out = fn(*leaves)
    return (out.detach(),) + torch.autograd.grad(out, leaves, do)


def test_attention_gradient_reaches_q_k_v(cuda):
    """The gradient fault: attention() through the kernel on CUDA tensors
    must give q, k and v the gradient that the plain version gives, not
    drop it."""
    q, k, v = _qkv(cuda, 1, 4096, 4096, 64, torch.float32, 11)
    do = torch.randn_like(q)
    got = _grads(A.attention, q, k, v, do)
    with plain_versions():
        want = _grads(A.attention, q, k, v, do)
    for g, w in zip(got, want):
        assert g is not None and _rel_err(g, w) <= 1e-4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("b, tq, tk, c", [(2, 256, 256, 64),
                                          (1, 100, 130, 64),
                                          (2, 33, 4096, 512),
                                          (1, 4096, 4096, 256),
                                          (1, 4096, 4096, 512),
                                          (1, 1024, 4096, 512),
                                          (1, 4100, 4100, 512),
                                          (2, 1000, 4100, 256)])
def test_flash_lse_matches_logsumexp(cuda, dtype, b, tq, tk, c):
    q, k, v = _qkv(cuda, b, tq, tk, c, dtype, 3 * tq + c)
    before = dict(A.KERNEL_LAUNCHES)
    out, lse = A.flash_attention(q, k, v, return_lse=True)
    torch.cuda.synchronize()
    assert A.KERNEL_LAUNCHES == {**before, "flash_fwd_lse":
                                 before["flash_fwd_lse"] + 1}
    assert lse.shape == (b, tq) and lse.dtype == torch.float32
    logits = torch.matmul(q.float(), k.float().transpose(1, 2)) * c ** -0.5
    assert _rel_err(lse, torch.logsumexp(logits, -1)) <= 1e-5
    assert torch.equal(out, A.flash_attention(q, k, v))    # the flag alone


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("b, tq, tk, c", [(2, 256, 256, 64),
                                          (1, 100, 130, 64),
                                          (1, 512, 4096, 128),
                                          (2, 4096, 4096, 512),
                                          (1, 4096, 4096, 256),
                                          (3, 64, 65, 16),
                                          (1, 4100, 4100, 512),
                                          (2, 33, 4096, 512),
                                          (1, 300, 4096, 384)])
def test_flash_backward_matches_autograd_of_plain(cuda, dtype, b, tq, tk, c):
    q, k, v = _qkv(cuda, b, tq, tk, c, dtype, tq + 2 * tk + c)
    do = torch.randn(b, tq, c, device=cuda).to(dtype)
    before = dict(A.KERNEL_LAUNCHES)
    got = _grads(A.FlashAttentionFn.apply, q, k, v, do)
    torch.cuda.synchronize()
    assert A.KERNEL_LAUNCHES == {
        **before, **{key: before[key] + 1 for key in
                     ("flash_fwd_lse", "flash_bwd_dkdv", "flash_bwd_dq")}}
    want = _grads(A.attention_reference, q, k, v, do)
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        assert g.dtype == dtype and g.shape == w.shape, name
        assert _rel_err(g, w) <= OUT_TOL[dtype], name


# the bf16 kernels' tile edges: dk/dv owns BK keys (32 at C = 512, 64 at
# C = 256) and steps 64 query rows, dq the other way round; lengths one
# below and one above a tile, Tq != Tk
@pytest.mark.parametrize("b, tq, tk, c", [(2, 63, 31, 512), (2, 65, 33, 512),
                                          (2, 129, 95, 512),
                                          (2, 4095, 4097, 512),
                                          (2, 1024, 4096, 512),
                                          (2, 63, 63, 256), (2, 65, 65, 256),
                                          (2, 127, 129, 256),
                                          (2, 4097, 4095, 256),
                                          (2, 1024, 4096, 256)])
def test_bf16_backward_at_tile_edges(cuda, b, tq, tk, c):
    """dq, dk and dv against autograd of the plain version within
    2e-2 max(1, max|plain|), and two launches give equal bits."""
    q, k, v = _qkv(cuda, b, tq, tk, c, torch.bfloat16, 7 * tq + tk + c)
    do = torch.randn(b, tq, c, device=cuda).to(torch.bfloat16)
    o, lse = A.flash_attention(q, k, v, return_lse=True)
    got = A.flash_attention_backward(q, k, v, o, lse, do)
    again = A.flash_attention_backward(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    want = _grads(A.attention_reference, q, k, v, do)[1:]
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape, name
        assert _rel_err(g, w) <= OUT_TOL[torch.bfloat16], name
    assert all(torch.equal(x, y) for x, y in zip(got, again))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("b, tq, tk, c", [(2, 4096, 4096, 512),
                                          (2, 4096, 4096, 256),
                                          (2, 65, 33, 512),
                                          (2, 1000, 1500, 64)])
def test_flash_backward_is_bit_stable(cuda, dtype, b, tq, tk, c):
    """No atomics: two launches of each backward kernel give equal bytes."""
    q, k, v = _qkv(cuda, b, tq, tk, c, dtype, 9 + c)
    o, lse = A.flash_attention(q, k, v, return_lse=True)
    do = torch.randn_like(q)
    first = A.flash_attention_backward(q, k, v, o, lse, do)
    second = A.flash_attention_backward(q, k, v, o, lse, do)
    assert all(torch.equal(x, y) for x, y in zip(first, second))


def test_dispatch_under_grad_takes_the_lse_forward_and_backward(cuda):
    q, k, v = _qkv(cuda, 1, 4096, 4096, 32, torch.bfloat16, 12)
    before = dict(A.KERNEL_LAUNCHES)
    with torch.no_grad():
        A.attention(q, k, v)
    leaves = [t.requires_grad_() for t in (q, k, v)]
    A.attention(*leaves).float().sum().backward()
    assert A.KERNEL_LAUNCHES == {key: n + 1 for key, n in before.items()}
    assert all(t.grad is not None for t in leaves)


def test_reference_backward_switch(cuda, monkeypatch):
    """CONTROL_GIC_FLASH_BWD=xla: the forward kernel without the lse and
    the backward through autograd of the plain version."""
    monkeypatch.setenv("CONTROL_GIC_FLASH_BWD", "xla")
    q, k, v = _qkv(cuda, 1, 512, 4096, 64, torch.float32, 13)
    do = torch.randn_like(q)
    before = dict(A.KERNEL_LAUNCHES)
    got = _grads(A.attention, q, k, v, do)
    assert A.KERNEL_LAUNCHES == {**before,
                                 "flash_fwd": before["flash_fwd"] + 1}
    want = _grads(A.attention_reference, q, k, v, do)
    for g, w in zip(got, want):
        assert _rel_err(g, w) <= 1e-4


def test_flash_kernels_refuse_what_they_do_not_take(cuda):
    q, k, v = _qkv(cuda, 1, 64, 64, 32, torch.float32, 0)
    o, lse = A.flash_attention(q, k, v, return_lse=True)
    with pytest.raises(ValueError, match="lse"):
        A.flash_attention_backward(q, k, v, o, lse[:, :32].contiguous(), o)
    with pytest.raises(TypeError):
        A.flash_attention_backward(q, k, v, o, lse, o.bfloat16())
    with pytest.raises(RuntimeError, match="gradient"):
        A.flash_attention(q.requires_grad_(), k, v)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("c", [528, 40])
def test_flash_backward_refuses_head_dims_it_does_not_take(cuda, dtype, c):
    """Above 512 or not a multiple of 16: both backward wrappers raise
    before any launch."""
    q, k, v = _qkv(cuda, 1, 64, 64, c, dtype, 4)
    lse = torch.zeros(1, 64, device=cuda)
    before = dict(A.KERNEL_LAUNCHES)
    with pytest.raises(ValueError, match="head dim"):
        A.flash_attention_backward_dkdv(q, k, v, q, lse, q)
    with pytest.raises(ValueError, match="head dim"):
        A.flash_attention_backward_dq(q, k, v, q, lse, lse)
    assert A.KERNEL_LAUNCHES == before


# ------------------------------------------------------- chained norm+conv

def _chain_inputs(device, b, cin, cout, h, w, dtype, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    r = lambda *s, scale=1.0: scale * torch.randn(*s, device=device,
                                                  generator=g)
    return dict(x=r(b, cin, h, w).to(dtype), zq_r=r(b, 4, h, w).to(dtype),
                gs=1 + r(cin, scale=0.1), gb=r(cin, scale=0.1),
                wy=r(cin, 4, scale=0.3), by=r(cin, scale=0.1),
                wb=r(cin, 4, scale=0.3), bb=r(cin, scale=0.1),
                cw=r(cout, cin, 3, 3, scale=(9 * cin) ** -0.5),
                cb=r(cout, scale=0.1), res=r(b, cout, h, w).to(dtype))


def _chain(a, modulate, with_res, stats, emit):
    kw = dict(res=a["res"] if with_res else None, stats=stats, emit_mom=emit)
    if modulate:
        return NC.spatial_norm_conv_mom(a["x"], a["zq_r"], a["gs"], a["gb"],
                                        a["wy"], a["by"], a["wb"], a["bb"],
                                        a["cw"], a["cb"], **kw)
    return NC.group_norm_conv_mom(a["x"], a["gs"], a["gb"], a["cw"], a["cb"],
                                  **kw)


def _rel_err(got, want):
    return ((got.float() - want.float()).abs().max()
            / max(1.0, want.float().abs().max().item())).item()


CHAIN_CONFIGS = list(itertools.product([True, False], [False, True],
                                       [False, True], [False, True]))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("b, cin, cout, h, w", [
    (2, 128, 128, 32, 48),     # square
    (1, 256, 128, 24, 32),     # Cin != Cout
    (1, 128, 256, 16, 32),
    (2, 128, 3, 32, 32),       # conv_out
    (1, 128, 128, 13, 40),     # H and W not multiples of the tile
    (1, 64, 3, 9, 20),
    # the bf16 tile's edges (64 columns; 4 rows at Cout 128, 2 at 256, 8
    # at Cout <= 8): W = TW -+ 1, H = TH +- 1, Cout = 256 as one CTA of N,
    # Cout = 512 as two, B = 2
    (1, 128, 128, 5, 63),
    (1, 128, 128, 3, 65),
    (2, 256, 256, 3, 64),
    (1, 256, 256, 1, 129),
    (2, 128, 3, 9, 65),
    (1, 256, 4, 7, 63),
    (1, 512, 512, 5, 65),
    # the tiled codec's ragged widths (tiles cut short of 64 columns; x not
    # loaded in 16-byte vectors where W is not a multiple of 8): a 768x496
    # tile's latent (W 124) and level 1 (W 248), a 576x496 tile's H/16 (W 31)
    (1, 512, 512, 192, 124),
    (1, 256, 256, 384, 248),
    (1, 512, 512, 36, 31)])
def test_chain_kernel_matches_plain(cuda, dtype, b, cin, cout, h, w):
    a = _chain_inputs(cuda, b, cin, cout, h, w, dtype, cin + cout + h + w)
    mom_in = FN.gn_moments_reference(a["x"])
    for modulate, with_res, with_stats, emit in CHAIN_CONFIGS:
        stats = (NC.stats_from_moments(mom_in, h * w) if with_stats
                 else None)
        before = dict(NC.KERNEL_LAUNCHES)
        got = _chain(a, modulate, with_res, stats, emit)
        torch.cuda.synchronize()
        key = "chain_sn" if modulate else "chain_gn"
        assert NC.KERNEL_LAUNCHES[key] == before[key] + 1
        with plain_versions():
            want = _chain(a, modulate, with_res, stats, emit)
        assert NC.KERNEL_LAUNCHES == {**before, key: before[key] + 1}
        what = (modulate, with_res, with_stats, emit)
        if emit:
            got, mom = got
            want, want_mom = want
            assert mom.shape == (b, 2, cout) and mom.dtype == torch.float32
            assert _rel_err(mom, want_mom) <= MOM_TOL[dtype], what
        assert got.shape == (b, cout, h, w) and got.dtype == dtype, what
        assert _rel_err(got, want) <= OUT_TOL[dtype], what


def _chain_grads(a, modulate, with_res, stats_from_x):
    """Gradients of a fixed projection of the chain's (out, mom) with
    respect to every input, with stats from the moment pass of x when
    stats_from_x, else given as leaves."""
    names = ["x", "gs", "gb", "cw", "cb"] + (["res"] if with_res else [])
    names += ["zq_r", "wy", "by", "wb", "bb"] if modulate else []
    leaves = {n: a[n].detach().clone().requires_grad_() for n in names}
    b = {**a, **leaves}
    if stats_from_x:
        stats = None
    else:
        mom = FN.gn_moments_reference(a["x"]).requires_grad_()
        leaves["mom_in"] = mom
        stats = NC.stats_from_moments(mom, a["x"].shape[2] * a["x"].shape[3])
    out, mom_out = _chain(b, modulate, with_res, stats, True)
    g = torch.Generator(device=out.device).manual_seed(5)
    loss = ((out.float() * torch.randn(out.shape, device=out.device,
                                       generator=g)).sum()
            + 1e-3 * (mom_out * torch.randn(mom_out.shape,
                                            device=out.device,
                                            generator=g)).sum())
    return dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))


@pytest.mark.parametrize("modulate", [True, False], ids=["sn", "gn"])
@pytest.mark.parametrize("with_res, stats_from_x", [(True, False),
                                                    (False, True)])
def test_chain_gradients_match_plain(cuda, modulate, with_res, stats_from_x):
    """The chain under grad (_ChainFn, and _GnMomentsFn for the stats)
    against autograd of the plain versions, in f32."""
    a = _chain_inputs(cuda, 2, 128, 128, 16, 32, torch.float32, 21)
    before = dict(NC.KERNEL_LAUNCHES)
    got = _chain_grads(a, modulate, with_res, stats_from_x)
    key = "chain_sn" if modulate else "chain_gn"
    assert NC.KERNEL_LAUNCHES[key] == before[key] + 1
    with plain_versions():
        want = _chain_grads(a, modulate, with_res, stats_from_x)
    for name in want:
        assert _rel_err(got[name], want[name]) <= 1e-4, name


def test_moment_gradient_matches_plain(cuda):
    x = torch.randn(2, 64, 24, 40, device=cuda, requires_grad=True)
    g = torch.randn(2, 2, 64, device=cuda)
    before = FN.KERNEL_LAUNCHES["gn_moments"]
    got, = torch.autograd.grad(FN.gn_moments(x), x, g)
    assert FN.KERNEL_LAUNCHES["gn_moments"] == before + 1
    want, = torch.autograd.grad(FN.gn_moments_reference(x), x, g)
    assert _rel_err(got, want) <= 1e-5


@pytest.mark.parametrize("cin, cout, h, w", [(128, 128, 64, 64),
                                           (256, 256, 34, 96),
                                           (128, 3, 40, 130),
                                           (256, 256, 384, 248)])
def test_chain_kernel_is_bit_stable(cuda, cin, cout, h, w):
    a = _chain_inputs(cuda, 1, cin, cout, h, w, torch.bfloat16, 7)
    out1, mom1 = _chain(a, True, True, None, True)
    out2, mom2 = _chain(a, True, True, None, True)
    assert torch.equal(out1, out2) and torch.equal(mom1, mom2)


@pytest.mark.parametrize("h, w, cout", [(512, 768, 128), (256, 384, 256),
                                        (512, 768, 3), (768, 768, 3),
                                        (192, 192, 512), (13, 65, 128),
                                        (3, 130, 256), (10, 65, 4)])
def test_tile_count_matches_the_mirror(cuda, h, w, cout):
    """The bf16 kernel's block of N and tile grid (the moment partials'
    second dim) as ops/norm_conv.py mirrors them for the packing and the
    CPU replay."""
    from control_gic_tpu_torch.kernels import build
    lib = build.load("norm_conv_chain")
    assert lib.cgic_norm_conv_chain_block_n(cout, 1) == NC.bf16_tile(cout)[0]
    assert lib.cgic_norm_conv_chain_tiles(h, w, cout, 1) == NC.bf16_tiles(
        h, w, cout)


@pytest.mark.parametrize("modulate", [True, False], ids=["sn", "gn"])
def test_in_place_weight_update_reaches_the_kernel(cuda, modulate):
    """The wrapper packs the weights once per version: an in-place update
    of cw (and of the modulation weights), as an optimizer step or
    load_state_dict makes, changes the next launch's output."""
    a = _chain_inputs(cuda, 1, 128, 128, 16, 64, torch.bfloat16, 41)
    first = _chain(a, modulate, False, None, False)
    with torch.no_grad():
        a["cw"].mul_(-2.0)
        a["wy"].add_(0.5)
    got = _chain(a, modulate, False, None, False)
    with plain_versions():
        want = _chain(a, modulate, False, None, False)
    assert not torch.equal(first, got)
    assert _rel_err(got, want) <= OUT_TOL[torch.bfloat16]


def test_chain_kernel_refuses_what_it_does_not_take(cuda):
    a = _chain_inputs(cuda, 1, 128, 128, 16, 16, torch.float32, 1)
    stats = NC.stats_from_moments(FN.gn_moments(a["x"]), 256)
    call = lambda **kw: NC.chain_kernel(**{
        **dict(x=a["x"], cw=a["cw"], cb=a["cb"], gs=a["gs"], gb=a["gb"],
               stats=stats), **kw})
    with pytest.raises(TypeError):
        call(x=a["x"].half())
    with pytest.raises(ValueError, match="contiguous"):
        call(x=a["x"].transpose(2, 3).contiguous().transpose(2, 3))
    with pytest.raises(ValueError, match="res"):
        call(res=a["res"][:, :64].contiguous())
    with pytest.raises(TypeError, match="res"):
        call(res=a["res"].bfloat16())
    with pytest.raises(ValueError, match="multiple of 32"):
        NC.chain_kernel(a["x"][:, :48].contiguous(), a["cw"][:, :48], a["cb"],
                        a["gs"][:48], a["gb"][:48],
                        (stats[0][:, :48], stats[1][:, :48]))
    with pytest.raises(ValueError, match="cw"):
        call(cw=a["cw"][:, :, :2])
    with pytest.raises(ValueError, match="zq_r"):
        call(zq_r=a["zq_r"][:, :3].contiguous(), wy=a["wy"], by=a["by"],
             wb=a["wb"], bb=a["bb"])
    with pytest.raises(ValueError, match="CUDA"):
        NC.chain_kernel(a["x"].cpu(), a["cw"], a["cb"], a["gs"], a["gb"],
                        stats)
    with pytest.raises(RuntimeError, match="gradient"):
        call(cw=a["cw"].clone().requires_grad_())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("b, c, h, w", [(1, 128, 512, 768), (2, 256, 64, 96),
                                        (1, 64, 7, 9), (3, 32, 1, 1)])
def test_moment_kernel_matches_plain(cuda, dtype, b, c, h, w):
    g = torch.Generator(device=cuda).manual_seed(c + h)
    x = (0.5 + 2 * torch.randn(b, c, h, w, device=cuda, generator=g)).to(dtype)
    before = FN.KERNEL_LAUNCHES["gn_moments"]
    mom = FN.gn_moments(x)
    torch.cuda.synchronize()
    assert FN.KERNEL_LAUNCHES["gn_moments"] == before + 1
    with plain_versions():
        want = FN.gn_moments(x)
    assert FN.KERNEL_LAUNCHES["gn_moments"] == before + 1
    assert mom.shape == (b, 2, c) and mom.dtype == torch.float32
    assert _rel_err(mom, want) <= MOM_TOL[dtype]
    assert torch.equal(mom, FN.gn_moments(x))         # bit-stable


def test_moment_kernel_refuses_what_it_does_not_take(cuda):
    x = torch.randn(1, 32, 8, 16, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        FN.gn_moments_kernel(x.transpose(2, 3))
    with pytest.raises(TypeError):
        FN.gn_moments_kernel(x.half())
    with pytest.raises(ValueError, match="B, C, H, W"):
        FN.gn_moments_kernel(x[0])
    with pytest.raises(ValueError, match="CUDA"):
        FN.gn_moments_kernel(x.cpu())
    with pytest.raises(RuntimeError, match="gradient"):
        FN.gn_moments_kernel(x.requires_grad_())


# ------------------------------------------------- per-call norm+conv op

def _norm_conv_call(a, modulate):
    if modulate:
        return NC.spatial_norm_conv(a["x"], a["zq_r"], a["gs"], a["gb"],
                                    a["wy"], a["by"], a["wb"], a["bb"],
                                    a["cw"], a["cb"], use_fused=True)
    return NC.group_norm_conv(a["x"], a["gs"], a["gb"], a["cw"], a["cb"],
                              use_fused=True)


@pytest.mark.parametrize("modulate", [True, False], ids=["sn", "gn"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("b, cin, cout, h, w", [
    (1, 256, 256, 24, 32), (2, 128, 4, 32, 48), (1, 128, 3, 13, 40),
    (1, 512, 512, 16, 16), (1, 256, 128, 48, 16),
    # the bf16 tile's edges, as in test_chain_kernel_matches_plain
    (1, 512, 512, 3, 65), (2, 256, 256, 5, 63), (1, 128, 3, 9, 64),
    (2, 128, 128, 5, 129)])
def test_norm_conv_call_matches_plain(cuda, modulate, dtype, b, cin, cout, h,
                                      w):
    """The per-call op (JAX `_kernel`): the moment pass, then the chain
    kernel with no residual and no moments, counted as norm_conv_*."""
    a = _chain_inputs(cuda, b, cin, cout, h, w, dtype, 3 * cin + cout + h)
    before = {**NC.KERNEL_LAUNCHES, **FN.KERNEL_LAUNCHES}
    got = _norm_conv_call(a, modulate)
    torch.cuda.synchronize()
    key = "norm_conv_sn" if modulate else "norm_conv_gn"
    assert {**NC.KERNEL_LAUNCHES, **FN.KERNEL_LAUNCHES} == {
        **before, key: before[key] + 1, "gn_moments": before["gn_moments"] + 1}
    with plain_versions():
        want = _norm_conv_call(a, modulate)
    assert got.shape == (b, cout, h, w) and got.dtype == dtype
    assert _rel_err(got, want) <= OUT_TOL[dtype]


@pytest.mark.parametrize("modulate", [True, False], ids=["sn", "gn"])
def test_norm_conv_call_gradients_match_plain(cuda, modulate):
    """Under grad the op runs in _NormConvFn, whose backward differentiates
    norm_conv_reference / group_norm_conv_reference (stats from x)."""
    a = _chain_inputs(cuda, 2, 128, 128, 16, 32, torch.float32, 23)
    names = ["x", "gs", "gb", "cw", "cb"]
    names += ["zq_r", "wy", "by", "wb", "bb"] if modulate else []

    def grads():
        leaves = {n: a[n].detach().clone().requires_grad_() for n in names}
        out = _norm_conv_call({**a, **leaves}, modulate)
        g = torch.Generator(device=out.device).manual_seed(6)
        loss = (out * torch.randn(out.shape, device=out.device,
                                  generator=g)).sum()
        return dict(zip(leaves, torch.autograd.grad(
            loss, list(leaves.values()))))

    before = dict(NC.KERNEL_LAUNCHES)
    got = grads()
    key = "norm_conv_sn" if modulate else "norm_conv_gn"
    assert NC.KERNEL_LAUNCHES[key] == before[key] + 1
    with plain_versions():
        want = grads()
    for name in want:
        assert _rel_err(got[name], want[name]) <= 1e-4, name


# ------------------------------------------------------ SpatialNorm apply

def _apply(a, act_swish, use_fused=True):
    return FN.spatial_norm(a["x"], a["zq_r"], a["gs"], a["gb"], a["wy"],
                           a["by"], a["wb"], a["bb"], act_swish=act_swish,
                           use_fused=use_fused)


@pytest.mark.parametrize("act_swish", [True, False], ids=["swish", "plain"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("b, c, h, w", [(1, 512, 24, 40), (2, 128, 13, 9),
                                        (1, 256, 64, 64), (3, 32, 5, 7)])
def test_spatial_norm_apply_matches_plain(cuda, act_swish, dtype, b, c, h, w):
    """The apply kernel (JAX `_apply_kernel`) after the moment pass against
    its plain version, spatial_norm_kernel_act with the same stats; shapes
    whose planes are not a multiple of the 16-byte vector take the scalar
    path."""
    a = _chain_inputs(cuda, b, c, 8, h, w, dtype, c + h + w)
    before = dict(FN.KERNEL_LAUNCHES)
    got = _apply(a, act_swish)
    torch.cuda.synchronize()
    assert FN.KERNEL_LAUNCHES == {
        "gn_moments": before["gn_moments"] + 1,
        "spatial_norm_apply": before["spatial_norm_apply"] + 1}
    with plain_versions():
        want = _apply(a, act_swish)
    assert FN.KERNEL_LAUNCHES["spatial_norm_apply"] == (
        before["spatial_norm_apply"] + 1)
    assert got.shape == (b, c, h, w) and got.dtype == dtype
    assert _rel_err(got, want) <= OUT_TOL[dtype]
    assert torch.equal(got, _apply(a, act_swish))       # bit-stable


def test_spatial_norm_gradients_match_reference(cuda):
    """Under grad the switched SpatialNorm runs in _SpatialNormFn: the
    kernels forward, the gradient of spatial_norm_reference backward."""
    a = _chain_inputs(cuda, 2, 128, 8, 16, 32, torch.float32, 29)
    names = ["x", "zq_r", "gs", "gb", "wy", "by", "wb", "bb"]

    def grads(fn):
        leaves = {n: a[n].detach().clone().requires_grad_() for n in names}
        out = fn({**a, **leaves})
        g = torch.Generator(device=out.device).manual_seed(7)
        return out, dict(zip(leaves, torch.autograd.grad(
            out, list(leaves.values()),
            torch.randn(out.shape, device=out.device, generator=g))))

    before = FN.KERNEL_LAUNCHES["spatial_norm_apply"]
    out, got = grads(lambda b: _apply(b, True))
    assert FN.KERNEL_LAUNCHES["spatial_norm_apply"] == before + 1
    ref, want = grads(lambda b: _apply(b, True, use_fused=False))
    assert _rel_err(out, ref) <= 1e-4
    for name in want:
        assert _rel_err(got[name], want[name]) <= 1e-5, name


def test_stats_kernel_switch_launches_only_the_moments(cuda, monkeypatch):
    monkeypatch.setenv("CONTROL_GIC_STATS_KERNEL", "1")
    a = _chain_inputs(cuda, 1, 128, 8, 16, 16, torch.bfloat16, 31)
    before = dict(FN.KERNEL_LAUNCHES)
    got = _apply(a, True, use_fused=None)
    assert FN.KERNEL_LAUNCHES == {**before,
                                  "gn_moments": before["gn_moments"] + 1}
    with plain_versions():
        want = _apply(a, True, use_fused=None)
    assert _rel_err(got, want) <= OUT_TOL[torch.bfloat16]


def test_spatial_norm_takes_the_kernels_by_default_without_grad(
        cuda, monkeypatch):
    """A bf16 SpatialNorm of the decoder's kind (C=512, zq at half the
    resolution) with no switch set: under torch.no_grad() one moment pass
    and one apply launch, no reference call, within OUT_TOL of the plain
    formula; under grad (its parameters need one) the reference formula,
    counted in PLAIN_CALLS."""
    from control_gic_tpu_torch.models.blocks import SpatialNorm

    for name in ("CONTROL_GIC_FUSED_NORM", "CONTROL_GIC_STATS_KERNEL"):
        monkeypatch.delenv(name, raising=False)
    g = torch.Generator(device=cuda).manual_seed(41)
    norm = SpatialNorm(512, 4, torch.bfloat16).to(cuda)
    with torch.no_grad():
        for p in norm.parameters():
            p.copy_(1.0 + 0.1 * torch.randn(p.shape, device=cuda,
                                            generator=g))
    f = torch.randn(2, 512, 32, 48, device=cuda, generator=g).to(
        torch.bfloat16)
    zq = torch.randn(2, 4, 16, 24, device=cuda, generator=g)
    before, plain = dict(FN.KERNEL_LAUNCHES), dict(FN.PLAIN_CALLS)
    with torch.no_grad():
        got = norm(f, zq, act="swish")
    torch.cuda.synchronize()
    assert FN.KERNEL_LAUNCHES == {k: n + 1 for k, n in before.items()}
    assert FN.PLAIN_CALLS == plain
    with torch.no_grad(), plain_versions():
        want = norm(f, zq, act="swish")
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    assert _rel_err(got, want) <= OUT_TOL[torch.bfloat16]
    out = norm(f, zq, act="swish")
    assert out.requires_grad
    assert FN.KERNEL_LAUNCHES == {k: n + 1 for k, n in before.items()}
    assert FN.PLAIN_CALLS == {"spatial_norm": plain["spatial_norm"] + 1}
    assert torch.equal(out.detach(), want)


def test_spatial_norm_apply_refuses_what_it_does_not_take(cuda):
    a = _chain_inputs(cuda, 1, 64, 8, 8, 16, torch.float32, 2)
    mom = FN.gn_moments(a["x"])
    call = lambda **kw: FN.spatial_norm_apply_kernel(**{
        **dict(f=a["x"], zq_r=a["zq_r"], gs=a["gs"], gb=a["gb"], wy=a["wy"],
               by=a["by"], wb=a["wb"], bb=a["bb"], mom=mom,
               act_swish=True), **kw})
    with pytest.raises(TypeError):
        call(f=a["x"].half())
    with pytest.raises(ValueError, match="contiguous"):
        call(f=a["x"].transpose(2, 3).contiguous().transpose(2, 3))
    with pytest.raises(ValueError, match="zq_r"):
        call(zq_r=a["zq_r"].bfloat16())
    with pytest.raises(ValueError, match="shape"):
        call(gs=a["gs"][:32])
    with pytest.raises(ValueError, match="CUDA"):
        call(f=a["x"].cpu())
    with pytest.raises(RuntimeError, match="gradient"):
        call(gs=a["gs"].clone().requires_grad_())
    with pytest.raises(ValueError, match="mom"):
        call(mom=mom[:, :, :32].contiguous())
    x32 = a["x"][:, :32].contiguous()
    with pytest.raises(ValueError, match="channels"):
        call(f=x32, mom=FN.gn_moments(x32))


def _apply_kernel_inputs(device, b, c, h, w, dtype, seed):
    """The apply kernel's inputs, each image of the batch with its own
    offset and scale (so its own moments)."""
    a = _chain_inputs(device, b, c, 8, h, w, dtype, seed)
    k = torch.arange(b, device=device, dtype=torch.float32)[:, None, None,
                                                            None]
    a["x"] = ((1 + 2 * k) * a["x"].float() + 0.5 * k).to(dtype)
    return a


def _apply_kernel_call(a, mom, act_swish):
    return FN.spatial_norm_apply_kernel(
        a["x"], a["zq_r"], a["gs"], a["gb"], a["wy"], a["by"], a["wb"],
        a["bb"], mom, act_swish)


@pytest.mark.parametrize("act_swish", [True, False], ids=["swish", "plain"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("b, c, h, w", [
    (1, 32, 64, 64), (1, 128, 40, 24), (1, 256, 24, 32), (1, 512, 64, 64),
    (2, 512, 16, 24), (2, 128, 13, 9), (2, 32, 3, 5)])
def test_apply_kernel_folds_the_moments(cuda, act_swish, dtype, b, c, h, w):
    """The apply kernel fed the moments, against its plain version on the
    torch fold of the same moments and against the CPU replay of its order;
    B = 2 with different moments per image; ragged planes (13x9, 3x5) take
    the scalar path; two launches give bit-equal outputs."""
    a = _apply_kernel_inputs(cuda, b, c, h, w, dtype, 5 * c + h + b)
    mom = FN.gn_moments_reference(a["x"])
    before = dict(FN.KERNEL_LAUNCHES)
    got = _apply_kernel_call(a, mom, act_swish)
    torch.cuda.synchronize()
    assert FN.KERNEL_LAUNCHES == {
        **before, "spatial_norm_apply": before["spatial_norm_apply"] + 1}
    p = [a[n] for n in ("gs", "gb", "wy", "by", "wb", "bb")]
    want = FN.spatial_norm_kernel_act(
        a["x"], a["zq_r"], *p, act_swish, FN.gn_stats_from_moments(mom, h * w))
    replay = FN.spatial_norm_apply_replay(a["x"], a["zq_r"], *p, mom,
                                          act_swish)
    assert got.shape == (b, c, h, w) and got.dtype == dtype
    assert _rel_err(got, want) <= OUT_TOL[dtype]
    assert _rel_err(got, replay) <= OUT_TOL[dtype]
    if b == 2:                       # the images' outputs differ in scale
        assert _rel_err(got[1:], want[1:]) <= OUT_TOL[dtype]
    assert torch.equal(got, _apply_kernel_call(a, mom, act_swish))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("name", ["f", "zq_r"])
def test_apply_kernel_refuses_a_misaligned_base(cuda, dtype, name):
    """A tensor that starts off a 16-byte boundary raises in the wrapper;
    nothing launches."""
    a = _apply_kernel_inputs(cuda, 1, 64, 8, 16, dtype, 4)
    mom = FN.gn_moments_reference(a["x"])
    key = "x" if name == "f" else "zq_r"
    t = a[key]
    shifted = torch.empty(t.numel() + 1, dtype=dtype, device=cuda)[1:]
    shifted.copy_(t.reshape(-1))
    a[key] = shifted.view(t.shape)
    assert a[key].is_contiguous() and a[key].data_ptr() % 16
    before = dict(FN.KERNEL_LAUNCHES)
    with pytest.raises(ValueError, match="aligned"):
        _apply_kernel_call(a, mom, True)
    assert FN.KERNEL_LAUNCHES == before


def test_moment_wrapper_counts_one_launch_a_call(cuda):
    """The moment wrapper adds one to its count for each launch, and the
    switched SpatialNorm launches one moment pass and one apply."""
    x = torch.randn(2, 128, 16, 24, device=cuda).bfloat16()
    before = dict(FN.KERNEL_LAUNCHES)
    moms = [FN.gn_moments_kernel(x) for _ in range(3)]
    torch.cuda.synchronize()
    assert FN.KERNEL_LAUNCHES == {**before,
                                  "gn_moments": before["gn_moments"] + 3}
    assert torch.equal(moms[0], moms[2])
    a = _apply_kernel_inputs(cuda, 2, 128, 16, 24, torch.bfloat16, 9)
    _apply(a, True)
    assert FN.KERNEL_LAUNCHES == {
        "gn_moments": before["gn_moments"] + 4,
        "spatial_norm_apply": before["spatial_norm_apply"] + 1}


# ---------------------------------------- the codec's programs as CUDA graphs

@pytest.fixture(scope="module")
def graph_codecs():
    """The full-width bf16 codec (random weights from seed 0) with its
    programs captured as CUDA graphs, and the same model eagerly."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; CUDA graphs have no CPU mode")
    import numpy as np

    from control_gic_tpu_torch.cli.common import build_codec
    from control_gic_tpu_torch.codec import CGICCodec
    graph = build_codec(device="cuda", seed=0)
    eager = CGICCodec(graph.model, np.ones(graph.model.config.n_embed,
                                           np.int64), graphs=False)
    assert graph._programs.backend is not None
    assert eager._programs.backend is None
    return graph, eager


def _all_launches():
    return {**A.KERNEL_LAUNCHES, **NC.KERNEL_LAUNCHES, **FN.KERNEL_LAUNCHES}


@pytest.mark.parametrize("ratios", [(0.1, 0.4), (1.0, 0.0)])
def test_captured_programs_match_eager(graph_codecs, ratios):
    """256x256 through encode + pack and decode, three images: the first
    captures, the others replay. The same streams, reconstructions within
    1e-3 and the same launch counts as the eager codec, and each replay's
    output a tensor of its own."""
    import numpy as np
    graph, eager = graph_codecs
    imgs = np.random.default_rng(41).uniform(0, 1, (3, 1, 256, 256, 3))

    def run(codec):
        before, captured = _all_launches(), codec._programs.captured
        out = []
        for img in imgs:
            encs = codec.encode_finish(codec.encode_batch_async(
                img, *ratios, device_pack=True))
            out.append((encs, codec.decode_batch_async(encs)))
        torch.cuda.synchronize()
        after = _all_launches()
        return (out, {k: after[k] - before[k] for k in after},
                codec._programs.captured - captured)

    g_out, g_launches, g_captured = run(graph)
    e_out, e_launches, _ = run(eager)
    assert g_captured == 2                      # encode + pack, decode
    assert g_launches == e_launches and sum(g_launches.values()) > 0
    for (g_encs, g_rec), (e_encs, e_rec) in zip(g_out, e_out):
        assert [e.streams for e in g_encs] == [e.streams for e in e_encs]
        assert (g_rec.float() - e_rec.float()).abs().max().item() <= 1e-3
    assert g_out[1][1].data_ptr() != g_out[2][1].data_ptr()
    assert not torch.equal(g_out[1][1], g_out[2][1])


# ------------------------------------------------- the Huffman scan kernel

def _scan_inputs(skew, n_cap, lanes, seed):
    """Real streams of a table with Poisson counts skewed by `skew` (None:
    uniform, every code 10 bits), one lane per count in `lanes`, as int32
    CPU tensors: (payloads [S, W], counts [S], lut_sym, lut_len, L)."""
    import numpy as np

    from control_gic_tpu_torch.coding import HuffmanCodec
    from control_gic_tpu_torch.coding import huffman_decode_device as D
    rng = np.random.default_rng(seed)
    counts = (np.ones(1024, np.int64) if skew is None else np.maximum(
        rng.poisson(100 * skew ** rng.uniform(-1, 1, 1024), 1024), 1))
    h = HuffmanCodec.from_counts(counts)
    lut_sym, lut_len, L = D.build_decode_lut(h.codes)
    cw = n_cap * L // 32 + 2
    words = [D.words_from_frame(h.encode(rng.integers(0, 1024, n)), cw)[0]
             for n in lanes]
    return (torch.from_numpy(np.stack(words).view(np.int32)),
            torch.tensor(lanes, dtype=torch.int32),
            torch.from_numpy(lut_sym), torch.from_numpy(lut_len), L)


@pytest.mark.parametrize("skew, n_cap, lanes", [
    (None, 24576, (24576, 20000)),      # L = 10: the table in shared memory
    (20.0, 24576, (24576, 13)),         # L = 18: read through L1 / L2
    (50.0, 1000, (0, 1, 999, 1000)),    # L = 20, ragged lanes
    (20.0, 16, (16,) * 300)])           # many lanes
def test_huffman_scan_kernel_matches_plain(cuda, skew, n_cap, lanes):
    """The scan kernel equals the plain loop (run on the CPU) exactly, zeros
    past each lane's count included, and adds one launch a call."""
    from control_gic_tpu_torch.coding import huffman_decode_device as D
    payloads, counts, lut_sym, lut_len, L = _scan_inputs(skew, n_cap, lanes,
                                                         len(lanes))
    want = D.huffman_decode_bits_scan_reference(payloads, counts, lut_sym,
                                                lut_len, n_cap, L)
    before = D.KERNEL_LAUNCHES["huffman_scan"]
    got = D.huffman_decode_bits_scan(payloads.to(cuda), counts.to(cuda),
                                     lut_sym.to(cuda), lut_len.to(cuda),
                                     n_cap, L)
    torch.cuda.synchronize()
    assert D.KERNEL_LAUNCHES["huffman_scan"] == before + 1
    assert got.dtype == torch.int32 and torch.equal(got.cpu(), want)


def test_huffman_scan_kernel_refuses_what_it_does_not_take(cuda):
    from control_gic_tpu_torch.coding import huffman_decode_device as D
    payloads, counts, lut_sym, lut_len, L = _scan_inputs(None, 64, (64,), 0)
    args = [payloads.to(cuda), counts.to(cuda), lut_sym.to(cuda),
            lut_len.to(cuda)]
    with pytest.raises(ValueError, match="CUDA tensors only"):
        D.huffman_scan_kernel(payloads, counts, lut_sym, lut_len, 64, L)
    with pytest.raises(TypeError, match="int32"):
        D.huffman_scan_kernel(args[0].long(), *args[1:], 64, L)
    with pytest.raises(ValueError, match="guard word"):
        D.huffman_scan_kernel(args[0][:, :10].contiguous(), *args[1:], 64, L)
    with pytest.raises(ValueError, match="shape"):
        D.huffman_scan_kernel(*args[:2], args[2][:5].contiguous(), args[3],
                              64, L)


@pytest.mark.parametrize("impl", ["scan", "rank"])
def test_device_unpack_programs_match_eager(graph_codecs, monkeypatch, impl):
    """decode_batch(device_unpack=True) through captured programs (the first
    batch captures, the second replays) equals the eager codec's, and the
    host receiver's uint8 output; the scan launches once per Huffman
    stream either way."""
    import numpy as np

    from control_gic_tpu_torch.coding import huffman_decode_device as D
    monkeypatch.setenv("CONTROL_GIC_UNPACK_IMPL", impl)
    graph, eager = graph_codecs
    imgs = np.random.default_rng(43).uniform(0, 1, (2, 2, 256, 256, 3))
    for img in imgs:
        encs = graph.encode_batch(img, 0.1, 0.4, device_pack=True)
        launches = []
        for codec in (graph, eager):
            before = D.KERNEL_LAUNCHES["huffman_scan"]
            out = codec.decode_batch(encs, out_uint8=True,
                                     device_unpack=True, strict=True)
            launches.append(D.KERNEL_LAUNCHES["huffman_scan"] - before)
            assert codec.last_decode_path == "device"
            np.testing.assert_array_equal(
                out, codec.decode_batch(encs, out_uint8=True))
        assert launches == ([3, 3] if impl == "scan" else [0, 0])


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_captured_train_steps_match_eager(cuda, remat):
    """Three small training steps across disc_start (adaptive weight on) as
    CUDA graphs and eagerly, from the same seed, under deterministic
    algorithms: the same metrics, parameters, EMA and Adam state to the
    last bit, the same launches; two programs, one per side."""
    import numpy as np

    from control_gic_tpu_torch.models import CGICConfig
    from control_gic_tpu_torch.train import (TrainConfig, Trainer,
                                             create_train_state)
    from control_gic_tpu_torch.train.losses import LossConfig
    cfg = CGICConfig(n_embed=32, embed_dim=4, z_channels=4, ch=32,
                     ch_mult=(1, 1, 2, 2, 2), num_res_blocks=1,
                     attn_resolutions=(8,), resolution=64, remat=remat)
    tcfg = TrainConfig(loss=LossConfig(disc_start=2, adaptive_g_weight=True))
    xs = np.random.default_rng(44).uniform(-1, 1, (3, 2, 64, 64, 3)).astype(
        np.float32)
    old = (torch.are_deterministic_algorithms_enabled(),
           torch.backends.cudnn.deterministic)
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic = True
    runs = []
    try:
        for graphs in (True, False):
            trainer = Trainer(cfg, tcfg, graphs=graphs)
            state = create_train_state(cfg, tcfg, device=cuda, seed=5)
            before = _all_launches()
            metrics = [trainer.train_step(state, x)[1] for x in xs]
            torch.cuda.synchronize()
            after = _all_launches()
            runs.append((state, metrics, trainer.program_stats(),
                         {k: after[k] - before[k] for k in after}))
    finally:
        torch.use_deterministic_algorithms(old[0])
        torch.backends.cudnn.deterministic = old[1]
    (gs, gm, gp, gl), (es, em, ep, el) = runs
    assert gp["programs_captured"] == 2 and not ep and gl == el
    for a, b in zip(gm, em):
        assert all(torch.equal(a[k], b[k]) for k in b)
    for a, b in zip(gs.written_tensors(), es.written_tensors()):
        assert torch.equal(a, b)
