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
                                          (1, 300, 4096, 384)])
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


def test_dispatch_stays_plain_where_jax_blocks_do_not_divide(cuda):
    before = A.KERNEL_LAUNCHES["flash_fwd"]
    out = A.attention(*_qkv(cuda, 1, 4112, 4112, 64, torch.bfloat16, 4))
    assert A.KERNEL_LAUNCHES["flash_fwd"] == before
    assert out.shape == (1, 4112, 64)
    A.attention(*_qkv(cuda, 1, 6144, 6144, 64, torch.bfloat16, 5))
    assert A.KERNEL_LAUNCHES["flash_fwd"] == before + 1


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("b, tq, tk, c", [(2, 4096, 4096, 512),
                                          (2, 4096, 4096, 256),
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
    (1, 512, 512, 5, 65)])
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
                                           (128, 3, 40, 130)])
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


def test_spatial_norm_apply_refuses_what_it_does_not_take(cuda):
    a = _chain_inputs(cuda, 1, 64, 8, 8, 16, torch.float32, 2)
    stats = NC.stats_from_moments(FN.gn_moments(a["x"]), 128)
    call = lambda **kw: FN.spatial_norm_apply_kernel(**{
        **dict(f=a["x"], zq_r=a["zq_r"], gs=a["gs"], gb=a["gb"], wy=a["wy"],
               by=a["by"], wb=a["wb"], bb=a["bb"], stats=stats,
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
