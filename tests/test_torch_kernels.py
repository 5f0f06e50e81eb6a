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
                                          (3, 64, 65, 16)])
def test_flash_kernel_matches_plain(cuda, b, tq, tk, c, dtype, tol):
    q, k, v = _qkv(cuda, b, tq, tk, c, dtype, tq + tk + c)
    before = A.KERNEL_LAUNCHES
    out = A.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert A.KERNEL_LAUNCHES == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    err = (out.float() - A.attention_reference(q, k, v).float()).abs().max()
    assert err.item() <= tol


def test_flash_kernel_refuses_what_it_does_not_take(cuda):
    q, k, v = _qkv(cuda, 1, 64, 64, 32, torch.float32, 0)
    with pytest.raises(ValueError, match="contiguous"):
        A.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2),
                          k, v)
    with pytest.raises(TypeError):
        A.flash_attention(q.half(), k.half(), v.half())
    big = _qkv(cuda, 1, 16, 16, 528, torch.float32, 1)
    with pytest.raises(ValueError, match="head dim"):
        A.flash_attention(*big)


def test_dispatch_engages_the_kernel_from_4096_keys(cuda):
    before = A.KERNEL_LAUNCHES
    A.attention(*_qkv(cuda, 1, 1024, 1024, 64, torch.bfloat16, 2))
    assert A.KERNEL_LAUNCHES == before
    A.attention(*_qkv(cuda, 1, 256, 4096, 64, torch.bfloat16, 3))
    assert A.KERNEL_LAUNCHES == before + 1


def test_dispatch_stays_plain_where_jax_blocks_do_not_divide(cuda):
    before = A.KERNEL_LAUNCHES
    out = A.attention(*_qkv(cuda, 1, 4112, 4112, 64, torch.bfloat16, 4))
    assert A.KERNEL_LAUNCHES == before and out.shape == (1, 4112, 64)
    A.attention(*_qkv(cuda, 1, 6144, 6144, 64, torch.bfloat16, 5))
    assert A.KERNEL_LAUNCHES == before + 1


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
    (1, 64, 3, 9, 20)])
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


def test_chain_kernel_is_bit_stable(cuda):
    a = _chain_inputs(cuda, 1, 128, 128, 64, 64, torch.bfloat16, 7)
    out1, mom1 = _chain(a, True, True, None, True)
    out2, mom2 = _chain(a, True, True, None, True)
    assert torch.equal(out1, out2) and torch.equal(mom1, mom2)


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
