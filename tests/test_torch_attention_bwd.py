"""The port's attention gradient against the JAX package's, on the CPU: the
logsumexp forward and the blocked replay of the two backward kernels against
the Pallas kernels in interpret mode (`attention_flash_with_lse`,
`_flash_backward`), autograd of the CPU dispatch against
jax.vjp(attention_xla), the autograd Functions' wiring with the kernels
replaced by their plain versions, and the CONTROL_GIC_FLASH_BWD=xla path."""
import importlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from control_gic_tpu_torch.ops import attention as tat

# the JAX ops package re-exports a function named `attention`
jat = importlib.import_module("control_gic_tpu.ops.attention")

torch.set_num_threads(2)

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
SHAPES = [(1, 256, 256, 64), (2, 512, 512, 64), (1, 256, 512, 64)]


def _inputs(seed, b, tq, tk, c):
    rng = np.random.default_rng(seed)
    return ((2 * rng.normal(size=(b, tq, c))).astype(np.float32),
            rng.normal(size=(b, tk, c)).astype(np.float32),
            rng.normal(size=(b, tk, c)).astype(np.float32),
            rng.normal(size=(b, tq, c)).astype(np.float32))


def _both(arrs, dtype):
    return (tuple(jnp.asarray(a, getattr(jnp, dtype)) for a in arrs),
            tuple(torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs))


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, dtype):
    """|got - want| <= TOL · max(1, max|want|)."""
    got = got.float().detach().numpy() if torch.is_tensor(got) else got
    scale = max(1.0, float(np.abs(want).max()))
    assert np.abs(got - want).max() <= TOL[dtype] * scale


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b, tq, tk, c", SHAPES)
def test_lse_forward_matches_pallas_interpret(b, tq, tk, c, dtype):
    (jq, jk, jv, _), (q, k, v, _) = _both(_inputs(c + tq + tk, b, tq, tk, c),
                                          dtype)
    jo, jlse = jat.attention_flash_with_lse(jq, jk, jv, 256, 256,
                                            interpret=True)
    o, lse = tat.flash_attention_blocked_reference(q, k, v, 32, 64,
                                                   return_lse=True)
    assert lse.shape == (b, tq) and lse.dtype == torch.float32
    _close(o, _np(jo), dtype)
    np.testing.assert_allclose(lse.numpy(), _np(jlse)[..., 0], atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b, tq, tk, c", SHAPES)
def test_backward_replay_matches_pallas_interpret(b, tq, tk, c, dtype):
    """Both sides get JAX's forward output and lse, so the comparison is of
    the backward alone."""
    (jq, jk, jv, jdo), (q, k, v, do) = _both(
        _inputs(3 * c + tq + tk, b, tq, tk, c), dtype)
    jo, jlse = jat.attention_flash_with_lse(jq, jk, jv, 256, 256,
                                            interpret=True)
    want = jat._flash_backward(jq, jk, jv, jo, jlse, jdo, 256, 256,
                               interpret=True)
    o = torch.from_numpy(_np(jo).copy()).to(q.dtype)
    lse = torch.from_numpy(_np(jlse)[..., 0].copy())
    got = tat.flash_attention_backward_blocked_reference(q, k, v, o, lse, do)
    for g, w in zip(got, want):
        assert g.dtype == q.dtype and g.shape == tuple(w.shape)
        _close(g, _np(w), dtype)


# (B, Tq, Tk, C, JAX block_q, JAX block_k): the JAX side takes blocks that
# divide its lengths; the last case's lengths are no multiple of the f32
# kernels' 32- and 64-row tiles
F32_BLOCKING = [(1, 256, 256, 64, 256, 256), (1, 256, 512, 128, 256, 256),
                (1, 128, 256, 256, 128, 256), (2, 100, 130, 64, 100, 130)]


@pytest.mark.parametrize("b, tq, tk, c, jbq, jbk", F32_BLOCKING)
def test_f32_replay_at_kernel_blocking_matches_pallas_interpret(
        b, tq, tk, c, jbq, jbk):
    """The replay at the f32 kernels' own tiles and summation order (ds
    scaled before the products) against JAX's backward; both sides get
    JAX's forward output and lse."""
    assert tat.kernel_bwd_blocks(torch.float32, c) == ((64, 32), (32, 64))
    (jq, jk, jv, jdo), (q, k, v, do) = _both(
        _inputs(7 * c + tq + tk, b, tq, tk, c), "float32")
    jo, jlse = jat.attention_flash_with_lse(jq, jk, jv, jbq, jbk,
                                            interpret=True)
    want = jat._flash_backward(jq, jk, jv, jo, jlse, jdo, jbq, jbk,
                               interpret=True)
    o = torch.from_numpy(_np(jo).copy())
    lse = torch.from_numpy(_np(jlse)[..., 0].copy())
    got = tat.flash_attention_backward_blocked_reference(q, k, v, o, lse, do)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == tuple(w.shape)
        _close(g, _np(w), "float32")


# (B, Tq, Tk, C, JAX block_q, JAX block_k) in bf16: the kernels own 64 query
# rows and BK keys, BK = 64 up to C = 256 and 32 above (C = 384 and 512
# here); the last two lengths are no multiple of either tile
BF16_BLOCKING = [(1, 256, 256, 64, 256, 256), (1, 256, 512, 128, 256, 256),
                 (1, 128, 256, 256, 128, 256), (1, 96, 100, 384, 96, 100),
                 (1, 64, 160, 512, 64, 160), (2, 100, 130, 64, 100, 130)]


def _bf16_case(b, tq, tk, c, jbq, jbk):
    """bf16 inputs on both sides, JAX's forward output and lse for both, and
    JAX's backward at its blocks."""
    (jq, jk, jv, jdo), (q, k, v, do) = _both(
        _inputs(11 * c + tq + tk, b, tq, tk, c), "bfloat16")
    jo, jlse = jat.attention_flash_with_lse(jq, jk, jv, jbq, jbk,
                                            interpret=True)
    o = torch.from_numpy(_np(jo).copy()).to(torch.bfloat16)
    lse = torch.from_numpy(_np(jlse)[..., 0].copy())
    return (jq, jk, jv, jo, jlse, jdo), (q, k, v, o, lse, do)


@pytest.mark.parametrize("b, tq, tk, c, jbq, jbk", BF16_BLOCKING)
def test_bf16_replay_at_kernel_blocking_matches_pallas_interpret(
        b, tq, tk, c, jbq, jbk):
    """The replay at the bf16 kernels' own tiles and scaling order (dk and dq
    scaled once after the sums) against JAX's backward, within 2e-2 of
    max(1, max|JAX|): p and ds are rounded to bf16 at the same points on
    both sides, and the f32 sums differ in order only."""
    bk = 64 if c <= 256 else 32
    assert tat.kernel_bwd_blocks(torch.bfloat16, c) == ((64, bk), (64, bk))
    jax_in, port_in = _bf16_case(b, tq, tk, c, jbq, jbk)
    want = jat._flash_backward(*jax_in, jbq, jbk, interpret=True)
    got = tat.flash_attention_backward_blocked_reference(*port_in)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and g.shape == tuple(w.shape)
        _close(g, _np(w), "bfloat16")


@pytest.mark.parametrize("b, tq, tk, c, jbq, jbk", BF16_BLOCKING)
def test_bf16_replay_at_kernel_tiles_matches_replay_at_jax_blocks(
        b, tq, tk, c, jbq, jbk):
    """The same replay at the kernels' tiles and at JAX's blocks: only the
    order of the f32 sums and where p and ds fall in blocks differ, within
    2e-2 of max(1, max|grad|)."""
    _, port_in = _bf16_case(b, tq, tk, c, jbq, jbk)
    got = tat.flash_attention_backward_blocked_reference(*port_in)
    want = tat.flash_attention_backward_blocked_reference(*port_in, jbq, jbk)
    for g, w in zip(got, want):
        _close(g, w.float().numpy(), "bfloat16")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b, tq, tk, c", SHAPES)
def test_dispatch_autograd_matches_jax_vjp(b, tq, tk, c, dtype):
    (jq, jk, jv, jdo), (q, k, v, do) = _both(
        _inputs(5 * c + tq, b, tq, tk, c), dtype)
    jout, vjp = jax.vjp(jat.attention_xla, jq, jk, jv)
    want = vjp(jdo)
    leaves = [t.requires_grad_() for t in (q, k, v)]
    out = tat.attention(*leaves)
    got = torch.autograd.grad(out, leaves, do)
    _close(out, _np(jout), dtype)
    for g, w in zip(got, want):
        _close(g, _np(w), dtype)


@pytest.fixture
def cpu_kernels(monkeypatch):
    """The dispatch's kernel path on CPU tensors, with every kernel replaced
    by its plain version (forward, lse forward and the two backward
    launches), counted; 512 tokens engage it."""
    calls = {"fwd": 0, "fwd_lse": 0, "dkdv": 0, "dq": 0}

    def fwd(q, k, v, return_lse=False):
        assert not torch.is_grad_enabled()
        calls["fwd_lse" if return_lse else "fwd"] += 1
        return tat.flash_attention_blocked_reference(q, k, v,
                                                     return_lse=return_lse)

    def dkdv(q, k, v, o, lse, do):
        calls["dkdv"] += 1
        _, dk, dv = tat.flash_attention_backward_blocked_reference(
            q, k, v, o, lse, do)
        delta = (do.float() * o.float()).sum(-1)
        return dk, dv, delta

    def dq(q, k, v, do, lse, delta):
        calls["dq"] += 1
        scale = q.shape[-1] ** -0.5
        s = torch.matmul(q.float(), k.float().transpose(1, 2)) * scale
        p = torch.exp(s - lse[..., None])
        dp = torch.matmul(do.float(), v.float().transpose(1, 2))
        ds = (p * (dp - delta[..., None])).to(q.dtype).float()
        return (torch.matmul(ds, k.float()) * scale).to(q.dtype)

    monkeypatch.setattr(tat, "use_kernel", lambda t: True)
    monkeypatch.setattr(tat, "FLASH_MIN_TOKENS", 512)
    monkeypatch.setattr(tat, "flash_attention", fwd)
    monkeypatch.setattr(tat, "flash_attention_backward_dkdv", dkdv)
    monkeypatch.setattr(tat, "flash_attention_backward_dq", dq)
    return calls


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_function_wiring(cpu_kernels, dtype):
    """Under grad the dispatch takes FlashAttentionFn: the lse forward once,
    then one dk/dv and one dq launch, and gradients equal to JAX's."""
    (jq, jk, jv, jdo), (q, k, v, do) = _both(_inputs(9, 1, 512, 512, 64),
                                             dtype)
    with torch.no_grad():
        tat.attention(q, k, v)
    assert cpu_kernels == {"fwd": 1, "fwd_lse": 0, "dkdv": 0, "dq": 0}
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = tat.attention(*leaves)
    got = torch.autograd.grad(out, leaves, do)
    assert cpu_kernels == {"fwd": 1, "fwd_lse": 1, "dkdv": 1, "dq": 1}
    _, vjp = jax.vjp(jat.attention_xla, jq, jk, jv)
    for g, w in zip(got, vjp(jdo)):
        _close(g, _np(w), dtype)


def test_reference_backward_switch(cpu_kernels, monkeypatch):
    """CONTROL_GIC_FLASH_BWD=xla: the forward kernel without the lse, then
    the backward through autograd of attention_reference (JAX's einsum
    recompute); no backward kernel runs."""
    monkeypatch.setenv("CONTROL_GIC_FLASH_BWD", "xla")
    (jq, jk, jv, jdo), (q, k, v, do) = _both(_inputs(10, 1, 512, 512, 64),
                                             "float32")
    leaves = [t.requires_grad_() for t in (q, k, v)]
    got = torch.autograd.grad(tat.attention(*leaves), leaves, do)
    assert cpu_kernels == {"fwd": 1, "fwd_lse": 0, "dkdv": 0, "dq": 0}
    _, vjp = jax.vjp(jat.attention_xla, jq, jk, jv)
    for g, w in zip(got, vjp(jdo)):
        _close(g, _np(w), "float32")
    assert jat._use_xla_bwd() and tat._use_reference_bwd()


def test_backward_replay_ragged_blocks():
    """Blocks that do not divide the lengths give autograd's gradient."""
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(4, 2, 100, 130, 32))
    o, lse = tat.flash_attention_blocked_reference(q, k, v, return_lse=True)
    got = tat.flash_attention_backward_blocked_reference(q, k, v, o, lse, do,
                                                         32, 16)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(tat.attention_reference(*leaves), leaves, do)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-5)


def test_backward_wrappers_on_cpu_raise():
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(6, 1, 64, 64, 16))
    lse = torch.zeros(1, 64)
    with pytest.raises(ValueError, match="CUDA"):
        tat.flash_attention_backward(q, k, v, q, lse, do)
    with pytest.raises(ValueError, match="CUDA"):
        tat.flash_attention(q, k, v, return_lse=True)
