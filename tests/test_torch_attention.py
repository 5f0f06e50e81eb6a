"""The port's attention against the JAX package's: the plain path against
`attention_xla`, the blocked replay of the flash kernel against the Pallas
kernel run in interpret mode, and the dispatch on CPU tensors."""
import importlib

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from control_gic_tpu_torch.ops import attention as tat

# the JAX ops package re-exports a function named `attention`
jat = importlib.import_module("control_gic_tpu.ops.attention")

torch.set_num_threads(2)

TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _qkv(seed, b, tq, tk, c):
    rng = np.random.default_rng(seed)
    q = (2 * rng.normal(size=(b, tq, c))).astype(np.float32)
    k = rng.normal(size=(b, tk, c)).astype(np.float32)
    v = rng.normal(size=(b, tk, c)).astype(np.float32)
    return q, k, v


def _both(arrs, dtype):
    jx = tuple(jnp.asarray(a, getattr(jnp, dtype)) for a in arrs)
    tt = tuple(torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs)
    return jx, tt


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b, tq, tk, c", [(2, 512, 512, 64),
                                          (1, 1024, 1024, 256),
                                          (1, 512, 512, 256),
                                          (2, 256, 1024, 64)])
def test_plain_matches_attention_xla(b, tq, tk, c, dtype):
    (jq, jk, jv), (tq_, tk_, tv) = _both(_qkv(c + tq, b, tq, tk, c), dtype)
    want = _np(jat.attention_xla(jq, jk, jv))
    got = tat.attention_reference(tq_, tk_, tv)
    assert got.dtype == tq_.dtype and got.shape == (b, tq, c)
    np.testing.assert_allclose(got.float().numpy(), want, atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b, tq, tk, c", [(1, 512, 512, 64),
                                          (1, 512, 512, 256),
                                          (1, 256, 1024, 64)])
def test_blocked_replay_matches_pallas_interpret(b, tq, tk, c, dtype):
    (jq, jk, jv), (tq_, tk_, tv) = _both(_qkv(7 + c, b, tq, tk, c), dtype)
    want = _np(jat.attention_flash(jq, jk, jv, 256, 256, interpret=True))
    got = tat.flash_attention_blocked_reference(tq_, tk_, tv, 32, 64)
    np.testing.assert_allclose(got.float().numpy(), want, atol=TOL[dtype])


def test_blocked_replay_ragged_blocks():
    """Lengths that the blocks do not divide (the kernel masks the tail)."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(3, 2, 100, 130, 32))
    np.testing.assert_allclose(
        tat.flash_attention_blocked_reference(q, k, v, 32, 64).numpy(),
        tat.attention_reference(q, k, v).numpy(), atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b, tq, tk, c", [(1, 512, 512, 64),
                                          (1, 512, 512, 256),
                                          (1, 256, 1024, 64),
                                          (1, 256, 512, 384)])
def test_blocked_replay_kernel_blocking_matches_pallas_interpret(b, tq, tk,
                                                                 c, dtype):
    """The replay at the CUDA kernel's own blocking (64 query rows; 32 keys
    for bf16 above C = 256, else 64), its defaults."""
    (jq, jk, jv), (tq_, tk_, tv) = _both(_qkv(11 + c, b, tq, tk, c), dtype)
    want = _np(jat.attention_flash(jq, jk, jv, 256, 256, interpret=True))
    got = tat.flash_attention_blocked_reference(tq_, tk_, tv)
    assert tat.kernel_blocks(tq_.dtype, c) == (
        (64, 32) if dtype == "bfloat16" and c > 256 else (64, 64))
    np.testing.assert_allclose(got.float().numpy(), want, atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("splits", [2, 3, 4])
def test_blocked_replay_split_kv_matches_pallas_interpret(splits, dtype):
    """Split KV: each run of key blocks keeps its own (acc, m, l) and the
    runs fold in order, out and lse against the Pallas lse kernel."""
    b, tq, tk, c = 2, 256, 1024, 64
    (jq, jk, jv), (q, k, v) = _both(_qkv(13 + splits, b, tq, tk, c), dtype)
    jo, jlse = jat.attention_flash_with_lse(jq, jk, jv, 256, 256,
                                            interpret=True)
    o, lse = tat.flash_attention_blocked_reference(q, k, v, return_lse=True,
                                                   splits=splits)
    assert lse.shape == (b, tq) and lse.dtype == torch.float32
    np.testing.assert_allclose(o.float().numpy(), _np(jo), atol=TOL[dtype])
    np.testing.assert_allclose(lse.numpy(), _np(jlse)[..., 0], atol=1e-5)


@pytest.mark.parametrize("block_q, block_k, splits", [(64, 64, 1),
                                                      (64, 32, 1),
                                                      (64, 32, 3),
                                                      (64, 64, 2)])
def test_blocked_replay_kernel_blocking_ragged(block_q, block_k, splits):
    """Lengths that the kernel's blocks do not divide, with and without
    split KV."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(3, 2, 100, 130, 32))
    got, lse = tat.flash_attention_blocked_reference(
        q, k, v, block_q, block_k, return_lse=True, splits=splits)
    np.testing.assert_allclose(got.numpy(),
                               tat.attention_reference(q, k, v).numpy(),
                               atol=1e-5)
    logits = torch.matmul(q, k.transpose(1, 2)) * 32 ** -0.5
    np.testing.assert_allclose(lse.numpy(),
                               torch.logsumexp(logits, -1).numpy(), atol=1e-5)


def test_blocked_replay_refuses_an_empty_split():
    q, k, v = (torch.from_numpy(a) for a in _qkv(4, 1, 64, 256, 32))
    with pytest.raises(ValueError, match="empty"):    # 4 blocks of 64 keys
        tat.flash_attention_blocked_reference(q, k, v, 64, 64, splits=3)


def test_dispatch_on_cpu_takes_the_plain_path():
    q, k, v = (torch.from_numpy(a) for a in _qkv(5, 1, 4096, 4096, 16))
    before, plain = dict(tat.KERNEL_LAUNCHES), dict(tat.PLAIN_CALLS)
    out = tat.attention(q, k, v)
    assert tat.KERNEL_LAUNCHES == before and tat.PLAIN_CALLS == plain
    np.testing.assert_array_equal(out.numpy(),
                                  tat.attention_reference(q, k, v).numpy())


@pytest.fixture
def cpu_kernels(monkeypatch):
    """The dispatch as on a card, on CPU tensors: `use_kernel` true, the
    forward kernel's wrapper replaced by its blocked replay (its launches
    counted) and FLASH_MIN_TOKENS lowered to 512. Yields the launches."""
    calls = {"fwd": 0}

    def fwd(q, k, v, return_lse=False):
        assert not return_lse and not torch.is_grad_enabled()
        calls["fwd"] += 1
        return tat.flash_attention_blocked_reference(q, k, v)

    monkeypatch.setattr(tat, "use_kernel", lambda t: True)
    monkeypatch.setattr(tat, "FLASH_MIN_TOKENS", 512)
    monkeypatch.setattr(tat, "flash_attention", fwd)
    return calls


def _plain_calls():
    return tat.PLAIN_CALLS["attention"]


@pytest.mark.parametrize("tq, tk", [(528, 528), (100, 600), (4464, 4464)])
def test_forward_takes_the_kernel_at_any_length(cpu_kernels, tq, tk):
    """Without a gradient the forward kernel runs from FLASH_MIN_TOKENS keys
    on whether or not JAX's blocks divide the lengths, and no plain call is
    counted."""
    assert tat._pick_block(tk, tat._BLOCK_K) == 0
    q, k, v = (torch.from_numpy(a) for a in _qkv(tq + tk, 1, tq, tk, 32))
    plain = _plain_calls()
    with torch.no_grad():
        out = tat.attention(q, k, v)
    assert cpu_kernels == {"fwd": 1} and _plain_calls() == plain
    np.testing.assert_allclose(out.numpy(),
                               tat.attention_reference(q, k, v).numpy(),
                               atol=TOL["float32"])


def test_grad_keeps_the_jax_rule_and_counts_the_fallback(cpu_kernels):
    """Under grad, lengths that JAX's blocks do not divide take the plain
    path: counted from FLASH_MIN_TOKENS keys on, not below."""
    ragged = tat.FLASH_MIN_TOKENS + 16
    for tk, counted in ((ragged, 1), (tat.FLASH_MIN_TOKENS - 16, 0)):
        q, k, v = (torch.from_numpy(a).requires_grad_()
                   for a in _qkv(tk, 1, tk, tk, 16))
        plain = _plain_calls()
        out = tat.attention(q, k, v)
        assert out.requires_grad and cpu_kernels == {"fwd": 0}
        assert _plain_calls() == plain + counted
        out.sum().backward()
        assert q.grad is not None and k.grad is not None


def test_below_the_key_threshold_stays_plain_and_uncounted(cpu_kernels):
    q, k, v = (torch.from_numpy(a) for a in _qkv(8, 1, 1024, 496, 16))
    plain = _plain_calls()
    with torch.no_grad():
        out = tat.attention(q, k, v)
    assert cpu_kernels == {"fwd": 0} and _plain_calls() == plain
    np.testing.assert_array_equal(out.numpy(),
                                  tat.attention_reference(q, k, v).numpy())


@pytest.mark.parametrize("t", [4096, 4112, 6144, 24576, 1024, 256, 100])
def test_pick_block_matches_jax(t):
    for preferred in (tat._BLOCK_Q, tat._BLOCK_K):
        assert tat._pick_block(t, preferred) == jat._pick_block(t, preferred)
    assert (tat._BLOCK_Q, tat._BLOCK_K) == (jat._BLOCK_Q, jat._BLOCK_K)
    assert tat.FLASH_MIN_TOKENS == jat._FLASH_MIN_TOKENS


def test_plain_versions_switch_restores_itself():
    from control_gic_tpu_torch import ops
    q = torch.zeros(1, 8, 16)
    assert not ops.use_kernel(q)
    assert not ops._PLAIN.get()
    with ops.plain_versions():
        with ops.plain_versions():
            assert ops._PLAIN.get()
        assert ops._PLAIN.get()
    assert not ops._PLAIN.get()


def test_flash_on_cpu_raises():
    q, k, v = (torch.from_numpy(a) for a in _qkv(6, 1, 64, 64, 16))
    with pytest.raises(ValueError, match="CUDA"):
        tat.attention(q, k, v, use_flash=True)
    with pytest.raises(ValueError, match="CUDA"):
        tat.flash_attention(q, k, v)
