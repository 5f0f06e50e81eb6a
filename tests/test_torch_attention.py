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


def test_dispatch_on_cpu_takes_the_plain_path():
    q, k, v = (torch.from_numpy(a) for a in _qkv(5, 1, 4096, 4096, 16))
    before = dict(tat.KERNEL_LAUNCHES)
    out = tat.attention(q, k, v)
    assert tat.KERNEL_LAUNCHES == before
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
