"""The port's CUDA kernels against their plain versions on a card.

These need a CUDA card and nvcc; without them every test skips. On a card
(where JAX is not installed) run them without the JAX test harness:
    python -m pytest --noconftest -q tests/test_torch_kernels.py
"""
import pytest
import torch

from control_gic_tpu_torch.ops import attention as A


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
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
