"""The operation and bound counts against hand-worked counts and against
torch's own counter on the reference, at small shapes."""
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from common import flops as F
from conftest import TINY
from reference import model as M
from reference import train as T


def test_conv_and_attention_by_hand():
    # a 3x3 conv 4 -> 8 on a 5x6 output: 8*5*6 outputs, 4*9 MACs each
    assert F.conv(4, 8, 3, 5, 6) == 2 * 8 * 5 * 6 * 4 * 9
    # q k^T and p v over 10 tokens of 16 channels: 2 * (2 * 10 * 10 * 16)
    assert F.attention(10, 16) == 6400


def test_bounds_by_hand():
    peaks = F.card_peaks("NVIDIA H100 80GB HBM3")
    assert peaks == (989e12, 67e12, 3.35e12)
    assert F.card_peaks("NVIDIA H100 PCIe") == (756e12, 51e12, 2.0e12)
    # 4096 tokens, C 512, bf16: 4*4096^2*512 ops against 2*(2*4096*512)*2
    # bytes; operations bound it
    want = 4 * 4096 ** 2 * 512 / 989e12
    got = F.flash_fwd_bound_s([(1, 4096, 4096, 512)], 2, 989e12, 3.35e12)
    assert got == pytest.approx(want)
    # a short sequence is bound by bytes: 64 tokens, C 512, f32
    nbytes = 4 * (2 * 64 * 512 + 2 * 64 * 512)
    assert F.flash_fwd_bound_s([(1, 64, 64, 512)], 4, 67e12, 3.35e12) == \
        pytest.approx(nbytes / 3.35e12)
    # the backward: 10 B Tq Tk C (S, dP, dV, dK, dQ) at the f32 peak;
    # 2,4096,4096,512 is bound by operations
    want = 10 * 2 * 4096 ** 2 * 512 / 67e12
    got = F.flash_bwd_bound_s([(2, 4096, 4096, 512)], 4, 67e12, 3.35e12)
    assert got == pytest.approx(want)
    assert got * 1e3 == pytest.approx(2.564, rel=1e-3)
    # 2.5 times the forward's operations
    assert F.flash_bwd_bound_s([(2, 4096, 4096, 512)], 4, 67e12, 1e30) == \
        pytest.approx(2.5 * F.flash_fwd_bound_s([(2, 4096, 4096, 512)], 4,
                                                67e12, 1e30))


@pytest.mark.parametrize("hw", [(64, 96), (128, 64)])
def test_codec_count_equals_torch_counter(hw):
    h, w = hw
    p = {k: torch.randn(s) * 0.1 for k, s in M.param_shapes(TINY).items()}
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        ind, masks, _ = M.encode(torch.rand(1, 3, h, w), p, TINY, (0.1, 0.4))
        M.decode(ind, masks, p, TINY)
    assert fc.get_total_flops() == F.codec_flops(TINY, h, w)


def test_lpips_and_disc_counts_equal_torch_counter():
    lp = {k: torch.randn(s) * 0.1 for k, s in T.lpips_shapes().items()}
    dp = {k: torch.randn(s) * 0.1 for k, s in T.disc_shapes().items()}
    x = torch.rand(1, 3, 64, 64)
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        T.lpips(x, x, lp)
    assert fc.get_total_flops() == 2 * F.lpips_flops(64, 64)
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        T.disc(x, dp, train=False)
    assert fc.get_total_flops() == F.disc_flops(64, 64)
    assert F.train_step_flops(TINY, 2, 64, 64) == 2 * (
        3 * F.codec_flops(TINY, 64, 64) + 3 * F.lpips_flops(64, 64)
        + 8 * F.disc_flops(64, 64))


def test_flash_attentions_follow_the_ports_rule():
    full = dict(TINY, ch=128, ch_mult=[1, 2, 2, 4, 4], num_res_blocks=2,
                attn_resolutions=[32], resolution=256, n_embed=1024)
    kodak = F.flash_attentions(full, 512, 768)
    # phase 4's launches: 24,576 tokens at C 512 x3 and C 256 x1, 6,144
    # at C 512 x6
    assert sorted(kodak) == sorted([(1, 24576, 24576, 512)] * 3
                                   + [(1, 24576, 24576, 256)]
                                   + [(1, 6144, 6144, 512)] * 6)
    # a 576 x 496 tile's latent (17,856 tokens) takes no 256-token block
    assert all(t != 17856 for _, t, _, _ in F.flash_attentions(full, 576,
                                                                496))
    assert len(F.flash_attentions(full, 256, 256, 2)) == 4
