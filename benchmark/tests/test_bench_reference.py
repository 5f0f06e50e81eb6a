"""benchmark/reference/ against the port at a tiny width on the CPU: masks
and indices equal, the port's streams decode to the same indices and
re-encode to the same bytes, reconstructions within f32 tolerance, one
training step's losses and parameters; and the comparison fails a
perturbed reconstruction."""
import numpy as np
import pytest
import torch

from common import weights
from conftest import TINY
from reference import coder as C
from reference import judge
from reference import model as M
from reference import train as T

RATIOS = [(0.1, 0.4), (0.0, 0.8), (0.3, 0.0), (0.5, 0.5), (1.0, 0.0),
          (0.0, 1.0), (0.0, 0.0)]


def port_model(params):
    from control_gic_tpu_torch.models import CGIC, CGICConfig
    cfg = CGICConfig(**{k: tuple(v) if isinstance(v, list) else v
                        for k, v in TINY.items()})
    model = CGIC(cfg).eval()
    model.load_state_dict(params, strict=True)
    return model


@pytest.fixture(scope="module")
def params():
    return weights.make_params([("gen", M.param_shapes(TINY))], 5,
                               "cpu")["gen"]


@pytest.mark.parametrize("ratios", RATIOS)
def test_encode_decode_equal(params, ratios):
    model = port_model(params)
    x = torch.rand(2, 3, 64, 96, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        enc = model.encode(x, *ratios, per_sample=True)
        ind, masks, _ = M.encode(x, params, TINY, ratios)
        for a, b in zip(enc.router.masks, masks):
            assert torch.equal(a, b)
        assert torch.equal(enc.indices, ind)
        rec = model.decode_indices(enc.indices, enc.router.masks)
        want = M.decode(ind, masks, params, TINY)
    assert (rec - want).abs().max() <= 1e-4 * max(1.0, want.abs().max())


def test_batch_thresholds(params):
    model = port_model(params)
    x = torch.rand(2, 3, 64, 64, generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        enc = model.encode(x, 0.1, 0.4, per_sample=False)
    for a, b in zip(enc.router.masks, M.route(x, 0.1, 0.4,
                                              per_sample=False)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("ratios", RATIOS)
def test_streams(params, ratios):
    from control_gic_tpu_torch.codec import CGICCodec
    from common.images import skewed_counts
    counts = skewed_counts(TINY["n_embed"], 20.0, 1)
    codec = CGICCodec(port_model(params), counts, device="cpu")
    coder = C.Coder(counts)
    assert coder.codes == codec.huffman.codes
    img = np.random.default_rng(0).integers(0, 256, (64, 96, 3), np.uint8)
    enc = codec.encode(img, *ratios)
    ind, masks = C.decode_streams(coder, enc.streams, enc.mode,
                                  *enc.latent_hw)
    x = torch.from_numpy(img).permute(2, 0, 1)[None].float() / 255.0
    with torch.no_grad():
        ind_r, masks_r, _ = M.encode(x, params, TINY, ratios)
    assert (ind == ind_r[0].numpy()).all()
    for a, b in zip(masks, masks_r):
        assert (a == b[0].numpy()).all()
    assert C.encode_streams(coder, ind, masks, enc.mode) == enc.streams


def test_judge_fails_a_perturbed_reconstruction(params):
    from control_gic_tpu_torch.codec import CGICCodec
    counts = np.full(TINY["n_embed"], 10)
    codec = CGICCodec(port_model(params), counts, device="cpu")
    img = np.random.default_rng(1).integers(0, 256, (64, 96, 3), np.uint8)
    rec, bpp, enc = codec.compress(img, 0.1, 0.4)
    unit = {"image": img, "streams": enc.streams, "mode": enc.mode,
            "bpp": bpp, "rec": rec}
    good = judge.judge_codec([unit], params, TINY, counts, (0.1, 0.4), "cpu")
    assert good["stream_errors"] == 0 and good["index_diff"] == 0
    assert good["rec_vs_fp8"] < 0.1
    bad = judge.judge_codec([dict(unit, rec=rec + 0.07)], params, TINY,
                            counts, (0.1, 0.4), "cpu")
    assert bad["rec_vs_fp8"] > 1
    stream = dict(enc.streams)
    body = bytearray(stream["indices_fine"])
    body[-1] ^= 0x10
    stream["indices_fine"] = bytes(body)
    bad = judge.judge_codec([dict(unit, streams=stream)], params, TINY,
                            counts, (0.1, 0.4), "cpu")
    assert bad["stream_errors"] >= 1


def test_training_step_equals_the_ports():
    from control_gic_tpu_torch.models import CGICConfig
    from control_gic_tpu_torch.train import TrainConfig, Trainer
    from control_gic_tpu_torch.train import create_train_state
    cfg = CGICConfig(**{k: tuple(v) if isinstance(v, list) else v
                        for k, v in dict(TINY, n_embed=32).items()})
    st = create_train_state(cfg, TrainConfig(), device="cpu",
                            lpips_net="vgg")
    ref = T.State(st.gen.state_dict(), st.disc.state_dict(),
                  st.lpips.state_dict())
    trainer = Trainer(cfg, TrainConfig())
    x = np.random.default_rng(0).uniform(-1, 1, (2, 64, 64, 3)).astype(
        np.float32)
    _, met = trainer.train_step(st, x)
    r = T.train_step(ref, torch.from_numpy(x).permute(0, 3, 1, 2),
                     dict(TINY, n_embed=32), (0.1, 0.4))
    assert r["aeloss"] == pytest.approx(float(met["train/aeloss"]), rel=1e-5)
    assert r["discloss"] == pytest.approx(float(met["train/discloss"]),
                                          rel=1e-5)
    # Adam's first moments leaf by leaf, measured against the median leaf
    # (judge.judge_train's scale: some gradients are all but zero)
    prog = {"gen." + n: st.opt_gen.state[p]["exp_avg"]
            for n, p in st.gen.named_parameters()}
    med = np.median([v.norm().item() for k, v in ref.m.items()
                     if k.startswith("gen.")])
    for k, m in prog.items():
        assert (m - ref.m[k]).norm().item() <= 1e-3 * max(
            med, ref.m[k].norm().item()), k
