"""The port's pipelined, wire-minimal codec against the JAX package's, on the
CPU at a tiny config with the same weights and counts: device-packed streams
(equal to the host coder's and to JAX's), the compact receiver's
reconstructions, roundtrip_pipelined with threads on and off, the async
batch API's error handling and stats, the three-stage runner's errors on
pure-Python stages, the uint16 codebook bound, and the inference CLI's
--device_pack, --batch, -w, --use-ema and --lpips."""
import os
import sys
import threading

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import control_gic_tpu.cli.infer as jinfer
import control_gic_tpu_torch.cli.infer as infer
from control_gic_tpu.codec import CGICCodec as JCodec
from control_gic_tpu.models import CGIC as JCGIC
from control_gic_tpu.models import CGICConfig as JConfig
from control_gic_tpu_torch.codec import CGICCodec
from control_gic_tpu_torch.models import CGIC, CGICConfig
from control_gic_tpu_torch.pipeline import run_stages
from control_gic_tpu_torch.utils import trace
from control_gic_tpu_torch.utils.from_jax import state_dict_from_flax

torch.set_num_threads(2)

SMALL = dict(n_embed=32, embed_dim=4, z_channels=4, ch=32,
             ch_mult=(1, 1, 2, 2, 2), num_res_blocks=1,
             attn_resolutions=(8,), resolution=64)
RATIOS = [(0.1, 0.4), (0.0, 0.8), (0.3, 0.0), (0.5, 0.5),
          (1.0, 0.0), (0.0, 1.0), (0.0, 0.0)]
STAT_KEYS = ("a_upload_s", "a_upload_bytes", "b_sync_s", "b_fetch_s",
             "b_frame_s", "b_fetch_bytes", "b_rebuild_s", "b_h2d_dispatch_s",
             "b_h2d_bytes", "c_sync_s", "c_fetch_s", "wall_s", "threaded")


@pytest.fixture(scope="module")
def codecs():
    """(JAX codec, the port's codec on the CPU), same weights and counts."""
    jmodel = JCGIC(JConfig(**SMALL))
    variables = jax.jit(lambda k: jmodel.init(
        k, jnp.zeros((1, 64, 64, 3)), 0.1, 0.4))(jax.random.PRNGKey(5))
    counts = np.random.default_rng(6).integers(1, 1000, size=SMALL["n_embed"])
    model = CGIC(CGICConfig(**SMALL))
    model.load_state_dict(state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, variables["params"])), strict=True)
    return JCodec(jmodel, variables, counts), CGICCodec(model, counts,
                                                        device="cpu")


@pytest.fixture(scope="module")
def batches():
    rng = np.random.default_rng(8)
    return [rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
            for _ in range(3)]


def _streams(encs):
    return [e.streams for e in encs]


@pytest.mark.parametrize("mode", range(7))
def test_device_pack_streams_equal_host_and_jax(codecs, batches, mode):
    jcodec, codec = codecs
    img = batches[0][0]
    packed = codec.encode(img, *RATIOS[mode], device_pack=True)
    assert packed.mode == mode
    assert packed.streams == codec.encode(img, *RATIOS[mode]).streams
    assert _streams(codec.encode_batch(batches[1], *RATIOS[mode],
                                       device_pack=True)) == \
        _streams(codec.encode_batch(batches[1], *RATIOS[mode]))
    if mode in (0, 3, 4):
        assert packed.streams == jcodec.encode(img, *RATIOS[mode],
                                               device_pack=True).streams


@pytest.mark.parametrize("mode", [0, 5])
def test_compact_receiver_matches_jax(codecs, batches, mode):
    jcodec, codec = codecs
    encs = codec.encode_batch(batches[0], *RATIOS[mode])
    jencs = jcodec.encode_batch(batches[0], *RATIOS[mode])
    assert _streams(encs) == _streams(jencs)
    rec = codec.decode_batch(encs)
    assert codec.last_decode_path == "host"
    assert rec.dtype == np.float32 and rec.shape == (2, 64, 64, 3)
    np.testing.assert_allclose(rec, np.asarray(jcodec.decode_batch(jencs)),
                               atol=1e-4)
    # out_uint8: save_png's quantization of the float reconstruction
    rec8 = codec.decode_batch(encs, out_uint8=True)
    assert rec8.dtype == np.uint8
    np.testing.assert_array_equal(
        rec8, (np.clip(rec, 0.0, 1.0) * 255).astype(np.uint8))


@pytest.mark.parametrize("threads", [False, True])
def test_roundtrip_pipelined_equals_serial_and_jax(codecs, batches, threads):
    jcodec, codec = codecs
    recs, encs = codec.roundtrip_pipelined(batches, 0.1, 0.4,
                                           device_pack=True, threads=threads)
    assert len(recs) == len(encs) == len(batches)
    for b, rec, enc in zip(batches, recs, encs):
        serial = codec.encode_batch(b, 0.1, 0.4)
        assert _streams(enc) == _streams(serial)
        np.testing.assert_array_equal(rec, codec.decode_batch(serial))
        jencs = jcodec.encode_batch(b, 0.1, 0.4)
        assert _streams(enc) == _streams(jencs)
        np.testing.assert_allclose(rec, np.asarray(jcodec.decode_batch(jencs)),
                                   atol=1e-4)
    stats = codec.last_pipeline_stats
    assert stats["threaded"] == float(threads) and stats["wall_s"] > 0
    assert set(STAT_KEYS) <= set(stats)
    assert stats["a_upload_bytes"] == sum(b.nbytes for b in batches)


def test_roundtrip_pipelined_host_coder_and_uint8(codecs, batches):
    _, codec = codecs
    recs, encs = codec.roundtrip_pipelined(batches[:2], 0.0, 0.8,
                                           out_uint8=True, threads=True)
    for b, rec, enc in zip(batches, recs, encs):
        serial = codec.encode_batch(b, 0.0, 0.8)
        assert _streams(enc) == _streams(serial)
        np.testing.assert_array_equal(
            rec, codec.decode_batch(serial, out_uint8=True))


def test_roundtrip_pipelined_empty(codecs):
    _, codec = codecs
    for threads in (None, True):
        assert codec.roundtrip_pipelined([], 0.1, 0.4,
                                         threads=threads) == ([], [])
    # threads=None follows the device: serial on the CPU
    assert codec.last_pipeline_stats["threaded"] == 0.0


@pytest.mark.parametrize("stage", ["decode_batch_async", "encode_finish"])
def test_worker_error_fails_the_call(codecs, batches, monkeypatch, stage):
    _, codec = codecs
    real = getattr(codec, stage)
    calls = []

    def failing(*args, **kwargs):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("injected failure")
        return real(*args, **kwargs)

    monkeypatch.setattr(codec, stage, failing)
    with pytest.raises(RuntimeError, match="injected failure"):
        codec.roundtrip_pipelined(batches, 0.1, 0.4, threads=True)
    assert codec.last_pipeline_stats["threaded"] == 1.0


def _run_failing(threads, failing, n, depth):
    """run_stages over n items on stages that log their calls, `failing`
    raising from item 1 on, called on a thread of its own with a time
    limit: (the errors raised, the log, the stats)."""
    log = []   # ("a", i) as stage a starts, ("raise", i) as a stage raises
    stats, raised = {}, []

    def stage(name):
        def run(i, x=None):
            if name == "a":
                log.append(("a", i))
            if name == failing and i >= 1:
                log.append(("raise", i))
                raise RuntimeError(f"stage {name} item {i}")
            return i
        return run

    def call():
        root = trace.span("cgic.test.root")
        try:
            with root:
                run_stages(n, stage("a"), stage("b"), stage("c"), root=root,
                           threads=threads, depth=depth, stats=stats)
        except RuntimeError as e:
            raised.append(e)

    t = threading.Thread(target=call)
    t.start()
    t.join(timeout=30)
    assert not t.is_alive()
    return raised, log, stats


@pytest.mark.parametrize("failing", ["a", "b", "c"])
@pytest.mark.parametrize("threads", [False, True])
def test_run_stages_raises_the_first_error(threads, failing):
    """The runner on pure-Python stages, the failing one raising from item
    1 on, 20 times with a short switch interval: the call raises item 1's
    error; threaded, once the failure is raised at most the queues' items
    (and one in each worker's hands) enter stage a, and both workers have
    exited."""
    n, depth = 20, 2
    before = threading.active_count()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for _ in range(20):
            raised, log, stats = _run_failing(threads, failing, n, depth)
            assert [str(e) for e in raised] == [f"stage {failing} item 1"]
            assert threading.active_count() == before
            assert stats["threaded"] == float(threads)
            at = log.index(("raise", 1))
            after = [e for e in log[at:] if e[0] == "a"]
            if threads:
                assert len(after) <= 2 * depth + 2
            else:
                assert after == [] and log[:at] == [("a", 0), ("a", 1)]
    finally:
        sys.setswitchinterval(old)


def test_encode_async_then_finish(codecs, batches):
    _, codec = codecs
    pend = codec.encode_batch_async(batches[0], 0.1, 0.4, device_pack=True)
    other = codec.encode_batch(batches[1], 0.1, 0.4)   # runs in between
    stats = {}
    encs = codec.encode_finish(pend, stats=stats)
    assert _streams(encs) == _streams(codec.encode_batch(batches[0], 0.1,
                                                         0.4))
    assert len(other) == 2
    assert {"b_sync_s", "b_fetch_s", "b_frame_s", "b_fetch_bytes"} <= set(
        stats)
    with pytest.raises(ValueError, match="same-mode"):
        codec.decode_batch_async([encs[0], other[0],
                                  codec.encode(batches[0][0], 0.0, 0.0)])


def test_uint16_codebook_bound(codecs):
    _, codec = codecs
    with pytest.raises(ValueError, match="65536"):
        CGICCodec(codec.model, np.ones(65537, np.int64), device="cpu")


# ------------------------------------------------------------- infer CLI

@pytest.fixture(scope="module")
def pngs(tmp_path_factory):
    from PIL import Image
    d = tmp_path_factory.mktemp("infer_imgs")
    rng = np.random.default_rng(9)
    for i in range(3):
        yy, xx = np.mgrid[0:70, 0:64] / 64
        img = 0.5 + 0.4 * np.sin((6 + i) * xx + 4 * yy)[..., None]
        img = img + 0.2 * rng.uniform(-1, 1, (70, 64, 3)) * (yy[..., None] > .5)
        Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8)).save(
            d / f"{i}.png")
    return d


def _fields(path, key):
    lines = path.read_text().splitlines()
    assert lines[-1].startswith("average: ")
    return [line.split(f"{key}=")[1].split()[0] for line in lines[:-1]]


@pytest.mark.parametrize("extra", [["--device_pack"],
                                   ["--device_pack", "--batch", "2"]])
def test_infer_cli_device_pack(codecs, pngs, tmp_path, extra):
    _, codec = codecs
    args = ["-i", str(pngs), "--device", "cpu"]
    infer.main(args + ["-o", str(tmp_path / "host")], codec=codec)
    infer.main(args + ["-o", str(tmp_path / "dev")] + extra, codec=codec)
    assert _fields(tmp_path / "dev" / "bpp.txt", "bpp") == _fields(
        tmp_path / "host" / "bpp.txt", "bpp")
    assert _fields(tmp_path / "dev" / "bpp.txt", "psnr") == _fields(
        tmp_path / "host" / "bpp.txt", "psnr")


@pytest.mark.parametrize("style", ["lines", "color"])
def test_infer_cli_partition_map_like_jax(codecs, pngs, tmp_path,
                                          monkeypatch, style):
    from PIL import Image
    jcodec, codec = codecs
    args = ["-i", str(pngs), "-r", "0", "2", "-w",
            "--partition_map_style", style]
    infer.main(args + ["-o", str(tmp_path / "port"), "--device", "cpu"],
               codec=codec)
    monkeypatch.setattr(jinfer, "build_codec",
                        lambda ckpt, use_ema=False: jcodec)
    monkeypatch.setattr(jinfer, "enable_compilation_cache", lambda: None)
    jinfer.main(args + ["-o", str(tmp_path / "jax")])
    for k in range(2):
        got = np.asarray(Image.open(tmp_path / "port" / f"{k:03d}_map.png"))
        want = np.asarray(Image.open(tmp_path / "jax" / f"{k:03d}_map.png"))
        assert got.shape == (64, 64, 3)
        np.testing.assert_array_equal(got, want)
    assert _fields(tmp_path / "port" / "bpp.txt", "bpp") == _fields(
        tmp_path / "jax" / "bpp.txt", "bpp")


def test_infer_cli_use_ema_and_lpips(codecs, pngs, tmp_path, monkeypatch,
                                     capsys):
    from control_gic_tpu_torch.data import EvalImageDataset
    from control_gic_tpu_torch.models.lpips import (LPIPS,
                                                    with_bundled_lin_heads)
    _, codec = codecs
    seen = {}

    def build(ckpt, device, use_ema):
        seen.update(ckpt=ckpt, device=device, use_ema=use_ema)
        return codec

    monkeypatch.setattr(infer, "build_codec", build)
    out = tmp_path / "out"
    infer.main(["-i", str(pngs), "-o", str(out), "--device", "cpu",
                "--ckpt", "ckpt_dir", "--use-ema", "--lpips", "-r", "0",
                "1"])
    assert seen == {"ckpt": "ckpt_dir", "device": "cpu", "use_ema": True}
    assert "NOTE: lin heads are the reference v0.1 weights" in \
        capsys.readouterr().out
    (got,) = map(float, _fields(out / "bpp.txt", "lpips"))
    img = EvalImageDataset(str(pngs))[0]
    rec, _, _ = codec.compress(img, 0.1, 0.4)
    model = with_bundled_lin_heads(LPIPS("alex")).eval()
    up = lambda x: torch.from_numpy(np.clip(x, 0, 1).astype(
        np.float32)).permute(2, 0, 1)[None]
    with torch.no_grad():
        want = float(model(up(rec), up(img), normalize=True)[0])
    assert got == pytest.approx(want, abs=1e-5)
    assert (out / "000_map.png").exists() is False
    assert os.path.exists(out / "streams")
