"""The port's compiled programs (utils/programs.py) against the JAX
package's jitted ones, on the CPU at a tiny config with the same weights and
counts.

The capture backend here is a recorder: its capture runs the program on the
static inputs, and its replay runs it there again and writes the results
into the static outputs, as a CUDA graph's replay does. Through it the codec
takes the graph path (keys, warm-up, capture, copies into the static inputs,
replay, clones, launch accounting), and the results are held against JAX's:
the keys of its program caches, streams byte-identical and reconstructions
within 1e-4. A flipped switch, plain_versions(), an engagement rule or an
in-place weight change captures anew; a failed capture raises."""
import copy
import sys
import threading

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from control_gic_tpu.codec import CGICCodec as JCodec
from control_gic_tpu.models import CGIC as JCGIC
from control_gic_tpu.models import CGICConfig as JConfig
from control_gic_tpu.parallel import tiling as jtiling
from control_gic_tpu_torch import ops
from control_gic_tpu_torch.codec import CGICCodec
from control_gic_tpu_torch.kernels import build
from control_gic_tpu_torch.models import CGIC, CGICConfig
from control_gic_tpu_torch.ops import attention, norm_conv
from control_gic_tpu_torch.parallel import tiling
from control_gic_tpu_torch.utils.from_jax import state_dict_from_flax
from control_gic_tpu_torch.utils.programs import Programs

torch.set_num_threads(2)

SMALL = dict(n_embed=32, embed_dim=4, z_channels=4, ch=32,
             ch_mult=(1, 1, 2, 2, 2), num_res_blocks=1,
             attn_resolutions=(8,), resolution=64)
RATIOS = [(0.1, 0.4), (0.0, 0.8), (0.3, 0.0), (0.5, 0.5),
          (1.0, 0.0), (0.0, 1.0), (0.0, 0.0)]
TILE = 64


class Recorder:
    """A stand-in capture backend that runs on the static buffers. Its
    replay, like a graph's, calls no kernel wrapper's counter."""

    def __init__(self):
        self.captures = self.replays = 0

    def capture(self, fn, inputs):
        out = fn(*inputs)
        self.captures += 1
        return (fn, inputs, out), out

    def replay(self, graph):
        fn, inputs, out = graph
        count = build.count_launch
        build.count_launch = lambda counts, key: None
        try:
            new = fn(*inputs)
        finally:
            build.count_launch = count
        pairs = ([(out, new)] if isinstance(out, torch.Tensor)
                 else zip(out, new))
        for o, n in pairs:
            if o is not n:
                o.copy_(n)
        self.replays += 1


class FailingCapture(Recorder):
    def capture(self, fn, inputs):
        raise RuntimeError("operation not permitted when stream is capturing")


def _recorded(model, counts):
    codec = CGICCodec(model, counts, device="cpu")
    codec._programs.backend = Recorder()
    return codec


@pytest.fixture(scope="module")
def setup():
    """(JAX codec, the port's model, counts), same weights and counts."""
    jmodel = JCGIC(JConfig(**SMALL))
    variables = jax.jit(lambda k: jmodel.init(
        k, jnp.zeros((1, 64, 64, 3)), 0.1, 0.4))(jax.random.PRNGKey(11))
    counts = np.random.default_rng(12).integers(1, 1000,
                                                 size=SMALL["n_embed"])
    model = CGIC(CGICConfig(**SMALL))
    model.load_state_dict(state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, variables["params"])), strict=True)
    return JCodec(jmodel, variables, counts), model, counts


@pytest.fixture(scope="module")
def runs(setup):
    """The same calls on both codecs. Each of the port's programs is first
    called on other inputs (the warm-up and the capture), so that every
    result compared below comes from a replay."""
    jcodec, model, counts = setup
    codec = _recorded(model, counts)
    rng = np.random.default_rng(13)
    img_a, img_b = rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    out = {"codec": codec, "jcodec": jcodec, "compress": [], "replays": []}
    for rc, rm in RATIOS:
        codec.compress(img_b, rc, rm)
        before = codec._programs.backend.replays
        out["compress"].append((codec.compress(img_a, rc, rm),
                                jcodec.compress(img_a, rc, rm)))
        out["replays"].append(codec._programs.backend.replays - before)
    codec.compress(img_b, *RATIOS[0], device_pack=True)
    out["pack"] = (codec.compress(img_a, *RATIOS[0], device_pack=True),
                   jcodec.compress(img_a, *RATIOS[0], device_pack=True))

    batches = [rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
               for _ in range(3)]
    out["pipelined"] = (
        codec.roundtrip_pipelined(batches, *RATIOS[0], device_pack=True,
                                  threads=True),
        jcodec.roundtrip_pipelined(batches, *RATIOS[0], device_pack=True,
                                   threads=False))

    # two images of one padded size (112x128: tiles 64x64 and 48x64), so
    # that the second one replays the first one's tile programs
    tiles = [(rng.uniform(0, 1, (100, 120, 3)) * 255).astype(np.uint8)
             for _ in range(2)]
    out["tiled"] = (
        tiling.compress_tiled_device(codec, tiles, *RATIOS[0], tile=TILE,
                                     out_uint8=False, threads=True),
        jtiling.compress_tiled_device(jcodec, tiles, *RATIOS[0], tile=TILE,
                                      out_uint8=False, threads=False))
    return out


@pytest.mark.parametrize("mode", range(7))
def test_replayed_compress_matches_jax(runs, mode):
    (rec, bpp, enc), (jrec, jbpp, jenc) = runs["compress"][mode]
    assert runs["replays"][mode] == 2           # the encode and the decode
    assert enc.mode == jenc.mode == mode
    assert enc.streams == jenc.streams and bpp == jbpp
    np.testing.assert_allclose(rec, np.asarray(jrec), atol=1e-4)


def test_replayed_device_pack_matches_jax(runs):
    (rec, bpp, enc), (jrec, jbpp, jenc) = runs["pack"]
    assert enc.streams == jenc.streams and bpp == jbpp
    np.testing.assert_allclose(rec, np.asarray(jrec), atol=1e-4)


def test_replayed_pipeline_matches_jax(runs):
    (recs, encs), (jrecs, jencs) = runs["pipelined"]
    assert runs["codec"].last_pipeline_stats["threaded"] == 1.0
    assert [e.streams for b in encs for e in b] == \
        [e.streams for b in jencs for e in b]
    for rec, jrec in zip(recs, jrecs):
        np.testing.assert_allclose(rec, np.asarray(jrec), atol=1e-4)


def test_replayed_tiled_device_matches_jax(runs):
    got, want = runs["tiled"]
    for (rec, bpp, bundles), (wrec, wbpp, wbundles) in zip(got, want):
        assert bpp == wbpp
        assert [b.streams for b in bundles] == [b.streams for b in wbundles]
        np.testing.assert_allclose(rec, np.asarray(wrec), atol=1e-4)


@pytest.mark.parametrize("cache", ["_encode_fns", "_encode_pack_fns",
                                   "_decode_fns", "_tile_fns"])
def test_keys_match_jax(runs, cache):
    """The port's keys, projected onto JAX's fields (the first element; the
    rest are the inputs' shapes and dtypes, the call-time state and the
    weights' generation), are JAX's keys after the same calls."""
    keys = getattr(runs["codec"], cache)
    assert keys
    assert {k[0] for k in keys} == set(getattr(runs["jcodec"], cache))
    for key in keys:
        assert all(len(shape) in (1, 2, 3, 4) for shape, _ in key[1])


def _switched(kind, model, monkeypatch):
    """Enter one change of the call-time state (or of the weights)."""
    if kind == "env":
        monkeypatch.setenv("CONTROL_GIC_SUBPIXEL", "0")
    elif kind == "plain":
        return ops.plain_versions()
    elif kind == "rule":
        norm_conv.set_engagement_rule(lambda shape, cout: False)
    elif kind == "gate":
        monkeypatch.setattr(norm_conv, "CHAIN_MIN_ELEMS", 0)
    else:
        with torch.no_grad():
            model.decoder.conv_out.weight.mul_(1.5)
    return None


@pytest.mark.parametrize("kind", ["env", "plain", "rule", "gate", "weights"])
def test_changed_state_captures_anew(setup, kind, monkeypatch):
    _, model, counts = setup
    model = copy.deepcopy(model)
    codec = _recorded(model, counts)
    eager = CGICCodec(model, counts, device="cpu", graphs=False)
    rec = codec._programs.backend
    img = np.random.default_rng(14).uniform(0, 1, (64, 64, 3)).astype(
        np.float32)
    codec.compress(img, *RATIOS[0])
    codec.compress(img, *RATIOS[0])
    assert (rec.captures, rec.replays) == (2, 2)
    ctx = _switched(kind, model, monkeypatch)
    try:
        with ctx if ctx is not None else torch.no_grad():
            got = codec.compress(img, *RATIOS[0])
            want = eager.compress(img, *RATIOS[0])
    finally:
        norm_conv.set_engagement_rule(None)
    assert (rec.captures, rec.replays) == (4, 2)
    assert got[2].streams == want[2].streams
    np.testing.assert_array_equal(got[0], want[0])
    # the weights' generation drops the programs of the old weights
    n_programs = sum(map(len, codec._programs.caches))
    assert n_programs == (2 if kind == "weights" else 4)


def test_outputs_are_not_aliased(setup):
    """A replay's outputs are clones: call 1's result is unchanged after
    call 2 with other inputs (the pipelined codec fetches batch k while
    batch k+1 runs)."""
    _, model, counts = setup
    codec = _recorded(model, counts)
    imgs = np.random.default_rng(15).uniform(0, 1, (3, 1, 64, 64, 3)).astype(
        np.float32)
    encs = [codec.encode_batch(im, *RATIOS[0]) for im in imgs]
    codec.decode_batch_async(encs[0])                  # warm-up + capture
    out1 = codec.decode_batch_async(encs[1])
    kept = out1.clone()
    out2 = codec.decode_batch_async(encs[2])
    assert torch.equal(out1, kept) and not torch.equal(out1, out2)
    pend1 = codec.encode_batch_async(imgs[1], *RATIOS[0], device_pack=True)
    pend2 = codec.encode_batch_async(imgs[2], *RATIOS[0], device_pack=True)
    assert codec._programs.backend.replays >= 3
    assert [e.streams for e in codec.encode_finish(pend1)] == \
        [e.streams for e in encs[1]]
    assert [e.streams for e in codec.encode_finish(pend2)] == \
        [e.streams for e in encs[2]]


def _counting(x):
    build.count_launch(attention.KERNEL_LAUNCHES, "flash_fwd")
    build.count_launch(norm_conv.KERNEL_LAUNCHES, "chain_gn")
    build.count_launch(norm_conv.KERNEL_LAUNCHES, "chain_gn")
    return x + 1


def _counts():
    return (attention.KERNEL_LAUNCHES["flash_fwd"],
            norm_conv.KERNEL_LAUNCHES["chain_gn"])


@pytest.mark.parametrize("backend", [None, Recorder])
def test_launch_accounting(setup, backend):
    """The warm-up and the capture count as one call; each replay adds the
    captured delta; without a backend each call counts itself."""
    programs = Programs(setup[1], backend and backend())
    cache = programs.cache()
    x = torch.zeros(3)
    c0 = _counts()
    for n in range(1, 4):
        out = programs.run(cache, ("k",), _counting, x + n)
        assert torch.equal(out, torch.full((3,), n + 1.0))
        assert _counts() == (c0[0] + n, c0[1] + 2 * n)
    assert len(cache) == (0 if backend is None else 1)
    if backend is not None:
        assert (programs.backend.captures, programs.backend.replays) == (1, 2)
        assert programs.captured == 1 and programs.capture_s > 0


def test_replays_add_the_reference_calls(setup, monkeypatch):
    """A program whose SpatialNorm runs the reference formula where the
    kernels would run on the card (use_kernel as on the card, a C above the
    kernels' 2048) counts it in fused_norm.PLAIN_CALLS once for the warm-up
    and the capture, and each replay adds it again, as replays add the
    kernels' KERNEL_LAUNCHES."""
    from control_gic_tpu_torch.models.blocks import SpatialNorm
    from control_gic_tpu_torch.ops import fused_norm

    monkeypatch.setattr(fused_norm, "use_kernel", lambda t: True)
    norm = SpatialNorm(2080, 4).requires_grad_(False)
    with torch.no_grad():
        for p in norm.parameters():
            p.normal_(generator=torch.Generator().manual_seed(16))

    def fn(f, zq):
        build.count_launch(attention.KERNEL_LAUNCHES, "flash_fwd")
        return norm(f, zq, act="swish")

    programs = Programs(setup[1], Recorder())
    cache = programs.cache()
    g = torch.Generator().manual_seed(17)
    f, zq = torch.randn(1, 2080, 4, 4, generator=g), torch.randn(1, 4, 2, 2,
                                                                 generator=g)
    counts = lambda: (fused_norm.PLAIN_CALLS["spatial_norm"],
                      attention.KERNEL_LAUNCHES["flash_fwd"])
    wants = [norm(f + n, zq, act="swish") for n in range(1, 4)]
    c0 = counts()
    for n, want in enumerate(wants, 1):
        out = programs.run(cache, ("sn",), fn, f + n, zq)
        assert torch.equal(out, want)
        assert counts() == (c0[0] + n, c0[1] + n)
    assert (programs.backend.captures, programs.backend.replays) == (1, 2)


def test_every_counter_is_registered_once():
    """Each counter that counts at call time is in build.COUNTERS once, so
    that a replay adds its capture's counts to it once."""
    from control_gic_tpu_torch.coding import huffman_decode_device
    from control_gic_tpu_torch.ops import fused_norm
    from control_gic_tpu_torch.parallel import multihost
    ids = [id(c) for c in build.COUNTERS]
    for c in (attention.KERNEL_LAUNCHES, attention.PLAIN_CALLS,
              norm_conv.KERNEL_LAUNCHES,
              fused_norm.KERNEL_LAUNCHES, fused_norm.PLAIN_CALLS,
              huffman_decode_device.KERNEL_LAUNCHES,
              multihost.COLLECTIVE_CALLS, multihost.COLLECTIVE_BYTES):
        assert ids.count(id(c)) == 1, c


def test_threads_capture_once_and_count_exactly(setup):
    """Eight threads call one program at once: one capture, and every call
    counted once."""
    programs = Programs(setup[1], Recorder())
    cache = programs.cache()
    c0 = _counts()
    errors = []

    def worker(i):
        try:
            for j in range(25):
                out = programs.run(cache, ("k",), _counting,
                                   torch.full((4,), float(i * 100 + j)))
                assert torch.equal(out, torch.full((4,), i * 100 + j + 1.0))
        except BaseException as e:   # reported on the test's thread
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert programs.backend.captures == 1 and len(cache) == 1
    assert _counts() == (c0[0] + 200, c0[1] + 400)


def test_failed_capture_raises(setup):
    """No silent fallback: a capture that fails makes the call raise, keeps
    no program, and the next call tries (and fails) again."""
    _, model, counts = setup
    codec = CGICCodec(model, counts, device="cpu")
    codec._programs.backend = FailingCapture()
    img = np.random.default_rng(16).uniform(0, 1, (64, 64, 3)).astype(
        np.float32)
    c0 = _counts()
    for _ in range(2):
        with pytest.raises(RuntimeError, match="capturing"):
            codec.compress(img, *RATIOS[0])
        assert not any(codec._programs.caches)
    assert _counts() == c0


@pytest.mark.parametrize("graphs", [None, True, False])
def test_cpu_codec_makes_no_graph(setup, graphs):
    """A codec on the CPU makes no graph (the caller asked for the CPU):
    every call runs eagerly and no program is kept."""
    _, model, counts = setup
    codec = CGICCodec(model, counts, device="cpu", graphs=graphs)
    assert codec._programs.backend is None
    img = np.random.default_rng(17).uniform(0, 1, (64, 64, 3)).astype(
        np.float32)
    codec.compress(img, *RATIOS[0])
    assert not any(codec._programs.caches)
