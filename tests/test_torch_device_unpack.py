"""The port's device-unpack receiver against the JAX package's, on the CPU at
the tests' tiny config with the same weights and counts (the contract of
tests/test_device_unpack.py, case for case): the decode tables, the
window peeks, the rank decoder and the scan's plain loop equal JAX's and
the host coder exactly; the flat upload is byte-identical to JAX's;
decode_batch(device_unpack=True) equals the port's host receiver (within
1e-6, uint8 equal) and JAX's device receiver (within 1e-4, the port's
tolerance against JAX) in all 7 modes under both CONTROL_GIC_UNPACK_IMPL
values; the pipelines and the tiled codec with device_unpack=True match
the host receiver and JAX; strict=True raises on a table the device cannot
decode, and without it the host receiver runs. On a CUDA tensor the scan
is a kernel (tests/test_torch_kernels.py holds it against the plain
loop)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from control_gic_tpu import codec as jcodec_mod
from control_gic_tpu.codec import CGICCodec as JCodec
from control_gic_tpu.coding import huffman_decode_tpu as J
from control_gic_tpu.models import CGIC as JCGIC
from control_gic_tpu.parallel import tiling as jtiling
from control_gic_tpu_torch import codec as codec_mod
from control_gic_tpu_torch.codec import CGICCodec
from control_gic_tpu_torch.coding import BitmapCodec, HuffmanCodec
from control_gic_tpu_torch.coding import huffman_decode_device as D
from control_gic_tpu_torch.models import CGIC, CGICConfig
from control_gic_tpu_torch.parallel import tiling
from control_gic_tpu_torch.utils.from_jax import state_dict_from_flax

from test_codec import RATIOS, TINY
from test_torch_programs import Recorder

torch.set_num_threads(2)

TILE = 64


def _t(a: np.ndarray) -> torch.Tensor:
    """numpy words (uint32) or tables (int32) -> an int32 tensor."""
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


def _skewed_counts(rng, skew: float, n: int = 256) -> np.ndarray:
    return np.maximum(rng.poisson(100 * skew ** rng.uniform(-1, 1, n), n),
                      1).astype(np.int64)


def _counts() -> np.ndarray:
    return np.random.default_rng(7).integers(0, 1000, size=TINY.n_embed)


@pytest.fixture(scope="module")
def codecs():
    """(JAX codec, the port's codec on the CPU) at test_codec.TINY, the same
    weights and counts (test_codec's draw: seed 7, 0..999)."""
    jmodel = JCGIC(TINY)
    variables = jax.jit(lambda k: jmodel.init(
        k, jnp.zeros((1, 64, 64, 3)), 0.1, 0.4))(jax.random.PRNGKey(0))
    counts = _counts()
    model = CGIC(CGICConfig(**{f: getattr(TINY, f) for f in (
        "n_embed", "embed_dim", "z_channels", "ch", "ch_mult",
        "num_res_blocks", "attn_resolutions", "resolution")}))
    model.load_state_dict(state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, variables["params"])), strict=True)
    return JCodec(jmodel, variables, counts), CGICCodec(model, counts,
                                                        device="cpu")


@pytest.fixture(scope="module")
def images():
    return np.random.default_rng(17).uniform(
        0, 1, (3, 64, 64, 3)).astype(np.float32)


# ------------------------------------------------------------ the decoders

@pytest.mark.parametrize("skew", [1.0, 50.0])
def test_build_decode_lut_matches_jax(skew):
    """The same arrays as JAX's build_decode_lut (exact), lut_len 1 where no
    code lands."""
    h = HuffmanCodec.from_counts(_skewed_counts(np.random.default_rng(3),
                                                skew))
    assert D.supports_decode_table(h.codes) == J.supports_decode_table(
        h.codes) is True
    got, want = D.build_decode_lut(h.codes), J.build_decode_lut(h.codes)
    assert got[2] == want[2]
    for a, b in zip(got[:2], want[:2]):
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)


def test_peek_windows_matches_jax():
    """Windows at every bit offset, bo == 0 included, exactly JAX's."""
    rng = np.random.default_rng(5)
    words = rng.integers(0, 2 ** 32, 40, dtype=np.uint64).astype(np.uint32)
    pos = np.arange(0, 38 * 32, 3, dtype=np.int32)
    for nbits in (1, 10, 20):
        want = np.asarray(J.peek_windows(jnp.asarray(words),
                                         jnp.asarray(pos), nbits))
        got = D.peek_windows(_t(words), torch.from_numpy(pos), nbits)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("skew", [1.0, 50.0])
def test_rank_decoder_matches_jax_and_host_coder(skew):
    """The rank decoder equals the host coder and JAX's huffman_decode_bits
    exactly, on empty, one-symbol, short and full streams, one stream at a
    time and as one batch."""
    rng = np.random.default_rng(int(skew))
    h = HuffmanCodec.from_counts(_skewed_counts(rng, skew))
    lut_sym, lut_len, L = D.build_decode_lut(h.codes)
    n_cap = 512
    cap_words = (n_cap * L + 31) // 32 + 2
    fn = jax.jit(J.huffman_decode_bits, static_argnames=("n_cap", "max_len"))
    payloads, ns, syms_in = [], [], []
    for n in (0, 1, 13, 512):
        syms = rng.integers(0, 256, n).astype(np.int64)
        words, _ = D.words_from_frame(h.encode(syms), cap_words)
        want = np.asarray(fn(jnp.asarray(words), jnp.int32(n),
                             jnp.asarray(lut_sym), jnp.asarray(lut_len),
                             n_cap=n_cap, max_len=L))
        got = D.huffman_decode_bits(_t(words), n, _t(lut_sym), _t(lut_len),
                                    n_cap, L)
        assert got.dtype == torch.int32 and got.shape == (n_cap,)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(got.numpy()[:n], syms)
        assert not got.numpy()[n:].any()
        payloads.append(words)
        ns.append(n)
        syms_in.append(syms)
    batch = D.huffman_decode_bits(_t(np.stack(payloads)),
                                  torch.tensor(ns, dtype=torch.int32),
                                  _t(lut_sym), _t(lut_len), n_cap, L)
    for lane, (n, syms) in enumerate(zip(ns, syms_in)):
        np.testing.assert_array_equal(batch[lane, :n].numpy(), syms)
        assert not batch[lane, n:].any()


@pytest.mark.parametrize("skew", [None, 50.0])
def test_scan_loop_matches_jax_lane_for_lane(skew):
    """The scan's plain loop (the CPU's path of huffman_decode_bits_scan)
    equals JAX's huffman_decode_bits_scan lane for lane, zeros past each
    lane's count included, and the rank decoder on the same lanes."""
    rng = np.random.default_rng(11)
    counts = (np.maximum(rng.poisson(80, 128), 1).astype(np.int64)
              if skew is None else _skewed_counts(rng, skew, 128))
    h = HuffmanCodec.from_counts(counts)
    lut_sym, lut_len, L = D.build_decode_lut(h.codes)
    n_cap = 100
    cap_words = (n_cap * L + 31) // 32 + 2
    lane_counts = np.asarray([0, 1, 37, 100], np.int32)
    payloads, syms_in = [], []
    for n in lane_counts:
        syms = rng.integers(0, 128, n).astype(np.int64)
        payloads.append(D.words_from_frame(h.encode(syms), cap_words)[0])
        syms_in.append(syms)
    payloads = np.stack(payloads)
    want = np.asarray(jax.jit(J.huffman_decode_bits_scan,
                              static_argnames=("n_cap", "max_len"))(
        jnp.asarray(payloads), jnp.asarray(lane_counts),
        jnp.asarray(lut_sym), jnp.asarray(lut_len), n_cap=n_cap, max_len=L))
    args = (_t(payloads), torch.from_numpy(lane_counts), _t(lut_sym),
            _t(lut_len), n_cap, L)
    got = D.huffman_decode_bits_scan(*args)
    assert got.dtype == torch.int32 and got.shape == (4, n_cap)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        D.huffman_decode_bits_scan_reference(*args).numpy(), want)
    np.testing.assert_array_equal(D.huffman_decode_bits(*args).numpy(), want)
    for lane, (n, syms) in enumerate(zip(lane_counts, syms_in)):
        np.testing.assert_array_equal(got[lane, :n].numpy(), syms)


def test_bitmap_decode_matches_host():
    b = BitmapCodec()
    for n in (1, 31, 32, 100):
        bits = np.random.default_rng(n).integers(0, 2, n).astype(np.int64)
        words, _ = D.words_from_frame(b.encode(bits), n // 32 + 2)
        np.testing.assert_array_equal(
            D.bitmap_decode_bits(_t(words), n).numpy(), bits)


def test_decode_lut_gate():
    """A one-symbol alphabet (an empty code) is not device-decodable, in
    either package; the cap is JAX's."""
    h = HuffmanCodec.from_counts(np.array([5]))
    assert not D.supports_decode_table(h.codes)
    assert not J.supports_decode_table(h.codes)
    assert D.MAX_LUT_BITS == J.MAX_LUT_BITS == 20
    with pytest.raises(ValueError, match="longest code"):
        D.build_decode_lut(h.codes)


def test_unpack_impl_switch(monkeypatch):
    monkeypatch.delenv("CONTROL_GIC_UNPACK_IMPL", raising=False)
    assert codec_mod.unpack_impl() == jcodec_mod.unpack_impl() == "scan"
    monkeypatch.setenv("CONTROL_GIC_UNPACK_IMPL", "rank")
    assert codec_mod.unpack_impl() == "rank"
    monkeypatch.setenv("CONTROL_GIC_UNPACK_IMPL", "bogus")
    with pytest.raises(ValueError, match="CONTROL_GIC_UNPACK_IMPL"):
        codec_mod.unpack_impl()
    with pytest.raises(ValueError, match="CONTROL_GIC_UNPACK_IMPL"):
        jcodec_mod.unpack_impl()


# -------------------------------------------------------------- the codec

@pytest.mark.parametrize("mode", range(7))
def test_flat_stream_upload_matches_jax(codecs, images, mode):
    """The same bundles give byte-identical flat words and offsets, and the
    same static layout, in both packages."""
    jcodec, codec = codecs
    encs = codec.encode_batch(images, *RATIOS[mode], device_pack=True)
    assert encs[0].mode == mode
    assert codec._unpack_caps(mode, 16, 16) == jcodec._unpack_caps(mode, 16,
                                                                   16)
    flat, offs = codec._flat_stream_upload(encs)
    jflat, joffs = jcodec._flat_stream_upload(encs)
    assert flat.dtype == jflat.dtype and offs.dtype == joffs.dtype
    assert flat.tobytes() == jflat.tobytes()
    assert offs.tobytes() == joffs.tobytes()


@pytest.mark.parametrize("impl", ["scan", "rank"])
@pytest.mark.parametrize("mode", range(7))
def test_device_unpack_matches_host_receiver_and_jax(codecs, images,
                                                     monkeypatch, mode,
                                                     impl):
    """decode_batch(device_unpack=True) against the port's host receiver
    (within 1e-6, the uint8 output equal) and JAX's device receiver on the
    same bundles (within 1e-4), on a batch routed per sample."""
    jcodec, codec = codecs
    monkeypatch.setenv("CONTROL_GIC_UNPACK_IMPL", impl)
    encs = codec.encode_batch(images, *RATIOS[mode], device_pack=True)
    host = codec.decode_batch(encs)
    assert codec.last_decode_path == "host"
    dev = codec.decode_batch(encs, device_unpack=True)
    assert codec.last_decode_path == "device"
    np.testing.assert_allclose(dev, host, atol=1e-6)
    host8 = codec.decode_batch(encs, out_uint8=True)
    dev8 = codec.decode_batch(encs, out_uint8=True, device_unpack=True,
                              strict=True)
    assert dev8.dtype == np.uint8
    np.testing.assert_array_equal(dev8, host8)
    jdev = np.asarray(jcodec.decode_batch(encs, device_unpack=True))
    assert jcodec.last_decode_path == "device"
    np.testing.assert_allclose(dev, jdev, atol=1e-4)


def test_strict_raises_and_fallback_takes_the_host(codecs, images):
    """Geometric counts give codes above 20 bits: strict=True raises (in
    both packages), otherwise the host receiver runs and says so."""
    jcodec, codec = codecs
    counts = 2 ** np.arange(TINY.n_embed, dtype=np.int64)
    deep = CGICCodec(codec.model, counts, device="cpu")
    assert max(len(c) for c in deep.huffman.codes.values()) > D.MAX_LUT_BITS
    assert deep._decode_tables is None
    encs = deep.encode_batch(images[:2], *RATIOS[0])
    with pytest.raises(ValueError, match="strict=True"):
        deep.decode_batch(encs, device_unpack=True, strict=True)
    jdeep = JCodec(jcodec.model, jcodec.variables, counts)
    with pytest.raises(ValueError, match="strict=True"):
        jdeep.decode_batch(encs, device_unpack=True, strict=True)
    got = deep.decode_batch(encs, device_unpack=True)
    assert deep.last_decode_path == "host"
    np.testing.assert_array_equal(got, deep.decode_batch(encs))
    with pytest.raises(ValueError, match="device-decodable"):
        tiling.compress_tiled_device(deep, [images[0]], *RATIOS[0],
                                     tile=TILE, device_unpack=True)


@pytest.mark.parametrize("threads", [False, True])
def test_pipelined_device_unpack_matches(codecs, threads):
    """roundtrip_pipelined(device_unpack=True) gives the host receiver's
    streams and reconstructions (within 1e-6)."""
    _, codec = codecs
    rng = np.random.default_rng(23)
    batches = [rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
               for _ in range(3)]
    recs_h, encs_h = codec.roundtrip_pipelined(
        batches, *RATIOS[0], device_pack=True, threads=threads)
    assert codec.last_pipeline_stats["device_unpack"] == 0.0
    recs_d, encs_d = codec.roundtrip_pipelined(
        batches, *RATIOS[0], device_pack=True, device_unpack=True,
        threads=threads)
    st = codec.last_pipeline_stats
    assert st["device_unpack"] == 1.0 and st["b_h2d_bytes"] > 0
    assert st["threaded"] == float(threads)
    for a, b in zip(encs_h, encs_d):
        assert [e.streams for e in a] == [e.streams for e in b]
    for a, b in zip(recs_h, recs_d):
        np.testing.assert_allclose(b, a, atol=1e-6)


@pytest.fixture(scope="module")
def tiled_images():
    """uint8 images: 128x96 (tiles 64x64 and 64x32) and 100x120 (padded to
    112x128: 64x64 and 48x64)."""
    rng = np.random.default_rng(29)
    return [(rng.uniform(0, 1, (h, w, 3)) * 255).astype(np.uint8)
            for h, w in [(128, 96), (100, 120)]]


@pytest.mark.parametrize("impl", ["scan", "rank"])
def test_tiled_device_unpack_matches_host_receiver_and_jax(
        codecs, tiled_images, monkeypatch, impl):
    """compress_tiled_device(device_unpack=True) against device_unpack=False
    (streams and bpp exact, the uint8 canvas equal, floats within 1e-6)
    and JAX's (within 1e-4)."""
    jcodec, codec = codecs
    monkeypatch.setenv("CONTROL_GIC_UNPACK_IMPL", impl)
    run = lambda **kw: tiling.compress_tiled_device(
        codec, tiled_images, *RATIOS[0], tile=TILE, threads=True, **kw)
    got = run(device_unpack=True, out_uint8=False)
    assert codec.last_pipeline_stats["device_unpack"] == 1.0
    want = run(out_uint8=False)
    assert codec.last_pipeline_stats["device_unpack"] == 0.0
    for (rec, bpp, bun), (wrec, wbpp, wbun) in zip(got, want):
        assert bpp == wbpp
        assert [b.streams for b in bun] == [b.streams for b in wbun]
        np.testing.assert_allclose(rec, wrec, atol=1e-6)
    for (rec8, _, _), (wrec8, _, _) in zip(run(device_unpack=True),
                                           run()):
        np.testing.assert_array_equal(rec8, wrec8)
    jgot = jtiling.compress_tiled_device(jcodec, tiled_images[:1],
                                         *RATIOS[0], tile=TILE,
                                         out_uint8=False, threads=False,
                                         device_unpack=True)
    (rec, bpp, bun), (jrec, jbpp, jbun) = got[0], jgot[0]
    assert bpp == jbpp
    assert [b.streams for b in bun] == [b.streams for b in jbun]
    np.testing.assert_allclose(rec, np.asarray(jrec), atol=1e-4)


def test_device_unpack_wire_bytes_are_compressed_size(codecs, images):
    """The flat upload follows the compressed payload, far below the host
    path's compact upload of the grids."""
    _, codec = codecs
    encs = codec.encode_batch(images[:2], *RATIOS[0], device_pack=True)
    flat, offs = codec._flat_stream_upload(encs)
    payload = sum(e.num_bytes for e in encs)
    grid_bytes = codec._compact_decode_input(
        encs, [np.zeros((16, 16), np.int64) for _ in encs]).nbytes
    # the payload, each stream's word padding and the guard, then the size
    # bucket (at least 1024 words)
    raw = payload + 4 * len(encs) * len(offs[0]) + 512
    assert flat.nbytes <= max(int(raw * 1.25) + 1024, 4096)
    assert raw + offs.nbytes < grid_bytes
    st = {}
    codec.decode_batch_device_async(encs, stats=st)
    assert st["b_h2d_bytes"] == flat.nbytes + offs.nbytes


def test_unpack_programs_replay_under_jax_keys(codecs, images, tiled_images):
    """Through the recorder backend (tests/test_torch_programs.py): the
    device receiver's programs sit under JAX's keys ('unpack', ...) and
    ('decu', ...), a second batch of the same shapes replays them, and the
    replays equal the eager results."""
    jcodec, codec = codecs
    rec = CGICCodec(codec.model, _counts(), device="cpu")
    rec._programs.backend = Recorder()
    encs_a = codec.encode_batch(images[:2], *RATIOS[0], device_pack=True)
    encs_b = codec.encode_batch(images[1:], *RATIOS[0], device_pack=True)
    rec.decode_batch(encs_a, device_unpack=True)
    replays = rec._programs.backend.replays
    got = rec.decode_batch(encs_b, device_unpack=True)
    assert rec._programs.backend.replays == replays + 1
    np.testing.assert_allclose(
        got, codec.decode_batch(encs_b, device_unpack=True), atol=0)
    jcodec.decode_batch(encs_b, device_unpack=True)
    assert {k[0] for k in rec._decode_fns} <= set(jcodec._decode_fns)
    tiling.compress_tiled_device(rec, tiled_images[:1] * 2, *RATIOS[0],
                                 tile=TILE, threads=False,
                                 device_unpack=True)
    assert {k[0][0] for k in rec._tile_fns} == {"enc", "decu"}
    assert rec._programs.backend.replays > replays + 1
    decu = [k[0] for k in rec._tile_fns if k[0][0] == "decu"]
    assert all(k[1] == 0 and k[-2:] == (True, "scan") for k in decu)
