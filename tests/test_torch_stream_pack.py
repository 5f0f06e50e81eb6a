"""The port's device entropy packing (coding/huffman_device.py,
coding/stream_pack.py) and the receiver's frame helpers
(coding/huffman_decode_device.py, CGICCodec.split_compact_buf) against the
JAX package's, on the CPU: payload words, bit counts, compaction, fused
buffers, frames and the compact receiver's grids and masks, all exact."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from control_gic_tpu.codec import CGICCodec as JCodec
from control_gic_tpu.coding import HuffmanCodec as JHuffman
from control_gic_tpu.coding import huffman_decode_tpu as jdec
from control_gic_tpu.coding import huffman_tpu as jpack
from control_gic_tpu.coding import stream_pack as jsp
from control_gic_tpu_torch.codec import MODE_STREAMS, CGICCodec
from control_gic_tpu_torch.coding import BitmapCodec, HuffmanCodec
from control_gic_tpu_torch.coding import huffman_decode_device as tdec
from control_gic_tpu_torch.coding import huffman_device as tpack
from control_gic_tpu_torch.coding import stream_pack as tsp

torch.set_num_threads(2)


def _table(seed, n=1024):
    """All-positive counts: every code fits the 32-bit device packer."""
    counts = np.random.default_rng(seed).integers(1, 10_000, size=n)
    return HuffmanCodec.from_counts(counts), JHuffman.from_counts(counts)


@pytest.mark.parametrize("n, count", [(0, 0), (1, 1), (5, 5), (255, 200),
                                      (4096, 4096)])
def test_huffman_pack_bits_matches_jax(n, count):
    ours, theirs = _table(0)
    assert ours.codes == theirs.codes
    lens, words = tpack.pack_tables(ours.codes)
    jl, jw = jpack.pack_tables(theirs.codes)
    np.testing.assert_array_equal(lens, jl)
    np.testing.assert_array_equal(words, jw)
    syms = np.random.default_rng(n).integers(0, 1024, size=n).astype(
        np.int32)
    max_words = (n * int(lens.max()) + 31) // 32 + 2
    payload, bits = tpack.huffman_pack_bits(torch.from_numpy(syms), count,
                                            lens, words, max_words)
    jp, jb = jax.jit(jpack.huffman_pack_bits, static_argnames="max_words")(
        jnp.asarray(syms), jnp.int32(count), jnp.asarray(jl), jnp.asarray(jw),
        max_words=max_words)
    assert payload.dtype == torch.uint32 and bits.dtype == torch.int32
    np.testing.assert_array_equal(payload.numpy(), np.asarray(jp))
    assert int(bits) == int(jb)
    frame = tpack.frame_from_words(payload.numpy(), int(bits))
    assert frame == ours.encode(syms[:count])
    assert frame == jpack.frame_from_words(np.asarray(jp), int(jb))


def test_encode_on_device_matches_host_coder():
    ours, _ = _table(1)
    lens, words = tpack.pack_tables(ours.codes)
    rng = np.random.default_rng(1)
    for n in (0, 1, 8, 777):
        syms = rng.integers(0, 1024, size=n)
        assert tpack.encode_on_device(syms, lens, words,
                                      device="cpu") == ours.encode(syms)


def test_zero_heavy_table_is_refused():
    freqs = np.random.default_rng(2).integers(0, 10_000, size=1024)
    freqs[np.random.default_rng(3).random(1024) < 0.5] = 0
    ours = HuffmanCodec({i: int(f) for i, f in enumerate(freqs)})
    theirs = JHuffman({i: int(f) for i, f in enumerate(freqs)})
    assert max(len(c) for c in ours.codes.values()) > 32
    assert tpack.supports_table(ours.codes) is False
    assert jpack.supports_table(theirs.codes) is False
    with pytest.raises(ValueError, match="at most 32"):
        tpack.pack_tables(ours.codes)


def test_compact_masked_matches_jax():
    rng = np.random.default_rng(4)
    vals = rng.integers(0, 100, (3, 64)).astype(np.int32)
    mask = rng.integers(0, 2, (3, 64)).astype(np.int32)
    mask[1] = 0
    mask[2] = 1
    out, count = tsp.compact_masked(torch.from_numpy(vals),
                                    torch.from_numpy(mask))
    jout, jcount = jax.jit(jsp.compact_masked)(jnp.asarray(vals),
                                               jnp.asarray(mask))
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    np.testing.assert_array_equal(count.numpy(), np.asarray(jcount))
    for i in range(3):
        np.testing.assert_array_equal(out[i, :count[i]].numpy(),
                                      vals[i][mask[i] == 1])


def _grids(rng, b=2, hl=8, wl=16, n_sym=16):
    ind = rng.integers(0, n_sym, (b, hl, wl)).astype(np.int32)
    m_c = rng.integers(0, 2, (b, hl // 4, wl // 4)).astype(np.int32)
    m_m = (1 - m_c.repeat(2, 1).repeat(2, 2)) * rng.integers(
        0, 2, (b, hl // 2, wl // 2)).astype(np.int32)
    m_f = 1 - m_m.repeat(2, 1).repeat(2, 2) - m_c.repeat(4, 1).repeat(4, 2)
    return ind, (m_c, m_m, m_f)


@pytest.mark.parametrize("mode", range(7))
def test_pack_fuse_frames_match_jax(mode):
    rng = np.random.default_rng(10 + mode)
    counts = rng.integers(1, 500, size=16)
    huff = HuffmanCodec.from_counts(counts)
    lens, words = tpack.pack_tables(huff.codes)
    ind, masks = _grids(rng)
    mcl = int(lens.max())
    packed = tsp.pack_streams_batch(
        torch.from_numpy(ind), tuple(map(torch.from_numpy, masks)), mode,
        lens, words, mcl)
    jpacked = jax.jit(lambda i, m: jsp.pack_streams_batch(
        i, m, mode, lens, words, mcl))(jnp.asarray(ind),
                                      tuple(map(jnp.asarray, masks)))
    assert sorted(packed) == sorted(jpacked) == sorted(MODE_STREAMS[mode])
    for name in packed:
        np.testing.assert_array_equal(packed[name][0].numpy(),
                                      np.asarray(jpacked[name][0]))
        np.testing.assert_array_equal(packed[name][1].numpy(),
                                      np.asarray(jpacked[name][1]))
    buf = tsp.fuse_packed(packed, mode).numpy()
    jbuf = np.asarray(jax.jit(lambda p: jsp.fuse_packed(p, mode))(jpacked))
    assert buf.dtype == np.uint32
    np.testing.assert_array_equal(buf, jbuf)
    layout = tsp.fused_layout(mode, 8, 16, mcl)
    assert layout == jsp.fused_layout(mode, 8, 16, mcl)
    host = {k: (v[0].numpy(), v[1].numpy()) for k, v in packed.items()}
    bitmap = BitmapCodec()
    for i in range(ind.shape[0]):
        frames = tsp.fused_to_bytes(buf, layout, i)
        assert frames == jsp.fused_to_bytes(jbuf, layout, i)
        assert frames == tsp.streams_to_bytes(host, i)
        # and the frames are the host coders' bytes
        m_c, m_m, m_f = (m[i] for m in masks)
        want = {"indices_coarse": huff.encode(
                    ind[i, ::4, ::4][m_c == 1] if mode != 4
                    else ind[i, ::4, ::4]),
                "indices_medium": huff.encode(
                    ind[i, ::2, ::2][m_m == 1] if mode != 5
                    else ind[i, ::2, ::2]),
                "indices_fine": huff.encode(ind[i][m_f == 1] if mode != 6
                                            else ind[i]),
                "mask_coarse": bitmap.encode(m_c.reshape(-1)),
                "mask_medium": bitmap.encode(m_m.reshape(-1))}
        assert frames == {k: want[k] for k in MODE_STREAMS[mode]}


def test_frame_helpers_match_jax():
    rng = np.random.default_rng(5)
    for n in (0, 1, 8, 31, 32, 33, 100):
        bits = rng.integers(0, 2, size=n)
        frame = BitmapCodec().encode(bits)
        words, total = tdec.frame_body_words(frame)
        jwords, jtotal = jdec.frame_body_words(frame)
        np.testing.assert_array_equal(words, jwords)
        assert total == jtotal == n
        cap = (n + 8 + 31) // 32
        w, _ = tdec.words_from_frame(frame, cap)
        np.testing.assert_array_equal(w, jdec.words_from_frame(frame, cap)[0])
        if n:
            got = tdec.bitmap_decode_bits(torch.from_numpy(w.view(np.int32)),
                                          n)
            np.testing.assert_array_equal(got.numpy(), bits)
            np.testing.assert_array_equal(
                got.numpy(), np.asarray(jdec.bitmap_decode_bits(
                    jnp.asarray(w), n)))
    with pytest.raises(ValueError, match="capacity"):
        tdec.words_from_frame(BitmapCodec().encode(np.ones(100)), 2)


@pytest.mark.parametrize("mode", range(7))
def test_split_compact_buf_matches_jax(mode):
    """The same compact buffer (uint16 grid + mask frame words) through the
    port's split (int16 upload, int32 view of each pair) and JAX's
    (bitcast of uint16 pairs to uint32)."""
    rng = np.random.default_rng(20 + mode)
    b, hl, wl = 2, 8, 16
    wcw, wmw = CGICCodec._mask_word_caps(hl, wl)
    assert (wcw, wmw) == JCodec._mask_word_caps(hl, wl)
    rows = []
    for _ in range(b):
        parts = [rng.integers(0, 65536, hl * wl).astype(np.uint16)]
        if "mask_coarse" in MODE_STREAMS[mode]:
            frame = BitmapCodec().encode(rng.integers(0, 2, hl * wl // 16))
            parts.append(tdec.words_from_frame(frame, wcw)[0].view(np.uint16))
        if "mask_medium" in MODE_STREAMS[mode]:
            frame = BitmapCodec().encode(rng.integers(0, 2, hl * wl // 4))
            parts.append(tdec.words_from_frame(frame, wmw)[0].view(np.uint16))
        rows.append(np.concatenate(parts))
    buf = np.stack(rows)
    ind, masks = CGICCodec.split_compact_buf(
        torch.from_numpy(buf.view(np.int16)), mode, hl, wl)
    jind, jmasks = jax.jit(lambda x: JCodec.split_compact_buf(
        x, mode, hl, wl))(jnp.asarray(buf))
    np.testing.assert_array_equal(ind.numpy(), np.asarray(jind))
    assert ind.dtype == torch.int64
    for m, jm in zip(masks, jmasks):
        assert m.dtype == torch.int32
        np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
