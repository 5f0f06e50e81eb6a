"""The port's codec against the JAX package's: stream files byte-identical
in all 7 modes given the same weights and counts, reconstructions within
f32 tolerance, and the Huffman and bitmap frames byte-identical to the JAX
package's coders."""
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from control_gic_tpu.codec import CGICCodec as JCodec
from control_gic_tpu.coding import BitmapCodec as JBitmap
from control_gic_tpu.coding import HuffmanCodec as JHuffman
from control_gic_tpu.models import CGIC as JCGIC
from control_gic_tpu.models import CGICConfig as JConfig
from control_gic_tpu_torch.codec import (MODE_STREAMS, STREAM_FILES,
                                         CGICCodec, CorruptStreamError,
                                         EncodedImage)
from control_gic_tpu_torch.coding import BitmapCodec, HuffmanCodec
from control_gic_tpu_torch.models import CGIC, CGICConfig
from control_gic_tpu_torch.utils.from_jax import state_dict_from_flax

torch.set_num_threads(2)

SMALL = dict(n_embed=32, embed_dim=4, z_channels=4, ch=32,
             ch_mult=(1, 1, 2, 2, 2), num_res_blocks=1,
             attn_resolutions=(8,), resolution=64)
RATIOS = [(0.1, 0.4), (0.0, 0.8), (0.3, 0.0), (0.5, 0.5),
          (1.0, 0.0), (0.0, 1.0), (0.0, 0.0)]


@pytest.fixture(scope="module")
def codecs():
    """(JAX codec, the port's codec on the CPU), same weights and counts."""
    jmodel = JCGIC(JConfig(**SMALL))
    variables = jmodel.init(jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 3)), 0.1, 0.4)
    counts = np.random.default_rng(7).integers(0, 1000, size=SMALL["n_embed"])
    model = CGIC(CGICConfig(**SMALL))
    model.load_state_dict(state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, variables["params"])), strict=True)
    jdecode = jax.jit(lambda v, i, m: jmodel.apply(
        v, i, m, method=JCGIC.decode_indices))
    return (JCodec(jmodel, variables, counts),
            CGICCodec(model, counts, device="cpu"), jdecode)


@pytest.fixture(scope="module")
def image():
    return np.random.default_rng(21).uniform(0, 1, (64, 64, 3)).astype(
        np.float32)


def _files(d):
    return {f: open(os.path.join(d, f), "rb").read()
            for f in sorted(os.listdir(d))}


@pytest.mark.parametrize("mode", range(7))
def test_stream_files_byte_identical(codecs, image, mode, tmp_path):
    jcodec, codec, jdecode = codecs
    rc, rm = RATIOS[mode]
    rec, bpp, enc = codec.compress(image, rc, rm,
                                   out_dir=str(tmp_path / "port"))
    jenc = jcodec.encode(image, rc, rm)
    jenc.write(str(tmp_path / "jax"))
    assert enc.mode == jenc.mode == mode
    assert sorted(enc.streams) == sorted(MODE_STREAMS[mode])
    files = _files(tmp_path / "port")
    assert files == _files(tmp_path / "jax")
    assert set(files) == {STREAM_FILES[n] for n in MODE_STREAMS[mode]}
    assert bpp == pytest.approx(sum(map(len, files.values())) * 8 / 64 ** 2)
    assert bpp > 0

    # the receivers rebuild the same grids from the same files
    ind, masks = codec._rebuild(enc)
    jind, jmasks = jcodec._rebuild(jenc)
    np.testing.assert_array_equal(ind, jind)
    for a, b in zip(masks, jmasks):
        np.testing.assert_array_equal(a, b)
    want = np.asarray(jdecode(jcodec.variables, jnp.asarray(jind)[None],
                              tuple(jnp.asarray(m)[None] for m in jmasks)))
    np.testing.assert_allclose(rec, want[0], atol=1e-4)

    # receiver only: a fresh read of the files decodes to the same image
    enc2 = EncodedImage.read(str(tmp_path / "port"), enc.mode, enc.latent_hw,
                             enc.image_hw)
    np.testing.assert_array_equal(codec.decode(enc2), rec)


def test_encode_batch_equals_solo_encodes(codecs):
    _, codec, _ = codecs
    imgs = np.random.default_rng(3).uniform(0, 1, (3, 64, 64, 3)).astype(
        np.float32)
    batch = codec.encode_batch(imgs, 0.1, 0.4)
    for img, enc in zip(imgs, batch):
        assert enc.streams == codec.encode(img, 0.1, 0.4).streams
    recs = codec.decode_batch(batch)
    assert recs.shape == (3, 64, 64, 3) and np.isfinite(recs).all()


def test_corrupt_stream_raises(codecs, image):
    _, codec, _ = codecs
    enc = codec.encode(image, 0.1, 0.4)
    streams = dict(enc.streams)
    streams["indices_fine"] = codec.huffman.encode([0, 1, 2])
    bad = EncodedImage(enc.mode, enc.latent_hw, enc.image_hw, streams)
    with pytest.raises(CorruptStreamError):
        codec.decode(bad)


def test_codec_rejects_bad_input(codecs, image):
    _, codec, _ = codecs
    with pytest.raises(ValueError, match="multiple of 16"):
        codec.encode(image[:40], 0.1, 0.4)
    with pytest.raises(ValueError, match="same-mode"):
        codec.decode_batch([codec.encode(image, 0.1, 0.4),
                            codec.encode(image, 0.0, 0.0)])


def test_codec_refuses_missing_cuda(codecs):
    _, codec, _ = codecs
    if torch.cuda.is_available():
        pytest.skip("CUDA is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        CGICCodec(codec.model, np.ones(SMALL["n_embed"]))


# ---------------------------------------------------------------- coders

def _freqs(rng, n=1024):
    return {i: int(c) for i, c in enumerate(rng.integers(0, 500, size=n))}


@pytest.mark.parametrize("seed", [0, 1])
def test_huffman_frames_identical(seed):
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 50, size=1024)
    ours, theirs = HuffmanCodec.from_counts(counts), JHuffman.from_counts(counts)
    assert ours.codes == theirs.codes
    freqs = _freqs(rng)
    assert HuffmanCodec(freqs).codes == JHuffman(freqs).codes
    for n in (0, 1, 7, 8, 9, 4096):
        syms = rng.integers(0, 1024, size=n)
        data = ours.encode(syms)
        assert data == theirs.encode(syms)
        if n == 0:
            assert data == b"" and ours.decode(data) is None
        else:
            assert ours.decode(data) == syms.tolist() == theirs.decode(data)


def test_from_counts_keeps_lexicographic_order():
    # heavy ties: heap insertion order decides the tree
    counts = np.random.default_rng(5).integers(1, 4, size=256)
    ours = HuffmanCodec.from_counts(counts)
    numeric = HuffmanCodec({i: int(c) for i, c in enumerate(counts)})
    assert ours.codes == JHuffman.from_counts(counts).codes
    assert ours.codes != numeric.codes


def test_zero_tail_table_codes_beyond_256_bits():
    counts = np.zeros(1024, np.int64)
    counts[:40] = np.arange(1, 41)
    ours, theirs = HuffmanCodec.from_counts(counts), JHuffman.from_counts(counts)
    assert max(len(c) for c in ours.codes.values()) > 256
    assert ours.codes == theirs.codes
    rare = max(ours.codes, key=lambda s: len(ours.codes[s]))
    syms = np.asarray([0, 5, 39, 1, rare, 39, 0, rare], np.int64)
    data = ours.encode(syms)
    assert data == theirs.encode(syms)
    assert ours.decode(data) == syms.tolist()


@pytest.mark.parametrize("n", [0, 1, 8, 13, 256, 1024])
def test_bitmap_frames_identical(n):
    bits = np.random.default_rng(n).integers(0, 2, size=n)
    data = BitmapCodec().encode(bits)
    assert data == JBitmap().encode(bits)
    if n == 0:
        assert data == b"" and BitmapCodec().decode(data) is None
    else:
        assert BitmapCodec().decode(data) == bits.tolist()


@pytest.mark.parametrize("batch", [1, 2])
def test_infer_cli_writes_streams_pngs_and_bpp(codecs, tmp_path, monkeypatch,
                                               batch):
    from PIL import Image

    import control_gic_tpu_torch.cli.infer as infer
    from control_gic_tpu_torch.data import EvalImageDataset

    _, codec, _ = codecs
    src = tmp_path / "imgs"
    src.mkdir()
    rng = np.random.default_rng(9)
    for i, (h, w) in enumerate([(70, 64), (64, 64), (64, 66)]):
        Image.fromarray(rng.integers(0, 256, (h, w, 3), np.uint8)).save(
            src / f"{i}.png")
    assert [im.shape for im in EvalImageDataset(str(src))] == [(64, 64, 3)] * 3
    monkeypatch.setattr(infer, "build_codec",
                        lambda ckpt, device, use_ema: codec)
    out = tmp_path / "out"
    infer.main(["-i", str(src), "-o", str(out), "--device", "cpu",
                "--batch", str(batch)])
    lines = (out / "bpp.txt").read_text().splitlines()
    assert len(lines) == 4 and lines[-1].startswith("average: bpp=")
    assert len(list(out.glob("*.png"))) == 3
    assert sorted(os.listdir(out / "streams")) == sorted(
        STREAM_FILES[n] for n in MODE_STREAMS[0])
    # each bpp equals a solo compress of the same image
    img = EvalImageDataset(str(src))[0]
    assert f"bpp={codec.encode(img, 0.1, 0.4).bpp:.5f}" in lines[0]
