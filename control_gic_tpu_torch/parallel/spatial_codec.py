"""The H-sharded single-pass codec: sharded encode -> entropy-coded streams
-> sharded decode (port of control_gic_tpu/parallel/spatial_codec.py).

The alternative to the tiled codec (parallel/tiling.py) for one large
image: one routing decision over the whole image (the tiled codec applies
its ratios per tile), no tile seams, the height sharded over the mesh's
devices all the way. The streams have the single-device codec's format,
and either receiver decodes them.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..codec import CGICCodec, EncodedImage
from ..ops.quantize import codebook_gather
from ..ops.router import mode_from_ratios
from .spatial_decoder import decode_spatial_sharded
from .spatial_encoder import encode_spatial_sharded
from .tiling import compute_padding


def compress_spatial(codec: CGICCodec, image: np.ndarray,
                     coarse_ratio: float, medium_ratio: float, mesh,
                     axis: str = "data"
                     ) -> Tuple[np.ndarray, float, EncodedImage]:
    """Single-pass sharded compress of [H, W, 3] in [0, 1]. Any size is
    center zero-padded to H % (64 * n_shards) == 0 and W % 16 == 0 (the
    sharded encoder's alignment) and the reconstruction unpadded; bpp is
    over the original pixels (the padding's bits are in the stream, like
    the reference's padded tiles). The streams are coded on the host
    (`CGICCodec.streams_from_arrays`). Returns (reconstruction, bpp,
    bundle)."""
    n = mesh.shape[axis]
    h0, w0, _ = image.shape
    (pl, pr, _, _), _ = compute_padding(h0, w0, min_div=16)
    (_, _, pt, pb), _ = compute_padding(h0, w0, min_div=64 * n)
    if pl or pr or pt or pb:
        image = np.pad(image, ((pt, pb), (pl, pr), (0, 0)))
    h, w, _ = image.shape
    model = codec.model

    x = codec._to_input(image[None].astype(np.float32))
    idx, masks = encode_spatial_sharded(
        mesh, model.encoder, model.quant_conv, model.codebook, x,
        coarse_ratio, medium_ratio, axis=axis,
        patch_sizes=model.config.entropy_patch_sizes)
    idx, m_c, m_m, m_f = (t[0].cpu().numpy() for t in (idx, *masks))
    encoded = codec.streams_from_arrays(
        idx, m_c, m_m, m_f, mode_from_ratios(coarse_ratio, medium_ratio),
        (h, w))

    rec = decode_spatial(codec, encoded, mesh, axis=axis)
    rec = rec[pt:h - pb if pb else h, pl:w - pr if pr else w]
    return rec, encoded.num_bytes * 8 / (h0 * w0), encoded


@torch.no_grad()
def decode_spatial(codec: CGICCodec, encoded: EncodedImage, mesh,
                   axis: str = "data") -> np.ndarray:
    """Receiver-side sharded decode of a bundle: [H, W, 3] float32."""
    model = codec.model
    dt = model.config.compute_dtype
    ind, masks = codec._rebuild(encoded)
    dev = codec.device
    zq = codebook_gather(torch.from_numpy(ind)[None].to(dev),
                         model.codebook).to(dt)
    # post_quant_conv is 1x1: local everywhere, applied before sharding
    z = model.post_quant_conv(zq)
    rec = decode_spatial_sharded(
        mesh, model.decoder, z, zq,
        [torch.from_numpy(m)[None].to(dev) for m in masks], axis=axis)
    return rec[0].float().permute(1, 2, 0).cpu().numpy()
