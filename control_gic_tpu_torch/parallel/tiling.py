"""High-resolution tiled codec: pad -> tile -> batched per-tile codec ->
stitch (port of control_gic_tpu/parallel/tiling.py).

  - center zero-pad to a /16-divisible size (`compute_padding`);
  - a non-overlapping grid of `tile`-px tiles plus remainder tiles
    (`tile_grid`), or with overlap > 0 equal-size tiles at stride
    tile - overlap, blended with the reference's Gaussian window
    (`overlapping_tile_grid`, `gaussian_tile_weights`);
  - every tile compressed independently; tiles of one shape go through
    `CGICCodec.encode_batch` / `decode_batch` as one batch, whose per-sample
    routing keeps each tile's streams equal to a solo encode;
  - bpp = the bits of all tiles / the original (unpadded) pixel count.
Three schedules give the same streams: `compress_tiled` (one image, tile
group after tile group), `compress_tiled_many` (many images, software-
pipelined across groups and images) and `compress_tiled_device` (the tiled
CLI's default: one upload and one download per image, tiles sliced and
stitched on the device, streams packed there, images overlapped across the
host entropy stage by the codec's own three-stage runner,
`pipeline.run_stages`, and framed and received through the codec's own
halves; device_unpack=True decodes the streams on the device as well).

The tile mesh (`mesh=` of compress_tiled and compress_tiled_many): a tile
group's batch is split over the mesh's devices when it divides by their
number (JAX's rule), else it runs unsharded; each chunk runs on a replica of
the codec on its device (`codec_replica`), all chunks dispatched before any
is fetched. Per-sample routing keeps the streams byte-identical to those
of the same tiles encoded at the chunk's batch size. They equal mesh=None's
on the CPU; on a card the batch size can change the order of some sums
(the flash forward's key splits, a convolution algorithm), so a chunk may
round otherwise than the whole group and flip a near-tie index.
"""
from __future__ import annotations

import copy
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..codec import CGICCodec, EncodedImage, unpack_impl
from ..ops.router import mode_from_ratios
from ..pipeline import _Fetch, run_stages
from ..utils.trace import span
from .mesh import replica, same_device

def codec_replica(codec: CGICCodec, device: torch.device) -> CGICCodec:
    """The codec on `device`: itself on its own device, else a copy of its
    model and tables there (graphs as the codec's), made at the first call
    and again after the codec's weights change (`mesh.replica`)."""
    if same_device(device, codec.device):
        return codec
    return replica(codec, device, codec.model, lambda d: CGICCodec(
        copy.deepcopy(codec.model), codec.counts, device=d,
        graphs=None if codec._programs.backend is not None else False))


def _mesh_codecs(codec: CGICCodec, mesh, n: int) -> List[CGICCodec]:
    """The codecs that take a batch of n: one per device of the mesh when n
    divides by their number (JAX's rule), else the codec alone."""
    if mesh is None or n % mesh.size:
        return [codec]
    return [codec_replica(codec, d) for d in mesh.devices.flat]


def _encode_async(codecs, batch: np.ndarray, rc: float, rm: float,
                  device_pack: bool) -> list:
    """Each codec's chunk of the batch dispatched: [(codec, pending)]."""
    return [(c, c.encode_batch_async(chunk, rc, rm, device_pack=device_pack))
            for c, chunk in zip(codecs, np.split(batch, len(codecs)))]


def _encode_finish(pends: list) -> List[EncodedImage]:
    return [e for c, p in pends for e in c.encode_finish(p)]


def _decode_async(codecs, encs: List[EncodedImage]) -> List[_Fetch]:
    """Each codec's chunk of the bundles decoded, dispatched; a fetch of
    each chunk (on its device's stream)."""
    k = len(encs) // len(codecs)
    return [_Fetch(c.decode_batch_async(encs[i * k:(i + 1) * k]))
            for i, c in enumerate(codecs)]


def _fetch_recs(fetches: List[_Fetch]) -> np.ndarray:
    return np.concatenate([f.arrays()[0] for f in fetches])


def compute_padding(h: int, w: int, min_div: int = 16
                    ) -> Tuple[Tuple[int, int, int, int],
                               Tuple[int, int, int, int]]:
    """(left, right, top, bottom) center padding to /min_div, + unpad."""
    out_h = (h + min_div - 1) // min_div * min_div
    out_w = (w + min_div - 1) // min_div * min_div
    left = (out_w - w) // 2
    right = out_w - w - left
    top = (out_h - h) // 2
    bottom = out_h - h - top
    return (left, right, top, bottom), (-left, -right, -top, -bottom)


def tile_grid(h: int, w: int, tile: int) -> List[Tuple[int, int, int, int]]:
    """(y, x, th, tw) of `tile`-px tiles plus remainder tiles covering
    [h, w], row-major (the reference's grid)."""
    return [(y, x, min(tile, h - y), min(tile, w - x))
            for y in range(0, h, tile) for x in range(0, w, tile)]


def overlapping_tile_grid(h: int, w: int, tile: int, overlap: int
                          ) -> List[Tuple[int, int, int, int]]:
    """Equal-size tiles at stride tile - overlap, the last one snapped to
    the border; one tile along a dim no larger than `tile`."""
    def starts(dim):
        if dim <= tile:
            return [0]
        s = list(range(0, dim - tile + 1, tile - overlap))
        if s[-1] != dim - tile:
            s.append(dim - tile)
        return s

    return [(y, x, min(tile, h - y), min(tile, w - x))
            for y in starts(h) for x in starts(w)]


def gaussian_tile_weights(th: int, tw: int) -> np.ndarray:
    """Per-pixel blending weights of an overlapped tile (the reference's
    _gaussian_weights: variance 0.01 over the relative position), [th, tw]
    float32."""
    var = 0.01
    mid_w = (tw - 1) / 2
    xp = np.exp(-((np.arange(tw) - mid_w) ** 2) / (tw * tw) / (2 * var)) \
        / np.sqrt(2 * np.pi * var)
    mid_h = th / 2
    yp = np.exp(-((np.arange(th) - mid_h) ** 2) / (th * th) / (2 * var)) \
        / np.sqrt(2 * np.pi * var)
    return np.outer(yp, xp).astype(np.float32)


def compress_tiled(codec: CGICCodec, image: np.ndarray, coarse_ratio: float,
                   medium_ratio: float, tile: int = 768, overlap: int = 0,
                   mesh=None, device_pack: bool = False
                   ) -> Tuple[np.ndarray, float, List[EncodedImage]]:
    """Compress an image of any size as independent tiles.

    image: [H, W, 3] in [0, 1]. overlap 0 is the reference's
    non-overlapping grid; a multiple of 16 above 0 overlaps the tiles and
    blends them with the Gaussian window (seams gone, more bits).
    device_pack=True packs the tiles' streams on the device (byte-identical).
    mesh (parallel.mesh.Mesh): tile groups whose batch divides over its
    devices are split across them (streams as at the chunk's batch size;
    see the module docstring).

    Returns (reconstruction [H, W, 3] float32, bpp over the original pixels,
    the tiles' bundles in grid order).
    """
    if overlap % 16 or not 0 <= overlap < tile:
        raise ValueError(f"overlap must be a multiple of 16 in [0, {tile}), "
                         f"got {overlap}")
    h0, w0, _ = image.shape
    (pl, pr, pt, pb), _ = compute_padding(h0, w0)
    padded = np.pad(image, ((pt, pb), (pl, pr), (0, 0)))
    h, w, _ = padded.shape

    tiles = (tile_grid(h, w, tile) if overlap == 0
             else overlapping_tile_grid(h, w, tile, overlap))
    # group by shape so each group runs as one batch; every tile is /16,
    # as h, w are and tile boundaries fall on multiples of 16
    groups: Dict[Tuple[int, int], List[int]] = defaultdict(list)
    for i, (_, _, th, tw) in enumerate(tiles):
        groups[(th, tw)].append(i)

    recon = np.zeros(padded.shape, np.float32)
    weight = np.zeros(padded.shape[:2] + (1,), np.float32)
    bundles: List[Optional[EncodedImage]] = [None] * len(tiles)
    total_bits = 0.0
    for (th, tw), idxs in groups.items():
        batch = np.stack([padded[tiles[i][0]:tiles[i][0] + th,
                                 tiles[i][1]:tiles[i][1] + tw] for i in idxs])
        codecs = _mesh_codecs(codec, mesh, len(idxs))
        encs = _encode_finish(_encode_async(codecs, batch, coarse_ratio,
                                            medium_ratio, device_pack))
        recs = _fetch_recs(_decode_async(codecs, encs))
        wt = (gaussian_tile_weights(th, tw)[..., None] if overlap
              else np.ones((th, tw, 1), np.float32))
        for j, i in enumerate(idxs):
            y, x, _, _ = tiles[i]
            recon[y:y + th, x:x + tw] += recs[j] * wt
            weight[y:y + th, x:x + tw] += wt
            bundles[i] = encs[j]
            total_bits += encs[j].num_bytes * 8

    recon = recon / np.maximum(weight, 1e-12)
    recon = recon[pt:h - pb if pb else h, pl:w - pr if pr else w]
    return recon, total_bits / (h0 * w0), bundles


@torch.no_grad()
def _encode_tiles(codec: CGICCodec, image: torch.Tensor, rc: float,
                  rm: float, offsets: tuple, th: int, tw: int
                  ) -> torch.Tensor:
    """The tile encode program: image [H, W, 3] on the device (uint8 or
    float) -> the fused packed stream buffer of the tiles at `offsets`,
    sliced on the device, so that the image crosses to the device once, not
    once per tile group."""
    if codec._device_tables is None:
        raise ValueError(
            "compress_tiled_device needs a Huffman table the device "
            "packer takes (codes <= 32 bits); use compress_tiled() or "
            "compress_tiled_many() for this codec")

    def fn(image):
        tiles = torch.stack([image[y:y + th, x:x + tw] for y, x in offsets])
        return codec._encode_pack_fn(codec._input_from_device(tiles), rc, rm,
                                     per_sample=True)

    return codec._programs.run(codec._tile_fns,
                               ("enc", rc, rm, offsets, th, tw), fn, image)


@torch.no_grad()
def _decode_stitch(codec: CGICCodec, canvas: torch.Tensor, buf: torch.Tensor,
                   mode: int, offsets: tuple, th: int, tw: int,
                   out_uint8: bool) -> torch.Tensor:
    """The decode + stitch program: (canvas [H, W, 3] on the device, compact
    receiver buffer) -> the canvas with the decoded tiles written at
    `offsets`, so that the reconstruction crosses to the host once per
    image. The upload is the compact uint16 + bitmap buffer
    (CGICCodec.split_compact_buf).

    JAX donates the canvas to its program. A captured graph bakes in the
    address of every buffer it writes, so the canvas is a static input
    here: a replay copies the caller's canvas in and returns a clone of the
    stitched one (two copies of the canvas a tile group, against one copy
    of each tile were the stitch outside the graph), and the stitch stays
    inside the program, one program a tile group as in JAX. Eagerly the
    canvas is written in place and returned."""
    hl, wl = th // 4, tw // 4

    def fn(canvas, buf):
        rec = codec._decode_fused_fn(buf, mode, hl, wl, out_uint8)
        for j, (y, x) in enumerate(offsets):
            canvas[y:y + th, x:x + tw] = rec[j]
        return canvas

    return codec._programs.run(codec._tile_fns,
                               ("dec", mode, offsets, th, tw, out_uint8), fn,
                               canvas, buf)


@torch.no_grad()
def _decode_stitch_unpack(codec: CGICCodec, canvas: torch.Tensor,
                          flat: torch.Tensor, offs: torch.Tensor, mode: int,
                          offsets: tuple, th: int, tw: int,
                          out_uint8: bool) -> torch.Tensor:
    """The device-unpack decode + stitch program: (canvas, flat stream
    words, word-offset table) -> the canvas with the tiles decoded ON the
    device (Huffman decode and grid rebuild, codec.make_rebuild_batch)
    written at `offsets`; the receiver's upload is the compressed payload.
    The canvas is a static input, as in _decode_stitch."""
    impl = unpack_impl()
    luts = codec._decode_luts_on_device()

    def fn(canvas, flat, offs):
        rec = codec._decode_unpack_fn(flat, offs, luts, mode, th // 4,
                                      tw // 4, out_uint8, impl)
        for j, (y, x) in enumerate(offsets):
            canvas[y:y + th, x:x + tw] = rec[j]
        return canvas

    return codec._programs.run(
        codec._tile_fns, ("decu", mode, offsets, th, tw, out_uint8, impl),
        fn, canvas, flat, offs)


def compress_tiled_device(codec: CGICCodec, images, coarse_ratio: float,
                          medium_ratio: float, tile: int = 768,
                          out_uint8: bool = True, threads: bool = True,
                          device_unpack: Optional[bool] = None
                          ) -> List[Tuple[np.ndarray, float,
                                          List[EncodedImage]]]:
    """Wire-minimal tiled codec over a sequence of images.

    Per image, two large transfers cross between host and device: the
    source image up (uint8 when given uint8) and the stitched
    reconstruction down (uint8 with out_uint8), plus the few-KB packed
    streams. Tiles are sliced and stitched on the device; the host runs
    only the entropy stage, in three stages an image
    (pipeline.run_stages): a uploads and dispatches every tile group's
    encode and pack, b fetches the packed words, frames and rebuilds, and
    dispatches each group's decode and stitch, c fetches the canvas. With
    threads, a runs on this thread and b and c on a worker each, with
    queues of one image between them, so the stages overlap across
    images.

    Streams and bpp equal compress_tiled(overlap=0)'s; the reconstruction
    differs only by the uint8 quantization (clip, * 255, truncate, as
    cli.common.save_png) with out_uint8=True. Each stage's work on an image
    is a span (cgic.pipe.a, .b, .c; utils/trace.py) of the call's root
    span, cgic.tiling.compress: a profiler trace shows the stages' timeline,
    one lane a thread.

    device_unpack=True decodes the streams on the device
    (codec.decode_batch's device_unpack): the receiver's upload shrinks from
    the compact grids to the compressed payload, pixel-identical. The
    default (None) is the host receiver, as in JAX; a table the device
    cannot decode raises.

    Returns [(reconstruction, bpp, bundles), ...] in input order; the stage
    seconds and bytes land in codec.last_pipeline_stats."""
    if tile % 16:
        raise ValueError(f"tile must be a multiple of 16, got {tile}")
    if device_unpack is None:
        device_unpack = False
    if device_unpack and codec._decode_tables is None:
        raise ValueError("device_unpack=True needs a device-decodable "
                         "Huffman table (code lengths in [1, MAX_LUT_BITS])")
    stats = defaultdict(float)   # each stage writes its own keys
    stats["device_unpack"] = float(device_unpack)
    root = span("cgic.tiling.compress", stats, "wall_s")

    def stage_a(i):
        """The image up once; every tile group's encode + pack dispatched,
        its fetch enqueued behind it."""
        with span("cgic.pipe.a", stats, "a_upload_s", parent=root, batch=i,
                  bytes=images[i].nbytes):
            (pt, pb, pl, pr), _, _, groups, _ = plans[i]
            img_dev = codec._upload(np.pad(images[i], ((pt, pb), (pl, pr),
                                                       (0, 0))))
            bufs = []
            for (th, tw), tyx in groups.items():
                offs = tuple((y, x) for _, y, x in tyx)
                bufs.append(((th, tw), tyx, offs, _Fetch(_encode_tiles(
                    codec, img_dev, rc, rm, offs, th, tw))))
        stats["a_upload_bytes"] += images[i].nbytes
        return bufs

    def stage_b(i, bufs):
        """Fetch the packed words, frame and rebuild on the host, dispatch
        each group's decode + stitch into the canvas."""
        with span("cgic.pipe.b", parent=root, batch=i):
            (pt, pb, pl, pr), h0, w0, _, n_tiles = plans[i]
            canvas = torch.zeros((h0 + pt + pb, w0 + pl + pr, 3),
                                 device=codec.device,
                                 dtype=torch.uint8 if out_uint8
                                 else torch.float32)
            bundles: List[Optional[EncodedImage]] = [None] * n_tiles
            for (th, tw), tyx, offs, fetch in bufs:
                # "encode still computing" apart from the copy
                fetch.sync(stats, "b_sync_s")
                buf = fetch.arrays(stats, "b_fetch_s")[0]
                stats["b_fetch_bytes"] += buf.nbytes
                with span("cgic.coding.rebuild", stats, "b_rebuild_s",
                          images=len(offs)):
                    with span("cgic.coding.frame", bytes=buf.nbytes,
                              images=len(offs)):
                        encs = codec._frame_packed(buf, mode, (th, tw),
                                                   len(offs))
                    for (t, _, _), e in zip(tyx, encs):
                        bundles[t] = e
                    up = codec._receiver_input(encs, device_unpack)
                with span("cgic.codec.dispatch", stats, "b_h2d_dispatch_s"):
                    decode = (_decode_stitch_unpack if device_unpack
                              else _decode_stitch)
                    canvas = decode(codec, canvas,
                                    *[codec._upload(a) for a in up], mode,
                                    offs, th, tw, out_uint8)
                    stats["b_h2d_bytes"] += sum(a.nbytes for a in up)
            return bundles, _Fetch(canvas)

    def stage_c(i, b):
        """Fetch the stitched reconstruction, unpad, count the bits."""
        bundles, canvas = b
        with span("cgic.pipe.c", parent=root, batch=i):
            (pt, pb, pl, pr), h0, w0, _, _ = plans[i]
            # "decode still computing" apart from the copy
            canvas.sync(stats, "c_sync_s")
            rec = canvas.arrays(stats, "c_fetch_s")[0]
            stats["c_fetch_bytes"] += rec.nbytes
            h, w = rec.shape[:2]
            rec = rec[pt:h - pb if pb else h, pl:w - pr if pr else w]
            bits = sum(e.num_bytes * 8 for e in bundles)
            out[i] = (rec, bits / (h0 * w0), bundles)

    try:
        with root:
            images = list(images)
            n = len(images)
            root.attrs["images"] = n
            mode = mode_from_ratios(coarse_ratio, medium_ratio)
            rc, rm = float(coarse_ratio), float(medium_ratio)
            out: List[Optional[Tuple]] = [None] * n

            # the plan: each image's padding and its tile offsets by shape,
            # with the tile's index so that the bundles come back in grid
            # order
            plans = []
            for image in images:
                h0, w0, _ = image.shape
                (pl, pr, pt, pb), _ = compute_padding(h0, w0)
                tiles = tile_grid(h0 + pt + pb, w0 + pl + pr, tile)
                groups: Dict[Tuple[int, int],
                             List[Tuple[int, int, int]]] = defaultdict(list)
                for t, (y, x, th, tw) in enumerate(tiles):
                    groups[(th, tw)].append((t, y, x))
                plans.append(((pt, pb, pl, pr), h0, w0, dict(groups),
                              len(tiles)))

            run_stages(n, stage_a, stage_b, stage_c, root=root,
                       threads=threads, depth=1, stats=stats)
    finally:
        codec.last_pipeline_stats = dict(stats)
    return out


def compress_tiled_many(codec: CGICCodec, images, coarse_ratio: float,
                        medium_ratio: float, tile: int = 768,
                        mesh=None, device_pack: bool = False
                        ) -> List[Tuple[np.ndarray, float,
                                        List[EncodedImage]]]:
    """The tiled codec over a sequence of images, software-pipelined across
    tile-shape groups and images: while the host frames and rebuilds group
    k's streams, the device already encodes group k+1 (possibly of the next
    image), and group k-1's decode drains. Each image's result equals
    compress_tiled(overlap=0)'s: the same tile batches through the same
    calls. mesh: as in compress_tiled.

    Returns [(reconstruction, bpp, bundles), ...] in input order."""
    images = list(images)
    plans = []        # (padded, (pt, pb, pl, pr), h0, w0, tiles)
    jobs = []         # (image, (th, tw), tile indices)
    for i, image in enumerate(images):
        h0, w0, _ = image.shape
        (pl, pr, pt, pb), _ = compute_padding(h0, w0)
        padded = np.pad(image, ((pt, pb), (pl, pr), (0, 0)))
        tiles = tile_grid(padded.shape[0], padded.shape[1], tile)
        groups: Dict[Tuple[int, int], List[int]] = defaultdict(list)
        for j, (_, _, th, tw) in enumerate(tiles):
            groups[(th, tw)].append(j)
        plans.append((padded, (pt, pb, pl, pr), h0, w0, tiles))
        for key, idxs in groups.items():
            jobs.append((i, key, idxs))

    def dispatch(job):
        i, (th, tw), idxs = job
        padded, tiles = plans[i][0], plans[i][4]
        batch = np.stack([padded[tiles[j][0]:tiles[j][0] + th,
                                 tiles[j][1]:tiles[j][1] + tw]
                          for j in idxs])
        codecs = _mesh_codecs(codec, mesh, len(idxs))
        return codecs, _encode_async(codecs, batch, coarse_ratio,
                                     medium_ratio, device_pack)

    state = [(np.zeros(p[0].shape, np.float32), [None] * len(p[4]), [0.0])
             for p in plans]   # per image: canvas, bundles, bits

    def stitch(job, encs, rec):
        i, (th, tw), idxs = job
        recon, bundles, bits = state[i]
        tiles = plans[i][4]
        for j, t in enumerate(idxs):
            y, x, _, _ = tiles[t]
            recon[y:y + th, x:x + tw] = rec[j]
            bundles[t] = encs[j]
            bits[0] += encs[j].num_bytes * 8

    pend = None                  # (job, bundles, reconstruction's fetch)
    pend_e = dispatch(jobs[0]) if jobs else None
    for k, job in enumerate(jobs):
        nxt = dispatch(jobs[k + 1]) if k + 1 < len(jobs) else None
        codecs, pends = pend_e
        encs = _encode_finish(pends)
        if pend is not None:
            stitch(pend[0], pend[1], _fetch_recs(pend[2]))
        pend = (job, encs, _decode_async(codecs, encs))
        pend_e = nxt
    if pend is not None:
        stitch(pend[0], pend[1], _fetch_recs(pend[2]))

    out = []
    for (padded, (pt, pb, pl, pr), h0, w0, _), (recon, bundles, bits) in \
            zip(plans, state):
        h, w = padded.shape[:2]
        out.append((recon[pt:h - pb if pb else h, pl:w - pr if pr else w],
                    bits[0] / (h0 * w0), bundles))
    return out
