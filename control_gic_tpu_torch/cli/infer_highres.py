"""High-resolution tiled codec CLI (port of
control_gic_tpu/cli/infer_highres.py, the counterpart of the reference's
inference_high_resolution.py).

Usage:
  python -m control_gic_tpu_torch.cli.infer_highres -i <images_dir> \
      -o <out_dir> [--ckpt model.ckpt] [--ratios 0.1 0.4] [--tile 768] \
      [--overlap 0] [--no-pipeline] [--device_pack] [-r 0 -1] \
      [--mesh-devices N] [--spatial] [--device cuda|cpu]

Per image (center-cropped to /16 by the dataset, as in the JAX CLI): pad to
/16, split into tiles, compress each tile independently (same-shape tiles
batched), stitch, and log bpp (bits of all tiles over the original pixels)
and PSNR to bpp.txt beside the reconstruction `NNN_<bpp>.png`.

By default (no overlap, a Huffman table the device packer takes) the images
go through the wire-minimal pipeline, `parallel.tiling.
compress_tiled_device`, in chunks of 8: each image up once as uint8, tiles
sliced, encoded and packed on the device, the host entropy stage overlapped
with the device by threads, the stitched reconstruction down once as uint8.
--no-pipeline (or --overlap) runs the per-tile path, `compress_tiled`
(--device_pack packs its streams on the device). Both give the same streams
and bpp; the pipeline quantizes the reconstruction on the device as
save_png does, so the PNGs agree to within a unit of 255.
--mesh-devices N splits each tile group over a mesh of N devices (the first
N cards; N times the CPU with --device cpu) on the per-tile path, and
--spatial (with --mesh-devices) runs the H-sharded single-pass codec
(parallel/spatial_codec.py) over that mesh instead of tiles: one routing
decision for the whole image, no seams. The pipeline runs only without
either, as in JAX.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np

from ..data import EvalImageDataset
from ..parallel.mesh import make_mesh
from ..parallel.spatial_codec import compress_spatial
from ..parallel.tiling import compress_tiled, compress_tiled_device
from ..utils.device import use_fp32_pipes
from ..utils.metrics import psnr
from .common import build_codec, save_png


def get_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-i", "--images_dir", type=str, required=True)
    p.add_argument("-o", "--output_dir", type=str, default="./output_hr")
    p.add_argument("--ckpt", type=str, default=None,
                   help="reference .ckpt, or a training-checkpoint "
                        "directory; random weights when omitted")
    p.add_argument("--ratios", type=float, nargs=2, default=(0.1, 0.4),
                   metavar=("COARSE", "MEDIUM"))
    p.add_argument("--tile", type=int, default=768)
    p.add_argument("--overlap", type=int, default=0,
                   help="tile overlap in px (multiple of 16); >0 blends "
                        "overlapped tiles with a Gaussian window")
    p.add_argument("--mesh-devices", type=int, default=0,
                   help="shard tile batches over this many devices (0 = "
                        "off)")
    p.add_argument("--spatial", action="store_true",
                   help="H-sharded single-pass codec over the mesh instead "
                        "of independent tiles (no seams, one global routing "
                        "decision); needs --mesh-devices")
    p.add_argument("--device_pack", action="store_true",
                   help="per-tile path: entropy-pack the tiles' streams on "
                        "the device, with the encoder (byte-identical)")
    p.add_argument("--no-pipeline", action="store_true",
                   help="run the per-tile path (compress_tiled) instead of "
                        "the wire-minimal threaded pipeline "
                        "(compress_tiled_device: one uint8 upload and one "
                        "uint8 download per image, tiles sliced and "
                        "stitched on the device)")
    p.add_argument("-r", "--images_range", type=int, nargs=2, default=(0, -1))
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    return p


def main(argv=None, codec=None):
    """Run the CLI; `codec` (optional) is used instead of building one from
    --ckpt and --device. Returns one record per image: (index, bpp, PSNR in
    dB, seconds)."""
    args = get_parser().parse_args(argv)
    use_fp32_pipes()
    if args.spatial and not args.mesh_devices:
        raise ValueError("--spatial requires --mesh-devices")
    rc, rm = args.ratios
    os.makedirs(args.output_dir, exist_ok=True)
    if codec is None:
        codec = build_codec(args.ckpt, device=args.device)
    mesh = None
    if args.mesh_devices:
        # the first N cards, or the CPU N times for a CPU codec
        mesh = make_mesh(args.mesh_devices,
                         devices=None if codec.device.type == "cuda"
                         else [codec.device] * args.mesh_devices)
    dataset = EvalImageDataset(args.images_dir,
                               images_range=tuple(args.images_range))
    print(f"Found {len(dataset)} images; tile={args.tile}; "
          f"device={codec.device}")

    # the pipeline runs plain tiled runs (no overlap blending, no spatial
    # codec, no mesh) with a table the device packer takes; streams and bpp
    # equal the per-tile path's
    pipeline = (not args.no_pipeline and not args.spatial
                and args.overlap == 0 and mesh is None
                and codec._device_tables is not None)
    records = []
    with open(os.path.join(args.output_dir, "bpp.txt"), "w") as log:
        def emit(k, img, rec, bpp, dt):
            p = psnr(np.clip(np.asarray(rec, np.float32)
                             / (255.0 if rec.dtype == np.uint8 else 1.0),
                             0, 1), img)
            records.append((k, bpp, p, dt))
            save_png(os.path.join(args.output_dir, f"{k:03d}_{bpp:0.5f}.png"),
                     rec)
            line = (f"{k:03d}: {img.shape[0]}x{img.shape[1]} "
                    f"bpp={bpp:.5f} psnr={p:.2f}dB {dt:.2f}s")
            print(line)
            log.write(line + "\n")

        if pipeline:
            chunk = 8    # bounds host memory; images overlap within a chunk
            for base in range(0, len(dataset), chunk):
                imgs = [dataset[k] for k in
                        range(base, min(base + chunk, len(dataset)))]
                # uint8 up (4x fewer bytes): the dataset's pixels are k/255,
                # so rint(img * 255) gives the source bytes back and the
                # device's / 255 the same floats, hence the same streams
                imgs_u8 = [np.rint(im * 255.0).astype(np.uint8)
                           for im in imgs]
                t0 = time.time()
                results = compress_tiled_device(codec, imgs_u8, rc, rm,
                                                tile=args.tile)
                dt = (time.time() - t0) / len(imgs)
                for j, (rec, bpp, _) in enumerate(results):
                    emit(base + j, imgs[j], rec, bpp, dt)
        else:
            for k in range(len(dataset)):
                img = dataset[k]
                t0 = time.time()
                if args.spatial:
                    rec, bpp, _ = compress_spatial(codec, img, rc, rm, mesh)
                else:
                    rec, bpp, _ = compress_tiled(
                        codec, img, rc, rm, tile=args.tile,
                        overlap=args.overlap, mesh=mesh,
                        device_pack=args.device_pack)
                emit(k, img, rec, bpp, time.time() - t0)
        avg = (f"average: bpp={np.mean([r[1] for r in records]):.5f} "
               f"psnr={np.mean([r[2] for r in records]):.2f}dB")
        print(avg)
        log.write(avg + "\n")
    return records


if __name__ == "__main__":
    main()
