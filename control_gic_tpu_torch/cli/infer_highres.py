"""High-resolution tiled codec CLI (port of
control_gic_tpu/cli/infer_highres.py, the counterpart of the reference's
inference_high_resolution.py).

Usage:
  python -m control_gic_tpu_torch.cli.infer_highres -i <images_dir> \
      -o <out_dir> [--ckpt model.ckpt] [--ratios 0.1 0.4] [--tile 768] \
      [--overlap 0] [-r 0 -1] [--device cuda|cpu]

Per image (center-cropped to /16 by the dataset, as in the JAX CLI): pad to
/16, split into tiles, compress each tile independently (same-shape tiles
batched), stitch, and log bpp (bits of all tiles over the original pixels)
and PSNR to bpp.txt beside the reconstruction `NNN_<bpp>.png`.

This runs JAX's per-tile path, `parallel.tiling.compress_tiled`, which gives
the same streams and bpp as JAX's default threaded pipeline. The pipeline
itself (`compress_tiled_device`, with device packing), the H-sharded codec
and the mesh are not ported yet: --spatial, --mesh-devices and --device_pack
raise, and --no-pipeline is accepted and changes nothing.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np

from ..data import EvalImageDataset
from ..parallel.tiling import compress_tiled
from ..utils.device import use_fp32_pipes
from ..utils.metrics import psnr
from .common import build_codec, save_png

# options of the JAX CLI that need a path the port does not have yet, and
# the ROADMAP queue 1 item that ports it
UNPORTED = {"spatial": "--spatial needs the H-sharded codec (ROADMAP queue "
                       "1 item 14)",
            "mesh_devices": "--mesh-devices needs the tile mesh (ROADMAP "
                            "queue 1 items 13-14)",
            "device_pack": "--device_pack needs the device entropy paths "
                           "(ROADMAP queue 1 item 11)"}


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
                   help="not ported yet (raises)")
    p.add_argument("--spatial", action="store_true",
                   help="not ported yet (raises)")
    p.add_argument("--device_pack", action="store_true",
                   help="not ported yet (raises)")
    p.add_argument("--no-pipeline", action="store_true",
                   help="the per-tile path, which is the only one the port "
                        "has: the threaded device pipeline of the JAX CLI "
                        "(compress_tiled_device) is not ported yet")
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
    for name, why in UNPORTED.items():
        if getattr(args, name):
            raise NotImplementedError(why)
    rc, rm = args.ratios
    os.makedirs(args.output_dir, exist_ok=True)
    if codec is None:
        codec = build_codec(args.ckpt, device=args.device)
    dataset = EvalImageDataset(args.images_dir,
                               images_range=tuple(args.images_range))
    print(f"Found {len(dataset)} images; tile={args.tile}; "
          f"device={codec.device}")

    records = []
    with open(os.path.join(args.output_dir, "bpp.txt"), "w") as log:
        for k in range(len(dataset)):
            img = dataset[k]
            t0 = time.time()
            rec, bpp, _ = compress_tiled(codec, img, rc, rm, tile=args.tile,
                                         overlap=args.overlap)
            dt = time.time() - t0
            p = psnr(np.clip(rec, 0, 1), img)
            records.append((k, bpp, p, dt))
            save_png(os.path.join(args.output_dir, f"{k:03d}_{bpp:0.5f}.png"),
                     rec)
            line = (f"{k:03d}: {img.shape[0]}x{img.shape[1]} "
                    f"bpp={bpp:.5f} psnr={p:.2f}dB {dt:.2f}s")
            print(line)
            log.write(line + "\n")
        avg = (f"average: bpp={np.mean([r[1] for r in records]):.5f} "
               f"psnr={np.mean([r[2] for r in records]):.2f}dB")
        print(avg)
        log.write(avg + "\n")
    return records


if __name__ == "__main__":
    main()
