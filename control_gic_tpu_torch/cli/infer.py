"""Single-shot codec evaluation CLI (port of control_gic_tpu/cli/infer.py).

Usage:
  python -m control_gic_tpu_torch.cli.infer -i <images_dir> -o <out_dir> \
      [--ckpt model.ckpt] [--ratios 0.1 0.4] [--batch N] \
      [--images_range 0 -1] [--device cuda|cpu]

Per image: center-crop to /16, compress through real stream files,
reconstruct, write `NNN_<bpp>.png`, and log per-image and average bpp and
PSNR to bpp.txt.
"""
from __future__ import annotations

import argparse
import os
import time
from collections import defaultdict

import numpy as np

from ..codec import EncodedImage
from ..data import EvalImageDataset
from ..utils.device import use_fp32_pipes
from ..utils.metrics import psnr
from .common import build_codec, save_png


def get_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-i", "--images_dir", type=str, required=True)
    p.add_argument("-o", "--output_dir", type=str, default="./output")
    p.add_argument("--ckpt", type=str, default=None,
                   help="reference .ckpt, or a training-checkpoint "
                        "directory; random weights when omitted")
    p.add_argument("--ratios", type=float, nargs=2, default=(0.1, 0.4),
                   metavar=("COARSE", "MEDIUM"),
                   help="(coarse, medium) grain ratios; fine = 1 - c - m")
    p.add_argument("--batch", type=int, default=1,
                   help="batch same-shape images through one device call "
                        "(per-sample routing keeps every stream identical "
                        "to a solo encode)")
    p.add_argument("-r", "--images_range", type=int, nargs=2, default=(0, -1))
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    return p


def _compress_batched(codec, dataset, rc, rm, batch, stream_dir):
    """Round-trip all images in same-shape batches through stream files.
    Returns {index: (rec, bpp, bundle, seconds per image)}."""
    images = [dataset[k] for k in range(len(dataset))]
    groups = defaultdict(list)
    for k, img in enumerate(images):
        groups[img.shape].append(k)
    results = {}
    for idxs in groups.values():
        for lo in range(0, len(idxs), batch):
            chunk = idxs[lo:lo + batch]
            t0 = time.time()
            encs = codec.encode_batch(np.stack([images[k] for k in chunk]),
                                      rc, rm)
            reread = []
            for enc in encs:
                enc.write(stream_dir)
                reread.append(EncodedImage.read(
                    stream_dir, enc.mode, enc.latent_hw, enc.image_hw))
            recs = codec.decode_batch(reread)
            dt = (time.time() - t0) / len(chunk)
            for j, k in enumerate(chunk):
                results[k] = (recs[j], reread[j].bpp, reread[j], dt)
    return results


def main(argv=None):
    args = get_parser().parse_args(argv)
    use_fp32_pipes()
    rc, rm = args.ratios
    os.makedirs(args.output_dir, exist_ok=True)
    stream_dir = os.path.join(args.output_dir, "streams")
    codec = build_codec(args.ckpt, device=args.device)
    dataset = EvalImageDataset(args.images_dir,
                               images_range=tuple(args.images_range))
    print(f"Found {len(dataset)} images; ratios=({rc}, {rm}, "
          f"{1 - rc - rm:.3f}); device={codec.device}")

    batched = args.batch > 1
    results = (_compress_batched(codec, dataset, rc, rm, args.batch,
                                 stream_dir) if batched else {})
    bpps, psnrs = [], []
    with open(os.path.join(args.output_dir, "bpp.txt"), "w") as log:
        for k in range(len(dataset)):
            img = dataset[k]
            if batched:
                rec, bpp, enc, dt = results[k]
            else:
                t0 = time.time()
                rec, bpp, enc = codec.compress(img, rc, rm,
                                               out_dir=stream_dir)
                dt = time.time() - t0
            p = psnr(np.clip(rec, 0, 1), img)
            bpps.append(bpp)
            psnrs.append(p)
            save_png(os.path.join(args.output_dir, f"{k:03d}_{bpp:0.5f}.png"),
                     rec)
            line = (f"{k:03d}: bpp={bpp:.5f} psnr={p:.2f}dB "
                    f"mode={enc.mode} {dt:.2f}s")
            print(line)
            log.write(line + "\n")
        avg = (f"average: bpp={np.mean(bpps):.5f} "
               f"psnr={np.mean(psnrs):.2f}dB over {len(bpps)} images")
        print(avg)
        log.write(avg + "\n")


if __name__ == "__main__":
    main()
