"""Single-shot codec evaluation CLI (port of control_gic_tpu/cli/infer.py).

Usage:
  python -m control_gic_tpu_torch.cli.infer -i <images_dir> -o <out_dir> \
      [--ckpt model.ckpt|ckpt_dir [--use-ema]] [--ratios 0.1 0.4] \
      [--batch N] [--device_pack] [-w [--partition_map_style lines|color]] \
      [--lpips [--lpips_net alex|vgg|squeeze]] [--images_range 0 -1] \
      [--device cuda|cpu]

Per image: center-crop to /16, compress through real stream files,
reconstruct, write `NNN_<bpp>.png` (and `NNN_map.png`, the grain partition
map, with -w), and log per-image and average bpp and PSNR (and LPIPS) to
bpp.txt.
"""
from __future__ import annotations

import argparse
import os
import time
from collections import defaultdict

import numpy as np
import torch

from ..codec import EncodedImage
from ..data import EvalImageDataset
from ..utils.device import use_fp32_pipes
from ..utils.draw import draw_partition_map, draw_partition_map_color
from ..utils.metrics import psnr
from .common import build_codec, save_png


def get_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-i", "--images_dir", type=str, required=True)
    p.add_argument("-o", "--output_dir", type=str, default="./output")
    p.add_argument("--ckpt", type=str, default=None,
                   help="reference .ckpt, or a training-checkpoint "
                        "directory; random weights when omitted")
    p.add_argument("--use-ema", action="store_true",
                   help="use the EMA shadow weights of a training "
                        "checkpoint")
    p.add_argument("--ratios", type=float, nargs=2, default=(0.1, 0.4),
                   metavar=("COARSE", "MEDIUM"),
                   help="(coarse, medium) grain ratios; fine = 1 - c - m")
    p.add_argument("-w", "--write_partition_map", action="store_true")
    p.add_argument("--partition_map_style", choices=("lines", "color"),
                   default="lines",
                   help="'lines' draws the grain cells' borders; 'color' "
                        "blends a granularity heat map")
    p.add_argument("--device_pack", action="store_true",
                   help="entropy-pack the streams on the device, with the "
                        "encoder (byte-identical output)")
    p.add_argument("--batch", type=int, default=1,
                   help="batch same-shape images through one device call "
                        "(per-sample routing keeps every stream identical "
                        "to a solo encode); -w forces the per-image path")
    p.add_argument("-r", "--images_range", type=int, nargs=2, default=(0, -1))
    p.add_argument("--lpips", action="store_true",
                   help="also report LPIPS (the reference's v0.1 lin heads "
                        "on a random backbone: relative values only)")
    p.add_argument("--lpips_net", choices=("alex", "vgg", "squeeze"),
                   default="alex", help="LPIPS backbone")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    return p


def _compress_batched(codec, dataset, rc, rm, batch, stream_dir,
                      device_pack=False):
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
                                      rc, rm, device_pack=device_pack)
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


def _lpips_fn(net: str, device):
    """LPIPS(a, b) of two [H, W, 3] images in [0, 1]."""
    from ..models.lpips import LPIPS, with_bundled_lin_heads
    model = with_bundled_lin_heads(LPIPS(net)).to(device).eval()
    print("NOTE: lin heads are the reference v0.1 weights; the ImageNet "
          "backbone is random-init unless ported — values are relative "
          "only until a backbone is supplied.")

    @torch.no_grad()
    def fn(a, b):
        up = lambda x: torch.from_numpy(np.ascontiguousarray(
            x, np.float32)).permute(2, 0, 1)[None].to(device)
        return float(model(up(a), up(b), normalize=True)[0])

    return fn


@torch.no_grad()
def _partition_map(codec, img: np.ndarray, rc: float, rm: float,
                  style: str) -> np.ndarray:
    """The grain partition map of one image drawn over it, [H, W, 3]."""
    enc = codec.model.encode(codec._to_input(img[None]), float(rc),
                             float(rm))
    grains = enc.grain_indices.cpu().numpy()
    if style == "color":
        return draw_partition_map_color(img[None], grains)[0]
    return draw_partition_map(img[None], grains, line_value=0.0)[0]


def main(argv=None, codec=None):
    """Run the CLI; `codec` (optional) is used instead of building one from
    --ckpt, --use-ema and --device."""
    args = get_parser().parse_args(argv)
    use_fp32_pipes()
    rc, rm = args.ratios
    os.makedirs(args.output_dir, exist_ok=True)
    stream_dir = os.path.join(args.output_dir, "streams")
    if codec is None:
        codec = build_codec(args.ckpt, device=args.device,
                            use_ema=args.use_ema)
    dataset = EvalImageDataset(args.images_dir,
                               images_range=tuple(args.images_range))
    print(f"Found {len(dataset)} images; ratios=({rc}, {rm}, "
          f"{1 - rc - rm:.3f}); device={codec.device}")
    lpips_fn = _lpips_fn(args.lpips_net, codec.device) if args.lpips else None

    batched = args.batch > 1 and not args.write_partition_map
    results = (_compress_batched(codec, dataset, rc, rm, args.batch,
                                 stream_dir, args.device_pack)
               if batched else {})
    bpps, psnrs, lpipses = [], [], []
    with open(os.path.join(args.output_dir, "bpp.txt"), "w") as log:
        for k in range(len(dataset)):
            img = dataset[k]
            if batched:
                rec, bpp, enc, dt = results[k]
            else:
                t0 = time.time()
                rec, bpp, enc = codec.compress(img, rc, rm,
                                               out_dir=stream_dir,
                                               device_pack=args.device_pack)
                dt = time.time() - t0
            p = psnr(np.clip(rec, 0, 1), img)
            bpps.append(bpp)
            psnrs.append(p)
            if lpips_fn is not None:
                lpipses.append(lpips_fn(np.clip(rec, 0, 1), img))
            save_png(os.path.join(args.output_dir, f"{k:03d}_{bpp:0.5f}.png"),
                     rec)
            if args.write_partition_map:
                save_png(os.path.join(args.output_dir, f"{k:03d}_map.png"),
                         _partition_map(codec, img, rc, rm,
                                       args.partition_map_style))
            line = (f"{k:03d}: bpp={bpp:.5f} psnr={p:.2f}dB "
                    + (f"lpips={lpipses[-1]:.5f} " if lpipses else "")
                    + f"mode={enc.mode} {dt:.2f}s")
            print(line)
            log.write(line + "\n")
        avg = (f"average: bpp={np.mean(bpps):.5f} "
               f"psnr={np.mean(psnrs):.2f}dB "
               + (f"lpips={np.mean(lpipses):.5f} " if lpipses else "")
               + f"over {len(bpps)} images")
        print(avg)
        log.write(avg + "\n")


if __name__ == "__main__":
    main()
