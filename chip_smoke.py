"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases, each printing a line of its own:
  1. device: the card's name and power limit (nvidia-smi); fails without CUDA;
  2. build: compiles every CUDA kernel of the main path from this checkout;
  3. kernels: each kernel against its plain PyTorch version on the card, at
     the shapes of the main path, with its time, the plain version's, the
     library call's and the bound;
  4. main path: the full-width codec (random weights from a seed, bf16)
     compresses 256x256 images through stream files in all 7 modes, with a
     receiver-only decode from the files and the kernel launch counts;
  5. f32 parity: one image at full width in float32 on the card against the
     port's plain versions on the CPU.
Then the kernel JSON line, and last the device JSON line. Any failure raises
and the script exits non-zero without the last line.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

# kernel -> where it lives, the TPU kernel it replaces
KERNELS = {
    "flash_attn_fwd": {
        "route": "cuda",
        "source": "control_gic_tpu_torch/kernels/flash_attn_fwd.cu",
        "replaces": "control_gic_tpu/ops/attention.py:49",
    },
}
# shapes the main path gives the attention kernel at 256x256:
# (B, Tq, Tk, C, dtype); the first is the one the JSON line reports
ATTN_SHAPES = [(1, 4096, 4096, 512, "bfloat16"), (1, 4096, 4096, 256, "bfloat16"),
               (2, 4096, 4096, 512, "float32"), (1, 1024, 4096, 512, "bfloat16")]
ATTN_TOL = {"bfloat16": 2e-2, "float32": 1e-4}
# (peak dense tensor bf16 FLOP/s, peak fp32 non-tensor FLOP/s, HBM bytes/s)
# of the H100 parts (NVIDIA data sheets)
PEAKS = {"PCIe": (756e12, 51e12, 2.0e12), "NVL": (835e12, 60e12, 3.9e12),
         "SXM": (989e12, 67e12, 3.35e12)}


def log(phase: str, **kw) -> None:
    print(f"[{phase}] " + json.dumps(kw, default=str), flush=True)


def card_peaks(name: str):
    for key in ("PCIe", "NVL"):
        if key in name:
            return PEAKS[key]
    return PEAKS["SXM"]


def cuda_time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_device() -> dict:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; this script "
                         "runs on a CUDA card only")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = {"name": torch.cuda.get_device_name(0),
           "count": torch.cuda.device_count(), "nvidia_smi": smi,
           "torch": torch.__version__, "cuda": torch.version.cuda,
           "python": sys.version.split()[0]}
    log("device", **dev)
    return dev


def phase_build() -> None:
    from concurrent.futures import ThreadPoolExecutor

    from control_gic_tpu_torch.kernels import build
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        paths = list(pool.map(build.build, KERNELS))
    for name in KERNELS:
        build.load(name)
    for name, (secs, report) in build.BUILD_LOG.items():
        print(f"[ptxas {name}]\n{report.strip()}", flush=True)
    log("build", seconds=round(time.perf_counter() - t0, 3), libraries=paths)


def attn_bound_ms(b, tq, tk, c, dtype, peaks) -> tuple:
    flops = 4.0 * b * tq * tk * c
    itemsize = 2 if dtype == "bfloat16" else 4
    nbytes = itemsize * (2 * b * tq * c + 2 * b * tk * c)
    t_ops = flops / (peaks[0] if dtype == "bfloat16" else peaks[1])
    t_bytes = nbytes / peaks[2]
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def phase_kernels(dev: dict) -> list:
    import torch
    import torch.nn.functional as F

    from control_gic_tpu_torch.ops import attention as A

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    peaks = card_peaks(dev["name"])
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for b, tq, tk, c, dt in ATTN_SHAPES:
        dtype = getattr(torch, dt)
        q = (2 * torch.randn(b, tq, c, device="cuda", generator=gen)).to(dtype)
        k = torch.randn(b, tk, c, device="cuda", generator=gen).to(dtype)
        v = torch.randn(b, tk, c, device="cuda", generator=gen).to(dtype)
        out = A.flash_attention(q, k, v)
        torch.cuda.synchronize()
        ref = A.attention_reference(q, k, v)
        err = (out.float() - ref.float()).abs().max().item()
        ms = cuda_time_ms(lambda: A.flash_attention(q, k, v))
        plain_ms = cuda_time_ms(lambda: A.attention_reference(q, k, v))
        lib_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(
            q[:, None], k[:, None], v[:, None]))
        bound_ms, bound_by = attn_bound_ms(b, tq, tk, c, dt, peaks)
        row = {"shape": [b, tq, tk, c], "dtype": dt, "max_abs_err": err,
               "tol": ATTN_TOL[dt], "ms": ms, "plain_ms": plain_ms,
               "library_ms": lib_ms, "bound_ms": bound_ms,
               "bound_by": bound_by, "card": dev["nvidia_smi"]}
        log("kernel flash_attn_fwd", **row)
        if not err <= ATTN_TOL[dt]:
            raise AssertionError(f"flash_attn_fwd disagrees with its plain "
                                 f"version at {row['shape']} {dt}: "
                                 f"max abs err {err} > {ATTN_TOL[dt]}")
        rows.append(row)
    return rows


RATIOS = [(0.1, 0.4), (0.0, 0.8), (0.3, 0.0), (0.5, 0.5),
          (1.0, 0.0), (0.0, 1.0), (0.0, 0.0)]   # the ratios of modes 0-6
IMAGE = 256
FLASH_PER_IMAGE = 4   # encoder head_fine + decoder mid_coarse, mid, mid_fine


def make_image(seed: int, size: int = IMAGE):
    """A test image with flat, smooth and textured regions, so that the
    router sees a spread of patch entropies; [H, W, 3] float32 in [0, 1]."""
    import numpy as np
    rng = np.random.default_rng(seed)
    cells = size // 32
    flat = np.kron(rng.uniform(0, 1, (cells, cells, 3)), np.ones((32, 32, 1)))
    yy, xx = np.mgrid[0:size, 0:size] / size
    ramp = (0.3 * np.sin(2 * np.pi * (rng.uniform(0.5, 2) * xx
                                      + rng.uniform(0.5, 2) * yy)))[..., None]
    busy = np.kron(rng.uniform(0, 1, (cells, cells, 1)), np.ones((32, 32, 1)))
    noise = rng.normal(0, 0.2, (size, size, 3)) * (busy > 0.5)
    return np.clip(0.6 * flat + ramp + noise, 0, 1).astype(np.float32)


def phase_main_path(dev: dict, workdir: str):
    """The full-width codec through stream files in all 7 modes; returns
    the kernel launch counts of that run, the codec and the images."""
    import numpy as np
    import torch

    from control_gic_tpu_torch.cli.common import build_codec
    from control_gic_tpu_torch.codec import EncodedImage
    from control_gic_tpu_torch.ops import attention as A

    t0 = time.perf_counter()
    codec = build_codec(device="cuda", seed=0)
    n_params = sum(p.numel() for p in codec.model.parameters())
    assert codec.model.config.dtype == "bfloat16", codec.model.config
    log("main path setup", params=n_params, dtype=codec.model.config.dtype,
        seconds=time.perf_counter() - t0)
    images = [make_image(seed) for seed in range(4)]
    runs = [(images[i], RATIOS[0]) for i in range(4)]
    runs += [(images[m % 4], RATIOS[m]) for m in range(1, 7)]
    codec.compress(images[0], *RATIOS[0])            # warm-up, not counted

    A.KERNEL_LAUNCHES = 0
    results, stats = [], {}
    torch.cuda.reset_peak_memory_stats()
    for i, (img, ratios) in enumerate(runs):
        out_dir = os.path.join(workdir, f"run{i}")
        results.append((out_dir,) + codec.compress(
            img, *ratios, out_dir=out_dir, stats=stats if i < 4 else None))
    launches = A.KERNEL_LAUNCHES
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30

    for i, (out_dir, rec, bpp, enc) in enumerate(results):
        mode = i - 3 if i >= 4 else 0
        assert enc.mode == mode, (i, enc.mode, mode)
        assert bpp > 0, (i, bpp)
        assert rec.shape == (IMAGE, IMAGE, 3) and np.isfinite(rec).all()
        rec2 = codec.decode(EncodedImage.read(out_dir, enc.mode,
                                              enc.latent_hw, enc.image_hw))
        diff = float(np.abs(rec2 - rec).max())
        assert diff <= 1e-3, f"receiver-only decode differs by {diff}"
        log("image", run=i, mode=enc.mode, bpp=bpp,
            stream_bytes=enc.num_bytes, recv_only_max_diff=diff,
            rec_mean=float(rec.mean()))
    expected = FLASH_PER_IMAGE * len(runs)
    if launches != expected:
        raise AssertionError(f"flash_attn_fwd launched {launches} times for "
                             f"{len(runs)} images, expected {expected}")
    per_image = {k: 1e3 * v / 4 for k, v in stats.items()}
    log("main path", images=len(runs), modes=sorted({r[3].mode
                                                      for r in results}),
        flash_launches=launches, peak_mem_gib=peak_gib,
        encode_ms=per_image["encode_s"],
        entropy_coding_ms=(per_image["entropy_s"] + per_image["files_s"]
                           + per_image["rebuild_s"]),
        decode_ms=per_image["decode_s"], ms_per_image_mode0=per_image,
        card=dev["nvidia_smi"])
    return {"flash_attn_fwd": launches}, codec, images


def phase_profile(dev: dict, codec, images) -> None:
    """torch.profiler over two mode-0 round trips: device busy and idle
    share of the host wall time, and device time by kernel."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for img in images[:2]:
            codec.compress(img, *RATIOS[0])
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            spans.append((e.time_range.start, e.time_range.end))
            name = e.name[:90]     # template names share long prefixes
            by_name[name] = by_name.get(name, 0.0) + e.time_range.elapsed_us()
    if not spans:
        log("profile", device_time="not measured (the profiler recorded no "
            "device events)", wall_ms_per_image=wall_us / 2e3)
        return
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):          # union of the device intervals
        if b > end:
            busy += b - max(a, end)
            end = b
    device_us = sum(by_name.values())
    flash_us = sum(v for k, v in by_name.items() if "flash_fwd_kernel" in k)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    log("profile", images=2, wall_ms_per_image=wall_us / 2e3,
        device_busy_ms_per_image=busy / 2e3,
        device_idle_share=1.0 - busy / wall_us,
        device_kernels_per_image=len(spans) / 2,
        flash_share_of_device_time=flash_us / device_us,
        top_kernels_ms_per_image={k: v / 2e3 for k, v in top},
        card=dev["nvidia_smi"])


def phase_f32_parity(image) -> None:
    """Full width in float32: the card (kernels) against the CPU (plain
    versions), same weights. Masks and indices must agree except at
    positions within 1e-5 of a threshold or a nearest-code tie; the decode
    of the CPU's indices must agree within 1e-3."""
    import copy

    import torch

    from control_gic_tpu_torch.models import CGIC, CGICConfig
    from control_gic_tpu_torch.ops import attention as A
    from control_gic_tpu_torch.ops.entropy import patch_entropy
    from control_gic_tpu_torch.ops.resample import upsample_nearest

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(os.cpu_count() or 1)
    t0 = time.perf_counter()
    cpu = CGIC(CGICConfig(dtype="float32"),
               generator=torch.Generator().manual_seed(1)).eval()
    gpu = copy.deepcopy(cpu).cuda()
    x = torch.from_numpy(image).permute(2, 0, 1)[None].contiguous()
    rc, rm = RATIOS[0]
    before = A.KERNEL_LAUNCHES
    with torch.no_grad():
        rg = gpu.route(x.cuda(), rc, rm)
        lat_g = gpu.latent(x.cuda(), rg)
        enc_g = gpu.encode(x.cuda(), rc, rm)
        rcpu = cpu.route(x, rc, rm)
        lat_c = cpu.latent(x, rcpu)
        enc_c = cpu.encode(x, rc, rm)
    assert A.KERNEL_LAUNCHES > before, "the f32 card run missed the kernel"

    # masks: differing cells must sit within 1e-5 of their threshold
    e16, e8 = patch_entropy(x, 16)[0], patch_entropy(x, 8)[0]
    thr_c = torch.sort(e16.reshape(-1)).values[round(e16.numel() * rc) - 1]
    not_c = ~upsample_nearest(rcpu.mask_coarse[0].bool(), 2)
    k_m = round(4 * e16.numel() * rc + e8.numel() * rm)
    thr_m = torch.sort((e8 * not_c).reshape(-1)).values[k_m - 1]
    dc = rg.mask_coarse[0].cpu() != rcpu.mask_coarse[0]
    dm = rg.mask_medium[0].cpu() != rcpu.mask_medium[0]
    near_c = ((e16 - thr_c).abs() <= 1e-5)
    near_m = ((e8 - thr_m).abs() <= 1e-5) | upsample_nearest(dc, 2)
    assert bool((near_c | ~dc).all()) and bool((near_m | ~dm).all()), \
        "router masks differ away from a threshold"
    df = rg.mask_fine[0].cpu() != rcpu.mask_fine[0]

    # indices: where the masks agree, differing positions must be ties
    lat = lat_c[0].float().permute(1, 2, 0).reshape(-1, 4)
    cb = cpu.codebook.float()
    dist = (lat * lat).sum(1, keepdim=True) + (cb * cb).sum(1) - 2 * lat @ cb.t()
    ig, ic = enc_g.indices[0].cpu().reshape(-1), enc_c.indices[0].reshape(-1)
    di = (ig != ic) & ~df.reshape(-1)
    pos = di.nonzero().reshape(-1)
    gap = (dist[pos, ig[pos]] - dist[pos, ic[pos]]).abs()
    assert bool((gap <= 1e-5).all()), \
        f"indices differ at non-ties: gaps {gap[gap > 1e-5][:8].tolist()}"

    with torch.no_grad():
        masks = enc_c.router.masks
        rec_c = cpu.decode_indices(enc_c.indices, masks)
        rec_g = gpu.decode_indices(enc_c.indices.cuda(),
                                   tuple(m.cuda() for m in masks)).cpu()
    rec_err = float((rec_g - rec_c).abs().max())
    # random weights give a small output, so hold the error to its scale too
    rec_rel = rec_err / float(rec_c.abs().max())
    log("f32 parity", mask_cells_differing=int(dc.sum() + dm.sum()),
        index_positions_differing=int(di.sum()), ties_among_them=int(
            pos.numel()), latent_max_abs_err=float(
            (lat_g.cpu() - lat_c).abs().max()), recon_max_abs_err=rec_err,
        recon_rel_err=rec_rel, recon_tol=1e-3,
        seconds=time.perf_counter() - t0)
    assert rec_err <= 1e-3 and rec_rel <= 1e-3, \
        f"f32 recon card vs CPU differs by {rec_err} ({rec_rel} relative)"


def main() -> None:
    import tempfile

    dev = phase_device()
    phase_build()
    rows = phase_kernels(dev)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        launches, codec, images = phase_main_path(dev, workdir)
    phase_profile(dev, codec, images)
    del codec
    phase_f32_parity(make_image(0))
    main_row = rows[0]
    kernels = [dict(name=name, **KERNELS[name], launches=launches[name],
                    max_abs_err=main_row["max_abs_err"], ms=main_row["ms"],
                    plain_ms=main_row["plain_ms"],
                    bound_ms=main_row["bound_ms"],
                    bound_by=main_row["bound_by"],
                    library_ms=main_row["library_ms"])
               for name in KERNELS]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev["name"], "count": dev["count"]}}),
        flush=True)


if __name__ == "__main__":
    main()
