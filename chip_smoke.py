"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases, each printing a line of its own:
  1. device: the card's name and power limit (nvidia-smi); fails without CUDA;
  2. build: compiles every CUDA kernel of the main paths from this checkout,
     one nvcc per source, all started together;
  3. kernels: each kernel against its plain PyTorch version on the card, at
     the shapes of the main paths, with its time, the plain version's, the
     library call's and the bound;
  4. 256x256 path: the full-width codec (random weights from a seed, bf16)
     compresses 256x256 images through stream files in all 7 modes, with a
     receiver-only decode from the files and the kernel launch counts, then
     a profile of two round trips;
  5. Kodak path: the same codec on 512x768 (Kodak-shape) images in all 7
     modes, where the chained norm+conv and moment kernels engage, with the
     launch counts per image and a profile of one round trip;
  6. f32 parity at 256x256: the card (kernels) against the CPU (plain
     versions), same weights;
  7. Kodak f32: one 512x768 image through the f32 model on the card with the
     kernels against the same model under ops.plain_versions().
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
    "norm_conv_chain": {
        "route": "cuda",
        "source": "control_gic_tpu_torch/kernels/norm_conv_chain.cu",
        "replaces": "control_gic_tpu/ops/norm_conv.py:136",
    },
    "gn_moments": {
        "route": "cuda",
        "source": "control_gic_tpu_torch/kernels/gn_moments.cu",
        "replaces": "control_gic_tpu/ops/fused_norm.py:101",
    },
}
# shapes the main paths give the attention kernel: (B, Tq, Tk, C, dtype);
# 4096 tokens at 256x256, 24576 and 6144 at 512x768
ATTN_SHAPES = [(1, 4096, 4096, 512, "bfloat16"), (1, 4096, 4096, 256, "bfloat16"),
               (2, 4096, 4096, 512, "float32"), (1, 1024, 4096, 512, "bfloat16"),
               (1, 24576, 24576, 512, "bfloat16"), (1, 24576, 24576, 256, "bfloat16"),
               (1, 6144, 6144, 512, "bfloat16")]
ATTN_TOL = {"bfloat16": 2e-2, "float32": 1e-4}
# the chain kernel's calls on the 512x768 path: (norm form, H, W, Cin, Cout,
# residual, emits moments, dtype); the f32 row is the parity path
CHAIN_SHAPES = [("gn", 512, 768, 128, 128, True, True, "bfloat16"),
                ("gn", 256, 384, 128, 256, False, True, "bfloat16"),
                ("gn", 256, 384, 256, 256, True, True, "bfloat16"),
                ("sn", 256, 384, 256, 256, True, True, "bfloat16"),
                ("sn", 512, 768, 256, 128, False, True, "bfloat16"),
                ("sn", 512, 768, 128, 128, True, True, "bfloat16"),
                ("sn", 512, 768, 128, 3, False, False, "bfloat16"),
                ("gn", 256, 384, 256, 256, True, True, "float32")]
# the moment pass's inputs on the 512x768 path: (B, C, H, W), bf16
MOMENT_SHAPES = [(1, 128, 512, 768), (1, 128, 256, 384), (1, 256, 256, 384),
                 (1, 256, 512, 768)]
# max |kernel - plain| <= tol * max(1, max |plain|), for outputs and moments
OUT_TOL = {"bfloat16": 2e-2, "float32": 1e-4}
MOM_TOL = {"bfloat16": 1e-2, "float32": 1e-5}
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


def bound_ms(flops: float, nbytes: float, dtype: str, peaks) -> tuple:
    """The least time for the work: flops over the dtype's peak, bytes over
    the memory rate, whichever is larger, and which one it is."""
    t_ops = flops / (peaks[0] if dtype == "bfloat16" else peaks[1])
    t_bytes = nbytes / peaks[2]
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def rel_err(got, want) -> float:
    return ((got.float() - want.float()).abs().max()
            / max(1.0, want.float().abs().max().item())).item()


def reset_launches() -> None:
    from control_gic_tpu_torch.ops import attention as A
    from control_gic_tpu_torch.ops import fused_norm as FN
    from control_gic_tpu_torch.ops import norm_conv as NC
    A.KERNEL_LAUNCHES = 0
    NC.KERNEL_LAUNCHES.update(chain_gn=0, chain_sn=0)
    FN.KERNEL_LAUNCHES.update(gn_moments=0)


def read_launches() -> dict:
    from control_gic_tpu_torch.ops import attention as A
    from control_gic_tpu_torch.ops import fused_norm as FN
    from control_gic_tpu_torch.ops import norm_conv as NC
    return {"flash_attn_fwd": A.KERNEL_LAUNCHES, **NC.KERNEL_LAUNCHES,
            **FN.KERNEL_LAUNCHES}


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
        print(f"[ptxas {name}] {secs:.2f} s\n{report.strip()}", flush=True)
    log("build", seconds=round(time.perf_counter() - t0, 3), libraries=paths)


def attn_bound_ms(b, tq, tk, c, dtype, peaks) -> tuple:
    itemsize = 2 if dtype == "bfloat16" else 4
    return bound_ms(4.0 * b * tq * tk * c,
                    itemsize * (2 * b * tq * c + 2 * b * tk * c), dtype, peaks)


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
        bms, bound_by = attn_bound_ms(b, tq, tk, c, dt, peaks)
        row = {"kernel": "flash_attn_fwd", "shape": [b, tq, tk, c],
               "dtype": dt, "max_abs_err": err, "tol": ATTN_TOL[dt],
               "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
               "bound_ms": bms, "bound_by": bound_by,
               "card": dev["nvidia_smi"]}
        log("kernel flash_attn_fwd", **row)
        if not err <= ATTN_TOL[dt]:
            raise AssertionError(f"flash_attn_fwd disagrees with its plain "
                                 f"version at {row['shape']} {dt}: "
                                 f"max abs err {err} > {ATTN_TOL[dt]}")
        rows.append(row)
        del q, k, v, out, ref
    rows += chain_rows(dev, peaks, gen)
    rows += moment_rows(dev, peaks, gen)
    return rows


def chain_rows(dev: dict, peaks, gen) -> list:
    """The chain kernel at each of its 512x768-path shapes, with its stats
    given (as the moment pass or a previous chain call gives them), against
    its plain version; the library yardstick is cuDNN's conv alone."""
    import torch
    import torch.nn.functional as F

    from control_gic_tpu_torch.ops import fused_norm as FN
    from control_gic_tpu_torch.ops import norm_conv as NC

    rows = []
    for form, h, w, cin, cout, with_res, emit, dt in CHAIN_SHAPES:
        dtype = getattr(torch, dt)
        r = lambda *s, scale=1.0: scale * torch.randn(*s, device="cuda",
                                                      generator=gen)
        x = r(1, cin, h, w).to(dtype)
        zq_r = r(1, 4, h, w).to(dtype) if form == "sn" else None
        norm = dict(gs=1 + r(cin, scale=0.1), gb=r(cin, scale=0.1))
        mod = (dict(wy=r(cin, 4, scale=0.3), by=r(cin, scale=0.1),
                    wb=r(cin, 4, scale=0.3), bb=r(cin, scale=0.1))
               if form == "sn" else {})
        cw = r(cout, cin, 3, 3, scale=(9 * cin) ** -0.5)
        cb = r(cout, scale=0.1)
        res = r(1, cout, h, w).to(dtype) if with_res else None
        stats = NC.stats_from_moments(FN.gn_moments_reference(x), h * w)

        def kernel():
            return NC.chain_kernel(x, cw, cb, norm["gs"], norm["gb"], stats,
                                   res, emit, True, zq_r, **mod)

        def plain():
            if form == "sn":
                return NC.chain_reference(x, zq_r, norm["gs"], norm["gb"],
                                          mod["wy"], mod["by"], mod["wb"],
                                          mod["bb"], cw, cb, res=res,
                                          stats=stats, emit_mom=emit)
            return NC.plain_chain_reference(x, norm["gs"], norm["gb"], cw,
                                            cb, res=res, stats=stats,
                                            emit_mom=emit)

        got, want = kernel(), plain()
        torch.cuda.synchronize()
        if emit:
            (got, mom), (want, want_mom) = got, want
            mom_err = rel_err(mom, want_mom)
        else:
            mom_err = None
        err = rel_err(got, want)
        max_abs = (got.float() - want.float()).abs().max().item()
        ms = cuda_time_ms(kernel)
        plain_ms = cuda_time_ms(plain)
        cwd, cbd = cw.to(dtype), cb.to(dtype)
        lib_ms = cuda_time_ms(lambda: F.conv2d(x, cwd, cbd, padding=1))
        itemsize = x.element_size()
        nbytes = itemsize * (cin * h * w + cout * h * w * (1 + with_res)
                             + 4 * h * w * (form == "sn") + 9 * cin * cout)
        bms, bound_by = bound_ms(2.0 * h * w * 9 * cin * cout, nbytes, dt,
                                 peaks)
        row = {"kernel": "norm_conv_chain", "form": form,
               "shape": [1, cin, h, w], "cout": cout, "residual": with_res,
               "emit_mom": emit, "dtype": dt, "max_abs_err": max_abs,
               "rel_err": err, "tol": OUT_TOL[dt], "mom_rel_err": mom_err,
               "mom_tol": MOM_TOL[dt], "ms": ms, "plain_ms": plain_ms,
               "library_ms": lib_ms, "library": "F.conv2d, conv only",
               "bound_ms": bms, "bound_by": bound_by,
               "card": dev["nvidia_smi"]}
        log("kernel norm_conv_chain", **row)
        if not (err <= OUT_TOL[dt]
                and (mom_err is None or mom_err <= MOM_TOL[dt])):
            raise AssertionError(f"norm_conv_chain disagrees with its plain "
                                 f"version: {row}")
        rows.append(row)
    return rows


def moment_rows(dev: dict, peaks, gen) -> list:
    import torch

    from control_gic_tpu_torch.ops import fused_norm as FN

    rows = []
    for b, c, h, w in MOMENT_SHAPES:
        x = (0.5 + torch.randn(b, c, h, w, device="cuda", generator=gen)
             ).to(torch.bfloat16)
        got = FN.gn_moments_kernel(x)
        want = FN.gn_moments_reference(x)
        torch.cuda.synchronize()
        err = rel_err(got, want)
        ms = cuda_time_ms(lambda: FN.gn_moments_kernel(x))
        plain_ms = cuda_time_ms(lambda: FN.gn_moments_reference(x))
        bms, bound_by = bound_ms(3.0 * x.numel(), 2 * x.numel() + 8 * b * c,
                                 "float32", peaks)
        row = {"kernel": "gn_moments", "shape": [b, c, h, w],
               "dtype": "bfloat16", "rel_err": err, "tol": MOM_TOL["bfloat16"],
               "max_abs_err": (got - want).abs().max().item(), "ms": ms,
               "plain_ms": plain_ms, "library_ms": None, "bound_ms": bms,
               "bound_by": bound_by, "card": dev["nvidia_smi"]}
        log("kernel gn_moments", **row)
        if not err <= MOM_TOL["bfloat16"]:
            raise AssertionError(f"gn_moments disagrees with its plain "
                                 f"version: {row}")
        rows.append(row)
    return rows


RATIOS = [(0.1, 0.4), (0.0, 0.8), (0.3, 0.0), (0.5, 0.5),
          (1.0, 0.0), (0.0, 1.0), (0.0, 0.0)]   # the ratios of modes 0-6
IMAGE = (256, 256)
KODAK = (512, 768)
# launches per image: at 256x256 the encoder's head_fine mid and the
# decoder's three mids attend (4096 tokens) and nothing chains; at 512x768
# add the encoder's level-3 attentions and head_medium mid and the decoder's
# level-3 attentions, and the chained trunks (encoder levels 0-1 in the
# GroupNorm form, decoder levels 1-0 and norm_out in the SpatialNorm form)
PER_IMAGE = {
    IMAGE: {"flash_attn_fwd": 4, "chain_gn": 0, "chain_sn": 0,
            "gn_moments": 0},
    KODAK: {"flash_attn_fwd": 10, "chain_gn": 8, "chain_sn": 13,
            "gn_moments": 4},
}


def make_image(seed: int, hw=IMAGE):
    """A test image with flat, smooth and textured regions, so that the
    router sees a spread of patch entropies; [H, W, 3] float32 in [0, 1]."""
    import numpy as np
    h, w = hw
    rng = np.random.default_rng(seed)
    cells = (h // 32, w // 32)
    flat = np.kron(rng.uniform(0, 1, cells + (3,)), np.ones((32, 32, 1)))
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    ramp = (0.3 * np.sin(2 * np.pi * (rng.uniform(0.5, 2) * xx
                                      + rng.uniform(0.5, 2) * yy)))[..., None]
    busy = np.kron(rng.uniform(0, 1, cells + (1,)), np.ones((32, 32, 1)))
    noise = rng.normal(0, 0.2, (h, w, 3)) * (busy > 0.5)
    return np.clip(0.6 * flat + ramp + noise, 0, 1).astype(np.float32)


def phase_main_path(dev: dict, codec, workdir: str, hw, n_mode0: int):
    """The full-width codec through stream files: n_mode0 images in mode 0,
    then one in each of modes 1-6. Returns the kernel launch counts of that
    run and the images."""
    import numpy as np
    import torch

    from control_gic_tpu_torch.codec import EncodedImage

    label = f"{hw[0]}x{hw[1]}"
    images = [make_image(seed, hw) for seed in range(n_mode0)]
    runs = [(images[i], RATIOS[0]) for i in range(n_mode0)]
    runs += [(images[m % n_mode0], RATIOS[m]) for m in range(1, 7)]
    codec.compress(images[0], *RATIOS[0])            # warm-up, not counted
    torch.cuda.synchronize()

    reset_launches()
    results, stats = [], {}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for i, (img, ratios) in enumerate(runs):
        out_dir = os.path.join(workdir, f"{label}_run{i}")
        results.append((out_dir,) + codec.compress(
            img, *ratios, out_dir=out_dir,
            stats=stats if i < n_mode0 else None))
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = read_launches()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30

    for i, (out_dir, rec, bpp, enc) in enumerate(results):
        mode = i - n_mode0 + 1 if i >= n_mode0 else 0
        assert enc.mode == mode, (i, enc.mode, mode)
        assert bpp > 0, (i, bpp)
        assert rec.shape == hw + (3,) and np.isfinite(rec).all()
        rec2 = codec.decode(EncodedImage.read(out_dir, enc.mode,
                                              enc.latent_hw, enc.image_hw))
        diff = float(np.abs(rec2 - rec).max())
        assert diff <= 1e-3, f"receiver-only decode differs by {diff}"
        log(f"image {label}", run=i, mode=enc.mode, bpp=bpp,
            stream_bytes=enc.num_bytes, recv_only_max_diff=diff,
            rec_mean=float(rec.mean()))
    expected = {k: v * len(runs) for k, v in PER_IMAGE[hw].items()}
    if launches != expected:
        raise AssertionError(f"{label}: kernel launches {launches} for "
                             f"{len(runs)} images, expected {expected}")
    per_image = {k: 1e3 * v / n_mode0 for k, v in stats.items()}
    log(f"main path {label}", images=len(runs),
        modes=sorted({r[3].mode for r in results}), launches=launches,
        launches_per_image={k: v / len(runs) for k, v in launches.items()},
        peak_mem_gib=peak_gib, wall_ms_per_image=1e3 * wall_s / len(runs),
        encode_ms=per_image["encode_s"],
        entropy_coding_ms=(per_image["entropy_s"] + per_image["files_s"]
                           + per_image["rebuild_s"]),
        decode_ms=per_image["decode_s"], ms_per_image_mode0=per_image,
        card=dev["nvidia_smi"])
    return launches, images


def phase_profile(dev: dict, codec, images, label: str) -> None:
    """torch.profiler over mode-0 round trips of `images`: device busy and
    idle share of the host wall time, and device time by kernel."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    n = len(images)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for img in images:
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
        log(f"profile {label}", device_time="not measured (the profiler "
            "recorded no device events)", wall_ms_per_image=wall_us / n / 1e3)
        return
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):          # union of the device intervals
        if b > end:
            busy += b - max(a, end)
            end = b
    device_us = sum(by_name.values())
    share = lambda key: sum(v for k, v in by_name.items() if key in k) / device_us
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    log(f"profile {label}", images=n, wall_ms_per_image=wall_us / n / 1e3,
        device_busy_ms_per_image=busy / n / 1e3,
        device_idle_share=1.0 - busy / wall_us,
        device_kernels_per_image=len(spans) / n,
        flash_share_of_device_time=share("flash_fwd_kernel"),
        chain_share_of_device_time=share("chain_kernel"),
        moments_share_of_device_time=share("gn_moments_kernel"),
        top_kernels_ms_per_image={k: v / n / 1e3 for k, v in top},
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


def kernels_vs_plain(model, image) -> dict:
    """One image's pre-VQ latent, and the decode of its indices and masks,
    through `model` with the kernels and under ops.plain_versions(); the
    launch counts of the plain run must stay where they were."""
    import torch

    from control_gic_tpu_torch.ops import plain_versions

    x = torch.from_numpy(image).permute(2, 0, 1)[None].contiguous().cuda()
    rc, rm = RATIOS[0]
    with torch.no_grad():
        reset_launches()
        router = model.route(x, rc, rm)
        lat_k = model.latent(x, router)
        enc = model.encode(x, rc, rm)
        rec_k = model.decode_indices(enc.indices, enc.router.masks)
        torch.cuda.synchronize()
        launched = read_launches()
        with plain_versions():
            lat_p = model.latent(x, router)
            rec_p = model.decode_indices(enc.indices, enc.router.masks)
        torch.cuda.synchronize()
    if read_launches() != launched:
        raise AssertionError("a kernel launched inside plain_versions()")
    if not all(launched.values()):
        raise AssertionError(f"the kernel run missed a kernel: {launched}")
    err = lambda a, b: (a.float() - b.float()).abs().max().item()
    return {"latent_max_abs_err": err(lat_k, lat_p),
            "latent_rel_err": err(lat_k, lat_p) / lat_p.abs().max().item(),
            "recon_max_abs_err": err(rec_k, rec_p),
            "recon_rel_err": err(rec_k, rec_p) / rec_p.float().abs().max().item(),
            "launches_with_kernels": launched}


def phase_kodak_f32(codec, image) -> None:
    """Kodak shape in float32 (TF32 off): kernels against plain versions on
    the card, within 1e-3 absolute and relative; the same comparison of the
    bf16 codec is printed for information."""
    import torch

    from control_gic_tpu_torch.models import CGIC, CGICConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    model = CGIC(CGICConfig(dtype="float32"),
                 generator=torch.Generator().manual_seed(1)).cuda().eval()
    f32 = kernels_vs_plain(model, image)
    del model
    bf16 = kernels_vs_plain(codec.model, image)
    log("kodak f32 kernels vs plain", tol=1e-3, **f32,
        seconds=time.perf_counter() - t0)
    log("kodak bf16 kernels vs plain (information)", **bf16)
    for key in ("latent", "recon"):
        if not (f32[f"{key}_max_abs_err"] <= 1e-3
                and f32[f"{key}_rel_err"] <= 1e-3):
            raise AssertionError(f"Kodak f32 {key}: kernels differ from the "
                                 f"plain versions: {f32}")


def main() -> None:
    import tempfile

    from control_gic_tpu_torch.cli.common import build_codec

    t_start = time.perf_counter()
    dev = phase_device()
    phase_build()
    rows = phase_kernels(dev)
    t0 = time.perf_counter()
    codec = build_codec(device="cuda", seed=0)
    assert codec.model.config.dtype == "bfloat16", codec.model.config
    log("main path setup", params=sum(p.numel()
                                      for p in codec.model.parameters()),
        dtype=codec.model.config.dtype, seconds=time.perf_counter() - t0)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        _, images = phase_main_path(dev, codec, workdir, IMAGE, 4)
        phase_profile(dev, codec, images[:2], "256x256")
        launches, kodak = phase_main_path(dev, codec, workdir, KODAK, 2)
        phase_profile(dev, codec, kodak[:1], "512x768")
    phase_f32_parity(make_image(0))
    phase_kodak_f32(codec, kodak[0])
    del codec

    main_rows = {
        "flash_attn_fwd": next(r for r in rows if r["kernel"] == "flash_attn_fwd"
                               and r["shape"] == [1, 24576, 24576, 512]),
        "norm_conv_chain": next(r for r in rows if r["kernel"] == "norm_conv_chain"),
        "gn_moments": next(r for r in rows if r["kernel"] == "gn_moments"),
    }
    kodak_launches = {"flash_attn_fwd": launches["flash_attn_fwd"],
                      "norm_conv_chain": launches["chain_gn"] + launches["chain_sn"],
                      "gn_moments": launches["gn_moments"]}
    kernels = [dict(name=name, **KERNELS[name],
                    launches=kodak_launches[name],
                    max_abs_err=main_rows[name]["max_abs_err"],
                    ms=main_rows[name]["ms"],
                    plain_ms=main_rows[name]["plain_ms"],
                    bound_ms=main_rows[name]["bound_ms"],
                    bound_by=main_rows[name]["bound_by"],
                    library_ms=main_rows[name]["library_ms"])
               for name in KERNELS]
    log("total", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev["name"], "count": dev["count"]}}),
        flush=True)


if __name__ == "__main__":
    main()
