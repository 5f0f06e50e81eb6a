"""Where the SpatialNorm apply and GroupNorm moment kernels spend their time,
on a CUDA card.

    python3 tools/torch_norm_ablation.py            # host, then every variant
    python3 tools/torch_norm_ablation.py host       # the wrappers' host time
    python3 tools/torch_norm_ablation.py full no_swish ...   # chosen variants

`host` times each wrapper's host work per call (the median of five runs of
100 calls with no synchronisation between them) and each piece of it alone: the
checks' tensor reads, the output allocation, the device and stream lookups,
the parameter pack lookup, the ctypes call with arguments the launcher
refuses (no launch), then the device kernels of one bf16 SpatialNorm under
CONTROL_GIC_FUSED_NORM=1, and, for comparison, the pieces the earlier wrappers
paid on every call (the torch.cuda.device context, torch.cuda.current_stream,
build.load under its lock, the torch group fold and the parameter casts).

A variant times both kernels (`kernels/spatial_norm_apply.cu`,
`kernels/gn_moments.cu`) at chip_smoke.py's APPLY_SHAPES and MOMENT_SHAPES
with one part changed: the apply without the swish, or without the loads of
f (a register value instead), the moment pass without its loads; or a
candidate design: the apply with plain stores, with __ldg loads, with 8
channels' loads in flight, or capped to fit 6 CTAs an SM; the moment pass
with four streaming loads in flight a thread. Each variant is built
from a copy of the package in a temporary directory (the checkout is not
touched) and timed in its own process: device µs per launch from
torch.profiler over 20 launches, and CUDA events over 20 launches after 3
warm-ups; beside each apply row, the device time of torch's copy of f (the
same bytes read and written). The outputs of `no_swish` and `no_loads` are wrong by design; only
their times mean something. Prints the card's name
and power limit, then one line per measurement.
"""
from __future__ import annotations

import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
APPLY = os.path.join("control_gic_tpu_torch", "kernels",
                     "spatial_norm_apply.cu")
MOMENTS = os.path.join("control_gic_tpu_torch", "kernels", "gn_moments.cu")
# variant -> [(source, text of the kernel, its replacement)]
VARIANTS = {
    "full": [],
    "no_swish": [(APPLY,
                  "  if (kSwish) v = __fdividef(v, 1.0f + __expf(-v));\n",
                  "")],
    "no_loads": [
        (APPLY, "ld_stream(f + ch * HW)",
         "make_uint4(threadIdx.x ^ ch, ch, threadIdx.x, 0x3f803f80u)"),
        (MOMENTS, "const uint4 u0 = __ldg(pv + i);",
         "const uint4 u0 = make_uint4((unsigned)i, 1u, 2u, 3u);"),
        (MOMENTS, "const uint4 u1 = __ldg(pv + i + kThreads);",
         "const uint4 u1 = make_uint4((unsigned)i, 5u, 6u, 7u);"),
        (MOMENTS, "if (i < nv) add_vec<T>(__ldg(pv + i), s1, s2);",
         "if (i < nv) add_vec<T>(make_uint4((unsigned)i, 1u, 1u, 1u), s1, "
         "s2);")],
    # candidates for the apply's streaming pass (its outputs are right)
    "apply_plain_stores": [(
        APPLY, "__stcs(reinterpret_cast<uint4*>(out + ch * HW), "
               "Vec<T>::pack(o));",
        "*reinterpret_cast<uint4*>(out + ch * HW) = Vec<T>::pack(o);")],
    "apply_ldg_loads": [(
        APPLY, """  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.L2::256B.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;""", "  return __ldg(reinterpret_cast<const uint4*>(p));")],
    "apply_8_in_flight": [(APPLY, "constexpr int kU = 4; ",
                           "constexpr int kU = 8; ")],
    "apply_min_6_ctas": [(APPLY, "__launch_bounds__(kThreads, 4)",
                          "__launch_bounds__(kThreads, 6)")],
    "moments_stream4": [(MOMENTS, """    // two loads in flight per thread per step
    for (; i + kThreads < nv; i += 2 * kThreads) {
      const uint4 u0 = __ldg(pv + i);
      const uint4 u1 = __ldg(pv + i + kThreads);
      add_vec<T>(u0, s1, s2);
      add_vec<T>(u1, s1, s2);
    }
    if (i < nv) add_vec<T>(__ldg(pv + i), s1, s2);""", """    for (; i + 3 * kThreads < nv; i += 4 * kThreads) {
      uint4 u[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        asm("ld.global.nc.L1::no_allocate.L2::256B.v4.u32 {%0, %1, %2, %3}, [%4];"
            : "=r"(u[k].x), "=r"(u[k].y), "=r"(u[k].z), "=r"(u[k].w)
            : "l"(pv + i + k * kThreads));
#pragma unroll
      for (int k = 0; k < 4; ++k) add_vec<T>(u[k], s1, s2);
    }
    for (; i < nv; i += kThreads) add_vec<T>(__ldg(pv + i), s1, s2);""")],
}
N = 20


def _smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()


def _smoke():
    import chip_smoke     # the checkout's, or with --time the copy's
    return chip_smoke


def _inputs(b, c, h, w, dtype):
    import torch
    g = torch.Generator(device="cuda").manual_seed(c + h + w)
    r = lambda *s, scale=1.0: scale * torch.randn(*s, device="cuda",
                                                  generator=g)
    x = (0.3 + r(b, c, h, w)).to(dtype)
    p = [1 + r(c, scale=0.1), r(c, scale=0.1), r(c, 4, scale=0.3),
         r(c, scale=0.1), r(c, 4, scale=0.3), r(c, scale=0.1)]
    return x, r(b, 4, h, w).to(dtype), p


def _us(v) -> str:
    """µs to two places; the profiler sometimes records no device events."""
    return "not measured" if v is None else f"{v:.2f} us"


def time_rows() -> None:
    """Device µs (profiler) and CUDA-event µs per launch of both kernels at
    the smoke shapes, with the package on sys.path; one line each."""
    import torch

    from control_gic_tpu_torch.ops import fused_norm as FN
    smoke = _smoke()
    for b, c, h, w, swish, dt in smoke.APPLY_SHAPES:
        x, zq, p = _inputs(b, c, h, w, getattr(torch, dt))
        mom = FN.gn_moments_reference(x)
        fn = lambda: FN.spatial_norm_apply_kernel(x, zq, *p, mom, swish)
        ev = 1e3 * smoke.cuda_time_ms(fn, iters=N, warmup=3)
        dev = smoke.device_us_per_launch(fn, N)
        # the same bytes through torch's copy: a floor that a streaming
        # pass on this card can reach
        out = torch.empty_like(x)
        copy = smoke.device_us_per_launch(lambda: out.copy_(x), N)
        print(f"apply {b}x{c}x{h}x{w} {dt} swish={swish}: device {_us(dev)}"
              f", events {ev:.2f} us; copy of f {_us(copy)}", flush=True)
    for b, c, h, w in smoke.MOMENT_SHAPES:
        x, _, _ = _inputs(b, c, h, w, torch.bfloat16)
        fn = lambda: FN.gn_moments_kernel(x)
        ev = 1e3 * smoke.cuda_time_ms(fn, iters=N, warmup=3)
        dev = smoke.device_us_per_launch(fn, N)
        lib = 1e3 * smoke.cuda_time_ms(
            lambda: torch.var_mean(x, dim=(2, 3), correction=0), iters=N,
            warmup=3)
        print(f"moments {b}x{c}x{h}x{w} bfloat16: device {_us(dev)}, "
              f"events {ev:.2f} us, torch.var_mean events {lib:.2f} us",
              flush=True)


def host() -> None:
    """Host µs per call of each wrapper and of each piece of its work."""
    import ctypes

    import torch

    from control_gic_tpu_torch.kernels import build
    from control_gic_tpu_torch.models.blocks import SpatialNorm
    from control_gic_tpu_torch.ops import fused_norm as FN
    smoke = _smoke()
    t = lambda fn: smoke.host_us(fn, 100)
    x, zq, p = _inputs(1, 128, 256, 384, torch.bfloat16)
    mom = FN.gn_moments_kernel(x)
    dev = x.device
    idx = x.get_device()
    fm = build.function("gn_moments", "cgic_gn_moments")
    fa = build.function("spatial_norm_apply", "cgic_spatial_norm_apply")
    norm = SpatialNorm(128, 4, torch.bfloat16).cuda()
    np_ = norm.params()
    f32 = lambda v: v.to(dev, torch.float32).contiguous()
    stats = FN.gn_stats_from_moments(mom, 256 * 384)

    def enter_device():
        with torch.cuda.device(dev):
            pass

    rows = {
        "gn_moments_kernel (wrapper)": lambda: FN.gn_moments_kernel(x),
        "spatial_norm_apply_kernel (wrapper, f32 params)":
            lambda: FN.spatial_norm_apply_kernel(x, zq, *p, mom, True),
        "spatial_norm_apply_kernel (wrapper, a bf16 SpatialNorm's params)":
            lambda: FN.spatial_norm_apply_kernel(x, zq, *norm.params(), mom,
                                                 True),
        "spatial_norm dispatch, use_fused (moments + apply)":
            lambda: FN.spatial_norm(x, zq, *p, act_swish=True,
                                    use_fused=True),
        "checks' tensor reads": lambda: (
            x.is_cuda, x.dtype, x.requires_grad, torch.is_grad_enabled(),
            x.dim(), x.numel(), x.is_contiguous(), x.shape, x.data_ptr()),
        "torch.empty((b, 2, c), f32)": lambda: torch.empty(
            (1, 2, 128), dtype=torch.float32, device=dev),
        "torch.empty_like(x)": lambda: torch.empty_like(x),
        "torch.cuda.current_device()": torch.cuda.current_device,
        "torch._C._cuda_getCurrentRawStream": lambda:
            torch._C._cuda_getCurrentRawStream(idx),
        "build.function": lambda: build.function("gn_moments",
                                                 "cgic_gn_moments"),
        "x.new_empty((b, 2, c), f32)": lambda: x.new_empty(
            (1, 2, 128), dtype=torch.float32),
        "torch._C._cuda_getDevice()": torch._C._cuda_getDevice,
        "struct pack of 11 int64": lambda: FN._APPLY_ARGS.pack(
            x.data_ptr(), zq.data_ptr(), mom.data_ptr(), mom.data_ptr(),
            x.data_ptr(), 0, 128, 256 * 384, 1, 1, 0),
        "ctypes moments call, refused (no launch)": lambda: fm(
            FN._MOMENT_ARGS.pack(x.data_ptr(), mom.data_ptr(), 0, 128,
                                 256 * 384, 1, 0)),
        "ctypes moments call, launched": lambda: fm(FN._MOMENT_ARGS.pack(
            x.data_ptr(), mom.data_ptr(), 1, 128, 256 * 384, 1,
            torch._C._cuda_getCurrentRawStream(idx))),
        "ctypes apply call, refused (no launch)": lambda: fa(
            FN._APPLY_ARGS.pack(x.data_ptr(), zq.data_ptr(), mom.data_ptr(),
                                mom.data_ptr(), x.data_ptr(), 0, 128,
                                256 * 384, 1, 1, 0)),
        "_packed_params (a hit)": lambda: FN._packed_params(*p, dev),
        "SpatialNorm.params() (the views)": norm.params,
        "_packed_params (a hit, the SpatialNorm's views)":
            lambda: FN._packed_params(*np_, dev),
        "earlier: with torch.cuda.device(dev)": enter_device,
        "earlier: torch.cuda.current_stream(dev).cuda_stream": lambda:
            torch.cuda.current_stream(dev).cuda_stream,
        "earlier: build.load (lock)": lambda: build.load("gn_moments"),
        "earlier: ctypes.c_void_p(ptr) x 5": lambda: [
            ctypes.c_void_p(x.data_ptr()) for _ in range(5)],
        "earlier: gn_stats_from_moments (torch fold)": lambda:
            FN.gn_stats_from_moments(mom, 256 * 384),
        "earlier: 8 casts of a bf16 SpatialNorm's params and stats":
            lambda: [f32(v) for v in (*stats, *np_)],
    }
    with torch.no_grad():          # the codec's inference runs so
        for name, fn in rows.items():
            print(f"host {name}: {t(fn):.2f} us", flush=True)
        # the device kernels of one bf16 SpatialNorm (+swish) under
        # CONTROL_GIC_FUSED_NORM=1, zq at a quarter of f's size
        f = (0.3 + torch.randn(1, 128, 64, 96, device=dev)).bfloat16()
        zq_small = torch.randn(1, 4, 16, 24, device=dev).bfloat16()
        os.environ["CONTROL_GIC_FUSED_NORM"] = "1"
        try:
            norm(f, zq_small, "swish")
            _, _, n, by_name = smoke.device_profile(
                lambda: norm(f, zq_small, "swish"))
        finally:
            del os.environ["CONTROL_GIC_FUSED_NORM"]
        print(f"one SpatialNorm forward, FUSED_NORM=1: {n} device kernels: "
              f"{sorted(by_name)}", flush=True)


def main(names) -> None:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch_norm_ablation: needs a CUDA card")
    print(_smi(), flush=True)
    sys.path.insert(0, ROOT)
    if not names or "host" in names:
        host()
    names = [n for n in names if n != "host"] or (list(VARIANTS)
                                                  if not names else [])
    sources = {}
    for src in (APPLY, MOMENTS):
        with open(os.path.join(ROOT, src)) as f:
            sources[src] = f.read()
    for name in names:
        work = tempfile.mkdtemp(prefix="norm_ablation_")
        try:
            shutil.copytree(os.path.join(ROOT, "control_gic_tpu_torch"),
                            os.path.join(work, "control_gic_tpu_torch"),
                            ignore=shutil.ignore_patterns("_build",
                                                          "__pycache__"))
            shutil.copy(os.path.join(ROOT, "chip_smoke.py"), work)
            text = dict(sources)
            for src, old, new in VARIANTS[name]:
                if old not in text[src]:
                    raise SystemExit(f"{name}: {src} changed; update "
                                     f"VARIANTS")
                text[src] = text[src].replace(old, new)
            for src, body in text.items():
                with open(os.path.join(work, src), "w") as f:
                    f.write(body)
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--time"],
                cwd=work, capture_output=True, text=True, timeout=900,
                env={**os.environ, "PYTHONPATH": work})
            if proc.returncode:
                raise SystemExit(f"{name} failed:\n{proc.stdout[-2000:]}\n"
                                 f"{proc.stderr[-4000:]}")
            for line in proc.stdout.strip().splitlines():
                print(f"{name}: {line}", flush=True)
        finally:
            shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    if sys.argv[1:] == ["--time"]:
        time_rows()
    else:
        main(sys.argv[1:])
