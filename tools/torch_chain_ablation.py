"""Which part bounds the port's bf16 chained norm+conv kernel, on a CUDA card.

    python3 tools/torch_chain_ablation.py

No device counter is readable on the card's machine, so this times the
kernel (`kernels/norm_conv_chain.cu`, `chain_kernel_wgmma`) at the codec's
shapes with one part of it taken out at a time: the activation transform
(the tile stays zero), the wgmma products, the cp.async loads of x, the
output stores. Each variant is built from a copy of the package in a
temporary directory (the checkout is not touched) and timed in its own
process with CUDA events, 20 launches after 3 warm-ups. The outputs of the
variants are wrong by design; only the times mean something. Prints one
line per variant, and the card's name and power limit.
"""
from __future__ import annotations

import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join("control_gic_tpu_torch", "kernels", "norm_conv_chain.cu")
# variant -> (text of the kernel, its replacement)
VARIANTS = {
    "full": [],
    "no_transform": [(
        "      if (y >= 0 && y < H && xx >= 0 && xx < W) {\n"
        "        const int ch = c * KC + 8 * j;",
        "      if (false) {\n        const int ch = c * KC + 8 * j;")],
    "no_products": [("          wgmma_ss(acc[mb], da, db);\n",
                     "          (void)da;\n          (void)db;\n")],
    "no_x_loads": [("    const uint32_t dst = raw0 + (c % RS) * K::RAW;\n",
                    "    const uint32_t dst = raw0 + (c % RS) * K::RAW;\n"
                    "    if (c >= 0) return;\n")],
    "no_stores": [("        *reinterpret_cast<uint4*>(out + o) = "
                   "make_uint4(pk[0], pk[1], pk[2], pk[3]);\n", "")],
}
# (norm form, Cin, Cout, H, W, residual, moments): the Kodak path's GN
# 128->128, the per-call decoder mid, the narrow conv_out
ROWS = [("gn", 128, 128, 512, 768, True, True),
        ("sn", 256, 256, 256, 384, True, True),
        ("sn", 512, 512, 192, 192, False, False),
        ("sn", 128, 3, 512, 768, False, False),
        ("sn", 128, 3, 768, 768, False, False)]


def time_rows() -> str:
    """Times every row with the package on sys.path; one line."""
    import torch

    from control_gic_tpu_torch.ops import fused_norm as FN
    from control_gic_tpu_torch.ops import norm_conv as NC

    out = []
    for form, cin, cout, h, w, res, emit in ROWS:
        g = torch.Generator(device="cuda").manual_seed(1)
        r = lambda *s, scale=1.0: scale * torch.randn(*s, device="cuda",
                                                      generator=g)
        x = r(1, cin, h, w).bfloat16()
        zq = r(1, 4, h, w).bfloat16() if form == "sn" else None
        mod = (dict(wy=r(cin, 4, scale=0.3), by=r(cin, scale=0.1),
                    wb=r(cin, 4, scale=0.3), bb=r(cin, scale=0.1))
               if form == "sn" else {})
        gs, gb = 1 + r(cin, scale=0.1), r(cin, scale=0.1)
        cw = r(cout, cin, 3, 3, scale=(9 * cin) ** -0.5)
        cb = r(cout, scale=0.1)
        rr = r(1, cout, h, w).bfloat16() if res else None
        stats = NC.stats_from_moments(FN.gn_moments_reference(x), h * w)
        fn = lambda: NC.chain_kernel(x, cw, cb, gs, gb, stats, rr, emit,
                                     True, zq, **mod)
        for _ in range(3):
            fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(20):
            fn()
        end.record()
        torch.cuda.synchronize()
        out.append(f"{form} {cin}->{cout} {h}x{w}: "
                   f"{start.elapsed_time(end) / 20:.4f} ms")
    return " | ".join(out)


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch_chain_ablation: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    with open(os.path.join(ROOT, SOURCE)) as f:
        original = f.read()
    for name, edits in VARIANTS.items():
        work = tempfile.mkdtemp(prefix="chain_ablation_")
        try:
            shutil.copytree(os.path.join(ROOT, "control_gic_tpu_torch"),
                            os.path.join(work, "control_gic_tpu_torch"),
                            ignore=shutil.ignore_patterns("_build",
                                                          "__pycache__"))
            text = original
            for old, new in edits:
                if old not in text:
                    raise SystemExit(f"{name}: the kernel source changed; "
                                     f"update VARIANTS")
                text = text.replace(old, new)
            with open(os.path.join(work, SOURCE), "w") as f:
                f.write(text)
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--time"],
                cwd=work, capture_output=True, text=True, timeout=900,
                env={**os.environ, "PYTHONPATH": work})
            if proc.returncode:
                raise SystemExit(f"{name} failed:\n{proc.stderr[-2000:]}")
            print(f"{name}: {proc.stdout.strip()}", flush=True)
        finally:
            shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    if sys.argv[1:] == ["--time"]:
        print(time_rows())
    else:
        main()
