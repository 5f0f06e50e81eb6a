"""The port's bf16 flash-attention backward on a CUDA card: agreement, times,
and which part bounds it.

    python3 tools/torch_attn_bwd_ablation.py            # every variant
    python3 tools/torch_attn_bwd_ablation.py full       # named variants only

Variant "full" is the kernel as it is (`kernels/flash_attn_bwd.cu`,
`flash_bwd_dkdv_bf16_kernel`, `flash_bwd_dq_bf16_kernel`): at the training
step's shapes and at ragged ones it checks dq, dk and dv against autograd
of `attention_reference` (max |kernel - plain| <= 2e-2 max(1, max |plain|))
and that two launches give equal bits, and prints the ptxas report of the
bf16 instantiations. Every variant times the dk/dv and the dq launch with
CUDA events (20 launches after 3 warm-ups) at the training shapes; "full"
also times SDPA forward + backward and the port's plain backward there. The
other variants take one part of the kernels out (the S and dP products, the
accumulating products, the loads of the streamed boxes) or change when the
loads are waited for and refilled (wait_first, tile_refill):
each is built from a copy of the package in a temporary directory (the
checkout is not touched) and run in its own process. Their outputs are wrong
by design; only their times mean something. Prints one JSON line per
variant, and the card's name and power limit.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join("control_gic_tpu_torch", "kernels", "flash_attn_bwd.cu")
# variant -> [(text of the kernel source, its replacement)]
VARIANTS = {
    "full": [],
    # the S and dP product waits for all of a step's boxes before its first
    # product, instead of a group a box as each box arrives
    "wait_first": [("""  fence_regs(x);
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    ring.wait(g0 + j);
    __syncwarp();   // wgmma is .aligned: the warp converged
    wgmma_fence();
""", """  for (int j = 0; j < NB; ++j) ring.wait(g0 + j);
  __syncwarp();
  fence_regs(x);
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < NB; ++j) {
""")],
    # each accumulating product waited for (wait_group 0) and its box
    # refilled at once, instead of pipelined products and refills after the
    # last one
    "tile_refill": [("""  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int m = 0; m < NT; ++m) {
""", """  fence_regs(acc);
#pragma unroll
  for (int m = 0; m < NT; ++m) {
    wgmma_fence();
"""), ("""    wgmma_commit();
    wgmma_wait<1>();
    if (m > 0) ring.arrive(g0 + m - 1);
  }
  wgmma_wait<0>();
  fence_regs(acc);
  ring.arrive(g0 + NT - 1);
  for (int m = 0; m < NT; ++m) ring.refill(g0 + m, leader);
}""", """    wgmma_commit();
    wgmma_wait<0>();
    ring.arrive(g0 + m);
    ring.refill(g0 + m, leader);
  }
  fence_regs(acc);
}""")],
    # no wait for a ring box and no refill: what the products and the
    # hand-offs take without the loads (the boxes hold stale data)
    "no_loads": [("""  __device__ __forceinline__ void wait(int g) const {
    mbar_wait(full + 16 * (g % R), (g / R) & 1);
  }""", """  __device__ __forceinline__ void wait(int g) const {}"""),
                 ("""    mbar_wait(empty + 16 * (g % R), (g / R) & 1);
    __syncwarp();
    load(g + R, leader && g + R < total);""", """    __syncwarp();""")],
    "no_scores": [("      wgmma_ss<0>(x, kRingA ? dr : dw, kRingA ? dw : dr, j + kc > 0);",
                   "      (void)dr;\n      (void)dw;")],
    "no_accumulate": [("      wgmma_ss<1>(acc[m], desc_sw128(ra + kk * 2048, ring.box, 1024),\n"
                       "                  desc_nosw(wa + kk * 2 * wl, wl, 128), 1);",
                       "      (void)ra;\n      (void)wa;")],
    "no_products": [("      wgmma_ss<0>(x, kRingA ? dr : dw, kRingA ? dw : dr, j + kc > 0);",
                     "      (void)dr;\n      (void)dw;"),
                    ("      wgmma_ss<1>(acc[m], desc_sw128(ra + kk * 2048, ring.box, 1024),\n"
                     "                  desc_nosw(wa + kk * 2 * wl, wl, 128), 1);",
                     "      (void)ra;\n      (void)wa;")],
}
# neither loads nor products: the hand-offs, the exp and ds arithmetic and
# the epilogue alone
VARIANTS["handoffs_only"] = VARIANTS["no_loads"] + VARIANTS["no_products"]
# (B, Tq, Tk, C): the bf16 training step's attentions, then ragged edges
# of the tiles (owned keys and query steps +-1, Tq != Tk)
TIMED = [(2, 4096, 4096, 512), (2, 4096, 4096, 256)]
CHECKED = TIMED + [(1, 4095, 4097, 512), (1, 4097, 4063, 256),
                   (2, 1024, 4096, 512), (1, 100, 130, 64), (3, 65, 33, 16),
                   (1, 300, 4096, 384), (1, 63, 65, 128)]
TOL = 2e-2


def _events_ms(fn, iters=20, warmup=3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def _inputs(b, tq, tk, c, seed):
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    r = lambda *s, sc=1.0: (sc * torch.randn(*s, device="cuda", generator=g)
                            ).to(torch.bfloat16)
    return r(b, tq, c, sc=2.0), r(b, tk, c), r(b, tk, c), r(b, tq, c)


def run(variant: str) -> dict:
    """Times (and for "full" checks) the kernels with the package on
    sys.path; returns the variant's record."""
    import torch
    import torch.nn.functional as F

    from control_gic_tpu_torch.kernels import build
    from control_gic_tpu_torch.ops import attention as A

    torch.backends.cuda.matmul.allow_tf32 = False
    build.load("flash_attn_bwd")
    rec = {"variant": variant}
    report = build.BUILD_LOG.get("flash_attn_bwd", (0, ""))[1]
    rec["ptxas_bf16"] = {}
    for block in report.split("Compiling entry function '")[1:]:
        name = block.split("'", 1)[0]
        if "_bf16_" in name:
            short = name.split("flash_bwd_")[1].split("EE")[0]
            rec["ptxas_bf16"][short] = [
                line.strip() for line in block.splitlines()
                if "registers" in line or "spill" in line]
    rec["serialized"] = [
        line.split("Performance Loss: ")[-1].replace("wgmma.mma_async instructions are "
                                                       "serialized due to ", "")
        for line in report.splitlines() if "serializ" in line.lower()]
    if variant == "full":
        errs = {}
        for b, tq, tk, c in CHECKED:
            q, k, v, do = _inputs(b, tq, tk, c, tq + tk + c)
            o, lse = A.flash_attention(q, k, v, return_lse=True)
            got = A.flash_attention_backward(q, k, v, o, lse, do)
            again = A.flash_attention_backward(q, k, v, o, lse, do)
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            want = torch.autograd.grad(A.attention_reference(*leaves), leaves,
                                       do)
            e = {n: ((g.float() - w.float()).abs().max()
                     / max(1.0, w.float().abs().max().item())).item()
                 for n, g, w in zip(("dq", "dk", "dv"), got, want)}
            e["bit_stable"] = all(torch.equal(x, y) for x, y in zip(got, again))
            errs[f"{b},{tq},{tk},{c}"] = e
            del q, k, v, do, o, lse, got, again, leaves, want
        rec["rel_err"] = errs
        rec["ok"] = all(e["bit_stable"] and max(e["dq"], e["dk"], e["dv"])
                        <= TOL for e in errs.values())
    for b, tq, tk, c in TIMED:
        q, k, v, do = _inputs(b, tq, tk, c, 5)
        o, lse = A.flash_attention(q, k, v, return_lse=True)
        _, _, delta = A.flash_attention_backward_dkdv(q, k, v, o, lse, do)
        row = {
            "lse_fwd_ms": _events_ms(lambda: A.flash_attention(
                q, k, v, return_lse=True)),
            "dkdv_ms": _events_ms(lambda: A.flash_attention_backward_dkdv(
                q, k, v, o, lse, do)),
            "dq_ms": _events_ms(lambda: A.flash_attention_backward_dq(
                q, k, v, do, lse, delta))}
        if variant == "full":
            q4, k4, v4, do4 = (t[:, None] for t in (q, k, v, do))
            l4 = [t.detach().requires_grad_() for t in (q4, k4, v4)]
            row["sdpa_fwd_bwd_ms"] = _events_ms(lambda: torch.autograd.grad(
                F.scaled_dot_product_attention(*l4), l4, do4))
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            ref = A.attention_reference(*leaves)
            row["plain_bwd_ms"] = _events_ms(lambda: torch.autograd.grad(
                ref, leaves, do, retain_graph=True))
            del ref, leaves, l4
        rec[f"{b},{tq},{tk},{c}"] = row
        del q, k, v, do, o, lse, delta
    return rec


def main() -> None:
    if len(sys.argv) > 1 and sys.argv[1] == "--one":
        print(json.dumps(run(sys.argv[2])), flush=True)
        return
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    names = sys.argv[1:] or list(VARIANTS)
    ok = True
    for name in names:
        with tempfile.TemporaryDirectory(prefix="attn_bwd_ablation_") as tmp:
            root = ROOT
            if VARIANTS[name]:
                root = os.path.join(tmp, "repo")
                shutil.copytree(os.path.join(ROOT, "control_gic_tpu_torch"),
                                os.path.join(root, "control_gic_tpu_torch"),
                                ignore=shutil.ignore_patterns("_build"))
                path = os.path.join(root, SOURCE)
                with open(path) as f:
                    text = f.read()
                for old, new in VARIANTS[name]:
                    if text.count(old) != 1:
                        raise SystemExit(f"{name}: {old!r} not found once")
                    text = text.replace(old, new)
                with open(path, "w") as f:
                    f.write(text)
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--one", name],
                cwd=root, env={**os.environ, "PYTHONPATH": root},
                capture_output=True, text=True, timeout=900)
            if proc.returncode != 0:
                print(f"{name}: failed ({proc.returncode})\n"
                      f"{proc.stdout[-4000:]}\n{proc.stderr[-6000:]}",
                      flush=True)
                ok = False
                continue
            line = proc.stdout.strip().splitlines()[-1]
            print(line, flush=True)
            ok = ok and json.loads(line).get("ok", True)
    if not ok:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
