"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases, each printing a line of its own:
  1. device: the card's name and power limit (nvidia-smi); fails without CUDA;
  2. build: compiles every CUDA kernel of the main paths from this checkout,
     one nvcc per source, all started together, and fails if ptxas reports
     a spill in a flash backward instantiation (f32 or bf16), a bf16
     chain instantiation (chain_kernel_wgmma<8|128|256>) or a SpatialNorm
     apply instantiation, whose registers it logs;
  3. kernels: each kernel against its plain PyTorch version on the card, at
     the shapes of the main paths, with its time, the device time per launch
     (profiler), the host time per call of its wrapper, the plain version's,
     the library call's and the bound; the flash rows also with the share of
     the bound, the forward's with its key splits; at the H-sharded
     codec's shapes (up to 196608 queries and keys) the forward is held on
     three slices of 1024 query rows and its plain version timed in chunks
     of queries;
  4. 256x256 path: the full-width codec (random weights from a seed, bf16)
     compresses 256x256 images through stream files in all 7 modes, with a
     receiver-only decode from the files and the kernel launch counts. The
     codec runs its batches as CUDA graphs (the default): a first run
     captures the programs (their launches counted once), a second replays
     them; the same runs through the same model with graphs=False give the
     same streams, reconstructions within 1e-3 and the same launches; then
     a profile of two round trips each way (wall, device busy, idle share,
     kernels per image, programs captured, capture seconds, memory
     reserved and the shared pool's bytes);
  5. Kodak path: the same codec on 512x768 (Kodak-shape) images in all 7
     modes, where the chained norm+conv and moment kernels engage and the
     decoder's unchained SpatialNorms run the moment pass and the apply
     kernel (the default dispatch), with the launch counts per image, graphs against eager as in phase 4, and a
     profile of one round trip each way;
  6. f32 parity at 256x256: the card (kernels) against the CPU (plain
     versions), same weights;
  7. Kodak f32: one 512x768 image through the f32 model on the card with the
     kernels against the same model under ops.plain_versions();
  8. training: the full-width f32 generator + discriminator step at 256x256,
     batch 2, through the train CLI's loop on synthetic batches: the first
     step's generator gradients with the kernels against the same step under
     ops.plain_versions(); 3 steps as CUDA graphs (the Trainer's default)
     with exact launch counts per step, and the same 3 steps from the same
     seed with graphs=False, both under deterministic algorithms: every
     loss within 1e-6 relative, every parameter, EMA tensor, Adam moment
     and running statistic within 1e-5 of its max (the largest differences
     logged); eval_step both ways, a checkpoint save and restore, ms per
     step both ways in turns, memory (the steps' peak above the resident
     state, the programs' pool), a profile of one step each way (device ms
     of the flash backward kernels, busy time, idle share); 3 steps with
     remat, adaptive_g_weight and disc_start=2 (two programs) both ways; 2
     steps and eval_step under a forced chain engagement both ways (the
     weight packs made inside the programs); then 2 bf16 steps both ways
     with the same checks, their first step's gradients against the plain
     versions (logged), ms per step and profiles; and the train CLI on PNGs
     when PIL is installed;
  9. 256x256 with CONTROL_GIC_FUSED_NORM=1: the phase-4 round trip under
     the switch (the default's launches: every norm there has a row
     block), launch counts and a profile;
 10. high-res tiled codec: cli/infer_highres.main on a 1356x2040 PNG (the
     DIV2K shape class; the CLI crops it to 1344x2032, 6 tiles of 768 px in 4
     shape groups) at full width in bf16 through the CLI's default path, the
     pipeline (parallel/tiling.compress_tiled_device), under the default
     switches, under CONTROL_GIC_CHAIN=0 + CONTROL_GIC_NORM_CONV=1 and under
     CONTROL_GIC_FUSED_NORM=1, each with bpp, PSNR, ms per image and exact
     launch counts, each profiled (kernels per image); then once with
     --no-pipeline (the per-tile path) under the default switches: the same
     launches, the same bpp to the last digit, PNGs within 1 of 255; then
     compress_tiled_device with float reconstructions, graphs against
     eager as in phase 4, each profiled;
 11. tile f32: one 768x768 tile through the f32 model with all three
     switches set, kernels against ops.plain_versions();
 12. entropy and pipeline (the phase-4 codec, full width, bf16): 256x256 in
     all 7 modes, encode(device_pack=True) streams byte-identical to the
     host coder's; eight 512x768 images from distinct seeds in 4 batches of
     2 through roundtrip_pipelined(device_pack=True, threads=True) and
     through serial encode_batch / decode_batch: the same streams, recons
     within 1e-3, exact launches (a launch serves a batch: 4 x phase 5's
     per-image counts each way), ms per image both ways, the stage seconds
     and a profile of the pipelined run; three 1356x2040 images (cropped to
     1344x2032 as the CLI does) through compress_tiled_device(threads=True)
     and compress_tiled per image: the same streams, exact launches (3 x
     the default's tiled counts), ms per image, stage seconds, a profile;
     entropy seconds per Kodak image with the C++ coder and the pure-Python
     coders (the phase fails unless the C++ coder is loaded). Both pipelines
     also run with graphs=False: the same streams, reconstructions within
     1e-3 and launches as with CUDA graphs, each profiled;
 13. the device-unpack receiver (CUDA graphs on), on the default codec
     (uniform counts: every code 10 bits) and a codec of the same model with
     skewed counts (codes up to 18 bits): the scan kernel against its plain
     loop on the card, the rank decoder and the host coder on two Kodak
     fine streams (symbols equal; ms of each); decode_batch(device_unpack=
     True) under CONTROL_GIC_UNPACK_IMPL=scan and =rank against the host
     receiver on a 256x256 batch of 4 in all 7 modes and a Kodak batch of 2
     (uint8 equal, floats within 1e-6, one scan launch per Huffman stream;
     ms per image and upload bytes both ways); roundtrip_pipelined and
     compress_tiled_device (one 1344x2032 image, the default codec) with
     device_unpack=True against False, uint8 equal, under both decoders;
     strict=True raising on a table with codes above 20 bits;
 14. data parallelism (f32, full width, 256x256; after phase 8): (a) the
     Trainer under an NCCL group of one rank, as CUDA graphs (the
     collectives captured) against graphs=False, 2 steps, both
     deterministic, launches per step exact, and ms per step with the group
     and without it in turns, of the Trainer and of the train CLI's loop;
     (b) two processes (this script with --dp-worker) in a gloo group,
     both on cuda:0, each stepping on 2 rows of a global batch of 4 with
     graphs=False, against this process's 2 steps on the whole batch,
     within DP_LIMITS: metrics, the step-1 gradients (relative L2), the
     codebook counters and the running statistics; rank 0's rows stepped
     alone without a group are a control that must fall outside every
     limit; the flash key splits at both batch sizes; ms per step both ways and the
     collectives' seconds per step; graphs=True under gloo raises; (c) the
     train CLI under torch.distributed.run with one process, 2 steps;
 15. the H-sharded codec (full width; after phase 7): (a) the f32 model on a
     512x768 image over 1, 2 and 4 shards on the card against the
     single-device model under ops.plain_versions() (masks equal, indices
     equal but for near-ties, the decode within 1e-3, one flash launch per
     attention and shard); (b) the bf16 codec on one 1536x2048 image
     through compress_spatial with 1 and 2 shards and decode_spatial from
     the stream files, beside the single-device and the tiled codec (bpp,
     PSNR, share of equal indices, exact flash launches and their shapes,
     each one that phase 3 held, ms per image,
     device busy and idle share, peak memory), then the CLI with --spatial
     --mesh-devices 1 on its PNG; (c) compress_tiled with a 2-device mesh
     on cuda:0 on phase 10's image: streams byte-identical to each tile
     encoded alone (the mesh's batch), masks equal to mesh=None's.
Phase 3 also holds the training kernels (the logsumexp forward, the dk/dv
and dq backward), the SpatialNorm apply and the per-call norm+conv, and the
gradients of the chain, the per-call op, the switched SpatialNorm and the
moment pass against their plain versions. The switches are set and restored
inside this process. Then the kernel JSON line, and last the device JSON
line. Any failure raises and the script exits non-zero without the last
line.
"""
from __future__ import annotations

import contextlib
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
    "flash_attn_fwd_lse": {
        "route": "cuda",
        "source": "control_gic_tpu_torch/kernels/flash_attn_fwd.cu",
        "replaces": "control_gic_tpu/ops/attention.py:125",
    },
    "flash_attn_bwd_dkdv": {
        "route": "cuda",
        "source": "control_gic_tpu_torch/kernels/flash_attn_bwd.cu",
        "replaces": "control_gic_tpu/ops/attention.py:200",
    },
    "flash_attn_bwd_dq": {
        "route": "cuda",
        "source": "control_gic_tpu_torch/kernels/flash_attn_bwd.cu",
        "replaces": "control_gic_tpu/ops/attention.py:244",
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
    "spatial_norm_apply": {
        "route": "cuda",
        "source": "control_gic_tpu_torch/kernels/spatial_norm_apply.cu",
        "replaces": "control_gic_tpu/ops/fused_norm.py:151",
    },
    "norm_conv": {
        "route": "cuda",
        "source": "control_gic_tpu_torch/kernels/norm_conv_chain.cu",
        "replaces": "control_gic_tpu/ops/norm_conv.py:79",
    },
    # the counterpart of a lax.scan, not of a Pallas kernel
    "huffman_scan": {
        "route": "cuda",
        "source": "control_gic_tpu_torch/kernels/huffman_scan.cu",
        "replaces": "control_gic_tpu/coding/huffman_decode_tpu.py:151",
    },
}
# shapes the main paths give the attention kernel: (B, Tq, Tk, C, dtype);
# 4096 tokens at 256x256, 24576 and 6144 at 512x768, 36864 on a 768-px tile;
# then the H-sharded codec's local queries against gathered keys (Tq =
# Tk / 2: the 2-shard Kodak latent)
ATTN_SHAPES = [(1, 4096, 4096, 512, "bfloat16"), (1, 4096, 4096, 256, "bfloat16"),
               (2, 4096, 4096, 512, "float32"), (1, 1024, 4096, 512, "bfloat16"),
               (1, 24576, 24576, 512, "bfloat16"), (1, 24576, 24576, 256, "bfloat16"),
               (1, 6144, 6144, 512, "bfloat16"), (1, 36864, 36864, 512, "bfloat16"),
               (1, 36864, 36864, 256, "bfloat16"),
               (1, 12288, 24576, 512, "bfloat16"),
               (1, 12288, 24576, 256, "bfloat16")]
ATTN_TOL = {"bfloat16": 2e-2, "float32": 1e-4}
# the H-sharded codec's flash calls on the 1536x2048 image of phase 15(b),
# whose latent levels are /4 (196608 tokens: C 512 in the decoder's mids,
# 256 in the encoder's fine head), /8 (49152, C 512) and /16 (12288, C
# 512): one shard attends all the tokens, each of two shards half of them
# to all; phase 15(b) fails on a shape that is not here or in ATTN_SHAPES
SPATIAL_ATTN_SHAPES = [(1, 196608, 196608, 512, "bfloat16"),
                       (1, 196608, 196608, 256, "bfloat16"),
                       (1, 49152, 49152, 512, "bfloat16"),
                       (1, 12288, 12288, 512, "bfloat16"),
                       (1, 98304, 196608, 512, "bfloat16"),
                       (1, 98304, 196608, 256, "bfloat16"),
                       (1, 24576, 49152, 512, "bfloat16"),
                       (1, 6144, 12288, 512, "bfloat16")]
# at those shapes the plain version's scores over every query would not
# fit: it is held on the first, a middle and the last CHECK_ROWS query
# rows against all the keys, and timed over all the queries in chunks of
# PLAIN_CHUNK rows (the rows of softmax attention are independent)
CHECK_ROWS = 1024
PLAIN_CHUNK = 4096
# the chain kernel's calls on the 512x768 path: (norm form, H, W, Cin, Cout,
# residual, emits moments, dtype); the f32 row is the parity path
CHAIN_SHAPES = [("gn", 512, 768, 128, 128, True, True, "bfloat16"),
                ("gn", 256, 384, 128, 256, False, True, "bfloat16"),
                ("gn", 256, 384, 256, 256, True, True, "bfloat16"),
                ("sn", 256, 384, 256, 256, True, True, "bfloat16"),
                ("sn", 512, 768, 256, 128, False, True, "bfloat16"),
                ("sn", 512, 768, 128, 128, True, True, "bfloat16"),
                ("sn", 512, 768, 128, 3, False, False, "bfloat16"),
                ("gn", 256, 384, 256, 256, True, True, "float32"),
                # the tiled path's 768-px tile (encoder level 0, decoder
                # level 0)
                ("gn", 768, 768, 128, 128, True, True, "bfloat16"),
                ("sn", 768, 768, 128, 128, True, True, "bfloat16")]
# the training kernels' shapes (B, Tq, Tk, C, dtype): the 256x256 batch-2
# training step's four attentions (C=512 in the decoder's mids, 256 in the
# encoder's fine head), in the recipe's f32 and in bf16; then ragged
# lengths and a Tq != Tk
TRAIN_ATTN_SHAPES = [(2, 4096, 4096, 512, "float32"),
                     (2, 4096, 4096, 256, "float32"),
                     (2, 4096, 4096, 512, "bfloat16"),
                     (2, 4096, 4096, 256, "bfloat16"),
                     (1, 4100, 4100, 512, "bfloat16"),
                     (1, 4100, 4100, 512, "float32"),
                     (2, 1024, 4096, 512, "float32")]
# chain gradient checks: one GroupNorm-form and one SpatialNorm-form Kodak
# shape, (form, H, W, Cin, Cout, residual), f32
CHAIN_GRAD_SHAPES = [("gn", 256, 384, 256, 256, True),
                     ("sn", 512, 768, 128, 128, True)]
# the moment pass's inputs on the 512x768 path: (B, C, H, W), bf16
MOMENT_SHAPES = [(1, 128, 512, 768), (1, 128, 256, 384), (1, 256, 256, 384),
                 (1, 256, 512, 768)]
# the SpatialNorm apply kernel's inputs at the decoder's unchained norms:
# (B, C, H, W, swish, dtype); a 768-px tile's decoder mids and their
# attention norm, the 768x496 tile's level-1 blocks, the 256x256 path's
# mids and level 0, and f32
APPLY_SHAPES = [(1, 512, 192, 192, True, "bfloat16"),
                (1, 512, 192, 192, False, "bfloat16"),
                (1, 256, 384, 248, True, "bfloat16"),
                (1, 512, 64, 64, True, "bfloat16"),
                (1, 128, 256, 256, True, "bfloat16"),
                (1, 512, 192, 192, True, "float32"),
                (1, 128, 256, 256, False, "float32")]
# the per-call norm+conv's calls on a 768-px tile with CONTROL_GIC_NORM_CONV=1
# (and CONTROL_GIC_CHAIN=0 for the trunks): (norm form, H, W, Cin, Cout,
# dtype); the decoder mids, the encoder fine head's blocks and conv_out, the
# decoder's norm_out + conv_out; then f32
NORM_CONV_SHAPES = [("sn", 192, 192, 512, 512, "bfloat16"),
                    ("gn", 192, 192, 256, 256, "bfloat16"),
                    ("gn", 192, 192, 256, 4, "bfloat16"),
                    ("sn", 768, 768, 128, 3, "bfloat16"),
                    ("gn", 192, 192, 256, 4, "float32"),
                    ("sn", 192, 192, 512, 512, "float32")]
# gradient checks of the per-call op (form, H, W, Cin, Cout) and of the
# switched SpatialNorm (B, C, H, W), f32
NORM_CONV_GRAD_SHAPES = [("sn", 192, 192, 512, 512), ("gn", 192, 192, 256, 4)]
APPLY_GRAD_SHAPES = [(1, 512, 64, 64), (1, 128, 256, 256)]
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


def host_us(fn, n: int = 20, rounds: int = 5) -> float:
    """Host µs per call of `fn`: time.perf_counter around n calls with no
    synchronisation between them, after a warm call; the median of `rounds`
    such runs (host time varies from run to run). It is the wrapper's own
    work (checks, allocation, launch), which CUDA events around a short
    kernel measure in its place."""
    import statistics

    import torch
    fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        runs.append((time.perf_counter() - t0) / n * 1e6)
        torch.cuda.synchronize()
    return statistics.median(runs)


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


@contextlib.contextmanager
def switches(**env):
    """Set the engagement switches (environment variables, read at call
    time) inside this process, and restore them on the way out."""
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _counters():
    from control_gic_tpu_torch.coding import huffman_decode_device as D
    from control_gic_tpu_torch.ops import attention as A
    from control_gic_tpu_torch.ops import fused_norm as FN
    from control_gic_tpu_torch.ops import norm_conv as NC
    return (A.KERNEL_LAUNCHES, NC.KERNEL_LAUNCHES, FN.KERNEL_LAUNCHES,
            D.KERNEL_LAUNCHES)


# the port's counter names -> the names of the kernels line
_FLASH_NAMES = {"flash_fwd": "flash_attn_fwd",
                "flash_fwd_lse": "flash_attn_fwd_lse",
                "flash_bwd_dkdv": "flash_attn_bwd_dkdv",
                "flash_bwd_dq": "flash_attn_bwd_dq"}


def reset_launches() -> None:
    for counts in _counters():
        counts.update({k: 0 for k in counts})


def read_launches() -> dict:
    flash, chain, moments, scan = _counters()
    return {**{_FLASH_NAMES[k]: v for k, v in flash.items()}, **chain,
            **moments, **scan}


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
    sources = sorted({os.path.basename(k["source"])[:-3]
                      for k in KERNELS.values()})
    with ThreadPoolExecutor(len(sources)) as pool:
        paths = list(pool.map(build.build, sources))
    for name in sources:
        build.load(name)
    for name, (secs, report) in build.BUILD_LOG.items():
        print(f"[ptxas {name}] {secs:.2f} s\n{report.strip()}", flush=True)
    log("build", seconds=round(time.perf_counter() - t0, 3), libraries=paths)
    if "flash_attn_bwd" in build.BUILD_LOG:
        report = build.BUILD_LOG["flash_attn_bwd"][1]
        entries = ptxas_entries(report)
        for dt in ("f32", "bf16"):
            found = {name: entry for name, entry in entries.items()
                     if f"_{dt}_" in name}
            log(f"ptxas {dt} backward", kernels=found,
                serialized=[line.strip() for line in report.splitlines()
                            if "serializ" in line and f"_{dt}_" in line])
            if len(found) != 8 or any(st or ld for _, st, ld in
                                      found.values()):
                raise AssertionError(f"{dt} backward instantiations: "
                                     f"expected 8 without spills, got "
                                     f"{found}")
    if "norm_conv_chain" in build.BUILD_LOG:
        chain = {name: entry for name, entry in ptxas_entries(
            build.BUILD_LOG["norm_conv_chain"][1]).items()
            if name.startswith("chain_kernel_wgmma")}
        log("ptxas bf16 chain", kernels=chain)
        if len(chain) != 3 or any(st or ld for _, st, ld in chain.values()):
            raise AssertionError(f"bf16 chain instantiations: expected 3 "
                                 f"without spills, got {chain}")
    if "spatial_norm_apply" in build.BUILD_LOG:
        apply = {name: entry for name, entry in ptxas_entries(
            build.BUILD_LOG["spatial_norm_apply"][1]).items()
            if "apply_kernel" in name}
        log("ptxas spatial_norm_apply", kernels=apply)
        if len(apply) != 12 or any(st or ld for _, st, ld in apply.values()):
            raise AssertionError(f"apply instantiations: expected 12 without "
                                 f"spills, got {apply}")


def ptxas_entries(report: str) -> dict:
    """kernel -> (registers, spill store bytes, spill load bytes) from a
    ptxas -v report; the flash backward's and the bf16 chain's templates by
    their short names (flash_bwd_dq_f32_kernel<8>, chain_kernel_wgmma<128>),
    others mangled."""
    import re
    out = {}
    for block in report.split("Compiling entry function '")[1:]:
        name = block.split("'", 1)[0]
        short = re.search(r"(flash_bwd_\w+?_kernel|chain_kernel_wgmma)"
                          r"ILi(\d+)E", name)
        if short:
            name = f"{short.group(1)}<{short.group(2)}>"
        regs = re.search(r"Used (\d+) registers", block)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", block)
        out[name] = (int(regs.group(1)) if regs else None,
                     int(spill.group(1)), int(spill.group(2)))
    return out


def attn_bound_ms(b, tq, tk, c, dtype, peaks) -> tuple:
    itemsize = 2 if dtype == "bfloat16" else 4
    return bound_ms(4.0 * b * tq * tk * c,
                    itemsize * (2 * b * tq * c + 2 * b * tk * c), dtype, peaks)


def phase_kernels(dev: dict) -> list:
    import torch
    import torch.nn.functional as F

    from control_gic_tpu_torch.ops import attention as A
    from control_gic_tpu_torch.utils.device import use_fp32_pipes

    use_fp32_pipes()
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
        dev_us = device_us_per_launch(lambda: A.flash_attention(q, k, v))
        plain_ms = cuda_time_ms(lambda: A.attention_reference(q, k, v))
        lib_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(
            q[:, None], k[:, None], v[:, None]))
        bms, bound_by = attn_bound_ms(b, tq, tk, c, dt, peaks)
        row = {"kernel": "flash_attn_fwd", "shape": [b, tq, tk, c],
               "dtype": dt, "max_abs_err": err, "tol": ATTN_TOL[dt],
               "ms": ms, "device_us": dev_us, "bound_share": bms / ms,
               "host_us": host_us(lambda: A.flash_attention(q, k, v)),
               "key_splits": flash_splits(b, tq, tk, c, dt),
               "plain_ms": plain_ms, "library_ms": lib_ms,
               "bound_ms": bms, "bound_by": bound_by,
               "card": dev["nvidia_smi"]}
        log("kernel flash_attn_fwd", **row)
        if not err <= ATTN_TOL[dt]:
            raise AssertionError(f"flash_attn_fwd disagrees with its plain "
                                 f"version at {row['shape']} {dt}: "
                                 f"max abs err {err} > {ATTN_TOL[dt]}")
        rows.append(row)
        del q, k, v, out, ref
    rows += spatial_attn_rows(dev, peaks, gen)
    rows += train_attn_rows(dev, peaks, gen)
    rows += chain_rows(dev, peaks, gen)
    rows += moment_rows(dev, peaks, gen)
    rows += apply_rows(dev, peaks, gen)
    rows += norm_conv_rows(dev, peaks, gen)
    chain_grad_checks(gen)
    switched_grad_checks(gen)
    return rows


def spatial_attn_rows(dev: dict, peaks, gen) -> list:
    """The flash forward at SPATIAL_ATTN_SHAPES against its plain version
    on query slices (CHECK_ROWS), with the kernel's, the chunked plain
    version's and SDPA's times; each timed over as many calls as fit in
    about a second and a half (at least one)."""
    import torch
    import torch.nn.functional as F

    from control_gic_tpu_torch.ops import attention as A

    def plain(q, k, v):
        return torch.cat([A.attention_reference(q[:, i:i + PLAIN_CHUNK], k, v)
                          for i in range(0, q.shape[1], PLAIN_CHUNK)], 1)

    def timed(fn):
        one = cuda_time_ms(fn, iters=1, warmup=1)
        reps = max(1, min(10, int(1500.0 / max(one, 1e-3))))
        return cuda_time_ms(fn, iters=reps, warmup=0), reps

    rows = []
    for b, tq, tk, c, dt in SPATIAL_ATTN_SHAPES:
        dtype = getattr(torch, dt)
        q = (2 * torch.randn(b, tq, c, device="cuda", generator=gen)).to(dtype)
        k = torch.randn(b, tk, c, device="cuda", generator=gen).to(dtype)
        v = torch.randn(b, tk, c, device="cuda", generator=gen).to(dtype)
        out = A.flash_attention(q, k, v)
        n = min(CHECK_ROWS, tq)
        slices = [slice(0, n), slice((tq - n) // 2, (tq + n) // 2),
                  slice(tq - n, tq)]
        err = max((out[:, s].float() - A.attention_reference(
            q[:, s], k, v).float()).abs().max().item() for s in slices)
        ms, reps = timed(lambda: A.flash_attention(q, k, v))
        dev_us = device_us_per_launch(lambda: A.flash_attention(q, k, v),
                                      n=min(5, reps))
        plain_ms, _ = timed(lambda: plain(q, k, v))
        q4, k4, v4 = q[:, None], k[:, None], v[:, None]
        backend = sdpa_backend(q4, k4, v4)
        lib_ms = (None if backend == "MATH" else      # [Tq, Tk] scores
                  timed(lambda: F.scaled_dot_product_attention(q4, k4,
                                                               v4))[0])
        bms, bound_by = attn_bound_ms(b, tq, tk, c, dt, peaks)
        row = {"kernel": "flash_attn_fwd", "shape": [b, tq, tk, c],
               "dtype": dt, "max_abs_err": err, "tol": ATTN_TOL[dt],
               "checked_query_rows": [[s.start, s.stop] for s in slices],
               "ms": ms, "timed_calls": reps, "device_us": dev_us,
               "bound_share": bms / ms, "host_us": None,
               "key_splits": flash_splits(b, tq, tk, c, dt),
               "plain_ms": plain_ms, "plain_chunk_rows": PLAIN_CHUNK,
               "library_ms": lib_ms, "library_backend": backend,
               "bound_ms": bms, "bound_by": bound_by,
               "card": dev["nvidia_smi"]}
        log("kernel flash_attn_fwd", **row)
        if not err <= ATTN_TOL[dt]:
            raise AssertionError(f"flash_attn_fwd disagrees with its plain "
                                 f"version at {row['shape']} {dt}: "
                                 f"max abs err {err} > {ATTN_TOL[dt]}")
        rows.append(row)
        del q, k, v, q4, k4, v4, out
        release()
    return rows


def device_us_per_launch(fn, n: int = 5):
    """Device time per call of `fn` from torch.profiler: every device kernel
    in a window of n calls (for the flash forward, the main kernel and,
    under split KV, the combine; for the dk/dv backward, the delta pre-pass
    and the kernel), over n; None where the profiler recorded no device
    events in three windows. The CUDA-event time around the wrapper also
    holds the wrapper's host work, which hides short kernels."""
    fn()
    for _ in range(3):   # a window now and then records no device events
        _, busy, _, by_name = device_profile(lambda: [fn() for _ in
                                                      range(n)])
        if busy is not None:
            return sum(by_name.values()) / n
    return None


def flash_splits(b, tq, tk, c, dt) -> int:
    """The key splits the forward takes at this shape on this card."""
    from control_gic_tpu_torch.kernels import build
    return build.load("flash_attn_fwd").cgic_flash_attn_splits(
        b, tq, tk, c, 1 if dt == "bfloat16" else 0)


def sdpa_backend(q4, k4, v4) -> str:
    """The SDPA backend torch picks for these inputs."""
    import torch
    choose = getattr(torch, "_fused_sdp_choice", None)
    if choose is None:
        return "not reported by this torch"
    from torch.nn.attention import SDPBackend
    return SDPBackend(choose(q4, k4, v4)).name


def train_attn_rows(dev: dict, peaks, gen) -> list:
    """The training kernels at TRAIN_ATTN_SHAPES: the lse forward against
    torch.logsumexp of the f32 logits, the backward kernels against autograd
    of attention_reference, each within OUT_TOL · max(1, max|plain|). The
    library yardstick is SDPA (forward, and forward + backward)."""
    import torch
    import torch.nn.functional as F

    from control_gic_tpu_torch.ops import attention as A

    rows = []
    for b, tq, tk, c, dt in TRAIN_ATTN_SHAPES:
        dtype = getattr(torch, dt)
        r = lambda *s, scale=1.0: (scale * torch.randn(
            *s, device="cuda", generator=gen)).to(dtype)
        q, k, v = r(b, tq, c, scale=2.0), r(b, tk, c), r(b, tk, c)
        do = r(b, tq, c)
        o, lse = A.flash_attention(q, k, v, return_lse=True)
        dk, dv, delta = A.flash_attention_backward_dkdv(q, k, v, o, lse, do)
        dq = A.flash_attention_backward_dq(q, k, v, do, lse, delta)
        torch.cuda.synchronize()
        logits = torch.matmul(q.float(), k.float().transpose(1, 2)) * c ** -0.5
        want_lse = torch.logsumexp(logits, dim=-1)
        del logits
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        ref = A.attention_reference(*leaves)
        want = torch.autograd.grad(ref, leaves, do, retain_graph=True)
        pairs = {"lse": (lse, want_lse), "out": (o, ref), "dq": (dq, want[0]),
                 "dk": (dk, want[1]), "dv": (dv, want[2])}
        errs = {key: rel_err(*pair) for key, pair in pairs.items()}
        abs_errs = {key: (got.float() - w.float()).abs().max().item()
                    for key, (got, w) in pairs.items()}
        del pairs
        dev_us = {
            "flash_attn_fwd_lse": device_us_per_launch(
                lambda: A.flash_attention(q, k, v, return_lse=True)),
            "flash_attn_bwd_dkdv": device_us_per_launch(
                lambda: A.flash_attention_backward_dkdv(q, k, v, o, lse, do)),
            "flash_attn_bwd_dq": device_us_per_launch(
                lambda: A.flash_attention_backward_dq(q, k, v, do, lse,
                                                      delta))}
        calls = {
            "flash_attn_fwd_lse": lambda: A.flash_attention(
                q, k, v, return_lse=True),
            "flash_attn_bwd_dkdv": lambda: A.flash_attention_backward_dkdv(
                q, k, v, o, lse, do),
            "flash_attn_bwd_dq": lambda: A.flash_attention_backward_dq(
                q, k, v, do, lse, delta)}
        host = {name: host_us(call) for name, call in calls.items()}
        ms = {"flash_attn_fwd_lse": cuda_time_ms(
                  lambda: A.flash_attention(q, k, v, return_lse=True)),
              "flash_attn_bwd_dkdv": cuda_time_ms(
                  lambda: A.flash_attention_backward_dkdv(q, k, v, o, lse,
                                                          do)),
              "flash_attn_bwd_dq": cuda_time_ms(
                  lambda: A.flash_attention_backward_dq(q, k, v, do, lse,
                                                        delta))}
        plain_ms = {
            "flash_attn_fwd_lse": cuda_time_ms(lambda: (
                A.attention_reference(q, k, v), torch.logsumexp(
                    torch.matmul(q.float(), k.float().transpose(1, 2))
                    * c ** -0.5, dim=-1))),
            "flash_attn_bwd_dkdv": cuda_time_ms(lambda: torch.autograd.grad(
                ref, leaves[1:], do, retain_graph=True)),
            "flash_attn_bwd_dq": cuda_time_ms(lambda: torch.autograd.grad(
                ref, leaves[:1], do, retain_graph=True))}
        del ref, want
        q4, k4, v4, do4 = (t[:, None] for t in (q, k, v, do))
        backend = sdpa_backend(q4, k4, v4)
        lib_fwd = cuda_time_ms(lambda: F.scaled_dot_product_attention(
            q4, k4, v4))
        l4 = [t.detach().requires_grad_() for t in (q4, k4, v4)]
        lib_fb = cuda_time_ms(lambda: torch.autograd.grad(
            F.scaled_dot_product_attention(*l4), l4, do4))
        item = q.element_size()
        io = item * (b * tq * c + 2 * b * tk * c)          # q, k, v
        mm = 2.0 * b * tq * tk * c                          # one product
        bounds = {
            "flash_attn_fwd_lse": bound_ms(2 * mm, io + item * b * tq * c
                                           + 4 * b * tq, dt, peaks),
            "flash_attn_bwd_dkdv": bound_ms(
                4 * mm + 2.0 * b * tq * c,
                io + item * (2 * b * tq * c + 2 * b * tk * c) + 8 * b * tq,
                dt, peaks),
            "flash_attn_bwd_dq": bound_ms(
                3 * mm, io + item * 2 * b * tq * c + 8 * b * tq, dt, peaks)}
        tol = OUT_TOL[dt]
        for name, err_keys in (("flash_attn_fwd_lse", ("lse", "out")),
                               ("flash_attn_bwd_dkdv", ("dk", "dv")),
                               ("flash_attn_bwd_dq", ("dq",))):
            err = max(errs[key] for key in err_keys)
            row = {"kernel": name, "shape": [b, tq, tk, c], "dtype": dt,
                   "max_abs_err": max(abs_errs[key] for key in err_keys),
                   "rel_err": err, "rel_errs": {key: errs[key] for key
                                                in err_keys},
                   "tol": tol, "ms": ms[name], "plain_ms": plain_ms[name],
                   "library_ms": lib_fwd if name == "flash_attn_fwd_lse"
                   else lib_fb,
                   "library": f"SDPA {'forward' if name.endswith('lse') else 'forward + backward'}, backend {backend}",
                   "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
                   "device_us": dev_us[name], "host_us": host[name],
                   "bound_share": bounds[name][0] / ms[name],
                   "card": dev["nvidia_smi"]}
            if name == "flash_attn_fwd_lse":
                row.update(key_splits=flash_splits(b, tq, tk, c, dt))
            else:   # the whole attention (lse forward + dk/dv + dq) beside
                # SDPA's forward + backward, which computes the same
                row.update(attention_fwd_bwd_ms=sum(ms.values()),
                           attention_vs_library=sum(ms.values()) / lib_fb)
            log(f"kernel {name}", **row)
            if not err <= tol:
                raise AssertionError(f"{name} disagrees with its plain "
                                     f"version: {row}")
            rows.append(row)
        del q, k, v, do, o, lse, dq, dk, dv, delta, leaves, l4, calls
    return rows


def chain_grad_checks(gen) -> None:
    """Gradients through the chain kernel (_ChainFn, stats from the moment
    kernel under _GnMomentsFn) against autograd of the plain versions, f32,
    at one Kodak shape of each norm form; and the moment pass's gradient."""
    import torch

    from control_gic_tpu_torch.ops import fused_norm as FN
    from control_gic_tpu_torch.ops import norm_conv as NC
    from control_gic_tpu_torch.ops import plain_versions

    for form, h, w, cin, cout, with_res in CHAIN_GRAD_SHAPES:
        r = lambda *s, scale=1.0: scale * torch.randn(*s, device="cuda",
                                                      generator=gen)
        inputs = dict(x=r(1, cin, h, w), gs=1 + r(cin, scale=0.1),
                      gb=r(cin, scale=0.1),
                      cw=r(cout, cin, 3, 3, scale=(9 * cin) ** -0.5),
                      cb=r(cout, scale=0.1))
        if with_res:
            inputs["res"] = r(1, cout, h, w)
        if form == "sn":
            inputs.update(zq_r=r(1, 4, h, w), wy=r(cin, 4, scale=0.3),
                          by=r(cin, scale=0.1), wb=r(cin, 4, scale=0.3),
                          bb=r(cin, scale=0.1))
        g_out, g_mom = r(1, cout, h, w), r(1, 2, cout, scale=1e-4)

        def grads():
            leaves = {n: t.detach().requires_grad_()
                      for n, t in inputs.items()}
            a = dict(leaves)
            if form == "sn":
                out, mom = NC.spatial_norm_conv_mom(
                    a["x"], a["zq_r"], a["gs"], a["gb"], a["wy"], a["by"],
                    a["wb"], a["bb"], a["cw"], a["cb"], res=a.get("res"))
            else:
                out, mom = NC.group_norm_conv_mom(
                    a["x"], a["gs"], a["gb"], a["cw"], a["cb"],
                    res=a.get("res"))
            return dict(zip(leaves, torch.autograd.grad(
                (out, mom), list(leaves.values()), (g_out, g_mom))))

        before = dict(NC.KERNEL_LAUNCHES), FN.KERNEL_LAUNCHES["gn_moments"]
        got = grads()
        key = "chain_sn" if form == "sn" else "chain_gn"
        if (NC.KERNEL_LAUNCHES[key] != before[0][key] + 1
                or FN.KERNEL_LAUNCHES["gn_moments"] != before[1] + 1):
            raise AssertionError("the chain gradient check missed a kernel")
        with plain_versions():
            want = grads()
        errs = {n: rel_err(got[n], want[n]) for n in want}
        log("chain gradient", form=form, shape=[1, cin, h, w], cout=cout,
            residual=with_res, rel_errs=errs, tol=OUT_TOL["float32"])
        if not max(errs.values()) <= OUT_TOL["float32"]:
            raise AssertionError(f"chain gradient disagrees: {errs}")
    x = torch.randn(1, 256, 512, 768, device="cuda", generator=gen,
                    requires_grad=True)
    g = torch.randn(1, 2, 256, device="cuda", generator=gen)
    got, = torch.autograd.grad(FN.gn_moments(x), x, g)
    want, = torch.autograd.grad(FN.gn_moments_reference(x), x, g)
    err = rel_err(got, want)
    log("moment gradient", shape=[1, 256, 512, 768], rel_err=err,
        tol=MOM_TOL["float32"])
    if not err <= MOM_TOL["float32"]:
        raise AssertionError(f"moment gradient disagrees: {err}")


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
               "mom_tol": MOM_TOL[dt], "ms": ms,
               "device_us": device_us_per_launch(kernel),
               "host_us": host_us(kernel), "plain_ms": plain_ms,
               "library_ms": lib_ms, "library": "F.conv2d, conv only",
               "bound_ms": bms, "bound_by": bound_by,
               "bound_share": bms / ms, "card": dev["nvidia_smi"]}
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
        # the same per-channel statistics from one read of x
        lib_ms = cuda_time_ms(lambda: torch.var_mean(x, dim=(2, 3),
                                                     correction=0))
        bms, bound_by = bound_ms(3.0 * x.numel(), 2 * x.numel() + 8 * b * c,
                                 "float32", peaks)
        row = {"kernel": "gn_moments", "shape": [b, c, h, w],
               "dtype": "bfloat16", "rel_err": err, "tol": MOM_TOL["bfloat16"],
               "max_abs_err": (got - want).abs().max().item(), "ms": ms,
               "device_us": device_us_per_launch(
                   lambda: FN.gn_moments_kernel(x)),
               "host_us": host_us(lambda: FN.gn_moments_kernel(x)),
               "plain_ms": plain_ms, "library_ms": lib_ms,
               "library": "torch.var_mean over (H, W), correction=0",
               "bound_ms": bms, "bound_by": bound_by,
               "bound_share": bms / ms, "card": dev["nvidia_smi"]}
        log("kernel gn_moments", **row)
        if not err <= MOM_TOL["bfloat16"]:
            raise AssertionError(f"gn_moments disagrees with its plain "
                                 f"version: {row}")
        rows.append(row)
    return rows


def _norm_inputs(r, c, h, w, dtype, modulate=True):
    """x, the norm parameters and (modulate) zq_r and the 1x1 convs."""
    out = dict(x=(0.3 + r(1, c, h, w)).to(dtype), gs=1 + r(c, scale=0.1),
               gb=r(c, scale=0.1))
    if modulate:
        out.update(zq_r=r(1, 4, h, w).to(dtype), wy=r(c, 4, scale=0.3),
                   by=r(c, scale=0.1), wb=r(c, 4, scale=0.3),
                   bb=r(c, scale=0.1))
    return out


def apply_rows(dev: dict, peaks, gen) -> list:
    """The SpatialNorm apply kernel at APPLY_SHAPES, fed the moments (as the
    moment pass gives them; the kernel folds them into the group stats),
    against its plain version spatial_norm_kernel_act on the torch fold of
    the same moments; no library call computes it."""
    import torch

    from control_gic_tpu_torch.ops import fused_norm as FN

    rows = []
    for b, c, h, w, swish, dt in APPLY_SHAPES:
        dtype = getattr(torch, dt)
        r = lambda *s, scale=1.0: scale * torch.randn(*s, device="cuda",
                                                      generator=gen)
        a = _norm_inputs(r, c, h, w, dtype)
        x, zq_r = a.pop("x"), a.pop("zq_r")
        mom = FN.gn_moments_reference(x)
        p = [a[k] for k in ("gs", "gb", "wy", "by", "wb", "bb")]
        kernel = lambda: FN.spatial_norm_apply_kernel(x, zq_r, *p, mom,
                                                      swish)
        plain = lambda: FN.spatial_norm_kernel_act(
            x, zq_r, *p, swish, FN.gn_stats_from_moments(mom, h * w))
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        err = rel_err(got, want)
        bms, bound_by = bound_ms(20.0 * x.numel(),
                                 x.element_size() * (2 * x.numel()
                                                     + zq_r.numel()),
                                 "float32", peaks)
        ms = cuda_time_ms(kernel)
        dev_us = device_us_per_launch(kernel)
        row = {"kernel": "spatial_norm_apply", "shape": [b, c, h, w],
               "swish": swish, "dtype": dt, "rel_err": err,
               "max_abs_err": (got.float() - want.float()).abs().max().item(),
               "tol": OUT_TOL[dt], "ms": ms, "device_us": dev_us,
               "host_us": host_us(kernel),
               "plain_ms": cuda_time_ms(plain), "library_ms": None,
               "bound_ms": bms, "bound_by": bound_by,
               "bound_share": bms / ms,
               "device_bound_share": (None if dev_us is None
                                      else 1e3 * bms / dev_us),
               "card": dev["nvidia_smi"]}
        log("kernel spatial_norm_apply", **row)
        if not err <= OUT_TOL[dt]:
            raise AssertionError(f"spatial_norm_apply disagrees with its "
                                 f"plain version: {row}")
        rows.append(row)
    return rows


def norm_conv_rows(dev: dict, peaks, gen) -> list:
    """The per-call norm+conv (the chain kernel with no residual and no
    moments) at NORM_CONV_SHAPES, stats given, against its plain version;
    the library yardstick is cuDNN's conv alone."""
    import torch
    import torch.nn.functional as F

    from control_gic_tpu_torch.ops import fused_norm as FN
    from control_gic_tpu_torch.ops import norm_conv as NC

    rows = []
    for form, h, w, cin, cout, dt in NORM_CONV_SHAPES:
        dtype = getattr(torch, dt)
        r = lambda *s, scale=1.0: scale * torch.randn(*s, device="cuda",
                                                      generator=gen)
        a = _norm_inputs(r, cin, h, w, dtype, form == "sn")
        x, zq_r = a.pop("x"), a.pop("zq_r", None)
        cw = r(cout, cin, 3, 3, scale=(9 * cin) ** -0.5)
        cb = r(cout, scale=0.1)
        stats = NC.stats_from_moments(FN.gn_moments_reference(x), h * w)
        mod = {k: a[k] for k in ("wy", "by", "wb", "bb") if k in a}
        kernel = lambda: NC.norm_conv_kernel(x, cw, cb, a["gs"], a["gb"],
                                             stats, True, zq_r, **mod)

        def plain():
            if form == "sn":
                return NC.chain_reference(x, zq_r, a["gs"], a["gb"],
                                          mod["wy"], mod["by"], mod["wb"],
                                          mod["bb"], cw, cb, stats=stats,
                                          emit_mom=False)
            return NC.plain_chain_reference(x, a["gs"], a["gb"], cw, cb,
                                            stats=stats, emit_mom=False)

        got, want = kernel(), plain()
        torch.cuda.synchronize()
        err = rel_err(got, want)
        cwd, cbd = cw.to(dtype), cb.to(dtype)
        lib_ms = cuda_time_ms(lambda: F.conv2d(x, cwd, cbd, padding=1))
        nbytes = x.element_size() * (cin * h * w + cout * h * w
                                     + 4 * h * w * (form == "sn")
                                     + 9 * cin * cout)
        bms, bound_by = bound_ms(2.0 * h * w * 9 * cin * cout, nbytes, dt,
                                 peaks)
        ms = cuda_time_ms(kernel)
        row = {"kernel": "norm_conv", "form": form, "shape": [1, cin, h, w],
               "cout": cout, "dtype": dt, "rel_err": err,
               "max_abs_err": (got.float() - want.float()).abs().max().item(),
               "tol": OUT_TOL[dt], "ms": ms,
               "device_us": device_us_per_launch(kernel),
               "host_us": host_us(kernel),
               "plain_ms": cuda_time_ms(plain), "library_ms": lib_ms,
               "library": "F.conv2d, conv only", "bound_ms": bms,
               "bound_by": bound_by, "bound_share": bms / ms,
               "card": dev["nvidia_smi"]}
        log("kernel norm_conv", **row)
        if not err <= OUT_TOL[dt]:
            raise AssertionError(f"norm_conv disagrees with its plain "
                                 f"version: {row}")
        rows.append(row)
    return rows


def switched_grad_checks(gen) -> None:
    """Gradients through the per-call op (_NormConvFn) and the switched
    SpatialNorm (_SpatialNormFn), kernels forward, against the same calls
    under plain_versions(), f32."""
    import torch

    from control_gic_tpu_torch.ops import fused_norm as FN
    from control_gic_tpu_torch.ops import norm_conv as NC
    from control_gic_tpu_torch.ops import plain_versions

    r = lambda *s, scale=1.0: scale * torch.randn(*s, device="cuda",
                                                  generator=gen)

    def check(label, inputs, fn, key, counts):
        g_out = None

        def grads():
            nonlocal g_out
            leaves = {n: t.detach().requires_grad_()
                      for n, t in inputs.items()}
            out = fn(leaves)
            if g_out is None:
                g_out = r(*out.shape)
            return dict(zip(leaves, torch.autograd.grad(
                out, list(leaves.values()), g_out)))

        before = counts[key]
        got = grads()
        if counts[key] != before + 1:
            raise AssertionError(f"the {label} gradient check missed its "
                                 f"kernel")
        with plain_versions():
            want = grads()
        errs = {n: rel_err(got[n], want[n]) for n in want}
        log(f"{label} gradient", rel_errs=errs, tol=OUT_TOL["float32"])
        if not max(errs.values()) <= OUT_TOL["float32"]:
            raise AssertionError(f"{label} gradient disagrees: {errs}")

    for form, h, w, cin, cout in NORM_CONV_GRAD_SHAPES:
        inputs = _norm_inputs(r, cin, h, w, torch.float32, form == "sn")
        inputs.update(cw=r(cout, cin, 3, 3, scale=(9 * cin) ** -0.5),
                      cb=r(cout, scale=0.1))
        if form == "sn":
            fn = lambda a: NC.spatial_norm_conv(
                a["x"], a["zq_r"], a["gs"], a["gb"], a["wy"], a["by"],
                a["wb"], a["bb"], a["cw"], a["cb"], use_fused=True)
        else:
            fn = lambda a: NC.group_norm_conv(a["x"], a["gs"], a["gb"],
                                              a["cw"], a["cb"],
                                              use_fused=True)
        check(f"norm_conv {form} {[1, cin, h, w]}->{cout}", inputs, fn,
              f"norm_conv_{form}", NC.KERNEL_LAUNCHES)
    for b, c, h, w in APPLY_GRAD_SHAPES:
        inputs = _norm_inputs(r, c, h, w, torch.float32)
        check(f"spatial_norm_apply {[b, c, h, w]}", inputs,
              lambda a: FN.spatial_norm(
                  a["x"], a["zq_r"], a["gs"], a["gb"], a["wy"], a["by"],
                  a["wb"], a["bb"], act_swish=True, use_fused=True),
              "spatial_norm_apply", FN.KERNEL_LAUNCHES)


RATIOS = [(0.1, 0.4), (0.0, 0.8), (0.3, 0.0), (0.5, 0.5),
          (1.0, 0.0), (0.0, 1.0), (0.0, 0.0)]   # the ratios of modes 0-6
IMAGE = (256, 256)
KODAK = (512, 768)
COUNTERS = ("flash_attn_fwd", "flash_attn_fwd_lse", "flash_attn_bwd_dkdv",
            "flash_attn_bwd_dq", "chain_gn", "chain_sn", "norm_conv_gn",
            "norm_conv_sn", "gn_moments", "spatial_norm_apply",
            "huffman_scan")


def launches_of(**counts) -> dict:
    """Every launch counter, 0 unless given."""
    assert set(counts) <= set(COUNTERS), counts
    return {k: counts.get(k, 0) for k in COUNTERS}


# launches per image: at 256x256 the encoder's head_fine mid and the
# decoder's three mids attend (4096 tokens) and nothing chains, so each of
# the decoder's 49 SpatialNorms (3 mids x 5, the trunk's 15 blocks x 2, 3
# level-3 attention norms, norm_out) runs the moment pass and the apply
# kernel; at 512x768 add the encoder's level-3 attentions and head_medium
# mid and the decoder's level-3 attentions, and the chained trunks (encoder
# levels 0-1 in the GroupNorm form, decoder levels 1-0 and norm_out in the
# SpatialNorm form), which leave the moment pass and the apply kernel 36 of
# the decoder's SpatialNorms (the mids' 15, level 4's 6, level 3's 9 and
# level 2's 6, under the 9M-element gate)
PER_IMAGE = {
    IMAGE: launches_of(flash_attn_fwd=4, gn_moments=49,
                       spatial_norm_apply=49),
    KODAK: launches_of(flash_attn_fwd=10, chain_gn=8, chain_sn=13,
                       gn_moments=40, spatial_norm_apply=36),
}
# 256x256 with CONTROL_GIC_FUSED_NORM=1: the same launches, every norm's
# shape having a row block
PER_IMAGE_FUSED_NORM = PER_IMAGE[IMAGE]
# launches per 256x256 batch-2 training step: the four attentions run as
# FlashAttentionFn (lse forward, dk/dv and dq backward); nothing chains
PER_TRAIN_STEP = launches_of(flash_attn_fwd_lse=4, flash_attn_bwd_dkdv=4,
                             flash_attn_bwd_dq=4)


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


def _max_diff(recs, want) -> float:
    import numpy as np
    return max(float(np.abs(np.asarray(a, np.float32)
                            - np.asarray(b, np.float32)).max())
               for a, b in zip(recs, want))


def graph_vs_eager(dev: dict, label: str, n: int, graph, eager,
                   streams_g, streams_e, recs_g, recs_e, launches_g,
                   launches_e, wall_g, wall_e) -> None:
    """Hold a path's run with CUDA graphs against the same inputs run
    eagerly (graphs=False): streams byte-identical, reconstructions within
    1e-3, launch counts equal; log both walls and the programs."""
    diff = _max_diff(recs_g, recs_e)
    log(f"graph vs eager {label}", images=n, streams_identical=(
        streams_g == streams_e), recon_max_abs_diff=diff,
        launches_equal=launches_g == launches_e, launches=launches_g,
        wall_ms_per_image_graph=1e3 * wall_g / n,
        wall_ms_per_image_eager=1e3 * wall_e / n,
        programs=graph._programs.stats(), card=dev["nvidia_smi"])
    if streams_g != streams_e:
        raise AssertionError(f"{label}: the streams with CUDA graphs differ "
                             "from the eager ones")
    if not diff <= 1e-3:
        raise AssertionError(f"{label}: the reconstructions with CUDA graphs "
                             f"differ from the eager ones by {diff}")
    if launches_g != launches_e:
        raise AssertionError(f"{label}: launches with CUDA graphs "
                             f"{launches_g}, eagerly {launches_e}")


def phase_main_path(dev: dict, codec, workdir: str, hw, n_mode0: int,
                    per_image=None, tag: str = "", eager=None):
    """The full-width codec through stream files: n_mode0 images in mode 0,
    then one in each of modes 1-6, each launching per_image (PER_IMAGE[hw]
    by default). After a warm-up image, a first run captures the programs
    of modes 1-6 (their launches counted once, as eagerly), a second run
    replays every program; with `eager` (the same model, graphs=False) the
    same runs eagerly, held against the replays. Returns the kernel launch
    counts of the replayed run and the images."""
    import numpy as np
    import torch

    from control_gic_tpu_torch.codec import EncodedImage

    label = f"{hw[0]}x{hw[1]}{tag}"
    per_image = PER_IMAGE[hw] if per_image is None else per_image
    images = [make_image(seed, hw) for seed in range(n_mode0)]
    runs = [(images[i], RATIOS[0]) for i in range(n_mode0)]
    runs += [(images[m % n_mode0], RATIOS[m]) for m in range(1, 7)]
    expected = {k: v * len(runs) for k, v in per_image.items()}
    codec.compress(images[0], *RATIOS[0])            # warm-up, not counted
    torch.cuda.synchronize()

    def path(c, name):
        reset_launches()
        results, stats = [], {}
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for i, (img, ratios) in enumerate(runs):
            out_dir = os.path.join(workdir, f"{label}_{name}_run{i}")
            results.append((out_dir,) + c.compress(
                img, *ratios, out_dir=out_dir,
                stats=stats if i < n_mode0 else None))
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = read_launches()
        if launches != expected:
            raise AssertionError(f"{label} {name}: kernel launches "
                                 f"{launches} for {len(runs)} images, "
                                 f"expected {expected}")
        return (results, launches, wall_s, stats,
                torch.cuda.max_memory_allocated() / 2 ** 30)

    _, _, capture_wall_s, _, _ = path(codec, "capture")
    results, launches, wall_s, stats, peak_gib = path(codec, "graph")

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
    per_mode0 = {k: 1e3 * v / n_mode0 for k, v in stats.items()}
    log(f"main path {label}", images=len(runs),
        modes=sorted({r[3].mode for r in results}), launches=launches,
        launches_per_image={k: v / len(runs) for k, v in launches.items()},
        peak_mem_gib=peak_gib, wall_ms_per_image=1e3 * wall_s / len(runs),
        capture_run_wall_ms_per_image=1e3 * capture_wall_s / len(runs),
        encode_ms=per_mode0["encode_s"],
        entropy_coding_ms=(per_mode0["entropy_s"] + per_mode0["files_s"]
                           + per_mode0["rebuild_s"]),
        decode_ms=per_mode0["decode_s"], ms_per_image_mode0=per_mode0,
        programs=codec._programs.stats(), card=dev["nvidia_smi"])
    if eager is not None:
        e_results, e_launches, e_wall_s, e_stats, _ = path(eager, "eager")
        e_mode0 = {k: 1e3 * v / n_mode0 for k, v in e_stats.items()}
        log(f"main path {label} eager", wall_ms_per_image=1e3 * e_wall_s
            / len(runs), encode_ms=e_mode0["encode_s"],
            decode_ms=e_mode0["decode_s"], ms_per_image_mode0=e_mode0,
            card=dev["nvidia_smi"])
        graph_vs_eager(dev, label, len(runs), codec, eager,
                       [r[3].streams for r in results],
                       [r[3].streams for r in e_results],
                       [r[1] for r in results], [r[1] for r in e_results],
                       launches, e_launches, wall_s, e_wall_s)
    return launches, images


def device_profile(run):
    """torch.profiler over `run()`: (host wall µs, device busy µs, device
    kernels, device µs by kernel name); busy is None when the profiler
    recorded no device events."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans, by_name = [], {}
    for e in prof.events():
        # a user annotation (Optimizer.step#Adam.step) spans its kernels
        # and the host gaps between them: not device work
        if (e.device_type == DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)):
            spans.append((e.time_range.start, e.time_range.end))
            name = e.name[:90]     # template names share long prefixes
            by_name[name] = by_name.get(name, 0.0) + e.time_range.elapsed_us()
    if not spans:
        return wall_us, None, 0, by_name
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):          # union of the device intervals
        if b > end:
            busy += b - max(a, end)
            end = b
    return wall_us, busy, len(spans), by_name


def _shares(by_name: dict, keys) -> dict:
    total = sum(by_name.values())
    return {key: sum(v for k, v in by_name.items() if key in k) / total
            for key in keys}


def phase_profile(dev: dict, codec, images, label: str, eager=None) -> None:
    """torch.profiler over mode-0 round trips of `images`: device busy and
    idle share of the host wall time, and device time by kernel; with
    `eager`, the same round trips eagerly (label + " eager")."""
    n = len(images)
    for c, name in ((codec, label), (eager, f"{label} eager")):
        if c is not None:
            log_profile(dev, name, n, *device_profile(
                lambda: [c.compress(img, *RATIOS[0]) for img in images]),
                programs=c._programs.stats())


def log_profile(dev: dict, label: str, n: int, wall_us, busy, kernels,
                by_name, programs=None) -> None:
    if busy is None:
        log(f"profile {label}", device_time="not measured (the profiler "
            "recorded no device events)", wall_ms_per_image=wall_us / n / 1e3,
            programs=programs)
        return
    # "flash_fwd_": every device kernel of the forward (the bf16 wgmma and
    # f32 kernels and the split-KV combine)
    shares = _shares(by_name, ("flash_fwd_", "chain_kernel",
                               "gn_moments_kernel", "apply_kernel"))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    log(f"profile {label}", images=n, wall_ms_per_image=wall_us / n / 1e3,
        device_busy_ms_per_image=busy / n / 1e3,
        device_idle_share=1.0 - busy / wall_us,
        device_kernels_per_image=kernels / n,
        flash_share_of_device_time=shares["flash_fwd_"],
        chain_share_of_device_time=shares["chain_kernel"],
        chain_device_ms_per_image=sum(
            v for k, v in by_name.items() if "chain_kernel" in k) / n / 1e3,
        moments_share_of_device_time=shares["gn_moments_kernel"],
        apply_share_of_device_time=shares["apply_kernel"],
        top_kernels_ms_per_image={k: v / n / 1e3 for k, v in top},
        programs=programs, card=dev["nvidia_smi"])


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
    from control_gic_tpu_torch.utils.device import use_fp32_pipes

    use_fp32_pipes()
    torch.set_num_threads(os.cpu_count() or 1)
    t0 = time.perf_counter()
    cpu = CGIC(CGICConfig(dtype="float32"),
               generator=torch.Generator().manual_seed(1)).eval()
    gpu = copy.deepcopy(cpu).cuda()
    x = torch.from_numpy(image).permute(2, 0, 1)[None].contiguous()
    rc, rm = RATIOS[0]
    before = A.KERNEL_LAUNCHES["flash_fwd"]
    with torch.no_grad():
        rg = gpu.route(x.cuda(), rc, rm)
        lat_g = gpu.latent(x.cuda(), rg)
        enc_g = gpu.encode(x.cuda(), rc, rm)
        rcpu = cpu.route(x, rc, rm)
        lat_c = cpu.latent(x, rcpu)
        enc_c = cpu.encode(x, rc, rm)
    assert A.KERNEL_LAUNCHES["flash_fwd"] > before, \
        "the f32 card run missed the kernel"

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


def kernels_vs_plain(model, image, per_image=None) -> dict:
    """One image's pre-VQ latent, and the decode of its indices and masks,
    through `model` with the kernels and under ops.plain_versions(); the
    launch counts of the plain run must stay where they were, and the
    kernel run must launch every kernel that per_image (PER_IMAGE[KODAK] by
    default) counts. Also the VQ indices of both latents, and those of the
    plain latent that differ from the kernels' by more than a near-tie."""
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
    per_image = PER_IMAGE[KODAK] if per_image is None else per_image
    if not all(launched[k] for k in per_image if per_image[k]):
        raise AssertionError(f"the kernel run missed a kernel: {launched}")
    err = lambda a, b: (a.float() - b.float()).abs().max().item()
    # indices: a latent error delta moves the distance gap of two codes by
    # at most 2 |delta| |c_i - c_j| <= 16 max|delta| max|c| over 4 dims
    cb = model.codebook.float()
    dist = lambda lat: ((lat[..., None] - cb.t()[None, :, None, None]) ** 2
                        ).sum(1)                         # [B, H, W, N]
    d_p = dist(lat_p.float())
    i_k, i_p = dist(lat_k.float()).argmin(-1), d_p.argmin(-1)
    gap = (d_p.gather(-1, i_k[..., None])
           - d_p.gather(-1, i_p[..., None]))[..., 0]
    near = 16 * err(lat_k, lat_p) * cb.abs().max().item() + 1e-7
    return {"indices_differing": int((i_k != i_p).sum()),
            "indices_differing_beyond_ties": int(((i_k != i_p)
                                                  & (gap > near)).sum()),
            "latent_max_abs_err": err(lat_k, lat_p),
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
    from control_gic_tpu_torch.utils.device import use_fp32_pipes

    use_fp32_pipes()
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


# the tiled phase: a 1356x2040 PNG (the DIV2K shape class), which the CLI's
# dataset crops to 1344x2032 (as the JAX CLI's does): 768-px tiles
# 768x768 (2), 768x496, 576x768 (2) and 576x496
HIGHRES = (1356, 2040)
TILE = 768
TILED_SETTINGS = {
    "default": {},
    "chain0_norm_conv1": {"CONTROL_GIC_CHAIN": "0",
                          "CONTROL_GIC_NORM_CONV": "1"},
    "fused_norm1": {"CONTROL_GIC_FUSED_NORM": "1"},
}
# launches per tile shape group (the tiles of one shape run as one batch:
# one encode and one decode), by setting and tile shape, from the gates on
# the full-width model's shapes:
#  - flash: the encoder's fine-head mid, the decoder's 3 mids and, where
#    H/8 x W/8 tokens are >= 4096 and JAX's blocks divide them, the
#    encoder's 2 level-3 attentions and medium-head mid and the decoder's 3
#    level-3 attentions; the 576x496 tile's fine head (17856 tokens) no
#    256-block divides;
#  - default: the chain where a trunk run of blocks reaches 9M elements per
#    sample with W a multiple of 16 (the encoder's levels 0-2 at 768x768,
#    levels 0-1 at 576x768, level 0 at 496 px wide; the decoder's levels
#    2-0 and norm_out, 1-0, 0), the moment pass at each chain's start, and
#    the moment pass and the apply kernel at every other SpatialNorm of the
#    decoder (49 less the chain's);
#  - CONTROL_GIC_CHAIN=0 + CONTROL_GIC_NORM_CONV=1: each of those convs,
#    plus the encoder fine head (2 blocks + conv_out, 192x192x256) and the
#    decoder mids (12 convs, 9.4-18.9M elements) as per-call ops, each with
#    its moment pass (48 calls on a 768x768 tile), and the default's
#    SpatialNorms that no per-call op takes;
#  - CONTROL_GIC_FUSED_NORM=1: the default's launches (its switched path
#    where a row block divides the plane, the default's elsewhere: level 4
#    of the 576x496 tile).
PER_TILE = {
    "default": {
        (768, 768): launches_of(flash_attn_fwd=10, chain_gn=12, chain_sn=19,
                                gn_moments=36, spatial_norm_apply=30),
        (768, 496): launches_of(flash_attn_fwd=4, chain_gn=4, chain_sn=7,
                                gn_moments=44, spatial_norm_apply=42),
        (576, 768): launches_of(flash_attn_fwd=10, chain_gn=8, chain_sn=13,
                                gn_moments=40, spatial_norm_apply=36),
        (576, 496): launches_of(chain_gn=4, chain_sn=7, gn_moments=44,
                                spatial_norm_apply=42)},
    "chain0_norm_conv1": {
        (768, 768): launches_of(flash_attn_fwd=10, norm_conv_gn=17,
                                norm_conv_sn=31, gn_moments=66,
                                spatial_norm_apply=18),
        (768, 496): launches_of(flash_attn_fwd=4, norm_conv_gn=4,
                                norm_conv_sn=7, gn_moments=53,
                                spatial_norm_apply=42),
        (576, 768): launches_of(flash_attn_fwd=10, norm_conv_gn=8,
                                norm_conv_sn=25, gn_moments=57,
                                spatial_norm_apply=24),
        (576, 496): launches_of(norm_conv_gn=4, norm_conv_sn=7,
                                gn_moments=53, spatial_norm_apply=42)},
}
PER_TILE["fused_norm1"] = PER_TILE["default"]
ALL_SWITCHES = {"CONTROL_GIC_CHAIN": "0", "CONTROL_GIC_NORM_CONV": "1",
                "CONTROL_GIC_FUSED_NORM": "1"}


def tiled_expected(setting: str, h: int, w: int) -> dict:
    """The launches of one h x w image (already /16) through the tiled
    codec under a setting: PER_TILE summed over its tile grid's shapes."""
    from control_gic_tpu_torch.parallel.tiling import tile_grid
    total = launches_of()
    for shape in {t[2:] for t in tile_grid(h, w, TILE)}:
        for k, v in PER_TILE[setting][shape].items():
            total[k] += v
    return total


def phase_tiled(dev: dict, codec, workdir: str, eager) -> dict:
    """Phase 10: the high-res CLI on one 1356x2040 PNG under each setting of
    TILED_SETTINGS through its default path (the pipeline), each after an
    untimed warm-up run (which captures the setting's programs), then once
    with --no-pipeline under the default
    switches; bpp, PSNR, ms per image and exact launches; a profile of each
    setting. Then, under the default switches, compress_tiled_device on
    the cropped image with float reconstructions, replayed CUDA graphs
    against `eager` (graphs=False), each profiled. Returns each setting's
    launches."""
    import numpy as np
    import torch
    from PIL import Image

    from control_gic_tpu_torch.cli import infer_highres
    from control_gic_tpu_torch.parallel.tiling import compress_tiled_device

    src = os.path.join(workdir, "highres")
    os.makedirs(src)
    h, w = HIGHRES
    img = make_image(500, (-(-h // 32) * 32, -(-w // 32) * 32))[:h, :w]
    Image.fromarray((img * 255).astype(np.uint8)).save(
        os.path.join(src, "div2k_shape.png"))
    ch, cw = h // 16 * 16, w // 16 * 16
    run = lambda out, *extra: infer_highres.main(
        ["-i", src, "-o", os.path.join(workdir, out), "--tile", str(TILE),
         "--ratios", "0.1", "0.4", *extra], codec=codec)
    run("hr_warmup")
    run("hr_warmup_per_tile", "--no-pipeline")
    torch.cuda.synchronize()
    launches, bpps = {}, {}
    for setting, env in [*TILED_SETTINGS.items(), ("no_pipeline", {})]:
        extra = ["--no-pipeline"] if setting == "no_pipeline" else []
        with switches(**env):
            if env:                 # capture the setting's programs, untimed
                run(f"hr_warmup_{setting}", *extra)
                torch.cuda.synchronize()
            reset_launches()
            t0 = time.perf_counter()
            (_, bpp, psnr, _), = run(f"hr_{setting}", *extra)
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0)
            launches[setting] = read_launches()
            bpps[setting] = bpp
            expected = tiled_expected(
                "default" if setting == "no_pipeline" else setting, ch, cw)
            log(f"tiled {setting}", image=[h, w], cropped_to=[ch, cw],
                tile=TILE, switches=env,
                path="per-tile" if extra else "pipeline", bpp=bpp,
                psnr_db=psnr, ms_per_image=ms, launches=launches[setting],
                stats=None if extra else codec.last_pipeline_stats,
                card=dev["nvidia_smi"])
            if launches[setting] != expected:
                raise AssertionError(f"tiled {setting}: launches "
                                     f"{launches[setting]}, expected "
                                     f"{expected}")
            if not (bpp > 0 and np.isfinite(psnr)):
                raise AssertionError(f"tiled {setting}: bpp {bpp}, PSNR "
                                     f"{psnr}")
            log_profile(dev, f"tiled {setting}", 1,
                        *device_profile(lambda: run("hr_prof", *extra)),
                        programs=codec._programs.stats())
    if bpps["no_pipeline"] != bpps["default"]:
        raise AssertionError(f"tiled: --no-pipeline bpp "
                             f"{bpps['no_pipeline']!r} != the pipeline's "
                             f"{bpps['default']!r}")
    png = lambda d: np.asarray(Image.open(os.path.join(
        workdir, d, f"000_{bpps['default']:0.5f}.png")), np.int16)
    diff = np.abs(png("hr_default") - png("hr_no_pipeline"))
    log("tiled pipeline vs per-tile", bpp=bpps["default"],
        png_max_abs_diff=int(diff.max()),
        png_values_differing=int((diff > 0).sum()),
        png_pixels_differing=int((diff > 0).any(-1).sum()))
    if diff.max() > 1:
        raise AssertionError(f"tiled: the pipeline's PNG differs from the "
                             f"per-tile path's by {int(diff.max())} of 255")

    # the CLI's default path eagerly, timed as the settings above
    reset_launches()
    t0 = time.perf_counter()
    (_, bpp_e, _, _), = infer_highres.main(
        ["-i", src, "-o", os.path.join(workdir, "hr_eager"), "--tile",
         str(TILE), "--ratios", "0.1", "0.4"], codec=eager)
    torch.cuda.synchronize()
    log("tiled default eager", ms_per_image=1e3 * (time.perf_counter() - t0),
        bpp=bpp_e, launches_equal=read_launches() == launches["default"],
        stats=eager.last_pipeline_stats, card=dev["nvidia_smi"])
    if bpp_e != bpps["default"] or read_launches() != launches["default"]:
        raise AssertionError("tiled: the CLI's eager run differs from its "
                             "run with CUDA graphs")

    img_u8 = [(img[:ch, :cw] * 255).astype(np.uint8)]
    device_run = lambda c: compress_tiled_device(c, img_u8, *RATIOS[0],
                                                 tile=TILE, out_uint8=False)
    device_run(codec)           # captures the float decode programs
    torch.cuda.synchronize()
    res = {}
    for name, c in (("graph", codec), ("eager", eager)):
        reset_launches()
        t0 = time.perf_counter()
        (rec, _, bundles), = device_run(c)
        torch.cuda.synchronize()
        res[name] = (rec, [b.streams for b in bundles], read_launches(),
                     time.perf_counter() - t0)
        if res[name][2] != tiled_expected("default", ch, cw):
            raise AssertionError(f"tiled {name}: launches {res[name][2]}")
    (rec_g, st_g, l_g, w_g), (rec_e, st_e, l_e, w_e) = res["graph"], \
        res["eager"]
    graph_vs_eager(dev, f"tiled {ch}x{cw}", 1, codec, eager, st_g, st_e,
                   [rec_g], [rec_e], l_g, l_e, w_g, w_e)
    for c, name in ((codec, "graph"), (eager, "eager")):
        log_profile(dev, f"tiled compress_tiled_device {name}", 1,
                    *device_profile(lambda: device_run(c)),
                    programs=c._programs.stats())
    return launches


def phase_tile_f32(image) -> None:
    """Phase 11: one 768x768 tile through the f32 model (TF32 off) with all
    three switches set, kernels against plain_versions(): recon and latent
    within 1e-3, the VQ indices equal except at near-ties."""
    import torch

    from control_gic_tpu_torch.models import CGIC, CGICConfig
    from control_gic_tpu_torch.utils.device import use_fp32_pipes

    use_fp32_pipes()
    t0 = time.perf_counter()
    model = CGIC(CGICConfig(dtype="float32"),
                 generator=torch.Generator().manual_seed(1)).cuda().eval()
    with switches(**ALL_SWITCHES):
        got = kernels_vs_plain(model, image, launches_of(
            flash_attn_fwd=1, norm_conv_gn=1, norm_conv_sn=1, gn_moments=1,
            spatial_norm_apply=1))
    del model
    torch.cuda.empty_cache()
    log("tile f32 kernels vs plain", tile=[TILE, TILE],
        switches=ALL_SWITCHES, tol=1e-3, **got,
        seconds=time.perf_counter() - t0)
    for key in ("latent", "recon"):
        if not (got[f"{key}_max_abs_err"] <= 1e-3
                and got[f"{key}_rel_err"] <= 1e-3):
            raise AssertionError(f"tile f32 {key}: kernels differ from the "
                                 f"plain versions: {got}")
    if got["indices_differing_beyond_ties"]:
        raise AssertionError(f"tile f32: VQ indices differ beyond near-ties: "
                             f"{got}")

# phase 12: the pipelined codec at the Kodak size, 4 batches of 2
PIPE_BATCHES, PIPE_BATCH = 4, 2
TILED_IMAGES = 3


def _streams(batches) -> list:
    return [e.streams for encs in batches for e in encs]


def phase_entropy_pipeline(dev: dict, codec, eager) -> None:
    """Phase 12: device packing against the host coder (256x256, 7 modes),
    roundtrip_pipelined against serial batches (512x768), the tiled
    pipeline against compress_tiled (1356x2040 cropped to 1344x2032), each
    pipeline also with CUDA graphs against `eager` (graphs=False), and the
    entropy coders' seconds per Kodak image, C++ against Python."""
    import numpy as np
    import torch

    from control_gic_tpu_torch.coding.native_lib import get_native
    from control_gic_tpu_torch.parallel.tiling import (compress_tiled,
                                                       compress_tiled_device)

    if get_native() is None or codec.huffman._native is None:
        raise AssertionError("phase 12: the C++ entropy coder is not loaded")
    if codec._device_tables is None:
        raise AssertionError("phase 12: the table has codes above 32 bits")

    # 1. device packing = host coding, 256x256, all 7 modes
    t0 = time.perf_counter()
    img = make_image(0)
    for mode, ratios in enumerate(RATIOS):
        host = codec.encode(img, *ratios)
        packed = codec.encode(img, *ratios, device_pack=True)
        if packed.mode != mode or packed.streams != host.streams:
            raise AssertionError(f"phase 12: device-packed streams differ "
                                 f"from the host coder's in mode {mode}")
    log("device pack 256x256", modes=7, byte_identical=True,
        seconds=time.perf_counter() - t0)

    # 2. roundtrip_pipelined against serial batches, 512x768
    batches = [np.stack([make_image(100 + PIPE_BATCH * b + j, KODAK)
                         for j in range(PIPE_BATCH)])
               for b in range(PIPE_BATCHES)]
    n_img = PIPE_BATCHES * PIPE_BATCH
    per_batch = PER_IMAGE[KODAK]
    expected = {k: v * PIPE_BATCHES for k, v in per_batch.items()}
    pipelined = lambda: codec.roundtrip_pipelined(
        batches, *RATIOS[0], device_pack=True, threads=True)

    def serial():
        encs = [codec.encode_batch(b, *RATIOS[0], device_pack=True)
                for b in batches]
        return [codec.decode_batch(e) for e in encs], encs

    pipelined()
    serial()                                     # warm-ups, not counted
    torch.cuda.synchronize()
    runs = {}
    for name, fn in (("pipelined", pipelined), ("serial", serial)):
        reset_launches()
        t0 = time.perf_counter()
        recs, encs = fn()
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / n_img
        launches = read_launches()
        if launches != expected:
            raise AssertionError(f"phase 12 {name}: launches {launches}, "
                                 f"expected {expected}")
        runs[name] = (recs, encs, ms)
        if name == "pipelined":
            stats = dict(codec.last_pipeline_stats)
    recs_p, encs_p, ms_p = runs["pipelined"]
    recs_s, encs_s, ms_s = runs["serial"]
    if _streams(encs_p) != _streams(encs_s):
        raise AssertionError("phase 12: pipelined streams differ from the "
                             "serial ones")
    diff = max(float(np.abs(a - b).max()) for a, b in zip(recs_p, recs_s))
    if not diff <= 1e-3 or not all(np.isfinite(r).all() for r in recs_p):
        raise AssertionError(f"phase 12: pipelined recons differ from the "
                             f"serial ones by {diff}")
    stage_sum = sum(v for k, v in stats.items() if k.endswith("_s")
                    and k != "wall_s")
    log("pipeline 512x768", images=n_img, batches=PIPE_BATCHES,
        batch=PIPE_BATCH, ms_per_image_pipelined=ms_p,
        ms_per_image_serial=ms_s, max_abs_diff=diff, launches=expected,
        stats=stats, stage_seconds_sum=stage_sum,
        overlap=stage_sum / stats["wall_s"], card=dev["nvidia_smi"])
    log_profile(dev, "pipeline 512x768", n_img, *device_profile(pipelined),
                programs=codec._programs.stats())
    log_profile(dev, "serial 512x768", n_img, *device_profile(serial),
                programs=codec._programs.stats())

    # the pipeline eagerly: the same streams, recons and launches
    pipelined_eager = lambda: eager.roundtrip_pipelined(
        batches, *RATIOS[0], device_pack=True, threads=True)
    reset_launches()
    t0 = time.perf_counter()
    recs_e, encs_e = pipelined_eager()
    torch.cuda.synchronize()
    wall_e = time.perf_counter() - t0
    graph_vs_eager(dev, "pipeline 512x768", n_img, codec, eager,
                   _streams(encs_p), _streams(encs_e), recs_p, recs_e,
                   expected, read_launches(), ms_p * n_img / 1e3, wall_e)
    log_profile(dev, "pipeline 512x768 eager", n_img,
                *device_profile(pipelined_eager),
                programs=eager._programs.stats())

    # 3. the tiled pipeline against compress_tiled, 1356x2040 -> 1344x2032
    h, w = HIGHRES
    ch, cw = h // 16 * 16, w // 16 * 16
    imgs_u8 = [(make_image(600 + i, (-(-h // 32) * 32, -(-w // 32) * 32))
                [:ch, :cw] * 255).astype(np.uint8)
               for i in range(TILED_IMAGES)]
    imgs_f = [im.astype(np.float32) / 255.0 for im in imgs_u8]
    tiled = lambda: compress_tiled_device(codec, imgs_u8, *RATIOS[0],
                                          tile=TILE, threads=True)
    per_image = lambda: [compress_tiled(codec, im, *RATIOS[0], tile=TILE)
                         for im in imgs_f]
    tiled()
    torch.cuda.synchronize()
    expected = {k: v * TILED_IMAGES
                for k, v in tiled_expected("default", ch, cw).items()}
    runs = {}
    for name, fn in (("pipeline", tiled), ("per_tile", per_image)):
        reset_launches()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / TILED_IMAGES
        launches = read_launches()
        if launches != expected:
            raise AssertionError(f"phase 12 tiled {name}: launches "
                                 f"{launches}, expected {expected}")
        runs[name] = (res, ms)
        if name == "pipeline":
            stats = dict(codec.last_pipeline_stats)
    (res_d, ms_d), (res_t, ms_t) = runs["pipeline"], runs["per_tile"]
    for (rec_d, bpp_d, bun_d), (rec_t, bpp_t, bun_t) in zip(res_d, res_t):
        if bpp_d != bpp_t or [b.streams for b in bun_d] != \
                [b.streams for b in bun_t]:
            raise AssertionError("phase 12: compress_tiled_device streams "
                                 "differ from compress_tiled's")
    quant = [(np.clip(r, 0, 1) * 255).astype(np.uint8) for r, _, _ in res_t]
    px = max(int(np.abs(a[0].astype(np.int16) - b).max())
             for a, b in zip(res_d, quant))
    stage_sum = sum(v for k, v in stats.items() if k.endswith("_s")
                    and k != "wall_s")
    log("tiled pipeline 1344x2032", images=TILED_IMAGES,
        ms_per_image_pipeline=ms_d, ms_per_image_per_tile=ms_t,
        bpp=[r[1] for r in res_d], png_max_abs_diff_vs_per_tile=px,
        launches=expected, stats=stats, stage_seconds_sum=stage_sum,
        overlap=stage_sum / stats["wall_s"], card=dev["nvidia_smi"])
    if px > 1:
        raise AssertionError(f"phase 12: the tiled pipeline's pixels differ "
                             f"from compress_tiled's by {px} of 255")
    log_profile(dev, "tiled pipeline 1344x2032", TILED_IMAGES,
                *device_profile(tiled), programs=codec._programs.stats())

    # the tiled pipeline with float reconstructions (programs that phase 10
    # captured), CUDA graphs against eager
    res = {}
    for name, c in (("graph", codec), ("eager", eager)):
        reset_launches()
        t0 = time.perf_counter()
        out = compress_tiled_device(c, imgs_u8, *RATIOS[0], tile=TILE,
                                    threads=True, out_uint8=False)
        torch.cuda.synchronize()
        res[name] = (out, read_launches(), time.perf_counter() - t0)
        if res[name][1] != expected:
            raise AssertionError(f"phase 12 tiled {name}: launches "
                                 f"{res[name][1]}, expected {expected}")
    (out_g, l_g, w_g), (out_e, l_e, w_e) = res["graph"], res["eager"]
    graph_vs_eager(dev, "tiled pipeline 1344x2032", TILED_IMAGES, codec,
                   eager, [b.streams for r in out_g for b in r[2]],
                   [b.streams for r in out_e for b in r[2]],
                   [r[0] for r in out_g], [r[0] for r in out_e], l_g, l_e,
                   w_g, w_e)
    log_profile(dev, "tiled pipeline 1344x2032 eager", TILED_IMAGES,
                *device_profile(lambda: compress_tiled_device(
                    eager, imgs_u8, *RATIOS[0], tile=TILE, threads=True)),
                programs=eager._programs.stats())

    # 4. entropy seconds per Kodak image, C++ against pure Python
    kodak = [make_image(100 + i, KODAK) for i in range(4)]
    arrays = [codec.encode_arrays(im[None], *RATIOS[0]) for im in kodak]
    huff, bitmap = codec.huffman, codec.bitmap
    streams_native, streams_py = [], []
    t = {"native_encode_s": 0.0, "python_encode_s": 0.0,
         "native_decode_s": 0.0, "python_decode_s": 0.0}
    for (ind, m_c, m_m, m_f), mode in arrays:
        ind, m_c, m_m, m_f = ind[0], m_c[0], m_m[0], m_f[0]
        syms = [ind[::4, ::4][m_c == 1], ind[::2, ::2][m_m == 1],
                ind[m_f == 1]]
        bits = [m_c.reshape(-1), m_m.reshape(-1)]
        t0 = time.perf_counter()
        native = ([huff.encode(x) for x in syms]
                  + [bitmap.encode(x) for x in bits])
        t1 = time.perf_counter()
        py = ([huff.encode_python(x) for x in syms]
              + [bitmap.encode_python(x) for x in bits])
        t2 = time.perf_counter()
        dec_n = ([huff.decode_array(x).tolist() for x in native[:3]]
                 + [bitmap.decode(x) for x in native[3:]])
        t3 = time.perf_counter()
        dec_p = ([huff.decode_python(x).tolist() for x in native[:3]]
                 + [bitmap.decode_python(x) for x in native[3:]])
        t4 = time.perf_counter()
        if native != py or dec_n != dec_p:
            raise AssertionError("phase 12: the C++ coder differs from the "
                                 "Python coder")
        for k, v in zip(t, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
            t[k] += v
    log("entropy per Kodak image", images=len(kodak), native_loaded=True,
        **{k.replace("_s", "_ms"): 1e3 * v / len(kodak)
           for k, v in t.items()},
        speedup_encode=t["python_encode_s"] / t["native_encode_s"],
        speedup_decode=t["python_decode_s"] / t["native_decode_s"])


# phase 13: the device-unpack receiver. The skewed counts give the second
# codec codes of 7 to 18 bits (L = 18: the scan kernel reads its table
# through L1 / L2); the default codec's uniform counts give every code 10
# bits (the table in shared memory). Geometric counts give codes above the
# decode table's 20 bits.
UNPACK_SKEW, UNPACK_SEED = 20.0, 0
UNPACK_IMPLS = ("scan", "rank")
UNPACK_IMAGES = 4                                # the 256x256 batch


def skewed_counts(n: int, skew: float, seed: int):
    """Poisson counts around 100 whose means spread over skew^[-1, 1]."""
    import numpy as np
    rng = np.random.default_rng(seed)
    return np.maximum(rng.poisson(100 * skew ** rng.uniform(-1, 1, n), n), 1)


def median_ms(fn, reps: int = 3) -> float:
    """Host ms of fn() through a final synchronize: the median of `reps`
    runs after a warm one."""
    import statistics

    import torch
    fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        runs.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(runs)


def scan_rows(dev: dict, codecs, encs_kodak, peaks) -> list:
    """13.1: on each codec's two Kodak fine streams (S = 2, n_cap = 24576,
    mode 0, so the counts are ragged), the scan kernel against its plain
    loop on the card, the rank decoder and the host coder: symbols equal.
    Times: the kernel and the rank decoder by CUDA events over many calls,
    the plain loop (some 300k launches) over one."""
    import numpy as np
    import torch

    from control_gic_tpu_torch.coding import huffman_decode_device as D

    rows = []
    for label, c in codecs:
        encs = encs_kodak[label]
        lut_sym, lut_len, L = c._decode_tables
        hl, wl = encs[0].latent_hw
        n_cap = hl * wl
        cw = n_cap * L // 32 + 2
        frames = [e.streams["indices_fine"] for e in encs]
        words = np.stack([D.words_from_frame(f, cw)[0] for f in frames])
        host = [c.huffman.decode_array(f) for f in frames]
        counts = [len(h) for h in host]
        args = (torch.from_numpy(words.view(np.int32)).cuda(),
                torch.tensor(counts, dtype=torch.int32).cuda(),
                torch.from_numpy(lut_sym).cuda(),
                torch.from_numpy(lut_len).cuda(), n_cap, L)
        out = D.huffman_scan_kernel(*args)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        plain = D.huffman_decode_bits_scan_reference(*args)
        end.record()
        torch.cuda.synchronize()
        plain_ms = start.elapsed_time(end)
        rank = D.huffman_decode_bits(*args)
        torch.cuda.synchronize()
        err = (out.long() - plain.long()).abs().max().item()
        rank_equal = torch.equal(rank, out)
        host_equal = all(np.array_equal(out[i, :n].cpu().numpy(), h)
                         and not out[i, n:].any().item()
                         for i, (n, h) in enumerate(zip(counts, host)))
        ms = cuda_time_ms(lambda: D.huffman_scan_kernel(*args), iters=20)
        rank_ms = cuda_time_ms(lambda: D.huffman_decode_bits(*args))
        # bytes: the frames' words, the counts, the table entries a walk can
        # touch and the output; operations: ~8 integer ops a symbol
        nbytes = (sum(len(f) for f in frames) + 4 * len(counts)
                  + 8 * min(1 << L, sum(counts)) + out.numel() * 4)
        bms, bound_by = bound_ms(8.0 * sum(counts), nbytes, "float32", peaks)
        row = {"kernel": "huffman_scan", "codec": label, "L": L,
               "shape": [len(counts), n_cap], "counts": counts,
               "table_in_shared_memory": L <= 12, "max_abs_err": err,
               "tol": 0, "rank_equal": rank_equal, "host_equal": host_equal,
               "ms": ms, "plain_ms": plain_ms, "rank_ms": rank_ms,
               "ns_per_symbol": 1e6 * ms / max(counts),
               "library_ms": None, "bound_ms": bms, "bound_by": bound_by,
               "card": dev["nvidia_smi"]}
        log("kernel huffman_scan", **row)
        if err != 0 or not rank_equal or not host_equal:
            raise AssertionError(f"phase 13 {label}: the decoders disagree "
                                 f"(kernel vs plain {err}, rank equal "
                                 f"{rank_equal}, host equal {host_equal})")
        rows.append(row)
    return rows


def phase_device_unpack(dev: dict, codec) -> dict:
    """Phase 13: the device-unpack receiver (see the module docstring).
    Returns the scan kernel's row and its launches on the main path: the
    default codec's round trips under the scan decoder."""
    import numpy as np
    import torch

    from control_gic_tpu_torch.codec import MODE_STREAMS, CGICCodec
    from control_gic_tpu_torch.parallel.tiling import compress_tiled_device

    t_phase = time.perf_counter()
    peaks = card_peaks(dev["name"])
    skew = CGICCodec(codec.model, skewed_counts(
        codec.model.config.n_embed, UNPACK_SKEW, UNPACK_SEED),
        device=codec.device)
    codecs = (("uniform", codec), ("skewed", skew))
    lens = {label: c._decode_tables[2] for label, c in codecs}
    log("device unpack codecs", max_code_bits=lens,
        skewed_counts=dict(skew=UNPACK_SKEW, seed=UNPACK_SEED))
    if lens["uniform"] != 10 or not 14 <= lens["skewed"] <= 20:
        raise AssertionError(f"phase 13: code lengths {lens}, expected 10 "
                             "and 14 to 20")

    # one encode per batch (the default codec's programs), each codec's
    # streams coded from the same grids by the host coder
    def bundles(images, ratios):
        (ind, m_c, m_m, m_f), mode = codec.encode_arrays(
            images, *ratios, per_sample=True)
        return {label: [c.streams_from_arrays(ind[i], m_c[i], m_m[i],
                                              m_f[i], mode,
                                              images.shape[1:3])
                        for i in range(len(images))]
                for label, c in codecs}

    small = np.stack([make_image(200 + j) for j in range(UNPACK_IMAGES)])
    kodak = np.stack([make_image(100 + j, KODAK) for j in range(2)])
    batches = [(f"256x256 mode {m}", bundles(small, RATIOS[m]))
               for m in range(7)]
    batches.append(("512x768 mode 0", bundles(kodak, RATIOS[0])))

    # 1. the decoders against each other on the Kodak fine streams
    rows = scan_rows(dev, codecs, batches[-1][1], peaks)

    # 2. round trips: device receiver against the host receiver
    host = {}
    for label, c in codecs:
        host[label] = [(c.decode_batch(b[label], out_uint8=True),
                        c.decode_batch(b[label])) for _, b in batches]
    main_launches = None
    for label, c in codecs:
        for impl in UNPACK_IMPLS:
            with switches(CONTROL_GIC_UNPACK_IMPL=impl):
                torch.cuda.synchronize()
                reset_launches()
                per_batch = []
                for (name, b), (h8, hf) in zip(batches, host[label]):
                    before = read_launches()
                    d8 = c.decode_batch(b[label], out_uint8=True,
                                        device_unpack=True, strict=True)
                    path = c.last_decode_path
                    df = c.decode_batch(b[label], device_unpack=True)
                    after = read_launches()
                    scans = after["huffman_scan"] - before["huffman_scan"]
                    mode = b[label][0].mode
                    want = (2 * sum(s.startswith("indices")
                                    for s in MODE_STREAMS[mode])
                            if impl == "scan" else 0)
                    diff = float(np.abs(df - hf).max())
                    per_batch.append({"batch": name, "uint8_equal":
                                      bool(np.array_equal(d8, h8)),
                                      "float_max_abs_diff": diff,
                                      "path": path, "scan_launches": scans})
                    if (not np.array_equal(d8, h8) or not diff <= 1e-6
                            or path != "device" or scans != want):
                        raise AssertionError(
                            f"phase 13 {label} {impl} {name}: device "
                            f"receiver uint8 equal "
                            f"{np.array_equal(d8, h8)}, float diff {diff}, "
                            f"path {path}, scan launches {scans} (want "
                            f"{want})")
                torch.cuda.synchronize()
                launches = read_launches()
                if label == "uniform" and impl == "scan":
                    main_launches = launches
                encs = batches[-1][1][label]
                st_d, st_h = {}, {}
                c.decode_batch_device_async(encs, stats=st_d)
                c.decode_batch_async(encs, stats=st_h)
                torch.cuda.synchronize()
                log(f"device unpack {label} {impl}", batches=per_batch,
                    launches=launches,
                    kodak_ms_per_image_device=median_ms(
                        lambda: c.decode_batch(
                            encs, device_unpack=True)) / len(encs),
                    kodak_ms_per_image_host=median_ms(
                        lambda: c.decode_batch(encs)) / len(encs),
                    small_ms_per_image_device=median_ms(
                        lambda: c.decode_batch(batches[0][1][label],
                                               device_unpack=True))
                    / UNPACK_IMAGES,
                    small_ms_per_image_host=median_ms(
                        lambda: c.decode_batch(batches[0][1][label]))
                    / UNPACK_IMAGES,
                    kodak_h2d_bytes_per_image_device=st_d["b_h2d_bytes"]
                    / len(encs),
                    kodak_h2d_bytes_per_image_host=st_h["b_h2d_bytes"]
                    / len(encs),
                    kodak_stream_bytes_per_image=sum(
                        e.num_bytes for e in encs) / len(encs),
                    programs=c._programs.stats(), card=dev["nvidia_smi"])
    if not main_launches["huffman_scan"]:
        raise AssertionError("phase 13: the scan kernel never launched")

    # 3. the pipelines, uint8 out: device receiver against host receiver
    pipe = [np.stack([make_image(100 + PIPE_BATCH * b + j, KODAK)
                      for j in range(PIPE_BATCH)])
            for b in range(PIPE_BATCHES)]
    h, w = HIGHRES
    ch, cw = h // 16 * 16, w // 16 * 16
    tiled_img = [(make_image(600, (-(-h // 32) * 32, -(-w // 32) * 32))
                  [:ch, :cw] * 255).astype(np.uint8)]
    for impl in UNPACK_IMPLS:
        with switches(CONTROL_GIC_UNPACK_IMPL=impl):
            res, ms = {}, {}
            for unpack in (False, True):
                run = lambda: codec.roundtrip_pipelined(
                    pipe, *RATIOS[0], device_pack=True, out_uint8=True,
                    device_unpack=unpack, threads=True)
                res[unpack] = run()
                t0 = time.perf_counter()
                run()
                torch.cuda.synchronize()
                ms[unpack] = 1e3 * (time.perf_counter() - t0) / (
                    PIPE_BATCHES * PIPE_BATCH)
                if codec.last_pipeline_stats["device_unpack"] != unpack:
                    raise AssertionError("phase 13: roundtrip_pipelined's "
                                         "device_unpack stat")
            (recs_h, encs_h), (recs_d, encs_d) = res[False], res[True]
            same = (_streams(encs_h) == _streams(encs_d)
                    and all(np.array_equal(a, b)
                            for a, b in zip(recs_h, recs_d)))
            tiled, tms = {}, {}
            for unpack in (False, True):
                run = lambda: compress_tiled_device(
                    codec, tiled_img, *RATIOS[0], tile=TILE, threads=True,
                    device_unpack=unpack)
                tiled[unpack] = run()[0]
                t0 = time.perf_counter()
                run()
                torch.cuda.synchronize()
                tms[unpack] = 1e3 * (time.perf_counter() - t0)
            t_same = (np.array_equal(tiled[False][0], tiled[True][0])
                      and tiled[False][1] == tiled[True][1])
            log(f"device unpack pipelines {impl}", pipelined_equal=same,
                pipelined_ms_per_image_device=ms[True],
                pipelined_ms_per_image_host=ms[False],
                tiled_equal=t_same, tiled_ms_per_image_device=tms[True],
                tiled_ms_per_image_host=tms[False], card=dev["nvidia_smi"])
            if not same or not t_same:
                raise AssertionError(f"phase 13 {impl}: the device receiver "
                                     f"differs in the pipelines (pipelined "
                                     f"{same}, tiled {t_same})")

    # 4. strict=True on a table with codes above 20 bits
    deep = CGICCodec(codec.model, np.maximum(
        1, 2 ** 40 >> np.arange(codec.model.config.n_embed)),
        device=codec.device, graphs=False)
    deep_bits = max(len(code) for code in deep.huffman.codes.values())
    encs = deep.encode_batch(small[:1], *RATIOS[0])
    try:
        deep.decode_batch(encs, device_unpack=True, strict=True)
        raised = False
    except ValueError:
        raised = True
    fallback = deep.decode_batch(encs, device_unpack=True)
    fell_back = (deep.last_decode_path == "host"
                 and np.array_equal(fallback, deep.decode_batch(encs)))
    log("device unpack strict", max_code_bits=deep_bits, strict_raised=raised,
        fallback_path=deep.last_decode_path, fallback_equal=fell_back,
        seconds=time.perf_counter() - t_phase)
    if deep_bits <= 20 or not raised or not fell_back:
        raise AssertionError(f"phase 13: strict mode (max code {deep_bits} "
                             f"bits, raised {raised}, fallback {fell_back})")
    row = next(r for r in rows if r["codec"] == "uniform")
    return {"row": dict(row, max_abs_err=max(r["max_abs_err"] for r in rows)),
            "launches": main_launches["huffman_scan"]}


TRAIN_BATCH = 2
TRAIN_STEPS = 3


def train_batches(seed: int, n: int):
    """n synthetic [-1, 1] NHWC batches of TRAIN_BATCH 256x256 images."""
    import numpy as np
    return [np.stack([2.0 * make_image(seed + TRAIN_BATCH * i + j) - 1.0
                      for j in range(TRAIN_BATCH)]).astype(np.float32)
            for i in range(n)]


class StepRecorder:
    """A Trainer whose train_step is timed on the host clock around a
    synchronised step, with each step's kernel launches and metrics kept."""

    def __init__(self, trainer):
        self.trainer = trainer
        self.ms, self.launches, self.metrics = [], [], []

    def train_step(self, state, x):
        import torch
        torch.cuda.synchronize()
        before, t0 = read_launches(), time.perf_counter()
        state, metrics = self.trainer.train_step(state, x)
        torch.cuda.synchronize()
        self.ms.append(1e3 * (time.perf_counter() - t0))
        after = read_launches()
        self.launches.append({k: after[k] - before[k] for k in after})
        self.metrics.append({k: float(v) for k, v in metrics.items()})
        return state, metrics

    def __getattr__(self, name):
        return getattr(self.trainer, name)


def _loop_args(workdir: str, steps: int, tag: str):
    from control_gic_tpu_torch.cli import train as train_cli
    return train_cli.get_parser().parse_args([
        "--train-dir", workdir, "--steps", str(steps), "--log-every", "1",
        "--ckpt-every", "1000000", "--ckpt-dir",
        os.path.join(workdir, f"ckpt_{tag}"), "--log-dir",
        os.path.join(workdir, f"logs_{tag}")])


def _check_steps(rec: StepRecorder, label: str, expected=None) -> None:
    import math
    expected = PER_TRAIN_STEP if expected is None else expected
    for i, (launched, metrics) in enumerate(zip(rec.launches, rec.metrics)):
        if launched != expected:
            raise AssertionError(f"{label} step {i}: kernel launches "
                                 f"{launched}, expected {expected}")
        bad = [k for k, v in metrics.items() if not math.isfinite(v)]
        if bad:
            raise AssertionError(f"{label} step {i}: non-finite {bad}")


def generator_grads(trainer, state, x):
    """The generator's gradients of one step's loss, and the VQ indices;
    nothing in the state changes. No tensor of the autograd graph is
    returned: a graph kept alive keeps its AccumulateGrad nodes on the
    stream of this eager call, and a captured step that reaches them would
    make the legacy stream wait on the capture, which CUDA refuses."""
    import torch
    params = list(state.gen.parameters())
    loss, _, enc, _ = trainer.forward_losses(state,
                                             trainer.to_input(state, x))
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g
            for p, g in zip(params, grads)], enc.indices


def step_profile(trainer, state, x) -> dict:
    """torch.profiler over one training step: host wall and device busy
    time, idle share, the flash kernels' shares of device time, the
    backward kernels' device ms (their bf16 and f32 instantiations by one
    name) and the top kernels."""
    wall_us, busy, kernels, by_name = device_profile(
        lambda: trainer.train_step(state, x))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    bwd_keys = ("flash_bwd_dkdv", "flash_bwd_dq", "flash_bwd_delta")
    shares = _shares(by_name, ("flash_fwd_",) + bwd_keys) if by_name else {}
    bwd_ms = {key: sum(v for k, v in by_name.items() if key in k) / 1e3
              for key in bwd_keys}
    return dict(
        profile_wall_ms=wall_us / 1e3,
        device_busy_ms=None if busy is None else busy / 1e3,
        device_idle_share=None if busy is None else 1.0 - busy / wall_us,
        device_kernels=kernels, flash_shares_of_device_time=shares,
        backward_device_ms_per_step=bwd_ms,
        backward_share_of_device_busy=None if not busy
        else sum(bwd_ms.values()) * 1e3 / busy,
        top_kernels_ms={k: v / 1e3 for k, v in top})


@contextlib.contextmanager
def deterministic():
    """cuDNN's deterministic algorithms, and PyTorch's deterministic
    implementations where it has them (index_add_, the backward of the
    nearest resizes, runs with float atomics otherwise), so that a step
    with CUDA graphs and the same step without them can be compared
    value for value."""
    import torch
    old = (torch.backends.cudnn.deterministic,
           torch.backends.cudnn.benchmark,
           torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
            old[:2]
        torch.use_deterministic_algorithms(old[2], warn_only=old[3])


def memory_of(run, trainer) -> dict:
    """run() with the memory it takes: the allocator's peak above what was
    allocated before it (the resident states; with graphs, the first
    call's warm-up), and with graphs the bytes of the training programs'
    pool after it (their captured intermediates and static outputs; a
    replay allocates nothing), in GiB."""
    import torch
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = run()
    torch.cuda.synchronize()
    pool = trainer.program_stats().get("pool_bytes")
    return out, dict(
        steps_peak_gib=(torch.cuda.max_memory_allocated() - resident)
        / 2 ** 30,
        resident_gib=resident / 2 ** 30,
        pool_gib=None if pool is None else pool / 2 ** 30)


def run_steps(trainer, state, batches):
    """train_step over `batches` through a StepRecorder; returns the
    recorder and memory_of's figures."""
    rec = StepRecorder(trainer)

    def run():
        for x in batches:
            rec.train_step(state, x)
    return rec, memory_of(run, trainer)[1]


def _state_tensors(state) -> dict:
    """The tensors a step writes, by name: parameters, EMA, Adam moments,
    running statistics, counters."""
    out = {f"gen.{n}": p for n, p in state.gen.named_parameters()}
    out.update({f"ema.{n}": t for n, t in state.ema.items()})
    out.update({f"disc.{n}": t for n, t in state.disc.state_dict().items()})
    for tag, opt, mod in (("opt_gen", state.opt_gen, state.gen),
                          ("opt_disc", state.opt_disc, state.disc)):
        for n, p in mod.named_parameters():
            for k in ("exp_avg", "exp_avg_sq"):
                out[f"{tag}.{n}.{k}"] = opt.state[p][k]
    out["codebook_counts"] = state.codebook_counts
    return out


def compare_runs(label: str, graph, eager) -> dict:
    """Steps with CUDA graphs against the same steps eagerly ((state,
    StepRecorder) each): every loss of every step within 1e-6 relative,
    every tensor the steps write within 1e-5 of its max. Returns the
    largest differences; raises beyond the tolerances."""
    (gs, grec), (es, erec) = graph, eager
    loss_rel = max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-12)
                   for a, b in zip(grec.metrics, erec.metrics)
                   for k in b if "loss" in k)
    want = _state_tensors(es)
    errs = {}
    for name, t in _state_tensors(gs).items():
        w = want[name].double()
        errs[name] = ((t.double() - w).abs().max()
                      / max(w.abs().max().item(), 1e-30)).item()
    worst = sorted(errs.items(), key=lambda kv: -kv[1])[:5]
    out = dict(steps=len(grec.metrics), loss_worst_rel_err=loss_rel,
               tensors=len(errs), tensors_differing=sum(
                   e > 0 for e in errs.values()),
               tensor_worst_rel_errs=dict(worst), all_equal=(
                   loss_rel == 0 and worst[0][1] == 0))
    log(f"train {label} graphs vs eager", tol_loss=1e-6, tol_tensor=1e-5,
        **out)
    if not (loss_rel <= 1e-6 and worst[0][1] <= 1e-5):
        raise AssertionError(f"{label}: captured steps differ from eager "
                             f"ones: {out}")
    return out


def timed_pair(graph, eager, batches) -> dict:
    """ms per step with and without CUDA graphs, in turns (graph, eager,
    graph, eager, ...) on `batches`; (trainer, state) each. The means leave
    out the first step of each: outside deterministic() the graph side
    captures a program of its own there."""
    rec_g, rec_e = StepRecorder(graph[0]), StepRecorder(eager[0])
    for x in batches:
        rec_g.train_step(graph[1], x)
        rec_e.train_step(eager[1], x)
    mean = lambda ms: sum(ms[1:]) / len(ms[1:])
    return {"timed_steps": dict(graph_ms=rec_g.ms, eager_ms=rec_e.ms,
                                graph_ms_mean=mean(rec_g.ms),
                                eager_ms_mean=mean(rec_e.ms))}


def graphs_vs_eager(label: str, cfg, tcfg, batches, expected=None,
                    state=None, trainer=None, group=None):
    """The same steps from the same seed with CUDA graphs and with
    graphs=False, both deterministic: launches per step exact (`expected`;
    None: PER_TRAIN_STEP), values compared (compare_runs). Takes an
    existing (trainer, state) for the graph side if given; both trainers
    take `group` (a process group) if given. Returns
    ((trainer, state, recorder, memory_of's figures) with graphs, the same
    eagerly, the comparison)."""
    from control_gic_tpu_torch.train import Trainer, create_train_state
    if state is None:
        trainer = Trainer(cfg, tcfg, group=group)
        state = create_train_state(cfg, tcfg, device="cuda", seed=0)
    eager = Trainer(cfg, tcfg, graphs=False, group=group)
    eager_state = create_train_state(cfg, tcfg, device="cuda", seed=0)
    with deterministic():
        rec_g, peak_g = run_steps(trainer, state, batches)
        rec_e, peak_e = run_steps(eager, eager_state, batches)
    _check_steps(rec_g, f"{label} graphs", expected)
    _check_steps(rec_e, f"{label} eager", expected)
    if rec_g.launches != rec_e.launches:
        raise AssertionError(f"{label}: launches with graphs "
                             f"{rec_g.launches}, eagerly {rec_e.launches}")
    agree = compare_runs(label, (state, rec_g), (eager_state, rec_e))
    return ((trainer, state, rec_g, peak_g), (eager, eager_state, rec_e,
                                              peak_e), agree)


def release() -> None:
    """Free what the last run left: collect reference cycles (an autograd
    graph, a traceback), then return the allocator's cached blocks."""
    import gc

    import torch
    gc.collect()
    torch.cuda.empty_cache()


def phase_train(dev: dict, workdir: str) -> dict:
    """Phase 8: the training step at full width, 256x256, batch 2, as CUDA
    graphs (the Trainer's default) against graphs=False. Returns the kernel
    launches of the 3 f32 steps."""
    import numpy as np
    import torch

    from control_gic_tpu_torch.cli import train as train_cli
    from control_gic_tpu_torch.models import CGICConfig
    from control_gic_tpu_torch.ops import norm_conv, plain_versions
    from control_gic_tpu_torch.train import (TrainConfig, Trainer,
                                             create_train_state)
    from control_gic_tpu_torch.train.losses import LossConfig
    from control_gic_tpu_torch.utils.checkpoint import (latest_step,
                                                        restore_checkpoint)

    release()                  # the codec phases' programs and caches
    t0 = time.perf_counter()
    cfg, tcfg = CGICConfig(dtype="float32"), TrainConfig()
    trainer = Trainer(cfg, tcfg)                   # CUDA graphs, by default
    state = create_train_state(cfg, tcfg, device="cuda", seed=0)
    batches = train_batches(100, TRAIN_STEPS)
    names = [n for n, _ in state.gen.named_parameters()]

    # the first step's generator gradients: kernels against plain versions,
    # with cuDNN's deterministic algorithms so that the comparison sees the
    # kernels and not run-to-run order; two plain runs give the floor
    torch.backends.cudnn.deterministic = True
    reset_launches()
    g_k, enc_k = generator_grads(trainer, state, batches[0])
    torch.cuda.synchronize()
    launched = read_launches()
    with plain_versions():
        g_p, enc_p = generator_grads(trainer, state, batches[0])
        g_p2, _ = generator_grads(trainer, state, batches[0])
    torch.backends.cudnn.deterministic = False
    if launched != PER_TRAIN_STEP:
        raise AssertionError(f"gradient step launches {launched}, expected "
                             f"{PER_TRAIN_STEP}")
    rel = lambda a, b: ((a - b).abs().max()
                        / max(1e-6, b.abs().max().item())).item()
    errs = {n: rel(a, b) for n, a, b in zip(names, g_k, g_p)}
    floor = max(rel(a, b) for a, b in zip(g_p2, g_p))
    worst = sorted(errs.items(), key=lambda kv: -kv[1])[:5]
    log("train gradients kernels vs plain", tensors=len(errs), tol=1e-3,
        worst_rel_errs=dict(worst), plain_vs_plain_worst_rel_err=floor,
        vq_indices_equal=bool(torch.equal(enc_k, enc_p)),
        launches=launched)
    if not worst[0][1] <= 1e-3:
        raise AssertionError(f"generator gradients with the kernels differ "
                             f"from the plain versions: {dict(worst)}")
    del g_k, g_p, g_p2, enc_k, enc_p

    # 3 steps through the train CLI's loop as CUDA graphs (the first call
    # runs a real step, then captures; the others replay), then the same
    # steps from the same seed eagerly; both deterministic
    before = [p.detach().clone() for p in state.gen.parameters()]
    rec = StepRecorder(trainer)
    args = _loop_args(workdir, TRAIN_STEPS, "f32")
    reset_launches()
    with deterministic():
        state, mem = memory_of(lambda: train_cli.train_loop(
            args, rec, state, iter(batches)), trainer)
    launches = read_launches()
    _check_steps(rec, "f32")
    changed = sum(not torch.equal(a, p) for a, p in
                  zip(before, state.gen.parameters()))
    del before
    if state.step != TRAIN_STEPS or changed < len(names):
        raise AssertionError(f"after {TRAIN_STEPS} steps: step {state.step}, "
                             f"{changed} of {len(names)} generator tensors "
                             f"changed")
    eager = Trainer(cfg, tcfg, graphs=False)
    eager_state = create_train_state(cfg, tcfg, device="cuda", seed=0)
    with deterministic():
        rec_e, mem_eager = run_steps(eager, eager_state, batches)
    _check_steps(rec_e, "f32 eager")
    agree = compare_runs("f32", (state, rec), (eager_state, rec_e))
    # eval_step as a program (captured, then replayed) against eager
    with deterministic():
        vm = [{k: float(v) for k, v in trainer.eval_step(state, batches[0])
               .items()} for _ in range(2)]
        vm_e = {k: float(v) for k, v in
                eager.eval_step(eager_state, batches[0]).items()}
    eval_rel = max(abs(vm[1][k] - vm_e[k]) / max(abs(vm_e[k]), 1e-12)
                   for k in vm_e)
    if not all(np.isfinite(list(vm[1].values()))) or eval_rel > 1e-6 \
            or vm[0] != vm[1]:
        raise AssertionError(f"eval metrics: {vm} against eager {vm_e}")

    # the loop's closing checkpoint, restored into a fresh state
    saved = latest_step(args.ckpt_dir)
    fresh = create_train_state(cfg, tcfg, device="cuda", seed=7)
    restore_checkpoint(args.ckpt_dir, fresh)
    same = (fresh.step == state.step == saved
            and fresh.ema_num_updates == state.ema_num_updates
            and torch.equal(fresh.codebook_counts, state.codebook_counts)
            and all(torch.equal(a, b) for a, b in
                    zip(fresh.gen.state_dict().values(),
                        state.gen.state_dict().values()))
            and all(torch.equal(a, b) for a, b in
                    zip(fresh.disc.state_dict().values(),
                        state.disc.state_dict().values()))
            and all(torch.equal(fresh.ema[k], state.ema[k])
                    for k in state.ema)
            and all(torch.equal(a[k], b[k]) for a, b in
                    zip(fresh.opt_gen.state.values(),
                        state.opt_gen.state.values())
                    for k in ("exp_avg_sq", "step")))
    del fresh
    if not same:
        raise AssertionError("the restored checkpoint differs from the state")

    # ms per step both ways, in turns, on other batches (PyTorch's default
    # algorithms: a program of its own), then one profiled step each way
    timing = timed_pair((trainer, state), (eager, eager_state),
                        train_batches(500, 5))
    log("train f32", config="CGICConfig(dtype=float32), 256x256, batch 2",
        params=sum(p.numel() for p in state.gen.parameters()),
        steps=TRAIN_STEPS, step_ms=rec.ms, eager_step_ms=rec_e.ms,
        launches=launches, launches_per_step=rec.launches[0],
        metrics_last=rec.metrics[-1], eval_metrics=vm[1],
        eval_vs_eager_worst_rel_err=eval_rel, params_changed=changed,
        checkpoint_step=saved, checkpoint_restored_equal=same,
        memory=mem, eager_memory=mem_eager,
        graphs_vs_eager=agree, **timing, programs=trainer.program_stats(),
        **step_profile(trainer, state, batches[0]),
        card=dev["nvidia_smi"], seconds=time.perf_counter() - t0)
    log("train f32 eager", **step_profile(eager, eager_state, batches[0]),
        card=dev["nvidia_smi"])
    del state, trainer, rec, eager, eager_state, rec_e
    release()

    # remat, the adaptive weight and disc_start=2: 3 steps cross the
    # switch, so two programs are captured. The per-step launches stay
    # PER_TRAIN_STEP: at 256x256 the flash attentions are the mids' (64x64
    # latent, 4096 tokens), which remat does not wrap; the trunk's run at
    # 32x32 (1024 tokens, the plain path), and the adaptive weight's
    # gradients reach only conv_out
    t0 = time.perf_counter()
    cfg_r = CGICConfig(dtype="float32", remat=True)
    tcfg_r = TrainConfig(loss=LossConfig(disc_start=2,
                                         adaptive_g_weight=True))
    (tr_g, st_g, rec_g, peak_g), (tr_e, st_e, rec_e, peak_e), agree = \
        graphs_vs_eager("f32 remat adaptive", cfg_r, tcfg_r, batches)
    programs = tr_g.program_stats()
    if programs["programs_captured"] != 2:
        raise AssertionError(f"remat run: {programs} (expected the two "
                             "sides of disc_start)")
    timing = timed_pair((tr_g, st_g), (tr_e, st_e), train_batches(700, 3))
    log("train f32 remat adaptive disc_start=2", steps=TRAIN_STEPS,
        step_ms=rec_g.ms, eager_step_ms=rec_e.ms,
        launches_per_step=rec_g.launches[0], metrics_last=rec_g.metrics[-1],
        memory=peak_g, eager_memory=peak_e, no_remat_memory=mem,
        no_remat_eager_memory=mem_eager, programs=programs,
        graphs_vs_eager=agree, **timing, card=dev["nvidia_smi"],
        seconds=time.perf_counter() - t0)
    del tr_g, st_g, rec_g, tr_e, st_e, rec_e
    release()

    # every chain-admissible trunk block engaged (the engagement rule): the
    # chain and its weight packs run inside the captured steps and eval;
    # the packs are made in the graph from the weights the replays write,
    # so eval_step captured after 2 steps and replayed after a third equals
    # the eager one each time
    t0 = time.perf_counter()
    norm_conv.set_engagement_rule(lambda shape, cout: True)
    try:
        reset_launches()
        probe = create_train_state(cfg, tcfg, device="cuda", seed=0)
        with deterministic():
            Trainer(cfg, tcfg, graphs=False).train_step(probe, batches[0])
        torch.cuda.synchronize()
        forced = read_launches()
        del probe
        if not forced["chain_gn"] or not forced["chain_sn"]:
            raise AssertionError(f"forced engagement: launches {forced}")
        (tr_g, st_g, rec_g, _), (tr_e, st_e, rec_e, _), agree = \
            graphs_vs_eager("f32 chain forced", cfg, tcfg, batches[:2],
                            expected=forced)
        evals = []
        with deterministic():
            for x in (None, batches[2]):
                if x is not None:
                    tr_g.train_step(st_g, x)
                    tr_e.train_step(st_e, x)
                got = {k: float(v) for k, v in
                       tr_g.eval_step(st_g, batches[0]).items()}
                want = {k: float(v) for k, v in
                        tr_e.eval_step(st_e, batches[0]).items()}
                evals.append(max(abs(got[k] - want[k])
                                 / max(abs(want[k]), 1e-12) for k in want))
    finally:
        norm_conv.set_engagement_rule(None)
    programs = tr_g.program_stats()
    log("train f32 chain forced", steps=3, launches_per_step=forced,
        eval_vs_eager_worst_rel_errs=evals, programs=programs,
        graphs_vs_eager=agree, card=dev["nvidia_smi"],
        seconds=time.perf_counter() - t0)
    if max(evals) > 1e-6 or programs["programs_captured"] != 2:
        raise AssertionError(f"forced chain: eval against eager {evals}, "
                             f"{programs}")
    del tr_g, st_g, rec_g, tr_e, st_e, rec_e
    release()

    # 2 steps in bf16 (the bf16 backward kernels' path) with graphs and
    # eagerly, the same launch checks and comparison; the first step's
    # generator gradients against the plain versions are logged for
    # information (bf16 rounds at other points in the plain attention),
    # then ms per step both ways and a profile of one step each way
    t0 = time.perf_counter()
    cfg16 = CGICConfig(dtype="bfloat16")
    trainer16 = Trainer(cfg16, tcfg)
    state16 = create_train_state(cfg16, tcfg, device="cuda", seed=0)
    batches16 = train_batches(200, 2)
    g_k, _ = generator_grads(trainer16, state16, batches16[0])
    with plain_versions():
        g_p, _ = generator_grads(trainer16, state16, batches16[0])
    errs16 = sorted(((n, rel(a.float(), b.float())) for n, a, b in
                     zip(names, g_k, g_p)), key=lambda kv: -kv[1])[:5]
    del g_k, g_p
    (tr_g, st_g, rec16, peak16), (tr_e, st_e, rec16_e, peak16_e), agree = \
        graphs_vs_eager("bf16", cfg16, tcfg, batches16, state=state16,
                        trainer=trainer16)
    timing = timed_pair((tr_g, st_g), (tr_e, st_e), train_batches(600, 5))
    log("train bf16", config="CGICConfig(dtype=bfloat16), 256x256, batch 2",
        steps=2, step_ms=rec16.ms, eager_step_ms=rec16_e.ms,
        launches_per_step=rec16.launches[0], metrics_last=rec16.metrics[-1],
        gradients_vs_plain_worst_rel_errs=dict(errs16),
        memory=peak16, eager_memory=peak16_e,
        graphs_vs_eager=agree, **timing, programs=tr_g.program_stats(),
        **step_profile(tr_g, st_g, batches16[0]),
        card=dev["nvidia_smi"], seconds=time.perf_counter() - t0)
    log("train bf16 eager", **step_profile(tr_e, st_e, batches16[0]),
        card=dev["nvidia_smi"])
    del tr_g, st_g, rec16, tr_e, st_e, rec16_e, state16, trainer16
    release()
    phase_train_cli(workdir)
    return launches


def phase_train_cli(workdir: str) -> None:
    """The train CLI end to end on PNGs, where PIL is installed."""
    import importlib.util
    import json as _json

    from control_gic_tpu_torch.utils.checkpoint import latest_step

    if importlib.util.find_spec("PIL") is None:
        log("train cli", skipped="PIL is not installed on this machine")
        return
    pngs = _train_pngs(workdir)
    ckpt, logs = os.path.join(workdir, "cli_ckpt"), os.path.join(workdir,
                                                                 "cli_logs")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "control_gic_tpu_torch.cli.train",
         "--train-dir", pngs, "--steps", "2", "--batch-size", "2",
         "--log-every", "1", "--ckpt-dir", ckpt, "--log-dir", logs],
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
        text=True, timeout=900)
    if proc.returncode != 0:
        raise AssertionError(f"train CLI failed ({proc.returncode}):\n"
                             f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    with open(os.path.join(logs, "metrics.jsonl")) as f:
        lines = [_json.loads(line) for line in f]
    if latest_step(ckpt) != 2 or len(lines) != 2:
        raise AssertionError(f"train CLI: checkpoint {latest_step(ckpt)}, "
                             f"{len(lines)} metric lines")
    log("train cli", steps=2, checkpoint_step=2,
        last_metrics={k: lines[-1][k] for k in ("train/aeloss",
                                                "train/discloss")},
        images=sorted(os.listdir(os.path.join(logs, "images"))),
        seconds=time.perf_counter() - t0)


# ---------------------------------------------------------------- phase 14

DP_STEPS = 2
DP_GLOBAL_BATCH = 4


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def dp_batches():
    """DP_STEPS global batches of DP_GLOBAL_BATCH 256x256 images."""
    import numpy as np
    return [np.concatenate(train_batches(800 + 8 * i, 2))
            for i in range(DP_STEPS)]


def _dp_config():
    from control_gic_tpu_torch.models import CGICConfig
    from control_gic_tpu_torch.train import TrainConfig
    return CGICConfig(dtype="float32"), TrainConfig()


@contextlib.contextmanager
def recorded_grads():
    """The gradients the training step hands to its optimizers (after the
    all-reduce, before the clip), first step only: [generator's,
    discriminator's]."""
    import torch

    from control_gic_tpu_torch.train import step as step_mod
    grads, orig = [], step_mod.apply_gradients

    def record(opt, params, g, cfg):
        if len(grads) < 2:
            grads.append([torch.zeros_like(p) if t is None
                          else t.detach().clone() for p, t in zip(params, g)])
        orig(opt, params, g, cfg)

    step_mod.apply_gradients = record
    try:
        yield grads
    finally:
        step_mod.apply_gradients = orig


@contextlib.contextmanager
def timed_collectives():
    """Host seconds in torch.distributed's all_reduce and all_gather (each
    call synchronised before and after), added up in the yielded list."""
    import torch
    import torch.distributed as dist
    spent, origs = [0.0], (dist.all_reduce, dist.all_gather)

    def timed(fn):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            spent[0] += time.perf_counter() - t0
            return out
        return run

    dist.all_reduce, dist.all_gather = (timed(f) for f in origs)
    try:
        yield spent
    finally:
        dist.all_reduce, dist.all_gather = origs


def _dp_result(rec, counts, state, grads) -> dict:
    """A run's metrics, step times, launches, codebook counters after each
    step, running statistics and step-1 gradients, on the host."""
    return {"metrics": rec.metrics, "ms": rec.ms, "launches": rec.launches,
            "counts": counts,
            "running": {k: v.cpu() for k, v in state.disc.state_dict().items()
                        if "running" in k},
            "grads": [[g.cpu() for g in gs] for gs in grads]}


# phase 14(b) runs as a user runs it ("kernels"); the witnesses of
# tools/torch_dp_gap.py run the reference and the ranks under
# ops.plain_versions() ("plain"), with cuDNN off ("nocudnn": PyTorch's own
# convolutions, one GEMM per sample) or both ("nocudnn_plain")


@contextlib.contextmanager
def _dp_mode(mode: str):
    """The context a run of `mode` steps in."""
    import torch

    from control_gic_tpu_torch import ops
    with contextlib.ExitStack() as stack:
        if "plain" in mode:
            stack.enter_context(ops.plain_versions())
        if "nocudnn" in mode:
            stack.enter_context(torch.backends.cudnn.flags(enabled=False))
        yield


def dp_worker(rank: int, port: int, out: str, mode: str) -> None:
    """One rank of phase 14(b): a gloo group of 2 on cuda:0, rows
    [2r, 2r + 2) of each global batch, graphs=False, in `mode`;
    writes its metrics, step times, collective seconds, counters, running
    statistics and (rank 0) the step-1 gradients to out/rank<r>.pt."""
    import torch

    from control_gic_tpu_torch.parallel.multihost import initialize_multihost
    from control_gic_tpu_torch.train import Trainer, create_train_state
    from control_gic_tpu_torch.utils.device import use_fp32_pipes

    use_fp32_pipes()
    group = initialize_multihost(f"localhost:{port}", 2, rank,
                                 backend="gloo", device="cuda:0")
    cfg, tcfg = _dp_config()
    try:
        Trainer(cfg, tcfg, graphs=True, group=group)
        graphs_raise = False
    except ValueError:
        graphs_raise = True
    trainer = Trainer(cfg, tcfg, graphs=False, group=group)
    state = create_train_state(cfg, tcfg, device="cuda", seed=0)
    rec, n = StepRecorder(trainer), DP_GLOBAL_BATCH // 2
    with recorded_grads() as grads, timed_collectives() as spent, \
            _dp_mode(mode):
        counts = [rec.train_step(state, x[rank * n:(rank + 1) * n])[0]
                  .codebook_counts.cpu().clone() for x in dp_batches()]
    res = _dp_result(rec, counts, state, grads if rank == 0 else [])
    res.update(collective_s_per_step=spent[0] / DP_STEPS,
               graphs_raise=graphs_raise)
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()


LOOP_STEPS = 8


def loop_ms_per_step(workdir: str, grouped, alone) -> dict:
    """ms per step of cli/train.py's train_loop (host clock, one sync at
    the end) over LOOP_STEPS steps from step 100 (no image log, no metric
    log, no checkpoint in between; the closing checkpoint left out), for
    the (trainer, state) under the group and the one without, in turns,
    3 times each; the first turn is a warm-up."""
    import torch

    from control_gic_tpu_torch.cli import train as train_cli

    out, save = {"group": [], "no_group": []}, train_cli._save
    train_cli._save = lambda *a, **kw: None
    try:
        for turn in range(3):
            for name, (trainer, state) in (("group", grouped),
                                           ("no_group", alone)):
                state.step = 100
                args = _loop_args(workdir, 100 + LOOP_STEPS, f"loop_{name}")
                args.log_every = 10 ** 6
                batches = train_batches(900 + turn, LOOP_STEPS)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                train_cli.train_loop(args, trainer, state, batches)
                torch.cuda.synchronize()
                if turn:
                    out[name].append(1e3 * (time.perf_counter() - t0)
                                     / LOOP_STEPS)
    finally:
        train_cli._save = save
    return out


def _dp_nccl_one_rank(dev: dict, workdir: str) -> None:
    """Phase 14(a): the Trainer under an NCCL group of one rank, as CUDA
    graphs (the collectives captured) against graphs=False, both
    deterministic: launches per step exact, losses 1e-6 relative, state
    1e-5 of each tensor's max (and whether every value is equal); then ms
    per step with the group and without it, in turns, of the Trainer and
    of the train CLI's loop (loop_ms_per_step)."""
    import torch.distributed as dist

    from control_gic_tpu_torch.parallel.multihost import initialize_multihost
    from control_gic_tpu_torch.train import Trainer, create_train_state

    t0 = time.perf_counter()
    cfg, tcfg = _dp_config()
    group = initialize_multihost(f"localhost:{free_port()}", 1, 0,
                                 backend="nccl", device="cuda:0")
    try:
        reset_launches()
        (tr_g, st_g, rec_g, peak_g), (tr_e, st_e, rec_e, _), agree = \
            graphs_vs_eager("f32 nccl group of 1", cfg, tcfg,
                            train_batches(100, DP_STEPS), group=group)
        del tr_e, st_e, rec_e
        release()
        plain = Trainer(cfg, tcfg)
        plain_state = create_train_state(cfg, tcfg, device="cuda", seed=0)
        rec_grp, rec_plain = StepRecorder(tr_g), StepRecorder(plain)
        for x in train_batches(500, 4):
            rec_grp.train_step(st_g, x)
            rec_plain.train_step(plain_state, x)
        loop = loop_ms_per_step(workdir, (tr_g, st_g), (plain, plain_state))
        mean = lambda ms: sum(ms[1:]) / len(ms[1:])
        log("data parallel nccl group of 1", steps=DP_STEPS,
            step_ms=rec_g.ms, launches_per_step=rec_g.launches[0],
            graphs_vs_eager=agree, memory=peak_g,
            programs=tr_g.program_stats(),
            group_ms=rec_grp.ms, no_group_ms=rec_plain.ms,
            group_ms_mean=mean(rec_grp.ms),
            no_group_ms_mean=mean(rec_plain.ms),
            train_loop_ms_per_step=loop, card=dev["nvidia_smi"],
            seconds=time.perf_counter() - t0)
        del tr_g, st_g, rec_g, plain, plain_state, rec_grp, rec_plain
        release()
    finally:
        dist.destroy_process_group()


def _grad_gap(got, want) -> dict:
    """The step-1 gradients of a run against the reference's: each tensor's
    error over its max, the worst three (part, index: 0 the generator, 1
    the discriminator), the relative L2 error over the whole model and
    over each part."""
    num, den, per = [0.0, 0.0], [0.0, 0.0], []
    for part, (gs, ws) in enumerate(zip(got, want)):
        for i, (g, w) in enumerate(zip(gs, ws)):
            g, w = g.to(w.device), w
            per.append(((g - w).abs().max().item()
                        / max(w.abs().max().item(), 1e-30), part, i))
            num[part] += (g.double() - w.double()).square().sum().item()
            den[part] += w.double().square().sum().item()
    per.sort(reverse=True)
    return {"worst_rel": per[:3], "l2_rel": (sum(num) / sum(den)) ** 0.5,
            "l2_rel_by_part": [(n / max(d, 1e-300)) ** 0.5
                               for n, d in zip(num, den)]}


def dp_reference(mode: str, rows=slice(None)) -> dict:
    """This process's DP_STEPS steps on `rows` of each global batch, with
    no group, graphs=False, in `mode`."""
    from control_gic_tpu_torch.train import Trainer, create_train_state

    cfg, tcfg = _dp_config()
    trainer = Trainer(cfg, tcfg, graphs=False)
    state = create_train_state(cfg, tcfg, device="cuda", seed=0)
    rec = StepRecorder(trainer)
    with recorded_grads() as grads, _dp_mode(mode):
        counts = [rec.train_step(state, x[rows])[0].codebook_counts.cpu()
                  .clone() for x in dp_batches()]
    res = _dp_result(rec, counts, state, grads)
    del trainer, state, rec, grads
    release()
    return res


def dp_ranks(workdir: str, mode: str) -> list:
    """Two ranks (this script with --dp-worker) in `mode`: their results."""
    import torch

    out = os.path.join(workdir, f"dp_{mode}")
    os.makedirs(out)
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--dp-worker", str(r),
         str(port), out, mode], cwd=os.path.dirname(os.path.abspath(__file__)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    try:
        logs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, text in zip(procs, logs):
        if p.returncode != 0:
            raise AssertionError(f"data-parallel rank failed "
                                 f"({p.returncode}):\n{text[-3000:]}")
    return [torch.load(os.path.join(out, f"rank{r}.pt")) for r in range(2)]


def dp_gap(runs: list, want: dict) -> dict:
    """How far runs (the ranks, or one run) are from the reference `want`:
    the worst metric error over max(1, |value|), the step-1 gradients
    (_grad_gap; the first run's), the share of codebook counts moved after
    each step and whether they are equal, and the running statistics'
    worst error over each tensor's max."""
    import torch

    def moved(step):
        w = want["counts"][step]
        return max((r["counts"][step] - w).abs().sum().item() / 2
                   / w.sum().item() for r in runs)

    return dict(
        metric_worst_err=max(abs(g[k] - w[k]) / max(1.0, abs(w[k]))
                             for r in runs for g, w in zip(r["metrics"],
                                                           want["metrics"])
                             for k in w),
        grads=_grad_gap(runs[0]["grads"], want["grads"]),
        counts_equal=all(torch.equal(r["counts"][-1], want["counts"][-1])
                         for r in runs),
        counts_totals_equal=all(r["counts"][-1].sum()
                                == want["counts"][-1].sum() for r in runs),
        counts_moved_share=moved(-1),
        counts_moved_share_per_step=[moved(i) for i in range(DP_STEPS)],
        running_worst_rel_err=max(((r["running"][k] - w).abs().max()
                                   / w.abs().max()).item()
                                  for r in runs
                                  for k, w in want["running"].items()))


def _dp_timing(ranks: list, want: dict) -> dict:
    mean = lambda ms: sum(ms[1:]) / len(ms[1:])
    return dict(one_process_ms=want["ms"], rank_ms=[r["ms"] for r in ranks],
                one_process_ms_mean=mean(want["ms"]),
                rank_ms_mean=[mean(r["ms"]) for r in ranks],
                collective_s_per_step=[r["collective_s_per_step"]
                                       for r in ranks])


# phase 14(b)'s limits on the gap of the ranks to one process: each about
# 3-5 times the sound runs' readings on the H100 and far below the
# control's (PERF.md, phase 14(b))
DP_LIMITS = dict(metric=1e-3, grad_l2=5e-3, counts_moved=1e-3,
                 running=5e-4)


def _dp_within(gap: dict, lim: dict) -> bool:
    return (gap["metric_worst_err"] <= lim["metric"]
            and gap["grads"]["l2_rel"] <= lim["grad_l2"]
            and gap["counts_totals_equal"]
            and gap["counts_moved_share"] <= lim["counts_moved"]
            and gap["running_worst_rel_err"] <= lim["running"])


def _dp_two_ranks(dev: dict, workdir: str) -> dict:
    """Phase 14(b): two processes in a gloo group on cuda:0, each stepping
    on 2 rows of a global batch of 4 (graphs=False), against this process's
    steps on the whole batch. On the card the two sides do not round alike
    (the gap stays near 1e-4 in the gradients with plain attention and
    with cuDNN off, hundreds of times the reference's own run-to-run gap;
    tools/torch_dp_gap.py), and a VQ near-tie may flip: the ranks are held
    within DP_LIMITS (metrics over max(1, |value|); the step-1 gradients
    in the relative L2 norm over the whole model, since a tensor's own max
    is no yardstick where its true gradient is 0, a key bias; the
    counters' totals equal and the share moved; the running statistics
    over each tensor's max). The control, rank 0's rows stepped alone
    without a group (local thresholds and statistics, half the batch),
    must be outside every limit. Returns the launches of the ranks'
    steps."""
    t0 = time.perf_counter()
    want = dp_reference("kernels")
    control = dp_gap([dp_reference("kernels", slice(0, 2))], want)
    ranks = dp_ranks(workdir, "kernels")
    gap, lim = dp_gap(ranks, want), DP_LIMITS
    launches = ranks[0]["launches"]
    res = dict(global_batch=DP_GLOBAL_BATCH, ranks=2, steps=DP_STEPS,
               **gap, limits=lim, within=_dp_within(gap, lim),
               control_rows_alone=control,
               control_outside_every_limit=(
                   control["metric_worst_err"] > lim["metric"]
                   and control["grads"]["l2_rel"] > lim["grad_l2"]
                   and control["counts_moved_share"] > lim["counts_moved"]
                   and control["running_worst_rel_err"] > lim["running"]),
               flash_key_splits={f"batch_{b}": {c: flash_splits(
                   b, 4096, 4096, c, "float32") for c in (256, 512)}
                   for b in (DP_GLOBAL_BATCH // 2, DP_GLOBAL_BATCH)},
               rank_launches_per_step=launches,
               graphs_under_gloo_raise=[r["graphs_raise"] for r in ranks],
               **_dp_timing(ranks, want), card=dev["nvidia_smi"],
               seconds=time.perf_counter() - t0)
    log("data parallel 2 ranks vs 1 process", **res)
    if not (res["within"] and res["control_outside_every_limit"]
            and all(step == PER_TRAIN_STEP for r in ranks
                    for step in r["launches"])
            and all(res["graphs_under_gloo_raise"])):
        raise AssertionError(f"2 ranks differ from one process: {res}")
    return launches


def _train_pngs(workdir: str) -> str:
    """Four 256x256 PNGs for the train CLI (PIL)."""
    from PIL import Image
    pngs = os.path.join(workdir, "train_pngs")
    if not os.path.isdir(pngs):
        os.makedirs(pngs)
        for i in range(4):
            Image.fromarray((make_image(300 + i) * 255).astype("uint8")).save(
                os.path.join(pngs, f"{i}.png"))
    return pngs


def _dp_cli(workdir: str) -> None:
    """Phase 14(c): the train CLI under torch.distributed.run with one
    process (an NCCL group of one rank), 2 steps."""
    import importlib.util
    import json as _json

    from control_gic_tpu_torch.utils.checkpoint import latest_step

    if importlib.util.find_spec("PIL") is None:
        log("data parallel cli", skipped="PIL is not installed")
        return
    pngs = _train_pngs(workdir)
    ckpt, logs = (os.path.join(workdir, "dp_cli_ckpt"),
                  os.path.join(workdir, "dp_cli_logs"))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nnodes", "1",
         "--nproc_per_node", "1", "--master_port", str(free_port()),
         "-m", "control_gic_tpu_torch.cli.train", "--train-dir", pngs,
         "--steps", "2", "--batch-size", "2", "--log-every", "1",
         "--ckpt-dir", ckpt, "--log-dir", logs],
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
        text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"torchrun train CLI failed ({proc.returncode})"
                             f":\n{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    with open(os.path.join(logs, "metrics.jsonl")) as f:
        lines = [_json.loads(line) for line in f]
    summary = [line for line in proc.stdout.splitlines()
               if line.startswith("process ")]
    if latest_step(ckpt) != 2 or len(lines) != 2 or "nccl" not in "".join(
            summary):
        raise AssertionError(f"torchrun train CLI: checkpoint "
                             f"{latest_step(ckpt)}, {len(lines)} metric "
                             f"lines, {summary}")
    log("data parallel cli", launcher="torch.distributed.run, 1 process",
        group=summary, steps=2, checkpoint_step=2,
        last_metrics={k: lines[-1][k] for k in ("train/aeloss",
                                                "train/discloss")},
        seconds=time.perf_counter() - t0)


def phase_data_parallel(dev: dict, workdir: str) -> dict:
    """Phase 14: data-parallel training at full width in f32, 256x256.
    Returns the kernel launches of the 2-rank run's steps (rank 0)."""
    release()
    t0 = time.perf_counter()
    _dp_nccl_one_rank(dev, workdir)
    launches = _dp_two_ranks(dev, workdir)
    _dp_cli(workdir)
    log("data parallel", seconds=time.perf_counter() - t0)
    return launches


# ---------------------------------------------------------------- phase 15

SPATIAL_IMAGE = (1536, 2048)
SPATIAL_SHARDS_F32 = (1, 2, 4)
SPATIAL_SHARDS = (1, 2)


def cuda_mesh(n: int):
    """A mesh of n shards on cuda:0."""
    from control_gic_tpu_torch.parallel.mesh import make_mesh
    return make_mesh(n, devices=["cuda:0"] * n)


def _spatial_f32(dev: dict) -> None:
    """Phase 15(a): the f32 model on a 512x768 image, H-sharded over 1, 2
    and 4 shards on the card (kernels) against the single-device model
    under ops.plain_versions(): masks equal, VQ indices equal but for
    near-ties, the decode of the same indices within 1e-3 (absolute and
    relative); one flash launch per attention and shard."""
    import torch

    from control_gic_tpu_torch.models import CGIC, CGICConfig
    from control_gic_tpu_torch.ops import plain_versions
    from control_gic_tpu_torch.ops.quantize import codebook_gather, vq_lookup
    from control_gic_tpu_torch.parallel.halo import join_rows, split_rows
    from control_gic_tpu_torch.parallel.spatial_decoder import \
        decode_spatial_sharded
    from control_gic_tpu_torch.parallel.spatial_encoder import latent_shards

    t0 = time.perf_counter()
    model = CGIC(CGICConfig(dtype="float32"),
                 generator=torch.Generator().manual_seed(1)).cuda().eval()
    img = make_image(21, KODAK)
    x = torch.from_numpy(img).permute(2, 0, 1)[None].contiguous().cuda()
    rc, rm = RATIOS[0]
    cb = model.codebook.float()
    with torch.no_grad(), plain_versions():
        router = model.route(x, rc, rm)
        lat_p = model.latent(x, router)
        idx_p = vq_lookup(lat_p.float(), cb)
        rec_p = model.decode_indices(idx_p, router.masks)
        zq = codebook_gather(idx_p, model.codebook)
        z = model.post_quant_conv(zq)
    # both latents' nearest codes under one formula (kernels_vs_plain's)
    dist = lambda lat: ((lat[..., None] - cb.t()[None, :, None, None]) ** 2
                        ).sum(1)
    d_p = dist(lat_p.float())
    i_p = d_p.argmin(-1)
    rows, per_shard = [], None
    for n in SPATIAL_SHARDS_F32:
        mesh = cuda_mesh(n)
        devices = mesh.axis_devices("data")
        reset_launches()
        with torch.no_grad():
            lat, *masks = latent_shards(split_rows(x, devices),
                                        [model.encoder] * n,
                                        [model.quant_conv] * n, rc, rm)
            lat = join_rows(lat)
            masks = [join_rows(m, 1) for m in masks]
            rec = decode_spatial_sharded(mesh, model.decoder, z, zq,
                                         router.masks)
        torch.cuda.synchronize()
        flash = read_launches()["flash_attn_fwd"]
        per_shard = flash if n == 1 else per_shard
        err = (lat - lat_p).abs().max().item()
        i_s = dist(lat.float()).argmin(-1)
        d_min = d_p.gather(-1, i_p[..., None])[..., 0]
        gap = d_p.gather(-1, i_s[..., None])[..., 0] - d_min
        # a latent error moves a gap by at most 16 max|err| max|c|, and
        # the f32 sums of squares round at ~4 ulp of the distance
        near = 16 * err * cb.abs().max().item() + 2.0 ** -21 * d_min + 1e-7
        diff = i_s != i_p
        row = dict(shards=n, masks_equal=all(
            torch.equal(a, b) for a, b in zip(masks, router.masks)),
            latent_max_abs_err=err,
            latent_max_abs=lat_p.abs().max().item(),
            indices_differing=int(diff.sum()),
            differing_gaps=gap[diff][:6].tolist(),
            differing_near=near[diff][:6].tolist(),
            indices_differing_beyond_ties=int((diff & (gap > near)).sum()),
            recon_max_abs_err=(rec - rec_p).abs().max().item(),
            recon_rel_err=((rec - rec_p).abs().max()
                           / rec_p.abs().max()).item(),
            flash_launches=flash)
        rows.append(row)
        if not (row["masks_equal"] and not row["indices_differing_beyond_ties"]
                and row["recon_max_abs_err"] <= 1e-3
                and row["recon_rel_err"] <= 1e-3 and flash
                and flash == n * per_shard):
            raise AssertionError(f"sharded f32 at {n} shards: {row}")
    log("spatial f32 vs single device (plain)", image=list(KODAK),
        tol_recon=1e-3, rows=rows, seconds=time.perf_counter() - t0)


def _psnr(rec, img) -> float:
    import numpy as np
    mse = float(np.mean((np.clip(rec, 0, 1) - img) ** 2))
    return float(10 * np.log10(1.0 / max(mse, 1e-12)))


@contextlib.contextmanager
def flash_shapes():
    """The (B, Tq, Tk, C) and dtype of every flash forward launch inside,
    in a yielded set."""
    from control_gic_tpu_torch.ops import attention as A
    seen, orig = set(), A.flash_attention

    def record(q, k, v, *a, **kw):
        seen.add(((*q.shape[:2], k.shape[1], q.shape[2]),
                  str(q.dtype).replace("torch.", "")))
        return orig(q, k, v, *a, **kw)

    A.flash_attention = record
    try:
        yield seen
    finally:
        A.flash_attention = orig


def _spatial_bf16(dev: dict, codec, workdir: str, held) -> dict:
    """Phase 15(b): the bf16 codec on one 1536x2048 image through
    compress_spatial with 1 and 2 shards on the card and decode_spatial
    from the stream files, beside the single-device codec and the tiled
    codec on the same image, then the CLI with --spatial --mesh-devices 1
    on its PNG. Every flash forward shape of the sharded round trips must
    be one that phase 3 held against the plain version (`held`). Returns
    the flash launches of the 2-shard round trip."""
    import numpy as np
    import torch
    from PIL import Image

    from control_gic_tpu_torch.cli import infer_highres
    from control_gic_tpu_torch.codec import EncodedImage
    from control_gic_tpu_torch.models.blocks import AttnBlock
    from control_gic_tpu_torch.parallel.spatial_codec import (
        compress_spatial, decode_spatial)
    from control_gic_tpu_torch.parallel.tiling import compress_tiled

    t0 = time.perf_counter()
    img = make_image(31, SPATIAL_IMAGE)
    rc, rm = RATIOS[0]
    attns = sum(isinstance(m, AttnBlock) for m in codec.model.modules())
    # the single-device and the tiled codec: a first call captures their
    # programs, the second is timed
    timed = []
    for run in (lambda: codec.decode(codec.encode(img, rc, rm)),
                lambda: compress_tiled(codec, img, rc, rm, tile=TILE)):
        run()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        timed.append(1e3 * (time.perf_counter() - t1))
    solo = codec.encode(img, rc, rm)
    rec_solo = codec.decode(solo)
    ind_solo, masks_solo = codec._rebuild(solo)
    rec_t, bpp_t, _ = compress_tiled(codec, img, rc, rm, tile=TILE)
    res = dict(image=list(SPATIAL_IMAGE), attention_blocks=attns,
               single_device=dict(bpp=solo.bpp, psnr=_psnr(rec_solo, img),
                                  ms_per_image=timed[0]),
               tiled=dict(tile=TILE, bpp=bpp_t, psnr=_psnr(rec_t, img),
                          ms_per_image=timed[1]))
    launches = None
    for n in SPATIAL_SHARDS:
        mesh = cuda_mesh(n)
        compress_spatial(codec, img, rc, rm, mesh)        # warm-up
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t1 = time.perf_counter()
        rec, bpp, enc = compress_spatial(codec, img, rc, rm, mesh)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t1)
        counts = read_launches()
        peak = (torch.cuda.max_memory_allocated() - resident) / 2 ** 30
        d = os.path.join(workdir, f"spatial_{n}")
        enc.write(d)
        back = decode_spatial(codec, EncodedImage.read(
            d, enc.mode, enc.latent_hw, enc.image_hw), mesh)
        ind, masks = codec._rebuild(enc)
        with flash_shapes() as shapes:
            wall_us, busy, kernels, _ = device_profile(
                lambda: compress_spatial(codec, img, rc, rm, mesh))
        unheld = sorted(shapes - held)
        row = dict(bpp=bpp, psnr=_psnr(rec, img), ms_per_image=ms,
                   peak_gib=peak, flash_launches=counts["flash_attn_fwd"],
                   flash_shapes=sorted(shapes), flash_shapes_unheld=unheld,
                   masks_equal_single_device=all(
                       np.array_equal(a, b) for a, b in zip(masks,
                                                            masks_solo)),
                   indices_equal_share=float(np.mean(ind == ind_solo)),
                   files_decode_max_abs_err=float(np.abs(back - rec).max()),
                   profile_wall_ms=wall_us / 1e3,
                   device_busy_ms=None if busy is None else busy / 1e3,
                   device_idle_share=None if busy is None
                   else 1.0 - busy / wall_us, device_kernels=kernels)
        res[f"shards_{n}"] = row
        if not (row["flash_launches"] == n * attns and shapes and not unheld
                and row["masks_equal_single_device"]
                and row["files_decode_max_abs_err"] <= 1e-3
                and np.isfinite(rec).all() and rec.shape == img.shape):
            raise AssertionError(f"spatial bf16 at {n} shards: {row}")
        if n == 2:
            launches = counts
        del rec, back
        release()

    src = os.path.join(workdir, "spatial_png")
    os.makedirs(src)
    Image.fromarray((img * 255).astype(np.uint8)).save(
        os.path.join(src, "big.png"))
    t1 = time.perf_counter()
    records = infer_highres.main(
        ["-i", src, "-o", os.path.join(workdir, "spatial_cli"), "--spatial",
         "--mesh-devices", "1", "--ratios", str(rc), str(rm)], codec=codec)
    res["cli"] = dict(flags="--spatial --mesh-devices 1", bpp=records[0][1],
                      psnr=records[0][2], seconds=time.perf_counter() - t1)
    if not (len(records) == 1 and records[0][1] > 0
            and np.isfinite(records[0][2])):
        raise AssertionError(f"spatial CLI: {records}")
    log("spatial bf16", **res, card=dev["nvidia_smi"],
        seconds=time.perf_counter() - t0)
    return launches


def _tiled_mesh(dev: dict, codec) -> None:
    """Phase 15(c): compress_tiled with a 2-device mesh on cuda:0 on phase
    10's image (cropped as the CLI crops it). The mesh splits each group of
    two tiles into two batches of one, and on the card a batch of one need
    not round as a batch of two does (a convolution algorithm or the flash
    forward's key splits may follow the batch), so the streams are held
    against each tile encoded alone: byte-identical. Against mesh=None: the masks equal, and the
    share of tiles with equal streams and the bpp logged."""
    import numpy as np

    from control_gic_tpu_torch.parallel.tiling import (compress_tiled,
                                                       tile_grid)

    t0 = time.perf_counter()
    h, w = HIGHRES
    img = make_image(500, (-(-h // 32) * 32, -(-w // 32) * 32))[:h, :w]
    img = (img * 255).astype(np.uint8).astype(np.float32) / 255.0
    th, tw = h // 16 * 16, w // 16 * 16
    top, left = round((h - th) / 2), round((w - tw) / 2)
    img = np.ascontiguousarray(img[top:top + th, left:left + tw])
    rc, rm = RATIOS[0]
    rec, bpp, bundles = compress_tiled(codec, img, rc, rm, tile=TILE)
    rec_m, bpp_m, bundles_m = compress_tiled(codec, img, rc, rm, tile=TILE,
                                             mesh=cuda_mesh(2))
    solo = [codec.encode_batch(img[y:y + a, x:x + b][None], rc, rm)[0]
            for y, x, a, b in tile_grid(th, tw, TILE)]
    same_solo = [b.streams for b in bundles_m] == [b.streams for b in solo]
    masks_equal = all(
        all(np.array_equal(p, q) for p, q in zip(codec._rebuild(a)[1],
                                                 codec._rebuild(b)[1]))
        for a, b in zip(bundles, bundles_m))
    res = dict(image=[th, tw], tiles=len(solo), bpp=bpp, mesh_bpp=bpp_m,
               streams_equal_tile_alone=same_solo,
               masks_equal_unsharded=masks_equal,
               tiles_with_streams_equal_unsharded=sum(
                   a.streams == b.streams for a, b in zip(bundles,
                                                          bundles_m)),
               recon_max_abs_err_vs_unsharded=float(np.abs(rec - rec_m)
                                                    .max()),
               card=dev["nvidia_smi"], seconds=time.perf_counter() - t0)
    log("tiled mesh of 2 on one card", **res)
    if not (same_solo and masks_equal):
        raise AssertionError(f"compress_tiled(mesh=): {res}")


def phase_spatial(dev: dict, codec, workdir: str, held) -> dict:
    """Phase 15: the H-sharded codec at full width; `held`: the (shape,
    dtype) of each flash forward row of phase 3. Returns the launches of
    the 2-shard bf16 round trip."""
    release()
    t0 = time.perf_counter()
    _spatial_f32(dev)
    release()
    launches = _spatial_bf16(dev, codec, workdir, held)
    _tiled_mesh(dev, codec)
    log("spatial", seconds=time.perf_counter() - t0)
    return launches


def main() -> None:
    import tempfile

    import numpy as np

    from control_gic_tpu_torch.cli.common import build_codec
    from control_gic_tpu_torch.codec import CGICCodec

    t_start = time.perf_counter()
    dev = phase_device()
    phase_build()
    rows = phase_kernels(dev)
    t0 = time.perf_counter()
    codec = build_codec(device="cuda", seed=0)     # CUDA graphs, by default
    assert codec.model.config.dtype == "bfloat16", codec.model.config
    assert codec._programs.backend is not None
    # the same model and counts (build_codec's ones), every batch eager
    eager = CGICCodec(codec.model, np.ones(codec.model.config.n_embed,
                                           np.int64), graphs=False)
    log("main path setup", params=sum(p.numel()
                                      for p in codec.model.parameters()),
        dtype=codec.model.config.dtype, seconds=time.perf_counter() - t0)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        _, images = phase_main_path(dev, codec, workdir, IMAGE, 4,
                                    eager=eager)
        phase_profile(dev, codec, images[:2], "256x256", eager)
        launches, kodak = phase_main_path(dev, codec, workdir, KODAK, 2,
                                          eager=eager)
        phase_profile(dev, codec, kodak[:1], "512x768", eager)
        with switches(CONTROL_GIC_FUSED_NORM="1"):
            phase_main_path(dev, codec, workdir, IMAGE, 4,
                            PER_IMAGE_FUSED_NORM, " fused_norm1")
            phase_profile(dev, codec, images[:2], "256x256 fused_norm1")
        tiled = phase_tiled(dev, codec, workdir, eager)
    phase_entropy_pipeline(dev, codec, eager)
    unpack = phase_device_unpack(dev, codec)
    log("programs", **codec._programs.stats(), card=dev["nvidia_smi"])
    phase_f32_parity(make_image(0))
    phase_kodak_f32(codec, kodak[0])
    del eager
    with tempfile.TemporaryDirectory(prefix="chip_smoke_spatial_") as workdir:
        phase_spatial(dev, codec, workdir,
                      {(tuple(r["shape"]), r["dtype"]) for r in rows
                       if r["kernel"] == "flash_attn_fwd"})
    del codec
    phase_tile_f32(make_image(7, (TILE, TILE)))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as workdir:
        train_launches = phase_train(dev, workdir)
        phase_data_parallel(dev, workdir)

    # each kernel's row at its main path's shape, and its launches there:
    # the inference kernels (the moment pass and the apply kernel among
    # them) on the Kodak round trip, the training kernels in the 3 f32
    # training steps, the per-call op on the tiled codec under its
    # switches, the scan kernel (on the Kodak fine streams) in phase 13's
    # round trips of the default codec
    train_row = lambda name: next(r for r in rows if r["kernel"] == name
                                  and r["shape"] == [2, 4096, 4096, 512]
                                  and r["dtype"] == "float32")
    main_rows = {
        "flash_attn_fwd": next(r for r in rows if r["kernel"] == "flash_attn_fwd"
                               and r["shape"] == [1, 24576, 24576, 512]),
        "flash_attn_fwd_lse": train_row("flash_attn_fwd_lse"),
        "flash_attn_bwd_dkdv": train_row("flash_attn_bwd_dkdv"),
        "flash_attn_bwd_dq": train_row("flash_attn_bwd_dq"),
        "norm_conv_chain": next(r for r in rows if r["kernel"] == "norm_conv_chain"),
        "gn_moments": next(r for r in rows if r["kernel"] == "gn_moments"),
        "spatial_norm_apply": next(r for r in rows
                                   if r["kernel"] == "spatial_norm_apply"),
        "norm_conv": next(r for r in rows if r["kernel"] == "norm_conv"),
        "huffman_scan": unpack["row"],
    }
    nc = tiled["chain0_norm_conv1"]
    main_launches = {"flash_attn_fwd": launches["flash_attn_fwd"],
                     "flash_attn_fwd_lse": train_launches["flash_attn_fwd_lse"],
                     "flash_attn_bwd_dkdv": train_launches["flash_attn_bwd_dkdv"],
                     "flash_attn_bwd_dq": train_launches["flash_attn_bwd_dq"],
                     "norm_conv_chain": launches["chain_gn"] + launches["chain_sn"],
                     "gn_moments": launches["gn_moments"],
                     "spatial_norm_apply": launches["spatial_norm_apply"],
                     "norm_conv": nc["norm_conv_gn"] + nc["norm_conv_sn"],
                     "huffman_scan": unpack["launches"]}
    kernels = [dict(name=name, **KERNELS[name],
                    launches=main_launches[name],
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
    if sys.argv[1:2] == ["--dp-worker"]:     # a rank of phase 14(b)
        dp_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
                  sys.argv[5])
    else:
        main()
