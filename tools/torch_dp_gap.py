"""Where the gap between two data-parallel ranks and one process comes from,
on a CUDA card: chip_smoke.py's phase 14(b) in its three modes, with no
limit applied.

    python3 tools/torch_dp_gap.py

Two gloo ranks on cuda:0, each stepping on 2 rows of a global batch of 4
(full-width f32 model, 256x256, 2 steps, graphs=False), against one process
on the whole batch:
  - "kernels": as a user runs them;
  - "plain": the reference and the ranks under ops.plain_versions();
  - "nocudnn": both with cuDNN off (PyTorch's own convolutions, one GEMM a
    sample, whatever the batch);
  - "nocudnn_plain": both;
and the control, rank 0's rows stepped alone without a group, and the
kernels' reference run again (the run-to-run floor), against the kernels'
reference. Prints one JSON line per mode (chip_smoke.dp_gap's
readings) and the card's name and power limit.
"""
from __future__ import annotations

import json
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as C  # noqa: E402


def main() -> None:
    from control_gic_tpu_torch.utils.device import use_fp32_pipes
    dev = C.phase_device()
    C.phase_build()
    use_fp32_pipes()
    modes = ("kernels", "plain", "nocudnn", "nocudnn_plain")
    refs = {m: C.dp_reference(m) for m in modes}
    out = {"control_rows_alone": C.dp_gap(
        [C.dp_reference("kernels", slice(0, 2))], refs["kernels"]),
        "reference_again": C.dp_gap([C.dp_reference("kernels")],
                                    refs["kernels"])}
    with tempfile.TemporaryDirectory(prefix="dp_gap_") as workdir:
        for mode in modes:
            ranks = C.dp_ranks(workdir, mode)
            out[mode] = dict(**C.dp_gap(ranks, refs[mode]),
                             reference_ms=refs[mode]["ms"],
                             rank_ms=[r["ms"] for r in ranks])
    for name, row in out.items():
        print(json.dumps({"mode": name, **row}, default=str), flush=True)
    print(dev["nvidia_smi"], flush=True)


if __name__ == "__main__":
    main()
