#!/usr/bin/env python3
"""Run one cell of the benchmark of the PyTorch and CUDA port once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with as many CUDA devices as the
cell asks for. Prints the set-up's parts on an earlier line, each number
the comparison with the reference read beside its limit as the last lines
of standard error, and one JSON object as the last line of standard
output: `correct`, `attempted`, `failed`, `metrics` (the cell's end-to-end
metrics, or with --trace 1 its per-layer ones), `device`, with --trace 1
`breakdown`, and `checks` last. Exits non-zero, printing no result, without
the devices, without the program, or if the run loaded JAX or the JAX
package. BENCHMARK.json names the cells and metrics; see
benchmark/common/harness.py for where each part is found.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(1, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    from common import harness
    return harness.main(ap.parse_args())


if __name__ == "__main__":
    sys.exit(main())
