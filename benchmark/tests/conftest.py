"""The benchmark's own tests (run with `python -m pytest benchmark/tests`).
They import the port and the benchmark, never JAX. Tests that need a CUDA
card carry the `card` marker and take the `card` fixture, which skips
without one. Under several workers give each few threads
(`OMP_NUM_THREADS=2 python -m pytest -n 4 benchmark/tests`: about a minute
on 8 cores; torch's default of a thread a core in each worker takes tens
of minutes there)."""
import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (BENCH, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)

# a small model and small images, for the CPU
TINY = {"n_embed": 64, "embed_dim": 4, "z_channels": 4, "ch": 32,
        "ch_mult": [1, 1, 2, 2, 2], "num_res_blocks": 1,
        "attn_resolutions": [8], "resolution": 64, "dropout": 0.0,
        "dtype": "float32"}
TINY_TRAFFIC = {
    "kodak-pipe": {"image_hw": [64, 96], "pool": 6, "check_images": 2,
                   "batches_per_call": 2},
    "kodak-single": {"image_hw": [64, 96], "pool": 6, "check_images": 2},
    "div2k-tiled": {"image_hw": [70, 100], "pool": 4, "check_images": 1,
                    "tile": 48, "images_per_call": 2},
    "train-256": {"image_hw": [64, 64], "pool": 8},
    # a point of each of modes 0-3, and two points of mode 0
    "kodak-mixrate": {"image_hw": [64, 96], "pool": 6, "batches_per_call": 1,
                      "warm_up_batches": 1,
                      "points": [[0.1, 0.4], [0.3, 0.5], [0.0, 0.8],
                                 [0.3, 0.0], [0.5, 0.5]]},
}


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


def tiny_run(workload, seed=2 ** 31 + 7, **kw):
    """One CPU run of `workload` at the tiny size."""
    from common import harness
    return harness.run(workload, seed, 0.2, False, device="cpu",
                       config_override={"model": dict(TINY)},
                       traffic_override=TINY_TRAFFIC[workload],
                       log=lambda s: None, **kw)
