"""The share of the codec's SpatialNorm calls (those outside a chain) that
ran the moment pass and the apply kernel, over the run, set-up and window:
100 apply launches / (apply launches + calls that ran the reference formula
where the kernels could run: a CUDA tensor outside plain_versions()), in %.
Read from the port's counters in this process
(ops/fused_norm.py's KERNEL_LAUNCHES and PLAIN_CALLS, to which CUDA-graph
replays add as the wrappers do); None where the port has no PLAIN_CALLS or
counted no call."""
import importlib


def read(d):
    fn = importlib.import_module("control_gic_tpu_torch.ops.fused_norm")
    plain = getattr(fn, "PLAIN_CALLS", None)
    if plain is None:
        return None
    kernel = fn.KERNEL_LAUNCHES["spatial_norm_apply"]
    total = kernel + plain["spatial_norm"]
    return 100.0 * kernel / total if total else None
