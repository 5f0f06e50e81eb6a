"""The share of the codec's attentions from FLASH_MIN_TOKENS keys on that
ran the flash forward kernel, over the run, set-up and window: 100 forward
launches / (forward launches + calls that ran the plain path where the
kernel could run: a CUDA tensor outside plain_versions() with at least
FLASH_MIN_TOKENS keys), in %. Read from the port's counters in this process
(ops/attention.py's KERNEL_LAUNCHES and PLAIN_CALLS, to which CUDA-graph
replays add as the wrappers do); None where the port has no PLAIN_CALLS or
counted no call."""
import importlib


def read(d):
    attn = importlib.import_module("control_gic_tpu_torch.ops.attention")
    plain = getattr(attn, "PLAIN_CALLS", None)
    if plain is None:
        return None
    kernel = attn.KERNEL_LAUNCHES["flash_fwd"]
    total = kernel + plain["attention"]
    return 100.0 * kernel / total if total else None
