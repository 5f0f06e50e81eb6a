"""What the per-layer metrics' readers share. Each reader takes the traced
run's data (the harness's `window_s`, `busy_s`, `device_ops`, `card`, and
what the driver's `layer_data` gives) and returns a number, or None where
it finds nothing to read."""
from __future__ import annotations

from typing import Optional

from . import flops
from .trace import seconds_matching


def idle_share(d: dict) -> Optional[float]:
    """100 (1 - busy / window), in %."""
    if not d.get("busy_s") or not d.get("window_s"):
        return None
    return 100.0 * (1.0 - d["busy_s"] / d["window_s"])


def mfu(d: dict, dtype: str) -> Optional[float]:
    """The model's operations in the window over the window and the card's
    peak for `dtype`, in %."""
    if not d.get("items") or not d.get("flops_per_item"):
        return None
    bf16, f32, _ = flops.card_peaks(d["card"])
    peak = bf16 if dtype == "bfloat16" else f32
    return 100.0 * d["flops_per_item"] * d["items"] / d["window_s"] / peak


def roofline(d: dict, key: str, pattern: str, bound_fn) -> Optional[float]:
    """The bound time of the attentions `key` lists per item, times the
    items, over the device time of the kernels whose names hold `pattern`,
    in %."""
    attns = d.get(key)
    spent = seconds_matching(d.get("device_ops", {}), pattern)
    if not attns or not d.get("items") or spent <= 0:
        return None
    bf16, f32, bw = flops.card_peaks(d["card"])
    bf = d["dtype"] == "bfloat16"
    bound = bound_fn(attns, 2 if bf else 4, bf16 if bf else f32, bw)
    return 100.0 * bound * d["items"] / spent
