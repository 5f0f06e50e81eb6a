"""Triple-grain entropy router: a pure function, no parameters
(port of control_gic_tpu/ops/router.py).

Thresholds are the k-th smallest entropy over the batch-flattened map
(sorted[k-1], sorted[0] when k == 0), with k = round(N * ratio) taken by
Python's banker's rounding on host floats, and comparisons strict `<` (ties
at the threshold go to the finer grain). The medium threshold runs over the
entropy map with the coarse area zeroed, at k = round(4*N16*r_c + N8*r_m).
The 7 compression modes are keyed by which ratios are zero; the mode is a
Python int. per_sample=True takes thresholds per batch element.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from .resample import upsample_nearest


class RouterOutput(NamedTuple):
    mask_coarse: torch.Tensor   # [B, H16, W16] int32 (1 = coarse here)
    mask_medium: torch.Tensor   # [B, H8,  W8 ] int32
    mask_fine: torch.Tensor     # [B, H4,  W4 ] int32
    mode: int                   # compression mode 0..6

    @property
    def masks(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        return (self.mask_coarse, self.mask_medium, self.mask_fine)


def mode_from_ratios(coarse_ratio: float, medium_ratio: float) -> int:
    """Compression mode 0-6 from the ratio triple (fine = 1 - c - m)."""
    c, m = float(coarse_ratio), float(medium_ratio)
    f = max(1.0 - c - m, 0.0)
    zeros = (c == 0, m == 0, f == 0)
    if sum(zeros) == 0:
        return 0
    if sum(zeros) == 1:
        return 1 if zeros[0] else (2 if zeros[1] else 3)
    return 4 if c != 0 else (5 if m != 0 else 6)


def triple_grain_router(e16: torch.Tensor, e8: torch.Tensor,
                        coarse_ratio: float, medium_ratio: float,
                        per_sample: bool = False) -> RouterOutput:
    """e16: [B, H16, W16] and e8: [B, 2*H16, 2*W16] entropy maps; the ratios
    are Python floats with fine = 1 - coarse - medium."""
    coarse_ratio = float(coarse_ratio)
    medium_ratio = float(medium_ratio)
    fine_ratio = 1.0 - coarse_ratio - medium_ratio
    if not (0.0 <= coarse_ratio <= 1.0 and 0.0 <= medium_ratio <= 1.0
            and fine_ratio >= -1e-9):
        raise ValueError(
            f"invalid grain ratios: coarse={coarse_ratio} "
            f"medium={medium_ratio} (fine = 1 - c - m = {fine_ratio}); "
            "each must be in [0, 1] and sum to at most 1")
    fine_ratio = max(fine_ratio, 0.0)

    b, h16, w16 = e16.shape
    _, h8, w8 = e8.shape
    assert (h8, w8) == (2 * h16, 2 * w16), (tuple(e16.shape), tuple(e8.shape))
    nb = 1 if per_sample else b
    n16 = nb * h16 * w16
    n8 = nb * h8 * w8
    e16 = e16.float()
    e8 = e8.float()
    dev = e16.device

    def threshold(vals: torch.Tensor, k: int) -> torch.Tensor:
        idx = k - 1 if k != 0 else 0
        if per_sample:
            s = torch.sort(vals.reshape(b, -1), dim=-1).values
            return s[:, idx][:, None, None]
        return torch.sort(vals.reshape(-1)).values[idx]

    def full(h, w, value: bool) -> torch.Tensor:
        return torch.full((b, h, w), value, dtype=torch.bool, device=dev)

    num_zero = (int(fine_ratio == 0) + int(medium_ratio == 0)
                + int(coarse_ratio == 0))
    if num_zero == 0:
        mode = 0
        gate_c = e16 < threshold(e16, round(n16 * coarse_ratio))
        not_c = ~upsample_nearest(gate_c, 2)
        e8_masked = e8 * not_c.float()
        k_m = round(4 * n16 * coarse_ratio + n8 * medium_ratio)
        gate_m = (e8 < threshold(e8_masked, k_m)) & not_c
        gate_f = ~(upsample_nearest(gate_c, 4) | upsample_nearest(gate_m, 2))
    elif num_zero == 1:
        if coarse_ratio == 0:
            mode = 1
            gate_m = e8 < threshold(e8, round(n8 * medium_ratio))
            gate_f = ~upsample_nearest(gate_m, 2)
            gate_c = full(h16, w16, False)
        elif medium_ratio == 0:
            mode = 2
            gate_c = e16 < threshold(e16, round(n16 * coarse_ratio))
            gate_f = ~upsample_nearest(gate_c, 4)
            gate_m = full(h8, w8, False)
        else:
            mode = 3
            gate_c = e16 < threshold(e16, round(n16 * coarse_ratio))
            gate_m = ~upsample_nearest(gate_c, 2)
            gate_f = full(2 * h8, 2 * w8, False)
    else:
        mode = 4 if coarse_ratio != 0 else (5 if medium_ratio != 0 else 6)
        gate_c = full(h16, w16, mode == 4)
        gate_m = full(h8, w8, mode == 5)
        gate_f = full(2 * h8, 2 * w8, mode == 6)

    return RouterOutput(mask_coarse=gate_c.to(torch.int32),
                        mask_medium=gate_m.to(torch.int32),
                        mask_fine=gate_f.to(torch.int32), mode=mode)


def grain_indices_from_masks(out: RouterOutput) -> torch.Tensor:
    """Partition map on the fine grid: 0 = coarse, 1 = medium, 2 = fine."""
    up_m = upsample_nearest(out.mask_medium, 2)
    return (up_m + 2 * out.mask_fine).to(torch.int32)
