"""Evaluation metrics (port of control_gic_tpu/utils/metrics.py).

psnr is the primary distortion metric; l2 and dssim are the reference's
"FakeNet" comparison metrics (networks_basic.py:141-177, RGB colorspace),
the LPIPS harness's drop-in alternatives. All on numpy arrays in f64.
"""
from __future__ import annotations

import numpy as np


def psnr(a: np.ndarray, b: np.ndarray, data_range: float = 1.0) -> float:
    """PSNR in dB between arrays in the same range."""
    mse = float(np.mean((np.asarray(a, np.float64)
                         - np.asarray(b, np.float64)) ** 2))
    if mse == 0:
        return float("inf")
    return 10.0 * np.log10(data_range ** 2 / mse)


def l2(a: np.ndarray, b: np.ndarray) -> float:
    """Mean squared error (the reference's L2 FakeNet in RGB,
    networks_basic.py:147-155)."""
    return float(np.mean((np.asarray(a, np.float64)
                          - np.asarray(b, np.float64)) ** 2))


def ssim(a: np.ndarray, b: np.ndarray, data_range: float = 1.0,
         win: int = 7) -> float:
    """Mean SSIM with a uniform win x win window over the valid region, in
    f64. a, b: [H, W, C] (or [H, W]); the channels are averaged."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.ndim == 2:
        a, b = a[..., None], b[..., None]
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2

    def box(x):
        # the separable uniform filter, valid region
        k = np.ones(win) / win
        x = np.apply_along_axis(lambda v: np.convolve(v, k, "valid"), 0, x)
        return np.apply_along_axis(lambda v: np.convolve(v, k, "valid"), 1, x)

    mu_a, mu_b = box(a), box(b)
    var_a = box(a * a) - mu_a ** 2
    var_b = box(b * b) - mu_b ** 2
    cov = box(a * b) - mu_a * mu_b
    s = ((2 * mu_a * mu_b + c1) * (2 * cov + c2)
         / ((mu_a ** 2 + mu_b ** 2 + c1) * (var_a + var_b + c2)))
    return float(s.mean())


def dssim(a: np.ndarray, b: np.ndarray, data_range: float = 1.0) -> float:
    """(1 - SSIM) / 2 (the reference's DSSIM FakeNet, networks_basic.py:
    165-177, RGB)."""
    return (1.0 - ssim(a, b, data_range)) / 2.0
