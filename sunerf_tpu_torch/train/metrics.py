"""Image quality metrics: PSNR, SSIM, MAE%, ME% (a copy of
sunerf_tpu/train/metrics.py; the port imports nothing of the JAX package).

Protocol matches the reference evaluation
(sunerf/train/callback.py:54-58, evaluation/stash/metrics_simulation.py:48-76):
PSNR from MSE on scaled images, SSIM with skimage's defaults (uniform 7x7
window, K1=0.01, K2=0.03), MAE/ME as percentages of the ground-truth mean.
Implemented natively (no scikit-image on this image).
"""
from __future__ import annotations

import numpy as np


def psnr(pred: np.ndarray, target: np.ndarray, data_range: float | None = None) -> float:
    mse = float(np.mean((np.asarray(pred, np.float64) - np.asarray(target, np.float64)) ** 2))
    if mse == 0:
        return float('inf')
    if data_range is None:
        return -10.0 * np.log10(mse)
    return 10.0 * np.log10(data_range ** 2 / mse)


def _uniform_filter_2d(img: np.ndarray, size: int) -> np.ndarray:
    """Mean filter via 2-D cumulative sums ('valid' region only)."""
    pad = np.zeros((img.shape[0] + 1, img.shape[1] + 1), np.float64)
    pad[1:, 1:] = np.cumsum(np.cumsum(img, axis=0), axis=1)
    s = (pad[size:, size:] - pad[:-size, size:] - pad[size:, :-size]
         + pad[:-size, :-size])
    return s / (size * size)


def ssim(pred: np.ndarray, target: np.ndarray, data_range: float | None = None,
         win_size: int = 7, k1: float = 0.01, k2: float = 0.03) -> float:
    """Structural similarity (Wang et al. 2004), skimage-default parameters."""
    x = np.asarray(pred, np.float64)
    y = np.asarray(target, np.float64)
    if data_range is None:
        data_range = float(y.max() - y.min()) or 1.0

    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2

    # sample (unbiased) covariance normalization, as skimage uses
    n = win_size * win_size
    cov_norm = n / (n - 1)

    ux = _uniform_filter_2d(x, win_size)
    uy = _uniform_filter_2d(y, win_size)
    uxx = _uniform_filter_2d(x * x, win_size)
    uyy = _uniform_filter_2d(y * y, win_size)
    uxy = _uniform_filter_2d(x * y, win_size)

    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)

    s = ((2 * ux * uy + c1) * (2 * vxy + c2)) / ((ux ** 2 + uy ** 2 + c1) * (vx + vy + c2))
    return float(s.mean())


def mae_percent(pred: np.ndarray, target: np.ndarray) -> float:
    """Mean absolute error as % of the ground-truth mean."""
    t = np.asarray(target, np.float64)
    return float(np.mean(np.abs(np.asarray(pred, np.float64) - t)) / (np.mean(np.abs(t)) + 1e-12) * 100.0)


def me_percent(pred: np.ndarray, target: np.ndarray) -> float:
    """Mean (signed) error as % of the ground-truth mean."""
    t = np.asarray(target, np.float64)
    return float(np.mean(np.asarray(pred, np.float64) - t) / (np.mean(np.abs(t)) + 1e-12) * 100.0)
