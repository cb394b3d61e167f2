"""Instrument normalization tables and image prep helpers (a copy of
sunerf_tpu/data/norms.py; the port imports nothing of the JAX package).

Values from the reference (sunerf/data/utils.py:8-25): per-wavelength linear
vmax normalizations for SDO/AIA, PSI synthetic renders, and Solar Orbiter EUI.
The stretch "is connected to NeRF" (utils.py:10) — training images are scaled
to [0, ~1] by these constants and the asinh scaling happens in the loss.
"""
from __future__ import annotations

import numpy as np

# vmin=0, linear stretch
SDO_NORMS = {171: 8600.0, 193: 9800.0, 195: 9800.0, 211: 5800.0,
             284: 5800.0, 304: 8800.0}
PSI_NORMS = {171: 22348.267578125, 193: 50000.0, 211: 13503.1240234375}
SO_NORMS = {304: 300.0, 174: 300.0}


def normalize(data: np.ndarray, vmax: float, vmin: float = 0.0,
              clip: bool = False) -> np.ndarray:
    out = (data.astype(np.float32) - vmin) / (vmax - vmin)
    if clip:
        out = np.clip(out, 0.0, 1.0)
    return out


def unnormalize(data: np.ndarray, vmax: float, vmin: float = 0.0) -> np.ndarray:
    return data.astype(np.float32) * (vmax - vmin) + vmin


def remove_nans(stack: np.ndarray) -> np.ndarray:
    stack = np.asarray(stack, np.float32).copy()
    stack[~np.isfinite(stack)] = 0.0
    return stack


def percentile_clip(stack: np.ndarray, percent: float) -> np.ndarray:
    """Clip each channel at its (100-percent) percentile and floor negatives
    (reference utils.py:117-123; percent=0.25 means 0.25%)."""
    stack = np.asarray(stack, np.float32).copy()
    for i in range(stack.shape[0]):
        hi = np.percentile(stack[i].reshape(-1), 100 - percent)
        stack[i][stack[i] < 0] = 0
        stack[i][stack[i] > hi] = hi
    return stack


def block_reduce_mean(image: np.ndarray, factor: int) -> np.ndarray:
    """Mean-pool the trailing two axes by an integer factor (replaces
    skimage.measure.block_reduce at multi_thermal_loader.py:226)."""
    if factor <= 1:
        return image
    *lead, h, w = image.shape
    h2, w2 = h // factor * factor, w // factor * factor
    img = image[..., :h2, :w2]
    img = img.reshape(*lead, h2 // factor, factor, w2 // factor, factor)
    return img.mean(axis=(-3, -1))
