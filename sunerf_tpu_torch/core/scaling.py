"""Image intensity scaling and datetime normalization
(sunerf_tpu/core/scaling.py)."""
from __future__ import annotations

import math
from datetime import datetime, timedelta

import torch

DEFAULT_SECONDS_PER_DT = 86400.0


def image_asinh_scaling(image: torch.Tensor, vmax: float = 1.0,
                        a: float = 0.005) -> torch.Tensor:
    """asinh(I / (vmax * a)) / asinh(1 / a) — compresses EUV dynamic range."""
    normalization = math.asinh(1.0 / a)
    return torch.asinh(image / (vmax * a)) / normalization


def image_log_scaling(image: torch.Tensor, vmin: float, vmax: float) -> torch.Tensor:
    return (torch.log(image) - vmin) / (vmax - vmin)


def normalize_datetime(date: datetime, seconds_per_dt: float = DEFAULT_SECONDS_PER_DT,
                       ref_time: datetime | None = None) -> float:
    """datetime -> float model time: (date - ref_time) / seconds_per_dt."""
    if ref_time is None:
        ref_time = datetime(2010, 1, 1)
    return (date - ref_time).total_seconds() / seconds_per_dt


def unnormalize_datetime(norm_date: float, seconds_per_dt: float = DEFAULT_SECONDS_PER_DT,
                         ref_time: datetime | None = None) -> datetime:
    if ref_time is None:
        ref_time = datetime(2010, 1, 1)
    return ref_time + timedelta(seconds=norm_date * seconds_per_dt)
