"""Datetime normalization (sunerf_tpu/core/scaling.py:27-40).

The image intensity scalings come with the training slice.
"""
from __future__ import annotations

from datetime import datetime, timedelta

DEFAULT_SECONDS_PER_DT = 86400.0


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
