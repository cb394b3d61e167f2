"""Differenced two-run-length timing of a call on the card
(sunerf_tpu/utils/timing.py).

A CUDA launch returns before the card has run it, so each run of calls ends
by synchronising the device of the last call's result (nothing to wait for
on the CPU); fixed launch and synchronisation overhead is cancelled by
differencing two run lengths. For the device time of one kernel, prefer
CUDA events or a CUDA graph (utils/profiling.timeit).
"""
from __future__ import annotations

import time

import torch


def _synchronize(result):
    """Waits for the card that holds `result` (a tensor, or a tuple, list or
    dict of them); nothing on the CPU."""
    if isinstance(result, dict):
        result = list(result.values())
    if isinstance(result, (tuple, list)):
        for r in result:
            _synchronize(r)
    elif isinstance(result, torch.Tensor) and result.device.type == 'cuda':
        torch.cuda.synchronize(result.device)


def measure_differenced(fn, n1: int = 3, n2: int = 13, warmup: int = 2):
    """Median-free single estimate: ((time of n2 calls) - (time of n1 calls))
    / (n2 - n1), each run ending when the card has finished fn's result."""

    def run(k):
        r = None
        t0 = time.perf_counter()
        for _ in range(k):
            r = fn()
        _synchronize(r)
        return time.perf_counter() - t0

    run(warmup)
    return (run(n2) - run(n1)) / (n2 - n1)


def measure_median(fn, reps: int = 3, **kwargs) -> float:
    """Median of `reps` differenced measurements (seconds per call)."""
    ts = sorted(measure_differenced(fn, **kwargs) for _ in range(reps))
    return ts[len(ts) // 2]
