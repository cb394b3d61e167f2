"""Throughput accounting over logged training windows (a copy of
sunerf_tpu/utils/throughput.py; the port imports nothing of the JAX package).

The Trainer logs a rays/s sample per logging window (StepTimer resets at
each log point). Summarizing a run — especially a multi-phase one (budget
annealing: scripts/psi_protocol.py) — needs care:

* a window that contains a phase start absorbs that phase's warm-up (the
  kernels' first build, the allocator's first growth) and must be dropped
  (the single-phase convention is rates[1:]);
* phases run at different rates AND different window lengths, so the
  steady-state effective rate is the ray-weighted harmonic mean
  (total rays / total time), not the plain mean of window rates.
"""
from __future__ import annotations

from typing import Iterable, Sequence, Tuple


def effective_rate(samples: Iterable[Tuple[int, float]],
                   phase_starts: Sequence[int] = (0,)) -> float:
    """Steady-state rays/s over logged (step, rays_per_sec) samples.

    Args:
        samples: (logged step, window rays/s) pairs in any order.
        phase_starts: steps at which a new phase takes over (always
            includes 0). Windows containing a phase start are dropped — they
            absorb its warm-up.

    Returns:
        total rays / total time over the kept windows (ray-weighted
        harmonic mean of the window rates).

    Raises:
        ValueError: when no window survives the compile-window drop.
    """
    kept, prev = [], 0
    for step_i, rate_i in sorted(samples):
        w = step_i - prev
        if w > 0 and rate_i > 0 and not any(
                prev <= s < step_i for s in phase_starts):
            kept.append((w, rate_i))
        prev = step_i
    if not kept:
        raise ValueError('no logging windows survive the compile-window '
                         'drop; log more often or train longer')
    return sum(w for w, _ in kept) / sum(w / r for w, r in kept)
