"""Optimizer and learning-rate schedule (sunerf_tpu/train/optim.py): Adam
with exponential decay from 1e-4 toward 1e-5 over 1e6 steps, floored at
5e-5, after global-norm gradient clipping at 0.5.

The JAX package chains optax.clip_by_global_norm and optax.adam. Here the
clip is optax's formula, written out (torch.nn.utils.clip_grad_norm_ divides
by norm + 1e-6 instead), and the step is torch.optim.Adam with its learning
rate set before each step to the schedule at the count of updates made so
far, as optax reads it (the first update uses lr(0)). Adam's defaults agree:
b1 0.9, b2 0.999, eps added outside the square root.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    lr_start: float = 1e-4
    lr_end: float = 1e-5
    lr_iterations: float = 1e6
    lr_floor: float = 5e-5
    grad_clip: float = 0.5
    # learning-rate multiplier of feature-grid tables; 1.0 = off
    table_lr_mult: float = 1.0
    adam_eps: float = 1e-8

    def __post_init__(self):
        if self.table_lr_mult != 1.0:
            raise NotImplementedError(
                'table_lr_mult: feature-grid tables are not ported yet '
                '(ROADMAP Queue 1 item 10, grid encodings)')


def lr_schedule(config: OptimConfig = OptimConfig()):
    """step -> lr = max(lr_start * gamma**step, lr_floor) with
    gamma = (lr_end / lr_start)**(1 / lr_iterations), in float32 as the JAX
    package's jitted optimizer evaluates it (its step count is an int32
    array, so gamma and the power are float32)."""
    gamma = np.float32((config.lr_end / config.lr_start) ** (1.0 / config.lr_iterations))
    start, floor = np.float32(config.lr_start), np.float32(config.lr_floor)

    def schedule(step: int) -> float:
        return float(max(start * gamma ** np.float32(step), floor))

    return schedule


def clip_by_global_norm(grads: list, max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm in place: every gradient is left as it is
    when the global norm is below max_norm, else replaced by
    (g / norm) * max_norm. Returns the norm. No host synchronisation."""
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, (g / norm) * max_norm))
    return norm


class Optimizer:
    """Global-norm clip, then Adam on the schedule, over parameter tensors
    that the step updates in place (the JAX package's make_optimizer)."""

    def __init__(self, config: OptimConfig = OptimConfig()):
        self.config = config
        self.schedule = lr_schedule(config)

    def init(self, params: list) -> torch.optim.Adam:
        """The optimizer state: a torch.optim.Adam over `params`."""
        return torch.optim.Adam(params, lr=self.schedule(0), betas=(0.9, 0.999),
                                eps=self.config.adam_eps)

    def update(self, adam: torch.optim.Adam, count: int) -> torch.Tensor:
        """Clip the parameters' .grad, then take Adam's step `count` (the
        number of updates made before this one) at lr(count). Returns the
        global gradient norm before clipping."""
        grads = [p.grad for group in adam.param_groups for p in group['params']]
        norm = clip_by_global_norm(grads, self.config.grad_clip)
        for group in adam.param_groups:
            group['lr'] = self.schedule(count)
        adam.step()
        return norm


def make_optimizer(config: OptimConfig = OptimConfig()) -> Optimizer:
    return Optimizer(config)
