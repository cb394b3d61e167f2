"""Optimizer and learning-rate schedule (sunerf_tpu/train/optim.py): Adam
with exponential decay from 1e-4 toward 1e-5 over 1e6 steps, floored at
5e-5, after global-norm gradient clipping at 0.5.

The JAX package chains optax.clip_by_global_norm and optax.adam. Here the
clip is optax's formula, written out (torch.nn.utils.clip_grad_norm_ divides
by norm + 1e-6 instead), and the step is torch.optim.Adam with its learning
rate set before each step to the schedule at the count of updates made so
far, as optax reads it (the first update uses lr(0)). Adam's defaults agree:
b1 0.9, b2 0.999, eps added outside the square root (adam_eps, a float32
1e-15 for the instant-NGP table recipe, enters both as the same float32).

table_lr_mult scales the updates of feature-grid tables (parameters whose
key starts with 'grid_'), which the JAX package does after Adam
(_scale_table_updates); here the tables form their own parameter group whose
learning rate is the schedule's times the multiplier, the same update.
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
    # feature-grid table recipe (instant-NGP: tables at ~10x the MLP's lr,
    # a tiny Adam eps); the multiplier applies to grid_* params only,
    # 1.0 = off
    table_lr_mult: float = 1.0
    adam_eps: float = 1e-8


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


def _named_leaves(tree, is_table=False) -> list:
    """(is a grid table, tensor) for every leaf of a nested dict: a leaf is
    a table when a key on its path starts with 'grid_'."""
    if isinstance(tree, dict):
        return [leaf for k, v in tree.items()
                for leaf in _named_leaves(v, is_table or str(k).startswith('grid_'))]
    return [(is_table, tree)]


class Optimizer:
    """Global-norm clip, then Adam on the schedule, over parameter tensors
    that the step updates in place (the JAX package's make_optimizer)."""

    def __init__(self, config: OptimConfig = OptimConfig()):
        self.config = config
        self.schedule = lr_schedule(config)

    def init(self, params: dict) -> torch.optim.Adam:
        """The optimizer state: a torch.optim.Adam over the tensors of the
        nested dict `params`, the grid tables (found by key) in a group of
        their own."""
        leaves = _named_leaves(params)
        groups = [{'params': [p for t, p in leaves if t == table], 'lr_mult': mult}
                  for table, mult in ((False, 1.0), (True, self.config.table_lr_mult))]
        return torch.optim.Adam([g for g in groups if g['params']], lr=self.schedule(0),
                                betas=(0.9, 0.999), eps=self.config.adam_eps)

    def update(self, adam: torch.optim.Adam, count: int) -> torch.Tensor:
        """Clip the parameters' .grad, then take Adam's step `count` (the
        number of updates made before this one) at lr(count), times
        table_lr_mult for the grid tables. Returns the global gradient norm
        before clipping."""
        grads = [p.grad for group in adam.param_groups for p in group['params']]
        norm = clip_by_global_norm(grads, self.config.grad_clip)
        for group in adam.param_groups:
            group['lr'] = self.schedule(count) * group['lr_mult']
        adam.step()
        return norm


def make_optimizer(config: OptimConfig = OptimConfig()) -> Optimizer:
    return Optimizer(config)
