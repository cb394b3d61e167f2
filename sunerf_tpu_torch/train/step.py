"""The training step and the eval step, single device
(sunerf_tpu/train/step.py).

One step: sampling -> coarse field -> hierarchical resample -> fine field ->
quadrature -> loss -> backward -> clip -> Adam. On the fused path the fields'
forward is the stashing kernel K1 and their backward K2 (ops/fused_mlp.py).

Where the JAX step is a pure function of an immutable state, this one
updates its state in place: the parameters and Adam's moments change where
they lie, and the step returns the same state object.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from sunerf_tpu_torch.ops.grid_encoding import table_tv
from sunerf_tpu_torch.rendering.renderer import Renderer
from sunerf_tpu_torch.train.objective import LossConfig, render_loss
from sunerf_tpu_torch.train.optim import Optimizer

_QUEUE = 'ROADMAP Queue 1 items 10 and 11'


@dataclasses.dataclass
class TrainState:
    params: dict                 # {'coarse': {...}, 'fine': {...}} leaf tensors
    opt_state: torch.optim.Optimizer
    step: int = 0                # steps taken


def create_train_state(params: dict, optimizer: Optimizer,
                       spike_guard: bool = False, ema: bool = False) -> TrainState:
    """A state that owns a copy of `params` (float32 tensors that require
    grad), which its steps update in place."""
    if spike_guard or ema:
        raise NotImplementedError(f'spike guard and EMA are not ported yet ({_QUEUE})')

    def copy(tree):
        if isinstance(tree, dict):
            return {k: copy(v) for k, v in tree.items()}
        return tree.detach().float().clone().requires_grad_(True)

    params = copy(params)
    return TrainState(params=params, opt_state=optimizer.init(params))


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The sampling generator of step `step`, the counterpart of the JAX
    step's fold_in(key, step): a torch.Generator on `device` seeded with
    numpy's SeedSequence((seed, step)).generate_state(1, uint64)[0]. The
    renderer draws the stratified jitter from it, then the hierarchical
    jitter (when perturb_hierarchical is on)."""
    value = int(np.random.SeedSequence((seed, step)).generate_state(1, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(value)


def make_train_step(renderer: Renderer, loss_config: LossConfig,
                    optimizer: Optimizer, mesh=None, donate: bool = False,
                    microbatch: Optional[int] = None,
                    spike_guard: Optional[float] = None,
                    ema_decay: Optional[float] = None):
    """Build the train step, step_fn(state, batch, seed) -> (state, metrics).

    batch: rays [B, 2, 3] (origin, direction), time [B, 1], target_image
    [B, C] (+ wavelength [B, W] for multi-channel heads), on the params'
    device. seed: the run's integer seed; the step's sampling generator is
    step_generator(seed, state.step). metrics: loss, coarse_loss, fine_loss,
    regularization_loss, psnr (and table_tv, when loss_config.lambda_table_tv
    adds lambda_table_tv * table_tv(params) to the loss) as 0-d tensors
    (reading them waits for the device).

    mesh, microbatch, spike_guard and ema_decay are not ported and raise;
    donate=True raises too (the step updates its state in place)."""
    for name, value in (('mesh', mesh), ('microbatch', microbatch),
                        ('spike_guard', spike_guard), ('ema_decay', ema_decay)):
        if value is not None:
            raise NotImplementedError(f'{name} is not ported yet ({_QUEUE})')
    if donate:
        raise NotImplementedError(f'donate=True is not ported ({_QUEUE}); the '
                                  f'step updates its state in place')

    def step_fn(state: TrainState, batch: dict, seed: int):
        rays = batch['rays']
        generator = step_generator(seed, state.step, rays.device)
        outputs = renderer(state.params, rays[:, 0], rays[:, 1], batch['time'],
                           generator=generator, wavelengths=batch.get('wavelength'))
        loss, metrics = render_loss(loss_config, outputs, batch['target_image'])
        if loss_config.lambda_table_tv:
            tv = table_tv(state.params)
            loss = loss + loss_config.lambda_table_tv * tv
            metrics = dict(metrics, loss=loss, table_tv=tv)
        state.opt_state.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.update(state.opt_state, state.step)
        state.step += 1
        return state, {k: v.detach() for k, v in metrics.items()}

    return step_fn


def make_eval_step(renderer: Renderer, mesh=None):
    """No-jitter forward pass without gradients (the fused path's K0):
    eval_fn(params, batch) -> renderer outputs."""
    if mesh is not None:
        raise NotImplementedError(f'mesh is not ported yet ({_QUEUE})')

    def eval_fn(params: dict, batch: dict) -> dict:
        rays = batch['rays']
        with torch.no_grad():
            return renderer(params, rays[:, 0], rays[:, 1], batch['time'],
                            generator=None, wavelengths=batch.get('wavelength'))

    return eval_fn
