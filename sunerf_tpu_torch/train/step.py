"""The training step and the eval step, single device
(sunerf_tpu/train/step.py).

One step: sampling -> coarse field -> hierarchical resample -> fine field ->
quadrature -> loss -> backward -> clip -> Adam, then the optional spike
guard and the Polyak (EMA) average. On the fused path the fields' forward
is the stashing kernel K1 and their backward K2 (ops/fused_mlp.py).

Where the JAX step is a pure function of an immutable state, this one
updates its state in place: the parameters, Adam's moments, the guard's
snapshot and the EMA average change where they lie, and the step returns
the same state object.
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

_MESH = 'ROADMAP Queue 1 item 11, data parallel'
_MICROBATCH = 'ROADMAP Queue 1 item 10, opt-in dials: microbatch'


@dataclasses.dataclass
class TrainState:
    params: dict                 # {'coarse': {...}, 'fine': {...}} leaf tensors
    opt_state: torch.optim.Optimizer
    step: int = 0                # steps taken
    # updates that stand: Adam's count, which the lr schedule reads (optax's
    # count in the JAX state); a spike-guard rollback restores it, so after a
    # trip it trails `step`
    updates: int = 0
    # spike-guard state (None unless create_train_state(spike_guard=True)):
    # the running loss EMA as a float32 (-1 = not yet set), the last healthy
    # Snapshot the guard rolls back to (copies, never aliases), and the
    # number of rollbacks so far
    loss_ema: np.float32 = np.float32(-1.0)
    snapshot: Optional['Snapshot'] = None
    trip_count: Optional[int] = None
    # the Polyak/EMA average of params (None unless create_train_state(
    # ema=True)), updated after each step's (post-guard) update and
    # evaluated and saved as the smoothed deployment variant
    ema_params: Optional[dict] = None


@dataclasses.dataclass
class Snapshot:
    """A copy of the parameters and of Adam's state and count."""
    params: dict
    adam: dict                   # {param index: {'step', 'exp_avg', 'exp_avg_sq'}}
    updates: int


def _paired_leaves(dst, src) -> tuple[list, list]:
    """The leaves of two nested dicts paired by key, in dst's order (two
    dicts of the same keys may hold them in different orders)."""
    if isinstance(dst, dict):
        a, b = [], []
        for k, v in dst.items():
            x, y = _paired_leaves(v, src[k])
            a += x
            b += y
        return a, b
    return [dst], [src]


def copy_params(dst, src):
    """Copy the nested dict `src` into the tensors of `dst` in place, key
    by key."""
    a, b = _paired_leaves(dst, src)
    with torch.no_grad():
        torch._foreach_copy_(a, b)


def map_params(fn, tree):
    """fn applied to every tensor of a nested dict, the nesting kept."""
    if isinstance(tree, dict):
        return {k: map_params(fn, v) for k, v in tree.items()}
    return fn(tree)


def _adam_params(adam: torch.optim.Optimizer) -> list:
    return [p for group in adam.param_groups for p in group['params']]


def snapshot(state: TrainState) -> Snapshot:
    """A copy of the state's parameters, Adam moments and counts."""
    with torch.no_grad():
        params = map_params(lambda t: t.detach().clone(), state.params)
        adam = {i: {k: v.clone() for k, v in state.opt_state.state[p].items()}
                for i, p in enumerate(_adam_params(state.opt_state))
                if p in state.opt_state.state}
    return Snapshot(params=params, adam=adam, updates=state.updates)


def _copy_adam(dst: dict, src: dict):
    """Copy one parameter's Adam state into another's tensors in place: the
    moments on the device, the count on the CPU, where torch.optim.Adam
    keeps it."""
    dst['step'].copy_(src['step'])
    torch._foreach_copy_([dst['exp_avg'], dst['exp_avg_sq']],
                         [src['exp_avg'], src['exp_avg_sq']])


def _restore(state: TrainState, snap: Snapshot):
    """Copy a snapshot back into the state's tensors, in place."""
    copy_params(state.params, snap.params)
    with torch.no_grad():
        for i, p in enumerate(_adam_params(state.opt_state)):
            if i in snap.adam:
                _copy_adam(state.opt_state.state[p], snap.adam[i])
            else:
                state.opt_state.state.pop(p, None)
    state.updates = snap.updates


def _refresh(snap: Snapshot, state: TrainState):
    """Copy the state's parameters, Adam state and count into the
    snapshot's own tensors in place (Adam's state of a parameter that has
    none in the snapshot yet, as after the first update, is cloned once)."""
    copy_params(snap.params, state.params)
    with torch.no_grad():
        for i, p in enumerate(_adam_params(state.opt_state)):
            st = state.opt_state.state.get(p)
            if st is None:
                continue
            if i in snap.adam:
                _copy_adam(snap.adam[i], st)
            else:
                snap.adam[i] = {k: v.clone() for k, v in st.items()}
    snap.updates = state.updates


def create_train_state(params: dict, optimizer: Optimizer,
                       spike_guard: bool = False, ema: bool = False) -> TrainState:
    """A state that owns a copy of `params` (float32 tensors that require
    grad), which its steps update in place. spike_guard adds the guard's
    loss EMA, snapshot and trip count; ema the averaged copy of params."""
    params = map_params(lambda t: t.detach().float().clone().requires_grad_(True), params)
    state = TrainState(params=params, opt_state=optimizer.init(params))
    if spike_guard:
        state.snapshot = snapshot(state)
        state.trip_count = 0
    if ema:
        state.ema_params = map_params(lambda t: t.detach().clone(), params)
    return state


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The sampling generator of step `step`, the counterpart of the JAX
    step's fold_in(key, step): a torch.Generator on `device` seeded with
    numpy's SeedSequence((seed, step)).generate_state(1, uint64)[0]. The
    renderer draws the stratified jitter from it, then the hierarchical
    jitter (when perturb_hierarchical is on)."""
    value = int(np.random.SeedSequence((seed, step)).generate_state(1, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(value)


def _guard(state: TrainState, loss: float, spike_guard: float) -> bool:
    """The spike guard after the step's update (_guarded_update in the JAX
    package): a loss above spike_guard x its running EMA, or non-finite,
    trips it and restores the snapshot wholesale (params, Adam's state and
    count); a healthy loss (within 1.5x the EMA, the EMA tracking rather
    than lagging a ramp) refreshes the snapshot to the update that stands.
    The EMA takes the loss (1% a step) unless the step tripped, when it
    grows by 5% instead, so consecutive trips unlatch the guard in
    O(log(loss / EMA) / log(1.05)) steps. The EMA's arithmetic is float32,
    as the JAX state's. The decision is the host's: the caller read the
    loss, so the host waited for the step; the rollback and the refresh are
    copies into tensors that already exist. Returns whether the step
    tripped."""
    ema, loss32 = state.loss_ema, np.float32(loss)
    fresh = ema < 0
    finite = bool(np.isfinite(loss32))
    tripped = not (finite and (fresh or loss32 <= np.float32(spike_guard) * ema))
    healthy = finite and (fresh or loss32 <= np.float32(1.5) * ema)
    if tripped:
        _restore(state, state.snapshot)
        state.loss_ema = np.float32(ema * np.float32(1.05))
        state.trip_count += 1
    else:
        state.loss_ema = loss32 if fresh else np.float32(
            np.float32(0.99) * ema + np.float32(0.01) * loss32)
        if healthy:
            _refresh(state.snapshot, state)
    return tripped


def _ema_update(state: TrainState, ema_decay: float):
    """One Polyak step of the averaged params toward the (post-guard)
    params: ema <- d * ema + (1 - d) * params, as the JAX step's, in two
    multi-tensor kernels for all the leaves (the sum may fuse into one
    rounding where JAX's takes two)."""
    ema, params = _paired_leaves(state.ema_params, state.params)
    with torch.no_grad():
        torch._foreach_mul_(ema, ema_decay)
        torch._foreach_add_(ema, [p.detach() for p in params], alpha=1.0 - ema_decay)


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

    spike_guard: optional factor k (see _guard); the state must come from
    create_train_state(spike_guard=True). The guard decides on the host, so
    a guarded step reads its loss (one wait for the device a step); metrics
    gain update_skipped (0 or 1) and spike_trips. ema_decay: optional
    Polyak decay d; the state must come from create_train_state(ema=True).

    mesh and microbatch are not ported and raise; donate=True raises too
    (the step updates its state in place)."""
    if mesh is not None:
        raise NotImplementedError(f'mesh is not ported yet ({_MESH})')
    if microbatch is not None:
        raise NotImplementedError(f'microbatch is not ported yet ({_MICROBATCH})')
    if donate:
        raise NotImplementedError('donate=True has no counterpart: the step '
                                  'updates its state in place')

    def step_fn(state: TrainState, batch: dict, seed: int):
        if spike_guard is not None and state.snapshot is None:
            raise ValueError('spike_guard needs a state made by '
                             'create_train_state(..., spike_guard=True)')
        if ema_decay is not None and state.ema_params is None:
            raise ValueError('ema_decay needs a state made by '
                             'create_train_state(..., ema=True)')
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
        optimizer.update(state.opt_state, state.updates)
        state.updates += 1
        state.step += 1
        metrics = {k: v.detach() for k, v in metrics.items()}
        if spike_guard is not None:
            tripped = _guard(state, float(metrics['loss']), spike_guard)
            metrics['update_skipped'] = torch.tensor(float(tripped))
            metrics['spike_trips'] = torch.tensor(float(state.trip_count))
        if ema_decay is not None:
            _ema_update(state, ema_decay)
        return state, metrics

    return step_fn


def make_eval_step(renderer: Renderer, mesh=None):
    """No-jitter forward pass without gradients (the fused path's K0):
    eval_fn(params, batch) -> renderer outputs."""
    if mesh is not None:
        raise NotImplementedError(f'mesh is not ported yet ({_MESH})')

    def eval_fn(params: dict, batch: dict) -> dict:
        rays = batch['rays']
        with torch.no_grad():
            return renderer(params, rays[:, 0], rays[:, 1], batch['time'],
                            generator=None, wavelengths=batch.get('wavelength'))

    return eval_fn
