"""The training step and the eval step (sunerf_tpu/train/step.py).

One step: sampling -> coarse field -> hierarchical resample -> fine field ->
quadrature -> loss -> backward -> clip -> Adam, then the optional spike
guard and the Polyak (EMA) average. On the fused path the fields' forward
is the stashing kernel K1 and their backward K2 (ops/fused_mlp.py).
With microbatch the batch runs as sequential chunks, each its own forward
and backward, and the gradients are their mean. On a mesh
(parallel/mesh.py) each rank steps on its rows of the global batch and one
all-reduce averages the gradients and the metrics before the update, which
then runs identically on every rank.

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
from sunerf_tpu_torch.parallel.mesh import all_mean_, gather_tiles
from sunerf_tpu_torch.rendering.renderer import Renderer
from sunerf_tpu_torch.train.objective import LossConfig, render_loss
from sunerf_tpu_torch.train.optim import Optimizer


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


# top-level params that are state, not learned: the occupancy grid, which
# the Trainer's update writes. They need no gradient and the optimizer never
# sees them, so Adam leaves them exactly as the update wrote them (the JAX
# package relies on their zero gradient instead)
NOT_LEARNED = ('occupancy',)


def create_train_state(params: dict, optimizer: Optimizer,
                       spike_guard: bool = False, ema: bool = False) -> TrainState:
    """A state that owns a copy of `params` (float32 tensors that require
    grad, but for NOT_LEARNED's, which the optimizer does not hold), which
    its steps update in place. spike_guard adds the guard's loss EMA,
    snapshot and trip count; ema the averaged copy of params."""
    params = {k: map_params(lambda t, learned=k not in NOT_LEARNED:
                            t.detach().float().clone().requires_grad_(learned), v)
              for k, v in params.items()}
    state = TrainState(params=params, opt_state=optimizer.init(
        {k: v for k, v in params.items() if k not in NOT_LEARNED}))
    if spike_guard:
        state.snapshot = snapshot(state)
        state.trip_count = 0
    if ema:
        state.ema_params = map_params(lambda t: t.detach().clone(), params)
    return state


def step_generator(seed: int, step: int, device, *folds: int) -> torch.Generator:
    """The sampling generator of step `step`, the counterpart of the JAX
    step's fold_in(key, step): a torch.Generator on `device` seeded with
    numpy's SeedSequence((seed, step, *folds)).generate_state(1, uint64)[0].
    folds are the further fold_ins, in JAX's order: a mesh rank's index,
    then a microbatch chunk's. The renderer draws the stratified jitter from
    it, then the hierarchical jitter (when perturb_hierarchical is on)."""
    value = int(np.random.SeedSequence((seed, step, *folds)).generate_state(1, np.uint64)[0])
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
    device; on a mesh, this rank's rows of the global batch
    (parallel.mesh.shard_batch). seed: the run's integer seed; the step's
    sampling generator is step_generator(seed, state.step), with the mesh
    rank and the chunk index folded in after it. metrics: loss, coarse_loss,
    fine_loss, regularization_loss, psnr (and table_tv, when
    loss_config.lambda_table_tv adds lambda_table_tv * table_tv(params) to
    the loss) as 0-d tensors (reading them waits for the device).

    mesh: a parallel.mesh.Mesh. Each rank computes its rows' gradients and
    one all-reduce of one flat buffer (the gradients, then the metrics)
    takes their mean over the ranks (JAX's pmean); clip, Adam, the guard and
    the EMA then run alike on every rank, the guard on the mean loss, so
    every rank trips together. microbatch: the rank's rows run as
    B // microbatch sequential chunks of microbatch rows (the remainder is
    dropped, as in the JAX package; B below microbatch raises), each with
    its own forward and backward (on the fused path one K1 + K2 pair a field
    a chunk), so the activations held are one chunk's; the gradients and
    metrics are the chunks' mean, and Adam steps once.

    spike_guard: optional factor k (see _guard); the state must come from
    create_train_state(spike_guard=True). The guard decides on the host, so
    a guarded step reads its loss (one wait for the device a step); metrics
    gain update_skipped (0 or 1) and spike_trips. ema_decay: optional
    Polyak decay d; the state must come from create_train_state(ema=True).

    donate=True raises (the step updates its state in place)."""
    if donate:
        raise NotImplementedError('donate=True has no counterpart: the step '
                                  'updates its state in place')
    folds = () if mesh is None else (mesh.rank,)

    def chunk_grads(params: dict, chunk: dict, generator) -> dict:
        """The chunk's loss backward into the parameters' .grad (added to
        what is there); its metrics, detached."""
        rays = chunk['rays']
        outputs = renderer(params, rays[:, 0], rays[:, 1], chunk['time'],
                           generator=generator, wavelengths=chunk.get('wavelength'))
        loss, metrics = render_loss(loss_config, outputs, chunk['target_image'])
        if loss_config.lambda_table_tv:
            tv = table_tv(params)
            loss = loss + loss_config.lambda_table_tv * tv
            metrics = dict(metrics, loss=loss, table_tv=tv)
        loss.backward()
        return {k: v.detach() for k, v in metrics.items()}

    def batch_grads(state: TrainState, batch: dict, seed: int) -> dict:
        device = batch['rays'].device
        if microbatch is None:
            return chunk_grads(state.params, batch,
                               step_generator(seed, state.step, device, *folds))
        n = batch['rays'].shape[0]
        if n < microbatch:
            raise ValueError(f'a batch of {n} rows is smaller than microbatch={microbatch}')
        n_chunks = n // microbatch
        total = None
        for i in range(n_chunks):
            rows = slice(i * microbatch, (i + 1) * microbatch)
            m = chunk_grads(state.params, {k: v[rows] for k, v in batch.items()},
                            step_generator(seed, state.step, device, *folds, i))
            total = m if total is None else {k: total[k] + v for k, v in m.items()}
        inv = 1.0 / n_chunks
        with torch.no_grad():
            torch._foreach_mul_([p.grad for p in _adam_params(state.opt_state)], inv)
        return {k: v * inv for k, v in total.items()}

    def step_fn(state: TrainState, batch: dict, seed: int):
        if spike_guard is not None and state.snapshot is None:
            raise ValueError('spike_guard needs a state made by '
                             'create_train_state(..., spike_guard=True)')
        if ema_decay is not None and state.ema_params is None:
            raise ValueError('ema_decay needs a state made by '
                             'create_train_state(..., ema=True)')
        state.opt_state.zero_grad(set_to_none=True)
        metrics = batch_grads(state, batch, seed)
        if mesh is not None:
            values = torch.stack(list(metrics.values()))
            all_mean_(mesh, [p.grad for p in _adam_params(state.opt_state)] + [values])
            metrics = dict(zip(metrics, values.unbind()))
        optimizer.update(state.opt_state, state.updates)
        state.updates += 1
        state.step += 1
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
    eval_fn(params, batch) -> renderer outputs. On a mesh the batch is this
    rank's rows of the global batch, and every rank returns the outputs of
    the whole batch in its order (one all-gather of the per-ray outputs)."""

    def eval_fn(params: dict, batch: dict) -> dict:
        rays = batch['rays']
        with torch.no_grad():
            out = renderer(params, rays[:, 0], rays[:, 1], batch['time'],
                           generator=None, wavelengths=batch.get('wavelength'))
            if mesh is None:
                return out
            n = rays.shape[0]
            keys = [k for k, v in out.items()
                    if isinstance(v, torch.Tensor) and v.ndim and v.shape[0] == n]
            return dict(out, **dict(zip(keys, gather_tiles(mesh, [out[k] for k in keys], n))))

    return eval_fn
