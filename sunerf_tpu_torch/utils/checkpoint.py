"""Checkpointing (sunerf_tpu/utils/checkpoint.py): resumable training
checkpoints, and the portable deployment bundle.

  * train checkpoint: one torch.save file a checkpoint,
    <workdir>/checkpoints/step_<N>.pt, with the parameters, Adam's state
    and counts, the spike guard's loss EMA, snapshot and trip count, and the
    EMA average; the newest (highest N) is the one resumed. It restores into
    a state built with other guard or EMA settings, as the JAX package's
    orbax restore re-shapes (restore_train_checkpoint);
  * deployment bundle: a flat npz of parameters + a JSON sidecar carrying
    the renderer/data config (:135-174 there) — the same files the JAX
    package writes, so its bundles load here and back.
"""
from __future__ import annotations

import json
import os
import re

import numpy as np
import torch

from sunerf_tpu_torch.train.step import (Snapshot, TrainState, _adam_params, copy_params,
                                         map_params, snapshot)


# ----------------------------------------------------------- train ckpt
#
# Everything is saved and restored by key: a parameter by its path in the
# nested dict ('fine/w_in'), Adam's state and the snapshot's by the path of
# their parameter. Two states of one system may hold their dicts' keys in
# different orders (the JAX package's params come back sorted, the port's
# init keeps the field's order), so no position is trusted.

def _ckpt_dir(workdir: str) -> str:
    return os.path.join(os.path.abspath(workdir), 'checkpoints')


def _to_cpu(tree):
    return map_params(lambda t: t.detach().cpu().clone(), tree)


def _paths(params: dict, prefix: str = '') -> dict:
    """{id of a parameter tensor: its path in the nested dict}."""
    out = {}
    for k, v in params.items():
        if isinstance(v, dict):
            out.update(_paths(v, f'{prefix}{k}/'))
        else:
            out[id(v)] = prefix + k
    return out


def _adam_paths(state: TrainState) -> list[str]:
    """The path of each of Adam's parameters, in Adam's order."""
    paths = _paths(state.params)
    return [paths[id(p)] for p in _adam_params(state.opt_state)]


def save_train_checkpoint(workdir: str, state: TrainState) -> str:
    """Write <workdir>/checkpoints/step_<state.step>.pt (atomically)."""
    os.makedirs(_ckpt_dir(workdir), exist_ok=True)
    path = os.path.join(_ckpt_dir(workdir), f'step_{int(state.step):08d}.pt')
    names = _adam_paths(state)
    adam = state.opt_state
    snap = state.snapshot
    blob = {'step': int(state.step), 'updates': int(state.updates),
            'params': _to_cpu(state.params),
            'adam': {names[i]: {k: v.detach().cpu().clone() for k, v in adam.state[p].items()}
                     for i, p in enumerate(_adam_params(adam)) if p in adam.state},
            'loss_ema': float(state.loss_ema),
            'snapshot': None if snap is None else {
                'params': _to_cpu(snap.params),
                'adam': {names[i]: {k: v.cpu() for k, v in st.items()}
                         for i, st in snap.adam.items()},
                'updates': snap.updates},
            'trip_count': state.trip_count,
            'ema_params': None if state.ema_params is None else _to_cpu(state.ema_params)}
    tmp = path + f'.tmp{os.getpid()}'
    torch.save(blob, tmp)
    os.replace(tmp, path)
    return path


def latest_checkpoint(workdir: str) -> str | None:
    d = _ckpt_dir(workdir)
    if not os.path.isdir(d):
        return None
    steps = [(int(m.group(1)), f) for f in os.listdir(d)
             if (m := re.fullmatch(r'step_(\d+)\.pt', f))]
    if not steps:
        return None
    return os.path.join(d, max(steps)[1])


def _check_tree(name: str, saved, target):
    """Raise unless `saved` has the nesting and shapes of `target`."""
    if isinstance(target, dict):
        if not isinstance(saved, dict) or set(saved) != set(target):
            raise ValueError(f'checkpoint {name}: keys {sorted(saved) if isinstance(saved, dict) else saved!r} '
                             f'against the state\'s {sorted(target)}')
        for k in target:
            _check_tree(f'{name}/{k}', saved[k], target[k])
    elif tuple(saved.shape) != tuple(target.shape):
        raise ValueError(f'checkpoint {name}: shape {tuple(saved.shape)} against the '
                         f'state\'s {tuple(target.shape)}')


def _adam_by_index(name: str, saved: dict, state: TrainState) -> dict:
    """Saved Adam state by path -> {Adam's index of the parameter: its state,
    the moments on the parameter's device and the count on the CPU, where
    torch.optim.Adam keeps it}. Raises unless every path is a parameter of
    the state and every moment has its parameter's shape."""
    params = _adam_params(state.opt_state)
    index = {path: i for i, path in enumerate(_adam_paths(state))}
    out = {}
    for path, st in saved.items():
        if path not in index:
            raise ValueError(f'checkpoint {name}: Adam state of {path}, which the state '
                             f'does not have')
        p = params[index[path]]
        for k in ('exp_avg', 'exp_avg_sq'):
            if tuple(st[k].shape) != tuple(p.shape):
                raise ValueError(f'checkpoint {name}/{path}: {k} shape {tuple(st[k].shape)} '
                                 f'against the parameter\'s {tuple(p.shape)}')
        out[index[path]] = {k: v if k == 'step' else v.to(p.device) for k, v in st.items()}
    return out


def restore_train_checkpoint(workdir: str, target: TrainState) -> TrainState | None:
    """Restore the newest checkpoint of `workdir` into `target` in place and
    return it; None when there is none. The parameters, Adam's state and
    the counts always restore, each by its key, whatever the order of the
    target's dicts. Guard and EMA state follow the target's
    settings, in either direction: a guard-on checkpoint into a guard-off
    target drops the guard's state; a guard-off one into a guard-on target
    takes a fresh loss EMA (-1) and a snapshot COPIED from the restored
    parameters and Adam state (not the target's fresh init, which a trip on
    the first step after the resume would roll back to); an EMA-off
    checkpoint into an EMA-on target starts the average from a copy of the
    restored parameters, and an EMA-on one into an EMA-off target drops it."""
    path = latest_checkpoint(workdir)
    if path is None:
        return None
    blob = torch.load(path, map_location='cpu', weights_only=True)
    _check_tree('params', blob['params'], target.params)
    adam_state = _adam_by_index('adam', blob['adam'], target)
    copy_params(target.params, blob['params'])
    adam = target.opt_state
    adam.state.clear()
    for i, p in enumerate(_adam_params(adam)):
        if i in adam_state:
            adam.state[p] = adam_state[i]
    target.step, target.updates = int(blob['step']), int(blob['updates'])
    if target.snapshot is not None:
        saved = blob['snapshot']
        if saved is None:
            target.loss_ema = np.float32(-1.0)
            target.snapshot = snapshot(target)
        else:
            _check_tree('snapshot/params', saved['params'], target.params)
            snap_params = map_params(lambda t: t.detach().clone(), target.params)
            copy_params(snap_params, saved['params'])
            target.loss_ema = np.float32(blob['loss_ema'])
            target.snapshot = Snapshot(
                params=snap_params,
                adam=_adam_by_index('snapshot/adam', saved['adam'], target),
                updates=int(saved['updates']))
            if blob['trip_count'] is not None:
                target.trip_count = int(blob['trip_count'])
    if target.ema_params is not None:
        if blob['ema_params'] is None:
            target.ema_params = map_params(lambda t: t.detach().clone(), target.params)
        else:
            _check_tree('ema_params', blob['ema_params'], target.ema_params)
            copy_params(target.ema_params, blob['ema_params'])
    return target


# ----------------------------------------------------------- deployment


def _flatten(tree, prefix=''):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f'{prefix}{k}/'))
    elif isinstance(tree, torch.Tensor):
        out[prefix[:-1]] = tree.detach().cpu().numpy()
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def _unflatten(flat: dict) -> dict:
    tree = {}
    for key, value in flat.items():
        parts = key.split('/')
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return tree


def save_state(path: str, params: dict, config: dict):
    """Write the deployment bundle: <path>.npz (flat params, tensors or numpy
    arrays) + <path>.json (render/data config)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    base = path[:-4] if path.endswith('.npz') else path
    np.savez(base + '.npz', **_flatten(params))
    with open(base + '.json', 'w') as f:
        json.dump(config, f, indent=2, default=str)


def load_state(path: str) -> tuple[dict, dict]:
    """Read a deployment bundle -> (params as a nested dict of numpy arrays,
    config dict). models.fields.params_from_numpy puts them on a device."""
    base = path[:-4] if path.endswith('.npz') else path
    with np.load(base + '.npz') as f:
        params = _unflatten({k: f[k] for k in f.files})
    with open(base + '.json') as f:
        config = json.load(f)
    return params, config
