"""Deployment bundles: a flat npz of parameters + a JSON sidecar carrying the
renderer/data config (sunerf_tpu/utils/checkpoint.py:135-174) — the same
files the JAX package writes, so its bundles load here and back, and a
trained state's params save with save_state. Resumable training
checkpoints come with the Trainer (ROADMAP Queue 1 item 5).
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch


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
