"""The whole training step at the grid_quarter configuration (a 4x128
proposal coarse field + a 4x128 fine field fed by 16^3 + 32^3 x 8 tables,
24 + 48 samples) with grid_hat_mxu off and on (scripts/probe_grid_step.py
of the JAX package).

In the JAX package grid_hat_mxu picks how its TPU kernel builds the
trilinear hat weights; the port's config accepts the flag and its kernels'
grid branch (K5) computes the same features either way, so the two rows
time the same kernels and their ratio reads the run's spread.

Usage: python -m sunerf_tpu_torch.scripts.probe_grid_step [--batch 1024]
       [--reps 3] [--out FILE] [--device cuda]

Times: utils/profiling.timeit over the step (CUDA events around 3 batches
of --reps steps, the median; the host clock on --device cpu, a CPU
number). Weights from seed 0, the batch from numpy seed 1. The result
holds the JAX script's keys and each row's launches of one step by kernel
name.
"""
from __future__ import annotations

import argparse
import json

import torch

from sunerf_tpu_torch.models.fields import emission_config
from sunerf_tpu_torch.scripts.probe_step import bench_batch, launches_by_kernel, zero_counts
from sunerf_tpu_torch.systems import make_emission_system
from sunerf_tpu_torch.train.objective import LossConfig
from sunerf_tpu_torch.train.optim import make_optimizer
from sunerf_tpu_torch.train.step import create_train_state, make_train_step
from sunerf_tpu_torch.utils.profiling import timeit


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument('--batch', type=int, default=1024)
    parser.add_argument('--reps', type=int, default=3)
    parser.add_argument('--out', default=None)
    parser.add_argument('--device', default='cuda')
    args = parser.parse_args(argv)

    device = torch.device(args.device)
    batch_size = args.batch
    batch = bench_batch(device, batch_size)
    proposal = emission_config(n_layers=4, d_filter=128)
    optimizer = make_optimizer()
    out = {'batch': batch_size, 'config': 'grid_quarter (prop4x128 + '
                                          'grid16+32-fed 4x128 @ 24+48)'}
    launches = {}
    for label, hat_mxu in (('iota', False), ('mxu', True)):
        model = emission_config(n_layers=4, d_filter=128,
                                grid_sizes=(16, 32), grid_features=8,
                                grid_bound=1.3, grid_hat_mxu=hat_mxu)
        renderer, init = make_emission_system(
            model_config=model, n_stratified=24, n_hierarchical=48,
            coarse_config=proposal, device=device)
        step = make_train_step(renderer, LossConfig(), optimizer)
        state = create_train_state(init(torch.Generator().manual_seed(0)), optimizer)
        step(state, batch, 1)                      # warm-up: kernels built
        if device.type == 'cuda':
            torch.cuda.synchronize(device)
        zero_counts()
        step(state, batch, 1)
        launches[label] = launches_by_kernel()
        ms = timeit(step, state, batch, 1, device=device, reps=args.reps)
        out[f'{label}_step_ms'] = round(ms, 3)
        out[f'{label}_rays_per_sec'] = round(batch_size / (ms / 1e3), 1)
        print(json.dumps(out | {'launches': launches}), flush=True)

    out['mxu_speedup'] = round(out['iota_step_ms'] / out['mxu_step_ms'], 3)
    out['launches'] = launches
    out['device'] = device.type
    print(json.dumps(out))
    if args.out:
        with open(args.out, 'w') as fh:
            json.dump(out, fh, indent=2)
    return out


if __name__ == '__main__':
    main()
