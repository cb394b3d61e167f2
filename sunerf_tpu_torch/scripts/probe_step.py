"""A/B bench.py's training step across the fused field's knobs
(scripts/probe_step.py): each argument is a dict of nerf_apply_fused
keywords, e.g.

    python -m sunerf_tpu_torch.scripts.probe_step "{}" "{'stash': False}" \\
        "{'stash_format': 'lsb'}" "{'stash_format': 'i8pair'}"

The step is bench.py's: the 8x512 emission field for both passes (posenc
4 -> 84), 64 + 128 samples, 1024 rays from (4, 0, 0) toward -x with 0.15
normal jitter, target 0.05, LossConfig(), make_optimizer(); weights random
from seed 0. Per knob set it prints ms/step and rays/s (CUDA events around
each of 3 batches of --reps back-to-back steps after warm-up, the median
batch per step; on --device cpu the host
clock, a CPU number) and the kernel launches of one step. The renderer
detaches its sample points, so no step computes a point cotangent.
"""
from __future__ import annotations

import argparse
import ast
import functools

import numpy as np
import torch

from sunerf_tpu_torch.models.fields import emission_config, init_nerf, nerf_apply_fused
from sunerf_tpu_torch.ops import fused_mlp
from sunerf_tpu_torch.rendering.emission import EmissionHead
from sunerf_tpu_torch.rendering.renderer import Renderer
from sunerf_tpu_torch.train.objective import LossConfig
from sunerf_tpu_torch.train.optim import make_optimizer
from sunerf_tpu_torch.train.step import create_train_state, make_train_step
from sunerf_tpu_torch.utils.profiling import timeit

COUNTERS = ('LAUNCHES', 'STASH_FWD_LAUNCHES', 'STASH_BWD_LAUNCHES', 'GRID_LAUNCHES',
            'DPTS_LAUNCHES', 'RECOMPUTE_BWD_LAUNCHES', 'LSB_LAUNCHES', 'I8PAIR_LAUNCHES')


def bench_batch(device, n: int = 1024, seed: int = 1) -> dict:
    """bench.py's batch, made with numpy."""
    rng = np.random.default_rng(seed)
    rays_o = np.tile(np.array([[4.0, 0.0, 0.0]], np.float32), (n, 1))
    dirs = np.array([[-1.0, 0.0, 0.0]]) + 0.15 * rng.normal(size=(n, 3))
    rays_d = (dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)).astype(np.float32)
    return {'rays': torch.from_numpy(np.stack([rays_o, rays_d], axis=1)).to(device),
            'time': torch.zeros((n, 1), device=device),
            'target_image': torch.full((n, 1), 0.05, device=device)}


# each counter's kernel, by the name its wrapper builds and launches
KERNEL_OF = {'LAUNCHES': 'fused_mlp_fwd_wgmma (K0)',
             'STASH_FWD_LAUNCHES': 'fused_mlp_stash_fwd (K1)',
             'STASH_BWD_LAUNCHES': 'fused_mlp_stash_bwd (K2)',
             'GRID_LAUNCHES': 'grid branch of K0-K2 (K5)',
             'DPTS_LAUNCHES': 'point cotangent of K2 (K3)',
             'RECOMPUTE_BWD_LAUNCHES': 'fused_mlp_recompute_bwd (K4)',
             'LSB_LAUNCHES': "'lsb' stash (K6a)", 'I8PAIR_LAUNCHES': "'i8pair' stash (K6b)"}


def launch_counts() -> dict:
    return {k: getattr(fused_mlp, k) for k in COUNTERS}


def zero_counts():
    for k in COUNTERS:
        setattr(fused_mlp, k, 0)


def launches_by_kernel() -> dict:
    """The launches counted since zero_counts(), by kernel name; kernels
    not launched are left out."""
    return {KERNEL_OF[k]: v for k, v in launch_counts().items() if v}


def timed(fn, device, reps: int) -> tuple:
    """(ms per fn() call by utils/profiling.timeit, the launches of one
    call by kernel name)."""
    zero_counts()
    fn()
    launches = launches_by_kernel()
    return timeit(fn, device=device, reps=reps), launches


def measure(knob: dict, device='cuda', n_steps: int = 0, reps: int = 10) -> dict:
    """One knob set: ms/step, rays/s, the launches of one step and, with
    n_steps, the losses of that many steps from fresh weights."""
    device = torch.device(device)
    config = emission_config()
    renderer = Renderer(field_apply=functools.partial(nerf_apply_fused, config, **knob),
                        head=EmissionHead())
    gen = torch.Generator(device=device).manual_seed(0)
    params = {'coarse': init_nerf(gen, config, device), 'fine': init_nerf(gen, config, device)}
    batch_size = 1024
    batch = bench_batch(device, batch_size)
    opt = make_optimizer()
    step = make_train_step(renderer, LossConfig(), opt)
    state = create_train_state(params, opt)
    losses = [float(step(state, batch, 0)[1]['loss']) for _ in range(n_steps)]
    step(state, batch, 0)                          # warm-up: libraries loaded
    if device.type == 'cuda':
        torch.cuda.synchronize()
    zero_counts()
    step(state, batch, 0)
    launches = launch_counts()
    ms = timeit(step, state, batch, 0, device=device, reps=reps)
    return dict(knob=knob, ms=ms, rays_per_s=batch_size / ms * 1e3, launches=launches,
                losses=losses, device=device.type)


def main(argv=None) -> list:
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('knobs', nargs='*', default=['{}'],
                        help="dicts of nerf_apply_fused keywords, e.g. \"{'stash': False}\"")
    parser.add_argument('--device', default='cuda')
    parser.add_argument('--reps', type=int, default=10)
    args = parser.parse_args(argv)
    rows = []
    for spec in args.knobs:
        row = measure(ast.literal_eval(spec), device=args.device, reps=args.reps)
        rows.append(row)
        nonzero = {k: v for k, v in row['launches'].items() if v}
        print(f"{str(row['knob']):40s} {row['ms']:8.2f} ms/step  {row['rays_per_s']:9.0f} "
              f"rays/s  ({row['device']}); launches of one step: {nonzero}", flush=True)
    return rows


if __name__ == '__main__':
    main()
