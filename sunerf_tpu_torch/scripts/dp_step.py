"""The data-parallel train step across the ranks of a torchrun launch:

    torchrun --nproc-per-node N -m sunerf_tpu_torch.scripts.dp_step [--rays 1024] [--reps 10]

bench.py's workload by default: make_emission_system's 8x512 for both
fields, 64 + 128 samples, LossConfig(), make_optimizer(), weights from seed
0, --rays rays a rank (bench.py's batch, drawn with numpy for all ranks at
once). Each rank runs on its own card over NCCL; --device cpu puts every
rank on the CPU over gloo (a dry run: --layers 2 --width 32 --samples 8 8
--rays 32; its times are the CPU's and no device metric).

  check  one mesh step (perturb off) against rank 0's single-process step
         on the global batch: loss within 1e-3 relative, the clipped
         gradients within 3e-2 of max (chip_smoke.py's step tolerances)
  times  the mesh step (perturbed, as bench.py's) on every rank, CUDA
         events, median of --reps after 3 warm-ups; rank 0's single-device
         step on its own --rays rays (the other ranks wait); the NCCL
         all-reduce of the step's gradients alone (median of 20)

Rank 0 prints one JSON line: the check, every rank's times, the global
rays/s, and the cards' names and power limits as nvidia-smi prints them.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import time
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

LOSS_TOL = 1e-3
GRAD_TOL = 3e-2


def _batch(n: int, device) -> dict:
    """bench.py's batch: rays from (4, 0, 0) toward -x with 0.15 normal
    jitter, time 0, target 0.05."""
    rng = np.random.default_rng(1)
    rays_o = np.tile(np.array([[4.0, 0.0, 0.0]], np.float32), (n, 1))
    dirs = np.array([[-1.0, 0.0, 0.0]]) + 0.15 * rng.normal(size=(n, 3))
    rays_d = (dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)).astype(np.float32)
    return {'rays': torch.from_numpy(np.stack([rays_o, rays_d], axis=1)).to(device),
            'time': torch.zeros((n, 1), device=device),
            'target_image': torch.full((n, 1), 0.05, device=device)}


def _ms(fn, device, warmup: int = 3, reps: int = 10) -> float:
    """Median ms of fn() after `warmup` calls: CUDA events on a card, the
    host clock on the CPU."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        if device.type == 'cuda':
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _grads(state) -> list:
    return [p.grad.detach().clone() for g in state.opt_state.param_groups for p in g['params']]


def main(argv=None):
    from sunerf_tpu_torch.models.fields import emission_config
    from sunerf_tpu_torch.parallel.mesh import make_mesh, replicate, shard_batch
    from sunerf_tpu_torch.systems import make_emission_system
    from sunerf_tpu_torch.train.objective import LossConfig
    from sunerf_tpu_torch.train.optim import make_optimizer
    from sunerf_tpu_torch.train.step import create_train_state, make_train_step
    parser = argparse.ArgumentParser()
    parser.add_argument('--rays', type=int, default=1024, help='rays a rank')
    parser.add_argument('--reps', type=int, default=10)
    parser.add_argument('--device', default='cuda')
    parser.add_argument('--layers', type=int, default=8)
    parser.add_argument('--width', type=int, default=512)
    parser.add_argument('--samples', type=int, nargs=2, default=(64, 128))
    args = parser.parse_args(argv)

    world = int(os.environ.get('WORLD_SIZE', 1))
    mesh = make_mesh(devices=None if args.device == 'cuda' else [args.device] * world,
                     timeout=timedelta(seconds=120))
    device = mesh.device
    torch.backends.cuda.matmul.allow_tf32 = False
    system = dict(model_config=emission_config(n_layers=args.layers, d_filter=args.width),
                  n_stratified=args.samples[0], n_hierarchical=args.samples[1], device=device)
    fixed, init = make_emission_system(perturb=False, **system)
    bench, _ = make_emission_system(**system)
    params = init(torch.Generator(device=device).manual_seed(0))
    opt = make_optimizer()
    full = _batch(args.rays * mesh.size, device)
    local = shard_batch(mesh, full)

    state = replicate(mesh, create_train_state(params, opt))
    _, m = make_train_step(fixed, LossConfig(), opt, mesh=mesh)(state, local, 0)
    check = None
    if mesh.rank == 0:
        ref = create_train_state(params, opt)
        _, m_ref = make_train_step(fixed, LossConfig(), opt)(ref, full, 0)
        loss_rel = abs(float(m['loss']) - float(m_ref['loss'])) / abs(float(m_ref['loss']))
        grad_rel = max(float((g - r).abs().max() / r.abs().max().clamp_min(1e-30))
                       for g, r in zip(_grads(state), _grads(ref)))
        check = dict(loss_rel_err=loss_rel, grads_max_rel_err=grad_rel,
                     ok=loss_rel <= LOSS_TOL and grad_rel <= GRAD_TOL)
        del ref
    dist.barrier()

    timed = replicate(mesh, create_train_state(params, opt))
    step = make_train_step(bench, LossConfig(), opt, mesh=mesh)
    mesh_ms = _ms(lambda: step(timed, local, 0), device, reps=args.reps)
    single_ms = None
    if mesh.rank == 0:
        alone = create_train_state(params, opt)
        single = make_train_step(bench, LossConfig(), opt)
        single_ms = _ms(lambda: single(alone, local, 0), device, reps=args.reps)
        del alone
    dist.barrier()
    flat = torch.cat([g.reshape(-1) for g in _grads(timed)])
    all_reduce_ms = _ms(lambda: dist.all_reduce(flat), device, reps=20)

    rows = [None] * mesh.size
    dist.all_gather_object(rows, dict(rank=mesh.rank, device=str(device),
                                      mesh_step_ms=mesh_ms, all_reduce_ms=all_reduce_ms))
    if mesh.rank == 0:
        cards = (subprocess.run(['nvidia-smi', '--query-gpu=index,name,power.limit',
                                 '--format=csv,noheader'], capture_output=True,
                                text=True).stdout.strip().splitlines()
                 if device.type == 'cuda' else [])
        step_ms = max(r['mesh_step_ms'] for r in rows)
        print(json.dumps(dict(world=mesh.size, backend=mesh.backend, rays_per_rank=args.rays,
                              model=[args.layers, args.width, *args.samples], check=check,
                              ranks=rows, single_step_ms=single_ms,
                              all_reduce_bytes=flat.numel() * 4,
                              global_rays_per_s=args.rays * mesh.size / step_ms * 1e3,
                              single_rays_per_s=args.rays / single_ms * 1e3, cards=cards)),
              flush=True)
    dist.destroy_process_group()
    if check is not None and not check['ok']:
        raise SystemExit(f'dp_step: the mesh step is off the single-process step: {check}')


if __name__ == '__main__':
    main()
