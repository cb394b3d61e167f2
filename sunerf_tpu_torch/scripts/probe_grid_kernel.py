"""The fused field's times for grid-encoded fields against plain
architectures (scripts/probe_grid_kernel.py of the JAX package), one
process: the forward (the inference path, K0) and value-and-grad through
the stashing backward (K1 + K2), for the flagship 8x512, the architecture
axis' 6x384 and 4x256, and grid-encoded small MLPs (4x128 / 2x128 with
16^3 + 32^3 x 8 tables and single levels), whose levels run in the
kernels' grid branch (K5).

Usage: python -m sunerf_tpu_torch.scripts.probe_grid_kernel [--n 262144]
       [--reps 3] [--out FILE] [--device cuda]

Times: utils/profiling.timeit (CUDA events around 3 batches of --reps
calls, the median; the host clock on --device cpu, a CPU number). Points
U(-1.2, 1.2) from seed 0, weights from seed 1 (tables U(-1e-4, 1e-4)). The
result holds the JAX script's keys ('<label>_fwd_ms', '<label>_step_ms',
'n_points') and the launches of one forward and one step by kernel name.
"""
from __future__ import annotations

import argparse
import json

import torch

from sunerf_tpu_torch.models.fields import emission_config, init_nerf, nerf_apply_fused
from sunerf_tpu_torch.scripts.probe_step import timed

CONFIGS = [
    ('8x512', dict(n_layers=8, d_filter=512)),
    ('6x384', dict(n_layers=6, d_filter=384)),
    ('4x256', dict(n_layers=4, d_filter=256)),
    ('4x128_g16_32', dict(n_layers=4, d_filter=128,
                          grid_sizes=(16, 32), grid_features=8)),
    ('2x128_g16_32', dict(n_layers=2, d_filter=128,
                          grid_sizes=(16, 32), grid_features=8)),
    ('4x128_g32', dict(n_layers=4, d_filter=128,
                       grid_sizes=(32,), grid_features=8)),
    ('4x128_g16', dict(n_layers=4, d_filter=128,
                       grid_sizes=(16,), grid_features=8)),
]




def probe_points(n: int, device) -> torch.Tensor:
    """[n, 4] points U(-1.2, 1.2) from seed 0."""
    return (torch.rand(n, 4, generator=torch.Generator(device=device).manual_seed(0),
                       device=device) * 2.4 - 1.2)


def field_calls(config, pts: torch.Tensor, device) -> tuple:
    """(forward, forward + backward) of a field of `config` with weights
    from seed 1: the no-grad forward (K0) and the mean-square loss's value
    and every gradient through the stashing backward (K1 + K2), the
    gradients summed into the result as the JAX script does."""
    params = init_nerf(torch.Generator(device=device).manual_seed(1), config, device)
    leaves = [v.requires_grad_() for v in params.values()]

    def fwd():
        with torch.no_grad():
            return nerf_apply_fused(config, params, pts, compute_dpts=False).raw

    def fwd_bwd():
        loss = torch.mean(nerf_apply_fused(config, params, pts, stash=True,
                                           compute_dpts=False).raw ** 2)
        grads = torch.autograd.grad(loss, leaves)
        return loss.detach() + sum(g.sum() for g in grads)
    return fwd, fwd_bwd


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument('--n', type=int, default=262144)
    parser.add_argument('--reps', type=int, default=3)
    parser.add_argument('--out', default=None)
    parser.add_argument('--device', default='cuda')
    args = parser.parse_args(argv)

    device = torch.device(args.device)
    pts = probe_points(args.n, device)
    out = {'n_points': args.n}
    launches = {}
    for label, kw in CONFIGS:
        fwd, fwd_bwd = field_calls(emission_config(**kw), pts, device)
        ms, fl = timed(fwd, device, args.reps)
        out[f'{label}_fwd_ms'] = round(ms, 3)
        ms, sl = timed(fwd_bwd, device, args.reps)
        out[f'{label}_step_ms'] = round(ms, 3)
        launches[label] = {'fwd': fl, 'step': sl}
        print(json.dumps({k: v for k, v in out.items()
                          if k.startswith(label) or k == 'n_points'}
                         | {'launches': launches[label]}), flush=True)
    out['launches'] = launches
    out['device'] = device.type
    print(json.dumps(out))
    if args.out:
        with open(args.out, 'w') as fh:
            fh.write(json.dumps(out) + '\n')
    return out


if __name__ == '__main__':
    main()
