"""Time the stashing forward (K1) and the stashing backward (K2) apart,
beside the plain no-grad forward (K0), at the 8x512 emission field
(scripts/probe_kernel.py of the JAX package), to see where forward +
backward loses efficiency against the forward alone.

    python -m sunerf_tpu_torch.scripts.probe_kernel [--n 262144] [--device cuda]

Through ops/fused_mlp's entry points: fused_mlp_forward without a gradient
(K0), fused_mlp_stash_forward (K1, 'int8'), and fused_mlp_stash_backward
(K2) fed K1's stash once and a dy of ones. Times: utils/profiling.timeit
(CUDA events around 3 batches of --reps calls, the median; the host clock
on --device cpu, through the plain versions: a CPU number). TFLOP/s from
the JAX script's counts (the forward 2 N H (E + (L-1) H + d_out), the
backward twice that). The JAX script's tile argument sizes TPU blocks and
has no counterpart. Weights random from seed 0, points standard normal
from seed 1. main returns {name: {ms, tflops, launches}}, the launches of
one call by kernel name.
"""
from __future__ import annotations

import argparse

import torch

from sunerf_tpu_torch.models.fields import emission_config, init_nerf
from sunerf_tpu_torch.ops import fused_mlp
from sunerf_tpu_torch.scripts.probe_step import timed


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--n', type=int, default=262144)
    parser.add_argument('--reps', type=int, default=20)
    parser.add_argument('--device', default='cuda')
    args = parser.parse_args(argv)

    device = torch.device(args.device)
    config = emission_config()
    params = init_nerf(torch.Generator(device=device).manual_seed(0), config, device)
    n, h = args.n, config.d_filter
    pts = torch.randn(n, 4, generator=torch.Generator(device=device).manual_seed(1),
                      device=device)
    flops_fwd = 2.0 * n * h * (config.d_encoded + (config.n_layers - 1) * h
                               + config.d_output)
    rows = {}

    def report(name, fn, flops):
        ms, launches = timed(fn, device, args.reps)
        rows[name] = dict(ms=ms, tflops=flops / ms / 1e9, launches=launches, n=n,
                          device=device.type)
        print(f'{name:32s} {ms:8.2f} ms   {flops / ms / 1e9:6.1f} TFLOP/s  '
              f'({device.type}); launches {launches}', flush=True)

    with torch.no_grad():
        report('plain fwd', lambda: fused_mlp.fused_mlp_forward(config, params, pts),
               flops_fwd)
        report('stash fwd', lambda: fused_mlp.fused_mlp_stash_forward(config, params, pts),
               flops_fwd)
        # the stash once, then the backward alone
        _, hs, cs = fused_mlp.fused_mlp_stash_forward(config, params, pts)
        dy = torch.ones((n, config.d_output), device=device)
        report('stash bwd', lambda: fused_mlp.fused_mlp_stash_backward(
            config, params, pts, dy, hs, cs), 2 * flops_fwd)
    return rows


if __name__ == '__main__':
    main()
