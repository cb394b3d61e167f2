"""Kernel micro-benchmark of the fused field (scripts/bench_kernel.py): the
forward K0, forward + backward of each stash format (K1 / K6a / K6b with
the stashing backward and, since the points need a gradient, its point
cotangent K3), each stashing forward alone, and the recompute path (K0 +
K4), at the 8x512 emission field and N = 262,144 points.

    python -m sunerf_tpu_torch.scripts.bench_kernel [--n 262144]

Times: utils/profiling.timeit, CUDA events around each of 3 batches of
--reps back-to-back calls after warm-up, the median batch per call (on
--device cpu the host clock, through the plain versions: a CPU number). TFLOP/s from the
JAX script's counts: the forward 2 N H (E + (L-1) H + d_out), forward +
backward three times that. The JAX script's tile flags size TPU blocks and
have no counterpart; --i8pair-group is the one tile with a numerical
meaning (the i8pair backward's dz scale group, stash_bwd_tile). Weights
random from seed 0, points standard normal from seed 1.
"""
from __future__ import annotations

import argparse

import torch

from sunerf_tpu_torch.models.fields import emission_config, init_nerf
from sunerf_tpu_torch.ops import fused_mlp
from sunerf_tpu_torch.utils.profiling import timeit


def main(argv=None) -> list:
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--n', type=int, default=262144)
    parser.add_argument('--device', default='cuda')
    parser.add_argument('--reps', type=int, default=20)
    parser.add_argument('--i8pair-group', type=int, default=fused_mlp.STASH_BWD_TILE)
    args = parser.parse_args(argv)

    device = torch.device(args.device)
    config = emission_config()
    params = init_nerf(torch.Generator(device=device).manual_seed(0), config, device)
    n, h = args.n, config.d_filter
    pts = torch.randn(n, 4, generator=torch.Generator(device=device).manual_seed(1),
                      device=device)
    flops_fwd = 2.0 * n * h * (config.d_encoded + (config.n_layers - 1) * h
                               + config.d_output)
    flops_bwd = 3 * flops_fwd
    leaves = [params[k].requires_grad_() for k in fused_mlp.param_keys(config)]
    x = pts.clone().requires_grad_()
    rows = []

    def report(name, fn, flops):
        ms = timeit(fn, device=device, reps=args.reps)
        rows.append(dict(name=name, ms=ms, tflops=flops / ms / 1e9, n=n,
                         device=device.type))
        print(f'{name:28s} {ms:9.3f} ms  {flops / ms / 1e9:7.1f} TFLOP/s  ({device.type})',
              flush=True)

    def forward_backward(**kw):
        out = fused_mlp.fused_mlp_forward(config, params, x,
                                          stash_bwd_tile=args.i8pair_group, **kw)
        return torch.autograd.grad(out.sum(), leaves + [x])

    with torch.no_grad():
        report('fwd (no grad)', lambda: fused_mlp.fused_mlp_forward(config, params, pts),
               flops_fwd)
    for fmt in fused_mlp.STASH_FORMATS:
        report(f'stash[{fmt}] fwd+bwd',
               lambda f=fmt: forward_backward(stash=True, stash_format=f), flops_bwd)
    with torch.no_grad():
        for fmt in fused_mlp.STASH_FORMATS:
            report(f'stash[{fmt}] fwd only',
                   lambda f=fmt: fused_mlp.fused_mlp_stash_forward(config, params, pts, f),
                   flops_fwd)
    report('recompute fwd+bwd', lambda: forward_backward(stash=False), flops_bwd)
    return rows


if __name__ == '__main__':
    main()
