"""The cost of a gather-free feature-grid encoding against the field
evaluations it would feed (scripts/probe_grid_encoding.py of the JAX
package).

The encoding probed: per point, the trilinear weight row over a small dense
grid (8 nonzeros in a [G^3] row, built from comparisons alone) contracted
against the feature table,

    feats[N, F] = W[N, G^3] @ table[G^3, F]

chunk by chunk, so the peak is [chunk, G^3]. The JAX package computes it
outside any Pallas kernel (a TPU workaround for slow gathers); here it is
torch.matmul in float32. It is timed beside the fused field's no-grad
forward (K0) and stashing forward (K1) at 6x384 and 2x128, one process.

Usage: python -m sunerf_tpu_torch.scripts.probe_grid_encoding [--n 73728]
       [--grid 16 24 32] [--features 16] [--device cuda]

Times: utils/profiling.timeit (CUDA events around 3 batches of --reps
calls, the median; the host clock on --device cpu, a CPU number). Points
U(-1, 1) from seed 0, weights from seed 1, tables normal from seed 2. The
result holds the JAX script's keys ('mlp_<L>x<H>', 'grid_<G>^3x<F>',
'n_points'), the stashing forwards' times ('mlp_<L>x<H>_stash') and the
launches of each call by kernel name.
"""
from __future__ import annotations

import argparse
import json

import torch

from sunerf_tpu_torch.models.fields import emission_config, init_nerf, nerf_apply_fused
from sunerf_tpu_torch.ops import fused_mlp
from sunerf_tpu_torch.scripts.probe_step import timed


def grid_encode(points: torch.Tensor, table: torch.Tensor, grid_size: int,
                chunk: int = 1024) -> torch.Tensor:
    """Trilinear features from a dense [G^3, F] table: a comparison-built
    one-hot contraction, no gathers. points [N, 3] in [-1, 1]^3."""
    G = grid_size
    n = points.shape[0]
    n_pad = (n + chunk - 1) // chunk * chunk
    pts = torch.nn.functional.pad(points, (0, 0, 0, n_pad - n))
    cells = torch.arange(G, dtype=torch.float32, device=points.device)
    outs = []
    for p in pts.reshape(-1, chunk, 3):
        x = (p + 1.0) * 0.5 * (G - 1)                                   # [C, 3]
        # per axis the hat function over all G cells: nonzero only at the
        # two bracketing cells
        w = torch.clamp(1.0 - torch.abs(x[:, :, None] - cells), min=0.0)  # [C, 3, G]
        w3 = (w[:, 0, :, None, None] * w[:, 1, None, :, None]
              * w[:, 2, None, None, :]).reshape(p.shape[0], G * G * G)
        outs.append(torch.matmul(w3, table))
    return torch.cat(outs)[:n]




def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument('--n', type=int, default=73728,
                        help='points per eval (1024 rays x 72 samples)')
    parser.add_argument('--grid', type=int, nargs='+', default=[16, 24, 32])
    parser.add_argument('--features', type=int, default=16)
    parser.add_argument('--chunk', type=int, default=1024)
    parser.add_argument('--reps', type=int, default=3)
    parser.add_argument('--device', default='cuda')
    args = parser.parse_args(argv)

    device = torch.device(args.device)
    pts3 = (torch.rand(args.n, 3, generator=torch.Generator(device=device).manual_seed(0),
                       device=device) * 2.0 - 1.0)
    pts4 = torch.cat([pts3, torch.zeros(args.n, 1, device=device)], -1)

    out, launches = {}, {}
    with torch.no_grad():
        for nl, df in ((6, 384), (2, 128)):
            config = emission_config(n_layers=nl, d_filter=df)
            params = init_nerf(torch.Generator(device=device).manual_seed(1), config, device)
            key = f'mlp_{nl}x{df}'
            ms, launches[key] = timed(
                lambda c=config, p=params: nerf_apply_fused(c, p, pts4).raw, device,
                args.reps)
            out[key] = round(ms, 3)
            ms, launches[key + '_stash'] = timed(
                lambda c=config, p=params: fused_mlp.fused_mlp_stash_forward(c, p, pts4),
                device, args.reps)
            out[key + '_stash'] = round(ms, 3)

        for G in args.grid:
            table = torch.randn(G ** 3, args.features,
                                generator=torch.Generator(device=device).manual_seed(2),
                                device=device)
            ms, _ = timed(lambda t=table, g=G: grid_encode(pts3, t, g, args.chunk), device,
                          args.reps)
            out[f'grid_{G}^3x{args.features}'] = round(ms, 3)

    out['n_points'] = args.n
    out['launches'] = launches
    out['device'] = device.type
    print(json.dumps(out))
    return out


if __name__ == '__main__':
    main()
