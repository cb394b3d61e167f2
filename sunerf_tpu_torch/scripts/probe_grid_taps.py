"""Grid-encode probe P1 (scripts/probe_grid_taps.py): trilinear features of
a dense feature grid by 8 table taps per point, timed on the card.

    python -m sunerf_tpu_torch.scripts.probe_grid_taps [--check] [--n 65536] \
        [--grid 32 64] [--features 8] [--device cuda]

The JAX script measures whether per-point dynamic-slice taps from a
VMEM-resident table beat the dense one-hot contraction at large G. Here
each point's taps are 8 loads of F contiguous floats from the table in L2
(ops/grid_probes.py tap_encode, csrc/grid_tap_encode.cu). The table is
packed as the JAX script packs it, [G^3 / P, 128] with P = 128 // F, which
on the card is the same bytes as [G^3, F]. --tile sizes the TPU kernel's
point blocks and has no counterpart here: it is accepted and unused.

Times: CUDA events, median of --reps calls after 3 warm-up calls (on
--device cpu the host clock, through the plain version: a CPU number, not
the card's). Draws come from torch.Generator seeds 1 (points, U(-1.2, 1.2))
and 2 (table, standard normal), so they differ from the JAX script's
jax.random draws. --check compares the kernel (or, on the CPU, its plain
version) with ops/grid_encoding.py grid_encode on the JAX script's check
inputs (G = 8, 300 points U(-2, 2), bound 2) at rtol = atol = 1e-5.
"""
from __future__ import annotations

import argparse
import json

import torch

from sunerf_tpu_torch.ops import grid_probes
from sunerf_tpu_torch.ops.grid_encoding import grid_encode
from sunerf_tpu_torch.ops.grid_probes import pack_table
from sunerf_tpu_torch.utils.profiling import timeit


def make_tap_encode(grid_size: int, features: int, bound: float, tile: int = 256):
    """Returns f(packed_table [G^3 // P, 128] f32, points [N, 3] f32) -> [N, F]
    by 8 table taps per point. `tile` is the TPU kernel's block of points and
    is not used."""
    del tile

    def encode(packed_table, points):
        if packed_table.numel() != grid_size ** 3 * features:
            raise ValueError(f'packed_table holds {packed_table.numel()} values, not '
                             f'{grid_size}^3 x {features}')
        return grid_probes.tap_encode(packed_table, points, grid_size, bound)

    return encode


def device_of(name: str) -> torch.device:
    """The device a probe runs on; a CUDA device on a host without one
    ends the run."""
    device = torch.device(name)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise SystemExit('no CUDA device: run on the card or pass --device cpu')
    return device


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--n', type=int, default=65536)
    parser.add_argument('--grid', type=int, nargs='+', default=[32, 64])
    parser.add_argument('--features', type=int, default=8)
    parser.add_argument('--tile', type=int, default=256)
    parser.add_argument('--check', action='store_true',
                        help='the kernel against grid_encode on the check inputs')
    parser.add_argument('--reps', type=int, default=20)
    parser.add_argument('--device', default='cuda')
    args = parser.parse_args(argv)
    device = device_of(args.device)
    gen = lambda seed: torch.Generator(device=device).manual_seed(seed)

    if args.check:
        G = 8
        table4 = torch.randn((G, G, G, args.features), generator=gen(0), device=device)
        pts = torch.rand((300, 3), generator=gen(1), device=device) * 4.0 - 2.0
        got = make_tap_encode(G, args.features, 2.0, 64)(pack_table(table4), pts)
        want = grid_encode(table4, pts, bound=2.0)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        out = {'check': 'ok', 'max_abs_err': float((got - want).abs().max()),
               'device': device.type}
        print(json.dumps(out))
        return out

    pts = torch.rand((args.n, 3), generator=gen(1), device=device) * 2.4 - 1.2
    out = {'n_points': args.n, 'tile': args.tile, 'features': args.features,
           'device': device.type}
    for G in args.grid:
        table4 = torch.randn((G, G, G, args.features), generator=gen(2), device=device)
        packed = pack_table(table4)
        enc = make_tap_encode(G, args.features, 1.3, args.tile)
        ms = timeit(enc, packed, pts, device=device, reps=args.reps)
        out[f'taps_{G}^3_ms'] = ms
        out[f'taps_{G}^3_ns_per_tap'] = ms * 1e6 / (args.n * 8)
        print(json.dumps({k: v for k, v in out.items() if str(G) in k}), flush=True)
    print(json.dumps(out))
    return out


if __name__ == '__main__':
    main()
