"""Grid-encode probe P2 (scripts/probe_grid_hatbuild.py): the three ways of
building the (y, z) hat weights of the dense grid encode, each contracted
with the table on the tensor cores, timed on the card.

    python -m sunerf_tpu_torch.scripts.probe_grid_hatbuild [--check] \
        [--n 262144] [--grid 32] [--features 8] [--device cuda]

The variants (ops/grid_probes.py hat_encode, csrc/grid_hat_encode.cu):
'iota' builds wyz [N, G^2] directly from the hats; 'expand' builds per-axis
hat rows [N, G] and spreads them with the 0/1 expansion matrices E1, E2,
passed as operands, on the tensor cores; 'inkernel' is the TPU kernel's
grid_hat_mxu build, whose fixed E the kernel applies directly. All three
then take wyz @ table [G^2, G F] with bf16 operands and f32 sums, the table
in bf16 as the JAX script has it. --tile sizes the TPU kernel's point blocks
and has no counterpart here: it is accepted and unused.

Times: CUDA events, median of --reps calls after 3 warm-up calls (on
--device cpu the host clock, through the plain version: a CPU number). Draws
come from torch.Generator seeds 0 (table, standard normal) and 1 (points,
U(-1.2, 1.2)), so they differ from the JAX script's jax.random draws.
--check runs the JAX script's check (G = 8, bound 1.3, 200 points U(-2, 2)):
'expand' and 'inkernel' within 2% of max|iota| + 1e-4 of 'iota'.
"""
from __future__ import annotations

import argparse
import json

import torch

from sunerf_tpu_torch.ops import grid_probes
from sunerf_tpu_torch.ops.grid_probes import HAT_VARIANTS, expansion_matrices
from sunerf_tpu_torch.scripts.probe_grid_taps import device_of
from sunerf_tpu_torch.utils.profiling import timeit


def make_encode(G: int, F: int, bound: float, tile: int, variant: str):
    """Returns f(table [G^2, G F] bf16, points [N, 3] f32, e1=None, e2=None)
    -> [N, G F] f32 through the `variant` build; e1, e2 [G, G^2] bf16 are
    the expansion operands of 'expand'. `tile` is the TPU kernel's block of
    points and is not used."""
    del tile
    if variant not in HAT_VARIANTS:
        raise ValueError(f'variant must be one of {HAT_VARIANTS}, got {variant!r}')

    def encode(table, points, e1=None, e2=None):
        if table.shape[-1] != G * F:
            raise ValueError(f'table width {table.shape[-1]} is not G F = {G * F}')
        return grid_probes.hat_encode(table, points, G, bound, variant, e1, e2)

    return encode


def _expansion(G: int, device) -> tuple:
    return tuple(torch.from_numpy(e).to(device, torch.bfloat16)
                 for e in expansion_matrices(G))


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--n', type=int, default=262144)
    parser.add_argument('--grid', type=int, default=32)
    parser.add_argument('--features', type=int, default=8)
    parser.add_argument('--tile', type=int, default=512)
    parser.add_argument('--check', action='store_true')
    parser.add_argument('--reps', type=int, default=20)
    parser.add_argument('--device', default='cuda')
    args = parser.parse_args(argv)
    device = device_of(args.device)
    gen = lambda seed: torch.Generator(device=device).manual_seed(seed)
    G, F = args.grid, args.features

    if args.check:
        G = 8
        e1, e2 = _expansion(G, device)
        table = torch.randn((G * G, G * F), generator=gen(0),
                            device=device).to(torch.bfloat16)
        pts = torch.rand((200, 3), generator=gen(1), device=device) * 4.0 - 2.0
        a = make_encode(G, F, 1.3, 64, 'iota')(table, pts)
        b = make_encode(G, F, 1.3, 64, 'expand')(table, pts, e1, e2)
        c = make_encode(G, F, 1.3, 64, 'inkernel')(table, pts)
        scale = float(a.abs().max())
        out = {'check': 'ok'}
        for name, x in (('expand', b), ('inkernel', c)):
            err = float((a - x).abs().max())
            if not err < 0.02 * scale + 1e-4:
                raise AssertionError(f'{name}: max |iota - {name}| {err} over '
                                     f'2% of {scale} + 1e-4')
            out[f'max_abs_err_{name}'] = err
        out['device'] = device.type
        print(json.dumps(out))
        return out

    e1, e2 = _expansion(G, device)
    table = torch.randn((G * G, G * F), generator=gen(0), device=device).to(torch.bfloat16)
    pts = torch.rand((args.n, 3), generator=gen(1), device=device) * 2.4 - 1.2
    out = {'n_points': args.n, 'grid': G, 'tile': args.tile, 'device': device.type}
    for variant in HAT_VARIANTS:
        enc = make_encode(G, F, 1.3, args.tile, variant)
        operands = (e1, e2) if variant == 'expand' else ()
        out[f'{variant}_ms'] = timeit(enc, table, pts, *operands, device=device,
                                      reps=args.reps)
        print(json.dumps(out), flush=True)
    print(json.dumps(out))
    return out


if __name__ == '__main__':
    main()
