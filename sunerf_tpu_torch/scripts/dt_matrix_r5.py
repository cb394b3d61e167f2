"""The five-channel DT production matrix on the port (scripts/dt_matrix_r5.py
of the JAX package): 256 px, five AIA channels (94 131 171 193 211; the
hot-blob scene gives 94 / 131 structure of their own), the union-lambda
mask exercise (the odd ecliptic views from a second source without 94 /
131), keep_best and the drift-probe traces.

Arms per seed:
  * dt_parity       64 + 128 at the base step count (the equal-wall-clock
                    anchor)
  * dt_parity_eq    parity at the fast arms' step count (the converged
                    parity control)
  * dt_prop_24_48   proposal 4x128 + 24 + 48, equal wall-clock
  * dt_tiered_warm  tiered (warmed 1750 steps), equal wall-clock
  * dt_long         prop_24_48 at 4x the steps (the long-schedule row)

Each row is a subprocess of the port's dt_protocol with its own deadline;
rows whose signature is already in the output jsonl are skipped.

Usage: python -m sunerf_tpu_torch.scripts.dt_matrix_r5 [--out DT_MATRIX_torch.jsonl]
       [--seeds 7 8] [--only dt_parity] [--device cuda] [--deadline 14400]
"""
from __future__ import annotations

import argparse
import os
import tempfile

from sunerf_tpu_torch.scripts.dt_matrix import plan_row, run_rows

WAVELENGTHS = [94, 131, 171, 193, 211]
BASE_STEPS = 8000  # the parity anchor (2x the 3-channel matrix: 256 px)

CONFIGS = [
    # (label, steps, extra args)
    ('dt_parity', BASE_STEPS, []),
    ('dt_parity_eq', 24000, []),
    ('dt_prop_24_48', 24000, ['--proposal-coarse', '--n-stratified', '24',
                              '--n-hierarchical', '48']),
    ('dt_tiered_warm', 28000, ['--proposal-coarse', '--n-stratified', '32',
                               '--n-hierarchical', '64', '--tier-fraction',
                               '0.5', '--tier-samples', '16',
                               '--tier-warmup-steps', '1750']),
    ('dt_long', 96000, ['--proposal-coarse', '--n-stratified', '24',
                        '--n-hierarchical', '48']),
]

COMMON = ['--resolution', '256', '--wavelengths'] + \
    [str(w) for w in WAVELENGTHS] + \
    ['--hot-blob', '--mask-exercise', '--keep-best']


def main(argv=None) -> list:
    parser = argparse.ArgumentParser()
    parser.add_argument('--out', default='DT_MATRIX_torch.jsonl')
    parser.add_argument('--seeds', type=int, nargs='+', default=[7, 8])
    parser.add_argument('--data-cache',
                        default=os.path.join(tempfile.gettempdir(), 'dt_scene_cache_r5'))
    parser.add_argument('--only', nargs='+', default=None)
    parser.add_argument('--device', default='cuda',
                        help="passed to each protocol run: 'cuda' (the card) or 'cpu'")
    parser.add_argument('--deadline', type=float, default=14400.0,
                        help='seconds each row may run before it is killed')
    args = parser.parse_args(argv)

    configs = [c for c in CONFIGS if args.only is None or c[0] in args.only]
    rows = [plan_row('dt_protocol', label, steps, seed, args.out, args.data_cache,
                     args.device, COMMON + extra)
            for seed in args.seeds for label, steps, extra in configs]
    return run_rows(rows, args.out, args.deadline)


if __name__ == '__main__':
    main()
