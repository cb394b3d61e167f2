"""The psi_193 matrix on the port (scripts/psi_matrix.py of the JAX
package): seeds x equal-wall-clock configurations of the emission protocol
(sunerf_tpu_torch/scripts/psi_protocol.py), each row a subprocess with its
own deadline, resumable (a row whose signature is already in the output
jsonl is skipped) and scene-cached (--data-cache shared across rows).

The step counts are the JAX package's: they equalize wall-clock against the
4k-step parity row at the rates it measured on its chip (parity 47.9k;
proposal + 32 + 64 ~120k -> 10k steps; proposal + 40 + 80 ~95k -> 8k;
tiered full ~99.8k -> 8.3k; tiered half ~190.8k -> 16k); each row records
the rate measured here.

Usage: python -m sunerf_tpu_torch.scripts.psi_matrix [--out PSI_MATRIX_torch.jsonl]
       [--seeds 7 8 9] [--only parity] [--device cuda] [--deadline 14400]
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile

from sunerf_tpu_torch.scripts.dt_matrix import plan_row, run_rows

CONFIGS = [
    # (label, steps, extra args)
    ('parity', 4000, []),
    ('proposal_half', 10000, ['--proposal-coarse', '--n-stratified', '32',
                              '--n-hierarchical', '64']),
    ('proposal_40_80', 8000, ['--proposal-coarse', '--n-stratified', '40',
                              '--n-hierarchical', '80']),
    ('proposal2x64_half', 10000, ['--proposal-coarse', '--coarse-layers', '2',
                                  '--coarse-filter', '64',
                                  '--n-stratified', '32',
                                  '--n-hierarchical', '64']),
    ('tiered_full', 8300, ['--proposal-coarse', '--tier-fraction', '0.5',
                           '--tier-samples', '32']),
    ('tiered_half', 16000, ['--proposal-coarse', '--n-stratified', '32',
                            '--n-hierarchical', '64', '--tier-fraction',
                            '0.5', '--tier-samples', '16']),
    # contingency rows targeting >=100k at matched quality
    ('prop2x64_40_80', 8300, ['--proposal-coarse', '--coarse-layers', '2',
                              '--coarse-filter', '64', '--n-stratified',
                              '40', '--n-hierarchical', '80']),
    ('tiered2x64_full', 8700, ['--proposal-coarse', '--coarse-layers', '2',
                               '--coarse-filter', '64', '--tier-fraction',
                               '0.5', '--tier-samples', '32']),
    ('tiered2x64_40_80', 12000, ['--proposal-coarse', '--coarse-layers', '2',
                                 '--coarse-filter', '64', '--n-stratified',
                                 '40', '--n-hierarchical', '80',
                                 '--tier-fraction', '0.5',
                                 '--tier-samples', '24']),
    # occupancy v2 rows (robust-max criterion + occ_vol factor) —
    # the psi streamer scene is exactly the shell+blob class the vol factor
    # was built for; steps equalize wall-clock via bench.py rates
    # (occupancy 32+64 ~94.9k, +proposal ~120k, 24+48 est ~150k)
    ('occ_half', 8000, ['--occupancy', '--n-stratified', '32',
                        '--n-hierarchical', '64']),
    ('prop_occ_half', 10000, ['--proposal-coarse', '--occupancy',
                              '--n-stratified', '32',
                              '--n-hierarchical', '64']),
    ('prop_occ_24_48', 12500, ['--proposal-coarse', '--occupancy',
                               '--n-stratified', '24',
                               '--n-hierarchical', '48']),
    # no-grid control for prop_occ_24_48: the occ row hit 143k at
    # matched-or-better 3-seed quality, but the value case says the budget
    # (not the grid) is usually the lever — attribute it properly
    ('prop_24_48', 12500, ['--proposal-coarse', '--n-stratified', '24',
                           '--n-hierarchical', '48']),
    # frontier edge: prop_24_48 landed +1.13 dB over parity at 16.0x —
    # how deep does the proposal-placed budget cut go before quality
    # breaks? Steps equalize wall-clock via bench.py-extrapolated rates
    # (20+40 ~185k, 16+32 ~210k).
    ('prop_20_40', 15000, ['--proposal-coarse', '--n-stratified', '20',
                           '--n-hierarchical', '40']),
    ('prop_16_32', 17500, ['--proposal-coarse', '--n-stratified', '16',
                           '--n-hierarchical', '32']),
    # budget annealing: prop_16_32 underfits (the knee is a TRAINING
    # deficiency — EVAL_BUDGET_r3 full-budget re-eval does not rescue it);
    # a 15% warm phase at 24+48 establishes the field before the cheap
    # budget takes over. Steps equalize wall-clock at the measured phase
    # rates (24+48 159.5k, 16+32 191.2k -> harmonic 185.7k).
    ('anneal_16_32', 15500, ['--proposal-coarse', '--n-stratified', '16',
                             '--n-hierarchical', '32', '--anneal-frac',
                             '0.15', '--anneal-stratified', '24',
                             '--anneal-hierarchical', '48']),
    # architecture axis: the quarter-budget step is still fine-MLP-bound
    # (scripts/probe_overhead.py, same-process A/B: 8x512 6.58 ms, 6x384
    # 3.43 ms = 298k rays/s, 4x256 2.16 ms = 473k). Step counts are BELOW
    # equal wall-clock on purpose: the small fields converge by ~12.5k
    # steps and then DEGRADE (the 25k-step 6x384 row in the jsonl: train
    # batches reach PSNR 43 while re-rendered views fall to 26.4 — NeRF
    # overfit/aliasing under the longer high-lr schedule), so matched
    # quality at LESS wall-clock is the claim, which is strictly stronger.
    ('arch_6x384', 12500, ['--proposal-coarse', '--n-stratified', '24',
                           '--n-hierarchical', '48', '--model-layers', '6',
                           '--model-filter', '384']),
    ('arch_4x256', 20000, ['--proposal-coarse', '--n-stratified', '24',
                           '--n-hierarchical', '48', '--model-layers', '4',
                           '--model-filter', '256']),
    ('arch_6x384_half', 10000, ['--proposal-coarse', '--n-stratified', '32',
                                '--n-hierarchical', '64', '--model-layers',
                                '6', '--model-filter', '384']),
]


def main(argv=None) -> list:
    parser = argparse.ArgumentParser()
    parser.add_argument('--out', default='PSI_MATRIX_torch.jsonl')
    parser.add_argument('--seeds', type=int, nargs='+', default=[7, 8, 9])
    parser.add_argument('--data-cache',
                        default=os.path.join(tempfile.gettempdir(), 'psi_scene_cache'))
    parser.add_argument('--only', nargs='+', default=None,
                        help='run only these config labels (e.g. '
                             '--only arch_6x384 arch_4x256)')
    parser.add_argument('--keep-best', action='store_true',
                        help='append --keep-best to every run (changes row '
                             'semantics/signature: use a separate --out)')
    parser.add_argument('--resolution', type=int, default=128)
    parser.add_argument('--device', default='cuda',
                        help="passed to each protocol run: 'cuda' (the card) or 'cpu'")
    parser.add_argument('--deadline', type=float, default=14400.0,
                        help='seconds each row may run before it is killed')
    args = parser.parse_args(argv)

    configs = [c for c in CONFIGS
               if args.only is None or c[0] in args.only]
    if args.only and len(configs) != len(args.only):
        known = {c[0] for c in CONFIGS}
        sys.exit(f'unknown --only labels: {set(args.only) - known}')

    rows = []
    for seed in args.seeds:
        for label, steps, extra in configs:
            run_extra = list(extra)
            if args.keep_best and '--keep-best' not in run_extra:
                run_extra.append('--keep-best')
            rows.append(plan_row('psi_protocol', label, steps, seed, args.out,
                                 args.data_cache, args.device,
                                 ['--resolution', str(args.resolution)] + run_extra))
    return run_rows(rows, args.out, args.deadline)


if __name__ == '__main__':
    main()
