"""Re-score trained psi_193 matrix bundles at another evaluation-time
sample budget (scripts/eval_budget_sweep.py of the JAX package), through
SuNeRFLoader's render_overrides (K0 on the card).

The matrix evaluates each run with the renderer spec it trained with, so a
16 + 32 run is also rendered with 16 + 32 samples, which conflates (a) a
worse fit with (b) a coarser held-out quadrature. The sweep separates the
two by re-rendering the saved bundles at the full 64 + 128 budget.

Usage: python -m sunerf_tpu_torch.scripts.eval_budget_sweep
       [--matrix PSI_MATRIX_torch.jsonl] [--gt '<scene>/gt/*.fits']
       [--out EVAL_BUDGET_torch.jsonl] [--n-stratified 64]
       [--n-hierarchical 128] [--budgets 16 20 24 32] [--device cuda]
Appends a JSON line a re-scored row to --out; main returns the rows.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import tempfile


def main(argv=None) -> list:
    parser = argparse.ArgumentParser()
    parser.add_argument('--matrix', default='PSI_MATRIX_torch.jsonl')
    parser.add_argument('--gt', default=os.path.join(tempfile.gettempdir(),
                                                     'psi_scene_cache', 'gt', '*.fits'))
    parser.add_argument('--out', default='EVAL_BUDGET_torch.jsonl')
    parser.add_argument('--n-stratified', type=int, default=64)
    parser.add_argument('--n-hierarchical', type=int, default=128)
    parser.add_argument('--budgets', type=int, nargs='+', default=None,
                        help='train-time n_stratified values to re-score '
                             '(default: 16 20 24 32)')
    parser.add_argument('--device', default='cuda',
                        help="'cuda' (the default, the card) or 'cpu'")
    args = parser.parse_args(argv)

    from sunerf_tpu_torch.evaluation.loader import SuNeRFLoader
    from sunerf_tpu_torch.evaluation.metrics_harness import evaluate_viewpoints

    budgets = set(args.budgets or (16, 20, 24, 32))
    with open(args.matrix) as fh:
        rows = [json.loads(line) for line in fh if line.strip()]
    rows = [r for r in rows
            if r['config'].get('proposal_coarse')
            and r['config'].get('tier_fraction', 0.0) == 0.0
            and 'occupancy' not in r['config']
            and r['config']['n_stratified'] in budgets]

    done = []
    if os.path.exists(args.out):
        with open(args.out) as fh:
            done = [json.loads(line)['config'] for line in fh if line.strip()]

    gt_files = sorted(glob.glob(args.gt))
    if not gt_files:
        raise SystemExit(f'no ground-truth FITS match {args.gt}')

    results = []
    for r in rows:
        sig = dict(r['config'],
                   eval_budget=[args.n_stratified, args.n_hierarchical])
        if sig in done:
            print(f'skip (done): {sig}', flush=True)
            continue
        state = os.path.join(r['workdir'], 'run', 'save_state.npz')
        if not os.path.exists(state):
            print(f'skip (gone): {state}', flush=True)
            continue
        loader = SuNeRFLoader(state, render_overrides={
            'n_stratified': args.n_stratified,
            'n_hierarchical': args.n_hierarchical}, device=args.device)
        metrics = evaluate_viewpoints(loader, gt_files)
        out = {'config': sig,
               'trained_test': r['test'],
               'test': metrics['test'], 'train': metrics['train'],
               'rays_per_sec': r['rays_per_sec']}
        print(json.dumps(out), flush=True)
        with open(args.out, 'a') as fh:
            fh.write(json.dumps(out) + '\n')
        results.append(out)
    return results


if __name__ == '__main__':
    main()
