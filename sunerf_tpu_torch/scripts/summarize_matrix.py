"""Summarize a protocol matrix's jsonl (psi_matrix.py / dt_matrix*.py
output; scripts/summarize_matrix.py of the JAX package) into a mean +- std
table over seeds, grouped by configuration. numpy only.

Usage: python -m sunerf_tpu_torch.scripts.summarize_matrix DT_MATRIX_torch.jsonl [--markdown]
Prints the table (or one JSON line a configuration); main returns the rows.
"""
from __future__ import annotations

import argparse
import json

import numpy as np


def config_key(c):
    tier = (f" tier{c.get('tier_fraction', 0)}/{c.get('tier_samples')}"
            if c.get('tier_fraction') else '')
    prop = ''
    if c.get('proposal_coarse'):
        shape = c.get('coarse_shape') or [4, 128]
        prop = f" prop{shape[0]}x{shape[1]}"
    occ = ' occ' if c.get('occupancy') else ''
    arch = (f" fine{c['model_shape'][0]}x{c['model_shape'][1]}"
            if c.get('model_shape') else '')
    ann = ''
    if c.get('anneal'):
        a = c['anneal']
        ann = f" anneal{a['frac']}@{a['n_stratified']}+{a['n_hierarchical']}"
    grid = ''
    if c.get('grid'):
        g = c['grid']
        grid = (f" grid{'x'.join(str(s) for s in g['sizes'])}"
                f"f{g['features']}b{g['bound']}")
        if g.get('hat_mxu'):
            grid += 'mxu'
    opt = ''
    if c.get('optim') or (c.get('grid') or {}).get('table_lr_mult'):
        o = c.get('optim') or c['grid']  # older rows kept it in the grid key
        opt = f" tlr{o['table_lr_mult']}eps{o['adam_eps']:g}"
    kb = ' best' if c.get('keep_best') else ''
    return (f"{c['n_stratified']}+{c['n_hierarchical']}{prop}{arch}{grid}"
            f"{opt}{tier}{occ}{ann}{kb} @{c['steps']}st")


def main(argv=None) -> list:
    parser = argparse.ArgumentParser()
    parser.add_argument('path')
    parser.add_argument('--markdown', action='store_true')
    parser.add_argument('--baseline-rays', type=float, default=10_000.0,
                        help='estimated reference rays/s (BASELINE.md)')
    args = parser.parse_args(argv)

    groups = {}
    with open(args.path) as fh:
        for line in fh:
            rec = json.loads(line)
            groups.setdefault(config_key(rec['config']), []).append(rec)

    rows = []
    for key, recs in groups.items():
        tp = [r['test']['psnr'] for r in recs]
        ts = [r['test']['ssim'] for r in recs]
        rate = float(np.median([r['rays_per_sec'] for r in recs]))
        rows.append({
            'config': key, 'n_seeds': len(recs),
            'rays_per_sec': round(rate, 1),
            'vs_baseline': round(rate / args.baseline_rays, 2),
            'test_psnr_mean': round(float(np.mean(tp)), 2),
            'test_psnr_std': round(float(np.std(tp)), 2),
            'test_psnr_runs': [round(p, 2) for p in tp],
            'test_ssim_mean': round(float(np.mean(ts)), 3),
            'train_psnr_mean': round(float(np.mean(
                [r['train']['psnr'] for r in recs])), 2),
        })
    rows.sort(key=lambda r: r['rays_per_sec'])

    if args.markdown:
        print('| Configuration | rays/s | vs est. baseline | test PSNR '
              '(seeds) | test SSIM |')
        print('|---|---|---|---|---|')
        for r in rows:
            print(f"| {r['config']} | {r['rays_per_sec']:,.0f} | "
                  f"{r['vs_baseline']}x | {r['test_psnr_mean']} +- "
                  f"{r['test_psnr_std']} ({r['n_seeds']}) | "
                  f"{r['test_ssim_mean']} |")
    else:
        for r in rows:
            print(json.dumps(r))
    return rows


if __name__ == '__main__':
    main()
