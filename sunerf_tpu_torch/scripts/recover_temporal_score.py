"""Re-score a completed temporal_closed_loop workdir without retraining, on
the port (scripts/recover_temporal_score.py of the JAX package).

A temporal_closed_loop workdir holds run/save_state.npz + .json,
run/metrics.jsonl and the eval/ ground truth: everything the loop's scoring
tail needs. This replays that tail (temporal_closed_loop.score_temporal:
the same normalization, asinh scaling at the recipe's vmax = 10, a = 0.005,
PSNR and SSIM) on the saved bundle through SuNeRFLoader (K0 on the card)
and prints the loop's JSON line with "recovered": true. The bundle loads
with no transposes, so a workdir the JAX package's script wrote scores too.
--platform is the JAX script's flag, taken as --device.

Usage: python -m sunerf_tpu_torch.scripts.recover_temporal_score WORKDIR [--device cuda]
Prints one JSON line (main returns it, with the launches by kernel name).
"""
from __future__ import annotations

import argparse
import json
import os
from datetime import datetime

import numpy as np


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument('workdir')
    parser.add_argument('--device', '--platform', dest='device', default='cuda',
                        help="'cuda' (the default, the card) or 'cpu'")
    args = parser.parse_args(argv)

    from sunerf_tpu_torch.evaluation.loader import SuNeRFLoader
    from sunerf_tpu_torch.scripts.probe_step import launches_by_kernel, zero_counts
    from sunerf_tpu_torch.scripts.temporal_closed_loop import score_temporal

    zero_counts()
    run_dir = os.path.join(args.workdir, 'run')
    with open(os.path.join(run_dir, 'save_state.json')) as fh:
        meta = json.load(fh)
    with open(os.path.join(run_dir, 'metrics.jsonl')) as fh:
        recs = [json.loads(line) for line in fh]
    spatial = [r for r in recs if 'val_psnr' in r][-1]
    rates = [r['rays_per_sec'] for r in recs if 'rays_per_sec' in r]
    steps = max(r['step'] for r in recs if 'step' in r)

    loader = SuNeRFLoader(os.path.join(run_dir, 'save_state.npz'), device=args.device)
    # the closed-loop recipe's scaling (temporal_closed_loop's LossConfig)
    t_psnrs, t_ssims = score_temporal(
        loader.renderer, loader.params, os.path.join(args.workdir, 'eval'), meta['Rs_per_ds'],
        meta['seconds_per_dt'], datetime.fromisoformat(meta['ref_time']), 10.0, 0.005,
        args.device)

    spec = meta.get('renderer_spec', {})
    render = spec.get('render', {})
    model_cfg = spec.get('model_config', {})
    out = {
        'frames': len(set(meta.get('times', []))), 'steps': steps,
        'budget': [render.get('n_stratified'), render.get('n_hierarchical')],
        'rays_per_sec': float(np.median(rates[1:] or rates)),
        'spatial_val_psnr': round(spatial['val_psnr'], 2),
        'spatial_val_ssim': round(spatial['val_ssim'], 4),
        'temporal_psnr': round(float(np.mean(t_psnrs)), 2),
        'temporal_psnr_min': round(float(np.min(t_psnrs)), 2),
        'temporal_ssim': round(float(np.mean(t_ssims)), 4),
        'n_eval_views': len(t_psnrs),
        'workdir': args.workdir, 'recovered': True,
    }
    if model_cfg.get('grid_rank'):
        out['grid'] = {'size': (model_cfg.get('grid_sizes') or [0])[0],
                       'rank': model_cfg.get('grid_rank'),
                       'time': model_cfg.get('grid_time')}
    print(json.dumps(out))
    out['launches'] = launches_by_kernel()
    return out


if __name__ == '__main__':
    main()
