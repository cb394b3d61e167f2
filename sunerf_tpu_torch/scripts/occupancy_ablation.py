"""Sample-budget / occupancy ablation on the SimpleStar closed loop, on the
port (scripts/occupancy_ablation.py of the JAX package).

Modes over the same synthesized 8-view set (193 A, one timestamp):
  * default: one baseline (64 + 128 samples) and one variant
    (--occ-stratified / --occ-hierarchical, occupancy-guided unless
    --control): a quick A/B;
  * --matrix: {baseline, plain-reduced, occupancy-reduced} x {64/128,
    40/80, 32/64} x --seeds, mean +- std held-out PSNR / SSIM;
  * --tiers: {baseline, proposal, tiered full, tiered half} x --seeds at
    equal steps.
Training runs the port's Trainer on --device (K1 + K2 on the card; the
occupancy grid's update on K0).

Usage: python -m sunerf_tpu_torch.scripts.occupancy_ablation --matrix \\
           --threshold 0.01 --floor 0.05 [--steps 3000] [--resolution 128] \\
           [--seeds 7 8 9] [--device cuda]
Prints the result as JSON (main returns it).
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
from datetime import datetime

import numpy as np


def run_variant(name, data, workdir, steps, seed=7, spike_guard=10.0, device='cuda',
                **render_kwargs):
    """One Trainer run of an emission variant; its median window rays/s
    and the last validation's PSNR and SSIM. spike_guard: the trip factor
    k, or None to disable. k must exceed the scene's inter-batch loss
    spread: on a scene of one compact bright feature (most batches dark,
    blob batches huge) k = 10 trips on most steps and freezes training at
    init (occupancy_value_case.py passes None)."""
    from sunerf_tpu_torch.systems import make_emission_system
    from sunerf_tpu_torch.train.loop import Trainer, TrainerConfig
    from sunerf_tpu_torch.train.objective import LossConfig
    from sunerf_tpu_torch.train.optim import OptimConfig

    renderer, init = make_emission_system(device=device, **render_kwargs)
    trainer = Trainer(
        renderer, init, data,
        loss_config=LossConfig(lambda_regularization=0.1, scaling_vmax=10.0),
        # a decaying lr: a flat 1e-3 never settles, so the end-of-run
        # validation would read noise
        optim_config=OptimConfig(lr_start=1e-3, lr_end=1e-4,
                                 lr_iterations=steps, lr_floor=1e-4),
        spike_guard=spike_guard,
        trainer_config=TrainerConfig(total_steps=steps, val_every=steps,
                                     checkpoint_every=steps,
                                     log_every=max(steps // 10, 1),
                                     save_val_images=False, seed=seed),
        workdir=os.path.join(workdir, name), device=device)
    trainer.fit()
    with open(os.path.join(workdir, name, 'metrics.jsonl')) as f:
        recs = [json.loads(line) for line in f]
    rates = [r['rays_per_sec'] for r in recs if 'rays_per_sec' in r]
    val = [r for r in recs if 'val_psnr' in r][-1]
    return {'name': name, 'rays_per_sec': float(np.median(rates[1:] or rates)),
            'val_psnr': val['val_psnr'], 'val_ssim': val['val_ssim']}


def matrix_specs(tiers: bool, threshold: float, floor: float) -> list:
    """(name, render kwargs) of the --matrix (or --tiers) variants."""
    occ = {'enabled': True, 'warmup': 200, 'update_every': 16,
           'threshold': threshold, 'floor': floor}
    if tiers:
        from sunerf_tpu_torch.models.fields import emission_config
        proposal = emission_config(n_layers=4, d_filter=128)
        return [
            ('baseline_64_128', dict(n_stratified=64, n_hierarchical=128)),
            ('proposal_64_128', dict(coarse_config=proposal)),
            ('tiered_64_128', dict(coarse_config=proposal,
                                   tier_fraction=0.5, tier_samples=32)),
            ('tiered_32_64', dict(n_stratified=32, n_hierarchical=64,
                                  coarse_config=proposal,
                                  tier_fraction=0.5, tier_samples=16)),
        ]
    return [
        ('baseline_64_128', dict(n_stratified=64, n_hierarchical=128)),
        ('control_40_80', dict(n_stratified=40, n_hierarchical=80)),
        ('occ_40_80', dict(n_stratified=40, n_hierarchical=80, occupancy=occ)),
        ('control_32_64', dict(n_stratified=32, n_hierarchical=64)),
        ('occ_32_64', dict(n_stratified=32, n_hierarchical=64, occupancy=occ)),
    ]


def ab_specs(args) -> list:
    """(name, render kwargs) of the default A/B: the baseline and one
    variant."""
    if args.control:
        variant = (f'control_{args.occ_stratified}_{args.occ_hierarchical}',
                   dict(n_stratified=args.occ_stratified,
                        n_hierarchical=args.occ_hierarchical))
    else:
        variant = (f'occ_{args.occ_stratified}_{args.occ_hierarchical}'
                   f'_t{args.threshold}_f{args.floor}',
                   dict(n_stratified=args.occ_stratified,
                        n_hierarchical=args.occ_hierarchical,
                        occupancy={'enabled': True, 'warmup': 200,
                                   'update_every': 16,
                                   'threshold': args.threshold,
                                   'floor': args.floor}))
    return [('baseline', dict(n_stratified=64, n_hierarchical=128)), variant]


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument('--steps', type=int, default=3000)
    parser.add_argument('--resolution', type=int, default=128)
    parser.add_argument('--workdir', default=None)
    parser.add_argument('--occ-stratified', type=int, default=32)
    parser.add_argument('--occ-hierarchical', type=int, default=64)
    parser.add_argument('--threshold', type=float, default=0.05)
    parser.add_argument('--floor', type=float, default=0.02)
    parser.add_argument('--control', action='store_true',
                        help='run the occ sample counts WITHOUT occupancy '
                             '(isolates fewer-samples from grid guidance)')
    parser.add_argument('--matrix', action='store_true',
                        help='run the full {baseline, control, occ} x '
                             '{64/128, 40/80, 32/64} x seeds grid and print '
                             'a mean+-std summary (overrides the other '
                             'variant flags)')
    parser.add_argument('--tiers', action='store_true',
                        help='matrix over adaptive per-ray budgets instead: '
                             '{baseline, proposal, tiered full, tiered half} '
                             'x seeds at EQUAL STEPS')
    parser.add_argument('--seeds', type=int, nargs='+', default=[7, 8, 9])
    parser.add_argument('--device', default='cuda',
                        help="'cuda' (the default, the card) or 'cpu'")
    args = parser.parse_args(argv)

    import torch

    from sunerf_tpu_torch.data.loaders import build_single_channel_data
    from sunerf_tpu_torch.evaluation.image_render import render_observers

    device = torch.device(args.device)
    workdir = args.workdir or tempfile.mkdtemp(prefix='occ_ablation_')
    # one timestamp for all views: distinct times let the 4D field memorize
    # per-time appearance, and the held-out view then scores ~8 dB whatever
    # the sampling; static views isolate the sampling comparison
    observers = [{'name': 'aia', 'lat': 5.0 * ((i % 3) - 1), 'lon': i * 45.0,
                  'distance': 215.0,
                  'time': datetime(2012, 8, 23).isoformat()}
                 for i in range(8)]
    render_observers({
        'model': 'SimpleStar',
        'render_path': os.path.join(workdir, 'renders'),
        'render_format': ['fits'],
        'resolution': args.resolution,
        'wavelengths': [193],
        'batch_size': 4096,
        'pixel_intensity_factor': 1e9,
        'observers': observers,
    }, device=device)
    data = build_single_channel_data(
        os.path.join(workdir, 'renders', 'aia', '193', '*.fits'),
        os.path.join(workdir, 'work'), batch_size=1024)

    if args.matrix or args.tiers:
        summary = {}
        for cname, kwargs in matrix_specs(args.tiers, args.threshold, args.floor):
            runs = [run_variant(f'{cname}_s{s}', data, workdir, args.steps,
                                seed=s, device=device, **kwargs) for s in args.seeds]
            psnrs = [r['val_psnr'] for r in runs]
            ssims = [r['val_ssim'] for r in runs]
            summary[cname] = {
                'rays_per_sec': round(float(np.median(
                    [r['rays_per_sec'] for r in runs])), 1),
                'psnr_mean': round(float(np.mean(psnrs)), 2),
                'psnr_std': round(float(np.std(psnrs)), 2),
                'psnr_runs': [round(p, 2) for p in psnrs],
                'ssim_mean': round(float(np.mean(ssims)), 4),
            }
            print(json.dumps({cname: summary[cname]}), flush=True)
        out = {'matrix': summary, 'seeds': args.seeds,
               'threshold': args.threshold, 'floor': args.floor}
        print(json.dumps(out))
        return out

    (a_name, a_kw), (b_name, b_kw) = ab_specs(args)
    a = run_variant(a_name, data, workdir, args.steps, device=device, **a_kw)
    b = run_variant(b_name, data, workdir, args.steps, device=device, **b_kw)
    speedup = b['rays_per_sec'] / a['rays_per_sec']
    out = {'baseline': a, 'occupancy': b, 'speedup': round(speedup, 3),
           'psnr_delta': round(b['val_psnr'] - a['val_psnr'], 3)}
    print(json.dumps(out))
    return out


if __name__ == '__main__':
    main()
