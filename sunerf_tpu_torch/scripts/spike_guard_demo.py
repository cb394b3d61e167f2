"""Spike-guard rescue demo on the collapse-prone recipe, on the port
(scripts/spike_guard_demo.py of the JAX package).

The flat lr=1e-3 SimpleStar recipe collapsed in the JAX package's runs (loss
x250 in a few tens of steps). This script trains that configuration
(occupancy 40 + 80, flat lr, seed 7) on 8 synthesized SimpleStar views
twice, without and with the rollback spike guard (k = 10), and reports both
runs' final held-out PSNR and whether and when each tripped. The port's
random draws (init, batches, jitter) are not JAX's, so a collapse need not
come at JAX's step, or at all.

Training runs the port's Trainer on --device (K1 + K2 on the card, K0 for
the occupancy grid's updates and the validations).

Usage: python -m sunerf_tpu_torch.scripts.spike_guard_demo [--steps 3000]
           [--seed 7] [--resolution 128] [--device cuda]
Prints the result as JSON (main returns it, with the launches by kernel
name).
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
from datetime import datetime


def run(name, data, workdir, steps, seed, spike_guard, device='cuda'):
    """One Trainer run of the recipe -> its last validation, its largest
    logged loss and the step it was logged at, and the guard's trips (the
    count, and the first logged step by which one had happened)."""
    from sunerf_tpu_torch.systems import make_emission_system
    from sunerf_tpu_torch.train.loop import Trainer, TrainerConfig
    from sunerf_tpu_torch.train.objective import LossConfig
    from sunerf_tpu_torch.train.optim import OptimConfig

    renderer, init = make_emission_system(
        n_stratified=40, n_hierarchical=80,
        occupancy={'enabled': True, 'warmup': 200, 'update_every': 16,
                   'threshold': 0.01, 'floor': 0.05}, device=device)
    trainer = Trainer(
        renderer, init, data,
        loss_config=LossConfig(lambda_regularization=0.1, scaling_vmax=10.0),
        optim_config=OptimConfig(lr_start=1e-3, lr_floor=1e-3),  # knife edge
        spike_guard=spike_guard,
        trainer_config=TrainerConfig(total_steps=steps, val_every=steps,
                                     checkpoint_every=steps,
                                     log_every=max(steps // 30, 1),
                                     save_val_images=False, seed=seed),
        workdir=os.path.join(workdir, name), device=device)
    trainer.fit()
    with open(os.path.join(workdir, name, 'metrics.jsonl')) as f:
        recs = [json.loads(line) for line in f]
    val = [r for r in recs if 'val_psnr' in r][-1]
    losses = [(r['step'], r['loss']) for r in recs if 'loss' in r]
    max_step, max_loss = max(losses, key=lambda sl: sl[1])
    skips = sum(r.get('update_skipped', 0.0) for r in recs)
    tripped_by = [r['step'] for r in recs if r.get('spike_trips', 0.0) > 0]
    trips = int(getattr(trainer.state, 'trip_count', 0) or 0)
    return {'name': name, 'val_psnr': round(val['val_psnr'], 2),
            'val_ssim': round(val['val_ssim'], 4),
            'max_logged_loss': round(max_loss, 5),
            'logged_skip_steps': int(skips),
            'max_logged_loss_step': int(max_step), 'tripped': trips > 0,
            'trips': trips, 'first_trip_by_step': tripped_by[0] if tripped_by else None}


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument('--steps', type=int, default=3000)
    parser.add_argument('--seed', type=int, default=7)
    parser.add_argument('--resolution', type=int, default=128)
    parser.add_argument('--workdir', default=None)
    parser.add_argument('--device', '--platform', dest='device', default='cuda',
                        help="'cuda' (the default, the card) or 'cpu'")
    args = parser.parse_args(argv)

    from sunerf_tpu_torch.data.loaders import build_single_channel_data
    from sunerf_tpu_torch.evaluation.image_render import render_observers
    from sunerf_tpu_torch.scripts.probe_step import launches_by_kernel, zero_counts

    zero_counts()
    workdir = args.workdir or tempfile.mkdtemp(prefix='guard_demo_')
    observers = [{'name': 'aia', 'lat': 5.0 * ((i % 3) - 1), 'lon': i * 45.0,
                  'distance': 215.0,
                  'time': datetime(2012, 8, 23).isoformat()}
                 for i in range(8)]
    render_observers({
        'model': 'SimpleStar',
        'render_path': os.path.join(workdir, 'renders'),
        'render_format': ['fits'], 'resolution': args.resolution,
        'wavelengths': [193], 'batch_size': 4096,
        'pixel_intensity_factor': 1e9, 'observers': observers,
    }, device=args.device)
    data = build_single_channel_data(
        os.path.join(workdir, 'renders', 'aia', '193', '*.fits'),
        os.path.join(workdir, 'work'), batch_size=1024)

    unguarded = run('unguarded', data, workdir, args.steps, args.seed, None, args.device)
    guarded = run('guarded', data, workdir, args.steps, args.seed, 10.0, args.device)
    out = {'unguarded': unguarded, 'guarded': guarded, 'seed': args.seed,
           'workdir': workdir}
    print(json.dumps(out))
    out['launches'] = launches_by_kernel()
    return out


if __name__ == '__main__':
    main()
