"""DT-head quality ablation on the port (scripts/dt_ablation.py of the JAX
package): the proposal coarse field and the adaptive per-ray budgets on
the multi-thermal closed loop.

SimpleStar rendered at 4 AIA wavelengths from 8 viewpoints -> the
multi-thermal loader -> DT SuNeRF (raw intensities, per-lambda log_abs,
the temperature-response synthesis) x {parity 64 + 128, proposal 4x128,
tiered half, prop 24 + 48, 6x384, grid 4x128} x seeds, scored on the
held-out view. Equal steps (conservative for the accelerated configs).
Training runs the port's Trainer on --device (K1 + K2 on the card; the
grid variant through the kernels' grid branch, K5).

Usage: python -m sunerf_tpu_torch.scripts.dt_ablation [--steps 3000]
       [--seeds 7 8 9] [--configs dt_parity_64_128 ...] [--device cuda]
Prints a JSON line a configuration and the summary (main returns it).
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
from datetime import datetime, timedelta

import numpy as np

WAVELENGTHS = [171, 193, 211, 304]


def run_variant(name, data, workdir, steps, seed, device='cuda', **sys_kwargs):
    """One Trainer run of a variant; its median window rays/s and the last
    validation's PSNR and SSIM."""
    from sunerf_tpu_torch.systems import make_density_temperature_system
    from sunerf_tpu_torch.train.loop import Trainer, TrainerConfig
    from sunerf_tpu_torch.train.objective import LossConfig
    from sunerf_tpu_torch.train.optim import OptimConfig

    # pixel_intensity_factor 1e17, the reference module's default, is what
    # lifts the multiplicative DT head off (image ~ exp(2 log_rho) R(log_T)
    # pif): at the base init it puts predictions near the target scale; at
    # the generation pif of 1e9 the gradients vanish and every config
    # collapses to the zero prediction
    renderer, init = make_density_temperature_system(
        pixel_intensity_factor=1e17, device=device, **sys_kwargs)
    # grid-encoded fields take the NGP table recipe
    grid = bool(getattr(sys_kwargs.get('model_config'), 'grid_sizes', ()))
    trainer = Trainer(
        renderer, init, data,
        loss_config=LossConfig(image_scaling='none',
                               lambda_regularization=0.0),
        optim_config=OptimConfig(lr_start=1e-3, lr_end=1e-4,
                                 lr_iterations=steps, lr_floor=1e-4,
                                 table_lr_mult=10.0 if grid else 1.0,
                                 adam_eps=1e-15 if grid else 1e-8),
        # no spike guard: raw multi-thermal intensities have a large
        # ordinary inter-batch loss variance, which trips it
        spike_guard=None,
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


def variant_specs() -> list:
    """(name, system kwargs) of every variant, in the JAX script's order."""
    from sunerf_tpu_torch.models.fields import density_temperature_config

    # n_freqs_time=2: the 10-min observer spacing must not be memorizable
    # along the time axis
    model = density_temperature_config(n_freqs_time=2)
    proposal = density_temperature_config(n_layers=4, d_filter=128,
                                          n_freqs_time=2)
    return [
        ('dt_parity_64_128', dict(model_config=model, n_stratified=64,
                                  n_hierarchical=128)),
        ('dt_proposal', dict(model_config=model, n_stratified=64,
                             n_hierarchical=128, coarse_config=proposal)),
        ('dt_tiered_half', dict(model_config=model, n_stratified=32,
                                n_hierarchical=64, coarse_config=proposal,
                                tier_fraction=0.5, tier_samples=16)),
        # the proposal-placed budget cut without tiers
        ('dt_prop_24_48', dict(model_config=model, n_stratified=24,
                               n_hierarchical=48, coarse_config=proposal)),
        # the architecture axis on the DT head
        ('dt_arch_6x384', dict(
            model_config=density_temperature_config(
                n_layers=6, d_filter=384, n_freqs_time=2),
            n_stratified=24, n_hierarchical=48, coarse_config=proposal)),
        # a feature-grid fine field on the DT head
        ('dt_grid_4x128', dict(
            model_config=density_temperature_config(
                n_layers=4, d_filter=128, n_freqs_time=2,
                grid_sizes=(16, 32), grid_features=8, grid_bound=1.3),
            n_stratified=24, n_hierarchical=48, coarse_config=proposal)),
    ]


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument('--steps', type=int, default=3000)
    parser.add_argument('--resolution', type=int, default=128)
    parser.add_argument('--seeds', type=int, nargs='+', default=[7, 8, 9])
    parser.add_argument('--workdir', default=None)
    parser.add_argument('--out', default=None)
    parser.add_argument('--configs', nargs='+', default=None,
                        help='run only these named configs (default: all)')
    parser.add_argument('--device', default='cuda',
                        help="'cuda' (the default, the card) or 'cpu'")
    args = parser.parse_args(argv)

    import torch

    from sunerf_tpu_torch.data.loaders import build_multi_thermal_data
    from sunerf_tpu_torch.evaluation.image_render import render_observers

    device = torch.device(args.device)
    workdir = args.workdir or tempfile.mkdtemp(prefix='dt_ablation_')
    # distinct timestamps so that the loader's 5-min datetime join makes
    # one stack a view; 10 minutes are invisible to the band-limited time
    # encoding, so the scene stays effectively static
    observers = [{'name': 'aia', 'lat': 5.0 * ((i % 3) - 1), 'lon': i * 45.0,
                  'distance': 215.0,
                  'time': (datetime(2012, 8, 23)
                           + timedelta(minutes=10 * i)).isoformat()}
                 for i in range(8)]
    render_observers({
        'model': 'SimpleStar',
        'render_path': os.path.join(workdir, 'renders'),
        'render_format': ['fits'], 'resolution': args.resolution,
        'wavelengths': WAVELENGTHS, 'batch_size': 4096,
        'pixel_intensity_factor': 1e9, 'observers': observers}, device=device)
    data = build_multi_thermal_data(os.path.join(workdir, 'renders'),
                                    os.path.join(workdir, 'work'),
                                    batch_size=1024)

    configs = variant_specs()
    if args.configs:
        configs = [c for c in configs if c[0] in args.configs]
    summary = {}
    for cname, kwargs in configs:
        runs = [run_variant(f'{cname}_s{s}', data, workdir, args.steps,
                            seed=s, device=device, **kwargs) for s in args.seeds]
        psnrs = [r['val_psnr'] for r in runs]
        summary[cname] = {
            'rays_per_sec': round(float(np.median(
                [r['rays_per_sec'] for r in runs])), 1),
            'psnr_mean': round(float(np.mean(psnrs)), 2),
            'psnr_std': round(float(np.std(psnrs)), 2),
            'psnr_runs': [round(p, 2) for p in psnrs],
            'ssim_mean': round(float(np.mean(
                [r['val_ssim'] for r in runs])), 4),
        }
        print(json.dumps({cname: summary[cname]}), flush=True)
    out = {'dt_ablation': summary, 'seeds': args.seeds,
           'wavelengths': WAVELENGTHS, 'workdir': workdir}
    print(json.dumps(out))
    if args.out:
        with open(args.out, 'a') as fh:
            fh.write(json.dumps(out) + '\n')
    return out


if __name__ == '__main__':
    main()
