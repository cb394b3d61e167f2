"""The occupancy grid's value case on the port
(scripts/occupancy_value_case.py of the JAX package): a scene with truly
empty space.

On SimpleStar and the psi streamer scene the learned emission never decays
enough off the shell for culling to engage. This scene is built for the
grid: a fast-decaying hydrostatic base (h0 = 0.02, empty beyond r ~ 1.08)
and one compact streamer blob reaching r = 1.3 in a narrow angular sector,
so most of the [1.0, 1.3] shell is empty and occupancy-guided sampling can
concentrate the budget where the scene is.

Protocol: {parity 64 + 128, plain 24 + 48, occ 24 + 48, occ 32 + 64, plain
16 + 32, occ 16 + 32} x seeds on the held-out view; the grid-health
fractions from metrics.jsonl show whether culling engaged. The cubes are
written by data/psi_io.wrhdf_3d, rendered through the MHDModel path,
prepped by data.prep.prep_file with the PSI norms; training runs the
port's Trainer on --device (occupancy_ablation.run_variant).

Usage: python -m sunerf_tpu_torch.scripts.occupancy_value_case [--steps 3000]
       [--seeds 7 8 9] [--device cuda]
Prints the summary as JSON (main returns it).
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import tempfile
from datetime import datetime

import numpy as np

from sunerf_tpu_torch.scripts.occupancy_ablation import run_variant


def synth_blob_cube(data_path: str):
    """Thin corona + one compact blob: truly empty space above r ~ 1.08
    except inside the blob sector."""
    from sunerf_tpu_torch.data.psi_io import wrhdf_3d
    r = np.linspace(1.0, 1.3, 32)
    th = np.linspace(0.0, np.pi, 32)
    ph = np.linspace(0.0, 2 * np.pi, 64)
    R, TH, PH = r[None, None, :], th[None, :, None], ph[:, None, None]
    base = np.exp((1.0 / R - 1.0) / 0.02)          # empty past r ~ 1.08
    blob = 4.0 * np.exp(-(np.angle(np.exp(1j * (PH - 1.2))) ** 2) / 0.04
                        - ((TH - np.pi / 2) ** 2) / 0.03
                        - ((R - 1.15) ** 2) / 0.008)
    rho = 1e8 * (base + blob)
    temp = np.full_like(rho, 1.5)
    for var, cube in (('rho', rho), ('t', temp)):
        d = os.path.join(data_path, var)
        os.makedirs(d, exist_ok=True)
        wrhdf_3d(os.path.join(d, f'{var}00100.h5'), r, th, ph,
                 cube.astype(np.float32))


def variant_specs(threshold: float, floor: float) -> list:
    """(name, render kwargs) of every variant, in the JAX script's order."""
    occ = {'enabled': True, 'warmup': 200, 'update_every': 16,
           'threshold': threshold, 'floor': floor}
    return [
        ('baseline_64_128', dict(n_stratified=64, n_hierarchical=128)),
        ('control_24_48', dict(n_stratified=24, n_hierarchical=48)),
        ('occ_24_48', dict(n_stratified=24, n_hierarchical=48, occupancy=occ)),
        ('occ_32_64', dict(n_stratified=32, n_hierarchical=64, occupancy=occ)),
        # 16 + 32, where the plain cut should hurt and occupancy-guided
        # placement rescue it
        ('control_16_32', dict(n_stratified=16, n_hierarchical=32)),
        ('occ_16_32', dict(n_stratified=16, n_hierarchical=32, occupancy=occ)),
    ]


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument('--steps', type=int, default=3000)
    parser.add_argument('--resolution', type=int, default=128)
    parser.add_argument('--seeds', type=int, nargs='+', default=[7, 8, 9])
    parser.add_argument('--threshold', type=float, default=0.01)
    parser.add_argument('--floor', type=float, default=0.05)
    parser.add_argument('--workdir', default=None)
    parser.add_argument('--out', default=None)
    parser.add_argument('--device', default='cuda',
                        help="'cuda' (the default, the card) or 'cpu'")
    args = parser.parse_args(argv)

    import torch

    from sunerf_tpu_torch.data.fits import read_fits
    from sunerf_tpu_torch.data.loaders import build_single_channel_data
    from sunerf_tpu_torch.data.norms import PSI_NORMS
    from sunerf_tpu_torch.data.prep import prep_file
    from sunerf_tpu_torch.evaluation.image_render import render_observers

    device = torch.device(args.device)
    workdir = args.workdir or tempfile.mkdtemp(prefix='occ_value_')
    cubes = os.path.join(workdir, 'cubes')
    synth_blob_cube(cubes)

    observers = [{'name': 'psi', 'lat': 5.0 * ((i % 3) - 1), 'lon': i * 45.0,
                  'distance': 215.0,
                  'time': datetime(2012, 8, 23).isoformat()}
                 for i in range(8)]

    probe_dir = os.path.join(workdir, 'probe')
    render_observers({'model': 'MHDModel', 'data_path': cubes,
                      'render_path': probe_dir, 'render_format': ['fits'],
                      'resolution': 64, 'wavelengths': [193],
                      'batch_size': 8192, 'pixel_intensity_factor': 1.0,
                      'observers': observers[:1]}, device=device)
    img, _ = read_fits(sorted(glob.glob(
        os.path.join(probe_dir, 'psi', '193', '*.fits')))[0])
    pif = 0.7 * PSI_NORMS[193] / max(float(np.percentile(img, 99.9)), 1e-30)

    render_observers({'model': 'MHDModel', 'data_path': cubes,
                      'render_path': os.path.join(workdir, 'renders'),
                      'render_format': ['fits'],
                      'resolution': args.resolution, 'wavelengths': [193],
                      'batch_size': 8192, 'pixel_intensity_factor': pif,
                      'observers': observers}, device=device)
    prep_dir = os.path.join(workdir, 'prep')
    for f in sorted(glob.glob(os.path.join(workdir, 'renders', 'psi', '193',
                                           '*.fits'))):
        prep_file(f, prep_dir, 'psi', resolution=args.resolution)
    data = build_single_channel_data(
        os.path.join(prep_dir, '*.fits'),
        os.path.join(workdir, 'work'), batch_size=1024)

    summary = {}
    for cname, kwargs in variant_specs(args.threshold, args.floor):
        runs = []
        for s in args.seeds:
            # spike_guard=None: this scene's inter-batch loss variance (dark
            # batches against blob batches) exceeds any workable trip factor
            r = run_variant(f'{cname}_s{s}', data, workdir, args.steps,
                            seed=s, spike_guard=None, device=device, **kwargs)
            # the grid-health fractions from the run's metrics tail (what
            # fraction of cells stayed occupied)
            with open(os.path.join(workdir, f'{cname}_s{s}',
                                   'metrics.jsonl')) as fh:
                recs = [json.loads(line) for line in fh]
            occ_fracs = [rec for rec in recs if 'occ_r_frac' in rec]
            if occ_fracs:
                r['occ_r_frac'] = occ_fracs[-1]['occ_r_frac']
                r['occ_ang_frac'] = occ_fracs[-1]['occ_ang_frac']
                if 'occ_vol_frac' in occ_fracs[-1]:
                    r['occ_vol_frac'] = occ_fracs[-1]['occ_vol_frac']
            runs.append(r)
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
        for k in ('occ_r_frac', 'occ_ang_frac', 'occ_vol_frac'):
            if k in runs[-1]:
                summary[cname][k] = round(float(np.mean(
                    [r[k] for r in runs if k in r])), 3)
        print(json.dumps({cname: summary[cname]}), flush=True)
    out = {'value_case': summary, 'seeds': args.seeds, 'workdir': workdir}
    print(json.dumps(out))
    if args.out:
        with open(args.out, 'a') as fh:
            fh.write(json.dumps(out) + '\n')
    return out


if __name__ == '__main__':
    main()
