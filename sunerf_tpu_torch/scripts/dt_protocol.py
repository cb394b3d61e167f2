"""End-to-end DT-head PSI protocol on the port (scripts/dt_protocol.py of
the JAX package): the emission psi_193 protocol's multi-channel sibling.

Synthetic MHD cubes with spatially structured temperature (quiet corona
1.0 MK, streamers up to 2.5 MK; --hot-blob adds a 6 MK active-region core
for the 94 / 131 A channels) -> MHDModel renders of every channel at 18
viewpoints (14 ecliptic + 4 high-latitude) -> the multi-thermal loader (the
5-min datetime join, union-lambda masks; --mask-exercise routes the odd
ecliptic views into a second source 'aia_b' without the first two
channels) on the ecliptic views only -> DT SuNeRF (raw intensities, pif
1e17) -> the metrics harness over every view-channel frame with the
|lat| > 7 deg train / test split.

The cubes are written by data/psi_io.wrhdf_3d (numpy alone where h5py is
absent), rendered through evaluation.image_render's MHDModel path on
--device; training runs the port's Trainer (K1 + K2 on the card, 2 + 2
launches a step) and scoring the harness through SuNeRFLoader (K0).

Usage: python -m sunerf_tpu_torch.scripts.dt_protocol [--steps 4000]
       [--n-stratified 64] [--n-hierarchical 128] [--proposal-coarse]
       [--resolution 128] [--wavelengths 94 131 171 193 211] [--hot-blob]
       [--mask-exercise] [--keep-best] [--device cuda]
Prints one JSON line (main returns it); --out appends it to a file.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import tempfile
from datetime import datetime, timedelta

import numpy as np

WAVELENGTHS = [171, 193, 211]
N_ECLIPTIC = 14  # observers [0, N_ECLIPTIC) form the training band
BATCH_SIZE = 1024


def synth_cubes(data_path: str, hot_blob: bool = False):
    """Static MHD frame: hydrostatic corona + two streamers, the streamers
    hotter than the quiet corona, so each channel sees its own structure
    through the temperature response. hot_blob adds a compact dense 6 MK
    core (lon 5.2, lat +20 deg, r < 1.08) that gives the hot-peaked 94 and
    131 A channels structure of their own."""
    from sunerf_tpu_torch.data.psi_io import wrhdf_3d
    r = np.linspace(1.0, 1.3, 24)
    th = np.linspace(0.0, np.pi, 32)
    ph = np.linspace(0.0, 2 * np.pi, 64)
    R, TH, PH = r[None, None, :], th[None, :, None], ph[:, None, None]
    s1 = np.exp(-(np.angle(np.exp(1j * (PH - 1.0))) ** 2) / 0.1
                - ((TH - np.pi / 2) ** 2) / 0.05)
    s2 = np.exp(-(np.angle(np.exp(1j * (PH - 3.8))) ** 2) / 0.2
                - ((TH - np.pi / 2) ** 2) / 0.08)
    streamer = 2.5 * s1 + 1.5 * s2
    rho = 1e8 * np.exp((1.0 / R - 1.0) / 0.1) * (1.0 + streamer)
    # temperature in MK (the MHD field reads log10(1e6 T)): 1.0 MK quiet
    # corona to 2.5 MK streamer cores spans the 171, 193 and 211 peaks
    snorm = np.clip((2.5 * s1 + 1.5 * s2) / 2.5, 0.0, 1.0)
    temp = (1.0 + 1.5 * snorm) * np.ones_like(rho)
    if hot_blob:
        blob = np.exp(-(np.angle(np.exp(1j * (PH - 5.2))) ** 2) / 0.03
                      - ((TH - (np.pi / 2 - 0.35)) ** 2) / 0.02
                      - ((R - 1.0) ** 2) / 0.003)
        rho = rho * (1.0 + 3.0 * blob)
        temp = temp + 4.5 * blob
    for var, cube in (('rho', rho), ('t', temp)):
        d = os.path.join(data_path, var)
        os.makedirs(d, exist_ok=True)
        wrhdf_3d(os.path.join(d, f'{var}00100.h5'), r, th, ph,
                 cube.astype(np.float32))


def make_observers() -> list:
    """18 viewpoints, 10 minutes apart (invisible to the band-limited
    n_freqs_time=2 encoding; the loader's 5-min datetime join then makes
    one lambda-stack of each view)."""
    t0 = datetime(2012, 8, 23)
    obs = [{'name': 'aia', 'lat': 6.0 * ((i % 3) - 1) / 1.5,
            'lon': i * (360.0 / 14), 'distance': 215.0,
            'time': (t0 + timedelta(minutes=10 * i)).isoformat()}
           for i in range(N_ECLIPTIC)]
    obs += [{'name': 'aia', 'lat': lat, 'lon': lon, 'distance': 215.0,
             'time': (t0 + timedelta(minutes=10 * (N_ECLIPTIC + j))).isoformat()}
            for j, (lat, lon) in enumerate(((-50.0, 30.0), (-25.0, 120.0),
                                            (25.0, 210.0), (50.0, 300.0)))]
    return obs


def ensure_scene(data_dir: str, resolution: int, wavelengths: list,
                 hot_blob: bool = False, mask_exercise: bool = False,
                 device='cuda') -> tuple:
    """Synthesize (or reuse) the protocol's scene in data_dir, rendering
    on `device`: the cubes, a 64^2 probe that sets the pixel intensity
    factor (the brightest channel's 99.9th percentile at 0.7), every
    channel at the 18 views (renders/aia/<wl>/), and the ecliptic training
    tree (train/<source>/<wl>/). Returns (train_dir, raw_dir)."""
    from sunerf_tpu_torch.data.fits import read_fits
    from sunerf_tpu_torch.evaluation.image_render import render_observers

    marker = os.path.join(data_dir, '.scene_complete')
    raw_dir = os.path.join(data_dir, 'renders')
    train_dir = os.path.join(data_dir, 'train')
    if os.path.exists(marker):
        print(f'reusing cached scene in {data_dir}')
        return train_dir, raw_dir

    cubes = os.path.join(data_dir, 'cubes')
    synth_cubes(cubes, hot_blob=hot_blob)
    observers = make_observers()

    # the metrics' asinh scale wants the brightest channel near 0.7; the
    # training pif stays 1e17 (the DT head's liftoff constant)
    probe_dir = os.path.join(data_dir, 'probe')
    render_observers({'model': 'MHDModel', 'data_path': cubes,
                      'render_path': probe_dir, 'render_format': ['fits'],
                      'resolution': 64, 'wavelengths': wavelengths,
                      'batch_size': 8192, 'pixel_intensity_factor': 1.0,
                      'observers': observers[:1]}, device=device)
    peak = max(float(np.percentile(read_fits(f)[0], 99.9))
               for f in glob.glob(os.path.join(probe_dir, 'aia', '*', '*.fits')))
    pif = 0.7 / max(peak, 1e-30)

    render_observers({'model': 'MHDModel', 'data_path': cubes,
                      'render_path': raw_dir, 'render_format': ['fits'],
                      'resolution': resolution, 'wavelengths': wavelengths,
                      'batch_size': 8192, 'pixel_intensity_factor': pif,
                      'observers': observers}, device=device)

    # the ecliptic band by observer index (the file name carries it); with
    # mask_exercise the odd views form a second source without the first
    # two channels (the loader's union-lambda masks)
    dropped = set(str(w) for w in wavelengths[:2]) if mask_exercise else set()
    n_train = 0
    frames = sorted(glob.glob(os.path.join(raw_dir, 'aia', '*', '*.fits')))
    for f in frames:
        idx = int(os.path.basename(f).split('_')[1].split('.')[0])
        if idx >= N_ECLIPTIC:
            continue
        wl_dir = os.path.basename(os.path.dirname(f))
        source = 'aia'
        if mask_exercise and idx % 2 == 1:
            if wl_dir in dropped:
                continue
            source = 'aia_b'
        dst = os.path.join(train_dir, source, wl_dir)
        os.makedirs(dst, exist_ok=True)
        shutil.copy(f, dst)
        n_train += 1
    print(f'prep: {n_train} train frames (ecliptic), {len(frames)} ground truth')
    with open(marker, 'w') as fh:
        fh.write('ok')
    return train_dir, raw_dir


def gt_files(raw_dir: str) -> list:
    """Every view-channel frame of the scene, sorted (the harness's files)."""
    return sorted(glob.glob(os.path.join(raw_dir, 'aia', '*', '*.fits')))


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument('--steps', type=int, default=4000)
    parser.add_argument('--resolution', type=int, default=128)
    parser.add_argument('--n-stratified', type=int, default=64)
    parser.add_argument('--n-hierarchical', type=int, default=128)
    parser.add_argument('--proposal-coarse', action='store_true')
    parser.add_argument('--coarse-layers', type=int, default=4)
    parser.add_argument('--coarse-filter', type=int, default=128)
    parser.add_argument('--tier-fraction', type=float, default=0.0)
    parser.add_argument('--tier-samples', type=int, default=16)
    parser.add_argument('--tier-warmup-steps', type=int, default=0,
                        help='train the first N steps at the full fine '
                             'budget before enabling the tiers (the DT '
                             'head collapses when the dim tier samples '
                             'from an untrained coarse CDF)')
    parser.add_argument('--model-layers', type=int, default=8)
    parser.add_argument('--model-filter', type=int, default=512)
    parser.add_argument('--keep-best', action='store_true',
                        help='validate at steps//8 and score the best '
                             'held-out checkpoint (save_state_best)')
    parser.add_argument('--wavelengths', type=int, nargs='+',
                        default=WAVELENGTHS,
                        help='AIA channels to synthesize and train on '
                             '(the production protocol: 94 131 171 193 211)')
    parser.add_argument('--hot-blob', action='store_true',
                        help='add a compact 6 MK active-region core to the '
                             'scene so the hot-peaked 94/131 channels have '
                             'structure of their own (see synth_cubes)')
    parser.add_argument('--mask-exercise', action='store_true',
                        help='route the odd-index ecliptic views into a '
                             'second instrument source missing the first '
                             'two --wavelengths channels, exercising the '
                             'union-lambda masks the multi-thermal loader '
                             'pads per source')
    parser.add_argument('--device', default='cuda',
                        help="'cuda' (the default, the card) or 'cpu'")
    parser.add_argument('--seed', type=int, default=7)
    parser.add_argument('--workdir', default=None)
    parser.add_argument('--out', default=None)
    parser.add_argument('--data-cache', default=None,
                        help='shared directory for the synthesized scene')
    return parser


def row_config(args) -> dict:
    """The row's config for parsed arguments: the matrix scripts' resume
    signature (a key absent at its default keeps older rows' signatures)."""
    wavelengths = list(args.wavelengths)
    config = {'head': 'density_temperature',
              'wavelengths': wavelengths,
              'n_stratified': args.n_stratified,
              'n_hierarchical': args.n_hierarchical,
              'proposal_coarse': args.proposal_coarse,
              'coarse_shape': ([args.coarse_layers, args.coarse_filter]
                               if args.proposal_coarse else None),
              'steps': args.steps,
              'tier_fraction': args.tier_fraction,
              'tier_samples': args.tier_samples,
              'seed': args.seed}
    if (args.model_layers, args.model_filter) != (8, 512):
        config['model_shape'] = [args.model_layers, args.model_filter]
    if args.tier_warmup_steps:
        config['tier_warmup_steps'] = args.tier_warmup_steps
    if args.resolution != 128:
        # key absent at the mini-protocol default (as psi_protocol's)
        config['resolution'] = args.resolution
    if args.hot_blob:
        # scene-changing: a signature key (absent for the 3-channel scene)
        config['hot_blob'] = True
    if args.mask_exercise:
        # data-layout-changing: a signature key naming the channels the
        # second source lacks
        config['mask_exercise'] = {'dropped_from_odd_views': wavelengths[:2]}
    if args.keep_best:
        config['keep_best'] = True
    return config


def build_system(args, device) -> tuple:
    """The protocol's DT system for parsed arguments: (renderer, init, the
    fine field's NeRFConfig, the training loss's LossConfig)."""
    from sunerf_tpu_torch.models.fields import density_temperature_config
    from sunerf_tpu_torch.systems import make_density_temperature_system
    from sunerf_tpu_torch.train.objective import LossConfig

    model = density_temperature_config(n_layers=args.model_layers,
                                       d_filter=args.model_filter,
                                       n_freqs_time=2)
    coarse = (density_temperature_config(n_layers=args.coarse_layers,
                                         d_filter=args.coarse_filter,
                                         n_freqs_time=2)
              if args.proposal_coarse else None)
    renderer, init = make_density_temperature_system(
        pixel_intensity_factor=1e17, model_config=model,
        coarse_config=coarse, n_stratified=args.n_stratified,
        n_hierarchical=args.n_hierarchical,
        tier_fraction=args.tier_fraction, tier_samples=args.tier_samples,
        device=device)
    # raw multi-thermal intensities
    loss_config = LossConfig(image_scaling='none', lambda_regularization=0.0)
    return renderer, init, model, loss_config


def main(argv=None) -> dict:
    parser = build_parser()
    args = parser.parse_args(argv)

    wavelengths = list(args.wavelengths)
    if args.mask_exercise and len(wavelengths) < 4:
        parser.error('--mask-exercise needs >= 4 --wavelengths (the second '
                     'source drops the first two)')

    import torch

    from sunerf_tpu_torch.data.loaders import build_multi_thermal_data
    from sunerf_tpu_torch.evaluation.loader import SuNeRFLoader
    from sunerf_tpu_torch.evaluation.metrics_harness import evaluate_viewpoints
    from sunerf_tpu_torch.train.loop import Trainer, TrainerConfig
    from sunerf_tpu_torch.train.optim import OptimConfig
    from sunerf_tpu_torch.utils.throughput import effective_rate

    device = torch.device(args.device)
    workdir = args.workdir or tempfile.mkdtemp(prefix='dt_protocol_')
    data_dir = args.data_cache or workdir
    train_dir, raw_dir = ensure_scene(data_dir, args.resolution, wavelengths,
                                      hot_blob=args.hot_blob,
                                      mask_exercise=args.mask_exercise,
                                      device=device)

    data = build_multi_thermal_data(train_dir, os.path.join(workdir, 'work'),
                                    batch_size=BATCH_SIZE)

    renderer, init, _, loss_config = build_system(args, device)

    run_dir = os.path.join(workdir, 'run')
    trainer = Trainer(
        renderer, init, data,
        # no spike guard: the ordinary inter-batch variance of raw
        # intensities trips it
        loss_config=loss_config,
        optim_config=OptimConfig(lr_start=1e-3, lr_end=1e-4,
                                 lr_iterations=args.steps, lr_floor=1e-4),
        spike_guard=None,
        trainer_config=TrainerConfig(
            tier_warmup_steps=args.tier_warmup_steps,
            total_steps=args.steps,
            val_every=(max(args.steps // 8, 1) if args.keep_best
                       else args.steps),
            keep_best=args.keep_best, checkpoint_every=args.steps,
            log_every=max(args.steps // 10, 1),
            # the ground-truth-free high-latitude drift probe
            # (train/probe.py), summarized into the row (highlat_probe)
            drift_probe_views=4,
            save_val_images=False, seed=args.seed),
        workdir=run_dir, device=device)
    trainer.fit()

    with open(os.path.join(run_dir, 'metrics.jsonl')) as fh:
        recs = [json.loads(line) for line in fh]
    samples = sorted((r['step'], r['rays_per_sec'])
                     for r in recs if 'rays_per_sec' in r)
    rates = [r for _, r in samples]
    rate = float(np.median(rates[1:] or rates))

    bundle = os.path.join(run_dir, 'save_state.npz')
    if args.keep_best:
        best = os.path.join(run_dir, 'save_state_best.npz')
        if os.path.exists(best):
            bundle = best
    loader = SuNeRFLoader(bundle, device=device)
    metrics = evaluate_viewpoints(loader, gt_files(raw_dir))
    out = {'config': row_config(args),
           'rays_per_sec': round(rate, 1),
           'effective_rays_per_sec': effective_rate(samples),
           'train': metrics['train'], 'test': metrics['test'],
           'workdir': workdir}
    if args.keep_best:
        out['scored_bundle'] = os.path.basename(bundle)
    stab = [round(r['probe_stability_db'], 2) for r in recs
            if 'probe_stability_db' in r]
    drift = [round(r['probe_drift_since_best_db'], 2) for r in recs
             if 'probe_drift_since_best_db' in r]
    if stab or drift:
        # observational (render-only; not a signature key)
        out['highlat_probe'] = {
            'stability_db': stab,
            'drift_since_best_db': drift,
            'warnings': int(sum(1 for r in recs
                                if r.get('probe_drift_warning')))}
    print(json.dumps(out))
    if args.out:
        with open(args.out, 'a') as fh:
            fh.write(json.dumps(out) + '\n')
    return out


if __name__ == '__main__':
    main()
