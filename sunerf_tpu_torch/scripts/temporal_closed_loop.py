"""Time-dependent closed loop at scale, on the port
(scripts/temporal_closed_loop.py of the JAX package).

Synthesizes an evolving MHD sequence (F frames of PSI-convention rho/T
cubes: a hydrostatic corona with a streamer whose amplitude grows and whose
longitude drifts), renders V views per trained timestamp through the MHD
field, trains the 4D emission SuNeRF (n_freqs_time=2) and scores:

  * spatial:   the held-out view at a trained timestamp (Trainer.validate)
  * temporal:  all V views at the F-1 unseen half-step times against the
               MHD ground truth rendered at those times (the field's linear
               frame interpolation defines it), asinh-scaled at the
               recipe's vmax and a, PSNR and SSIM (score_temporal)

--grid-size adds HexPlane-style VM tables (grid_rank, grid_time over the
[0, 1] training window, vm_encode_time) with the NGP optimizer recipe
(table lr x10, Adam eps 1e-15); VM levels have no kernel in either package,
so such a field runs the float32 field. Otherwise training runs the port's
Trainer on --device (K1 + K2 on the card) and scoring K0 through
ModelLoader. --platform is the JAX script's flag, taken as --device.

Usage: python -m sunerf_tpu_torch.scripts.temporal_closed_loop [--frames 6]
           [--views 10] [--steps 4000] [--resolution 128] [--device cuda]
Prints one JSON line (main returns it, with the launches by kernel name).
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import tempfile

import numpy as np


def synth_cubes(data_path: str, n_frames: int, drift: float = 0.5,
                amp_max: float = 4.0):
    """F frames of (rho, T): hydrostatic corona + evolving streamer.

    rho(r, th, ph, f) = 1e8 exp((1/r - 1)/0.1)
                        * (1 + a(f) * streamer(th, ph - ph0(f)))
    with amplitude a: 1.5 -> amp_max and streamer longitude drifting
    `drift` rad across the sequence; T = 1.5 MK (the DT head reads
    temp * 1e6). Written by data/psi_io.wrhdf_3d (numpy alone where h5py is
    absent)."""
    from sunerf_tpu_torch.data.psi_io import wrhdf_3d
    r = np.linspace(1.0, 1.3, 24)
    th = np.linspace(0.0, np.pi, 32)
    ph = np.linspace(0.0, 2 * np.pi, 64)
    R = r[None, None, :]
    TH = th[None, :, None]
    PH = ph[:, None, None]
    for f in range(n_frames):
        s = f / max(n_frames - 1, 1)
        a = 1.5 + (amp_max - 1.5) * s
        ph0 = 1.0 + drift * s
        dph = np.angle(np.exp(1j * (PH - ph0)))  # wrapped angular distance
        streamer = np.exp(-(dph ** 2) / 0.1 - ((TH - np.pi / 2) ** 2) / 0.05)
        rho = 1e8 * np.exp((1.0 / R - 1.0) / 0.1) * (1.0 + a * streamer)
        temp = np.full_like(rho, 1.5)
        for var, cube in (('rho', rho), ('t', temp)):
            d = os.path.join(data_path, var)
            os.makedirs(d, exist_ok=True)
            wrhdf_3d(os.path.join(d, f'{var}00{100 + f}.h5'),
                     r, th, ph, cube.astype(np.float32))


def view_list(n_views: int, times, name='aia'):
    obs = []
    for t in times:
        for i in range(n_views):
            obs.append({'name': name, 'lat': 6.0 * ((i % 3) - 1),
                        'lon': i * (360.0 / n_views), 'distance': 215.0,
                        'time': float(t)})
    return obs


def render_set(workdir, sub, data_path, observers, resolution, pif, device='cuda'):
    from sunerf_tpu_torch.evaluation.image_render import render_observers
    out = os.path.join(workdir, sub)
    render_observers({
        'model': 'MHDModel', 'data_path': data_path,
        'render_path': out, 'render_format': ['fits'],
        'resolution': resolution, 'wavelengths': [193],
        'batch_size': 8192, 'pixel_intensity_factor': pif,
        'observers': observers,
    }, device=device)
    return out


def score_temporal(renderer, params: dict, eval_dir: str, Rs_per_ds: float,
                   seconds_per_dt: float, ref_time, vmax: float, a: float,
                   device='cuda') -> tuple:
    """The scoring tail: each ground-truth FITS under eval_dir/aia/193 with
    its own geometry and normalized time, rendered without jitter in chunks
    of 8,192 rays, both images asinh-scaled at (vmax, a) -> (PSNRs, SSIMs)
    with data_range 1."""
    import torch

    from sunerf_tpu_torch.core.scaling import image_asinh_scaling, normalize_datetime
    from sunerf_tpu_torch.data.loaders import load_map_data
    from sunerf_tpu_torch.evaluation.loader import ModelLoader
    from sunerf_tpu_torch.train.metrics import psnr as psnr_fn, ssim as ssim_fn

    loader = ModelLoader(renderer, params, batch_size=8192, device=device)
    psnrs, ssims = [], []
    for path in sorted(glob.glob(os.path.join(eval_dir, 'aia', '193', '*.fits'))):
        m = load_map_data(path, Rs_per_ds=Rs_per_ds)
        t = normalize_datetime(m['time'], seconds_per_dt, ref_time)
        rays = m['all_rays'].astype(np.float32)
        pred = loader.render_rays(rays[:, 0], rays[:, 1], t, keys=('image',))['image'][:, 0]
        shape = m['image'].shape
        pred_s = image_asinh_scaling(torch.from_numpy(pred.reshape(shape)), vmax, a).numpy()
        targ_s = image_asinh_scaling(torch.from_numpy(np.asarray(m['image'], np.float32)),
                                     vmax, a).numpy()
        psnrs.append(psnr_fn(pred_s, targ_s, data_range=1.0))
        ssims.append(ssim_fn(pred_s, targ_s, data_range=1.0))
    return psnrs, ssims


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument('--frames', type=int, default=6)
    parser.add_argument('--drift', type=float, default=0.5,
                        help='streamer longitude drift (rad) across the '
                             'sequence; 0.5 = slow evolution, ~2.0 = the '
                             'fast-evolution dense-cadence case')
    parser.add_argument('--amp-max', type=float, default=4.0,
                        help='final streamer amplitude (starts at 1.5)')
    parser.add_argument('--views', type=int, default=10)
    parser.add_argument('--steps', type=int, default=4000)
    parser.add_argument('--resolution', type=int, default=128)
    parser.add_argument('--workdir', default=None)
    parser.add_argument('--grid-size', type=int, default=0)
    parser.add_argument('--grid-rank', type=int, default=16)
    parser.add_argument('--grid-time', type=int, default=8)
    parser.add_argument('--table-tv', type=float, default=0.0)
    parser.add_argument('--device', '--platform', dest='device', default='cuda',
                        help="'cuda' (the default, the card) or 'cpu'")
    parser.add_argument('--n-stratified', type=int, default=64)
    parser.add_argument('--n-hierarchical', type=int, default=128)
    args = parser.parse_args(argv)

    from sunerf_tpu_torch.data.fits import read_fits
    from sunerf_tpu_torch.data.loaders import build_single_channel_data
    from sunerf_tpu_torch.models.fields import emission_config
    from sunerf_tpu_torch.scripts.probe_step import launches_by_kernel, zero_counts
    from sunerf_tpu_torch.systems import make_emission_system
    from sunerf_tpu_torch.train.loop import Trainer, TrainerConfig
    from sunerf_tpu_torch.train.objective import LossConfig
    from sunerf_tpu_torch.train.optim import OptimConfig

    zero_counts()
    dev = args.device
    workdir = args.workdir or tempfile.mkdtemp(prefix='temporal_loop_')
    data_path = os.path.join(workdir, 'cubes')
    synth_cubes(data_path, args.frames, drift=args.drift, amp_max=args.amp_max)

    # calibrate pixel_intensity_factor so the brightest frame peaks ~3
    probe = render_set(workdir, 'probe', data_path, view_list(1, [1.0]), 64, 1.0, dev)
    img, _ = read_fits(sorted(glob.glob(os.path.join(probe, 'aia', '193', '*.fits')))[0])
    pif = 3.0 / max(float(np.percentile(img, 99.9)), 1e-30)

    F, V = args.frames, args.views
    train_times = [f / (F - 1) for f in range(F)]
    eval_times = [(f + 0.5) / (F - 1) for f in range(F - 1)]
    train_dir = render_set(workdir, 'train', data_path, view_list(V, train_times),
                           args.resolution, pif, dev)
    eval_dir = render_set(workdir, 'eval', data_path, view_list(V, eval_times),
                          args.resolution, pif, dev)

    data = build_single_channel_data(
        os.path.join(train_dir, 'aia', '193', '*.fits'),
        os.path.join(workdir, 'work'), batch_size=1024)

    grid_kwargs, optim_kwargs, tv = {}, {}, {}
    if args.grid_size and args.grid_time and args.frames < 8:
        print(f'WARNING: grid_time={args.grid_time} with only '
              f'{args.frames} frames: the temporal tables silently '
              'overfit sparse cadences (unseen-time error exploded 10x at '
              '4 frames in the JAX package\'s capacity sweep); prefer '
              '--grid-time 0 or more frames', file=sys.stderr)
    if args.grid_size:
        grid_kwargs = dict(grid_sizes=(args.grid_size,), grid_rank=args.grid_rank,
                           grid_time=args.grid_time, grid_time_range=(0.0, 1.0),
                           grid_bound=1.3)
        optim_kwargs = dict(table_lr_mult=10.0, adam_eps=1e-15)
        tv = dict(lambda_table_tv=args.table_tv) if args.table_tv else {}

    renderer, init = make_emission_system(
        model_config=emission_config(n_freqs_time=2, **grid_kwargs),
        n_stratified=args.n_stratified, n_hierarchical=args.n_hierarchical, device=dev)
    trainer = Trainer(
        renderer, init, data,
        loss_config=LossConfig(lambda_regularization=0.1, scaling_vmax=10.0, **tv),
        optim_config=OptimConfig(lr_start=1e-3, lr_floor=1e-3, **optim_kwargs),
        # k = 10: the observed collapse spike is ~200x while normal
        # batch-loss variance stays under ~3x
        spike_guard=10.0,
        trainer_config=TrainerConfig(total_steps=args.steps, val_every=args.steps,
                                     checkpoint_every=args.steps,
                                     log_every=max(args.steps // 10, 1),
                                     save_val_images=False),
        workdir=os.path.join(workdir, 'run'), device=dev)
    trainer.fit()
    with open(os.path.join(workdir, 'run', 'metrics.jsonl')) as fh:
        recs = [json.loads(line) for line in fh]
    spatial = [r for r in recs if 'val_psnr' in r][-1]
    rates = [r['rays_per_sec'] for r in recs if 'rays_per_sec' in r]

    t_psnrs, t_ssims = score_temporal(
        renderer, trainer.state.params, eval_dir, data.Rs_per_ds, data.seconds_per_dt,
        data.ref_time, trainer.loss_config.scaling_vmax, trainer.loss_config.scaling_a, dev)
    out = {
        'frames': F, 'views_per_time': V, 'steps': args.steps,
        'drift': args.drift, 'amp_max': args.amp_max,
        'budget': [args.n_stratified, args.n_hierarchical],
        **({'grid': {'size': args.grid_size, 'rank': args.grid_rank,
                     'time': args.grid_time, 'table_tv': args.table_tv}}
           if args.grid_size else {}),
        'rays_per_sec': float(np.median(rates[1:] or rates)),
        'spatial_val_psnr': round(spatial['val_psnr'], 2),
        'spatial_val_ssim': round(spatial['val_ssim'], 4),
        'temporal_psnr': round(float(np.mean(t_psnrs)), 2),
        'temporal_psnr_min': round(float(np.min(t_psnrs)), 2),
        'temporal_ssim': round(float(np.mean(t_ssims)), 4),
        'n_eval_views': len(t_psnrs),
        'workdir': workdir}
    print(json.dumps(out))
    out['launches'] = launches_by_kernel()
    return out


if __name__ == '__main__':
    main()
