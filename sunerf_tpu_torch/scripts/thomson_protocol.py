"""Quantitative Thomson-scattering row on the port (scripts/thomson_protocol.py
of the JAX package): accuracy and throughput of the white-light head.

1. Accuracy: a coronagraph view of an analytic hydrostatic electron-density
   corona rendered through the production sampling stack (64 stratified +
   128 hierarchical) by the port's Renderer and ThomsonHead, tB and pB
   scored against a float64 dense-midpoint quadrature of the same Howard &
   Tappin integrand (16,384 points a ray) over the same interval (the
   stratified sampler's [|o| - 1.3, the solar-surface clip]). The oracle
   shares the physics formulas; what it checks is the discretization:
   stratified and inverse-CDF sampling, the rectangular quadrature, float32
   arithmetic on the device.

2. Throughput: the training step of make_thomson_system at 8x512 for both
   passes, batch 1024, Adam (K1 + K2 on the card, 2 + 2 launches a step),
   timed by CUDA events (utils/profiling.timeit; the host clock on --device
   cpu, a CPU number).

Usage: python -m sunerf_tpu_torch.scripts.thomson_protocol
       [--resolution 64] [--distance 215] [--out THOMSON.json] [--device cuda]
Writes the JSON where --out says (main returns it).
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from sunerf_tpu_torch.core.geometry import observer_rays
from sunerf_tpu_torch.models.fields import FieldOutput
from sunerf_tpu_torch.rendering.renderer import Renderer
from sunerf_tpu_torch.rendering.thomson import ThomsonHead
from sunerf_tpu_torch.scripts.probe_step import launches_by_kernel, zero_counts
from sunerf_tpu_torch.systems import make_thomson_system
from sunerf_tpu_torch.train.objective import LossConfig
from sunerf_tpu_torch.train.optim import make_optimizer
from sunerf_tpu_torch.train.step import create_train_state, make_train_step
from sunerf_tpu_torch.utils.profiling import timeit

RHO0_LOG10 = 8.0   # n_e(1 Rs) = 1e8 cm^-3
SCALE_H = 0.2      # hydrostatic scale height (Rs)
U_LIMB = 0.63      # limb-darkening constant (Howard & Tappin 2009)
N_QUAD = 16384     # the oracle's midpoints a ray


def log10_ne(r):
    """Analytic hydrostatic corona: n_e = 1e8 * exp((1/r - 1)/h)."""
    return RHO0_LOG10 + ((1.0 / np.maximum(r, 0.5) - 1.0) / SCALE_H) \
        / np.log(10.0)


def oracle_tb_pb(rays_o, rays_d, n_quad=N_QUAD, solar_radius=1.0,
                 shell=1.3):
    """Float64 dense-midpoint quadrature of the Howard & Tappin integrand.

    The integration interval mirrors the production stratified sampler
    (core/sampling.py stratified_sample): near = |o| - shell; far = the
    solar-surface intersection where the ray hits the Sun, else |o| + shell.
    """
    o = np.asarray(rays_o, np.float64)
    d = np.asarray(rays_d, np.float64)
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)

    obs_dist = np.linalg.norm(o, axis=-1)
    b = 2.0 * np.sum(o * d, axis=-1)
    c = np.sum(o * o, axis=-1) - solar_radius ** 2
    disc = b * b - 4.0 * c
    hit = disc >= 0.0
    t_inner = (-b - np.sqrt(np.maximum(disc, 0.0))) / 2.0
    near = obs_dist - shell
    far = np.where(hit, t_inner, obs_dist + shell)

    # midpoint rule, [R, n_quad]
    tq = (np.arange(n_quad, dtype=np.float64) + 0.5) / n_quad
    z = near[:, None] + (far - near)[:, None] * tq[None, :]
    dz = ((far - near) / n_quad)[:, None]
    pts = o[:, None, :] + d[:, None, :] * z[..., None]
    r = np.linalg.norm(pts, axis=-1)
    ne = 10.0 ** log10_ne(r)

    sinw = np.clip(solar_radius / np.maximum(r, 1e-6), 0.0, 1.0 - 1e-6)
    cosw = np.sqrt(1.0 - sinw ** 2)
    ln = np.log((1.0 + sinw) / cosw)
    cos2_sin = cosw ** 2 / sinw
    A = cosw * sinw ** 2
    B = -(1.0 / 8.0) * (1.0 - 3.0 * sinw ** 2
                        - cos2_sin * (1.0 + 3.0 * sinw ** 2) * ln)
    C = 4.0 / 3.0 - cosw - cosw ** 3 / 3.0
    D = (1.0 / 8.0) * (5.0 + sinw ** 2
                       - cos2_sin * (5.0 - sinw ** 2) * ln)

    # sin^2(chi) = |o x d|^2 / r^2 (impact parameter over point radius)
    cross = np.cross(o, d)
    sin_chi2 = np.sum(cross * cross, axis=-1)[:, None] / r ** 2

    i_pb = sin_chi2 * ((1.0 - U_LIMB) * A + U_LIMB * B)
    i_tb = 2.0 * ((1.0 - U_LIMB) * C + U_LIMB * D) - i_pb
    tb = np.sum(ne * i_tb * dz, axis=-1)
    pb = np.sum(ne * i_pb * dz, axis=-1)
    return tb, pb


def analytic_apply(params, pts):
    """The analytic corona as a field: raw = (log10 n_e, 0)."""
    r = torch.linalg.norm(pts[:, :3], dim=-1)
    log_ne = RHO0_LOG10 + ((1.0 / torch.clamp(r, min=0.5) - 1.0)
                           / SCALE_H) / float(np.log(10.0))
    return FieldOutput(raw=torch.stack([log_ne, torch.zeros_like(log_ne)], -1))


def render_tb_pb(resolution: int, distance: float, device) -> tuple:
    """(tB, pB, rays_o, rays_d) of the analytic corona at the protocol's
    observer (lat 0.3, lon 1.1 rad), float64 on the host, rendered at 64 +
    128 samples without jitter on `device`."""
    renderer = Renderer(field_apply=analytic_apply, head=ThomsonHead(),
                        n_stratified=64, n_hierarchical=128, perturb=False)
    o, d = observer_rays(lat=0.3, lon=1.1, distance=distance, resolution=resolution)
    o, d = np.asarray(o).reshape(-1, 3), np.asarray(d).reshape(-1, 3)
    up = lambda a: torch.as_tensor(a, dtype=torch.float32).to(device)  # noqa: E731
    with torch.no_grad():
        img = renderer({'coarse': {}, 'fine': {}}, up(o), up(d),
                       torch.zeros((o.shape[0], 1), device=device))['image']
    img = img.cpu().numpy().astype(np.float64)
    return img[:, 0], img[:, 1], o, d


def score(pred, ref) -> dict:
    mae_pct = float(np.mean(np.abs(pred - ref)) / np.mean(ref) * 100.0)
    rng = float(ref.max() - ref.min())
    psnr = float(10.0 * np.log10(rng ** 2 / max(np.mean((pred - ref) ** 2), 1e-300)))
    return {'mae_percent_of_mean': round(mae_pct, 4), 'psnr_db': round(psnr, 2)}


def step_throughput(device, batch_size: int = 1024, reps: int = 10,
                    model_config=None) -> dict:
    """ms and rays/s of make_thomson_system's training step (raw
    intensities, no regularization, Adam), and the kernel launches of one
    step; weights from torch.Generator seed 0, the batch from numpy seed 1."""
    renderer, init = make_thomson_system(model_config=model_config, device=device)
    params = init(torch.Generator().manual_seed(0))
    optimizer = make_optimizer()
    step = make_train_step(renderer, LossConfig(image_scaling='none',
                                                lambda_regularization=0.0),
                           optimizer)
    state = create_train_state(params, optimizer)
    rng = np.random.default_rng(1)
    bo = np.tile(np.array([[4.0, 0.0, 0.0]], np.float32), (batch_size, 1))
    dirs = np.array([[-1.0, 0.0, 0.0]]) + 0.15 * rng.normal(size=(batch_size, 3))
    bd = (dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)).astype(np.float32)
    batch = {'rays': torch.from_numpy(np.stack([bo, bd], 1)).to(device),
             'time': torch.zeros((batch_size, 1), device=device),
             'target_image': torch.full((batch_size, 2), 0.05, device=device)}
    step(state, batch, 1)                          # warm-up: kernels built
    if device.type == 'cuda':
        torch.cuda.synchronize(device)
    zero_counts()
    _, metrics = step(state, batch, 1)
    launches = launches_by_kernel()
    ms = timeit(step, state, batch, 1, device=device, reps=reps)
    return {'ms_per_step': ms, 'rays_per_sec': batch_size / ms * 1e3,
            'launches_per_step': launches, 'loss': float(metrics['loss']),
            'batch': batch_size}


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument('--resolution', type=int, default=64)
    parser.add_argument('--distance', type=float, default=215.0,
                        help='observer distance [Rs] (1 AU)')
    parser.add_argument('--out', default=None, help='write the JSON here')
    parser.add_argument('--skip-throughput', action='store_true',
                        help='accuracy only')
    parser.add_argument('--device', default='cuda',
                        help="'cuda' (the default, the card) or 'cpu'")
    args = parser.parse_args(argv)
    device = torch.device(args.device)

    # ---- accuracy: the production sampling stack vs the float64 oracle ----
    tb_r, pb_r, o, d = render_tb_pb(args.resolution, args.distance, device)
    tb_o, pb_o = oracle_tb_pb(o, d)

    # physicality on the oracle and the renderer
    assert np.all(tb_o >= 0) and np.all(pb_o >= 0)
    assert np.all(pb_o <= tb_o * (1 + 1e-9)), 'pB must not exceed tB'
    assert np.all(np.isfinite(tb_r)) and np.all(np.isfinite(pb_r))

    out = {
        'scene': {'field': 'hydrostatic n_e=1e8*exp((1/r-1)/0.2)',
                  'observer': {'lat': 0.3, 'lon': 1.1,
                               'distance_rs': args.distance},
                  'resolution': args.resolution},
        'sampling': {'n_stratified': 64, 'n_hierarchical': 128},
        'oracle': {'quadrature': 'float64 midpoint', 'n_points': N_QUAD},
        'tB': score(tb_r, tb_o),
        'pB': score(pb_r, pb_o),
        'pb_over_tb_max': round(float(np.max(pb_o / np.maximum(tb_o, 1e-300))), 4),
    }

    # ---- throughput: the training step at the reference workload ----
    if not args.skip_throughput:
        t = step_throughput(device)
        out['train_rays_per_sec_per_chip'] = round(t['rays_per_sec'], 1)
        out['platform'] = 'gpu' if device.type == 'cuda' else 'cpu'
        out['train_ms_per_step'] = t['ms_per_step']
        out['train_launches_per_step'] = t['launches_per_step']
        out['timing'] = ('CUDA events, 3 batches of 10 steps, the median'
                         if device.type == 'cuda' else 'host clock (CPU)')
        out['device'] = (torch.cuda.get_device_name(device) if device.type == 'cuda'
                         else 'cpu')

    print(json.dumps(out, indent=2))
    if args.out:
        with open(args.out, 'w') as fh:
            json.dump(out, fh, indent=2)
    return out


if __name__ == '__main__':
    main()
