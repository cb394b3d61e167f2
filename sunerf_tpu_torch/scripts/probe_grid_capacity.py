"""Field-fitting capacity A/B for grid-encoded small MLPs, on the port
(scripts/probe_grid_capacity.py of the JAX package).

Fits the psi_193 protocol's analytic emission structure (hydrostatic corona
+ two longitudinal streamers, scripts/psi_protocol.py synth_cubes) directly
as a regression target, with no renderer: do dense feature-grid levels let
a 4x128 MLP represent what the flagship 8x512 represents? Reports the last
batch's train MSE and the MSE on 16,384 fresh held-out points (the same
distribution: capacity and optimization, not view generalization).

Like the JAX script it fits the float32 field (models/fields.nerf_apply),
not the fused kernels, on --device. Adam as optax.adam computes it (torch's
Adam is the same update, eps outside the square root); --table-lr-mult puts
the grid tables in a parameter group of their own at lr x the multiplier
(optax.multi_transform's 'table' transform). The points come from torch
generators (seed 1 for the batches, 999 for the held-out set; JAX draws its
own), the init from seed 0.

Usage: python -m sunerf_tpu_torch.scripts.probe_grid_capacity [--steps 1500]
           [--batch 2048] [--only 4x128 ...] [--device cuda]
Prints one JSON line a config, then the whole result (main returns it).
"""
from __future__ import annotations

import argparse
import json
import math

import torch

CONFIGS = [
    ('4x128', dict(n_layers=4, d_filter=128)),
    ('2x128', dict(n_layers=2, d_filter=128)),
    ('4x128_g16_32', dict(n_layers=4, d_filter=128, grid_sizes=(16, 32), grid_features=8,
                          grid_bound=1.3)),
    ('2x128_g16_32', dict(n_layers=2, d_filter=128, grid_sizes=(16, 32), grid_features=8,
                          grid_bound=1.3)),
    ('4x128_g32', dict(n_layers=4, d_filter=128, grid_sizes=(32,), grid_features=8,
                       grid_bound=1.3)),
    ('6x384', dict(n_layers=6, d_filter=384)),
]


def _wrap(a: torch.Tensor) -> torch.Tensor:
    return torch.remainder(a + math.pi, 2 * math.pi) - math.pi


def _polar(pts: torch.Tensor) -> tuple:
    """(r, theta, phi in [0, 2 pi)) of [N, >= 3] points, float32."""
    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
    r = torch.sqrt(x * x + y * y + z * z)
    th = torch.arccos(torch.clamp(z / torch.clamp_min(r, 1e-6), -1, 1))
    ph = torch.remainder(torch.atan2(y, x), 2 * math.pi)
    return r, th, ph


def _log_emission(r: torch.Tensor, streamer: torch.Tensor) -> torch.Tensor:
    """2 log rho (emission ~ rho^2) inside the shell 1 <= r <= 1.3, -2
    outside."""
    rc = torch.clamp(r, 1.0, 1.3)
    log_rho = (1.0 / rc - 1.0) / 0.1 + torch.log1p(streamer)
    return torch.where((r >= 1.0) & (r <= 1.3), 2.0 * log_rho, torch.full_like(r, -2.0))


def target_field(pts: torch.Tensor) -> torch.Tensor:
    """log-emission-like target from the psi_protocol streamer formula."""
    r, th, ph = _polar(pts)
    streamer = (2.5 * torch.exp(-_wrap(ph - 1.0) ** 2 / 0.1 - (th - math.pi / 2) ** 2 / 0.05)
                + 1.5 * torch.exp(-_wrap(ph - 3.8) ** 2 / 0.2
                                  - (th - math.pi / 2) ** 2 / 0.08))
    return _log_emission(r, streamer)


def sample_points(gen: torch.Generator, n: int) -> torch.Tensor:
    """[n, 4] points uniform in [-1.3, 1.3]^3, t = 0."""
    p = torch.rand(n, 3, generator=gen, device=gen.device) * 2.6 - 1.3
    return torch.cat([p, torch.zeros(n, 1, device=gen.device)], dim=-1)


def make_adam(params: dict, lr: float, eps: float, table_lr_mult: float):
    """optax.adam (or its multi_transform with the 'grid_' tables at lr x
    table_lr_mult) as torch parameter groups."""
    tables = [v for k, v in params.items() if k.startswith('grid_')]
    mlp = [v for k, v in params.items() if not k.startswith('grid_')]
    groups = [{'params': mlp, 'lr': lr}]
    if tables:
        groups.append({'params': tables, 'lr': lr * table_lr_mult})
    return torch.optim.Adam(groups, betas=(0.9, 0.999), eps=eps)


def fit(config, sample, target, steps: int, lr: float, eps: float, table_lr_mult: float,
        device) -> tuple:
    """Fit the float32 field of `config` (init from seed 0) to target on
    sample(gen) batches (gen seeded 1) for `steps` Adam steps -> (params,
    the last batch's MSE, the MSE function)."""
    from sunerf_tpu_torch.models.fields import init_nerf, nerf_apply
    params = {k: v.requires_grad_() for k, v in
              init_nerf(torch.Generator(device=device).manual_seed(0), config, device).items()}
    adam = make_adam(params, lr, eps, table_lr_mult)

    def mse(pts, y):
        return torch.mean((nerf_apply(config, params, pts).raw[:, 0] - y) ** 2)

    gen = torch.Generator(device=device).manual_seed(1)
    last = None
    for _ in range(steps):
        pts = sample(gen)
        loss = mse(pts, target(pts))
        adam.zero_grad(set_to_none=True)
        loss.backward()
        adam.step()
        last = loss.detach()
    return params, last, mse


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument('--steps', type=int, default=1500)
    parser.add_argument('--batch', type=int, default=2048)
    parser.add_argument('--lr', type=float, default=1e-3)
    parser.add_argument('--table-lr-mult', type=float, default=1.0,
                        help='lr multiplier for grid tables (instant-NGP '
                             'trains tables at ~10x the MLP lr)')
    parser.add_argument('--adam-eps', type=float, default=1e-8,
                        help='Adam eps (NGP uses 1e-15: table cells see '
                             'sparse tiny gradients that default eps '
                             'strangles)')
    parser.add_argument('--only', nargs='+', default=None,
                        help='subset of config labels to run')
    parser.add_argument('--device', default='cuda',
                        help="'cuda' (the default, the card) or 'cpu' (the JAX "
                             "script's --cpu)")
    parser.add_argument('--out', default=None)
    args = parser.parse_args(argv)

    from sunerf_tpu_torch.models.fields import emission_config

    device = torch.device(args.device)
    val_pts = sample_points(torch.Generator(device=device).manual_seed(999), 16384)
    val_y = target_field(val_pts)
    out = {'steps': args.steps, 'batch': args.batch, 'lr': args.lr,
           'table_lr_mult': args.table_lr_mult, 'adam_eps': args.adam_eps}
    for label, kw in CONFIGS:
        if args.only and label not in args.only:
            continue
        config = emission_config(**kw)
        mult = args.table_lr_mult if config.grid_sizes else 1.0
        _, last, mse = fit(config, lambda g: sample_points(g, args.batch), target_field,
                           args.steps, args.lr, args.adam_eps, mult, device)
        with torch.no_grad():
            val_mse = float(mse(val_pts, val_y))
        out[label] = {'train_mse': round(float(last), 6), 'val_mse': round(val_mse, 6)}
        print(json.dumps({label: out[label]}), flush=True)

    print(json.dumps(out))
    if args.out:
        with open(args.out, 'w') as fh:
            fh.write(json.dumps(out) + '\n')
    return out


if __name__ == '__main__':
    main()
