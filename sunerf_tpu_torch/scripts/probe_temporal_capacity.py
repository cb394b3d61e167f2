"""4-D (time) field-fitting capacity A/B for the temporal grid, on the port
(scripts/probe_temporal_capacity.py of the JAX package).

Fits a time-evolving emission structure (the temporal_closed_loop scene:
streamer amplitude growth and longitude drift) by direct regression, no
renderer, with the training times restricted to F discrete frames, and
scores:

  * val_trained_t: held-out points at the trained frame times (capacity)
  * val_unseen_t:  held-out points at the F-1 half-step times (temporal
                   interpolation, the closed loop's generalization axis)

Configs: posenc only (n_freqs_time=2), + static VM tables (grid_rank: time
through the posenc alone), + HexPlane temporal VM tables (grid_time;
ops/grid_encoding.py vm_encode_time). Every config takes the NGP recipe
(Adam eps 1e-15, the tables at 10x the lr in their own parameter group,
optax's multi_transform). The float32 field (models/fields.nerf_apply) on
--device, as the JAX script fits it; the points from torch generators
(probe_grid_capacity.fit: batches seed 1; held-out 999 and 998).

Usage: python -m sunerf_tpu_torch.scripts.probe_temporal_capacity
           [--steps 2000] [--batch 2048] [--frames 6] [--device cuda]
Prints one JSON line a config, then the whole result (main returns it).
"""
from __future__ import annotations

import argparse
import json
import math

import numpy as np
import torch

from sunerf_tpu_torch.scripts.probe_grid_capacity import _log_emission, _polar, _wrap, fit

CONFIGS = [
    ('posenc_t2', dict(n_layers=4, d_filter=128, n_freqs_time=2)),
    ('vm_static', dict(n_layers=4, d_filter=128, n_freqs_time=2, grid_sizes=(32,),
                       grid_rank=16, grid_bound=1.3)),
    ('vm_time', dict(n_layers=4, d_filter=128, n_freqs_time=2, grid_sizes=(32,),
                     grid_rank=16, grid_time=8, grid_time_range=(0.0, 1.0), grid_bound=1.3)),
]


def target_field_t(pts: torch.Tensor, drift: float = 0.5, amp_cycles: float = 0.0):
    """Time-evolving log-emission target: amplitude 1.5 -> 4.0 (optionally
    oscillating amp_cycles times), longitude drifting `drift` rad across t
    in [0, 1] (drift 0.5 = temporal_closed_loop's synth_cubes)."""
    r, th, ph = _polar(pts)
    t = pts[:, 3]
    a = 1.5 + 2.5 * t
    if amp_cycles:
        a = a * (1.0 + 0.5 * torch.sin(2 * math.pi * amp_cycles * t))
    ph0 = 1.0 + drift * t
    streamer = a * torch.exp(-_wrap(ph - ph0) ** 2 / 0.1 - (th - math.pi / 2) ** 2 / 0.05)
    return _log_emission(r, streamer)


def sample_points(gen: torch.Generator, n: int, times: torch.Tensor) -> torch.Tensor:
    """[n, 4] points with t drawn uniformly from the given frame times."""
    p = torch.rand(n, 3, generator=gen, device=gen.device) * 2.6 - 1.3
    idx = torch.randint(0, len(times), (n, 1), generator=gen, device=gen.device)
    return torch.cat([p, times[idx]], dim=-1)


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument('--steps', type=int, default=2000)
    parser.add_argument('--batch', type=int, default=2048)
    parser.add_argument('--frames', type=int, default=6,
                        help='number of discrete training times (>= 2)')
    parser.add_argument('--lr', type=float, default=1e-3)
    parser.add_argument('--drift', type=float, default=0.5,
                        help='streamer longitude drift [rad] over t in [0,1]')
    parser.add_argument('--amp-cycles', type=float, default=0.0,
                        help='amplitude oscillation cycles over [0,1]')
    parser.add_argument('--only', nargs='+', default=None)
    parser.add_argument('--device', default='cuda',
                        help="'cuda' (the default, the card) or 'cpu'")
    parser.add_argument('--out', default=None)
    args = parser.parse_args(argv)

    from sunerf_tpu_torch.models.fields import emission_config

    F = args.frames
    if F < 2:
        parser.error('--frames must be >= 2 (half-step eval needs a gap)')
    device = torch.device(args.device)
    train_times = torch.tensor(np.asarray([f / (F - 1) for f in range(F)], np.float32),
                               device=device)
    unseen_times = torch.tensor(np.asarray([(f + 0.5) / (F - 1) for f in range(F - 1)],
                                           np.float32), device=device)

    def target(pts):
        return target_field_t(pts, drift=args.drift, amp_cycles=args.amp_cycles)

    def gen(seed):
        return torch.Generator(device=device).manual_seed(seed)
    val_seen = sample_points(gen(999), 16384, train_times)
    val_unseen = sample_points(gen(998), 16384, unseen_times)
    y_seen, y_unseen = target(val_seen), target(val_unseen)

    out = {'steps': args.steps, 'batch': args.batch, 'frames': F,
           'lr': args.lr, 'drift': args.drift, 'amp_cycles': args.amp_cycles,
           'recipe': 'table_lr_mult=10 adam_eps=1e-15'}
    for label, kw in CONFIGS:
        if args.only and label not in args.only:
            continue
        config = emission_config(**kw)
        _, last, mse = fit(config, lambda g: sample_points(g, args.batch, train_times), target,
                           args.steps, args.lr, 1e-15, 10.0, device)
        with torch.no_grad():
            out[label] = {'train_mse': round(float(last), 6),
                          'val_trained_t': round(float(mse(val_seen, y_seen)), 6),
                          'val_unseen_t': round(float(mse(val_unseen, y_unseen)), 6)}
        print(json.dumps({label: out[label]}), flush=True)

    print(json.dumps(out))
    if args.out:
        with open(args.out, 'w') as fh:
            fh.write(json.dumps(out) + '\n')
    return out


if __name__ == '__main__':
    main()
