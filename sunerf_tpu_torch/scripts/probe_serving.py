"""Artifact against live render probe (scripts/probe_serving.py of the JAX
package): one full-disk frame of a bundle through the live SuNeRFLoader and
through its .tsrv serving artifact, exported from the same bundle into a
temporary directory, on the card.

Each path is timed by the host clock to the host copy of the frame (median
of --reps renders after a warm-up) and, on the card, by CUDA events around
the same renders and by torch.profiler over one more: the device's kernel
time, its idle share and K0's launches counted by kernel name
(fwd_wgmma_kernel). On the CPU (--device cpu) only the host clock is read
and the device numbers are null: not measured.

Usage: python -m sunerf_tpu_torch.scripts.probe_serving --state <bundle>
       [--resolution 512] [--batch-size 8192] [--tier 0.5,16] [--reps 3]
       [--device cuda] [--out FILE]
Prints one JSON object.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import tempfile
import time

import numpy as np
import torch

K0_KERNEL = 'fwd_wgmma_kernel'
VIEW = dict(lat=0.3, lon=1.0, time=0.0, distance=215.0)


def _profiled(render, cuda: bool) -> dict:
    """One render under torch.profiler: the device's kernel ms, its idle
    share of the render's host-clock ms and K0's launches by kernel name
    (after a throwaway kernel, which takes the session's first record)."""
    if not cuda:
        return dict(device_ms=None, idle_share=None, k0_launches=None)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.zeros(1, device='cuda').add_(1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        render()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, 'is_user_annotation', False) and '#' not in e.name]
    device_ms = sum(e.device_time for e in kernels) / 1e3
    return dict(device_ms=device_ms, idle_share=1.0 - device_ms / wall_ms,
                k0_launches=sum(K0_KERNEL in e.name for e in kernels))


def timed(render, reps: int, cuda: bool) -> dict:
    """wall_ms: the host clock to the host copy, median of reps after a
    warm-up; events_ms: CUDA events around the same renders (card only);
    then _profiled's one render."""
    render()
    walls, events = [], []
    for _ in range(reps):
        if cuda:
            start, end = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            start.record()
        t0 = time.perf_counter()
        render()
        walls.append((time.perf_counter() - t0) * 1e3)
        if cuda:
            end.record()
            end.synchronize()
            events.append(start.elapsed_time(end))
    return dict(wall_ms=statistics.median(walls),
                events_ms=statistics.median(events) if cuda else None,
                **_profiled(render, cuda))


def probe(state: str, resolution: int = 512, batch_size: int = 8192, tier=None,
          reps: int = 3, device='cuda') -> dict:
    from sunerf_tpu_torch.evaluation.loader import SuNeRFLoader
    from sunerf_tpu_torch.evaluation.serving import ServingModel, export_serving
    device = torch.device(device)
    cuda = device.type == 'cuda'
    loader = SuNeRFLoader(state, batch_size=batch_size, tier=tier, device=device)
    wl = list(loader.wavelengths) if loader.wavelengths else None
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, 'model.tsrv')
        t0 = time.perf_counter()
        meta = export_serving(state, path, batch_size=batch_size, platforms=(device.type,),
                              tier=tier)
        export_s = time.perf_counter() - t0
        model = ServingModel(path, device=device)
        size = os.path.getsize(path)
        frames = {}

        def run(name, source):
            def render():
                frames[name] = source.render_observer_image(
                    resolution=resolution, wavelengths=wl, **VIEW).image
            return render

        live = timed(run('live', loader), reps, cuda)
        served = timed(run('served', model), reps, cuda)
    n_rays = resolution ** 2
    diff = np.abs(frames['served'] - frames['live'])
    return {
        'device': torch.cuda.get_device_name(device) if cuda else 'cpu',
        'resolution': resolution, 'batch_size': batch_size,
        'tier': list(tier) if tier else None, 'fused_cuda': meta['fused_cuda'],
        'export_s': export_s, 'artifact_bytes': size,
        'live': live, 'served': served,
        'live_rays_per_sec': n_rays / live['wall_ms'] * 1e3,
        'served_rays_per_sec': n_rays / served['wall_ms'] * 1e3,
        'served_over_live': served['wall_ms'] / live['wall_ms'],
        'max_abs_diff': float(diff.max()),
        'max_rel_diff': float(diff.max() / max(float(np.abs(frames['live']).max()), 1e-30)),
    }


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--state', required=True)
    parser.add_argument('--resolution', type=int, default=512)
    parser.add_argument('--batch-size', type=int, default=8192)
    parser.add_argument('--tier', default=None, metavar='FRAC,SAMPLES')
    parser.add_argument('--reps', type=int, default=3)
    parser.add_argument('--device', default='cuda',
                        help="'cuda' (the default, the card) or 'cpu'")
    parser.add_argument('--out', default=None)
    args = parser.parse_args(argv)
    if torch.device(args.device).type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('no CUDA device: the probe times the card; pass --device cpu '
                           'to run it on the CPU')
    tier = None
    if args.tier:
        frac, samples = args.tier.split(',')
        tier = (float(frac), int(samples))
    result = probe(args.state, args.resolution, args.batch_size, tier, reps=args.reps,
                   device=args.device)
    print(json.dumps(result))
    if args.out:
        with open(args.out, 'w') as fh:
            fh.write(json.dumps(result) + '\n')
    return result


if __name__ == '__main__':
    main()
