"""Serve the committed bundle's artifact across the cards of one host, through
the user's entry points: ServingModel on any card, and a sharded (format 2)
artifact over an NCCL mesh under torchrun.

    python -m sunerf_tpu_torch.scripts.serve_cards [--ranks 1 2 4]
        [--res 256] [--batch 4096] [--reps 4] [--out serve_cards.json]

The parent process exports the bundle once per rank count (n_devices 1 for one
rank, n for n ranks; export_serving traces on the current card), renders
the one-device artifact's --res square frame at 1 AU on cuda:0 (the
reference frame) and on the host's last card, then for each count N of
--ranks runs `torchrun --standalone --nproc-per-node N -m
sunerf_tpu_torch.scripts.serve_cards --worker ...`: rank r joins the mesh
(NCCL, cuda:r), loads the artifact with ServingModel(path, mesh=mesh), which
maps its CUDA program onto cuda:r, and serves the frame, every rank taking
its rows of each chunk, one all-gather a frame. Each rank reports every
map's max abs difference from the reference frame and whether the bits are
the same, the frame's ms (host clock, median of --reps after a warm-up) and
K0's launches on its card by kernel name (fwd_wgmma_kernel, as K0's
library counts them: fused_mlp.kernel_launches).

Prints one JSON object (and writes it to --out), with the cards' names and
power limits as nvidia-smi prints them. --device cpu is a dry run on the CPU
(the artifact's CPU program, gloo ranks): its times are the CPU's, no device
metric, and no launch count.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BUNDLE = os.path.join(REPO, 'artifacts_r4', 's8_probe_rerun_best')
VIEW = dict(lat=0.3, lon=1.1, time=0.0, distance=215.0)
MAPS = ('image', 'height_map', 'absorption_map')
K0_KERNEL = 'fwd_wgmma_kernel'


def k0_launches(render, device: torch.device):
    """K0's launches in one render on `device` (this process renders on
    that card alone), by kernel name as K0's library counts them; None off
    the card."""
    if device.type != 'cuda':
        return None
    from sunerf_tpu_torch.ops.fused_mlp import kernel_launches
    before = kernel_launches('fused_mlp_fwd_wgmma')[K0_KERNEL]
    render()
    torch.cuda.synchronize(device)
    return kernel_launches('fused_mlp_fwd_wgmma')[K0_KERNEL] - before


def frame_ms(render, reps: int) -> float:
    """The host clock to the host copy of the frame, median of reps after a
    warm-up."""
    render()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        render()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def versus(view, ref: dict) -> dict:
    """Per map: max |served - reference| and whether the bits are the same."""
    out = {}
    for k in MAPS:
        got = getattr(view, k)
        out[k] = dict(max_abs_diff=float(np.abs(got.astype(np.float64) - ref[k]).max()),
                      same_bits=bool(np.array_equal(got, ref[k])))
    return out


def serve(model, res: int, reps: int, ref: dict) -> dict:
    """One served frame against the reference, its ms and K0's launches."""
    frames = {}

    def render():
        frames['view'] = model.render_observer_image(resolution=res, **VIEW)
    ms = frame_ms(render, reps)
    return dict(device=str(model.device), ms=ms, vs_one_device=versus(frames['view'], ref),
                k0_launches=k0_launches(render, model.device))


def _worker(args):
    """A rank under torchrun: the sharded artifact on the mesh."""
    from sunerf_tpu_torch.evaluation.serving import ServingModel
    from sunerf_tpu_torch.parallel.mesh import make_mesh
    import torch.distributed as dist
    cuda = args.device == 'cuda'
    world = int(os.environ['WORLD_SIZE'])
    mesh = make_mesh(None if cuda else ['cpu'] * world)
    try:
        model = ServingModel(args.worker, device=args.device, mesh=mesh)
        with np.load(args.ref) as f:
            ref = {k: f[k] for k in MAPS}
        row = dict(rank=mesh.rank, backend=mesh.backend, **serve(model, args.res, args.reps, ref))
        with open(os.path.join(args.outdir, f'rank{mesh.rank}.json'), 'w') as f:
            json.dump(row, f)
    finally:
        dist.destroy_process_group()


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument('--ranks', type=int, nargs='+', default=[1, 2, 4])
    parser.add_argument('--state', default=BUNDLE)
    parser.add_argument('--res', type=int, default=256)
    parser.add_argument('--batch', type=int, default=4096, help='rays a chunk (all ranks)')
    parser.add_argument('--reps', type=int, default=4)
    parser.add_argument('--device', default='cuda')
    parser.add_argument('--timeout', type=float, default=300.0, help='seconds a run')
    parser.add_argument('--out', default=None)
    parser.add_argument('--worker', default=None, help=argparse.SUPPRESS)
    parser.add_argument('--ref', default=None, help=argparse.SUPPRESS)
    parser.add_argument('--outdir', default=None, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.worker:
        return _worker(args)
    from sunerf_tpu_torch.evaluation.serving import ServingModel, export_serving
    from sunerf_tpu_torch.scripts.dp_cards import _torchrun

    cuda = args.device == 'cuda'
    if cuda and torch.cuda.device_count() < max(args.ranks):
        raise RuntimeError(f'{max(args.ranks)} ranks need as many cards; this host has '
                           f'{torch.cuda.device_count()}')
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get('PYTHONPATH', ''))
    for k in ('RANK', 'WORLD_SIZE', 'LOCAL_RANK', 'MASTER_ADDR', 'MASTER_PORT'):
        env.pop(k, None)
    out = dict(state=args.state, res=args.res, batch=args.batch, view=VIEW, export_s={},
               ranks={})
    with tempfile.TemporaryDirectory() as tmp:
        arts = {}
        for n in sorted({1, *args.ranks}):
            arts[n] = os.path.join(tmp, f'n{n}.tsrv')
            t0 = time.perf_counter()
            export_serving(args.state, arts[n], batch_size=args.batch,
                           platforms=(args.device,), n_devices=n)
            out['export_s'][n] = time.perf_counter() - t0
        first = 'cuda:0' if cuda else 'cpu'
        model = ServingModel(arts[1], device=first)
        view = model.render_observer_image(resolution=args.res, **VIEW)
        ref = {k: getattr(view, k) for k in MAPS}
        ref_path = os.path.join(tmp, 'ref.npz')
        np.savez(ref_path, **ref)
        out['one_device'] = serve(model, args.res, args.reps, ref)
        del model
        if cuda:
            # the one-device artifact on the host's last card, in this process
            last = f'cuda:{torch.cuda.device_count() - 1}'
            out['last_card'] = serve(ServingModel(arts[1], device=last), args.res, args.reps,
                                     ref)
        last_card = ''
        if cuda:
            same = all(v['same_bits'] for v in out['last_card']['vs_one_device'].values())
            last_card = (f", {out['last_card']['ms']:.1f} ms on {out['last_card']['device']} "
                         f"(the same bits: {same})")
        print(f"[serve_cards] one-device artifact: {out['one_device']['ms']:.1f} ms on {first}"
              + last_card, flush=True)
        for n in args.ranks:
            outdir = os.path.join(tmp, f'ranks{n}')
            os.makedirs(outdir)
            seconds, _ = _torchrun(n, 'sunerf_tpu_torch.scripts.serve_cards',
                                   ['--worker', arts[n], '--ref', ref_path, '--outdir', outdir,
                                    '--res', str(args.res), '--reps', str(args.reps),
                                    '--device', args.device], env, args.timeout)
            rows = []
            for r in range(n):
                with open(os.path.join(outdir, f'rank{r}.json')) as f:
                    rows.append(json.load(f))
            out['ranks'][n] = dict(run_s=seconds, n_devices=n, rows=rows)
            print(f'[serve_cards] {n} rank(s): ' + '; '.join(
                f"rank {row['rank']} on {row['device']}: {row['ms']:.1f} ms, max diff "
                f"{max(v['max_abs_diff'] for v in row['vs_one_device'].values()):.2e}, K0 "
                f"{row['k0_launches']}" for row in rows), flush=True)
    if cuda:
        out['cards'] = subprocess.run(
            ['nvidia-smi', '--query-gpu=index,name,power.limit', '--format=csv,noheader'],
            capture_output=True, text=True).stdout.strip().splitlines()
    if args.out:
        with open(args.out, 'w') as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out), flush=True)
    return out


if __name__ == '__main__':
    main()
