"""Data parallel across the cards of one host, through the user's entry
points: the emission CLI and the bare mesh step under torchrun.

    python -m sunerf_tpu_torch.scripts.dp_cards [--ranks 1 4] [--steps 100]
        [--batch 1024] [--out dp_cards.json]

For each count N of --ranks, in order: `torchrun --standalone
--nproc-per-node N -m sunerf_tpu_torch.run_emission` on views of the
committed bundle rendered as FITS (data/synthetic.py, --res square),
8x512 for both fields with 64 + 128 samples unless --model / --samples say
otherwise, --batch rays a rank, --steps steps, the loss logged every 10
steps, no drift probe, validations at step 0 and at the end only. Its
ms/step is the mean of metrics.jsonl's step_ms after step 10 (rank 0's host
clock, waiting for the loss every 10 steps), and the global rays/s is N
--batch rays over it; rank_data_dirs lists the data directories that ranks
made of their own (none: rank 0 builds the shards once). For each N above
1, then, `dp_step.py` at --batch rays a rank (the bare mesh step against one
card's, and the NCCL all-reduce).

Prints one JSON object (and writes it to --out): every run's numbers, and
the cards' names and power limits as nvidia-smi prints them. --device cpu
is a dry run on the CPU over gloo (--res 32 --model 2 32 --samples 8 8
--batch 64): its times are the CPU's, no device metric.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import yaml

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BUNDLE = os.path.join(REPO, 'artifacts_r4', 's8_probe_rerun_best')


def _torchrun(n: int, module: str, args: list, env: dict, timeout: float) -> tuple:
    """Run `module` on n ranks under torchrun; (seconds, stdout). Raises on
    a non-zero exit or at the deadline (torchrun then stops its ranks)."""
    cmd = [sys.executable, '-m', 'torch.distributed.run', '--standalone',
           f'--nproc-per-node={n}', '-m', module, *args]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=timeout)
    seconds = time.perf_counter() - t0
    if proc.returncode:
        raise SystemExit(f'{module} on {n} ranks exited {proc.returncode}:\n'
                         f'{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}')
    return seconds, proc.stdout


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--ranks', type=int, nargs='+', default=[1, 4])
    parser.add_argument('--steps', type=int, default=100)
    parser.add_argument('--batch', type=int, default=1024, help='rays a rank')
    parser.add_argument('--res', type=int, default=256)
    parser.add_argument('--model', type=int, nargs=2, default=(8, 512))
    parser.add_argument('--samples', type=int, nargs=2, default=(64, 128))
    parser.add_argument('--device', default='cuda')
    parser.add_argument('--timeout', type=float, default=300.0, help='seconds a run')
    parser.add_argument('--out', default=None)
    args = parser.parse_args(argv)
    import torch
    from sunerf_tpu_torch.data.synthetic import synthesize_views

    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get('PYTHONPATH', ''))
    for k in ('RANK', 'WORLD_SIZE', 'LOCAL_RANK', 'MASTER_ADDR', 'MASTER_PORT'):
        env.pop(k, None)
    out = dict(batch_per_rank=args.batch, steps=args.steps, res=args.res,
               model=[*args.model, *args.samples], cli={}, dp_step={})
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        pattern = synthesize_views(tmp, torch.device(args.device), args.res, BUNDLE)
        out['synth_s'] = time.perf_counter() - t0
        for n in args.ranks:
            workdir = os.path.join(tmp, f'run{n}')
            config = {'path_to_save': workdir,
                      'model': {'n_layers': args.model[0], 'd_filter': args.model[1]},
                      'rendering': {'n_stratified': args.samples[0],
                                    'n_hierarchical': args.samples[1]},
                      'data': {'data_path': pattern, 'batch_size': args.batch},
                      'training': {'total_steps': args.steps, 'log_every_n_steps': args.steps,
                                   'scalar_log_every': 10, 'drift_probe_views': 0}}
            path = os.path.join(tmp, f'run{n}.yaml')
            with open(path, 'w') as f:
                yaml.safe_dump(config, f)
            seconds, _ = _torchrun(n, 'sunerf_tpu_torch.run_emission',
                                   ['--config', path, '--device', args.device], env,
                                   args.timeout)
            with open(os.path.join(workdir, 'metrics.jsonl')) as f:
                recs = [json.loads(line) for line in f]
            steps = [r for r in recs if 'loss' in r]
            ms = statistics.mean(r['step_ms'] for r in steps if r['step'] > 10)
            batches = os.path.join(workdir, 'batches')
            own = sorted(d for d in os.listdir(batches) if os.path.isdir(os.path.join(batches, d)))
            out['cli'][n] = dict(ms_per_step=ms, global_rays_per_s=n * args.batch / ms * 1e3,
                                 run_s=seconds, rank_data_dirs=own,
                                 losses=[r['loss'] for r in steps])
            print(f'[dp_cards] run_emission on {n} ranks: {ms:.2f} ms/step over steps 11-'
                  f'{args.steps}, {n * args.batch / ms * 1e3:.0f} rays/s, {seconds:.1f} s',
                  flush=True)
        for n in (n for n in args.ranks if n > 1):
            extra = ([] if args.device == 'cuda' else
                     ['--device', args.device, '--layers', str(args.model[0]), '--width',
                      str(args.model[1]), '--samples', *map(str, args.samples)])
            _, text = _torchrun(n, 'sunerf_tpu_torch.scripts.dp_step',
                                ['--rays', str(args.batch), *extra], env, args.timeout)
            out['dp_step'][n] = json.loads(text.strip().splitlines()[-1])
            print(f'[dp_cards] dp_step on {n} ranks: {out["dp_step"][n]["global_rays_per_s"]:.0f} '
                  f'rays/s against {out["dp_step"][n]["single_rays_per_s"]:.0f} on one card',
                  flush=True)
    if args.device == 'cuda':
        out['cards'] = subprocess.run(
            ['nvidia-smi', '--query-gpu=index,name,power.limit', '--format=csv,noheader'],
            capture_output=True, text=True).stdout.strip().splitlines()
    if args.out:
        with open(args.out, 'w') as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out), flush=True)


if __name__ == '__main__':
    main()
