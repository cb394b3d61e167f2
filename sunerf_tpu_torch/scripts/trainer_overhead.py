"""What each piece of the Trainer adds to the bare train step:

    python -m sunerf_tpu_torch.scripts.trainer_overhead [--steps 100] [--turns 2] [--batch 1024]

The data: the committed bundle rendered at --res^2 from
config/render_simple_star.yaml's 8 observers (data/synthetic.py), read by
build_single_channel_data with batches of --batch rays (1024, the CLI's
default: the step is host-bound; 4096: the device takes longer than the
host, so a copy that waits for the device costs the host's time). The system: the
emission CLI's defaults (8x512 for both fields, 64 + 128 samples,
LossConfig(), make_optimizer()), weights from seed 7. Each variant trains
--steps steps from the same weights, timed by the host clock with the device
synchronized at both ends (ms/step):

  bare           the train step on one batch already on the device
  pageable       each step's batch read by MmapDataset and copied to the
                 device from pageable memory
  pinned         the same, copied from pinned memory (train/loop.py
                 _Uploader): the Trainer's way
  pinned_ema     the same, with the EMA average (decay 0.999)
  trainer        Trainer.fit for 2 x --steps steps with EMA 0.999 and no
                 validation after step 0's: its logged step_ms of the last
                 --steps
  trainer_guard  the same with the spike guard (factor 3), which reads
                 every step's loss on the host

in turns (the list, then the list reversed, --turns times), and the batch
read alone. Prints one JSON line with every run, the card's name and power
limit. On --device cpu (a dry run at --res 16) the numbers are the CPU's
and are no device metric.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import tempfile
import time

import torch

VARIANTS = ('bare', 'pageable', 'pinned', 'pinned_ema', 'trainer', 'trainer_guard')


def measure(device='cuda', steps: int = 100, turns: int = 2, resolution: int = 256,
            batch_size: int = 1024) -> dict:
    from sunerf_tpu_torch.data.datasets import iterate_batches
    from sunerf_tpu_torch.data.loaders import build_single_channel_data
    from sunerf_tpu_torch.data.synthetic import synthesize_views
    from sunerf_tpu_torch.systems import make_emission_system
    from sunerf_tpu_torch.train import loop
    from sunerf_tpu_torch.train.objective import LossConfig
    from sunerf_tpu_torch.train.optim import make_optimizer
    from sunerf_tpu_torch.train.step import create_train_state, make_train_step

    device = torch.device(device)
    cuda = device.type == 'cuda'
    sync = (lambda: torch.cuda.synchronize(device)) if cuda else (lambda: None)
    runs = {v: [] for v in VARIANTS}
    with tempfile.TemporaryDirectory() as tmp:
        pattern = synthesize_views(tmp, device, resolution)
        data = build_single_channel_data(pattern, os.path.join(tmp, 'shards'),
                                         batch_size=batch_size, n_workers=1)
        renderer, init = make_emission_system(device=device)
        params = init(torch.Generator().manual_seed(7))
        opt = make_optimizer()

        def timed(fn, n=steps):
            sync()
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            sync()
            return (time.perf_counter() - t0) * 1e3 / n

        def run(variant: str) -> float:
            if variant.startswith('trainer'):
                cfg = loop.TrainerConfig(total_steps=2 * steps, val_every=10 ** 9,
                                         checkpoint_every=10 ** 9, log_every=steps,
                                         save_val_images=False, ema_decay=0.999)
                workdir = tempfile.mkdtemp(dir=tmp)
                trainer = loop.Trainer(renderer, params, data, trainer_config=cfg,
                                       workdir=workdir, device=device,
                                       spike_guard=3.0 if variant == 'trainer_guard' else None)
                trainer.fit()
                with open(os.path.join(workdir, 'metrics.jsonl')) as f:
                    recs = [json.loads(line) for line in f]
                return [r['step_ms'] for r in recs if 'step_ms' in r][-1]
            ema = variant == 'pinned_ema'
            step = make_train_step(renderer, LossConfig(), opt,
                                   ema_decay=0.999 if ema else None)
            state = create_train_state(params, opt, ema=ema)
            reads = iterate_batches(data.train, seed=7)
            if 'pinned' in variant:
                upload = loop._Uploader(device)
                fetch = lambda: upload(next(reads))  # noqa: E731
            else:
                fetch = lambda: {k: torch.from_numpy(v).to(device)  # noqa: E731
                                 for k, v in next(reads).items()}
            batch = fetch()
            for _ in range(5):
                step(state, batch, 7)
            if variant == 'bare':
                return timed(lambda: step(state, batch, 7))
            return timed(lambda: step(state, fetch(), 7))

        for _ in range(turns):
            for order in (VARIANTS, VARIANTS[::-1]):
                for variant in order:
                    runs[variant].append(run(variant))
                    print(f'{variant:13s} {runs[variant][-1]:8.3f} ms/step', flush=True)
        reads = iterate_batches(data.train, seed=7)
        read_ms = timed(lambda: next(reads))
    out = {'device': torch.cuda.get_device_name(device) if cuda else 'cpu',
           'steps': steps, 'resolution': resolution, 'batch': batch_size, 'runs_ms': runs,
           'median_ms': {v: statistics.median(r) for v, r in runs.items()},
           'read_alone_ms': read_ms}
    if cuda:
        out['card'] = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                                      '--format=csv,noheader'], capture_output=True,
                                     text=True, check=True).stdout.strip()
    return out


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--device', default='cuda')
    parser.add_argument('--steps', type=int, default=100)
    parser.add_argument('--turns', type=int, default=2)
    parser.add_argument('--res', type=int, default=256)
    parser.add_argument('--batch', type=int, default=1024)
    args = parser.parse_args(argv)
    out = measure(args.device, args.steps, args.turns, args.res, args.batch)
    print(json.dumps(out), flush=True)
    return out


if __name__ == '__main__':
    main()
