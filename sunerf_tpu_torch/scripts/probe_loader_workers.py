"""What a spawned FITS loader worker costs on this host, against the rate at
which the data layer reads FITS in process, and so whether the data
layer's default (data/loaders: FITS loaded in process, n_workers=1) holds:

    python -m sunerf_tpu_torch.scripts.probe_loader_workers [--maps 40]
        [--resolution 1024] [--small-maps 8] [--small-resolution 128]
        [--workers N] [--workdir DIR]

It writes two sets of float32 193 A FITS maps with observer headers: a
real-size set (--maps prepped maps at --resolution^2, the reference prep's
default 1024^2) and a small one (--small-maps at --small-resolution^2, the
size of chip_smoke's synthesized views). Measured, by the host clock:

  start_s          a pool of --workers spawned workers (default one per
                   CPU), each loading one 16^2 map, less the same loads in
                   process: the workers' start, torch's import included
  read_mib_s       the real-size set loaded in process (load_map_data:
                   read, pose, rays), MiB of FITS a second
  break_even_mib   start_s * read_mib_s: the FITS a worker must read in
                   process time to pay for its start

and, for each set, its MiB and its load in process and through one worker
per CPU (at most one per map). Prints one JSON object with the host's CPU
count. Every number is a host number; no device is used.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from datetime import datetime, timedelta

import numpy as np

from sunerf_tpu_torch.data import loaders
from sunerf_tpu_torch.data.fits import write_fits
from sunerf_tpu_torch.data.wcs import observer_header


def write_maps(root: str, n: int, resolution: int, seed: int = 0) -> list[str]:
    """n float32 maps of random data with observer headers under root."""
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(seed)
    t0 = datetime(2012, 8, 23)
    paths = []
    for i in range(n):
        t = t0 + timedelta(hours=i)
        path = os.path.join(root, f'aia_{i:03d}.193.fits')
        write_fits(path, rng.random((resolution, resolution), dtype=np.float32),
                   observer_header(0.0, 360.0 * i / n, 215.0, t, resolution, 193.0))
        paths.append(path)
    return paths


def load_s(files: list[str], n_workers: int) -> float:
    """Seconds to load files through the loaders' pool of n_workers."""
    t0 = time.perf_counter()
    maps = loaders._load_maps(files, 1.0, n_workers)
    assert len(maps) == len(files)
    return time.perf_counter() - t0


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--maps', type=int, default=40)
    parser.add_argument('--resolution', type=int, default=1024)
    parser.add_argument('--small-maps', type=int, default=8)
    parser.add_argument('--small-resolution', type=int, default=128)
    parser.add_argument('--workers', type=int, default=os.cpu_count() or 1)
    parser.add_argument('--workdir', default=None)
    args = parser.parse_args(argv)
    with tempfile.TemporaryDirectory(dir=args.workdir) as tmp:
        tiny = write_maps(os.path.join(tmp, 'tiny'), args.workers, 16)
        real = write_maps(os.path.join(tmp, 'real'), args.maps, args.resolution)
        small = write_maps(os.path.join(tmp, 'small'), args.small_maps, args.small_resolution)
        load_s(tiny, 1)                              # the modules imported in process
        start_s = load_s(tiny, args.workers) - load_s(tiny, 1)
        mib = {name: sum(os.path.getsize(f) for f in files) / 2 ** 20
               for name, files in (('real', real), ('small', small))}
        in_process = {'real': load_s(real, 1), 'small': load_s(small, 1)}
        read_mib_s = mib['real'] / in_process['real']
        row = dict(cpus=os.cpu_count(), workers=args.workers, start_s=start_s,
                   read_mib_s=read_mib_s, break_even_mib=start_s * read_mib_s, sets={})
        for name, files in (('real', real), ('small', small)):
            row['sets'][name] = dict(maps=len(files), mib=mib[name],
                                     in_process_s=in_process[name],
                                     all_workers_s=load_s(files, min(args.workers, len(files))))
    print(json.dumps(row), flush=True)
    return row


if __name__ == '__main__':
    main()
