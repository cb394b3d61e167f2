"""Multi-instrument file alignment: intersect observation dates across
instrument/wavelength directories and copy matching files into an aligned
tree (reference sunerf/data/preprocessing/align_data.py:9-61;
sunerf_tpu/data/align.py, with the port's date_from_filename).

Usage:
  python -m sunerf_tpu_torch.data.align --dirs prep/171 prep/193 --out aligned/
"""
from __future__ import annotations

import argparse
import glob
import os
import shutil

from sunerf_tpu_torch.data.loaders import date_from_filename


def align_directories(input_dirs: list[str], output_dir: str,
                      copy: bool = True) -> dict:
    """Keep only observation times present in every input directory.

    Returns {iso_time: [file per dir]} for the aligned intersection.
    """
    by_dir = []
    for d in input_dirs:
        files = sorted(glob.glob(os.path.join(d, '*.fits')))
        by_dir.append({date_from_filename(f): f for f in files})

    common = set(by_dir[0])
    for m in by_dir[1:]:
        common &= set(m)

    aligned = {}
    for t in sorted(common):
        group = [m[t] for m in by_dir]
        aligned[t.isoformat()] = group
        if copy:
            for src_dir, f in zip(input_dirs, group):
                dst = os.path.join(output_dir, os.path.basename(src_dir.rstrip('/')))
                os.makedirs(dst, exist_ok=True)
                shutil.copy(f, os.path.join(dst, os.path.basename(f)))
    return aligned


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--dirs', nargs='+', required=True)
    parser.add_argument('--out', required=True)
    args = parser.parse_args(argv)
    aligned = align_directories(args.dirs, args.out)
    print(f'aligned {len(aligned)} timestamps across {len(args.dirs)} dirs')


if __name__ == '__main__':
    main()
