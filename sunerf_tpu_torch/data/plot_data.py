"""Input quality-check thumbnails: block-reduced JPEG previews of prepped
FITS frames, plus a flat-frame (zero-variance) report.

Parity with the reference's preprocessing QA script
(sunerf/data/preprocessing/plot_data.py): walk a FITS glob, flag frames whose
data has zero standard deviation (dead/failed preps), write an 8x8
block-mean-downsampled thumbnail per frame, and zip the folder. Differences:
paths are CLI arguments instead of hardcoded, the FITS IO is the native
reader (no sunpy), and the flat-frame list is returned/saved rather than just
printed.

The port's copy of sunerf_tpu/data/plot_data.py. matplotlib is imported
inside plot_data only: a host without it (the card's) still has
block_reduce_mean and the CLI's error.

Usage:
    python -m sunerf_tpu_torch.data.plot_data '<glob>' <out_dir> [--block 8] \
        [--vmin 0] [--vmax 1] [--cmap afmhot]
"""
from __future__ import annotations

import argparse
import glob
import os
import shutil

import numpy as np

from sunerf_tpu_torch.data.fits import read_fits


def block_reduce_mean(data: np.ndarray, block: int) -> np.ndarray:
    """Mean over non-overlapping block x block tiles (edge-cropped), the
    astropy.nddata.block_reduce(..., np.mean) the reference uses."""
    h, w = data.shape[:2]
    h2, w2 = h // block * block, w // block * block
    d = data[:h2, :w2].reshape(h2 // block, block, w2 // block, block)
    return d.mean(axis=(1, 3))


def plot_data(file_glob: str, out_dir: str, block: int = 8,
              vmin: float = 0.0, vmax: float = 1.0, cmap: str = 'afmhot',
              archive: bool = True) -> dict:
    """Write thumbnails for every matching FITS; returns a report dict with
    the flat (zero-std) frames and the thumbnail count."""
    try:
        import matplotlib
        matplotlib.use('Agg')
        import matplotlib.pyplot as plt
    except Exception as e:
        raise RuntimeError(f'matplotlib required for thumbnails: {e}')

    paths = sorted(glob.glob(file_glob))
    if os.path.exists(out_dir):
        shutil.rmtree(out_dir)
    os.makedirs(out_dir)

    flat = []
    for path in paths:
        data, _header = read_fits(path)
        data = np.asarray(data, np.float32)
        if data.ndim > 2:
            data = data[0]
        if float(np.std(data)) == 0.0:
            flat.append(path)
        bn = os.path.basename(path)
        plt.imsave(os.path.join(out_dir, f'{bn}.jpg'),
                   block_reduce_mean(data, block),
                   vmin=vmin, vmax=vmax, cmap=cmap)

    report = {'n_frames': len(paths), 'flat_frames': flat}
    if flat:
        with open(os.path.join(out_dir, 'flat_frames.txt'), 'w') as f:
            f.write('\n'.join(flat) + '\n')
    if archive:
        shutil.make_archive(out_dir, 'zip', out_dir)
    return report


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument('file_glob')
    parser.add_argument('out_dir')
    parser.add_argument('--block', type=int, default=8)
    parser.add_argument('--vmin', type=float, default=0.0)
    parser.add_argument('--vmax', type=float, default=1.0)
    parser.add_argument('--cmap', default='afmhot')
    parser.add_argument('--no-archive', action='store_true')
    args = parser.parse_args(argv)
    report = plot_data(args.file_glob, args.out_dir, block=args.block,
                       vmin=args.vmin, vmax=args.vmax, cmap=args.cmap,
                       archive=not args.no_archive)
    print(f"{report['n_frames']} frames; "
          f"{len(report['flat_frames'])} flat frames")
    for p in report['flat_frames']:
        print(f'FLAT: {p}')


if __name__ == '__main__':
    main()
