"""Score the classical reprojection baseline on the psi_193 protocol, on the
port (scripts/reprojection_baseline_psi.py of the JAX package).

The reference's non-ML comparison: merge the 14 ecliptic training views
into a heliographic Carrington map (surface-emission assumption,
baseline/reprojection.py) and reproject to each ground-truth viewpoint,
scored with the same asinh PSNR / SSIM / MAE% / ME% and |lat| > 7 deg test
split as the SuNeRF matrix rows. Pure numpy (the asinh scaling in torch on
the CPU); no device. The scene defaults to the port's psi_193 cache (the
directory scripts/psi_matrix.py and psi_protocol --data-cache share).

Usage: python -m sunerf_tpu_torch.scripts.reprojection_baseline_psi \\
    [--train '<tmp>/psi_scene_cache/train/*.fits'] \\
    [--gt '<tmp>/psi_scene_cache/gt/*.fits'] [--out REPROJECTION_r3.json]
Prints the summary as JSON (main returns the full result).
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import tempfile

import numpy as np

SCENE = os.path.join(tempfile.gettempdir(), 'psi_scene_cache')


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument('--train', default=os.path.join(SCENE, 'train', '*.fits'))
    parser.add_argument('--gt', default=os.path.join(SCENE, 'gt', '*.fits'))
    parser.add_argument('--lat-split', type=float, default=7.0)
    parser.add_argument('--shape-out', type=int, nargs=2, default=(512, 1024))
    parser.add_argument('--out', default=None)
    args = parser.parse_args(argv)

    import torch

    from sunerf_tpu_torch.baseline.reprojection import (create_heliographic_map,
                                                        heliographic_to_observer)
    from sunerf_tpu_torch.core.scaling import image_asinh_scaling
    from sunerf_tpu_torch.data.fits import read_fits
    from sunerf_tpu_torch.data.wcs import parse_observer
    from sunerf_tpu_torch.train.metrics import mae_percent, me_percent, psnr, ssim

    def scaled(image: np.ndarray) -> np.ndarray:
        return image_asinh_scaling(torch.from_numpy(image.astype(np.float32))).numpy()

    train_files = sorted(glob.glob(args.train))
    gt_files = sorted(glob.glob(args.gt))
    if not train_files or not gt_files:
        raise SystemExit(f'no FITS at {args.train} / {args.gt}')

    maps = [read_fits(f) for f in train_files]
    hmap = create_heliographic_map(maps, tuple(args.shape_out))

    per_view = []
    for path in gt_files:
        data, header = read_fits(path)
        obs = parse_observer(header)
        pred = heliographic_to_observer(hmap, obs.carrington_lat, obs.carrington_lon,
                                        obs.dsun_rs, resolution=data.shape[0])
        # off-disk pixels have no surface intersection; the SuNeRF rows
        # render the (near-zero) corona there, the baseline predicts 0
        pred = np.nan_to_num(pred, nan=0.0)
        p, t = scaled(pred), scaled(data)
        per_view.append({
            'file': path,
            'lat_deg': float(np.rad2deg(obs.carrington_lat)),
            'psnr': psnr(p, t),
            'ssim': ssim(p, t, data_range=float(t.max() - t.min() or 1)),
            'mae_percent': mae_percent(p, t),
            'me_percent': me_percent(p, t),
        })

    def summarize(views):
        return {k: float(np.mean([v[k] for v in views]))
                for k in ('psnr', 'ssim', 'mae_percent', 'me_percent')} if views else {}

    train = [v for v in per_view if abs(v['lat_deg']) <= args.lat_split]
    test = [v for v in per_view if abs(v['lat_deg']) > args.lat_split]
    out = {'baseline': 'reprojection', 'n_train_maps': len(train_files),
           'shape_out': list(args.shape_out),
           'train': summarize(train), 'test': summarize(test), 'views': per_view}
    print(json.dumps({k: out[k] for k in ('baseline', 'n_train_maps', 'train', 'test')}))
    if args.out:
        with open(args.out, 'w') as fh:
            json.dump(out, fh, indent=1)
    return out


if __name__ == '__main__':
    main()
