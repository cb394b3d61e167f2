"""Offline metrics harness: score a trained SuNeRF against ground-truth
viewpoint FITS files with PSNR/SSIM/MAE%/ME%, split into train (|lat| <= 7
deg) and test (|lat| > 7 deg) viewpoints: the PSI evaluation protocol
(sunerf_tpu/evaluation/metrics_harness.py; reference
evaluation/stash/metrics_simulation.py:40-76; training data is restricted
to the ecliptic band at prep time, data/prep/psi.py:29-30).

Usage:
  python -m sunerf_tpu_torch.evaluation.metrics_harness \\
      --state runs/psi_193/save_state --data '/mnt/data/psi/193/*.fits' \\
      [--lat-split 7.0] [--output metrics.json] [--device cuda]
"""
from __future__ import annotations

import argparse
import glob
import json

import numpy as np
import torch

from sunerf_tpu_torch.core.scaling import image_asinh_scaling
from sunerf_tpu_torch.data.fits import read_fits
from sunerf_tpu_torch.data.wcs import parse_observer
from sunerf_tpu_torch.evaluation.loader import SHLO, ModelLoader, SuNeRFLoader
from sunerf_tpu_torch.train.metrics import mae_percent, me_percent, psnr, ssim

METRICS = ('psnr', 'ssim', 'mae_percent', 'me_percent')


def view_metrics(pred: np.ndarray, target: np.ndarray, image_scaling: str = 'asinh') -> dict:
    """The four metrics of one [H, W] prediction against its target, both
    asinh-scaled first unless image_scaling is 'none'."""
    target = target.astype(np.float32)
    if image_scaling == 'asinh':
        pred = image_asinh_scaling(torch.from_numpy(np.asarray(pred, np.float32))).numpy()
        target = image_asinh_scaling(torch.from_numpy(target)).numpy()
    return {'psnr': psnr(pred, target),
            'ssim': ssim(pred, target, data_range=float(target.max() - target.min() or 1)),
            'mae_percent': mae_percent(pred, target),
            'me_percent': me_percent(pred, target)}


def evaluate_viewpoints(loader: ModelLoader, files: list[str],
                        lat_split_deg: float = 7.0,
                        image_scaling: str = 'asinh') -> dict:
    """Render each FITS file's observer view at its resolution and
    wavelength and score it against the file's data. Returns the mean
    metrics of the train split, the test split and all views, the split
    sizes, and the per-view metrics."""
    per_view = []
    for path in files:
        data, header = read_fits(path)
        obs = parse_observer(header)
        wl = [obs.wavelength] if obs.wavelength else None
        view = loader.render_observer_image(
            lat=obs.carrington_lat, lon=obs.carrington_lon,
            time=obs.time, distance=obs.dsun_rs,
            resolution=data.shape[0], wavelengths=wl)
        per_view.append({
            'file': path,
            'lat_deg': float(np.rad2deg(obs.carrington_lat)),
            'lon_deg': float(np.rad2deg(obs.carrington_lon)),
            **view_metrics(view.image[:, :, 0], data, image_scaling),
        })

    def summarize(views):
        if not views:
            return {}
        return {k: float(np.mean([v[k] for v in views])) for k in METRICS}

    train = [v for v in per_view if abs(v['lat_deg']) <= lat_split_deg]
    test = [v for v in per_view if abs(v['lat_deg']) > lat_split_deg]
    return {'train': summarize(train), 'test': summarize(test),
            'all': summarize(per_view), 'n_train': len(train),
            'n_test': len(test), 'views': per_view}


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--state', required=True)
    parser.add_argument('--data', required=True, help='glob of ground-truth FITS')
    parser.add_argument('--lat-split', type=float, default=7.0)
    parser.add_argument('--batch-size', type=int, default=4096)
    parser.add_argument('--scaling', default='asinh', choices=['asinh', 'none'])
    parser.add_argument('--output', default=None)
    parser.add_argument('--eval-stratified', type=int, default=None,
                        help='override the train-time stratified sample '
                             'count for evaluation renders '
                             '(SuNeRFLoader render_overrides)')
    parser.add_argument('--eval-hierarchical', type=int, default=None)
    parser.add_argument('--device', default='cuda',
                        help="'cuda' (the default, the card) or 'cpu'")
    args = parser.parse_args(argv)

    overrides = {}
    if args.eval_stratified is not None:
        overrides['n_stratified'] = args.eval_stratified
    if args.eval_hierarchical is not None:
        overrides['n_hierarchical'] = args.eval_hierarchical
    if args.state.endswith('.shlo'):
        raise NotImplementedError(SHLO)
    loader = SuNeRFLoader(args.state, batch_size=args.batch_size,
                          render_overrides=overrides or None, device=args.device)
    files = sorted(glob.glob(args.data))
    result = evaluate_viewpoints(loader, files, args.lat_split, args.scaling)
    summary = {k: result[k] for k in ('train', 'test', 'all', 'n_train', 'n_test')}
    print(json.dumps(summary, indent=2))
    if args.output:
        with open(args.output, 'w') as f:
            json.dump(result, f, indent=2)


if __name__ == '__main__':
    main()
