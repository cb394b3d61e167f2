"""Offline FITS -> FITS preparation CLIs: normalize instrument data into the
[0, 1]-scaled, resolution-matched maps the loaders consume
(sunerf_tpu/data/prep.py; host-side numpy, the port imports nothing of the
JAX package).

Native equivalents of the reference prep scripts (sunerf/data/prep/sdo.py:18-112,
stereo.py:16-103, psi.py:14-68, so.py:14-61):
  * resample to a target resolution (scipy zoom, WCS CDELT/CRPIX updated);
  * per-wavelength linear normalization (data/norms.py tables);
  * PSI: drop frames with |Carrington lat| > 7 deg (the ecliptic training cut
    whose complement defines the test split, psi.py:29-30);
  * SO/EUI: exposure-time normalization (so.py:31-33);
  * AIA degradation correction: the reference uses the external ITI package
    (AIAPrepEditor); when `itipy` is importable it is applied, otherwise the
    correction is skipped with a warning (documented difference).

Usage:
  python -m sunerf_tpu_torch.data.prep sdo    --files 'raw/*.fits' --out prep/ [--resolution 1024]
  python -m sunerf_tpu_torch.data.prep stereo --files 'raw/*.fits' --out prep/
  python -m sunerf_tpu_torch.data.prep psi    --files 'raw/*.fits' --out prep/
  python -m sunerf_tpu_torch.data.prep so     --files 'raw/*.fits' --out prep/
"""
from __future__ import annotations

import argparse
import glob
import logging
import os

import numpy as np

from sunerf_tpu_torch.data.fits import read_fits, write_fits
from sunerf_tpu_torch.data.norms import PSI_NORMS, SDO_NORMS, SO_NORMS, normalize, remove_nans
from sunerf_tpu_torch.data.wcs import parse_observer

logger = logging.getLogger(__name__)


def resample(data: np.ndarray, header, resolution: int):
    """Resample the image to resolution^2 and update the WCS scale/refpix:
    scipy.ndimage.zoom(order=1) where scipy imports, else nearest
    neighbour (the same two branches as the JAX package's)."""
    if data.shape == (resolution, resolution):
        return data, header
    try:
        from scipy.ndimage import zoom
        fy = resolution / data.shape[0]
        fx = resolution / data.shape[1]
        out = zoom(data.astype(np.float32), (fy, fx), order=1)
    except ImportError:  # nearest-neighbor fallback
        yi = (np.arange(resolution) * data.shape[0] / resolution).astype(int)
        xi = (np.arange(resolution) * data.shape[1] / resolution).astype(int)
        out = data[np.ix_(yi, xi)].astype(np.float32)
        fy = resolution / data.shape[0]
        fx = resolution / data.shape[1]
    for key, f in (('CDELT1', fx), ('CDELT2', fy)):
        if key in header:
            header[key] = float(header[key]) / f
    for key, f in (('CRPIX1', fx), ('CRPIX2', fy)):
        if key in header:
            header[key] = (float(header[key]) - 0.5) * f + 0.5
    header['NAXIS1'] = resolution
    header['NAXIS2'] = resolution
    return out, header


def _aia_degradation_correction(data, header):
    """Apply ITI's AIA degradation correction when available
    (reference loadAIAMap, data/utils.py:28-51)."""
    try:
        from itipy.data.editor import AIAPrepEditor  # noqa: F401
    except ImportError:
        logger.warning('itipy not available - skipping AIA degradation '
                       'correction (prep parity difference)')
        return data
    # ITI operates on sunpy Maps; only usable when sunpy is present too.
    try:
        import sunpy.map
        s_map = sunpy.map.Map(data, dict(header.cards))
        from itipy.data.editor import AIAPrepEditor
        s_map = AIAPrepEditor(calibration='auto').call(s_map)
        return np.asarray(s_map.data)
    except Exception as e:  # pragma: no cover
        logger.warning('AIA degradation correction failed: %s', e)
        return data


def prep_file(path: str, out_dir: str, instrument: str,
              resolution: int | None = 1024, apply_norm: bool = True,
              degradation_table=None, lat_cut: bool = True) -> str | None:
    """degradation_table: a data.degradation.DegradationTable, the default
    packaged AIA table when None, or False to skip the correction (the
    ITI/aiapy path is then tried, matching reference loadAIAMap,
    data/utils.py:28-51)."""
    data, header = read_fits(path)
    data = remove_nans(data)
    obs = parse_observer(header)
    wl = int(obs.wavelength) if obs.wavelength else None

    if instrument == 'sdo':
        if header.get('QUALITY', 0) != 0:
            logger.warning('skip %s: QUALITY=%s', path, header.get('QUALITY'))
            return None
        if degradation_table is None:
            from sunerf_tpu_torch.data.degradation import DegradationTable
            degradation_table = DegradationTable.default()
        if degradation_table is not False and wl is not None:
            data = degradation_table.correct(data, wl, obs.time)
        else:
            data = _aia_degradation_correction(data, header)
        norms = SDO_NORMS
    elif instrument == 'stereo':
        norms = SDO_NORMS  # ITI-converted SECCHI uses the AIA tables
    elif instrument == 'psi':
        # ecliptic-band training cut (reference psi.py:29-30); lat_cut=False
        # preps ALL viewpoints (evaluation ground truth for the metrics
        # harness's |lat|>7-deg test split)
        if lat_cut and abs(np.rad2deg(obs.carrington_lat)) > 7.0:
            logger.info('skip %s: |lat| > 7 deg', path)
            return None
        norms = PSI_NORMS
    elif instrument == 'so':
        exp = float(header.get('XPOSURE', header.get('EXPTIME', 1.0)) or 1.0)
        data = data / exp
        norms = SO_NORMS
    else:
        raise ValueError(f'unknown instrument {instrument!r}')

    if resolution:
        data, header = resample(data, header, resolution)
    if apply_norm and wl in norms:
        data = normalize(data, norms[wl], clip=(instrument == 'psi'))
    elif apply_norm:
        logger.warning('%s: no norm table for wavelength %s', path, wl)

    os.makedirs(out_dir, exist_ok=True)
    out_path = os.path.join(out_dir, os.path.basename(path))
    write_fits(out_path, data.astype(np.float32), header)
    return out_path


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('instrument', choices=['sdo', 'stereo', 'psi', 'so'])
    parser.add_argument('--files', required=True, help='input FITS glob')
    parser.add_argument('--out', required=True, help='output directory')
    parser.add_argument('--resolution', type=int, default=1024)
    parser.add_argument('--no-norm', action='store_true')
    parser.add_argument('--degradation-table', default=None,
                        help='JSON degradation table (data/degradation.py); '
                             'default: the packaged approximate AIA table')
    parser.add_argument('--no-degradation', action='store_true',
                        help='skip the table correction (tries ITI/aiapy)')
    parser.add_argument('--keep-all-lats', action='store_true',
                        help='psi: keep |lat| > 7 deg viewpoints (evaluation '
                             'ground truth rather than training data)')
    args = parser.parse_args(argv)

    table = False if args.no_degradation else None
    if args.degradation_table:
        from sunerf_tpu_torch.data.degradation import DegradationTable
        table = DegradationTable.from_json(args.degradation_table)

    files = sorted(glob.glob(args.files))
    done = 0
    for f in files:
        if prep_file(f, args.out, args.instrument, args.resolution,
                     apply_norm=not args.no_norm, degradation_table=table,
                     lat_cut=not args.keep_all_lats):
            done += 1
    print(f'prepped {done}/{len(files)} files -> {args.out}')


if __name__ == '__main__':
    logging.basicConfig(level=logging.INFO)
    main()
