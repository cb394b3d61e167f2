"""Solar WCS: observer geometry and helioprojective pixel grids straight from
FITS headers — the frozen-at-prep-time replacement for the reference's
sunpy/astropy coordinate machinery (base_loader.py:87-103 uses
Map.carrington_longitude/latitude/dsun and all_coordinates_from_map).
A copy of sunerf_tpu/data/wcs.py (the port imports nothing of the JAX
package).

All astropy work happens offline in the data layer; the device path only ever
sees ray bundles (SURVEY §7 'hard parts': WCS/FITS boundary).
"""
from __future__ import annotations

import dataclasses
from datetime import datetime

import numpy as np

R_SUN_M = 6.957e8       # IAU nominal solar radius [m]
ARCSEC_TO_RAD = np.pi / (180.0 * 3600.0)


@dataclasses.dataclass
class SolarObserver:
    """Observer geometry extracted from a FITS header."""
    time: datetime
    carrington_lon: float   # [rad]
    carrington_lat: float   # [rad]
    dsun_rs: float          # distance in solar radii
    wavelength: float | None = None


def _parse_date(value: str) -> datetime:
    value = value.strip().replace('Z', '')
    for fmt in ('%Y-%m-%dT%H:%M:%S.%f', '%Y-%m-%dT%H:%M:%S',
                '%Y-%m-%d %H:%M:%S.%f', '%Y-%m-%d %H:%M:%S', '%Y-%m-%d'):
        try:
            return datetime.strptime(value, fmt)
        except ValueError:
            continue
    raise ValueError(f'unparseable FITS date {value!r}')


def parse_observer(header) -> SolarObserver:
    """Extract observer time, Carrington lon/lat, and Sun distance.

    Uses CRLN_OBS/CRLT_OBS when present (AIA/SECCHI standard); falls back to
    HGLN_OBS/HGLT_OBS (Stonyhurst — longitude then relative to the central
    meridian, matching how synthesized headers are written by image_render).
    """
    date_key = next((k for k in ('DATE-OBS', 'DATE_OBS', 'T_OBS', 'DATE-AVG', 'DATE')
                     if k in header), None)
    if date_key is None:
        raise KeyError('no observation date in header')
    time = _parse_date(str(header[date_key]))

    if 'CRLN_OBS' in header:
        lon = float(header['CRLN_OBS'])
        lat = float(header.get('CRLT_OBS', header.get('HGLT_OBS', 0.0)))
    elif 'HGLN_OBS' in header:
        lon = float(header['HGLN_OBS'])
        lat = float(header.get('HGLT_OBS', 0.0))
    else:
        raise KeyError('no observer longitude (CRLN_OBS/HGLN_OBS) in header')

    dsun_m = float(header.get('DSUN_OBS', 1.496e11))
    wl = header.get('WAVELNTH')

    return SolarObserver(time=time,
                         carrington_lon=np.deg2rad(lon),
                         carrington_lat=np.deg2rad(lat),
                         dsun_rs=dsun_m / R_SUN_M,
                         wavelength=float(wl) if wl is not None else None)


def helioprojective_grid(header, shape=None):
    """Per-pixel helioprojective angles (Tx, Ty) [rad] from a linear WCS.

    Solar image WCS (TAN at disk scale) is linear to <<1 pixel:
    Tx = CRVAL1 + CDELT1*(PC11*dx + PC12*dy) [arcsec], dx = x+1-CRPIX1.

    Returns Tx, Ty each [H, W] float32, row 0 = bottom row in FITS convention
    (data array row order).
    """
    if shape is None:
        shape = (header['NAXIS2'], header['NAXIS1'])
    h, w = shape
    crpix1 = float(header.get('CRPIX1', (w + 1) / 2))
    crpix2 = float(header.get('CRPIX2', (h + 1) / 2))
    cdelt1 = float(header.get('CDELT1', 1.0))
    cdelt2 = float(header.get('CDELT2', 1.0))
    crval1 = float(header.get('CRVAL1', 0.0))
    crval2 = float(header.get('CRVAL2', 0.0))

    if 'PC1_1' in header:
        pc = np.array([[float(header.get('PC1_1', 1.0)), float(header.get('PC1_2', 0.0))],
                       [float(header.get('PC2_1', 0.0)), float(header.get('PC2_2', 1.0))]])
    elif 'CROTA2' in header:
        rho = np.deg2rad(float(header['CROTA2']))
        # FITS standard: PC = [[cos, -sin*l], [sin/l, cos]] with l = cdelt2/cdelt1
        lam = cdelt2 / cdelt1
        pc = np.array([[np.cos(rho), -np.sin(rho) * lam],
                       [np.sin(rho) / lam, np.cos(rho)]])
    else:
        pc = np.eye(2)

    x = np.arange(w, dtype=np.float64) + 1 - crpix1
    y = np.arange(h, dtype=np.float64) + 1 - crpix2
    dx, dy = np.meshgrid(x, y)
    tx = crval1 + cdelt1 * (pc[0, 0] * dx + pc[0, 1] * dy)
    ty = crval2 + cdelt2 * (pc[1, 0] * dx + pc[1, 1] * dy)
    return (tx * ARCSEC_TO_RAD).astype(np.float32), (ty * ARCSEC_TO_RAD).astype(np.float32)


def observer_header(lat_deg: float, lon_deg: float, dsun_rs: float,
                    time: datetime, resolution: int, wavelength: float,
                    fov_arcsec: float | None = None) -> dict:
    """Build a synthetic-observer FITS header (the inverse of parse_observer),
    matching the reference's frame_to_fits header reconstruction
    (evaluation/image_render.py:93-144)."""
    if fov_arcsec is None:
        # frame +/- 1.3 Rsun (matches core.geometry.fov_for_distance)
        fov_arcsec = 2 * np.rad2deg(np.arctan2(1.3, dsun_rs)) * 3600
    cdelt = fov_arcsec / resolution
    return {
        'DATE-OBS': time.strftime('%Y-%m-%dT%H:%M:%S.%f')[:-3],
        'CRLN_OBS': lon_deg, 'CRLT_OBS': lat_deg,
        'HGLT_OBS': lat_deg,
        'DSUN_OBS': dsun_rs * R_SUN_M,
        'CRPIX1': (resolution + 1) / 2, 'CRPIX2': (resolution + 1) / 2,
        'CRVAL1': 0.0, 'CRVAL2': 0.0,
        'CDELT1': cdelt, 'CDELT2': cdelt,
        'CUNIT1': 'arcsec', 'CUNIT2': 'arcsec',
        'CTYPE1': 'HPLN-TAN', 'CTYPE2': 'HPLT-TAN',
        'WAVELNTH': wavelength,
        'RSUN_REF': R_SUN_M,
    }
