"""Synthetic FITS views of a deployment bundle, for a training run that
needs no downloaded data: the bundle rendered by the port's loader from
config/render_simple_star.yaml's observers and written as 193 A FITS files
with observer headers, which the data layer reads like observed frames.
"""
from __future__ import annotations

import os
from datetime import datetime

import numpy as np

# config/render_simple_star.yaml's observers: (name, lat and lon in degrees,
# distance in solar radii, time)
OBSERVERS = (
    ('aia', 0.0, 0.0, 215.0, '2012-08-23T00:00:00'),
    ('aia', 2.0, 45.0, 215.0, '2012-08-23T06:00:00'),
    ('aia', -3.0, 90.0, 215.0, '2012-08-23T12:00:00'),
    ('euvia', 4.0, 135.0, 206.0, '2012-08-23T00:00:00'),
    ('euvia', 0.0, 180.0, 206.0, '2012-08-23T06:00:00'),
    ('euvib', -2.0, 225.0, 230.0, '2012-08-23T00:00:00'),
    ('euvib', 1.0, 270.0, 230.0, '2012-08-23T06:00:00'),
    ('euvib', 3.0, 315.0, 230.0, '2012-08-23T12:00:00'),
)
BUNDLE = 'artifacts_r4/s8_probe_rerun_best'


def synthesize_views(root: str, device, resolution: int = 256,
                     bundle: str = BUNDLE) -> str:
    """The bundle rendered from OBSERVERS by the port's loader, written as
    FITS (193 A) with the port's write_fits and observer_header under
    <root>/views/193. Each frame is written with its rows in the header's
    order (row 0 at the bottom: the loader's helioprojective_grid), the
    render's rows reversed, so that every pixel carries the ray it was
    rendered along. Returns the files' glob."""
    from sunerf_tpu_torch.data.fits import write_fits
    from sunerf_tpu_torch.data.wcs import observer_header
    from sunerf_tpu_torch.evaluation.loader import SuNeRFLoader
    loader = SuNeRFLoader(bundle, device=device)
    out = os.path.join(root, 'views', '193')
    os.makedirs(out)
    for i, (name, lat, lon, dist, when) in enumerate(OBSERVERS):
        t = datetime.fromisoformat(when)
        view = loader.render_observer_image(lat=np.deg2rad(lat), lon=np.deg2rad(lon), time=t,
                                            distance=dist, resolution=resolution)
        if not np.isfinite(view.image).all():
            raise RuntimeError(f'synthesized view {i} is not finite')
        write_fits(os.path.join(out, f'{name}_{i:03d}.{when}.193.fits'),
                   view.image[::-1, :, 0], observer_header(lat, lon, dist, t, resolution, 193.0))
    return os.path.join(out, '*.fits')
