"""Classical (non-ML) baseline: reproject observed full-disk maps to novel
viewpoints by assuming emission on the solar surface.

Native replacement for the reference's sunpy/reproject pipeline
(sunerf/baseline/reprojection.py:19-168): observed maps are merged into a
heliographic Carrington plate-carree map (create_heliographic_map equivalent)
and resampled to any observer (transform equivalent). Pure numpy: a copy of
sunerf_tpu/baseline/reprojection.py over the port's own geometry and WCS
modules (the port imports nothing of the JAX package).

Frame convention (matches core.geometry.pose_spherical): Carrington
(lat, lon) -> world xyz = (-cos(lat) sin(lon), cos(lat) cos(lon), -sin(lat)),
solar north = -z.
"""
from __future__ import annotations

import numpy as np

from sunerf_tpu_torch.core.geometry import pose_spherical
from sunerf_tpu_torch.data.wcs import helioprojective_grid, parse_observer


def carrington_to_world(lat, lon, r=1.0):
    """Carrington (lat, lon) [rad] -> world xyz."""
    return np.stack([-r * np.cos(lat) * np.sin(lon),
                     r * np.cos(lat) * np.cos(lon),
                     -r * np.sin(lat)], axis=-1)


def world_to_carrington(xyz):
    """world xyz -> (lat, lon) [rad], lon in [0, 2pi)."""
    r = np.linalg.norm(xyz, axis=-1)
    lat = np.arcsin(np.clip(-xyz[..., 2] / np.maximum(r, 1e-12), -1, 1))
    lon = np.arctan2(-xyz[..., 0], xyz[..., 1]) % (2 * np.pi)
    return lat, lon


def _bilinear(image, x, y, fill=np.nan):
    """Sample image[y, x] bilinearly at fractional pixel coords."""
    h, w = image.shape
    valid = (x >= 0) & (x <= w - 1) & (y >= 0) & (y <= h - 1)
    x = np.clip(x, 0, w - 1.0001)
    y = np.clip(y, 0, h - 1.0001)
    x0, y0 = np.floor(x).astype(int), np.floor(y).astype(int)
    fx, fy = x - x0, y - y0
    v = (image[y0, x0] * (1 - fx) * (1 - fy)
         + image[y0, x0 + 1] * fx * (1 - fy)
         + image[y0 + 1, x0] * (1 - fx) * fy
         + image[y0 + 1, x0 + 1] * fx * fy)
    return np.where(valid, v, fill)


def map_to_heliographic(data: np.ndarray, header, shape_out=(1024, 2048)):
    """Project one observed map onto the heliographic Carrington grid.

    Each heliographic cell is a point on the solar surface; if visible from
    the observer, it is projected into the image and bilinearly sampled.

    Returns (hmap [H, W], weight [H, W]) with NaN where not visible.
    """
    obs = parse_observer(header)
    h, w = shape_out
    lon = (np.arange(w) + 0.5) / w * 2 * np.pi
    lat = (np.arange(h) + 0.5) / h * np.pi - np.pi / 2
    lon_g, lat_g = np.meshgrid(lon, lat)
    surface = carrington_to_world(lat_g, lon_g)  # [H, W, 3] on unit sphere

    observer = carrington_to_world(obs.carrington_lat, obs.carrington_lon,
                                   obs.dsun_rs)
    # visibility: surface normal faces the observer
    to_obs = observer - surface
    visible = np.sum(surface * to_obs, axis=-1) > 0

    # helioprojective angles of the surface points as seen by this observer:
    # build the camera frame from the pose and invert the ray direction map.
    pose = pose_spherical(-obs.carrington_lon, obs.carrington_lat, obs.dsun_rs)
    R = pose[:3, :3]
    d_world = surface - observer
    d_cam = d_world @ R  # R^T applied from the right (R orthonormal)
    # camera convention (ray_sampling.py:15-17): x=sin(Tx),
    # y=-sin(Ty)cos(Tx), z=-cos(Tx)cos(Ty)
    norm = np.linalg.norm(d_cam, axis=-1)
    d_cam = d_cam / norm[..., None]
    tx = np.arcsin(np.clip(d_cam[..., 0], -1, 1))
    ty = -np.arcsin(np.clip(d_cam[..., 1] / np.maximum(np.cos(tx), 1e-9), -1, 1))

    # invert the linear WCS: pixel = crpix + (angle - crval)/cdelt
    tx_grid, ty_grid = helioprojective_grid(header, shape=data.shape)
    # linear fit (exact for PC=I): infer scale/offset from the grid corners
    dx = (tx_grid[0, -1] - tx_grid[0, 0]) / (data.shape[1] - 1)
    dy = (ty_grid[-1, 0] - ty_grid[0, 0]) / (data.shape[0] - 1)
    px = (tx - tx_grid[0, 0]) / dx
    py = (ty - ty_grid[0, 0]) / dy

    samp = _bilinear(data.astype(np.float64), px, py)
    samp = np.where(visible, samp, np.nan)
    weight = np.isfinite(samp).astype(np.float64)
    return samp, weight


def create_heliographic_map(maps: list, shape_out=(1024, 2048)) -> np.ndarray:
    """Merge (data, header) pairs into one Carrington map (mean coadd —
    reference create_heliographic_map, reprojection.py:52-95). NaN gaps are
    filled with the global mean, as upstream (reprojection.py:92)."""
    acc = np.zeros(shape_out)
    wacc = np.zeros(shape_out)
    for data, header in maps:
        samp, weight = map_to_heliographic(data, header, shape_out)
        acc += np.nan_to_num(samp, nan=0.0) * weight
        wacc += weight
    out = np.divide(acc, wacc, out=np.full(shape_out, np.nan), where=wacc > 0)
    if np.isnan(out).mean() > 0.5:
        import logging
        logging.warning('More than 50 percent of the heliographic map are NaNs!')
    return np.nan_to_num(out, nan=np.nanmean(out))


def heliographic_to_observer(hmap: np.ndarray, lat: float, lon: float,
                             distance: float, resolution: int = 256,
                             fov: float | None = None) -> np.ndarray:
    """Render the Carrington map as seen by an observer at (lat, lon) [rad]
    and the given distance [Rsun] (reference transform, reprojection.py:98-125).
    Off-disk pixels are NaN."""
    from sunerf_tpu_torch.core.geometry import fov_for_distance, observer_rays
    rays_o, rays_d = observer_rays(lat, lon, distance, resolution,
                                   fov=fov or fov_for_distance(distance))
    o = rays_o.reshape(-1, 3)
    d = rays_d.reshape(-1, 3)
    # nearest solar-surface intersection
    b = 2 * np.sum(o * d, axis=-1)
    c = np.sum(o * o, axis=-1) - 1.0
    disc = b * b - 4 * c
    hit = disc >= 0
    t = (-b - np.sqrt(np.maximum(disc, 0))) / 2
    pts = o + d * t[:, None]
    plat, plon = world_to_carrington(pts)

    h, w = hmap.shape
    px = plon / (2 * np.pi) * w - 0.5
    py = (plat + np.pi / 2) / np.pi * h - 0.5
    vals = _bilinear(hmap, px, py)
    vals = np.where(hit, vals, np.nan)
    return vals.reshape(resolution, resolution)


def transform(maps: list, lat: float, lon: float, distance: float,
              resolution: int = 256, shape_out=(1024, 2048)) -> np.ndarray:
    """Full baseline: merge observed maps -> Carrington -> novel view."""
    hmap = create_heliographic_map(maps, shape_out)
    return heliographic_to_observer(hmap, lat, lon, distance, resolution)
