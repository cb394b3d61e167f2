"""Camera pose and ray geometry for heliographic observers — a copy of the
numpy-only sunerf_tpu/core/geometry.py:24-146 (the port imports nothing of
the JAX package).

An observer at Carrington (lat, lon, distance) looks at the Sun's center;
pixel directions come from helioprojective angles (Tx, Ty) with the central
pixel looking down -z in camera frame. Host-side numpy: poses and ray bundles
are built once per image and uploaded to the device by the caller.
"""
from __future__ import annotations

import numpy as np

# Axis-swap that maps the NeRF-convention camera frame into the heliographic
# frame used by the data pipeline.
_AXIS_SWAP = np.array(
    [[-1.0, 0.0, 0.0, 0.0],
     [0.0, 0.0, 1.0, 0.0],
     [0.0, 1.0, 0.0, 0.0],
     [0.0, 0.0, 0.0, 1.0]], dtype=np.float32)


def _trans_t(t: float) -> np.ndarray:
    m = np.eye(4, dtype=np.float32)
    m[2, 3] = t
    return m


def _rot_phi(phi: float) -> np.ndarray:
    c, s = np.cos(phi), np.sin(phi)
    m = np.eye(4, dtype=np.float32)
    m[1, 1], m[1, 2] = c, -s
    m[2, 1], m[2, 2] = s, c
    return m


def _rot_theta(th: float) -> np.ndarray:
    c, s = np.cos(th), np.sin(th)
    m = np.eye(4, dtype=np.float32)
    m[0, 0], m[0, 2] = c, -s
    m[2, 0], m[2, 2] = s, c
    return m


def pose_spherical(theta: float, phi: float, radius: float,
                   shift: tuple[float, float, float] | None = None) -> np.ndarray:
    """Camera-to-world matrix for an observer at spherical angles (theta, phi)
    and the given radius, looking at the origin.

    Args:
        theta: longitude-like angle [rad] (callers pass -lon here).
        phi: latitude-like angle [rad].
        radius: observer distance in model units (solar radii / Rs_per_ds).
        shift: optional (tx, ty, tz) world-frame translation.

    Returns:
        [4, 4] float32 camera-to-world matrix.
    """
    c2w = _trans_t(float(radius))
    c2w = _rot_phi(float(phi)) @ c2w
    c2w = _rot_theta(float(theta)) @ c2w
    c2w = _AXIS_SWAP @ c2w
    if shift is not None:
        m = np.eye(4, dtype=np.float32)
        m[:3, 3] = np.asarray(shift, dtype=np.float32)
        c2w = m @ c2w
    return c2w.astype(np.float32)


def spherical_to_cartesian(r, lat, lon):
    """(r, lat, lon) [rad] -> cartesian xyz."""
    return np.stack([r * np.cos(lat) * np.cos(lon),
                     r * np.cos(lat) * np.sin(lon),
                     r * np.sin(lat)], axis=-1)


def helioprojective_directions(tx, ty):
    """Unit direction vectors in camera frame from helioprojective angles [rad].
    The central pixel (Tx=Ty=0) looks down (0, 0, -1)."""
    x = np.sin(tx)
    y = -np.sin(ty) * np.cos(tx)
    z = -np.cos(tx) * np.cos(ty)
    return np.stack([x, y, z], axis=-1).astype(np.float32)


def get_rays(tx: np.ndarray, ty: np.ndarray, c2w: np.ndarray):
    """Ray origins and directions through every pixel.

    Args:
        tx, ty: helioprojective angles [rad], any shape [...].
        c2w: [4, 4] camera-to-world matrix.

    Returns:
        rays_o, rays_d: [..., 3] float32. Directions are unit-norm (rotation of
        unit vectors); origin is the camera optical center tiled to pixel shape.
    """
    directions = helioprojective_directions(tx, ty)  # [..., 3]
    # rays_d[..., i] = sum_j directions[..., j] * c2w[i, j]
    rays_d = np.einsum('...j,ij->...i', directions, c2w[:3, :3]).astype(np.float32)
    rays_o = np.broadcast_to(c2w[:3, -1], rays_d.shape).astype(np.float32)
    return np.ascontiguousarray(rays_o), rays_d


def camera_angle_grid(resolution: int, fov: float):
    """Square helioprojective angle grid spanning [-fov/2, fov/2] radians.
    Tx varies along image x (fastest axis), Ty along image y, flipped so that
    y increases upward as in FITS images. Returns (tx, ty) each
    [resolution, resolution]."""
    half = fov / 2.0
    v = np.linspace(-half, half, resolution, dtype=np.float32)
    tx, ty = np.meshgrid(v, v[::-1], indexing='xy')
    return tx.astype(np.float32), ty.astype(np.float32)


def fov_for_distance(distance: float, extent_rs: float = 1.3) -> float:
    """Field of view [rad] so the image spans +/- extent_rs solar radii at the
    Sun (the stratified sampler extends 1.3 Rs around the Sun)."""
    return 2.0 * float(np.arctan2(extent_rs, distance))


def observer_rays(lat: float, lon: float, distance: float, resolution: int,
                  fov: float | None = None):
    """Full ray bundle for a synthetic observer at Carrington (lat, lon) [rad],
    posed as pose_spherical(-lon, lat, distance).

    Returns rays_o, rays_d each [resolution, resolution, 3].
    """
    if fov is None:
        fov = fov_for_distance(distance)
    c2w = pose_spherical(-lon, lat, distance)
    tx, ty = camera_angle_grid(resolution, fov)
    return get_rays(tx, ty, c2w)
