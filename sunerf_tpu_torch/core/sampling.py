"""Ray sampling: stratified and hierarchical (sunerf_tpu/core/sampling.py).

The ray-sphere clip uses discriminant masking, and randomness comes from an
explicit torch.Generator (None = deterministic). The inverse CDF uses
torch.searchsorted + gather, the natural form on a GPU; for a sorted cdf
searchsorted-right equals the JAX package's comparison count.

Shapes: rays_o/rays_d [R, 3]; all z_vals [R, S] sorted ascending per ray.
"""
from __future__ import annotations

from typing import Optional

import torch


def dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis of three, as ((a0 b0 + a1 b1) + a2 b2): one
    IEEE rounding per operation in a fixed order, so CPU and GPU agree to the
    bit. The ray-sphere clip at 1 AU cancels ~5 digits of |o|^2, and a
    reduction that reorders or fuses those sums moves the far plane."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def norm3(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(dot3(x, x))


def _uniform(shape, like: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, dtype=like.dtype,
                   device=generator.device)
    return u.to(like.device)


def _ray_sphere_near_intersection(rays_o, rays_d, radius):
    """Distance along each ray to its first intersection with the sphere of the
    given radius centered at the origin. Returns (t_near, t_far, hit_mask)."""
    a = dot3(rays_d, rays_d)
    b = 2.0 * dot3(rays_o, rays_d)
    c = dot3(rays_o, rays_o) - radius ** 2
    disc = b * b - 4.0 * a * c
    hit = disc >= 0.0
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t_near = (-b - sq) / (2.0 * a)
    t_far = (-b + sq) / (2.0 * a)
    return t_near, t_far, hit


def _perturb_bins(z_vals: torch.Tensor, t_rand: torch.Tensor) -> torch.Tensor:
    """Move each z to t_rand of the way through its bin (bin edges are the
    midpoints between consecutive z values)."""
    mids = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
    upper = torch.cat([mids, z_vals[..., -1:]], dim=-1)
    lower = torch.cat([z_vals[..., :1], mids], dim=-1)
    return lower + (upper - lower) * t_rand


def stratified_sample(rays_o: torch.Tensor, rays_d: torch.Tensor,
                      n_samples: int = 64, distance: float = 1.3,
                      solar_radius: float = 1.0,
                      generator: Optional[torch.Generator] = None):
    """Uniform bins in [|o| - distance, |o| + distance] along each ray, with the
    far plane clipped to the solar-surface intersection where the ray hits the
    Sun. With a generator, each sample is jittered uniformly within its bin.

    Returns:
        dict(points=[R, S, 3], z_vals=[R, S]).
    """
    obs_distance = norm3(rays_o)
    t_inner, _, hit = _ray_sphere_near_intersection(rays_o, rays_d, solar_radius)
    near = obs_distance - distance
    far = torch.where(hit, t_inner, obs_distance + distance)

    t_vals = torch.linspace(0.0, 1.0, n_samples, dtype=rays_o.dtype,
                            device=rays_o.device)
    z_vals = near[:, None] * (1.0 - t_vals) + far[:, None] * t_vals
    if generator is not None:
        z_vals = _perturb_bins(z_vals, _uniform(z_vals.shape, z_vals, generator))
    points = rays_o[..., None, :] + rays_d[..., None, :] * z_vals[..., :, None]
    return {'points': points, 'z_vals': z_vals}


def spherical_sample(rays_o: torch.Tensor, rays_d: torch.Tensor,
                     n_samples: int = 64, distance: float = 2.0,
                     solar_radius: float = 1.0,
                     generator: Optional[torch.Generator] = None):
    """Uniform bins between the entry and exit of a bounding sphere of the
    given radius, the far plane clipped at the solar surface (reference
    SphericalSampler, sampling.py:4-54). A ray that misses the bounding
    sphere collapses to a zero-length segment at its closest approach (NaN
    in the reference). With a generator, each sample is jittered uniformly
    within its bin.

    Returns:
        dict(points=[R, S, 3], z_vals=[R, S]).
    """
    t_near_b, t_far_b, hit_b = _ray_sphere_near_intersection(rays_o, rays_d, distance)
    t_inner, _, hit_s = _ray_sphere_near_intersection(rays_o, rays_d, solar_radius)
    t_mid = -dot3(rays_o, rays_d) / dot3(rays_d, rays_d)
    near = torch.where(hit_b, t_near_b, t_mid)
    far = torch.where(hit_s, t_inner, torch.where(hit_b, t_far_b, t_mid))

    t_vals = torch.linspace(0.0, 1.0, n_samples, dtype=rays_o.dtype,
                            device=rays_o.device)
    z_vals = near[:, None] * (1.0 - t_vals) + far[:, None] * t_vals
    if generator is not None:
        z_vals = _perturb_bins(z_vals, _uniform(z_vals.shape, z_vals, generator))
    points = rays_o[..., None, :] + rays_d[..., None, :] * z_vals[..., :, None]
    return {'points': points, 'z_vals': z_vals}


def _invert_cdf(bins: torch.Tensor, weights: torch.Tensor,
                u: torch.Tensor) -> torch.Tensor:
    """Positions [R, n] where the piecewise-linear CDF of (bins [R, M+1],
    weights [R, M]) reaches the levels u [R, n]."""
    pdf = (weights + 1e-5) / torch.sum(weights + 1e-5, dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)  # [R, M+1]

    # index i such that cdf[i-1] <= u < cdf[i]
    inds = torch.searchsorted(cdf.contiguous(), u.contiguous(), right=True)
    m = cdf.shape[-1]
    below = torch.clamp(inds - 1, 0, m - 1)
    above = torch.clamp(inds, 0, m - 1)
    cdf_below = torch.gather(cdf, -1, below)
    cdf_above = torch.gather(cdf, -1, above)
    bins_below = torch.gather(bins, -1, below)
    bins_above = torch.gather(bins, -1, above)

    denom = cdf_above - cdf_below
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_below) / denom
    return bins_below + t * (bins_above - bins_below)


def sample_pdf(bins: torch.Tensor, weights: torch.Tensor, n_samples: int,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Inverse-CDF sampling of the piecewise PDF defined by (bins, weights).

    Args:
        bins: [R, M+1] bin centers.
        weights: [R, M] non-negative weights.
        n_samples: number of samples to draw per ray.
        generator: stratified uniform draws (one jittered draw per 1/n
            stratum) when given; else linspace(0, 1).

    Returns:
        [R, n_samples] sample positions.
    """
    shape = (*bins.shape[:-1], n_samples)
    if generator is None:
        u = torch.linspace(0.0, 1.0, n_samples, dtype=bins.dtype,
                           device=bins.device).expand(shape)
    else:
        strata = torch.arange(n_samples, dtype=bins.dtype, device=bins.device)
        u = (strata + _uniform(shape, bins, generator)) / n_samples
    return _invert_cdf(bins, weights, u)


def hierarchical_sample(rays_o: torch.Tensor, rays_d: torch.Tensor,
                        z_vals: torch.Tensor, weights: torch.Tensor,
                        n_samples: int = 128,
                        generator: Optional[torch.Generator] = None):
    """Resample along rays from the coarse-pass weight distribution. The new
    samples carry no gradient.

    Returns:
        dict(points=[R, S+n, 3], z_vals=[R, S+n], new_z_samples=[R, n]).
    """
    z_mid = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
    new_z = sample_pdf(z_mid, weights[..., 1:-1], n_samples,
                       generator=generator).detach()

    z_combined, _ = torch.sort(torch.cat([z_vals, new_z], dim=-1), dim=-1)
    points = rays_o[..., None, :] + rays_d[..., None, :] * z_combined[..., :, None]
    return {'points': points, 'z_vals': z_combined, 'new_z_samples': new_z}
