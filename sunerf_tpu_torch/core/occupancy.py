"""Factorized occupancy grid for empty-space skipping, opt-in
(sunerf_tpu/core/occupancy.py).

The grid is a radial profile occ_r [Nr], an angular map occ_ang [Nt, Np],
each the running max of cell activity over its other coordinates, and a
coarse full-3D volume occ_vol [nvol] (16x8x16 at the defaults). The estimate
at a point is min(occ_r, occ_ang, occ_vol), an upper bound of the cell's
true occupancy, so occupied space is never culled; the volume factor culls
what the separable factors cannot (a thin full shell plus a compact
streamer at high r lights every radial and every angular cell).

The sampler keeps the stratified sampler's [near, far] bounds and sorted z
values: occupancy reshapes only the sample density, through the inverse
CDF, and a pdf floor keeps every bin reachable. The update evaluates the
field at one jittered point per cell, laid out cell by cell, so the per-axis
maxima are axis reductions.

Against the JAX package: its one-hot contractions (table lookups as MXU
matvecs, the workaround for gathers on its chip) are index gathers here,
exact either way; its uniforms come from a jax.random key, these from a
torch.Generator (or are passed in, as the parity tests pass JAX's). The
grid lives in params['occupancy'] as tensors without gradients, which the
optimizer never sees (train/step.create_train_state).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from sunerf_tpu_torch.core.sampling import (_ray_sphere_near_intersection, norm3,
                                            sample_pdf)


@dataclasses.dataclass(frozen=True)
class OccupancyConfig:
    """Static occupancy-grid configuration. Radii are in solar radii;
    converted with Rs_per_ds (solar_radius) at the call sites."""
    nr: int = 64            # radial shells over [r_min, r_max]
    ntheta: int = 16        # colatitude cells over [0, pi]
    nphi: int = 32          # longitude cells over [-pi, pi]
    r_min: float = 1.0      # inner radius (solar surface) [Rsun]
    r_max: float = 1.3      # outer radius of the occupied volume [Rsun]
    nvol: Optional[tuple] = None  # coarse 3D volume factor dims (r, theta,
                                  # phi); each must divide (nr, ntheta,
                                  # nphi). None: ~(nr/4, nt/2, np/2) snapped
                                  # to divisors (16x8x16 at the defaults)
    n_probe: int = 64       # occupancy probes per ray feeding the CDF
    floor: float = 0.02     # pdf floor: minimum relative density everywhere
    decay: float = 0.97     # EMA-max decay per update
    threshold: float = 0.05  # occupied if activity > threshold * robust max
                             # (the 99.5th-percentile activity)
    update_every: int = 16  # the Trainer updates the grid every N steps
    warmup: int = 500       # steps before the first update

    def __post_init__(self):
        if self.nvol is None:
            # gcd snaps the ~(1/4, 1/2, 1/2) targets to exact divisors for
            # any grid dims (gcd(d, 0) = d covers tiny test grids)
            auto = (math.gcd(self.nr, self.nr // 4),
                    math.gcd(self.ntheta, self.ntheta // 2),
                    math.gcd(self.nphi, self.nphi // 2))
            object.__setattr__(self, 'nvol', auto)
        nvr, nvt, nvp = self.nvol
        if self.nr % nvr or self.ntheta % nvt or self.nphi % nvp:
            raise ValueError(
                f'nvol {self.nvol} must divide (nr, ntheta, nphi) = '
                f'({self.nr}, {self.ntheta}, {self.nphi})')


def init_occupancy(config: OccupancyConfig, device='cuda') -> dict:
    """The fully occupied grid. occupancy_sample reads this warm state as an
    exactly uniform pdf over [near, far] (the stratified density everywhere,
    beyond r_max too) until the first update."""
    ones = lambda *shape: torch.ones(shape, dtype=torch.float32, device=device)  # noqa: E731
    return {'occ_r': ones(config.nr), 'occ_ang': ones(config.ntheta, config.nphi),
            'occ_vol': ones(*config.nvol)}


def occupancy_at(grid: dict, config: OccupancyConfig, points: torch.Tensor,
                 solar_radius: float = 1.0) -> torch.Tensor:
    """Occupancy estimate in [0, 1] at [..., 3] spatial points (model units;
    solar_radius = 1/Rs_per_ds scales the grid's radii into model units):
    0 above r_max, 1 below r_min."""
    r_min = config.r_min * solar_radius
    r_max = config.r_max * solar_radius
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    r = torch.sqrt(x * x + y * y + z * z)

    dr = (r_max - r_min) / config.nr
    ir = torch.clamp(torch.floor((r - r_min) / dr), 0, config.nr - 1).long()
    theta = torch.arccos(torch.clamp(z / torch.clamp(r, min=1e-12), -1.0, 1.0))
    phi = torch.arctan2(y, x)
    it = torch.clamp((theta / (math.pi / config.ntheta)).long(), 0, config.ntheta - 1)
    ip = torch.clamp(((phi + math.pi) / (2 * math.pi / config.nphi)).long(),
                     0, config.nphi - 1)
    occ = torch.minimum(grid['occ_r'][ir], grid['occ_ang'][it, ip])
    if 'occ_vol' in grid:  # absent in grids from pre-vol checkpoints
        vol = grid['occ_vol']
        nvr, nvt, nvp = vol.shape
        occ = torch.minimum(occ, vol[ir // (config.nr // nvr), it // (config.ntheta // nvt),
                                     ip // (config.nphi // nvp)])
    # outside the modeled shell: empty above r_max, solid below r_min (rays
    # are far-clipped at the surface; never cull numerically-inside points)
    zero, one = occ.new_zeros(()), occ.new_ones(())
    return torch.where(r > r_max, zero, torch.where(r < r_min, one, occ))


def occupancy_pdf(rays_o: torch.Tensor, rays_d: torch.Tensor, grid: dict,
                  config: OccupancyConfig, distance: float,
                  solar_radius: float) -> tuple:
    """The stratified sampler's [near, far] bounds cut into n_probe bins,
    and the bins' pdf from the occupancy at their midpoints:
    (edges [R, n_probe + 1], pdf [R, n_probe]). The warm (fully occupied)
    grid gives an exactly uniform pdf; otherwise occupancy + floor."""
    obs_distance = norm3(rays_o)
    t_inner, _, hit = _ray_sphere_near_intersection(rays_o, rays_d, solar_radius)
    near = obs_distance - distance
    far = torch.where(hit, t_inner, obs_distance + distance)

    edges_t = torch.linspace(0.0, 1.0, config.n_probe + 1, dtype=rays_o.dtype,
                             device=rays_o.device)
    edges = near[:, None] * (1.0 - edges_t) + far[:, None] * edges_t  # [R, M+1]
    mids = 0.5 * (edges[:, 1:] + edges[:, :-1])                      # [R, M]
    probe_pts = rays_o[:, None, :] + rays_d[:, None, :] * mids[..., None]
    occ = occupancy_at(grid, config, probe_pts, solar_radius)

    # the warm grid samples uniformly over the whole span (occ is 0 beyond
    # r_max by construction, which would down-weight off-limb segments
    # ~1/floor before the first update); decided on the device, no sync
    warm = (torch.amin(grid['occ_r']) >= 1.0) & (torch.amin(grid['occ_ang']) >= 1.0)
    if 'occ_vol' in grid:
        warm = warm & (torch.amin(grid['occ_vol']) >= 1.0)
    pdf = torch.where(warm, torch.ones_like(occ), occ + config.floor)
    return edges, pdf


def occupancy_sample(rays_o: torch.Tensor, rays_d: torch.Tensor, grid: dict,
                     config: OccupancyConfig, n_samples: int, distance: float,
                     solar_radius: float,
                     generator: Optional[torch.Generator] = None) -> dict:
    """Occupancy-guided stratified sampling: n_samples drawn by inverse CDF
    from occupancy_pdf (stratified jitter from the generator, or linspace
    without one), sorted, without gradient.

    Returns dict(points=[R, S, 3], z_vals=[R, S]), stratified_sample's
    contract."""
    edges, pdf = occupancy_pdf(rays_o, rays_d, grid, config, distance, solar_radius)
    z_vals = sample_pdf(edges, pdf, n_samples, generator=generator)
    z_vals = torch.sort(z_vals, dim=-1).values.detach()
    points = rays_o[..., None, :] + rays_d[..., None, :] * z_vals[..., :, None]
    return {'points': points, 'z_vals': z_vals}


def cell_points(config: OccupancyConfig, uniforms: torch.Tensor, time,
                solar_radius: float = 1.0) -> torch.Tensor:
    """One point per grid cell, jittered within it by uniforms [Nr, Nt, Np,
    3], cell-ordered: [Nr * Nt * Np, 4] (x, y, z, time)."""
    nr, nt, npp = config.nr, config.ntheta, config.nphi
    r_min = config.r_min * solar_radius
    r_max = config.r_max * solar_radius
    u = uniforms
    ar = lambda n: torch.arange(n, device=u.device)  # noqa: E731
    r = r_min + (ar(nr)[:, None, None] + u[..., 0]) * (r_max - r_min) / nr
    theta = (ar(nt)[None, :, None] + u[..., 1]) * math.pi / nt
    phi = -math.pi + (ar(npp)[None, None, :] + u[..., 2]) * 2 * math.pi / npp
    st = torch.sin(theta)
    xyz = torch.stack([r * st * torch.cos(phi), r * st * torch.sin(phi),
                       r * torch.cos(theta)], dim=-1)
    t = torch.as_tensor(time, dtype=xyz.dtype).reshape(-1)[:1].to(u.device)
    t = t.expand(nr, nt, npp)
    return torch.cat([xyz, t[..., None]], dim=-1).reshape(-1, 4)


def cell_activity(config: OccupancyConfig, field_apply, params, activity_fn,
                  uniforms: torch.Tensor, time, solar_radius: float = 1.0) -> torch.Tensor:
    """The field's activity at cell_points, [Nr, Nt, Np] (no gradient)."""
    pts = cell_points(config, uniforms, time, solar_radius)
    with torch.no_grad():
        raw = field_apply(params, pts).raw
    return activity_fn(raw.reshape(config.nr, config.ntheta, config.nphi, -1))


def occupancy_from_activity(grid: dict, config: OccupancyConfig,
                            act: torch.Tensor) -> dict:
    """The EMA-max update from a cell activity [Nr, Nt, Np]: a cell is
    occupied if its activity exceeds threshold x the 99.5th-percentile
    activity (a robust max: against the mean a dominant dim background could
    never be culled; against the raw max one hot cell could cull the
    scene); each factor decays toward empty and is refreshed by the max of
    its cells. torch.quantile's linear interpolation is jnp.percentile's."""
    nr, nt, npp = config.nr, config.ntheta, config.nphi
    robust_max = torch.quantile(act.reshape(-1), 0.995)
    occupied = (act > config.threshold * robust_max).float()
    out = {'occ_r': torch.maximum(grid['occ_r'] * config.decay, occupied.amax(dim=(1, 2))),
           'occ_ang': torch.maximum(grid['occ_ang'] * config.decay, occupied.amax(dim=0))}
    if 'occ_vol' in grid:
        nvr, nvt, nvp = grid['occ_vol'].shape
        # block-max pooling: the cell-ordered layout makes it a reshape and
        # axis reductions
        pooled = occupied.reshape(nvr, nr // nvr, nvt, nt // nvt,
                                  nvp, npp // nvp).amax(dim=(1, 3, 5))
        out['occ_vol'] = torch.maximum(grid['occ_vol'] * config.decay, pooled)
    return out


def update_occupancy(grid: dict, config: OccupancyConfig, field_apply, params,
                     activity_fn, generator: Optional[torch.Generator], time,
                     solar_radius: float = 1.0,
                     uniforms: Optional[torch.Tensor] = None) -> dict:
    """One EMA-max update of the grid from the (fine) field, evaluated at one
    jittered point per cell: the jitter is `uniforms` [Nr, Nt, Np, 3] when
    given, else drawn from the generator. activity_fn maps the field's raw
    output [..., C] to a nonnegative activity (the heads'
    occupancy_activity). Returns the new grid (new tensors)."""
    if uniforms is None:
        shape = (config.nr, config.ntheta, config.nphi, 3)
        uniforms = torch.rand(shape, generator=generator,
                              device=generator.device).to(grid['occ_r'].device)
    act = cell_activity(config, field_apply, params, activity_fn, uniforms, time,
                        solar_radius)
    return occupancy_from_activity(grid, config, act)
