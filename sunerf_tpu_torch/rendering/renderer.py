"""Rendering orchestrator: stratified (or spherical, or occupancy-guided)
sampling -> coarse field pass -> hierarchical resampling -> fine field pass
-> physics-head quadrature (sunerf_tpu/rendering/renderer.py), with the
opt-in adaptive per-ray tiers of the fine pass.

The tiers move rays by index (index_select, and the inverse permutation
by a scatter of the ranks) where the JAX package multiplies by one-hot
permutation matrices, the workaround for gathers on its chip: exact either
way, and no [R, R] matrix.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from sunerf_tpu_torch.core.occupancy import OccupancyConfig, occupancy_sample
from sunerf_tpu_torch.core.sampling import (hierarchical_sample, norm3, sample_pdf,
                                            spherical_sample, stratified_sample)
from sunerf_tpu_torch.models.fields import FieldOutput


@dataclasses.dataclass(frozen=True, eq=False)
class Renderer:
    """Volume renderer over a neural field.

    field_apply: (params, points [N, 4]) -> FieldOutput.
    head: physics quadrature (EmissionHead, DensityTemperatureHead,
        ThomsonHead).
    coarse_field_apply: optional separate apply for the coarse pass (a smaller
        proposal field); None = the fine architecture for both passes.
    """
    field_apply: Callable[[dict, torch.Tensor], FieldOutput]
    head: object
    coarse_field_apply: Optional[Callable] = None
    Rs_per_ds: float = 1.0
    n_stratified: int = 64
    n_hierarchical: int = 128
    sample_distance: float = 1.3
    sampling: str = 'stratified'  # 'stratified' | 'spherical'
    perturb: bool = True
    perturb_hierarchical: bool = False
    # opt-in occupancy-guided sampling (core/occupancy.py): when set AND the
    # params carry an 'occupancy' grid, the stratified pass concentrates its
    # samples into occupied space (off = reference parity)
    occupancy: Optional[OccupancyConfig] = None
    # opt-in adaptive per-ray budgets: in training (a generator given), the
    # tier_fraction dimmest rays, ranked by the coarse pass's brightness,
    # run the fine pass with only tier_samples samples drawn from the coarse
    # CDF; the bright rays keep the full stratified + hierarchical budget.
    # 0.0 = off (the reference evaluates every ray at the full budget)
    tier_fraction: float = 0.0
    tier_samples: int = 32
    # the tiers in generator=None (eval) passes too: opt-in for fast
    # full-disk and video renders (ModelLoader(tier=...)); off by default so
    # validation and deployment renders stay at the full budget
    tier_eval: bool = False
    # serializable description for checkpoint reconstruction (systems.from_spec)
    spec: Optional[dict] = None

    def __post_init__(self):
        if self.sampling not in _SAMPLERS:
            raise ValueError(f'Unknown sampling type {self.sampling}')
        # occupancy_sample probes the stratified sampler's [|o|-d, |o|+d]
        # bounds; beside another sampler it would change the integration
        # domain, not only the sample density
        if self.occupancy is not None and self.sampling != 'stratified':
            raise ValueError(
                f"occupancy-guided sampling assumes the stratified sampler's "
                f"integration bounds; got sampling={self.sampling!r}. Disable "
                f"occupancy or use sampling='stratified'.")
        if not 0.0 <= self.tier_fraction < 1.0:
            raise ValueError(f'tier_fraction must be in [0, 1), got '
                             f'{self.tier_fraction}')
        if self.tier_fraction and self.tier_samples < 4:
            raise ValueError('tier_samples must be >= 4')

    @property
    def solar_radius(self) -> float:
        return 1.0 / self.Rs_per_ds

    def _sample(self, rays_o, rays_d, generator, occupancy_grid=None):
        kwargs = dict(n_samples=self.n_stratified,
                      distance=self.sample_distance / self.Rs_per_ds,
                      solar_radius=self.solar_radius, generator=generator)
        if self.occupancy is not None and occupancy_grid is not None:
            return occupancy_sample(rays_o, rays_d, occupancy_grid, self.occupancy,
                                    **kwargs)
        return _SAMPLERS[self.sampling](rays_o, rays_d, **kwargs)

    def _render_pass(self, params, query_points_time, rays_o, rays_d, z_vals,
                     wavelengths, apply_fn=None):
        """Flatten query points, evaluate the field, run the head quadrature.
        Sample points carry no gradient: they come from data, the generator
        and detached resamples."""
        n_rays, n_samples = query_points_time.shape[:2]
        flat = query_points_time.reshape(-1, query_points_time.shape[-1]).detach()
        field_out = (apply_fn or self.field_apply)(params, flat)
        raw = field_out.raw.reshape(n_rays, n_samples, -1)
        field_out = FieldOutput(raw=raw, log_abs=field_out.log_abs,
                                vol_c=field_out.vol_c)
        return self.head.raw2outputs(field_out, z_vals, rays_o, rays_d,
                                     query_points_time[..., :3], wavelengths)

    def __call__(self, params: dict, rays_o: torch.Tensor, rays_d: torch.Tensor,
                 times: torch.Tensor, generator: Optional[torch.Generator] = None,
                 wavelengths: Optional[torch.Tensor] = None) -> dict:
        """Full coarse+fine forward pass.

        Args:
            params: {'coarse': dict, 'fine': dict} field parameters, and the
                occupancy grid under 'occupancy' when the renderer samples by
                one.
            rays_o, rays_d: [R, 3]; times: [R, 1] normalized observation times.
            generator: sampling jitter (None = deterministic, eval mode); a
                generator also selects the training pass, which takes the
                tiers when tier_fraction is set.
            wavelengths: [R, W] for multi-channel heads.

        Returns:
            dict with image, coarse_image, fine_image, height_map,
            absorption_map, regularization ([R, S], or [R] per-ray means
            under tiers), z_vals_stratified, z_vals_hierarchical.
        """
        strat = self._sample(rays_o, rays_d, generator if self.perturb else None,
                             params.get('occupancy'))
        z_vals = strat['z_vals']
        qpt = _with_time(strat['points'], times)

        coarse_out = self._render_pass(params['coarse'], qpt, rays_o, rays_d,
                                       z_vals, wavelengths,
                                       apply_fn=self.coarse_field_apply)

        if self.tier_fraction and (generator is not None or self.tier_eval):
            return self._tiered_fine(params, rays_o, rays_d, times, z_vals,
                                     coarse_out, generator, wavelengths)

        hier = hierarchical_sample(
            rays_o, rays_d, z_vals, coarse_out['weights'],
            n_samples=self.n_hierarchical,
            generator=generator if self.perturb_hierarchical else None)
        z_comb = hier['z_vals']
        qpt_fine = _with_time(hier['points'], times)

        fine_out = self._render_pass(params['fine'], qpt_fine, rays_o, rays_d,
                                     z_comb, wavelengths)

        distance = norm3(hier['points'])  # [R, S_fine]
        reg_q = fine_out['regularizing_quantity']
        outputs = {
            'image': fine_out['image'],
            'coarse_image': coarse_out['image'],
            'fine_image': fine_out['image'],
            'z_vals_stratified': z_vals,
            'z_vals_hierarchical': hier['new_z_samples'],
            'height_map': torch.sum(fine_out['weights'] * distance, dim=-1),
            'absorption_map': torch.sum(1.0 - reg_q, dim=-1),
            'regularization': self.head.regularization(distance, reg_q),
        }
        # propagate any extra head outputs
        for k, v in fine_out.items():
            if k not in ('image', 'weights', 'regularizing_quantity'):
                outputs.setdefault(k, v)
        return outputs

    def _tiered_fine(self, params, rays_o, rays_d, times, z_vals, coarse_out,
                     generator, wavelengths):
        """Adaptive per-ray budgets: the dim tier_fraction of the batch runs
        the fine pass at tier_samples samples, the bright rays at the full
        budget. The rays are ranked by the coarse pass's detached brightness
        with a stable argsort (JAX's is stable: rays off the disk tie), moved
        into rank order by index_select and back by the inverse permutation.
        Outputs come back in the original ray order, so the mean-over-rays
        loss keeps its form; regularization is each ray's mean (the tiers
        have different sample counts) and z_vals_hierarchical the bright
        tier's."""
        R = rays_o.shape[0]
        n_lo = int(round(R * self.tier_fraction))
        score = coarse_out['image'].detach().amax(dim=-1)
        order = torch.argsort(score, stable=True)  # dim rays first
        inverse = torch.empty_like(order).scatter_(
            0, order, torch.arange(R, device=order.device))
        take = lambda x: x.index_select(0, order)  # noqa: E731
        back = lambda x: x.index_select(0, inverse)  # noqa: E731

        rays_o_p, rays_d_p, times_p = take(rays_o), take(rays_d), take(times)
        z_p, w_p = take(z_vals), take(coarse_out['weights'])
        wl_p = take(wavelengths) if wavelengths is not None else None
        lo, hi = slice(0, n_lo), slice(n_lo, R)
        wl_lo = wl_p[lo] if wl_p is not None else None
        wl_hi = wl_p[hi] if wl_p is not None else None

        # bright tier: the full stratified + hierarchical budget
        hier = hierarchical_sample(
            rays_o_p[hi], rays_d_p[hi], z_p[hi], w_p[hi], n_samples=self.n_hierarchical,
            generator=generator if self.perturb_hierarchical else None)
        fine_hi = self._render_pass(params['fine'], _with_time(hier['points'], times_p[hi]),
                                    rays_o_p[hi], rays_d_p[hi], hier['z_vals'], wl_hi)

        # dim tier: tier_samples samples straight from the coarse CDF
        z_mid = 0.5 * (z_p[lo, 1:] + z_p[lo, :-1])
        z_lo = sample_pdf(z_mid, w_p[lo][..., 1:-1], self.tier_samples)
        z_lo = torch.sort(z_lo, dim=-1).values.detach()
        pts_lo = rays_o_p[lo, None, :] + rays_d_p[lo, None, :] * z_lo[..., :, None]
        fine_lo = self._render_pass(params['fine'], _with_time(pts_lo, times_p[lo]),
                                    rays_o_p[lo], rays_d_p[lo], z_lo, wl_lo)

        dist_lo, dist_hi = norm3(pts_lo), norm3(hier['points'])
        both = lambda a, b: back(torch.cat([a, b], dim=0))  # noqa: E731
        image = both(fine_lo['image'], fine_hi['image'])
        height = both(torch.sum(fine_lo['weights'] * dist_lo, dim=-1),
                      torch.sum(fine_hi['weights'] * dist_hi, dim=-1))
        absorption = both(torch.sum(1.0 - fine_lo['regularizing_quantity'], dim=-1),
                          torch.sum(1.0 - fine_hi['regularizing_quantity'], dim=-1))
        reg = both(
            torch.mean(self.head.regularization(dist_lo, fine_lo['regularizing_quantity']),
                       dim=-1),
            torch.mean(self.head.regularization(dist_hi, fine_hi['regularizing_quantity']),
                       dim=-1))
        return {
            'image': image,
            'coarse_image': coarse_out['image'],
            'fine_image': image,
            'z_vals_stratified': z_vals,
            'z_vals_hierarchical': hier['new_z_samples'],  # bright tier
            'height_map': height,
            'absorption_map': absorption,
            'regularization': reg,
        }

    def forward_points(self, params: dict, query_points: torch.Tensor) -> FieldOutput:
        """Direct field query for volume extraction. Always the FINE field:
        a proposal coarse field exists only to place samples."""
        flat = query_points.reshape(-1, query_points.shape[-1])
        return self.field_apply(params['fine'], flat)


_SAMPLERS = {'stratified': stratified_sample, 'spherical': spherical_sample}


def _with_time(points: torch.Tensor, times: torch.Tensor) -> torch.Tensor:
    """Append the per-ray time coordinate to [R, S, 3] sample points -> [R, S, 4]."""
    exp_times = times.reshape(times.shape[0], 1, 1).expand(
        points.shape[0], points.shape[1], 1)
    return torch.cat([points, exp_times.to(points.dtype)], dim=-1)
