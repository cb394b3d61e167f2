"""Rendering orchestrator: stratified (or spherical) sampling -> coarse field pass ->
hierarchical resampling -> fine field pass -> physics-head quadrature
(sunerf_tpu/rendering/renderer.py).

Adaptive per-ray tiers are not ported yet: a renderer that asks for them
raises (as the system factories do for occupancy-guided sampling).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from sunerf_tpu_torch.core.sampling import (hierarchical_sample, norm3,
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
    # adaptive per-ray tiers: bundles carry these keys; only 0.0 (off) runs
    tier_fraction: float = 0.0
    tier_samples: int = 32
    # serializable description for checkpoint reconstruction (systems.from_spec)
    spec: Optional[dict] = None

    def __post_init__(self):
        if self.sampling not in _SAMPLERS:
            raise ValueError(f'Unknown sampling type {self.sampling}')
        if not 0.0 <= self.tier_fraction < 1.0:
            raise ValueError(f'tier_fraction must be in [0, 1), got '
                             f'{self.tier_fraction}')
        if self.tier_fraction:
            raise NotImplementedError('adaptive per-ray tiers are not ported '
                                      'yet (ROADMAP Queue 1, opt-in dials: '
                                      'tiered fine pass)')

    @property
    def solar_radius(self) -> float:
        return 1.0 / self.Rs_per_ds

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
            params: {'coarse': dict, 'fine': dict} field parameters.
            rays_o, rays_d: [R, 3]; times: [R, 1] normalized observation times.
            generator: sampling jitter (None = deterministic, eval mode).
            wavelengths: [R, W] for multi-channel heads.

        Returns:
            dict with image, coarse_image, fine_image, height_map,
            absorption_map, regularization, z_vals_stratified,
            z_vals_hierarchical.
        """
        strat = _SAMPLERS[self.sampling](
            rays_o, rays_d, n_samples=self.n_stratified,
            distance=self.sample_distance / self.Rs_per_ds,
            solar_radius=self.solar_radius,
            generator=generator if self.perturb else None)
        z_vals = strat['z_vals']
        qpt = _with_time(strat['points'], times)

        coarse_out = self._render_pass(params['coarse'], qpt, rays_o, rays_d,
                                       z_vals, wavelengths,
                                       apply_fn=self.coarse_field_apply)

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
