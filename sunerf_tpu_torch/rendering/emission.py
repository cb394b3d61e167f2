"""Emission/absorption radiative-transfer head, one wavelength channel
(sunerf_tpu/rendering/emission.py:21-79).

The field outputs (log emission, absorption) per sample; pixel intensity is
the sum of per-sample emission attenuated by the exclusive cumulative product
of transmission:

  I = sum_i  exp(raw0_i) * dz_i * prod_{j<i} exp(-relu(raw1_j) * dz_j)

The sampling weights for the hierarchical pass are the normalized emerging
intensities.
"""
from __future__ import annotations

import dataclasses

import torch

from sunerf_tpu_torch.core.sampling import norm3
from sunerf_tpu_torch.models.fields import FieldOutput


def exclusive_cumprod(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """[1, x0, x0*x1, ...] along dim."""
    cp = torch.cumprod(x, dim=dim)
    ones = torch.ones_like(cp.narrow(dim, 0, 1))
    return torch.cat([ones, cp.narrow(dim, 0, x.shape[dim] - 1)], dim=dim)


def ray_deltas(z_vals: torch.Tensor, rays_d: torch.Tensor) -> torch.Tensor:
    """Line element dz per sample: consecutive z differences (first repeated)
    scaled by |rays_d|."""
    dists = z_vals[..., 1:] - z_vals[..., :-1]
    dists = torch.cat([dists[..., :1], dists], dim=-1)
    return dists * norm3(rays_d)[..., None]


@dataclasses.dataclass(frozen=True)
class EmissionHead:
    """Emission/absorption quadrature.

    Rs_per_ds: solar radii per model distance unit (regularization radius scale).
    """
    Rs_per_ds: float = 1.0

    def raw2outputs(self, field_out: FieldOutput, z_vals: torch.Tensor,
                    rays_o: torch.Tensor, rays_d: torch.Tensor,
                    query_points: torch.Tensor,
                    wavelengths: torch.Tensor | None = None) -> dict:
        raw = field_out.raw  # [R, S, 2]
        dists = ray_deltas(z_vals, rays_d)  # [R, S]

        intensity = torch.exp(raw[..., 0]) * dists
        transmission = torch.exp(-torch.clamp(raw[..., 1], min=0.0) * dists)
        total_absorption = exclusive_cumprod(transmission + 1e-10, dim=-1)

        emerging = intensity * total_absorption
        pixel_intensity = torch.sum(emerging, dim=-1, keepdim=True)  # [R, 1]
        weights = emerging / (torch.sum(emerging, dim=-1, keepdim=True) + 1e-10)

        return {'image': pixel_intensity, 'weights': weights,
                'regularizing_quantity': transmission}

    def regularization(self, distance: torch.Tensor,
                       regularizing_quantity: torch.Tensor) -> torch.Tensor:
        """Penalize absorption beyond 1.2 Rsun, elementwise [R, S]."""
        return (torch.clamp(distance - 1.2 / self.Rs_per_ds, min=0.0)
                * (1.0 - regularizing_quantity))
