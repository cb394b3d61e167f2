"""Thomson-scattering head for white-light (coronagraph) total and polarized
brightness (sunerf_tpu/rendering/thomson.py).

Physics (Howard & Tappin 2009, eqs. 23/24/29; reference
sunerf/rendering/thompson.py:7-109): the field outputs log10 electron density;
per-sample scattering intensities use the geometric coefficient functions
A, B, C, D of the half-angular solar width omega, with limb-darkening u=0.63.
Plain PyTorch: the JAX package computes this head in XLA.
"""
from __future__ import annotations

import dataclasses

import torch

from sunerf_tpu_torch.core.sampling import norm3
from sunerf_tpu_torch.models.fields import FieldOutput
from sunerf_tpu_torch.rendering.emission import ray_deltas


def _scrub(x: torch.Tensor) -> torch.Tensor:
    """|x| with NaN and infinities set to 0: negative intensities are
    unphysical (thompson.py:76-84)."""
    return torch.nan_to_num(torch.abs(x), nan=0.0, posinf=0.0, neginf=0.0)


@dataclasses.dataclass(frozen=True)
class ThomsonHead:
    Rs_per_ds: float = 1.0
    limb_darkening: float = 0.63
    C_0: float = 1.0
    d_output: int = 2

    def raw2outputs(self, field_out: FieldOutput, z_vals: torch.Tensor,
                    rays_o: torch.Tensor, rays_d: torch.Tensor,
                    query_points: torch.Tensor,
                    wavelengths: torch.Tensor | None = None) -> dict:
        """image [R, 2] (total and polarized brightness), weights [R, S], and
        the density-weighted pixel_density, distance_from_sun and
        distance_from_obs [R]."""
        raw = field_out.raw
        dists = ray_deltas(z_vals, rays_d)                   # [R, S]
        rho = torch.pow(10.0, raw[..., 0])                  # electron density [R, S]

        solar_radius = 1.0 / self.Rs_per_ds
        s_q = norm3(query_points[..., :3])                  # Sun-to-point [R, S]
        # clamp: points inside the Sun would give |sin| > 1
        sin_omega = torch.clamp(solar_radius / torch.clamp(s_q, min=1e-6), 0.0, 1.0 - 1e-6)
        omega = torch.asin(sin_omega)
        cos_omega = torch.cos(omega)

        z = z_vals * norm3(rays_d)[:, None]                 # observer distance

        # sin^2(chi): chi = angle between line of sight and the Sun-to-point vector
        cross = torch.linalg.cross(rays_o, rays_d, dim=-1)
        sin_chi2 = torch.sum(cross * cross, dim=-1)[:, None] / (s_q ** 2)

        u = self.limb_darkening
        ln = torch.log((1.0 + sin_omega) / cos_omega)
        cos2_sin = cos_omega ** 2 / sin_omega
        A = cos_omega * sin_omega ** 2
        B = -(1.0 / 8.0) * (1.0 - 3.0 * sin_omega ** 2
                            - cos2_sin * (1.0 + 3.0 * sin_omega ** 2) * ln)
        C = 4.0 / 3.0 - cos_omega - cos_omega ** 3 / 3.0
        D = (1.0 / 8.0) * (5.0 + sin_omega ** 2
                           - cos2_sin * (5.0 - sin_omega ** 2) * ln)

        intensity_T = (1.0 - u) * C + u * D
        intensity_pB = sin_chi2 * ((1.0 - u) * A + u * B)
        intensity_tB = _scrub(2.0 * intensity_T - intensity_pB)
        intensity_pB = _scrub(intensity_pB)

        point_tB = (self.C_0 * rho) * intensity_tB * dists
        point_pB = (self.C_0 * rho) * intensity_pB * dists
        pixel_B = torch.stack([torch.sum(point_tB, dim=-1),
                               torch.sum(point_pB, dim=-1)], dim=-1)  # [R, 2]

        rho_sum = torch.sum(rho, dim=1, keepdim=True)
        pixel_density = torch.sum(rho * dists, dim=1)
        distance_from_sun = torch.sum(rho * s_q, dim=1) / (rho_sum[:, 0] + 1e-10)
        distance_from_obs = torch.sum(rho * z, dim=1) / (rho_sum[:, 0] + 1e-10)
        weights = rho / (rho_sum + 1e-10)

        return {'image': pixel_B, 'weights': weights,
                'regularizing_quantity': torch.zeros_like(rho),
                'pixel_density': pixel_density,
                'distance_from_sun': distance_from_sun,
                'distance_from_obs': distance_from_obs}

    def occupancy_activity(self, raw: torch.Tensor) -> torch.Tensor:
        """Electron density drives the scattered brightness."""
        return torch.pow(10.0, raw[..., 0])

    def regularization(self, distance: torch.Tensor,
                       regularizing_quantity: torch.Tensor) -> torch.Tensor:
        # the reference defines no Thomson regularizer
        return torch.zeros_like(distance)
