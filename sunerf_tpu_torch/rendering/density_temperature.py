"""Density-temperature radiative-transfer head, all AIA channels at once
(sunerf_tpu/rendering/density_temperature.py).

The field outputs (log density, log10 temperature); per-wavelength intensity is

  I_wl = vol_c * pif * trapz( exp(-cumtrapz(rho * kappa_wl, z)) * rho^2 * R_wl(logT), z )

with rho = exp(relu(raw0)), logT = relu(raw1), kappa_wl = relu(log_abs[wl]) and
R_wl the AIA temperature-response function. The quadrature runs over the sample
axis with trapezoid rules; hierarchical sampling weights are normalized
relu(log density), or with hierarchical_weighting='emission' the attenuated
integrand. Each ray's wavelengths pick their channels by index
(ops/tresp.py); an absent channel (wavelength 0) renders exactly 0. The
integrals use raw z_vals in model units, compensated by
pixel_intensity_factor, as the reference does. Plain PyTorch: the JAX
package computes this head in XLA, outside its kernels.
"""
from __future__ import annotations

import dataclasses

import torch

from sunerf_tpu_torch.models.fields import FieldOutput
from sunerf_tpu_torch.ops.tresp import TemperatureResponse


def cumtrapz(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Cumulative trapezoid of y over x along the sample axis.
    y: [R, S, W], x: [R, S] -> [R, S-1, W]."""
    dx = (x[:, 1:] - x[:, :-1])[..., None]
    return torch.cumsum(0.5 * (y[:, 1:] + y[:, :-1]) * dx, dim=1)


def trapz(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Trapezoid integral of y over x along the sample axis.
    y: [R, S, W], x: [R, S] -> [R, W]."""
    dx = (x[:, 1:] - x[:, :-1])[..., None]
    return torch.sum(0.5 * (y[:, 1:] + y[:, :-1]) * dx, dim=1)


@dataclasses.dataclass(frozen=True, eq=False)
class DensityTemperatureHead:
    """Multi-channel EUV synthesis through AIA temperature responses.

    response: shared-grid response table (ops/tresp.py), on the renderer's
        device.
    pixel_intensity_factor: output scale (1e17 for a trained DT field, 1e10
        for SimpleStar; systems.py).
    Rs_per_ds: solar radii per model distance unit.
    hierarchical_weighting: 'density' (reference parity) or 'emission'.
    """
    response: TemperatureResponse
    pixel_intensity_factor: float = 1e10
    Rs_per_ds: float = 1.0
    d_output: int = 2
    hierarchical_weighting: str = 'density'

    def raw2outputs(self, field_out: FieldOutput, z_vals: torch.Tensor,
                    rays_o: torch.Tensor, rays_d: torch.Tensor,
                    query_points: torch.Tensor,
                    wavelengths: torch.Tensor) -> dict:
        """
        Args:
            field_out: raw [R, S, 2] + log_abs [C] + vol_c scalar.
            z_vals: [R, S] sample positions along rays (model units).
            wavelengths: [R, W] wavelength values (0 = channel absent for this ray).
        Returns:
            image [R, W], weights [R, S], regularizing_quantity [R, S].
        """
        raw = field_out.raw
        density = torch.exp(torch.clamp(raw[..., 0], min=0.0))       # [R, S]
        log_t = torch.clamp(raw[..., 1], min=0.0)                    # [R, S]

        channel = self.response.channel_index(wavelengths)           # [R, W]
        present = (channel >= 0).to(raw.dtype)
        channel = torch.clamp(channel, min=0)
        per_ch = self.response.evaluate_channels_last(log_t)         # [R, S, C]
        n_rays, n_samples = log_t.shape
        t_resp = torch.gather(per_ch, 2, channel[:, None, :].expand(
            n_rays, n_samples, channel.shape[1])) * present[:, None, :]  # [R, S, W]

        # a gather from the per-ray view, not log_abs[channel]: the index's
        # backward sorts its indices (0.76 ms a DT_2012_11 step on an H100),
        # the gather's is a scatter-add and a sum over rays
        kappa = torch.clamp(field_out.log_abs, min=0.0)
        abs_coeff = torch.gather(kappa.expand(n_rays, kappa.shape[0]), 1,
                                 channel) * present                 # [R, W]

        absorption = density[..., None] * abs_coeff[:, None, :]      # [R, S, W]
        absorption_integral = cumtrapz(absorption, z_vals)           # [R, S-1, W]

        emission = (density ** 2)[..., None] * t_resp                # [R, S, W]
        integrand = torch.exp(-absorption_integral) * emission[:, :-1]
        image = trapz(integrand, z_vals[:, :-1]) * field_out.vol_c \
            * self.pixel_intensity_factor                            # [R, W]

        if self.hierarchical_weighting == 'emission':
            # the channel-summed attenuated integrand, scaled by its per-ray
            # max first (absolute values are ~1e-17, below the 1e-10 epsilon)
            w = torch.sum(integrand, dim=-1)                         # [R, S-1]
            w = w / (torch.amax(w, dim=1, keepdim=True) + 1e-30)
            w = torch.cat([w, w[:, -1:]], dim=1)                     # [R, S]
        else:
            w = torch.clamp(raw[..., 0], min=0.0)
        weights = w / (torch.sum(w, dim=1, keepdim=True) + 1e-10)

        return {'image': image, 'weights': weights,
                'regularizing_quantity': torch.clamp(raw[..., 0], min=0.0)}

    def occupancy_activity(self, raw: torch.Tensor) -> torch.Tensor:
        """EUV emission scales with density squared, so the occupancy
        criterion follows it (its caller, occupancy-guided sampling, is not
        ported yet: ROADMAP Queue 1 item 10)."""
        return torch.exp(2.0 * torch.clamp(raw[..., 0], min=0.0))

    def regularization(self, distance: torch.Tensor,
                       regularizing_quantity: torch.Tensor) -> torch.Tensor:
        """Penalize density beyond 1.25 Rsun (density_temperature.py:273-274)."""
        return torch.clamp(distance - 1.25 / self.Rs_per_ds, min=0.0) \
            * torch.clamp(regularizing_quantity, min=0.0)
