"""SimpleStar: an analytic hydrostatic stellar atmosphere with the field
contract of a trained NeRF (sunerf_tpu/models/simple_star.py; reference
sunerf/model/stellar_model.py:5-102).

It synthesizes training sets through the DT radiative-transfer head and is
the teacher of the closed-loop tests.

Physics (Pascoe et al. 2019, eqs. 4 & 6):
  rho(r) = rho_0                                        r <= 1 Rsun
         = rho_0 * exp((1/r - 1) / h0)                  r >  1 Rsun
  T(r)   = T_phot                                       r <= 1 Rsun
         = linear(T_phot -> T0) on [1, R_s]             1 < r <= R_s
         = T0                                           r >  R_s
Field outputs (log rho, log10 T) in the shared FieldOutput contract.
"""
from __future__ import annotations

import dataclasses

import torch

from sunerf_tpu_torch.core.sampling import norm3
from sunerf_tpu_torch.models.fields import FieldOutput

_SOLRAD_MM = 695.7     # 1 solar radius [Mm]


@dataclasses.dataclass(frozen=True)
class SimpleStarConfig:
    """Defaults match the reference (stellar_model.py:8-31): h0 = 60 Mm,
    T0 = 1.4e6 K, R_s = 1.02 Rsun, T_phot = 5777 K, rho_0 = 3e8 cm^-3."""
    h0: float = 60.0 / _SOLRAD_MM          # scale height [Rsun]
    T0: float = 1.4e6                      # coronal temperature [K]
    R_s: float = 1.02                      # isothermal radius [Rsun]
    t_photosphere: float = 5777.0          # photospheric temperature [K]
    rho_0: float = 3.0e8                   # photospheric density [cm^-3]


def init_simple_star(config: SimpleStarConfig = SimpleStarConfig(),
                     device='cuda') -> dict:
    """Stellar parameters (0-d tensors), the per-wavelength log absorption
    and the volumetric constant on `device` (all trainable in the
    reference; stellar_model.py:33-50)."""
    scalar = lambda v: torch.tensor(v, dtype=torch.float32, device=device)  # noqa: E731
    return {
        'Rs': scalar(config.R_s),
        'h0': scalar(config.h0),
        'T0': scalar(config.T0),
        'rho_0': scalar(config.rho_0),
        # per-wavelength log absorption for (94, 131, 171, 193, 211, 304, 335) A
        'log_abs': scalar([20.4, 20.2, 20.0, 19.8, 19.6, 19.4, 19.2]),
        'vol_c': scalar(1.0),
    }


def simple_star_apply(config: SimpleStarConfig, params: dict,
                      points: torch.Tensor) -> FieldOutput:
    """(log rho, log10 T) at [N, 4] query points (time is ignored: the
    analytic star is static). The outer density branch is evaluated at
    r = 1 for points inside the Sun, where its value is discarded: there
    exp((1/r - 1) / h0) overflows for r below about 0.116, and the inf
    would turn the discarded branch's zero gradient into NaN (as it does
    for h0 and rho_0 in the JAX package; ROADMAP Queue 3)."""
    r = norm3(points[:, :3])
    inside = r <= 1.0

    r_out = torch.where(inside, torch.ones_like(r), r)
    rho_out = params['rho_0'] * torch.exp(
        (1.0 / torch.clamp(r_out, min=1e-6) - 1.0) / params['h0'])
    rho = torch.where(inside, params['rho_0'], rho_out)
    log_rho = torch.log(rho)

    t_lin = (r - 1.0) * ((params['T0'] - config.t_photosphere) / (params['Rs'] - 1.0)) \
        + config.t_photosphere
    temp = torch.where(inside, config.t_photosphere,
                       torch.where(r <= params['Rs'], t_lin, params['T0']))
    log10_t = torch.log10(temp)

    raw = torch.stack([log_rho, log10_t], dim=-1)
    return FieldOutput(raw=raw, log_abs=params['log_abs'], vol_c=params['vol_c'])
