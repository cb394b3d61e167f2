"""AIA temperature-response tables and their differentiable evaluation
(sunerf_tpu/ops/tresp.py).

All seven channel responses are interpolated at once, and each ray's
wavelengths select their channels by index. The JAX package phrases both
as one-hot products, a workaround for slow gathers on its chip; here they
are gathers: the lookup is an index lerp on the uniform log T grid (floor,
clamp to [0, G-2], two table columns, zero outside [0, G-1]) and the
channel selection an index into AIA_WAVELENGTHS, with -1 for a wavelength
that is absent (0) or unknown, which selects nothing.

The table is the reference's calibration asset parsed by data/genx.py and
cached as npz (assets/aia_temp_resp.npz, the same bytes as the JAX
package's); the response is multiplied by the typical AIA exposure time
(2.9 s) at load, as the reference does.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from sunerf_tpu_torch.models.fields import AIA_WAVELENGTHS

DEFAULT_NPZ = os.path.join(os.path.dirname(os.path.abspath(__file__)), '..', 'assets',
                           'aia_temp_resp.npz')
DEFAULT_AIA_EXP_TIME = 2.9  # seconds (reference density_temperature.py:99)


@dataclasses.dataclass(frozen=True, eq=False)
class TemperatureResponse:
    """Per-channel temperature response R(logT) on a shared logT grid.

    logte: [G] log10 temperature grid (ascending, uniform spacing: the
        shipped AIA table is 4.0..9.0 step 0.05; load_aia_response asserts it).
    tresp: [C, G] response per channel, channel order == AIA_WAVELENGTHS.
    """
    logte: torch.Tensor
    tresp: torch.Tensor
    wavelengths: tuple = AIA_WAVELENGTHS

    def evaluate_all(self, log_t: torch.Tensor) -> torch.Tensor:
        """Every channel's response at log_t [...] -> [C, ...]; 0 outside the
        table (the reference's Interp1D(extrap=0))."""
        return torch.movedim(self.evaluate_channels_last(log_t), -1, 0)

    def evaluate_channels_last(self, log_t: torch.Tensor) -> torch.Tensor:
        """[...] -> [..., C]: the two table columns around each log T,
        weighted (1 - frac, frac) as the JAX package's interpolation
        weights are."""
        g0 = self.logte[0]
        dt = self.logte[1] - self.logte[0]
        n_grid = self.logte.shape[0]
        pos = (log_t.reshape(-1) - g0) / dt
        i0 = torch.clamp(torch.floor(pos), 0, n_grid - 2)
        frac = pos - i0
        inside = ((pos >= 0.0) & (pos <= n_grid - 1)).to(pos.dtype)
        table, idx = self.tresp.T, i0.long()                   # [G, C]
        out = ((1.0 - frac) * inside)[:, None] * table[idx] \
            + (frac * inside)[:, None] * table[idx + 1]
        return out.reshape(*log_t.shape, self.tresp.shape[0])

    def channel_index(self, wavelengths: torch.Tensor) -> torch.Tensor:
        """Wavelength values [...] -> channel indices [...] (int64), -1 for
        padding (0) and unknown values."""
        known = torch.tensor(self.wavelengths, dtype=wavelengths.dtype,
                             device=wavelengths.device)
        ones_based = torch.arange(1, len(self.wavelengths) + 1, device=wavelengths.device)
        return ((wavelengths[..., None] == known) * ones_based).sum(-1) - 1


def load_aia_response(path: str = DEFAULT_NPZ,
                      aia_exp_time: float = DEFAULT_AIA_EXP_TIME,
                      device='cuda') -> TemperatureResponse:
    """The packaged AIA response table (npz with 'logte' [G] and 'tresp'
    [C, G]) times the exposure time, on `device`."""
    with np.load(path) as f:
        logte_np = np.asarray(f['logte'], np.float32)
        tresp = torch.as_tensor(np.asarray(f['tresp'], np.float32)) * aia_exp_time
    steps = np.diff(logte_np)
    if not np.allclose(steps, steps[0], rtol=1e-3):
        raise ValueError(f'{path}: the response grid must be uniform (the index '
                         f'lookup assumes it)')
    return TemperatureResponse(logte=torch.as_tensor(logte_np).to(device),
                               tresp=tresp.to(device))


def convert_genx_to_npz(genx_path: str, npz_path: str = DEFAULT_NPZ) -> None:
    """Parse an SSW genx response file and cache it as npz (offline, host-side).

    Channels are resampled onto the union of their logT grids so a single
    shared grid serves all channels (they are identical in the shipped asset).
    """
    from sunerf_tpu_torch.data.genx import read_genx
    data = read_genx(genx_path)
    grids, resps = [], {}
    for wl in AIA_WAVELENGTHS:
        ch = data[f'A{wl}']
        grids.append(np.asarray(ch['LOGTE'], np.float64))
        resps[wl] = np.asarray(ch['TRESP'], np.float64)
    common = np.unique(np.concatenate(grids))
    tresp = np.stack([
        np.interp(common, g, resps[wl], left=0.0, right=0.0)
        for g, wl in zip(grids, AIA_WAVELENGTHS)])
    os.makedirs(os.path.dirname(npz_path), exist_ok=True)
    np.savez(npz_path, logte=common.astype(np.float32),
             tresp=tresp.astype(np.float32),
             wavelengths=np.asarray(AIA_WAVELENGTHS, np.int32))
