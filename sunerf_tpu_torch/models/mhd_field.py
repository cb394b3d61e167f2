"""MHD simulation field: PSI (rho, T) cubes behaving like a trained NeRF
(sunerf_tpu/models/mhd_field.py; reference sunerf/model/mhd_model.py:11-142).

The frames are read once on the host (data/psi_io.py's numpy reader: no
h5py) into [F, n_phi, n_theta, n_r] tensors on the device; the field is a
trilinear interpolation in spherical coordinates (phi, theta, r), brackets
found by torch.searchsorted and corners gathered by index, lerped in time
between the two bracketing frames. No kernel: plain PyTorch, as JAX's is
XLA gathers.

Field output: raw = (log rho, log10(1e6 T)) with fill value 1e-10 outside
the cube (mhd_model.py:108,137-138).
"""
from __future__ import annotations

import dataclasses
import glob
import math
import os
import re

import numpy as np
import torch

from sunerf_tpu_torch.models.fields import FieldOutput

_FILL = 1e-10
TENSORS = ('r_grid', 'theta_grid', 'phi_grid', 'rho', 'temperature')


def _frame_number(path: str) -> int:
    m = re.search(r'(\d+)\.h5$', os.path.basename(path))
    if not m:
        raise ValueError(f'no frame number in {path}')
    return int(m.group(1))


def _axis(grid: torch.Tensor, x: torch.Tensor):
    """Bracketing indices and weights on a (possibly non-uniform) grid."""
    idx = (torch.searchsorted(grid, x.contiguous(), right=True) - 1).clamp(
        0, grid.shape[0] - 2)
    lo, hi = grid[idx], grid[idx + 1]
    return idx, ((x - lo) / torch.clamp(hi - lo, min=1e-12)).clamp(0.0, 1.0)


@dataclasses.dataclass(frozen=True, eq=False)
class MHDField:
    """Device-resident MHD cubes and spherical grids."""
    r_grid: torch.Tensor        # [n_r]
    theta_grid: torch.Tensor    # [n_theta]
    phi_grid: torch.Tensor      # [n_phi]
    rho: torch.Tensor           # [F, n_phi, n_theta, n_r]
    temperature: torch.Tensor   # [F, n_phi, n_theta, n_r]
    ffirst: int
    flast: int

    def tensors(self) -> dict:
        return {k: getattr(self, k) for k in TENSORS}

    def sample(self, points: torch.Tensor):
        """points [N, 4] (x, y, z, t in [0, 1]) -> (rho, T) [N] each."""
        x, y, z, t = points.unbind(-1)
        r = torch.sqrt(x * x + y * y + z * z)
        theta = torch.arccos(torch.clamp(z / torch.clamp(r, min=1e-10), -1.0, 1.0))
        phi = torch.atan2(y, x)
        phi = torch.where(phi < 0, phi + 2 * math.pi, phi)

        inside = (r >= self.r_grid[0]) & (r <= self.r_grid[-1])
        pi, pw = _axis(self.phi_grid, phi)
        ti, tw = _axis(self.theta_grid, theta)
        ri, rw = _axis(self.r_grid, r)

        # frame interpolation: t in [0, 1] spans [ffirst, flast]
        n_frames = self.rho.shape[0]
        f = t * (self.flast - self.ffirst)
        f0 = torch.floor(f).to(torch.int64).clamp(0, n_frames - 1)
        f1 = (f0 + 1).clamp(0, n_frames - 1)
        fw = (f - f0).clamp(0.0, 1.0)

        def tri_at(frames, fidx):
            def g(dp, dt, dr):
                return frames[fidx, pi + dp, ti + dt, ri + dr]
            c00 = g(0, 0, 0) * (1 - rw) + g(0, 0, 1) * rw
            c01 = g(0, 1, 0) * (1 - rw) + g(0, 1, 1) * rw
            c10 = g(1, 0, 0) * (1 - rw) + g(1, 0, 1) * rw
            c11 = g(1, 1, 0) * (1 - rw) + g(1, 1, 1) * rw
            c0 = c00 * (1 - tw) + c01 * tw
            c1 = c10 * (1 - tw) + c11 * tw
            return c0 * (1 - pw) + c1 * pw

        rho = (1 - fw) * tri_at(self.rho, f0) + fw * tri_at(self.rho, f1)
        temp = (1 - fw) * tri_at(self.temperature, f0) + fw * tri_at(self.temperature, f1)
        fill = torch.full_like(rho, _FILL)
        rho = torch.where(inside, torch.clamp(rho, min=_FILL), fill)
        temp = torch.where(inside, torch.clamp(temp, min=_FILL), fill)
        return rho, temp


def mhd_apply(field: MHDField, params: dict, points: torch.Tensor) -> FieldOutput:
    """FieldOutput contract: raw = (log rho, log10(1e6 T))
    (reference mhd_model.py:137-138)."""
    rho, temp = field.sample(points)
    raw = torch.stack([torch.log(rho), torch.log10(1e6 * temp)], dim=-1)
    return FieldOutput(raw=raw, log_abs=params['log_abs'], vol_c=params['vol_c'])


class MHDFieldLoader:
    """Host-side loader: reads rho/tNNNNNN.h5 frame files once (numpy reader)
    and builds the MHDField on `device` ('cuda' by default, which raises
    without a card; 'cpu' on request)."""

    def __init__(self, data_path: str, max_frames: int | None = None, device='cuda'):
        from sunerf_tpu_torch.data.psi_io import rdhdf_3d
        device = torch.device(device)
        if device.type == 'cuda' and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: the MHD field lives on the card; pass "
                               "device='cpu' to load it on the CPU")
        self.data_path = data_path
        self.device = device
        rho_files = sorted(glob.glob(os.path.join(data_path, 'rho', '*.h5')))
        t_files = sorted(glob.glob(os.path.join(data_path, 't', '*.h5')))
        if not rho_files or not t_files:
            raise FileNotFoundError(f'no rho/t HDF5 frames under {data_path}')
        if max_frames:
            rho_files = rho_files[:max_frames]
            t_files = t_files[:max_frames]
        self.ffirst = _frame_number(rho_files[0])
        self.flast = _frame_number(rho_files[-1])

        rhos, temps = [], []
        r = th = phi = None
        for rf, tf in zip(rho_files, t_files):
            r, th, phi, rho = rdhdf_3d(rf)
            _, _, _, temp = rdhdf_3d(tf)
            rho = np.asarray(rho, np.float32)
            temp = np.asarray(temp, np.float32)
            rho[rho < 0] = _FILL
            temp[temp < 0] = _FILL
            rhos.append(rho)
            temps.append(temp)

        def dev(a):
            return torch.as_tensor(np.asarray(a, np.float32)).to(device)

        self.field = MHDField(r_grid=dev(r), theta_grid=dev(th), phi_grid=dev(phi),
                              rho=dev(np.stack(rhos)), temperature=dev(np.stack(temps)),
                              ffirst=self.ffirst, flast=self.flast)

    def init_params(self) -> dict:
        """Learnable per-wavelength log absorption + volumetric constant
        (reference mhd_model.py:33-43)."""
        return {'log_abs': torch.tensor([20.4, 20.2, 20.0, 19.8, 19.6, 19.4, 19.2],
                                        dtype=torch.float32, device=self.device),
                'vol_c': torch.tensor(1.0, dtype=torch.float32, device=self.device)}
