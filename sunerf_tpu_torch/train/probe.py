"""GT-free high-latitude drift probe (round-4 scale-test finding), over the
port's renderer (sunerf_tpu/train/probe.py).

The 200k-step scale test (SCALE_PROOF_r4.jsonl, RESULTS.md round 4) found
that deep-cut sample budgets can drift at HIGH LATITUDE late in long
schedules while the ecliptic-band validation — the only ground truth the
data reality provides (the reference's viewpoints are ecliptic-bound too;
its validation is the same band, /root/reference/sunerf/train/callback.py)
— stays flat: keep_best cannot see the failure (seed 8 reversed by
−5.67 dB on the |lat| ≥ 25° test views with healthy band-val throughout).

This probe renders a small set of FIXED synthetic high-latitude viewpoints
(no ground truth required) at every validation and reports how much those
renders change:

  * ``probe_stability_db``        — PSNR(current, previous validation)
  * ``probe_drift_since_best_db`` — PSNR(current, render at the val-PSNR
                                    high-water mark)

A run whose band-val holds near its high-water while
``probe_drift_since_best_db`` collapses is exhibiting exactly the seed-8
failure signature; the Trainer logs ``probe_drift_warning`` and prints a
loud message. Observational in round 4: the metrics are not wired into
checkpoint selection until they are validated against a reproduced
long-schedule failure (ROADMAP).
"""
from __future__ import annotations

import numpy as np
import torch

from sunerf_tpu_torch.core.geometry import observer_rays

PSNR_CAP_DB = 99.0  # identical renders would be +inf; cap for finite logs


def probe_psnr(a: np.ndarray, b: np.ndarray) -> float:
    """PSNR [dB] between two probe render stacks, capped for finite logs.

    data_range is taken from the REFERENCE stack (b) so the number reads as
    "how large is the change relative to the reference render's dynamic
    range" — the same convention as the validation metric.
    """
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    mse = float(np.mean((a - b) ** 2))
    rng = float(b.max() - b.min()) or 1.0
    if mse == 0:
        return PSNR_CAP_DB
    return min(10.0 * np.log10(rng * rng / mse), PSNR_CAP_DB)


class DriftProbe:
    """Renders fixed high-latitude viewpoints through a renderer.

    Views alternate between +lat_deg and -lat_deg with longitudes evenly
    spaced over the full circle, all at the same observer distance and
    scene time (taken from the validation data by the Trainer), so every
    render in the run sees the identical ray bundle and differences are
    attributable to the field alone. The rays are uploaded to `device`
    once; a render is a plain loop over the views (chunks of batch_size
    rays, no gradient: the fused path's K0) with one host fetch at the end.
    """

    def __init__(self, renderer, distance: float, time: float = 0.0,
                 n_views: int = 4, resolution: int = 64,
                 lat_deg: float = 60.0, wavelength: float | None = None,
                 device='cuda', batch_size: int = 4096):
        self.renderer = renderer
        self.n_views = int(n_views)
        self.resolution = int(resolution)
        self.batch_size = int(batch_size)
        lat = float(np.deg2rad(lat_deg))
        origins, dirs = [], []
        for i in range(self.n_views):
            lat_i = lat if i % 2 == 0 else -lat
            lon_i = 2.0 * np.pi * i / self.n_views
            o, d = observer_rays(lat_i, lon_i, float(distance), self.resolution)
            origins.append(np.asarray(o).reshape(-1, 3))
            dirs.append(np.asarray(d).reshape(-1, 3))
        # camera optical centers [V, 3] (all rays of a view share one)
        self.view_origins = np.stack([o[0] for o in origins])
        as_dev = lambda x: torch.as_tensor(np.stack(x), dtype=torch.float32).to(device)  # noqa: E731
        self._rays_o, self._rays_d = as_dev(origins), as_dev(dirs)    # [V, R, 3]
        n_rays = self._rays_o.shape[1]
        self._times = torch.full((n_rays, 1), float(time), dtype=torch.float32, device=device)
        self._wl = (None if wavelength is None else
                    torch.full((n_rays, 1), float(wavelength), dtype=torch.float32,
                               device=device))

    def render(self, params) -> np.ndarray:
        """[n_views, resolution, resolution, C] fine-pass render stack."""
        n_rays, bs = self._rays_o.shape[1], self.batch_size
        views = []
        with torch.no_grad():
            for v in range(self.n_views):
                chunks = []
                for i in range(0, n_rays, bs):
                    sl = slice(i, i + bs)
                    out = self.renderer(params, self._rays_o[v, sl], self._rays_d[v, sl],
                                        self._times[sl], generator=None,
                                        wavelengths=None if self._wl is None else self._wl[sl])
                    chunks.append(out['fine_image'])
                views.append(torch.cat(chunks))
            out = torch.stack(views).cpu().numpy()
        return out.reshape(self.n_views, self.resolution, self.resolution, -1)
