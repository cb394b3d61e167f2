"""Trained-model inference loaders: render observer views from a deployment
bundle or a live renderer (sunerf_tpu/evaluation/loader.py).

Rays are built on the host, uploaded once per call and rendered in chunks of
batch_size rays under torch.inference_mode(), through render_rays, the one
batched method that the observer view and the products use. With adaptive
tiers (tier=(fraction, samples)) each chunk ranks its own rays, so the last
chunk is padded to batch_size as the JAX loader pads it (zeros; the products
pad directions with ones) and its padded rays take part in the ranking. No
device mesh (ROADMAP Queue 1 item 11).
"""
from __future__ import annotations

import dataclasses
from datetime import datetime
from typing import Optional

import numpy as np
import torch

from sunerf_tpu_torch.core.geometry import fov_for_distance, observer_rays
from sunerf_tpu_torch.core.scaling import normalize_datetime
from sunerf_tpu_torch.models.fields import params_from_numpy
from sunerf_tpu_torch.systems import from_spec
from sunerf_tpu_torch.utils.checkpoint import load_state


MAPS = ('image', 'height_map', 'absorption_map')
# what the CLIs raise for a serving artifact in place of a bundle
SHLO = ('serving artifacts (.shlo) are not ported yet (ROADMAP Queue 1 item 12, '
        'serving export); pass the deployment bundle')


@dataclasses.dataclass
class RenderedView:
    """Full-disk render products."""
    image: np.ndarray            # [H, W, C]
    height_map: np.ndarray       # [H, W]
    absorption_map: np.ndarray   # [H, W]


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: rendering runs on the card; pass "
                           "device='cpu' to render on the CPU")
    return device


def _tensor(x, device) -> torch.Tensor:
    """A float32 tensor on `device` from a tensor, an array, a sequence or a
    scalar."""
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x, np.float32))
    return x.to(device, torch.float32)


class ModelLoader:
    """Batched observer-image rendering over any renderer + params."""

    def __init__(self, renderer, params: dict, ref_time: datetime | None = None,
                 seconds_per_dt: float = 86400.0, batch_size: int = 4096,
                 tier: Optional[tuple] = None, device='cuda'):
        """tier: optional (fraction, samples), adaptive per-ray budgets for
        inference: per chunk, the dimmest `fraction` of the rays (ranked by
        the coarse pass) render at `samples` samples (the renderer's tiered
        fine pass with tier_eval=True). Off by default (the full budget)."""
        if tier is not None:
            renderer = dataclasses.replace(
                renderer, tier_fraction=float(tier[0]), tier_samples=int(tier[1]),
                tier_eval=True)
        self.renderer = renderer
        self.params = params
        self.ref_time = ref_time
        self.seconds_per_dt = seconds_per_dt
        self.batch_size = int(batch_size)
        self.device = _device(device)

    def normalize_time(self, time) -> float:
        if isinstance(time, datetime):
            if self.ref_time is None:
                raise ValueError('datetime given but loader has no ref_time')
            return normalize_datetime(time, self.seconds_per_dt, self.ref_time)
        return float(time)

    def render_rays(self, rays_o, rays_d, times, wavelengths=None, keys=MAPS,
                    pad_direction: float = 0.0) -> dict:
        """Render [n, 3] rays (numpy arrays or tensors) at `times` (a scalar
        or [n, 1]) with `wavelengths` (None, [W] for every ray, or [n, W]),
        in chunks of batch_size, without jitter. Returns {key: numpy array
        [n, ...]} of the renderer's outputs named in `keys`. Under tiers the
        last chunk is padded to batch_size with zero origins and times and
        directions of `pad_direction` (0 in render_observer_image, 1 in the
        products, as in the JAX package)."""
        rays_o = _tensor(rays_o, self.device).reshape(-1, 3)
        rays_d = _tensor(rays_d, self.device).reshape(-1, 3)
        n = rays_o.shape[0]
        times = _tensor(times, self.device).reshape(-1, 1).expand(n, 1)
        wl = None
        if wavelengths is not None:
            wl = _tensor(wavelengths, self.device)
            wl = wl.reshape(1, -1).expand(n, -1) if wl.ndim == 1 else wl
        bs = self.batch_size
        pad = (-n) % bs if self.renderer.tier_fraction and self.renderer.tier_eval else 0
        if pad:
            fill = lambda x, v: torch.cat([x, x.new_full((pad, x.shape[1]), v)])  # noqa: E731
            rays_o, rays_d, times = fill(rays_o, 0.0), fill(rays_d, pad_direction), fill(times, 0.0)
            wl = fill(wl, 0.0) if wl is not None else None
        parts = {k: [] for k in keys}
        with torch.inference_mode():
            for i in range(0, n + pad, bs):
                sl = slice(i, i + bs)
                out = self.renderer(self.params, rays_o[sl], rays_d[sl], times[sl],
                                    wavelengths=wl[sl] if wl is not None else None)
                for k in keys:
                    parts[k].append(out[k])
            return {k: torch.cat(v)[:n].cpu().numpy() for k, v in parts.items()}

    def render_observer_image(self, lat: float, lon: float, time,
                              distance: float, resolution: int = 256,
                              wavelengths=None, fov: float | None = None,
                              center_distance: float | None = None) -> RenderedView:
        """Render the Sun as seen from Carrington (lat, lon) [rad] at the given
        distance [solar radii / ds].

        wavelengths: sequence of channel values for multi-channel heads.
        center_distance: accepted and unused, as in the JAX package.
        """
        rays_o, rays_d = observer_rays(lat, lon, distance, resolution,
                                       fov=fov or fov_for_distance(distance))
        out = self.render_rays(rays_o, rays_d, self.normalize_time(time),
                               None if wavelengths is None else list(wavelengths))
        res = (resolution, resolution)
        return RenderedView(image=out['image'].reshape(*res, -1),
                            height_map=out['height_map'].reshape(res),
                            absorption_map=out['absorption_map'].reshape(res))

    def load_coords(self, query_points: np.ndarray, batch_size: int | None = None):
        """Direct field query at [N, 4] (x, y, z, t) points. Returns raw
        [N, d_out] as numpy."""
        bs = batch_size or self.batch_size
        q = torch.as_tensor(np.asarray(query_points, np.float32).reshape(-1, 4))
        outs = []
        with torch.inference_mode():
            for i in range(0, len(q), bs):
                out = self.renderer.forward_points(
                    self.params, q[i:i + bs].to(self.device))
                outs.append(out.raw.cpu())
        return torch.cat(outs).numpy()


class SuNeRFLoader(ModelLoader):
    """Load a trained deployment bundle (<state_path>.npz/.json) and render."""

    def __init__(self, state_path: str, batch_size: int = 4096,
                 use_fused: Optional[bool] = None, tier: Optional[tuple] = None,
                 render_overrides: Optional[dict] = None, device='cuda'):
        """use_fused: None = the fused kernel on CUDA, the plain field on the
        CPU; True/False forces it (True on the CPU runs the kernel's plain
        bf16 version).
        tier: optional (fraction, samples) adaptive per-ray budgets
        (ModelLoader).
        render_overrides: optional sampling kwargs merged over the saved
        spec's render section (e.g. {'n_stratified': 64, 'n_hierarchical':
        128}); None = render exactly as trained.
        device: 'cuda' (default) raises when there is no card."""
        device = _device(device)
        params, config = load_state(state_path)
        spec = config.get('renderer_spec')
        if spec is None:
            raise ValueError(f'{state_path} carries no renderer_spec')
        if render_overrides:
            spec = dict(spec,
                        render=dict(spec.get('render', {}), **render_overrides))
        renderer, _ = from_spec(spec, use_fused=use_fused, device=device)
        ref_time = config.get('ref_time')
        super().__init__(
            renderer, params_from_numpy(params, device),
            ref_time=datetime.fromisoformat(ref_time) if ref_time else None,
            seconds_per_dt=config.get('seconds_per_dt', 86400.0),
            batch_size=batch_size, tier=tier, device=device)
        self.config = config

    @property
    def wavelengths(self):
        return self.config.get('wavelengths')
