"""Trained-model inference loaders: render observer views from a deployment
bundle or a live renderer (sunerf_tpu/evaluation/loader.py).

Rays are built on the host, uploaded once per view and rendered in fixed
chunks of batch_size rays under torch.inference_mode(). No device mesh and no
adaptive tiers yet.
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


class ModelLoader:
    """Batched observer-image rendering over any renderer + params."""

    def __init__(self, renderer, params: dict, ref_time: datetime | None = None,
                 seconds_per_dt: float = 86400.0, batch_size: int = 4096,
                 device='cuda'):
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

    def render_observer_image(self, lat: float, lon: float, time,
                              distance: float, resolution: int = 256,
                              wavelengths=None, fov: float | None = None) -> RenderedView:
        """Render the Sun as seen from Carrington (lat, lon) [rad] at the given
        distance [solar radii / ds].

        wavelengths: sequence of channel values for multi-channel heads.
        """
        rays_o, rays_d = observer_rays(lat, lon, distance, resolution,
                                       fov=fov or fov_for_distance(distance))
        n = resolution * resolution
        upload = lambda x: torch.as_tensor(x.reshape(n, -1)).to(self.device)
        rays_o, rays_d = upload(rays_o), upload(rays_d)
        t = torch.full((n, 1), self.normalize_time(time), dtype=torch.float32,
                       device=self.device)
        wl = None
        if wavelengths is not None:
            wl = torch.tensor(wavelengths, dtype=torch.float32,
                              device=self.device).expand(n, len(wavelengths))

        images, heights, absorptions = [], [], []
        with torch.inference_mode():
            for i in range(0, n, self.batch_size):
                sl = slice(i, i + self.batch_size)
                out = self.renderer(self.params, rays_o[sl], rays_d[sl], t[sl],
                                    wavelengths=wl[sl] if wl is not None else None)
                images.append(out['image'])
                heights.append(out['height_map'])
                absorptions.append(out['absorption_map'])
            image = torch.cat(images).reshape(resolution, resolution, -1)
            height = torch.cat(heights).reshape(resolution, resolution)
            absorption = torch.cat(absorptions).reshape(resolution, resolution)
        return RenderedView(image=image.cpu().numpy(),
                            height_map=height.cpu().numpy(),
                            absorption_map=absorption.cpu().numpy())

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
                 use_fused: Optional[bool] = None,
                 render_overrides: Optional[dict] = None, device='cuda'):
        """use_fused: None = the fused kernel on CUDA, the plain field on the
        CPU; True/False forces it (True on the CPU runs the kernel's plain
        bf16 version).
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
            batch_size=batch_size, device=device)
        self.config = config

    @property
    def wavelengths(self):
        return self.config.get('wavelengths')
