"""System factories wiring fields, heads and renderers together
(sunerf_tpu/systems.py). The emission head is ported; the other heads come
with later slices."""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch

from sunerf_tpu_torch.models.fields import (NeRFConfig, emission_config,
                                            init_nerf, nerf_apply,
                                            nerf_apply_fused)
from sunerf_tpu_torch.rendering.emission import EmissionHead
from sunerf_tpu_torch.rendering.renderer import Renderer

_HEAD_TODO = {
    'density_temperature': 'ROADMAP Queue 1, DT head',
    'simple_star': 'ROADMAP Queue 1, DT head',
    'thomson': 'ROADMAP Queue 1, Thomson head',
    'mhd': 'ROADMAP Queue 1, MHD field',
}


def _select_apply(config: NeRFConfig, use_fused: Optional[bool], device):
    """Pick the field evaluation path: use_fused=None takes the fused kernel
    when the device is CUDA and the plain float32 field otherwise; True or
    False forces the choice."""
    if config.grid_sizes:
        raise NotImplementedError('feature-grid encodings are not ported yet '
                                  '(ROADMAP Queue 1, opt-in dials: grid '
                                  'encodings)')
    if use_fused is None:
        use_fused = torch.device(device).type == 'cuda'
    if use_fused:
        # compute_dpts=False: the renderer detaches its sample points, so
        # the stashing backward computes no point cotangent
        return functools.partial(nerf_apply_fused, config, compute_dpts=False)
    return functools.partial(nerf_apply, config)


def _spec(head_name: str, config, Rs_per_ds, render_kwargs, **extra) -> dict:
    spec = {'head': head_name, 'Rs_per_ds': Rs_per_ds,
            'render': dict(render_kwargs)}
    if config is not None:
        spec['model_config'] = dataclasses.asdict(config)
    spec.update(extra)
    return spec


def make_emission_system(Rs_per_ds: float = 1.0,
                         model_config: Optional[NeRFConfig] = None,
                         coarse_config: Optional[NeRFConfig] = None,
                         use_fused: Optional[bool] = None,
                         device='cuda', **render_kwargs):
    """Emission SuNeRF: NeRF field + emission/absorption quadrature. Returns
    (renderer, init) where init(generator) makes {'coarse', 'fine'} params on
    `device`.

    coarse_config: optional SMALLER architecture for the coarse pass
    (proposal-network style); None = both passes share model_config."""
    config = model_config or emission_config()
    extra = {}
    if coarse_config is not None:
        extra['coarse_model_config'] = dataclasses.asdict(coarse_config)
    occ = render_kwargs.pop('occupancy', None)
    if occ and not (isinstance(occ, dict) and not occ.get('enabled', True)):
        raise NotImplementedError('occupancy-guided sampling is not ported '
                                  'yet (ROADMAP Queue 1, opt-in dials: '
                                  'occupancy)')
    renderer = Renderer(
        field_apply=_select_apply(config, use_fused, device),
        coarse_field_apply=(_select_apply(coarse_config, use_fused, device)
                            if coarse_config is not None else None),
        head=EmissionHead(Rs_per_ds=Rs_per_ds), Rs_per_ds=Rs_per_ds,
        spec=_spec('emission', config, Rs_per_ds, render_kwargs, **extra),
        **render_kwargs)

    def init(generator: torch.Generator) -> dict:
        return {'coarse': init_nerf(generator, coarse_config or config, device),
                'fine': init_nerf(generator, config, device)}

    return renderer, init


def from_spec(spec: dict, use_fused: Optional[bool] = None, device='cuda'):
    """Rebuild a (renderer, init) pair from a serialized spec — the bundle
    reconstruction path of the evaluation loader."""
    head = spec['head']
    if head != 'emission':
        todo = _HEAD_TODO.get(head)
        if todo is None:
            raise ValueError(f'unknown head {head!r}')
        raise NotImplementedError(f'the {head!r} head is not ported yet ({todo})')
    mc = spec.get('model_config')
    cc = spec.get('coarse_model_config')
    return make_emission_system(
        Rs_per_ds=spec['Rs_per_ds'],
        model_config=NeRFConfig(**mc) if mc else None,
        coarse_config=NeRFConfig(**cc) if cc else None,
        use_fused=use_fused, device=device, **dict(spec.get('render', {})))
