"""System factories wiring fields, heads and renderers together
(sunerf_tpu/systems.py): each returns a Renderer and an init function for
its parameters on `device`. The emission, density-temperature, SimpleStar
and Thomson systems are ported; the MHD field is not (ROADMAP Queue 1
item 9)."""
from __future__ import annotations

import dataclasses
import functools
import warnings
from typing import Optional

import torch

from sunerf_tpu_torch.models.fields import (NeRFConfig, density_temperature_config,
                                            emission_config, init_nerf, nerf_apply,
                                            nerf_apply_fused)
from sunerf_tpu_torch.models.simple_star import (SimpleStarConfig, init_simple_star,
                                                 simple_star_apply)
from sunerf_tpu_torch.ops.tresp import TemperatureResponse, load_aia_response
from sunerf_tpu_torch.rendering.density_temperature import DensityTemperatureHead
from sunerf_tpu_torch.rendering.emission import EmissionHead
from sunerf_tpu_torch.rendering.renderer import Renderer
from sunerf_tpu_torch.rendering.thomson import ThomsonHead


def _select_apply(config: NeRFConfig, use_fused: Optional[bool], device):
    """Pick the field evaluation path: use_fused=None takes the fused kernel
    when the device is CUDA and the plain float32 field otherwise; True or
    False forces the choice. Dense grid levels run in the kernels' grid
    branch; VM levels (grid_rank > 0) have no kernel and always take the
    float32 field, with a warning, as in the JAX package."""
    if use_fused is None:
        use_fused = torch.device(device).type == 'cuda'
    if use_fused and config.grid_rank:
        warnings.warn(
            'grid_rank/grid_time tables run the float32 field path, not the '
            'fused kernels: expect a lower step rate than dense-table or '
            'plain-MLP configs (systems._select_apply)', stacklevel=3)
        use_fused = False
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


def _refuse_occupancy(render_kwargs: dict) -> dict:
    """Render kwargs without 'occupancy'; an enabled occupancy grid raises
    (not ported yet), and, as in the JAX package, so does its combination
    with any sampler but the stratified one."""
    kwargs = dict(render_kwargs)
    occ = kwargs.pop('occupancy', None)
    if occ and not (isinstance(occ, dict) and not occ.get('enabled', True)):
        if kwargs.get('sampling', 'stratified') != 'stratified':
            raise ValueError(
                f"occupancy-guided sampling assumes the stratified sampler's "
                f"integration bounds; got sampling={kwargs['sampling']!r}. "
                f"Disable occupancy or use sampling='stratified'.")
        raise NotImplementedError('occupancy-guided sampling is not ported '
                                  'yet (ROADMAP Queue 1 item 10, opt-in dials: '
                                  'occupancy)')
    return kwargs


def _nerf_pair(config: NeRFConfig, coarse_config: Optional[NeRFConfig],
               use_fused: Optional[bool], device) -> tuple:
    """The fine field's apply, the coarse proposal field's (None = the fine
    architecture for both passes) and init(generator) of both."""
    coarse_apply = (_select_apply(coarse_config, use_fused, device)
                    if coarse_config is not None else None)

    def init(generator: torch.Generator) -> dict:
        return {'coarse': init_nerf(generator, coarse_config or config, device),
                'fine': init_nerf(generator, config, device)}

    return _select_apply(config, use_fused, device), coarse_apply, init


def _coarse_extra(coarse_config: Optional[NeRFConfig]) -> dict:
    if coarse_config is None:
        return {}
    return {'coarse_model_config': dataclasses.asdict(coarse_config)}


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
    render_kwargs = _refuse_occupancy(render_kwargs)
    fine_apply, coarse_apply, init = _nerf_pair(config, coarse_config, use_fused, device)
    renderer = Renderer(
        field_apply=fine_apply, coarse_field_apply=coarse_apply,
        head=EmissionHead(Rs_per_ds=Rs_per_ds), Rs_per_ds=Rs_per_ds,
        spec=_spec('emission', config, Rs_per_ds, render_kwargs,
                   **_coarse_extra(coarse_config)),
        **render_kwargs)
    return renderer, init


def make_density_temperature_system(Rs_per_ds: float = 1.0,
                                    model_config: Optional[NeRFConfig] = None,
                                    coarse_config: Optional[NeRFConfig] = None,
                                    response: Optional[TemperatureResponse] = None,
                                    pixel_intensity_factor: float = 1e17,
                                    use_fused: Optional[bool] = None,
                                    hierarchical_weighting: str = 'density',
                                    device='cuda', **render_kwargs):
    """DT SuNeRF: the NeRF_DT field (8x512, log density + 10, log10 T + 5,
    learnable log_abs and vol_c) + multi-channel AIA synthesis (reference
    DensityTemperatureSuNeRFModule, sunerf.py:152-224; default
    pixel_intensity_factor 1e17 from sunerf.py:155).
    hierarchical_weighting='emission' opts into integrand-weighted fine
    sampling (reference parity is 'density').
    coarse_config: optional smaller proposal-style coarse architecture."""
    config = model_config or density_temperature_config()
    response = response or load_aia_response(device=device)
    head = DensityTemperatureHead(response=response,
                                  pixel_intensity_factor=pixel_intensity_factor,
                                  Rs_per_ds=Rs_per_ds,
                                  hierarchical_weighting=hierarchical_weighting)
    render_kwargs = _refuse_occupancy(render_kwargs)
    fine_apply, coarse_apply, init = _nerf_pair(config, coarse_config, use_fused, device)
    renderer = Renderer(
        field_apply=fine_apply, coarse_field_apply=coarse_apply,
        head=head, Rs_per_ds=Rs_per_ds,
        spec=_spec('density_temperature', config, Rs_per_ds, render_kwargs,
                   pixel_intensity_factor=pixel_intensity_factor,
                   hierarchical_weighting=hierarchical_weighting,
                   **_coarse_extra(coarse_config)),
        **render_kwargs)
    return renderer, init


def make_simple_star_renderer(Rs_per_ds: float = 1.0,
                              star_config: SimpleStarConfig = SimpleStarConfig(),
                              response: Optional[TemperatureResponse] = None,
                              pixel_intensity_factor: float = 1e10,
                              device='cuda', **render_kwargs):
    """The analytic SimpleStar rendered through the DT head: the synthetic
    training sets' source and the closed-loop tests' teacher (reference
    image_render.py:235-259; default pixel_intensity_factor 1e10 from
    density_temperature.py:99). init() returns one parameter dict for both
    passes, as the JAX package's does."""
    response = response or load_aia_response(device=device)
    head = DensityTemperatureHead(response=response,
                                  pixel_intensity_factor=pixel_intensity_factor,
                                  Rs_per_ds=Rs_per_ds)
    render_kwargs = _refuse_occupancy(render_kwargs)
    renderer = Renderer(field_apply=functools.partial(simple_star_apply, star_config),
                        head=head, Rs_per_ds=Rs_per_ds,
                        spec=_spec('simple_star', None, Rs_per_ds, render_kwargs,
                                   pixel_intensity_factor=pixel_intensity_factor),
                        **render_kwargs)

    def init(_generator: Optional[torch.Generator] = None) -> dict:
        p = init_simple_star(star_config, device)
        return {'coarse': p, 'fine': p}

    return renderer, init


def make_thomson_system(Rs_per_ds: float = 1.0,
                        model_config: Optional[NeRFConfig] = None,
                        use_fused: Optional[bool] = None,
                        device='cuda', **render_kwargs):
    """White-light Thomson-scattering SuNeRF (reference rendering/thompson.py,
    orphaned there): the emission field config (8x512 on the fused kernels)
    read as log10 electron density."""
    config = model_config or emission_config()
    render_kwargs = _refuse_occupancy(render_kwargs)
    fine_apply, _, init = _nerf_pair(config, None, use_fused, device)
    renderer = Renderer(field_apply=fine_apply,
                        head=ThomsonHead(Rs_per_ds=Rs_per_ds), Rs_per_ds=Rs_per_ds,
                        spec=_spec('thomson', config, Rs_per_ds, render_kwargs),
                        **render_kwargs)
    return renderer, init


def from_spec(spec: dict, use_fused: Optional[bool] = None, device='cuda'):
    """Rebuild a (renderer, init) pair from a serialized spec — the bundle
    reconstruction path of the evaluation loader. Specs of either package
    rebuild here."""
    head = spec['head']
    kwargs = dict(spec.get('render', {}))
    mc = spec.get('model_config')
    cc = spec.get('coarse_model_config')
    config = NeRFConfig(**mc) if mc else None
    coarse = NeRFConfig(**cc) if cc else None
    if head == 'emission':
        return make_emission_system(Rs_per_ds=spec['Rs_per_ds'], model_config=config,
                                    coarse_config=coarse, use_fused=use_fused,
                                    device=device, **kwargs)
    if head == 'density_temperature':
        return make_density_temperature_system(
            Rs_per_ds=spec['Rs_per_ds'], model_config=config, coarse_config=coarse,
            pixel_intensity_factor=spec.get('pixel_intensity_factor', 1e17),
            hierarchical_weighting=spec.get('hierarchical_weighting', 'density'),
            use_fused=use_fused, device=device, **kwargs)
    if head == 'simple_star':
        return make_simple_star_renderer(
            Rs_per_ds=spec['Rs_per_ds'],
            pixel_intensity_factor=spec.get('pixel_intensity_factor', 1e10),
            device=device, **kwargs)
    if head == 'thomson':
        return make_thomson_system(Rs_per_ds=spec['Rs_per_ds'], model_config=config,
                                   use_fused=use_fused, device=device, **kwargs)
    if head == 'mhd':
        raise NotImplementedError('the MHD field is not ported yet (ROADMAP Queue 1 '
                                  'item 9: PSI cubes, which need h5py)')
    raise ValueError(f'unknown head {head!r}')
