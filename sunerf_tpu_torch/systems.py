"""System factories wiring fields, heads and renderers together
(sunerf_tpu/systems.py): each returns a Renderer and an init function for
its parameters on `device`: the emission, density-temperature, SimpleStar,
Thomson and MHD systems. An occupancy config in the render kwargs (an OccupancyConfig or
a dict, as YAML and bundle specs carry it) adds the grid to the params as
params['occupancy']."""
from __future__ import annotations

import dataclasses
import functools
import warnings
from typing import Optional

import torch

from sunerf_tpu_torch.core.occupancy import OccupancyConfig, init_occupancy
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
    float32 field, with a warning, as in the JAX package. On the card a
    field runs on the fused kernels or, above 512 units or outside their
    heads, on the wide route (fused_mlp.kernel_route); one that no kernel
    takes (d_output 0) raises ValueError by name here, before any kernel
    runs (fused_mlp.check_kernel_config)."""
    cuda = torch.device(device).type == 'cuda'
    if use_fused is None:
        use_fused = cuda
    if use_fused and config.grid_rank:
        warnings.warn(
            'grid_rank/grid_time tables run the float32 field path, not the '
            'fused kernels: expect a lower step rate than dense-table or '
            'plain-MLP configs (systems._select_apply)', stacklevel=3)
        use_fused = False
    if use_fused:
        if cuda:
            from sunerf_tpu_torch.ops.fused_mlp import check_kernel_config
            check_kernel_config(config)
        # compute_dpts=False: the renderer detaches its sample points, so
        # the stashing backward computes no point cotangent
        return functools.partial(nerf_apply_fused, config, compute_dpts=False)
    return functools.partial(nerf_apply, config)


def _spec(head_name: str, config, Rs_per_ds, render_kwargs, **extra) -> dict:
    render = dict(render_kwargs)
    if isinstance(render.get('occupancy'), OccupancyConfig):
        render['occupancy'] = dataclasses.asdict(render['occupancy'])
    spec = {'head': head_name, 'Rs_per_ds': Rs_per_ds, 'render': render}
    if config is not None:
        spec['model_config'] = dataclasses.asdict(config)
    spec.update(extra)
    return spec


def _normalize_occupancy(render_kwargs: dict) -> dict:
    """Accept occupancy as an OccupancyConfig or a plain dict (YAML configs,
    deserialized specs); returns kwargs with an OccupancyConfig, or without
    the key. A falsy value or enabled: false disables it."""
    kwargs = dict(render_kwargs)
    occ = kwargs.get('occupancy')
    if occ is None or occ is False:
        kwargs.pop('occupancy', None)
        return kwargs
    if isinstance(occ, dict):
        occ = dict(occ)
        if not occ.pop('enabled', True):
            kwargs.pop('occupancy', None)
            return kwargs
        if occ.get('nvol') is not None:
            occ['nvol'] = tuple(occ['nvol'])  # JSON/YAML round-trips as list
        kwargs['occupancy'] = OccupancyConfig(**occ)
    return kwargs


def _with_occupancy(init_fn, occupancy: Optional[OccupancyConfig], device):
    """Wrap an init function to add the (fully occupied) occupancy grid to
    the params as params['occupancy'], tensors without gradients that the
    optimizer leaves alone (train/step.create_train_state)."""
    if occupancy is None:
        return init_fn

    def init(generator: Optional[torch.Generator] = None) -> dict:
        params = init_fn(generator) if generator is not None else init_fn()
        params['occupancy'] = init_occupancy(occupancy, device)
        return params

    return init


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
    render_kwargs = _normalize_occupancy(render_kwargs)
    fine_apply, coarse_apply, init = _nerf_pair(config, coarse_config, use_fused, device)
    renderer = Renderer(
        field_apply=fine_apply, coarse_field_apply=coarse_apply,
        head=EmissionHead(Rs_per_ds=Rs_per_ds), Rs_per_ds=Rs_per_ds,
        spec=_spec('emission', config, Rs_per_ds, render_kwargs,
                   **_coarse_extra(coarse_config)),
        **render_kwargs)
    return renderer, _with_occupancy(init, renderer.occupancy, device)


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
    render_kwargs = _normalize_occupancy(render_kwargs)
    fine_apply, coarse_apply, init = _nerf_pair(config, coarse_config, use_fused, device)
    renderer = Renderer(
        field_apply=fine_apply, coarse_field_apply=coarse_apply,
        head=head, Rs_per_ds=Rs_per_ds,
        spec=_spec('density_temperature', config, Rs_per_ds, render_kwargs,
                   pixel_intensity_factor=pixel_intensity_factor,
                   hierarchical_weighting=hierarchical_weighting,
                   **_coarse_extra(coarse_config)),
        **render_kwargs)
    return renderer, _with_occupancy(init, renderer.occupancy, device)


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
    render_kwargs = _normalize_occupancy(render_kwargs)
    renderer = Renderer(field_apply=functools.partial(simple_star_apply, star_config),
                        head=head, Rs_per_ds=Rs_per_ds,
                        spec=_spec('simple_star', None, Rs_per_ds, render_kwargs,
                                   pixel_intensity_factor=pixel_intensity_factor),
                        **render_kwargs)

    def init(_generator: Optional[torch.Generator] = None) -> dict:
        p = init_simple_star(star_config, device)
        return {'coarse': p, 'fine': p}

    return renderer, _with_occupancy(init, renderer.occupancy, device)


def make_thomson_system(Rs_per_ds: float = 1.0,
                        model_config: Optional[NeRFConfig] = None,
                        use_fused: Optional[bool] = None,
                        device='cuda', **render_kwargs):
    """White-light Thomson-scattering SuNeRF (reference rendering/thompson.py,
    orphaned there): the emission field config (8x512 on the fused kernels)
    read as log10 electron density."""
    config = model_config or emission_config()
    render_kwargs = _normalize_occupancy(render_kwargs)
    fine_apply, _, init = _nerf_pair(config, None, use_fused, device)
    renderer = Renderer(field_apply=fine_apply,
                        head=ThomsonHead(Rs_per_ds=Rs_per_ds), Rs_per_ds=Rs_per_ds,
                        spec=_spec('thomson', config, Rs_per_ds, render_kwargs),
                        **render_kwargs)
    return renderer, _with_occupancy(init, renderer.occupancy, device)


def make_mhd_renderer(loader, Rs_per_ds: float = 1.0,
                      response: Optional[TemperatureResponse] = None,
                      pixel_intensity_factor: float = 1e10, **render_kwargs):
    """PSI MHD simulation cubes rendered through the DT head (reference
    image_render.py:235-259 with MHDModel). Returns (renderer, params): the
    cubes live in the field (loader.field, on the loader's device), the
    params are log_abs and vol_c only."""
    from sunerf_tpu_torch.models.mhd_field import mhd_apply
    device = loader.device
    response = response or load_aia_response(device=device)
    head = DensityTemperatureHead(response=response,
                                  pixel_intensity_factor=pixel_intensity_factor,
                                  Rs_per_ds=Rs_per_ds)
    render_kwargs = _normalize_occupancy(render_kwargs)
    renderer = Renderer(field_apply=functools.partial(mhd_apply, loader.field),
                        head=head, Rs_per_ds=Rs_per_ds,
                        spec=_spec('mhd', None, Rs_per_ds, render_kwargs,
                                   pixel_intensity_factor=pixel_intensity_factor,
                                   data_path=loader.data_path),
                        **render_kwargs)
    p = loader.init_params()
    params = {'coarse': p, 'fine': p}
    if renderer.occupancy is not None:
        params['occupancy'] = init_occupancy(renderer.occupancy, device)
    return renderer, params


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
        from sunerf_tpu_torch.models.mhd_field import MHDFieldLoader
        data_path = spec.get('data_path')
        if not data_path:
            raise ValueError('mhd spec carries no data_path (cube files are not '
                             'serialized into the bundle)')
        renderer, params = make_mhd_renderer(
            MHDFieldLoader(data_path, device=device), Rs_per_ds=spec['Rs_per_ds'],
            pixel_intensity_factor=spec.get('pixel_intensity_factor', 1e10), **kwargs)
        return renderer, (lambda _generator=None: params)
    raise ValueError(f'unknown head {head!r}')
