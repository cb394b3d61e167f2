"""One-way converter: reference `save_state.snf` (pickled live torch modules,
sunerf/model/sunerf.py:62-74) -> deployment bundle (sunerf_tpu/utils/
snf_converter.py; the bundle is the format utils/checkpoint.py writes, which
both packages' loaders read).

The reference pickles the entire rendering nn.Module, so loading normally
requires the reference package plus astropy/sunpy/xitorch. This converter
installs stub modules for every `sunerf.*` import the pickle references
(torch modules restore their state through plain __dict__ updates, so stubs
subclassing nn.Module round-trip the parameters faithfully), walks the
restored module tree, and maps the parameters onto our pytree layout:

  reference (torch, [out, in] weights)      bundle ([in, out])
  coarse_model.in_layer.1.weight/bias   ->  coarse.w_in (T), coarse.b_in
  coarse_model.layers.{i}.weight/bias   ->  coarse.w_h[i] (T), coarse.b_h[i]
  coarse_model.out_layer.weight/bias    ->  coarse.w_out (T), coarse.b_out
  *.log_absortpion.{94..335}            ->  *.log_abs [7]
  *.volumetric_constant                 ->  *.vol_c
  (same for fine_model)

The widths come from the weights; a coarse field of another shape than the
fine one (a proposal field) gets the spec's coarse_model_config, which JAX's
converter does not write (its config is otherwise the same dict). A
converted field may have any width and output count: one that the fused
kernels cannot hold (d_filter above 512, d_output outside their heads) runs
on the card on the wide route (ops/fused_mlp.kernel_route,
ops/wide_mlp.py); only d_output 0 is refused by name
(ops/fused_mlp.check_kernel_config), as JAX's kernels refuse it.

Usage:
  python -m sunerf_tpu_torch.utils.snf_converter --snf save_state.snf --out save_state
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import types

import numpy as np

from sunerf_tpu_torch.models.fields import AIA_WAVELENGTHS, NeRFConfig

_STUB_PREFIXES = ('sunerf', 'xitorch', 'itipy', 'sunpy', 'astropy')


def _install_stub_modules():
    """Make every reference-package import resolvable with nn.Module stubs."""
    import torch.nn as nn

    class _StubModule(nn.Module):
        """Accepts any pickled state; behaves as a plain attribute bag."""

        def __init__(self, *args, **kwargs):  # not called: unpickling skips it
            super().__init__()

        def __setstate__(self, state):
            # nn.Module.__setstate__ handles missing keys poorly pre-init;
            # initialize the module machinery first
            nn.Module.__init__(self)
            if isinstance(state, dict):
                self.__dict__.update(state)

    class _StubAny:
        def __init__(self, *a, **k):
            pass

        def __setstate__(self, state):
            if isinstance(state, dict):
                self.__dict__.update(state)

    created = []

    class _StubModuleType(types.ModuleType):
        def __getattr__(self, name):
            if name.startswith('__'):
                raise AttributeError(name)
            # heuristics: reference classes under model/rendering are Modules
            return _StubModule if self.__name__.startswith('sunerf') else _StubAny

    import importlib.abc
    import importlib.machinery

    class _Loader(importlib.abc.Loader):
        def create_module(self, spec):
            mod = _StubModuleType(spec.name)
            mod.__path__ = []  # behave as a package for submodule imports
            created.append(spec.name)
            return mod

        def exec_module(self, module):
            pass

    class _Finder(importlib.abc.MetaPathFinder):
        def find_spec(self, fullname, path=None, target=None):
            if fullname.split('.')[0] in _STUB_PREFIXES:
                return importlib.machinery.ModuleSpec(fullname, _Loader(),
                                                      is_package=True)
            return None

    finder = _Finder()
    sys.meta_path.insert(0, finder)
    return finder, created


def _collect_tensors(obj, prefix='', out=None, seen=None):
    """Walk an unpickled object graph collecting torch tensors by path."""
    import torch
    if out is None:
        out, seen = {}, set()
    if id(obj) in seen:
        return out
    seen.add(id(obj))

    if isinstance(obj, torch.Tensor):
        out[prefix.rstrip('.')] = obj.detach().cpu().numpy()
        return out
    if isinstance(obj, dict):
        for k, v in obj.items():
            _collect_tensors(v, f'{prefix}{k}.', out, seen)
        return out
    if isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            _collect_tensors(v, f'{prefix}{i}.', out, seen)
        return out
    if hasattr(obj, '__dict__'):
        for k, v in vars(obj).items():
            if k.startswith('_') and k not in ('_parameters', '_buffers',
                                               '_modules'):
                continue
            name = '' if k in ('_parameters', '_buffers', '_modules') else k
            _collect_tensors(v, f'{prefix}{name}.' if name else prefix, out, seen)
    return out


def _to_field_params(tensors: dict, model_prefix: str) -> dict:
    """Map one model's tensors (reference names) to the bundle's params."""
    def get(name):
        key = f'{model_prefix}.{name}'
        if key not in tensors:
            raise KeyError(f'{key} not found; available: '
                           f'{[k for k in tensors if k.startswith(model_prefix)][:10]}')
        return tensors[key]

    n_hidden = len({k.split('.')[2] for k in tensors
                    if k.startswith(f'{model_prefix}.layers.')})
    params = {
        'w_in': np.ascontiguousarray(get('in_layer.1.weight').T),
        'b_in': get('in_layer.1.bias'),
        'w_h': np.stack([np.ascontiguousarray(get(f'layers.{i}.weight').T)
                         for i in range(n_hidden)]),
        'b_h': np.stack([get(f'layers.{i}.bias') for i in range(n_hidden)]),
        'w_out': np.ascontiguousarray(get('out_layer.weight').T),
        'b_out': get('out_layer.bias'),
    }
    # DT aux params (NeRF_DT, model.py:157-167)
    abs_keys = [f'{model_prefix}.log_absortpion.{wl}' for wl in AIA_WAVELENGTHS]
    if all(k in tensors for k in abs_keys):
        params['log_abs'] = np.asarray([tensors[k] for k in abs_keys],
                                       np.float32).reshape(-1)
        params['vol_c'] = np.asarray(
            tensors[f'{model_prefix}.volumetric_constant'], np.float32).reshape(())
    return params


def convert_snf(snf_path: str, head: str | None = None) -> tuple[dict, dict]:
    """Load a reference .snf and return (params pytree, config dict)."""
    import torch
    finder, _created = _install_stub_modules()
    try:
        state = torch.load(snf_path, map_location='cpu', weights_only=False)
    finally:
        sys.meta_path.remove(finder)

    tensors = _collect_tensors(state.get('rendering'))
    params = {'coarse': _to_field_params(tensors, 'coarse_model'),
              'fine': _to_field_params(tensors, 'fine_model')}

    if head is None:
        head = ('density_temperature' if 'log_abs' in params['fine']
                else 'emission')
    config = {
        'type': head,
        'Rs_per_ds': float(state.get('Rs_per_ds', 1.0)),
        'seconds_per_dt': float(state.get('seconds_per_dt', 86400.0)),
        'ref_time': str(state.get('ref_time', '')),
        'renderer_spec': {'head': head,
                          'Rs_per_ds': float(state.get('Rs_per_ds', 1.0)),
                          'render': {},
                          'model_config': None},
    }
    # model config recovered from tensor shapes
    config['renderer_spec']['model_config'] = dataclasses.asdict(
        _field_config(params['fine'], head))
    coarse = _field_config(params['coarse'], head)
    if dataclasses.asdict(coarse) != config['renderer_spec']['model_config']:
        # the reference's two fields share one architecture; a coarse field
        # of its own shape (a proposal field) is described as the renderer
        # spec describes one, which JAX's converter leaves out
        config['renderer_spec']['coarse_model_config'] = dataclasses.asdict(coarse)
    return params, config


def _field_config(params: dict, head: str) -> NeRFConfig:
    return NeRFConfig(d_input=4, d_output=params['w_out'].shape[1],
                      n_layers=params['w_h'].shape[0] + 1,
                      d_filter=params['w_in'].shape[1],
                      with_aux='log_abs' in params,
                      base_log_density=10.0 if head == 'density_temperature' else 0.0,
                      base_log_temperature=5.0 if head == 'density_temperature' else 0.0)


def main(argv=None):
    from sunerf_tpu_torch.utils.checkpoint import save_state
    parser = argparse.ArgumentParser()
    parser.add_argument('--snf', required=True)
    parser.add_argument('--out', required=True, help='output bundle basename')
    parser.add_argument('--head', default=None,
                        choices=[None, 'emission', 'density_temperature'])
    args = parser.parse_args(argv)
    params, config = convert_snf(args.snf, head=args.head)
    save_state(args.out, params, config)
    print(f'converted {args.snf} -> {args.out}.npz/.json '
          f'(head={config["type"]})')


if __name__ == '__main__':
    main()
