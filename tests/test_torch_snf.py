"""The port's reference-checkpoint converter (sunerf_tpu_torch/utils/
snf_converter.py) against the JAX package's, the kernels' refusal of a
converted field they cannot take, and ServingModel's device mapping.

A reference-style save_state.snf is built as tests/test_torch_parity.py
builds one: module-level torch classes of the reference's shapes, pickled
under sunerf.* module names that are then removed, so unpickling goes
through the converters' stub modules. Weights come from torch.manual_seed.

Tolerances: converted parameters bit-equal (both converters transpose the
same float32 arrays) and the config dicts equal; the converted bundle's
renders by the two packages' loaders on the CPU within 1e-5 of max at a
close observer (3 Rs: the fp32 tolerance of tests/test_torch_eval.py; at
1 AU the ray-sphere clip is ill-conditioned in float32). The card-only
tests (marker gpu, skipped without a card) hold a served frame on the last
card, and a converted 8x512 frame on K0, to the bits of the same frame on
cuda:0 and from the committed bundle. The JAX package is imported inside
the CPU tests, so that the card's host (torch alone) collects this file:

    python -m pytest --noconftest -m gpu tests/test_torch_snf.py -q
"""
import io
import os
import sys
import types

import numpy as np
import pytest
import torch
import torch.nn as nn

from sunerf_tpu_torch.evaluation.loader import SuNeRFLoader
from sunerf_tpu_torch.evaluation.serving import (ServingModel, _cards_to, export_programs,
                                                 export_serving, map_program)
from sunerf_tpu_torch.models.fields import AIA_WAVELENGTHS, NeRFConfig
from sunerf_tpu_torch.ops.fused_mlp import check_kernel_config, kernel_route
from sunerf_tpu_torch.systems import from_spec
from sunerf_tpu_torch.utils import snf_converter
from sunerf_tpu_torch.utils.checkpoint import load_state

torch.set_num_threads(1)

TOL = 1e-5
NEAR = 3.0
BUNDLE = os.path.join(os.path.dirname(__file__), '..', 'artifacts_r4', 's8_probe_rerun_best')
VIEW = dict(lat=0.3, lon=1.1, time=0.0)


# ---- reference-shaped torch classes (module level: pickle finds them) ----

class RefSine(nn.Module):
    def forward(self, x):
        return torch.sin(x)


class RefPositionalEncoding(nn.Module):
    def __init__(self):
        super().__init__()
        self.register_buffer('freq_bands', 2.0 ** torch.linspace(0., 9., 10))


class RefNeRF(nn.Module):
    def __init__(self, n_layers=8, width=512, d_output=2, dt=False):
        super().__init__()
        self.in_layer = nn.Sequential(RefPositionalEncoding(), nn.Linear(84, width))
        self.layers = nn.ModuleList([nn.Linear(width, width) for _ in range(n_layers - 1)])
        self.out_layer = nn.Linear(width, d_output)
        self.act = RefSine()
        if dt:
            self.log_absortpion = nn.ParameterDict(
                {str(wl): nn.Parameter(torch.randn(())) for wl in AIA_WAVELENGTHS})
            self.volumetric_constant = nn.Parameter(torch.rand(()))


class RefRendering(nn.Module):
    def __init__(self, fine, coarse):
        super().__init__()
        self.coarse_model = coarse
        self.fine_model = fine


# the reference's module paths and class names
_AS = {RefSine: ('sunerf.model.model', 'Sine'),
       RefPositionalEncoding: ('sunerf.model.model', 'PositionalEncoding'),
       RefNeRF: ('sunerf.model.model', 'NeRF'),
       RefRendering: ('sunerf.rendering.emission', 'EmissionRadiativeTransfer')}


def _drop_reference_modules():
    for name in [m for m in sys.modules if m == 'sunerf' or m.startswith('sunerf.')]:
        del sys.modules[name]


def write_snf(path, rendering, **state):
    """torch.save a reference-style state whose classes pickle under the
    reference's module names, which are then removed again."""
    _drop_reference_modules()
    saved = {cls: (cls.__module__, cls.__qualname__) for cls in _AS}
    try:
        for cls, (mod, name) in _AS.items():
            parts = mod.split('.')
            for i in range(1, len(parts) + 1):
                dotted = '.'.join(parts[:i])
                sys.modules.setdefault(dotted, types.ModuleType(dotted))
                if i > 1:
                    setattr(sys.modules['.'.join(parts[:i - 1])], parts[i - 1],
                            sys.modules[dotted])
            setattr(sys.modules[mod], name, cls)
            cls.__module__, cls.__qualname__ = mod, name
        torch.save({'rendering': rendering, 'Rs_per_ds': 1.0, 'seconds_per_dt': 86400.0,
                    'ref_time': '2012-08-23T00:00:00', **state}, path)
    finally:
        for cls, (mod, name) in saved.items():
            cls.__module__, cls.__qualname__ = mod, name
        _drop_reference_modules()
    return str(path)


def _snf(tmp_path, n_layers, width, d_output=2, dt=False, seed=0):
    torch.manual_seed(seed)
    rendering = RefRendering(RefNeRF(n_layers, width, d_output, dt),
                             RefNeRF(n_layers, width, d_output, dt))
    return write_snf(tmp_path / f'save_state_{n_layers}x{width}.snf', rendering), rendering


def _convert(fn, path):
    """A converter run with no reference module left over from another."""
    _drop_reference_modules()
    try:
        return fn(path)
    finally:
        _drop_reference_modules()


@pytest.mark.parametrize('n_layers,width,dt', [(2, 48, False), (8, 64, False), (2, 48, True)])
def test_converter_matches_jax(tmp_path, n_layers, width, dt):
    from sunerf_tpu.utils.snf_converter import convert_snf as jax_convert_snf
    path, rendering = _snf(tmp_path, n_layers, width, dt=dt)
    params, config = _convert(snf_converter.convert_snf, path)
    jparams, jconfig = _convert(jax_convert_snf, path)
    assert config == jconfig
    assert config['type'] == ('density_temperature' if dt else 'emission')
    for field, module in (('fine', rendering.fine_model), ('coarse', rendering.coarse_model)):
        assert params[field].keys() == jparams[field].keys()
        for k, v in params[field].items():
            assert v.dtype == jparams[field][k].dtype and np.array_equal(v, jparams[field][k])
        np.testing.assert_array_equal(params[field]['w_in'],
                                      module.in_layer[1].weight.detach().numpy().T)
        np.testing.assert_array_equal(params[field]['w_h'][-1],
                                      module.layers[-1].weight.detach().numpy().T)
    assert params['fine']['w_h'].shape == (n_layers - 1, width, width)
    assert config['renderer_spec']['model_config']['d_filter'] == width


def test_converter_cli_matches_jax(tmp_path):
    from sunerf_tpu.utils.snf_converter import main as jax_main
    path, _ = _snf(tmp_path, 2, 48)
    _convert(lambda p: snf_converter.main(['--snf', p, '--out', str(tmp_path / 'port')]), path)
    _convert(lambda p: jax_main(['--snf', p, '--out', str(tmp_path / 'jax')]), path)
    got, want = load_state(str(tmp_path / 'port')), load_state(str(tmp_path / 'jax'))
    assert got[1] == want[1]
    for field in ('fine', 'coarse'):
        for k, v in want[0][field].items():
            np.testing.assert_array_equal(got[0][field][k], v)


def _of_max(ref, got) -> float:
    ref, got = np.asarray(ref, np.float64), np.asarray(got, np.float64)
    return float(np.max(np.abs(ref - got)) / max(np.max(np.abs(ref)), 1e-30))


@pytest.mark.parametrize('n_layers,width', [(2, 48), (8, 64)])
def test_converted_bundle_renders_like_jax(tmp_path, n_layers, width):
    """The converted bundle through both packages' loaders (the port's float32
    field on the CPU) at a close observer."""
    from sunerf_tpu.evaluation.loader import SuNeRFLoader as JaxLoader
    path, _ = _snf(tmp_path, n_layers, width, seed=n_layers)
    out = str(tmp_path / 'bundle')
    _convert(lambda p: snf_converter.main(['--snf', p, '--out', out]), path)
    overrides = {'n_stratified': 16, 'n_hierarchical': 16}
    got = SuNeRFLoader(out, render_overrides=overrides, device='cpu').render_observer_image(
        distance=NEAR, resolution=8, **VIEW)
    want = JaxLoader(out, render_overrides=overrides).render_observer_image(
        distance=NEAR, resolution=8, **VIEW)
    for k in ('image', 'height_map', 'absorption_map'):
        assert _of_max(getattr(want, k), getattr(got, k)) <= TOL, k


def test_converter_describes_a_proposal_coarse_field(tmp_path):
    """A coarse field of its own shape gets coarse_model_config, so the
    bundle loads (JAX's converter leaves it out)."""
    torch.manual_seed(1)
    path = write_snf(tmp_path / 'proposal.snf', RefRendering(RefNeRF(3, 64), RefNeRF(2, 32)))
    params, config = _convert(snf_converter.convert_snf, path)
    spec = config['renderer_spec']
    assert spec['coarse_model_config']['d_filter'] == 32
    assert spec['coarse_model_config']['n_layers'] == 2
    renderer, _ = from_spec(spec, device='cpu')
    assert renderer.coarse_field_apply is not None


@pytest.mark.parametrize('width,d_output,route', [(640, 2, 'wide'), (64, 9, 'wide'),
                                               (64, 0, None)])
def test_converted_field_outside_the_fused_kernels_takes_the_wide_route(tmp_path, width,
                                                                       d_output, route):
    """A converted 2x640 field, or one with d_output outside the fused
    heads (9), is accepted by the CUDA path's check and routed to the wide
    kernels (ops/fused_mlp.kernel_route), and the float32 field serves it on
    the CPU; d_output 0, which JAX's kernels refuse too, raises ValueError
    naming it at the check (called directly, and through from_spec for the
    card, before any tensor is made)."""
    path, _ = _snf(tmp_path, 2, width, d_output=max(d_output, 1))
    params, config = _convert(snf_converter.convert_snf, path)
    mc = dict(config['renderer_spec']['model_config'], d_output=d_output)
    spec = dict(config['renderer_spec'], model_config=mc)
    if route is None:
        with pytest.raises(ValueError, match=f'got {d_output}$'):
            check_kernel_config(NeRFConfig(**mc))
        with pytest.raises(ValueError, match=f'got {d_output}$'):
            from_spec(spec, device='cuda')
        return
    check_kernel_config(NeRFConfig(**mc))
    assert kernel_route(NeRFConfig(**mc)) == kernel_route(NeRFConfig(**mc), True) == route
    out = str(tmp_path / 'wide')
    _convert(lambda p: snf_converter.main(['--snf', p, '--out', out]), path)
    view = SuNeRFLoader(out, render_overrides={'n_stratified': 8, 'n_hierarchical': 8},
                        device='cpu').render_observer_image(distance=NEAR, resolution=4, **VIEW)
    assert np.isfinite(view.image).all()


def _tiny_export(fused: bool):
    from sunerf_tpu_torch.models.fields import emission_config
    from sunerf_tpu_torch.systems import make_emission_system
    renderer, init = make_emission_system(
        model_config=emission_config(n_layers=2, d_filter=32, n_freqs=4), n_stratified=8,
        n_hierarchical=8, use_fused=False, device='cpu')
    params = init(torch.Generator().manual_seed(0))
    params_np = {k: {kk: vv.numpy() for kk, vv in v.items()} for k, v in params.items()}
    return export_programs(renderer.spec, params_np, 'cpu', 64, 0, fused=fused)


def _program_devices(program) -> list:
    """The devices an exported program names: its factory calls' device
    arguments, its nodes' tensor metadata, its buffers and constants."""
    devices = [torch.device(n.kwargs['device']) for n in program.graph.nodes
               if 'device' in n.kwargs]
    devices += [n.meta['val'].device for n in program.graph.nodes
                if isinstance(n.meta.get('val'), torch.Tensor)]
    devices += [t.device for t in program.state_dict.values()]
    return devices + [t.device for t in program.constants.values()
                      if isinstance(t, torch.Tensor)]


@pytest.mark.parametrize('fused', [False, True])
def test_map_program_moves_every_device(fused):
    """ServingModel's device mapping on a CPU program (and one calling the
    K0 op), mapped cpu -> meta: every factory call's device, every constant
    and buffer and every node's tensor metadata moved, and the program runs
    there."""
    render, points, _ = _tiny_export(fused)
    for blob, args in ((render, [(64, 3), (64, 3), (64, 1), (64, 0)]), (points, [(64, 4)])):
        program = torch.export.load(io.BytesIO(blob))
        assert {d.type for d in _program_devices(program)} == {'cpu'}
        program = map_program(program, {'cpu': 'meta'})
        assert {d.type for d in _program_devices(program)} == {'meta'}
        outs = program.module()(*(torch.zeros(s, device='meta') for s in args))
        outs = outs if isinstance(outs, (tuple, list)) else [outs]
        assert all(o.device.type == 'meta' for o in outs)
    factory = [n for n in torch.export.load(io.BytesIO(render)).graph.nodes
               if 'device' in n.kwargs]
    assert factory or not fused


def test_cards_to_names_every_card():
    mapping = _cards_to(torch.device('cuda', 3))
    assert mapping['cuda'] == torch.device('cuda', 3)
    assert all(mapping[f'cuda:{i}'] == torch.device('cuda', 3)
               for i in range(torch.cuda.device_count()))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the K0 op has no CPU launch')
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device('cuda')


def _views_equal(a, b):
    for k in ('image', 'height_map', 'absorption_map'):
        assert np.array_equal(getattr(a, k), getattr(b, k)), k


@pytest.mark.gpu
def test_artifact_serves_on_every_card(cuda, tmp_path):
    """The committed bundle's artifact, traced on cuda:0, served on every
    card of the host: cuda:0's bits."""
    art = str(tmp_path / 'bundle.tsrv')
    export_serving(BUNDLE, art, platforms=('cuda',))
    ref = ServingModel(art, device='cuda:0').render_observer_image(
        distance=215.0, resolution=64, **VIEW)
    for k in range(torch.cuda.device_count()):
        model = ServingModel(art, device=f'cuda:{k}')
        assert model.device == torch.device('cuda', k)
        _views_equal(model.render_observer_image(distance=215.0, resolution=64, **VIEW), ref)


@pytest.mark.gpu
def test_converted_reference_frame_on_k0(cuda, tmp_path):
    """A reference .snf holding the committed bundle's 8x512 fine and 4x128
    coarse fields, converted: the same parameters bit for bit, and its frame
    on K0 the bundle's own frame at the converter's render spec."""
    from sunerf_tpu_torch.ops import fused_mlp
    params, config = load_state(BUNDLE)
    spec = config['renderer_spec']
    fields = {}
    for key, mc in (('fine', spec['model_config']), ('coarse', spec['coarse_model_config'])):
        module = RefNeRF(mc['n_layers'], mc['d_filter'])
        p = params[key]
        with torch.no_grad():
            module.in_layer[1].weight.copy_(torch.as_tensor(p['w_in'].T))
            module.in_layer[1].bias.copy_(torch.as_tensor(p['b_in']))
            for i, layer in enumerate(module.layers):
                layer.weight.copy_(torch.as_tensor(p['w_h'][i].T))
                layer.bias.copy_(torch.as_tensor(p['b_h'][i]))
            module.out_layer.weight.copy_(torch.as_tensor(p['w_out'].T))
            module.out_layer.bias.copy_(torch.as_tensor(p['b_out']))
        fields[key] = module
    path = write_snf(tmp_path / 'save_state.snf', RefRendering(fields['fine'], fields['coarse']))
    out = str(tmp_path / 'converted')
    _convert(lambda p: snf_converter.main(['--snf', p, '--out', out]), path)
    got, got_config = load_state(out)
    for key in ('fine', 'coarse'):
        for k, v in params[key].items():
            assert np.array_equal(got[key][k], v), (key, k)
    render = got_config['renderer_spec'].get('render') or {}
    before = fused_mlp.LAUNCHES
    view = SuNeRFLoader(out, device='cuda').render_observer_image(
        distance=215.0, resolution=64, **VIEW)
    assert fused_mlp.LAUNCHES - before == 2
    want = SuNeRFLoader(BUNDLE, render_overrides={'n_stratified': 64, 'n_hierarchical': 128,
                                                  **render},
                        device='cuda').render_observer_image(distance=215.0, resolution=64,
                                                             **VIEW)
    _views_equal(view, want)
