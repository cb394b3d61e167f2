"""The port's render path (sunerf_tpu_torch) against the JAX package on the
CPU: emission head, renderer, bundle loader, golden render, flyby, bundle IO,
the no-fallback rule and import hygiene.

Tolerances, as fractions of max|reference|:
  * 1e-4 for float32 renders against the JAX package's jitted loader at a
    well-conditioned pose (observer at 3 Rs). At 1 AU (215 Rs) the ray-sphere
    clip cancels ~5 digits of |o|^2 in float32, and XLA's fused program and
    op-by-op float32 differ from each other by several percent of max — so
    renders at 215 Rs are held against the op-by-op JAX render (the golden),
    whose arithmetic the port repeats (1e-3);
  * 3e-2 for the bf16 fused path: bf16 rounding flips compound over 8
    trained layers.

Regenerate the golden render with `PYTHONPATH=. python tests/test_torch_render.py`.
"""
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sunerf_tpu.evaluation.loader import SuNeRFLoader as JaxLoader
from sunerf_tpu.models.fields import FieldOutput as JaxFieldOutput
from sunerf_tpu.models.fields import emission_config as jax_emission_config
from sunerf_tpu.rendering.emission import EmissionHead as JaxEmissionHead
from sunerf_tpu.rendering.emission import exclusive_cumprod as jax_excl_cumprod
from sunerf_tpu.rendering.emission import ray_deltas as jax_ray_deltas
from sunerf_tpu.systems import make_emission_system as jax_make_emission_system
from sunerf_tpu.utils.checkpoint import load_state as jax_load_state
from sunerf_tpu_torch.core.geometry import observer_rays
from sunerf_tpu_torch.evaluation import loader as port_loader
from sunerf_tpu_torch.evaluation.loader import SuNeRFLoader
from sunerf_tpu_torch.evaluation.video import main as video_main
from sunerf_tpu_torch.models.fields import (FieldOutput, NeRFConfig, emission_config,
                                            nerf_apply, params_from_numpy)
from sunerf_tpu_torch.ops import fused_mlp
from sunerf_tpu_torch.rendering.emission import EmissionHead, exclusive_cumprod, ray_deltas
from sunerf_tpu_torch.systems import from_spec, make_emission_system
from sunerf_tpu_torch.utils.checkpoint import load_state, save_state

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
BUNDLE = str(REPO / 'artifacts_r4' / 's8_probe_rerun_best')
GOLDEN = REPO / 'sunerf_tpu_torch' / 'assets' / 's8_golden_32.npz'
# lat, lon, time, distance, resolution
GOLDEN_VIEW = (0.3, 1.1, 0.0, 215.0, 32)
MAPS = ('image', 'height_map', 'absorption_map')
TINY = dict(n_layers=3, d_filter=64, n_freqs=4)


def _view_kwargs(view):
    lat, lon, time, distance, resolution = view
    return dict(lat=float(lat), lon=float(lon), time=float(time),
                distance=float(distance), resolution=int(resolution))


def _rel(ref, got) -> float:
    ref, got = np.asarray(ref), np.asarray(got)
    assert ref.shape == got.shape, (ref.shape, got.shape)
    return float(np.max(np.abs(ref - got)) / np.max(np.abs(ref)))


def _jax_golden(use_fused: bool) -> dict:
    """The JAX package's render of the golden view, run op by op — the float32
    arithmetic the port repeats (see the module docstring)."""
    with jax.disable_jit():
        view = JaxLoader(BUNDLE, batch_size=1024, use_fused=use_fused) \
            .render_observer_image(**_view_kwargs(GOLDEN_VIEW))
    tag = 'fused' if use_fused else 'unfused'
    return {f'{tag}/{k}': np.asarray(getattr(view, k)) for k in MAPS}


def _tiny_params(rng, config) -> dict:
    """numpy-seeded params in the shared layout (the same values go to both
    packages)."""
    def lin(fan_in, fan_out, *lead):
        b = 1.0 / np.sqrt(fan_in)
        return (rng.uniform(-b, b, (*lead, fan_in, fan_out)).astype(np.float32),
                rng.uniform(-b, b, (*lead, fan_out)).astype(np.float32))
    w_in, b_in = lin(config.d_encoded, config.d_filter)
    w_h, b_h = lin(config.d_filter, config.d_filter, config.n_layers - 1)
    w_out, b_out = lin(config.d_filter, config.d_output)
    return dict(w_in=w_in, b_in=b_in, w_h=w_h, b_h=b_h, w_out=w_out, b_out=b_out)


# ------------------------------------------------------------- emission head

def test_emission_head_matches_jax():
    rng = np.random.default_rng(0)
    R, S = 16, 24
    raw = rng.normal(0, 1, (R, S, 2)).astype(np.float32)
    z = np.sort(rng.uniform(1, 4, (R, S)).astype(np.float32), axis=-1)
    d = rng.normal(0, 1, (R, 3)).astype(np.float32)
    dist = rng.uniform(0.5, 2.0, (R, S)).astype(np.float32)

    jh, th = JaxEmissionHead(Rs_per_ds=1.0), EmissionHead(Rs_per_ds=1.0)
    jo = jh.raw2outputs(JaxFieldOutput(raw=jnp.asarray(raw)), jnp.asarray(z),
                        jnp.zeros((R, 3)), jnp.asarray(d), jnp.zeros((R, S, 3)))
    to = th.raw2outputs(FieldOutput(raw=torch.from_numpy(raw)), torch.from_numpy(z),
                        torch.zeros(R, 3), torch.from_numpy(d), torch.zeros(R, S, 3))
    for k in ('image', 'weights', 'regularizing_quantity'):
        assert _rel(jo[k], to[k].numpy()) < 1e-5, k
    reg_j = jh.regularization(jnp.asarray(dist), jo['regularizing_quantity'])
    reg_t = th.regularization(torch.from_numpy(dist), to['regularizing_quantity'])
    assert reg_t.shape == (R, S)
    np.testing.assert_allclose(reg_t.numpy(), np.asarray(reg_j), atol=1e-6)
    x = rng.uniform(0.5, 1.0, (R, S)).astype(np.float32)
    np.testing.assert_allclose(exclusive_cumprod(torch.from_numpy(x)).numpy(),
                               np.asarray(jax_excl_cumprod(jnp.asarray(x))),
                               rtol=1e-6)
    np.testing.assert_allclose(ray_deltas(torch.from_numpy(z), torch.from_numpy(d)).numpy(),
                               np.asarray(jax_ray_deltas(jnp.asarray(z), jnp.asarray(d))),
                               rtol=1e-5, atol=1e-6)


# ------------------------------------------------------------------ renderer

@pytest.mark.parametrize('coarse', [False, True])
def test_renderer_matches_jax_on_tiny_params(coarse):
    """Every output key of Renderer.__call__ at key=None, with the proposal
    coarse field on and off."""
    rng = np.random.default_rng(3)
    jc, tc = jax_emission_config(**TINY), emission_config(**TINY)
    cc = dict(n_layers=2, d_filter=64, n_freqs=4) if coarse else None
    params = {'fine': _tiny_params(rng, tc),
              'coarse': _tiny_params(rng, emission_config(**(cc or TINY)))}
    kw = dict(n_stratified=12, n_hierarchical=16, perturb=False)
    jr, _ = jax_make_emission_system(
        model_config=jc, use_fused=False,
        coarse_config=jax_emission_config(**cc) if cc else None, **kw)
    tr, _ = make_emission_system(
        model_config=tc, use_fused=False, device='cpu',
        coarse_config=emission_config(**cc) if cc else None, **kw)
    R = 32
    o = np.tile(np.array([[3.0, 0.4, -0.2]], np.float32), (R, 1))
    d = rng.normal(0, 1, (R, 3)).astype(np.float32) * 0.3 - o / 3.0
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t = rng.uniform(0, 1, (R, 1)).astype(np.float32)
    jo = jr(params, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t))
    to = tr(params_from_numpy(params, 'cpu'), torch.from_numpy(o),
            torch.from_numpy(d), torch.from_numpy(t))
    assert set(to) == set(jo)
    for k in jo:
        ref = np.asarray(jo[k])
        if np.max(np.abs(ref)) == 0:
            assert np.max(np.abs(to[k].numpy())) == 0, k
        else:
            assert _rel(ref, to[k].numpy()) < 1e-4, k


def test_renderer_rejects_unported_options():
    # tiers and occupancy are ported: each dial builds and round-trips
    # through the spec (as JSON), the grid in the params of both inits
    small = emission_config(n_layers=2, d_filter=32)
    for kw in (dict(tier_fraction=0.5, tier_samples=8),
               dict(occupancy={'nr': 8, 'ntheta': 4, 'nphi': 8, 'nvol': [4, 2, 4]})):
        renderer, init = make_emission_system(model_config=small, device='cpu', **kw)
        rebuilt, init2 = from_spec(json.loads(json.dumps(renderer.spec)), device='cpu')
        for k in ('tier_fraction', 'tier_samples', 'tier_eval', 'occupancy'):
            assert getattr(rebuilt, k) == getattr(renderer, k), k
        params = init2(torch.Generator().manual_seed(0))
        assert ('occupancy' in params) == ('occupancy' in kw)
        assert ('occupancy' in init(torch.Generator().manual_seed(0))) == ('occupancy' in kw)
    assert rebuilt.occupancy.nvol == (4, 2, 4)
    # feature grids are ported: dense levels take the fused path, VM levels
    # (grid_rank) the float32 field, with a warning
    make_emission_system(model_config=emission_config(grid_sizes=(8,)), device='cpu')
    with pytest.warns(UserWarning, match='grid_rank'):
        make_emission_system(model_config=emission_config(grid_sizes=(8,), grid_rank=2),
                             use_fused=True, device='cpu')
    _, config = load_state(BUNDLE)
    spec = dict(config['renderer_spec'], head='mhd')
    with pytest.raises(ValueError, match='data_path'):
        from_spec(spec, device='cpu')
    # the bundle's own tier_fraction 0.0 / tier_samples 16 are accepted
    renderer, _ = from_spec(config['renderer_spec'], device='cpu')
    assert renderer.tier_fraction == 0.0 and renderer.tier_samples == 16


# -------------------------------------------------------------- bundle loader

@pytest.mark.parametrize('use_fused,tol', [(False, 1e-4), (True, 3e-2)])
def test_loader_matches_jax_loader(use_fused, tol):
    """SuNeRFLoader on the committed 8x512 bundle at 16x16, against the JAX
    package's SuNeRFLoader (fused = the Pallas kernel in interpret mode)."""
    view = dict(lat=0.3, lon=1.1, time=0.0, distance=3.0, resolution=16)
    jv = JaxLoader(BUNDLE, batch_size=256, use_fused=use_fused).render_observer_image(**view)
    tv = SuNeRFLoader(BUNDLE, batch_size=256, use_fused=use_fused,
                      device='cpu').render_observer_image(**view)
    for k in MAPS:
        assert np.isfinite(getattr(tv, k)).all(), k
        assert _rel(getattr(jv, k), getattr(tv, k)) < tol, k


@pytest.mark.parametrize('use_fused', [False, True])
def test_golden_render_is_current(use_fused):
    """The committed golden render is what the JAX package renders today."""
    golden = np.load(GOLDEN)
    np.testing.assert_array_equal(golden['view'], np.asarray(GOLDEN_VIEW))
    for k, v in _jax_golden(use_fused).items():
        assert _rel(golden[k], v) < 1e-5, k


@pytest.mark.parametrize('use_fused,tol', [(False, 1e-3), (True, 3e-2)])
def test_port_matches_golden_render(use_fused, tol):
    """The port on the CPU against the golden JAX render at 1 AU — the check
    chip_smoke.py makes on the card — on every 4th pixel (rays render
    independently, so a subset of the view is the same render there)."""
    golden = np.load(GOLDEN)
    view = _view_kwargs(golden['view'])
    loader = SuNeRFLoader(BUNDLE, use_fused=use_fused, device='cpu')
    rays_o, rays_d = observer_rays(view['lat'], view['lon'], view['distance'],
                                   view['resolution'])
    idx = np.arange(0, view['resolution'] ** 2, 4)
    pick = lambda x: torch.from_numpy(x.reshape(-1, x.shape[-1])[idx])
    with torch.inference_mode():
        out = loader.renderer(loader.params, pick(rays_o), pick(rays_d),
                              torch.full((len(idx), 1), view['time']))
    tag = 'fused' if use_fused else 'unfused'
    for k in MAPS:
        ref = golden[f'{tag}/{k}']
        got = out[k].numpy().reshape(len(idx), -1)
        err = np.max(np.abs(ref.reshape(-1, got.shape[1])[idx] - got))
        assert err < tol * np.max(np.abs(ref)), k


def test_load_coords_is_the_fine_field():
    loader = SuNeRFLoader(BUNDLE, batch_size=64, use_fused=False, device='cpu')
    q = np.random.default_rng(5).uniform(-1.3, 1.3, (100, 4)).astype(np.float32)
    raw = loader.load_coords(q)
    assert raw.shape == (100, 2) and np.isfinite(raw).all()
    cfg = NeRFConfig(**loader.config['renderer_spec']['model_config'])
    ref = nerf_apply(cfg, loader.params['fine'], torch.from_numpy(q)).raw.numpy()
    np.testing.assert_allclose(raw, ref, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------- no fallback

def test_loader_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(port_loader.torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        SuNeRFLoader(BUNDLE)


def test_fused_wrapper_on_cpu_runs_the_plain_version():
    params, config = load_state(BUNDLE)
    params = params_from_numpy(params, 'cpu')['coarse']
    cfg = NeRFConfig(**config['renderer_spec']['coarse_model_config'])
    pts = torch.from_numpy(np.random.default_rng(2).uniform(
        -1.3, 1.3, (300, 4)).astype(np.float32))
    before = fused_mlp.LAUNCHES
    out = fused_mlp.fused_mlp_forward(cfg, params, pts)
    assert fused_mlp.LAUNCHES == before
    torch.testing.assert_close(out, fused_mlp.fused_mlp_reference(cfg, params, pts),
                               rtol=0, atol=0)
    # points that need a gradient take the stashing path's plain versions,
    # with the point cotangent (K3); the output is still K0's
    x = pts.clone().requires_grad_()
    out = fused_mlp.fused_mlp_forward(cfg, params, x)
    out.sum().backward()
    assert fused_mlp.LAUNCHES == before and fused_mlp.DPTS_LAUNCHES == 0
    torch.testing.assert_close(out.detach(), fused_mlp.fused_mlp_reference(cfg, params, pts),
                               rtol=0, atol=0)
    assert x.grad.shape == pts.shape and bool(torch.isfinite(x.grad).all())


# -------------------------------------------------------------- video, IO

def test_flyby_frames_on_cpu(tmp_path):
    video_main(['--state', BUNDLE, '--output', str(tmp_path), '--n-frames', '3',
                '--resolution', '8', '--device', 'cpu'])
    frames = sorted(os.listdir(tmp_path))
    assert frames == ['frame_0000.jpg', 'frame_0001.jpg', 'frame_0002.jpg']
    from sunerf_tpu_torch.evaluation.video import render_video_frames
    with pytest.raises(ValueError, match='JAX StableHLO artifact'):
        render_video_frames('model.shlo', str(tmp_path), device='cpu')


def test_bundle_roundtrip_between_packages(tmp_path):
    params, config = load_state(BUNDLE)
    tparams = params_from_numpy(params, 'cpu')
    save_state(str(tmp_path / 'copy'), tparams, config)
    jparams, jconfig = jax_load_state(str(tmp_path / 'copy'))
    assert jconfig == config
    for field in ('coarse', 'fine'):
        for k, v in params[field].items():
            np.testing.assert_array_equal(jparams[field][k], v)
            assert tparams[field][k].shape == v.shape


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        'import importlib, pkgutil, sys\n'
        'import sunerf_tpu_torch\n'
        'for m in pkgutil.walk_packages(sunerf_tpu_torch.__path__, "sunerf_tpu_torch."):\n'
        '    importlib.import_module(m.name)\n'
        'bad = sorted(k for k in sys.modules if k == "jax" or k.startswith("jax.")\n'
        '             or k == "sunerf_tpu" or k.startswith("sunerf_tpu."))\n'
        'print(len([k for k in sys.modules if k.startswith("sunerf_tpu_torch")]), bad)\n'
        'assert not bad, bad\n'
        '# the walk reached the data-parallel package and the modules of the\n'
        '# serving export and the MHD field\n'
        'for name in ("parallel.mesh", "evaluation.serving", "models.mhd_field",\n'
        '             "data.psi_io", "scripts.probe_serving"):\n'
        '    assert "sunerf_tpu_torch." + name in sys.modules, name\n')
    proc = subprocess.run([sys.executable, '-c', code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    # chip_smoke.py imports nothing of JAX either
    src = (REPO / 'chip_smoke.py').read_text()
    assert not re.search(r'^\s*(from|import)\s+(jax|sunerf_tpu)\b(?!_)', src,
                         re.MULTILINE)


if __name__ == '__main__':
    jax.config.update('jax_platforms', 'cpu')
    out = {'view': np.asarray(GOLDEN_VIEW)}
    for fused in (False, True):
        out.update(_jax_golden(fused))
    np.savez(GOLDEN, **out)
    print(json.dumps({k: list(v.shape) for k, v in out.items()}))
