"""The port's serving export (sunerf_tpu_torch/evaluation/serving.py) on the
CPU: a bundle exported to a .tsrv artifact (torch.export programs, the
weights baked in) renders as the live renderer does, and as the JAX
package's own .shlo artifact of the same bundle does.

Tolerances: rtol 1e-4, atol 1e-6 for served against live and for the port's
artifact against JAX's (tests/test_serving.py:57-63: a serialized program
may reassociate float ops); the CPU dispatch of the registered K0 op is the
plain version's bits (exact). Every test that starts a process gives it a
deadline.
"""
import io
import json
import os
import subprocess
import sys
import time
import zipfile
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from sunerf_tpu.evaluation.serving import ServingModel as JaxServingModel
from sunerf_tpu.evaluation.serving import export_serving as jax_export_serving
from sunerf_tpu.models.fields import density_temperature_config as jax_dt_config
from sunerf_tpu.models.fields import emission_config as jax_emission_config
from sunerf_tpu.systems import make_density_temperature_system as jax_dt_system
from sunerf_tpu.systems import make_emission_system as jax_emission_system
from sunerf_tpu.utils.checkpoint import save_state as jax_save_state
from sunerf_tpu_torch.evaluation import metrics_harness, products, video
from sunerf_tpu_torch.evaluation.loader import ModelLoader
from sunerf_tpu_torch.evaluation.serving import (ServingModel, export_programs,
                                                 export_serving, main as serving_main)
from sunerf_tpu_torch.models.fields import params_from_numpy
from sunerf_tpu_torch.systems import from_spec
from sunerf_tpu_torch.utils.checkpoint import load_state

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
RTOL, ATOL = 1e-4, 1e-6
DEADLINE_S = 100.0
OP = 'sunerf_tpu_torch.fused_mlp_fwd.default'


def _save_jax_bundle(path, renderer, params, **config):
    jax_save_state(path, params, {'renderer_spec': renderer.spec, **config})
    return path


@pytest.fixture(scope='module')
def bundle(tmp_path_factory):
    """A 2x32 emission bundle (8 + 8 samples) from JAX's init, its CPU
    artifact at batch 64 and the port's live renderer of it."""
    tmp = tmp_path_factory.mktemp('serving')
    config = jax_emission_config(n_layers=2, d_filter=32, n_freqs=4)
    jr, init = jax_emission_system(model_config=config, n_stratified=8, n_hierarchical=8,
                                   use_fused=False)
    jp = init(jax.random.key(0))
    path = _save_jax_bundle(str(tmp / 'save_state'), jr, jp, type='emission',
                            ref_time='2021-01-01T00:00:00', seconds_per_dt=86400.0)
    art = str(tmp / 'model.tsrv')
    meta = export_serving(path, art, batch_size=64, platforms=('cpu',))
    renderer, _ = from_spec(jr.spec, use_fused=False, device='cpu')
    params = params_from_numpy(load_state(path)[0], 'cpu')
    return SimpleNamespace(tmp=tmp, path=path, art=art, meta=meta, renderer=renderer,
                           params=params, model=ServingModel(art, device='cpu'))


def _rays(n, seed=0):
    rng = np.random.default_rng(seed)
    ro = np.tile(np.array([[0., 0., 5.]], np.float32), (n, 1))
    rd = np.float32(rng.normal(size=(n, 3)) * 0.05 + [0., 0., -1.])
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    return ro, rd, np.zeros((n, 1), np.float32)


def _live(renderer, params, ro, rd, t, wavelengths=None):
    with torch.no_grad():
        out = renderer(params, torch.as_tensor(ro), torch.as_tensor(rd), torch.as_tensor(t),
                       wavelengths=wavelengths)
    return {k: v.numpy() for k, v in out.items()}


@pytest.mark.parametrize('n', [64, 71])
def test_export_roundtrip_matches_live(bundle, n):
    """One full batch, and 71 rays (padded to two batches, chunked,
    unpadded): the served maps are the live render's."""
    ro, rd, t = _rays(n)
    served = bundle.model(ro, rd, t)
    live = _live(bundle.renderer, bundle.params, ro, rd, t)
    assert served['image'].shape == (n, 1)
    for k in ('image', 'height_map', 'absorption_map'):
        np.testing.assert_allclose(served[k], live[k], rtol=RTOL, atol=ATOL)


def test_artifact_is_self_describing(bundle):
    with zipfile.ZipFile(bundle.art) as zf:
        meta = json.loads(zf.read('meta.json'))
        names = set(zf.namelist())
    assert names == {'meta.json', 'render.cpu.pt2', 'points.cpu.pt2'}
    assert meta == bundle.meta
    assert meta['batch_size'] == 64 and meta['format_version'] == 1
    assert meta['platforms'] == ['cpu'] and meta['n_channels'] == 0
    assert meta['fused_cuda'] is False and meta['tier'] is None
    assert meta['renderer_spec']['model_config']['n_layers'] == 2
    assert meta['torch_version'] == torch.__version__
    assert 'jax_version' not in meta


def test_full_disk_render_and_datetime(bundle):
    from datetime import datetime
    model = bundle.model
    assert model.normalize_time(datetime(2021, 1, 3)) == pytest.approx(2.0)
    view = model.render_observer_image(lat=0.3, lon=1.0, time=datetime(2021, 1, 2),
                                       distance=215.0, resolution=8)
    assert view.image.shape == (8, 8, 1) and view.height_map.shape == (8, 8)
    assert np.all(np.isfinite(view.image))
    live = ModelLoader(bundle.renderer, bundle.params, batch_size=64,
                       device='cpu').render_observer_image(lat=0.3, lon=1.0, time=1.0,
                                                           distance=215.0, resolution=8)
    np.testing.assert_allclose(view.image, live.image, rtol=RTOL, atol=ATOL)


def test_points_entry_matches_live(bundle):
    """The points entry (50 points: padded) is the live forward_points."""
    q = np.float32(np.random.default_rng(3).uniform(-1.2, 1.2, size=(50, 4)))
    served = bundle.model.query_points(q)
    with torch.no_grad():
        live = bundle.renderer.forward_points(bundle.params, torch.as_tensor(q)).raw.numpy()
    assert served.shape == live.shape == (50, 2)
    np.testing.assert_allclose(served, live, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(bundle.model.load_coords(q), served)


def test_artifact_matches_jax_artifact(bundle):
    """The same bundle exported by JAX (platforms=('cpu',)) and by the port:
    served images, maps and points agree."""
    shlo = str(bundle.tmp / 'model.shlo')
    jax_export_serving(bundle.path, shlo, batch_size=64, platforms=('cpu',))
    jmodel = JaxServingModel(shlo)
    ro, rd, t = _rays(100, seed=5)
    ours, theirs = bundle.model(ro, rd, t), jmodel(ro, rd, t)
    for k in ('image', 'height_map', 'absorption_map'):
        np.testing.assert_allclose(ours[k], theirs[k], rtol=RTOL, atol=ATOL)
    q = np.float32(np.random.default_rng(4).uniform(-1.2, 1.2, size=(70, 4)))
    np.testing.assert_allclose(bundle.model.query_points(q), jmodel.query_points(q),
                               rtol=RTOL, atol=ATOL)
    # a JAX artifact handed to the port is refused, named
    with pytest.raises(ValueError, match='JAX StableHLO artifact'):
        ServingModel(shlo, device='cpu')


def test_cuda_refused_without_a_card(bundle, tmp_path):
    """export_serving for 'cuda' and ServingModel(device='cuda') (the
    default) raise without a card; a device the artifact has no program for
    raises too."""
    if torch.cuda.is_available():
        pytest.skip('this host has a card: the refusals are of a CPU host')
    with pytest.raises(RuntimeError, match='--platforms cpu'):
        export_serving(bundle.path, str(tmp_path / 'x.tsrv'))
    assert not (tmp_path / 'x.tsrv').exists()
    with pytest.raises(RuntimeError, match='no CUDA device'):
        ServingModel(bundle.art)
    with pytest.raises(ValueError, match='unknown platform'):
        export_serving(bundle.path, str(tmp_path / 'y.tsrv'), platforms=('tpu',))


def test_future_format_version_rejected(bundle, tmp_path):
    bad = str(tmp_path / 'bad.tsrv')
    with zipfile.ZipFile(bundle.art) as zin, zipfile.ZipFile(bad, 'w') as zout:
        for name in zin.namelist():
            blob = zin.read(name)
            if name == 'meta.json':
                blob = json.dumps(dict(json.loads(blob), format_version=999))
            zout.writestr(name, blob)
    with pytest.raises(ValueError, match='newer'):
        ServingModel(bad, device='cpu')


def test_cli_with_render_overrides(bundle, tmp_path, capsys):
    """The CLI exports on a CPU host with --platforms cpu; a model trained
    at a reduced budget exports at another (the override reaches the traced
    program)."""
    out = str(tmp_path / 'cli.tsrv')
    serving_main([bundle.path, out, '--batch-size', '32', '--platforms', 'cpu',
                  '--n-stratified', '16', '--n-hierarchical', '32'])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line['out'] == out and line['batch_size'] == 32 and line['platforms'] == ['cpu']
    model = ServingModel(out, device='cpu')
    assert model.batch_size == 32
    assert model.meta['renderer_spec']['render']['n_stratified'] == 16
    ro, rd, t = _rays(40)
    renderer, _ = from_spec(model.meta['renderer_spec'], use_fused=False, device='cpu')
    served = model(ro, rd, t)
    np.testing.assert_allclose(served['image'], _live(renderer, bundle.params, ro, rd, t)['image'],
                               rtol=RTOL, atol=ATOL)
    assert not np.allclose(served['image'], bundle.model(ro, rd, t)['image'])


def test_tiered_export(bundle, tmp_path):
    """tier=(f, n) bakes the tiered fine pass in: the live tiered loader's
    frame, not the full budget's; a fraction of 0 is refused."""
    tiered = str(tmp_path / 'tiered.tsrv')
    meta = export_serving(bundle.path, tiered, batch_size=64, platforms=('cpu',),
                          tier=(0.5, 4))
    assert meta['tier'] == [0.5, 4]
    model = ServingModel(tiered, device='cpu')
    ro, rd, t = _rays(64)
    served = model(ro, rd, t)
    assert np.all(np.isfinite(served['image']))
    assert not np.allclose(served['image'], bundle.model(ro, rd, t)['image'])
    live = ModelLoader(bundle.renderer, bundle.params, batch_size=64, tier=(0.5, 4),
                       device='cpu').render_rays(ro, rd, t)
    np.testing.assert_allclose(served['image'], live['image'], rtol=RTOL, atol=ATOL)
    with pytest.raises(ValueError, match='fraction'):
        export_serving(bundle.path, str(tmp_path / 'z.tsrv'), batch_size=64,
                       platforms=('cpu',), tier=(0.0, 16))


@pytest.mark.parametrize('grid', ['dense', 'vm'])
def test_grid_bundle_exports(tmp_path, grid):
    """Feature-grid bundles, a dense level (the kernels' grid branch K5 on
    the card) and JAX's temporal VM case, export and match live."""
    kw = (dict(grid_sizes=(8,), grid_features=4, grid_bound=1.3) if grid == 'dense' else
          dict(grid_sizes=(8,), grid_rank=4, grid_time=4, grid_time_range=(0.0, 1.0),
               grid_bound=1.3))
    config = jax_emission_config(n_layers=2, d_filter=32, n_freqs=4, **kw)
    jr, init = jax_emission_system(model_config=config, n_stratified=8, n_hierarchical=8,
                                   use_fused=False)
    jp = init(jax.random.key(2))
    if grid == 'dense':    # fresh tables are +-1e-4: scale them to carry signal
        jp['fine']['grid_0'] = jp['fine']['grid_0'] * 1e4
    path = _save_jax_bundle(str(tmp_path / 'save_state'), jr, jp, type='emission')
    out = str(tmp_path / 'grid.tsrv')
    export_serving(path, out, batch_size=32, platforms=('cpu',))
    ro, rd, _ = _rays(32)
    t = np.linspace(0, 1, 32, dtype=np.float32)[:, None]
    served = ServingModel(out, device='cpu')(ro, rd, t)
    renderer, _ = from_spec(jr.spec, use_fused=False, device='cpu')
    live = _live(renderer, params_from_numpy(load_state(path)[0], 'cpu'), ro, rd, t)
    np.testing.assert_allclose(served['image'], live['image'], rtol=RTOL, atol=ATOL)


def test_multichannel_wavelength_default(tmp_path):
    """Multi-channel (DT) heads: the artifact fills in its bundle's
    wavelengths when the caller passes none."""
    config = jax_dt_config(n_layers=2, d_filter=32, n_freqs=4)
    jr, init = jax_dt_system(model_config=config, n_stratified=8, n_hierarchical=8,
                             use_fused=False)
    path = _save_jax_bundle(str(tmp_path / 'save_state'), jr, init(jax.random.key(1)),
                            type='density_temperature', wavelengths=[171.0, 193.0])
    out = str(tmp_path / 'model.tsrv')
    meta = export_serving(path, out, batch_size=32, platforms=('cpu',))
    assert meta['n_channels'] == 2 and meta['wavelengths'] == [171.0, 193.0]
    model = ServingModel(out, device='cpu')
    ro, rd, t = _rays(32)
    served = model(ro, rd, t)
    assert served['image'].shape == (32, 2)
    np.testing.assert_array_equal(served['image'],
                                  model(ro, rd, t, wavelengths=[171.0, 193.0])['image'])
    renderer, _ = from_spec(jr.spec, use_fused=False, device='cpu')
    live = _live(renderer, params_from_numpy(load_state(path)[0], 'cpu'), ro, rd, t,
                 wavelengths=torch.tensor([171.0, 193.0]).expand(32, 2))
    np.testing.assert_allclose(served['image'], live['image'], rtol=RTOL, atol=ATOL)


def _op_nodes(blob: bytes) -> list:
    program = torch.export.load(io.BytesIO(blob))
    return program, [n for n in program.graph.nodes
                     if n.op == 'call_function' and str(n.target) == OP]


def test_fused_cpu_export_holds_the_op(bundle):
    """A program traced with the NeRF fields through the registered K0 op
    (fused=True) on the CPU: its graph calls the op once a field (coarse and
    fine; once in the points entry) on constants, and its CPU dispatch is
    the plain version's bits, the live use_fused=True render's."""
    _, config = load_state(bundle.path)
    spec = config['renderer_spec']
    render, points, fused = export_programs(spec, load_state(bundle.path)[0], 'cpu', 64, 0,
                                            fused=True)
    assert fused
    program, nodes = _op_nodes(render)
    assert len(nodes) == 2
    assert len(_op_nodes(points)[1]) == 1
    # the packed weights are constants of the program, not packed per call
    assert not any('pack' in str(n.target) for n in program.graph.nodes)
    ro, rd, t = _rays(64)
    args = [torch.as_tensor(x) for x in (ro, rd, t)] + [torch.zeros(64, 0)]
    with torch.no_grad():
        image, height, _ = program.module()(*args)
    renderer, _ = from_spec(spec, use_fused=True, device='cpu')
    live = _live(renderer, bundle.params, ro, rd, t)
    np.testing.assert_array_equal(image.numpy(), live['image'])
    np.testing.assert_array_equal(height.numpy(), live['height_map'])


CPU_PROGRAM = '''
import io, json, sys, zipfile
import torch
torch.set_num_threads(1)
path, rays = sys.argv[1], sys.argv[2]
with zipfile.ZipFile(path) as zf:
    meta = json.loads(zf.read('meta.json'))
    render = torch.export.load(io.BytesIO(zf.read('render.cpu.pt2'))).module()
r = torch.load(rays)
with torch.no_grad():
    image, height, absorption = render(r['ro'], r['rd'], r['t'],
                                       torch.zeros(meta['batch_size'], meta['n_channels']))
torch.save({'image': image}, rays + '.out')
print(json.dumps({'finite': bool(torch.isfinite(image).all()),
                  'port': sorted(k for k in sys.modules if k.startswith('sunerf_tpu'))}))
'''


def test_cpu_program_loads_with_torch_alone(bundle, tmp_path):
    """The CPU program loads and renders in a process that imports only
    torch, zipfile and json (a deadline): no module of either package."""
    ro, rd, t = _rays(64)
    rays = str(tmp_path / 'rays.pt')
    torch.save({'ro': torch.as_tensor(ro), 'rd': torch.as_tensor(rd),
                't': torch.as_tensor(t)}, rays)
    (tmp_path / 'load.py').write_text(CPU_PROGRAM)
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    proc = subprocess.run([sys.executable, str(tmp_path / 'load.py'), bundle.art, rays],
                          cwd=str(tmp_path), env=env, capture_output=True, text=True,
                          timeout=DEADLINE_S)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line == {'finite': True, 'port': []}
    image = torch.load(rays + '.out')['image'].numpy()
    np.testing.assert_array_equal(image, bundle.model(ro, rd, t)['image'])


def test_cli_consumers_take_the_artifact(bundle, tmp_path):
    """video, products (volume) and the harness (refusing sample-budget
    flags) take a .tsrv artifact, as JAX's CLIs take a .shlo."""
    frames = video.render_video_frames(bundle.art, str(tmp_path / 'frames'), n_frames=2,
                                       resolution=8, device='cpu')
    assert len(frames) == 2 and all(os.path.exists(f) for f in frames)
    with pytest.raises(ValueError, match='baked'):
        video.render_video_frames(bundle.art, str(tmp_path / 'f2'), n_frames=1,
                                  resolution=8, tier=(0.5, 8), device='cpu')
    vol = str(tmp_path / 'volume.npz')
    products.main(['volume', '--state', bundle.art, '--output', vol, '--resolution', '8',
                   '--device', 'cpu'])
    with np.load(vol) as f:
        assert f['raw'].shape == (8, 8, 8, 2)
        live = ModelLoader(bundle.renderer, bundle.params, device='cpu').load_coords(
            np.stack([*np.meshgrid(*[f['grid']] * 3, indexing='ij'),
                      np.zeros((8, 8, 8), np.float32)], -1).reshape(-1, 4))
        np.testing.assert_allclose(f['raw'].reshape(-1, 2), live, rtol=RTOL, atol=ATOL)
    for product in ('synchronic', 'uncertainty'):
        with pytest.raises(SystemExit):
            products.main([product, '--state', bundle.art, '--output',
                           str(tmp_path / 'x.npz'), '--device', 'cpu'])
    with pytest.raises(SystemExit):
        metrics_harness.main(['--state', bundle.art, '--data', 'none', '--device', 'cpu',
                              '--eval-stratified', '16'])


def test_metrics_harness_accepts_artifact(tmp_path):
    """The harness scores a SimpleStar artifact (a non-NeRF head: no op)
    against the ground-truth FITS it rendered: near-perfect metrics."""
    import glob
    from sunerf_tpu_torch.evaluation.image_render import build_model_renderer, render_observers
    from sunerf_tpu_torch.utils.checkpoint import save_state
    config = {
        'model': 'SimpleStar', 'render_path': str(tmp_path / 'gt'),
        'render_format': ['fits'], 'resolution': 16, 'wavelengths': [193],
        'batch_size': 256, 'pixel_intensity_factor': 1e9,
        'observers': [
            {'name': 'v', 'lat': 0.0, 'lon': 0.0, 'distance': 215.0,
             'time': '2012-01-01T00:00:00'},
            {'name': 'v', 'lat': 20.0, 'lon': 90.0, 'distance': 215.0,
             'time': '2012-01-01T06:00:00'}]}
    render_observers(config, device='cpu')
    renderer, params = build_model_renderer(config, device='cpu')
    path = str(tmp_path / 'save_state')
    save_state(path, params, {'renderer_spec': renderer.spec,
                              'ref_time': '2012-01-01T00:00:00', 'wavelengths': [193]})
    out = str(tmp_path / 'star.tsrv')
    meta = export_serving(path, out, batch_size=256, platforms=('cpu',))
    assert meta['fused_cuda'] is False
    files = sorted(glob.glob(str(tmp_path / 'gt' / 'v' / '193' / '*.fits')))
    assert len(files) == 2
    result = metrics_harness.evaluate_viewpoints(ServingModel(out, device='cpu'), files)
    assert result['train']['psnr'] > 40 and result['test']['psnr'] > 40


RANK_SCRIPT = '''
import os, sys
from datetime import timedelta
import numpy as np
import torch
torch.set_num_threads(1)
from sunerf_tpu_torch.evaluation.serving import ServingModel
from sunerf_tpu_torch.parallel.mesh import make_mesh
rank, world, tmp, art = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
mesh = make_mesh(devices=['cpu'] * world, init_method='file://' + os.path.join(tmp, 'store'),
                 rank=rank, world_size=world, timeout=timedelta(seconds=60))
rays = np.load(os.path.join(tmp, 'rays.npz'))
out = ServingModel(art, device='cpu', mesh=mesh)(rays['ro'], rays['rd'], rays['t'])
np.savez(os.path.join(tmp, f'rank{rank}.npz'), **out)
'''


def test_sharded_export_matches_single(bundle, tmp_path):
    """n_devices=2 writes format 2 with programs of batch_size / 2 rays;
    two gloo ranks (subprocesses, a deadline) each render their rows of
    every chunk and all-gather: both hold the single-device artifact's
    frame. Without a mesh it is refused; a batch that does not divide is
    refused at export."""
    sharded = str(tmp_path / 'sharded.tsrv')
    meta = export_serving(bundle.path, sharded, batch_size=64, platforms=('cpu',),
                          n_devices=2)
    assert meta['n_devices'] == 2 and meta['format_version'] == 2
    ro, rd, t = _rays(100)                       # padded too
    np.savez(tmp_path / 'rays.npz', ro=ro, rd=rd, t=t)
    (tmp_path / 'rank.py').write_text(RANK_SCRIPT)
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS='1')
    for k in ('RANK', 'WORLD_SIZE', 'LOCAL_RANK', 'MASTER_ADDR', 'MASTER_PORT'):
        env.pop(k, None)
    procs = [subprocess.Popen([sys.executable, str(tmp_path / 'rank.py'), str(r), '2',
                               str(tmp_path), sharded], cwd=str(tmp_path), env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    start = time.monotonic()
    try:
        single = bundle.model(ro, rd, t)
        with pytest.raises(ValueError, match='2 ranks'):
            ServingModel(sharded, device='cpu')
        with pytest.raises(ValueError, match='divisible'):
            export_serving(bundle.path, str(tmp_path / 'x.tsrv'), batch_size=30,
                           platforms=('cpu',), n_devices=4)
        outs = []
        for p in procs:
            left = DEADLINE_S - (time.monotonic() - start)
            try:
                outs.append(p.communicate(timeout=max(left, 1.0))[0])
            except subprocess.TimeoutExpired:
                pytest.fail(f'a rank did not finish within {DEADLINE_S} s')
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, text) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f'rank {r} exited {p.returncode}:\n{text[-4000:]}'
        got = np.load(tmp_path / f'rank{r}.npz')
        for k in ('image', 'height_map', 'absorption_map'):
            np.testing.assert_allclose(got[k], single[k], rtol=RTOL, atol=ATOL)


def test_new_entry_points_default_to_the_card():
    """export_serving, ServingModel, MHDFieldLoader and probe_serving run on
    the card unless the caller asks for the CPU."""
    import inspect
    from sunerf_tpu_torch.evaluation import serving
    from sunerf_tpu_torch.models.mhd_field import MHDFieldLoader
    from sunerf_tpu_torch.scripts import probe_serving
    assert 'cuda' in inspect.signature(export_serving).parameters['platforms'].default
    assert inspect.signature(ServingModel.__init__).parameters['device'].default == 'cuda'
    assert inspect.signature(MHDFieldLoader.__init__).parameters['device'].default == 'cuda'
    assert inspect.signature(probe_serving.probe).parameters['device'].default == 'cuda'
    assert "default='cuda'" in inspect.getsource(probe_serving.main)
    assert "default=','.join(PLATFORMS)" in inspect.getsource(serving.main)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='no CUDA device'):
            probe_serving.main(['--state', 'x'])


@pytest.mark.parametrize('kw', [dict(n_layers=3, d_filter=64, n_freqs=4),
                                dict(n_layers=2, d_filter=20, n_freqs=3, n_freqs_time=1),
                                dict(n_layers=2, d_filter=32, n_freqs=4, grid_sizes=(4, 6),
                                     grid_features=8, d_output=3)])
def test_k0_op_cpu_kernel_is_the_plain_version(kw):
    """The registered op's CPU kernel reads the wgmma pack back
    (unpack_wgmma: the bf16 roundings of the weights, at any width) and
    gives fused_mlp_reference's bits; the eager wrapper calls it."""
    from sunerf_tpu_torch.models.fields import NeRFConfig, init_nerf
    from sunerf_tpu_torch.ops import fused_mlp
    cfg = NeRFConfig(**kw)
    p = init_nerf(torch.Generator().manual_seed(0), cfg, 'cpu')
    for k in fused_mlp.grid_keys(cfg):
        p[k] = p[k] * 1e4
    packed = fused_mlp.pack_wgmma(p['w_in'], p['w_h'], p['w_out'])
    w_in, w_h, w_out = fused_mlp.unpack_wgmma(packed, cfg.d_encoded, cfg.d_filter,
                                              cfg.n_layers, cfg.d_output)
    for got, ref in ((w_in, p['w_in']), (w_h, p['w_h']), (w_out, p['w_out'])):
        assert got.dtype == torch.bfloat16
        torch.testing.assert_close(got, ref.to(torch.bfloat16), rtol=0, atol=0)
    pts = torch.rand(100, 4, generator=torch.Generator().manual_seed(1)) * 2.6 - 1.3
    ref = fused_mlp.fused_mlp_reference(cfg, p, pts)
    ops = fused_mlp.k0_operands(cfg, p)
    assert torch.equal(fused_mlp.fused_mlp_packed(ops, pts, cfg.grid_bound), ref)
    assert torch.equal(fused_mlp._forward_k0(cfg, p, pts), ref)
    assert fused_mlp.LAUNCHES == 0          # CPU calls launch nothing


def test_probe_serving_on_the_cpu(bundle, tmp_path):
    """scripts/probe_serving.py's path on the CPU: the artifact's frame is
    the live frame; host times only, the device's not measured."""
    from sunerf_tpu_torch.scripts import probe_serving
    out = str(tmp_path / 'probe.json')
    result = probe_serving.main(['--state', bundle.path, '--resolution', '8',
                                 '--batch-size', '32', '--reps', '1', '--device', 'cpu',
                                 '--out', out])
    assert result == json.loads(Path(out).read_text())
    assert result['device'] == 'cpu' and result['max_rel_diff'] <= RTOL
    for side in ('live', 'served'):
        assert result[side]['wall_ms'] > 0
        assert result[side]['events_ms'] is None and result[side]['device_ms'] is None
