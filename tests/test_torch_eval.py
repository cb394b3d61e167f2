"""The port's evaluation layer against the JAX package on the CPU: the
trainable encoding (core/encoding.py), the reprojection baseline
(baseline/reprojection.py), the science products (evaluation/products.py),
the metrics harness (evaluation/metrics_harness.py) and both CLIs.

Tolerances:
  * the trainable encoding: values within 1e-6 of max, gradients (inputs
    and frequencies) within 1e-5 of max;
  * the reprojection baseline (numpy, a copy over the port's geometry and
    WCS copies): bit for bit on tests/test_baseline_and_metrics.py's cases;
  * the five products, on tests/test_products.py's SimpleStar loader (both
    passes' absorption zeroed) and on a 2x32 emission field, through each
    package's loader: within 1e-5 of max. The uncertainty map, a difference
    of the coarse and fine images: of the 2x32 field within 1e-5 of the fine
    image's max; of both, per pixel within the two images' own differences
    across the packages (+ 1e-5 of the fine max). SimpleStar's 16-sample
    coarse image at 3 Rs differs by 6.2e-5 of max at a ray near the limb,
    whose far plane the float32 ray-sphere clip moves by 2.2e-5 (ROADMAP
    Queue 3). The views are taken at 3 Rs: float32 renders at 1 AU are
    ill-conditioned (the port re-renders JAX's 215 Rs SimpleStar frames at
    67-70 dB), and the 2x32 field has 3 posenc bands, as JAX's occupancy
    tests' fields (its default 10 bands multiply a sample position's
    float32 rounding by up to 2^9 in phase);
  * evaluate_viewpoints on the FITS files of
    tests/test_baseline_and_metrics.py::test_metrics_harness: both harnesses
    fed the same renders score within 1e-5 relative; the port's own loader
    scores JAX's frames above 40 dB on both splits, as that test asks of JAX;
  * the products and metrics CLIs of both packages on one bundle: the .npz
    arrays within 1e-5 of max (uncertainty: of the fine image's max), the
    JSON metrics within 1e-5 relative (ground truth at a 3 Rs observer).
"""
import dataclasses
import glob
import inspect
import json
import os
from datetime import datetime

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sunerf_tpu.baseline import reprojection as jrep
from sunerf_tpu.core.encoding import init_trainable_encoding as jax_init_trainable
from sunerf_tpu.core.encoding import trainable_encoding_apply as jax_trainable_apply
from sunerf_tpu.data.fits import Header as JaxHeader
from sunerf_tpu.data.wcs import observer_header as jax_observer_header
from sunerf_tpu.evaluation import metrics_harness as jax_harness
from sunerf_tpu.evaluation import products as jax_products
from sunerf_tpu.evaluation.image_render import render_observers as jax_render_observers
from sunerf_tpu.evaluation.loader import ModelLoader as JaxModelLoader
from sunerf_tpu.models.fields import emission_config as jax_emission_config
from sunerf_tpu.systems import make_emission_system as jax_make_emission_system
from sunerf_tpu.systems import make_simple_star_renderer as jax_make_star
from sunerf_tpu.utils.checkpoint import save_state as jax_save_state
from sunerf_tpu_torch.baseline import reprojection as rep
from sunerf_tpu_torch.core.geometry import observer_rays
from sunerf_tpu_torch.core.encoding import init_trainable_encoding, trainable_encoding_apply
from sunerf_tpu_torch.data.fits import Header, write_fits
from sunerf_tpu_torch.data.wcs import observer_header
from sunerf_tpu_torch.evaluation import metrics_harness, products, video
from sunerf_tpu_torch.evaluation.image_render import build_model_renderer
from sunerf_tpu_torch.evaluation.loader import ModelLoader, SuNeRFLoader
from sunerf_tpu_torch.models.fields import emission_config, params_from_numpy
from sunerf_tpu_torch.systems import make_emission_system, make_simple_star_renderer

torch.set_num_threads(1)

TOL = 1e-5
SMALL = dict(n_layers=2, d_filter=32, n_freqs=3)
SAMPLES = dict(n_stratified=16, n_hierarchical=16, perturb=False)
NEAR = 3.0
BUNDLE = os.path.join(os.path.dirname(__file__), '..', 'artifacts_r4', 's8_probe_rerun_best')


def _of_max(ref, got, scale=None) -> float:
    ref, got = np.asarray(ref, np.float64), np.asarray(got, np.float64)
    scale = np.max(np.abs(ref)) if scale is None else scale
    return float(np.max(np.abs(ref - got)) / max(scale, 1e-30))


@pytest.fixture
def no_jax_cache(monkeypatch):
    """The JAX CLIs point JAX's compilation cache at a directory of the host;
    this keeps them from it."""
    update = jax.config.update
    monkeypatch.setattr(jax.config, 'update', lambda k, v: None
                        if k == 'jax_compilation_cache_dir' else update(k, v))


# ---------------------------------------------------------- trainable encoding

def test_trainable_encoding_matches_jax():
    jp = jax_init_trainable(4, n_freqs=5)
    tp = init_trainable_encoding(4, n_freqs=5)
    np.testing.assert_array_equal(tp['frequencies'].numpy(), np.asarray(jp['frequencies']))
    x = np.random.default_rng(0).uniform(-1.3, 1.3, (16, 4)).astype(np.float32)
    w = np.random.default_rng(1).normal(size=(16, 40)).astype(np.float32)
    jout = jax.jit(jax_trainable_apply)(jp, x)
    assert jout.shape == (16, 40)
    f = tp['frequencies'].clone().requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    out = trainable_encoding_apply({'frequencies': f}, xt)
    assert _of_max(jout, out.detach().numpy()) <= 1e-6
    (out * torch.from_numpy(w)).sum().backward()
    gf, gx = jax.jit(jax.grad(lambda p, x: jnp.sum(jax_trainable_apply(p, x) * w),
                              argnums=(0, 1)))(jp, x)
    assert _of_max(gf['frequencies'], f.grad.numpy()) <= TOL
    assert _of_max(gx, xt.grad.numpy()) <= TOL


# ---------------------------------------------------------- reprojection

def _maps(lat=0.0, lon=0.0, value=1.0, res=64):
    """_disk_map of tests/test_baseline_and_metrics.py for each package."""
    t = datetime(2012, 1, 1)
    jh, th = JaxHeader(), Header()
    jh.update(jax_observer_header(lat, lon, 215.0, t, res, 193.0))
    th.update(observer_header(lat, lon, 215.0, t, res, 193.0))
    data = np.full((res, res), value, np.float32)
    return (data, jh), (data, th)


def test_reprojection_matches_jax_bit_for_bit():
    rng = np.random.default_rng(3)
    lat = rng.uniform(-np.pi / 2 + 0.01, np.pi / 2 - 0.01, 50)
    lon = rng.uniform(0, 2 * np.pi, 50)
    xyz = rep.carrington_to_world(lat, lon, 1.0)
    np.testing.assert_array_equal(xyz, jrep.carrington_to_world(lat, lon, 1.0))
    for a, b in zip(rep.world_to_carrington(xyz), jrep.world_to_carrington(xyz)):
        np.testing.assert_array_equal(a, b)
    (jd, jh), (td, th) = _maps()
    for a, b in zip(rep.map_to_heliographic(td, th, shape_out=(45, 90)),
                    jrep.map_to_heliographic(jd, jh, shape_out=(45, 90))):
        np.testing.assert_array_equal(a, b)
    pairs = [_maps(lon=0.0), _maps(lon=180.0)]
    np.testing.assert_array_equal(
        rep.transform([p[1] for p in pairs], lat=0.3, lon=1.0, distance=215.0, resolution=32,
                      shape_out=(45, 90)),
        jrep.transform([p[0] for p in pairs], lat=0.3, lon=1.0, distance=215.0, resolution=32,
                       shape_out=(45, 90)))
    hmap = np.zeros((90, 180))
    hmap[:, 40:50] = 5.0
    for lon in (90.0, 270.0):
        np.testing.assert_array_equal(
            rep.heliographic_to_observer(hmap, 0.0, np.deg2rad(lon), 215.0, 32),
            jrep.heliographic_to_observer(hmap, 0.0, np.deg2rad(lon), 215.0, 32))
    facing = rep.heliographic_to_observer(hmap, 0.0, np.deg2rad(90.0), 215.0, 32)
    assert np.nanmax(facing) > 4.0


# ---------------------------------------------------------- products

@pytest.fixture(scope='module')
def loaders():
    """{kind: (JAX ModelLoader, port ModelLoader, fine-image scale view)}:
    tests/test_products.py's SimpleStar (pif 1e9) with both passes'
    absorption zeroed, and a 2x32 emission field, batch 512."""
    jr, jinit = jax_make_star(pixel_intensity_factor=1e9, **SAMPLES)
    tr, _ = make_simple_star_renderer(pixel_intensity_factor=1e9, device='cpu', **SAMPLES)
    p = jax.tree.map(np.asarray, jinit())
    z = dict(p['fine'], log_abs=np.zeros(7, np.float32))
    star = {'coarse': z, 'fine': z}
    jm, minit = jax_make_emission_system(model_config=jax_emission_config(**SMALL),
                                         use_fused=False, **SAMPLES)
    tm, _ = make_emission_system(model_config=emission_config(**SMALL), device='cpu', **SAMPLES)
    nerf = jax.tree.map(np.asarray, minit(jax.random.key(3)))
    out = {}
    for kind, j, t, params, wl in (('star', jr, tr, star, [193.0]), ('nerf', jm, tm, nerf, None)):
        kw = dict(ref_time=datetime(2012, 1, 1), batch_size=512)
        out[kind] = (JaxModelLoader(j, jax.tree.map(jnp.asarray, params), **kw),
                     ModelLoader(t, params_from_numpy(params, 'cpu'), device='cpu', **kw), wl)
    return out


@pytest.mark.parametrize('kind', ['star', 'nerf'])
def test_products_match_jax(loaders, kind):
    jl, tl, wl = loaders[kind]
    vj = jax_products.extract_volume(jl, 0.0, resolution=12, extent=1.5)
    vt = products.extract_volume(tl, 0.0, resolution=12, extent=1.5)
    np.testing.assert_array_equal(vt['grid'], vj['grid'])
    assert vt['raw'].shape == (12, 12, 12, 2) and _of_max(vj['raw'], vt['raw']) <= TOL
    sj = jax_products.synchronic_map(jl, 0.0, resolution_lat=8, wavelengths=wl)
    st = products.synchronic_map(tl, 0.0, resolution_lat=8, wavelengths=wl)
    assert st.shape == (8, 16, 1) and _of_max(sj, st) <= TOL
    view = dict(lat=0.2, lon=1.0, time=0.0, distance=NEAR, resolution=8, wavelengths=wl)
    tj, tt = jax_products.topographic_maps(jl, **view), products.topographic_maps(tl, **view)
    for k in ('height_map', 'absorption_map', 'image'):
        assert _of_max(tj[k], tt[k]) <= TOL, k
    ej = jax_products.eruption_profile(jl, [0.0, 0.5], 0.2, 1.0, NEAR, resolution=8,
                                       wavelengths=wl)
    et = products.eruption_profile(tl, [0.0, 0.5], 0.2, 1.0, NEAR, resolution=8, wavelengths=wl)
    assert et['times'] == ej['times']
    for k in ('images', 'light_curve'):
        assert _of_max(ej[k], et[k]) <= TOL, k
    uj = jax_products.uncertainty_map(jl, 0.2, 1.0, 0.0, NEAR, resolution=8, wavelengths=wl)
    ut = products.uncertainty_map(tl, 0.2, 1.0, 0.0, NEAR, resolution=8, wavelengths=wl)
    assert ut.shape == (8, 8)
    # |coarse - fine| moves by at most the two images' own differences
    o, d = observer_rays(0.2, 1.0, NEAR, 8)
    o, d = o.reshape(-1, 3), d.reshape(-1, 3)
    t = np.zeros((64, 1), np.float32)
    w = None if wl is None else np.full((64, 1), wl[0], np.float32)
    ref = jax.jit(lambda p: jl.renderer(p, o, d, t, key=None, wavelengths=w))(jl.params)
    got = tl.render_rays(o, d, 0.0, wl, keys=('coarse_image', 'fine_image'))
    fine_max = np.max(np.abs(got['fine_image']))
    gap = sum(np.abs(np.asarray(ref[k]) - got[k]) for k in got).mean(-1)
    assert np.all(np.abs(uj - ut).reshape(64) <= gap + TOL * fine_max)
    if kind == 'nerf':
        assert _of_max(uj, ut, fine_max) <= TOL


def test_products_counterparts_on_simple_star(loaders):
    """tests/test_products.py's checks, on the port's SimpleStar loader."""
    _, tl, wl = loaders['star']
    raw = products.extract_volume(tl, time=0.0, resolution=12, extent=1.5)['raw']
    assert raw[6, 6, 6, 0] > raw[0, 0, 0, 0]
    m = products.synchronic_map(tl, time=0.0, resolution_lat=8, wavelengths=wl)
    assert np.all(np.isfinite(m)) and m.max() > 0
    assert m[4, :, 0].std() / (m[4, :, 0].mean() + 1e-12) < 0.1
    maps = products.topographic_maps(tl, lat=0.0, lon=0.0, time=0.0, distance=215.0,
                                     resolution=8, wavelengths=wl)
    assert maps['height_map'].shape == maps['absorption_map'].shape == (8, 8)
    assert 0.8 < maps['height_map'][4, 4] < 1.5
    lc = products.eruption_profile(tl, times=[0.0, 0.5, 1.0], lat=0.0, lon=0.0, distance=215.0,
                                   resolution=8, wavelengths=wl)['light_curve'][:, 0]
    assert np.allclose(lc, lc[0], rtol=1e-4)
    u = products.uncertainty_map(tl, lat=0.0, lon=0.0, time=0.0, distance=215.0,
                                 resolution=8, wavelengths=wl)
    assert u.shape == (8, 8) and np.all(np.isfinite(u))


# ---------------------------------------------------------- metrics harness

class _Replay:
    """A loader that answers every view with the same stored render."""

    def __init__(self, views):
        self.views = list(views)

    def render_observer_image(self, **kw):
        return self.views.pop(0)


def test_metrics_harness_matches_jax(tmp_path):
    """tests/test_baseline_and_metrics.py::test_metrics_harness's frames."""
    config = {
        'model': 'SimpleStar', 'render_path': str(tmp_path / 'gt'),
        'render_format': ['fits'], 'resolution': 16, 'wavelengths': [193],
        'batch_size': 256, 'pixel_intensity_factor': 1e9,
        'observers': [
            {'name': 'v', 'lat': 0.0, 'lon': 0.0, 'distance': 215.0,
             'time': '2012-01-01T00:00:00'},
            {'name': 'v', 'lat': 20.0, 'lon': 90.0, 'distance': 215.0,
             'time': '2012-01-01T06:00:00'}]}
    jax_render_observers(config)
    files = sorted(glob.glob(str(tmp_path / 'gt' / 'v' / '193' / '*.fits')))
    assert len(files) == 2
    renderer, params = build_model_renderer(config, device='cpu')
    loader = ModelLoader(renderer, params, ref_time=datetime(2012, 1, 1), batch_size=256,
                         device='cpu')
    result = metrics_harness.evaluate_viewpoints(loader, files, lat_split_deg=7.0)
    assert result['n_train'] == 1 and result['n_test'] == 1
    assert result['train']['psnr'] > 40 and result['test']['psnr'] > 40
    assert abs(result['all']['me_percent']) < 1.0
    # both harnesses on the same renders: the port's, 2% brighter, so that
    # every metric is finite and ME% is not a difference of near-equal sums
    views = []
    for lat, lon, t in ((0.0, 0.0, '2012-01-01T00:00:00'), (20.0, 90.0, '2012-01-01T06:00:00')):
        v = loader.render_observer_image(lat=np.deg2rad(lat), lon=np.deg2rad(lon),
                                         time=datetime.fromisoformat(t), distance=215.0,
                                         resolution=16, wavelengths=[193.0])
        views.append(dataclasses.replace(v, image=v.image * np.float32(1.02)))
    for scaling in ('asinh', 'none'):
        jres = jax_harness.evaluate_viewpoints(_Replay(views), files, 7.0, scaling)
        tres = metrics_harness.evaluate_viewpoints(_Replay(views), files, 7.0, scaling)
        assert (tres['n_train'], tres['n_test']) == (jres['n_train'], jres['n_test'])
        for split in ('train', 'test', 'all'):
            for k, v in jres[split].items():
                assert np.isfinite(v) and abs(tres[split][k] - v) <= 1e-5 * abs(v), (split, k)
        for jv, tv in zip(jres['views'], tres['views']):
            assert (tv['file'], tv['lat_deg'], tv['lon_deg']) == (jv['file'], jv['lat_deg'],
                                                                 jv['lon_deg'])


# ---------------------------------------------------------- the CLIs

@pytest.fixture(scope='module')
def bundle(tmp_path_factory):
    """A 2x32 emission bundle written by the JAX package, and two ground
    truth FITS views at a 3 Rs observer (lat 0 and 20 deg)."""
    tmp = tmp_path_factory.mktemp('cli')
    renderer, init = jax_make_emission_system(model_config=jax_emission_config(**SMALL),
                                              use_fused=False, **SAMPLES)
    path = str(tmp / 'save_state')
    jax_save_state(path, init(jax.random.key(5)),
                   {'renderer_spec': renderer.spec, 'ref_time': '2012-01-01T00:00:00'})
    rng = np.random.default_rng(0)
    for i, lat in enumerate((0.0, 20.0)):
        header = Header()
        header.update(observer_header(lat, 40.0 * i, NEAR, datetime(2012, 1, 1, 6 * i), 12,
                                      193.0))
        write_fits(str(tmp / f'gt_{i}.fits'), rng.uniform(0, 2, (12, 12)).astype(np.float32),
                   header)
    return tmp, path


PRODUCT_ARGS = {
    'volume': ['--resolution', '8'],
    'synchronic': ['--resolution', '6'],
    'topographic': ['--resolution', '8', '--distance', str(NEAR), '--lat', '10'],
    'eruption': ['--resolution', '8', '--distance', str(NEAR), '--times', '0', '0.5'],
    'uncertainty': ['--resolution', '8', '--distance', str(NEAR), '--lon', '30'],
}


def test_products_cli_both_packages(bundle, no_jax_cache):
    tmp, path = bundle
    loader = SuNeRFLoader(path, device='cpu')
    o, d = observer_rays(0.0, np.deg2rad(30.0), NEAR, 8)
    fine_max = np.max(np.abs(loader.render_rays(o, d, 0.0, keys=('fine_image',))['fine_image']))
    for product, args in PRODUCT_ARGS.items():
        jout, tout = str(tmp / f'jax_{product}.npz'), str(tmp / f'port_{product}.npz')
        jax_products.main([product, '--state', path, '--output', jout] + args)
        products.main([product, '--state', path, '--output', tout, '--device', 'cpu'] + args)
        with np.load(jout) as j, np.load(tout) as t:
            assert sorted(t.files) == sorted(j.files), product
            for k in j.files:
                assert t[k].shape == j[k].shape, (product, k)
                scale = fine_max if product == 'uncertainty' else None
                assert _of_max(j[k], t[k], scale) <= TOL, (product, k)


def test_metrics_cli_both_packages(bundle, no_jax_cache, capsys):
    tmp, path = bundle
    common = ['--state', path, '--data', str(tmp / 'gt_*.fits'), '--eval-stratified', '12']
    jax_harness.main(common + ['--output', str(tmp / 'jax.json')])
    metrics_harness.main(common + ['--output', str(tmp / 'port.json'), '--device', 'cpu'])
    printed = capsys.readouterr().out
    with open(tmp / 'jax.json') as f:
        jres = json.load(f)
    with open(tmp / 'port.json') as f:
        tres = json.load(f)
    assert (tres['n_train'], tres['n_test']) == (jres['n_train'], jres['n_test']) == (1, 1)
    for split in ('train', 'test', 'all'):
        for k, v in jres[split].items():
            assert abs(tres[split][k] - v) <= 1e-5 * abs(v), (split, k, tres[split][k], v)
    assert '"n_train": 1' in printed


def test_shlo_states_raise_naming_item_12(tmp_path):
    state = str(tmp_path / 'model.shlo')
    for call in (lambda: products.main(['volume', '--state', state, '--output', 'x.npz',
                                        '--device', 'cpu']),
                 lambda: metrics_harness.main(['--state', state, '--data', 'x', '--device',
                                               'cpu']),
                 lambda: video.render_video_frames(state, str(tmp_path), device='cpu')):
        # the port serves its own .tsrv artifacts (Queue 1 item 12): a JAX
        # .shlo is refused, named
        with pytest.raises(ValueError, match='JAX StableHLO artifact'):
            call()


def test_new_entry_points_default_to_the_card():
    for module in (products, metrics_harness, video):
        assert "default='cuda'" in inspect.getsource(module.main), module.__name__
    for cls in (ModelLoader, SuNeRFLoader):
        assert inspect.signature(cls.__init__).parameters['device'].default == 'cuda'
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='no CUDA device'):
            products.main(['volume', '--state', BUNDLE, '--output', 'x.npz'])
