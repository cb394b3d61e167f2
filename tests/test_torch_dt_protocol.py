"""The five-channel DT protocol on the port (sunerf_tpu_torch/scripts/
dt_protocol.py) against the JAX package's scripts/dt_protocol.py on the CPU.

One module fixture runs both packages' main at 2x32, 8 + 8 samples, 20
steps, 16^2, the five channels, --hot-blob --mask-exercise --keep-best (the
JAX side through sys.argv with jax.config.update stubbed, so it keeps no
host compile cache; the port's cubes written without h5py). Then:

  * synth_cubes (with and without the hot blob): the same arrays bit for
    bit and byte-identical .h5 files (the port's numpy writer and h5py's);
  * make_observers: the same 18 observers;
  * the --mask-exercise training tree: the same files per source and
    channel (56: the odd ecliptic views' 94 and 131 dropped), with equal
    FITS headers;
  * the scene's 90 raw renders, over their pixel_intensity_factor: within
    2x JAX's own jitted-to-op-by-op gap plus RENDER_TOL of max of JAX's
    jitted view (tests/test_torch_psi_protocol.py's bound: the sampler's last
    sample sits on the cube's inner edge), and within OP_BY_OP_TOL of max of
    JAX's op-by-op render of the same view. JAX's jitted and op-by-op
    renders of a view differ by up to 12.3% of max here (the hot blob's
    steep density at r = 1 weights those edge samples); the port reads at
    most 1.78% of max from the op-by-op render (131 A, views 13 and 14), so
    OP_BY_OP_TOL is 3e-2;
  * the row: its config equal to JAX's for the same flags, the same keys,
    finite scores;
  * the harness on the port's bundle and the 90 frames: both packages'
    evaluate_viewpoints fed the same renders (the port's) within 1e-5
    relative (tests/test_torch_eval.py's tolerance), and each package's own
    loader scoring the bundle: PSNR within 0.05 dB, SSIM within 2e-3, MAE /
    ME within 1e-3 relative (tests/test_torch_psi_protocol.py's score
    tolerances: the float32 renders at 1 AU agree to ~1e-4 of max).
"""
import glob
import json
import os
import signal
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from sunerf_tpu_torch.data import psi_io
from sunerf_tpu_torch.data.fits import read_fits
from sunerf_tpu_torch.scripts import dt_protocol

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
RES = 16
RENDER_TOL = 2e-4
OP_BY_OP_TOL = 3e-2
WAVELENGTHS = [94, 131, 171, 193, 211]
FLAGS = ['--steps', '20', '--model-layers', '2', '--model-filter', '32', '--n-stratified', '8',
         '--n-hierarchical', '8', '--resolution', str(RES), '--wavelengths',
         *map(str, WAVELENGTHS), '--hot-blob', '--mask-exercise', '--keep-best']


def _jax_script(name):
    sys.path.insert(0, str(REPO / 'scripts'))
    try:
        sys.modules.pop(name, None)
        return __import__(name)
    finally:
        sys.path.remove(str(REPO / 'scripts'))


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    """Both packages' main on their own scenes: (port row, JAX row, port
    scene dir, JAX scene dir)."""
    import jax
    tmp = tmp_path_factory.mktemp('dt_protocol')
    port_dir, jax_dir = str(tmp / 'port_scene'), str(tmp / 'jax_scene')
    jax_dt = _jax_script('dt_protocol')
    handler = signal.getsignal(signal.SIGTERM)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.config, 'update', lambda *a: None)   # no host compile cache
        mp.setattr(sys, 'argv', ['dt_protocol.py', *FLAGS, '--data-cache', jax_dir,
                                 '--workdir', str(tmp / 'jax_run')])
        import io
        from contextlib import redirect_stdout
        buf = io.StringIO()
        try:
            with redirect_stdout(buf):
                jax_dt.main()
        finally:
            signal.signal(signal.SIGTERM, handler)   # JAX's fit leaves its own
    jax_row = json.loads(buf.getvalue().strip().splitlines()[-1])
    h5 = psi_io.h5py
    psi_io.h5py = None
    try:
        row = dt_protocol.main([*FLAGS, '--device', 'cpu', '--data-cache', port_dir,
                                '--workdir', str(tmp / 'port_run')])
    finally:
        psi_io.h5py = h5
    return row, jax_row, port_dir, jax_dir


@pytest.mark.parametrize('hot_blob', [True, False])
def test_synth_cubes_match_jax(tmp_path, monkeypatch, hot_blob):
    jax_dt = _jax_script('dt_protocol')
    jax_dt.synth_cubes(str(tmp_path / 'jax'), hot_blob=hot_blob)
    dt_protocol.synth_cubes(str(tmp_path / 'h5py'), hot_blob=hot_blob)
    monkeypatch.setattr(psi_io, 'h5py', None)
    dt_protocol.synth_cubes(str(tmp_path / 'numpy'), hot_blob=hot_blob)
    for var in ('rho', 't'):
        name = os.path.join(var, f'{var}00100.h5')
        want = (tmp_path / 'jax' / name).read_bytes()
        assert (tmp_path / 'h5py' / name).read_bytes() == want
        assert (tmp_path / 'numpy' / name).read_bytes() == want
        *_, jcube = psi_io.rdhdf_3d(str(tmp_path / 'jax' / name))
        *_, pcube = psi_io.rdhdf_3d(str(tmp_path / 'numpy' / name))
        np.testing.assert_array_equal(pcube, jcube)


def test_make_observers_match_jax():
    assert dt_protocol.make_observers() == _jax_script('dt_protocol').make_observers()
    assert dt_protocol.N_ECLIPTIC == 14 and len(dt_protocol.make_observers()) == 18


def test_mask_exercise_needs_four_channels(tmp_path):
    with pytest.raises(SystemExit):
        dt_protocol.main(['--mask-exercise', '--wavelengths', '171', '193', '211',
                          '--device', 'cpu', '--workdir', str(tmp_path)])


def _rel_files(root, sub):
    return sorted(os.path.relpath(p, os.path.join(root, sub))
                  for p in glob.glob(os.path.join(root, sub, '*', '*', '*.fits')))


def test_training_tree_matches_jax(runs):
    _, _, port, jax_dir = runs
    train = _rel_files(port, 'train')
    assert train == _rel_files(jax_dir, 'train')
    assert len(train) == 56
    for source, n_views, channels in (('aia', 7, WAVELENGTHS), ('aia_b', 7, WAVELENGTHS[2:])):
        for wl in WAVELENGTHS:
            n = len([f for f in train if f.startswith(os.path.join(source, str(wl), ''))])
            assert n == (n_views if wl in channels else 0), (source, wl)
    raw = _rel_files(port, 'renders')
    assert raw == _rel_files(jax_dir, 'renders') and len(raw) == 90
    for sub, names in (('train', train), ('renders', raw)):
        for name in names:
            _, ph = read_fits(os.path.join(port, sub, name))
            _, jh = read_fits(os.path.join(jax_dir, sub, name))
            assert ph.cards == jh.cards, name


def _pif(data_dir) -> float:
    """ensure_scene's pixel_intensity_factor, from its 64^2 probe."""
    peak = max(float(np.percentile(read_fits(f)[0], 99.9))
               for f in glob.glob(os.path.join(data_dir, 'probe', 'aia', '*', '*.fits')))
    return 0.7 / max(peak, 1e-30)


def _rel(ref, got) -> float:
    ref, got = np.asarray(ref, np.float64), np.asarray(got, np.float64)
    return float(np.max(np.abs(ref - got)) / np.max(np.abs(ref)))


def test_scene_renders_match_jax(runs):
    import jax.numpy as jnp
    from sunerf_tpu.evaluation.image_render import build_model_renderer as jax_build
    from sunerf_tpu_torch.core.geometry import fov_for_distance, observer_rays
    from sunerf_tpu_torch.data.wcs import parse_observer
    _, _, port, jax_dir = runs
    renderer, params = jax_build({'model': 'MHDModel', 'pixel_intensity_factor': 1.0,
                                  'data_path': os.path.join(jax_dir, 'cubes')})
    p_pif, j_pif = _pif(port), _pif(jax_dir)
    wl = jnp.tile(jnp.asarray(WAVELENGTHS, jnp.float32), (RES * RES, 1))
    for i in range(18):
        names = [os.path.join('aia', str(w), os.path.basename(f)) for w in WAVELENGTHS
                 for f in glob.glob(os.path.join(port, 'renders', 'aia', str(w),
                                                 f'aia_{i:03d}.*.fits'))]
        assert len(names) == 5
        _, header = read_fits(os.path.join(port, 'renders', names[0]))
        obs = parse_observer(header)
        o, d = observer_rays(obs.carrington_lat, obs.carrington_lon, obs.dsun_rs, RES,
                             fov=fov_for_distance(obs.dsun_rs))
        out = renderer(params, jnp.asarray(o.reshape(-1, 3)), jnp.asarray(d.reshape(-1, 3)),
                       jnp.zeros((RES * RES, 1)), key=None, wavelengths=wl)
        op_by_op = np.asarray(out['image']).reshape(RES, RES, 5)
        for c, name in enumerate(names):
            port_view = read_fits(os.path.join(port, 'renders', name))[0] / p_pif
            jax_view = read_fits(os.path.join(jax_dir, 'renders', name))[0] / j_pif
            gap = _rel(jax_view, op_by_op[:, :, c])
            assert _rel(jax_view, port_view) <= 2 * gap + RENDER_TOL, (name, gap)
            assert _rel(op_by_op[:, :, c], port_view) <= OP_BY_OP_TOL, name


def test_protocol_row_matches_jax(runs):
    row, jax_row, _, _ = runs
    assert row['config'] == jax_row['config']
    assert row['config']['mask_exercise'] == {'dropped_from_odd_views': [94, 131]}
    assert set(jax_row) <= set(row)
    assert set(row) - set(jax_row) == {'effective_rays_per_sec'}
    assert row['scored_bundle'] == jax_row['scored_bundle'] == 'save_state_best.npz'
    assert row['rays_per_sec'] > 0 and row['effective_rays_per_sec'] > 0
    assert set(row['highlat_probe']) == set(jax_row['highlat_probe'])
    for split in ('train', 'test'):
        assert set(row[split]) == set(jax_row[split]) == {'psnr', 'ssim', 'mae_percent',
                                                          'me_percent'}
        assert all(np.isfinite(v) for v in row[split].values())


class _Replay:
    def __init__(self, views):
        self.views = list(views)

    def render_observer_image(self, **kw):
        return self.views.pop(0)


class _Recording:
    def __init__(self, loader):
        self.loader, self.views = loader, []

    def render_observer_image(self, **kw):
        self.views.append(self.loader.render_observer_image(**kw))
        return self.views[-1]


def test_harness_on_the_bundle_matches_jax(runs):
    from sunerf_tpu.evaluation import metrics_harness as jax_harness
    from sunerf_tpu.evaluation.loader import SuNeRFLoader as JaxSuNeRFLoader
    from sunerf_tpu_torch.evaluation import metrics_harness
    from sunerf_tpu_torch.evaluation.loader import SuNeRFLoader
    row, _, port, _ = runs
    bundle = os.path.join(row['workdir'], 'run', row['scored_bundle'])
    files = dt_protocol.gt_files(os.path.join(port, 'renders'))
    assert len(files) == 90
    rec = _Recording(SuNeRFLoader(bundle, device='cpu'))
    got = metrics_harness.evaluate_viewpoints(rec, files)
    for split in ('train', 'test'):
        assert got[split] == pytest.approx(row[split], rel=1e-12), split
    # both harnesses fed the port's renders
    jres = jax_harness.evaluate_viewpoints(_Replay(rec.views), files)
    assert (got['n_train'], got['n_test']) == (jres['n_train'], jres['n_test']) == (70, 20)
    for split in ('train', 'test', 'all'):
        for k, v in jres[split].items():
            assert np.isfinite(v) and abs(got[split][k] - v) <= 1e-5 * abs(v), (split, k)
    # each package's own loader on the bundle
    want = jax_harness.evaluate_viewpoints(JaxSuNeRFLoader(bundle), files)
    for split in ('train', 'test'):
        assert abs(got[split]['psnr'] - want[split]['psnr']) <= 0.05, split
        assert abs(got[split]['ssim'] - want[split]['ssim']) <= 2e-3, split
        for k in ('mae_percent', 'me_percent'):
            assert abs(got[split][k] - want[split][k]) <= 1e-3 * abs(want[split][k]), (split, k)


def test_chip_smoke_phase_deadline_ends_a_spawned_pool():
    """chip_smoke's phase deadline (phases 22-25 run under it): a phase
    blocked on a spawned worker pool is interrupted at the deadline, exits
    with the phase's name, ends the pool's workers and restores the
    previous SIGALRM handler."""
    import multiprocessing
    import time
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))
    before = signal.getsignal(signal.SIGALRM)
    t0 = time.perf_counter()
    with pytest.raises(SystemExit, match=r'\[dt_protocol\] past its 2 s deadline'):
        with chip_smoke._deadline(2, '[dt_protocol]'):
            with multiprocessing.get_context('spawn').Pool(2) as pool:
                pool.map(time.sleep, [60, 60])
    assert time.perf_counter() - t0 < 30
    assert multiprocessing.active_children() == []
    assert signal.getsignal(signal.SIGALRM) == before
    with chip_smoke._deadline(5, '[probes]'):
        pass                                    # an in-time phase passes
