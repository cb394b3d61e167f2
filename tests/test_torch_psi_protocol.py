"""The psi_193 protocol on the port (sunerf_tpu_torch/scripts/psi_protocol.py,
score_bundle.py) and the PSI HDF5 writer it needs without h5py
(data/psi_io.py), against the JAX package and h5py on the CPU.

  * the numpy writer: the same bytes as h5py 3.14 writes for the same
    write_hdf call (the JAX package's writer; ranks 1-3, float32 / float64,
    all scales or none, at sizes that cross HDF5's 2048-byte allocation
    blocks), read back by read_hdf and by h5py to the same arrays and
    scales; write_hdf takes it with h5py and without, hands what it does
    not write to h5py, and refuses that by name when h5py is absent;
  * ensure_scene at 16^2 (its 64^2 probe included) against JAX's: the cubes
    byte-identical (the port's written without h5py), the same train (14)
    and ground-truth (18) files with equal headers; each raw view, over its
    pixel_intensity_factor, within 2x JAX's own jitted-to-op-by-op gap plus
    2e-4 of max of JAX's jitted view (tests/test_torch_mhd.py's bound: the
    sampler's last sample sits on the cube's inner edge, ROADMAP Queue 3),
    and within 2e-4 of JAX's op-by-op render;
  * the protocol's main at 2x32, 8 + 8 samples, 20 steps on that scene (the
    row JAX's writes, its effective rays/s from utils.throughput), and
    score_bundle on the trained bundle against JAX's score_bundle on the
    same files: PSNR within 0.05 dB, MAE / ME within 1e-3 of their values
    (the float32 renders at 1 AU agree to ~1e-4 of max, and a mean of
    absolute differences moves by no more), SSIM within 2e-3 (its 7x7
    windows' variances amplify such a change on a nearly dark 16^2 frame;
    5e-4 measured).
"""
import glob
import os
import sys
from pathlib import Path

import h5py
import numpy as np
import pytest
import torch

from sunerf_tpu_torch.data import psi_io
from sunerf_tpu_torch.data.fits import read_fits
from sunerf_tpu_torch.scripts import psi_protocol, score_bundle

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
RES = 16
RENDER_TOL = 2e-4


@pytest.mark.parametrize('shape', [(5,), (600,), (4, 3), (7, 300), (4, 2, 3), (64, 32, 24),
                                   (1, 1, 1)])
@pytest.mark.parametrize('dtype', [np.float32, np.float64])
@pytest.mark.parametrize('with_scales', [True, False])
def test_numpy_writer_is_h5py_byte_for_byte(tmp_path, monkeypatch, shape, dtype, with_scales):
    from sunerf_tpu.data.psi_io import write_hdf as jax_write_hdf
    rng = np.random.default_rng(len(shape) * 100 + shape[0])
    data = rng.normal(size=shape).astype(dtype)
    scales = [np.sort(rng.normal(size=n)) for n in shape] if with_scales else None
    jax_write_hdf(str(tmp_path / 'h5py.h5'), data, scales)
    psi_io.write_hdf(str(tmp_path / 'with_h5py.h5'), data, scales)
    monkeypatch.setattr(psi_io, 'h5py', None)
    psi_io.write_hdf(str(tmp_path / 'numpy.h5'), data, scales)
    assert (tmp_path / 'numpy.h5').read_bytes() == (tmp_path / 'h5py.h5').read_bytes()
    assert (tmp_path / 'with_h5py.h5').read_bytes() == (tmp_path / 'h5py.h5').read_bytes()
    got_scales, got = psi_io.read_hdf(str(tmp_path / 'numpy.h5'))
    np.testing.assert_array_equal(got, data)
    with h5py.File(tmp_path / 'numpy.h5', 'r') as f:
        np.testing.assert_array_equal(f['Data'][...], data)
        for i in range(len(shape)):
            attached = [s[...] for s in f['Data'].dims[i].values()]
            if with_scales:
                np.testing.assert_array_equal(got_scales[i], scales[i].astype(dtype))
                np.testing.assert_array_equal(attached[0], got_scales[i])
            else:
                assert attached == [] and got_scales[i].size == 0


def test_wrhdf_3d_without_h5py(tmp_path, monkeypatch):
    """wrhdf_3d's cube (the protocol's call) through the numpy writer reads
    back through rdhdf_3d."""
    r, th, ph = np.linspace(1, 1.3, 24), np.linspace(0, np.pi, 32), np.linspace(0, 6.2, 64)
    cube = np.random.default_rng(0).uniform(size=(64, 32, 24)).astype(np.float32)
    monkeypatch.setattr(psi_io, 'h5py', None)
    psi_io.wrhdf_3d(str(tmp_path / 'c.h5'), r, th, ph, cube)
    x, y, z, data = psi_io.rdhdf_3d(str(tmp_path / 'c.h5'))
    np.testing.assert_array_equal(data, cube)
    for got, want in ((x, r), (y, th), (z, ph)):
        np.testing.assert_array_equal(got, want.astype(np.float32))


@pytest.mark.parametrize('data,scales,message', [
    (np.zeros((2, 2), np.int32), None, 'float32 / float64 data'),
    (np.zeros((2, 2, 2, 2), np.float32), None, 'rank 1 to 3'),
    (np.zeros((2, 3), np.float32), [np.zeros(2)], 'a non-empty scale for every axis'),
    (np.zeros((2, 3), np.float32), [np.zeros(2), np.zeros(0)], 'a non-empty scale'),
])
def test_numpy_writer_refuses_by_name(tmp_path, monkeypatch, data, scales, message):
    """What the numpy writer does not write raises by name without h5py,
    and goes through h5py (as the JAX package's writer) where it imports."""
    psi_io.write_hdf(str(tmp_path / 'h5py.h5'), data, scales)
    with h5py.File(tmp_path / 'h5py.h5', 'r') as f:
        np.testing.assert_array_equal(f['Data'][...], data)
    monkeypatch.setattr(psi_io, 'h5py', None)
    with pytest.raises(ValueError, match=message):
        psi_io.write_hdf(str(tmp_path / 'x.h5'), data, scales)


def _rel(ref, got) -> float:
    ref, got = np.asarray(ref, np.float64), np.asarray(got, np.float64)
    return float(np.max(np.abs(ref - got)) / np.max(np.abs(ref)))


def _pif(data_dir) -> float:
    """ensure_scene's pixel_intensity_factor, from its 64^2 probe."""
    img, _ = read_fits(sorted(glob.glob(os.path.join(data_dir, 'probe', 'psi', '193',
                                                     '*.fits')))[0])
    return 0.7 * 50000.0 / max(float(np.percentile(img, 99.9)), 1e-30)


def _files(root, sub):
    return sorted(os.path.relpath(p, root) for p in glob.glob(os.path.join(root, sub, '*.fits')))


@pytest.fixture(scope='module')
def scenes(tmp_path_factory):
    """The protocol scene at 16^2 from both packages: the port's cubes
    written without h5py."""
    sys.path.insert(0, str(REPO / 'scripts'))
    try:
        from psi_protocol import ensure_scene as jax_ensure_scene
    finally:
        sys.path.remove(str(REPO / 'scripts'))
    tmp = tmp_path_factory.mktemp('psi_scene')
    port, jax_dir = str(tmp / 'port'), str(tmp / 'jax')
    h5 = psi_io.h5py
    psi_io.h5py = None
    try:
        psi_protocol.ensure_scene(port, RES, prep_batch=256, device='cpu')
    finally:
        psi_io.h5py = h5
    jax_ensure_scene(jax_dir, RES, prep_batch=256)
    return port, jax_dir


def test_ensure_scene_matches_jax(scenes):
    import jax.numpy as jnp
    from sunerf_tpu.evaluation.image_render import build_model_renderer as jax_build
    from sunerf_tpu_torch.core.geometry import fov_for_distance, observer_rays
    from sunerf_tpu_torch.data.wcs import parse_observer
    port, jax_dir = scenes
    for var in ('rho', 't'):
        name = os.path.join('cubes', var, f'{var}00100.h5')
        assert Path(port, name).read_bytes() == Path(jax_dir, name).read_bytes()
    assert len(_files(port, 'train')) == 14 and len(_files(port, 'gt')) == 18
    for sub in ('train', 'gt', os.path.join('renders', 'psi', '193')):
        names = _files(port, sub)
        assert names == _files(jax_dir, sub)
        for name in names:
            _, ph = read_fits(os.path.join(port, name))
            _, jh = read_fits(os.path.join(jax_dir, name))
            assert ph.cards == jh.cards, name
    # the raw views over their intensity factors, against JAX's jitted views
    # and its op-by-op render of the same rays
    renderer, params = jax_build({'model': 'MHDModel', 'pixel_intensity_factor': 1.0,
                                  'data_path': os.path.join(jax_dir, 'cubes')})
    p_pif, j_pif = _pif(port), _pif(jax_dir)
    for name in _files(port, os.path.join('renders', 'psi', '193')):
        pdata, header = read_fits(os.path.join(port, name))
        jdata, _ = read_fits(os.path.join(jax_dir, name))
        obs = parse_observer(header)
        o, d = observer_rays(obs.carrington_lat, obs.carrington_lon, obs.dsun_rs, RES,
                             fov=fov_for_distance(obs.dsun_rs))
        out = renderer(params, jnp.asarray(o.reshape(-1, 3)), jnp.asarray(d.reshape(-1, 3)),
                       jnp.zeros((RES * RES, 1)), key=None,
                       wavelengths=jnp.full((RES * RES, 1), 193.0))
        op_by_op = np.asarray(out['image'])[:, 0].reshape(RES, RES)
        port_view, jax_view = pdata / p_pif, jdata / j_pif
        gap = _rel(jax_view, op_by_op)
        assert _rel(jax_view, port_view) <= 2 * gap + RENDER_TOL, (name, gap)


def test_protocol_and_score_bundle_match_jax(scenes, tmp_path, monkeypatch, capsys):
    """The protocol's main on the port's scene, then both packages'
    score_bundle on its bundle and the same ground-truth files."""
    import jax
    port, _ = scenes
    row = psi_protocol.main(['--steps', '20', '--model-layers', '2', '--model-filter', '32',
                             '--n-stratified', '8', '--n-hierarchical', '8', '--resolution',
                             str(RES), '--device', 'cpu', '--data-cache', port, '--workdir',
                             str(tmp_path / 'run')])
    assert row['config'] == {'n_stratified': 8, 'n_hierarchical': 8, 'proposal_coarse': False,
                             'coarse_shape': None, 'steps': 20, 'tier_fraction': 0.0,
                             'tier_samples': 16, 'seed': 7, 'resolution': RES,
                             'model_shape': [2, 32]}
    assert row['rays_per_sec'] > 0 and row['effective_rays_per_sec'] > 0
    for split in ('train', 'test'):
        assert set(row[split]) == {'psnr', 'ssim', 'mae_percent', 'me_percent'}
        assert all(np.isfinite(v) for v in row[split].values())
    bundle = str(tmp_path / 'run' / 'run' / 'save_state.npz')
    got = score_bundle.main(['--bundle', bundle, '--resolution', str(RES), '--data-cache', port,
                             '--label', 'tiny', '--device', 'cpu'])
    assert got['train'] == row['train'] and got['test'] == row['test']
    # JAX's scorer on the same bundle and scene (it reuses the scene's files)
    monkeypatch.setattr(jax.config, 'update', lambda *a: None)   # no host compile cache
    monkeypatch.syspath_prepend(str(REPO / 'scripts'))
    monkeypatch.setattr(sys, 'argv', ['score_bundle.py', '--bundle', bundle, '--resolution',
                                      str(RES), '--data-cache', port, '--label', 'tiny'])
    sys.modules.pop('score_bundle', None)
    import score_bundle as jax_score_bundle
    capsys.readouterr()
    jax_score_bundle.main()
    want = __import__('json').loads(capsys.readouterr().out.strip().splitlines()[-1])
    for split in ('train', 'test'):
        assert abs(got[split]['psnr'] - want[split]['psnr']) <= 0.05, split
        assert abs(got[split]['ssim'] - want[split]['ssim']) <= 2e-3, split
        for k in ('mae_percent', 'me_percent'):
            assert abs(got[split][k] - want[split][k]) <= 1e-3 * abs(want[split][k]), (split, k)
