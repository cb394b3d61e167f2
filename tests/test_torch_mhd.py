"""The port's MHD field (sunerf_tpu_torch/models/mhd_field.py), its PSI HDF5
reader (data/psi_io.py, numpy alone) and the MHD renderer, against the JAX
package on the CPU.

  * the reader against h5py (and JAX's h5py reader) on files written by
    JAX's write_hdf / wrhdf_3d: the same arrays, bit for bit;
  * MHDFieldLoader: JAX's arrays and frame numbers, bit for bit;
  * mhd_apply against JAX's: within 1e-5 of max(|raw|, 1) (the same float32
    formulas; atan2 / arccos differ by an ulp between the libraries, which
    moves an interpolation weight: 2.6e-6 at the worst of 4,000 points);
  * renders: 2e-4 of max, float32 against JAX's float32 render op by op,
    at a close observer and at 1 AU. Jitted, JAX's own render moves by up to
    3.7% of max (7.6% on the absorption map): the sampler's last sample of a
    disk ray lies on the solar surface, r = 1 to an ulp, which is the
    cube's inner edge, so XLA's roundings flip it between the cube and the
    fill value (ROADMAP Queue 3);
  * the committed fixture (sunerf_tpu_torch/assets/psi_fixture, written by
    JAX's wrhdf_3d; regenerate with `PYTHONPATH=. python
    tests/test_torch_mhd.py`) read by the numpy reader equals its h5py read
    (psi_fixture.npz), bit for bit.
"""
import glob
import os
from pathlib import Path

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sunerf_tpu.data import psi_io as jax_psi_io
from sunerf_tpu.evaluation.image_render import render_observers as jax_render_observers
from sunerf_tpu.models.mhd_field import MHDFieldLoader as JaxMHDFieldLoader
from sunerf_tpu.models.mhd_field import mhd_apply as jax_mhd_apply
from sunerf_tpu.systems import make_mhd_renderer as jax_make_mhd_renderer
from sunerf_tpu_torch.core.geometry import observer_rays
from sunerf_tpu_torch.data import psi_io
from sunerf_tpu_torch.data.fits import read_fits
from sunerf_tpu_torch.evaluation.image_render import render_observers
from sunerf_tpu_torch.models.mhd_field import MHDFieldLoader, mhd_apply
from sunerf_tpu_torch.systems import from_spec, make_mhd_renderer

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
FIXTURE = REPO / 'sunerf_tpu_torch' / 'assets' / 'psi_fixture'
FIXTURE_NPZ = REPO / 'sunerf_tpu_torch' / 'assets' / 'psi_fixture.npz'
FIELD_TOL = 1e-5
RENDER_TOL = 2e-4
AIA = [94.0, 131.0, 171.0, 193.0, 211.0, 304.0, 335.0]


# ------------------------------------------------------------------ fixture

def fixture_cubes(frame: int):
    """The fixture's grids and its (rho, T) cubes [phi, theta, r] of one
    frame: a corona falling off with height (scale height 0.15 Rs), streamers
    in longitude and latitude, 1-2 MK, both moving with the frame."""
    r = np.geomspace(1.0, 3.0, 12)
    th = np.linspace(0.0, np.pi, 12)
    ph = np.linspace(0.0, 2 * np.pi, 16)
    P, T, R = np.meshgrid(ph, th, r, indexing='ij')
    shift = 0.3 * frame
    rho = 1e5 * np.exp(-(R - 1.0) / 0.15) * (1.0 + 0.5 * np.cos(2 * P + shift)
                                             * np.sin(T) ** 2)
    temp = 1.0 + 0.6 * np.sin(T) ** 2 + 0.2 * np.cos(P - shift) + 0.1 * (R - 1.0)
    return r, th, ph, rho.astype(np.float32), temp.astype(np.float32)


def write_fixture(root: Path, writer=jax_psi_io.wrhdf_3d):
    """rho/ and t/ frames 2531 and 2532 under root, through JAX's writer."""
    for f in range(2):
        r, th, ph, rho, temp = fixture_cubes(f)
        for var, cube in (('rho', rho), ('t', temp)):
            (root / var).mkdir(parents=True, exist_ok=True)
            writer(str(root / var / f'{var}00{2531 + f}.h5'), r.astype(np.float32),
                   th.astype(np.float32), ph.astype(np.float32), cube)


def h5py_read(path: str) -> dict:
    """A file's Data and its first scale a dimension, read by h5py."""
    with h5py.File(path, 'r') as f:
        d = f['Data']
        out = {'data': np.asarray(d)}
        for i in range(d.ndim):
            out[f'dim{i}'] = (np.asarray(d.dims[i][0]) if len(d.dims[i].keys())
                              else np.array([]))
    return out


# ------------------------------------------------------------------- reader

@pytest.mark.parametrize('dtype', [np.float32, np.float64])
@pytest.mark.parametrize('ndim', [1, 2, 3])
@pytest.mark.parametrize('scales', ['all', 'none', 'some'])
def test_reader_matches_h5py(tmp_path, ndim, dtype, scales):
    """The numpy reader against h5py's and JAX's reads of a file from JAX's
    writer: the data and every scale, the same dtype and bits."""
    rng = np.random.default_rng(ndim)
    shape = (5, 4, 3)[:ndim]
    data = rng.normal(size=shape).astype(dtype)
    axes = [np.linspace(0, 1, n) for n in shape]
    if scales == 'some':
        axes[0] = np.array([])
    path = str(tmp_path / 'f.h5')
    jax_psi_io.write_hdf(path, data, scales=None if scales == 'none' else axes)
    ours_scales, ours = psi_io.read_hdf(path)
    ref = h5py_read(path)
    assert ours.dtype == ref['data'].dtype == dtype
    np.testing.assert_array_equal(ours, ref['data'])
    for i in range(ndim):
        assert ours_scales[i].dtype == ref[f'dim{i}'].dtype
        np.testing.assert_array_equal(ours_scales[i], ref[f'dim{i}'])
    jax_scales, jax_data = jax_psi_io.read_hdf(path)
    np.testing.assert_array_equal(ours, jax_data)
    for a, b in zip(ours_scales, jax_scales):
        np.testing.assert_array_equal(a, b)
    reader = {1: psi_io.rdhdf_1d, 2: psi_io.rdhdf_2d, 3: psi_io.rdhdf_3d}[ndim]
    np.testing.assert_array_equal(reader(path)[-1], data)


@pytest.mark.parametrize('layout,message', [
    ({'chunks': (5, 4)}, 'chunked data layout'),
    ({'compression': 'gzip'}, 'filter pipeline'),
    ({'shape': (3, 2), 'dtype': 'i4'}, 'data type class 0'),
])
def test_reader_refuses_what_it_does_not_read(tmp_path, layout, message):
    path = str(tmp_path / 'f.h5')
    with h5py.File(path, 'w') as f:
        if 'shape' in layout:
            f.create_dataset('Data', data=np.zeros(layout['shape'], layout['dtype']))
        else:
            f.create_dataset('Data', data=np.zeros((10, 8)), **layout)
    with pytest.raises(ValueError, match=message):
        psi_io.read_hdf(path)
    (tmp_path / 'g.h5').write_bytes(b'not hdf5')
    with pytest.raises(ValueError, match='not an HDF5 file'):
        psi_io.read_hdf(str(tmp_path / 'g.h5'))


def test_reader_never_imports_h5py():
    import inspect
    src = inspect.getsource(psi_io._File) + inspect.getsource(psi_io.read_hdf)
    assert 'h5py' not in src


def test_committed_fixture_equals_its_h5py_read():
    """The fixture (under 100 KB with its npz) read by the numpy reader is
    its h5py read, saved beside it."""
    files = sorted(glob.glob(str(FIXTURE / '*' / '*.h5')))
    assert len(files) == 4
    size = sum(os.path.getsize(f) for f in files) + os.path.getsize(FIXTURE_NPZ)
    assert size < 100_000, size
    saved = np.load(FIXTURE_NPZ)
    for f in files:
        key = os.path.relpath(f, FIXTURE)
        scales, data = psi_io.read_hdf(f)
        np.testing.assert_array_equal(data, saved[f'{key}/data'])
        assert data.dtype == saved[f'{key}/data'].dtype == np.float32
        for i, s in enumerate(scales):
            np.testing.assert_array_equal(s, saved[f'{key}/dim{i}'])


# -------------------------------------------------------------------- field

def _fixture(tmp_path) -> Path:
    write_fixture(tmp_path / 'psi')
    return tmp_path / 'psi'


def test_loader_matches_jax(tmp_path):
    root = _fixture(tmp_path)
    ours, theirs = MHDFieldLoader(str(root), device='cpu'), JaxMHDFieldLoader(str(root))
    assert (ours.ffirst, ours.flast) == (theirs.ffirst, theirs.flast) == (2531, 2532)
    for k in ('r_grid', 'theta_grid', 'phi_grid', 'rho', 'temperature'):
        np.testing.assert_array_equal(getattr(ours.field, k).numpy(),
                                      np.asarray(getattr(theirs.field, k)))
    for k, v in ours.init_params().items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(theirs.init_params()[k]))
    one = MHDFieldLoader(str(root), max_frames=1, device='cpu')
    assert one.field.rho.shape[0] == 1 and one.flast == 2531
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='no CUDA device'):
            MHDFieldLoader(str(root))


def _probe_points(loader, n=4000, seed=0) -> np.ndarray:
    """Seeded points inside and outside the cube (r in [0.5, 3.5]), and on
    its edges where float32 places them exactly: on the axes at both ends
    of the r grid, at the poles (theta 0 and pi) and in the y = 0 half-plane
    x > 0 (phi 0); t in [0, 1] with both ends."""
    rng = np.random.default_rng(seed)
    f = loader.field
    r = rng.uniform(0.5, 3.5, n)
    th = rng.uniform(0, np.pi, n)
    ph = rng.uniform(0, 2 * np.pi, n)
    pts = np.stack([r * np.sin(th) * np.cos(ph), r * np.sin(th) * np.sin(ph),
                    r * np.cos(th), rng.uniform(0, 1, n)], -1).astype(np.float32)
    k = n // 8
    bounds = np.float32([f.r_grid[0], f.r_grid[-1]])
    axis = rng.integers(0, 3, 2 * k)
    pts[:2 * k, :3] = 0.0
    pts[np.arange(2 * k), axis] = rng.choice([-1, 1], 2 * k) * rng.choice(bounds, 2 * k)
    pts[2 * k:3 * k, :2] = 0.0                                          # the poles
    pts[3 * k:4 * k, 1] = 0.0                                           # phi = 0
    pts[3 * k:4 * k, 0] = np.abs(pts[3 * k:4 * k, 0])
    pts[:k // 2, 3], pts[k // 2:k, 3] = 0.0, 1.0
    return pts


def test_mhd_apply_matches_jax(tmp_path):
    root = _fixture(tmp_path)
    ours, theirs = MHDFieldLoader(str(root), device='cpu'), JaxMHDFieldLoader(str(root))
    pts = _probe_points(theirs)
    got = mhd_apply(ours.field, ours.init_params(), torch.as_tensor(pts)).raw.numpy()
    ref = np.asarray(jax_mhd_apply(theirs.field, theirs.init_params(), jnp.asarray(pts)).raw)
    assert got.shape == ref.shape == (len(pts), 2)
    err = np.abs(got - ref) / np.maximum(np.abs(ref), 1.0)
    assert err.max() <= FIELD_TOL, err.max()
    # outside the cube: the fill value in both
    outside = np.linalg.norm(pts[:, :3], axis=-1) > 3.0 + 1e-5
    assert outside.any()
    np.testing.assert_array_equal(got[outside, 0], np.float32(np.log(np.float32(1e-10))))


def test_mhd_field_roundtrip(tmp_path):
    """test_mhd_field_roundtrip (tests/test_end_to_end.py:538-577) on the
    port: synthetic cubes through JAX's writer, the numpy reader and the
    port's loader interpolate the analytic profile they were made from."""
    r = np.linspace(1.0, 3.0, 20)
    th = np.linspace(0.0, np.pi, 16)
    phi = np.linspace(0.0, 2 * np.pi, 24)
    for var, make in (('rho', lambda f: 100.0 / r[None, None, :] ** 2 + np.zeros((24, 16, 1))),
                      ('t', lambda f: np.full((24, 16, 20), 1.5 + 0.1 * f))):
        d = tmp_path / var
        d.mkdir()
        for f in range(2):
            jax_psi_io.wrhdf_3d(str(d / f'{var}00{2531 + f}.h5'), r, th, phi, make(f))
    rr, tt, pp, data = psi_io.rdhdf_3d(str(tmp_path / 'rho' / 'rho002531.h5'))
    np.testing.assert_allclose(rr, r)
    assert data.shape == (24, 16, 20)
    loader = MHDFieldLoader(str(tmp_path), device='cpu')
    assert loader.ffirst == 2531 and loader.flast == 2532
    pts = torch.tensor([[2.0, 0.0, 0.0, 0.0], [1.5, 0.0, 0.0, 1.0], [10.0, 0.0, 0.0, 0.0]])
    raw = mhd_apply(loader.field, loader.init_params(), pts).raw.numpy()
    np.testing.assert_allclose(raw[0, 0], np.log(100 / 4), rtol=1e-3)
    np.testing.assert_allclose(raw[1, 0], np.log(100 / 2.25), rtol=1e-3)
    np.testing.assert_allclose(raw[0, 1], np.log10(1e6 * 1.5), rtol=1e-3)
    np.testing.assert_allclose(raw[1, 1], np.log10(1e6 * 1.6), rtol=1e-3)
    np.testing.assert_allclose(raw[2, 0], np.log(1e-10), rtol=1e-3)


# ------------------------------------------------------------------- render

def _rel(ref, got) -> float:
    ref, got = np.asarray(ref, np.float64), np.asarray(got, np.float64)
    return float(np.max(np.abs(ref - got)) / np.max(np.abs(ref)))


def _jax_frames(renderer, params, rays_o, rays_d, t, wavelengths) -> dict:
    """JAX's render op by op: jitted, XLA flips the samples that the sampler
    puts on the solar surface, the cube's inner edge (ROADMAP Queue 3)."""
    out = renderer(params, *(jnp.asarray(x) for x in (rays_o, rays_d, t)), key=None,
                   wavelengths=jnp.asarray(wavelengths))
    return {k: np.asarray(out[k]) for k in ('image', 'height_map', 'absorption_map')}


@pytest.mark.parametrize('distance', [5.0, 215.0])
def test_mhd_renderer_matches_jax(tmp_path, distance):
    """test_mhd_renderer's set-up (tests/test_end_to_end.py:580-609: 8 + 8
    samples, no jitter, coarse log_abs zeroed), in all seven channels, at
    16^2 on the fixture's cubes: the port's frame is JAX's op-by-op frame."""
    root = _fixture(tmp_path)
    pr, pp = make_mhd_renderer(MHDFieldLoader(str(root), device='cpu'), n_stratified=8,
                               n_hierarchical=8, perturb=False)
    jr, jp = jax_make_mhd_renderer(JaxMHDFieldLoader(str(root)), n_stratified=8,
                                   n_hierarchical=8, perturb=False)
    pp['coarse']['log_abs'] = torch.zeros(7)
    jp['coarse']['log_abs'] = jnp.zeros(7)
    res = 16
    rays_o, rays_d = observer_rays(0.3, 1.0, distance, res)
    o, d = rays_o.reshape(-1, 3), rays_d.reshape(-1, 3)
    t = np.full((res * res, 1), 0.4, np.float32)
    wl = np.broadcast_to(np.float32(AIA), (res * res, 7))
    with torch.no_grad():
        got = pr(pp, *(torch.as_tensor(x) for x in (o, d, t)),
                 wavelengths=torch.as_tensor(wl.copy()))
    ref = _jax_frames(jr, jp, o, d, t, wl)
    assert np.all(np.isfinite(got['image'].numpy())) and got['image'].max() > 0
    for k in ref:
        assert _rel(ref[k], got[k].numpy()) <= RENDER_TOL, (k, _rel(ref[k], got[k].numpy()))


def _render_config(tmp_path, root) -> dict:
    import yaml
    with open(REPO / 'config' / 'render_mhd.yaml') as f:
        config = yaml.safe_load(f)
    config.update(data_path=str(root), resolution=16, render_format=['fits'], batch_size=128)
    return config


def test_image_render_mhd_matches_jax_cli(tmp_path):
    """config/render_mhd.yaml's four observers (at 16^2, on the fixture)
    through image_render's MHDModel path: the same files and headers as
    JAX's CLI; each frame within RENDER_TOL of max of JAX's op-by-op render,
    and no further from JAX's CLI (jitted) frame than twice JAX's own
    jitted-to-op-by-op gap plus RENDER_TOL; disks brighter than corners."""
    from datetime import datetime, timedelta
    from sunerf_tpu.evaluation.image_render import (build_model_renderer as jax_build,
                                                    observers_from_config)
    from sunerf_tpu.core.geometry import fov_for_distance
    root = _fixture(tmp_path)
    config = _render_config(tmp_path, root)
    render_observers(dict(config, render_path=str(tmp_path / 'port')), device='cpu')
    jax_render_observers(dict(config, render_path=str(tmp_path / 'jax')))
    names = lambda base: sorted(os.path.relpath(os.path.join(dp, f), base)  # noqa: E731
                                for dp, _, fs in os.walk(base) for f in fs)
    assert names(tmp_path / 'port') == names(tmp_path / 'jax')
    assert len(names(tmp_path / 'port')) == 4 * 6
    jr, jp = jax_build(config)
    res, wls = config['resolution'], config['wavelengths']
    op_by_op = {}
    for i, obs in enumerate(observers_from_config(config)):
        o, d = observer_rays(np.deg2rad(obs['lat']), np.deg2rad(obs['lon']), obs['distance'],
                             res, fov=fov_for_distance(obs['distance']))
        t = np.full((res * res, 1), obs['time'], np.float32)
        img = _jax_frames(jr, jp, o.reshape(-1, 3), d.reshape(-1, 3), t,
                          np.broadcast_to(np.float32(wls), (res * res, len(wls))))['image']
        stamp = (datetime(2000, 1, 1) + timedelta(seconds=obs['time'] * 86400.0)).strftime(
            '%Y-%m-%dT%H:%M:%S')
        for c, wl in enumerate(wls):
            op_by_op[os.path.join(obs['name'], str(wl), f"{obs['name']}_{i:03d}.{stamp}."
                                  f"{wl}.fits")] = img[:, c].reshape(res, res)
    for name in names(tmp_path / 'port'):
        pdata, pheader = read_fits(str(tmp_path / 'port' / name))
        jdata, jheader = read_fits(str(tmp_path / 'jax' / name))
        assert dict(pheader.cards) == dict(jheader.cards), name
        assert np.all(np.isfinite(pdata))
        assert _rel(op_by_op[name], pdata) <= RENDER_TOL, (name, _rel(op_by_op[name], pdata))
        assert _rel(jdata, pdata) <= 2 * _rel(jdata, op_by_op[name]) + RENDER_TOL, name
        assert pdata[6:10, 6:10].mean() > pdata[[0, 0, -1, -1], [0, -1, 0, -1]].mean(), name


def test_from_spec_and_export_of_an_mhd_spec(tmp_path):
    """from_spec('mhd') rebuilds the renderer from a bundle's spec (the cubes
    read again from data_path); the spec exports with its cubes baked in as
    constants (no op) and serves as live renders."""
    from sunerf_tpu_torch.evaluation.serving import ServingModel, export_serving
    from sunerf_tpu_torch.utils.checkpoint import save_state
    root = _fixture(tmp_path)
    renderer, params = make_mhd_renderer(MHDFieldLoader(str(root), device='cpu'),
                                         n_stratified=8, n_hierarchical=8, perturb=False)
    params = {k: dict(v, log_abs=torch.zeros(7)) for k, v in params.items()}
    rebuilt, init = from_spec(renderer.spec, device='cpu')
    assert rebuilt.spec == renderer.spec and rebuilt.spec['data_path'] == str(root)
    np.testing.assert_array_equal(init()['fine']['log_abs'].numpy(),
                                  np.float32([20.4, 20.2, 20.0, 19.8, 19.6, 19.4, 19.2]))
    path = str(tmp_path / 'save_state')
    save_state(path, params, {'renderer_spec': renderer.spec, 'wavelengths': [171.0, 193.0]})
    out = str(tmp_path / 'mhd.tsrv')
    meta = export_serving(path, out, batch_size=64, platforms=('cpu',))
    assert meta['fused_cuda'] is False and meta['n_channels'] == 2
    model = ServingModel(out, device='cpu')
    rays_o, rays_d = observer_rays(0.3, 1.0, 5.0, 8)
    o, d = rays_o.reshape(-1, 3), rays_d.reshape(-1, 3)
    t = np.full((64, 1), 0.25, np.float32)
    served = model(o, d, t)
    with torch.no_grad():
        live = rebuilt(params, *(torch.as_tensor(x) for x in (o, d, t)),
                       wavelengths=torch.tensor([171.0, 193.0]).expand(64, 2))
    for k in ('image', 'height_map', 'absorption_map'):
        np.testing.assert_allclose(served[k], live[k].numpy(), rtol=1e-4, atol=1e-6)
    assert served['image'].max() > 0
    q = np.concatenate([d[:32] * 1.5, t[:32]], -1)       # points inside the cube
    np.testing.assert_allclose(model.query_points(q), rebuilt.forward_points(
        params, torch.as_tensor(q)).raw.numpy(), rtol=1e-4, atol=1e-6)


if __name__ == '__main__':
    # regenerate the committed fixture and its h5py read
    import shutil
    shutil.rmtree(FIXTURE, ignore_errors=True)
    write_fixture(FIXTURE)
    saved = {}
    for f in sorted(glob.glob(str(FIXTURE / '*' / '*.h5'))):
        key = os.path.relpath(f, FIXTURE)
        for k, v in h5py_read(f).items():
            saved[f'{key}/{k}'] = v
    np.savez_compressed(FIXTURE_NPZ, **saved)
    print(sorted(saved), sum(os.path.getsize(f) for f in glob.glob(str(FIXTURE / '*' / '*.h5'))),
          os.path.getsize(FIXTURE_NPZ))
