"""The port's acquisition and prep layer (sunerf_tpu_torch/data/{prep,
degradation,align,plot_data,download}.py, utils/{throughput,timing}.py and
load_map_stack's resampling) against the JAX package's, on the CPU, on
inputs made from a seed with numpy (the maps of
tests/test_baseline_and_metrics.py, filled with seeded values).

Tolerances: prepped data within 1e-6 relative of JAX's and the headers
equal (both packages run the same numpy and scipy code, so the bits agree in
practice); degradation factors and corrections bit-equal; everything else
equal. Both resampling branches run in both packages: scipy's zoom, and the
nearest-neighbour fallback with scipy.ndimage hidden from the import.
Nothing is downloaded: the fetches are checked through their gating and
through mocks of the packages they need.
"""
import glob
import json
import os
import sys
import types
import warnings
from datetime import datetime, timedelta

import numpy as np
import pytest
import torch

from sunerf_tpu.data import align as jax_align
from sunerf_tpu.data import download as jax_download
from sunerf_tpu.data import plot_data as jax_plot
from sunerf_tpu.data import prep as jax_prep
from sunerf_tpu.data.degradation import DegradationTable as JaxTable
from sunerf_tpu.data.loaders import load_map_stack as jax_load_map_stack
from sunerf_tpu.utils.throughput import effective_rate as jax_effective_rate
from sunerf_tpu_torch.data import align, download, plot_data, prep
from sunerf_tpu_torch.data.degradation import DegradationTable
from sunerf_tpu_torch.data.fits import Header, read_fits, write_fits
from sunerf_tpu_torch.data.loaders import load_map_stack
from sunerf_tpu_torch.data.wcs import observer_header
from sunerf_tpu_torch.utils.throughput import effective_rate
from sunerf_tpu_torch.utils.timing import measure_differenced, measure_median

torch.set_num_threads(1)

RTOL = 1e-6
# instrument -> (wavelength, extra header cards)
INSTRUMENTS = {
    'sdo': (193, {'QUALITY': 0}),
    'stereo': (195, {}),
    'psi': (193, {}),
    'so': (174, {'XPOSURE': 2.5}),
}


def _raw_map(path, seed, lat=3.0, lon=0.0, res=16, wavelength=193, when=None, **cards):
    """A seeded res^2 map with an observer header (the JAX tests' _disk_map,
    tests/test_baseline_and_metrics.py:27-32, filled with seeded values)."""
    header = Header()
    header.update(observer_header(lat, lon, 215.0, when or datetime(2012, 1, 1), res,
                                  float(wavelength)))
    header.update(cards)
    data = np.random.default_rng(seed).uniform(0, 9000, (res, res)).astype(np.float32)
    write_fits(str(path), data, header)
    return str(path)


def _same_output(jax_out, port_out):
    assert (jax_out is None) == (port_out is None)
    if jax_out is None:
        return
    jd, jh = read_fits(jax_out)
    pd, ph = read_fits(port_out)
    assert jh.cards == ph.cards
    np.testing.assert_allclose(pd, jd, rtol=RTOL, atol=0)


@pytest.fixture(params=['zoom', 'nearest'])
def branch(request, monkeypatch):
    """Both resample branches: scipy.ndimage hidden from the import for
    'nearest'."""
    if request.param == 'nearest':
        monkeypatch.setitem(sys.modules, 'scipy.ndimage', None)
    return request.param


@pytest.mark.parametrize('instrument', sorted(INSTRUMENTS))
@pytest.mark.parametrize('resolution', [8, 12, None])
def test_prep_file_matches_jax(tmp_path, branch, instrument, resolution):
    wl, cards = INSTRUMENTS[instrument]
    raw = _raw_map(tmp_path / 'raw.fits', seed=3, wavelength=wl, **cards)
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        jax_out = jax_prep.prep_file(raw, str(tmp_path / 'jax'), instrument, resolution)
        port_out = prep.prep_file(raw, str(tmp_path / 'port'), instrument, resolution)
    assert port_out is not None
    _same_output(jax_out, port_out)
    if resolution == 12:
        _, header = read_fits(port_out)
        assert header['NAXIS1'] == 12 and header['CDELT1'] != 0.0


def test_prep_resample_branches_differ(tmp_path, monkeypatch):
    """The two branches are two resamplers (a guard on the test above)."""
    data = np.random.default_rng(0).uniform(size=(16, 16)).astype(np.float32)
    zoom, _ = prep.resample(data, Header(), 8)
    monkeypatch.setitem(sys.modules, 'scipy.ndimage', None)
    nearest, _ = prep.resample(data, Header(), 8)
    np.testing.assert_array_equal(nearest, data[::2, ::2])
    assert not np.array_equal(zoom, nearest)


def test_prep_skips_and_cuts_like_jax(tmp_path):
    """sdo's QUALITY skip, psi's |lat| > 7 deg cut and lat_cut=False, and an
    unknown instrument, in both packages."""
    bad = _raw_map(tmp_path / 'bad.fits', 1, QUALITY=4)
    high = _raw_map(tmp_path / 'high.fits', 2, lat=30.0)
    for path, instrument, kw in ((bad, 'sdo', {}), (high, 'psi', {}),
                                 (high, 'psi', {'lat_cut': False})):
        _same_output(jax_prep.prep_file(path, str(tmp_path / 'j'), instrument, 8, **kw),
                     prep.prep_file(path, str(tmp_path / 'p'), instrument, 8, **kw))
    assert prep.prep_file(high, str(tmp_path / 'p'), 'psi', 8) is None
    with pytest.raises(ValueError, match='unknown instrument'):
        prep.prep_file(bad, str(tmp_path / 'p'), 'hinode')


def test_prep_degradation_options_match_jax(tmp_path):
    """sdo with an explicit table, and with degradation_table=False (the
    gated ITI path, skipped here with the same warning)."""
    raw = _raw_map(tmp_path / 'aia.fits', 5, wavelength=171, QUALITY=0,
                   when=datetime(2015, 6, 1))
    table = {'171': {'times': ['2012-01-01T00:00:00', '2016-01-01T00:00:00'],
                     'factors': [1.0, 0.6]}}
    for kw in ({'degradation_table': JaxTable(table)}, {'degradation_table': False}):
        port_kw = dict(kw)
        if kw['degradation_table'] is not False:
            port_kw['degradation_table'] = DegradationTable(table)
        _same_output(jax_prep.prep_file(raw, str(tmp_path / 'j'), 'sdo', 8, **kw),
                     prep.prep_file(raw, str(tmp_path / 'p'), 'sdo', 8, **port_kw))


def test_prep_cli_matches_jax(tmp_path):
    (tmp_path / 'raw').mkdir()
    for i, lat in enumerate((0.0, 5.0, 20.0)):
        _raw_map(tmp_path / 'raw' / f'v{i}.fits', 10 + i, lat=lat)
    pattern = str(tmp_path / 'raw' / '*.fits')
    for args in (['psi', '--resolution', '8'], ['psi', '--resolution', '8', '--keep-all-lats'],
                 ['stereo', '--resolution', '8', '--no-norm']):
        jax_prep.main([*args, '--files', pattern, '--out', str(tmp_path / 'j' / args[-1])])
        prep.main([*args, '--files', pattern, '--out', str(tmp_path / 'p' / args[-1])])
        jf = sorted(glob.glob(str(tmp_path / 'j' / args[-1] / '*.fits')))
        pf = sorted(glob.glob(str(tmp_path / 'p' / args[-1] / '*.fits')))
        assert [os.path.basename(f) for f in jf] == [os.path.basename(f) for f in pf]
        for a, b in zip(jf, pf):
            _same_output(a, b)


def test_degradation_table_matches_jax():
    """The packaged tables (the port's copy and JAX's) bit-equal at many
    times and every channel (and an absent one); correct() likewise."""
    jt, pt = JaxTable.default(), DegradationTable.default()
    assert pt.channels.keys() == jt.channels.keys()
    assert pt.approx_channels == jt.approx_channels == {304, 335}
    rng = np.random.default_rng(7)
    start = datetime(2009, 1, 1)
    times = [start + timedelta(seconds=float(s)) for s in rng.uniform(0, 4e8, 200)]
    data = rng.uniform(0, 1e4, (4, 4)).astype(np.float32)
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        for wl in (*sorted(jt.channels), 1600):
            for t in times:
                assert pt.factor(wl, t) == jt.factor(wl, t)
            for t in times[:10]:
                np.testing.assert_array_equal(pt.correct(data, wl, t), jt.correct(data, wl, t))


def test_degradation_warns_once_a_channel():
    table = DegradationTable.default()
    when = datetime(2013, 1, 1)
    for wl in (304, 335):
        with pytest.warns(UserWarning, match=f'AIA {wl} A degradation factors'):
            table.correct(np.ones((2, 2)), wl, when)
    with warnings.catch_warnings():
        warnings.simplefilter('error')
        for wl in (304, 335, 171, 193):
            table.correct(np.ones((2, 2)), wl, when)


def test_degradation_from_json_matches_jax(tmp_path):
    table = {'_meta': {'approximate_channels': [193]},
             '193': {'times': ['2012-01-01T00:00:00Z', '2013-01-01T00:00:00'],
                     'factors': [1.0, 0.5]}}
    path = tmp_path / 'deg.json'
    path.write_text(json.dumps(table))
    jt, pt = JaxTable.from_json(str(path)), DegradationTable.from_json(str(path))
    assert pt.approx_channels == jt.approx_channels == {193}
    for day in range(0, 500, 7):
        t = datetime(2011, 12, 1) + timedelta(days=day)
        assert pt.factor(193, t) == jt.factor(193, t)


def _aligned_tree(root):
    return sorted(os.path.relpath(p, root) for p in glob.glob(str(root / '**' / '*.fits'),
                                                              recursive=True))


def test_align_directories_matches_jax(tmp_path):
    a, b = tmp_path / 'in' / '171', tmp_path / 'in' / '193'
    for d, hours in ((a, (0, 6, 12, 18)), (b, (6, 12, 18, 23))):
        d.mkdir(parents=True)
        for h in hours:
            (d / f'aia_2012-08-23T{h:02d}:00:00.fits').write_bytes(bytes([h]) * 16)
    dirs = [str(a), str(b)]
    got = align.align_directories(dirs, str(tmp_path / 'p'))
    want = jax_align.align_directories(dirs, str(tmp_path / 'j'))
    assert got == want and len(got) == 3
    assert _aligned_tree(tmp_path / 'p') == _aligned_tree(tmp_path / 'j')
    assert align.align_directories(dirs, str(tmp_path / 'x'), copy=False) == want
    assert not (tmp_path / 'x').exists()
    align.main(['--dirs', *dirs, '--out', str(tmp_path / 'cli')])
    assert _aligned_tree(tmp_path / 'cli') == _aligned_tree(tmp_path / 'j')


@pytest.mark.parametrize('shape,block', [((16, 16), 8), ((17, 30), 4), ((9, 9), 3)])
def test_block_reduce_mean_matches_jax(shape, block):
    data = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    np.testing.assert_array_equal(plot_data.block_reduce_mean(data, block),
                                  jax_plot.block_reduce_mean(data, block))


def test_plot_data_matches_jax(tmp_path):
    pytest.importorskip('matplotlib')
    raw = tmp_path / 'raw'
    raw.mkdir()
    for i in range(3):
        _raw_map(raw / f'v{i}.fits', i)
    header = Header()
    header.update(observer_header(0.0, 0.0, 215.0, datetime(2012, 1, 1), 16, 193.0))
    write_fits(str(raw / 'flat.fits'), np.full((16, 16), 0.5, np.float32), header)
    pattern = str(raw / '*.fits')
    got = plot_data.plot_data(pattern, str(tmp_path / 'p'), block=4, archive=True)
    want = jax_plot.plot_data(pattern, str(tmp_path / 'j'), block=4, archive=True)
    assert got == want and got['flat_frames'] == [str(raw / 'flat.fits')]
    assert sorted(os.listdir(tmp_path / 'p')) == sorted(os.listdir(tmp_path / 'j'))
    assert os.path.exists(str(tmp_path / 'p') + '.zip')
    plot_data.main([pattern, str(tmp_path / 'cli'), '--block', '4', '--no-archive'])
    assert not os.path.exists(str(tmp_path / 'cli') + '.zip')


def test_plot_data_without_matplotlib(tmp_path, monkeypatch):
    """The card's host has no matplotlib: plot_data says so, by name."""
    monkeypatch.setitem(sys.modules, 'matplotlib', None)
    with pytest.raises(RuntimeError, match='matplotlib required'):
        plot_data.plot_data(str(tmp_path / '*.fits'), str(tmp_path / 'out'))


def _message(fn, *args):
    with pytest.raises(ImportError) as info:
        fn(*args)
    return str(info.value)


@pytest.mark.parametrize('name,args', [
    ('download_jsoc', ('x@y', '2012-01-01', '2012-01-02', [193], '6h', 'OUT')),
    ('download_fido', ('2012-01-01', '2012-01-02', 193, 'AIA', 'OUT')),
    ('download_eui', ('2022-03-01', '2022-03-05', 'OUT')),
    ('download_synoptic', (2150, 'OUT')),
    ('_build_iti_translator', ('stereo_to_sdo_v0_2.pt', 1024)),
])
def test_download_gating_matches_jax(tmp_path, name, args):
    """Each fetch raises ImportError naming what it needs, with JAX's
    message, 'this TPU image' read as 'this host'."""
    args = tuple(str(tmp_path / 'out') if a == 'OUT' else a for a in args)
    got = _message(getattr(download, name), *args)
    want = _message(getattr(jax_download, name), *args)
    assert got == want.replace('this TPU image', 'this host')
    assert 'TPU' not in got


def test_download_cli_wiring_matches_jax(tmp_path):
    """Every subcommand parses and reaches its gated implementation; an
    empty SECCHI tree converts nothing before the translator is built."""
    for mod in (download, jax_download):
        with pytest.raises(ImportError, match='drms'):
            mod.main(['synoptic', '--carrington-rotation', '2150', '--out', str(tmp_path)])
        with pytest.raises(ImportError, match='drms'):
            mod.main(['jsoc', '--email', 'a@b', '--start', 's', '--end', 'e', '--out',
                      str(tmp_path)])
        with pytest.raises(ImportError, match='sunpy'):
            mod.main(['fido', '--start', 's', '--end', 'e', '--wavelength', '195', '--out',
                      str(tmp_path)])
        with pytest.raises(ImportError, match='sunpy'):
            mod.main(['eui', '--start', 's', '--end', 'e', '--out', str(tmp_path)])
        mod.main(['stereo-to-sdo', '--data-path', str(tmp_path), '--out',
                  str(tmp_path / 'out')])


class _FakeExport:
    def __init__(self, log, query):
        self.log, self.query = log, query

    def wait(self):
        self.log.append(('wait', self.query))

    def download(self, directory):
        self.log.append(('download', directory))
        return types.SimpleNamespace(download=types.SimpleNamespace(
            values=[os.path.join(directory, 'a.fits')]))


def _fake_drms(log):
    class Client:
        def __init__(self, email=None):
            log.append(('client', email))

        def export(self, query, method, protocol):
            log.append(('export', query, method, protocol))
            return _FakeExport(log, query)
    return types.SimpleNamespace(Client=Client)


def test_download_jsoc_query_matches_jax(tmp_path, monkeypatch):
    """A mock drms: the port's JSOC export builds JAX's queries and
    directories."""
    logs = {}
    for name, mod in (('port', download), ('jax', jax_download)):
        log = logs[name] = []
        monkeypatch.setitem(sys.modules, 'drms', _fake_drms(log))
        out = mod.download_jsoc('me@x', '2012-08-01', '2012-09-01', [171, 193], '6h',
                                str(tmp_path / 'out'))
        assert out == [str(tmp_path / 'out' / str(w) / 'a.fits') for w in (171, 193)]
    assert logs['port'] == logs['jax']
    assert ('export', 'aia.lev1_euv_12s[2012-08-01Z-2012-09-01Z@6h][171]{image}', 'url',
            'fits') in logs['port']


def test_stereo_to_sdo_conversion_matches_jax(tmp_path):
    """convert_stereo_to_sdo with a fake translator (the ITI model is not in
    the repo) in both packages: the same basenames, paths and outputs."""
    data = tmp_path / 'prep'
    names = ['a_2012-08-01T00:00:00.fits', 'b_2012-08-01T06:00:00.fits',
             'c_2012-08-01T12:00:00.fits']
    for wl in download.STEREO_WAVELENGTHS:
        (data / wl).mkdir(parents=True)
        for n in names if wl != '284' else names[:2]:
            (data / wl / n).write_bytes(b'')
    assert download.align_stereo_basenames(str(data)) == \
        jax_download.align_stereo_basenames(str(data)) == names[:2]

    class FakeMap:
        def save(self, path):
            with open(path, 'w') as f:
                f.write('x')

    calls = {}

    class FakeTranslator:
        def translate(self, paths, basenames=None):
            calls.setdefault('paths', []).append(paths)
            for _ in basenames:
                yield [FakeMap() for _ in range(4)]

    got = download.convert_stereo_to_sdo(str(data), str(tmp_path / 'p'),
                                         translator=FakeTranslator())
    want = jax_download.convert_stereo_to_sdo(str(data), str(tmp_path / 'j'),
                                              translator=FakeTranslator())
    assert [os.path.relpath(p, tmp_path / 'p') for p in got] == \
        [os.path.relpath(p, tmp_path / 'j') for p in want]
    assert len(got) == 8 and calls['paths'][0] == calls['paths'][1]
    assert download.convert_stereo_to_sdo(str(data), str(tmp_path / 'p')) == []


@pytest.mark.parametrize('samples,starts', [
    ([(10, 100.0), (20, 200.0), (30, 300.0)], (0,)),
    ([(30, 300.0), (10, 100.0), (20, 200.0)], (0,)),
    ([(10, 50.0), (20, 100.0), (30, 100.0), (40, 400.0), (50, 400.0)], (0, 25)),
    ([(5, 10.0), (15, 0.0), (25, 30.0), (40, 45.0)], (0, 30)),
    ([(100, 1e5), (200, 2e5), (300, 3e5)], (0, 150)),
])
def test_effective_rate_matches_jax(samples, starts):
    assert effective_rate(samples, starts) == jax_effective_rate(samples, starts)


def test_effective_rate_refuses_like_jax():
    for fn in (effective_rate, jax_effective_rate):
        with pytest.raises(ValueError, match='no logging windows survive'):
            fn([(10, 5.0)], (0,))


def test_measure_median_on_the_cpu():
    """The differenced timing on CPU tensors (nothing to synchronise), for
    results that are a tensor, a tuple and a dict."""
    x = torch.ones(64, 64)
    for fn in (lambda: x @ x, lambda: (x @ x, x + 1), lambda: {'y': x @ x}):
        t = measure_median(fn, reps=3, n1=1, n2=3, warmup=1)
        assert isinstance(t, float) and abs(t) < 1.0
    assert isinstance(measure_differenced(lambda: x + 1, n1=1, n2=2, warmup=0), float)


@pytest.mark.parametrize('resolution', [8, 12])
def test_load_map_stack_resamples_like_jax(tmp_path, branch, resolution):
    files = [_raw_map(tmp_path / f'm{i}.fits', 20 + i, wavelength=wl)
             for i, wl in enumerate((171, 193, 211))]
    for kw in ({}, {'apply_norm': True}, {'percentile_clip_percent': 0.25}):
        got = load_map_stack(files, resolution=resolution, **kw)
        np.testing.assert_array_equal(got, jax_load_map_stack(files, resolution=resolution,
                                                              **kw))
        assert got.shape == (3, resolution, resolution)
