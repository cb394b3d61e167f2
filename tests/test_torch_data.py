"""The port's host data layer (sunerf_tpu_torch/data, native) and its
training CLI against the JAX package, on the CPU.

The data layer is numpy in both packages, the port's a copy, so it is held
bit for bit: the same FITS files (plain ones from JAX's write_fits, and
RICE_1 / GZIP_1 tile-compressed ones from the independent compressor of
tests/test_fits_compressed.py) read to the same arrays and headers with the
port's native and pure-Python Rice decoders, and build_single_channel_data
gives the same rays, times, targets and batch order.

The CLI test runs both packages' run_emission.main on one tiny config. The
test host gives JAX 8 CPU devices (tests/conftest.py), so JAX's CLI trains
on an 8-device mesh with 8x the global batch: the two runs are held to
their own outputs (logged steps, bundles), not to each other's numbers.
"""
import json
import os
import signal
from datetime import datetime

import jax
import numpy as np
import pytest
import torch
import yaml

from sunerf_tpu.data.datasets import iterate_batches as jax_iterate_batches
from sunerf_tpu.data.fits import read_fits as jax_read_fits
from sunerf_tpu.data.fits import write_fits as jax_write_fits
from sunerf_tpu.data.loaders import build_single_channel_data as jax_build
from sunerf_tpu.data.wcs import observer_header as jax_observer_header
from sunerf_tpu.evaluation.image_render import render_observers
from sunerf_tpu.utils.checkpoint import load_state as jax_load_state
from sunerf_tpu_torch import native
from sunerf_tpu_torch.data import fits as port_fits
from sunerf_tpu_torch.data.datasets import iterate_batches
from sunerf_tpu_torch.data.loaders import (build_single_channel_data, date_from_filename,
                                           load_map_stack, scan_instrument_tree)
from sunerf_tpu_torch.data.wcs import observer_header, parse_observer
from sunerf_tpu_torch.evaluation.loader import SuNeRFLoader

from test_fits_compressed import write_tile_compressed

torch.set_num_threads(1)


@pytest.fixture(params=['native', 'python'])
def decoder(request, monkeypatch):
    """The port's Rice decoder: the g++-built rice.cpp or the pure-Python
    decoder."""
    if request.param == 'native':
        assert native.decoder() == 'native'
    else:
        monkeypatch.setattr(native, '_lib', None)
        monkeypatch.setattr(native, '_lib_tried', True)
        assert native.decoder() == 'python'
    return request.param


def _image(shape=(24, 20), seed=0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (1000.0 * rng.random(shape) ** 2).astype(np.float32)


def _same_read(path):
    """Both read_fits on one file: the same array bits and header cards."""
    jd, jh = jax_read_fits(path)
    pd, ph = port_fits.read_fits(path)
    assert pd.dtype == jd.dtype and pd.shape == jd.shape
    np.testing.assert_array_equal(pd, jd)
    assert ph.cards == jh.cards
    return pd


def test_plain_fits_written_by_jax_reads_identically(tmp_path, decoder):
    header = jax_observer_header(5.0, 45.0, 215.0, datetime(2012, 8, 23, 6), 24, 193.0)
    for dtype in (np.float32, np.int16, np.float64):
        path = str(tmp_path / f'plain_{np.dtype(dtype).name}.fits')
        jax_write_fits(path, _image().astype(dtype), header)
        data = _same_read(path)
        np.testing.assert_array_equal(data, _image().astype(dtype))
    # and a file the port writes reads identically in JAX
    path = str(tmp_path / 'port.fits')
    port_fits.write_fits(path, _image(), observer_header(5.0, 45.0, 215.0,
                                                         datetime(2012, 8, 23, 6), 24, 193.0))
    _same_read(path)
    assert parse_observer(port_fits.read_fits(path)[1]).wavelength == 193.0


@pytest.mark.parametrize('zcmptype,bytepix', [('RICE_1', 2), ('RICE_1', 4), ('GZIP_1', 2)])
def test_tile_compressed_fits_read_identically(tmp_path, decoder, zcmptype, bytepix):
    rng = np.random.default_rng(3)
    dtype = np.int16 if bytepix == 2 else np.int32
    image = rng.integers(-3000, 3000, size=(40, 33)).astype(dtype)
    path = str(tmp_path / f'{zcmptype}_{bytepix}.fits')
    write_tile_compressed(path, image, zcmptype=zcmptype, bytepix=bytepix)
    data = _same_read(path)
    np.testing.assert_array_equal(data, image)


def test_quantized_float_rice_reads_identically(tmp_path, decoder):
    path = str(tmp_path / 'quantized.fits')
    write_tile_compressed(path, _image((32, 32), seed=5), zcmptype='RICE_1', quantize=16)
    _same_read(path)


def test_native_and_python_rice_decoders_agree():
    from sunerf_tpu.native import rice_decode as jax_rice_decode
    from test_fits_compressed import rice_compress
    rng = np.random.default_rng(9)
    pixels = np.cumsum(rng.integers(-40, 40, size=4096)).astype(np.int32)
    buf = rice_compress(pixels, bytepix=4)
    assert native.decoder() == 'native'
    fast = native.rice_decode(buf, pixels.size, 4)
    slow = native._rice_decode_py(buf, pixels.size, 4, 32)
    np.testing.assert_array_equal(fast, pixels)
    np.testing.assert_array_equal(slow, pixels)
    np.testing.assert_array_equal(jax_rice_decode(buf, pixels.size, 4), pixels)


# ------------------------------------------------ the single-channel pipeline

@pytest.fixture(scope='module')
def views(tmp_path_factory):
    """JAX's SimpleStar renders at 16x16, 8 observers (tests/test_end_to_end.py's
    closed-loop set), written as FITS."""
    tmp = tmp_path_factory.mktemp('views')
    observers = [{'name': 'aia', 'lat': 5.0 * ((i % 3) - 1), 'lon': i * 45.0,
                  'distance': 215.0, 'time': datetime(2012, 8, 20 + i).isoformat()}
                 for i in range(8)]
    render_observers({'model': 'SimpleStar', 'render_path': str(tmp / 'renders'),
                      'render_format': ['fits'], 'resolution': 16, 'wavelengths': [193],
                      'batch_size': 256, 'pixel_intensity_factor': 1e9,
                      'observers': observers})
    return tmp, str(tmp / 'renders' / 'aia' / '193' / '*.fits')


def test_build_single_channel_data_matches_jax(views, tmp_path):
    _, pattern = views
    jd = jax_build(pattern, str(tmp_path / 'jax'), batch_size=128, n_workers=1)
    pd = build_single_channel_data(pattern, str(tmp_path / 'port'), batch_size=128,
                                   n_workers=1)
    assert len(pd.train) == len(jd.train) >= 10
    assert pd.config == jd.config
    assert pd.validation_shape == jd.validation_shape == (16, 16)
    assert pd.ref_time == jd.ref_time
    for k in ('rays', 'time', 'target_image'):
        np.testing.assert_array_equal(pd.valid.arrays[k], jd.valid.arrays[k])
        full_p = np.load(pd.train.batch_files[k])
        full_j = np.load(jd.train.batch_files[k])
        assert full_p.dtype == full_j.dtype
        np.testing.assert_array_equal(full_p, full_j)
    np.testing.assert_array_equal(np.load(pd.extras['dataset_ids_path']),
                                  np.load(jd.extras['dataset_ids_path']))
    # the same batches in the same order for the same seed, over an epoch
    jb, pb = jax_iterate_batches(jd.train, seed=7), iterate_batches(pd.train, seed=7)
    for _ in range(len(pd.train) + 2):
        a, b = next(jb), next(pb)
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_loader_workers_match_one_process(views, tmp_path):
    """Two spawned worker processes (each with the default SIGTERM) give the
    same arrays as one process."""
    _, pattern = views
    one = build_single_channel_data(pattern, str(tmp_path / 'one'), n_workers=1)
    two = build_single_channel_data(pattern, str(tmp_path / 'two'), n_workers=2)
    for k in ('rays', 'time', 'target_image'):
        np.testing.assert_array_equal(np.load(one.train.batch_files[k]),
                                      np.load(two.train.batch_files[k]))


def test_loader_workers_default_in_process(monkeypatch, views, tmp_path):
    """Both builders load FITS in process unless asked for workers (no pool
    is made), and the probe that measures a worker's cost runs on the CPU
    (one worker: in process)."""
    import inspect
    from sunerf_tpu_torch.data import loaders
    from sunerf_tpu_torch.scripts import probe_loader_workers
    for fn in (loaders.build_single_channel_data, loaders.build_multi_thermal_data):
        assert inspect.signature(fn).parameters['n_workers'].default == 1
    import multiprocessing
    monkeypatch.setattr(multiprocessing, 'get_context', lambda *a: pytest.fail('a pool'))
    _, pattern = views
    build_single_channel_data(pattern, str(tmp_path / 'one'))
    row = probe_loader_workers.main(['--maps', '2', '--resolution', '32', '--small-maps', '2',
                                     '--small-resolution', '16', '--workers', '1',
                                     '--workdir', str(tmp_path)])
    assert row['sets']['real']['maps'] == 2 and row['workers'] == 1
    assert all(np.isfinite(v) for v in (row['start_s'], row['read_mib_s'],
                                        row['break_even_mib']))


def test_map_stack_and_instrument_tree(views, tmp_path):
    tmp, pattern = views
    import glob
    files = sorted(glob.glob(pattern))[:3]
    stack = load_map_stack(files, apply_norm=True)
    from sunerf_tpu.data.loaders import load_map_stack as jax_load_map_stack
    np.testing.assert_array_equal(stack, jax_load_map_stack(files, apply_norm=True))
    # maps at another resolution are resampled (data/prep.resample), as JAX's
    np.testing.assert_array_equal(load_map_stack(files, resolution=8, apply_norm=True),
                                  jax_load_map_stack(files, resolution=8, apply_norm=True))
    from sunerf_tpu.data.loaders import scan_instrument_tree as jax_scan
    tree, jtree = scan_instrument_tree(str(tmp / 'renders')), jax_scan(str(tmp / 'renders'))
    np.testing.assert_array_equal(tree['all_wavelengths'], jtree['all_wavelengths'])
    assert tree['sources']['aia']['file_stacks'] == jtree['sources']['aia']['file_stacks']
    assert date_from_filename('aia_2012-08-23T06:00:00.193.fits') == datetime(2012, 8, 23, 6)


# --------------------------------------------------------------------- CLI

def test_run_emission_cli_both_packages(views, tmp_path, monkeypatch):
    """Both run_emission.main on one tiny config (2x32 fields, 8 + 8
    samples, 20 steps; the drift probe, on by default, is off here and held
    in tests/test_torch_trainer.py): each logs its steps and writes save_state,
    save_state_best and save_state_ema, and each package's bundle loads in
    the other's loader. The port runs with --device cpu."""
    from sunerf_tpu.evaluation.loader import SuNeRFLoader as JaxLoader
    from sunerf_tpu.run_emission import main as jax_main
    from sunerf_tpu_torch.run_emission import main
    _, pattern = views
    runs = {}
    for name in ('jax', 'port'):
        workdir = str(tmp_path / name)
        config = {'path_to_save': workdir,
                  'data': {'data_path': pattern, 'batch_size': 16},
                  'model': {'n_layers': 2, 'd_filter': 32},
                  'rendering': {'n_stratified': 8, 'n_hierarchical': 8},
                  'image_scaling': {'vmax': 10.0},
                  'optimizer': {'lr_start': 1e-3, 'lr_floor': 1e-3},
                  'training': {'total_steps': 20, 'log_every_n_steps': 10,
                               'scalar_log_every': 5, 'keep_best': True,
                               'ema_decay': 0.9, 'drift_probe_views': 0}}
        path = str(tmp_path / f'{name}.yaml')
        with open(path, 'w') as f:
            yaml.safe_dump(config, f)
        if name == 'jax':
            # JAX's CLI points its compilation cache at a directory of its
            # own; nothing is written there while the cache is off. Its
            # loader takes one process (os.cpu_count 1: it forks otherwise,
            # and its forked workers keep whatever SIGTERM handler this
            # process has), and its fit leaves its SIGTERM handler
            # installed, so the process's own is put back after it.
            cache = jax.config.jax_enable_compilation_cache
            jax.config.update('jax_enable_compilation_cache', False)
            monkeypatch.setattr(os, 'cpu_count', lambda: 1)
            handler = signal.signal(signal.SIGTERM, signal.SIG_DFL)
            try:
                jax_main(['--config', path])
            finally:
                signal.signal(signal.SIGTERM, handler)
                monkeypatch.undo()
                jax.config.update('jax_enable_compilation_cache', cache)
        else:
            # the loader of either package takes one process when
            # os.cpu_count is 1
            monkeypatch.setattr(os, 'cpu_count', lambda: 1)
            try:
                main(['--config', path, '--device', 'cpu'])
            finally:
                monkeypatch.undo()
        with open(os.path.join(workdir, 'metrics.jsonl')) as f:
            runs[name] = [json.loads(line) for line in f]
        for bundle in ('save_state', 'save_state_best', 'save_state_ema'):
            assert os.path.exists(os.path.join(workdir, bundle + '.npz')), (name, bundle)
    for name, recs in runs.items():
        assert [r['step'] for r in recs if 'loss' in r] == [5, 10, 15, 20], name
        assert sorted(r['step'] for r in recs if 'val_psnr' in r) == [0, 10, 20], name
        assert all(np.isfinite(r['loss']) for r in recs if 'loss' in r), name
    view = dict(lat=0.3, lon=1.0, time=0.0, distance=215.0, resolution=8)
    port_in_jax = JaxLoader(str(tmp_path / 'port' / 'save_state'), batch_size=64)
    jax_in_port = SuNeRFLoader(str(tmp_path / 'jax' / 'save_state'), batch_size=64,
                               device='cpu')
    for loader in (port_in_jax, jax_in_port):
        assert np.isfinite(loader.render_observer_image(**view).image).all()
    params, config = jax_load_state(str(tmp_path / 'port' / 'save_state'))
    assert config['type'] == 'emission' and params['fine']['w_in'].shape == (84, 32)


def test_run_emission_refuses_microbatch(tmp_path, views, monkeypatch):
    """training.microbatch is ported (this test refused it before): the CLI
    under torchrun's environment makes a one-rank mesh (gloo on the CPU),
    trains two steps of two 8-ray chunks and leaves no process group
    behind; a microbatch above the per-rank batch raises."""
    import socket
    from sunerf_tpu_torch.run_emission import main
    _, pattern = views
    monkeypatch.setattr(os, 'cpu_count', lambda: 1)
    for microbatch in (8, 32):
        with socket.socket() as s:
            s.bind(('127.0.0.1', 0))
            port = s.getsockname()[1]
        for k, v in dict(RANK='0', WORLD_SIZE='1', LOCAL_RANK='0', MASTER_ADDR='127.0.0.1',
                         MASTER_PORT=str(port)).items():
            monkeypatch.setenv(k, v)
        workdir = str(tmp_path / f'mb{microbatch}')
        path = str(tmp_path / f'mb{microbatch}.yaml')
        with open(path, 'w') as f:
            yaml.safe_dump({'path_to_save': workdir,
                            'data': {'data_path': pattern, 'batch_size': 16},
                            'model': {'n_layers': 2, 'd_filter': 32},
                            'rendering': {'n_stratified': 8, 'n_hierarchical': 8},
                            'training': {'total_steps': 2, 'log_every_n_steps': 2,
                                         'scalar_log_every': 1, 'drift_probe_views': 0,
                                         'microbatch': microbatch}}, f)
        if microbatch > 16:
            with pytest.raises(ValueError, match='smaller than microbatch'):
                main(['--config', path, '--device', 'cpu'])
        else:
            trainer = main(['--config', path, '--device', 'cpu'])
            assert trainer.mesh.size == 1 and trainer.state.step == 2
            with open(os.path.join(workdir, 'metrics.jsonl')) as f:
                losses = [json.loads(line)['loss'] for line in f if '"loss"' in line]
            assert len(losses) == 2 and np.isfinite(losses).all()
        assert not torch.distributed.is_initialized()
