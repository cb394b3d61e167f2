"""The spike-guard demo, the reprojection baseline, the real-data rehearsal
and the two capacity probes on the port (sunerf_tpu_torch/scripts/
spike_guard_demo.py, reprojection_baseline_psi.py, real_data_rehearsal.py,
probe_grid_capacity.py, probe_temporal_capacity.py) against the JAX
package's scripts on the CPU:

  * spike_guard_demo: both packages' main with their Trainer runs recorded
    instead of made (run replaced; the renders and data loading replaced
    too): the same runs, steps, seed and guards in the same order; the
    port's main at 2 steps / 8^2 (its system narrowed to 2x32, 8 + 8
    samples), its row holding JAX's keys and when each arm tripped;
  * reprojection_baseline_psi on the port's psi_193 scene at 16^2: both
    packages' rows, the per-view scores within 1e-6 relative and the lats
    and files equal. Not bit for bit: the asinh scaling is jnp.arcsinh in
    JAX and torch.asinh in the port, which differ in the last bit on ~3% of
    pixels (the reprojected maps themselves are held bit for bit in
    tests/test_torch_eval.py);
  * real_data_rehearsal: the port's own tile-compressed writer byte for
    byte against tests/test_fits_compressed.py's (RICE_1 int16 and int32,
    GZIP_1, quantized floats with and without SUBTRACTIVE_DITHER_1 / _2,
    the dither truth arrays equal), jsocify's files byte for byte against
    the JAX script's on the same render, and the port's main at 2 steps /
    16^2 (2x32, 8 + 8 samples): prep's compress / decode error under JAX's 5e-3, a finite row
    with JAX's keys;
  * the capacity probes: the targets against JAX's on the same 100,000
    points within 2e-6 of max (XLA's exp, log1p, arccos and atan2 differ
    from torch's in the last bits, up to 5e-7 of max here), the configs
    label by label and field by field against those JAX's main builds (its
    fits replaced), the table recipe's parameter groups, and each port
    main at 2 steps with JAX's keys.
"""
import glob
import io
import json
import os
import sys
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest
import torch

from sunerf_tpu_torch.scripts import (probe_grid_capacity, probe_temporal_capacity,
                                      real_data_rehearsal, reprojection_baseline_psi,
                                      spike_guard_demo)

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]


def _jax_script(name):
    sys.path.insert(0, str(REPO / 'scripts'))
    try:
        sys.modules.pop(name, None)
        return __import__(name)
    finally:
        sys.path.remove(str(REPO / 'scripts'))


@pytest.fixture
def small_system(monkeypatch):
    """The port's emission systems at 2x32 and 8 + 8 samples (the scripts'
    own recipes train the 8x512 field at 40 + 80 or 64 + 128, minutes on
    one CPU thread)."""
    from sunerf_tpu_torch import systems
    from sunerf_tpu_torch.models.fields import emission_config
    make = systems.make_emission_system

    def small(*a, **kw):
        kw.update(model_config=emission_config(n_layers=2, d_filter=32), n_stratified=8,
                  n_hierarchical=8)
        return make(*a, **kw)
    monkeypatch.setattr(systems, 'make_emission_system', small)


def _run_jax(module, name, argv, mp) -> str:
    import jax
    mp.setattr(jax.config, 'update', lambda *a: None)   # no host compile cache
    mp.setattr(sys, 'argv', [f'{name}.py', *argv])
    buf = io.StringIO()
    with redirect_stdout(buf):
        module.main()
    return buf.getvalue()


# ------------------------------------------------------------ spike_guard_demo

def test_spike_guard_demo_runs_the_jax_arms(monkeypatch, tmp_path):
    import sunerf_tpu.data.loaders as jax_loaders
    import sunerf_tpu.evaluation.image_render as jax_render
    import sunerf_tpu_torch.data.loaders as port_loaders
    import sunerf_tpu_torch.evaluation.image_render as port_render
    calls = {'jax': [], 'port': []}

    def recorder(side):
        def run(name, data, workdir, steps, seed, spike_guard, *device):
            calls[side].append((name, steps, seed, spike_guard))
            return {'name': name}
        return run
    jax_demo = _jax_script('spike_guard_demo')
    renders = {}
    for side, render, loaders, module in (('jax', jax_render, jax_loaders, jax_demo),
                                          ('port', port_render, port_loaders,
                                           spike_guard_demo)):
        monkeypatch.setattr(render, 'render_observers',
                            lambda cfg, device=None, s=side: renders.setdefault(s, cfg))
        monkeypatch.setattr(loaders, 'build_single_channel_data', lambda *a, **k: None)
        monkeypatch.setattr(module, 'run', recorder(side))
    jax_out = json.loads(_run_jax(jax_demo, 'spike_guard_demo',
                                  ['--steps', '40', '--seed', '3', '--resolution', '32'],
                                  monkeypatch).strip().splitlines()[-1])
    out = spike_guard_demo.main(['--steps', '40', '--seed', '3', '--resolution', '32',
                                 '--device', 'cpu', '--workdir', str(tmp_path)])
    assert calls['port'] == calls['jax'] == [('unguarded', 40, 3, None),
                                             ('guarded', 40, 3, 10.0)]
    assert set(out) - {'launches'} == set(jax_out)
    jr, pr = dict(renders['jax']), dict(renders['port'])
    for r in (jr, pr):
        r.pop('render_path')
    assert pr == jr


def test_spike_guard_demo_row_on_the_cpu(tmp_path, small_system):
    out = spike_guard_demo.main(['--steps', '2', '--resolution', '8', '--device', 'cpu',
                                 '--workdir', str(tmp_path)])
    jax_keys = {'name', 'val_psnr', 'val_ssim', 'max_logged_loss', 'logged_skip_steps'}
    for arm in ('unguarded', 'guarded'):
        row = out[arm]
        assert jax_keys <= set(row) and row['name'] == arm
        assert np.isfinite(row['val_psnr']) and np.isfinite(row['max_logged_loss'])
        assert row['tripped'] == (row['trips'] > 0)
        assert (row['first_trip_by_step'] is None) == (not row['tripped'])
    assert out['unguarded']['trips'] == 0 and out['launches'] == {}


# ------------------------------------------------------------ reprojection

def test_reprojection_row_matches_jax(tmp_path, monkeypatch):
    from sunerf_tpu_torch.scripts import psi_protocol
    train_dir, gt_dir = psi_protocol.ensure_scene(str(tmp_path / 'scene'), 16, device='cpu')
    argv = ['--train', os.path.join(train_dir, '*.fits'), '--gt',
            os.path.join(gt_dir, '*.fits'), '--shape-out', '64', '128']
    jax_out = str(tmp_path / 'jax.json')
    _run_jax(_jax_script('reprojection_baseline_psi'), 'reprojection_baseline_psi',
             [*argv, '--out', jax_out], monkeypatch)
    with open(jax_out) as f:
        want = json.load(f)
    got = reprojection_baseline_psi.main([*argv, '--out', str(tmp_path / 'port.json')])
    assert set(got) == set(want) and got['n_train_maps'] == want['n_train_maps'] == 14
    assert got['shape_out'] == want['shape_out']
    assert len(got['views']) == len(want['views']) == 18
    for g, w in zip(got['views'], want['views']):
        assert g['file'] == w['file'] and g['lat_deg'] == w['lat_deg']
        for k in ('psnr', 'ssim', 'mae_percent', 'me_percent'):
            assert abs(g[k] - w[k]) <= 1e-6 * max(abs(w[k]), 1.0), (k, g[k], w[k])
    for split in ('train', 'test'):
        assert set(got[split]) == set(want[split]) and got[split]
    # the default scene is the port's psi_193 cache
    assert reprojection_baseline_psi.SCENE.endswith('psi_scene_cache')


# ------------------------------------------------------------ real_data_rehearsal

def _jax_writer():
    sys.path.insert(0, str(REPO / 'tests'))
    try:
        import test_fits_compressed
        return test_fits_compressed
    finally:
        sys.path.remove(str(REPO / 'tests'))


@pytest.mark.parametrize('case', ['int16', 'int32_tiles', 'gzip', 'float', 'dither1',
                                  'dither2'])
def test_tile_compressed_writer_matches_the_jax_tests_byte_for_byte(tmp_path, case):
    jax_writer = _jax_writer()
    rng = np.random.default_rng(3)
    image16 = rng.normal(1000, 40, (37, 64)).astype(np.int16)
    image16[5:9, 10:30] = 12000
    img_f = rng.normal(100.0, 20.0, (33, 40)).astype(np.float32)
    img_f[3, 5] = 0.0
    img_f[7, 9] = np.nan
    kwargs = {'int16': (image16, dict(extra_cards=(('WAVELNTH', 193), ('BZERO', 0)))),
              'int32_tiles': (image16.astype(np.int32), dict(bytepix=4, tile_rows=7)),
              'gzip': (rng.integers(-500, 4000, (16, 24)).astype(np.int32),
                       dict(zcmptype='GZIP_1', tile_rows=4)),
              'float': (img_f, dict(tile_rows=5, quantize=0.25)),
              'dither1': (img_f, dict(tile_rows=4, quantize=0.3,
                                      dither='SUBTRACTIVE_DITHER_1', zdither0=17)),
              'dither2': (img_f, dict(tile_rows=16, quantize=0.5,
                                      dither='SUBTRACTIVE_DITHER_2', zdither0=4242,
                                      extra_cards=(('QUALITY', 0), ('LVL_NUM', 1.5),
                                                   ('ORIGIN', 'SDO/JSOC-SDP'))))}[case]
    image, kw = kwargs
    a, b = str(tmp_path / 'jax.fits'), str(tmp_path / 'port.fits')
    truth_j = jax_writer.write_tile_compressed(a, image, **kw)
    truth_p = real_data_rehearsal.write_tile_compressed(b, image, **kw)
    assert Path(a).read_bytes() == Path(b).read_bytes()
    if truth_j is None:
        assert truth_p is None
    else:
        np.testing.assert_array_equal(truth_p, truth_j)


def test_jsocify_matches_jax(tmp_path, monkeypatch):
    """The same SimpleStar render re-packaged by both packages' jsocify:
    the same bytes."""
    from sunerf_tpu_torch.evaluation.image_render import render_observers
    render_observers({'model': 'SimpleStar', 'render_path': str(tmp_path / 'r'),
                      'render_format': ['fits'], 'resolution': 16, 'wavelengths': [193],
                      'batch_size': 4096, 'pixel_intensity_factor': 1e9,
                      'observers': [{'name': 'aia', 'lat': 5.0, 'lon': 45.0,
                                     'distance': 215.0, 'time': '2014-01-15T00:00:00'}]},
                     device='cpu')
    src = sorted(glob.glob(str(tmp_path / 'r' / 'aia' / '193' / '*.fits')))[0]
    monkeypatch.syspath_prepend(str(REPO / 'tests'))
    jax_rehearsal = _jax_script('real_data_rehearsal')
    a = jax_rehearsal.jsocify(src, str(tmp_path / 'jax'))
    b = real_data_rehearsal.jsocify(src, str(tmp_path / 'port'))
    assert Path(a).read_bytes() == Path(b).read_bytes()


def test_real_data_rehearsal_row_on_the_cpu(tmp_path, small_system):
    out = real_data_rehearsal.main(['--steps', '2', '--resolution', '16', '--device', 'cpu',
                                    '--workdir', str(tmp_path)])
    assert {'rehearsal', 'n_files', 'steps', 'pipeline', 'workdir'} <= set(out)
    assert out['n_files'] == 8 and out['steps'] == 2 and out['quant_err'] < 5e-3
    row = out['rehearsal']
    assert np.isfinite(row['val_psnr']) and row['rays_per_sec'] > 0
    assert out['launches'] == {}


# ------------------------------------------------------------ capacity probes

@pytest.fixture(scope='module')
def points():
    rng = np.random.default_rng(0)
    pts = rng.uniform(-1.3, 1.3, (100000, 4)).astype(np.float32)
    pts[:, 3] = rng.uniform(0, 1, 100000)
    return pts


@pytest.mark.parametrize('which', ['grid', 'temporal', 'temporal_fast'])
def test_capacity_targets_match_jax(points, which):
    import jax.numpy as jnp
    if which == 'grid':
        jf = _jax_script('probe_grid_capacity').target_field
        pf = probe_grid_capacity.target_field
    else:
        kw = dict(drift=2.0, amp_cycles=1.5) if which == 'temporal_fast' else {}
        j = _jax_script('probe_temporal_capacity')
        jf = lambda p: j.target_field_t(p, **kw)   # noqa: E731
        pf = lambda p: probe_temporal_capacity.target_field_t(p, **kw)   # noqa: E731
    want = np.asarray(jf(jnp.asarray(points)))
    got = pf(torch.from_numpy(points)).numpy()
    assert got.dtype == want.dtype == np.float32
    assert np.max(np.abs(got - want)) <= 2e-6 * np.max(np.abs(want))
    # both sides' shell: -2 outside 1 <= r <= 1.3
    np.testing.assert_array_equal(got == -2.0, want == -2.0)


@pytest.mark.parametrize('name,port', [('probe_grid_capacity', probe_grid_capacity),
                                       ('probe_temporal_capacity', probe_temporal_capacity)])
def test_capacity_configs_match_jax(monkeypatch, name, port):
    """The configs JAX's main builds (its training replaced by the identity,
    its held-out MSE kept) label by label and field by field, and the keys
    of its rows, against the port's."""
    import jax

    import sunerf_tpu.models.fields as jax_fields
    built = []
    original = jax_fields.emission_config

    def record(**kw):
        built.append(kw)
        return original(**kw)
    monkeypatch.setattr(jax_fields, 'emission_config', record)
    import optax  # noqa: F401  (imported before jax.jit is replaced: it jits at import)
    jit = jax.jit
    monkeypatch.setattr(jax, 'jit', lambda f, **kw: (
        (lambda p, s, key: (p, s, np.float32(0.0))) if f.__name__ == 'step' else jit(f, **kw)))
    out = _run_jax(_jax_script(name), name, ['--steps', '1', '--batch', '8'], monkeypatch)
    rows = [json.loads(line) for line in out.strip().splitlines()]
    labels = [next(iter(r)) for r in rows[:-1]]
    assert labels == [label for label, _ in port.CONFIGS]
    assert built == [kw for _, kw in port.CONFIGS]
    got = port.main(['--steps', '2', '--batch', '8', '--device', 'cpu'])
    assert set(got) == set(rows[-1])
    for label in labels:
        assert set(got[label]) == set(rows[-1][label])
        assert all(np.isfinite(v) for v in got[label].values())


def test_table_recipe_parameter_groups():
    """optax.multi_transform's 'table' label: the grid_ keys at lr x mult,
    the rest at lr, one eps."""
    from sunerf_tpu_torch.models.fields import emission_config, init_nerf
    cfg = emission_config(n_layers=2, d_filter=16, grid_sizes=(8,), grid_rank=4,
                          grid_time=2, grid_time_range=(0.0, 1.0), grid_bound=1.3)
    params = init_nerf(torch.Generator().manual_seed(0), cfg, 'cpu')
    adam = probe_grid_capacity.make_adam(params, 1e-3, 1e-15, 10.0)
    (mlp, table) = adam.param_groups
    assert mlp['lr'] == 1e-3 and table['lr'] == pytest.approx(1e-2)
    assert adam.defaults['eps'] == 1e-15
    ids = {id(v): k for k, v in params.items()}
    assert {ids[id(p)] for p in table['params']} == {k for k in params
                                                     if k.startswith('grid_')}
    assert all(not ids[id(p)].startswith('grid_') for p in mlp['params'])
