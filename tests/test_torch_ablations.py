"""The first four ablations on the port (sunerf_tpu_torch/scripts/
dt_ablation.py, occupancy_ablation.py, occupancy_value_case.py,
eval_budget_sweep.py) against the JAX package's scripts on the CPU:

  * synth_blob_cube: the same arrays bit for bit and byte-identical .h5
    files (the port's numpy writer and h5py's);
  * each ablation's variants: both packages' main run with their Trainer
    runs recorded instead of made (run_variant replaced; the scene
    synthesis and data loading replaced too), the same variant names,
    steps, seeds, spike guards and system keywords in the same order (the
    field configs compared field by field), for every mode of
    occupancy_ablation (A/B, --control, --matrix, --tiers);
  * eval_budget_sweep: a 2x32 emission bundle with a 2x32 proposal field
    (16 + 16 samples, written by the JAX package) listed in a one-row
    matrix, re-scored at 32 + 24 by both packages on two ground-truth views
    at a 3 Rs observer: the rows' configs equal, every metric within 1e-5
    relative of JAX's (tests/test_torch_eval.py's CLI tolerance there).
"""
import dataclasses
import json
import os
import sys
from datetime import datetime
from pathlib import Path

import numpy as np
import pytest
import torch

from sunerf_tpu_torch.data import psi_io
from sunerf_tpu_torch.scripts import (dt_ablation, eval_budget_sweep, occupancy_ablation,
                                      occupancy_value_case)

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
def no_jax_cache(monkeypatch):
    import jax
    monkeypatch.setattr(jax.config, 'update', lambda *a: None)


def test_synth_blob_cube_matches_jax(tmp_path, monkeypatch):
    jax_value = _jax_script('occupancy_value_case')
    jax_value.synth_blob_cube(str(tmp_path / 'jax'))
    occupancy_value_case.synth_blob_cube(str(tmp_path / 'h5py'))
    monkeypatch.setattr(psi_io, 'h5py', None)
    occupancy_value_case.synth_blob_cube(str(tmp_path / 'numpy'))
    for var in ('rho', 't'):
        name = os.path.join(var, f'{var}00100.h5')
        want = (tmp_path / 'jax' / name).read_bytes()
        assert (tmp_path / 'h5py' / name).read_bytes() == want
        assert (tmp_path / 'numpy' / name).read_bytes() == want
        *_, jcube = psi_io.rdhdf_3d(str(tmp_path / 'jax' / name))
        *_, pcube = psi_io.rdhdf_3d(str(tmp_path / 'numpy' / name))
        np.testing.assert_array_equal(pcube, jcube)


def _plain(value):
    """A variant keyword's value in comparable form: field configs of
    either package as their fields."""
    if dataclasses.is_dataclass(value):
        return dataclasses.asdict(value)
    return value


def _recorder(calls):
    def run_variant(name, data, workdir, steps, seed=7, spike_guard=10.0, device=None,
                    **kwargs):
        calls.append((name, steps, seed, spike_guard,
                      {k: _plain(v) for k, v in kwargs.items()}))
        # the run's log as the value case reads it (its grid-health tail)
        os.makedirs(os.path.join(workdir, name), exist_ok=True)
        with open(os.path.join(workdir, name, 'metrics.jsonl'), 'w') as f:
            f.write(json.dumps({'occ_r_frac': 0.5, 'occ_ang_frac': 0.25,
                                'occ_vol_frac': 0.125}) + '\n')
        return {'name': name, 'rays_per_sec': 1.0, 'val_psnr': 1.0, 'val_ssim': 0.5}
    return run_variant


def _stub_scene(monkeypatch, *modules):
    """Scene synthesis and data loading of both packages replaced by no-ops."""
    import sunerf_tpu.data.loaders as jax_loaders
    import sunerf_tpu.evaluation.image_render as jax_render
    import sunerf_tpu_torch.data.loaders as loaders
    import sunerf_tpu_torch.evaluation.image_render as render
    for mod in (jax_render, render):
        monkeypatch.setattr(mod, 'render_observers', lambda *a, **k: [])
    for mod in (jax_loaders, loaders):
        monkeypatch.setattr(mod, 'build_multi_thermal_data', lambda *a, **k: None)
        monkeypatch.setattr(mod, 'build_single_channel_data', lambda *a, **k: None)


def _both(monkeypatch, capsys, name, port_module, flags, tmp_path):
    """(JAX's recorded variant calls, the port's) of one main run; the
    port's printed result equal to JAX's but for the workdir."""
    jax_module = _jax_script(name)
    jax_calls, port_calls = [], []
    monkeypatch.setattr(jax_module, 'run_variant', _recorder(jax_calls))
    monkeypatch.setattr(port_module, 'run_variant', _recorder(port_calls))
    monkeypatch.setattr(sys, 'argv', [f'{name}.py', *flags, '--workdir', str(tmp_path / 'jax')])
    capsys.readouterr()
    jax_module.main()
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    got = port_module.main([*flags, '--workdir', str(tmp_path / 'port'), '--device', 'cpu'])
    capsys.readouterr()
    assert {k: v for k, v in got.items() if k != 'workdir'} == \
        {k: v for k, v in want.items() if k != 'workdir'}
    return jax_calls, port_calls


def test_dt_ablation_variants_match_jax(tmp_path, monkeypatch, capsys, no_jax_cache):
    _stub_scene(monkeypatch)
    jax_calls, port_calls = _both(monkeypatch, capsys, 'dt_ablation', dt_ablation,
                                  ['--steps', '5', '--seeds', '7', '8'], tmp_path)
    assert len(port_calls) == 12 and port_calls == jax_calls
    jax_calls, port_calls = _both(monkeypatch, capsys, 'dt_ablation', dt_ablation,
                                  ['--steps', '5', '--seeds', '9', '--configs', 'dt_proposal',
                                   'dt_grid_4x128'], tmp_path)
    assert [c[0] for c in port_calls] == ['dt_proposal_s9', 'dt_grid_4x128_s9']
    assert port_calls == jax_calls
    assert dt_ablation.WAVELENGTHS == _jax_script('dt_ablation').WAVELENGTHS


@pytest.mark.parametrize('mode', [[], ['--control'], ['--matrix'], ['--tiers'],
                                  ['--occ-stratified', '24', '--occ-hierarchical', '48',
                                   '--threshold', '0.01', '--floor', '0.05']])
def test_occupancy_ablation_variants_match_jax(mode, tmp_path, monkeypatch, capsys,
                                               no_jax_cache):
    _stub_scene(monkeypatch)
    jax_calls, port_calls = _both(monkeypatch, capsys, 'occupancy_ablation',
                                  occupancy_ablation,
                                  ['--steps', '5', '--seeds', '7', '8'] + mode, tmp_path)
    assert port_calls == jax_calls and len(port_calls) in (2, 8, 10)


def test_occupancy_value_case_variants_match_jax(tmp_path, monkeypatch, capsys, no_jax_cache):
    import sunerf_tpu.data.prep as jax_prep
    import sunerf_tpu_torch.data.prep as prep
    _stub_scene(monkeypatch)
    for mod in (jax_prep, prep):
        monkeypatch.setattr(mod, 'prep_file', lambda *a, **k: None)
    probe = np.ones((64, 64), np.float32)
    import sunerf_tpu.data.fits as jax_fits
    import sunerf_tpu_torch.data.fits as fits
    for mod in (jax_fits, fits):
        monkeypatch.setattr(mod, 'read_fits', lambda path: (probe, None))
    monkeypatch.setattr(occupancy_value_case.glob, 'glob', lambda pattern: ['probe.fits'])
    jax_calls, port_calls = _both(monkeypatch, capsys, 'occupancy_value_case',
                                  occupancy_value_case, ['--steps', '5', '--seeds', '7', '9'],
                                  tmp_path)
    assert len(port_calls) == 12 and port_calls == jax_calls
    assert all(c[3] is None for c in port_calls)
    # the cubes were written by both (the port's through its own writer)
    for side in ('jax', 'port'):
        assert (tmp_path / side / 'cubes' / 'rho' / 'rho00100.h5').exists()


@pytest.fixture(scope='module')
def matrix(tmp_path_factory):
    """A one-row matrix whose bundle has a proposal coarse field, and two
    ground-truth views at a 3 Rs observer."""
    import jax
    from sunerf_tpu.models.fields import emission_config as jax_emission_config
    from sunerf_tpu.systems import make_emission_system as jax_make_emission_system
    from sunerf_tpu.utils.checkpoint import save_state as jax_save_state
    from sunerf_tpu_torch.data.fits import Header, write_fits
    from sunerf_tpu_torch.data.wcs import observer_header
    tmp = tmp_path_factory.mktemp('budget')
    small = dict(n_layers=2, d_filter=32, n_freqs=3)
    renderer, init = jax_make_emission_system(
        model_config=jax_emission_config(**small), coarse_config=jax_emission_config(**small),
        use_fused=False, n_stratified=16, n_hierarchical=16, perturb=False)
    os.makedirs(tmp / 'run' / 'run')
    jax_save_state(str(tmp / 'run' / 'run' / 'save_state'), init(jax.random.key(5)),
                   {'renderer_spec': renderer.spec, 'ref_time': '2012-01-01T00:00:00'})
    rng = np.random.default_rng(0)
    os.makedirs(tmp / 'gt')
    for i, lat in enumerate((0.0, 20.0)):
        header = Header()
        header.update(observer_header(lat, 40.0 * i, 3.0, datetime(2012, 1, 1, 6 * i), 12,
                                      193.0))
        write_fits(str(tmp / 'gt' / f'gt_{i}.fits'),
                   rng.uniform(0, 2, (12, 12)).astype(np.float32), header)
    row = {'config': {'n_stratified': 16, 'n_hierarchical': 16, 'proposal_coarse': True,
                      'coarse_shape': [2, 32], 'steps': 1, 'tier_fraction': 0.0,
                      'tier_samples': 16, 'seed': 7},
           'test': {'psnr': 1.0}, 'rays_per_sec': 1.0, 'workdir': str(tmp / 'run')}
    skipped = dict(row, config=dict(row['config'], n_stratified=64))   # not a budget row
    (tmp / 'matrix.jsonl').write_text(json.dumps(row) + '\n' + json.dumps(skipped) + '\n')
    return tmp


def test_eval_budget_sweep_matches_jax(matrix, tmp_path, monkeypatch, capsys, no_jax_cache):
    flags = ['--matrix', str(matrix / 'matrix.jsonl'), '--gt', str(matrix / 'gt' / '*.fits'),
             '--n-stratified', '32', '--n-hierarchical', '24']
    rows = eval_budget_sweep.main(flags + ['--out', str(tmp_path / 'port.jsonl'),
                                           '--device', 'cpu'])
    monkeypatch.setattr(sys, 'argv', ['eval_budget_sweep.py', *flags,
                                      '--out', str(tmp_path / 'jax.jsonl')])
    _jax_script('eval_budget_sweep').main()
    capsys.readouterr()
    want = [json.loads(line) for line in (tmp_path / 'jax.jsonl').read_text().splitlines()]
    got = [json.loads(line) for line in (tmp_path / 'port.jsonl').read_text().splitlines()]
    assert got == rows and len(got) == len(want) == 1
    assert got[0]['config'] == want[0]['config']
    assert got[0]['config']['eval_budget'] == [32, 24]
    for split in ('train', 'test'):
        assert set(got[0][split]) == set(want[0][split])
        for k, v in want[0][split].items():
            assert np.isfinite(v) and abs(got[0][split][k] - v) <= 1e-5 * abs(v), (split, k)
    # a second run finds the row done and re-scores nothing
    assert eval_budget_sweep.main(flags + ['--out', str(tmp_path / 'port.jsonl'),
                                           '--device', 'cpu']) == []
