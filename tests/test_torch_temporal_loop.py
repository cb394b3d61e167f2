"""The time-dependent closed loop and its re-scoring on the port
(sunerf_tpu_torch/scripts/temporal_closed_loop.py, recover_temporal_score.py)
against the JAX package's scripts on the CPU.

One module fixture runs both packages' temporal_closed_loop main at 2x32
(emission_config patched in both packages), 2 frames x 2 views, 8 + 8
samples, 2 steps, 16^2 (the JAX side through sys.argv with
jax.config.update stubbed, so it keeps no host compile cache; the port's
cubes written without h5py). Then:

  * synth_cubes: the same arrays bit for bit and byte-identical .h5 files
    (the port's numpy writer and h5py's), at both drifts; view_list equal;
  * the rows: the same keys (the port's adds launches by kernel name), the
    same config fields, finite scores;
  * recover_temporal_score on the port's own workdir: the loop's numbers
    exactly (the same scoring tail on the saved bundle);
  * recover_temporal_score on the workdir JAX's script wrote (its bundle
    read with no transposes): each score within 2x JAX's own jitted-to-
    op-by-op gap (JAX's recover script run both ways; the bound
    tests/test_torch_dt_protocol.py uses for renders) plus the psi
    protocol's score tolerances (PSNR 0.05 dB, SSIM 2e-3:
    tests/test_torch_psi_protocol.py), the rounding of the printed row
    (0.01 dB, 1e-4) included.
"""
import functools
import io
import json
import os
import signal
import sys
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest
import torch

from sunerf_tpu_torch.data import psi_io
from sunerf_tpu_torch.scripts import recover_temporal_score, temporal_closed_loop

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
FLAGS = ['--frames', '2', '--views', '2', '--steps', '2', '--resolution', '16',
         '--n-stratified', '8', '--n-hierarchical', '8']
CONFIG_KEYS = ('frames', 'views_per_time', 'steps', 'drift', 'amp_max', 'budget')
SCORES = {'temporal_psnr': 0.05 + 0.01, 'temporal_psnr_min': 0.05 + 0.01,
          'temporal_ssim': 2e-3 + 1e-4}


def _jax_script(name):
    sys.path.insert(0, str(REPO / 'scripts'))
    try:
        sys.modules.pop(name, None)
        return __import__(name)
    finally:
        sys.path.remove(str(REPO / 'scripts'))


def _narrow(module):
    """A wrapper of `module`.emission_config at 2 x 32."""
    original = module.emission_config
    return lambda **kw: original(**{'n_layers': 2, 'd_filter': 32, **kw})


def _jax_main(name, argv, disable_jit=False) -> dict:
    import jax
    script = _jax_script(name)
    handler = signal.getsignal(signal.SIGTERM)
    buf = io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.config, 'update', lambda *a: None)   # no host compile cache
        mp.setattr(sys, 'argv', [f'{name}.py', *argv])
        try:
            with redirect_stdout(buf):
                if disable_jit:
                    with jax.disable_jit():
                        script.main()
                else:
                    script.main()
        finally:
            signal.signal(signal.SIGTERM, handler)   # JAX's fit leaves its own
    return json.loads(buf.getvalue().strip().splitlines()[-1])


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    """(port row, JAX row): both packages' loops at 2x32."""
    import sunerf_tpu.data.loaders as jax_loaders
    import sunerf_tpu.models.fields as jax_fields
    import sunerf_tpu_torch.models.fields as port_fields
    tmp = tmp_path_factory.mktemp('temporal_loop')
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_fields, 'emission_config', _narrow(jax_fields))
        # JAX's loader reads in process (its pool forks, which a process
        # holding torch's and JAX's threads should not); the same arrays
        mp.setattr(jax_loaders, 'build_single_channel_data',
                   functools.partial(jax_loaders.build_single_channel_data, n_workers=1))
        mp.setattr(port_fields, 'emission_config', _narrow(port_fields))
        jax_row = _jax_main('temporal_closed_loop', [*FLAGS, '--workdir', str(tmp / 'jax')])
        mp.setattr(psi_io, 'h5py', None)
        row = temporal_closed_loop.main([*FLAGS, '--device', 'cpu',
                                         '--workdir', str(tmp / 'port')])
    return row, jax_row


@pytest.mark.parametrize('drift', [0.5, 2.0])
def test_synth_cubes_match_jax(tmp_path, monkeypatch, drift):
    jax_loop = _jax_script('temporal_closed_loop')
    jax_loop.synth_cubes(str(tmp_path / 'jax'), 3, drift=drift)
    temporal_closed_loop.synth_cubes(str(tmp_path / 'h5py'), 3, drift=drift)
    monkeypatch.setattr(psi_io, 'h5py', None)
    temporal_closed_loop.synth_cubes(str(tmp_path / 'numpy'), 3, drift=drift)
    for f in range(3):
        for var in ('rho', 't'):
            name = os.path.join(var, f'{var}00{100 + f}.h5')
            want = (tmp_path / 'jax' / name).read_bytes()
            assert (tmp_path / 'h5py' / name).read_bytes() == want
            assert (tmp_path / 'numpy' / name).read_bytes() == want
            *_, jcube = psi_io.rdhdf_3d(str(tmp_path / 'jax' / name))
            *_, pcube = psi_io.rdhdf_3d(str(tmp_path / 'numpy' / name))
            np.testing.assert_array_equal(pcube, jcube)


def test_view_list_matches_jax():
    jax_loop = _jax_script('temporal_closed_loop')
    times = [0.0, 0.25, 1.0]
    assert temporal_closed_loop.view_list(10, times) == jax_loop.view_list(10, times)
    assert temporal_closed_loop.view_list(3, [0.5], 'euvi') == jax_loop.view_list(3, [0.5],
                                                                                  'euvi')


def test_loop_row_matches_jax_keys_and_config(runs):
    row, jax_row = runs
    assert set(row) - {'launches'} == set(jax_row)
    for k in CONFIG_KEYS:
        assert row[k] == jax_row[k], k
    assert row['n_eval_views'] == jax_row['n_eval_views'] == 2
    for k in ('rays_per_sec', 'spatial_val_psnr', 'spatial_val_ssim', *SCORES):
        assert np.isfinite(row[k]), k
    assert row['launches'] == {}          # the CPU launches nothing


def test_recover_replays_the_loop_on_its_own_workdir(runs):
    row, _ = runs
    got = recover_temporal_score.main([row['workdir'], '--device', 'cpu'])
    assert got['recovered'] is True
    for k in ('steps', 'budget', 'rays_per_sec', 'spatial_val_psnr', 'spatial_val_ssim',
              'n_eval_views', *SCORES):
        assert got[k] == row[k], k


def test_recover_scores_a_jax_workdir_within_its_jit_gap(runs):
    """The port's recover_temporal_score on JAX's workdir against JAX's own
    recover script, jitted (the loop's scoring) and op by op."""
    _, jax_row = runs
    workdir = jax_row['workdir']
    jitted = _jax_main('recover_temporal_score', [workdir])
    op_by_op = _jax_main('recover_temporal_score', [workdir], disable_jit=True)
    got = recover_temporal_score.main([workdir, '--device', 'cpu'])
    assert set(got) - {'launches'} == set(jitted)
    for k in ('frames', 'steps', 'budget', 'rays_per_sec', 'spatial_val_psnr',
              'spatial_val_ssim', 'n_eval_views'):
        assert got[k] == jitted[k], k
    for k, tol in SCORES.items():
        assert jitted[k] == jax_row[k], k
        gap = abs(jitted[k] - op_by_op[k])
        assert abs(got[k] - jitted[k]) <= 2 * gap + tol, (k, got[k], jitted[k], gap)
