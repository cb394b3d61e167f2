"""The kernel and step probes on the port (sunerf_tpu_torch/scripts/
probe_kernel.py, probe_grid_kernel.py, probe_overhead.py,
probe_grid_step.py, probe_grid_encoding.py) against the JAX package's
scripts on the CPU.

Each probe's main runs on the port at tiny shapes through the kernels'
plain versions (a CPU number; no launches counted), and the JAX script's
main with its timers stubbed (utils.timing.measure_median, probe_kernel's
timeit, probe_overhead's train step), so that it reports its keys without
timing anything; probe_kernel's Pallas calls run in interpret mode on 64
points. The port's result holds JAX's keys (probe_kernel: its report
names, less the TPU tile) and, beside them, the launches by kernel name.
grid_encode, the one-hot contraction the JAX package computes outside any
Pallas kernel, is held within 1e-6 of max of JAX's at G = 8 on random
points (chunks of 64, a ragged tail included) and against the port's
8-corner gather (ops/grid_encoding.py) on the same table.
"""
import json
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from sunerf_tpu_torch.scripts import (probe_grid_encoding, probe_grid_kernel, probe_kernel,
                                      probe_overhead, probe_grid_step)

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
def jax_probe(monkeypatch, capsys):
    """run(name, argv) -> the JAX script's stdout, its timers stubbed."""
    import jax
    import jax.numpy as jnp

    import sunerf_tpu.train.step as jax_step
    import sunerf_tpu.utils.timing as jax_timing
    monkeypatch.setattr(jax.config, 'update', lambda *a: None)   # no host compile cache
    monkeypatch.setattr(jax_timing, 'measure_median', lambda fn, reps=3, **kw: 1e-3)
    monkeypatch.setattr(jax_step, 'make_train_step',
                        lambda *a, **kw: (lambda state, batch, key:
                                          (state, {'loss': jnp.zeros(())})))

    def run(name, argv, module=None):
        module = module or _jax_script(name)
        monkeypatch.setattr(sys, 'argv', [f'{name}.py', *argv])
        capsys.readouterr()
        module.main()
        return capsys.readouterr().out
    return run


def test_probe_kernel_keys(jax_probe, monkeypatch):
    import jax

    from sunerf_tpu.ops.pallas import fused_mlp as fm
    module = _jax_script('probe_kernel')
    monkeypatch.setattr(module, 'timeit', lambda fn, *a: 1e-3)
    for name in ('_fused_mlp_fwd', '_fused_mlp_stash_fwd', '_fused_mlp_stash_bwd'):
        monkeypatch.setattr(fm, name, lambda dims, tile, bwd_tile, interpret, *a,
                            _f=getattr(fm, name): _f(dims, tile, bwd_tile, True, *a))
    normal = jax.random.normal
    monkeypatch.setattr(jax.random, 'normal',
                        lambda key, shape, dtype=jax.numpy.float32:
                        normal(key, (64, *shape[1:]), dtype))
    out = jax_probe('probe_kernel', ['8'], module)
    names = [re.sub(r' \(tile=\d+\)', '', line[:32].strip()) for line in out.splitlines()]
    rows = probe_kernel.main(['--n', '64', '--reps', '1', '--device', 'cpu'])
    assert list(rows) == names == ['plain fwd', 'stash fwd', 'stash bwd']
    for r in rows.values():
        assert r['ms'] > 0 and np.isfinite(r['tflops']) and r['launches'] == {}


def test_probe_grid_kernel_keys(jax_probe):
    want = json.loads(jax_probe('probe_grid_kernel', ['--n', '64', '--reps', '1'])
                      .strip().splitlines()[-1])
    got = probe_grid_kernel.main(['--n', '64', '--reps', '1', '--device', 'cpu'])
    assert set(got) - set(want) == {'launches', 'device'} and set(want) <= set(got)
    assert got['n_points'] == want['n_points'] == 64
    assert set(got['launches']) == {label for label, _ in probe_grid_kernel.CONFIGS}
    assert all(got[k] > 0 for k in want if k.endswith('_ms'))


def test_probe_overhead_keys(jax_probe):
    out = jax_probe('probe_overhead', ['--batch', '2', '--reps', '1', '--n1', '1', '--n2', '2'])
    want = json.loads(out[out.index('{'):])
    got = probe_overhead.main(['--batch', '2', '--reps', '2', '--steps', '1', '--device', 'cpu'])
    assert list(got) == list(want)
    for name, row in got.items():
        assert set(row) - set(want[name]) == {'launches'} and set(want[name]) <= set(row)
        assert len(row['all_ms']) == 2 and row['ms_per_step'] > 0


def test_probe_grid_step_keys(jax_probe):
    want = json.loads(jax_probe('probe_grid_step', ['--batch', '2', '--reps', '1'])
                      .strip().splitlines()[-1])
    got = probe_grid_step.main(['--batch', '2', '--reps', '1', '--device', 'cpu'])
    assert set(got) - set(want) == {'launches', 'device'} and set(want) <= set(got)
    assert got['config'] == want['config'] and got['batch'] == want['batch'] == 2
    assert got['iota_step_ms'] > 0 and got['mxu_step_ms'] > 0


def test_probe_grid_encoding_keys(jax_probe):
    flags = ['--n', '64', '--grid', '8', '--features', '4', '--chunk', '32', '--reps', '1']
    want = json.loads(jax_probe('probe_grid_encoding', flags).strip().splitlines()[-1])
    got = probe_grid_encoding.main(flags + ['--device', 'cpu'])
    assert set(want) <= set(got)
    assert set(got) - set(want) == {'mlp_6x384_stash', 'mlp_2x128_stash', 'launches', 'device'}
    assert got['n_points'] == 64 and all(got[k] > 0 for k in want if k != 'n_points')


@pytest.mark.parametrize('n,chunk', [(300, 64), (64, 64)])
def test_grid_encode_matches_jax(n, chunk):
    import jax.numpy as jnp

    from sunerf_tpu_torch.ops.grid_encoding import grid_encode as gather_encode
    jax_enc = _jax_script('probe_grid_encoding')
    rng = np.random.default_rng(n)
    G, F = 8, 16
    pts = rng.uniform(-1.0, 1.0, size=(n, 3)).astype(np.float32)
    table = rng.normal(size=(G ** 3, F)).astype(np.float32)
    want = np.asarray(jax_enc.grid_encode(jnp.asarray(pts), jnp.asarray(table), G, chunk))
    got = probe_grid_encoding.grid_encode(torch.from_numpy(pts), torch.from_numpy(table), G,
                                          chunk).numpy()
    assert got.shape == want.shape == (n, F)
    assert np.max(np.abs(got - want)) <= 1e-6 * np.max(np.abs(want))
    # the same trilinear features as the port's gather over a [G, G, G, F]
    # table in axis order (y, z, x, f), at bound 1: the one-hot rows index
    # the flat table as (x, y, z)
    grid = torch.from_numpy(table.reshape(G, G, G, F).transpose(1, 2, 0, 3).copy())
    gathered = gather_encode(grid, torch.from_numpy(pts), 1.0).numpy()
    assert np.max(np.abs(got - gathered)) <= 1e-5 * np.max(np.abs(gathered))
