"""The Thomson protocol on the port (sunerf_tpu_torch/scripts/
thomson_protocol.py) against the JAX package's scripts/thomson_protocol.py
on the CPU:

  * the float64 oracle (log10_ne, oracle_tb_pb): the port's copy equal to
    JAX's to float64 rounding (relative 1e-12) on the protocol's rays and
    on random ones;
  * tB and pB at 16^2, 215 Rs, 64 + 128 samples through the analytic field:
    the port's Renderer and ThomsonHead within 1e-5 of max of JAX's;
  * main with --skip-throughput at 16^2: JAX's keys, the oracle's
    pb_over_tb_max equal, the scores within 1e-3 percentage points (MAE) and
    0.01 dB (PSNR) of JAX main's (both round them to 4 and 2 decimals);
  * the training step's throughput at a 2x32 field and 32 rays on the CPU:
    finite, with JAX's key and the launches of one step (none on the CPU).
"""
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from sunerf_tpu_torch.models.fields import emission_config
from sunerf_tpu_torch.scripts import thomson_protocol

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
RES = 16


@pytest.fixture(scope='module')
def jax_tp():
    sys.path.insert(0, str(REPO / 'scripts'))
    try:
        sys.modules.pop('thomson_protocol', None)
        import thomson_protocol as jax_thomson
    finally:
        sys.path.remove(str(REPO / 'scripts'))
    return jax_thomson


def test_oracle_matches_jax(jax_tp):
    from sunerf_tpu_torch.core.geometry import observer_rays
    rng = np.random.default_rng(3)
    r = rng.uniform(0.2, 3.0, size=1000)
    np.testing.assert_allclose(thomson_protocol.log10_ne(r), jax_tp.log10_ne(r), rtol=1e-12)
    o, d = observer_rays(lat=0.3, lon=1.1, distance=215.0, resolution=8)
    cases = [(o.reshape(-1, 3), d.reshape(-1, 3)),
             (np.tile([[4.0, 0.0, 0.0]], (64, 1)) + rng.normal(size=(64, 3)) * 0.1,
              np.array([[-1.0, 0.0, 0.0]]) + 0.3 * rng.normal(size=(64, 3)))]
    for ro, rd in cases:
        for got, want in zip(thomson_protocol.oracle_tb_pb(ro, rd, n_quad=2048),
                             jax_tp.oracle_tb_pb(ro, rd, n_quad=2048)):
            np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)


def test_render_matches_jax(jax_tp):
    import jax.numpy as jnp
    from sunerf_tpu.core.geometry import observer_rays as jax_observer_rays
    from sunerf_tpu.models.fields import FieldOutput
    from sunerf_tpu.rendering.renderer import Renderer as JaxRenderer
    from sunerf_tpu.rendering.thomson import ThomsonHead as JaxThomsonHead

    def analytic_apply(params, pts):
        r = jnp.linalg.norm(pts[:, :3], axis=-1)
        log_ne = jax_tp.RHO0_LOG10 + ((1.0 / jnp.maximum(r, 0.5) - 1.0)
                                      / jax_tp.SCALE_H) / jnp.log(10.0)
        return FieldOutput(raw=jnp.stack([log_ne, jnp.zeros_like(log_ne)], -1))

    renderer = JaxRenderer(field_apply=analytic_apply, head=JaxThomsonHead(),
                           n_stratified=64, n_hierarchical=128, perturb=False)
    o, d = jax_observer_rays(lat=0.3, lon=1.1, distance=215.0, resolution=RES)
    img = np.asarray(renderer({'coarse': {}, 'fine': {}},
                              jnp.asarray(np.asarray(o).reshape(-1, 3), jnp.float32),
                              jnp.asarray(np.asarray(d).reshape(-1, 3), jnp.float32),
                              jnp.zeros((RES * RES, 1), jnp.float32))['image'], np.float64)
    tb, pb, po, pd = thomson_protocol.render_tb_pb(RES, 215.0, torch.device('cpu'))
    np.testing.assert_array_equal(po, np.asarray(o).reshape(-1, 3))
    np.testing.assert_array_equal(pd, np.asarray(d).reshape(-1, 3))
    for got, want in ((tb, img[:, 0]), (pb, img[:, 1])):
        assert np.max(np.abs(got - want)) <= 1e-5 * np.max(np.abs(want))


def test_main_matches_jax(jax_tp, tmp_path, monkeypatch, capsys):
    import jax
    row = thomson_protocol.main(['--resolution', str(RES), '--skip-throughput',
                                 '--device', 'cpu', '--out', str(tmp_path / 'port.json')])
    assert json.loads((tmp_path / 'port.json').read_text()) == row
    monkeypatch.setattr(jax.config, 'update', lambda *a: None)   # no host compile cache
    monkeypatch.setattr(sys, 'argv', ['thomson_protocol.py', '--resolution', str(RES),
                                      '--skip-throughput', '--out', str(tmp_path / 'jax.json')])
    jax_tp.main()
    capsys.readouterr()
    want = json.loads((tmp_path / 'jax.json').read_text())
    assert set(row) == set(want)
    for k in ('scene', 'sampling', 'oracle', 'pb_over_tb_max'):
        assert row[k] == want[k], k
    for k in ('tB', 'pB'):
        assert abs(row[k]['mae_percent_of_mean'] - want[k]['mae_percent_of_mean']) <= 1e-3, k
        assert abs(row[k]['psnr_db'] - want[k]['psnr_db']) <= 0.01, k


def test_step_throughput_on_the_cpu():
    t = thomson_protocol.step_throughput(torch.device('cpu'), batch_size=32, reps=1,
                                         model_config=emission_config(n_layers=2, d_filter=32))
    assert t['ms_per_step'] > 0 and t['rays_per_sec'] > 0 and np.isfinite(t['loss'])
    assert t['launches_per_step'] == {} and t['batch'] == 32
