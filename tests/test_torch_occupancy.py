"""The port's occupancy grid (sunerf_tpu_torch/core/occupancy.py, its
systems, renderer and Trainer plumbing) against the JAX package on the CPU,
and counterparts of tests/test_occupancy.py.

JAX draws the sampler's and the update's uniforms from its keys, the port
from a torch.Generator; the parity tests feed the port JAX's own uniforms.
Tolerances:
  * occupancy_at within 1e-6 (the same cells: JAX's one-hot contractions
    and the port's gathers pick the same entries);
  * occupancy_sample's z values within 1e-5 absolute (a few float32 ulps of
    z ~ 3-5, as the samplers' tests);
  * update_occupancy's grids within 1e-5 (torch.quantile's linear
    interpolation is jnp.percentile's; a cell at the threshold could flip,
    none does here);
  * the occupancy closed loop (2x32 emission field on SimpleStar views,
    perturb off, the grid updated every 2 steps from step 2 with JAX's
    uniforms): logged losses within 1e-3 relative, the final grids within
    1e-5; each package's bundle, grid included, served by both loaders at a
    close observer within 1e-4 of max (the float32 field; as the Trainer
    tests hold bundles).
"""
import dataclasses
import functools
import json
import os
import signal
from datetime import datetime

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sunerf_tpu.core import occupancy as jocc
from sunerf_tpu.data.loaders import build_single_channel_data as jax_build
from sunerf_tpu.evaluation.image_render import render_observers
from sunerf_tpu.evaluation.loader import SuNeRFLoader as JaxLoader
from sunerf_tpu.models.fields import emission_config as jax_emission_config
from sunerf_tpu.models.fields import init_nerf as jax_init_nerf
from sunerf_tpu.models.fields import nerf_apply as jax_nerf_apply
from sunerf_tpu.rendering.emission import EmissionHead as JaxEmissionHead
from sunerf_tpu.systems import make_emission_system as jax_make_emission_system
from sunerf_tpu.train.loop import Trainer as JaxTrainer
from sunerf_tpu.train.loop import TrainerConfig as JaxTrainerConfig
from sunerf_tpu.train.objective import LossConfig as JaxLossConfig
from sunerf_tpu.train.optim import OptimConfig as JaxOptimConfig
from sunerf_tpu.train.optim import make_optimizer as jax_make_optimizer
from sunerf_tpu.train.step import create_train_state as jax_create_train_state
from sunerf_tpu.train.step import make_train_step as jax_make_train_step
from sunerf_tpu_torch.core.occupancy import (OccupancyConfig, init_occupancy, occupancy_at,
                                             occupancy_pdf, occupancy_sample,
                                             update_occupancy)
from sunerf_tpu_torch.core.sampling import _invert_cdf, stratified_sample
from sunerf_tpu_torch.data.loaders import build_single_channel_data
from sunerf_tpu_torch.evaluation.loader import SuNeRFLoader
from sunerf_tpu_torch.models.fields import (FieldOutput, emission_config, nerf_apply,
                                            params_from_numpy)
from sunerf_tpu_torch.rendering.emission import EmissionHead
from sunerf_tpu_torch.rendering.renderer import Renderer
from sunerf_tpu_torch.systems import (from_spec, make_emission_system,
                                      make_simple_star_renderer, make_thomson_system)
from sunerf_tpu_torch.train.loop import Trainer, TrainerConfig
from sunerf_tpu_torch.train.objective import LossConfig
from sunerf_tpu_torch.train.optim import OptimConfig, make_optimizer
from sunerf_tpu_torch.train.step import create_train_state, make_train_step

torch.set_num_threads(1)

CFG = OccupancyConfig(nr=8, ntheta=4, nphi=6)
JCFG = jocc.OccupancyConfig(nr=8, ntheta=4, nphi=6)
SMALL = dict(n_layers=2, d_filter=32, n_freqs=3)


def _random_grid(seed=0, vol=True) -> dict:
    rng = np.random.default_rng(seed)
    grid = {'occ_r': rng.uniform(0, 1, CFG.nr), 'occ_ang': rng.uniform(0, 1, (CFG.ntheta, CFG.nphi))}
    if vol:
        grid['occ_vol'] = rng.uniform(0, 1, CFG.nvol)
    return {k: v.astype(np.float32) for k, v in grid.items()}


def _shell_points(n=500, seed=1) -> tuple:
    rng = np.random.default_rng(seed)
    r = rng.uniform(0.9, 1.5, n)
    theta = rng.uniform(0.0, np.pi, n)
    phi = rng.uniform(-np.pi, np.pi, n)
    pts = np.stack([r * np.sin(theta) * np.cos(phi), r * np.sin(theta) * np.sin(phi),
                    r * np.cos(theta)], axis=-1).astype(np.float32)
    return pts, r, theta, phi


def _t(tree):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in tree.items()}


def _rays(n=32, seed=0) -> tuple:
    rng = np.random.default_rng(seed)
    o = np.tile(np.array([[4.0, 0.0, 0.0]], np.float32), (n, 1))
    d = np.array([[-1.0, 0.0, 0.0]]) + 0.2 * rng.normal(size=(n, 3))
    return o, (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize('vol', [True, False], ids=['with_vol', 'separable'])
def test_occupancy_at_matches_jax(vol):
    grid = _random_grid(vol=vol)
    pts, r, theta, phi = _shell_points()
    got = occupancy_at(_t(grid), CFG, torch.from_numpy(pts)).numpy()
    want = np.asarray(jax.jit(lambda g, x: jocc.occupancy_at(g, JCFG, x))(grid, pts))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    if not vol:  # tests/test_occupancy.py's dense-indexing reference
        ir = np.clip(((r - CFG.r_min) / ((CFG.r_max - CFG.r_min) / CFG.nr)).astype(int), 0,
                     CFG.nr - 1)
        it = np.clip((theta / (np.pi / CFG.ntheta)).astype(int), 0, CFG.ntheta - 1)
        ip = np.clip(((phi + np.pi) / (2 * np.pi / CFG.nphi)).astype(int), 0, CFG.nphi - 1)
        ref = np.minimum(grid['occ_r'][ir], grid['occ_ang'][it, ip])
        ref = np.where(r > CFG.r_max, 0.0, np.where(r < CFG.r_min, 1.0, ref))
        np.testing.assert_allclose(got, ref, atol=1e-6)


@pytest.mark.parametrize('warm', [False, True], ids=['updated_grid', 'warm_grid'])
def test_occupancy_sample_matches_jax_on_its_uniforms(warm):
    grid = {k: np.ones_like(v) for k, v in _random_grid().items()} if warm else _random_grid()
    cfg = dataclasses.replace(CFG, n_probe=16)
    jcfg = dataclasses.replace(JCFG, n_probe=16)
    o, d = _rays()
    jgrid = {k: jnp.asarray(v) for k, v in grid.items()}
    key = jax.random.key(4)
    sample = jax.jit(lambda g, k: jocc.occupancy_sample(o, d, g, jcfg, n_samples=24,
                                                        distance=1.3, solar_radius=1.0, key=k))
    j = sample(jgrid, key)
    edges, pdf = occupancy_pdf(torch.from_numpy(o), torch.from_numpy(d), _t(grid), cfg, 1.3, 1.0)
    if warm:
        assert bool((pdf == 1.0).all())
    jitter = np.asarray(jax.random.uniform(key, (o.shape[0], 24)))
    u = torch.from_numpy(((np.arange(24, dtype=np.float32) + jitter) / 24).astype(np.float32))
    z = torch.sort(_invert_cdf(edges, pdf, u), dim=-1).values
    np.testing.assert_allclose(z.numpy(), np.asarray(j['z_vals']), rtol=0, atol=1e-5)
    # the deterministic path, whole
    j0 = jax.jit(lambda g: jocc.occupancy_sample(o, d, g, jcfg, n_samples=24, distance=1.3,
                                                 solar_radius=1.0, key=None))(jgrid)
    t0 = occupancy_sample(torch.from_numpy(o), torch.from_numpy(d), _t(grid), cfg, n_samples=24,
                          distance=1.3, solar_radius=1.0)
    for k in ('z_vals', 'points'):
        np.testing.assert_allclose(t0[k].numpy(), np.asarray(j0[k]), rtol=0, atol=1e-5)
    g = occupancy_sample(torch.from_numpy(o), torch.from_numpy(d), _t(grid), cfg, n_samples=24,
                         distance=1.3, solar_radius=1.0,
                         generator=torch.Generator().manual_seed(0))['z_vals']
    assert bool((torch.diff(g, dim=-1) >= 0).all()) and not g.requires_grad
    assert bool((g >= edges[:, :1] - 1e-5).all()) and bool((g <= edges[:, -1:] + 1e-5).all())


def test_update_occupancy_matches_jax_on_its_uniforms():
    """Three updates from the warm grid on a 2x32 field (the emission
    head's activity, the field scaled so cells fall on both sides of the
    threshold), fed JAX's uniforms; the percentile itself beside."""
    cfg, jcfg = dataclasses.replace(CFG, threshold=0.3), dataclasses.replace(JCFG, threshold=0.3)
    config = jax_emission_config(**SMALL)
    p = jax.tree.map(np.asarray, jax_init_nerf(jax.random.key(2), config))
    p['w_out'] = p['w_out'] * 8.0
    jfield = functools.partial(jax_nerf_apply, config)
    tfield = functools.partial(nerf_apply, emission_config(**SMALL))
    jgrid, tgrid = jocc.init_occupancy(jcfg), init_occupancy(cfg, 'cpu')
    tp = params_from_numpy(p, 'cpu')
    activity, jactivity = EmissionHead().occupancy_activity, JaxEmissionHead().occupancy_activity
    update = jax.jit(lambda g, k: jocc.update_occupancy(g, jcfg, jfield, p, jactivity, k, 0.25))
    for i in range(3):
        key = jax.random.key(10 + i)
        jgrid = update(jgrid, key)
        u = torch.from_numpy(np.asarray(jax.random.uniform(key, (8, 4, 6, 3))))
        tgrid = update_occupancy(tgrid, cfg, tfield, tp, activity, None, 0.25, uniforms=u)
        for k in jgrid:
            np.testing.assert_allclose(tgrid[k].numpy(), np.asarray(jgrid[k]), rtol=0, atol=1e-5)
    cells = np.concatenate([v.numpy().ravel() for v in tgrid.values()])
    assert (cells < 1.0).any() and (cells == 1.0).any()   # both sides of the threshold
    x = np.random.default_rng(0).lognormal(0, 2, 768).astype(np.float32)
    q = float(torch.quantile(torch.from_numpy(x), 0.995))
    assert abs(q - float(jnp.percentile(jnp.asarray(x), 99.5))) <= 1e-6 * q


# ------------------------------------ counterparts of tests/test_occupancy.py

def _scene(kind: str):
    """tests/test_occupancy.py's analytic fields, on torch: activity as both
    raw channels."""
    def apply(_params, pts):
        r = torch.linalg.norm(pts[:, :3], dim=-1)
        phi = torch.arctan2(pts[:, 1], pts[:, 0])
        if kind == 'cell':      # shell 4 of 8, phi > 0 (cols 3-5)
            act = ((r >= 1.15) & (r < 1.1875) & (phi > 0)).float()
        elif kind == 'blob':    # a bright blob in one sextant on a 1% floor
            act = 0.01 + ((r >= 1.15) & (r < 1.1875) & (phi > 0) & (phi < np.pi / 3)).float()
        else:                   # a thin full shell plus a blob at high r
            act = ((r < 1.075) | ((r >= 1.1875) & (r < 1.225) & (phi > 0)
                                  & (phi < np.pi / 3))).float()
        return FieldOutput(raw=torch.stack([act, act], dim=-1))
    return apply


def _zero(vol=False) -> dict:
    grid = {'occ_r': torch.zeros(CFG.nr), 'occ_ang': torch.zeros(CFG.ntheta, CFG.nphi)}
    if vol:
        grid['occ_vol'] = torch.zeros(CFG.nvol)
    return grid


def _update(grid, kind, seed=0):
    return update_occupancy(grid, CFG, _scene(kind), {}, lambda raw: raw[..., 0],
                            torch.Generator().manual_seed(seed), 0.0)


def test_update_occupancy_projects_active_cell():
    grid = _update(_zero(), 'cell')
    np.testing.assert_array_equal(grid['occ_r'].numpy(), [0, 0, 0, 0, 1, 0, 0, 0])
    np.testing.assert_array_equal(grid['occ_ang'][:, :3].numpy(), np.zeros((CFG.ntheta, 3)))
    np.testing.assert_array_equal(grid['occ_ang'][:, 3:].numpy(), np.ones((CFG.ntheta, 3)))


def test_update_occupancy_culls_dominant_dim_background():
    grid = _update(_zero(), 'blob')
    np.testing.assert_array_equal(grid['occ_r'].numpy(), [0, 0, 0, 0, 1, 0, 0, 0])
    assert float(grid['occ_ang'].sum()) > 0


def test_volume_factor_culls_what_separable_factors_cannot():
    grid = _update(_zero(vol=True), 'shell_and_blob')
    assert float(grid['occ_r'][5]) == 1.0
    np.testing.assert_array_equal(grid['occ_ang'].numpy(), np.ones((CFG.ntheta, CFG.nphi)))
    in_blob = torch.tensor([[1.2 * np.cos(0.5), 1.2 * np.sin(0.5), 0.0]], dtype=torch.float32)
    off = torch.tensor([[1.2 * np.cos(2.5), 1.2 * np.sin(2.5), 0.0]], dtype=torch.float32)
    assert float(occupancy_at(grid, CFG, in_blob)[0]) == 1.0
    separable = {k: grid[k] for k in ('occ_r', 'occ_ang')}
    assert float(occupancy_at(separable, CFG, off)[0]) == 1.0
    assert float(occupancy_at(grid, CFG, off)[0]) == 0.0


def test_update_occupancy_ema_decay():
    def dead(_params, pts):
        return FieldOutput(raw=torch.zeros(pts.shape[0], 2))
    grid = init_occupancy(CFG, 'cpu')
    for i in range(3):
        grid = update_occupancy(grid, CFG, dead, {}, lambda r: r[..., 0],
                                torch.Generator().manual_seed(i), 0.0)
    np.testing.assert_allclose(grid['occ_r'].numpy(), CFG.decay ** 3, rtol=1e-5)


def test_occupancy_sample_concentrates_in_occupied_shell():
    grid = init_occupancy(CFG, 'cpu')
    grid['occ_r'][2:] = 0.0
    gen = torch.Generator().manual_seed(0)
    dirs = torch.tensor([[-1.0, 0.0, 0.0]]) + 0.02 * torch.randn(32, 3, generator=gen)
    rays_d = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
    out = occupancy_sample(torch.tensor([[4.0, 0.0, 0.0]]).expand(32, 3), rays_d, grid, CFG,
                           n_samples=32, distance=1.3, solar_radius=1.0,
                           generator=torch.Generator().manual_seed(1))
    assert bool((torch.diff(out['z_vals'], dim=-1) >= 0).all())
    r = torch.linalg.norm(out['points'], dim=-1)
    assert float(((r > 0.99) & (r < 1.09)).float().mean()) > 0.6


def test_full_grid_matches_stratified_bounds():
    grid = init_occupancy(CFG, 'cpu')
    rays_o = torch.tensor([[4.0, 0.0, 0.0]]).expand(8, 3)
    d = torch.tensor([[-1.0, 0.05, 0.0]]).expand(8, 3)
    rays_d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    occ = occupancy_sample(rays_o, rays_d, grid, CFG, n_samples=64, distance=1.3,
                           solar_radius=1.0)
    ref = stratified_sample(rays_o, rays_d, n_samples=64, distance=1.3, solar_radius=1.0)
    z_occ, z_ref = occ['z_vals'].numpy(), ref['z_vals'].numpy()
    np.testing.assert_allclose(z_occ[:, 0], z_ref[:, 0], atol=0.05)
    np.testing.assert_allclose(z_occ[:, -1], z_ref[:, -1], atol=0.05)
    uniform = (z_ref[:, -1] - z_ref[:, 0]) / 63
    assert np.diff(z_occ, axis=-1).max() < 3.0 * uniform.max()
    r_occ = np.linalg.norm(occ['points'].numpy(), axis=-1)
    r_ref = np.linalg.norm(ref['points'].numpy(), axis=-1)
    assert abs(np.mean(r_occ > CFG.r_max) - np.mean(r_ref > CFG.r_max)) < 0.05


def test_occupancy_rejects_non_stratified_sampling():
    occ = {'enabled': True, 'nr': 8, 'ntheta': 4, 'nphi': 8}
    with pytest.raises(ValueError, match='stratified'):
        make_thomson_system(sampling='spherical', occupancy=occ, device='cpu')
    with pytest.raises(ValueError, match='stratified'):
        Renderer(field_apply=None, head=EmissionHead(), sampling='spherical', occupancy=CFG)
    # disabled configs drop the key
    renderer, init = make_emission_system(model_config=emission_config(**SMALL), device='cpu',
                                          occupancy=dict(occ, enabled=False))
    assert renderer.occupancy is None and 'occupancy' not in renderer.spec['render']
    assert 'occupancy' not in init(torch.Generator().manual_seed(0))


def test_training_step_with_occupancy_grid_matches_jax():
    """One step with a non-trivial grid: the grid is not a parameter of
    Adam and stays exactly as it was, the MLP moves, and the loss and the
    updated fine weights match JAX's step on the same params and batch."""
    occ = {'enabled': True, 'nr': 8, 'ntheta': 4, 'nphi': 6, 'n_probe': 8}
    kw = dict(n_stratified=8, n_hierarchical=8, perturb=False, occupancy=occ)
    jr, jinit = jax_make_emission_system(model_config=jax_emission_config(**SMALL),
                                         use_fused=False, **kw)
    tr, _ = make_emission_system(model_config=emission_config(**SMALL), device='cpu', **kw)
    params = jax.tree.map(np.asarray, jinit(jax.random.key(0)))
    params['occupancy']['occ_r'] = np.where(np.arange(6 + 2) >= 4, 0.1, 1.0).astype(np.float32)
    batch = {'rays': np.stack([np.tile(np.array([[4.0, 0.0, 0.0]], np.float32), (16, 1)),
                               np.tile(np.array([[-1.0, 0.0, 0.0]], np.float32), (16, 1))],
                              axis=1),
             'time': np.zeros((16, 1), np.float32),
             'target_image': np.full((16, 1), 0.05, np.float32)}
    jopt = jax_make_optimizer()
    jstate, jm = jax_make_train_step(jr, JaxLossConfig(), jopt, donate=False)(
        jax_create_train_state(jax.tree.map(jnp.asarray, params), jopt),
        jax.tree.map(jnp.asarray, batch), jax.random.key(1))
    opt = make_optimizer()
    state = create_train_state(params_from_numpy(params, 'cpu'), opt)
    grid = state.params['occupancy']
    assert all(not g.requires_grad for g in grid.values())
    held = {id(p) for group in state.opt_state.param_groups for p in group['params']}
    assert not held & {id(g) for g in grid.values()}
    before = {k: v.clone() for k, v in grid.items()}
    w_in = state.params['fine']['w_in'].detach().clone()
    state, m = make_train_step(tr, LossConfig(), opt)(
        state, {k: torch.from_numpy(v) for k, v in batch.items()}, 1)
    assert np.isfinite(float(m['loss']))
    for k in before:
        assert torch.equal(state.params['occupancy'][k], before[k]), k
    assert not torch.equal(state.params['fine']['w_in'], w_in)
    assert abs(float(m['loss']) - float(jm['loss'])) <= 1e-5 * abs(float(jm['loss']))
    ref = np.asarray(jstate.params['fine']['w_in'])
    got = state.params['fine']['w_in'].detach().numpy()
    assert np.max(np.abs(got - ref)) <= 1e-4 * np.max(np.abs(ref))


def test_spec_roundtrip_and_analytic_renderers_carry_the_grid():
    renderer, _ = make_emission_system(model_config=emission_config(**SMALL), device='cpu',
                                       occupancy=OccupancyConfig(nr=16, ntheta=8, nphi=8))
    spec = json.loads(json.dumps(renderer.spec))
    assert spec['render']['occupancy']['nr'] == 16
    r2, init2 = from_spec(spec, device='cpu')
    assert r2.occupancy == OccupancyConfig(nr=16, ntheta=8, nphi=8)
    assert 'occupancy' in init2(torch.Generator().manual_seed(0))
    star, init = make_simple_star_renderer(
        occupancy=OccupancyConfig(nr=8, ntheta=4, nphi=8, n_probe=8), device='cpu')
    params = init()
    assert set(params['occupancy']) == {'occ_r', 'occ_ang', 'occ_vol'}


# ----------------------------------------------- the Trainer, against JAX's

OCC = {'enabled': True, 'nr': 8, 'ntheta': 4, 'nphi': 8, 'n_probe': 16, 'warmup': 2,
       'update_every': 2, 'threshold': 0.9}
LOOP_KW = dict(total_steps=8, val_every=1000, checkpoint_every=1000, log_every=2,
               save_val_images=False, ema_decay=0.9)
SAMPLES = dict(n_stratified=8, n_hierarchical=8, perturb=False, occupancy=OCC)


class _JaxUniforms(Trainer):
    """The port's Trainer, its grid updates fed JAX's uniforms for the step
    (fold_in(key(seed + 2), step), as JAX's Trainer draws them)."""

    def update_occupancy(self, step, time, uniforms=None):
        occ = self.renderer.occupancy
        key = jax.random.fold_in(jax.random.key(self.config.seed + 2), step)
        u = np.asarray(jax.random.uniform(key, (occ.nr, occ.ntheta, occ.nphi, 3)))
        super().update_occupancy(step, time, uniforms=torch.from_numpy(u))


def _records(workdir) -> list:
    with open(os.path.join(workdir, 'metrics.jsonl')) as f:
        return [json.loads(line) for line in f]


def test_trainer_with_occupancy_matches_jax(tmp_path):
    observers = [{'name': 'aia', 'lat': 5.0 * ((i % 3) - 1), 'lon': i * 45.0,
                  'distance': 215.0, 'time': datetime(2012, 8, 20 + i).isoformat()}
                 for i in range(4)]
    render_observers({'model': 'SimpleStar', 'render_path': str(tmp_path / 'renders'),
                      'render_format': ['fits'], 'resolution': 16, 'wavelengths': [193],
                      'batch_size': 256, 'pixel_intensity_factor': 1e9,
                      'observers': observers})
    pattern = str(tmp_path / 'renders' / 'aia' / '193' / '*.fits')
    loss_kw = dict(lambda_regularization=0.1, scaling_vmax=10.0)
    optim_kw = dict(lr_start=1e-3, lr_floor=1e-3)
    jr, jinit = jax_make_emission_system(model_config=jax_emission_config(**SMALL), **SAMPLES)
    params = jax.tree.map(np.array, jinit(jax.random.key(7)))
    params['fine']['w_out'] *= 8.0   # activity on both sides of the threshold
    jt = JaxTrainer(jr, params, jax_build(pattern, str(tmp_path / 'jw'), batch_size=128,
                                          n_workers=1),
                    loss_config=JaxLossConfig(**loss_kw), optim_config=JaxOptimConfig(**optim_kw),
                    trainer_config=JaxTrainerConfig(**LOOP_KW), workdir=str(tmp_path / 'jax'))
    handler = signal.getsignal(signal.SIGTERM)
    try:
        jt.fit()
    finally:
        signal.signal(signal.SIGTERM, handler)   # JAX's fit leaves its own
    tr, _ = make_emission_system(model_config=emission_config(**SMALL), device='cpu', **SAMPLES)
    pt = _JaxUniforms(tr, params, build_single_channel_data(pattern, str(tmp_path / 'pw'),
                                                            batch_size=128, n_workers=1),
                      loss_config=LossConfig(**loss_kw), optim_config=OptimConfig(**optim_kw),
                      trainer_config=TrainerConfig(**LOOP_KW), workdir=str(tmp_path / 'port'),
                      device='cpu')
    pt.fit()
    jrec = [r for r in _records(str(tmp_path / 'jax')) if 'loss' in r]
    prec = [r for r in _records(str(tmp_path / 'port')) if 'loss' in r]
    assert [r['step'] for r in prec] == [r['step'] for r in jrec] == [2, 4, 6, 8]
    for j, p in zip(jrec, prec):
        assert abs(p['loss'] - j['loss']) <= 1e-3 * abs(j['loss']), (j['step'], p, j)
        for k in ('occ_r_frac', 'occ_ang_frac', 'occ_vol_frac'):
            assert p[k] == j[k], (j['step'], k)
    jgrid = jt.state.params['occupancy']
    for k, v in pt.state.params['occupancy'].items():
        np.testing.assert_allclose(v.numpy(), np.asarray(jgrid[k]), rtol=0, atol=1e-5)
    assert any(bool((v < 1.0).any()) for v in pt.state.params['occupancy'].values())
    # the EMA bundle carries the live grid; each bundle served by both loaders
    ema = np.load(str(tmp_path / 'port' / 'save_state_ema.npz'))
    np.testing.assert_array_equal(ema['occupancy/occ_r'],
                                  pt.state.params['occupancy']['occ_r'].numpy())
    view = dict(lat=0.1, lon=0.5, time=0.0, distance=3.0, resolution=12)
    for run in ('jax', 'port'):
        path = str(tmp_path / run / 'save_state')
        jv = JaxLoader(path, batch_size=256).render_observer_image(**view)
        pv = SuNeRFLoader(path, batch_size=256, device='cpu').render_observer_image(**view)
        assert 'occupancy' in SuNeRFLoader(path, device='cpu').params
        for k in ('image', 'height_map', 'absorption_map'):
            ref, got = getattr(jv, k), getattr(pv, k)
            assert np.max(np.abs(ref - got)) <= 1e-4 * np.max(np.abs(ref)), (run, k)
