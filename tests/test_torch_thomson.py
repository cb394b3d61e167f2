"""The port's Thomson slice against the JAX package, on the CPU: the
spherical sampler (sunerf_tpu_torch/core/sampling.py), the Thomson head
(rendering/thomson.py), make_thomson_system and from_spec, and the Thomson
closed loop of tests/test_end_to_end.py.

The same inputs, made from a seed with numpy, go to both packages; the JAX
side is jitted. Tolerances:
  * the spherical sampler: 1e-5 absolute on z values of order 1-6 (a few
    float32 ulps), jittered with JAX's own uniforms;
  * the head, its extra outputs and their gradients with respect to raw:
    within 1e-5 of max (float32 sums in another order);
  * the closed loop (a 2x32 student, 8 + 8 samples, perturb off, one set of
    JAX-initialised parameters, 25 steps): the teacher's target within 1e-5
    of max, the losses within 1e-3 relative, falling in both packages.
"""
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sunerf_tpu.core.sampling import spherical_sample as jax_spherical_sample
from sunerf_tpu.models.fields import FieldOutput as JaxFieldOutput
from sunerf_tpu.models.fields import emission_config as jax_emission_config
from sunerf_tpu.models.fields import init_nerf as jax_init_nerf
from sunerf_tpu.models.fields import nerf_apply as jax_nerf_apply
from sunerf_tpu.rendering.renderer import Renderer as JaxRenderer
from sunerf_tpu.rendering.thomson import ThomsonHead as JaxThomsonHead
from sunerf_tpu.systems import from_spec as jax_from_spec
from sunerf_tpu.systems import make_thomson_system as jax_make_thomson
from sunerf_tpu.train.objective import LossConfig as JaxLossConfig
from sunerf_tpu.train.optim import OptimConfig as JaxOptimConfig
from sunerf_tpu.train.optim import make_optimizer as jax_make_optimizer
from sunerf_tpu.train.step import create_train_state as jax_create_train_state
from sunerf_tpu.train.step import make_train_step as jax_make_train_step
from sunerf_tpu_torch.core.sampling import _perturb_bins, norm3, spherical_sample
from sunerf_tpu_torch.models.fields import (FieldOutput, emission_config, nerf_apply,
                                            params_from_numpy)
from sunerf_tpu_torch.rendering.renderer import Renderer
from sunerf_tpu_torch.rendering.thomson import ThomsonHead
from sunerf_tpu_torch.systems import from_spec, make_thomson_system
from sunerf_tpu_torch.train.objective import LossConfig
from sunerf_tpu_torch.train.optim import OptimConfig, make_optimizer
from sunerf_tpu_torch.train.step import create_train_state, make_train_step

torch.set_num_threads(1)

Z_ATOL = 1e-5
HEAD_TOL = 1e-5
TARGET_TOL = 1e-5
LOSS_RTOL = 1e-3


def _rel(ref, got) -> float:
    ref, got = np.asarray(ref, np.float64), np.asarray(got, np.float64)
    return float(np.max(np.abs(ref - got)) / np.max(np.abs(ref)))


def _rays(n: int = 48, seed: int = 0):
    """An observer at 4 Rs whose rays hit the Sun and the 2-Rs bounding
    sphere, graze past the Sun inside the bounding sphere, or miss both."""
    rng = np.random.default_rng(seed)
    o = np.tile(np.float32([[4.0, 0.5, -0.3]]), (n, 1))
    toward = -o / np.linalg.norm(o, axis=-1, keepdims=True)
    side = np.cross(toward, [0.0, 0.0, 1.0])
    side /= np.linalg.norm(side, axis=-1, keepdims=True)
    # impact parameters: < 1 hits the Sun, 1..2 the bounding sphere only,
    # > 2 misses both
    b = np.concatenate([rng.uniform(0.0, 0.9, n // 3), rng.uniform(1.1, 1.9, n // 3),
                        rng.uniform(2.2, 3.0, n - 2 * (n // 3))])
    d = toward * np.sqrt(16.34 - b[:, None] ** 2) + side * b[:, None]
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    return o.astype(np.float32), d


def _hits(o, d, radius):
    b = 2 * np.sum(o * d, -1)
    return b * b - 4 * (np.sum(o * o, -1) - radius ** 2) >= 0


def test_spherical_sample_matches_jax():
    o, d = _rays()
    sun, bound = _hits(o, d, 1.0), _hits(o, d, 2.0)
    assert sun.any() and (bound & ~sun).any() and (~bound).any()
    j = jax_spherical_sample(jnp.asarray(o), jnp.asarray(d), n_samples=20, distance=2.0)
    t = spherical_sample(torch.from_numpy(o), torch.from_numpy(d), n_samples=20, distance=2.0)
    for k in ('z_vals', 'points'):
        assert torch.isfinite(t[k]).all()
        np.testing.assert_allclose(t[k].numpy(), np.asarray(j[k]), rtol=0, atol=Z_ATOL)
    z = t['z_vals'].numpy()
    # a ray that misses the bounding sphere collapses to its closest approach
    closest = -np.sum(o * d, -1)
    np.testing.assert_allclose(z[~bound], np.repeat(closest[~bound, None], 20, 1), atol=Z_ATOL)
    # a ray that hits the Sun stops at its surface
    pts = t['points'].numpy()
    np.testing.assert_allclose(np.linalg.norm(pts[sun, -1], axis=-1), 1.0, atol=1e-4)
    np.testing.assert_allclose(np.linalg.norm(pts[bound, 0], axis=-1), 2.0, atol=1e-4)
    # jitter: the port's bins fed JAX's own uniforms
    key = jax.random.key(5)
    jj = jax_spherical_sample(jnp.asarray(o), jnp.asarray(d), n_samples=20, distance=2.0,
                              key=key)
    u = np.asarray(jax.random.uniform(key, z.shape))
    np.testing.assert_allclose(_perturb_bins(t['z_vals'], torch.from_numpy(u)).numpy(),
                               np.asarray(jj['z_vals']), rtol=0, atol=Z_ATOL)
    g = [spherical_sample(torch.from_numpy(o), torch.from_numpy(d), n_samples=20,
                          generator=torch.Generator().manual_seed(1))['z_vals']
         for _ in range(2)]
    torch.testing.assert_close(g[0], g[1], rtol=0, atol=0)
    assert not torch.equal(g[0], t['z_vals'])


def test_thomson_head_and_gradients_match_jax():
    o, d = _rays(12, seed=1)
    t = spherical_sample(torch.from_numpy(o), torch.from_numpy(d), n_samples=16, distance=2.0)
    z, pts = t['z_vals'].numpy(), t['points'].numpy()
    rng = np.random.default_rng(2)
    raw = np.stack([rng.uniform(5.0, 9.0, z.shape), rng.normal(size=z.shape)],
                   -1).astype(np.float32)
    cot = {k: rng.normal(size=s).astype(np.float32) for k, s in (
        ('image', (12, 2)), ('pixel_density', (12,)), ('distance_from_sun', (12,)),
        ('distance_from_obs', (12,)), ('weights', z.shape))}
    keys = tuple(cot)

    def jfn(raw_):
        out = JaxThomsonHead().raw2outputs(JaxFieldOutput(raw=raw_), jnp.asarray(z),
                                           jnp.asarray(o), jnp.asarray(d), jnp.asarray(pts))
        return out

    jout = jax.jit(jfn)(jnp.asarray(raw))
    scale = {k: float(jnp.max(jnp.abs(jout[k]))) for k in keys}
    jgrad = jax.jit(jax.grad(lambda r: sum(jnp.sum(jfn(r)[k] / scale[k] * cot[k])
                                           for k in keys)))(jnp.asarray(raw))
    traw = torch.from_numpy(raw).requires_grad_(True)
    pout = ThomsonHead().raw2outputs(FieldOutput(raw=traw), *map(torch.from_numpy,
                                                                  (z, o, d, pts)))
    assert set(pout) == set(jout)
    for k in jout:
        assert torch.isfinite(pout[k]).all(), k
        if k == 'regularizing_quantity':
            assert torch.all(pout[k] == 0)
        else:
            assert _rel(jout[k], pout[k].detach().numpy()) < HEAD_TOL, k
    sum((pout[k] / scale[k] * torch.from_numpy(cot[k])).sum() for k in keys).backward()
    assert _rel(jgrad, traw.grad.numpy()) < HEAD_TOL
    head = ThomsonHead()
    np.testing.assert_allclose(head.occupancy_activity(torch.from_numpy(raw)).numpy(),
                               np.asarray(JaxThomsonHead().occupancy_activity(jnp.asarray(raw))),
                               rtol=1e-6)
    assert torch.all(head.regularization(torch.ones(3, 4), torch.ones(3, 4)) == 0)


def _json(x):
    return json.loads(json.dumps(x))


def test_thomson_system_round_trips_and_only_mhd_is_refused():
    small = dict(n_layers=2, d_filter=32)
    for sampling in ('stratified', 'spherical'):
        pr, pinit = make_thomson_system(model_config=emission_config(**small), device='cpu',
                                        n_stratified=8, n_hierarchical=8, sampling=sampling)
        jr, _ = jax_make_thomson(model_config=jax_emission_config(**small), use_fused=False,
                                 n_stratified=8, n_hierarchical=8, sampling=sampling)
        assert _json(pr.spec) == _json(jr.spec)
        assert _json(jax_from_spec(_json(pr.spec), use_fused=False)[0].spec) == _json(pr.spec)
        rebuilt, init = from_spec(_json(jr.spec), device='cpu')
        assert _json(rebuilt.spec) == _json(jr.spec)
        assert isinstance(rebuilt.head, ThomsonHead) and rebuilt.sampling == sampling
        params = init(torch.Generator().manual_seed(0))
        assert params['coarse']['w_h'].shape == params['fine']['w_h'].shape == (1, 32, 32)
    default, _ = make_thomson_system(device='cpu')
    assert default.spec['model_config']['d_filter'] == 512
    assert default.spec['model_config']['n_layers'] == 8
    with pytest.raises(ValueError, match='stratified'):
        make_thomson_system(device='cpu', sampling='spherical', occupancy={'nvol': [8, 8, 8]})
    with pytest.raises(ValueError, match='Unknown sampling'):
        make_thomson_system(device='cpu', sampling='uniform')
    # every head rebuilds but the MHD field
    for head in ('emission', 'density_temperature', 'simple_star', 'thomson'):
        renderer, _ = from_spec({'head': head, 'Rs_per_ds': 1.0,
                                 'render': {'n_stratified': 8}}, device='cpu')
        assert renderer.n_stratified == 8
    with pytest.raises(NotImplementedError, match='item 9'):
        from_spec({'head': 'mhd', 'Rs_per_ds': 1.0}, device='cpu')
    with pytest.raises(ValueError, match='unknown head'):
        from_spec({'head': 'nope', 'Rs_per_ds': 1.0}, device='cpu')


def _teacher_raw(log):
    """tests/test_end_to_end.py's teacher: n_e = 1e8 exp((1/r - 1)/0.2)."""
    def apply(params, pts):
        r = (jnp.linalg.norm(pts[:, :3], axis=-1) if log is jnp
             else norm3(pts[:, :3]))
        clamp = jnp.maximum(r, 0.5) if log is jnp else torch.clamp(r, min=0.5)
        log_ne = 8.0 + ((1.0 / clamp - 1.0) / 0.2) / np.log(10.0)
        zeros = jnp.zeros_like(log_ne) if log is jnp else torch.zeros_like(log_ne)
        stack = jnp.stack if log is jnp else torch.stack
        out = JaxFieldOutput if log is jnp else FieldOutput
        return out(raw=stack([log_ne, zeros], -1))
    return apply


def test_thomson_closed_loop_matches_jax():
    n = 128
    key = jax.random.key(0)
    rays_o = np.tile(np.float32([[4.0, 0.0, 0.0]]), (n, 1))
    dirs = np.float32([[-1.0, 0.0, 0.0]]) + 0.15 * np.asarray(jax.random.normal(key, (n, 3)))
    rays_d = (dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)).astype(np.float32)
    times = np.zeros((n, 1), np.float32)
    samples = dict(n_stratified=8, n_hierarchical=8, perturb=False)
    jteacher = JaxRenderer(field_apply=_teacher_raw(jnp), head=JaxThomsonHead(), **samples)
    pteacher = Renderer(field_apply=_teacher_raw(torch), head=ThomsonHead(), **samples)
    jtarget = np.asarray(jteacher({'coarse': {}, 'fine': {}}, *map(jnp.asarray,
                                                                   (rays_o, rays_d, times)))['image'])
    ptarget = pteacher({'coarse': {}, 'fine': {}},
                       *map(torch.from_numpy, (rays_o, rays_d, times)))['image'].numpy()
    assert np.isfinite(ptarget).all() and ptarget.max() > 0
    assert _rel(jtarget, ptarget) < TARGET_TOL

    jcfg, cfg = jax_emission_config(n_layers=2, d_filter=32), emission_config(n_layers=2,
                                                                             d_filter=32)
    k1, k2 = jax.random.split(key)
    params = jax.tree.map(np.asarray, {'coarse': jax_init_nerf(k1, jcfg),
                                       'fine': jax_init_nerf(k2, jcfg)})
    jstudent = JaxRenderer(field_apply=functools.partial(jax_nerf_apply, jcfg),
                           head=JaxThomsonHead(), **samples)
    student = Renderer(field_apply=functools.partial(nerf_apply, cfg), head=ThomsonHead(),
                       **samples)
    loss_kw = dict(image_scaling='none', lambda_regularization=0.0)
    jopt = jax_make_optimizer(JaxOptimConfig(lr_start=1e-3, lr_floor=1e-3))
    opt = make_optimizer(OptimConfig(lr_start=1e-3, lr_floor=1e-3))
    jstep = jax_make_train_step(jstudent, JaxLossConfig(**loss_kw), jopt, donate=False)
    step = make_train_step(student, LossConfig(**loss_kw), opt)
    jstate = jax_create_train_state(jax.tree.map(jnp.asarray, params), jopt)
    state = create_train_state(params_from_numpy(params, 'cpu'), opt)
    rays = np.stack([rays_o, rays_d], 1)
    jbatch = {'rays': jnp.asarray(rays), 'time': jnp.asarray(times),
              'target_image': jnp.asarray(jtarget)}
    batch = {'rays': torch.from_numpy(rays), 'time': torch.from_numpy(times),
             'target_image': torch.from_numpy(jtarget)}
    jlosses, losses = [], []
    for _ in range(25):
        jstate, jm = jstep(jstate, jbatch, key)
        state, m = step(state, batch, 0)
        jlosses.append(float(jm['loss']))
        losses.append(float(m['loss']))
    assert jlosses[-1] < jlosses[0] and losses[-1] < losses[0]
    np.testing.assert_allclose(losses, jlosses, rtol=LOSS_RTOL)
