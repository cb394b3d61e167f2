"""The port's feature-grid slice (sunerf_tpu_torch: ops/grid_encoding.py,
the grid branch K5 of the fused kernels' plain versions, the grid fields,
table TV, the table optimizer recipe, grid bundles) against the JAX package
on the CPU. Inputs come from numpy seeds; torch runs at one thread.

Tolerances, each with its reason:
  * float32 paths (grid_encode, VM encodings, nerf_apply, the float32 train
    step) within 1e-5 to 1e-4 of max: only the order of float32 sums
    differs (the JAX package contracts one-hot hat rows at
    precision=HIGHEST, the port gathers 8 corners);
  * the kernels' plain versions against JAX's grid kernels in interpret
    mode, as tests/test_fused_mlp.py:205-241 holds the JAX kernel to its
    float32 field: forward within 1% of max|ref| + 1e-4, every gradient,
    the tables' included, within 3% of its max (bf16 matmul operands on
    both sides; the TPU kernel also rounds its hat weights to bf16, the
    port does not);
  * the optimizer within 1e-6 of max: the same update, rounded in another
    order.
"""
import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sunerf_tpu.evaluation.loader import SuNeRFLoader as JaxLoader
from sunerf_tpu.models.fields import NeRFConfig as JaxNeRFConfig
from sunerf_tpu.models.fields import init_nerf as jax_init_nerf
from sunerf_tpu.models.fields import nerf_apply as jax_nerf_apply
from sunerf_tpu.models.fields import nerf_apply_fused as jax_nerf_apply_fused
from sunerf_tpu.ops import grid_encoding as jge
from sunerf_tpu.ops.pallas.fused_mlp import (_dims_from_config, _fused_mlp_stash_bwd,
                                             _fused_mlp_stash_fwd)
from sunerf_tpu.systems import make_emission_system as jax_make_emission_system
from sunerf_tpu.train.objective import LossConfig as JaxLossConfig
from sunerf_tpu.train.objective import render_loss as jax_render_loss
from sunerf_tpu.train.objective import table_tv as jax_table_tv
from sunerf_tpu.train.optim import OptimConfig as JaxOptimConfig
from sunerf_tpu.train.optim import make_optimizer as jax_make_optimizer
from sunerf_tpu.train.step import create_train_state as jax_create_train_state
from sunerf_tpu.train.step import make_train_step as jax_make_train_step
from sunerf_tpu.utils.checkpoint import save_state as jax_save_state
from sunerf_tpu_torch.evaluation.loader import SuNeRFLoader
from sunerf_tpu_torch.models.fields import (NeRFConfig, emission_config, init_nerf,
                                            nerf_apply, nerf_apply_fused,
                                            params_from_numpy)
from sunerf_tpu_torch.ops import fused_mlp
from sunerf_tpu_torch.ops import grid_encoding as ge
from sunerf_tpu_torch.systems import make_emission_system
from sunerf_tpu_torch.train.objective import LossConfig, render_loss
from sunerf_tpu_torch.train.optim import OptimConfig, make_optimizer
from sunerf_tpu_torch.train.step import create_train_state, make_train_step

torch.set_num_threads(1)

# tests/test_fused_mlp.py:205-241's grid shapes
GRID_TINY = dict(n_layers=3, d_filter=64, n_freqs=4, grid_sizes=(8, 16), grid_features=8)
KEYS = ('w_in', 'b_in', 'w_h', 'b_h', 'w_out', 'b_out')
HIGHEST = jax.lax.Precision.HIGHEST


def _rel(ref, got) -> float:
    ref, got = np.asarray(ref, np.float64), np.asarray(got, np.float64)
    assert ref.shape == got.shape, (ref.shape, got.shape)
    return float(np.max(np.abs(ref - got)) / max(np.max(np.abs(ref)), 1e-30))


def _params(config, seed=0, table_scale=1.0) -> dict:
    """numpy params: torch.nn.Linear-style layers and U(-1, 1) * table_scale
    dense tables (the 1e-4 init times 1e4, as tests/test_fused_mlp.py makes
    the tables carry signal)."""
    rng = np.random.default_rng(seed)

    def lin(fan_in, fan_out, *lead):
        b = 1.0 / np.sqrt(fan_in)
        return (rng.uniform(-b, b, (*lead, fan_in, fan_out)).astype(np.float32),
                rng.uniform(-b, b, (*lead, fan_out)).astype(np.float32))
    w_in, b_in = lin(config.d_encoded, config.d_filter)
    w_h, b_h = lin(config.d_filter, config.d_filter, config.n_layers - 1)
    w_out, b_out = lin(config.d_filter, config.d_output)
    p = dict(w_in=w_in, b_in=b_in, w_h=w_h, b_h=b_h, w_out=w_out, b_out=b_out)
    for i, g in enumerate(config.grid_sizes):
        p[f'grid_{i}'] = (table_scale * rng.uniform(
            -1, 1, (g, g, g, config.grid_features))).astype(np.float32)
    return p


def _points(n, seed=1, lim=1.5):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-lim, lim, (n, 4)).astype(np.float32)
    pts[:, 3] = rng.uniform(0, 1, n)
    return pts


def _edge_points(bound, grid_size, seed=2) -> np.ndarray:
    """Points inside, outside and exactly on the bound, and on cell
    centres: each case in every axis."""
    rng = np.random.default_rng(seed)
    inside = rng.uniform(-bound, bound, (64, 3))
    outside = rng.uniform(-3 * bound, 3 * bound, (64, 3))
    on = rng.choice(np.array([-bound, bound]), (32, 3))
    mixed = inside[:32].copy()
    mixed[np.arange(32), rng.integers(0, 3, 32)] = rng.choice([-bound, bound], 32)
    centres = (rng.integers(0, grid_size, (32, 3)) / (grid_size - 1) * 2 - 1) * bound
    pts = np.concatenate([inside, outside, on, mixed, centres]).astype(np.float32)
    return np.concatenate([pts, np.zeros((len(pts), 1), np.float32)], axis=1)


# ------------------------------------------------------------ the encodings

@pytest.mark.parametrize('grid_size,features,bound', [(8, 4, 1.3), (16, 8, 2.0)])
def test_grid_encode_and_table_grad_match_jax(grid_size, features, bound):
    """grid_encode and its table cotangent against the JAX package's
    grid_encode at precision=HIGHEST, with an asymmetric table. Measured on
    the CPU: 1.2e-7 of max at both shapes; held to 1e-5."""
    rng = np.random.default_rng(3)
    table = rng.uniform(-1, 1, (grid_size,) * 3 + (features,)).astype(np.float32)
    pts = _edge_points(bound, grid_size)
    dfeat = rng.normal(size=(len(pts), features)).astype(np.float32)
    ref, vjp = jax.vjp(lambda t: jge.grid_encode(t, jnp.asarray(pts), bound=bound,
                                                 precision=HIGHEST, chunk=None),
                       jnp.asarray(table))
    (ref_dt,) = vjp(jnp.asarray(dfeat))
    tt = torch.from_numpy(table).requires_grad_()
    out = ge.grid_encode(tt, torch.from_numpy(pts), bound)
    out.backward(torch.from_numpy(dfeat))
    assert _rel(ref, out.detach().numpy()) < 1e-5
    assert _rel(ref_dt, tt.grad.numpy()) < 1e-5
    explicit = ge.grid_encode_table_grad(torch.from_numpy(pts), torch.from_numpy(dfeat),
                                         grid_size, bound)
    assert _rel(ref_dt, explicit.numpy()) < 1e-5
    # the axis order (y, z, x, f): a point on a cell centre reads that cell
    ix, iy, iz = 1, 2, grid_size - 1
    p = np.array([[(i / (grid_size - 1) * 2 - 1) * bound for i in (ix, iy, iz)] + [0.0]],
                 np.float32)
    np.testing.assert_allclose(ge.grid_encode(torch.from_numpy(table), torch.from_numpy(p),
                                              bound).numpy()[0],
                               table[iy, iz, ix], rtol=1e-5, atol=1e-6)


def test_vm_encodings_match_jax():
    """vm_encode and vm_encode_time against the JAX package's (HIGHEST).
    Measured on the CPU: 4.8e-8 of max; held to 1e-5."""
    rng = np.random.default_rng(4)
    planes = rng.normal(size=(3, 8, 8, 4)).astype(np.float32)
    lines = rng.normal(size=(3, 8, 4)).astype(np.float32)
    tplanes = rng.normal(size=(3, 8, 5, 4)).astype(np.float32)
    pts = _edge_points(1.3, 8)
    pts[:, 3] = rng.uniform(-0.5, 1.5, len(pts))
    ref = jge.vm_encode(jnp.asarray(planes), jnp.asarray(lines), jnp.asarray(pts),
                        bound=1.3, precision=HIGHEST, chunk=None)
    got = ge.vm_encode(torch.from_numpy(planes), torch.from_numpy(lines),
                       torch.from_numpy(pts), bound=1.3)
    assert _rel(ref, got.numpy()) < 1e-5
    ref = jge.vm_encode_time(jnp.asarray(planes), jnp.asarray(tplanes), jnp.asarray(pts),
                             bound=1.3, t_range=(0.0, 1.0), precision=HIGHEST, chunk=None)
    got = ge.vm_encode_time(torch.from_numpy(planes), torch.from_numpy(tplanes),
                            torch.from_numpy(pts), bound=1.3, t_range=(0.0, 1.0))
    assert _rel(ref, got.numpy()) < 1e-5


@pytest.mark.parametrize('extra', [dict(grid_sizes=(8, 16), grid_bound=1.3),
                                   dict(grid_sizes=(8,), grid_rank=2),
                                   dict(grid_sizes=(8,), grid_rank=2, grid_time=3)])
def test_nerf_apply_with_grids_matches_jax(extra):
    """The float32 field with grid levels against JAX nerf_apply at
    precision='highest', on JAX's own init (so the parameter keys and
    shapes agree), values from numpy (tables U(-1, 1)). Measured on the CPU:
    1.1e-6 (dense), 2.9e-7 (VM), 2.4e-7 (VM-time) of max; held to 1e-4
    (tests/test_torch_field.py's float32 figure)."""
    kw = dict(n_layers=3, d_filter=64, n_freqs=4, **extra)
    jc = JaxNeRFConfig(precision='highest', **kw)
    shapes = jax.eval_shape(lambda key: jax_init_nerf(key, jc), jax.random.key(0))
    tparams = init_nerf(torch.Generator().manual_seed(0), NeRFConfig(**kw), 'cpu')
    assert {k: tuple(v.shape) for k, v in tparams.items()} == \
        {k: v.shape for k, v in shapes.items()}
    params = _params(emission_config(**{k: v for k, v in kw.items()
                                        if not k.startswith('grid_')}), seed=14)
    rng = np.random.default_rng(15)
    params.update({k: rng.uniform(-1, 1, v.shape).astype(np.float32)
                   for k, v in shapes.items() if k.startswith('grid_')})
    params['w_in'] = rng.uniform(-0.1, 0.1, shapes['w_in'].shape).astype(np.float32)
    pts = _points(64, lim=1.6)
    ref = jax.jit(jax_nerf_apply, static_argnums=0)(
        jc, jax.tree.map(jnp.asarray, params), jnp.asarray(pts)).raw
    got = nerf_apply(NeRFConfig(**kw), params_from_numpy(params, 'cpu'),
                     torch.from_numpy(pts)).raw
    assert _rel(ref, got.numpy()) < 1e-4


# ------------------------------------------------- the kernels' plain versions

def _grid_configs():
    return JaxNeRFConfig(**GRID_TINY), NeRFConfig(**GRID_TINY)


def test_grid_plain_forward_matches_jax_kernel():
    """K0's and K1's plain versions with the grid branch against the JAX
    fused field in interpret mode (the primal is its K0) and against the
    float32 field of both packages: 1% of max + 1e-4."""
    jc, tc = _grid_configs()
    params, pts = _params(tc, seed=5), _points(50, seed=6)
    jp = jax.tree.map(jnp.asarray, params)
    tp, tpts = params_from_numpy(params, 'cpu'), torch.from_numpy(pts)
    ref_k = np.asarray(jax_nerf_apply_fused(jc, jp, jnp.asarray(pts), tile=16,
                                            bwd_tile=16, interpret=True).raw)
    ref_f32 = np.asarray(jax.jit(jax_nerf_apply, static_argnums=0)(
        jc, jp, jnp.asarray(pts)).raw)
    k0 = fused_mlp.fused_mlp_reference(tc, tp, tpts).numpy()
    k1, hs, cs = fused_mlp.fused_mlp_stash_reference(tc, tp, tpts)
    np.testing.assert_array_equal(k1.numpy(), k0)         # K1's out is K0's
    for ref in (ref_k, ref_f32):
        assert np.max(np.abs(ref - k0)) < 0.01 * np.max(np.abs(ref)) + 1e-4
    # the grid features enter the encoding after sin/cos, as JAX's XLA path
    enc = fused_mlp._encode(tc, tp, tpts)
    assert enc.shape == (50, tc.d_encoded)
    np.testing.assert_array_equal(enc[:, -8:].numpy(),
                                  ge.grid_encode(tp['grid_1'], tpts, 2.0).numpy())


def test_grid_plain_backward_matches_jax_kernel():
    """K2's plain version fed the JAX K1's own stash against JAX's K2 (grid
    branch, interpret mode): every gradient, grid_0 and grid_1 included,
    within 3% of its max (measured on the CPU: 3.7e-3 at most)."""
    jc, tc = _grid_configs()
    params, pts = _params(tc, seed=7), _points(48, seed=8)
    dy = np.random.default_rng(9).normal(size=(48, 2)).astype(np.float32)
    dims = _dims_from_config(jc)
    fwd = jax.jit(functools.partial(_fused_mlp_stash_fwd, dims, 16, 16, True, False, 'int8'))
    bwd = jax.jit(functools.partial(_fused_mlp_stash_bwd, dims, 16, 16, True, False, 'int8'))
    _, residuals = fwd(jax.tree.map(jnp.asarray, params), jnp.asarray(pts))
    dparams, _ = bwd(residuals, jnp.asarray(dy))
    _, _, hs, cs = residuals
    got = fused_mlp.fused_mlp_stash_bwd_reference(
        tc, params_from_numpy(params, 'cpu'), torch.from_numpy(pts), torch.from_numpy(dy),
        torch.from_numpy(np.asarray(hs[:48], np.float32)).to(torch.bfloat16),
        torch.from_numpy(np.array(cs[:48])))
    for k in KEYS + ('grid_0', 'grid_1'):
        assert got[k].shape == params[k].shape, k
        assert _rel(dparams[k], got[k].numpy()) < 3e-2, k


def test_grid_fused_grads_match_jax():
    """nerf_apply_fused on CPU tensors that need a gradient (FusedMLPStash
    on the plain K1 / K2, grid branch) against jax.grad of the JAX grid
    kernels in interpret mode and of the float32 field (loss mean(raw^2), as
    tests/test_fused_mlp.py:223-240): every gradient within 3% of its max
    (measured on the CPU: 1.4e-2 at most)."""
    jc, tc = _grid_configs()
    params, pts = _params(tc, seed=10), _points(48, seed=11)
    jp = jax.tree.map(jnp.asarray, params)

    def jloss(apply, **kw):
        return jax.jit(jax.grad(lambda p: jnp.mean(
            apply(jc, p, jnp.asarray(pts), **kw).raw ** 2)))(jp)
    ref_k = jloss(jax_nerf_apply_fused, stash=True, stash_tile=16, stash_bwd_tile=16,
                  interpret=True, compute_dpts=False)
    ref_f32 = jloss(jax_nerf_apply)
    tp = {k: v.requires_grad_() for k, v in params_from_numpy(params, 'cpu').items()}
    before = (fused_mlp.STASH_FWD_LAUNCHES, fused_mlp.STASH_BWD_LAUNCHES,
              fused_mlp.GRID_LAUNCHES)
    (nerf_apply_fused(tc, tp, torch.from_numpy(pts), compute_dpts=False).raw ** 2
     ).mean().backward()
    assert before == (fused_mlp.STASH_FWD_LAUNCHES, fused_mlp.STASH_BWD_LAUNCHES,
                      fused_mlp.GRID_LAUNCHES)       # the plain versions launch nothing
    for ref in (ref_k, ref_f32):
        for k in KEYS + ('grid_0', 'grid_1'):
            assert _rel(ref[k], tp[k].grad.numpy()) < 3e-2, k


def test_grid_guards():
    """As in the JAX package: grid configs take no point cotangent and the
    int8 stash only; VM levels have no fused kernel."""
    tc = NeRFConfig(n_layers=2, d_filter=64, n_freqs=2, grid_sizes=(8,), grid_features=4)
    tp = {k: v.requires_grad_() for k, v in params_from_numpy(_params(tc), 'cpu').items()}
    pts = torch.zeros(8, 4)
    with pytest.raises(NotImplementedError, match='point cotangents'):
        nerf_apply_fused(tc, tp, pts.clone().requires_grad_())
    for fmt in ('lsb', 'i8pair'):
        with pytest.raises(NotImplementedError, match='int8 stash only'):
            nerf_apply_fused(tc, tp, pts, stash_format=fmt)
    # without grid levels the other stash formats are taken (K6a, K6b), and
    # an unknown one is refused
    plain = NeRFConfig(n_layers=2, d_filter=64, n_freqs=2)
    pp = {k: v.requires_grad_() for k, v in params_from_numpy(_params(plain), 'cpu').items()}
    for fmt in ('lsb', 'i8pair'):
        out = nerf_apply_fused(plain, pp, pts, stash_format=fmt).raw
        torch.testing.assert_close(out.detach(), fused_mlp.fused_mlp_reference(plain, pp, pts),
                                   rtol=0, atol=0)
    with pytest.raises(ValueError, match='stash_format'):
        nerf_apply_fused(plain, pp, pts, stash_format='fp8')
    # the recompute backward has no table gradient
    with pytest.raises(NotImplementedError, match='stashing backward only'):
        nerf_apply_fused(tc, tp, pts, stash=False)
    vm = NeRFConfig(n_layers=2, d_filter=64, grid_sizes=(8,), grid_rank=2)
    with pytest.raises(NotImplementedError, match='grid_rank'):
        nerf_apply_fused(vm, init_nerf(torch.Generator().manual_seed(0), vm, 'cpu'), pts)
    # grid_hat_mxu is a TPU layout flag: accepted, the same field
    hat = dataclasses.replace(tc, grid_hat_mxu=True)
    with torch.no_grad():
        torch.testing.assert_close(nerf_apply_fused(hat, tp, pts).raw,
                                   nerf_apply_fused(tc, tp, pts).raw, rtol=0, atol=0)


# ------------------------------------------------ objective and optimizer

def test_table_tv_matches_jax():
    rng = np.random.default_rng(12)
    params = {'coarse': {'w_in': rng.normal(size=(4, 3)).astype(np.float32),
                         'grid_0': rng.normal(size=(8, 8, 8, 4)).astype(np.float32)},
              'fine': {'grid_0': rng.normal(size=(4, 4, 4, 2)).astype(np.float32),
                       'grid_planes_1': rng.normal(size=(3, 6, 6, 2)).astype(np.float32),
                       'grid_lines_1': rng.normal(size=(3, 6, 2)).astype(np.float32),
                       'grid_tplanes_2': rng.normal(size=(3, 6, 5, 2)).astype(np.float32)}}
    ref = float(jax.jit(jax_table_tv)(jax.tree.map(jnp.asarray, params)))
    got = ge.table_tv({f: {k: torch.from_numpy(v) for k, v in sub.items()}
                       for f, sub in params.items()})
    np.testing.assert_allclose(float(got), ref, rtol=1e-6)
    assert float(ge.table_tv({'fine': {'w_in': torch.ones(2)}})) == 0.0


def _adam_moments(state):
    for leaf in jax.tree.leaves(state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState)):
        if isinstance(leaf, optax.ScaleByAdamState):
            return leaf.mu, leaf.nu
    raise AssertionError('no Adam state')


def test_table_optimizer_recipe_matches_optax():
    """5 updates with table_lr_mult=10 and adam_eps=1e-15 against optax:
    params and moments within 1e-6 of each tensor's max. The table's
    gradients include entries of 1e-9, where eps 1e-8 would set the step
    and 1e-15 does not, and exact zeros. Measured on the CPU: 2.4e-7."""
    rng = np.random.default_rng(13)
    params = {'fine': {'w_in': rng.normal(size=(6, 5)).astype(np.float32),
                       'grid_0': rng.normal(size=(4, 4, 4, 2)).astype(np.float32)}}

    def grad(scale):
        g = {'w_in': (scale * rng.normal(size=(6, 5))).astype(np.float32),
             'grid_0': (scale * rng.normal(size=(4, 4, 4, 2))).astype(np.float32)}
        g['grid_0'][0] *= 1e-9
        g['grid_0'][1] = 0.0
        return {'fine': g}
    grads = [grad(s) for s in (10.0, 0.01, 0.01, 1.0, 0.001)]
    cfg = dict(table_lr_mult=10.0, adam_eps=1e-15)
    jopt = jax_make_optimizer(JaxOptimConfig(**cfg))
    jp = jax.tree.map(jnp.asarray, params)
    jstate = jopt.init(jp)
    jupdate = jax.jit(jopt.update)
    opt = make_optimizer(OptimConfig(**cfg))
    tp = {'fine': {k: torch.from_numpy(v.copy()).requires_grad_()
                   for k, v in params['fine'].items()}}
    adam = opt.init(tp)
    assert [g['lr_mult'] for g in adam.param_groups] == [1.0, 10.0]
    for count, g in enumerate(grads):
        updates, jstate = jupdate(jax.tree.map(jnp.asarray, g), jstate, jp)
        jp = optax.apply_updates(jp, updates)
        for k, v in tp['fine'].items():
            v.grad = torch.from_numpy(g['fine'][k].copy())
        opt.update(adam, count)
    mu, nu = _adam_moments(jstate)
    for k, v in tp['fine'].items():
        assert _rel(jp['fine'][k], v.detach().numpy()) < 1e-6, k
        assert _rel(mu['fine'][k], adam.state[v]['exp_avg'].numpy()) < 1e-6, k
        assert _rel(nu['fine'][k], adam.state[v]['exp_avg_sq'].numpy()) < 1e-6, k
    # the tables moved 10x the MLP's step: 5 steps of ~lr each
    moved = np.abs(tp['fine']['grid_0'].detach().numpy()[2:] - params['fine']['grid_0'][2:])
    assert moved.max() > 5e-4


# ------------------------------------------------------------ the train step

N_RAYS = 8
RENDER = dict(n_stratified=8, n_hierarchical=16)
STEP_GRID = dict(n_layers=3, d_filter=64, n_freqs=4, grid_sizes=(8,), grid_features=4,
                 grid_bound=1.3)
PROPOSAL = dict(n_layers=2, d_filter=64, n_freqs=4)
TV_LOSS = dict(lambda_table_tv=1e-2)
NGP_OPT = dict(table_lr_mult=10.0, adam_eps=1e-15)


def _batch(n_rays=N_RAYS, seed=42):
    """tests/test_train.py's batch: rays from (4, 0, 0) toward -x with 0.1
    normal jitter, time 0, target 0.05."""
    rng = np.random.default_rng(seed)
    rays_o = np.tile(np.array([[4.0, 0.0, 0.0]], np.float32), (n_rays, 1))
    dirs = np.array([[-1.0, 0.0, 0.0]]) + 0.1 * rng.normal(size=(n_rays, 3))
    rays_d = (dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)).astype(np.float32)
    return {'rays': np.stack([rays_o, rays_d], axis=1),
            'time': np.zeros((n_rays, 1), np.float32),
            'target_image': np.full((n_rays, 1), 0.05, np.float32)}


def _systems(use_fused: bool):
    """(JAX renderer, port renderer, numpy params): a grid fine field and a
    proposal coarse field, as bench.py's grid_quarter; the JAX fused fields
    are its K1 + K2 in interpret mode."""
    jr, _ = jax_make_emission_system(model_config=JaxNeRFConfig(**STEP_GRID),
                                     coarse_config=JaxNeRFConfig(**PROPOSAL),
                                     use_fused=False, perturb=False, **RENDER)
    if use_fused:
        kw = dict(stash=True, interpret=True, compute_dpts=False, stash_tile=8,
                  stash_bwd_tile=8)
        jr = dataclasses.replace(
            jr, field_apply=functools.partial(jax_nerf_apply_fused,
                                              JaxNeRFConfig(**STEP_GRID), **kw),
            coarse_field_apply=functools.partial(jax_nerf_apply_fused,
                                                 JaxNeRFConfig(**PROPOSAL), **kw))
    tr, _ = make_emission_system(model_config=emission_config(**STEP_GRID),
                                 coarse_config=emission_config(**PROPOSAL),
                                 use_fused=use_fused, perturb=False, device='cpu', **RENDER)
    params = {'coarse': _params(emission_config(**PROPOSAL), seed=20),
              'fine': _params(emission_config(**STEP_GRID), seed=21, table_scale=0.5)}
    return jr, tr, params


@pytest.mark.parametrize('use_fused,tol_loss,tol_grad', [(False, 1e-5, 1e-5),
                                                         (True, 1e-3, 3e-2)])
def test_grid_train_steps_match_jax(use_fused, tol_loss, tol_grad):
    """The step-1 loss (with lambda_table_tv) and gradients against JAX:
    float32 fields (1e-5: summation order), and the fused path on the plain
    K1 / K2 against JAX's interpret-mode kernels (1e-3 loss, 3e-2 grads).
    Then, on the float32 fields, 3 train steps with lambda_table_tv,
    table_lr_mult 10 and adam_eps 1e-15 against the JAX step (losses and
    table_tv within 1e-5). Measured on the CPU: float32 5.2e-7, fused
    1.4e-3 of max at most (the grads)."""
    jr, tr, params = _systems(use_fused)
    batch = _batch()
    jloss_cfg, loss_cfg = JaxLossConfig(**TV_LOSS), LossConfig(**TV_LOSS)

    def jloss(p):
        rays = jnp.asarray(batch['rays'])
        out = jr(p, rays[:, 0], rays[:, 1], jnp.asarray(batch['time']))
        return jax_render_loss(jloss_cfg, out, jnp.asarray(batch['target_image']))[0] \
            + TV_LOSS['lambda_table_tv'] * jax_table_tv(p)
    jl, jg = jax.jit(jax.value_and_grad(jloss))(jax.tree.map(jnp.asarray, params))
    tp = {f: {k: v.requires_grad_() for k, v in sub.items()}
          for f, sub in params_from_numpy(params, 'cpu').items()}
    rays = torch.from_numpy(batch['rays'])
    out = tr(tp, rays[:, 0], rays[:, 1], torch.from_numpy(batch['time']))
    loss = render_loss(loss_cfg, out, torch.from_numpy(batch['target_image']))[0] \
        + TV_LOSS['lambda_table_tv'] * ge.table_tv(tp)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=tol_loss)
    for f, sub in tp.items():
        for k, v in sub.items():
            assert _rel(jg[f][k], v.grad.numpy()) < tol_grad, (f, k)
    if use_fused:
        return

    jopt = jax_make_optimizer(JaxOptimConfig(**NGP_OPT))
    jstep = jax_make_train_step(jr, jloss_cfg, jopt, donate=False)
    jstate = jax_create_train_state(jax.tree.map(jnp.asarray, params), jopt)
    opt = make_optimizer(OptimConfig(**NGP_OPT))
    step = make_train_step(tr, loss_cfg, opt)
    state = create_train_state(params_from_numpy(params, 'cpu'), opt)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    jbatch = jax.tree.map(jnp.asarray, batch)
    for _ in range(3):
        jstate, jm = jstep(jstate, jbatch, jax.random.key(0))
        state, m = step(state, tbatch, 0)
        assert set(m) == set(jm) and 'table_tv' in m
        np.testing.assert_allclose(float(m['loss']), float(jm['loss']), rtol=1e-5)
        np.testing.assert_allclose(float(m['table_tv']), float(jm['table_tv']), rtol=1e-5)


# ------------------------------------------------------------ grid bundles

@pytest.mark.parametrize('use_fused,tol', [(False, 1e-4), (True, 3e-2)])
def test_jax_grid_bundle_renders_in_both_loaders(tmp_path, use_fused, tol):
    """A grid bundle written by the JAX package's save_state (fine/grid_0
    and the spec's grid_* fields), rendered at 8x8 by both loaders at a
    close observer: the float32 fields within 1e-4 of max, the port's
    fused path (K0's plain version, grid branch) within 3e-2 of JAX's
    interpret-mode kernel (measured on the CPU: 2.4e-6 and 1.1e-3)."""
    jr, _, params = _systems(use_fused=False)
    path = str(tmp_path / 'grid_bundle')
    jax_save_state(path, jax.tree.map(jnp.asarray, params), {'renderer_spec': jr.spec})
    spec = json.loads(open(path + '.json').read())['renderer_spec']
    assert spec['model_config']['grid_sizes'] == [8]
    view = dict(lat=0.3, lon=1.1, time=0.0, distance=3.0, resolution=8)
    jv = JaxLoader(path, batch_size=64, use_fused=use_fused).render_observer_image(**view)
    loader = SuNeRFLoader(path, batch_size=64, use_fused=use_fused, device='cpu')
    assert loader.params['fine']['grid_0'].shape == (8, 8, 8, 4)
    np.testing.assert_array_equal(loader.params['fine']['grid_0'].numpy(),
                                  params['fine']['grid_0'])
    tv = loader.render_observer_image(**view)
    for k in ('image', 'height_map', 'absorption_map'):
        assert np.isfinite(getattr(tv, k)).all(), k
        assert _rel(getattr(jv, k), getattr(tv, k)) < tol, k
