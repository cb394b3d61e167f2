"""The port's training slice (sunerf_tpu_torch: the stashing kernels' plain
versions and their autograd Function, the objective, the optimizer, the
train step) against the JAX package on the CPU.

The JAX side runs its kernels K1 (_fwd_stash_kernel) and K2
(_bwd_stash_kernel, fmt 'int8', compute_dpts=False) in interpret mode with
tiles of 8: on the CPU, fused_nerf_raw would otherwise take the recompute
backward K4 (stash defaults to `not interpret`), so every JAX field here
names stash=True explicitly.

Tolerances, each with its reason:
  * the forward out within 2e-2 of max|raw| and parameter gradients within
    3e-2 of max|grad|, as tests/test_fused_mlp.py holds the JAX kernel: both
    sides round matmul operands and dz to bf16, and single rounding flips
    compound down the layers;
  * the int8 cos stash within 1 everywhere: the two sides evaluate the cos
    polynomial with different contractions, so 127 cos lands on the other
    side of a rounding boundary at most by one, and rarely;
  * float32 paths within the figures measured and stated at each test: only
    the summation order differs.
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

from sunerf_tpu.core.scaling import image_asinh_scaling as jax_asinh_scaling
from sunerf_tpu.models.fields import NeRFConfig as JaxNeRFConfig
from sunerf_tpu.models.fields import nerf_apply_fused as jax_nerf_apply_fused
from sunerf_tpu.ops.pallas.fused_mlp import (_dims_from_config, _fused_mlp_stash_bwd,
                                             _fused_mlp_stash_fwd, fast_sincos_q,
                                             fused_nerf_raw)
from sunerf_tpu.systems import make_emission_system as jax_make_emission_system
from sunerf_tpu.train.objective import LossConfig as JaxLossConfig
from sunerf_tpu.train.objective import render_loss as jax_render_loss
from sunerf_tpu.train.optim import lr_schedule as jax_lr_schedule
from sunerf_tpu.train.optim import make_optimizer as jax_make_optimizer
from sunerf_tpu.train.step import create_train_state as jax_create_train_state
from sunerf_tpu.train.step import make_train_step as jax_make_train_step
from sunerf_tpu.utils.checkpoint import load_state as jax_load_state
from sunerf_tpu_torch.core.scaling import image_asinh_scaling, image_log_scaling
from sunerf_tpu_torch.evaluation.loader import SuNeRFLoader
from sunerf_tpu_torch.models.fields import (NeRFConfig, emission_config, nerf_apply,
                                            nerf_apply_fused, params_from_numpy)
from sunerf_tpu_torch.ops import fused_mlp
from sunerf_tpu_torch.systems import make_emission_system
from sunerf_tpu_torch.train.objective import LossConfig, render_loss
from sunerf_tpu_torch.train.optim import OptimConfig, lr_schedule, make_optimizer
from sunerf_tpu_torch.train.step import (create_train_state, make_eval_step,
                                         make_train_step, step_generator)
from sunerf_tpu_torch.utils.checkpoint import save_state

torch.set_num_threads(1)

TINY = dict(n_layers=3, d_filter=64, n_freqs=4)
PROPOSAL = dict(n_layers=4, d_filter=128)
KEYS = ('w_in', 'b_in', 'w_h', 'b_h', 'w_out', 'b_out')
# the JAX K1 + K2 path in interpret mode, tiles of 8
JAX_STASH = dict(stash=True, interpret=True, compute_dpts=False, stash_tile=8,
                 stash_bwd_tile=8)


def _rel(ref, got) -> float:
    ref, got = np.asarray(ref, np.float64), np.asarray(got, np.float64)
    assert ref.shape == got.shape, (ref.shape, got.shape)
    return float(np.max(np.abs(ref - got)) / max(np.max(np.abs(ref)), 1e-30))


def _random_params(config, seed=0) -> dict:
    rng = np.random.default_rng(seed)

    def lin(fan_in, fan_out, *lead):
        b = 1.0 / np.sqrt(fan_in)
        return (rng.uniform(-b, b, (*lead, fan_in, fan_out)).astype(np.float32),
                rng.uniform(-b, b, (*lead, fan_out)).astype(np.float32))
    w_in, b_in = lin(config.d_encoded, config.d_filter)
    w_h, b_h = lin(config.d_filter, config.d_filter, config.n_layers - 1)
    w_out, b_out = lin(config.d_filter, config.d_output)
    return dict(w_in=w_in, b_in=b_in, w_h=w_h, b_h=b_h, w_out=w_out, b_out=b_out)


def _points(n, seed=1):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1.3, 1.3, (n, 4)).astype(np.float32)
    pts[:, 3] = rng.uniform(0, 1, n)
    return pts


def _configs(width):
    kw = TINY if width == 'tiny' else PROPOSAL
    return JaxNeRFConfig(**kw), NeRFConfig(**kw)


def _bf16_to_torch(x) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)


# ------------------------------------------------------------ the stash kernels

def test_sin_and_int8_cos_match_fast_sincos_q():
    """The plain version's (sin, int8 cos) of the kernels' range-reduced
    argument against JAX fast_sincos_q over [-400, 400] rad."""
    x = np.linspace(-400, 400, 200001, dtype=np.float32)
    s_ref, c_ref = (np.asarray(v) for v in fast_sincos_q(jnp.asarray(x)))
    y = fused_mlp._reduce(torch.from_numpy(x))
    s, c = torch.sin(y).numpy(), fused_mlp.cos8_quantized(y).numpy()
    assert c.dtype == np.int8 and c_ref.dtype == np.int8
    diff = np.abs(c.astype(np.int32) - c_ref.astype(np.int32))
    off_by_one = int(np.sum(diff == 1))
    print(f'int8 cos: {off_by_one} of {x.size} entries differ by 1')
    assert diff.max() <= 1
    assert off_by_one <= 20                     # measured: 0
    # torch.sin against the 11th-order polynomial on the same reduced y
    assert np.max(np.abs(s - s_ref)) < 2e-6


@pytest.mark.parametrize('width', ['tiny', 'proposal'])
def test_stash_forward_reference_matches_jax_kernel(width):
    jc, tc = _configs(width)
    params, pts = _random_params(tc, seed=3), _points(48)
    out_j, (_, _, hs_j, cs_j) = _fused_mlp_stash_fwd(
        _dims_from_config(jc), 8, 8, True, False, 'int8',
        jax.tree.map(jnp.asarray, params), jnp.asarray(pts))
    tp, tpts = params_from_numpy(params, 'cpu'), torch.from_numpy(pts)
    out, hs, cs = fused_mlp.fused_mlp_stash_reference(tc, tp, tpts)
    n, lh = pts.shape[0], tc.n_layers * tc.d_filter
    assert hs.shape == (n, lh) and hs.dtype == torch.bfloat16
    assert cs.shape == (n, lh) and cs.dtype == torch.int8
    assert _rel(out_j, out.numpy()) < 2e-2
    # the sin stash: bf16 on both sides; an operand flip upstream moves a
    # value by a bf16 ulp or more, so hold it to 2e-2 of max like out
    assert _rel(np.asarray(hs_j[:n], np.float32), hs.float().numpy()) < 2e-2
    assert np.max(np.abs(np.asarray(cs_j[:n], np.int32) - cs.int().numpy())) <= 1
    # the forward output is K0's, bit for bit
    torch.testing.assert_close(out, fused_mlp.fused_mlp_reference(tc, tp, tpts),
                               rtol=0, atol=0)


@pytest.mark.parametrize('width', ['tiny', 'proposal'])
def test_stash_backward_reference_matches_jax_kernel(width):
    """Both backwards fed JAX's own stash, so the check isolates K2."""
    jc, tc = _configs(width)
    params, pts = _random_params(tc, seed=5), _points(48, seed=6)
    dy = np.random.default_rng(7).normal(size=(48, 2)).astype(np.float32)
    dims = _dims_from_config(jc)
    jparams = jax.tree.map(jnp.asarray, params)
    _, residuals = _fused_mlp_stash_fwd(dims, 8, 8, True, False, 'int8', jparams,
                                        jnp.asarray(pts))
    dparams, dpts = _fused_mlp_stash_bwd(dims, 8, 8, True, False, 'int8', residuals,
                                         jnp.asarray(dy))
    assert not np.any(np.asarray(dpts))          # compute_dpts=False: zeros
    _, _, hs_j, cs_j = residuals
    got = fused_mlp.fused_mlp_stash_bwd_reference(
        tc, params_from_numpy(params, 'cpu'), torch.from_numpy(pts),
        torch.from_numpy(dy), _bf16_to_torch(hs_j[:48]),
        torch.from_numpy(np.array(cs_j[:48])))
    for k in KEYS:
        assert _rel(dparams[k], got[k].numpy()) < 3e-2, k


def _loss_dy(n, seed=8):
    return np.random.default_rng(seed).normal(size=(n, 2)).astype(np.float32)


def test_fused_field_grads_under_autograd():
    """nerf_apply_fused on CPU tensors that need a gradient is the Function
    on the plain versions: its parameter gradients against jax.grad of the
    JAX K1 + K2 path (loss sum(raw * dy) and mean(raw^2)) and against the
    port's float32 nerf_apply (loss mean(raw^2), as tests/test_fused_mlp.py
    holds the JAX kernel to its float32 field: under sum(raw * dy) with
    random dy the bias gradients cancel, and the JAX kernel itself lies 3.3%
    of max from its float32 field on b_in)."""
    jc, tc = _configs('tiny')
    params, pts, dy = _random_params(tc, seed=9), _points(200, seed=10), _loss_dy(200)
    losses = {'dy': (lambda r: jnp.sum(r * dy), lambda r: (r * torch.from_numpy(dy)).sum()),
              'msq': (lambda r: jnp.mean(r ** 2), lambda r: (r ** 2).mean())}

    def port_grads(apply, loss, **kw):
        tp = {k: v.requires_grad_() for k, v in params_from_numpy(params, 'cpu').items()}
        loss(apply(tc, tp, torch.from_numpy(pts), **kw).raw).backward()
        return {k: tp[k].grad for k in KEYS}

    before = (fused_mlp.LAUNCHES, fused_mlp.STASH_FWD_LAUNCHES,
              fused_mlp.STASH_BWD_LAUNCHES)
    for name, (jloss, tloss) in losses.items():
        jgrads = jax.grad(lambda p: jloss(
            fused_nerf_raw(jc, p, jnp.asarray(pts), **JAX_STASH)))(
                jax.tree.map(jnp.asarray, params))
        fused = port_grads(nerf_apply_fused, tloss, compute_dpts=False)
        for k in KEYS:
            assert _rel(jgrads[k], fused[k].numpy()) < 3e-2, (name, k)
    # the plain versions launch nothing
    assert before == (fused_mlp.LAUNCHES, fused_mlp.STASH_FWD_LAUNCHES,
                      fused_mlp.STASH_BWD_LAUNCHES)
    f32 = port_grads(nerf_apply, losses['msq'][1])
    for k in KEYS:
        assert _rel(f32[k], fused[k]) < 3e-2, k

    tp = {k: v.requires_grad_() for k, v in params_from_numpy(params, 'cpu').items()}
    # points that need a gradient get K3's (plain version), within the 5%
    # tests/test_fused_mlp.py:85 holds the JAX kernel's to, of the float32
    # field's under mean(raw^2)
    x, x32 = (torch.from_numpy(pts).requires_grad_() for _ in range(2))
    (nerf_apply_fused(tc, tp, x).raw ** 2).mean().backward()
    (nerf_apply(tc, tp, x32).raw ** 2).mean().backward()
    assert _rel(x32.grad, x.grad) < 5e-2
    # points that need a gradient, with compute_dpts=False: they get none
    x = torch.from_numpy(pts).requires_grad_()
    nerf_apply_fused(tc, tp, x, compute_dpts=False).raw.sum().backward()
    assert x.grad is None and tp['w_in'].grad is not None
    # without a gradient the fused field is K0's plain version
    with torch.no_grad():
        torch.testing.assert_close(
            nerf_apply_fused(tc, tp, torch.from_numpy(pts)).raw,
            fused_mlp.fused_mlp_reference(tc, tp, torch.from_numpy(pts)),
            rtol=0, atol=0)


# ------------------------------------------------------------ objective, optimizer

def test_render_loss_and_scalings_match_jax():
    rng = np.random.default_rng(11)
    outputs = {'coarse_image': rng.uniform(0, 0.3, (16, 1)).astype(np.float32),
               'fine_image': rng.uniform(0, 0.3, (16, 1)).astype(np.float32),
               'regularization': rng.uniform(0, 0.1, (16, 24)).astype(np.float32)}
    target = rng.uniform(0, 0.3, (16, 1)).astype(np.float32)
    for kw in ({}, dict(lambda_image=2.0, lambda_regularization=0.5,
                        image_scaling='none')):
        loss_j, m_j = jax_render_loss(JaxLossConfig(**kw),
                                      jax.tree.map(jnp.asarray, outputs),
                                      jnp.asarray(target))
        loss, m = render_loss(LossConfig(**kw),
                              {k: torch.from_numpy(v) for k, v in outputs.items()},
                              torch.from_numpy(target))
        assert set(m) == set(m_j)
        np.testing.assert_allclose(float(loss), float(loss_j), rtol=1e-6)
        for k in m:
            np.testing.assert_allclose(float(m[k]), float(m_j[k]), rtol=1e-6, err_msg=k)
    img = rng.uniform(0, 2, 1000).astype(np.float32)
    np.testing.assert_allclose(
        image_asinh_scaling(torch.from_numpy(img), vmax=1.5, a=0.01).numpy(),
        np.asarray(jax_asinh_scaling(jnp.asarray(img), vmax=1.5, a=0.01)), rtol=1e-6)
    np.testing.assert_allclose(
        image_log_scaling(torch.from_numpy(img + 0.1), vmin=-3.0, vmax=1.0).numpy(),
        (np.log(img + 0.1) + 3.0) / 4.0, rtol=1e-6)
    # the table TV term is ported (tests/test_torch_grid.py holds it to JAX)
    assert LossConfig(lambda_table_tv=0.1).lambda_table_tv == 0.1


def test_lr_schedule_matches_jax():
    """The schedule as the JAX optimizer evaluates it, inside jit with an
    int32 count (float32 gamma and power)."""
    sched, ref = lr_schedule(OptimConfig()), jax.jit(jax_lr_schedule())
    for step in (0, 1, 10 ** 3, 10 ** 6, 5 * 10 ** 6):
        np.testing.assert_allclose(sched(step), float(ref(jnp.int32(step))),
                                   rtol=1e-6, err_msg=str(step))
    assert sched(5 * 10 ** 6) == pytest.approx(5e-5)
    # the grid-table recipe leaves the schedule as it is (the multiplier
    # scales the tables' updates: tests/test_torch_grid.py)
    ngp = lr_schedule(OptimConfig(table_lr_mult=10.0, adam_eps=1e-15))
    assert all(ngp(step) == sched(step) for step in (0, 1000))


def _adam_moments(state):
    """(mu, nu) of optax's ScaleByAdamState inside a chained optimizer state."""
    for leaf in jax.tree.leaves(state, is_leaf=lambda s: isinstance(
            s, optax.ScaleByAdamState)):
        if isinstance(leaf, optax.ScaleByAdamState):
            return leaf.mu, leaf.nu
    raise AssertionError('no Adam state')


@pytest.mark.parametrize('grad_scale', [10.0, 0.01])
def test_optimizer_matches_optax(grad_scale):
    """3 updates of make_optimizer() on fixed gradients whose global norm is
    above (10.0) or below (0.01) the 0.5 clip, against optax: params and
    moments within 1e-6 of each tensor's max (only the rounding of the
    update's arithmetic differs)."""
    rng = np.random.default_rng(12)
    params = {'a': rng.normal(size=(6, 5)).astype(np.float32),
              'b': rng.normal(size=(5,)).astype(np.float32)}
    grads = [{k: (grad_scale * rng.normal(size=v.shape) / np.sqrt(v.size)).astype(np.float32)
              for k, v in params.items()} for _ in range(3)]
    jopt = jax_make_optimizer()
    jp = jax.tree.map(jnp.asarray, params)
    jstate = jopt.init(jp)
    opt = make_optimizer()
    tp = {k: torch.from_numpy(v.copy()).requires_grad_() for k, v in params.items()}
    adam = opt.init(tp)
    for count, g in enumerate(grads):
        updates, jstate = jopt.update(jax.tree.map(jnp.asarray, g), jstate, jp)
        jp = optax.apply_updates(jp, updates)
        for k in tp:
            tp[k].grad = torch.from_numpy(g[k].copy())
        norm = opt.update(adam, count)
        gnorm = np.sqrt(sum(np.sum(v.astype(np.float64) ** 2) for v in g.values()))
        np.testing.assert_allclose(float(norm), gnorm, rtol=1e-6)
    mu, nu = _adam_moments(jstate)
    for k in tp:
        assert _rel(jp[k], tp[k].detach().numpy()) < 1e-6, k
        assert _rel(mu[k], adam.state[tp[k]]['exp_avg'].numpy()) < 1e-6, k
        assert _rel(nu[k], adam.state[tp[k]]['exp_avg_sq'].numpy()) < 1e-6, k


# ------------------------------------------------------------ the train step

N_RAYS = 8
RENDER = dict(n_stratified=8, n_hierarchical=16)


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


def _systems(use_fused: bool, perturb=False):
    """(JAX renderer, port renderer, numpy params) at TINY for both fields.
    The JAX fused renderer's fields are K1 + K2 in interpret mode."""
    jr, _ = jax_make_emission_system(model_config=JaxNeRFConfig(**TINY),
                                     use_fused=False, perturb=perturb, **RENDER)
    if use_fused:
        apply = functools.partial(jax_nerf_apply_fused, JaxNeRFConfig(**TINY), **JAX_STASH)
        jr = dataclasses.replace(jr, field_apply=apply, coarse_field_apply=apply)
    tr, _ = make_emission_system(model_config=emission_config(**TINY),
                                 use_fused=use_fused, perturb=perturb, device='cpu',
                                 **RENDER)
    cfg = emission_config(**TINY)
    params = {'coarse': _random_params(cfg, seed=20), 'fine': _random_params(cfg, seed=21)}
    return jr, tr, params


def _step1_grads(jr, tr, params, batch):
    """Gradients of renderer + render_loss at the params, both packages."""
    def jloss(p):
        rays = jnp.asarray(batch['rays'])
        out = jr(p, rays[:, 0], rays[:, 1], jnp.asarray(batch['time']))
        return jax_render_loss(JaxLossConfig(), out, jnp.asarray(batch['target_image']))[0]
    jl, jg = jax.value_and_grad(jloss)(jax.tree.map(jnp.asarray, params))
    tp = {f: {k: v.requires_grad_() for k, v in sub.items()}
          for f, sub in params_from_numpy(params, 'cpu').items()}
    rays = torch.from_numpy(batch['rays'])
    out = tr(tp, rays[:, 0], rays[:, 1], torch.from_numpy(batch['time']))
    loss, _ = render_loss(LossConfig(), out, torch.from_numpy(batch['target_image']))
    loss.backward()
    return float(jl), jg, float(loss.detach()), {f: {k: v.grad for k, v in sub.items()}
                                         for f, sub in tp.items()}


def _run_steps(jr, tr, params, batch, n_steps):
    jopt, opt = jax_make_optimizer(), make_optimizer()
    jstep = jax_make_train_step(jr, JaxLossConfig(), jopt, donate=False)
    jstate = jax_create_train_state(jax.tree.map(jnp.asarray, params), jopt)
    step = make_train_step(tr, LossConfig(), opt)
    state = create_train_state(params_from_numpy(params, 'cpu'), opt)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    jbatch = jax.tree.map(jnp.asarray, batch)
    jlosses, losses = [], []
    for _ in range(n_steps):
        jstate, jm = jstep(jstate, jbatch, jax.random.key(0))
        state, m = step(state, tbatch, 0)
        assert set(m) == set(jm)
        jlosses.append(float(jm['loss']))
        losses.append(float(m['loss']))
    assert state.step == n_steps
    return np.array(jlosses), np.array(losses), jstate.params, state.params


def test_train_step_float32_matches_jax():
    """use_fused=False, perturb off, TINY, 8 rays, 8+16 samples. Measured on
    the CPU: the 10 losses agree to 3.9e-7 relative, the step-1 grads to
    4.0e-7 of max, the params after 10 steps to 3.1e-6 of max (Adam divides
    by the root of small second moments); held to 1e-5, 1e-5 and 1e-4:
    float32 sums in another order, compounding through the hierarchical
    resample and ten updates."""
    jr, tr, params = _systems(use_fused=False)
    batch = _batch()
    jl, jg, tl, tg = _step1_grads(jr, tr, params, batch)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    for f in ('coarse', 'fine'):
        for k in KEYS:
            assert _rel(jg[f][k], tg[f][k].numpy()) < 1e-5, (f, k)
    jlosses, losses, jp, tp = _run_steps(jr, tr, params, batch, 10)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    assert losses[-1] < losses[0]
    for f in ('coarse', 'fine'):
        for k in KEYS:
            assert _rel(jp[f][k], tp[f][k].detach().numpy()) < 1e-4, (f, k)


def test_train_step_fused_matches_jax():
    """use_fused=True on CPU tensors (the Function on the plain K1 / K2)
    against JAX with K1 + K2 in interpret mode: the loss and the step-1
    grads (Adam's first update is ~lr * sign(g), which hides a gradient's
    size, so grads are compared and not params). Measured on the CPU: loss
    1.3e-6 relative, grads 5.3e-4 of max, 3 step losses 1.6e-6; held to the
    kernels' 1e-3 and 3e-2 (bf16 flips in either kernel's sums)."""
    jr, tr, params = _systems(use_fused=True)
    batch = _batch()
    jl, jg, tl, tg = _step1_grads(jr, tr, params, batch)
    np.testing.assert_allclose(tl, jl, rtol=1e-3)
    for f in ('coarse', 'fine'):
        for k in KEYS:
            assert _rel(jg[f][k], tg[f][k].numpy()) < 3e-2, (f, k)
    jlosses, losses, _, _ = _run_steps(jr, tr, params, batch, 3)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-3)


def test_train_save_serve(tmp_path):
    """3 port steps on the CPU with perturbation, save_state, then the
    port's loader renders the trained bundle and the JAX package reads it."""
    _, tr, params = _systems(use_fused=True, perturb=True)
    opt = make_optimizer()
    step = make_train_step(tr, LossConfig(), opt)
    state = create_train_state(params_from_numpy(params, 'cpu'), opt)
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    for _ in range(3):
        state, m = step(state, batch, 1)
        assert all(np.isfinite(float(v)) for v in m.values())
    # the input params are copied, not updated
    np.testing.assert_array_equal(params['fine']['w_in'], _random_params(
        emission_config(**TINY), seed=21)['w_in'])
    path = str(tmp_path / 'trained')
    save_state(path, state.params, {'renderer_spec': tr.spec})
    view = SuNeRFLoader(path, device='cpu').render_observer_image(
        lat=0.3, lon=1.1, time=0.0, distance=3.0, resolution=8)
    assert view.image.shape == (8, 8, 1) and np.isfinite(view.image).all()
    jparams, jconfig = jax_load_state(path)
    assert jconfig == json.loads(json.dumps({'renderer_spec': tr.spec}))
    for f in ('coarse', 'fine'):
        for k in KEYS:
            np.testing.assert_array_equal(jparams[f][k],
                                          state.params[f][k].detach().numpy())
    # the eval step renders without gradients (the fused path's K0)
    out = make_eval_step(tr)(state.params, batch)
    assert out['image'].grad_fn is None and out['image'].shape == (N_RAYS, 1)


def test_step_rejects_what_is_not_ported(tmp_path):
    """donate=True raises. mesh and microbatch, which raised here before,
    run (tests/test_torch_parallel.py holds them against JAX): on the fused
    path (the plain K1 / K2 on the CPU) a one-rank mesh, gloo in this
    process, gives the single-device step's bits and the eval step's, and
    microbatch 4 makes one update of two chunks of the 8 rays. The spike
    guard and EMA are ported (tests/test_torch_trainer.py holds them against
    JAX), and need a state made with their leaves."""
    from datetime import timedelta
    from sunerf_tpu_torch.parallel.mesh import make_mesh
    tr = make_emission_system(model_config=emission_config(**TINY), device='cpu')[0]
    opt = make_optimizer()
    with pytest.raises(NotImplementedError, match='in place'):
        make_train_step(tr, LossConfig(), opt, donate=True)
    _, fused, pair = _systems(use_fused=True)
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}

    def one_step(**kw):
        state = create_train_state(params_from_numpy(pair, 'cpu'), opt)
        return make_train_step(fused, LossConfig(), opt, **kw)(state, batch, 3)

    single, m_single = one_step()
    mesh = make_mesh(devices=['cpu'], init_method=f'file://{tmp_path}/store', rank=0,
                     world_size=1, timeout=timedelta(seconds=60))
    try:
        meshed, m_mesh = one_step(mesh=mesh)
        out_mesh = make_eval_step(fused, mesh=mesh)(single.params, batch)
    finally:
        torch.distributed.destroy_process_group()
    assert torch.equal(m_mesh['loss'], m_single['loss'])
    for f in ('coarse', 'fine'):
        for k in KEYS:
            assert torch.equal(meshed.params[f][k], single.params[f][k]), (f, k)
    out = make_eval_step(fused)(single.params, batch)
    for k in ('image', 'height_map', 'absorption_map'):
        assert torch.equal(out_mesh[k], out[k]), k
    micro, m_micro = one_step(microbatch=4)
    assert micro.updates == 1 and np.isfinite(float(m_micro['loss']))
    params = params_from_numpy(_random_params(emission_config(**TINY)), 'cpu')
    state = create_train_state({'fine': params}, opt, spike_guard=True, ema=True)
    # the snapshot and the average are copies, never aliases of the params
    for copy in (state.snapshot.params['fine']['w_in'], state.ema_params['fine']['w_in']):
        assert torch.equal(copy, state.params['fine']['w_in'])
        assert copy.data_ptr() != state.params['fine']['w_in'].data_ptr()
    plain = create_train_state({'fine': params}, opt)
    assert plain.snapshot is None and plain.ema_params is None
    a = torch.rand(4, generator=step_generator(3, 5, 'cpu'))
    b = torch.rand(4, generator=step_generator(3, 5, 'cpu'))
    c = torch.rand(4, generator=step_generator(3, 6, 'cpu'))
    assert torch.equal(a, b) and not torch.equal(a, c)
