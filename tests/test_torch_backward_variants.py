"""The port's other backward paths of the fused field (sunerf_tpu_torch/ops/
fused_mlp.py: the point cotangent K3, the recompute backward K4, the 'lsb'
and 'i8pair' stashes K6a and K6b) against the JAX package on the CPU.

The port runs its plain versions (CPU tensors); the JAX side runs its Pallas
kernels in interpret mode with tiles of 8 (stash_bwd_tile=8 in the port for
i8pair), jitted. Inputs come from numpy seeds; torch runs at one thread.

Tolerances, as fractions of max|JAX|, each with its reason:
  * the polynomials and the lsb pack/unpack: bit for bit against the JAX
    functions run op by op (jit contracts the polynomials into fused
    multiply-adds, which the kernels' plain versions do not repeat);
  * stashes fed the same upstream activations: int8 within 1, bf16 within
    1 ulp, the lsb sign bit exact away from |cos| < 1e-3 (the two sides
    round the pre-activation's sum in another order);
  * outputs and parameter gradients 2e-2, as the plain version is held to
    the JAX kernel elsewhere; point gradients 5e-2
    (tests/test_fused_mlp.py:85); i8pair gradients 6e-2 (:163), whose dz
    quantization step moves with any flip of the group's max.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sunerf_tpu.models.fields import NeRFConfig as JaxNeRFConfig
from sunerf_tpu.models.fields import nerf_apply_fused as jax_nerf_apply_fused
from sunerf_tpu.ops.pallas import fused_mlp as jfm
from sunerf_tpu.systems import make_emission_system as jax_make_emission_system
from sunerf_tpu.train.objective import LossConfig as JaxLossConfig
from sunerf_tpu.train.objective import render_loss as jax_render_loss
from sunerf_tpu_torch.models.fields import (NeRFConfig, nerf_apply_fused,
                                            params_from_numpy)
from sunerf_tpu_torch.ops import fused_mlp
from sunerf_tpu_torch.rendering.emission import EmissionHead
from sunerf_tpu_torch.rendering.renderer import Renderer
from sunerf_tpu_torch.scripts import bench_kernel
from sunerf_tpu_torch.train.objective import LossConfig
from sunerf_tpu_torch.train.optim import make_optimizer
from sunerf_tpu_torch.train.step import create_train_state, make_train_step

torch.set_num_threads(1)

TINY = dict(n_layers=3, d_filter=64, n_freqs=4)
KEYS = ('w_in', 'b_in', 'w_h', 'b_h', 'w_out', 'b_out')
N = 48
# the JAX kernels in interpret mode, tiles of 8
JAX_TILES = dict(interpret=True, tile=8, bwd_tile=8, stash_tile=8, stash_bwd_tile=8)
GRAD_TOL = {'int8': 2e-2, 'lsb': 2e-2, 'i8pair': 6e-2, 'recompute': 2e-2}
DPTS_TOL = 5e-2


def _rel(ref, got) -> float:
    ref, got = np.asarray(ref, np.float64), np.asarray(got, np.float64)
    assert ref.shape == got.shape, (ref.shape, got.shape)
    return float(np.max(np.abs(ref - got)) / max(np.max(np.abs(ref)), 1e-30))


def _params(config, seed=0) -> dict:
    rng = np.random.default_rng(seed)

    def lin(fan_in, fan_out, *lead):
        b = 1.0 / np.sqrt(fan_in)
        return (rng.uniform(-b, b, (*lead, fan_in, fan_out)).astype(np.float32),
                rng.uniform(-b, b, (*lead, fan_out)).astype(np.float32))
    w_in, b_in = lin(config.d_encoded, config.d_filter)
    w_h, b_h = lin(config.d_filter, config.d_filter, config.n_layers - 1)
    w_out, b_out = lin(config.d_filter, config.d_output)
    return dict(w_in=w_in, b_in=b_in, w_h=w_h, b_h=b_h, w_out=w_out, b_out=b_out)


def _points(n=N, seed=1):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1.3, 1.3, (n, 4)).astype(np.float32)
    pts[:, 3] = rng.uniform(0, 1, n)
    return pts


def _setup(seed=0):
    jc, tc = JaxNeRFConfig(**TINY), NeRFConfig(**TINY)
    params = _params(tc, seed)
    pts = _points(seed=seed + 1)
    dy = np.random.default_rng(seed + 2).normal(size=(N, 2)).astype(np.float32)
    return jc, tc, params, pts, dy


def _bf16(x) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)


def _stash_to_torch(fmt, hs, n=N):
    hs = np.asarray(hs)[:n]
    return _bf16(hs) if fmt in ('int8', 'lsb') else torch.from_numpy(np.array(hs))


@functools.lru_cache(maxsize=None)
def _jax_stash(fmt, seed=0):
    """JAX's stashing forward at TINY: (out, hs, cs) as numpy, rows past N
    dropped."""
    jc, _, params, pts, _ = _setup(seed)
    out, (_, _, hs, cs) = jax.jit(
        lambda p, x: jfm._fused_mlp_stash_fwd(jfm._dims_from_config(jc), 8, 8, True, False,
                                              fmt, p, x))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(pts))
    return (np.asarray(out), np.asarray(hs)[:N],
            None if cs is None else np.asarray(cs)[:N])


# ------------------------------------------------------------ polynomials, packing

def test_polynomials_and_lsb_packing_match_jax_bit_for_bit():
    x = np.linspace(-400, 400, 400001, dtype=np.float32)
    tx = torch.from_numpy(x)
    s_j, c_j = jfm.fast_sincos(jnp.asarray(x))
    s, c = fused_mlp.fast_sincos(tx)
    np.testing.assert_array_equal(s.numpy().view(np.uint32), np.asarray(s_j).view(np.uint32))
    np.testing.assert_array_equal(c.numpy().view(np.uint32), np.asarray(c_j).view(np.uint32))
    s_j, n_j = jfm.fast_sin_csign(jnp.asarray(x))
    s, neg = fused_mlp.fast_sin_csign(tx)
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_j))
    np.testing.assert_array_equal(neg.numpy(), np.asarray(n_j))
    packed_j = jfm._pack_sin_csign(s_j.astype(jnp.bfloat16), n_j)
    packed = fused_mlp.pack_sin_csign(s, neg)
    np.testing.assert_array_equal(packed.view(torch.int16).numpy(),
                                  np.asarray(packed_j).view(np.int16))
    _, cos_j = jfm._unpack_sin_cos(packed_j)
    _, cos = fused_mlp.unpack_sin_cos(packed)
    np.testing.assert_array_equal(cos.view(torch.int16).numpy(),
                                  np.asarray(cos_j).view(np.int16))
    # the sign round-trips (as the sign bit: cos is -0.0 where bf16 sin is
    # +-1) wherever cos is not ~0
    c64 = np.cos(x.astype(np.float64))
    away = np.abs(c64) > 1e-3
    assert np.array_equal(torch.signbit(cos.float()).numpy()[away], c64[away] < 0)


# ------------------------------------------------------------ the stashes

@pytest.mark.parametrize('fmt', ['int8', 'lsb', 'i8pair'])
def test_stash_matches_jax_kernel(fmt):
    """Each format's stash against _fused_mlp_stash_fwd's, the port's layers
    fed JAX's own bf16 activations (its int8 run's sin stash: every format
    feeds the next layer the same bf16 sine)."""
    _, tc, params, pts, _ = _setup()
    out_j, hs_j, _ = _jax_stash(fmt)
    _, act_j, _ = _jax_stash('int8')
    tp, tpts = params_from_numpy(params, 'cpu'), torch.from_numpy(pts)
    out, hs, cs = fused_mlp.fused_mlp_stash_reference(tc, tp, tpts, fmt)
    assert _rel(out_j[:N], out.numpy()) < 2e-2
    lw, lw_cs = fused_mlp.fused_mlp_stash_layerwise(tc, tp, tpts, _bf16(act_j), fmt)
    assert hs.shape == lw.shape and hs.dtype == lw.dtype
    if fmt == 'i8pair':
        assert lw.shape == (N, 2 * 3 * 64) and lw_cs is None
        assert np.max(np.abs(lw.int().numpy() - hs_j.astype(np.int32))) <= 1
        return
    got = lw.float().numpy()
    ref = hs_j.astype(np.float32)
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(ref), 2.0 ** -126))) - 7)
    if fmt == 'int8':
        assert np.max(np.abs(got - ref) / ulp) <= 1
        assert np.max(np.abs(lw_cs.int().numpy() - np.asarray(_jax_stash('int8')[2], np.int32))) <= 1
        return
    # lsb: the packed values within 1 ulp of the sine (the last bit aside),
    # the sign bit exact away from |cos| ~ 0
    bits, bits_j = lw.view(torch.int16).numpy(), hs_j.view(np.int16)
    assert np.max(np.abs((bits & -2).astype(np.int32) - (bits_j & -2))) <= 2
    sign_off = (bits & 1) != (bits_j & 1)
    y = fused_mlp._reduce(fused_mlp._mm(fused_mlp._encode(tc, tp, tpts), tp['w_in']) + tp['b_in'])
    print(f'lsb: {int(sign_off.sum())} of {sign_off.size} sign bits differ')
    assert not np.any(sign_off[:, :64] & (np.abs(np.cos(y.numpy())) > 1e-3))


# ------------------------------------------------------------ the backwards

def _port_grads(tc, params, pts, dy, fmt, hs, cs, compute_dpts, group=8):
    return fused_mlp.fused_mlp_stash_bwd_reference(
        tc, params_from_numpy(params, 'cpu'), torch.from_numpy(pts), torch.from_numpy(dy),
        hs, cs, fmt, compute_dpts, group)


@pytest.mark.parametrize('fmt', ['int8', 'lsb', 'i8pair'])
def test_stash_backward_with_point_cotangent_matches_jax_kernel(fmt):
    """K2 / K6a / K6b with K3 (compute_dpts=True), both sides fed JAX's own
    stash so the check isolates the backward."""
    jc, tc, params, pts, dy = _setup(seed=3)
    dims = jfm._dims_from_config(jc)
    jp = jax.tree.map(jnp.asarray, params)
    fwd = jax.jit(lambda p, x: jfm._fused_mlp_stash_fwd(dims, 8, 8, True, True, fmt, p, x))
    _, residuals = fwd(jp, jnp.asarray(pts))
    bwd = jax.jit(lambda r, g: jfm._fused_mlp_stash_bwd(dims, 8, 8, True, True, fmt, r, g))
    dparams, dpts = bwd(residuals, jnp.asarray(dy))
    _, _, hs_j, cs_j = residuals
    got = _port_grads(tc, params, pts, dy, fmt, _stash_to_torch(fmt, hs_j),
                      None if cs_j is None else torch.from_numpy(np.array(cs_j)[:N]), True)
    for k in KEYS:
        assert _rel(dparams[k], got[k].numpy()) < GRAD_TOL[fmt], (fmt, k)
    assert _rel(dpts, got['dpts'].numpy()) < DPTS_TOL
    # K3 only adds an output: the same parameter gradients without it
    without = _port_grads(tc, params, pts, dy, fmt, _stash_to_torch(fmt, hs_j),
                          None if cs_j is None else torch.from_numpy(np.array(cs_j)[:N]), False)
    assert 'dpts' not in without
    for k in KEYS:
        assert torch.equal(without[k], got[k]), k


def test_recompute_backward_matches_jax_kernel():
    """K4 (_bwd_kernel): parameter gradients and dpts."""
    jc, tc, params, pts, dy = _setup(seed=4)
    dims = jfm._dims_from_config(jc)
    jp = jax.tree.map(jnp.asarray, params)
    dparams, dpts = jax.jit(lambda p, x, g: jfm._fused_mlp_bwd(dims, 8, 8, True, (p, x), g))(
        jp, jnp.asarray(pts), jnp.asarray(dy))
    got = fused_mlp.fused_mlp_recompute_bwd_reference(
        tc, params_from_numpy(params, 'cpu'), torch.from_numpy(pts), torch.from_numpy(dy))
    for k in KEYS:
        assert _rel(dparams[k], got[k].numpy()) < GRAD_TOL['recompute'], k
    assert _rel(dpts, got['dpts'].numpy()) < DPTS_TOL


def test_i8pair_gradients_depend_on_the_group():
    """The i8pair dW_h quantizes dz per group of stash_bwd_tile points: 8 and
    16 give different gradients, and each matches JAX's at the same tile."""
    jc, tc, params, pts, dy = _setup(seed=5)
    dims = jfm._dims_from_config(jc)
    jp = jax.tree.map(jnp.asarray, params)
    _, residuals = jax.jit(lambda p, x: jfm._fused_mlp_stash_fwd(
        dims, 16, 16, True, False, 'i8pair', p, x))(jp, jnp.asarray(pts))
    hs = _stash_to_torch('i8pair', residuals[2])
    port, ref = {}, {}
    for group in (8, 16):
        ref[group] = jax.jit(lambda r, g, t=group: jfm._fused_mlp_stash_bwd(
            dims, 16, t, True, False, 'i8pair', r, g))(residuals, jnp.asarray(dy))[0]['w_h']
        port[group] = _port_grads(tc, params, pts, dy, 'i8pair', hs, None, False,
                                  group)['w_h'].numpy()
    def rms(a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        return float(np.sqrt(np.mean((a - b) ** 2) / np.mean(a ** 2)))

    assert _rel(port[16], port[8]) > 1e-3
    for group, other in ((8, 16), (16, 8)):
        own, cross = rms(ref[group], port[group]), rms(ref[other], port[group])
        print(f'i8pair group {group}: RMS vs JAX at the same tile {own:.2e}, at the '
              f'other {cross:.2e}; max vs JAX {_rel(ref[group], port[group]):.2e}')
        assert _rel(ref[group], port[group]) < GRAD_TOL['i8pair'] and own < cross
    # the other gradients do not depend on it
    g8 = _port_grads(tc, params, pts, dy, 'i8pair', hs, None, False, 8)
    g16 = _port_grads(tc, params, pts, dy, 'i8pair', hs, None, False, 16)
    for k in ('w_in', 'b_in', 'b_h', 'w_out', 'b_out'):
        assert torch.equal(g8[k], g16[k]), k


@functools.lru_cache(maxsize=None)
def _jax_i8pair_stash(seed=5):
    """JAX's i8pair stashing forward at TINY (stash tile 16): the residuals
    and, for the port, the stash rows below N."""
    jc, _, params, pts, _ = _setup(seed)
    _, residuals = jax.jit(lambda p, x: jfm._fused_mlp_stash_fwd(
        jfm._dims_from_config(jc), 16, 16, True, False, 'i8pair', p, x))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(pts))
    return residuals, _stash_to_torch('i8pair', residuals[2])


@pytest.mark.parametrize('group', [8, 16, 24])
def test_i8pair_plain_matches_jax_at_the_group(group):
    """Every gradient of the i8pair backward's plain version at scale groups
    that are not multiples of 32 (the card's dW_i8 kernel splits its 32-point
    chunks at their boundaries) against JAX's interpret-mode kernel at the
    same stash_bwd_tile, within the i8pair tolerance."""
    jc, tc, params, pts, dy = _setup(seed=5)
    residuals, hs = _jax_i8pair_stash()
    ref = jax.jit(lambda r, g: jfm._fused_mlp_stash_bwd(
        jfm._dims_from_config(jc), 16, group, True, False, 'i8pair', r, g))(
        residuals, jnp.asarray(dy))[0]
    got = _port_grads(tc, params, pts, dy, 'i8pair', hs, None, False, group)
    for k in KEYS:
        assert _rel(ref[k], got[k].numpy()) < GRAD_TOL['i8pair'], (group, k)


@pytest.mark.parametrize('knob', [dict(stash=False), dict(stash_format='lsb'),
                                  dict(stash_format='i8pair')])
def test_autograd_paths_match_jax(knob):
    """nerf_apply_fused under autograd with each knob (the Functions on the
    plain versions) against jax.grad of the JAX field with the same knob:
    the parameters' and the points' gradients under mean(raw^2), as
    tests/test_fused_mlp.py compares (under sum(raw * dy) with random dy the
    bias gradients cancel to a few percent of their max)."""
    jc, tc, params, pts, _ = _setup(seed=6)
    jg = jax.jit(jax.grad(lambda p, x: jnp.mean(jax_nerf_apply_fused(
        jc, p, x, compute_dpts=True, **JAX_TILES, **dict(dict(stash=True), **knob)).raw ** 2),
        argnums=(0, 1)))(jax.tree.map(jnp.asarray, params), jnp.asarray(pts))
    tp = {k: v.requires_grad_() for k, v in params_from_numpy(params, 'cpu').items()}
    x = torch.from_numpy(pts).requires_grad_()
    launches = (fused_mlp.DPTS_LAUNCHES, fused_mlp.RECOMPUTE_BWD_LAUNCHES,
                fused_mlp.LSB_LAUNCHES, fused_mlp.I8PAIR_LAUNCHES)
    out = nerf_apply_fused(tc, tp, x, stash_bwd_tile=8, **knob).raw
    (out ** 2).mean().backward()
    tol = GRAD_TOL['i8pair' if knob.get('stash_format') == 'i8pair' else 'int8']
    for k in KEYS:
        assert _rel(jg[0][k], tp[k].grad.numpy()) < tol, (knob, k)
    assert _rel(jg[1], x.grad.numpy()) < DPTS_TOL
    # the plain versions launch nothing
    assert launches == (fused_mlp.DPTS_LAUNCHES, fused_mlp.RECOMPUTE_BWD_LAUNCHES,
                        fused_mlp.LSB_LAUNCHES, fused_mlp.I8PAIR_LAUNCHES)
    # the forward under grad is K0's in every path
    with torch.no_grad():
        torch.testing.assert_close(out.detach(), fused_mlp.fused_mlp_reference(
            tc, tp, torch.from_numpy(pts)), rtol=0, atol=0)


# ------------------------------------------------------------ the train step

RENDER = dict(n_stratified=8, n_hierarchical=16)
N_RAYS = 8


def _batch(seed=42):
    rng = np.random.default_rng(seed)
    rays_o = np.tile(np.array([[4.0, 0.0, 0.0]], np.float32), (N_RAYS, 1))
    dirs = np.array([[-1.0, 0.0, 0.0]]) + 0.15 * rng.normal(size=(N_RAYS, 3))
    rays_d = (dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)).astype(np.float32)
    return {'rays': np.stack([rays_o, rays_d], axis=1),
            'time': np.zeros((N_RAYS, 1), np.float32),
            'target_image': np.full((N_RAYS, 1), 0.05, np.float32)}


@pytest.mark.parametrize('knob', [dict(stash=False), dict(stash_format='lsb'),
                                  dict(stash_format='i8pair')])
def test_train_step_per_knob_matches_jax(knob):
    """One bench.py-style train step at TINY with each knob as
    nerf_apply_fused keywords (scripts/probe_step.py) against the JAX
    step's loss and gradients with the same knob: the port's step leaves its
    gradients on the parameters."""
    jc, tc = JaxNeRFConfig(**TINY), NeRFConfig(**TINY)
    jr, _ = jax_make_emission_system(model_config=jc, use_fused=False, perturb=False,
                                     **RENDER)
    japply = functools.partial(jax_nerf_apply_fused, jc, **JAX_TILES,
                               **dict(dict(stash=True), **knob))
    jr = dataclasses.replace(jr, field_apply=japply, coarse_field_apply=japply)
    tr = Renderer(field_apply=functools.partial(nerf_apply_fused, tc, stash_bwd_tile=8,
                                                **knob),
                  head=EmissionHead(), perturb=False, **RENDER)
    params = {'coarse': _params(tc, 20), 'fine': _params(tc, 21)}
    batch = _batch()

    def jloss(p):
        rays = jnp.asarray(batch['rays'])
        out = jr(p, rays[:, 0], rays[:, 1], jnp.asarray(batch['time']))
        return jax_render_loss(JaxLossConfig(), out, jnp.asarray(batch['target_image']))[0]
    jl, jg = jax.jit(jax.value_and_grad(jloss))(jax.tree.map(jnp.asarray, params))
    opt = make_optimizer()
    state = create_train_state(params_from_numpy(params, 'cpu'), opt)
    _, m = make_train_step(tr, LossConfig(), opt)(
        state, {k: torch.from_numpy(v) for k, v in batch.items()}, 0)
    np.testing.assert_allclose(float(m['loss']), float(jl), rtol=1e-3)
    tol = GRAD_TOL['i8pair' if knob.get('stash_format') == 'i8pair' else 'int8']
    for f in ('coarse', 'fine'):
        for k in KEYS:
            assert _rel(jg[f][k], state.params[f][k].grad.numpy()) < tol, (knob, f, k)


# ------------------------------------------------------------ the benchmark script

def test_bench_kernel_runs_on_the_cpu(capsys):
    """sunerf_tpu_torch/scripts/bench_kernel.py at a tiny N through the plain
    versions: every row, host-clock times labelled as the CPU's."""
    rows = bench_kernel.main(['--n', '64', '--device', 'cpu', '--reps', '1'])
    names = [r['name'] for r in rows]
    assert names == ['fwd (no grad)'] + [f'stash[{f}] fwd+bwd' for f in fused_mlp.STASH_FORMATS] \
        + [f'stash[{f}] fwd only' for f in fused_mlp.STASH_FORMATS] + ['recompute fwd+bwd']
    assert all(r['device'] == 'cpu' and r['ms'] > 0 for r in rows)
    printed = capsys.readouterr().out
    assert 'recompute fwd+bwd' in printed and 'cpu' in printed
