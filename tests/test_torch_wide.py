"""The wide route of the fused field (sunerf_tpu_torch/ops/wide_mlp.py, the
per-layer kernels that take any width and output count) on the CPU: the
routing (fused_mlp.kernel_route), the plain versions that define the wide
kernels' functions against the JAX package's Pallas kernels in interpret
mode at fields the fused kernels cannot hold (2x640 with d_output 9 for the
forwards, 2x64 with d_output 5 for the backwards), the wide operand
layouts read back against the JAX parameters, the dispatch of the port's
entry points and the serving export's wide op.

The port runs its plain versions (CPU tensors); the JAX side runs its
kernels in interpret mode with tiles of 8, jitted. Inputs come from numpy
seeds; torch runs at one thread.

Tolerances, as fractions of max|JAX|, each with its reason (those of
tests/test_torch_backward_variants.py):
  * outputs 2e-2 and parameter gradients 2e-2 (the North star's kernel
    tolerance: bf16 operands on both sides, bf16 flips compound down the
    layers); point gradients 5e-2 (tests/test_fused_mlp.py:85); i8pair
    gradients 6e-2 (:163), whose dz scale moves with any flip of a group's
    max; grid tables 3e-2 (tests/test_torch_grid_levels.py: JAX rounds its
    hat weights to bf16, the port does not);
  * stashes fed the same upstream activations: bf16 within 1 ulp, int8
    within 1;
  * layouts and the CPU dispatch exactly: index arithmetic and the same
    plain versions.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sunerf_tpu.models.fields import NeRFConfig as JaxNeRFConfig
from sunerf_tpu.ops.pallas import fused_mlp as jfm
from sunerf_tpu_torch.models.fields import NeRFConfig, params_from_numpy
from sunerf_tpu_torch.ops import fused_mlp, wide_mlp

torch.set_num_threads(1)

FWD = dict(n_layers=2, d_filter=640, d_output=9, n_freqs=4)
BWD = dict(n_layers=2, d_filter=64, d_output=5, n_freqs=4)
GRID = dict(BWD, grid_sizes=(4, 6), grid_features=4)
KEYS = ('w_in', 'b_in', 'w_h', 'b_h', 'w_out', 'b_out')
N = 48
TOL, DPTS_TOL, I8PAIR_TOL, GRID_TOL = 2e-2, 5e-2, 6e-2, 3e-2


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
    p = dict(w_in=w_in, b_in=b_in, w_h=w_h, b_h=b_h, w_out=w_out, b_out=b_out)
    for i, g in enumerate(config.grid_sizes):
        p[f'grid_{i}'] = rng.uniform(-1, 1, (g, g, g, config.grid_features)).astype(np.float32)
    return p


def _points(n=N, seed=1):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1.3, 1.3, (n, 4)).astype(np.float32)
    pts[:, 3] = rng.uniform(0, 1, n)
    return pts


def _setup(shape: dict, seed: int):
    jc, tc = JaxNeRFConfig(**shape), NeRFConfig(**shape)
    params, pts = _params(tc, seed), _points(seed=seed + 1)
    dy = np.random.default_rng(seed + 2).normal(size=(N, tc.d_output)).astype(np.float32)
    return jc, tc, params, pts, dy


def _bf16(x) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)


def _stash_to_torch(fmt, hs):
    hs = np.asarray(hs)[:N]
    return _bf16(hs) if fmt in ('int8', 'lsb') else torch.from_numpy(np.array(hs))


# ------------------------------------------------------------ routing

@pytest.mark.parametrize('width,d_output,forward,backward', [
    (64, 2, 'fused', 'fused'), (512, 2, 'fused', 'fused'), (96, 4, 'fused', 'fused'),
    (64, 5, 'fused', 'wide'), (512, 8, 'fused', 'wide'), (64, 9, 'wide', 'wide'),
    (8, 16, 'wide', 'wide'), (513, 2, 'wide', 'wide'), (640, 9, 'wide', 'wide'),
    (1024, 1, 'wide', 'wide'), (64, 0, 'wide', 'wide')])
def test_kernel_route(width, d_output, forward, backward):
    cfg = NeRFConfig(d_filter=width, d_output=d_output)
    assert fused_mlp.kernel_route(cfg) == forward
    assert fused_mlp.kernel_route(cfg, backward=True) == backward


def test_wide_width_and_pads():
    assert [wide_mlp.wide_width(w) for w in (1, 8, 9, 513, 640, 1000, 1001)] \
        == [16, 16, 16, 528, 640, 1008, 1008]
    assert [wide_mlp.o_pad(o) for o in (1, 8, 9, 16)] == [8, 8, 16, 16]
    assert wide_mlp.e_pad(NeRFConfig(**FWD)) == 48          # 4 + 2 * 4 * 4 = 36 -> 48


# ------------------------------------------------------------ the forwards

def test_plain_forward_matches_jax_kernel_at_2x640_nine_outputs():
    """K0's plain version (what the wide K0 computes) at 2x640 / d_output 9
    against JAX's fused forward in interpret mode, and the port's entry
    point on the CPU, routed 'wide', its bits."""
    jc, tc, params, pts, _ = _setup(FWD, seed=0)
    ref = np.asarray(jfm.fused_nerf_raw(jc, jax.tree.map(jnp.asarray, params),
                                        jnp.asarray(pts), tile=8, interpret=True,
                                        stash=False))
    tp, tpts = params_from_numpy(params, 'cpu'), torch.from_numpy(pts)
    got = fused_mlp.fused_mlp_reference(tc, tp, tpts)
    assert got.shape == (N, 9) and _rel(ref, got.numpy()) < TOL
    assert fused_mlp.kernel_route(tc) == 'wide'
    with torch.no_grad():
        assert torch.equal(fused_mlp.fused_mlp_forward(tc, tp, tpts), got)
    assert torch.equal(wide_mlp.wide_forward(tc, tp, tpts), got)
    assert wide_mlp.WIDE_LAUNCHES == 0          # CPU calls launch nothing


@functools.lru_cache(maxsize=None)
def _jax_stash(fmt, shape_key, seed=0):
    shape = dict(shape_key)
    jc, _, params, pts, _ = _setup(shape, seed)
    out, (_, _, hs, cs) = jax.jit(
        lambda p, x: jfm._fused_mlp_stash_fwd(jfm._dims_from_config(jc), 8, 8, True, False,
                                              fmt, p, x))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(pts))
    return (np.asarray(out)[:N], np.asarray(hs)[:N],
            None if cs is None else np.asarray(cs)[:N])


@pytest.mark.parametrize('fmt', ['int8', 'lsb', 'i8pair'])
def test_plain_stash_matches_jax_kernel_at_2x640_nine_outputs(fmt):
    """The stashing forwards' plain versions (the wide K1 / K6a stash
    layouts; i8pair's, K6b's) against
    _fused_mlp_stash_fwd at 2x640 / d_output 9, the port's layers fed JAX's
    own bf16 activations."""
    key = tuple(FWD.items())
    _, tc, params, pts, _ = _setup(FWD, seed=0)
    out_j, hs_j, cs_j = _jax_stash(fmt, key)
    _, act_j, _ = _jax_stash('int8', key)
    tp, tpts = params_from_numpy(params, 'cpu'), torch.from_numpy(pts)
    out, hs, cs = wide_mlp.wide_stash_forward(tc, tp, tpts, fmt)
    assert _rel(out_j, out.numpy()) < TOL
    lw, lw_cs = fused_mlp.fused_mlp_stash_layerwise(tc, tp, tpts, _bf16(act_j), fmt)
    assert hs.shape == lw.shape == hs_j.shape
    if fmt == 'i8pair':
        assert np.max(np.abs(lw.int().numpy() - hs_j.astype(np.int32))) <= 1
        return
    got, ref = lw.float().numpy(), hs_j.astype(np.float32)
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(ref), 2.0 ** -126))) - 7)
    if fmt == 'int8':
        assert np.max(np.abs(got - ref) / ulp) <= 1
        assert np.max(np.abs(lw_cs.int().numpy() - cs_j.astype(np.int32))) <= 1
        return
    bits, bits_j = lw.view(torch.int16).numpy(), hs_j.view(np.int16)
    assert np.max(np.abs((bits & -2).astype(np.int32) - (bits_j & -2))) <= 2


# ------------------------------------------------------------ the backwards

@functools.lru_cache(maxsize=None)
def _jax_backward(fmt, compute_dpts, shape_key, seed):
    shape = dict(shape_key)
    jc, _, params, pts, dy = _setup(shape, seed)
    dims = jfm._dims_from_config(jc)
    fwd = jax.jit(lambda p, x: jfm._fused_mlp_stash_fwd(dims, 8, 8, True, compute_dpts, fmt,
                                                        p, x))
    _, residuals = fwd(jax.tree.map(jnp.asarray, params), jnp.asarray(pts))
    bwd = jax.jit(lambda r, g: jfm._fused_mlp_stash_bwd(dims, 8, 8, True, compute_dpts, fmt,
                                                        r, g))
    dparams, dpts = bwd(residuals, jnp.asarray(dy))
    _, _, hs, cs = residuals
    return ({k: np.asarray(v) for k, v in dparams.items()}, np.asarray(dpts),
            np.asarray(hs)[:N], None if cs is None else np.asarray(cs)[:N])


@pytest.mark.parametrize('compute_dpts', [False, True], ids=['params', 'dpts'])
@pytest.mark.parametrize('fmt', ['int8', 'lsb', 'i8pair'])
def test_plain_stash_backward_matches_jax_kernel_at_five_outputs(fmt, compute_dpts):
    """The stashing backward's plain version (the wide K2 / K6a, with K3)
    at 2x64 / d_output 5, outside the fused backward's heads, both sides fed
    JAX's own stash; through the port's wrapper, routed 'wide'."""
    _, tc, params, pts, dy = _setup(BWD, seed=3)
    dparams, dpts_j, hs_j, cs_j = _jax_backward(fmt, compute_dpts, tuple(BWD.items()), 3)
    assert fused_mlp.kernel_route(tc, backward=True) == 'wide'
    got = fused_mlp.fused_mlp_stash_backward(
        tc, params_from_numpy(params, 'cpu'), torch.from_numpy(pts), torch.from_numpy(dy),
        _stash_to_torch(fmt, hs_j), None if cs_j is None else torch.from_numpy(np.array(cs_j)),
        fmt, compute_dpts, group=8)
    tol = I8PAIR_TOL if fmt == 'i8pair' else TOL
    for k in KEYS:
        assert got[k].shape == dparams[k].shape, k
        assert _rel(dparams[k], got[k].numpy()) < tol, (fmt, k)
    assert ('dpts' in got) == compute_dpts
    if compute_dpts:
        assert _rel(dpts_j, got['dpts'].numpy()) < DPTS_TOL


@pytest.mark.parametrize('group', [8, 24, 40, 768])
def test_plain_i8pair_backward_matches_jax_kernel_at_any_group(group):
    """'i8pair''s plain backward (what the wide K6b computes, at any scale
    group since the wide route takes any) at 2x640 / d_output 9 against
    JAX's kernel in interpret mode with its backward tile (the group) of
    the same size: groups 8, 24 and 40 are no multiple of 32 (40 leaves a
    partial last group of the 48 points), 768 holds them all."""
    jc, tc, params, pts, dy = _setup(FWD, seed=12)
    dims = jfm._dims_from_config(jc)
    fwd = jax.jit(lambda p, x: jfm._fused_mlp_stash_fwd(dims, 8, group, True, False, 'i8pair',
                                                        p, x))
    _, residuals = fwd(jax.tree.map(jnp.asarray, params), jnp.asarray(pts))
    bwd = jax.jit(lambda r, g: jfm._fused_mlp_stash_bwd(dims, 8, group, True, False, 'i8pair',
                                                        r, g))
    dparams, _ = bwd(residuals, jnp.asarray(dy))
    hs_j = residuals[2]
    got = fused_mlp.fused_mlp_stash_backward(
        tc, params_from_numpy(params, 'cpu'), torch.from_numpy(pts), torch.from_numpy(dy),
        _stash_to_torch('i8pair', hs_j), None, 'i8pair', False, group=group)
    for k in KEYS:
        assert got[k].shape == dparams[k].shape, k
        assert _rel(np.asarray(dparams[k]), got[k].numpy()) < I8PAIR_TOL, (group, k)


def test_plain_recompute_backward_matches_jax_kernel_at_five_outputs():
    """K4's plain version (the wide K4) at 2x64 / d_output 5 against
    _fused_mlp_bwd: parameter gradients and dpts."""
    jc, tc, params, pts, dy = _setup(BWD, seed=4)
    dims = jfm._dims_from_config(jc)
    dparams, dpts = jax.jit(lambda p, x, g: jfm._fused_mlp_bwd(dims, 8, 8, True, (p, x), g))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(pts), jnp.asarray(dy))
    got = wide_mlp.wide_recompute_backward(tc, params_from_numpy(params, 'cpu'),
                                           torch.from_numpy(pts), torch.from_numpy(dy))
    for k in KEYS:
        assert _rel(dparams[k], got[k].numpy()) < TOL, k
    assert _rel(dpts, got['dpts'].numpy()) < DPTS_TOL


def test_plain_grid_backward_matches_jax_kernel_at_two_levels():
    """K5 on the wide route: the plain forward and backward with two grid
    levels at 2x64 / d_output 5 against JAX's grid kernels in interpret
    mode, every gradient, both tables' included."""
    jc, tc, params, pts, dy = _setup(GRID, seed=5)
    dims = jfm._dims_from_config(jc)
    fwd = jax.jit(functools.partial(jfm._fused_mlp_stash_fwd, dims, 8, 8, True, False, 'int8'))
    bwd = jax.jit(functools.partial(jfm._fused_mlp_stash_bwd, dims, 8, 8, True, False, 'int8'))
    out_j, residuals = fwd(jax.tree.map(jnp.asarray, params), jnp.asarray(pts))
    dparams, _ = bwd(residuals, jnp.asarray(dy))
    tp, tpts = params_from_numpy(params, 'cpu'), torch.from_numpy(pts)
    out, hs, cs = fused_mlp.fused_mlp_stash_forward(tc, tp, tpts)
    assert _rel(np.asarray(out_j)[:N], out.numpy()) < TOL
    _, _, hs_j, cs_j = residuals
    got = fused_mlp.fused_mlp_stash_backward(tc, tp, tpts, torch.from_numpy(dy),
                                             _stash_to_torch('int8', hs_j),
                                             torch.from_numpy(np.array(cs_j)[:N]))
    for k in KEYS + ('grid_0', 'grid_1'):
        assert _rel(dparams[k], got[k].numpy()) < (GRID_TOL if k.startswith('grid') else TOL), k


def test_autograd_on_the_wide_route_takes_one_route():
    """fused_mlp_forward under autograd on a 2x64 / d_output 5 field: the
    forward runs at the backward's route ('wide'), and the gradients are the
    plain backward's of each format ('i8pair' at a scale group of 8)."""
    _, tc, params, pts, dy = _setup(BWD, seed=6)
    tp = params_from_numpy(params, 'cpu')
    for knobs in (dict(), dict(stash_format='lsb'), dict(stash_format='i8pair', stash_bwd_tile=8),
                  dict(stash=False)):
        leaves = {k: v.clone().requires_grad_() for k, v in tp.items()}
        x = torch.from_numpy(pts).requires_grad_()
        out = fused_mlp.fused_mlp_forward(tc, leaves, x, **knobs)
        out.backward(torch.from_numpy(dy))
        if knobs.get('stash') is False:
            ref = fused_mlp.fused_mlp_recompute_bwd_reference(tc, tp, x.detach(),
                                                              torch.from_numpy(dy))
        else:
            fmt = knobs.get('stash_format', 'int8')
            _, hs, cs = fused_mlp.fused_mlp_stash_reference(tc, tp, x.detach(), fmt)
            ref = fused_mlp.fused_mlp_stash_bwd_reference(tc, tp, x.detach(),
                                                          torch.from_numpy(dy), hs, cs, fmt,
                                                          True, knobs.get('stash_bwd_tile', 768))
        for k in KEYS:
            assert torch.equal(leaves[k].grad, ref[k]), (knobs, k)
        assert torch.equal(x.grad, ref['dpts']), knobs


# ------------------------------------------------------------ layouts

def test_wide_layouts_unpack_to_the_jax_parameters():
    """pack_wide (the forward's W^T, w_in's rows zero-padded to e_pad) and
    pack_wide_bwd (W as stored, w_out's columns zero-padded to o_pad) read
    back as the JAX parameters' bf16 roundings; wide_operands holds them."""
    jc, tc, params, _, _ = _setup(FWD, seed=7)
    tp = params_from_numpy(params, 'cpu')
    ops = wide_mlp.wide_operands(tc, tp)
    assert ops['w_in_t'].shape == (640, 48) and ops['w_out_t'].shape == (9, 640)
    assert not ops['w_in_t'][:, tc.d_encoded:].float().any()
    w_in, w_h, w_out = wide_mlp.unpack_wide(ops, tc.d_encoded)
    for got, k in ((w_in, 'w_in'), (w_h, 'w_h'), (w_out, 'w_out')):
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.float().numpy(), _bf16(params[k]).float().numpy())
    bwd = wide_mlp.pack_wide_bwd(tp['w_in'], tp['w_h'], tp['w_out'])
    assert bwd['w_out_b'].shape == (640, 16) and not bwd['w_out_b'][:, 9:].float().any()
    np.testing.assert_array_equal(bwd['w_out_b'][:, :9].float().numpy(),
                                  _bf16(params['w_out']).float().numpy())
    np.testing.assert_array_equal(bwd['w_h_b'].float().numpy(),
                                  _bf16(params['w_h']).float().numpy())
    np.testing.assert_array_equal(bwd['w_in_b'].float().numpy(),
                                  _bf16(params['w_in']).float().numpy())
    # the op's plain version reads them back to fused_mlp_reference's bits
    pts = torch.from_numpy(_points(20, seed=8))
    assert torch.equal(wide_mlp.wide_mlp_packed(ops, pts, tc.grid_bound),
                       fused_mlp.fused_mlp_reference(tc, tp, pts))
    # cached: the same tensors give the same pack; an in-place update a new one
    assert wide_mlp.wide_operands(tc, tp)['w_in_t'] is ops['w_in_t']
    with torch.no_grad():
        tp['w_in'].add_(1.0)
    assert wide_mlp.wide_operands(tc, tp)['w_in_t'] is not ops['w_in_t']


def test_wide_field_pads_to_a_multiple_of_eight():
    """A 2x1001 field runs at 1008 on the wide route: the pad's field and
    gradients are the unpadded ones (pad_field's zero units)."""
    cfg = NeRFConfig(n_layers=2, d_filter=1001, d_output=3, n_freqs=2)
    params = params_from_numpy(_params(cfg, seed=9), 'cpu')
    pts = torch.from_numpy(_points(16, seed=10))
    pcfg, pp = wide_mlp.wide_field(cfg, params)
    assert pcfg.d_filter == 1008 and pp['w_h'].shape == (1, 1008, 1008)
    torch.testing.assert_close(fused_mlp.fused_mlp_reference(pcfg, pp, pts),
                               fused_mlp.fused_mlp_reference(cfg, params, pts),
                               rtol=0, atol=1e-6)


def test_export_bakes_the_wide_op_into_the_program(tmp_path):
    """A serving export of a 2x640 / d_output 2 field through the fused op
    on the CPU (what the CUDA export does on the card) calls
    sunerf_tpu_torch::wide_mlp_fwd, and its points program gives the live
    field's raw output."""
    from sunerf_tpu_torch.evaluation.serving import export_programs
    from sunerf_tpu_torch.models.fields import emission_config
    from sunerf_tpu_torch.systems import make_emission_system
    cfg = emission_config(n_layers=2, d_filter=640, n_freqs=4)
    renderer, init = make_emission_system(model_config=cfg, n_stratified=4,
                                          n_hierarchical=4, use_fused=False, device='cpu')
    params = init(torch.Generator().manual_seed(0))
    params_np = {k: {kk: vv.numpy() for kk, vv in v.items()} for k, v in params.items()}
    _, points_blob, op = export_programs(renderer.spec, params_np, 'cpu', 16, 0, fused=True)
    assert op
    import io
    program = torch.export.load(io.BytesIO(points_blob))
    targets = {str(n.target) for n in program.graph.nodes if n.op == 'call_function'}
    assert any('wide_mlp_fwd' in t for t in targets), targets
    assert not any('fused_mlp_fwd' in t for t in targets)
    query = torch.from_numpy(_points(16, seed=11))
    fused, _ = make_emission_system(model_config=cfg, n_stratified=4, n_hierarchical=4,
                                    use_fused=True, device='cpu')
    with torch.no_grad():
        assert torch.equal(program.module()(query), fused.forward_points(params, query).raw)
