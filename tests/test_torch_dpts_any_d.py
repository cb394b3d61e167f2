"""The point cotangent (K3) and the recompute backward (K4) of the port at
any d_input, against the JAX package on the CPU.

The JAX kernels take any number of input dimensions
(sunerf_tpu/ops/pallas/fused_mlp.py _bwd_stash_kernel's compute_dpts branch
and _bwd_kernel); so do the port's plain versions and, on the card, its
kernels: pack_wgmma_dpts orders W_in's columns by dimension (dpts_layout),
and the chain kernel's tail sums each dimension's groups of columns in
turn, with no per-dimension register file to bound d_input.

Here the port runs its plain versions (CPU tensors) at TINY widths with
d_input 3 and 12; the JAX side runs its Pallas kernels in interpret mode
with tiles of 8, jitted. Inputs come from numpy seeds; torch runs at one
thread. Tolerances as tests/test_torch_backward_variants.py states them:
parameter gradients 2e-2 of max|JAX| (GRAD_TOL), point gradients 5e-2
(DPTS_TOL, tests/test_fused_mlp.py:85).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sunerf_tpu.models.fields import NeRFConfig as JaxNeRFConfig
from sunerf_tpu.ops.pallas import fused_mlp as jfm
from sunerf_tpu_torch.core.encoding import encoding_columns
from sunerf_tpu_torch.models.fields import NeRFConfig, params_from_numpy
from sunerf_tpu_torch.ops import fused_mlp

torch.set_num_threads(1)

TINY = dict(n_layers=3, d_filter=64, n_freqs=4, d_output=2)
KEYS = ('w_in', 'b_in', 'w_h', 'b_h', 'w_out', 'b_out')
N = 40
GRAD_TOL = {'int8': 2e-2, 'recompute': 2e-2}
DPTS_TOL = 5e-2


def _rel(ref, got) -> float:
    ref, got = np.asarray(ref, np.float64), np.asarray(got, np.float64)
    assert ref.shape == got.shape, (ref.shape, got.shape)
    return float(np.max(np.abs(ref - got)) / max(np.max(np.abs(ref)), 1e-30))


@functools.lru_cache(maxsize=None)
def _setup(d_input: int, seed: int):
    """(JAX config, port config, params, points, dy) as numpy, from seeds."""
    jc, tc = JaxNeRFConfig(d_input=d_input, **TINY), NeRFConfig(d_input=d_input, **TINY)
    rng = np.random.default_rng(seed)

    def lin(fan_in, fan_out, *lead):
        b = 1.0 / np.sqrt(fan_in)
        return (rng.uniform(-b, b, (*lead, fan_in, fan_out)).astype(np.float32),
                rng.uniform(-b, b, (*lead, fan_out)).astype(np.float32))
    w_in, b_in = lin(tc.d_encoded, tc.d_filter)
    w_h, b_h = lin(tc.d_filter, tc.d_filter, tc.n_layers - 1)
    w_out, b_out = lin(tc.d_filter, tc.d_output)
    params = dict(w_in=w_in, b_in=b_in, w_h=w_h, b_h=b_h, w_out=w_out, b_out=b_out)
    pts = rng.uniform(-1.3, 1.3, (N, d_input)).astype(np.float32)
    dy = rng.normal(size=(N, tc.d_output)).astype(np.float32)
    return jc, tc, params, pts, dy


@pytest.mark.parametrize('d_input', [3, 12])
def test_point_cotangent_matches_jax_at_any_d_input(d_input):
    """K2 with K3 (compute_dpts=True): the plain version fed JAX's own
    int8 stash against _fused_mlp_stash_bwd, every parameter gradient and
    dpts [N, d_input]; the parameter gradients the same bits without K3."""
    jc, tc, params, pts, dy = _setup(d_input, 30 + d_input)
    dims = jfm._dims_from_config(jc)
    jp = jax.tree.map(jnp.asarray, params)
    _, residuals = jax.jit(lambda p, x: jfm._fused_mlp_stash_fwd(
        dims, 8, 8, True, True, 'int8', p, x))(jp, jnp.asarray(pts))
    dparams, dpts = jax.jit(lambda r, g: jfm._fused_mlp_stash_bwd(
        dims, 8, 8, True, True, 'int8', r, g))(residuals, jnp.asarray(dy))
    _, _, hs_j, cs_j = residuals
    hs = torch.from_numpy(np.asarray(hs_j, np.float32)[:N]).to(torch.bfloat16)
    cs = torch.from_numpy(np.array(cs_j)[:N])
    tp, tpts, tdy = params_from_numpy(params, 'cpu'), torch.from_numpy(pts), torch.from_numpy(dy)
    got = fused_mlp.fused_mlp_stash_bwd_reference(tc, tp, tpts, tdy, hs, cs, 'int8', True)
    assert got['dpts'].shape == (N, d_input)
    for k in KEYS:
        assert _rel(dparams[k], got[k].numpy()) < GRAD_TOL['int8'], k
    assert _rel(dpts, got['dpts'].numpy()) < DPTS_TOL
    without = fused_mlp.fused_mlp_stash_bwd_reference(tc, tp, tpts, tdy, hs, cs, 'int8', False)
    for k in KEYS:
        assert torch.equal(without[k], got[k]), k


@pytest.mark.parametrize('d_input', [3, 12])
def test_recompute_backward_matches_jax_at_any_d_input(d_input):
    """K4 (_bwd_kernel): parameter gradients and dpts [N, d_input]."""
    jc, tc, params, pts, dy = _setup(d_input, 40 + d_input)
    dims = jfm._dims_from_config(jc)
    dparams, dpts = jax.jit(lambda p, x, g: jfm._fused_mlp_bwd(dims, 8, 8, True, (p, x), g))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(pts), jnp.asarray(dy))
    got = fused_mlp.fused_mlp_recompute_bwd_reference(
        tc, params_from_numpy(params, 'cpu'), torch.from_numpy(pts), torch.from_numpy(dy))
    assert got['dpts'].shape == (N, d_input)
    for k in KEYS:
        assert _rel(dparams[k], got[k].numpy()) < GRAD_TOL['recompute'], k
    assert _rel(dpts, got['dpts'].numpy()) < DPTS_TOL


def test_card_path_takes_any_d_input():
    """No d_input limit is left: MAX_DPTS_INPUTS is gone, the backwards'
    argument check accepts d_input = 12, and K3's tables cover a 12-input
    field's every encoding column once, in whole chunks of the ring."""
    assert not hasattr(fused_mlp, 'MAX_DPTS_INPUTS')
    cfg = NeRFConfig(d_input=12, **TINY)
    fused_mlp._check_backward(cfg, torch.zeros(5, 2), 5, torch.device('cpu'))
    dims, _ = encoding_columns(12, cfg.n_freqs, cfg.scale_factor, cfg.n_freqs_time)
    # every width up to 512 runs at a kernel width (32 and 96 zero-padded)
    for h in map(fused_mlp.kernel_width, fused_mlp.KERNEL_WIDTHS + (32, 96)):
        cols, pairs, gdim = fused_mlp.dpts_layout(12, dims, h)
        assert len(cols) % fused_mlp.dpts_chunk_cols(h) == 0
        assert sorted(c for c in cols if c >= 0) == list(range(cfg.d_encoded))
        assert len(pairs) * 2 == len(cols) == len(gdim) * 8
        assert gdim == sorted(gdim) and set(range(12)) <= set(gdim) <= set(range(13))
