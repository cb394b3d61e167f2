"""The port's field (sunerf_tpu_torch.models.fields, core.encoding and the
fused forward's plain version in ops.fused_mlp) against the JAX package on
the CPU, at TINY widths and on the committed bundle's two fields.

Tolerances, as fractions of max|raw|:
  * 1e-4 for the float32 field against JAX's nerf_apply: only the summation
    order differs;
  * 2e-2 for fused_mlp_reference against the JAX Pallas kernel in interpret
    mode: both round matmul operands to bf16, and single bf16 rounding flips
    compound over 8 trained layers.
"""
import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sunerf_tpu.core.encoding import positional_encoding as jax_posenc
from sunerf_tpu.models.fields import NeRFConfig as JaxNeRFConfig
from sunerf_tpu.models.fields import init_nerf as jax_init_nerf
from sunerf_tpu.models.fields import nerf_apply as jax_nerf_apply
from sunerf_tpu.models.fields import nerf_apply_fused as jax_nerf_apply_fused
from sunerf_tpu.utils.checkpoint import load_state as jax_load_state
from sunerf_tpu_torch.core.encoding import encoded_dim, positional_encoding
from sunerf_tpu_torch.models.fields import (NeRFConfig, density_temperature_config,
                                            emission_config, init_nerf, nerf_apply,
                                            nerf_apply_fused, params_from_numpy)
from sunerf_tpu_torch.ops.fused_mlp import fused_mlp_reference, pack_wgmma

torch.set_num_threads(1)

BUNDLE = str(Path(__file__).resolve().parents[1] / 'artifacts_r4' / 's8_probe_rerun_best')
TINY = dict(n_layers=3, d_filter=64, n_freqs=4)


def _rel(ref, got) -> float:
    ref, got = np.asarray(ref), np.asarray(got)
    assert ref.shape == got.shape, (ref.shape, got.shape)
    return float(np.max(np.abs(ref - got)) / np.max(np.abs(ref)))


def _points(n, seed=1):
    pts = np.random.default_rng(seed).uniform(-1.3, 1.3, (n, 4)).astype(np.float32)
    pts[:, 3] = np.random.default_rng(seed + 1).uniform(0, 1, n)
    return pts


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


def _case(name):
    """(jax config, port config, numpy params) for TINY or a bundle field."""
    if name == 'tiny':
        kw = dict(TINY)
        return JaxNeRFConfig(**kw), NeRFConfig(**kw), _random_params(NeRFConfig(**kw))
    params, config = jax_load_state(BUNDLE)
    key = 'model_config' if name == 'fine' else 'coarse_model_config'
    mc = config['renderer_spec'][key]
    return JaxNeRFConfig(**mc), NeRFConfig(**mc), params[name]


@pytest.mark.parametrize('name', ['tiny', 'coarse', 'fine'])
def test_nerf_apply_matches_jax(name):
    jc, tc, params = _case(name)
    pts = _points(1024)
    ref = jax_nerf_apply(jc, params, jnp.asarray(pts)).raw
    got = nerf_apply(tc, params_from_numpy(params, 'cpu'), torch.from_numpy(pts)).raw
    assert _rel(ref, got.numpy()) < 1e-4


@pytest.mark.parametrize('name', ['tiny', 'coarse', 'fine'])
def test_fused_reference_matches_jax_kernel(name):
    """The kernel's plain version against the Pallas _fwd_kernel (interpret)."""
    jc, tc, params = _case(name)
    pts = _points(1000)
    ref = jax_nerf_apply_fused(jc, params, jnp.asarray(pts), interpret=True,
                               stash=False).raw
    got = fused_mlp_reference(tc, params_from_numpy(params, 'cpu'),
                              torch.from_numpy(pts))
    assert _rel(ref, got.numpy()) < 2e-2
    # through the field contract on CPU tensors: the same plain version
    fo = nerf_apply_fused(tc, params_from_numpy(params, 'cpu'), torch.from_numpy(pts))
    torch.testing.assert_close(fo.raw, got, rtol=0, atol=0)


def test_fused_dt_base_offsets_added_after_the_kernel():
    tc = density_temperature_config(**TINY)
    jc = JaxNeRFConfig(**dataclasses.asdict(tc))
    params = _random_params(tc, seed=4)
    params.update(log_abs=np.full(7, 1e-6, np.float32), vol_c=np.float32(1.0))
    pts = _points(200)
    ref = jax_nerf_apply_fused(jc, params, jnp.asarray(pts), interpret=True,
                               stash=False)
    tparams = params_from_numpy(params, 'cpu')
    got = nerf_apply_fused(tc, tparams, torch.from_numpy(pts))
    assert _rel(ref.raw, got.raw.numpy()) < 2e-2
    assert got.log_abs.shape == (7,) and float(got.vol_c) == 1.0
    kernel_raw = fused_mlp_reference(tc, tparams, torch.from_numpy(pts))
    torch.testing.assert_close(got.raw, kernel_raw + torch.tensor([10.0, 5.0]),
                               rtol=0, atol=0)


@pytest.mark.parametrize('n_freqs_time', [None, 2])
def test_positional_encoding_matches_jax(n_freqs_time):
    pts = _points(256)
    ref = jax_posenc(jnp.asarray(pts), 10, 2.0, n_freqs_time=n_freqs_time)
    got = positional_encoding(torch.from_numpy(pts), 10, 2.0,
                              n_freqs_time=n_freqs_time)
    assert got.shape[-1] == encoded_dim(4, 10, n_freqs_time)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-6)


def test_nerf_config_json_roundtrip():
    _, config = jax_load_state(BUNDLE)
    for key in ('model_config', 'coarse_model_config'):
        mc = config['renderer_spec'][key]
        cfg = NeRFConfig(**mc)
        assert isinstance(cfg.grid_sizes, tuple) and isinstance(cfg.grid_time_range, tuple)
        again = NeRFConfig(**json.loads(json.dumps(dataclasses.asdict(cfg))))
        assert again == cfg and hash(again) == hash(cfg)
        assert json.loads(json.dumps(dataclasses.asdict(cfg))) == mc
        assert dataclasses.asdict(cfg) == dataclasses.asdict(JaxNeRFConfig(**mc))
    with pytest.raises(ValueError, match='grid_rank'):
        NeRFConfig(grid_time=4)


def test_params_from_numpy_keeps_the_jax_layout():
    params, _ = jax_load_state(BUNDLE)
    tp = params_from_numpy(params, 'cpu')
    assert tp['fine']['w_h'].shape == (7, 512, 512)
    assert tp['fine']['w_in'].shape == (84, 512)
    assert tp['coarse']['w_h'].shape == (3, 128, 128)
    for field in ('coarse', 'fine'):
        for k, v in params[field].items():
            assert tp[field][k].dtype == torch.float32
            np.testing.assert_array_equal(tp[field][k].numpy(), v)


def test_init_nerf_bounds_and_seed():
    cfg = emission_config(**TINY)
    a = init_nerf(torch.Generator().manual_seed(7), cfg, 'cpu')
    b = init_nerf(torch.Generator().manual_seed(7), cfg, 'cpu')
    assert a['w_h'].shape == (2, 64, 64) and a['b_h'].shape == (2, 64)
    assert a['w_in'].shape == (cfg.d_encoded, 64) and a['w_out'].shape == (64, 2)
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
    assert float(a['w_in'].abs().max()) <= 1 / np.sqrt(cfg.d_encoded)
    assert float(a['w_h'].abs().max()) <= 1 / np.sqrt(64)
    dt = init_nerf(torch.Generator().manual_seed(0),
                   density_temperature_config(**TINY), 'cpu')
    assert dt['log_abs'].shape == (7,)


# ------------------------------------------------------------ the K0 wgmma kernel's weights

def _core_unpack(block: np.ndarray, n_k: int, n_n: int) -> np.ndarray:
    """One K-major no-swizzle block (flat) -> [n_k, n_n]: element (k, n) at
    ((k // 8) * (n_n // 8) + n // 8) * 64 + (n % 8) * 8 + k % 8."""
    k, n = np.meshgrid(np.arange(n_k), np.arange(n_n), indexing='ij')
    return block[((k // 8) * (n_n // 8) + n // 8) * 64 + (n % 8) * 8 + k % 8]


def _bf16_np(x) -> np.ndarray:
    return torch.as_tensor(np.asarray(x, np.float32)).to(torch.bfloat16).float().numpy()


@pytest.mark.parametrize('d_filter,grid_sizes,d_output', [
    (128, (), 2), (512, (), 2), (128, (4,), 2), (128, (), 8)])
def test_k0_wgmma_packing_unpacks_to_the_jax_layout(d_filter, grid_sizes, d_output):
    """pack_wgmma's chunks, unpacked, are bf16(w_in) zero-padded to a
    multiple of 32 rows, then each bf16(w_h[i]), and last the head
    bf16(w_out)^T zero-padded to 8 outputs, of JAX-initialised params at
    TINY depth (3 layers), exactly."""
    jc = JaxNeRFConfig(n_layers=3, d_filter=d_filter, n_freqs=4, grid_sizes=grid_sizes,
                       grid_features=8, d_output=d_output)
    jp = jax.tree.map(np.array, jax_init_nerf(jax.random.PRNGKey(0), jc))
    params = params_from_numpy(jp, 'cpu')
    packed = pack_wgmma(params['w_in'].float(), params['w_h'].float(), params['w_out'].float())
    assert packed.dtype == torch.bfloat16 and packed.shape[1] == 32 * d_filter
    flat = packed.float().numpy()
    rows = np.concatenate([_core_unpack(c, 32, d_filter) for c in flat[:-1]])
    e = jp['w_in'].shape[0]
    k_in = -(-e // 32) * 32
    assert rows.shape == (k_in + 2 * d_filter, d_filter)
    np.testing.assert_array_equal(rows[:e], _bf16_np(jp['w_in']))
    np.testing.assert_array_equal(rows[e:k_in], 0.0)
    for i in range(2):
        np.testing.assert_array_equal(rows[k_in + i * d_filter:k_in + (i + 1) * d_filter],
                                      _bf16_np(jp['w_h'][i]))
    at = packed.shape[0] - 1
    head = _core_unpack(flat[at], d_filter, 8)
    np.testing.assert_array_equal(head[:, :d_output], _bf16_np(jp['w_out']))
    np.testing.assert_array_equal(head[:, d_output:], 0.0)
    assert not flat[at][d_filter * 8:].any()
