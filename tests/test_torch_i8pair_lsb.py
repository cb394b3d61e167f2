"""The two backward formats redesigned on the card, 'i8pair' (K6b: dW_h on
the int8 tensor cores) and 'lsb' (K6a: the packed-sin gate through the
weight ring), checked on the CPU through the port's mirrors of what the
kernels (csrc/fused_mlp_backward.cuh) compute and where they put it:

  * the group maxima: each point's max |dz_j| (the chain kernel's row
    maxima), then each scale group's (dz_group_max_kernel), equal to the
    JAX i8pair kernel's per-tile max |dz| at tiles of 8, 16, 24 and 768
    with a ragged N;
  * the int8 operands: the build threads' loads, byte transposes and
    stores (i8_build_operands), read back through wgmma's descriptors
    (start, the leading and stride byte offsets), are sin8^T and
    round_half_even(dz scale) for a segment's points, 0 for the others, in
    the kernel's order of the points (i8_point);
  * the 'lsb' gate decode (lsb_cos_decode, the kernels' table) on every
    16-bit pattern against JAX's _unpack_sin_cos.

All exact: maxima and layouts move values, and the decode rounds as JAX
does (NaN where JAX gives NaN).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sunerf_tpu.ops.pallas import fused_mlp as jfm
from sunerf_tpu_torch.models.fields import emission_config, init_nerf
from sunerf_tpu_torch.ops import fused_mlp

torch.set_num_threads(1)


@pytest.mark.parametrize('group', [8, 16, 24, 768])
def test_i8pair_group_maxima_match_jax_per_tile_max(group):
    """Row maxima then group maxima of each hidden layer's dz (the plain
    backward's, bf16 values) at a ragged N, against JAX's max|dz| per
    stash_bwd_tile tile as _bwd_stash_kernel's i8pair dw takes it (the
    points padded to whole tiles with zero rows, whose dz is 0)."""
    n = 1000
    cfg = emission_config(n_layers=3, d_filter=64, n_freqs_time=3)
    gen = torch.Generator().manual_seed(group)
    params = init_nerf(gen, cfg, 'cpu')
    pts = torch.rand(n, 4, generator=gen) * 2.6 - 1.3
    dy = torch.randn(n, cfg.d_output, generator=gen)
    with torch.no_grad():
        _, hs, _ = fused_mlp.fused_mlp_stash_reference(cfg, params, pts, 'i8pair')
        dzs = []
        fused_mlp.fused_mlp_stash_bwd_reference(cfg, params, pts, dy, hs, None, 'i8pair',
                                                group=group, dzs=dzs)
    n_pad = -(-n // group) * group
    for j in range(1, cfg.n_layers):
        got = fused_mlp.i8pair_group_maxima(dzs[j], group)
        dz = jnp.pad(jnp.asarray(dzs[j].numpy()).astype(jnp.bfloat16), ((0, n_pad - n), (0, 0)))
        want = jax.vmap(lambda t: jnp.max(jnp.abs(t).astype(jnp.float32)))(
            dz.reshape(-1, group, cfg.d_filter))
        assert got.shape == (n_pad // group,) and float(got.max()) > 0
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize('tn,s0,s1', [(128, 0, 64), (64, 0, 64), (128, 8, 24), (64, 40, 57)])
def test_i8_operands_read_back_through_the_descriptors(tn, s0, s1):
    """A chunk's int8 operands as the build threads write them, read as the
    kernel's wgmma descriptors address them: A for warpgroup wg and k-step
    s at a8 + wg 1024 + 2 s (128 / 8) 128 (leading byte offset (128 / 8)
    128 between the two 16-k core matrices of a k32 step, stride byte
    offset 128 between 8-row groups), B at b8 + 2 s (tn / 8) 128 (leading
    (tn / 8) 128, stride 128); each core matrix row 16 bytes of 16 k. With
    K index k standing for the chunk point i8_point(k) (a permutation of
    0..63), they are the stash box transposed and dz quantized (round half
    to even of the f32 product, plain _dw_i8's rule) for the segment
    [s0, s1), 0 past it."""
    rng = np.random.default_rng(tn + s0)
    box = torch.from_numpy(rng.integers(-127, 128, (64, 128), dtype=np.int8))
    dz = torch.from_numpy(rng.normal(size=(64, tn)).astype(np.float32)).to(torch.bfloat16)
    m = float(dz.float().abs().max())
    scale = float(np.float32(127.0) / np.float32(m))
    a8, b8 = fused_mlp.i8_build_operands(box, dz, s0, s1, scale, tn)
    a8, b8 = a8.numpy(), b8.numpy()
    point = np.array([fused_mlp.i8_point(k) for k in range(64)])
    assert sorted(point) == list(range(64))

    def read(buf, start, rows, lbo, k_steps=2):
        out = np.zeros((rows, 32 * k_steps), np.int8)
        for s in range(k_steps):
            for row in range(rows):
                for k in range(32):
                    at = (start(s) + (row // 8) * 128 + (k // 16) * lbo + (row % 8) * 16
                          + k % 16)
                    out[row, 32 * s + k] = buf[at]
        return out
    a = np.concatenate([read(a8, lambda s, wg=wg: wg * 1024 + 2 * s * 16 * 128, 64, 16 * 128)
                        for wg in range(2)])
    np.testing.assert_array_equal(a, box.numpy()[point].T)
    b = read(b8, lambda s: 2 * s * (tn // 8) * 128, tn, (tn // 8) * 128)
    q = torch.round(dz.float() * torch.tensor(scale, dtype=torch.float32)).to(torch.int8)
    inside = (point >= s0) & (point < s1)
    want = np.where(inside[None, :], q.numpy()[point].T, 0).astype(np.int8)
    assert int(np.count_nonzero(want)) > 0
    np.testing.assert_array_equal(b, want)


def test_lsb_gate_decode_matches_jax_on_every_pattern():
    """The kernels' decode of a packed sin by table (lsb_cos_decode: 1 below
    |s| = 2^-4, 0 from |s| = 1, NaN for a NaN, 512 values between) on all
    65,536 16-bit patterns against JAX's _unpack_sin_cos: the same bits
    wherever JAX's cos is a number, NaN wherever it is NaN; and the same as
    the plain backward's unpack_sin_cos."""
    bits = np.arange(-32768, 32768, dtype=np.int32).astype(np.int16)
    got = fused_mlp.lsb_cos_decode(torch.from_numpy(bits)).numpy()
    _, cos_j = jfm._unpack_sin_cos(jax.lax.bitcast_convert_type(jnp.asarray(bits), jnp.bfloat16))
    want = np.asarray(jax.lax.bitcast_convert_type(cos_j, jnp.int16))
    nan_j = np.isnan(np.asarray(cos_j, np.float32))
    nan = np.isnan(torch.from_numpy(got).view(torch.bfloat16).float().numpy())
    assert nan_j.sum() > 0 and np.array_equal(nan, nan_j)
    np.testing.assert_array_equal(got[~nan_j], want[~nan_j])
    _, plain = fused_mlp.unpack_sin_cos(torch.from_numpy(bits).view(torch.bfloat16))
    np.testing.assert_array_equal(plain.view(torch.int16).numpy()[~nan_j], got[~nan_j])
