"""The layouts that the wgmma backward kernels (csrc/fused_mlp_backward.cuh)
read and write, checked on the CPU against their sources:

  * pack_wgmma_bwd, the chain kernel's ring chunks of W_h^T, and
    pack_wgmma_dpts, the point cotangent's of W_in[:n_enc]^T, unpacked, are
    the JAX package's bf16 weights exactly, at every width the kernels take;
  * the dz scratch, written tile by tile in the chain kernel's core-matrix
    order (the element rule of hopper.cuh core_offset, spelled out here
    apart from ops.fused_mlp.dz_index), unpacked, is the row-major dz of
    fused_mlp_stash_bwd_reference, rows past n left out;
  * the dW kernel's work items (the C plan's enumeration, spelled out
    here, with the ranges of dw_splits) cover every (job, output element,
    point) exactly once, for ragged n too, and give every split a partial
    of every job's tile; the i8pair int8 dW_h kernel's ranges
    (dw_i8_splits) cover every point once, in whole groups and tiles.

All exact: layouts move values, they do not round them.
"""
import jax
import numpy as np
import pytest
import torch

from sunerf_tpu.models.fields import NeRFConfig as JaxNeRFConfig
from sunerf_tpu.models.fields import init_nerf as jax_init_nerf
from sunerf_tpu_torch.models.fields import emission_config, init_nerf, params_from_numpy
from sunerf_tpu_torch.ops import fused_mlp

torch.set_num_threads(1)


def _core_unpack(block: np.ndarray, n_k: int, n_n: int) -> np.ndarray:
    """One K-major no-swizzle block (flat) -> [n_k, n_n]: element (k, n) at
    ((k // 8) * (n_n // 8) + n // 8) * 64 + (n % 8) * 8 + k % 8."""
    k, n = np.meshgrid(np.arange(n_k), np.arange(n_n), indexing='ij')
    return block[((k // 8) * (n_n // 8) + n // 8) * 64 + (n % 8) * 8 + k % 8]


def _bf16_np(x) -> np.ndarray:
    return torch.as_tensor(np.asarray(x, np.float32)).to(torch.bfloat16).float().numpy()


@pytest.mark.parametrize('d_filter', fused_mlp.KERNEL_WIDTHS)
def test_backward_packing_unpacks_to_the_jax_layout(d_filter):
    """pack_wgmma_bwd's chunks, unpacked, are each layer's bf16(w_h[i])^T
    (B [k = out, n = in] of dh = dz w_h^T, so w_h itself read K-major), and
    pack_wgmma_dpts's are bf16(w_in[:n_enc])^T in column blocks of
    dpts_chunk_cols, zero-padded, of JAX-initialised params (3 layers)."""
    jc = JaxNeRFConfig(n_layers=3, d_filter=d_filter, n_freqs=4)
    jp = jax.tree.map(np.array, jax_init_nerf(jax.random.PRNGKey(0), jc))
    params = params_from_numpy(jp, 'cpu')
    h = d_filter
    packed = fused_mlp.pack_wgmma_bwd(params['w_h'].float())
    assert packed.dtype == torch.bfloat16 and packed.shape == (2 * h // 32, 32 * h)
    flat = packed.float().numpy()
    for i in range(2):
        rows = np.concatenate([_core_unpack(c, 32, h) for c in flat[i * h // 32:(i + 1) * h // 32]])
        np.testing.assert_array_equal(rows, _bf16_np(jp['w_h'][i]).T)

    n_enc = jp['w_in'].shape[0]
    cw = fused_mlp.dpts_chunk_cols(h)
    n_cc = -(-n_enc // cw)
    packed = fused_mlp.pack_wgmma_dpts(params['w_in'].float(), n_enc)
    assert packed.dtype == torch.bfloat16 and packed.shape == (n_cc * h // 32, 32 * cw)
    flat = packed.float().numpy()
    cols = np.concatenate([
        np.concatenate([_core_unpack(c, 32, cw) for c in flat[b * h // 32:(b + 1) * h // 32]])
        for b in range(n_cc)], axis=1)
    np.testing.assert_array_equal(cols[:, :n_enc], _bf16_np(jp['w_in']).T)
    np.testing.assert_array_equal(cols[:, n_enc:], 0.0)


@pytest.mark.parametrize('n', [1, 100, 130])
def test_dz_scratch_tile_order_unpacks_to_the_plain_dz(n):
    """The chain kernel's dz scratch order: tile t = point // 64, layer j,
    then K-major core matrices of the tile's [64 x H] (row r = point % 64,
    column c at ((c // 8) * 8 + r // 8) * 64 + (r % 8) * 8 + c % 8). A
    scratch laid out by that rule from the plain backward's dz, unpacked by
    unpack_dz_scratch, is that dz again; dz_index is the same rule."""
    cfg = emission_config(n_layers=3, d_filter=64, n_freqs_time=3)
    gen = torch.Generator().manual_seed(n)
    params = init_nerf(gen, cfg, 'cpu')
    pts = torch.rand(n, 4, generator=gen) * 2.6 - 1.3
    dy = torch.randn(n, cfg.d_output, generator=gen)
    with torch.no_grad():
        _, hs, cs = fused_mlp.fused_mlp_stash_reference(cfg, params, pts)
        dzs = []
        fused_mlp.fused_mlp_stash_bwd_reference(cfg, params, pts, dy, hs, cs, dzs=dzs)
    L, H = cfg.n_layers, cfg.d_filter
    ref = torch.cat(dzs, 1).to(torch.bfloat16)
    assert ref.shape == (n, L * H) and float(ref.float().abs().max()) > 0
    pt, j, c = np.meshgrid(np.arange(n), np.arange(L), np.arange(H), indexing='ij')
    r = pt % 64
    at = (((pt // 64) * L + j) * 64 * H
          + ((c // 8) * 8 + r // 8) * 64 + (r % 8) * 8 + c % 8)
    np.testing.assert_array_equal(fused_mlp.dz_index(pt, j, c, L, H), at)
    size = fused_mlp.dz_scratch_size(n, L, H)
    assert size == -(-n // 64) * 64 * L * H
    scratch = torch.zeros(size, dtype=torch.bfloat16)
    scratch[torch.from_numpy(at.reshape(-1))] = ref.reshape(n, L, H).reshape(-1)
    assert torch.equal(fused_mlp.unpack_dz_scratch(scratch, n, L, H), ref)


def _dw_items(H: int, e_pad: int, jobs: int, pps: int, splits: int, n: int) -> list:
    """The dW kernel's work items as csrc/fused_mlp_backward.cuh dw_plan and
    dw_item decode them, spelled out here: item it -> split it // per_split,
    then job 0's mt0 x nt tiles (e_pad rows), then each further job's mt x
    nt (H rows), row tile by column tile; 128 rows and TN = 256, 128 or 64
    columns a tile. Each item as (split, job, row0, row1, col0, col1,
    point0, point1), rows clipped to the job's, points to n."""
    tn = 256 if H % 256 == 0 else 128 if H % 128 == 0 else 64
    mt0, mt, nt = -(-e_pad // 128), -(-H // 128), H // tn
    per_split = mt0 * nt + (jobs - 1) * mt * nt
    items = []
    for it in range(splits * per_split):
        split, r = divmod(it, per_split)
        job = 0
        if r >= mt0 * nt:
            job, r = divmod(r - mt0 * nt, mt * nt)
            job += 1
        mtile, ntile = divmod(r, nt)
        m_rows = e_pad if job == 0 else H
        p0 = split * pps
        items.append((split, job, mtile * 128, min(m_rows, (mtile + 1) * 128), ntile * tn,
                      (ntile + 1) * tn, p0, max(p0, min(n, p0 + pps))))
    return items


@pytest.mark.parametrize('d_filter,n_layers,n,fmt', [
    (64, 3, 1, 'int8'), (128, 4, 4097, 'int8'), (384, 6, 65541, 'int8'),
    (512, 8, 196608, 'int8'), (512, 8, 1000, 'i8pair'), (256, 1, 777, 'lsb')])
def test_dw_plan_covers_every_point_once(d_filter, n_layers, n, fmt):
    """With dw_splits's ranges, the dW kernel's items give every (job,
    output tile) one item per split, the tiles of a job partition its
    [rows x H] output, and the splits' point ranges partition [0, n) in
    order: each (job, element, point) is summed exactly once and every
    partial the reduction reads is written. 'i8pair' leaves its hidden
    layers' dW to the int8 kernel (job 0 only)."""
    cfg = emission_config(n_layers=n_layers, d_filter=d_filter, n_freqs_time=3)
    e_pad = -(-cfg.d_encoded // 16) * 16
    pps, splits = fused_mlp.dw_splits(cfg, n, e_pad, 132, fmt)
    assert pps % 64 == 0 and splits * pps >= n > (splits - 1) * pps
    n_jobs = 1 if fmt == 'i8pair' else n_layers
    items = _dw_items(d_filter, e_pad, n_jobs, pps, splits, n)
    jobs = range(n_jobs)
    seen = {}
    for s, job, m0, m1, c0, c1, p0, p1 in items:
        assert job in jobs and (s, job, m0, c0) not in seen
        seen[(s, job, m0, c0)] = (m1, c1, p0, p1)
        assert d_filter % (c1 - c0) == 0
    for job in jobs:
        m_rows = e_pad if job == 0 else d_filter
        cover = np.zeros((m_rows, d_filter), int)
        tiles = {(m0, c0) for (s, jb, m0, c0) in seen if jb == job}
        for m0, c0 in tiles:
            m1, c1, _, _ = seen[(0, job, m0, c0)]
            cover[m0:m1, c0:c1] += 1
            points = np.zeros(n, int)
            for s in range(splits):
                _, _, p0, p1 = seen[(s, job, m0, c0)]
                assert p0 == s * pps
                points[p0:p1] += 1
            assert (points == 1).all()
        assert (cover == 1).all()


@pytest.mark.parametrize('n,group,want', [(262144, 768, 7), (196608, 768, 7), (1000, 768, 1),
                                          (65541, 100, 7)])
def test_i8pair_int8_dw_ranges_cover_every_point_once(n, group, want):
    """'i8pair''s int8 dW_h kernel (csrc/fused_mlp_backward.cuh
    dw_i8_wgmma_kernel) takes dw_i8_splits's ranges of pps8 points: each
    starts at a multiple of pps8, itself a multiple of the scale group and
    of the 64-point dz tile (every range whole groups and tiles), and they
    partition [0, n); at 8x512 there are as many as fill the last wave of
    its 7 x 4 x 4 work items a range best on 132 SMs, so its partials
    [splits][7 H^2] f32 stay at splits x 7.3 MB whatever the wgmma dW_in's
    split count."""
    cfg = emission_config(n_layers=8, d_filter=512)
    pps, splits = fused_mlp.dw_i8_splits(cfg, n, group, 132)
    assert splits == want and pps % 64 == 0 and pps % group == 0
    assert splits * pps >= n > (splits - 1) * pps
    points = np.zeros(n, int)
    for s in range(splits):
        points[s * pps:min(n, (s + 1) * pps)] += 1
    assert (points == 1).all()
