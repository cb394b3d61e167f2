"""The layouts that the wgmma backward kernels (csrc/fused_mlp_backward.cuh)
read and write, checked on the CPU against their sources:

  * pack_wgmma_bwd, the chain kernel's ring chunks of W_h^T, and
    pack_wgmma_dpts, the point cotangent's of W_in^T with its columns
    ordered by dimension (dpts_layout), unpacked, are the JAX package's
    bf16 weights exactly, at every width the kernels take;
  * the point cotangent's column tables (dpts_layout's pairs and groups),
    read as the chain kernel's tail reads them (a mirror of its epilogue),
    give the plain version's dpts, for any d_input;
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
from sunerf_tpu_torch.core.encoding import encoding_columns
from sunerf_tpu_torch.models.fields import NeRFConfig, emission_config, init_nerf, params_from_numpy
from sunerf_tpu_torch.ops import fused_mlp

torch.set_num_threads(1)


def _core_unpack(block: np.ndarray, n_k: int, n_n: int) -> np.ndarray:
    """One K-major no-swizzle block (flat) -> [n_k, n_n]: element (k, n) at
    ((k // 8) * (n_n // 8) + n // 8) * 64 + (n % 8) * 8 + k % 8."""
    k, n = np.meshgrid(np.arange(n_k), np.arange(n_n), indexing='ij')
    return block[((k // 8) * (n_n // 8) + n // 8) * 64 + (n % 8) * 8 + k % 8]


def _bf16_np(x) -> np.ndarray:
    return torch.as_tensor(np.asarray(x, np.float32)).to(torch.bfloat16).float().numpy()


@pytest.mark.parametrize('d_filter', fused_mlp.KERNEL_WIDTHS + (32, 96))
def test_backward_packing_unpacks_to_the_jax_layout(d_filter):
    """pack_wgmma_bwd's chunks, unpacked, are each layer's bf16(w_h[i])^T
    (B [k = out, n = in] of dh = dz w_h^T, so w_h itself read K-major), and
    pack_wgmma_dpts's are bf16(w_in)^T's columns in dpts_layout's order
    (zeros where it has -1), in column blocks of dpts_chunk_cols, of
    JAX-initialised params (3 layers): x_d, a zero, then each phase's sin
    and cos columns, dimension by dimension. A width outside KERNEL_WIDTHS
    (32, 96) is packed as the card packs it, zero-padded to the next kernel
    width (pad_field): JAX's parameters with zero rows and columns."""
    jc = JaxNeRFConfig(n_layers=3, d_filter=d_filter, n_freqs=4)
    jp = jax.tree.map(np.array, jax_init_nerf(jax.random.PRNGKey(0), jc))
    cfg = emission_config(n_layers=3, d_filter=d_filter, n_freqs=4)
    cfg, params = fused_mlp.pad_field(cfg, params_from_numpy(jp, 'cpu'))
    h = cfg.d_filter
    pad = h - d_filter
    jp = dict(jp, w_h=np.pad(jp['w_h'], ((0, 0), (0, pad), (0, pad))),
              w_in=np.pad(jp['w_in'], ((0, 0), (0, pad))))
    packed = fused_mlp.pack_wgmma_bwd(params['w_h'].float())
    assert packed.dtype == torch.bfloat16 and packed.shape == (2 * h // 32, 32 * h)
    flat = packed.float().numpy()
    for i in range(2):
        rows = np.concatenate([_core_unpack(c, 32, h) for c in flat[i * h // 32:(i + 1) * h // 32]])
        np.testing.assert_array_equal(rows, _bf16_np(jp['w_h'][i]).T)

    d_in = jc.d_input
    dims, _ = encoding_columns(d_in, jc.n_freqs, jc.scale_factor, jc.n_freqs_time)
    order, _, _ = fused_mlp.dpts_layout(d_in, dims, h)
    cw = fused_mlp.dpts_chunk_cols(h)
    n_cc = len(order) // cw
    assert len(order) == n_cc * cw and sorted(c for c in order if c >= 0) == list(
        range(jp['w_in'].shape[0]))
    packed = fused_mlp.pack_wgmma_dpts(params['w_in'].float(), d_in, dims)
    assert packed.dtype == torch.bfloat16 and packed.shape == (n_cc * h // 32, 32 * cw)
    flat = packed.float().numpy()
    cols = np.concatenate([
        np.concatenate([_core_unpack(c, 32, cw) for c in flat[b * h // 32:(b + 1) * h // 32]])
        for b in range(n_cc)], axis=1)
    w_t = _bf16_np(jp['w_in']).T
    for c, e in enumerate(order):
        np.testing.assert_array_equal(cols[:, c], w_t[:, e] if e >= 0 else 0.0)
    # x_d first in its dimension's segment, then (sin_j, cos_j) pairs of dims[j] == d
    for c in range(0, len(order), 2):
        e = order[c]
        if e >= d_in:
            j = e - d_in
            assert order[c + 1] == d_in + len(dims) + j


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


@pytest.mark.parametrize('d_input,d_filter,n_freqs_time,n_freqs', [
    (3, 64, None, 4), (4, 128, 3, 4), (4, 512, None, 4), (12, 64, None, 4),
    (12, 384, None, 4), (3, 64, None, 16)])
def test_dpts_tables_give_the_plain_point_cotangent(d_input, d_filter, n_freqs_time, n_freqs):
    """A mirror of the chain kernel's K3 tail: denc over pack_wgmma_dpts's
    column order (dz_0 times W_in^T's columns in dpts_layout's order), each
    column pair's term from `pairs` (a phase's f (cos u dsin - sin u dcos),
    x_d's denc, or zero), summed per 8-column group as the lanes' butterfly
    does, and the groups added into their dimension (`gdim`) in column
    order, equals the plain version's dpts within f32 rounding (1e-5 of
    max), for any d_input and with the time axis's bands cut. A dimension's
    groups lie in one half of a chunk (the columns one warpgroup sums)
    unless its segment is longer than a half (16 bands at H = 64)."""
    cfg = NeRFConfig(d_input=d_input, d_output=2, n_layers=2, d_filter=d_filter,
                     n_freqs=n_freqs, n_freqs_time=n_freqs_time)
    gen = torch.Generator().manual_seed(d_input + d_filter)
    params = init_nerf(gen, cfg, 'cpu')
    n = 37
    pts = torch.rand(n, d_input, generator=gen) * 2.6 - 1.3
    dz0 = torch.randn(n, d_filter, generator=gen).to(torch.bfloat16).float()
    ref = fused_mlp._point_cotangent(cfg, params, pts, dz0)
    dims, freqs = encoding_columns(d_input, cfg.n_freqs, cfg.scale_factor, n_freqs_time)
    order, pairs, gdim = fused_mlp.dpts_layout(d_input, dims, d_filter)
    cols = torch.tensor(order)
    w = params['w_in'].to(torch.bfloat16).float()
    acc = dz0 @ torch.where((cols >= 0)[:, None], w[cols.clamp_min(0)], 0.0).t()
    v0, v1 = acc[:, 0::2], acc[:, 1::2]
    pr = torch.tensor(pairs)
    j = pr.clamp_min(0)
    f = torch.tensor(freqs)[j]
    u = pts[:, torch.tensor(dims)[j]] * f
    t = (fused_mlp.reduced_sin(u + fused_mlp._HALF_PI) * v0) * f \
        - (fused_mlp.reduced_sin(u) * v1) * f
    t = torch.where(pr >= 0, t, torch.where(pr < -1, v0, torch.zeros_like(v0)))
    q = t.view(n, -1, 4)
    groups = (q[..., 0] + q[..., 1]) + (q[..., 2] + q[..., 3])
    got = torch.zeros(n, d_input)
    for g, d in enumerate(gdim):
        if d < d_input:    # d_input marks the zero groups after the last
            got[:, d] += groups[:, g]
    assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
    half = fused_mlp.dpts_chunk_cols(d_filter) // 16
    straddles = [b for b in range(half, len(gdim), half)
                 if gdim[b] < d_input and gdim[b - 1] == gdim[b]]
    fits = 2 + 2 * max(dims.count(d) for d in range(d_input)) <= 8 * half
    assert (not straddles) if fits else straddles
