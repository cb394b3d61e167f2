"""The wide route's GEMM (csrc/wide_mlp.cuh wide_wgmma_kernel) and 'i8pair'
dW_h (wide_dw_i8_wgmma_kernel, its scale groups' maxima from the chain's
epilogue): their host plans, mirrored in ops/wide_mlp.py, on the CPU (a
product's N tile, a dW product's ranges of the points, 'i8pair''s ranges of
whole scale groups, the arrival counters' length, every TMA operand's row
stride and base offset), the int8 dW_h's operand builds and the groups'
maxima through their mirrors against _dw_i8 and i8pair_group_maxima, and
the kernels against their plain versions on the card. The card tests skip
without one; run them there with

    python -m pytest --noconftest -m gpu tests/test_torch_wide_gemm.py -q

This file imports no JAX (tests/test_torch_wide.py holds the plain versions
to JAX's kernels). Tolerances on the card, as fractions of max|plain|:
  * the wide K0 within 2e-2 at the 99.99th percentile and 1e-1 at most
    (chip_smoke's KERNEL_TOL and KERNEL_MAX_TOL: bf16 operands on both
    sides, single rounding flips compound over the layers);
  * the parameter gradients within 3e-2 (tests/test_fused_mlp.py holds the
    JAX kernel's to 3%), 'i8pair''s within 6e-2 (its :163: the dz scale
    moves with any flip of a group's max), dpts within 5e-2 (:85);
  * every gradient the same bits twice (fixed summation orders, no float
    atomics);
  * 'i8pair''s dW_h kernel alone _dw_i8's bits in one range of the points
    (the int32 sums are exact and the f32 steps are _dw_i8's), within 1e-5
    of max in the ranges of i8_plan (only the ranges' f32 sum is taken in
    another order); the groups' maxima the bits of i8pair_group_maxima.
"""
import ctypes
import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from sunerf_tpu_torch.models.fields import NeRFConfig, emission_config, init_nerf
from sunerf_tpu_torch.ops import fused_mlp, wide_mlp

torch.set_num_threads(1)

KEYS = ('w_in', 'b_in', 'w_h', 'b_h', 'w_out', 'b_out')
SMS = 132


# ------------------------------------------------------------ host plans

@pytest.mark.parametrize('n,min_tn,tn', [
    (1024, 128, 256), (640, 128, 128), (512, 128, 256), (528, 128, 128), (768, 128, 256),
    (64, 128, 128), (8, 128, 128), (2, 8, 8), (9, 8, 16), (16, 8, 16), (17, 8, 32),
    (36, 8, 64), (2, 64, 64), (1024, 64, 256), (48, 64, 64), (100, 64, 128)])
def test_tile_n(n, min_tn, tn):
    """The N tile: the layers and the chain 128 or 256 (whichever pads N
    less), the head 8 or 16 for o_pad, MN-major B from 64."""
    assert wide_mlp.tile_n(n, min_tn) == tn
    assert tn >= min_tn and tn in (8, 16, 32, 64, 128, 256)
    if n <= 128:
        assert tn >= n


@pytest.mark.parametrize('m,n_out,points', [
    (1024, 1024, 196608), (48, 1024, 196608), (1024, 2, 196608), (640, 640, 65536),
    (640, 9, 48), (520, 520, 1000), (64, 64, 777), (1024, 1024, 65536), (96, 640, 1)])
def test_dw_plan_sums_each_point_once_in_order(m, n_out, points):
    """A dW product's ranges of the points: k_split a multiple of the ring's
    64, every range non-empty, the ranges [s k_split, (s+1) k_split)
    covering each point exactly once and in order (the last block of a tile
    sums them in that order), at most WIDE_MAX_SPLITS of them, and no more
    work items than the card's blocks once there is more than one range."""
    tn, splits, k_split = wide_mlp.dw_plan(m, n_out, points, SMS)
    assert tn == wide_mlp.tile_n(n_out, 64)
    assert k_split % wide_mlp.TILE_K == 0 and 1 <= splits <= wide_mlp.WIDE_MAX_SPLITS
    covered = []
    for s in range(splits):
        lo, hi = s * k_split, min(points, (s + 1) * k_split)
        assert lo < hi
        covered.extend(range(lo, hi))
    assert covered == list(range(points))
    tiles = -(-m // wide_mlp.TILE_M) * -(-n_out // tn)
    assert splits == 1 or splits * tiles <= SMS


@pytest.mark.parametrize('h,points,group', [
    (1024, 196608, 768), (640, 65536, 8), (640, 65536, 40), (640, 48, 40), (640, 48, 768),
    (64, 777, 24), (1024, 196608, 133144), (520, 1000, 1), (640, 65536, 7)])
def test_i8_plan_holds_whole_groups(h, points, group):
    """'i8pair''s dW_h ranges: whole scale groups (k_split a multiple of the
    group), each point once and in order, at most WIDE_MAX_SPLITS; one wave
    of the persistent walk (no more work items than the card's blocks once
    there is more than one range), and as many ranges as that and 1024
    points a range allow, less only where whole groups round them up."""
    splits, k_split = wide_mlp.i8_plan(h, points, group, SMS)
    assert k_split % group == 0 and 1 <= splits <= wide_mlp.WIDE_MAX_SPLITS
    bounds = [(s * k_split, min(points, (s + 1) * k_split)) for s in range(splits)]
    assert all(lo < hi for lo, hi in bounds) and bounds[-1][1] == points
    assert all(b[1] == c[0] for b, c in zip(bounds, bounds[1:]))
    for lo, _ in bounds:
        assert lo % group == 0          # a range starts on a group's first point
    tiles = wide_mlp.i8_tiles(h)
    assert tiles == (-(-h // 128)) ** 2
    assert splits == 1 or splits * tiles <= SMS
    want = max(1, min(SMS // tiles, 16, -(-points // 1024)))
    assert splits <= want and (splits == want or k_split < -(-points // want) + group)


@pytest.mark.parametrize('layers,width,d_output,grid', [
    (8, 1024, 2, ()), (2, 640, 9, ()), (8, 512, 16, ()), (2, 520, 3, ()), (2, 64, 5, ()),
    (2, 640, 2, (16, 32)), (3, 8, 16, ())])
def test_tma_operands_are_16_byte_aligned(layers, width, d_output, grid):
    """Every TMA operand of the wide GEMM at wide_width: row strides and
    base offsets multiples of 16 bytes, so that a tensor map takes them
    (the width padded to 8, e_pad to 16, o_pad to 8); and the arrival
    counters cover each dW product's tiles."""
    cfg = NeRFConfig(n_layers=layers, d_filter=wide_mlp.wide_width(width), d_output=d_output,
                     n_freqs=4, grid_sizes=grid, grid_features=4 if grid else 0)
    for name, (stride, offset) in wide_mlp.operand_row_bytes(cfg).items():
        assert stride % 16 == 0 and offset % 16 == 0, (name, stride, offset)
    h, ep = cfg.d_filter, wide_mlp.e_pad(cfg)
    for m, n in ((ep, h), (h, h), (h, d_output)):
        tiles = -(-m // wide_mlp.TILE_M) * -(-n // wide_mlp.tile_n(n, 64))
        assert tiles <= wide_mlp.dw_tiles(cfg)


def test_wide_i8pair_takes_any_group_by_the_plain_version():
    """The wide route's 'i8pair' backward takes a scale group that is no
    multiple of 32 (the CPU runs the plain version; the card the kernel, in
    the gpu tests below), and still refuses one whose int32 sums could
    overflow."""
    cfg = NeRFConfig(n_layers=2, d_filter=64, d_output=5, n_freqs=2)
    gen = torch.Generator().manual_seed(3)
    p = init_nerf(gen, cfg, 'cpu')
    pts = torch.rand(40, 4, generator=gen) * 2.6 - 1.3
    dy = torch.randn(40, 5, generator=gen)
    _, hs, cs = fused_mlp.fused_mlp_stash_forward(cfg, p, pts, 'i8pair')
    for group in (8, 40):
        got = wide_mlp.wide_stash_backward(cfg, p, pts, dy, hs, cs, 'i8pair', True, group)
        ref = fused_mlp.fused_mlp_stash_bwd_reference(cfg, p, pts, dy, hs, cs, 'i8pair', True,
                                                      group)
        for k in ref:
            assert torch.equal(got[k], ref[k]), (group, k)
    with pytest.raises(ValueError, match='stash_bwd_tile'):
        fused_mlp._check_group(133145)


# ------------------------------------- 'i8pair''s dW_h through its mirrors

def _read_operand(buf: torch.Tensor) -> torch.Tensor:
    """An int8 operand [128 rows, 64 k] read back at
    fused_mlp.i8_operand_index, where wgmma's descriptors address it."""
    rows, ks = torch.arange(128).view(128, 1), torch.arange(64).view(1, 64)
    return buf[fused_mlp.i8_operand_index(128, rows, ks)]


@pytest.mark.parametrize('s0,s1', [(0, 64), (8, 24), (40, 57), (63, 64)])
def test_wide_i8_operands_read_back_through_the_descriptors(s0, s1):
    """A chunk's int8 operands as the build threads write them from the
    stash box and dz's row-major boxes (both as TMA leaves them, 128-byte
    swizzled; dz's columns past the width TMA's zeros), read as the
    kernel's wgmma descriptors address them (warpgroup wg and k-step s at A
    + wg 1024 + 2 s 16 128, B + 2 s 16 128, leading byte offset 16 128
    between a k32 step's two core matrices, stride 128 between 8-row
    groups): with K index k standing for chunk point i8_point(k), the stash
    box transposed and dz quantized (round half to even of the f32 product,
    _dw_i8's rule) for the segment [s0, s1), 0 past it."""
    rng = np.random.default_rng(s0 + 64 * s1)
    box = torch.from_numpy(rng.integers(-127, 128, (64, 128), dtype=np.int8))
    dz = torch.from_numpy(rng.normal(size=(64, 128)).astype(np.float32)).to(torch.bfloat16)
    dz[:, 80:] = 0           # a tile past the width: TMA's zero fill
    scale = float(np.float32(127.0) / np.float32(dz.float().abs().max()))
    a8, b8 = wide_mlp.i8_build_operands(box, dz, s0, s1, scale)
    point = torch.tensor([fused_mlp.i8_point(k) for k in range(64)])
    assert sorted(point.tolist()) == list(range(64))

    def read(buf, start, rows):
        row, k = torch.arange(rows).view(rows, 1), torch.arange(32).view(1, 32)
        return torch.cat([buf[start(s) + (row // 8) * 128 + (k // 16) * 16 * 128
                              + (row % 8) * 16 + k % 16] for s in range(2)], dim=1)
    for wg in range(2):
        a = read(a8, lambda s, wg=wg: wg * 1024 + 2 * s * 16 * 128, 64)
        assert torch.equal(a, box[point, 64 * wg:64 * (wg + 1)].t())
    b = read(b8, lambda s: 2 * s * 16 * 128, 128)
    q = torch.round(dz.float() * torch.tensor(scale, dtype=torch.float32)).to(torch.int8)
    inside = ((point >= s0) & (point < s1)).view(1, 64)
    want = torch.where(inside, q[point].t(), torch.zeros((), dtype=torch.int8))
    assert int(torch.count_nonzero(want)) > 0
    assert torch.equal(b, want)
    assert torch.equal(_read_operand(a8), box[point].t())


def _emulate_dw_i8(stash, a_x, dz, group, k_split, tiles):
    """wide_dw_i8_wgmma_kernel on the CPU through its mirrors, at the output
    tiles `tiles` ((m tile, n tile) pairs): the groups' maxima from the
    chain's row words (dz_row_maxima, dz_group_maxima); for each range of
    k_split points, its chunks of 64 from the range's first point, each
    group segment's operands built (i8_build_operands, from the stash and
    dz boxes as TMA fills them: zeros past n and past the stash's or dz's
    columns) and multiplied exactly, each group's int32 sum to f32 and
    scaled by f32(m (1/127)^2) group after group; the ranges' partials
    summed in range order. -> dW_h [h, h] f32 (zero outside `tiles`)."""
    n, h = dz.shape
    gmax = wide_mlp.dz_group_maxima(wide_mlp.dz_row_maxima(dz, wide_mlp.tile_n(h, 128)), group)
    inv_sq = torch.tensor(fused_mlp._INV_COS_SQ, dtype=torch.float32)
    splits = -(-n // k_split)
    out = torch.zeros((h, h), dtype=torch.float32)
    pad_s = F.pad(stash, (0, 256, 0, 64))
    pad_dz = F.pad(dz, (0, 128, 0, 64))
    for mt, nt in tiles:
        total = torch.zeros((128, 128), dtype=torch.float32)
        for split in range(splits):
            p0, p1 = split * k_split, min(n, (split + 1) * k_split)
            acc_f = torch.zeros((128, 128), dtype=torch.float32)
            g0 = p0
            while g0 < p1:
                grp = g0 // group
                g1 = min(p1, (grp + 1) * group)
                m = gmax[grp]
                scale = float(torch.tensor(127.0) / m) if float(m) > 0 else 0.0
                acc_i = torch.zeros((128, 128), dtype=torch.int64)
                s0 = g0
                while s0 < g1:
                    c = p0 + ((s0 - p0) & ~63)
                    s1 = min(g1, min(c + 64, p1))
                    box = pad_s[c:c + 64, a_x + 128 * mt:a_x + 128 * mt + 128]
                    dzb = pad_dz[c:c + 64, 128 * nt:128 * nt + 128].clone()
                    if 128 * nt + 128 > h:        # past dz's columns: TMA's zeros
                        dzb[:, max(0, h - 128 * nt):] = 0
                    if c + 64 > n:                # past n: zeros
                        box = box.clone()
                        box[max(0, n - c):] = 0
                    a8, b8 = wide_mlp.i8_build_operands(box, dzb, s0 - c, s1 - c, scale)
                    acc_i += _read_operand(a8).long() @ _read_operand(b8).long().t()
                    s0 = s1
                acc_f = acc_f + acc_i.float() * (m * inv_sq)
                g0 = g1
            total = acc_f if splits == 1 else total + acc_f
        rows, cols = min(128, h - 128 * mt), min(128, h - 128 * nt)
        out[128 * mt:128 * mt + rows, 128 * nt:128 * nt + cols] = total[:rows, :cols]
    return out


@pytest.mark.parametrize('h,group,n', [(528, 1, 150), (528, 8, 300), (640, 24, 300),
                                       (640, 40, 300), (528, 40, 300)])
def test_wide_dw_i8_mirror_matches_dw_i8(h, group, n):
    """wide_dw_i8_wgmma_kernel's computation through its mirrors against
    _dw_i8 on the layer's sin8 (layer 1 of three: the stash columns past
    h hold the layer's cos8, which the tile's rows past h read and drop), at
    chunks that cross group boundaries (groups 1, 8, 24, 40) and a ragged n:
    in one range the bits of _dw_i8, in ranges of a few groups (not
    multiples of 64: chunks start at each range's first point) within 1e-5
    of max. The tiles: the first, the last (rows and columns past h at
    528) and one inside."""
    rng = np.random.default_rng(h + group)
    L = 3
    stash = torch.from_numpy(rng.integers(-127, 128, (n, 2 * L * h), dtype=np.int8))
    # dz at scales that move from group to group, exact bf16 values
    dz = torch.from_numpy((rng.normal(size=(n, h)) * np.exp(rng.normal(size=(n, 1))))
                          .astype(np.float32)).to(torch.bfloat16)
    dz[: min(n, 2 * group)] = 0        # a group whose maximum is 0
    a_x = 2 * 1 * h
    t = -(-h // 128) - 1
    tiles = [(0, 0), (t, t), (t // 2, t - 1)]
    want = fused_mlp._dw_i8(stash[:, a_x:a_x + h], dz.float(), group)
    one = _emulate_dw_i8(stash, a_x, dz, group, -(-n // group) * group, tiles)
    for mt, nt in tiles:
        sl = (slice(128 * mt, 128 * mt + 128), slice(128 * nt, 128 * nt + 128))
        assert torch.equal(one[sl], want[sl]), (mt, nt)
    k_split = group * max(1, -(-n // (3 * group)))
    ranged = _emulate_dw_i8(stash, a_x, dz, group, k_split, tiles)
    for mt, nt in tiles:
        sl = (slice(128 * mt, 128 * mt + 128), slice(128 * nt, 128 * nt + 128))
        assert float((ranged[sl] - want[sl]).abs().max()) <= 1e-5 * float(want.abs().max())


@pytest.mark.parametrize('group', [1, 8, 24, 768])
def test_wide_group_maxima_from_row_words(group):
    """The scale groups' maxima as the wide route finds them: each point's
    max |dz| over a chain tile's columns (a word a (tile, point), the
    chain's epilogue), then each group's over its points and the tiles
    (wide_dz_group_max_kernel), mirrored by dz_row_maxima and
    dz_group_maxima: the bits of i8pair_group_maxima at a ragged n and a
    width of 528 (tiles of 128, the last of 16 columns), NaN, infinities,
    negative zeros and all-zero groups included."""
    rng = np.random.default_rng(group)
    n, h = 1001, 528
    dz = torch.from_numpy(rng.normal(size=(n, h)).astype(np.float32)).to(torch.bfloat16)
    dz[:group] = 0
    dz[group:2 * group] = -0.0
    dz[500, 520] = float('nan')
    dz[800, 3] = float('-inf')
    dz[999, 515] = 1e30
    tn = wide_mlp.tile_n(h, 128)
    rows = wide_mlp.dz_row_maxima(dz, tn)
    assert rows.shape == (-(-h // tn), n) and rows.dtype == torch.int32
    got = wide_mlp.dz_group_maxima(rows, group)
    want = fused_mlp.i8pair_group_maxima(dz.float(), group)
    assert got.shape == want.shape == (-(-n // group),)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert bool(torch.isnan(got).any()) and bool(torch.isinf(got).any())


# ------------------------------------------------------------ on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the kernel has no CPU mode')
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device('cuda')


def _field(device, layers, width, d_output, n, seed):
    cfg = dataclasses.replace(emission_config(n_layers=layers, d_filter=width), d_output=d_output)
    gen = torch.Generator(device=device).manual_seed(seed)
    p = init_nerf(gen, cfg, device)
    pts = torch.rand(n, 4, generator=gen, device=device) * 2.6 - 1.3
    pts[:, 3] = torch.rand(n, generator=gen, device=device)
    dy = torch.randn(n, d_output, generator=gen, device=device)
    return cfg, p, pts, dy


def _rel(ref: torch.Tensor, got: torch.Tensor) -> float:
    return float((got.double() - ref.double()).abs().max()
                 / ref.double().abs().max().clamp_min(1e-30))


@pytest.mark.gpu
@pytest.mark.parametrize('group', [8, 40])
def test_wide_i8pair_backward_any_group_on_the_card(cuda, group):
    """Wide K6b at scale groups 8 and 40 (no multiple of 32) on a 2x640 /
    d_output 9 field at 3,001 points (a partial last group) against the
    plain version fed the kernel's own stash, and the same bits twice."""
    cfg, p, pts, dy = _field(cuda, 2, 640, 9, 3001, seed=group)
    _, hs, cs = fused_mlp.fused_mlp_stash_forward(cfg, p, pts, 'i8pair')
    got = wide_mlp.wide_stash_backward(cfg, p, pts, dy, hs, cs, 'i8pair', True, group)
    again = wide_mlp.wide_stash_backward(cfg, p, pts, dy, hs, cs, 'i8pair', True, group)
    ref = fused_mlp.fused_mlp_stash_bwd_reference(cfg, p, pts, dy, hs, cs, 'i8pair', True, group)
    for k in ref:
        assert torch.equal(got[k], again[k]), k
        assert _rel(ref[k], got[k]) < (5e-2 if k == 'dpts' else 6e-2), k


@pytest.mark.gpu
@pytest.mark.parametrize('layers,width,d_output,n', [
    (2, 640, 9, 5000), (2, 528, 3, 1000), (3, 1024, 2, 4099)])
def test_wide_gemm_at_ragged_tiles_on_the_card(cuda, layers, width, d_output, n):
    """The GEMM where N is no multiple of the tile (528: tiles of 128 past
    the width; the heads' 9 and 3 outputs in tiles of 16 and 8; points no
    multiple of 128) and at a width that is no multiple of 256 (640): K0, K1
    and K2 against the plain versions, K2's bits twice, and the products on
    wide_wgmma_kernel by name."""
    cfg, p, pts, dy = _field(cuda, layers, width, d_output, n, seed=width)
    assert fused_mlp.kernel_route(cfg) == 'wide'
    before = {**fused_mlp.kernel_launches('wide_mlp_fwd'),
              **fused_mlp.kernel_launches('wide_mlp_bwd')}
    with torch.no_grad():
        out = fused_mlp.fused_mlp_forward(cfg, p, pts)
        ref = fused_mlp.fused_mlp_reference(cfg, p, pts)
    d = (out - ref).abs().amax(dim=1).double()
    m = float(ref.abs().max())
    assert float(torch.quantile(d.cpu(), 0.9999)) <= 2e-2 * m and float(d.max()) <= 1e-1 * m
    o1, hs, cs = fused_mlp.fused_mlp_stash_forward(cfg, p, pts)
    assert _rel(out, o1) <= 1e-5
    got = fused_mlp.fused_mlp_stash_backward(cfg, p, pts, dy, hs, cs, compute_dpts=True)
    again = fused_mlp.fused_mlp_stash_backward(cfg, p, pts, dy, hs, cs, compute_dpts=True)
    gref = fused_mlp.fused_mlp_stash_bwd_reference(cfg, p, pts, dy, hs, cs, 'int8', True)
    for k in gref:
        assert torch.equal(got[k], again[k]), k
        assert _rel(gref[k], got[k]) < (5e-2 if k == 'dpts' else 3e-2), k
    after = {**fused_mlp.kernel_launches('wide_mlp_fwd'),
             **fused_mlp.kernel_launches('wide_mlp_bwd')}
    delta = {k: after[k] - before[k] for k in after}
    # K0 and K1: L layers and the head each; K2 twice: the chain's L and dW's L + 1 products
    assert delta['wide_wgmma_kernel'] == 2 * (layers + 1)
    assert delta['wide_wgmma_kernel chain'] == 2 * layers
    assert delta['wide_wgmma_kernel dW'] == 2 * (layers + 1)
    assert delta['wide_wgmma_kernel denc'] == 2


P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
I8_GROUPS = (1, 8, 40, 768, 133144)


def _i8_probe(entry: str, argtypes: tuple, *args):
    """A C entry of csrc/wide_gemm_probe.cu on the current stream, then a
    synchronize; raises on its CUDA error."""
    from sunerf_tpu_torch.ops import build
    fn = getattr(build.load('wide_gemm_probe'), f'sunerf_{entry}')
    fn.argtypes = [*argtypes, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(*args, torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert err == 0, f'{entry}: CUDA error {err}'


@pytest.mark.gpu
@pytest.mark.parametrize('h', [528, 640, 1024])
def test_wide_dw_i8_kernel_alone_on_the_card(cuda, h):
    """wide_dw_i8_wgmma_kernel alone on layer 1's sin8 of a three-layer
    stash and a dz whose scale moves from point to point, at 3,001 points
    and groups 1, 8, 40, 768 and 133,144: in one range the bits of _dw_i8;
    in i8_plan's ranges within 1e-5 of max, the same bits twice, and the
    arrival counters back at zero."""
    n, L = 3001, 3
    gen = torch.Generator(device=cuda).manual_seed(h)
    stash = torch.randint(-127, 128, (n, 2 * L * h), generator=gen, device=cuda,
                          dtype=torch.int8)
    dz = (torch.randn(n, h, generator=gen, device=cuda)
          * torch.exp(torch.randn(n, 1, generator=gen, device=cuda))).to(torch.bfloat16)
    a_x = 2 * h
    part = torch.empty(wide_mlp.WIDE_MAX_SPLITS * h * h, device=cuda)
    count = torch.zeros(wide_mlp.i8_tiles(h), dtype=torch.int32, device=cuda)
    for group in I8_GROUPS:
        gmax = fused_mlp.i8pair_group_maxima(dz.float(), group).view(torch.int32).contiguous()
        want = fused_mlp._dw_i8(stash[:, a_x:a_x + h], dz.float(), group)
        outs = []
        for ranged in (0, 1, 1):
            out = torch.empty(h, h, device=cuda)
            _i8_probe('wide_dw_i8_probe', (P, LL, I, P, I, I, P, I, I, P, P, P),
                      stash.data_ptr(), 2 * L * h, a_x, dz.data_ptr(), n, h, gmax.data_ptr(),
                      group, ranged, part.data_ptr(), count.data_ptr(), out.data_ptr())
            outs.append(out)
        assert torch.equal(outs[0], want), group
        assert torch.equal(outs[1], outs[2]), group
        assert _rel(want, outs[1]) <= 1e-5, group
        assert int(count.abs().sum()) == 0, group


@pytest.mark.gpu
@pytest.mark.parametrize('h', [528, 640, 1024])
def test_wide_i8_chain_maxima_on_the_card(cuda, h):
    """The 'i8pair' chain step's row maxima (a word a (N tile, point),
    ChainEpi) and wide_dz_group_max_kernel over them, at 3,001 points and
    groups 1, 8, 40, 768 and 133,144: the row words those of
    dz_row_maxima and the groups' maxima the bits of i8pair_group_maxima,
    both of the dz the chain wrote."""
    n, L, layer = 3001, 3, 1
    gen = torch.Generator(device=cuda).manual_seed(h + 1)
    a = torch.randn(n, h, generator=gen, device=cuda).to(torch.bfloat16)
    w = (torch.randn(h, h, generator=gen, device=cuda) / h ** 0.5).to(torch.bfloat16)
    stash = torch.randint(-127, 128, (n, 2 * L * h), generator=gen, device=cuda,
                          dtype=torch.int8)
    dz = torch.empty(n, h, dtype=torch.bfloat16, device=cuda)
    db_part = torch.empty(2 * -(-n // 128), h, device=cuda)
    rowmax = torch.empty(-(-h // 128), n, dtype=torch.int32, device=cuda)
    tn = wide_mlp.tile_n(h, 128)
    for group in I8_GROUPS:
        gmax = torch.empty(-(-n // group), dtype=torch.int32, device=cuda)
        _i8_probe('wide_i8_chain_probe', (P, P, I, P, LL, LL, I, I, P, P, P, I, P),
                  a.data_ptr(), w.data_ptr(), h, stash.data_ptr(), 2 * L * h,
                  2 * layer * h + h, n, h, dz.data_ptr(), db_part.data_ptr(),
                  rowmax.data_ptr(), group, gmax.data_ptr())
        assert bool(torch.isfinite(dz.float()).all()) and float(dz.float().abs().max()) > 0
        assert torch.equal(rowmax[:-(-h // tn)], wide_mlp.dz_row_maxima(dz, tn)), group
        want = fused_mlp.i8pair_group_maxima(dz.float(), group).view(torch.int32)
        assert torch.equal(gmax, want), group


@pytest.mark.gpu
@pytest.mark.parametrize('layers,width,group', [(8, 1024, 768), (2, 640, 768), (2, 528, 40)])
def test_wide_i8pair_backward_by_kernel_name_on_the_card(cuda, layers, width, group):
    """The whole wide K6b backward (dpts included) at 8x1024 and 2x640 at the
    default group and at 528 (tiles past the width) at 40, 3,001 points:
    against the plain version fed the kernel's own stash, the same bits
    twice, and one wide_dw_i8_wgmma_kernel and one wide_dz_group_max_kernel
    a hidden layer by the library's own count."""
    cfg, p, pts, dy = _field(cuda, layers, width, 2, 3001, seed=width + group)
    assert fused_mlp.kernel_route(cfg) == 'wide'
    _, hs, cs = fused_mlp.fused_mlp_stash_forward(cfg, p, pts, 'i8pair')
    before = fused_mlp.kernel_launches('wide_mlp_bwd')
    got = wide_mlp.wide_stash_backward(cfg, p, pts, dy, hs, cs, 'i8pair', True, group)
    torch.cuda.synchronize()
    after = fused_mlp.kernel_launches('wide_mlp_bwd')
    delta = {k: after[k] - before[k] for k in after}
    assert delta['wide_bwd (K6b)'] == 1
    assert delta['wide_dw_i8_wgmma_kernel (K6b)'] == layers - 1
    assert delta['wide_dz_group_max_kernel (K6b)'] == layers - 1
    again = wide_mlp.wide_stash_backward(cfg, p, pts, dy, hs, cs, 'i8pair', True, group)
    ref = fused_mlp.fused_mlp_stash_bwd_reference(cfg, p, pts, dy, hs, cs, 'i8pair', True, group)
    for k in ref:
        assert torch.equal(got[k], again[k]), k
        assert _rel(ref[k], got[k]) < (5e-2 if k == 'dpts' else 6e-2), k


def test_probe_wide_gemm_measures_only_the_card():
    """scripts/probe_wide_gemm.py times the GEMM's variants on the card
    (csrc/wide_gemm_probe.cu): without one it stops with a message, it
    does not time the CPU."""
    if torch.cuda.is_available():
        pytest.skip('a card is here: the script would measure it')
    from sunerf_tpu_torch.scripts import probe_wide_gemm
    with pytest.raises(SystemExit, match='no CUDA device'):
        probe_wide_gemm.main(['--n', '256'])
