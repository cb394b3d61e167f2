"""The wide route's GEMM (csrc/wide_mlp.cuh wide_wgmma_kernel) and 'i8pair'
dW_h (dw_i8_kernel): their host plans, mirrored in ops/wide_mlp.py, on the
CPU (a product's N tile, a dW product's ranges of the points, 'i8pair''s
ranges of whole scale groups, the arrival counters' length, every TMA
operand's row stride and base offset), and the kernels against their plain
versions on the card. The card tests skip without one; run them there with

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
    atomics).
"""
import dataclasses

import pytest
import torch

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
    group), each point once and in order; at a group that is a multiple of
    32 the ranges of the former plan (32-point slices rounded up to groups)."""
    splits, k_split = wide_mlp.i8_plan(h, points, group, SMS)
    assert k_split % group == 0 and 1 <= splits <= wide_mlp.WIDE_MAX_SPLITS
    bounds = [(s * k_split, min(points, (s + 1) * k_split)) for s in range(splits)]
    assert all(lo < hi for lo, hi in bounds) and bounds[-1][1] == points
    assert all(b[1] == c[0] for b, c in zip(bounds, bounds[1:]))
    for lo, _ in bounds:
        assert lo % group == 0          # a range starts on a group's first point
    if group % 32 == 0:
        tiles = (-(-h // 128)) ** 2
        want = max(1, min(-(-2 * SMS // tiles), 16, -(-points // 1024)))
        old = -(-(-(-points // want)) // 32) * 32
        assert k_split == -(-old // group) * group


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


def test_probe_wide_gemm_measures_only_the_card():
    """scripts/probe_wide_gemm.py times the GEMM's variants on the card
    (csrc/wide_gemm_probe.cu): without one it stops with a message, it
    does not time the CPU."""
    if torch.cuda.is_available():
        pytest.skip('a card is here: the script would measure it')
    from sunerf_tpu_torch.scripts import probe_wide_gemm
    with pytest.raises(SystemExit, match='no CUDA device'):
        probe_wide_gemm.main(['--n', '256'])
