"""The fused kernels (csrc/fused_mlp_fwd_wgmma.cu K0, fused_mlp_stash_fwd.cu K1,
fused_mlp_stash_bwd.cu K2 with the point cotangent K3, their dense
feature-grid branch K5, the 'lsb' and 'i8pair' stashes K6a and K6b, K6b's
int8 dW_h and the 16-bit gates through the weight ring on their own, and
fused_mlp_recompute_bwd.cu K4), and the grid-encode probes P1
(grid_tap_encode.cu) and P2 (grid_hat_encode.cu), against their plain
PyTorch versions on the card.
CUDA kernels have no CPU mode, so these tests need a card and skip without
one; run them on the card with

    python -m pytest --noconftest -m gpu tests/test_torch_kernel.py -q

Tolerances, as fractions of max|plain|:
  * 2e-2 for the forward outputs: both round matmul operands to bf16, and
    single rounding flips compound over the layers;
  * 1e-5 for K1's output against K0's: the same kernel (K1 is K0's wgmma
    kernel with the stashes in its epilogue), so the same bits;
  * 3e-2 for the parameter gradients (tests/test_fused_mlp.py holds the
    JAX kernel's to 3%): bf16 dz flips compound down the chain;
  * the grid tables' gradients (K5) within 3e-2 of max too, and
    bit-identical run to run (fixed-point sums, no float atomics);
  * each layer of the sin stash within 1 bf16 ulp for 99.9% of entries and
    of the int8 cos stash within 1 everywhere, against the plain version fed
    the kernel's own upstream activations (fused_mlp_stash_layerwise): f32
    sums in another order, and a polynomial evaluated with and without fused
    multiply-adds, move a value across a rounding boundary at most by one;
    the same for the 'lsb' stash (its sign bit may differ only where
    |cos| < 1e-3) and the 'i8pair' pairs;
  * 5e-2 for the point cotangent (tests/test_fused_mlp.py:85); the
    parameter gradients bit-identical with and without it;
  * 1e-4 for K6b's int8 dW_h against the plain _dw_i8 fed the kernel's own
    dz: each group's int32 sum is exact, and only the f32 sums over groups
    and ranges are taken in another order;
  * P1 within 1e-5 abs (the same float32 operations in the same order), P2
    within 1e-2 of max + 1e-4 with RMS within 1e-4 of max (the same bf16
    weights, float32 sums in another order).
"""
import dataclasses

import pytest
import torch

from sunerf_tpu_torch.models.fields import emission_config, init_nerf
from sunerf_tpu_torch.ops import fused_mlp, grid_probes

KEYS = ('w_in', 'b_in', 'w_h', 'b_h', 'w_out', 'b_out')


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the kernel has no CPU mode')
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device('cuda')


def _setup(device, n_layers, d_filter, n, requires_grad=False, grid_sizes=()):
    cfg = emission_config(n_layers=n_layers, d_filter=d_filter, n_freqs_time=3,
                          grid_sizes=grid_sizes, grid_bound=1.3)
    gen = torch.Generator(device=device).manual_seed(n)
    params = init_nerf(gen, cfg, device)
    for k in fused_mlp.grid_keys(cfg):
        params[k] = params[k] * 1e4     # tables that carry signal: U(-1, 1)
    if requires_grad:
        params = {k: v.requires_grad_() for k, v in params.items()}
    pts = torch.rand(n, 4, generator=gen, device=device) * 2.6 - 1.3
    dy = torch.randn(n, 2, generator=gen, device=device)
    return cfg, params, pts, dy


def bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """|a - b| in units of the bf16 ulp of the larger magnitude."""
    af, bf = a.float(), b.float()
    m = torch.maximum(af.abs(), bf.abs()).clamp_min(2.0 ** -126)
    return (af - bf).abs() / torch.exp2(torch.floor(torch.log2(m)) - 7)


def _rel(ref: torch.Tensor, got: torch.Tensor) -> float:
    return float((got - ref).abs().max()) / max(float(ref.abs().max()), 1e-30)


@pytest.mark.gpu
@pytest.mark.parametrize('n_layers,d_filter,n', [
    (3, 64, 1), (4, 128, 81920), (6, 384, 1000), (8, 512, 4097),
])
def test_kernel_matches_plain_version(cuda, n_layers, d_filter, n):
    cfg, params, pts, _ = _setup(cuda, n_layers, d_filter, n)
    before = fused_mlp.LAUNCHES
    with torch.inference_mode():
        out = fused_mlp.fused_mlp_forward(cfg, params, pts)
        ref = fused_mlp.fused_mlp_reference(cfg, params, pts)
    torch.cuda.synchronize()
    assert fused_mlp.LAUNCHES == before + 1
    assert out.shape == (n, 2) and bool(torch.isfinite(out).all())
    assert float((out - ref).abs().max()) <= 2e-2 * float(ref.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize('n_layers,d_filter,n', [
    (3, 64, 1), (4, 128, 20480), (8, 512, 4097), (6, 384, 777),
])
def test_stash_kernels_match_plain_versions(cuda, n_layers, d_filter, n):
    """K1 and K2 against their plain versions, K2 fed K1's own stash."""
    cfg, params, pts, dy = _setup(cuda, n_layers, d_filter, n)
    fwd0, bwd0 = fused_mlp.STASH_FWD_LAUNCHES, fused_mlp.STASH_BWD_LAUNCHES
    with torch.no_grad():
        out, hs, cs = fused_mlp.fused_mlp_stash_forward(cfg, params, pts)
        ref_out, ref_hs, ref_cs = fused_mlp.fused_mlp_stash_reference(cfg, params, pts)
        grads = fused_mlp.fused_mlp_stash_backward(cfg, params, pts, dy, hs, cs)
        ref = fused_mlp.fused_mlp_stash_bwd_reference(cfg, params, pts, dy, hs, cs)
        again = fused_mlp.fused_mlp_stash_backward(cfg, params, pts, dy, hs, cs)
    torch.cuda.synchronize()
    assert fused_mlp.STASH_FWD_LAUNCHES == fwd0 + 1
    assert fused_mlp.STASH_BWD_LAUNCHES == bwd0 + 2
    lh = n_layers * d_filter
    assert hs.shape == (n, lh) and hs.dtype == torch.bfloat16
    assert cs.shape == (n, lh) and cs.dtype == torch.int8
    assert bool(torch.isfinite(out).all())
    assert _rel(ref_out, out) <= 2e-2
    # each layer against the plain version fed the kernel's own upstream
    # activations; free-running, bf16 flips compound over the layers
    lw_hs, lw_cs = fused_mlp.fused_mlp_stash_layerwise(cfg, params, pts, hs)
    assert float((bf16_ulps(lw_hs, hs) <= 1).float().mean()) >= 0.999
    assert int((cs.int() - lw_cs.int()).abs().max()) <= 1
    print(f'{n_layers}x{d_filter}: free-running sin stash within 1 ulp '
          f'{float((bf16_ulps(ref_hs, hs) <= 1).float().mean()):.5f}, '
          f'int8 cos max |diff| {int((cs.int() - ref_cs.int()).abs().max())}')
    for k in KEYS:
        assert grads[k].shape == params[k].shape, k
        assert bool(torch.isfinite(grads[k]).all()), k
        assert _rel(ref[k], grads[k]) <= 3e-2, (k, _rel(ref[k], grads[k]))
        # fixed-order reductions: a second run gives the same bits
        assert torch.equal(grads[k], again[k]), k


@pytest.mark.gpu
def test_dz_scratch_matches_plain_chain(cuda):
    """The chain kernel's dz scratch (tile by tile in its core-matrix order,
    unpacked by unpack_dz_scratch) against the plain backward's dz of every
    layer, for each gate (int8, lsb, i8pair) at ragged N: within 3e-2 of
    max per layer (bf16 flips compound down the chain, as in the
    gradients); the rows of the last tile past N are zeros."""
    for fmt, n_layers, d_filter, n in (('int8', 4, 128, 20481), ('int8', 8, 512, 4097),
                                       ('lsb', 6, 384, 777), ('i8pair', 3, 64, 1000)):
        cfg, params, pts, dy = _setup(cuda, n_layers, d_filter, n)
        with torch.no_grad():
            _, hs, cs = fused_mlp.fused_mlp_stash_forward(cfg, params, pts, fmt)
            _, dz = fused_mlp._stash_backward_launch(cfg, params, pts, dy, hs, cs, fmt, False,
                                                     fused_mlp.STASH_BWD_TILE)
            dzs = []
            fused_mlp.fused_mlp_stash_bwd_reference(cfg, params, pts, dy, hs, cs, fmt, dzs=dzs)
        torch.cuda.synchronize()
        tiles = -(-n // 64) * 64
        got = fused_mlp.unpack_dz_scratch(dz, tiles, n_layers, d_filter).float()
        assert not got[n:].any(), fmt
        for j, ref in enumerate(dzs):
            layer = got[:n, j * d_filter:(j + 1) * d_filter]
            assert _rel(ref, layer) <= 3e-2, (fmt, n_layers, d_filter, j, _rel(ref, layer))


@pytest.mark.gpu
def test_function_grads_match_plain_path(cuda):
    """nerf_apply_fused under autograd on CUDA tensors goes through K1 + K2
    (not K0), with grads as the plain versions give them."""
    cfg, params, pts, dy = _setup(cuda, 8, 512, 3000, requires_grad=True)
    k0, fwd0, bwd0 = (fused_mlp.LAUNCHES, fused_mlp.STASH_FWD_LAUNCHES,
                      fused_mlp.STASH_BWD_LAUNCHES)
    out = fused_mlp.fused_mlp_forward(cfg, params, pts, compute_dpts=False)
    out.backward(dy)
    torch.cuda.synchronize()
    assert (fused_mlp.LAUNCHES, fused_mlp.STASH_FWD_LAUNCHES,
            fused_mlp.STASH_BWD_LAUNCHES) == (k0, fwd0 + 1, bwd0 + 1)
    with torch.no_grad():
        ref_out, hs, cs = fused_mlp.fused_mlp_stash_reference(cfg, params, pts)
        ref = fused_mlp.fused_mlp_stash_bwd_reference(cfg, params, pts, dy, hs, cs)
    assert _rel(ref_out, out.detach()) <= 2e-2
    for k in KEYS:
        assert _rel(ref[k], params[k].grad) <= 3e-2, k
    # points that need a gradient: K2 with K3, the point cotangent
    x = pts.clone().requires_grad_()
    dpts0 = fused_mlp.DPTS_LAUNCHES
    fused_mlp.fused_mlp_forward(cfg, params, x).backward(dy)
    torch.cuda.synchronize()
    assert fused_mlp.DPTS_LAUNCHES == dpts0 + 1
    with torch.no_grad():
        ref = fused_mlp.fused_mlp_stash_bwd_reference(cfg, params, pts, dy, hs, cs,
                                                      compute_dpts=True)
    assert _rel(ref['dpts'], x.grad) <= 5e-2


@pytest.mark.gpu
@pytest.mark.parametrize('n_layers,d_filter,grid_sizes,n', [
    (3, 64, (8,), 1), (4, 128, (16,), 20480), (8, 512, (16, 32), 4097),
])
def test_grid_kernels_match_plain_versions(cuda, n_layers, d_filter, grid_sizes, n):
    """K0, K1 and K2 with the grid branch against their plain versions, K2
    fed K1's stash; K1's output within 1e-5 of K0's (the same bf16
    operands, sums in another order); the table gradients bit-identical
    over two runs; a table updated in place is read by the next launch
    (tables are not cached)."""
    cfg, params, pts, dy = _setup(cuda, n_layers, d_filter, n, grid_sizes=grid_sizes)
    pts[0, :3] = 1.3                    # a point exactly on the bound
    keys = fused_mlp.param_keys(cfg)
    grid0 = fused_mlp.GRID_LAUNCHES
    with torch.no_grad():
        k0 = fused_mlp.fused_mlp_forward(cfg, params, pts)
        out, hs, cs = fused_mlp.fused_mlp_stash_forward(cfg, params, pts)
        ref_out, _, _ = fused_mlp.fused_mlp_stash_reference(cfg, params, pts)
        grads = fused_mlp.fused_mlp_stash_backward(cfg, params, pts, dy, hs, cs)
        ref = fused_mlp.fused_mlp_stash_bwd_reference(cfg, params, pts, dy, hs, cs)
        again = fused_mlp.fused_mlp_stash_backward(cfg, params, pts, dy, hs, cs)
    torch.cuda.synchronize()
    assert fused_mlp.GRID_LAUNCHES == grid0 + 4
    assert _rel(ref_out, k0) <= 2e-2 and _rel(ref_out, out) <= 2e-2
    assert _rel(k0, out) <= 1e-5, _rel(k0, out)
    lw_hs, lw_cs = fused_mlp.fused_mlp_stash_layerwise(cfg, params, pts, hs)
    assert float((bf16_ulps(lw_hs, hs) <= 1).float().mean()) >= 0.999
    assert int((cs.int() - lw_cs.int()).abs().max()) <= 1
    for k in keys:
        assert grads[k].shape == params[k].shape, k
        assert bool(torch.isfinite(grads[k]).all()), k
        assert _rel(ref[k], grads[k]) <= 3e-2, (k, _rel(ref[k], grads[k]))
        assert torch.equal(grads[k], again[k]), k
    with torch.no_grad():
        params['grid_0'].add_(0.5)
        moved = fused_mlp.fused_mlp_forward(cfg, params, pts)
        assert _rel(fused_mlp.fused_mlp_reference(cfg, params, pts), moved) <= 2e-2
    assert not torch.equal(moved, k0)


@pytest.mark.gpu
def test_kernel_rejects_what_it_does_not_take(cuda):
    cfg = emission_config(n_layers=2, d_filter=96)
    params = init_nerf(torch.Generator(device=cuda).manual_seed(0), cfg, cuda)
    pts = torch.zeros(8, 4, device=cuda)
    with pytest.raises(ValueError, match='d_filter'):
        fused_mlp.fused_mlp_forward(cfg, params, pts)
    cfg = emission_config(n_layers=2, d_filter=64)
    params = init_nerf(torch.Generator(device=cuda).manual_seed(0), cfg, cuda)
    with pytest.raises(ValueError, match='contiguous'):
        fused_mlp.fused_mlp_forward(cfg, params, torch.zeros(4, 8, device=cuda)[:, :4])
    with pytest.raises(ValueError, match='float32'):
        fused_mlp.fused_mlp_forward(cfg, params, pts.double())
    out, hs, cs = fused_mlp.fused_mlp_stash_forward(cfg, params, pts)
    with pytest.raises(ValueError, match='hs'):
        fused_mlp.fused_mlp_stash_backward(cfg, params, pts, torch.zeros(8, 2, device=cuda),
                                           hs.float(), cs)


@pytest.mark.gpu
@pytest.mark.parametrize('n_layers,d_filter,n', [(4, 128, 20480), (8, 512, 4097)])
def test_point_cotangent_matches_plain_version(cuda, n_layers, d_filter, n):
    """K2 with K3: dpts against the plain version, and the parameter
    gradients the same bits as K2's without it."""
    cfg, params, pts, dy = _setup(cuda, n_layers, d_filter, n)
    with torch.no_grad():
        _, hs, cs = fused_mlp.fused_mlp_stash_forward(cfg, params, pts)
        d0 = fused_mlp.DPTS_LAUNCHES
        with_dpts = fused_mlp.fused_mlp_stash_backward(cfg, params, pts, dy, hs, cs,
                                                       compute_dpts=True)
        without = fused_mlp.fused_mlp_stash_backward(cfg, params, pts, dy, hs, cs)
        ref = fused_mlp.fused_mlp_stash_bwd_reference(cfg, params, pts, dy, hs, cs,
                                                      compute_dpts=True)
    torch.cuda.synchronize()
    assert fused_mlp.DPTS_LAUNCHES == d0 + 1 and 'dpts' not in without
    assert with_dpts['dpts'].shape == (n, 4) and bool(torch.isfinite(with_dpts['dpts']).all())
    assert _rel(ref['dpts'], with_dpts['dpts']) <= 5e-2
    for k in KEYS:
        assert torch.equal(with_dpts[k], without[k]), k


@pytest.mark.gpu
@pytest.mark.parametrize('fmt', ['lsb', 'i8pair'])
@pytest.mark.parametrize('n_layers,d_filter,n', [(4, 128, 20480), (8, 512, 4097)])
def test_stash_formats_match_plain_versions(cuda, fmt, n_layers, d_filter, n):
    """K6a / K6b: the output K1's bits, the stash layer by layer, every
    gradient (dpts included) against the plain version at the same group."""
    cfg, params, pts, dy = _setup(cuda, n_layers, d_filter, n)
    counter = 'LSB_LAUNCHES' if fmt == 'lsb' else 'I8PAIR_LAUNCHES'
    before = getattr(fused_mlp, counter)
    with torch.no_grad():
        k1_out, k1_hs, _ = fused_mlp.fused_mlp_stash_forward(cfg, params, pts)
        out, hs, cs = fused_mlp.fused_mlp_stash_forward(cfg, params, pts, fmt)
        lw, _ = fused_mlp.fused_mlp_stash_layerwise(cfg, params, pts, k1_hs, fmt)
        grads = fused_mlp.fused_mlp_stash_backward(cfg, params, pts, dy, hs, cs, fmt, True)
        again = fused_mlp.fused_mlp_stash_backward(cfg, params, pts, dy, hs, cs, fmt, True)
        ref = fused_mlp.fused_mlp_stash_bwd_reference(cfg, params, pts, dy, hs, cs, fmt, True)
    torch.cuda.synchronize()
    assert getattr(fused_mlp, counter) == before + 3 and cs is None
    torch.testing.assert_close(out, k1_out, rtol=0, atol=0)
    if fmt == 'lsb':
        masked = (hs.view(torch.int16) & -2).view(torch.bfloat16)
        lw_masked = (lw.view(torch.int16) & -2).view(torch.bfloat16)
        assert float((bf16_ulps(lw_masked, masked) <= 2).float().mean()) >= 0.999
        assert float(((hs.view(torch.int16) ^ lw.view(torch.int16)) & 1).float().mean()) < 1e-4
    else:
        assert int((hs.int() - lw.int()).abs().max()) <= 1
    tol = {'lsb': 3e-2, 'i8pair': 6e-2}[fmt]
    for k in KEYS:
        assert bool(torch.isfinite(grads[k]).all()), k
        assert _rel(ref[k], grads[k]) <= tol, (k, _rel(ref[k], grads[k]))
        assert torch.equal(grads[k], again[k]), k
    assert _rel(ref['dpts'], grads['dpts']) <= 5e-2


@pytest.mark.gpu
@pytest.mark.parametrize('n_layers,d_filter,n,chunk', [(4, 128, 20480, 4096),
                                                       (8, 512, 4097, 32768)])
def test_recompute_backward_matches_plain_version(cuda, monkeypatch, n_layers, d_filter, n,
                                                 chunk):
    """K4, over one chunk and over several: gradients and dpts against the
    plain version, the same bits run to run; under autograd the output is
    K0's."""
    monkeypatch.setattr(fused_mlp, 'RECOMPUTE_CHUNK', chunk)
    cfg, params, pts, dy = _setup(cuda, n_layers, d_filter, n, requires_grad=True)
    before = fused_mlp.RECOMPUTE_BWD_LAUNCHES
    with torch.no_grad():
        grads = fused_mlp.fused_mlp_recompute_backward(cfg, params, pts, dy)
        again = fused_mlp.fused_mlp_recompute_backward(cfg, params, pts, dy)
        ref = fused_mlp.fused_mlp_recompute_bwd_reference(cfg, params, pts, dy)
    torch.cuda.synchronize()
    assert fused_mlp.RECOMPUTE_BWD_LAUNCHES == before + 2
    for k in KEYS:
        assert _rel(ref[k], grads[k]) <= 3e-2, (k, _rel(ref[k], grads[k]))
        assert torch.equal(grads[k], again[k]), k
    assert _rel(ref['dpts'], grads['dpts']) <= 5e-2
    x = pts.clone().requires_grad_()
    out = fused_mlp.fused_mlp_forward(cfg, params, x, stash=False)
    with torch.no_grad():
        torch.testing.assert_close(out, fused_mlp.fused_mlp_forward(cfg, params, pts),
                                   rtol=0, atol=0)
    out.backward(dy)
    assert _rel(ref['dpts'], x.grad) <= 5e-2


@pytest.mark.gpu
def test_grid_probe_kernels_match_plain_versions(cuda):
    gen = torch.Generator(device=cuda).manual_seed(0)
    for G, Fe in ((8, 8), (6, 16), (32, 8)):
        table4 = torch.randn((G, G, G, Fe), generator=gen, device=cuda)
        pts = torch.rand((1000, 3), generator=gen, device=cuda) * 3.2 - 1.6
        packed = grid_probes.pack_table(table4)
        before = grid_probes.TAP_LAUNCHES
        got = grid_probes.tap_encode(packed, pts, G, 1.3)
        assert grid_probes.TAP_LAUNCHES == before + 1
        ref = grid_probes.tap_encode_reference(packed, pts, G, 1.3)
        assert (got - ref).abs().max() <= 1e-5
    for G in (8, 13, 32):
        table = torch.randn((G * G, G * 8), generator=gen, device=cuda).bfloat16()
        pts = torch.rand((1000, 3), generator=gen, device=cuda) * 3.2 - 1.6
        e1, e2 = (torch.from_numpy(e).to(cuda, torch.bfloat16)
                  for e in grid_probes.expansion_matrices(G))
        for variant in grid_probes.HAT_VARIANTS:
            ops = (e1, e2) if variant == 'expand' else ()
            got = grid_probes.hat_encode(table, pts, G, 1.3, variant, *ops)
            ref = grid_probes.hat_encode_reference(table, pts, G, 1.3, variant, *ops)
            m = ref.abs().max()
            assert (got - ref).abs().max() <= 1e-2 * m + 1e-4
            assert (got - ref).pow(2).mean().sqrt() <= 1e-4 * m


@pytest.mark.gpu
@pytest.mark.parametrize('n_layers,d_filter,n,grid_sizes,d_input,d_output', [
    (3, 64, 1, (), 4, 2), (4, 128, 81920, (), 4, 2), (3, 256, 4097, (), 4, 2),
    (6, 384, 1000, (), 4, 2), (8, 512, 4097, (), 4, 2), (4, 128, 3000, (16,), 4, 2),
    (8, 512, 2000, (16, 32), 4, 2), (3, 128, 5000, (), 6, 8), (3, 512, 777, (), 3, 1),
])
def test_k0_kernel_matches_plain_version(cuda, n_layers, d_filter, n, grid_sizes, d_input,
                                         d_output):
    """K0 at every width, with and without grid levels, and at other input
    and output counts (up to 8 outputs: its head's width), against the plain
    version; one launch counted a call."""
    cfg, params, pts, _ = _setup(cuda, n_layers, d_filter, n, grid_sizes=grid_sizes)
    if (d_input, d_output) != (4, 2):
        cfg = dataclasses.replace(cfg, d_input=d_input, d_output=d_output)
        gen = torch.Generator(device=cuda).manual_seed(n)
        params = init_nerf(gen, cfg, cuda)
        pts = torch.rand(n, d_input, generator=gen, device=cuda) * 2.6 - 1.3
    with torch.inference_mode():
        ref = fused_mlp.fused_mlp_reference(cfg, params, pts)
        before = fused_mlp.LAUNCHES
        out = fused_mlp.fused_mlp_forward(cfg, params, pts)
        torch.cuda.synchronize()
    assert fused_mlp.LAUNCHES == before + 1
    assert out.shape == (n, d_output) and bool(torch.isfinite(out).all())
    assert _rel(ref, out) <= 2e-2, _rel(ref, out)


@pytest.mark.gpu
def test_i8pair_backward_takes_any_group(cuda):
    """K6b's backward at scale groups that are not multiples of 64 (each
    64-point dW_h chunk taken a group segment at a time) and at the default
    768:
    every gradient within the i8pair tolerance of the plain version at the
    same group, the same bits run to run."""
    cfg, params, pts, dy = _setup(cuda, 4, 128, 4097)
    with torch.no_grad():
        _, hs, _ = fused_mlp.fused_mlp_stash_forward(cfg, params, pts, 'i8pair')
        for group in (8, 16, 24, 768):
            grads = fused_mlp.fused_mlp_stash_backward(cfg, params, pts, dy, hs, None,
                                                       'i8pair', False, group)
            again = fused_mlp.fused_mlp_stash_backward(cfg, params, pts, dy, hs, None,
                                                       'i8pair', False, group)
            ref = fused_mlp.fused_mlp_stash_bwd_reference(cfg, params, pts, dy, hs, None,
                                                          'i8pair', False, group)
            torch.cuda.synchronize()
            for k in KEYS:
                assert _rel(ref[k], grads[k]) <= 6e-2, (group, k, _rel(ref[k], grads[k]))
                assert torch.equal(grads[k], again[k]), (group, k)


@pytest.mark.gpu
@pytest.mark.parametrize('G,n', [(16, 3000), (32, 5000), (48, 2000), (64, 1000), (5, 777)])
def test_hat_encode_kernel_at_every_build(cuda, G, n):
    """P2 at the G whose k-steps lie in one y (16, 32, 64: the aligned
    build), at others (48, 5: the general build), every variant against its
    plain version."""
    gen = torch.Generator(device=cuda).manual_seed(G)
    table = torch.randn((G * G, G * 8), generator=gen, device=cuda).bfloat16()
    pts = torch.rand((n, 3), generator=gen, device=cuda) * 3.2 - 1.6
    e1, e2 = (torch.from_numpy(e).to(cuda, torch.bfloat16)
              for e in grid_probes.expansion_matrices(G))
    for variant in grid_probes.HAT_VARIANTS:
        ops = (e1, e2) if variant == 'expand' else ()
        got = grid_probes.hat_encode(table, pts, G, 1.3, variant, *ops)
        ref = grid_probes.hat_encode_reference(table, pts, G, 1.3, variant, *ops)
        m = ref.abs().max()
        assert (got - ref).abs().max() <= 1e-2 * m + 1e-4, (variant, G)
        assert (got - ref).pow(2).mean().sqrt() <= 1e-4 * m, (variant, G)


@pytest.mark.gpu
@pytest.mark.parametrize('n_layers,d_filter,n,group', [
    (3, 64, 1000, 8), (4, 128, 4097, 16), (8, 512, 4097, 24), (8, 512, 20481, 768),
    (6, 384, 3001, 768), (4, 128, 4097, 768),
])
def test_i8pair_dw_h_matches_int8_plain_version(cuda, n_layers, d_filter, n, group):
    """K6b's dW_h on the int8 tensor cores (dw_i8_wgmma_kernel, with the
    chain kernel's row maxima and dz_group_max_kernel) against the plain
    _dw_i8 fed the kernel's own dz (its scratch, unpacked): within 1e-4 of
    max per layer, the f32 sums over groups and ranges taken in another
    order (each group's int32 sum is exact); the same bits over two runs."""
    cfg, params, pts, dy = _setup(cuda, n_layers, d_filter, n)
    L, H = n_layers, d_filter
    with torch.no_grad():
        _, hs, _ = fused_mlp.fused_mlp_stash_forward(cfg, params, pts, 'i8pair')
        grads, dz = fused_mlp._stash_backward_launch(cfg, params, pts, dy, hs, None, 'i8pair',
                                                     False, group)
        again, _ = fused_mlp._stash_backward_launch(cfg, params, pts, dy, hs, None, 'i8pair',
                                                    False, group)
        dzs = fused_mlp.unpack_dz_scratch(dz, n, L, H).float()
        for j in range(1, L):
            ref = fused_mlp._dw_i8(hs[:, 2 * (j - 1) * H:2 * (j - 1) * H + H],
                                   dzs[:, j * H:(j + 1) * H], group)
            got = grads['w_h'][j - 1]
            assert bool(torch.isfinite(got).all()) and float(ref.abs().max()) > 0
            assert _rel(ref, got) <= 1e-4, (j, _rel(ref, got))
    torch.cuda.synchronize()
    for k in KEYS:
        assert torch.equal(grads[k], again[k]), k


@pytest.mark.gpu
@pytest.mark.parametrize('gate,n_layers,d_filter,n', [
    ('lsb', 3, 64, 1000), ('lsb', 8, 512, 4097), ('bf16', 3, 64, 1000), ('bf16', 8, 512, 4097),
])
def test_16bit_gates_through_the_ring_match_plain_versions(cuda, monkeypatch, gate, n_layers,
                                                           d_filter, n):
    """The 16-bit gates through the chain kernel's weight ring (two stages of
    [32 x 64] boxes a layer, at H = 64 their own box path): 'lsb' (K6a, the
    packed sines decoded in place under the last products) with its dz
    scratch per layer and every gradient against the plain backward, and
    K4's bf16 cos (over two recompute chunks) against its plain version:
    within 3e-2 of max (dpts 5e-2), the same bits over two runs."""
    cfg, params, pts, dy = _setup(cuda, n_layers, d_filter, n)
    with torch.no_grad():
        if gate == 'lsb':
            _, hs, _ = fused_mlp.fused_mlp_stash_forward(cfg, params, pts, 'lsb')
            grads, dz = fused_mlp._stash_backward_launch(cfg, params, pts, dy, hs, None, 'lsb',
                                                         True, fused_mlp.STASH_BWD_TILE)
            again, _ = fused_mlp._stash_backward_launch(cfg, params, pts, dy, hs, None, 'lsb',
                                                        True, fused_mlp.STASH_BWD_TILE)
            dzs = []
            ref = fused_mlp.fused_mlp_stash_bwd_reference(cfg, params, pts, dy, hs, None, 'lsb',
                                                          True, dzs=dzs)
            got = fused_mlp.unpack_dz_scratch(dz, n, n_layers, d_filter).float()
            for j, want in enumerate(dzs):
                layer = got[:, j * d_filter:(j + 1) * d_filter]
                assert _rel(want, layer) <= 3e-2, (j, _rel(want, layer))
        else:
            monkeypatch.setattr(fused_mlp, 'RECOMPUTE_CHUNK', 64 * (-(-n // 128)))
            grads = fused_mlp.fused_mlp_recompute_backward(cfg, params, pts, dy)
            again = fused_mlp.fused_mlp_recompute_backward(cfg, params, pts, dy)
            ref = fused_mlp.fused_mlp_recompute_bwd_reference(cfg, params, pts, dy)
    torch.cuda.synchronize()
    for k in KEYS:
        assert bool(torch.isfinite(grads[k]).all()), k
        assert _rel(ref[k], grads[k]) <= 3e-2, (k, _rel(ref[k], grads[k]))
        assert torch.equal(grads[k], again[k]), k
    assert _rel(ref['dpts'], grads['dpts']) <= 5e-2


@pytest.mark.gpu
def test_lsb_gate_decode_on_the_card_matches_plain_on_every_pattern(cuda):
    """The chain kernel's 'lsb' gate decode (lsb_cos_table: 1 and 0 outside
    the 512 values of the table the block builds with rounded square roots)
    on all 65,536 16-bit patterns against its plain version (held to JAX's
    _unpack_sin_cos on the CPU): the same bits, NaN where NaN."""
    bits = torch.arange(-32768, 32768, dtype=torch.int32).to(torch.int16)
    got = fused_mlp.lsb_cos_decode(bits.to(cuda)).cpu()
    want = fused_mlp.lsb_cos_decode(bits)
    nan = torch.isnan(want.view(torch.bfloat16).float())
    assert torch.equal(torch.isnan(got.view(torch.bfloat16).float()), nan)
    assert torch.equal(got[~nan], want[~nan])
