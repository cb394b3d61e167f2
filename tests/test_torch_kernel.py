"""The fused kernels (csrc/fused_mlp_fwd.cu K0, fused_mlp_stash_fwd.cu K1,
fused_mlp_stash_bwd.cu K2, and their dense feature-grid branch K5) against
their plain PyTorch versions on the card.
CUDA kernels have no CPU mode, so these tests need a card and skip without
one; run them on the card with

    python -m pytest --noconftest -m gpu tests/test_torch_kernel.py -q

Tolerances, as fractions of max|plain|:
  * 2e-2 for the forward outputs: both round matmul operands to bf16, and
    single rounding flips compound over the layers;
  * 3e-2 for the parameter gradients (tests/test_fused_mlp.py holds the
    JAX kernel's to 3%): bf16 dz flips compound down the chain;
  * the grid tables' gradients (K5) within 3e-2 of max too, and
    bit-identical run to run (fixed-point sums, no float atomics);
  * each layer of the sin stash within 1 bf16 ulp for 99.9% of entries and
    of the int8 cos stash within 1 everywhere, against the plain version fed
    the kernel's own upstream activations (fused_mlp_stash_layerwise): f32
    sums in another order, and a polynomial evaluated with and without fused
    multiply-adds, move a value across a rounding boundary at most by one.
"""
import pytest
import torch

from sunerf_tpu_torch.models.fields import emission_config, init_nerf
from sunerf_tpu_torch.ops import fused_mlp

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
    with pytest.raises(NotImplementedError, match='K3'):
        fused_mlp.fused_mlp_forward(cfg, params, pts.clone().requires_grad_())


@pytest.mark.gpu
@pytest.mark.parametrize('n_layers,d_filter,grid_sizes,n', [
    (3, 64, (8,), 1), (4, 128, (16,), 20480), (8, 512, (16, 32), 4097),
])
def test_grid_kernels_match_plain_versions(cuda, n_layers, d_filter, grid_sizes, n):
    """K0, K1 and K2 with the grid branch against their plain versions, K2
    fed K1's stash; the table gradients bit-identical over two runs; a table
    updated in place is read by the next launch (tables are not cached)."""
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
    torch.testing.assert_close(out, k0, rtol=0, atol=0)
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
