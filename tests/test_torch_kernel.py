"""The fused forward kernel (csrc/fused_mlp_fwd.cu) against its plain PyTorch
version on the card. CUDA kernels have no CPU mode, so these tests need a
card and skip without one; run them on the card with

    python -m pytest -m gpu tests/test_torch_kernel.py -q

Tolerance 2e-2 of max|plain|: both round matmul operands to bf16, and single
rounding flips compound over the layers.
"""
import pytest
import torch

from sunerf_tpu_torch.models.fields import emission_config, init_nerf
from sunerf_tpu_torch.ops import fused_mlp


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the kernel has no CPU mode')
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device('cuda')


@pytest.mark.gpu
@pytest.mark.parametrize('n_layers,d_filter,n', [
    (3, 64, 1), (4, 128, 81920), (6, 384, 1000), (8, 512, 4097),
])
def test_kernel_matches_plain_version(cuda, n_layers, d_filter, n):
    cfg = emission_config(n_layers=n_layers, d_filter=d_filter, n_freqs_time=3)
    gen = torch.Generator(device=cuda).manual_seed(n)
    params = init_nerf(gen, cfg, cuda)
    pts = torch.rand(n, 4, generator=gen, device=cuda) * 2.6 - 1.3
    before = fused_mlp.LAUNCHES
    with torch.inference_mode():
        out = fused_mlp.fused_mlp_forward(cfg, params, pts)
        ref = fused_mlp.fused_mlp_reference(cfg, params, pts)
    torch.cuda.synchronize()
    assert fused_mlp.LAUNCHES == before + 1
    assert out.shape == (n, 2) and bool(torch.isfinite(out).all())
    assert float((out - ref).abs().max()) <= 2e-2 * float(ref.abs().max())


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
