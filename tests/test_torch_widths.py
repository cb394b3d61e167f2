"""Fields of any width up to 512 on the fused kernels (ops/fused_mlp.py
kernel_width, pad_field, _kernel_field), on the CPU.

The card's kernels are built for d_filter in KERNEL_WIDTHS; fused_mlp_forward
runs a CUDA field of another width at the next of them, zero-padded. These
tests hold the padding to the field it pads, through the kernels' plain
versions (which run any width on the CPU), at d_filter 16, 32 and 96: the
forward of every route, the stashing forward and backward of each format
('int8' K1 + K2, 'lsb' K6a, 'i8pair' K6b) with the point cotangent (K3), and
the recompute backward (K4), the gradients sliced back by autograd through
the pads. Measured: the padded and unpadded plain versions agree to the bit
on the CPU; held to 1e-6 of max, since padding changes the shapes of the
float32 products (a different blocking of the same sums could move an ulp).
The padded plain version is also held against JAX's own fused kernel at the
real width (interpret mode, which takes any d_filter), under the forward's
1e-2 of max. The kernels themselves at these widths are card tests
(tests/test_torch_backward_layouts.py, tests/test_torch_dpts_any_d.py) and
chip_smoke.py's [widths] phase.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sunerf_tpu.models.fields import NeRFConfig as JaxNeRFConfig
from sunerf_tpu.ops.pallas.fused_mlp import fused_nerf_raw
from sunerf_tpu_torch.models.fields import emission_config, init_nerf, nerf_apply
from sunerf_tpu_torch.ops import fused_mlp

torch.set_num_threads(1)

SHAPES = ((2, 16), (2, 32), (4, 96))
TOL = 1e-6
N = 96


def _field(layers, width, seed=0, **kw):
    cfg = emission_config(n_layers=layers, d_filter=width, n_freqs=4, **kw)
    gen = torch.Generator().manual_seed(seed)
    params = init_nerf(gen, cfg, 'cpu')
    pts = torch.rand(N, 4, generator=gen) * 2.6 - 1.3
    dy = torch.randn(N, cfg.d_output, generator=gen)
    return cfg, params, pts, dy


def _close(ref: torch.Tensor, got: torch.Tensor, what: str):
    assert ref.shape == got.shape, what
    scale = float(ref.abs().max())
    assert float((ref - got).abs().max()) <= TOL * max(scale, 1e-30), what


def test_kernel_width():
    assert [fused_mlp.kernel_width(w) for w in (1, 16, 32, 64, 65, 96, 128, 300, 384, 512)] \
        == [64, 64, 64, 64, 128, 128, 128, 384, 384, 512]
    for width in (513, 1024):
        with pytest.raises(ValueError, match='up to 512'):
            fused_mlp.kernel_width(width)
        cfg, params, _, _ = _field(1, width)
        with pytest.raises(ValueError, match='up to 512'):
            fused_mlp.pad_field(cfg, params)


@pytest.mark.parametrize('layers,width', SHAPES)
def test_padded_field_forward_equals_unpadded(layers, width):
    cfg, params, pts, _ = _field(layers, width)
    pcfg, pparams = fused_mlp.pad_field(cfg, params)
    assert pcfg.d_filter == fused_mlp.kernel_width(width) in fused_mlp.KERNEL_WIDTHS
    assert pparams['w_h'].shape == (layers - 1, pcfg.d_filter, pcfg.d_filter)
    for fn in (fused_mlp.fused_mlp_reference,
               lambda c, p, x: fused_mlp.fused_mlp_stash_reference(c, p, x)[0],
               lambda c, p, x: nerf_apply(c, p, x).raw):
        _close(fn(cfg, params, pts), fn(pcfg, pparams, pts), f'{width} forward')
    # the stash's real columns are the unpadded stash's; the padded ones are
    # sin 0 (and int8 cos 127)
    _, hs, cs = fused_mlp.fused_mlp_stash_reference(cfg, params, pts)
    _, phs, pcs = fused_mlp.fused_mlp_stash_reference(pcfg, pparams, pts)
    phs = phs.view(N, layers, pcfg.d_filter)
    torch.testing.assert_close(phs[..., :width], hs.view(N, layers, width), rtol=0, atol=0)
    assert not phs[..., width:].float().any()
    assert bool((pcs.view(N, layers, pcfg.d_filter)[..., width:] == 127).all())


def _grads(cfg, params, pts, dy, pad: bool, **knobs):
    """Parameter (and point) gradients of sum(dy * field) through the
    fused entry's autograd path on the plain versions, padding first when
    `pad` (as fused_mlp_forward does on the card)."""
    leaves = {k: v.detach().clone().requires_grad_() for k, v in params.items()}
    x = pts.clone().requires_grad_()
    c, p = fused_mlp.pad_field(cfg, leaves) if pad else (cfg, leaves)
    out = fused_mlp.fused_mlp_forward(c, p, x, **knobs)
    (out * dy).sum().backward()
    return out.detach(), dict({k: v.grad for k, v in leaves.items()}, dpts=x.grad)


@pytest.mark.parametrize('layers,width', SHAPES)
@pytest.mark.parametrize('knobs', [dict(), dict(stash_format='lsb'),
                                   dict(stash_format='i8pair', stash_bwd_tile=8),
                                   dict(stash=False)],
                         ids=['int8', 'lsb', 'i8pair', 'recompute'])
def test_padded_field_gradients_equal_unpadded(layers, width, knobs):
    cfg, params, pts, dy = _field(layers, width, seed=width)
    out, ref = _grads(cfg, params, pts, dy, False, **knobs)
    pout, got = _grads(cfg, params, pts, dy, True, **knobs)
    _close(out, pout, f'{width} out')
    for k in ref:
        assert got[k].shape == ref[k].shape, k
        _close(ref[k], got[k], f'{width} {k}')


def test_kernel_field_pads_for_the_card_and_reuses_a_render_pad():
    cfg, params, _, _ = _field(2, 32)
    with torch.no_grad():
        c1, p1 = fused_mlp._kernel_field(cfg, params)
        c2, p2 = fused_mlp._kernel_field(cfg, params)
    assert c1.d_filter == 64 and p1 is p2           # one pad for a render's chunks
    with torch.no_grad():
        params['w_h'].add_(1.0)                      # an in-place update: a new pad
        _, p3 = fused_mlp._kernel_field(cfg, params)
    assert p3 is not p1 and torch.equal(p3['w_h'][:, :32, :32], params['w_h'])
    leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
    _, g1 = fused_mlp._kernel_field(cfg, leaves)
    _, g2 = fused_mlp._kernel_field(cfg, leaves)
    assert g1 is not g2 and g1['w_in'].requires_grad    # through autograd each call
    wide, wp, _, _ = _field(2, 128)
    assert fused_mlp._kernel_field(wide, wp) == (wide, wp)
    narrow = emission_config(n_layers=2, d_filter=600)
    with pytest.raises(ValueError, match='up to 512'):
        fused_mlp._kernel_field(narrow, {})


@pytest.mark.parametrize('layers,width', [(2, 32)])
def test_padded_plain_version_matches_jax_kernel_at_the_real_width(layers, width):
    """JAX's fused kernel (interpret mode, tiles of 8) runs d_filter 32
    itself; the port's plain version of the padded field agrees with it
    under the forward's tolerance."""
    cfg, params, pts, _ = _field(layers, width, seed=3)
    pcfg, pparams = fused_mlp.pad_field(cfg, params)
    jc = JaxNeRFConfig(n_layers=layers, d_filter=width, n_freqs=4)
    ref = np.asarray(fused_nerf_raw(jc, jax.tree.map(lambda t: jnp.asarray(t.numpy()), params),
                                    jnp.asarray(pts.numpy()), tile=8, interpret=True))
    got = fused_mlp.fused_mlp_reference(pcfg, pparams, pts).numpy()
    assert np.max(np.abs(ref - got)) <= 1e-2 * np.max(np.abs(ref)) + 1e-4
