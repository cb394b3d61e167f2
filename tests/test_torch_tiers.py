"""The port's adaptive per-ray tiers (sunerf_tpu_torch/rendering/renderer.py
_tiered_fine, ModelLoader(tier=...), TrainerConfig.tier_warmup_steps)
against the JAX package on the CPU.

JAX's three tier tests (tests/test_renderer.py:178-260) are held against
JAX's outputs: the same 2x32 field and rays go through both renderers
(perturb off, so no generator draws a number; a key / generator still
selects the training pass), and the port's own untiered render stands in
for the full budget. Tolerances:
  * membership: both packages rank with a stable argsort of the detached
    coarse brightness; they may put a ray in different tiers only where its
    score lies within 1e-5 relative of the cut (the coarse images differ in
    the last bits);
  * image, height, absorption and the per-ray regularization within 1e-5 of
    max, ray by ray, where the tiers agree; gradients of
    mean(image) + mean(coarse image) within 1e-5 of max;
  * the loader's tiered chunks within 1e-5 of max (a full chunk through
    render_observer_image; a padded last chunk through the products, which
    pad directions with ones as JAX's do). JAX pads render_observer_image's
    last chunk with zero rays, whose NaN coarse scores reach every ray of the
    chunk through its one-hot permutation matmuls (NaN x 0): its padded
    tiered chunks are NaN (ROADMAP Queue 3); the port moves rays by index and
    stays finite, so that case is held to JAX's own assertions instead;
  * tier_warmup_steps on the 2x32 SimpleStar closed loop (8 steps, the
    first 4 at the full budget): logged losses within 1e-3 relative.
"""
import dataclasses
import functools
import json
import os
import signal
from datetime import datetime

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sunerf_tpu.core.geometry import observer_rays
from sunerf_tpu.data.loaders import build_single_channel_data as jax_build
from sunerf_tpu.evaluation.image_render import render_observers
from sunerf_tpu.evaluation.loader import ModelLoader as JaxModelLoader
from sunerf_tpu.evaluation.products import synchronic_map as jax_synchronic_map
from sunerf_tpu.evaluation.products import uncertainty_map as jax_uncertainty_map
from sunerf_tpu.models.fields import emission_config as jax_emission_config
from sunerf_tpu.models.fields import init_nerf as jax_init_nerf
from sunerf_tpu.models.fields import nerf_apply as jax_nerf_apply
from sunerf_tpu.rendering.emission import EmissionHead as JaxEmissionHead
from sunerf_tpu.rendering.renderer import Renderer as JaxRenderer
from sunerf_tpu.systems import make_emission_system as jax_make_emission_system
from sunerf_tpu.train.loop import Trainer as JaxTrainer
from sunerf_tpu.train.loop import TrainerConfig as JaxTrainerConfig
from sunerf_tpu.train.objective import LossConfig as JaxLossConfig
from sunerf_tpu.train.optim import OptimConfig as JaxOptimConfig
from sunerf_tpu_torch.baseline.reprojection import carrington_to_world
from sunerf_tpu_torch.data.loaders import build_single_channel_data
from sunerf_tpu_torch.evaluation.loader import ModelLoader
from sunerf_tpu_torch.evaluation.products import synchronic_map, uncertainty_map
from sunerf_tpu_torch.models.fields import emission_config, nerf_apply, params_from_numpy
from sunerf_tpu_torch.rendering.emission import EmissionHead
from sunerf_tpu_torch.rendering.renderer import Renderer
from sunerf_tpu_torch.systems import make_emission_system, make_simple_star_renderer
from sunerf_tpu_torch.train.loop import Trainer, TrainerConfig
from sunerf_tpu_torch.train.objective import LossConfig
from sunerf_tpu_torch.train.optim import OptimConfig

torch.set_num_threads(1)

TOL = 1e-5
TIE = 1e-5
LOSS_RTOL = 1e-3
SMALL = dict(n_layers=2, d_filter=32)
OUTPUTS = ('image', 'height_map', 'absorption_map', 'regularization')


def _rays(n, distance=4.0):
    """tests/test_renderer.py's _rays, as numpy."""
    o, d = observer_rays(lat=0.1, lon=0.4, distance=distance, resolution=int(np.sqrt(n)) + 1)
    return (o.reshape(-1, 3)[:n].astype(np.float32), d.reshape(-1, 3)[:n].astype(np.float32),
            np.zeros((n, 1), np.float32))


def _pair(**kw):
    """JAX's and the port's renderer over one 2x32 field (16 + 16 samples,
    perturb off) and its JAX-initialised params, as numpy."""
    kw = dict(n_stratified=16, n_hierarchical=16, perturb=False, **kw)
    jr = JaxRenderer(field_apply=functools.partial(jax_nerf_apply, jax_emission_config(**SMALL)),
                     head=JaxEmissionHead(), **kw)
    tr = Renderer(field_apply=functools.partial(nerf_apply, emission_config(**SMALL)),
                  head=EmissionHead(), **kw)
    k1, k2 = jax.random.split(jax.random.key(0))
    cfg = jax_emission_config(**SMALL)
    params = jax.tree.map(np.asarray, {'coarse': jax_init_nerf(k1, cfg),
                                       'fine': jax_init_nerf(k2, cfg)})
    return jr, tr, params


def _of_max(ref, got) -> float:
    ref, got = np.asarray(ref, np.float64), np.asarray(got, np.float64)
    return float(np.max(np.abs(ref - got)) / max(np.max(np.abs(ref)), 1e-30))


def _dim_sets(score_jax, score_port, n_lo):
    """The dim tier of each package and the rays they disagree on; those must
    sit within TIE relative of the cut."""
    dim_j = set(np.argsort(score_jax, kind='stable')[:n_lo].tolist())
    dim_p = set(np.argsort(score_port, kind='stable')[:n_lo].tolist())
    cut = np.sort(score_jax)[max(n_lo - 1, 0)]
    for i in dim_j ^ dim_p:
        assert abs(score_jax[i] - cut) <= TIE * max(abs(cut), 1e-30), (i, score_jax[i], cut)
    return dim_j, dim_p


@pytest.mark.parametrize('n,fraction,samples', [(32, 0.5, 8), (37, 0.3, 8)],
                         ids=['half_of_32', 'ragged_0.3_of_37'])
def test_tiered_fine_matches_jax(n, fraction, samples):
    """The tiered training pass against JAX's, ray by ray where the tiers
    agree; then JAX's own checks on the port: bright rays exactly the
    untiered full-budget render, dim rays close to it, eval untiered."""
    jr, tr, params = _pair(tier_fraction=fraction, tier_samples=samples)
    o, d, t = _rays(n)
    jo = jax.jit(lambda p: jr(p, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t),
                              key=jax.random.key(5)))(params)
    tp = params_from_numpy(params, 'cpu')
    args = (torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(t))
    to = tr(tp, *args, generator=torch.Generator().manual_seed(5))
    n_lo = int(round(n * fraction))
    dim_j, dim_p = _dim_sets(np.asarray(jo['coarse_image']).max(-1),
                             to['coarse_image'].numpy().max(-1), n_lo)
    same = np.array([(i in dim_j) == (i in dim_p) for i in range(n)])
    for k in OUTPUTS:
        got = to[k].numpy()
        assert got.shape == np.asarray(jo[k]).shape, k
        assert np.isfinite(got).all(), k
        assert _of_max(np.asarray(jo[k])[same], got[same]) <= TOL, k
    assert to['z_vals_hierarchical'].shape == (n - n_lo, 16)
    # JAX's test_tiered_fine_bright_rays_match_full_budget, on the port
    base = dataclasses.replace(tr, tier_fraction=0.0)
    full = base(tp, *args, generator=torch.Generator().manual_seed(5))
    order = np.argsort(full['coarse_image'].numpy().max(-1), kind='stable')
    hi, lo = order[n_lo:], order[:n_lo]
    np.testing.assert_array_equal(to['image'].numpy()[hi], full['image'].numpy()[hi])
    np.testing.assert_allclose(to['image'].numpy()[lo], full['image'].numpy()[lo],
                               rtol=0.35, atol=1e-3)
    e_tier = tr(tp, *args)['image']
    np.testing.assert_array_equal(e_tier.numpy(), base(tp, *args)['image'].numpy())


def test_tiered_gradients_match_jax():
    """JAX's test_tiered_fine_gradients_flow_to_both_tiers held against
    JAX's gradients: both fields, every leaf."""
    jr, tr, params = _pair(tier_fraction=0.5, tier_samples=8)
    o, d, t = _rays(32)

    def jloss(p):
        out = jr(p, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t), key=jax.random.key(5))
        return jnp.mean(out['image']) + jnp.mean(out['coarse_image']), out['coarse_image']

    jgrads, jcoarse = jax.jit(jax.grad(jloss, has_aux=True))(params)
    tp = {f: {k: v.requires_grad_(True) for k, v in leaves.items()}
          for f, leaves in params_from_numpy(params, 'cpu').items()}
    out = tr(tp, torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(t),
             generator=torch.Generator().manual_seed(5))
    (out['image'].mean() + out['coarse_image'].mean()).backward()
    dim_j, dim_p = _dim_sets(np.asarray(jcoarse).max(-1),
                             out['coarse_image'].detach().numpy().max(-1), 16)
    assert dim_j == dim_p   # else the gradients are not comparable
    for f in ('coarse', 'fine'):
        assert any(float(v.grad.abs().max()) > 0 for v in tp[f].values()), f
        for k, v in tp[f].items():
            assert _of_max(np.asarray(jgrads[f][k]), v.grad.numpy()) <= TOL, (f, k)


@pytest.fixture(scope='module')
def nerf():
    """A 2x32 emission field (3 posenc bands), 16 + 16 samples, perturb off:
    (JAX renderer, port renderer, numpy params). Its coarse scores agree
    across the packages to ~1e-6 relative, so the tier membership is
    comparable at the 1e-5 tie tolerance; SimpleStar's differ by up to
    7e-5 at 5 Rs (the float32 ray-sphere clip; ROADMAP Queue 3)."""
    cfg = dict(n_layers=2, d_filter=32, n_freqs=3)
    kw = dict(n_stratified=16, n_hierarchical=16, perturb=False)
    jr, jinit = jax_make_emission_system(model_config=jax_emission_config(**cfg), use_fused=False,
                                         **kw)
    tr, _ = make_emission_system(model_config=emission_config(**cfg), device='cpu', **kw)
    return jr, tr, jax.tree.map(np.asarray, jinit(jax.random.key(3)))


@pytest.fixture(scope='module')
def star():
    """tests/test_renderer.py's SimpleStar with zero absorption in both
    passes: (port renderer, params on the CPU), for JAX's loader checks."""
    tr, init = make_simple_star_renderer(perturb=False, n_stratified=16, n_hierarchical=16,
                                         device='cpu')
    z = dict(init()['fine'], log_abs=torch.zeros(7))
    return tr, {'coarse': z, 'fine': z}


def _agree(jr, tr, params, o, d, bs, fraction, pad_direction=0.0):
    """The rays of [n, 3] (o, d) at time 0 that both packages put in the same
    tier when a loader renders them in chunks of bs, padded as JAX pads them;
    the others must sit at a near-tie of their chunk's cut (_dim_sets)."""
    n = o.shape[0]
    pad = (-n) % bs
    o = np.concatenate([o, np.zeros((pad, 3), np.float32)]).astype(np.float32)
    d = np.concatenate([d, np.full((pad, 3), pad_direction, np.float32)]).astype(np.float32)
    t = np.zeros((n + pad, 1), np.float32)
    score_j = np.asarray(jax.jit(lambda p: jr(p, o, d, t, key=None)['coarse_image'])(
        params)).max(-1)
    with torch.no_grad():
        score_p = tr(params_from_numpy(params, 'cpu'), *map(torch.from_numpy, (o, d, t)))[
            'coarse_image'].numpy().max(-1)
    agree = np.ones(n + pad, bool)
    for c in range(0, n + pad, bs):
        dim_j, dim_p = _dim_sets(score_j[c:c + bs], score_p[c:c + bs], int(round(bs * fraction)))
        for i in dim_j ^ dim_p:
            agree[c + i] = False
    return agree[:n]


def _jax_loader_checks(tiered: ModelLoader, full: ModelLoader, view: dict):
    """JAX's test_tiered_inference_via_loader: finite, bright pixels (above
    the untiered frame's 60th percentile) within 1e-5 relative of the
    untiered render, the frame's relative L1 below 0.05."""
    vt, vf = tiered.render_observer_image(**view), full.render_observer_image(**view)
    assert np.isfinite(vt.image).all() and np.isfinite(vt.height_map).all()
    bright = vf.image[..., 0] > np.percentile(vf.image[..., 0], 60)
    np.testing.assert_allclose(vt.image[..., 0][bright], vf.image[..., 0][bright], rtol=1e-5)
    assert np.abs(vt.image - vf.image).sum() / max(vf.image.sum(), 1e-9) < 0.05


def test_tiered_loader_full_chunks_match_jax(nerf, star):
    """ModelLoader(tier=...) at 16x16 in chunks of 128 (no padding) against
    JAX's where the tiers agree; then JAX's test_tiered_inference_via_loader
    on the port's SimpleStar."""
    jr, tr, params = nerf
    view = dict(lat=0.2, lon=1.0, time=0.0, distance=5.0, resolution=16)
    jt = JaxModelLoader(jr, params, batch_size=128, tier=(0.5, 8)).render_observer_image(**view)
    tier = ModelLoader(tr, params_from_numpy(params, 'cpu'), batch_size=128, tier=(0.5, 8),
                       device='cpu')
    assert tier.renderer.tier_eval and tier.renderer.tier_samples == 8
    pt = tier.render_observer_image(**view)
    o, d = observer_rays(0.2, 1.0, 5.0, 16)
    agree = _agree(jr, tr, params, o.reshape(-1, 3), d.reshape(-1, 3), 128, 0.5)
    assert agree.mean() > 0.9
    for k in ('image', 'height_map', 'absorption_map'):
        ref, got = getattr(jt, k).reshape(256, -1), getattr(pt, k).reshape(256, -1)
        assert np.isfinite(got).all(), k
        assert _of_max(ref[agree], got[agree]) <= TOL, k
    str_, sp = star
    _jax_loader_checks(ModelLoader(str_, sp, batch_size=256, tier=(0.5, 8), device='cpu'),
                       ModelLoader(str_, sp, batch_size=256, device='cpu'),
                       dict(view, wavelengths=[193.0]))


def test_tiered_loader_padded_last_chunk(nerf, star):
    """The last chunk padded to batch_size under tiers: through the products
    (directions padded with ones, as JAX's products pad) against JAX where
    the tiers agree; through render_observer_image (zero rays, as JAX's
    loader pads) finite where JAX's padded chunk is NaN, its full chunk
    against JAX's, and JAX's loader checks on the port's SimpleStar."""
    jr, tr, params = nerf
    jl = JaxModelLoader(jr, params, batch_size=96, tier=(0.5, 8))
    pl = ModelLoader(tr, params_from_numpy(params, 'cpu'), batch_size=96, tier=(0.5, 8),
                     device='cpu')
    # 8 x 16 = 128 radial rays: one full chunk and one of 32 rays + 64 pads
    sync_j = jax_synchronic_map(jl, 0.0, resolution_lat=8)
    sync_p = synchronic_map(pl, 0.0, resolution_lat=8)
    assert sync_p.shape == (8, 16, 1)
    lon = (np.arange(16) + 0.5) / 16 * 2 * np.pi
    lat = (np.arange(8) + 0.5) / 8 * np.pi - np.pi / 2
    lon_g, lat_g = np.meshgrid(lon, lat)
    surface = carrington_to_world(lat_g, lon_g).reshape(-1, 3)
    agree = _agree(jr, tr, params, surface * 2.5, -surface, 96, 0.5, pad_direction=1.0)
    assert agree[96:].mean() > 0.9
    assert _of_max(sync_j.reshape(128)[agree], sync_p.reshape(128)[agree]) <= TOL
    # 10 x 10 = 100 rays: chunks of 96 and 4 + 92 pads
    u_j = jax_uncertainty_map(jl, 0.2, 1.0, 0.0, 3.0, resolution=10)
    u_p = uncertainty_map(pl, 0.2, 1.0, 0.0, 3.0, resolution=10)
    o, d = observer_rays(0.2, 1.0, 3.0, 10)
    o, d = o.reshape(-1, 3), d.reshape(-1, 3)
    agree = _agree(jr, tr, params, o, d, 96, 0.5, pad_direction=1.0)
    fine = pl.render_rays(o, d, 0.0, keys=('fine_image',), pad_direction=1.0)['fine_image']
    assert np.max(np.abs(u_j - u_p).reshape(100)[agree]) <= TOL * np.max(np.abs(fine))
    view = dict(lat=0.2, lon=1.0, time=0.0, distance=5.0, resolution=10)
    jv = jl.render_observer_image(**view)
    pv = pl.render_observer_image(**view)
    assert np.isnan(jv.image.reshape(-1)[96:]).all()          # JAX: Queue 3
    assert np.isfinite(pv.image).all() and np.isfinite(pv.height_map).all()
    o, d = observer_rays(0.2, 1.0, 5.0, 10)
    agree = _agree(jr, tr, params, o.reshape(-1, 3)[:96], d.reshape(-1, 3)[:96], 96, 0.5)
    assert _of_max(jv.image.reshape(-1)[:96][agree], pv.image.reshape(-1)[:96][agree]) <= TOL
    str_, sp = star
    _jax_loader_checks(ModelLoader(str_, sp, batch_size=96, tier=(0.5, 8), device='cpu'),
                       ModelLoader(str_, sp, batch_size=96, device='cpu'),
                       dict(view, wavelengths=[193.0]))


# ------------------------------------------------- tier_warmup_steps, Trainer

LOOP_KW = dict(total_steps=8, val_every=1000, checkpoint_every=1000, log_every=1,
               save_val_images=False, tier_warmup_steps=4)
SAMPLES = dict(n_stratified=8, n_hierarchical=8, perturb=False, tier_fraction=0.5,
               tier_samples=4)


def _records(workdir) -> list:
    with open(os.path.join(workdir, 'metrics.jsonl')) as f:
        return [json.loads(line) for line in f]


def test_tier_warmup_closed_loop_matches_jax(tmp_path):
    """Both Trainers on the 2x32 SimpleStar closed loop (16x16 views, batch
    128) from one set of JAX-initialised params: 4 full-budget steps, then
    4 tiered; every logged loss within 1e-3 relative."""
    observers = [{'name': 'aia', 'lat': 5.0 * ((i % 3) - 1), 'lon': i * 45.0,
                  'distance': 215.0, 'time': datetime(2012, 8, 20 + i).isoformat()}
                 for i in range(4)]
    render_observers({'model': 'SimpleStar', 'render_path': str(tmp_path / 'renders'),
                      'render_format': ['fits'], 'resolution': 16, 'wavelengths': [193],
                      'batch_size': 256, 'pixel_intensity_factor': 1e9,
                      'observers': observers})
    pattern = str(tmp_path / 'renders' / 'aia' / '193' / '*.fits')
    loss_kw = dict(lambda_regularization=0.1, scaling_vmax=10.0)
    optim_kw = dict(lr_start=1e-3, lr_floor=1e-3)
    jr, jinit = jax_make_emission_system(model_config=jax_emission_config(**SMALL), **SAMPLES)
    params = jax.tree.map(np.asarray, jinit(jax.random.key(7)))
    jt = JaxTrainer(jr, params, jax_build(pattern, str(tmp_path / 'jw'), batch_size=128,
                                          n_workers=1),
                    loss_config=JaxLossConfig(**loss_kw), optim_config=JaxOptimConfig(**optim_kw),
                    trainer_config=JaxTrainerConfig(**LOOP_KW), workdir=str(tmp_path / 'jax'))
    handler = signal.getsignal(signal.SIGTERM)
    try:
        jt.fit()
    finally:
        signal.signal(signal.SIGTERM, handler)   # JAX's fit leaves its own
    tr, _ = make_emission_system(model_config=emission_config(**SMALL), device='cpu', **SAMPLES)
    pt = Trainer(tr, params, build_single_channel_data(pattern, str(tmp_path / 'pw'),
                                                       batch_size=128, n_workers=1),
                 loss_config=LossConfig(**loss_kw), optim_config=OptimConfig(**optim_kw),
                 trainer_config=TrainerConfig(**LOOP_KW), workdir=str(tmp_path / 'port'),
                 device='cpu')
    assert pt.warmup_step_fn is not None
    calls = []
    warm, tiered = pt.warmup_step_fn, pt.step_fn
    pt.warmup_step_fn = lambda *a: (calls.append('warm'), warm(*a))[1]
    pt.step_fn = lambda *a: (calls.append('tiered'), tiered(*a))[1]
    pt.fit()
    assert calls == ['warm'] * 4 + ['tiered'] * 4
    jl = {r['step']: r['loss'] for r in _records(str(tmp_path / 'jax')) if 'loss' in r}
    pl = {r['step']: r['loss'] for r in _records(str(tmp_path / 'port')) if 'loss' in r}
    assert sorted(pl) == sorted(jl) == list(range(1, 9))
    for s in jl:
        assert abs(pl[s] - jl[s]) <= LOSS_RTOL * abs(jl[s]), (s, pl[s], jl[s])
