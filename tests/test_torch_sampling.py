"""The port's samplers (sunerf_tpu_torch.core.sampling) and geometry against
the JAX package on the CPU: deterministic paths (key=None) and the random
paths fed the JAX side's own uniforms. Tolerance 1e-5 absolute on z values
of order 1-6 (a few float32 ulps)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sunerf_tpu.core import geometry as jax_geometry
from sunerf_tpu.core.sampling import hierarchical_sample as jax_hierarchical_sample
from sunerf_tpu.core.sampling import sample_pdf as jax_sample_pdf
from sunerf_tpu.core.sampling import stratified_sample as jax_stratified_sample
from sunerf_tpu.core.scaling import normalize_datetime as jax_normalize_datetime
from sunerf_tpu_torch.core import geometry
from sunerf_tpu_torch.core.sampling import (_invert_cdf, _perturb_bins,
                                            hierarchical_sample, sample_pdf,
                                            stratified_sample)
from sunerf_tpu_torch.core.scaling import normalize_datetime, unnormalize_datetime

torch.set_num_threads(1)
ATOL = 1e-5


def _rays(kind: str, n: int = 48):
    """Ray bundles: 'mixed' = an observer at 4.5 Rs with rays both hitting
    and missing the Sun; 'center' = rays through the Sun's centre; 'inside'
    = an observer inside the 1.3 Rs sampling shell."""
    rng = np.random.default_rng(0)
    if kind == 'mixed':
        o = np.tile(np.array([[4.0, 1.5, -1.2]], np.float32), (n, 1))
        d = -o / np.linalg.norm(o, axis=-1, keepdims=True) \
            + rng.normal(0, 0.25, (n, 3)).astype(np.float32)
    elif kind == 'center':
        o = rng.normal(0, 1, (n, 3)).astype(np.float32)
        o *= (3.0 / np.linalg.norm(o, axis=-1, keepdims=True)).astype(np.float32)
        d = -o
    else:
        o = np.tile(np.array([[1.1, 0.2, 0.0]], np.float32), (n, 1))
        d = rng.normal(0, 1, (n, 3)).astype(np.float32)
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    return o, d


def _both(fn_jax, fn_torch, *arrays, **kw):
    return (fn_jax(*map(jnp.asarray, arrays), **kw),
            fn_torch(*map(torch.from_numpy, arrays), **kw))


@pytest.mark.parametrize('kind', ['mixed', 'center', 'inside'])
def test_stratified_matches_jax(kind):
    o, d = _rays(kind)
    j, t = _both(jax_stratified_sample, stratified_sample, o, d,
                 n_samples=20, distance=1.3, solar_radius=1.0)
    for k in ('z_vals', 'points'):
        assert torch.isfinite(t[k]).all()
        np.testing.assert_allclose(t[k].numpy(), np.asarray(j[k]), rtol=0, atol=ATOL)
    if kind == 'center':
        # the far plane is the solar surface: 2 Rs from an observer at 3 Rs
        np.testing.assert_allclose(t['z_vals'][:, -1].numpy(), 2.0, atol=1e-5)
    if kind == 'inside':
        # near plane behind the observer (|o| - 1.3 < 0)
        assert float(t['z_vals'][:, 0].max()) < 0


def test_stratified_jitter_matches_jax_on_its_uniforms():
    o, d = _rays('mixed')
    key = jax.random.key(3)
    j = jax_stratified_sample(jnp.asarray(o), jnp.asarray(d), n_samples=16, key=key)
    base = stratified_sample(torch.from_numpy(o), torch.from_numpy(d), n_samples=16)
    u = np.asarray(jax.random.uniform(key, (o.shape[0], 16)))
    z = _perturb_bins(base['z_vals'], torch.from_numpy(u))
    np.testing.assert_allclose(z.numpy(), np.asarray(j['z_vals']), rtol=0, atol=ATOL)
    # the generator path is seeded and stays within the bins
    g1 = stratified_sample(torch.from_numpy(o), torch.from_numpy(d), n_samples=16,
                           generator=torch.Generator().manual_seed(1))['z_vals']
    g2 = stratified_sample(torch.from_numpy(o), torch.from_numpy(d), n_samples=16,
                           generator=torch.Generator().manual_seed(1))['z_vals']
    torch.testing.assert_close(g1, g2, rtol=0, atol=0)
    assert bool((g1[:, 1:] >= g1[:, :-1] - 1e-6).all())


def _pdf_inputs(r=40, m=19):
    rng = np.random.default_rng(5)
    bins = np.sort(rng.uniform(2, 6, (r, m + 1)).astype(np.float32), axis=-1)
    weights = rng.uniform(0, 1, (r, m)).astype(np.float32)
    weights[::3, 4:-2] = 0.0  # mass in a few bins only
    weights[1] = 0.0          # a ray with no mass: a uniform pdf
    return bins, weights


def test_sample_pdf_linspace_matches_jax():
    bins, weights = _pdf_inputs()
    j, t = _both(jax_sample_pdf, sample_pdf, bins, weights, n_samples=24)
    assert torch.isfinite(t).all()
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=ATOL)


def test_sample_pdf_guard_at_u_one_with_an_empty_last_bin():
    """With zero weight in the last bin, u = 1 meets cdf[-1] = 1 +- 1 ulp and
    the 1e-5 denominator guard sends the sample to the last bin centre or to
    the one before it, by the last bit of the cumsum — a discontinuity of
    the JAX package's inverse CDF that the port keeps. Either branch is the
    reference's answer."""
    bins, weights = _pdf_inputs()
    weights[:, -3:] = 0.0
    j, t = _both(jax_sample_pdf, sample_pdf, bins, weights, n_samples=24)
    np.testing.assert_allclose(t[:, :-1].numpy(), np.asarray(j)[:, :-1], rtol=0, atol=ATOL)
    last = t[:, -1].numpy()
    near = np.minimum(np.abs(last - bins[:, -1]), np.abs(last - bins[:, -2]))
    assert near.max() < 1e-3


def test_sample_pdf_stratified_uniforms_match_jax():
    bins, weights = _pdf_inputs()
    key = jax.random.key(11)
    j = jax_sample_pdf(jnp.asarray(bins), jnp.asarray(weights), 24, key=key)
    jitter = np.asarray(jax.random.uniform(key, (bins.shape[0], 24)))
    u = (np.arange(24, dtype=np.float32) + jitter) / 24
    t = _invert_cdf(torch.from_numpy(bins), torch.from_numpy(weights),
                    torch.from_numpy(u.astype(np.float32)))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=ATOL)
    g = sample_pdf(torch.from_numpy(bins), torch.from_numpy(weights), 24,
                   generator=torch.Generator().manual_seed(0))
    assert bool((g >= torch.from_numpy(bins[:, :1]) - 1e-5).all())
    assert bool((g <= torch.from_numpy(bins[:, -1:]) + 1e-5).all())


@pytest.mark.parametrize('kind', ['mixed', 'center', 'inside'])
def test_hierarchical_matches_jax(kind):
    o, d = _rays(kind)
    strat = jax_stratified_sample(jnp.asarray(o), jnp.asarray(d), n_samples=20)
    w = np.random.default_rng(2).uniform(0, 1, (o.shape[0], 20)).astype(np.float32)
    j = jax_hierarchical_sample(jnp.asarray(o), jnp.asarray(d), strat['z_vals'],
                                jnp.asarray(w), n_samples=32)
    t = hierarchical_sample(torch.from_numpy(o), torch.from_numpy(d),
                            torch.from_numpy(np.asarray(strat['z_vals'])),
                            torch.from_numpy(w), n_samples=32)
    for k in ('z_vals', 'new_z_samples', 'points'):
        np.testing.assert_allclose(t[k].numpy(), np.asarray(j[k]), rtol=0, atol=ATOL)
    assert bool((t['z_vals'][:, 1:] >= t['z_vals'][:, :-1]).all())


def test_geometry_copy_matches_jax_package():
    for lat, lon, dist, res in ((0.3, 1.1, 215.0, 8), (-0.7, 4.0, 3.0, 5)):
        a = jax_geometry.observer_rays(lat, lon, dist, res)
        b = geometry.observer_rays(lat, lon, dist, res)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(jax_geometry.pose_spherical(0.2, 0.1, 5.0, (1, 2, 3)),
                                  geometry.pose_spherical(0.2, 0.1, 5.0, (1, 2, 3)))
    np.testing.assert_array_equal(jax_geometry.spherical_to_cartesian(2.0, 0.3, 1.0),
                                  geometry.spherical_to_cartesian(2.0, 0.3, 1.0))


def test_datetime_normalization_matches_jax():
    from datetime import datetime
    ref = datetime(2012, 8, 23)
    when = datetime(2012, 8, 24, 6, 30)
    assert normalize_datetime(when, ref_time=ref) == jax_normalize_datetime(when, ref_time=ref)
    assert unnormalize_datetime(normalize_datetime(when, 3600.0, ref), 3600.0, ref) == when
