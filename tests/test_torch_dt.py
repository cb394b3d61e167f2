"""The port's density-temperature slice against the JAX package, on the CPU:
the AIA response table and its lookup (sunerf_tpu_torch/ops/tresp.py), the
genx reader, the DT head, SimpleStar, the DT and SimpleStar systems, the
multi-thermal data builder, the synthesizer (evaluation/image_render.py),
the Trainer on the DT closed loop and the DT training CLI.

The same inputs, made from a seed with numpy, go to both packages; the JAX
side is jitted. Tolerances:
  * the response lookup: values within 1e-6 relative per element, its
    gradient with respect to log T within 1e-5 of max (the same two table
    columns, weighted in the same order; the products may be fused);
  * the head: image, weights and their gradients with respect to raw,
    log_abs and vol_c within 1e-5 of max (float32 sums in another order);
  * SimpleStar: raw within 1e-6 relative, the full-disk render at 5 Rs
    within 1e-5 of max (float32 renders at 1 AU are ill-conditioned,
    ROADMAP Queue 3);
  * the data builder and the genx reader: bit for bit;
  * the synthesizer's FITS frames at close observers (5 to 6 Rs): each
    within twice JAX's own distance (at least 1e-5) of max from a float64
    render of the same view, and within 1e-3 of max of JAX's frame. The float32
    frames are noisy at that level: JAX's sit up to 2.1e-5 (171 A) and
    7.6e-4 (304 A, whose response samples the steep transition region)
    of max from the float64 render (measured on the CPU);
  * the DT closed loop (2x32 DT field, 8 + 8 samples, perturb off, one set
    of JAX-initialised parameters, 30 steps): logged losses within 1e-3
    relative; each package's bundle rendered by both loaders at a close
    observer within 1e-4 of max.
"""
import inspect
import json
import os
import signal
import struct
from datetime import datetime, timedelta

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from sunerf_tpu.data.fits import read_fits as jax_read_fits
from sunerf_tpu.data.fits import write_fits as jax_write_fits
from sunerf_tpu.data.genx import read_genx as jax_read_genx
from sunerf_tpu.data.loaders import build_multi_thermal_data as jax_build
from sunerf_tpu.data.datasets import iterate_batches as jax_iterate_batches
from sunerf_tpu.data.wcs import observer_header as jax_observer_header
from sunerf_tpu.evaluation.image_render import render_observers as jax_render_observers
from sunerf_tpu.evaluation.loader import SuNeRFLoader as JaxLoader
from sunerf_tpu.models.fields import FieldOutput as JaxFieldOutput
from sunerf_tpu.models.fields import density_temperature_config as jax_dt_config
from sunerf_tpu.models.simple_star import SimpleStarConfig as JaxStarConfig
from sunerf_tpu.models.simple_star import init_simple_star as jax_init_star
from sunerf_tpu.models.simple_star import simple_star_apply as jax_star_apply
from sunerf_tpu.ops import tresp as jax_tresp
from sunerf_tpu.rendering import density_temperature as jax_dt
from sunerf_tpu.systems import from_spec as jax_from_spec
from sunerf_tpu.systems import make_density_temperature_system as jax_make_dt
from sunerf_tpu.systems import make_simple_star_renderer as jax_make_star
from sunerf_tpu.train.loop import Trainer as JaxTrainer
from sunerf_tpu.train.loop import TrainerConfig as JaxTrainerConfig
from sunerf_tpu.train.objective import LossConfig as JaxLossConfig
from sunerf_tpu.train.optim import OptimConfig as JaxOptimConfig
from sunerf_tpu_torch.core.geometry import observer_rays
from sunerf_tpu_torch.data import genx
from sunerf_tpu_torch.data.datasets import iterate_batches
from sunerf_tpu_torch.data.fits import read_fits
from sunerf_tpu_torch.data.loaders import build_multi_thermal_data
from sunerf_tpu_torch.evaluation import image_render
from sunerf_tpu_torch.evaluation.loader import SuNeRFLoader
from sunerf_tpu_torch.models.fields import FieldOutput, density_temperature_config
from sunerf_tpu_torch.models.fields import params_from_numpy
from sunerf_tpu_torch.models.simple_star import (SimpleStarConfig, init_simple_star,
                                                 simple_star_apply)
from sunerf_tpu_torch.ops import tresp
from sunerf_tpu_torch.rendering.density_temperature import (DensityTemperatureHead,
                                                            cumtrapz, trapz)
from sunerf_tpu_torch.systems import (from_spec, make_density_temperature_system,
                                      make_simple_star_renderer)
from sunerf_tpu_torch.train.loop import Trainer, TrainerConfig
from sunerf_tpu_torch.train.objective import LossConfig
from sunerf_tpu_torch.train.optim import OptimConfig

torch.set_num_threads(1)

VALUE_RTOL = 1e-6
HEAD_TOL = 1e-5
STAR_RENDER_TOL = 1e-5
SYNTH_TOL = 1e-3
LOSS_RTOL = 1e-3
BUNDLE_TOL = 1e-4
CLOSE = dict(lat=0.2, lon=0.7, time=0.0, distance=5.0)


def _rel(ref, got) -> float:
    ref, got = np.asarray(ref, np.float64), np.asarray(got, np.float64)
    scale = np.max(np.abs(ref))
    return float(np.max(np.abs(ref - got)) / scale) if scale else float(np.max(np.abs(got)))


def _port_response():
    return tresp.load_aia_response(device='cpu')


def _toy_pair():
    """Analytically simple response in both packages: R_c(logT) = (c+1) logT
    on [0, 10]."""
    logte = np.linspace(0.0, 10.0, 11, dtype=np.float32)
    table = np.stack([(c + 1.0) * logte for c in range(7)]).astype(np.float32)
    return (jax_tresp.TemperatureResponse(logte=jnp.asarray(logte), tresp=jnp.asarray(table)),
            tresp.TemperatureResponse(logte=torch.from_numpy(logte),
                                      tresp=torch.from_numpy(table)))


# ------------------------------------------------------------ the response

def test_asset_is_the_jax_packages_bytes():
    with open(jax_tresp.DEFAULT_NPZ, 'rb') as a, open(tresp.DEFAULT_NPZ, 'rb') as b:
        assert a.read() == b.read()
    assert 'sunerf_tpu_torch' in os.path.abspath(tresp.DEFAULT_NPZ)


def _log_t_probe() -> np.ndarray:
    rng = np.random.default_rng(0)
    nodes = (4.0 + 0.05 * np.arange(101)).astype(np.float32)
    return np.concatenate([rng.uniform(3.0, 10.0, 300), nodes,
                           [3.0, 3.99, 4.0, 9.0, 9.01, 10.0, 6.5]]).astype(np.float32)


def test_response_values_match_jax():
    j, p = jax_tresp.load_aia_response(), _port_response()
    np.testing.assert_array_equal(p.tresp.numpy(), np.asarray(j.tresp))
    np.testing.assert_array_equal(p.logte.numpy(), np.asarray(j.logte))
    log_t = _log_t_probe().reshape(-1, 8)
    # the table goes in as an argument: closed over, it would be a constant
    # of the jitted program, and XLA would fold the division by the grid
    # step into a product with its reciprocal (positions one float32 ulp
    # apart, 7.5e-6 relative on the table's steepest flanks)
    ref, ref_all = (np.asarray(jax.jit(
        lambda lt, tr, x, m=m: getattr(jax_tresp.TemperatureResponse(lt, tr), m)(x))(
            j.logte, j.tresp, jnp.asarray(log_t))) for m in ('evaluate_channels_last',
                                                              'evaluate_all'))
    got = p.evaluate_channels_last(torch.from_numpy(log_t)).numpy()
    assert got.shape == ref.shape == (*log_t.shape, 7)
    np.testing.assert_allclose(got, ref, rtol=VALUE_RTOL, atol=1e-37)
    np.testing.assert_allclose(p.evaluate_all(torch.from_numpy(log_t)).numpy(), ref_all,
                               rtol=VALUE_RTOL, atol=1e-37)
    # zero outside [4, 9], every channel positive at 1 MK
    outside = p.evaluate_all(torch.tensor([3.0, 3.99, 9.01, 10.0])).numpy()
    assert np.all(outside == 0.0)
    assert np.all(p.evaluate_all(torch.tensor([6.0])).numpy() > 0)


def test_response_gradient_matches_jax():
    j, p = jax_tresp.load_aia_response(), _port_response()
    rng = np.random.default_rng(1)
    log_t = rng.uniform(3.0, 10.0, (64, 5)).astype(np.float32)
    cot = rng.normal(size=(64, 5, 7)).astype(np.float32)
    ref = np.asarray(jax.jit(jax.grad(
        lambda x, lt, tr: jnp.sum(jax_tresp.TemperatureResponse(lt, tr).evaluate_channels_last(x)
                                  * cot)))(jnp.asarray(log_t), j.logte, j.tresp))
    x = torch.from_numpy(log_t).requires_grad_(True)
    (p.evaluate_channels_last(x) * torch.from_numpy(cot)).sum().backward()
    assert _rel(ref, x.grad.numpy()) < HEAD_TOL
    assert np.all(x.grad.numpy()[(log_t < 4.0) | (log_t > 9.0)] == 0.0)


def test_channel_selection_semantics():
    p = _port_response()
    wl = torch.tensor([[94.0, 0.0, 335.0], [171.0, 999.0, 131.0]])
    index = p.channel_index(wl).numpy()
    np.testing.assert_array_equal(index, [[0, -1, 6], [2, -1, 1]])
    # JAX's one-hot selects the same channel, and nothing where the index is -1
    ref = np.asarray(jax_tresp.load_aia_response().channel_onehot(jnp.asarray(wl.numpy())))
    np.testing.assert_array_equal(np.where(index >= 0, ref.argmax(-1), -1), index)
    assert np.all(ref[index < 0] == 0)


# ----------------------------------------------------------------- genx

def _genx_str(text: str) -> bytes:
    raw = text.encode('latin-1')
    if not raw:
        return struct.pack('>i', 0)
    return struct.pack('>ii', len(raw), len(raw)) + raw + b'\0' * (-len(raw) % 4)


_TYPECODES = {np.dtype('>i4'): 3, np.dtype('>f4'): 4, np.dtype('>f8'): 5}


def _genx_template(node) -> bytes:
    kind = node[0]
    if kind == 'str':
        return struct.pack('>iii', 0, 7, 1)
    if kind == 'arr':
        arr = node[1]
        return (struct.pack('>i', arr.ndim) + struct.pack(f'>{arr.ndim}i', *arr.shape)
                + struct.pack('>ii', _TYPECODES[arr.dtype], max(arr.size, 1)))
    tags = node[1]
    out = struct.pack('>iiii', 0, 8, 1, len(tags))
    out += b''.join(_genx_str(name) for name, _ in tags)
    return out + b''.join(_genx_template(child) for _, child in tags)


def _genx_data(node) -> bytes:
    if node[0] == 'str':
        return _genx_str(node[1])
    if node[0] == 'arr':
        raw = node[1].tobytes()
        return raw + b'\0' * (-len(raw) % 4)
    return b''.join(_genx_data(child) for _, child in node[1])


def _write_genx(path: str):
    """A version-2 genx stream: the seven AIA channel structs (a string, an
    int32 scalar, a float32 log T grid, a float64 response, the grids of
    two channels shorter than the rest) and a nested struct with arrays."""
    rng = np.random.default_rng(2)
    channels = []
    for i, wl in enumerate((94, 131, 171, 193, 211, 304, 335)):
        n = 21 if i in (1, 4) else 26
        logte = (4.0 + 0.2 * np.arange(n)).astype('>f4')
        channels.append((f'A{wl}', ('struct', [
            ('NAME', ('str', f'A{wl}')),
            ('CHANNEL', ('arr', np.asarray(wl, '>i4'))),
            ('LOGTE', ('arr', logte)),
            ('TRESP', ('arr', rng.uniform(0, 1e-24, n).astype('>f8')))])))
    nested = ('struct', [('LABEL', ('str', 'calibration')),
                         ('INNER', ('struct', [('IDS', ('arr', np.arange(5, dtype='>i4'))),
                                               ('GAIN', ('arr', np.float32([1.5, 2.5]).astype('>f4')))]))])
    top = ('struct', channels + [('META', nested)])
    head = struct.pack('>ii', 2, 1) + _genx_str('Sat Nov 17 2012') + _genx_str('x86_64') \
        + _genx_str('linux') + _genx_str('8.2') + _genx_str('')
    with open(path, 'wb') as f:
        f.write(head + _genx_template(top) + _genx_data(top))


def _same_tree(a, b):
    assert type(a) is type(b), (a, b)
    if isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _same_tree(a[k], b[k])
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


def test_genx_reader_and_conversion_match_jax(tmp_path):
    path = str(tmp_path / 'resp.genx')
    _write_genx(path)
    ours, theirs = genx.read_genx(path), jax_read_genx(path)
    _same_tree(ours, theirs)
    assert ours['META']['INNER']['GAIN'].tolist() == [1.5, 2.5]
    assert ours['A94']['CHANNEL'] == 94
    tresp.convert_genx_to_npz(path, str(tmp_path / 'port' / 'r.npz'))
    jax_tresp.convert_genx_to_npz(path, str(tmp_path / 'jax' / 'r.npz'))
    with np.load(str(tmp_path / 'port' / 'r.npz')) as a, \
            np.load(str(tmp_path / 'jax' / 'r.npz')) as b:
        assert sorted(a.files) == sorted(b.files) == ['logte', 'tresp', 'wavelengths']
        for k in a.files:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
        assert a['tresp'].shape == (7, 26)


# ----------------------------------------------------------------- the head

def _head_inputs(seed: int = 3, R: int = 6, S: int = 16):
    rng = np.random.default_rng(seed)
    raw = np.stack([rng.uniform(-0.5, 3.0, (R, S)), rng.uniform(3.5, 9.5, (R, S))],
                   -1).astype(np.float32)
    z = np.sort(rng.uniform(0.0, 2.0, (R, S)), axis=1).astype(np.float32)
    wl = rng.choice([0.0, 94.0, 171.0, 193.0, 335.0, 999.0], (R, 3)).astype(np.float32)
    wl[0] = [171.0, 193.0, 0.0]
    log_abs = rng.uniform(-0.5, 1.5, 7).astype(np.float32)
    return raw, z, wl, log_abs, np.float32(1.3)


def _jax_head_fn(head):
    def fn(raw, log_abs, vol_c, z, wl):
        fo = JaxFieldOutput(raw=raw, log_abs=log_abs, vol_c=vol_c)
        R, S = z.shape
        return head.raw2outputs(fo, z, jnp.zeros((R, 3)), jnp.ones((R, 3)),
                                jnp.zeros((R, S, 3)), wl)
    return fn


def _port_head(head, raw, log_abs, vol_c, z, wl):
    R, S = z.shape
    fo = FieldOutput(raw=raw, log_abs=log_abs, vol_c=vol_c)
    return head.raw2outputs(fo, z, torch.zeros(R, 3), torch.ones(R, 3), torch.zeros(R, S, 3), wl)


@pytest.mark.parametrize('weighting', ['density', 'emission'])
def test_head_and_gradients_match_jax(weighting):
    raw, z, wl, log_abs, vol_c = _head_inputs()
    jhead = jax_dt.DensityTemperatureHead(response=jax_tresp.load_aia_response(),
                                          pixel_intensity_factor=1e17,
                                          hierarchical_weighting=weighting)
    phead = DensityTemperatureHead(response=_port_response(), pixel_intensity_factor=1e17,
                                   hierarchical_weighting=weighting)
    rng = np.random.default_rng(4)
    c_img = rng.normal(size=(raw.shape[0], wl.shape[1])).astype(np.float32)
    c_w = rng.normal(size=z.shape).astype(np.float32)
    fn = _jax_head_fn(jhead)

    # the weights' gradient only under 'density': under 'emission' JAX's is
    # NaN (the quotient rule squares the ~1e-24 per-ray maximum, which
    # underflows in float32; no loss reads the weights, which only place
    # the fine samples), and the port's is checked finite
    with_weights = weighting == 'density'

    def scalar(raw_, log_abs_, vol_c_, z_, wl_):
        out = fn(raw_, log_abs_, vol_c_, z_, wl_)
        scale = jnp.max(jnp.abs(jax.lax.stop_gradient(out['image']))) + 1e-30
        loss = jnp.sum(out['image'] / scale * c_img)
        return loss + jnp.sum(out['weights'] * c_w) if with_weights else loss

    args = [jnp.asarray(a) for a in (raw, log_abs, vol_c, z, wl)]
    jout = jax.jit(fn)(*args)
    jgrads = jax.jit(jax.grad(scalar, argnums=(0, 1, 2)))(*args)

    t_raw, t_abs, t_vc = (torch.tensor(a, requires_grad=True) for a in (raw, log_abs, vol_c))
    pout = _port_head(phead, t_raw, t_abs, t_vc, torch.from_numpy(z), torch.from_numpy(wl))
    for k in ('image', 'weights', 'regularizing_quantity'):
        assert _rel(jout[k], pout[k].detach().numpy()) < HEAD_TOL, k
    # an absent or unknown wavelength renders exactly 0
    absent = (wl == 0.0) | (wl == 999.0)
    assert np.all(pout['image'].detach().numpy()[absent] == 0.0)
    scale = pout['image'].detach().abs().max() + 1e-30
    loss = (pout['image'] / scale * torch.from_numpy(c_img)).sum()
    if with_weights:
        loss = loss + (pout['weights'] * torch.from_numpy(c_w)).sum()
    loss.backward()
    for name, ref, got in zip(('raw', 'log_abs', 'vol_c'), jgrads, (t_raw, t_abs, t_vc)):
        assert got.grad.shape == np.shape(ref), name
        assert _rel(ref, got.grad.numpy()) < HEAD_TOL, name
    t_raw.grad = None
    _port_head(phead, t_raw, t_abs, t_vc, torch.from_numpy(z),
               torch.from_numpy(wl))['weights'].sum().backward()
    assert torch.isfinite(t_raw.grad).all()


def test_cumtrapz_and_trapz_match_jax():
    x = np.array([[0.0, 1.0, 3.0]], np.float32)
    y = np.array([[[1.0], [3.0], [5.0]]], np.float32)
    ct = cumtrapz(torch.from_numpy(y), torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(ct[0, :, 0], [2.0, 10.0], atol=1e-6)
    np.testing.assert_allclose(trapz(torch.from_numpy(y), torch.from_numpy(x)).numpy()[0, 0],
                               10.0, atol=1e-6)
    rng = np.random.default_rng(5)
    y = rng.normal(size=(4, 9, 3)).astype(np.float32)
    x = np.sort(rng.uniform(0, 3, (4, 9)), axis=1).astype(np.float32)
    for ours, theirs in ((cumtrapz, jax_dt.cumtrapz), (trapz, jax_dt.trapz)):
        ref = np.asarray(jax.jit(theirs)(jnp.asarray(y), jnp.asarray(x)))
        assert _rel(ref, ours(torch.from_numpy(y), torch.from_numpy(x)).numpy()) < HEAD_TOL


def _toy_case(pif, log_abs, vol_c, raw0=1.0, raw1=5.0, R=1, S=64, length=3.0, wl=((94.0,),)):
    jresp, presp = _toy_pair()
    raw = np.stack([np.full((R, S), raw0), np.full((R, S), raw1)], -1).astype(np.float32)
    z = np.broadcast_to(np.linspace(0.0, length, S, dtype=np.float32), (R, S)).copy()
    wl = np.asarray(wl, np.float32)
    fn = _jax_head_fn(jax_dt.DensityTemperatureHead(response=jresp, pixel_intensity_factor=pif))
    log_abs = np.full(7, log_abs, np.float32)
    jout = fn(*map(jnp.asarray, (raw, log_abs, np.float32(vol_c), z, wl)))
    pout = _port_head(DensityTemperatureHead(response=presp, pixel_intensity_factor=pif),
                      *map(torch.from_numpy, (raw, log_abs, np.asarray(vol_c, np.float32),
                                              z, wl)))
    img = pout['image'].numpy()
    assert _rel(jout['image'], img) < HEAD_TOL
    return img


def test_dt_quadrature_golden():
    """Constant density, zero absorption: I = rho^2 R(logT) L pif vol_c, the
    integral over z[:, :-1] (S-1 points), as the reference integrates."""
    img = _toy_case(pif=2.0, log_abs=0.0, vol_c=1.5)
    expected = np.exp(1.0) ** 2 * 5.0 * 3.0 * 62 / 63 * 1.5 * 2.0
    np.testing.assert_allclose(img[0, 0], expected, rtol=1e-5)


def test_dt_masking_and_attenuation():
    img = _toy_case(pif=1.0, log_abs=0.0, vol_c=1.0, R=2, S=8,
                    wl=((94.0, 193.0), (94.0, 0.0)))
    assert img[1, 1] == 0.0 and img[0, 0] == img[1, 0] and img[0, 1] > img[0, 0]
    free = _toy_case(pif=1.0, log_abs=0.0, vol_c=1.0)
    absorbed = _toy_case(pif=1.0, log_abs=0.5, vol_c=1.0)
    assert absorbed[0, 0] < free[0, 0]


def test_dt_regularization_and_occupancy_activity():
    jresp, presp = _toy_pair()
    jhead = jax_dt.DensityTemperatureHead(response=jresp, Rs_per_ds=2.0)
    phead = DensityTemperatureHead(response=presp, Rs_per_ds=2.0)
    rng = np.random.default_rng(6)
    dist = rng.uniform(0, 3, (3, 5)).astype(np.float32)
    q = rng.uniform(-1, 4, (3, 5)).astype(np.float32)
    np.testing.assert_allclose(
        phead.regularization(torch.from_numpy(dist), torch.from_numpy(q)).numpy(),
        np.asarray(jhead.regularization(jnp.asarray(dist), jnp.asarray(q))), rtol=1e-6)
    raw = rng.uniform(-1, 3, (3, 5, 2)).astype(np.float32)
    np.testing.assert_allclose(phead.occupancy_activity(torch.from_numpy(raw)).numpy(),
                               np.asarray(jhead.occupancy_activity(jnp.asarray(raw))),
                               rtol=1e-6)
    np.testing.assert_allclose(
        DensityTemperatureHead(response=presp).regularization(
            torch.full((2, 4), 2.0), torch.full((2, 4), 3.0)).numpy(), 0.75 * 3.0, rtol=1e-6)


# --------------------------------------------------------------- SimpleStar

def test_simple_star_apply_matches_jax():
    jp = jax.tree.map(np.asarray, jax_init_star(JaxStarConfig()))
    pp = init_simple_star(SimpleStarConfig(), device='cpu')
    assert set(jp) == set(pp)
    for k in jp:
        assert pp[k].shape == jp[k].shape, k
        np.testing.assert_array_equal(pp[k].numpy(), jp[k])
    # r = 0, inside, at 1, between 1 and R_s (1.02), outside
    radii = np.array([0.0, 0.5, 1.0, 1.01, 1.5, 3.0], np.float32)
    pts = np.zeros((6, 4), np.float32)
    pts[:, 0] = radii * 0.6
    pts[:, 1] = radii * 0.8
    ref = np.asarray(jax.jit(lambda p, x: jax_star_apply(JaxStarConfig(), p, x).raw)(
        jax.tree.map(jnp.asarray, jp), jnp.asarray(pts)))
    np.testing.assert_allclose(simple_star_apply(SimpleStarConfig(), pp,
                                                 torch.from_numpy(pts)).raw.numpy(),
                               ref, rtol=VALUE_RTOL)
    # the parameters' gradients, point by point: JAX's are NaN for h0 and
    # rho_0 at r < ~0.116 (its discarded outer branch overflows there), the
    # port's are finite everywhere and equal JAX's where JAX's are finite
    jgrad = jax.jit(jax.vmap(jax.grad(
        lambda p, x: jnp.sum(jax_star_apply(JaxStarConfig(), p, x[None]).raw)),
        in_axes=(None, 0)))(jax.tree.map(jnp.asarray, jp), jnp.asarray(pts))
    for i in range(len(pts)):
        params = {k: v.clone().requires_grad_(True) for k, v in pp.items()}
        simple_star_apply(SimpleStarConfig(), params, torch.from_numpy(pts[i:i + 1])).raw.sum() \
            .backward()
        for k in ('Rs', 'h0', 'T0', 'rho_0'):
            got, want = params[k].grad.numpy(), np.asarray(jgrad[k][i])
            assert np.isfinite(got), (k, radii[i])
            if radii[i] < 0.116 and k in ('h0', 'rho_0'):
                assert np.isnan(want), (k, radii[i])
                want = {'h0': 0.0, 'rho_0': 1.0 / 3.0e8}[k]
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-30, err_msg=f'{k} {radii[i]}')


def test_simple_star_render_matches_jax_at_a_close_observer():
    """The SKILL recipe's full-disk render at 5 Rs, log_abs zeroed on both
    passes: a limb-brightened disk, all-zero wavelengths exactly 0."""
    jr, jinit = jax_make_star(perturb=False)
    pr, pinit = make_simple_star_renderer(perturb=False, device='cpu')
    jparams = jinit()
    jparams = {k: dict(v, log_abs=jnp.zeros(7)) for k, v in jparams.items()}
    pparams = pinit()
    assert pparams['coarse'] is pparams['fine']
    pparams = {k: dict(v, log_abs=torch.zeros(7)) for k, v in pparams.items()}
    res = 16
    o, d = observer_rays(CLOSE['lat'], CLOSE['lon'], CLOSE['distance'], res)
    o, d = o.reshape(-1, 3).astype(np.float32), d.reshape(-1, 3).astype(np.float32)
    wl = np.broadcast_to(np.float32([171.0, 193.0, 0.0]), (res * res, 3)).copy()
    t = np.zeros((res * res, 1), np.float32)
    ref = np.asarray(jax.jit(lambda *a: jr(jparams, *a[:3], wavelengths=a[3])['image'])(
        *map(jnp.asarray, (o, d, t, wl))))
    img = pr(pparams, *map(torch.from_numpy, (o, d, t)),
             wavelengths=torch.from_numpy(wl))['image'].numpy()
    assert _rel(ref, img) < STAR_RENDER_TOL
    assert np.all(img[:, 2] == 0.0) and np.isfinite(img).all()
    disk = img[:, 1].reshape(res, res)
    assert disk[res // 2, res // 2] > 10 * disk[0, 0]


# ------------------------------------------------------------------ systems

def _json(x):
    return json.loads(json.dumps(x))


def test_systems_round_trip_both_ways():
    small = dict(n_layers=2, d_filter=32, n_freqs=3)
    cases = [
        (lambda **kw: make_density_temperature_system(
            model_config=density_temperature_config(**small),
            coarse_config=density_temperature_config(n_layers=2, d_filter=16),
            hierarchical_weighting='emission', pixel_intensity_factor=1e15, device='cpu', **kw),
         lambda **kw: jax_make_dt(model_config=jax_dt_config(**small),
                                  coarse_config=jax_dt_config(n_layers=2, d_filter=16),
                                  hierarchical_weighting='emission',
                                  pixel_intensity_factor=1e15, use_fused=False, **kw)),
        (lambda **kw: make_simple_star_renderer(pixel_intensity_factor=1e9, device='cpu', **kw),
         lambda **kw: jax_make_star(pixel_intensity_factor=1e9, **kw)),
    ]
    for port_factory, jax_factory in cases:
        pr, _ = port_factory(n_stratified=8, n_hierarchical=8)
        jr, _ = jax_factory(n_stratified=8, n_hierarchical=8)
        assert _json(pr.spec) == _json(jr.spec)
        # the port's spec rebuilt by JAX, JAX's by the port
        assert _json(jax_from_spec(_json(pr.spec), use_fused=False)[0].spec) == _json(pr.spec)
        rebuilt, init = from_spec(_json(jr.spec), device='cpu')
        assert _json(rebuilt.spec) == _json(jr.spec)
        assert type(rebuilt.head) is type(pr.head)
    # the DT system's fields and its default pif
    renderer, init = from_spec(_json(cases[0][0]()[0].spec), device='cpu')
    params = init(torch.Generator().manual_seed(0))
    assert params['coarse']['w_h'].shape == (1, 16, 16)
    assert params['fine']['log_abs'].shape == (7,) and params['fine']['vol_c'].shape == ()
    assert renderer.head.hierarchical_weighting == 'emission'
    assert renderer.coarse_field_apply is not None
    dt_default, _ = make_density_temperature_system(device='cpu')
    assert dt_default.head.pixel_intensity_factor == 1e17
    assert dt_default.spec['model_config']['d_filter'] == 512
    with pytest.raises(NotImplementedError, match='item 9'):
        from_spec({'head': 'mhd', 'Rs_per_ds': 1.0}, device='cpu')
    # occupancy is ported: the DT system with a grid builds, its spec equals
    # JAX's and rebuilds (both ways) with the grid in the params
    occ = {'nr': 8, 'ntheta': 4, 'nphi': 8, 'nvol': [4, 2, 4]}
    pr, _ = cases[0][0](occupancy=occ)
    jr, _ = cases[0][1](occupancy=occ)
    assert _json(pr.spec) == _json(jr.spec)
    rebuilt, init = from_spec(_json(jr.spec), device='cpu')
    assert rebuilt.occupancy == pr.occupancy and rebuilt.occupancy.nvol == (4, 2, 4)
    grid = init(torch.Generator().manual_seed(0))['occupancy']
    assert {k: tuple(v.shape) for k, v in grid.items()} == {
        'occ_r': (8,), 'occ_ang': (4, 8), 'occ_vol': (4, 2, 4)}
    assert _json(jax_from_spec(_json(pr.spec), use_fused=False)[0].spec) == _json(pr.spec)


def test_entry_points_default_to_the_card():
    from sunerf_tpu_torch import run_density_temperature, systems
    for fn in (systems.make_density_temperature_system, systems.make_simple_star_renderer,
               systems.make_thomson_system, tresp.load_aia_response,
               image_render.build_model_renderer, image_render.render_observers):
        assert inspect.signature(fn).parameters['device'].default == 'cuda', fn.__name__
    for module in (run_density_temperature, image_render):
        assert "default='cuda'" in inspect.getsource(module.main)


def test_params_from_numpy_keeps_0d():
    jr, jinit = jax_make_dt(model_config=jax_dt_config(n_layers=2, d_filter=8), use_fused=False)
    params = params_from_numpy(jax.tree.map(np.asarray, jinit(jax.random.key(0))), 'cpu')
    assert params['fine']['vol_c'].shape == () and params['fine']['log_abs'].shape == (7,)
    star = params_from_numpy(jax.tree.map(np.asarray, jax_init_star()), 'cpu')
    assert all(star[k].shape == () for k in ('Rs', 'h0', 'T0', 'rho_0'))


# ------------------------------------------------------------- data builder

def _write_tree(root, spec, res=8, seed=0):
    rng = np.random.default_rng(seed)
    for inst, wls, n_views in spec:
        for wl in wls:
            d = root / inst / str(wl)
            d.mkdir(parents=True)
            for i in range(n_views):
                t = datetime(2012, 11, 1 + i, 12, 0)
                header = jax_observer_header(5.0 * i - 5.0, i * 40.0 + 10 * len(inst), 215.0, t,
                                             res, float(wl))
                jax_write_fits(str(d / f'{inst}.{t.strftime("%Y-%m-%dT%H:%M:%S")}.{wl}.fits'),
                               rng.uniform(0, 5, (res, res)).astype(np.float32), header)


@pytest.mark.parametrize('target_resolution', [None, 4])
def test_multi_thermal_builder_matches_jax(tmp_path, target_resolution):
    """tests/test_data_pipeline.py's tree (aia 171 + 193, euvib 193 only)
    and a third source with every channel; both builders give the same
    shards, held-out arrays and batch order, bit for bit."""
    root = tmp_path / 'mt'
    _write_tree(root, (('aia', (171, 193), 3), ('euvib', (193,), 3), ('stereo', (171, 193), 2)))
    kw = dict(batch_size=8, target_resolution=target_resolution)
    jd = jax_build(str(root), str(tmp_path / 'jax'), n_devices=1, **kw)
    pd = build_multi_thermal_data(str(root), str(tmp_path / 'port'), n_workers=1, **kw)
    assert pd.config == jd.config and pd.config['wavelengths'] == [171, 193]
    assert pd.ref_time == jd.ref_time and pd.validation_shape == jd.validation_shape
    assert pd.validation_shape == ((4, 4) if target_resolution else (8, 8))
    assert set(pd.train.batch_files) == set(jd.train.batch_files) == {
        'rays', 'time', 'target_image', 'wavelength'}
    for k in pd.train.batch_files:
        a, b = np.load(pd.train.batch_files[k]), np.load(jd.train.batch_files[k])
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert set(pd.valid.arrays) == set(jd.valid.arrays)
    for k in pd.valid.arrays:
        np.testing.assert_array_equal(pd.valid.arrays[k], jd.valid.arrays[k])
    for k in ('poses', 'times'):
        np.testing.assert_array_equal(pd.extras['overview'][k], jd.extras['overview'][k])
    batch = pd.train[0]
    assert batch['wavelength'].shape == batch['target_image'].shape == (8, 2)
    wl_rows = {tuple(r) for r in np.load(pd.train.batch_files['wavelength']).astype(int).tolist()}
    assert wl_rows == {(171, 193), (0, 193)}
    jb, pb = jax_iterate_batches(jd.train, seed=7), iterate_batches(pd.train, seed=7)
    for _ in range(len(pd.train) + 2):
        a, b = next(jb), next(pb)
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    if target_resolution is None:
        two = build_multi_thermal_data(str(root), str(tmp_path / 'two'), n_workers=2, **kw)
        for k in pd.train.batch_files:
            np.testing.assert_array_equal(np.load(two.train.batch_files[k]),
                                          np.load(pd.train.batch_files[k]))


# -------------------------------------------------------------- synthesizer

def _float64_frames(config) -> dict:
    """The synthesizer's frames rendered by the port in float64, by relative
    FITS path."""
    import dataclasses
    from sunerf_tpu_torch.core.geometry import fov_for_distance
    renderer, params = image_render.build_model_renderer(config, device='cpu')
    resp = renderer.head.response
    renderer = dataclasses.replace(renderer, head=dataclasses.replace(
        renderer.head, response=tresp.TemperatureResponse(resp.logte.double(),
                                                          resp.tresp.double())))
    params = {k: {kk: vv.double() for kk, vv in v.items()} for k, v in params.items()}
    res, wls = config['resolution'], config['wavelengths']
    frames = {}
    for i, obs in enumerate(image_render.observers_from_config(config)):
        o, d = observer_rays(np.deg2rad(obs['lat']), np.deg2rad(obs['lon']), obs['distance'],
                             res, fov=fov_for_distance(obs['distance']))
        n = res * res
        img = renderer(params, torch.from_numpy(o.reshape(n, 3)).double(),
                       torch.from_numpy(d.reshape(n, 3)).double(),
                       torch.zeros(n, 1, dtype=torch.float64),
                       wavelengths=torch.tensor(wls, dtype=torch.float64).expand(n, len(wls))
                       )['image'].reshape(res, res, -1).numpy()
        t = obs['time'] if isinstance(obs['time'], datetime) else \
            datetime(2000, 1, 1) + timedelta(seconds=obs['time'] * 86400.0)
        for c, wl in enumerate(wls):
            frames[os.path.join(obs['name'], str(wl), f"{obs['name']}_{i:03d}."
                                f"{t.strftime('%Y-%m-%dT%H:%M:%S')}.{wl}.fits")] = img[:, :, c]
    return frames


def test_render_observers_matches_jax(tmp_path):
    observers = [{'name': 'aia', 'lat': 10.0, 'lon': 20.0, 'distance': 5.0,
                  'time': '2012-08-23T00:00:00'},
                 {'name': 'euvi', 'lat': -5.0, 'lon': 120.0, 'distance': 6.0,
                  'time': '2012-08-23T06:00:00'},
                 {'name': 'euvi', 'lat': 0.0, 'lon': 200.0, 'distance': 5.5, 'time': 0.5}]
    config = {'model': 'SimpleStar', 'render_format': ['fits', 'jpeg'], 'resolution': 8,
              'wavelengths': [171, 193, 304], 'batch_size': 32,
              'pixel_intensity_factor': 1e9, 'observers': observers}
    jax_out = jax_render_observers(dict(config, render_path=str(tmp_path / 'jax')))
    port_out = image_render.render_observers(dict(config, render_path=str(tmp_path / 'port')),
                                             device='cpu')
    rel = lambda paths, root: sorted(os.path.relpath(p, root) for p in paths)  # noqa: E731
    assert rel(port_out, tmp_path / 'port') == rel(jax_out, tmp_path / 'jax')
    fits = lambda root: sorted(os.path.relpath(os.path.join(d, f), root)  # noqa: E731
                               for d, _, fs in os.walk(root) for f in fs if f.endswith('.fits'))
    assert fits(tmp_path / 'port') == fits(tmp_path / 'jax') and len(fits(tmp_path / 'port')) == 9
    exact = _float64_frames(config)
    for name in fits(tmp_path / 'port'):
        pdata, pheader = read_fits(str(tmp_path / 'port' / name))
        jdata, jheader = jax_read_fits(str(tmp_path / 'jax' / name))
        assert dict(pheader.cards) == dict(jheader.cards), name
        truth = exact[name]
        # about as close to the float64 frame as JAX's own float32 frame is
        assert _rel(truth, pdata) <= max(2.0 * _rel(truth, jdata), 1e-5), name
        assert _rel(jdata, pdata) < SYNTH_TOL, name
    with pytest.raises(NotImplementedError, match='item 9'):
        image_render.build_model_renderer({'model': 'MHDModel'}, device='cpu')


# ---------------------------------------------------------- DT closed loop

@pytest.fixture(scope='module')
def dt_tree(tmp_path_factory):
    """tests/test_end_to_end.py's DT set: JAX's SimpleStar at 12x12, channels
    [171, 193], 7 observers, as an <instrument>/<wavelength>/ FITS tree."""
    tmp = tmp_path_factory.mktemp('dt')
    jax_render_observers({
        'model': 'SimpleStar', 'render_path': str(tmp / 'mt'), 'render_format': ['fits'],
        'resolution': 12, 'wavelengths': [171, 193], 'batch_size': 256,
        'pixel_intensity_factor': 1e9,
        'observers': [{'name': 'aia', 'lat': 2.0 * i - 6, 'lon': i * 51.0, 'distance': 215.0,
                       'time': datetime(2012, 11, 1 + i).isoformat()} for i in range(7)]})
    return tmp


DT_SMALL = dict(n_layers=2, d_filter=32)
DT_SAMPLES = dict(n_stratified=8, n_hierarchical=8, perturb=False)
DT_LOOP = dict(total_steps=30, val_every=30, checkpoint_every=30, log_every=10,
               save_val_images=False)
DT_LOSS = dict(image_scaling='none', lambda_regularization=0.0)
DT_OPTIM = dict(lr_start=1e-3, lr_floor=1e-3)


def _records(workdir) -> list:
    with open(os.path.join(workdir, 'metrics.jsonl')) as f:
        return [json.loads(line) for line in f]


def test_dt_closed_loop_matches_jax(dt_tree, tmp_path):
    root = str(dt_tree / 'mt')
    jdata = jax_build(root, str(tmp_path / 'jwork'), batch_size=96)
    pdata = build_multi_thermal_data(root, str(tmp_path / 'pwork'), batch_size=96, n_workers=1)
    assert pdata.config['wavelengths'] == [171, 193]
    jr, jinit = jax_make_dt(model_config=jax_dt_config(**DT_SMALL), pixel_intensity_factor=1e9,
                            use_fused=False, **DT_SAMPLES)
    params = jax.tree.map(np.asarray, jinit(jax.random.key(0)))
    jt = JaxTrainer(jr, params, jdata, loss_config=JaxLossConfig(**DT_LOSS),
                    optim_config=JaxOptimConfig(**DT_OPTIM),
                    trainer_config=JaxTrainerConfig(**DT_LOOP), workdir=str(tmp_path / 'jax'))
    handler = signal.getsignal(signal.SIGTERM)
    try:
        jt.fit()
    finally:
        signal.signal(signal.SIGTERM, handler)   # JAX's fit leaves its own
    pr, _ = make_density_temperature_system(model_config=density_temperature_config(**DT_SMALL),
                                            pixel_intensity_factor=1e9, device='cpu',
                                            **DT_SAMPLES)
    pt = Trainer(pr, params, pdata, loss_config=LossConfig(**DT_LOSS),
                 optim_config=OptimConfig(**DT_OPTIM), trainer_config=TrainerConfig(**DT_LOOP),
                 workdir=str(tmp_path / 'port'), device='cpu')
    pt.fit()
    jrec = [r for r in _records(tmp_path / 'jax') if 'loss' in r]
    prec = [r for r in _records(tmp_path / 'port') if 'loss' in r]
    assert [r['step'] for r in prec] == [r['step'] for r in jrec] == [10, 20, 30]
    for j, p in zip(jrec, prec):
        assert abs(p['loss'] - j['loss']) <= LOSS_RTOL * abs(j['loss']), (j['loss'], p['loss'])
    assert prec[-1]['loss'] < prec[0]['loss']
    # each package's bundle through both loaders, two channels at 5 Rs
    view = dict(CLOSE, resolution=8, wavelengths=[171.0, 193.0])
    for name in ('port', 'jax'):
        path = str(tmp_path / name / 'save_state')
        in_jax = JaxLoader(path, batch_size=64).render_observer_image(**view).image
        loader = SuNeRFLoader(path, batch_size=64, device='cpu')
        assert loader.wavelengths == [171, 193]
        in_port = loader.render_observer_image(**view).image
        assert in_port.shape == (8, 8, 2) and np.isfinite(in_port).all()
        assert _rel(in_jax, in_port) < BUNDLE_TOL, name
        zero = loader.render_observer_image(**dict(view, wavelengths=[0.0, 0.0])).image
        assert np.all(zero == 0.0)


# ---------------------------------------------------------------------- CLI

def test_run_density_temperature_cli_both_packages(dt_tree, tmp_path, monkeypatch):
    """Both run_density_temperature.main on one tiny config (2x32 fields,
    8 + 8 samples, 6 steps, a 2-view drift probe). JAX's CLI trains on the
    test host's 8-device mesh with 8x the global batch, so each run is held
    to its own outputs, and the bundles cross-load."""
    from sunerf_tpu.run_density_temperature import main as jax_main
    from sunerf_tpu_torch.run_density_temperature import main
    for name in ('jax', 'port'):
        workdir = str(tmp_path / name)
        config = {'path_to_save': workdir,
                  'data': {'data_path': str(dt_tree / 'mt'), 'batch_size': 32},
                  'model': {'n_layers': 2, 'd_filter': 32},
                  'rendering': {'n_stratified': 8, 'n_hierarchical': 8},
                  'optimizer': {'lr_start': 1e-3, 'lr_floor': 1e-3},
                  'training': {'total_steps': 6, 'log_every_n_steps': 3, 'scalar_log_every': 3,
                               'keep_best': True, 'ema_decay': 0.9,
                               'drift_probe_views': 2, 'drift_probe_resolution': 8}}
        path = str(tmp_path / f'{name}.yaml')
        with open(path, 'w') as f:
            yaml.safe_dump(config, f)
        if name == 'jax':
            cache = jax.config.jax_enable_compilation_cache
            jax.config.update('jax_enable_compilation_cache', False)
            handler = signal.signal(signal.SIGTERM, signal.SIG_DFL)
            try:
                jax_main(['--config', path])
            finally:
                signal.signal(signal.SIGTERM, handler)   # JAX's fit leaves its own
                jax.config.update('jax_enable_compilation_cache', cache)
        else:
            monkeypatch.setattr(os, 'cpu_count', lambda: 1)
            try:
                trainer = main(['--config', path, '--device', 'cpu'])
            finally:
                monkeypatch.undo()
            assert trainer.renderer.head.pixel_intensity_factor == 1e17
        recs = _records(workdir)
        assert [r['step'] for r in recs if 'loss' in r] == [3, 6], name
        vals = [r for r in recs if 'val_psnr' in r]
        assert [r['step'] for r in vals] == [0, 3, 6], name
        assert all('probe_stability_db' in r for r in vals[1:]), name
        assert all(np.isfinite(r['loss']) for r in recs if 'loss' in r), name
        for bundle in ('save_state', 'save_state_best', 'save_state_ema'):
            assert os.path.exists(os.path.join(workdir, bundle + '.npz')), (name, bundle)
    view = dict(CLOSE, resolution=8, wavelengths=[171.0, 193.0])
    for name in ('port', 'jax'):
        path = str(tmp_path / name / 'save_state')
        for loader in (JaxLoader(path, batch_size=64),
                       SuNeRFLoader(path, batch_size=64, device='cpu')):
            assert np.isfinite(loader.render_observer_image(**view).image).all()
    mb = str(tmp_path / 'mb.yaml')
    with open(mb, 'w') as f:
        yaml.safe_dump({'data': {'data_path': str(dt_tree / 'mt')},
                        'training': {'microbatch': 64}}, f)
    with pytest.raises(NotImplementedError, match='Queue 1 item 10'):
        main(['--config', mb, '--device', 'cpu'])
