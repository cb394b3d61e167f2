"""The port's Trainer, spike guard, EMA and training checkpoints
(sunerf_tpu_torch/train/{loop,step,probe}.py, utils/checkpoint.py) against
the JAX package on the CPU.

The closed loop is tests/test_end_to_end.py's: JAX's SimpleStar renders at
16x16 (8 observers) as FITS, a 2x32 emission field for both passes, 8 + 8
samples, perturb off on both sides, 40 steps at lr 1e-3, validation every
10 steps with keep_best, EMA (0.9) and a 2-view drift probe at 8x8. Both
Trainers start from one set of JAX-initialised parameters. Tolerances, as
measured on the CPU (both fields float32; the renders differ by float32
sums in another order, which ten Adam steps then carry):
  * logged losses within 1e-3 relative (measured 4.1e-4);
  * val_psnr and val_psnr_ema within 0.05 dB (measured 1.4e-3);
  * the drift probe's dB within 0.2 (measured 0.064);
  * bundle renders across the packages within 1e-4 of max, at a close
    observer (float32 renders at 1 AU are ill-conditioned, ROADMAP Queue 3).
The spike guard and EMA are held against JAX's make_train_step on the same
parameters and batches (tests/test_train.py's setup, perturb off): the
same trips, the loss EMA within 1e-5 relative, the parameters within 1e-4
of max of JAX's; the EMA is the exact lerp of the port's own parameters
(1e-6, as tests/test_train.py holds JAX's) and within 1e-5 of max of JAX's
average.
"""
import dataclasses
import functools
import json
import os
import shutil
import signal
from datetime import datetime, timedelta

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sunerf_tpu.data.loaders import build_single_channel_data as jax_build
from sunerf_tpu.evaluation.image_render import render_observers
from sunerf_tpu.evaluation.loader import SuNeRFLoader as JaxLoader
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
from sunerf_tpu.train.optim import make_optimizer as jax_make_optimizer
from sunerf_tpu.train.step import create_train_state as jax_create_train_state
from sunerf_tpu.train.step import make_train_step as jax_make_train_step
from sunerf_tpu_torch.data.loaders import build_single_channel_data
from sunerf_tpu_torch.evaluation.loader import SuNeRFLoader
from sunerf_tpu_torch.models.fields import emission_config, params_from_numpy
from sunerf_tpu_torch.parallel.mesh import make_mesh
from sunerf_tpu_torch.rendering.emission import EmissionHead
from sunerf_tpu_torch.rendering.renderer import Renderer
from sunerf_tpu_torch.systems import make_emission_system
from sunerf_tpu_torch.train.loop import Trainer, TrainerConfig, degenerate_prediction
from sunerf_tpu_torch.train.objective import LossConfig
from sunerf_tpu_torch.train.optim import OptimConfig, make_optimizer
from sunerf_tpu_torch.train.step import create_train_state, make_train_step
from sunerf_tpu_torch.utils.checkpoint import (latest_checkpoint, restore_train_checkpoint,
                                               save_train_checkpoint)

torch.set_num_threads(1)

LOSS_RTOL = 1e-3
PSNR_DB = 0.05
PROBE_DB = 0.2
LOSS_KW = dict(lambda_regularization=0.1, scaling_vmax=10.0)
OPTIM_KW = dict(lr_start=1e-3, lr_floor=1e-3)
LOOP_KW = dict(total_steps=40, val_every=10, checkpoint_every=20, log_every=10,
               save_val_images=False, keep_best=True, ema_decay=0.9,
               drift_probe_views=2, drift_probe_resolution=8)
SMALL = dict(n_layers=2, d_filter=32)
SAMPLES = dict(n_stratified=8, n_hierarchical=8, perturb=False)


def _records(workdir) -> list:
    with open(os.path.join(workdir, 'metrics.jsonl')) as f:
        return [json.loads(line) for line in f]


def _port_system():
    return make_emission_system(model_config=emission_config(**SMALL), device='cpu',
                                **SAMPLES)


@pytest.fixture(scope='module')
def views(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('closed_loop')
    observers = [{'name': 'aia', 'lat': 5.0 * ((i % 3) - 1), 'lon': i * 45.0,
                  'distance': 215.0, 'time': datetime(2012, 8, 20 + i).isoformat()}
                 for i in range(8)]
    render_observers({'model': 'SimpleStar', 'render_path': str(tmp / 'renders'),
                      'render_format': ['fits'], 'resolution': 16, 'wavelengths': [193],
                      'batch_size': 256, 'pixel_intensity_factor': 1e9,
                      'observers': observers})
    return tmp, str(tmp / 'renders' / 'aia' / '193' / '*.fits')


@pytest.fixture(scope='module')
def port_data(views, tmp_path_factory):
    _, pattern = views
    return build_single_channel_data(pattern, str(tmp_path_factory.mktemp('pwork')),
                                     batch_size=128, n_workers=1)


@pytest.fixture(scope='module')
def loops(views, port_data, tmp_path_factory):
    """Both Trainers, 40 steps from the same JAX-initialised parameters."""
    _, pattern = views
    tmp = tmp_path_factory.mktemp('loops')
    jr, jinit = jax_make_emission_system(model_config=jax_emission_config(**SMALL), **SAMPLES)
    params = jax.tree.map(np.asarray, jinit(jax.random.key(7)))
    jdata = jax_build(pattern, str(tmp / 'jwork'), batch_size=128, n_workers=1)
    jt = JaxTrainer(jr, params, jdata, loss_config=JaxLossConfig(**LOSS_KW),
                    optim_config=JaxOptimConfig(**OPTIM_KW),
                    trainer_config=JaxTrainerConfig(**LOOP_KW), workdir=str(tmp / 'jax'))
    handler = signal.getsignal(signal.SIGTERM)
    try:
        jt.fit()
    finally:
        signal.signal(signal.SIGTERM, handler)   # JAX's fit leaves its own
    tr, _ = _port_system()
    pt = Trainer(tr, params, port_data, loss_config=LossConfig(**LOSS_KW),
                 optim_config=OptimConfig(**OPTIM_KW), trainer_config=TrainerConfig(**LOOP_KW),
                 workdir=str(tmp / 'port'), device='cpu')
    pt.fit()
    return dict(jax=jt, port=pt, jdir=str(tmp / 'jax'), pdir=str(tmp / 'port'), tmp=tmp)


def test_closed_loop_losses_match_jax(loops):
    jrec = [r for r in _records(loops['jdir']) if 'loss' in r]
    prec = [r for r in _records(loops['pdir']) if 'loss' in r]
    assert [r['step'] for r in prec] == [r['step'] for r in jrec] == [10, 20, 30, 40]
    for j, p in zip(jrec, prec):
        for k in ('loss', 'coarse_loss', 'fine_loss', 'regularization_loss', 'psnr'):
            np.testing.assert_allclose(p[k], j[k], rtol=LOSS_RTOL, err_msg=f"{k} {p['step']}")
    assert prec[-1]['loss'] < prec[0]['loss']
    assert all(r['rays_per_sec'] > 0 and r['step_ms'] > 0 for r in prec)


def test_closed_loop_validation_matches_jax(loops):
    jval = [r for r in _records(loops['jdir']) if 'val_psnr' in r]
    pval = [r for r in _records(loops['pdir']) if 'val_psnr' in r]
    assert [r['step'] for r in pval] == [r['step'] for r in jval] == [0, 10, 20, 30, 40]
    for j, p in zip(jval, pval):
        assert set(p) - {'step_ms'} == set(j), (sorted(p), sorted(j))
        for k in ('val_psnr', 'val_psnr_ema', 'val_best_psnr'):
            if k in j:
                assert abs(p[k] - j[k]) < PSNR_DB, (p['step'], k, p[k], j[k])
        for k in ('probe_stability_db', 'probe_drift_since_best_db'):
            if k in j:
                assert abs(p[k] - j[k]) < PROBE_DB, (p['step'], k, p[k], j[k])
    # the validation improved over the step-0 sanity render
    assert pval[-1]['val_psnr'] > pval[0]['val_psnr']


def test_keep_best_and_ema_bundles(loops):
    """keep_best keeps the running maximum of the validations, and the
    same variant as JAX; the EMA bundle differs from the live bundle and
    renders (tests/test_end_to_end.py:131-193, :336-415)."""
    recs = _records(loops['pdir'])
    vals = [r for r in recs if 'val_psnr' in r]
    bests = [r['val_best_psnr'] for r in recs if 'val_best_psnr' in r]
    scores = [max(v['val_psnr'], v.get('val_psnr_ema', -np.inf)) for v in vals]
    assert bests and max(bests) == max(scores) and bests == sorted(bests)
    with open(os.path.join(loops['pdir'], 'save_state_best.json')) as f:
        best = json.load(f)
    with open(os.path.join(loops['jdir'], 'save_state_best.json')) as f:
        jbest = json.load(f)
    assert float(best['best_val_psnr']) == max(bests)
    assert best['best_variant'] == jbest['best_variant']
    live = np.load(os.path.join(loops['pdir'], 'save_state.npz'))
    ema = np.load(os.path.join(loops['pdir'], 'save_state_ema.npz'))
    assert set(live.files) == set(ema.files)
    assert any(not np.array_equal(live[k], ema[k]) for k in live.files)
    for bundle in ('save_state_best', 'save_state_ema'):
        view = SuNeRFLoader(os.path.join(loops['pdir'], bundle), batch_size=64,
                            device='cpu').render_observer_image(
            lat=0.1, lon=0.3, time=0.0, distance=215.0, resolution=8)
        assert np.isfinite(view.image).all()


def test_resume_picks_up_at_step_40(loops, port_data, tmp_path):
    """A new Trainer on the workdir resumes at step 40 with the EMA average
    and Adam's state restored, logs steps 41-45, and keeps the best
    bundle's high-water mark."""
    workdir = str(tmp_path / 'resume')
    shutil.copytree(loops['pdir'], workdir)
    tr, _ = _port_system()
    cfg = dataclasses.replace(TrainerConfig(**LOOP_KW), total_steps=45, log_every=5)
    first = loops['port']
    t2 = Trainer(tr, first.state.params, port_data, loss_config=LossConfig(**LOSS_KW),
                 optim_config=OptimConfig(**OPTIM_KW), trainer_config=cfg, workdir=workdir,
                 device='cpu')
    assert t2.state.step == 40 and t2.state.updates == 40
    for f in ('coarse', 'fine'):
        for k, v in first.state.ema_params[f].items():
            torch.testing.assert_close(t2.state.ema_params[f][k], v, rtol=0, atol=0)
        for k, v in first.state.params[f].items():
            p_new = t2.state.params[f][k]
            torch.testing.assert_close(t2.state.opt_state.state[p_new]['exp_avg'],
                                       first.state.opt_state.state[v]['exp_avg'],
                                       rtol=0, atol=0)
    assert t2._best_psnr_high_water() == max(
        r['val_best_psnr'] for r in _records(workdir) if 'val_best_psnr' in r)
    t2.fit()
    assert t2.state.step == 45
    assert [r['step'] for r in _records(workdir) if 'loss' in r][-1] == 45
    assert os.path.basename(latest_checkpoint(workdir)) == 'step_00000045.pt'


def test_bundles_cross_load_both_ways(loops):
    """The port's bundle renders in JAX's loader as in its own, and JAX's
    bundle in the port's, within 1e-4 of max (a close observer)."""
    view = dict(lat=0.3, lon=1.0, time=0.0, distance=3.0, resolution=8)
    for d in (loops['pdir'], loops['jdir']):
        path = os.path.join(d, 'save_state')
        a = JaxLoader(path, batch_size=64).render_observer_image(**view)
        b = SuNeRFLoader(path, batch_size=64, device='cpu').render_observer_image(**view)
        for k in ('image', 'height_map', 'absorption_map'):
            ref, got = np.asarray(getattr(a, k)), getattr(b, k)
            assert ref.shape == got.shape
            assert np.max(np.abs(ref - got)) <= 1e-4 * np.max(np.abs(ref)), (d, k)


def test_drift_probe_warning(loops, port_data, tmp_path):
    """The probe's distance is the held-out view's, and its warning fires
    when band-val sits within 0.5 dB of its best while the probe render is
    far from the best checkpoint's, and not when a validation sets a new
    best (tests/test_end_to_end.py:194-280)."""
    workdir = str(tmp_path / 'probe')
    shutil.copytree(loops['pdir'], workdir)
    tr, _ = _port_system()
    trainer = Trainer(tr, loops['port'].state.params, port_data,
                      loss_config=LossConfig(**LOSS_KW), trainer_config=TrainerConfig(**LOOP_KW),
                      workdir=workdir, device='cpu')
    origins = np.asarray(port_data.valid.arrays['rays'][:, 0])
    d_val = float(np.median(np.linalg.norm(origins, axis=-1)))
    d_probe = float(np.linalg.norm(trainer._drift_probe.view_origins[0]))
    np.testing.assert_allclose(d_probe, d_val, rtol=1e-4)
    v_now = trainer.validate(997)['val_psnr']
    assert trainer.validate(998)['probe_stability_db'] == 99.0   # eval is deterministic
    trainer._probe_best_val = v_now + 0.2
    trainer._probe_at_best = np.full_like(trainer._probe_prev, 1e3)
    val = trainer.validate(999)
    assert val.get('probe_drift_warning') == 1.0
    assert val['probe_drift_since_best_db'] < 25.0
    trainer._probe_best_val = v_now - 5.0
    trainer._probe_at_best = np.full_like(trainer._probe_prev, 1e3)
    assert 'probe_drift_warning' not in trainer.validate(1000)
    warn = [f for f in os.listdir(workdir) if f.startswith('probe_warn_')]
    assert warn
    saved = np.load(os.path.join(workdir, warn[0]))
    assert saved['probe'].shape == saved['at_best'].shape == (2, 8, 8, 1)


def test_drift_probe_gate(port_data, tmp_path):
    """A marginal keep_best promotion with a drifted probe is vetoed, a
    large one promotes (tests/test_end_to_end.py:281-335)."""
    tr, init = _port_system()
    with pytest.raises(ValueError, match='drift_probe_gate'):
        Trainer(tr, init, port_data, trainer_config=TrainerConfig(drift_probe_gate=True),
                workdir=str(tmp_path / 'bad'), device='cpu')
    cfg = dataclasses.replace(TrainerConfig(**LOOP_KW), total_steps=10, ema_decay=0.0,
                              drift_probe_gate=True)
    trainer = Trainer(tr, init, port_data, loss_config=LossConfig(**LOSS_KW),
                      trainer_config=cfg, workdir=str(tmp_path / 'gate'), device='cpu')
    v_now = trainer.validate(1)['val_psnr']
    trainer._best_val_psnr = v_now - 0.5
    pinned = np.full_like(trainer._probe_prev, 1e3)
    trainer._probe_at_best = pinned
    trainer._probe_best_val = v_now - 0.5
    val = trainer.validate(2)
    assert val.get('probe_gate_rejected') == 1.0 and 'val_best_psnr' not in val
    assert trainer._best_psnr_high_water() == v_now - 0.5
    assert np.all(trainer._probe_at_best == pinned)
    trainer._best_val_psnr = v_now - 5.0
    trainer._probe_at_best = np.full_like(trainer._probe_prev, 1e3)
    trainer._probe_best_val = v_now - 5.0
    val2 = trainer.validate(3)
    assert 'probe_gate_rejected' not in val2 and val2.get('val_best_psnr') == v_now
    assert not np.all(trainer._probe_at_best == 1e3)


def _sentinel(signum, frame):
    pass


def test_fit_restores_the_sigterm_handler(port_data, tmp_path):
    """fit's SIGTERM handler is gone when fit returns, when it raises, and
    after a preemption, which checkpoints and returns at the next step; with
    debug_nans, anomaly detection is on while fit runs and off after it."""
    tr, init = _port_system()
    cfg = TrainerConfig(total_steps=3, val_every=1000, checkpoint_every=1000, log_every=1,
                        save_val_images=False)
    previous = signal.signal(signal.SIGTERM, _sentinel)
    try:
        trainer = Trainer(tr, init, port_data, trainer_config=cfg,
                          workdir=str(tmp_path / 'ok'), device='cpu')
        trainer.fit()
        assert signal.getsignal(signal.SIGTERM) is _sentinel

        failing = Trainer(tr, init, port_data, trainer_config=cfg,
                          workdir=str(tmp_path / 'raise'), device='cpu')

        def boom(state, batch, seed):
            raise RuntimeError('step failed')
        failing.step_fn = boom
        with pytest.raises(RuntimeError, match='step failed'):
            failing.fit()
        assert signal.getsignal(signal.SIGTERM) is _sentinel

        workdir = str(tmp_path / 'preempt')
        preempted = Trainer(tr, init, port_data,
                            trainer_config=dataclasses.replace(cfg, total_steps=10),
                            workdir=workdir, device='cpu')
        step_fn = preempted.step_fn

        def step_then_term(state, batch, seed):
            out = step_fn(state, batch, seed)
            if state.step == 2:
                os.kill(os.getpid(), signal.SIGTERM)
            return out
        preempted.step_fn = step_then_term
        preempted.fit()
        assert preempted.state.step == 2
        assert signal.getsignal(signal.SIGTERM) is _sentinel
        assert os.path.basename(latest_checkpoint(workdir)) == 'step_00000002.pt'
        assert any(r.get('preempted') == 1.0 for r in _records(workdir))

        # debug_nans: anomaly detection while fit runs, off again after it
        debug = Trainer(tr, init, port_data,
                        trainer_config=dataclasses.replace(cfg, debug_nans=True),
                        workdir=str(tmp_path / 'debug'), device='cpu')
        seen = []
        inner = debug.step_fn
        debug.step_fn = lambda *a: (seen.append(torch.is_anomaly_enabled()), inner(*a))[1]
        debug.fit()
        assert seen == [True] * 3 and not torch.is_anomaly_enabled()
    finally:
        signal.signal(signal.SIGTERM, previous)


def test_trainer_refuses_what_is_not_ported(port_data, tmp_path):
    tr, init = _port_system()
    # the mesh and microbatch, which raised here before, run: two steps on a
    # one-rank mesh (gloo in this process) give the single-device Trainer's
    # bits, and microbatch 64 takes each 128-ray batch in two chunks
    two = TrainerConfig(total_steps=2, val_every=10, checkpoint_every=10, log_every=1,
                        save_val_images=False)
    single = Trainer(tr, init, port_data, trainer_config=two, workdir=str(tmp_path / 's'),
                     device='cpu')
    single.fit()
    mesh = make_mesh(devices=['cpu'], init_method=f'file://{tmp_path}/store', rank=0,
                     world_size=1, timeout=timedelta(seconds=60))
    try:
        meshed = Trainer(tr, init, port_data, trainer_config=two, workdir=str(tmp_path / 'm'),
                         mesh=mesh, device='cpu')
        meshed.fit()
    finally:
        torch.distributed.destroy_process_group()
    for f in ('coarse', 'fine'):
        for k, v in single.state.params[f].items():
            assert torch.equal(meshed.state.params[f][k], v), (f, k)
    micro = Trainer(tr, init, port_data, trainer_config=two, workdir=str(tmp_path / 'mb'),
                    device='cpu', microbatch=64)
    micro.fit()
    losses = [r['loss'] for r in _records(str(tmp_path / 'mb')) if 'loss' in r]
    assert micro.state.step == 2 and len(losses) == 2 and np.isfinite(losses).all()
    # tier_warmup_steps is ported: a full-budget warm-up step beside a tiered
    # renderer, none beside an untiered one
    warm = TrainerConfig(tier_warmup_steps=5)
    assert Trainer(tr, init, port_data, trainer_config=warm, workdir=str(tmp_path / 'w0'),
                   device='cpu').warmup_step_fn is None
    tiered = dataclasses.replace(tr, tier_fraction=0.5, tier_samples=4)
    assert Trainer(tiered, init, port_data, trainer_config=warm, workdir=str(tmp_path / 'w1'),
                   device='cpu').warmup_step_fn is not None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='no CUDA device'):
            Trainer(tr, init, port_data, workdir=str(tmp_path / 'y'))
    assert degenerate_prediction(np.zeros(3), np.ones(3))
    assert not degenerate_prediction(np.ones(3), np.ones(3))


# ------------------------------------------------ spike guard and EMA vs JAX

def _tiny(n_rays=32):
    """tests/test_train.py's _tiny_setup, perturb off, the batch made with
    numpy: (JAX renderer, port renderer, numpy params, numpy batch)."""
    config = jax_emission_config(**SMALL)
    jr = JaxRenderer(field_apply=functools.partial(jax_nerf_apply, config),
                     head=JaxEmissionHead(), n_stratified=8, n_hierarchical=8, perturb=False)
    from sunerf_tpu_torch.models.fields import nerf_apply
    tr = Renderer(field_apply=functools.partial(nerf_apply, emission_config(**SMALL)),
                  head=EmissionHead(), n_stratified=8, n_hierarchical=8, perturb=False)
    k1, k2 = jax.random.split(jax.random.key(0))
    params = jax.tree.map(np.asarray, {'coarse': jax_init_nerf(k1, config),
                                       'fine': jax_init_nerf(k2, config)})
    rng = np.random.default_rng(42)
    rays_o = np.tile(np.array([[4.0, 0.0, 0.0]], np.float32), (n_rays, 1))
    dirs = np.array([[-1.0, 0.0, 0.0]]) + 0.1 * rng.normal(size=(n_rays, 3))
    rays_d = (dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)).astype(np.float32)
    batch = {'rays': np.stack([rays_o, rays_d], axis=1),
             'time': np.zeros((n_rays, 1), np.float32),
             'target_image': np.full((n_rays, 1), 0.05, np.float32)}
    return jr, tr, params, batch


class _Pair:
    """The JAX step and the port's step, stepped together on one batch."""

    def __init__(self, spike_guard=None, ema_decay=None):
        self.jr, self.tr, self.params, self.batch = _tiny()
        loss = dict(lambda_regularization=0.0)
        jopt = jax_make_optimizer(JaxOptimConfig(**OPTIM_KW))
        self.jstep = jax_make_train_step(self.jr, JaxLossConfig(**loss), jopt,
                                         spike_guard=spike_guard, ema_decay=ema_decay,
                                         donate=False)
        self.jstate = jax_create_train_state(jax.tree.map(jnp.asarray, self.params), jopt,
                                             spike_guard=spike_guard is not None,
                                             ema=ema_decay is not None)
        opt = make_optimizer(OptimConfig(**OPTIM_KW))
        self.step = make_train_step(self.tr, LossConfig(**loss), opt,
                                    spike_guard=spike_guard, ema_decay=ema_decay)
        self.state = create_train_state(params_from_numpy(self.params, 'cpu'), opt,
                                        spike_guard=spike_guard is not None,
                                        ema=ema_decay is not None)

    def __call__(self, target_shift=0.0):
        batch = dict(self.batch, target_image=self.batch['target_image'] + target_shift)
        self.jstate, jm = self.jstep(self.jstate, jax.tree.map(jnp.asarray, batch),
                                     jax.random.key(7))
        self.state, m = self.step(self.state, {k: torch.from_numpy(v) for k, v in batch.items()},
                                  0)
        return jm, m

    def port_params(self) -> dict:
        return {f: {k: v.detach().clone() for k, v in d.items()}
                for f, d in self.state.params.items()}

    def close_to_jax(self, rtol=1e-4):
        for f in ('coarse', 'fine'):
            for k, v in self.state.params[f].items():
                ref = np.asarray(self.jstate.params[f][k])
                assert np.max(np.abs(v.detach().numpy() - ref)) <= rtol * np.max(np.abs(ref)), (f, k)


def _same_params(a: dict, b: dict) -> bool:
    return all(torch.equal(a[f][k], b[f][k]) for f in a for k in a[f])


def test_spike_guard_skips_bad_update_like_jax():
    pair = _Pair(spike_guard=3.0)
    for _ in range(3):
        jm, m = pair()
        assert float(m['update_skipped']) == float(jm['update_skipped']) == 0.0
    np.testing.assert_allclose(float(pair.state.loss_ema), float(pair.jstate.loss_ema), rtol=1e-5)
    before = pair.port_params()
    ema = pair.state.loss_ema
    jm, m = pair(target_shift=1e3)
    assert float(m['update_skipped']) == float(jm['update_skipped']) == 1.0
    assert _same_params(before, pair.state.params)
    np.testing.assert_allclose(float(pair.state.loss_ema), float(ema) * 1.05, rtol=1e-6)
    np.testing.assert_allclose(float(pair.state.loss_ema), float(pair.jstate.loss_ema), rtol=1e-5)
    assert pair.state.step == int(pair.jstate.step) == 4
    assert pair.state.updates == 3
    jm, m = pair()
    assert float(m['update_skipped']) == float(jm['update_skipped']) == 0.0
    pair.close_to_jax()


def test_spike_guard_rolls_back_past_ramp_steps_like_jax():
    pair = _Pair(spike_guard=3.0)
    for _ in range(30):
        jm, m = pair()
    assert float(m['update_skipped']) == 0.0
    healthy = pair.port_params()
    jm, m = pair(target_shift=0.5)           # ~1.7x the EMA: applies, no refresh
    assert float(m['update_skipped']) == float(jm['update_skipped']) == 0.0
    assert not _same_params(healthy, pair.state.params)
    trips = pair.state.trip_count
    jm, m = pair(target_shift=3.0)           # ~4.7x: rolls back past the ramp step
    assert float(m['update_skipped']) == float(jm['update_skipped']) == 1.0
    assert _same_params(healthy, pair.state.params)
    assert pair.state.trip_count == trips + 1 == int(pair.jstate.trip_count)
    assert float(m['spike_trips']) == float(jm['spike_trips']) == trips + 1
    pair()
    assert pair.state.trip_count == trips + 1
    pair.close_to_jax()


def test_spike_guard_unlatches_like_jax():
    pair = _Pair(spike_guard=3.0)
    for _ in range(30):
        pair()
    latched = pair.port_params()
    jm, m = pair(target_shift=3.0)
    assert float(m['update_skipped']) == float(jm['update_skipped']) == 1.0
    streak = 0
    for _ in range(400):
        jm, m = pair(target_shift=3.0)
        assert float(m['update_skipped']) == float(jm['update_skipped'])
        streak = 0 if float(m['update_skipped']) else streak + 1
        if streak >= 3:
            break
    assert streak >= 3, 'guard stayed latched across 400 steps'
    assert not _same_params(latched, pair.state.params)
    np.testing.assert_allclose(float(pair.state.loss_ema), float(pair.jstate.loss_ema), rtol=1e-5)
    pair.close_to_jax()


def test_ema_params_exact_lerp_like_jax():
    pair = _Pair(ema_decay=0.9)
    prev = {f: {k: v.clone() for k, v in d.items()} for f, d in pair.state.ema_params.items()}
    for _ in range(2):
        pair()
        for f in ('coarse', 'fine'):
            for k, e in pair.state.ema_params[f].items():
                expect = 0.9 * prev[f][k] + 0.1 * pair.state.params[f][k].detach()
                torch.testing.assert_close(e, expect, rtol=1e-6, atol=1e-7)
                ref = np.asarray(pair.jstate.ema_params[f][k])
                assert np.max(np.abs(e.numpy() - ref)) <= 1e-5 * np.max(np.abs(ref)), (f, k)
        prev = {f: {k: v.clone() for k, v in d.items()} for f, d in pair.state.ema_params.items()}
    assert not _same_params(pair.state.ema_params, pair.port_params())


def test_checkpoint_restores_across_ema_settings(tmp_path):
    """tests/test_train.py:241-283 on the port's checkpoints."""
    _, tr, params, batch = _tiny()
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    opt = make_optimizer()
    tp = params_from_numpy(params, 'cpu')
    off = create_train_state(tp, opt)
    make_train_step(tr, LossConfig(), opt)(off, tb, 0)
    save_train_checkpoint(str(tmp_path / 'a'), off)
    restored = restore_train_checkpoint(str(tmp_path / 'a'), create_train_state(tp, opt, ema=True))
    assert restored.step == 1 and restored.ema_params is not None
    assert torch.equal(restored.ema_params['fine']['w_in'], off.params['fine']['w_in'].detach())

    on = create_train_state(tp, opt, ema=True)
    make_train_step(tr, LossConfig(), opt, ema_decay=0.9)(on, tb, 0)
    save_train_checkpoint(str(tmp_path / 'b'), on)
    restored = restore_train_checkpoint(str(tmp_path / 'b'), create_train_state(tp, opt))
    assert restored.step == 1 and restored.ema_params is None
    assert torch.equal(restored.params['fine']['w_in'], on.params['fine']['w_in'])
    restored = restore_train_checkpoint(str(tmp_path / 'b'),
                                        create_train_state(tp, opt, ema=True))
    assert torch.equal(restored.ema_params['fine']['w_in'], on.ema_params['fine']['w_in'])


def test_checkpoint_restores_across_guard_settings(tmp_path):
    """tests/test_train.py:297-333 on the port's checkpoints: the snapshot
    of a guard-on target restored from a guard-off checkpoint is a copy of
    the RESTORED state, and a guard-on checkpoint drops its guard state
    into a guard-off target."""
    _, tr, params, batch = _tiny()
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    opt = make_optimizer()
    tp = params_from_numpy(params, 'cpu')
    off = create_train_state(tp, opt)
    make_train_step(tr, LossConfig(), opt)(off, tb, 0)
    save_train_checkpoint(str(tmp_path / 'a'), off)
    restored = restore_train_checkpoint(str(tmp_path / 'a'),
                                        create_train_state(tp, opt, spike_guard=True))
    assert restored.step == 1 and restored.snapshot is not None
    assert torch.equal(restored.params['fine']['w_in'], off.params['fine']['w_in'])
    snap_w = restored.snapshot.params['fine']['w_in']
    assert torch.equal(snap_w, off.params['fine']['w_in'].detach())
    assert snap_w.data_ptr() != restored.params['fine']['w_in'].data_ptr()
    assert float(restored.loss_ema) == -1.0 and restored.snapshot.updates == 1

    gstep = make_train_step(tr, LossConfig(), opt, spike_guard=10.0)
    on = create_train_state(tp, opt, spike_guard=True)
    gstep(on, tb, 0)
    gstep(on, tb, 0)
    save_train_checkpoint(str(tmp_path / 'b'), on)
    restored = restore_train_checkpoint(str(tmp_path / 'b'), create_train_state(tp, opt))
    assert restored.step == 2 and restored.snapshot is None and restored.trip_count is None
    assert torch.equal(restored.params['fine']['w_in'], on.params['fine']['w_in'])
    again = restore_train_checkpoint(str(tmp_path / 'b'),
                                     create_train_state(tp, opt, spike_guard=True))
    assert float(again.loss_ema) == float(on.loss_ema) and again.trip_count == on.trip_count
    assert torch.equal(again.snapshot.params['fine']['w_in'], on.snapshot.params['fine']['w_in'])
    # the restored state trains on
    gstep(again, tb, 0)
    assert again.step == 3


def _reordered(tree):
    """The nested dict with its keys in reverse order at every level."""
    if isinstance(tree, dict):
        return {k: _reordered(tree[k]) for k in reversed(list(tree))}
    return tree


def test_checkpoint_restores_by_key_whatever_the_order(tmp_path):
    """A checkpoint of a state whose dicts hold their keys in one order
    restores into a state whose dicts hold them in reverse (on a 2-layer
    field b_in [H] would otherwise land in b_h [1, H] by broadcasting):
    every parameter, the snapshot, the EMA average and each parameter's
    Adam moments come back under their own key, bit for bit, and the two
    states then take the same step. A checkpoint whose Adam moment does
    not fit its parameter is refused."""
    _, tr, params, batch = _tiny()
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    opt = make_optimizer(OptimConfig(**OPTIM_KW))
    tp = params_from_numpy(params, 'cpu')
    step = make_train_step(tr, LossConfig(), opt, spike_guard=10.0, ema_decay=0.9)
    saved = create_train_state(tp, opt, spike_guard=True, ema=True)
    for _ in range(3):
        step(saved, tb, 0)
    save_train_checkpoint(str(tmp_path), saved)

    target = create_train_state(_reordered(tp), opt, spike_guard=True, ema=True)
    assert list(target.params['fine']) != list(saved.params['fine'])
    restore_train_checkpoint(str(tmp_path), target)
    moments = lambda s: {id(p): st for p, st in s.opt_state.state.items()}  # noqa: E731
    got, want = moments(target), moments(saved)
    for f in saved.params:
        for k in saved.params[f]:
            assert torch.equal(target.params[f][k], saved.params[f][k]), (f, k)
            assert torch.equal(target.ema_params[f][k], saved.ema_params[f][k]), (f, k)
            assert torch.equal(target.snapshot.params[f][k], saved.snapshot.params[f][k]), (f, k)
            a, b = got[id(target.params[f][k])], want[id(saved.params[f][k])]
            for m in ('exp_avg', 'exp_avg_sq', 'step'):
                assert torch.equal(a[m], b[m]), (f, k, m)
    assert target.step == saved.step and target.updates == saved.updates
    step(saved, tb, 0)
    step(target, tb, 0)
    for f in saved.params:
        for k in saved.params[f]:
            torch.testing.assert_close(target.params[f][k], saved.params[f][k],
                                       rtol=1e-6, atol=0.0)

    blob = torch.load(latest_checkpoint(str(tmp_path)), weights_only=True)
    blob['adam']['fine/b_in'], blob['adam']['fine/b_h'] = (blob['adam']['fine/b_h'],
                                                           blob['adam']['fine/b_in'])
    torch.save(blob, latest_checkpoint(str(tmp_path)))
    with pytest.raises(ValueError, match='fine/b_'):
        restore_train_checkpoint(str(tmp_path), create_train_state(tp, opt))


def test_step_refuses_what_is_not_ported(tmp_path):
    """donate=True raises. mesh and microbatch, which raised here before,
    run: with the spike guard and EMA, microbatch 8 on a one-rank mesh (gloo
    in this process) gives the bits of microbatch 8 without it."""
    _, tr, params, batch = _tiny()
    opt = make_optimizer()
    with pytest.raises(NotImplementedError, match='in place'):
        make_train_step(tr, LossConfig(), opt, donate=True)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}

    def one_step(**kw):
        st = create_train_state(params_from_numpy(params, 'cpu'), opt, spike_guard=True,
                                ema=True)
        return make_train_step(tr, LossConfig(), opt, microbatch=8, spike_guard=3.0,
                               ema_decay=0.9, **kw)(st, tb, 0)

    alone, m_alone = one_step()
    mesh = make_mesh(devices=['cpu'], init_method=f'file://{tmp_path}/store', rank=0,
                     world_size=1, timeout=timedelta(seconds=60))
    try:
        meshed, m_mesh = one_step(mesh=mesh)
    finally:
        torch.distributed.destroy_process_group()
    for k, v in m_alone.items():
        assert torch.equal(m_mesh[k], v), k
    for tree in ('params', 'ema_params'):
        for f, sub in getattr(alone, tree).items():
            for k, v in sub.items():
                assert torch.equal(getattr(meshed, tree)[f][k], v), (tree, f, k)
    state = create_train_state(params_from_numpy(params, 'cpu'), opt)
    for kw, match in ((dict(spike_guard=3.0), 'spike_guard=True'), (dict(ema_decay=0.9), 'ema=True')):
        with pytest.raises(ValueError, match=match):
            make_train_step(tr, LossConfig(), opt, **kw)(state, tb, 0)
