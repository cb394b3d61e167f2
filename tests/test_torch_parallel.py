"""The port's data parallelism (sunerf_tpu_torch/parallel/mesh.py, the mesh
and microbatch paths of train/step.py, train/loop.py and
evaluation/loader.py) against the JAX package on the CPU.

JAX runs a 2-device mesh of the 8 virtual CPU devices (tests/conftest.py);
the port runs two ranks over gloo on the CPU. The field is
tests/test_sharding.py's: a 2x32 emission field for both passes, 8 + 8
samples, perturb off. Tolerances are tests/test_microbatch.py's: loss rtol
1e-5, parameters after Adam rtol 5e-3 and atol 1e-5 (the reductions
reassociate across shards and chunks); renders against the single-device
render rtol 1e-5, atol 1e-7. The tiled frame against JAX's is held within
1e-4 of max, the cross-package render tolerance of
tests/test_torch_trainer.py (one pixel of 256 differed by 1.05e-5 relative),
at a close observer (float32 renders at 1 AU are ill-conditioned).

The two ranks are one process group that runs every multi-rank case:
a script written to the test's directory, started with subprocess (so a
child imports neither jax nor the JAX package, nor this file), with one
torch thread, the default SIGTERM, a 60 s collective timeout and a
deadline after which the parent kills both and fails. The parent computes
JAX's side and the port's single-process references while they run.
"""
import functools
import json
import os
import signal
import subprocess
import sys
import time
from datetime import timedelta
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from sunerf_tpu.evaluation.loader import ModelLoader as JaxModelLoader
from sunerf_tpu.models.fields import emission_config as jax_emission_config
from sunerf_tpu.models.fields import init_nerf as jax_init_nerf
from sunerf_tpu.models.fields import nerf_apply as jax_nerf_apply
from sunerf_tpu.parallel import mesh as jax_mesh
from sunerf_tpu.rendering.emission import EmissionHead as JaxEmissionHead
from sunerf_tpu.rendering.renderer import Renderer as JaxRenderer
from sunerf_tpu.train.objective import LossConfig as JaxLossConfig
from sunerf_tpu.train.optim import make_optimizer as jax_make_optimizer
from sunerf_tpu.train.step import create_train_state as jax_create_train_state
from sunerf_tpu.train.step import make_eval_step as jax_make_eval_step
from sunerf_tpu.train.step import make_train_step as jax_make_train_step
from sunerf_tpu_torch.data.datasets import ArrayDataset
from sunerf_tpu_torch.evaluation.loader import ModelLoader
from sunerf_tpu_torch.models.fields import emission_config, nerf_apply, params_from_numpy
from sunerf_tpu_torch.parallel import mesh as port_mesh
from sunerf_tpu_torch.rendering.emission import EmissionHead
from sunerf_tpu_torch.rendering.renderer import Renderer
from sunerf_tpu_torch.train.objective import LossConfig
from sunerf_tpu_torch.train.optim import make_optimizer
from sunerf_tpu_torch.train.step import create_train_state, make_eval_step, make_train_step

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
WORLD = 2
N_RAYS = 64
SEED = 11
MICRO = 8                  # the two-rank microbatch: 4 chunks a rank
VIEW = (0.1, 0.5, 0.0, 4.0)
TIER = (0.5, 4)
DEADLINE_S = 100.0
LOSS_RTOL = 1e-5
PARAM_TOL = dict(rtol=5e-3, atol=1e-5)
RENDER_TOL = dict(rtol=1e-5, atol=1e-7)
CROSS_RENDER_TOL = 1e-4     # of max, the tiled frame against JAX's
KEYS = ('w_in', 'b_in', 'w_h', 'b_h', 'w_out', 'b_out')

# one rank of the group: every multi-rank case, its results to rank<r>.npz
RANK_SCRIPT = r'''
import functools, json, os, signal, sys
signal.signal(signal.SIGTERM, signal.SIG_DFL)
from datetime import timedelta
import numpy as np
import torch
torch.set_num_threads(1)
from sunerf_tpu_torch.core.occupancy import OccupancyConfig
from sunerf_tpu_torch.data.datasets import ArrayDataset, MmapDataset
from sunerf_tpu_torch.data.loaders import RayData
from sunerf_tpu_torch.evaluation.loader import ModelLoader
from sunerf_tpu_torch.models.fields import emission_config, nerf_apply, params_from_numpy
from sunerf_tpu_torch.parallel.mesh import (ShardedRows, build_on_rank0, make_mesh, replicate,
                                            shard_batch, global_batch_size)
from sunerf_tpu_torch.rendering.emission import EmissionHead
from sunerf_tpu_torch.rendering.renderer import Renderer
from sunerf_tpu_torch.train import loop
from sunerf_tpu_torch.train.objective import LossConfig
from sunerf_tpu_torch.train.optim import make_optimizer
from sunerf_tpu_torch.train.step import create_train_state, make_eval_step, make_train_step

rank, world, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
mesh = make_mesh(devices=['cpu'] * world, init_method='file://' + os.path.join(tmp, 'store'),
                 rank=rank, world_size=world, timeout=timedelta(seconds=60))
inputs = dict(np.load(os.path.join(tmp, 'inputs.npz')))
meta = json.loads(open(os.path.join(tmp, 'meta.json')).read())
cfg = emission_config(n_layers=2, d_filter=32)
renderer = Renderer(field_apply=functools.partial(nerf_apply, cfg), head=EmissionHead(),
                    n_stratified=8, n_hierarchical=8, perturb=False)
params_np = {f: {k: inputs[f'{f}/{k}'] for k in meta['keys']} for f in ('coarse', 'fine')}
params = params_from_numpy(params_np, 'cpu')
n = meta['n_rays']
batch_np = {k: inputs[k][:n] for k in ('rays', 'time', 'target_image')}
batch = {k: torch.from_numpy(v) for k, v in batch_np.items()}
out = {'mesh': np.array([mesh.rank, mesh.size, global_batch_size(3, mesh)]),
       'shard/rays': shard_batch(mesh, batch_np)['rays']}
opt = make_optimizer()

# the data built once, on rank 0: every rank maps its shards, reading its rows
def build():
    paths = {k: os.path.join(tmp, f'shard_{k}.npy') for k in ('rays', 'time', 'target_image')}
    for k, path in paths.items():
        np.save(path, inputs[k])
    return RayData(train=MmapDataset(paths, batch_size=64),
                   valid=ArrayDataset({k: inputs[k][:8] for k in paths}, batch_size=8),
                   config={'built_by': rank}, ref_time=None)
shared = build_on_rank0(mesh, build)
out['shared/built_by'] = np.array([shared.config['built_by']])
out['shared/files'] = np.array(json.dumps(shared.train.batch_files))
rows = ShardedRows(mesh, shared.train)
out['shared/rays'] = np.concatenate([rows[i]['rays'] for i in range(len(rows))])

def flat(tree):
    return np.concatenate([tree[f][k].detach().numpy().ravel()
                           for f in ('coarse', 'fine') for k in meta['keys']])

for name, kw in (('step', dict(spike_guard=3.0, ema_decay=0.9)),
                 ('micro', dict(microbatch=meta['micro']))):
    state = create_train_state(params, opt, spike_guard='spike_guard' in kw,
                               ema='ema_decay' in kw)
    if rank:   # replicate must put rank 0's state back
        with torch.no_grad():
            for f in state.params.values():
                for t in f.values():
                    t.add_(1.0)
        state.step, state.updates = 5, 5
    replicate(mesh, state)
    out[f'{name}/replicated'] = flat(state.params)
    step = make_train_step(renderer, LossConfig(), opt, mesh=mesh, **kw)
    state, metrics = step(state, shard_batch(mesh, batch), meta['seed'])
    out[f'{name}/loss'] = np.array([float(metrics['loss']), state.step, state.updates])
    out[f'{name}/params'] = flat(state.params)
    if state.ema_params is not None:
        out[f'{name}/ema'] = flat(state.ema_params)

out['eval/image'] = make_eval_step(renderer, mesh=mesh)(
    params, shard_batch(mesh, batch))['image'].numpy()
view = meta['view']
out['loader/image'] = ModelLoader(renderer, params, batch_size=128, mesh=mesh, device='cpu') \
    .render_observer_image(*view, resolution=16).image
out['tier/image'] = ModelLoader(renderer, params, batch_size=128, mesh=mesh, device='cpu',
                                tier=tuple(meta['tier'])) \
    .render_observer_image(*view, resolution=16).image

# the Trainer: who writes what
writes = []
import matplotlib.figure
savefig = matplotlib.figure.Figure.savefig
def spy_savefig(self, fname, *a, **k):
    writes.append(os.path.basename(str(fname)))
    return savefig(self, fname, *a, **k)
matplotlib.figure.Figure.savefig = spy_savefig
for fn in ('save_state', 'save_train_checkpoint', 'MetricsLogger'):
    def spy(*a, _inner=getattr(loop, fn), _name=fn, **k):
        writes.append(_name)
        return _inner(*a, **k)
    setattr(loop, fn, spy)
big = {k: inputs[k] for k in ('rays', 'time', 'target_image')}
poses = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))
poses[:, 0, 3] = [4.0, 0.0, -4.0]
data = RayData(train=ArrayDataset(big, batch_size=64),
               valid=ArrayDataset({k: v[:64] for k, v in big.items()}, batch_size=64),
               config={'type': 'emission'}, ref_time=None, validation_shape=(8, 8),
               extras={'overview': {'poses': poses,
                                    'times': np.asarray([0.0, 0.5, 1.0], np.float32),
                                    'images': [np.ones((8, 8), np.float32)] * 2}})
# with an occupancy grid updated every step: the same jitter on each rank
occ = OccupancyConfig(nr=8, ntheta=4, nphi=8, warmup=1, update_every=1)
trainer = loop.Trainer(Renderer(field_apply=functools.partial(nerf_apply, cfg),
                                head=EmissionHead(), n_stratified=8, n_hierarchical=8,
                                perturb=False, occupancy=occ), params_np, data,
                       loss_config=LossConfig(lambda_regularization=0.0),
                       trainer_config=loop.TrainerConfig(total_steps=2, val_every=10,
                                                         checkpoint_every=10, log_every=1),
                       workdir=os.path.join(tmp, 'run'), mesh=mesh, microbatch=16,
                       device='cpu')
vals = []
validate = trainer.validate
trainer.validate = lambda step: (vals.append(validate(step)), vals[-1])[1]
trainer.fit()
out['trainer/params'] = flat(trainer.state.params)
out['trainer/val0'] = np.array([vals[0]['val_psnr'], vals[0]['val_ssim'], vals[0]['val_loss']])
out['trainer/step'] = np.array([trainer.state.step])
out['trainer/occupancy'] = np.concatenate(
    [g.numpy().ravel() for g in trainer.state.params['occupancy'].values()])

# SIGTERM on rank 1 after its second step stops both ranks there
pre = loop.Trainer(renderer, params_np, data, loss_config=LossConfig(lambda_regularization=0.0),
                   trainer_config=loop.TrainerConfig(total_steps=6, val_every=100,
                                                     checkpoint_every=100, log_every=1,
                                                     save_val_images=False),
                   workdir=os.path.join(tmp, 'preempt'), mesh=mesh, device='cpu')
inner = pre.step_fn
def step_then_signal(state, b, seed):
    result = inner(state, b, seed)
    if rank == 1 and state.step == 2:
        os.kill(os.getpid(), signal.SIGTERM)
    return result
pre.step_fn = step_then_signal
pre.fit()
out['preempt/step'] = np.array([pre.state.step])
out['writes'] = np.array(json.dumps(writes))
out['jax_imported'] = np.array([any(m == 'jax' or m.startswith(('jax.', 'sunerf_tpu.'))
                                    or m == 'sunerf_tpu' for m in sys.modules)])
np.savez(os.path.join(tmp, f'rank{rank}.npz'), **out)
torch.distributed.destroy_process_group()
'''


def _config():
    return jax_emission_config(n_layers=2, d_filter=32)


def _inputs(n_rays: int) -> tuple:
    """tests/test_sharding.py's field (JAX's init from key 0) and batch,
    its directions drawn with numpy from a seed."""
    k1, k2 = jax.random.split(jax.random.key(0))
    params = jax.tree.map(np.asarray, {'coarse': jax_init_nerf(k1, _config()),
                                       'fine': jax_init_nerf(k2, _config())})
    rng = np.random.default_rng(5)
    rays_o = np.tile(np.array([[4.0, 0.0, 0.0]], np.float32), (n_rays, 1))
    dirs = np.array([[-1.0, 0.0, 0.0]]) + 0.1 * rng.normal(size=(n_rays, 3))
    rays_d = (dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)).astype(np.float32)
    batch = {'rays': np.stack([rays_o, rays_d], axis=1),
             'time': np.zeros((n_rays, 1), np.float32),
             'target_image': np.full((n_rays, 1), 0.05, np.float32)}
    return params, batch


def _jax_renderer(**kw):
    return JaxRenderer(field_apply=functools.partial(jax_nerf_apply, _config()),
                       head=JaxEmissionHead(), n_stratified=8, n_hierarchical=8,
                       perturb=False, **kw)


def _port_renderer(**kw):
    return Renderer(field_apply=functools.partial(nerf_apply, emission_config(n_layers=2,
                                                                               d_filter=32)),
                    head=EmissionHead(), n_stratified=8, n_hierarchical=8, perturb=False,
                    **kw)


def _flat(tree) -> np.ndarray:
    return np.concatenate([np.asarray(tree[f][k]).ravel()
                           for f in ('coarse', 'fine') for k in KEYS])


def _jax_step(params, batch, mesh=None, **kw):
    opt = jax_make_optimizer()
    step = jax_make_train_step(_jax_renderer(), JaxLossConfig(), opt, mesh=mesh,
                               donate=False, **kw)
    state = jax_create_train_state(params, opt, spike_guard='spike_guard' in kw,
                                   ema='ema_decay' in kw)
    if mesh is not None:
        state = jax_mesh.replicate(mesh, state)
        batch = jax_mesh.shard_batch(mesh, batch)
    state, metrics = step(state, batch, jax.random.key(SEED))
    return float(metrics['loss']), state


def _port_step(params, batch, **kw):
    opt = make_optimizer()
    state = create_train_state(params_from_numpy(params, 'cpu'), opt,
                               spike_guard='spike_guard' in kw, ema='ema_decay' in kw)
    step = make_train_step(_port_renderer(), LossConfig(), opt, **kw)
    state, metrics = step(state, {k: torch.from_numpy(v) for k, v in batch.items()}, SEED)
    return float(metrics['loss']), state


def _detached(tree) -> dict:
    return {f: {k: v.detach().numpy() for k, v in sub.items()} for f, sub in tree.items()}


@pytest.fixture(scope='module')
def ranks(tmp_path_factory):
    """Both ranks' results, beside the JAX and single-process references
    computed while they run."""
    tmp = tmp_path_factory.mktemp('ranks')
    params, batch = _inputs(2 * N_RAYS)
    flat = {f'{f}/{k}': v for f, sub in params.items() for k, v in sub.items()}
    np.savez(tmp / 'inputs.npz', **flat, **batch)
    (tmp / 'meta.json').write_text(json.dumps({'keys': KEYS, 'n_rays': N_RAYS, 'seed': SEED,
                                              'micro': MICRO, 'view': VIEW, 'tier': TIER}))
    (tmp / 'rank.py').write_text(RANK_SCRIPT)
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS='1')
    for k in ('RANK', 'WORLD_SIZE', 'LOCAL_RANK', 'MASTER_ADDR', 'MASTER_PORT'):
        env.pop(k, None)
    procs = [subprocess.Popen([sys.executable, str(tmp / 'rank.py'), str(r), str(WORLD),
                               str(tmp)], cwd=str(tmp), env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
    start = time.monotonic()
    try:
        batch64 = {k: v[:N_RAYS] for k, v in batch.items()}
        mesh2 = jax_mesh.make_mesh(jax.devices()[:WORLD])
        refs = {'params': params, 'batch': batch64}
        refs['jax_step'] = _jax_step(params, batch64, mesh2, spike_guard=3.0, ema_decay=0.9)
        refs['jax_micro'] = _jax_step(params, batch64, mesh2, microbatch=MICRO)
        refs['port_step'] = _port_step(params, batch64, spike_guard=3.0, ema_decay=0.9)
        refs['port_micro'] = _port_step(params, batch64, microbatch=MICRO)
        sharded = jax_make_eval_step(_jax_renderer(), mesh=mesh2)
        refs['jax_eval'] = np.asarray(sharded(jax_mesh.replicate(mesh2, params),
                                              jax_mesh.shard_batch(mesh2, batch64))['image'])
        shards = jax_mesh.shard_batch(mesh2, batch64)['rays'].addressable_shards
        refs['jax_shards'] = [np.asarray(s.data) for s in
                              sorted(shards, key=lambda s: s.index[0].start)]
        refs['jax_loader'] = JaxModelLoader(_jax_renderer(), params, batch_size=128,
                                            mesh=mesh2).render_observer_image(
            *VIEW, resolution=16).image
        outs = []
        for p in procs:
            left = DEADLINE_S - (time.monotonic() - start)
            try:
                outs.append(p.communicate(timeout=max(left, 1.0))[0])
            except subprocess.TimeoutExpired:
                pytest.fail(f'a rank did not finish within {DEADLINE_S} s')
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, text) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f'rank {r} exited {p.returncode}:\n{text[-4000:]}'
    results = [dict(np.load(tmp / f'rank{r}.npz')) for r in range(WORLD)]
    return results, refs, tmp


def test_mesh_and_shard_batch_rows(ranks):
    results, refs, _ = ranks
    for r, res in enumerate(results):
        np.testing.assert_array_equal(res['mesh'], [r, WORLD, 3 * WORLD])
        # this rank's rows are the rows JAX's NamedSharding puts on device r
        np.testing.assert_array_equal(res['shard/rays'], refs['jax_shards'][r])
        assert not res['jax_imported'][0]
    with pytest.raises(ValueError, match='multiple of the mesh size'):
        port_mesh.shard_batch(port_mesh.Mesh(0, WORLD, torch.device('cpu'), 'gloo'),
                              {'rays': np.zeros((5, 2, 3))})
    assert port_mesh.global_batch_size(1024) == 1024


def test_data_built_once_and_read_by_rows(ranks):
    """build_on_rank0 runs the build on rank 0 alone; rank 1 gets its
    result with the shards mapped from the same files, and ShardedRows
    reads each rank's rows of every 64-row batch, the rows shard_batch
    keeps."""
    results, refs, tmp = ranks
    _, batch = _inputs(2 * N_RAYS)
    files = [json.loads(str(res['shared/files'])) for res in results]
    assert files[0] == files[1]
    for r, res in enumerate(results):
        assert res['shared/built_by'][0] == 0
        want = np.concatenate([batch['rays'][i * 64 + r * 32:i * 64 + (r + 1) * 32]
                               for i in range(2)])
        np.testing.assert_array_equal(res['shared/rays'], want)
    mesh = port_mesh.Mesh(0, WORLD, torch.device('cpu'), 'gloo')
    # a ragged last batch of 31 rows does not divide over two ranks
    ragged = port_mesh.ShardedRows(mesh, ArrayDataset({k: v[:95] for k, v in batch.items()},
                                                      batch_size=64))
    np.testing.assert_array_equal(ragged[0]['rays'], batch['rays'][:32])
    with pytest.raises(ValueError, match='multiple of the mesh size'):
        ragged[1]


def test_two_rank_step_matches_jax_mesh_and_the_whole_batch(ranks):
    """The two-rank step (spike guard and EMA on) against JAX's 2-device
    mesh step and the port's single-process step on the whole batch;
    replicate puts rank 0's state on rank 1 first."""
    results, refs, _ = ranks
    j_loss, j_state = refs['jax_step']
    p_loss, p_state = refs['port_step']
    for res in results:
        np.testing.assert_array_equal(res['step/replicated'], _flat(refs['params']))
        loss, step, updates = res['step/loss']
        assert (step, updates) == (1, 1)
        for ref_loss, ref_params, ref_ema in (
                (j_loss, j_state.params, j_state.ema_params),
                (p_loss, _detached(p_state.params), _detached(p_state.ema_params))):
            np.testing.assert_allclose(loss, ref_loss, rtol=LOSS_RTOL)
            np.testing.assert_allclose(res['step/params'], _flat(ref_params), **PARAM_TOL)
            np.testing.assert_allclose(res['step/ema'], _flat(ref_ema), **PARAM_TOL)
    # the update ran alike on both ranks
    np.testing.assert_array_equal(results[0]['step/params'], results[1]['step/params'])


def test_two_rank_microbatch_matches_jax_and_one_rank(ranks):
    """Microbatch inside the two-rank mesh: finite, and within the
    tolerances of the one-rank microbatched step on the whole batch and of
    JAX's microbatched 2-device step."""
    results, refs, _ = ranks
    for res in results:
        assert np.isfinite(res['micro/loss'][0]) and np.isfinite(res['micro/params']).all()
        for ref_loss, ref_params in ((refs['jax_micro'][0], refs['jax_micro'][1].params),
                                     (refs['port_micro'][0],
                                      _detached(refs['port_micro'][1].params))):
            np.testing.assert_allclose(res['micro/loss'][0], ref_loss, rtol=LOSS_RTOL)
            np.testing.assert_allclose(res['micro/params'], _flat(ref_params), **PARAM_TOL)


def test_sharded_eval_and_tiled_loader(ranks):
    """The eval step and ModelLoader(mesh=...) over two ranks against JAX's
    2-device mesh and the single-device render; with tiers each rank ranks
    its own 64 rows of a 128-ray chunk, which is the single-device tiered
    render at batch_size 64."""
    results, refs, _ = ranks
    params = params_from_numpy(refs['params'], 'cpu')
    batch = {k: torch.from_numpy(v) for k, v in refs['batch'].items()}
    single = make_eval_step(_port_renderer())(params, batch)['image'].numpy()
    loader = ModelLoader(_port_renderer(), params, batch_size=128, device='cpu')
    frame = loader.render_observer_image(*VIEW, resolution=16).image
    tiered = ModelLoader(_port_renderer(), params, batch_size=64, device='cpu',
                         tier=TIER).render_observer_image(*VIEW, resolution=16).image
    for res in results:
        np.testing.assert_allclose(res['eval/image'], refs['jax_eval'], **RENDER_TOL)
        np.testing.assert_allclose(res['eval/image'], single, **RENDER_TOL)
        jax_frame = refs['jax_loader']
        assert np.abs(res['loader/image'] - jax_frame).max() <= \
            CROSS_RENDER_TOL * np.abs(jax_frame).max()
        np.testing.assert_allclose(res['loader/image'], frame, **RENDER_TOL)
        assert np.isfinite(res['tier/image']).all()
        np.testing.assert_allclose(res['tier/image'], tiered, **RENDER_TOL)
    with pytest.raises(ValueError, match='divide by the mesh size'):
        ModelLoader(_port_renderer(), params, batch_size=127, device='cpu',
                    mesh=port_mesh.Mesh(0, WORLD, torch.device('cpu'), 'gloo'))
    with pytest.raises(ValueError, match="not the mesh's"):
        ModelLoader(_port_renderer(), params, batch_size=128,
                    mesh=port_mesh.Mesh(0, WORLD, torch.device('cpu'), 'gloo'))


def test_two_rank_trainer_writes_on_rank_0(ranks):
    """The Trainer on two ranks for 2 steps (microbatch 16, the occupancy
    grid updated each step): the step-0 sanity validation, the same
    validation numbers, parameters and grid on both ranks, and only rank 0
    writing metrics.jsonl, the images and the
    checkpoint and bundle; a SIGTERM on rank 1 stops both ranks at its step
    and rank 0 checkpoints there."""
    results, _, tmp = ranks
    workdir = tmp / 'run'
    recs = [json.loads(line) for line in open(workdir / 'metrics.jsonl')]
    assert [r['step'] for r in recs if 'val_psnr' in r] == [0]
    assert [r['step'] for r in recs if 'loss' in r] == [1, 2]
    for name in ('overview.jpg', 'ray_sampling.jpg', 'val_00000000_ch0.jpg',
                 'save_state.npz', 'checkpoints/step_00000002.pt'):
        assert (workdir / name).exists(), name
    writes = [json.loads(str(res['writes'])) for res in results]
    assert writes[1] == []
    assert {'MetricsLogger', 'save_state', 'save_train_checkpoint', 'overview.jpg',
            'ray_sampling.jpg', 'val_00000000_ch0.jpg'} <= set(writes[0])
    for k in ('trainer/params', 'trainer/val0', 'trainer/step', 'trainer/occupancy'):
        np.testing.assert_array_equal(results[0][k], results[1][k])
    assert results[0]['trainer/step'][0] == 2 and np.isfinite(results[0]['trainer/val0']).all()
    assert [res['preempt/step'][0] for res in results] == [2, 2]
    assert (tmp / 'preempt' / 'checkpoints' / 'step_00000002.pt').exists()
    assert any(json.loads(line).get('preempted') == 1.0
               for line in open(tmp / 'preempt' / 'metrics.jsonl'))


@pytest.mark.parametrize('microbatch', [16, 24])
def test_microbatched_step_matches_jax(microbatch):
    """One rank, microbatch 16 (4 chunks of 64 rays) and 24 (2 chunks, 16
    rows dropped on both sides) against JAX's microbatched step."""
    params, batch = _inputs(N_RAYS)
    j_loss, j_state = _jax_step(params, batch, microbatch=microbatch)
    p_loss, p_state = _port_step(params, batch, microbatch=microbatch)
    np.testing.assert_allclose(p_loss, j_loss, rtol=LOSS_RTOL)
    np.testing.assert_allclose(_flat(_detached(p_state.params)), _flat(j_state.params),
                               **PARAM_TOL)
    if microbatch == 16:   # per-chunk mean of means == the full batch's mean
        f_loss, f_state = _port_step(params, batch)
        np.testing.assert_allclose(p_loss, f_loss, rtol=LOSS_RTOL)
        np.testing.assert_allclose(_flat(_detached(p_state.params)),
                                   _flat(_detached(f_state.params)), **PARAM_TOL)
    else:   # the dropped rows take no part: the step on the first 48 rows
        d_loss, _ = _port_step(params, {k: v[:48] for k, v in batch.items()},
                               microbatch=microbatch)
        assert p_loss == d_loss
    with pytest.raises(ValueError, match='smaller than microbatch'):
        _port_step(params, {k: v[:8] for k, v in batch.items()}, microbatch=microbatch)


def test_initialize_multihost_explicit_args_raise(monkeypatch):
    def boom(*args, **kwargs):
        raise ValueError('coordinator unreachable')

    monkeypatch.setattr(torch.distributed, 'init_process_group', boom)
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match='explicit coordinator args'):
        port_mesh.initialize_multihost(coordinator_address='10.0.0.1:1234',
                                       num_processes=4, process_id=0)


def test_initialize_multihost_autodetect_warns(monkeypatch):
    def boom(*args, **kwargs):
        raise ValueError('no MASTER_ADDR')

    monkeypatch.setattr(torch.distributed, 'init_process_group', boom)
    with pytest.warns(RuntimeWarning, match='continuing in one process'):
        port_mesh.initialize_multihost()


def test_initialize_multihost_success_path(monkeypatch):
    seen = {}

    def fake_init(backend, **kwargs):
        seen.update(kwargs, backend=backend)

    monkeypatch.setattr(torch.distributed, 'init_process_group', fake_init)
    port_mesh.initialize_multihost(coordinator_address='host:99', num_processes=2,
                                   process_id=1)
    assert seen == {'backend': 'nccl', 'init_method': 'tcp://host:99', 'world_size': 2,
                    'rank': 1}


def test_mesh_defaults_to_the_card(monkeypatch, tmp_path):
    """A mesh asked for a card on a host without one raises before it joins
    a group; it never falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip('this host has a card')
    for k in ('RANK', 'WORLD_SIZE', 'LOCAL_RANK'):
        monkeypatch.delenv(k, raising=False)
    store = 'file://' + str(tmp_path / 'store')
    with pytest.raises(RuntimeError, match='which this machine lacks'):
        port_mesh.make_mesh()
    with pytest.raises(RuntimeError, match='which this machine lacks'):
        port_mesh.make_mesh(devices=['cuda'], init_method=store, rank=0, world_size=1)
    # the backend follows from the devices: NCCL only where each rank has a card
    cuda = functools.partial(torch.device, 'cuda')
    assert port_mesh._default_backend(None) == 'nccl'
    assert port_mesh._default_backend([cuda(0), cuda(1)]) == 'nccl'
    assert port_mesh._default_backend([cuda(0), cuda(0)]) == 'gloo'
    assert port_mesh._default_backend([torch.device('cpu')]) == 'gloo'
    with pytest.raises(ValueError, match='2 devices for a world of 1'):
        port_mesh.make_mesh(devices=['cpu', 'cpu'], init_method=store, rank=0, world_size=1)
    assert not torch.distributed.is_initialized()
