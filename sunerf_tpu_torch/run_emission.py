"""Emission SuNeRF training CLI (sunerf_tpu/run_emission.py).

Usage: python -m sunerf_tpu_torch.run_emission --config config/emission.yaml
       [--device cuda|cpu]
       torchrun --nproc-per-node N -m sunerf_tpu_torch.run_emission --config ...

Config sections (YAML): data, training, logging, model, rendering,
optimizer, image_scaling — the JAX CLI's layout and defaults. The card
unless --device cpu is given. rendering.tier_fraction / tier_samples and
rendering.occupancy go to the system factory as in the JAX CLI;
training.tier_warmup_steps and training.microbatch to the Trainer.

Launched by torchrun (WORLD_SIZE in the environment) the run is data
parallel over a mesh of WORLD_SIZE ranks (parallel/mesh.py; the JAX CLI
makes one when it sees more than one device): rank r trains on
cuda:LOCAL_RANK over NCCL (--device cpu or cuda:N puts every rank there,
over gloo), data.batch_size is the per-rank batch, rank 0 builds the data
shards and writes the workdir, and every rank maps the same shards and
reads its own rows of each batch.
"""
from __future__ import annotations

import argparse
import contextlib
import os
from datetime import datetime

import torch.distributed as dist

from sunerf_tpu_torch.data.loaders import build_single_channel_data
from sunerf_tpu_torch.models.fields import emission_config
from sunerf_tpu_torch.parallel.mesh import build_on_rank0, make_mesh
from sunerf_tpu_torch.systems import make_emission_system
from sunerf_tpu_torch.train.loop import Trainer, TrainerConfig
from sunerf_tpu_torch.train.objective import LossConfig
from sunerf_tpu_torch.train.optim import OptimConfig
from sunerf_tpu_torch.utils.logging import MetricsLogger


def parse_config(path: str) -> dict:
    import yaml
    with open(path) as f:
        return yaml.safe_load(f)


@contextlib.contextmanager
def launched_mesh(device: str):
    """The mesh of a run launched by torchrun (WORLD_SIZE in the
    environment), else None. device 'cuda' places rank r on
    cuda:LOCAL_RANK; any other ('cpu', 'cuda:0') holds every rank. The
    process group this made is destroyed on exit."""
    if 'WORLD_SIZE' not in os.environ:
        yield None
        return
    owned = not dist.is_initialized()
    world = int(os.environ['WORLD_SIZE'])
    mesh = make_mesh(devices=None if device == 'cuda' else [device] * world)
    try:
        yield mesh
    finally:
        if owned:
            dist.destroy_process_group()


def run_paths(config: dict) -> tuple:
    """(workdir, working_dir): the run's output directory and its data
    shards' directory."""
    workdir = config.get('path_to_save', config.get('workdir', './workdir'))
    return workdir, config.get('work_directory', workdir + '/batches')


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--config', type=str, required=True)
    parser.add_argument('--device', type=str, default='cuda',
                        help="'cuda' (the default, the card) or 'cpu'")
    args = parser.parse_args(argv)
    config = parse_config(args.config)
    with launched_mesh(args.device) as mesh:
        return _train(config, args.device if mesh is None else mesh.device, mesh)


def _train(config: dict, device, mesh):
    data_cfg = config.get('data', {})
    train_cfg = config.get('training', {})
    log_cfg = config.get('logging', {})
    model_cfg = config.get('model', {})
    scaling_cfg = config.get('image_scaling', {})
    workdir, working_dir = run_paths(config)

    ref_time = data_cfg.get('ref_time')
    data = build_on_rank0(mesh, lambda: build_single_channel_data(
        data_path=data_cfg['data_path'],
        working_dir=working_dir,
        Rs_per_ds=data_cfg.get('Rs_per_ds', 1.0),
        seconds_per_dt=data_cfg.get('seconds_per_dt', 86400.0),
        ref_time=datetime.fromisoformat(ref_time) if ref_time else None,
        batch_size=data_cfg.get('batch_size', 1024),
        n_devices=1 if mesh is None else mesh.size,
        debug=data_cfg.get('debug', False)))

    # model: {coarse: {n_layers: 4, d_filter: 128}} opts into a small
    # proposal-style coarse field (systems.make_emission_system)
    model_cfg = dict(model_cfg)
    coarse_cfg = model_cfg.pop('coarse', None)
    nerf_cfg = emission_config(**model_cfg)
    renderer, init = make_emission_system(
        Rs_per_ds=data.Rs_per_ds, model_config=nerf_cfg,
        coarse_config=emission_config(**coarse_cfg) if coarse_cfg else None,
        device=device, **config.get('rendering', {}))

    loss_config = LossConfig(
        lambda_image=config.get('lambda_image', 1.0),
        lambda_regularization=config.get('lambda_regularization', 1.0),
        image_scaling='asinh',
        scaling_vmax=scaling_cfg.get('vmax', 1.0),
        scaling_a=scaling_cfg.get('a', 0.005),
        lambda_table_tv=config.get('lambda_table_tv', 0.0))

    trainer_config = TrainerConfig(
        total_steps=train_cfg.get('total_steps',
                                  train_cfg.get('epochs', 100)
                                  * max(len(data.train), 1)),
        val_every=train_cfg.get('log_every_n_steps', 10_000),
        checkpoint_every=train_cfg.get('checkpoint_every',
                                       train_cfg.get('log_every_n_steps', 10_000)),
        log_every=train_cfg.get('scalar_log_every', 100),
        debug_nans=train_cfg.get('debug_nans', False),
        keep_best=train_cfg.get('keep_best', False),
        ema_decay=train_cfg.get('ema_decay', 0.0),
        profile_steps=train_cfg.get('profile_steps', 0),
        # GT-free high-latitude drift probe (train/probe.py): on by
        # default for long schedules where the measured failure lives;
        # set drift_probe_views: 0 to disable
        drift_probe_views=train_cfg.get('drift_probe_views', 4),
        drift_probe_resolution=train_cfg.get('drift_probe_resolution', 64),
        drift_probe_lat_deg=train_cfg.get('drift_probe_lat_deg', 60.0),
        # opt-in probe-aware checkpoint selection: veto marginal keep_best
        # promotions whose probe render drifted past drift_probe_warn_db
        drift_probe_gate=train_cfg.get('drift_probe_gate', False),
        drift_probe_gate_margin_db=train_cfg.get(
            'drift_probe_gate_margin_db', 1.0),
        # full-budget steps before rendering.tier_fraction's tiers start (a
        # key of the port's CLI: JAX's scripts set it on the Trainer)
        tier_warmup_steps=train_cfg.get('tier_warmup_steps', 0))

    logger = rank0_logger(workdir, log_cfg, mesh)
    trainer = Trainer(renderer, init, data, loss_config=loss_config,
                      optim_config=OptimConfig(**config.get('optimizer', {})),
                      trainer_config=trainer_config, workdir=workdir,
                      logger=logger, device=device, mesh=mesh,
                      microbatch=train_cfg.get('microbatch'))
    try:
        trainer.fit()
    finally:
        if logger is not None:
            logger.close()
    return trainer


def rank0_logger(workdir: str, log_cfg: dict, mesh):
    """The run's MetricsLogger on rank 0 (or without a mesh), None on the
    other ranks, which write nothing."""
    if mesh is not None and mesh.rank:
        return None
    return MetricsLogger(workdir, project=log_cfg.get('project'),
                         name=log_cfg.get('name'), use_wandb=log_cfg.get('wandb', None))


if __name__ == '__main__':
    main()
