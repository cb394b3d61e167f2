"""Emission SuNeRF training CLI (sunerf_tpu/run_emission.py).

Usage: python -m sunerf_tpu_torch.run_emission --config config/emission.yaml
       [--device cuda|cpu]

Config sections (YAML): data, training, logging, model, rendering,
optimizer, image_scaling — the JAX CLI's layout and defaults. One device:
the card unless --device cpu is given. rendering.tier_fraction /
tier_samples and rendering.occupancy go to the system factory as in the JAX
CLI; training.tier_warmup_steps to the Trainer. There is no mesh (ROADMAP
Queue 1 item 11), and training.microbatch raises (item 10).
"""
from __future__ import annotations

import argparse
from datetime import datetime

from sunerf_tpu_torch.data.loaders import build_single_channel_data
from sunerf_tpu_torch.models.fields import emission_config
from sunerf_tpu_torch.systems import make_emission_system
from sunerf_tpu_torch.train.loop import Trainer, TrainerConfig
from sunerf_tpu_torch.train.objective import LossConfig
from sunerf_tpu_torch.train.optim import OptimConfig
from sunerf_tpu_torch.utils.logging import MetricsLogger


def parse_config(path: str) -> dict:
    import yaml
    with open(path) as f:
        return yaml.safe_load(f)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--config', type=str, required=True)
    parser.add_argument('--device', type=str, default='cuda',
                        help="'cuda' (the default, the card) or 'cpu'")
    args = parser.parse_args(argv)
    config = parse_config(args.config)

    data_cfg = config.get('data', {})
    train_cfg = config.get('training', {})
    log_cfg = config.get('logging', {})
    model_cfg = config.get('model', {})
    scaling_cfg = config.get('image_scaling', {})
    if train_cfg.get('microbatch') is not None:
        raise NotImplementedError('training.microbatch is not ported yet (ROADMAP '
                                  'Queue 1 item 10, opt-in dials: microbatch)')

    workdir = config.get('path_to_save', config.get('workdir', './workdir'))
    working_dir = config.get('work_directory', workdir + '/batches')

    ref_time = data_cfg.get('ref_time')
    data = build_single_channel_data(
        data_path=data_cfg['data_path'],
        working_dir=working_dir,
        Rs_per_ds=data_cfg.get('Rs_per_ds', 1.0),
        seconds_per_dt=data_cfg.get('seconds_per_dt', 86400.0),
        ref_time=datetime.fromisoformat(ref_time) if ref_time else None,
        batch_size=data_cfg.get('batch_size', 1024),
        debug=data_cfg.get('debug', False))

    # model: {coarse: {n_layers: 4, d_filter: 128}} opts into a small
    # proposal-style coarse field (systems.make_emission_system)
    model_cfg = dict(model_cfg)
    coarse_cfg = model_cfg.pop('coarse', None)
    nerf_cfg = emission_config(**model_cfg)
    renderer, init = make_emission_system(
        Rs_per_ds=data.Rs_per_ds, model_config=nerf_cfg,
        coarse_config=emission_config(**coarse_cfg) if coarse_cfg else None,
        device=args.device, **config.get('rendering', {}))

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

    logger = MetricsLogger(workdir, project=log_cfg.get('project'),
                           name=log_cfg.get('name'),
                           use_wandb=log_cfg.get('wandb', None))

    trainer = Trainer(renderer, init, data, loss_config=loss_config,
                      optim_config=OptimConfig(**config.get('optimizer', {})),
                      trainer_config=trainer_config, workdir=workdir,
                      logger=logger, device=args.device)
    try:
        trainer.fit()
    finally:
        logger.close()
    return trainer


if __name__ == '__main__':
    main()
