"""Density-temperature SuNeRF training CLI (sunerf_tpu/run_density_temperature.py).

Usage: python -m sunerf_tpu_torch.run_density_temperature --config config/DT_2012_11.yaml
       [--device cuda|cpu]
       torchrun --nproc-per-node N -m sunerf_tpu_torch.run_density_temperature --config ...

Config sections (YAML): data (an <instrument>/<wavelength>/*.fits tree),
training, logging, model (model.coarse for a proposal field), rendering,
optimizer, pixel_intensity_factor (1e17) — the JAX CLI's layout and
defaults; the loss is on raw intensities (image_scaling 'none'). The card
unless --device cpu is given. rendering.tier_fraction / tier_samples and
rendering.occupancy go to the system factory as in the JAX CLI;
training.tier_warmup_steps and training.microbatch to the Trainer. Launched
by torchrun the run is data parallel, as run_emission's is.
"""
from __future__ import annotations

import argparse
from datetime import datetime

from sunerf_tpu_torch.data.loaders import build_multi_thermal_data
from sunerf_tpu_torch.models.fields import density_temperature_config
from sunerf_tpu_torch.parallel.mesh import build_on_rank0
from sunerf_tpu_torch.run_emission import (launched_mesh, parse_config, rank0_logger,
                                           run_paths)
from sunerf_tpu_torch.systems import make_density_temperature_system
from sunerf_tpu_torch.train.loop import Trainer, TrainerConfig
from sunerf_tpu_torch.train.objective import LossConfig
from sunerf_tpu_torch.train.optim import OptimConfig


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
    workdir, working_dir = run_paths(config)

    ref_time = data_cfg.get('ref_time')
    data = build_on_rank0(mesh, lambda: build_multi_thermal_data(
        data_path=data_cfg['data_path'],
        working_dir=working_dir,
        Rs_per_ds=data_cfg.get('Rs_per_ds', 1.0),
        seconds_per_dt=data_cfg.get('seconds_per_dt', 86400.0),
        ref_time=datetime.fromisoformat(ref_time) if ref_time else None,
        batch_size=data_cfg.get('batch_size', 1024),
        n_devices=1 if mesh is None else mesh.size,
        # read as the JAX CLI reads it: downscaling_factor alone gives None
        target_resolution=data_cfg.get('target_resolution',
                                       data_cfg.get('downscaling_factor')
                                       and None),
        debug=data_cfg.get('debug', False)))

    # model: {coarse: {n_layers: 4, d_filter: 128}} opts into a small
    # proposal-style coarse field (systems.make_density_temperature_system)
    model_cfg = dict(model_cfg)
    coarse_cfg = model_cfg.pop('coarse', None)
    nerf_cfg = density_temperature_config(**model_cfg)
    renderer, init = make_density_temperature_system(
        Rs_per_ds=data.Rs_per_ds, model_config=nerf_cfg,
        coarse_config=(density_temperature_config(**coarse_cfg)
                       if coarse_cfg else None),
        pixel_intensity_factor=float(config.get('pixel_intensity_factor', 1e17)),
        device=device, **config.get('rendering', {}))

    loss_config = LossConfig(
        lambda_image=config.get('lambda_image', 1.0),
        lambda_regularization=config.get('lambda_regularization', 1.0),
        image_scaling='none',
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
        # GT-free high-latitude drift probe (train/probe.py); it pins the
        # held-out stack's first wavelength entry; drift_probe_views: 0
        # disables it
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


if __name__ == '__main__':
    main()
