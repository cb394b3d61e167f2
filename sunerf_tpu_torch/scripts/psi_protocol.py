"""End-to-end PSI-protocol run (the psi_193 config family) on the port
(scripts/psi_protocol.py of the JAX package).

Synthetic MHD cubes (hydrostatic corona + longitudinal streamer) -> MHDModel
renders at 18 viewpoints (14 ecliptic |lat| <= 7 deg + 4 test up to +-50 deg)
-> `prep psi` (ecliptic training cut + PSI norms; ground truth keeps all
lats) -> emission SuNeRF training -> metrics harness with the |lat| > 7 deg
train/test split (reference protocol: evaluation/stash/metrics_simulation.py
+ data/prep/psi.py:29-30).

--n-stratified/--n-hierarchical/--proposal-coarse select the sampling
configuration, so the matched-quality acceleration points (RESULTS.md
SimpleStar matrix) can be validated on the MHD scene the north-star metric
names (BASELINE.json: >=10x rays/s/chip at matched PSNR on psi_193).

The cubes are written by data/psi_io.wrhdf_3d (numpy alone where h5py is
absent, as on the card's host), rendered through evaluation.image_render's
MHDModel path, prepped by data.prep.prep_file; training runs the port's
Trainer (K1 + K2 on the card) and scoring the metrics harness through
SuNeRFLoader (K0). Rays/s is utils.throughput's accounting of the Trainer's
logged windows.

Usage: python -m sunerf_tpu_torch.scripts.psi_protocol [--steps 4000]
       [--n-stratified 64] [--n-hierarchical 128] [--proposal-coarse]
       [--resolution 128] [--device cuda]
Prints one JSON line (main returns it).
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import tempfile
from datetime import datetime

import numpy as np


def synth_cubes(data_path: str):
    """Static MHD frame: hydrostatic corona + two longitudinal streamers."""
    from sunerf_tpu_torch.data.psi_io import wrhdf_3d
    r = np.linspace(1.0, 1.3, 24)
    th = np.linspace(0.0, np.pi, 32)
    ph = np.linspace(0.0, 2 * np.pi, 64)
    R, TH, PH = r[None, None, :], th[None, :, None], ph[:, None, None]
    streamer = (2.5 * np.exp(-(np.angle(np.exp(1j * (PH - 1.0))) ** 2) / 0.1
                             - ((TH - np.pi / 2) ** 2) / 0.05)
                + 1.5 * np.exp(-(np.angle(np.exp(1j * (PH - 3.8))) ** 2) / 0.2
                               - ((TH - np.pi / 2) ** 2) / 0.08))
    rho = 1e8 * np.exp((1.0 / R - 1.0) / 0.1) * (1.0 + streamer)
    temp = np.full_like(rho, 1.5)
    for var, cube in (('rho', rho), ('t', temp)):
        d = os.path.join(data_path, var)
        os.makedirs(d, exist_ok=True)
        wrhdf_3d(os.path.join(d, f'{var}00100.h5'), r, th, ph,
                 cube.astype(np.float32))


def ensure_scene(data_dir: str, resolution: int, prep_batch: int = 8192,
                 device='cuda'):
    """Synthesize (or reuse) the deterministic psi_193 protocol scene,
    rendering on `device`.

    Returns (train_dir, gt_dir). Importable so offline scorers
    (scripts/score_bundle.py) can rebuild the exact ground-truth views a
    bundle was trained against without re-running the protocol.
    """
    from sunerf_tpu_torch.data.fits import read_fits
    from sunerf_tpu_torch.data.norms import PSI_NORMS
    from sunerf_tpu_torch.data.prep import prep_file
    from sunerf_tpu_torch.evaluation.image_render import render_observers

    marker = os.path.join(data_dir, '.scene_complete')
    train_dir = os.path.join(data_dir, 'train')
    gt_dir = os.path.join(data_dir, 'gt')
    if os.path.exists(marker):
        print(f'reusing cached scene in {data_dir}')
        return train_dir, gt_dir

    cubes = os.path.join(data_dir, 'cubes')
    synth_cubes(cubes)

    # 18 viewpoints: 14 ecliptic (train band) + 4 high-lat test views
    observers = [{'name': 'psi', 'lat': 6.0 * ((i % 3) - 1) / 1.5,
                  'lon': i * (360.0 / 14), 'distance': 215.0,
                  'time': datetime(2012, 8, 23).isoformat()}
                 for i in range(14)]
    observers += [{'name': 'psi', 'lat': lat, 'lon': lon,
                   'distance': 215.0,
                   'time': datetime(2012, 8, 23).isoformat()}
                  for lat, lon in ((-50.0, 30.0), (-25.0, 120.0),
                                   (25.0, 210.0), (50.0, 300.0))]

    # calibrate pixel intensity so the peak lands near the PSI 193 vmax
    probe_dir = os.path.join(data_dir, 'probe')
    render_observers({'model': 'MHDModel', 'data_path': cubes,
                      'render_path': probe_dir, 'render_format': ['fits'],
                      'resolution': 64, 'wavelengths': [193],
                      'batch_size': 8192, 'pixel_intensity_factor': 1.0,
                      'observers': observers[:1]}, device=device)
    img, _ = read_fits(sorted(glob.glob(
        os.path.join(probe_dir, 'psi', '193', '*.fits')))[0])
    pif = 0.7 * PSI_NORMS[193] / max(float(np.percentile(img, 99.9)),
                                     1e-30)

    raw_dir = os.path.join(data_dir, 'renders')
    render_observers({'model': 'MHDModel', 'data_path': cubes,
                      'render_path': raw_dir, 'render_format': ['fits'],
                      'resolution': resolution, 'wavelengths': [193],
                      'batch_size': prep_batch,
                      'pixel_intensity_factor': pif,
                      'observers': observers}, device=device)

    raw_glob = os.path.join(raw_dir, 'psi', '193', '*.fits')
    n_train = n_gt = 0
    for f in sorted(glob.glob(raw_glob)):
        if prep_file(f, train_dir, 'psi', resolution=resolution):
            n_train += 1
        if prep_file(f, gt_dir, 'psi', resolution=resolution,
                     lat_cut=False):
            n_gt += 1
    print(f'prep: {n_train} train views (ecliptic), {n_gt} ground truth')
    with open(marker, 'w') as fh:
        fh.write('ok')
    return train_dir, gt_dir


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument('--steps', type=int, default=4000)
    parser.add_argument('--prep-batch', type=int, default=8192,
                        help='rays per render chunk during scene prep')
    parser.add_argument('--resolution', type=int, default=128)
    parser.add_argument('--n-stratified', type=int, default=64)
    parser.add_argument('--n-hierarchical', type=int, default=128)
    parser.add_argument('--proposal-coarse', action='store_true')
    parser.add_argument('--coarse-layers', type=int, default=4,
                        help='proposal coarse-field depth (with '
                             '--proposal-coarse)')
    parser.add_argument('--coarse-filter', type=int, default=128,
                        help='proposal coarse-field width')
    parser.add_argument('--tier-fraction', type=float, default=0.0,
                        help='adaptive per-ray budgets: fraction of dim rays '
                             'rendered at --tier-samples (renderer.py)')
    parser.add_argument('--tier-samples', type=int, default=16)
    parser.add_argument('--occupancy', action='store_true',
                        help='occupancy-guided stratified sampling '
                             '(robust-max criterion + occ_vol factor, '
                             'core/occupancy.py)')
    parser.add_argument('--occ-threshold', type=float, default=0.05)
    parser.add_argument('--occ-floor', type=float, default=0.02)
    parser.add_argument('--anneal-frac', type=float, default=0.0,
                        help='budget annealing: train the FIRST this '
                             'fraction of steps at (--anneal-stratified, '
                             '--anneal-hierarchical), then resume at the '
                             'main budget for the rest (two Trainers, a '
                             'checkpoint hand-off in between; 0 = off)')
    parser.add_argument('--anneal-stratified', type=int, default=24)
    parser.add_argument('--anneal-hierarchical', type=int, default=48)
    parser.add_argument('--model-layers', type=int, default=8,
                        help='FINE field depth (reference parity: 8x512, '
                             'model.py:12-42) — the quality-per-FLOP axis '
                             'also includes the field itself')
    parser.add_argument('--model-filter', type=int, default=512,
                        help='FINE field width (up to 512; the kernels run '
                             'other widths zero-padded to the next of '
                             'ops/fused_mlp.KERNEL_WIDTHS)')
    parser.add_argument('--grid-sizes', type=int, nargs='+', default=[],
                        help='FINE-field feature-grid levels (e.g. 16 32): '
                             'learned dense tables whose trilinear features '
                             'subsidize a much smaller MLP '
                             '(ops/grid_encoding.py); empty = off')
    parser.add_argument('--grid-features', type=int, default=8)
    parser.add_argument('--grid-rank', type=int, default=0,
                        help='>0 switches the grid levels to TensoRF-style '
                             'VM factorization of this rank (3 plane x line '
                             'products per level, ops/grid_encoding.py '
                             'vm_encode) — the low-rank smoothness prior '
                             'candidate for the dense tables: measured '
                             'view overfitting. float32 field path (no '
                             'kernel). 0 = dense tables')
    parser.add_argument('--grid-hat-mxu', action='store_true',
                        help='recorded in the config (a layout flag of the JAX '
                             "package's kernel; it changes nothing here)")
    parser.add_argument('--grid-bound', type=float, default=1.3,
                        help='grid half-extent in ds units (the psi scene '
                             'samples within 1.3 Rsun of Sun center)')
    parser.add_argument('--table-lr-mult', type=float, default=1.0,
                        help='feature-grid table lr multiplier '
                             '(instant-NGP recipe: ~10x the MLP lr)')
    parser.add_argument('--adam-eps', type=float, default=1e-8)
    parser.add_argument('--table-tv', type=float, default=0.0,
                        help='total-variation penalty weight on feature-grid '
                             'tables (the few-view smoothness prior; '
                             'objective.py table_tv). 0 = off')
    parser.add_argument('--grid-coarse', action='store_true',
                        help='attach the feature grid to the PROPOSAL '
                             '(coarse) field instead of the fine field: the '
                             'proposal only places samples, so table view-'
                             'overfitting cannot corrupt held-out renders '
                             '(overfit-fix option 3, RESULTS.md grid A/B). '
                             'Requires --proposal-coarse and --grid-sizes.')
    parser.add_argument('--ema-decay', type=float, default=0.0,
                        help='Polyak parameter averaging decay (train/loop.py '
                             'TrainerConfig.ema_decay): validation also '
                             'scores the averaged variant and keep_best '
                             'saves the better of live/EMA. 0 = off')
    parser.add_argument('--keep-best', action='store_true',
                        help='validate periodically (steps//8) and score the '
                             'best-held-out checkpoint (save_state_best) '
                             'instead of the final step — counters the '
                             'long-schedule degradation of small fields '
                             '(RESULTS.md arch rows). Changes row semantics: '
                             'use a separate matrix file.')
    parser.add_argument('--drift-probe-gate', action='store_true',
                        help='probe-aware keep_best (train/loop.py '
                             'drift_probe_gate): veto marginal band-val '
                             'promotions whose high-latitude probe render '
                             'drifted below --drift-probe-warn-db from the '
                             'reigning best bundle (requires --keep-best)')
    parser.add_argument('--drift-probe-warn-db', type=float, default=34.0)
    parser.add_argument('--drift-probe-gate-margin-db', type=float,
                        default=1.0,
                        help='band-val gains at least this large bypass the '
                             'gate (real improvements are never vetoed)')
    parser.add_argument('--report-hbm', action='store_true',
                        help='record device memory stats (peak bytes '
                             'allocated) in the output row — the 1024 px '
                             'reference-prep-resolution rehearsal needs '
                             'the memory headroom on record (reference prep '
                             'default: sunerf/data/utils.py:74)')
    parser.add_argument('--device', default='cuda',
                        help="'cuda' (the default, the card) or 'cpu'")
    parser.add_argument('--seed', type=int, default=7)
    parser.add_argument('--workdir', default=None)
    parser.add_argument('--out', default=None,
                        help='append the result JSON line to this file')
    parser.add_argument('--data-cache', default=None,
                        help='shared directory for the synthesized scene '
                             '(cubes/renders/prep) — reused across runs; the '
                             'pipeline is deterministic, so this only skips '
                             'recomputation (matrix runs save ~3 min each)')
    return parser


def row_config(args) -> dict:
    """The row's config for parsed arguments: the matrix script's resume
    signature (a key absent at its default keeps older rows' signatures)."""
    config = {'n_stratified': args.n_stratified,
              'n_hierarchical': args.n_hierarchical,
              'proposal_coarse': args.proposal_coarse,
              'coarse_shape': ([args.coarse_layers, args.coarse_filter]
                               if args.proposal_coarse else None),
              'steps': args.steps,
              'tier_fraction': args.tier_fraction,
              'tier_samples': args.tier_samples,
              'seed': args.seed}
    if args.resolution != 128:
        # key absent at the mini-protocol default: keeps earlier rows'
        # signatures unchanged (256 px rows written before this key exist
        # in SCALE_PROOF_r4.jsonl; their resolution is documented there)
        config['resolution'] = args.resolution
    if (args.model_layers, args.model_filter) != (8, 512):
        # key absent at reference parity: keeps earlier rows' signatures
        # (and so psi_matrix.py idempotency) unchanged
        config['model_shape'] = [args.model_layers, args.model_filter]
    if args.grid_sizes:
        # key absent when off: keeps pre-grid matrix rows' signatures
        # (and so psi_matrix.py idempotency) unchanged
        config['grid'] = {'sizes': list(args.grid_sizes),
                          'features': args.grid_features,
                          'bound': args.grid_bound}
        if args.grid_hat_mxu:
            # numerics-equivalent kernel strategy; recorded for provenance
            # but only when on, so default rows keep their signatures
            config['grid']['hat_mxu'] = True
        if args.table_tv:
            # loss-changing: must differentiate the row signature
            config['grid']['table_tv'] = args.table_tv
        if args.grid_rank:
            # factorization changes the model: signature key (absent for
            # dense rows so earlier signatures are unchanged)
            config['grid']['rank'] = args.grid_rank
        if args.grid_coarse:
            # which field carries the tables changes the model: signature key
            config['grid']['on'] = 'coarse'
    if (args.table_lr_mult, args.adam_eps) != (1.0, 1e-8):
        # recorded OUTSIDE the grid block: adam_eps changes the optimizer
        # for ALL params, and a non-grid eps-control row must not collapse
        # into the default-eps signature
        config['optim'] = {'table_lr_mult': args.table_lr_mult,
                           'adam_eps': args.adam_eps}
    if int(round(args.anneal_frac * args.steps)):
        # key absent when off: keeps pre-anneal matrix rows' signatures
        # (and so psi_matrix.py idempotency) unchanged
        config['anneal'] = {
            'frac': args.anneal_frac,
            'n_stratified': args.anneal_stratified,
            'n_hierarchical': args.anneal_hierarchical}
    if args.ema_decay:
        # key absent when off: keeps non-EMA rows' signatures unchanged
        config['ema_decay'] = args.ema_decay
    if args.keep_best:
        # key absent when off: keeps final-step rows' signatures unchanged
        config['keep_best'] = True
    if args.drift_probe_gate:
        # selection-changing: must differentiate the row signature
        config['probe_gate'] = {
            'warn_db': args.drift_probe_warn_db,
            'margin_db': args.drift_probe_gate_margin_db}
    if args.occupancy:
        # key absent when off: keeps pre-occupancy matrix rows' signatures
        # (and so psi_matrix.py idempotency) unchanged
        config['occupancy'] = {'threshold': args.occ_threshold,
                               'floor': args.occ_floor}
    return config


def main(argv=None) -> dict:
    parser = build_parser()
    args = parser.parse_args(argv)

    import torch

    from sunerf_tpu_torch.data.loaders import build_single_channel_data
    from sunerf_tpu_torch.evaluation.loader import SuNeRFLoader
    from sunerf_tpu_torch.evaluation.metrics_harness import evaluate_viewpoints
    from sunerf_tpu_torch.models.fields import emission_config
    from sunerf_tpu_torch.systems import make_emission_system
    from sunerf_tpu_torch.train.loop import Trainer, TrainerConfig
    from sunerf_tpu_torch.train.objective import LossConfig
    from sunerf_tpu_torch.train.optim import OptimConfig
    from sunerf_tpu_torch.utils.throughput import effective_rate

    device = torch.device(args.device)
    workdir = args.workdir or tempfile.mkdtemp(prefix='psi_protocol_')
    data_dir = args.data_cache or workdir
    train_dir, gt_dir = ensure_scene(data_dir, args.resolution,
                                     prep_batch=args.prep_batch, device=device)

    data = build_single_channel_data(
        os.path.join(train_dir, '*.fits'),
        os.path.join(workdir, 'work'), batch_size=1024)
    grid_kwargs = (dict(grid_sizes=tuple(args.grid_sizes),
                        grid_features=args.grid_features,
                        grid_bound=args.grid_bound,
                        grid_hat_mxu=args.grid_hat_mxu,
                        grid_rank=args.grid_rank)
                   if args.grid_sizes else {})
    if args.grid_coarse and not (args.proposal_coarse and args.grid_sizes):
        parser.error('--grid-coarse requires --proposal-coarse and '
                     '--grid-sizes')

    coarse = (emission_config(n_layers=args.coarse_layers,
                              d_filter=args.coarse_filter,
                              **(grid_kwargs if args.grid_coarse else {}))
              if args.proposal_coarse else None)
    occ = ({'enabled': True, 'threshold': args.occ_threshold,
            'floor': args.occ_floor, 'warmup': 500, 'update_every': 16}
           if args.occupancy else None)
    run_dir = os.path.join(workdir, 'run')
    loss_config = LossConfig(lambda_regularization=0.1, scaling_vmax=10.0,
                             lambda_table_tv=args.table_tv)
    optim_config = OptimConfig(lr_start=1e-3, lr_end=1e-4,
                               lr_iterations=args.steps, lr_floor=1e-4,
                               table_lr_mult=args.table_lr_mult,
                               adam_eps=args.adam_eps)

    def make_trainer(n_strat, n_hier, total_steps, phase_start=0):
        renderer, init = make_emission_system(
            model_config=emission_config(
                n_layers=args.model_layers, d_filter=args.model_filter,
                **({} if args.grid_coarse else grid_kwargs)),
            n_stratified=n_strat, n_hierarchical=n_hier,
            coarse_config=coarse, tier_fraction=args.tier_fraction,
            tier_samples=args.tier_samples, occupancy=occ, device=device)
        return Trainer(
            renderer, init, data,
            loss_config=loss_config, optim_config=optim_config,
            spike_guard=10.0,
            trainer_config=TrainerConfig(total_steps=total_steps,
                                         val_every=(max(args.steps // 8, 1)
                                                    if args.keep_best
                                                    else args.steps),
                                         keep_best=args.keep_best,
                                         ema_decay=args.ema_decay,
                                         checkpoint_every=total_steps,
                                         # ~10 windows per PHASE so a short
                                         # anneal phase still contributes
                                         # usable rate samples
                                         log_every=max((total_steps
                                                        - phase_start) // 10,
                                                       1),
                                         save_val_images=False,
                                         # GT-free high-latitude drift probe
                                         # (train/probe.py): observational
                                         # render-only metrics at each
                                         # validation — does not change
                                         # training; trace summarized into
                                         # the output row (highlat_probe)
                                         drift_probe_views=4,
                                         drift_probe_gate=(
                                             args.drift_probe_gate),
                                         drift_probe_warn_db=(
                                             args.drift_probe_warn_db),
                                         drift_probe_gate_margin_db=(
                                             args.drift_probe_gate_margin_db),
                                         seed=args.seed),
            workdir=run_dir, device=device)

    phase1_steps = int(round(args.anneal_frac * args.steps))
    phase_starts = [0]
    if phase1_steps:
        # budget annealing: the deep-cut budgets (16+32) underfit when the
        # proposal CDF is still random early on (RESULTS.md frontier-edge /
        # eval-budget sweep: the knee is a TRAINING deficiency); a short
        # moderate-budget phase establishes the field, then the cheap budget
        # takes over via the checkpoint/resume path (two Trainers, params
        # are budget-independent).
        make_trainer(args.anneal_stratified, args.anneal_hierarchical,
                     phase1_steps).fit()
        phase_starts.append(phase1_steps)
    trainer = make_trainer(args.n_stratified, args.n_hierarchical, args.steps,
                           phase_start=phase1_steps)
    trainer.fit()
    with open(os.path.join(run_dir, 'metrics.jsonl')) as fh:
        recs = [json.loads(line) for line in fh]
    samples = sorted((r['step'], r['rays_per_sec'])
                     for r in recs if 'rays_per_sec' in r)
    if phase1_steps:
        # mixed-budget run: ray-weighted harmonic mean over the kept windows
        # (warm-up windows dropped — utils/throughput.py has the semantics)
        rate = effective_rate(samples, phase_starts)
    else:
        rates = [r for _, r in samples]
        rate = float(np.median(rates[1:] or rates))
    effective = effective_rate(samples, phase_starts)

    bundle = os.path.join(run_dir, 'save_state.npz')
    if args.keep_best:
        best = os.path.join(run_dir, 'save_state_best.npz')
        if os.path.exists(best):
            bundle = best
    loader = SuNeRFLoader(bundle, device=device)
    metrics = evaluate_viewpoints(loader,
                                  sorted(glob.glob(os.path.join(gt_dir,
                                                                '*.fits'))))
    out = {'config': row_config(args),
           'rays_per_sec': round(rate, 1),
           'effective_rays_per_sec': effective,
           'train': metrics['train'], 'test': metrics['test'],
           'workdir': workdir}
    if args.keep_best:
        # records which bundle was actually scored (best may be absent if
        # no validation improved on -inf, i.e. the run produced no val rows)
        out['scored_bundle'] = os.path.basename(bundle)
    stab = [round(r['probe_stability_db'], 2) for r in recs
            if 'probe_stability_db' in r]
    drift = [round(r['probe_drift_since_best_db'], 2) for r in recs
             if 'probe_drift_since_best_db' in r]
    if stab or drift:
        # OBSERVATIONAL (render-only, does not change training, so NOT a
        # config/signature key): the high-latitude drift-probe trace
        # (train/probe.py) — the seed-8 long-schedule reversal's failure
        # signature is band-val flat while drift_since_best collapses
        # (RESULTS.md round-4 scale section)
        out['highlat_probe'] = {
            'stability_db': stab,
            'drift_since_best_db': drift,
            'warnings': int(sum(1 for r in recs
                                if r.get('probe_drift_warning')))}
        if args.drift_probe_gate:
            out['highlat_probe']['gate_rejections'] = int(
                sum(1 for r in recs if r.get('probe_gate_rejected')))
    if args.occupancy:
        tail = [r for r in recs if 'occ_vol_frac' in r]
        if tail:
            out['occ_fracs'] = {k: tail[-1][k] for k in
                                ('occ_r_frac', 'occ_ang_frac', 'occ_vol_frac')}
    if args.report_hbm and device.type == 'cuda':
        # observational (not a signature key): peak/current device memory
        # after train + eval
        out['hbm'] = {'peak_bytes_in_use': torch.cuda.max_memory_allocated(device),
                      'bytes_in_use': torch.cuda.memory_allocated(device),
                      'bytes_limit': torch.cuda.get_device_properties(device).total_memory}
    print(json.dumps(out))
    if args.out:
        with open(args.out, 'a') as fh:
            fh.write(json.dumps(out) + '\n')
    return out


if __name__ == '__main__':
    main()
