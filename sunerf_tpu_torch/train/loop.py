"""Training loop (sunerf_tpu/train/loop.py): steps over pre-batched ray
shards, periodic held-out-view validation (with keep_best, the EMA variant
and the GT-free drift probe and its gate), checkpoint/resume, metrics
logging.

Replaces the reference's PyTorch-Lightning orchestration
(run_emission.py:65-75, model/sunerf.py:15-59, train/callback.py:17-88) with
a plain loop. Each batch goes to the device once, staged in pinned memory
so that its copy does not wait for the device; the host reads the step's
metrics only every log_every steps, so it stays ahead of the device between
those reads, validations and checkpoints.

Against the JAX loop: fit's SIGTERM handler (a checkpoint, then return, on
preemption) is restored to the process's previous handler on every way out
of fit, whether it ends, is preempted or raises; the validation render runs
in chunks of the validation set's batch size under torch.no_grad() with one
host fetch at the end; the rays/s window restarts after each validation and
checkpoint, so it times steps only. The occupancy grid is updated in place
in params['occupancy'] (never by the optimizer); tier_warmup_steps swaps
between two step functions on the host.

On a mesh (parallel/mesh.py) every rank runs this loop: the state is
replicated from rank 0 after a restore, each rank reads its own rows of the
same global batch and steps on them, the held-out view renders tiled over
the ranks
and every rank scores it alike, and the occupancy update draws the same
jitter at rank 0's time on every rank, so the grids agree. JAX's loop is one process and
writes each file once; here only rank 0 writes the metrics log, the
images, the checkpoints and the bundles. A SIGTERM on any rank stops every
rank at the same step (a host-side all-reduce of the flag each step).
"""
from __future__ import annotations

import dataclasses
import json
import logging
import os
import signal
from typing import Optional

import numpy as np
import torch

from sunerf_tpu_torch.core.occupancy import init_occupancy, update_occupancy
from sunerf_tpu_torch.core.scaling import image_asinh_scaling
from sunerf_tpu_torch.data.datasets import iterate_batches
from sunerf_tpu_torch.data.loaders import RayData
from sunerf_tpu_torch.models.fields import params_from_numpy
from sunerf_tpu_torch.parallel.mesh import (ShardedRows, host_any, host_first, mesh_device,
                                            render_tiled, replicate)
from sunerf_tpu_torch.train.metrics import psnr as psnr_metric, ssim as ssim_metric
from sunerf_tpu_torch.train.objective import LossConfig
from sunerf_tpu_torch.train.optim import OptimConfig, make_optimizer
from sunerf_tpu_torch.train.step import (copy_params, create_train_state, make_eval_step,
                                         make_train_step, step_generator)
from sunerf_tpu_torch.utils.checkpoint import (restore_train_checkpoint,
                                               save_state, save_train_checkpoint)
from sunerf_tpu_torch.utils.logging import MetricsLogger

logger = logging.getLogger(__name__)


def degenerate_prediction(pred: np.ndarray, target: np.ndarray,
                          rtol: float = 1e-6) -> bool:
    """True when a validation prediction is (near-)zero relative to its
    target — the signature of a collapsed multiplicative head (DT), whose
    PSNR/SSIM are then seed-independent scene constants."""
    return float(np.abs(pred).max()) < rtol * max(
        float(np.abs(target).max()), 1e-30)


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: training runs on the card; pass "
                           "device='cpu' to train on the CPU")
    return device


def _to_device(params, device) -> dict:
    """Initial parameters as float32 tensors on `device`: a nested dict of
    tensors or of numpy arrays (the JAX package's parameters)."""
    if isinstance(params, dict):
        return {k: _to_device(v, device) for k, v in params.items()}
    if isinstance(params, torch.Tensor):
        return params.detach().to(device=device, dtype=torch.float32)
    return params_from_numpy(np.array(params, np.float32), device)


class _Uploader:
    """Host batches to the device without waiting for it. A copy from
    pageable memory waits for the stream's earlier work (every step's
    kernels), so each batch is staged in one of two pinned buffers per key
    and copied with non_blocking=True; a buffer is refilled only once the
    copy that last read it, two batches back, has finished (its event). On
    the CPU a batch is just wrapped."""

    def __init__(self, device: torch.device):
        self.device = device
        self._slots = [None, None]
        self._turn = 0

    def __call__(self, batch: dict) -> dict:
        if self.device.type != 'cuda':
            return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}
        slot = self._slots[self._turn]
        if slot is None or any(slot['host'][k].shape != v.shape for k, v in batch.items()):
            slot = {'host': {k: torch.empty(v.shape, dtype=torch.from_numpy(v[:0]).dtype,
                                            pin_memory=True) for k, v in batch.items()},
                    'event': None}
            self._slots[self._turn] = slot
        elif slot['event'] is not None:
            slot['event'].synchronize()
        out = {}
        for k, v in batch.items():
            slot['host'][k].numpy()[...] = v
            out[k] = slot['host'][k].to(self.device, non_blocking=True)
        slot['event'] = torch.cuda.Event()
        slot['event'].record()
        self._turn ^= 1
        return out


class _Silent:
    """The logger of a rank other than 0: it records nothing."""

    def log(self, metrics: dict, step: int):
        pass

    def log_image(self, name: str, path: str, step: int):
        pass

    def close(self):
        pass


def _asinh(loss_config: LossConfig, x: torch.Tensor) -> np.ndarray:
    if loss_config.image_scaling == 'asinh':
        x = image_asinh_scaling(x, loss_config.scaling_vmax, loss_config.scaling_a)
    return x.numpy()


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100_000
    val_every: int = 10_000
    checkpoint_every: int = 10_000
    log_every: int = 100
    seed: int = 7
    # torch.autograd anomaly detection while fit runs (a NaN in the
    # backward raises where it appears), beside the finite-loss check
    debug_nans: bool = False
    save_val_images: bool = True
    # record a torch.profiler trace over steps [profile_start, profile_start +
    # profile_steps) into <workdir>/profile (utils/profiling.trace: trace.json
    # and summary.json with the device's idle share); 0 disables
    profile_steps: int = 0
    profile_start: int = 10
    # keep a 'save_state_best' deployment bundle at the highest held-out
    # val PSNR seen so far (the reference keeps only save_last,
    # run_emission.py:53-55). Motivated by a measured failure mode: small
    # fields on long high-lr schedules overfit training rays while
    # re-rendered views DEGRADE (RESULTS.md architecture axis), so
    # last != best.
    keep_best: bool = False
    # Polyak/EMA parameter averaging (train/step.py ema_params leaf): the
    # CONTINUOUS counterpart to keep_best for the same measured failure mode
    # (long-schedule small-field degradation, RESULTS.md arch axis).
    # Validation additionally scores the averaged params (val_psnr_ema) and,
    # under keep_best, the better of live/EMA wins the save_state_best
    # bundle; save() writes a save_state_ema deployment variant.
    # 0.0 = off (reference parity). Typical: 0.999.
    ema_decay: float = 0.0
    # Tier warmup (curriculum for the adaptive per-ray budgets,
    # renderer.tier_fraction): the tiered fine pass places the dim tier's
    # samples from the coarse pass's CDF, which is uninformative at init.
    # On the DT head's multiplicative parametrization that starves half
    # the batch of gradient signal early and can collapse training into
    # the zero-output constant (DT_MATRIX_r4 dt_tiered_half: train
    # latched at the scene constant by step 1400 while the untier'd
    # proposal row trained fine on the same scene/seed). For the first
    # tier_warmup_steps the Trainer steps a full-budget clone of the
    # renderer (tier_fraction=0), swapped on the host. 0 = off (tiers from
    # step 0).
    tier_warmup_steps: int = 0
    # GT-free high-latitude drift probe (train/probe.py): render
    # drift_probe_views FIXED |lat| = drift_probe_lat_deg viewpoints at
    # every validation and log probe_stability_db (vs the previous
    # validation) and probe_drift_since_best_db (vs the render at the
    # val-PSNR high-water mark). This is the observability answer to the
    # round-4 scale-test reversal: the deep-cut budgets can drift at high
    # latitude late in long schedules while the ecliptic-band validation
    # — the only ground truth solar data provides — stays flat, so
    # keep_best cannot see the failure (SCALE_PROOF_r4.jsonl seed 8,
    # RESULTS.md round-4 scale section). 0 = off.
    drift_probe_views: int = 0
    drift_probe_resolution: int = 64
    drift_probe_lat_deg: float = 60.0
    # warn when band-val sits within 0.5 dB of its high-water while the
    # probe render has moved by more than this (probe PSNR below this).
    # Default recalibrated in round 5: both recorded real failures'
    # drift traces bottom out at ~27-31 dB (the original 25 dB guess can
    # NEVER trip on them), and the gate-repair run at 34 dB vetoed the
    # drifting promotions and recovered +3.52 dB of a -4.10 dB failure
    # (SCALE_PROOF_r4.jsonl s7 512px probe_gate row; RESULTS.md round 5).
    drift_probe_warn_db: float = 34.0
    # PROBE-AWARE CHECKPOINT SELECTION (opt-in): when set, a keep_best
    # promotion is VETOED if the candidate's band-val improvement over
    # the reigning best is marginal (< drift_probe_gate_margin_db) while
    # its high-latitude probe render has moved more than the warn
    # threshold from the best-checkpoint reference — the long-schedule
    # signature (band-val creeps while |lat|>=25° degrades). Large
    # band-val improvements always promote: early training legitimately
    # moves everything. Validated round 5 on the reproduced 512px
    # over-training failure: gated keep_best 28.90 vs ungated 25.38
    # (parity 29.48) — a guardrail for schedules that over-run the
    # time-to-quality rule (MIGRATION.md), not a substitute for it.
    # Requires drift_probe_views > 0.
    drift_probe_gate: bool = False
    drift_probe_gate_margin_db: float = 1.0


class Trainer:
    def __init__(self, renderer, init_params, data: RayData,
                 loss_config: LossConfig = LossConfig(),
                 optim_config: OptimConfig = OptimConfig(),
                 trainer_config: TrainerConfig = TrainerConfig(),
                 workdir: str = './workdir', mesh=None,
                 logger: Optional[MetricsLogger] = None,
                 microbatch: Optional[int] = None,
                 spike_guard: Optional[float] = None,
                 device='cuda'):
        """init_params: a callable generator -> params (a system's init; the
        generator is a CPU torch.Generator seeded with trainer_config.seed,
        so the same seed gives the same init on every device), or the
        params themselves, as tensors or numpy arrays. device: 'cuda' (the
        default; raises when there is no card) or 'cpu'; on a mesh the
        mesh's device, which device must name. mesh: a
        parallel.mesh.Mesh; data's batches are then the global batches.
        microbatch: make_train_step's. A workdir holding a training
        checkpoint resumes from its newest one."""
        self.renderer = renderer
        self.data = data
        self.config = trainer_config
        self.workdir = workdir
        self.mesh = mesh
        self.chief = mesh is None or mesh.rank == 0
        self.device = _device(device if mesh is None else mesh_device(mesh, device))
        os.makedirs(workdir, exist_ok=True)

        self.optimizer = make_optimizer(optim_config)
        ema_decay = trainer_config.ema_decay or None
        self.step_fn = make_train_step(renderer, loss_config, self.optimizer,
                                       mesh=mesh, microbatch=microbatch,
                                       spike_guard=spike_guard,
                                       ema_decay=ema_decay)
        self.warmup_step_fn = None
        if trainer_config.tier_warmup_steps and renderer.tier_fraction:
            # the full-budget step for steps [0, tier_warmup_steps): the
            # same state, so the two step functions alternate freely
            self.warmup_step_fn = make_train_step(
                dataclasses.replace(renderer, tier_fraction=0.0), loss_config,
                self.optimizer, mesh=mesh, microbatch=microbatch,
                spike_guard=spike_guard, ema_decay=ema_decay)
        # a rank's rows of a chunk; _render_valid gathers the whole view
        self.eval_fn = make_eval_step(renderer)
        self.loss_config = loss_config

        params = (init_params(torch.Generator().manual_seed(trainer_config.seed))
                  if callable(init_params) else init_params)
        if renderer.occupancy is not None and 'occupancy' not in params:
            # pre-built params without the grid: add the fully occupied one,
            # so the renderer samples by occupancy and the update has a grid
            params = dict(params, occupancy=init_occupancy(renderer.occupancy, self.device))
        self.state = create_train_state(_to_device(params, self.device), self.optimizer,
                                        spike_guard=spike_guard is not None,
                                        ema=ema_decay is not None)
        restore_train_checkpoint(workdir, self.state)
        if mesh is not None:
            replicate(mesh, self.state)
            # read once, before any rank writes: rank 0's first promotion
            # writes the sidecar that another rank's later read would find
            self._best_val_psnr = self._best_psnr_high_water()

        self.logger = (logger or MetricsLogger(workdir)) if self.chief else _Silent()
        self.profile_summary = None
        self._valid_dev = None

        self._drift_probe = None
        self._probe_prev = None
        self._probe_at_best = None
        self._probe_best_val = -np.inf
        if trainer_config.drift_probe_gate and \
                not trainer_config.drift_probe_views:
            raise ValueError('drift_probe_gate requires drift_probe_views '
                             '> 0 (there is no probe to gate on)')
        if trainer_config.drift_probe_views:
            # observer distance / scene time / wavelength pinned from the
            # held-out view so the probe lives in the scene's own regime
            arrays = data.valid.arrays
            origins = np.asarray(arrays['rays'][:, 0])
            distance = float(np.median(np.linalg.norm(origins, axis=-1)))
            t_med = float(np.median(np.asarray(arrays['time'])))
            wl = arrays.get('wavelength')
            wl_val = float(np.asarray(wl).ravel()[0]) if wl is not None \
                else None
            from sunerf_tpu_torch.train.probe import DriftProbe
            self._drift_probe = DriftProbe(
                renderer, distance, time=t_med,
                n_views=trainer_config.drift_probe_views,
                resolution=trainer_config.drift_probe_resolution,
                lat_deg=trainer_config.drift_probe_lat_deg,
                wavelength=wl_val, device=self.device,
                batch_size=data.valid.batch_size)

    def _log_fit_start_overview(self):
        """Camera-pose quiver + sample-image strip at fit start (reference
        log_overview, train/callback.py:180-234, called from the data module
        at single_channel.py:32)."""
        overview = (self.data.extras or {}).get('overview')
        if not overview:
            return
        try:
            from sunerf_tpu_torch.train.visualization import log_overview
            path = os.path.join(self.workdir, 'overview.jpg')
            log_overview(overview['images'], overview['poses'],
                         overview['times'], path,
                         wavelength=self.data.config.get('wavelength'))
            self.logger.log_image('overview', path, 0)
        except Exception as e:  # diagnostics never kill training
            self.logger.log({'overview_failed': 1.0}, 0)
            logger.warning('overview plot failed: %s', e)

    def _log_ray_sampling(self, seed: int):
        """Stratified-vs-hierarchical sample-position diagnostic on a few
        held-out rays (reference plot_ray_sampling, callback.py:237-256)."""
        try:
            from sunerf_tpu_torch.train.step import step_generator
            from sunerf_tpu_torch.train.visualization import plot_ray_sampling
            arrays = self.data.valid.arrays
            n = min(32, next(iter(arrays.values())).shape[0])
            dev = lambda x: torch.as_tensor(np.asarray(x[:n])).to(self.device)  # noqa: E731
            rays = dev(arrays['rays'])
            wl = arrays.get('wavelength')
            with torch.no_grad():
                render = self.renderer(
                    self.state.params, rays[:, 0], rays[:, 1], dev(arrays['time']),
                    generator=step_generator(seed, 0, self.device),
                    wavelengths=None if wl is None else dev(wl))
            path = os.path.join(self.workdir, 'ray_sampling.jpg')
            plot_ray_sampling(render['z_vals_stratified'].cpu().numpy(),
                              render['z_vals_hierarchical'].cpu().numpy(), path)
            self.logger.log_image('ray_sampling', path, 0)
        except Exception as e:
            logger.warning('ray-sampling plot failed: %s', e)

    # ------------------------------------------------------------------ fit
    def fit(self):
        """Train from the state's step to total_steps. On SIGTERM the run
        checkpoints and returns at the next step (on a mesh, every rank at
        the same step); the process's previous SIGTERM handler is back in
        place whenever fit returns or raises. Only rank 0 profiles."""
        from sunerf_tpu_torch.utils.profiling import StepTimer, trace
        cfg = self.config
        start_step = int(self.state.step)
        train = self.data.train if self.mesh is None else ShardedRows(self.mesh,
                                                                      self.data.train)
        batches = iterate_batches(train, shuffle=True, seed=cfg.seed)
        size = 1 if self.mesh is None else self.mesh.size

        if start_step == 0:
            if self.chief:
                self._log_fit_start_overview()
                self._log_ray_sampling(cfg.seed + 1)
            # pre-training sanity render of the held-out view (reference
            # num_sanity_val_steps=-1, run_emission.py:70): a mis-wired run
            # shows a broken image immediately, not val_every steps later
            self.validate(0)

        # preemption handling: checkpoint on SIGTERM, then resume-from-last
        # recovers the run (SURVEY §5 — the reference has none)
        preempted = {'flag': False}

        def _on_sigterm(signum, frame):
            preempted['flag'] = True
        try:
            prev_handler = signal.signal(signal.SIGTERM, _on_sigterm)
        except ValueError:  # not the main thread
            prev_handler = None
        anomaly = torch.is_anomaly_enabled()
        profile_cm = None
        try:
            torch.autograd.set_detect_anomaly(cfg.debug_nans or anomaly)
            upload = _Uploader(self.device)
            timer = StepTimer()
            for step in range(start_step, cfg.total_steps):
                if cfg.profile_steps and self.chief:
                    if step == cfg.profile_start:
                        profile_cm = trace(os.path.join(self.workdir, 'profile'),
                                           self.device)
                        self.profile_summary = profile_cm.__enter__()
                        self.profile_summary['steps'] = [step, step + cfg.profile_steps]
                    elif profile_cm is not None and \
                            step == cfg.profile_start + cfg.profile_steps:
                        profile_cm.__exit__(None, None, None)
                        profile_cm = None
                        self.logger.log({f'profile_{k}': v for k, v in
                                         self.profile_summary.items()
                                         if isinstance(v, (int, float))}, step)
                        timer.reset()
                if (preempted['flag'] if self.mesh is None
                        else host_any(self.mesh, preempted['flag'])):
                    self.save(step)
                    self.logger.log({'preempted': 1.0}, step)
                    return self.state
                host_batch = next(batches)      # on a mesh, this rank's rows
                t0 = float(host_batch['time'].ravel()[0])
                batch = upload(host_batch)
                fn = (self.warmup_step_fn if self.warmup_step_fn is not None
                      and step < cfg.tier_warmup_steps else self.step_fn)
                self.state, metrics = fn(self.state, batch, cfg.seed)
                n_rays = host_batch['rays'].shape[0] * size    # the global batch's
                timer.tick(n_rays)
                occ = self.renderer.occupancy
                if occ is not None and (step + 1) >= occ.warmup \
                        and (step + 1) % occ.update_every == 0:
                    # the global batch's first time: rank 0's first row
                    self.update_occupancy(step, t0 if self.mesh is None
                                          else host_first(self.mesh, t0))

                if (step + 1) % cfg.log_every == 0:
                    n_steps = timer.count / n_rays
                    seconds = timer.seconds(sync_value=metrics['loss'])
                    m = {k: float(v) for k, v in metrics.items()}
                    m['rays_per_sec'] = timer.count / seconds if seconds > 0 else 0.0
                    m['step_ms'] = seconds * 1e3 / n_steps
                    if occ is not None:
                        # grid health beside the loss: a collapsing grid
                        # shows in its occupied fractions
                        for k, g in self.state.params['occupancy'].items():
                            m[f'{k}_frac'] = float((g > 0.5).float().mean())
                    if not np.isfinite(m['loss']):
                        raise FloatingPointError(
                            f'! [Numerical Alert] non-finite loss at step {step + 1}')
                    self.logger.log(m, step + 1)
                    timer.reset()

                if (step + 1) % cfg.val_every == 0:
                    self.validate(step + 1)
                    timer.reset()

                if (step + 1) % cfg.checkpoint_every == 0 or step + 1 == cfg.total_steps:
                    self.save(step + 1)
                    timer.reset()
            return self.state
        finally:
            if profile_cm is not None:
                profile_cm.__exit__(None, None, None)
            torch.autograd.set_detect_anomaly(anomaly)
            if prev_handler is not None:
                signal.signal(signal.SIGTERM, prev_handler)

    def update_occupancy(self, step: int, time: float, uniforms=None):
        """One EMA-max update of the occupancy grid from the fine field at
        `time`, written in place into params['occupancy']. The jitter is
        `uniforms` [Nr, Nt, Np, 3] when given, else drawn from
        step_generator(seed + 2, step), the counterpart of JAX's
        fold_in(key(seed + 2), step)."""
        r = self.renderer
        grid = update_occupancy(
            self.state.params['occupancy'], r.occupancy, r.field_apply,
            self.state.params['fine'], r.head.occupancy_activity,
            step_generator(self.config.seed + 2, step, self.device), time,
            solar_radius=r.solar_radius, uniforms=uniforms)
        copy_params(self.state.params['occupancy'], grid)

    # ------------------------------------------------------------- validate
    def _valid_arrays(self) -> dict:
        """The held-out view's rays, times (and wavelengths) on the device,
        uploaded once."""
        if self._valid_dev is None:
            self._valid_dev = {k: torch.as_tensor(np.asarray(v)).to(self.device)
                               for k, v in self.data.valid.arrays.items()
                               if k != 'target_image'}
        return self._valid_dev

    def _render_valid(self, params: dict) -> tuple:
        """The held-out view through the renderer with no jitter and no
        gradient, in chunks of the validation batch size; one host fetch.
        On a mesh each chunk is tiled over the ranks (the view padded with
        zero rays to whole chunks, as JAX's validation pads it) and one
        all-gather gives every rank the whole view. Returns (fine, coarse,
        height, absorption) as CPU tensors [n, ...]."""
        def render(chunk):
            out = self.eval_fn(params, chunk)
            return [torch.cat([out['fine_image'], out['coarse_image'],
                               out['height_map'][:, None], out['absorption_map'][:, None]],
                              dim=1)]
        host = render_tiled(self.mesh, self._valid_arrays(), self.data.valid.batch_size,
                            render)[0].cpu()
        c = (host.shape[1] - 2) // 2
        return host[:, :c], host[:, c:2 * c], host[:, 2 * c], host[:, 2 * c + 1]

    def validate(self, step: int) -> dict:
        """Re-render the held-out view and score it (reference
        TestImageCallback, train/callback.py:30-58)."""
        params = self.state.params
        arrays = self.data.valid.arrays
        fine, coarse, height, absorption = self._render_valid(params)
        pred = fine.numpy()
        target_t = torch.as_tensor(np.asarray(arrays['target_image']))
        target = target_t.numpy()
        height = height.numpy()
        absorption = absorption.numpy()
        pred_s = _asinh(self.loss_config, fine)
        target_s = _asinh(self.loss_config, target_t)
        coarse_s = _asinh(self.loss_config, coarse)

        h, w = self.data.validation_shape
        n_ch = pred.shape[-1]
        val = {'val_loss': float(np.mean((pred_s - target_s) ** 2))}
        # Degenerate-output sentinel: a (near-)zero prediction scores a
        # seed-independent scene constant that is easy to misread as a real
        # metric (the DT head's multiplicative parametrization collapses this
        # way when the pixel_intensity_factor leaves init predictions orders
        # of magnitude below the targets). Flag it loudly at the source.
        val['val_pred_absmax'] = float(np.abs(pred).max())
        if degenerate_prediction(pred, target):
            print(f'WARNING: validation prediction is (near-)zero '
                  f'(|pred|_max={val["val_pred_absmax"]:.3e} vs '
                  f'|target|_max={float(np.abs(target).max()):.3e}) — the '
                  f'val PSNR/SSIM below are the zero-output scene constant, '
                  f'not evidence of training. For DT heads check '
                  f'pixel_intensity_factor (reference default 1e17).',
                  flush=True)
            val['val_pred_degenerate'] = True
        psnrs, ssims = [], []
        for c in range(n_ch):
            p_img = pred_s[:, c].reshape(h, w)
            t_img = target_s[:, c].reshape(h, w)
            if np.all(t_img == 0):
                continue  # padded absent channel
            psnrs.append(psnr_metric(p_img, t_img))
            ssims.append(ssim_metric(p_img, t_img,
                                     data_range=float(t_img.max() - t_img.min() or 1)))
            if self.config.save_val_images and self.chief:
                wl_arr = arrays.get('wavelength')
                wl_c = (float(np.asarray(wl_arr)[0, c])
                        if wl_arr is not None and np.asarray(wl_arr).ndim == 2
                        and c < np.asarray(wl_arr).shape[1]
                        else self.data.config.get('wavelength'))
                self._save_val_image(p_img, t_img, step, c,
                                     coarse_s[:, c].reshape(h, w),
                                     height.reshape(h, w),
                                     absorption.reshape(h, w),
                                     wavelength=wl_c)
        # GT-free high-latitude probe render — computed BEFORE the keep_best
        # decision so drift_probe_gate can veto a marginal promotion whose
        # probe render has drifted (stability/drift metrics logged below)
        probe = None
        probe_drift = None
        if self._drift_probe is not None:
            from sunerf_tpu_torch.train.probe import probe_psnr
            probe = _asinh(self.loss_config, torch.from_numpy(self._drift_probe.render(params)))
            if self._probe_prev is not None:
                val['probe_stability_db'] = probe_psnr(probe,
                                                       self._probe_prev)
            if self._probe_at_best is not None:
                probe_drift = probe_psnr(probe, self._probe_at_best)
                val['probe_drift_since_best_db'] = probe_drift

        if psnrs:
            val['val_psnr'] = float(np.mean(psnrs))
            val['val_ssim'] = float(np.mean(ssims))
            # the candidate set for keep_best: live params, plus the
            # EMA-averaged variant when enabled (TrainerConfig.ema_decay)
            candidates = [('live', val['val_psnr'], params)]
            if self.state.ema_params is not None:
                ema = self._ema_render_params()
                pred_es = _asinh(self.loss_config, self._render_valid(ema)[0])
                psnrs_e, ssims_e = [], []
                for c in range(n_ch):
                    t_img = target_s[:, c].reshape(h, w)
                    if np.all(t_img == 0):
                        continue
                    p_img = pred_es[:, c].reshape(h, w)
                    psnrs_e.append(psnr_metric(p_img, t_img))
                    ssims_e.append(ssim_metric(
                        p_img, t_img,
                        data_range=float(t_img.max() - t_img.min() or 1)))
                if psnrs_e:
                    val['val_psnr_ema'] = float(np.mean(psnrs_e))
                    val['val_ssim_ema'] = float(np.mean(ssims_e))
                    candidates.append(('ema', val['val_psnr_ema'], ema))
            best_name, best_score, best_params = max(candidates,
                                                     key=lambda c: c[1])
            promote = (self.config.keep_best
                       and best_score > self._best_psnr_high_water())
            if (promote and self.config.drift_probe_gate
                    and probe_drift is not None
                    and probe_drift < self.config.drift_probe_warn_db
                    and best_score - self._best_psnr_high_water()
                        < self.config.drift_probe_gate_margin_db):
                # probe-aware selection: the candidate's band-val gain is
                # marginal while its |lat|=60° render has moved far from
                # the reigning best checkpoint's — the long-schedule drift
                # signature. Keep the old best; keep the probe reference
                # pinned to it (see the reference update below).
                promote = False
                val['probe_gate_rejected'] = 1.0
                print(f'drift_probe_gate at step {step}: keep_best '
                      f'promotion VETOED — band-val {best_score:.2f} is '
                      f'only +{best_score - self._best_psnr_high_water():.2f} '
                      f'dB over the best bundle while the high-latitude '
                      f'probe moved {probe_drift:.1f} dB from its render '
                      f'(< {self.config.drift_probe_warn_db:.0f} dB '
                      f'threshold). Retaining the previous best.',
                      flush=True)
            if promote:
                self._best_val_psnr = best_score
                config = self._bundle_config()
                # stamp the score into the bundle so a NEW Trainer on the
                # same workdir (preemption resume, two-phase annealing)
                # restores the high-water mark instead of clobbering the
                # best bundle with its first validation
                config['best_val_psnr'] = best_score
                config['best_variant'] = best_name
                if self.chief:
                    save_state(os.path.join(self.workdir, 'save_state_best'),
                               best_params, config)
                val['val_best_psnr'] = best_score

        if probe is not None:
            if probe_drift is not None:
                drift = probe_drift
                # the failure signature is band-val sitting NEAR its best
                # WITHOUT beating it while the probe drifts; a validation
                # that sets a new high-water replaces the reference render
                # anyway, and early training legitimately moves everything
                v = val.get('val_psnr', -np.inf)
                near_best = (v >= self._probe_best_val - 0.5
                             and v <= self._probe_best_val)
                if near_best and drift < self.config.drift_probe_warn_db:
                    print(f'WARNING: high-latitude drift probe at step '
                          f'{step}: band-val is within 0.5 dB of its best '
                          f'({val.get("val_psnr", float("nan")):.2f} vs '
                          f'{self._probe_best_val:.2f}) but the |lat|='
                          f'{self.config.drift_probe_lat_deg:.0f}° probe '
                          f'render has moved {drift:.1f} dB from the '
                          f'best-checkpoint render (< '
                          f'{self.config.drift_probe_warn_db:.0f} dB '
                          f'threshold) — the seed-8 long-schedule failure '
                          f'signature (RESULTS.md round-4 scale section). '
                          f'High-latitude renders from this run may be '
                          f'unreliable; prefer a milder sample budget '
                          f'(24+48) or inspect the probe images.',
                          flush=True)
                    val['probe_drift_warning'] = 1.0
                    # the evidence for the warning: current stack + the
                    # best-checkpoint reference it drifted from
                    if self.chief:
                            np.savez(os.path.join(self.workdir, f'probe_warn_{step:08d}.npz'),
                                 probe=probe, at_best=self._probe_at_best)
            # the probe reference tracks the best ACCEPTED checkpoint: a
            # gate-rejected candidate must not move it, or the drift
            # reference would creep along with the drifting field
            if val.get('val_psnr', -np.inf) > self._probe_best_val and \
                    not val.get('probe_gate_rejected'):
                self._probe_best_val = val['val_psnr']
                self._probe_at_best = probe
            self._probe_prev = probe

        self.logger.log(val, step)
        return val

    def _ema_render_params(self) -> dict:
        """The EMA params with the NON-learned leaves (the occupancy grid)
        taken from the live params: averaging the grid would lag the
        sampling distribution rather than smooth the field."""
        ema = dict(self.state.ema_params)
        if 'occupancy' in ema and 'occupancy' in self.state.params:
            ema['occupancy'] = self.state.params['occupancy']
        return ema

    def _best_psnr_high_water(self) -> float:
        """Best held-out PSNR seen by ANY Trainer on this workdir: in-memory
        if this instance already validated, else recovered from the existing
        save_state_best bundle (preemption resume / multi-phase schedules
        must not overwrite a better checkpoint with a worse first val)."""
        if hasattr(self, '_best_val_psnr'):
            return self._best_val_psnr
        sidecar = os.path.join(self.workdir, 'save_state_best.json')
        if os.path.exists(sidecar):
            try:
                with open(sidecar) as fh:
                    return float(json.load(fh).get('best_val_psnr', -np.inf))
            except (ValueError, OSError):
                return -np.inf
        return -np.inf

    def _save_val_image(self, pred, target, step, channel, coarse=None,
                        height=None, absorption=None, wavelength=None):
        """6-panel validation figure (reference TestImageCallback,
        train/callback.py:38-58): target / fine / coarse / |error| /
        emission-height map / absorption map. Without matplotlib it draws
        nothing."""
        try:
            import matplotlib
            matplotlib.use('Agg')
            import matplotlib.pyplot as plt
        except Exception:
            return
        from sunerf_tpu_torch.utils.colormaps import wavelength_cmap
        img_cmap = wavelength_cmap(wavelength)
        panels = [('target', target, img_cmap), ('fine', pred, img_cmap)]
        if coarse is not None:
            panels.append(('coarse', coarse, img_cmap))
        panels.append(('|error|', np.abs(pred - target), 'viridis'))
        if height is not None:
            panels.append(('height map', height, 'plasma'))
        if absorption is not None:
            panels.append(('absorption map', absorption, 'cividis'))
        n = len(panels)
        fig, axs = plt.subplots(1, n, figsize=(3 * n, 3.2))
        vmax = max(float(np.nanmax(target)), 1e-10)
        for ax, (title, img, cmap) in zip(np.atleast_1d(axs), panels):
            kw = dict(vmin=0, vmax=vmax) if cmap == img_cmap else {}
            ax.imshow(img, cmap=cmap, origin='lower', **kw)
            ax.set_title(title, fontsize=9)
            ax.axis('off')
        path = os.path.join(self.workdir,
                            f'val_{step:08d}_ch{channel}.jpg')
        fig.savefig(path, dpi=100, bbox_inches='tight')
        plt.close(fig)
        self.logger.log_image(f'val_image_ch{channel}', path, step)

    # ----------------------------------------------------------------- save
    def _bundle_config(self) -> dict:
        config = dict(self.data.config)
        if self.renderer.spec is not None:
            config['renderer_spec'] = self.renderer.spec
        return config

    def save(self, step: int):
        """The training checkpoint, then the deployment bundles:
        save_state (live params) and, with EMA, save_state_ema. On a mesh
        rank 0 writes them; the other ranks hold the same state."""
        if not self.chief:
            return
        save_train_checkpoint(self.workdir, self.state)
        config = self._bundle_config()
        save_state(os.path.join(self.workdir, 'save_state'), self.state.params, config)
        if self.state.ema_params is not None:
            # smoothed deployment variant (TrainerConfig.ema_decay)
            save_state(os.path.join(self.workdir, 'save_state_ema'),
                       self._ema_render_params(), config)
