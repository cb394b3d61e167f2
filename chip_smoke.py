"""Chip smoke test of the PyTorch / CUDA port (sunerf_tpu_torch) on one
NVIDIA H100: build the hand-written kernels from the sources in this checkout,
hold each against its plain PyTorch version on the card, serve the committed
8x512 emission bundle through the port's entry points, train the emission
system at bench.py's workload, and check what comes out.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

Phases (the first failure ends the run with a non-zero exit):
  1. build   nvcc builds csrc/fused_mlp_fwd_wgmma.cu (K0),
             fused_mlp_stash_fwd.cu (K1, K6a, K6b: K0's wgmma kernel with
             the stashes), fused_mlp_stash_bwd.cu (K2, K3: the wgmma chain
             and dW kernels; K6b's int8 dW_h), fused_mlp_recompute_bwd.cu
             (K4), grid_tap_encode.cu (P1) and grid_hat_encode.cu (P2) for
             sm_90a, and the two measurement-only 'lsb' ablation variants of
             fused_mlp_stash_bwd.cu, in parallel, and prints -Xptxas -v's
             registers and spills.
  2. kernel  K0 against fused_mlp_reference on the card, for the
             bundle's two fields at one render chunk's shapes (4096 rays x 60
             fine samples, x 20 coarse samples): per-point |kernel - plain| /
             max|plain| within 2e-2 at the 99.99th percentile, within 1e-1 at
             the maximum, RMS within 2e-3 (see KERNEL_TOL); times by CUDA
             events, median of 20 after warm-up.
     stash   K1 and K2 against their plain versions at the training step's
             shapes, random weights from a seed: 8x512 at N = 196,608 (fine)
             and 65,536 (coarse), 4x128 at 20,480. K1's out under K0's
             tolerances, and within K1_VS_K0_TOL of K0's own out (the same
             kernel, so the same bits); each layer of
             its sin stash within 1 bf16 ulp for 99.9% of entries and of its
             int8 cos stash within 1, against the plain version fed the
             kernel's upstream activations (free-running figures reported).
             K2, fed K1's stash and a seeded dy: every gradient within 3e-2
             of max|plain| (RMS reported); a second run bit-identical. Times
             of K1, K2 and the plain versions, median of 20; at the fine
             shape K2's kernels by name (prep, chain, dW, reductions) and the
             library yardstick of its dW part, one torch.bmm of the hidden
             layers' dW_h in bf16.
  3. render  SuNeRFLoader(bundle, device='cuda').render_observer_image at
             256x256 with the launch counts set to 0 just before: 16 chunks x
             (coarse + fine) = 32 launches of K0. Finite products; the image within
             3e-2 of max of the same render with the fields through the
             kernel's plain version on the card. The float32 render (TF32 off)
             is reported beside it: bf16 operands move this trained field's
             render far more than 3e-2, in the JAX package too. At the golden's
             32x32 view: the kernel's image within 3e-2 and the float32 image
             within 1e-2 of the JAX package's own renders
             (sunerf_tpu_torch/assets/s8_golden_32.npz).
  4. flyby   3 frames through evaluation.video.render_video_frames.
  5. train   bench.py's workload: make_emission_system() defaults (8x512 for
             both fields, 64 + 128 samples), LossConfig(), make_optimizer(),
             1024 rays. One step with the launch counts set to 0 just before:
             2 K1, 2 K2 and 0 K0 launches. One step (perturb off) against the
             same Function on the plain versions: loss within 1e-3 relative,
             every gradient within 3e-2 of max. 30 steps with the kernels and
             with the float32 field: finite losses, the kernel path's last
             below its first. Step time (CUDA events, median of 10 after 3
             warm-up steps), a torch.profiler step by kernel name, the peak
             of device memory.
  6. serve   the trained params saved as a bundle and rendered at 64x64 by
             SuNeRFLoader(device='cuda'): finite maps, K0 launches > 0.
  7. tune    3 training steps on the committed bundle at its own spec (8x512
             fine, 4x128 coarse, 20 + 40): finite losses, 2 K1 and 2 K2
             launches a step (one per field, at widths 512 and 128).
  7a. widths fields of widths outside KERNEL_WIDTHS, run zero-padded to the
             next kernel width, through fused_mlp_forward at N = 65,536:
             2x16, 2x32, 2x96 and 4x96: K0 (one launch, KERNEL_TOL against
             the plain version at the real width), K1 + K2 under autograd
             (one launch each, K1's out within K1_VS_K0_TOL of K0's, every
             gradient within GRAD_TOL of the plain path's, the same bits
             twice); at 2x32 K3, K4, K6a and K6b (their launches; gradients
             within GRAD_TOL, dpts within DPTS_TOL). Times beside the same
             calls of a field of the width each runs at, the plain versions'
             times, the bound of the real width's work and the pad's own
             time.
  7b. trainer  the committed bundle rendered at 256^2 from
             config/render_simple_star.yaml's 8 observers, written as FITS;
             `sunerf_tpu_torch.run_emission.main` at 8x512, 64 + 128, batch
             1024, 300 steps (validation every 150 with keep_best, EMA
             0.999, a 4-view 64^2 drift probe; 20 steps profiled): 2 K1 and
             2 K2 launches a step, K0 launches for validation, finite and
             falling losses, val_psnr at 300 above step 0's, save_state,
             save_state_ema and save_state_best each served at 64^2 through
             K0; a second main resumes at step 300 and logs 350; a 2x32 run
             (8 + 8 samples, 40 steps) on the padded kernels, loss falling.
             Prints the Trainer's ms/step over steps 51-300 beside [train]'s
             bare step, the profiled window's device idle share and the
             Rice decoder that loaded.
  7c. dt     the analytic SimpleStar rendered by the port's
             evaluation.image_render.render_observers at
             config/render_simple_star.yaml's 8 observers and pif (1e9), at
             256^2, over all seven AIA channels, as an aia / euvia / euvib
             FITS tree, with euvib's 94 and 131 directories removed (its rays
             carry 0 for them); `sunerf_tpu_torch.run_density_temperature.main`
             with config/DT_2012_11.yaml (8x512 DT field for both passes,
             64 + 128, batch 3072, pif 1e17) on that tree, cut to 300 steps
             (validation every 150 with keep_best, EMA 0.999, the 4-view 64^2
             drift probe pinned at 94 A): 2 K1 and 2 K2 launches a step, K0
             launches for validation, finite and falling losses, no
             degenerate validation, the three bundles each served at 64^2
             in seven finite channels, all-zero wavelengths rendering 0. One
             step from the run's first params and batch (perturb off) against
             the plain versions: loss within STEP_LOSS_TOL, every gradient
             within GRAD_TOL (the float32 field's figures beside); the
             trained fine field's raw at the 256^2 held-out view's fine
             samples, K0 against its plain version under KERNEL_TOL, and the
             seven-channel image from those samples within the bound derived
             at DT_RAW_TO_IMAGE; K0, K1 and K2 at the step's shapes (fine N =
             589,824, coarse 196,608) against their plain versions, as in
             2 (stash). Prints ms/step and rays/s over steps 51-300,
             validations excluded; the device idle share of 20 profiled
             Trainer steps (301-320, run after the checks); the head's share
             of a profiled step; the peak device memory of the run and of a
             step; max|dy| into K2 at step 1; val_psnr at 0, 150 and 300.
  7d. thomson  the analytic electron-density teacher of
             tests/test_end_to_end.py (observer at 4 Rs) renders its target
             for 1,024 rays; make_thomson_system() at 8x512, 64 + 128, trains
             100 steps on the kernels (the asinh-scaled loss, Adam's
             defaults) with sampling 'stratified' and then 'spherical': 2 K1 + 2 K2 launches a step, a falling loss, one
             step against the plain versions (STEP_LOSS_TOL, GRAD_TOL), the
             trained student's fine raw, K0 against the plain version under
             KERNEL_TOL, finite pixel_density, distance_from_sun and
             distance_from_obs.
  8. grid    K0, K1 and K2 with the dense feature-grid branch (K5) against
             their plain versions, random weights and U(-1, 1) tables from a
             seed, at bench.py grid_quarter's fine field (4x128, G = 16,
             F = 8, bound 1.3, N = 1024 x 72) and at the NGP recipe's
             (8x512, levels 16 + 32, N = 1024 x 192), and with five levels
             (4x128, levels 8, 12, 16, 24, 32, F = 8, N = 1024 x 72: any
             number of levels): K0/K1 out under
             KERNEL_TOL and K1 within K1_VS_K0_TOL of K0, the stash layer by
             layer, every gradient (the tables' included) within 3e-2 of max
             and bit-identical over two runs. Times of the three kernels with the grid, of K1 + K2 of
             the same widths without it, and of the plain versions; K2's
             kernels by name (K5's parts: grid_scatter_kernel,
             grid_convert_kernel, and the chain and prep kernels that carry
             its cotangent and features) and the library yardstick, one
             5-D torch.nn.functional.grid_sample a level, forward and
             forward + backward to d_table (timing rows, never on the path).
  9. gridtrain  bench.py grid_quarter, uncut: 4x128 fine field with a 16^3 x 8
             table, 4x128 proposal coarse field, 24 + 48 samples, 1024 rays.
             One step with the counts set to 0 just before: 2 K1, 2 K2,
             0 K0, 2 of them through the grid branch. One step against the
             plain path (loss 1e-3, grads 3e-2, grid_0 included); 30 steps
             with the kernels and with the float32 field (finite, falling,
             last losses within GRID_CURVE_TOL); step time, rays/s, profile.
 10. ngp     the MIGRATION.md instant-NGP recipe: 8x512, levels 16 + 32,
             table_lr_mult 10, adam_eps 1e-15, lambda_table_tv 1e-4, 64 + 128
             samples: launches of one step (4 through the grid branch),
             10 finite steps with a falling loss, step time, profile.
 11. gridserve  the trained grid_quarter state saved as a bundle and rendered
             at 256x256 by SuNeRFLoader(device='cuda'): 32 K0 launches, 16
             through the grid branch; the image within 3e-2 of max of the
             render through the plain version; render time.
 12. dpts    K1 + K2 with the point cotangent K3 at 8x512, N = 196,608
             (d_input 4 and 12), and 4x128, N = 20,480: dpts within 5e-2 of
             max of the plain version; the parameter gradients bit-identical
             to K2's without K3; K3's cost as K2-with-dpts minus K2; K2 + K3's
             kernels by name.
 13. recompute  K0 + K4 (stash=False) at 8x512, N = 262,144 through the
             autograd Function: out bit-identical to the no-grad K0; every
             gradient within 3e-2 and dpts within 5e-2 of max of the plain
             version; the same bits over two runs; K4 at d_input = 12 over
             two chunks (N = 65,536) held the same way; the growth of
             max_memory_allocated during the backward at N and 2N, the same
             within 5% and under a quarter of the int8 stash path's forward
             + backward growth at N; K4's kernels by name.
 14. lsb, i8pair  K6a / K6b at 8x512, N = 262,144: out bit-identical to K1's;
             the stash layer by layer (lsb within 1 bf16 ulp of the sine for
             99.9% with the sign bit off only where |cos| < 1e-3; i8pair
             within 1); every gradient within 3e-2 and dpts within 5e-2 of max
             of the plain version at the same group (768; the gradients'
             sha256 printed); i8pair also at groups 8, 16 and 24 (N = 4,097);
             times and bounds; each backward's kernels by name under
             torch.profiler; lsb's gate taken apart (as built, loaded but
             not decoded, decoded but not loaded:
             scripts/backward_ablation.py); i8pair's dW_h beside one bf16
             torch.bmm and seven torch._int_mm of the same product (timing
             rows, never on the path).
 15. bench_kernel  sunerf_tpu_torch/scripts/bench_kernel.py at N = 262,144, the
             launch counts set to 0 just before: its rows (K0, the three
             formats' fwd+bwd with K3 and fwd only, recompute fwd+bwd).
 16. probe_step  sunerf_tpu_torch/scripts/probe_step.py: bench.py's step under
             {}, {'stash': False}, {'stash_format': 'lsb'} and
             {'stash_format': 'i8pair'}: ms/step, rays/s, the launches of one
             step (e.g. stash=False: 2 K0 + 2 K4, no K1/K2); 30 steps from the
             same weights, finite and falling, the last loss within 1% of {}'s.
 17. grid_probes  sunerf_tpu_torch/scripts/probe_grid_taps.py (P1, N = 65,536,
             G = 32 and 64, F = 8) and probe_grid_hatbuild.py (P2, N =
             262,144, G = 32, F = 8, the three variants) at their defaults,
             the launch counts set to 0 just before; both --check modes on
             the card. P1 against its plain version at G = 32 and 64, N =
             65,536 and 262,144: max abs error within 1e-5; P2, each variant,
             at the script's shape: within 1e-2 of max|plain| + 1e-4, RMS
             within 1e-4 of max. Times of the kernels, the plain versions and
             torch.nn.functional.grid_sample (the yardstick: 5-D for P1, 4-D
             for P2) per call from CUDA graphs of 20 or more calls over input
             sets that exceed L2 (P2's plain version: events, median of 5);
             the P1 script's own
             time within 1.5x of the graph time at its shape. Beside P1's
             byte bound its L2 gather floor: 8 ceil(4 F / 32) sectors of 32
             bytes a point over the L2's rate for P1's gathers, measured at
             each shape by grid_probes.sector_read (P1's loads of random
             cells of the same table, without the arithmetic).
Then it prints the card's name and power limit, one {"kernels": [...]} line
(K0 with the widths it serves on the render path, K1, K2, K3,
K4, K5, K6a, K6b, P1 and P2) and, last, {"ok": true, "device": {...}}.
"""
import dataclasses
import hashlib
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

BUNDLE = 'artifacts_r4/s8_probe_rerun_best'
GOLDEN = 'sunerf_tpu_torch/assets/s8_golden_32.npz'
VIEW = dict(lat=0.3, lon=1.1, time=0.0, distance=215.0)
MAPS = ('image', 'height_map', 'absorption_map')
BF16_TFLOPS = 989.0          # H100 SXM dense bf16 tensor-core peak
HBM_TBPS = 3.35              # H100 SXM device memory rate
INT8_TOPS = 1979.0           # H100 SXM dense int8 tensor-core peak
F32_TFLOPS = 67.0            # H100 SXM float32 peak outside the tensor cores
KERNELS = ('fused_mlp_fwd_wgmma', 'fused_mlp_stash_fwd', 'fused_mlp_stash_bwd',
           'fused_mlp_recompute_bwd', 'grid_tap_encode', 'grid_hat_encode')
KEYS = ('w_in', 'b_in', 'w_h', 'b_h', 'w_out', 'b_out')
# K2's launches, by kernel name (the grid ones only with grid levels, the
# i8pair ones only for that format)
K2_KERNELS = ('prep_kernel', 'prep_grid_kernel', 'chain_wgmma_kernel', 'dw_wgmma_kernel',
              'reduce_kernel',
              'grid_scatter_kernel', 'grid_convert_kernel', 'dz_group_max_kernel',
              'dw_i8_wgmma_kernel')
DPTS_TOL = 5e-2
MEM_TOL = 5e-2                # K4's backward growth at 2N against N, relative
# the knob sets of the probe_step phase and the launches of one step
PROBE_KNOBS = (
    ({}, dict(LAUNCHES=0, STASH_FWD_LAUNCHES=2, STASH_BWD_LAUNCHES=2)),
    ({'stash': False}, dict(LAUNCHES=2, RECOMPUTE_BWD_LAUNCHES=2)),
    ({'stash_format': 'lsb'}, dict(STASH_FWD_LAUNCHES=2, STASH_BWD_LAUNCHES=2,
                                   LSB_LAUNCHES=4)),
    ({'stash_format': 'i8pair'}, dict(STASH_FWD_LAUNCHES=2, STASH_BWD_LAUNCHES=2,
                                      I8PAIR_LAUNCHES=4)),
)
PROBE_CURVE_TOL = 1e-2
# bench.py grid_quarter's fine field and the MIGRATION.md instant-NGP recipe
GRID_QUARTER = dict(n_layers=4, d_filter=128, grid_sizes=(16,), grid_features=8,
                    grid_bound=1.3)
NGP = dict(grid_sizes=(16, 32), grid_features=8, grid_bound=1.3)
# five levels of other sizes at grid_quarter's widths: any number of levels
GRID_FIVE = dict(n_layers=4, d_filter=128, grid_sizes=(8, 12, 16, 24, 32), grid_features=8,
                 grid_bound=1.3)
GRID_SHAPES = (('grid_quarter', GRID_QUARTER, 1024 * 72), ('ngp', NGP, 1024 * 192),
               ('five_levels', GRID_FIVE, 1024 * 72))
# the grid_quarter kernel path's last loss of 30 steps against the float32
# field's, relative
GRID_CURVE_TOL = 5e-2
# the stash checks' shapes: the training step's two fields at 8x512, and the
# bundle's 4x128 coarse field at one 1024-ray step of 20 samples
STASH_SHAPES = (('fine', 8, 512, 1024 * 192), ('coarse', 8, 512, 1024 * 64),
                ('proposal', 4, 128, 1024 * 20))
GRAD_TOL = 3e-2
# K6b's dz scale groups checked besides the default 768 (stash_bwd_tile)
I8PAIR_GROUPS = (8, 16, 24)
STEP_LOSS_TOL = 1e-3
N_CURVE = 30
# kernel vs plain version, per point, as fractions of max|plain|: the bulk
# (99.99% of points) within 2e-2 and RMS within 2e-3; any point within 1e-1.
# bf16 roundings that flip between the tensor cores' accumulation and
# cuBLAS's compound over this trained field's 8 layers, and a handful of
# hypersensitive points in 10^5 move by a few percent (the plain version on
# the CPU against itself on the card shows the float32-order floor).
KERNEL_TOL = 2e-2
KERNEL_RMS_TOL = 2e-3
KERNEL_MAX_TOL = 1e-1
# K1's out against K0's, per point, of max|K0|: the same function with the
# same bf16 operands; since K1 runs K0's wgmma kernel with its stashes in
# the epilogue the two are the same bits (the mma.sync K1 read up to 5.4e-7
# on an H100 at the stash shapes)
K1_VS_K0_TOL = 1e-5
RENDER_TOL = 3e-2
F32_GOLDEN_TOL = 1e-2
# the grid-encode probes: P1 at F = 8, G = 32 and 64, at its script's N and
# at bench_kernel's; P2 at its script's shape (N, G, F); bound 1.3 and
# points U(-1.2, 1.2) as both scripts draw them
TAP_SHAPES = tuple((g, n) for n in (65536, 262144) for g in (32, 64))
HAT_SHAPE = (262144, 32, 8)
PROBE_BOUND = 1.3
# P1 kernel vs plain, abs: the same float32 operations in the same order.
# P2, of max|plain|: within 1e-2 (+ 1e-4), RMS within 1e-4: the same bf16
# weights, float32 sums of four nonzero products in another order.
TAP_TOL = 1e-5
# a probe script's time (utils/profiling.timeit) over chip_smoke's graph time
SCRIPT_TIME_TOL = 1.5
HAT_TOL = 1e-2
HAT_RMS_TOL = 1e-4
# [widths]: fields of widths outside KERNEL_WIDTHS, run zero-padded to the
# next kernel width, at one step's worth of points
WIDTH_SHAPES = ((2, 16), (2, 32), (2, 96), (4, 96))
WIDTHS_N = 65536
# [trainer]: the committed bundle rendered at TRAINER_RES^2 from
# config/render_simple_star.yaml's 8 observers (data/synthetic.py
# synthesize_views) as the run's FITS views
TRAINER_RES = 256
TRAINER_STEPS = 300
TRAINER_BATCH = 1024
TRAINER_MODEL = {}        # the CLI's defaults: 8x512 for both fields
TRAINER_RENDERING = {}    # 64 + 128 samples
# [dt]: config/render_simple_star.yaml's observers (data/synthetic.py
# OBSERVERS) rendered at DT_RES^2 over every AIA channel; euvib loses
# DT_DROPPED; config/DT_2012_11.yaml cut to DT_STEPS
DT_RES = 256
DT_STEPS = 300
DT_DROPPED = ('euvib', (94, 131))
DT_CONFIG = 'config/DT_2012_11.yaml'
# the image from the K0 raw against the image from the plain raw, each
# channel as a fraction of its max: the head squares exp(raw0), so a raw
# error of d moves a sample's emission by a factor e^(2d), about 1 + 2d.
# The bound takes d as the K0 check's bulk allowance, KERNEL_TOL of
# max|raw|, read from the run: DT_IMAGE_TOL = exp(2 KERNEL_TOL max|raw|) - 1
# (the response's slope in log T, which raw1's error meets, is not in it)
DT_RAW_TO_IMAGE = 2.0
# [thomson]: the teacher's rays and the student's schedule
THOMSON_RAYS = 1024
THOMSON_STEPS = 100




def _rel(ref, got) -> float:
    ref, got = np.asarray(ref, np.float64), np.asarray(got, np.float64)
    return float(np.max(np.abs(ref - got)) / np.max(np.abs(ref)))


def _err_stats(ref: torch.Tensor, got: torch.Tensor) -> dict:
    """Per-point error of got against ref [N, d], as fractions of max|ref|."""
    ref, got = ref.double().cpu(), got.double().cpu()
    d = (got - ref).abs().amax(dim=1)
    m = float(ref.abs().max())
    return dict(max_abs_err=float(d.max()), max_rel_err=float(d.max()) / m,
                p9999_rel_err=float(torch.quantile(d, 0.9999)) / m,
                rms_rel_err=float((got - ref).pow(2).mean().sqrt()
                                  / ref.pow(2).mean().sqrt()),
                points_over_tol=int((d > KERNEL_TOL * m).sum()))


def _fmt(e: dict) -> str:
    return (f"max {e['max_rel_err']:.2e} p99.99 {e['p9999_rel_err']:.2e} rms "
            f"{e['rms_rel_err']:.2e} points>{KERNEL_TOL:g} {e['points_over_tol']}")


def _check(ok: bool, what: str):
    if not ok:
        raise SystemExit(f'chip_smoke FAILED: {what}')


def _cuda_ms(fn, warmup: int = 3, reps: int = 20) -> float:
    """Median of `reps` CUDA-event timings of fn() after `warmup` calls."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _graph_ms(fns, calls: int = 20, reps: int = 5) -> float:
    """Device ms of one call: `calls` calls, cycling through the callables
    `fns` (one per input set), captured in one CUDA graph, each output kept
    to the end so no two calls share one; the replay timed by CUDA events,
    median of `reps`, over the calls. Host dispatch, which dwarfs a kernel of
    a few microseconds, is left out; input sets that together exceed the
    50 MB L2 make each call find its inputs in device memory."""
    for f in fns[:2]:
        f()
    torch.cuda.synchronize()
    calls = max(calls, len(fns))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode='thread_local'):
        outs = [fns[i % len(fns)]() for i in range(calls)]
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    del outs, graph
    return statistics.median(times)


def _flops(cfg, n: int) -> float:
    h = cfg.d_filter
    return 2.0 * n * h * (cfg.d_encoded + (cfg.n_layers - 1) * h + cfg.d_output)


def _bound(flops: float, nbytes: float) -> tuple:
    """(least ms on the card, what bounds it): the larger of the operations
    at the bf16 tensor-core peak and the bytes at the device memory rate."""
    t_ops = flops / (BF16_TFLOPS * 1e12) * 1e3
    t_bytes = nbytes / (HBM_TBPS * 1e12) * 1e3
    return max(t_ops, t_bytes), ('operations' if t_ops >= t_bytes else 'bytes')


def _param_bytes(cfg) -> int:
    h = cfg.d_filter
    return 4 * ((cfg.d_encoded + 1) * h + (cfg.n_layers - 1) * (h + 1) * h
                + (h + 1) * cfg.d_output)


def _bwd_flops(cfg, n: int) -> float:
    """K2's operations: dW_h and dh, dW_in, dW_out and the first dh."""
    h = cfg.d_filter
    return float(n) * (4 * (cfg.n_layers - 1) * h * h + 2 * cfg.d_encoded * h
                       + 4 * cfg.d_output * h)


def _bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """|a - b| in units of the bf16 ulp of the larger magnitude."""
    af, bf = a.float(), b.float()
    m = torch.maximum(af.abs(), bf.abs()).clamp_min(2.0 ** -126)
    return (af - bf).abs() / torch.exp2(torch.floor(torch.log2(m)) - 7)


def _grad_err(ref: dict, got: dict) -> dict:
    """Per gradient: max |got - ref|, that over max|ref|, and RMS over RMS."""
    out = {}
    for k in ref:
        r, g = ref[k].double(), got[k].double()
        d = (g - r).abs()
        out[k] = dict(max_abs_err=float(d.max()),
                      max_rel_err=float(d.max() / r.abs().max().clamp_min(1e-30)),
                      rms_rel_err=float((g - r).pow(2).mean().sqrt()
                                        / r.pow(2).mean().sqrt().clamp_min(1e-30)))
    return out


def _stash_phase(name: str, n_layers: int, width: int, n: int, device) -> dict:
    """K1 and K2 against their plain versions at one shape (random weights
    and points from a seed); their times and bounds."""
    from sunerf_tpu_torch.models.fields import emission_config, init_nerf
    from sunerf_tpu_torch.ops import fused_mlp
    cfg = emission_config(n_layers=n_layers, d_filter=width)
    gen = torch.Generator(device=device).manual_seed(n)
    p = init_nerf(gen, cfg, device)
    pts = torch.rand(n, 4, generator=gen, device=device) * 2.6 - 1.3
    pts[:, 3] = 0.0
    dy = torch.randn(n, cfg.d_output, generator=gen, device=device)
    tag = f'[stash] {name} {n_layers}x{width} N={n}'

    out, hs, cs = fused_mlp.fused_mlp_stash_forward(cfg, p, pts)
    ref_out, ref_hs, ref_cs = fused_mlp.fused_mlp_stash_reference(cfg, p, pts)
    k0_out = fused_mlp.fused_mlp_forward(cfg, p, pts)
    lw_hs, lw_cs = fused_mlp.fused_mlp_stash_layerwise(cfg, p, pts, hs)
    torch.cuda.synchronize()
    _check(bool(torch.isfinite(out).all()), f'{tag}: non-finite K1 output')
    err = _err_stats(ref_out, out)
    vs_k0 = _err_stats(k0_out, out)
    hs_ulp1 = float((_bf16_ulps(lw_hs, hs) <= 1).float().mean())
    cs_diff = int((cs.int() - lw_cs.int()).abs().max())
    free_hs_ulp1 = float((_bf16_ulps(ref_hs, hs) <= 1).float().mean())
    free_cs_diff = (cs.int() - ref_cs.int()).abs()
    free_cs = dict(max=int(free_cs_diff.max()),
                   share_off=float((free_cs_diff > 0).float().mean()))
    print(f'{tag}: K1 out vs plain {_fmt(err)}; vs K0 {_fmt(vs_k0)} (tol max '
          f'{K1_VS_K0_TOL:g})', flush=True)
    _check(vs_k0['max_rel_err'] <= K1_VS_K0_TOL, f'{tag}: K1 vs K0 {_fmt(vs_k0)}')
    print(f'{tag}: K1 sin stash within 1 ulp of the layerwise plain version '
          f'{hs_ulp1:.6f} (free-running {free_hs_ulp1:.6f}); int8 cos max |diff| '
          f'{cs_diff} (free-running max {free_cs["max"]}, '
          f'{free_cs["share_off"]:.2e} of entries off)', flush=True)
    _check(err['p9999_rel_err'] <= KERNEL_TOL and err['rms_rel_err'] <= KERNEL_RMS_TOL
           and err['max_rel_err'] <= KERNEL_MAX_TOL, f'{tag}: K1 out vs plain {_fmt(err)}')
    _check(hs_ulp1 >= 0.999, f'{tag}: K1 sin stash within 1 ulp for {hs_ulp1:.6f}')
    _check(cs_diff <= 1, f'{tag}: K1 int8 cos stash off by {cs_diff}')
    del ref_hs, ref_cs, lw_hs, lw_cs, free_cs_diff

    grads = fused_mlp.fused_mlp_stash_backward(cfg, p, pts, dy, hs, cs)
    again = fused_mlp.fused_mlp_stash_backward(cfg, p, pts, dy, hs, cs)
    ref = fused_mlp.fused_mlp_stash_bwd_reference(cfg, p, pts, dy, hs, cs)
    torch.cuda.synchronize()
    gerr = _grad_err(ref, grads)
    identical = all(torch.equal(grads[k], again[k]) for k in KEYS)
    spread = max(float((grads[k] - again[k]).abs().max()) for k in KEYS)
    print(f'{tag}: K2 vs plain, max / RMS over max|plain| / RMS: ' + '; '.join(
        f"{k} {e['max_rel_err']:.2e} / {e['rms_rel_err']:.2e}" for k, e in gerr.items())
        + f'; two runs bit-identical: {identical} (spread {spread:.3e})', flush=True)
    for k, e in gerr.items():
        _check(bool(torch.isfinite(grads[k]).all()), f'{tag}: K2 {k} not finite')
        _check(e['max_rel_err'] <= GRAD_TOL,
               f"{tag}: K2 {k} vs plain {e['max_rel_err']:.3e} (tol {GRAD_TOL})")
    _check(identical, f'{tag}: K2 gradients differ over two runs (spread {spread})')
    detail = {}
    if name == 'fine':
        # where K2's time goes, and the library yardstick of its dW part: one
        # torch.bmm of the hidden layers' dW_h = hs_{j-1}^T dz_j in bf16 (K1's
        # stash, the plain version's dz), both made contiguous untimed
        detail['kernels'] = _kernel_breakdown(
            lambda: fused_mlp.fused_mlp_stash_backward(cfg, p, pts, dy, hs, cs), f'{tag} K2')
        dzs = []
        fused_mlp.fused_mlp_stash_bwd_reference(cfg, p, pts, dy, hs, cs, dzs=dzs)
        L = cfg.n_layers
        hs_t = hs.view(n, L, width)[:, :L - 1].permute(1, 2, 0).contiguous()
        dz = torch.stack(dzs[1:]).to(torch.bfloat16)
        detail['dw_h_bmm_ms'] = _cuda_ms(lambda: torch.bmm(hs_t, dz))
        print(f"{tag}: dW_h as one torch.bmm {detail['dw_h_bmm_ms']:.3f} ms", flush=True)
        del dzs, hs_t, dz

    k1_ms = _cuda_ms(lambda: fused_mlp.fused_mlp_stash_forward(cfg, p, pts))
    k1_plain_ms = _cuda_ms(lambda: fused_mlp.fused_mlp_stash_reference(cfg, p, pts))
    k2_ms = _cuda_ms(lambda: fused_mlp.fused_mlp_stash_backward(cfg, p, pts, dy, hs, cs))
    k2_plain_ms = _cuda_ms(
        lambda: fused_mlp.fused_mlp_stash_bwd_reference(cfg, p, pts, dy, hs, cs))
    stash_bytes = n * cfg.n_layers * width * 3
    io_bytes = n * 4 * (cfg.d_input + cfg.d_output)
    k1_bound, k1_by = _bound(_flops(cfg, n), io_bytes + stash_bytes + _param_bytes(cfg))
    k2_bound, k2_by = _bound(_bwd_flops(cfg, n),
                             io_bytes + stash_bytes + 2 * _param_bytes(cfg))
    # the two-pass design's own floor: the chain reads the int8 gates and
    # hs_{L-1} and writes dz; the dW products read hs_{0..L-2} and dz
    L, h = cfg.n_layers, width
    two_pass_ms = n * (L * h + 2 * h + 2 * L * h + 2 * (L - 1) * h + 2 * L * h) \
        / (HBM_TBPS * 1e12) * 1e3
    print(f'{tag}: K1 {k1_ms:.3f} ms (plain {k1_plain_ms:.3f}, bound {k1_bound:.3f} '
          f'by {k1_by}); K2 {k2_ms:.3f} ms (plain {k2_plain_ms:.3f}, bound '
          f'{k2_bound:.3f} by {k2_by}, two-pass byte floor {two_pass_ms:.3f})', flush=True)
    return {
        'k1': dict(n=n, layers=n_layers, width=width, ms=k1_ms, plain_ms=k1_plain_ms,
                   bound_ms=k1_bound, bound_by=k1_by, **err, vs_k0=vs_k0,
                   hs_within_1ulp_layerwise=hs_ulp1, hs_within_1ulp_free=free_hs_ulp1,
                   cs_max_diff_layerwise=cs_diff, cs_free=free_cs),
        'k2': dict(n=n, layers=n_layers, width=width, ms=k2_ms, plain_ms=k2_plain_ms,
                   bound_ms=k2_bound, bound_by=k2_by, **detail,
                   max_abs_err=max(e['max_abs_err'] for e in gerr.values()),
                   max_rel_err=max(e['max_rel_err'] for e in gerr.values()),
                   grads=gerr, bit_identical=identical, run_spread=spread),
    }


class _PlainStash(torch.autograd.Function):
    """FusedMLPStash's twin on the kernels' plain versions: the same
    forward, stash and backward arithmetic through PyTorch ops (weights in
    fused_mlp.param_keys order, grid tables included)."""

    @staticmethod
    def forward(ctx, config, points, *weights):
        from sunerf_tpu_torch.ops import fused_mlp
        out, hs, cs = fused_mlp.fused_mlp_stash_reference(
            config, dict(zip(fused_mlp.param_keys(config), weights)), points)
        ctx.config = config
        ctx.save_for_backward(points, hs, cs, *weights)
        return out

    @staticmethod
    def backward(ctx, dy):
        from sunerf_tpu_torch.ops import fused_mlp
        points, hs, cs, *weights = ctx.saved_tensors
        keys = fused_mlp.param_keys(ctx.config)
        g = fused_mlp.fused_mlp_stash_bwd_reference(
            ctx.config, dict(zip(keys, weights)), points, dy.contiguous(), hs, cs)
        return (None, None, *(g[k] for k in keys))


def _plain_field(cfg):
    """A field_apply through _PlainStash (grads) or K0's plain version."""
    from sunerf_tpu_torch.models.fields import FieldOutput
    from sunerf_tpu_torch.ops import fused_mlp
    return lambda p, x: FieldOutput(raw=_PlainStash.apply(
        cfg, x, *(p[k] for k in fused_mlp.param_keys(cfg))))


def _bench_batch(device, n: int = 1024, seed: int = 1) -> dict:
    """bench.py's batch, made with numpy: rays from (4, 0, 0) toward -x with
    0.15 normal jitter, normalized; time 0; target 0.05."""
    rng = np.random.default_rng(seed)
    rays_o = np.tile(np.array([[4.0, 0.0, 0.0]], np.float32), (n, 1))
    dirs = np.array([[-1.0, 0.0, 0.0]]) + 0.15 * rng.normal(size=(n, 3))
    rays_d = (dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)).astype(np.float32)
    return {'rays': torch.from_numpy(np.stack([rays_o, rays_d], axis=1)).to(device),
            'time': torch.zeros((n, 1), device=device),
            'target_image': torch.full((n, 1), 0.05, device=device)}


def _loss_and_grads(renderer, params: dict, batch: dict) -> tuple:
    from sunerf_tpu_torch.train.objective import LossConfig, render_loss
    p = {f: {k: v.detach().clone().requires_grad_() for k, v in sub.items()}
         for f, sub in params.items()}
    rays = batch['rays']
    out = renderer(p, rays[:, 0], rays[:, 1], batch['time'])
    loss, _ = render_loss(LossConfig(), out, batch['target_image'])
    loss.backward()
    return float(loss.detach()), {f: {k: v.grad for k, v in sub.items()}
                                  for f, sub in p.items()}


def _step_times(step, state, batch, warmup: int = 3, reps: int = 10) -> float:
    """Median CUDA-event time of one whole train step, optimizer included."""
    for _ in range(warmup):
        step(state, batch, 0)
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        step(state, batch, 0)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _profile_step(step, state, batch, tag: str) -> dict:
    """One step under torch.profiler: device time by kernel, K0/K1/K2 (the
    grid branch inside them) and the rest, against the step's wall time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, batch, 0)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    parts = {'K1': 0.0, 'K2': 0.0, 'K0': 0.0, 'other': 0.0}
    by_kernel = {}
    for evt in prof.events():
        # kernels only: a user annotation (Optimizer.step#Adam.step) spans
        # kernels that are counted on their own
        if (evt.device_type != torch.autograd.DeviceType.CUDA
                or getattr(evt, 'is_user_annotation', False) or '#' in evt.name):
            continue
        ms = evt.device_time / 1e3
        by_kernel[evt.name] = by_kernel.get(evt.name, 0.0) + ms
        # the wgmma forward with no stash (template kFmt 0) is K0, with one K1
        fwd = re.search(r'fwd_wgmma_kernel<\d+, (\d)>', evt.name)
        if fwd and fwd.group(1) == '0':
            parts['K0'] += ms
        elif fwd:
            parts['K1'] += ms
        elif any(k in evt.name for k in K2_KERNELS):
            parts['K2'] += ms
        else:
            parts['other'] += ms
    device_ms = sum(parts.values())
    row = dict(wall_ms=wall_ms, device_ms=device_ms, idle_share=1 - device_ms / wall_ms,
               **{f'{k}_ms': v for k, v in parts.items()},
               top={k[:70]: v for k, v in sorted(by_kernel.items(),
                                                key=lambda kv: -kv[1])[:10]})
    print(f'[profile] {tag}: {wall_ms:.2f} ms wall, {device_ms:.2f} ms of device '
          f'kernels (K1 {parts["K1"]:.2f}, K2 {parts["K2"]:.2f}, other {parts["other"]:.2f}); '
          f'device idle {row["idle_share"]:.1%}; top: ' + '; '.join(
              f'{k[:50]} {v:.3f} ms' for k, v in list(row['top'].items())[:8]),
          flush=True)
    return row


def _train_phase(device) -> dict:
    from sunerf_tpu_torch.models.fields import emission_config
    from sunerf_tpu_torch.ops import fused_mlp
    from sunerf_tpu_torch.systems import make_emission_system
    from sunerf_tpu_torch.train.objective import LossConfig
    from sunerf_tpu_torch.train.optim import make_optimizer
    from sunerf_tpu_torch.train.step import create_train_state, make_train_step

    cfg = emission_config()
    renderer, init = make_emission_system(device='cuda')
    params = init(torch.Generator(device=device).manual_seed(0))
    batch = _bench_batch(device)
    opt = make_optimizer()
    step = make_train_step(renderer, LossConfig(), opt)
    state = create_train_state(params, opt)
    step(state, batch, 0)                       # warm-up: libraries loaded
    torch.cuda.synchronize()
    fused_mlp.LAUNCHES = fused_mlp.STASH_FWD_LAUNCHES = fused_mlp.STASH_BWD_LAUNCHES = 0
    _, m = step(state, batch, 0)
    launches = {'k0': fused_mlp.LAUNCHES, 'k1': fused_mlp.STASH_FWD_LAUNCHES,
                'k2': fused_mlp.STASH_BWD_LAUNCHES}
    print(f'[train] one step: {launches["k1"]} K1, {launches["k2"]} K2, '
          f'{launches["k0"]} K0 launches (expected 2, 2, 0); loss {float(m["loss"]):.6f}',
          flush=True)
    _check(launches == {'k0': 0, 'k1': 2, 'k2': 2},
           f'train step launches {launches}, not 2 K1, 2 K2, 0 K0')

    # one step against the plain path: perturb off, the same params and batch
    fixed, _ = make_emission_system(device='cuda', perturb=False)
    plain = dataclasses.replace(fixed, field_apply=_plain_field(cfg))
    loss_k, grads_k = _loss_and_grads(fixed, params, batch)
    loss_p, grads_p = _loss_and_grads(plain, params, batch)
    vs_plain = {'loss': loss_k, 'plain_loss': loss_p,
                'loss_rel_err': abs(loss_k - loss_p) / abs(loss_p),
                'grads': {f: _grad_err(grads_p[f], grads_k[f]) for f in grads_p}}
    print(f'[train] one step vs the plain path: loss {loss_k:.7f} vs {loss_p:.7f} '
          f'(rel {vs_plain["loss_rel_err"]:.2e}, tol {STEP_LOSS_TOL}); grads max/max: '
          + '; '.join(f"{f}/{k} {e['max_rel_err']:.2e}" for f, g in vs_plain['grads'].items()
                      for k, e in g.items()), flush=True)
    _check(vs_plain['loss_rel_err'] <= STEP_LOSS_TOL,
           f"train loss vs plain {vs_plain['loss_rel_err']:.3e}")
    for f, g in vs_plain['grads'].items():
        for k, e in g.items():
            _check(e['max_rel_err'] <= GRAD_TOL,
                   f"train grad {f}/{k} vs plain {e['max_rel_err']:.3e} (tol {GRAD_TOL})")
    del grads_k, grads_p

    # 30 steps with the kernels and with the float32 field
    curves, states, steps = {}, {}, {}
    for path, use_fused in (('kernel', True), ('float32', False)):
        r, _ = make_emission_system(device='cuda', use_fused=use_fused)
        steps[path] = make_train_step(r, LossConfig(lambda_regularization=0.0), opt)
        states[path] = create_train_state(params, opt)
        losses = [steps[path](states[path], batch, 0)[1]['loss'] for _ in range(N_CURVE)]
        curves[path] = [float(v) for v in losses]
        print(f'[train] {N_CURVE} steps, {path}: ' + ' '.join(f'{v:.5f}' for v in curves[path]),
              flush=True)
        _check(all(np.isfinite(curves[path])), f'{path} losses not finite')
    _check(curves['kernel'][-1] < curves['kernel'][0],
           f"kernel path loss did not fall: {curves['kernel'][0]} -> {curves['kernel'][-1]}")
    gap = abs(curves['kernel'][-1] - curves['float32'][-1]) / curves['float32'][-1]
    print(f'[train] last loss: kernel {curves["kernel"][-1]:.6f}, float32 '
          f'{curves["float32"][-1]:.6f} ({gap:.1%} apart)', flush=True)

    step_ms = _step_times(step, state, batch)
    f32_ms = _step_times(steps['float32'], states['float32'], batch)
    print(f'[train] step: kernel path {step_ms:.2f} ms ({1024 / step_ms * 1e3:.0f} rays/s); '
          f'float32 path {f32_ms:.2f} ms ({1024 / f32_ms * 1e3:.0f} rays/s) (CUDA events, '
          f'median of 10 after 3 warm-up steps)', flush=True)
    del states, steps

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step(state, batch, 0)
    torch.cuda.synchronize()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f'[train] peak device memory of a kernel-path step: {peak_gib:.2f} GiB',
          flush=True)

    profile_row = _profile_step(step, state, batch, 'train step')
    return dict(launches=launches, vs_plain=vs_plain, curves=curves, step_ms=step_ms,
                rays_per_s=1024 / step_ms * 1e3, f32_step_ms=f32_ms,
                peak_gib=peak_gib, profile=profile_row, renderer=renderer, state=state)


def _serve_phase(renderer, state):
    """The trained params as a bundle, rendered by the port's loader."""
    from sunerf_tpu_torch.evaluation.loader import SuNeRFLoader
    from sunerf_tpu_torch.ops import fused_mlp
    from sunerf_tpu_torch.utils.checkpoint import save_state
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, 'trained')
        save_state(path, state.params, {'renderer_spec': renderer.spec})
        fused_mlp.LAUNCHES = 0
        view = SuNeRFLoader(path, device='cuda').render_observer_image(
            lat=0.3, lon=1.1, time=0.0, distance=4.0, resolution=64)
        launches = fused_mlp.LAUNCHES
    print(f'[serve] trained bundle rendered at 64x64: {launches} K0 launches, image '
          f'max {float(np.max(view.image)):.4g}', flush=True)
    for k in MAPS:
        _check(bool(np.isfinite(getattr(view, k)).all()), f'served {k} not finite')
    _check(launches > 0, 'the served render launched no K0')


def _tune_phase(device, gview: dict, g_view) -> list:
    """3 steps on the committed bundle at its own spec; rays of the golden
    view, its own kernel render as the target."""
    from sunerf_tpu_torch.core.geometry import observer_rays
    from sunerf_tpu_torch.models.fields import params_from_numpy
    from sunerf_tpu_torch.ops import fused_mlp
    from sunerf_tpu_torch.systems import from_spec
    from sunerf_tpu_torch.train.objective import LossConfig
    from sunerf_tpu_torch.train.optim import make_optimizer
    from sunerf_tpu_torch.train.step import create_train_state, make_train_step
    from sunerf_tpu_torch.utils.checkpoint import load_state
    params_np, cfg = load_state(BUNDLE)
    renderer, _ = from_spec(cfg['renderer_spec'], device='cuda')
    rays_o, rays_d = observer_rays(gview['lat'], gview['lon'], gview['distance'],
                                   gview['resolution'])
    n = rays_o.shape[0] * rays_o.shape[1]
    batch = {'rays': torch.from_numpy(np.stack([rays_o.reshape(n, 3), rays_d.reshape(n, 3)],
                                               axis=1)).float().to(device),
             'time': torch.full((n, 1), gview['time'], device=device),
             'target_image': torch.from_numpy(g_view.image.reshape(n, -1)).to(device)}
    opt = make_optimizer()
    state = create_train_state(params_from_numpy(params_np, device), opt)
    step = make_train_step(renderer, LossConfig(), opt)
    fused_mlp.LAUNCHES = fused_mlp.STASH_FWD_LAUNCHES = fused_mlp.STASH_BWD_LAUNCHES = 0
    losses = [float(step(state, batch, 0)[1]['loss']) for _ in range(3)]
    launches = (fused_mlp.STASH_FWD_LAUNCHES, fused_mlp.STASH_BWD_LAUNCHES,
                fused_mlp.LAUNCHES)
    print(f'[tune] bundle, {n} rays, 3 steps: losses ' + ' '.join(f'{v:.6f}' for v in losses)
          + f'; K1, K2, K0 launches {launches} (expected 6, 6, 0)', flush=True)
    _check(all(np.isfinite(losses)), 'fine-tune losses not finite')
    _check(launches == (6, 6, 0), f'fine-tune launches {launches}, not 6 K1, 6 K2, 0 K0')
    return losses


_COUNTERS = ('LAUNCHES', 'STASH_FWD_LAUNCHES', 'STASH_BWD_LAUNCHES', 'DPTS_LAUNCHES',
             'RECOMPUTE_BWD_LAUNCHES', 'LSB_LAUNCHES', 'I8PAIR_LAUNCHES')


def _zero_counters():
    from sunerf_tpu_torch.ops import fused_mlp
    for c in _COUNTERS:
        setattr(fused_mlp, c, 0)


def _counters() -> dict:
    from sunerf_tpu_torch.ops import fused_mlp
    return {c: getattr(fused_mlp, c) for c in _COUNTERS if getattr(fused_mlp, c)}


def _autograd(cfg, p, pts, dy, **knobs) -> tuple:
    """out and the gradients of sum(dy * out) through fused_mlp_forward
    (the padded kernels for a width outside KERNEL_WIDTHS), 'dpts' when the
    points get one."""
    from sunerf_tpu_torch.ops import fused_mlp
    leaves = {k: v.detach().clone().requires_grad_() for k, v in p.items()}
    x = pts.clone().requires_grad_()
    out = fused_mlp.fused_mlp_forward(cfg, leaves, x, **knobs)
    out.backward(dy)
    grads = {k: v.grad for k, v in leaves.items()}
    if x.grad is not None:
        grads['dpts'] = x.grad
    return out.detach(), grads


def _width_row(layers: int, width: int, n: int, device) -> dict:
    """K0, then K1 + K2, at one width through fused_mlp_forward, against
    the plain versions at the real width; the times beside the same calls
    of a field of the kernel width it runs at."""
    from sunerf_tpu_torch.ops import fused_mlp
    cfg, p, pts, dy = _setup_field(layers, width, n, device, seed=width + layers)
    run_width = fused_mlp.kernel_width(width)
    tag = f'[widths] {layers}x{width} (runs at {run_width}) N={n}'
    _zero_counters()
    with torch.no_grad():
        out = fused_mlp.fused_mlp_forward(cfg, p, pts)
    k0_launches = _counters()
    ref = fused_mlp.fused_mlp_reference(cfg, p, pts)
    err = _err_stats(ref, out)
    _zero_counters()
    out1, grads = _autograd(cfg, p, pts, dy, compute_dpts=False)
    k12_launches = _counters()
    out_p, grads_p = _autograd(cfg, p, pts, dy, compute_dpts=False)   # again: the bits
    same = all(torch.equal(grads[k], grads_p[k]) for k in grads)
    leaves = [v.detach().clone().requires_grad_() for v in p.values()]
    plain_out = _PlainStash.apply(cfg, pts, *leaves)
    plain_out.backward(dy)
    gerr = _grad_err({k: v.grad for k, v in zip(p, leaves)}, grads)
    torch.cuda.synchronize()
    print(f'{tag}: K0 launches {k0_launches}, K1 + K2 launches {k12_launches}; K0 vs plain '
          f'{_fmt(err)}; K1 out vs K0 {_rel(out.cpu(), out1.cpu()):.2e}; K2 vs plain, max: '
          + '; '.join(f"{k} {e['max_rel_err']:.2e}" for k, e in gerr.items())
          + f'; two runs bit-identical: {same}', flush=True)
    _check(k0_launches == {'LAUNCHES': 1}, f'{tag}: K0 launches {k0_launches}')
    _check(k12_launches == {'STASH_FWD_LAUNCHES': 1, 'STASH_BWD_LAUNCHES': 1},
           f'{tag}: K1 + K2 launches {k12_launches}')
    _check(bool(torch.isfinite(out).all()), f'{tag}: K0 output not finite')
    _check(err['p9999_rel_err'] <= KERNEL_TOL and err['rms_rel_err'] <= KERNEL_RMS_TOL
           and err['max_rel_err'] <= KERNEL_MAX_TOL, f'{tag}: K0 vs plain {_fmt(err)}')
    _check(_rel(out.cpu(), out1.cpu()) <= K1_VS_K0_TOL, f'{tag}: K1 out vs K0')
    for k, e in gerr.items():
        _check(bool(torch.isfinite(grads[k]).all()), f'{tag}: {k} not finite')
        _check(e['max_rel_err'] <= GRAD_TOL, f"{tag}: {k} vs plain {e['max_rel_err']:.3e}")
    _check(same, f'{tag}: K2 gradients differ over two runs')
    del grads_p, plain_out, leaves

    # times: this width (pads included) beside a field of the width it runs
    # at, and the plain versions
    wide, wp, _, _ = _setup_field(layers, run_width, n, device, seed=1)
    with torch.no_grad():
        k0_ms = _cuda_ms(lambda: fused_mlp.fused_mlp_forward(cfg, p, pts))
        k0_wide_ms = _cuda_ms(lambda: fused_mlp.fused_mlp_forward(wide, wp, pts))
        k0_plain_ms = _cuda_ms(lambda: fused_mlp.fused_mlp_reference(cfg, p, pts))
    step_ms = _cuda_ms(lambda: _autograd(cfg, p, pts, dy, compute_dpts=False), reps=10)
    step_wide_ms = _cuda_ms(lambda: _autograd(wide, wp, pts, dy, compute_dpts=False), reps=10)

    def plain_step():
        lv = [v.detach().clone().requires_grad_() for v in p.values()]
        _PlainStash.apply(cfg, pts, *lv).backward(dy)
    step_plain_ms = _cuda_ms(plain_step, warmup=1, reps=5)
    leaves = {k: v.detach().clone().requires_grad_() for k, v in p.items()}
    pad_ms = _cuda_ms(lambda: fused_mlp.pad_field(cfg, leaves))
    io = n * 4 * (cfg.d_input + cfg.d_output)
    k0_bound = _bound(_flops(cfg, n), io + _param_bytes(cfg))
    stash_bytes = n * cfg.n_layers * width * 3
    k12_bound = _bound(_flops(cfg, n) + _bwd_flops(cfg, n),
                       2 * io + 2 * stash_bytes + 3 * _param_bytes(cfg))
    print(f'{tag}: K0 {k0_ms:.3f} ms (at width {run_width} {k0_wide_ms:.3f}; plain '
          f'{k0_plain_ms:.3f}; bound of the real width {k0_bound[0]:.4f} by {k0_bound[1]}); '
          f'K1 + K2 under autograd {step_ms:.3f} ms (at width {run_width} {step_wide_ms:.3f}; '
          f'plain {step_plain_ms:.3f}; bound {k12_bound[0]:.4f} by {k12_bound[1]}); the pad '
          f'alone {pad_ms:.4f} ms', flush=True)
    return dict(layers=layers, width=width, runs_at=run_width, n=n,
                k0=dict(ms=k0_ms, ms_at_run_width=k0_wide_ms, plain_ms=k0_plain_ms,
                        bound_ms=k0_bound[0], bound_by=k0_bound[1], **err,
                        launches=k0_launches),
                k1_k2=dict(ms=step_ms, ms_at_run_width=step_wide_ms, plain_ms=step_plain_ms,
                           bound_ms=k12_bound[0], bound_by=k12_bound[1],
                           max_abs_err=max(e['max_abs_err'] for e in gerr.values()),
                           max_rel_err=max(e['max_rel_err'] for e in gerr.values()),
                           grads=gerr, bit_identical=same, launches=k12_launches),
                pad_ms=pad_ms)


def _widths_paths(n: int, device) -> dict:
    """K3, K4, K6a and K6b at 2x32 (run at 64) through fused_mlp_forward
    against the plain versions at the real width."""
    from sunerf_tpu_torch.ops import fused_mlp
    cfg, p, pts, dy = _setup_field(2, 32, n, device, seed=32)
    group = fused_mlp.STASH_BWD_TILE
    rows = {}
    for name, knobs, expect in (
            ('K3', dict(), dict(STASH_FWD_LAUNCHES=1, STASH_BWD_LAUNCHES=1, DPTS_LAUNCHES=1)),
            ('K4', dict(stash=False), dict(LAUNCHES=1, RECOMPUTE_BWD_LAUNCHES=1)),
            ('K6a', dict(stash_format='lsb'),
             dict(STASH_FWD_LAUNCHES=1, STASH_BWD_LAUNCHES=1, DPTS_LAUNCHES=1, LSB_LAUNCHES=2)),
            ('K6b', dict(stash_format='i8pair'),
             dict(STASH_FWD_LAUNCHES=1, STASH_BWD_LAUNCHES=1, DPTS_LAUNCHES=1,
                  I8PAIR_LAUNCHES=2))):
        tag = f'[widths] {name} 2x32 (runs at 64) N={n}'
        _zero_counters()
        _, got = _autograd(cfg, p, pts, dy, **knobs)
        launches = _counters()
        if name == 'K4':
            ref = fused_mlp.fused_mlp_recompute_bwd_reference(cfg, p, pts, dy)
        else:
            fmt = knobs.get('stash_format', 'int8')
            _, hs, cs = fused_mlp.fused_mlp_stash_reference(cfg, p, pts, fmt)
            ref = fused_mlp.fused_mlp_stash_bwd_reference(cfg, p, pts, dy, hs, cs, fmt, True,
                                                          group)
        torch.cuda.synchronize()
        gerr = _grad_err(ref, got)
        ms = _cuda_ms(lambda: _autograd(cfg, p, pts, dy, **knobs), reps=10)
        print(f'{tag}: launches {launches}; vs plain, max: ' + '; '.join(
            f"{k} {e['max_rel_err']:.2e}" for k, e in gerr.items())
            + f'; forward + backward {ms:.3f} ms', flush=True)
        _check(launches == expect, f'{tag}: launches {launches}, expected {expect}')
        _check(set(got) == set(ref), f'{tag}: gradients {sorted(got)} against {sorted(ref)}')
        for k, e in gerr.items():
            tol = DPTS_TOL if k == 'dpts' else GRAD_TOL
            _check(bool(torch.isfinite(got[k]).all()), f'{tag}: {k} not finite')
            _check(e['max_rel_err'] <= tol, f"{tag}: {k} vs plain {e['max_rel_err']:.3e}")
        rows[name] = dict(launches=launches, grads=gerr, ms=ms,
                          max_abs_err=max(e['max_abs_err'] for e in gerr.values()),
                          max_rel_err=max(e['max_rel_err'] for e in gerr.values()))
    return rows


def _widths_phase(device) -> dict:
    """[widths]: fields of widths outside KERNEL_WIDTHS on the kernels,
    zero-padded to the next kernel width."""
    t0 = time.perf_counter()
    rows = {f'{layers}x{width}': _width_row(layers, width, WIDTHS_N, device)
            for layers, width in WIDTH_SHAPES}
    paths = _widths_paths(WIDTHS_N, device)
    wall = time.perf_counter() - t0
    print(f'[widths] {wall:.1f} s', flush=True)
    return dict(rows=rows, paths=paths, wall_s=wall)


def _run_cli(config: dict, path: str, device):
    """sunerf_tpu_torch.run_emission.main on a config written as JSON, which
    YAML reads as it is."""
    from sunerf_tpu_torch.run_emission import main
    with open(path, 'w') as f:
        json.dump(config, f)
    return main(['--config', path, '--device', str(device)])


def _trainer_phase(device, train: dict) -> dict:
    """[trainer]: the emission CLI at 8x512 on synthesized FITS views, its
    bundles served, a resume, and a 2x32 run on the padded kernels."""
    from sunerf_tpu_torch import native
    from sunerf_tpu_torch.evaluation.loader import SuNeRFLoader
    from sunerf_tpu_torch.ops import fused_mlp
    from sunerf_tpu_torch.data.synthetic import OBSERVERS, synthesize_views
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        pattern = synthesize_views(tmp, device, TRAINER_RES, BUNDLE)
        synth_s = time.perf_counter() - t0
        workdir = os.path.join(tmp, 'run')
        config = {'path_to_save': workdir, 'model': dict(TRAINER_MODEL),
                  'rendering': dict(TRAINER_RENDERING),
                  'data': {'data_path': pattern, 'batch_size': TRAINER_BATCH},
                  'training': {'total_steps': TRAINER_STEPS, 'log_every_n_steps': 150,
                               'scalar_log_every': 50, 'ema_decay': 0.999, 'keep_best': True,
                               'drift_probe_views': 4, 'drift_probe_resolution': 64,
                               'profile_steps': 20}}
        _zero_counters()
        t1 = time.perf_counter()
        trainer = _run_cli(config, os.path.join(tmp, 'emission.yaml'), device)
        run_s = time.perf_counter() - t1
        launches = _counters()
        recs = [json.loads(line) for line in open(os.path.join(workdir, 'metrics.jsonl'))]
        steps = [r for r in recs if 'loss' in r]
        vals = {r['step']: r for r in recs if 'val_psnr' in r}
        window = [r for r in steps if 50 < r['step'] <= TRAINER_STEPS]
        ms_step = statistics.mean(r['step_ms'] for r in window)
        with open(os.path.join(workdir, 'profile', 'summary.json')) as f:
            prof = json.load(f)
        print(f'[trainer] synthesized {len(OBSERVERS)} views at {TRAINER_RES}^2 in '
              f'{synth_s:.1f} s; Rice decoder: {native.decoder()}', flush=True)
        print(f'[trainer] run_emission {TRAINER_MODEL or "8x512"}, '
              f'{TRAINER_RENDERING or "64 + 128"}, batch {TRAINER_BATCH}, {TRAINER_STEPS} steps: '
              f'{run_s:.1f} s; launches {launches}; losses ' + ' '.join(
                  f"{r['step']}:{r['loss']:.5f}" for r in steps) + '; val_psnr ' + ' '.join(
                  f"{s}:{r['val_psnr']:.3f}" for s, r in sorted(vals.items())), flush=True)
        print(f'[trainer] {ms_step:.2f} ms/step ({TRAINER_BATCH / ms_step * 1e3:.0f} rays/s) over steps '
              f'51-{TRAINER_STEPS}, validations excluded (the host clock, waiting for the '
              f'loss every 50 steps), beside [train]\'s bare step {train["step_ms"]:.2f} ms; '
              f'profiled steps {prof["steps"]}: {prof["wall_ms"]:.1f} ms wall, '
              f'{prof["device_ms"]:.1f} ms of kernels, device idle {prof["idle_share"]:.1%}',
              flush=True)
        _check(launches.get('STASH_FWD_LAUNCHES') == 2 * TRAINER_STEPS
               and launches.get('STASH_BWD_LAUNCHES') == 2 * TRAINER_STEPS,
               f'trainer launches {launches}: not 2 K1 and 2 K2 a step')
        _check(launches.get('LAUNCHES', 0) > 0, 'the trainer\'s validation launched no K0')
        _check(all(np.isfinite(r['loss']) for r in steps), 'trainer losses not finite')
        _check(steps[-1]['loss'] < steps[0]['loss'],
               f"trainer loss did not fall: {steps[0]['loss']} -> {steps[-1]['loss']}")
        _check(vals[TRAINER_STEPS]['val_psnr'] > vals[0]['val_psnr'],
               f"val_psnr {vals[TRAINER_STEPS]['val_psnr']} not above step 0's "
               f"{vals[0]['val_psnr']}")
        served = {}
        for bundle in ('save_state', 'save_state_ema', 'save_state_best'):
            path = os.path.join(workdir, bundle)
            _check(os.path.exists(path + '.npz') and os.path.exists(path + '.json'),
                   f'{bundle} missing')
            fused_mlp.LAUNCHES = 0
            view = SuNeRFLoader(path, device=device).render_observer_image(
                lat=0.3, lon=1.1, time=0.0, distance=215.0, resolution=64)
            served[bundle] = dict(k0_launches=fused_mlp.LAUNCHES,
                                  image_max=float(np.max(view.image)))
            for k in MAPS:
                _check(bool(np.isfinite(getattr(view, k)).all()), f'{bundle} {k} not finite')
            _check(fused_mlp.LAUNCHES > 0, f'{bundle} rendered without K0')
        print(f'[trainer] bundles served at 64^2: {served}', flush=True)
        del trainer

        # resume: the same workdir, 50 more steps
        n_before = len(recs)
        config['training']['total_steps'] = TRAINER_STEPS + 50
        t1 = time.perf_counter()
        resumed = _run_cli(config, os.path.join(tmp, 'resume.yaml'), device)
        resume_s = time.perf_counter() - t1
        recs = [json.loads(line) for line in open(os.path.join(workdir, 'metrics.jsonl'))]
        after = [r['step'] for r in recs[n_before:] if 'loss' in r]
        print(f'[trainer] resumed at step {TRAINER_STEPS}: now at {resumed.state.step}, logged '
              f'steps {after} ({resume_s:.1f} s)', flush=True)
        _check(resumed.state.step == TRAINER_STEPS + 50 and after == [TRAINER_STEPS + 50],
               f'resume: step {resumed.state.step}, logged {after}')
        del resumed

        # the repaired width: 2x32 with 8 + 8 samples on the padded kernels
        narrow = {'path_to_save': os.path.join(tmp, 'narrow'),
                  'data': dict(config['data']),
                  'model': {'n_layers': 2, 'd_filter': 32},
                  'rendering': {'n_stratified': 8, 'n_hierarchical': 8},
                  'optimizer': {'lr_start': 1e-3, 'lr_floor': 1e-3},
                  'training': {'total_steps': 40, 'log_every_n_steps': 20,
                               'scalar_log_every': 10, 'drift_probe_views': 0}}
        _zero_counters()
        _run_cli(narrow, os.path.join(tmp, 'narrow.yaml'), device)
        n_launches = _counters()
        n_recs = [json.loads(line) for line in open(os.path.join(narrow['path_to_save'],
                                                                 'metrics.jsonl'))]
        n_losses = [r['loss'] for r in n_recs if 'loss' in r]
        print(f'[trainer] 2x32 (runs at 64), 8 + 8, 40 steps: launches {n_launches}; losses '
              + ' '.join(f'{v:.5f}' for v in n_losses), flush=True)
        _check(n_launches.get('STASH_FWD_LAUNCHES') == 80
               and n_launches.get('STASH_BWD_LAUNCHES') == 80
               and n_launches.get('LAUNCHES', 0) > 0, f'2x32 launches {n_launches}')
        _check(all(np.isfinite(n_losses)) and n_losses[-1] < n_losses[0],
               f'2x32 loss did not fall: {n_losses}')
    wall = time.perf_counter() - t0
    print(f'[trainer] {wall:.1f} s', flush=True)
    return dict(launches=launches, ms_per_step=ms_step, rays_per_s=TRAINER_BATCH / ms_step * 1e3,
                bare_step_ms=train['step_ms'], profile=prof, losses=[r['loss'] for r in steps],
                val_psnr={s: r['val_psnr'] for s, r in vals.items()}, served=served,
                decoder=native.decoder(), narrow_launches=n_launches, narrow_losses=n_losses,
                run_s=run_s, resume_s=resume_s, wall_s=wall)


def _with_dt_offsets(cfg, fn):
    """fn's raw [N, 2] as a DT field's FieldOutput: the base offsets added
    and log_abs / vol_c attached, as models.fields does for the kernels."""
    from sunerf_tpu_torch.models.fields import FieldOutput
    base = torch.tensor([cfg.base_log_density, cfg.base_log_temperature])

    def apply(p, x):
        return FieldOutput(raw=fn(p, x) + base.to(x.device), log_abs=p['log_abs'],
                           vol_c=p['vol_c'])
    return apply


def _plain_apply(cfg):
    """The kernels' plain versions as a field_apply: _PlainStash under
    autograd, K0's plain version without; DT offsets and aux as the fused
    path has them."""
    from sunerf_tpu_torch.ops import fused_mlp

    def raw(p, x):
        if torch.is_grad_enabled():
            return _PlainStash.apply(cfg, x, *(p[k] for k in fused_mlp.param_keys(cfg)))
        return fused_mlp.fused_mlp_reference(cfg, p, x)
    if cfg.with_aux:
        return _with_dt_offsets(cfg, raw)
    from sunerf_tpu_torch.models.fields import FieldOutput
    return lambda p, x: FieldOutput(raw=raw(p, x))


def _step_vs_plain(renderer, plain, params: dict, batch: dict, loss_config) -> dict:
    """One step's loss and gradients through `renderer` (the kernels)
    against `plain`, from the same params and batch, perturb off."""
    from sunerf_tpu_torch.train.objective import render_loss

    def run(r):
        p = {f: {k: v.detach().clone().requires_grad_() for k, v in sub.items()}
             for f, sub in params.items()}
        rays = batch['rays']
        out = r(p, rays[:, 0], rays[:, 1], batch['time'], wavelengths=batch.get('wavelength'))
        loss, _ = render_loss(loss_config, out, batch['target_image'])
        loss.backward()
        return float(loss.detach()), {f: {k: v.grad for k, v in sub.items()}
                                      for f, sub in p.items()}
    fixed = dataclasses.replace(renderer, perturb=False)
    loss_k, grads_k = run(fixed)
    loss_p, grads_p = run(dataclasses.replace(fixed, **plain))
    return {'loss': loss_k, 'plain_loss': loss_p,
            'loss_rel_err': abs(loss_k - loss_p) / abs(loss_p),
            'grads': {f: _grad_err(grads_p[f], grads_k[f]) for f in grads_p}}


def _check_vs_plain(tag: str, vs: dict):
    print(f'[{tag}] one step vs the plain versions: loss {vs["loss"]:.7g} vs '
          f'{vs["plain_loss"]:.7g} (rel {vs["loss_rel_err"]:.2e}, tol {STEP_LOSS_TOL}); '
          'grads max/max: ' + '; '.join(f"{f}/{k} {e['max_rel_err']:.2e}"
                                        for f, g in vs['grads'].items() for k, e in g.items()),
          flush=True)
    _check(vs['loss_rel_err'] <= STEP_LOSS_TOL, f'{tag} loss vs plain {vs["loss_rel_err"]:.3e}')
    for f, g in vs['grads'].items():
        for k, e in g.items():
            _check(e['max_rel_err'] <= GRAD_TOL,
                   f"{tag} grad {f}/{k} vs plain {e['max_rel_err']:.3e} (tol {GRAD_TOL})")


def _fine_points(renderer, params: dict, arrays: dict, chunk: int) -> list:
    """The fine pass's sample points of a no-jitter render of `arrays`
    (rays, time, wavelength), chunk by chunk: the renderer's field_apply
    recorded (a coarse proposal field, when there is one, runs apart)."""
    seen = []

    def record(p, x):
        seen.append(x)
        return renderer.field_apply(p, x)
    rec = dataclasses.replace(renderer, field_apply=record,
                              coarse_field_apply=renderer.coarse_field_apply
                              or renderer.field_apply)
    n = arrays['rays'].shape[0]
    with torch.no_grad():
        for i in range(0, n, chunk):
            sl = slice(i, i + chunk)
            rays = arrays['rays'][sl]
            rec(params, rays[:, 0], rays[:, 1], arrays['time'][sl],
                wavelengths=arrays['wavelength'][sl] if 'wavelength' in arrays else None)
    return seen


def _k0_on_points(cfg, p: dict, chunks: list) -> tuple:
    """K0 and its plain version on each chunk of points; both outputs
    concatenated (the kernels' raw, without DT offsets)."""
    from sunerf_tpu_torch.ops import fused_mlp
    got, ref = [], []
    with torch.inference_mode():
        for x in chunks:
            got.append(fused_mlp.fused_mlp_forward(cfg, p, x))
            ref.append(fused_mlp.fused_mlp_reference(cfg, p, x))
    return torch.cat(got), torch.cat(ref)


def _check_k0(tag: str, err: dict):
    print(f'[{tag}] K0 vs plain on the trained fine field: {_fmt(err)}', flush=True)
    _check(err['p9999_rel_err'] <= KERNEL_TOL and err['rms_rel_err'] <= KERNEL_RMS_TOL
           and err['max_rel_err'] <= KERNEL_MAX_TOL,
           f'{tag}: K0 vs plain {_fmt(err)} (tol p99.99 {KERNEL_TOL}, rms '
           f'{KERNEL_RMS_TOL}, max {KERNEL_MAX_TOL})')


def _device_ms(fn) -> float:
    """The device kernel time of one call of fn under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.device_time for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, 'is_user_annotation', False) and '#' not in e.name) / 1e3


def _head_ms(head, n_rays: int, samples: tuple, wavelengths, device) -> float:
    """The DT head's forward + backward at one step's shapes (the coarse
    and the fine pass), device time by torch.profiler."""
    gen = torch.Generator(device=device).manual_seed(3)
    inputs = []
    for s in samples:
        raw = torch.rand(n_rays, s, 2, generator=gen, device=device) * 3.0 \
            + torch.tensor([10.0, 4.0], device=device)
        z = torch.sort(torch.rand(n_rays, s, generator=gen, device=device) * 2.6 + 213.7,
                       dim=1).values
        inputs.append((raw, z))
    log_abs = torch.full((7,), 1e-6, device=device, requires_grad=True)
    vol_c = torch.tensor(1.0, device=device, requires_grad=True)

    def fwd_bwd():
        from sunerf_tpu_torch.models.fields import FieldOutput
        total = 0.0
        for raw, z in inputs:
            r = raw.detach().requires_grad_()
            out = head.raw2outputs(FieldOutput(raw=r, log_abs=log_abs, vol_c=vol_c), z,
                                   None, None, None, wavelengths)
            total = total + out['image'].sum()
        total.backward()
    return _device_ms(fwd_bwd)


def _synthesize_dt_tree(root: str, device) -> dict:
    """render_simple_star.yaml's observers and pif at DT_RES^2 over every
    AIA channel, through the port's synthesizer; DT_DROPPED removed."""
    import shutil

    import yaml

    from sunerf_tpu_torch.evaluation.image_render import render_observers
    from sunerf_tpu_torch.models.fields import AIA_WAVELENGTHS
    with open('config/render_simple_star.yaml') as f:
        cfg = yaml.safe_load(f)
    cfg.update(render_path=root, render_format=['fits'], resolution=DT_RES,
               wavelengths=list(AIA_WAVELENGTHS))
    render_observers(cfg, device=device)
    inst, wls = DT_DROPPED
    for wl in wls:
        shutil.rmtree(os.path.join(root, inst, str(wl)))
    counts = {i: {w: len(os.listdir(os.path.join(root, i, w)))
                  for w in sorted(os.listdir(os.path.join(root, i)), key=int)}
              for i in sorted(os.listdir(root))}
    return dict(counts=counts, pif=float(cfg['pixel_intensity_factor']),
                observers=len(cfg['observers']), ref_time=min(o['time'] for o in cfg['observers']))


def _dt_phase(device) -> dict:
    """[dt]: the DT CLI at config/DT_2012_11.yaml's widths on a synthesized
    seven-channel tree; its bundles served; a step and K0 against the plain
    versions; the Trainer's step time, idle share, head share and memory."""
    import yaml

    from sunerf_tpu_torch.data.datasets import iterate_batches
    from sunerf_tpu_torch.evaluation.loader import SuNeRFLoader
    from sunerf_tpu_torch.models.fields import NeRFConfig
    from sunerf_tpu_torch.ops import fused_mlp
    from sunerf_tpu_torch.run_density_temperature import main as dt_main
    from sunerf_tpu_torch.systems import from_spec
    from sunerf_tpu_torch.train.objective import LossConfig
    from sunerf_tpu_torch.train.step import make_train_step
    from sunerf_tpu_torch.utils.logging import MetricsLogger
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        tree = _synthesize_dt_tree(os.path.join(tmp, 'tree'), device)
        synth_s = time.perf_counter() - t0
        print(f'[dt] synthesized SimpleStar tree at {DT_RES}^2, pif {tree["pif"]:g}: '
              f'{tree["counts"]} ({synth_s:.1f} s)', flush=True)
        with open(DT_CONFIG) as f:
            config = yaml.safe_load(f)
        workdir = os.path.join(tmp, 'run')
        config.update(path_to_save=workdir, work_directory=os.path.join(workdir, 'batches'))
        # the tree's own epoch in place of 2012-11's
        config['data'].update(data_path=os.path.join(tmp, 'tree'), ref_time=tree['ref_time'])
        config['training'].update(total_steps=DT_STEPS, log_every_n_steps=150,
                                  scalar_log_every=50, ema_decay=0.999, keep_best=True)
        path = os.path.join(tmp, 'dt.yaml')
        with open(path, 'w') as f:
            yaml.safe_dump(config, f)
        _zero_counters()
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        trainer = dt_main(['--config', path, '--device', str(device)])
        run_s = time.perf_counter() - t1
        launches = _counters()
        run_peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        recs = [json.loads(line) for line in open(os.path.join(workdir, 'metrics.jsonl'))]
        steps = [r for r in recs if 'loss' in r]
        vals = {r['step']: r for r in recs if 'val_loss' in r}
        window = [r for r in steps if 50 < r['step'] <= DT_STEPS]
        ms_step = statistics.mean(r['step_ms'] for r in window)
        batch_size = config['data']['batch_size']
        spec = trainer.renderer.spec
        cfg = NeRFConfig(**spec['model_config'])
        probe_wl = float(np.asarray(trainer.data.valid.arrays['wavelength']).ravel()[0])
        print(f'[dt] run_density_temperature {cfg.n_layers}x{cfg.d_filter} (coarse '
              f'{spec.get("coarse_model_config") or "the same"}), '
              f'{spec["render"] or "64 + 128"}, batch {batch_size}, pif '
              f'{spec["pixel_intensity_factor"]:g}, {DT_STEPS} steps: {run_s:.1f} s; launches '
              f'{launches}; drift probe pinned at {probe_wl:g} A; losses ' + ' '.join(
                  f"{r['step']}:{r['loss']:.6g}" for r in steps) + '; val_psnr ' + ' '.join(
                  f"{s}:{r.get('val_psnr', float('nan')):.3f}" for s, r in sorted(vals.items())),
              flush=True)
        _check(cfg.n_layers == 8 and cfg.d_filter == 512 and batch_size == 3072
               and spec['pixel_intensity_factor'] == 1e17, f'[dt] not at DT_2012_11: {spec}')
        _check(launches.get('STASH_FWD_LAUNCHES') == 2 * DT_STEPS
               and launches.get('STASH_BWD_LAUNCHES') == 2 * DT_STEPS,
               f'dt launches {launches}: not 2 K1 and 2 K2 a step')
        _check(launches.get('LAUNCHES', 0) > 0, 'the DT validation launched no K0')
        _check(all(np.isfinite(r['loss']) for r in steps), 'dt losses not finite')
        _check(steps[-1]['loss'] < steps[0]['loss'],
               f"dt loss did not fall: {steps[0]['loss']} -> {steps[-1]['loss']}")
        _check(sorted(vals) == [0, 150, DT_STEPS], f'dt validations at {sorted(vals)}')
        _check(not any(r.get('val_pred_degenerate') for r in vals.values()),
               'a DT validation was degenerate (near-zero prediction)')
        _check(probe_wl == 94.0, f'drift probe pinned at {probe_wl}, not 94')

        served = {}
        wls = [float(w) for w in trainer.data.config['wavelengths']]
        for bundle in ('save_state', 'save_state_ema', 'save_state_best'):
            bpath = os.path.join(workdir, bundle)
            _check(os.path.exists(bpath + '.npz') and os.path.exists(bpath + '.json'),
                   f'{bundle} missing')
            loader = SuNeRFLoader(bpath, device=device)
            _check(loader.wavelengths == [int(w) for w in wls],
                   f'{bundle} wavelengths {loader.wavelengths}')
            fused_mlp.LAUNCHES = 0
            view = loader.render_observer_image(lat=0.3, lon=1.1, time=0.0, distance=215.0,
                                                resolution=64, wavelengths=wls)
            k0 = fused_mlp.LAUNCHES
            zero = loader.render_observer_image(lat=0.3, lon=1.1, time=0.0, distance=215.0,
                                                resolution=64, wavelengths=[0.0] * len(wls))
            served[bundle] = dict(k0_launches=k0, channel_max=[float(v) for v in
                                                               view.image.max(axis=(0, 1))])
            _check(view.image.shape == (64, 64, 7), f'{bundle} image {view.image.shape}')
            for k in MAPS:
                _check(bool(np.isfinite(getattr(view, k)).all()), f'{bundle} {k} not finite')
            _check(k0 > 0, f'{bundle} rendered without K0')
            _check(bool((zero.image == 0.0).all()), f'{bundle}: all-zero wavelengths not 0')
        print(f'[dt] bundles served at 64^2 in {len(wls)} channels: {served}', flush=True)

        # one step from the run's first params and batch, against the plain versions
        renderer, init = from_spec(spec, device=device)
        params0 = init(torch.Generator().manual_seed(trainer.config.seed))
        batch = {k: torch.as_tensor(np.array(v)).to(device) for k, v in
                 next(iterate_batches(trainer.data.train, shuffle=True,
                                      seed=trainer.config.seed)).items()}
        loss_config = trainer.loss_config
        vs_plain = _step_vs_plain(renderer, {'field_apply': _plain_apply(cfg)}, params0, batch,
                                  loss_config)
        _check_vs_plain('dt', vs_plain)
        f32 = _step_vs_plain(renderer, {'field_apply': from_spec(spec, use_fused=False,
                                                                 device=device)[0].field_apply},
                             params0, batch, loss_config)
        print(f'[dt] the same step vs the float32 field (reported): loss rel '
              f'{f32["loss_rel_err"]:.2e}; grads max/max ' + '; '.join(
                  f"{f}/{k} {e['max_rel_err']:.2e}" for f, g in f32['grads'].items()
                  for k, e in g.items()), flush=True)

        # max|dy| into K2 at step 1: the gradient reaching each field's raw
        dy_max = []

        def hooked(apply):
            def fn(p, x):
                out = apply(p, x)
                out.raw.register_hook(lambda g: dy_max.append(float(g.abs().max())))
                return out
            return fn
        probe = dataclasses.replace(renderer, field_apply=hooked(renderer.field_apply))
        step1 = make_train_step(probe, loss_config, trainer.optimizer)
        from sunerf_tpu_torch.train.step import create_train_state
        state1 = create_train_state({f: {k: v.clone() for k, v in sub.items()}
                                     for f, sub in params0.items()}, trainer.optimizer)
        step1(state1, batch, trainer.config.seed)
        print(f'[dt] max|dy| into K2 at step 1: fine, coarse {dy_max} (log10 '
              f'{[round(float(np.log10(max(v, 1e-45))), 2) for v in dy_max]})', flush=True)
        _check(all(np.isfinite(v) for v in dy_max) and len(dy_max) == 2,
               f'dy into K2 not finite: {dy_max}')

        # a bare step: its peak memory and profile; the head's share of it
        step = make_train_step(renderer, loss_config, trainer.optimizer)
        state = create_train_state({f: {k: v.clone() for k, v in sub.items()}
                                    for f, sub in params0.items()}, trainer.optimizer)
        step(state, batch, 0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        step(state, batch, 0)
        torch.cuda.synchronize()
        step_peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        bare_ms = _step_times(step, state, batch)
        prof_step = _profile_step(step, state, batch, 'DT step')
        head_ms = _head_ms(renderer.head, batch_size,
                           (renderer.n_stratified, renderer.n_stratified + renderer.n_hierarchical),
                           batch['wavelength'], device)
        head_share = head_ms / prof_step['device_ms']
        del state, state1

        # the trained fine field at the held-out view: K0 vs plain, raw and image
        arrays = trainer._valid_arrays()
        chunks = _fine_points(trainer.renderer, trainer.state.params, arrays, batch_size)
        got, ref = _k0_on_points(cfg, trainer.state.params['fine'], chunks)
        raw_err = _err_stats(ref, got)
        _check_k0('dt', raw_err)
        max_raw = float(ref.abs().max())
        # K0, K1 and K2 at the step's shapes: the fine pass (N = 3072 x 192,
        # K0 on the first chunk of held-out fine samples) and the coarse
        fine_p = trainer.state.params['fine']
        k0_rows = {}
        for name, x in (('dt_fine', chunks[0]), ('dt_coarse', chunks[0][::3].contiguous())):
            with torch.inference_mode():
                k0_rows[name] = dict(
                    n=x.shape[0], ms=_cuda_ms(lambda: fused_mlp.fused_mlp_forward(cfg, fine_p, x)),
                    plain_ms=_cuda_ms(lambda: fused_mlp.fused_mlp_reference(cfg, fine_p, x)),
                    bound_ms=_flops(cfg, x.shape[0]) / (BF16_TFLOPS * 1e12) * 1e3)
        print(f'[dt] K0 at the step\'s shapes: {k0_rows}', flush=True)
        with torch.no_grad():
            stash_rows = {name: _stash_phase(name, cfg.n_layers, cfg.d_filter, n, device)
                          for name, n in (('dt_fine', batch_size * (renderer.n_stratified
                                                                    + renderer.n_hierarchical)),
                                          ('dt_coarse', batch_size * renderer.n_stratified))}
        image_tol = float(np.exp(DT_RAW_TO_IMAGE * KERNEL_TOL * max_raw) - 1.0)
        plain_fine = dataclasses.replace(trainer.renderer, field_apply=_plain_apply(cfg),
                                         coarse_field_apply=trainer.renderer.field_apply)
        imgs = {'k0': [], 'plain': []}
        n = arrays['rays'].shape[0]
        with torch.no_grad():
            for i in range(0, n, batch_size):
                sl = slice(i, i + batch_size)
                rays = arrays['rays'][sl]
                for name, r in (('k0', trainer.renderer), ('plain', plain_fine)):
                    imgs[name].append(r(trainer.state.params, rays[:, 0], rays[:, 1],
                                        arrays['time'][sl],
                                        wavelengths=arrays['wavelength'][sl])['image'])
        img_k, img_p = torch.cat(imgs['k0']).double(), torch.cat(imgs['plain']).double()
        per_channel = ((img_k - img_p).abs().amax(0)
                       / img_p.abs().amax(0).clamp_min(1e-30)).tolist()
        image_err = max(per_channel)
        print(f'[dt] held-out {DT_RES}^2 view, 7 channels from the same fine samples: image '
              f'K0 vs plain {image_err:.3e} of each channel\'s max (per channel '
              f'{[f"{v:.2e}" for v in per_channel]}); derived tolerance exp(2 x {KERNEL_TOL} '
              f'x max|raw| {max_raw:.3f}) - 1 = {image_tol:.3e}', flush=True)
        _check(bool(torch.isfinite(img_k).all()), 'dt held-out image not finite')
        _check(image_err <= image_tol, f'dt image K0 vs plain {image_err:.3e} > {image_tol:.3e}')
        del chunks, got, ref, imgs

        # 20 profiled Trainer steps (301-320), after the checks above; the
        # run ends a step later, so its checkpoint falls outside the window
        trainer.config.total_steps = DT_STEPS + 21
        trainer.config.profile_start, trainer.config.profile_steps = DT_STEPS, 20
        trainer.logger = MetricsLogger(workdir)
        try:
            trainer.fit()
        finally:
            trainer.logger.close()
        with open(os.path.join(workdir, 'profile', 'summary.json')) as f:
            prof = json.load(f)
        vp = {s: vals[s].get('val_psnr') for s in sorted(vals)}
        print(f'[dt] {ms_step:.2f} ms/step ({batch_size / ms_step * 1e3:.0f} rays/s) over steps '
              f'51-{DT_STEPS}, validations excluded (the host clock, waiting for the loss every '
              f'50 steps); bare step {bare_ms:.2f} ms (CUDA events); Trainer steps '
              f'{prof["steps"]} profiled: {prof["wall_ms"]:.1f} ms wall, '
              f'{prof["device_ms"]:.1f} ms of kernels, device idle {prof["idle_share"]:.1%}; '
              f'head fwd + bwd {head_ms:.2f} ms of a step\'s {prof_step["device_ms"]:.2f} ms of '
              f'kernels ({head_share:.1%}); peak memory {run_peak_gib:.2f} GiB over the run, '
              f'{step_peak_gib:.2f} GiB a step; val_psnr {vp}', flush=True)
    wall = time.perf_counter() - t0
    print(f'[dt] {wall:.1f} s', flush=True)
    return dict(launches=launches, tree=tree['counts'], ms_per_step=ms_step,
                rays_per_s=batch_size / ms_step * 1e3, bare_step_ms=bare_ms,
                trainer_profile=prof, step_profile=prof_step, head_ms=head_ms,
                head_share=head_share, run_peak_gib=run_peak_gib, step_peak_gib=step_peak_gib,
                dy_max=dy_max, val_psnr=vp, losses=[r['loss'] for r in steps],
                vs_plain=vs_plain, vs_float32=f32, k0_raw_err=raw_err, image_err=image_err,
                k0_rows=k0_rows, stash_rows=stash_rows,
                image_err_per_channel=per_channel, image_tol=image_tol, served=served,
                synth_s=synth_s, run_s=run_s, wall_s=wall)


def _thomson_phase(device) -> dict:
    """[thomson]: an 8x512 student on the kernels learns the analytic
    teacher's white-light target, with either sampler."""
    from sunerf_tpu_torch.core.sampling import norm3
    from sunerf_tpu_torch.models.fields import FieldOutput, NeRFConfig
    from sunerf_tpu_torch.rendering.renderer import Renderer
    from sunerf_tpu_torch.rendering.thomson import ThomsonHead
    from sunerf_tpu_torch.systems import make_thomson_system
    from sunerf_tpu_torch.train.objective import LossConfig
    from sunerf_tpu_torch.train.optim import make_optimizer
    from sunerf_tpu_torch.train.step import create_train_state, make_train_step
    t0 = time.perf_counter()

    def teacher_apply(params, pts):
        r = norm3(pts[:, :3])
        log_ne = 8.0 + ((1.0 / torch.clamp(r, min=0.5) - 1.0) / 0.2) / np.log(10.0)
        return FieldOutput(raw=torch.stack([log_ne, torch.zeros_like(log_ne)], -1))

    batch = _bench_batch(device, n=THOMSON_RAYS, seed=2)
    rays = batch['rays']
    teacher = Renderer(field_apply=teacher_apply, head=ThomsonHead(), perturb=False)
    with torch.no_grad():
        target = teacher({'coarse': {}, 'fine': {}}, rays[:, 0], rays[:, 1],
                         batch['time'])['image']
    _check(bool(torch.isfinite(target).all()) and float(target.max()) > 0,
           'thomson target not finite and positive')
    batch['target_image'] = target
    # the asinh-scaled loss (LossConfig's defaults, no regularizer): on raw
    # intensities (~1e8) the student's 10^raw either stalls or overshoots
    # within 100 steps at 8x512 (lr 2e-5 against 1e-4 and 1e-3 in a CPU trial)
    loss_config = LossConfig(lambda_regularization=0.0)
    rows = {}
    for sampling in ('stratified', 'spherical'):
        renderer, init = make_thomson_system(device=device, sampling=sampling)
        cfg = NeRFConfig(**renderer.spec['model_config'])
        params = init(torch.Generator(device=device).manual_seed(0))
        vs_plain = _step_vs_plain(renderer, {'field_apply': _plain_apply(cfg)}, params, batch,
                                  loss_config)
        _check_vs_plain(f'thomson {sampling}', vs_plain)
        opt = make_optimizer()
        step = make_train_step(renderer, loss_config, opt)
        state = create_train_state(params, opt)
        _zero_counters()
        losses = [step(state, batch, 0)[1]['loss'] for _ in range(THOMSON_STEPS)]
        launches = _counters()
        losses = [float(v) for v in losses]
        _check(launches.get('STASH_FWD_LAUNCHES') == 2 * THOMSON_STEPS
               and launches.get('STASH_BWD_LAUNCHES') == 2 * THOMSON_STEPS
               and not launches.get('LAUNCHES'),
               f'thomson {sampling} launches {launches}: not 2 K1 and 2 K2 a step')
        _check(all(np.isfinite(losses)) and losses[-1] < losses[0],
               f'thomson {sampling} loss did not fall: {losses[0]} -> {losses[-1]}')
        step_ms = _step_times(step, state, batch)
        arrays = {'rays': rays, 'time': batch['time']}
        chunks = _fine_points(renderer, state.params, arrays, THOMSON_RAYS)
        got, ref = _k0_on_points(cfg, state.params['fine'], chunks)
        raw_err = _err_stats(ref, got)
        _check_k0(f'thomson {sampling}', raw_err)
        with torch.no_grad():
            out = renderer(state.params, rays[:, 0], rays[:, 1], batch['time'])
        extras = {k: float(out[k].abs().max()) for k in
                  ('pixel_density', 'distance_from_sun', 'distance_from_obs')}
        for k in extras:
            _check(bool(torch.isfinite(out[k]).all()), f'thomson {sampling} {k} not finite')
        rows[sampling] = dict(launches=launches, losses=losses[::10] + [losses[-1]],
                              step_ms=step_ms, rays_per_s=THOMSON_RAYS / step_ms * 1e3,
                              vs_plain=vs_plain, k0_raw_err=raw_err, extras_absmax=extras)
        print(f'[thomson] {sampling}, {cfg.n_layers}x{cfg.d_filter}, '
              f'{renderer.n_stratified} + {renderer.n_hierarchical}, {THOMSON_RAYS} rays: '
              f'launches {launches}; loss {losses[0]:.5g} -> {losses[-1]:.5g}; step '
              f'{step_ms:.2f} ms ({THOMSON_RAYS / step_ms * 1e3:.0f} rays/s, CUDA events); '
              f'extras |max| {extras}', flush=True)
        del state, step, chunks, got, ref
    wall = time.perf_counter() - t0
    print(f'[thomson] {wall:.1f} s', flush=True)
    return dict(rows=rows, wall_s=wall)


def _grid_bytes(cfg) -> int:
    """Bytes of a config's float32 grid tables."""
    return 4 * sum(g ** 3 for g in cfg.grid_sizes) * cfg.grid_features


def _grid_flops(cfg, n: int, backward: bool) -> float:
    """Operations of the grid branch beyond the MLP's products: per point,
    level and feature 8 corners of a multiply and an add (and the corner
    weights); K2 adds the cotangent product dz_0 W_grid^T and the scatter's
    8 products per feature."""
    per = 16.0 * cfg.d_grid
    if backward:
        per += 2.0 * cfg.d_filter * cfg.d_grid + 8.0 * cfg.d_grid
    return n * per


def _grid_kernel_phase(name: str, kw: dict, n: int, device) -> dict:
    """K0, K1 and K2 with the grid branch against their plain versions at
    one shape; their times, the times of K1 + K2 of the same widths without
    the grid, and bounds."""
    from sunerf_tpu_torch.models.fields import emission_config, init_nerf
    from sunerf_tpu_torch.ops import fused_mlp
    cfg = emission_config(**kw)
    gen = torch.Generator(device=device).manual_seed(n + 7)
    p = init_nerf(gen, cfg, device)
    for k in fused_mlp.grid_keys(cfg):
        p[k] = p[k] * 1e4                      # U(-1, 1): tables that carry signal
    pts = torch.rand(n, 4, generator=gen, device=device) * 3.0 - 1.5
    pts[:, 3] = 0.0
    pts[:64, :3] = torch.tensor([1.3, -1.3, 1.3], device=device)   # on the bound
    dy = torch.randn(n, cfg.d_output, generator=gen, device=device)
    keys = fused_mlp.param_keys(cfg)
    tag = f'[grid] {name} {cfg.n_layers}x{cfg.d_filter} levels {cfg.grid_sizes} N={n}'

    k0 = fused_mlp.fused_mlp_forward(cfg, p, pts)
    out, hs, cs = fused_mlp.fused_mlp_stash_forward(cfg, p, pts)
    ref_out = fused_mlp.fused_mlp_reference(cfg, p, pts)
    lw_hs, lw_cs = fused_mlp.fused_mlp_stash_layerwise(cfg, p, pts, hs)
    torch.cuda.synchronize()
    err0, err1 = _err_stats(ref_out, k0), _err_stats(ref_out, out)
    vs_k0 = _err_stats(k0, out)
    hs_ulp1 = float((_bf16_ulps(lw_hs, hs) <= 1).float().mean())
    cs_diff = int((cs.int() - lw_cs.int()).abs().max())
    print(f'{tag}: K0 vs plain {_fmt(err0)}; K1 vs plain {_fmt(err1)}; K1 vs K0 '
          f'{_fmt(vs_k0)} (tol max {K1_VS_K0_TOL:g}); sin stash within 1 ulp (layerwise) '
          f'{hs_ulp1:.6f}, int8 cos max |diff| {cs_diff}', flush=True)
    _check(vs_k0['max_rel_err'] <= K1_VS_K0_TOL, f'{tag}: K1 vs K0 {_fmt(vs_k0)}')
    for label, err in (('K0', err0), ('K1', err1)):
        _check(bool(torch.isfinite(k0).all() and torch.isfinite(out).all()),
               f'{tag}: non-finite forward')
        _check(err['p9999_rel_err'] <= KERNEL_TOL and err['rms_rel_err'] <= KERNEL_RMS_TOL
               and err['max_rel_err'] <= KERNEL_MAX_TOL, f'{tag}: {label} vs plain {_fmt(err)}')
    _check(hs_ulp1 >= 0.999, f'{tag}: K1 sin stash within 1 ulp for {hs_ulp1:.6f}')
    _check(cs_diff <= 1, f'{tag}: K1 int8 cos stash off by {cs_diff}')
    del lw_hs, lw_cs

    grads = fused_mlp.fused_mlp_stash_backward(cfg, p, pts, dy, hs, cs)
    again = fused_mlp.fused_mlp_stash_backward(cfg, p, pts, dy, hs, cs)
    ref = fused_mlp.fused_mlp_stash_bwd_reference(cfg, p, pts, dy, hs, cs)
    torch.cuda.synchronize()
    gerr = _grad_err(ref, grads)
    identical = {k: bool(torch.equal(grads[k], again[k])) for k in keys}
    print(f'{tag}: K2 vs plain, max / RMS over max|plain| / RMS: ' + '; '.join(
        f"{k} {e['max_rel_err']:.2e} / {e['rms_rel_err']:.2e}" for k, e in gerr.items())
        + f'; two runs bit-identical: {all(identical.values())} (tables: '
        + ', '.join(f'{k} {identical[k]}' for k in fused_mlp.grid_keys(cfg)) + ')',
        flush=True)
    for k, e in gerr.items():
        _check(bool(torch.isfinite(grads[k]).all()), f'{tag}: K2 {k} not finite')
        _check(e['max_rel_err'] <= GRAD_TOL,
               f"{tag}: K2 {k} vs plain {e['max_rel_err']:.3e} (tol {GRAD_TOL})")
    _check(all(identical.values()), f'{tag}: K2 not bit-identical run to run: {identical}')
    del again, ref

    # the same widths without the grid: the grid branch's share of the time
    base_cfg = emission_config(n_layers=cfg.n_layers, d_filter=cfg.d_filter)
    base = dict(p, w_in=p['w_in'][:base_cfg.d_encoded].contiguous())
    _, bhs, bcs = fused_mlp.fused_mlp_stash_forward(base_cfg, base, pts)
    t = dict(
        k0=_cuda_ms(lambda: fused_mlp.fused_mlp_forward(cfg, p, pts)),
        k1=_cuda_ms(lambda: fused_mlp.fused_mlp_stash_forward(cfg, p, pts)),
        k2=_cuda_ms(lambda: fused_mlp.fused_mlp_stash_backward(cfg, p, pts, dy, hs, cs)),
        k1_no_grid=_cuda_ms(lambda: fused_mlp.fused_mlp_stash_forward(base_cfg, base, pts)),
        k2_no_grid=_cuda_ms(lambda: fused_mlp.fused_mlp_stash_backward(
            base_cfg, base, pts, dy, bhs, bcs)),
        k0_plain=_cuda_ms(lambda: fused_mlp.fused_mlp_reference(cfg, p, pts), reps=5),
        k1_plain=_cuda_ms(lambda: fused_mlp.fused_mlp_stash_reference(cfg, p, pts), reps=5),
        k2_plain=_cuda_ms(lambda: fused_mlp.fused_mlp_stash_bwd_reference(
            cfg, p, pts, dy, hs, cs), reps=5))
    del bhs, bcs
    # K5's parts by kernel name, and the library yardstick (never on the path)
    from sunerf_tpu_torch.scripts.backward_ablation import grid_sample_ms
    kernels = _kernel_breakdown(
        lambda: fused_mlp.fused_mlp_stash_backward(cfg, p, pts, dy, hs, cs), f'{tag} K2')
    lib = grid_sample_ms(cfg, p, pts, device)
    print(f"{tag}: grid_sample a level (5-D, trilinear, border), forward {lib['fwd_ms']:.3f} "
          f"ms, forward + backward to d_table {lib['fwd_bwd_ms']:.3f} ms (timing rows, never "
          f"on the path)", flush=True)
    io = n * 4 * (cfg.d_input + cfg.d_output)
    stash = n * cfg.n_layers * cfg.d_filter * 3
    par, tab = _param_bytes(cfg), _grid_bytes(cfg)
    b0 = _bound(_flops(cfg, n) + _grid_flops(cfg, n, False), io + par + tab)
    b1 = _bound(_flops(cfg, n) + _grid_flops(cfg, n, False), io + stash + par + tab)
    b2 = _bound(_bwd_flops(cfg, n) + _grid_flops(cfg, n, True),
                io + stash + 2 * par + 2 * tab)
    # the grid branch's own work: read the points and tables, write d_table
    b5 = _bound(_grid_flops(cfg, n, False) + _grid_flops(cfg, n, True),
                n * 4 * cfg.d_input + 2 * tab)
    marginal = t['k1'] + t['k2'] - t['k1_no_grid'] - t['k2_no_grid']
    print(f"{tag}: K0 {t['k0']:.3f} ms (plain {t['k0_plain']:.3f}, bound {b0[0]:.3f} by "
          f"{b0[1]}); K1 {t['k1']:.3f} (plain {t['k1_plain']:.3f}, bound {b1[0]:.3f} by "
          f"{b1[1]}; no grid {t['k1_no_grid']:.3f}); K2 {t['k2']:.3f} (plain "
          f"{t['k2_plain']:.3f}, bound {b2[0]:.3f} by {b2[1]}; no grid "
          f"{t['k2_no_grid']:.3f}); the grid's share of K1 + K2 {marginal:.3f} ms "
          f"(its own work's bound {b5[0]:.4f} by {b5[1]})", flush=True)
    table_err = {k: gerr[k] for k in fused_mlp.grid_keys(cfg)}
    return dict(n=n, layers=cfg.n_layers, width=cfg.d_filter, levels=list(cfg.grid_sizes),
                k0=dict(ms=t['k0'], plain_ms=t['k0_plain'], bound_ms=b0[0], bound_by=b0[1],
                        **err0),
                k1=dict(ms=t['k1'], plain_ms=t['k1_plain'], bound_ms=b1[0], bound_by=b1[1],
                        no_grid_ms=t['k1_no_grid'], hs_within_1ulp_layerwise=hs_ulp1,
                        cs_max_diff_layerwise=cs_diff, vs_k0=vs_k0, **err1),
                k2=dict(ms=t['k2'], plain_ms=t['k2_plain'], bound_ms=b2[0], bound_by=b2[1],
                        no_grid_ms=t['k2_no_grid'],
                        max_abs_err=max(e['max_abs_err'] for e in gerr.values()),
                        max_rel_err=max(e['max_rel_err'] for e in gerr.values()),
                        grads=gerr, bit_identical=identical),
                k5=dict(grid_share_ms=marginal, own_bound_ms=b5[0], own_bound_by=b5[1],
                        table_grads=table_err, k2_kernels=kernels,
                        grid_sample_fwd_ms=lib['fwd_ms'],
                        grid_sample_fwd_bwd_ms=lib['fwd_bwd_ms']))


def _grid_train_phase(device) -> dict:
    """bench.py grid_quarter, uncut, through the port's train step."""
    from sunerf_tpu_torch.models.fields import emission_config
    from sunerf_tpu_torch.ops import fused_mlp
    from sunerf_tpu_torch.systems import make_emission_system
    from sunerf_tpu_torch.train.objective import LossConfig
    from sunerf_tpu_torch.train.optim import make_optimizer
    from sunerf_tpu_torch.train.step import create_train_state, make_train_step

    fine_cfg = emission_config(**GRID_QUARTER)
    coarse_cfg = emission_config(n_layers=4, d_filter=128)
    system = dict(model_config=fine_cfg, coarse_config=coarse_cfg, n_stratified=24,
                  n_hierarchical=48, device='cuda')
    renderer, init = make_emission_system(**system)
    params = init(torch.Generator(device=device).manual_seed(0))
    batch = _bench_batch(device)
    opt = make_optimizer()
    step = make_train_step(renderer, LossConfig(), opt)
    state = create_train_state(params, opt)
    step(state, batch, 0)                       # warm-up: libraries loaded
    torch.cuda.synchronize()
    fused_mlp.LAUNCHES = fused_mlp.STASH_FWD_LAUNCHES = fused_mlp.STASH_BWD_LAUNCHES = 0
    fused_mlp.GRID_LAUNCHES = 0
    _, m = step(state, batch, 0)
    launches = {'k0': fused_mlp.LAUNCHES, 'k1': fused_mlp.STASH_FWD_LAUNCHES,
                'k2': fused_mlp.STASH_BWD_LAUNCHES, 'k5': fused_mlp.GRID_LAUNCHES}
    print(f'[gridtrain] one grid_quarter step: {launches["k1"]} K1, {launches["k2"]} K2, '
          f'{launches["k0"]} K0 launches, {launches["k5"]} through the grid branch '
          f'(expected 2, 2, 0, 2); loss {float(m["loss"]):.6f}', flush=True)
    _check(launches == {'k0': 0, 'k1': 2, 'k2': 2, 'k5': 2},
           f'grid_quarter step launches {launches}')

    fixed, _ = make_emission_system(perturb=False, **system)
    plain = dataclasses.replace(fixed, field_apply=_plain_field(fine_cfg),
                                coarse_field_apply=_plain_field(coarse_cfg))
    loss_k, grads_k = _loss_and_grads(fixed, params, batch)
    loss_p, grads_p = _loss_and_grads(plain, params, batch)
    vs_plain = {'loss': loss_k, 'plain_loss': loss_p,
                'loss_rel_err': abs(loss_k - loss_p) / abs(loss_p),
                'grads': {f: _grad_err(grads_p[f], grads_k[f]) for f in grads_p}}
    print(f'[gridtrain] one step vs the plain path: loss {loss_k:.7f} vs {loss_p:.7f} '
          f'(rel {vs_plain["loss_rel_err"]:.2e}); grads max/max: '
          + '; '.join(f"{f}/{k} {e['max_rel_err']:.2e}" for f, g in vs_plain['grads'].items()
                      for k, e in g.items()), flush=True)
    _check(vs_plain['loss_rel_err'] <= STEP_LOSS_TOL,
           f"grid train loss vs plain {vs_plain['loss_rel_err']:.3e}")
    for f, g in vs_plain['grads'].items():
        for k, e in g.items():
            _check(e['max_rel_err'] <= GRAD_TOL,
                   f"grid train grad {f}/{k} vs plain {e['max_rel_err']:.3e}")
    _check('grid_0' in vs_plain['grads']['fine'], 'the grid table got no gradient')

    curves, states, steps = {}, {}, {}
    for path, use_fused in (('kernel', True), ('float32', False)):
        r, _ = make_emission_system(use_fused=use_fused, **system)
        steps[path] = make_train_step(r, LossConfig(lambda_regularization=0.0), opt)
        states[path] = create_train_state(params, opt)
        losses = [steps[path](states[path], batch, 0)[1]['loss'] for _ in range(N_CURVE)]
        curves[path] = [float(v) for v in losses]
        print(f'[gridtrain] {N_CURVE} steps, {path}: '
              + ' '.join(f'{v:.5f}' for v in curves[path]), flush=True)
        _check(all(np.isfinite(curves[path])), f'grid {path} losses not finite')
        _check(curves[path][-1] < curves[path][0], f'grid {path} loss did not fall')
    gap = abs(curves['kernel'][-1] - curves['float32'][-1]) / curves['float32'][-1]
    print(f'[gridtrain] last loss: kernel {curves["kernel"][-1]:.6f}, float32 '
          f'{curves["float32"][-1]:.6f} ({gap:.2%} apart, tol {GRID_CURVE_TOL:.0%})',
          flush=True)
    _check(gap <= GRID_CURVE_TOL, f'grid kernel path {gap:.2%} from the float32 field')

    step_ms = _step_times(step, state, batch)
    f32_ms = _step_times(steps['float32'], states['float32'], batch)
    print(f'[gridtrain] step: kernel path {step_ms:.2f} ms ({1024 / step_ms * 1e3:.0f} '
          f'rays/s); float32 path {f32_ms:.2f} ms ({1024 / f32_ms * 1e3:.0f} rays/s) (CUDA '
          f'events, median of 10 after 3 warm-up steps)', flush=True)
    profile_row = _profile_step(step, state, batch, 'grid_quarter step')
    return dict(launches=launches, vs_plain=vs_plain, curves=curves, curve_gap=gap,
                step_ms=step_ms, rays_per_s=1024 / step_ms * 1e3, f32_step_ms=f32_ms,
                profile=profile_row, renderer=renderer, state=state,
                configs=(fine_cfg, coarse_cfg))


def _ngp_phase(device) -> dict:
    """A few steps of the MIGRATION.md instant-NGP recipe at the default
    width and sample counts."""
    from sunerf_tpu_torch.models.fields import emission_config
    from sunerf_tpu_torch.ops import fused_mlp
    from sunerf_tpu_torch.systems import make_emission_system
    from sunerf_tpu_torch.train.objective import LossConfig
    from sunerf_tpu_torch.train.optim import OptimConfig, make_optimizer
    from sunerf_tpu_torch.train.step import create_train_state, make_train_step
    renderer, init = make_emission_system(model_config=emission_config(**NGP),
                                          device='cuda')
    params = init(torch.Generator(device=device).manual_seed(1))
    batch = _bench_batch(device)
    opt = make_optimizer(OptimConfig(table_lr_mult=10.0, adam_eps=1e-15))
    step = make_train_step(renderer, LossConfig(lambda_table_tv=1e-4), opt)
    state = create_train_state(params, opt)
    step(state, batch, 0)
    torch.cuda.synchronize()
    fused_mlp.LAUNCHES = fused_mlp.STASH_FWD_LAUNCHES = fused_mlp.STASH_BWD_LAUNCHES = 0
    fused_mlp.GRID_LAUNCHES = 0
    step(state, batch, 0)
    launches = {'k0': fused_mlp.LAUNCHES, 'k1': fused_mlp.STASH_FWD_LAUNCHES,
                'k2': fused_mlp.STASH_BWD_LAUNCHES, 'k5': fused_mlp.GRID_LAUNCHES}
    _check(launches == {'k0': 0, 'k1': 2, 'k2': 2, 'k5': 4}, f'NGP step launches {launches}')
    metrics = [step(state, batch, 0)[1] for _ in range(10)]
    losses = [float(m['loss']) for m in metrics]
    tv = [float(m['table_tv']) for m in metrics]
    print(f'[ngp] 8x512, levels {NGP["grid_sizes"]}, table_lr_mult 10, adam_eps 1e-15, '
          f'lambda_table_tv 1e-4: launches {launches} (expected 2 K1, 2 K2, 4 grid); '
          f'losses ' + ' '.join(f'{v:.5f}' for v in losses) + f'; table_tv {tv[0]:.3e} -> '
          f'{tv[-1]:.3e}', flush=True)
    _check(all(np.isfinite(losses)), 'NGP losses not finite')
    _check(losses[-1] < losses[0], f'NGP loss did not fall: {losses[0]} -> {losses[-1]}')
    step_ms = _step_times(step, state, batch, warmup=1, reps=5)
    print(f'[ngp] step {step_ms:.2f} ms ({1024 / step_ms * 1e3:.0f} rays/s; CUDA events, '
          f'median of 5)', flush=True)
    profile_row = _profile_step(step, state, batch, 'NGP step')
    return dict(launches=launches, losses=losses, table_tv=tv, step_ms=step_ms,
                rays_per_s=1024 / step_ms * 1e3, profile=profile_row)


def _grid_serve_phase(train: dict, device) -> dict:
    """The trained grid_quarter state as a bundle, rendered at 256^2."""
    from sunerf_tpu_torch.evaluation.loader import ModelLoader, SuNeRFLoader
    from sunerf_tpu_torch.models.fields import FieldOutput
    from sunerf_tpu_torch.ops import fused_mlp
    from sunerf_tpu_torch.utils.checkpoint import save_state
    view = dict(lat=0.3, lon=1.1, time=0.0, distance=4.0, resolution=256)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, 'grid_quarter')
        save_state(path, train['state'].params, {'renderer_spec': train['renderer'].spec})
        loader = SuNeRFLoader(path, device='cuda')
    _check(tuple(loader.params['fine']['grid_0'].shape) == (16, 16, 16, 8),
           'the bundle lost its grid table')
    loader.render_observer_image(**view)             # warm-up: weights packed
    torch.cuda.synchronize()
    fused_mlp.LAUNCHES = fused_mlp.GRID_LAUNCHES = 0
    got = loader.render_observer_image(**view)
    launches = {'k0': fused_mlp.LAUNCHES, 'k5': fused_mlp.GRID_LAUNCHES}
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        loader.render_observer_image(**view)
        times.append((time.perf_counter() - t0) * 1e3)
    render_ms = statistics.median(times)
    fine_cfg, coarse_cfg = train['configs']
    plain_apply = lambda cfg: lambda p, x: FieldOutput(raw=fused_mlp.fused_mlp_reference(cfg, p, x))
    plain_renderer = dataclasses.replace(loader.renderer, field_apply=plain_apply(fine_cfg),
                                         coarse_field_apply=plain_apply(coarse_cfg))
    plain = ModelLoader(plain_renderer, loader.params, device=device).render_observer_image(**view)
    err = {k: _rel(getattr(plain, k), getattr(got, k)) for k in MAPS}
    print(f'[gridserve] grid_quarter bundle at 256x256: {launches["k0"]} K0 launches, '
          f'{launches["k5"]} through the grid branch (expected 32, 16); {render_ms:.1f} ms '
          f'(median of 3, host clock to the host copy); vs the plain-version render: '
          + '; '.join(f'{k} {v:.3e}' for k, v in err.items()), flush=True)
    for k in MAPS:
        _check(bool(np.isfinite(getattr(got, k)).all()), f'grid render {k} not finite')
    _check(launches == {'k0': 32, 'k5': 16}, f'grid render launches {launches}')
    _check(err['image'] <= RENDER_TOL, f"grid render image vs plain {err['image']:.3e}")
    return dict(launches=launches, render_ms=render_ms, err=err)


def _setup_field(n_layers: int, width: int, n: int, device, seed: int, d_input: int = 4):
    """An emission field of the given widths (and d_input: 4 is x, y, z,
    t), random weights, points in the sampling shell and a dy, all from a
    seed."""
    from sunerf_tpu_torch.models.fields import emission_config, init_nerf
    cfg = dataclasses.replace(emission_config(n_layers=n_layers, d_filter=width),
                              d_input=d_input)
    gen = torch.Generator(device=device).manual_seed(seed)
    p = init_nerf(gen, cfg, device)
    pts = torch.rand(n, d_input, generator=gen, device=device) * 2.6 - 1.3
    if d_input == 4:
        pts[:, 3] = torch.rand(n, generator=gen, device=device)
    dy = torch.randn(n, cfg.d_output, generator=gen, device=device)
    return cfg, p, pts, dy


def _dpts_flops(cfg, n: int) -> float:
    """K3's operations: denc over the x, sin and cos columns, and per phase
    column the cotangent's products."""
    n_enc = cfg.d_encoded - cfg.d_grid
    return float(n) * (2 * n_enc * cfg.d_filter + 8 * (n_enc - cfg.d_input))


def _dpts_phase(name: str, n_layers: int, width: int, n: int, device, d_input: int = 4) -> dict:
    """K1 + K2/K3 against the plain version: dpts, and the parameter
    gradients bit-identical with and without K3; K3's cost; K2 + K3's
    kernels by name."""
    from sunerf_tpu_torch.ops import fused_mlp
    cfg, p, pts, dy = _setup_field(n_layers, width, n, device, seed=n + 11, d_input=d_input)
    tag = f'[dpts] {name} {n_layers}x{width} N={n} d_input={d_input}'
    _, hs, cs = fused_mlp.fused_mlp_stash_forward(cfg, p, pts)
    with_dpts = fused_mlp.fused_mlp_stash_backward(cfg, p, pts, dy, hs, cs, compute_dpts=True)
    without = fused_mlp.fused_mlp_stash_backward(cfg, p, pts, dy, hs, cs)
    ref = fused_mlp.fused_mlp_stash_bwd_reference(cfg, p, pts, dy, hs, cs, compute_dpts=True)
    torch.cuda.synchronize()
    identical = {k: bool(torch.equal(with_dpts[k], without[k])) for k in KEYS}
    derr = _grad_err({'dpts': ref['dpts']}, {'dpts': with_dpts['dpts']})['dpts']
    print(f"{tag}: dpts vs plain max {derr['max_rel_err']:.2e} RMS {derr['rms_rel_err']:.2e} "
          f"(tol {DPTS_TOL}); parameter gradients with and without K3 bit-identical: "
          f"{identical}", flush=True)
    _check(bool(torch.isfinite(with_dpts['dpts']).all()), f'{tag}: dpts not finite')
    _check(derr['max_rel_err'] <= DPTS_TOL, f"{tag}: dpts vs plain {derr['max_rel_err']:.3e}")
    _check(all(identical.values()), f'{tag}: K3 changed the parameter gradients: {identical}')
    del ref, with_dpts, without
    # K2 and K2 + K3 in turns (A B B A B A), the median of each
    k2_runs, k23_runs = [], []
    for with_k3 in (False, True, True, False, False, True):
        ms = _cuda_ms(lambda: fused_mlp.fused_mlp_stash_backward(
            cfg, p, pts, dy, hs, cs, compute_dpts=with_k3))
        (k23_runs if with_k3 else k2_runs).append(ms)
    k2_ms, k23_ms = statistics.median(k2_runs), statistics.median(k23_runs)
    plain_ms = _cuda_ms(lambda: fused_mlp.fused_mlp_stash_bwd_reference(
        cfg, p, pts, dy, hs, cs, compute_dpts=True), warmup=1, reps=3)
    plain_k2_ms = _cuda_ms(lambda: fused_mlp.fused_mlp_stash_bwd_reference(
        cfg, p, pts, dy, hs, cs), warmup=1, reps=3)
    kernels = _kernel_breakdown(lambda: fused_mlp.fused_mlp_stash_backward(
        cfg, p, pts, dy, hs, cs, compute_dpts=True), f'{tag} K2 + K3')
    # K3's own work: read the points, write dpts
    bound = _bound(_dpts_flops(cfg, n), n * 4 * 2 * cfg.d_input)
    print(f'{tag}: K2 {k2_ms:.3f} ms ({" ".join(f"{v:.3f}" for v in k2_runs)}), K2 + K3 '
          f'{k23_ms:.3f} ms ({" ".join(f"{v:.3f}" for v in k23_runs)}): K3 '
          f'{k23_ms - k2_ms:.3f} ms '
          f'(bound {bound[0]:.4f} by {bound[1]}); plain K2 + K3 {plain_ms:.1f} ms, plain '
          f'K3 {plain_ms - plain_k2_ms:.1f} ms', flush=True)
    return dict(n=n, layers=n_layers, width=width, d_input=d_input, k2_ms=k2_ms,
                k2_k3_ms=k23_ms, kernels_ms=kernels,
                k2_runs=k2_runs, k2_k3_runs=k23_runs,
                ms=k23_ms - k2_ms, plain_ms=plain_ms - plain_k2_ms, plain_k2_k3_ms=plain_ms,
                bound_ms=bound[0], bound_by=bound[1], max_abs_err=derr['max_abs_err'],
                max_rel_err=derr['max_rel_err'], dpts_err=derr, bit_identical=identical)


def _kernel_name(name: str) -> str:
    """A profiler kernel name without its return type, namespaces, parameter
    list and enum casts: 'void sunerf::(anonymous namespace)::chain_wgmma_kernel<
    512, (sunerf::(anonymous namespace)::Gate)2, true>(...)' ->
    'chain_wgmma_kernel<512, 2, true>'. The parameter list is cut at the first '('
    outside the template arguments, so casts inside them do not end it."""
    s = re.sub(r'\(anonymous namespace\)::|<unnamed>::', '', name)
    s = s[5:] if s.startswith('void ') else s
    depth = 0
    for i, ch in enumerate(s):
        depth += (ch == '<') - (ch == '>')
        if ch == '(' and depth == 0:
            s = s[:i]
            break
    head, sep, args = s.partition('<')
    return head.rsplit('::', 1)[-1] + sep + re.sub(r'\([\w:]+\)', '', args)


def _kernel_breakdown(fn, tag: str) -> dict:
    """Device ms and launches by kernel name of one fn() under
    torch.profiler, every kernel the call ran (the device events of
    prof.events(), as _profile_step reads them, after a throwaway kernel),
    against the call's time by CUDA events and the launch calls the
    profiler saw on the host (one more than the records: the throwaway's
    own record is the one lost)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        # the session's first kernel record is lost (one record fewer than
        # launch calls, always the first launch): a throwaway kernel takes it
        torch.zeros(1, device='cuda').add_(1)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
    ms, launches = {}, {}
    api = 0    # launch calls the profiler saw on the host
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            api += 'LaunchKernel' in evt.name
            continue
        if getattr(evt, 'is_user_annotation', False) or '#' in evt.name:
            continue
        name = _kernel_name(evt.name)
        ms[name] = ms.get(name, 0.0) + evt.device_time / 1e3
        launches[name] = launches.get(name, 0) + 1
    order = sorted(ms, key=lambda k: -ms[k])
    print(f'[profile] {tag}: {sum(ms.values()):.3f} ms of device kernels in '
          f'{start.elapsed_time(end):.3f} ms (CUDA events), {sum(launches.values())} kernel '
          f'records, {api} launch calls seen on the host; ' + '; '.join(
              f'{k} x{launches[k]} {ms[k]:.3f}' for k in order), flush=True)
    return {k: dict(ms=ms[k], launches=launches[k]) for k in order}


def _bwd_growth(fn) -> int:
    """Bytes by which max_memory_allocated rises over fn() above what was
    allocated before it."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base


def _recompute_phase(n: int, device) -> dict:
    """K0 + K4 through FusedMLPRecompute at 8x512: out, gradients, dpts,
    memory at N and 2N against the int8 stash path, times."""
    from sunerf_tpu_torch.ops import fused_mlp
    cfg, p, pts, dy = _setup_field(8, 512, n, device, seed=5)
    keys = fused_mlp.param_keys(cfg)
    tag = f'[recompute] 8x512 N={n}'
    leaves = {k: p[k].detach().clone().requires_grad_() for k in keys}
    x = pts.clone().requires_grad_()
    out = fused_mlp.fused_mlp_forward(cfg, leaves, x, stash=False)
    with torch.no_grad():
        k0 = fused_mlp.fused_mlp_forward(cfg, p, pts)
    same = bool(torch.equal(out.detach(), k0))
    out.backward(dy)
    got = dict({k: leaves[k].grad for k in keys}, dpts=x.grad)
    ref = fused_mlp.fused_mlp_recompute_bwd_reference(cfg, p, pts, dy)
    torch.cuda.synchronize()
    gerr = _grad_err(ref, got)
    print(f'{tag}: out under grad equals the no-grad K0: {same}; K4 vs plain, max / RMS: '
          + '; '.join(f"{k} {e['max_rel_err']:.2e} / {e['rms_rel_err']:.2e}"
                      for k, e in gerr.items()), flush=True)
    _check(same, f'{tag}: the output under grad is not K0\'s')
    for k, e in gerr.items():
        _check(bool(torch.isfinite(got[k]).all()), f'{tag}: {k} not finite')
        tol = DPTS_TOL if k == 'dpts' else GRAD_TOL
        _check(e['max_rel_err'] <= tol, f"{tag}: {k} vs plain {e['max_rel_err']:.3e} (tol {tol})")
    del got, ref, out, leaves, x
    torch.cuda.empty_cache()
    with torch.no_grad():
        first = fused_mlp.fused_mlp_recompute_backward(cfg, p, pts, dy)
        again = fused_mlp.fused_mlp_recompute_backward(cfg, p, pts, dy)
        torch.cuda.synchronize()
        twice = {k: bool(torch.equal(first[k], again[k])) for k in first}
    print(f'{tag}: K4 the same bits over two runs: {twice}', flush=True)
    _check(all(twice.values()), f'{tag}: K4 gave other bits the second time: {twice}')
    del first, again
    d12 = _recompute_any_d(65536, device)

    # memory: K4's backward at N and 2N, the int8 stash path's forward +
    # backward at N
    def k4_growth(m):
        c, q, pt, d = _setup_field(8, 512, m, device, seed=6)
        lv = [q[k].requires_grad_() for k in keys]
        xx = pt.requires_grad_()
        o = fused_mlp.fused_mlp_forward(c, q, xx, stash=False)
        g = _bwd_growth(lambda: torch.autograd.grad(o, lv + [xx], d))
        del o, lv, xx, q
        torch.cuda.empty_cache()
        return g

    def stash_growth(m):
        c, q, pt, d = _setup_field(8, 512, m, device, seed=6)
        lv = [q[k].requires_grad_() for k in keys]

        def run():
            o = fused_mlp.fused_mlp_forward(c, q, pt, compute_dpts=False)
            torch.autograd.grad(o, lv, d)
        g = _bwd_growth(run)
        del lv, q
        torch.cuda.empty_cache()
        return g
    grow = {'k4_n': k4_growth(n), 'k4_2n': k4_growth(2 * n), 'int8_n': stash_growth(n)}
    rel = abs(grow['k4_2n'] - grow['k4_n']) / grow['k4_n']
    print(f"{tag}: max_memory_allocated growth: K4 backward {grow['k4_n'] / 2 ** 30:.3f} GiB "
          f"at N, {grow['k4_2n'] / 2 ** 30:.3f} GiB at 2N ({rel:.1%} apart, tol "
          f"{MEM_TOL:.0%}); int8 stash path forward + backward {grow['int8_n'] / 2 ** 30:.3f} "
          f"GiB at N ({grow['k4_n'] / grow['int8_n']:.1%})", flush=True)
    _check(rel <= MEM_TOL, f'{tag}: K4 memory grows with N: {grow}')
    _check(grow['k4_n'] < grow['int8_n'] / 4, f'{tag}: K4 memory not under a quarter: {grow}')

    k4_ms = _cuda_ms(lambda: fused_mlp.fused_mlp_recompute_backward(cfg, p, pts, dy), reps=10)
    k4_kernels = _kernel_breakdown(
        lambda: fused_mlp.fused_mlp_recompute_backward(cfg, p, pts, dy), f'{tag} K4')
    plain_ms = _cuda_ms(lambda: fused_mlp.fused_mlp_recompute_bwd_reference(cfg, p, pts, dy),
                        warmup=1, reps=3)
    flops = _flops(cfg, n) + _bwd_flops(cfg, n) + _dpts_flops(cfg, n)
    bound = _bound(flops, n * 4 * (2 * cfg.d_input + cfg.d_output) + 2 * _param_bytes(cfg))
    print(f'{tag}: K4 {k4_ms:.3f} ms (plain {plain_ms:.1f}, bound {bound[0]:.3f} by '
          f'{bound[1]})', flush=True)
    return dict(n=n, ms=k4_ms, plain_ms=plain_ms, bound_ms=bound[0], bound_by=bound[1],
                max_abs_err=max(e['max_abs_err'] for e in gerr.values()),
                max_rel_err=max(e['max_rel_err'] for e in gerr.values()), grads=gerr,
                out_equals_k0=same, memory_bytes=grow, memory_2n_vs_n=rel,
                kernels_ms=k4_kernels, same_bits_twice=twice, d_input_12=d12)


def _recompute_any_d(n: int, device, d_input: int = 12) -> dict:
    """K4 at 8x512 with d_input = 12 over two chunks: every gradient
    within 3e-2 and dpts [N, 12] within 5e-2 of max of the plain version,
    the same bits over two runs; its kernels by name."""
    from sunerf_tpu_torch.ops import fused_mlp
    cfg, p, pts, dy = _setup_field(8, 512, n, device, seed=12, d_input=d_input)
    tag = f'[recompute] 8x512 N={n} d_input={d_input}'
    with torch.no_grad():
        got = fused_mlp.fused_mlp_recompute_backward(cfg, p, pts, dy)
        again = fused_mlp.fused_mlp_recompute_backward(cfg, p, pts, dy)
        ref = fused_mlp.fused_mlp_recompute_bwd_reference(cfg, p, pts, dy)
        torch.cuda.synchronize()
    gerr = _grad_err(ref, got)
    twice = all(torch.equal(got[k], again[k]) for k in got)
    print(f'{tag}: K4 vs plain, max / RMS: ' + '; '.join(
        f"{k} {e['max_rel_err']:.2e} / {e['rms_rel_err']:.2e}" for k, e in gerr.items())
        + f'; the same bits over two runs: {twice}', flush=True)
    _check(tuple(got['dpts'].shape) == (n, d_input), f'{tag}: dpts shape {tuple(got["dpts"].shape)}')
    for k, e in gerr.items():
        _check(bool(torch.isfinite(got[k]).all()), f'{tag}: {k} not finite')
        tol = DPTS_TOL if k == 'dpts' else GRAD_TOL
        _check(e['max_rel_err'] <= tol, f"{tag}: {k} vs plain {e['max_rel_err']:.3e} (tol {tol})")
    _check(twice, f'{tag}: K4 gave other bits the second time')
    del got, again, ref
    ms = _cuda_ms(lambda: fused_mlp.fused_mlp_recompute_backward(cfg, p, pts, dy), reps=5)
    kernels = _kernel_breakdown(lambda: fused_mlp.fused_mlp_recompute_backward(cfg, p, pts, dy),
                                f'{tag} K4')
    return dict(n=n, d_input=d_input, ms=ms, grads=gerr, same_bits_twice=twice,
                kernels_ms=kernels)


def _format_phase(fmt: str, n: int, device) -> dict:
    """K6a ('lsb') or K6b ('i8pair') at 8x512 against K1 and the plain
    versions; times and bounds."""
    from sunerf_tpu_torch.ops import fused_mlp
    cfg, p, pts, dy = _setup_field(8, 512, n, device, seed=7)
    group = fused_mlp.STASH_BWD_TILE
    tag = f'[{fmt}] 8x512 N={n}'
    k1_out, k1_hs, _ = fused_mlp.fused_mlp_stash_forward(cfg, p, pts)
    out, hs, _ = fused_mlp.fused_mlp_stash_forward(cfg, p, pts, fmt)
    torch.cuda.synchronize()
    same = bool(torch.equal(out, k1_out))
    lw, _ = fused_mlp.fused_mlp_stash_layerwise(cfg, p, pts, k1_hs, fmt)
    if fmt == 'lsb':
        # the sine within 1 bf16 ulp (2 apart once the last bit is cleared),
        # and the sign bit: where it differs, |cos| of the plain version's
        # reduced pre-activation
        bits, lw_bits = hs.view(torch.int16), lw.view(torch.int16)
        ulp1 = float((_bf16_ulps((lw_bits & -2).view(torch.bfloat16),
                                 (bits & -2).view(torch.bfloat16)) <= 2).float().mean())
        off = ((bits ^ lw_bits) & 1) != 0
        worst_cos = 0.0
        if bool(off.any()):
            _, ys = fused_mlp._stash_layers(cfg, p, pts, inputs=k1_hs)
            worst_cos = float(torch.cos(torch.cat(ys, 1)[off]).abs().max())
            del ys
        stash = dict(within_1ulp_layerwise=ulp1, sign_bits_off=int(off.sum()),
                     sign_off_max_abs_cos=worst_cos)
        ok = ulp1 >= 0.999 and worst_cos < 1e-3
    else:
        diff = int((hs.int() - lw.int()).abs().max())
        stash = dict(max_count_diff_layerwise=diff)
        ok = diff <= 1
    del lw, k1_hs
    print(f'{tag}: out equals K1\'s: {same}; stash layer by layer {stash}', flush=True)
    _check(same, f'{tag}: out differs from K1\'s')
    _check(ok, f'{tag}: stash vs the layerwise plain version {stash}')

    grads = fused_mlp.fused_mlp_stash_backward(cfg, p, pts, dy, hs, None, fmt, True, group)
    ref = fused_mlp.fused_mlp_stash_bwd_reference(cfg, p, pts, dy, hs, None, fmt, True, group)
    torch.cuda.synchronize()
    gerr = _grad_err(ref, grads)
    print(f'{tag}: backward vs plain (group {group}), max / RMS: ' + '; '.join(
        f"{k} {e['max_rel_err']:.2e} / {e['rms_rel_err']:.2e}" for k, e in gerr.items()),
        flush=True)
    for k, e in gerr.items():
        _check(bool(torch.isfinite(grads[k]).all()), f'{tag}: {k} not finite')
        tol = DPTS_TOL if k == 'dpts' else GRAD_TOL
        _check(e['max_rel_err'] <= tol, f"{tag}: {k} vs plain {e['max_rel_err']:.3e} (tol {tol})")
    digest = hashlib.sha256(b''.join(grads[k].cpu().numpy().tobytes()
                                     for k in sorted(grads))).hexdigest()[:16]
    print(f'{tag}: sha256 of the gradients at group {group}: {digest}', flush=True)
    del grads, ref
    small = _i8pair_small_groups(device) if fmt == 'i8pair' else None
    extra = _lsb_ablations(n) if fmt == 'lsb' else _dw_h_yardsticks(cfg, hs, device)
    fwd_ms = _cuda_ms(lambda: fused_mlp.fused_mlp_stash_forward(cfg, p, pts, fmt))
    bwd_ms = _cuda_ms(lambda: fused_mlp.fused_mlp_stash_backward(cfg, p, pts, dy, hs, None,
                                                                 fmt, True, group))
    fwd_plain = _cuda_ms(lambda: fused_mlp.fused_mlp_stash_reference(cfg, p, pts, fmt),
                         warmup=1, reps=3)
    bwd_plain = _cuda_ms(lambda: fused_mlp.fused_mlp_stash_bwd_reference(
        cfg, p, pts, dy, hs, None, fmt, True, group), warmup=1, reps=3)
    bwd_kernels = _kernel_breakdown(lambda: fused_mlp.fused_mlp_stash_backward(
        cfg, p, pts, dy, hs, None, fmt, True, group), f'{tag} backward')
    io = n * 4 * (cfg.d_input + cfg.d_output)
    stash_bytes = n * cfg.n_layers * cfg.d_filter * 2
    b_fwd = _bound(_flops(cfg, n), io + stash_bytes + _param_bytes(cfg))
    # the backward with K3; 'i8pair' takes dW_h's products on the int8 cores
    bwd_flops = _bwd_flops(cfg, n) + _dpts_flops(cfg, n)
    i8_flops = 2.0 * n * (cfg.n_layers - 1) * cfg.d_filter ** 2 if fmt == 'i8pair' else 0.0
    t_ops = ((bwd_flops - i8_flops) / (BF16_TFLOPS * 1e12)
             + i8_flops / (INT8_TOPS * 1e12)) * 1e3
    t_bytes = (io + stash_bytes + 2 * _param_bytes(cfg) + n * 4 * cfg.d_input) \
        / (HBM_TBPS * 1e12) * 1e3
    b_bwd = (max(t_ops, t_bytes), 'operations' if t_ops >= t_bytes else 'bytes')
    print(f'{tag}: forward {fwd_ms:.3f} ms (plain {fwd_plain:.1f}, bound {b_fwd[0]:.3f} by '
          f'{b_fwd[1]}); backward with K3 {bwd_ms:.3f} ms (plain {bwd_plain:.1f}, bound '
          f'{b_bwd[0]:.3f} by {b_bwd[1]})', flush=True)
    return dict(n=n, group=group, fwd_ms=fwd_ms, bwd_ms=bwd_ms, ms=fwd_ms + bwd_ms,
                fwd_plain_ms=fwd_plain, bwd_plain_ms=bwd_plain, plain_ms=fwd_plain + bwd_plain,
                fwd_bound_ms=b_fwd[0], fwd_bound_by=b_fwd[1], bwd_bound_ms=b_bwd[0],
                bwd_bound_by=b_bwd[1], bound_ms=b_fwd[0] + b_bwd[0],
                bound_by='operations' if 'operations' in (b_fwd[1], b_bwd[1]) else 'bytes',
                max_abs_err=max(e['max_abs_err'] for e in gerr.values()),
                max_rel_err=max(e['max_rel_err'] for e in gerr.values()), grads=gerr,
                out_equals_k1=same, stash=stash, bwd_kernels_ms=bwd_kernels,
                grads_sha256=digest, small_groups=small, **extra)


def _lsb_ablations(n: int) -> dict:
    """K6a's gate path taken apart (scripts/backward_ablation.py): the 'lsb'
    backward with K3 as built, with the gate loaded but not decoded, and
    decoded but not loaded (variants built with -D; their gradients are
    wrong and only timed)."""
    from sunerf_tpu_torch.scripts import backward_ablation
    rows = backward_ablation.measure('lsb', n)
    for tag, r in rows.items():
        print(f"[lsb] ablation, {tag}: backward {r['ms']:.3f} ms; " + '; '.join(
            f"{k} x{v['launches']} {v['ms']:.3f}" for k, v in r['kernels'].items()), flush=True)
    return dict(ablations=rows)


def _dw_h_yardsticks(cfg, hs8, device) -> dict:
    """Library yardsticks of K6b's dW_h at its shape, timed here and never
    on the path: one bf16 torch.bmm of the L-1 products hs_{j-1}^T dz_j (the
    stash's sin8 as bf16, dz normal), and torch._int_mm of the same int8
    products, one call a layer, summed (dz8 uniform in [-127, 127])."""
    n, L, H = hs8.shape[0], cfg.n_layers, cfg.d_filter
    gen = torch.Generator(device=device).manual_seed(9)
    s8 = hs8.view(n, L, 2, H)[:, :L - 1, 0].permute(1, 2, 0).contiguous()
    dz8 = torch.randint(-127, 128, (L - 1, n, H), generator=gen, device=device,
                        dtype=torch.int8)
    int_mm_ms = _cuda_ms(lambda: [torch._int_mm(s8[j], dz8[j]) for j in range(L - 1)], reps=5)
    del dz8
    s16 = s8.to(torch.bfloat16)
    del s8
    dzb = torch.randn((L - 1, n, H), generator=gen, device=device).to(torch.bfloat16)
    bmm_ms = _cuda_ms(lambda: torch.bmm(s16, dzb), reps=5)
    del s16, dzb
    print(f'[i8pair] dW_h yardsticks (never on the path), 8x512 N={n}: one bf16 torch.bmm '
          f'{bmm_ms:.3f} ms; torch._int_mm x{L - 1} {int_mm_ms:.3f} ms', flush=True)
    return dict(dw_h_bmm_ms=bmm_ms, dw_h_int_mm_ms=int_mm_ms)


def _i8pair_small_groups(device, n: int = 4097) -> dict:
    """K6b's backward at scale groups that are not multiples of 64 (8, 16,
    24: dw_i8_wgmma_kernel takes each 64-point chunk a group segment at a
    time) against
    the plain version at the same group, 8x512 with a ragged N: every
    gradient within GRAD_TOL, dpts within DPTS_TOL, two runs bit-identical."""
    from sunerf_tpu_torch.ops import fused_mlp
    cfg, p, pts, dy = _setup_field(8, 512, n, device, seed=8)
    _, hs, _ = fused_mlp.fused_mlp_stash_forward(cfg, p, pts, 'i8pair')
    rows = {}
    for group in I8PAIR_GROUPS:
        run = lambda: fused_mlp.fused_mlp_stash_backward(  # noqa: E731
            cfg, p, pts, dy, hs, None, 'i8pair', True, group)
        grads, again = run(), run()
        ref = fused_mlp.fused_mlp_stash_bwd_reference(cfg, p, pts, dy, hs, None, 'i8pair',
                                                      True, group)
        torch.cuda.synchronize()
        gerr = _grad_err(ref, grads)
        same = all(torch.equal(grads[k], again[k]) for k in grads)
        print(f'[i8pair] group {group}, 8x512 N={n}: backward vs plain, max / RMS: '
              + '; '.join(f"{k} {e['max_rel_err']:.2e} / {e['rms_rel_err']:.2e}"
                          for k, e in gerr.items()) + f'; bit-identical run to run: {same}',
              flush=True)
        for k, e in gerr.items():
            tol = DPTS_TOL if k == 'dpts' else GRAD_TOL
            _check(bool(torch.isfinite(grads[k]).all()) and e['max_rel_err'] <= tol,
                   f"[i8pair] group {group}: {k} vs plain {e['max_rel_err']:.3e} (tol {tol})")
        _check(same, f'[i8pair] group {group}: two runs differ')
        rows[group] = dict(max_rel_err=max(e['max_rel_err'] for e in gerr.values()),
                           grads=gerr, bit_identical=same)
    return rows


def _bench_kernel_phase() -> dict:
    """The ported kernel micro-benchmark, with its launches counted."""
    from sunerf_tpu_torch.ops import fused_mlp
    from sunerf_tpu_torch.scripts import bench_kernel, probe_step
    for k in probe_step.COUNTERS:
        setattr(fused_mlp, k, 0)
    print('[bench_kernel] python -m sunerf_tpu_torch.scripts.bench_kernel --n 262144 '
          '(CUDA events, median of 20)', flush=True)
    rows = bench_kernel.main(['--n', '262144'])
    launches = probe_step.launch_counts()
    print(f'[bench_kernel] launches over the run: {launches}', flush=True)
    for k in ('DPTS_LAUNCHES', 'RECOMPUTE_BWD_LAUNCHES', 'LSB_LAUNCHES', 'I8PAIR_LAUNCHES'):
        _check(launches[k] > 0, f'bench_kernel launched no {k}')
    return dict(rows=rows, launches=launches)


def _probe_step_phase(device) -> dict:
    """bench.py's step under the four knob sets of the ported probe_step."""
    from sunerf_tpu_torch.scripts import probe_step
    rows = []
    for knob, expect in PROBE_KNOBS:
        row = probe_step.measure(knob, device=device, n_steps=N_CURVE)
        launches = {k: v for k, v in row['launches'].items() if v}
        want = {k: v for k, v in expect.items() if v}
        print(f"[probe_step] {str(knob):28s} {row['ms']:7.2f} ms/step {row['rays_per_s']:8.0f} "
              f"rays/s; launches of one step {launches} (expected {want}); {N_CURVE} steps "
              f"{row['losses'][0]:.5f} -> {row['losses'][-1]:.5f}", flush=True)
        _check(launches == want, f'probe_step {knob}: launches {launches}, not {want}')
        _check(all(np.isfinite(row['losses'])), f'probe_step {knob}: losses not finite')
        _check(row['losses'][-1] < row['losses'][0], f'probe_step {knob}: loss did not fall')
        rows.append(row)
    base = rows[0]['losses'][-1]
    for row in rows[1:]:
        gap = abs(row['losses'][-1] - base) / base
        row['last_loss_vs_default'] = gap
        print(f"[probe_step] {row['knob']}: last loss {gap:.3%} from {{}}'s (tol "
              f"{PROBE_CURVE_TOL:.0%})", flush=True)
        _check(gap <= PROBE_CURVE_TOL, f"probe_step {row['knob']}: last loss {gap:.3%} off")
    return dict(rows=rows)


def _tap_row(G: int, n: int, gen, device) -> dict:
    """P1 against its plain version and grid_sample at one shape."""
    from torch.nn.functional import grid_sample
    from sunerf_tpu_torch.ops import grid_probes as gp
    F, b = 8, PROBE_BOUND
    table4 = torch.randn((G, G, G, F), generator=gen, device=device)
    packed = gp.pack_table(table4)
    # input sets (points, and the outputs each call writes) of 100 MB in all
    sets = -(-100_000_000 // (n * (12 + 4 * F)))
    pts = [torch.rand((n, 3), generator=gen, device=device) * 2.4 - 1.2
           for _ in range(sets)]
    out = gp.tap_encode(packed, pts[0], G, b)
    ref = gp.tap_encode_reference(packed, pts[0], G, b)
    # the library call: a [1, F, G(y), G(z), G(x)] volume at (x, z, y) / b
    vol = table4.permute(3, 0, 1, 2)[None].contiguous()
    grids = [(p[:, [0, 2, 1]] / b).reshape(1, n, 1, 1, 3).contiguous() for p in pts]
    lib = lambda g: grid_sample(vol, g, mode='bilinear', padding_mode='border',
                                align_corners=True)
    lib_out = lib(grids[0]).reshape(F, n).T
    torch.cuda.synchronize()
    _check(bool(torch.isfinite(out).all()), f'P1 G={G} N={n}: non-finite output')
    err = float((out - ref).abs().max())
    lib_err = float((lib_out - ref).abs().max())
    ms = _graph_ms([lambda p=p: gp.tap_encode(packed, p, G, b) for p in pts])
    plain_ms = _graph_ms([lambda p=p: gp.tap_encode_reference(packed, p, G, b) for p in pts])
    library_ms = _graph_ms([lambda g=g: lib(g) for g in grids])
    # one call between CUDA events, as the script times it: host dispatch
    # included
    event_ms = _cuda_ms(lambda: gp.tap_encode(packed, pts[0], G, b))
    # bytes: the points and outputs once, the table once; operations: the
    # taps' multiply-adds and the corner weights, float32 on the CUDA cores
    nbytes = n * (12 + 4 * F) + 4 * G ** 3 * F
    t_bytes = nbytes / (HBM_TBPS * 1e12) * 1e3
    t_ops = n * (2 * 8 * F + 16) / (F32_TFLOPS * 1e12) * 1e3
    # the L2 gather floor: the taps' sectors over the L2's rate for them
    # (sector_read: P1's loads of n random cells of this table, no
    # arithmetic), so the floor is that microbenchmark's time
    sectors = 8 * -(-4 * F // 32)
    l2_floor = _graph_ms([lambda: gp.sector_read(packed, G, n)])
    l2_rate = n * sectors * 32 / (l2_floor * 1e-3)
    row = dict(G=G, n=n, features=F, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
               bound_ms=max(t_bytes, t_ops),
               bound_by='bytes' if t_bytes >= t_ops else 'operations',
               l2_floor_ms=l2_floor, l2_rate_tbps=l2_rate / 1e12, l2_sectors_a_point=sectors,
               floor_ms=max(t_bytes, t_ops, l2_floor),
               floor_by='L2 gathers' if l2_floor > max(t_bytes, t_ops) else 'bytes',
               ns_per_tap=ms * 1e6 / (n * 8), event_ms=event_ms, input_sets=sets,
               max_abs_err=err,
               library_max_abs_err=lib_err, max_abs=float(ref.abs().max()))
    print(f"[grid_probes] P1 G={G} N={n}: kernel {ms:.4f} ms ({row['ns_per_tap']:.4f} ns a "
          f"tap; {event_ms:.4f} by events around one call), plain {plain_ms:.4f}, "
          f"grid_sample {library_ms:.4f}, bound "
          f"{row['bound_ms']:.4f} ms by {row['bound_by']}, L2 gather floor {l2_floor:.4f} ms "
          f"({sectors} sectors a point at {l2_rate / 1e12:.2f} TB/s, P1's gathers alone): "
          f"held by {row['floor_by']}; kernel vs plain max abs "
          f"{err:.2e} (tol {TAP_TOL}), grid_sample vs plain {lib_err:.2e}", flush=True)
    _check(err <= TAP_TOL, f'P1 G={G} N={n}: kernel vs plain {err:.3e}')
    return row


def _hat_rows(gen, device) -> dict:
    """P2, each variant, against its plain version, and grid_sample."""
    from torch.nn.functional import grid_sample
    from sunerf_tpu_torch.ops import grid_probes as gp
    n, G, F = HAT_SHAPE
    b = PROBE_BOUND
    table = torch.randn((G * G, G * F), generator=gen, device=device).to(torch.bfloat16)
    pts = torch.rand((n, 3), generator=gen, device=device) * 2.4 - 1.2
    e1, e2 = (torch.from_numpy(e).to(device, torch.bfloat16)
              for e in gp.expansion_matrices(G))
    # bytes: points, output and table once (E too for expand); operations:
    # the 4 nonzero hats of a row times the table, float32; the dense
    # product's own time on the bf16 tensor cores beside it
    base_bytes = n * 12 + 4 * n * G * F + 2 * G ** 3 * F
    t_ops = n * 8 * G * F / (F32_TFLOPS * 1e12) * 1e3
    dense_tc_ms = 2.0 * n * G ** 3 * F / (BF16_TFLOPS * 1e12) * 1e3
    rows = {}
    for variant in gp.HAT_VARIANTS:
        ops = (e1, e2) if variant == 'expand' else ()
        out = gp.hat_encode(table, pts, G, b, variant, *ops)
        ref = gp.hat_encode_reference(table, pts, G, b, variant, *ops)
        torch.cuda.synchronize()
        _check(bool(torch.isfinite(out).all()), f'P2 {variant}: non-finite output')
        m = float(ref.abs().max())
        err = float((out - ref).abs().max())
        rms = float((out - ref).pow(2).mean().sqrt())
        del out, ref
        ms = _graph_ms([lambda: gp.hat_encode(table, pts, G, b, variant, *ops)])
        # ~4 GB of intermediates a call: one call at a time, between events
        plain_ms = _cuda_ms(lambda: gp.hat_encode_reference(table, pts, G, b, variant, *ops),
                            warmup=1, reps=5)
        t_bytes = (base_bytes + (4 * G ** 3 if variant == 'expand' else 0)) \
            / (HBM_TBPS * 1e12) * 1e3
        rows[variant] = dict(n=n, G=G, features=F, ms=ms, plain_ms=plain_ms,
                             bound_ms=max(t_bytes, t_ops),
                             bound_by='bytes' if t_bytes >= t_ops else 'operations',
                             dense_tc_ms=dense_tc_ms, max_abs_err=err, max_rel_err=err / m,
                             rms_rel_err=rms / m)
        print(f"[grid_probes] P2 {variant} N={n} G={G} F={F}: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.3f}, bound {rows[variant]['bound_ms']:.4f} ms by "
              f"{rows[variant]['bound_by']} (dense product on the tensor cores "
              f"{dense_tc_ms:.4f}); kernel vs plain max {err / m:.2e} RMS {rms / m:.2e} of "
              f"max (tol {HAT_TOL} + 1e-4, RMS {HAT_RMS_TOL})", flush=True)
        _check(err <= HAT_TOL * m + 1e-4 and rms <= HAT_RMS_TOL * m,
               f'P2 {variant}: kernel vs plain max {err:.3e}, RMS {rms:.3e} of max {m:.3e}')
    # the library call: a [1, G F, G(y), G(z)] plane at (z, y) / b, on the
    # float32 copy of the table (the function up to the kernel's bf16 hats);
    # grid_sample takes coordinates of the input's type, so its bf16 form
    # also rounds the points and is recorded beside it, not in its place
    ref = gp.hat_encode_reference(table, pts, G, b, 'iota')
    plane = table.float().T.reshape(1, G * F, G, G).contiguous()
    grid = (pts[:, [2, 1]] / b).reshape(1, n, 1, 2).contiguous()
    lib = lambda v, g: grid_sample(v, g, mode='bilinear', padding_mode='border',
                                   align_corners=True)
    m = float(ref.abs().max())
    lib_err = float((lib(plane, grid).reshape(G * F, n).T - ref).abs().max()) / m
    library = dict(library_ms=_graph_ms([lambda: lib(plane, grid)]),
                   library_dtype='float32', library_max_rel_err=lib_err)
    plane16, grid16 = plane.bfloat16(), grid.bfloat16()
    try:        # whether grid_sample dispatches bf16 on CUDA: recorded, no check
        lib_bf16 = lib(plane16, grid16)
    except RuntimeError as e:
        library['library_bf16'] = f'not dispatched: {str(e)[:80]}'
    else:
        library['library_bf16_ms'] = _graph_ms([lambda: lib(plane16, grid16)])
        library['library_bf16_max_rel_err'] = float(
            (lib_bf16.float().reshape(G * F, n).T - ref).abs().max()) / m
    print(f'[grid_probes] P2 grid_sample on the float32 table: {library}', flush=True)
    for r in rows.values():
        r.update(library)
    return rows


def _grid_probe_phase(device) -> dict:
    """P1 and P2: the two ported probe scripts at their defaults with their
    launches counted, their --check modes on the card, then each kernel
    against its plain version and grid_sample."""
    from sunerf_tpu_torch.ops import grid_probes as gp
    from sunerf_tpu_torch.scripts import probe_grid_hatbuild, probe_grid_taps
    print('[grid_probes] python -m sunerf_tpu_torch.scripts.probe_grid_taps; python -m '
          'sunerf_tpu_torch.scripts.probe_grid_hatbuild (utils/profiling.timeit: 20 calls '
          'in a CUDA graph, median of 3 replays)', flush=True)
    gp.TAP_LAUNCHES = gp.HAT_LAUNCHES = 0
    taps = probe_grid_taps.main([])
    hats = probe_grid_hatbuild.main([])
    launches = dict(TAP_LAUNCHES=gp.TAP_LAUNCHES, HAT_LAUNCHES=gp.HAT_LAUNCHES)
    print(f'[grid_probes] launches over the two scripts\' runs: {launches}', flush=True)
    _check(launches['TAP_LAUNCHES'] > 0, 'probe_grid_taps launched no P1')
    _check(launches['HAT_LAUNCHES'] > 0, 'probe_grid_hatbuild launched no P2')
    checks = dict(taps=probe_grid_taps.main(['--check']),
                  hatbuild=probe_grid_hatbuild.main(['--check']))
    gen = torch.Generator(device=device).manual_seed(3)
    with torch.no_grad():
        tap_rows = {f'G={g} N={n}': _tap_row(g, n, gen, device) for g, n in TAP_SHAPES}
        hat_rows = _hat_rows(gen, device)
    # the script times the device, not its dispatch: its JSON against the
    # graph time of the same shape, within SCRIPT_TIME_TOL
    for g in (32, 64):
        ratio = taps[f'taps_{g}^3_ms'] / tap_rows[f'G={g} N=65536']['ms']
        print(f'[grid_probes] P1 G={g}: the script\'s taps_{g}^3_ms over the graph time '
              f'{ratio:.3f} (tol {SCRIPT_TIME_TOL}x either way)', flush=True)
        _check(1 / SCRIPT_TIME_TOL <= ratio <= SCRIPT_TIME_TOL,
               f'probe_grid_taps G={g} times {ratio:.3f}x the device time')
    return dict(launches=launches, taps=taps, hatbuild=hats, checks=checks,
                tap_rows=tap_rows, hat_rows=hat_rows)


def main() -> int:
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device; this script runs on the card',
              file=sys.stderr)
        return 1
    root = Path(__file__).resolve().parent
    os.chdir(root)
    sys.path.insert(0, str(root))
    from sunerf_tpu_torch.core.geometry import observer_rays
    from sunerf_tpu_torch.evaluation.loader import ModelLoader, SuNeRFLoader
    from sunerf_tpu_torch.evaluation.video import render_video_frames
    from sunerf_tpu_torch.models.fields import (FieldOutput, NeRFConfig,
                                                params_from_numpy)
    from sunerf_tpu_torch.ops import build, fused_mlp
    from sunerf_tpu_torch.systems import from_spec
    from sunerf_tpu_torch.utils.checkpoint import load_state

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device('cuda')
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(f'device: {torch.cuda.get_device_name(0)} ({smi}), torch '
          f'{torch.__version__}, CUDA {torch.version.cuda}', flush=True)

    # 1. build ----------------------------------------------------------
    t0 = time.perf_counter()
    # the kernels, and the [lsb] phase's two measurement-only ablation
    # variants of the stashing backward, one nvcc each, all at once
    from sunerf_tpu_torch.scripts.backward_ablation import VARIANTS
    builds = [(k, ()) for k in KERNELS] + [('fused_mlp_stash_bwd', d)
                                           for _, d, _ in VARIANTS['lsb'] if d]
    with ThreadPoolExecutor(len(builds)) as pool:
        built = list(pool.map(lambda b: build.build(*b), builds))
    print(f'[build] {", ".join(KERNELS)} and {len(builds) - len(KERNELS)} ablation variants: '
          f'{time.perf_counter() - t0:.1f} s (parallel nvcc)', flush=True)
    for (name, defines), (path, log) in zip(builds, built):
        print(f'[build] {" ".join((name,) + defines)}: {path}')
        for line in log.splitlines():
            if 'registers' in line or 'spill' in line or 'Compiling entry' in line:
                print('[build]', line.strip())

    # 2. kernel against its plain version --------------------------------
    params_np, bundle_cfg = load_state(BUNDLE)
    params = params_from_numpy(params_np, device)
    spec = bundle_cfg['renderer_spec']
    render = spec['render']
    fields = {
        'fine': (NeRFConfig(**spec['model_config']),
                 4096 * (render['n_stratified'] + render['n_hierarchical'])),
        'coarse': (NeRFConfig(**spec['coarse_model_config']),
                   4096 * render['n_stratified']),
    }
    gen = torch.Generator(device=device).manual_seed(0)
    kernel_rows = {}
    with torch.inference_mode():
        for name, (cfg, n) in fields.items():
            pts = torch.rand(n, 4, generator=gen, device=device) * 2.6 - 1.3
            pts[:, 3] = 0.0
            p = params[name]
            ref = fused_mlp.fused_mlp_reference(cfg, p, pts)
            floor = _err_stats(ref, fused_mlp.fused_mlp_reference(
                cfg, {k: v.cpu() for k, v in p.items()}, pts.cpu()))
            out = fused_mlp.fused_mlp_forward(cfg, p, pts)
            torch.cuda.synchronize()
            _check(bool(torch.isfinite(out).all()), f'{name}: non-finite K0 output')
            err = _err_stats(ref, out)
            print(f'[kernel] {name} K0 vs plain: {_fmt(err)}', flush=True)
            _check(err['p9999_rel_err'] <= KERNEL_TOL and err['rms_rel_err'] <= KERNEL_RMS_TOL
                   and err['max_rel_err'] <= KERNEL_MAX_TOL,
                   f'{name}: K0 vs plain {_fmt(err)} (tol p99.99 {KERNEL_TOL}, rms '
                   f'{KERNEL_RMS_TOL}, max {KERNEL_MAX_TOL})')
            ms = _cuda_ms(lambda: fused_mlp.fused_mlp_forward(cfg, p, pts))
            plain_ms = _cuda_ms(lambda: fused_mlp.fused_mlp_reference(cfg, p, pts))
            bound_ms = _flops(cfg, n) / (BF16_TFLOPS * 1e12) * 1e3
            kernel_rows[name] = dict(n=n, layers=cfg.n_layers, width=cfg.d_filter, ms=ms,
                                     plain_ms=plain_ms, bound_ms=bound_ms, **err,
                                     plain_cpu_vs_card=floor)
            print(f'[kernel] {name} {cfg.n_layers}x{cfg.d_filter} N={n}: K0 {ms:.3f} ms; '
                  f'plain {plain_ms:.3f} ms, bound {bound_ms:.3f} ms', flush=True)
            print(f'[kernel] {name} plain on the CPU vs on the card: {_fmt(floor)}',
                  flush=True)

    stash_rows = {}
    with torch.no_grad():
        for name, n_layers, width, n in STASH_SHAPES:
            stash_rows[name] = _stash_phase(name, n_layers, width, n, device)
    torch.cuda.empty_cache()

    # 3. render through the port's loader --------------------------------
    loader = SuNeRFLoader(BUNDLE, device='cuda')
    view256 = dict(VIEW, resolution=256)
    loader.render_observer_image(**view256)          # warm-up: weights packed
    torch.cuda.synchronize()
    fused_mlp.LAUNCHES = 0
    view = loader.render_observer_image(**view256)
    launches = fused_mlp.LAUNCHES
    print(f'[render] 256x256: {launches} kernel launches (expected 32) at widths '
          f'{sorted({cfg.d_filter for cfg, _ in fields.values()})}', flush=True)
    _check(launches == 32, f'render launched the kernel {launches} times, not 32')
    for k in MAPS:
        _check(bool(np.isfinite(getattr(view, k)).all()), f'render {k} not finite')
    render_times = []
    for _ in range(3):
        t0 = time.perf_counter()
        loader.render_observer_image(**view256)
        render_times.append((time.perf_counter() - t0) * 1e3)
    render_ms = statistics.median(render_times)
    print(f'[render] 256x256 fused: {render_ms:.1f} ms (median of 3, host clock '
          f'to the host copy of the products)', flush=True)

    # where a render's device time goes (torch.profiler over one render)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        loader.render_observer_image(**view256)
        prof_wall_ms = (time.perf_counter() - t0) * 1e3
    by_kernel, n_kernel = {}, {}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            name = _kernel_name(evt.name)
            by_kernel[name] = by_kernel.get(name, 0.0) + evt.device_time / 1e3
            n_kernel[name] = n_kernel.get(name, 0) + 1
    device_ms = sum(by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]
    breakdown = dict(wall_ms=prof_wall_ms, device_ms=device_ms,
                     top={k[:60]: v for k, v in top})
    print(f'[profile] 256x256 render: {prof_wall_ms:.1f} ms wall, {device_ms:.1f} ms '
          f'of device kernels; top: ' + '; '.join(f'{k[:40]} x{n_kernel[k]} {v:.1f} ms'
                                                   for k, v in top), flush=True)

    # the same render with both fields through the kernel's plain version,
    # and with the float32 field (the JAX package's bf16 kernel is itself
    # 6.6% of max from its float32 render at 32x32: the gap is reported)
    def plain_apply(cfg):
        return lambda p, x: FieldOutput(raw=fused_mlp.fused_mlp_reference(cfg, p, x))
    base, _ = from_spec(spec, use_fused=False, device=device)
    plain_renderer = dataclasses.replace(
        base, field_apply=plain_apply(fields['fine'][0]),
        coarse_field_apply=plain_apply(fields['coarse'][0]))
    plain_view = ModelLoader(plain_renderer, loader.params,
                             device=device).render_observer_image(**view256)
    f32_loader = SuNeRFLoader(BUNDLE, use_fused=False, device='cuda')
    f32_view = f32_loader.render_observer_image(**view256)
    f32_times = []
    for _ in range(3):
        t0 = time.perf_counter()
        f32_loader.render_observer_image(**view256)
        f32_times.append((time.perf_counter() - t0) * 1e3)
    f32_render_ms = statistics.median(f32_times)
    print(f'[render] 256x256 float32 field: {f32_render_ms:.1f} ms (median of 3)',
          flush=True)
    render_err = {}
    for k in MAPS:
        r_plain = _rel(getattr(plain_view, k), getattr(view, k))
        r_f32 = _rel(getattr(f32_view, k), getattr(view, k))
        render_err[k] = dict(vs_plain=r_plain, vs_float32=r_f32)
        print(f'[render] 256x256 {k}: kernel vs plain-version render {r_plain:.3e}'
              f'{f" (tol {RENDER_TOL})" if k == "image" else ""}; vs float32 '
              f'render {r_f32:.3e}', flush=True)
    _check(render_err['image']['vs_plain'] <= RENDER_TOL,
           f"render image: kernel vs plain {render_err['image']['vs_plain']:.3e}")

    golden = np.load(GOLDEN)
    lat, lon, t, dist, res = golden['view']
    gview = dict(lat=float(lat), lon=float(lon), time=float(t),
                 distance=float(dist), resolution=int(res))
    g_fused = loader.render_observer_image(**gview)
    g_f32 = f32_loader.render_observer_image(**gview)
    golden_err = {}
    for k in MAPS:
        golden_err[k] = dict(
            fused=_rel(golden[f'fused/{k}'], getattr(g_fused, k)),
            float32=_rel(golden[f'unfused/{k}'], getattr(g_f32, k)),
            card_fused_vs_f32=_rel(getattr(g_f32, k), getattr(g_fused, k)),
            jax_fused_vs_f32=_rel(golden[f'unfused/{k}'], golden[f'fused/{k}']))
        e = golden_err[k]
        print(f'[golden] {res}x{res} {k}: kernel vs JAX kernel {e["fused"]:.3e}; '
              f'float32 vs JAX float32 {e["float32"]:.3e}; kernel vs float32 '
              f'{e["card_fused_vs_f32"]:.3e} here, {e["jax_fused_vs_f32"]:.3e} '
              f'in JAX', flush=True)
    # float32 conditioning at 1 AU: the float32 render against the same
    # render in float64 on the card, from the same float32 rays
    rays_o, rays_d = observer_rays(gview['lat'], gview['lon'], gview['distance'],
                                   gview['resolution'])
    f64 = lambda x: torch.as_tensor(x.reshape(-1, 3), dtype=torch.float64,
                                    device=device)
    params64 = {f: {k: v.double() for k, v in p.items()} for f, p in params.items()}
    with torch.inference_mode():
        out64 = base(params64, f64(rays_o), f64(rays_d),
                     torch.full((rays_o.shape[0] ** 2, 1), gview['time'],
                                dtype=torch.float64, device=device))
    for k in MAPS:
        golden_err[k]['float32_vs_float64'] = _rel(
            out64[k].cpu().numpy().reshape(getattr(g_f32, k).shape),
            getattr(g_f32, k))
    print('[golden] float32 render vs float64 render on the card: ' + '; '.join(
        f"{k} {golden_err[k]['float32_vs_float64']:.3e}" for k in MAPS), flush=True)
    _check(golden_err['image']['fused'] <= RENDER_TOL,
           f"golden image: kernel render {golden_err['image']['fused']:.3e}")
    _check(golden_err['image']['float32'] <= F32_GOLDEN_TOL,
           f"golden image: float32 render {golden_err['image']['float32']:.3e}")

    # 4. flyby -----------------------------------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        paths = render_video_frames(BUNDLE, tmp, n_frames=3, resolution=256,
                                    device='cuda')
        flyby_s = time.perf_counter() - t0
        _check(len(paths) == 3 and all(os.path.getsize(p) > 0 for p in paths),
               'flyby frames missing')
    print(f'[flyby] 3 frames at 256x256: {flyby_s:.2f} s', flush=True)

    train = _train_phase(device)
    _serve_phase(train.pop('renderer'), train.pop('state'))
    tune = _tune_phase(device, gview, g_fused)

    # 8-9. fields of any width up to 512; the Trainer through the CLI ------
    torch.cuda.empty_cache()
    widths = _widths_phase(device)
    torch.cuda.empty_cache()
    trainer = _trainer_phase(device, train)
    torch.cuda.empty_cache()
    dt = _dt_phase(device)
    torch.cuda.empty_cache()
    thomson = _thomson_phase(device)

    # 8-11. dense feature grids (K5) ----------------------------------------
    torch.cuda.empty_cache()
    with torch.no_grad():
        grid_rows = {name: _grid_kernel_phase(name, kw, n, device)
                     for name, kw, n in GRID_SHAPES}
    torch.cuda.empty_cache()
    grid_train = _grid_train_phase(device)
    grid_serve = _grid_serve_phase(grid_train, device)
    for k in ('renderer', 'state', 'configs'):
        grid_train.pop(k)
    torch.cuda.empty_cache()
    ngp = _ngp_phase(device)

    # 12-16. the other backward paths (K3, K4, K6a, K6b) ------------------
    torch.cuda.empty_cache()
    with torch.no_grad():
        dpts_rows = {'fine': _dpts_phase('fine', 8, 512, 1024 * 192, device),
                     'proposal': _dpts_phase('proposal', 4, 128, 1024 * 20, device),
                     'fine_d12': _dpts_phase('fine', 8, 512, 1024 * 192, device, d_input=12)}
    torch.cuda.empty_cache()
    recompute = _recompute_phase(262144, device)
    torch.cuda.empty_cache()
    with torch.no_grad():
        formats = {fmt: _format_phase(fmt, 262144, device) for fmt in ('lsb', 'i8pair')}
    torch.cuda.empty_cache()
    bench = _bench_kernel_phase()
    torch.cuda.empty_cache()
    probe = _probe_step_phase(device)
    probe_launches = {str(r['knob']): r['launches'] for r in probe['rows']}

    # 17. the grid-encode probes (P1, P2) ------------------------------------
    torch.cuda.empty_cache()
    probes = _grid_probe_phase(device)

    fine = kernel_rows['fine']
    kernels = []
    # K0 with the widths it serves on the render path and its launches in
    # the 256^2 render
    kernels.append({
        'name': 'fused_mlp_fwd_wgmma (K0)', 'route': 'cuda',
        'source': 'sunerf_tpu_torch/csrc/fused_mlp_fwd_wgmma.cu',
        'replaces': 'sunerf_tpu/ops/pallas/fused_mlp.py:343', 'launches': launches,
        'serves_widths': sorted({r['width'] for r in kernel_rows.values()}),
        'max_abs_err': max(r['max_abs_err'] for r in kernel_rows.values()),
        'max_rel_err': max(r['max_rel_err'] for r in kernel_rows.values()),
        'ms': fine['ms'], 'plain_ms': fine['plain_ms'], 'bound_ms': fine['bound_ms'],
        'bound_by': 'operations', 'library_ms': None, 'k0_detail': kernel_rows,
        'render_256_ms': render_ms, 'render_256_float32_ms': f32_render_ms,
        'render_256_err': render_err, 'render_256_profile': breakdown,
        'golden_err': golden_err,
        'grid_shapes': {name: r['k0'] for name, r in grid_rows.items()},
        'grid_render_256': grid_serve,
        'widths': {name: dict(r['k0'], runs_at=r['runs_at'], pad_ms=r['pad_ms'])
                   for name, r in widths['rows'].items()},
        'trainer_served': trainer['served'],
        'dt_launches': dt['launches'].get('LAUNCHES', 0), 'dt_served': dt['served'],
        'dt_shapes': dt['k0_rows'],
        'dt_raw_err': dt['k0_raw_err'], 'dt_image_err': dt['image_err'],
        'dt_image_tol': dt['image_tol'],
        'thomson_raw_err': {k: r['k0_raw_err'] for k, r in thomson['rows'].items()},
    })
    for key, kname, line, header in (
            ('k1', 'fused_mlp_stash_fwd', 453, 'fused_mlp_fwd_wgmma.cuh'),
            ('k2', 'fused_mlp_stash_bwd', 533, 'fused_mlp_backward.cuh')):
        rows = {name: r[key] for name, r in stash_rows.items()}
        kernels.append({
            'name': f'{kname} ({key.upper()})', 'route': 'cuda',
            'source': f'sunerf_tpu_torch/csrc/{kname}.cu',
            'sources': [f'sunerf_tpu_torch/csrc/{kname}.cu', f'sunerf_tpu_torch/csrc/{header}',
                        'sunerf_tpu_torch/csrc/hopper.cuh'],
            'replaces': f'sunerf_tpu/ops/pallas/fused_mlp.py:{line}',
            'launches': train['launches'][key],
            'max_abs_err': max(r['max_abs_err'] for r in rows.values()),
            'max_rel_err': max(r['max_rel_err'] for r in rows.values()),
            'ms': rows['fine']['ms'], 'plain_ms': rows['fine']['plain_ms'],
            'bound_ms': rows['fine']['bound_ms'], 'bound_by': rows['fine']['bound_by'],
            'library_ms': None, 'shapes': rows,
            'train_step_ms': train['step_ms'], 'train_rays_per_s': train['rays_per_s'],
            'train_step_float32_ms': train['f32_step_ms'],
            'train_profile': train['profile'], 'train_peak_gib': train['peak_gib'],
            'train_vs_plain': train['vs_plain'], 'tune_losses': tune,
            'grid_shapes': {name: r[key] for name, r in grid_rows.items()},
            # K1 + K2 together under autograd at the padded widths
            'widths_k1_k2': {name: dict(r['k1_k2'], runs_at=r['runs_at'])
                             for name, r in widths['rows'].items()},
            'trainer': trainer,
            'dt_shapes': {name: r[key] for name, r in dt['stash_rows'].items()},
            'dt_launches': dt['launches'][{'k1': 'STASH_FWD_LAUNCHES',
                                            'k2': 'STASH_BWD_LAUNCHES'}[key]],
            'thomson_launches': {k: r['launches'] for k, r in thomson['rows'].items()},
            'dt': dt if key == 'k1' else {'vs_plain': dt['vs_plain'], 'dy_max': dt['dy_max']},
            'thomson': thomson if key == 'k1' else None,
        })
    gq = grid_rows['grid_quarter']
    kernels.append({
        'name': 'fused_mlp_grid (K5, the grid branch of K0/K1/K2)', 'route': 'cuda',
        'source': 'sunerf_tpu_torch/csrc/fused_mlp_common.cuh',
        'sources': ['sunerf_tpu_torch/csrc/fused_mlp_common.cuh',
                    'sunerf_tpu_torch/csrc/fused_mlp_fwd_wgmma.cuh',
                    'sunerf_tpu_torch/csrc/fused_mlp_backward.cuh',
                    'sunerf_tpu_torch/csrc/fused_mlp_stash_bwd.cu'],
        'replaces': 'sunerf_tpu/ops/pallas/fused_mlp.py:313',
        'launches': grid_train['launches']['k5'],
        'max_abs_err': max(e['max_abs_err'] for r in grid_rows.values()
                           for e in r['k5']['table_grads'].values()),
        'max_rel_err': max(e['max_rel_err'] for r in grid_rows.values()
                           for e in r['k5']['table_grads'].values()),
        # K1 + K2 with the grid branch at grid_quarter's fine field, the
        # training path's grid launches
        'ms': gq['k1']['ms'] + gq['k2']['ms'],
        'plain_ms': gq['k1']['plain_ms'] + gq['k2']['plain_ms'],
        'bound_ms': gq['k1']['bound_ms'] + gq['k2']['bound_ms'],
        'bound_by': gq['k2']['bound_by'],
        'library_ms': gq['k5']['grid_sample_fwd_bwd_ms'],
        'library': 'torch.nn.functional.grid_sample, 5-D, a call a level, forward + backward '
                   'to d_table (forward alone: shapes[*].grid_sample_fwd_ms)',
        'grid_share_ms': {name: r['k5']['grid_share_ms'] for name, r in grid_rows.items()},
        'shapes': {name: r['k5'] for name, r in grid_rows.items()},
        'train_step_ms': grid_train['step_ms'], 'train_rays_per_s': grid_train['rays_per_s'],
        'train_step_float32_ms': grid_train['f32_step_ms'], 'train': grid_train,
        'ngp': ngp, 'serve': grid_serve,
    })
    fine_dpts = dpts_rows['fine']
    kernels.append({
        'name': 'fused_mlp_dpts (K3, the point cotangent of K2)', 'route': 'cuda',
        'source': 'sunerf_tpu_torch/csrc/fused_mlp_backward.cuh',
        'replaces': 'sunerf_tpu/ops/pallas/fused_mlp.py:646',
        'launches': bench['launches']['DPTS_LAUNCHES'],
        'max_abs_err': max(r['max_abs_err'] for r in dpts_rows.values()),
        'max_rel_err': max(r['max_rel_err'] for r in dpts_rows.values()),
        'ms': fine_dpts['ms'], 'plain_ms': fine_dpts['plain_ms'],
        'bound_ms': fine_dpts['bound_ms'], 'bound_by': fine_dpts['bound_by'],
        'library_ms': None, 'shapes': dpts_rows, 'width_2x32': widths['paths']['K3'],
    })
    kernels.append({
        'name': 'fused_mlp_recompute_bwd (K4)', 'route': 'cuda',
        'source': 'sunerf_tpu_torch/csrc/fused_mlp_recompute_bwd.cu',
        'replaces': 'sunerf_tpu/ops/pallas/fused_mlp.py:834',
        'launches': probe_launches[str({'stash': False})]['RECOMPUTE_BWD_LAUNCHES'],
        'bench_kernel_launches': bench['launches']['RECOMPUTE_BWD_LAUNCHES'],
        'max_abs_err': recompute['max_abs_err'], 'max_rel_err': recompute['max_rel_err'],
        'ms': recompute['ms'], 'plain_ms': recompute['plain_ms'],
        'bound_ms': recompute['bound_ms'], 'bound_by': recompute['bound_by'],
        'library_ms': None, 'detail': recompute, 'width_2x32': widths['paths']['K4'],
    })
    backward_design = {
        'lsb': 'the packed-sin gate through the chain kernel\'s weight ring (TMA boxes, two '
               'stages), decoded in place by a 1 KB shared-memory table under the layer\'s '
               'last products',
        'i8pair': 'dW_h on int8 wgmma (dw_i8_wgmma_kernel: operands transposed and dz '
                  'quantized in shared memory), group maxima from the chain\'s row maxima '
                  '(dz_group_max_kernel)'}
    for fmt, kname, line, counter in (('lsb', 'K6a', 481, 'LSB_LAUNCHES'),
                                      ('i8pair', 'K6b', 503, 'I8PAIR_LAUNCHES')):
        r = formats[fmt]
        kernels.append({
            'name': f"fused_mlp_stash_fwd/bwd '{fmt}' ({kname})", 'route': 'cuda',
            'source': 'sunerf_tpu_torch/csrc/fused_mlp_stash_fwd.cu',
            'sources': ['sunerf_tpu_torch/csrc/fused_mlp_stash_fwd.cu',
                        'sunerf_tpu_torch/csrc/fused_mlp_stash_bwd.cu',
                        'sunerf_tpu_torch/csrc/fused_mlp_backward.cuh',
                        'sunerf_tpu_torch/csrc/hopper.cuh'],
            'backward_design': backward_design[fmt],
            'replaces': f'sunerf_tpu/ops/pallas/fused_mlp.py:{line}',
            'launches': probe_launches[str({'stash_format': fmt})][counter],
            'bench_kernel_launches': bench['launches'][counter],
            'max_abs_err': r['max_abs_err'], 'max_rel_err': r['max_rel_err'],
            'ms': r['ms'], 'plain_ms': r['plain_ms'], 'bound_ms': r['bound_ms'],
            'bound_by': r['bound_by'], 'library_ms': None, 'detail': r,
            'width_2x32': widths['paths'][kname],
        })
    kernels[-1]['bench_kernel'] = bench['rows']
    kernels[-1]['probe_step'] = [{k: v for k, v in row.items() if k != 'losses'}
                                 for row in probe['rows']]
    tap = probes['tap_rows']['G=32 N=262144']
    kernels.append({
        'name': 'grid_tap_encode (P1)', 'route': 'cuda',
        'source': 'sunerf_tpu_torch/csrc/grid_tap_encode.cu',
        'replaces': 'scripts/probe_grid_taps.py:31',
        'launches': probes['launches']['TAP_LAUNCHES'],
        'max_abs_err': max(r['max_abs_err'] for r in probes['tap_rows'].values()),
        'ms': tap['ms'], 'plain_ms': tap['plain_ms'], 'bound_ms': tap['bound_ms'],
        'bound_by': tap['bound_by'], 'library_ms': tap['library_ms'],
        'l2_floor_ms': tap['l2_floor_ms'], 'l2_rate_tbps': tap['l2_rate_tbps'],
        'library': 'torch.nn.functional.grid_sample, 5-D, float32',
        'shapes': probes['tap_rows'], 'script': probes['taps'],
        'check': probes['checks']['taps'],
    })
    hat = probes['hat_rows']['iota']
    kernels.append({
        'name': 'grid_hat_encode (P2)', 'route': 'cuda',
        'source': 'sunerf_tpu_torch/csrc/grid_hat_encode.cu',
        'replaces': 'scripts/probe_grid_hatbuild.py:35',
        'launches': probes['launches']['HAT_LAUNCHES'],
        'max_abs_err': max(r['max_abs_err'] for r in probes['hat_rows'].values()),
        'max_rel_err': max(r['max_rel_err'] for r in probes['hat_rows'].values()),
        'ms': hat['ms'], 'plain_ms': hat['plain_ms'], 'bound_ms': hat['bound_ms'],
        'bound_by': hat['bound_by'], 'library_ms': hat['library_ms'],
        'library': 'torch.nn.functional.grid_sample, 4-D, float32',
        'dense_tc_ms': hat['dense_tc_ms'], 'variants': probes['hat_rows'],
        'script': probes['hatbuild'], 'check': probes['checks']['hatbuild'],
    })
    for k in kernels:
        _check(k['launches'] > 0, f"{k['name']}: no launches on its path")
    print(smi)
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
