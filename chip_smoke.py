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
  4a. export the committed bundle through evaluation.serving at its own spec:
             a. export_serving(platforms=('cpu', 'cuda'), batch 4,096) into a
             temporary directory: seconds and size; the CUDA render program's
             graph calls the registered K0 op sunerf_tpu_torch::fused_mlp_fwd
             twice (coarse, fine), its points program once, the CPU programs
             never, and no other call of the port; b. the 256^2 view of [render]
             through ServingModel(device='cuda') against the live frame, every
             map at rtol 1e-4 / atol 1e-6 (JAX's), the bits compared; c. K0's
             launches in the served frame by kernel name, as K0's library
             counts them (32; fused_mlp.kernel_launches), K0 at the frame's fine samples against its plain version
             (KERNEL_TOL), served and live frames timed in turns and profiled;
             d. the points entry on a 64^3 cube against live load_coords; e. a
             tiered artifact (tier=TIER) against the live tiered loader, the
             bright tier the same bits, 48 K0 launches; f.
             scripts/probe_serving.py at 512^2, batch 8,192: artifact against
             live, host clock, CUDA events and profiled device time; g. the
             artifact's CPU program in a subprocess (a deadline) that imports
             torch, zipfile and json only: a finite 16^2 frame, no sunerf_tpu
             module loaded.
  4b. mhd    a. the committed PSI fixture (sunerf_tpu_torch/assets/psi_fixture,
             written by the JAX package's h5py writer) read by the port's numpy
             reader: the arrays of its h5py read (psi_fixture.npz); rendered
             through evaluation.image_render's MHDModel path at
             config/render_mhd.yaml's four observers at 256^2 in its six
             channels: finite FITS frames, each disk above its corners; b. a
             field at the size of PSI's MAS cubes, made on the card (two frames
             of rho and T at (n_phi, n_theta, n_r) = (360, 180, 256), 265 MB):
             one 256^2 frame at the renderer's defaults (64 + 128 samples),
             ms a frame, profiled, peak memory; 1,024 rays against the same
             render in float64 on the card at 215 Rs (reported) and at 5 Rs
             (MHD_F64_TOL); c. the fixture's MHD spec exported for cuda (no
             op), a 64^2 view served against live at rtol 1e-4 / atol 1e-6.
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
  7w. wide   the wide route (ops/wide_mlp.py, csrc/wide_mlp_fwd.cu and
             wide_mlp_bwd.cu: one launch a layer) at fields the fused
             kernels cannot hold, random weights from a seed: a. the wide K0
             at 8x1024 / d_output 2, 2x640 / 9 and 8x512 / 16, N = 245,760,
             at KERNEL_TOL, KERNEL_RMS_TOL and KERNEL_MAX_TOL; b. K1 + K2
             ('int8') at the same shapes, N = 196,608 (and 65,536 at
             8x1024): K1's out K0's bits, its RMS within KERNEL_RMS_TOL
             or K1_RMS_FLOOR_FACTOR times the plain version's own f32 floor
             on that field (CPU vs card) where that is higher, its stash
             layer by layer as [stash] holds it, every gradient within
             GRAD_TOL, the same bits
             twice; K3, K4, K6a, K6b (scale groups of 768) and K5 (two grid
             levels) at 2x640 under autograd (gradients within GRAD_TOL,
             dpts within DPTS_TOL, the same bits twice, their kernels by
             name); K6b's backward at scale groups 8 and 40 (no multiple of
             32) and 768 against the plain version (GRAD_TOL, dpts
             DPTS_TOL, the same bits twice), and K6b at 8x1024 / d_output 2,
             N = 196,608, group 768 under autograd (the same checks; its
             int8 dW_h, wide_dw_i8_wgmma_kernel, and the groups' maxima,
             wide_dz_group_max_kernel, once a hidden layer by name; dW_h's
             bf16 torch.bmm and torch._int_mm yardsticks); every product of K0 / K1 / K2
             on wide_wgmma_kernel by name; c. an 8x1024 reference
             save_state.snf converted, its
             256^2 frame on the wide K0 (32 launches by kernel name) against
             the plain version (RENDER_TOL), exported and served from the
             artifact with the live frame's bits, fine-tuned
             WIDE_TUNE_STEPS steps through the Trainer (2 + 2 wide K1 / K2
             launches a step by name, the loss finite and falling). Times:
             scripts/probe_wide.py's rows (kernel, plain version, one bf16
             torch.matmul a layer product, the bound).
  7b. trainer  the committed bundle rendered at TRAINER_RES^2 from
             config/render_simple_star.yaml's 8 observers, written as FITS;
             `sunerf_tpu_torch.run_emission.main` at 8x512, 64 + 128, batch
             1024, TRAINER_STEPS steps (validation every 150 with keep_best, EMA
             0.999, a 4-view 64^2 drift probe; 20 steps profiled): 2 K1 and
             2 K2 launches a step, K0 launches for validation, finite and
             falling losses, val_psnr at the last step above step 0's, save_state,
             save_state_ema and save_state_best each served at 64^2 through
             K0; a second main resumes there and logs 50 steps on; a 2x32 run
             (8 + 8 samples, 40 steps) on the padded kernels, loss falling.
             Prints the Trainer's ms/step over steps 51 on beside [train]'s
             bare step, the profiled window's device idle share and the
             Rice decoder that loaded.
  7c. dt     the analytic SimpleStar rendered by the port's
             evaluation.image_render.render_observers at
             config/render_simple_star.yaml's 8 observers and pif (1e9), at
             DT_RES^2, over all seven AIA channels, as an aia / euvia / euvib
             FITS tree, with euvib's 94 and 131 directories removed (its rays
             carry 0 for them); `sunerf_tpu_torch.run_density_temperature.main`
             with config/DT_2012_11.yaml (8x512 DT field for both passes,
             64 + 128, batch 3072, pif 1e17) on that tree, cut to DT_STEPS
             (validation at its half and its end with keep_best, EMA 0.999, the 4-view 64^2
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
  7e. eval  the committed bundle through the evaluation layer on K0: 8
             ground-truth FITS views at 256^2 (4 with |lat| <= 7 deg, 4 beyond)
             rendered by its float32 field; evaluation.metrics_harness's
             evaluate_viewpoints on the kernel path: both splits populated,
             every metric finite, each view's metrics within HARNESS_TOL of
             the same metrics computed directly from the same render; the
             reprojection baseline from the 4 band views, scored alike
             (reported). The five products (volume 64^3, synchronic 90x180,
             topographic 256^2, eruption at 3 times at 64^2, uncertainty
             128^2) against the same products through the kernels' plain
             versions: the volume's raw under KERNEL_TOL, the images within
             RENDER_TOL of max (the uncertainty of the fine image's max); the
             float32 field's distance and each product's seconds reported.
             The 256^2 view with tier=TIER: 48 K0 launches against 32
             untiered, the bright tier (per 4,096-ray chunk, the half the
             coarse pass ranks brightest) within TIER_BRIGHT_TOL relative of
             the untiered render, the frame's relative L1 below TIER_L1_TOL,
             ms a frame beside the untiered render and each frame's device
             time under torch.profiler; K0 at the tiered chunk's fine shapes
             (2,048 x 60 and 2,048 x 16 points). The eruption frames off the
             bundle's one training instant are held by K0's point check at
             their own fine samples (the t = 0 frame also by RENDER_TOL), their
             image gap reported: there the trained field is hypersensitive to
             bf16 flips.
  7f. tiers  bench.py's workload and DT_2012_11's widths (3,072 rays, 7
             channels) with tier TIER: one step on the kernels against the
             plain versions (STEP_LOSS_TOL, GRAD_TOL), 3 K1 + 3 K2 a step
             (2 + 2 untiered), step times tiered and untiered in turns; K1
             and K2 at the tiered fine shapes (as 2, stash); run_emission at
             8x512 on [trainer]'s synthesized views, TIERS_TRAINER_STEPS
             steps, the first half at the full budget (tier_warmup_steps):
             2 + 2 launches a step before the switch and 3 + 3 after, a
             falling loss.
  7g. occupancy  run_emission at 8x512 with rendering.occupancy at its
             defaults but warmup 50 and update_every 16, to the grid's first
             update (step 64; its occupied fractions reported), then resumed
             from its checkpoint to step 112 with a falling loss, 2 K1 + 2 K2
             a step and the fractions in the log; the update's cell activity
             on K0 against the plain version on the same jitter under
             KERNEL_TOL, with the cells whose occupancy differs counted, on
             the run's field and on the committed bundle's trained field,
             whose one update from the warm grid must leave it (an untrained
             field lights every cell); the bundle's 256^2 view sampled by that
             grid (32 K0 launches, finite); the run's bundle, grid included,
             served as a topographic map; ms a step beside [trainer]'s, and
             the update's ms.
  7h. dp     data parallel and microbatch at bench.py's workload (8x512 for
             both fields, 64 + 128 samples, random weights from a seed):
             a. a one-rank mesh over NCCL in this process (a FileStore):
             one step on 1,024 rays against the single-device step (2 K1 +
             2 K2; the same bits, or the gap), both timed in turns (CUDA
             events, median of 10 after 3 warm-ups), the all-reduce of the
             step's 15 MB of gradients timed alone and with its flatten and
             copy back; b. two spawned ranks on this card over gloo, 1,024
             rays each: one step against the single-process step on the
             2,048 rays (loss within STEP_LOSS_TOL, clipped gradients within
             GRAD_TOL of max), 4 K1 + 4 K2 in all, the step's ms and the
             gloo all-reduce's (host clock: gloo stages through the host);
             c. 4,096 rays with microbatch 1,024 against the unchunked step
             (STEP_LOSS_TOL, GRAD_TOL), 8 K1 + 8 K2, ms/step and the peak
             device memory of both; d. run_emission at 8x512 under
             torchrun's environment (a one-rank NCCL mesh), 50 steps with
             microbatch 512 on [trainer]'s synthesized views: 4 K1 + 4 K2 a
             step, a falling loss, one checkpoint, the bundle served on K0,
             ms/step beside [trainer]'s; e. the committed bundle's 256^2
             frame through SuNeRFLoader(mesh=...) on the one-rank NCCL mesh
             and on each gloo rank, against the single-device frame (the
             same bits, or within FRAME_TOL of max).
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
 18. serve_cards  the committed bundle exported for cuda once and loaded by
             ServingModel onto cuda:0 (its program's devices mapped by
             move_to_device_pass) and, with more than one card, onto the
             last card: each frame the live 256^2 frame's bits, 32 K0
             launches on that card by kernel name, ms; the sharded artifact
             over 2 and 4 NCCL ranks runs in scripts/serve_cards.py.
 19. snf     a reference-style save_state.snf (torch modules pickled under
             sunerf.* names, unpickled by the converter's stubs) holding the
             bundle's 8x512 fine and 4x128 coarse fields, converted by
             utils/snf_converter's CLI: the bundle's parameters bit for bit;
             the converted bundle's 256^2 frame at the converter's render
             spec (64 + 128) on K0 (32 launches) against the same frame
             through the plain version (RENDER_TOL), K0 at its 12.6M fine
             samples against the plain version (p99.99 KERNEL_TOL, RMS
             KERNEL_RMS_TOL, at most SNF_POINTS_OVER_TOL points beyond
             KERNEL_TOL and SNF_POINTS_OVER_MAX beyond KERNEL_MAX_TOL), ms.
 20. prep    8 SDO-style (193 A) and 8 STEREO-style (195 A) raw 512^2 FITS
             from a seed (disks with WCS, WAVELNTH, T_OBS, QUALITY) prepped
             to 256^2 by data/prep.prep_file (the default degradation
             table, scipy's zoom), aligned by data/align, loaded through
             load_map_stack (and the raw frames resampled by it);
             run_emission at 8x512 for 30 steps on the prepped views: 2 K1
             + 2 K2 a step, finite losses, seconds and ms/step.
 21. psi     scripts/psi_protocol.ensure_scene at 256^2 (the cubes written
             by the numpy HDF5 writer, h5py or not): 14 train and 18
             ground-truth views; scripts/score_bundle on the committed
             bundle (K0: 18 x 16 x 2 launches) and the same views through
             the plain version: each view's K0 render against the plain
             render at p99.99 KERNEL_TOL, max KERNEL_MAX_TOL, RMS
             PSI_RENDER_RMS_TOL, and asinh-scaled at RMS PSI_SCALED_RMS_TOL;
             the fine K0 output reversed on one chunk of a view fails that
             check; each split's PSNR, SSIM, MAE and ME gaps within the
             bounds that the scaled RMS limit implies (_score_bounds), JAX's
             recorded row printed beside (not checked); psi_protocol's
             training at 8x512, 64 + 128, PSI_PROTOCOL_STEPS at 128^2: 2 K1 + 2 K2 a
             step, a falling loss, its effective rays/s.
 22. dt_protocol  scripts/dt_protocol at 8x512, 64 + 128, batch 1024, the five
             channels (94 131 171 193 211), --hot-blob --mask-exercise
             --keep-best at 128^2, cut to DT_PROTOCOL_STEPS (100) of the matrix row's 8,000
             steps: 2 K1 + 2 K2 a step by kernel name, finite training
             losses and a falling held-out loss (the last validation's below
             the untrained field's at step 0); one step of the protocol's
             own system (dt_protocol.build_system: n_freqs_time=2, d_encoded
             68) on its first training batch against the plain versions
             (STEP_LOSS_TOL, GRAD_TOL), from the seed-0 init (both fields'
             gradients non-zero) and from the scored bundle, 2 K1 + 2 K2
             each; its 90 view-channel frames
             scored again on K0 (launches counted: 90 x 4 chunks x 2); each
             of the 18 views rendered in
             five channels on K0 and through the plain version, each of the
             90 frames held at p99.99 KERNEL_TOL, max KERNEL_MAX_TOL, RMS
             DT_RENDER_RMS_TOL and asinh-scaled RMS DT_SCALED_RMS_TOL; those
             frames' scores within DT_SCORE_TOL of the harness's; the fine
             K0 output reversed on one chunk of a view fails the check in
             every channel; ms/step, effective rays/s, the scores.
 23. thomson_protocol  scripts/thomson_protocol at its defaults: tB and pB at
             64^2, 215 Rs, 64 + 128 against the float64 oracle, each MAE
             within 2x and each PSNR within 20 log10(2) dB of the JAX
             package's recorded THOMSON_r5.json (accuracy, not times), and
             within THOMSON_CPU_FACTOR of its CPU reading (THOMSON_JAX_CPU); the
             8x512 Thomson step at batch 1024 (CUDA events), 2 K1 + 2 K2 by
             kernel name.
 24. probes  probe_kernel, probe_grid_kernel (K5 in K0-K2 at the grid
             shapes), probe_overhead, probe_grid_step and probe_grid_encoding
             once each at their default shapes and fewer repetitions: their
             JSON printed, each call's launches by kernel name held; one
             step of each grid field with K5's own kernels (prep_grid,
             grid_scatter, grid_convert) launched once each by name, as the
             backward's library counts them (fused_mlp.kernel_launches).
 25. ablations  dt_ablation, occupancy_ablation (the A/B) and
             occupancy_value_case at their configs' widths, 3 steps, one
             seed, 64^2; eval_budget_sweep re-scoring the committed bundle at
             64 + 128 on the psi_193 scene at 64^2 (36 K0 launches): finite
             rows, K0, K1, K2 (and K5 in dt_ablation's grid variant) by name.
 26. scripts18  spike_guard_demo, temporal_closed_loop and
             recover_temporal_score (on the loop's workdir: the loop's
             numbers), reprojection_baseline_psi (the psi_193 scene at
             32^2), real_data_rehearsal and the two capacity probes, 3 steps
             each at 32^2: finite rows, K0 / K1 / K2 by name where they
             train or render.
Phases 22-26 each run under PHASE_DEADLINE_S; past it the run fails. [time] lines give each phase's seconds.
Then it prints the card's name and power limit, one {"kernels": [...]} line
(K0 with the widths it serves on the render path and the serving artifact's
launches and times, K1, K2, K3,
K4, K5, K6a, K6b, P1 and P2; K0's entry with [eval]'s and the occupancy
update's launches, K1's and K2's with the tiered steps' and the tier
shapes', and each with its launches in phases 22-25; the wide route's K0,
K1, K2, K3, K4, K6a, K6b and K5) and, last,
{"ok": true, "device": {...}}.
"""
import contextlib
import dataclasses
import hashlib
import json
import os
import re
import shutil
import signal
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
           'fused_mlp_recompute_bwd', 'grid_tap_encode', 'grid_hat_encode', 'wide_mlp_fwd',
           'wide_mlp_bwd')
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
TRAINER_RES = 128
TRAINER_STEPS = 150
TRAINER_BATCH = 1024
TRAINER_MODEL = {}        # the CLI's defaults: 8x512 for both fields
TRAINER_RENDERING = {}    # 64 + 128 samples
# [dt]: config/render_simple_star.yaml's observers (data/synthetic.py
# OBSERVERS) rendered at DT_RES^2 over every AIA channel; euvib loses
# DT_DROPPED; config/DT_2012_11.yaml cut to DT_STEPS
DT_RES = 128
DT_STEPS = 150
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
# [eval]: the harness's ground truth, (lat, lon) in degrees at 1 AU, four
# inside the |lat| <= 7 deg training band and four beyond, at EVAL_RES^2;
# its per-view metrics against the same metrics computed directly, relative
EVAL_RES = 256
EVAL_VIEWS = ((0.0, 0.0), (4.0, 90.0), (-5.0, 180.0), (7.0, 270.0),
              (15.0, 45.0), (-20.0, 135.0), (35.0, 225.0), (-50.0, 315.0))
HARNESS_TOL = 1e-6
# [eval]: the eruption profile's times (normalized; the bundle was trained
# at t = 0 alone)
ERUPTION_TIMES = (0.0, 0.5, 1.0)
# [eval] / [tiers]: the adaptive per-ray tiers (fraction, samples); the
# tiered render's bright pixels against the untiered render, relative, and
# the frame's relative L1 (JAX's tests/test_renderer.py:237-260)
TIER = (0.5, 16)
TIER_BRIGHT_TOL = 1e-5
TIER_L1_TOL = 0.05
DT_TIER_RAYS = 3072
TIERS_TRAINER_STEPS = 60
# [occupancy]: run_emission to the first grid update (warmup 50, every 16:
# step 64), then resumed to the second number
OCC_STEPS = (64, 112)
# [dp]: a rank's rays in the mesh steps; the microbatched step's rays and
# microbatch; run_emission's steps and microbatch under torchrun's
# environment; the spawned ranks' deadline from their go signal; the tiled
# frames against the single-device frame, of max
DP_RAYS = 1024
DP_MICRO = (4096, 1024)
DP_TRAINER_STEPS = 30
DP_TRAINER_MICRO = 512
DP_DEADLINE_S = 180.0
FRAME_TOL = 1e-6
# [export]: the serving artifact of the committed bundle, served against live
EXPORT_BATCH = 4096
SERVE_RTOL, SERVE_ATOL = 1e-4, 1e-6   # JAX's own (tests/test_serving.py:57-63)
K0_OP = 'sunerf_tpu_torch.fused_mlp_fwd.default'
K0_KERNEL = 'fwd_wgmma_kernel'
PROBE_SERVING = ('--resolution', '512', '--batch-size', '8192')
CPU_PROGRAM_RES = 16
SUBPROCESS_DEADLINE_S = 300.0
# [mhd]: the committed PSI fixture, and a field at the size of PSI's MAS cubes
PSI_FIXTURE = 'sunerf_tpu_torch/assets/psi_fixture'
MHD_CONFIG = 'config/render_mhd.yaml'
MHD_RES = 256
PSI_SHAPE = (360, 180, 256)          # (n_phi, n_theta, n_r), two frames of rho and T
MHD_F64_RAYS = 1024
MHD_F64_TOL = 1e-3             # float32 vs float64 at 5 Rs, of max




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
                points_over_tol=int((d > KERNEL_TOL * m).sum()),
                points_over_max=int((d > KERNEL_MAX_TOL * m).sum()))


def _fmt(e: dict) -> str:
    return (f"max {e['max_rel_err']:.2e} p99.99 {e['p9999_rel_err']:.2e} rms "
            f"{e['rms_rel_err']:.2e} points>{KERNEL_TOL:g} {e['points_over_tol']} "
            f"points>{KERNEL_MAX_TOL:g} {e['points_over_max']}")


_T_START = time.perf_counter()
_T_LAST = [_T_START]


def _mark(tag: str):
    """Print the seconds since the last mark and since the start."""
    now = time.perf_counter()
    print(f'[time] {tag}: {now - _T_LAST[0]:.1f} s (at {now - _T_START:.1f} s)', flush=True)
    _T_LAST[0] = now


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


def _step_vs_plain(renderer, plain, params: dict, batch: dict, loss_config,
                   train_pass: bool = False) -> dict:
    """One step's loss and gradients through `renderer` (the kernels)
    against `plain`, from the same params and batch, perturb off. With
    train_pass a generator (from which nothing is drawn) selects the
    training pass: the tiered fine pass of a tiered renderer."""
    from sunerf_tpu_torch.train.objective import render_loss

    def run(r):
        p = {f: {k: v.detach().clone().requires_grad_() for k, v in sub.items()}
             for f, sub in params.items()}
        rays = batch['rays']
        gen = torch.Generator(device=rays.device).manual_seed(0) if train_pass else None
        out = r(p, rays[:, 0], rays[:, 1], batch['time'], wavelengths=batch.get('wavelength'),
                generator=gen)
        loss, _ = render_loss(loss_config, out, batch['target_image'])
        loss.backward()
        return float(loss.detach()), {f: {k: v.grad for k, v in sub.items()}
                                      for f, sub in p.items()}
    fixed = dataclasses.replace(renderer, perturb=False)
    loss_k, grads_k = run(fixed)
    loss_p, grads_p = run(dataclasses.replace(fixed, **plain))
    return {'loss': loss_k, 'plain_loss': loss_p,
            'loss_rel_err': abs(loss_k - loss_p) / abs(loss_p),
            'grads': {f: _grad_err(grads_p[f], grads_k[f]) for f in grads_p},
            'plain_grad_max': {f: max(float(g.abs().max()) for g in grads_p[f].values())
                               for f in grads_p}}


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
        config['training'].update(total_steps=DT_STEPS, log_every_n_steps=DT_STEPS // 2,
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
        _check(sorted(vals) == [0, DT_STEPS // 2, DT_STEPS], f'dt validations at {sorted(vals)}')
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


# ------------------------------------------------ the evaluation layer, tiers, occupancy

def _k0_row(cfg, p: dict, n: int, device, seed: int) -> dict:
    """K0 against its plain version at N points of the field p (K0's
    tolerances), its time, the plain version's and the ops bound."""
    from sunerf_tpu_torch.ops import fused_mlp
    gen = torch.Generator(device=device).manual_seed(seed)
    pts = torch.rand(n, 4, generator=gen, device=device) * 2.6 - 1.3
    pts[:, 3] = 0.0
    with torch.inference_mode():
        err = _err_stats(fused_mlp.fused_mlp_reference(cfg, p, pts),
                         fused_mlp.fused_mlp_forward(cfg, p, pts))
        ms = _cuda_ms(lambda: fused_mlp.fused_mlp_forward(cfg, p, pts))
        plain_ms = _cuda_ms(lambda: fused_mlp.fused_mlp_reference(cfg, p, pts))
    bound_ms, bound_by = _bound(_flops(cfg, n), n * 4 * (cfg.d_input + cfg.d_output)
                                + _param_bytes(cfg))
    _check(err['p9999_rel_err'] <= KERNEL_TOL and err['rms_rel_err'] <= KERNEL_RMS_TOL
           and err['max_rel_err'] <= KERNEL_MAX_TOL, f'K0 N={n} vs plain {_fmt(err)}')
    return dict(n=n, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, **err)


def _wall_and_device_ms(fn) -> dict:
    """One call of fn under torch.profiler: its host-clock ms, the device
    kernels' ms and the share of the wall time the device sat idle."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    device_ms = sum(e.device_time for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA
                    and not getattr(e, 'is_user_annotation', False) and '#' not in e.name) / 1e3
    return dict(wall_ms=wall_ms, device_ms=device_ms, idle_share=1 - device_ms / wall_ms)


def _eval_phase(device, plain_renderer, fine_cfg) -> dict:
    """[eval]: the metrics harness, the five products and the tiered 256^2
    render of the committed bundle, on K0."""
    from sunerf_tpu_torch.baseline.reprojection import (create_heliographic_map,
                                                        heliographic_to_observer)
    from sunerf_tpu_torch.core.geometry import observer_rays
    from sunerf_tpu_torch.core.scaling import image_asinh_scaling
    from sunerf_tpu_torch.data.fits import Header, read_fits, write_fits
    from sunerf_tpu_torch.data.wcs import observer_header, parse_observer
    from sunerf_tpu_torch.evaluation import products
    from sunerf_tpu_torch.evaluation.loader import ModelLoader, SuNeRFLoader
    from sunerf_tpu_torch.evaluation.metrics_harness import (METRICS, evaluate_viewpoints,
                                                             view_metrics)
    from sunerf_tpu_torch.ops import fused_mlp
    from sunerf_tpu_torch.train.metrics import mae_percent, me_percent, psnr, ssim
    t0 = time.perf_counter()
    kernel = SuNeRFLoader(BUNDLE, device=device)
    f32 = SuNeRFLoader(BUNDLE, use_fused=False, device=device)
    plain = ModelLoader(plain_renderer, kernel.params, ref_time=kernel.ref_time, device=device)
    when, wl = kernel.ref_time, float(kernel.config['wavelength'])
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        # the harness: ground truth from the float32 field, scored on K0
        files = []
        for i, (lat, lon) in enumerate(EVAL_VIEWS):
            view = f32.render_observer_image(np.deg2rad(lat), np.deg2rad(lon), when, 215.0,
                                             EVAL_RES)
            header = Header()
            header.update(observer_header(lat, lon, 215.0, when, EVAL_RES, wl))
            files.append(os.path.join(tmp, f'view_{i}.fits'))
            write_fits(files[-1], view.image[:, :, 0], header)
        _zero_counters()
        t1 = time.perf_counter()
        result = evaluate_viewpoints(kernel, files)
        harness_s = time.perf_counter() - t1
        k0 = fused_mlp.LAUNCHES
        _check(result['n_train'] == 4 and result['n_test'] == 4,
               f"harness splits {result['n_train']} / {result['n_test']}")
        _check(all(np.isfinite(v) for s in ('train', 'test', 'all')
                   for v in result[s].values()), f'harness metrics not finite: {result}')
        # the same metrics computed directly from the same renders
        direct_err = 0.0
        for v, path in zip(result['views'], files):
            data, header = read_fits(path)
            obs = parse_observer(header)
            img = kernel.render_observer_image(obs.carrington_lat, obs.carrington_lon, obs.time,
                                               obs.dsun_rs, data.shape[0],
                                               wavelengths=[obs.wavelength]).image[:, :, 0]
            p = image_asinh_scaling(torch.from_numpy(img)).numpy()
            t = image_asinh_scaling(torch.from_numpy(data.astype(np.float32))).numpy()
            direct = dict(psnr=psnr(p, t), ssim=ssim(p, t, data_range=float(t.max() - t.min() or 1)),
                          mae_percent=mae_percent(p, t), me_percent=me_percent(p, t))
            direct_err = max([direct_err] + [abs(v[k] - direct[k]) / max(abs(direct[k]), 1e-30)
                                             for k in METRICS])
        _check(direct_err <= HARNESS_TOL, f'harness vs direct metrics {direct_err:.2e}')
        # the reprojection baseline from the |lat| <= 7 deg views, scored as
        # scripts/reprojection_baseline_psi.py scores it (off-disk 0)
        t1 = time.perf_counter()
        hmap = create_heliographic_map([read_fits(f) for f, v in zip(files, result['views'])
                                        if abs(v['lat_deg']) <= 7.0])
        base = {'train': [], 'test': []}
        for path, v in zip(files, result['views']):
            data, header = read_fits(path)
            obs = parse_observer(header)
            pred = heliographic_to_observer(hmap, obs.carrington_lat, obs.carrington_lon,
                                            obs.dsun_rs, data.shape[0])
            base['train' if abs(v['lat_deg']) <= 7.0 else 'test'].append(
                view_metrics(np.nan_to_num(pred, nan=0.0).astype(np.float32), data))
        baseline = {s: {k: float(np.mean([m[k] for m in rows])) for k in METRICS}
                    for s, rows in base.items()}
        baseline_s = time.perf_counter() - t1
        fmt = lambda m: ' '.join(f'{k} {m[k]:.4f}' for k in METRICS)  # noqa: E731
        print(f'[eval] harness, 8 views at {EVAL_RES}^2 on K0 ({k0} launches, {harness_s:.2f} s): '
              f"train (|lat| <= 7) {fmt(result['train'])}; test {fmt(result['test'])}; "
              f'per-view metrics vs direct {direct_err:.1e} (tol {HARNESS_TOL:g})', flush=True)
        print(f"[eval] reprojection baseline from the 4 train views ({baseline_s:.1f} s, host): "
              f"train {fmt(baseline['train'])}; test {fmt(baseline['test'])}", flush=True)
        out['harness'] = dict(train=result['train'], test=result['test'], k0_launches=k0,
                              seconds=harness_s, vs_direct=direct_err, baseline=baseline)

    # the five products on K0, against the same products through the plain
    # versions (the float32 field's distance reported)
    lat, lon = VIEW['lat'], VIEW['lon']
    specs = {
        'volume': lambda l: products.extract_volume(l, 0.0, resolution=64),
        'synchronic': lambda l: {'map': products.synchronic_map(l, 0.0, resolution_lat=90)},
        'topographic': lambda l: products.topographic_maps(l, lat, lon, 0.0, 215.0, 256),
        'eruption': lambda l: products.eruption_profile(l, ERUPTION_TIMES, lat, lon, 215.0, 64),
        'uncertainty': lambda l: {'uncertainty': products.uncertainty_map(l, lat, lon, 0.0,
                                                                          215.0, 128)},
    }
    image_key = {'synchronic': 'map', 'topographic': 'image', 'eruption': 'images',
                 'uncertainty': 'uncertainty'}
    o, d = observer_rays(lat, lon, 215.0, 128)
    fine_max = float(np.max(plain.render_rays(o, d, 0.0, keys=('fine_image',))['fine_image']))
    rows = {}
    for name, fn in specs.items():
        fn(kernel)
        torch.cuda.synchronize()
        _zero_counters()
        t1 = time.perf_counter()
        got = fn(kernel)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t1
        launches = fused_mlp.LAUNCHES
        ref, f32_out = fn(plain), fn(f32)
        _check(launches > 0, f'{name}: no K0 launch')
        for k, v in got.items():
            _check(bool(np.isfinite(np.asarray(v, np.float64)).all()), f'{name} {k} not finite')
        if name == 'volume':
            shape = got['raw'].shape
            err = _err_stats(torch.from_numpy(ref['raw'].reshape(-1, shape[-1])),
                             torch.from_numpy(got['raw'].reshape(-1, shape[-1])))
            _check(err['p9999_rel_err'] <= KERNEL_TOL and err['rms_rel_err'] <= KERNEL_RMS_TOL
                   and err['max_rel_err'] <= KERNEL_MAX_TOL, f'volume vs plain {_fmt(err)}')
            row = dict(vs_plain=err, vs_float32=_rel(f32_out['raw'], got['raw']))
        elif name == 'eruption':
            # the bundle was trained at one instant (t = 0); off it the field
            # is hypersensitive to bf16 flips (ROADMAP Queue 3), so the frames
            # at t != 0 are held by K0's point check at their own fine samples
            # and their image gap to the plain version is reported
            frames = []
            for i, t in enumerate(ERUPTION_TIMES):
                o, d = observer_rays(lat, lon, 215.0, 64)
                arrays = {'rays': torch.from_numpy(np.stack([o.reshape(-1, 3),
                                                             d.reshape(-1, 3)], 1)).to(device),
                          'time': torch.full((64 * 64, 1), t, device=device)}
                k0, plain_raw = _k0_on_points(fine_cfg, kernel.params['fine'], _fine_points(
                    kernel.renderer, kernel.params, arrays, kernel.batch_size))
                err = _err_stats(plain_raw, k0)
                _check(err['p9999_rel_err'] <= KERNEL_TOL and err['rms_rel_err'] <= KERNEL_RMS_TOL
                       and err['max_rel_err'] <= KERNEL_MAX_TOL,
                       f'eruption t={t}: K0 vs plain at its fine samples {_fmt(err)}')
                image = float(np.max(np.abs(ref['images'][i] - got['images'][i]))
                              / np.max(np.abs(ref['images'][i])))
                if t == 0.0:
                    _check(image <= RENDER_TOL, f'eruption t=0 vs plain {image:.3e}')
                frames.append(dict(time=t, k0_raw=err, image_vs_plain=image))
            row = dict(vs_plain=max(f['image_vs_plain'] for f in frames), frames=frames,
                       vs_float32=float(np.max(np.abs(f32_out['images'] - got['images'])))
                       / float(np.max(np.abs(ref['images']))))
        else:
            k = image_key[name]
            scale = fine_max if name == 'uncertainty' else float(np.max(np.abs(ref[k])))
            vs_plain = float(np.max(np.abs(ref[k] - got[k]))) / scale
            _check(vs_plain <= RENDER_TOL, f'{name} vs plain {vs_plain:.3e} (tol {RENDER_TOL})')
            row = dict(vs_plain=vs_plain,
                       vs_float32=float(np.max(np.abs(f32_out[k] - got[k]))) / scale)
        rows[name] = dict(row, seconds=seconds, k0_launches=launches,
                          shape=list(np.shape(got[image_key.get(name, 'raw')])))
    print('[eval] products on K0 (seconds, K0 launches, vs plain / vs float32): ' + '; '.join(
        f"{n} {r['seconds']:.3f} s x{r['k0_launches']} "
        + (_fmt(r['vs_plain']) if n == 'volume' else f"{r['vs_plain']:.2e}")
        + f" / {r['vs_float32']:.2e}" for n, r in rows.items()), flush=True)
    print('[eval] eruption frames (time: image vs plain of the frame\'s max, reported; K0 vs '
          'plain at the frame\'s fine samples, checked): ' + '; '.join(
              f"t={f['time']}: {f['image_vs_plain']:.2e}, {_fmt(f['k0_raw'])}"
              for f in rows['eruption']['frames']), flush=True)
    out['products'] = rows

    # the tiered 256^2 render against the untiered one, both on K0
    tiered = SuNeRFLoader(BUNDLE, tier=TIER, device=device)
    view256 = dict(VIEW, resolution=256)
    tiered.render_observer_image(**view256)
    full = kernel.render_observer_image(**view256)
    torch.cuda.synchronize()
    counts = {}
    for name, loader in (('untiered', kernel), ('tiered', tiered)):
        _zero_counters()
        view = loader.render_observer_image(**view256)   # the tiered one last
        counts[name] = fused_mlp.LAUNCHES
    _check(counts == {'untiered': 32, 'tiered': 48}, f'render K0 launches {counts}')
    _check(bool(np.isfinite(view.image).all()), 'tiered render not finite')
    # the bright tier: per chunk of batch_size rays, the half that the
    # coarse pass ranks brightest (the same coarse pass in both renders)
    o, d = observer_rays(VIEW['lat'], VIEW['lon'], 215.0, 256)
    score = kernel.render_rays(o, d, 0.0, keys=('coarse_image',))['coarse_image'].max(-1)
    bs, n_lo = kernel.batch_size, round(kernel.batch_size * TIER[0])
    in_bright = np.zeros(score.size, bool)
    for c in range(0, score.size, bs):
        in_bright[c + np.argsort(score[c:c + bs], kind='stable')[n_lo:]] = True
    got, ref = view.image[..., 0].reshape(-1), full.image[..., 0].reshape(-1)
    rel = np.abs(got - ref) / np.maximum(np.abs(ref), 1e-30)
    bright_err = float(rel[in_bright].max())
    # JAX's criterion (one chunk a frame there): pixels above the untiered
    # frame's 60th percentile, some of which fall in their chunk's dim half
    above60 = ref > np.percentile(ref, 60)
    above60_err = float(rel[above60].max())
    above60_dim = int((above60 & ~in_bright).sum())
    l1 = float(np.abs(view.image - full.image).sum() / full.image.sum())
    _check(bright_err <= TIER_BRIGHT_TOL, f'tiered bright tier {bright_err:.2e}')
    _check(l1 < TIER_L1_TOL, f'tiered frame relative L1 {l1:.3f}')
    times = {'untiered': [], 'tiered': []}
    for name in ('untiered', 'tiered', 'tiered', 'untiered') * 2:
        loader = kernel if name == 'untiered' else tiered
        t1 = time.perf_counter()
        loader.render_observer_image(**view256)
        times[name].append((time.perf_counter() - t1) * 1e3)
    ms = {k: statistics.median(v[:3]) for k, v in times.items()}
    # where a frame's time goes: device kernels against the host clock
    prof = {name: _wall_and_device_ms(lambda: loader.render_observer_image(**view256))
            for name, loader in (('untiered', kernel), ('tiered', tiered))}
    print(f'[eval] tiered 256^2 render {TIER}: {counts["tiered"]} K0 launches (untiered '
          f'{counts["untiered"]}); the bright tier\'s {int(in_bright.sum())} pixels within '
          f'{bright_err:.1e} relative of the untiered render (tol {TIER_BRIGHT_TOL:g}); pixels '
          f'above the untiered 60th percentile within {above60_err:.2e} ({above60_dim} of them '
          f'in their chunk\'s dim half; reported); frame L1 {l1:.4f} (tol {TIER_L1_TOL}); '
          f'{ms["tiered"]:.1f} ms a frame against {ms["untiered"]:.1f} untiered (host clock to '
          f'the host copy, median of 3, in turns); under torch.profiler ' + '; '.join(
              f"{k} {v['wall_ms']:.1f} ms wall, {v['device_ms']:.1f} ms of kernels, idle "
              f"{v['idle_share']:.1%}" for k, v in prof.items()), flush=True)
    shapes = {name: _k0_row(fine_cfg, kernel.params['fine'], n, device, seed)
              for name, n, seed in (('tier_bright', 2048 * 60, 11), ('tier_dim', 2048 * 16, 12))}
    print('[eval] K0 at the tiered render\'s fine shapes (trained fine field, random points): '
          + '; '.join(f"{k} N={r['n']} {r['ms']:.3f} ms (plain {r['plain_ms']:.3f}, bound "
                      f"{r['bound_ms']:.3f} by {r['bound_by']}), {_fmt(r)}"
                      for k, r in shapes.items()), flush=True)
    out['tiered_render'] = dict(launches=counts, bright_tier_rel_err=bright_err,
                                above60_rel_err=above60_err, above60_in_dim_tier=above60_dim,
                                frame_l1=l1, ms=ms, profile=prof, k0_shapes=shapes)
    out['wall_s'] = time.perf_counter() - t0
    print(f'[eval] {out["wall_s"]:.1f} s', flush=True)
    return out


def _dt_tier_batch(device, n: int) -> dict:
    """n rays of a 1 AU view at 256^2 (lat 0.3, lon 1.1), drawn from a
    seed, in every AIA channel, target 1 (the DT CLI's raw intensities)."""
    from sunerf_tpu_torch.core.geometry import observer_rays
    from sunerf_tpu_torch.models.fields import AIA_WAVELENGTHS
    o, d = observer_rays(VIEW['lat'], VIEW['lon'], 215.0, 256)
    pick = np.random.default_rng(4).choice(256 * 256, n, replace=False)
    rays = np.stack([o.reshape(-1, 3)[pick], d.reshape(-1, 3)[pick]], axis=1)
    wl = torch.tensor(AIA_WAVELENGTHS, dtype=torch.float32, device=device)
    return {'rays': torch.from_numpy(rays.astype(np.float32)).to(device),
            'time': torch.zeros((n, 1), device=device),
            'wavelength': wl.expand(n, len(AIA_WAVELENGTHS)).contiguous(),
            'target_image': torch.ones((n, len(AIA_WAVELENGTHS)), device=device)}


def _tiers_phase(device, trainer: dict) -> dict:
    """[tiers]: tiered training steps at bench.py's workload and at
    DT_2012_11's widths against the plain versions, their launches and
    step times, the tiers' kernel shapes, and a run_emission Trainer run with
    tier_warmup_steps."""
    from sunerf_tpu_torch.data.synthetic import synthesize_views
    from sunerf_tpu_torch.models.fields import density_temperature_config, emission_config
    from sunerf_tpu_torch.ops import fused_mlp
    from sunerf_tpu_torch.systems import make_density_temperature_system, make_emission_system
    from sunerf_tpu_torch.train.objective import LossConfig
    from sunerf_tpu_torch.train.optim import make_optimizer
    from sunerf_tpu_torch.train.step import create_train_state, make_train_step
    t0 = time.perf_counter()
    tier = dict(tier_fraction=TIER[0], tier_samples=TIER[1])
    rows = {}
    for name, factory, cfg, batch, loss_config in (
            ('bench', make_emission_system, emission_config(), _bench_batch(device),
             LossConfig()),
            ('dt', make_density_temperature_system, density_temperature_config(),
             _dt_tier_batch(device, DT_TIER_RAYS), LossConfig(image_scaling='none'))):
        tiered, init = factory(device=device, **tier)
        untiered = dataclasses.replace(tiered, tier_fraction=0.0)
        params = init(torch.Generator(device=device).manual_seed(0))
        tag = f'tiers] [{name}'
        vs = _step_vs_plain(tiered, {'field_apply': _plain_apply(cfg)}, params, batch,
                            loss_config, train_pass=True)
        _check_vs_plain(tag, vs)
        opt = make_optimizer()
        state = create_train_state(params, opt)
        steps = {'tiered': make_train_step(tiered, loss_config, opt),
                 'untiered': make_train_step(untiered, loss_config, opt)}
        launches = {}
        for k, step in steps.items():
            step(state, batch, 0)
            torch.cuda.synchronize()
            _zero_counters()
            _, m = step(state, batch, 0)
            launches[k] = _counters()
            _check(np.isfinite(float(m['loss'])), f'[{tag}] {k} loss not finite')
        _check(launches['tiered'] == {'STASH_FWD_LAUNCHES': 3, 'STASH_BWD_LAUNCHES': 3}
               and launches['untiered'] == {'STASH_FWD_LAUNCHES': 2, 'STASH_BWD_LAUNCHES': 2},
               f'[{tag}] launches {launches}')
        ms = {'untiered': [], 'tiered': []}
        for k in ('untiered', 'tiered', 'tiered', 'untiered'):
            ms[k].append(_step_times(steps[k], state, batch))
        n_rays = batch['rays'].shape[0]
        print(f'[{tag}] {cfg.n_layers}x{cfg.d_filter}, {n_rays} rays, tier {TIER}: a step '
              f'launches {launches["tiered"]} (untiered {launches["untiered"]}); step '
              f'{ms["tiered"]} ms against {ms["untiered"]} untiered (CUDA events, median of 10 '
              f'after 3, in turns U T T U)', flush=True)
        rows[name] = dict(vs_plain=vs, launches=launches, step_ms=ms, rays=n_rays,
                          fine_n=(n_rays - round(n_rays * TIER[0])) * 192
                          + round(n_rays * TIER[0]) * TIER[1])
        del state, steps, params
        torch.cuda.empty_cache()
    with torch.no_grad():
        shapes = {name: _stash_phase(name, 8, 512, n, device)
                  for name, n in (('tier_bright', 512 * 192), ('tier_dim', 512 * TIER[1]))}

    # the Trainer: run_emission with the tiers after tier_warmup_steps
    with tempfile.TemporaryDirectory() as tmp:
        pattern = synthesize_views(tmp, device, TRAINER_RES, BUNDLE)
        workdir = os.path.join(tmp, 'run')
        warm = TIERS_TRAINER_STEPS // 2
        config = {'path_to_save': workdir, 'rendering': dict(tier),
                  'data': {'data_path': pattern, 'batch_size': TRAINER_BATCH},
                  'training': {'total_steps': TIERS_TRAINER_STEPS, 'tier_warmup_steps': warm,
                               'log_every_n_steps': TIERS_TRAINER_STEPS,
                               'scalar_log_every': 10, 'drift_probe_views': 0}}
        _zero_counters()
        t1 = time.perf_counter()
        run = _run_cli(config, os.path.join(tmp, 'tiers.yaml'), device)
        run_s = time.perf_counter() - t1
        launches = _counters()
        recs = [json.loads(line) for line in open(os.path.join(workdir, 'metrics.jsonl'))]
        losses = {r['step']: r['loss'] for r in recs if 'loss' in r}
        step_ms = {r['step']: r['step_ms'] for r in recs if 'step_ms' in r}
        want = 2 * warm + 3 * (TIERS_TRAINER_STEPS - warm)
        print(f'[tiers] run_emission 8x512, batch {TRAINER_BATCH}, {TIERS_TRAINER_STEPS} steps, '
              f'tier {TIER} after {warm} full-budget steps: {run_s:.1f} s; launches {launches} '
              f'(K1, K2 expected {want} each); losses ' + ' '.join(
                  f'{s}:{v:.5f}' for s, v in sorted(losses.items())) + '; ms/step ' + ' '.join(
                  f'{s}:{v:.2f}' for s, v in sorted(step_ms.items())), flush=True)
        _check(launches.get('STASH_FWD_LAUNCHES') == want
               and launches.get('STASH_BWD_LAUNCHES') == want,
               f'tiers trainer launches {launches}, not {want} K1 and K2')
        _check(run.warmup_step_fn is not None, 'tiers trainer has no warm-up step')
        first, last = min(losses), max(losses)
        _check(all(np.isfinite(list(losses.values()))) and losses[last] < losses[first],
               f'tiers trainer loss did not fall: {losses}')
        del run
    wall = time.perf_counter() - t0
    print(f'[tiers] {wall:.1f} s', flush=True)
    return dict(rows=rows, shapes=shapes, trainer=dict(
        launches=launches, losses=losses, step_ms=step_ms, warmup=warm, run_s=run_s,
        bare_trainer_ms=trainer['ms_per_step']), wall_s=wall)


def _occupancy_activity(tag: str, occ, renderer, fine: dict, plain_fn, device, seed: int):
    """One cell-ordered activity of the occupancy update (the fine field on
    one jitter per cell), through the renderer's field (K0) and through the
    plain version, held to K0's tolerances; the cells whose occupancy the
    two disagree on are counted. Returns (K0 activity, error row)."""
    from sunerf_tpu_torch.core.occupancy import cell_activity
    u = torch.rand((occ.nr, occ.ntheta, occ.nphi, 3), device=device,
                   generator=torch.Generator(device=device).manual_seed(seed))
    act = {name: cell_activity(occ, apply, fine, renderer.head.occupancy_activity, u, 0.0,
                               renderer.solar_radius)
           for name, apply in (('kernel', renderer.field_apply), ('plain', plain_fn))}
    err = _err_stats(act['plain'].reshape(-1, 1), act['kernel'].reshape(-1, 1))
    occupied = {k: a > occ.threshold * torch.quantile(a.reshape(-1), 0.995)
                for k, a in act.items()}
    flipped = int((occupied['kernel'] != occupied['plain']).sum())
    print(f'[occupancy] {tag}: the update\'s activity ({act["kernel"].numel()} cells), K0 vs '
          f'plain: {_fmt(err)}; cells occupied in one and not the other: {flipped} (reported)',
          flush=True)
    _check(err['p9999_rel_err'] <= KERNEL_TOL and err['rms_rel_err'] <= KERNEL_RMS_TOL
           and err['max_rel_err'] <= KERNEL_MAX_TOL, f'{tag}: occupancy activity {_fmt(err)}')
    return act['kernel'], dict(err, flipped_cells=flipped)


def _occupancy_phase(device, trainer: dict) -> dict:
    """[occupancy]: run_emission at 8x512 with the occupancy grid (warmup 50,
    update_every 16) on synthesized views, to its first update (step 64) and,
    resumed from the checkpoint, to OCC_STEPS[1]; the update's activity on K0
    against the plain version, on the run's field and on the committed
    bundle's trained one, whose update takes the grid out of its warm state
    and whose render then samples by it; the run's bundle served through
    one product; ms a step and the update's ms."""
    from sunerf_tpu_torch.core.occupancy import (OccupancyConfig, init_occupancy,
                                                 occupancy_from_activity)
    from sunerf_tpu_torch.data.synthetic import synthesize_views
    from sunerf_tpu_torch.evaluation import products
    from sunerf_tpu_torch.evaluation.loader import ModelLoader, SuNeRFLoader
    from sunerf_tpu_torch.models.fields import NeRFConfig
    from sunerf_tpu_torch.ops import fused_mlp
    t0 = time.perf_counter()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        pattern = synthesize_views(tmp, device, TRAINER_RES, BUNDLE)
        workdir = os.path.join(tmp, 'run')
        first, total = OCC_STEPS
        config = {'path_to_save': workdir,
                  'rendering': {'occupancy': {'warmup': 50, 'update_every': 16}},
                  'data': {'data_path': pattern, 'batch_size': TRAINER_BATCH},
                  'training': {'total_steps': first, 'log_every_n_steps': total,
                               'scalar_log_every': 16, 'drift_probe_views': 0}}
        _zero_counters()
        run = _run_cli(config, os.path.join(tmp, 'occ.yaml'), device)
        first_fracs = {k: float((g > 0.5).float().mean())
                       for k, g in run.state.params['occupancy'].items()}
        first_min = {k: float(g.min()) for k, g in run.state.params['occupancy'].items()}
        del run
        config['training']['total_steps'] = total
        t1 = time.perf_counter()
        run = _run_cli(config, os.path.join(tmp, 'occ_resume.yaml'), device)
        run_s = time.perf_counter() - t1
        launches = _counters()
        _check(run.state.step == total, f'occupancy resume at {run.state.step}')
        recs = [json.loads(line) for line in open(os.path.join(workdir, 'metrics.jsonl'))]
        steps = [r for r in recs if 'loss' in r]
        losses = {r['step']: r['loss'] for r in steps}
        ms_step = statistics.mean(r['step_ms'] for r in steps if r['step'] > 16)
        print(f'[occupancy] run_emission 8x512 to step {total} (resumed at {first}, '
              f'{run_s:.1f} s): launches {launches}; losses ' + ' '.join(
                  f'{s}:{v:.5f}' for s, v in sorted(losses.items())) + '; occupied fractions '
              + ' '.join(f"{r['step']}:{r.get('occ_r_frac')}/{r.get('occ_ang_frac')}/"
                         f"{r.get('occ_vol_frac')}" for r in steps)
              + f'; after the first update (step {first}) fractions {first_fracs}, minima '
              f'{first_min}; {ms_step:.2f} ms/step over steps 17-{total} against '
              f'{trainer["ms_per_step"]:.2f} without occupancy ([trainer])', flush=True)
        _check(all(np.isfinite(list(losses.values())))
               and losses[max(losses)] < losses[min(losses)],
               f'occupancy loss did not fall: {losses}')
        _check(launches.get('STASH_FWD_LAUNCHES') == 2 * total
               and launches.get('STASH_BWD_LAUNCHES') == 2 * total,
               f'occupancy launches {launches}: not 2 K1 and 2 K2 a step')
        _check(all(k in r for r in steps for k in ('occ_r_frac', 'occ_ang_frac', 'occ_vol_frac')),
               'occupancy fractions missing from the log')

        r = run.renderer
        occ = r.occupancy
        _, run_err = _occupancy_activity(f'run field (step {total})', occ, r,
                                         run.state.params['fine'],
                                         _plain_apply(NeRFConfig(**r.spec['model_config'])),
                                         device, 5)
        _zero_counters()
        run.update_occupancy(total, 0.0)
        update_k0 = fused_mlp.LAUNCHES
        update_ms = _cuda_ms(lambda: run.update_occupancy(total, 0.0), warmup=2, reps=10)
        _check(update_k0 == 1, f'the update launched K0 {update_k0} times')

        # the run's bundle, grid included, served through one product
        loader = SuNeRFLoader(os.path.join(workdir, 'save_state'), device=device)
        _check(loader.renderer.occupancy == occ and 'occupancy' in loader.params,
               'the bundle lost its occupancy grid')
        _zero_counters()
        topo = products.topographic_maps(loader, VIEW['lat'], VIEW['lon'], 0.0, 215.0, 64)
        served_k0 = fused_mlp.LAUNCHES
        _check(served_k0 > 0 and all(bool(np.isfinite(v).all()) for v in topo.values()),
               f'occupancy bundle product: {served_k0} K0 launches')
        del run, loader

    # the committed bundle's trained fine field: one update from the warm
    # grid (the defaults), and the 256^2 view rendered by that grid
    bundle = SuNeRFLoader(BUNDLE, device=device)
    occ = OccupancyConfig()
    fine_cfg = NeRFConfig(**bundle.renderer.spec['model_config'])
    act, bundle_err = _occupancy_activity('the committed bundle\'s field', occ, bundle.renderer,
                                          bundle.params['fine'], _plain_apply(fine_cfg), device, 6)
    grid = occupancy_from_activity(init_occupancy(occ, device), occ, act)
    fracs = {k: float((g > 0.5).float().mean()) for k, g in grid.items()}
    _check(any(bool((g < 1.0).any()) for g in grid.values()),
           'the trained field\'s update left the grid warm')
    guided = ModelLoader(dataclasses.replace(bundle.renderer, occupancy=occ),
                         dict(bundle.params, occupancy=grid), ref_time=bundle.ref_time,
                         device=device)
    view256 = dict(VIEW, resolution=256)
    guided.render_observer_image(**view256)
    _zero_counters()
    t1 = time.perf_counter()
    view = guided.render_observer_image(**view256)
    guided_ms = (time.perf_counter() - t1) * 1e3
    guided_k0 = fused_mlp.LAUNCHES
    base = bundle.render_observer_image(**view256)
    _check(guided_k0 == 32 and all(bool(np.isfinite(getattr(view, k)).all()) for k in MAPS),
           f'occupancy-guided render: {guided_k0} K0 launches')
    gap = _rel(base.image, view.image)
    print(f'[occupancy] the committed bundle\'s field, one update from the warm grid '
          f'(defaults): occupied fractions {fracs}; its 256^2 view sampled by that grid: '
          f'{guided_k0} K0 launches, {guided_ms:.1f} ms, image {gap:.3e} of max from the '
          f'stratified render (reported); the update on the run\'s field {update_ms:.3f} ms '
          f'({update_k0} K0 launch, CUDA events, median of 10); the run\'s bundle served as a '
          f'64^2 topographic map ({served_k0} K0 launches)', flush=True)
    wall = time.perf_counter() - t0
    print(f'[occupancy] {wall:.1f} s', flush=True)
    out.update(first_update=dict(fractions=first_fracs, minima=first_min), launches=launches,
               losses=losses, ms_per_step=ms_step, bare_trainer_ms=trainer['ms_per_step'],
               run_activity_err=run_err, bundle_activity_err=bundle_err,
               bundle_grid_fractions=fracs, guided_render=dict(ms=guided_ms, k0_launches=guided_k0,
                                                               image_vs_stratified=gap),
               update_ms=update_ms, update_k0_launches=update_k0, served_k0_launches=served_k0,
               wall_s=wall)
    return out


# ------------------------------------------------ data parallel and microbatch

def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def _clipped_grads(state) -> dict:
    """The step's gradients as Adam took them (global-norm clipped), by
    field and key."""
    return {f: {k: v.grad.detach().clone() for k, v in sub.items()}
            for f, sub in state.params.items()}


def _grads_vs(tag: str, ref: dict, got: dict) -> float:
    errs = {f: _grad_err(ref[f], got[f]) for f in ref}
    worst = max(e['max_rel_err'] for g in errs.values() for e in g.values())
    _check(worst <= GRAD_TOL, f'[dp] {tag}: gradients {worst:.3e} of max (tol {GRAD_TOL})')
    return worst


def _same_bits(a: dict, b: dict) -> float:
    """0.0 where two nested dicts of tensors hold the same bits, else the
    largest gap over max|a| of any leaf."""
    gaps = [float((b[f][k] - v).abs().max() / v.abs().max().clamp_min(1e-30))
            for f, sub in a.items() for k, v in sub.items() if not torch.equal(v, b[f][k])]
    return max(gaps, default=0.0)


def _timed_in_turns(steps: dict, states: dict, batch: dict, warmup: int = 3,
                    reps: int = 10) -> dict:
    """Median CUDA-event ms of each named step, the steps taken in turns."""
    for name in steps:
        for _ in range(warmup):
            steps[name](states[name], batch, 0)
    times = {name: [] for name in steps}
    for _ in range(reps):
        for name in steps:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            steps[name](states[name], batch, 0)
            end.record()
            end.synchronize()
            times[name].append(start.elapsed_time(end))
    return {name: statistics.median(t) for name, t in times.items()}


def _dp_rank(rank: int, world: int, tmp: str):
    """One of [dp]'s spawned ranks, both on cuda:0 over gloo: one mesh step
    on its rows of DP_RAYS * world rays (launches counted, loss and clipped
    gradients saved), the step's and the all-reduce's times, and the
    committed bundle's frame tiled over the ranks."""
    import signal
    from datetime import timedelta
    signal.signal(signal.SIGTERM, signal.SIG_DFL)
    from sunerf_tpu_torch.evaluation.loader import SuNeRFLoader
    from sunerf_tpu_torch.ops import fused_mlp
    from sunerf_tpu_torch.parallel.mesh import all_mean_, make_mesh, replicate, shard_batch
    from sunerf_tpu_torch.systems import make_emission_system
    from sunerf_tpu_torch.train.objective import LossConfig
    from sunerf_tpu_torch.train.optim import make_optimizer
    from sunerf_tpu_torch.train.step import create_train_state, make_train_step
    device = torch.device('cuda', 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    # the imports above overlap the parent's phases; the card is touched
    # only once the parent has finished with it
    go = os.path.join(tmp, 'go')
    t0 = time.perf_counter()
    while not os.path.exists(go):
        if time.perf_counter() - t0 > 2 * DP_DEADLINE_S:
            raise SystemExit(f'rank {rank}: no go signal')
        time.sleep(0.05)
    mesh = make_mesh(devices=[device] * world, init_method=f'file://{tmp}/store_gloo',
                     rank=rank, world_size=world, timeout=timedelta(seconds=60))
    out = {'backend': mesh.backend}
    params = torch.load(os.path.join(tmp, 'params.pt'))
    params = {f: {k: v.to(device) for k, v in sub.items()} for f, sub in params.items()}
    opt = make_optimizer()
    fixed, _ = make_emission_system(device='cuda', perturb=False)
    bench, _ = make_emission_system(device='cuda')
    batch = shard_batch(mesh, _bench_batch(device, DP_RAYS * world))
    state = replicate(mesh, create_train_state(params, opt))
    step = make_train_step(fixed, LossConfig(), opt, mesh=mesh)
    _zero_counters()
    _, m = step(state, batch, 0)
    torch.cuda.synchronize()
    out['launches'] = _counters()
    out['loss'] = float(m['loss'])
    out['grads'] = {f: {k: v.cpu() for k, v in g.items()}
                    for f, g in _clipped_grads(state).items()}
    timed = create_train_state(params, opt)
    out['step_ms'] = _timed_in_turns(
        {'mesh': make_train_step(bench, LossConfig(), opt, mesh=mesh)}, {'mesh': timed},
        batch)['mesh']
    grads = [p.grad for group in timed.opt_state.param_groups for p in group['params']]
    times = []
    for _ in range(13):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        all_mean_(mesh, grads)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    out['all_reduce_ms'] = statistics.median(times[3:])
    out['all_reduce_bytes'] = 4 * sum(g.numel() for g in grads)
    fused_mlp.LAUNCHES = 0
    view = SuNeRFLoader(BUNDLE, mesh=mesh).render_observer_image(**VIEW, resolution=256)
    out['frame_k0_launches'] = fused_mlp.LAUNCHES
    out['frame'] = view.image
    torch.save(out, os.path.join(tmp, f'rank{rank}.pt'))
    torch.distributed.destroy_process_group()


def _dp_trainer(device, trainer: dict) -> dict:
    """[dp] d: run_emission at 8x512 as a one-rank mesh under torchrun's
    environment, with training.microbatch."""
    from sunerf_tpu_torch.data.synthetic import synthesize_views
    from sunerf_tpu_torch.evaluation.loader import SuNeRFLoader
    from sunerf_tpu_torch.ops import fused_mlp
    env = dict(RANK='0', WORLD_SIZE='1', LOCAL_RANK='0', MASTER_ADDR='127.0.0.1',
               MASTER_PORT=str(_free_port()))
    saved = {k: os.environ.get(k) for k in env}
    with tempfile.TemporaryDirectory() as tmp:
        pattern = synthesize_views(tmp, device, TRAINER_RES, BUNDLE)
        workdir = os.path.join(tmp, 'run')
        config = {'path_to_save': workdir,
                  'data': {'data_path': pattern, 'batch_size': TRAINER_BATCH},
                  'training': {'total_steps': DP_TRAINER_STEPS,
                               'log_every_n_steps': DP_TRAINER_STEPS, 'scalar_log_every': 10,
                               'drift_probe_views': 0, 'microbatch': DP_TRAINER_MICRO}}
        os.environ.update(env)
        try:
            _zero_counters()
            t0 = time.perf_counter()
            tr = _run_cli(config, os.path.join(tmp, 'dp.yaml'), device)
            run_s = time.perf_counter() - t0
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        launches = _counters()
        mesh = (tr.mesh.size, tr.mesh.backend, str(tr.mesh.device))
        recs = [json.loads(line) for line in open(os.path.join(workdir, 'metrics.jsonl'))]
        steps = [r for r in recs if 'loss' in r]
        ms_step = statistics.mean(r['step_ms'] for r in steps[1:])
        ckpts = sorted(os.listdir(os.path.join(workdir, 'checkpoints')))
        fused_mlp.LAUNCHES = 0
        view = SuNeRFLoader(os.path.join(workdir, 'save_state'), device=device) \
            .render_observer_image(lat=0.3, lon=1.1, time=0.0, distance=215.0, resolution=64)
        served = fused_mlp.LAUNCHES
    chunks = TRAINER_BATCH // DP_TRAINER_MICRO
    print(f'[dp] d. run_emission 8x512 under torchrun\'s environment: mesh (size, backend, '
          f'device) {mesh}, batch {TRAINER_BATCH}, microbatch {DP_TRAINER_MICRO}, '
          f'{DP_TRAINER_STEPS} steps in {run_s:.1f} s; launches {launches} (K1, K2 expected '
          f'{2 * chunks * DP_TRAINER_STEPS} each); losses ' + ' '.join(
              f"{r['step']}:{r['loss']:.5f}" for r in steps)
          + f'; checkpoints {ckpts}; {ms_step:.2f} ms/step over steps 11-{DP_TRAINER_STEPS} '
          f'(the host clock, waiting for the loss every 10 steps) beside [trainer]\'s '
          f'{trainer["ms_per_step"]:.2f} (no microbatch, no mesh); the bundle served at 64^2: '
          f'{served} K0 launches', flush=True)
    _check(mesh[:2] == (1, 'nccl'), f'[dp] d: the CLI made no one-rank NCCL mesh: {mesh}')
    _check(launches.get('STASH_FWD_LAUNCHES') == 2 * chunks * DP_TRAINER_STEPS
           and launches.get('STASH_BWD_LAUNCHES') == 2 * chunks * DP_TRAINER_STEPS,
           f'[dp] d: launches {launches}')
    _check(all(np.isfinite(r['loss']) for r in steps) and steps[-1]['loss'] < steps[0]['loss'],
           f"[dp] d: loss did not fall: {[r['loss'] for r in steps]}")
    _check(ckpts == [f'step_{DP_TRAINER_STEPS:08d}.pt'], f'[dp] d: checkpoints {ckpts}')
    _check(served > 0 and all(np.isfinite(getattr(view, k)).all() for k in MAPS),
           f'[dp] d: the bundle was not served on K0 ({served} launches)')
    return dict(mesh=list(mesh), launches=launches, losses=[r['loss'] for r in steps],
                ms_per_step=ms_step, trainer_ms_per_step=trainer['ms_per_step'],
                checkpoints=ckpts, served_k0_launches=served, run_s=run_s)


def _dp_phase(device, trainer: dict) -> dict:
    """[dp]: the mesh and microbatch at bench.py's workload (8x512 for both
    fields, 64 + 128 samples): a. a one-rank NCCL mesh in this process
    against the single-device step; b. two spawned ranks on this card over
    gloo against the single-process step on both ranks' rays; c. the
    microbatched step against the unchunked one; d. the Trainer through the
    CLI as a one-rank mesh; e. the committed bundle's 256^2 frame tiled over
    the one-rank NCCL mesh and the two gloo ranks against the single-device
    frame."""
    import multiprocessing
    from datetime import timedelta
    import torch.distributed as dist
    from sunerf_tpu_torch.evaluation.loader import SuNeRFLoader
    from sunerf_tpu_torch.parallel.mesh import all_mean_, make_mesh
    from sunerf_tpu_torch.systems import make_emission_system
    from sunerf_tpu_torch.train.objective import LossConfig
    from sunerf_tpu_torch.train.optim import make_optimizer
    from sunerf_tpu_torch.train.step import create_train_state, make_train_step
    t_phase = time.perf_counter()
    out = {}
    fixed, init = make_emission_system(device='cuda', perturb=False)
    bench, _ = make_emission_system(device='cuda')
    params = init(torch.Generator(device=device).manual_seed(0))
    opt = make_optimizer()
    batch = _bench_batch(device, DP_RAYS)
    tmp = tempfile.mkdtemp()
    torch.save({f: {k: v.cpu() for k, v in sub.items()} for f, sub in params.items()},
               os.path.join(tmp, 'params.pt'))
    single_frame = SuNeRFLoader(BUNDLE, device=device).render_observer_image(
        **VIEW, resolution=256).image

    # b. two ranks on this card over gloo, spawned first so that their
    # start overlaps a, c and d; they touch the card after d (the go file)
    ctx = multiprocessing.get_context('spawn')
    ranks = [ctx.Process(target=_dp_rank, args=(r, 2, tmp)) for r in range(2)]
    for p in ranks:
        p.start()
    try:
        # a. one rank over NCCL, in this process
        mesh = make_mesh(devices=[device], init_method=f'file://{tmp}/store',
                         rank=0, world_size=1, timeout=timedelta(seconds=60))
        try:
            _check(mesh.backend == 'nccl', f'[dp] a: a one-card mesh over {mesh.backend}')
            states = {k: create_train_state(params, opt) for k in ('single', 'mesh')}
            make_train_step(fixed, LossConfig(), opt)(states['single'], batch, 0)
            _zero_counters()
            _, m = make_train_step(fixed, LossConfig(), opt, mesh=mesh)(states['mesh'], batch, 0)
            torch.cuda.synchronize()
            launches = _counters()
            gap = _same_bits(states['single'].params, states['mesh'].params)
            grads_gap = _same_bits(_clipped_grads(states['single']),
                                   _clipped_grads(states['mesh']))
            timed = {k: create_train_state(params, opt) for k in ('single', 'mesh')}
            ms = _timed_in_turns({'single': make_train_step(bench, LossConfig(), opt),
                                  'mesh': make_train_step(bench, LossConfig(), opt, mesh=mesh)},
                                 timed, batch)
            grads = [p.grad for g in timed['mesh'].opt_state.param_groups for p in g['params']]
            flat = torch.cat([g.reshape(-1) for g in grads])
            ar_ms = _cuda_ms(lambda: dist.all_reduce(flat))
            mean_ms = _cuda_ms(lambda: all_mean_(mesh, grads))
            nccl_frame = SuNeRFLoader(BUNDLE, mesh=mesh).render_observer_image(
                **VIEW, resolution=256).image
        finally:
            dist.destroy_process_group()
        out['a'] = dict(launches=launches, params_gap=gap, grads_gap=grads_gap,
                        loss=float(m['loss']), step_ms=ms['mesh'], single_step_ms=ms['single'],
                        all_reduce_ms=ar_ms, all_mean_ms=mean_ms,
                        all_reduce_bytes=flat.numel() * 4)
        print(f'[dp] a. one-rank NCCL mesh, {DP_RAYS} rays: launches {launches} (expected 2 K1, '
              f'2 K2); vs the single-device step: params {"the same bits" if gap == 0 else gap}, '
              f'clipped grads {"the same bits" if grads_gap == 0 else grads_gap}; step '
              f'{ms["mesh"]:.2f} ms against {ms["single"]:.2f} (CUDA events, median of 10 after '
              f'3 warm-ups, in turns); the all-reduce of {flat.numel() * 4 / 1e6:.2f} MB '
              f'{ar_ms:.4f} ms, with its flatten, mean and copy back {mean_ms:.4f} ms (CUDA '
              f'events, median of 20)', flush=True)
        _check(launches == {'STASH_FWD_LAUNCHES': 2, 'STASH_BWD_LAUNCHES': 2},
               f'[dp] a: launches {launches}')
        _check(gap <= STEP_LOSS_TOL, f'[dp] a: mesh params {gap:.3e} from single-device')
        del states, timed, grads, flat

        # c. microbatch against the unchunked step
        n, micro = DP_MICRO
        big = _bench_batch(device, n)
        checks, peaks = {}, {}
        for name, mb in (('whole', None), ('micro', micro)):
            state = create_train_state(params, opt)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
            _zero_counters()
            _, m = make_train_step(fixed, LossConfig(), opt, microbatch=mb)(state, big, 0)
            torch.cuda.synchronize()
            peaks[name] = dict(peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                               growth_gib=(torch.cuda.max_memory_allocated() - before) / 2 ** 30)
            checks[name] = dict(loss=float(m['loss']), grads=_clipped_grads(state),
                                launches=_counters())
            del state
        loss_rel = abs(checks['micro']['loss'] - checks['whole']['loss']) / abs(
            checks['whole']['loss'])
        worst = _grads_vs('c. microbatch', checks['whole']['grads'], checks['micro']['grads'])
        timed = {k: create_train_state(params, opt) for k in ('whole', 'micro')}
        ms = _timed_in_turns({'whole': make_train_step(bench, LossConfig(), opt),
                              'micro': make_train_step(bench, LossConfig(), opt,
                                                       microbatch=micro)}, timed, big)
        del timed
        out['c'] = dict(rays=n, microbatch=micro, launches=checks['micro']['launches'],
                        loss_rel_err=loss_rel, grads_max_rel_err=worst, step_ms=ms['micro'],
                        whole_step_ms=ms['whole'], memory=peaks)
        print(f'[dp] c. {n} rays, microbatch {micro}: launches {checks["micro"]["launches"]} '
              f'(expected 8 K1, 8 K2; unchunked {checks["whole"]["launches"]}); vs the '
              f'unchunked step: loss {loss_rel:.2e} relative (tol {STEP_LOSS_TOL}), clipped '
              f'grads {worst:.2e} of max (tol {GRAD_TOL}); {ms["micro"]:.2f} ms/step against '
              f'{ms["whole"]:.2f} (in turns); peak device memory {peaks["micro"]["peak_gib"]:.2f} '
              f'GiB against {peaks["whole"]["peak_gib"]:.2f}, the step\'s growth over what it '
              f'found {peaks["micro"]["growth_gib"]:.2f} against '
              f'{peaks["whole"]["growth_gib"]:.2f} GiB', flush=True)
        _check(checks['micro']['launches'] == {'STASH_FWD_LAUNCHES': 8, 'STASH_BWD_LAUNCHES': 8},
               f'[dp] c: launches {checks["micro"]["launches"]}')
        _check(loss_rel <= STEP_LOSS_TOL, f'[dp] c: loss {loss_rel:.3e}')
        del checks, big
        torch.cuda.empty_cache()

        # d. the Trainer through the CLI
        out['d'] = _dp_trainer(device, trainer)

        # b. the two ranks' results
        open(os.path.join(tmp, 'go'), 'w').close()
        t_spawn = time.perf_counter()
        for p in ranks:
            p.join(max(DP_DEADLINE_S - (time.perf_counter() - t_spawn), 1.0))
        alive = [p.pid for p in ranks if p.is_alive()]
        _check(not alive, f'[dp] b: ranks {alive} still running after {DP_DEADLINE_S} s')
    finally:
        for p in ranks:
            if p.is_alive():
                p.kill()
                p.join()
    _check(all(p.exitcode == 0 for p in ranks),
           f'[dp] b: rank exit codes {[p.exitcode for p in ranks]}')
    res = [torch.load(os.path.join(tmp, f'rank{r}.pt'), weights_only=False) for r in range(2)]
    state = create_train_state(params, opt)
    _, m = make_train_step(fixed, LossConfig(), opt)(state, _bench_batch(device, 2 * DP_RAYS), 0)
    ref_loss, ref_grads = float(m['loss']), _clipped_grads(state)
    launches = {}
    for r in res:
        for k, v in r['launches'].items():
            launches[k] = launches.get(k, 0) + v
    loss_rel = max(abs(r['loss'] - ref_loss) / abs(ref_loss) for r in res)
    worst = max(_grads_vs(f'b. rank {i}',
                          {f: {k: v.cpu() for k, v in g.items()} for f, g in ref_grads.items()},
                          r['grads']) for i, r in enumerate(res))
    out['b'] = dict(backend=res[0]['backend'], launches=launches, loss_rel_err=loss_rel,
                    grads_max_rel_err=worst, step_ms=[r['step_ms'] for r in res],
                    all_reduce_host_ms=[r['all_reduce_ms'] for r in res],
                    all_reduce_bytes=res[0]['all_reduce_bytes'],
                    single_step_ms=out['a']['single_step_ms'])
    print(f'[dp] b. two spawned ranks on cuda:0 over {res[0]["backend"]}, {DP_RAYS} rays each: '
          f'launches in all {launches} (expected 4 K1, 4 K2); vs the single-process step on '
          f'the {2 * DP_RAYS} rays: loss {loss_rel:.2e} relative (tol {STEP_LOSS_TOL}), clipped '
          f'grads {worst:.2e} of max (tol {GRAD_TOL}); step {res[0]["step_ms"]:.2f} / '
          f'{res[1]["step_ms"]:.2f} ms a rank (CUDA events, median of 10); the gloo all-reduce '
          f'of {res[0]["all_reduce_bytes"] / 1e6:.2f} MB {res[0]["all_reduce_ms"]:.2f} / '
          f'{res[1]["all_reduce_ms"]:.2f} ms (host clock to a synchronize, median of 10: '
          f'gloo stages CUDA tensors through the host, a cost of two ranks on one card, not of '
          f'data parallel across cards)', flush=True)
    _check(launches == {'STASH_FWD_LAUNCHES': 4, 'STASH_BWD_LAUNCHES': 4},
           f'[dp] b: launches {launches}')
    _check(loss_rel <= STEP_LOSS_TOL, f'[dp] b: loss {loss_rel:.3e}')

    # e. the tiled frames
    frames = {'nccl_1': nccl_frame, 'gloo_2_rank0': res[0]['frame'],
              'gloo_2_rank1': res[1]['frame']}
    gaps = {k: (0.0 if np.array_equal(v, single_frame) else _rel(single_frame, v))
            for k, v in frames.items()}
    out['e'] = dict(gaps=gaps, k0_launches=[r['frame_k0_launches'] for r in res])
    print(f'[dp] e. the committed bundle\'s 256^2 frame tiled over the mesh, against the '
          f'single-device frame (0.0: the same bits): {gaps}; K0 launches a gloo rank '
          f'{out["e"]["k0_launches"]} (32 untiled)', flush=True)
    _check(all(g <= FRAME_TOL for g in gaps.values()), f'[dp] e: frames {gaps}')
    shutil.rmtree(tmp, ignore_errors=True)
    out['wall_s'] = time.perf_counter() - t_phase
    print(f'[dp] {out["wall_s"]:.1f} s', flush=True)
    return out


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


CPU_PROGRAM = """
import io, json, sys, zipfile
import torch
path, rays, res = sys.argv[1], sys.argv[2], int(sys.argv[3])
with zipfile.ZipFile(path) as zf:
    meta = json.loads(zf.read('meta.json'))
    render = torch.export.load(io.BytesIO(zf.read('render.cpu.pt2'))).module()
r, b = torch.load(rays), meta['batch_size']
pad = lambda x: torch.cat([x, x.new_zeros(b - x.shape[0], x.shape[1])])
with torch.no_grad():
    image = render(pad(r['ro']), pad(r['rd']), pad(r['t']),
                   torch.zeros(b, meta['n_channels']))[0][:res * res]
torch.save(image, rays + '.out')
print(json.dumps({'finite': bool(torch.isfinite(image).all()), 'shape': list(image.shape),
                  'port': sorted(k for k in sys.modules if k.startswith('sunerf_tpu'))}))
"""


def _close(tag: str, served, live) -> dict:
    """max |served - live| and its share of max|live|, checked at SERVE_RTOL
    / SERVE_ATOL elementwise, and whether the bits are the same."""
    a, b = np.asarray(served, np.float64), np.asarray(live, np.float64)
    diff = np.abs(a - b)
    _check(bool(np.all(diff <= SERVE_ATOL + SERVE_RTOL * np.abs(b))),
           f'{tag}: served vs live max diff {diff.max():.3e}')
    return dict(max_abs_diff=float(diff.max()),
                max_rel_diff=float(diff.max() / max(np.abs(b).max(), 1e-30)),
                same_bits=bool(np.array_equal(served, live)))


def _served_vs(tag: str, served, live) -> dict:
    """_close of each map of two RenderedViews."""
    return {k: _close(f'{tag} {k}', getattr(served, k), getattr(live, k)) for k in MAPS}


def _library_launches(library: str, fn) -> dict:
    """The launches in one fn() by kernel name, as the library
    csrc/<library>.cu counts them itself (fused_mlp.kernel_launches): K0's
    in an exported program too, which the wrapper does not see, and K5's
    own kernels; torch.profiler loses device records on the card's
    machine, all of a call's or some."""
    from sunerf_tpu_torch.ops import fused_mlp
    before = fused_mlp.kernel_launches(library)
    fn()
    torch.cuda.synchronize()
    after = fused_mlp.kernel_launches(library)
    return {k: after[k] - before[k] for k in after}


def _k0_launches(fn) -> int:
    return _library_launches('fused_mlp_fwd_wgmma', fn)[K0_KERNEL]


def _export_phase(device, loader, live_view) -> dict:
    """[export]: the committed bundle exported (cpu + cuda programs) and
    served from the artifact on the card against the live loader."""
    import io
    import zipfile
    from sunerf_tpu_torch.core.geometry import observer_rays
    from sunerf_tpu_torch.evaluation.loader import SuNeRFLoader
    from sunerf_tpu_torch.evaluation.serving import ServingModel, export_serving, program_name
    from sunerf_tpu_torch.models.fields import NeRFConfig
    from sunerf_tpu_torch.ops import fused_mlp
    from sunerf_tpu_torch.scripts import probe_serving
    t_phase = time.perf_counter()
    out = {}
    view256 = dict(VIEW, resolution=256)
    with tempfile.TemporaryDirectory() as tmp:
        # a. the export and the CUDA program's graph
        art = os.path.join(tmp, 'bundle.tsrv')
        t0 = time.perf_counter()
        meta = export_serving(BUNDLE, art, batch_size=EXPORT_BATCH, platforms=('cpu', 'cuda'))
        out['export_s'] = time.perf_counter() - t0
        out['artifact_bytes'] = os.path.getsize(art)
        graph = {}
        with zipfile.ZipFile(art) as zf:
            out['members'] = {n: zf.getinfo(n).file_size for n in zf.namelist()}
            for entry in ('render', 'points'):
                for platform in ('cpu', 'cuda'):
                    ep = torch.export.load(io.BytesIO(zf.read(program_name(entry, platform))))
                    targets = [str(n.target) for n in ep.graph.nodes if n.op == 'call_function']
                    graph[f'{entry}.{platform}'] = dict(
                        nodes=len(targets), k0_ops=targets.count(K0_OP),
                        other_port_calls=sorted({t for t in targets
                                                 if 'sunerf' in t and t != K0_OP}))
        _check(meta['fused_cuda'] and meta['platforms'] == ['cpu', 'cuda'], f'export meta {meta}')
        _check(graph['render.cuda']['k0_ops'] == 2 and graph['points.cuda']['k0_ops'] == 1
               and graph['render.cpu']['k0_ops'] == 0 and graph['points.cpu']['k0_ops'] == 0
               and not any(g['other_port_calls'] for g in graph.values()),
               f'export graphs {graph}')
        out['graph'] = graph
        print(f"[export] a. {BUNDLE} -> .tsrv (cpu + cuda, batch {EXPORT_BATCH}): "
              f"{out['export_s']:.1f} s, {out['artifact_bytes'] / 2**20:.1f} MiB; "
              + '; '.join(f"{k}: {g['nodes']} nodes, {g['k0_ops']} K0 op"
                          for k, g in graph.items()), flush=True)

        # b. the 256^2 view served from the artifact against the live frame
        model = ServingModel(art, device='cuda')
        model.render_observer_image(**view256)
        torch.cuda.synchronize()
        _zero_counters()
        served = model.render_observer_image(**view256)
        out['wrapper_launches_in_served_frame'] = fused_mlp.LAUNCHES
        out['served_vs_live'] = _served_vs('[export] b. 256^2', served, live_view)
        print('[export] b. 256^2 served vs live: ' + '; '.join(
            f"{k} max {r['max_abs_diff']:.2e} ({r['max_rel_diff']:.2e} of max), same bits "
            f"{r['same_bits']}" for k, r in out['served_vs_live'].items())
            + f" (rtol {SERVE_RTOL:g}, atol {SERVE_ATOL:g})", flush=True)

        # c. K0's launches in the served frame, by kernel name; K0 at the
        # frame's fine samples against its plain version
        out['kernels'] = {
            'served': _kernel_breakdown(lambda: model.render_observer_image(**view256),
                                        'export served 256^2'),
            'live': _kernel_breakdown(lambda: loader.render_observer_image(**view256),
                                      'export live 256^2')}
        out['k0_launches'] = {
            'served': _k0_launches(lambda: model.render_observer_image(**view256)),
            'live': _k0_launches(lambda: loader.render_observer_image(**view256))}
        _check(out['k0_launches']['served'] == 32,
               f"served frame launched K0 {out['k0_launches']['served']} times, not 32")
        o, d = observer_rays(VIEW['lat'], VIEW['lon'], VIEW['distance'], 256)
        arrays = {'rays': torch.as_tensor(np.stack([o.reshape(-1, 3), d.reshape(-1, 3)], 1),
                                          device=device),
                  'time': torch.zeros(256 * 256, 1, device=device)}
        fine_cfg = NeRFConfig(**loader.config['renderer_spec']['model_config'])
        got, ref = _k0_on_points(fine_cfg, loader.params['fine'],
                                 _fine_points(loader.renderer, loader.params, arrays, 4096))
        out['k0_fine_samples'] = _err_stats(ref, got)
        _check_k0('export c. the frame\'s fine samples', out['k0_fine_samples'])
        times = {'served': [], 'live': []}
        for name in ('live', 'served', 'served', 'live') * 2:
            src = model if name == 'served' else loader
            t0 = time.perf_counter()
            src.render_observer_image(**view256)
            times[name].append((time.perf_counter() - t0) * 1e3)
        out['render_256_ms'] = {k: statistics.median(v) for k, v in times.items()}
        out['render_256_profile'] = {
            'served': _wall_and_device_ms(lambda: model.render_observer_image(**view256)),
            'live': _wall_and_device_ms(lambda: loader.render_observer_image(**view256))}
        print(f"[export] c. K0 launches by kernel name: served {out['k0_launches']['served']}, "
              f"live {out['k0_launches']['live']} (the wrapper's count in the served frame: "
              f"{out['wrapper_launches_in_served_frame']}); 256^2 served "
              f"{out['render_256_ms']['served']:.1f} ms, live {out['render_256_ms']['live']:.1f}"
              f" ms (host clock, median of 4 in turns); under torch.profiler " + '; '.join(
                  f"{k} {v['wall_ms']:.1f} ms wall, {v['device_ms']:.1f} ms of kernels, idle "
                  f"{v['idle_share']:.1%}" for k, v in out['render_256_profile'].items()),
              flush=True)

        # d. the points entry on a 64^3 cube against live load_coords
        axis = np.linspace(-1.3, 1.3, 64, dtype=np.float32)
        cube = np.stack([*np.meshgrid(axis, axis, axis, indexing='ij'),
                         np.zeros((64,) * 3, np.float32)], -1).reshape(-1, 4)
        served_raw, live_raw = model.load_coords(cube), loader.load_coords(cube)
        out['points_64'] = _close('[export] d. points', served_raw, live_raw)
        print(f"[export] d. points entry, 64^3 cube: max diff {out['points_64']['max_abs_diff']:.2e}"
              f", same bits {out['points_64']['same_bits']}", flush=True)

        # e. a tiered artifact against the live tiered loader
        tiered_art = os.path.join(tmp, 'tiered.tsrv')
        export_serving(BUNDLE, tiered_art, batch_size=EXPORT_BATCH, platforms=('cuda',),
                       tier=TIER)
        tiered_model = ServingModel(tiered_art, device='cuda')
        tiered_live = SuNeRFLoader(BUNDLE, tier=TIER, device=device)
        t_served = tiered_model.render_observer_image(**view256).image[..., 0].reshape(-1)
        t_live = tiered_live.render_observer_image(**view256).image[..., 0].reshape(-1)
        score = loader.render_rays(o, d, 0.0, keys=('coarse_image',))['coarse_image'].max(-1)
        n_lo = round(EXPORT_BATCH * TIER[0])
        in_bright = np.zeros(score.size, bool)
        for c in range(0, score.size, EXPORT_BATCH):
            in_bright[c + np.argsort(score[c:c + EXPORT_BATCH], kind='stable')[n_lo:]] = True
        bright_diff = float(np.abs(t_served - t_live)[in_bright].max())
        out['tiered'] = dict(bright_max_abs_diff=bright_diff,
                             frame_max_rel_diff=_rel(t_live, t_served),
                             kernels=_kernel_breakdown(
                                 lambda: tiered_model.render_observer_image(**view256),
                                 'export tiered served 256^2'),
                             k0_launches=_k0_launches(
                                 lambda: tiered_model.render_observer_image(**view256)))
        _check(bright_diff == 0.0, f'tiered artifact: bright tier {bright_diff:.3e} from live')
        _check(out['tiered']['k0_launches'] == 48,
               f"tiered served frame launched K0 {out['tiered']['k0_launches']} times, not 48")
        print(f"[export] e. tiered {TIER} artifact vs the live tiered loader: the bright tier's "
              f"{int(in_bright.sum())} pixels {bright_diff:.1e} apart (the same bits required), "
              f"the frame {out['tiered']['frame_max_rel_diff']:.2e} of max; "
              f"{out['tiered']['k0_launches']} K0 launches", flush=True)
        del tiered_model, tiered_live

        # f. probe_serving: artifact against live at 512^2, batch 8,192
        out['probe_serving'] = probe_serving.main(['--state', BUNDLE, *PROBE_SERVING])
        ps = out['probe_serving']
        _check(ps['max_rel_diff'] <= SERVE_RTOL, f"probe_serving frames {ps['max_rel_diff']:.2e}")
        print(f"[export] f. probe_serving 512^2 batch 8192: live {ps['live']['wall_ms']:.1f} ms "
              f"wall / {ps['live']['events_ms']:.1f} ms events / {ps['live']['device_ms']:.1f} ms "
              f"of kernels ({ps['live']['k0_launches']} K0), served {ps['served']['wall_ms']:.1f} / "
              f"{ps['served']['events_ms']:.1f} / {ps['served']['device_ms']:.1f} "
              f"({ps['served']['k0_launches']} K0); served/live {ps['served_over_live']:.3f}",
              flush=True)

        # g. the CPU program in a process that imports only torch, zipfile and json
        res = CPU_PROGRAM_RES
        o16, d16 = observer_rays(VIEW['lat'], VIEW['lon'], VIEW['distance'], res)
        rays = os.path.join(tmp, 'rays.pt')
        torch.save({'ro': torch.as_tensor(o16.reshape(-1, 3)),
                    'rd': torch.as_tensor(d16.reshape(-1, 3)),
                    't': torch.zeros(res * res, 1)}, rays)
        script = os.path.join(tmp, 'cpu_program.py')
        Path(script).write_text(CPU_PROGRAM)
        env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, script, art, rays, str(res)], cwd=tmp, env=env,
                              capture_output=True, text=True, timeout=SUBPROCESS_DEADLINE_S)
        _check(proc.returncode == 0, f'CPU program: {proc.stdout[-2000:]}{proc.stderr[-2000:]}')
        line = json.loads(proc.stdout.strip().splitlines()[-1])
        _check(line == {'finite': True, 'shape': [res * res, 1], 'port': []},
               f'CPU program: {line}')
        cpu_image = torch.load(rays + '.out').numpy().reshape(res, res, 1)
        f32_view = SuNeRFLoader(BUNDLE, use_fused=False, device=device).render_observer_image(
            **dict(VIEW, resolution=res))
        out['cpu_program'] = dict(seconds=time.perf_counter() - t0,
                                  vs_card_float32=_rel(f32_view.image, cpu_image))
        print(f"[export] g. the CPU program in a process with torch alone: a finite {res}^2 "
              f"frame in {out['cpu_program']['seconds']:.1f} s, no sunerf_tpu module loaded; "
              f"{out['cpu_program']['vs_card_float32']:.2e} of max from the float32 field's "
              f"live frame on the card (reported)", flush=True)
    out['wall_s'] = time.perf_counter() - t_phase
    print(f"[export] {out['wall_s']:.1f} s", flush=True)
    return out


class _Cubes:
    """make_mhd_renderer's loader, over an MHDField made on the card."""

    def __init__(self, field, device):
        from sunerf_tpu_torch.models.mhd_field import MHDFieldLoader
        self.field, self.device, self.data_path = field, device, None
        self.init_params = lambda: MHDFieldLoader.init_params(self)


def _psi_sized_field(device, dtype=torch.float32):
    """Two frames of rho and T at PSI_SHAPE on the card: a corona falling off
    with height on a geometric r grid from 1 to 30 Rs (as MAS's), streamers
    in longitude and latitude."""
    from sunerf_tpu_torch.models.mhd_field import MHDField
    n_phi, n_theta, n_r = PSI_SHAPE
    kw = dict(dtype=dtype, device=device)
    r = torch.logspace(0.0, float(np.log10(30.0)), n_r, **kw)
    th = torch.linspace(0.0, np.pi, n_theta, **kw)
    ph = torch.linspace(0.0, 2 * np.pi, n_phi, **kw)
    P, T, R = (g[None] for g in torch.meshgrid(ph, th, r, indexing='ij'))
    shift = torch.tensor([0.0, 0.3], **kw).reshape(2, 1, 1, 1)
    rho = 1e5 * torch.exp(-(R - 1.0) / 0.15) * (1 + 0.5 * torch.cos(2 * P + shift)
                                                * torch.sin(T) ** 2) + 1e-3 / R ** 2
    temp = 1.0 + 0.6 * torch.sin(T) ** 2 + 0.2 * torch.cos(P - shift) + 0.01 * R
    return MHDField(r_grid=r, theta_grid=th, phi_grid=ph, rho=rho.contiguous(),
                    temperature=temp.contiguous(), ffirst=0, flast=1)


def _mhd_phase(device) -> dict:
    """[mhd]: the PSI fixture through the numpy reader on the card, rendered
    by image_render's MHDModel path; a PSI-sized field; an MHD export."""
    import dataclasses as dc
    import yaml
    from sunerf_tpu_torch.core.geometry import observer_rays
    from sunerf_tpu_torch.data import psi_io
    from sunerf_tpu_torch.data.fits import read_fits
    from sunerf_tpu_torch.evaluation.image_render import build_model_renderer, render_observers
    from sunerf_tpu_torch.evaluation.loader import ModelLoader
    from sunerf_tpu_torch.evaluation.serving import ServingModel, export_serving
    from sunerf_tpu_torch.ops.tresp import TemperatureResponse
    from sunerf_tpu_torch.systems import make_mhd_renderer
    from sunerf_tpu_torch.utils.checkpoint import save_state
    t_phase = time.perf_counter()
    out = {'h5py_here': __import__('importlib').util.find_spec('h5py') is not None}
    # a. the fixture: the reader's arrays are h5py's, the four observers of
    # config/render_mhd.yaml at 256^2 in six channels
    saved = np.load(PSI_FIXTURE + '.npz')
    for f in sorted(Path(PSI_FIXTURE).glob('*/*.h5')):
        key = str(f.relative_to(PSI_FIXTURE))
        scales, data = psi_io.read_hdf(str(f))
        _check(np.array_equal(data, saved[f'{key}/data']) and data.dtype == np.float32
               and all(np.array_equal(s, saved[f'{key}/dim{i}']) for i, s in enumerate(scales)),
               f'PSI reader: {key} differs from its h5py read')
    with open(MHD_CONFIG) as f:
        config = yaml.safe_load(f)
    with tempfile.TemporaryDirectory() as tmp:
        config.update(data_path=PSI_FIXTURE, resolution=MHD_RES, render_path=tmp)
        t0 = time.perf_counter()
        written = render_observers(config, device=device)
        out['fixture_render_s'] = time.perf_counter() - t0
        frames = {}
        for base in written:
            data, _ = read_fits(base + '.fits')
            _check(bool(np.isfinite(data).all()), f'{base}: not finite')
            c, w = MHD_RES // 2, MHD_RES // 16
            disk = float(data[c - w:c + w, c - w:c + w].mean())
            corners = float(np.mean([data[:w, :w], data[:w, -w:], data[-w:, :w],
                                     data[-w:, -w:]]))
            _check(disk > corners, f'{base}: disk {disk:.3e} not above corners {corners:.3e}')
            frames[os.path.relpath(base, tmp)] = dict(max=float(data.max()), disk=disk,
                                                      corners=corners)
        _check(len(frames) == 4 * 6, f'{len(frames)} frames, not 24')
    out['fixture_frames'] = frames
    print(f"[mhd] a. {PSI_FIXTURE} read without h5py (h5py on this host: {out['h5py_here']}), "
          f"the arrays h5py wrote; {len(frames)} frames at {MHD_RES}^2 (4 observers x 6 "
          f"channels) in {out['fixture_render_s']:.1f} s, finite, each disk above its corners "
          f"(disk/corners from {min(r['disk'] / max(r['corners'], 1e-30) for r in frames.values()):.3g})",
          flush=True)

    # b. a field at the size of PSI's MAS cubes, rendered at the defaults
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    field = _psi_sized_field(device)
    out['psi_field_mib'] = (torch.cuda.memory_allocated() - base_mem) / 2**20
    renderer, params = make_mhd_renderer(_Cubes(field, device))
    zeros = torch.zeros(7, device=device)
    params = {k: dict(v, log_abs=zeros) for k, v in params.items()}
    wl = [94.0, 171.0, 193.0, 211.0, 304.0, 335.0]
    loader = ModelLoader(renderer, params, device=device)
    view256 = dict(VIEW, resolution=256)
    view = loader.render_observer_image(**view256, wavelengths=wl)
    _check(bool(np.isfinite(view.image).all()) and view.image.max() > 0,
           'PSI-sized field: frame not finite or black')
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        loader.render_observer_image(**view256, wavelengths=wl)
        times.append((time.perf_counter() - t0) * 1e3)
    out['psi_frame_ms'] = statistics.median(times)
    out['psi_frame_profile'] = _wall_and_device_ms(
        lambda: loader.render_observer_image(**view256, wavelengths=wl))
    out['psi_peak_gib'] = torch.cuda.max_memory_allocated() / 2**30
    # 1,024 rays against the same render in float64 on the card: of the
    # frame's (1 AU, where float32's ray-sphere clip cancels about 5 digits:
    # reported), and of a 5 Rs view (held at MHD_F64_TOL)
    field64 = dc.replace(field, **{k: v.double() for k, v in field.tensors().items()})
    resp = renderer.head.response
    r64, _ = make_mhd_renderer(_Cubes(field64, device), response=TemperatureResponse(
        resp.logte.double(), resp.tresp.double()))
    p64 = {k: {kk: vv.double() for kk, vv in v.items()} for k, v in params.items()}
    wl_t = torch.tensor(wl, device=device).expand(MHD_F64_RAYS, -1)
    t = torch.zeros(MHD_F64_RAYS, 1, device=device)
    out['psi_f32_vs_f64'] = {}
    for distance in (VIEW['distance'], 5.0):
        o, d = observer_rays(VIEW['lat'], VIEW['lon'], distance, 256)
        pick = np.random.default_rng(0).choice(256 * 256, MHD_F64_RAYS, replace=False)
        rays = [torch.as_tensor(x.reshape(-1, 3)[pick], device=device) for x in (o, d)]
        with torch.inference_mode():
            img32 = renderer(params, *rays, t, wavelengths=wl_t)['image']
            img64 = r64(p64, *(x.double() for x in rays), t.double(),
                        wavelengths=wl_t.double())['image']
        out['psi_f32_vs_f64'][distance] = _rel(img64.cpu().numpy(), img32.cpu().numpy())
    _check(out['psi_f32_vs_f64'][5.0] <= MHD_F64_TOL,
           f"PSI-sized field at 5 Rs: float32 vs float64 {out['psi_f32_vs_f64'][5.0]:.3e}")
    del field64, r64, p64
    print(f"[mhd] b. PSI-sized field {PSI_SHAPE} x 2 frames x (rho, T): "
          f"{out['psi_field_mib']:.0f} MiB on the card; 256^2 at 64 + 128 samples in 6 "
          f"channels: {out['psi_frame_ms']:.1f} ms a frame (host clock, median of 3; "
          f"profiled: {out['psi_frame_profile']['device_ms']:.1f} ms of kernels, idle "
          f"{out['psi_frame_profile']['idle_share']:.1%}), peak {out['psi_peak_gib']:.2f} GiB; "
          f"{MHD_F64_RAYS} rays vs float64 on the card: at 215 Rs "
          f"{out['psi_f32_vs_f64'][VIEW['distance']]:.2e} of max (reported), at 5 Rs "
          f"{out['psi_f32_vs_f64'][5.0]:.2e} (tol {MHD_F64_TOL:g})", flush=True)
    del field, renderer, params, loader
    torch.cuda.empty_cache()

    # c. the fixture's MHD spec exported for cuda, one view served against live
    with tempfile.TemporaryDirectory() as tmp:
        renderer, params = build_model_renderer(dict(config, resolution=64), device=device)
        path = os.path.join(tmp, 'mhd')
        save_state(path, params, {'renderer_spec': renderer.spec, 'wavelengths': wl})
        art = os.path.join(tmp, 'mhd.tsrv')
        t0 = time.perf_counter()
        meta = export_serving(path, art, batch_size=EXPORT_BATCH,
                              platforms=(torch.device(device).type,))
        export_s = time.perf_counter() - t0
        _check(not meta['fused_cuda'], 'MHD export carries the K0 op')
        view64 = dict(VIEW, resolution=64)
        served = ServingModel(art, device=device).render_observer_image(**view64)
        live = ModelLoader(renderer, params, device=device).render_observer_image(
            **view64, wavelengths=wl)
        out['export'] = dict(export_s=export_s, artifact_bytes=os.path.getsize(art),
                             served_vs_live=_served_vs('[mhd] c.', served, live))
    print(f"[mhd] c. the fixture's spec exported for cuda (no op) in {export_s:.1f} s, "
          f"{out['export']['artifact_bytes'] / 2**10:.0f} KiB; 64^2 served vs live: " + '; '.join(
              f"{k} {r['max_rel_diff']:.2e} of max" for k, r in
              out['export']['served_vs_live'].items()), flush=True)
    out['wall_s'] = time.perf_counter() - t_phase
    print(f"[mhd] {out['wall_s']:.1f} s", flush=True)
    return out


# ------------------- serving on any card, the converter, prep, the psi_193 protocol

SNF_RES = 256
PREP_RAW, PREP_RES = 512, 256
PREP_VIEWS = 8
PREP_STEPS = 30
PSI_SCORE_RES = 256
PSI_PROTOCOL_STEPS = 100
PSI_PROTOCOL = ('--steps', str(PSI_PROTOCOL_STEPS), '--resolution', '128')   # 8x512, 64 + 128
PSI_JAX_ROW = 'BUNDLE_SCORES_r5.jsonl'
# Where K0 runs the trained bundle over millions of samples, single bf16
# flips move a few points beyond KERNEL_MAX_TOL of the plain version, while
# K0 and the plain version stay equally far from the float32 field (PERF.md).
# [snf] holds p99.99 and RMS as the point check does, and bounds K0's own
# outliers by count: the points beyond KERNEL_TOL and beyond KERNEL_MAX_TOL
# of max from the plain version, each limit set from the H100 readings in
# PERF.md (a fault in one tail tile of one chunk moves more points than that).
SNF_POINTS_OVER_TOL = 128
SNF_POINTS_OVER_MAX = 16
# [psi] holds each view's K0 render against the plain version's: raw, at
# p99.99 KERNEL_TOL and max KERNEL_MAX_TOL of max as the point check does,
# and RMS within PSI_RENDER_RMS_TOL of the plain render's RMS; asinh-scaled,
# as the metrics read it, at RMS PSI_SCALED_RMS_TOL (absolute: the scaled
# images span about 0..1). Both RMS limits are twice the worst of the 18
# views on an H100 (PERF.md). The score bounds follow from the scaled limit.
PSI_RENDER_RMS_TOL = 4e-3
PSI_SCALED_RMS_TOL = 6e-4
# the self-check: the fine field's K0 output on this chunk of one view
# reversed, which the view check must refuse
PSI_FAULT_CHUNK = 8


def _serve_cards_phase(device, live_view) -> dict:
    """[serve_cards]: the one-device artifact loaded through ServingModel's
    device mapping on cuda:0 and, with more than one card, on the last card:
    the live frame's bits, K0's launches on that card by kernel name."""
    from sunerf_tpu_torch.evaluation.serving import ServingModel, export_serving
    from sunerf_tpu_torch.scripts.serve_cards import frame_ms, k0_launches
    t0 = time.perf_counter()
    out = {}
    view256 = dict(VIEW, resolution=256)
    with tempfile.TemporaryDirectory() as tmp:
        art = os.path.join(tmp, 'bundle.tsrv')
        export_serving(BUNDLE, art, batch_size=EXPORT_BATCH, platforms=('cuda',))
        cards = [0] + ([torch.cuda.device_count() - 1] if torch.cuda.device_count() > 1 else [])
        for k in cards:
            model = ServingModel(art, device=f'cuda:{k}')
            _check(model.device == torch.device('cuda', k), f'served on {model.device}, not cuda:{k}')
            frames = {}

            def render():
                frames['view'] = model.render_observer_image(**view256)
            ms = frame_ms(render, 4)
            launches = k0_launches(render, model.device)
            same = {m: bool(np.array_equal(getattr(frames['view'], m), getattr(live_view, m)))
                    for m in MAPS}
            out[f'cuda:{k}'] = dict(ms=ms, k0_launches=launches, same_bits=same)
            _check(all(same.values()), f'[serve_cards] cuda:{k}: not the live frame\'s bits {same}')
            _check(launches == 32, f'[serve_cards] cuda:{k}: {launches} K0 launches, not 32')
            print(f'[serve_cards] the one-device artifact on cuda:{k} (its program mapped onto '
                  f'the card): the live frame\'s bits in every map, {launches} K0 launches on '
                  f'cuda:{k} by kernel name, {ms:.1f} ms (host clock, median of 4)', flush=True)
            del model
    if len(cards) == 1:
        print('[serve_cards] one card here: the cross-card check (the artifact on the last card, '
              'the sharded artifact over 2 and 4 NCCL ranks) runs in '
              'sunerf_tpu_torch/scripts/serve_cards.py on a four-card host', flush=True)
    out['wall_s'] = time.perf_counter() - t0
    print(f"[serve_cards] {out['wall_s']:.1f} s", flush=True)
    return out


# reference-shaped modules for [snf]: the classes a reference save_state.snf
# pickles (sunerf.model.model's NeRF and its parts, the rendering module),
# pickled under those names and unpickled by the converter's stub modules
class _RefSine(torch.nn.Module):
    def forward(self, x):
        return torch.sin(x)


class _RefPositionalEncoding(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.register_buffer('freq_bands', 2.0 ** torch.linspace(0., 9., 10))


class _RefNeRF(torch.nn.Module):
    def __init__(self, n_layers, width, d_output=2):
        super().__init__()
        self.in_layer = torch.nn.Sequential(_RefPositionalEncoding(), torch.nn.Linear(84, width))
        self.layers = torch.nn.ModuleList([torch.nn.Linear(width, width)
                                           for _ in range(n_layers - 1)])
        self.out_layer = torch.nn.Linear(width, d_output)
        self.act = _RefSine()


class _RefRendering(torch.nn.Module):
    def __init__(self, fine, coarse):
        super().__init__()
        self.coarse_model = coarse
        self.fine_model = fine


_REF_NAMES = {_RefSine: ('sunerf.model.model', 'Sine'),
              _RefPositionalEncoding: ('sunerf.model.model', 'PositionalEncoding'),
              _RefNeRF: ('sunerf.model.model', 'NeRF'),
              _RefRendering: ('sunerf.rendering.emission', 'EmissionRadiativeTransfer')}


def _drop_reference_modules():
    for name in [m for m in sys.modules if m == 'sunerf' or m.startswith('sunerf.')]:
        del sys.modules[name]


def _write_reference_snf(path: str, params: dict, spec: dict):
    """A reference-style save_state.snf whose fine and coarse NeRFs hold the
    bundle's fields ([out, in] weights, as torch.nn.Linear keeps them)."""
    import types
    fields = {}
    for key, mc in (('fine', spec['model_config']), ('coarse', spec['coarse_model_config'])):
        module, p = _RefNeRF(mc['n_layers'], mc['d_filter'], mc['d_output']), params[key]
        with torch.no_grad():
            module.in_layer[1].weight.copy_(torch.as_tensor(p['w_in'].T))
            module.in_layer[1].bias.copy_(torch.as_tensor(p['b_in']))
            for i, layer in enumerate(module.layers):
                layer.weight.copy_(torch.as_tensor(p['w_h'][i].T))
                layer.bias.copy_(torch.as_tensor(p['b_h'][i]))
            module.out_layer.weight.copy_(torch.as_tensor(p['w_out'].T))
            module.out_layer.bias.copy_(torch.as_tensor(p['b_out']))
        fields[key] = module
    _drop_reference_modules()
    saved = {cls: (cls.__module__, cls.__qualname__) for cls in _REF_NAMES}
    try:
        for cls, (mod, name) in _REF_NAMES.items():
            parts = mod.split('.')
            for i in range(1, len(parts) + 1):
                dotted = '.'.join(parts[:i])
                sys.modules.setdefault(dotted, types.ModuleType(dotted))
                if i > 1:
                    setattr(sys.modules['.'.join(parts[:i - 1])], parts[i - 1],
                            sys.modules[dotted])
            setattr(sys.modules[mod], name, cls)
            cls.__module__, cls.__qualname__ = mod, name
        torch.save({'rendering': _RefRendering(fields['fine'], fields['coarse']),
                    'Rs_per_ds': 1.0, 'seconds_per_dt': 86400.0,
                    'ref_time': '2012-08-23T00:00:00'}, path)
    finally:
        for cls, (mod, name) in saved.items():
            cls.__module__, cls.__qualname__ = mod, name
        _drop_reference_modules()


def _snf_phase(device) -> dict:
    """[snf]: a reference save_state.snf holding the committed bundle's
    fields, converted by the port's CLI: the bundle's parameters bit for bit;
    its 256^2 frame at the converter's render spec on K0 against the plain
    version (RENDER_TOL, K0's point check)."""
    from sunerf_tpu_torch.core.geometry import observer_rays
    from sunerf_tpu_torch.evaluation.loader import ModelLoader, SuNeRFLoader
    from sunerf_tpu_torch.models.fields import FieldOutput, NeRFConfig, nerf_apply
    from sunerf_tpu_torch.ops import fused_mlp
    from sunerf_tpu_torch.systems import from_spec
    from sunerf_tpu_torch.utils import snf_converter
    from sunerf_tpu_torch.utils.checkpoint import load_state
    t_phase = time.perf_counter()
    params, config = load_state(BUNDLE)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        snf = os.path.join(tmp, 'save_state.snf')
        _write_reference_snf(snf, params, config['renderer_spec'])
        converted = os.path.join(tmp, 'converted')
        t0 = time.perf_counter()
        snf_converter.main(['--snf', snf, '--out', converted])
        out['convert_s'] = time.perf_counter() - t0
        _drop_reference_modules()
        got, got_config = load_state(converted)
        for key in ('fine', 'coarse'):
            _check(got[key].keys() == params[key].keys(), f'[snf] {key} keys {sorted(got[key])}')
            for k, v in params[key].items():
                _check(got[key][k].dtype == v.dtype and np.array_equal(got[key][k], v),
                       f'[snf] converted {key}.{k} is not the bundle\'s')
        spec = got_config['renderer_spec']
        fine_cfg = NeRFConfig(**spec['model_config'])
        coarse_cfg = NeRFConfig(**spec['coarse_model_config'])
        loader = SuNeRFLoader(converted, device=device)
        render = loader.renderer
        view = dict(VIEW, resolution=SNF_RES)
        loader.render_observer_image(**view)
        torch.cuda.synchronize()
        fused_mlp.LAUNCHES = 0
        frame = loader.render_observer_image(**view)
        out['k0_launches'] = fused_mlp.LAUNCHES
        n_chunks = SNF_RES * SNF_RES // loader.batch_size
        _check(out['k0_launches'] == 2 * n_chunks,
               f"[snf] {out['k0_launches']} K0 launches, not {2 * n_chunks}")
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            loader.render_observer_image(**view)
            times.append((time.perf_counter() - t0) * 1e3)
        out['frame_ms'] = statistics.median(times)

        def plain(cfg):
            return lambda p, x: FieldOutput(raw=fused_mlp.fused_mlp_reference(cfg, p, x))
        base, _ = from_spec(spec, use_fused=False, device=device)
        plain_renderer = dataclasses.replace(base, field_apply=plain(fine_cfg),
                                             coarse_field_apply=plain(coarse_cfg))
        plain_frame = ModelLoader(plain_renderer, loader.params,
                                  device=device).render_observer_image(**view)
        out['vs_plain'] = {k: _rel(getattr(plain_frame, k), getattr(frame, k)) for k in MAPS}
        for k in MAPS:
            _check(bool(np.isfinite(getattr(frame, k)).all()), f'[snf] {k} not finite')
        _check(out['vs_plain']['image'] <= RENDER_TOL,
               f"[snf] image {out['vs_plain']['image']:.3e} of max from the plain version")
        o, d = observer_rays(VIEW['lat'], VIEW['lon'], VIEW['distance'], SNF_RES)
        arrays = {'rays': torch.as_tensor(np.stack([o.reshape(-1, 3), d.reshape(-1, 3)], 1),
                                          device=device),
                  'time': torch.zeros(SNF_RES * SNF_RES, 1, device=device)}
        chunks = _fine_points(render, loader.params, arrays, loader.batch_size)
        k0, ref = _k0_on_points(fine_cfg, loader.params['fine'], chunks)
        with torch.inference_mode():
            f32 = torch.cat([nerf_apply(fine_cfg, loader.params['fine'], x).raw for x in chunks])
        err = out['k0_fine_samples'] = _err_stats(ref, k0)
        out['k0_vs_f32'], out['plain_vs_f32'] = _err_stats(f32, k0), _err_stats(f32, ref)
        print(f"[snf] K0 vs plain at the frame's {k0.shape[0]} fine samples: {_fmt(err)}; against "
              f"the float32 field K0 {_fmt(out['k0_vs_f32'])}, plain {_fmt(out['plain_vs_f32'])}",
              flush=True)
        _check(err['p9999_rel_err'] <= KERNEL_TOL and err['rms_rel_err'] <= KERNEL_RMS_TOL
               and err['points_over_tol'] <= SNF_POINTS_OVER_TOL
               and err['points_over_max'] <= SNF_POINTS_OVER_MAX,
               f"[snf] K0 vs plain {_fmt(err)} (tol p99.99 {KERNEL_TOL}, rms {KERNEL_RMS_TOL}, "
               f"at most {SNF_POINTS_OVER_TOL} points beyond {KERNEL_TOL:g} and "
               f"{SNF_POINTS_OVER_MAX} beyond {KERNEL_MAX_TOL:g})")
    out['render'] = spec.get('render')
    out['wall_s'] = time.perf_counter() - t_phase
    print(f"[snf] a reference save_state.snf (8x512 fine, 4x128 coarse: the committed "
          f"bundle's fields) converted in {out['convert_s']:.2f} s: the bundle's parameters bit "
          f"for bit; {SNF_RES}^2 at the converter's render spec ({out['render'] or 'the '
          'renderer defaults, 64 + 128'}): {out['k0_launches']} K0 launches, "
          f"{out['frame_ms']:.1f} ms (host clock, median of 3); vs the plain version " + '; '.join(
              f'{k} {v:.3e}' for k, v in out['vs_plain'].items())
          + f" (tol {RENDER_TOL} on the image); {out['wall_s']:.1f} s", flush=True)
    return out


def _raw_disk(rng, res: int, value: float) -> np.ndarray:
    """A limb-brightened disk of 1 solar radius on a res^2 frame of
    observer_header's field of view (+-1.3 Rs at the observer's distance),
    with seeded blobs and noise."""
    half = 1.3
    y, x = (np.mgrid[:res, :res] + 0.5) / res * 2 * half - half
    r = np.hypot(x, y)
    disk = np.where(r < 1.0, 1.0 / np.sqrt(np.clip(1.0 - r * r, 0.05, None)), 0.0)
    corona = np.exp(-np.clip(r - 1.0, 0.0, None) / 0.08) * (r >= 1.0)
    for _ in range(6):
        cx, cy = rng.uniform(-0.8, 0.8, 2)
        disk += 2.0 * np.exp(-((x - cx) ** 2 + (y - cy) ** 2) / 0.01) * (r < 1.0)
    img = value * (disk + corona) / 4.0 + rng.normal(0, value * 0.002, (res, res))
    return img.astype(np.float32)


def _prep_phase(device) -> dict:
    """[prep]: raw 512^2 SDO-style (193 A) and STEREO-style (195 A) FITS from
    a seed, prepped to 256^2 (the default degradation table, scipy's zoom),
    aligned, loaded through load_map_stack, and run_emission at 8x512 for a
    few steps on the prepped SDO views (K1 + K2)."""
    import glob
    from datetime import datetime, timedelta
    from sunerf_tpu_torch.data import prep as prep_mod
    from sunerf_tpu_torch.data.align import align_directories
    from sunerf_tpu_torch.data.fits import Header, read_fits, write_fits
    from sunerf_tpu_torch.data.loaders import load_map_stack
    from sunerf_tpu_torch.data.wcs import observer_header
    import scipy
    t_phase = time.perf_counter()
    rng = np.random.default_rng(16)
    out = {'scipy': scipy.__version__}
    with tempfile.TemporaryDirectory() as tmp:
        raw = {'sdo': os.path.join(tmp, 'raw', 'aia193'), 'stereo': os.path.join(tmp, 'raw',
                                                                                'euvi195')}
        for d in raw.values():
            os.makedirs(d)
        start = datetime(2012, 8, 23)
        for i in range(PREP_VIEWS):
            when = start + timedelta(hours=6 * i)
            stamp = when.strftime('%Y-%m-%dT%H:%M:%S')
            for instrument, wl, lon, dist in (('sdo', 193, 45.0 * i, 215.0),
                                              ('stereo', 195, 45.0 * i + 120.0, 206.0)):
                header = Header()
                header.update(observer_header(2.0 * ((i % 3) - 1), lon, dist, when, PREP_RAW,
                                              float(wl)))
                header.update({'T_OBS': stamp + '.000', 'QUALITY': 0, 'EXPTIME': 2.0})
                write_fits(os.path.join(raw[instrument], f'{instrument}_{stamp}.{wl}.fits'),
                           _raw_disk(rng, PREP_RAW, 9000.0), header)
        prepped = {k: os.path.join(tmp, 'prep', k) for k in raw}
        t0 = time.perf_counter()
        counts = {}
        for instrument, d in raw.items():
            files = sorted(glob.glob(os.path.join(d, '*.fits')))
            counts[instrument] = sum(prep_mod.prep_file(f, prepped[instrument], instrument,
                                                        resolution=PREP_RES) is not None
                                     for f in files)
        out['prep_s'] = time.perf_counter() - t0
        _check(counts == {'sdo': PREP_VIEWS, 'stereo': PREP_VIEWS}, f'[prep] prepped {counts}')
        data, header = read_fits(sorted(glob.glob(os.path.join(prepped['sdo'], '*.fits')))[0])
        _check(data.shape == (PREP_RES, PREP_RES) and header['NAXIS1'] == PREP_RES
               and abs(header['CDELT1'] * PREP_RES / PREP_RAW
                       - observer_header(0.0, 0.0, 215.0, start, PREP_RAW,
                                         193.0)['CDELT1']) < 1e-9,
               f'[prep] prepped frame {data.shape}, CDELT1 {header["CDELT1"]}')
        aligned = align_directories(list(prepped.values()), os.path.join(tmp, 'aligned'))
        _check(len(aligned) == PREP_VIEWS, f'[prep] aligned {len(aligned)} timestamps')
        files = [f for group in aligned.values() for f in group]
        stack = load_map_stack(files, resolution=PREP_RES)
        raw_files = sorted(glob.glob(os.path.join(raw['sdo'], '*.fits')))
        t0 = time.perf_counter()
        resampled = load_map_stack(raw_files, resolution=PREP_RES, apply_norm=True)
        out['load_resample_s'] = time.perf_counter() - t0
        _check(stack.shape == (2 * PREP_VIEWS, PREP_RES, PREP_RES)
               and resampled.shape == (PREP_VIEWS, PREP_RES, PREP_RES)
               and np.isfinite(stack).all() and np.isfinite(resampled).all(),
               f'[prep] stacks {stack.shape} {resampled.shape}')
        workdir = os.path.join(tmp, 'run')
        config = {'path_to_save': workdir,
                  'data': {'data_path': os.path.join(prepped['sdo'], '*.fits'),
                           'batch_size': TRAINER_BATCH},
                  'training': {'total_steps': PREP_STEPS, 'log_every_n_steps': PREP_STEPS,
                               'scalar_log_every': 10, 'drift_probe_views': 0}}
        _zero_counters()
        t0 = time.perf_counter()
        _run_cli(config, os.path.join(tmp, 'prep.yaml'), device)
        out['run_s'] = time.perf_counter() - t0
        out['launches'] = _counters()
        recs = [json.loads(line) for line in open(os.path.join(workdir, 'metrics.jsonl'))]
        steps = [r for r in recs if 'loss' in r]
        out['losses'] = [r['loss'] for r in steps]
        window = [r for r in steps if r['step'] > 10]
        out['ms_per_step'] = statistics.mean(r['step_ms'] for r in window)
        _check(out['launches'].get('STASH_FWD_LAUNCHES') == 2 * PREP_STEPS
               and out['launches'].get('STASH_BWD_LAUNCHES') == 2 * PREP_STEPS,
               f"[prep] launches {out['launches']}: not 2 K1 and 2 K2 a step")
        _check(all(np.isfinite(out['losses'])), f"[prep] losses {out['losses']}")
    out['wall_s'] = time.perf_counter() - t_phase
    print(f"[prep] {PREP_VIEWS} SDO-style 193 A and {PREP_VIEWS} STEREO-style 195 A raw "
          f"{PREP_RAW}^2 FITS prepped to {PREP_RES}^2 (the default degradation table, scipy "
          f"{out['scipy']}'s zoom) in {out['prep_s']:.2f} s; aligned {PREP_VIEWS} timestamps; "
          f"load_map_stack of the raw SDO frames resampled to {PREP_RES}^2 in "
          f"{out['load_resample_s']:.2f} s; run_emission 8x512, 64 + 128, batch "
          f"{TRAINER_BATCH} on the prepped views, {PREP_STEPS} steps: {out['ms_per_step']:.2f} "
          f"ms/step over steps 11-{PREP_STEPS} (host clock), launches {out['launches']}, losses "
          + ' '.join(f'{v:.5f}' for v in out['losses']) + f"; {out['wall_s']:.1f} s", flush=True)
    return out


def _scaled(image: np.ndarray) -> np.ndarray:
    from sunerf_tpu_torch.core.scaling import image_asinh_scaling
    return image_asinh_scaling(torch.from_numpy(np.asarray(image, np.float32))).numpy().astype(
        np.float64)


def _view_check(k_img: np.ndarray, p_img: np.ndarray, rms_tol: float = PSI_RENDER_RMS_TOL,
                scaled_tol: float = PSI_SCALED_RMS_TOL) -> tuple:
    """One view's K0 render against its plain render: the raw per-pixel
    statistics (fractions of max, as _err_stats), the asinh-scaled RMS, and
    the list of criteria it fails (empty when it passes)."""
    err = _err_stats(torch.as_tensor(p_img).reshape(-1, 1), torch.as_tensor(k_img).reshape(-1, 1))
    stats = dict(err, scaled_rms=float(np.sqrt(np.mean((_scaled(k_img) - _scaled(p_img)) ** 2))))
    faults = [name for name, ok in (
        (f'p99.99 > {KERNEL_TOL}', err['p9999_rel_err'] <= KERNEL_TOL),
        (f'rms > {rms_tol}', err['rms_rel_err'] <= rms_tol),
        (f'max > {KERNEL_MAX_TOL}', err['max_rel_err'] <= KERNEL_MAX_TOL),
        (f'scaled rms > {scaled_tol}', stats['scaled_rms'] <= scaled_tol))
        if not ok]
    return stats, faults


def _ssim_gap_bound(x: np.ndarray, y: np.ndarray, tau: float, win: int = 7,
                    k1: float = 0.01, k2: float = 0.03) -> float:
    """A bound on |ssim(x + e, y) - ssim(x, y)| (train.metrics.ssim, its
    data range from y) over every e with RMS(e) <= tau. A pixel lies in at
    most win^2 windows, so the RMS rho_w of e over a window w is at most
    r = tau sqrt(n) / win, and sum_w rho_w^2 <= B = n tau^2. Over w, the
    mean moves by <= rho_w, the variance by <= 2 sqrt(cn vx) rho_w +
    cn rho_w^2, the covariance by <= sqrt(cn vy) rho_w; the luminance
    term's derivative in the mean, bounded over +-rho_w, and the
    contrast-structure quotient (its moved denominator at least
    max(den - the variance's move at r, vy + C2), a variance being >= 0)
    then move the window's SSIM by at most min(2, p_w rho_w + q_w rho_w^2),
    the coefficients bounded over the radius r. For any
    lam > 0, p rho <= lam rho^2 + p^2 / (4 lam), so the sum over windows is
    at most sum_w min(2, p_w^2 / (4 lam)) plus the most that
    sum_w min(2, (lam + q_w) rho_w^2) can take under the budget B: a
    fractional knapsack, the steepest windows filled first. The least of
    that over a range of lam, over the number of windows."""
    from sunerf_tpu_torch.train.metrics import _uniform_filter_2d
    x, y = np.asarray(x, np.float64), np.asarray(y, np.float64)
    d = float(y.max() - y.min()) or 1.0
    c1, c2 = (k1 * d) ** 2, (k2 * d) ** 2
    cn = win * win / (win * win - 1)
    budget = x.size * tau * tau
    r = np.sqrt(budget) / win
    ux, uy = _uniform_filter_2d(x, win), _uniform_filter_2d(y, win)
    vx = np.maximum(cn * (_uniform_filter_2d(x * x, win) - ux * ux), 0.0)
    vy = np.maximum(cn * (_uniform_filter_2d(y * y, win) - uy * uy), 0.0)
    cxy = cn * (_uniform_filter_2d(x * y, win) - ux * uy)
    lum = np.abs((2 * ux * uy + c1) / (ux ** 2 + uy ** 2 + c1))
    # luminance: |f(a + h) - f(a)| <= 2 (|b - a| + |h|) |h| top / bottom^2
    top = uy ** 2 + np.abs(uy) * (np.abs(ux) + r) + c1
    bottom = np.maximum(np.abs(ux) - r, 0.0) ** 2 + uy ** 2 + c1
    # contrast-structure: (2 dc den - (2c + C2) dv) / (den den'), den' >= den_lo
    den = vx + vy + c2
    sx = 2 * np.sqrt(cn * vx)
    inv = 1.0 / (den * np.maximum(den - sx * r - cn * r * r, vy + c2))
    p = (2 * np.abs(uy - ux) * top / bottom ** 2
         + lum * (2 * np.sqrt(cn * vy) * den + np.abs(2 * cxy + c2) * sx) * inv).ravel()
    q = (2 * top / bottom ** 2 + lum * np.abs(2 * cxy + c2) * cn * inv).ravel()
    best = float('inf')
    for lam in np.logspace(-2, 10, 49):
        steep = np.sort(lam + q)[::-1]
        cost = np.minimum(2.0 / steep, r * r)       # rho^2 that takes a window to its most
        spent = np.cumsum(cost)
        full = int(np.searchsorted(spent, budget, side='right'))
        gain = float(np.sum(np.minimum(2.0, steep[:full] * cost[:full])))
        if full < steep.size:
            left = budget - (spent[full - 1] if full else 0.0)
            gain += min(2.0, steep[full] * left)
        best = min(best, float(np.sum(np.minimum(2.0, p * p / (4 * lam)))) + gain)
    return min(2.0, best / p.size)


def _score_bounds(p_img: np.ndarray, data: np.ndarray) -> dict:
    """How far each metric of a view can move from the plain render's score
    when the scaled render moves by at most tau = PSI_SCALED_RMS_TOL in RMS
    (the view check's limit): RMSE moves by at most tau, so |dPSNR| <=
    -20 log10(1 - tau / rmse_plain); mean|de| <= tau, so |dMAE%|, |dME%| <=
    100 tau / mean|s_truth|; SSIM as _ssim_gap_bound. Computed from the
    plain render and the truth only."""
    sp, st = _scaled(p_img), _scaled(data)
    tau = PSI_SCALED_RMS_TOL
    rmse = float(np.sqrt(np.mean((sp - st) ** 2)))
    mae = 100 * tau / (float(np.mean(np.abs(st))) + 1e-12)
    return {'psnr': -20 * np.log10(1 - tau / rmse) if tau < rmse else float('inf'),
            'ssim': _ssim_gap_bound(sp, st, tau), 'mae_percent': mae, 'me_percent': mae}


def _psi_phase(device, plain_renderer) -> dict:
    """[psi]: the psi_193 scene at 256^2 (cubes written without h5py), the
    committed bundle scored by score_bundle on K0 and through the plain
    version, and the protocol's training at 8x512 for PSI_PROTOCOL_STEPS
    steps at 128^2 (K1 + K2)."""
    import glob
    from sunerf_tpu_torch.data import psi_io
    from sunerf_tpu_torch.data.fits import read_fits
    from sunerf_tpu_torch.data.wcs import parse_observer
    from sunerf_tpu_torch.evaluation.loader import ModelLoader, SuNeRFLoader
    from sunerf_tpu_torch.evaluation.metrics_harness import view_metrics
    from sunerf_tpu_torch.ops import fused_mlp
    from sunerf_tpu_torch.scripts import psi_protocol, score_bundle
    t_phase = time.perf_counter()
    out = {'h5py': psi_io.h5py is not None}
    with tempfile.TemporaryDirectory() as tmp:
        scene = os.path.join(tmp, f'scene{PSI_SCORE_RES}')
        t0 = time.perf_counter()
        train_dir, gt_dir = psi_protocol.ensure_scene(scene, PSI_SCORE_RES, device=device)
        out['scene_s'] = time.perf_counter() - t0
        n_train = len(glob.glob(os.path.join(train_dir, '*.fits')))
        gt_files = sorted(glob.glob(os.path.join(gt_dir, '*.fits')))
        _check(n_train == 14 and len(gt_files) == 18,
               f'[psi] the scene has {n_train} train and {len(gt_files)} ground-truth views')
        _check(psi_io.read_hdf(os.path.join(scene, 'cubes', 'rho', 'rho00100.h5'))[1].shape
               == (64, 32, 24), '[psi] the rho cube does not read back')
        print(f"[psi] ensure_scene at {PSI_SCORE_RES}^2: {out['scene_s']:.1f} s, {n_train} train "
              f"and {len(gt_files)} ground-truth views; cubes written "
              f"by the numpy HDF5 writer (h5py {'present' if out['h5py'] else 'absent'} here)", flush=True)

        # the committed bundle scored on K0 (score_bundle) and through the plain version
        _zero_counters()
        t0 = time.perf_counter()
        k0_row = score_bundle.main(['--bundle', BUNDLE + '.npz', '--resolution',
                                    str(PSI_SCORE_RES), '--data-cache', scene, '--label',
                                    'chip_smoke', '--device', str(device)])
        out['score_s'] = time.perf_counter() - t0
        out['score_k0_launches'] = fused_mlp.LAUNCHES
        n_chunks = PSI_SCORE_RES * PSI_SCORE_RES // 4096
        _check(out['score_k0_launches'] == 2 * n_chunks * len(gt_files),
               f"[psi] score_bundle launched K0 {out['score_k0_launches']} times, not "
               f"{2 * n_chunks * len(gt_files)}")
        k0_loader = SuNeRFLoader(BUNDLE, device=device)
        plain_loader = ModelLoader(plain_renderer, k0_loader.params, ref_time=k0_loader.ref_time,
                                   seconds_per_dt=k0_loader.seconds_per_dt, device=device)
        # per view: the K0 and plain renders' metrics, the view check, and
        # each metric's bound from the view check's tolerances
        views = []
        for path in gt_files:
            data, header = read_fits(path)
            obs = parse_observer(header)
            kw = dict(lat=obs.carrington_lat, lon=obs.carrington_lon, time=obs.time,
                      distance=obs.dsun_rs, resolution=data.shape[0],
                      wavelengths=[obs.wavelength])
            k_img = k0_loader.render_observer_image(**kw).image[:, :, 0]
            p_img = plain_loader.render_observer_image(**kw).image[:, :, 0]
            stats, faults = _view_check(k_img, p_img)
            _check(not faults, f"[psi] {os.path.basename(path)}: K0 render vs the plain "
                               f"version's: {', '.join(faults)} ({_fmt(stats)}, scaled rms "
                               f"{stats['scaled_rms']:.3e})")
            views.append(dict(lat=float(np.rad2deg(obs.carrington_lat)), check=stats,
                              k0=view_metrics(k_img, data), plain=view_metrics(p_img, data),
                              bound=_score_bounds(p_img, data)))
        out['views'] = [{k: v[k] for k in ('lat', 'check', 'bound')} for v in views]
        print('[psi] each view, K0 vs the plain version (raw: max, p99.99 of max, rms of rms; '
              'scaled: rms): ' + '; '.join(
                  f"{c['max_rel_err']:.2e} {c['p9999_rel_err']:.2e} {c['rms_rel_err']:.2e} / "
                  f"{c['scaled_rms']:.2e}"
                  for c in (v['check'] for v in views)), flush=True)

        # the view check's own power: the fine field's K0 output reversed on
        # one chunk of the first view must fail it
        calls = [0]

        def faulty(p, x):
            o = k0_loader.renderer.field_apply(p, x)
            calls[0] += 1
            return o._replace(raw=o.raw.flip(0)) if calls[0] == PSI_FAULT_CHUNK + 1 else o
        data, header = read_fits(gt_files[0])
        obs = parse_observer(header)
        bad = ModelLoader(dataclasses.replace(k0_loader.renderer, field_apply=faulty),
                          k0_loader.params, ref_time=k0_loader.ref_time,
                          seconds_per_dt=k0_loader.seconds_per_dt, device=device)
        kw = dict(lat=obs.carrington_lat, lon=obs.carrington_lon, time=obs.time,
                  distance=obs.dsun_rs, resolution=data.shape[0], wavelengths=[obs.wavelength])
        stats, out['fault_flags'] = _view_check(bad.render_observer_image(**kw).image[:, :, 0],
                                                plain_loader.render_observer_image(**kw).image[:, :, 0])
        _check(calls[0] > PSI_FAULT_CHUNK and out['fault_flags'],
               f'[psi] a reversed K0 chunk passed the view check ({_fmt(stats)})')
        print(f"[psi] self-check: the fine K0 output reversed on chunk {PSI_FAULT_CHUNK} of "
              f"{os.path.basename(gt_files[0])} fails the view check: "
              f"{', '.join(out['fault_flags'])} ({_fmt(stats)}, scaled rms "
              f"{stats['scaled_rms']:.3e})", flush=True)

        splits = {'train': [v for v in views if abs(v['lat']) <= 7.0],
                  'test': [v for v in views if abs(v['lat']) > 7.0]}
        out['scores'] = {}
        for split, vs in splits.items():
            mean = lambda key, m: float(np.mean([v[key][m] for v in vs]))  # noqa: E731
            row = {m: dict(k0=mean('k0', m), plain=mean('plain', m), bound=mean('bound', m))
                   for m in ('psnr', 'ssim', 'mae_percent', 'me_percent')}
            for m, r in row.items():
                _check(abs(r['k0'] - r['plain']) <= r['bound'],
                       f"[psi] {split} {m}: K0 {r['k0']:.6g} vs plain {r['plain']:.6g} beyond "
                       f"the bound {r['bound']:.3g}")
                _check(abs(r['k0'] - k0_row[split][m]) <= 1e-9 * max(1.0, abs(r['k0'])),
                       f"[psi] score_bundle {split} {m} {k0_row[split][m]} is not the K0 "
                       f"renders' {r['k0']}")
            out['scores'][split] = row
        with open(PSI_JAX_ROW) as f:
            jax_row = json.loads(f.readline())
        out['jax_recorded'] = {s: jax_row[s] for s in ('train', 'test')}
        out['jax_label'] = jax_row['label']
        for split in ('train', 'test'):
            r = out['scores'][split]
            print(f"[psi] the committed bundle, {split} ({len(splits[split])} views, "
                  f"{PSI_SCORE_RES}^2): K0 PSNR {r['psnr']['k0']:.3f} dB, SSIM "
                  f"{r['ssim']['k0']:.4f}, MAE {r['mae_percent']['k0']:.3f}%, ME "
                  f"{r['me_percent']['k0']:.3f}%; plain version PSNR {r['psnr']['plain']:.3f}, "
                  f"SSIM {r['ssim']['plain']:.4f}, MAE {r['mae_percent']['plain']:.3f}%, ME "
                  f"{r['me_percent']['plain']:.3f}% (bounds from the view check: PSNR "
                  f"{r['psnr']['bound']:.3f} dB, SSIM {r['ssim']['bound']:.4f}, MAE / ME "
                  f"{r['mae_percent']['bound']:.3f} points); the JAX package's recorded "
                  f"row ({jax_row['label']}): PSNR {jax_row[split]['psnr']:.3f}, SSIM "
                  f"{jax_row[split]['ssim']:.4f}, MAE {jax_row[split]['mae_percent']:.3f}%, ME "
                  f"{jax_row[split]['me_percent']:.3f}% (a reference, not a check)", flush=True)
        print(f"[psi] score_bundle on K0: {out['score_s']:.1f} s, {out['score_k0_launches']} K0 "
              f'launches ({len(gt_files)} views x {n_chunks} chunks x 2 fields)', flush=True)
        del k0_loader, plain_loader, bad

        # the protocol's training at 8x512, 64 + 128 samples, 128^2
        workdir = os.path.join(tmp, 'protocol')
        _zero_counters()
        t0 = time.perf_counter()
        row = psi_protocol.main([*PSI_PROTOCOL, '--device', str(device), '--workdir', workdir,
                                 '--data-cache', os.path.join(tmp, 'scene128')])
        out['protocol_s'] = time.perf_counter() - t0
        out['protocol_launches'] = _counters()
        recs = [json.loads(line) for line in open(os.path.join(workdir, 'run', 'metrics.jsonl'))]
        steps = [r for r in recs if 'loss' in r]
        out['protocol_losses'] = [r['loss'] for r in steps]
        out['protocol_ms_per_step'] = statistics.mean(r['step_ms'] for r in steps[1:])
        out['protocol_row'] = row
        _check(out['protocol_launches'].get('STASH_FWD_LAUNCHES') == 2 * PSI_PROTOCOL_STEPS
               and out['protocol_launches'].get('STASH_BWD_LAUNCHES') == 2 * PSI_PROTOCOL_STEPS,
               f"[psi] protocol launches {out['protocol_launches']}: not 2 K1 and 2 K2 a step")
        _check(all(np.isfinite(out['protocol_losses']))
               and out['protocol_losses'][-1] < out['protocol_losses'][0],
               f"[psi] protocol loss did not fall: {out['protocol_losses']}")
        _check(all(np.isfinite(v) for s in ('train', 'test') for v in row[s].values()),
               f'[psi] protocol scores {row}')
        print(f"[psi] psi_protocol {' '.join(PSI_PROTOCOL)} (8x512, 64 + 128, batch 1024): "
              f"{out['protocol_s']:.1f} s; launches {out['protocol_launches']}; losses "
              + ' '.join(f"{r['step']}:{r['loss']:.5f}" for r in steps)
              + f"; {out['protocol_ms_per_step']:.2f} ms/step (logged windows after the first); "
              f"effective {row['effective_rays_per_sec']:.0f} rays/s (utils.throughput), median "
              f"window {row['rays_per_sec']:.0f}; train PSNR {row['train']['psnr']:.3f} dB, test "
              f"{row['test']['psnr']:.3f} dB", flush=True)
    out['wall_s'] = time.perf_counter() - t_phase
    print(f"[psi] {out['wall_s']:.1f} s", flush=True)
    return out


# ------------- the quality protocols, the probes and the first ablations (item 14)

DT_PROTOCOL_RES = 128
DT_PROTOCOL_STEPS = 100
DT_WAVELENGTHS = (94, 131, 171, 193, 211)
DT_PROTOCOL = ('--steps', str(DT_PROTOCOL_STEPS), '--resolution', str(DT_PROTOCOL_RES),
               '--wavelengths', *map(str, DT_WAVELENGTHS), '--hot-blob', '--mask-exercise',
               '--keep-best')                  # 8x512, 64 + 128, batch 1024 by default
# [dt_protocol] holds each of the 90 view-channel frames' K0 render against
# the plain version's as [psi] does (p99.99 KERNEL_TOL, max KERNEL_MAX_TOL
# of max), with its own RMS limits: the raw RMS of the difference over the
# plain frame's RMS, and the asinh-scaled RMS (absolute), each twice the
# worst of the 90 frames on an H100 (1.36e-4 and 2.79e-5 read; PERF.md)
DT_RENDER_RMS_TOL = 3e-4
DT_SCALED_RMS_TOL = 6e-5
DT_FAULT_CHUNK = 2                   # of a 128^2 frame's 4 chunks of 4,096 rays
# the harness's single-channel frames against the five-channel renders'
# channels (the same field evaluations): PSNR dB, SSIM, MAE / ME points
DT_SCORE_TOL = dict(psnr=1e-3, ssim=1e-4, mae_percent=1e-3, me_percent=1e-3)
THOMSON_JAX = 'THOMSON_r5.json'      # the JAX package's recorded accuracy
THOMSON_ERR_FACTOR = 2.0             # held at no more than twice its errors
# and near the JAX package's float32 reading of the same scene on the CPU
# (scripts/thomson_protocol.py --skip-throughput): MAE at most
# THOMSON_CPU_FACTOR x, PSNR at most 20 log10 of it (0.51 dB) below
THOMSON_JAX_CPU = {'tB': {'mae_percent_of_mean': 0.7955, 'psnr_db': 41.03},
                   'pB': {'mae_percent_of_mean': 0.3017, 'psnr_db': 42.11}}
THOMSON_CPU_FACTOR = 1.06
PROBE_REPS = ('--reps', '2')
ABLATION_STEPS = ('--steps', '3', '--seeds', '7', '--resolution', '64')
K0, K1, K2, K5 = ('fused_mlp_fwd_wgmma (K0)', 'fused_mlp_stash_fwd (K1)',
                  'fused_mlp_stash_bwd (K2)', 'grid branch of K0-K2 (K5)')
# each of phases 22-26 runs under this deadline; a phase past it fails the
# run, and any worker pool of its ends its workers
PHASE_DEADLINE_S = 300


@contextlib.contextmanager
def _deadline(seconds: int, tag: str):
    """Raise SystemExit in the main thread once `seconds` have passed
    (SIGALRM; a blocked lock wait is interrupted), so that the phase's
    with-blocks (worker pools, temporary directories) unwind and the run
    exits non-zero; the previous handler and alarm are restored."""
    def expire(signum, frame):
        raise SystemExit(f'chip_smoke FAILED: {tag} past its {seconds} s deadline')
    previous = signal.signal(signal.SIGALRM, expire)
    signal.alarm(seconds)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, previous)


def _channel_check(k_img: np.ndarray, p_img: np.ndarray) -> tuple:
    """_view_check at [dt_protocol]'s RMS limits."""
    return _view_check(k_img, p_img, DT_RENDER_RMS_TOL, DT_SCALED_RMS_TOL)


def _dt_protocol_phase(device) -> dict:
    """[dt_protocol]: scripts/dt_protocol at 8x512, 64 + 128, batch 1024,
    five channels, the hot blob, the mask exercise and keep_best at 128^2
    for DT_PROTOCOL_STEPS steps (K1 + K2), its 90 frames scored on K0; one
    step of the protocol's system and each frame's K0 render held against
    the plain versions'."""
    from sunerf_tpu_torch.data.datasets import MmapDataset
    from sunerf_tpu_torch.data.fits import read_fits
    from sunerf_tpu_torch.data.loaders import p_key
    from sunerf_tpu_torch.data.wcs import parse_observer
    from sunerf_tpu_torch.evaluation.loader import ModelLoader, SuNeRFLoader
    from sunerf_tpu_torch.evaluation.metrics_harness import evaluate_viewpoints, view_metrics
    from sunerf_tpu_torch.models.fields import NeRFConfig
    from sunerf_tpu_torch.scripts import dt_protocol
    from sunerf_tpu_torch.scripts.probe_step import launches_by_kernel, zero_counts
    from sunerf_tpu_torch.systems import from_spec
    t_phase = time.perf_counter()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        workdir = os.path.join(tmp, 'run')
        zero_counts()
        t0 = time.perf_counter()
        row = dt_protocol.main([*DT_PROTOCOL, '--device', str(device), '--workdir', workdir,
                                '--data-cache', os.path.join(tmp, 'scene')])
        out['protocol_s'] = time.perf_counter() - t0
        out['launches'] = launches_by_kernel()
        out['row'] = row
        recs = [json.loads(line) for line in open(os.path.join(workdir, 'run', 'metrics.jsonl'))]
        steps = [r for r in recs if 'loss' in r]
        out['losses'] = [r['loss'] for r in steps]
        out['ms_per_step'] = statistics.mean(r['step_ms'] for r in steps[1:])
        # the training loss reaches its noise floor within the first logged
        # window (steps // 10), so the fall is read on the held-out view:
        # its loss at the last validation against the untrained field's
        vals = {r['step']: r for r in recs if 'val_loss' in r}
        out['val_loss'] = {s: r['val_loss'] for s, r in sorted(vals.items())}
        out['val_psnr'] = {s: r.get('val_psnr') for s, r in sorted(vals.items())}
        _check(out['launches'].get(K1) == 2 * DT_PROTOCOL_STEPS
               and out['launches'].get(K2) == 2 * DT_PROTOCOL_STEPS,
               f"[dt_protocol] launches {out['launches']}: not 2 K1 and 2 K2 a step")
        _check(all(np.isfinite(out['losses'])) and 0 in vals
               and vals[max(vals)]['val_loss'] < vals[0]['val_loss'],
               f"[dt_protocol] loss did not fall: held-out {out['val_loss']}, training "
               f"{out['losses']}")
        _check(all(np.isfinite(v) for s in ('train', 'test') for v in row[s].values()),
               f'[dt_protocol] scores {row}')
        print(f"[dt_protocol] dt_protocol {' '.join(DT_PROTOCOL)} (8x512, 64 + 128, batch "
              f"1024): {out['protocol_s']:.1f} s; launches {out['launches']}; losses "
              + ' '.join(f"{r['step']}:{r['loss']:.4g}" for r in steps)
              + '; held-out loss ' + ' '.join(f'{k}:{v:.4g}' for k, v in out['val_loss'].items())
              + f"; {out['ms_per_step']:.2f} ms/step (logged windows after the first); "
              f"effective {row['effective_rays_per_sec']:.0f} rays/s, median window "
              f"{row['rays_per_sec']:.0f}; scored {row['scored_bundle']}: train PSNR "
              f"{row['train']['psnr']:.3f} dB, SSIM {row['train']['ssim']:.4f}; test PSNR "
              f"{row['test']['psnr']:.3f} dB, SSIM {row['test']['ssim']:.4f}", flush=True)

        # the 90 frames scored again on K0, the launches of one score counted
        bundle = os.path.join(workdir, 'run', row['scored_bundle'])
        files = dt_protocol.gt_files(os.path.join(tmp, 'scene', 'renders'))
        _check(len(files) == 18 * len(DT_WAVELENGTHS), f'[dt_protocol] {len(files)} frames')
        k0_loader = SuNeRFLoader(bundle, device=device)

        # one K1 + K2 step of the protocol's own system (n_freqs_time=2
        # masks the time columns: d_encoded 68, not 84) on its first
        # training batch against the plain versions, from the system's
        # seed-0 init (both fields live) and from the scored bundle
        args = dt_protocol.build_parser().parse_args([*DT_PROTOCOL, '--device', str(device)])
        renderer, init, model, loss_config = dt_protocol.build_system(args, device)
        _check(model.d_encoded == 68, f'[dt_protocol] d_encoded {model.d_encoded}, not 68')
        shards = {p_key(n): os.path.join(workdir, 'work', f'{n}_batches.npy')
                  for n in ('rays', 'times', 'images', 'wavelengths')}
        batch = {k: torch.from_numpy(v).to(device) for k, v in
                 MmapDataset(shards, batch_size=dt_protocol.BATCH_SIZE)[0].items()}
        out['step_vs_plain'] = {}
        for which, params in (('init', init(torch.Generator(device=device).manual_seed(0))),
                              ('trained', k0_loader.params)):
            zero_counts()
            vs = _step_vs_plain(renderer, {'field_apply': _plain_apply(model)}, params,
                                batch, loss_config)
            vs['launches'] = launches_by_kernel()
            _check(vs['launches'].get(K1) == 2 and vs['launches'].get(K2) == 2,
                   f"[dt_protocol] the step vs plain launched {vs['launches']}, not 2 K1 "
                   "and 2 K2")
            print(f"[dt_protocol] {which} params: max |plain grad| per field "
                  f"{vs['plain_grad_max']}", flush=True)
            _check(which != 'init' or min(vs['plain_grad_max'].values()) > 0,
                   f"[dt_protocol] a field's plain gradients are all zero: "
                   f"{vs['plain_grad_max']}")
            _check_vs_plain(f'dt_protocol] [{which}', vs)
            out['step_vs_plain'][which] = vs
        del renderer
        zero_counts()
        t0 = time.perf_counter()
        scored = evaluate_viewpoints(k0_loader, files)
        out['score_s'] = time.perf_counter() - t0
        out['score_k0_launches'] = launches_by_kernel().get(K0, 0)
        n_chunks = DT_PROTOCOL_RES * DT_PROTOCOL_RES // 4096
        _check(out['score_k0_launches'] == 2 * n_chunks * len(files),
               f"[dt_protocol] the score launched K0 {out['score_k0_launches']} times, not "
               f"{2 * n_chunks * len(files)}")
        for split in ('train', 'test'):
            for m, v in scored[split].items():
                _check(abs(v - row[split][m]) <= 1e-9 * max(1.0, abs(v)),
                       f"[dt_protocol] {split} {m}: the row's {row[split][m]} is not the K0 "
                       f"score's {v}")

        # each view in five channels on K0 and through the plain version
        spec = k0_loader.config['renderer_spec']
        base, _ = from_spec(spec, use_fused=False, device=device)
        plain_renderer = dataclasses.replace(
            base, field_apply=_plain_apply(NeRFConfig(**spec['model_config'])),
            coarse_field_apply=None)
        plain_loader = ModelLoader(plain_renderer, k0_loader.params, ref_time=k0_loader.ref_time,
                                   seconds_per_dt=k0_loader.seconds_per_dt, device=device)
        by_view = {}
        for path in files:
            by_view.setdefault(os.path.basename(path).split('.')[0], []).append(path)
        frames, worst = [], {}
        for name, paths in sorted(by_view.items()):
            data = {}
            for path in paths:
                img, header = read_fits(path)
                data[int(os.path.basename(os.path.dirname(path)))] = (img, path)
            obs = parse_observer(header)
            wls = sorted(data)
            kw = dict(lat=obs.carrington_lat, lon=obs.carrington_lon, time=obs.time,
                      distance=obs.dsun_rs, resolution=DT_PROTOCOL_RES, wavelengths=wls)
            k_img = k0_loader.render_observer_image(**kw).image
            p_img = plain_loader.render_observer_image(**kw).image
            for c, wl in enumerate(wls):
                stats, faults = _channel_check(k_img[:, :, c], p_img[:, :, c])
                _check(not faults, f"[dt_protocol] {name} {wl} A: K0 render vs the plain "
                                   f"version's: {', '.join(faults)} ({_fmt(stats)}, scaled "
                                   f"rms {stats['scaled_rms']:.3e})")
                img, path = data[wl]
                frames.append(dict(view=name, wavelength=wl,
                                   lat=float(np.rad2deg(obs.carrington_lat)), check=stats,
                                   k0=view_metrics(k_img[:, :, c], img),
                                   plain=view_metrics(p_img[:, :, c], img)))
        for key in ('max_rel_err', 'p9999_rel_err', 'rms_rel_err', 'scaled_rms'):
            worst[key] = max(f['check'][key] for f in frames)
        out['frames_checked'] = len(frames)
        out['worst'] = worst
        print(f"[dt_protocol] {len(frames)} view-channel frames, K0 (five channels a view) vs "
              f"the plain version, worst: max {worst['max_rel_err']:.2e}, p99.99 "
              f"{worst['p9999_rel_err']:.2e} of max, rms {worst['rms_rel_err']:.2e} of rms, "
              f"scaled rms {worst['scaled_rms']:.2e} (limits {KERNEL_MAX_TOL}, {KERNEL_TOL}, "
              f"{DT_RENDER_RMS_TOL}, {DT_SCALED_RMS_TOL}); per channel, worst rms / scaled "
              "rms: " + '; '.join(
                  f"{wl} {max(f['check']['rms_rel_err'] for f in frames if f['wavelength'] == wl):.2e}"
                  f" / {max(f['check']['scaled_rms'] for f in frames if f['wavelength'] == wl):.2e}"
                  for wl in DT_WAVELENGTHS), flush=True)

        # the five-channel K0 frames score as the harness's single-channel ones
        out['scores'] = {}
        for split, keep in (('train', lambda f: abs(f['lat']) <= 7.0),
                            ('test', lambda f: abs(f['lat']) > 7.0)):
            fs = [f for f in frames if keep(f)]
            r = {m: dict(k0=float(np.mean([f['k0'][m] for f in fs])),
                         plain=float(np.mean([f['plain'][m] for f in fs])))
                 for m in DT_SCORE_TOL}
            for m, tol in DT_SCORE_TOL.items():
                _check(abs(r[m]['k0'] - row[split][m]) <= tol,
                       f"[dt_protocol] {split} {m}: five-channel K0 frames "
                       f"{r[m]['k0']:.6g} vs the harness's {row[split][m]:.6g}")
            out['scores'][split] = r
            print(f"[dt_protocol] {split} ({len(fs)} frames): K0 PSNR {r['psnr']['k0']:.3f} dB, "
                  f"SSIM {r['ssim']['k0']:.4f}, MAE {r['mae_percent']['k0']:.3f}%, ME "
                  f"{r['me_percent']['k0']:.3f}%; plain version PSNR {r['psnr']['plain']:.3f}, "
                  f"SSIM {r['ssim']['plain']:.4f}, MAE {r['mae_percent']['plain']:.3f}%, ME "
                  f"{r['me_percent']['plain']:.3f}%", flush=True)

        # the check's own power: the fine K0 output reversed on one chunk
        calls = [0]

        def faulty(p, x):
            # one field for both passes: a chunk's coarse pass, then its fine
            o = k0_loader.renderer.field_apply(p, x)
            calls[0] += 1
            return o._replace(raw=o.raw.flip(0)) if calls[0] == 2 * DT_FAULT_CHUNK + 2 else o
        name, paths = sorted(by_view.items())[0]
        obs = parse_observer(read_fits(paths[0])[1])
        kw = dict(lat=obs.carrington_lat, lon=obs.carrington_lon, time=obs.time,
                  distance=obs.dsun_rs, resolution=DT_PROTOCOL_RES,
                  wavelengths=list(DT_WAVELENGTHS))
        bad = ModelLoader(dataclasses.replace(k0_loader.renderer, field_apply=faulty),
                          k0_loader.params, ref_time=k0_loader.ref_time,
                          seconds_per_dt=k0_loader.seconds_per_dt, device=device)
        b_img = bad.render_observer_image(**kw).image
        p_img = plain_loader.render_observer_image(**kw).image
        out['fault_flags'] = {wl: _channel_check(b_img[:, :, c], p_img[:, :, c])[1]
                              for c, wl in enumerate(DT_WAVELENGTHS)}
        _check(calls[0] > 2 * DT_FAULT_CHUNK + 1 and all(out['fault_flags'].values()),
               f"[dt_protocol] a reversed K0 chunk passed the check: {out['fault_flags']}")
        print(f"[dt_protocol] self-check: the fine K0 output reversed on chunk {DT_FAULT_CHUNK} "
              f"of {name} fails every channel's check: " + '; '.join(
                  f"{wl}: {', '.join(f)}" for wl, f in out['fault_flags'].items()), flush=True)
        print(f"[dt_protocol] the score: {out['score_s']:.1f} s, {out['score_k0_launches']} K0 "
              f"launches ({len(files)} frames x {n_chunks} chunks x 2 fields)", flush=True)
        del k0_loader, plain_loader, bad
    out['wall_s'] = time.perf_counter() - t_phase
    print(f"[dt_protocol] {out['wall_s']:.1f} s", flush=True)
    return out


def _thomson_protocol_phase(device) -> dict:
    """[thomson_protocol]: scripts/thomson_protocol at its defaults: tB and
    pB at 64^2, 215 Rs, 64 + 128 against the float64 oracle, held at no
    more than THOMSON_ERR_FACTOR x the JAX package's recorded errors and
    THOMSON_CPU_FACTOR x its CPU reading; the 8x512 step's ms and rays/s
    with its launches by kernel name."""
    from sunerf_tpu_torch.scripts import thomson_protocol
    t_phase = time.perf_counter()
    with open(THOMSON_JAX) as f:
        jax_row = json.load(f)
    with tempfile.TemporaryDirectory() as tmp:
        row = thomson_protocol.main(['--device', str(device), '--out',
                                     os.path.join(tmp, 'thomson.json')])
    out = {'row': row, 'jax_recorded': {k: jax_row[k] for k in ('tB', 'pB')}}
    for k in ('tB', 'pB'):
        got = row[k]
        limits = []
        for want, factor in ((jax_row[k], THOMSON_ERR_FACTOR),
                             (THOMSON_JAX_CPU[k], THOMSON_CPU_FACTOR)):
            # factor x the error: MAE x factor, and the RMS x factor lowers
            # the PSNR by 20 log10(factor)
            mae_lim = factor * want['mae_percent_of_mean']
            psnr_lim = want['psnr_db'] - 20 * np.log10(factor)
            _check(got['mae_percent_of_mean'] <= mae_lim and got['psnr_db'] >= psnr_lim,
                   f"[thomson_protocol] {k} MAE {got['mae_percent_of_mean']}% (limit "
                   f"{mae_lim:.4f}), PSNR {got['psnr_db']} dB (limit {psnr_lim:.2f})")
            limits.append(f'{mae_lim:.4f}%, {psnr_lim:.2f} dB')
        print(f"[thomson_protocol] {k} at {row['scene']['resolution']}^2, 215 Rs, 64 + 128 vs "
              f"the float64 oracle: MAE {got['mae_percent_of_mean']}% of mean, PSNR "
              f"{got['psnr_db']} dB (the JAX package's recorded "
              f"{jax_row[k]['mae_percent_of_mean']}%, {jax_row[k]['psnr_db']} dB, its CPU "
              f"reading {THOMSON_JAX_CPU[k]['mae_percent_of_mean']}%, "
              f"{THOMSON_JAX_CPU[k]['psnr_db']} dB; limits {limits[0]} and {limits[1]})",
              flush=True)
    launches = row['train_launches_per_step']
    _check(launches.get(K1) == 2 and launches.get(K2) == 2 and not launches.get(K0),
           f'[thomson_protocol] launches of one step {launches}: not 2 K1 + 2 K2')
    _check(np.isfinite(row['train_ms_per_step']), f'[thomson_protocol] step {row}')
    print(f"[thomson_protocol] make_thomson_system 8x512, 64 + 128, batch 1024: "
          f"{row['train_ms_per_step']:.3f} ms/step, {row['train_rays_per_sec_per_chip']:.0f} "
          f"rays/s (CUDA events); launches of one step {launches}", flush=True)
    out['wall_s'] = time.perf_counter() - t_phase
    print(f"[thomson_protocol] {out['wall_s']:.1f} s", flush=True)
    return out


def _probes_phase(device) -> dict:
    """[probes]: probe_kernel, probe_grid_kernel, probe_overhead,
    probe_grid_step and probe_grid_encoding once each at their default
    shapes and fewer repetitions; the launches of each call by kernel
    name."""
    from sunerf_tpu_torch.scripts import (probe_grid_encoding, probe_grid_kernel,
                                          probe_grid_step, probe_kernel, probe_overhead)
    t_phase = time.perf_counter()
    dev = ['--device', str(device)]
    out = {'kernel': probe_kernel.main([*PROBE_REPS, *dev])}
    for name, want in (('plain fwd', {K0: 1}), ('stash fwd', {K1: 1}), ('stash bwd', {K2: 1})):
        _check(out['kernel'][name]['launches'] == want,
               f"[probes] probe_kernel {name}: launches {out['kernel'][name]['launches']}")
    out['grid_kernel'] = probe_grid_kernel.main([*PROBE_REPS, *dev])
    for label, kw in probe_grid_kernel.CONFIGS:
        n_grid = 1 if 'grid_sizes' in kw else 0
        want = {'fwd': {K0: 1} | ({K5: 1} if n_grid else {}),
                'step': {K1: 1, K2: 1} | ({K5: 2} if n_grid else {})}
        _check(out['grid_kernel']['launches'][label] == want,
               f"[probes] probe_grid_kernel {label}: launches "
               f"{out['grid_kernel']['launches'][label]}, not {want}")
    # K5's parts by kernel name at the grid shapes: one step of each grid
    # field, as probe_grid_kernel times it, each part launched once, as the
    # backward's library counts its launches (torch.profiler loses device
    # records on the card's machine, all of a call's or some)
    from sunerf_tpu_torch.models.fields import emission_config
    from sunerf_tpu_torch.ops import fused_mlp
    pts = probe_grid_kernel.probe_points(out['grid_kernel']['n_points'], device)
    out['grid_kernels'] = {}
    for label, kw in probe_grid_kernel.CONFIGS:
        if 'grid_sizes' in kw:
            _, fwd_bwd = probe_grid_kernel.field_calls(emission_config(**kw), pts, device)
            names = _library_launches('fused_mlp_stash_bwd', fwd_bwd)
            out['grid_kernels'][label] = names
            _check(names == dict.fromkeys(fused_mlp.GRID_KERNELS, 1),
                   f'[probes] probe_grid_kernel {label} step: K5 kernels {names}, '
                   f'not one launch each')
    del pts
    out['overhead'] = probe_overhead.main([*PROBE_REPS, '--steps', '5', *dev])
    for name, r in out['overhead'].items():
        _check(r['launches'] == {K1: 2, K2: 2},
               f"[probes] probe_overhead {name}: launches of one step {r['launches']}")
    out['grid_step'] = probe_grid_step.main(['--reps', '5', *dev])
    for label, launches in out['grid_step']['launches'].items():
        _check(launches == {K1: 2, K2: 2, K5: 2},
               f'[probes] probe_grid_step {label}: launches of one step {launches}')
    out['grid_encoding'] = probe_grid_encoding.main(['--reps', '5', *dev])
    for key, launches in out['grid_encoding']['launches'].items():
        want = {K1: 1} if key.endswith('_stash') else {K0: 1}
        _check(launches == want, f'[probes] probe_grid_encoding {key}: launches {launches}')
    out['wall_s'] = time.perf_counter() - t_phase
    print(f"[probes] {out['wall_s']:.1f} s; " + json.dumps(
        {k: v for k, v in out.items() if k != 'wall_s'}), flush=True)
    return out


def _ablations_phase(device) -> dict:
    """[ablations]: dt_ablation, occupancy_ablation (the A/B) and
    occupancy_value_case at their own widths (8x512 fine fields, the
    variants' proposal, 6x384 and grid fields) for ABLATION_STEPS, one
    seed; eval_budget_sweep re-scoring the committed bundle at 64 + 128 on
    the psi_193 scene at 64^2. Finite rows, launches by kernel name."""
    from sunerf_tpu_torch.scripts import (dt_ablation, eval_budget_sweep, occupancy_ablation,
                                          occupancy_value_case, psi_protocol)
    from sunerf_tpu_torch.scripts.probe_step import launches_by_kernel, zero_counts
    t_phase = time.perf_counter()
    out = {}
    dev = ['--device', str(device)]
    with tempfile.TemporaryDirectory() as tmp:
        for name, module, flags, summary in (
                ('dt_ablation', dt_ablation, ABLATION_STEPS, 'dt_ablation'),
                ('occupancy_ablation', occupancy_ablation, ABLATION_STEPS, None),
                ('occupancy_value_case', occupancy_value_case, ABLATION_STEPS, 'value_case')):
            zero_counts()
            t0 = time.perf_counter()
            row = module.main([*flags, *dev, '--workdir', os.path.join(tmp, name)])
            launches = launches_by_kernel()
            runs = (list(row[summary].values()) if summary
                    else [row['baseline'], row['occupancy']])
            psnrs = [r.get('psnr_mean', r.get('val_psnr')) for r in runs]
            _check(all(np.isfinite(p) for p in psnrs) and all(r['rays_per_sec'] > 0 for r in runs),
                   f'[ablations] {name}: {row}')
            _check(all(launches.get(k, 0) > 0 for k in (K0, K1, K2)),
                   f'[ablations] {name}: launches {launches}')
            if name == 'dt_ablation':
                _check(launches.get(K5, 0) > 0, f'[ablations] dt_ablation: launches {launches}')
            out[name] = dict(row=row, launches=launches, s=time.perf_counter() - t0)
            print(f"[ablations] {name} {' '.join(flags)}: {out[name]['s']:.1f} s, launches "
                  f"{launches}; {json.dumps(row)}", flush=True)

        # the committed bundle (proposal 4x128, 20 + 40) as a one-row matrix
        run = os.path.join(tmp, 'bundle', 'run')
        os.makedirs(run)
        for ext in ('.npz', '.json'):
            shutil.copy(BUNDLE + ext, os.path.join(run, 'save_state' + ext))
        with open(BUNDLE + '.json') as f:
            render = json.load(f)['renderer_spec']['render']
        matrix = os.path.join(tmp, 'matrix.jsonl')
        with open(matrix, 'w') as f:
            f.write(json.dumps({'config': {
                'n_stratified': render['n_stratified'], 'n_hierarchical': render['n_hierarchical'],
                'proposal_coarse': True, 'coarse_shape': [4, 128], 'steps': 0,
                'tier_fraction': 0.0, 'tier_samples': 16, 'seed': 0},
                'test': {}, 'rays_per_sec': 0.0, 'workdir': os.path.join(tmp, 'bundle')}) + '\n')
        _, gt_dir = psi_protocol.ensure_scene(os.path.join(tmp, 'scene64'), 64, device=device)
        zero_counts()
        t0 = time.perf_counter()
        rows = eval_budget_sweep.main(['--matrix', matrix, '--gt', os.path.join(gt_dir, '*.fits'),
                                       '--out', os.path.join(tmp, 'budget.jsonl'), *dev])
        launches = launches_by_kernel()
        _check(len(rows) == 1 and all(np.isfinite(v) for s in ('train', 'test')
                                      for v in rows[0][s].values()),
               f'[ablations] eval_budget_sweep: {rows}')
        _check(launches == {K0: 18 * 2}, f'[ablations] eval_budget_sweep: launches {launches}')
        out['eval_budget_sweep'] = dict(row=rows[0], launches=launches,
                                        s=time.perf_counter() - t0)
        print(f"[ablations] eval_budget_sweep: the committed bundle ({render['n_stratified']} + "
              f"{render['n_hierarchical']}) re-scored at 64 + 128 on the psi_193 scene's 18 "
              f"views at 64^2: {out['eval_budget_sweep']['s']:.1f} s, launches {launches}; "
              f"{json.dumps(rows[0])}", flush=True)
    out['wall_s'] = time.perf_counter() - t_phase
    print(f"[ablations] {out['wall_s']:.1f} s", flush=True)
    return out


# the wide route (ops/wide_mlp.py): fields the fused kernels cannot hold.
# (name, layers, width, d_output): a converted reference-style field at
# twice the reference's default width, the converter test's 2x640 field at
# 9 outputs, and 8x512 at 16 outputs; K0 at WIDE_N_FWD points, K1 + K2 at
# WIDE_N_BWD (and 8x1024 also at the coarse step's 65,536)
WIDE_SHAPES = (('8x1024:2', 8, 1024, 2), ('2x640:9', 2, 640, 9), ('8x512:16', 8, 512, 16))
WIDE_N_FWD, WIDE_N_BWD, WIDE_N_COARSE = 245760, 196608, 65536
WIDE_N_PATHS = 65536
WIDE_SNF_RES = 256
WIDE_TUNE_STEPS = 20
WIDE_TUNE_RES = 64
K0W, K1W, K2W = 'wide_fwd (K0)', 'wide_fwd (K1)', 'wide_bwd (K2)'
WGMMA = 'wide_wgmma_kernel'   # the wide route's GEMM, by the name its libraries count
# the wide K1's RMS over RMS against the plain version, at most this many
# times the plain version's own f32 floor (CPU against card) on that field
K1_RMS_FLOOR_FACTOR = 3.0


def _wide_launches() -> dict:
    """Both wide libraries' launches by kernel name, since they were loaded."""
    from sunerf_tpu_torch.ops import fused_mlp
    return {**fused_mlp.kernel_launches('wide_mlp_fwd'),
            **fused_mlp.kernel_launches('wide_mlp_bwd')}


def _wide_delta(before: dict) -> dict:
    after = _wide_launches()
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


def _check_k1(tag: str, k1: dict):
    """K1's out is K0's bits (K1_VS_K0_TOL), and within KERNEL_TOL at the
    99.99th percentile and KERNEL_MAX_TOL of the plain version; its RMS
    within KERNEL_RMS_TOL, or within K1_RMS_FLOOR_FACTOR times the f32
    order's own floor on the same field where that floor is higher (the
    plain version on the CPU against the card's on the first 2,048 points:
    on a random field whose outputs sit near zero the RMS over RMS magnifies
    any reordering of the f32 sums)."""
    rms_tol = max(KERNEL_RMS_TOL,
                  K1_RMS_FLOOR_FACTOR * k1['plain_cpu_vs_card']['rms_rel_err'])
    _check(k1['p9999_rel_err'] <= KERNEL_TOL and k1['max_rel_err'] <= KERNEL_MAX_TOL
           and k1['rms_rel_err'] <= rms_tol,
           f'{tag}: K1 out vs plain {_fmt(k1)} (rms tol {rms_tol:.2e}: the f32 floor '
           f"{k1['plain_cpu_vs_card']['rms_rel_err']:.2e})")
    _check(k1['vs_k0_max_rel_err'] <= K1_VS_K0_TOL, f"{tag}: K1 vs K0 {k1['vs_k0_max_rel_err']}")
    _check(k1['hs_within_1ulp_layerwise'] >= 0.999,
           f"{tag}: K1 sin stash within 1 ulp for {k1['hs_within_1ulp_layerwise']:.6f}")
    _check(k1['cs_max_diff_layerwise'] <= 1, f"{tag}: K1 int8 cos off by "
                                              f"{k1['cs_max_diff_layerwise']}")


def _check_grads(tag: str, row: dict):
    for k, e in row['grads'].items():
        tol = DPTS_TOL if k == 'dpts' else GRAD_TOL
        _check(e['max_rel_err'] <= tol, f"{tag}: {k} vs plain {e['max_rel_err']:.3e} (tol {tol})")
    _check(row['finite'], f'{tag}: gradients not finite')
    _check(row['bit_identical'], f'{tag}: gradients differ over two runs')


I8W, I8MAXW = 'wide_dw_i8_wgmma_kernel (K6b)', 'wide_dz_group_max_kernel (K6b)'


def _wide_kernel_rows(device) -> dict:
    """[wide] a-b: the wide K0, K1 + K2 at WIDE_SHAPES and K3, K4, K6a, K5
    at 2x640 against the plain versions (scripts/probe_wide.py's rows),
    K6b's backward at scale groups 8, 40 and 768 there, and K6b at 8x1024 /
    d_output 2, N = WIDE_N_BWD, the default group: its int8 dW_h and the
    groups' maxima a hidden layer by kernel name."""
    from sunerf_tpu_torch.ops import fused_mlp
    from sunerf_tpu_torch.scripts import probe_wide
    rows = {}
    for i, (name, layers, width, d_out) in enumerate(WIDE_SHAPES):
        tag = f'[wide] {name}'
        cfg, p, pts, _ = probe_wide.setup(layers, width, d_out, WIDE_N_FWD, device, seed=i)
        k0 = probe_wide.k0_row(cfg, p, pts, reps=3)
        print(f"{tag} K0 N={WIDE_N_FWD}: {_fmt(k0)}; {k0['ms']:.3f} ms (plain {k0['plain_ms']:.3f}, "
              f"library {k0['library_ms']:.3f}, bound {k0['bound_ms']:.3f} by {k0['bound_by']}); "
              f"launches {k0['launches']}", flush=True)
        _check(k0['finite'] and k0['p9999_rel_err'] <= KERNEL_TOL
               and k0['rms_rel_err'] <= KERNEL_RMS_TOL and k0['max_rel_err'] <= KERNEL_MAX_TOL,
               f'{tag}: K0 vs plain {_fmt(k0)}')
        _check(k0['launches'].get(K0W) == 1 and k0['launches'].get('WIDE_LAUNCHES') == 1
               and k0['launches'].get(WGMMA) == layers + 1,
               f"{tag}: K0 launches {k0['launches']}")
        del p, pts
        row = {'k0': k0}
        for n in ((WIDE_N_BWD, WIDE_N_COARSE) if width == 1024 else (WIDE_N_BWD,)):
            cfg, p, pts, dy = probe_wide.setup(layers, width, d_out, n, device, seed=100 + i)
            k1, k2 = probe_wide.k12_rows(cfg, p, pts, dy, reps=3)
            print(f"{tag} K1 N={n}: {_fmt(k1)}; the f32 floor (plain on the CPU vs the "
                  f"card's, 2,048 points): rms {k1['plain_cpu_vs_card']['rms_rel_err']:.2e}; "
                  f"stash within 1 ulp "
                  f"{k1['hs_within_1ulp_layerwise']:.6f}, int8 cos off by at most "
                  f"{k1['cs_max_diff_layerwise']}; {k1['ms']:.3f} ms (plain {k1['plain_ms']:.3f}, "
                  f"library {k1['library_ms']:.3f}, bound {k1['bound_ms']:.3f})", flush=True)
            print(f"{tag} K2 N={n}: max over max|plain| " + '; '.join(
                f"{k} {e['max_rel_err']:.2e}" for k, e in k2['grads'].items())
                + f"; two runs bit-identical {k2['bit_identical']}; {k2['ms']:.3f} ms (plain "
                f"{k2['plain_ms']:.3f}, library {k2['library_ms']:.3f}, bound {k2['bound_ms']:.3f}); "
                f"launches {k2['launches']}", flush=True)
            _check_k1(f'{tag} N={n}', k1)
            _check_grads(f'{tag} K2 N={n}', k2)
            # every product on wide_wgmma_kernel: K1's layers and head, K2's
            # chain (L) and dW (L + 1)
            _check(k1['launches'].get(K1W) == 1 and k2['launches'].get(K2W) == 1
                   and k1['launches'].get(WGMMA) == layers + 1
                   and k2['launches'].get(f'{WGMMA} chain') == layers
                   and k2['launches'].get(f'{WGMMA} dW') == layers + 1,
                   f"{tag}: K1 / K2 launches {k1['launches']} {k2['launches']}")
            row['k1' if n == WIDE_N_BWD else 'k1_coarse'] = k1
            row['k2' if n == WIDE_N_BWD else 'k2_coarse'] = k2
            del p, pts, dy
            torch.cuda.empty_cache()
        rows[name] = row
    paths = probe_wide.path_rows(WIDE_N_PATHS, device, reps=3)
    expect = {'K3': ('dpts_kernel (K3)', K1W, K2W), 'K4': ('dpts_kernel (K3)', 'wide_fwd (K4)',
                                                         'wide_bwd (K4)'),
              'K6a': ('dpts_kernel (K3)', 'wide_fwd (K6a)', 'wide_bwd (K6a)'),
              'K6b': ('dpts_kernel (K3)', 'wide_fwd (K6b)', 'wide_bwd (K6b)', I8W, I8MAXW),
              'K5': ('grid_max_kernel (K5)', 'grid_scatter_kernel', 'grid_convert_kernel', K1W,
                     K2W)}
    for name, row in paths.items():
        tag = f'[wide] {name} 2x640 N={WIDE_N_PATHS}'
        print(f"{tag}: max over max|plain| " + '; '.join(
            f"{k} {e['max_rel_err']:.2e}" for k, e in row['grads'].items())
            + f"; bit-identical {row['bit_identical']}; {row['ms']:.3f} ms forward + backward; "
            f"launches {row['launches']}", flush=True)
        _check(row['keys_match'], f'{tag}: gradient keys')
        _check_grads(tag, row)
        _check(all(row['launches'].get(k, 0) >= 1 for k in expect[name]),
               f"{tag}: launches {row['launches']}, expected {expect[name]}")
    groups = probe_wide.i8pair_group_rows(WIDE_N_PATHS, device, reps=3)
    for name, row in groups.items():
        tag = f'[wide] K6b i8pair {name} 2x640 N={WIDE_N_PATHS}'
        print(f"{tag}: max over max|plain| " + '; '.join(
            f"{k} {e['max_rel_err']:.2e}" for k, e in row['grads'].items())
            + f"; bit-identical {row['bit_identical']}; {row['ms']:.3f} ms backward (plain "
            f"{row['plain_ms']:.3f}); launches {row['launches']}", flush=True)
        _check_grads(tag, row)
        _check(row['launches'].get(I8W) == 1 and row['launches'].get(I8MAXW) == 1
               and row['launches'].get('wide_bwd (K6b)') == 1,
               f"{tag}: launches {row['launches']}")
    torch.cuda.empty_cache()
    k6b = probe_wide.i8pair_wide_row(WIDE_N_BWD, device, reps=3)
    tag = f'[wide] K6b i8pair 8x1024:2 N={WIDE_N_BWD} group {fused_mlp.STASH_BWD_TILE}'
    lib = k6b['dw_h_library']
    print(f"{tag}: max over max|plain| " + '; '.join(
        f"{k} {e['max_rel_err']:.2e}" for k, e in k6b['grads'].items())
        + f"; bit-identical {k6b['bit_identical']}; {k6b['ms']:.3f} ms forward + backward "
        f"(plain {k6b['plain_ms']:.3f}, library {k6b['library_ms']:.3f}, bound "
        f"{k6b['bound_ms']:.3f} by {k6b['bound_by']}); backward {k6b['bwd_ms']:.3f} ms (plain "
        f"{k6b['bwd_plain_ms']:.3f}; dW_h bound {k6b['dw_h_bound_ms']:.3f} by "
        f"{k6b['dw_h_bound_by']}; bf16 torch.bmm "
        f"{lib['bmm_ms']:.3f}, torch._int_mm a layer, summed {lib['int_mm_ms']:.3f}); launches "
        f"{k6b['launches']}", flush=True)
    _check(k6b['keys_match'], f'{tag}: gradient keys')
    _check_grads(tag, k6b)
    layers = WIDE_SHAPES[0][1]
    _check(k6b['launches'].get(I8W) == layers - 1 and k6b['launches'].get(I8MAXW) == layers - 1
           and k6b['launches'].get('wide_bwd (K6b)') == 1,
           f"{tag}: launches {k6b['launches']}")
    return {'rows': rows, 'paths': paths, 'i8pair_groups': groups, 'i8pair_8x1024': k6b}


def _wide_snf(device) -> dict:
    """[wide] c: an 8x1024 reference-style save_state.snf (random fields
    from a seed, both passes 8x1024 as the reference's NeRF(d_filter)
    builds them), converted by the port's CLI, served at 256^2 through
    SuNeRFLoader on the wide K0 (32 launches by kernel name) against the
    plain version, exported and served from the artifact (the live frame's
    bits, 32 launches), then fine-tuned WIDE_TUNE_STEPS steps through the
    Trainer on views of the committed bundle: 2 wide K1 + 2 wide K2 a step
    by kernel name, the loss finite and falling."""
    from sunerf_tpu_torch.data.loaders import build_single_channel_data
    from sunerf_tpu_torch.data.synthetic import synthesize_views
    from sunerf_tpu_torch.evaluation.loader import ModelLoader, SuNeRFLoader
    from sunerf_tpu_torch.evaluation.serving import ServingModel, export_serving
    from sunerf_tpu_torch.models.fields import (FieldOutput, NeRFConfig, emission_config,
                                                init_nerf)
    from sunerf_tpu_torch.ops import fused_mlp
    from sunerf_tpu_torch.scripts.probe_step import launches_by_kernel, zero_counts
    from sunerf_tpu_torch.systems import from_spec
    from sunerf_tpu_torch.train.loop import Trainer, TrainerConfig
    from sunerf_tpu_torch.train.objective import LossConfig
    from sunerf_tpu_torch.train.optim import OptimConfig
    from sunerf_tpu_torch.utils import snf_converter
    t_phase = time.perf_counter()
    cfg = emission_config(n_layers=8, d_filter=1024)
    gen = torch.Generator().manual_seed(1024)
    params = {k: {kk: vv.numpy() for kk, vv in init_nerf(gen, cfg, 'cpu').items()}
              for k in ('fine', 'coarse')}
    mc = dataclasses.asdict(cfg)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        snf = os.path.join(tmp, 'save_state.snf')
        _write_reference_snf(snf, params, {'model_config': mc, 'coarse_model_config': mc})
        converted = os.path.join(tmp, 'converted')
        snf_converter.main(['--snf', snf, '--out', converted])
        _drop_reference_modules()
        loader = SuNeRFLoader(converted, device=device)
        fine = NeRFConfig(**loader.config['renderer_spec']['model_config'])
        _check(fine.d_filter == 1024 and fused_mlp.kernel_route(fine) == 'wide',
               f'[wide] converted field {fine.n_layers}x{fine.d_filter}, route '
               f'{fused_mlp.kernel_route(fine)}')
        view = dict(VIEW, resolution=WIDE_SNF_RES)
        loader.render_observer_image(**view)
        torch.cuda.synchronize()
        zero_counts()
        before = _wide_launches()
        frame = loader.render_observer_image(**view)
        torch.cuda.synchronize()
        out['live_launches'] = dict(_wide_delta(before), **launches_by_kernel())
        n_chunks = WIDE_SNF_RES * WIDE_SNF_RES // loader.batch_size
        _check(out['live_launches'].get(K0W) == 2 * n_chunks
               and out['live_launches'].get('wide_mlp_fwd (K0 wide)') == 2 * n_chunks
               and out['live_launches'].get(WGMMA) == 2 * n_chunks * (fine.n_layers + 1),
               f"[wide] live frame launches {out['live_launches']}, not {2 * n_chunks} wide K0")
        t0 = time.perf_counter()
        loader.render_observer_image(**view)
        out['frame_ms'] = (time.perf_counter() - t0) * 1e3

        def plain(c):
            return lambda p, x: FieldOutput(raw=fused_mlp.fused_mlp_reference(c, p, x))
        spec = loader.config['renderer_spec']
        base, _ = from_spec(spec, use_fused=False, device=device)
        plain_renderer = dataclasses.replace(base, field_apply=plain(fine),
                                             coarse_field_apply=plain(fine))
        plain_frame = ModelLoader(plain_renderer, loader.params,
                                  device=device).render_observer_image(**view)
        out['vs_plain'] = {k: _rel(getattr(plain_frame, k), getattr(frame, k)) for k in MAPS}
        for k in MAPS:
            _check(bool(np.isfinite(getattr(frame, k)).all()), f'[wide] frame {k} not finite')
        _check(out['vs_plain']['image'] <= RENDER_TOL,
               f"[wide] frame image {out['vs_plain']['image']:.3e} of max from the plain version")
        artifact = os.path.join(tmp, 'wide.tsrv')
        t0 = time.perf_counter()
        meta = export_serving(converted, artifact, batch_size=4096, platforms=('cuda',))
        out['export_s'] = time.perf_counter() - t0
        served = ServingModel(artifact, device='cuda')
        served.render_observer_image(**view)
        torch.cuda.synchronize()
        before = _wide_launches()
        sframe = served.render_observer_image(**view)
        torch.cuda.synchronize()
        out['served_launches'] = _wide_delta(before)
        out['served_bits'] = all(np.array_equal(getattr(sframe, k), getattr(frame, k))
                                 for k in MAPS)
        print(f"[wide] 8x1024 reference .snf converted and served at {WIDE_SNF_RES}^2: live "
              f"launches {out['live_launches']}, {out['frame_ms']:.1f} ms; vs the plain version "
              + '; '.join(f'{k} {v:.3e}' for k, v in out['vs_plain'].items())
              + f"; exported in {out['export_s']:.1f} s (fused_cuda {meta['fused_cuda']}); served "
              f"from the artifact: launches {out['served_launches']}, the live frame's bits "
              f"{out['served_bits']}", flush=True)
        _check(meta['fused_cuda'] and out['served_bits'],
               f"[wide] artifact frame: fused_cuda {meta['fused_cuda']}, bits {out['served_bits']}")
        _check(out['served_launches'].get(K0W) == 2 * n_chunks,
               f"[wide] artifact launches {out['served_launches']}")
        del served, sframe, plain_frame

        # fine-tune through the Trainer on the committed bundle's views
        pattern = synthesize_views(tmp, device, WIDE_TUNE_RES)
        data = build_single_channel_data(pattern, os.path.join(tmp, 'work'), batch_size=1024)
        renderer, _ = from_spec(spec, device=device)
        trainer = Trainer(renderer, loader.params, data,
                          loss_config=LossConfig(lambda_regularization=0.1, scaling_vmax=10.0),
                          optim_config=OptimConfig(lr_start=5e-4, lr_floor=5e-4),
                          trainer_config=TrainerConfig(
                              total_steps=WIDE_TUNE_STEPS, val_every=WIDE_TUNE_STEPS,
                              checkpoint_every=WIDE_TUNE_STEPS, log_every=1,
                              save_val_images=False),
                          workdir=os.path.join(tmp, 'tune'), device=device)
        zero_counts()
        before = _wide_launches()
        t0 = time.perf_counter()
        trainer.fit()
        out['tune_s'] = time.perf_counter() - t0
        out['tune_launches'] = dict(_wide_delta(before), **launches_by_kernel())
        recs = [json.loads(line) for line in open(os.path.join(tmp, 'tune', 'metrics.jsonl'))]
        losses = [r['loss'] for r in recs if 'loss' in r]
        out['tune_losses'] = losses
        out['tune_ms_per_step'] = statistics.median(r['step_ms'] for r in recs if 'step_ms' in r)
    n = WIDE_TUNE_STEPS
    print(f"[wide] fine-tuned {n} steps ({out['tune_s']:.1f} s, {out['tune_ms_per_step']:.1f} "
          f"ms/step): launches {out['tune_launches']}; losses " + ' '.join(
              f'{v:.5f}' for v in losses), flush=True)
    _check(len(losses) == n and all(np.isfinite(losses)), f'[wide] fine-tune losses {losses}')
    _check(np.mean(losses[-5:]) < np.mean(losses[:5]), f'[wide] fine-tune loss not falling')
    for k in (K1W, K2W, 'wide_mlp_fwd (K1 wide)', 'wide_mlp_bwd (K2 wide)'):
        _check(out['tune_launches'].get(k) == 2 * n,
               f"[wide] fine-tune {k}: {out['tune_launches'].get(k)}, not {2 * n}")
    # K2's products on wide_wgmma_kernel: 8 chain steps and 9 dW a backward
    for k, per in ((f'{WGMMA} chain', 8), (f'{WGMMA} dW', 9)):
        _check(out['tune_launches'].get(k) == 2 * n * per,
               f"[wide] fine-tune {k}: {out['tune_launches'].get(k)}, not {2 * n * per}")
    out['wall_s'] = time.perf_counter() - t_phase
    return out


def _wide_phase(device) -> dict:
    """[wide]: the wide route on the card (see the docstring)."""
    t0 = time.perf_counter()
    out = _wide_kernel_rows(device)
    torch.cuda.empty_cache()
    out['snf'] = _wide_snf(device)
    out['wall_s'] = time.perf_counter() - t0
    print(f"[wide] {out['wall_s']:.1f} s", flush=True)
    return out


# [scripts18]: the last seven scripts of item 14 at tiny depths
SCRIPTS18_RES = ('--resolution', '32')
SCRIPTS18_STEPS = 3


def _scripts18_phase(device) -> dict:
    """[scripts18]: spike_guard_demo, temporal_closed_loop and its
    re-scoring, reprojection_baseline_psi (on the psi_193 scene at 32^2),
    real_data_rehearsal and the two capacity probes, a few steps each:
    finite rows, launches by kernel name where kernels run, the re-score
    the loop's own numbers."""
    from sunerf_tpu_torch.scripts import (probe_grid_capacity, probe_temporal_capacity,
                                          psi_protocol, real_data_rehearsal,
                                          recover_temporal_score, reprojection_baseline_psi,
                                          spike_guard_demo, temporal_closed_loop)
    t_phase = time.perf_counter()
    dev = ['--device', str(device)]
    out = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        row = fn()
        out[name] = dict(row=row, s=time.perf_counter() - t0)
        print(f"[scripts18] {name}: {out[name]['s']:.1f} s; {json.dumps(row)}", flush=True)
        return row

    with tempfile.TemporaryDirectory() as tmp:
        row = timed('spike_guard_demo', lambda: spike_guard_demo.main(
            ['--steps', str(SCRIPTS18_STEPS), *SCRIPTS18_RES, *dev, '--workdir',
             os.path.join(tmp, 'guard')]))
        n = 2 * 2 * SCRIPTS18_STEPS      # two runs, two fields a step
        _check(all(np.isfinite(row[a]['val_psnr']) for a in ('unguarded', 'guarded'))
               and row['launches'].get(K1) == n and row['launches'].get(K2) == n,
               f'[scripts18] spike_guard_demo: {row}')
        loop = timed('temporal_closed_loop', lambda: temporal_closed_loop.main(
            ['--frames', '2', '--views', '2', '--steps', str(SCRIPTS18_STEPS), *SCRIPTS18_RES,
             *dev, '--workdir', os.path.join(tmp, 'loop')]))
        _check(all(np.isfinite(loop[k]) for k in ('temporal_psnr', 'temporal_ssim',
                                                  'spatial_val_psnr'))
               and loop['launches'].get(K1) == 2 * SCRIPTS18_STEPS
               and loop['launches'].get(K0, 0) > 0,
               f'[scripts18] temporal_closed_loop: {loop}')
        again = timed('recover_temporal_score', lambda: recover_temporal_score.main(
            [loop['workdir'], *dev]))
        _check(all(again[k] == loop[k] for k in ('temporal_psnr', 'temporal_psnr_min',
                                                 'temporal_ssim', 'n_eval_views'))
               and again['launches'].get(K0, 0) > 0,
               f'[scripts18] recover_temporal_score: {again} against {loop}')
        train_dir, gt_dir = psi_protocol.ensure_scene(os.path.join(tmp, 'scene'), 32,
                                                      device=device)
        row = timed('reprojection_baseline_psi', lambda: {
            k: v for k, v in reprojection_baseline_psi.main(
                ['--train', os.path.join(train_dir, '*.fits'), '--gt',
                 os.path.join(gt_dir, '*.fits'), '--shape-out', '128', '256']).items()
            if k != 'views'})
        _check(all(np.isfinite(v) for s in ('train', 'test') for v in row[s].values()),
               f'[scripts18] reprojection_baseline_psi: {row}')
        row = timed('real_data_rehearsal', lambda: real_data_rehearsal.main(
            ['--steps', str(SCRIPTS18_STEPS), *SCRIPTS18_RES, *dev, '--workdir',
             os.path.join(tmp, 'rehearsal')]))
        _check(np.isfinite(row['rehearsal']['val_psnr']) and row['quant_err'] < 5e-3
               and row['launches'].get(K1) == 2 * SCRIPTS18_STEPS,
               f'[scripts18] real_data_rehearsal: {row}')
        for name, module in (('probe_grid_capacity', probe_grid_capacity),
                             ('probe_temporal_capacity', probe_temporal_capacity)):
            row = timed(name, lambda m=module: m.main(['--steps', str(SCRIPTS18_STEPS), *dev]))
            _check(all(np.isfinite(v) for label, r in row.items() if isinstance(r, dict)
                       for v in r.values()), f'[scripts18] {name}: {row}')
    out['wall_s'] = time.perf_counter() - t_phase
    print(f"[scripts18] {out['wall_s']:.1f} s", flush=True)
    return out


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
    # the kernels, one nvcc each, all at once; then, while the phases run,
    # the [lsb] phase's two measurement-only ablation variants of the
    # stashing backward (read there)
    from sunerf_tpu_torch.scripts.backward_ablation import VARIANTS
    builds = [(k, ()) for k in KERNELS]
    with ThreadPoolExecutor(len(builds)) as pool:
        built = list(pool.map(lambda b: build.build(*b), builds))
    variants = [('fused_mlp_stash_bwd', d) for _, d, _ in VARIANTS['lsb'] if d]
    variant_pool = ThreadPoolExecutor(len(variants))
    variant_builds = [variant_pool.submit(build.build, *v) for v in variants]
    _mark('build')
    print(f'[build] {", ".join(KERNELS)}: {time.perf_counter() - t0:.1f} s (parallel nvcc); '
          f'{len(variants)} ablation variants building meanwhile', flush=True)
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
            floor = _err_stats(ref[:n // 4], fused_mlp.fused_mlp_reference(
                cfg, {k: v.cpu() for k, v in p.items()}, pts[:n // 4].cpu()))
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

    _mark('kernel')
    stash_rows = {}
    with torch.no_grad():
        for name, n_layers, width, n in STASH_SHAPES:
            stash_rows[name] = _stash_phase(name, n_layers, width, n, device)
    torch.cuda.empty_cache()
    _mark('stash')

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
    _mark('render, golden, flyby')

    # 4a-4b. the serving export; the MHD field ------------------------------
    torch.cuda.empty_cache()
    export = _export_phase(device, loader, view)
    _mark('export')
    torch.cuda.empty_cache()
    mhd = _mhd_phase(device)
    _mark('mhd')

    train = _train_phase(device)
    _serve_phase(train.pop('renderer'), train.pop('state'))
    tune = _tune_phase(device, gview, g_fused)
    _mark('train, serve, tune')

    # 8-9. fields of any width up to 512; the wide route above it; the
    # Trainer through the CLI -----------------------------------------------
    torch.cuda.empty_cache()
    widths = _widths_phase(device)
    _mark('widths')
    torch.cuda.empty_cache()
    wide = _wide_phase(device)
    _mark('wide')
    torch.cuda.empty_cache()
    trainer = _trainer_phase(device, train)
    _mark('trainer')
    torch.cuda.empty_cache()
    dt = _dt_phase(device)
    _mark('dt')
    torch.cuda.empty_cache()
    thomson = _thomson_phase(device)
    _mark('thomson')

    # 7e-7g. the evaluation layer, the tiers and the occupancy grid ----------
    torch.cuda.empty_cache()
    evals = _eval_phase(device, plain_renderer, fields['fine'][0])
    _mark('eval')
    torch.cuda.empty_cache()
    tiers = _tiers_phase(device, trainer)
    _mark('tiers')
    torch.cuda.empty_cache()
    occupancy = _occupancy_phase(device, trainer)
    _mark('occupancy')

    # 7h. data parallel and microbatch ------------------------------------
    torch.cuda.empty_cache()
    dp = _dp_phase(device, trainer)
    _mark('dp')

    # 8-11. dense feature grids (K5) ----------------------------------------
    torch.cuda.empty_cache()
    with torch.no_grad():
        grid_rows = {name: _grid_kernel_phase(name, kw, n, device)
                     for name, kw, n in GRID_SHAPES}
    torch.cuda.empty_cache()
    _mark('grid')
    grid_train = _grid_train_phase(device)
    grid_serve = _grid_serve_phase(grid_train, device)
    for k in ('renderer', 'state', 'configs'):
        grid_train.pop(k)
    _mark('gridtrain, gridserve')
    torch.cuda.empty_cache()
    ngp = _ngp_phase(device)
    _mark('ngp')

    # 12-16. the other backward paths (K3, K4, K6a, K6b) ------------------
    torch.cuda.empty_cache()
    with torch.no_grad():
        dpts_rows = {'fine': _dpts_phase('fine', 8, 512, 1024 * 192, device),
                     'proposal': _dpts_phase('proposal', 4, 128, 1024 * 20, device),
                     'fine_d12': _dpts_phase('fine', 8, 512, 1024 * 192, device, d_input=12)}
    torch.cuda.empty_cache()
    _mark('dpts')
    recompute = _recompute_phase(262144, device)
    _mark('recompute')
    torch.cuda.empty_cache()
    for (name, defines), future in zip(variants, variant_builds):
        path, _ = future.result()
        print(f'[build] {" ".join((name,) + defines)}: {path}', flush=True)
    variant_pool.shutdown()
    with torch.no_grad():
        formats = {fmt: _format_phase(fmt, 262144, device) for fmt in ('lsb', 'i8pair')}
    _mark('lsb, i8pair')
    torch.cuda.empty_cache()
    bench = _bench_kernel_phase()
    _mark('bench_kernel')
    torch.cuda.empty_cache()
    probe = _probe_step_phase(device)
    _mark('probe_step')
    probe_launches = {str(r['knob']): r['launches'] for r in probe['rows']}

    # 17. the grid-encode probes (P1, P2) ------------------------------------
    torch.cuda.empty_cache()
    probes = _grid_probe_phase(device)
    _mark('grid_probes')

    # 18-21. serving on any card; the converter; prep; the psi_193 protocol ----
    torch.cuda.empty_cache()
    serve_cards = _serve_cards_phase(device, view)
    _mark('serve_cards')
    torch.cuda.empty_cache()
    snf = _snf_phase(device)
    _mark('snf')
    torch.cuda.empty_cache()
    prep = _prep_phase(device)
    _mark('prep')
    torch.cuda.empty_cache()
    psi = _psi_phase(device, plain_renderer)
    _mark('psi')

    # 22-25. the quality protocols, the probes, the first ablations ----------
    torch.cuda.empty_cache()
    with _deadline(PHASE_DEADLINE_S, '[dt_protocol]'):
        dt_proto = _dt_protocol_phase(device)
    _mark('dt_protocol')
    torch.cuda.empty_cache()
    with _deadline(PHASE_DEADLINE_S, '[thomson_protocol]'):
        thomson_proto = _thomson_protocol_phase(device)
    _mark('thomson_protocol')
    torch.cuda.empty_cache()
    with _deadline(PHASE_DEADLINE_S, '[probes]'):
        item_probes = _probes_phase(device)
    _mark('probes')
    torch.cuda.empty_cache()
    with _deadline(PHASE_DEADLINE_S, '[ablations]'):
        ablations = _ablations_phase(device)
    _mark('ablations')
    torch.cuda.empty_cache()
    with _deadline(PHASE_DEADLINE_S, '[scripts18]'):
        scripts18 = _scripts18_phase(device)
    _mark('scripts18')
    ablation_launches = {k: ablations[k]['launches'] for k in (
        'dt_ablation', 'occupancy_ablation', 'occupancy_value_case', 'eval_budget_sweep')}

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
        'eval': evals, 'tiered_render_launches': evals['tiered_render']['launches'],
        'tier_shapes': evals['tiered_render']['k0_shapes'],
        'occupancy_update': {k: occupancy[k] for k in ('update_ms', 'update_k0_launches',
                                                       'run_activity_err',
                                                       'bundle_activity_err', 'guided_render')},
        'dp_tiled_render': dp['e'],
        # the serving artifact's CUDA program: K0 through the registered op
        'artifact_launches': export['k0_launches']['served'],
        'artifact': {k: export[k] for k in (
            'export_s', 'artifact_bytes', 'graph', 'served_vs_live', 'k0_fine_samples',
            'render_256_ms', 'render_256_profile', 'points_64', 'tiered', 'probe_serving',
            'cpu_program')},
        'mhd': {k: mhd[k] for k in ('fixture_render_s', 'psi_field_mib', 'psi_frame_ms',
                                    'psi_frame_profile', 'psi_peak_gib', 'psi_f32_vs_f64',
                                    'export')},
        # the artifact mapped onto each card, a converted reference .snf, the
        # committed bundle scored on the psi_193 scene
        'serve_cards': serve_cards,
        'snf_launches': snf['k0_launches'], 'snf': snf,
        'psi_score_launches': psi['score_k0_launches'],
        'psi': {k: psi[k] for k in ('scene_s', 'score_s', 'scores', 'views', 'jax_recorded',
                                    'jax_label', 'h5py')},
        # the DT protocol's 90-frame score, the probes' forwards, the
        # ablations' validations and the budget sweep
        'dt_protocol_score_launches': dt_proto['score_k0_launches'],
        'dt_protocol': {k: dt_proto[k] for k in ('score_s', 'frames_checked', 'worst', 'scores',
                                                 'fault_flags')},
        'probe_launches': {
            'probe_kernel': item_probes['kernel']['plain fwd']['launches'],
            'probe_grid_kernel': {k: v['fwd'] for k, v in
                                  item_probes['grid_kernel']['launches'].items()},
            'probe_grid_encoding': item_probes['grid_encoding']['launches']},
        'ablation_launches': ablation_launches,
        'eval_budget_sweep': ablations['eval_budget_sweep'],
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
            'tier_launches': {k: r['launches'] for k, r in tiers['rows'].items()},
            'tier_shapes': {name: r[key] for name, r in tiers['shapes'].items()},
            'tiers': {'rows': tiers['rows'], 'trainer': tiers['trainer']} if key == 'k1' else None,
            'occupancy_trainer': occupancy if key == 'k1' else None,
            'dp_launches': {'mesh_1_rank': dp['a']['launches'],
                            'gloo_2_ranks': dp['b']['launches'],
                            'microbatch': dp['c']['launches'],
                            'trainer': dp['d']['launches']},
            'dp': dp if key == 'k1' else None,
            # run_emission on prepped raw frames; the psi_193 protocol's training
            'prep_launches': prep['launches'][{'k1': 'STASH_FWD_LAUNCHES',
                                               'k2': 'STASH_BWD_LAUNCHES'}[key]],
            'psi_protocol_launches': psi['protocol_launches'][{'k1': 'STASH_FWD_LAUNCHES',
                                                               'k2': 'STASH_BWD_LAUNCHES'}[key]],
            'prep': prep if key == 'k1' else None,
            # the DT and Thomson protocols' steps, the probes, the ablations
            'dt_protocol_launches': dt_proto['launches'][{'k1': K1, 'k2': K2}[key]],
            'thomson_protocol_launches_per_step':
                thomson_proto['row']['train_launches_per_step'][{'k1': K1, 'k2': K2}[key]],
            'ablation_launches': {k: v.get({'k1': K1, 'k2': K2}[key], 0)
                                  for k, v in ablation_launches.items()},
            'dt_protocol': {k: dt_proto[k] for k in ('protocol_s', 'ms_per_step', 'losses',
                                                     'row', 'launches')}
            if key == 'k1' else None,
            'thomson_protocol': thomson_proto if key == 'k1' else None,
            'probes': item_probes if key == 'k1' else None,
            'ablations': ablations if key == 'k1' else None,
            'psi_protocol': {k: psi[k] for k in ('protocol_s', 'protocol_ms_per_step',
                                                 'protocol_losses', 'protocol_row')}
            if key == 'k1' else None,
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
        'probe_launches': {
            'probe_grid_kernel': {k: v for k, v in item_probes['grid_kernel']['launches'].items()
                                  if K5 in v['step']},
            'probe_grid_step': item_probes['grid_step']['launches'],
            'probe_grid_kernel_names': item_probes['grid_kernels'],
            'dt_ablation': ablation_launches['dt_ablation'].get(K5, 0)},
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
    # the wide route: K0 on the converted 8x1024 field's frame (live), K1 and
    # K2 in its fine-tune, the other paths on their own [wide] runs
    wsnf, wpaths = wide['snf'], wide['paths']
    wide_sources = ['sunerf_tpu_torch/csrc/wide_mlp.cuh', 'sunerf_tpu_torch/csrc/fused_mlp_common.cuh']
    for key, kname, src, line, launches in (
            ('k0', 'wide_mlp_fwd (K0 wide)', 'wide_mlp_fwd.cu', 343, wsnf['live_launches'][K0W]),
            ('k1', 'wide_mlp_fwd (K1 wide)', 'wide_mlp_fwd.cu', 453, wsnf['tune_launches'][K1W]),
            ('k2', 'wide_mlp_bwd (K2 wide)', 'wide_mlp_bwd.cu', 533, wsnf['tune_launches'][K2W])):
        rows = {name: r[key] for name, r in wide['rows'].items()}
        top = rows['8x1024:2']
        kernels.append({
            'name': kname, 'route': 'cuda', 'source': f'sunerf_tpu_torch/csrc/{src}',
            'sources': [f'sunerf_tpu_torch/csrc/{src}', *wide_sources],
            'replaces': f'sunerf_tpu/ops/pallas/fused_mlp.py:{line}',
            'replaces_where': 'd_filter above 512 or d_output outside the fused heads',
            'launches': launches,
            'max_abs_err': max(r['max_abs_err'] for r in rows.values()),
            'max_rel_err': max(r['max_rel_err'] for r in rows.values()),
            'ms': top['ms'], 'plain_ms': top['plain_ms'], 'bound_ms': top['bound_ms'],
            'bound_by': top['bound_by'], 'library_ms': top['library_ms'],
            'library': 'one bf16 torch.matmul a layer product at the same shapes',
            'shapes': rows,
            **({'coarse_8x1024': wide['rows']['8x1024:2'][f'{key}_coarse']} if key != 'k0' else
               {'snf': wsnf}),
        })
    for name, kname, src, line, counted in (
            ('K3', 'dpts_kernel (K3 wide)', 'wide_mlp_bwd.cu', 646, 'dpts_kernel (K3)'),
            ('K4', 'wide_mlp_fwd/bwd recompute (K4 wide)', 'wide_mlp_bwd.cu', 834, 'wide_bwd (K4)'),
            ('K6a', "wide_mlp_fwd/bwd 'lsb' (K6a wide)", 'wide_mlp_fwd.cu', 481, 'wide_bwd (K6a)'),
            ('K6b', "wide_mlp_fwd/bwd 'i8pair' (K6b wide)", 'wide_mlp_bwd.cu', 503, I8W),
            ('K5', 'grid branch of the wide route (K5 wide)', 'wide_mlp_bwd.cu', 313,
             'grid_max_kernel (K5)')):
        r = wpaths[name]
        kernels.append({
            'name': kname, 'route': 'cuda', 'source': f'sunerf_tpu_torch/csrc/{src}',
            'sources': ['sunerf_tpu_torch/csrc/wide_mlp_fwd.cu',
                        'sunerf_tpu_torch/csrc/wide_mlp_bwd.cu', *wide_sources],
            'replaces': f'sunerf_tpu/ops/pallas/fused_mlp.py:{line}',
            'replaces_where': 'd_filter above 512 or d_output outside the fused heads',
            'launches': r['launches'][counted], 'max_abs_err': r['max_abs_err'],
            'max_rel_err': r['max_rel_err'], 'ms': r['ms'], 'plain_ms': r['plain_ms'],
            'bound_ms': r['bound_ms'], 'bound_by': r['bound_by'], 'library_ms': r['library_ms'],
            'library': 'one bf16 torch.matmul a layer product at the same shapes',
            'timed': 'forward + backward under autograd at 2x640, N = 65,536',
            'detail': r})
        if name == 'K6b':
            # the slice's full-width path: 8x1024 / d_output 2, N = 196,608
            k6b = wide['i8pair_8x1024']
            kernels[-1].update({
                'launches': k6b['launches'][I8W], 'max_abs_err': k6b['max_abs_err'],
                'max_rel_err': k6b['max_rel_err'], 'ms': k6b['ms'], 'plain_ms': k6b['plain_ms'],
                'bound_ms': k6b['bound_ms'], 'bound_by': k6b['bound_by'],
                'library_ms': k6b['library_ms'],
                'timed': 'forward + backward under autograd at 8x1024 / d_output 2, N = 196,608, '
                         'group 768',
                'dw_h_library': k6b['dw_h_library'], 'at_2x640': r,
                'groups_2x640': wide['i8pair_groups'], 'detail': k6b})
    kernels[-1]['scripts18'] = scripts18
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
