// Stashing backward of the fused posenc + Sine MLP for Hopper (sm_90a): K2,
// with the point cotangent K3 and the 'lsb' / 'i8pair' formats K6a / K6b.
//
// Replaces the TPU kernel sunerf_tpu/ops/pallas/fused_mlp.py:_bwd_stash_kernel
// (the training backward; pallas_call in _fused_mlp_stash_bwd). Same
// function, with its roundings: from dy [N, d_out] and the forward's stash,
//   dW_out = hs_{L-1}^T bf16(dy),  db_out = sum(dy)                  (f32)
//   dh     = bf16(dy) bf16(W_out)^T
//   for j = L-1 .. 0:
//     dz_j = bf16(bf16(dh) * gate_j)     (gate: the layer's cos, below)
//     db_j = sum over points of dz_j (f32)
//     dW_j = hs_{j-1}^T dz_j for j >= 1 (the hidden layers),
//            bf16(enc)^T dz_0 for j = 0 (enc recomputed from the points
//            as the forward computes it)
//     dh   = dz_j bf16(W_h[j-1])^T for j >= 1
// every product with bf16 operands and f32 accumulation. By format:
//   'int8' (K2): hs is K1's bf16 sin, gate_j = bf16(bf16(cs_j) * bf16(1/127));
//   'lsb' (K6a, the lsb branch :606-609): hs is the packed bf16 sin itself,
//       LSB included, and gate_j = bf16(sign * sqrt(max(1 - hs_j^2, 0))) in
//       f32, the sign its last bit;
//   'i8pair' (K6b, :580-601): hs_j = bf16(bf16(sin8_j) * bf16(1/127)) (dW_out)
//       and gate_j the same of cos8_j; dW_h[j-1] on the int8 tensor cores:
//       per group of `group` points (the TPU kernel's backward tile, 768 by
//       default; any group from 1 to 133,144 = (2^31 - 1) / 127^2, so the
//       int32 sums cannot overflow) dz_j is quantized to int8 with scale
//       127 / max|dz_j| over the group, and the group's exact int32 sum
//       sin8^T dz8 is scaled by max * (1/127)^2 in f32.
// compute_dpts (K3, :634-635, :646-655) adds the point cotangent
//   dpts = denc_x + (cos u dsin - sin u dcos) K^T,  denc = dz_0 bf16(W_in)^T
// over the x, sin and cos columns; the parameter gradients are the same
// bits with and without it (it only adds an output).
//
// Bound on this card: operations. Per point at 8x512: 4*7*512^2 flop for
// dW_h and dh, 2*84*512 for dW_in, 2*2*2*512 for dW_out and the first dh;
// 7.43 Mflop, 1.477 ms at the fine step's N = 196,608 at 989 TFLOP/s bf16
// dense, against 0.722 ms to read the int8 format's stashes at 3.35 TB/s.
// K3 adds denc, 2*84*512 flop per point (0.017 ms). 'i8pair' moves dW_h's
// 2*7*512^2 flop per point to the int8 rate (1,979 TOP/s).
//
// Design. On the TPU the grid runs in order and every dW accumulates in VMEM
// across it (7.3 MB of f32 for dW_h alone at 8x512), flushed once. On Hopper
// blocks run in parallel and no block can hold the dW, so the backward is
// two passes over the points (fused_mlp_backward.cuh): the chain kernel,
// which carries dz down the layers on wgmma in K0's design (64-point tiles,
// two warpgroups, dz in place in shared memory, W_h's chunks through a
// bulk-copy ring with the layer's int8 gate tile in the stage after them)
// and stores every dz_j to a scratch [tiles][L][64 x H] (1.6 GB at the fine
// shape) tile by tile in its core-matrix order, by one bulk copy a tile and
// layer; then the dW kernel, wgmma products over the points (A the stash
// rows by ldmatrix.trans, B the dz tiles MN-major) in work items of a split,
// a job and a 128 x TN output tile, and fixed-order reductions. Bytes of
// this two-pass design at the fine shape: the chain reads the gates (0.81
// GB) and hs_{L-1} and writes dz (1.61 GB), 0.79 ms; the dW kernel reads hs
// (1.41 GB) and dz, 0.90 ms: a floor of about 1.69 ms, above the operations
// bound. The gate and dz streams carry an L2 evict-first policy, the
// weights evict-last. K3 is the chain kernel's tail (point_cotangent):
// denc = dz_0 W_in^T as one more product against pack_wgmma_dpts's chunks
// through the same ring, all of a chunk's stages issued before one wait,
// its columns ordered by dimension so each thread sums whole groups of one
// dimension and the groups are added into dpts in column order: any
// d_input, the same bits every run. Where each of its 16 k-chunks at 8x512
// waited for its product, and each accumulator element summed its term
// into one of 8 per-dimension registers by a predicated loop (d_input <= 8),
// K3 cost 0.362 ms of the chain kernel at the fine step's N = 196,608, its
// epilogue 0.238 of them (scripts/backward_ablation.py --fmt dpts, H100
// 80GB HBM3, 700 W).
// 'i8pair' (K6b): the chain kernel also writes each point's max |dz_j| (two
// partial maxima a point from its epilogue's accumulators, 15 MB at 8x512,
// N = 262,144, read back in place of dz's 1.9 GB), a small
// kernel reduces them to each group's, and dw_i8_wgmma_kernel takes dW_h
// on wgmma m64nTNk32 s32.s8.s8: 8-bit operands must be K-major (the
// points), and both the stash (a point's H columns contiguous) and the dz
// scratch hold the output columns contiguous, so its two consumer
// warpgroups transpose each 64-point chunk in shared memory, quantizing dz
// on the way, before the products (byte permutes, one barrier a chunk,
// three operand buffers). The dW_h floor at the int8 rate is 0.49 ms at
// N = 262,144; reading sin8 (0.94 GB) and dz (1.88 GB) once is 0.84 ms, and
// the 128 x 128 output tiles read them 4 times each through L2. dW_in goes
// through the wgmma dW kernel.
//
// 'lsb' (K6a) and K4's bf16 gate come through the weight ring as K2's int8
// gate does: two stages of [32 rows][64 columns] 128-byte swizzled TMA
// boxes, prefetched into L2 a layer ahead. The 'lsb' sines are decoded in
// place in those stages while the layer's last two chunks' products run,
// by a 1 KB table of the 512 values where the decode is neither 1 nor 0
// (lsb_cos_table, built from lsb_cos_bits by the block); the epilogue then
// reads a bf16 gate. The earlier design read both gates from device memory in
// the epilogue: at 8x512, N = 262,144 its 'lsb' chain took 8.99 ms, 4.51
// with the gate loaded but not decoded and 4.90 decoded but not loaded
// (scripts/backward_ablation.py, H100 80GB HBM3, 700 W), against 3.57 for
// the int8 gate through the ring; through the ring with a square root a
// gate element, 6.47, 3.43 and 5.62.
//
// K5, the dense feature-grid branch (fused_mlp.py:564-576, :634-644): the
// recomputed encoding carries the grid features (so dW_in covers their
// rows), and the table gradients are
//   denc_grid = dz_0 bf16(W_in[grid rows])^T        [N, levels * F], f32
//   d_table[level][row(corner), f] += w(corner) * denc_grid[n, level F + f]
// over the 8 corners of each point's cell. The TPU form contracts one-hot
// hat rows over the points on the MXU (65.5 kflop per point at G = 16,
// 0.52 Mflop at G = 32); here the products are a scatter, and a scatter's
// float atomics would sum in a different order each run. So it sums in
// 64-bit fixed point instead, where addition is exact and the order does
// not matter: the chain kernel writes denc_grid and each level's max |.|
// m; grid_scatter_kernel adds round(w * d * 2^k) with integer atomics, k
// chosen so that N such terms of size <= m cannot overflow
// (k = 62 - ceil(log2 N) - e, m < 2^e: resolution m * N * 2^-62, far below
// f32's); grid_convert_kernel turns the sums back into f32. The gradients
// are bit-identical run to run, and within f32 rounding of the plain
// version's float32 index_add. Grid configs take the 'int8' format and no
// point cotangent, as in the JAX package; any number of levels, each a
// descriptor (table, G, offset into d_table) in a device array.
// Bound: the grid's own work is tiny (0.0034 ms of operations at the NGP
// recipe); what it costs is latency and traffic around the MLP's. At the
// NGP recipe (8x512, levels 16 + 32, F = 8, N = 196,608) the first design
// added 1.01 ms to K2 (H100 80GB HBM3, 700 W; PERF.md): the grid
// cotangent summed on the CUDA cores in the chain kernel's tail (+0.41),
// the scatter a thread a term, 25.2 M threads each recomputing its cell
// (0.26), and prep's features a scalar L2 load a corner (+0.08). Now: the
// cotangent is a wgmma product from one ring stage a 32 columns
// (pack_wgmma_grid), db_0's sums under it; the scatter a quad of lanes a
// (point, level), a warp's equal rows merged before the reds; prep's
// features a (point, level) a thread, rows as 16-byte vectors.

#include "fused_mlp_backward.cuh"

// C entry, bound with ctypes: the launches of one backward on `stream`.
// fmt: 0 'int8' (hs bf16 sin, cs int8 cos), 1 'lsb' (hs packed bf16, cs
// unused), 2 'i8pair' (hs the int8 pairs, cs unused). w_bwd is
// pack_wgmma_bwd's chunks, w_dpts pack_wgmma_dpts's (K3) or null; dz the
// scratch [tiles][L][64 x H]; the dW work is `splits` point ranges of
// `pps` points, with part_dw [splits][e_pad H + (L-1) H^2]; for 'i8pair'
// part_dw is dW_in's [splits][e_pad H], then the int8 dW_h's
// [splits8][(L-1) H^2] over `splits8` ranges of `pps8` points (whole groups
// and tiles), with dz_rowmax [L-1][n][2] and dz_max [groups][L-1] scratch
// (pps8, splits8, dz_rowmax and dz_max are ignored for the other formats).
// dpts null: no point cotangent; else w_dpts, dpts_pairs and dpts_gdim are
// pack_wgmma_dpts's pack and tables over dpts_cols columns. grid a
// GridParams (its levels a device array of descriptors) or null; w_grid
// pack_wgmma_grid's chunks, dgrid [n, levels F], gmax [levels] and gacc
// [sum G^3 F] zeroed, grad_grid [sum G^3 F]. Returns a
// cudaError_t (0 = launched).
extern "C" int sunerf_fused_mlp_stash_bwd(
    const void* pts, const void* col_dim, const void* col_freq, const void* dy,
    const void* hs, const void* cs, const void* w_bwd, const void* w_out,
    void* dz, void* enc, void* part_chain, void* part_dw, void* grad_chain,
    void* grad_dw, const void* grid, const void* w_grid, void* dgrid, void* gmax,
    void* gacc, void* grad_grid, void* dpts, const void* w_dpts, const void* dpts_pairs,
    const void* dpts_gdim, void* dz_rowmax, void* dz_max, int n, int d_in, int n_cols,
    int e_pad, int d_filter, int n_hidden, int d_out, int pps, int splits, int pps8,
    int splits8, int fmt, int group, int dpts_cols, void* stream) {
  using namespace sunerf;
  BwdParams p{};
  p.grid = grid_params(grid);
  const int L = n_hidden + 1;
  const size_t ld = static_cast<size_t>(L) * d_filter;
  p.pts = static_cast<const float*>(pts);
  p.col_dim = static_cast<const int*>(col_dim);
  p.col_freq = static_cast<const float*>(col_freq);
  p.dy = static_cast<const float*>(dy);
  if (fmt == 2) {
    p.hs8 = static_cast<const int8_t*>(hs);
    p.gate = static_cast<const int8_t*>(hs) + d_filter;
    p.gate_ld = 2 * ld;
    p.gate_layer = 2 * d_filter;
  } else {
    p.hs = static_cast<const __nv_bfloat16*>(hs);
    p.gate = fmt == 1 ? hs : cs;
    p.gate_ld = ld;
    p.gate_layer = d_filter;
  }
  p.w_bwd = static_cast<const __nv_bfloat16*>(w_bwd);
  p.w_dpts = static_cast<const __nv_bfloat16*>(w_dpts);
  p.w_out = static_cast<const __nv_bfloat16*>(w_out);
  p.dz = static_cast<__nv_bfloat16*>(dz);
  p.enc = static_cast<__nv_bfloat16*>(enc);
  p.part_chain = static_cast<float*>(part_chain);
  p.part_dw = static_cast<float*>(part_dw);
  p.grad_chain = static_cast<float*>(grad_chain);
  p.grad_dw = static_cast<float*>(grad_dw);
  p.w_grid = static_cast<const __nv_bfloat16*>(w_grid);
  p.dgrid = static_cast<float*>(dgrid);
  p.gmax = static_cast<unsigned int*>(gmax);
  p.gacc = static_cast<unsigned long long*>(gacc);
  p.grad_grid = static_cast<float*>(grad_grid);
  p.dpts = static_cast<float*>(dpts);
  p.dpts_pairs = static_cast<const int*>(dpts_pairs);
  p.dpts_gdim = static_cast<const int*>(dpts_gdim);
  p.dpts_cols = dpts_cols;
  p.dz_rowmax = static_cast<float*>(dz_rowmax);
  p.dz_max = static_cast<float*>(dz_max);
  p.group = group;
  p.n = n;
  p.d_in = d_in;
  p.n_cols = n_cols;
  p.e_pad = e_pad;
  p.h = d_filter;
  p.n_hidden = n_hidden;
  p.d_out = d_out;
  p.pps = pps;
  p.splits = splits;
  p.pps8 = pps8;
  p.splits8 = splits8;
  set_sizes(p);
  if (fmt == 2) p.part_i8 = p.part_dw + static_cast<size_t>(splits) * p.dw_ld;
  const bool grid_bad = p.grid.n_levels > 0 &&
      (w_grid == nullptr || dgrid == nullptr || gmax == nullptr || gacc == nullptr ||
       grad_grid == nullptr || fmt != 0 || dpts != nullptr);
  if (!bwd_ok(p) || !grid_ok(p.grid) || grid_bad || fmt < 0 || fmt > 2 ||
      e_pad < d_in + 2 * n_cols + p.grid.n_levels * p.grid.features || w_bwd == nullptr ||
      (fmt == 2 && (group < 1 || group > 133144 || dz_rowmax == nullptr || dz_max == nullptr ||
                    splits8 < 1 || pps8 < 1 || pps8 % kRows != 0 || pps8 % group != 0 ||
                    static_cast<long long>(splits8) * pps8 < n)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = set_maps(p, fmt != 1);
  if (err != cudaSuccess) return static_cast<int>(err);

  const bool with_dpts = dpts != nullptr;
  if (fmt == 1)
    err = with_dpts ? launch_chain_width<kGateLsb, true>(p, s)
                    : launch_chain_width<kGateLsb, false>(p, s);
  else if (fmt == 2)
    err = with_dpts ? launch_chain_width<kGateI8pair, true>(p, s)
                    : launch_chain_width<kGateI8pair, false>(p, s);
  else
    err = with_dpts ? launch_chain_width<kGateInt8, true>(p, s)
                    : launch_chain_width<kGateInt8, false>(p, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_after_chain(p, s));
}

// C entry: K5's kernels launched by this library since it was loaded into
// out[3] (prep_grid_kernel, grid_scatter_kernel, grid_convert_kernel), as
// the launchers count them. Returns 0.
extern "C" int sunerf_kernel_launches(long long* out) {
  for (int i = 0; i < 3; ++i) out[i] = static_cast<long long>(sunerf::grid_kernel_launches[i]);
  return 0;
}

// C entry: the 'lsb' gate decode of the chain kernel on n packed sines
// (int16 bits in, bf16 bits out) on `stream`, for the card's check of it on
// every pattern. Returns a cudaError_t (0 = launched).
extern "C" int sunerf_lsb_decode(const void* in, void* out, int n, void* stream) {
  using namespace sunerf;
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  lsb_decode_kernel<<<(n + kConsumers - 1) / kConsumers, kConsumers, 0,
                      static_cast<cudaStream_t>(stream)>>>(static_cast<const uint16_t*>(in),
                                                            static_cast<uint16_t*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

// C entry: K5's scatter and conversion alone (grid_scatter_kernel, then
// grid_convert_kernel, counted as above) for a grid cotangent made
// elsewhere, the wide route's (ops/wide_mlp.py): pts [n, d_in], dgrid
// [n, levels F] f32, gmax [levels] each level's max |dgrid| as float bits,
// gacc [sum G^3 F] zeroed, grad_grid [sum G^3 F] out; grid a GridParams.
// Returns a cudaError_t (0 = launched).
extern "C" int sunerf_grid_scatter(const void* pts, const void* dgrid, void* gmax, void* gacc,
                                   void* grad_grid, const void* grid, int n, int d_in,
                                   void* stream) {
  using namespace sunerf;
  BwdParams p{};
  p.pts = static_cast<const float*>(pts);
  p.dgrid = static_cast<float*>(const_cast<void*>(dgrid));
  p.gmax = static_cast<unsigned int*>(gmax);
  p.gacc = static_cast<unsigned long long*>(gacc);
  p.grad_grid = static_cast<float*>(grad_grid);
  p.grid = grid_params(grid);
  p.n = n;
  p.d_in = d_in;
  if (n < 1 || p.grid.n_levels < 1 || !grid_ok(p.grid)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int e_n = 0;
  while ((1LL << e_n) < n) ++e_n;
  const long long lanes = static_cast<long long>(n) * p.grid.n_levels * kScatterLanes;
  grid_scatter_kernel<<<static_cast<unsigned>((lanes + 255) / 256), 256, 0, s>>>(p, e_n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ++grid_kernel_launches[1];
  grid_convert_kernel<<<static_cast<unsigned>((p.grid.total + 255) / 256), 256, 0, s>>>(p, e_n);
  err = cudaGetLastError();
  if (err == cudaSuccess) ++grid_kernel_launches[2];
  return static_cast<int>(err);
}
