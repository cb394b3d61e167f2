// Recompute backward of the fused posenc + Sine MLP for Hopper (sm_90a): K4.
//
// Replaces the TPU kernel sunerf_tpu/ops/pallas/fused_mlp.py:_bwd_kernel
// (pallas_call in _fused_mlp_bwd): the backward of the custom_vjp whose
// primal is K0 (stash=False), for large N without activation memory. Same
// function: per point, the forward again with each layer's
//   hs_i = bf16(sin y_i),  cs_i = bf16(cos10(y_i))
// (fast_sincos: the degree-11 sine and the degree-10 even cos polynomial of
// one range-reduced pre-activation y_i), then K2's gradient math with the
// bf16 cos as the gate (dz_j = bf16(bf16(dh) * cs_j)) and the point
// cotangent dpts = denc_x + (cos u dsin - sin u dcos) K^T of K3, for any
// d_input. No grid levels: the TPU kernel has no d_table path (:911-915).
//
// Bound on this card: operations. Per point at 8x512: the forward's
// 3.76 Mflop plus the backward's 7.43 (K2's, with K3's denc), 11.2 Mflop;
// 2.99 ms at N = 262,144 at 989 TFLOP/s bf16 dense. It reads the points and
// dy and writes dpts (32 bytes a point); the chunked design below moves
// 48 KB a point through device memory (the forward writes hs and cs, the
// chain reads cs and writes dz, the dW kernel reads hs and dz): 12.9 GB,
// a floor of 3.85 ms at 3.35 TB/s, above the operations bound.
//
// Design. On the TPU each tile recomputes its activations into VMEM and
// backpropagates them at once; a 64-point block's sin and cos at 8x512
// (1 MB) do not fit in shared memory here, and the dW products need many
// points per pass over their 8 MB of f32 sums. So the points are walked in
// chunks of `chunk` (32,768 from the wrapper). For each chunk:
//   * the wgmma forward (fused_mlp_fwd_wgmma.cuh, kStashBf16Cos) fills
//     chunk-sized scratch: its activation buffer and its cos staging tile
//     lie in the 128-byte swizzle, and after each layer's epilogue one
//     thread hands both to the copy engine as 2-D TMA tensor stores, boxes
//     [64 rows][64 columns], which run under the next layer's products (the
//     wait for their reads comes just before the next epilogue writes the
//     tiles); with those two 64 KB tiles its weights stream through 16-row
//     ring chunks, 6 stages at H = 512. The consumer threads' own 16-byte
//     copies of the stash, which the next layer's products waited for, took
//     1.39 ms of the 5.41 that 8 such forwards took at 8x512, N = 262,144;
//     the 3 stages of 32-row chunks left beside the two tiles most of the
//     rest (the forward without any stores took 4.02 ms, K0's work about
//     2.2) (scripts/backward_ablation.py --fmt recompute, H100 80GB HBM3,
//     700 W);
//   * prep_kernel, the chain kernel with the bf16 gate through its weight
//     ring (chain_wgmma_kernel<H, kGateBf16, true>, K3's tail included) and
//     the wgmma dW kernel run over the chunk (fused_mlp_backward.cuh);
//   * their per-tile and per-split f32 partials are not reduced: each slot
//     adds the chunk's sum to what it holds (BwdParams::acc_parts), chunk
//     after chunk in order, and one pair of reductions after the last chunk
//     takes the slots, where 16 reductions re-read them every chunk (0.81 ms
//     at 8x512, N = 262,144). A run gives the same bits as the last.
// The scratch (hs, cs and dz: 3 * 8 KB a point at 8x512, 768 MB per chunk
// of 32,768, plus the encoding and the partials) does not grow with N; the
// stashing path's stashes and dz scratch are 20 KB a point. Each launch
// holds every SM with one block of nearly all its shared memory, so a
// second stream could overlap chunks only at the kernels' tails; the
// chunks run in one stream. The forward of the autograd Function is K0
// itself, so the output under grad is the no-grad render's, bit for bit.

#include "fused_mlp_backward.cuh"
#include "fused_mlp_fwd_wgmma.cuh"

// C entry, bound with ctypes: the chunks' launches of one backward on
// `stream` (per chunk: the recompute forward, prep, the chain kernel and the
// dW products; then the two reductions). w_fwd is pack_wgmma's chunks, w_bwd
// pack_wgmma_bwd's, w_dpts, dpts_pairs and dpts_gdim pack_wgmma_dpts's over
// dpts_cols columns; the dW work of a chunk is `splits` ranges of `pps`
// points. Returns a cudaError_t (0 = launched).
extern "C" int sunerf_fused_mlp_recompute_bwd(
    const void* pts, const void* col_dim, const void* col_freq, const void* w_fwd,
    const void* b_in, const void* b_h, const void* b_out, const void* dy, const void* w_bwd,
    const void* w_dpts, const void* dpts_pairs, const void* dpts_gdim, const void* w_out,
    void* hs, void* cs, void* out, void* dz, void* enc, void* part_chain, void* part_dw,
    void* grad_chain, void* grad_dw, void* dpts, int n, int d_in, int n_cols, int e_pad,
    int d_filter, int n_hidden, int d_out, int pps, int splits, int chunk, int dpts_cols,
    void* stream) {
  using namespace sunerf;
  const int L = n_hidden + 1;
  const size_t ld = static_cast<size_t>(L) * d_filter;
  fwd::Params f{};
  f.col_dim = static_cast<const int*>(col_dim);
  f.col_freq = static_cast<const float*>(col_freq);
  f.w = static_cast<const __nv_bfloat16*>(w_fwd);
  f.b_in = static_cast<const float*>(b_in);
  f.b_h = static_cast<const float*>(b_h);
  f.b_out = static_cast<const float*>(b_out);
  f.out = static_cast<float*>(out);
  f.hs = hs;
  f.cs = cs;
  f.d_in = d_in;
  f.n_cols = n_cols;
  f.n_hidden = n_hidden;
  f.d_out = d_out;

  BwdParams p{};
  p.col_dim = f.col_dim;
  p.col_freq = f.col_freq;
  p.hs = static_cast<const __nv_bfloat16*>(hs);
  p.gate = cs;
  p.gate_ld = ld;
  p.gate_layer = d_filter;
  p.w_bwd = static_cast<const __nv_bfloat16*>(w_bwd);
  p.w_dpts = static_cast<const __nv_bfloat16*>(w_dpts);
  p.dpts_pairs = static_cast<const int*>(dpts_pairs);
  p.dpts_gdim = static_cast<const int*>(dpts_gdim);
  p.dpts_cols = dpts_cols;
  p.w_out = static_cast<const __nv_bfloat16*>(w_out);
  p.dz = static_cast<__nv_bfloat16*>(dz);
  p.enc = static_cast<__nv_bfloat16*>(enc);
  p.part_chain = static_cast<float*>(part_chain);
  p.part_dw = static_cast<float*>(part_dw);
  p.grad_chain = static_cast<float*>(grad_chain);
  p.grad_dw = static_cast<float*>(grad_dw);
  p.d_in = d_in;
  p.n_cols = n_cols;
  p.e_pad = e_pad;
  p.h = d_filter;
  p.n_hidden = n_hidden;
  p.d_out = d_out;
  p.pps = pps;
  p.splits = splits;
  p.n = n < chunk ? n : chunk;
  p.dpts = static_cast<float*>(dpts);
  set_sizes(p);
  if (chunk <= 0 || chunk % kRows != 0 || !bwd_ok(p) || e_pad < d_in + 2 * n_cols ||
      w_bwd == nullptr || d_filter % 64 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the first chunk writes every tile slot and split of the partials
  const int slots = (p.n + kRows - 1) / kRows;

  for (int c0 = 0; c0 < n; c0 += chunk) {
    const int m = n - c0 < chunk ? n - c0 : chunk;
    f.pts = static_cast<const float*>(pts) + static_cast<size_t>(c0) * d_in;
    f.n = m;
    // the stashes' tensor maps: the forward's boxes [64 rows][64 columns]
    // are the dW kernel's A boxes and half the chain's gate boxes
    cudaError_t err = hp::encode_2d(&f.hs_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, hs, ld, m,
                                    ld * 2, 64, kRows, true);
    if (err == cudaSuccess)
      err = hp::encode_2d(&f.cs_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, cs, ld, m, ld * 2, 64,
                          kRows, true);
    if (err == cudaSuccess) err = fwd::launch<kStashBf16Cos>(f, e_pad, d_filter, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    p.pts = f.pts;
    p.dy = static_cast<const float*>(dy) + static_cast<size_t>(c0) * d_out;
    p.dpts = static_cast<float*>(dpts) + static_cast<size_t>(c0) * d_in;
    p.n = m;
    p.acc_parts = c0 > 0;
    err = set_maps(p, false);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = launch_chain_width<kGateBf16, true>(p, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = launch_dw(p, L, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (SUNERF_ABLATION == 7) return 0;
  return static_cast<int>(launch_reductions(p, slots, s));
}
