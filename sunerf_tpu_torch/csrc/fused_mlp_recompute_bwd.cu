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
// cotangent dpts = denc_x + (cos u dsin - sin u dcos) K^T of K3. No grid
// levels: the TPU kernel has no d_table path (:911-915).
//
// Bound on this card: operations. Per point at 8x512: the forward's
// 3.76 Mflop plus the backward's 7.43 (K2's, with K3's denc), 11.2 Mflop;
// 2.99 ms at N = 262,144 at 989 TFLOP/s bf16 dense. It reads the points and
// dy and writes dpts (32 bytes a point), so bytes never bind.
//
// Design. On the TPU each tile recomputes its activations into VMEM and
// backpropagates them at once; a 64-point block's sin and cos at 8x512
// (1 MB) do not fit in shared memory here. So the points are walked in
// chunks of `chunk` (32,768 from the wrapper): for each chunk the wgmma
// forward (fused_mlp_fwd_wgmma.cuh with kStashBf16Cos: K0's kernel writing
// the bf16 sin and cos from its epilogue) fills chunk-sized scratch, then
// K2's launches run over the chunk with the bf16 gate read in the epilogue
// (chain_wgmma_kernel<H, kGateBf16, true> and the wgmma dW kernel,
// fused_mlp_backward.cuh), and the two reductions add the chunk's partials
// to the running gradients, chunk after chunk in order, so a run gives the
// same bits as the last. The scratch (hs, cs and dz: 3 * 8 KB a point at
// 8x512, 768 MB per chunk of 32,768, plus the encoding and the partials)
// does not grow with N; the stashing path's stashes and dz scratch are 20 KB
// a point. The forward of the autograd Function is K0 itself, so the output
// under grad is the no-grad render's, bit for bit.

#include "fused_mlp_backward.cuh"
#include "fused_mlp_fwd_wgmma.cuh"

// C entry, bound with ctypes: the chunks' launches of one backward on
// `stream` (per chunk: the recompute forward, the chain kernel, the dW
// products and the two accumulating reductions). w_fwd is pack_wgmma's
// chunks, w_bwd pack_wgmma_bwd's, w_dpts pack_wgmma_dpts's; the dW work of
// a chunk is `splits` ranges of `pps` points. Returns a cudaError_t
// (0 = launched).
extern "C" int sunerf_fused_mlp_recompute_bwd(
    const void* pts, const void* col_dim, const void* col_freq, const void* w_fwd,
    const void* b_in, const void* b_h, const void* b_out, const void* dy, const void* w_bwd,
    const void* w_dpts, const void* w_out, void* hs, void* cs, void* out, void* dz,
    void* enc, void* part_chain, void* part_dw, void* grad_chain, void* grad_dw,
    void* dpts, int n, int d_in, int n_cols, int e_pad, int d_filter, int n_hidden,
    int d_out, int pps, int splits, int chunk, void* stream) {
  using namespace sunerf;
  const size_t ld = static_cast<size_t>(n_hidden + 1) * d_filter;
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
  p.w_out = static_cast<const __nv_bfloat16*>(w_out);
  p.dz = static_cast<__nv_bfloat16*>(dz);
  p.enc = static_cast<__nv_bfloat16*>(enc);
  p.part_chain = static_cast<float*>(part_chain);
  p.part_dw = static_cast<float*>(part_dw);
  p.grad_chain = static_cast<float*>(grad_chain);
  p.grad_dw = static_cast<float*>(grad_dw);
  p.n_enc = d_in + 2 * n_cols;
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
      w_bwd == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);

  for (int c0 = 0; c0 < n; c0 += chunk) {
    const int m = n - c0 < chunk ? n - c0 : chunk;
    f.pts = static_cast<const float*>(pts) + static_cast<size_t>(c0) * d_in;
    f.n = m;
    cudaError_t err = fwd::launch<kStashBf16Cos>(f, e_pad, d_filter, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    p.pts = f.pts;
    p.dy = static_cast<const float*>(dy) + static_cast<size_t>(c0) * d_out;
    p.dpts = static_cast<float*>(dpts) + static_cast<size_t>(c0) * d_in;
    p.n = m;
    err = set_maps(p, false);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = launch_chain_width<kGateBf16, true>(p, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = launch_after_chain(p, c0 > 0, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
