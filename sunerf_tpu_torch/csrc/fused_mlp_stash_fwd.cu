// Stashing forward of the fused posenc + Sine MLP for Hopper (sm_90a): K1.
//
// Replaces the TPU kernel sunerf_tpu/ops/pallas/fused_mlp.py:_fwd_stash_kernel
// with the 'int8' stash (the training forward; pallas_call in
// _fused_mlp_stash_fwd). Same function: K0's output (fused_mlp_fwd.cu), plus,
// for every Sine layer i of L, with z_i its pre-activation and y_i the
// range-reduced z_i that the sine also uses,
//   hs[:, i*H:(i+1)*H] = bf16(sin y_i)   — the same bf16 value that feeds
//                                          layer i+1's product,
//   cs[:, i*H:(i+1)*H] = int8(round_half_even(127 * cos8(y_i)))
// with cos8 the TPU kernel's degree-8 even polynomial (fast_sincos_q). Both
// stashes are [N, L*H] row-major, the TPU kernel's layout; the backward K2
// (fused_mlp_stash_bwd.cu) reads them. Dense grid levels (K5) enter the
// encoding as in K0 (fused_mlp_fwd.cu).
//
// Bound on this card: both nearly equal at 8x512. Operations: 2*N*H*(E +
// (L-1)*H + d_out) flop, 3.76 Mflop per point, 0.747 ms at the fine step's
// N = 196,608 at 989 TFLOP/s bf16 dense. Bytes: the stashes write 3*L*H =
// 12,288 bytes per point, 0.722 ms at 3.35 TB/s.
// Design: K0's kernel (fused_mlp_fwd_kernel<H, true> in fused_mlp_common.cuh)
// with two stores per layer. The epilogue writes the bf16 sines into the
// next activation buffer, as K0 does, and the int8 cosines into one of two
// staging tiles [64, H + 16] in shared memory (+66 KB, 200 KB in all at
// H = 512); then the bulk-copy (TMA) engine copies both tiles to the
// stashes, one cp.async.bulk per row, while the warps go on to the next
// layer's products. The two staging tiles keep K0's one barrier a layer.
// Every block re-reads the weights (3.7 MB bf16 at 8x512) from L2, so the
// stash rows go out under an L2 evict-first policy and the weights load
// under evict-last: without the policies the 2.4 GB stash stream evicted
// the weights, and K1 took 4.67 ms instead of 3.62 ms at the fine N on an
// H100 (chip_smoke.py). Rows past N are never stored.

#include "fused_mlp_common.cuh"

// C entry, bound with ctypes. Returns a cudaError_t (0 = launched).
extern "C" int sunerf_fused_mlp_stash_fwd(
    const void* pts, const void* col_dim, const void* col_freq,
    const void* w_in, const void* b_in, const void* w_h, const void* b_h,
    const void* w_out, const void* b_out, const void* grid, void* out, void* hs,
    void* cs, int n, int d_in, int n_cols, int e_pad, int d_filter, int n_hidden,
    int d_out, void* stream) {
  sunerf::FwdParams p;
  p.pts = static_cast<const float*>(pts);
  p.col_dim = static_cast<const int*>(col_dim);
  p.col_freq = static_cast<const float*>(col_freq);
  p.w_in = static_cast<const uint2*>(w_in);
  p.b_in = static_cast<const float*>(b_in);
  p.w_h = static_cast<const uint2*>(w_h);
  p.b_h = static_cast<const float*>(b_h);
  p.w_out = static_cast<const __nv_bfloat16*>(w_out);
  p.b_out = static_cast<const float*>(b_out);
  p.grid = sunerf::grid_params(grid);
  p.out = static_cast<float*>(out);
  p.hs = static_cast<__nv_bfloat16*>(hs);
  p.cs = static_cast<int8_t*>(cs);
  p.n = n;
  p.d_in = d_in;
  p.n_cols = n_cols;
  p.e_pad = e_pad;
  p.n_hidden = n_hidden;
  p.d_out = d_out;
  return sunerf::fused_mlp_fwd_entry<true>(p, d_filter, stream);
}
