// Stashing forwards of the fused posenc + Sine MLP for Hopper (sm_90a): K1,
// K6a and K6b, one per stash format.
//
// K1 replaces the TPU kernel sunerf_tpu/ops/pallas/fused_mlp.py:_fwd_stash_kernel
// with the 'int8' stash (the training forward; pallas_call in
// _fused_mlp_stash_fwd). Same function: K0's output (fused_mlp_fwd_wgmma.cu), plus,
// for every Sine layer i of L, with z_i its pre-activation and y_i the
// range-reduced z_i that the sine also uses,
//   hs[:, i*H:(i+1)*H] = bf16(sin y_i)   — the same bf16 value that feeds
//                                          layer i+1's product,
//   cs[:, i*H:(i+1)*H] = int8(round_half_even(127 * cos8(y_i)))
// with cos8 the TPU kernel's degree-8 even polynomial (fast_sincos_q). Both
// stashes are [N, L*H] row-major, the TPU kernel's layout; the backward K2
// (fused_mlp_stash_bwd.cu) reads them. Dense grid levels (K5) enter the
// encoding as in K0.
//
// K6a replaces _fwd_stash_lsb_kernel (stash_format 'lsb'): one bf16 stream
// [N, L*H] holding bf16(sin y_i) with its last mantissa bit replaced by
// (y_i^2 > (pi/2)^2), the sign of cos y_i on the reduced argument
// (fast_sin_csign, _pack_sin_csign). K6b replaces _fwd_stash_i8pair_kernel
// ('i8pair'): one int8 stream [N, 2*L*H], layer i's round(127 sin y_i) (from
// the f32 sine) in columns [2iH, 2iH + H) beside K1's int8 cos in
// [2iH + H, 2(i+1)H). In both the next layer takes bf16(sin y_i), so `out` is
// K1's bit for bit. Grid configs take the 'int8' stash only, as in the JAX
// package.
//
// Bound on this card: both nearly equal at 8x512. Operations: 2*N*H*(E +
// (L-1)*H + d_out) flop, 3.76 Mflop per point, 0.747 ms at the fine step's
// N = 196,608 at 989 TFLOP/s bf16 dense. Bytes: K1's stashes write 3*L*H =
// 12,288 bytes per point, 0.722 ms at 3.35 TB/s; K6a's and K6b's one stream
// 2*L*H = 8,192 bytes, 0.481 ms.
// Design: the mma.sync forward (fused_mlp_fwd_kernel<H, fmt> in
// fused_mlp_common.cuh) with the stash stores in each layer's epilogue. K1
// writes the bf16 sines into the next activation buffer, and the int8 cosines
// into one of two staging tiles [64, H + 16] in shared memory (+66 KB, 200 KB
// in all at H = 512); then the bulk-copy (TMA) engine copies both tiles to
// the stashes, one cp.async.bulk per row, while the warps go on to the next
// layer's products. The two staging tiles keep one barrier a layer.
// K6a's and K6b's rows are twice as wide (a bf16 tile [64, H + 8] or the
// int8 pairs [64, 2H + 16]), so one staging tile fits in the same 66 KB, and
// a layer waits for the previous layer's copy out of it before its epilogue:
// two barriers a layer.
// Every block re-reads the weights (3.7 MB bf16 at 8x512) from L2, so the
// stash rows go out under an L2 evict-first policy and the weights load
// under evict-last: without the policies the 2.4 GB stash stream evicted
// the weights, and K1 took 4.67 ms instead of 3.62 ms at the fine N on an
// H100 (chip_smoke.py). Rows past N are never stored.

#include "fused_mlp_common.cuh"

// C entry, bound with ctypes. fmt: 0 'int8' (hs bf16, cs int8), 1 'lsb' (hs
// packed bf16, cs unused), 2 'i8pair' (hs int8 pairs, cs unused). Returns a
// cudaError_t (0 = launched).
extern "C" int sunerf_fused_mlp_stash_fwd(
    const void* pts, const void* col_dim, const void* col_freq,
    const void* w_in, const void* b_in, const void* w_h, const void* b_h,
    const void* w_out, const void* b_out, const void* grid, void* out, void* hs,
    void* cs, int n, int d_in, int n_cols, int e_pad, int d_filter, int n_hidden,
    int d_out, int fmt, void* stream) {
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
  p.hs = hs;
  p.cs = cs;
  p.n = n;
  p.d_in = d_in;
  p.n_cols = n_cols;
  p.e_pad = e_pad;
  p.n_hidden = n_hidden;
  p.d_out = d_out;
  switch (fmt) {
    case 0: return sunerf::fused_mlp_fwd_entry<sunerf::kStashInt8>(p, d_filter, stream);
    case 1: return sunerf::fused_mlp_fwd_entry<sunerf::kStashLsb>(p, d_filter, stream);
    case 2: return sunerf::fused_mlp_fwd_entry<sunerf::kStashI8pair>(p, d_filter, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
