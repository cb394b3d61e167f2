// Fused positional encoding + Sine MLP forward for Hopper (sm_90a): K0.
//
// Replaces the TPU kernel sunerf_tpu/ops/pallas/fused_mlp.py:_fwd_kernel
// (the custom_vjp primal that serves every no-grad render). Same function:
//   enc = [x, sin(u), cos(u)],  u_j = x[dim_j] * freq_j   (f32, exact: each
//         phase column has one power-of-two frequency, as _freq_matrix)
//   h   = sin(bf16(enc) @ bf16(w_in) + b_in)
//   h   = sin(bf16(h) @ bf16(w_h[i]) + b_h[i])        for i < L-1
//   out = bf16(h) @ bf16(w_out) + b_out               (f32, no base offsets)
// with bf16 operands, f32 accumulation and f32 bias and sine. Sines use the
// TPU kernel's explicit range reduction + 11th-order odd minimax polynomial
// (fast_sin): phases reach ~400 rad, where unreduced __sinf is wrong.
// With dense grid levels (K5, the grid branch of _fwd_kernel:
// _encode_grid/_grid_feats, fused_mlp.py:283-327) enc also holds each
// level's F trilinear features after the sin/cos columns, computed in f32
// from the float32 tables (grid_feature in fused_mlp_common.cuh).
//
// Bound on this card: operations. 2*N*H*(E + (L-1)*H + d_out) flop on the
// bf16 tensor cores (989 TFLOP/s dense) — 3.76 Mflop per point at 8x512
// against 16 bytes of point input and 8 bytes of output, so bytes never bind.
// Design against that bound, simple first (the kernel body is
// fused_mlp_fwd_kernel<H, kNoStash> in fused_mlp_common.cuh, shared with
// K1, K6a, K6b and K4's recompute):
//   * one block of 8 warps per 64 points; two bf16 activation buffers
//     [64, max(H, E_pad) + 8] in dynamic shared memory (133 KB at H = 512)
//     hold each layer's input and output, so activations never reach device
//     memory (the TPU kernel's VMEM residency);
//   * every warp owns H/8 output columns for all 64 rows and issues
//     mma.sync m16n8k16 bf16 -> f32: each weight fragment it loads serves 4
//     row tiles, and the 128 f32 accumulators stay in registers through the
//     bias + sine epilogue;
//   * weights (3.7 MB bf16 at 8x512) are read from global memory, where they
//     stay resident in the 50 MB L2 (loaded under an evict-last policy); the
//     wrapper packs them once per field in
//     mma fragment order, so a warp's fragment load is one coalesced 256-byte
//     read, double-buffered in registers one k-step ahead;
//   * the padded row stride (H + 8 bf16) keeps the 32-bit fragment loads and
//     the epilogue stores free of bank conflicts;
//   * d_out = 2 is a per-point f32 dot product reduced across the warp;
//   * rows past N read zeros and are never stored (ragged edge masked here);
//   * K5: the TPU kernel contracts one-hot hat rows with the table on the MXU
//     (2*G^3*F flop per point and level: 0.52 Mflop at G = 32, four times a
//     4x128 MLP) because gathers are slow there. Here each grid column is an
//     8-corner gather: 8 loads of 4 bytes through L2 (the 128 KB to 1 MB
//     tables stay resident) and 23 f32 operations, against the MLP's
//     tensor-core work per point; threads of one row read neighbouring
//     features of one corner, so a warp's loads share 32-byte sectors.
// wgmma, TMA and persistent blocks are left for later work.

#include "fused_mlp_common.cuh"

// C entry, bound with ctypes. Returns a cudaError_t (0 = launched).
extern "C" int sunerf_fused_mlp_fwd(
    const void* pts, const void* col_dim, const void* col_freq,
    const void* w_in, const void* b_in, const void* w_h, const void* b_h,
    const void* w_out, const void* b_out, const void* grid, void* out, int n,
    int d_in, int n_cols, int e_pad, int d_filter, int n_hidden, int d_out,
    void* stream) {
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
  p.hs = nullptr;
  p.cs = nullptr;
  p.n = n;
  p.d_in = d_in;
  p.n_cols = n_cols;
  p.e_pad = e_pad;
  p.n_hidden = n_hidden;
  p.d_out = d_out;
  return sunerf::fused_mlp_fwd_entry<sunerf::kNoStash>(p, d_filter, stream);
}
