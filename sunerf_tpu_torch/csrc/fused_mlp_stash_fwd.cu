// Stashing forwards of the fused posenc + Sine MLP for Hopper (sm_90a): K1,
// K6a and K6b, one per stash format, all the wgmma forward of
// fused_mlp_fwd_wgmma.cuh (K0's kernel) with the format's stores in each
// layer's epilogue.
//
// K1 replaces the TPU kernel sunerf_tpu/ops/pallas/fused_mlp.py:_fwd_stash_kernel
// with the 'int8' stash (the training forward; pallas_call :715 in
// _fused_mlp_stash_fwd): K0's output, plus, for every Sine layer i of L,
// hs = bf16(sin y_i) and cs = int8(round_half_even(127 cos8(y_i))), both
// [N, L*H] row-major, the TPU kernel's layout; the backward K2
// (fused_mlp_stash_bwd.cu) reads them. K6a replaces _fwd_stash_lsb_kernel
// ('lsb'), K6b _fwd_stash_i8pair_kernel ('i8pair'); the header gives their
// stashes. Dense grid levels (K5) enter the encoding as in K0; grid
// configs take the 'int8' stash only, as in the JAX package.
//
// Bound on this card: both nearly equal at 8x512. Operations: 2*N*H*(E +
// (L-1)*H + d_out) flop, 3.76 Mflop per point, 0.747 ms at the fine step's
// N = 196,608 at 989 TFLOP/s bf16 dense. Bytes: K1's stashes write 3*L*H =
// 12,288 bytes per point, 0.722 ms at 3.35 TB/s; K6a's and K6b's one stream
// 2*L*H = 8,192 bytes, 0.481 ms. The design (the header): after each
// layer's epilogue the stashes are copied out of shared memory (the sin
// stash from the activation buffer, the rest from a staging tile beside
// it) in whole sectors under an L2 evict-first policy, so the stash stream
// does not evict the weights; the copies do not overlap the products
// (every overlapping variant measured slower, the header lists them), so
// K1 stays above its byte bound by their time.

#include "fused_mlp_fwd_wgmma.cuh"

// C entry, bound with ctypes. w is pack_wgmma's chunks; fmt: 0 'int8' (hs
// bf16, cs int8), 1 'lsb' (hs packed bf16, cs unused), 2 'i8pair' (hs int8
// pairs, cs unused). Returns a cudaError_t (0 = launched).
extern "C" int sunerf_fused_mlp_stash_fwd(
    const void* pts, const void* col_dim, const void* col_freq, const void* w,
    const void* b_in, const void* b_h, const void* b_out, const void* grid, void* out,
    void* hs, void* cs, int n, int d_in, int n_cols, int e_pad, int d_filter, int n_hidden,
    int d_out, int fmt, void* stream) {
  using namespace sunerf;
  fwd::Params p{};
  p.pts = static_cast<const float*>(pts);
  p.col_dim = static_cast<const int*>(col_dim);
  p.col_freq = static_cast<const float*>(col_freq);
  p.w = static_cast<const __nv_bfloat16*>(w);
  p.b_in = static_cast<const float*>(b_in);
  p.b_h = static_cast<const float*>(b_h);
  p.b_out = static_cast<const float*>(b_out);
  p.out = static_cast<float*>(out);
  p.hs = hs;
  p.cs = cs;
  p.grid = grid_params(grid);
  p.n = n;
  p.d_in = d_in;
  p.n_cols = n_cols;
  p.n_hidden = n_hidden;
  p.d_out = d_out;
  if (fmt != 0 && p.grid.n_levels > 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (fmt) {
    case 0: return static_cast<int>(fwd::launch<kStashInt8>(p, e_pad, d_filter, s));
    case 1: return static_cast<int>(fwd::launch<kStashLsb>(p, e_pad, d_filter, s));
    case 2: return static_cast<int>(fwd::launch<kStashI8pair>(p, e_pad, d_filter, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
