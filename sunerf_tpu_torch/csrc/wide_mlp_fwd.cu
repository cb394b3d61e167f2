// The wide route's forward for Hopper (sm_90a), one launch a layer
// (wide_mlp.cuh): K0 (no stash), K1 ('int8'), K6a ('lsb'), K6b ('i8pair')
// and K4's recompute forward (bf16 sin and cos) for a field above the fused
// kernels' widths or outside their heads. It replaces, at those shapes, the
// TPU kernels sunerf_tpu/ops/pallas/fused_mlp.py:_fwd_kernel (pallas_call
// :410), _fwd_stash_kernel (:715), _fwd_stash_lsb_kernel (:481) and
// _fwd_stash_i8pair_kernel (:503); the function, bound and design are in
// wide_mlp.cuh.
//
// A forward is encode_kernel (the points' encoding, grid features included,
// to a bf16 scratch), then L launches of wide_wgmma_kernel with FwdEpi (layer
// 0 from the encoding, layer i from layer i-1's bf16 sin; N tiles of 128 or
// 256), then the head with HeadEpi (an N tile of 8 or 16 for o_pad columns). 'int8' and K4 keep each layer's sin in the stash hs, where
// the next layer reads it; K0, 'lsb' and 'i8pair' pass it through two [n, H]
// buffers.

#include "wide_mlp.cuh"

namespace {

using namespace sunerf;
using namespace sunerf::wide;

// launches by this library since it was loaded, counted where a launch
// returned no error (read by sunerf_kernel_launches): forwards by format
// (K0, K1, K6a, K6b, K4), then encode_kernel's and the layer and head GEMMs'
// (wide_wgmma_kernel)
constexpr int kCounts = 7;
unsigned long long launches[kCounts] = {};

template <int kFmt>
cudaError_t forward(const WideArgs& a, cudaStream_t s) {
  const int n = a.n, H = a.h, L = a.n_hidden + 1;
  const GridParams grid = grid_params(a.grid);
  if (!grid_ok(grid)) return cudaErrorInvalidValue;
  cudaError_t err = encode(a.pts, a.col_dim, a.col_freq, grid, a.enc, n, a.d_in, a.n_cols, a.e_pad,
                           s);
  if (err != cudaSuccess) return err;
  ++launches[5];
  constexpr bool kInStash = kFmt == kStashInt8 || kFmt == kStashBf16Cos;
  const long long lh = static_cast<long long>(L) * H;
  auto* hs = static_cast<__nv_bfloat16*>(a.hs);
  const __nv_bfloat16* in = a.enc;
  long long in_ld = a.e_pad;
  for (int l = 0; l < L; ++l) {
    FwdEpi<kFmt> epi{};
    epi.bias = l == 0 ? a.b_in : a.b_h + static_cast<size_t>(l - 1) * H;
    epi.act = kInStash ? hs + static_cast<size_t>(l) * H : a.act + static_cast<size_t>(l & 1) * n * H;
    epi.act_ld = kInStash ? lh : H;
    epi.hs = a.hs;
    epi.cs = a.cs;
    // 'i8pair': a layer's sin8 and cos8 halves side by side, 2 H a layer
    constexpr int kPer = kFmt == kStashI8pair ? 2 : 1;
    epi.stash_ld = kPer * lh;
    epi.at = static_cast<long long>(kPer) * l * H;
    epi.h = H;
    Gemm g{};
    g.a = {in, in_ld};
    g.b = l == 0 ? Operand{a.w_in_t, a.e_pad}
                 : Operand{a.w_h_t + static_cast<size_t>(l - 1) * H * H, H};
    g.m = g.m_load = n;
    g.n = g.n_load = H;
    g.k = l == 0 ? a.e_pad : H;
    err = launch_kmajor(g, epi, s);
    if (err != cudaSuccess) return err;
    ++launches[6];
    in = epi.act;
    in_ld = epi.act_ld;
  }
  HeadEpi head{a.b_out, a.out, a.d_out};
  Gemm g{};
  g.a = {in, in_ld};
  g.b = {a.w_out_t, H};
  g.m = g.m_load = n;
  g.n = g.n_load = a.d_out;
  g.k = H;
  err = launch_kmajor(g, head, s);
  if (err == cudaSuccess) ++launches[6];
  return err;
}

}  // namespace

// C entry, bound with ctypes: a forward of format fmt (0 K0, 1 'int8', 2
// 'lsb', 3 'i8pair', 4 K4's bf16 sin and cos; kStash* of
// fused_mlp_common.cuh) on the
// WideArgs at `args`. Returns a cudaError_t (0 = launched).
extern "C" int sunerf_wide_mlp_fwd(const void* args, void* stream) {
  const WideArgs& a = *static_cast<const WideArgs*>(args);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.n <= 0 || a.h % 16 != 0 || a.e_pad % 16 != 0 || a.d_out < 1) return cudaErrorInvalidValue;
  cudaError_t err;
  int slot;
  switch (a.fmt) {
    case kStashNone: err = forward<kStashNone>(a, s); slot = 0; break;
    case kStashInt8: err = forward<kStashInt8>(a, s); slot = 1; break;
    case kStashLsb: err = forward<kStashLsb>(a, s); slot = 2; break;
    case kStashI8pair: err = forward<kStashI8pair>(a, s); slot = 3; break;
    case kStashBf16Cos: err = forward<kStashBf16Cos>(a, s); slot = 4; break;
    default: return cudaErrorInvalidValue;
  }
  if (err == cudaSuccess) ++launches[slot];
  return static_cast<int>(err);
}

// C entry: the launches above into out[0..kCounts). Returns 0.
extern "C" int sunerf_kernel_launches(long long* out) {
  for (int i = 0; i < kCounts; ++i) out[i] = static_cast<long long>(launches[i]);
  return 0;
}
