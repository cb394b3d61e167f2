// The wide route's backward for Hopper (sm_90a), one launch a layer
// (wide_mlp.cuh): K2 ('int8'), K6a ('lsb'), K6b ('i8pair': dW_h on int8
// wgmma, wide_dw_i8_wgmma_kernel, its scale groups' maxima from the chain's
// epilogue) and K4's backward (its bf16 cos gate) with
// the point cotangent K3 and the grid levels' d_table K5,
// for a field above the fused kernels' widths or outside their heads. It
// replaces, at those shapes, the TPU kernels
// sunerf_tpu/ops/pallas/fused_mlp.py:_bwd_stash_kernel (pallas_call :783;
// its lsb branch :606, i8pair branch :580 with _mm_i8 :525, compute_dpts
// :646, d_table :637-644) and _bwd_kernel
// (:936). The same function as fused_mlp_stash_bwd.cu states, with its
// roundings:
//   dW_out = hs_{L-1}^T bf16(dy),  db_out = sum(dy)
//   dh     = bf16(dy) bf16(W_out)^T
//   for j = L-1 .. 0:  dz_j = bf16(bf16(dh) * gate_j),  db_j = sum dz_j,
//                      dW_j = hs_{j-1}^T dz_j (bf16(enc)^T dz_0 for j = 0),
//                      dh = dz_j bf16(W_h[j-1])^T
//   K3: dpts = denc_x + (cos u dsin - sin u dcos) K^T, denc = dz_0 bf16(W_in)^T
//   K5: denc_grid = dz_0 bf16(W_in[grid rows])^T and each level's max
//       |denc_grid| here; the wrapper then spreads it over the tables with
//       the fused backward's grid_scatter_kernel and grid_convert_kernel
//       (fused_mlp_stash_bwd.cu sunerf_grid_scatter: fixed-point sums, the
//       same bits every run)
// Each product is a launch of wide_wgmma_kernel: the chain (ChainEpi, both
// operands K-major, dz through two [n, H] buffers), each dW over ranges of
// the points (both operands MN-major; the ranges' partials summed in order
// by each tile's last block, StoreEpi), denc (StoreEpi); the bias gradients
// are the chain epilogue's column sums a warpgroup's 64 rows, then
// colsum_kernel's over those, all in a fixed order.

#include "wide_mlp.cuh"

namespace sunerf {
namespace {

// launches by this library since it was loaded, counted where a launch
// returned no error (read by sunerf_kernel_launches): backwards by format
// (K2, K6a, K6b, K4), then the chain and dW GEMMs' (wide_wgmma_kernel), the
// point cotangent's (dpts_kernel, K3), the grid cotangent's maxima
// (grid_max_kernel, K5), the int8 dW_h products ('i8pair',
// wide_dw_i8_wgmma_kernel), the denc GEMMs' (K3, K5) and the scale groups'
// maxima ('i8pair', wide_dz_group_max_kernel)
constexpr int kCounts = 11;
unsigned long long wide_launches[kCounts] = {};

// K3's tail a thread a point: dpts[d] = denc[d] + the sum over the phase
// columns j of dimension d of (cos u_j dsin_j - sin u_j dcos_j) freq_j,
// u_j = x[d] freq_j in f32, sin and cos as the forward's encoding
__global__ void dpts_kernel(const float* pts, const int* col_dim, const float* col_freq,
                            const float* denc, float* dpts, int n, int d_in, int n_cols) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int ld = d_in + 2 * n_cols;
  const float* de = denc + static_cast<size_t>(i) * ld;
  const float* x = pts + static_cast<size_t>(i) * d_in;
  for (int d = 0; d < d_in; ++d) {
    float s = 0.f;
    for (int j = 0; j < n_cols; ++j) {
      if (__ldg(col_dim + j) != d) continue;
      const float f = __ldg(col_freq + j);
      const float u = __fmul_rn(__ldg(x + d), f);
      const float du = __fsub_rn(__fmul_rn(fast_sin(__fadd_rn(u, kHalfPi)), de[d_in + j]),
                                 __fmul_rn(fast_sin(u), de[d_in + n_cols + j]));
      s = __fadd_rn(s, __fmul_rn(du, f));
    }
    dpts[static_cast<size_t>(i) * d_in + d] = __fadd_rn(de[d], s);
  }
}

// K5: gmax[level] = the bits of max |denc_grid| over the level's columns
// (non-negative floats order as their bits; NaN above every finite one)
__global__ void grid_max_kernel(const float* dgrid, int n, int levels, int features,
                                unsigned int* gmax) {
  __shared__ unsigned int best;
  if (threadIdx.x == 0) best = 0u;
  __syncthreads();
  const int level = blockIdx.y, cols = levels * features;
  unsigned int m = 0u;
  for (long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       t < static_cast<long long>(n) * features; t += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long row = t / features;
    const float v = dgrid[row * cols + level * features + t % features];
    m = max(m, __float_as_uint(fabsf(v)));
  }
  atomicMax(&best, m);
  __syncthreads();
  if (threadIdx.x == 0 && best != 0u) atomicMax(gmax + level, best);
}

// dW [m, n_out] = A^T B over the points (both MN-major, [points][ld]),
// over ranges of the points (dw_plan) whose partials each tile's last block
// sums in order
cudaError_t dw_product(const wide::WideArgs& a, const wide::Operand& A, int m,
                       const wide::Operand& B, int n_out, int n_load, int sms, float* out,
                       cudaStream_t s) {
  const int tn = wide::tile_n(n_out, 64);
  int splits, k_split;
  wide::dw_plan(m, n_out, tn, a.n, sms, splits, k_split);
  wide::Gemm g{};
  g.a = A;
  g.b = B;
  g.m = g.m_load = m;
  g.n = n_out;
  g.n_load = n_load;
  g.k = a.n;
  const cudaError_t err = wide::launch_gemm<false>(g, tn, splits, k_split, a.part, a.tile_count,
                                                   wide::StoreEpi{out, n_out}, s);
  if (err == cudaSuccess) ++wide_launches[5];
  return err;
}

// The chain step into layer `layer`'s dz: dz_out = bf16(bf16(A B^T) * gate)
// with A [n, k] and B^T [H, k] K-major, and the layer's bias gradient from
// the epilogue's column sums (db_part); 'i8pair' also each point's max |dz|
// an N tile (dz_rowmax)
template <int kFmt>
cudaError_t chain_step(const wide::WideArgs& a, const wide::Operand& in, const wide::Operand& w,
                       int k, int layer, __nv_bfloat16* dz_out, cudaStream_t s) {
  const long long lh = static_cast<long long>(a.n_hidden + 1) * a.h;
  // the gate: 'lsb' the packed sin, 'i8pair' the cos8 half of the layer's
  // pairs (2 H a layer), else cs
  constexpr bool kInHs = kFmt == kStashLsb || kFmt == kStashI8pair;
  constexpr int kPer = kFmt == kStashI8pair ? 2 : 1;
  wide::ChainEpi<kFmt> epi{dz_out, a.h, kInHs ? a.hs : a.cs, kPer * lh,
                           static_cast<long long>(kPer) * layer * a.h
                               + (kFmt == kStashI8pair ? a.h : 0),
                           a.db_part, a.dz_rowmax};
  wide::Gemm g{};
  g.a = in;
  g.b = w;
  g.m = g.m_load = a.n;
  g.n = g.n_load = a.h;
  g.k = k;
  cudaError_t err = wide::launch_kmajor(g, epi, s);
  if (err != cudaSuccess) return err;
  ++wide_launches[4];
  // the layer's bias gradient: the warpgroups' column sums, summed in order
  const int parts = 2 * ((a.n + wide::kBM - 1) / wide::kBM);
  return wide::column_sums(a.db_part, a.h, parts, a.h, a.part_sum,
                           layer > 0 ? a.g_b_h + static_cast<size_t>(layer - 1) * a.h : a.g_b_in, s);
}

// 'i8pair': dW_h[layer] = sin8_layer^T dz8 per scale group on int8 wgmma
// (wide_dw_i8_wgmma_kernel), over ranges of whole groups summed in order in
// the kernel; the groups' maxima from the chain's row maxima of dz
// (wide_dz_group_max_kernel)
cudaError_t dw_i8_product(const wide::WideArgs& a, const __nv_bfloat16* dz, int layer, int sms,
                          float* out, cudaStream_t s) {
  const int n = a.n, H = a.h;
  const int tn = wide::tile_n(H, wide::ChainEpi<kStashI8pair>::kMinTile);   // the chain's
  cudaError_t err = wide::group_maxima(a.dz_rowmax, n, (H + tn - 1) / tn, a.group, a.group_max, s);
  if (err != cudaSuccess) return err;
  ++wide_launches[10];
  int splits, k_split;
  wide::i8_plan(H, n, a.group, sms, splits, k_split);
  const long long lh = static_cast<long long>(a.n_hidden + 1) * H;
  err = wide::dw_i8(static_cast<const int8_t*>(a.hs), 2 * lh, 2 * layer * H, dz, n, H,
                    a.group_max, a.group, splits, k_split, a.part, a.tile_count, out, s);
  if (err == cudaSuccess) ++wide_launches[8];
  return err;
}

// denc [n, cols] f32 = dz_0 bf16(W_in[rows from row0])^T
cudaError_t denc_product(const wide::WideArgs& a, const __nv_bfloat16* dz0, int row0, int cols,
                         float* out, cudaStream_t s) {
  wide::Gemm g{};
  g.a = {dz0, a.h};
  g.b = {a.w_in_b + static_cast<size_t>(row0) * a.h, a.h};
  g.m = g.m_load = a.n;
  g.n = g.n_load = cols;
  g.k = a.h;
  const cudaError_t err = wide::launch_kmajor(g, wide::StoreEpi{out, cols}, s);
  if (err == cudaSuccess) ++wide_launches[9];
  return err;
}

template <int kFmt>
cudaError_t backward(const wide::WideArgs& a, cudaStream_t s) {
  const int n = a.n, H = a.h, L = a.n_hidden + 1;
  const GridParams grid = grid_params(a.grid);
  if (!grid_ok(grid)) return cudaErrorInvalidValue;
  int device = 0, sms = 132;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const long long lh = static_cast<long long>(L) * H;
  const auto* hs = static_cast<const __nv_bfloat16*>(a.hs);

  cudaError_t err = wide::encode(a.pts, a.col_dim, a.col_freq, grid, a.enc, n, a.d_in, a.n_cols,
                                 a.e_pad, s);
  if (err != cudaSuccess) return err;
  const long long dy_elems = static_cast<long long>(n) * a.o_pad;
  wide::dy_bf16_kernel<<<static_cast<unsigned>((dy_elems + 255) / 256), 256, 0, s>>>(
      a.dy, a.dyb, n, a.d_out, a.o_pad);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = wide::column_sums(a.dy, a.d_out, n, a.d_out, a.part_sum, a.g_b_out, s)) != cudaSuccess)
    return err;
  int cur = 0;
  __nv_bfloat16* dz[2] = {a.dz, a.dz + static_cast<size_t>(n) * H};
  wide::Operand last{hs + static_cast<size_t>(L - 1) * H, lh};
  if constexpr (kFmt == kStashI8pair) {
    // the last layer's dequantized sin, into the second dz buffer (free
    // until the chain's second step)
    const long long elems = static_cast<long long>(n) * H;
    wide::i8_dequant_kernel<<<static_cast<unsigned>((elems + 255) / 256), 256, 0, s>>>(
        static_cast<const int8_t*>(a.hs), 2 * lh, 2LL * (L - 1) * H, n, H, dz[1]);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    last = {dz[1], H};
  }
  if ((err = dw_product(a, last, H, {a.dyb, a.o_pad}, a.d_out, a.o_pad, sms, a.g_w_out, s))
      != cudaSuccess)
    return err;
  if ((err = chain_step<kFmt>(a, {a.dyb, a.o_pad}, {a.w_out_b, a.o_pad}, a.o_pad, L - 1, dz[cur],
                              s)) != cudaSuccess)
    return err;
  for (int j = L - 1; j >= 1; --j) {
    float* g_w = a.g_w_h + static_cast<size_t>(j - 1) * H * H;
    if constexpr (kFmt == kStashI8pair) {
      if ((err = dw_i8_product(a, dz[cur], j - 1, sms, g_w, s)) != cudaSuccess) return err;
    } else if ((err = dw_product(a, {hs + static_cast<size_t>(j - 1) * H, lh}, H, {dz[cur], H}, H,
                                 H, sms, g_w, s)) != cudaSuccess) {
      return err;
    }
    if ((err = chain_step<kFmt>(a, {dz[cur], H}, {a.w_h_b + static_cast<size_t>(j - 1) * H * H, H},
                                H, j - 1, dz[cur ^ 1], s)) != cudaSuccess)
      return err;
    cur ^= 1;
  }
  if ((err = dw_product(a, {a.enc, a.e_pad}, a.e_pad, {dz[cur], H}, H, H, sms, a.g_w_in, s))
      != cudaSuccess)
    return err;

  if (a.dpts != nullptr) {
    // K3
    if ((err = denc_product(a, dz[cur], 0, a.d_in + 2 * a.n_cols, a.denc, s)) != cudaSuccess)
      return err;
    dpts_kernel<<<(n + 127) / 128, 128, 0, s>>>(a.pts, a.col_dim, a.col_freq, a.denc, a.dpts, n,
                                                a.d_in, a.n_cols);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    ++wide_launches[6];
  }
  if (grid.n_levels > 0) {
    // K5: the grid cotangent and each level's maximum (the scatter follows
    // in the wrapper)
    const int F = grid.features, cols = grid.n_levels * F;
    if ((err = denc_product(a, dz[cur], a.d_in + 2 * a.n_cols, cols, a.dgrid, s)) != cudaSuccess)
      return err;
    grid_max_kernel<<<dim3(64, grid.n_levels), 256, 0, s>>>(a.dgrid, n, grid.n_levels, F, a.gmax);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    ++wide_launches[7];
  }
  return cudaSuccess;
}

}  // namespace
}  // namespace sunerf

// C entry, bound with ctypes: the backward of format fmt (1 'int8', 2
// 'lsb', 3 'i8pair' with its scale group, 4 K4's bf16 cos gate; kStash* of
// fused_mlp_common.cuh) on the
// WideArgs at `args`, with K3 where args.dpts is set and K5 where it has
// grid levels (the cotangent and maxima; the scatter is
// sunerf_grid_scatter's). Returns a cudaError_t (0 = launched).
extern "C" int sunerf_wide_mlp_bwd(const void* args, void* stream) {
  using namespace sunerf;
  const wide::WideArgs& a = *static_cast<const wide::WideArgs*>(args);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.n <= 0 || a.h % 16 != 0 || a.e_pad % 16 != 0 || a.d_out < 1 || a.o_pad % 8 != 0
      || a.o_pad < a.d_out
      || a.part == nullptr || a.tile_count == nullptr || a.db_part == nullptr
      || (a.fmt == kStashI8pair && (a.group < 1 || a.group > 133144 || a.group_max == nullptr
                                    || a.dz_rowmax == nullptr)))
    return cudaErrorInvalidValue;
  cudaError_t err;
  int slot;
  switch (a.fmt) {
    case kStashInt8: err = backward<kStashInt8>(a, s); slot = 0; break;
    case kStashLsb: err = backward<kStashLsb>(a, s); slot = 1; break;
    case kStashI8pair: err = backward<kStashI8pair>(a, s); slot = 2; break;
    case kStashBf16Cos: err = backward<kStashBf16Cos>(a, s); slot = 3; break;
    default: return cudaErrorInvalidValue;
  }
  if (err == cudaSuccess) ++wide_launches[slot];
  return static_cast<int>(err);
}

// C entry: the launches above into out[0..kCounts). Returns 0.
extern "C" int sunerf_kernel_launches(long long* out) {
  for (int i = 0; i < sunerf::kCounts; ++i)
    out[i] = static_cast<long long>(sunerf::wide_launches[i]);
  return 0;
}
