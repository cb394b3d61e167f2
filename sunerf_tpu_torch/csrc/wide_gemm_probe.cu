// The wide route's GEMM (wide_mlp.cuh wide_wgmma_kernel) taken apart, for
// scripts/probe_wide_gemm.py: one layer's product with each epilogue, and
// the dW products over the points in ranges (as the route runs them)
// against one launch over every layer's tiles; and 'i8pair''s two kernels
// alone (wide_dw_i8_wgmma_kernel; the chain step with its row maxima and
// wide_dz_group_max_kernel), for the card tests
// (tests/test_torch_wide_gemm.py). Nothing of the route calls it; it
// replaces no TPU kernel. Its variants' times show what bounds the
// route's kernels on the card: the products alone, the epilogues, the
// stores straight from the accumulators against the staged ones.

#include "wide_mlp.cuh"

namespace {

using namespace sunerf;
using namespace sunerf::wide;

// the products alone: a value kept live so that nothing is optimised away
struct NullEpi {
  static constexpr int kMinTile = 8;
  static constexpr bool kStaged = false, kGate = false, kColsum = false;
  float* out;
  __device__ __forceinline__ void operator()(int, int, float v0, float v1) const {
    if (v0 == 12345.678f && v1 == -1.f) out[0] = v0;
  }
};

// bf16(acc) stored a pair at a time straight from the accumulators
struct DirectEpi {
  static constexpr int kMinTile = 8;
  static constexpr bool kStaged = false, kGate = false, kColsum = false;
  __nv_bfloat16* out;
  long long ld;
  __device__ __forceinline__ void operator()(int row, int col, float v0, float v1) const {
    *reinterpret_cast<uint32_t*>(out + static_cast<size_t>(row) * ld + col) = pack_bf16(v0, v1);
  }
};

}  // namespace

// C entry: one product [n, k] x [k, h] (both K-major: a [n][k], w [h][k])
// with the epilogue of `variant`: 0 none (NullEpi), 1 stores straight from
// the accumulators (DirectEpi), 2 K0's FwdEpi, 3 K1's FwdEpi<'int8'> (cs
// [n][h] int8), 4 the chain's ChainEpi<'int8'> (its gate cs, its column
// sums to db_part [2 ceil(n / 128)][h]); 5 and 6 are 0 and 3 at an N tile
// of 128. Returns a cudaError_t.
extern "C" int sunerf_wide_gemm_probe(int variant, const void* a, const void* w, const float* bias,
                                      void* act, void* cs, float* db_part, int n, int h, int k,
                                      void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  Gemm g{};
  g.a = {static_cast<const __nv_bfloat16*>(a), k};
  g.b = {static_cast<const __nv_bfloat16*>(w), k};
  g.m = g.m_load = n;
  g.n = g.n_load = h;
  g.k = k;
  FwdEpi<kStashInt8> k1{};
  k1.bias = bias;
  k1.act = static_cast<__nv_bfloat16*>(act);
  k1.act_ld = h;
  k1.cs = cs;
  k1.stash_ld = h;
  k1.h = h;
  FwdEpi<kStashNone> k0{};
  k0.bias = bias;
  k0.act = k1.act;
  k0.act_ld = h;
  k0.stash_ld = h;
  k0.h = h;
  const int k_split = (k + kBK - 1) / kBK * kBK;
  switch (variant) {
    case 0: return static_cast<int>(launch_kmajor(g, NullEpi{db_part}, s));
    case 1: return static_cast<int>(launch_kmajor(g, DirectEpi{k1.act, h}, s));
    case 2: return static_cast<int>(launch_kmajor(g, k0, s));
    case 3: return static_cast<int>(launch_kmajor(g, k1, s));
    case 4:
      return static_cast<int>(launch_kmajor(
          g, ChainEpi<kStashInt8>{k1.act, h, cs, h, 0, db_part}, s));
    case 5:
      return static_cast<int>(
          launch_gemm<true>(g, 128, 1, k_split, nullptr, nullptr, NullEpi{db_part}, s));
    case 6: return static_cast<int>(launch_gemm<true>(g, 128, 1, k_split, nullptr, nullptr, k1, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// C entry: dW [m, n_out] f32 = A^T B over `points` (A [points][lda] from
// column 0, B [points][n_out], both MN-major), in the point ranges of
// dw_plan (ranged != 0, part and count the route's scratch) or in one range.
extern "C" int sunerf_wide_dw_probe(const void* a, long long lda, const void* b, int m, int n_out,
                                    int points, int ranged, float* part, unsigned int* count,
                                    float* out, void* stream) {
  Gemm g{};
  g.a = {static_cast<const __nv_bfloat16*>(a), lda};
  g.b = {static_cast<const __nv_bfloat16*>(b), n_out};
  g.m = g.m_load = m;
  g.n = g.n_load = n_out;
  g.k = points;
  const int tn = tile_n(n_out, 64);
  int splits = 1, k_split = (points + kBK - 1) / kBK * kBK;
  if (ranged) {
    int device = 0, sms = 132;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    dw_plan(m, n_out, tn, points, sms, splits, k_split);
  }
  return static_cast<int>(launch_gemm<false>(g, tn, splits, k_split, part, count,
                                             StoreEpi{out, n_out},
                                             static_cast<cudaStream_t>(stream)));
}

// C entry: 'i8pair''s dW_h alone (wide_dw_i8_wgmma_kernel): out [h][h] f32 =
// sin8^T dz8 per scale group of `group` points, sin8 the stash's columns
// [a_x, a_x + h) of rows of ld bytes, dz [n][h] bf16, gmax the groups' max
// |dz| bits; in the ranges of i8_plan (ranged != 0: part [kMaxSplits h h]
// and count [ceil(h / 128)^2], zero) or in one range. Returns a cudaError_t.
extern "C" int sunerf_wide_dw_i8_probe(const void* stash, long long ld, int a_x, const void* dz,
                                       int n, int h, const unsigned int* gmax, int group,
                                       int ranged, float* part, unsigned int* count, float* out,
                                       void* stream) {
  int splits = 1, k_split = (n + group - 1) / group * group;
  if (ranged) {
    int device = 0, sms = 132;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    i8_plan(h, n, group, sms, splits, k_split);
  }
  return static_cast<int>(dw_i8(static_cast<const int8_t*>(stash), ld, a_x,
                                static_cast<const __nv_bfloat16*>(dz), n, h, gmax, group, splits,
                                k_split, part, count, out, static_cast<cudaStream_t>(stream)));
}

// C entry: the 'i8pair' chain step alone and its scale groups' maxima: dz
// [n][h] bf16 = bf16(bf16(a w^T) * gate) with a [n][k] and w [h][k] bf16
// (K-major), the gate the int8 cos8 at column `at` of the stash's rows of ld
// bytes; db_part [2 ceil(n / 128)][h] its column sums, rowmax [ceil(h /
// 128)][n] its row maxima, gmax [ceil(n / group)] the groups' maxima
// (wide_dz_group_max_kernel). Returns a cudaError_t.
extern "C" int sunerf_wide_i8_chain_probe(const void* a, const void* w, int k, const void* stash,
                                          long long ld, long long at, int n, int h, void* dz,
                                          float* db_part, unsigned int* rowmax, int group,
                                          unsigned int* gmax, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  Gemm g{};
  g.a = {static_cast<const __nv_bfloat16*>(a), k};
  g.b = {static_cast<const __nv_bfloat16*>(w), k};
  g.m = g.m_load = n;
  g.n = g.n_load = h;
  g.k = k;
  using Epi = ChainEpi<kStashI8pair>;
  const cudaError_t err = launch_kmajor(
      g, Epi{static_cast<__nv_bfloat16*>(dz), h, stash, ld, at, db_part, rowmax}, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tn = tile_n(h, Epi::kMinTile);
  return static_cast<int>(group_maxima(rowmax, n, (h + tn - 1) / tn, group, gmax, s));
}
