// The wide route of the fused posenc + Sine MLP for Hopper (sm_90a): the
// kernels of a field that the fused kernels cannot hold, d_filter above 512
// or d_output outside their heads (1..8 forward, 1..4 backward). It stands
// in, at those shapes, for the TPU kernels of
// sunerf_tpu/ops/pallas/fused_mlp.py: _fwd_kernel (K0, :343),
// _fwd_stash_kernel (K1, :453), _fwd_stash_lsb_kernel (K6a, :481),
// _bwd_stash_kernel (K2, :533) with its compute_dpts branch (K3, :646), the
// grid levels' features and d_table (K5, :283-327, :637-644) and
// _bwd_kernel (K4, :834), and computes their functions with their
// roundings: bf16 operands, f32 accumulation, f32 bias, the posenc phase
// u = x K in f32, the range-reduced sine (reduce_2pi, sin_poly), raw output
// without the DT base offsets.
//
// Design. The fused forward keeps a 64-point tile in shared memory through
// every layer; at H = 1024 two consumer warpgroups would need 256 f32
// accumulators a thread and a layer's input and output together 256 KB, so
// no such tile fits. Here each layer is its own launch of one GEMM kernel
// (wide_gemm_kernel), the activations going through device memory:
//   C[M, N] = epilogue(sum over k of A[m, k] B[k, n])
// on mma.sync m16n8k16 (bf16 in, f32 accumulate) from a 3-stage cp.async
// ring of 128 x 32 and 32 x 128 tiles, 8 warps of 64 x 32 outputs a block.
// Either operand is K-major (a row of k contiguous, fragments by ldmatrix)
// or MN-major (a row of m or n contiguous, fragments by ldmatrix.trans), so
// one kernel takes the forward's layers (activations x W^T, both K-major),
// the backward's chain (dz x W, both K-major) and the dW products over the
// points (stash^T x dz, both MN-major). Loads past an operand's extent are
// zero-filled (cp.async's source size 0); K-major extents along k and the
// row strides are multiples of 8 (the wrapper pads the width to a multiple
// of 8 and the head's outputs to 8 where they are a K). The epilogue is a
// functor on each accumulator pair (row, col, col + 1):
//   FwdEpi<kFmt>   y = reduce_2pi(acc + b); the bf16 sin to the next
//                  layer's input, and the stash of the format ('int8' the
//                  int8 cos8, 'lsb' the packed sin, K4 the bf16 cos10);
//   HeadEpi        out = acc + b_out, f32, any d_output;
//   ChainEpi<kFmt> dz = bf16(bf16(acc) * gate), the gate decoded from the
//                  stash of the layer;
//   StoreEpi       f32 partials (dW over a split of the points) or denc.
// dW products split the points into ranges, each with its own f32
// partials, summed in a fixed order (sum_parts_kernel), and the bias
// gradients are column sums in a fixed order (colsum_kernel), so a run
// gives the bits of the last.
//
// Bound on this card: operations, 2 N H (E + (L-1) H + O) flop for the
// forward (3.65 TFLOP at 8x1024, N = 245,760: 3.69 ms at 989 TFLOP/s bf16
// dense); mma.sync reaches a fraction of wgmma's rate, which is the price
// of this route's simplicity.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "fused_mlp_common.cuh"

namespace sunerf {
namespace wide {

constexpr int kBM = 128, kBN = 128, kBK = 32, kStages = 3, kThreads = 256;
constexpr int kPad = 8;          // bf16 of padding a shared row (no bank conflicts)
constexpr int kMaxSplits = 16;   // dW point ranges at most (ops/wide_mlp.py WIDE_MAX_SPLITS)
constexpr int kSumRows = 128;    // colsum_kernel's row ranges at most (WIDE_SUM_PARTS)
// f32((1/127)^2), the 'i8pair' dW scale factor (ops/fused_mlp.py _INV_COS_SQ)
constexpr float kInvCosSq = static_cast<float>((1.0 / 127.0) * (1.0 / 127.0));

// One operand as stored: element (r, k) of a K-major operand at ptr[r ld + k],
// of an MN-major one at ptr[k ld + r].
struct Operand {
  const __nv_bfloat16* ptr;
  long long ld;
};

struct Gemm {
  Operand a, b;
  int m, n;           // the outputs (rows, columns) the epilogue sees
  int m_load, n_load; // the extents loaded along m and n (multiples of 8 where MN-major)
  int k;              // the contraction's extent
  int k_split;        // k a split (blockIdx.z), a multiple of kBK
};

template <bool kKMajor, int kRows>
struct Tile {
  static constexpr int kLd = kKMajor ? kBK + kPad : kRows + kPad;
  static constexpr int kElems = kKMajor ? kRows * kLd : kBK * kLd;
};

constexpr size_t gemm_smem_bytes() {
  return static_cast<size_t>(kStages) * 2 * (kBM * (kBK + kPad)) * sizeof(__nv_bfloat16);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending));
}

template <bool kTrans>
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  if constexpr (kTrans)
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
  else
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One operand's tile of stage `kt0` (k from kt0) into shared memory:
// K-major [128 rows][kBK], MN-major [kBK][128], 16-byte pieces, zero past
// the extents (rows r0 + .. < extent, k < k_end).
template <bool kKMajor>
__device__ __forceinline__ void load_tile(__nv_bfloat16* s, const Operand& op, int r0,
                                          int extent, int kt0, int k_end) {
  using T = Tile<kKMajor, kBM>;
  for (int c = threadIdx.x; c < kBM * kBK / 8; c += kThreads) {
    int r, kk;
    if constexpr (kKMajor) {
      r = c >> 2;
      kk = (c & 3) * 8;
    } else {
      kk = c >> 4;
      r = (c & 15) * 8;
    }
    const int gr = r0 + r, gk = kt0 + kk;
    const bool ok = gr < extent && gk < k_end;
    const __nv_bfloat16* src = op.ptr;
    if (ok)
      src += kKMajor ? static_cast<size_t>(gr) * op.ld + gk : static_cast<size_t>(gk) * op.ld + gr;
    cp_async16(s + (kKMajor ? r * T::kLd + kk : kk * T::kLd + r), src, ok);
  }
}

template <bool kAK, bool kBK_, class Epi>
__global__ void __launch_bounds__(kThreads) wide_gemm_kernel(const Gemm g, const Epi epi) {
  extern __shared__ __align__(16) unsigned char smem[];
  using TA = Tile<kAK, kBM>;
  using TB = Tile<kBK_, kBN>;
  auto* sa = reinterpret_cast<__nv_bfloat16*>(smem);
  auto* sb = sa + kStages * TA::kElems;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int kb = blockIdx.z * g.k_split;
  const int ke = min(g.k, kb + g.k_split);
  const int nk = ke > kb ? (ke - kb + kBK - 1) / kBK : 0;

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  auto load = [&](int stage, int kt) {
    load_tile<kAK>(sa + stage * TA::kElems, g.a, m0, g.m_load, kb + kt * kBK, ke);
    load_tile<kBK_>(sb + stage * TB::kElems, g.b, n0, g.n_load, kb + kt * kBK, ke);
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load(s, s);
    cp_async_commit();
  }
  // ldmatrix's row addresses: matrix j = lane / 8, its row lane % 8
  const int j = lane >> 3, r = lane & 7;
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int next = kt + kStages - 1;
    if (next < nk) load(next % kStages, next);
    cp_async_commit();
    const __nv_bfloat16* ta = sa + (kt % kStages) * TA::kElems;
    const __nv_bfloat16* tb = sb + (kt % kStages) * TB::kElems;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t af[4][4], bfr[2][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const int mb = wm * 64 + mt * 16;
        // a0 (m 0-7, k 0-7), a1 (m 8-15, k 0-7), a2 (m 0-7, k 8-15), a3
        if constexpr (kAK)
          ldsm_x4<false>(af[mt], ta + (mb + (j & 1) * 8 + r) * TA::kLd + kk + (j >> 1) * 8);
        else
          ldsm_x4<true>(af[mt], ta + (kk + (j >> 1) * 8 + r) * TA::kLd + mb + (j & 1) * 8);
      }
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        const int nb = wn * 32 + np * 16;
        // b (n 0-7, k 0-7), (n 0-7, k 8-15), (n 8-15, k 0-7), (n 8-15, k 8-15)
        if constexpr (kBK_)
          ldsm_x4<false>(bfr[np], tb + (nb + (j >> 1) * 8 + r) * TB::kLd + kk + (j & 1) * 8);
        else
          ldsm_x4<true>(bfr[np], tb + (kk + (j & 1) * 8 + r) * TB::kLd + nb + (j >> 1) * 8);
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma_bf16(acc[mt][nt], af[mt], bfr[nt >> 1][(nt & 1) * 2],
                   bfr[nt >> 1][(nt & 1) * 2 + 1]);
    }
  }
  cp_async_wait<0>();

  const int gq = lane >> 2, q = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm * 64 + mt * 16 + gq + 8 * h;
        const int col = n0 + wn * 32 + nt * 8 + 2 * q;
        if (row < g.m && col < g.n) epi(row, col, acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
      }
}

// Launch wide_gemm_kernel: grid (n tiles, m tiles, splits), 3 stages of
// dynamic shared memory (its limit raised on every launch: a few
// microseconds, and right on any device).
template <bool kAK, bool kBK_, class Epi>
cudaError_t launch_gemm(const Gemm& g, int splits, const Epi& epi, cudaStream_t s) {
  auto kernel = wide_gemm_kernel<kAK, kBK_, Epi>;
  const size_t bytes = gemm_smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid((g.n + kBN - 1) / kBN, (g.m + kBM - 1) / kBM, splits);
  kernel<<<grid, kThreads, bytes, s>>>(g, epi);
  return cudaGetLastError();
}

// ----------------------------------------------------------------- epilogues

// A Sine layer: y = reduce_2pi(acc + b), its bf16 sin to `act` (the next
// layer's input, row stride act_ld) and, by format, at column `at` + col
// of the stash rows (stride stash_ld): kStashInt8 the int8 cos8 to cs (act
// is the bf16 sin stash itself), kStashLsb the packed sin to hs,
// kStashI8pair the int8 round(127 sin) pairs to hs and the int8 cos8 H
// columns on, kStashBf16Cos (K4) the bf16 cos10 to cs (act the sin stash).
template <int kFmt>
struct FwdEpi {
  const float* bias;
  __nv_bfloat16* act;
  long long act_ld;
  void* hs;
  void* cs;
  long long stash_ld;
  long long at;
  int h;             // 'i8pair': the cos8 half's offset from the sin8 half

  __device__ __forceinline__ void operator()(int row, int col, float v0, float v1) const {
    const float2 b = *reinterpret_cast<const float2*>(bias + col);
    const float y0 = reduce_2pi(v0 + b.x), y1 = reduce_2pi(v1 + b.y);
    const float s0 = sin_poly(y0), s1 = sin_poly(y1);
    *reinterpret_cast<uint32_t*>(act + static_cast<size_t>(row) * act_ld + col) = pack_bf16(s0, s1);
    const size_t st = static_cast<size_t>(row) * stash_ld + at + col;
    if constexpr (kFmt == kStashInt8) {
      *reinterpret_cast<uint16_t*>(static_cast<int8_t*>(cs) + st) =
          static_cast<uint16_t>(pack_i8(cos8_q(y0), cos8_q(y1)));
    } else if constexpr (kFmt == kStashLsb) {
      *reinterpret_cast<uint32_t*>(static_cast<__nv_bfloat16*>(hs) + st) =
          pack_sin_csign(s0, __fmul_rn(y0, y0) > kHalfPiSq)
          | (pack_sin_csign(s1, __fmul_rn(y1, y1) > kHalfPiSq) << 16);
    } else if constexpr (kFmt == kStashI8pair) {
      // the sin rounded from f32, not from its bf16
      int8_t* q = static_cast<int8_t*>(hs) + st;
      *reinterpret_cast<uint16_t*>(q) = static_cast<uint16_t>(
          pack_i8(__float2int_rn(__fmul_rn(s0, kCosScale)), __float2int_rn(__fmul_rn(s1, kCosScale))));
      *reinterpret_cast<uint16_t*>(q + h) =
          static_cast<uint16_t>(pack_i8(cos8_q(y0), cos8_q(y1)));
    } else if constexpr (kFmt == kStashBf16Cos) {
      *reinterpret_cast<uint32_t*>(static_cast<__nv_bfloat16*>(cs) + st) =
          pack_bf16(cos10(y0), cos10(y1));
    }
  }
};

// The head: out[row, col] = acc + b_out[col], f32, d_output columns.
struct HeadEpi {
  const float* bias;
  float* out;
  int d_out;

  __device__ __forceinline__ void operator()(int row, int col, float v0, float v1) const {
    float* o = out + static_cast<size_t>(row) * d_out;
    o[col] = v0 + bias[col];
    if (col + 1 < d_out) o[col + 1] = v1 + bias[col + 1];
  }
};

// bf16(sign sqrt(max(1 - s^2, 0))) of the packed 'lsb' sin s, every
// operation rounded on its own (unpack_sin_cos)
__device__ __forceinline__ float lsb_gate(uint16_t bits) {
  const float s = __bfloat162float(__ushort_as_bfloat16(bits));
  const float c = __fsqrt_rn(fmaxf(__fsub_rn(1.0f, __fmul_rn(s, s)), 0.0f));
  return bf16_round((bits & 1u) ? -c : c);
}

// The chain: dz = bf16(bf16(acc) * gate) of a layer, the gate at column
// `at` + col of its stash rows (stride stash_ld) by format: kStashInt8 the
// int8 cs, kStashLsb the packed sin hs, kStashI8pair the int8 cos8 of the
// pairs hs, kStashBf16Cos the bf16 cs.
template <int kFmt>
struct ChainEpi {
  __nv_bfloat16* dz;
  int h;
  const void* gate;
  long long stash_ld;
  long long at;

  __device__ __forceinline__ void operator()(int row, int col, float v0, float v1) const {
    const size_t st = static_cast<size_t>(row) * stash_ld + at + col;
    float g0, g1;
    if constexpr (kFmt == kStashInt8 || kFmt == kStashI8pair) {
      const int8_t* c = static_cast<const int8_t*>(gate) + st;
      g0 = cos_dequant(c[0]);
      g1 = cos_dequant(c[1]);
    } else if constexpr (kFmt == kStashLsb) {
      const uint32_t w = *reinterpret_cast<const uint32_t*>(static_cast<const __nv_bfloat16*>(gate) + st);
      g0 = lsb_gate(static_cast<uint16_t>(w & 0xFFFFu));
      g1 = lsb_gate(static_cast<uint16_t>(w >> 16));
    } else {
      const __nv_bfloat162 c = *reinterpret_cast<const __nv_bfloat162*>(
          static_cast<const __nv_bfloat16*>(gate) + st);
      g0 = __low2float(c);
      g1 = __high2float(c);
    }
    *reinterpret_cast<uint32_t*>(dz + static_cast<size_t>(row) * h + col) =
        pack_bf16(__fmul_rn(bf16_round(v0), g0), __fmul_rn(bf16_round(v1), g1));
  }
};

// f32 outputs [rows][ld] at blockIdx.z's slice (`slice` elements a split):
// the dW partials, or denc (one split).
struct StoreEpi {
  float* out;
  long long ld;
  long long slice;

  __device__ __forceinline__ void operator()(int row, int col, float v0, float v1) const {
    float* o = out + blockIdx.z * slice + static_cast<size_t>(row) * ld + col;
    o[0] = v0;
    if (col + 1 < ld) o[1] = v1;
  }
};

// ------------------------------------------------------------ small kernels

// The encoding [x, sin u, cos u, grid features, zeros] of each point as
// bf16 rows of e_pad, as the plain version computes it: a thread a point,
// u = x[dim] * freq in f32, cos u = sin(u + pi/2) with the sum rounded to
// f32, each grid level's features grid_level_features'.
__global__ void encode_kernel(const float* pts, const int* col_dim, const float* col_freq,
                              const GridParams grid, __nv_bfloat16* enc, int n, int d_in,
                              int n_cols, int e_pad) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float* x = pts + static_cast<size_t>(i) * d_in;
  __nv_bfloat16* e = enc + static_cast<size_t>(i) * e_pad;
  for (int a = 0; a < d_in; ++a) e[a] = __float2bfloat16_rn(__ldg(x + a));
  for (int j = 0; j < n_cols; ++j) {
    const float u = __fmul_rn(__ldg(x + __ldg(col_dim + j)), __ldg(col_freq + j));
    e[d_in + j] = __float2bfloat16_rn(fast_sin(u));
    e[d_in + n_cols + j] = __float2bfloat16_rn(fast_sin(__fadd_rn(u, kHalfPi)));
  }
  int c = d_in + 2 * n_cols;
  for (int l = 0; l < grid.n_levels; ++l, c += grid.features)
    grid_level_features<4>(grid, l, x, [&](int f, float v) {
      e[c + f] = __float2bfloat16_rn(v);
    });
  for (; c < e_pad; ++c) e[c] = __float2bfloat16_rn(0.f);
}

// dy [n, d_out] f32 -> bf16 [n, ld] (columns past d_out zero): the
// chain's first A operand and dW_out's B.
__global__ void dy_bf16_kernel(const float* dy, __nv_bfloat16* out, int n, int d_out, int ld) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= static_cast<long long>(n) * ld) return;
  const int row = static_cast<int>(t / ld), col = static_cast<int>(t % ld);
  out[t] = __float2bfloat16_rn(col < d_out ? dy[static_cast<size_t>(row) * d_out + col] : 0.f);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// part[y][col] = the sum of in[row, col] over range y of the rows, in a
// fixed order (8 interleaved sums a column, then those 8 in order): a block
// of 32 x 8 threads a (32 columns, row range).
template <typename T>
__global__ void colsum_kernel(const T* in, long long ld, int n, int cols, int rows_per,
                              float* part) {
  __shared__ float red[8][33];
  const int col = blockIdx.x * 32 + threadIdx.x;
  const int r0 = blockIdx.y * rows_per, r1 = min(n, r0 + rows_per);
  float s = 0.f;
  if (col < cols)
    for (int row = r0 + threadIdx.y; row < r1; row += 8) s += to_f32(in[static_cast<size_t>(row) * ld + col]);
  red[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && col < cols) {
    float total = 0.f;
#pragma unroll
    for (int y = 0; y < 8; ++y) total += red[y][threadIdx.x];
    part[static_cast<size_t>(blockIdx.y) * cols + col] = total;
  }
}

// out[e] = the sum over s < S of part[s][e], in order.
__global__ void sum_parts_kernel(const float* part, int S, size_t P, float* out) {
  const size_t e = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= P) return;
  float s = 0.f;
  for (int i = 0; i < S; ++i) s += part[static_cast<size_t>(i) * P + e];
  out[e] = s;
}

inline cudaError_t sum_parts(const float* part, int S, size_t P, float* out, cudaStream_t s) {
  sum_parts_kernel<<<static_cast<unsigned>((P + 255) / 256), 256, 0, s>>>(part, S, P, out);
  return cudaGetLastError();
}

// The bias gradient: column sums of in [n, cols] (row stride ld) into out
// [cols], through part [kSumRows][cols].
template <typename T>
cudaError_t column_sums(const T* in, long long ld, int n, int cols, float* part, float* out,
                        cudaStream_t s) {
  const int ranges = min(kSumRows, max(1, (n + 1023) / 1024));
  const int rows_per = (n + ranges - 1) / ranges;
  colsum_kernel<T><<<dim3((cols + 31) / 32, ranges), dim3(32, 8), 0, s>>>(in, ld, n, cols,
                                                                          rows_per, part);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return sum_parts(part, ranges, static_cast<size_t>(cols), out, s);
}

// The split of a dW product's points: enough ranges for about two blocks
// an SM, at least 1024 points a range, at most kMaxSplits; k_split a
// multiple of kBK.
inline void dw_split(int m, int n_out, int points, int sms, int& splits, int& k_split) {
  const int tiles = ((m + kBM - 1) / kBM) * ((n_out + kBN - 1) / kBN);
  int want = (2 * sms + tiles - 1) / tiles;
  want = max(1, min(want, min(kMaxSplits, (points + 1023) / 1024)));
  k_split = ((points + want - 1) / want + kBK - 1) / kBK * kBK;
  splits = max(1, (points + k_split - 1) / k_split);
}

// ------------------------------------------------------------ 'i8pair' dW_h

// out[row, c] = bf16(bf16(q) * bf16(1/127)) of the int8 stash columns
// [col0, col0 + h) of rows of stride ld: the layer's dequantized sin, the
// bf16 A operand of dW_out.
__global__ void i8_dequant_kernel(const int8_t* q, long long ld, long long col0, int n, int h,
                                  __nv_bfloat16* out) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= static_cast<long long>(n) * h) return;
  const long long row = t / h;
  out[t] = __float2bfloat16_rn(cos_dequant(q[row * ld + col0 + t % h]));
}

// gmax[g] = the bits of max |dz| over group g's rows [g G, (g+1) G) below n
// and every column (non-negative floats order as their bits, NaN above
// every finite one, as jnp.max propagates it): a block a group.
__global__ void group_max_kernel(const __nv_bfloat16* dz, int n, int h, int group,
                                 unsigned int* gmax) {
  __shared__ unsigned int best;
  if (threadIdx.x == 0) best = 0u;
  __syncthreads();
  const long long r0 = static_cast<long long>(blockIdx.x) * group;
  const long long end = min(static_cast<long long>(n), r0 + group) * h;
  unsigned int m = 0u;
  for (long long t = r0 * h + threadIdx.x; t < end; t += blockDim.x)
    m = max(m, __float_as_uint(fabsf(__bfloat162float(dz[t]))));
  atomicMax(&best, m);
  __syncthreads();
  if (threadIdx.x == 0) gmax[blockIdx.x] = best;
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 4 bytes of column c of an int8 tile [rows][kI8Ld], rows k .. k+3: an
// m16n8k32 fragment register (row k in the low byte)
constexpr int kI8Ld = kBM + 16;
__device__ __forceinline__ uint32_t i8_column4(const int8_t* s, int k, int c) {
  return (static_cast<uint32_t>(static_cast<uint8_t>(s[k * kI8Ld + c])))
         | (static_cast<uint32_t>(static_cast<uint8_t>(s[(k + 1) * kI8Ld + c])) << 8)
         | (static_cast<uint32_t>(static_cast<uint8_t>(s[(k + 2) * kI8Ld + c])) << 16)
         | (static_cast<uint32_t>(static_cast<uint8_t>(s[(k + 3) * kI8Ld + c])) << 24);
}

// 'i8pair' dW_h = sin8^T dz8 on the int8 tensor cores (mma.sync m16n8k32
// s32.s8.s8), K6b's _dw_i8: per group of `group` points (a multiple of 32,
// so a 32-point tile lies in one group) dz is quantized with scale 127 / m
// (m the group's max |dz|, a rounded division; 0 where m = 0) to
// round_half_even(dz scale); the group's exact int32 sum goes to f32 and is
// scaled by f32(m (1/127)^2) into f32 accumulators, group after group in
// order. A block takes a 128 x 128 tile of dW over its split's points
// (whole groups), loading each 32-point tile of sin8 (as stored) and of dz
// (quantized on the way) into shared memory; out is the split's f32
// partials [m][n].
__global__ void __launch_bounds__(kThreads) dw_i8_kernel(
    const int8_t* s8, long long s8_ld, const __nv_bfloat16* dz, int h, int n_pts,
    const unsigned int* gmax, int group, int k_split, float* out) {
  __shared__ int8_t sa[kBK * kI8Ld];
  __shared__ int8_t sb[kBK * kI8Ld];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int kb = blockIdx.z * k_split;
  const int ke = min(n_pts, kb + k_split);
  int acc_i[4][4][4];
  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc_i[i][j][e] = 0;
        acc[i][j][e] = 0.f;
      }
  const int gq = lane >> 2, q = lane & 3;
  for (int k0 = kb; k0 < ke; k0 += kBK) {
    const float m = __uint_as_float(gmax[k0 / group]);
    const float scale = m > 0.f ? __fdiv_rn(kCosScale, m) : 0.f;
    // the tiles: thread t takes 16 columns of one point row of each
    const int r = threadIdx.x >> 3, c = (threadIdx.x & 7) * 16;
    const int pt = k0 + r;
    int4 va = make_int4(0, 0, 0, 0);
    int8_t vb[16];
    if (pt < ke) {
      if (m0 + c < h)
        va = *reinterpret_cast<const int4*>(s8 + static_cast<size_t>(pt) * s8_ld + m0 + c);
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const float x = n0 + c + e < h
                            ? __bfloat162float(dz[static_cast<size_t>(pt) * h + n0 + c + e]) : 0.f;
        vb[e] = static_cast<int8_t>(__float2int_rn(__fmul_rn(x, scale)));
      }
    } else {
#pragma unroll
      for (int e = 0; e < 16; ++e) vb[e] = 0;
    }
    __syncthreads();
    *reinterpret_cast<int4*>(sa + r * kI8Ld + c) = va;
#pragma unroll
    for (int e = 0; e < 16; ++e) sb[r * kI8Ld + c + e] = vb[e];
    __syncthreads();
    uint32_t af[4][4], bfr[4][2];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      const int row = wm * 64 + mt * 16 + gq;
      af[mt][0] = i8_column4(sa, 4 * q, row);
      af[mt][1] = i8_column4(sa, 4 * q, row + 8);
      af[mt][2] = i8_column4(sa, 16 + 4 * q, row);
      af[mt][3] = i8_column4(sa, 16 + 4 * q, row + 8);
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int col = wn * 32 + nt * 8 + gq;
      bfr[nt][0] = i8_column4(sb, 4 * q, col);
      bfr[nt][1] = i8_column4(sb, 16 + 4 * q, col);
    }
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) mma_s8(acc_i[mt][nt], af[mt], bfr[nt][0], bfr[nt][1]);
    // the group's end (or the split's): its exact sum, scaled, into f32
    if ((k0 + kBK) % group == 0 || k0 + kBK >= ke) {
      const float f = __fmul_rn(m, kInvCosSq);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[i][j][e] = __fadd_rn(acc[i][j][e],
                                     __fmul_rn(static_cast<float>(acc_i[i][j][e]), f));
            acc_i[i][j][e] = 0;
          }
    }
  }
  float* o = out + static_cast<size_t>(blockIdx.z) * h * h;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = m0 + wm * 64 + mt * 16 + gq + 8 * (e >> 1);
        const int col = n0 + wn * 32 + nt * 8 + 2 * q + (e & 1);
        if (row < h && col < h) o[static_cast<size_t>(row) * h + col] = acc[mt][nt][e];
      }
}

// The arguments of both entries (ops/wide_mlp.py _WideArgs), by pointer.
struct WideArgs {
  const float* pts;             // [n, d_in]
  const int* col_dim;           // [n_cols]
  const float* col_freq;        // [n_cols]
  const __nv_bfloat16* w_in_t;  // forward: w_in^T [H, e_pad] (zero past E)
  const __nv_bfloat16* w_h_t;   // forward: w_h[i]^T [L-1, H, H]
  const __nv_bfloat16* w_out_t; // forward: w_out^T [d_out, H]
  const float* b_in;            // [H]
  const float* b_h;             // [L-1, H]
  const float* b_out;           // [d_out]
  const void* grid;             // GridParams (ops/fused_mlp.py _GridArgs), or null
  float* out;                   // forward: [n, d_out]
  __nv_bfloat16* act;           // forward: two [n, H] buffers (K0 and 'lsb'), or null
  __nv_bfloat16* enc;           // [n, e_pad] scratch
  void* hs;                     // the stash: [n, L H] bf16 ('int8' sin, 'lsb' packed, K4 sin)
  void* cs;                     // [n, L H] int8 ('int8') or bf16 (K4), or null
  // backward
  const float* dy;              // [n, d_out]
  const __nv_bfloat16* w_h_b;   // w_h as stored [L-1, H, H], bf16
  const __nv_bfloat16* w_out_b; // w_out as stored [H, o_pad], zero past d_out
  const __nv_bfloat16* w_in_b;  // w_in as stored [E, H], bf16
  __nv_bfloat16* dyb;           // [n, o_pad] scratch
  __nv_bfloat16* dz;            // two [n, H] scratch buffers
  float* part;                  // [kMaxSplits * max(e_pad H, H H, H d_out)] dW partials
  float* part_sum;              // [kSumRows * max(H, d_out)] column-sum partials
  float* g_w_in;                // [e_pad, H]
  float* g_b_in;                // [H]
  float* g_w_h;                 // [L-1, H, H]
  float* g_b_h;                 // [L-1, H]
  float* g_w_out;               // [H, d_out]
  float* g_b_out;               // [d_out]
  float* denc;                  // K3: [n, d_in + 2 n_cols] scratch, or null
  float* dpts;                  // K3: [n, d_in], or null
  float* dgrid;                 // K5: [n, levels F] scratch
  unsigned int* gmax;           // K5: [levels], zeroed
  unsigned long long* gacc;     // K5: [sum G^3 F], zeroed
  float* g_grid;                // K5: [sum G^3 F]
  unsigned int* group_max;      // 'i8pair': [ceil(n / group)] scratch
  int n, d_in, n_cols, e_pad, h, n_hidden, d_out, o_pad, fmt;
  int group;                    // 'i8pair': dz's scale group, a multiple of 32
};

}  // namespace wide
}  // namespace sunerf
