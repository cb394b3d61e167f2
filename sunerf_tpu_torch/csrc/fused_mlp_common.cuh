// Device code shared by the fused-MLP kernels for Hopper (sm_90a): the
// stashing forwards K1, K6a and K6b (fused_mlp_stash_fwd.cu) and the
// recompute backward's forward pass (fused_mlp_recompute_bwd.cu), each with
// the dense feature-grid branch K5, and the sine, bf16 and grid helpers of
// the forward K0 (fused_mlp_fwd_wgmma.cu). The backwards share
// fused_mlp_backward.cuh. See those files for what each replaces and what
// bounds it.
//
// The block layout of K1 and of K2's chain kernel: 8 warps per 64
// points; bf16 activations [64, width + 8] in dynamic shared memory; every
// warp owns H/8 output columns for all 64 rows and runs mma.sync m16n8k16
// bf16 -> f32 against weights packed in B-fragment order
// (ops/fused_mlp.py pack_fragments), read from global memory (L2-resident)
// one k-step ahead.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sunerf {

constexpr int kRows = 64;             // points per block
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kPad = 8;               // bf16 elements of row padding
constexpr int kCosPad = 16;           // int8 elements of row padding
constexpr int kRowsPerWarp = kRows / kWarps;

constexpr int kMaxLevels = 4;         // feature-grid levels the kernels take

constexpr float kTwoPi = 6.283185307179586f;
constexpr float kInvTwoPi = 0.15915494309189535f;
constexpr float kHalfPi = 1.5707963267948966f;
constexpr float kCosScale = 127.0f;
constexpr float kHalfPiSq = 2.4674011002723395f;   // (pi/2)^2 rounded to f32

// What a forward writes beside its output: the bf16 sin and
// int8 cos stashes (K1, 'int8'), the packed bf16 sin with sign(cos) in its
// last bit (K6a, 'lsb'), the int8 sin and cos pairs (K6b, 'i8pair'), or the
// bf16 sin and bf16 cos of the recompute backward K4
enum Stash : int { kStashInt8 = 1, kStashLsb = 2, kStashI8pair = 3,
                   kStashBf16Cos = 4 };

// x - 2*pi*round(x / 2*pi), rounding 2*pi*k before subtracting (no fused
// multiply-add), as the plain version does: at |x| ~ 70 that rounding is
// worth ~4e-6, enough to flip bf16 roundings downstream.
__device__ __forceinline__ float reduce_2pi(float x) {
  return x - __fmul_rn(kTwoPi, rintf(x * kInvTwoPi));
}

// odd minimax polynomial for sin on [-pi, pi] (max abs err 9.6e-8), the
// coefficients of the TPU kernel's fast_sin
__device__ __forceinline__ float sin_poly(float y) {
  const float y2 = y * y;
  return y * (9.999995999e-01f + y2 * (-1.666655263e-01f + y2 * (8.332402961e-03f
         + y2 * (-1.980863262e-04f + y2 * (2.699713829e-06f
         + y2 * -2.036221213e-08f)))));
}

// sin of an unreduced argument: phases reach ~400 rad, where __sinf is wrong
__device__ __forceinline__ float fast_sin(float x) { return sin_poly(reduce_2pi(x)); }

// cos on a reduced argument by the TPU kernel's degree-8 even polynomial
// (_COS8_C, max abs err 4.1e-5), quantized to int8 as round-half-even(127 c)
// like jnp.round; it only gates the backward's dz, where 1/127 is the floor
__device__ __forceinline__ int cos8_q(float y) {
  const float y2 = y * y;
  const float c = 9.999598405e-01f + y2 * (-4.997933042e-01f + y2 * (4.149612510e-02f
                  + y2 * (-1.339285342e-03f + y2 * 1.879295230e-05f)));
  return __float2int_rn(c * kCosScale);
}

// cos on a reduced argument by the TPU kernel's degree-10 even polynomial
// (_COS_C of fast_sincos, max abs err 7.8e-7): the recompute backward's cos
__device__ __forceinline__ float cos10(float y) {
  const float y2 = y * y;
  return 9.999992216e-01f + y2 * (-4.999942681e-01f + y2 * (4.165982217e-02f
         + y2 * (-1.385891583e-03f + y2 * (2.420439995e-05f + y2 * -2.197887694e-07f))));
}

// The bits of bf16(s) with the last mantissa bit replaced by `neg`
// (_pack_sin_csign: 1 = cos < 0)
__device__ __forceinline__ uint32_t pack_sin_csign(float s, bool neg) {
  return (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(s))) & 0xFFFEu)
         | (neg ? 1u : 0u);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint2 b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// L2 policies: the weights, re-read by every block, stay (evict_last); the
// stash and scratch streams, each byte touched once, go first (evict_first)
__device__ __forceinline__ uint64_t l2_evict_last() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n" : "=l"(policy));
  return policy;
}

__device__ __forceinline__ uint64_t l2_evict_first() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(policy));
  return policy;
}

__device__ __forceinline__ uint2 load_weights(const uint2* p, uint64_t policy) {
  uint2 v;
  asm volatile("ld.global.L2::cache_hint.v2.u32 {%0, %1}, [%2], %3;\n"
               : "=r"(v.x), "=r"(v.y) : "l"(p), "l"(policy));
  return v;
}

// acc[64, H] (this warp's H/8 columns) = src[64, k] @ W, with W the packed
// B fragments of one layer: fragment (n-tile nt, k-step ks) of lane l is
// W[(nt * k/16 + ks) * 32 + l].
template <int H>
__device__ __forceinline__ void block_matmul(const __nv_bfloat16* src, int stride,
                                             int k, const uint2* w,
                                             float (&acc)[4][H / 64][4]) {
  constexpr int kTiles = H / 8 / kWarps;  // n-tiles of 8 columns per warp
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // fragment column pair
  const int k_steps = k / 16;

#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < kTiles; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

  const uint64_t keep = l2_evict_last();
  const uint2* wp = w + static_cast<size_t>(warp * kTiles) * k_steps * 32 + lane;
  uint2 b[kTiles], b_next[kTiles];
#pragma unroll
  for (int nt = 0; nt < kTiles; ++nt) {
    b[nt] = load_weights(wp + static_cast<size_t>(nt) * k_steps * 32, keep);
    b_next[nt] = b[nt];
  }

  for (int ks = 0; ks < k_steps; ++ks) {
    if (ks + 1 < k_steps) {
#pragma unroll
      for (int nt = 0; nt < kTiles; ++nt)
        b_next[nt] = load_weights(wp + (static_cast<size_t>(nt) * k_steps + ks + 1) * 32,
                                  keep);
    }
    uint32_t a[4][4];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      const __nv_bfloat16* ap = src + (mt * 16 + g) * stride + ks * 16 + t * 2;
      a[mt][0] = *reinterpret_cast<const uint32_t*>(ap);
      a[mt][1] = *reinterpret_cast<const uint32_t*>(ap + 8 * stride);
      a[mt][2] = *reinterpret_cast<const uint32_t*>(ap + 8);
      a[mt][3] = *reinterpret_cast<const uint32_t*>(ap + 8 * stride + 8);
    }
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < kTiles; ++nt) mma_bf16(acc[mt][nt], a[mt], b[nt]);
#pragma unroll
    for (int nt = 0; nt < kTiles; ++nt) b[nt] = b_next[nt];
  }
}

// Calls f(row, col, v0, v1) for each pair of neighbouring accumulators
// (row, col) and (row, col + 1) that this thread holds after block_matmul.
template <int H, typename F>
__device__ __forceinline__ void for_each_pair(const float (&acc)[4][H / 64][4], F&& f) {
  constexpr int kTiles = H / 8 / kWarps;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < kTiles; ++nt) {
    const int col = (warp * kTiles + nt) * 8 + t * 2;
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      const int row = mt * 16 + g;
      f(row, col, acc[mt][nt][0], acc[mt][nt][1]);
      f(row + 8, col, acc[mt][nt][2], acc[mt][nt][3]);
    }
  }
}

// The dense feature-grid levels (K5), the same struct on the host
// (ops/fused_mlp.py _GridArgs, passed by pointer) and in the kernels'
// parameters. Tables are the float32 parameters themselves, read through
// L2: the optimizer updates them in place, and nothing caches them.
struct GridParams {
  const float* table[kMaxLevels];   // [G, G, G, F] f32, axis order (y, z, x, f)
  int size[kMaxLevels];             // G of each level
  int n_levels;                     // 0 = no grid
  int features;                     // F
  float bound;                      // the tables span [-bound, bound]^3
};

inline GridParams grid_params(const void* grid) {
  GridParams g{};
  if (grid != nullptr) g = *static_cast<const GridParams*>(grid);
  return g;
}

inline bool grid_ok(const GridParams& g) {
  if (g.n_levels < 0 || g.n_levels > kMaxLevels) return false;
  if (g.n_levels == 0) return true;
  if (g.features < 1 || !(g.bound > 0.f)) return false;
  for (int l = 0; l < g.n_levels; ++l)
    if (g.table[l] == nullptr || g.size[l] < 2) return false;
  return true;
}

// The lower cell corner lo and the offset fr from it, per axis, of point x
// in a level of G cells a side: u = clip((x / bound + 1) * (G-1)/2, 0, G-1),
// lo = clip(floor(u), 0, G-2), fr = u - lo (ops/grid_encoding.py _cell).
// Every operation rounds on its own, as the plain version's tensor ops do.
__device__ __forceinline__ void grid_cell(const float* x, int G, float bound,
                                          int (&lo)[3], float (&fr)[3]) {
  const float scale = 0.5f * static_cast<float>(G - 1);
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float u = fminf(fmaxf(__fmul_rn(__fadd_rn(__fdiv_rn(x[a], bound), 1.0f), scale),
                                0.0f), static_cast<float>(G - 1));
    const float l = fminf(fmaxf(floorf(u), 0.0f), static_cast<float>(G - 2));
    lo[a] = static_cast<int>(l);
    fr[a] = __fsub_rn(u, l);
  }
}

// Corner c = 4 dx + 2 dy + dz of a cell: its weight (wx * wy) * wz and its
// table row (iy * G + iz) * G + ix (ops/grid_encoding.py _corners).
__device__ __forceinline__ float grid_corner(const int (&lo)[3], const float (&fr)[3],
                                             int G, int c, int& row) {
  const int dx = c >> 2, dy = (c >> 1) & 1, dz = c & 1;
  const float wx = dx ? fr[0] : __fsub_rn(1.0f, fr[0]);
  const float wy = dy ? fr[1] : __fsub_rn(1.0f, fr[1]);
  const float wz = dz ? fr[2] : __fsub_rn(1.0f, fr[2]);
  row = ((lo[1] + dy) * G + lo[2] + dz) * G + lo[0] + dx;
  return __fmul_rn(__fmul_rn(wx, wy), wz);
}

// Feature f of grid level `level` at point x: the trilinear interpolation
// of ops/grid_encoding.py grid_encode, corners summed in the same order with
// the same roundings, so both give the same bits. 8 loads from L2.
__device__ __forceinline__ float grid_feature(const GridParams& g, int level,
                                              const float* x, int f) {
  const int G = g.size[level];
  int lo[3];
  float fr[3];
  grid_cell(x, G, g.bound, lo, fr);
  const float* t = g.table[level];
  float acc = 0.f;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    int row;
    const float w = grid_corner(lo, fr, G, c, row);
    acc = __fadd_rn(acc, __fmul_rn(w, __ldg(t + static_cast<size_t>(row) * g.features + f)));
  }
  return acc;
}

// Encoding of the block's 64 points, [x, sin u, cos u, grid features] with
// u_j = x[dim_j] * freq_j (f32, exact: each phase column has one
// power-of-two frequency) and the grid levels' F features each after the
// sin/cos columns, as bf16 into dst[64, e_pad]; zero past the encoded
// columns and past row n.
__device__ __forceinline__ void encode_tile(const float* pts, const int* col_dim,
                                            const float* col_freq, const GridParams& grid,
                                            int n, int d_in, int n_cols, int e_pad,
                                            int row0, __nv_bfloat16* dst, int stride) {
  const int grid0 = d_in + 2 * n_cols;
  const int grid_end = grid0 + grid.n_levels * grid.features;
  for (int idx = threadIdx.x; idx < kRows * e_pad; idx += kThreads) {
    const int r = idx / e_pad;
    const int c = idx - r * e_pad;
    const int gr = row0 + r;
    float v = 0.f;
    if (gr < n) {
      const float* x = pts + static_cast<size_t>(gr) * d_in;
      if (c < d_in) {
        v = x[c];
      } else if (c < grid0) {
        const int j = (c - d_in) % n_cols;
        const float u = __fmul_rn(x[col_dim[j]], col_freq[j]);
        // cos(u) = sin(u + pi/2), as the TPU kernel's fast_cos
        v = fast_sin(c < d_in + n_cols ? u : __fadd_rn(u, kHalfPi));
      } else if (c < grid_end) {
        const int j = c - grid0;
        v = grid_feature(grid, j / grid.features, x, j % grid.features);
      }
    }
    dst[r * stride + c] = __float2bfloat16_rn(v);
  }
}

// Copies `width` bytes of each of the block's rows below n from shared
// memory (row stride src_stride bytes) to global memory (row stride
// dst_stride bytes), 16 bytes per thread and store.
__device__ __forceinline__ void store_rows(const void* src, int src_stride,
                                           void* dst, size_t dst_stride, int width,
                                           int row0, int n) {
  const int vecs = width / 16;
  for (int idx = threadIdx.x; idx < kRows * vecs; idx += kThreads) {
    const int r = idx / vecs;
    const int v = idx - r * vecs;
    if (row0 + r < n)
      *reinterpret_cast<uint4*>(static_cast<char*>(dst)
                                + static_cast<size_t>(row0 + r) * dst_stride + v * 16) =
          *reinterpret_cast<const uint4*>(static_cast<const char*>(src)
                                          + r * src_stride + v * 16);
  }
}

// The reverse of store_rows; rows at or past n read zeros.
__device__ __forceinline__ void load_rows(const void* src, size_t src_stride,
                                          void* dst, int dst_stride, int width,
                                          int row0, int n) {
  const int vecs = width / 16;
  for (int idx = threadIdx.x; idx < kRows * vecs; idx += kThreads) {
    const int r = idx / vecs;
    const int v = idx - r * vecs;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n)
      val = *reinterpret_cast<const uint4*>(static_cast<const char*>(src)
                                            + static_cast<size_t>(row0 + r) * src_stride
                                            + v * 16);
    *reinterpret_cast<uint4*>(static_cast<char*>(dst) + r * dst_stride + v * 16) = val;
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Asynchronous row copies out of shared memory by the bulk-copy (TMA)
// engine: thread r < 64 copies row r, if below n, with one
// cp.async.bulk, and commits it as its bulk group. The warps go on at once.
// Before the rows are written again, bulk_wait_read() (every thread) and a
// barrier; before they are copied, the writers' fence_proxy_async() and a
// barrier, so the copy engine sees the threads' writes.
__device__ __forceinline__ void store_rows_bulk(const void* src, int src_stride,
                                                void* dst, size_t dst_stride,
                                                int width, int row0, int n) {
  const int r = threadIdx.x;
  if (r < kRows && row0 + r < n) {
    asm volatile(
        "cp.async.bulk.global.shared::cta.bulk_group.L2::cache_hint [%0], [%1], %2, %3;\n"
        :: "l"(static_cast<char*>(dst) + static_cast<size_t>(row0 + r) * dst_stride),
           "r"(smem_addr(static_cast<const char*>(src) + r * src_stride)), "r"(width),
           "l"(l2_evict_first())
        : "memory");
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  }
}

// this thread's bulk copies have read their shared-memory source
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// this thread's bulk copies are complete
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// this thread's shared-memory writes are visible to the copy engine
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// load_rows with cp.async: 16 bytes per thread and copy, zero-filled past
// row n, landing by cp_async_wait_all() and a barrier
__device__ __forceinline__ void load_rows_async(const void* src, size_t src_stride,
                                                void* dst, int dst_stride, int width,
                                                int row0, int n) {
  const int vecs = width / 16;
  const uint64_t stream = l2_evict_first();
  for (int idx = threadIdx.x; idx < kRows * vecs; idx += kThreads) {
    const int r = idx / vecs;
    const int v = idx - r * vecs;
    const bool valid = row0 + r < n;
    const char* g = static_cast<const char*>(src)
        + (valid ? static_cast<size_t>(row0 + r) * src_stride + v * 16 : 0);
    asm volatile("cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2, %3;\n"
                 :: "r"(smem_addr(static_cast<char*>(dst) + r * dst_stride + v * 16)),
                    "l"(g), "r"(valid ? 16 : 0), "l"(stream)
                 : "memory");
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Forward of K1, K6a, K6b and K4's recompute: kFmt (Stash) picks what
// each layer writes beside the output, row-major with L = n_hidden + 1:
// K1 hs bf16 [n, L*H] and cs int8 [n, L*H]; K6a hs packed bf16 [n, L*H];
// K6b hs int8 [n, 2*L*H], layer i's sin in columns [2iH, 2iH + H) and its
// cos in [2iH + H, 2(i+1)H); K4 hs bf16 [n, L*H] and cs bf16 [n, L*H].
struct FwdParams {
  const float* pts;          // [n, d_in]
  const int* col_dim;        // [n_cols] input dim of each phase column
  const float* col_freq;     // [n_cols] frequency of each phase column
  const uint2* w_in;         // [H/8][e_pad/16][32] packed bf16 fragments
  const float* b_in;         // [H]
  const uint2* w_h;          // [L-1][H/8][H/16][32] packed bf16 fragments
  const float* b_h;          // [L-1][H]
  const __nv_bfloat16* w_out;  // [d_out][H]
  const float* b_out;        // [d_out]
  float* out;                // [n, d_out]
  void* hs;                  // the sin stash (see above)
  void* cs;                  // the cos stash of K1 and K4, else null
  GridParams grid;
  int n, d_in, n_cols, e_pad, n_hidden, d_out;
};

template <int H>
__host__ __device__ constexpr int act_stride(int e_pad) {
  return (H > e_pad ? H : e_pad) + kPad;
}

// The stashing forwards add staging tiles after the two activation
// buffers: K1 two int8 cos tiles [64, H + 16] (alternating by layer), K6a
// and K6b one tile [64, 2H + 16] bytes (bf16 [64, H + 8] or the int8
// pairs), which fits in the same bytes; K4's recompute keeps K1's layout
// and writes its bf16 cos from the registers.
template <int H, int kFmt>
__host__ __device__ constexpr size_t fwd_smem_bytes(int e_pad) {
  return 2 * kRows * act_stride<H>(e_pad) * sizeof(__nv_bfloat16)
         + 2 * kRows * (H + kCosPad);
}

template <int H, int kFmt>
__global__ void __launch_bounds__(kThreads, 1) fused_mlp_fwd_kernel(FwdParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int stride = act_stride<H>(p.e_pad);
  constexpr int kCosStride = H + kCosPad;
  constexpr int kStage16 = H + kPad;          // bf16 staging row stride (K6a)
  constexpr int kStage8 = 2 * H + 16;         // int8 pair staging row stride (K6b)
  __nv_bfloat16* cur = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* nxt = cur + kRows * stride;
  // K1: two int8 cos staging tiles, alternating by layer; K6a and K6b: one
  // staging tile in the same bytes
  int8_t* cq_tiles = reinterpret_cast<int8_t*>(nxt + kRows * stride);
  __nv_bfloat16* stage16 = reinterpret_cast<__nv_bfloat16*>(cq_tiles);
  const int row0 = blockIdx.x * kRows;
  const size_t stash_ld = static_cast<size_t>(p.n_hidden + 1) * H;

  encode_tile(p.pts, p.col_dim, p.col_freq, p.grid, p.n, p.d_in, p.n_cols, p.e_pad,
              row0, cur, stride);
  __syncthreads();

  for (int layer = 0; layer <= p.n_hidden; ++layer) {
    const uint2* w = layer == 0 ? p.w_in
        : p.w_h + static_cast<size_t>(layer - 1) * (H / 8) * (H / 16) * 32;
    const float* bias = layer == 0 ? p.b_in : p.b_h + static_cast<size_t>(layer - 1) * H;
    float acc[4][H / 64][4];
    // two call sites, so the hidden layers' depth H is a compile-time
    // constant and their k-loop unrolls
    if (layer == 0)
      block_matmul<H>(cur, stride, p.e_pad, w, acc);
    else
      block_matmul<H>(cur, stride, H, w, acc);
    if constexpr (kFmt == kStashInt8 || kFmt == kStashBf16Cos) {
      int8_t* cq = cq_tiles + (layer & 1) * kRows * kCosStride;
      for_each_pair<H>(acc, [&](int row, int col, float v0, float v1) {
        const float y0 = reduce_2pi(v0 + bias[col]);
        const float y1 = reduce_2pi(v1 + bias[col + 1]);
        *reinterpret_cast<uint32_t*>(nxt + row * stride + col) =
            pack_bf16(sin_poly(y0), sin_poly(y1));
        if constexpr (kFmt == kStashInt8) {
          char2 q;
          q.x = static_cast<char>(cos8_q(y0));
          q.y = static_cast<char>(cos8_q(y1));
          *reinterpret_cast<char2*>(cq + row * kCosStride + col) = q;
        } else if (row0 + row < p.n) {
          // K4's scratch bf16 cos, written from the registers: two staging
          // tiles of it do not fit beside the activations at H = 512
          *reinterpret_cast<uint32_t*>(static_cast<__nv_bfloat16*>(p.cs)
                                       + static_cast<size_t>(row0 + row) * stash_ld
                                       + layer * H + col) = pack_bf16(cos10(y0), cos10(y1));
        }
      });
      fence_proxy_async();
      // the previous layer's copies have read their tiles, which the next
      // layer's epilogue overwrites after this barrier; so one barrier a
      // layer, and the warps drift apart between barriers
      bulk_wait_read();
      __syncthreads();
      // the sin stash is the bf16 activation that feeds the next layer; the
      // copies overlap the next layer's products
      store_rows_bulk(nxt, stride * 2, static_cast<__nv_bfloat16*>(p.hs) + layer * H,
                      stash_ld * 2, H * 2, row0, p.n);
      if constexpr (kFmt == kStashInt8)
        store_rows_bulk(cq, kCosStride, static_cast<int8_t*>(p.cs) + layer * H, stash_ld, H,
                        row0, p.n);
    } else {
      // one staging tile: the previous layer's copy out of it has read it
      bulk_wait_read();
      __syncthreads();
      for_each_pair<H>(acc, [&](int row, int col, float v0, float v1) {
        const float y0 = reduce_2pi(v0 + bias[col]);
        const float y1 = reduce_2pi(v1 + bias[col + 1]);
        const float s0 = sin_poly(y0);
        const float s1 = sin_poly(y1);
        // the next layer takes bf16(sin) in every format, so out is K1's
        *reinterpret_cast<uint32_t*>(nxt + row * stride + col) = pack_bf16(s0, s1);
        if constexpr (kFmt == kStashLsb) {
          *reinterpret_cast<uint32_t*>(stage16 + row * kStage16 + col) =
              pack_sin_csign(s0, __fmul_rn(y0, y0) > kHalfPiSq)
              | (pack_sin_csign(s1, __fmul_rn(y1, y1) > kHalfPiSq) << 16);
        } else {
          // the sin rounded from f32, not from its bf16
          char2 q;
          q.x = static_cast<char>(__float2int_rn(__fmul_rn(s0, kCosScale)));
          q.y = static_cast<char>(__float2int_rn(__fmul_rn(s1, kCosScale)));
          int8_t* stage8 = cq_tiles + row * kStage8;
          *reinterpret_cast<char2*>(stage8 + col) = q;
          q.x = static_cast<char>(cos8_q(y0));
          q.y = static_cast<char>(cos8_q(y1));
          *reinterpret_cast<char2*>(stage8 + H + col) = q;
        }
      });
      fence_proxy_async();
      __syncthreads();
      if constexpr (kFmt == kStashLsb)
        store_rows_bulk(stage16, kStage16 * 2, static_cast<__nv_bfloat16*>(p.hs) + layer * H,
                        stash_ld * 2, H * 2, row0, p.n);
      else
        store_rows_bulk(cq_tiles, kStage8, static_cast<int8_t*>(p.hs) + layer * 2 * H,
                        2 * stash_ld, 2 * H, row0, p.n);
    }
    __nv_bfloat16* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }

  // linear output layer: per-point f32 dot products over the last activations
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int r = warp * kRowsPerWarp + rr;
    const int gr = row0 + r;
    for (int o = 0; o < p.d_out; ++o) {
      float s = 0.f;
      for (int c = lane; c < H; c += 32)
        s += __bfloat162float(cur[r * stride + c]) *
             __bfloat162float(p.w_out[o * H + c]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off);
      if (lane == 0 && gr < p.n)
        p.out[static_cast<size_t>(gr) * p.d_out + o] = s + p.b_out[o];
    }
  }
  bulk_wait();
}

template <int H, int kFmt>
cudaError_t launch_fwd(const FwdParams& p, cudaStream_t stream) {
  const size_t smem = fwd_smem_bytes<H, kFmt>(p.e_pad);
  cudaError_t err = cudaFuncSetAttribute(
      fused_mlp_fwd_kernel<H, kFmt>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.n + kRows - 1) / kRows);
  fused_mlp_fwd_kernel<H, kFmt><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int kFmt>
int fused_mlp_fwd_entry(const FwdParams& p, int d_filter, void* stream) {
  if (p.n <= 0 || p.e_pad % 16 != 0 || !grid_ok(p.grid) ||
      p.e_pad < p.d_in + 2 * p.n_cols + p.grid.n_levels * p.grid.features ||
      (kFmt != kStashInt8 && p.grid.n_levels > 0))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (d_filter) {
    case 64: err = launch_fwd<64, kFmt>(p, s); break;
    case 128: err = launch_fwd<128, kFmt>(p, s); break;
    case 256: err = launch_fwd<256, kFmt>(p, s); break;
    case 384: err = launch_fwd<384, kFmt>(p, s); break;
    case 512: err = launch_fwd<512, kFmt>(p, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // namespace sunerf
