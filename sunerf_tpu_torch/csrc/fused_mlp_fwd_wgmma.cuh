// Fused positional encoding + Sine MLP forward for Hopper (sm_90a) by
// wgmma, one kernel for every forward of the port: K0 (the no-grad
// forward of every render, fused_mlp_fwd_wgmma.cu), the stashing forwards
// K1, K6a and K6b (fused_mlp_stash_fwd.cu) and K4's recompute forward
// (fused_mlp_recompute_bwd.cu). The template's kFmt (Stash) picks what each
// layer's epilogue writes beside the activations; everything else is K0's.
//
// Replaces the TPU kernels sunerf_tpu/ops/pallas/fused_mlp.py:_fwd_kernel
// (pallas_call :410, the custom_vjp primal that serves every no-grad
// render) and _fwd_stash_kernel (:453, pallas_call :715, the training
// forward), with _fwd_stash_lsb_kernel (:481) and _fwd_stash_i8pair_kernel
// (:503). Same function:
//   enc = [x, sin(u), cos(u)],  u_j = x[dim_j] * freq_j   (f32, exact: each
//         phase column has one power-of-two frequency, as _freq_matrix)
//   h   = sin(bf16(enc) @ bf16(w_in) + b_in)
//   h   = sin(bf16(h) @ bf16(w_h[i]) + b_h[i])        for i < L-1
//   out = bf16(h) @ bf16(w_out) + b_out               (f32, no base offsets)
// with bf16 operands, f32 sums, f32 bias and sine; any d_in, d_out up to 8.
// Sines use the TPU kernel's explicit range reduction and odd degree-11
// polynomial (fast_sin): phases reach ~400 rad, where unreduced __sinf is
// wrong. With dense grid levels (K5, the grid branch of _fwd_kernel:
// _encode_grid/_grid_feats, fused_mlp.py:283-327) enc also holds each
// level's F trilinear features after the sin/cos columns, computed in f32
// from the float32 tables (grid_level_features in fused_mlp_common.cuh),
// any number of levels. A grid warp, launched only with a grid, computes
// the next tile's features, a (point, level) a lane at a time, while the
// consumers run the current tile's products, and stages them as bf16
// [64][levels F] beside the activations (2 KB at the NGP recipe's 16
// features, which the ring's 5 stages at 8x512 leave free); the encode
// copies them in. The first design computed each (point, feature)
// in the encode itself, the cell and 8 scalar L2 loads every time, while
// the tensor cores waited.
// The stashes, [N, L*H] row-major (the TPU kernels' layout), with y_i the
// range-reduced pre-activation of layer i that the sine also uses:
//   kStashInt8 (K1): hs = bf16(sin y_i), the value that feeds layer i+1,
//       and cs = int8(round_half_even(127 cos8(y_i)));
//   kStashLsb (K6a): hs = bf16(sin y_i) with its last bit (y_i^2 > (pi/2)^2),
//       the sign of cos y_i;
//   kStashI8pair (K6b): one int8 row [N, 2 L H], layer i's round(127 sin y_i)
//       (from the f32 sine) in columns [2iH, 2iH + H), its int8 cos8 in
//       [2iH + H, 2(i+1)H);
//   kStashBf16Cos (K4): hs = bf16(sin y_i) and cs = bf16(cos10(y_i)).
// Every format feeds the next layer bf16(sin y_i), so out is K0's bit for
// bit in every format.
//
// Bound on this card: operations, 2 N H (E + (L-1) H + d_out) flop on the
// bf16 tensor cores: 0.934 ms for K0 at 8x512, N = 245,760; 0.747 ms for K1
// at the fine step's N = 196,608, where its stashes write 3 L H = 12,288
// bytes a point (0.722 ms at 3.35 TB/s), so the stores must overlap the
// products. What held the mma.sync kernels at 3.3 ms (K0) and 3.5 ms (K1)
// (H100 80GB HBM3, 700 W): mma.sync and a synchronous chunk loop that
// cannot reach the tensor cores' rate, every 64-point block re-reading the
// whole packed weight set (3.77 MB at 8x512) from L2, and the sine
// epilogue with the tensor cores idle. Design (hopper.cuh):
//   * 64 points a tile; two consumer warpgroups each own H/2 output columns
//     of every layer (wgmma m64n{H/2}k16, A and B from shared memory, 128
//     f32 accumulators a thread at H = 512) and a producer warp;
//   * the activations stay in shared memory in one bf16 buffer [64, H] in
//     wgmma's K-major layout: a layer reads it, both warpgroups meet at a
//     named barrier once their products are done, and the epilogue (bias,
//     fast_sin, bf16) overwrites it with the layer's output straight from
//     the accumulators; a second barrier before the next layer. One buffer,
//     not two, leaves room for a deeper weight ring;
//   * the stashes leave from shared memory: K1's sin stash (and K4's) is
//     the buffer itself; what differs from it goes to a staging tile beside
//     it, in the same columns of 16-byte pieces [bytes / 16][64 rows][16]:
//     K1's int8 cos (64 H bytes, 32 KB at H = 512, so the ring has 4
//     stages), K6a's packed sin, K6b's int8 sin and cos (128 H bytes, 3
//     stages); K4's bf16 cos below. After the epilogue's barrier every consumer
//     thread copies 16-byte pieces, a warp 4 core matrices: 8 rows by 64
//     contiguous bytes a store (whole sectors), under an L2 evict-first
//     policy while the weights load under evict-last (the 2.4 GB stash
//     stream at the fine step must not evict the weights: without the
//     policies the mma.sync K1 took 4.67 ms instead of 3.62 on an H100).
//     K1's copies cost 0.78 ms of 2.72 at the fine step (H100 80GB HBM3,
//     700 W), none of it under the products; measured worse: the pairs
//     stored from the epilogue's registers (5.0 ms: 128 stores a thread a
//     layer of half-filled sectors), the copies issued after the next
//     layer's first products, or half-way through them on every other
//     block (3.5-3.7 and 3.5-3.6 ms against 3.2-3.3 in one call), a storer
//     warp copying them while the consumers run the next layer's products
//     (4.3 ms: one warp keeps too few stores in flight, and the next
//     epilogue waits for it), TMA tensor stores of a column of core
//     matrices a box (3.9 ms: 96 small boxes a layer beside the weight
//     ring's loads), and the buffer in the 128-byte swizzle so a box is 64
//     columns (K0 itself 2.0 -> 2.6 ms);
//   * the weights stream through a ring of 32-row k-chunks ([32, H] bf16,
//     32 KB at H = 512: 5 stages beside the 64 KB of activations), laid out
//     once per field by the wrapper (pack_wgmma) so one bulk copy (TMA
//     engine) moves a chunk; mbarriers carry full and empty, two chunks'
//     products stay in flight, and the producer runs ahead across layers
//     and tiles, so the next layer's first chunks land during the epilogue.
//     Where every chunk fits (4x128: 16 chunks of 8 KB) the weights are
//     resident instead: loaded once, each chunk in its own stage;
//   * the head is one more ring chunk, w_out^T [H, 8] (d_out padded): 16
//     wgmma m64n8k16 over the last activations, f32 sums;
//   * persistent blocks, one an SM, walk the tiles; rows past n encode as
//     zeros and are never stored;
//   * K4 (kStashBf16Cos, tma_stash): the buffer and the bf16 cos staging
//     tile lie in the 128-byte swizzle, blocks of 64 columns [64 rows][128
//     bytes], so after each epilogue one thread hands both to the copy
//     engine as 2 H / 64 TMA tensor stores, boxes [64 rows][64 columns] of
//     the stash's tensor maps (rows past n not written), which run under
//     the next layer's products; its wait for their reads comes just before
//     the next epilogue (or encode) writes the tiles, and A's descriptors
//     take the swizzle. With the two 64 KB tiles its weights come in 16-row
//     chunks, 6 stages at H = 512. The consumers' own 16-byte copies took
//     1.39 ms of the 5.41 that K4's 8 forwards took at 8x512, N = 262,144,
//     and 3 stages of 32-row chunks left 1.8 ms above K0's work
//     (scripts/backward_ablation.py --fmt recompute, H100 80GB HBM3, 700 W).
// What holds it above the bound: between a layer's products and the next
// layer's, the epilogue's 128 range-reduced sines a thread run on the CUDA
// cores while the tensor cores wait (at 8x512, N = 245,760: 1.0e9 sines of
// ~12 float instructions, 0.36 ms at the 67 TFLOP/s float32 peak,
// against the products' 0.934 ms), and the 3.77 MB of weights that every
// 64-point tile streams from L2.
#pragma once

#include "fused_mlp_common.cuh"
#include "hopper.cuh"

// Measurement only (see fused_mlp_backward.cuh): 6 = K4's recompute
// forward without its hs / cs stores; K5 14 = the grid warp stages nothing
// (no loads, no features: the staging tile as it is), 15 = the consumers
// neither wait for the grid warp nor copy its features
#ifndef SUNERF_ABLATION
#define SUNERF_ABLATION 0
#endif

// Internal linkage (the anonymous namespace): each library that includes
// this header keeps its own launch state (launch_width's block count and
// shared-memory attribute), also two variants of one source loaded in one
// process (a weak template's static local would be one object for both).
namespace sunerf {
namespace {
namespace fwd {

namespace hp = sunerf::hopper;

constexpr int kRows = 64;             // points per tile
constexpr int kKC = 32;               // weight rows (k) per ring chunk
constexpr int kConsumerWarps = 8;     // two warpgroups
constexpr int kConsumers = kConsumerWarps * 32;
constexpr int kThreads = kConsumers + 32;   // + the producer warp
constexpr int kGridWarp = kConsumerWarps + 1;   // launched only with grid levels
constexpr int kGridThreads = kThreads + 32;
constexpr int kMaxStages = 32;
constexpr int kBarBytes = 1024;       // the barriers, before the buffers
constexpr int kGridBar = 2 * kMaxStages;   // the grid staging's full and empty barriers
constexpr size_t kSmemLimit = 232448; // a block's shared memory on sm_90
constexpr int kHeadN = 8;             // the head's wgmma width: d_out up to 8, padded

struct Params {
  CUtensorMap hs_map;        // K4: the bf16 sin stash [n, L*H], boxes [64 rows][64 columns]
  CUtensorMap cs_map;        // K4: the bf16 cos stash, the same
  const float* pts;          // [n, d_in]
  const int* col_dim;        // [n_cols]
  const float* col_freq;     // [n_cols]
  const __nv_bfloat16* w;    // [chunks][32 x H]: pack_wgmma's ring chunks, the head's last
  const float* b_in;         // [H]
  const float* b_h;          // [L-1][H]
  const float* b_out;        // [d_out]
  float* out;                // [n, d_out]
  void* hs;                  // the sin stash (see the top of this file), or null
  void* cs;                  // the cos stash of K1 and K4, else null
  GridParams grid;
  int n, d_in, n_cols, n_hidden, d_out;
  int k_in;                  // the input layer's rows: e_pad rounded up to 32
  int act_k;                 // activation buffer width: max(H, k_in) (K4: to 64)
  int stages;                // ring stages
  int resident;              // 1: every chunk of the weights has its own stage
  int grid_bytes;            // the grid staging tile (0 without a grid)
};

constexpr int kColumn = kRows * 16;   // bytes of a column of core matrices

// K4's format keeps its activations and its cos staging tile in the
// 128-byte swizzle, so that the copy engine stores them as whole boxes,
// and, with those two tiles filling 128 KB at H = 512, streams its weights
// in 16-row ring chunks (6 stages where 32-row chunks left 3)
__host__ __device__ constexpr bool tma_stash(int fmt) { return fmt == kStashBf16Cos; }
__host__ __device__ constexpr int ring_rows(int fmt) { return fmt == kStashBf16Cos ? 16 : kKC; }

// Byte offset of (row, col) in the activation buffer (and K4's staging
// tile): wgmma's no-swizzle K-major core matrices, a column of them (8
// columns) 1 KB; with kSw (K4) blocks of 64 columns [64 rows][128 bytes] in
// the 128-byte swizzle, 8 KB each, as a TMA box [64 x 64] of a bf16 stash
// lies in shared memory
template <bool kSw = false>
__device__ __forceinline__ int act_at(int row, int col) {
  if constexpr (kSw) return (col >> 6) * (kRows * 128) + hp::swizzle128(row, (col & 63) * 2);
  return hp::core_offset(row, col, kRows / 8) * 2;
}

// Byte offset of (row, byte col) in an int8 staging tile [bytes/16][64][16]
// (K1's cos, K6b's sin and cos pairs)
__device__ __forceinline__ int byte_at(int row, int col) {
  return (col >> 4) * kColumn + row * 16 + (col & 15);
}

// Bytes of a format's staging tile: what of its stash differs from the
// activations, [64, H] int8 (K1) or 2-byte (K6a, K6b's pairs, K4)
__host__ __device__ constexpr int staging_bytes(int H, int fmt) {
  return fmt == kStashNone ? 0 : fmt == kStashInt8 ? kRows * H : 2 * kRows * H;
}

// The tile's encoding [x, sin u, cos u, grid features, zeros] as bf16 into
// the activation buffer, as the plain version computes
// it: consumer thread t takes row t % 64 and a quarter of each kind of
// column (t / 64 + 4 i), reading its point's coordinates through L1; each
// phase u gives its sin and its cos column. The grid features come from the
// grid warp's staging tile `gstage` [64][n_grid] bf16, already rounded.
template <bool kSw>
__device__ __forceinline__ void encode(const Params& p, int row0, unsigned char* dst,
                                       const __nv_bfloat16* gstage) {
  const int r = threadIdx.x & (kRows - 1);
  const int part = threadIdx.x / kRows;
  constexpr int kParts = kConsumers / kRows;
  const int gr = row0 + r;
  const bool valid = gr < p.n;
  const float* xp = p.pts + static_cast<size_t>(valid ? gr : 0) * p.d_in;
  auto put = [&](int c, float v) {
    *reinterpret_cast<__nv_bfloat16*>(dst + act_at<kSw>(r, c)) = __float2bfloat16_rn(v);
  };
  if (part == 0)
    for (int a = 0; a < p.d_in; ++a) put(a, valid ? __ldg(xp + a) : 0.f);
  const int sin0 = p.d_in, cos0 = p.d_in + p.n_cols, grid0 = p.d_in + 2 * p.n_cols;
#pragma unroll 4
  for (int j = part; j < p.n_cols; j += kParts) {
    const float u = __fmul_rn(__ldg(xp + __ldg(p.col_dim + j)), __ldg(p.col_freq + j));
    // cos(u) = sin(u + pi/2), as the TPU kernel's fast_cos
    put(sin0 + j, valid ? fast_sin(u) : 0.f);
    put(cos0 + j, valid ? fast_sin(__fadd_rn(u, kHalfPi)) : 0.f);
  }
  const int n_grid = p.grid.n_levels * p.grid.features;
  for (int idx = threadIdx.x; SUNERF_ABLATION != 15 && idx < kRows * n_grid;
       idx += kConsumers) {
    const int row = idx / n_grid;
    *reinterpret_cast<__nv_bfloat16*>(dst + act_at<kSw>(row, grid0 + idx - row * n_grid)) =
        gstage[idx];
  }
  for (int c = grid0 + n_grid + part; c < p.k_in; c += kParts) put(c, 0.f);
}

// The grid warp: for each of the block's tiles in turn, once the consumers
// have copied the last tile's features out of the staging tile, the
// features of the tile's rows (zeros past n) into it as bf16, a (point,
// level) a lane at a time (grid_level_features), then one arrival on full.
__device__ __forceinline__ void grid_stage_tiles(const Params& p, __nv_bfloat16* gstage,
                                                 uint64_t* gfull, uint64_t* gempty) {
  const int lane = threadIdx.x & 31;
  const int F = p.grid.features, n_grid = p.grid.n_levels * F;
  const int tiles = (p.n + kRows - 1) / kRows;
  int phase = 0;
  for (int w = blockIdx.x; w < tiles; w += gridDim.x, phase ^= 1) {
    // one lane waits, asleep between polls: the warp takes no issue slots
    // from the consumers on its SM sub-partition while they run a tile
    if (lane == 0) hp::mbar_wait(gempty, phase ^ 1, 1000);
    __syncwarp();
    for (int it = lane; SUNERF_ABLATION != 14 && it < kRows * p.grid.n_levels; it += 32) {
      const int r = it & (kRows - 1), level = it / kRows;
      const int gr = w * kRows + r;
      __nv_bfloat16* dst = gstage + r * n_grid + level * F;
      if (gr < p.n)
        grid_level_features(p.grid, level, p.pts + static_cast<size_t>(gr) * p.d_in,
                            [&](int f, float v) { dst[f] = __float2bfloat16_rn(v); });
      else
        for (int f = 0; f < F; ++f) dst[f] = __float2bfloat16_rn(0.f);
    }
    __syncwarp();
    if (lane == 0) hp::mbar_arrive(gfull);
  }
}

__device__ __forceinline__ void release(uint64_t* empty, int lane) {
  __syncwarp();
  if (lane == 0) hp::mbar_arrive(empty);
}

__device__ __forceinline__ void st_v4(void* ptr, uint4 v, uint64_t policy) {
  asm volatile("st.global.L2::cache_hint.v4.b32 [%0], {%1, %2, %3, %4}, %5;\n"
               :: "l"(ptr), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "l"(policy) : "memory");
}

// Copies a tile's [64, width] stash block, held in shared memory as
// columns of 16-byte pieces [width / 16 bytes][64 rows] (the activation
// buffer's core-matrix order for bf16, the cos staging tile's for int8), to
// rows row0.. of a row-major stash (`ld` bytes a row, the block at byte
// `col0`), rows past n not stored. Piece u is row 8 (u / 8 / pieces) + u % 8
// of column (u / 8) % pieces: a warp reads 4 whole core matrices and writes
// 8 rows by 64 contiguous bytes.
__device__ __forceinline__ void copy_stash(const unsigned char* src, int pieces, char* dst,
                                           size_t ld, size_t col0, int row0, int n,
                                           uint64_t policy) {
  for (int u = threadIdx.x; u < kRows * pieces; u += kConsumers) {
    const int lo = u & 7, cg = (u >> 3) % pieces, rg = (u >> 3) / pieces;
    const int row = rg * 8 + lo;
    if (row0 + row < n)
      st_v4(dst + static_cast<size_t>(row0 + row) * ld + col0 + cg * 16,
            *reinterpret_cast<const uint4*>(src + cg * kColumn + row * 16), policy);
  }
}

template <int H, int kFmt>
__global__ void __launch_bounds__(kGridThreads, 1) fwd_wgmma_kernel(const __grid_constant__ Params p) {
  constexpr int N = H / 2;                   // columns of each warpgroup
  constexpr bool kSw = tma_stash(kFmt);
  constexpr int KC = ring_rows(kFmt);        // weight rows a ring chunk
  constexpr int kChunkBytes = KC * H * 2;
  extern __shared__ __align__(1024) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kMaxStages;
  unsigned char* act = smem + kBarBytes;
  // the stash's staging tile, after the activations
  unsigned char* staging = act + p.act_k * kRows * 2;
  // the grid warp's staging tile, then the ring
  auto* gstage = reinterpret_cast<__nv_bfloat16*>(staging + staging_bytes(H, kFmt));
  unsigned char* ring = staging + staging_bytes(H, kFmt) + p.grid_bytes;
  uint64_t* gfull = full + kGridBar;
  uint64_t* gempty = gfull + 1;
  const bool grid = p.grid.n_levels > 0;
  const int S = p.stages;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tiles = (p.n + kRows - 1) / kRows;
  const int chunks = p.k_in / KC + p.n_hidden * (H / KC) + 1;   // + the head

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      hp::mbar_init(&full[s], 1);
      hp::mbar_init(&empty[s], kConsumerWarps);
    }
    hp::mbar_init(gfull, 1);
    hp::mbar_init(gempty, 1);
    hp::fence_barrier_init();
  }
  __syncthreads();

  if (warp == kGridWarp) {
    grid_stage_tiles(p, gstage, gfull, gempty);
  } else if (warp == kConsumerWarps) {
    // producer: one thread keeps the ring full, across layers and tiles
    if (lane == 0) {
      const uint64_t policy = hp::evict_last_policy();
      const auto* src0 = reinterpret_cast<const unsigned char*>(p.w);
      int stage = 0, phase = 0;
      // resident: the block's weights once, whatever its tiles
      const int end = p.resident ? static_cast<int>(blockIdx.x) + 1 : tiles;
      for (int w = blockIdx.x; w < end; w += gridDim.x) {
        for (int i = 0; i < chunks; ++i) {
          // resident: chunk i into stage i, once; else the ring's next stage
          const int st = p.resident ? i : stage;
          if (!p.resident) {
            hp::mbar_wait(&empty[st], phase ^ 1);
            if (++stage == S) {
              stage = 0;
              phase ^= 1;
            }
          }
          // the head's chunk holds w_out^T [H, 8], the rest of it unread
          const uint32_t bytes = i == chunks - 1 ? H * kHeadN * 2 : kChunkBytes;
          hp::mbar_expect_tx(&full[st], bytes);
          hp::bulk_load(ring + st * kChunkBytes, src0 + static_cast<size_t>(i) * kChunkBytes,
                        bytes, &full[st], policy);
        }
      }
    }
    __syncwarp();
  } else {
    const int wg = warp >> 2, w4 = warp & 3, g = lane >> 2, q = lane & 3;
    const uint32_t ring0 = hp::smem_u32(ring);
    const uint64_t stream = hp::evict_first_policy();
    // the ring's stage and phase, and the stages of the last two chunks
    int stage = 0, phase = 0, prev1 = 0, prev2 = 0, gphase = 0;
    for (int w = blockIdx.x; w < tiles; w += gridDim.x) {
      const int row0 = w * kRows;
      // the grid warp has staged this tile's features
      if (grid && SUNERF_ABLATION != 15) hp::mbar_wait(gfull, gphase);
      encode<kSw>(p, row0, act, gstage);
      hp::fence_async_smem();
      hp::named_sync(1, kConsumers);
      // the staging tile is free for the next tile's features
      if (grid) {
        if (threadIdx.x == 0) hp::mbar_arrive(gempty);
        gphase ^= 1;
      }
      const uint32_t a0 = hp::smem_u32(act);
      // A of the k16 step at column k: its two columns of core matrices
      auto a_desc = [&](int k) {
        if constexpr (kSw) return hp::make_desc_sw128(a0 + (k >> 6) * (kRows * 128) + (k & 63) * 2);
        return hp::make_desc(a0 + (k >> 3) * kColumn, kColumn, 128);
      };
      int i = 0;   // the chunk's index in the tile's sequence
      for (int layer = 0; layer <= p.n_hidden; ++layer) {
        const int nk = (layer == 0 ? p.k_in : H) / KC;
        const float* bias = layer == 0 ? p.b_in : p.b_h + static_cast<size_t>(layer - 1) * H;
        float acc[N / 2] = {};
        for (int kc = 0; kc < nk; ++kc, ++i) {
          const int st = p.resident ? i : stage;
          hp::mbar_wait(&full[st], p.resident ? 0 : phase);
          const uint32_t b0 = ring0 + st * kChunkBytes + wg * (N / 8) * 128;
          hp::wgmma_fence();
#pragma unroll
          for (int s = 0; s < KC / 16; ++s) {
            // A: k = KC kc + 16 s of the buffer; B: k-groups 2 s and 2 s + 1
            // of the chunk, this warpgroup's N
            hp::wgmma_ss(acc, a_desc(KC * kc + 16 * s),
                         hp::make_desc(b0 + 2 * s * (H / 8) * 128, (H / 8) * 128, 128),
                         kc > 0 || s > 0);
          }
          hp::wgmma_commit();
          // two chunks' products in flight: the one before last is done
          hp::wgmma_wait<2>();
          if (!p.resident) {
            if (kc > 1) release(&empty[prev2], lane);
            prev2 = prev1;
            prev1 = stage;
            if (++stage == S) {
              stage = 0;
              phase ^= 1;
            }
          }
        }
        hp::wgmma_wait<0>();
        hp::fence_regs(acc);
        if (!p.resident) {
          if (nk > 1) release(&empty[prev2], lane);
          release(&empty[prev1], lane);
        }
        // both warpgroups, and the copy engine's stash stores (K4: of the
        // layer before, issued after its epilogue), have read the layer's
        // input: the epilogue (bias, fast_sin, bf16, the stashes) overwrites
        // it with the layer's output
        if (kSw && threadIdx.x == 0) hp::bulk_wait_read();
        hp::named_sync(1, kConsumers);
        if constexpr (kSw) {
          // K4: (row, col) of the swizzled tiles lies at t ^ ((j % 8) << 4)
          // + (j / 8) 8 KB + r 1 KB, t this thread's byte of (row 16 w4 + g,
          // column wg N + 2 q), its 16-byte piece permuted by g: one
          // logic op an address, where swizzle128 per element held 8 more
          // addresses live and spilled 712 bytes a thread at H = 512
          // (forward x8 5.33 ms against 3.53, 8x512, N = 262,144, H100
          // 80GB HBM3, 700 W)
          const uint32_t t = ((wg * N) / 64) * (kRows * 128) + (w4 * 16 + g) * 128 + 4 * q
                             + (((((wg * N) % 64) / 8) ^ g) << 4);   // H = 64: wg 1 at byte 64
#pragma unroll
          for (int j = 0; j < N / 8; ++j) {
            const float2 bb =
                __ldg(reinterpret_cast<const float2*>(bias + wg * N + 8 * j + 2 * q));
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const uint32_t at = (t ^ ((j & 7) << 4)) + (j >> 3) * (kRows * 128) + r * 1024;
              const float y0 = reduce_2pi(acc[4 * j + 2 * r] + bb.x);
              const float y1 = reduce_2pi(acc[4 * j + 2 * r + 1] + bb.y);
              *reinterpret_cast<uint32_t*>(act + at) = pack_bf16(sin_poly(y0), sin_poly(y1));
              *reinterpret_cast<uint32_t*>(staging + at) = pack_bf16(cos10(y0), cos10(y1));
            }
          }
        } else {
#pragma unroll
          for (int j = 0; j < N / 8; ++j) {
            const int col = wg * N + 8 * j + 2 * q;
            const float2 bb = __ldg(reinterpret_cast<const float2*>(bias + col));
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int row = w4 * 16 + g + 8 * r;
              const float y0 = reduce_2pi(acc[4 * j + 2 * r] + bb.x);
              const float y1 = reduce_2pi(acc[4 * j + 2 * r + 1] + bb.y);
              const float s0 = sin_poly(y0), s1 = sin_poly(y1);
              *reinterpret_cast<uint32_t*>(act + act_at(row, col)) = pack_bf16(s0, s1);
              if constexpr (kFmt == kStashInt8) {
                *reinterpret_cast<uint16_t*>(staging + byte_at(row, col)) =
                    static_cast<uint16_t>(pack_i8(cos8_q(y0), cos8_q(y1)));
              } else if constexpr (kFmt == kStashLsb) {
                *reinterpret_cast<uint32_t*>(staging + act_at(row, col)) =
                    pack_sin_csign(s0, __fmul_rn(y0, y0) > kHalfPiSq)
                    | (pack_sin_csign(s1, __fmul_rn(y1, y1) > kHalfPiSq) << 16);
              } else if constexpr (kFmt == kStashI8pair) {
                // the sin rounded from f32, not from its bf16
                *reinterpret_cast<uint16_t*>(staging + byte_at(row, col)) =
                    static_cast<uint16_t>(pack_i8(__float2int_rn(__fmul_rn(s0, kCosScale)),
                                                  __float2int_rn(__fmul_rn(s1, kCosScale))));
                *reinterpret_cast<uint16_t*>(staging + byte_at(row, H + col)) =
                    static_cast<uint16_t>(pack_i8(cos8_q(y0), cos8_q(y1)));
              }
            }
          }
        }
        hp::fence_async_smem();
        hp::named_sync(1, kConsumers);
        // the layer's stash from the buffer and the staging tile, read
        // before the next epilogue's barrier: hs the sin (K1, K4) or the
        // staged packed sin (K6a) or int8 pairs (K6b); cs the staged int8
        // (K1) or bf16 (K4) cos
        const size_t ld = static_cast<size_t>(p.n_hidden + 1) * H;   // a layer's H a row
        const size_t at = static_cast<size_t>(layer) * H;
        char* hs = static_cast<char*>(p.hs);
        char* cs = static_cast<char*>(p.cs);
        if constexpr (kSw) {
          // K4: one thread hands both stashes to the copy engine, a box [64
          // rows][64 columns] a block, and the next layer's products run
          // while it stores them (rows past n are not stored)
          if (SUNERF_ABLATION != 6 && threadIdx.x == 0) {
            for (int b = 0; b < H / 64; ++b) {
              hp::tensor_store_2d(&p.hs_map, static_cast<int>(at) + 64 * b, row0,
                                  act + b * (kRows * 128), stream);
              hp::tensor_store_2d(&p.cs_map, static_cast<int>(at) + 64 * b, row0,
                                  staging + b * (kRows * 128), stream);
            }
            hp::bulk_commit();
          }
        }
        if constexpr (kFmt == kStashInt8)
          copy_stash(act, H / 8, hs, ld * 2, at * 2, row0, p.n, stream);
        if constexpr (kFmt == kStashInt8)
          copy_stash(staging, H / 16, cs, ld, at, row0, p.n, stream);
        if constexpr (kFmt == kStashLsb || kFmt == kStashI8pair)
          copy_stash(staging, H / 8, hs, ld * 2, at * 2, row0, p.n, stream);
      }

      // the linear head on the tensor cores, [64, H] x w_out^T [H, 8] (d_out
      // padded) with f32 sums, from the tile's last ring chunk: warpgroup 0
      // computes it, both release the stage
      const int st = p.resident ? i : stage;
      hp::mbar_wait(&full[st], p.resident ? 0 : phase);
      if (wg == 0) {
        const uint32_t b0 = ring0 + st * kChunkBytes;
        float h[4] = {};
        hp::wgmma_fence();
#pragma unroll
        for (int s = 0; s < H / 16; ++s)
          hp::wgmma_ss(h, a_desc(16 * s), hp::make_desc(b0 + 2 * s * 128, 128, 128), s > 0);
        hp::wgmma_commit();
        hp::wgmma_wait<0>();
        hp::fence_regs(h);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int gr = row0 + w4 * 16 + g + 8 * r;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int o = 2 * q + e;
            if (o < p.d_out && gr < p.n)
              p.out[static_cast<size_t>(gr) * p.d_out + o] = h[2 * r + e] + p.b_out[o];
          }
        }
      }
      if (!p.resident) {
        release(&empty[st], lane);
        if (++stage == S) {
          stage = 0;
          phase ^= 1;
        }
      }
      // the head, and the copy engine's last stores, have read the
      // activations before the next tile's encode
      if (kSw && threadIdx.x == 0) hp::bulk_wait_read();
      hp::named_sync(1, kConsumers);
    }
    if (kSw && threadIdx.x == 0) hp::bulk_wait();
  }
}

inline size_t smem_bytes(int H, int act_k, int stages, int fmt, int grid_bytes) {
  return kBarBytes + static_cast<size_t>(kRows) * act_k * 2 + staging_bytes(H, fmt) + grid_bytes
         + static_cast<size_t>(stages) * ring_rows(fmt) * H * 2;
}

// Raises the shared memory limit and finds how many blocks fit at once,
// once per kernel and device (so no attribute or occupancy call in a graph
// capture); then launches as many blocks as fit, each walking the tiles.
template <int H, int kFmt>
cudaError_t launch_width(const Params& p, cudaStream_t stream) {
  static int blocks_of[kMaxDevices] = {};
  int* const slot = device_slot(blocks_of);
  if (slot == nullptr) return cudaErrorInvalidDevice;
  int& max_blocks = *slot;
  if (max_blocks == 0) {
    cudaError_t err = cudaFuncSetAttribute(fwd_wgmma_kernel<H, kFmt>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(kSmemLimit));
    int device = 0, sms = 0, per_sm = 0;
    if (err == cudaSuccess) err = cudaGetDevice(&device);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    // one block an SM whatever the smem: the occupancy of the largest
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fwd_wgmma_kernel<H, kFmt>,
                                                          kGridThreads, kSmemLimit);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    max_blocks = sms * per_sm;
  }
  const int tiles = (p.n + kRows - 1) / kRows;
  // the grid warp only with a grid
  fwd_wgmma_kernel<H, kFmt><<<tiles < max_blocks ? tiles : max_blocks,
                              p.grid.n_levels > 0 ? kGridThreads : kThreads,
                              smem_bytes(H, p.act_k, p.stages, kFmt, p.grid_bytes), stream>>>(p);
  return cudaGetLastError();
}

// Fills p's sizes (k_in, act_k, stages, resident) from e_pad (the
// encoding's width rounded up to 16) and d_filter, checks what the kernel
// takes, and launches it. p's pointers, n, d_in, n_cols, n_hidden, d_out
// and grid are the caller's. Returns a cudaError_t.
template <int kFmt>
cudaError_t launch(Params p, int e_pad, int d_filter, cudaStream_t stream) {
  p.k_in = (e_pad + kKC - 1) / kKC * kKC;
  p.act_k = d_filter > p.k_in ? d_filter : p.k_in;
  if (tma_stash(kFmt)) p.act_k = (p.act_k + 63) / 64 * 64;
  const size_t chunk = static_cast<size_t>(ring_rows(kFmt)) * d_filter * 2;
  // the grid staging tile, bf16 [64][levels F], in whole 128-byte lines
  p.grid_bytes = (kRows * p.grid.n_levels * p.grid.features * 2 + 127) / 128 * 128;
  const size_t fixed = smem_bytes(d_filter, p.act_k, 0, kFmt, p.grid_bytes);
  p.stages = fixed < kSmemLimit ? static_cast<int>((kSmemLimit - fixed) / chunk) : 0;
  if (p.stages > kMaxStages) p.stages = kMaxStages;
  const int chunks =
      p.k_in / ring_rows(kFmt) + p.n_hidden * (d_filter / ring_rows(kFmt)) + 1;
  p.resident = chunks <= p.stages;
  if (p.resident) p.stages = chunks;
  if (p.n <= 0 || e_pad % 16 != 0 || !grid_ok(p.grid) || (!p.resident && p.stages < 3) ||
      e_pad < p.d_in + 2 * p.n_cols + p.grid.n_levels * p.grid.features || p.d_out < 1 ||
      p.d_out > kHeadN || p.n_hidden < 0 || (kFmt != kStashNone && p.hs == nullptr) ||
      ((kFmt == kStashInt8 || kFmt == kStashBf16Cos) && p.cs == nullptr))
    return cudaErrorInvalidValue;
  switch (d_filter) {
    case 64: return launch_width<64, kFmt>(p, stream);
    case 128: return launch_width<128, kFmt>(p, stream);
    case 256: return launch_width<256, kFmt>(p, stream);
    case 384: return launch_width<384, kFmt>(p, stream);
    case 512: return launch_width<512, kFmt>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace fwd
}  // namespace
}  // namespace sunerf
