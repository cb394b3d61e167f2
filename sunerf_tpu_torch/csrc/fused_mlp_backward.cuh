// Device code of the fused-MLP backwards for Hopper (sm_90a), shared by the
// stashing backward (fused_mlp_stash_bwd.cu: K2 with its point cotangent K3,
// the 'lsb' and 'i8pair' formats K6a and K6b, and the grid branch K5) and the
// recompute backward K4 (fused_mlp_recompute_bwd.cu). See those files for
// what each replaces and what bounds it.
//
// One backward pass over n points is these launches, in stream order:
//   0. prep_kernel, a block per 64-point tile: per tile f32 partials of
//      dW_out = hs_{L-1}^T bf16(dy) and db_out, and the recomputed bf16
//      encoding to a scratch [n, E_pad] for dW_in (many blocks an SM hide
//      the loads' latency, which inside the chain kernel's tile loop cost
//      the tensor cores their time);
//   1. chain_wgmma_kernel: the row-parallel chain dy -> dh -> dz_{L-1} ->
//      dh -> ... -> dz_0, each dz_j gated by the layer's cos (the "gate",
//      below), on wgmma in K0's design (fused_mlp_fwd_wgmma.cuh): 64-point
//      tiles, two consumer warpgroups each taking H/2 columns of
//      dh = dz_j W_h[j-1]^T (m64n{H/2}k16), dz_j in place in one bf16 buffer
//      in wgmma's K-major core-matrix layout, W_h[j-1]^T streamed in 32-row
//      k-chunks through a bulk-copy ring by a producer warp (pack_wgmma_bwd:
//      W_h's core-matrix chunks as stored, K-major for B), persistent blocks.
//      The epilogue gates the accumulators into dz_{j-1} in the buffer; the
//      copy engine stores each dz_j, tile by tile in the buffer's own order,
//      to a scratch [tiles][L][64 x H] (one 64 KB bulk copy a tile and layer
//      at 8x512) for the dW products; db_j are column sums of the buffer in
//      a fixed order, into per tile f32 partials. With kDpts it ends with
//      the point cotangent (K3, one more
//      wgmma against W_in[:n_enc]^T from the ring); with grid levels with
//      the grid cotangent (K5).
//   2. K5 only: grid_scatter_kernel and grid_convert_kernel.
//   3. 'i8pair' only: dz_absmax_kernel, each group's max |dz_j|.
//   4. dw_wgmma_kernel: dW_in = enc^T dz_0 and dW_h[j-1] = hs_{j-1}^T dz_j,
//      products contracting over the points, as work items (split, job,
//      128-row by TN-column output tile) walked by persistent blocks: a
//      producer warp brings each 64-point chunk of A (the stash or the
//      encoding: two TMA boxes [64 points x 64 columns] of a 2-D tensor
//      map, 128-byte swizzled) and of B (dz, one bulk copy of the scratch's
//      tile) through a ring, and two consumer warpgroups take 64 rows each,
//      wgmma m64n{TN}k16 with A from registers (ldmatrix.trans of the
//      swizzled tile, which reads 8 points' same columns from 8 bank
//      groups: A is the stash transposed) and B = dz MN-major from shared
//      memory. With a bulk copy a point row for A instead (64 of 256 bytes
//      a chunk) the kernel took 3.8 ms at the fine step where the B copies
//      alone take 1.2 ms (H100 80GB HBM3, 700 W): the copy engine's rate in
//      small copies, not the bytes, bound it. f32 partials per split.
//      'i8pair' runs it for dW_in alone and sends the hidden layers' dW to
//      dw_i8_kernel, over ranges of its own (splits8) into partials of its
//      own, so neither kernel's split count sizes the other's partials.
//   5. reduce_kernel: the partials summed over tiles and splits in a fixed
//      order (added to the running sums with `accumulate`, for K4's
//      chunks), so a run gives the same bits as the last; no atomics.
// Rows past n are masked in every kernel: they load as zeros (dz) or are
// multiplied by zero rows of dz, and are never stored.
//
// The gate of layer j, the value dz_j = bf16(bf16(dh) * gate) multiplies by:
//   kGateInt8: bf16(bf16(q) * bf16(1/127)) of an int8 cos x127 stash (K1's
//              cs, or the cos half of K6b's pairs);
//   kGateBf16: a bf16 cos (K4's recomputed fast_sincos cos);
//   kGateLsb:  bf16(sign * sqrt(max(1 - s^2, 0))) in f32 from K6a's packed
//              bf16 sin s, its last bit the sign (_unpack_sin_cos).
// The int8 gate tile [64, H] of a layer comes through the weight ring
// itself, in the stage after the layer's weight chunks (64 H bytes, a
// weight chunk's size): H / 128 TMA boxes [64 rows x 128 bytes] of a 2-D
// tensor map of the stash, 128-byte swizzled so the epilogue's reads of 8
// rows' same columns fall in 8 bank groups, prefetched into L2 one layer
// ahead. The bf16 and lsb gates, twice the bytes, are read in the epilogue
// straight from device memory (through L1 and L2).
#pragma once

#include "fused_mlp_common.cuh"
#include "hopper.cuh"

namespace sunerf {
namespace {

namespace hp = sunerf::hopper;

constexpr int kMaxOut = 4;        // d_out the chain kernel takes
constexpr int kMaxDpts = 8;       // d_in the point cotangent takes
constexpr int kRows = 64;         // points a chain tile and a dW chunk
constexpr int kKC = 32;           // weight rows (k) per ring chunk
constexpr int kConsumerWarps = 8; // two warpgroups
constexpr int kConsumers = kConsumerWarps * 32;
constexpr int kThreads = kConsumers + 32;   // + the producer warp
constexpr int kMaxStages = 32;
constexpr int kRowGroups = kRows / 8;
constexpr size_t kSmemLimit = 232448;   // a block's shared memory on sm_90
// the chain kernel's head: barriers [0, 512), block maxima [512, 640),
// then dy [64][d_out] f32, later K3's [64][kMaxDpts] f32, at 1024
constexpr int kChainHead = 3072;
constexpr int kDwBar = 1024;      // the dW kernel's barriers, before its stages
constexpr int kDwTM = 128;        // dW output rows a work item (two warpgroups)
constexpr int kBox = 64;          // rows of a TMA box; bf16 columns of a dW A box
constexpr int kGateBox = 128;     // int8 columns of a gate box (a 128-byte swizzled row)
// dw_i8_kernel: mma.sync int8, 128x128 output tiles, 32-point chunks
constexpr int kI8Threads = 256;
constexpr int kI8Tile = 128;
constexpr int kI8Chunk = 32;
constexpr int kQuadStride = kI8Chunk / 4 + 4;   // staging row, 32-bit words

enum Gate : int { kGateInt8 = 0, kGateBf16 = 1, kGateLsb = 2 };

struct BwdParams {
  CUtensorMap gate_map;         // int8 gates: [n, gate columns] with gate_ld-byte rows
  CUtensorMap enc_map;          // the encoding scratch [n, e_pad], bf16
  CUtensorMap hs_map;           // the bf16 sin stash [n, L*H] ('int8', 'lsb', K4)
  const float* pts;             // [n, d_in]
  const int* col_dim;           // [n_cols]
  const float* col_freq;        // [n_cols]
  const float* dy;              // [n, d_out]
  const __nv_bfloat16* hs;      // [n, L*H] bf16 sin stash ('int8', 'lsb', K4)
  const int8_t* hs8;            // 'i8pair': the int8 pairs [n, 2*L*H], else null
  const void* gate;             // layer 0's gate, int8 or bf16 (see above)
  size_t gate_ld;               // its row stride, elements
  int gate_layer;               // elements from one layer's gate to the next
  const __nv_bfloat16* w_bwd;   // [L-1][H/32][32 x H] pack_wgmma_bwd: w_h[j]^T chunks
  const __nv_bfloat16* w_dpts;  // K3: pack_wgmma_dpts: w_in[:n_enc]^T chunks, or null
  const __nv_bfloat16* w_out;   // [d_out][H]
  __nv_bfloat16* dz;            // [tiles][L][64 x H] scratch, core-matrix order
  __nv_bfloat16* enc;           // [n, e_pad] scratch
  float* part_chain;            // [tiles][q] per-tile partials
  float* part_dw;               // [splits][dw_ld] the dW kernel's per-split partials
  float* part_i8;               // 'i8pair': [splits8][(L-1) H^2] dw_i8_kernel's partials
  float* grad_chain;            // [q]: dW_out [H][d_out], db_out, db_j [L][H]
  float* grad_dw;               // [p]: dW_in [e_pad][H], dW_h [L-1][H][H]
  GridParams grid;              // dense grid levels (K5), or none
  const __nv_bfloat16* w_grid;  // [levels * F][H] bf16 grid rows of w_in
  float* dgrid;                 // [n, levels * F] scratch: denc_grid
  unsigned int* gmax;           // [levels] bits of max |denc_grid|, zeroed
  unsigned long long* gacc;     // [sum G^3 F] fixed-point sums, zeroed
  float* grad_grid;             // [sum G^3 F]: d_table of each level
  float* dpts;                  // K3: [n, d_in], or null
  int n_enc;                    // K3: encoding columns x, sin, cos (d_in + 2 n_cols)
  float* dz_max;                // 'i8pair': [n_groups][L-1] max |dz_j|, j >= 1
  int group;                    // 'i8pair': points per dz scale group
  int n, d_in, n_cols, e_pad, h, n_hidden, d_out;
  int splits, pps;              // dW: point ranges of pps points (a multiple of 64)
  int splits8;                  // 'i8pair': dw_i8_kernel's point ranges
  int stages, stage_bytes;      // the launched kernel's ring
  size_t q, p;
  size_t dw_ld;                 // a split's partials in part_dw: p, or e_pad H for 'i8pair'
};

// Element (point pt, layer j, column c) of the dz scratch: tile pt / 64,
// then layer j's [64 x H] block in K-major core-matrix order.
__host__ __device__ __forceinline__ size_t dz_index(int pt, int j, int c, int L, int H) {
  return (static_cast<size_t>(pt >> 6) * L + j) * (kRows * H)
         + hp::core_offset(pt & (kRows - 1), c, kRowGroups);
}

// bf16(bf16(q) * bf16(1/127)): the TPU kernel's dequantized int8
__device__ __forceinline__ float cos_dequant(int8_t q) {
  const float inv = __bfloat162float(__float2bfloat16_rn(1.0f / kCosScale));
  return bf16_round(static_cast<float>(q) * inv);
}

// bf16(sign * sqrt(max(1 - s^2, 0))) of a packed bf16 sin (its 16 bits),
// in f32 with every operation rounded on its own (_unpack_sin_cos)
__device__ __forceinline__ float lsb_cos(uint32_t bits) {
  const float s = __uint_as_float(bits << 16);
  const float c = __fsqrt_rn(fmaxf(__fsub_rn(1.0f, __fmul_rn(s, s)), 0.0f));
  return bf16_round((bits & 1u) ? -c : c);
}

// Where a layer's gate is read: an int8 ring stage (H / 128 swizzled boxes
// [64][128], or one plain box [64][64] at H = 64), or the tile's rows
// [0, last] of a bf16 gate in device memory, `ld` elements apart.
struct GateRef {
  const unsigned char* tile;
  const void* base;
  size_t ld;
  int last;
};

// The gates at (row, col) and (row, col + 1) of the tile, col even, from one
// load. bf16 rows past n read the tile's last row, and int8 rows past n are
// zeros: their dh is zero, so any finite gate gives dz = 0.
template <int H, int kGate>
__device__ __forceinline__ float2 gate_pair(const GateRef& g, int row, int col) {
  if constexpr (kGate == kGateInt8) {
    const int at = H < kGateBox ? row * H + col
        : (col / kGateBox) * (kBox * kGateBox) + hp::swizzle128(row, col % kGateBox);
    const char2 q = *reinterpret_cast<const char2*>(g.tile + at);
    return make_float2(cos_dequant(q.x), cos_dequant(q.y));
  } else {
    const uint32_t bits = __ldg(reinterpret_cast<const unsigned int*>(
        static_cast<const unsigned short*>(g.base)
        + static_cast<size_t>(min(row, g.last)) * g.ld + col));
    if constexpr (kGate == kGateBf16)
      return make_float2(__uint_as_float(bits << 16), __uint_as_float(bits & 0xFFFF0000u));
    else
      return make_float2(lsb_cos(bits & 0xFFFFu), lsb_cos(bits >> 16));
  }
}

__device__ __forceinline__ void release(uint64_t* empty, int lane) {
  __syncwarp();
  if (lane == 0) hp::mbar_arrive(empty);
}

// The tile's recomputed encoding [x, sin u, cos u, grid features, zeros]
// as bf16 rows of the scratch [n, e_pad], as the forward computes it: cos
// u = sin(u + pi/2), as the TPU kernel's fast_cos.
__device__ __forceinline__ void encode_rows(const BwdParams& p, int row0, int rows) {
  const int grid0 = p.d_in + 2 * p.n_cols;
  const int grid_end = grid0 + p.grid.n_levels * p.grid.features;
  for (int idx = threadIdx.x; idx < rows * p.e_pad; idx += kConsumers) {
    const int r = idx / p.e_pad;
    const int c = idx - r * p.e_pad;
    const float* x = p.pts + static_cast<size_t>(row0 + r) * p.d_in;
    float v = 0.f;
    if (c < p.d_in) {
      v = x[c];
    } else if (c < grid0) {
      const int j = (c - p.d_in) % p.n_cols;
      const float u = __fmul_rn(x[p.col_dim[j]], p.col_freq[j]);
      v = fast_sin(c < p.d_in + p.n_cols ? u : __fadd_rn(u, kHalfPi));
    } else if (c < grid_end) {
      const int j = c - grid0;
      v = grid_feature(p.grid, j / p.grid.features, x, j % p.grid.features);
    }
    p.enc[static_cast<size_t>(row0) * p.e_pad + idx] = __float2bfloat16_rn(v);
  }
}

// dW_out = hs_{L-1}^T bf16(dy) and db_out = sum(dy) over the tile's rows
// into its partials: a column pair per thread, rows in order.
__device__ __forceinline__ void dw_out_partial(const BwdParams& p, int row0, int rows,
                                               const float* sdy, float* part) {
  const int L = p.n_hidden + 1, d_out = p.d_out, H = p.h;
  const size_t ld = static_cast<size_t>(L) * H;
  for (int m = 2 * threadIdx.x; m < H; m += 2 * kConsumers) {
    float acc[kMaxOut][2] = {};
#pragma unroll 4
    for (int r = 0; r < rows; ++r) {
      float h0, h1;
      if (p.hs8 != nullptr) {
        // 'i8pair': hs_{L-1} is bf16(bf16(q) * bf16(1/127)) of the int8 sin
        const char2 v = *reinterpret_cast<const char2*>(
            p.hs8 + static_cast<size_t>(row0 + r) * 2 * ld + static_cast<size_t>(L - 1) * 2 * H + m);
        h0 = cos_dequant(v.x);
        h1 = cos_dequant(v.y);
      } else {
        const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
            p.hs + static_cast<size_t>(row0 + r) * ld + static_cast<size_t>(L - 1) * H + m));
        h0 = v.x;
        h1 = v.y;
      }
#pragma unroll
      for (int o = 0; o < kMaxOut; ++o) {
        if (o < d_out) {
          const float d = bf16_round(sdy[r * d_out + o]);
          acc[o][0] += h0 * d;
          acc[o][1] += h1 * d;
        }
      }
    }
#pragma unroll
    for (int o = 0; o < kMaxOut; ++o) {
      if (o < d_out) {
        part[m * d_out + o] = acc[o][0];
        part[(m + 1) * d_out + o] = acc[o][1];
      }
    }
  }
  if (threadIdx.x < d_out) {
    float s = 0.f;
    for (int r = 0; r < kRows; ++r) s += sdy[r * d_out + threadIdx.x];
    part[d_out * H + threadIdx.x] = s;
  }
}

// dy of a tile's rows (zeros past n) into sdy [64][d_out]
__device__ __forceinline__ void load_dy(const BwdParams& p, int row0, int rows, float* sdy) {
  for (int idx = threadIdx.x; idx < kRows * p.d_out; idx += kConsumers)
    sdy[idx] = idx / p.d_out < rows ? p.dy[static_cast<size_t>(row0) * p.d_out + idx] : 0.f;
}

// The tile's dW_out and db_out partials and its rows of the encoding
// scratch: a block of kConsumers threads per 64-point tile.
__global__ void __launch_bounds__(kConsumers) prep_kernel(BwdParams p) {
  __shared__ float sdy[kRows * kMaxOut];
  const int row0 = blockIdx.x * kRows;
  const int rows = min(kRows, p.n - row0);
  load_dy(p, row0, rows, sdy);
  encode_rows(p, row0, rows);
  __syncthreads();
  dw_out_partial(p, row0, rows, sdy, p.part_chain + static_cast<size_t>(blockIdx.x) * p.q);
}

// Sums over the butterfly of the 8 lanes with the same lane % 4 (the rows
// g + 8 i of a column pair), in a fixed order.
__device__ __forceinline__ void sum_rows(float& s0, float& s1) {
#pragma unroll
  for (int off = 4; off < 32; off <<= 1) {
    s0 += __shfl_xor_sync(0xffffffffu, s0, off);
    s1 += __shfl_xor_sync(0xffffffffu, s1, off);
  }
}

// dz_{L-1} = bf16(bf16(dh) * gate) with dh = bf16(dy) bf16(W_out)^T (d_out
// terms) into the buffer, and db_{L-1}: warp w takes the column groups
// w + 8 i, lane (g, q) the pair 2q of a group and the rows g + 8 k, so each
// warp's shared-memory accesses are 128 contiguous bytes.
template <int H, int kGate>
__device__ __forceinline__ void first_dz(const BwdParams& p, const float* sdy, const GateRef& gate,
                                         __nv_bfloat16* act, float* db) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const int d_out = p.d_out;
  for (int cg = warp; cg < H / 8; cg += kConsumerWarps) {
    const int col = 8 * cg + 2 * q;
    float w0[kMaxOut], w1[kMaxOut];
#pragma unroll
    for (int o = 0; o < kMaxOut; ++o) {
      w0[o] = o < d_out ? __bfloat162float(p.w_out[o * H + col]) : 0.f;
      w1[o] = o < d_out ? __bfloat162float(p.w_out[o * H + col + 1]) : 0.f;
    }
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int r = g + 8 * k;
      float dh0 = 0.f, dh1 = 0.f;
#pragma unroll
      for (int o = 0; o < kMaxOut; ++o) {
        if (o < d_out) {
          const float d = bf16_round(sdy[r * d_out + o]);
          dh0 += d * w0[o];
          dh1 += d * w1[o];
        }
      }
      const float2 gt = gate_pair<H, kGate>(gate, r, col);
      const float z0 = bf16_round(bf16_round(dh0) * gt.x);
      const float z1 = bf16_round(bf16_round(dh1) * gt.y);
      *reinterpret_cast<uint32_t*>(act + hp::core_offset(r, col, kRowGroups)) = pack_bf16(z0, z1);
      s0 += z0;
      s1 += z1;
    }
    sum_rows(s0, s1);
    if (g == 0) {
      db[col] = s0;
      db[col + 1] = s1;
    }
  }
}

// db[c] = the sum of the buffer's column c over the 64 rows (dz_j, exact
// bf16 values), in the order of first_dz
template <int H>
__device__ __forceinline__ void column_sums(const __nv_bfloat16* act, float* db) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  for (int cg = warp; cg < H / 8; cg += kConsumerWarps) {
    const int col = 8 * cg + 2 * q;
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
          act + hp::core_offset(g + 8 * k, col, kRowGroups)));
      s0 += v.x;
      s1 += v.y;
    }
    sum_rows(s0, s1);
    if (g == 0) {
      db[col] = s0;
      db[col + 1] = s1;
    }
  }
}

// denc_grid[r, j] = sum_c dz_0[r, c] bf16(W_in[grid row j, c]) for the
// tile's rows into p.dgrid, and each level's max |denc_grid| into p.gmax:
// max over the tile, then one atomicMax on the bits (non-negative floats
// order as their bits do, NaN above infinity; any order gives the same
// max). Thread t takes row t / 4 and the columns t % 4 + 4 q, four
// independent sums over c at a time, 8 bf16 per 16-byte load (8 columns of
// a row are contiguous in the buffer's core matrices).
template <int H>
__device__ __forceinline__ void grid_cotangent(const BwdParams& p, const __nv_bfloat16* dz0,
                                               int row0, unsigned int (*block_max)[kMaxLevels]) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r = threadIdx.x >> 2;
  const int gr = row0 + r;
  const int F = p.grid.features;
  const int n_grid = p.grid.n_levels * F;
  unsigned int mx[kMaxLevels] = {0u, 0u, 0u, 0u};
  for (int j0 = threadIdx.x & 3; j0 < n_grid; j0 += 16) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    const __nv_bfloat16* w[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)  // columns past n_grid read the last row, unused
      w[q] = p.w_grid + static_cast<size_t>(min(j0 + 4 * q, n_grid - 1)) * H;
#pragma unroll 2
    for (int c = 0; c < H; c += 8) {
      const uint4 av = *reinterpret_cast<const uint4*>(dz0 + hp::core_offset(r, c, kRowGroups));
      const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&av);
      float af[8];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 v = __bfloat1622float2(a2[e]);
        af[2 * e] = v.x;
        af[2 * e + 1] = v.y;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint4 wv = __ldg(reinterpret_cast<const uint4*>(w[q] + c));
        const __nv_bfloat162* w2 = reinterpret_cast<const __nv_bfloat162*>(&wv);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 v = __bfloat1622float2(w2[e]);
          acc[q] = fmaf(af[2 * e], v.x, acc[q]);
          acc[q] = fmaf(af[2 * e + 1], v.y, acc[q]);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = j0 + 4 * q;
      if (j >= n_grid || gr >= p.n) continue;
      p.dgrid[static_cast<size_t>(gr) * n_grid + j] = acc[q];
      const unsigned int bits = __float_as_uint(fabsf(acc[q]));
#pragma unroll
      for (int l = 0; l < kMaxLevels; ++l)
        if (l == j / F) mx[l] = max(mx[l], bits);
    }
  }
#pragma unroll
  for (int l = 0; l < kMaxLevels; ++l) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx[l] = max(mx[l], __shfl_xor_sync(0xffffffffu, mx[l], off));
    if (lane == 0) block_max[warp][l] = mx[l];
  }
  hp::named_sync(1, kConsumers);
  if (threadIdx.x < p.grid.n_levels) {
    unsigned int m = 0u;
    for (int w = 0; w < kConsumerWarps; ++w) m = max(m, block_max[w][threadIdx.x]);
    atomicMax(p.gmax + threadIdx.x, m);
  }
}

// K3, the point cotangent of the tile's rows (the compute_dpts=True branch
// of _bwd_stash_kernel, and the tail of _bwd_kernel):
//   denc = dz_0 bf16(W_in[:n_enc])^T, one more wgmma over the buffer per
//          CW-column chunk of pack_wgmma_dpts's ring chunks (two warpgroups,
//          CW / 2 columns each),
//   dpts[r, d] = denc[r, d] + sum over the phase columns j of dimension d
//                of freq_j (cos u_j dsin_j - sin u_j dcos_j),
// u_j = x[dim_j] freq_j in f32 and its sine and cosine by the kernels'
// range-reduced polynomial (cos u = sin(u + pi/2), as in the encoding).
// Each thread sums the terms of its accumulators per (row, dimension);
// the lanes of a row meet by shuffles, the two warpgroups in `sdpts`
// [64][kMaxDpts], warpgroup 0's sum first.
template <int H, typename Take>
__device__ __forceinline__ void point_cotangent(const BwdParams& p, uint32_t a0, int row0,
                                                Take&& take, uint64_t* empty, uint32_t ring0,
                                                int stage_bytes, float* sdpts) {
  constexpr int CW = H < 128 ? H : 128;   // encoding columns a chunk
  constexpr int NW = CW / 2;              // of them, each warpgroup's
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wg = warp >> 2, w4 = warp & 3, g = lane >> 2, q = lane & 3;
  const int D = p.d_in, nc = p.n_cols;
  const int n_cc = (p.n_enc + CW - 1) / CW;
  float dp[2][kMaxDpts] = {};
  for (int cc = 0; cc < n_cc; ++cc) {
    float acc[NW / 2] = {};
    for (int kc = 0; kc < H / kKC; ++kc) {
      const int st = take();
      const uint32_t b0 = ring0 + st * stage_bytes + wg * (NW / 8) * 128;
      hp::wgmma_fence();
#pragma unroll
      for (int s = 0; s < 2; ++s)
        hp::wgmma_ss(acc, hp::make_desc(a0 + (4 * kc + 2 * s) * kRowGroups * 128,
                                        kRowGroups * 128, 128),
                     hp::make_desc(b0 + 2 * s * (CW / 8) * 128, (CW / 8) * 128, 128),
                     kc > 0 || s > 0);
      hp::wgmma_commit();
      hp::wgmma_wait<0>();
      hp::fence_regs(acc);
      release(&empty[st], lane);
    }
#pragma unroll
    for (int jj = 0; jj < NW / 8; ++jj) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = cc * CW + wg * NW + 8 * jj + 2 * q + (i & 1);
        const int gr = row0 + w4 * 16 + g + 8 * (i >> 1);
        if (col >= p.n_enc || gr >= p.n) continue;
        const float v = acc[4 * jj + i];
        int d;
        float t;
        if (col < D) {
          d = col;
          t = v;
        } else {
          const int j = col < D + nc ? col - D : col - D - nc;
          d = __ldg(p.col_dim + j);
          const float f = __ldg(p.col_freq + j);
          const float u = __fmul_rn(__ldg(p.pts + static_cast<size_t>(gr) * D + d), f);
          t = col < D + nc ? __fmul_rn(__fmul_rn(fast_sin(__fadd_rn(u, kHalfPi)), v), f)
                           : -__fmul_rn(__fmul_rn(fast_sin(u), v), f);
        }
#pragma unroll
        for (int e = 0; e < kMaxDpts; ++e)
          if (e == d) dp[i >> 1][e] += t;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int e = 0; e < kMaxDpts; ++e) {
      dp[r][e] += __shfl_xor_sync(0xffffffffu, dp[r][e], 1);
      dp[r][e] += __shfl_xor_sync(0xffffffffu, dp[r][e], 2);
    }
  if (wg == 1 && q == 0)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      for (int e = 0; e < D; ++e) sdpts[(w4 * 16 + g + 8 * r) * kMaxDpts + e] = dp[r][e];
  hp::named_sync(1, kConsumers);
  if (wg == 0 && q == 0)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = w4 * 16 + g + 8 * r;
      if (row0 + row < p.n)
        for (int e = 0; e < D; ++e)
          p.dpts[static_cast<size_t>(row0 + row) * D + e] = dp[r][e] + sdpts[row * kMaxDpts + e];
    }
}

template <int H, int kGate, bool kDpts>
__global__ void __launch_bounds__(kThreads, 1) chain_wgmma_kernel(const __grid_constant__ BwdParams p) {
  constexpr int N = H / 2;                 // columns of each warpgroup
  constexpr int nk = H / kKC;              // ring chunks of a layer's weights
  constexpr int kGateBoxes = H < kGateBox ? 1 : H / kGateBox;
  constexpr int kGateCols = H < kGateBox ? H : kGateBox;
  constexpr int CW = H < 128 ? H : 128;    // K3's columns a chunk
  constexpr uint32_t kChunkBytes = kKC * H * 2;
  extern __shared__ __align__(1024) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kMaxStages;
  auto* block_max = reinterpret_cast<unsigned int (*)[kMaxLevels]>(smem + 512);
  float* scratch = reinterpret_cast<float*>(smem + 1024);
  auto* act = reinterpret_cast<__nv_bfloat16*>(smem + kChainHead);
  unsigned char* ring = smem + kChainHead + kRows * H * 2;
  const int S = p.stages, SB = p.stage_bytes;
  const int L = p.n_hidden + 1;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tiles = (p.n + kRows - 1) / kRows;
  const int n_cc = kDpts ? (p.n_enc + CW - 1) / CW : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      hp::mbar_init(&full[s], 1);
      hp::mbar_init(&empty[s], kConsumerWarps);
    }
    hp::fence_barrier_init();
  }
  __syncthreads();

  if (warp == kConsumerWarps) {
    // producer: the weight chunks (and the int8 gates) in the order the
    // consumers take them, across layers and tiles
    const uint64_t keep = hp::evict_last_policy(), stream = hp::evict_first_policy();
    const auto* wb = reinterpret_cast<const unsigned char*>(p.w_bwd);
    const auto* we = reinterpret_cast<const unsigned char*>(p.w_dpts);
    int stage = 0, phase = 0;
    auto next = [&]() {
      const int st = stage;
      if (lane == 0) hp::mbar_wait(&empty[st], phase ^ 1);
      __syncwarp();
      if (++stage == S) {
        stage = 0;
        phase ^= 1;
      }
      return st;
    };
    auto put_chunk = [&](const unsigned char* src, uint32_t bytes) {
      const int st = next();
      if (lane == 0) {
        hp::mbar_expect_tx(&full[st], bytes);
        hp::bulk_load(ring + st * SB, src, bytes, &full[st], keep);
      }
    };
    auto put_gate = [&](int row0, int j) {
      const int st = next();
      if (lane == 0) {
        hp::mbar_expect_tx(&full[st], kRows * H);
        for (int b = 0; b < kGateBoxes; ++b)
          hp::tensor_load_2d(ring + st * SB + b * kBox * kGateCols, &p.gate_map,
                             j * p.gate_layer + b * kGateCols, row0, &full[st], stream);
      }
    };
    auto prefetch_gate = [&](int row0, int j) {
      if (lane == 0)
        for (int b = 0; b < kGateBoxes; ++b)
          hp::tensor_prefetch_2d(&p.gate_map, j * p.gate_layer + b * kGateCols, row0);
    };
    for (int w = blockIdx.x; w < tiles; w += gridDim.x) {
      const int row0 = w * kRows;
      if constexpr (kGate == kGateInt8) put_gate(row0, L - 1);
      for (int j = L - 1; j > 0; --j) {
        if constexpr (kGate == kGateInt8) prefetch_gate(row0, j - 1);
        for (int kc = 0; kc < nk; ++kc)
          put_chunk(wb + (static_cast<size_t>(j - 1) * nk + kc) * kChunkBytes, kChunkBytes);
        if constexpr (kGate == kGateInt8) put_gate(row0, j - 1);
      }
      for (int cc = 0; cc < n_cc; ++cc)
        for (int kc = 0; kc < nk; ++kc)
          put_chunk(we + (static_cast<size_t>(cc) * nk + kc) * (kKC * CW * 2), kKC * CW * 2);
      // the next tile's first gate into L2
      if constexpr (kGate == kGateInt8)
        if (w + gridDim.x < tiles) prefetch_gate((w + gridDim.x) * kRows, L - 1);
    }
  } else {
    const int wg = warp >> 2, w4 = warp & 3, g = lane >> 2, q = lane & 3;
    const uint32_t a0 = hp::smem_u32(act);
    const uint64_t stream = hp::evict_first_policy();
    const uint32_t ring0 = hp::smem_u32(ring);
    // the ring's stage and phase: take() waits for the next stage to fill
    int stage = 0, phase = 0;
    auto take = [&]() {
      const int st = stage;
      hp::mbar_wait(&full[st], phase);
      if (++stage == S) {
        stage = 0;
        phase ^= 1;
      }
      return st;
    };
    const int d_out = p.d_out;
    for (int w = blockIdx.x; w < tiles; w += gridDim.x) {
      const int row0 = w * kRows;
      const int rows = min(kRows, p.n - row0);
      float* part = p.part_chain + static_cast<size_t>(w) * p.q;
      float* part_db = part + d_out * H + d_out;
      __nv_bfloat16* dz_tile = p.dz + static_cast<size_t>(w) * L * kRows * H;
      auto gate = [&](int j, int st) -> GateRef {
        if constexpr (kGate == kGateInt8) {
          return {ring + st * SB, nullptr, 0, kRows - 1};
        } else {
          return {nullptr, static_cast<const __nv_bfloat16*>(p.gate)
                               + static_cast<size_t>(row0) * p.gate_ld
                               + static_cast<size_t>(j) * p.gate_layer,
                  p.gate_ld, rows - 1};
        }
      };

      // dy of the tile's rows (zeros past n)
      load_dy(p, row0, rows, scratch);
      hp::named_sync(1, kConsumers);

      // dz_{L-1} into the buffer; the copy engine stores it
      {
        const int st = kGate == kGateInt8 ? take() : 0;
        first_dz<H, kGate>(p, scratch, gate(L - 1, st), act, part_db + (L - 1) * H);
        if constexpr (kGate == kGateInt8) release(&empty[st], lane);
      }
      hp::fence_async_smem();
      hp::named_sync(1, kConsumers);
      if (threadIdx.x == 0)
        hp::bulk_store(dz_tile + static_cast<size_t>(L - 1) * kRows * H, act, kRows * H * 2,
                       stream);

      for (int j = L - 1; j > 0; --j) {
        // dh = dz_j W_h[j-1]^T, this warpgroup's N columns, two chunks'
        // products in flight
        float acc[N / 2] = {};
        int prev1 = 0, prev2 = 0;
        for (int kc = 0; kc < nk; ++kc) {
          const int st = take();
          const uint32_t b0 = ring0 + st * SB + wg * (N / 8) * 128;
          hp::wgmma_fence();
#pragma unroll
          for (int s = 0; s < 2; ++s)
            hp::wgmma_ss(acc, hp::make_desc(a0 + (4 * kc + 2 * s) * kRowGroups * 128,
                                            kRowGroups * 128, 128),
                         hp::make_desc(b0 + 2 * s * (H / 8) * 128, (H / 8) * 128, 128),
                         kc > 0 || s > 0);
          hp::wgmma_commit();
          // db_j, the column sums of dz_j, while its first products run
          // (db_{L-1} came with dz_{L-1})
          if (kc == 0 && j < L - 1) column_sums<H>(act, part_db + j * H);
          hp::wgmma_wait<2>();
          if (kc > 1) release(&empty[prev2], lane);
          prev2 = prev1;
          prev1 = st;
        }
        hp::wgmma_wait<0>();
        hp::fence_regs(acc);
        release(&empty[prev2], lane);
        release(&empty[prev1], lane);
        // both warpgroups and the copy engine have read dz_j: the epilogue
        // overwrites it with dz_{j-1} = bf16(bf16(dh) * gate_{j-1})
        if (threadIdx.x == 0) hp::bulk_wait_read();
        hp::named_sync(1, kConsumers);
        const int st = kGate == kGateInt8 ? take() : 0;
        const GateRef gr = gate(j - 1, st);
#pragma unroll
        for (int jj = 0; jj < N / 8; ++jj) {
          const int col = wg * N + 8 * jj + 2 * q;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int row = w4 * 16 + g + 8 * r;
            const float2 gt = gate_pair<H, kGate>(gr, row, col);
            const float z0 = bf16_round(bf16_round(acc[4 * jj + 2 * r]) * gt.x);
            const float z1 = bf16_round(bf16_round(acc[4 * jj + 2 * r + 1]) * gt.y);
            *reinterpret_cast<uint32_t*>(act + hp::core_offset(row, col, kRowGroups)) =
                pack_bf16(z0, z1);
          }
        }
        if constexpr (kGate == kGateInt8) release(&empty[st], lane);
        hp::fence_async_smem();
        hp::named_sync(1, kConsumers);
        if (threadIdx.x == 0)
          hp::bulk_store(dz_tile + static_cast<size_t>(j - 1) * kRows * H, act, kRows * H * 2,
                         stream);
      }
      // the buffer holds dz_0: db_0, and the tails read it beside the copy
      // engine
      if (L > 1) column_sums<H>(act, part_db);
      if (p.grid.n_levels > 0) grid_cotangent<H>(p, act, row0, block_max);
      if constexpr (kDpts) point_cotangent<H>(p, a0, row0, take, empty, ring0, SB, scratch);
      if (threadIdx.x == 0) hp::bulk_wait_read();
      hp::named_sync(1, kConsumers);
    }
    if (threadIdx.x == 0) hp::bulk_wait();
  }
}

// The dW kernel's work items: per split, job 0 (dW_in: mt0 row tiles of
// e_pad rows) and, for jobs 1 .. n_jobs-1 (dW_h[j-1]), mt row tiles of H,
// each with nt column tiles of TN; item i is split i / per_split, then in
// that order (ops/fused_mlp.py dw_splits counts per_split to size the
// splits).
struct DwPlan {
  int mt0, mt, nt, per_split, items;
};

__host__ __device__ inline int dw_tn(int H) { return H % 256 == 0 ? 256 : H % 128 == 0 ? 128 : 64; }

__host__ __device__ inline DwPlan dw_plan(int H, int e_pad, int n_jobs, int splits) {
  DwPlan d;
  d.mt0 = (e_pad + kDwTM - 1) / kDwTM;
  d.mt = (H + kDwTM - 1) / kDwTM;
  d.nt = H / dw_tn(H);
  d.per_split = d.mt0 * d.nt + (n_jobs - 1) * d.mt * d.nt;
  d.items = splits * d.per_split;
  return d;
}

__device__ __forceinline__ void dw_item(const DwPlan& d, int it, int& split, int& job,
                                        int& mtile, int& ntile) {
  split = it / d.per_split;
  int r = it - split * d.per_split;
  if (r < d.mt0 * d.nt) {
    job = 0;
  } else {
    r -= d.mt0 * d.nt;
    job = 1 + r / (d.mt * d.nt);
    r -= (job - 1) * d.mt * d.nt;
  }
  mtile = r / d.nt;
  ntile = r - mtile * d.nt;
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// part_dw[split][job] = A_job^T B_job over the split's points, per work
// item (see DwPlan): job 0 is dW_in (A = enc, B = dz_0), job j >= 1 is
// dW_h[j-1] (A = hs_{j-1}, B = dz_j). A stage holds a 64-point chunk of A,
// two 128-byte swizzled TMA boxes [64 points][64 columns] bf16 (zeros past
// n and past the encoding's columns), and of B, the dz scratch's [64 x TN]
// columns of one tile (one bulk copy: TN / 8 core-matrix columns of 8
// k-groups, 128 bytes each).
template <int TN>
__global__ void __launch_bounds__(kThreads, 1) dw_wgmma_kernel(const __grid_constant__ BwdParams p,
                                                               int n_jobs) {
  constexpr int kABytes = 2 * kBox * kBox * 2;
  constexpr int kBBytes = TN * kRows * 2;
  constexpr int kStage = kABytes + kBBytes;
  extern __shared__ __align__(1024) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kMaxStages;
  unsigned char* stages = smem + kDwBar;
  const int S = p.stages;
  const int H = p.h, L = p.n_hidden + 1;
  const DwPlan d = dw_plan(H, p.e_pad, n_jobs, p.splits);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      hp::mbar_init(&full[s], 1);
      hp::mbar_init(&empty[s], kConsumerWarps);
    }
    hp::fence_barrier_init();
  }
  __syncthreads();

  if (warp == kConsumerWarps) {
    // evict-normal, not evict-first: each chunk of A is read by H / TN work
    // items and each of B by m_rows / 128, running side by side, through L2
    const uint64_t shared = hp::evict_normal_policy();
    int stage = 0, phase = 0;
    for (int it = blockIdx.x; it < d.items; it += gridDim.x) {
      int split, job, mtile, ntile;
      dw_item(d, it, split, job, mtile, ntile);
      const int p0 = split * p.pps, p1 = min(p.n, p0 + p.pps);
      // A's first column: the encoding's m0, or the stash's layer j-1 block
      const CUtensorMap* amap = job == 0 ? &p.enc_map : &p.hs_map;
      const int x0 = (job == 0 ? 0 : (job - 1) * H) + mtile * kDwTM;
      if (lane == 0) {
        for (int c = p0; c < p1; c += kRows) {
          const int st = stage;
          hp::mbar_wait(&empty[st], phase ^ 1);
          if (++stage == S) {
            stage = 0;
            phase ^= 1;
          }
          unsigned char* sa = stages + st * kStage;
          hp::mbar_expect_tx(&full[st], kABytes + kBBytes);
          hp::tensor_load_2d(sa, amap, x0, c, &full[st], shared);
          hp::tensor_load_2d(sa + kABytes / 2, amap, x0 + kBox, c, &full[st], shared);
          hp::bulk_load(sa + kABytes,
                        p.dz + (static_cast<size_t>(c / kRows) * L + job) * kRows * H
                            + static_cast<size_t>(ntile) * TN * kRows,
                        kBBytes, &full[st], shared);
        }
      }
    }
  } else {
    const int wg = warp >> 2, w4 = warp & 3, g = lane >> 2, q = lane & 3;
    const uint32_t s0 = hp::smem_u32(stages);
    int stage = 0, phase = 0;
    // A = this warp's 16 of the stash's columns, transposed: a chunk's k16
    // steps' fragments, by ldmatrix.trans from warpgroup wg's box (columns
    // 64 wg ..), 8 points' 16 bytes a matrix row; then its 4 products.
    // Two chunks' products in flight: the A fragments alternate between
    // two register sets (af[c & 1]), and a stage is released once the
    // products after it were issued.
    auto chunk = [&](uint32_t (&af)[4][4], float (&acc)[TN / 2], int& st) {
      st = stage;
      hp::mbar_wait(&full[st], phase);
      if (++stage == S) {
        stage = 0;
        phase ^= 1;
      }
      const uint32_t sa = s0 + st * kStage, sb = sa + kABytes;
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const int k = ks * 16 + (lane & 7) + (lane >> 4) * 8;
        const int m = w4 * 16 + ((lane >> 3) & 1) * 8;
        ldsm_x4_trans(af[ks], sa + wg * (kABytes / 2) + hp::swizzle128(k, m * 2));
      }
      hp::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        // B: k-groups 2 ks, 2 ks + 1 (128 bytes apart), N-groups 1 KB apart
        hp::wgmma_rs_t(acc, af[ks], hp::make_desc(sb + ks * 256, 128, kRowGroups * 128), 1);
      hp::wgmma_commit();
    };
    for (int it = blockIdx.x; it < d.items; it += gridDim.x) {
      int split, job, mtile, ntile;
      dw_item(d, it, split, job, mtile, ntile);
      const int p0 = split * p.pps, p1 = min(p.n, p0 + p.pps);
      float acc[TN / 2] = {};
      uint32_t af0[4][4], af1[4][4];
      int st0 = -1, st1 = -1;
      for (int c = p0; c < p1; c += 2 * kRows) {
        chunk(af0, acc, st0);
        hp::wgmma_wait<1>();
        if (st1 >= 0) release(&empty[st1], lane);
        st1 = -1;
        if (c + kRows < p1) {
          chunk(af1, acc, st1);
          hp::wgmma_wait<1>();
          release(&empty[st0], lane);
          st0 = -1;
        }
      }
      hp::wgmma_wait<0>();
      hp::fence_regs(acc);
      if (st0 >= 0) release(&empty[st0], lane);
      if (st1 >= 0) release(&empty[st1], lane);
      const int m_rows = job == 0 ? p.e_pad : H;
      float* out = p.part_dw + static_cast<size_t>(split) * p.dw_ld
                   + (job == 0 ? 0 : static_cast<size_t>(p.e_pad) * H
                                     + static_cast<size_t>(job - 1) * H * H);
#pragma unroll
      for (int jj = 0; jj < TN / 8; ++jj) {
        const int col = ntile * TN + 8 * jj + 2 * q;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = mtile * kDwTM + wg * 64 + w4 * 16 + g + 8 * r;
          if (row < m_rows)
            *reinterpret_cast<float2*>(out + static_cast<size_t>(row) * H + col) =
                make_float2(acc[4 * jj + 2 * r], acc[4 * jj + 2 * r + 1]);
        }
      }
    }
  }
}

// The fixed-point scale exponent k of a level whose terms are at most m in
// size, n of them to a sum: m < 2^e, k = 62 - e_n - e with n <= 2^e_n.
__device__ __forceinline__ int grid_scale_exp(float m, int e_n) {
  int e;
  frexpf(m, &e);
  return 62 - e_n - e;
}

// The level of flat table element i (over the levels' G^3 F elements in
// order) and its offset within that level.
__device__ __forceinline__ int grid_level_of(const GridParams& g, size_t& i) {
  int l = 0;
  for (; l < g.n_levels - 1; ++l) {
    const size_t sz = static_cast<size_t>(g.size[l]) * g.size[l] * g.size[l] * g.features;
    if (i < sz) break;
    i -= sz;
  }
  return l;
}

// One thread per (point, level, corner, feature): the term
// w(corner) * denc_grid in f32, scaled by 2^k exactly (in double) and
// rounded to an integer, added to the level's fixed-point sum. A warp's
// 32 threads cover 4 corners x 8 features of one point, 8 neighbouring
// 8-byte words per corner.
__global__ void grid_scatter_kernel(BwdParams p, int e_n) {
  const GridParams& g = p.grid;
  const int F = g.features;
  const size_t per_point = static_cast<size_t>(g.n_levels) * 8 * F;
  const size_t t = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= static_cast<size_t>(p.n) * per_point) return;
  const int pt = static_cast<int>(t / per_point);
  int rem = static_cast<int>(t - static_cast<size_t>(pt) * per_point);
  const int level = rem / (8 * F);
  rem -= level * 8 * F;
  const int corner = rem / F;
  const int f = rem - corner * F;
  const float m = __uint_as_float(p.gmax[level]);
  if (!(m > 0.f) || !(m <= 3.402823466e38f)) return;  // all zero, or not finite
  const int G = g.size[level];
  int lo[3];
  float fr[3];
  grid_cell(p.pts + static_cast<size_t>(pt) * p.d_in, G, g.bound, lo, fr);
  int row;
  const float w = grid_corner(lo, fr, G, corner, row);
  const float v = __fmul_rn(w, p.dgrid[static_cast<size_t>(pt) * g.n_levels * F + level * F + f]);
  const long long q = __double2ll_rn(static_cast<double>(v)
                                     * ldexp(1.0, grid_scale_exp(m, e_n)));
  if (q == 0) return;
  size_t off = 0;
  for (int l = 0; l < level; ++l)
    off += static_cast<size_t>(g.size[l]) * g.size[l] * g.size[l] * F;
  atomicAdd(p.gacc + off + static_cast<size_t>(row) * F + f,
            static_cast<unsigned long long>(q));
}

// d_table = the fixed-point sums times 2^-k, in f32; NaN for a level whose
// cotangent was not finite, 0 for one that was all zero.
__global__ void grid_convert_kernel(BwdParams p, size_t total, int e_n) {
  const size_t t = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= total) return;
  size_t i = t;
  const int level = grid_level_of(p.grid, i);
  const float m = __uint_as_float(p.gmax[level]);
  float v;
  if (!(m <= 3.402823466e38f))
    v = __int_as_float(0x7fc00000);
  else if (!(m > 0.f))
    v = 0.f;
  else
    v = static_cast<float>(static_cast<double>(static_cast<long long>(p.gacc[t]))
                           * ldexp(1.0, -grid_scale_exp(m, e_n)));
  p.grad_grid[t] = v;
}

// 'i8pair': dz_max[g][j-1] = max |dz_j| over the rows of group g (points
// [g G, (g+1) G) below n), j = 1..L-1; bf16 magnitudes order as their bits.
__global__ void dz_absmax_kernel(BwdParams p) {
  __shared__ unsigned int warp_max[32];
  const int g = blockIdx.x;
  const int j = blockIdx.y + 1;
  const int H = p.h, L = p.n_hidden + 1;
  const int begin = g * p.group;
  const int rows = min(p.n, begin + p.group) - begin;
  const int vecs = H / 8;
  unsigned int m = 0u;
  for (int idx = threadIdx.x; idx < rows * vecs; idx += blockDim.x) {
    const int r = begin + idx / vecs;
    const int v = idx % vecs;
    const uint4 w = *reinterpret_cast<const uint4*>(p.dz + dz_index(r, j, v * 8, L, H));
    const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int e = 0; e < 4; ++e)
      m = max(m, max(words[e] & 0x7FFFu, (words[e] >> 16) & 0x7FFFu));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = max(m, __shfl_xor_sync(0xffffffffu, m, off));
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < static_cast<int>(blockDim.x >> 5); ++w) m = max(m, warp_max[w]);
    p.dz_max[static_cast<size_t>(g) * p.n_hidden + j - 1] = __uint_as_float(m << 16);
  }
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four bytes, one from each of four words (byte `b` of each), into one word
// in order
__device__ __forceinline__ uint32_t gather_bytes(const uint32_t (&w)[4], int b) {
  const uint32_t lo = __byte_perm(w[0], w[1], b | ((b + 4) << 4));
  const uint32_t hi = __byte_perm(w[2], w[3], b | ((b + 4) << 4));
  return __byte_perm(lo, hi, 0x5410);
}

// 'i8pair' dW_h (the i8pair branch of _bwd_stash_kernel, _mm_i8): per group
// g of G points (any G >= 1 with G 127^2 < 2^31; the splits8 point ranges
// whole groups), into part_i8, with
// m = dz_max[g][j-1], scale = 127 / m (0 when m = 0) and
// dz8 = round_half_even(dz_j scale),
//   dW_h[j-1] += f32(sum over g's points of sin8_{j-1} (x) dz8, int32)
//                * (m * f32((1/127)^2))
// with the groups of a split in order. 128x128 output tiles; each 32-point
// chunk is staged transposed (points contiguous, 4 to a 32-bit word) for
// mma.sync m16n8k32 s8.s8.s32; the int32 sums are exact (G 127^2 < 2^31),
// so kernel and plain version differ only in the f32 order across groups
// and splits.
__global__ void __launch_bounds__(kI8Threads) dw_i8_kernel(BwdParams p, int pts_per_split) {
  __shared__ uint32_t sa[kI8Tile][kQuadStride];   // [m][point quad]: sin8
  __shared__ uint32_t sb[kI8Tile][kQuadStride];   // [n][point quad]: dz8
  const int H = p.h, L = p.n_hidden + 1;
  const int j = blockIdx.z + 1;
  const size_t ld = static_cast<size_t>(L) * H;
  const int n_ct = (H + kI8Tile - 1) / kI8Tile;
  const int m0 = (blockIdx.x / n_ct) * kI8Tile;
  const int c0 = (blockIdx.x % n_ct) * kI8Tile;
  float* out = p.part_i8 + (static_cast<size_t>(blockIdx.y) * p.n_hidden + j - 1) * H * H;
  const int begin = blockIdx.y * pts_per_split;
  const int end = min(p.n, begin + pts_per_split);
  const int8_t* a = p.hs8 + static_cast<size_t>(j - 1) * 2 * H;
  const float inv_sq = static_cast<float>((1.0 / 127.0) * (1.0 / 127.0));

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wm = warp & 3;   // 32 output rows each
  const int wc = warp >> 2;  // 64 output columns each
  const int g = lane >> 2;
  const int t = lane & 3;
  float acc[2][8][4];
  int iacc[2][8][4];
#pragma unroll
  for (int x = 0; x < 2; ++x)
#pragma unroll
    for (int y = 0; y < 8; ++y)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        acc[x][y][k] = 0.f;
        iacc[x][y][k] = 0;
      }

  // staging: warp w takes the chunk's points 4w..4w+3, lane l the columns
  // 4l..4l+3 of the tile (coalesced rows), transposed into one word per
  // column. A chunk that crosses a group boundary is taken one group
  // segment at a time, its other points' dz8 zero, each segment's int32 sum
  // under its own group's scale; with G a multiple of 32 every chunk is one
  // segment.
  for (int p0 = begin; p0 < end; p0 += kI8Chunk) {
    const int c_end = min(p0 + kI8Chunk, end);
    uint32_t wa[4];
    uint2 raw[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int pt = p0 + 4 * warp + i;
      wa[i] = 0u;
      raw[i] = make_uint2(0u, 0u);
      if (pt < c_end && m0 + 4 * lane < H)
        wa[i] = *reinterpret_cast<const uint32_t*>(a + static_cast<size_t>(pt) * 2 * ld
                                                   + m0 + 4 * lane);
      // 4 neighbouring columns of a row are contiguous in the dz scratch
      if (pt < c_end && c0 + 4 * lane < H)
        raw[i] = *reinterpret_cast<const uint2*>(p.dz + dz_index(pt, j, c0 + 4 * lane, L, H));
    }
    for (int s0 = p0; s0 < c_end;) {
      const int grp = s0 / p.group;
      const int s1 = min(c_end, (grp + 1) * p.group);
      const float m = p.dz_max[static_cast<size_t>(grp) * p.n_hidden + j - 1];
      const float scale = m > 0.f ? __fdiv_rn(kCosScale, m) : 0.f;
      uint32_t wb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int pt = p0 + 4 * warp + i;
        const uint32_t dw[2] = {raw[i].x, raw[i].y};
        uint32_t q = 0u;
        if (pt >= s0 && pt < s1) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const uint32_t bits = (dw[e >> 1] >> (16 * (e & 1))) & 0xFFFFu;
            const int v = __float2int_rn(__fmul_rn(__uint_as_float(bits << 16), scale));
            q |= (static_cast<uint32_t>(v) & 0xFFu) << (8 * e);
          }
        }
        wb[i] = q;
      }
      __syncthreads();   // the previous segment's fragments are read
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sa[4 * lane + e][warp] = gather_bytes(wa, e);
        sb[4 * lane + e][warp] = gather_bytes(wb, e);
      }
      __syncthreads();
      uint32_t af[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int r = wm * 32 + mt * 16 + g;
        af[mt][0] = sa[r][t];
        af[mt][1] = sa[r + 8][t];
        af[mt][2] = sa[r][4 + t];
        af[mt][3] = sa[r + 8][4 + t];
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int c = wc * 64 + nt * 8 + g;
        const uint32_t b0 = sb[c][t];
        const uint32_t b1 = sb[c][4 + t];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) mma_s8(iacc[mt][nt], af[mt], b0, b1);
      }
      // the group ends: its exact int32 sum, scaled, into the f32 sum
      if (s1 == (grp + 1) * p.group || s1 >= end) {
        const float sc = __fmul_rn(m, inv_sq);
#pragma unroll
        for (int x = 0; x < 2; ++x)
#pragma unroll
          for (int y = 0; y < 8; ++y)
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              acc[x][y][k] = __fadd_rn(acc[x][y][k],
                                       __fmul_rn(static_cast<float>(iacc[x][y][k]), sc));
              iacc[x][y][k] = 0;
            }
      }
      s0 = s1;
    }
  }

#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int row = m0 + wm * 32 + mt * 16 + g;
      const int col = c0 + wc * 64 + nt * 8 + t * 2;
      if (col >= H || row >= H) continue;   // H = 64: half a tile
      *reinterpret_cast<float2*>(out + static_cast<size_t>(row) * H + col) =
          make_float2(acc[mt][nt][0], acc[mt][nt][1]);
      if (row + 8 < H)
        *reinterpret_cast<float2*>(out + static_cast<size_t>(row + 8) * H + col) =
            make_float2(acc[mt][nt][2], acc[mt][nt][3]);
    }
  }
}

// out[e] (+)= sum over s < S of part[s][e], in a fixed order: 8 interleaved
// sequential sums per element, then those 8 in order; with `accumulate`
// the total is added to out[e].
__global__ void reduce_kernel(const float* part, int S, size_t P, float* out,
                              int accumulate) {
  __shared__ float red[8][33];
  const size_t e = static_cast<size_t>(blockIdx.x) * 32 + threadIdx.x;
  float s = 0.f;
  if (e < P)
    for (int i = threadIdx.y; i < S; i += 8) s += part[static_cast<size_t>(i) * P + e];
  red[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && e < P) {
    float total = 0.f;
#pragma unroll
    for (int y = 0; y < 8; ++y) total += red[y][threadIdx.x];
    out[e] = accumulate ? out[e] + total : total;
  }
}

cudaError_t launch_reduce(const float* part, int S, size_t P, float* out, bool accumulate,
                          cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((P + 31) / 32));
  reduce_kernel<<<grid, dim3(32, 8), 0, stream>>>(part, S, P, out, accumulate ? 1 : 0);
  return cudaGetLastError();
}

// Raises `kernel`'s shared memory limit to the card's and returns how many
// blocks of kThreads fit on the card at once, once per kernel (so no
// attribute or occupancy call in a graph capture).
template <typename K>
cudaError_t persistent_blocks(K kernel, int& max_blocks) {
  if (max_blocks > 0) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kSmemLimit));
  int device = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, kSmemLimit);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  max_blocks = sms * per_sm;
  return cudaSuccess;
}

template <int H, int kGate, bool kDpts>
cudaError_t launch_chain(BwdParams p, cudaStream_t stream) {
  static int max_blocks = 0;
  cudaError_t err = persistent_blocks(chain_wgmma_kernel<H, kGate, kDpts>, max_blocks);
  if (err != cudaSuccess) return err;
  // a stage holds a weight chunk [32 x H] bf16, a K3 chunk [32 x CW] bf16,
  // or an int8 gate tile [64, H]
  p.stage_bytes = kKC * H * 2;
  const size_t fixed = kChainHead + static_cast<size_t>(kRows) * H * 2;
  p.stages = static_cast<int>((kSmemLimit - fixed) / p.stage_bytes);
  if (p.stages > kMaxStages) p.stages = kMaxStages;
  if (p.stages < 3) return cudaErrorInvalidConfiguration;
  const int tiles = (p.n + kRows - 1) / kRows;
  prep_kernel<<<tiles, kConsumers, 0, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  chain_wgmma_kernel<H, kGate, kDpts><<<tiles < max_blocks ? tiles : max_blocks, kThreads,
                                        fixed + static_cast<size_t>(p.stages) * p.stage_bytes,
                                        stream>>>(p);
  return cudaGetLastError();
}

template <int kGate, bool kDpts>
cudaError_t launch_chain_width(const BwdParams& p, cudaStream_t s) {
  switch (p.h) {
    case 64: return launch_chain<64, kGate, kDpts>(p, s);
    case 128: return launch_chain<128, kGate, kDpts>(p, s);
    case 256: return launch_chain<256, kGate, kDpts>(p, s);
    case 384: return launch_chain<384, kGate, kDpts>(p, s);
    case 512: return launch_chain<512, kGate, kDpts>(p, s);
    default: return cudaErrorInvalidValue;
  }
}

template <int TN>
cudaError_t launch_dw_tn(BwdParams p, int n_jobs, cudaStream_t stream) {
  static int max_blocks = 0;
  cudaError_t err = persistent_blocks(dw_wgmma_kernel<TN>, max_blocks);
  if (err != cudaSuccess) return err;
  const int stage = 2 * kBox * kBox * 2 + TN * kRows * 2;
  p.stages = static_cast<int>((kSmemLimit - kDwBar) / stage);
  if (p.stages > kMaxStages) p.stages = kMaxStages;
  const int items = dw_plan(p.h, p.e_pad, n_jobs, p.splits).items;
  dw_wgmma_kernel<TN><<<items < max_blocks ? items : max_blocks, kThreads,
                        kDwBar + static_cast<size_t>(p.stages) * stage, stream>>>(p, n_jobs);
  return cudaGetLastError();
}

inline cudaError_t launch_dw(const BwdParams& p, int n_jobs, cudaStream_t s) {
  switch (dw_tn(p.h)) {
    case 64: return launch_dw_tn<64>(p, n_jobs, s);
    case 128: return launch_dw_tn<128>(p, n_jobs, s);
    default: return launch_dw_tn<256>(p, n_jobs, s);
  }
}

// The tensor maps of one backward launch over p.n points: the int8 gates
// (if `int8_gate`; 'i8pair' rows start H into the pairs), the encoding
// scratch and the bf16 sin stash (if any) as the dW kernel's A.
inline cudaError_t set_maps(BwdParams& p, bool int8_gate) {
  const int L = p.n_hidden + 1, H = p.h;
  cudaError_t err = cudaSuccess;
  if (int8_gate) {
    const uint64_t cols = p.hs8 != nullptr ? p.gate_ld - H : p.gate_ld;
    err = hp::encode_2d(&p.gate_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, p.gate, cols, p.n, p.gate_ld,
                    H < kGateBox ? H : kGateBox, kBox, H >= kGateBox);
  }
  if (err == cudaSuccess)
    err = hp::encode_2d(&p.enc_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, p.enc, p.e_pad, p.n,
                    static_cast<uint64_t>(p.e_pad) * 2, kBox, kBox, true);
  if (err == cudaSuccess && p.hs != nullptr)
    err = hp::encode_2d(&p.hs_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, p.hs,
                    static_cast<uint64_t>(L) * H, p.n, static_cast<uint64_t>(L) * H * 2, kBox,
                    kBox, true);
  return err;
}

// p.q, p.p, p.dw_ld from the shapes
inline void set_sizes(BwdParams& p) {
  const int L = p.n_hidden + 1;
  p.q = static_cast<size_t>(p.d_out) * p.h + p.d_out + static_cast<size_t>(L) * p.h;
  p.p = static_cast<size_t>(p.e_pad) * p.h + static_cast<size_t>(p.n_hidden) * p.h * p.h;
  p.dw_ld = p.hs8 != nullptr ? static_cast<size_t>(p.e_pad) * p.h : p.p;
}

// What every backward entry checks: the shapes the kernels take.
inline bool bwd_ok(const BwdParams& p) {
  return p.n > 0 && p.e_pad % 16 == 0 && p.d_out >= 1 && p.d_out <= kMaxOut &&
         p.n_hidden >= 0 && p.splits >= 1 && p.pps > 0 && p.pps % kRows == 0 &&
         static_cast<long long>(p.splits) * p.pps >= p.n &&
         (p.dpts == nullptr || (p.w_dpts != nullptr && p.d_in <= kMaxDpts));
}

// The launches after the chain kernel (see the top of this file): K5's
// scatter and conversion, the i8pair maxima, the dW products and the two
// reductions, added to the gradients already there with `accumulate`.
inline cudaError_t launch_after_chain(const BwdParams& p, bool accumulate, cudaStream_t s) {
  cudaError_t err;
  const int n = p.n;
  const int L = p.n_hidden + 1;
  if (p.grid.n_levels > 0) {
    int e_n = 0;
    while ((1LL << e_n) < n) ++e_n;
    size_t total = 0;
    for (int l = 0; l < p.grid.n_levels; ++l)
      total += static_cast<size_t>(p.grid.size[l]) * p.grid.size[l] * p.grid.size[l]
               * p.grid.features;
    const size_t terms = static_cast<size_t>(n) * p.grid.n_levels * 8 * p.grid.features;
    grid_scatter_kernel<<<static_cast<unsigned>((terms + 255) / 256), 256, 0, s>>>(p, e_n);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    grid_convert_kernel<<<static_cast<unsigned>((total + 255) / 256), 256, 0, s>>>(
        p, total, e_n);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }

  if (p.hs8 != nullptr) {
    // 'i8pair': each group's scale, dW_in on wgmma, then the hidden layers'
    // dW on the int8 cores over splits of whole groups
    const int n_groups = (n + p.group - 1) / p.group;
    if (L > 1) {
      dz_absmax_kernel<<<dim3(n_groups, L - 1), 256, 0, s>>>(p);
      err = cudaGetLastError();
      if (err != cudaSuccess) return err;
    }
    err = launch_dw(p, 1, s);
    if (err != cudaSuccess) return err;
    if (L > 1) {
      const int chunk = (n + p.splits8 - 1) / p.splits8;
      int pts_per_split = (chunk + kI8Chunk - 1) / kI8Chunk * kI8Chunk;
      pts_per_split = (pts_per_split + p.group - 1) / p.group * p.group;
      const int c_tiles = (p.h + kI8Tile - 1) / kI8Tile;
      dw_i8_kernel<<<dim3(c_tiles * c_tiles, p.splits8, L - 1), kI8Threads, 0, s>>>(
          p, pts_per_split);
      err = cudaGetLastError();
      if (err != cudaSuccess) return err;
      err = launch_reduce(p.part_i8, p.splits8, p.p - p.dw_ld, p.grad_dw + p.dw_ld, accumulate,
                          s);
      if (err != cudaSuccess) return err;
    }
  } else {
    err = launch_dw(p, L, s);
    if (err != cudaSuccess) return err;
  }

  const int n_tiles = (n + kRows - 1) / kRows;
  err = launch_reduce(p.part_chain, n_tiles, p.q, p.grad_chain, accumulate, s);
  if (err != cudaSuccess) return err;
  return launch_reduce(p.part_dw, p.splits, p.dw_ld, p.grad_dw, accumulate, s);
}

}  // namespace
}  // namespace sunerf
