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
//      the point cotangent (K3: one more product against W_in^T, its
//      columns by dimension, from whole ring stages, for any d_input); with
//      grid levels with the grid cotangent (K5: one more product, dz_0
//      against W_in's grid rows, from one ring stage a 32 columns, any
//      number of levels). 'i8pair': each point's max |dz_j| too.
//   2. K5 only: grid_scatter_kernel (a quad of lanes a (point, level),
//      equal table rows of a warp's consecutive points summed before one
//      64-bit red each) and grid_convert_kernel.
//   3. 'i8pair' only: dz_group_max_kernel, each group's max |dz_j| from the
//      points'.
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
//      dw_i8_wgmma_kernel (int8 wgmma on operands its consumers transpose
//      and quantize in shared memory), over ranges of its own (splits8) into
//      partials of its own, so neither kernel's split count sizes the
//      other's partials.
//   5. reduce_kernel: the partials summed over tiles and splits in a fixed
//      order, so a run gives the same bits as the last. K4 runs 0-4 once a
//      chunk with each partial slot adding the chunk's sum to what it
//      holds (acc_parts; an L2 reduction with one writer a slot a launch,
//      so the same order every run) and reduces once after the last.
// Rows past n are masked in every kernel: they load as zeros (dz) or are
// multiplied by zero rows of dz, and are never stored.
//
// The gate of layer j, the value dz_j = bf16(bf16(dh) * gate) multiplies by:
//   kGateInt8: bf16(bf16(q) * bf16(1/127)) of an int8 cos x127 stash (K1's
//              cs; kGateI8pair the cos half of K6b's pairs, whose chain also
//              writes each point's max |dz_j|);
//   kGateBf16: a bf16 cos (K4's recomputed fast_sincos cos);
//   kGateLsb:  bf16(sign * sqrt(max(1 - s^2, 0))) in f32 from K6a's packed
//              bf16 sin s, its last bit the sign (_unpack_sin_cos).
// The gate tile [64, H] of a layer comes through the weight ring itself,
// after the layer's weight chunks, as TMA boxes of a 2-D tensor map of the
// stash, 128-byte swizzled so the epilogue's reads of 8 rows' same columns
// fall in 8 bank groups, prefetched into L2 one layer ahead: an int8 gate
// in one stage (64 H bytes, a weight chunk's size: H / 128 boxes [64 rows x
// 128 bytes]), a 16-bit gate in two (rows 0-31 and 32-63: H / 64 boxes [32
// rows x 64 columns] each), taken under the layer's last products. There
// the consumers decode the 'lsb' sines in place (decode_lsb_gate), so the
// epilogue reads a bf16 gate, as K4's.
#pragma once

#include "fused_mlp_common.cuh"
#include "hopper.cuh"

namespace sunerf {
namespace {

namespace hp = sunerf::hopper;

constexpr int kMaxOut = 4;        // d_out the chain kernel takes
constexpr int kRows = 64;         // points a chain tile and a dW chunk
constexpr int kKC = 32;           // weight rows (k) per ring chunk
constexpr int kConsumerWarps = 8; // two warpgroups
constexpr int kConsumers = kConsumerWarps * 32;
constexpr int kThreads = kConsumers + 32;   // + the producer warp
constexpr int kMaxStages = 32;
constexpr int kRowGroups = kRows / 8;
constexpr size_t kSmemLimit = 232448;   // a block's shared memory on sm_90
// the chain kernel's head: barriers [0, 512), the block's grid maxima at
// [512, 1024) (up to 128 levels; more go after the ring), then dy [64][d_out]
// f32 at 1024 and the 'lsb' decode table at 2048
constexpr int kChainHead = 3072;
constexpr int kGridMaxAt = 512;
constexpr int kHeadLevels = (1024 - kGridMaxAt) / 4;
constexpr int kLsbTableAt = 2048;
constexpr int kGridCols = 32;     // K5's grid-cotangent columns a ring stage
constexpr int kDwBar = 1024;      // the dW kernel's barriers, before its stages
constexpr int kDwTM = 128;        // dW output rows a work item (two warpgroups)
constexpr int kBox = 64;          // rows of a TMA box; bf16 columns of a dW A box
constexpr int kGateBox = 128;     // int8 columns of a gate box (a 128-byte swizzled row)
// dw_i8_wgmma_kernel ('i8pair' dW_h): 128 output rows a work item (64 each
// warpgroup), TN = 128 columns (64 at H = 64), 64-point chunks; three
// operand buffers (see the kernel)
constexpr int kI8TM = 128;
constexpr int kI8Bufs = 3;

enum Gate : int { kGateInt8 = 0, kGateBf16 = 1, kGateLsb = 2, kGateI8pair = 3 };

// Measurement only (scripts/backward_ablation.py builds variants with -D;
// their gradients are wrong; 0, the default, is the kernel): the 'lsb' gate
// 1 = loaded but not decoded (its bits taken as a bf16 gate), 2 = decoded
// but not loaded (no gate boxes copied; bits made from each element's row
// and column); 'i8pair' 3 = dw_i8_wgmma_kernel without its operand builds,
// 4 = without its products, 5 = the chain kernel without its row maxima;
// K4 6 = its forward without the hs / cs stores (fused_mlp_fwd_wgmma.cuh),
// 7 = without its reductions; K3 8 = the tail's products without its
// epilogue, 9 = the epilogue without the products; K5 10 = the grid
// scatter's reds term by term, without the warp's merge of equal rows,
// 11 = the grid cotangent without its products, 12 = its products without
// its epilogue (no denc_grid, no maxima).
#ifndef SUNERF_ABLATION
#define SUNERF_ABLATION 0
#endif

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
  const __nv_bfloat16* w_dpts;  // K3: pack_wgmma_dpts: w_in's columns by dimension, or null
  const int* dpts_pairs;        // K3: [dpts_cols / 2] what each column pair of the pack holds
  const int* dpts_gdim;         // K3: [dpts_cols / 8] the dimension of each 8-column group
  const __nv_bfloat16* w_out;   // [d_out][H]
  __nv_bfloat16* dz;            // [tiles][L][64 x H] scratch, core-matrix order
  __nv_bfloat16* enc;           // [n, e_pad] scratch
  float* part_chain;            // [tiles][q] per-tile partials
  float* part_dw;               // [splits][dw_ld] the dW kernel's per-split partials
  float* part_i8;               // 'i8pair': [splits8][(L-1) H^2] dw_i8_wgmma_kernel's partials
  float* grad_chain;            // [q]: dW_out [H][d_out], db_out, db_j [L][H]
  float* grad_dw;               // [p]: dW_in [e_pad][H], dW_h [L-1][H][H]
  GridParams grid;              // dense grid levels (K5), or none
  const __nv_bfloat16* w_grid;  // pack_wgmma_grid: w_in's grid rows, 32 columns a ring stage
  float* dgrid;                 // [n, levels * F] scratch: denc_grid
  unsigned int* gmax;           // [levels] bits of max |denc_grid|, zeroed
  int gmax_at;                  // the chain kernel's block maxima, a byte offset in its smem
  unsigned long long* gacc;     // [sum G^3 F] fixed-point sums, zeroed
  float* grad_grid;             // [sum G^3 F]: d_table of each level
  float* dpts;                  // K3: [n, d_in], or null
  int dpts_cols;                // K3: the pack's columns, a multiple of its chunk's
  int acc_parts;                // 1: add to the partials (K4's chunks after the first)
  CUtensorMap hs8_map;          // 'i8pair': the int8 pairs [n, 2 L H], dw_i8_wgmma_kernel's A
  float* dz_rowmax;             // 'i8pair': [L-1][n][2] max |dz_j| of each point, j >= 1
  float* dz_max;                // 'i8pair': [n_groups][L-1] max |dz_j| of each group
  int group;                    // 'i8pair': points per dz scale group
  int pps8;                     // 'i8pair': points a dW_h range (whole groups and tiles)
  int n, d_in, n_cols, e_pad, h, n_hidden, d_out;
  int splits, pps;              // dW: point ranges of pps points (a multiple of 64)
  int splits8;                  // 'i8pair': dw_i8_wgmma_kernel's point ranges
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

// The bf16 bits of bf16(sign * sqrt(max(1 - s^2, 0))) of a packed bf16 sin
// s (its 16 bits; finite), in f32 with every operation rounded on its own
// (_unpack_sin_cos): the 'lsb' gate, from which its table is built.
__device__ __forceinline__ uint32_t lsb_cos_bits(uint32_t bits) {
  const float s = __uint_as_float(bits << 16);
  const float c = __fsqrt_rn(fmaxf(__fsub_rn(1.0f, __fmul_rn(s, s)), 0.0f));
  return __bfloat16_as_ushort(__float2bfloat16_rn((bits & 1u) ? -c : c));
}

// The 'lsb' gate by table: lsb_cos_bits of the packed bits h depends on
// a = h & 0x7FFF (s's magnitude, its last bit included) for its magnitude
// and on h & 1 for its sign. |s| < 2^-4 (a < 0x3D80) rounds to 1, |s| >= 1
// (a in [0x3F80, 0x7F80]) gives 0 and a NaN s NaN (as JAX's max(NaN, 0)
// does); the 512 a in between are a 1 KB table of lsb_cos_bits' magnitudes
// in shared memory, built by the block every tile. The same bits as _unpack_sin_cos on every pattern
// (ops/fused_mlp.py lsb_cos_decode, held to the card's lsb_decode_kernel
// on all 65,536).
constexpr uint32_t kLsbLo = 0x3D80u;
constexpr int kLsbTable = 0x3F80 - kLsbLo;

__device__ __forceinline__ void build_lsb_table(uint16_t* table) {
  for (int i = threadIdx.x; i < kLsbTable; i += kConsumers)
    table[i] = static_cast<uint16_t>(lsb_cos_bits(kLsbLo + i) & 0x7FFFu);
}

__device__ __forceinline__ uint32_t lsb_cos_table(const uint16_t* table, uint32_t h) {
  const uint32_t a = h & 0x7FFFu;
  uint32_t mag = a < kLsbLo ? 0x3F80u : a > 0x7F80u ? 0x7FC0u : 0u;
  if (a - kLsbLo < static_cast<uint32_t>(kLsbTable)) mag = table[a - kLsbLo];
  return mag | ((h & 1u) << 15);
}

// Measurement only: the bits an element of an 'lsb' gate that was not
// loaded stands on (SUNERF_ABLATION == 2), packed sines in [0.5, 1)
__device__ __forceinline__ uint32_t ablation_bits(int row, int col) {
  const uint32_t h = (row * 0x9E3779B1u) ^ (col * 0x85EBCA77u);
  return (h & 0x007F007Fu) | 0x3F003F00u;
}

// The 'lsb' gates of a packed pair (two bf16 sines in one word): two bf16
// cosines in one word
__device__ __forceinline__ uint32_t lsb_cos_pair(const uint16_t* table, uint32_t bits) {
  if (SUNERF_ABLATION == 1) return bits;
  return lsb_cos_table(table, bits & 0xFFFFu) | (lsb_cos_table(table, bits >> 16) << 16);
}

// Where a layer's gate tile [64, H] lies in the weight ring: an int8 gate
// in one stage (H / 128 swizzled boxes [64][128], or one plain box [64][64]
// at H = 64), a 16-bit gate (bf16 or 'lsb') in two, rows 0-31 in `a` and
// 32-63 in `b`, each H / 64 swizzled boxes [32 rows][64 columns]; and the
// 'lsb' decode table.
struct GateRef {
  const unsigned char* a;
  const unsigned char* b;
  const uint16_t* table;
};

// Byte offset of (row, col) of a 16-bit gate in its half-tile stage
__device__ __forceinline__ int gate16_offset(int row, int col) {
  return (col >> 6) * (32 * 128) + hp::swizzle128(row & 31, (col & 63) * 2);
}

// The gates at (row, col) and (row, col + 1) of the tile, col even, from one
// shared-memory load (a 16-bit stage holds bf16 cosines: K4's, or the 'lsb'
// sines decoded in place, see decode_lsb_gate; `kRaw` decodes the packed
// sines here instead). Rows past n are zeros (TMA's fill): their dh is
// zero, so dz = 0 whatever the gate.
template <int H, int kGate, bool kRaw = false>
__device__ __forceinline__ float2 gate_pair(const GateRef& g, int row, int col) {
  if constexpr (kGate == kGateInt8 || kGate == kGateI8pair) {
    const int at = H < kGateBox ? row * H + col
        : (col / kGateBox) * (kBox * kGateBox) + hp::swizzle128(row, col % kGateBox);
    const char2 q = *reinterpret_cast<const char2*>(g.a + at);
    return make_float2(cos_dequant(q.x), cos_dequant(q.y));
  } else {
    uint32_t bits = *reinterpret_cast<const uint32_t*>((row < 32 ? g.a : g.b)
                                                       + gate16_offset(row, col));
    if constexpr (kGate == kGateLsb && kRaw) {
      if (SUNERF_ABLATION == 2) bits = ablation_bits(row, col);
      bits = lsb_cos_pair(g.table, bits);
    }
    return make_float2(__uint_as_float(bits << 16), __uint_as_float(bits & 0xFFFF0000u));
  }
}

// 'lsb': the packed sines of the gate stages that this thread's epilogue
// reads (rows 16 w4 + g + 8 r, columns wg N + 8 jj + 2 q, as the
// accumulators) decoded in place into bf16 cosines, while the layer's last
// products run on the tensor cores; then visible to the copy engine, which
// refills the stages after their release.
template <int H>
__device__ __forceinline__ void decode_lsb_gate(const GateRef& g) {
  constexpr int N = H / 2;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wg = warp >> 2, w4 = warp & 3, gi = lane >> 2, q = lane & 3;
  unsigned char* half = const_cast<unsigned char*>(w4 < 2 ? g.a : g.b);
#pragma unroll 4
  for (int jj = 0; jj < N / 8; ++jj) {
    const int col = wg * N + 8 * jj + 2 * q;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = w4 * 16 + gi + 8 * r;
      uint32_t* at = reinterpret_cast<uint32_t*>(half + gate16_offset(row, col));
      *at = lsb_cos_pair(g.table, SUNERF_ABLATION == 2 ? ablation_bits(row, col) : *at);
    }
  }
  hp::fence_async_smem();
}

__device__ __forceinline__ void release(uint64_t* empty, int lane) {
  __syncwarp();
  if (lane == 0) hp::mbar_arrive(empty);
}

// A partial sum into its slot: written, or with `acc` (K4's chunks after
// the first) added to what the slot holds by a reduction in L2 (red.add,
// round to nearest; the thread does not wait for it, where a load of the
// slot stalled the chain kernel's consumers once per column pair): each
// slot has one writer a launch and the launches run in order, so each slot
// sums its chunks in order, the same bits every run, and one reduction at
// the end takes the slots.
__device__ __forceinline__ void put_part(float* at, float v, bool acc) {
  if (acc)
    atomicAdd(at, v);
  else
    *at = v;
}

// The tile's recomputed encoding [x, sin u, cos u, grid features, zeros]
// as bf16 rows of the scratch [n, e_pad], as the forward computes it: cos
// u = sin(u + pi/2), as the TPU kernel's fast_cos; then the grid features,
// a (point, level) a thread (grid_level_features: the cell once, the
// corners' rows as vectors).
template <bool kGrid>
__device__ __forceinline__ void encode_rows(const BwdParams& p, int row0, int rows) {
  const int grid0 = p.d_in + 2 * p.n_cols;
  const int F = p.grid.features;
  const int grid_end = grid0 + (kGrid ? p.grid.n_levels * F : 0);
  for (int idx = threadIdx.x; idx < rows * p.e_pad; idx += kConsumers) {
    const int r = idx / p.e_pad;
    const int c = idx - r * p.e_pad;
    if (kGrid && c >= grid0 && c < grid_end) continue;
    const float* x = p.pts + static_cast<size_t>(row0 + r) * p.d_in;
    float v = 0.f;
    if (c < p.d_in) {
      v = x[c];
    } else if (c < grid0) {
      const int j = (c - p.d_in) % p.n_cols;
      const float u = __fmul_rn(x[p.col_dim[j]], p.col_freq[j]);
      v = fast_sin(c < p.d_in + p.n_cols ? u : __fadd_rn(u, kHalfPi));
    }
    p.enc[static_cast<size_t>(row0) * p.e_pad + idx] = __float2bfloat16_rn(v);
  }
  if constexpr (!kGrid) return;
  for (int it = threadIdx.x; it < rows * p.grid.n_levels; it += kConsumers) {
    const int level = it / rows, r = it - level * rows;
    __nv_bfloat16* dst = p.enc + static_cast<size_t>(row0 + r) * p.e_pad + grid0 + level * F;
    grid_level_features<4>(p.grid, level, p.pts + static_cast<size_t>(row0 + r) * p.d_in,
                           [&](int f, float v) { dst[f] = __float2bfloat16_rn(v); });
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
        put_part(part + m * d_out + o, acc[o][0], p.acc_parts);
        put_part(part + (m + 1) * d_out + o, acc[o][1], p.acc_parts);
      }
    }
  }
  if (threadIdx.x < d_out) {
    float s = 0.f;
    for (int r = 0; r < kRows; ++r) s += sdy[r * d_out + threadIdx.x];
    put_part(part + d_out * H + threadIdx.x, s, p.acc_parts);
  }
}

// dy of a tile's rows (zeros past n) into sdy [64][d_out]
__device__ __forceinline__ void load_dy(const BwdParams& p, int row0, int rows, float* sdy) {
  for (int idx = threadIdx.x; idx < kRows * p.d_out; idx += kConsumers)
    sdy[idx] = idx / p.d_out < rows ? p.dy[static_cast<size_t>(row0) * p.d_out + idx] : 0.f;
}

// The tile's dW_out and db_out partials and its rows of the encoding
// scratch: a block of kConsumers threads per 64-point tile (prep_kernel;
// prep_grid_kernel with grid levels, at least 4 blocks an SM: the grid
// features' loads at 110 registers a thread left 2, and prep took 0.29 ms
// instead of 0.21 at 8x512, N = 196,608; H100 80GB HBM3, 700 W). Without a
// grid the kernel holds no grid code, so its registers and occupancy are
// its own.
template <bool kGrid>
__device__ __forceinline__ void prep_tile(const BwdParams& p) {
  __shared__ float sdy[kRows * kMaxOut];
  const int row0 = blockIdx.x * kRows;
  const int rows = min(kRows, p.n - row0);
  load_dy(p, row0, rows, sdy);
  encode_rows<kGrid>(p, row0, rows);
  __syncthreads();
  dw_out_partial(p, row0, rows, sdy, p.part_chain + static_cast<size_t>(blockIdx.x) * p.q);
}

__global__ void __launch_bounds__(kConsumers) prep_kernel(BwdParams p) { prep_tile<false>(p); }

__global__ void __launch_bounds__(kConsumers, 4) prep_grid_kernel(BwdParams p) {
  prep_tile<true>(p);
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
      const float2 gt = gate_pair<H, kGate, true>(gate, r, col);
      const float z0 = bf16_round(bf16_round(dh0) * gt.x);
      const float z1 = bf16_round(bf16_round(dh1) * gt.y);
      *reinterpret_cast<uint32_t*>(act + hp::core_offset(r, col, kRowGroups)) = pack_bf16(z0, z1);
      s0 += z0;
      s1 += z1;
    }
    sum_rows(s0, s1);
    if (g == 0) {
      put_part(db + col, s0, kGate == kGateBf16 && p.acc_parts);
      put_part(db + col + 1, s1, kGate == kGateBf16 && p.acc_parts);
    }
  }
}

// db[c] (+)= the sum of the buffer's column c over the 64 rows (dz_j, exact
// bf16 values), in the order of first_dz
template <int H>
__device__ __forceinline__ void column_sums(const __nv_bfloat16* act, float* db, bool acc) {
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
      put_part(db + col, s0, acc);
      put_part(db + col + 1, s1, acc);
    }
  }
}

// 'i8pair': each point's max |dz_j| in dz_rowmax [L-1][n][2], two partial
// maxima a point (the columns of the chain's two warpgroups), as floats
// whose magnitudes compare as their bits (NaN above infinity, as jnp.max
// propagates it); each group's maximum is then a reduction of its points'
// (dz_group_max_kernel). The layers' epilogues take them from the
// accumulators they gate; dz_{L-1}, which first_dz writes, here from the
// buffer: out[2 (row0 + r)] = the max over the tile's row r (its bf16 values
// as f32; rows past n not stored), out[2 (row0 + r) + 1] = 0. Thread t takes
// row t / 4 and the 8-column groups t % 4 + 4 i, 16 bytes a load, and the
// four threads of a row meet by shuffles.
template <int H>
__device__ __forceinline__ void row_maxima(const __nv_bfloat16* act, float* out, int row0, int n) {
  const int r = threadIdx.x >> 2;
  uint32_t m = 0u;
#pragma unroll 4
  for (int cg = threadIdx.x & 3; cg < H / 8; cg += 4) {
    const uint4 v = *reinterpret_cast<const uint4*>(act + hp::core_offset(r, 8 * cg, kRowGroups));
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) m = max(m, max(w[e] & 0x7FFFu, (w[e] >> 16) & 0x7FFFu));
  }
  m = max(m, __shfl_xor_sync(0xffffffffu, m, 1));
  m = max(m, __shfl_xor_sync(0xffffffffu, m, 2));
  if ((threadIdx.x & 3) == 0 && row0 + r < n)
    *reinterpret_cast<float2*>(out + 2 * static_cast<size_t>(row0 + r)) =
        make_float2(__uint_as_float(m << 16), 0.f);
}

// K5's grid cotangent of the tile's rows, denc_grid = dz_0 bf16(W_in[grid
// rows])^T, into p.dgrid [n, levels F], and each level's max |denc_grid|
// into the block's maxima `smax` (bits: non-negative floats order as their
// bits do, NaN above infinity; any order gives the same max). On wgmma, as
// K3's point cotangent: per chunk of 32 columns one ring stage of
// pack_wgmma_grid (H / 32 k-chunks [32 x 32]), each warpgroup m64n16k16
// over its 16 columns from dz_0 in the buffer, issued at once and waited
// for once, with `during` (db_0's column sums) under the first chunk's
// products. Then each thread stores its 8 sums, and each column's max over
// the warp's 16 rows, by shuffles, goes to its level's maximum (a shared
// atomicMax by the 4 lanes of row 0). The first design summed these on
// the CUDA cores in the chain kernel's tail: 0.41 ms of the chain at the
// NGP recipe (H100 80GB HBM3, 700 W; PERF.md).
template <int H, typename Take, typename During>
__device__ __forceinline__ void grid_cotangent(const BwdParams& p, uint32_t a0, int row0,
                                               Take&& take, uint64_t* empty, uint32_t ring0,
                                               int stage_bytes, unsigned int* smax,
                                               During&& during) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wg = warp >> 2, w4 = warp & 3, g = lane >> 2, q = lane & 3;
  const int F = p.grid.features, n_grid = p.grid.n_levels * F;
  const int n_gc = (n_grid + kGridCols - 1) / kGridCols;
  for (int cc = 0; cc < n_gc; ++cc) {
    float acc[8] = {};
    const int st = take();
    hp::wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < H / kKC; ++kc) {
      // k-chunk kc [32 x 32] of the stage, this warpgroup's 16 columns
      const uint32_t b0 =
          ring0 + st * stage_bytes + kc * (kKC * kGridCols * 2) + wg * (kGridCols / 16) * 128;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (SUNERF_ABLATION != 11)
          hp::wgmma_ss(acc, hp::make_desc(a0 + (4 * kc + 2 * h) * kRowGroups * 128,
                                          kRowGroups * 128, 128),
                       hp::make_desc(b0 + 2 * h * (kGridCols / 8) * 128, (kGridCols / 8) * 128,
                                     128),
                       kc > 0 || h > 0);
    }
    hp::wgmma_commit();
    if (cc == 0) during();
    hp::wgmma_wait<0>();
    hp::fence_regs(acc);
    release(&empty[st], lane);
    if (SUNERF_ABLATION == 12) continue;
    const int col0 = cc * kGridCols + wg * (kGridCols / 2);
#pragma unroll
    for (int jj = 0; jj < 2; ++jj)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int gr = row0 + w4 * 16 + g + 8 * r;
        const int j = col0 + 8 * jj + 2 * q;
        if (gr >= p.n) continue;
        float* at = p.dgrid + static_cast<size_t>(gr) * n_grid + j;
        if (SUNERF_ABLATION == 13) continue;
        if (j < n_grid) at[0] = acc[4 * jj + 2 * r];
        if (j + 1 < n_grid) at[1] = acc[4 * jj + 2 * r + 1];
      }
    if (col0 >= n_grid) continue;
    // each of the thread's 4 columns' max over its 2 rows, then over the 8
    // lanes of its column pair (the rows g), and lanes 0-3 (g = 0) take
    // them to the columns' levels: 16 shared atomicMax a warp and chunk
    unsigned int cm[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int jj = c >> 1, e = c & 1;
      unsigned int m = 0u;
#pragma unroll
      for (int r = 0; r < 2; ++r)
        if (row0 + w4 * 16 + g + 8 * r < p.n)
          m = max(m, __float_as_uint(fabsf(acc[4 * jj + 2 * r + e])));
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) m = max(m, __shfl_xor_sync(0xffffffffu, m, off));
      cm[c] = m;
    }
    if (g == 0) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = col0 + 8 * (c >> 1) + 2 * q + (c & 1);
        if (j < n_grid && cm[c] != 0u) atomicMax(smax + j / F, cm[c]);
      }
    }
  }
}

// K3, the point cotangent of the tile's rows (the compute_dpts=True branch
// of _bwd_stash_kernel, and the tail of _bwd_kernel):
//   denc = dz_0 bf16(W_in[:n_enc])^T,
//   dpts[r, d] = denc[r, d] + sum over the phase columns j of dimension d
//                of freq_j (cos u_j dsin_j - sin u_j dcos_j),
// u_j = x[dim_j] freq_j in f32 and its sine and cosine by the kernels'
// range-reduced polynomial (cos u = sin(u + pi/2), as in the encoding).
// pack_wgmma_dpts orders W_in's columns by dimension (dpts_layout), each
// dimension's segment [x_d, 0, (sin_j, cos_j) for its phases] in whole
// 8-column groups, so a thread's column pair is one phase's (dsin, dcos)
// and every group one dimension's (dpts_pairs, dpts_gdim); a segment does
// not run across the halves of a chunk that the two warpgroups take where
// it fits in one. Per chunk of CW columns the products are issued at once,
// CW / 32 ring stages of H / CW k-chunks each, and waited for once; under
// them run `during` (the caller's db_0 column sums) and the loads of each
// pair's phase, frequency and coordinates. Then each thread sums its
// pairs' terms per row and group, the 4 lanes of a group meet by shuffles,
// and lane q = 0 writes each run of groups of one dimension to dpts: the
// whole of that dimension's sum, or, where a segment runs across halves
// (a dimension of more than CW / 2 columns), added in turn, warpgroup 0's
// half, a barrier, warpgroup 1's. Either way each (point, dimension) sums
// its groups in column order, the same bits every run, for any d_input.
template <int H, typename Take, typename During>
__device__ __forceinline__ void point_cotangent(const BwdParams& p, uint32_t a0, int row0,
                                                Take&& take, uint64_t* empty, uint32_t ring0,
                                                int stage_bytes, During&& during) {
  constexpr int CW = H < 128 ? H : 128;   // pack columns a chunk
  constexpr int NW = CW / 2;              // of them, each warpgroup's
  constexpr int kStages = CW / 32;        // ring stages a chunk
  constexpr int kPer = H / CW;            // k-chunks [32 x CW] a stage
  constexpr int G = NW / 8;               // groups a warpgroup's half
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wg = warp >> 2, w4 = warp & 3, g = lane >> 2, q = lane & 3;
  const int D = p.d_in;
  const int n_cc = p.dpts_cols / CW;
  // does a dimension's run of groups cross from one half to the next?
  bool split = false;
  for (int b = G; b < p.dpts_cols / 8; b += G) {
    const int d = __ldg(p.dpts_gdim + b);
    split |= d < D && __ldg(p.dpts_gdim + b - 1) == d;
  }
  int rows[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) rows[r] = row0 + w4 * 16 + g + 8 * r;
  for (int cc = 0; cc < n_cc; ++cc) {
    float acc[NW / 2] = {};
    int st[kStages];
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      st[s] = take();
      hp::wgmma_fence();
#pragma unroll
      for (int c = 0; c < kPer; ++c) {
        const int kc = s * kPer + c;   // rows 32 kc.. of W_in^T
        const uint32_t b0 = ring0 + st[s] * stage_bytes + c * (kKC * CW * 2) + wg * (NW / 8) * 128;
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (SUNERF_ABLATION != 9)
            hp::wgmma_ss(acc, hp::make_desc(a0 + (4 * kc + 2 * h) * kRowGroups * 128,
                                            kRowGroups * 128, 128),
                         hp::make_desc(b0 + 2 * h * (CW / 8) * 128, (CW / 8) * 128, 128),
                         kc > 0 || h > 0);
      }
    }
    hp::wgmma_commit();
    // under the products: each pair's phase (or what else it holds), its
    // frequency and the rows' coordinates of its dimension
    const int grp0 = cc * (CW / 8) + wg * G;
    int pr[G];
    float fq[G], xv[G][2];
#pragma unroll
    for (int jj = 0; jj < G; ++jj) {
      pr[jj] = __ldg(p.dpts_pairs + (grp0 + jj) * 4 + q);
      const int j = max(pr[jj], 0);
      fq[jj] = __ldg(p.col_freq + j);
      const int d = __ldg(p.col_dim + j);
#pragma unroll
      for (int r = 0; r < 2; ++r)
        xv[jj][r] = __ldg(p.pts + static_cast<size_t>(min(rows[r], p.n - 1)) * D + d);
    }
    if (cc == 0) during();
    hp::wgmma_wait<0>();
    hp::fence_regs(acc);
#pragma unroll
    for (int s = 0; s < kStages; ++s) release(&empty[st[s]], lane);
    if (SUNERF_ABLATION == 8) continue;
    // each group's sum over its 8 columns for the thread's two rows
    float gs[G][2];
#pragma unroll
    for (int jj = 0; jj < G; ++jj) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float v0 = acc[4 * jj + 2 * r], v1 = acc[4 * jj + 2 * r + 1];
        float t = 0.f;
        if (pr[jj] >= 0) {
          // v0 = dsin, v1 = dcos of the phase
          const float u = __fmul_rn(xv[jj][r], fq[jj]);
          t = __fsub_rn(__fmul_rn(__fmul_rn(fast_sin(__fadd_rn(u, kHalfPi)), v0), fq[jj]),
                        __fmul_rn(__fmul_rn(fast_sin(u), v1), fq[jj]));
        } else if (pr[jj] < -1) {
          t = v0;   // x_d, its partner column zero
        }
        t += __shfl_xor_sync(0xffffffffu, t, 1);
        t += __shfl_xor_sync(0xffffffffu, t, 2);
        gs[jj][r] = t;
      }
    }
    // the runs of groups of one dimension into dpts (split: warpgroup 0's
    // half first)
#pragma unroll 1
    for (int half = 0; half < 2; ++half) {
      if ((!split || wg == half) && q == 0) {
        float run[2] = {0.f, 0.f};
        int cur = __ldg(p.dpts_gdim + grp0), start = grp0;
        auto flush = [&]() {
          if (cur >= D) return;   // the zero groups after the last dimension
          const bool first = start == 0 || __ldg(p.dpts_gdim + start - 1) != cur;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            if (rows[r] < p.n) {
              float* at = p.dpts + static_cast<size_t>(rows[r]) * D + cur;
              *at = first ? run[r] : __fadd_rn(*at, run[r]);
            }
          }
        };
#pragma unroll
        for (int jj = 0; jj < G; ++jj) {
          const int d = __ldg(p.dpts_gdim + grp0 + jj);
          if (d != cur) {
            flush();
            cur = d;
            start = grp0 + jj;
            run[0] = run[1] = 0.f;
          }
          run[0] += gs[jj][0];
          run[1] += gs[jj][1];
        }
        flush();
      }
      if (!split) break;
      hp::named_sync(1, kConsumers);
    }
  }
}

template <int H, int kGate, bool kDpts>
__global__ void __launch_bounds__(kThreads, 1) chain_wgmma_kernel(const __grid_constant__ BwdParams p) {
  constexpr int N = H / 2;                 // columns of each warpgroup
  constexpr int nk = H / kKC;              // ring chunks of a layer's weights
  // an int8 gate: kGateBoxes boxes [64 rows][kGateCols] in one stage; a
  // 16-bit gate: H / 64 boxes [32 rows][64 columns] in each of two
  constexpr bool k16 = kGate == kGateBf16 || kGate == kGateLsb;
  constexpr bool kRowMax = kGate == kGateI8pair;
  constexpr bool kAcc = kGate == kGateBf16;   // K4: partials added chunk to chunk
  constexpr int kGateBoxes = k16 ? H / 64 : H < kGateBox ? 1 : H / kGateBox;
  constexpr int kGateCols = k16 ? 64 : H < kGateBox ? H : kGateBox;
  constexpr int kGateRows = k16 ? kRows / 2 : kRows;
  constexpr int kGateStages = k16 ? 2 : 1;
  constexpr int CW = H < 128 ? H : 128;    // K3's columns a chunk
  constexpr uint32_t kChunkBytes = kKC * H * 2;
  extern __shared__ __align__(1024) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kMaxStages;
  auto* smax = reinterpret_cast<unsigned int*>(smem + p.gmax_at);   // K5's level maxima
  float* scratch = reinterpret_cast<float*>(smem + 1024);
  auto* lsb_table = reinterpret_cast<uint16_t*>(smem + kLsbTableAt);
  auto* act = reinterpret_cast<__nv_bfloat16*>(smem + kChainHead);
  unsigned char* ring = smem + kChainHead + kRows * H * 2;
  const int S = p.stages, SB = p.stage_bytes;
  const int L = p.n_hidden + 1;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tiles = (p.n + kRows - 1) / kRows;
  const int n_cc = kDpts ? p.dpts_cols / CW : 0;
  const int n_gc = (p.grid.n_levels * p.grid.features + kGridCols - 1) / kGridCols;

  for (int l = threadIdx.x; l < p.grid.n_levels; l += blockDim.x) smax[l] = 0u;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      hp::mbar_init(&full[s], 1);
      hp::mbar_init(&empty[s], kConsumerWarps);
    }
    hp::fence_barrier_init();
  }
  __syncthreads();

  if (warp == kConsumerWarps) {
    // producer: the weight chunks and the gates in the order the consumers
    // take them, across layers and tiles
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
    constexpr uint32_t kBoxBytes = kGateRows * kGateCols * (k16 ? 2 : 1);
    auto put_gate = [&](int row0, int j) {
      for (int h = 0; h < kGateStages; ++h) {
        const int st = next();
        if (lane == 0) {
          if (kGate == kGateLsb && SUNERF_ABLATION == 2) {
            hp::mbar_arrive(&full[st]);
            continue;
          }
          hp::mbar_expect_tx(&full[st], kGateBoxes * kBoxBytes);
          for (int b = 0; b < kGateBoxes; ++b)
            hp::tensor_load_2d(ring + st * SB + b * kBoxBytes, &p.gate_map,
                               j * p.gate_layer + b * kGateCols, row0 + h * kGateRows,
                               &full[st], stream);
        }
      }
    };
    auto prefetch_gate = [&](int row0, int j) {
      if (lane == 0)
        for (int h = 0; h < kGateStages; ++h)
          for (int b = 0; b < kGateBoxes; ++b)
            hp::tensor_prefetch_2d(&p.gate_map, j * p.gate_layer + b * kGateCols,
                                   row0 + h * kGateRows);
    };
    for (int w = blockIdx.x; w < tiles; w += gridDim.x) {
      const int row0 = w * kRows;
      put_gate(row0, L - 1);
      for (int j = L - 1; j > 0; --j) {
        prefetch_gate(row0, j - 1);
        for (int kc = 0; kc < nk; ++kc)
          put_chunk(wb + (static_cast<size_t>(j - 1) * nk + kc) * kChunkBytes, kChunkBytes);
        put_gate(row0, j - 1);
      }
      // K3: a chunk of CW columns of W_in^T is CW / 32 whole stages
      for (int cc = 0; cc < n_cc; ++cc)
        for (int s = 0; s < CW / 32; ++s)
          put_chunk(we + (static_cast<size_t>(cc) * (CW / 32) + s) * SB, SB);
      // K5: a chunk of 32 columns of the grid rows is one stage
      for (int cc = 0; cc < n_gc; ++cc)
        put_chunk(reinterpret_cast<const unsigned char*>(p.w_grid) + static_cast<size_t>(cc) * SB,
                  SB);
      // the next tile's first gate into L2
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
      // the next gate's stages from the ring, and their release
      auto take_gate = [&]() -> GateRef {
        const int a = take();
        const int b = k16 ? take() : a;
        return {ring + a * SB, ring + b * SB, lsb_table};
      };
      auto release_gate = [&](const GateRef& g) {
        release(&empty[(g.a - ring) / SB], lane);
        if constexpr (k16) release(&empty[(g.b - ring) / SB], lane);
      };

      // dy of the tile's rows (zeros past n); 'lsb': the decode table
      load_dy(p, row0, rows, scratch);
      if constexpr (kGate == kGateLsb) build_lsb_table(lsb_table);
      hp::named_sync(1, kConsumers);

      // dz_{L-1} into the buffer; the copy engine stores it
      {
        const GateRef g = take_gate();
        first_dz<H, kGate>(p, scratch, g, act, part_db + (L - 1) * H);
        release_gate(g);
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
        GateRef gr{};
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
          // (db_{L-1} came with dz_{L-1}); 'i8pair': each row's max |dz_j|
          if (kc == 0 && j < L - 1) column_sums<H>(act, part_db + j * H, kAcc && p.acc_parts);
          if (kRowMax && kc == 0 && j == L - 1 && SUNERF_ABLATION != 5)
            row_maxima<H>(act, p.dz_rowmax + static_cast<size_t>(j - 1) * 2 * p.n, row0, p.n);
          hp::wgmma_wait<2>();
          if (kc > 1) release(&empty[prev2], lane);
          prev2 = prev1;
          prev1 = st;
          // a 16-bit gate is taken under the last products ('lsb': and
          // decoded there); the ring holds the two chunks in flight and its
          // two stages (stages >= 4)
          if constexpr (k16) {
            if (kc == nk - 1) {
              gr = take_gate();
              if constexpr (kGate == kGateLsb) decode_lsb_gate<H>(gr);
            }
          }
        }
        hp::wgmma_wait<0>();
        hp::fence_regs(acc);
        release(&empty[prev2], lane);
        release(&empty[prev1], lane);
        // both warpgroups and the copy engine have read dz_j: the epilogue
        // overwrites it with dz_{j-1} = bf16(bf16(dh) * gate_{j-1})
        if (threadIdx.x == 0) hp::bulk_wait_read();
        hp::named_sync(1, kConsumers);
        if constexpr (!k16) gr = take_gate();
        uint32_t zmax[2] = {0u, 0u};   // 'i8pair': the rows' |dz_{j-1}|, two bf16 a word
#pragma unroll
        for (int jj = 0; jj < N / 8; ++jj) {
          const int col = wg * N + 8 * jj + 2 * q;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int row = w4 * 16 + g + 8 * r;
            const float2 gt = gate_pair<H, kGate>(gr, row, col);
            const float z0 = bf16_round(bf16_round(acc[4 * jj + 2 * r]) * gt.x);
            const float z1 = bf16_round(bf16_round(acc[4 * jj + 2 * r + 1]) * gt.y);
            const uint32_t zw = pack_bf16(z0, z1);
            *reinterpret_cast<uint32_t*>(act + hp::core_offset(row, col, kRowGroups)) = zw;
            if constexpr (kRowMax) zmax[r] = __vmaxu2(zmax[r], zw & 0x7FFF7FFFu);
          }
        }
        if (kRowMax && j > 1 && SUNERF_ABLATION != 5) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            zmax[r] = __vmaxu2(zmax[r], __shfl_xor_sync(0xffffffffu, zmax[r], 1));
            zmax[r] = __vmaxu2(zmax[r], __shfl_xor_sync(0xffffffffu, zmax[r], 2));
            const int gr_row = row0 + w4 * 16 + g + 8 * r;
            if (q == 0 && gr_row < p.n)
              p.dz_rowmax[(static_cast<size_t>(j - 2) * p.n + gr_row) * 2 + wg] =
                  __uint_as_float(max(zmax[r] & 0xFFFFu, zmax[r] >> 16) << 16);
          }
        }
        release_gate(gr);
        hp::fence_async_smem();
        hp::named_sync(1, kConsumers);
        if (threadIdx.x == 0)
          hp::bulk_store(dz_tile + static_cast<size_t>(j - 1) * kRows * H, act, kRows * H * 2,
                         stream);
      }
      // the buffer holds dz_0: db_0, and the tails read it beside the copy
      // engine
      auto db0 = [&]() {
        if (L > 1) column_sums<H>(act, part_db, kAcc && p.acc_parts);
      };
      if constexpr (kDpts) {
        point_cotangent<H>(p, a0, row0, take, empty, ring0, SB, db0);
        if (n_gc > 0) grid_cotangent<H>(p, a0, row0, take, empty, ring0, SB, smax, [] {});
      } else if (n_gc > 0) {
        grid_cotangent<H>(p, a0, row0, take, empty, ring0, SB, smax, db0);
      } else {
        db0();
      }
      if (threadIdx.x == 0) hp::bulk_wait_read();
      hp::named_sync(1, kConsumers);
    }
    if (threadIdx.x == 0) hp::bulk_wait();
    // K5: the block's level maxima, once
    for (int l = threadIdx.x; l < p.grid.n_levels; l += kConsumers)
      if (smax[l] != 0u) atomicMax(p.gmax + l, smax[l]);
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
          if (row < m_rows) {
            // K4's chunks after the first add to the split's partials (see
            // put_part)
            float2* at = reinterpret_cast<float2*>(out + static_cast<size_t>(row) * H + col);
            const float2 v = make_float2(acc[4 * jj + 2 * r], acc[4 * jj + 2 * r + 1]);
            if (p.acc_parts)
              atomicAdd(at, v);
            else
              *at = v;
          }
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
// order), from the descriptors' offsets.
__device__ __forceinline__ int grid_level_of(const GridParams& g, long long i) {
  int l = 0;
  while (l + 1 < g.n_levels && i >= grid_level(g, l + 1).offset) ++l;
  return l;
}

// K5's scatter of the grid cotangent onto the tables, a quad of lanes a
// (point, level): lane q of quad t takes features q, q + 4, ... of level
// t / n, point t % n (ops/fused_mlp.py grid_scatter_item), so a warp holds 8
// consecutive points of one level, which are mostly samples along one ray,
// and each of its reds of a corner and feature group covers one 32-byte
// sector a point (F = 8). The cell once a lane, then for each corner and
// feature the term w(corner) * denc_grid in f32, scaled by 2^k exactly (in
// double) and rounded to an integer (grid_scale_exp: the same terms as the
// first design's thread a term). Terms that a warp's runs of consecutive
// points add to one table element (the same cell) are summed by a
// segmented suffix sum over the run (shuffles by 4, 8 and 16 lanes, 64-bit
// integers, exact), and the run's first point issues one 64-bit red;
// integer sums in any order give the same bits. Where no two neighbouring
// points share a row the terms go out one red each.
constexpr int kScatterLanes = 4;

__global__ void __launch_bounds__(256) grid_scatter_kernel(BwdParams p, int e_n) {
  const GridParams& g = p.grid;
  const int F = g.features, n_grid = g.n_levels * F;
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31, fq = lane & (kScatterLanes - 1);
  const long long items = static_cast<long long>(p.n) * g.n_levels;
  if ((t - lane) / kScatterLanes >= items) return;   // whole warps past the end
  const long long item = t / kScatterLanes;
  bool valid = item < items;
  const int level = valid ? static_cast<int>(item / p.n) : 0;
  const int pt = valid ? static_cast<int>(item - static_cast<long long>(level) * p.n) : 0;
  const float m = __uint_as_float(p.gmax[level]);
  valid = valid && m > 0.f && m <= 3.402823466e38f;   // all zero, or not finite: nothing
  const GridLevel lv = grid_level(g, level);
  const int G = static_cast<int>(lv.size);
  int lo[3];
  float fr[3];
  grid_cell(p.pts + static_cast<size_t>(pt) * p.d_in, G, g.bound, lo, fr);
  float w[8];
  long long key[8];   // each corner's table row, as an element of the sums
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    int row;
    w[c] = grid_corner(lo, fr, G, c, row);
    key[c] = valid ? lv.offset + static_cast<long long>(row) * F : -1;
  }
  const double scale = valid ? ldexp(1.0, grid_scale_exp(m, e_n)) : 0.0;
  const float* d = p.dgrid + static_cast<size_t>(pt) * n_grid + level * F;
  // this lane's residue class (lanes fq, fq + 4, ...) past it
  const unsigned later = (0x11111111u << fq) & ~((2u << lane) - 1u);
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    // the runs of points with this corner's row: heads, and each lane's
    // end (the lane before the next head of its class)
    const long long prev = __shfl_up_sync(0xffffffffu, key[c], kScatterLanes);
    const bool head = lane < kScatterLanes || prev != key[c];
    const unsigned heads = __ballot_sync(0xffffffffu, head);
    const unsigned after = heads & later;
    const int end = after ? __ffs(after) - 1 - kScatterLanes : 32 - kScatterLanes + fq;
    const bool merge = SUNERF_ABLATION != 10 && heads != 0xFFFFFFFFu;
    for (int f0 = 0; f0 < F; f0 += kScatterLanes) {
      const int f = f0 + fq;
      long long q = 0;
      if (valid && f < F)
        q = __double2ll_rn(static_cast<double>(__fmul_rn(w[c], __ldg(d + f))) * scale);
      if (merge) {
#pragma unroll
        for (int off = kScatterLanes; off < 32; off <<= 1) {
          const long long o = __shfl_down_sync(0xffffffffu, q, off);
          if (lane + off <= end) q += o;
        }
        if (!head) continue;
      }
      if (q != 0)
        atomicAdd(p.gacc + key[c] + f, static_cast<unsigned long long>(q));
    }
  }
}

// d_table = the fixed-point sums times 2^-k, in f32; NaN for a level whose
// cotangent was not finite, 0 for one that was all zero.
__global__ void grid_convert_kernel(BwdParams p, int e_n) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= p.grid.total) return;
  const int level = grid_level_of(p.grid, t);
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

// 'i8pair': dz_max[g][j-1] = the max over group g's rows (points [g G,
// (g+1) G) below n) of the chain kernel's row maxima of dz_j (two a point),
// j = 1..L-1, compared as bits (non-negative floats order as their bits): a
// warp a group, 8 groups a block.
__global__ void dz_group_max_kernel(BwdParams p, int n_groups) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = blockIdx.x * 8 + warp;
  const int j = blockIdx.y + 1;
  if (g >= n_groups) return;
  const unsigned int* rows =
      reinterpret_cast<const unsigned int*>(p.dz_rowmax) + static_cast<size_t>(j - 1) * 2 * p.n;
  const int end = 2 * min(p.n, (g + 1) * p.group);
  unsigned int m = 0u;
  for (int r = 2 * g * p.group + lane; r < end; r += 32) m = max(m, rows[r]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = max(m, __shfl_xor_sync(0xffffffffu, m, off));
  if (lane == 0) p.dz_max[static_cast<size_t>(g) * p.n_hidden + j - 1] = __uint_as_float(m);
}

// The int8 operands of dw_i8_wgmma_kernel, both K-major (8-bit wgmma takes
// no transpose) with the chunk's 64 points as K, in the no-swizzle layout:
// core matrices of 8 rows x 16 k (16 bytes), element (row, k) at
// ((k / 16) (rows / 8) + row / 8) 128 + (row % 8) 16 + k % 16. K runs over
// the points in the order k = 16 kg + 8 h + j <-> point 8 j + 2 kg + h (the
// sum over k does not care, as long as A and B agree): a thread with the
// points 8 j + q (q = l / 4, j = 0..7) then writes 8 contiguous bytes of a
// core-matrix row (kg = q / 2, h = q % 2), and its loads, q's 8 rows of the
// tiles at the same columns, are immediate offsets that the 8 q of a warp
// spread over 32 banks. ops/fused_mlp.py i8_build_operands mirrors it.
__device__ __forceinline__ int i8_offset(int rows, int row, int q) {
  return ((q >> 1) * (rows / 8) + row / 8) * 128 + (row % 8) * 16 + 8 * (q & 1);
}

// Bytes e of four words, in order (e may differ from lane to lane)
__device__ __forceinline__ uint32_t gather_bytes(uint32_t w0, uint32_t w1, uint32_t w2,
                                                 uint32_t w3, int e) {
  const int sel = e | ((e + 4) << 4);
  return __byte_perm(__byte_perm(w0, w1, sel), __byte_perm(w2, w3, sel), 0x5410);
}

// A = sin8_{j-1}^T [128 rows m][64 points] from the stash box [64 points]
// [128 bytes m] (TMA, 128-byte swizzled): thread t (warp w, lane l) the
// columns m = 16 w + 4 (l % 4) + e, e = 0..3, of the points 8 j + l / 4
// (one 32-bit load a point, a byte transpose); the row order rotated by
// 2 kg + (l % 4) / 2 so a half warp's 8-byte stores cover 16 slots.
__device__ __forceinline__ void build_a8(const unsigned char* box, unsigned char* a8) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q = lane >> 2, c3 = lane & 3;
  const unsigned char* src = box + q * 128 + ((warp ^ q) << 4) + 4 * c3;
  uint32_t w[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) w[j] = *reinterpret_cast<const uint32_t*>(src + 1024 * j);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int er = (e + 2 * (q >> 1) + (c3 >> 1)) & 3;
    *reinterpret_cast<uint2*>(a8 + i8_offset(kI8TM, 16 * warp + 4 * c3 + er, q)) =
        make_uint2(gather_bytes(w[0], w[1], w[2], w[3], er),
                   gather_bytes(w[4], w[5], w[6], w[7], er));
  }
}

// B = dz8_j [TN rows n][64 points] of a group segment: round_half_even(dz
// scale) for the chunk's points [s0, s1), 0 for its others, from the dz
// tile's TN columns (bf16 in the chain's core-matrix order, (pt, n) at
// ((n / 8) 8 + pt / 8) 64 + (pt % 8) 8 + n % 8): thread t the columns
// n = 8 ng + 2 (l % 4) and n + 1 of the points 8 j + l / 4, for
// ng = (TN / 64) w .. + TN / 64 - 1 (one 32-bit load a point); odd kg store
// column n + 1 first. The product is rounded to f32, then to an integer by
// adding 1.5 2^23 (round half to even, the integer in the low bits: its low
// byte is the int8).
template <int TN>
__device__ __forceinline__ void build_b8(const unsigned char* tile, unsigned char* b8, int s0,
                                         int s1, float scale) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q = lane >> 2, cp = lane & 3, kg = q >> 1;
  constexpr float kRound = 12582912.0f;
  float sc[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) sc[j] = (8 * j + q >= s0 && 8 * j + q < s1) ? scale : 0.0f;
#pragma unroll
  for (int u = 0; u < TN / 64; ++u) {
    const int ng = (TN / 64) * warp + u;
    const int n = 8 * ng + 2 * cp;
    const unsigned char* src = tile + ng * 1024 + q * 16 + 4 * cp;
    uint32_t lo[8], hi[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint32_t x = *reinterpret_cast<const uint32_t*>(src + 128 * j);
      lo[j] = __float_as_uint(__fadd_rn(__fmul_rn(__uint_as_float(x << 16), sc[j]), kRound));
      hi[j] = __float_as_uint(__fadd_rn(__fmul_rn(__uint_as_float(x & 0xFFFF0000u), sc[j]),
                                        kRound));
    }
    const uint2 vlo = make_uint2(gather_bytes(lo[0], lo[1], lo[2], lo[3], 0),
                                 gather_bytes(lo[4], lo[5], lo[6], lo[7], 0));
    const uint2 vhi = make_uint2(gather_bytes(hi[0], hi[1], hi[2], hi[3], 0),
                                 gather_bytes(hi[4], hi[5], hi[6], hi[7], 0));
    *reinterpret_cast<uint2*>(b8 + i8_offset(TN, n + (kg & 1), q)) = (kg & 1) ? vhi : vlo;
    *reinterpret_cast<uint2*>(b8 + i8_offset(TN, n + 1 - (kg & 1), q)) = (kg & 1) ? vlo : vhi;
  }
}

__host__ __device__ inline int i8_tn(int H) { return H % 128 == 0 ? 128 : 64; }

// 'i8pair' dW_h on the int8 tensor cores (the i8pair branch of
// _bwd_stash_kernel, _mm_i8): per group g of G points (any G >= 1 with
// G 127^2 < 2^31, so the int32 sums cannot overflow), with m = dz_max[g]
// [j-1], scale = 127 / m (0 when m = 0), dz8 = round_half_even(dz_j scale),
//   part_i8[split][j-1] += f32(sum over g's points of sin8_{j-1} (x) dz8)
//                          * (m * f32((1/127)^2))
// with the groups of a split (pps8 points, whole groups and whole 64-point
// tiles) in order. Work items (split, layer j, 128-row tile of m, TN-column
// tile of n), walked by persistent blocks of two warpgroups and no
// producer warp (a 168-register cap comes with a ninth warp; the two int32
// and f32 accumulator sets take 128): thread 0 keeps a ring of 64-point
// chunks S ahead, each the stash box [64 points][128 bytes of sin8_{j-1}]
// (TMA, 128-byte swizzled) and the dz tile's TN columns (one bulk copy),
// refilling a stage as soon as the block is past its last read. Both
// warpgroups transpose each chunk into K-major int8 operands (build_a8,
// and build_b8 with dz quantized: once a chunk for both warpgroups' rows),
// meet at one barrier, and run wgmma m64nTNk32 s32.s8.s8 twice, each
// warpgroup its 64 rows, the next chunk's transposes under them: exact
// int32 sums, scaled into the f32 sums in registers when a group ends. A
// chunk that crosses a group boundary (G = 8, 16, 24, ...) is taken one
// segment at a time, its other points' dz8 zero. Three operand buffers: a
// warpgroup waits for its products of the segment before last before the
// barrier, so the buffer rewritten after it is no longer read by either.
template <int TN>
__global__ void __launch_bounds__(kConsumers, 1) dw_i8_wgmma_kernel(const __grid_constant__ BwdParams p) {
  constexpr int kARaw = kRows * kI8TM;
  constexpr int kBRaw = kRows * TN * 2;
  constexpr int kStage = kARaw + kBRaw;
  constexpr int kA8 = kI8TM * kRows;
  constexpr int kOps = kA8 + TN * kRows;
  extern __shared__ __align__(1024) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  unsigned char* ops = smem + kDwBar;
  unsigned char* stages = ops + kI8Bufs * kOps;
  const int S = p.stages;
  const int H = p.h, L = p.n_hidden + 1;
  const int mts = (H + kI8TM - 1) / kI8TM, nts = H / TN;
  const int per_split = (L - 1) * mts * nts;
  const int items = p.splits8 * per_split;
  auto item = [&](int it, int& split, int& j, int& mtile, int& ntile) {
    split = it / per_split;
    int r = it - split * per_split;
    j = 1 + r / (mts * nts);
    r -= (j - 1) * mts * nts;
    mtile = r / nts;
    ntile = r - mtile * nts;
  };

  // thread 0's loader: the block's chunks in the order they are read
  int ld_it = blockIdx.x, ld_c = ld_it < items ? (ld_it / per_split) * p.pps8 : 0, ld_st = 0;
  const uint64_t shared = hp::evict_normal_policy();
  auto load_next = [&]() {
    if (ld_it >= items) return;
    int split, j, mtile, ntile;
    item(ld_it, split, j, mtile, ntile);
    unsigned char* sa = stages + ld_st * kStage;
    hp::mbar_expect_tx(&full[ld_st], kStage);
    // evict-normal: each chunk of A is read by H / TN work items and each
    // of B by H / 128, running side by side, through L2
    hp::tensor_load_2d(sa, &p.hs8_map, (j - 1) * 2 * H + mtile * kI8TM, ld_c, &full[ld_st],
                       shared);
    hp::bulk_load(sa + kARaw,
                  p.dz + (static_cast<size_t>(ld_c / kRows) * L + j) * kRows * H
                      + static_cast<size_t>(ntile) * TN * kRows,
                  kBRaw, &full[ld_st], shared);
    if (++ld_st == S) ld_st = 0;
    ld_c += kRows;
    if (ld_c >= min(p.n, (split + 1) * p.pps8)) {
      ld_it += gridDim.x;
      ld_c = ld_it < items ? (ld_it / per_split) * p.pps8 : 0;
    }
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) hp::mbar_init(&full[s], 1);
    hp::fence_barrier_init();
    for (int s = 0; s < S; ++s) load_next();
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wg = warp >> 2, w4 = warp & 3, g = lane >> 2, q = lane & 3;
  const float inv_sq = static_cast<float>((1.0 / 127.0) * (1.0 / 127.0));
  const uint32_t ops0 = hp::smem_u32(ops);
  int stage = 0, phase = 0, buf = 0;
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    int split, j, mtile, ntile;
    item(it, split, j, mtile, ntile);
    const int p0 = split * p.pps8, p1 = min(p.n, p0 + p.pps8);
    int acc_i[TN / 2];
    float acc_f[TN / 2];
#pragma unroll
    for (int e = 0; e < TN / 2; ++e) {
      acc_i[e] = 0;
      acc_f[e] = 0.f;
    }
    int have = -1;                        // the chunk in the stage being read
    const unsigned char* sa = stages;
    for (int g0 = p0; g0 < p1;) {
      const int grp = g0 / p.group;
      const int g1 = min(p1, (grp + 1) * p.group);
      const float m = p.dz_max[static_cast<size_t>(grp) * p.n_hidden + j - 1];
      const float scale = m > 0.f ? __fdiv_rn(kCosScale, m) : 0.f;
      for (int s0 = g0; s0 < g1;) {
        const int c = s0 & ~(kRows - 1);
        if (c != have) {
          hp::mbar_wait(&full[stage], phase);
          sa = stages + stage * kStage;
          if (++stage == S) {
            stage = 0;
            phase ^= 1;
          }
          have = c;
        }
        const int c_end = min(c + kRows, p1);
        const int s1 = min(g1, c_end);
        unsigned char* op = ops + buf * kOps;
        if (SUNERF_ABLATION != 3) {
          build_a8(sa, op);
          build_b8<TN>(sa + kARaw, op + kA8, s0 - c, s1 - c, scale);
        }
        hp::fence_async_smem();
        hp::named_sync(1, kConsumers);
        // the block is past its reads of the chunk: refill its stage
        if (s1 == c_end && threadIdx.x == 0) load_next();
        const uint32_t a8 = ops0 + buf * kOps, b8 = a8 + kA8;
        hp::wgmma_fence();
#pragma unroll
        for (int s = 0; s < 2; ++s)
          if (SUNERF_ABLATION != 4)
            hp::wgmma_s8(acc_i,
                         hp::make_desc(a8 + wg * (64 / 8) * 128 + 2 * s * (kI8TM / 8) * 128,
                                       (kI8TM / 8) * 128, 128),
                         hp::make_desc(b8 + 2 * s * (TN / 8) * 128, (TN / 8) * 128, 128),
                         s0 > g0 || s > 0);
        hp::wgmma_commit();
        if (++buf == kI8Bufs) buf = 0;
        hp::wgmma_wait<1>();
        s0 = s1;
      }
      // the group ends: its exact int32 sum, scaled, into the f32 sum
      hp::wgmma_wait<0>();
      hp::fence_regs(acc_i);
      const float sc = __fmul_rn(m, inv_sq);
#pragma unroll
      for (int e = 0; e < TN / 2; ++e)
        acc_f[e] = __fadd_rn(acc_f[e], __fmul_rn(__int2float_rn(acc_i[e]), sc));
      g0 = g1;
    }
    float* out = p.part_i8 + (static_cast<size_t>(split) * (L - 1) + j - 1) * H * H;
#pragma unroll
    for (int jj = 0; jj < TN / 8; ++jj) {
      const int col = ntile * TN + 8 * jj + 2 * q;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = mtile * kI8TM + wg * 64 + w4 * 16 + g + 8 * r;
        if (row < H)   // H = 64: the tile's other 64 rows are the cos half
          *reinterpret_cast<float2*>(out + static_cast<size_t>(row) * H + col) =
              make_float2(acc_f[4 * jj + 2 * r], acc_f[4 * jj + 2 * r + 1]);
      }
    }
  }
}

// The chain kernel's 'lsb' gate decode (lsb_cos_table, with the table built
// by the block) on n packed sines: out[i] = the bf16 bits of the gate of
// in[i]. Checked against ops/fused_mlp.py's plain decode on every pattern.
__global__ void __launch_bounds__(kConsumers) lsb_decode_kernel(const uint16_t* in, uint16_t* out,
                                                                 int n) {
  __shared__ uint16_t table[kLsbTable];
  build_lsb_table(table);
  __syncthreads();
  const int i = blockIdx.x * kConsumers + threadIdx.x;
  if (i < n) out[i] = static_cast<uint16_t>(lsb_cos_table(table, in[i]));
}

// out[e] = sum over s < S of part[s][e], in a fixed order: 8 interleaved
// sequential sums per element, then those 8 in order.
__global__ void reduce_kernel(const float* part, int S, size_t P, float* out) {
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
    out[e] = total;
  }
}

cudaError_t launch_reduce(const float* part, int S, size_t P, float* out, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((P + 31) / 32));
  reduce_kernel<<<grid, dim3(32, 8), 0, stream>>>(part, S, P, out);
  return cudaGetLastError();
}

// Raises `kernel`'s shared memory limit to the card's and returns how many
// blocks of `threads` fit on the card at once, once per kernel (so no
// attribute or occupancy call in a graph capture).
template <typename K>
cudaError_t persistent_blocks(K kernel, int& max_blocks, int threads = kThreads) {
  if (max_blocks > 0) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kSmemLimit));
  int device = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, kSmemLimit);
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
  // a stage holds a weight chunk [32 x H] bf16, H / CW of K3's [32 x CW],
  // an int8 gate tile [64, H] or half a 16-bit one [32, H]; a 16-bit gate is
  // taken while two chunks are in flight (4 stages)
  p.stage_bytes = kKC * H * 2;
  // K5's level maxima in the head, or, past 128 levels, after the ring
  const size_t grid_max = p.grid.n_levels > kHeadLevels ? (p.grid.n_levels * 4 + 15) / 16 * 16 : 0;
  const size_t fixed = kChainHead + static_cast<size_t>(kRows) * H * 2 + grid_max;
  p.stages = static_cast<int>((kSmemLimit - fixed) / p.stage_bytes);
  if (p.stages > kMaxStages) p.stages = kMaxStages;
  // K3 takes a chunk's CW / 32 stages at once
  if (p.stages < (kGate == kGateBf16 || kGate == kGateLsb ? 4 : 3) ||
      (kDpts && p.stages < (H < 128 ? H : 128) / 32))
    return cudaErrorInvalidConfiguration;
  const int tiles = (p.n + kRows - 1) / kRows;
  if (p.grid.n_levels > 0)
    prep_grid_kernel<<<tiles, kConsumers, 0, stream>>>(p);
  else
    prep_kernel<<<tiles, kConsumers, 0, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  p.gmax_at = grid_max > 0 ? static_cast<int>(fixed - grid_max) + p.stages * p.stage_bytes
                           : kGridMaxAt;
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

template <int TN>
cudaError_t launch_dw_i8_tn(BwdParams p, cudaStream_t stream) {
  static int max_blocks = 0;
  cudaError_t err = persistent_blocks(dw_i8_wgmma_kernel<TN>, max_blocks, kConsumers);
  if (err != cudaSuccess) return err;
  const int ops = kI8Bufs * (kI8TM * kRows + TN * kRows);
  const int stage = kRows * kI8TM + kRows * TN * 2;
  p.stages = static_cast<int>((kSmemLimit - kDwBar - ops) / stage);
  if (p.stages > kMaxStages) p.stages = kMaxStages;
  const int L = p.n_hidden + 1;
  const int items = p.splits8 * (L - 1) * ((p.h + kI8TM - 1) / kI8TM) * (p.h / TN);
  dw_i8_wgmma_kernel<TN><<<items < max_blocks ? items : max_blocks, kConsumers,
                           kDwBar + ops + static_cast<size_t>(p.stages) * stage, stream>>>(p);
  return cudaGetLastError();
}

// The tensor maps of one backward launch over p.n points: the gates (an
// int8 gate [64 rows][128 columns] boxes, 'i8pair' rows starting H into the
// pairs; a 16-bit gate, bf16 or 'lsb', [32 rows][64 columns]; none for
// 'i8pair''s dW_h A, the pairs [64 points][128 bytes]), the encoding
// scratch and the bf16 sin stash (if any) as the dW kernel's A.
inline cudaError_t set_maps(BwdParams& p, bool int8_gate) {
  const int L = p.n_hidden + 1, H = p.h;
  cudaError_t err;
  if (int8_gate) {
    const uint64_t cols = p.hs8 != nullptr ? p.gate_ld - H : p.gate_ld;
    err = hp::encode_2d(&p.gate_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, p.gate, cols, p.n, p.gate_ld,
                        H < kGateBox ? H : kGateBox, kBox, H >= kGateBox);
  } else {
    err = hp::encode_2d(&p.gate_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, p.gate, p.gate_ld, p.n,
                        p.gate_ld * 2, 64, kRows / 2, true);
  }
  if (err == cudaSuccess && p.hs8 != nullptr)
    err = hp::encode_2d(&p.hs8_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, p.hs8, p.gate_ld, p.n,
                        p.gate_ld, kI8TM, kRows, true);
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
         (p.dpts == nullptr ||
          (p.w_dpts != nullptr && p.dpts_pairs != nullptr && p.dpts_gdim != nullptr &&
           p.dpts_cols > 0 && p.dpts_cols % (p.h < 128 ? p.h : 128) == 0));
}

// The per-tile partials over `n_tiles` tile slots and the per-split dW
// partials reduced into the gradients.
inline cudaError_t launch_reductions(const BwdParams& p, int n_tiles, cudaStream_t s) {
  const cudaError_t err = launch_reduce(p.part_chain, n_tiles, p.q, p.grad_chain, s);
  if (err != cudaSuccess) return err;
  return launch_reduce(p.part_dw, p.splits, p.dw_ld, p.grad_dw, s);
}

// The launches after the chain kernel of a stashing backward (see the top
// of this file): K5's scatter and conversion, the i8pair maxima, the dW
// products and the reductions.
inline cudaError_t launch_after_chain(const BwdParams& p, cudaStream_t s) {
  cudaError_t err;
  const int n = p.n;
  const int L = p.n_hidden + 1;
  if (p.grid.n_levels > 0) {
    int e_n = 0;
    while ((1LL << e_n) < n) ++e_n;
    const long long lanes = static_cast<long long>(n) * p.grid.n_levels * kScatterLanes;
    grid_scatter_kernel<<<static_cast<unsigned>((lanes + 255) / 256), 256, 0, s>>>(p, e_n);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    grid_convert_kernel<<<static_cast<unsigned>((p.grid.total + 255) / 256), 256, 0, s>>>(p, e_n);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }

  if (p.hs8 != nullptr) {
    // 'i8pair': each group's scale from the chain's row maxima, dW_in on
    // wgmma, then the hidden layers' dW on the int8 cores over ranges of
    // whole groups
    const int n_groups = (n + p.group - 1) / p.group;
    if (L > 1) {
      dz_group_max_kernel<<<dim3((n_groups + 7) / 8, L - 1), 256, 0, s>>>(p, n_groups);
      err = cudaGetLastError();
      if (err != cudaSuccess) return err;
    }
    err = launch_dw(p, 1, s);
    if (err != cudaSuccess) return err;
    if (L > 1) {
      err = i8_tn(p.h) == 128 ? launch_dw_i8_tn<128>(p, s) : launch_dw_i8_tn<64>(p, s);
      if (err != cudaSuccess) return err;
      err = launch_reduce(p.part_i8, p.splits8, p.p - p.dw_ld, p.grad_dw + p.dw_ld, s);
      if (err != cudaSuccess) return err;
    }
  } else {
    err = launch_dw(p, L, s);
    if (err != cudaSuccess) return err;
  }

  return launch_reductions(p, (n + kRows - 1) / kRows, s);
}

}  // namespace
}  // namespace sunerf
