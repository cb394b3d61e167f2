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
// (wide_wgmma_kernel), the activations going through device memory:
//   C[M, N] = epilogue(sum over k of A[m, k] B[k, n])
// A block of three warpgroups takes 128 x TN output tiles of a persistent
// walk (one block an SM): one producer thread issues 2-D TMA boxes in the
// 128-byte swizzle into a ring of 4 to 8 stages of 64 k each (full and
// empty mbarriers a stage), and two consumer warpgroups (their registers
// raised by setmaxnreg, the producer's lowered) run wgmma m64nTNk16 (bf16
// in, f32 accumulate) from shared memory, 64 rows each. TN is 128 or 256
// for the layers and the chain (whichever pads N less), the smallest of 8,
// 16, 32, 64 that holds N for the head and denc (tile_n). Both operands are
// K-major (a row of k contiguous: the forward's activations x W^T, the
// chain's dz x W) or both MN-major (a row of m or n contiguous, taken with
// wgmma's transpose bits: the dW products over the points, stash^T x dz).
// TMA zero-fills past an operand's extents; every row stride is a multiple
// of 16 bytes (the wrapper pads the width to a multiple of 16, e_pad to 16,
// o_pad to 8). The epilogue is a functor on each accumulator pair (row,
// col, col + 1), the pairs wgmma's accumulator gives a thread:
//   FwdEpi<kFmt>   y = reduce_2pi(acc + b); the bf16 sin to the next
//                  layer's input, and the stash of the format ('int8' the
//                  int8 cos8, 'lsb' the packed sin, K4 the bf16 cos10);
//   HeadEpi        out = acc + b_out, f32, any d_output;
//   ChainEpi<kFmt> dz = bf16(bf16(acc) * gate), the gate decoded from the
//                  stash of the layer, and dz's column sums (the bias
//                  gradient's first step);
//   StoreEpi       f32 outputs (dW, denc).
// The epilogue does not overlap the products (the consumers hold the
// accumulators), so it is made cheap where it is heavy. FwdEpi and
// ChainEpi, which write 2 or 3 bytes an output, are staged: a warpgroup
// puts a chunk of 64 rows x 32 columns into shared memory and copies it out
// in 16- or 8-byte pieces that fill whole sectors (pair stores straight
// from the accumulators wrote a layer's bf16 at ~1 TB/s); the parameters
// they read come from shared memory, FwdEpi's bias copied there under the
// products and the chain's gate loaded by the producer through the ring
// after the tile's k stages (GateRing), since a load from device memory in
// the epilogue waits behind the chunk's stores. A dW product splits the points into ranges
// (dw_plan: about one tile a block over the card); each (tile, range)
// writes its f32 partial, and the tile's last block to arrive (a counter a
// tile, reset by that block) sums the partials in range order into the
// epilogue, so there is no second pass, no float atomics, and a run gives
// the bits of the last. The bias gradients sum the chain's column sums in
// a fixed order (colsum_kernel). (scripts/probe_wide_gemm.py on an H100
// 80GB HBM3 at 700 W, 8x1024 at N = 196,608: the eight dW_h products in
// point ranges take 5.48 ms, one launch over all layers' tiles, which would
// keep every layer's dz, 3.2 GB, 5.34 ms.)
//
// Bound on this card: operations, 2 N H (E + (L-1) H + O) flop for the
// forward (3.65 TFLOP at 8x1024, N = 245,760: 3.69 ms at 989 TFLOP/s bf16
// dense); a layer a launch also moves each layer's bf16 activations through
// device memory (written once, read once: 0.8 GB a layer at that N, about
// 0.25 ms at 3.35 TB/s), which the stashing forwards write anyway. The
// design's own floor (scripts/probe_wide_gemm.py, H100 80GB HBM3, 700 W):
// the mainloop reaches ~635 TFLOP/s (a layer of 8x1024 at N = 196,608 in
// 0.65 ms with no epilogue, one bf16 torch.matmul 0.56 ms), and the
// epilogues add 0.2-0.4 ms a layer that no product hides.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "fused_mlp_common.cuh"
#include "hopper.cuh"

namespace sunerf {
namespace wide {

namespace hp = sunerf::hopper;

constexpr int kBM = 128;         // output rows a tile (two consumer warpgroups of 64)
constexpr int kBK = 64;          // k a stage: one 128-byte swizzled row of bf16
constexpr int kConsumers = 256, kThreads = 384;
constexpr int kMaxStages = 8;
constexpr int kRingBytes = 196608;   // the ring's shared memory at most
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
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

// A product as the launchers state it
struct Gemm {
  Operand a, b;
  int m, n;           // the outputs (rows, columns) the epilogue sees
  int m_load, n_load; // the operands' extents along m and n (zero past them)
  int k;              // the contraction's extent
};

// The kernel's parameters: the operands' tensor maps and the walk
struct GemmParams {
  CUtensorMap a, b;
  int m, n, k;
  int k_split;        // k a split, a multiple of kBK
  int splits, tiles_m, tiles_n;
  float* part;        // splits > 1: the partials [splits][m][n]
  unsigned int* count; // splits > 1: the arrivals a tile, zero between launches
  CUtensorMap gate;   // ChainEpi: the stash the gate is read from (GateRing)
  int gate_x;         // its column of the layer's first gate
};

// The N tile of a product with n outputs (ops/wide_mlp.py tile_n): from
// min_tn (the layers and the chain 128; MN-major B 64, its boxes' width;
// else 8), the smallest of 8, 16, .. 128 that holds n, and above 128 columns
// 256 unless 128 pads n less.
__host__ __device__ inline int tile_n(int n, int min_tn) {
  if (n > 128) {
    const int pad256 = (n + 255) / 256 * 256 - n, pad128 = (n + 127) / 128 * 128 - n;
    return pad256 <= pad128 ? 256 : 128;
  }
  int tn = 8;
  while (tn < n || tn < min_tn) tn *= 2;
  return tn;
}

// The split of a dW product's points (ops/wide_mlp.py dw_plan): as many
// ranges as keep every block of the card on one tile, at least 1024 points a
// range, at most kMaxSplits; k_split a multiple of kBK.
inline void dw_plan(int m, int n_out, int tn, int points, int sms, int& splits, int& k_split) {
  const int tiles = ((m + kBM - 1) / kBM) * ((n_out + tn - 1) / tn);
  const int want = max(1, min(sms / tiles, min(kMaxSplits, (points + 1023) / 1024)));
  k_split = ((points + want - 1) / want + kBK - 1) / kBK * kBK;
  splits = (points + k_split - 1) / k_split;
}

// A tile's shared memory: A [128 x 64] and B [TN x 64] (K-major) or
// [64 x 128] and [64 x TN] (MN-major, boxes of 64 columns), 128-byte rows in
// the 128-byte swizzle; as many stages as kRingBytes holds, up to kMaxStages.
template <int TN>
struct Ring {
  static constexpr int kABytes = kBM * kBK * 2;
  static constexpr int kBBytes = TN * kBK * 2;
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kStages =
      kRingBytes / kStageBytes < kMaxStages ? kRingBytes / kStageBytes : kMaxStages;
  static constexpr size_t kSmem = static_cast<size_t>(kStages) * kStageBytes + 1024;
};

// A staged epilogue (FwdEpi, ChainEpi) writes its outputs a chunk of 64 rows
// x kChunk columns at a time into shared memory, a region a consumer
// warpgroup (x: 16-bit values, kPitch16 bytes a row; y, FwdEpi's stash:
// 16-bit values, or int8 ones kPitch8 bytes a row, two such halves kHalf8
// apart; z: FwdEpi's bias or the chain's column sums), then copies
// the chunk out in 8-column pieces (flush_chunk: 16 bytes of bf16 or 8 of
// int8, each row's pieces side by side), so that the stores fill whole
// sectors; the pitches keep a warp's pair writes on distinct banks.
constexpr int kChunk = 32;
constexpr int kPitch16 = 2 * kChunk + 16, kPitch8 = kChunk + 16;
constexpr int kHalf8 = 64 * kPitch8;
constexpr int kEpiX = 64 * kPitch16;
constexpr int kEpiZ = kEpiX + 2 * kHalf8;   // the tile's f32 bias (z), 256 at most
constexpr int kEpiBytes = kEpiZ + 256 * 4;
static_assert(64 * kPitch16 <= 2 * kHalf8, "a 16-bit y region fits");

// rows < rows of a staged chunk at s (pitch bytes a row) to dst (element
// (0, 0) of the chunk, ld elements a row), its 8-column pieces below cols,
// two pieces a thread t of the warpgroup
template <int kBytes, class T>
__device__ __forceinline__ void flush_chunk(const unsigned char* s, int pitch, T* dst,
                                            long long ld, int rows, int cols, int t) {
  static_assert(sizeof(T) == kBytes, "element size");
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int i = t + 128 * k, r = i >> 2, piece = i & 3;
    if (r < rows && 8 * piece < cols) {
      T* d = dst + static_cast<size_t>(r) * ld + 8 * piece;
      if constexpr (kBytes == 2)
        *reinterpret_cast<int4*>(d) = *reinterpret_cast<const int4*>(s + r * pitch + 16 * piece);
      else
        *reinterpret_cast<int2*>(d) = *reinterpret_cast<const int2*>(s + r * pitch + 8 * piece);
    }
  }
}

__device__ __forceinline__ void release(uint64_t* empty, int lane) {
  __syncwarp();
  if (lane == 0) hp::mbar_arrive(empty);
}

// The persistent walk's work item `it`: (split, m tile, n tile), the n tiles
// of one m tile side by side (its A rows read once from device memory).
__device__ __forceinline__ void gemm_item(const GemmParams& g, int it, int& split, int& mt,
                                          int& nt) {
  const int tiles = g.tiles_m * g.tiles_n;
  split = it / tiles;
  const int r = it - split * tiles;
  mt = r / g.tiles_n;
  nt = r - mt * g.tiles_n;
}

// The gate of a chain tile (ChainEpi) comes through the ring: after a tile's
// k stages the producer loads its gate as TMA boxes of [64 rows][128 bytes]
// in the 128-byte swizzle, a warpgroup's rows side by side, into one ring
// stage or, where the two warpgroups' do not fit in one, a stage each.
template <int TN, class Epi>
struct GateRing {
  static constexpr int kElem = Epi::kGateBytes;
  static constexpr int kBoxes = TN * kElem / 128;   // a warpgroup's boxes
  static constexpr int kWgBytes = kBoxes * 8192;
  static constexpr int kStages = 2 * kWgBytes <= Ring<TN>::kStageBytes ? 1 : 2;
  static_assert(kBoxes >= 1 && kWgBytes <= Ring<TN>::kStageBytes, "a warpgroup's gate fits a stage");
};

template <bool kKMajor, int TN, class Epi>
__global__ void __launch_bounds__(kThreads, 1) wide_wgmma_kernel(const __grid_constant__ GemmParams g,
                                                                 const Epi epi) {
  using R = Ring<TN>;
  static_assert(kKMajor || TN >= 64, "MN-major B is taken in boxes of 64 columns");
  static_assert(!Epi::kStaged || TN <= 256, "z holds 256 columns");
  extern __shared__ unsigned char smem_raw[];
  __shared__ uint64_t full[kMaxStages], empty[kMaxStages];
  __shared__ int last;
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, wg = warp >> 2;
  const int items = g.splits * g.tiles_m * g.tiles_n;
  if (threadIdx.x == 0) {
    for (int s = 0; s < R::kStages; ++s) {
      hp::mbar_init(&full[s], 1);
      hp::mbar_init(&empty[s], kConsumers / 32);
    }
    hp::fence_barrier_init();
  }
  __syncthreads();
  auto advance = [](int& stage, int& phase) {
    if (++stage == R::kStages) {
      stage = 0;
      phase ^= 1;
    }
  };

  if (wg == 0) {
    hp::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x != 0) return;
    // evict-normal: an A box is read by the tiles_n blocks of its m tile,
    // a B box by every block; a gate box once
    const uint64_t policy = hp::evict_normal_policy(), once = hp::evict_first_policy();
    int stage = 0, phase = 0;
    for (int it = blockIdx.x; it < items; it += gridDim.x) {
      int split, mt, nt;
      gemm_item(g, it, split, mt, nt);
      const int kb = split * g.k_split, ke = min(g.k, kb + g.k_split);
      for (int k = kb; k < ke; k += kBK) {
        hp::mbar_wait(&empty[stage], phase ^ 1);
        unsigned char* sa = smem + stage * R::kStageBytes;
        unsigned char* sb = sa + R::kABytes;
        hp::mbar_expect_tx(&full[stage], R::kStageBytes);
        if constexpr (kKMajor) {
          hp::tensor_load_2d(sa, &g.a, k, mt * kBM, &full[stage], policy);
          hp::tensor_load_2d(sb, &g.b, k, nt * TN, &full[stage], policy);
        } else {
#pragma unroll
          for (int j = 0; j < kBM / 64; ++j)
            hp::tensor_load_2d(sa + j * 8192, &g.a, mt * kBM + 64 * j, k, &full[stage], policy);
#pragma unroll
          for (int j = 0; j < TN / 64; ++j)
            hp::tensor_load_2d(sb + j * 8192, &g.b, nt * TN + 64 * j, k, &full[stage], policy);
        }
        advance(stage, phase);
      }
      if constexpr (Epi::kGate) {
        using G = GateRing<TN, Epi>;
#pragma unroll
        for (int gs = 0; gs < G::kStages; ++gs) {
          hp::mbar_wait(&empty[stage], phase ^ 1);
          unsigned char* sg = smem + stage * R::kStageBytes;
          constexpr int kWgs = G::kStages == 1 ? 2 : 1;
          hp::mbar_expect_tx(&full[stage], kWgs * G::kWgBytes);
#pragma unroll
          for (int w = 0; w < kWgs; ++w)
#pragma unroll
            for (int b = 0; b < G::kBoxes; ++b)
              hp::tensor_load_2d(sg + (w * G::kBoxes + b) * 8192, &g.gate,
                                 g.gate_x + nt * TN + b * (128 / G::kElem),
                                 mt * kBM + 64 * (G::kStages == 1 ? w : gs), &full[stage], once);
          advance(stage, phase);
        }
      }
    }
    return;
  }

  hp::setmaxnreg_inc<kConsumerRegs>();
  const int cw = wg - 1, w4 = warp & 3, gq = lane >> 2, q = lane & 3;
  const int t = threadIdx.x - 128 * (cw + 1);   // the thread in its warpgroup
  const uint32_t s0 = hp::smem_u32(smem);
  unsigned char* epi_smem = smem + R::kStages * R::kStageBytes + cw * kEpiBytes;
  int stage = 0, phase = 0;
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    int split, mt, nt;
    gemm_item(g, it, split, mt, nt);
    const int kb = split * g.k_split, ke = min(g.k, kb + g.k_split);
    const int row0 = mt * kBM + cw * 64;
    float acc[TN / 2];
#pragma unroll
    for (int i = 0; i < TN / 2; ++i) acc[i] = 0.f;
    if constexpr (Epi::kStaged)
      epi.begin(reinterpret_cast<float*>(epi_smem + kEpiZ), nt * TN, min(TN, g.n - nt * TN), t);
    int held = -1;
    for (int k = kb; k < ke; k += kBK) {
      hp::mbar_wait(&full[stage], phase);
      const uint32_t sa = s0 + stage * R::kStageBytes + cw * 8192, sb = s0 + stage * R::kStageBytes
                                                                      + R::kABytes;
      hp::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kBK / 16; ++ks) {
        if constexpr (kKMajor)
          hp::wgmma_ss(acc, hp::make_desc_sw128(sa + ks * 32), hp::make_desc_sw128(sb + ks * 32),
                       1);
        else
          hp::wgmma_ss_tt(acc, hp::make_desc_sw128_mn(sa + ks * 2048, 8192),
                          hp::make_desc_sw128_mn(sb + ks * 2048, 8192), 1);
      }
      hp::wgmma_commit();
      // the stage before this one is read: back to the producer
      hp::wgmma_wait<1>();
      if (held >= 0) release(&empty[held], lane);
      held = stage;
      advance(stage, phase);
    }
    hp::wgmma_wait<0>();
    hp::fence_regs(acc);
    if (held >= 0) release(&empty[held], lane);

    // accumulator entry 4 j + i: row 16 w4 + gq + 8 (i / 2) of this
    // warpgroup's 64, column 8 j + 2 q + (i % 2)
    if constexpr (Epi::kStaged) {
      // the gate's stage(s) after the tile's k stages
      int gate_stage[2] = {stage, stage};
      const unsigned char* gate = nullptr;
      if constexpr (Epi::kGate) {
        using G = GateRing<TN, Epi>;
        int gate_phase[2] = {phase, phase};
#pragma unroll
        for (int gs = 0; gs < G::kStages; ++gs) {
          gate_stage[gs] = stage;
          gate_phase[gs] = phase;
          advance(stage, phase);
        }
        const int mine = G::kStages == 1 ? 0 : cw;
        hp::mbar_wait(&full[gate_stage[mine]], gate_phase[mine]);
        gate = smem + gate_stage[mine] * R::kStageBytes + (G::kStages == 1 ? cw * G::kWgBytes : 0);
      }
      // a chunk of kChunk columns at a time through this warpgroup's region
      unsigned char* x = epi_smem;
      unsigned char* y = x + kEpiX;
      const float* z = reinterpret_cast<const float*>(x + kEpiZ);
      const int rows = g.m - row0, bar = 2 + cw;
      unsigned char* yg = y;   // FwdEpi's stash region, or the chain's gate
      if constexpr (Epi::kGate) yg = const_cast<unsigned char*>(gate);
      // begin's z is written by the warpgroup's other threads
      hp::named_sync(bar, 128);
#pragma unroll
      for (int c = 0; c < TN / kChunk; ++c) {
        const int c0 = nt * TN + kChunk * c;
        if (c0 < g.n) {
          float2 sum[kChunk / 8];
#pragma unroll
          for (int jj = 0; jj < kChunk / 8; ++jj) {
            sum[jj] = make_float2(0.f, 0.f);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int j = c * (kChunk / 8) + jj, cc = 8 * jj + 2 * q, r = w4 * 16 + gq + 8 * h;
              if (c0 + cc < g.n) {
                const float2 v = epi.put(x, yg, r, cc, kChunk * c + cc, z + kChunk * c,
                                         acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
                if (r < rows) {
                  sum[jj].x += v.x;
                  sum[jj].y += v.y;
                }
              }
            }
          }
          if constexpr (Epi::kColsum) {
            // the chunk's column sums over this warpgroup's rows: over the
            // 8 lanes of a column pair, then the 4 warps in order
            float* red = reinterpret_cast<float*>(x + kEpiZ);
#pragma unroll
            for (int jj = 0; jj < kChunk / 8; ++jj) {
#pragma unroll
              for (int off = 4; off < 32; off *= 2) {
                sum[jj].x += __shfl_xor_sync(0xffffffffu, sum[jj].x, off);
                sum[jj].y += __shfl_xor_sync(0xffffffffu, sum[jj].y, off);
              }
              if (gq == 0)
                *reinterpret_cast<float2*>(red + w4 * kChunk + 8 * jj + 2 * q) = sum[jj];
            }
          }
          hp::named_sync(bar, 128);
          epi.flush(x, y, row0, c0, rows, g.n - c0, t);
          if constexpr (Epi::kColsum) {
            const float* red = reinterpret_cast<const float*>(x + kEpiZ);
            if (t < kChunk && c0 + t < g.n)
              epi.db_part[static_cast<size_t>(2 * mt + cw) * g.n + c0 + t] =
                  ((red[t] + red[kChunk + t]) + red[2 * kChunk + t]) + red[3 * kChunk + t];
          }
          // the region is written again by the next chunk
          hp::named_sync(bar, 128);
        }
      }
      if constexpr (Epi::kGate) {
#pragma unroll
        for (int gs = 0; gs < GateRing<TN, Epi>::kStages; ++gs) release(&empty[gate_stage[gs]], lane);
      }
    } else {
      const int rw = row0 + w4 * 16 + gq, col0 = nt * TN + 2 * q;
      if (g.splits == 1) {
#pragma unroll
        for (int j = 0; j < TN / 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = rw + 8 * h, col = col0 + 8 * j;
            if (row < g.m && col < g.n) epi(row, col, acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
          }
        continue;
      }
      // a range of the points: its partial, and the tile's last arrival sums
      // the partials in range order
      const size_t slice = static_cast<size_t>(g.m) * g.n;
#pragma unroll
      for (int j = 0; j < TN / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = rw + 8 * h, col = col0 + 8 * j;
          if (row < g.m && col < g.n) {
            float* p = g.part + split * slice + static_cast<size_t>(row) * g.n + col;
            p[0] = acc[4 * j + 2 * h];
            if (col + 1 < g.n) p[1] = acc[4 * j + 2 * h + 1];
          }
        }
      __threadfence();
      hp::named_sync(1, kConsumers);
      if (threadIdx.x == 128) {
        unsigned int* cnt = g.count + mt * g.tiles_n + nt;
        const bool is_last = atomicAdd(cnt, 1u) == static_cast<unsigned int>(g.splits - 1);
        if (is_last) *cnt = 0u;
        last = is_last;
      }
      hp::named_sync(1, kConsumers);
      if (!last) continue;
      __threadfence();
#pragma unroll
      for (int j = 0; j < TN / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = rw + 8 * h, col = col0 + 8 * j;
          if (row < g.m && col < g.n) {
            const float* p = g.part + static_cast<size_t>(row) * g.n + col;
            const bool two = col + 1 < g.n;
            float v0 = 0.f, v1 = 0.f;
            for (int sp = 0; sp < g.splits; ++sp, p += slice) {
              v0 += __ldcg(p);
              if (two) v1 += __ldcg(p + 1);
            }
            epi(row, col, v0, v1);
          }
        }
    }
  }
}

// Launch wide_wgmma_kernel<kKMajor, TN> on g: the operands' tensor maps
// (K-major A [m_load rows][k] in boxes of [128][64], B [n_load][k] in
// [TN][64]; MN-major A [k rows][m_load] and B [k][n_load] in [64][64]), a
// persistent grid of at most one block an SM, its shared memory (the limit
// raised on every launch: a few microseconds, and right on any device).
template <bool kKMajor, int TN, class Epi>
cudaError_t launch_tn(const Gemm& g, int splits, int k_split, float* part, unsigned int* count,
                      const Epi& epi, cudaStream_t s) {
  using R = Ring<TN>;
  GemmParams p{};
  cudaError_t err = kKMajor
      ? hp::encode_2d(&p.a, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, g.a.ptr, g.k, g.m_load, g.a.ld * 2,
                      kBK, kBM, true)
      : hp::encode_2d(&p.a, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, g.a.ptr, g.m_load, g.k, g.a.ld * 2,
                      64, kBK, true);
  if (err != cudaSuccess) return err;
  err = kKMajor
      ? hp::encode_2d(&p.b, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, g.b.ptr, g.k, g.n_load, g.b.ld * 2,
                      kBK, TN, true)
      : hp::encode_2d(&p.b, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, g.b.ptr, g.n_load, g.k, g.b.ld * 2,
                      64, kBK, true);
  if (err != cudaSuccess) return err;
  p.m = g.m;
  p.n = g.n;
  p.k = g.k;
  p.k_split = k_split;
  p.splits = splits;
  p.tiles_m = (g.m + kBM - 1) / kBM;
  p.tiles_n = (g.n + TN - 1) / TN;
  p.part = part;
  p.count = count;
  if constexpr (Epi::kGate) {
    if ((err = epi.gate_map(&p.gate, g.m)) != cudaSuccess) return err;
    p.gate_x = static_cast<int>(epi.at);
  }
  int device = 0, sms = 132;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  auto kernel = wide_wgmma_kernel<kKMajor, TN, Epi>;
  const size_t smem = R::kSmem + (Epi::kStaged ? 2 * kEpiBytes : 0);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int items = splits * p.tiles_m * p.tiles_n;
  kernel<<<min(items, sms), kThreads, smem, s>>>(p, epi);
  return cudaGetLastError();
}

// Launch the product g at N tile tn (tile_n) in `splits` ranges of k_split
// (splits > 1: partials and counts, see wide_wgmma_kernel). An epilogue
// declares the least tile it is built for (kMinTile), so only the tiles a
// product can take are compiled.
template <bool kKMajor, class Epi>
cudaError_t launch_gemm(const Gemm& g, int tn, int splits, int k_split, float* part,
                        unsigned int* count, const Epi& epi, cudaStream_t s) {
  constexpr int kMin = kKMajor ? Epi::kMinTile : (Epi::kMinTile > 64 ? Epi::kMinTile : 64);
#define SUNERF_WIDE_TILE(TN)                                                          \
  if constexpr (TN >= kMin)                                                           \
    if (tn == TN) return launch_tn<kKMajor, TN>(g, splits, k_split, part, count, epi, s);
  SUNERF_WIDE_TILE(8)
  SUNERF_WIDE_TILE(16)
  SUNERF_WIDE_TILE(32)
  SUNERF_WIDE_TILE(64)
  SUNERF_WIDE_TILE(128)
  SUNERF_WIDE_TILE(256)
#undef SUNERF_WIDE_TILE
  return cudaErrorInvalidValue;
}

// One product in one range of the points (no partials): the layers, the
// head, the chain, denc
template <class Epi>
cudaError_t launch_kmajor(const Gemm& g, const Epi& epi, cudaStream_t s) {
  const int tn = tile_n(g.n, Epi::kMinTile);
  return launch_gemm<true>(g, tn, 1, (g.k + kBK - 1) / kBK * kBK, nullptr, nullptr, epi, s);
}

// ----------------------------------------------------------------- epilogues

// A Sine layer: y = reduce_2pi(acc + b), its bf16 sin to `act` (the next
// layer's input, row stride act_ld) and, by format, at column `at` + col
// of the stash rows (stride stash_ld): kStashInt8 the int8 cos8 to cs (act
// is the bf16 sin stash itself), kStashLsb the packed sin to hs,
// kStashI8pair the int8 round(127 sin) pairs to hs and the int8 cos8 H
// columns on, kStashBf16Cos (K4) the bf16 cos10 to cs (act the sin stash).
// Staged: the sin into x, the stash into y, then copied out.
template <int kFmt>
struct FwdEpi {
  static constexpr int kMinTile = 128;
  static constexpr bool kStaged = true, kGate = false, kColsum = false;
  const float* bias;
  __nv_bfloat16* act;
  long long act_ld;
  void* hs;
  void* cs;
  long long stash_ld;
  long long at;
  int h;             // 'i8pair': the cos8 half's offset from the sin8 half

  // the bias of columns [col0, col0 + cols) into z, a thread t of 128 two
  __device__ __forceinline__ void begin(float* z, int col0, int cols, int t) const {
    if (2 * t < cols)
      *reinterpret_cast<float2*>(z + 2 * t) = __ldg(reinterpret_cast<const float2*>(bias + col0 + 2 * t));
  }

  // (r, c) of the chunk, its bias at zc[c] (z from the chunk's first column)
  __device__ __forceinline__ float2 put(unsigned char* x, unsigned char* y, int r, int c, int,
                                        const float* zc, float v0, float v1) const {
    const float2 b = *reinterpret_cast<const float2*>(zc + c);
    const float y0 = reduce_2pi(v0 + b.x), y1 = reduce_2pi(v1 + b.y);
    const float s0 = sin_poly(y0), s1 = sin_poly(y1);
    *reinterpret_cast<uint32_t*>(x + r * kPitch16 + 2 * c) = pack_bf16(s0, s1);
    if constexpr (kFmt == kStashInt8) {
      *reinterpret_cast<uint16_t*>(y + r * kPitch8 + c) =
          static_cast<uint16_t>(pack_i8(cos8_q(y0), cos8_q(y1)));
    } else if constexpr (kFmt == kStashLsb) {
      *reinterpret_cast<uint32_t*>(y + r * kPitch16 + 2 * c) =
          pack_sin_csign(s0, __fmul_rn(y0, y0) > kHalfPiSq)
          | (pack_sin_csign(s1, __fmul_rn(y1, y1) > kHalfPiSq) << 16);
    } else if constexpr (kFmt == kStashI8pair) {
      // the sin rounded from f32, not from its bf16
      *reinterpret_cast<uint16_t*>(y + r * kPitch8 + c) = static_cast<uint16_t>(
          pack_i8(__float2int_rn(__fmul_rn(s0, kCosScale)), __float2int_rn(__fmul_rn(s1, kCosScale))));
      *reinterpret_cast<uint16_t*>(y + kHalf8 + r * kPitch8 + c) =
          static_cast<uint16_t>(pack_i8(cos8_q(y0), cos8_q(y1)));
    } else if constexpr (kFmt == kStashBf16Cos) {
      *reinterpret_cast<uint32_t*>(y + r * kPitch16 + 2 * c) = pack_bf16(cos10(y0), cos10(y1));
    }
    return make_float2(0.f, 0.f);
  }

  __device__ __forceinline__ void flush(const unsigned char* x, const unsigned char* y, int row0,
                                        int col0, int rows, int cols, int t) const {
    flush_chunk<2>(x, kPitch16, act + static_cast<size_t>(row0) * act_ld + col0, act_ld, rows,
                   cols, t);
    const size_t st = static_cast<size_t>(row0) * stash_ld + at + col0;
    if constexpr (kFmt == kStashInt8) {
      flush_chunk<1>(y, kPitch8, static_cast<int8_t*>(cs) + st, stash_ld, rows, cols, t);
    } else if constexpr (kFmt == kStashLsb) {
      flush_chunk<2>(y, kPitch16, static_cast<__nv_bfloat16*>(hs) + st, stash_ld, rows, cols, t);
    } else if constexpr (kFmt == kStashI8pair) {
      flush_chunk<1>(y, kPitch8, static_cast<int8_t*>(hs) + st, stash_ld, rows, cols, t);
      flush_chunk<1>(y + kHalf8, kPitch8, static_cast<int8_t*>(hs) + st + h, stash_ld, rows, cols,
                     t);
    } else if constexpr (kFmt == kStashBf16Cos) {
      flush_chunk<2>(y, kPitch16, static_cast<__nv_bfloat16*>(cs) + st, stash_ld, rows, cols, t);
    }
  }
};

// The head: out[row, col] = acc + b_out[col], f32, d_output columns.
struct HeadEpi {
  static constexpr int kMinTile = 8;
  static constexpr bool kStaged = false, kGate = false, kColsum = false;
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
// pairs hs, kStashBf16Cos the bf16 cs. Staged: the gate read from the ring
// (GateRing: TMA boxes, 128-byte swizzle), dz into x, and the column sums
// of dz a warpgroup's 64 rows into db_part (the bias gradient's first step).
template <int kFmt>
struct ChainEpi {
  static constexpr int kMinTile = 128;
  static constexpr bool kStaged = true, kGate = true, kColsum = true;
  static constexpr bool kGate8 = kFmt == kStashInt8 || kFmt == kStashI8pair;
  static constexpr int kGateBytes = kGate8 ? 1 : 2;
  __nv_bfloat16* dz;
  int h;
  const void* gate;
  long long stash_ld;
  long long at;
  float* db_part;   // [2 m tiles][h]

  // the stash as the producer loads the gate: [rows][stash_ld] in boxes of
  // [64 rows][128 bytes]
  cudaError_t gate_map(CUtensorMap* map, int rows) const {
    return hp::encode_2d(map, kGate8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                         gate, stash_ld, rows, stash_ld * kGateBytes, 128 / kGateBytes, 64, true);
  }

  __device__ __forceinline__ void begin(float*, int, int, int) const {}

  // dz of (r, c) of the chunk into x, its gate at tile column tc of the
  // warpgroup's gate boxes g; returns dz as stored (bf16 values)
  __device__ __forceinline__ float2 put(unsigned char* x, unsigned char* g, int r, int c, int tc,
                                        const float*, float v0, float v1) const {
    float g0, g1;
    if constexpr (kGate8) {
      const unsigned char* p = g + (tc >> 7) * 8192 + hp::swizzle128(r, tc & 127);
      g0 = cos_dequant(static_cast<int8_t>(p[0]));
      g1 = cos_dequant(static_cast<int8_t>(p[1]));
    } else {
      const uint32_t w = *reinterpret_cast<const uint32_t*>(
          g + (tc >> 6) * 8192 + hp::swizzle128(r, (tc & 63) * 2));
      if constexpr (kFmt == kStashLsb) {
        g0 = lsb_gate(static_cast<uint16_t>(w & 0xFFFFu));
        g1 = lsb_gate(static_cast<uint16_t>(w >> 16));
      } else {
        g0 = __bfloat162float(__ushort_as_bfloat16(static_cast<uint16_t>(w & 0xFFFFu)));
        g1 = __bfloat162float(__ushort_as_bfloat16(static_cast<uint16_t>(w >> 16)));
      }
    }
    const float d0 = bf16_round(__fmul_rn(bf16_round(v0), g0));
    const float d1 = bf16_round(__fmul_rn(bf16_round(v1), g1));
    *reinterpret_cast<uint32_t*>(x + r * kPitch16 + 2 * c) = pack_bf16(d0, d1);
    return make_float2(d0, d1);
  }

  __device__ __forceinline__ void flush(const unsigned char* x, const unsigned char*, int row0,
                                        int col0, int rows, int cols, int t) const {
    flush_chunk<2>(x, kPitch16, dz + static_cast<size_t>(row0) * h + col0, h, rows, cols, t);
  }
};

// f32 outputs [rows][ld]: dW (summed over the points' ranges) or denc.
struct StoreEpi {
  static constexpr int kMinTile = 8;
  static constexpr bool kStaged = false, kGate = false, kColsum = false;
  float* out;
  long long ld;

  __device__ __forceinline__ void operator()(int row, int col, float v0, float v1) const {
    float* o = out + static_cast<size_t>(row) * ld + col;
    o[0] = v0;
    if (col + 1 < ld) o[1] = v1;
  }
};

// ------------------------------------------------------------ small kernels

// The encoding [x, sin u, cos u, grid features, zeros] of each point as
// bf16 rows of e_pad, as the plain version computes it: a thread a point,
// u = x[dim] * freq in f32, cos u = sin(u + pi/2) with the sum rounded to
// f32, each grid level's features grid_level_features'. A block's
// kEncPoints rows are put together in shared memory (an odd number of words
// a row apart, so a warp's writes fall on distinct banks) and copied out a
// word a thread, whole rows side by side.
constexpr int kEncPoints = 64;

inline size_t encode_smem(int e_pad) {
  return static_cast<size_t>(kEncPoints) * (e_pad + 2) * sizeof(__nv_bfloat16);
}

__global__ void __launch_bounds__(kEncPoints) encode_kernel(
    const float* pts, const int* col_dim, const float* col_freq, const GridParams grid,
    __nv_bfloat16* enc, int n, int d_in, int n_cols, int e_pad) {
  extern __shared__ __nv_bfloat16 rows[];
  const int pitch = e_pad + 2;
  const int i0 = blockIdx.x * kEncPoints, i = i0 + threadIdx.x;
  if (i < n) {
    const float* x = pts + static_cast<size_t>(i) * d_in;
    __nv_bfloat16* e = rows + threadIdx.x * pitch;
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
  __syncthreads();
  const int words = e_pad / 2, points = min(kEncPoints, n - i0);
  const uint32_t* src = reinterpret_cast<const uint32_t*>(rows);
  uint32_t* dst = reinterpret_cast<uint32_t*>(enc + static_cast<size_t>(i0) * e_pad);
  for (int w = threadIdx.x; w < points * words; w += kEncPoints) {
    const int r = w / words;
    dst[w] = src[r * (pitch / 2) + (w - r * words)];
  }
}

// Launch encode_kernel (its shared memory above 48 KB where e_pad asks)
inline cudaError_t encode(const float* pts, const int* col_dim, const float* col_freq,
                          const GridParams& grid, __nv_bfloat16* enc, int n, int d_in, int n_cols,
                          int e_pad, cudaStream_t s) {
  const size_t bytes = encode_smem(e_pad);
  const cudaError_t err = cudaFuncSetAttribute(
      encode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  encode_kernel<<<(n + kEncPoints - 1) / kEncPoints, kEncPoints, bytes, s>>>(
      pts, col_dim, col_freq, grid, enc, n, d_in, n_cols, e_pad);
  return cudaGetLastError();
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

// 'i8pair''s dW_h tiles: 128 x 128 outputs, 32-point slices, 8 warps
constexpr int kI8K = 32, kI8BN = 128, kI8Threads = 256;

// The split of 'i8pair''s dW_h points (ops/wide_mlp.py i8_plan): ranges of
// whole scale groups, enough for about two blocks an SM, at least 1024
// points a range, at most kMaxSplits.
inline void i8_plan(int h, int points, int group, int sms, int& splits, int& k_split) {
  const int tiles = ((h + kBM - 1) / kBM) * ((h + kI8BN - 1) / kI8BN);
  int want = (2 * sms + tiles - 1) / tiles;
  want = max(1, min(want, min(kMaxSplits, (points + 1023) / 1024)));
  k_split = ((points + want - 1) / want + group - 1) / group * group;
  splits = (points + k_split - 1) / k_split;
}

// The bytes of an m16n8k32 fragment register holding rows k .. k+3 (row k
// in the low byte) that lie in [lo, hi): 0xFF where they do, else 0.
__device__ __forceinline__ uint32_t row_mask4(int k, int lo, int hi) {
  uint32_t m = 0u;
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (k + e >= lo && k + e < hi) m |= 0xFFu << (8 * e);
  return m;
}

// 'i8pair' dW_h = sin8^T dz8 on the int8 tensor cores (mma.sync m16n8k32
// s32.s8.s8), K6b's _dw_i8 at any scale group of `group` points (1 to
// 133,144, so that a group's int32 sum cannot overflow): each point's dz is
// quantized with its own group's scale 127 / m (m the group's max |dz|, a
// rounded division; 0 where m = 0) to round_half_even(dz scale); each
// group's exact int32 sum goes to f32 and is scaled by f32(m (1/127)^2) into
// f32 accumulators, group after group in point order. A block takes a
// 128 x 128 tile of dW over its split's points (whole groups), loading each
// 32-point slice of sin8 (as stored) and of dz (quantized on the way) into
// shared memory; where a group boundary falls inside a slice, the slice's
// products are issued once for each of its groups, the other groups' dz
// rows masked to zero in the fragments, and a group's sum is flushed where
// it ends. One int32 accumulator set is live at a time (a group that runs
// on into the next slice keeps it). out is the split's f32 partials [m][n].
__global__ void __launch_bounds__(kI8Threads) dw_i8_kernel(
    const int8_t* s8, long long s8_ld, const __nv_bfloat16* dz, int h, int n_pts,
    const unsigned int* gmax, int group, int k_split, float* out) {
  __shared__ int8_t sa[kI8K * kI8Ld];
  __shared__ int8_t sb[kI8K * kI8Ld];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kI8BN;
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
  for (int k0 = kb; k0 < ke; k0 += kI8K) {
    // the slices: thread t takes 16 columns of one point row of each, the
    // point's dz quantized with its own group's scale
    const int r = threadIdx.x >> 3, c = (threadIdx.x & 7) * 16;
    const int pt = k0 + r;
    int4 va = make_int4(0, 0, 0, 0);
    int8_t vb[16];
    if (pt < ke) {
      const float m = __uint_as_float(gmax[pt / group]);
      const float scale = m > 0.f ? __fdiv_rn(kCosScale, m) : 0.f;
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
    // the slice's groups in order: the points [lo, hi) of group gi
    const int k1 = min(k0 + kI8K, ke);
    for (int gi = k0 / group; gi * group < k1; ++gi) {
      const int lo = max(k0, gi * group), hi = min(k1, (gi + 1) * group);
      const uint32_t mk0 = row_mask4(k0 + 4 * q, lo, hi), mk1 = row_mask4(k0 + 16 + 4 * q, lo, hi);
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma_s8(acc_i[mt][nt], af[mt], bfr[nt][0] & mk0, bfr[nt][1] & mk1);
      // the group's end (or the split's): its exact sum, scaled, into f32
      if (hi == (gi + 1) * group || hi == ke) {
        const float f = __fmul_rn(__uint_as_float(gmax[gi]), kInvCosSq);
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
  unsigned int* tile_count;     // [dW tiles at most] arrivals, zero (wide_wgmma_kernel)
  float* db_part;               // [2 ceil(n / 128), H] the chain's column sums (ChainEpi)
  int n, d_in, n_cols, e_pad, h, n_hidden, d_out, o_pad, fmt;
  int group;                    // 'i8pair': dz's scale group, 1 to 133,144
};

}  // namespace wide
}  // namespace sunerf
