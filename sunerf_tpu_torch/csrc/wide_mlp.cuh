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
      unsigned int rmax[2] = {0u, 0u};   // kRowmax: max |dz| bits of this thread's rows
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
                if constexpr (Epi::kRowmax)
                  rmax[h] = max(rmax[h], max(__float_as_uint(fabsf(v.x)),
                                             __float_as_uint(fabsf(v.y))));
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
      if constexpr (Epi::kRowmax) {
        // each row's maximum over the tile's columns: over the 4 lanes of a
        // row, a word a (N tile, point)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          unsigned int m = max(rmax[h], __shfl_xor_sync(0xffffffffu, rmax[h], 1));
          m = max(m, __shfl_xor_sync(0xffffffffu, m, 2));
          const int r = w4 * 16 + gq + 8 * h;
          if (q == 0 && r < rows) epi.rowmax[static_cast<size_t>(nt) * g.m + row0 + r] = m;
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
  static constexpr bool kStaged = true, kGate = false, kColsum = false, kRowmax = false;
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
// of dz a warpgroup's 64 rows into db_part (the bias gradient's first step);
// 'i8pair' also each point's max |dz| over the tile's columns into rowmax
// (the scale groups' maxima's first step, wide_dz_group_max_kernel).
template <int kFmt>
struct ChainEpi {
  static constexpr int kMinTile = 128;
  static constexpr bool kStaged = true, kGate = true, kColsum = true;
  static constexpr bool kRowmax = kFmt == kStashI8pair;
  static constexpr bool kGate8 = kFmt == kStashInt8 || kFmt == kStashI8pair;
  static constexpr int kGateBytes = kGate8 ? 1 : 2;
  __nv_bfloat16* dz;
  int h;
  const void* gate;
  long long stash_ld;
  long long at;
  float* db_part;   // [2 m tiles][h]
  unsigned int* rowmax;  // 'i8pair': [N tiles][rows] each point's max |dz| over a tile's columns

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

// The groups' maxima of 'i8pair''s dz scale (K6b's _mm_i8 takes max |dz|
// over each group of `group` points): the chain's epilogue writes each
// point's max |dz| over an N tile's columns as the bits of a non-negative
// float (ChainEpi::rowmax, [tiles][n]); gmax[g] = the max of those words
// over group g's points [g G, (g+1) G) below n and every tile, compared as
// bits (non-negative floats order as their bits, NaN above every finite
// one, as jnp.max propagates it): a warp a group, 8 groups a block. The
// words replace a pass over dz (n H bf16, 403 MB a layer at 8x1024, N =
// 196,608) with one over n tiles words (3.1 MB).
constexpr int kGroupsPerBlock = 8;

__global__ void __launch_bounds__(32 * kGroupsPerBlock) wide_dz_group_max_kernel(
    const unsigned int* rowmax, int n, int tiles, int group, int n_groups, unsigned int* gmax) {
  const int g = blockIdx.x * kGroupsPerBlock + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (g >= n_groups) return;
  const long long r0 = static_cast<long long>(g) * group;
  const long long r1 = min(static_cast<long long>(n), r0 + group);
  unsigned int m = 0u;
  for (int t = 0; t < tiles; ++t)
    for (long long r = r0 + lane; r < r1; r += 32)
      m = max(m, __ldg(rowmax + static_cast<size_t>(t) * n + r));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = max(m, __shfl_xor_sync(0xffffffffu, m, off));
  if (lane == 0) gmax[g] = m;
}

inline cudaError_t group_maxima(const unsigned int* rowmax, int n, int tiles, int group,
                                unsigned int* gmax, cudaStream_t s) {
  const int n_groups = (n + group - 1) / group;
  wide_dz_group_max_kernel<<<(n_groups + kGroupsPerBlock - 1) / kGroupsPerBlock,
                             32 * kGroupsPerBlock, 0, s>>>(rowmax, n, tiles, group, n_groups,
                                                           gmax);
  return cudaGetLastError();
}

// 'i8pair''s dW_h tiles: kBM x kI8TN outputs over chunks of kI8Chunk points,
// a ring of kI8Stages chunks, kI8Bufs buffers of int8 operands
constexpr int kI8TN = 128, kI8Chunk = 64, kI8Stages = 6, kI8Bufs = 3;
constexpr int kI8ABytes = kI8Chunk * 128;                       // the stash box
constexpr int kI8StageBytes = kI8ABytes + (kI8TN / 64) * 8192;  // and dz's boxes
constexpr int kI8A8 = kBM * kI8Chunk;                           // A8 [128 rows][64 k]
constexpr int kI8OpBytes = kI8A8 + kI8TN * kI8Chunk;            // A8 and B8
constexpr size_t kI8Smem =
    static_cast<size_t>(kI8Stages) * kI8StageBytes + kI8Bufs * kI8OpBytes + 1024;

// The split of 'i8pair''s dW_h points (ops/wide_mlp.py i8_plan): ranges of
// whole scale groups, as many as keep every block of the card on one tile
// (one wave of the persistent walk), at least 1024 points a range, at most
// kMaxSplits.
inline void i8_plan(int h, int points, int group, int sms, int& splits, int& k_split) {
  const int tiles = ((h + kBM - 1) / kBM) * ((h + kI8TN - 1) / kI8TN);
  const int want = max(1, min(sms / tiles, min(kMaxSplits, (points + 1023) / 1024)));
  k_split = ((points + want - 1) / want + group - 1) / group * group;
  splits = (points + k_split - 1) / k_split;
}

// The int8 operands of wide_dw_i8_wgmma_kernel, both K-major (8-bit wgmma
// takes no transpose) with the chunk's 64 points as K, in the no-swizzle
// layout: core matrices of 8 rows x 16 k (16 bytes), element (row, k) at
// ((k / 16) (rows / 8) + row / 8) 128 + (row % 8) 16 + k % 16. K runs over
// the points in the order k = 16 kg + 8 h + j <-> point 8 j + 2 kg + h (the
// sum over k does not care, as long as A and B agree): a thread with the
// points 8 j + q (q = l / 4, j = 0..7) then writes 8 contiguous bytes of a
// core-matrix row (kg = q / 2, h = q % 2). ops/wide_mlp.py
// i8_build_operands mirrors the builds.
__device__ __forceinline__ int i8_offset(int rows, int row, int q) {
  return ((q >> 1) * (rows / 8) + row / 8) * 128 + (row % 8) * 16 + 8 * (q & 1);
}

// Bytes e of four words, in order (e may differ from lane to lane)
__device__ __forceinline__ uint32_t gather_bytes(uint32_t w0, uint32_t w1, uint32_t w2,
                                                 uint32_t w3, int e) {
  const int sel = e | ((e + 4) << 4);
  return __byte_perm(__byte_perm(w0, w1, sel), __byte_perm(w2, w3, sel), 0x5410);
}

// A = sin8^T [128 rows m][64 points] from the stash box [64 points][128
// bytes of m] (TMA, 128-byte swizzle: point p's 16-byte piece i at
// p 128 + ((i ^ p) % 8) 16): thread t (warp w, lane l) the columns
// m = 16 w + 4 (l % 4) + e, e = 0..3, of the points 8 j + l / 4 (one 32-bit
// load a point, a byte transpose); the row order rotated by
// 2 kg + (l % 4) / 2 so that a half warp's 8-byte stores cover 16 slots.
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
    *reinterpret_cast<uint2*>(a8 + i8_offset(kBM, 16 * warp + 4 * c3 + er, q)) =
        make_uint2(gather_bytes(w[0], w[1], w[2], w[3], er),
                   gather_bytes(w[4], w[5], w[6], w[7], er));
  }
}

// B = dz8 [kI8TN rows n][64 points] of a group segment: round_half_even(dz
// scale) for the chunk's points [s0, s1), 0 for its others, from dz's boxes
// [64 points][64 bf16] (TMA, 128-byte swizzle; box n / 64, point p's
// 16-byte piece i at p 128 + ((i ^ p) % 8) 16): thread t the columns
// n = 8 ng + 2 (l % 4) and n + 1 of the points 8 j + l / 4 for
// ng = 2 w, 2 w + 1 (one 32-bit load a point; a warp's 32 loads on 32
// banks); odd kg store column n + 1 first. The product is rounded to f32,
// then to an integer by adding 1.5 2^23 (round half to even, the integer in
// the low bits: its low byte is the int8). Each block quantizes its tile's
// columns once a chunk for both warpgroups' rows.
__device__ __forceinline__ void build_b8(const unsigned char* boxes, unsigned char* b8, int s0,
                                         int s1, float scale) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q = lane >> 2, cp = lane & 3, kg = q >> 1;
  constexpr float kRound = 12582912.0f;
  float sc[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) sc[j] = (8 * j + q >= s0 && 8 * j + q < s1) ? scale : 0.0f;
#pragma unroll
  for (int u = 0; u < kI8TN / 64; ++u) {
    const int ng = (kI8TN / 64) * warp + u;
    const int n = 8 * ng + 2 * cp;
    const unsigned char* src = boxes + (ng >> 3) * 8192 + q * 128 + (((ng & 7) ^ q) << 4) + 4 * cp;
    uint32_t lo[8], hi[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint32_t x = *reinterpret_cast<const uint32_t*>(src + 1024 * j);
      lo[j] = __float_as_uint(__fadd_rn(__fmul_rn(__uint_as_float(x << 16), sc[j]), kRound));
      hi[j] = __float_as_uint(__fadd_rn(__fmul_rn(__uint_as_float(x & 0xFFFF0000u), sc[j]),
                                        kRound));
    }
    const uint2 vlo = make_uint2(gather_bytes(lo[0], lo[1], lo[2], lo[3], 0),
                                 gather_bytes(lo[4], lo[5], lo[6], lo[7], 0));
    const uint2 vhi = make_uint2(gather_bytes(hi[0], hi[1], hi[2], hi[3], 0),
                                 gather_bytes(hi[4], hi[5], hi[6], hi[7], 0));
    *reinterpret_cast<uint2*>(b8 + i8_offset(kI8TN, n + (kg & 1), q)) = (kg & 1) ? vhi : vlo;
    *reinterpret_cast<uint2*>(b8 + i8_offset(kI8TN, n + 1 - (kg & 1), q)) = (kg & 1) ? vlo : vhi;
  }
}

// Variants of wide_dw_i8_wgmma_kernel for scripts/probe_wide_gemm.py (built
// with -D by build.build(name, defines); timed only, their sums are wrong):
// 1 without the operand builds, 2 without the products, 3 without either.
#ifndef SUNERF_WIDE_I8_ABLATION
#define SUNERF_WIDE_I8_ABLATION 0
#endif

// The parameters of wide_dw_i8_wgmma_kernel
struct I8Params {
  CUtensorMap a;            // the stash [n][ld] bytes in boxes [64 points][128 bytes]
  CUtensorMap b;            // dz [n][h] bf16 in boxes [64 points][64 columns]
  int a_x;                  // the layer's sin8 column in the stash
  int h, n, group, k_split, splits;
  const unsigned int* gmax; // the groups' max |dz| bits (wide_dz_group_max_kernel)
  float* out;               // dW_h [h][h]
  float* part;              // splits > 1: the ranges' partials [splits][h][h]
  unsigned int* count;      // splits > 1: the arrivals a tile, zero between launches
};

// 'i8pair' dW_h = sin8^T dz8 on the int8 tensor cores, K6b's _dw_i8 (the
// i8pair branch of _bwd_stash_kernel, _mm_i8) at any scale group of `group`
// points (1 to 133,144, so that a group's int32 sum cannot overflow): with
// m = gmax[g] of group g, scale = 127 / m (a rounded division; 0 where
// m = 0), dz8 = round_half_even(dz scale); each group's exact int32 sum of
// sin8 (x) dz8 goes to f32 and is scaled by f32(m (1/127)^2) into f32 sums,
// group after group in point order. Work items (range of whole groups,
// 128-row tile of m, kI8TN-column tile of n), walked by persistent blocks of
// two warpgroups in one wave, the items of a range side by side, so that
// the tiles reading the same chunk of sin8 (h / kI8TN of them) and of dz
// (h / 128) run at the same time and L2 serves the repeats. Thread 0 keeps
// a ring of 64-point chunks kI8Stages ahead: the stash box [64 points][128
// bytes of sin8] and dz's kI8TN columns as two boxes [64][64 bf16], by TMA
// in the 128-byte swizzle (past n and past the width TMA's zeros), and
// refills a stage as soon as the block is past its last read. No producer
// warp: the int32 and f32 accumulator sets take 128 registers a thread, and
// a ninth warp would cap them at 168. Both warpgroups transpose each chunk
// into K-major int8 operands (build_a8, and build_b8 with dz quantized: once
// a chunk for both warpgroups' rows), meet at one barrier, and run wgmma
// m64n128k32 s32.s8.s8 twice, each warpgroup its 64 rows, the next chunk's
// transposes under them. A chunk that crosses a group boundary (G = 8, 24,
// 40, ...) is taken one segment at a time, its other points' dz8 zero.
// Three operand buffers: a warpgroup waits for its products of the segment
// before last before the barrier, so the buffer rewritten after it is no
// longer read by either. Rows of a tile past h (the stash's next columns)
// are computed and not stored. With one range the sums are _dw_i8's bits;
// ranges' partials are summed in range order by each tile's last block (a
// counter a tile, reset by that block).
//
// Bound on this card: operations, 2 n h^2 int8 (0.412 TOP a layer at
// 8x1024, N = 196,608: 0.208 ms at 1979 TOPS dense); bytes, sin8 n h and dz
// 2 n h once (0.604 GB, 0.180 ms at 3.35 TB/s). The design streams sin8
// h / kI8TN and dz h / 128 times from L2 (4.8 GB a layer at 8x1024) and
// builds both operands in the consumers' time: scripts/probe_wide_gemm.py
// on an H100 80GB HBM3 at 700 W, a layer at 8x1024, the kernel 1.387 ms,
// its ring's loads alone 0.707 (the L2 stream at 6.8 TB/s), the loads and
// builds without the products 1.272.
__global__ void __launch_bounds__(kConsumers, 1) wide_dw_i8_wgmma_kernel(
    const __grid_constant__ I8Params p) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ uint64_t full[kI8Stages];
  __shared__ int last;
  unsigned char* stages = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  unsigned char* ops = stages + kI8Stages * kI8StageBytes;
  const int tiles_n = (p.h + kI8TN - 1) / kI8TN;
  const int tiles = ((p.h + kBM - 1) / kBM) * tiles_n, items = p.splits * tiles;
  auto item = [&](int it, int& split, int& mt, int& nt) {
    split = it / tiles;
    const int r = it - split * tiles;
    mt = r / tiles_n;
    nt = r - mt * tiles_n;
  };

  // thread 0's loader: the block's chunks in the order they are read
  int ld_it = blockIdx.x, ld_c = ld_it < items ? (ld_it / tiles) * p.k_split : 0, ld_st = 0;
  const uint64_t policy = hp::evict_normal_policy();
  auto load_next = [&]() {
    if (ld_it >= items) return;
    int split, mt, nt;
    item(ld_it, split, mt, nt);
    unsigned char* s = stages + ld_st * kI8StageBytes;
    hp::mbar_expect_tx(&full[ld_st], kI8StageBytes);
    hp::tensor_load_2d(s, &p.a, p.a_x + mt * kBM, ld_c, &full[ld_st], policy);
#pragma unroll
    for (int b = 0; b < kI8TN / 64; ++b)
      hp::tensor_load_2d(s + kI8ABytes + b * 8192, &p.b, nt * kI8TN + 64 * b, ld_c, &full[ld_st],
                         policy);
    if (++ld_st == kI8Stages) ld_st = 0;
    ld_c += kI8Chunk;
    if (ld_c >= min(p.n, (split + 1) * p.k_split)) {
      ld_it += gridDim.x;
      ld_c = ld_it < items ? (ld_it / tiles) * p.k_split : 0;
    }
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < kI8Stages; ++s) hp::mbar_init(&full[s], 1);
    hp::fence_barrier_init();
    for (int s = 0; s < kI8Stages; ++s) load_next();
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wg = warp >> 2, w4 = warp & 3, gq = lane >> 2, q = lane & 3;
  const uint32_t ops0 = hp::smem_u32(ops);
  const size_t hh = static_cast<size_t>(p.h) * p.h;
  int stage = 0, phase = 0, buf = 0;
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    int split, mt, nt;
    item(it, split, mt, nt);
    const int p0 = split * p.k_split, p1 = min(p.n, p0 + p.k_split);
    int acc_i[kI8TN / 2];
    float acc_f[kI8TN / 2];
#pragma unroll
    for (int e = 0; e < kI8TN / 2; ++e) {
      acc_i[e] = 0;
      acc_f[e] = 0.f;
    }
    int have = -1;   // the chunk in the stage being read
    const unsigned char* sa = stages;
    for (int g0 = p0; g0 < p1;) {
      const int grp = g0 / p.group;
      const int g1 = min(p1, (grp + 1) * p.group);
      const float m = __uint_as_float(__ldg(p.gmax + grp));
      const float scale = m > 0.f ? __fdiv_rn(kCosScale, m) : 0.f;
      for (int s0 = g0; s0 < g1;) {
        const int c = p0 + ((s0 - p0) & ~(kI8Chunk - 1));
        if (c != have) {
          hp::mbar_wait(&full[stage], phase);
          sa = stages + stage * kI8StageBytes;
          if (++stage == kI8Stages) {
            stage = 0;
            phase ^= 1;
          }
          have = c;
        }
        const int c_end = min(c + kI8Chunk, p1), s1 = min(g1, c_end);
        unsigned char* op = ops + buf * kI8OpBytes;
        if (SUNERF_WIDE_I8_ABLATION != 1 && SUNERF_WIDE_I8_ABLATION != 3) {
          build_a8(sa, op);
          build_b8(sa + kI8ABytes, op + kI8A8, s0 - c, s1 - c, scale);
        }
        hp::fence_async_smem();
        hp::named_sync(1, kConsumers);
        // the block is past its reads of the chunk: refill its stage
        if (s1 == c_end && threadIdx.x == 0) load_next();
        const uint32_t a8 = ops0 + buf * kI8OpBytes, b8 = a8 + kI8A8;
        hp::wgmma_fence();
#pragma unroll
        for (int s = 0; s < 2; ++s)
          if (SUNERF_WIDE_I8_ABLATION != 2 && SUNERF_WIDE_I8_ABLATION != 3)
            hp::wgmma_s8(acc_i,
                         hp::make_desc(a8 + wg * (64 / 8) * 128 + 2 * s * (kBM / 8) * 128,
                                       (kBM / 8) * 128, 128),
                         hp::make_desc(b8 + 2 * s * (kI8TN / 8) * 128, (kI8TN / 8) * 128, 128),
                         s0 > g0 || s > 0);
        hp::wgmma_commit();
        if (++buf == kI8Bufs) buf = 0;
        hp::wgmma_wait<1>();
        s0 = s1;
      }
      // the group ends: its exact int32 sum, scaled, into the f32 sum
      hp::wgmma_wait<0>();
      hp::fence_regs(acc_i);
      const float f = __fmul_rn(m, kInvCosSq);
#pragma unroll
      for (int e = 0; e < kI8TN / 2; ++e)
        acc_f[e] = __fadd_rn(acc_f[e], __fmul_rn(__int2float_rn(acc_i[e]), f));
      g0 = g1;
    }
    // accumulator entry 4 j + i: row 16 w4 + gq + 8 (i / 2) of this
    // warpgroup's 64, column 8 j + 2 q + (i % 2)
    const int rw = mt * kBM + wg * 64 + w4 * 16 + gq, col0 = nt * kI8TN + 2 * q;
    float* dst = p.splits == 1 ? p.out : p.part + split * hh;
#pragma unroll
    for (int j = 0; j < kI8TN / 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = rw + 8 * r, col = col0 + 8 * j;
        if (row < p.h && col < p.h)   // h is even: col + 1 < h too
          *reinterpret_cast<float2*>(dst + static_cast<size_t>(row) * p.h + col) =
              make_float2(acc_f[4 * j + 2 * r], acc_f[4 * j + 2 * r + 1]);
      }
    if (p.splits == 1) continue;
    // a range's partial: the tile's last arrival sums the partials in range order
    __threadfence();
    hp::named_sync(1, kConsumers);
    if (threadIdx.x == 0) {
      unsigned int* cnt = p.count + mt * tiles_n + nt;
      const bool is_last = atomicAdd(cnt, 1u) == static_cast<unsigned int>(p.splits - 1);
      if (is_last) *cnt = 0u;
      last = is_last;
    }
    hp::named_sync(1, kConsumers);
    if (!last) continue;
    __threadfence();
#pragma unroll
    for (int j = 0; j < kI8TN / 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = rw + 8 * r, col = col0 + 8 * j;
        if (row < p.h && col < p.h) {
          const float* src = p.part + static_cast<size_t>(row) * p.h + col;
          float v0 = 0.f, v1 = 0.f;
          for (int sp = 0; sp < p.splits; ++sp, src += hh) {
            v0 += __ldcg(src);
            v1 += __ldcg(src + 1);
          }
          *reinterpret_cast<float2*>(p.out + static_cast<size_t>(row) * p.h + col) =
              make_float2(v0, v1);
        }
      }
  }
}

// Launch wide_dw_i8_wgmma_kernel: out [h][h] = dW_h of sin8, the stash's
// columns [a_x, a_x + h) of rows of ld bytes, and dz [n][h] bf16, per scale
// group of `group` points with the groups' maxima gmax, in `splits` ranges
// of k_split points (i8_plan; splits > 1: partials [splits][h][h] and
// counts [tiles], zero). A persistent grid of at most one block an SM.
inline cudaError_t dw_i8(const int8_t* stash, long long ld, int a_x, const __nv_bfloat16* dz,
                         int n, int h, const unsigned int* gmax, int group, int splits,
                         int k_split, float* part, unsigned int* count, float* out,
                         cudaStream_t s) {
  I8Params p{};
  cudaError_t err = hp::encode_2d(&p.a, CU_TENSOR_MAP_DATA_TYPE_UINT8, stash, ld, n, ld, 128,
                                  kI8Chunk, true);
  if (err != cudaSuccess) return err;
  err = hp::encode_2d(&p.b, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, dz, h, n, 2LL * h, 64, kI8Chunk,
                      true);
  if (err != cudaSuccess) return err;
  p.a_x = a_x;
  p.h = h;
  p.n = n;
  p.group = group;
  p.k_split = k_split;
  p.splits = splits;
  p.gmax = gmax;
  p.out = out;
  p.part = part;
  p.count = count;
  int device = 0, sms = 132;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  err = cudaFuncSetAttribute(wide_dw_i8_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kI8Smem));
  if (err != cudaSuccess) return err;
  const int items = splits * ((h + kBM - 1) / kBM) * ((h + kI8TN - 1) / kI8TN);
  wide_dw_i8_wgmma_kernel<<<min(items, sms), kConsumers, kI8Smem, s>>>(p);
  return cudaGetLastError();
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
  unsigned int* tile_count;     // [dW tiles at most] arrivals, zero (wide_wgmma_kernel,
                                // wide_dw_i8_wgmma_kernel)
  float* db_part;               // [2 ceil(n / 128), H] the chain's column sums (ChainEpi)
  unsigned int* dz_rowmax;      // 'i8pair': [ceil(H / 128), n] the chain's row maxima
  int n, d_in, n_cols, e_pad, h, n_hidden, d_out, o_pad, fmt;
  int group;                    // 'i8pair': dz's scale group, 1 to 133,144
};

}  // namespace wide
}  // namespace sunerf
