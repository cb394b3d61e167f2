// Device code of the fused-MLP backwards for Hopper (sm_90a), shared by the
// stashing backward (fused_mlp_stash_bwd.cu: K2 with its point cotangent K3,
// the 'lsb' and 'i8pair' formats K6a and K6b, and the grid branch K5) and the
// recompute backward K4 (fused_mlp_recompute_bwd.cu). See those files for
// what each replaces and what bounds it.
//
// One backward pass over n points is these launches, in stream order:
//   1. chain_kernel: K1's block layout (64 points, 8 warps, mma.sync against
//      W_h^T packed in fragment order by the wrapper). It carries the
//      row-parallel chain dy -> dh -> dz_{L-1} -> dh -> ... -> dz_0 with dz
//      in shared memory, each dz_j gated by the layer's cos (the "gate",
//      below); it writes dz to a scratch [n, L*H] by the bulk-copy (TMA)
//      engine, the recomputed bf16 encoding to a scratch [n, E_pad], and per
//      block f32 partials of dW_out, db_out and every db_j. With kDpts it
//      ends with the point cotangent (K3); with grid levels with the grid
//      cotangent (K5).
//   2. K5 only: grid_scatter_kernel and grid_convert_kernel.
//   3. 'i8pair' only: dz_absmax_kernel, each group's max |dz_j|.
//   4. dw_kernel: each dW as a product contracting over the points, split
//      over the points into `splits` ranges with f32 partials per split;
//      for 'i8pair' the hidden layers' dW go to dw_i8_kernel instead.
//   5. reduce_kernel twice: the partials summed over blocks and splits in a
//      fixed order (added to the running sums with `accumulate`, for K4's
//      chunks), so a run gives the same bits as the last; no atomics.
// Rows past n are masked in every kernel: they load as zeros and are never
// stored.
//
// The gate of layer j, the value dz_j = bf16(bf16(dh) * gate) multiplies by:
//   kGateInt8: bf16(bf16(q) * bf16(1/127)) of an int8 cos x127 stash (K1's
//              cs, or the cos half of K6b's pairs);
//   kGateBf16: a bf16 cos (K4's recomputed fast_sincos cos);
//   kGateLsb:  bf16(sign * sqrt(max(1 - s^2, 0))) in f32 from K6a's packed
//              bf16 sin s, its last bit the sign (_unpack_sin_cos).
// The int8 gates are staged in shared memory: two tiles [64, H + 16] that
// land by cp.async while the warps run the previous product (one barrier a
// layer). A bf16 gate tile takes twice the bytes, and two do not fit beside
// the activation buffers at H = 512, so the bf16 gates are read in the
// epilogue straight from device memory (through L1 and L2).
#pragma once

#include "fused_mlp_common.cuh"

namespace sunerf {
namespace {

constexpr int kMaxOut = 4;        // d_out the chain kernel takes
constexpr int kTile = 128;        // dw_kernel output tile (rows and columns)
constexpr int kChunk = 32;        // points per dw_kernel step
constexpr int kTileStride = kTile + 8;
constexpr int kDptsCols = 128;    // encoding columns per K3 product
constexpr int kQuadStride = kChunk / 4 + 4;   // dw_i8_kernel staging row, 32-bit words

enum Gate : int { kGateInt8 = 0, kGateBf16 = 1, kGateLsb = 2 };

struct BwdParams {
  const float* pts;             // [n, d_in]
  const int* col_dim;           // [n_cols]
  const float* col_freq;        // [n_cols]
  const float* dy;              // [n, d_out]
  const __nv_bfloat16* hs;      // [n, L*H] bf16 sin stash ('int8', 'lsb', K4)
  const int8_t* hs8;            // 'i8pair': the int8 pairs [n, 2*L*H], else null
  const void* gate;             // layer 0's gate, int8 or bf16 (see above)
  size_t gate_ld;               // its row stride, elements
  int gate_layer;               // elements from one layer's gate to the next
  const uint2* w_h_t;           // [L-1][H/8][H/16][32] packed fragments of w_h[i]^T
  const __nv_bfloat16* w_out;   // [d_out][H]
  __nv_bfloat16* dz;            // [n, L*H] scratch
  __nv_bfloat16* enc;           // [n, e_pad] scratch
  float* part_chain;            // [n_tiles][q] per-block partials
  float* part_dw;               // [splits][p] per-split partials
  float* grad_chain;            // [q]: dW_out [H][d_out], db_out, db_j [L][H]
  float* grad_dw;               // [p]: dW_in [e_pad][H], dW_h [L-1][H][H]
  GridParams grid;              // dense grid levels (K5), or none
  const __nv_bfloat16* w_grid;  // [levels * F][H] bf16 grid rows of w_in
  float* dgrid;                 // [n, levels * F] scratch: denc_grid
  unsigned int* gmax;           // [levels] bits of max |denc_grid|, zeroed
  unsigned long long* gacc;     // [sum G^3 F] fixed-point sums, zeroed
  float* grad_grid;             // [sum G^3 F]: d_table of each level
  float* dpts;                  // K3: [n, d_in], or null
  const uint2* w_enc_t;         // K3: packed fragments of w_in[:n_enc]^T, padded
                                //     to a multiple of kDptsCols columns
  int n_enc;                    // K3: encoding columns x, sin, cos (d_in + 2 n_cols)
  float* dz_max;                // 'i8pair': [n_groups][L-1] max |dz_j|, j >= 1
  int group;                    // 'i8pair': points per dz scale group
  int n, d_in, n_cols, e_pad, h, n_hidden, d_out, splits;
  size_t q, p;
};

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

// Where a layer's gate is read: an int8 staged tile [64, H + 16], or the
// block's rows [0, last_row] of a bf16 gate in device memory, `ld` elements
// apart.
struct GateRef {
  const void* base;
  size_t ld;
  int last_row;
};

// The gate at (row, col) of the block. bf16 rows past n read the block's
// last row: their dh is zero, so any finite gate gives dz = 0.
template <int H, int kGate>
__device__ __forceinline__ float gate_at(const GateRef& g, int row, int col) {
  if constexpr (kGate == kGateInt8) {
    return cos_dequant(static_cast<const int8_t*>(g.base)[row * (H + kCosPad) + col]);
  } else {
    const uint32_t bits = __ldg(static_cast<const unsigned short*>(g.base)
                                + static_cast<size_t>(min(row, g.last_row)) * g.ld + col);
    if constexpr (kGate == kGateBf16) return __uint_as_float(bits << 16);
    else return lsb_cos(bits);
  }
}

template <int H>
__host__ __device__ constexpr size_t chain_smem_bytes(int e_pad, int d_out) {
  return 2 * kRows * act_stride<H>(e_pad) * sizeof(__nv_bfloat16)
         + 2 * kRows * (H + kCosPad) + kRows * d_out * sizeof(float);
}

// K3's f32 staging of the encoding cotangent [64, n_enc padded + 4], laid
// over the dead gate tiles and dy after both activation buffers (either
// buffer may hold dz_0, which K3 and the copy engine still read); it may
// need more than those bytes at small widths
template <int H>
__host__ __device__ constexpr size_t chain_dpts_smem_bytes(int e_pad, int d_out, int n_enc) {
  const size_t base = chain_smem_bytes<H>(e_pad, d_out);
  const size_t need = 2 * kRows * act_stride<H>(e_pad) * sizeof(__nv_bfloat16)
      + kRows * static_cast<size_t>((n_enc + kDptsCols - 1) / kDptsCols * kDptsCols + 4)
        * sizeof(float);
  return base > need ? base : need;
}

// dst = dz = bf16(bf16(dh) * gate) from block_matmul's dh accumulators and
// the gate tile; db[col] = the column's sum over the block's 64 rows, in a
// fixed order (each thread's 8 rows, then across the 8 row groups by
// shuffles).
template <int H, int kGate>
__device__ __forceinline__ void dz_epilogue(const float (&acc)[4][H / 64][4],
                                            const GateRef& gate, __nv_bfloat16* dst,
                                            int stride, float* db) {
  constexpr int kTiles = H / 8 / kWarps;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < kTiles; ++nt) {
    const int col = (warp * kTiles + nt) * 8 + t * 2;
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = mt * 16 + g + half * 8;
        const float d0 = bf16_round(bf16_round(acc[mt][nt][2 * half])
                                    * gate_at<H, kGate>(gate, row, col));
        const float d1 = bf16_round(bf16_round(acc[mt][nt][2 * half + 1])
                                    * gate_at<H, kGate>(gate, row, col + 1));
        *reinterpret_cast<uint32_t*>(dst + row * stride + col) = pack_bf16(d0, d1);
        s0 += d0;
        s1 += d1;
      }
    }
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) {
      s0 += __shfl_xor_sync(0xffffffffu, s0, off);
      s1 += __shfl_xor_sync(0xffffffffu, s1, off);
    }
    if (g == 0) {
      db[col] = s0;
      db[col + 1] = s1;
    }
  }
}

// denc_grid[r, j] = sum_c dz_0[r, c] bf16(W_in[grid row j, c]) for the
// block's rows into p.dgrid, and each level's max |denc_grid| into p.gmax:
// max over the block, then one atomicMax on the bits (non-negative floats
// order as their bits do, NaN above infinity; any order gives the same
// max). Thread t takes row t / 4 and the columns t % 4 + 4 q, four
// independent sums over c at a time, 8 bf16 per 16-byte load, so the loads
// and products overlap (a warp per row with a shuffle tree per column left
// K2 latency-bound at one block per SM: about 1.1 ms per 8x512 field at
// N = 196,608 on an H100 80GB HBM3 at 700 W, chip_smoke.py).
template <int H>
__device__ __forceinline__ void grid_cotangent(const BwdParams& p,
                                               const __nv_bfloat16* dz0, int stride,
                                               int row0, unsigned int (*block_max)[kMaxLevels]) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r = threadIdx.x >> 2;
  const int gr = row0 + r;
  const int F = p.grid.features;
  const int n_grid = p.grid.n_levels * F;
  const __nv_bfloat16* a = dz0 + r * stride;
  unsigned int mx[kMaxLevels] = {0u, 0u, 0u, 0u};
  for (int j0 = threadIdx.x & 3; j0 < n_grid; j0 += 16) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    const __nv_bfloat16* w[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)  // columns past n_grid read the last row, unused
      w[q] = p.w_grid + static_cast<size_t>(min(j0 + 4 * q, n_grid - 1)) * H;
#pragma unroll 2
    for (int c = 0; c < H; c += 8) {
      const uint4 av = *reinterpret_cast<const uint4*>(a + c);
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
  __syncthreads();
  if (threadIdx.x < p.grid.n_levels) {
    unsigned int m = 0u;
    for (int w = 0; w < kWarps; ++w) m = max(m, block_max[w][threadIdx.x]);
    atomicMax(p.gmax + threadIdx.x, m);
  }
}

// K3, the point cotangent of the block's rows (the compute_dpts=True branch
// of _bwd_stash_kernel, and the tail of _bwd_kernel):
//   denc = dz_0 bf16(W_in[:n_enc])^T on the tensor cores (block_matmul, 128
//          encoding columns at a time, into f32 staging in shared memory),
//   dpts[r, d] = denc[r, d] + sum over the phase columns j of dimension d,
//                in order, of freq_j (cos u_j dsin_j - sin u_j dcos_j),
// u_j = x[dim_j] freq_j in f32 and its sine and cosine by the kernels'
// range-reduced polynomial (cos u = sin(u + pi/2), as in the encoding).
// Thread t takes row t / 4 and the input dimensions t % 4 + 4 k.
template <int H>
__device__ __forceinline__ void point_cotangent(const BwdParams& p, const __nv_bfloat16* dz0,
                                                int stride, int row0, float* stage) {
  const int cols = (p.n_enc + kDptsCols - 1) / kDptsCols * kDptsCols;
  const int ss = cols + 4;
  for (int c0 = 0; c0 < cols; c0 += kDptsCols) {
    float acc[4][kDptsCols / 64][4];
    block_matmul<kDptsCols>(dz0, stride, H,
                            p.w_enc_t + static_cast<size_t>(c0 / 8) * (H / 16) * 32, acc);
    for_each_pair<kDptsCols>(acc, [&](int row, int col, float v0, float v1) {
      *reinterpret_cast<float2*>(stage + row * ss + c0 + col) = make_float2(v0, v1);
    });
  }
  __syncthreads();
  const int r = threadIdx.x >> 2;
  const int gr = row0 + r;
  if (gr >= p.n) return;
  const int D = p.d_in;
  const float* x = p.pts + static_cast<size_t>(gr) * D;
  const float* denc = stage + r * ss;
  for (int d = threadIdx.x & 3; d < D; d += 4) {
    float s = 0.f;
    for (int j = 0; j < p.n_cols; ++j) {
      if (p.col_dim[j] != d) continue;
      const float f = p.col_freq[j];
      const float u = __fmul_rn(x[d], f);
      const float du = __fsub_rn(__fmul_rn(fast_sin(__fadd_rn(u, kHalfPi)), denc[D + j]),
                                 __fmul_rn(fast_sin(u), denc[D + p.n_cols + j]));
      s = __fadd_rn(s, __fmul_rn(du, f));
    }
    p.dpts[static_cast<size_t>(gr) * D + d] = __fadd_rn(denc[d], s);
  }
}

template <int H, int kGate, bool kDpts>
__global__ void __launch_bounds__(kThreads, 1) chain_kernel(BwdParams p) {
  constexpr bool kStaged = kGate == kGateInt8;
  constexpr int kCosStride = H + kCosPad;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned int block_max[kWarps][kMaxLevels];  // grid levels only
  const int stride = act_stride<H>(p.e_pad);
  __nv_bfloat16* cur = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* nxt = cur + kRows * stride;
  // two int8 gate staging tiles: gate j lands in tile j % 2
  int8_t* cq_tiles = reinterpret_cast<int8_t*>(nxt + kRows * stride);
  auto cq = [&](int j) { return cq_tiles + (j & 1) * kRows * kCosStride; };
  float* sdy = reinterpret_cast<float*>(cq_tiles + 2 * kRows * kCosStride);
  const int L = p.n_hidden + 1;
  const int row0 = blockIdx.x * kRows;
  const size_t ld = static_cast<size_t>(L) * H;
  const int d_out = p.d_out;
  float* part = p.part_chain + blockIdx.x * p.q;
  float* part_db = part + d_out * H + d_out;
  const int8_t* gate8 = static_cast<const int8_t*>(p.gate);
  auto load_gate_async = [&](int j) {
    load_rows_async(gate8 + static_cast<size_t>(j) * p.gate_layer, p.gate_ld, cq(j),
                    kCosStride, H, row0, p.n);
  };
  auto gate = [&](int j) -> GateRef {
    if constexpr (kStaged) {
      return {cq(j), static_cast<size_t>(kCosStride), kRows - 1};
    } else {
      return {static_cast<const __nv_bfloat16*>(p.gate) + static_cast<size_t>(row0) * p.gate_ld
                  + static_cast<size_t>(j) * p.gate_layer,
              p.gate_ld, min(kRows, p.n - row0) - 1};
    }
  };

  encode_tile(p.pts, p.col_dim, p.col_freq, p.grid, p.n, p.d_in, p.n_cols, p.e_pad,
              row0, cur, stride);
  for (int idx = threadIdx.x; idx < kRows * d_out; idx += kThreads) {
    const int gr = row0 + idx / d_out;
    sdy[idx] = gr < p.n ? p.dy[static_cast<size_t>(row0) * d_out + idx] : 0.f;
  }
  if constexpr (kStaged)
    load_rows(gate8 + static_cast<size_t>(L - 1) * p.gate_layer, p.gate_ld, cq(L - 1),
              kCosStride, H, row0, p.n);
  if (p.hs8 != nullptr) {
    // 'i8pair': hs_{L-1} is bf16(bf16(q) * bf16(1/127)) of the int8 sin
    const int8_t* src = p.hs8 + static_cast<size_t>(L - 1) * 2 * H;
    for (int idx = threadIdx.x; idx < kRows * H; idx += kThreads) {
      const int r = idx / H;
      const int c = idx - r * H;
      const float v = row0 + r < p.n
          ? cos_dequant(src[static_cast<size_t>(row0 + r) * 2 * ld + c]) : 0.f;
      nxt[r * stride + c] = __float2bfloat16_rn(v);
    }
  } else {
    load_rows(p.hs + (L - 1) * H, ld * 2, nxt, stride * 2, H * 2, row0, p.n);
  }
  __syncthreads();
  store_rows(cur, stride * 2, p.enc, static_cast<size_t>(p.e_pad) * 2, p.e_pad * 2,
             row0, p.n);

  // dW_out = hs_{L-1}^T bf16(dy) and db_out = sum(dy) over this block's rows
  // (rows past n load as zeros)
  for (int m = threadIdx.x; m < H; m += kThreads) {
    float acc[kMaxOut] = {0.f, 0.f, 0.f, 0.f};
    for (int r = 0; r < kRows; ++r) {
      const float hv = __bfloat162float(nxt[r * stride + m]);
#pragma unroll
      for (int o = 0; o < kMaxOut; ++o)
        if (o < d_out) acc[o] += hv * bf16_round(sdy[r * d_out + o]);
    }
    for (int o = 0; o < d_out; ++o) part[m * d_out + o] = acc[o];
  }
  if (threadIdx.x < d_out) {
    float s = 0.f;
    for (int r = 0; r < kRows; ++r) s += sdy[r * d_out + threadIdx.x];
    part[d_out * H + threadIdx.x] = s;
  }
  __syncthreads();  // the encoding is stored out of cur, hs_{L-1} read out of nxt

  // the next int8 gate in flight while dz_{L-1} is computed
  if (kStaged && L > 1) load_gate_async(L - 2);
  // dz_{L-1} = bf16(bf16(dh) * gate), dh = bf16(dy) bf16(W_out)^T (d_out
  // terms): a column per thread, summed for db_{L-1}
  const GateRef last = gate(L - 1);
  for (int c = threadIdx.x; c < H; c += kThreads) {
    float w[kMaxOut];
#pragma unroll
    for (int o = 0; o < kMaxOut; ++o)
      w[o] = o < d_out ? __bfloat162float(p.w_out[o * H + c]) : 0.f;
    float s = 0.f;
    for (int r = 0; r < kRows; ++r) {
      float dh = 0.f;
      for (int o = 0; o < d_out; ++o) dh += bf16_round(sdy[r * d_out + o]) * w[o];
      const float dz = bf16_round(bf16_round(dh) * gate_at<H, kGate>(last, r, c));
      cur[r * stride + c] = __float2bfloat16_rn(dz);
      s += dz;
    }
    part_db[(L - 1) * H + c] = s;
  }
  cp_async_wait_all();
  fence_proxy_async();
  __syncthreads();

  // One barrier an iteration. Before it: this thread's gate copies for the
  // next iteration have landed, and its bulk copy of dz_j has read cur,
  // which the next iteration's epilogue overwrites.
  for (int j = L - 1; j > 0; --j) {
    // cur holds dz_j: the copy engine stores it for the dW products while
    // the warps carry the chain on, with the int8 gate after next in flight
    store_rows_bulk(cur, stride * 2, p.dz + j * H, ld * 2, H * 2, row0, p.n);
    if (kStaged && j >= 2) load_gate_async(j - 2);
    float acc[4][H / 64][4];
    block_matmul<H>(cur, stride, H,
                    p.w_h_t + static_cast<size_t>(j - 1) * (H / 8) * (H / 16) * 32, acc);
    dz_epilogue<H, kGate>(acc, gate(j - 1), nxt, stride, part_db + (j - 1) * H);
    cp_async_wait_all();
    bulk_wait_read();
    fence_proxy_async();
    __syncthreads();
    __nv_bfloat16* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
  store_rows_bulk(cur, stride * 2, p.dz, ld * 2, H * 2, row0, p.n);  // dz_0
  if (p.grid.n_levels > 0) grid_cotangent<H>(p, cur, stride, row0, block_max);
  // K3 reads dz_0 out of cur beside the copy engine and stages after both
  // activation buffers
  if constexpr (kDpts)
    point_cotangent<H>(p, cur, stride, row0, reinterpret_cast<float*>(cq_tiles));
  bulk_wait();
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

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* ptr) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// One 32-point chunk of an operand, [kChunk, kTile] bf16 starting at column
// col0 of a row-major [n, *] matrix: two 16-byte vectors per thread, zero
// past row end and past column width.
__device__ __forceinline__ void load_chunk(uint4 (&v)[2], const __nv_bfloat16* src,
                                           size_t ld, int p0, int end, int col0,
                                           int width) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int r = idx >> 4;
    const int col = col0 + (idx & 15) * 8;
    v[i] = make_uint4(0u, 0u, 0u, 0u);
    if (p0 + r < end && col < width)
      v[i] = *reinterpret_cast<const uint4*>(src + static_cast<size_t>(p0 + r) * ld + col);
  }
}

__device__ __forceinline__ void stage_chunk(const uint4 (&v)[2],
                                            __nv_bfloat16 (*dst)[kTileStride]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    *reinterpret_cast<uint4*>(&dst[idx >> 4][(idx & 15) * 8]) = v[i];
  }
}

// part_dw[split][job] = A_job^T B_job over the split's points, per 128x128
// tile: job 0 is dW_in (A = enc, B = dz_0), job j >= 1 is dW_h[j-1]
// (A = hs_{j-1}, B = dz_j).
__global__ void __launch_bounds__(kThreads) dw_kernel(BwdParams p, int pts_per_split) {
  __shared__ __align__(16) __nv_bfloat16 sa[2][kChunk][kTileStride];
  __shared__ __align__(16) __nv_bfloat16 sb[2][kChunk][kTileStride];
  const int H = p.h;
  const int job = blockIdx.z;
  const size_t ld = static_cast<size_t>(p.n_hidden + 1) * H;
  const __nv_bfloat16* a;
  size_t lda;
  int m_rows;
  float* out = p.part_dw + blockIdx.y * p.p;
  if (job == 0) {
    a = p.enc;
    lda = p.e_pad;
    m_rows = p.e_pad;
  } else {
    a = p.hs + (job - 1) * H;
    lda = ld;
    m_rows = H;
    out += static_cast<size_t>(p.e_pad) * H + static_cast<size_t>(job - 1) * H * H;
  }
  const __nv_bfloat16* b = p.dz + job * H;
  const int n_ct = (H + kTile - 1) / kTile;
  const int m0 = (blockIdx.x / n_ct) * kTile;
  const int c0 = (blockIdx.x % n_ct) * kTile;
  if (m0 >= m_rows) return;
  const int begin = blockIdx.y * pts_per_split;
  const int end = min(p.n, begin + pts_per_split);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wm = warp & 3;   // 32 output rows each
  const int wc = warp >> 2;  // 64 output columns each
  float acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][j][k] = 0.f;

  uint4 va[2], vb[2];
  int buf = 0;
  if (begin < end) {
    load_chunk(va, a, lda, begin, end, m0, m_rows);
    load_chunk(vb, b, ld, begin, end, c0, H);
    stage_chunk(va, sa[0]);
    stage_chunk(vb, sb[0]);
  }
  __syncthreads();
  for (int p0 = begin; p0 < end; p0 += kChunk) {
    const bool more = p0 + kChunk < end;
    if (more) {
      load_chunk(va, a, lda, p0 + kChunk, end, m0, m_rows);
      load_chunk(vb, b, ld, p0 + kChunk, end, c0, H);
    }
#pragma unroll
    for (int ks = 0; ks < kChunk / 16; ++ks) {
      uint32_t af[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int k = ks * 16 + (lane & 7) + (lane >> 4) * 8;
        const int m = wm * 32 + mt * 16 + ((lane >> 3) & 1) * 8;
        ldsm_x4_trans(af[mt], &sa[buf][k][m]);
      }
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        const int k = ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        const int c = wc * 64 + np * 16 + (lane >> 4) * 8;
        uint32_t r[4];
        ldsm_x4_trans(r, &sb[buf][k][c]);
        const uint2 b0 = make_uint2(r[0], r[1]);
        const uint2 b1 = make_uint2(r[2], r[3]);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_bf16(acc[mt][2 * np], af[mt], b0);
          mma_bf16(acc[mt][2 * np + 1], af[mt], b1);
        }
      }
    }
    if (more) {
      stage_chunk(va, sa[buf ^ 1]);
      stage_chunk(vb, sb[buf ^ 1]);
    }
    __syncthreads();
    buf ^= 1;
  }

  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int row = m0 + wm * 32 + mt * 16 + g;
      const int col = c0 + wc * 64 + nt * 8 + t * 2;
      if (col >= H) continue;
      if (row < m_rows)
        *reinterpret_cast<float2*>(out + static_cast<size_t>(row) * H + col) =
            make_float2(acc[mt][nt][0], acc[mt][nt][1]);
      if (row + 8 < m_rows)
        *reinterpret_cast<float2*>(out + static_cast<size_t>(row + 8) * H + col) =
            make_float2(acc[mt][nt][2], acc[mt][nt][3]);
    }
  }
}

// 'i8pair': dz_max[g][j-1] = max |dz_j| over the rows of group g (points
// [g G, (g+1) G) below n), j = 1..L-1; bf16 magnitudes order as their bits.
__global__ void dz_absmax_kernel(BwdParams p) {
  __shared__ unsigned int warp_max[32];
  const int g = blockIdx.x;
  const int j = blockIdx.y + 1;
  const int H = p.h;
  const size_t ld = static_cast<size_t>(p.n_hidden + 1) * H;
  const int begin = g * p.group;
  const int rows = min(p.n, begin + p.group) - begin;
  const int vecs = H / 8;
  unsigned int m = 0u;
  for (int idx = threadIdx.x; idx < rows * vecs; idx += blockDim.x) {
    const int r = begin + idx / vecs;
    const int v = idx % vecs;
    const uint4 w = *reinterpret_cast<const uint4*>(p.dz + static_cast<size_t>(r) * ld
                                                    + j * H + v * 8);
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
// g of G points (any G >= 1 with G 127^2 < 2^31; splits a multiple of G), with
// m = dz_max[g][j-1], scale = 127 / m (0 when m = 0) and
// dz8 = round_half_even(dz_j scale),
//   dW_h[j-1] += f32(sum over g's points of sin8_{j-1} (x) dz8, int32)
//                * (m * f32((1/127)^2))
// with the groups of a split in order. 128x128 output tiles as dw_kernel;
// each 32-point chunk is staged transposed (points contiguous, 4 to a
// 32-bit word) for mma.sync m16n8k32 s8.s8.s32; the int32 sums are exact
// (G 127^2 < 2^31), so kernel and plain version differ only in the f32
// order across groups and splits.
__global__ void __launch_bounds__(kThreads) dw_i8_kernel(BwdParams p, int pts_per_split) {
  __shared__ uint32_t sa[kTile][kQuadStride];   // [m][point quad]: sin8
  __shared__ uint32_t sb[kTile][kQuadStride];   // [n][point quad]: dz8
  const int H = p.h;
  const int j = blockIdx.z + 1;
  const size_t ld = static_cast<size_t>(p.n_hidden + 1) * H;
  const int n_ct = (H + kTile - 1) / kTile;
  const int m0 = (blockIdx.x / n_ct) * kTile;
  const int c0 = (blockIdx.x % n_ct) * kTile;
  float* out = p.part_dw + blockIdx.y * p.p + static_cast<size_t>(p.e_pad) * H
               + static_cast<size_t>(j - 1) * H * H;
  const int begin = blockIdx.y * pts_per_split;
  const int end = min(p.n, begin + pts_per_split);
  const int8_t* a = p.hs8 + static_cast<size_t>(j - 1) * 2 * H;
  const __nv_bfloat16* b = p.dz + static_cast<size_t>(j) * H;
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
  for (int p0 = begin; p0 < end; p0 += kChunk) {
    const int c_end = min(p0 + kChunk, end);
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
      if (pt < c_end && c0 + 4 * lane < H)
        raw[i] = *reinterpret_cast<const uint2*>(b + static_cast<size_t>(pt) * ld
                                                 + c0 + 4 * lane);
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

template <int H, int kGate, bool kDpts>
cudaError_t launch_chain(const BwdParams& p, cudaStream_t stream) {
  const size_t smem = kDpts ? chain_dpts_smem_bytes<H>(p.e_pad, p.d_out, p.n_enc)
                            : chain_smem_bytes<H>(p.e_pad, p.d_out);
  cudaError_t err = cudaFuncSetAttribute(
      chain_kernel<H, kGate, kDpts>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.n + kRows - 1) / kRows);
  chain_kernel<H, kGate, kDpts><<<grid, kThreads, smem, stream>>>(p);
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

// p.q, p.p from the shapes
inline void set_sizes(BwdParams& p) {
  const int L = p.n_hidden + 1;
  p.q = static_cast<size_t>(p.d_out) * p.h + p.d_out + static_cast<size_t>(L) * p.h;
  p.p = static_cast<size_t>(p.e_pad) * p.h + static_cast<size_t>(p.n_hidden) * p.h * p.h;
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

  const int m_tiles = ((p.h > p.e_pad ? p.h : p.e_pad) + kTile - 1) / kTile;
  const int c_tiles = (p.h + kTile - 1) / kTile;
  const int chunk = (n + p.splits - 1) / p.splits;
  int pts_per_split = (chunk + kChunk - 1) / kChunk * kChunk;
  if (p.hs8 != nullptr) {
    // 'i8pair': each group's scale, then splits of whole groups
    const int n_groups = (n + p.group - 1) / p.group;
    if (L > 1) {
      dz_absmax_kernel<<<dim3(n_groups, L - 1), 256, 0, s>>>(p);
      err = cudaGetLastError();
      if (err != cudaSuccess) return err;
    }
    pts_per_split = (pts_per_split + p.group - 1) / p.group * p.group;
    dw_kernel<<<dim3(m_tiles * c_tiles, p.splits, 1), kThreads, 0, s>>>(p, pts_per_split);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    if (L > 1) {
      dw_i8_kernel<<<dim3(c_tiles * c_tiles, p.splits, L - 1), kThreads, 0, s>>>(
          p, pts_per_split);
      err = cudaGetLastError();
      if (err != cudaSuccess) return err;
    }
  } else {
    dw_kernel<<<dim3(m_tiles * c_tiles, p.splits, L), kThreads, 0, s>>>(p, pts_per_split);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }

  const int n_tiles = (n + kRows - 1) / kRows;
  err = launch_reduce(p.part_chain, n_tiles, p.q, p.grad_chain, accumulate, s);
  if (err != cudaSuccess) return err;
  return launch_reduce(p.part_dw, p.splits, p.p, p.grad_dw, accumulate, s);
}

}  // namespace
}  // namespace sunerf
