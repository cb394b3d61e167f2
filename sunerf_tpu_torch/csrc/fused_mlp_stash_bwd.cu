// Stashing backward of the fused posenc + Sine MLP for Hopper (sm_90a): K2.
//
// Replaces the TPU kernel sunerf_tpu/ops/pallas/fused_mlp.py:_bwd_stash_kernel
// with fmt='int8' and compute_dpts=False (the training backward; pallas_call
// in _fused_mlp_stash_bwd). Same function, with its roundings: from dy
// [N, d_out] and K1's stashes hs (bf16 sin) and cs (int8 cos x 127),
//   dW_out = hs_{L-1}^T bf16(dy),  db_out = sum(dy)                  (f32)
//   dh     = bf16(dy) bf16(W_out)^T
//   for j = L-1 .. 0:
//     dz_j = bf16(bf16(dh) * bf16(bf16(cs_j) * bf16(1/127)))
//     db_j = sum over points of dz_j (f32)
//     dW_j = hs_{j-1}^T dz_j for j >= 1 (the hidden layers),
//            bf16(enc)^T dz_0 for j = 0 (enc recomputed from the points
//            as K0 computes it)
//     dh   = dz_j bf16(W_h[j-1])^T for j >= 1
// every product with bf16 operands and f32 accumulation. The point
// cotangent (compute_dpts=True, K3) is not computed: the renderer detaches
// its sample points.
//
// Bound on this card: operations. Per point at 8x512: 4*7*512^2 flop for
// dW_h and dh, 2*84*512 for dW_in, 2*2*2*512 for dW_out and the first dh;
// 7.43 Mflop, 1.477 ms at the fine step's N = 196,608 at 989 TFLOP/s bf16
// dense, against 0.722 ms to read the stashes at 3.35 TB/s.
//
// Design. On the TPU the grid runs in order and every dW accumulates in VMEM
// across it (7.3 MB of f32 for dW_h alone at 8x512), flushed once. On Hopper
// blocks run in parallel and no block can hold the dW, so the backward is
// four launches:
//   1. chain_kernel: K0's block layout (64 points, 8 warps, mma.sync against
//      W_h^T packed in fragment order by the wrapper). It carries the
//      row-parallel chain dy -> dh -> dz_{L-1} -> dh -> ... -> dz_0 with dz in
//      shared memory. Each cs tile lands in one of two staging tiles by
//      cp.async while the warps run the previous product (so a layer takes
//      one barrier, as in K0), and each dz_j goes to a scratch
//      [N, L*H] (1.6 GB at the fine shapes) by the bulk-copy (TMA) engine,
//      so neither stalls the warps (one block fills an SM); both streams
//      carry an L2 evict-first policy, so W_h^T, re-read by every block,
//      stays in L2 (9.12 -> 8.06 ms for the whole backward at the fine N on
//      an H100, chip_smoke.py). It also writes
//      the recomputed bf16 encoding to a scratch [N, E_pad], and per block
//      f32 partials of dW_out, db_out (hs_{L-1} staged into the second
//      activation buffer) and every db_j over its 64 points (the column
//      sums taken in the epilogue, by shuffles).
//   2. dw_kernel: each dW as a product contracting over the points, split
//      over the points into `splits` ranges with f32 partials per split.
//      128x128 output tiles, 32-point chunks staged through shared memory
//      (double-buffered through registers), fragments read with
//      ldmatrix.trans, mma.sync bf16 -> f32. Blocks of one point range run
//      side by side, so each chunk of hs and dz comes from device memory
//      about once and from L2 for the other tiles.
//   3, 4. reduce_kernel: the partials summed over blocks and splits in a
//      fixed order, so a run gives the same bits as the last; no atomics.
// Rows past N are masked in every kernel: they load as zeros and are never
// stored. wgmma, TMA and a fused dW epilogue are left for later work.

#include "fused_mlp_common.cuh"

namespace sunerf {
namespace {

constexpr int kMaxOut = 4;        // d_out the chain kernel takes
constexpr int kTile = 128;        // dw_kernel output tile (rows and columns)
constexpr int kChunk = 32;        // points per dw_kernel step
constexpr int kTileStride = kTile + 8;

struct BwdParams {
  const float* pts;             // [n, d_in]
  const int* col_dim;           // [n_cols]
  const float* col_freq;        // [n_cols]
  const float* dy;              // [n, d_out]
  const __nv_bfloat16* hs;      // [n, L*H] sin stash
  const int8_t* cs;             // [n, L*H] int8 cos stash
  const uint2* w_h_t;           // [L-1][H/8][H/16][32] packed fragments of w_h[i]^T
  const __nv_bfloat16* w_out;   // [d_out][H]
  __nv_bfloat16* dz;            // [n, L*H] scratch
  __nv_bfloat16* enc;           // [n, e_pad] scratch
  float* part_chain;            // [n_tiles][q] per-block partials
  float* part_dw;               // [splits][p] per-split partials
  float* grad_chain;            // [q]: dW_out [H][d_out], db_out, db_j [L][H]
  float* grad_dw;               // [p]: dW_in [e_pad][H], dW_h [L-1][H][H]
  int n, d_in, n_cols, e_pad, h, n_hidden, d_out, splits;
  size_t q, p;
};

// bf16(bf16(q) * bf16(1/127)): the TPU kernel's dequantized cos
__device__ __forceinline__ float cos_dequant(int8_t q) {
  const float inv = __bfloat162float(__float2bfloat16_rn(1.0f / kCosScale));
  return bf16_round(static_cast<float>(q) * inv);
}

template <int H>
__host__ __device__ constexpr size_t chain_smem_bytes(int e_pad, int d_out) {
  return 2 * kRows * act_stride<H>(e_pad) * sizeof(__nv_bfloat16)
         + 2 * kRows * (H + kCosPad) + kRows * d_out * sizeof(float);
}

// dst = dz = bf16(bf16(dh) * cos) from block_matmul's dh accumulators and
// the cos tile; db[col] = the column's sum over the block's 64 rows, in a
// fixed order (each thread's 8 rows, then across the 8 row groups by
// shuffles).
template <int H>
__device__ __forceinline__ void dz_epilogue(const float (&acc)[4][H / 64][4],
                                            const int8_t* cq, __nv_bfloat16* dst,
                                            int stride, float* db) {
  constexpr int kTiles = H / 8 / kWarps;
  constexpr int kCosStride = H + kCosPad;
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
                                    * cos_dequant(cq[row * kCosStride + col]));
        const float d1 = bf16_round(bf16_round(acc[mt][nt][2 * half + 1])
                                    * cos_dequant(cq[row * kCosStride + col + 1]));
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

template <int H>
__global__ void __launch_bounds__(kThreads, 1) chain_kernel(BwdParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int stride = act_stride<H>(p.e_pad);
  constexpr int kCosStride = H + kCosPad;
  __nv_bfloat16* cur = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* nxt = cur + kRows * stride;
  // two int8 cos staging tiles: cs_j lands in tile j % 2
  int8_t* cq_tiles = reinterpret_cast<int8_t*>(nxt + kRows * stride);
  auto cq = [&](int j) { return cq_tiles + (j & 1) * kRows * kCosStride; };
  float* sdy = reinterpret_cast<float*>(cq_tiles + 2 * kRows * kCosStride);
  const int L = p.n_hidden + 1;
  const int row0 = blockIdx.x * kRows;
  const size_t ld = static_cast<size_t>(L) * H;
  const int d_out = p.d_out;
  float* part = p.part_chain + blockIdx.x * p.q;
  float* part_db = part + d_out * H + d_out;

  encode_tile(p.pts, p.col_dim, p.col_freq, p.n, p.d_in, p.n_cols, p.e_pad, row0,
              cur, stride);
  for (int idx = threadIdx.x; idx < kRows * d_out; idx += kThreads) {
    const int gr = row0 + idx / d_out;
    sdy[idx] = gr < p.n ? p.dy[static_cast<size_t>(row0) * d_out + idx] : 0.f;
  }
  load_rows(p.cs + (L - 1) * H, ld, cq(L - 1), kCosStride, H, row0, p.n);
  load_rows(p.hs + (L - 1) * H, ld * 2, nxt, stride * 2, H * 2, row0, p.n);
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

  // the next cos tile in flight while dz_{L-1} is computed
  if (L > 1) load_rows_async(p.cs + (L - 2) * H, ld, cq(L - 2), kCosStride, H, row0, p.n);
  // dz_{L-1} = bf16(bf16(dh) * cos), dh = bf16(dy) bf16(W_out)^T (d_out
  // terms): a column per thread, summed for db_{L-1}
  for (int c = threadIdx.x; c < H; c += kThreads) {
    float w[kMaxOut];
#pragma unroll
    for (int o = 0; o < kMaxOut; ++o)
      w[o] = o < d_out ? __bfloat162float(p.w_out[o * H + c]) : 0.f;
    float s = 0.f;
    for (int r = 0; r < kRows; ++r) {
      float dh = 0.f;
      for (int o = 0; o < d_out; ++o) dh += bf16_round(sdy[r * d_out + o]) * w[o];
      const float dz = bf16_round(bf16_round(dh) * cos_dequant(cq(L - 1)[r * kCosStride + c]));
      cur[r * stride + c] = __float2bfloat16_rn(dz);
      s += dz;
    }
    part_db[(L - 1) * H + c] = s;
  }
  cp_async_wait_all();
  fence_proxy_async();
  __syncthreads();

  // One barrier an iteration. Before it: this thread's cos copies for the
  // next iteration have landed, and its bulk copy of dz_j has read cur,
  // which the next iteration's epilogue overwrites.
  for (int j = L - 1; j > 0; --j) {
    // cur holds dz_j: the copy engine stores it for the dW products while
    // the warps carry the chain on, with the cos tile after next in flight
    store_rows_bulk(cur, stride * 2, p.dz + j * H, ld * 2, H * 2, row0, p.n);
    if (j >= 2) load_rows_async(p.cs + (j - 2) * H, ld, cq(j - 2), kCosStride, H, row0, p.n);
    float acc[4][H / 64][4];
    block_matmul<H>(cur, stride, H,
                    p.w_h_t + static_cast<size_t>(j - 1) * (H / 8) * (H / 16) * 32, acc);
    dz_epilogue<H>(acc, cq(j - 1), nxt, stride, part_db + (j - 1) * H);
    cp_async_wait_all();
    bulk_wait_read();
    fence_proxy_async();
    __syncthreads();
    __nv_bfloat16* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
  store_rows_bulk(cur, stride * 2, p.dz, ld * 2, H * 2, row0, p.n);  // dz_0
  bulk_wait();
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

cudaError_t launch_reduce(const float* part, int S, size_t P, float* out,
                          cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((P + 31) / 32));
  reduce_kernel<<<grid, dim3(32, 8), 0, stream>>>(part, S, P, out);
  return cudaGetLastError();
}

template <int H>
cudaError_t launch_chain(const BwdParams& p, cudaStream_t stream) {
  const size_t smem = chain_smem_bytes<H>(p.e_pad, p.d_out);
  cudaError_t err = cudaFuncSetAttribute(
      chain_kernel<H>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.n + kRows - 1) / kRows);
  chain_kernel<H><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace
}  // namespace sunerf

// C entry, bound with ctypes: the four launches of one backward on `stream`.
// Returns a cudaError_t (0 = launched).
extern "C" int sunerf_fused_mlp_stash_bwd(
    const void* pts, const void* col_dim, const void* col_freq, const void* dy,
    const void* hs, const void* cs, const void* w_h_t, const void* w_out,
    void* dz, void* enc, void* part_chain, void* part_dw, void* grad_chain,
    void* grad_dw, int n, int d_in, int n_cols, int e_pad, int d_filter,
    int n_hidden, int d_out, int splits, void* stream) {
  using namespace sunerf;
  if (n <= 0 || e_pad % 16 != 0 || e_pad < d_in + 2 * n_cols || d_out < 1 ||
      d_out > kMaxOut || splits < 1 || n_hidden < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  BwdParams p;
  p.pts = static_cast<const float*>(pts);
  p.col_dim = static_cast<const int*>(col_dim);
  p.col_freq = static_cast<const float*>(col_freq);
  p.dy = static_cast<const float*>(dy);
  p.hs = static_cast<const __nv_bfloat16*>(hs);
  p.cs = static_cast<const int8_t*>(cs);
  p.w_h_t = static_cast<const uint2*>(w_h_t);
  p.w_out = static_cast<const __nv_bfloat16*>(w_out);
  p.dz = static_cast<__nv_bfloat16*>(dz);
  p.enc = static_cast<__nv_bfloat16*>(enc);
  p.part_chain = static_cast<float*>(part_chain);
  p.part_dw = static_cast<float*>(part_dw);
  p.grad_chain = static_cast<float*>(grad_chain);
  p.grad_dw = static_cast<float*>(grad_dw);
  p.n = n;
  p.d_in = d_in;
  p.n_cols = n_cols;
  p.e_pad = e_pad;
  p.h = d_filter;
  p.n_hidden = n_hidden;
  p.d_out = d_out;
  p.splits = splits;
  const int L = n_hidden + 1;
  p.q = static_cast<size_t>(d_out) * d_filter + d_out + static_cast<size_t>(L) * d_filter;
  p.p = static_cast<size_t>(e_pad) * d_filter
        + static_cast<size_t>(n_hidden) * d_filter * d_filter;
  cudaStream_t s = static_cast<cudaStream_t>(stream);

  cudaError_t err;
  switch (d_filter) {
    case 64: err = launch_chain<64>(p, s); break;
    case 128: err = launch_chain<128>(p, s); break;
    case 256: err = launch_chain<256>(p, s); break;
    case 384: err = launch_chain<384>(p, s); break;
    case 512: err = launch_chain<512>(p, s); break;
    default: err = cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return static_cast<int>(err);

  const int m_tiles = ((d_filter > e_pad ? d_filter : e_pad) + kTile - 1) / kTile;
  const int c_tiles = (d_filter + kTile - 1) / kTile;
  const int chunk = (n + splits - 1) / splits;
  const int pts_per_split = (chunk + kChunk - 1) / kChunk * kChunk;
  dw_kernel<<<dim3(m_tiles * c_tiles, splits, L), kThreads, 0, s>>>(p, pts_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const int n_tiles = (n + kRows - 1) / kRows;
  err = launch_reduce(p.part_chain, n_tiles, p.q, p.grad_chain, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_reduce(p.part_dw, splits, p.p, p.grad_dw, s));
}
