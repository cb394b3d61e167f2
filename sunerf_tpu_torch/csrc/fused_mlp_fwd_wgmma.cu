// Fused positional encoding + Sine MLP forward for Hopper (sm_90a) by
// wgmma: K0, the no-grad forward of every render.
//
// Replaces the TPU kernel sunerf_tpu/ops/pallas/fused_mlp.py:_fwd_kernel
// (pallas_call :410, the custom_vjp primal that serves every no-grad
// render). Same function:
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
// from the float32 tables (grid_feature in fused_mlp_common.cuh). It
// replaces the port's mma.sync K0, whose body, fused_mlp_fwd_kernel in
// fused_mlp_common.cuh, stays as K1's, K6a's, K6b's and K4's forward.
//
// Bound on this card: operations, 2 N H (E + (L-1) H + d_out) flop on the
// bf16 tensor cores (0.934 ms at 8x512, N = 245,760). What held the
// mma.sync kernel at 3.3 ms (H100 80GB HBM3, 700 W): mma.sync and a synchronous chunk loop that
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
//     zeros and are never stored.
// What holds it above the bound: between a layer's products and the next
// layer's, the epilogue's 128 range-reduced sines a thread run on the CUDA
// cores while the tensor cores wait (at 8x512, N = 245,760: 1.0e9 sines of
// ~12 float instructions, 0.36 ms at the 67 TFLOP/s float32 peak,
// against the products' 0.934 ms), and the 3.77 MB of weights that every
// 64-point tile streams from L2.

#include "fused_mlp_common.cuh"
#include "hopper.cuh"

namespace {

namespace hp = sunerf::hopper;

constexpr int kRows = 64;             // points per tile
constexpr int kKC = 32;               // weight rows (k) per ring chunk
constexpr int kConsumerWarps = 8;     // two warpgroups
constexpr int kConsumers = kConsumerWarps * 32;
constexpr int kThreads = kConsumers + 32;   // + the producer warp
constexpr int kMaxStages = 32;
constexpr int kBarBytes = 1024;       // the barriers, before the buffers
constexpr int kRowGroups = kRows / 8; // core matrices along M of an activation
constexpr size_t kSmemLimit = 232448; // a block's shared memory on sm_90
constexpr int kHeadN = 8;             // the head's wgmma width: d_out up to 8, padded

struct Params {
  const float* pts;          // [n, d_in]
  const int* col_dim;        // [n_cols]
  const float* col_freq;     // [n_cols]
  const __nv_bfloat16* w;    // [chunks][32 x H]: pack_wgmma's ring chunks, the head's last
  const float* b_in;         // [H]
  const float* b_h;          // [L-1][H]
  const float* b_out;        // [d_out]
  float* out;                // [n, d_out]
  sunerf::GridParams grid;
  int n, d_in, n_cols, n_hidden, d_out;
  int k_in;                  // the input layer's rows: e_pad rounded up to 32
  int act_k;                 // activation buffer width: max(H, k_in)
  int stages;                // ring stages
  int resident;              // 1: every chunk of the weights has its own stage
};

// The tile's encoding [x, sin u, cos u, grid features, zeros] as bf16 into
// the activation buffer (K-major layout), as fused_mlp_common.cuh
// encode_tile computes it: consumer thread t takes row t % 64 and a quarter
// of each kind of column (t / 64 + 4 i), reading its point's coordinates
// through L1; each phase u gives its sin and its cos column.
__device__ __forceinline__ void encode(const Params& p, int row0, __nv_bfloat16* dst) {
  const int r = threadIdx.x & (kRows - 1);
  const int part = threadIdx.x / kRows;
  constexpr int kParts = kConsumers / kRows;
  const int gr = row0 + r;
  const bool valid = gr < p.n;
  const float* xp = p.pts + static_cast<size_t>(valid ? gr : 0) * p.d_in;
  auto put = [&](int c, float v) { dst[hp::core_offset(r, c, kRowGroups)] = __float2bfloat16_rn(v); };
  if (part == 0)
    for (int a = 0; a < p.d_in; ++a) put(a, valid ? __ldg(xp + a) : 0.f);
  const int sin0 = p.d_in, cos0 = p.d_in + p.n_cols, grid0 = p.d_in + 2 * p.n_cols;
#pragma unroll 4
  for (int j = part; j < p.n_cols; j += kParts) {
    const float u = __fmul_rn(__ldg(xp + __ldg(p.col_dim + j)), __ldg(p.col_freq + j));
    // cos(u) = sin(u + pi/2), as the TPU kernel's fast_cos
    put(sin0 + j, valid ? sunerf::fast_sin(u) : 0.f);
    put(cos0 + j, valid ? sunerf::fast_sin(__fadd_rn(u, sunerf::kHalfPi)) : 0.f);
  }
  const int n_grid = p.grid.n_levels * p.grid.features;
  for (int j = part; j < n_grid; j += kParts)
    put(grid0 + j, valid ? sunerf::grid_feature(p.grid, j / p.grid.features, xp,
                                                j % p.grid.features) : 0.f);
  for (int c = grid0 + n_grid + part; c < p.k_in; c += kParts) put(c, 0.f);
}

__device__ __forceinline__ void release(uint64_t* empty, int lane) {
  __syncwarp();
  if (lane == 0) hp::mbar_arrive(empty);
}

template <int H>
__global__ void __launch_bounds__(kThreads, 1) fwd_wgmma_kernel(Params p) {
  constexpr int N = H / 2;                   // columns of each warpgroup
  constexpr int kChunkBytes = kKC * H * 2;
  extern __shared__ __align__(1024) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kMaxStages;
  auto* act = reinterpret_cast<__nv_bfloat16*>(smem + kBarBytes);
  unsigned char* ring = reinterpret_cast<unsigned char*>(act + kRows * p.act_k);
  const int S = p.stages;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tiles = (p.n + kRows - 1) / kRows;
  const int chunks = p.k_in / kKC + p.n_hidden * (H / kKC) + 1;   // + the head

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      hp::mbar_init(&full[s], 1);
      hp::mbar_init(&empty[s], kConsumerWarps);
    }
    hp::fence_barrier_init();
  }
  __syncthreads();

  if (warp == kConsumerWarps) {
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
    // the ring's stage and phase, and the stages of the last two chunks
    int stage = 0, phase = 0, prev1 = 0, prev2 = 0;
    for (int w = blockIdx.x; w < tiles; w += gridDim.x) {
      const int row0 = w * kRows;
      encode(p, row0, act);
      hp::fence_async_smem();
      hp::named_sync(1, kConsumers);
      const uint32_t a0 = hp::smem_u32(act);
      int i = 0;   // the chunk's index in the tile's sequence
      for (int layer = 0; layer <= p.n_hidden; ++layer) {
        const int nk = (layer == 0 ? p.k_in : H) / kKC;
        const float* bias = layer == 0 ? p.b_in : p.b_h + static_cast<size_t>(layer - 1) * H;
        float acc[N / 2] = {};
        for (int kc = 0; kc < nk; ++kc, ++i) {
          const int st = p.resident ? i : stage;
          hp::mbar_wait(&full[st], p.resident ? 0 : phase);
          const uint32_t b0 = ring0 + st * kChunkBytes + wg * (N / 8) * 128;
          hp::wgmma_fence();
#pragma unroll
          for (int s = 0; s < 2; ++s) {
            // A: k = 32 kc + 16 s, the k-group 4 kc + 2 s of the buffer;
            // B: k-groups 2 s and 2 s + 1 of the chunk, this warpgroup's N
            hp::wgmma_ss(acc, hp::make_desc(a0 + (4 * kc + 2 * s) * kRowGroups * 128,
                                            kRowGroups * 128, 128),
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
        // both warpgroups have read the layer's input: the epilogue (bias,
        // fast_sin, bf16) overwrites it with the layer's output
        hp::named_sync(1, kConsumers);
#pragma unroll
        for (int j = 0; j < N / 8; ++j) {
          const int col = wg * N + 8 * j + 2 * q;
          const float2 bb = __ldg(reinterpret_cast<const float2*>(bias + col));
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int row = w4 * 16 + g + 8 * r;
            *reinterpret_cast<uint32_t*>(act + hp::core_offset(row, col, kRowGroups)) =
                sunerf::pack_bf16(sunerf::fast_sin(acc[4 * j + 2 * r] + bb.x),
                                  sunerf::fast_sin(acc[4 * j + 2 * r + 1] + bb.y));
          }
        }
        hp::fence_async_smem();
        hp::named_sync(1, kConsumers);
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
          hp::wgmma_ss(h, hp::make_desc(a0 + 2 * s * kRowGroups * 128, kRowGroups * 128, 128),
                       hp::make_desc(b0 + 2 * s * 128, 128, 128), s > 0);
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
      // the head has read the activations before the next tile's encode
      hp::named_sync(1, kConsumers);
    }
  }
}

size_t smem_bytes(int H, int act_k, int stages) {
  return kBarBytes + static_cast<size_t>(kRows) * act_k * 2
         + static_cast<size_t>(stages) * kKC * H * 2;
}

// Raises the shared memory limit and finds how many blocks fit at once,
// once per kernel (so no attribute or occupancy call in a graph capture);
// then launches as many blocks as fit, each walking the tiles.
template <int H>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  static int max_blocks = 0;
  if (max_blocks == 0) {
    cudaError_t err = cudaFuncSetAttribute(fwd_wgmma_kernel<H>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(kSmemLimit));
    int device = 0, sms = 0, per_sm = 0;
    if (err == cudaSuccess) err = cudaGetDevice(&device);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    // one block an SM whatever the smem: the occupancy of the largest
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fwd_wgmma_kernel<H>,
                                                          kThreads, kSmemLimit);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    max_blocks = sms * per_sm;
  }
  const int tiles = (p.n + kRows - 1) / kRows;
  fwd_wgmma_kernel<H><<<tiles < max_blocks ? tiles : max_blocks, kThreads,
                        smem_bytes(H, p.act_k, p.stages), stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// C entry, bound with ctypes. pts [n, d_in] f32; col_dim, col_freq the
// posenc columns (core/encoding.py encoding_columns); w pack_wgmma's
// [chunks][32 x H] bf16; the biases f32; grid a GridParams; out [n, d_out]
// f32; e_pad the encoding's width rounded up to 16. Returns a cudaError_t
// (0 = launched).
extern "C" int sunerf_fused_mlp_fwd_wgmma(
    const void* pts, const void* col_dim, const void* col_freq, const void* w,
    const void* b_in, const void* b_h, const void* b_out, const void* grid, void* out,
    int n, int d_in, int n_cols, int e_pad, int d_filter, int n_hidden, int d_out,
    void* stream) {
  Params p;
  p.pts = static_cast<const float*>(pts);
  p.col_dim = static_cast<const int*>(col_dim);
  p.col_freq = static_cast<const float*>(col_freq);
  p.w = static_cast<const __nv_bfloat16*>(w);
  p.b_in = static_cast<const float*>(b_in);
  p.b_h = static_cast<const float*>(b_h);
  p.b_out = static_cast<const float*>(b_out);
  p.out = static_cast<float*>(out);
  p.grid = sunerf::grid_params(grid);
  p.n = n;
  p.d_in = d_in;
  p.n_cols = n_cols;
  p.n_hidden = n_hidden;
  p.d_out = d_out;
  p.k_in = (e_pad + kKC - 1) / kKC * kKC;
  p.act_k = d_filter > p.k_in ? d_filter : p.k_in;
  const size_t chunk = static_cast<size_t>(kKC) * d_filter * 2;
  const size_t fixed = smem_bytes(d_filter, p.act_k, 0);
  p.stages = fixed < kSmemLimit ? static_cast<int>((kSmemLimit - fixed) / chunk) : 0;
  if (p.stages > kMaxStages) p.stages = kMaxStages;
  const int chunks = p.k_in / kKC + n_hidden * (d_filter / kKC) + 1;
  p.resident = chunks <= p.stages;
  if (p.resident) p.stages = chunks;
  if (n <= 0 || e_pad % 16 != 0 || !sunerf::grid_ok(p.grid) || p.stages < 2 ||
      e_pad < d_in + 2 * n_cols + p.grid.n_levels * p.grid.features || d_out < 1 ||
      d_out > kHeadN)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (d_filter) {
    case 64: err = launch<64>(p, s); break;
    case 128: err = launch<128>(p, s); break;
    case 256: err = launch<256>(p, s); break;
    case 384: err = launch<384>(p, s); break;
    case 512: err = launch<512>(p, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
