// Fused positional encoding + Sine MLP forward for Hopper (sm_90a).
//
// Replaces the TPU kernel sunerf_tpu/ops/pallas/fused_mlp.py:_fwd_kernel
// (the custom_vjp primal that serves every no-grad render). Same function:
//   enc = [x, sin(u), cos(u)],  u_j = x[dim_j] * freq_j   (f32, exact: each
//         phase column has one power-of-two frequency, as _freq_matrix)
//   h   = sin(bf16(enc) @ bf16(w_in) + b_in)
//   h   = sin(bf16(h) @ bf16(w_h[i]) + b_h[i])        for i < L-1
//   out = bf16(h) @ bf16(w_out) + b_out               (f32, no base offsets)
// with bf16 operands, f32 accumulation and f32 bias and sine. Sines use the
// TPU kernel's explicit range reduction + 11th-order odd minimax polynomial
// (fast_sin): phases reach ~400 rad, where unreduced __sinf is wrong.
//
// Bound on this card: operations. 2*N*H*(E + (L-1)*H + d_out) flop on the
// bf16 tensor cores (989 TFLOP/s dense) — 3.76 Mflop per point at 8x512
// against 16 bytes of point input and 8 bytes of output, so bytes never bind.
// Design against that bound, simple first:
//   * one block of 8 warps per 64 points; two bf16 activation buffers
//     [64, max(H, E_pad) + 8] in dynamic shared memory (133 KB at H = 512)
//     hold each layer's input and output, so activations never reach device
//     memory (the TPU kernel's VMEM residency);
//   * every warp owns H/8 output columns for all 64 rows and issues
//     mma.sync m16n8k16 bf16 -> f32: each weight fragment it loads serves 4
//     row tiles, and the 128 f32 accumulators stay in registers through the
//     bias + sine epilogue;
//   * weights (3.7 MB bf16 at 8x512) are read from global memory, where they
//     stay resident in the 50 MB L2; the wrapper packs them once per field in
//     mma fragment order, so a warp's fragment load is one coalesced 256-byte
//     read, double-buffered in registers one k-step ahead;
//   * the padded row stride (H + 8 bf16) keeps the 32-bit fragment loads and
//     the epilogue stores free of bank conflicts;
//   * d_out = 2 is a per-point f32 dot product reduced across the warp;
//   * rows past N read zeros and are never stored (ragged edge masked here).
// wgmma, TMA and persistent blocks are left for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;             // points per block
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kPad = 8;               // bf16 elements of row padding
constexpr int kRowsPerWarp = kRows / kWarps;

constexpr float kTwoPi = 6.283185307179586f;
constexpr float kInvTwoPi = 0.15915494309189535f;
constexpr float kHalfPi = 1.5707963267948966f;

struct Params {
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
  int n, d_in, n_cols, e_pad, n_hidden, d_out;
};

// sin via round-based range reduction + odd minimax polynomial on [-pi, pi]
// (max abs err 9.6e-8), the coefficients of the TPU kernel's fast_sin. The
// reduction rounds 2*pi*k before subtracting (no fused multiply-add), as the
// plain version does: at |x| ~ 70 that rounding is worth ~4e-6, enough to
// flip bf16 roundings downstream.
__device__ __forceinline__ float fast_sin(float x) {
  const float y = x - __fmul_rn(kTwoPi, rintf(x * kInvTwoPi));
  const float y2 = y * y;
  return y * (9.999995999e-01f + y2 * (-1.666655263e-01f + y2 * (8.332402961e-03f
         + y2 * (-1.980863262e-04f + y2 * (2.699713829e-06f
         + y2 * -2.036221213e-08f)))));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint2 b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// One Sine layer for the block: dst[64, H] = sin(src[64, K] @ W + bias).
// W holds the packed B fragments of this layer: fragment (n-tile nt, k-step
// ks) of lane l is W[(nt * K/16 + ks) * 32 + l].
template <int H>
__device__ __forceinline__ void sine_layer(const __nv_bfloat16* src,
                                           __nv_bfloat16* dst, int stride,
                                           int k, const uint2* w,
                                           const float* bias) {
  constexpr int kTiles = H / 8 / kWarps;  // n-tiles of 8 columns per warp
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // fragment column pair
  const int k_steps = k / 16;

  float acc[4][kTiles][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < kTiles; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

  const uint2* wp = w + static_cast<size_t>(warp * kTiles) * k_steps * 32 + lane;
  uint2 b[kTiles], b_next[kTiles];
#pragma unroll
  for (int nt = 0; nt < kTiles; ++nt) {
    b[nt] = wp[static_cast<size_t>(nt) * k_steps * 32];
    b_next[nt] = b[nt];
  }

  for (int ks = 0; ks < k_steps; ++ks) {
    if (ks + 1 < k_steps) {
#pragma unroll
      for (int nt = 0; nt < kTiles; ++nt)
        b_next[nt] = wp[(static_cast<size_t>(nt) * k_steps + ks + 1) * 32];
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

#pragma unroll
  for (int nt = 0; nt < kTiles; ++nt) {
    const int col = (warp * kTiles + nt) * 8 + t * 2;
    const float b0 = bias[col];
    const float b1 = bias[col + 1];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      const int row = mt * 16 + g;
      *reinterpret_cast<uint32_t*>(dst + row * stride + col) =
          pack_bf16(fast_sin(acc[mt][nt][0] + b0), fast_sin(acc[mt][nt][1] + b1));
      *reinterpret_cast<uint32_t*>(dst + (row + 8) * stride + col) =
          pack_bf16(fast_sin(acc[mt][nt][2] + b0), fast_sin(acc[mt][nt][3] + b1));
    }
  }
}

template <int H>
__global__ void __launch_bounds__(kThreads, 1) fused_mlp_fwd_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int stride = (H > p.e_pad ? H : p.e_pad) + kPad;
  __nv_bfloat16* cur = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* nxt = cur + kRows * stride;
  const int row0 = blockIdx.x * kRows;

  // positional encoding, zero-padded to e_pad columns and past row n
  for (int idx = threadIdx.x; idx < kRows * p.e_pad; idx += kThreads) {
    const int r = idx / p.e_pad;
    const int c = idx - r * p.e_pad;
    const int gr = row0 + r;
    float v = 0.f;
    if (gr < p.n) {
      const float* x = p.pts + static_cast<size_t>(gr) * p.d_in;
      if (c < p.d_in) {
        v = x[c];
      } else if (c < p.d_in + 2 * p.n_cols) {
        const int j = (c - p.d_in) % p.n_cols;
        const float u = __fmul_rn(x[p.col_dim[j]], p.col_freq[j]);
        // cos(u) = sin(u + pi/2), as the TPU kernel's fast_cos
        v = fast_sin(c < p.d_in + p.n_cols ? u : __fadd_rn(u, kHalfPi));
      }
    }
    cur[r * stride + c] = __float2bfloat16_rn(v);
  }
  __syncthreads();

  sine_layer<H>(cur, nxt, stride, p.e_pad, p.w_in, p.b_in);
  __syncthreads();
  for (int layer = 0; layer < p.n_hidden; ++layer) {
    __nv_bfloat16* tmp = cur;
    cur = nxt;
    nxt = tmp;
    sine_layer<H>(cur, nxt, stride, H,
                  p.w_h + static_cast<size_t>(layer) * (H / 8) * (H / 16) * 32,
                  p.b_h + static_cast<size_t>(layer) * H);
    __syncthreads();
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
        s += __bfloat162float(nxt[r * stride + c]) *
             __bfloat162float(p.w_out[o * H + c]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off);
      if (lane == 0 && gr < p.n)
        p.out[static_cast<size_t>(gr) * p.d_out + o] = s + p.b_out[o];
    }
  }
}

template <int H>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const int stride = (H > p.e_pad ? H : p.e_pad) + kPad;
  const size_t smem = 2 * kRows * stride * sizeof(__nv_bfloat16);
  cudaError_t err = cudaFuncSetAttribute(
      fused_mlp_fwd_kernel<H>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.n + kRows - 1) / kRows);
  fused_mlp_fwd_kernel<H><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// C entry, bound with ctypes. Returns a cudaError_t (0 = launched).
extern "C" int sunerf_fused_mlp_fwd(
    const void* pts, const void* col_dim, const void* col_freq,
    const void* w_in, const void* b_in, const void* w_h, const void* b_h,
    const void* w_out, const void* b_out, void* out, int n, int d_in,
    int n_cols, int e_pad, int d_filter, int n_hidden, int d_out,
    void* stream) {
  if (n <= 0 || e_pad % 16 != 0 || e_pad < d_in + 2 * n_cols)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.pts = static_cast<const float*>(pts);
  p.col_dim = static_cast<const int*>(col_dim);
  p.col_freq = static_cast<const float*>(col_freq);
  p.w_in = static_cast<const uint2*>(w_in);
  p.b_in = static_cast<const float*>(b_in);
  p.w_h = static_cast<const uint2*>(w_h);
  p.b_h = static_cast<const float*>(b_h);
  p.w_out = static_cast<const __nv_bfloat16*>(w_out);
  p.b_out = static_cast<const float*>(b_out);
  p.out = static_cast<float*>(out);
  p.n = n;
  p.d_in = d_in;
  p.n_cols = n_cols;
  p.e_pad = e_pad;
  p.n_hidden = n_hidden;
  p.d_out = d_out;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
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
