// Grid-encode probe P2 for Hopper (sm_90a): the (y, z) hat weights of each
// point, contracted with the table on the tensor cores.
//
// Replaces the TPU kernel of scripts/probe_grid_hatbuild.py:make_encode
// (pallas_call :96), the JAX package's A/B of three ways to build the hat
// weights of its one-hot grid encode. Same function, per point p:
//   u[n, x] = sum over j = y G + z of w[n, j] * table[j, x F + f]   ([N, G F])
// with bf16 operands and f32 sums, uy, uz = clip((p + bound) * scale, 0,
// G - 1), scale = 0.5 (G - 1) / bound, hat(d) = max(0, 1 - |d|), and w:
//   kIota      bf16(hat(uy - y) * hat(uz - z)), the product in f32;
//   kExpand    bf16((bf16(wy) @ E1)[j] * (bf16(wz) @ E2)[j]), wy[y] =
//              hat(uy - y) and wz likewise, E1 and E2 [G, G^2] bf16
//              operands: both expansion products run on the tensor cores
//              with f32 sums, for whatever E the caller passes;
//   kInkernel  the TPU kernel's grid_hat_mxu build (sunerf_tpu/ops/pallas/
//              fused_mlp.py _grid_wyz), whose E are the fixed 0/1 matrices
//              E1[y, yG+z] = E2[z, yG+z] = 1 built from index comparisons:
//              each column of those products sums one nonzero term, so it
//              equals bf16(bf16(wy[y]) * bf16(wz[z])) exactly, which this
//              kernel computes directly.
//
// Bound on this card: bytes. Each row of w has 4 nonzeros, so the function
// needs 8 G F flop a point; the bytes are 12 a point in, 4 G F out (268 MB
// at N = 262,144, G = 32, F = 8) and the table once. The dense contraction
// that this probe exists to measure does 2 G^3 F flop a point on the bf16
// tensor cores (1.37e11 at that shape, 0.139 ms at 989 TFLOP/s), so it
// cannot reach the byte bound. Design, simple first:
//   * a block of 8 warps per 128 points and 128 output columns; the G^2
//     axis in chunks of 64: each chunk's w [128, 64] is built as bf16 in
//     shared memory by the variant, the table chunk [64, 128] is staged
//     beside it with 16-byte loads (the 512 KB bf16 table at G = 32 does not
//     fit in shared memory; it stays in L2), and each warp accumulates its
//     32 x 64 output tile in f32 registers by mma.sync m16n8k16, operands
//     from ldmatrix (the table's B fragments transposed on the load);
//   * the iota and inkernel builds: a thread per chunk column (y and z
//     once) and 32 rows, unrolled so their shared-memory loads overlap;
//     these two variants fit in 128 registers, so two blocks share an SM
//     and one's build overlaps the other's products; rows at or past n and
//     columns at or past G^2 get zero weight, table rows and columns past
//     the ends read zeros;
//   * expand: the block's bf16 hat rows wy, wz [128, G] are built once;
//     per chunk E1 and E2's columns are staged and both [128, G] x [G, 64]
//     products run on the tensor cores, multiplied in the registers of
//     their f32 fragments and rounded to bf16 into the w chunk;
//   * f32 output written from the fragments, 8 bytes per thread and row.
// The chunk loop is synchronous (two barriers a chunk); cp.async staging,
// wgmma and a build that skips the zero hats are left for later work.

#include "fused_mlp_common.cuh"

namespace {

constexpr int kBM = 128;            // points per block
constexpr int kBN = 128;            // output columns per block
constexpr int kKC = 64;             // G^2 columns of w per chunk
constexpr int kThreads = 256;       // 8 warps: 4 along the points x 2 along the columns
constexpr int kWStride = kKC + 8;   // bf16 row stride of the w and E chunks
constexpr int kTStride = kBN + 8;   // bf16 row stride of the table chunk

enum Variant : int { kIota = 0, kExpand = 1, kInkernel = 2 };

struct HatParams {
  const float* pts;              // [n, 3]
  const __nv_bfloat16* table;    // [G^2, cols]
  const __nv_bfloat16* e1;       // [G, G^2], expand only
  const __nv_bfloat16* e2;       // [G, G^2], expand only
  float* out;                    // [n, cols]
  int n, G, cols;
  float bound, scale;
};

__device__ __forceinline__ float hat(float u, float c) {
  return fmaxf(0.f, __fsub_rn(1.f, fabsf(__fsub_rn(u, c))));
}

__device__ __forceinline__ float coord(float x, const HatParams& p) {
  return fminf(fmaxf(__fmul_rn(__fadd_rn(x, p.bound), p.scale), 0.f),
               static_cast<float>(p.G - 1));
}

// A fragments of a 16 x 16 bf16 tile at `tile` (row stride `stride`)
__device__ __forceinline__ void ldsm_a(uint32_t (&r)[4], const __nv_bfloat16* tile,
                                       int stride) {
  const int lane = threadIdx.x & 31;
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(sunerf::smem_addr(tile + (lane & 15) * stride + (lane >> 4) * 8)));
}

// B fragments of two n-tiles of a row-major [16, 16] bf16 tile at `tile`
// (k along the rows): r[0..1] columns 0-7, r[2..3] columns 8-15
__device__ __forceinline__ void ldsm_b(uint32_t (&r)[4], const __nv_bfloat16* tile,
                                       int stride) {
  const int lane = threadIdx.x & 31;
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(sunerf::smem_addr(tile + (lane & 15) * stride + (lane >> 4) * 8)));
}

// acc[2][2 * kPairs] (this warp's 32 rows of a, 16 kPairs columns of b) +=
// a[32, k] @ b[k, 16 kPairs], both in shared memory
template <int kPairs>
__device__ __forceinline__ void warp_mma(float (&acc)[2][2 * kPairs][4],
                                         const __nv_bfloat16* a, int a_stride,
                                         const __nv_bfloat16* b, int b_stride, int k) {
  for (int ks = 0; ks < k; ks += 16) {
    uint32_t af[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) ldsm_a(af[mt], a + mt * 16 * a_stride + ks, a_stride);
#pragma unroll
    for (int np = 0; np < kPairs; ++np) {
      uint32_t bf[4];
      ldsm_b(bf, b + ks * b_stride + np * 16, b_stride);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        sunerf::mma_bf16(acc[mt][2 * np], af[mt], make_uint2(bf[0], bf[1]));
        sunerf::mma_bf16(acc[mt][2 * np + 1], af[mt], make_uint2(bf[2], bf[3]));
      }
    }
  }
}

// Dynamic shared memory of a variant at grid size G (bytes)
size_t smem_bytes(int variant, int G) {
  const int gp = (G + 15) / 16 * 16;
  size_t b = (kKC * kTStride + kBM * kWStride) * 2 + 2 * kBM * 4;
  if (variant == kExpand) b += (2 * kBM * (gp + 8) + 2 * gp * kWStride) * 2;
  return b;
}

// iota and inkernel fit in 128 registers, two blocks an SM; expand's
// expansion fragments take more
template <int kVariant>
__global__ void __launch_bounds__(kThreads, kVariant == kExpand ? 1 : 2)
    hat_encode_kernel(HatParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int G = p.G, K = G * G;
  const int gp = (G + 15) / 16 * 16;   // G rounded up to the k-step (expand)
  const int gs = gp + 8;               // bf16 row stride of wy, wz
  auto* s_table = reinterpret_cast<__nv_bfloat16*>(smem);       // [kKC][kTStride]
  auto* s_w = s_table + kKC * kTStride;                          // [kBM][kWStride]
  float* s_uy = reinterpret_cast<float*>(s_w + kBM * kWStride);  // [kBM]
  float* s_uz = s_uy + kBM;
  auto* s_wy = reinterpret_cast<__nv_bfloat16*>(s_uz + kBM);    // [kBM][gs]
  auto* s_wz = s_wy + kBM * gs;
  auto* s_e1 = s_wz + kBM * gs;                                  // [gp][kWStride]
  auto* s_e2 = s_e1 + gp * kWStride;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int row0 = blockIdx.x * kBM, col0 = blockIdx.y * kBN;
  const int wm = (warp & 3) * 32;      // this warp's rows of the block
  const int wn = (warp >> 2) * 64;     // its columns of the output tile

  for (int r = tid; r < kBM; r += kThreads) {
    float uy = 0.f, uz = 0.f;
    if (row0 + r < p.n) {
      const float* x = p.pts + static_cast<size_t>(row0 + r) * 3;
      uy = coord(x[1], p);
      uz = coord(x[2], p);
    }
    s_uy[r] = uy;
    s_uz[r] = uz;
  }
  if constexpr (kVariant == kExpand) {
    __syncthreads();
    for (int idx = tid; idx < kBM * gp; idx += kThreads) {
      const int r = idx / gp, c = idx - r * gp;
      const bool in = c < G && row0 + r < p.n;
      s_wy[r * gs + c] = __float2bfloat16_rn(in ? hat(s_uy[r], static_cast<float>(c)) : 0.f);
      s_wz[r * gs + c] = __float2bfloat16_rn(in ? hat(s_uz[r], static_cast<float>(c)) : 0.f);
    }
  }
  __syncthreads();

  float acc[2][8][4] = {};
  for (int k0 = 0; k0 < K; k0 += kKC) {
    for (int idx = tid; idx < kKC * (kBN / 8); idx += kThreads) {
      const int r = idx / (kBN / 8), c = (idx % (kBN / 8)) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (k0 + r < K && col0 + c < p.cols)
        v = *reinterpret_cast<const uint4*>(p.table + static_cast<size_t>(k0 + r) * p.cols
                                            + col0 + c);
      *reinterpret_cast<uint4*>(s_table + r * kTStride + c) = v;
    }
    if constexpr (kVariant == kExpand) {
      for (int idx = tid; idx < gp * kKC; idx += kThreads) {
        const int r = idx / kKC, c = idx % kKC;
        const bool in = r < G && k0 + c < K;
        const size_t off = static_cast<size_t>(r) * K + k0 + c;
        s_e1[r * kWStride + c] = in ? p.e1[off] : __float2bfloat16_rn(0.f);
        s_e2[r * kWStride + c] = in ? p.e2[off] : __float2bfloat16_rn(0.f);
      }
      __syncthreads();
      // wye, wze: this warp's 32 rows x 32 columns of the chunk
      const int ec = (warp >> 2) * 32;
      float ey[2][4][4] = {}, ez[2][4][4] = {};
      warp_mma<2>(ey, s_wy + wm * gs, gs, s_e1 + ec, kWStride, gp);
      warp_mma<2>(ez, s_wz + wm * gs, gs, s_e2 + ec, kWStride, gp);
      const int g = lane >> 2, t = lane & 3;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int r = wm + mt * 16 + g, c = ec + nt * 8 + 2 * t;
          *reinterpret_cast<uint32_t*>(s_w + r * kWStride + c) =
              sunerf::pack_bf16(__fmul_rn(ey[mt][nt][0], ez[mt][nt][0]),
                                __fmul_rn(ey[mt][nt][1], ez[mt][nt][1]));
          *reinterpret_cast<uint32_t*>(s_w + (r + 8) * kWStride + c) =
              sunerf::pack_bf16(__fmul_rn(ey[mt][nt][2], ez[mt][nt][2]),
                                __fmul_rn(ey[mt][nt][3], ez[mt][nt][3]));
        }
    } else {
      const int c = tid % kKC, j = k0 + c;
      const bool in = j < K;
      const float yc = static_cast<float>(in ? j / G : 0);
      const float zc = static_cast<float>(in ? j % G : 0);
#pragma unroll
      for (int i = 0; i < kBM * kKC / kThreads; ++i) {
        const int r = tid / kKC + i * (kThreads / kKC);
        float w = 0.f;
        if (in && row0 + r < p.n) {
          const float hy = hat(s_uy[r], yc), hz = hat(s_uz[r], zc);
          w = kVariant == kIota ? __fmul_rn(hy, hz)
                                : __fmul_rn(sunerf::bf16_round(hy), sunerf::bf16_round(hz));
        }
        s_w[r * kWStride + c] = __float2bfloat16_rn(w);
      }
    }
    __syncthreads();
    warp_mma<4>(acc, s_w + wm * kWStride, kWStride, s_table + wn, kTStride, kKC);
    __syncthreads();
  }

  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int r = row0 + wm + mt * 16 + g;
      const int c = col0 + wn + nt * 8 + 2 * t;
      if (c >= p.cols) continue;
      float* o = p.out + static_cast<size_t>(r) * p.cols + c;
      if (r < p.n) *reinterpret_cast<float2*>(o) = make_float2(acc[mt][nt][0], acc[mt][nt][1]);
      if (r + 8 < p.n)
        *reinterpret_cast<float2*>(o + 8 * static_cast<size_t>(p.cols)) =
            make_float2(acc[mt][nt][2], acc[mt][nt][3]);
    }
}

// Raises the kernel's dynamic shared memory limit once per larger size, so
// that a launch inside a CUDA graph capture makes no attribute call.
template <int kVariant>
cudaError_t launch(const HatParams& p, cudaStream_t stream) {
  static size_t smem_set = 0;
  const size_t smem = smem_bytes(kVariant, p.G);
  if (smem > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(hat_encode_kernel<kVariant>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    smem_set = smem;
  }
  const dim3 grid((p.n + kBM - 1) / kBM, (p.cols + kBN - 1) / kBN);
  hat_encode_kernel<kVariant><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// C entry, bound with ctypes. pts [n, 3] f32, table [G^2, cols] bf16 (cols
// a multiple of 8), e1, e2 [G, G^2] bf16 (variant kExpand only, else null),
// out [n, cols] f32. Returns a cudaError_t (0 = launched).
extern "C" int sunerf_grid_hat_encode(const void* pts, const void* table, const void* e1,
                                      const void* e2, void* out, int n, int G, int cols,
                                      int variant, float bound, float scale, void* stream) {
  HatParams p;
  p.pts = static_cast<const float*>(pts);
  p.table = static_cast<const __nv_bfloat16*>(table);
  p.e1 = static_cast<const __nv_bfloat16*>(e1);
  p.e2 = static_cast<const __nv_bfloat16*>(e2);
  p.out = static_cast<float*>(out);
  p.n = n;
  p.G = G;
  p.cols = cols;
  p.bound = bound;
  p.scale = scale;
  const auto s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case kIota: return static_cast<int>(launch<kIota>(p, s));
    case kExpand: return static_cast<int>(launch<kExpand>(p, s));
    case kInkernel: return static_cast<int>(launch<kInkernel>(p, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
