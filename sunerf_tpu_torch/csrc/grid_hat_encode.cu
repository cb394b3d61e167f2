// Grid-encode probe P2 for Hopper (sm_90a): the (y, z) hat weights of each
// point, contracted with the table on the tensor cores by wgmma.
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
// at N = 262,144, G = 32, F = 8) and the table once: 0.081 ms at 3.35 TB/s.
// The dense contraction that this probe exists to measure does 2 G^3 F flop
// a point on the bf16 tensor cores (1.37e11 at that shape, 0.139 ms at 989
// TFLOP/s), so it cannot reach the byte bound. Design (hopper.cuh):
//   * a tile is 128 points x 256 output columns, so at G F = 256 each
//     point's weights are built once; two consumer warpgroups of 64 points
//     each run wgmma m64n256k16 with the f32 sums in 128 registers a thread.
//     'expand' takes 64 points x 256 columns a tile instead, each warpgroup
//     128 of the columns (m64n128k16, 64 sum registers), both building the
//     same weights: its expansion products' operands and sums need the
//     registers that the other builds give to the wider product;
//   * w never touches shared memory: each thread builds the bf16 weights of
//     its rows and k indices straight into wgmma's register A fragment, one
//     k-step ahead, while the tensor cores run the previous step (a double
//     buffer of 4 registers; wgmma.wait_group 1 frees the older one). Where
//     G is 16, 32 or 64 every k-step lies in one y: a step then takes one
//     hat in y a row, the z hats of its phase being computed once a tile.
//     'expand' runs its two expansion products as m64n16k16 wgmmas of the
//     per-axis bf16 hats (A from registers, built once per tile) against
//     E1, E2 in shared memory, issued one step ahead too; their f32
//     accumulators, multiplied and rounded to bf16 pairs, are the next
//     step's A fragment (the accumulator and A layouts agree);
//   * the table streams through a ring of 6 stages of 64 k-rows x 256
//     columns (32 KB; 4 stages for 'expand', with E's 64 columns), filled
//     by one producer warp with the bulk-copy (TMA) engine from a copy that
//     the wrapper lays out once in wgmma's no-swizzle K-major layout, so one
//     copy instruction moves a stage; mbarriers carry full and empty;
//   * persistent blocks, one per SM, walk the tiles;
//   * the epilogue stores straight from the accumulators, 8 bytes a thread
//     and row; rows at or past n and columns at or past G F are masked, k
//     past G^2 reads zero table rows and gets zero hats.

#include "fused_mlp_common.cuh"
#include "hopper.cuh"

namespace {

namespace hp = sunerf::hopper;

constexpr int kBN = 256;              // output columns per tile
constexpr int kKC = 64;               // k (G^2 index) per ring stage
constexpr int kConsumerWarps = 8;     // two warpgroups of 64 points
constexpr int kThreads = kConsumerWarps * 32 + 32;   // + the producer warp
constexpr int kTableBytes = kKC * kBN * 2;           // one stage's table chunk
constexpr int kMaxG = 64;
constexpr int kMaxKK = (kMaxG + 15) / 16;            // expansion k-steps over y
constexpr int kBarBytes = 1024;       // the barriers, before the ring

enum Variant : int { kIota = 0, kExpand = 1, kInkernel = 2 };

// ring stages: 6 x 32 KB, or 4 x 48 KB with E's columns ('expand' at G = 64)
__host__ __device__ constexpr int stages_of(int variant) { return variant == kExpand ? 4 : 6; }

// points per tile: 'expand's two warpgroups share 64, each taking 128 columns
__host__ __device__ constexpr int tile_rows(int variant) { return variant == kExpand ? 64 : 128; }

struct HatParams {
  const float* pts;              // [n, 3]
  const __nv_bfloat16* table;    // [col_tiles][chunks][32 KB], see hat_table_layout
  const __nv_bfloat16* e;        // [chunks][2][gp x 64], expand only
  float* out;                    // [n, cols]
  int n, G, cols, chunks, col_tiles, gp;
  float bound, scale;
};

__device__ __forceinline__ float hat(float u, float c) {
  return fmaxf(0.f, __fsub_rn(1.f, fabsf(__fsub_rn(u, c))));
}

__device__ __forceinline__ float coord(float x, const HatParams& p) {
  return fminf(fmaxf(__fmul_rn(__fadd_rn(x, p.bound), p.scale), 0.f),
               static_cast<float>(p.G - 1));
}

// A weight of the iota or inkernel build
template <int kVariant>
__device__ __forceinline__ float weight(float uy, float uz, float y, float z) {
  const float hy = hat(uy, y), hz = hat(uz, z);
  return kVariant == kIota ? __fmul_rn(hy, hz)
                           : __fmul_rn(sunerf::bf16_round(hy), sunerf::bf16_round(hz));
}

// The step's A fragment for rows (r0, r1) at k positions (y[o], z[o]),
// o = 2q, 2q + 1, 2q + 8, 2q + 9
template <int kVariant>
__device__ __forceinline__ void build_a(uint32_t (&a)[4], const float (&uy)[2],
                                        const float (&uz)[2], const int (&y)[4],
                                        const int (&z)[4]) {
  float yf[4], zf[4];
#pragma unroll
  for (int o = 0; o < 4; ++o) {
    yf[o] = static_cast<float>(y[o]);
    zf[o] = static_cast<float>(z[o]);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      a[2 * h + r] = sunerf::pack_bf16(weight<kVariant>(uy[r], uz[r], yf[2 * h], zf[2 * h]),
                                       weight<kVariant>(uy[r], uz[r], yf[2 * h + 1],
                                                        zf[2 * h + 1]));
}

// The same where every k-step lies in one y (G = 16 kPh): the step's hats
// hy at its y, the four hz of its phase (k mod G) / 16 computed per tile
template <int kVariant>
__device__ __forceinline__ void build_a_aligned(uint32_t (&a)[4], const float (&uy)[2],
                                                const float (&hz)[4][2], int y) {
  const float yf = static_cast<float>(y);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float hy = hat(uy[r], yf);
    if constexpr (kVariant == kInkernel) hy = sunerf::bf16_round(hy);
#pragma unroll
    for (int h = 0; h < 2; ++h)
      a[2 * h + r] = sunerf::pack_bf16(__fmul_rn(hy, hz[2 * h][r]),
                                       __fmul_rn(hy, hz[2 * h + 1][r]));
  }
}

// The (y, z) of each k position 16 further on
__device__ __forceinline__ void advance(int (&y)[4], int (&z)[4], int G) {
#pragma unroll
  for (int o = 0; o < 4; ++o) {
    z[o] += 16;
    while (z[o] >= G) {
      z[o] -= G;
      ++y[o];
    }
  }
}

// 'expand': wye and wze of big step s (the 16 columns j = 64 kc + 16 s), by
// m64n16k16 products of the per-axis hat fragments with E1, E2 of the stage
__device__ __forceinline__ void expand_issue(float (&ey)[8], float (&ez)[8],
                                             const uint32_t (&wy)[kMaxKK][4],
                                             const uint32_t (&wz)[kMaxKK][4],
                                             uint32_t e1, uint32_t e2, int s, int nkk) {
  hp::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kMaxKK; ++kk) {
    if (kk < nkk) {
      const uint32_t off = (16 * kk + 2 * s) * 128;
      hp::wgmma_rs(ey, wy[kk], hp::make_desc(e1 + off, 1024, 128), kk);
      hp::wgmma_rs(ez, wz[kk], hp::make_desc(e2 + off, 1024, 128), kk);
    }
  }
  hp::wgmma_commit();
}

__device__ __forceinline__ void expand_to_a(uint32_t (&a)[4], const float (&ey)[8],
                                            const float (&ez)[8]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    a[i] = sunerf::pack_bf16(__fmul_rn(ey[2 * i], ez[2 * i]),
                             __fmul_rn(ey[2 * i + 1], ez[2 * i + 1]));
}

__device__ __forceinline__ void release(uint64_t* empty, int lane) {
  __syncwarp();
  if (lane == 0) hp::mbar_arrive(empty);
}

// kPh: G / 16 where that is 1, 2 or 4 and the variant builds its weights
// itself (iota, inkernel), else 0 (the general build)
template <int kVariant, int kPh>
__global__ void __launch_bounds__(kThreads, 1) hat_encode_kernel(HatParams p) {
  constexpr int kStages = stages_of(kVariant);
  constexpr int kBM = tile_rows(kVariant);
  constexpr int kWN = kVariant == kExpand ? kBN / 2 : kBN;   // a warpgroup's columns
  extern __shared__ __align__(1024) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kStages;
  unsigned char* ring = smem + kBarBytes;
  const int e_bytes = kVariant == kExpand ? 2 * p.gp * kKC * 2 : 0;
  const int stage_bytes = kTableBytes + e_bytes;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int items = (p.n + kBM - 1) / kBM * p.col_tiles;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hp::mbar_init(&full[s], 1);
      hp::mbar_init(&empty[s], kConsumerWarps);
    }
    hp::fence_barrier_init();
  }
  __syncthreads();

  if (warp == kConsumerWarps) {
    // producer: one thread keeps the ring full
    if (lane == 0) {
      const uint64_t policy = hp::evict_last_policy();
      int c = 0;
      for (int w = blockIdx.x; w < items; w += gridDim.x) {
        const int ct = w % p.col_tiles;
        for (int kc = 0; kc < p.chunks; ++kc, ++c) {
          const int st = c % kStages;
          hp::mbar_wait(&empty[st], ((c / kStages) & 1) ^ 1);
          hp::mbar_expect_tx(&full[st], stage_bytes);
          unsigned char* dst = ring + st * stage_bytes;
          const unsigned char* src = reinterpret_cast<const unsigned char*>(p.table)
              + (static_cast<size_t>(ct) * p.chunks + kc) * kTableBytes;
          hp::bulk_load(dst, src, kTableBytes, &full[st], policy);
          if constexpr (kVariant == kExpand)
            hp::bulk_load(dst + kTableBytes, reinterpret_cast<const unsigned char*>(p.e)
                              + static_cast<size_t>(kc) * e_bytes,
                          e_bytes, &full[st], policy);
        }
      }
    }
    __syncwarp();
  } else {
    // consumers: warpgroup wg takes points 64 wg .. 64 wg + 63 of the tile
    // and all its columns, or ('expand') all 64 points and columns
    // 128 wg .. 128 wg + 127
    const int wg = warp >> 2, w4 = warp & 3, g = lane >> 2, q = lane & 3;
    const int G = p.G;
    const int nkk = p.gp / 16;
    const int row_off = kVariant == kExpand ? 0 : 64 * wg;
    const int col_off = kVariant == kExpand ? kWN * wg : 0;
    int c = 0;
    for (int w = blockIdx.x; w < items; w += gridDim.x) {
      const int ct = w % p.col_tiles;
      const int r0 = (w / p.col_tiles) * kBM + row_off + w4 * 16 + g;
      float uy[2], uz[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = r0 + 8 * r;
        uy[r] = 0.f;
        uz[r] = 0.f;
        if (row < p.n) {
          uy[r] = coord(p.pts[static_cast<size_t>(row) * 3 + 1], p);
          uz[r] = coord(p.pts[static_cast<size_t>(row) * 3 + 2], p);
        }
      }
      const int c0 = c;
      const uint32_t ring0 = hp::smem_u32(ring);
      uint32_t a[2][4];
      float acc[kWN / 2] = {};
      float ey[8] = {}, ez[8] = {};
      uint32_t wy[kMaxKK][4], wz[kMaxKK][4];
      int y[4], z[4];
      float hz[kPh > 0 ? kPh : 1][4][2];
      if constexpr (kVariant == kExpand) {
#pragma unroll
        for (int kk = 0; kk < kMaxKK; ++kk)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const float y0 = static_cast<float>(16 * kk + 8 * h + 2 * q);
              wy[kk][2 * h + r] = sunerf::pack_bf16(hat(uy[r], y0), hat(uy[r], y0 + 1.f));
              wz[kk][2 * h + r] = sunerf::pack_bf16(hat(uz[r], y0), hat(uz[r], y0 + 1.f));
            }
        hp::mbar_wait(&full[c0 % kStages], (c0 / kStages) & 1);
        const uint32_t e1 = ring0 + (c0 % kStages) * stage_bytes + kTableBytes;
        expand_issue(ey, ez, wy, wz, e1, e1 + e_bytes / 2, 0, nkk);
        hp::wgmma_wait<0>();
        hp::fence_regs(ey);
        hp::fence_regs(ez);
        expand_to_a(a[0], ey, ez);
      } else if constexpr (kPh > 0) {
#pragma unroll
        for (int ph = 0; ph < kPh; ++ph)
#pragma unroll
          for (int o = 0; o < 4; ++o)
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const float h = hat(uz[r], static_cast<float>(16 * ph + 2 * q + (o & 1)
                                                            + 8 * (o >> 1)));
              hz[ph][o][r] = kVariant == kInkernel ? sunerf::bf16_round(h) : h;
            }
        build_a_aligned<kVariant>(a[0], uy, hz[0], 0);
      } else {
#pragma unroll
        for (int o = 0; o < 4; ++o) {
          const int j = 2 * q + (o & 1) + 8 * (o >> 1);
          y[o] = j / G;
          z[o] = j - y[o] * G;
        }
        build_a<kVariant>(a[0], uy, uz, y, z);
      }

      for (int kc = 0; kc < p.chunks; ++kc) {
        const int cc = c0 + kc;
        const int st = cc % kStages;
        // (expand waited for this stage a step ahead, for its E columns)
        if constexpr (kVariant != kExpand) hp::mbar_wait(&full[st], (cc / kStages) & 1);
        const uint32_t stage = ring0 + st * stage_bytes;
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const bool last = kc == p.chunks - 1 && s == 3;
          if constexpr (kVariant == kExpand) {
            if (!last) {
              int nst = st;
              if (s == 3) {
                nst = (cc + 1) % kStages;
                hp::mbar_wait(&full[nst], ((cc + 1) / kStages) & 1);
              }
              const uint32_t e1 = ring0 + nst * stage_bytes + kTableBytes;
              expand_issue(ey, ez, wy, wz, e1, e1 + e_bytes / 2, (s + 1) & 3, nkk);
            }
          }
          hp::wgmma_fence();
          // B: k-groups 2 s and 2 s + 1 of the stage, this warpgroup's columns
          hp::wgmma_rs(acc, a[s & 1],
                       hp::make_desc(stage + s * 8192 + (col_off / 8) * 128, 4096, 128),
                       (kc | s) != 0);
          hp::wgmma_commit();
          hp::wgmma_wait<1>();
          hp::fence_regs(a[(s + 1) & 1]);
          if (s == 0 && kc > 0) release(&empty[(cc - 1) % kStages], lane);
          if (!last) {
            if constexpr (kVariant == kExpand) {
              hp::fence_regs(ey);
              hp::fence_regs(ez);
              expand_to_a(a[(s + 1) & 1], ey, ez);
            } else if constexpr (kPh > 0) {
              // step 4 kc + s + 1: phase (s + 1) mod kPh, as kPh divides 4
              build_a_aligned<kVariant>(a[(s + 1) & 1], uy, hz[(s + 1) % kPh],
                                        (4 * kc + s + 1) / kPh);
            } else {
              advance(y, z, G);
              build_a<kVariant>(a[(s + 1) & 1], uy, uz, y, z);
            }
          }
        }
      }
      hp::wgmma_wait<0>();
      hp::fence_regs(acc);
      hp::fence_regs(a[0]);
      hp::fence_regs(a[1]);
      if constexpr (kVariant == kExpand) {
#pragma unroll
        for (int kk = 0; kk < kMaxKK; ++kk) {
          hp::fence_regs(wy[kk]);
          hp::fence_regs(wz[kk]);
        }
      }
      release(&empty[(c0 + p.chunks - 1) % kStages], lane);
      c = c0 + p.chunks;

      // epilogue: f32 straight from the accumulators
#pragma unroll
      for (int j = 0; j < kWN / 8; ++j) {
        const int col = ct * kBN + col_off + 8 * j + 2 * q;
        if (col >= p.cols) continue;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = r0 + 8 * r;
          if (row < p.n)
            *reinterpret_cast<float2*>(p.out + static_cast<size_t>(row) * p.cols + col) =
                make_float2(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
        }
      }
    }
  }
}

// Dynamic shared memory of a variant at its largest G
constexpr size_t smem_bytes(int variant) {
  return kBarBytes
         + stages_of(variant) * (kTableBytes + (variant == kExpand ? 2 * kMaxG * kKC * 2 : 0));
}

// Raises the kernel's shared memory limit and finds how many blocks fit at
// once, both once per kernel and device, so that a launch inside a CUDA
// graph capture makes no attribute or occupancy call; then launches one
// block per SM (block slot), each walking the tiles.
template <int kVariant, int kPh>
cudaError_t launch(const HatParams& p, cudaStream_t stream) {
  static int blocks_of[sunerf::kMaxDevices] = {};
  int* const slot = sunerf::device_slot(blocks_of);
  if (slot == nullptr) return cudaErrorInvalidDevice;
  int& max_blocks = *slot;
  const size_t smem = smem_bytes(kVariant);
  if (max_blocks == 0) {
    cudaError_t err = cudaFuncSetAttribute(hat_encode_kernel<kVariant, kPh>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    int device = 0, sms = 0, per_sm = 0;
    err = cudaGetDevice(&device);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, hat_encode_kernel<kVariant, kPh>, kThreads, smem);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    max_blocks = sms * per_sm;
  }
  const int items = (p.n + tile_rows(kVariant) - 1) / tile_rows(kVariant) * p.col_tiles;
  hat_encode_kernel<kVariant, kPh>
      <<<items < max_blocks ? items : max_blocks, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int kVariant>
cudaError_t launch_build(const HatParams& p, cudaStream_t s) {
  switch (p.G) {
    case 16: return launch<kVariant, 1>(p, s);
    case 32: return launch<kVariant, 2>(p, s);
    case 64: return launch<kVariant, 4>(p, s);
    default: return launch<kVariant, 0>(p, s);
  }
}

}  // namespace

// C entry, bound with ctypes. pts [n, 3] f32; table the wrapper's layout of
// the bf16 [G^2, cols] table (ops/grid_probes.py hat_table_layout): col_tiles
// x chunks blocks of 64 k-rows x 256 columns; e (variant kExpand only, else
// null) its layout of E1 and E2 [G, G^2] (hat_e_layout), gp = G rounded up
// to 16; out [n, cols] f32. Returns a cudaError_t (0 = launched).
extern "C" int sunerf_grid_hat_encode(const void* pts, const void* table, const void* e,
                                      void* out, int n, int G, int cols, int variant,
                                      float bound, float scale, void* stream) {
  HatParams p;
  p.pts = static_cast<const float*>(pts);
  p.table = static_cast<const __nv_bfloat16*>(table);
  p.e = static_cast<const __nv_bfloat16*>(e);
  p.out = static_cast<float*>(out);
  p.n = n;
  p.G = G;
  p.cols = cols;
  p.chunks = (G * G + kKC - 1) / kKC;
  p.col_tiles = (cols + kBN - 1) / kBN;
  p.gp = (G + 15) / 16 * 16;
  p.bound = bound;
  p.scale = scale;
  if (n <= 0 || G < 2 || G > kMaxG || cols % 8 != 0 || cols <= 0 ||
      (variant == kExpand && e == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case kIota: return static_cast<int>(launch_build<kIota>(p, s));
    case kExpand: return static_cast<int>(launch<kExpand, 0>(p, s));
    case kInkernel: return static_cast<int>(launch_build<kInkernel>(p, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
