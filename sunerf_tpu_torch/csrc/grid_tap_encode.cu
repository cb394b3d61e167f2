// Grid-encode probe P1 for Hopper (sm_90a): trilinear features by 8 table
// taps per point.
//
// Replaces the TPU kernel of scripts/probe_grid_taps.py:make_tap_encode
// (pallas_call :77), the JAX package's probe of per-point dynamic-slice taps
// from a VMEM-resident packed table. Same function, per point p:
//   u   = clip((p + bound) * scale, 0, G - 1),  scale = 0.5 (G - 1) / bound
//   lo  = clip(floor(u), 0, G - 2),  fr = u - lo              (axes x, y, z)
//   out = sum over (dy, dz, dx), in that order, of
//         ((fy|1-fy) * (fz|1-fz)) * (fx|1-fx) * T[(iy+dy) G^2 + (iz+dz) G + ix+dx]
// with T the [G^3, F] f32 table (axis order y, z, x, f). The TPU packs
// P = 128 / F table rows into each 128-lane VMEM row; those are the bytes of
// T row-major, so here row r starts at r * F and the packing costs nothing.
//
// Bound on this card: bytes. 12 bytes of point and 4 F of output per point
// plus the table once (4 G^3 F: 1 MB at G = 32, 8.4 MB at G = 64), against
// 24 flop per feature. Design against that bound:
//   * a thread per point and 4 features, each tap one float4 load (a thread
//     per point and feature where F is not a multiple of 4); the TPU body's
//     fori_loop over a tile's points is not carried over: a block's points
//     run in parallel, so the 8 taps' latency overlaps across threads;
//   * the cell once per thread, then 8 loads of 4 F bytes through the
//     read-only path (__ldg) from the table, which stays resident in the
//     50 MB L2; neighbouring threads read neighbouring features of a corner;
//   * every product and sum rounded on its own (__fmul_rn, __fadd_rn) in the
//     JAX kernel's order, as ops/grid_probes.py tap_encode_reference does:
//     nvcc would otherwise contract them into fused multiply-adds, and the
//     kernel and its plain version agree to the bit.
// It sits at its L2 gather floor: 8 ceil(4 F / 32) sectors of 32 bytes a
// point at the rate the card reads P1's gathers, which sector_read_kernel
// below measures (P1's loads of random cells of the same table without the
// arithmetic: 0.0163 ms at N = 262,144, G = 32, where this kernel took
// 0.0159-0.0160; H100 80GB HBM3, 700 W, PERF.md). Two redesigns measured
// no faster and were not kept: persistent blocks with each chunk's
// coordinates read coalesced into shared memory (0.0162-0.0164), and that
// with a lane a point, all 8 features (0.0220: a lane's two 16-byte halves
// of a sector are two L1 requests, where a pair of lanes makes one).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// V features per thread: 4 (float4 taps) or 1
template <int V>
__global__ void __launch_bounds__(kThreads) tap_encode_kernel(
    const float* __restrict__ pts, const float* __restrict__ table,
    float* __restrict__ out, int n, int G, int F, float bound, float scale) {
  const int per_point = F / V;
  const long long idx = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= static_cast<long long>(n) * per_point) return;
  const long long i = idx / per_point;
  const int f = static_cast<int>(idx - i * per_point) * V;
  int lo[3];
  float fr[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float u = fminf(fmaxf(__fmul_rn(__fadd_rn(__ldg(pts + 3 * i + a), bound), scale),
                                0.f), static_cast<float>(G - 1));
    const float l = fminf(fmaxf(floorf(u), 0.f), static_cast<float>(G - 2));
    lo[a] = static_cast<int>(l);
    fr[a] = __fsub_rn(u, l);
  }
  float acc[V] = {};
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int dy = c >> 2, dz = (c >> 1) & 1, dx = c & 1;
    const float w = __fmul_rn(__fmul_rn(dy ? fr[1] : __fsub_rn(1.f, fr[1]),
                                        dz ? fr[2] : __fsub_rn(1.f, fr[2])),
                              dx ? fr[0] : __fsub_rn(1.f, fr[0]));
    const size_t row = (static_cast<size_t>(lo[1] + dy) * G + lo[2] + dz) * G + lo[0] + dx;
    const float* t = table + row * F + f;
    if constexpr (V == 4) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(t));
      acc[0] = __fadd_rn(acc[0], __fmul_rn(w, v.x));
      acc[1] = __fadd_rn(acc[1], __fmul_rn(w, v.y));
      acc[2] = __fadd_rn(acc[2], __fmul_rn(w, v.z));
      acc[3] = __fadd_rn(acc[3], __fmul_rn(w, v.w));
    } else {
      acc[0] = __fadd_rn(acc[0], __fmul_rn(w, __ldg(t)));
    }
  }
  float* o = out + i * F + f;
  if constexpr (V == 4)
    *reinterpret_cast<float4*>(o) = make_float4(acc[0], acc[1], acc[2], acc[3]);
  else
    *o = acc[0];
}

template <int V>
cudaError_t launch(const float* pts, const float* table, float* out, int n, int G,
                   int F, float bound, float scale, cudaStream_t stream) {
  const long long threads = static_cast<long long>(n) * (F / V);
  const unsigned blocks = static_cast<unsigned>((threads + kThreads - 1) / kThreads);
  tap_encode_kernel<V><<<blocks, kThreads, 0, stream>>>(pts, table, out, n, G, F,
                                                        bound, scale);
  return cudaGetLastError();
}

// Blocks of `kernel` that fit on the card at once, found once per kernel
template <typename K>
cudaError_t resident_blocks(K kernel, int& blocks) {
  if (blocks > 0) return cudaSuccess;
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  blocks = sms * per_sm;
  return cudaSuccess;
}

// The L2 gather floor's microbenchmark (no TPU kernel; added to measure
// what bounds P1): P1's taps without their arithmetic. `n` points a pair
// of lanes each, as P1 runs them, each point a pseudo-random cell of the
// [G^3, F] table (F a multiple of 4) whose 8 corner rows the pair reads as
// P1 does (lane h the float4 groups h, h + 2, ...), all loads issued
// before a plain sum, one float out a lane so nothing is dropped. The
// table stays in L2; 8 ceil(4 F / 32) sectors a point over its time is the
// card's rate for P1's gathers.
__global__ void __launch_bounds__(kThreads) sector_read_kernel(
    const float* __restrict__ table, float* __restrict__ out, int n, int G, int F) {
  const int h = threadIdx.x & 1;
  for (long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; t < 2LL * n;
       t += static_cast<long long>(gridDim.x) * kThreads) {
    unsigned x = static_cast<unsigned>(t >> 1) * 2654435761u + 0x9E3779B9u;
    int lo[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      x ^= x >> 15;
      x *= 2246822519u;
      x ^= x >> 13;
      lo[a] = static_cast<int>(x % static_cast<unsigned>(G - 1));
    }
    float s = 0.f;
    for (int f = 4 * h; f < F; f += 8) {
      float4 v[8];
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int dy = c >> 2, dz = (c >> 1) & 1, dx = c & 1;
        const size_t row = (static_cast<size_t>(lo[1] + dy) * G + lo[2] + dz) * G + lo[0] + dx;
        v[c] = __ldg(reinterpret_cast<const float4*>(table + row * F + f));
      }
#pragma unroll
      for (int c = 0; c < 8; ++c) s += v[c].x + v[c].y + v[c].z + v[c].w;
    }
    out[t] = s;
  }
}

}  // namespace

// C entry, bound with ctypes. pts [n, 3] f32, table [G^3, F] f32, out
// [n, F] f32. Returns a cudaError_t (0 = launched).
extern "C" int sunerf_grid_tap_encode(const void* pts, const void* table, void* out,
                                      int n, int G, int F, float bound, float scale,
                                      void* stream) {
  const auto* p = static_cast<const float*>(pts);
  const auto* t = static_cast<const float*>(table);
  auto* o = static_cast<float*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  const bool vec4 = F % 4 == 0 && reinterpret_cast<uintptr_t>(table) % 16 == 0
                    && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  return static_cast<int>(vec4 ? launch<4>(p, t, o, n, G, F, bound, scale, s)
                               : launch<1>(p, t, o, n, G, F, bound, scale, s));
}

// C entry of the microbenchmark: table [G^3, F] f32 (F a multiple of 4,
// 16-byte aligned), out [2 n] f32. Returns a cudaError_t.
extern "C" int sunerf_l2_sector_read(const void* table, void* out, int n, int G, int F,
                                     void* stream) {
  if (n < 1 || G < 2 || F < 4 || F % 4 != 0 || reinterpret_cast<uintptr_t>(table) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  static int max_blocks = 0;
  cudaError_t err = resident_blocks(sector_read_kernel, max_blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long want = (2LL * n + kThreads - 1) / kThreads;
  sector_read_kernel<<<static_cast<unsigned>(want < max_blocks ? want : max_blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(table), static_cast<float*>(out), n, G, F);
  return static_cast<int>(cudaGetLastError());
}
