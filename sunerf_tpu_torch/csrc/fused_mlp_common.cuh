// Device code shared by the fused-MLP kernels for Hopper (sm_90a): the
// sine, cosine, bf16 and stash helpers and the dense feature-grid branch K5
// (its level descriptors and the per-(point, level) feature helper) of the
// forward (fused_mlp_fwd_wgmma.cuh: K0, K1, K6a, K6b and K4's
// recompute forward) and of the backwards (fused_mlp_backward.cuh). See
// those files for what each replaces and what bounds it.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sunerf {

constexpr float kTwoPi = 6.283185307179586f;
constexpr float kInvTwoPi = 0.15915494309189535f;
constexpr float kHalfPi = 1.5707963267948966f;
constexpr float kCosScale = 127.0f;
constexpr float kHalfPiSq = 2.4674011002723395f;   // (pi/2)^2 rounded to f32

// A kernel's launch state (its raised shared-memory limit, the blocks that
// fit at once) belongs to the device it was set on, so a launcher keeps one
// slot a device: a process that launches on two cards sets each card's.
// Returns the current device's slot of `slots` [kMaxDevices], or nullptr.
constexpr int kMaxDevices = 64;
inline int* device_slot(int* slots) {
  int device = 0;
  if (cudaGetDevice(&device) != cudaSuccess || device < 0 || device >= kMaxDevices)
    return nullptr;
  return slots + device;
}

// What a forward writes beside its output: nothing (K0), the bf16 sin and
// int8 cos stashes (K1, 'int8'), the packed bf16 sin with sign(cos) in its
// last bit (K6a, 'lsb'), the int8 sin and cos pairs (K6b, 'i8pair'), or the
// bf16 sin and bf16 cos of the recompute backward K4
enum Stash : int { kStashNone = 0, kStashInt8 = 1, kStashLsb = 2, kStashI8pair = 3,
                   kStashBf16Cos = 4 };

// x - 2*pi*round(x / 2*pi), rounding 2*pi*k before subtracting (no fused
// multiply-add), as the plain version does: at |x| ~ 70 that rounding is
// worth ~4e-6, enough to flip bf16 roundings downstream.
__device__ __forceinline__ float reduce_2pi(float x) {
  return x - __fmul_rn(kTwoPi, rintf(x * kInvTwoPi));
}

// odd minimax polynomial for sin on [-pi, pi] (max abs err 9.6e-8), the
// coefficients of the TPU kernel's fast_sin
__device__ __forceinline__ float sin_poly(float y) {
  const float y2 = y * y;
  return y * (9.999995999e-01f + y2 * (-1.666655263e-01f + y2 * (8.332402961e-03f
         + y2 * (-1.980863262e-04f + y2 * (2.699713829e-06f
         + y2 * -2.036221213e-08f)))));
}

// sin of an unreduced argument: phases reach ~400 rad, where __sinf is wrong
__device__ __forceinline__ float fast_sin(float x) { return sin_poly(reduce_2pi(x)); }

// cos on a reduced argument by the TPU kernel's degree-8 even polynomial
// (_COS8_C, max abs err 4.1e-5), quantized to int8 as round-half-even(127 c)
// like jnp.round; it only gates the backward's dz, where 1/127 is the floor
__device__ __forceinline__ int cos8_q(float y) {
  const float y2 = y * y;
  const float c = 9.999598405e-01f + y2 * (-4.997933042e-01f + y2 * (4.149612510e-02f
                  + y2 * (-1.339285342e-03f + y2 * 1.879295230e-05f)));
  return __float2int_rn(c * kCosScale);
}

// cos on a reduced argument by the TPU kernel's degree-10 even polynomial
// (_COS_C of fast_sincos, max abs err 7.8e-7): the recompute backward's cos
__device__ __forceinline__ float cos10(float y) {
  const float y2 = y * y;
  return 9.999992216e-01f + y2 * (-4.999942681e-01f + y2 * (4.165982217e-02f
         + y2 * (-1.385891583e-03f + y2 * (2.420439995e-05f + y2 * -2.197887694e-07f))));
}

// The bits of bf16(s) with the last mantissa bit replaced by `neg`
// (_pack_sin_csign: 1 = cos < 0)
__device__ __forceinline__ uint32_t pack_sin_csign(float s, bool neg) {
  return (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(s))) & 0xFFFEu)
         | (neg ? 1u : 0u);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// two int8 values in the low 16 bits (lo first in memory)
__device__ __forceinline__ uint32_t pack_i8(int lo, int hi) {
  return (static_cast<uint32_t>(lo) & 0xFFu) | ((static_cast<uint32_t>(hi) & 0xFFu) << 8);
}

// bf16(bf16(q) * bf16(1/127)): the TPU kernel's dequantized int8
__device__ __forceinline__ float cos_dequant(int8_t q) {
  const float inv = __bfloat162float(__float2bfloat16_rn(1.0f / kCosScale));
  return bf16_round(static_cast<float>(q) * inv);
}

// The dense feature-grid levels (K5), any number of them, as the JAX
// kernels loop over dims.grid_sizes: one descriptor a level in a small
// device array (ops/fused_mlp.py grid_descriptors, int64 [levels, 3]) that
// the kernels read by pointer, and GridParams, the same struct on the host
// (ops/fused_mlp.py _GridArgs, passed by pointer) and in the kernels'
// parameters. Tables are the float32 parameters themselves, read through
// L2: the optimizer updates them in place, and nothing caches them.
struct GridLevel {
  const float* table;   // [G, G, G, F] f32, axis order (y, z, x, f)
  long long offset;     // its first element in d_table and the fixed-point sums
  long long size;       // G
};

struct GridParams {
  const GridLevel* levels;   // [n_levels], device memory
  long long total;           // elements of all the tables: sum of G^3 F
  int n_levels;              // 0 = no grid
  int features;              // F
  float bound;               // the tables span [-bound, bound]^3
  int vec4;                  // 1: F % 4 == 0 and every table 16-byte aligned
};

inline GridParams grid_params(const void* grid) {
  GridParams g{};
  if (grid != nullptr) g = *static_cast<const GridParams*>(grid);
  return g;
}

// What the host can check; the descriptors (tables, G >= 2, offsets) are
// the wrapper's (ops/fused_mlp.py _check, grid_descriptors)
inline bool grid_ok(const GridParams& g) {
  if (g.n_levels < 0) return false;
  if (g.n_levels == 0) return true;
  return g.levels != nullptr && g.features >= 1 && g.bound > 0.f && g.total > 0;
}

__device__ __forceinline__ GridLevel grid_level(const GridParams& g, int l) {
  const long long* d = reinterpret_cast<const long long*>(g.levels + l);
  GridLevel v;
  v.table = reinterpret_cast<const float*>(__ldg(d));
  v.offset = __ldg(d + 1);
  v.size = __ldg(d + 2);
  return v;
}

// The lower cell corner lo and the offset fr from it, per axis, of point x
// in a level of G cells a side: u = clip((x / bound + 1) * (G-1)/2, 0, G-1),
// lo = clip(floor(u), 0, G-2), fr = u - lo (ops/grid_encoding.py _cell).
// Every operation rounds on its own, as the plain version's tensor ops do.
__device__ __forceinline__ void grid_cell(const float* x, int G, float bound,
                                          int (&lo)[3], float (&fr)[3]) {
  const float scale = 0.5f * static_cast<float>(G - 1);
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float u = fminf(fmaxf(__fmul_rn(__fadd_rn(__fdiv_rn(x[a], bound), 1.0f), scale),
                                0.0f), static_cast<float>(G - 1));
    const float l = fminf(fmaxf(floorf(u), 0.0f), static_cast<float>(G - 2));
    lo[a] = static_cast<int>(l);
    fr[a] = __fsub_rn(u, l);
  }
}

// Corner c = 4 dx + 2 dy + dz of a cell: its weight (wx * wy) * wz and its
// table row (iy * G + iz) * G + ix (ops/grid_encoding.py _corners).
__device__ __forceinline__ float grid_corner(const int (&lo)[3], const float (&fr)[3],
                                             int G, int c, int& row) {
  const int dx = c >> 2, dy = (c >> 1) & 1, dz = c & 1;
  const float wx = dx ? fr[0] : __fsub_rn(1.0f, fr[0]);
  const float wy = dy ? fr[1] : __fsub_rn(1.0f, fr[1]);
  const float wz = dz ? fr[2] : __fsub_rn(1.0f, fr[2]);
  row = ((lo[1] + dy) * G + lo[2] + dz) * G + lo[0] + dx;
  return __fmul_rn(__fmul_rn(wx, wy), wz);
}

// The F features of grid level `level` at point x, put(f, value) for each:
// the trilinear interpolation of ops/grid_encoding.py grid_encode. The
// cell is computed once a (point, level), not once a feature; each corner's
// row of F floats comes as 16-byte loads (with vec4), kWide (8 or 4)
// features at a time, all 8 corners' loads issued before the first sum;
// the corners are summed in _corners' order with every operation rounded
// on its own, so every feature has grid_encode's bits. kWide = 4 holds 32
// loaded floats a thread instead of 64, for kernels that need occupancy.
template <int kWide = 8, typename Put>
__device__ __forceinline__ void grid_level_features(const GridParams& g, int level,
                                                    const float* x, Put&& put) {
  const GridLevel lv = grid_level(g, level);
  const int G = static_cast<int>(lv.size), F = g.features;
  int lo[3];
  float fr[3];
  grid_cell(x, G, g.bound, lo, fr);
  float w[8];
  int t[8];   // each corner's row's first element (a table has < 2^31)
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    int row;
    w[c] = grid_corner(lo, fr, G, c, row);
    t[c] = row * F;
  }
  int f0 = 0;
  if (g.vec4) {
    for (; kWide == 8 && f0 + 8 <= F; f0 += 8) {
      float4 v[8][2];
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        v[c][0] = __ldg(reinterpret_cast<const float4*>(lv.table + t[c] + f0));
        v[c][1] = __ldg(reinterpret_cast<const float4*>(lv.table + t[c] + f0 + 4));
      }
      float a[8] = {};
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float e[8] = {v[c][0].x, v[c][0].y, v[c][0].z, v[c][0].w,
                            v[c][1].x, v[c][1].y, v[c][1].z, v[c][1].w};
#pragma unroll
        for (int k = 0; k < 8; ++k) a[k] = __fadd_rn(a[k], __fmul_rn(w[c], e[k]));
      }
#pragma unroll
      for (int k = 0; k < 8; ++k) put(f0 + k, a[k]);
    }
    for (; f0 < F; f0 += 4) {   // kWide 4, or F % 8 == 4
      float4 v[8];
#pragma unroll
      for (int c = 0; c < 8; ++c) v[c] = __ldg(reinterpret_cast<const float4*>(lv.table + t[c] + f0));
      float a[4] = {};
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        a[0] = __fadd_rn(a[0], __fmul_rn(w[c], v[c].x));
        a[1] = __fadd_rn(a[1], __fmul_rn(w[c], v[c].y));
        a[2] = __fadd_rn(a[2], __fmul_rn(w[c], v[c].z));
        a[3] = __fadd_rn(a[3], __fmul_rn(w[c], v[c].w));
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) put(f0 + k, a[k]);
    }
    return;
  }
  for (; f0 < F; ++f0) {
    float v[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) v[c] = __ldg(lv.table + t[c] + f0);
    float a = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) a = __fadd_rn(a, __fmul_rn(w[c], v[c]));
    put(f0, a);
  }
}

}  // namespace sunerf
