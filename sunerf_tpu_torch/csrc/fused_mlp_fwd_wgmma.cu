// K0, the no-grad forward of every render, for Hopper (sm_90a): the wgmma
// forward of fused_mlp_fwd_wgmma.cuh with no stash (kStashNone). It
// replaces the TPU kernel sunerf_tpu/ops/pallas/fused_mlp.py:_fwd_kernel
// (pallas_call :410); its function, bound and design are in that header.

#include "fused_mlp_fwd_wgmma.cuh"

// fwd_wgmma_kernel's launches by this library since it was loaded, counted
// where the launch returned no error (read by sunerf_kernel_launches).
static unsigned long long fwd_launches = 0;

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
  sunerf::fwd::Params p{};
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
  const cudaError_t err = sunerf::fwd::launch<sunerf::kStashNone>(
      p, e_pad, d_filter, static_cast<cudaStream_t>(stream));
  if (err == cudaSuccess) ++fwd_launches;
  return static_cast<int>(err);
}

// C entry: fwd_wgmma_kernel's launches by this library into out[0].
// Returns 0.
extern "C" int sunerf_kernel_launches(long long* out) {
  out[0] = static_cast<long long>(fwd_launches);
  return 0;
}
