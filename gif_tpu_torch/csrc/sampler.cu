// Bilinear grid_sample (zeros padding, align_corners=False) on NHWC float32
// images — the renderer's albedo lookup (forward).
//
// Replaces the TPU kernel gif_tpu/render/sampler_pallas.py::_sampler_kernel
// (called through _sampler_fwd_impl / grid_sample_bilinear_mxu).  The TPU
// kernel turned the random-access lookup into one-hot matrix products on
// the matrix unit because the TPU gathers slowly; Hopper gathers through
// its L1/L2 caches, so this is the direct form: one thread per output
// pixel, four taps, all C channels of a tap read together (NHWC), taps
// outside the image contribute zero (gif_tpu/render/shading.py:140-159).
//
// What bounds it on the H100: memory — it reads the grid and C values per
// tap and writes C values per pixel, a handful of flops per byte.  The 768
// KB texture of a sample stays resident in L2, so the taps' scattered reads
// cost little DRAM traffic; coalescing comes from neighbouring threads
// taking neighbouring pixels.
//
// Arithmetic uses explicitly rounded intrinsics in the plain version's
// order, so the two agree bit for bit.

#include <cuda_runtime.h>

namespace {

__global__ void sampler_kernel(const float* __restrict__ img,   // (B, H, W, C)
                               const float* __restrict__ grid,  // (B, P, 2)
                               float* __restrict__ out,         // (B, P, C)
                               int B, int H, int W, int C, int P) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)B * P) return;
  const int b = (int)(idx / P);
  const float gxn = grid[idx * 2 + 0];
  const float gyn = grid[idx * 2 + 1];
  const float gx = __fsub_rn(__fmul_rn(__fadd_rn(gxn, 1.f), (float)W * 0.5f), 0.5f);
  const float gy = __fsub_rn(__fmul_rn(__fadd_rn(gyn, 1.f), (float)H * 0.5f), 0.5f);
  const float x0f = floorf(gx);
  const float y0f = floorf(gy);
  const float dx = __fsub_rn(gx, x0f);
  const float dy = __fsub_rn(gy, y0f);
  const float ex = __fsub_rn(1.f, dx);
  const float ey = __fsub_rn(1.f, dy);
  // Validity is decided on the float coordinates, so no out-of-range
  // float -> int conversion happens.
  const bool vx0 = x0f >= 0.f && x0f <= (float)(W - 1);
  const bool vx1 = x0f >= -1.f && x0f <= (float)(W - 2);
  const bool vy0 = y0f >= 0.f && y0f <= (float)(H - 1);
  const bool vy1 = y0f >= -1.f && y0f <= (float)(H - 2);
  const int x0 = vx0 || vx1 ? (int)x0f : 0;
  const int y0 = vy0 || vy1 ? (int)y0f : 0;
  const float* im = img + (size_t)b * H * W * C;
  float* o = out + idx * C;
  for (int c = 0; c < C; ++c) {
    const float v00 = vy0 && vx0 ? im[((size_t)y0 * W + x0) * C + c] : 0.f;
    const float v01 = vy0 && vx1 ? im[((size_t)y0 * W + x0 + 1) * C + c] : 0.f;
    const float v10 = vy1 && vx0 ? im[((size_t)(y0 + 1) * W + x0) * C + c] : 0.f;
    const float v11 = vy1 && vx1 ? im[((size_t)(y0 + 1) * W + x0 + 1) * C + c] : 0.f;
    float acc = __fmul_rn(__fmul_rn(v00, ex), ey);
    acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(v01, dx), ey));
    acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(v10, ex), dy));
    acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(v11, dx), dy));
    o[c] = acc;
  }
}

}  // namespace

extern "C" int gif_sampler_forward(const void* img, const void* grid, void* out,
                                   int B, int H, int W, int C, int P,
                                   void* stream) {
  const long long n = (long long)B * P;
  const int threads = 256;
  const int blocks = (int)((n + threads - 1) / threads);
  if (blocks > 0) {
    sampler_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const float*)img, (const float*)grid, (float*)out, B, H, W, C, P);
  }
  return (int)cudaGetLastError();
}
