// Transpose of bilinear point sampling: accumulate per-point cotangents into
// a zeroed NHWC float32 image — the image gradient of sample_at_points, the
// texture-interpolation loss's backward through the texture steal.
//
//   d_img[b, y, x, c] += w_y * w_x * g[b, p, c]   over each point's 4 taps
//
// Replaces the TPU kernel gif_tpu/render/sampler_pallas.py::_scatter_kernel
// (called through scatter_bilinear_mxu).  The TPU kernel turned the scatter
// into one-hot bf16 matrix products, W_y^T @ (W_x * g), because the TPU has
// no fast scattered writes; Hopper has float32 atomics in L2, so this is the
// direct form: one thread per (b, p), the tap geometry of the forward
// sampler, one atomicAdd per valid tap and channel, taps outside the image
// dropped.  Sums are float32 (the TPU's products were bf16).
//
// The tap geometry repeats sampler.cu's rounded intrinsics operation for
// operation, so a point's taps and weights are the forward's; validity is
// decided on the float coordinates.  The atomics add in no fixed order, so
// the result equals the plain version (an index_add_ of the same products)
// up to float32 reassociation, not bit for bit.
//
// What bounds it on the H100: memory.  It reads g and the points once and
// writes the image (zero-filled by the wrapper).  At the run_id-0 shapes —
// 15 interpolant rows, P = 20000 texels, 256 x 256 x 3 — that is 3.6 + 2.4 +
// 11.8 MB ~ 17.8 MB: ~5.3 us at 3.35 TB/s.  It launches once per G update.
// The 786 KB image of a row stays in the 50 MB L2, where the atomics
// resolve; contention is low (20000 points over 65536 texels).

#include <cuda_runtime.h>

namespace {

__global__ void scatter_kernel(const float* __restrict__ g,    // (B, P, C)
                               const float* __restrict__ pts,  // (B, P, 2)
                               float* __restrict__ out,        // (B, H, W, C)
                               int B, int P, int H, int W, int C) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)B * P) return;
  const int b = (int)(idx / P);
  const float gxn = pts[idx * 2 + 0];
  const float gyn = pts[idx * 2 + 1];
  const float gx = __fsub_rn(__fmul_rn(__fadd_rn(gxn, 1.f), (float)W * 0.5f), 0.5f);
  const float gy = __fsub_rn(__fmul_rn(__fadd_rn(gyn, 1.f), (float)H * 0.5f), 0.5f);
  const float x0f = floorf(gx);
  const float y0f = floorf(gy);
  const float dx = __fsub_rn(gx, x0f);
  const float dy = __fsub_rn(gy, y0f);
  const float ex = __fsub_rn(1.f, dx);
  const float ey = __fsub_rn(1.f, dy);
  const bool vx0 = x0f >= 0.f && x0f <= (float)(W - 1);
  const bool vx1 = x0f >= -1.f && x0f <= (float)(W - 2);
  const bool vy0 = y0f >= 0.f && y0f <= (float)(H - 1);
  const bool vy1 = y0f >= -1.f && y0f <= (float)(H - 2);
  if (!((vx0 || vx1) && (vy0 || vy1))) return;
  const int x0 = (int)x0f;
  const int y0 = (int)y0f;
  const bool ok[4] = {vy0 && vx0, vy0 && vx1, vy1 && vx0, vy1 && vx1};
  const float wt[4] = {__fmul_rn(ex, ey), __fmul_rn(dx, ey), __fmul_rn(ex, dy), __fmul_rn(dx, dy)};
  const float* gp = g + idx * C;
  float* im = out + (size_t)b * H * W * C;
  for (int t = 0; t < 4; ++t) {
    if (!ok[t]) continue;
    const int y = y0 + (t >> 1);
    const int x = x0 + (t & 1);
    float* o = im + ((size_t)y * W + x) * C;
    for (int c = 0; c < C; ++c) atomicAdd(o + c, __fmul_rn(wt[t], gp[c]));
  }
}

}  // namespace

extern "C" int gif_scatter_bilinear(const void* g, const void* pts, void* out,
                                    int B, int P, int H, int W, int C,
                                    void* stream) {
  const long long n = (long long)B * P;
  const int threads = 256;
  const int blocks = (int)((n + threads - 1) / threads);
  if (blocks > 0) {
    scatter_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const float*)g, (const float*)pts, (float*)out, B, P, H, W, C);
  }
  return (int)cudaGetLastError();
}
