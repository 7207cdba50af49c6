// Bilinear grid_sample (zeros padding, align_corners=False) on float32
// images laid out (B, H, W, C) through any positive element strides — the
// renderer's albedo lookup (NHWC-contiguous) and the texture steal's
// sampling of the generator output (an NHWC view of NCHW memory), forward.
//
// Replaces the TPU kernel gif_tpu/render/sampler_pallas.py::_sampler_kernel
// (called through _sampler_fwd_impl / grid_sample_bilinear_mxu).  The TPU
// kernel turned the random-access lookup into one-hot matrix products on
// the matrix unit because the TPU gathers slowly; Hopper gathers through
// its L1/L2 caches, so this is the direct form: four taps per output
// pixel, taps outside the image contribute zero
// (gif_tpu/render/shading.py:140-159).
//
// What bounds it on the H100: memory — it reads the grid and C values per
// tap and writes C values per pixel, a handful of flops per byte.  A
// sample's texture (768 KB) stays resident in L2, so the taps' scattered
// reads cost little DRAM traffic.  Design:
// - the image is read in place through its four strides (no copy of a
//   strided view: the steal reads G's NCHW output directly);
// - one thread per output pixel, 256 consecutive pixels a CTA, so a
//   warp's grid loads (one float2 a pixel, through the read-only path) are
//   coalesced; taps through the read-only path (__ldg).  More pixels per
//   thread measured slower on the H100: fewer CTAs in flight hide less
//   latency;
// - the CTA stages its (pixels x C) outputs in shared memory and writes
//   them out as 16-byte vectors, contiguous across the warp (a thread's C
//   scalar stores at a 4C-byte stride used a third of each request);
// - taps come one channel at a time where the channels lie in planes of
//   their own (the steal's NCHW memory: channel stride > 1), all channels
//   at once where they are interleaved (the NHWC albedo map).  The steal's
//   points land anywhere in the image, so each tap load of a warp touches
//   32 lines; with all 12 loads of a pixel in flight the steal measured
//   slower on the H100 than with one channel's 4 (and than F.grid_sample,
//   which also takes a channel at a time), while on interleaved memory,
//   where a tap's channels share a sector, all at once measured faster.
//
// Arithmetic uses explicitly rounded intrinsics in the plain version's
// order, so the two agree bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

template <int C, bool PLANAR>
__global__ void __launch_bounds__(THREADS)
sampler_kernel(const float* __restrict__ img,   // (B, H, W, C), strided
               const float* __restrict__ grid,  // (B, P, 2), strided
               float* __restrict__ out,         // (B, P, C), contiguous
               int H, int W, int P, unsigned total, int sb, int sh, int sw,
               int sc, int gb, int gp) {
  __shared__ __align__(16) float s_out[THREADS * C];
  const unsigned base = blockIdx.x * THREADS;
  const unsigned g = base + threadIdx.x;
  if (g < total) {
    const unsigned b = g / P;
    const unsigned p = g - b * P;
    const float2 pt = __ldg(reinterpret_cast<const float2*>(
        grid + static_cast<size_t>(b) * gb + static_cast<size_t>(p) * gp));
    const float gx = __fsub_rn(__fmul_rn(__fadd_rn(pt.x, 1.f), (float)W * 0.5f), 0.5f);
    const float gy = __fsub_rn(__fmul_rn(__fadd_rn(pt.y, 1.f), (float)H * 0.5f), 0.5f);
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
    const float* t00 = img + static_cast<size_t>(b) * sb + static_cast<ptrdiff_t>(y0) * sh +
                       static_cast<ptrdiff_t>(x0) * sw;
    const float* t10 = t00 + sh;
    // Planar: one channel's four taps in flight at a time (see above).
#pragma unroll(PLANAR ? 1 : C)
    for (int c = 0; c < C; ++c) {
      const ptrdiff_t o = static_cast<ptrdiff_t>(c) * sc;
      const float v00 = vy0 && vx0 ? __ldg(t00 + o) : 0.f;
      const float v01 = vy0 && vx1 ? __ldg(t00 + o + sw) : 0.f;
      const float v10 = vy1 && vx0 ? __ldg(t10 + o) : 0.f;
      const float v11 = vy1 && vx1 ? __ldg(t10 + o + sw) : 0.f;
      float acc = __fmul_rn(__fmul_rn(v00, ex), ey);
      acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(v01, dx), ey));
      acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(v10, ex), dy));
      acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(v11, dx), dy));
      s_out[threadIdx.x * C + c] = acc;
    }
  }
  __syncthreads();
  // The CTA's outputs are out[base * C, (base + n) * C): 16-byte aligned
  // (base is a multiple of THREADS), written as float4s, then the ragged
  // tail of the last CTA as scalars.
  const unsigned n = min(total - base, static_cast<unsigned>(THREADS)) * C;
  float* o = out + static_cast<size_t>(base) * C;
  const unsigned n4 = n / 4;
  for (unsigned i = threadIdx.x; i < n4; i += THREADS) {
    reinterpret_cast<float4*>(o)[i] = reinterpret_cast<const float4*>(s_out)[i];
  }
  for (unsigned i = n4 * 4 + threadIdx.x; i < n; i += THREADS) o[i] = s_out[i];
}

template <int C>
void launch(const float* img, const float* grid, float* out, int blocks, int H,
            int W, int P, unsigned total, int sb, int sh, int sw, int sc,
            int gb, int gp, cudaStream_t s) {
  if (sc > 1) {
    sampler_kernel<C, true><<<blocks, THREADS, 0, s>>>(img, grid, out, H, W, P, total,
                                                       sb, sh, sw, sc, gb, gp);
  } else {
    sampler_kernel<C, false><<<blocks, THREADS, 0, s>>>(img, grid, out, H, W, P, total,
                                                        sb, sh, sw, sc, gb, gp);
  }
}

}  // namespace

// Image element strides (sb, sh, sw, sc), grid element strides (gb: batch,
// gp: point; the point's two coordinates adjacent and 8-byte aligned) as
// render/sampler_cuda.py::sampler_strides checks them; C in 1..4.
extern "C" int gif_sampler_forward(const void* img, const void* grid, void* out,
                                   int B, int H, int W, int C, int P, int sb,
                                   int sh, int sw, int sc, int gb, int gp,
                                   void* stream) {
  const unsigned total = static_cast<unsigned>(B) * static_cast<unsigned>(P);
  const int blocks = static_cast<int>((total + THREADS - 1) / THREADS);
  if (blocks == 0) return static_cast<int>(cudaErrorInvalidValue);
  const float* im = static_cast<const float*>(img);
  const float* gr = static_cast<const float*>(grid);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 1: launch<1>(im, gr, o, blocks, H, W, P, total, sb, sh, sw, sc, gb, gp, s); break;
    case 2: launch<2>(im, gr, o, blocks, H, W, P, total, sb, sh, sw, sc, gb, gp, s); break;
    case 3: launch<3>(im, gr, o, blocks, H, W, P, total, sb, sh, sw, sc, gb, gp, s); break;
    case 4: launch<4>(im, gr, o, blocks, H, W, P, total, sb, sh, sw, sc, gb, gp, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
