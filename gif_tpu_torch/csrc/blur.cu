// Separable 4-tap FIR blur with static zero pads (forward), NCHW planes.
//
// Replaces the TPU kernel gif_tpu/ops/blur_pallas.py::_blur_slab_kernel
// (called through _blur4_fwd_impl / blur4_pallas).  out[y, x] =
// sum_i sum_j t[i] t[j] xpad[y + i, x + j], where xpad carries p0y / p0x
// zero rows / columns in front; the caller passes the taps already flipped
// (the blur is a true convolution, i.e. a correlation with flipped taps).
//
// One CTA per 32x32 output tile of one (n, c) plane.  It stages the halo'd
// (32+3) x (32+3) input window in shared memory (zeros outside the plane —
// the pads never touch device memory), runs the vertical pass into a second
// shared buffer, then the horizontal pass, both in f32, and writes the
// output tile once in the input's type (bf16 or f32).
//
// What bounds it on the H100: memory — 16 multiply-adds per output against
// one input read and one output write (about 4 flops per byte in bf16).
// The design reads each input element from device memory about once (the
// 3-pixel halo re-read is (35/32)^2 - 1 ~ 20% of a tile) and never writes
// the intermediate of the first pass out.
//
// Arithmetic uses explicitly rounded intrinsics in the plain version's
// order, so the two agree bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TO = 32;          // output tile edge
constexpr int TI = TO + 3;      // input window edge (4 taps)
constexpr int THREADS = 256;

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
blur4_kernel(const T* __restrict__ x, T* __restrict__ out, int Hin, int Win,
             int Ho, int Wo, int p0y, int p0x, float t0, float t1, float t2,
             float t3) {
  __shared__ float s_in[TI][TI];
  __shared__ float s_mid[TO][TI];
  const int ox0 = blockIdx.x * TO;
  const int oy0 = blockIdx.y * TO;
  const size_t plane = blockIdx.z;
  const T* xp = x + plane * Hin * Win;
  T* op = out + plane * Ho * Wo;

  for (int i = threadIdx.x; i < TI * TI; i += THREADS) {
    const int r = i / TI, c = i - r * TI;
    const int gy = oy0 - p0y + r, gx = ox0 - p0x + c;
    s_in[r][c] = (gy >= 0 && gy < Hin && gx >= 0 && gx < Win)
                     ? load_f(xp + (size_t)gy * Win + gx)
                     : 0.f;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < TO * TI; i += THREADS) {
    const int r = i / TI, c = i - r * TI;
    float v = __fmul_rn(t0, s_in[r][c]);
    v = __fadd_rn(v, __fmul_rn(t1, s_in[r + 1][c]));
    v = __fadd_rn(v, __fmul_rn(t2, s_in[r + 2][c]));
    v = __fadd_rn(v, __fmul_rn(t3, s_in[r + 3][c]));
    s_mid[r][c] = v;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < TO * TO; i += THREADS) {
    const int r = i / TO, c = i - r * TO;
    const int oy = oy0 + r, ox = ox0 + c;
    if (oy >= Ho || ox >= Wo) continue;
    float v = __fmul_rn(t0, s_mid[r][c]);
    v = __fadd_rn(v, __fmul_rn(t1, s_mid[r][c + 1]));
    v = __fadd_rn(v, __fmul_rn(t2, s_mid[r][c + 2]));
    v = __fadd_rn(v, __fmul_rn(t3, s_mid[r][c + 3]));
    store_f(op + (size_t)oy * Wo + ox, v);
  }
}

}  // namespace

// is_bf16: 1 for bfloat16 tensors, 0 for float32.
extern "C" int gif_blur4_forward(const void* x, void* out, int planes, int Hin,
                                 int Win, int Ho, int Wo, int p0y, int p0x,
                                 int is_bf16, float t0, float t1, float t2,
                                 float t3, void* stream) {
  dim3 grid((Wo + TO - 1) / TO, (Ho + TO - 1) / TO, planes);
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) {
    blur4_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
        (const __nv_bfloat16*)x, (__nv_bfloat16*)out, Hin, Win, Ho, Wo, p0y,
        p0x, t0, t1, t2, t3);
  } else {
    blur4_kernel<float><<<grid, THREADS, 0, s>>>(
        (const float*)x, (float*)out, Hin, Win, Ho, Wo, p0y, p0x, t0, t1, t2,
        t3);
  }
  return (int)cudaGetLastError();
}
