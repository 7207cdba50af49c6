// Transpose of bilinear point sampling: accumulate per-point cotangents into
// an NHWC float32 image — the image gradient of sample_at_points, the
// texture-interpolation loss's backward through the texture steal.
//
//   d_img[b, y, x, c] = sum over taps (y, x) of (b, p):  w_y * w_x * g[b, p, c]
//
// Replaces the TPU kernel gif_tpu/render/sampler_pallas.py::_scatter_kernel
// (called through scatter_bilinear_mxu).  The TPU kernel turned the scatter
// into one-hot bf16 matrix products, W_y^T @ (W_x * g), because the TPU has
// no fast scattered writes.  Sums are float32 here (the TPU's products were
// bf16).
//
// Design: output-stationary windows, points binned to them first.  The
// image of each batch row is cut into windows of whole rows (columns too
// where a row is wider than a window); the wrapper picks the geometry
// (render/scatter_cuda.py::scatter_launch_geometry).  Three steps on the
// stream, every size static:
//   0. clear the per-window point counts (cudaMemsetAsync, a few KB);
//   1. bin: one thread per point lists it under each window one of its
//      valid taps lands in (at most 4, usually 1).  A CTA counts its points
//      per window in shared memory, reserves each window's range with one
//      global atomicAdd, and writes the point ids there;
//   2. accumulate: one CTA per window zeroes the window in shared memory,
//      adds the products of its listed points' taps that land in it with
//      shared-memory atomics, and writes the window out once with plain
//      coalesced stores — zeros included.
// So the image is written exactly once (no separate zero-fill), no global
// atomic touches it, and each point is read by the windows it lands in.
//
// Why not the earlier designs: one thread per point with one global atomic
// per tap and channel (3.6 M f32 atomics at the run_id-0 shapes, into a
// zero-filled image) ran at 11% of its bound; windows that each scan every
// point of their row spent their time in the scan's dependent loads;
// CTA-private windows over runs of consecutive points do not apply, because
// consecutive steal points are not near each other in the image (a run of
// 256 texels spans most of the head on the synthetic mesh).
//
// The tap geometry repeats sampler.cu's rounded intrinsics operation for
// operation, so a point's taps and weights are the forward's; validity is
// decided on the float coordinates.  The shared-memory atomics add in no
// fixed order, so the result equals the plain version (an index_add_ of the
// same products) up to float32 reassociation, not bit for bit.
//
// What bounds it on the H100: memory.  It reads g and the points once from
// device memory and writes the image once (the point lists, ~5 B a point,
// stay in L2).  At the run_id-0 shapes — 15 interpolant rows, P = 20000
// texels, 256 x 256 x 3 — that is 3.6 + 2.4 + 11.8 MB ~ 17.8 MB: ~5.3 us at
// 3.35 TB/s.  It launches once per G update.

#include <cuda_runtime.h>

namespace {

constexpr int BIN_THREADS = 256;
constexpr int ACC_THREADS = 512;
constexpr int MAX_C = 4;                 // channels (scatter_cuda.MAX_CHANNELS)
constexpr int WINDOW_BYTES = 24 * 1024;  // shared memory per window (scatter_cuda.WINDOW_BYTES)
constexpr int MAX_WINDOWS = 1024;        // windows per batch row (scatter_cuda.MAX_WINDOWS)

struct Taps {
  int x0, y0;   // top-left tap
  float wt[4];  // (y0, x0), (y0, x0 + 1), (y0 + 1, x0), (y0 + 1, x0 + 1)
  bool ok[4];   // inside the image
};

// sampler.cu's tap geometry, operation for operation.
__device__ __forceinline__ bool point_taps(float2 q, int H, int W, Taps& t) {
  const float gx = __fsub_rn(__fmul_rn(__fadd_rn(q.x, 1.f), (float)W * 0.5f), 0.5f);
  const float gy = __fsub_rn(__fmul_rn(__fadd_rn(q.y, 1.f), (float)H * 0.5f), 0.5f);
  const float x0f = floorf(gx);
  const float y0f = floorf(gy);
  const bool vx0 = x0f >= 0.f && x0f <= (float)(W - 1);
  const bool vx1 = x0f >= -1.f && x0f <= (float)(W - 2);
  const bool vy0 = y0f >= 0.f && y0f <= (float)(H - 1);
  const bool vy1 = y0f >= -1.f && y0f <= (float)(H - 2);
  if (!((vx0 || vx1) && (vy0 || vy1))) return false;
  const float dx = __fsub_rn(gx, x0f);
  const float dy = __fsub_rn(gy, y0f);
  const float ex = __fsub_rn(1.f, dx);
  const float ey = __fsub_rn(1.f, dy);
  t.x0 = (int)x0f;
  t.y0 = (int)y0f;
  t.wt[0] = __fmul_rn(ex, ey);
  t.wt[1] = __fmul_rn(dx, ey);
  t.wt[2] = __fmul_rn(ex, dy);
  t.wt[3] = __fmul_rn(dx, dy);
  t.ok[0] = vy0 && vx0;
  t.ok[1] = vy0 && vx1;
  t.ok[2] = vy1 && vx0;
  t.ok[3] = vy1 && vx1;
  return true;
}

// Windows of a point's valid taps, without repeats: returns how many (<= 4).
__device__ __forceinline__ int point_windows(const Taps& t, int win_rows, int win_cols, int n_col, int w[4]) {
  int n = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (!t.ok[k]) continue;
    const int id = ((t.y0 + (k >> 1)) / win_rows) * n_col + (t.x0 + (k & 1)) / win_cols;
    bool seen = false;
    for (int j = 0; j < n; ++j) seen |= w[j] == id;
    if (!seen) w[n++] = id;
  }
  return n;
}

// 1. bin: lists[b, window, :counts[b, window]] = ids of the points with a
// tap in that window (any order).
__global__ void __launch_bounds__(BIN_THREADS)
scatter_bin(const float2* __restrict__ pts, int* __restrict__ counts, int* __restrict__ lists, int P, int H,
            int W, int win_rows, int win_cols, int n_col, int n_win) {
  __shared__ int hist[MAX_WINDOWS];
  __shared__ int base[MAX_WINDOWS];
  const int b = blockIdx.y;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  for (int i = threadIdx.x; i < n_win; i += blockDim.x) hist[i] = 0;
  __syncthreads();
  int w[4], slot[4], n = 0;
  Taps t;
  if (p < P && point_taps(__ldg(pts + (long long)b * P + p), H, W, t)) {
    n = point_windows(t, win_rows, win_cols, n_col, w);
    for (int j = 0; j < n; ++j) slot[j] = atomicAdd(hist + w[j], 1);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n_win; i += blockDim.x) {
    base[i] = hist[i] ? atomicAdd(counts + b * n_win + i, hist[i]) : 0;
  }
  __syncthreads();
  for (int j = 0; j < n; ++j) lists[((long long)b * n_win + w[j]) * P + base[w[j]] + slot[j]] = p;
}

// 2. accumulate: one CTA per (window, batch row).
__global__ void __launch_bounds__(ACC_THREADS)
scatter_accumulate(const float* __restrict__ g, const float2* __restrict__ pts, const int* __restrict__ counts,
                   const int* __restrict__ lists, float* __restrict__ out, int P, int H, int W, int C,
                   int win_rows, int win_cols, int n_col, int n_win) {
  extern __shared__ float s_win[];
  const int b = blockIdx.y;
  const int win = blockIdx.x;
  const int y_lo = (win / n_col) * win_rows;
  const int x_lo = (win % n_col) * win_cols;
  const int rows = min(win_rows, H - y_lo);
  const int cols = min(win_cols, W - x_lo);
  const int n = rows * cols * C;
  for (int i = threadIdx.x; i < n; i += blockDim.x) s_win[i] = 0.f;
  __syncthreads();

  const int count = counts[b * n_win + win];
  const int* list = lists + ((long long)b * n_win + win) * P;
  const float2* pb = pts + (long long)b * P;
  const float* gb = g + (long long)b * P * C;
  for (int i = threadIdx.x; i < count; i += ACC_THREADS) {
    const int p = __ldg(list + i);
    Taps t;
    point_taps(__ldg(pb + p), H, W, t);  // listed: it has a valid tap
    float gv[MAX_C];
#pragma unroll
    for (int c = 0; c < MAX_C; ++c) gv[c] = c < C ? __ldg(gb + (long long)p * C + c) : 0.f;
    const int wy = t.y0 - y_lo, wx = t.x0 - x_lo;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int ry = wy + (j >> 1), rx = wx + (j & 1);
      if (!(t.ok[j] && ry >= 0 && ry < rows && rx >= 0 && rx < cols)) continue;
      float* o = s_win + (ry * cols + rx) * C;
#pragma unroll
      for (int c = 0; c < MAX_C; ++c) {
        if (c < C) atomicAdd(o + c, __fmul_rn(t.wt[j], gv[c]));
      }
    }
  }
  __syncthreads();

  // Write the window once: each of its rows is a contiguous span of the
  // image (the whole window is one span when it holds whole rows).
  float* ob = out + (((long long)b * H + y_lo) * W + x_lo) * C;
  if (cols == W) {
    for (int i = threadIdx.x; i < n; i += blockDim.x) ob[i] = s_win[i];
  } else {
    const int span = cols * C;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int r = i / span;
      ob[(long long)r * W * C + (i - r * span)] = s_win[i];
    }
  }
}

}  // namespace

// counts: (B, n_row_windows * n_col_windows) int32 scratch; lists: (B, that,
// P) int32 scratch.  win_rows x win_cols pixels a window.  passes: bit 0
// clear the counts, 1 bin, 2 accumulate (7: all).
extern "C" int gif_scatter_bilinear(const void* g, const void* pts, void* out, void* counts, void* lists, int B,
                                    int P, int H, int W, int C, int win_rows, int win_cols, int n_row_windows,
                                    int n_col_windows, int passes, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  const int n_win = n_row_windows * n_col_windows;
  const size_t smem = sizeof(float) * (size_t)win_rows * win_cols * C;
  if (C > MAX_C || win_rows <= 0 || win_cols <= 0 || smem > WINDOW_BYTES || n_win > MAX_WINDOWS ||
      (long long)win_rows * n_row_windows < H || (long long)win_cols * n_col_windows < W)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSuccess;
  if (passes & 1) {
    err = cudaMemsetAsync(counts, 0, sizeof(int) * (size_t)B * n_win, st);
    if (err != cudaSuccess) return (int)err;
  }
  if ((passes & 2) && P > 0) {
    scatter_bin<<<dim3((P + BIN_THREADS - 1) / BIN_THREADS, B), BIN_THREADS, 0, st>>>(
        (const float2*)pts, (int*)counts, (int*)lists, P, H, W, win_rows, win_cols, n_col_windows, n_win);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  if (passes & 4) {
    scatter_accumulate<<<dim3(n_win, B), ACC_THREADS, smem, st>>>(
        (const float*)g, (const float2*)pts, (const int*)counts, (const int*)lists, (float*)out, P, H, W, C,
        win_rows, win_cols, n_col_windows, n_win);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}
