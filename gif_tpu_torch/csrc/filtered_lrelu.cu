// StyleGAN3's filtered leaky ReLU, forward (gif_filtered_lrelu_forward) and
// backward (gif_filtered_lrelu_backward), on NCHW planes.
//
// Replaces no TPU kernel: the JAX package has no alias-free generator.  It
// computes ops/filtered_lrelu.py::filtered_lrelu_plain, per (n, c) plane:
//
//   tmp[k] = sum_t cu[t] * zp[k + t]      zp: x + b, zero-stuffed by UP,
//                                          shifted by the low pad p0
//   a[k]   = clamp(lrelu(tmp[k], slope) * gain, +-clamp)
//   out[i] = sum_s cd[s] * a[i * DOWN + s]
//
// separably along x then y, where cu (6 UP taps) and cd (6 DOWN taps) are
// the flipped filters, cu scaled by UP per axis (ops/filtered_lrelu.py
// passes them so).  The backward is the transposed chain:
//
//   da[k]   = sum_s cd[s] * dout[(k - s) / DOWN]   (k - s a multiple of DOWN)
//   dtmp[k] = da[k] * a'(tmp[k])                     gain, gain * slope or 0
//   dx[r]   = sum_t cu[t] * dtmp[r * UP + p0 - t]
//
// with tmp recomputed from x: no mask is saved, and x is what the forward
// keeps alive anyway (the convolution before it needs its own input, not
// this one's).  The bias gradient is the sum of dx: each CTA writes its
// tile's float32 sum (before dx is rounded to the map's dtype) and the
// wrapper sums the tiles.
//
// What bounds it on the H100: the upsampled map.  Written out, as the plain
// version does, it is UP^2 * 4 / (DOWN^2 * 2) ~ 8-32 bf16 output maps of
// float32 per layer, written once and read three times.  Kept on chip, the
// kernel moves only x in and the output out (2 bf16 bytes each); per output
// it then does about 66 multiply-adds at the published shapes (the up pass
// 6 taps a sample along each axis on the zero-stuffed map, the down pass
// 12), so at bf16 in and out it is bound by float32 arithmetic, and by the
// shared-memory reads that feed it, not by HBM.
//
// Design: one CTA of 256 threads per tile of one plane.  Forward: a 32 x 32
// output tile; it stages its input tile (+ bias, zero outside the map) in
// shared memory, forms the x-upsampled rows, then the upsampled tile (76 x
// 76 samples) with the activation applied, the x-downsampled rows, and
// writes the outputs.  Backward: a dx tile of 32 x 32 (UP 2) or 16 x 16
// (UP 4) inputs; it recomputes its upsampled tile's derivative from x,
// forms da from the dout tile the same way (zero-stuffed by DOWN, 6 taps a
// sample an axis), multiplies, and reduces the product by UP along x then
// y.  Every pass is register-blocked: a thread computes four consecutive
// outputs from operands it loads once from shared memory (7-8 for four up
// samples, 18 for four down samples), with the taps in registers; the up
// pass's four samples have different phases, handled by templates on the
// phase the CTA's tile starts at.  Passes along x walk rows fastest and
// passes along y columns fastest, and every staged array has an odd row
// stride, so a warp's loads fall in 32 banks.  The backward's derivative
// is the forward's upsampled value computed by the same code in the same
// order, bit for bit.  A cell of four up samples is 24 multiply-adds for 7
// loads (UP 4), of four down samples 48 for 18 (PERF.md gives the share of
// the roofline this reaches).
//
// Indices are 32-bit within a plane and 64-bit across planes; gridDim.y is
// the plane (<= 65535, checked by the wrapper).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int FS = 6;  // taps per unit of UP / DOWN
constexpr int THREADS = 256;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) { return __float2bfloat16(v); }

__device__ __forceinline__ int floor_div(int a, int b) { return a >= 0 ? a / b : -((-a + b - 1) / b); }
__device__ __forceinline__ int ceil_div(int a, int b) { return floor_div(a + b - 1, b); }

__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }
__host__ __device__ constexpr int round4(int a) { return (a + 3) / 4 * 4; }
__host__ __device__ constexpr int pmod(int a, int b) { return (a % b + b) % b; }

struct Geo {
  int C, H, W, OH, OW, p0y, p0x, tiles_x;
  float gain, slope, clamp;
};

// Register blocking: a thread computes a cell of four consecutive outputs
// along the pass's direction from operands it loads once, with every tap
// in registers.  In the up passes (and the backward's da passes) the four
// outputs have different phases; cells start on a multiple of 4, which UP
// (and DOWN) divide, so every cell of a pass starts at the same phase PH,
// a template argument picked by a CTA-uniform switch.  Passes along x walk
// rows fastest and passes along y columns fastest; every staged array has
// an odd row stride, so a warp's 32 lanes hit 32 banks either way.

__host__ __device__ constexpr int odd(int a) { return a | 1; }

// Up pass cell: out[u] = sum_q cu[ph(u) + q UP] * in[(F + off(u) + q) * stride],
// ph(u) = (PH - u) mod UP, off(u) = (u + ph(u) - PH) / UP; ``in`` points at
// input F, the first input of u = 0.
template <int UP, int PH>
__device__ __forceinline__ void up_cell(const float* in, int stride, const float (&cu)[FS * UP], float (&out)[4]) {
  constexpr int NV = FS + (3 + pmod(PH - 3, UP) - PH) / UP;
  float v[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) v[i] = in[i * stride];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int ph = pmod(PH - u, UP), off = (u + pmod(PH - u, UP) - PH) / UP;
    float acc = 0.f;
#pragma unroll
    for (int q = 0; q < FS; ++q) acc += cu[ph + q * UP] * v[off + q];
    out[u] = acc;
  }
}

// A strided cell (the forward's down pass; the backward's dx pass, with
// the taps reversed): out[u] = sum_t taps[REV ? L - 1 - t : t] * in[(u S +
// t) * stride], S the stride, L taps.
template <int S, int L, bool REV>
__device__ __forceinline__ void stride_cell(const float* in, int stride, const float (&taps)[L], float (&out)[4]) {
  constexpr int NV = 3 * S + L;
  float v[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) v[i] = in[i * stride];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    float acc = 0.f;
#pragma unroll
    for (int t = 0; t < L; ++t) acc += taps[REV ? L - 1 - t : t] * v[u * S + t];
    out[u] = acc;
  }
}

// The backward's da cell (dout zero-stuffed by DOWN, then the down taps):
// out[u] = sum_q cd[ps(u) + q DOWN] * in[(base(u) - q) * stride] for
// upsampled index k + u, ps(u) = (PS + u) mod DOWN, base(u) = (PS + u) /
// DOWN + FS - 1; ``in`` points at dout element (k - PS) / DOWN - (FS - 1).
template <int DOWN, int PS>
__device__ __forceinline__ void da_cell(const float* in, int stride, const float (&cd)[FS * DOWN], float (&out)[4]) {
  constexpr int NV = FS + (PS + 3) / DOWN;
  float v[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) v[i] = in[i * stride];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int ps = (PS + u) % DOWN, base = (PS + u) / DOWN + FS - 1;
    float acc = 0.f;
#pragma unroll
    for (int q = 0; q < FS; ++q) acc += cd[ps + q * DOWN] * v[base - q];
    out[u] = acc;
  }
}

// The up pass along x: dst[r][4c + u] (stride ds) for upsampled columns
// k0 + 4c + u from the staged rows (stride ss), r < rows, 4c < cols.
template <int UP, int PH>
__device__ __forceinline__ void up_x(const float* src, int ss, float* dst, int ds, int rows, int cols, int k0,
                                     int p0, int i0, const float (&cu)[FS * UP]) {
  for (int idx = threadIdx.x; idx < rows * (cols / 4); idx += THREADS) {
    const int c = idx / rows, r = idx - c * rows;
    float o[4];
    up_cell<UP, PH>(src + r * ss + (k0 + 4 * c + PH - p0) / UP - i0, 1, cu, o);
#pragma unroll
    for (int u = 0; u < 4; ++u) dst[r * ds + 4 * c + u] = o[u];
  }
}

// The up pass along y, then ``act``: dst[4c + u][j] for upsampled rows
// k0 + 4c + u; src and dst share the stride st.
template <int UP, int PH, typename Act>
__device__ __forceinline__ void up_y(const float* src, float* dst, int st, int rows, int cols, int k0, int p0,
                                     int i0, const float (&cu)[FS * UP], Act act) {
  for (int idx = threadIdx.x; idx < (rows / 4) * cols; idx += THREADS) {
    const int c = idx / cols, j = idx - c * cols;
    float o[4];
    up_cell<UP, PH>(src + ((k0 + 4 * c + PH - p0) / UP - i0) * st + j, st, cu, o);
#pragma unroll
    for (int u = 0; u < 4; ++u) dst[(4 * c + u) * st + j] = act(o[u]);
  }
}

// The up pass, x then y, of the staged tile (x_rows rows, stride xs_st)
// into dst (rows x cols, multiples of 4, stride st, as u1's) with ``act``.
template <int UP, typename Act>
__device__ __forceinline__ void up_pass(const float* xs, int xs_st, int x_rows, float* u1, float* dst, int st,
                                        int rows, int cols, int ky0, int kx0, int p0y, int p0x, int iy0, int ix0,
                                        const float (&cu)[FS * UP], Act act) {
  switch (pmod(p0x - kx0, UP)) {
    case 0: up_x<UP, 0>(xs, xs_st, u1, st, x_rows, cols, kx0, p0x, ix0, cu); break;
    case 1: up_x<UP, 1 % UP>(xs, xs_st, u1, st, x_rows, cols, kx0, p0x, ix0, cu); break;
    case 2: up_x<UP, 2 % UP>(xs, xs_st, u1, st, x_rows, cols, kx0, p0x, ix0, cu); break;
    default: up_x<UP, 3 % UP>(xs, xs_st, u1, st, x_rows, cols, kx0, p0x, ix0, cu); break;
  }
  __syncthreads();
  switch (pmod(p0y - ky0, UP)) {
    case 0: up_y<UP, 0>(u1, dst, st, rows, cols, ky0, p0y, iy0, cu, act); break;
    case 1: up_y<UP, 1 % UP>(u1, dst, st, rows, cols, ky0, p0y, iy0, cu, act); break;
    case 2: up_y<UP, 2 % UP>(u1, dst, st, rows, cols, ky0, p0y, iy0, cu, act); break;
    default: up_y<UP, 3 % UP>(u1, dst, st, rows, cols, ky0, p0y, iy0, cu, act); break;
  }
}

// Stage x + bias (zero outside the map) into dst[rows][cols] (stride st)
// from (y0, x0).
template <typename T>
__device__ __forceinline__ void load_tile(const T* plane, int h, int w, float bias, float* dst, int st, int rows,
                                          int cols, int y0, int x0) {
  for (int idx = threadIdx.x; idx < rows * cols; idx += THREADS) {
    const int r = idx / cols, c = idx - r * cols;
    const int gy = y0 + r, gx = x0 + c;
    dst[r * st + c] = (gy >= 0 && gy < h && gx >= 0 && gx < w) ? to_f(plane[gy * w + gx]) + bias : 0.f;
  }
}

template <int L>
__device__ __forceinline__ void taps_to_registers(const float* src, float (&dst)[L]) {
#pragma unroll
  for (int t = 0; t < L; ++t) dst[t] = src[t];
}

template <int UP, int DOWN>
struct Fwd {
  static constexpr int LU = FS * UP, LD = FS * DOWN;
  static constexpr int OT = 32;                        // output tile
  static constexpr int TN = (OT - 1) * DOWN + LD;      // upsampled samples the outputs read
  static constexpr int TT = round4(TN);                // upsampled tile (rows and columns)
  static constexpr int IT = (TT + LU) / UP + 2;        // input tile
  static constexpr int XS = odd(IT), TS = odd(TT), OS = odd(OT);  // row strides
  static constexpr int A = cmax(IT * TS, TN * OS);     // x-upsampled rows, then x-downsampled rows
  static constexpr int B = cmax(IT * XS, TT * TS);     // the input tile, then tmp
  static constexpr int SMEM = (A + B + LU + LD) * 4;
};

template <typename T, int UP, int DOWN>
__global__ void __launch_bounds__(THREADS)
    flrelu_forward(const T* __restrict__ x, const float* __restrict__ bias, const float* __restrict__ taps_u,
                   const float* __restrict__ taps_d, T* __restrict__ out, Geo g) {
  using K = Fwd<UP, DOWN>;
  extern __shared__ float sm[];
  float* A = sm;
  float* B = A + K::A;
  float* cs = B + K::B;
  const int plane = blockIdx.y;
  const int ty = blockIdx.x / g.tiles_x, tx = blockIdx.x - ty * g.tiles_x;
  const int oy0 = ty * K::OT, ox0 = tx * K::OT;
  const int ky0 = oy0 * DOWN, kx0 = ox0 * DOWN;
  const int iy0 = ceil_div(ky0 - g.p0y, UP), ix0 = ceil_div(kx0 - g.p0x, UP);
  if (threadIdx.x < K::LU) cs[threadIdx.x] = taps_u[threadIdx.x];
  if (threadIdx.x < K::LD) cs[K::LU + threadIdx.x] = taps_d[threadIdx.x];
  const T* xp = x + static_cast<long long>(plane) * g.H * g.W;
  load_tile(xp, g.H, g.W, bias[plane % g.C], B, K::XS, K::IT, K::IT, iy0, ix0);
  __syncthreads();
  float cu[K::LU], cd[K::LD];
  taps_to_registers(cs, cu);
  taps_to_registers(cs + K::LU, cd);
  const float gain = g.gain, slope = g.slope, clamp = g.clamp;
  up_pass<UP>(B, K::XS, K::IT, A, B, K::TS, K::TT, K::TT, ky0, kx0, g.p0y, g.p0x, iy0, ix0, cu, [=](float t) {
    return fminf(fmaxf((t >= 0.f ? t : t * slope) * gain, -clamp), clamp);
  });
  __syncthreads();
  // Down along x: the rows of tmp the outputs read, by cells of 4 output
  // columns.
  for (int idx = threadIdx.x; idx < K::TN * (K::OT / 4); idx += THREADS) {
    const int c = idx / K::TN, i = idx - c * K::TN;
    float o[4];
    stride_cell<DOWN, K::LD, false>(B + i * K::TS + 4 * c * DOWN, 1, cd, o);
#pragma unroll
    for (int u = 0; u < 4; ++u) A[i * K::OS + 4 * c + u] = o[u];
  }
  __syncthreads();
  // Down along y: cells of 4 output rows by output columns.
  T* op = out + static_cast<long long>(plane) * g.OH * g.OW;
  for (int idx = threadIdx.x; idx < (K::OT / 4) * K::OT; idx += THREADS) {
    const int c = idx / K::OT, j = idx - c * K::OT;
    float o[4];
    stride_cell<DOWN, K::LD, false>(A + 4 * c * DOWN * K::OS + j, K::OS, cd, o);
    const int ox = ox0 + j;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int oy = oy0 + 4 * c + u;
      if (oy < g.OH && ox < g.OW) op[oy * g.OW + ox] = from_f<T>(o[u]);
    }
  }
}

template <int UP, int DOWN>
struct Bwd {
  static constexpr int LU = FS * UP, LD = FS * DOWN;
  static constexpr int RT = 64 / UP;                        // dx tile
  static constexpr int TN = (RT - 1) * UP + LU;             // upsampled samples the dx tile reads
  static constexpr int TT = round4(TN);                     // upsampled tile
  static constexpr int XT = (TT + LU) / UP + 2;             // x tile
  static constexpr int DT = (TT + LD) / DOWN + 2;           // dout tile
  static constexpr int XS = odd(XT), TS = odd(TT), DS = odd(DT), RS = odd(RT);  // row strides
  static constexpr int P = cmax(XT * XS, DT * DS);          // x tile, then dout tile
  static constexpr int Q = cmax(cmax(XT * TS, DT * TS), TN * RS);  // x-upsampled, da along x, dx along x
  static constexpr int R = TT * TS;                         // a'(tmp), then dtmp
  static constexpr int SMEM = (P + Q + R + LU + LD) * 4;
};

template <int DOWN, int PS>
__device__ __forceinline__ void da_x(const float* src, int ss, float* dst, int ds, int rows, int cols, int k0, int d0,
                                     const float (&cd)[FS * DOWN]) {
  for (int idx = threadIdx.x; idx < rows * (cols / 4); idx += THREADS) {
    const int c = idx / rows, r = idx - c * rows;
    float o[4];
    da_cell<DOWN, PS>(src + r * ss + (k0 + 4 * c - PS) / DOWN - (FS - 1) - d0, 1, cd, o);
#pragma unroll
    for (int u = 0; u < 4; ++u) dst[r * ds + 4 * c + u] = o[u];
  }
}

// da along y, times the derivative already in ``r``: r <- dtmp.
template <int DOWN, int PS>
__device__ __forceinline__ void da_y(const float* e1, float* r, int st, int rows, int cols, int k0, int d0,
                                     const float (&cd)[FS * DOWN]) {
  for (int idx = threadIdx.x; idx < (rows / 4) * cols; idx += THREADS) {
    const int c = idx / cols, j = idx - c * cols;
    float o[4];
    da_cell<DOWN, PS>(e1 + ((k0 + 4 * c - PS) / DOWN - (FS - 1) - d0) * st + j, st, cd, o);
#pragma unroll
    for (int u = 0; u < 4; ++u) r[(4 * c + u) * st + j] *= o[u];
  }
}

template <typename T, int UP, int DOWN>
__global__ void __launch_bounds__(THREADS)
    flrelu_backward(const T* __restrict__ x, const float* __restrict__ bias, const T* __restrict__ dy,
                    const float* __restrict__ taps_u, const float* __restrict__ taps_d, T* __restrict__ dx,
                    float* __restrict__ db_part, Geo g) {
  using K = Bwd<UP, DOWN>;
  extern __shared__ float sm[];
  float* P = sm;
  float* Q = P + K::P;
  float* R = Q + K::Q;
  float* cs = R + K::R;
  const int plane = blockIdx.y;
  const int ty = blockIdx.x / g.tiles_x, tx = blockIdx.x - ty * g.tiles_x;
  const int ry0 = ty * K::RT, rx0 = tx * K::RT;
  const int ky0 = ry0 * UP + g.p0y - (K::LU - 1), kx0 = rx0 * UP + g.p0x - (K::LU - 1);
  const int iy0 = ceil_div(ky0 - g.p0y, UP), ix0 = ceil_div(kx0 - g.p0x, UP);
  const int dy0 = ceil_div(ky0 - K::LD + 1, DOWN), dx0 = ceil_div(kx0 - K::LD + 1, DOWN);
  if (threadIdx.x < K::LU) cs[threadIdx.x] = taps_u[threadIdx.x];
  if (threadIdx.x < K::LD) cs[K::LU + threadIdx.x] = taps_d[threadIdx.x];
  const long long pin = static_cast<long long>(plane) * g.H * g.W;
  load_tile(x + pin, g.H, g.W, bias[plane % g.C], P, K::XS, K::XT, K::XT, iy0, ix0);
  __syncthreads();
  float cu[K::LU], cd[K::LD];
  taps_to_registers(cs, cu);
  taps_to_registers(cs + K::LU, cd);
  const float gain = g.gain, slope = g.slope, clamp = g.clamp;
  // a'(tmp): the forward's tmp, recomputed in its order.
  up_pass<UP>(P, K::XS, K::XT, Q, R, K::TS, K::TT, K::TT, ky0, kx0, g.p0y, g.p0x, iy0, ix0, cu, [=](float t) {
    const float s = t >= 0.f ? 1.f : slope;
    return fabsf(t * s * gain) <= clamp ? s * gain : 0.f;
  });
  // The dout tile (zero outside the map: da is 0 past the last upsampled
  // sample an output reads).
  const T* dyp = dy + static_cast<long long>(plane) * g.OH * g.OW;
  for (int idx = threadIdx.x; idx < K::DT * K::DT; idx += THREADS) {
    const int r = idx / K::DT, c = idx - r * K::DT;
    const int gy = dy0 + r, gx = dx0 + c;
    P[r * K::DS + c] = (gy >= 0 && gy < g.OH && gx >= 0 && gx < g.OW) ? to_f(dyp[gy * g.OW + gx]) : 0.f;
  }
  __syncthreads();
  // da along x: dout rows by upsampled columns, then along y times a'.
  if (pmod(kx0, DOWN) == 0) {
    da_x<DOWN, 0>(P, K::DS, Q, K::TS, K::DT, K::TT, kx0, dx0, cd);
  } else {
    da_x<DOWN, 1 % DOWN>(P, K::DS, Q, K::TS, K::DT, K::TT, kx0, dx0, cd);
  }
  __syncthreads();
  if (pmod(ky0, DOWN) == 0) {
    da_y<DOWN, 0>(Q, R, K::TS, K::TT, K::TT, ky0, dy0, cd);
  } else {
    da_y<DOWN, 1 % DOWN>(Q, R, K::TS, K::TT, K::TT, ky0, dy0, cd);
  }
  __syncthreads();
  // dx along x: the upsampled rows the dx tile reads, by cells of 4 dx
  // columns.
  for (int idx = threadIdx.x; idx < K::TN * (K::RT / 4); idx += THREADS) {
    const int c = idx / K::TN, i = idx - c * K::TN;
    float o[4];
    stride_cell<UP, K::LU, true>(R + i * K::TS + 4 * c * UP, 1, cu, o);
#pragma unroll
    for (int u = 0; u < 4; ++u) Q[i * K::RS + 4 * c + u] = o[u];
  }
  __syncthreads();
  T* dxp = dx + pin;
  float part = 0.f;  // this thread's share of the tile's bias gradient, in float32
  for (int idx = threadIdx.x; idx < (K::RT / 4) * K::RT; idx += THREADS) {
    const int c = idx / K::RT, j = idx - c * K::RT;
    float o[4];
    stride_cell<UP, K::LU, true>(Q + 4 * c * UP * K::RS + j, K::RS, cu, o);
    const int gx = rx0 + j;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int gy = ry0 + 4 * c + u;
      if (gy < g.H && gx < g.W) {
        dxp[gy * g.W + gx] = from_f<T>(o[u]);
        part += o[u];
      }
    }
  }
  // The tile's sum of dx before rounding, in a fixed order: warps, then
  // the CTA's eight warp sums (the caller sums the tiles).
  for (int o = 16; o > 0; o >>= 1) part += __shfl_down_sync(0xffffffffu, part, o);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) P[threadIdx.x >> 5] = part;
  __syncthreads();
  if (threadIdx.x == 0) {
    float sum = 0.f;
    for (int w = 0; w < THREADS / 32; ++w) sum += P[w];
    db_part[static_cast<long long>(plane) * gridDim.x + blockIdx.x] = sum;
  }
}

template <typename T, int UP, int DOWN>
int launch_forward(const void* x, const void* bias, const void* tu, const void* td, void* out, int planes,
                   int tiles_y, const Geo& g, cudaStream_t s) {
  auto kern = flrelu_forward<T, UP, DOWN>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Fwd<UP, DOWN>::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(g.tiles_x * tiles_y, planes);
  kern<<<grid, THREADS, Fwd<UP, DOWN>::SMEM, s>>>(static_cast<const T*>(x), static_cast<const float*>(bias),
                                                  static_cast<const float*>(tu), static_cast<const float*>(td),
                                                  static_cast<T*>(out), g);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int UP, int DOWN>
int launch_backward(const void* x, const void* bias, const void* dy, const void* tu, const void* td, void* dx,
                    void* db_part, int planes, int tiles_y, const Geo& g, cudaStream_t s) {
  auto kern = flrelu_backward<T, UP, DOWN>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Bwd<UP, DOWN>::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(g.tiles_x * tiles_y, planes);
  kern<<<grid, THREADS, Bwd<UP, DOWN>::SMEM, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(bias), static_cast<const T*>(dy),
      static_cast<const float*>(tu), static_cast<const float*>(td), static_cast<T*>(dx),
      static_cast<float*>(db_part), g);
  return static_cast<int>(cudaGetLastError());
}

bool valid(int planes, int tiles_x, int tiles_y, int up, int down) {
  return planes > 0 && planes <= 65535 && tiles_x > 0 && tiles_y > 0 && down == 2 && (up == 2 || up == 4);
}

}  // namespace

// x (planes, H, W) -> out (planes, OH, OW); bias[C] (plane % C is the
// channel), taps_u[6 up] and taps_d[6 down] as the header says; p0y / p0x:
// the up pass's low pads (negative crops); tiles of 32 x 32 outputs.
extern "C" int gif_filtered_lrelu_forward(const void* x, const void* bias, const void* taps_u,
                                          const void* taps_d, void* out, int planes, int C, int H, int W,
                                          int OH, int OW, int up, int down, int p0y, int p0x, int tiles_x,
                                          int tiles_y, int is_bf16, float gain, float slope, float clamp,
                                          void* stream) {
  if (!valid(planes, tiles_x, tiles_y, up, down)) return static_cast<int>(cudaErrorInvalidValue);
  const Geo g{C, H, W, OH, OW, p0y, p0x, tiles_x, gain, slope, clamp};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (up == 2) {
    return is_bf16 ? launch_forward<__nv_bfloat16, 2, 2>(x, bias, taps_u, taps_d, out, planes, tiles_y, g, s)
                   : launch_forward<float, 2, 2>(x, bias, taps_u, taps_d, out, planes, tiles_y, g, s);
  }
  return is_bf16 ? launch_forward<__nv_bfloat16, 4, 2>(x, bias, taps_u, taps_d, out, planes, tiles_y, g, s)
                 : launch_forward<float, 4, 2>(x, bias, taps_u, taps_d, out, planes, tiles_y, g, s);
}

// dx (planes, H, W) from x, bias and dy (planes, OH, OW); tiles of 32 x 32
// (up 2) or 16 x 16 (up 4) inputs; db_part (planes, tiles): each tile's
// float32 sum of its dx, for the bias gradient.
extern "C" int gif_filtered_lrelu_backward(const void* x, const void* bias, const void* dy, const void* taps_u,
                                           const void* taps_d, void* dx, void* db_part, int planes, int C,
                                           int H, int W,
                                           int OH, int OW, int up, int down, int p0y, int p0x, int tiles_x,
                                           int tiles_y, int is_bf16, float gain, float slope, float clamp,
                                           void* stream) {
  if (!valid(planes, tiles_x, tiles_y, up, down)) return static_cast<int>(cudaErrorInvalidValue);
  const Geo g{C, H, W, OH, OW, p0y, p0x, tiles_x, gain, slope, clamp};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (up == 2) {
    return is_bf16
               ? launch_backward<__nv_bfloat16, 2, 2>(x, bias, dy, taps_u, taps_d, dx, db_part, planes, tiles_y, g, s)
               : launch_backward<float, 2, 2>(x, bias, dy, taps_u, taps_d, dx, db_part, planes, tiles_y, g, s);
  }
  return is_bf16
             ? launch_backward<__nv_bfloat16, 4, 2>(x, bias, dy, taps_u, taps_d, dx, db_part, planes, tiles_y, g, s)
             : launch_backward<float, 4, 2>(x, bias, dy, taps_u, taps_d, dx, db_part, planes, tiles_y, g, s);
}
