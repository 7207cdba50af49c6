// Separable 4-tap FIR blur with static zero pads (forward), on NCHW planes
// (gif_blur4_forward) or on channels-last maps (gif_blur4_forward_nhwc).
//
// Replaces the TPU kernel gif_tpu/ops/blur_pallas.py::_blur_slab_kernel
// (called through _blur4_fwd_impl / blur4_pallas).  out[y, x] =
// sum_i sum_j t[i] t[j] xpad[y + i, x + j], where xpad carries p0y / p0x
// zero rows / columns in front; the caller passes the taps already flipped
// (the blur is a true convolution, i.e. a correlation with flipped taps).
// The VJP is this kernel too, with the taps reversed and pads 3 - p.
//
// What bounds it on the H100: memory — 16 multiply-adds per output against
// one input read and one output write (about 4 flops per byte in bf16).
//
// Design, by map size (ops/blur_cuda.py::blur4_launch_geometry):
// - Maps of more than 24 px go in strips, register-tiled, with no shared
//   memory on the input side and no __syncthreads.  Each thread owns OC = 8
//   output columns by R output rows (R = 8 or 16, a template parameter) of
//   one (n, c) plane and walks down them: per step it reads one row of its
//   OC + 3 input columns, adds it into three running vertical sums (the
//   sum that row completes goes to the horizontal pass; the order of the
//   terms is the plain version's), and stores one output row.  Threads are
//   laid out column group fastest, then row strip, then plane
//   (::blur4_thread_tiles mirrors it), so a warp covers 256 output columns
//   of a wide map; the 3-row halo of the next strip (3 / R of the input)
//   comes from L2.  The next input row is loaded before the current one is
//   used (PF), and three CTAs fit an SM (MIN_CTAS): on the H100 occupancy
//   hid more latency than deeper prefetch at fewer CTAs.
//   - Rows that start on 16-byte boundaries (width a multiple of 8) are
//     read as one 16-byte load a thread, the 3-column halo taken from the
//     neighbour lanes by shuffles (blur4_strips_vec); other rows as OC + 3
//     scalar loads a thread, the halo from L1 (blur4_strips).
//   - Output rows go out as one 16-byte store a thread when they are
//     aligned and whole; otherwise the warp stages its 32 x 8 values in
//     shared memory and writes them element-major, so consecutive lanes
//     store consecutive addresses (a thread storing its own 8 values at a
//     16-byte lane stride sent each 32-byte sector to L2 in pieces, and ran
//     at half the speed).
// - Maps of up to 24 px go whole-plane (blur4_planes): a CTA stages about
//   2048 outputs' worth of consecutive planes — one contiguous span — in
//   shared memory with coalesced loads, then writes its outputs in order.
//   Strips there would give each warp instruction 32 planes' scattered
//   addresses.
//
// Channels-last maps (blur4_nhwc): x is (N, Hin, Win, C) in memory and
// out (N, Ho, Wo, C), channels fastest — the discriminator's layout.  The
// bound is the same bytes: each input read once, each output written once.
// C is contiguous, so a thread owns V channels, 16 bytes (V = 8 in bf16, 4
// in f32; V = 1 where C is not a multiple of that or a base is off the
// 16-byte grid), of one output row, and walks a strip of `cols` output
// columns along x: at each input column it reads the four input rows of its
// output row as four 16-byte loads (the next column's loads in flight
// before this column is used), forms the vertical sums, and carries the
// horizontal pass in three running partial sums, storing one 16-byte
// vector per output column.  No shared memory, no synchronisation, V x 3
// partials in registers.  Lanes take consecutive channel groups of one
// pixel (a warp moves up to 512 contiguous bytes, whole sectors at the
// discriminator's 128-512 channels), and a CTA's warps take consecutive
// output rows of the same channels and column strip, so each input row a
// thread reads is read by up to three neighbours in the CTA too: it comes
// from device memory about once, the 3-row halo between CTAs and the
// 3-column halo between strips (3 / cols) from L2.
// (ops/blur_cuda.py::blur4_nhwc_geometry picks V, the channel blocks and
// the strip length, which shrinks on small maps to keep the card full.)
//
// Arithmetic uses explicitly rounded intrinsics in the plain version's
// order (t0*a + t1*b + t2*c + t3*d, left to right; vertical pass first),
// so the two agree bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int OC = 8;          // output columns per thread
constexpr int IC = OC + 3;     // input columns per thread (4 taps)
constexpr int THREADS = 256;

__device__ __forceinline__ float load_f(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  const unsigned short u = __ldg(reinterpret_cast<const unsigned short*>(p));
  return __uint_as_float(static_cast<unsigned>(u) << 16);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ unsigned pack_bf16x2(float lo, float hi) {
  return static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         (static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(hi))) << 16);
}

// One output row of OC values as 16-byte stores (the caller checked that
// the row and its start are 16-byte aligned).
__device__ __forceinline__ void store_row_vec(float* p, const float* o) {
  reinterpret_cast<float4*>(p)[0] = make_float4(o[0], o[1], o[2], o[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(o[4], o[5], o[6], o[7]);
}
__device__ __forceinline__ void store_row_vec(__nv_bfloat16* p, const float* o) {
  *reinterpret_cast<uint4*>(p) =
      make_uint4(pack_bf16x2(o[0], o[1]), pack_bf16x2(o[2], o[3]),
                 pack_bf16x2(o[4], o[5]), pack_bf16x2(o[6], o[7]));
}

__device__ __forceinline__ float tap4(float t0, float t1, float t2, float t3,
                                      float a, float b, float c, float d) {
  float v = __fmul_rn(t0, a);
  v = __fadd_rn(v, __fmul_rn(t1, b));
  v = __fadd_rn(v, __fmul_rn(t2, c));
  return __fadd_rn(v, __fmul_rn(t3, d));
}

// The 8 elements at a 16-byte aligned address as 32-bit words (bf16: 4
// words of two; f32: 8 words), and element e of such words as a float.
template <typename T> struct Chunk;
template <> struct Chunk<__nv_bfloat16> {
  static constexpr int NW = 4;
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, unsigned* w) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  }
  static __device__ __forceinline__ float elem(const unsigned* w, int e) {
    return __uint_as_float(e & 1 ? (w[e >> 1] & 0xffff0000u) : (w[e >> 1] << 16));
  }
};
template <> struct Chunk<float> {
  static constexpr int NW = 8;
  static __device__ __forceinline__ void load(const float* p, unsigned* w) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
    w[0] = __float_as_uint(a.x); w[1] = __float_as_uint(a.y);
    w[2] = __float_as_uint(a.z); w[3] = __float_as_uint(a.w);
    w[4] = __float_as_uint(b.x); w[5] = __float_as_uint(b.y);
    w[6] = __float_as_uint(b.z); w[7] = __float_as_uint(b.w);
  }
  static __device__ __forceinline__ float elem(const unsigned* w, int e) {
    return __uint_as_float(w[e]);
  }
};

// One input row w (the thread's IC columns) into the running vertical sums
// of the strip: a2 holds t0*x[k-3] + t1*x[k-2] + t2*x[k-1] for output row
// k - 3, which this row completes into v; a1 and a0 move up a row and a0
// restarts at t0*x[k].  Each sum is formed left to right as the plain
// version forms it, one rounded product and one rounded add per row.
__device__ __forceinline__ void accumulate(const float* w, float* a0, float* a1,
                                           float* a2, float* v, float t0,
                                           float t1, float t2, float t3) {
#pragma unroll
  for (int j = 0; j < IC; ++j) {
    v[j] = __fadd_rn(a2[j], __fmul_rn(t3, w[j]));
    a2[j] = __fadd_rn(a1[j], __fmul_rn(t2, w[j]));
    a1[j] = __fadd_rn(a0[j], __fmul_rn(t1, w[j]));
    a0[j] = __fmul_rn(t0, w[j]);
  }
}

// The horizontal pass of one output row from its vertical sums.
__device__ __forceinline__ void row_out(const float* v, float* o, float t0,
                                        float t1, float t2, float t3) {
#pragma unroll
  for (int j = 0; j < OC; ++j) o[j] = tap4(t0, t1, t2, t3, v[j], v[j + 1], v[j + 2], v[j + 3]);
}

// Per-warp staging for stores of rows that do not start on 16-byte
// boundaries: 32 x OC floats, one pad after every 32 so that both the
// writes (lane-major) and the reads (element-major) are free of bank
// conflicts.
constexpr int WARP_BUF = 32 * OC + OC;

// Stores the warp's output rows: 16-byte vectors when every row is aligned
// and whole (vec_store), else through the warp's staging buffer, so that
// lane l writes elements l, l + 32, ... of the warp's 32 x OC values, each
// at its owner's offset — consecutive addresses across the warp wherever
// neighbouring lanes hold neighbouring column groups of one row (a thread
// storing its own 8 values at a 16-byte lane stride would send every
// 32-byte sector to L2 in pieces).  All lanes of the warp call it.
// row_off: the element offset of the thread's row in out; nvalid: how many
// of its OC values to store (0 for none).
template <typename T>
__device__ __forceinline__ void store_row(T* __restrict__ out, const float* o,
                                          int row_off, int nvalid, bool vec_store,
                                          float* wbuf, int lane) {
  if (vec_store) {
    if (nvalid > 0) store_row_vec(out + row_off, o);
    return;
  }
  __syncwarp();
#pragma unroll
  for (int j = 0; j < OC; ++j) {
    const int e = lane * OC + j;
    wbuf[e + e / 32] = o[j];
  }
  __syncwarp();
#pragma unroll
  for (int k = 0; k < OC; ++k) {
    const int e = lane + 32 * k;
    const int owner = e / OC;
    const int off = __shfl_sync(0xffffffffu, row_off, owner);
    const int nv = __shfl_sync(0xffffffffu, nvalid, owner);
    if (e % OC < nv) store_f(out + off + e % OC, wbuf[e + k]);
  }
}

// Input rows are loaded PF rows ahead of the row in use, so each warp has
// PF + 1 rows of loads in flight; the strips' CTAs keep their registers
// under 65536 / (3 * THREADS), so three CTAs fit an SM.
constexpr int PF = 1;
constexpr int MIN_CTAS = 3;

template <typename T>
__device__ __forceinline__ void load_row_scalar(const T* xp, int gy, int Hin,
                                                int Win, int gx0,
                                                unsigned colmask, float* v) {
  const bool rv = gy >= 0 && gy < Hin;
  const T* row = xp + static_cast<ptrdiff_t>(gy) * Win + gx0;
#pragma unroll
  for (int j = 0; j < IC; ++j) v[j] = (rv && ((colmask >> j) & 1u)) ? load_f(row + j) : 0.f;
}

// Strips, any row width: each thread reads its OC + 3 input columns of a
// row as scalars (the 3-column halo from L1).
template <typename T, int R>
__global__ void __launch_bounds__(THREADS, MIN_CTAS)
blur4_strips(const T* __restrict__ x, T* __restrict__ out, unsigned n_threads,
             int col_groups, int row_strips, int Hin, int Win, int Ho, int Wo,
             int p0y, int p0x, int vec_store, float t0, float t1, float t2,
             float t3) {
  __shared__ float s_buf[THREADS / 32][WARP_BUF];
  const unsigned t = blockIdx.x * THREADS + threadIdx.x;
  const int lane = threadIdx.x & 31;
  // No early exit: every lane takes part in the warp's stores.
  const bool live = t < n_threads;
  // Column group fastest, then row strip, then plane (blur4_thread_tiles).
  const unsigned cg = t % col_groups;
  const unsigned strip = t / col_groups;
  const int ox0 = cg * OC;
  const int oy0 = (strip % row_strips) * R;
  const size_t plane = live ? strip / row_strips : 0;
  const int gx0 = ox0 - p0x;
  const int gy0 = oy0 - p0y;
  const T* xp = x + plane * Hin * Win;
  const int plane_off = static_cast<int>(plane * Ho * Wo) + ox0;
  const int ncols = live ? min(OC, Wo - ox0) : 0;
  unsigned colmask = 0;
#pragma unroll
  for (int j = 0; j < IC; ++j) {
    colmask |= (live && gx0 + j >= 0 && gx0 + j < Win) ? 1u << j : 0u;
  }

  float in[R + 3][IC];
#pragma unroll
  for (int r = 0; r < PF; ++r) load_row_scalar(xp, gy0 + r, Hin, Win, gx0, colmask, in[r]);
  float a0[IC] = {}, a1[IC] = {}, a2[IC] = {}, v[IC];
#pragma unroll
  for (int r = 0; r < R + 3; ++r) {
    if (r + PF < R + 3) load_row_scalar(xp, gy0 + r + PF, Hin, Win, gx0, colmask, in[r + PF]);
    accumulate(in[r], a0, a1, a2, v, t0, t1, t2, t3);
    if (r < 3) continue;
    const int oy = oy0 + r - 3;
    float o[OC];
    row_out(v, o, t0, t1, t2, t3);
    store_row(out, o, plane_off + oy * Wo, oy < Ho ? ncols : 0, vec_store,
              s_buf[threadIdx.x / 32], lane);
  }
}

// One input row of a 16-byte-aligned strip thread: its own chunk, and the
// halo values it reads from memory itself (only at a warp's edge).  Of the
// window [ox0 - 4, ox0 + 12) the strip uses [ox0 - P0X, ox0 + 11 - P0X):
// P0X values on the left, 3 - P0X on the right.
template <typename T, int P0X>
struct VecRow {
  unsigned own[Chunk<T>::NW];
  float left[3], right[3];
};

template <typename T, int P0X>
__device__ __forceinline__ void load_row_vec(const T* xp, int gy, int Hin,
                                             int Win, int ox0, bool own_ok,
                                             bool left_mem, bool right_mem,
                                             VecRow<T, P0X>& v) {
  const bool rv = gy >= 0 && gy < Hin;
  const T* row = xp + static_cast<ptrdiff_t>(gy) * Win + ox0;
#pragma unroll
  for (int k = 0; k < Chunk<T>::NW; ++k) v.own[k] = 0u;
  if (rv && own_ok) Chunk<T>::load(row, v.own);
#pragma unroll
  for (int k = 0; k < P0X; ++k) v.left[k] = (rv && left_mem) ? load_f(row - P0X + k) : 0.f;
#pragma unroll
  for (int k = 0; k < 3 - P0X; ++k) v.right[k] = (rv && right_mem) ? load_f(row + OC + k) : 0.f;
}

// Strips on 16-byte aligned rows (Win a multiple of 8 and an aligned
// base): each thread reads the 8 input columns [ox0, ox0 + 8) of a row as
// one 16-byte load and takes the halo from its neighbour lanes by
// shuffles; only a lane at a warp's edge reads its halo from memory.
// Every line is then requested once per warp instruction.  P0X = p0x is a
// template parameter, so the window's offset is a register index known at
// compile time.
template <typename T, int R, int P0X>
__global__ void __launch_bounds__(THREADS, MIN_CTAS)
blur4_strips_vec(const T* __restrict__ x, T* __restrict__ out,
                 unsigned n_threads, int col_groups, int row_strips, int Hin,
                 int Win, int Ho, int Wo, int p0y, int vec_store, float t0,
                 float t1, float t2, float t3) {
  using CH = Chunk<T>;
  constexpr int NW = CH::NW;
  __shared__ float s_buf[THREADS / 32][WARP_BUF];
  const unsigned t = blockIdx.x * THREADS + threadIdx.x;
  const int lane = threadIdx.x & 31;
  // No early exit: every lane takes part in the shuffles.
  const bool live = t < n_threads;
  const unsigned cg = t % col_groups;
  const unsigned strip = t / col_groups;
  const int ox0 = cg * OC;
  const int oy0 = (strip % row_strips) * R;
  const int gy0 = oy0 - p0y;
  const size_t plane = live ? strip / row_strips : 0;
  const T* xp = x + plane * Hin * Win;
  const int plane_off = static_cast<int>(plane * Ho * Wo) + ox0;
  const int ncols = live ? min(OC, Wo - ox0) : 0;
  // The neighbour lane holds the adjacent column group of the same strip
  // when this thread's group is not the strip's first / last.
  const bool own_ok = live && ox0 + OC <= Win;
  const bool left_lane = lane > 0 && cg > 0;
  const bool left_mem = lane == 0 && cg > 0;
  const bool right_lane = lane < 31 && cg + 1 < col_groups;
  const bool right_mem = !right_lane && live && ox0 + OC < Win;

  VecRow<T, P0X> in[R + 3];
#pragma unroll
  for (int r = 0; r < PF; ++r) {
    load_row_vec(xp, gy0 + r, Hin, Win, ox0, own_ok, left_mem, right_mem, in[r]);
  }
  float a0[IC] = {}, a1[IC] = {}, a2[IC] = {}, v[IC];
#pragma unroll
  for (int r = 0; r < R + 3; ++r) {
    if (r + PF < R + 3) {
      load_row_vec(xp, gy0 + r + PF, Hin, Win, ox0, own_ok, left_mem, right_mem, in[r + PF]);
    }
    const unsigned* own = in[r].own;
    unsigned lw[NW / 2], rw[NW / 2];
#pragma unroll
    for (int k = 0; k < NW / 2; ++k) {
      lw[k] = __shfl_up_sync(0xffffffffu, own[NW / 2 + k], 1);
      rw[k] = __shfl_down_sync(0xffffffffu, own[k], 1);
    }
    // The input columns [ox0 - P0X, ox0 + 11 - P0X) of this row.
    float w[IC];
#pragma unroll
    for (int k = 0; k < P0X; ++k) {
      w[k] = left_lane ? CH::elem(lw, 4 - P0X + k) : in[r].left[k];
    }
#pragma unroll
    for (int e = 0; e < OC; ++e) w[P0X + e] = CH::elem(own, e);
#pragma unroll
    for (int k = 0; k < 3 - P0X; ++k) {
      w[P0X + OC + k] = right_lane ? CH::elem(rw, k) : in[r].right[k];
    }
    accumulate(w, a0, a1, a2, v, t0, t1, t2, t3);
    if (r < 3) continue;
    const int oy = oy0 + r - 3;
    float o[OC];
    row_out(v, o, t0, t1, t2, t3);
    store_row(out, o, plane_off + oy * Wo, oy < Ho ? ncols : 0, vec_store,
              s_buf[threadIdx.x / 32], lane);
  }
}

// Whole planes, for maps of at most 24 x 24 outputs: the CTA reads
// per_cta consecutive planes — one contiguous span of memory, coalesced —
// into shared memory, then each thread computes outputs in order, so the
// stores are coalesced too.
template <typename T>
__global__ void __launch_bounds__(THREADS)
blur4_planes(const T* __restrict__ x, T* __restrict__ out, int planes,
             int per_cta, int Hin, int Win, int Ho, int Wo, int p0y, int p0x,
             float t0, float t1, float t2, float t3) {
  extern __shared__ float s_in[];
  const int first = blockIdx.x * per_cta;
  const int np = min(per_cta, planes - first);
  const int hw_in = Hin * Win, hw = Ho * Wo;
  const T* xs = x + static_cast<size_t>(first) * hw_in;
  for (int i = threadIdx.x; i < np * hw_in; i += THREADS) s_in[i] = load_f(xs + i);
  __syncthreads();
  T* os = out + static_cast<size_t>(first) * hw;
  for (int o = threadIdx.x; o < np * hw; o += THREADS) {
    const int pl = o / hw;
    const int rem = o - pl * hw;
    const int oy = rem / Wo;
    const int ox = rem - oy * Wo;
    const float* sp = s_in + pl * hw_in;
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int ix = ox + j - p0x;
      float a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int iy = oy + i - p0y;
        a[i] = (ix >= 0 && ix < Win && iy >= 0 && iy < Hin) ? sp[iy * Win + ix] : 0.f;
      }
      v[j] = tap4(t0, t1, t2, t3, a[0], a[1], a[2], a[3]);
    }
    store_f(os + o, tap4(t0, t1, t2, t3, v[0], v[1], v[2], v[3]));
  }
}

struct Args {
  int blocks, n, rows, col_groups, row_strips, Hin, Win, Ho, Wo, p0y, p0x,
      vec_store;
  float t0, t1, t2, t3;
};

template <typename T, int R, int P0X>
void launch_vec(const T* x, T* out, const Args& a, cudaStream_t s) {
  blur4_strips_vec<T, R, P0X><<<a.blocks, THREADS, 0, s>>>(
      x, out, a.n, a.col_groups, a.row_strips, a.Hin, a.Win, a.Ho, a.Wo, a.p0y,
      a.vec_store, a.t0, a.t1, a.t2, a.t3);
}

template <typename T, int R>
void launch_strips(const T* x, T* out, const Args& a, bool vec_load, cudaStream_t s) {
  if (!vec_load) {
    blur4_strips<T, R><<<a.blocks, THREADS, 0, s>>>(
        x, out, a.n, a.col_groups, a.row_strips, a.Hin, a.Win, a.Ho, a.Wo,
        a.p0y, a.p0x, a.vec_store, a.t0, a.t1, a.t2, a.t3);
    return;
  }
  switch (a.p0x) {
    case 0: launch_vec<T, R, 0>(x, out, a, s); break;
    case 1: launch_vec<T, R, 1>(x, out, a, s); break;
    case 2: launch_vec<T, R, 2>(x, out, a, s); break;
    default: launch_vec<T, R, 3>(x, out, a, s); break;
  }
}

template <typename T>
int launch(const void* x, void* out, int mode, const Args& a, cudaStream_t s) {
  const T* xi = static_cast<const T*>(x);
  T* o = static_cast<T*>(out);
  if (a.p0x < 0 || a.p0x > 3 || a.p0y < 0 || a.p0y > 3 || a.blocks <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (mode == 2) {  // planes: n = planes, rows = planes per CTA
    const size_t smem = static_cast<size_t>(a.rows) * a.Hin * a.Win * sizeof(float);
    if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
    blur4_planes<T><<<a.blocks, THREADS, smem, s>>>(
        xi, o, a.n, a.rows, a.Hin, a.Win, a.Ho, a.Wo, a.p0y, a.p0x, a.t0, a.t1,
        a.t2, a.t3);
  } else if (a.rows == 8) {
    launch_strips<T, 8>(xi, o, a, mode == 1, s);
  } else if (a.rows == 16) {
    launch_strips<T, 16>(xi, o, a, mode == 1, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// V channels at one (y, x) of a channels-last map: held as the loaded words
// (Raw) until used, unpacked to floats, packed and stored.
template <typename T, int V> struct VecIO;
template <> struct VecIO<__nv_bfloat16, 8> {
  using Raw = uint4;
  static __device__ __forceinline__ Raw load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  static __device__ __forceinline__ Raw zero() { return make_uint4(0u, 0u, 0u, 0u); }
  static __device__ __forceinline__ void unpack(const Raw& r, float* f) {
    const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      f[2 * k] = __uint_as_float(w[k] << 16);
      f[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float* f) {
    *reinterpret_cast<uint4*>(p) = make_uint4(pack_bf16x2(f[0], f[1]), pack_bf16x2(f[2], f[3]),
                                              pack_bf16x2(f[4], f[5]), pack_bf16x2(f[6], f[7]));
  }
};
template <> struct VecIO<float, 4> {
  using Raw = float4;
  static __device__ __forceinline__ Raw load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ Raw zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  static __device__ __forceinline__ void unpack(const Raw& r, float* f) {
    f[0] = r.x; f[1] = r.y; f[2] = r.z; f[3] = r.w;
  }
  static __device__ __forceinline__ void store(float* p, const float* f) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  }
};
template <typename T> struct VecIO<T, 1> {
  using Raw = float;
  static __device__ __forceinline__ Raw load(const T* p) { return load_f(p); }
  static __device__ __forceinline__ Raw zero() { return 0.f; }
  static __device__ __forceinline__ void unpack(const Raw& r, float* f) { f[0] = r; }
  static __device__ __forceinline__ void store(T* p, const float* f) { store_f(p, f[0]); }
};

// Threads are laid out channel group within its block fastest (cb groups
// of V channels), then output row, then channel block, then column strip,
// then image (ops/blur_cuda.py::blur4_nhwc_thread_tiles mirrors it).
template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
blur4_nhwc(const T* __restrict__ x, T* __restrict__ out, unsigned n_threads,
           int cb, int cblocks, int col_strips, int cols, int Hin, int Win,
           int Ho, int Wo, int C, int p0y, int p0x, float t0, float t1,
           float t2, float t3) {
  using IO = VecIO<T, V>;
  const unsigned t = blockIdx.x * THREADS + threadIdx.x;
  if (t >= n_threads) return;  // no warp-wide operations below
  unsigned r = t / cb;
  const int lane_cg = t % cb;
  const int oy = r % Ho;
  r /= Ho;
  const int blk = r % cblocks;
  r /= cblocks;
  const int ox0 = (r % col_strips) * cols;
  const size_t n = r / col_strips;
  const int c0 = (blk * cb + lane_cg) * V;
  const int nin = min(cols, Wo - ox0) + 3;  // input columns of the strip
  const int gx0 = ox0 - p0x;
  const size_t row = static_cast<size_t>(Win) * C;
  const T* img = x + n * Hin * row + c0;
  const T* rows[4];
  bool rv[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gy = oy - p0y + i;
    rv[i] = gy >= 0 && gy < Hin;
    rows[i] = img + (rv[i] ? gy : 0) * row;
  }
  T* o = out + (n * Ho + oy) * static_cast<size_t>(Wo) * C + static_cast<size_t>(ox0) * C + c0;

  typename IO::Raw cur[4], nxt[4];
  auto load_col = [&](int k, typename IO::Raw* dst) {
    const int gx = gx0 + k;
    const bool cv = gx >= 0 && gx < Win;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      dst[i] = (rv[i] && cv) ? IO::load(rows[i] + static_cast<ptrdiff_t>(gx) * C) : IO::zero();
    }
  };
  load_col(0, cur);
  float b0[V], b1[V], b2[V];
#pragma unroll
  for (int e = 0; e < V; ++e) b0[e] = b1[e] = b2[e] = 0.f;
  for (int k = 0; k < nin; ++k) {
    if (k + 1 < nin) load_col(k + 1, nxt);
    float a[4][V], v[V];
#pragma unroll
    for (int i = 0; i < 4; ++i) IO::unpack(cur[i], a[i]);
#pragma unroll
    for (int e = 0; e < V; ++e) v[e] = tap4(t0, t1, t2, t3, a[0][e], a[1][e], a[2][e], a[3][e]);
    // Column k completes output column ox0 + k - 3 (b2 holds its first
    // three terms), then moves the partial sums along, as accumulate()
    // moves them down a strip.
    if (k >= 3) {
      float res[V];
#pragma unroll
      for (int e = 0; e < V; ++e) res[e] = __fadd_rn(b2[e], __fmul_rn(t3, v[e]));
      IO::store(o + static_cast<size_t>(k - 3) * C, res);
    }
#pragma unroll
    for (int e = 0; e < V; ++e) {
      b2[e] = __fadd_rn(b1[e], __fmul_rn(t2, v[e]));
      b1[e] = __fadd_rn(b0[e], __fmul_rn(t1, v[e]));
      b0[e] = __fmul_rn(t0, v[e]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) cur[i] = nxt[i];
  }
}

template <typename T, int V>
int launch_nhwc(const void* x, void* out, int blocks, unsigned n, int cb,
                int cblocks, int col_strips, int cols, int Hin, int Win, int Ho,
                int Wo, int C, int p0y, int p0x, float t0, float t1, float t2,
                float t3, cudaStream_t s) {
  blur4_nhwc<T, V><<<blocks, THREADS, 0, s>>>(
      static_cast<const T*>(x), static_cast<T*>(out), n, cb, cblocks,
      col_strips, cols, Hin, Win, Ho, Wo, C, p0y, p0x, t0, t1, t2, t3);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// mode 0: strips with scalar loads; 1: strips with 16-byte loads (rows
// 16-byte aligned); 2: whole planes.  blocks, n (threads for strips, planes
// for planes), rows (strip rows, or planes per CTA), col_groups and
// row_strips come from ops/blur_cuda.py::blur4_launch_geometry.  is_bf16:
// 1 for bfloat16 tensors, 0 for float32.  vec_store: 1 when every output
// row starts on a 16-byte boundary.
extern "C" int gif_blur4_forward(const void* x, void* out, int mode, int blocks,
                                 int n, int rows, int col_groups,
                                 int row_strips, int Hin, int Win, int Ho,
                                 int Wo, int p0y, int p0x, int is_bf16,
                                 int vec_store, float t0, float t1, float t2,
                                 float t3, void* stream) {
  const Args a{blocks, n, rows, col_groups, row_strips, Hin, Win, Ho, Wo,
               p0y, p0x, vec_store, t0, t1, t2, t3};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(x, out, mode, a, s)
                 : launch<float>(x, out, mode, a, s);
}

// Channels-last maps.  blocks, n (threads), cb (channel groups a block),
// cblocks, col_strips and cols (output columns a thread) come from
// ops/blur_cuda.py::blur4_nhwc_geometry; vec: channels a thread, 8 (bf16)
// or 4 (f32) for 16-byte access (C a multiple of it, 16-byte aligned
// bases), else 1.
extern "C" int gif_blur4_forward_nhwc(const void* x, void* out, int blocks,
                                      int n, int cb, int cblocks,
                                      int col_strips, int cols, int Hin,
                                      int Win, int Ho, int Wo, int C, int p0y,
                                      int p0x, int is_bf16, int vec, float t0,
                                      float t1, float t2, float t3,
                                      void* stream) {
  if (p0x < 0 || p0x > 3 || p0y < 0 || p0y > 3 || blocks <= 0 || n <= 0 ||
      cb <= 0 || cblocks <= 0 || col_strips <= 0 || cols <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned nt = static_cast<unsigned>(n);
  if (is_bf16 && vec == 8) {
    return launch_nhwc<__nv_bfloat16, 8>(x, out, blocks, nt, cb, cblocks, col_strips, cols, Hin, Win,
                                         Ho, Wo, C, p0y, p0x, t0, t1, t2, t3, s);
  }
  if (!is_bf16 && vec == 4) {
    return launch_nhwc<float, 4>(x, out, blocks, nt, cb, cblocks, col_strips, cols, Hin, Win, Ho, Wo,
                                 C, p0y, p0x, t0, t1, t2, t3, s);
  }
  if (vec != 1) return static_cast<int>(cudaErrorInvalidValue);
  return is_bf16 ? launch_nhwc<__nv_bfloat16, 1>(x, out, blocks, nt, cb, cblocks, col_strips, cols, Hin,
                                                 Win, Ho, Wo, C, p0y, p0x, t0, t1, t2, t3, s)
                 : launch_nhwc<float, 1>(x, out, blocks, nt, cb, cblocks, col_strips, cols, Hin, Win,
                                         Ho, Wo, C, p0y, p0x, t0, t1, t2, t3, s);
}
