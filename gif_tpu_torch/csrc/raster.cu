// Tile rasterizer with fused attribute interpolation (forward).
//
// Replaces the TPU kernel gif_tpu/render/raster_pallas.py::_raster_group_kernel
// (called through _raster_core / rasterize_pallas_with_attrs).  The binning
// (per-tile candidate face lists, ascending face id, capped at K with a
// per-tile overflow flag) and the per-face barycentric setup table are built
// on the torch side (gif_tpu_torch/render/raster.py); this kernel does the
// per-pixel work.
//
// One CTA per (tile, batch), one thread per pixel of the tile.  The tile's
// candidates are staged through shared memory in chunks of RCH faces, every
// thread tests every staged candidate against its pixel, and the running
// winner (max depth denominator zdenom = w0/z0 + v/z1 + u/z2, the lowest
// face id on exact ties because candidates arrive in ascending id order and
// only a strictly larger zdenom replaces the winner) stays in registers.
// The winner's depth, id, barycentrics [w0, v, u] and its D interpolated
// corner attributes are written once per pixel.
//
// What bounds it on the H100: float32 ALU work, (binned candidates) x
// (pixels per tile) x ~26 flops; the bytes moved (face table, attributes,
// ~40 B of output per pixel) are small next to it.  The design keeps every
// candidate read in shared memory (one global read per staged face per CTA,
// not per pixel) and the winner in registers; the TPU kernel's bf16 hi/lo
// split of its matrix-unit formulation is gone — Hopper evaluates the
// reference's dot-product barycentrics directly in f32.
//
// Arithmetic uses the explicitly rounded intrinsics (__fmul_rn, __fadd_rn,
// ...), which the compiler never contracts into FMAs, in the same order as
// the plain PyTorch version, so the kernel and the plain version agree bit
// for bit.
//
// Semantics (gif_tpu/render/raster.py): pixel centres at integer coords;
// inside test w0 > 0 && v >= 0 && u >= 0; a degenerate face (det == 0) gets
// w0 = -1 and never hits; empty pixels get depth 1e6, id -1, zeros.

#include <cuda_runtime.h>

namespace {

constexpr int NCOEF = 16;  // per-face table width, see raster.py::face_table
constexpr int RCH = 128;   // candidates staged per chunk
constexpr float BIG_DEPTH = 1e6f;

__global__ void __launch_bounds__(1024)
raster_kernel(const float* __restrict__ face_tab,  // (B, F, NCOEF)
              const float* __restrict__ attrs,     // (B, F, 3, D)
              const int* __restrict__ cand,        // (B, T, K) face ids
              const int* __restrict__ counts,      // (B, T)
              float* __restrict__ depth,           // (B, H, W)
              int* __restrict__ tri,               // (B, H, W)
              float* __restrict__ bary,            // (B, H, W, 3)
              float* __restrict__ attr_out,        // (B, H, W, D)
              int F, int K, int H, int W, int tile, int n_tx, int D) {
  __shared__ float s_tab[RCH * NCOEF];
  __shared__ int s_id[RCH];

  const int t = blockIdx.x;
  const int b = blockIdx.y;
  const int T = gridDim.x;
  const int lx = threadIdx.x % tile;
  const int ly = threadIdx.x / tile;
  const int px = (t % n_tx) * tile + lx;
  const int py = (t / n_tx) * tile + ly;
  const float fx = (float)px;
  const float fy = (float)py;

  const int count = counts[b * T + t];
  const int* ids = cand + ((size_t)b * T + t) * K;
  const float* tab_b = face_tab + (size_t)b * F * NCOEF;

  float best_zd = 0.f, bw0 = 0.f, bv = 0.f, bu = 0.f;
  int best = -1;

  for (int base = 0; base < count; base += RCH) {
    const int n = min(RCH, count - base);
    __syncthreads();  // previous chunk fully consumed
    for (int i = threadIdx.x; i < n * NCOEF; i += blockDim.x) {
      const int c = i / NCOEF;
      s_tab[i] = tab_b[(size_t)ids[base + c] * NCOEF + (i - c * NCOEF)];
    }
    for (int i = threadIdx.x; i < n; i += blockDim.x) s_id[i] = ids[base + i];
    __syncthreads();

    for (int c = 0; c < n; ++c) {
      const float* q = s_tab + c * NCOEF;
      // q: p0x p0y v0x v0y v1x v1y dot00 dot01 dot11 inv degen rz0 rz1 rz2
      const float v2x = __fsub_rn(fx, q[0]);
      const float v2y = __fsub_rn(fy, q[1]);
      const float dot02 = __fadd_rn(__fmul_rn(q[2], v2x), __fmul_rn(q[3], v2y));
      const float dot12 = __fadd_rn(__fmul_rn(q[4], v2x), __fmul_rn(q[5], v2y));
      const float u = __fmul_rn(
          __fsub_rn(__fmul_rn(q[8], dot02), __fmul_rn(q[7], dot12)), q[9]);
      const float v = __fmul_rn(
          __fsub_rn(__fmul_rn(q[6], dot12), __fmul_rn(q[7], dot02)), q[9]);
      const float w0 = q[10] != 0.f ? -1.f : __fsub_rn(__fsub_rn(1.f, u), v);
      if (w0 > 0.f && v >= 0.f && u >= 0.f) {
        const float zd = __fadd_rn(
            __fadd_rn(__fmul_rn(w0, q[11]), __fmul_rn(v, q[12])),
            __fmul_rn(u, q[13]));
        if (best < 0 || zd > best_zd) {
          best_zd = zd;
          best = s_id[c];
          bw0 = w0;
          bv = v;
          bu = u;
        }
      }
    }
  }

  if (px >= W || py >= H) return;
  const size_t pix = ((size_t)b * H + py) * W + px;
  const bool hit = best >= 0;
  depth[pix] = hit ? __fdiv_rn(1.f, best_zd) : BIG_DEPTH;
  tri[pix] = best;
  bary[pix * 3 + 0] = hit ? bw0 : 0.f;
  bary[pix * 3 + 1] = hit ? bv : 0.f;
  bary[pix * 3 + 2] = hit ? bu : 0.f;
  if (hit) {
    const float* a = attrs + ((size_t)b * F + best) * 3 * D;
    for (int d = 0; d < D; ++d) {
      attr_out[pix * D + d] = __fadd_rn(
          __fadd_rn(__fmul_rn(bw0, a[d]), __fmul_rn(bv, a[D + d])),
          __fmul_rn(bu, a[2 * D + d]));
    }
  } else {
    for (int d = 0; d < D; ++d) attr_out[pix * D + d] = 0.f;
  }
}

}  // namespace

extern "C" int gif_raster_forward(const void* face_tab, const void* attrs,
                                  const void* cand, const void* counts,
                                  void* depth, void* tri, void* bary,
                                  void* attr_out, int B, int F, int K, int H,
                                  int W, int tile, int D, void* stream) {
  const int n_tx = W / tile;
  const int n_ty = H / tile;
  dim3 grid(n_tx * n_ty, B);
  raster_kernel<<<grid, tile * tile, 0, (cudaStream_t)stream>>>(
      (const float*)face_tab, (const float*)attrs, (const int*)cand,
      (const int*)counts, (float*)depth, (int*)tri, (float*)bary,
      (float*)attr_out, F, K, H, W, tile, n_tx, D);
  return (int)cudaGetLastError();
}
