// Rasterizer with fused attribute interpolation (forward), binning included.
//
// Replaces the TPU kernel gif_tpu/render/raster_pallas.py::_raster_group_kernel
// (called through _raster_core / rasterize_pallas_with_attrs) together with
// the binning around it.  The whole call runs on the stream with every size
// static, so it never waits on the host and the host never waits on it.
//
// Contract (gif_tpu_torch/render/raster.py::rasterize_plain, bit for bit):
// face f is a candidate of tile t when it is front-facing, its clamped
// integer bbox is non-empty and overlaps t, and its rank among such faces of
// t (ascending face id) is below K = min(cap, F); overflow[b, t] = count > K.
// Each pixel keeps, among its tile's candidates, the inside hit with the
// largest zd = w0 * rz0 + v * rz1 + u * rz2, the lowest face id on exact
// ties.  Degenerate faces (det == 0) count toward ranks but never hit.
//
// Six steps, one launch each (``passes`` selects them, for timing):
//   0. clear the (B, H, W) u64 key buffer and the large-walk list;
//   a. bin: one warp per (batch, 32 consecutive faces); for every tile the
//      warp's overlap flags become one bitset word by __ballot_sync, so the
//      (B, T, ceil(F / 32)) membership bitset is written once, no atomics;
//   b. ranks: one warp per (batch, tile) row, an exclusive prefix popcount
//      over its words: counts, overflow flags, and per word the number of
//      candidates before it (a face's rank is that plus a popcount).
//      With K = F no tile can overflow: (a) is skipped and (b) only clears
//      the overflow flags;
//   c. coverage, face-parallel: a group of 4 lanes per face walks the
//      pixels of its candidate tiles where it can hit (below), runs the
//      inside test, and on a hit does a 64-bit atomicMax of
//      key = bits(zd) << 32 | (0xFFFFFFFF - f).  zd > 0 on every hit
//      (z >= 1), so the float's bits order as unsigned integers and the max
//      key is the largest zd with the lowest face id among ties.  A walk of
//      more than 64 pixels in a tile goes to a list instead, in chunks of
//      8 rows;
//   c'. the listed walks, one warp per chunk;
//   d. resolve, one thread per pixel: decode the face id, recompute its
//      barycentrics (bit-equal to the values that won: same operations),
//      write depth 1 / zd, tri_id, bary and the D interpolated attributes;
//      an empty key is background (depth 1e6, id -1, zeros).
// Why face-parallel and not one CTA per tile testing every candidate
// against every pixel: a FLAME face covers a few pixels, so ~99% of those
// tests miss, and in serving a few tiles hold thousands of faces while the
// rest are empty; faces spread evenly over the card.
//
// Where a face can hit.  rasterize_plain tests every pixel of each candidate
// tile.  For a pixel outside the face's bbox widened by m pixels (more than
// m pixels from the triangle) to pass the inside test, the rounding of the
// barycentrics must move them by about m / (the face's size) — possible only
// for slivers, whose rounding error is amplified by 1 / det.  The coverage
// pass bounds that distance per face (``reach``: a forward error bound of the
// operations below, each term 3-5x generous) and walks the bbox widened by
// m = max(1, ceil(2 reach)) pixels within its candidate tiles; a face whose
// setup is too ill-conditioned for the bound (det <= 0, or the rounding of
// det itself not small) walks its candidate tiles whole.
//
// What bounds it on the H100: memory.  Per call it reads the faces and
// attributes, writes the bitset, clears and reads the 8-byte key per pixel
// and writes ~40 B of outputs per pixel; the face-pixel tests (each face's
// bbox, ~27 f32 operations each) are far below the f32 rate.  The passes
// are short, so launch gaps between the five steps are a visible share.
//
// Arithmetic that decides results uses the explicitly rounded intrinsics
// (__fmul_rn, __fadd_rn, ...), which the compiler never contracts into FMAs,
// in the order of face_table / _tile_winners / interpolate_face_attributes.

#include <cuda_runtime.h>

namespace {

constexpr float BIG_DEPTH = 1e6f;
constexpr int GROUP = 4;         // lanes per face in the coverage step
constexpr int WIDE_WALK = 64;    // pixels a group walks in one tile at most
constexpr int WIDE_ROWS = 8;     // rows of one listed large walk
constexpr int THREADS = 256;
constexpr int MAX_STAGED_D = 8;  // attributes per pixel the resolve step stages
constexpr int WIDE_BLOCKS = 264; // CTAs of the large-walk step (2 per H100 SM)

// The lanes of thread gid's coverage group.
__device__ __forceinline__ unsigned group_mask(int gid) {
  return ((1u << GROUP) - 1u) << (gid % 32 / GROUP * GROUP);
}

struct Face {
  float p0x, p0y, v0x, v0y, v1x, v1y, d00, d01, d11, inv, rz0, rz1, rz2;
  bool degenerate;
};

__device__ __forceinline__ void load_corners(const float* __restrict__ fv, long long face, float c[9]) {
  const float* p = fv + face * 9;
#pragma unroll
  for (int i = 0; i < 9; ++i) c[i] = __ldg(p + i);
}

// raster.py::bin_faces: front-facing and a non-empty clamped integer bbox.
__device__ __forceinline__ bool face_bbox(const float c[9], int H, int W, int& x0, int& x1, int& y0, int& y1) {
  const float xmin = fmaxf(ceilf(fminf(fminf(c[0], c[3]), c[6])), 0.f);
  const float xmax = fminf(floorf(fmaxf(fmaxf(c[0], c[3]), c[6])), (float)(W - 1));
  const float ymin = fmaxf(ceilf(fminf(fminf(c[1], c[4]), c[7])), 0.f);
  const float ymax = fminf(floorf(fmaxf(fmaxf(c[1], c[4]), c[7])), (float)(H - 1));
  // _front_facing: (p2y - p0y) * (p1x - p0x) < (p1y - p0y) * (p2x - p0x)
  const bool front = __fmul_rn(__fsub_rn(c[7], c[1]), __fsub_rn(c[3], c[0])) <
                     __fmul_rn(__fsub_rn(c[4], c[1]), __fsub_rn(c[6], c[0]));
  if (!(front && xmin <= xmax && ymin <= ymax)) return false;
  x0 = (int)xmin;
  x1 = (int)xmax;
  y0 = (int)ymin;
  y1 = (int)ymax;
  return true;
}

// raster.py::face_table, column for column.
__device__ __forceinline__ Face face_setup(const float c[9]) {
  Face s;
  s.p0x = c[0];
  s.p0y = c[1];
  s.v0x = __fsub_rn(c[6], c[0]);
  s.v0y = __fsub_rn(c[7], c[1]);
  s.v1x = __fsub_rn(c[3], c[0]);
  s.v1y = __fsub_rn(c[4], c[1]);
  s.d00 = __fadd_rn(__fmul_rn(s.v0x, s.v0x), __fmul_rn(s.v0y, s.v0y));
  s.d01 = __fadd_rn(__fmul_rn(s.v0x, s.v1x), __fmul_rn(s.v0y, s.v1y));
  s.d11 = __fadd_rn(__fmul_rn(s.v1x, s.v1x), __fmul_rn(s.v1y, s.v1y));
  const float det = __fsub_rn(__fmul_rn(s.d00, s.d11), __fmul_rn(s.d01, s.d01));
  s.degenerate = det == 0.f;
  s.inv = s.degenerate ? 0.f : __fdiv_rn(1.f, det);
  return s;
}

// face_table's rz columns (only the inside test's depth needs them).
__device__ __forceinline__ void face_depths(const float c[9], Face& s) {
  s.rz0 = __fdiv_rn(1.f, c[2]);
  s.rz1 = __fdiv_rn(1.f, c[5]);
  s.rz2 = __fdiv_rn(1.f, c[8]);
}

// raster.py::_tile_winners' per-pixel arithmetic: w0 / v / u as the plain
// version computes them.
__device__ __forceinline__ void face_bary(const Face& s, float fx, float fy, float& w0, float& v, float& u) {
  const float v2x = __fsub_rn(fx, s.p0x);
  const float v2y = __fsub_rn(fy, s.p0y);
  const float dot02 = __fadd_rn(__fmul_rn(s.v0x, v2x), __fmul_rn(s.v0y, v2y));
  const float dot12 = __fadd_rn(__fmul_rn(s.v1x, v2x), __fmul_rn(s.v1y, v2y));
  u = __fmul_rn(__fsub_rn(__fmul_rn(s.d11, dot02), __fmul_rn(s.d01, dot12)), s.inv);
  v = __fmul_rn(__fsub_rn(__fmul_rn(s.d00, dot12), __fmul_rn(s.d01, dot02)), s.inv);
  w0 = s.degenerate ? -1.f : __fsub_rn(__fsub_rn(1.f, u), v);
}

// The inside test; on a hit, the key of (zd, f) for atomicMax.
__device__ __forceinline__ bool face_hit(const Face& s, float fx, float fy, unsigned long long low,
                                         unsigned long long& key) {
  float w0, v, u;
  face_bary(s, fx, fy, w0, v, u);
  if (!(w0 > 0.f && v >= 0.f && u >= 0.f)) return false;
  const float zd = __fadd_rn(__fadd_rn(__fmul_rn(w0, s.rz0), __fmul_rn(v, s.rz1)), __fmul_rn(u, s.rz2));
  key = ((unsigned long long)__float_as_uint(zd) << 32) | low;
  return true;
}

// Walk the rw x rh pixels from (xa, ya) with ``lanes`` lanes, lane first,
// row by row, keeping the highest key of every pixel the face hits.
__device__ __forceinline__ void walk(const Face& s, unsigned long long low, unsigned long long* kb, int W, int xa,
                                     int ya, int rw, int rh, int lane, int lanes) {
  int x = lane, y = 0;
  while (x >= rw && y < rh) {
    x -= rw;
    ++y;
  }
  while (y < rh) {
    unsigned long long key;
    if (face_hit(s, (float)(xa + x), (float)(ya + y), low, key)) atomicMax(kb + (ya + y) * W + xa + x, key);
    x += lanes;
    while (x >= rw && y < rh) {
      x -= rw;
      ++y;
    }
  }
}

// How many pixels around its bbox a face's walk must reach: ``reach``
// bounds (in pixels) how far outside the triangle a pixel of its tiles can
// pass the inside test.  r bounds |pixel - p0| over the tiles; e bounds the
// rounding error of u, v and w0 there (about 10 roundings of terms up to
// |v0| |v1|^2 r / det), so the exact barycentrics of an inside pixel lie in
// the simplex grown by e; shape bounds how far the stored setup (rounded
// Gram entries and 1 / det, the rounding of p2 - p0 and p1 - p0) moves the
// triangle those exact barycentrics describe, relative to its size.  Each
// term is 3-5x generous and the margin is twice the reach; ``tile`` (whole
// tiles) where the bound does not hold.
__device__ __forceinline__ int face_margin(const Face& s, int tx0, int tx1, int ty0, int ty1, int tile) {
  // (The bound has slack enough for the approximate rsqrt.)
  const float ai = fabsf(s.inv);
  const float n0 = s.d00 * rsqrtf(s.d00), n1 = s.d11 * rsqrtf(s.d11);
  const float r = fmaxf(fabsf((float)(tx0 * tile) - s.p0x), fabsf((float)(tx1 * tile + tile - 1) - s.p0x)) +
                  fmaxf(fabsf((float)(ty0 * tile) - s.p0y), fabsf((float)(ty1 * tile + tile - 1) - s.p0y));
  const float e = 0x1p-19f * r * (n0 * s.d11 + n1 * s.d00) * ai + 0x1p-20f;
  const float shape = 0x1p-20f * (1.f + s.d00 * s.d11 * ai + (s.d00 + s.d11) * ai * rsqrtf(ai));
  const float reach = (2.f * e + shape * (1.f + 2.f * e)) * (n0 + n1);
  const bool bounded = __fsub_rn(__fmul_rn(s.d00, s.d11), __fmul_rn(s.d01, s.d01)) > 0.f && shape < 0.0625f &&
                       2.f * reach < (float)tile;
  return bounded ? max(1, (int)ceilf(2.f * reach)) : tile;
}

// (a) One warp per (b, word of 32 faces): bits[b, t, word] for every tile.
// Tiles go 32 at a time: lane j keeps the ballot of tile base + j and
// stores it, so a warp issues ceil(T / 32) stores; tiles outside the
// rectangle of tiles its faces touch take no ballot (their word is 0).
__global__ void __launch_bounds__(THREADS)
raster_bin(const float* __restrict__ fv, unsigned* __restrict__ bits, int B, int F, int H, int W, int tile,
           int n_tx, int T, int n_words) {
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (warp >= B * n_words) return;  // uniform over the warp
  const int b = warp / n_words;
  const int word = warp - b * n_words;
  const int f = word * 32 + lane;
  int x0 = 0, x1 = -1, y0 = 0, y1 = -1;
  if (f < F) {
    float c[9];
    load_corners(fv, (long long)b * F + f, c);
    if (!face_bbox(c, H, W, x0, x1, y0, y1)) x1 = -1;
  }
  const bool alive = x1 >= 0;
  const int tx0 = alive ? x0 / tile : 1 << 30, tx1 = alive ? x1 / tile : -1;
  const int ty0 = alive ? y0 / tile : 1 << 30, ty1 = alive ? y1 / tile : -1;
  const int wx0 = __reduce_min_sync(0xffffffffu, tx0), wx1 = __reduce_max_sync(0xffffffffu, tx1);
  const int wy0 = __reduce_min_sync(0xffffffffu, ty0), wy1 = __reduce_max_sync(0xffffffffu, ty1);
  unsigned* out = bits + (long long)b * T * n_words + word;
  int ty = 0, tx = 0;
  for (int base = 0; base < T; base += 32) {
    unsigned mine = 0;
    for (int j = 0; j < 32 && base + j < T; ++j) {
      if (ty >= wy0 && ty <= wy1 && tx >= wx0 && tx <= wx1) {  // uniform over the warp
        const unsigned m = __ballot_sync(0xffffffffu, tx >= tx0 && tx <= tx1 && ty >= ty0 && ty <= ty1);
        if (lane == j) mine = m;
      }
      if (++tx == n_tx) {
        tx = 0;
        ++ty;
      }
    }
    if (base + lane < T) out[(long long)(base + lane) * n_words] = mine;
  }
}

// (b) One warp per (b, t) row: exclusive prefix popcount of its words.
__global__ void __launch_bounds__(THREADS)
raster_ranks(const unsigned* __restrict__ bits, int* __restrict__ prefix, int* __restrict__ counts,
             unsigned char* __restrict__ overflow, int rows, int n_words, int K) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const unsigned* r = bits + (long long)row * n_words;
  int* p = prefix + (long long)row * n_words;
  int carry = 0;
  for (int base = 0; base < n_words; base += 32) {
    const int i = base + lane;
    const int c = i < n_words ? __popc(r[i]) : 0;
    int incl = c;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += y;
    }
    if (i < n_words) p[i] = carry + incl - c;
    carry += __shfl_sync(0xffffffffu, incl, 31);
  }
  if (lane == 0) {
    counts[row] = carry;
    overflow[row] = carry > K;
  }
}

// (c) GROUP lanes per face: the inside test over the pixels where the face
// can hit, in the tiles where it is a candidate; 64-bit atomicMax per hit.
// A walk of more than WIDE_WALK pixels in one tile is listed for step (c'),
// in chunks of WIDE_ROWS rows, as long as the list has room: no group walks
// for long.  With K = F no tile can overflow, and no rank is looked up.
__global__ void __launch_bounds__(THREADS)
raster_cover(const float* __restrict__ fv, const unsigned* __restrict__ bits, const int* __restrict__ prefix,
             const int* __restrict__ counts, unsigned long long* __restrict__ keys, int* __restrict__ wide,
             int wide_cap, int B, int F, int K, int H, int W, int tile, int n_tx, int T, int n_words) {
  const int gid = blockIdx.x * blockDim.x + threadIdx.x;
  const int face = gid / GROUP;
  const int lane = gid % GROUP;
  if (face >= B * F) return;
  const int b = face / F;
  const int f = face - b * F;
  float c[9];
  load_corners(fv, face, c);
  int x0, x1, y0, y1;
  if (!face_bbox(c, H, W, x0, x1, y0, y1)) return;
  Face s = face_setup(c);
  if (s.degenerate) return;
  face_depths(c, s);
  const int tx0 = x0 / tile, tx1 = x1 / tile, ty0 = y0 / tile, ty1 = y1 / tile;
  const int m = face_margin(s, tx0, tx1, ty0, ty1, tile);

  const unsigned long long low = 0xFFFFFFFFull - (unsigned)f;
  const int word = f >> 5;
  const unsigned below = (1u << (f & 31)) - 1u;
  unsigned long long* kb = keys + b * H * W;
  for (int ty = ty0; ty <= ty1; ++ty) {
    for (int tx = tx0; tx <= tx1; ++tx) {
      const int row = b * T + ty * n_tx + tx;
      if (K < F && counts[row] > K) {
        const int at = row * n_words + word;
        if (prefix[at] + __popc(bits[at] & below) >= K) continue;
      }
      const int xa = max(tx * tile, x0 - m), xb = min(tx * tile + tile - 1, x1 + m);
      const int ya = max(ty * tile, y0 - m), yb = min(ty * tile + tile - 1, y1 + m);
      const int rw = xb - xa + 1, rh = yb - ya + 1;
      if (rw * rh > WIDE_WALK) {
        const int n_chunks = (rh + WIDE_ROWS - 1) / WIDE_ROWS;
        int slot = 0;
        if (lane == 0) slot = atomicAdd(wide, n_chunks);
        slot = __shfl_sync(group_mask(gid), slot, 0, GROUP);
        const bool listed = slot + n_chunks <= wide_cap;
        int2* items = reinterpret_cast<int2*>(wide + 2);
        for (int k = lane; k < n_chunks && slot + k < wide_cap; k += GROUP) {
          items[slot + k] = listed ? make_int2(face, (row - b * T) * 64 + k) : make_int2(-1, 0);
        }
        if (listed) continue;
      }
      walk(s, low, kb, W, xa, ya, rw, rh, lane, GROUP);
    }
  }
}

// (c') One warp per listed (face, tile, chunk of WIDE_ROWS rows): the walk
// of step (c) over 32 lanes.  Items of face -1 are empty.
__global__ void __launch_bounds__(THREADS)
raster_cover_wide(const float* __restrict__ fv, const int* __restrict__ wide, int wide_cap,
                  unsigned long long* __restrict__ keys, int F, int H, int W, int tile, int n_tx) {
  const int lane = threadIdx.x % 32;
  const int n_items = min(*wide, wide_cap);
  const int n_warps = gridDim.x * blockDim.x / 32;
  for (int it = (blockIdx.x * blockDim.x + threadIdx.x) / 32; it < n_items; it += n_warps) {
    const int2 item = reinterpret_cast<const int2*>(wide + 2)[it];
    const int face = item.x, t = item.y / 64, chunk = item.y % 64;
    if (face < 0) continue;
    const int b = face / F;
    const int f = face - b * F;
    float c[9];
    load_corners(fv, face, c);
    int x0, x1, y0, y1;
    face_bbox(c, H, W, x0, x1, y0, y1);  // listed: alive and not degenerate
    Face s = face_setup(c);
    face_depths(c, s);
    const int m = face_margin(s, x0 / tile, x1 / tile, y0 / tile, y1 / tile, tile);
    const int ty = t / n_tx, tx = t - ty * n_tx;
    const int xa = max(tx * tile, x0 - m), xb = min(tx * tile + tile - 1, x1 + m);
    const int ya = max(ty * tile, y0 - m) + chunk * WIDE_ROWS;
    const int yb = min(min(ty * tile + tile - 1, y1 + m), ya + WIDE_ROWS - 1);
    walk(s, 0xFFFFFFFFull - (unsigned)f, keys + b * H * W, W, xa, ya, xb - xa + 1, yb - ya + 1, lane, 32);
  }
}

// (d) One thread per pixel: decode the winner, write the outputs.  bary
// and the attributes are staged in shared memory and leave the CTA as one
// contiguous span each.
__global__ void __launch_bounds__(THREADS)
raster_resolve(const float* __restrict__ fv, const float* __restrict__ attrs,
               const unsigned long long* __restrict__ keys, float* __restrict__ depth, int* __restrict__ tri,
               float* __restrict__ bary, float* __restrict__ attr_out, int B, int F, int H, int W, int D) {
  __shared__ float s_bary[THREADS * 3];
  __shared__ float s_attr[THREADS * MAX_STAGED_D];
  const int total = B * H * W;
  const int pix0 = blockIdx.x * THREADS;
  const int pix = pix0 + threadIdx.x;
  const int n_pix = min(THREADS, total - pix0);
  const bool staged = D <= MAX_STAGED_D;
  float w0 = 0.f, v = 0.f, u = 0.f;
  int f = -1;
  const float* a = attrs;
  if (pix < total) {
    const unsigned long long key = keys[pix];
    if (key != 0ull) {
      f = (int)(0xFFFFFFFFu - (unsigned)(key & 0xFFFFFFFFull));
      const int b = pix / (H * W);
      const int row = pix / W;
      float c[9];
      load_corners(fv, (long long)b * F + f, c);
      face_bary(face_setup(c), (float)(pix - row * W), (float)(row - b * H), w0, v, u);
      depth[pix] = __fdiv_rn(1.f, __uint_as_float((unsigned)(key >> 32)));
      a = attrs + ((long long)b * F + f) * 3 * D;
    } else {
      depth[pix] = BIG_DEPTH;
    }
    tri[pix] = f;
    for (int d = 0; d < D; ++d) {
      const float val = f < 0 ? 0.f
                              : __fadd_rn(__fadd_rn(__fmul_rn(w0, __ldg(a + d)), __fmul_rn(v, __ldg(a + D + d))),
                                          __fmul_rn(u, __ldg(a + 2 * D + d)));
      if (staged) {
        s_attr[threadIdx.x * D + d] = val;
      } else {
        attr_out[(long long)pix * D + d] = val;
      }
    }
    s_bary[threadIdx.x * 3 + 0] = w0;
    s_bary[threadIdx.x * 3 + 1] = v;
    s_bary[threadIdx.x * 3 + 2] = u;
  }
  __syncthreads();
  float* ob = bary + (long long)pix0 * 3;
  for (int i = threadIdx.x; i < n_pix * 3; i += THREADS) ob[i] = s_bary[i];
  if (staged) {
    float* oa = attr_out + (long long)pix0 * D;
    for (int i = threadIdx.x; i < n_pix * D; i += THREADS) oa[i] = s_attr[i];
  }
}

unsigned blocks_for(long long threads) { return (unsigned)((threads + THREADS - 1) / THREADS); }

}  // namespace

// Index arithmetic is 32-bit: the wrapper keeps B*H*W, GROUP*B*F and
// 32*B*T below 2^31 and B*T*ceil(F/32) below 2^31.
// passes: bit 0 clear keys and the large-walk list, 1 bin, 2 ranks, 3
// coverage, 4 large walks, 5 resolve (63: all).  With K = F the bin and
// rank steps reduce to clearing the overflow flags.  Scratch (the wrapper allocates it): keys (B, H, W)
// u64, bits and prefix (B, T, ceil(F / 32)) u32 / i32, counts (B, T) i32,
// wide: a count, a pad word and wide_cap (face, tile) int pairs.
extern "C" int gif_raster_forward(const void* fv, const void* attrs, void* keys, void* bits, void* prefix,
                                  void* counts, void* wide, void* depth, void* tri, void* bary, void* attr_out,
                                  void* overflow, int B, int F, int K, int H, int W, int tile, int D,
                                  int wide_cap, int passes, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int n_tx = W / tile;
  const int T = n_tx * (H / tile);
  const int n_words = (F + 31) / 32;
  cudaError_t err = cudaSuccess;
  const bool binned = K < F;  // else no tile can overflow: no bitset, no ranks
  if (passes & 1) {
    err = cudaMemsetAsync(keys, 0, sizeof(unsigned long long) * (size_t)B * H * W, st);
    if (err == cudaSuccess) err = cudaMemsetAsync(wide, 0, sizeof(int), st);
    if (err != cudaSuccess) return (int)err;
  }
  if ((passes & 2) && binned) {
    raster_bin<<<blocks_for(32LL * B * n_words), THREADS, 0, st>>>((const float*)fv, (unsigned*)bits, B, F, H, W,
                                                                    tile, n_tx, T, n_words);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  if ((passes & 4) && binned) {
    raster_ranks<<<blocks_for(32LL * B * T), THREADS, 0, st>>>((const unsigned*)bits, (int*)prefix, (int*)counts,
                                                                (unsigned char*)overflow, B * T, n_words, K);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  } else if (passes & 4) {
    err = cudaMemsetAsync(overflow, 0, (size_t)B * T, st);
    if (err != cudaSuccess) return (int)err;
  }
  if (passes & 8) {
    raster_cover<<<blocks_for((long long)GROUP * B * F), THREADS, 0, st>>>(
        (const float*)fv, (const unsigned*)bits, (const int*)prefix, (const int*)counts,
        (unsigned long long*)keys, (int*)wide, wide_cap, B, F, K, H, W, tile, n_tx, T, n_words);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  if (passes & 16) {
    raster_cover_wide<<<WIDE_BLOCKS, THREADS, 0, st>>>((const float*)fv, (const int*)wide, wide_cap,
                                                       (unsigned long long*)keys, F, H, W, tile, n_tx);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  if (passes & 32) {
    raster_resolve<<<blocks_for((long long)B * H * W), THREADS, 0, st>>>(
        (const float*)fv, (const float*)attrs, (const unsigned long long*)keys, (float*)depth, (int*)tri,
        (float*)bary, (float*)attr_out, B, F, H, W, D);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}
