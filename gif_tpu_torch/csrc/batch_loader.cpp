// Native batch assembly for the input pipeline (the port's copy of the
// JAX package's native/batch_loader.cpp, unchanged in its arithmetic).
//
// The reference feeds the GPU through 16 torch DataLoader worker processes
// doing LMDB reads + JPEG decode + normalize (dataset_loaders.py,
// sample_data :390-397).  Frames are stored as a memory-mapped uint8 array,
// so the host hot loop is: gather batch rows, convert to float32 in
// [-1, 1], optionally mirror.  This library does that with a thread pool
// and one pass over the data; gif_tpu_torch.data.native builds it with g++
// on first use and loads it with ctypes (a plain C interface, no PyTorch
// headers).  A failed build raises there: there is no silent fallback.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct Job {
  const uint8_t* images;   // (n, h, w, c) contiguous
  const int64_t* indices;  // (batch,)
  const uint8_t* flip;     // (batch,) or nullptr; 1 = mirror horizontally
  float* out;              // (batch, h, w, c)
  int64_t h, w, c;
};

void assemble_range(const Job& job, int64_t lo, int64_t hi) {
  const int64_t row = job.w * job.c;
  const int64_t img = job.h * row;
  for (int64_t b = lo; b < hi; ++b) {
    const uint8_t* src = job.images + job.indices[b] * img;
    float* dst = job.out + b * img;
    const bool mirror = job.flip != nullptr && job.flip[b];
    if (!mirror) {
      for (int64_t i = 0; i < img; ++i) {
        dst[i] = (static_cast<float>(src[i]) - 127.5f) / 127.5f;
      }
    } else {
      for (int64_t y = 0; y < job.h; ++y) {
        const uint8_t* srow = src + y * row;
        float* drow = dst + y * row;
        for (int64_t x = 0; x < job.w; ++x) {
          const uint8_t* sp = srow + (job.w - 1 - x) * job.c;
          float* dp = drow + x * job.c;
          for (int64_t ch = 0; ch < job.c; ++ch) {
            dp[ch] = (static_cast<float>(sp[ch]) - 127.5f) / 127.5f;
          }
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// Returns 0 on success.
int gif_assemble_batch(const uint8_t* images, int64_t n_images, int64_t h,
                       int64_t w, int64_t c, const int64_t* indices,
                       int64_t batch, const uint8_t* flip, float* out,
                       int64_t n_threads) {
  if (images == nullptr || indices == nullptr || out == nullptr) return 1;
  for (int64_t b = 0; b < batch; ++b) {
    if (indices[b] < 0 || indices[b] >= n_images) return 2;
  }
  Job job{images, indices, flip, out, h, w, c};
  if (n_threads <= 1 || batch == 1) {
    assemble_range(job, 0, batch);
    return 0;
  }
  const int64_t workers =
      n_threads < batch ? n_threads : batch;  // one chunk per worker
  std::vector<std::thread> threads;
  threads.reserve(workers);
  const int64_t chunk = (batch + workers - 1) / workers;
  for (int64_t t = 0; t < workers; ++t) {
    const int64_t lo = t * chunk;
    const int64_t hi = (lo + chunk) < batch ? (lo + chunk) : batch;
    if (lo >= hi) break;
    threads.emplace_back([&job, lo, hi] { assemble_range(job, lo, hi); });
  }
  for (auto& th : threads) th.join();
  return 0;
}

// uint8 HWC -> float32 normalize only (whole-array), used by eval paths.
int gif_normalize_u8(const uint8_t* src, int64_t count, float scale,
                     float shift, float* out) {
  if (src == nullptr || out == nullptr) return 1;
  for (int64_t i = 0; i < count; ++i) {
    out[i] = static_cast<float>(src[i]) * scale + shift;
  }
  return 0;
}

}  // extern "C"
