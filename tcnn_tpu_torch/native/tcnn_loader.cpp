// tcnn_tpu_torch native host runtime: threaded training-data sampler.
//
// The port's own copy of native/tcnn_loader.cpp, the JAX package's native
// loader, with the same code, ABI (version 1) and seeds, so that both draw
// the same samples: the port imports nothing of the JAX package, and keeps
// no path into it.  Built with g++ by utils/native_loader.py into build/
// at the root of the checkout.
//
// The counterpart of the reference's on-GPU training-data generation
// (samples/mlp_learning_an_image.cu:229-243 samples a CUDA texture at
// random uvs each step) for data that lives on the host (large images,
// BTF measurement sets, ray dumps): a C++ thread pool fills batch buffers
// with PCG32-driven random samples (uv coords + bilinear texel fetches)
// while the device trains, exposed to Python via ctypes with a prefetch
// queue.
//
// Deliberately dependency-free C++17: no pybind11, plain extern "C" ABI.
//
// PCG32: the same generator family the reference vendors
// (dependencies/pcg32), implemented from the public PCG definition
// (www.pcg-random.org, Apache-2.0 reference algorithm).

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct Pcg32 {
  uint64_t state = 0x853c49e6748fea9bULL;
  uint64_t inc = 0xda3e39cb94b95bdbULL;

  void seed(uint64_t initstate, uint64_t initseq) {
    state = 0u;
    inc = (initseq << 1u) | 1u;
    next();
    state += initstate;
    next();
  }

  uint32_t next() {
    uint64_t old = state;
    state = old * 6364136223846793005ULL + inc;
    uint32_t xorshifted = (uint32_t)(((old >> 18u) ^ old) >> 27u);
    uint32_t rot = (uint32_t)(old >> 59u);
    return (xorshifted >> rot) | (xorshifted << ((~rot + 1u) & 31u));
  }

  // Uniform float in [0, 1) with 24 bits of randomness.
  float next_float() { return (next() >> 8) * (1.0f / 16777216.0f); }
};

struct ImageSampler {
  std::vector<float> image;  // H*W*C row-major
  int h = 0, w = 0, c = 0;
  int n_threads = 0;
};

inline void bilinear_fetch(const ImageSampler& s, float u, float v,
                           float* out) {
  // Texel-center convention: uv*size - 0.5 (matches utils/image.py and
  // CUDA's linear texture filtering with normalized coords).
  float fx = u * s.w - 0.5f;
  float fy = v * s.h - 0.5f;
  float x0f = std::floor(fx);
  float y0f = std::floor(fy);
  float tx = fx - x0f;
  float ty = fy - y0f;
  int x0 = (int)x0f, y0 = (int)y0f;
  auto clampi = [](int x, int lo, int hi) {
    return x < lo ? lo : (x > hi ? hi : x);
  };
  int x0c = clampi(x0, 0, s.w - 1);
  int y0c = clampi(y0, 0, s.h - 1);
  int x1c = clampi(x0 + 1, 0, s.w - 1);
  int y1c = clampi(y0 + 1, 0, s.h - 1);
  const float* base = s.image.data();
  const float* c00 = base + ((size_t)y0c * s.w + x0c) * s.c;
  const float* c01 = base + ((size_t)y0c * s.w + x1c) * s.c;
  const float* c10 = base + ((size_t)y1c * s.w + x0c) * s.c;
  const float* c11 = base + ((size_t)y1c * s.w + x1c) * s.c;
  for (int k = 0; k < s.c; ++k) {
    float top = (1.0f - tx) * c00[k] + tx * c01[k];
    float bot = (1.0f - tx) * c10[k] + tx * c11[k];
    out[k] = (1.0f - ty) * top + ty * bot;
  }
}

}  // namespace

extern "C" {

void* tcnn_sampler_create(const float* image, int h, int w, int c,
                          int n_threads) {
  auto* s = new ImageSampler();
  s->image.assign(image, image + (size_t)h * w * c);
  s->h = h;
  s->w = w;
  s->c = c;
  s->n_threads =
      n_threads > 0 ? n_threads : (int)std::thread::hardware_concurrency();
  if (s->n_threads <= 0) s->n_threads = 4;
  return s;
}

void tcnn_sampler_destroy(void* handle) {
  delete static_cast<ImageSampler*>(handle);
}

// Fill out_xy (n, 2) and out_val (n, C) with random uv samples +
// bilinear fetches.  Deterministic given seed regardless of thread
// count: work is split into fixed-size chunks and each chunk owns a
// PCG32 stream seeded by (seed, chunk_id), so any thread may grab any
// chunk without changing the output.
void tcnn_sampler_sample(void* handle, long long n, uint64_t seed,
                         float* out_xy, float* out_val) {
  auto& s = *static_cast<ImageSampler*>(handle);
  const long long kChunk = 4096;
  const long long n_chunks = (n + kChunk - 1) / kChunk;
  std::atomic<long long> next_chunk{0};

  auto worker = [&]() {
    for (;;) {
      long long ci = next_chunk.fetch_add(1);
      if (ci >= n_chunks) return;
      Pcg32 rng;
      rng.seed(seed, (uint64_t)ci + 1);
      long long begin = ci * kChunk;
      long long end = begin + kChunk < n ? begin + kChunk : n;
      for (long long i = begin; i < end; ++i) {
        float u = rng.next_float();
        float v = rng.next_float();
        out_xy[i * 2 + 0] = u;
        out_xy[i * 2 + 1] = v;
        bilinear_fetch(s, u, v, out_val + i * s.c);
      }
    }
  };

  int nt = s.n_threads;
  if (n < kChunk * 2) nt = 1;
  if (nt <= 1) {
    worker();
  } else {
    std::vector<std::thread> threads;
    threads.reserve(nt);
    for (int t = 0; t < nt; ++t) threads.emplace_back(worker);
    for (auto& t : threads) t.join();
  }
}

// Dense grid evaluation: fills out_val (h*w, C) with pixel-center
// fetches (for inference dumps / golden comparisons).
void tcnn_sampler_grid(void* handle, float* out_xy, float* out_val) {
  auto& s = *static_cast<ImageSampler*>(handle);
  for (int y = 0; y < s.h; ++y) {
    for (int x = 0; x < s.w; ++x) {
      size_t i = (size_t)y * s.w + x;
      float u = (x + 0.5f) / s.w;
      float v = (y + 0.5f) / s.h;
      out_xy[i * 2 + 0] = u;
      out_xy[i * 2 + 1] = v;
      bilinear_fetch(s, u, v, out_val + i * s.c);
    }
  }
}

int tcnn_loader_abi_version() { return 1; }

}  // extern "C"
