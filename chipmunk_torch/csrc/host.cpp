// Host-side native runtime of chipmunk_torch: the port's own copy of the
// JAX package's csrc/chipmunk_host.cpp, built by g++ at first use
// (chipmunk_torch/kernels/_build.py) and loaded with ctypes
// (chipmunk_torch/utils/native.py) through a plain C ABI.
//
// Page-aligned, pre-faulted host staging buffers, a multi-threaded
// memcpy into them, memory-bandwidth bitpack/bitunpack of bool masks
// (1 bit an entry of host RAM), and the row-wise weight quantizers that
// quantize_host runs for 2-D weights with per-row scales.

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

#if defined(__linux__)
#include <sys/mman.h>
#include <unistd.h>
#endif

namespace {

constexpr size_t kAlign = 4096;  // page alignment for DMA-friendly staging

struct Buffer {
  void* ptr = nullptr;
  size_t size = 0;
};

std::mutex g_mu;
std::vector<Buffer> g_buffers;

size_t num_workers() {
  unsigned n = std::thread::hardware_concurrency();
  return n == 0 ? 4 : (n > 16 ? 16 : n);
}

template <typename Fn>
void parallel_for(size_t n, size_t grain, Fn fn) {
  size_t workers = num_workers();
  if (n <= grain || workers <= 1) {
    fn(0, n);
    return;
  }
  size_t chunks = (n + grain - 1) / grain;
  if (chunks > workers) chunks = workers;
  size_t per = (n + chunks - 1) / chunks;
  std::vector<std::thread> ts;
  ts.reserve(chunks);
  for (size_t c = 0; c < chunks; ++c) {
    size_t lo = c * per;
    size_t hi = lo + per > n ? n : lo + per;
    if (lo >= hi) break;
    ts.emplace_back([=] { fn(lo, hi); });
  }
  for (auto& t : ts) t.join();
}

}  // namespace

extern "C" {

// ----------------------------------------------------------- buffer pool

// Allocate a page-aligned staging buffer; returns an id (>= 0) or -1.
int64_t chipmunk_host_alloc(uint64_t size) {
  void* p = nullptr;
#if defined(__linux__)
  if (posix_memalign(&p, kAlign, size) != 0) return -1;
  // Hint the kernel to back it with huge pages and keep it resident —
  // the closest portable analogue of cudaHostAlloc pinning.
  madvise(p, size, MADV_HUGEPAGE);
  madvise(p, size, MADV_WILLNEED);
#else
  p = std::aligned_alloc(kAlign, size);
  if (!p) return -1;
#endif
  std::memset(p, 0, size);  // fault pages in now, not during the pipeline
  std::lock_guard<std::mutex> lk(g_mu);
  g_buffers.push_back({p, size});
  return static_cast<int64_t>(g_buffers.size() - 1);
}

void* chipmunk_host_ptr(int64_t id) {
  std::lock_guard<std::mutex> lk(g_mu);
  if (id < 0 || static_cast<size_t>(id) >= g_buffers.size()) return nullptr;
  return g_buffers[id].ptr;
}

void chipmunk_host_free_all() {
  std::lock_guard<std::mutex> lk(g_mu);
  for (auto& b : g_buffers) std::free(b.ptr);
  g_buffers.clear();
}

// --------------------------------------------------------- parallel copy

void chipmunk_memcpy(void* dst, const void* src, uint64_t n) {
  parallel_for(n, 8u << 20, [&](size_t lo, size_t hi) {
    std::memcpy(static_cast<char*>(dst) + lo,
                static_cast<const char*>(src) + lo, hi - lo);
  });
}

// ---------------------------------------------------------- bitpack (8x)

// Pack n bool bytes (0/1) into ceil(n/8) little-endian bitfield bytes
// (bit order matches chipmunk_torch.ops.bitpack).
void chipmunk_bitpack(const uint8_t* src, uint8_t* dst, uint64_t n) {
  uint64_t n_full = n / 8;
  parallel_for(n_full, 4u << 20, [&](size_t lo, size_t hi) {
    for (size_t i = lo; i < hi; ++i) {
      uint64_t w;
      std::memcpy(&w, src + i * 8, 8);
      // gather LSB of each byte into one output byte (little-endian)
      w &= 0x0101010101010101ull;
      dst[i] = static_cast<uint8_t>((w * 0x0102040810204080ull) >> 56);
    }
  });
  if (n % 8) {
    uint8_t b = 0;
    for (uint64_t j = n_full * 8; j < n; ++j)
      b |= (src[j] & 1) << (j - n_full * 8);
    dst[n_full] = b;
  }
}

void chipmunk_bitunpack(const uint8_t* src, uint8_t* dst, uint64_t n) {
  uint64_t n_full = n / 8;
  parallel_for(n_full, 4u << 20, [&](size_t lo, size_t hi) {
    for (size_t i = lo; i < hi; ++i) {
      uint64_t b = src[i];
      // replicate the byte, then keep bit k in byte k and normalize to 0/1
      uint64_t x = b * 0x0101010101010101ull;
      x &= 0x8040201008040201ull;
      // byte k now holds b_k << k; collapse to 0/1 per byte
      x |= x >> 4;
      x |= x >> 2;
      x |= x >> 1;
      x &= 0x0101010101010101ull;
      std::memcpy(dst + i * 8, &x, 8);
    }
  });
  for (uint64_t j = n_full * 8; j < n; ++j)
    dst[j] = (src[n_full] >> (j - n_full * 8)) & 1;
}

}  // extern "C"

// --------------------------------------------------- weight quantization
//
// Row-wise quantizers for load-time weight residency.  Consumer:
// chipmunk_torch/utils/quant.quantize_host (2-D weights with per-row
// scales) — they run across cores and match the numpy path bit-exactly
// (same absmax scale, same IEEE division, round-to-nearest-even).
// w: [rows, cols] float32 row-major.  scale out: [rows] float32.

namespace {

// float32 -> float8_e4m3fn with round-to-nearest-even, saturating to
// +-448 (0x7E); NaN -> 0x7F.  Matches ml_dtypes' cast for the in-range
// values quantize_host produces (|x| <= 448 by construction).
inline uint8_t f32_to_e4m3(float x) {
  uint32_t bits;
  std::memcpy(&bits, &x, 4);
  uint8_t sign = static_cast<uint8_t>((bits >> 24) & 0x80);
  uint32_t abs = bits & 0x7FFFFFFFu;
  if (abs >= 0x43E80000u) {              // >= 464 = RNE saturation bound
    if (abs > 0x7F800000u) return sign | 0x7F;  // NaN
    return sign | 0x7E;                  // saturate to +-448
  }
  if (abs < 0x3C800000u) {               // < 2^-6: e4m3 subnormal range
    float ax;
    std::memcpy(&ax, &abs, 4);
    long m = std::lrint(ax * 512.0f);    // RNE; step = 2^-9
    if (m >= 8) return sign | 0x08;      // rounded up to min normal
    return sign | static_cast<uint8_t>(m);
  }
  // normal range: round the f32 mantissa to 3 bits (RNE) in integer
  // space — the carry propagates into the exponent automatically
  uint32_t lsb = (abs >> 20) & 1;
  uint32_t a = abs + 0x0007FFFFu + lsb;
  int E = static_cast<int>(a >> 23) - 127 + 7;
  uint8_t mant = static_cast<uint8_t>((a >> 20) & 7);
  if (E >= 16 || (E == 15 && mant == 7)) return sign | 0x7E;
  return sign | static_cast<uint8_t>(E << 3) | mant;
}

inline float row_absmax(const float* row, size_t cols) {
  float amax = 0.0f;
  for (size_t c = 0; c < cols; ++c) {
    float a = std::fabs(row[c]);
    if (a > amax) amax = a;
  }
  return amax < 1e-8f ? 1e-8f : amax;
}

}  // namespace

extern "C" {

void chipmunk_quantize_fp8_rows(const float* w, uint8_t* q, float* scale,
                                uint64_t rows, uint64_t cols) {
  parallel_for(rows, 1, [&](size_t lo, size_t hi) {
    for (size_t r = lo; r < hi; ++r) {
      const float* row = w + r * cols;
      float s = row_absmax(row, cols) / 448.0f;
      scale[r] = s;
      uint8_t* out = q + r * cols;
      for (size_t c = 0; c < cols; ++c) out[c] = f32_to_e4m3(row[c] / s);
    }
  });
}

void chipmunk_quantize_int8_rows(const float* w, int8_t* q, float* scale,
                                 uint64_t rows, uint64_t cols) {
  parallel_for(rows, 1, [&](size_t lo, size_t hi) {
    for (size_t r = lo; r < hi; ++r) {
      const float* row = w + r * cols;
      float s = row_absmax(row, cols) / 127.0f;
      scale[r] = s;
      int8_t* out = q + r * cols;
      for (size_t c = 0; c < cols; ++c) {
        float v = std::nearbyint(row[c] / s);  // RNE like np.round
        if (v > 127.0f) v = 127.0f;
        if (v < -127.0f) v = -127.0f;
        out[c] = static_cast<int8_t>(v);
      }
    }
  });
}

// int4 plane-packed along cols (chipmunk_torch.utils.quant format): output
// byte [r, c] holds the low nibble of col c and the high nibble of col
// c + cols/2, both stored offset-binary (+8).  cols must be even.
void chipmunk_quantize_int4_rows(const float* w, uint8_t* q_packed,
                                 float* scale, uint64_t rows,
                                 uint64_t cols) {
  uint64_t half = cols / 2;
  parallel_for(rows, 1, [&](size_t lo, size_t hi) {
    for (size_t r = lo; r < hi; ++r) {
      const float* row = w + r * cols;
      float s = row_absmax(row, cols) / 7.0f;
      scale[r] = s;
      uint8_t* out = q_packed + r * half;
      for (size_t c = 0; c < half; ++c) {
        float v0 = std::nearbyint(row[c] / s);
        float v1 = std::nearbyint(row[c + half] / s);
        int a = v0 > 7.0f ? 7 : (v0 < -8.0f ? -8 : static_cast<int>(v0));
        int b = v1 > 7.0f ? 7 : (v1 < -8.0f ? -8 : static_cast<int>(v1));
        out[c] = static_cast<uint8_t>((a + 8) | ((b + 8) << 4));
      }
    }
  });
}

}  // extern "C"
