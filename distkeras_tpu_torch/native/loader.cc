// Host-side data-plane loops of the port: a multithreaded row gather for
// batch planning and the MinMax scale.
//
// The port's copy of distkeras_tpu/native/loader.cc, built from this file
// (never from the JAX package's library). Each fold round's
// [workers, window, batch, ...] array is gathered from the index matrix
// (data/batching.py BatchPlan.round, data/shards.py ShardStore.gather).
// numpy's fancy indexing is single-threaded and holds the GIL; this gather
// runs on a small thread pool, and ctypes releases the GIL for the call, so
// the round feeder's staging overlaps with the training step.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -o <lib> loader.cc -lpthread
// (distkeras_tpu_torch/data/native_loader.py does this at first use into
// build/native/ and names the library after a digest of this source).

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// ABI contract with the ctypes declarations in
// distkeras_tpu_torch/data/native_loader.py (_ABI_VERSION). Bump BOTH on
// any signature change; the Python side refuses a mismatched library.
int dk_abi_version() { return 2; }

// Gather rows: out[i, :] = src[idx[i], :] for i in [0, n_idx).
// row_bytes is the size of one row in bytes; src has n_rows rows.
// Returns 0 on success, -1 on an out-of-range index (out undefined).
int dk_gather_rows(const uint8_t* src, int64_t n_rows, int64_t row_bytes,
                   const int64_t* idx, int64_t n_idx, uint8_t* out,
                   int num_threads) {
  if (num_threads < 1) num_threads = 1;
  std::atomic<int> bad{0};
  auto worker = [&](int64_t begin, int64_t end) {
    for (int64_t i = begin; i < end; ++i) {
      const int64_t r = idx[i];
      if (r < 0 || r >= n_rows) {
        bad.store(1, std::memory_order_relaxed);
        return;
      }
      std::memcpy(out + i * row_bytes, src + r * row_bytes,
                  static_cast<size_t>(row_bytes));
    }
  };
  if (num_threads == 1 || n_idx < 4 * num_threads) {
    worker(0, n_idx);
  } else {
    std::vector<std::thread> threads;
    const int64_t chunk = (n_idx + num_threads - 1) / num_threads;
    for (int t = 0; t < num_threads; ++t) {
      const int64_t begin = t * chunk;
      const int64_t end = begin + chunk < n_idx ? begin + chunk : n_idx;
      if (begin >= end) break;
      threads.emplace_back(worker, begin, end);
    }
    for (auto& th : threads) th.join();
  }
  return bad.load() ? -1 : 0;
}

// Scale float32 values: out = (x - offset) * scale + bias (the
// MinMaxTransformer's loop). bias is applied apart from offset, so that a
// huge scale (a degenerate input range) cannot cancel it away.
void dk_scale_f32(const float* src, int64_t n, float offset, float scale,
                  float bias, float* out, int num_threads) {
  if (num_threads < 1) num_threads = 1;
  auto worker = [&](int64_t begin, int64_t end) {
    for (int64_t i = begin; i < end; ++i)
      out[i] = (src[i] - offset) * scale + bias;
  };
  if (num_threads == 1 || n < 1 << 16) {
    worker(0, n);
  } else {
    std::vector<std::thread> threads;
    const int64_t chunk = (n + num_threads - 1) / num_threads;
    for (int t = 0; t < num_threads; ++t) {
      const int64_t begin = t * chunk;
      const int64_t end = begin + chunk < n ? begin + chunk : n;
      if (begin >= end) break;
      threads.emplace_back(worker, begin, end);
    }
    for (auto& th : threads) th.join();
  }
}

}  // extern "C"
