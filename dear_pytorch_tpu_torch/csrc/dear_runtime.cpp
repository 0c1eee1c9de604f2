// dear_runtime — native host-side runtime for the TPU training framework.
//
// Role: the counterpart of the reference's native layer. Where the
// reference's C++ (common/comm_core) wraps NCCL/MPI because CUDA-side
// communication needed hand management, on TPU the communication lives in
// XLA — what remains host-side and performance-critical is the INPUT path
// and timing. This library provides:
//
//   * a lock-stepped ring-buffer batch pipeline: N slots of host memory,
//     filled by producer threads running vectorizable RNG fillers
//     (xorshift128+ uniform, Box-Muller normal, bounded ints), consumed by
//     the training loop. Keeps synthetic-batch generation (the reference
//     regenerates with torch.randn / random token ids,
//     dear/imagenet_benchmark.py:97-103, dear/bert_benchmark.py:90-99) off
//     the Python thread that dispatches XLA work.
//   * monotonic nanosecond timers for the profiling layer.
//
// C ABI only (consumed via ctypes; the environment has no pybind11).
// Build: g++ -O2 -shared -fPIC -pthread (see runtime/build.py).

#include <atomic>
#include <chrono>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <thread>
#include <vector>

namespace {

// xorshift128+ — fast, good-enough tail behavior for synthetic data
struct Rng {
  uint64_t s0, s1;
  explicit Rng(uint64_t seed) {
    // splitmix64 seeding
    auto next = [&seed]() {
      seed += 0x9E3779B97F4A7C15ull;
      uint64_t z = seed;
      z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
      z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
      return z ^ (z >> 31);
    };
    s0 = next();
    s1 = next();
  }
  inline uint64_t next() {
    uint64_t a = s0, b = s1;
    s0 = b;
    a ^= a << 23;
    a ^= a >> 18;
    a ^= b ^ (b >> 5);
    s1 = a;
    return a + b;
  }
  inline double uniform() {  // [0, 1)
    return (next() >> 11) * (1.0 / 9007199254740992.0);
  }
};

enum SegmentKind : int32_t {
  kNormalF32 = 0,    // p0 = mean, p1 = stddev
  kUniformI32 = 1,   // ints in [p0, p1)
  kConstI32 = 2,     // p0
  kUniformF32 = 3,   // floats in [p0, p1)
  kBernoulliMaskedI32 = 4,  // p0 = keep prob; value in [0,p1) or -1
};

struct Segment {
  uint64_t offset;   // bytes into the slot
  uint64_t count;    // elements
  int32_t kind;
  double p0, p1;
};

void fill_segment(char* base, const Segment& seg, Rng& rng) {
  char* dst = base + seg.offset;
  switch (seg.kind) {
    case kNormalF32: {
      float* out = reinterpret_cast<float*>(dst);
      uint64_t i = 0;
      // Box-Muller, two at a time
      for (; i + 1 < seg.count; i += 2) {
        double u1 = rng.uniform(), u2 = rng.uniform();
        if (u1 < 1e-300) u1 = 1e-300;
        double r = std::sqrt(-2.0 * std::log(u1));
        double a = 6.283185307179586 * u2;
        out[i] = static_cast<float>(seg.p0 + seg.p1 * r * std::cos(a));
        out[i + 1] = static_cast<float>(seg.p0 + seg.p1 * r * std::sin(a));
      }
      if (i < seg.count) {
        double u1 = rng.uniform(), u2 = rng.uniform();
        if (u1 < 1e-300) u1 = 1e-300;
        out[i] = static_cast<float>(
            seg.p0 + seg.p1 * std::sqrt(-2.0 * std::log(u1)) *
                         std::cos(6.283185307179586 * u2));
      }
      break;
    }
    case kUniformI32: {
      int32_t* out = reinterpret_cast<int32_t*>(dst);
      int64_t lo = static_cast<int64_t>(seg.p0);
      int64_t hi = static_cast<int64_t>(seg.p1);
      uint64_t span = static_cast<uint64_t>(hi - lo);
      if (span == 0) span = 1;
      for (uint64_t i = 0; i < seg.count; ++i)
        out[i] = static_cast<int32_t>(lo + (rng.next() % span));
      break;
    }
    case kConstI32: {
      int32_t* out = reinterpret_cast<int32_t*>(dst);
      int32_t v = static_cast<int32_t>(seg.p0);
      for (uint64_t i = 0; i < seg.count; ++i) out[i] = v;
      break;
    }
    case kUniformF32: {
      float* out = reinterpret_cast<float*>(dst);
      double span = seg.p1 - seg.p0;
      for (uint64_t i = 0; i < seg.count; ++i)
        out[i] = static_cast<float>(seg.p0 + span * rng.uniform());
      break;
    }
    case kBernoulliMaskedI32: {
      int32_t* out = reinterpret_cast<int32_t*>(dst);
      int64_t hi = static_cast<int64_t>(seg.p1);
      uint64_t span = hi > 0 ? static_cast<uint64_t>(hi) : 1;
      for (uint64_t i = 0; i < seg.count; ++i) {
        bool keep = rng.uniform() < seg.p0;
        out[i] = keep ? static_cast<int32_t>(rng.next() % span) : -1;
      }
      break;
    }
    default:
      std::memset(dst, 0, seg.count);
  }
}

struct Pipeline {
  uint64_t slot_bytes;
  std::vector<std::vector<char>> slots;
  std::vector<Segment> segments;
  std::vector<std::thread> workers;

  std::mutex mu;
  std::condition_variable cv_filled, cv_free;
  std::deque<int> free_q, filled_q;
  std::atomic<bool> stop{false};
  std::atomic<uint64_t> produced{0};

  Pipeline(uint64_t bytes, int nslots, int nthreads, uint64_t seed,
           const Segment* segs, int nsegs)
      : slot_bytes(bytes), slots(nslots), segments(segs, segs + nsegs) {
    for (int i = 0; i < nslots; ++i) {
      slots[i].resize(bytes);
      free_q.push_back(i);
    }
    for (int t = 0; t < nthreads; ++t) {
      workers.emplace_back([this, seed, t] { this->worker(seed + 1315423911u * (t + 1)); });
    }
  }

  void worker(uint64_t seed) {
    Rng rng(seed);
    while (true) {
      int slot;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_free.wait(lk, [this] { return stop.load() || !free_q.empty(); });
        if (stop.load()) return;
        slot = free_q.front();
        free_q.pop_front();
      }
      char* base = slots[slot].data();
      for (const auto& seg : segments) fill_segment(base, seg, rng);
      {
        std::lock_guard<std::mutex> lk(mu);
        filled_q.push_back(slot);
        produced.fetch_add(1);
      }
      cv_filled.notify_one();
    }
  }

  int acquire(void** data, int timeout_ms) {
    std::unique_lock<std::mutex> lk(mu);
    bool ok = cv_filled.wait_for(
        lk, std::chrono::milliseconds(timeout_ms),
        [this] { return stop.load() || !filled_q.empty(); });
    if (!ok || stop.load() || filled_q.empty()) return -1;
    int slot = filled_q.front();
    filled_q.pop_front();
    *data = slots[slot].data();
    return slot;
  }

  void release(int slot) {
    {
      std::lock_guard<std::mutex> lk(mu);
      free_q.push_back(slot);
    }
    cv_free.notify_one();
  }

  ~Pipeline() {
    stop.store(true);
    cv_free.notify_all();
    cv_filled.notify_all();
    for (auto& w : workers) w.join();
  }
};

}  // namespace

extern "C" {

uint64_t dear_now_ns() {
  return static_cast<uint64_t>(
      std::chrono::duration_cast<std::chrono::nanoseconds>(
          std::chrono::steady_clock::now().time_since_epoch())
          .count());
}

// Segment layout must match the Python ctypes.Structure mirror.
void* dear_pipeline_create(uint64_t slot_bytes, int nslots, int nthreads,
                           uint64_t seed, const Segment* segs, int nsegs) {
  if (nslots <= 0 || nthreads <= 0 || nsegs < 0) return nullptr;
  return new Pipeline(slot_bytes, nslots, nthreads, seed, segs, nsegs);
}

int dear_pipeline_acquire(void* h, void** data, int timeout_ms) {
  return static_cast<Pipeline*>(h)->acquire(data, timeout_ms);
}

void dear_pipeline_release(void* h, int slot) {
  static_cast<Pipeline*>(h)->release(slot);
}

uint64_t dear_pipeline_produced(void* h) {
  return static_cast<Pipeline*>(h)->produced.load();
}

void dear_pipeline_destroy(void* h) { delete static_cast<Pipeline*>(h); }

}  // extern "C"
