// The native data engine of fedrec_tpu_torch: a copy of the JAX package's
// engine (native/fedrec_data.cpp), kept beside the port so that the port
// builds and loads its own library and never the JAX package's. The port
// fills whole epochs only, so the per-batch entry point is left out.
//
// The host-side hot loop that feeds the card: per-epoch shuffling,
// round-robin client sharding with wrap-around padding, without-replacement
// negative sampling, and static-shape batch packing, as a dependency-free
// C++17 library with a C ABI consumed from Python via ctypes
// (fedrec_tpu_torch/data/native_batcher.py).
//
// Semantics mirror fedrec_tpu_torch/data/batcher.py (shapes, sharding,
// padding, pool-shorter-than-ratio behavior); the RNG is its own
// deterministic splitmix64/xoshiro stream, so sampled negatives are
// reproducible per (seed, epoch, client, batch) and bitwise the JAX
// package's engine's, but not numpy's.
//
// Build (done at first use by native_batcher.py):
//   g++ -O3 -std=c++17 -fPIC -Wall -Wextra -pthread -shared \
//       -o build/fedrec_tpu_torch_native/libfedrec_data_<hash>.so fedrec_data.cpp

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <memory>
#include <mutex>
#include <numeric>
#include <thread>
#include <vector>

namespace {

// ----------------------------------------------------------------- RNG
// splitmix64: seeding + short streams (Vigna, public domain reference impl)
static inline uint64_t splitmix64(uint64_t& x) {
  uint64_t z = (x += 0x9E3779B97F4A7C15ULL);
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
  return z ^ (z >> 31);
}

struct Xoshiro256pp {  // xoshiro256++ (Blackman & Vigna, public domain)
  uint64_t s[4];
  explicit Xoshiro256pp(uint64_t seed) {
    for (auto& w : s) w = splitmix64(seed);
  }
  static inline uint64_t rotl(uint64_t x, int k) {
    return (x << k) | (x >> (64 - k));
  }
  uint64_t next() {
    const uint64_t result = rotl(s[0] + s[3], 23) + s[0];
    const uint64_t t = s[1] << 17;
    s[2] ^= s[0];
    s[3] ^= s[1];
    s[1] ^= s[2];
    s[0] ^= s[3];
    s[2] ^= t;
    s[3] = rotl(s[3], 45);
    return result;
  }
  // unbiased bounded draw (Lemire's method with rejection)
  uint64_t bounded(uint64_t n) {
    if (n <= 1) return 0;
    uint64_t x = next();
    __uint128_t m = (__uint128_t)x * n;
    uint64_t l = (uint64_t)m;
    if (l < n) {
      uint64_t t = (0 - n) % n;
      while (l < t) {
        x = next();
        m = (__uint128_t)x * n;
        l = (uint64_t)m;
      }
    }
    return (uint64_t)(m >> 64);
  }
};

static inline uint64_t hash_combine(uint64_t seed, uint64_t a, uint64_t b,
                                    uint64_t c, uint64_t d) {
  uint64_t x = seed;
  // fold each component through the splitmix64 mix
  for (uint64_t v : {a, b, c, d}) {
    x ^= v + 0x9E3779B97F4A7C15ULL + (x << 6) + (x >> 2);
    uint64_t t = x;
    x = splitmix64(t);
  }
  return x;
}

// ----------------------------------------------------------- the engine
struct Batcher {
  // owned copies of the indexed sample arrays (IndexedSamples layout)
  std::vector<int32_t> pos;        // (n)
  std::vector<int32_t> neg_pools;  // (n, max_pool)
  std::vector<int32_t> neg_lens;   // (n)
  std::vector<int32_t> history;    // (n, max_his)
  std::vector<int32_t> his_len;    // (n)
  int64_t n = 0, max_pool = 0, max_his = 0;
  int64_t batch_size = 0, npratio = 0;
  bool shuffle = true, drop_remainder = true;
  uint64_t seed = 0;

  // cached per-epoch permutation (recomputing is O(n) per fill call).
  // Returned as a shared_ptr: a reader iterating epoch E keeps its order
  // alive even if another thread concurrently rebuilds the cache for epoch
  // E+1 (the mutex guards the cache slot, not the readers).
  std::mutex perm_mu;
  int64_t cached_epoch = -1;
  std::shared_ptr<const std::vector<int64_t>> perm;

  std::shared_ptr<const std::vector<int64_t>> epoch_order(int64_t epoch) {
    std::lock_guard<std::mutex> lock(perm_mu);
    if (cached_epoch != epoch || !perm) {
      auto fresh = std::make_shared<std::vector<int64_t>>(n);
      std::iota(fresh->begin(), fresh->end(), 0);
      if (shuffle) {
        Xoshiro256pp rng(hash_combine(seed, (uint64_t)epoch, 0xB, 0, 0));
        for (int64_t i = n - 1; i > 0; --i) {  // Fisher-Yates
          int64_t j = (int64_t)rng.bounded((uint64_t)i + 1);
          std::swap((*fresh)[i], (*fresh)[j]);
        }
      }
      perm = std::move(fresh);
      cached_epoch = epoch;
    }
    return perm;
  }

  // per-client sample count after round-robin dealing with wrap-around pad
  // (= ceil(n / num_clients); shard_indices parity, batcher.py)
  int64_t per_client(int64_t num_clients) const {
    if (n == 0) return 0;
    return (n + num_clients - 1) / num_clients;
  }

  int64_t num_batches(int64_t num_clients) const {
    int64_t pc = per_client(num_clients);
    if (drop_remainder) return pc / batch_size;
    return (pc + batch_size - 1) / batch_size;
  }

  // global sample index for slot `k` of client `c`'s shard.
  // shard c = order[c::num_clients] over the wrap-padded order (tiled pad:
  // padded slot t maps to order[t % n]), matching shard_indices().
  int64_t shard_at(const std::vector<int64_t>& order, int64_t num_clients,
                   int64_t c, int64_t k) const {
    int64_t t = c + k * num_clients;  // position in the padded order
    return order[t % n];
  }

  // sample `npratio` negatives for sample i into out (without replacement;
  // short pools keep all entries and pad with 0 = <unk>, dataset.py:11-12)
  void sample_negs(int64_t i, Xoshiro256pp& rng, int32_t* out) const {
    const int32_t* pool = neg_pools.data() + i * max_pool;
    int64_t len = neg_lens[i];
    if (len <= npratio) {
      for (int64_t j = 0; j < npratio; ++j) out[j] = j < len ? pool[j] : 0;
      return;
    }
    // partial Fisher-Yates over pool indices: first npratio slots are a
    // uniform without-replacement draw
    int64_t idx_buf[64];
    std::vector<int64_t> idx_heap;
    int64_t* idx;
    if (len <= 64) {
      idx = idx_buf;
    } else {
      idx_heap.resize(len);
      idx = idx_heap.data();
    }
    for (int64_t j = 0; j < len; ++j) idx[j] = j;
    for (int64_t j = 0; j < npratio; ++j) {
      int64_t r = j + (int64_t)rng.bounded((uint64_t)(len - j));
      std::swap(idx[j], idx[r]);
      out[j] = pool[idx[j]];
    }
  }

  // fill one (B, ...) batch for client c of batch b in epoch e.
  // cand: (B, 1+npratio)  hist: (B, max_his)  hlen/labels: (B)
  void fill_client_batch(const std::vector<int64_t>& order, int64_t epoch,
                         int64_t b, int64_t num_clients, int64_t c,
                         int32_t* cand, int32_t* hist, int32_t* hlen,
                         int32_t* labels) const {
    int64_t pc = per_client(num_clients);
    // independent stream per (epoch, client, batch): parallel fills are
    // deterministic regardless of thread schedule
    Xoshiro256pp rng(
        hash_combine(seed, (uint64_t)epoch, 0xA, (uint64_t)c, (uint64_t)b));
    int64_t c_width = 1 + npratio;
    for (int64_t j = 0; j < batch_size; ++j) {
      int64_t k = b * batch_size + j;  // slot in this client's shard
      if (k >= pc) k = (k - pc) % pc;  // wrap-around pad (np.resize parity)
      int64_t i = shard_at(order, num_clients, c, k);
      int32_t* crow = cand + j * c_width;
      crow[0] = pos[i];  // positive fixed at slot 0 (dataset.py:83)
      sample_negs(i, rng, crow + 1);
      std::memcpy(hist + j * max_his, history.data() + i * max_his,
                  sizeof(int32_t) * max_his);
      hlen[j] = his_len[i];
      labels[j] = 0;  // label always 0 (dataset.py:85-86)
    }
  }
};

}  // namespace

// ------------------------------------------------------------------ C ABI
extern "C" {

void* frd_create(const int32_t* pos, const int32_t* neg_pools,
                 const int32_t* neg_lens, const int32_t* history,
                 const int32_t* his_len, int64_t n, int64_t max_pool,
                 int64_t max_his, int64_t batch_size, int64_t npratio,
                 int shuffle, int drop_remainder, uint64_t seed) {
  if (n <= 0 || batch_size <= 0 || npratio < 0 || max_pool < 0 || max_his < 0)
    return nullptr;
  auto* b = new Batcher();
  b->pos.assign(pos, pos + n);
  b->neg_pools.assign(neg_pools, neg_pools + n * max_pool);
  b->neg_lens.assign(neg_lens, neg_lens + n);
  b->history.assign(history, history + n * max_his);
  b->his_len.assign(his_len, his_len + n);
  b->n = n;
  b->max_pool = max_pool;
  b->max_his = max_his;
  b->batch_size = batch_size;
  b->npratio = npratio;
  b->shuffle = shuffle != 0;
  b->drop_remainder = drop_remainder != 0;
  b->seed = seed;
  return b;
}

void frd_destroy(void* h) { delete static_cast<Batcher*>(h); }

int64_t frd_num_batches(void* h, int64_t num_clients) {
  auto* b = static_cast<Batcher*>(h);
  if (num_clients <= 0) return -1;
  return b->num_batches(num_clients);
}

// Fill a whole epoch, stacked (steps, C, B, ...), using up to `num_threads`
// worker threads (0 = hardware concurrency). Deterministic: per-(c, b) RNG
// streams are independent of the thread schedule.
int frd_fill_epoch(void* h, int64_t epoch, int64_t num_clients,
                   int64_t num_threads, int32_t* cand, int32_t* hist,
                   int32_t* hlen, int32_t* labels) {
  auto* b = static_cast<Batcher*>(h);
  if (num_clients <= 0) return 1;
  int64_t steps = b->num_batches(num_clients);
  if (steps == 0) return 2;
  const auto order_ptr = b->epoch_order(epoch);
  const auto& order = *order_ptr;
  if (num_threads <= 0)
    num_threads = (int64_t)std::thread::hardware_concurrency();
  num_threads = std::max<int64_t>(1, std::min(num_threads, steps));

  int64_t cw = (1 + b->npratio) * b->batch_size;
  int64_t hw = b->max_his * b->batch_size;
  int64_t step_c = num_clients * cw;   // stride of one step in cand
  int64_t step_h = num_clients * hw;   // stride of one step in hist
  int64_t step_l = num_clients * b->batch_size;

  auto work = [&](int64_t tid) {
    for (int64_t s = tid; s < steps; s += num_threads) {
      for (int64_t c = 0; c < num_clients; ++c) {
        b->fill_client_batch(order, epoch, s, num_clients, c,
                             cand + s * step_c + c * cw,
                             hist + s * step_h + c * hw,
                             hlen + s * step_l + c * b->batch_size,
                             labels + s * step_l + c * b->batch_size);
      }
    }
  };
  std::vector<std::thread> pool;
  for (int64_t t = 1; t < num_threads; ++t) pool.emplace_back(work, t);
  work(0);
  for (auto& th : pool) th.join();
  return 0;
}

int64_t frd_version() { return 1; }

}  // extern "C"
