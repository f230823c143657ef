// Native token-corpus data loader: mmap + shuffled sharded sampling +
// multi-threaded ordered prefetch (the port's copy of the JAX package's
// `_native/token_loader.cpp`; both packages' loaders give the same
// batches in the same order).
//
// Host C++, no device code: tokenized corpora are memory-mapped (no read
// amplification, page cache shared across processes), samples are
// fixed-length windows, each epoch is a seeded permutation sharded across
// processes, and producer threads assemble batches ahead of the training
// step. Exposed through a C ABI consumed by ctypes (native/__init__.py);
// semantics mirrored by the numpy fallback there.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -pthread token_loader.cpp -o libatl.so

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <mutex>
#include <random>
#include <sys/mman.h>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

enum DType { DT_U16 = 0, DT_I32 = 1, DT_U32 = 2 };

struct Corpus {
  int fd = -1;
  const uint8_t* data = nullptr;
  size_t bytes = 0;
  int dtype = DT_I32;
  long sample_len = 0;   // tokens per sample window
  long num_tokens = 0;
  long num_samples = 0;
};

size_t elem_size(int dtype) { return dtype == DT_U16 ? 2 : 4; }

struct Slot {
  std::vector<int32_t> buf;
  long batch_id = -1;
  bool ready = false;
};

struct Loader {
  Corpus* corpus = nullptr;
  long batch = 0;
  bool shuffle = true;
  uint64_t seed = 0;
  int rank = 0, world = 1;
  bool drop_last = true;
  int threads = 2;
  int depth = 4;

  // epoch state
  std::vector<long> order;       // this shard's sample indices
  long num_batches = 0;
  std::vector<Slot> slots;
  std::vector<std::thread> pool;
  std::mutex mu;
  std::condition_variable cv_prod, cv_cons;
  std::atomic<long> next_claim{0};
  long next_consume = 0;
  bool stopping = false;

  ~Loader() { stop(); }

  void stop() {
    {
      std::lock_guard<std::mutex> lk(mu);
      stopping = true;
    }
    cv_prod.notify_all();
    cv_cons.notify_all();
    for (auto& t : pool)
      if (t.joinable()) t.join();
    pool.clear();
    stopping = false;
  }

  void fill_batch(long b, Slot& slot) {
    const Corpus& c = *corpus;
    const long L = c.sample_len;
    slot.buf.resize(batch * L);
    const long base = b * batch;
    const long avail = (long)order.size();
    for (long i = 0; i < batch; ++i) {
      // wraparound padding for a short final batch (even_batches semantics)
      const long idx = order[(base + i) % avail];
      const uint8_t* src = c.data + (size_t)idx * L * elem_size(c.dtype);
      int32_t* dst = slot.buf.data() + i * L;
      if (c.dtype == DT_I32) {
        std::memcpy(dst, src, L * 4);
      } else if (c.dtype == DT_U16) {
        const uint16_t* s = reinterpret_cast<const uint16_t*>(src);
        for (long t = 0; t < L; ++t) dst[t] = (int32_t)s[t];
      } else {
        const uint32_t* s = reinterpret_cast<const uint32_t*>(src);
        for (long t = 0; t < L; ++t) dst[t] = (int32_t)s[t];
      }
    }
  }

  void producer() {
    for (;;) {
      const long b = next_claim.fetch_add(1);
      if (b >= num_batches) return;
      Slot& slot = slots[b % depth];
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_prod.wait(lk, [&] { return stopping || b - next_consume < depth; });
        if (stopping) return;
      }
      fill_batch(b, slot);
      {
        std::lock_guard<std::mutex> lk(mu);
        slot.batch_id = b;
        slot.ready = true;
      }
      cv_cons.notify_all();
    }
  }

  // SplitMix64: trivially portable, reproduced bit-for-bit by the Python
  // fallback (native/__init__.py) so mixed native/fallback fleets compute
  // IDENTICAL permutations — host shards stay disjoint either way.
  static uint64_t splitmix64(uint64_t& s) {
    uint64_t z = (s += 0x9E3779B97F4A7C15ull);
    z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
    z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
    return z ^ (z >> 31);
  }

  void start_epoch(long epoch) {
    stop();
    const Corpus& c = *corpus;
    // deterministic epoch order, identical on every host; shard by stride
    std::vector<long> all(c.num_samples);
    for (long i = 0; i < c.num_samples; ++i) all[i] = i;
    if (shuffle) {
      uint64_t s = seed ^ ((uint64_t)epoch * 0xD1B54A32D192ED03ull);
      for (long i = c.num_samples - 1; i > 0; --i) {
        const long j = (long)(splitmix64(s) % (uint64_t)(i + 1));
        std::swap(all[i], all[j]);
      }
    }
    // every rank takes exactly ceil(n/world) samples (wraparound fill), so
    // all hosts run the same number of batches — SPMD lockstep
    const long per = (c.num_samples + world - 1) / world;
    order.clear();
    order.reserve(per);
    for (long i = 0; i < per; ++i)
      order.push_back(all[(rank + i * world) % c.num_samples]);
    const long n = per;
    num_batches = drop_last ? n / batch : (n + batch - 1) / batch;
    slots.assign(depth, Slot{});
    next_claim.store(0);
    next_consume = 0;
    const int t = (int)std::max<long>(1, std::min<long>(threads, num_batches));
    for (int i = 0; i < t; ++i) pool.emplace_back([this] { producer(); });
  }

  // 0 = batch written, 1 = epoch exhausted
  int next(int32_t* out) {
    if (next_consume >= num_batches) return 1;
    const long b = next_consume;
    Slot& slot = slots[b % depth];
    {
      std::unique_lock<std::mutex> lk(mu);
      cv_cons.wait(lk, [&] { return slot.ready && slot.batch_id == b; });
    }
    std::memcpy(out, slot.buf.data(), slot.buf.size() * 4);
    {
      std::lock_guard<std::mutex> lk(mu);
      slot.ready = false;
      next_consume = b + 1;
    }
    cv_prod.notify_all();
    return 0;
  }
};

}  // namespace

extern "C" {

void* atl_open(const char* path, int dtype_code, long sample_len) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    ::close(fd);
    return nullptr;
  }
  void* p = mmap(nullptr, st.st_size, PROT_READ, MAP_SHARED, fd, 0);
  if (p == MAP_FAILED) {
    ::close(fd);
    return nullptr;
  }
  madvise(p, st.st_size, MADV_WILLNEED);
  auto* c = new Corpus;
  c->fd = fd;
  c->data = static_cast<const uint8_t*>(p);
  c->bytes = st.st_size;
  c->dtype = dtype_code;
  c->sample_len = sample_len;
  c->num_tokens = (long)(st.st_size / elem_size(dtype_code));
  c->num_samples = sample_len > 0 ? c->num_tokens / sample_len : 0;
  return c;
}

long atl_num_samples(void* corpus) {
  return corpus ? static_cast<Corpus*>(corpus)->num_samples : -1;
}

long atl_num_tokens(void* corpus) {
  return corpus ? static_cast<Corpus*>(corpus)->num_tokens : -1;
}

void atl_close(void* corpus) {
  auto* c = static_cast<Corpus*>(corpus);
  if (!c) return;
  if (c->data) munmap(const_cast<uint8_t*>(c->data), c->bytes);
  if (c->fd >= 0) ::close(c->fd);
  delete c;
}

void* atl_loader_new(void* corpus, long batch, int shuffle, uint64_t seed,
                     int rank, int world, int drop_last, int threads,
                     int depth) {
  if (!corpus || batch <= 0 || world <= 0 || rank < 0 || rank >= world)
    return nullptr;
  auto* l = new Loader;
  l->corpus = static_cast<Corpus*>(corpus);
  l->batch = batch;
  l->shuffle = shuffle != 0;
  l->seed = seed;
  l->rank = rank;
  l->world = world;
  l->drop_last = drop_last != 0;
  l->threads = threads > 0 ? threads : 2;
  l->depth = depth > 0 ? depth : 4;
  return l;
}

long atl_loader_batches_per_epoch(void* loader) {
  if (!loader) return -1;
  auto* l = static_cast<Loader*>(loader);
  const long n = (l->corpus->num_samples + l->world - 1) / l->world;
  return l->drop_last ? n / l->batch : (n + l->batch - 1) / l->batch;
}

void atl_loader_start_epoch(void* loader, long epoch) {
  if (loader) static_cast<Loader*>(loader)->start_epoch(epoch);
}

int atl_loader_next(void* loader, int32_t* out) {
  return loader ? static_cast<Loader*>(loader)->next(out) : -1;
}

void atl_loader_free(void* loader) { delete static_cast<Loader*>(loader); }

}  // extern "C"
