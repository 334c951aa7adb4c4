// flink_tpu_torch native host layer (C ABI, loaded via ctypes).
//
// The port's own copy of the host half of the JAX package's native layer
// (native/flink_native.cc): the C keydict, the ShardPool worker pool, and the
// write-through window value mirror (WinMirror) that the window operator's
// host emit tier folds into, fires from and snapshots.  The codec, LZ, CRC,
// SpillStore and ring sections of that file are not part of this copy.
//
// It computes what the original computes, bit for bit: the same splitmix64
// hash, the same first-occurrence slot numbering, the same per-shard fold
// order.  Two differences, both of naming and access only:
//   - every exported symbol carries the prefix ``ftt_``, so this library and
//     the JAX package's libflink_native can live in one process;
//   - ftt_keydict_reverse_range copies a slice of the reverse table, so the
//     Python key index can keep its copy of it current by appending only the
//     keys inserted since the last call.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC -pthread -fvisibility=hidden
// (flink_tpu_torch/kernels/build.py: build_host).

#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <mutex>
#include <thread>
#include <unordered_map>
#include <vector>

#if defined(_WIN32)
#error "POSIX only"
#endif
#include <sys/mman.h>

#define API extern "C" __attribute__((visibility("default")))

typedef int64_t i64;
typedef uint64_t u64;
typedef int32_t i32;
typedef uint32_t u32;
typedef uint8_t u8;

// ---------------------------------------------------------------------------
// keydict: vectorized int64 key -> dense int32 slot open-addressing table.
// The native twin of flink_tpu_torch/state/keyindex.py (KeyIndex): one C
// call maps a whole micro-batch of keys to dense state row ids.
// ---------------------------------------------------------------------------

static inline u64 kd_mix64(u64 x) {
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ULL;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBULL;
  return x ^ (x >> 31);
}

namespace {

// mmap-backed buffer advised onto 2MB transparent huge pages.  Random access
// into multi-MB tables (the key dict, the mirror panes) is TLB-bound with 4K
// pages — every probe is a TLB miss on top of the cache miss; 2MB pages cut
// the working set to a handful of TLB entries.  Memory is NOT pre-touched:
// anonymous mmap reads as zero, so untouched regions stay unbacked.
struct HugeBuf {
  u8* p = nullptr;
  size_t mapped = 0;  // 0 => malloc fallback (zero-filled manually)

  HugeBuf() = default;
  HugeBuf(const HugeBuf&) = delete;
  HugeBuf& operator=(const HugeBuf&) = delete;
  HugeBuf(HugeBuf&& o) noexcept { *this = static_cast<HugeBuf&&>(o); }
  HugeBuf& operator=(HugeBuf&& o) noexcept {
    release();
    p = o.p; mapped = o.mapped;
    o.p = nullptr; o.mapped = 0;
    return *this;
  }
  ~HugeBuf() { release(); }

  void release() {
    if (!p) return;
    if (mapped) munmap(p, mapped);
    else free(p);
    p = nullptr;
    mapped = 0;
  }

  // fresh zero-filled allocation (drops previous contents)
  void alloc(size_t bytes) {
    release();
    size_t rounded = (bytes + ((size_t)1 << 21) - 1) & ~((((size_t)1 << 21)) - 1);
    void* m = mmap(nullptr, rounded, PROT_READ | PROT_WRITE,
                   MAP_PRIVATE | MAP_ANONYMOUS, -1, 0);
    if (m != MAP_FAILED) {
      madvise(m, rounded, MADV_HUGEPAGE);
      p = (u8*)m;
      mapped = rounded;
    } else {
      p = (u8*)calloc(1, bytes);
      mapped = 0;
    }
  }
};

struct KeyDict {
  // Interleaved bucket layout: key + slot share a cache line, so a probe
  // costs ONE memory access instead of two parallel-array misses, and the
  // +1 linear-probe neighbour is usually already resident.  slot1 stores
  // slot + 1 so the zero-page state of a fresh HugeBuf IS the empty table.
  struct Bucket { i64 key; i32 slot1; };  // slot1 0 = empty (16B padded)
  u64 cap = 0, mask = 0;
  HugeBuf tabbuf;
  Bucket* tab = nullptr;
  std::vector<i64> reverse; // slot -> key
  i64 n = 0;

  void init(u64 c) {
    cap = 1;
    while (cap < c) cap <<= 1;
    mask = cap - 1;
    tabbuf.alloc(cap * sizeof(Bucket));
    tab = (Bucket*)tabbuf.p;
  }

  inline i32 find_or_insert(i64 key) {
    u64 b = kd_mix64((u64)key) & mask;
    for (;;) {
      Bucket& bk = tab[b];
      if (bk.slot1 == 0) {
        bk.slot1 = (i32)n + 1;
        bk.key = key;
        reverse.push_back(key);
        return (i32)n++;
      }
      if (bk.key == key) return bk.slot1 - 1;
      b = (b + 1) & mask;
    }
  }

  inline i32 find(i64 key) const {
    u64 b = kd_mix64((u64)key) & mask;
    for (;;) {
      const Bucket& bk = tab[b];
      if (bk.slot1 == 0) return -1;
      if (bk.key == key) return bk.slot1 - 1;
      b = (b + 1) & mask;
    }
  }

  void grow_to(u64 c) {
    init(c);
    for (i64 i = 0; i < n; i++) {
      u64 b = kd_mix64((u64)reverse[i]) & mask;
      while (tab[b].slot1 != 0) b = (b + 1) & mask;
      tab[b].slot1 = (i32)i + 1;
      tab[b].key = reverse[i];
    }
  }

  inline void reserve(i64 incoming) {
    // worst case every incoming key is new; keep load factor <= 0.5
    if ((u64)(n + incoming) * 2 > cap) {
      u64 c = cap;
      while ((u64)(n + incoming) * 2 > c) c <<= 1;
      grow_to(c);
    }
  }

  inline void prefetch(i64 key) const {
    __builtin_prefetch(&tab[kd_mix64((u64)key) & mask]);
  }
};

}  // namespace

API void* ftt_keydict_create(i64 initial_cap) {
  KeyDict* d = new KeyDict();
  d->init((u64)(initial_cap > 16 ? initial_cap : 16));
  // pre-size reverse to the load-factor bound so a hinted run avoids
  // push_back's amortized doubling copies
  d->reverse.reserve(d->cap / 2);
  return d;
}

API void ftt_keydict_destroy(void* h) { delete (KeyDict*)h; }

API i64 ftt_keydict_size(void* h) { return ((KeyDict*)h)->n; }

// Probe distance for software pipelining: random hash probes are
// memory-latency bound on one core; issuing the (i + PF)-th bucket's
// prefetch while resolving the i-th keeps ~PF misses in flight.
static const i64 KD_PF = 12;

API void ftt_keydict_lookup_or_insert(void* h, const i64* ks, i64 m, i32* out) {
  KeyDict* d = (KeyDict*)h;
  d->reserve(m);
  for (i64 i = 0; i < m; i++) {
    if (i + KD_PF < m) d->prefetch(ks[i + KD_PF]);
    out[i] = d->find_or_insert(ks[i]);
  }
}

API void ftt_keydict_lookup(void* h, const i64* ks, i64 m, i32* out) {
  KeyDict* d = (KeyDict*)h;
  for (i64 i = 0; i < m; i++) {
    if (i + KD_PF < m) d->prefetch(ks[i + KD_PF]);
    out[i] = d->find(ks[i]);
  }
}

API void ftt_keydict_reverse(void* h, i64* out) {
  KeyDict* d = (KeyDict*)h;
  std::memcpy(out, d->reverse.data(), (size_t)d->n * sizeof(i64));
}

// reverse[lo, hi) into out[0, hi - lo); the caller keeps 0 <= lo <= hi <= n
API void ftt_keydict_reverse_range(void* h, i64 lo, i64 hi, i64* out) {
  KeyDict* d = (KeyDict*)h;
  std::memcpy(out, d->reverse.data() + lo, (size_t)(hi - lo) * sizeof(i64));
}

// ---------------------------------------------------------------------------
// ShardPool: a small persistent worker pool for the sharded probe/mirror
// pass.  The hot path is memory-latency bound on one core (every random
// probe is a cache+TLB miss); a second/third core doubles the number of
// misses in flight, which is the only parallelism this workload has.  The
// CALLING thread executes shard 0 inline, pool workers cover shards
// 1..S-1, so a serial call (S=1) never touches the pool at all.  The pool
// is process-wide and intentionally leaked (daemon-style threads park on
// the condvar forever): joining at static destruction would deadlock
// interpreters that unload the library mid-exit.
// ---------------------------------------------------------------------------

namespace {

struct ShardPool {
  std::vector<std::thread> workers;
  std::mutex mu;
  // serializes whole waves: the pool is process-wide, so two threads
  // sharding concurrently must not clobber each other's job/active/pending
  // — without this the second caller rebinds `job` while the first wave's
  // workers still reference it (use-after-free of the wave lambda).
  // Concurrent callers degrade to serialized waves, which is also the
  // honest schedule: they would be contending for the same cores anyway.
  std::mutex run_mu;
  std::condition_variable cv_work, cv_done;
  std::function<void(int)> job;
  u64 gen = 0;
  int active = 0;   // shards in the current wave (including the caller)
  int pending = 0;  // participating workers not yet finished

  void loop(int tid) {
    u64 seen = 0;
    std::unique_lock<std::mutex> lk(mu);
    for (;;) {
      cv_work.wait(lk, [&] { return gen != seen; });
      seen = gen;
      if (tid < active) {
        auto f = job;  // copy: `job` is rebound by the next wave
        lk.unlock();
        f(tid);
        lk.lock();
        if (--pending == 0) cv_done.notify_all();
      }
    }
  }

  // Run f(tid) for tid in [0, nshards); blocks until every shard returns.
  void run(int nshards, const std::function<void(int)>& f) {
    if (nshards <= 1) {
      f(0);
      return;
    }
    std::lock_guard<std::mutex> wave(run_mu);
    {
      std::unique_lock<std::mutex> lk(mu);
      while ((int)workers.size() < nshards - 1) {
        int tid = (int)workers.size() + 1;  // caller is shard 0
        workers.emplace_back([this, tid] { loop(tid); });
      }
      job = f;
      active = nshards;
      pending = nshards - 1;
      gen++;
      cv_work.notify_all();
    }
    f(0);
    std::unique_lock<std::mutex> lk(mu);
    cv_done.wait(lk, [&] { return pending == 0; });
  }
};

ShardPool* shard_pool() {
  static ShardPool* p = new ShardPool();  // leaked by design, see above
  return p;
}

// below this the parallel path costs more than the misses it hides
static const i64 WM_MIN_PARALLEL = 1 << 14;

}  // namespace

API i32 ftt_hw_threads() { return (i32)std::thread::hardware_concurrency(); }

// ---------------------------------------------------------------------------
// WinMirror: write-through host value mirror of windowed ACC cells.
//
// The native fire/mirror/probe hot path of the window operator's host emit
// tier (flink_tpu_torch/operators/window_agg.py).
//
// Layout: one entry per live pane, rows interleaved as
// [count i64][leaf_0 8B][leaf_1 8B]... so a record update touches ONE cache
// line; leaves are f64 (float accumulators) or i64 (integer accumulators) —
// the higher-precision twins of the device's f32/i32 cells.  The key dict is
// SHARED with the Python key index (same handle), so slot ids agree with the
// device state rows by construction.
//
// ftt_wm_probe_update fuses the key probe and the mirror write-through into
// one pass (the (slot, pane, value) triples are computed once and consumed
// twice); ftt_wm_fire is one sequential pass over slots that combines panes,
// compacts non-empty rows, and resolves keys — fire cost is memory
// bandwidth, not Python.
// ---------------------------------------------------------------------------

namespace {

struct MirrorPane {
  HugeBuf rows;  // interleaved rows, `cap` of them
  i64 cap = 0;
};

struct WinMirror {
  KeyDict* dict = nullptr;  // shared with the Python key index; NOT owned
  int nl = 0;               // number of accumulator leaves (scalar each)
  u8 kind[16];              // per leaf: 0 add, 1 min, 2 max
  u8 lt[16];                // per leaf storage: 0 f64, 1 i64
  u64 init_bits[16];        // identity value bits (storage dtype)
  i64 stride = 0;           // 8 * (1 + nl) bytes per row
  bool zero_init = true;    // all identities are 0 bits: zero pages suffice
  std::unordered_map<i64, MirrorPane> panes;

  void grow(MirrorPane& mp, i64 min_rows) {
    i64 nc = mp.cap ? mp.cap : 1024;
    while (nc < min_rows) nc <<= 1;
    HugeBuf fresh;
    fresh.alloc((size_t)(nc * stride));
    if (!zero_init) {
      // min/max identities are non-zero bit patterns: stamp the template
      // into the grown region (add identities are 0, the mmap default,
      // so sum/count panes skip this and stay zero-page-backed)
      u8 tmpl[8 * 17];
      i64 zero = 0;
      memcpy(tmpl, &zero, 8);
      for (int j = 0; j < nl; j++) memcpy(tmpl + 8 + 8 * j, &init_bits[j], 8);
      for (i64 r = mp.cap; r < nc; r++)
        memcpy(fresh.p + r * stride, tmpl, (size_t)stride);
    }
    if (mp.cap) memcpy(fresh.p, mp.rows.p, (size_t)(mp.cap * stride));
    mp.rows = static_cast<HugeBuf&&>(fresh);
    mp.cap = nc;
  }

  inline MirrorPane* ensure_pane(i64 p, i64 min_rows) {
    MirrorPane& mp = panes[p];
    if (mp.cap < min_rows) grow(mp, min_rows);
    return &mp;
  }
};

// value load: input leaf arrays keep their numpy dtype (no Python-side cast)
enum VDt { VF64 = 0, VF32 = 1, VI64 = 2, VI32 = 3 };

}  // namespace

API void* ftt_wm_create(void* dict_handle, i32 n_leaves, const u8* kinds,
                        const u8* ltypes, const u64* init_bits) {
  if (n_leaves < 1 || n_leaves > 16) return nullptr;
  auto* w = new WinMirror();
  w->dict = (KeyDict*)dict_handle;
  w->nl = n_leaves;
  memcpy(w->kind, kinds, (size_t)n_leaves);
  memcpy(w->lt, ltypes, (size_t)n_leaves);
  memcpy(w->init_bits, init_bits, (size_t)n_leaves * 8);
  w->stride = 8 * (1 + n_leaves);
  w->zero_init = true;
  for (i32 j = 0; j < n_leaves; j++)
    if (init_bits[j] != 0) w->zero_init = false;
  return w;
}

API void ftt_wm_destroy(void* h) { delete (WinMirror*)h; }

API void ftt_wm_drop_pane(void* h, i64 pane) {
  ((WinMirror*)h)->panes.erase(pane);
}

API i64 ftt_wm_pane_count(void* h) {
  return (i64)((WinMirror*)h)->panes.size();
}

API void ftt_wm_live_panes(void* h, i64* out) {
  auto* w = (WinMirror*)h;
  i64 i = 0;
  for (auto& kv : w->panes) out[i++] = kv.first;
}

namespace {

// One record's fold into its mirror row (generic path, any leaf mix).
static inline void wm_fold_one(WinMirror* w, u8* row, const void* const* vals,
                               const u8* vdt, i64 k) {
  (*(i64*)row)++;
  for (int l = 0; l < w->nl; l++) {
    u8* cell = row + 8 + 8 * l;
    if (w->lt[l] == 0) {
      double x;
      switch (vdt[l]) {
        case VF64: x = ((const double*)vals[l])[k]; break;
        case VF32: x = (double)((const float*)vals[l])[k]; break;
        case VI64: x = (double)((const i64*)vals[l])[k]; break;
        default:   x = (double)((const i32*)vals[l])[k]; break;
      }
      double* c = (double*)cell;
      if (w->kind[l] == 0) *c += x;
      else if (w->kind[l] == 1) { if (x < *c) *c = x; }
      else { if (x > *c) *c = x; }
    } else {
      i64 x;
      switch (vdt[l]) {
        case VF64: x = (i64)((const double*)vals[l])[k]; break;
        case VF32: x = (i64)((const float*)vals[l])[k]; break;
        case VI64: x = ((const i64*)vals[l])[k]; break;
        default:   x = (i64)((const i32*)vals[l])[k]; break;
      }
      i64* c = (i64*)cell;
      if (w->kind[l] == 0) *c += x;
      else if (w->kind[l] == 1) { if (x < *c) *c = x; }
      else { if (x > *c) *c = x; }
    }
  }
}

static void wm_probe_serial(WinMirror* w, const i64* keys,
                            const i64* pane_ids, i64 n,
                            const void* const* vals, const u8* vdt,
                            i32* slots_out, i64 pane_mod, i32* flat_out) {
  KeyDict* d = w->dict;
  d->reserve(n);
  for (i64 i = 0; i < n; i++) {
    if (i + KD_PF < n) d->prefetch(keys[i + KD_PF]);
    slots_out[i] = d->find_or_insert(keys[i]);
  }
  const i64 need = d->n;  // fixed for the scatter: all inserts done above
  const i64 stride = w->stride;
  const i64 PF = 16;
  // timestamps arrive roughly sorted, so panes form long runs: segment the
  // batch by pane once and keep the inner loops free of per-record checks
  i64 i = 0;
  while (i < n) {
    const i64 p = pane_ids[i];
    i64 j = i + 1;
    while (j < n && pane_ids[j] == p) j++;
    MirrorPane* mp = w->ensure_pane(p, need);
    u8* base = mp->rows.p;
    if (flat_out) {
      const i32 ps = (i32)(((p % pane_mod) + pane_mod) % pane_mod);
      const i32 mul = (i32)pane_mod;
      for (i64 k = i; k < j; k++) flat_out[k] = slots_out[k] * mul + ps;
    }
    // fast path: single f64 add leaf fed by f32 values (sum over floats —
    // the dominant shape): a direct prefetched scatter
    if (w->nl == 1 && w->kind[0] == 0 && w->lt[0] == 0 && vdt[0] == VF32) {
      const float* v = (const float*)vals[0];
      for (i64 k = i; k < j; k++) {
        if (k + PF < j)
          __builtin_prefetch(base + (i64)slots_out[k + PF] * stride, 1);
        u8* row = base + (i64)slots_out[k] * stride;
        (*(i64*)row)++;
        *(double*)(row + 8) += (double)v[k];
      }
      i = j;
      continue;
    }
    for (i64 k = i; k < j; k++) {
      if (k + PF < j)
        __builtin_prefetch(base + (i64)slots_out[k + PF] * stride, 1);
      wm_fold_one(w, base + (i64)slots_out[k] * stride, vals, vdt, k);
    }
    i = j;
  }
}

// Sharded probe+fold: bitwise identical to the serial pass at ANY shard
// count.  Phase 1 partitions the batch into contiguous record ranges and
// runs READ-ONLY dict lookups in parallel (no inserts -> the table is
// immutable during the scan).  Phase 2 inserts the misses serially in
// batch order, so new keys get exactly the slot ids the serial pass would
// assign.  Phase 3 folds in parallel with slot-ownership partitioning:
// by default shard t owns slots with slot %% S == t; with shard_div > 0
// shard t instead owns the CONTIGUOUS slot range
// [t * shard_div, (t+1) * shard_div).  Either way every mirror cell has
// exactly ONE writer and sees its updates in batch order — no locks, no
// atomics, and the result is bit-identical, not just equivalent.  shard_ns
// (nullable, length >= S) receives each shard's phase-3 fold wall time in
// nanoseconds (the per-shard probe breakdown).
static void wm_probe_sharded(WinMirror* w, const i64* keys,
                             const i64* pane_ids, i64 n,
                             const void* const* vals, const u8* vdt,
                             i32* slots_out, i64 pane_mod, i32* flat_out,
                             i64 flat_cap, i32 flat_pad, int S,
                             i64 shard_div, i64* shard_ns) {
  KeyDict* d = w->dict;
  d->reserve(n);  // up front: phase 1 must not observe a rehash
  ShardPool* pool = shard_pool();
  std::vector<std::vector<i64>> misses((size_t)S);
  pool->run(S, [&](int t) {
    const i64 lo = n * t / S, hi = n * (t + 1) / S;
    auto& miss = misses[(size_t)t];
    for (i64 i = lo; i < hi; i++) {
      if (i + KD_PF < hi) d->prefetch(keys[i + KD_PF]);
      i32 s = d->find(keys[i]);
      slots_out[i] = s;
      if (s < 0) miss.push_back(i);
    }
  });
  // serial insert in batch order (ranges are contiguous and ordered, so
  // concatenating the per-shard miss lists IS the original record order);
  // duplicate new keys resolve to their first occurrence's slot, exactly
  // like the serial pass
  for (int t = 0; t < S; t++)
    for (i64 i : misses[(size_t)t])
      slots_out[i] = d->find_or_insert(keys[i]);
  const i64 need = d->n;
  // pre-grow every pane this batch touches: the parallel fold must not
  // mutate the pane map (iterating pane runs costs one sequential scan)
  {
    i64 i = 0;
    while (i < n) {
      const i64 p = pane_ids[i];
      w->ensure_pane(p, need);
      i64 j = i + 1;
      while (j < n && pane_ids[j] == p) j++;
      i = j;
    }
  }
  const i64 stride = w->stride;
  const i64 PF = 16;
  pool->run(S, [&](int t) {
    const auto t0 = std::chrono::steady_clock::now();
    if (flat_out) {
      // flat device-scatter ids partition by record range (no sharing)
      const i64 lo = n * t / S, hi = n * (t + 1) / S;
      for (i64 k = lo; k < hi; k++) {
        const i64 p = pane_ids[k];
        const i32 ps = (i32)(((p % pane_mod) + pane_mod) % pane_mod);
        flat_out[k] = slots_out[k] * (i32)pane_mod + ps;
      }
      if (t == S - 1)
        for (i64 k = n; k < flat_cap; k++) flat_out[k] = flat_pad;
    }
    const u32 uS = (u32)S, ut = (u32)t;
    const bool by_range = shard_div > 0;
    const i64 own_lo = by_range ? (i64)t * shard_div : 0;
    // the LAST range is open-ended: slots past shard_div * S (a caller
    // whose capacity grew under it) must still have exactly one owner
    const i64 own_hi = !by_range ? 0
        : (t == S - 1 ? INT64_MAX : own_lo + shard_div);
    // mine(s): does this shard own slot s?  Range ownership compares
    // against [own_lo, own_hi); modulo ownership hashes slot classes.
#define WM_MINE(s) (by_range ? ((i64)(s) >= own_lo && (i64)(s) < own_hi) \
                             : ((u32)(s) % uS == ut))
    i64 i = 0;
    while (i < n) {
      const i64 p = pane_ids[i];
      i64 j = i + 1;
      while (j < n && pane_ids[j] == p) j++;
      u8* base = w->panes.find(p)->second.rows.p;  // pre-grown above
      if (w->nl == 1 && w->kind[0] == 0 && w->lt[0] == 0 && vdt[0] == VF32) {
        const float* v = (const float*)vals[0];
        for (i64 k = i; k < j; k++) {
          const i32 s = slots_out[k];
          if (!WM_MINE(s)) continue;
          const i64 kp = k + PF;
          if (kp < j && WM_MINE(slots_out[kp]))
            __builtin_prefetch(base + (i64)slots_out[kp] * stride, 1);
          u8* row = base + (i64)s * stride;
          (*(i64*)row)++;
          *(double*)(row + 8) += (double)v[k];
        }
      } else {
        for (i64 k = i; k < j; k++) {
          const i32 s = slots_out[k];
          if (!WM_MINE(s)) continue;
          const i64 kp = k + PF;
          if (kp < j && WM_MINE(slots_out[kp]))
            __builtin_prefetch(base + (i64)slots_out[kp] * stride, 1);
          wm_fold_one(w, base + (i64)s * stride, vals, vdt, k);
        }
      }
      i = j;
    }
#undef WM_MINE
    if (shard_ns)
      shard_ns[t] = (i64)std::chrono::duration_cast<std::chrono::nanoseconds>(
          std::chrono::steady_clock::now() - t0).count();
  });
}

}  // namespace

// Fused probe + mirror write-through: one pass maps keys -> slots (shared
// dict; new keys insert) and folds each record into its pane's row.  Pane
// pointers are cached across the usual within-batch runs (timestamps arrive
// roughly sorted), and both the hash probe and the mirror row are
// software-prefetched — the loop keeps ~8-12 cache misses in flight, which
// is all the parallelism a single core offers; ``nshards`` > 1 multiplies
// it across cores (see wm_probe_sharded — bit-identical at any count).
// ``pane_mod``/``flat_out``: when flat_out is non-null, also emit the device
// scatter ids flat = slot * pane_mod + pane %% pane_mod (int32) — the ids
// the device update step consumes; flat_out[n..flat_cap) is filled with
// ``flat_pad`` (the dropped-row id).
API void ftt_wm_probe_update2(void* h, const i64* keys, const i64* pane_ids,
                              i64 n, const void* const* vals, const u8* vdt,
                              i32* slots_out, i64 pane_mod, i32* flat_out,
                              i64 flat_cap, i32 flat_pad, i32 nshards,
                              i64 shard_div, i64* shard_ns);

API void ftt_wm_probe_update(void* h, const i64* keys, const i64* pane_ids,
                             i64 n, const void* const* vals, const u8* vdt,
                             i32* slots_out, i64 pane_mod, i32* flat_out,
                             i64 flat_cap, i32 flat_pad, i32 nshards) {
  ftt_wm_probe_update2(h, keys, pane_ids, n, vals, vdt, slots_out, pane_mod,
                       flat_out, flat_cap, flat_pad, nshards, 0, nullptr);
}

// Extended probe entry: ``shard_div`` > 0 switches shard ownership from
// slot %% S classes to contiguous slot ranges [t*shard_div, (t+1)*shard_div).
// ``shard_ns`` (nullable, i64[nshards]) receives per-shard fold wall nanos
// (serial pass: total in shard_ns[0]).
API void ftt_wm_probe_update2(void* h, const i64* keys, const i64* pane_ids,
                              i64 n, const void* const* vals, const u8* vdt,
                              i32* slots_out, i64 pane_mod, i32* flat_out,
                              i64 flat_cap, i32 flat_pad, i32 nshards,
                              i64 shard_div, i64* shard_ns) {
  auto* w = (WinMirror*)h;
  int S = nshards;
  if (S > 16) S = 16;
  // range ownership must cover every slot: with fewer ranges than shards
  // the tail shards simply own nothing (their ranges sit past shard_div*S)
  if (S > 1 && n >= WM_MIN_PARALLEL) {
    wm_probe_sharded(w, keys, pane_ids, n, vals, vdt, slots_out, pane_mod,
                     flat_out, flat_cap, flat_pad, S, shard_div, shard_ns);
    return;
  }
  const auto t0 = std::chrono::steady_clock::now();
  wm_probe_serial(w, keys, pane_ids, n, vals, vdt, slots_out, pane_mod,
                  flat_out);
  if (flat_out)
    for (i64 k = n; k < flat_cap; k++) flat_out[k] = flat_pad;
  if (shard_ns && nshards >= 1) {
    for (i32 t = 1; t < nshards && t < 16; t++) shard_ns[t] = 0;
    shard_ns[0] = (i64)std::chrono::duration_cast<std::chrono::nanoseconds>(
        std::chrono::steady_clock::now() - t0).count();
  }
}

// Window fire: combine the window's panes per slot, compact non-empty rows
// (ascending slot order), resolve raw keys from the shared dict's reverse
// table.  Outputs are caller-allocated with capacity >= dict->n rows.
// Returns the number of emitted rows.  Slots beyond a pane's capacity hold
// the identity by construction, so clamping is sufficient.
API i64 ftt_wm_fire(void* h, const i64* pane_ids, i32 npanes, i64* out_keys,
                    i64* out_counts, void* const* out_leaves) {
  auto* w = (WinMirror*)h;
  const i64 n = w->dict->n;
  std::vector<const u8*> bases_v;
  std::vector<i64> caps_v;
  bases_v.reserve((size_t)npanes);
  caps_v.reserve((size_t)npanes);
  for (i32 i = 0; i < npanes; i++) {
    auto it = w->panes.find(pane_ids[i]);
    if (it == w->panes.end() || it->second.cap == 0) continue;
    bases_v.push_back(it->second.rows.p);
    caps_v.push_back(it->second.cap);
  }
  const int np = (int)bases_v.size();
  if (np == 0 || n == 0) return 0;
  const u8* const* bases = bases_v.data();
  const i64* caps = caps_v.data();
  const i64 stride = w->stride;
  const i64* rev = w->dict->reverse.data();
  i64 m = 0;
  // fast path: tumbling (single pane), one f64 leaf — one sequential sweep
  if (np == 1 && w->nl == 1 && w->lt[0] == 0) {
    const u8* base = bases[0];
    const i64 lim = n < caps[0] ? n : caps[0];
    double* ol = (double*)out_leaves[0];
    for (i64 s = 0; s < lim; s++) {
      const u8* row = base + s * stride;
      const i64 c = *(const i64*)row;
      if (c > 0) {
        out_keys[m] = rev[s];
        out_counts[m] = c;
        ol[m] = *(const double*)(row + 8);
        m++;
      }
    }
    return m;
  }
  for (i64 s = 0; s < n; s++) {
    i64 total = 0;
    for (int q = 0; q < np; q++)
      if (s < caps[q]) total += *(const i64*)(bases[q] + s * stride);
    if (total <= 0) continue;
    out_keys[m] = rev[s];
    out_counts[m] = total;
    // seed the combine from the FIRST present pane's cell (total > 0
    // guarantees one exists) — seeding from the identity instead would
    // double-count a nonzero 'add' identity relative to the numpy mirror
    for (int j = 0; j < w->nl; j++) {
      if (w->lt[j] == 0) {
        double acc = 0;
        bool first = true;
        for (int q = 0; q < np; q++) {
          if (s >= caps[q]) continue;
          double v = *(const double*)(bases[q] + s * stride + 8 + 8 * j);
          if (first) { acc = v; first = false; }
          else if (w->kind[j] == 0) acc += v;
          else if (w->kind[j] == 1) acc = v < acc ? v : acc;
          else acc = v > acc ? v : acc;
        }
        ((double*)out_leaves[j])[m] = acc;
      } else {
        i64 acc = 0;
        bool first = true;
        for (int q = 0; q < np; q++) {
          if (s >= caps[q]) continue;
          i64 v = *(const i64*)(bases[q] + s * stride + 8 + 8 * j);
          if (first) { acc = v; first = false; }
          else if (w->kind[j] == 0) acc += v;
          else if (w->kind[j] == 1) acc = v < acc ? v : acc;
          else acc = v > acc ? v : acc;
        }
        ((i64*)out_leaves[j])[m] = acc;
      }
    }
    m++;
  }
  return m;
}

// Fold a pane-granular DELTA into the mirror (the device key probe's
// catch-up path, flink_tpu_torch/state/device_keyindex.py): ``counts`` adds
// into the per-row element counts, each leaf column combines by its kind.
// The delta columns are identity-initialized on the device, so folding an
// untouched row is a no-op by construction (add identity 0, min/max
// identities compare away) — no mask is needed.  Rows past the pane's
// current capacity grow it first, like ftt_wm_import_pane.
API void ftt_wm_apply_delta(void* h, i64 pane, i64 nrows, const i64* counts,
                            const void* const* vals, const u8* vdt) {
  auto* w = (WinMirror*)h;
  i64 need = nrows > w->dict->n ? nrows : w->dict->n;
  MirrorPane* mp = w->ensure_pane(pane, need);
  u8* base = mp->rows.p;
  const i64 stride = w->stride;
  for (i64 s = 0; s < nrows; s++) {
    u8* row = base + s * stride;
    *(i64*)row += counts[s];
    for (int l = 0; l < w->nl; l++) {
      u8* cell = row + 8 + 8 * l;
      if (w->lt[l] == 0) {
        double x;
        switch (vdt[l]) {
          case VF64: x = ((const double*)vals[l])[s]; break;
          case VF32: x = (double)((const float*)vals[l])[s]; break;
          case VI64: x = (double)((const i64*)vals[l])[s]; break;
          default:   x = (double)((const i32*)vals[l])[s]; break;
        }
        double* c = (double*)cell;
        if (w->kind[l] == 0) *c += x;
        else if (w->kind[l] == 1) { if (x < *c) *c = x; }
        else { if (x > *c) *c = x; }
      } else {
        i64 x;
        switch (vdt[l]) {
          case VF64: x = (i64)((const double*)vals[l])[s]; break;
          case VF32: x = (i64)((const float*)vals[l])[s]; break;
          case VI64: x = ((const i64*)vals[l])[s]; break;
          default:   x = (i64)((const i32*)vals[l])[s]; break;
        }
        i64* c = (i64*)cell;
        if (w->kind[l] == 0) *c += x;
        else if (w->kind[l] == 1) { if (x < *c) *c = x; }
        else { if (x > *c) *c = x; }
      }
    }
  }
}

// De-interleave one pane's first `nrows` rows into columnar buffers
// (snapshots, verification).  Rows beyond the pane's capacity export as
// count 0 / identity.  Returns 1 if the pane exists, else 0 (buffers are
// still filled with identity rows).
API i32 ftt_wm_export_pane(void* h, i64 pane, i64 nrows, i64* counts_out,
                           void* const* leaves_out) {
  auto* w = (WinMirror*)h;
  auto it = w->panes.find(pane);
  const u8* base = nullptr;
  i64 cap = 0;
  if (it != w->panes.end()) {
    base = it->second.rows.p;
    cap = it->second.cap;
  }
  const i64 stride = w->stride;
  for (i64 s = 0; s < nrows; s++) {
    if (s < cap) {
      const u8* row = base + s * stride;
      counts_out[s] = *(const i64*)row;
      for (int j = 0; j < w->nl; j++)
        memcpy((u8*)leaves_out[j] + 8 * s, row + 8 + 8 * j, 8);
    } else {
      counts_out[s] = 0;
      for (int j = 0; j < w->nl; j++)
        memcpy((u8*)leaves_out[j] + 8 * s, &w->init_bits[j], 8);
    }
  }
  return it != w->panes.end() ? 1 : 0;
}

// Interleave columnar buffers into one pane's rows (snapshot restore).
API void ftt_wm_import_pane(void* h, i64 pane, i64 nrows, const i64* counts,
                            const void* const* leaves) {
  auto* w = (WinMirror*)h;
  MirrorPane* mp = w->ensure_pane(pane, nrows);
  u8* base = mp->rows.p;
  const i64 stride = w->stride;
  for (i64 s = 0; s < nrows; s++) {
    u8* row = base + s * stride;
    *(i64*)row = counts[s];
    for (int j = 0; j < w->nl; j++)
      memcpy(row + 8 + 8 * j, (const u8*)leaves[j] + 8 * s, 8);
  }
}
