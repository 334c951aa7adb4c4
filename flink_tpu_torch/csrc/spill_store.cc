// flink_tpu_torch spill store (C ABI, loaded via ctypes).
//
// Two stores of the port's own version of the SpillStore of the JAX
// package's native layer (native/flink_native.cc), in one library:
//
// 1. The cell store (``ftt_spill_*_cells``): the storage tier of cold-key
//    paging (flink_tpu_torch/state/paging.py, PaneSpillStore).  Entries are
//    pane cells keyed (gid, pane), with values of one fixed length per store
//    (``u8 flags | i64 count | leaf bytes``, the JAX package's layout).
// 2. The key-value store (``ftt_spill_kv_*``): byte keys and byte values of
//    any length, under the spill keyed-state backend
//    (flink_tpu_torch/state/spill.py, SpillKeyedStateBackend).  These are
//    JAX's ``spill_put``/``spill_get``/``spill_delete``/``spill_count``/
//    ``spill_iter_*``/``spill_flush``/``spill_compact`` with the ``ftt_``
//    prefix.
//
// Both hold values in memory up to a byte budget; past it, values move to an
// append-only log, oldest write first.  What they keep from the original, so
// the same calls leave the same values, the same resident bytes and the same
// log bytes:
//   - the eviction rule: a queue of keys in first-write order (an update of
//     a present key does not re-enter it) walked by a cursor, each resident
//     value it reaches moved to the log until the budget holds; when the
//     queue runs out while over budget, it is rebuilt from the resident
//     keys;
//   - the accounting: resident bytes are the values' lengths, the log only
//     grows (until a key-value ``compact``), a delete or ``clear`` leaves
//     the queue as it is;
//   - the log record: [crc u32][klen u32][vlen u32][key][value], the CRC-32
//     (IEEE) of the key bytes then the value bytes (a cell's key is the 16
//     bytes of struct('<qq', gid, pane)).
//
// The key-value store also keeps the original's ``log_garbage`` count (dead
// value bytes in the log), its ``FSP1`` manifest, written by ``flush`` and
// read back when a store opens in the same directory, and its ``compact``,
// which rewrites the log with only the live spilled values and returns the
// bytes it reclaimed.  Its index is a ``std::unordered_map`` of the key
// bytes, as the original's, so its queue rebuilds walk the same order.
//
// What differs:
//   - every exported symbol carries the prefix ``ftt_``, so this library and
//     the JAX package's libflink_native can live in one process;
//   - the cell index is an open-addressing table of (gid, pane) with the
//     values in one slab, and the entries take whole arrays of cells, so a
//     batch's page-out or promotion is one call with no allocation per cell;
//   - the cell queue's rebuild (which paging never reaches: it never updates
//     a present cell) walks the resident keys in table order, where the
//     original walks its hash map's order;
//   - each log is one file descriptor: appended records gather in a write
//     buffer and go out with pwrite.  A cell read sorts the spilled values
//     of one call by offset and reads each run of nearby records with one
//     pread (or copies it out of the buffer); a key-value read is one pread.
//     The original flushes, reopens and seeks the file for every read;
//   - the cell store has no manifest, flush or compaction.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC -pthread -fvisibility=hidden
// (flink_tpu_torch/kernels/build.py: build_host).

#include <algorithm>
#include <cerrno>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <cstdio>
#include <string>
#include <unordered_map>
#include <utility>
#include <vector>

#if defined(_WIN32)
#error "POSIX only"
#endif
#include <fcntl.h>
#include <sys/stat.h>
#include <sys/types.h>
#include <unistd.h>

#define API extern "C" __attribute__((visibility("default")))

typedef int64_t i64;
typedef uint64_t u64;
typedef uint32_t u32;
typedef uint8_t u8;

namespace {

// ---------------------------------------------------------------------------
// CRC32 (IEEE, table-driven): log record integrity
// ---------------------------------------------------------------------------

u32 crc_table[256];
std::once_flag crc_once;

void crc_init() {
  for (u32 i = 0; i < 256; i++) {
    u32 c = i;
    for (int k = 0; k < 8; k++) c = (c & 1) ? 0xedb88320u ^ (c >> 1) : c >> 1;
    crc_table[i] = c;
  }
}

u32 crc32(const u8* data, i64 n, u32 seed) {
  std::call_once(crc_once, crc_init);
  u32 c = seed ^ 0xffffffffu;
  for (i64 i = 0; i < n; i++) c = crc_table[(c ^ data[i]) & 0xff] ^ (c >> 8);
  return c ^ 0xffffffffu;
}

// ---------------------------------------------------------------------------
// the index: (gid, pane) -> a resident value's slab slot or a log offset
// ---------------------------------------------------------------------------

struct Key {
  i64 gid, pane;
};

constexpr u32 kKeyBytes = 16;   // struct('<qq', gid, pane)

struct Slot {
  i64 gid, pane;
  i64 loc;      // >= 0: slab slot of the resident value; < 0: ~log offset
  i64 used;     // 0 = empty
};

inline u64 mix64(u64 x) {
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ULL;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBULL;
  return x ^ (x >> 31);
}

inline u64 key_hash(i64 gid, i64 pane) {
  return mix64((u64)gid * 0x9E3779B97F4A7C15ULL ^ (u64)pane);
}

// appended records are written out once this many bytes are buffered
constexpr size_t kWriteChunk = (size_t)1 << 20;
// log records closer than this are read in one pread, with the gap
constexpr i64 kReadGap = (i64)1 << 16;
// and one pread reads at most this much
constexpr i64 kReadRun = (i64)1 << 23;

struct SpillStore {
  i64 mem_budget = 0;
  i64 vlen = 0;           // the length of every value
  i64 mem_used = 0;       // resident value bytes
  i64 log_end = 0;        // append position
  int fd = -1;
  std::string wbuf;       // the log's bytes [log_end - wbuf.size(), log_end)
  std::vector<Slot> table;   // power-of-two capacity, linear probing
  i64 n_used = 0;
  std::vector<u8> slab;      // resident values, vlen bytes a slot
  std::vector<i64> slab_free;
  std::mutex mu;
  // keys in first-write order; [evict_cursor, size) not yet reached
  std::vector<Key> write_order;
  size_t evict_cursor = 0;
};

// the table slot of (gid, pane), or -1
i64 find(const SpillStore* s, i64 gid, i64 pane) {
  const u64 mask = s->table.size() - 1;
  for (u64 i = key_hash(gid, pane) & mask;; i = (i + 1) & mask) {
    const Slot& t = s->table[i];
    if (!t.used) return -1;
    if (t.gid == gid && t.pane == pane) return (i64)i;
  }
}

void place(std::vector<Slot>& table, const Slot& slot) {
  const u64 mask = table.size() - 1;
  u64 i = key_hash(slot.gid, slot.pane) & mask;
  while (table[i].used) i = (i + 1) & mask;
  table[i] = slot;
}

// a new entry (the key is absent); the table doubles at half load
void insert(SpillStore* s, i64 gid, i64 pane, i64 loc) {
  if ((u64)(s->n_used + 1) * 2 > s->table.size()) {
    std::vector<Slot> grown(s->table.size() * 2, Slot{0, 0, 0, 0});
    for (const Slot& t : s->table)
      if (t.used) place(grown, t);
    s->table.swap(grown);
  }
  place(s->table, Slot{gid, pane, loc, 1});
  s->n_used++;
}

// remove slot i (backward-shift deletion keeps every probe chain whole)
void remove_slot(SpillStore* s, u64 i) {
  const u64 mask = s->table.size() - 1;
  u64 j = i;
  for (;;) {
    j = (j + 1) & mask;
    if (!s->table[j].used) break;
    u64 home = key_hash(s->table[j].gid, s->table[j].pane) & mask;
    // the entry at j stays iff its home lies cyclically in (i, j]
    bool stays = i <= j ? (i < home && home <= j) : (i < home || home <= j);
    if (!stays) {
      s->table[i] = s->table[j];
      i = j;
    }
  }
  s->table[i].used = 0;
  s->n_used--;
}

u8* slab_at(SpillStore* s, i64 slot) {
  return &s->slab[(size_t)(slot * s->vlen)];
}

i64 slab_alloc(SpillStore* s) {
  if (!s->slab_free.empty()) {
    i64 slot = s->slab_free.back();
    s->slab_free.pop_back();
    return slot;
  }
  i64 slot = (i64)(s->slab.size() / (size_t)s->vlen);
  s->slab.resize(s->slab.size() + (size_t)s->vlen);
  return slot;
}

// the 16 key bytes of a log record
void key_bytes(i64 gid, i64 pane, u8* out) {
  memcpy(out, &gid, 8);
  memcpy(out + 8, &pane, 8);
}

// ---------------------------------------------------------------------------
// the log
// ---------------------------------------------------------------------------

bool write_out(SpillStore* s) {
  i64 at = s->log_end - (i64)s->wbuf.size();
  size_t done = 0;
  while (done < s->wbuf.size()) {
    ssize_t w = pwrite(s->fd, s->wbuf.data() + done, s->wbuf.size() - done,
                       (off_t)(at + (i64)done));
    if (w < 0 && errno == EINTR) continue;
    if (w <= 0) return false;
    done += (size_t)w;
  }
  s->wbuf.clear();
  return true;
}

// Append a record; returns the offset of its value, or -1 on a write error.
i64 log_append(SpillStore* s, i64 gid, i64 pane, const u8* val) {
  u8 key[kKeyBytes];
  key_bytes(gid, pane, key);
  u32 klen = kKeyBytes, vlen = (u32)s->vlen;
  u32 crc = crc32(key, klen, 0);
  crc = crc32(val, vlen, crc);
  s->wbuf.append((const char*)&crc, 4);
  s->wbuf.append((const char*)&klen, 4);
  s->wbuf.append((const char*)&vlen, 4);
  s->wbuf.append((const char*)key, klen);
  s->wbuf.append((const char*)val, vlen);
  i64 off = s->log_end + 12 + klen;
  s->log_end += 12 + klen + vlen;
  if (s->wbuf.size() >= kWriteChunk && !write_out(s)) return -1;
  return off;
}

bool pread_all(int fd, u8* dst, size_t n, i64 at) {
  size_t done = 0;
  while (done < n) {
    ssize_t r = pread(fd, dst + done, n - done, (off_t)(at + (i64)done));
    if (r < 0 && errno == EINTR) continue;
    if (r <= 0) return false;
    done += (size_t)r;
  }
  return true;
}

// One spilled value to read: its record starts at ``start``.
struct LogRead {
  i64 start;
  i64 cell;            // the caller's index of the cell
  Key key;
};

// Verify one record (its header and key, and its CRC over the key bytes then
// the value bytes) and return a pointer to its value, or nullptr.
const u8* check_record(const SpillStore* s, const u8* rec, const LogRead& r) {
  u32 stored_crc, klen, vlen;
  memcpy(&stored_crc, rec, 4);
  memcpy(&klen, rec + 4, 4);
  memcpy(&vlen, rec + 8, 4);
  u8 key[kKeyBytes];
  key_bytes(r.key.gid, r.key.pane, key);
  if (klen != kKeyBytes || (i64)vlen != s->vlen ||
      memcmp(rec + 12, key, kKeyBytes) != 0)
    return nullptr;
  const u8* val = rec + 12 + kKeyBytes;
  u32 crc = crc32(key, kKeyBytes, 0);
  crc = crc32(val, vlen, crc);
  return crc == stored_crc ? val : nullptr;
}

// Read spilled values in log order: runs of records closer than kReadGap
// take one pread each (records still in the write buffer are read there);
// ``emit(read, value)`` receives each checked value.  False on an I/O or
// CRC failure.
template <class Emit>
bool log_read_all(SpillStore* s, std::vector<LogRead>& reads, Emit emit) {
  std::sort(reads.begin(), reads.end(),
            [](const LogRead& a, const LogRead& b) { return a.start < b.start; });
  const i64 rec_len = 12 + kKeyBytes + s->vlen;
  const i64 buffered = s->log_end - (i64)s->wbuf.size();
  std::string run;
  size_t i = 0;
  while (i < reads.size()) {
    const i64 lo = reads[i].start;
    i64 hi = lo + rec_len;
    size_t j = i + 1;
    if (lo < buffered) {        // a run on disk stays below the buffer
      while (j < reads.size() && reads[j].start < buffered &&
             reads[j].start - hi <= kReadGap &&
             reads[j].start + rec_len - lo <= kReadRun) {
        hi = reads[j].start + rec_len;
        j++;
      }
      run.resize((size_t)(hi - lo));
      if (!pread_all(s->fd, (u8*)&run[0], run.size(), lo)) return false;
    }
    for (size_t k = i; k < j; k++) {
      const u8* rec = lo < buffered
          ? (const u8*)run.data() + (reads[k].start - lo)
          : (const u8*)s->wbuf.data() + (reads[k].start - buffered);
      const u8* val = check_record(s, rec, reads[k]);
      if (!val) return false;
      emit(reads[k], val);
    }
    i = j;
  }
  return true;
}

// ---------------------------------------------------------------------------
// eviction, put, delete
// ---------------------------------------------------------------------------

bool maybe_evict(SpillStore* s) {
  while (s->mem_used > s->mem_budget) {
    if (s->evict_cursor >= s->write_order.size()) {
      // Updated keys re-enter residency without re-entering write_order, so
      // one pass is not enough: rebuild the queue from currently-resident
      // keys. Empty rebuild == nothing evictable -> stop.
      s->write_order.clear();
      for (const Slot& t : s->table)
        if (t.used && t.loc >= 0) s->write_order.push_back({t.gid, t.pane});
      s->evict_cursor = 0;
      if (s->write_order.empty()) return true;
    }
    const Key k = s->write_order[s->evict_cursor++];
    i64 i = find(s, k.gid, k.pane);
    if (i < 0 || s->table[i].loc < 0) continue;
    i64 slot = s->table[i].loc;
    i64 off = log_append(s, k.gid, k.pane, slab_at(s, slot));
    if (off < 0) return false;
    s->slab_free.push_back(slot);
    s->mem_used -= s->vlen;
    s->table[i].loc = ~off;
  }
  // the queue's consumed prefix is never read again
  if (s->evict_cursor > ((size_t)1 << 16) &&
      2 * s->evict_cursor > s->write_order.size()) {
    s->write_order.erase(s->write_order.begin(),
                         s->write_order.begin() + (i64)s->evict_cursor);
    s->evict_cursor = 0;
  }
  return true;
}

bool put(SpillStore* s, i64 gid, i64 pane, const u8* val) {
  i64 i = find(s, gid, pane);
  if (i >= 0) {
    if (s->table[i].loc < 0) {      // spilled: the value becomes resident
      s->table[i].loc = slab_alloc(s);
      s->mem_used += s->vlen;
    }
    memcpy(slab_at(s, s->table[i].loc), val, (size_t)s->vlen);
  } else {
    i64 slot = slab_alloc(s);
    memcpy(slab_at(s, slot), val, (size_t)s->vlen);
    insert(s, gid, pane, slot);
    s->write_order.push_back({gid, pane});
    s->mem_used += s->vlen;
  }
  return maybe_evict(s);
}

void erase(SpillStore* s, i64 i) {
  if (s->table[i].loc >= 0) {
    s->slab_free.push_back(s->table[i].loc);
    s->mem_used -= s->vlen;
  }
  remove_slot(s, (u64)i);
}

// one cell's value: u8 flags | i64 count | each leaf's bytes
i64 value_len(int n_leaves, const i64* leaf_bytes) {
  i64 n = 9;
  for (int j = 0; j < n_leaves; j++) n += leaf_bytes[j];
  return n;
}

}  // namespace

// A store whose values are ``value_len`` bytes, keeping ``mem_budget`` bytes
// of them in memory and the rest in ``dir``/spill.log (appended to when it
// exists).  nullptr when the log cannot be opened.
API void* ftt_spill_open(const char* dir, i64 mem_budget, i64 value_len) {
  if (value_len <= 0) return nullptr;
  mkdir(dir, 0755);
  std::string path = std::string(dir) + "/spill.log";
  int fd = open(path.c_str(), O_RDWR | O_CREAT | O_CLOEXEC, 0644);
  if (fd < 0) return nullptr;
  auto* s = new SpillStore();
  s->mem_budget = mem_budget;
  s->vlen = value_len;
  s->fd = fd;
  s->log_end = (i64)lseek(fd, 0, SEEK_END);
  s->table.assign(1024, Slot{0, 0, 0, 0});
  return s;
}

API void ftt_spill_close(void* h) {
  auto* s = (SpillStore*)h;
  if (!s) return;
  write_out(s);
  if (s->fd >= 0) close(s->fd);
  delete s;
}

// Put cells i = 0..n-1 in order: key (gids[i], panes[i]), value flags[i],
// counts[i], then leaf j's ``leaf_bytes[j]`` bytes at ``leaves[j] + i *
// leaf_bytes[j]``.  Returns 0, -2 when the log cannot be written, -3 when
// the layout's length is not the store's.
API i64 ftt_spill_put_cells(void* h, i64 n, const i64* gids, const i64* panes,
                            const u8* flags, const i64* counts, int n_leaves,
                            const u8* const* leaves, const i64* leaf_bytes) {
  auto* s = (SpillStore*)h;
  std::lock_guard<std::mutex> g(s->mu);
  if (value_len(n_leaves, leaf_bytes) != s->vlen) return -3;
  std::vector<u8> val((size_t)s->vlen);
  for (i64 i = 0; i < n; i++) {
    val[0] = flags[i];
    memcpy(&val[1], &counts[i], 8);
    size_t at = 9;
    for (int j = 0; j < n_leaves; j++) {
      memcpy(&val[at], leaves[j] + i * leaf_bytes[j], (size_t)leaf_bytes[j]);
      at += (size_t)leaf_bytes[j];
    }
    if (!put(s, gids[i], panes[i], val.data())) return -2;
  }
  return 0;
}

// Get cells i = 0..n-1 into the same layout as ftt_spill_put_cells; found[i]
// says whether the cell exists (absent cells leave their outputs alone).
// Values in the log are read in log order, nearby records in one pread.
// With ``remove``, every cell found is deleted once all are read.  Returns
// the number found, -2 on a log read or CRC failure, -3 when the layout's
// length is not the store's.
API i64 ftt_spill_get_cells(void* h, i64 n, const i64* gids, const i64* panes,
                            int remove, u8* found, u8* flags, i64* counts,
                            int n_leaves, u8* const* leaves,
                            const i64* leaf_bytes) {
  auto* s = (SpillStore*)h;
  std::lock_guard<std::mutex> g(s->mu);
  if (value_len(n_leaves, leaf_bytes) != s->vlen) return -3;
  auto emit = [&](i64 i, const u8* v) {
    flags[i] = v[0];
    memcpy(&counts[i], v + 1, 8);
    size_t at = 9;
    for (int j = 0; j < n_leaves; j++) {
      memcpy(leaves[j] + i * leaf_bytes[j], v + at, (size_t)leaf_bytes[j]);
      at += (size_t)leaf_bytes[j];
    }
  };
  std::vector<LogRead> reads;
  i64 hits = 0;
  for (i64 i = 0; i < n; i++) {
    i64 t = find(s, gids[i], panes[i]);
    found[i] = t >= 0;
    if (t < 0) continue;
    hits++;
    if (s->table[t].loc >= 0)
      emit(i, slab_at(s, s->table[t].loc));
    else
      reads.push_back({~s->table[t].loc - 12 - kKeyBytes, i,
                       {gids[i], panes[i]}});
  }
  if (!log_read_all(s, reads, [&](const LogRead& r, const u8* v) {
        emit(r.cell, v);
      }))
    return -2;
  if (remove)
    for (i64 i = 0; i < n; i++)
      if (found[i]) {
        i64 t = find(s, gids[i], panes[i]);
        if (t >= 0) erase(s, t);     // a cell listed twice goes once
      }
  return hits;
}

// Delete cells i = 0..n-1 in order; returns how many existed.
API i64 ftt_spill_delete_cells(void* h, i64 n, const i64* gids,
                               const i64* panes) {
  auto* s = (SpillStore*)h;
  std::lock_guard<std::mutex> g(s->mu);
  i64 gone = 0;
  for (i64 i = 0; i < n; i++) {
    i64 t = find(s, gids[i], panes[i]);
    if (t < 0) continue;
    erase(s, t);
    gone++;
  }
  return gone;
}

// Delete every entry (the write order queue and the log stay, as they do
// when each key is deleted).
API void ftt_spill_clear(void* h) {
  auto* s = (SpillStore*)h;
  std::lock_guard<std::mutex> g(s->mu);
  std::fill(s->table.begin(), s->table.end(), Slot{0, 0, 0, 0});
  s->n_used = 0;
  s->slab.clear();
  s->slab_free.clear();
  s->mem_used = 0;
}

API i64 ftt_spill_count(void* h) {
  auto* s = (SpillStore*)h;
  std::lock_guard<std::mutex> g(s->mu);
  return s->n_used;
}

API i64 ftt_spill_mem_used(void* h) { return ((SpillStore*)h)->mem_used; }
API i64 ftt_spill_log_bytes(void* h) { return ((SpillStore*)h)->log_end; }

// ---------------------------------------------------------------------------
// the key-value store: byte keys, byte values of any length
// ---------------------------------------------------------------------------

namespace {

struct KvEntry {
  std::string val;   // when resident
  bool in_mem;
  i64 off;           // log offset of the record's value (when spilled)
  u32 len;           // value length
};

struct KvStore {
  std::string dir;
  i64 mem_budget = 0;
  i64 mem_used = 0;       // resident value bytes
  i64 log_end = 0;        // append position
  i64 log_garbage = 0;    // dead value bytes in the log
  int fd = -1;
  std::string wbuf;       // the log's bytes [log_end - wbuf.size(), log_end)
  std::unordered_map<std::string, KvEntry> map;
  std::mutex mu;
  // keys in first-write order; [evict_cursor, size) not yet reached
  std::vector<std::string> write_order;
  size_t evict_cursor = 0;

  std::string log_path() const { return dir + "/spill.log"; }
  std::string manifest_path() const { return dir + "/manifest.fsp"; }
};

bool kv_write_out(KvStore* s) {
  i64 at = s->log_end - (i64)s->wbuf.size();
  size_t done = 0;
  while (done < s->wbuf.size()) {
    ssize_t w = pwrite(s->fd, s->wbuf.data() + done, s->wbuf.size() - done,
                       (off_t)(at + (i64)done));
    if (w < 0 && errno == EINTR) continue;
    if (w <= 0) return false;
    done += (size_t)w;
  }
  s->wbuf.clear();
  return true;
}

// Append a record; its value's offset goes to *val_off.
bool kv_log_append(KvStore* s, const std::string& key, const std::string& val,
                   i64* val_off) {
  u32 klen = (u32)key.size(), vlen = (u32)val.size();
  u32 crc = crc32((const u8*)key.data(), klen, 0);
  crc = crc32((const u8*)val.data(), vlen, crc);
  s->wbuf.append((const char*)&crc, 4);
  s->wbuf.append((const char*)&klen, 4);
  s->wbuf.append((const char*)&vlen, 4);
  s->wbuf.append(key);
  s->wbuf.append(val);
  *val_off = s->log_end + 12 + klen;
  s->log_end += 12 + klen + vlen;
  return s->wbuf.size() < kWriteChunk || kv_write_out(s);
}

// Read a spilled value and check its record's CRC (the CRC sits at off - 12
// - klen and covers the key bytes then the value bytes).
bool kv_log_read(KvStore* s, i64 off, u32 len, const std::string& key,
                 std::string* out) {
  const i64 rec_start = off - 12 - (i64)key.size();
  if (rec_start < 0) return false;
  std::string rec((size_t)(off + len - rec_start), '\0');
  const i64 buffered = s->log_end - (i64)s->wbuf.size();
  if (rec_start >= buffered) {
    memcpy(&rec[0], s->wbuf.data() + (rec_start - buffered), rec.size());
  } else {
    if (!kv_write_out(s)) return false;
    if (!pread_all(s->fd, (u8*)&rec[0], rec.size(), rec_start)) return false;
  }
  u32 stored_crc;
  memcpy(&stored_crc, rec.data(), 4);
  out->assign(rec, 12 + key.size(), len);
  u32 crc = crc32((const u8*)key.data(), (i64)key.size(), 0);
  crc = crc32((const u8*)out->data(), len, crc);
  return crc == stored_crc;
}

void kv_maybe_evict(KvStore* s) {
  while (s->mem_used > s->mem_budget) {
    if (s->evict_cursor >= s->write_order.size()) {
      // updated keys re-enter residency without re-entering the queue, so
      // one pass is not enough: rebuild it from the resident keys (none:
      // nothing is evictable)
      s->write_order.clear();
      for (auto& kv : s->map)
        if (kv.second.in_mem) s->write_order.push_back(kv.first);
      s->evict_cursor = 0;
      if (s->write_order.empty()) return;
    }
    const std::string& k = s->write_order[s->evict_cursor++];
    auto it = s->map.find(k);
    if (it == s->map.end() || !it->second.in_mem) continue;
    i64 off;
    if (!kv_log_append(s, k, it->second.val, &off)) return;
    s->mem_used -= (i64)it->second.val.size();
    it->second.in_mem = false;
    it->second.off = off;
    it->second.len = (u32)it->second.val.size();
    it->second.val.clear();
    it->second.val.shrink_to_fit();
  }
  // the queue's consumed prefix is never read again
  if (s->evict_cursor > ((size_t)1 << 16) &&
      2 * s->evict_cursor > s->write_order.size()) {
    s->write_order.erase(s->write_order.begin(),
                         s->write_order.begin() + (i64)s->evict_cursor);
    s->evict_cursor = 0;
  }
}

// Write the manifest (resident values inline, spilled ones as (off, len)
// into the log) to a temporary file, fsync it and rename it into place,
// after the log itself is written out and fsynced.  Holds s->mu.
int kv_flush_locked(KvStore* s) {
  if (!kv_write_out(s)) return -1;
  fsync(s->fd);
  std::string tmp = s->manifest_path() + ".tmp";
  FILE* mf = fopen(tmp.c_str(), "wb");
  if (!mf) return -1;
  u64 n = s->map.size();
  fwrite("FSP1", 1, 4, mf);
  fwrite(&n, 8, 1, mf);
  for (auto& kv : s->map) {
    u32 klen = (u32)kv.first.size();
    u8 flag = kv.second.in_mem ? 1 : 0;
    fwrite(&klen, 4, 1, mf);
    fwrite(&flag, 1, 1, mf);
    fwrite(kv.first.data(), 1, klen, mf);
    if (flag) {
      u32 vlen = (u32)kv.second.val.size();
      fwrite(&vlen, 4, 1, mf);
      fwrite(kv.second.val.data(), 1, vlen, mf);
    } else {
      fwrite(&kv.second.off, 8, 1, mf);
      fwrite(&kv.second.len, 4, 1, mf);
    }
  }
  fflush(mf);
  fsync(fileno(mf));
  fclose(mf);
  return rename(tmp.c_str(), s->manifest_path().c_str());
}

// Load the manifest of ``s->dir`` when there is one (reopen after flush).
void kv_load_manifest(KvStore* s) {
  FILE* mf = fopen(s->manifest_path().c_str(), "rb");
  if (!mf) return;
  char magic[4];
  u64 n = 0;
  if (fread(magic, 1, 4, mf) == 4 && memcmp(magic, "FSP1", 4) == 0 &&
      fread(&n, 8, 1, mf) == 1) {
    for (u64 i = 0; i < n; i++) {
      u32 klen;
      u8 flag;
      if (fread(&klen, 4, 1, mf) != 1 || fread(&flag, 1, 1, mf) != 1) break;
      std::string key(klen, '\0');
      if (klen && fread(&key[0], 1, klen, mf) != klen) break;
      KvEntry e;
      if (flag) {   // resident in the manifest
        u32 vlen;
        if (fread(&vlen, 4, 1, mf) != 1) break;
        e.val.resize(vlen);
        if (vlen && fread(&e.val[0], 1, vlen, mf) != vlen) break;
        e.in_mem = true;
        e.off = 0;
        e.len = vlen;
        s->mem_used += vlen;
      } else {
        i64 off;
        u32 vlen;
        if (fread(&off, 8, 1, mf) != 1 || fread(&vlen, 4, 1, mf) != 1) break;
        e.in_mem = false;
        e.off = off;
        e.len = vlen;
      }
      s->write_order.push_back(key);
      s->map.emplace(std::move(key), std::move(e));
    }
  }
  fclose(mf);
}

// the iteration cursor: the keys at ``ftt_spill_kv_iter_begin``
struct KvIter {
  std::vector<std::string> keys;
  size_t pos = 0;
};

}  // namespace

// A key-value store keeping ``mem_budget`` value bytes in memory and the rest
// in ``dir``/spill.log; the entries of ``dir``/manifest.fsp are loaded first
// when it exists.  nullptr when the log cannot be opened.
API void* ftt_spill_kv_open(const char* dir, i64 mem_budget) {
  mkdir(dir, 0755);
  auto* s = new KvStore();
  s->dir = dir;
  s->mem_budget = mem_budget;
  kv_load_manifest(s);
  s->fd = open(s->log_path().c_str(), O_RDWR | O_CREAT | O_CLOEXEC, 0644);
  if (s->fd < 0) {
    delete s;
    return nullptr;
  }
  s->log_end = (i64)lseek(s->fd, 0, SEEK_END);
  return s;
}

API void ftt_spill_kv_close(void* h) {
  auto* s = (KvStore*)h;
  if (!s) return;
  kv_write_out(s);
  if (s->fd >= 0) close(s->fd);
  delete s;
}

API int ftt_spill_kv_put(void* h, const u8* key, i64 klen, const u8* val,
                         i64 vlen) {
  auto* s = (KvStore*)h;
  std::lock_guard<std::mutex> g(s->mu);
  std::string k((const char*)key, (size_t)klen);
  auto it = s->map.find(k);
  if (it != s->map.end()) {
    if (it->second.in_mem)
      s->mem_used -= (i64)it->second.val.size();
    else
      s->log_garbage += it->second.len;
    it->second.val.assign((const char*)val, (size_t)vlen);
    it->second.in_mem = true;
    it->second.len = (u32)vlen;
  } else {
    KvEntry e;
    e.val.assign((const char*)val, (size_t)vlen);
    e.in_mem = true;
    e.off = 0;
    e.len = (u32)vlen;
    s->map.emplace(k, std::move(e));
    s->write_order.push_back(k);
  }
  s->mem_used += vlen;
  kv_maybe_evict(s);
  return 0;
}

// The value's length (copied into ``out`` when ``cap`` holds it), -1 when the
// key is absent, -2 on a log read or CRC failure.  ``cap`` 0 asks the length.
API i64 ftt_spill_kv_get(void* h, const u8* key, i64 klen, u8* out, i64 cap) {
  auto* s = (KvStore*)h;
  std::lock_guard<std::mutex> g(s->mu);
  std::string k((const char*)key, (size_t)klen);
  auto it = s->map.find(k);
  if (it == s->map.end()) return -1;
  if (it->second.in_mem) {
    i64 n = (i64)it->second.val.size();
    if (out && cap >= n) memcpy(out, it->second.val.data(), (size_t)n);
    return n;
  }
  if (out == nullptr || cap < (i64)it->second.len) return it->second.len;
  std::string v;
  if (!kv_log_read(s, it->second.off, it->second.len, k, &v)) return -2;
  memcpy(out, v.data(), v.size());
  return (i64)v.size();
}

// 1 when the key existed, else 0.
API int ftt_spill_kv_delete(void* h, const u8* key, i64 klen) {
  auto* s = (KvStore*)h;
  std::lock_guard<std::mutex> g(s->mu);
  auto it = s->map.find(std::string((const char*)key, (size_t)klen));
  if (it == s->map.end()) return 0;
  if (it->second.in_mem)
    s->mem_used -= (i64)it->second.val.size();
  else
    s->log_garbage += it->second.len;
  s->map.erase(it);
  return 1;
}

API i64 ftt_spill_kv_count(void* h) {
  auto* s = (KvStore*)h;
  std::lock_guard<std::mutex> g(s->mu);
  return (i64)s->map.size();
}

API i64 ftt_spill_kv_mem_used(void* h) { return ((KvStore*)h)->mem_used; }
API i64 ftt_spill_kv_log_bytes(void* h) { return ((KvStore*)h)->log_end; }
API i64 ftt_spill_kv_log_garbage(void* h) {
  return ((KvStore*)h)->log_garbage;
}

// The keys present now, walked by ftt_spill_kv_iter_next.
API void* ftt_spill_kv_iter_begin(void* h) {
  auto* s = (KvStore*)h;
  std::lock_guard<std::mutex> g(s->mu);
  auto* it = new KvIter();
  it->keys.reserve(s->map.size());
  for (auto& kv : s->map) it->keys.push_back(kv.first);
  return it;
}

// The next key's length (copied into ``key_out`` when ``cap`` holds it, and
// only then does the cursor move), or -1 past the last key.
API i64 ftt_spill_kv_iter_next(void* hi, u8* key_out, i64 cap) {
  auto* it = (KvIter*)hi;
  if (it->pos >= it->keys.size()) return -1;
  const std::string& k = it->keys[it->pos];
  if ((i64)k.size() > cap) return (i64)k.size();
  memcpy(key_out, k.data(), k.size());
  it->pos++;
  return (i64)k.size();
}

API void ftt_spill_kv_iter_end(void* hi) { delete (KvIter*)hi; }

// Make the store durable: the log fsynced, then the manifest written beside
// it.  0, or -1 when a file cannot be written.
API int ftt_spill_kv_flush(void* h) {
  auto* s = (KvStore*)h;
  std::lock_guard<std::mutex> g(s->mu);
  return kv_flush_locked(s);
}

// Rewrite the log with only the live spilled values (the RocksDB compaction
// analog).  Returns the bytes reclaimed, or -1 (the old log and its offsets
// stay) when the new log cannot be written.
API i64 ftt_spill_kv_compact(void* h) {
  auto* s = (KvStore*)h;
  std::lock_guard<std::mutex> g(s->mu);
  if (!kv_write_out(s)) return -1;
  std::string tmp = s->log_path() + ".tmp";
  int nfd = open(tmp.c_str(), O_RDWR | O_CREAT | O_TRUNC | O_CLOEXEC, 0644);
  if (nfd < 0) return -1;
  const i64 old_end = s->log_end;
  std::string out;
  bool ok = true;
  // the new offsets are committed only once the new log is in place
  std::vector<std::pair<KvEntry*, i64>> new_offs;
  for (auto& kv : s->map) {
    if (kv.second.in_mem) continue;
    std::string v;
    if (!kv_log_read(s, kv.second.off, kv.second.len, kv.first, &v)) {
      ok = false;
      break;
    }
    u32 klen = (u32)kv.first.size(), vlen = (u32)v.size();
    u32 crc = crc32((const u8*)kv.first.data(), klen, 0);
    crc = crc32((const u8*)v.data(), vlen, crc);
    out.append((const char*)&crc, 4);
    out.append((const char*)&klen, 4);
    out.append((const char*)&vlen, 4);
    out.append(kv.first);
    new_offs.emplace_back(&kv.second, (i64)out.size());
    out.append(v);
  }
  for (size_t done = 0; ok && done < out.size();) {
    ssize_t w = pwrite(nfd, out.data() + done, out.size() - done,
                       (off_t)done);
    if (w < 0 && errno == EINTR) continue;
    if (w <= 0) ok = false;
    else done += (size_t)w;
  }
  if (!ok || rename(tmp.c_str(), s->log_path().c_str()) != 0) {
    close(nfd);
    remove(tmp.c_str());
    return -1;
  }
  close(s->fd);
  s->fd = nfd;
  for (auto& [entry, off] : new_offs) entry->off = off;
  s->log_end = (i64)out.size();
  s->log_garbage = 0;
  // eviction restarts over the resident keys
  s->write_order.clear();
  for (auto& kv : s->map)
    if (kv.second.in_mem) s->write_order.push_back(kv.first);
  s->evict_cursor = 0;
  // a manifest on disk points at the old offsets: rewrite it, or a reopen
  // would read the wrong bytes of the new log
  if (access(s->manifest_path().c_str(), F_OK) == 0) kv_flush_locked(s);
  return old_end - s->log_end;
}
