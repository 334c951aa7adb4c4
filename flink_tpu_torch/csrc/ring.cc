// flink_tpu_torch single-producer single-consumer byte ring (C ABI, loaded
// via ctypes).
//
// The host infeed ring of the JAX package's native layer
// (native/flink_native.cc, its SPSC ring buffer), every symbol with the
// ``ftt_`` prefix: length-prefixed messages (a 4-byte length, then the
// bytes) in a circular buffer of fixed capacity.  The producer owns
// ``head``, the consumer ``tail``; each publishes its position with a
// release store and reads the other's with an acquire load, so one pushing
// thread and one popping thread need no lock.  A push that does not fit is
// refused (returns 0), never dropped: that refusal is the backpressure.
//
// Built with g++ by flink_tpu_torch/kernels/build.py (ring_lib()); used by
// flink_tpu_torch/native (RingBuffer).

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <vector>

#define API extern "C" __attribute__((visibility("default")))

typedef int64_t i64;
typedef uint64_t u64;
typedef uint32_t u32;
typedef uint8_t u8;

namespace {
struct Ring {
  std::vector<u8> buf;
  std::atomic<u64> head{0};  // producer position (bytes written)
  std::atomic<u64> tail{0};  // consumer position (bytes read)
  u64 cap;
};

void copy_in(Ring* r, u64 pos, const u8* src, u64 n) {
  u64 off = pos % r->cap;
  u64 first = std::min(n, r->cap - off);
  memcpy(r->buf.data() + off, src, first);
  if (n > first) memcpy(r->buf.data(), src + first, n - first);
}

void copy_out(Ring* r, u64 pos, u8* dst, u64 n) {
  u64 off = pos % r->cap;
  u64 first = std::min(n, r->cap - off);
  memcpy(dst, r->buf.data() + off, first);
  if (n > first) memcpy(dst + first, r->buf.data(), n - first);
}
}  // namespace

API void* ftt_ring_create(i64 capacity) {
  auto* r = new Ring();
  r->cap = (u64)capacity;
  r->buf.resize(r->cap);
  return r;
}

// Bytes free for messages and their 4-byte length prefixes.
API i64 ftt_ring_free_space(void* h) {
  auto* r = (Ring*)h;
  return (i64)(r->cap - (r->head.load(std::memory_order_acquire) -
                         r->tail.load(std::memory_order_acquire)));
}

// Push one length-prefixed message.  Returns 1 on success, 0 if no room.
API int ftt_ring_push(void* h, const u8* data, i64 n) {
  auto* r = (Ring*)h;
  u64 need = (u64)n + 4;
  u64 head = r->head.load(std::memory_order_relaxed);
  u64 tail = r->tail.load(std::memory_order_acquire);
  if (r->cap - (head - tail) < need) return 0;
  u32 len = (u32)n;
  copy_in(r, head, (const u8*)&len, 4);
  copy_in(r, head + 4, data, (u64)n);
  r->head.store(head + need, std::memory_order_release);
  return 1;
}

// Pop one message into out (cap bytes).  Returns the message's length, -1 if
// the ring is empty, or the length needed if cap is too small (the message
// stays in place).
API i64 ftt_ring_pop(void* h, u8* out, i64 cap) {
  auto* r = (Ring*)h;
  u64 tail = r->tail.load(std::memory_order_relaxed);
  u64 head = r->head.load(std::memory_order_acquire);
  if (head == tail) return -1;
  u32 len;
  copy_out(r, tail, (u8*)&len, 4);
  if ((i64)len > cap) return (i64)len;
  copy_out(r, tail + 4, out, len);
  r->tail.store(tail + 4 + len, std::memory_order_release);
  return (i64)len;
}

API void ftt_ring_destroy(void* h) { delete (Ring*)h; }
