// The hash and the open-addressing walk of the device key probe, shared by
// probe.cu and probe_fold.cu.  Same arithmetic as
// flink_tpu/state/device_keyindex.py `lax_probe`: start at
// _mix64(key) & (cap - 1), step linearly with (idx + 1) & (cap - 1); a bucket
// whose slot1 is 0 is empty (miss, -1); a bucket whose lo/hi words equal the
// key is a hit (slot1 - 1).
//
// The table is one interleaved int32 array of `cap` bucket rows
// (lo, hi, slot1, 0): one 16-byte read-only load (__ldg of an int4) brings a
// whole bucket into registers, and a 32-byte sector holds two neighbouring
// buckets, so a linear walk's next step is usually in the sector already
// read.  The table does not change during a launch.  The walk is bounded at
// `cap` buckets, so even a full table cannot hang a kernel; at load <= 0.5
// the bound never binds.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// splitmix64 finalizer: flink_tpu_torch/state/keyindex.py `_mix64`, in the
// same uint64 arithmetic as the host's numpy.
__device__ __forceinline__ uint64_t flink_mix64(uint64_t x) {
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ull;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBull;
  return x ^ (x >> 31);
}

// The bucket a key's walk starts at; `cap` is a power of two below 2^31.
__device__ __forceinline__ uint32_t flink_probe_start(int64_t key, int cap) {
  return static_cast<uint32_t>(flink_mix64(static_cast<uint64_t>(key))) &
         (static_cast<uint32_t>(cap) - 1u);
}

// Walk on from bucket `idx`, whose row `b` the caller has already loaded (so
// a caller can issue several first loads before it waits on any).  Returns
// the key's slot, or -1.
__device__ __forceinline__ int32_t flink_probe_walk_from(
    const int4* __restrict__ buckets, int64_t key, uint32_t idx, int4 b,
    int cap) {
  const uint32_t mask = static_cast<uint32_t>(cap) - 1u;
  const uint64_t u = static_cast<uint64_t>(key);
  const int32_t klo = static_cast<int32_t>(static_cast<uint32_t>(u));
  const int32_t khi = static_cast<int32_t>(static_cast<uint32_t>(u >> 32));
  for (int step = 1;; ++step) {
    if (b.z == 0) return -1;  // empty bucket: the key is not in the table
    if (b.x == klo && b.y == khi) return b.z - 1;
    if (step >= cap) return -1;
    idx = (idx + 1u) & mask;
    b = __ldg(buckets + idx);
  }
}

__device__ __forceinline__ int32_t flink_probe_walk(
    const int4* __restrict__ buckets, int64_t key, int cap) {
  const uint32_t idx = flink_probe_start(key, cap);
  return flink_probe_walk_from(buckets, key, idx, __ldg(buckets + idx), cap);
}
