// The open-addressing walk of the device key probe, shared by probe.cu and
// probe_fold.cu.  Same arithmetic as flink_tpu/state/device_keyindex.py
// `lax_probe`: start at start & (cap - 1), step linearly with
// (idx + 1) & (cap - 1); a bucket whose slot1 plane is 0 is empty (miss, -1);
// a bucket whose lo/hi planes equal the key is a hit (slot1 - 1).
//
// The slot plane is read first, so an empty bucket costs one 32-byte sector;
// loads go through the read-only path (__ldg): the table does not change
// during a launch.  The walk is bounded at `cap` steps, so even a full table
// cannot hang a kernel; at load <= 0.5 the bound never binds.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ int32_t flink_probe_walk(
    const int32_t* __restrict__ tab_lo, const int32_t* __restrict__ tab_hi,
    const int32_t* __restrict__ tab_slot1, int32_t klo, int32_t khi,
    int32_t start, int cap) {
  const uint32_t mask = static_cast<uint32_t>(cap) - 1u;
  uint32_t idx = static_cast<uint32_t>(start) & mask;
  for (int step = 0; step < cap; ++step) {
    const int32_t s1 = __ldg(tab_slot1 + idx);
    if (s1 == 0) return -1;  // empty bucket: the key is not in the table
    if (__ldg(tab_lo + idx) == klo && __ldg(tab_hi + idx) == khi) {
      return s1 - 1;
    }
    idx = (idx + 1u) & mask;
  }
  return -1;
}
