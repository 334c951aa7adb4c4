// Device key probe for Hopper (sm_90a): open-addressing lookup of int64 keys
// in an int64 -> int32 hash table held as three int32 planes.
//
// Replaces: flink_tpu/state/device_keyindex.py:139 `pallas_probe` (and its
// portable twin `lax_probe`, :77).  The walk itself is `flink_probe_walk`
// (probe_walk.cuh, shared with probe_fold.cu): start at
// start[i] = _mix64(key) & (cap - 1), step linearly; an empty bucket is a
// miss (-1), a matching bucket a hit (slot1 - 1).
//
// What bounds it on this card: memory, not arithmetic.  Each record streams
// 12 B in (key_lo, key_hi, start) and 4 B out, and reads one 32-byte sector
// of each of the three table planes per probe step (about 1.5 steps per
// record at the table's load factor of at most 0.5).  Those table reads are
// random.  The Pallas kernel pinned the whole table in VMEM; here the table
// (3 x 4 B x cap: 24 MiB at cap 2^21) fits in the H100's 50 MB L2, so the
// design leans on L2 residency: read-only loads through the non-coherent
// path (__ldg), the slot plane read first so an empty bucket costs one
// sector, and one thread per record so a warp's streaming loads coalesce.

#include <cuda_runtime.h>
#include <stdint.h>

#include "probe_walk.cuh"

namespace {

__global__ void probe_kernel(const int32_t* __restrict__ tab_lo,
                             const int32_t* __restrict__ tab_hi,
                             const int32_t* __restrict__ tab_slot1,
                             const int32_t* __restrict__ key_lo,
                             const int32_t* __restrict__ key_hi,
                             const int32_t* __restrict__ start,
                             int32_t* __restrict__ out, int n, int cap) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  out[i] = flink_probe_walk(tab_lo, tab_hi, tab_slot1, key_lo[i], key_hi[i],
                            start[i], cap);
}

}  // namespace

// Launches the probe on `stream` (a cudaStream_t).  `cap` is a power of two.
// Returns cudaGetLastError() after the launch: nonzero means the launch was
// refused or an earlier asynchronous fault surfaced.
extern "C" int flink_probe_launch(const void* tab_lo, const void* tab_hi,
                                  const void* tab_slot1, const void* key_lo,
                                  const void* key_hi, const void* start,
                                  void* out, int n, int cap, void* stream) {
  if (n > 0) {
    const int threads = 256;
    const int blocks = (n + threads - 1) / threads;
    probe_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(tab_lo), static_cast<const int32_t*>(tab_hi),
        static_cast<const int32_t*>(tab_slot1),
        static_cast<const int32_t*>(key_lo), static_cast<const int32_t*>(key_hi),
        static_cast<const int32_t*>(start), static_cast<int32_t*>(out), n, cap);
  }
  return static_cast<int>(cudaGetLastError());
}
