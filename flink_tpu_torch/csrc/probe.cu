// Device key probe for Hopper (sm_90a): open-addressing lookup of int64 keys
// in an int64 -> int32 hash table held as one interleaved bucket array.
//
// Replaces: flink_tpu/state/device_keyindex.py:139 `pallas_probe` (and its
// portable twin `lax_probe`, :77).  The hash and the walk are
// `flink_probe_walk` (probe_walk.cuh, shared with probe_fold.cu): the kernel
// hashes each int64 key itself, start = _mix64(key) & (cap - 1), steps
// linearly; an empty bucket is a miss (-1), a matching bucket a hit
// (slot1 - 1).
//
// What bounds it on this card: memory, not arithmetic.  Each record streams
// 8 B in (the key) and 4 B out (the slot); the walk reads random buckets of
// the table (16 B per bucket, 32 MiB at cap 2^21, which the H100's 50 MB L2
// holds), about 1.5 buckets a record at the table's load factor of at most
// 0.5.  The design spends one 32-byte sector per step, not three: a bucket
// row (lo, hi, slot1, 0) is one 16-byte __ldg, and a neighbouring bucket is
// usually in the same sector.  Hashing on the card costs ~10 integer
// operations a record and takes the host's hash pass, and a 4-byte start
// plane, off the path.  One thread per record, so a warp's key loads and
// slot stores coalesce and many walks are in flight to hide the random
// reads' latency.

#include <cuda_runtime.h>
#include <stdint.h>

#include "probe_walk.cuh"

namespace {

__global__ void probe_kernel(const int4* __restrict__ buckets,
                             const int64_t* __restrict__ keys,
                             int32_t* __restrict__ out, int n, int cap) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  out[i] = flink_probe_walk(buckets, keys[i], cap);
}

}  // namespace

// Launches the probe on `stream` (a cudaStream_t): `buckets` is int32
// [cap, 4], 16-byte aligned, `cap` a power of two; `keys` int64 [n]; `out`
// int32 [n].  Returns cudaGetLastError() after the launch: nonzero means the
// launch was refused or an earlier asynchronous fault surfaced.
extern "C" int flink_probe_launch(const void* buckets, const void* keys,
                                  void* out, int n, int cap, void* stream) {
  if (n > 0) {
    const int threads = 256;
    const int blocks = (n + threads - 1) / threads;
    probe_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int4*>(buckets), static_cast<const int64_t*>(keys),
        static_cast<int32_t*>(out), n, cap);
  }
  return static_cast<int>(cudaGetLastError());
}
