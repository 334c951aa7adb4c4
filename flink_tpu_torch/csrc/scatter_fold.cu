// Ordered fold of a batch into the device replica for Hopper (sm_90a).
//
// Replaces: the `index_add_` fold that flink_tpu_torch/ops/scatter.py
// `scatter_fold_counts` runs on the card, which adds floats with atomics in
// no fixed order.  Its TPU counterpart is no Pallas kernel: XLA's scatter in
// flink_tpu/ops/scatter.py `scatter_fold_counts` (the update step
// `_update_step`, window_agg.py), which adds in row order.  For every row
// i < n whose host-computed flat id f = ids[i] lies in [0, n_cells):
// dsum[f] += vals[i] in the replica's own type, and, when dcnt is given,
// dcnt[f] += 1; rows with any other id (the dropped id n_cells, padding)
// fold nothing.
//
// Determinism: each cell's rows are added in row order by one thread, so
// dsum is bit-equal to a sequential `state[f] += v` in the leaf's type (XLA's
// and PyTorch's CPU scatters).  A device-tier fire reads the replica
// directly, so its values no longer change from run to run.
//
// Four steps on one stream.  Step 1 is this file's: one thread per row
// (kHistRows rows a thread, striped over the block so loads and stores
// coalesce) reads the id, writes the row's int32 cell id or -1, and counts
// the block's folding rows per tile of 2^tile_bits cells in shared memory.
// Steps 2-4 are probe_fold.cu's offsets, stable partition by tile and
// per-tile ordered fold, shared through ordered_fold.cuh.
//
// What bounds it on this card: memory.  Rows stream in (id 4 or 8 B, value
// 4 or 8 B); each touched cell of dsum and dcnt is read and written once, a
// random sector each in the [K, P] layout.  The partition adds a pass of
// 4 + 4 + 8 B a row for 4-byte values.  At the main path's 2^18 rows a batch
// the whole fold moves a few MB, so its five launches' fixed costs are a
// large share of its time.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ordered_fold.cuh"

namespace {

// Step 1.  Block 0 also zeroes step 2's ticket.  Ids stream once, so they
// are loaded with the evict-first hint.
template <typename I>
__global__ void __launch_bounds__(kHistThreads) ids_hist_kernel(
    const I* __restrict__ ids, int32_t* __restrict__ cell_out,
    int32_t* __restrict__ counts, int32_t* __restrict__ ticket, int n,
    int n_cells, int tile_bits, int tiles) {
  __shared__ int hist[kMaxTiles];
  if (blockIdx.x == 0 && threadIdx.x == 0) *ticket = 0;
  for (int t = threadIdx.x; t < tiles; t += kHistThreads) hist[t] = 0;
  const int base = blockIdx.x * kBlockRows + threadIdx.x;
  int64_t id[kHistRows];
#pragma unroll
  for (int k = 0; k < kHistRows; ++k) {
    const int i = base + k * kHistThreads;
    id[k] = i < n ? static_cast<int64_t>(__ldcs(ids + i)) : -1;
  }
  __syncthreads();  // hist is zeroed
#pragma unroll
  for (int k = 0; k < kHistRows; ++k) {
    const int i = base + k * kHistThreads;
    if (i >= n) continue;
    int32_t c = -1;
    if (id[k] >= 0 && id[k] < n_cells) {
      c = static_cast<int32_t>(id[k]);
      atomicAdd(&hist[c >> tile_bits], 1);
    }
    cell_out[i] = c;
  }
  __syncthreads();
  int32_t* row = counts + static_cast<int64_t>(blockIdx.x) * tiles;
  for (int t = threadIdx.x; t < tiles; t += kHistThreads) row[t] = hist[t];
}

}  // namespace

// Runs the steps named by the `steps` mask (1 ids + histogram, 2 offsets,
// 4 partition, 8 fold; the wrapper passes 15) on `stream`.
//   ids: [n] int32 (ids64 = 0) or int64 (ids64 = 1); vals: [n] of dsum's
//   type; dsum: [n_cells]; dcnt: int32 [n_cells], or null to fold no counts.
//   Scratch, from the wrapper: cell int32 [n], counts int32 [blocks * tiles],
//   tile_base int32 [tiles + 2], part [n] rows of 8 bytes (4-byte values)
//   or 16 (8-byte values), 16-byte aligned.  blocks = ceil(n / 4096) and
//   tiles = ceil(n_cells / 2^tile_bits) <= 1024, as `fold_plan` computes
//   them.  `kind` names the value and plane type: 0 f32, 1 f64, 2 i32,
//   3 i64.
// Returns cudaGetLastError() after the launches, or cudaErrorInvalidValue
// for arguments the kernels do not take.
extern "C" int flink_scatter_fold_launch(
    const void* ids, const void* vals, void* dsum, void* dcnt, void* cell,
    void* counts, void* tile_base, void* part, int n, int ids64, int n_cells,
    int tile_bits, int kind, int steps, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kind < 0 || kind > 3 || tile_bits < 0 || tile_bits > 30 || n < 0 ||
      n_cells < 0 || (ids64 != 0 && ids64 != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int tiles = static_cast<int>(
      (static_cast<int64_t>(n_cells) + (int64_t{1} << tile_bits) - 1) >>
      tile_bits);
  if (tiles > kMaxTiles) return static_cast<int>(cudaErrorInvalidValue);
  int key_bits = 0;  // bits of the partition's keys [0, tiles]
  while ((1 << key_bits) <= tiles) ++key_bits;
  const int nblk = (n + kBlockRows - 1) / kBlockRows;
  int32_t* ticket = static_cast<int32_t*>(tile_base) + tiles + 1;
  int32_t* dcnt32 = static_cast<int32_t*>(dcnt);
  if (nblk > 0 && (steps & 1)) {
    if (ids64) {
      ids_hist_kernel<int64_t><<<nblk, kHistThreads, 0, s>>>(
          static_cast<const int64_t*>(ids), static_cast<int32_t*>(cell),
          static_cast<int32_t*>(counts), ticket, n, n_cells, tile_bits,
          tiles);
    } else {
      ids_hist_kernel<int32_t><<<nblk, kHistThreads, 0, s>>>(
          static_cast<const int32_t*>(ids), static_cast<int32_t*>(cell),
          static_cast<int32_t*>(counts), ticket, n, n_cells, tile_bits,
          tiles);
    }
  }
  if (nblk > 0 && tiles > 0) {
    if (steps & 2) {
      tile_scan_kernel<<<(tiles + 31) / 32, kScanThreads, 0, s>>>(
          static_cast<int32_t*>(counts), static_cast<int32_t*>(tile_base),
          ticket, nblk, tiles);
    }
    if (steps & 4) {
      switch (kind) {
        case 0: launch_scatter<float>(cell, vals, counts, tile_base, part, n, nblk, tile_bits, tiles, key_bits, s); break;
        case 1: launch_scatter<double>(cell, vals, counts, tile_base, part, n, nblk, tile_bits, tiles, key_bits, s); break;
        case 2: launch_scatter<int32_t>(cell, vals, counts, tile_base, part, n, nblk, tile_bits, tiles, key_bits, s); break;
        default: launch_scatter<int64_t>(cell, vals, counts, tile_base, part, n, nblk, tile_bits, tiles, key_bits, s); break;
      }
    }
    if (steps & 8) {
      switch (kind) {
        case 0: launch_fold<float, float>(part, tile_base, dsum, dcnt32, tiles, tile_bits, s); break;
        case 1: launch_fold<double, double>(part, tile_base, dsum, dcnt32, tiles, tile_bits, s); break;
        case 2: launch_fold<int32_t, int32_t>(part, tile_base, dsum, dcnt32, tiles, tile_bits, s); break;
        default: launch_fold<int64_t, int64_t>(part, tile_base, dsum, dcnt32, tiles, tile_bits, s); break;
      }
    }
  }
  return static_cast<int>(cudaGetLastError());
}
