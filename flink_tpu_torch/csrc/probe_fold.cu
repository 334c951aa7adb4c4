// Fused device key probe + ordered delta fold for Hopper (sm_90a).
//
// Replaces: flink_tpu/state/device_keyindex.py:228 `pallas_probe_fold` (its
// portable twin: `lax_probe` + ops/scatter.py `scatter_fold_counts`).  For
// every row i < n it probes the int64 key as probe.cu does (the hash and the
// walk of probe_walk.cuh); every hit row i < b folds into the flat delta
// planes at cell f = slot * pane_mod + pane_slots[i]: dsum[f] += vals[i]
// (widened to dsum's type), dcnt[f] += 1, in place.  Misses, rows past b and
// cells outside [0, n_cells) fold nothing.
//
// Determinism: each cell's rows are added in row order by one thread, so
// dsum is bit-equal to a sequential fold (the Pallas kernel's fori_loop,
// XLA's and PyTorch's CPU scatters).  No atomicAdd touches dsum.  Order
// matters only within a cell, so the rows are never put in one global order:
// the cells are cut into at most kMaxTiles tiles of 2^tile_bits cells, and
// the rows are partitioned by tile, stably, then folded tile by tile.  Four
// steps on one stream: step 1 is this file's, steps 2-4 (with their
// constants and launchers) live in ordered_fold.cuh:
//   1. probe_hist_kernel: one thread per row (kHistRows rows a thread,
//      their keys, pane slots and first buckets loaded before any is waited
//      on) writes slot[i] and the row's int32 cell id, or -1 for a row that
//      folds nothing; each block of kBlockRows rows counts its folding rows
//      per tile in shared memory and writes its row of the [blocks, tiles]
//      count matrix;
//   2. tile_scan_kernel: per tile, an exclusive scan of the counts over the
//      blocks in block order (each (block, tile) gets its offset within the
//      tile); its last block scans the tiles' totals (each tile's base);
//   3. scatter_kernel: each block sorts its rows' tiles with
//      cub::BlockRadixSort (stable, so one tile's rows stay in row order),
//      and writes each folding row once, as (cell's low bits, value), to
//      base[tile] + offset[block, tile] + its rank in the tile;
//   4. fold_kernel: one block per tile walks the tile's rows in chunks of
//      kChunk, sorts each chunk stably by the cell's low bits in shared
//      memory, finds the runs of one cell with a block scan, and the head of
//      each run reads dsum[f] (all of a thread's heads at once), adds the
//      run's values in order, writes dsum[f] once, and adds the run's length
//      to dcnt[f] with one integer atomicAdd (no atomic touches dsum; a
//      count's sum is the same in any order).  A tile's
//      chunks are folded in order by its one block, with __syncthreads()
//      between them, so a cell split across chunks is still added in row
//      order.
// A hot key is a long run in one tile and is folded by one thread, in
// order: a cell with r rows costs a chain of r dependent adds, and its
// tile's r / kChunk chunks are sorted one after another.  The fold's reads
// and writes of dsum and dcnt take most of its time: at the main path's
// [K, P] delta layout each touched cell costs a random sector of each plane,
// read and written.
//
// What bounds it on this card: memory.  Rows stream in (key, pane slot,
// value: 16 B for f32 values) and out (slot: 4 B); the probe reads random
// 16-byte buckets of the table (32 MiB at cap 2^21, which L2 holds); the
// fold reads and writes random dsum and dcnt cells (128 + 64 MiB at the main
// path's 2^20 x 16 delta ring, beyond L2: a sector of each per touched
// cell, in ascending cell order within a tile).  The partition adds a pass
// of 4 + 4 + 8 B a row for f32 values (cell id out and in, value in,
// (low bits, value) out and in); the count matrix is 4 B x blocks x tiles
// (2 MiB at 2M rows).

#include <cuda_runtime.h>
#include <stdint.h>

#include "ordered_fold.cuh"
#include "probe_walk.cuh"

namespace {

// Step 1.  Rows are striped over the block's threads (row base + k *
// kHistThreads + tid), so each of a warp's loads and stores coalesces; a
// thread's keys and pane slots, then its first buckets, are loaded before it
// waits on any of them.  Keys, pane slots and slots stream once, so they
// are loaded and stored with the evict-first hint (__ldcs/__stcs) and leave
// L2 to the table.  Block 0 also zeroes step 2's ticket.
__global__ void __launch_bounds__(kHistThreads) probe_hist_kernel(
    const int4* __restrict__ buckets, const int64_t* __restrict__ keys,
    const int32_t* __restrict__ pane_slots, int32_t* __restrict__ slot_out,
    int32_t* __restrict__ cell_out, int32_t* __restrict__ counts,
    int32_t* __restrict__ ticket, int n, int b, int cap, int64_t pane_mod,
    int n_cells, int tile_bits, int tiles) {
  __shared__ int hist[kMaxTiles];
  if (blockIdx.x == 0 && threadIdx.x == 0) *ticket = 0;
  for (int t = threadIdx.x; t < tiles; t += kHistThreads) hist[t] = 0;
  const int base = blockIdx.x * kBlockRows + threadIdx.x;
  int64_t key[kHistRows];
  int32_t pane[kHistRows];
  uint32_t idx[kHistRows];
  int4 first[kHistRows];
#pragma unroll
  for (int k = 0; k < kHistRows; ++k) {
    const int i = base + k * kHistThreads;
    key[k] = i < n ? __ldcs(keys + i) : 0;
    pane[k] = i < b ? __ldcs(pane_slots + i) : 0;
  }
#pragma unroll
  for (int k = 0; k < kHistRows; ++k) {
    const int i = base + k * kHistThreads;
    idx[k] = flink_probe_start(key[k], cap);
    first[k] = i < n ? __ldg(buckets + idx[k]) : make_int4(0, 0, 0, 0);
  }
  __syncthreads();  // hist is zeroed
#pragma unroll
  for (int k = 0; k < kHistRows; ++k) {
    const int i = base + k * kHistThreads;
    if (i >= n) continue;
    const int32_t s =
        flink_probe_walk_from(buckets, key[k], idx[k], first[k], cap);
    __stcs(slot_out + i, s);
    int32_t c = -1;
    if (i < b && s >= 0) {
      const int64_t f = static_cast<int64_t>(s) * pane_mod + pane[k];
      if (f >= 0 && f < n_cells) {
        c = static_cast<int32_t>(f);
        atomicAdd(&hist[c >> tile_bits], 1);
      }
    }
    cell_out[i] = c;
  }
  __syncthreads();
  int32_t* row = counts + static_cast<int64_t>(blockIdx.x) * tiles;
  for (int t = threadIdx.x; t < tiles; t += kHistThreads) row[t] = hist[t];
}

}  // namespace

// Runs the steps named by the `steps` mask (1 probe + histogram, 2 offsets,
// 4 partition, 8 fold; the wrapper passes 15) on `stream`.
//   buckets: int32 [cap, 4], 16-byte aligned; keys: int64 [n]; pane_slots:
//   int32 [n]; vals: [n] of the kind's value type; dsum/dcnt: [n_cells];
//   slot: int32 [n] out.  Scratch, from the wrapper: cell int32 [n], counts
//   int32 [blocks * tiles], tile_base int32 [tiles + 2] (the tiles' bases,
//   the number of folding rows, step 2's ticket), part [n] rows of 8
//   bytes (4-byte values) or 16 (8-byte values), 16-byte aligned.
//   blocks = ceil(n / 4096) and tiles = ceil(n_cells / 2^tile_bits) <= 1024,
//   as `fold_plan` computes them.  `kind` names the value and delta types:
//   0 f32 -> f64, 1 f64 -> f64, 2 i32 -> i64, 3 i64 -> i64.
// Returns cudaGetLastError() after the launches, or cudaErrorInvalidValue
// for arguments the kernels do not take.
extern "C" int flink_probe_fold_launch(
    const void* buckets, const void* keys, const void* pane_slots,
    const void* vals, void* dsum, void* dcnt, void* slot, void* cell,
    void* counts, void* tile_base, void* part, int n, int b, int cap,
    long long pane_mod, int n_cells, int tile_bits, int kind, int steps,
    void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kind < 0 || kind > 3 || tile_bits < 0 || tile_bits > 30 || n < 0 ||
      b < 0 || b > n || n_cells < 0 || pane_mod <= 0) {
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
  if (nblk > 0 && (steps & 1)) {
    probe_hist_kernel<<<nblk, kHistThreads, 0, s>>>(
        static_cast<const int4*>(buckets), static_cast<const int64_t*>(keys),
        static_cast<const int32_t*>(pane_slots), static_cast<int32_t*>(slot),
        static_cast<int32_t*>(cell), static_cast<int32_t*>(counts), ticket,
        n, b, cap, pane_mod, n_cells, tile_bits, tiles);
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
        case 0: launch_fold<float, double>(part, tile_base, dsum, dcnt, tiles, tile_bits, s); break;
        case 1: launch_fold<double, double>(part, tile_base, dsum, dcnt, tiles, tile_bits, s); break;
        case 2: launch_fold<int32_t, int64_t>(part, tile_base, dsum, dcnt, tiles, tile_bits, s); break;
        default: launch_fold<int64_t, int64_t>(part, tile_base, dsum, dcnt, tiles, tile_bits, s); break;
      }
    }
  }
  return static_cast<int>(cudaGetLastError());
}
