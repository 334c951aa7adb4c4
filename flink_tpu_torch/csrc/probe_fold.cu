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
// steps, all kernels of this file, on one stream:
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

#include <cub/block/block_radix_sort.cuh>
#include <cub/block/block_scan.cuh>

#include "probe_walk.cuh"

namespace {

constexpr int kHistThreads = 1024;
constexpr int kHistRows = 4;
constexpr int kBlockRows = kHistThreads * kHistRows;  // 4096
constexpr int kScatterThreads = 512;
constexpr int kScatterItems = kBlockRows / kScatterThreads;  // 8
constexpr int kMaxTiles = 1024;
constexpr int kScanThreads = 1024;  // 32 warps, 32 tiles a block
constexpr int kFoldThreads = 512;
constexpr int kFoldItems = 4;
constexpr int kChunk = kFoldThreads * kFoldItems;  // 2048

// A partitioned row: the cell's low tile_bits bits and the value, written
// and read with one 8- or 16-byte access.
template <typename V>
struct alignas(sizeof(V) == 4 ? 8 : 16) PartRow {
  uint32_t low;
  V val;
};

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

// Step 2.  A block takes 32 tiles (one a lane) and 32 warps, each warp a
// contiguous range of blocks: partial sums per warp, then the exclusive
// running count written back in place (loads of a group issued before its
// stores).  Lanes read neighbouring tiles of one matrix row, so the loads
// coalesce.  Warp 31 writes each tile's total to tile_base; the last block
// to finish (a ticket, reset for the next launch) scans the totals into the
// tiles' bases, and tile_base[tiles] into the number of folding rows.
__global__ void __launch_bounds__(kScanThreads) tile_scan_kernel(
    int32_t* __restrict__ counts, int32_t* __restrict__ tile_base,
    int32_t* __restrict__ ticket, int nblk, int tiles) {
  using Scan = cub::BlockScan<int, kScanThreads>;
  __shared__ typename Scan::TempStorage tmp;
  __shared__ int part[32][33];
  __shared__ bool last;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int t = blockIdx.x * 32 + lane;
  const int per = (nblk + 31) / 32;
  const int j0 = min(nblk, warp * per);
  const int j1 = min(nblk, j0 + per);
  int sum = 0;
  if (t < tiles) {
    for (int j = j0; j < j1; ++j) {
      sum += counts[static_cast<int64_t>(j) * tiles + t];
    }
  }
  part[warp][lane] = sum;
  __syncthreads();
  if (t < tiles) {
    int run = 0;
    for (int w = 0; w < warp; ++w) run += part[w][lane];
    if (warp == 31) tile_base[t] = run + sum;  // the tile's total
    for (int j = j0; j < j1; j += 8) {
      int c[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        c[u] = j + u < j1 ? counts[static_cast<int64_t>(j + u) * tiles + t]
                          : 0;
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        if (j + u < j1) {
          counts[static_cast<int64_t>(j + u) * tiles + t] = run;
          run += c[u];
        }
      }
    }
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  const int v = static_cast<int>(threadIdx.x) < tiles
                    ? __ldcg(tile_base + threadIdx.x)
                    : 0;
  int excl = 0;
  int total = 0;
  Scan(tmp).ExclusiveSum(v, excl, total);
  if (static_cast<int>(threadIdx.x) < tiles) tile_base[threadIdx.x] = excl;
  if (threadIdx.x == 0) {
    tile_base[tiles] = total;
    *ticket = 0;
  }
}

// Step 3.  The block's cell ids are sorted by tile in blocked arrangement
// (thread tid holds rows tid * kScatterItems + k), which is row order, so
// the stable sort keeps one tile's rows in row order.  Key: the tile, or
// `tiles` for a row that folds nothing (sorted last, never written).  The
// sort carries each row's index and hands the rows back striped (thread tid
// holds sorted positions k * kScatterThreads + tid), so a warp writes 32
// neighbouring positions, a few runs of one tile each; each row is written
// once, as a PartRow.
template <typename V>
__global__ void __launch_bounds__(kScatterThreads) scatter_kernel(
    const int32_t* __restrict__ cell, const V* __restrict__ vals,
    const int32_t* __restrict__ counts, const int32_t* __restrict__ tile_base,
    PartRow<V>* __restrict__ part, int n, int tile_bits, int tiles,
    int key_bits) {
  using Sort = cub::BlockRadixSort<uint32_t, kScatterThreads, kScatterItems,
                                   int32_t>;
  __shared__ typename Sort::TempStorage tmp;
  __shared__ int32_t sorted[kBlockRows];
  __shared__ int32_t run_start[kMaxTiles];
  const int base = blockIdx.x * kBlockRows;
  const int r0 = threadIdx.x * kScatterItems;
  const uint32_t sentinel = static_cast<uint32_t>(tiles);
  int32_t c[kScatterItems];
  if (base + r0 + kScatterItems <= n) {
    const int4* src = reinterpret_cast<const int4*>(cell + base + r0);
    const int4 lo = src[0];
    const int4 hi = src[1];
    c[0] = lo.x; c[1] = lo.y; c[2] = lo.z; c[3] = lo.w;
    c[4] = hi.x; c[5] = hi.y; c[6] = hi.z; c[7] = hi.w;
  } else {
#pragma unroll
    for (int k = 0; k < kScatterItems; ++k) {
      c[k] = base + r0 + k < n ? cell[base + r0 + k] : -1;
    }
  }
  uint32_t key[kScatterItems];
  int32_t local[kScatterItems];
#pragma unroll
  for (int k = 0; k < kScatterItems; ++k) {
    key[k] = c[k] >= 0 ? static_cast<uint32_t>(c[k]) >> tile_bits : sentinel;
    local[k] = r0 + k;
  }
  Sort(tmp).SortBlockedToStriped(key, local, 0, key_bits);
#pragma unroll
  for (int k = 0; k < kScatterItems; ++k) {
    sorted[k * kScatterThreads + threadIdx.x] = static_cast<int32_t>(key[k]);
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kScatterItems; ++k) {
    const int p = k * kScatterThreads + threadIdx.x;
    if (key[k] != sentinel &&
        (p == 0 || sorted[p - 1] != static_cast<int32_t>(key[k]))) {
      run_start[key[k]] = p;
    }
  }
  __syncthreads();
  const int32_t* offs = counts + static_cast<int64_t>(blockIdx.x) * tiles;
  const uint32_t low = (1u << tile_bits) - 1u;
#pragma unroll
  for (int k = 0; k < kScatterItems; ++k) {
    if (key[k] == sentinel) continue;
    const int p = k * kScatterThreads + threadIdx.x;
    const int t = static_cast<int>(key[k]);
    PartRow<V> row;
    row.low = static_cast<uint32_t>(cell[base + local[k]]) & low;
    row.val = vals[base + local[k]];
    part[tile_base[t] + offs[t] + (p - run_start[t])] = row;
  }
}

// Step 4.  One block per tile; V is the value type, A the delta plane's.
// Per chunk: sort by the cell's low bits (stable), list the heads of the
// runs with a block scan (the sentinel run's head closes the last real
// run), load every head's dsum together, then fold each run in order and
// write once.
template <typename V, typename A>
__global__ void __launch_bounds__(kFoldThreads) fold_kernel(
    const PartRow<V>* __restrict__ part,
    const int32_t* __restrict__ tile_base, A* __restrict__ dsum,
    int32_t* __restrict__ dcnt, int tile_bits) {
  using Sort = cub::BlockRadixSort<uint32_t, kFoldThreads, kFoldItems, V>;
  using HeadScan = cub::BlockScan<int, kFoldThreads>;
  __shared__ union {
    typename Sort::TempStorage sort;
    struct {
      typename HeadScan::TempStorage scan;
      int32_t head_pos[kChunk + 1];
    } runs;
  } tmp;
  __shared__ uint32_t skey[kChunk];
  __shared__ V sval[kChunk];
  const int start = tile_base[blockIdx.x];
  const int end = tile_base[blockIdx.x + 1];
  const uint32_t sentinel = 1u << tile_bits;
  const int64_t cell0 = static_cast<int64_t>(blockIdx.x) << tile_bits;
  const int p0 = threadIdx.x * kFoldItems;
  for (int c0 = start; c0 < end; c0 += kChunk) {
    uint32_t key[kFoldItems];
    V val[kFoldItems];
#pragma unroll
    for (int k = 0; k < kFoldItems; ++k) {
      const int q = c0 + p0 + k;
      if (q < end) {
        const PartRow<V> row = part[q];
        key[k] = row.low;
        val[k] = row.val;
      } else {
        key[k] = sentinel;
        val[k] = V(0);
      }
    }
    Sort(tmp.sort).Sort(key, val, 0, tile_bits + 1);
#pragma unroll
    for (int k = 0; k < kFoldItems; ++k) {
      skey[p0 + k] = key[k];
      sval[p0 + k] = val[k];
    }
    __syncthreads();  // the sort is done: tmp.runs may alias it
    bool head[kFoldItems];
    int heads = 0;
#pragma unroll
    for (int k = 0; k < kFoldItems; ++k) {
      head[k] = p0 + k == 0 || skey[p0 + k - 1] != key[k];
      heads += head[k];
    }
    int rank = 0;
    int total = 0;
    HeadScan(tmp.runs.scan).ExclusiveSum(heads, rank, total);
    int r = rank;
#pragma unroll
    for (int k = 0; k < kFoldItems; ++k) {
      if (head[k]) tmp.runs.head_pos[r++] = p0 + k;
    }
    if (threadIdx.x == 0) tmp.runs.head_pos[total] = kChunk;
    __syncthreads();
    A sum0[kFoldItems];
#pragma unroll
    for (int k = 0; k < kFoldItems; ++k) {
      if (head[k] && key[k] != sentinel) sum0[k] = dsum[cell0 + key[k]];
    }
    r = rank;
#pragma unroll
    for (int k = 0; k < kFoldItems; ++k) {
      if (!head[k]) continue;
      const int e = tmp.runs.head_pos[++r];
      if (key[k] == sentinel) continue;
      // the run's values in order: eight loaded ahead of their adds, so a
      // long run is a chain of adds, not of shared-memory loads
      A acc = sum0[k];
      int q = p0 + k;
      for (; q + 8 <= e; q += 8) {
        V v[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = sval[q + j];
#pragma unroll
        for (int j = 0; j < 8; ++j) acc += static_cast<A>(v[j]);
      }
      for (; q < e; ++q) acc += static_cast<A>(sval[q]);
      dsum[cell0 + key[k]] = acc;
      // an integer count is the same in any order: added at L2, no round
      // trip (one writer per cell per chunk in any case)
      atomicAdd(dcnt + cell0 + key[k], e - p0 - k);
    }
    // this chunk's dsum/dcnt writes are visible to the next chunk's heads,
    // and the shared arrays are free again
    __syncthreads();
  }
}

template <typename V, typename A>
void launch_fold(const void* part, const void* tile_base, void* dsum,
                 void* dcnt, int tiles, int tile_bits, cudaStream_t s) {
  fold_kernel<V, A><<<tiles, kFoldThreads, 0, s>>>(
      static_cast<const PartRow<V>*>(part),
      static_cast<const int32_t*>(tile_base), static_cast<A*>(dsum),
      static_cast<int32_t*>(dcnt), tile_bits);
}

template <typename V>
void launch_scatter(const void* cell, const void* vals, const void* counts,
                    const void* tile_base, void* part, int n, int nblk,
                    int tile_bits, int tiles, int key_bits, cudaStream_t s) {
  scatter_kernel<V><<<nblk, kScatterThreads, 0, s>>>(
      static_cast<const int32_t*>(cell), static_cast<const V*>(vals),
      static_cast<const int32_t*>(counts),
      static_cast<const int32_t*>(tile_base),
      static_cast<PartRow<V>*>(part), n, tile_bits, tiles, key_bits);
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
