// The ordered fold of probe_fold.cu: steps 2-4 of a fold of rows into flat
// cell planes that adds each cell's rows in row order, with no atomic on
// values (see probe_fold.cu for the design and its costs; scatter_fold.cu
// has a design of its own).  A file that includes it writes its own step 1:
// one cell id per row (-1 for a row that folds nothing) into `cell`, and
// each block's row of the [blocks, tiles] count matrix (the block's folding
// rows per tile of 2^tile_bits cells), with block 0 zeroing step 2's
// ticket.  Then:
//   2. tile_scan_kernel: the count matrix becomes each (block, tile)'s offset
//      within its tile, and tile_base the tiles' bases;
//   3. scatter_kernel<V>: each block writes its folding rows, stably
//      partitioned by tile, as (cell's low bits, value) rows;
//   4. fold_kernel<V, A>: one block per tile folds each cell's run in row
//      order into dsum (type A) and adds its length to dcnt (int32, with an
//      integer atomicAdd; skipped when dcnt is null).
// Everything here sits in an anonymous namespace: each including file gets
// its own copy.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <cub/block/block_radix_sort.cuh>
#include <cub/block/block_scan.cuh>

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
      // trip (one writer per cell per chunk in any case); a launch that
      // folds no counts passes a null dcnt
      if (dcnt != nullptr) atomicAdd(dcnt + cell0 + key[k], e - p0 - k);
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
