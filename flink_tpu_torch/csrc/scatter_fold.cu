// Ordered multi-plane fold of a batch into flat cell planes for Hopper
// (sm_90a).
//
// Replaces: the `index_add_` fold that flink_tpu_torch/ops/scatter.py
// `scatter_fold_counts` runs on the card, which adds floats with atomics in
// no fixed order.  Its TPU counterpart is no Pallas kernel: XLA's scatter in
// flink_tpu/ops/scatter.py:61 `scatter_fold_counts` (the update step, the
// probe lanes' replica and delta folds, window_agg.py), which adds in row
// order.  For every row i < n whose host- or device-computed flat id
// f = ids[i] lies in [0, n_cells), and for every plane p of the call:
// plane_p[f] += src_p[i] in the plane's own type, and for every count plane
// c: counts_c[f] += 1.  Rows with any other id (the dropped id n_cells,
// padding) fold nothing.  The planes of one call share the ids, so the rows
// are partitioned once for all of them: the update step of the probe lane
// folds its f32 replica, its f64 delta ring and both count planes in one
// call.
//
// Determinism: each cell's rows are added in row order by one thread, so
// every plane is bit-equal to a sequential `state[f] += v` in the plane's
// type (XLA's and PyTorch's CPU scatters).  No atomic touches a value; the
// int32 counts take integer atomicAdds (the same sum in any order).  A hot
// cell is one thread's chain of adds, in row order.
//
// Two kernels on one stream:
//   1. partition_kernel: each block of kPartRows rows sorts its rows by
//      tile (cells cut into tiles of 2^tile_bits; dropped rows last) with a
//      stable cub::BlockRadixSort and writes them, in that order, into its
//      own kPartRows slots of the partition: the cell's low bits, and the
//      row's value of each source.  It also writes its row of the offset
//      table, where each tile's rows start among its slots.  Every write is
//      coalesced, and no block waits on another: there is no global scan.
//   2. fold_kernel: one block per tile gathers the tile's rows from the
//      blocks' slots in block order (a block scan over the offset table's
//      column), which is row order, in chunks of kChunk; sorts the chunk
//      stably by the cell's low bits (each row having added itself to
//      every count plane before the sort, with an integer atomic); lists
//      the runs of one cell; then, per plane, loads each run head's cell,
//      stages the chunk's values (widened to the plane's type) in shared
//      memory in sorted order, and lets each head add its run in order and
//      store the cell once.  The
//      chunks of a tile are folded in order by its one block, so a cell
//      split across chunks is still added in row order.
//
// What bounds it on this card: the random sectors of the planes.  The rows
// stream in (id 4 or 8 B, a value per source) and through the partition
// (4 B of low bits and a value per source, written and read once); each
// touched cell costs a random sector of each plane, read and written, and an
// atomic on each count plane.  At the main path's shapes (2^18 rows, 2^24
// cells, ~241k touched) the compulsory bytes are ~6 MB, ~2 us at the card's
// memory rate, but ~480k distinct 128-byte lines are touched, more than L2
// holds, and each costs a DRAM access: measured (scatter_fold_study.py),
// the plane's loads and stores take ~16 us and the counts' atomics ~12 us,
// about as long as the two `index_add_` calls that do the same random
// accesses unordered.  The count atomics are issued before the fold's
// sort, so part of their drain overlaps it.  The rest is fixed cost the
// design cuts: two launches instead of the earlier design's four
// (histogram, offsets scan with a ticket, partition, fold);
// a tile plan sized to the rows (scatter_plan: ~kChunk / 2 rows a tile),
// where the earlier plan's 1024 fixed tiles left 7/8 of each sort padding;
// and large chunks (4096 rows, a 5-bit radix), so a hot cell's tile, which
// one block folds chunk by chunk, pays few sorts.  Tried and dropped, as
// they moved nothing: an L2 prefetch of every row's cells before the sort,
// and the count atomics moved into the partition (the partition's own
// loads then queue behind them).
//
// Scratch (from the wrapper, cached and reused, never allocated here): the
// partition's low bits and value slots, and the offset table.  A call
// reuses them on the same stream, so calls run in stream order and one
// cannot overwrite another's scratch before it has finished; the wrapper
// keys its cache by stream.

#include <cuda_runtime.h>
#include <stdint.h>

#include <cub/block/block_radix_sort.cuh>
#include <cub/block/block_scan.cuh>

namespace {

constexpr int kPartThreads = 256;
constexpr int kPartItems = 8;
constexpr int kPartRows = kPartThreads * kPartItems;  // 2048
constexpr int kMaxTiles = 1024;
constexpr int kFoldThreads = 512;
constexpr int kFoldItems = 8;
constexpr int kChunk = kFoldThreads * kFoldItems;  // 4096
// digit bits of the fold's radix sort: 5 sorts the main path's 17-bit
// tiles in four passes
constexpr int kFoldRadixBits = 5;
constexpr int kMaxSources = 8;
constexpr int kMaxPlanes = 8;
constexpr int kMaxCounts = 8;

// The value columns the partition carries: one per distinct source tensor,
// 4- or 8-byte elements copied as bits.
struct Sources {
  const void* vals[kMaxSources];
  void* part[kMaxSources];
  int bytes[kMaxSources];
  int n;
};

// The planes one call folds.  combo names (plane type <- source type):
// 0 f32<-f32, 1 f64<-f64, 2 i32<-i32, 3 i64<-i64, 4 f64<-f32, 5 i64<-i32.
struct Planes {
  void* dst[kMaxPlanes];
  const void* part[kMaxPlanes];
  int combo[kMaxPlanes];
  int n;
  int32_t* counts[kMaxCounts];
  int n_counts;
};

// A plane's cell, loaded through L2 only: the block's own earlier chunk may
// have stored it.
__device__ __forceinline__ float load_cg(const float* p) { return __ldcg(p); }
__device__ __forceinline__ double load_cg(const double* p) {
  return __ldcg(p);
}
__device__ __forceinline__ int32_t load_cg(const int32_t* p) {
  return __ldcg(p);
}
__device__ __forceinline__ int64_t load_cg(const int64_t* p) {
  return __ldcg(reinterpret_cast<const long long*>(p));
}

// Step 1.  Thread tid holds rows tid * kPartItems + k of the block (row
// order, the blocked arrangement), so the stable sort keeps one tile's rows
// in row order; it hands them back striped (thread tid holds sorted
// positions k * kPartThreads + tid), so a warp's writes are 32 neighbouring
// slots.  Key: the tile, or `tiles` for a row that folds nothing (sorted
// last, never written).  The per-tile counts come from a shared-memory
// histogram (integer atomics: the same counts in any order), scanned into
// the block's row of the offset table: tiles + 1 entries, the last the
// block's number of folding rows.
template <typename I>
__global__ void __launch_bounds__(kPartThreads) partition_kernel(
    const I* __restrict__ ids, int n, int n_cells, int tile_bits, int tiles,
    int key_bits, uint32_t* __restrict__ part_low,
    int32_t* __restrict__ offs, Sources src) {
  using Sort =
      cub::BlockRadixSort<uint32_t, kPartThreads, kPartItems, int32_t>;
  using Scan = cub::BlockScan<int, kPartThreads>;
  constexpr int kScanItems = kMaxTiles / kPartThreads;  // 4
  __shared__ union {
    typename Sort::TempStorage sort;
    typename Scan::TempStorage scan;
  } tmp;
  __shared__ int hist[kMaxTiles];
  const int base = blockIdx.x * kPartRows;
  for (int t = threadIdx.x; t < tiles; t += kPartThreads) hist[t] = 0;
  const uint32_t sentinel = static_cast<uint32_t>(tiles);
  const int r0 = threadIdx.x * kPartItems;
  uint32_t key[kPartItems];
  int32_t local[kPartItems];
  int64_t id[kPartItems];
#pragma unroll
  for (int k = 0; k < kPartItems; ++k) {
    const int r = base + r0 + k;
    id[k] = r < n ? static_cast<int64_t>(__ldg(ids + r)) : -1;
  }
  __syncthreads();  // hist is zeroed
#pragma unroll
  for (int k = 0; k < kPartItems; ++k) {
    const bool keep = id[k] >= 0 && id[k] < n_cells;
    key[k] = keep ? static_cast<uint32_t>(id[k] >> tile_bits) : sentinel;
    local[k] = r0 + k;
    if (keep) atomicAdd(&hist[key[k]], 1);
  }
  Sort(tmp.sort).SortBlockedToStriped(key, local, 0, key_bits);
  __syncthreads();  // the sort's storage is free for the scan; hist is done
  int h[kScanItems];
  int e[kScanItems];
  int total = 0;
#pragma unroll
  for (int q = 0; q < kScanItems; ++q) {
    const int t = threadIdx.x * kScanItems + q;
    h[q] = t < tiles ? hist[t] : 0;
  }
  Scan(tmp.scan).ExclusiveSum(h, e, total);
  int32_t* row = offs + static_cast<int64_t>(blockIdx.x) * (tiles + 1);
#pragma unroll
  for (int q = 0; q < kScanItems; ++q) {
    const int t = threadIdx.x * kScanItems + q;
    if (t < tiles) row[t] = e[q];
  }
  if (threadIdx.x == 0) row[tiles] = total;
  const uint32_t low_mask =
      tile_bits >= 32 ? 0xffffffffu : (1u << tile_bits) - 1u;
#pragma unroll
  for (int k = 0; k < kPartItems; ++k) {
    if (key[k] == sentinel) continue;
    const int64_t p = base + k * kPartThreads + threadIdx.x;
    const int r = base + local[k];
    part_low[p] = static_cast<uint32_t>(static_cast<int64_t>(ids[r])) &
                  low_mask;
    for (int s = 0; s < src.n; ++s) {
      if (src.bytes[s] == 4) {
        static_cast<uint32_t*>(src.part[s])[p] =
            static_cast<const uint32_t*>(src.vals[s])[r];
      } else {
        static_cast<uint64_t*>(src.part[s])[p] =
            static_cast<const uint64_t*>(src.vals[s])[r];
      }
    }
  }
}

// Step 2, one plane: each run head loads its cell, adds the run's values
// (staged in sorted order in `sbuf`, widened to the plane's type) in order,
// and stores it once.  The head loads are issued before the staging loop,
// so their latency overlaps it.  A long run (a hot cell) is a chain of
// dependent adds, its values loaded sixteen at a time.
template <typename A, typename V>
__device__ __forceinline__ void fold_plane(
    A* __restrict__ plane, const V* __restrict__ part,
    const uint32_t (&key)[kFoldItems], const int32_t (&g)[kFoldItems],
    const bool (&head)[kFoldItems], const int (&end)[kFoldItems],
    int64_t cell0, A* sbuf) {
  const int p0 = threadIdx.x * kFoldItems;
  A acc[kFoldItems];
#pragma unroll
  for (int k = 0; k < kFoldItems; ++k) {
    if (head[k]) acc[k] = load_cg(plane + cell0 + key[k]);
  }
#pragma unroll
  for (int k = 0; k < kFoldItems; ++k) {
    if (g[k] >= 0) sbuf[p0 + k] = static_cast<A>(part[g[k]]);
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kFoldItems; ++k) {
    if (!head[k]) continue;
    A a = acc[k];
    int i = p0 + k;
    const int e = end[k];
    for (; i + 16 <= e; i += 16) {
      A v[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) v[j] = sbuf[i + j];
#pragma unroll
      for (int j = 0; j < 16; ++j) a += v[j];
    }
    for (; i < e; ++i) a += sbuf[i];
    plane[cell0 + key[k]] = a;
  }
  __syncthreads();  // sbuf is free for the next plane
}

// Step 2.  One block per tile.  The tile's rows lie in every partition
// block's slots, at offs[j][t] .. offs[j][t + 1] of block j; taken in block
// order they are in row order.  A window of kFoldThreads blocks is scanned
// at a time (one thread a block), and its rows are folded in chunks.
__global__ void __launch_bounds__(kFoldThreads) fold_kernel(
    const uint32_t* __restrict__ part_low, const int32_t* __restrict__ offs,
    int nblk, int tiles, int tile_bits, Planes pl) {
  using Sort = cub::BlockRadixSort<uint32_t, kFoldThreads, kFoldItems,
                                   int32_t, kFoldRadixBits>;
  using Scan = cub::BlockScan<int, kFoldThreads>;
  __shared__ union {
    typename Sort::TempStorage sort;
    struct {
      typename Scan::TempStorage scan;
      int32_t head_pos[kChunk + 1];
    } runs;
  } tmp;
  __shared__ typename Scan::TempStorage seg_scan;
  __shared__ int32_t seg_start[kFoldThreads];
  __shared__ int32_t seg_src[kFoldThreads];
  __shared__ uint32_t last_key[kFoldThreads];
  __shared__ int32_t last_g[kFoldThreads];
  extern __shared__ __align__(16) unsigned char sbuf[];  // kChunk * 8 B
  const int t = blockIdx.x;
  const int64_t cell0 = static_cast<int64_t>(t) << tile_bits;
  const uint32_t pad_key =
      tile_bits >= 32 ? 0xffffffffu : (1u << tile_bits) - 1u;
  const int p0 = threadIdx.x * kFoldItems;
  for (int w0 = 0; w0 < nblk; w0 += kFoldThreads) {
    const int j = w0 + threadIdx.x;
    int cnt = 0;
    int start = 0;
    if (j < nblk) {
      const int32_t* row = offs + static_cast<int64_t>(j) * (tiles + 1);
      start = row[t];
      cnt = row[t + 1] - start;
    }
    int excl = 0;
    int total = 0;
    Scan(seg_scan).ExclusiveSum(cnt, excl, total);
    seg_start[threadIdx.x] = excl;
    seg_src[threadIdx.x] = j * kPartRows + start;
    __syncthreads();
    const int nseg = min(kFoldThreads, nblk - w0);
    for (int c0 = 0; c0 < total; c0 += kChunk) {
      const int m = min(kChunk, total - c0);
      uint32_t key[kFoldItems];
      int32_t g[kFoldItems];
      // the segment of the thread's first row: the last with a start at or
      // before it (an empty segment shares its start with the next one)
      int s = 0;
      if (p0 < m) {
        int lo = 0;
        int hi = nseg - 1;
        while (lo < hi) {
          const int mid = (lo + hi + 1) >> 1;
          if (seg_start[mid] <= c0 + p0) {
            lo = mid;
          } else {
            hi = mid - 1;
          }
        }
        s = lo;
      }
#pragma unroll
      for (int k = 0; k < kFoldItems; ++k) {
        const int q = p0 + k;
        if (q < m) {
          const int pos = c0 + q;
          while (s + 1 < nseg && seg_start[s + 1] <= pos) ++s;
          g[k] = seg_src[s] + (pos - seg_start[s]);
          key[k] = part_low[g[k]];
        } else {
          g[k] = -1;
          key[k] = pad_key;
        }
      }
      // the counts first: an integer count is the same in any order, so
      // each row adds itself (a warp's rows of one cell with one atomic)
      // and the atomics stream out while the block sorts
      for (int c = 0; c < pl.n_counts; ++c) {
#pragma unroll
        for (int k = 0; k < kFoldItems; ++k) {
          const unsigned lane = threadIdx.x & 31u;
          const unsigned same = __match_any_sync(
              0xffffffffu, g[k] >= 0 ? key[k] : 0xffffffffu - lane);
          if (g[k] >= 0 && (same & ((1u << lane) - 1u)) == 0) {
            atomicAdd(pl.counts[c] + cell0 + key[k], __popc(same));
          }
        }
      }
      // stable: a cell's rows stay in row order; padding (g = -1, the
      // chunk's last positions) sorts after any real row of its key
      Sort(tmp.sort).Sort(key, g, 0, tile_bits);
      last_key[threadIdx.x] = key[kFoldItems - 1];
      last_g[threadIdx.x] = g[kFoldItems - 1];
      __syncthreads();  // the sort is done: tmp.runs may alias it
      // a boundary starts a run of one cell, or the padding
      bool bnd[kFoldItems];
      int nb = 0;
#pragma unroll
      for (int k = 0; k < kFoldItems; ++k) {
        bool b;
        if (k == 0) {
          b = threadIdx.x == 0 || last_key[threadIdx.x - 1] != key[0] ||
              (last_g[threadIdx.x - 1] >= 0) != (g[0] >= 0);
        } else {
          b = key[k - 1] != key[k] || (g[k - 1] >= 0) != (g[k] >= 0);
        }
        bnd[k] = b;
        nb += b;
      }
      int rank = 0;
      int nbt = 0;
      Scan(tmp.runs.scan).ExclusiveSum(nb, rank, nbt);
      int r = rank;
#pragma unroll
      for (int k = 0; k < kFoldItems; ++k) {
        if (bnd[k]) tmp.runs.head_pos[r++] = p0 + k;
      }
      if (threadIdx.x == 0) tmp.runs.head_pos[nbt] = kChunk;
      __syncthreads();
      bool head[kFoldItems];
      int end[kFoldItems];
      r = rank;
#pragma unroll
      for (int k = 0; k < kFoldItems; ++k) {
        end[k] = bnd[k] ? tmp.runs.head_pos[++r] : 0;
        head[k] = bnd[k] && g[k] >= 0;
      }
      for (int i = 0; i < pl.n; ++i) {
        switch (pl.combo[i]) {
          case 0:
            fold_plane<float, float>(
                static_cast<float*>(pl.dst[i]),
                static_cast<const float*>(pl.part[i]), key, g, head, end,
                cell0, reinterpret_cast<float*>(sbuf));
            break;
          case 1:
            fold_plane<double, double>(
                static_cast<double*>(pl.dst[i]),
                static_cast<const double*>(pl.part[i]), key, g, head, end,
                cell0, reinterpret_cast<double*>(sbuf));
            break;
          case 2:
            fold_plane<int32_t, int32_t>(
                static_cast<int32_t*>(pl.dst[i]),
                static_cast<const int32_t*>(pl.part[i]), key, g, head, end,
                cell0, reinterpret_cast<int32_t*>(sbuf));
            break;
          case 3:
            fold_plane<int64_t, int64_t>(
                static_cast<int64_t*>(pl.dst[i]),
                static_cast<const int64_t*>(pl.part[i]), key, g, head, end,
                cell0, reinterpret_cast<int64_t*>(sbuf));
            break;
          case 4:
            fold_plane<double, float>(
                static_cast<double*>(pl.dst[i]),
                static_cast<const float*>(pl.part[i]), key, g, head, end,
                cell0, reinterpret_cast<double*>(sbuf));
            break;
          default:
            fold_plane<int64_t, int32_t>(
                static_cast<int64_t*>(pl.dst[i]),
                static_cast<const int32_t*>(pl.part[i]), key, g, head, end,
                cell0, reinterpret_cast<int64_t*>(sbuf));
            break;
        }
      }
      // this chunk's stores are visible to the next chunk's heads, and the
      // shared arrays are free again
      __syncthreads();
    }
    __syncthreads();  // the window's segments are read: the next may land
  }
}

// combo code of (plane kind, source kind), kinds 0 f32, 1 f64, 2 i32,
// 3 i64; -1 for a pair the kernel does not widen
int combo_of(int dst, int src) {
  if (dst == src) return dst;
  if (dst == 1 && src == 0) return 4;
  if (dst == 3 && src == 2) return 5;
  return -1;
}

constexpr int kKindBytes[4] = {4, 8, 4, 8};

}  // namespace

// Runs the steps named by the `steps` mask (1 partition, 2 fold; the
// wrapper passes 3) on `stream`.
//   ids: [n] int32 (ids64 = 0) or int64 (ids64 = 1).  Sources: n_src
//   contiguous [n] value columns of kinds src_kinds (0 f32, 1 f64, 2 i32,
//   3 i64).  Planes: n_planes contiguous [n_cells] planes of kinds
//   plane_kinds, plane i folding source plane_src[i] (the same kind, or
//   f32 -> f64, i32 -> i64).  Counts: n_counts int32 [n_cells] planes.
//   Scratch, from the wrapper: part_low uint32 [blocks * 2048]; the value
//   slots of source s at part_vals + s * part_stride bytes, [blocks * 2048]
//   elements of its kind; offs int32 [blocks * (tiles + 1)].  blocks =
//   ceil(n / 2048) and tiles = ceil(n_cells / 2^tile_bits) <= 1024, as
//   `scatter_plan` computes them.
// Returns cudaGetLastError() after the launches, or cudaErrorInvalidValue
// for arguments the kernels do not take.
extern "C" int flink_scatter_fold_launch(
    const void* ids, int ids64, int n, int n_cells, int tile_bits, int n_src,
    const void* const* src_vals, const int* src_kinds, int n_planes,
    void* const* planes, const int* plane_kinds, const int* plane_src,
    int n_counts, void* const* counts, void* part_low, void* part_vals,
    long long part_stride, void* offs, int steps, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n < 0 || n > 0x7fffffff - kPartRows || n_cells < 0 || tile_bits < 1 ||
      tile_bits > 31 || (ids64 != 0 && ids64 != 1) || n_src < 0 ||
      n_src > kMaxSources || n_planes < 0 || n_planes > kMaxPlanes ||
      n_counts < 0 || n_counts > kMaxCounts || part_stride < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t tiles64 =
      (static_cast<int64_t>(n_cells) + (int64_t{1} << tile_bits) - 1) >>
      tile_bits;
  if (tiles64 > kMaxTiles) return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = static_cast<int>(tiles64);
  Sources src{};
  src.n = n_src;
  for (int s = 0; s < n_src; ++s) {
    if (src_kinds[s] < 0 || src_kinds[s] > 3) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    src.vals[s] = src_vals[s];
    src.part[s] = static_cast<char*>(part_vals) + s * part_stride;
    src.bytes[s] = kKindBytes[src_kinds[s]];
  }
  Planes pl{};
  pl.n = n_planes;
  for (int i = 0; i < n_planes; ++i) {
    const int s = plane_src[i];
    if (s < 0 || s >= n_src || plane_kinds[i] < 0 || plane_kinds[i] > 3) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    pl.combo[i] = combo_of(plane_kinds[i], src_kinds[s]);
    if (pl.combo[i] < 0) return static_cast<int>(cudaErrorInvalidValue);
    pl.dst[i] = planes[i];
    pl.part[i] = src.part[s];
  }
  pl.n_counts = n_counts;
  for (int c = 0; c < n_counts; ++c) {
    pl.counts[c] = static_cast<int32_t*>(counts[c]);
  }
  const int nblk = (n + kPartRows - 1) / kPartRows;
  if (nblk == 0 || tiles == 0) return static_cast<int>(cudaGetLastError());
  int key_bits = 0;  // bits of the partition's keys [0, tiles]
  while ((1 << key_bits) <= tiles) ++key_bits;
  if (steps & 1) {
    if (ids64) {
      partition_kernel<int64_t><<<nblk, kPartThreads, 0, st>>>(
          static_cast<const int64_t*>(ids), n, n_cells, tile_bits, tiles,
          key_bits, static_cast<uint32_t*>(part_low),
          static_cast<int32_t*>(offs), src);
    } else {
      partition_kernel<int32_t><<<nblk, kPartThreads, 0, st>>>(
          static_cast<const int32_t*>(ids), n, n_cells, tile_bits, tiles,
          key_bits, static_cast<uint32_t*>(part_low),
          static_cast<int32_t*>(offs), src);
    }
  }
  if (steps & 2) {
    // the staged values are dynamic shared memory: with the static arrays
    // they may pass the default 48 KB a block
    const cudaError_t attr = cudaFuncSetAttribute(
        fold_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kChunk * 8);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    fold_kernel<<<tiles, kFoldThreads, kChunk * 8, st>>>(
        static_cast<const uint32_t*>(part_low),
        static_cast<const int32_t*>(offs), nblk, tiles, tile_bits, pl);
  }
  return static_cast<int>(cudaGetLastError());
}
