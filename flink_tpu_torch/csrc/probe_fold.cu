// Fused device key probe + ordered delta fold for Hopper (sm_90a).
//
// Replaces: flink_tpu/state/device_keyindex.py:228 `pallas_probe_fold` (its
// portable twin: `lax_probe` + ops/scatter.py `scatter_fold_counts`).  For
// every row i < n it probes (key_lo, key_hi) from start[i] as probe.cu does
// (flink_probe_walk, probe_walk.cuh); every hit row i < b folds into the flat
// delta planes at cell f = slot * pane_mod + pane_slots[i]:
// dsum[f] += vals[i] (widened to dsum's type), dcnt[f] += 1, in place.
// Misses, rows past b and cells outside [0, n_cells) fold nothing.
//
// Determinism: the float fold keeps row order per cell, so dsum is bit-equal
// to a sequential fold (the Pallas kernel's fori_loop, XLA's and PyTorch's
// CPU scatters).  No atomicAdd touches dsum.  The wrapper (`probe_fold` in
// state/device_keyindex.py) runs three steps on one stream:
//   1. probe_flat_kernel: one thread per row writes slot[i] and the int64
//      cell id flat[i], or kDropped (INT64_MAX, which sorts last) for a row
//      that folds nothing;
//   2. a stable torch.sort of flat, which gives the row permutation perm:
//      the rows of one cell stay in row order;
//   3. segment_fold_kernel: one thread per sorted position.  The head of
//      each run of equal cell ids reads dsum[f] once, adds its rows' values
//      in order, writes dsum[f] once and adds the run's length to dcnt[f].
//      One writer per cell, so no atomics.
// The TPU kernel computes no sort: the sort only puts the rows in order for
// the fold.
//
// What bounds it on this card: memory.  Rows stream in (key_lo, key_hi,
// start, pane slot, value: 20 B) and out (slot: 4 B); the probe reads random
// 32-byte sectors of the table (24 MiB at cap 2^21, which L2 holds); the
// fold reads and writes random dsum and dcnt cells (128 + 64 MiB at the main
// path's 2^20 x 16 delta ring, beyond L2: a sector per touched cell).  The
// flat ids and the sort add 8 B-per-row passes of their own.  A long run of
// one cell (a hot key) serialises one thread: a later PR redesigns that.

#include <cuda_runtime.h>
#include <stdint.h>

#include "probe_walk.cuh"

namespace {

constexpr int64_t kDropped = 0x7fffffffffffffffLL;  // INT64_MAX

__global__ void probe_flat_kernel(const int32_t* __restrict__ tab_lo,
                                  const int32_t* __restrict__ tab_hi,
                                  const int32_t* __restrict__ tab_slot1,
                                  const int32_t* __restrict__ key_lo,
                                  const int32_t* __restrict__ key_hi,
                                  const int32_t* __restrict__ start,
                                  const int32_t* __restrict__ pane_slots,
                                  int32_t* __restrict__ slot_out,
                                  int64_t* __restrict__ flat_out, int n, int b,
                                  int cap, int64_t pane_mod, int64_t n_cells) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int32_t s = flink_probe_walk(tab_lo, tab_hi, tab_slot1, key_lo[i],
                                     key_hi[i], start[i], cap);
  slot_out[i] = s;
  int64_t f = kDropped;
  if (i < b && s >= 0) {
    const int64_t c = static_cast<int64_t>(s) * pane_mod + pane_slots[i];
    if (c >= 0 && c < n_cells) f = c;
  }
  flat_out[i] = f;
}

template <typename V, typename A>
__global__ void segment_fold_kernel(const int64_t* __restrict__ sflat,
                                    const int64_t* __restrict__ perm,
                                    const V* __restrict__ vals,
                                    A* __restrict__ dsum,
                                    int32_t* __restrict__ dcnt, int n) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  const int64_t f = sflat[j];
  if (f == kDropped) return;
  if (j > 0 && sflat[j - 1] == f) return;  // not the head of its run
  A acc = dsum[f];
  int k = j;
  for (; k < n && sflat[k] == f; ++k) acc += static_cast<A>(vals[perm[k]]);
  dsum[f] = acc;
  dcnt[f] += k - j;
}

template <typename V, typename A>
void launch_fold(const void* sflat, const void* perm, const void* vals,
                 void* dsum, void* dcnt, int n, cudaStream_t stream) {
  const int threads = 256;
  const int blocks = (n + threads - 1) / threads;
  segment_fold_kernel<V, A><<<blocks, threads, 0, stream>>>(
      static_cast<const int64_t*>(sflat), static_cast<const int64_t*>(perm),
      static_cast<const V*>(vals), static_cast<A*>(dsum),
      static_cast<int32_t*>(dcnt), n);
}

}  // namespace

// Step 1 on `stream`: slot[i] and flat[i] for rows i < n.  `cap` is a power
// of two; n_cells is the length of the delta planes.  Returns
// cudaGetLastError() after the launch (nonzero: refused, or an earlier
// asynchronous fault surfaced).
extern "C" int flink_probe_fold_probe(const void* tab_lo, const void* tab_hi,
                                      const void* tab_slot1, const void* key_lo,
                                      const void* key_hi, const void* start,
                                      const void* pane_slots, void* slot,
                                      void* flat, int n, int b, int cap,
                                      long long pane_mod, long long n_cells,
                                      void* stream) {
  if (n > 0) {
    const int threads = 256;
    const int blocks = (n + threads - 1) / threads;
    probe_flat_kernel<<<blocks, threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(tab_lo), static_cast<const int32_t*>(tab_hi),
        static_cast<const int32_t*>(tab_slot1),
        static_cast<const int32_t*>(key_lo), static_cast<const int32_t*>(key_hi),
        static_cast<const int32_t*>(start),
        static_cast<const int32_t*>(pane_slots), static_cast<int32_t*>(slot),
        static_cast<int64_t*>(flat), n, b, cap, pane_mod, n_cells);
  }
  return static_cast<int>(cudaGetLastError());
}

// Step 3 on `stream`: fold the rows in sorted order (sflat ascending, perm
// the row of each sorted position).  `kind` names the value and delta types:
// 0 f32 -> f64, 1 f64 -> f64, 2 i32 -> i64, 3 i64 -> i64.  Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for an
// unknown kind.
extern "C" int flink_probe_fold_fold(const void* sflat, const void* perm,
                                     const void* vals, void* dsum, void* dcnt,
                                     int n, int kind, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n > 0) {
    switch (kind) {
      case 0: launch_fold<float, double>(sflat, perm, vals, dsum, dcnt, n, s); break;
      case 1: launch_fold<double, double>(sflat, perm, vals, dsum, dcnt, n, s); break;
      case 2: launch_fold<int32_t, int64_t>(sflat, perm, vals, dsum, dcnt, n, s); break;
      case 3: launch_fold<int64_t, int64_t>(sflat, perm, vals, dsum, dcnt, n, s); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
