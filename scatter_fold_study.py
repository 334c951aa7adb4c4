#!/usr/bin/env python3
"""Where the time of ``csrc/scatter_fold.cu`` goes, on one NVIDIA GPU.

    python3 scatter_fold_study.py

Builds variants of the kernel's source (text substitutions of
``flink_tpu_torch/csrc/scatter_fold.cu``, compiled with the port's nvcc
flags into ``build/scatter_fold_study/``) and times each at the chip smoke's
path-5 shapes (``chip_smoke.make_replica_batch``: 2^18 int32 ids, ~2%
dropped, into an f32 ``[2^20, 16]`` replica and int32 counts; the skewed
batch puts one key on 25% of the rows), L2 flushed by a write before each
timed call, beside the two ``index_add_`` calls that do the same accesses
unordered.  Variants:

- ``final``: the source as it is;
- ``chunk2048``: fold chunks of 2048 rows (4 a thread), a 4-bit radix and
  tiles of ~1024 rows: the chunk size's trade between the uniform and the
  skewed batch;
- ``run_counts``: the count atomics issued per run after the fold's sort
  (one a cell), instead of per row before it;
- timing-only cuts, whose results are wrong and not checked: ``no_counts``
  (no count atomics), ``no_planes`` (no plane loads, stores or staging),
  ``sort_only`` (the fold stops after its sort), ``load_only`` (the fold
  stops after loading the chunk).

Each line: whether the variant equals the plain version bit for bit (both
batches), its time, the partition and the fold step alone, the skewed
batch, and the multi-plane call (int64 ids, the f32 replica and an f64
plane from one column, two count planes).  Imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(ROOT, "flink_tpu_torch", "csrc", "scatter_fold.cu")
OUT = os.path.join(ROOT, "build", "scatter_fold_study")

_CHUNK = ("constexpr int kFoldItems = 8;", "constexpr int kFoldItems = 4;")
_RADIX = ("constexpr int kFoldRadixBits = 5;",
          "constexpr int kFoldRadixBits = 4;")
_SORT = "      Sort(tmp.sort).Sort(key, g, 0, tile_bits);\n"
_STOP = ("      if (key[0] == 0xfffffff7u && g[1] == 12345) "
         "pl.counts[0][0] = 1;\n      __syncthreads();\n      continue;\n")
_EARLY_COUNTS = "      for (int c = 0; c < pl.n_counts; ++c) {\n"
_RUN_COUNTS = """        head[k] = bnd[k] && g[k] >= 0;
        if (!head[k]) continue;
        for (int c = 0; c < pl.n_counts; ++c) {
          atomicAdd(pl.counts[c] + cell0 + key[k], end[k] - p0 - k);
        }
"""
_PLANES = "      for (int i = 0; i < pl.n; ++i) {\n"

#: name -> (substitutions, tile rows of the plan, checked)
VARIANTS = {
    "final": ([], None, True),
    "chunk2048": ([_CHUNK, _RADIX], 1024, True),
    "run_counts": ([(_EARLY_COUNTS, "      for (int c = 0; c < 0; ++c) {\n"),
                    ("        head[k] = bnd[k] && g[k] >= 0;\n",
                     _RUN_COUNTS)], None, True),
    "no_counts": ([(_EARLY_COUNTS, "      for (int c = 0; c < 0; ++c) {\n")],
                  None, False),
    "no_planes": ([(_PLANES, "      for (int i = 0; i < 0; ++i) {\n")], None,
                  False),
    "sort_only": ([(_SORT, _SORT + _STOP)], None, False),
    "load_only": ([(_EARLY_COUNTS, _STOP + _EARLY_COUNTS)], None, False),
}


def variant_source(subs) -> str:
    text = open(SOURCE).read()
    for old, new in subs:
        if text.count(old) != 1:
            raise RuntimeError(f"substitution anchor not found once: {old!r}")
        text = text.replace(old, new)
    return text


def build(name, subs):
    from flink_tpu_torch.kernels import build as kb
    os.makedirs(OUT, exist_ok=True)
    cu = os.path.join(OUT, f"{name}.cu")
    with open(cu, "w") as f:
        f.write(variant_source(subs))
    so = os.path.join(OUT, f"lib{name}.so")
    res = subprocess.run([kb.find_nvcc(), *kb.NVCC_FLAGS, "-o", so, cu],
                         capture_output=True, text=True, timeout=600)
    if res.returncode:
        raise RuntimeError(f"nvcc failed for {name}:\n{res.stderr}")
    fn = ctypes.CDLL(so).flink_scatter_fold_launch
    fn.argtypes = kb.scatter_fold_lib().flink_scatter_fold_launch.argtypes
    fn.restype = ctypes.c_int
    return name, fn


def plan(n, n_cells, tile_rows):
    from flink_tpu_torch.ops import scatter as sc
    if tile_rows is None:
        return sc.scatter_plan(n, n_cells)[0]
    want = min(sc.SCATTER_MAX_TILES,
               max(sc.SCATTER_MIN_TILES, -(-n // tile_rows)))
    return max(1, (-(-n_cells // want) - 1).bit_length())


def main() -> None:
    import torch

    import chip_smoke as cs
    from flink_tpu_torch.ops import scatter as sc
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false: this study needs a GPU")
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        fns = dict(pool.map(lambda kv: build(kv[0], kv[1][0]),
                            VARIANTS.items()))
    print(f"built {len(fns)} variants in {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(7)
    n, n_cells = cs.BATCH, cs.KEY_CAPACITY * cs.PANES
    gen = torch.Generator().manual_seed(13)
    plane0 = torch.rand(n_cells, dtype=torch.float32, generator=gen) * 100
    counts0 = torch.randint(0, 5, (n_cells,), dtype=torch.int32,
                            generator=gen)
    delta0 = torch.rand(n_cells, dtype=torch.float64, generator=gen)
    batch = cs.make_replica_batch(rng, dev)
    skew = cs.make_replica_batch(rng, dev, hot_key=cs.N_KEYS // 3)
    low = torch.empty(n, dtype=torch.int32, device=dev)
    slots = torch.empty((1, n), dtype=torch.int64, device=dev)
    offs = torch.empty(-(-n // sc.SCATTER_PART_ROWS)
                       * (sc.SCATTER_MAX_TILES + 1), dtype=torch.int32,
                       device=dev)
    flush, _ = cs.l2_flushes(dev)
    vp, ci = ctypes.c_void_p, ctypes.c_int

    def call(fn, tile_rows, ids, vals, planes, counts, steps=3):
        src, src_kind = (vp * 1)(vals.data_ptr()), (ci * 1)(0)
        dst = (vp * 2)(*[p.data_ptr() for p in planes])
        kinds = (ci * 2)(*[{torch.float32: 0, torch.float64: 1}[p.dtype]
                           for p in planes])
        dsrc = (ci * 2)(0, 0)
        cnt = (vp * 2)(*[c.data_ptr() for c in counts])
        rc = fn(ids.data_ptr(), int(ids.dtype == torch.int64), n, n_cells,
                plan(n, n_cells, tile_rows), 1, ctypes.addressof(src),
                ctypes.addressof(src_kind), len(planes),
                ctypes.addressof(dst), ctypes.addressof(kinds),
                ctypes.addressof(dsrc), len(counts), ctypes.addressof(cnt),
                low.data_ptr(), slots.data_ptr(), slots.stride(0) * 8,
                offs.data_ptr(), steps, torch.cuda.current_stream().cuda_stream)
        cs.check(rc == 0, f"launch failed: cudaError {rc}")

    for name, fn in fns.items():
        _, tile_rows, checked = VARIANTS[name]
        ok = "n/a (timing only)"
        if checked:
            same = True
            for ids, vals in (batch, skew):
                p, c = plane0.to(dev), counts0.to(dev)
                call(fn, tile_rows, ids, vals, [p], [c])
                torch.cuda.synchronize()
                (w,), wc = sc.scatter_fold_counts(
                    (plane0.clone(),), counts0.clone(), ids.cpu(),
                    (vals.cpu(),), ("add",))
                same &= (p.cpu().numpy().tobytes() == w.numpy().tobytes()
                         and torch.equal(c.cpu(), wc))
            cs.check(same, f"{name} != the plain version")
            ok = "bit-equal"
        p, c = plane0.to(dev), counts0.to(dev)
        d, dc = delta0.to(dev), counts0.to(dev)
        ids, vals = batch
        ms = cs.cuda_time_ms(lambda: call(fn, tile_rows, ids, vals, [p], [c]),
                             20, flush=flush)
        split = cs.split_ms(sc.SCATTER_FOLD_STEPS, lambda st: call(
            fn, tile_rows, ids, vals, [p], [c], st), 20, flush)
        sk = cs.cuda_time_ms(lambda: call(fn, tile_rows, skew[0], skew[1],
                                          [p], [c]), 10, flush=flush)
        multi = cs.cuda_time_ms(lambda: call(fn, tile_rows, ids.long(), vals,
                                             [p, d], [c, dc]), 20, flush=flush)
        print(f"{name} ({ok}; tile_bits {plan(n, n_cells, tile_rows)}): "
              f"{ms:.4f} ms with L2 flushed ({cs._steps(split)}); skewed "
              f"{sk:.4f} ms; multi-plane {multi:.4f} ms")
    keep = batch[0] < n_cells
    li, lv = batch[0][keep].long(), batch[1][keep]
    lo = torch.ones_like(li, dtype=torch.int32)
    p, c = plane0.to(dev), counts0.to(dev)

    def library():
        p.index_add_(0, li, lv)
        c.index_add_(0, li, lo)

    print(f"index_add_ x2 {cs.cuda_time_ms(library, 20, flush=flush):.4f} ms "
          f"with L2 flushed; timing floor {cs.timing_floor_ms():.4f} ms")
    print(cs.card_line())


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    main()
