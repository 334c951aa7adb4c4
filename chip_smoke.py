#!/usr/bin/env python3
"""Chip smoke of flink_tpu_torch on one NVIDIA GPU (written for the H100).

    python3 chip_smoke.py

Phases, each fatal on failure (exit code 1, no result line):

1. the card's name and power limit, as nvidia-smi reports them;
2. build of every kernel of the port's main paths from
   ``flink_tpu_torch/csrc`` with nvcc (``sm_90a``), one nvcc per source, and
   of the C host layer (``csrc/host_mirror.cc``: the keydict and the window
   value mirror) with g++, all started together;
3. kernel phase, probe: the device key probe (``csrc/probe.cu``, which
   hashes the int64 keys on the card) at the main path's shapes — a table of
   1M keys at capacity 2^21 (an interleaved ``[cap, 4]`` bucket array),
   batches of 2^18 records, about 10% of them unseen — must equal the plain
   ``torch_probe`` and ``KeyIndex.lookup`` exactly; its median time over
   CUDA-event-timed runs (after a flush that writes L2, after one that
   reads it, and warm) is printed beside the timing floor (an empty
   kernel), its bound (and the bound's bytes under the earlier
   three-plane interface, with host-made starts), and the plain version's
   time;
4. main path 1: the 1M-key tumbling-sum workload of ``bench.py`` (seed 7,
   1,000,000 keys, 2^18 records per batch, 5000 ms windows), 40 batches
   through ``WindowAggOperator(device="cuda", device_probe="on")`` (scatter
   sync, one batch at a time) with a snapshot every 16 batches and
   ``end_input``; every fire is held against an independent numpy reference
   (per window ``np.bincount`` in f64 over the same records);
5. restore and replay of path 1: the first snapshot restored into a fresh
   operator and the remaining batches replayed must give the same
   per-window digests; a profiled replay gives the device's busy share;
6. main path 2: the same 40 batches through the fused super-batch lane,
   ``device_sync="deferred"``, ``superbatch=8``: the same checks, plus
   launches of ``probe_fold`` and a scan depth above 1;
7. restore and replay of path 2, as in phase 5;
7a. main paths 3 and 4: paths 1 and 2 with ``native_emit=True`` and
   ``native_shards = min(4, os.cpu_count())``: the key index and the host
   mirror are the C layer's, so each pair differs only in the mirror.  The
   same checks, plus: the C mirror is active, both kernels still launch,
   and every fire equals its numpy twin's (same keys in the same order,
   values to rtol 1e-6; the card's unordered f64 atomics in the delta fold
   allow no more).  Each is restored and replayed as in phase 5.  The paths
   run in the order 1, 3, 2, 4, so each pair runs back to back;
7b. host layer phase: the C layer's calls at the main paths' sizes, on the
   host's clock (median of 5): the probe + mirror pass over one batch of
   2^18 records into a warm 1M-key keydict at 1 and at ``native_shards``
   threads, beside the numpy ``KeyIndex.lookup_or_insert`` of the same
   keys; ``apply_delta`` of a 1M-row delta column into a pane whose pages
   are fresh and into one already touched; one fire sweep over 1M rows;
8. kernel phase, probe_fold: the fused probe + ordered fold
   (``csrc/probe_fold.cu``) at the fused lane's shapes — the same table, one
   flush of 8 staged batches of 2^18 records (the last one short, about 10%
   unseen keys) into f64/int32 delta planes of 2^20 x 16 cells with non-zero
   contents — must equal ``torch_probe_fold`` on CPU copies bit for bit; its
   median time (L2 flushed and warm, and split into its four steps: probe +
   tile histogram, offsets, stable partition by tile, ordered fold) is
   printed beside its bound, the plain version's time and the unfused
   route's (the probe kernel + ``index_add_``).  A skewed flush, one key on
   25% of the rows, is held to ``torch_probe_fold`` bit for bit too, and
   timed beside the uniform one (a check of the kernel, not a main path);
9. main paths 5 and 6, the device emit tier: path 5 is
   ``emit_tier="device"``, ``snapshot_source="device"``, scatter sync, one
   batch at a time, ``native_emit=True`` (the C keydict, no value mirror);
   path 6 is path 5 with ``async_fire=True`` and ``superbatch=8``.  Every
   batch folds into the f32 replica through ``scatter_fold``; a fire gathers
   the emitted rows on the card and downloads the values.  Every fire must
   equal, bit for bit, a numpy reference that folds the same records into
   f32 cells in record order (``np.add.at``); every fire must equal path 3's
   (same keys in the same order, values to rtol 1e-5: f32 against the f64
   mirror); path 6 must surface exactly path 5's fires, each at most one
   batch later.  Each is restored and replayed, with fires equal bit for
   bit;
10. kernel phase, scatter_fold: the ordered replica fold
   (``csrc/scatter_fold.cu``) at path 5's shapes — 2^18 int32 flat ids
   (about 2% dropped) into an f32 ``[2^20, 16]`` replica and int32 counts
   with non-zero contents, and a skewed batch with one key on 25% of the
   rows — must equal its plain version on CPU copies bit for bit; its
   median time (L2 flushed and warm, split into its four steps) is printed
   beside its bound, the plain version's time and the two ``index_add_``
   calls it replaces.

Each main path runs with every launch count set to 0 just before it and
read just after; the kernel line reports each kernel's launches on every
path (``launches_by_path``) and their sum (``launches``).  Then one JSON
line of kernel numbers, the nvidia-smi line, and, last,
``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

#: H100 SXM published peaks (NVIDIA data sheet) used for the bounds
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12          # non-tensor-core 32-bit rate
F64_OPS_PER_S = 34e12            # non-tensor-core f64 rate

N_KEYS = 1_000_000              # bench.py --keys default
KEY_CAPACITY = 1 << 20
BATCH = 1 << 18
WINDOW_MS = 5000
N_BATCHES = 40
SNAPSHOT_EVERY = 16
PANES = 16                      # the operator's pane ring at these windows
SUPERBATCH = 8
RTOL = 1e-6   # path 1's f64 atomics fold in no fixed order: ~1e-16 relative

#: the kernels of the main paths, built together in phase 2
SOURCES = ("probe.cu", "probe_fold.cu", "scatter_fold.cu")
#: the C host layer of paths 3 and 4, built beside them with g++
HOST_SOURCE = "host_mirror.cc"
#: host threads of the C probe + fold pass on paths 3 and 4 (pinned)
NATIVE_SHARDS = min(4, os.cpu_count() or 1)

#: the main paths: slice 1's per-batch scatter lane, slice 2's fused lane,
#: each of them on the C host layer (slice 4), and the device emit tier,
#: synchronous and async (slice 5)
DEVICE_TIER = dict(emit_tier="device", snapshot_source="device",
                   device_sync="scatter", native_emit=True)
PATHS = {
    "path 1": dict(device_sync="scatter", superbatch=1),
    "path 2": dict(device_sync="deferred", superbatch=SUPERBATCH),
    "path 3": dict(device_sync="scatter", superbatch=1, native_emit=True),
    "path 4": dict(device_sync="deferred", superbatch=SUPERBATCH,
                   native_emit=True),
    "path 5": dict(DEVICE_TIER, superbatch=1),
    "path 6": dict(DEVICE_TIER, superbatch=SUPERBATCH, async_fire=True),
}
#: each native path's numpy twin
TWIN = {"path 3": "path 1", "path 4": "path 2"}
#: the device-tier paths, and the host-tier path each is held to
DEVICE_PATHS = {"path 5": "path 3", "path 6": "path 3"}
#: run order: each numpy/C pair back to back, then the device tier
ORDER = ("path 1", "path 3", "path 2", "path 4", "path 5", "path 6")
#: device-tier fires against the host tier's f64 mirror
DEVICE_VS_HOST_RTOL = 1e-5


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def make_batches(n_records: int, n_keys: int, batch_size: int,
                 window_ms: int, seed: int = 7):
    """Copy of ``bench.py`` ``make_batches``: uniform keys, f32 values,
    event time advancing 1000 ms per batch."""
    rng = np.random.default_rng(seed)
    batches = []
    t = 0
    for lo in range(0, n_records, batch_size):
        b = min(batch_size, n_records - lo)
        keys = rng.integers(0, n_keys, b).astype(np.int64)
        vals = rng.random(b).astype(np.float32)
        ts = t + np.sort(rng.integers(0, 1000, b)).astype(np.int64)
        t += 1000
        batches.append((keys, vals, ts))
    return batches


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "-i", "0",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    check(res.returncode == 0, f"nvidia-smi failed: {res.stderr}")
    return res.stdout.strip()


def cuda_time_ms(fn, runs: int, flush=None) -> float:
    """Median ms of ``fn()`` over ``runs`` CUDA-event-timed calls (after two
    warm-up calls).  Before each call ``flush()`` (if given) evicts L2, and a
    ~1 ms spin keeps the stream busy, so the host's launch overhead is not
    inside the timed interval.  :func:`timing_floor_ms` is what the method
    reads for an empty kernel."""
    import torch
    for _ in range(2):
        fn()
    times = []
    for _ in range(runs):
        if flush is not None:
            flush()
        torch.cuda._sleep(2_000_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def l2_flushes(device):
    """Two ways to evict L2 before a timed call: ``dirty`` writes 256 MiB
    (the flush the earlier kernel times were taken with, so the timed
    kernel also writes back up to 50 MB of the flush's dirty lines), ``clean`` reads them (L2 then holds clean
    lines, and the time is the kernel's own traffic)."""
    import torch
    scratch = torch.empty(256 << 20, dtype=torch.uint8, device=device)
    return (lambda: scratch.fill_(1)), (lambda: scratch.sum())


def timing_floor_ms() -> float:
    """What :func:`cuda_time_ms` reads for an empty kernel (a one-cycle
    spin): the events' and the launch's own share of every time."""
    import torch
    return cuda_time_ms(lambda: torch.cuda._sleep(1), 20)


def probe_work(buckets, keys):
    """(probe steps, distinct buckets touched) this data needs: the same
    walk as the probe, counting bucket reads."""
    import torch

    from flink_tpu_torch.state import device_keyindex as dk
    cap = buckets.shape[0]
    pending = torch.arange(keys.shape[0], device=keys.device)
    idx = dk.torch_probe_starts(keys, cap)
    steps = 0
    touched = torch.zeros(cap, dtype=torch.bool, device=keys.device)
    while pending.numel():
        steps += pending.numel()
        touched[idx] = True
        rows = buckets[idx]
        empty = rows[:, 2] == 0
        hit = ~empty & (dk.bucket_keys(rows) == keys[pending])
        go_on = ~(hit | empty)
        pending = pending[go_on]
        idx = (idx[go_on] + 1) & (cap - 1)
    return steps, int(touched.sum())


def bound(bytes_: int, int_ops: int, f64_ops: int = 0):
    """(bound ms, "bytes" or "operations") for this work on the card."""
    by_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    by_ops = (int_ops / INT32_OPS_PER_S + f64_ops / F64_OPS_PER_S) * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                   else "operations"), by_bytes, by_ops


def build_kernels():
    """Phase 2: one nvcc per source and g++ for the host layer, started
    together, then load each."""
    from flink_tpu_torch.kernels import build
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES) + 1) as pool:
        list(pool.map(lambda f: f(), [lambda s=s: build.build(s)
                                      for s in SOURCES]
                      + [lambda: build.build_host(HOST_SOURCE)]))
    build.probe_lib()
    build.probe_fold_lib()
    build.scatter_fold_lib()
    host = build.host_mirror_lib()
    print(f"build: {', '.join(SOURCES)}, {HOST_SOURCE} in "
          f"{time.perf_counter() - t0:.2f} s wall (nvcc " + ", ".join(
              f"{s} {build.build_seconds.get(s, 0.0):.2f} s"
              for s in SOURCES) + f"; g++ {HOST_SOURCE} "
          f"{build.build_seconds.get(HOST_SOURCE, 0.0):.2f} s)")
    print(f"host layer: ftt_hw_threads() = {host.ftt_hw_threads()}, "
          f"os.cpu_count() = {os.cpu_count()}, native_shards = "
          f"{NATIVE_SHARDS} on paths 3 and 4")
    for s in SOURCES:
        print(f"ptxas {s}: " + build.ptxas_report.get(s, "(cached)")
              .replace("\n", " | "))


def load_table(device, rng):
    """A device table of N_KEYS keys at capacity 2^21, and its KeyIndex."""
    from flink_tpu_torch.state import device_keyindex as dk
    from flink_tpu_torch.state.keyindex import KeyIndex

    ki = KeyIndex(initial_capacity=2 * KEY_CAPACITY)
    ki.lookup_or_insert(rng.permutation(N_KEYS).astype(np.int64))
    dki = dk.DeviceKeyIndex(initial_capacity=2 * KEY_CAPACITY, device=device)
    dki.ensure_loaded(ki)
    check(dki.capacity == 2 * KEY_CAPACITY, f"table capacity {dki.capacity}")
    return ki, dki


#: int32 operations a record spends on the hash: 9 uint64 operations
#: (3 shifts, 3 xors, 2 multiplies, 1 and), counted as 2 each
HASH_OPS = 18


def kernel_phase(device, rng, ki, dki):
    import torch

    from flink_tpu_torch.state import device_keyindex as dk

    keys = rng.integers(0, N_KEYS, BATCH).astype(np.int64)
    unseen = rng.random(BATCH) < 0.1
    keys[unseen] = rng.integers(N_KEYS, 1 << 40, int(unseen.sum()))
    kt = torch.from_numpy(keys).to(device)
    buckets = dki.buckets

    got = dk.probe(buckets, kt)
    torch.cuda.synchronize()
    want = dk.torch_probe(buckets, kt)
    check(torch.equal(got, want), "probe kernel != torch_probe")
    check(np.array_equal(got.cpu().numpy(), ki.lookup(keys)),
          "probe kernel != KeyIndex.lookup")
    max_abs_err = int((got.long() - want.long()).abs().max())

    dirty, clean = l2_flushes(device)
    ms_cold = cuda_time_ms(lambda: dk.probe(buckets, kt), 20, flush=dirty)
    ms_clean = cuda_time_ms(lambda: dk.probe(buckets, kt), 20, flush=clean)
    ms_warm = cuda_time_ms(lambda: dk.probe(buckets, kt), 20)
    floor_ms = timing_floor_ms()
    plain_ms = cuda_time_ms(lambda: dk.torch_probe(buckets, kt), 5)
    del dirty, clean
    steps, touched = probe_work(buckets, kt)
    # the key streams in (8 B) and the slot out (4 B); each touched bucket's
    # key words and slot (12 B) are read once, whatever the layout stores
    bytes_ = 12 * BATCH + 12 * touched
    old_bytes = 16 * BATCH + 12 * touched   # key_lo, key_hi, start in
    ops = 6 * steps + HASH_OPS * BATCH     # 3 compares, 2 ands, 1 step add
    bound_ms, bound_by, bound_bytes_ms, bound_ops_ms = bound(bytes_, ops)
    print(f"probe kernel: cap={dki.capacity} B={BATCH} "
          f"unseen={int(unseen.sum())} hits={int((got >= 0).sum())}")
    print(f"probe kernel: median {ms_cold:.4f} ms with L2 flushed, "
          f"{ms_clean:.4f} ms after a read-only flush, {ms_warm:.4f} ms warm "
          f"(20 runs each); timing floor (an empty kernel) {floor_ms:.4f} ms; "
          f"plain torch_probe {plain_ms:.4f} ms")
    print(f"probe bound: bytes = 12 B/record x {BATCH} + 12 B x {touched} "
          f"distinct buckets touched = {bytes_} B over "
          f"{HBM_BYTES_PER_S:.3g} B/s = {bound_bytes_ms:.5f} ms (the "
          f"three-plane interface's 16 B/record: {old_bytes} B = "
          f"{old_bytes / HBM_BYTES_PER_S * 1e3:.5f} ms); ops = 6 x {steps} "
          f"probe steps + {HASH_OPS} x {BATCH} hashes over "
          f"{INT32_OPS_PER_S:.3g}/s = {bound_ops_ms:.6f} ms; bound by "
          f"{bound_by}")
    print("probe library_ms: null — PyTorch has no single call that probes "
          "an open-addressing hash table")
    return {"name": "probe", "route": "cuda",
            "source": "flink_tpu_torch/csrc/probe.cu",
            "replaces": "flink_tpu/state/device_keyindex.py:139",
            "launches": 0, "max_abs_err": max_abs_err,
            "ms": ms_cold, "ms_clean_l2": ms_clean, "ms_warm": ms_warm,
            "timing_floor_ms": floor_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_bytes": bytes_, "old_bound_bytes": old_bytes,
            "library_ms": None}


def make_flush(rng, device, hot_key=None):
    """One flush of the fused lane at the main path's shapes: 8 staged
    batches of 2^18 records (the last one 4096 short), ~10% unseen keys,
    pane slots of 5000 ms panes in a 16-pane ring, f32 values.  With
    ``hot_key``, that key takes 25% of the rows (the skewed flush)."""
    import torch
    keys, panes, vals = [], [], []
    for i in range(SUPERBATCH):
        b = BATCH - (4096 if i == SUPERBATCH - 1 else 0)
        k = rng.integers(0, N_KEYS, b).astype(np.int64)
        unseen = rng.random(b) < 0.1
        k[unseen] = rng.integers(N_KEYS, 1 << 40, int(unseen.sum()))
        if hot_key is not None:
            k[rng.random(b) < 0.25] = hot_key
        ts = i * 1000 + np.sort(rng.integers(0, 1000, b)).astype(np.int64)
        keys.append(k)
        panes.append((ts // WINDOW_MS % PANES).astype(np.int32))
        vals.append(rng.random(b).astype(np.float32))
    return [torch.from_numpy(np.concatenate(a)).to(device)
            for a in (keys, panes, vals)]


def split_ms(steps, launch, runs: int, flush=None):
    """Median ms of each of a kernel's ``steps`` (name -> bit of its steps
    mask), each between CUDA events: ``launch(bit)`` runs one step."""
    import torch
    times = []
    for r in range(runs + 2):
        if flush is not None:
            flush()
        torch.cuda._sleep(2_000_000)
        ev = [torch.cuda.Event(enable_timing=True)
              for _ in range(len(steps) + 1)]
        ev[0].record()
        for i, step in enumerate(steps.values()):
            launch(step)
            ev[i + 1].record()
        ev[-1].synchronize()
        if r >= 2:
            times.append([ev[i].elapsed_time(ev[i + 1])
                          for i in range(len(steps))])
    med = np.median(np.asarray(times), axis=0)
    return {name: float(t) for name, t in zip(steps, med)}


def probe_fold_split_ms(buckets, keys, panes, vals, ds, dc, runs: int,
                        flush=None):
    """Median ms of probe_fold's four steps (probe + tile histogram,
    offsets, partition, fold): the wrapper's launches, made one step at a
    time."""
    import torch

    from flink_tpu_torch.state import device_keyindex as dk
    n = int(keys.shape[0])
    slot = torch.empty(n, dtype=torch.int32, device=keys.device)
    scratch = dk.probe_fold_scratch(n, int(ds.shape[0]), vals)
    return split_ms(dk.FOLD_STEPS, lambda step: dk.launch_probe_fold_steps(
        buckets, keys, panes, n, vals, ds, dc, PANES, slot, scratch, step),
        runs, flush)


def _fold_check(device, buckets, flush_t, dsum0, dcnt0, label):
    """One probe_fold on the card against torch_probe_fold on CPU copies,
    bit for bit; returns (max abs errors, the plain version's slots, the
    most rows folded into one cell)."""
    import torch

    from flink_tpu_torch.state import device_keyindex as dk
    keys, panes, vals = flush_t
    R = int(keys.shape[0])
    ds, dc = dsum0.to(device, copy=True), dcnt0.to(device, copy=True)
    slot, ds, dc = dk.probe_fold(buckets, keys, panes, R, vals, ds, dc, PANES)
    torch.cuda.synchronize()
    wslot, ws, wc = dk.torch_probe_fold(
        buckets.cpu(), keys.cpu(), panes.cpu(), R, vals.cpu(), dsum0.clone(),
        dcnt0.clone(), PANES)
    got_slot, got_sum, got_cnt = slot.cpu(), ds.cpu(), dc.cpu()
    errs = {"slot": int((got_slot.long() - wslot.long()).abs().max()),
            "dcnt": int((got_cnt.long() - wc.long()).abs().max()),
            "dsum": float((got_sum - ws).abs().max())}
    check(max(errs.values()) == 0, f"probe_fold kernel != torch_probe_fold "
          f"on the {label} flush: max abs errors {errs}")
    check(torch.equal(got_sum.view(torch.int64), ws.view(torch.int64)),
          f"probe_fold dsum differs from torch_probe_fold in its bits on "
          f"the {label} flush")
    return errs, wslot, (wc.long() - dcnt0.long()).max().item()


def _steps(split) -> str:
    return " + ".join(f"{k} {v:.4f}" for k, v in split.items())


def probe_fold_phase(device, rng, dki):
    import torch

    from flink_tpu_torch.ops.scatter import scatter_fold_counts
    from flink_tpu_torch.state import device_keyindex as dk

    buckets = dki.buckets
    keys, panes, vals = flush_t = make_flush(rng, device)
    R = int(vals.shape[0])
    n_cells = KEY_CAPACITY * PANES
    gen = torch.Generator().manual_seed(11)
    dsum0 = torch.rand(n_cells, dtype=torch.float64, generator=gen)
    dcnt0 = torch.randint(0, 5, (n_cells,), dtype=torch.int32, generator=gen)

    errs, wslot, _ = _fold_check(device, buckets, flush_t, dsum0, dcnt0,
                                 "uniform")
    hits = int((wslot >= 0).sum())
    flat_hit = (wslot.long() * PANES + panes.cpu().long())[wslot >= 0]
    cells = int(torch.unique(flat_hit).numel())
    hot_key = int(N_KEYS // 3)
    skew_t = make_flush(rng, device, hot_key=hot_key)
    skew_errs, _, hot_run = _fold_check(device, buckets, skew_t, dsum0,
                                        dcnt0, "skewed")

    ds, dc = dsum0.to(device, copy=True), dcnt0.to(device, copy=True)
    flush, clean = l2_flushes(device)
    run = lambda: dk.probe_fold(buckets, keys, panes, R,  # noqa: E731
                                vals, ds, dc, PANES)
    ms_cold = cuda_time_ms(run, 20, flush=flush)
    ms_clean = cuda_time_ms(run, 20, flush=clean)
    ms_warm = cuda_time_ms(run, 20)
    split_cold = probe_fold_split_ms(buckets, keys, panes, vals, ds, dc, 20,
                                     flush)
    split_warm = probe_fold_split_ms(buckets, keys, panes, vals, ds, dc, 20)
    skew_ms = cuda_time_ms(lambda: dk.probe_fold(
        buckets, skew_t[0], skew_t[1], R, skew_t[2], ds, dc, PANES), 10,
        flush=flush)
    skew_split = probe_fold_split_ms(buckets, *skew_t, ds, dc, 10, flush)

    def unfused():
        s = dk.probe(buckets, keys)
        f = torch.where(s >= 0, s.long() * PANES + panes, n_cells)
        scatter_fold_counts((ds,), dc, f, (vals,), ("add",))

    unfused_ms = cuda_time_ms(unfused, 20, flush=flush)
    plain_ms = cuda_time_ms(lambda: dk.torch_probe_fold(
        buckets, keys, panes, R, vals, ds, dc, PANES), 5)
    del flush, clean
    steps, touched = probe_work(buckets, keys)
    # rows stream in (key, pane slot, value) and out (slot); each touched
    # bucket's key words and slot are read once; each touched cell's dsum
    # and dcnt are read and written once
    bytes_ = 20 * R + 12 * touched + 24 * cells
    old_bytes = 24 * R + 12 * touched + 24 * cells
    bound_ms, bound_by, bound_bytes_ms, bound_ops_ms = bound(
        bytes_, 6 * steps + HASH_OPS * R + hits, hits)
    bits, tiles, blocks = dk.fold_plan(R, n_cells)
    print(f"probe_fold kernel: cap={dki.capacity} R={R} rows "
          f"({SUPERBATCH} batches), hits={hits}, distinct cells={cells}, "
          f"planes {n_cells} cells f64 + int32 in {tiles} tiles of "
          f"2^{bits} cells, {blocks} row blocks; max abs err {errs}")
    print(f"probe_fold kernel: median {ms_cold:.4f} ms with L2 flushed "
          f"({_steps(split_cold)}), {ms_clean:.4f} ms after a read-only "
          f"flush, {ms_warm:.4f} ms warm ({_steps(split_warm)}); 20 runs "
          f"each")
    print(f"probe_fold skewed flush (key {hot_key} on 25% of the rows, its "
          f"longest cell run {hot_run} rows; max abs err {skew_errs}): "
          f"median {skew_ms:.4f} ms with L2 flushed ({_steps(skew_split)}; 10 "
          f"runs) vs the uniform flush's {ms_cold:.4f} ms")
    print(f"probe_fold plain torch_probe_fold on the card {plain_ms:.4f} ms; "
          f"unfused route (probe kernel + index_add_, f64 atomics in no "
          f"fixed order) {unfused_ms:.4f} ms with L2 flushed")
    print(f"probe_fold bound: bytes = 20 B/row x {R} + 12 B x {touched} "
          f"buckets + 24 B x {cells} cells = {bytes_} B over "
          f"{HBM_BYTES_PER_S:.3g} B/s = {bound_bytes_ms:.5f} ms (the "
          f"three-plane interface's 24 B/row: {old_bytes} B = "
          f"{old_bytes / HBM_BYTES_PER_S * 1e3:.5f} ms); ops = "
          f"{6 * steps + HASH_OPS * R + hits} int32 + {hits} f64 = "
          f"{bound_ops_ms:.6f} ms; bound by {bound_by}")
    print("probe_fold library_ms: null — no single PyTorch call probes a "
          "hash table and folds; the unfused route above is two calls and "
          "its float fold is unordered")
    return {"name": "probe_fold", "route": "cuda",
            "source": "flink_tpu_torch/csrc/probe_fold.cu",
            "replaces": "flink_tpu/state/device_keyindex.py:228",
            "launches": 0, "max_abs_err": max(errs.values()),
            "ms": ms_cold, "ms_clean_l2": ms_clean, "ms_warm": ms_warm,
            "split_ms": split_cold, "split_ms_warm": split_warm,
            "skewed_ms": skew_ms, "skewed_split_ms": skew_split,
            "plain_ms": plain_ms, "unfused_ms": unfused_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_bytes": bytes_, "old_bound_bytes": old_bytes,
            "library_ms": None}


def make_replica_batch(rng, device, hot_key=None):
    """One batch of path 5's update step: 2^18 int32 flat ids ``slot * 16 +
    pane slot`` of uniform keys into the ``[2^20, 16]`` replica, about 2% of
    them the dropped id, f32 values.  With ``hot_key``, that key takes 25% of
    the rows (the skewed batch)."""
    import torch
    n_cells = KEY_CAPACITY * PANES
    slots = rng.integers(0, N_KEYS, BATCH)
    if hot_key is not None:
        slots[rng.random(BATCH) < 0.25] = hot_key
    ids = slots * PANES + rng.integers(2, 4, BATCH)      # two live panes
    ids[rng.random(BATCH) < 0.02] = n_cells
    vals = rng.random(BATCH).astype(np.float32)
    return [torch.from_numpy(a).to(device)
            for a in (ids.astype(np.int32), vals)]


def _scatter_fold_check(device, batch, plane0, counts0, label):
    """One ``ordered_fold_counts`` on the card against its plain version on
    CPU copies, bit for bit; returns (max abs errors, rows folded, distinct
    cells touched, the longest run of one cell)."""
    import torch

    from flink_tpu_torch.ops import scatter as sc
    ids, vals = batch
    plane, counts = plane0.to(device, copy=True), counts0.to(device, copy=True)
    sc.ordered_fold_counts((plane,), counts, ids, (vals,), ("add",))
    torch.cuda.synchronize()
    (want,), want_c = sc.scatter_fold_counts(
        (plane0.clone(),), counts0.clone(), ids.cpu(), (vals.cpu(),),
        ("add",))
    got, got_c = plane.cpu(), counts.cpu()
    errs = {"plane": float((got - want).abs().max()),
            "counts": int((got_c.long() - want_c.long()).abs().max())}
    check(max(errs.values()) == 0 and torch.equal(
        got.view(torch.int32), want.view(torch.int32)),
        f"scatter_fold kernel != its plain version on the {label} batch: "
        f"max abs errors {errs}")
    added = want_c.long() - counts0.long()
    return (errs, int(added.sum()), int((added > 0).sum()),
            int(added.max()))


def scatter_fold_split_ms(batch, plane, counts, runs: int, flush=None):
    """Median ms of scatter_fold's four steps (ids + tile histogram,
    offsets, partition, fold)."""
    from flink_tpu_torch.ops import scatter as sc
    ids, vals = batch
    scratch = sc.fold_scratch(int(ids.shape[0]), int(plane.shape[0]), 4,
                              ids.device)
    return split_ms(sc.SCATTER_FOLD_STEPS, lambda step:
                    sc.launch_ordered_fold_steps(ids, vals, plane, counts,
                                                 scratch, step), runs, flush)


def scatter_fold_phase(device, rng):
    import torch

    from flink_tpu_torch.ops import scatter as sc
    n_cells = KEY_CAPACITY * PANES
    gen = torch.Generator().manual_seed(13)
    plane0 = torch.rand(n_cells, dtype=torch.float32, generator=gen) * 100
    counts0 = torch.randint(0, 5, (n_cells,), dtype=torch.int32,
                            generator=gen)
    batch = make_replica_batch(rng, device)
    errs, rows, cells, _ = _scatter_fold_check(device, batch, plane0,
                                               counts0, "uniform")
    hot_key = int(N_KEYS // 3)
    skew = make_replica_batch(rng, device, hot_key=hot_key)
    skew_errs, _, _, hot_run = _scatter_fold_check(device, skew, plane0,
                                                   counts0, "skewed")

    ids, vals = batch
    plane, counts = plane0.to(device), counts0.to(device)
    flush, clean = l2_flushes(device)
    run = lambda: sc.ordered_fold_counts(  # noqa: E731
        (plane,), counts, ids, (vals,), ("add",))
    ms_cold = cuda_time_ms(run, 20, flush=flush)
    ms_clean = cuda_time_ms(run, 20, flush=clean)
    ms_warm = cuda_time_ms(run, 20)
    split_cold = scatter_fold_split_ms(batch, plane, counts, 20, flush)
    split_warm = scatter_fold_split_ms(batch, plane, counts, 20)
    skew_ms = cuda_time_ms(lambda: sc.ordered_fold_counts(
        (plane,), counts, skew[0], (skew[1],), ("add",)), 10, flush=flush)
    plain_ms = cuda_time_ms(lambda: sc.scatter_fold_counts(
        (plane,), counts, ids, (vals,), ("add",)), 20, flush=flush)
    # the library route: the two index_add_ calls alone, on ids already
    # cleared of the dropped id (what the plain version spends around them
    # is not counted)
    keep = ids < n_cells
    lib_ids = ids[keep].long()
    lib_vals, lib_ones = vals[keep], torch.ones_like(lib_ids,
                                                     dtype=torch.int32)

    def library():
        plane.index_add_(0, lib_ids, lib_vals)
        counts.index_add_(0, lib_ids, lib_ones)

    library_ms = cuda_time_ms(library, 20, flush=flush)
    del flush, clean
    # ids and values stream in (4 + 4 B a row); each touched cell of the
    # replica and the counts is read and written once (4 + 4 B each way)
    bytes_ = 8 * BATCH + 16 * cells
    bound_ms, bound_by, bound_bytes_ms, bound_ops_ms = bound(bytes_,
                                                             2 * rows)
    bits, tiles, blocks = sc.fold_plan(BATCH, n_cells)
    print(f"scatter_fold kernel: {BATCH} rows ({BATCH - rows} dropped) into "
          f"an f32 replica and int32 counts of {n_cells} cells "
          f"({cells} touched) in {tiles} tiles of 2^{bits} cells, {blocks} "
          f"row blocks; max abs err {errs}")
    print(f"scatter_fold kernel: median {ms_cold:.4f} ms with L2 flushed "
          f"({_steps(split_cold)}), {ms_clean:.4f} ms after a read-only "
          f"flush, {ms_warm:.4f} ms warm ({_steps(split_warm)}); 20 runs "
          f"each")
    print(f"scatter_fold skewed batch (key {hot_key} on 25% of the rows, its "
          f"longest cell run {hot_run} rows; max abs err {skew_errs}): "
          f"median {skew_ms:.4f} ms with L2 flushed (10 runs)")
    print(f"scatter_fold plain version (scatter_fold_counts on the card: "
          f"identity rewrite + index_add_ x2) {plain_ms:.4f} ms; library "
          f"route (index_add_ x2, f32 atomics in no fixed order) "
          f"{library_ms:.4f} ms; both with L2 flushed")
    print(f"scatter_fold bound: bytes = 8 B/row x {BATCH} + 16 B x {cells} "
          f"cells = {bytes_} B over {HBM_BYTES_PER_S:.3g} B/s = "
          f"{bound_bytes_ms:.5f} ms; ops = {2 * rows} adds = "
          f"{bound_ops_ms:.6f} ms; bound by {bound_by}")
    return {"name": "scatter_fold", "route": "cuda",
            "source": "flink_tpu_torch/csrc/scatter_fold.cu",
            "replaces": "flink_tpu/ops/scatter.py:61 (scatter_fold_counts, "
                        "an XLA scatter; no Pallas kernel)",
            "launches": 0, "max_abs_err": max(errs.values()),
            "ms": ms_cold, "ms_clean_l2": ms_clean, "ms_warm": ms_warm,
            "split_ms": split_cold, "split_ms_warm": split_warm,
            "skewed_ms": skew_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_bytes": bytes_, "library_ms": library_ms}


def check_async(fired, sync, label, ref):
    """An async path surfaces exactly the synchronous path's fires, in the
    same order and bit for bit, each at most one batch later."""
    check(len(fired) == len(sync), f"{label}: {len(fired)} fires, {ref} "
          f"{len(sync)}")
    lag = []
    for (ia, a), (ib, b) in zip(fired, sync):
        w = int(a.column("window_start")[0])
        check(w == int(b.column("window_start")[0])
              and np.asarray(a.column("k")).tobytes()
              == np.asarray(b.column("k")).tobytes()
              and np.asarray(a.column("result")).tobytes()
              == np.asarray(b.column("result")).tobytes(),
              f"{label} window {w}: differs from {ref}'s fire")
        lag.append(ia - ib)
    check(all(0 <= d <= 1 for d in lag), f"{label}: fires surfaced {lag} "
          f"batches after {ref}'s")
    print(f"{label} surfaces {ref}'s {len(sync)} fires bit for bit: "
          f"{lag.count(1)} one batch later, {lag.count(0)} in the same batch")


def host_ms(fn, runs: int = 5, setup=None) -> float:
    """Median host wall ms of ``fn()`` over ``runs`` calls, each after
    ``setup()`` if given (untimed)."""
    times = []
    for _ in range(runs):
        if setup is not None:
            setup()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def host_layer_phase(rng):
    """Phase 7b: the C layer's calls timed alone on this host."""
    from flink_tpu_torch.core.functions import SumAggregator
    from flink_tpu_torch.state.keyindex import KeyIndex, NativeKeyIndex
    from flink_tpu_torch.state.native_mirror import NativeWindowMirror

    warm = rng.permutation(N_KEYS).astype(np.int64)
    keys = rng.integers(0, N_KEYS, BATCH).astype(np.int64)
    vals = rng.random(BATCH).astype(np.float32)
    panes = np.zeros(BATCH, np.int64)
    nki = NativeKeyIndex(initial_capacity=2 * KEY_CAPACITY)
    nm = NativeWindowMirror.create(nki, SumAggregator().acc_spec(), ("add",),
                                   (np.float64,))
    nm.probe_update(warm, np.zeros(N_KEYS, np.int64),
                    [np.zeros(N_KEYS, np.float32)])
    pass_ms = {s: host_ms(lambda s=s: nm.probe_update(keys, panes, [vals],
                                                      shards=s))
               for s in sorted({1, NATIVE_SHARDS})}
    ki = KeyIndex(initial_capacity=2 * KEY_CAPACITY)
    ki.lookup_or_insert(warm)
    numpy_ms = host_ms(lambda: ki.lookup_or_insert(keys))
    cnt = np.ones(N_KEYS, np.int64)
    col = rng.random(N_KEYS)
    fresh = iter(range(1000, 2000))
    pane = [0]
    fresh_ms = host_ms(lambda: nm.apply_delta(pane[0], cnt, [col]),
                       setup=lambda: pane.__setitem__(0, next(fresh)))
    touched_ms = host_ms(lambda: nm.apply_delta(0, cnt, [col]))
    fire_ms = host_ms(lambda: nm.fire(np.zeros(1, np.int64)))
    print(f"host layer: probe + mirror pass over {BATCH} records into a "
          f"warm {N_KEYS}-key keydict: " + ", ".join(
              f"{v:.3f} ms at {k} shard(s)" for k, v in pass_ms.items())
          + f"; numpy KeyIndex.lookup_or_insert of the same keys "
          f"{numpy_ms:.3f} ms (no mirror fold)")
    print(f"host layer: apply_delta of {N_KEYS} rows into a fresh pane "
          f"{fresh_ms:.3f} ms, into a touched pane {touched_ms:.3f} ms; one "
          f"fire sweep over {N_KEYS} rows {fire_ms:.3f} ms")


def build_op(device, device_sync: str, superbatch: int,
             native_emit: bool = False, **tier):
    """The operator of a path; ``tier`` sets the emit tier, the snapshot
    source and async_fire (the host tier's mirror-sourced defaults
    otherwise)."""
    import torch

    from flink_tpu_torch.core.functions import RuntimeContext, SumAggregator
    from flink_tpu_torch.operators.window_agg import WindowAggOperator
    from flink_tpu_torch.windowing.assigners import TumblingEventTimeWindows
    op = WindowAggOperator(
        TumblingEventTimeWindows.of(WINDOW_MS), SumAggregator(torch.float32),
        key_column="k", value_column="v", initial_key_capacity=KEY_CAPACITY,
        device_sync=device_sync, device_probe="on", superbatch=superbatch,
        native_emit=native_emit,
        native_shards=NATIVE_SHARDS if native_emit else 0, device=device,
        **{"emit_tier": "host", "snapshot_source": "mirror", **tier})
    op.open(RuntimeContext())
    return op


def digests(out):
    """(window start, rows, f64 sum of the results, hash of the keys' and
    results' bytes) per fire."""
    return [(int(b.column("window_start")[0]), len(b),
             float(np.asarray(b.column("result"), np.float64).sum()),
             hashlib.sha256(np.asarray(b.column("k")).tobytes()
                            + np.asarray(b.column("result")).tobytes())
             .hexdigest())
            for b in out]


def reference(batches):
    """Independent numpy reference: window start -> (f64 sums, counts) per
    key, a plain bincount over every record of the window."""
    expect = {}
    for keys, vals, ts in batches:
        starts = ts // WINDOW_MS * WINDOW_MS
        for w in np.unique(starts).tolist():
            m = starts == w
            sums, cnt = expect.setdefault(w, (np.zeros(N_KEYS),
                                              np.zeros(N_KEYS, np.int64)))
            sums += np.bincount(keys[m], weights=vals[m].astype(np.float64),
                                minlength=N_KEYS)
            cnt += np.bincount(keys[m], minlength=N_KEYS)
    return expect


def reference_f32(batches):
    """The device tier's bits, independently: window start -> f32 cells per
    key, each record added in record order (``np.add.at``); a tumbling
    window is one pane, so its fire is the cell itself."""
    cells = {}
    for keys, vals, ts in batches:
        starts = ts // WINDOW_MS * WINDOW_MS
        for w in np.unique(starts).tolist():
            m = starts == w
            np.add.at(cells.setdefault(w, np.zeros(N_KEYS, np.float32)),
                      keys[m], vals[m])
    return cells


def check_fires_bits(fired, cells, label):
    """Every fire's values equal the f32 reference bit for bit."""
    for b in fired:
        w = int(b.column("window_start")[0])
        res = np.asarray(b.column("result"))
        want = cells[w][np.asarray(b.column("k"))]
        check(res.dtype == np.float32 and np.array_equal(
            res.view(np.uint32), want.view(np.uint32)),
            f"{label} window {w}: results differ from the f32 ordered "
            f"reference in their bits ({int((res != want).sum())} rows, max "
            f"abs {np.max(np.abs(res - want))})")


def check_fires(fired, expect, label):
    """Every window fired once, with the reference's keys and sums."""
    starts = [int(b.column("window_start")[0]) for b in fired]
    check(starts == sorted(expect), f"{label}: fired windows {starts} != "
          f"reference {sorted(expect)}")
    for w, b in zip(starts, fired):
        sums, cnt = expect[w]
        keys = np.asarray(b.column("k"))
        check(np.array_equal(np.sort(keys), np.flatnonzero(cnt)),
              f"{label} window {w}: fired keys differ from the reference")
        res = np.asarray(b.column("result"))
        check(np.allclose(res, sums[keys], rtol=RTOL, atol=0),
              f"{label} window {w}: results differ from the reference (max "
              f"abs {np.max(np.abs(res - sums[keys]))})")


def check_twin(fired, twin, label, rtol=RTOL):
    """A path's fires against another's: the same windows, keys in the same
    (slot) order, values to ``rtol``."""
    check(len(fired) == len(twin), f"{label}: {len(fired)} fires, its twin "
          f"{len(twin)}")
    for a, b in zip(fired, twin):
        w = int(a.column("window_start")[0])
        check(w == int(b.column("window_start")[0])
              and np.array_equal(np.asarray(a.column("k")),
                                 np.asarray(b.column("k"))),
              f"{label} window {w}: keys differ from the numpy twin's")
        check(np.allclose(np.asarray(a.column("result")),
                          np.asarray(b.column("result")), rtol=rtol, atol=0),
              f"{label} window {w}: values differ from the numpy twin's")


def reset_launches() -> None:
    from flink_tpu_torch.ops import scatter as sc
    from flink_tpu_torch.state import device_keyindex as dk
    dk.probe.launches = 0
    dk.probe_fold.launches = 0
    sc.ordered_fold_counts.launches = 0


def read_launches():
    from flink_tpu_torch.ops import scatter as sc
    from flink_tpu_torch.state import device_keyindex as dk
    return {"probe": dk.probe.launches, "probe_fold": dk.probe_fold.launches,
            "scatter_fold": sc.ordered_fold_counts.launches}


def main_path(device, batches, expect, label):
    """Drive one main path with every launch count at 0 just before and
    read just after; returns (launches per kernel, first snapshot, digests
    of the fires after it, every fire with the batch it surfaced at, the
    path's numbers)."""
    import torch

    from flink_tpu_torch.core.batch import RecordBatch, Watermark

    op = build_op(device, **PATHS[label])
    device_tier = op.emit_tier == "device"
    fire_ms = []
    fired = []
    after_snap = []
    mid = None
    snaps, snap_d2h = 0, 0

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    for i, (keys, vals, ts) in enumerate(batches):
        out = op.process_batch(RecordBatch({"k": keys, "v": vals},
                                           timestamps=ts))
        pending = len(op._pending_fires)
        f0 = time.perf_counter()
        wm_out = op.process_watermark(Watermark(int(ts.max()) - 1))
        if wm_out or len(op._pending_fires) > pending:
            # a call that fired (or, async, started a fire's download)
            fire_ms.append((time.perf_counter() - f0) * 1e3)
        out += wm_out
        snapshot_now = (i + 1) % SNAPSHOT_EVERY == 0
        if snapshot_now:
            # async fires surface before the barrier
            out += op.prepare_snapshot_pre_barrier()
        fired += [(i, b) for b in out]
        if mid is not None:
            after_snap += out
        if snapshot_now:
            d0 = op.phase_bytes.get("d2h", 0)
            snap = op.snapshot_state()
            snaps += 1
            snap_d2h += op.phase_bytes.get("d2h", 0) - d0
            if mid is None:
                mid = (i, snap)
    f0 = time.perf_counter()
    tail = op.end_input()
    fire_ms.append((time.perf_counter() - f0) * 1e3)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = read_launches()
    fired += [(len(batches), b) for b in tail]
    after_snap += tail
    stats = op.device_probe_stats()
    fused = op.fused_stats()
    check_fires([b for _, b in fired], expect, label)
    native = bool(PATHS[label].get("native_emit")) and not device_tier
    check(op.native_mirror_active == native,
          f"{label}: native_mirror_active is {op.native_mirror_active}")
    if device_tier:
        check(stats["enabled"] == 0 and stats["probe_hits"] == 0,
              f"{label}: the device probe ran on the device tier")
        check(launches["scatter_fold"] > 0 and launches["probe"] == 0
              and launches["probe_fold"] == 0,
              f"{label}: launches {launches}; the device tier folds through "
              f"scatter_fold and launches neither TPU kernel")
        check("emit_mirror" in op.phase_ns and "probe" in op.phase_ns
              and "mirror" not in op.phase_ns,
              f"{label}: the device tier's phases are wrong: "
              f"{sorted(op.phase_ns)}")
        check(not op._pending_fires, f"{label}: fires left pending")
    else:
        check(stats["probe_hits"] > 0, f"{label}: the probe never hit")
        check(native or "probe_mirror" in op.phase_ns
              and "mirror" in op.phase_ns,
              f"{label}: the numpy lane's phases are missing")
        check(not native or "mirror" not in op.phase_ns,
              f"{label}: the C lane ran a numpy mirror fold")
        if PATHS[label]["superbatch"] > 1:
            check(launches["probe_fold"] > 0,
                  f"{label} never launched the probe_fold kernel")
            check(fused["scan_dispatches"] > 0, f"{label}: no one-step pass")
            check(fused["scan_steps"] > fused["scan_dispatches"],
                  f"{label}: the one-step passes covered one batch each")
        else:
            check(launches["probe"] > 0,
                  f"{label} never launched the probe kernel")
    check(fused["staged_pending"] == 0, f"{label}: batches left staged")
    check(op.verify_mirror(), f"{label}: device replica != host mirror")
    n_records = sum(len(b[0]) for b in batches)
    n_fires = len(fired)
    print(f"{label} {PATHS[label]}: {n_records} records in {elapsed:.3f} s "
          f"= {n_records / elapsed:.1f} records/s; {n_fires} windows "
          f"fired and matched the numpy reference (rtol {RTOL}); launches "
          f"{launches}; probe hits {stats['probe_hits']}, misses "
          f"{stats['probe_misses']}; native_mirror_active "
          f"{op.native_mirror_active}")
    if fused["scan_dispatches"] or fused["host_super_passes"]:
        print(f"{label} fused lane: {fused}" + (
            f"; scan depth {fused['scan_steps'] / fused['scan_dispatches']:.3f}"
            f" batches per one-step pass" if fused["scan_dispatches"]
            else ""))
    p50, p99 = np.percentile(fire_ms, 50), np.percentile(fire_ms, 99)
    print(f"{label} fire latency ms over {len(fire_ms)} firing calls: p50 "
          f"{p50:.3f} p99 {p99:.3f}")
    print(f"{label} phase_ns: " + json.dumps(op.phase_ns, sort_keys=True))
    print(f"{label} phase_bytes: " + json.dumps(op.phase_bytes,
                                                sort_keys=True))
    fire_d2h = op.phase_bytes.get("d2h", 0) - snap_d2h
    print(f"{label} d2h bytes: {fire_d2h / max(n_fires, 1):.0f} per fire "
          f"({n_fires} fires), {snap_d2h / max(snaps, 1):.0f} per snapshot "
          f"({snaps} snapshots)")
    print(f"{label} peak device memory: {torch.cuda.max_memory_allocated()} B")
    numbers = {"records_per_s": n_records / elapsed, "wall_s": elapsed,
               "fire_p50_ms": p50, "fire_p99_ms": p99,
               "d2h_per_fire": fire_d2h / max(n_fires, 1),
               "d2h_per_snapshot": snap_d2h / max(snaps, 1),
               "phase_ms": {k: v / 1e6 for k, v in op.phase_ns.items()}}
    return launches, mid, digests(after_snap), fired, numbers


def _replay_once(device, batches, mid, label, prof=None):
    """Restore ``mid`` into a fresh operator and replay the rest; returns
    (wall seconds, fired batches)."""
    import torch

    from flink_tpu_torch.core.batch import RecordBatch, Watermark

    i, snap = mid
    op = build_op(device, **PATHS[label])
    out = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with prof if prof is not None else contextlib.nullcontext():
        op.restore_state(snap)
        for keys, vals, ts in batches[i + 1:]:
            out += op.process_batch(RecordBatch({"k": keys, "v": vals},
                                                timestamps=ts))
            out += op.process_watermark(Watermark(int(ts.max()) - 1))
        out += op.end_input()
        torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def replay(device, batches, mid, want, label):
    """Restore + replay must give the run's digests.  The replay runs twice:
    plain (the digest check and the wall time), then under
    ``torch.profiler`` for the device's busy time — kernel and copy time
    summed over the trace — taken as a share of the plain run's wall time
    (the profiler's own host overhead would lengthen a profiled wall)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    wall, out = _replay_once(device, batches, mid, label)
    got = digests(out)
    check(len(got) == len(want) and len(got) > 0,
          f"{label} replay fired {len(got)} windows, the run {len(want)}")
    # the device tier folds in row order from the restored f32 cells, so
    # its replay is bit-equal; the host tier re-seeds its f64 mirror from
    # the snapshot's f32 cells, so its sums agree to 1e-6
    exact = label in DEVICE_PATHS
    for (w1, n1, s1, h1), (w2, n2, s2, h2) in zip(got, want):
        check(w1 == w2 and n1 == n2 and abs(s1 - s2) <= 1e-6 * max(abs(s2), 1)
              and (h1 == h2 or not exact),
              f"{label} replay digest {(w1, n1, s1, h1)} != "
              f"{(w2, n2, s2, h2)}")
    print(f"{label} restore+replay from batch {mid[0]}: {len(got)} window "
          f"digests equal" + (" bit for bit" if exact else "")
          + f"; wall {wall * 1e3:.3f} ms")
    prof = profile(activities=[ProfilerActivity.CUDA])
    _replay_once(device, batches, mid, label, prof)
    dev = sorted(((e.self_device_time_total, e.key)
                  for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and e.self_device_time_total > 0), reverse=True)
    busy_ms = sum(t for t, _ in dev) / 1e3
    share = busy_ms / (wall * 1e3)
    print(f"{label} replay device busy {busy_ms:.3f} ms of {wall * 1e3:.3f} "
          f"ms wall = {100 * share:.2f}% (idle {100 - 100 * share:.2f}%)")
    print(f"{label} replay top device ops (ms): " + "; ".join(
        f"{k[:60]} {t / 1e3:.3f}" for t, k in dev[:8]))


def main() -> None:
    try:
        import torch

        import flink_tpu_torch  # noqa: F401
    except ImportError as err:
        fail(f"cannot import the port ({err}): run from the repository root")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs a GPU")
    device = torch.device("cuda")
    card = card_line()
    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {card}")

    build_kernels()
    rng = np.random.default_rng(7)
    ki, dki = load_table(device, rng)
    kernels = [kernel_phase(device, rng, ki, dki)]
    batches = make_batches(N_BATCHES * BATCH, N_KEYS, BATCH, WINDOW_MS)
    expect = reference(batches)
    cells = reference_f32(batches)
    launches, fires, numbers = {}, {}, {}
    for label in ORDER:
        launches[label], mid, after, fires[label], numbers[label] = \
            main_path(device, batches, expect, label)
        check(mid is not None, f"{label}: no mid-run snapshot")
        plain = [b for _, b in fires[label]]
        if label in TWIN:
            check_twin(plain, [b for _, b in fires[TWIN[label]]], label)
            print(f"{label} fires equal {TWIN[label]}'s: same keys in the "
                  f"same order, values to rtol {RTOL}")
        if label in DEVICE_PATHS:
            check_fires_bits(plain, cells, label)
            host = DEVICE_PATHS[label]
            check_twin(plain, [b for _, b in fires[host]], label,
                       rtol=DEVICE_VS_HOST_RTOL)
            print(f"{label} fires equal the f32 ordered reference bit for "
                  f"bit, and {host}'s (same keys in the same order, values "
                  f"to rtol {DEVICE_VS_HOST_RTOL})")
        if label == "path 6":
            check_async(fires["path 6"], fires["path 5"], label, "path 5")
        replay(device, batches, mid, after, label)
        rest = ORDER[ORDER.index(label) + 1:]
        needed = ({TWIN.get(k) for k in rest}
                  | {DEVICE_PATHS.get(k) for k in rest}
                  | ({"path 5"} if "path 6" in rest else set()))
        for done in [k for k in fires if k not in needed]:
            del fires[done]
    del fires
    for label, twin in TWIN.items():
        a, b = numbers[label], numbers[twin]
        host = lambda n: sum(n["phase_ms"].get(k, 0.0)  # noqa: E731
                             for k in ("probe", "probe_mirror", "mirror"))
        print(f"A/B {label} (C layer) vs {twin} (numpy), same batches, one "
              f"process: records/s {a['records_per_s']:.1f} vs "
              f"{b['records_per_s']:.1f} ({a['records_per_s'] / b['records_per_s']:.3f}x); "
              f"probe/probe_mirror/mirror {host(a):.3f} vs {host(b):.3f} ms; "
              f"fire {a['phase_ms'].get('fire', 0.0):.3f} vs "
              f"{b['phase_ms'].get('fire', 0.0):.3f} ms (delta_sync "
              f"{a['phase_ms'].get('delta_sync', 0.0):.3f} vs "
              f"{b['phase_ms'].get('delta_sync', 0.0):.3f}); fire p50/p99 "
              f"{a['fire_p50_ms']:.3f}/{a['fire_p99_ms']:.3f} vs "
              f"{b['fire_p50_ms']:.3f}/{b['fire_p99_ms']:.3f} ms")
    for label, ref in (("path 5", "path 3"), ("path 6", "path 5")):
        a, b = numbers[label], numbers[ref]
        print(f"A/B {label} vs {ref}, same batches, one process: records/s "
              f"{a['records_per_s']:.1f} vs {b['records_per_s']:.1f} "
              f"({a['records_per_s'] / b['records_per_s']:.3f}x); fire "
              f"{a['phase_ms'].get('fire', 0.0):.3f} vs "
              f"{b['phase_ms'].get('fire', 0.0):.3f} ms; fire p50/p99 "
              f"{a['fire_p50_ms']:.3f}/{a['fire_p99_ms']:.3f} vs "
              f"{b['fire_p50_ms']:.3f}/{b['fire_p99_ms']:.3f} ms; d2h per "
              f"fire {a['d2h_per_fire']:.0f} vs {b['d2h_per_fire']:.0f} B, "
              f"per snapshot {a['d2h_per_snapshot']:.0f} vs "
              f"{b['d2h_per_snapshot']:.0f} B")
    host_layer_phase(rng)
    # the fused kernel's phase runs last: its 2M-row CPU check and large
    # host tensors would otherwise perturb the paths' host-bound timings
    kernels.append(probe_fold_phase(device, rng, dki))
    kernels.append(scatter_fold_phase(device, rng))
    for kernel in kernels:
        by_path = {label: launches[label][kernel["name"]] for label in ORDER}
        kernel["launches_by_path"] = by_path
        kernel["launches"] = sum(by_path.values())
    for label in ("path 1", "path 3"):
        check(launches[label]["probe"] > 0, f"{label}: no probe launch")
    for label in ("path 2", "path 4"):
        check(launches[label]["probe_fold"] > 0,
              f"{label}: no probe_fold launch")
    for label in DEVICE_PATHS:
        check(launches[label]["scatter_fold"] > 0,
              f"{label}: no scatter_fold launch")

    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": 1}}))


if __name__ == "__main__":
    main()
