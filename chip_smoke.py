#!/usr/bin/env python3
"""Chip smoke of flink_tpu_torch on one NVIDIA GPU (written for the H100).

    python3 chip_smoke.py

Phases, each fatal on failure (exit code 1, no result line):

1. the card's name and power limit, as nvidia-smi reports them;
2. build of every kernel of the port's main paths from
   ``flink_tpu_torch/csrc`` with nvcc (``sm_90a``), one nvcc per source, all
   started together;
3. kernel phase, probe: the device key probe (``csrc/probe.cu``) at the main
   path's shapes — a table of 1M keys at capacity 2^21, batches of 2^18
   records, about 10% of them unseen — must equal the plain ``torch_probe``
   exactly; its median time over CUDA-event-timed runs is printed beside its
   bound and the plain version's time;
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
8. kernel phase, probe_fold: the fused probe + ordered fold
   (``csrc/probe_fold.cu``) at the fused lane's shapes — the same table, one
   flush of 8 staged batches of 2^18 records (the last one short, about 10%
   unseen keys) into f64/int32 delta planes of 2^20 x 16 cells with non-zero
   contents — must equal ``torch_probe_fold`` on CPU copies bit for bit; its
   median time (L2 flushed and warm, and split into probe, sort and fold) is
   printed beside its bound, the plain version's time and the unfused
   route's (the probe kernel + ``index_add_``).

Each main path runs with every launch count set to 0 just before it and
read just after; the kernel line reports the probe's launches from path 1
and probe_fold's from path 2.  Then one JSON line of kernel numbers, the
nvidia-smi line, and, last, ``{"ok": true, "device": {...}}``.  Imports
nothing of JAX.
"""

from __future__ import annotations

import contextlib
import json
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
SOURCES = ("probe.cu", "probe_fold.cu")

#: the two main paths: slice 1's per-batch scatter lane, slice 2's fused lane
PATHS = {
    "path 1": dict(device_sync="scatter", superbatch=1),
    "path 2": dict(device_sync="deferred", superbatch=SUPERBATCH),
}


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
    inside the timed interval."""
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


def probe_work(tab_slot1, tab_lo, tab_hi, key_lo, key_hi, start):
    """(probe steps, distinct buckets touched) this data needs: the same
    walk as the probe, counting bucket reads."""
    import torch
    cap = tab_slot1.shape[0]
    pending = torch.arange(start.shape[0], device=start.device)
    idx = start.long()
    steps = 0
    touched = torch.zeros(cap, dtype=torch.bool, device=start.device)
    while pending.numel():
        steps += pending.numel()
        touched[idx] = True
        b_s = tab_slot1[idx]
        hit = (b_s != 0) & (tab_lo[idx] == key_lo[pending]) \
            & (tab_hi[idx] == key_hi[pending])
        go_on = ~(hit | (b_s == 0))
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
    """Phase 2: one nvcc per source, started together, then load each."""
    from flink_tpu_torch.kernels import build
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        list(pool.map(build.build, SOURCES))
    build.probe_lib()
    build.probe_fold_lib()
    print(f"build: {', '.join(SOURCES)} in {time.perf_counter() - t0:.2f} s "
          f"wall (nvcc " + ", ".join(
              f"{s} {build.build_seconds.get(s, 0.0):.2f} s"
              for s in SOURCES) + ")")
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


def kernel_phase(device, rng, ki, dki):
    import torch

    from flink_tpu_torch.state import device_keyindex as dk

    keys = rng.integers(0, N_KEYS, BATCH).astype(np.int64)
    unseen = rng.random(BATCH) < 0.1
    keys[unseen] = rng.integers(N_KEYS, 1 << 40, int(unseen.sum()))
    planes = [torch.from_numpy(a).to(device) for a in dki.prepare_batch(keys)]
    tab = dki.table()

    got = dk.probe(*tab, *planes)
    torch.cuda.synchronize()
    want = dk.torch_probe(*tab, *planes)
    check(torch.equal(got, want), "probe kernel != torch_probe")
    check(np.array_equal(got.cpu().numpy(), ki.lookup(keys)),
          "probe kernel != KeyIndex.lookup")
    max_abs_err = int((got.long() - want.long()).abs().max())

    scratch = torch.empty(256 << 20, dtype=torch.uint8, device=device)
    ms_cold = cuda_time_ms(lambda: dk.probe(*tab, *planes), 20,
                           flush=lambda: scratch.fill_(1))
    ms_warm = cuda_time_ms(lambda: dk.probe(*tab, *planes), 20)
    plain_ms = cuda_time_ms(lambda: dk.torch_probe(*tab, *planes), 5)
    del scratch
    steps, touched = probe_work(tab[2], tab[0], tab[1], *planes)
    bytes_ = 16 * BATCH + 12 * touched     # stream in/out + table words read
    ops = 6 * steps                        # 3 compares, 2 ands, 1 step add
    bound_ms, bound_by, bound_bytes_ms, bound_ops_ms = bound(bytes_, ops)
    print(f"probe kernel: cap={dki.capacity} B={BATCH} "
          f"unseen={int(unseen.sum())} hits={int((got >= 0).sum())}")
    print(f"probe kernel: median {ms_cold:.4f} ms with L2 flushed, "
          f"{ms_warm:.4f} ms warm (20 runs each); plain torch_probe "
          f"{plain_ms:.4f} ms")
    print(f"probe bound: bytes = 16 B/record x {BATCH} + 12 B x {touched} "
          f"distinct buckets touched = {bytes_} B over "
          f"{HBM_BYTES_PER_S:.3g} B/s = {bound_bytes_ms:.4f} ms; "
          f"ops = 6 x {steps} probe steps over {INT32_OPS_PER_S:.3g}/s = "
          f"{bound_ops_ms:.6f} ms; bound by {bound_by}")
    print("probe library_ms: null — PyTorch has no single call that probes "
          "an open-addressing hash table")
    return {"name": "probe", "route": "cuda",
            "source": "flink_tpu_torch/csrc/probe.cu",
            "replaces": "flink_tpu/state/device_keyindex.py:139",
            "launches": 0, "max_abs_err": max_abs_err,
            "ms": ms_cold, "ms_warm": ms_warm, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


def make_flush(rng, dki, device):
    """One flush of the fused lane at the main path's shapes: 8 staged
    batches of 2^18 records (the last one 4096 short), ~10% unseen keys,
    pane slots of 5000 ms panes in a 16-pane ring, f32 values."""
    import torch
    keys, panes, vals = [], [], []
    for i in range(SUPERBATCH):
        b = BATCH - (4096 if i == SUPERBATCH - 1 else 0)
        k = rng.integers(0, N_KEYS, b).astype(np.int64)
        unseen = rng.random(b) < 0.1
        k[unseen] = rng.integers(N_KEYS, 1 << 40, int(unseen.sum()))
        ts = i * 1000 + np.sort(rng.integers(0, 1000, b)).astype(np.int64)
        keys.append(k)
        panes.append((ts // WINDOW_MS % PANES).astype(np.int32))
        vals.append(rng.random(b).astype(np.float32))
    keys = np.concatenate(keys)
    planes = [torch.from_numpy(a).to(device) for a in
              (*dki.prepare_batch(keys), np.concatenate(panes))]
    return planes, torch.from_numpy(np.concatenate(vals)).to(device)


def probe_fold_split_ms(tab, planes, vals, ds, dc, runs: int, flush=None):
    """Median ms of probe_fold's three steps (probe kernel, stable sort,
    fold kernel), each between CUDA events: the wrapper's steps, called
    one by one."""
    import torch

    from flink_tpu_torch.kernels.build import probe_fold_lib
    lib = probe_fold_lib()
    n = int(planes[0].shape[0])
    slot = torch.empty_like(planes[0])
    flat = torch.empty(n, dtype=torch.int64, device=vals.device)
    stream = torch.cuda.current_stream().cuda_stream
    times = []
    for r in range(runs + 2):
        if flush is not None:
            flush()
        torch.cuda._sleep(2_000_000)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        rc = lib.flink_probe_fold_probe(
            *(t.data_ptr() for t in (*tab, *planes)), slot.data_ptr(),
            flat.data_ptr(), n, n, int(tab[2].shape[0]), PANES,
            int(ds.shape[0]), stream)
        ev[1].record()
        sflat, perm = torch.sort(flat, stable=True)
        ev[2].record()
        rc |= lib.flink_probe_fold_fold(
            sflat.data_ptr(), perm.data_ptr(), vals.data_ptr(),
            ds.data_ptr(), dc.data_ptr(), n, 0, stream)
        ev[3].record()
        ev[3].synchronize()
        check(rc == 0, f"probe_fold split launch failed: cudaError {rc}")
        if r >= 2:
            times.append([ev[i].elapsed_time(ev[i + 1]) for i in range(3)])
    return [float(x) for x in np.median(np.asarray(times), axis=0)]


def probe_fold_phase(device, rng, dki):
    import torch

    from flink_tpu_torch.ops.scatter import scatter_fold_counts
    from flink_tpu_torch.state import device_keyindex as dk

    tab = dki.table()
    planes, vals = make_flush(rng, dki, device)
    R = int(vals.shape[0])
    n_cells = KEY_CAPACITY * PANES
    gen = torch.Generator().manual_seed(11)
    dsum0 = torch.rand(n_cells, dtype=torch.float64, generator=gen)
    dcnt0 = torch.randint(0, 5, (n_cells,), dtype=torch.int32, generator=gen)

    ds, dc = dsum0.to(device, copy=True), dcnt0.to(device, copy=True)
    slot, ds, dc = dk.probe_fold(*tab, *planes, R, vals, ds, dc, PANES)
    torch.cuda.synchronize()
    wslot, ws, wc = dk.torch_probe_fold(
        *(t.cpu() for t in (*tab, *planes)), R, vals.cpu(), dsum0.clone(),
        dcnt0.clone(), PANES)
    got_slot, got_sum, got_cnt = slot.cpu(), ds.cpu(), dc.cpu()
    errs = {"slot": int((got_slot.long() - wslot.long()).abs().max()),
            "dcnt": int((got_cnt.long() - wc.long()).abs().max()),
            "dsum": float((got_sum - ws).abs().max())}
    check(max(errs.values()) == 0, f"probe_fold kernel != torch_probe_fold: "
          f"max abs errors {errs}")
    check(torch.equal(got_sum.view(torch.int64), ws.view(torch.int64)),
          "probe_fold dsum differs from torch_probe_fold in its bits")
    hits = int((wslot >= 0).sum())
    flat_hit = (wslot.long() * PANES + planes[3].cpu().long())[wslot >= 0]
    cells = int(torch.unique(flat_hit).numel())

    scratch = torch.empty(256 << 20, dtype=torch.uint8, device=device)
    flush = lambda: scratch.fill_(1)      # noqa: E731
    run = lambda: dk.probe_fold(*tab, *planes, R, vals, ds, dc,  # noqa: E731
                                PANES)
    ms_cold = cuda_time_ms(run, 20, flush=flush)
    ms_warm = cuda_time_ms(run, 20)
    split_cold = probe_fold_split_ms(tab, planes, vals, ds, dc, 20, flush)
    split_warm = probe_fold_split_ms(tab, planes, vals, ds, dc, 20)

    def unfused():
        s = dk.probe(*tab, *planes[:3])
        f = torch.where(s >= 0, s.long() * PANES + planes[3], n_cells)
        scatter_fold_counts((ds,), dc, f, (vals,), ("add",))

    unfused_ms = cuda_time_ms(unfused, 20, flush=flush)
    plain_ms = cuda_time_ms(lambda: dk.torch_probe_fold(
        *tab, *planes, R, vals, ds, dc, PANES), 5)
    del scratch
    steps, touched = probe_work(tab[2], tab[0], tab[1], *planes[:3])
    # rows stream in (key_lo, key_hi, start, pane slot, value) and out
    # (slot); table words read once; each touched cell's dsum/dcnt read and
    # written once
    bytes_ = 24 * R + 12 * touched + 24 * cells
    bound_ms, bound_by, bound_bytes_ms, bound_ops_ms = bound(
        bytes_, 6 * steps + hits, hits)
    print(f"probe_fold kernel: cap={dki.capacity} R={R} rows "
          f"({SUPERBATCH} batches), hits={hits}, distinct cells={cells}, "
          f"planes {n_cells} cells f64 + int32; max abs err {errs}")
    print(f"probe_fold kernel: median {ms_cold:.4f} ms with L2 flushed "
          f"(probe {split_cold[0]:.4f} + sort {split_cold[1]:.4f} + fold "
          f"{split_cold[2]:.4f}), {ms_warm:.4f} ms warm (probe "
          f"{split_warm[0]:.4f} + sort {split_warm[1]:.4f} + fold "
          f"{split_warm[2]:.4f}); 20 runs each")
    print(f"probe_fold plain torch_probe_fold on the card {plain_ms:.4f} ms; "
          f"unfused route (probe kernel + index_add_, f64 atomics in no "
          f"fixed order) {unfused_ms:.4f} ms with L2 flushed")
    print(f"probe_fold bound: bytes = 24 B/row x {R} + 12 B x {touched} "
          f"buckets + 24 B x {cells} cells = {bytes_} B over "
          f"{HBM_BYTES_PER_S:.3g} B/s = {bound_bytes_ms:.4f} ms; ops = "
          f"{6 * steps + hits} int32 + {hits} f64 = {bound_ops_ms:.6f} ms; "
          f"bound by {bound_by}")
    print("probe_fold library_ms: null — no single PyTorch call probes a "
          "hash table and folds; the unfused route above is two calls and "
          "its float fold is unordered")
    return {"name": "probe_fold", "route": "cuda",
            "source": "flink_tpu_torch/csrc/probe_fold.cu",
            "replaces": "flink_tpu/state/device_keyindex.py:228",
            "launches": 0, "max_abs_err": max(errs.values()),
            "ms": ms_cold, "ms_warm": ms_warm,
            "split_ms": {"probe": split_cold[0], "sort": split_cold[1],
                         "fold": split_cold[2]},
            "split_ms_warm": {"probe": split_warm[0], "sort": split_warm[1],
                              "fold": split_warm[2]},
            "plain_ms": plain_ms, "unfused_ms": unfused_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


def build_op(device, device_sync: str, superbatch: int):
    import torch

    from flink_tpu_torch.core.functions import RuntimeContext, SumAggregator
    from flink_tpu_torch.operators.window_agg import WindowAggOperator
    from flink_tpu_torch.windowing.assigners import TumblingEventTimeWindows
    op = WindowAggOperator(
        TumblingEventTimeWindows.of(WINDOW_MS), SumAggregator(torch.float32),
        key_column="k", value_column="v", initial_key_capacity=KEY_CAPACITY,
        emit_tier="host", snapshot_source="mirror", device_sync=device_sync,
        device_probe="on", superbatch=superbatch, device=device)
    op.open(RuntimeContext())
    return op


def digests(out):
    return [(int(b.column("window_start")[0]), len(b),
             float(np.asarray(b.column("result"), np.float64).sum()))
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


def main_path(device, batches, expect, label):
    """Drive one main path with every launch count at 0 just before and
    read just after; returns (launches per kernel, first snapshot, digests
    of the fires after it)."""
    import torch

    from flink_tpu_torch.core.batch import RecordBatch, Watermark
    from flink_tpu_torch.state import device_keyindex as dk

    op = build_op(device, **PATHS[label])
    fire_ms = []
    fired = []
    after_snap = []
    mid = None

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dk.probe.launches = 0
    dk.probe_fold.launches = 0
    t0 = time.perf_counter()
    for i, (keys, vals, ts) in enumerate(batches):
        op.process_batch(RecordBatch({"k": keys, "v": vals}, timestamps=ts))
        f0 = time.perf_counter()
        out = op.process_watermark(Watermark(int(ts.max()) - 1))
        if out:
            fire_ms.append((time.perf_counter() - f0) * 1e3)
        fired += out
        if mid is not None:
            after_snap += out
        if (i + 1) % SNAPSHOT_EVERY == 0:
            snap = op.snapshot_state()
            if mid is None:
                mid = (i, snap)
    f0 = time.perf_counter()
    tail = op.end_input()
    fire_ms.append((time.perf_counter() - f0) * 1e3)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = {"probe": dk.probe.launches,
                "probe_fold": dk.probe_fold.launches}
    fired += tail
    after_snap += tail
    stats = op.device_probe_stats()
    fused = op.fused_stats()
    check_fires(fired, expect, label)
    check(stats["probe_hits"] > 0, f"{label}: the probe never hit")
    if PATHS[label]["superbatch"] > 1:
        check(launches["probe_fold"] > 0,
              f"{label} never launched the probe_fold kernel")
        check(fused["scan_dispatches"] > 0, f"{label}: no one-step pass")
        check(fused["scan_steps"] > fused["scan_dispatches"],
              f"{label}: the one-step passes covered one batch each")
        check(fused["staged_pending"] == 0, f"{label}: batches left staged")
    else:
        check(launches["probe"] > 0,
              f"{label} never launched the probe kernel")
    check(op.verify_mirror(), f"{label}: device replica != host mirror")
    n_records = sum(len(b[0]) for b in batches)
    print(f"{label} {PATHS[label]}: {n_records} records in {elapsed:.3f} s "
          f"= {n_records / elapsed:.1f} records/s; {len(fired)} windows "
          f"fired and matched the numpy reference (rtol {RTOL}); launches "
          f"{launches}; probe hits {stats['probe_hits']}, misses "
          f"{stats['probe_misses']}")
    if fused["scan_dispatches"]:
        print(f"{label} fused lane: {fused}; scan depth "
              f"{fused['scan_steps'] / fused['scan_dispatches']:.3f} "
              f"batches per one-step pass")
    print(f"{label} fire latency ms over {len(fire_ms)} fires: p50 "
          f"{np.percentile(fire_ms, 50):.3f} p99 "
          f"{np.percentile(fire_ms, 99):.3f}")
    print(f"{label} phase_ns: " + json.dumps(op.phase_ns, sort_keys=True))
    print(f"{label} phase_bytes: " + json.dumps(op.phase_bytes,
                                                sort_keys=True))
    print(f"{label} peak device memory: {torch.cuda.max_memory_allocated()} B")
    return launches, mid, digests(after_snap)


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
    for (w1, n1, s1), (w2, n2, s2) in zip(got, want):
        check(w1 == w2 and n1 == n2 and abs(s1 - s2) <= 1e-6 * max(abs(s2), 1),
              f"{label} replay digest {(w1, n1, s1)} != {(w2, n2, s2)}")
    print(f"{label} restore+replay from batch {mid[0]}: {len(got)} window "
          f"digests equal; wall {wall * 1e3:.3f} ms")
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
    launches = {}
    for label in PATHS:
        launches[label], mid, after = main_path(device, batches, expect,
                                                label)
        check(mid is not None, f"{label}: no mid-run snapshot")
        replay(device, batches, mid, after, label)
    # the fused kernel's phase runs last: its 2M-row CPU check and large
    # host tensors would otherwise perturb the paths' host-bound timings
    kernels.append(probe_fold_phase(device, rng, dki))
    for label, kernel in zip(PATHS, kernels):
        kernel["launches"] = launches[label][kernel["name"]]

    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": 1}}))


if __name__ == "__main__":
    main()
