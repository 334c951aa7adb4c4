#!/usr/bin/env python3
"""Chip smoke of flink_tpu_torch on one NVIDIA GPU (written for the H100).

    python3 chip_smoke.py

Phases, each fatal on failure (exit code 1, no result line):

1. the card's name and power limit, as nvidia-smi reports them;
2. build of every kernel of the port's main path from ``flink_tpu_torch/csrc``
   with nvcc (``sm_90a``);
3. kernel phase: the device key probe (``csrc/probe.cu``) at the main path's
   shapes — a table of 1M keys at capacity 2^21, batches of 2^18 records,
   about 10% of them unseen — must equal the plain ``torch_probe`` exactly;
   its median time over CUDA-event-timed runs is printed beside its bound and
   the plain version's time;
4. main path: the 1M-key tumbling-sum workload of ``bench.py`` (seed 7,
   1,000,000 keys, 2^18 records per batch, 5000 ms windows), 40 batches through
   ``WindowAggOperator(device="cuda", device_probe="on")`` with a snapshot
   every 16 batches and ``end_input``; every fire is held against an
   independent numpy reference (per window ``np.bincount`` in f64 over the
   same records);
5. restore and replay: the first snapshot restored into a fresh operator and
   the remaining batches replayed must give the same per-window digests.

Then one JSON line of kernel numbers, the nvidia-smi line, and, last,
``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time

import numpy as np

#: H100 SXM published peaks (NVIDIA data sheet) used for the bounds
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12          # non-tensor-core 32-bit rate

N_KEYS = 1_000_000              # bench.py --keys default
KEY_CAPACITY = 1 << 20
BATCH = 1 << 18
WINDOW_MS = 5000
N_BATCHES = 40
SNAPSHOT_EVERY = 16
RTOL = 1e-6   # f64 atomics fold in no fixed order: error ~1e-16 relative


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
    warm-up calls).  Before each call the stream is kept busy — by
    ``flush()`` (which also evicts L2) or by a ~1 ms spin — so the host's
    launch overhead is not inside the timed interval."""
    import torch
    for _ in range(2):
        fn()
    times = []
    for _ in range(runs):
        if flush is not None:
            flush()
        else:
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


def kernel_phase(device, rng):
    import torch

    from flink_tpu_torch.state import device_keyindex as dk
    from flink_tpu_torch.state.keyindex import KeyIndex

    ki = KeyIndex(initial_capacity=2 * KEY_CAPACITY)
    ki.lookup_or_insert(rng.permutation(N_KEYS).astype(np.int64))
    dki = dk.DeviceKeyIndex(initial_capacity=2 * KEY_CAPACITY, device=device)
    dki.ensure_loaded(ki)
    check(dki.capacity == 1 << 21, f"table capacity {dki.capacity}")
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
    bound_bytes_ms = bytes_ / HBM_BYTES_PER_S * 1e3
    bound_ops_ms = ops / INT32_OPS_PER_S * 1e3
    print(f"probe kernel: cap={dki.capacity} B={BATCH} "
          f"unseen={int(unseen.sum())} hits={int((got >= 0).sum())}")
    print(f"probe kernel: median {ms_cold:.4f} ms with L2 flushed, "
          f"{ms_warm:.4f} ms warm (20 runs each); plain torch_probe "
          f"{plain_ms:.4f} ms")
    print(f"probe bound: bytes = 16 B/record x {BATCH} + 12 B x {touched} "
          f"distinct buckets touched = {bytes_} B over "
          f"{HBM_BYTES_PER_S:.3g} B/s = {bound_bytes_ms:.4f} ms; "
          f"ops = 6 x {steps} probe steps over {INT32_OPS_PER_S:.3g}/s = "
          f"{bound_ops_ms:.6f} ms; bound by "
          f"{'bytes' if bound_bytes_ms >= bound_ops_ms else 'operations'}")
    print("probe library_ms: null — PyTorch has no single call that probes "
          "an open-addressing hash table")
    return {"name": "probe", "route": "cuda",
            "source": "flink_tpu_torch/csrc/probe.cu",
            "replaces": "flink_tpu/state/device_keyindex.py:139",
            "launches": 0, "max_abs_err": max_abs_err,
            "ms": ms_cold, "ms_warm": ms_warm, "plain_ms": plain_ms,
            "bound_ms": max(bound_bytes_ms, bound_ops_ms),
            "bound_by": ("bytes" if bound_bytes_ms >= bound_ops_ms
                         else "operations"),
            "library_ms": None}


def build_op(device):
    import torch

    from flink_tpu_torch.core.functions import RuntimeContext, SumAggregator
    from flink_tpu_torch.operators.window_agg import WindowAggOperator
    from flink_tpu_torch.windowing.assigners import TumblingEventTimeWindows
    op = WindowAggOperator(
        TumblingEventTimeWindows.of(WINDOW_MS), SumAggregator(torch.float32),
        key_column="k", value_column="v", initial_key_capacity=KEY_CAPACITY,
        emit_tier="host", snapshot_source="mirror", device_sync="scatter",
        device_probe="on", device=device)
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


def check_fires(fired, expect):
    """Every window fired once, with the reference's keys and sums."""
    starts = [int(b.column("window_start")[0]) for b in fired]
    check(starts == sorted(expect), f"fired windows {starts} != reference "
          f"{sorted(expect)}")
    for w, b in zip(starts, fired):
        sums, cnt = expect[w]
        keys = np.asarray(b.column("k"))
        check(np.array_equal(np.sort(keys), np.flatnonzero(cnt)),
              f"window {w}: fired keys differ from the reference")
        res = np.asarray(b.column("result"))
        check(np.allclose(res, sums[keys], rtol=RTOL, atol=0),
              f"window {w}: results differ from the reference (max abs "
              f"{np.max(np.abs(res - sums[keys]))})")


def main_path(device, batches):
    import torch

    from flink_tpu_torch.core.batch import RecordBatch, Watermark
    from flink_tpu_torch.state import device_keyindex as dk

    expect = reference(batches)
    op = build_op(device)
    fire_ms = []
    fired = []
    after_snap = []
    mid = None

    dk.probe.launches = 0
    torch.cuda.synchronize()
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
    launches = dk.probe.launches
    fired += tail
    after_snap += tail
    stats = op.device_probe_stats()
    check_fires(fired, expect)
    n_windows = len(fired)
    check(launches > 0, "the main path never launched the probe kernel")
    check(stats["probe_hits"] > 0, "the probe never hit")
    check(op.verify_mirror(), "device replica != host mirror")
    n_records = sum(len(b[0]) for b in batches)
    print(f"main path: {n_records} records in {elapsed:.3f} s = "
          f"{n_records / elapsed:.1f} records/s; {n_windows} windows fired "
          f"and matched the numpy reference (rtol {RTOL}); probe launches "
          f"{launches}, hits {stats['probe_hits']}, misses "
          f"{stats['probe_misses']}")
    print(f"fire latency ms over {len(fire_ms)} fires: p50 "
          f"{np.percentile(fire_ms, 50):.3f} p99 "
          f"{np.percentile(fire_ms, 99):.3f}")
    print("phase_ns: " + json.dumps(op.phase_ns, sort_keys=True))
    print("phase_bytes: " + json.dumps(op.phase_bytes, sort_keys=True))
    print(f"peak device memory: {torch.cuda.max_memory_allocated()} B")
    return launches, mid, digests(after_snap)


def _replay_once(device, batches, mid, prof=None):
    """Restore ``mid`` into a fresh operator and replay the rest; returns
    (wall seconds, fired batches)."""
    import torch

    from flink_tpu_torch.core.batch import RecordBatch, Watermark

    i, snap = mid
    op = build_op(device)
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


def replay(device, batches, mid, want):
    """Restore + replay must give the run's digests.  The replay runs twice:
    plain (the digest check and the wall time), then under
    ``torch.profiler`` for the device's busy time — kernel and copy time
    summed over the trace — taken as a share of the plain run's wall time
    (the profiler's own host overhead would lengthen a profiled wall)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    wall, out = _replay_once(device, batches, mid)
    got = digests(out)
    check(len(got) == len(want) and len(got) > 0,
          f"replay fired {len(got)} windows, the run {len(want)}")
    for (w1, n1, s1), (w2, n2, s2) in zip(got, want):
        check(w1 == w2 and n1 == n2 and abs(s1 - s2) <= 1e-6 * max(abs(s2), 1),
              f"replay digest {(w1, n1, s1)} != {(w2, n2, s2)}")
    print(f"restore+replay from batch {mid[0]}: {len(got)} window digests "
          f"equal; wall {wall * 1e3:.3f} ms")
    prof = profile(activities=[ProfilerActivity.CUDA])
    _replay_once(device, batches, mid, prof)
    dev = sorted(((e.self_device_time_total, e.key)
                  for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and e.self_device_time_total > 0), reverse=True)
    busy_ms = sum(t for t, _ in dev) / 1e3
    share = busy_ms / (wall * 1e3)
    print(f"replay device busy {busy_ms:.3f} ms of {wall * 1e3:.3f} ms wall "
          f"= {100 * share:.2f}% (idle {100 - 100 * share:.2f}%)")
    print("replay top device ops (ms): " + "; ".join(
        f"{k[:60]} {t / 1e3:.3f}" for t, k in dev[:8]))


def main() -> None:
    try:
        import torch

        from flink_tpu_torch.kernels import build
    except ImportError as err:
        fail(f"cannot import the port ({err}): run from the repository root")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs a GPU")
    device = torch.device("cuda")
    card = card_line()
    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {card}")

    t0 = time.perf_counter()
    build.probe_lib()
    print(f"build: csrc/probe.cu in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {build.build_seconds.get('probe.cu', 0.0):.2f} s)")
    print("ptxas: " + build.ptxas_report.get("probe.cu", "(cached)")
          .replace("\n", " | "))

    rng = np.random.default_rng(7)
    kernel = kernel_phase(device, rng)
    batches = make_batches(N_BATCHES * BATCH, N_KEYS, BATCH, WINDOW_MS)
    launches, mid, after = main_path(device, batches)
    kernel["launches"] = launches
    check(mid is not None, "no mid-run snapshot")
    replay(device, batches, mid, after)

    print(json.dumps({"kernels": [kernel]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
