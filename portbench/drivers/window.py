"""The window family: keyed event-time windows through the port's
``WindowAggOperator``, driven as a job's task loop drives it.

Set-up draws the traffic mix's pool of batches from the seed, builds the
operator with the configuration's pinned options, and runs the mix's
warm-up batches (a fire and a checkpoint among them).  The timed loop is a
closed loop over the pool: each pass shifts the event times by the pool's
span, so event time keeps advancing with no generator in the loop.  After
each batch comes the watermark (the batch's largest timestamp - 1); every
``checkpoint_every_batches`` batches a checkpoint (``prepare_snapshot_
pre_barrier`` + ``snapshot_state``), whose state the loop keeps until the
next cut.  The sink keeps each fire's row count and f64 total, and the rows
of a sample of windows drawn from the seed: the whole fired output of a run
is gigabytes.  The check reads the fired windows and the window's last
cut.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np

from portbench.lib import gen


class _Fired:
    """What the sink keeps of one window's fired rows: its count, its f64
    total, and, for a window drawn into the sample, the rows themselves."""
    __slots__ = ("calls", "rows", "total", "parts", "bounds_ok")

    def __init__(self):
        self.calls = set()
        self.rows = 0
        self.total = 0.0
        self.parts: Optional[List[tuple]] = None
        self.bounds_ok = True


class Sink:
    """The harness's sink of fired rows (columns ``k``, ``result``,
    ``window_start``, ``window_end``).  It keeps every window's row count
    and f64 total, and the rows of ``keep`` windows drawn from ``rng`` (a
    reservoir over however many windows fire): a run fires gigabytes."""

    def __init__(self, size_ms: int, keep: int, rng):
        self.size_ms = size_ms
        self.keep = keep
        self.rng = rng
        self.windows: Dict[int, _Fired] = {}
        self.kept: List[int] = []

    def _new(self, start: int) -> _Fired:
        rec = self.windows[start] = _Fired()
        if len(self.kept) < self.keep:
            self.kept.append(start)
            rec.parts = []
        elif self.keep:
            slot = int(self.rng.integers(0, len(self.windows)))
            if slot < self.keep:
                self.windows[self.kept[slot]].parts = None
                self.kept[slot] = start
                rec.parts = []
        return rec

    def take(self, elements, call: int) -> int:
        """Keep what the check needs of ``elements`` (one operator call's
        output); returns the rows taken."""
        rows = 0
        for b in elements:
            keys = np.asarray(b.column("k"))
            sums = np.asarray(b.column("result"))
            start = int(np.asarray(b.column("window_start"))[0])
            end = int(np.asarray(b.column("window_end"))[0])
            rec = self.windows.get(start) or self._new(start)
            rec.calls.add(call)
            rec.rows += len(keys)
            rec.total += float(sums.sum(dtype=np.float64))
            rec.bounds_ok &= (end - start == self.size_ms
                              and start % self.size_ms == 0)
            if rec.parts is not None:
                rec.parts.append((keys, sums))
            rows += len(keys)
        return rows


class Driver:
    def __init__(self, cell, seed: int, device):
        self.cell = cell
        self.config = config = cell.config
        self.traffic = traffic = cell.traffic
        self.seed = int(seed)
        self.device = device
        self.n_keys = int(config["keys"])
        self.size_ms = int(config["window"]["size_ms"])
        self.every = int(config["checkpoint_every_batches"])
        self.ms = int(traffic["ms_per_batch"])
        self.op = None

    # -- set-up --------------------------------------------------------------
    def setup(self) -> None:
        import torch
        from flink_tpu_torch.core.functions import (RuntimeContext,
                                                    SumAggregator)
        from flink_tpu_torch.operators.window_agg import WindowAggOperator
        from flink_tpu_torch.windowing.assigners import (
            TumblingEventTimeWindows)
        if self.config["window"]["kind"] != "tumbling" \
                or self.config["aggregate"] != "sum":
            raise ValueError("the window driver runs tumbling sums")
        self._inputs()
        self.op = WindowAggOperator(
            TumblingEventTimeWindows.of(self.size_ms),
            SumAggregator(torch.float32), key_column="k", value_column="v",
            allowed_lateness_ms=int(self.config["allowed_lateness_ms"]),
            initial_key_capacity=int(self.config["key_capacity"]),
            device=self.device, **self.config["operator"])
        self.op.open(RuntimeContext())
        self.g = 0
        self.fire_ms: List[float] = []
        self.fired_rows = 0
        self.cuts = 0
        self.watermark = None
        self.cut = None
        warm = Sink(self.size_ms, 0, None)
        for _ in range(int(self.traffic["warmup_batches"])):
            self._step(None, warm)
        self.fire_ms.clear()
        self.fired_rows = 0
        self.cuts = 0
        self.cut = None

    def _inputs(self) -> None:
        """The pool and an empty sink, from the seed."""
        self.pool = gen.window_pool(self.traffic, self.n_keys, self.seed)
        self.pool_max = [int(ts.max()) for _, _, ts in self.pool]
        self.sink = Sink(self.size_ms, int(self.traffic["check_windows"]),
                         np.random.default_rng([self.seed, 1]))

    def _watermark_after(self, g: int) -> int:
        """The watermark after batch ``g``: its largest timestamp - 1."""
        pool = len(self.pool)
        return self.pool_max[g % pool] + (g // pool) * pool * self.ms - 1

    def _batch(self, g: int):
        from flink_tpu_torch.core.batch import RecordBatch
        pool = len(self.pool)
        keys, vals, ts = self.pool[g % pool]
        shift = (g // pool) * pool * self.ms
        return RecordBatch({"k": keys, "v": vals}, timestamps=ts + shift)

    def _step(self, window, sink: Sink) -> None:
        """One batch, its watermark and, on the cadence, a checkpoint."""
        from flink_tpu_torch.core.batch import Watermark
        span = window.span if window is not None else _no_span
        g = self.g
        with span("source"):
            batch = self._batch(g)
        with span("batch"):
            out = self.op.process_batch(batch)
        if out:
            with span("sink"):
                self.fired_rows += sink.take(out, 2 * g)
        self.watermark = self._watermark_after(g)
        t0 = time.perf_counter()
        with span("watermark"):
            out = self.op.process_watermark(Watermark(self.watermark))
        if out:
            # the rows are on the host: the fire's latency ends here
            self.fire_ms.append((time.perf_counter() - t0) * 1e3)
            with span("sink"):
                self.fired_rows += sink.take(out, 2 * g + 1)
        if (g + 1) % self.every == 0:
            with span("checkpoint"):
                out = self.op.prepare_snapshot_pre_barrier()
                snap = self.op.snapshot_state()
            # the cut holds the batches before event time (g + 1) * ms
            self.cut = ((g + 1) * self.ms, self.watermark, snap)
            self.cuts += 1
            if out:
                with span("sink"):
                    self.fired_rows += sink.take(out, 2 * g + 1)
        self.g = g + 1

    # -- the window ----------------------------------------------------------
    def run(self, seconds: float, window) -> None:
        self.g0 = self.g
        self.wm0 = self.watermark
        phase0 = dict(self.op.phase_ns)
        window.begin()
        deadline = window.t0 + seconds
        while time.perf_counter() < deadline:
            self._step(window, self.sink)
        window.end()
        self.batches = self.g - self.g0
        self.phase_ns = {k: v - phase0.get(k, 0)
                         for k, v in self.op.phase_ns.items()}

    def end_to_end(self, window) -> dict:
        return {"records_per_s": self.batches
                * int(self.traffic["batch_size"]) / window.seconds}

    def counters(self) -> dict:
        return {"phase_ns": self.phase_ns, "batches": self.batches,
                "fires": len(self.fire_ms), "fire_ms": self.fire_ms,
                "cuts": self.cuts,
                "fired_rows": self.fired_rows, "pool": self.pool,
                "pool_visits": np.bincount(
                    np.arange(self.g0, self.g) % len(self.pool),
                    minlength=len(self.pool)),
                "batch_size": int(self.traffic["batch_size"])}

    def release(self) -> None:
        if self.op is not None:
            self.op.close()
            self.op = None

    # -- the check -----------------------------------------------------------
    def due_windows(self) -> np.ndarray:
        """The windows whose end the window's watermarks passed: those the
        measured window had to fire."""
        first = (self.wm0 + 1) // self.size_ms
        last = (self.watermark + 1) // self.size_ms
        return np.arange(first, last, dtype=np.int64)

    def reference(self):
        return self.cell.module(
            "reference", self.config["reference"]).TumblingSum(
            self.pool, self.size_ms, self.ms, self.n_keys)

    def answers(self):
        """(windows due, windows due that never fired, the readings the
        limits apply to)."""
        ref = self.reference()
        attempted, failed, got = compare(self.sink, self.due_windows(),
                                         self.size_ms, ref)
        got.update(compare_cut(self.cut, ref, self.size_ms))
        return attempted, failed, got

    def control(self, dtype, batches: int):
        """The control: the reference computed in ``dtype`` in the
        program's place, over the windows a run of ``batches`` timed
        batches after the warm-up is due and its last cut, through the
        same check."""
        self._inputs()
        warm = int(self.traffic["warmup_batches"])
        self.wm0 = self._watermark_after(warm - 1)
        self.watermark = self._watermark_after(warm + batches - 1)
        ref = self.reference()
        for i, w in enumerate(self.due_windows().tolist()):
            self.sink.take([ref.fired(int(w), dtype)], i)
        last = warm + batches - 1
        last -= (last + 1) % self.every
        if last >= warm:
            until, wm = (last + 1) * self.ms, self._watermark_after(last)
            self.cut = (until, wm, ref.cut(
                open_windows(until, wm, self.size_ms), until, dtype))
        return self.answers()


def compare(sink: Sink, due: np.ndarray, size_ms: int, ref):
    """The check of a window run: every due window fired once, with the
    reference's row count and total, and the windows drawn into the
    sample with the reference's rows.  Readings: ``window_errors`` (due
    windows missing or fired in more than one call, fired windows not
    due, wrong bounds), ``row_count_gap`` (the sum over due windows of
    |rows - reference rows|), ``total_rel_err`` (the largest relative
    error of a window's f64 total), and over the sampled windows' rows
    ``sample_key_gap`` (keys missing, extra, twice or out of range) and
    ``sample_rel_err`` (the largest relative error of a row's sum)."""
    due_set = set(due.tolist())
    window_errors = sum(1 for start in sink.windows
                        if start // size_ms not in due_set)
    failed = row_gap = key_gap = 0
    rel = total_rel = 0.0
    n = ref.n_keys
    for w in due.tolist():
        got = sink.windows.get(w * size_ms)
        if got is None:
            window_errors += 1
            failed += 1
            continue
        if len(got.calls) != 1 or not got.bounds_ok:
            window_errors += 1
        want = ref.window(w)
        row_gap += abs(got.rows - want["rows"])
        total_rel = max(total_rel,
                        abs(got.total - want["total"]) / want["total"])
        if got.parts is None:
            continue
        keys = np.concatenate([k for k, _ in got.parts])
        sums = np.concatenate([v for _, v in got.parts]).astype(np.float64)
        inside = (keys >= 0) & (keys < n)
        key_gap += int(np.count_nonzero(~inside))
        keys, sums = keys[inside], sums[inside]
        times = np.bincount(keys, minlength=n)
        want_counts, want_sums = ref.sums(w)
        present = want_counts > 0
        key_gap += int((times[present] != 1).sum()
                       + (times[~present] > 0).sum())
        got_sums = np.zeros(n)
        got_sums[keys] = sums
        once = present & (times == 1)
        # a sum of values in [0, 1) is 0 only where every value is
        err = np.abs(got_sums[once] - want_sums[once]) / np.maximum(
            np.abs(want_sums[once]), np.finfo(np.float64).tiny)
        if err.size:
            rel = max(rel, float(err.max()))
    return len(due), failed, {
        "window_errors": window_errors, "row_count_gap": row_gap,
        "sample_key_gap": key_gap, "sample_rel_err": rel,
        "total_rel_err": total_rel}


def open_windows(until: int, watermark: int, size_ms: int) -> range:
    """The windows open at a cut taken before event time ``until`` under
    ``watermark``: those with a record before ``until`` whose end the
    watermark has not passed (allowed lateness 0)."""
    return range((watermark + 1) // size_ms, (until - 1) // size_ms + 1)


def compare_cut(cut, ref, size_ms: int) -> dict:
    """The check of the window's last checkpoint ``(until, watermark,
    state)``: for each window open at the cut, the state holds every key's
    record count and sum over the records before ``until``, and no other
    pane holds a record.  Readings: ``cut_count_gap`` (the records the
    state gets wrong: over the open windows' keys |count - reference
    count|, the counts of other panes and of slots whose key is out of
    range, every record of an open window the state lacks; 1 where the
    window took no cut) and ``cut_rel_err`` (the largest relative error of
    a key's sum in an open window)."""
    if cut is None:
        return {"cut_count_gap": 1, "cut_rel_err": 0.0}
    until, watermark, snap = cut
    n = ref.n_keys
    windows = open_windows(until, watermark, size_ms)
    panes = np.asarray(snap.get("panes", []), np.int64).tolist()
    gap = 0
    rel = 0.0
    if panes:
        counts = np.asarray(snap["counts"]).astype(np.int64)
        sums = np.asarray(snap["leaves"][0]).astype(np.float64)
        keys = np.asarray(snap["key_index"]["reverse"],
                          np.int64)[:counts.shape[0]]
        inside = (keys >= 0) & (keys < n)
        gap += int(counts[~inside].sum())
        keys = keys[inside]
    for j, p in enumerate(panes):
        if p not in windows:
            gap += int(counts[:, j].sum())
    for w in windows:
        want_counts, want_sums = ref.sums(w, until)
        if w not in panes:
            gap += int(want_counts.sum())
            continue
        j = panes.index(w)
        got_counts = np.bincount(keys, weights=counts[inside, j],
                                 minlength=n)
        got_sums = np.bincount(keys, weights=sums[inside, j], minlength=n)
        gap += int(np.abs(got_counts - want_counts).sum())
        present = want_counts > 0
        err = np.abs(got_sums[present] - want_sums[present]) / np.maximum(
            np.abs(want_sums[present]), np.finfo(np.float64).tiny)
        if err.size:
            rel = max(rel, float(err.max()))
    return {"cut_count_gap": gap, "cut_rel_err": rel}


class _NoSpan:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def _no_span(_name):
    return _NoSpan()
