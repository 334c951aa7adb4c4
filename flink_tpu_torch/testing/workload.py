"""Shared workload generators: the diurnal load curve (port of
``flink_tpu/testing/workload.py``: one seed gives both packages the same
stream).

ONE implementation of the millions-of-users day curve drives both
the scenario suite (``flink_tpu_torch/scenarios``) and JAX's ``bench.py
--autoscale`` — twin generators would drift, and the whole point of the curve is that
the autoscaler, the chaos schedules, and the budget gates all see the
same arrival process.

Pacing goes through the :mod:`flink_tpu_torch.utils.clock` seam
(``clock.sleep``) so chaos clock schedules and tests see one time
surface; data is fully determined by ``seed`` (two instances with the
same arguments generate bit-identical streams — the scenario harness
runs its unfaulted control leg on a fresh instance and compares
committed digests).
"""

from __future__ import annotations

import math
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from flink_tpu_torch.connectors.sources import Source, SourceSplit
from flink_tpu_torch.core.batch import RecordBatch
from flink_tpu_torch.utils import clock

__all__ = ["DiurnalSource"]


class DiurnalSource(Source):
    """Diurnal load-curve generator: a stable-split bounded source whose
    per-batch emission pace follows a day curve — slow at the edges (the
    overnight trough), fastest in the middle (the traffic peak) — so the
    arrival rate crosses the (injected, per-dequeue) consumer capacity
    mid-stream and recrosses it on the way down.  Splits are fixed
    (2 by default) regardless of job parallelism: the autoscaler's
    stable-split rescale contract.

    ``value_fn(rng, n) -> ndarray`` shapes the value column (default: all
    ones — count-like sums stay exact in float64, the digest-comparison
    convention); keys are uniform over ``[0, n_keys)`` and timestamps are
    sorted uniform over ``[0, span_ms)`` per split.

    Replay fast-forward: a rescale restore re-reads each split from batch
    0; batches already emitted once (tracked per split in ``_progress``)
    re-yield WITHOUT re-sleeping the pre-cut day curve — re-pacing would
    add seconds of dead time per restore and shift the remaining curve.

    ``paced=False`` drops the sleeps entirely (data identical): the
    scenario harness's unfaulted control leg runs at full speed.
    """

    bounded = True

    def __init__(self, n_records: int, n_keys: int, batch_size: int,
                 span_ms: int, peak_s: float, trough_s: float,
                 n_splits: int = 2, seed: int = 31,
                 key_column: str = "k", value_column: str = "v",
                 ts_column: str = "t",
                 value_fn: Optional[Callable[[np.random.Generator, int],
                                             np.ndarray]] = None,
                 paced: bool = True):
        rng = np.random.default_rng(seed)
        per = n_records // n_splits
        self.n_keys = n_keys
        self.batch_size = batch_size
        self.n_splits = n_splits
        self.key_column = key_column
        self.value_column = value_column
        self.ts_column = ts_column
        self.paced = paced
        self._data: List[Tuple[np.ndarray, np.ndarray, np.ndarray]] = []
        for split in range(n_splits):
            ks = rng.integers(0, n_keys, per).astype(np.int64)
            vs = (np.ones(per, np.float64) if value_fn is None
                  else np.asarray(value_fn(rng, per), np.float64))
            ts = np.sort(rng.integers(0, span_ms, per)).astype(np.int64)
            # disjoint per-split timestamp residue classes (ts ≡ split
            # mod n_splits; the floor map is monotone, sortedness holds):
            # two splits can otherwise emit SAME-timestamp events for one
            # key, and which arrives first at a keyed consumer is thread
            # scheduling — order-sensitive consumers (CEP: which strike a
            # bait partial takes) would then differ run to run, making
            # the control-digest comparison flaky on a tie the framework
            # legitimately may resolve either way.  With total per-key
            # event-time order the committed output is deterministic.
            ts = (ts // n_splits) * np.int64(n_splits) + np.int64(split)
            self._data.append((ks, vs, ts))
        nb = max(1, per // batch_size)
        self.n_batches = nb
        #: pace per batch index: trough at the edges, peak (the smallest
        #: sleep = highest arrival rate) in the middle
        self.paces = [
            trough_s - (trough_s - peak_s)
            * math.sin(math.pi * i / max(1, nb - 1))
            for i in range(nb + 2)]
        #: per-split high-water batch index EVER emitted (the replay
        #: fast-forward state — see class docstring)
        self._progress = [0] * n_splits
        #: per-split (batch_index, monotonic_s) log of FIRST emissions —
        #: the scenario harness derives sustained-at-peak throughput from
        #: the middle third of the curve
        self._emit_log: List[List[Tuple[int, float]]] = \
            [[] for _ in range(n_splits)]
        self._lock = threading.Lock()

    # -- Source contract ---------------------------------------------------
    def create_splits(self, parallelism: int) -> List[SourceSplit]:
        return [SourceSplit(self, i, self.n_splits)
                for i in range(self.n_splits)]

    def read_split(self, index: int, of: int):
        ks, vs, ts = self._data[index]
        for bi, lo in enumerate(range(0, len(ks), self.batch_size)):
            hi = min(lo + self.batch_size, len(ks))
            if bi >= self._progress[index]:
                if self.paced:
                    clock.sleep(self.paces[min(bi, len(self.paces) - 1)])
                # split reader threads write, the harness watcher reads
                # progress_frac()/peak_stats() concurrently
                with self._lock:
                    self._progress[index] = bi + 1
                    self._emit_log[index].append((bi, time.monotonic()))
            yield RecordBatch({self.key_column: ks[lo:hi],
                               self.value_column: vs[lo:hi],
                               self.ts_column: ts[lo:hi]})

    # -- accounting helpers (bench + scenario harness share these) ---------
    @property
    def total_records(self) -> int:
        return sum(d[0].size for d in self._data)

    def progress_frac(self) -> float:
        """Fraction of first-time batch emissions done across splits —
        the harness's trigger for arming chaos at the peak."""
        with self._lock:
            return sum(self._progress) / float(
                self.n_splits * self.n_batches)

    def expected_per_key(self) -> Dict[int, Tuple[int, float]]:
        """Per-key ``(count, value_sum)`` over the WHOLE generated stream
        — the exactly-once ledger both bench and harness check against.
        Vectorized: a per-row Python loop costs seconds at the full
        tier's 500k records."""
        ks = np.concatenate([d[0] for d in self._data])
        vs = np.concatenate([d[1] for d in self._data])
        uniq, inv = np.unique(ks, return_inverse=True)
        counts = np.bincount(inv)
        sums = np.bincount(inv, weights=vs)
        return {int(k): (int(c), float(s))
                for k, c, s in zip(uniq.tolist(), counts.tolist(),
                                   sums.tolist())}

    def peak_stats(self) -> Dict[str, float]:
        """Sustained throughput over the curve's middle third (the peak):
        records first-emitted there divided by the emission span."""
        lo, hi = self.n_batches // 3, (2 * self.n_batches) // 3
        t0, t1, records = None, None, 0
        with self._lock:
            logs = [list(log) for log in self._emit_log]
        for log in logs:
            for bi, t in log:
                if lo <= bi < hi:
                    t0 = t if t0 is None else min(t0, t)
                    t1 = t if t1 is None else max(t1, t)
                    records += self.batch_size
        span = (t1 - t0) if (t0 is not None and t1 is not None) else 0.0
        return {"peak_records": float(records),
                "peak_span_s": round(span, 3),
                "peak_records_per_sec": round(records / span, 1)
                if span > 1e-6 else 0.0}
