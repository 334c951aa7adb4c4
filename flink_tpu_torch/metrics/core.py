"""Metric types — Counter / Gauge / Meter / Histogram (port of ``flink_tpu/metrics/core.py``).

Analog of ``flink-metrics/flink-metrics-core`` (``Counter.java``,
``Gauge.java``, ``Meter.java``, ``Histogram.java``) plus the reference's
``DescriptiveStatisticsHistogram``: a numpy ring-buffer reservoir with
vectorized percentile queries (the batched runtime records whole arrays of
latencies at once, so ``update_all`` is the hot path, not ``update``).
"""

from __future__ import annotations

import time
from collections import deque
from typing import Any, Callable, Dict, Optional

import numpy as np


class Metric:
    pass


class Counter(Metric):
    __slots__ = ("_count",)

    def __init__(self):
        self._count = 0

    def inc(self, n: int = 1) -> None:
        self._count += n

    def dec(self, n: int = 1) -> None:
        self._count -= n

    def get_count(self) -> int:
        return self._count


class Gauge(Metric):
    """Wraps a supplier; ``get_value`` reads it lazily (``Gauge.java``)."""

    def __init__(self, supplier: Callable[[], Any]):
        self._supplier = supplier

    def get_value(self):
        return self._supplier()


class SettableGauge(Gauge):
    def __init__(self, initial=0):
        self._value = initial
        super().__init__(lambda: self._value)

    def set(self, value) -> None:
        self._value = value


class Meter(Metric):
    """Events-per-second over a sliding time window (``MeterView`` analog:
    the reference updates a rate from a counter once per view interval)."""

    def __init__(self, window_s: float = 60.0, clock: Callable[[], float] = time.monotonic):
        self._clock = clock
        self._window_s = window_s
        self._count = 0
        # (t, cumulative count) checkpoints; deque so the window trim is
        # O(1) per event (list.pop(0) was O(n) on hot meters)
        self._marks: deque = deque()

    def mark_event(self, n: int = 1) -> None:
        self._count += n
        now = self._clock()
        self._marks.append((now, self._count))
        cutoff = now - self._window_s
        while len(self._marks) > 2 and self._marks[0][0] < cutoff:
            self._marks.popleft()

    def get_count(self) -> int:
        return self._count

    def get_rate(self) -> float:
        if len(self._marks) < 2:
            return 0.0
        (t0, c0), (t1, c1) = self._marks[0], self._marks[-1]
        dt = t1 - t0
        return (c1 - c0) / dt if dt > 0 else 0.0


class Histogram(Metric):
    """Ring-buffer reservoir with vectorized bulk update."""

    def __init__(self, size: int = 10_000):
        self._buf = np.zeros(size, np.float64)
        self._n = 0          # total updates ever
        self._pos = 0
        self._sum = 0.0      # lifetime sum (Prometheus summary `_sum`)

    def update(self, value: float) -> None:
        self._buf[self._pos] = value
        self._pos = (self._pos + 1) % self._buf.size
        self._n += 1
        self._sum += value

    def update_all(self, values: np.ndarray) -> None:
        """Bulk insert (the batched-runtime hot path)."""
        values = np.asarray(values, np.float64).ravel()
        if values.size >= self._buf.size:
            self._buf[:] = values[-self._buf.size:]
            self._pos = 0
        else:
            end = self._pos + values.size
            if end <= self._buf.size:
                self._buf[self._pos:end] = values
            else:
                k = self._buf.size - self._pos
                self._buf[self._pos:] = values[:k]
                self._buf[: end - self._buf.size] = values[k:]
            self._pos = end % self._buf.size
        self._n += values.size
        self._sum += float(values.sum())

    def clear(self) -> None:
        """Back to empty (count, sum, reservoir).  Per-execution latency
        views reuse their already-registered Histogram objects across
        resets — reporters see a counter reset, not a new series."""
        self._buf[:] = 0.0
        self._n = 0
        self._pos = 0
        self._sum = 0.0

    def get_count(self) -> int:
        return self._n

    def get_sum(self) -> float:
        """Lifetime sum of every recorded value (not just the reservoir) —
        the Prometheus summary ``_sum`` series."""
        return self._sum

    def _values(self) -> np.ndarray:
        return self._buf[: min(self._n, self._buf.size)]

    def get_statistics(self) -> Dict[str, float]:
        v = self._values()
        if v.size == 0:
            return {"count": 0, "min": 0.0, "max": 0.0, "mean": 0.0,
                    "p50": 0.0, "p95": 0.0, "p99": 0.0, "p999": 0.0}
        q = np.percentile(v, [50, 95, 99, 99.9])
        return {"count": self._n, "min": float(v.min()), "max": float(v.max()),
                "mean": float(v.mean()), "p50": float(q[0]),
                "p95": float(q[1]), "p99": float(q[2]), "p999": float(q[3])}
