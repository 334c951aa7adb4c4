"""Window evictors (copy of ``flink_tpu/windowing/evictors.py``; the
``api/windowing/evictors/`` analog).

An evictor trims a window's buffered rows before the window function runs
(evicting windows buffer raw elements rather than folding into an ACC —
``EvictingWindowOperator`` semantics).  Vectorized: an evictor receives the
window's row index order + timestamps and returns a keep-mask.
"""

from __future__ import annotations

import numpy as np


class Evictor:
    def keep_mask(self, timestamps: np.ndarray, window_max_ts: int,
                  rows=None) -> np.ndarray:
        """bool[n] over rows sorted by arrival order: True = keep.
        ``rows`` is the window's buffered row dicts (same order) so
        value-inspecting evictors need no side channel."""
        raise NotImplementedError


class CountEvictor(Evictor):
    """Keep only the LAST ``n`` rows (``CountEvictor.of``)."""

    def __init__(self, n: int):
        self.n = n

    @staticmethod
    def of(n: int) -> "CountEvictor":
        return CountEvictor(n)

    def keep_mask(self, timestamps: np.ndarray, window_max_ts: int,
                  rows=None) -> np.ndarray:
        m = np.zeros(len(timestamps), bool)
        m[max(0, len(timestamps) - self.n):] = True
        return m


class TimeEvictor(Evictor):
    """Keep rows within ``window_ms`` of the newest row (``TimeEvictor.of``)."""

    def __init__(self, window_ms: int):
        self.window_ms = window_ms

    @staticmethod
    def of(window_ms: int) -> "TimeEvictor":
        return TimeEvictor(window_ms)

    def keep_mask(self, timestamps: np.ndarray, window_max_ts: int,
                  rows=None) -> np.ndarray:
        ts = np.asarray(timestamps, np.int64)
        if ts.size == 0:
            return np.zeros(0, bool)
        return ts >= ts.max() - self.window_ms


class DeltaEvictor(Evictor):
    """Keep rows whose value is within ``threshold`` of the newest row's
    value (``DeltaEvictor`` analog)."""

    def __init__(self, threshold: float, value_column: str):
        self.threshold = threshold
        self.value_column = value_column

    @staticmethod
    def of(threshold: float, value_column: str) -> "DeltaEvictor":
        return DeltaEvictor(threshold, value_column)

    def keep_mask(self, timestamps: np.ndarray, window_max_ts: int,
                  rows=None) -> np.ndarray:
        if not rows:
            return np.ones(len(timestamps), bool)
        values = np.asarray([r[self.value_column] for r in rows], np.float64)
        return np.abs(values - values[-1]) <= self.threshold
