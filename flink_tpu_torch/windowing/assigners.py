"""Window assigners, pane-decomposed (port of ``flink_tpu/windowing/assigners.py``).

A pane is the gcd span shared by every window covering it; the per-record
hot path only computes ``pane_of(timestamps)`` (one vectorized int op) and
state is a ``[keys, panes]`` ring.  This slice carries the tumbling
event-time assigner, where one pane is one window.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np


@dataclass(frozen=True, order=True)
class TimeWindow:
    """[start, end) time window; max_timestamp = end - 1."""

    start: int
    end: int

    @property
    def max_timestamp(self) -> int:
        return self.end - 1


class WindowAssigner:
    """Pane-decomposed window assigner.

    Window id ``w`` covers panes ``[w * pane_stride, w * pane_stride +
    panes_per_window)``; its time span is ``window_bounds(w)``.
    """

    is_event_time: bool = True
    pane_ms: int = 0
    panes_per_window: int = 1
    pane_stride: int = 1
    _offset: int = 0

    def pane_of(self, timestamps: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def window_panes(self, window_id: int) -> Tuple[int, int]:
        """[first_pane, last_pane] inclusive for a window id."""
        first = window_id * self.pane_stride
        return first, first + self.panes_per_window - 1

    def window_bounds(self, window_id: int) -> TimeWindow:
        start = window_id * self.pane_stride * self.pane_ms + self._offset
        return TimeWindow(start, start + self.panes_per_window * self.pane_ms)

    def windows_of_pane(self, pane_id: int) -> Tuple[int, int]:
        """[first_window, last_window] inclusive containing pane_id."""
        last = pane_id // self.pane_stride
        first = ((pane_id - self.panes_per_window + self.pane_stride)
                 // self.pane_stride)
        return first, last

    def last_window_end_of_pane(self, pane_id: int) -> int:
        """End of the latest window containing this pane: the pane can be
        cleared once the watermark passes this + allowed lateness."""
        _, last_w = self.windows_of_pane(pane_id)
        return self.window_bounds(last_w).end


class TumblingEventTimeWindows(WindowAssigner):
    """``TumblingEventTimeWindows.of(size[, offset])`` — pane == window."""

    def __init__(self, size_ms: int, offset_ms: int = 0):
        if size_ms <= 0:
            raise ValueError(f"window size must be > 0, got {size_ms}")
        self.size_ms = int(size_ms)
        self.pane_ms = self.size_ms
        self.panes_per_window = 1
        self.pane_stride = 1
        self._offset = int(offset_ms) % self.size_ms

    @staticmethod
    def of(size_ms: int, offset_ms: int = 0) -> "TumblingEventTimeWindows":
        return TumblingEventTimeWindows(size_ms, offset_ms)

    def pane_of(self, timestamps: np.ndarray) -> np.ndarray:
        ts = np.asarray(timestamps, np.int64)
        return (ts - self._offset) // np.int64(self.pane_ms)
