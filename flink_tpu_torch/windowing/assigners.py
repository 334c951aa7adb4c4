"""Window assigners, pane-decomposed (port of ``flink_tpu/windowing/assigners.py``).

A pane is the gcd span shared by every window covering it; the per-record
hot path only computes ``pane_of(timestamps)`` (one vectorized int op) and
state is a ``[keys, panes]`` ring.  The port carries the tumbling and the
sliding event-time assigners, :class:`GlobalWindows`, and the session gap
(:class:`SessionGap`), which the session operator consumes.
"""

from __future__ import annotations

from dataclasses import dataclass
from math import gcd
from typing import Tuple

import numpy as np

from flink_tpu_torch.core.batch import LONG_MAX, LONG_MIN


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


class SlidingEventTimeWindows(WindowAssigner):
    """``SlidingEventTimeWindows.of(size, slide[, offset])``: windows overlap;
    a record lands in one pane of gcd(size, slide), and a window combines
    size / gcd panes when it fires."""

    def __init__(self, size_ms: int, slide_ms: int, offset_ms: int = 0):
        if size_ms <= 0 or slide_ms <= 0:
            raise ValueError(f"window size/slide must be > 0, got "
                             f"size={size_ms} slide={slide_ms}")
        if slide_ms > size_ms:
            raise ValueError("slide must be <= size")
        self.size_ms = int(size_ms)
        self.slide_ms = int(slide_ms)
        self.pane_ms = gcd(self.size_ms, self.slide_ms)
        self.panes_per_window = self.size_ms // self.pane_ms
        self.pane_stride = self.slide_ms // self.pane_ms
        self._offset = int(offset_ms) % self.slide_ms

    @staticmethod
    def of(size_ms: int, slide_ms: int,
           offset_ms: int = 0) -> "SlidingEventTimeWindows":
        return SlidingEventTimeWindows(size_ms, slide_ms, offset_ms)

    def pane_of(self, timestamps: np.ndarray) -> np.ndarray:
        ts = np.asarray(timestamps, np.int64)
        return (ts - self._offset) // np.int64(self.pane_ms)


class TumblingEventTimeWindows(SlidingEventTimeWindows):
    """``TumblingEventTimeWindows.of(size[, offset])`` — pane == window."""

    def __init__(self, size_ms: int, offset_ms: int = 0):
        super().__init__(size_ms, size_ms, offset_ms)

    @staticmethod
    def of(size_ms: int, offset_ms: int = 0) -> "TumblingEventTimeWindows":
        return TumblingEventTimeWindows(size_ms, offset_ms)


class GlobalWindows(WindowAssigner):
    """One window covering everything (``GlobalWindows.java``), which only
    a count trigger fires: a single pane of an effectively infinite width."""

    is_event_time = True
    pane_ms = LONG_MAX // 4
    panes_per_window = 1
    pane_stride = 1

    def pane_of(self, timestamps: np.ndarray) -> np.ndarray:
        return np.zeros(np.shape(timestamps)[0], np.int64)

    def window_bounds(self, window_id: int) -> TimeWindow:
        return TimeWindow(LONG_MIN, LONG_MAX)

    def last_window_end_of_pane(self, pane_id: int) -> int:
        return LONG_MAX

    @staticmethod
    def create() -> "GlobalWindows":
        return GlobalWindows()


@dataclass(frozen=True)
class SessionGap:
    """Session spec: windows merge while gaps < gap_ms
    (``EventTimeSessionWindows``).  Consumed by the dedicated session
    operator, not the paned one."""

    gap_ms: int
    is_event_time: bool = True


def EventTimeSessionWindows(gap_ms: int) -> SessionGap:
    return SessionGap(gap_ms, True)


def ProcessingTimeSessionWindows(gap_ms: int) -> SessionGap:
    return SessionGap(gap_ms, False)
