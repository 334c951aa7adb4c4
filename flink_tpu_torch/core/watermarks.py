"""Watermark strategies and generation (copy of ``flink_tpu/core/watermarks.py``).

A strategy sees a whole batch's timestamp column and yields the watermark to
emit after the batch (the batched ``TimestampsAndWatermarksOperator``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np

from flink_tpu_torch.core.batch import LONG_MIN


class WatermarkGenerator:
    """Stateful per-source-subtask generator; ``on_batch`` returns the
    watermark to emit after the batch (or None)."""

    def on_batch(self, timestamps: np.ndarray) -> Optional[int]:
        raise NotImplementedError

    def on_periodic(self) -> Optional[int]:
        return None


class BoundedOutOfOrdernessWatermarks(WatermarkGenerator):
    """max_seen_ts - out_of_orderness - 1 (``BoundedOutOfOrdernessWatermarks.java``)."""

    def __init__(self, max_out_of_orderness_ms: int):
        self._delay = int(max_out_of_orderness_ms)
        self._max_ts = LONG_MIN + self._delay + 1

    def on_batch(self, timestamps: np.ndarray) -> Optional[int]:
        if timestamps is None or len(timestamps) == 0:
            return None
        self._max_ts = max(self._max_ts, int(np.max(timestamps)))
        return self._max_ts - self._delay - 1

    def on_periodic(self) -> Optional[int]:
        return self._max_ts - self._delay - 1


class MonotonousTimestampsWatermarks(BoundedOutOfOrdernessWatermarks):
    """Ascending timestamps (``AscendingTimestampsWatermarks``)."""

    def __init__(self):
        super().__init__(0)


class NoWatermarks(WatermarkGenerator):
    def on_batch(self, timestamps):
        return None


@dataclass
class WatermarkStrategy:
    """A generator factory and a timestamp assigner (a column name or
    ``fn(columns) -> int64[B]``)."""

    generator_factory: Callable[[], WatermarkGenerator]
    timestamp_assigner: Optional[object] = None

    @staticmethod
    def for_bounded_out_of_orderness(ms: int) -> "WatermarkStrategy":
        return WatermarkStrategy(lambda: BoundedOutOfOrdernessWatermarks(ms))

    @staticmethod
    def for_monotonous_timestamps() -> "WatermarkStrategy":
        return WatermarkStrategy(MonotonousTimestampsWatermarks)

    @staticmethod
    def no_watermarks() -> "WatermarkStrategy":
        return WatermarkStrategy(NoWatermarks)

    def with_timestamp_assigner(self, assigner) -> "WatermarkStrategy":
        return WatermarkStrategy(self.generator_factory, assigner)

    def extract_timestamps(self, columns) -> Optional[np.ndarray]:
        if self.timestamp_assigner is None:
            return None
        if callable(self.timestamp_assigner):
            return np.asarray(self.timestamp_assigner(columns), np.int64)
        return np.asarray(columns[self.timestamp_assigner], np.int64)
