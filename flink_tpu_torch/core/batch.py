"""Stream elements, batched (numpy-only copy of ``flink_tpu/core/batch.py``).

The unit of flow is a columnar :class:`RecordBatch` of host numpy arrays;
control elements such as :class:`Watermark` flow individually and in order
between batches.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Mapping

import numpy as np

LONG_MIN = -(2 ** 63)
LONG_MAX = 2 ** 63 - 1


class StreamElement:
    __slots__ = ()

    def is_batch(self) -> bool:
        return False


@dataclass(frozen=True)
class Watermark(StreamElement):
    """Event-time watermark: no element with ts <= this will arrive later."""

    timestamp: int


class RecordBatch(StreamElement):
    """Columnar record batch.

    columns:    name -> array [B, ...]
    timestamps: int64[B] event timestamps in ms, or None
    """

    __slots__ = ("columns", "timestamps", "_size")

    def __init__(self, columns: Mapping[str, Any], timestamps=None):
        self.columns: Dict[str, Any] = dict(columns)
        self.timestamps = timestamps
        if self.columns:
            self._size = int(np.shape(next(iter(self.columns.values())))[0])
        elif timestamps is not None:
            self._size = int(np.shape(timestamps)[0])
        else:
            self._size = 0
        if timestamps is not None and int(np.shape(timestamps)[0]) != self._size:
            raise ValueError(f"timestamps length {int(np.shape(timestamps)[0])}"
                             f" != batch size {self._size}")
        for n, v in self.columns.items():
            if int(np.shape(v)[0]) != self._size:
                raise ValueError(f"column {n!r} length {int(np.shape(v)[0])} "
                                 f"!= batch size {self._size}")

    def is_batch(self) -> bool:
        return True

    def __len__(self) -> int:
        return self._size

    def column(self, name: str):
        return self.columns[name]

    def select(self, mask: np.ndarray) -> "RecordBatch":
        """Host-side row filter by boolean mask."""
        cols = {k: np.asarray(v)[mask] for k, v in self.columns.items()}
        ts = (None if self.timestamps is None
              else np.asarray(self.timestamps)[mask])
        return RecordBatch(cols, ts)

    def __repr__(self) -> str:
        cols = {k: f"{np.asarray(v).dtype}{list(np.shape(v))}"
                for k, v in self.columns.items()}
        return f"RecordBatch(n={self._size}, cols={cols})"
