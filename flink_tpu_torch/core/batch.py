"""Stream elements, batched (numpy-only copy of ``flink_tpu/core/batch.py``).

The unit of flow is a columnar :class:`RecordBatch` of host numpy arrays;
control elements such as :class:`Watermark` flow individually and in order
between batches.  After a ``keyBy`` a batch also carries its key slot ids
and key groups; a :class:`TaggedBatch` is bound for one side output.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Mapping, Optional

import numpy as np

LONG_MIN = -(2 ** 63)
LONG_MAX = 2 ** 63 - 1

#: the watermark meaning "end of stream" (the reference's MAX_WATERMARK)
MAX_WATERMARK = LONG_MAX


class StreamElement:
    __slots__ = ()

    def is_batch(self) -> bool:
        return False


@dataclass(frozen=True)
class Watermark(StreamElement):
    """Event-time watermark: no element with ts <= this will arrive later."""

    timestamp: int


@dataclass(frozen=True)
class OutputTag:
    """Names a side output (``OutputTag`` analog)."""

    name: str


class TaggedBatch(StreamElement):
    """A batch bound for a side output: only the ``SideOutputOperator`` of
    its tag takes it; every other consumer drops it."""

    __slots__ = ("tag", "batch")

    def __init__(self, tag: str, batch: "RecordBatch"):
        self.tag = tag
        self.batch = batch


class RecordBatch(StreamElement):
    """Columnar record batch.

    columns:    name -> array [B, ...]
    timestamps: int64[B] event timestamps in ms, or None
    key_ids:    int32[B] dense key slot ids (after keying), or None
    key_groups: int32[B] key group per record (after keying), or None
    """

    __slots__ = ("columns", "timestamps", "key_ids", "key_groups", "_size")

    def __init__(self, columns: Mapping[str, Any], timestamps=None,
                 key_ids=None, key_groups=None):
        self.columns: Dict[str, Any] = dict(columns)
        self.timestamps = timestamps
        self.key_ids = key_ids
        self.key_groups = key_groups
        if self.columns:
            self._size = int(np.shape(next(iter(self.columns.values())))[0])
        elif timestamps is not None:
            self._size = int(np.shape(timestamps)[0])
        else:
            self._size = 0
        # row alignment: a size-changing map that kept stale timestamps or
        # key ids would attribute rows to the wrong keys
        for attr in ("timestamps", "key_ids", "key_groups"):
            v = getattr(self, attr)
            if v is not None and int(np.shape(v)[0]) != self._size:
                raise ValueError(f"{attr} length {int(np.shape(v)[0])} != "
                                 f"batch size {self._size}")
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

    def with_columns(self, columns: Mapping[str, Any]) -> "RecordBatch":
        return RecordBatch(columns, self.timestamps, self.key_ids,
                           self.key_groups)

    def with_keys(self, key_ids, key_groups=None) -> "RecordBatch":
        return RecordBatch(self.columns, self.timestamps, key_ids, key_groups)

    def with_timestamps(self, timestamps) -> "RecordBatch":
        return RecordBatch(self.columns, timestamps, self.key_ids,
                           self.key_groups)

    def _rows(self, sel) -> "RecordBatch":
        cols = {k: np.asarray(v)[sel] for k, v in self.columns.items()}
        meta = [None if a is None else np.asarray(a)[sel]
                for a in (self.timestamps, self.key_ids, self.key_groups)]
        return RecordBatch(cols, *meta)

    def select(self, mask: np.ndarray) -> "RecordBatch":
        """Host-side row filter by boolean mask."""
        return self._rows(mask)

    def take(self, indices: np.ndarray) -> "RecordBatch":
        """Host-side row gather by index."""
        return self._rows(indices)

    @staticmethod
    def from_rows(rows: List[Mapping[str, Any]],
                  timestamps: Optional[List[int]] = None) -> "RecordBatch":
        """List of dict rows -> columnar batch."""
        if not rows:
            return RecordBatch({})
        cols = {n: np.asarray([r[n] for r in rows]) for n in rows[0].keys()}
        ts = (np.asarray(timestamps, np.int64) if timestamps is not None
              else None)
        return RecordBatch(cols, ts)

    def to_rows(self) -> List[Dict[str, Any]]:
        arrs = {k: np.asarray(v) for k, v in self.columns.items()}

        def cell(a, i):
            x = a[i]
            # numpy scalars as Python values; object cells and sub-arrays
            # pass through
            return x.item() if isinstance(x, np.generic) else x

        return [{k: cell(a, i) for k, a in arrs.items()}
                for i in range(self._size)]

    def __repr__(self) -> str:
        cols = {k: f"{np.asarray(v).dtype}{list(np.shape(v))}"
                for k, v in self.columns.items()}
        return (f"RecordBatch(n={self._size}, cols={cols}, "
                f"keyed={self.key_ids is not None})")
