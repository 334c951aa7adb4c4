"""Shared connector helpers: JSON row encoding and rows→RecordBatch
assembly (the port's copy of ``flink_tpu/connectors/util.py``)."""

from __future__ import annotations

from typing import List, Optional

import numpy as np


def json_default(o):
    """``json.dumps(default=...)`` hook for numpy scalars and arrays
    (``formats/__init__.py`` aliases it)."""
    if isinstance(o, np.generic):
        return o.item()
    if isinstance(o, np.ndarray):
        return o.tolist()
    raise TypeError(f"not JSON serializable: {type(o)}")


def rows_to_batch(rows: List[dict],
                  timestamp_column: Optional[str] = None):
    """Row dicts → RecordBatch with typed columns: the column set is the
    UNION over all rows (sparse fields fill with None → object dtype),
    numeric columns come out int64/float64, mixed-type columns fall back
    to object (never silent string coercion)."""
    from flink_tpu_torch.core.batch import RecordBatch
    from flink_tpu_torch.formats import _coerce_columns

    cols = _coerce_columns(rows)
    ts = (np.asarray(cols[timestamp_column], np.int64)
          if timestamp_column and timestamp_column in cols else None)
    return RecordBatch(cols, timestamps=ts)
