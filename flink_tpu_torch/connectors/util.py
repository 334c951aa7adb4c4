"""Shared connector helpers: JSON row encoding (the port's copy of
``json_default`` from ``flink_tpu/connectors/util.py``)."""

from __future__ import annotations

import numpy as np


def json_default(o):
    """``json.dumps(default=...)`` hook for numpy scalars and arrays
    (``formats/__init__.py`` aliases it)."""
    if isinstance(o, np.generic):
        return o.item()
    if isinstance(o, np.ndarray):
        return o.tolist()
    raise TypeError(f"not JSON serializable: {type(o)}")
