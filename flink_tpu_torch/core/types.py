"""Type information for record columns (port of ``flink_tpu/core/types.py``).

Light-weight analog of the reference's type system
(``flink-core/src/main/java/org/apache/flink/api/common/typeinfo/TypeInformation``
→ ``TypeSerializer``): here a record type is a named tuple of columns, each
with a numpy dtype (or ``object`` for strings); serialization rides
numpy/arrow buffers instead of per-record serializers.  Schema evolution
(``TypeSerializerSnapshot.java:73``) maps to the snapshot carrying each
column's dtype + a compatibility check on restore (see
``flink_tpu/runtime/checkpoint/snapshot.py``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclass(frozen=True)
class FieldType:
    name: str
    dtype: np.dtype

    @property
    def is_object(self) -> bool:
        return self.dtype == np.dtype(object)


@dataclass(frozen=True)
class RowType:
    """Schema of a RecordBatch: ordered named columns."""

    fields: Tuple[FieldType, ...]

    @staticmethod
    def of(**kwargs) -> "RowType":
        return RowType(tuple(FieldType(k, np.dtype(v)) for k, v in kwargs.items()))

    def names(self) -> List[str]:
        return [f.name for f in self.fields]

    def dtype(self, name: str) -> np.dtype:
        for f in self.fields:
            if f.name == name:
                return f.dtype
        raise KeyError(name)

    def with_field(self, name: str, dtype) -> "RowType":
        return RowType(self.fields + (FieldType(name, np.dtype(dtype)),))

    def project(self, names: Sequence[str]) -> "RowType":
        by = {f.name: f for f in self.fields}
        return RowType(tuple(by[n] for n in names))

    def is_compatible_with(self, other: "RowType") -> bool:
        """Restore-time schema compatibility: same names, castable dtypes
        (``TypeSerializerSnapshot.resolveSchemaCompatibility:132`` analog)."""
        if self.names() != other.names():
            return False
        return all(np.can_cast(a.dtype, b.dtype, casting="same_kind") or a.dtype == b.dtype
                   for a, b in zip(self.fields, other.fields))

    def to_meta(self) -> List[Dict[str, str]]:
        return [{"name": f.name, "dtype": str(f.dtype)} for f in self.fields]

    @staticmethod
    def from_meta(meta: List[Dict[str, str]]) -> "RowType":
        return RowType(tuple(FieldType(m["name"], np.dtype(m["dtype"])) for m in meta))


class Types:
    """Shorthand dtype constants (``Types.java`` analog)."""

    BOOL = np.dtype(np.bool_)
    INT = np.dtype(np.int32)
    LONG = np.dtype(np.int64)
    FLOAT = np.dtype(np.float32)
    DOUBLE = np.dtype(np.float64)
    STRING = np.dtype(object)
    BYTE = np.dtype(np.int8)
    SHORT = np.dtype(np.int16)

    @staticmethod
    def infer(batch_columns: Dict[str, Any]) -> RowType:
        return RowType(tuple(FieldType(k, np.asarray(v).dtype) for k, v in batch_columns.items()))
