"""State schema evolution: versioned snapshots + compatibility resolution
(a copy of ``flink_tpu/state/evolution.py``, which imports no JAX).

Analog of the reference's serializer-snapshot machinery
(``TypeSerializerSnapshot.java:73`` written into every checkpoint,
``resolveSchemaCompatibility:132`` evaluated on restore, e2e-tested by
``flink-state-evolution-test``): every keyed snapshot carries a **schema
descriptor** (per-state dtype/shape/kind); on restore the old schema is
resolved against the registered descriptors:

- ``COMPATIBLE_AS_IS``      — identical layout, restore verbatim;
- ``COMPATIBLE_AFTER_MIGRATION`` — numeric widening (int32→int64,
  float32→float64, int→float) or added states: rows are cast / defaulted;
- ``INCOMPATIBLE``          — narrowing or kind changes: fail loudly
  (silent truncation is the one outcome the reference never allows).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

AS_IS = "COMPATIBLE_AS_IS"
AFTER_MIGRATION = "COMPATIBLE_AFTER_MIGRATION"
INCOMPATIBLE = "INCOMPATIBLE"

#: widening lattice: old dtype -> dtypes it may migrate to
_WIDENINGS = {
    "int8": {"int16", "int32", "int64", "float32", "float64"},
    "int16": {"int32", "int64", "float32", "float64"},
    "int32": {"int64", "float64"},
    "int64": {"float64"},
    "float32": {"float64"},
    "uint8": {"int16", "int32", "int64", "uint16", "uint32", "float32",
              "float64"},
}


def schema_of_backend(backend) -> Dict[str, Dict[str, Any]]:
    """Schema descriptor of a keyed backend's registered states."""
    out: Dict[str, Dict[str, Any]] = {}
    for name, desc in getattr(backend, "_descs", {}).items():
        out[name] = schema_of_descriptor(desc)
    return out


def schema_of_descriptor(desc) -> Dict[str, Any]:
    dtype = getattr(desc, "dtype", None)
    return {
        "kind": getattr(desc, "kind", "value"),
        "dtype": (np.dtype(dtype).name if dtype is not None else None),
        "shape": tuple(getattr(desc, "shape", ()) or ()),
    }


def resolve_compatibility(old: Dict[str, Any],
                          new: Dict[str, Any]) -> str:
    """One state's old schema vs the newly registered descriptor
    (``resolveSchemaCompatibility`` analog)."""
    if old.get("kind") != new.get("kind"):
        return INCOMPATIBLE
    od, nd = old.get("dtype"), new.get("dtype")
    if tuple(old.get("shape", ())) != tuple(new.get("shape", ())):
        return INCOMPATIBLE
    if od == nd:
        return AS_IS
    if od is None or nd is None:
        # object-typed states (pickled rows): layout-free
        return AS_IS
    if nd in _WIDENINGS.get(od, ()):  # widening only
        return AFTER_MIGRATION
    return INCOMPATIBLE


class SchemaEvolutionError(ValueError):
    pass


def attach_schema(snapshot: Dict[str, Any], backend) -> Dict[str, Any]:
    """Write the schema descriptor into a keyed snapshot (checkpoint-time
    side of ``TypeSerializerSnapshot``)."""
    snapshot = dict(snapshot)
    snapshot["__schema__"] = schema_of_backend(backend)
    return snapshot


def migrate_snapshot(snapshot: Dict[str, Any],
                     new_descriptors: Dict[str, Any]) -> Dict[str, Any]:
    """Resolve + migrate a keyed snapshot against the job's CURRENT state
    descriptors; returns a restorable snapshot or raises
    :class:`SchemaEvolutionError` with the exact mismatch."""
    old_schema: Dict[str, Dict[str, Any]] = snapshot.get("__schema__", {})
    out = {k: v for k, v in snapshot.items() if k != "__schema__"}
    for name, desc in new_descriptors.items():
        new_s = schema_of_descriptor(desc)
        old_s = old_schema.get(name)
        if old_s is None:
            continue  # newly ADDED state: starts empty (compatible)
        verdict = resolve_compatibility(old_s, new_s)
        if verdict == INCOMPATIBLE:
            raise SchemaEvolutionError(
                f"state {name!r}: stored schema {old_s} is incompatible with "
                f"registered descriptor {new_s} (only widening migrations "
                f"are supported)")
        if verdict == AFTER_MIGRATION:
            target = np.dtype(new_s["dtype"])
            for field in list(out):
                if field.startswith(f"state.{name}.") and \
                        isinstance(out[field], np.ndarray) and \
                        out[field].dtype != object:
                    out[field] = out[field].astype(target)
    # states present in the snapshot but no longer registered restore as-is
    # (lazy-bound, dropped when never re-registered) — reference keeps
    # unknown state until explicitly removed via the State Processor API
    return out


# ---------------------------------------------------------------------------
# composite accumulator (ACC pytree) evolution
# ---------------------------------------------------------------------------

def acc_leaf_schema(spec) -> List[Dict[str, Any]]:
    """Per-leaf schema of an accumulator pytree (written into snapshots):
    the pytree key path is the leaf's evolution identity — dict-keyed ACC
    fields migrate by NAME, the POJO field-name matching of the reference's
    ``PojoSerializerSnapshot``."""
    names = spec.leaf_names or tuple(f"[{i}]" for i in range(spec.num_leaves))
    return [{"name": n, "dtype": np.dtype(d).name}
            for n, d in zip(names, spec.leaf_dtypes)]


def migrate_acc_leaves(old_leaves, old_schema: Optional[List[Dict[str, Any]]],
                       spec, default_fill) -> List[Any]:
    """Align snapshot leaf arrays with the CURRENT accumulator spec.

    - same name, same dtype   → restored verbatim;
    - same name, widened dtype → cast (``_WIDENINGS``);
    - new leaf (field ADDED)  → ``default_fill(leaf_index)`` supplies rows
      of the identity value in the caller's row geometry;
    - old leaf gone (REMOVED) → dropped;
    - narrowing/kind change   → :class:`SchemaEvolutionError`.

    Snapshots without a recorded schema (pre-evolution) must match leaf
    count exactly.
    """
    if old_schema is None:
        if len(old_leaves) != spec.num_leaves:
            raise SchemaEvolutionError(
                f"accumulator layout changed ({len(old_leaves)} stored "
                f"leaves vs {spec.num_leaves} registered) and the snapshot "
                f"carries no leaf schema to migrate by")
        return list(old_leaves)
    new_schema = acc_leaf_schema(spec)
    by_name = {s["name"]: i for i, s in enumerate(old_schema)}
    out: List[Any] = []
    for j, ns in enumerate(new_schema):
        i = by_name.get(ns["name"])
        if i is None:
            out.append(default_fill(j))
            continue
        arr = np.asarray(old_leaves[i])
        od, nd = old_schema[i]["dtype"], ns["dtype"]
        if od != nd:
            if nd not in _WIDENINGS.get(od, ()):
                raise SchemaEvolutionError(
                    f"accumulator leaf {ns['name']!r}: stored dtype {od} -> "
                    f"registered {nd} is not a widening migration")
            arr = arr.astype(nd)
        out.append(arr)
    return out
