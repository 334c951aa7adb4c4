"""State carried across: snapshots between the JAX operator and the port.

A stream processor's "weights" are its state.  Both packages' window
operators snapshot to a dict of numpy arrays in the same dense format (the
JAX operator's mirror-sourced snapshot):

    pane_base, max_pane, last_fired_window, watermark, late_dropped, P
    key_index = {"reverse": int64[n]}, key_index_kind = "KeyIndex"
        (object keys: {"reverse": object[n]}, "ObjectKeyIndex")
    panes int64[m], counts int32[n, m], leaves [f32[n, m], ...], leaf_schema

so :func:`snapshot_from_jax` and :func:`snapshot_to_jax` mostly validate and
fix dtypes.  A mesh snapshot's per-shard slices (``shard_slices`` with its
``shard_layout`` manifest, ``state/shard_layout.py``) cross over as slices,
each slice's arrays fixed like the dense ones.  Count-trigger registers
cross over both ways (``count_baselines``: window -> int64 ``[n]``;
``value_baselines``: window -> one array per accumulator leaf, in the leaf
dtypes).

Incremental checkpoints' increment nodes cross over both ways: a window
operator's ``window_delta`` increment through :func:`window_delta_from_jax`
and :func:`window_delta_to_jax` (its cells, key tail, baselines and meta
fixed like a full snapshot's), a changelog backend's ``changelog``
increment through :func:`changelog_increment_from_jax` and
:func:`changelog_increment_to_jax` (its logged registrations take the
restoring job's descriptors, as the full changelog snapshot's do).  A
MiniCluster checkpoint tree (``{uid: {"subtasks": [...]}}`` with
``__job__`` and ``__enumerators__``) crosses through
:func:`job_checkpoint_from_jax` and :func:`job_checkpoint_to_jax`: each
subtask's operator state goes through the converter of its kind (chains
member by member), source positions and valves cross as they are, and the
persisted in-flight elements of unaligned channel state are rebuilt as
the other package's stream elements.

The basic operators' keyed snapshots (``KeyedReduceOperator``:
``keys``/``key_index_kind``/``leaves``; ``ExtremumByOperator``:
``state.vals``/``state.rows``) cross over through
:func:`keyed_snapshot_from_jax` and :func:`keyed_snapshot_to_jax`.

Session snapshots (``SessionWindowOperator`` and its mesh subclass: raw
``session_keys``, ``start``/``end``/``fired`` per live session, ``acc`` one
array per accumulator leaf, ``watermark``, ``late_dropped``, optional
distinct ``sets``) cross over through :func:`session_snapshot_from_jax` and
:func:`session_snapshot_to_jax`; the evicting lane's
(``DeviceEvictingWindowOperator``: the pane bookkeeping, the key index and
the live raw elements ``vals`` f32, ``keys`` int32, absolute ``panes`` and
``ts`` int64) through :func:`evicting_snapshot_from_jax` and
:func:`evicting_snapshot_to_jax`.  Session accumulator leaves go to JAX in
the dtypes JAX holds them in with x64 off: a 64-bit leaf (the port's
``SumAggregator(torch.int64)``) narrows to 32 bits, as JAX would have
folded it.

CEP snapshots (``CepOperator``, either engine: ``buffers`` key -> event
entries ``(ts, eid, bits, ubits, row)``, ``nfas`` key -> ``(partials,
skip_until_ts, rows)``, ``last_rows``, ``next_event_id``, ``watermark``)
carry partial matches as instances of the owning package's ``_Partial``,
which the other package cannot import.  :func:`cep_snapshot_from_jax`
rebuilds them field by field (``stage_i``, ``count``, ``events``,
``first_ts``, ``greedy_from``) as the port's; :func:`cep_snapshot_to_jax`
gives tuples in that field order, or instances of the class passed in.
Rows, bits and the scalars cross as they are.

``ChangelogGroupAggOperator`` snapshots (``key_index`` ``{"reverse":
int64[n]}`` with ``key_index_kind``, ``state`` a list of f32 ``[n]`` words,
(hi, lo) per aggregate column; or the legacy ``groups`` dict) cross over
through :func:`changelog_agg_snapshot_from_jax` and
:func:`changelog_agg_snapshot_to_jax`, which fix dtypes and refuse object
keys.  The join operators' snapshots (``IntervalJoinOperator``,
``WindowJoinOperator``, ``SqlJoinOperator``, ``StreamingJoinOperator``) are
the same numpy and object arrays in both packages and restore across as
they are.

Keyed-state backend snapshots (``state/heap.py`` ``HeapKeyedStateBackend``;
``KeyedProcessOperator``'s, which add ``timers`` on raw keys) are the same
numpy trees in both packages and restore across as they are, with one
exception: JAX without x64 holds a 64-bit accumulator leaf (an aggregating
or reducing state over ``SumAggregator(int64)``, say) as 32 bits, so
:func:`heap_snapshot_to_jax` narrows such leaves and their ``leaf_schema``
(the port restores JAX's 32-bit leaves by widening them, as schema
evolution allows).  A ``ChangelogKeyedStateBackend`` snapshot's log also
holds the state descriptors, which are code of the package that wrote it
(a reducing descriptor holds its aggregate):
:func:`changelog_snapshot_from_jax` and :func:`changelog_snapshot_to_jax`
put the restoring job's own descriptors in their place, by state name.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import numpy as np

from flink_tpu_torch.state.shard_layout import (LAYOUT_KEY, SLICES_KEY,
                                                densify_keyed_snapshot)

_SCALARS = ("pane_base", "max_pane", "last_fired_window", "watermark",
            "late_dropped", "P")


def _optional_int(v):
    return None if v is None else int(v)


def _key_reverse(reverse, kind: str, source: str) -> np.ndarray:
    """A snapshot's slot -> key table in the dtype its index kind holds:
    int64 for ``"KeyIndex"``, a 1-D object array for ``"ObjectKeyIndex"``
    (JAX's builds its table with ``np.asarray(list, object)``, which makes
    tuple keys the rows of a 2-D array; they come back as tuples)."""
    if kind == "KeyIndex":
        return np.ascontiguousarray(reverse, np.int64)
    if kind != "ObjectKeyIndex":
        raise ValueError(f"{source} snapshot key index is {kind!r}")
    reverse = np.asarray(reverse, object)
    out = np.empty(len(reverse), object)
    out[:] = ([tuple(r) for r in reverse.tolist()] if reverse.ndim > 1
              else reverse.tolist())
    return out


def _key_index_part(snap: Dict[str, Any], source: str, out: Dict[str, Any],
                    field: str = "key_index") -> np.ndarray:
    """Carry ``snap[field]`` and its ``key_index_kind`` into ``out``; returns
    the slot -> key table."""
    kind = snap.get("key_index_kind", "KeyIndex")
    rev = _key_reverse(snap[field]["reverse"], kind, source)
    out[field] = {"reverse": rev}
    out["key_index_kind"] = kind
    return rev


def _normalize(snap: Dict[str, Any], source: str) -> Dict[str, Any]:
    if snap.get("__increment__"):
        return _normalize_window_delta(snap, source)
    missing = [k for k in ("pane_base", "max_pane", "last_fired_window",
                           "watermark", "P") if k not in snap]
    if missing:
        raise ValueError(f"{source} snapshot lacks {missing}")
    out: Dict[str, Any] = {k: _optional_int(snap.get(k, 0))
                           for k in _SCALARS}
    if "key_index" in snap:
        _key_index_part(snap, source, out)
    _baselines(snap, out)
    if SLICES_KEY in snap:
        # validate the slices as the dense state they tile, then carry them
        dense = _normalize(densify_keyed_snapshot(snap), source)
        out["panes"] = dense["panes"]
        out["leaf_schema"] = dense["leaf_schema"]
        out[SLICES_KEY] = [
            {"shard": int(s["shard"]),
             "row_range": tuple(int(r) for r in s["row_range"]),
             "key_groups": tuple(int(g) for g in s["key_groups"]),
             "counts": np.ascontiguousarray(s["counts"], np.int32),
             "leaves": [np.ascontiguousarray(l) for l in s["leaves"]]}
            for s in snap[SLICES_KEY]]
        out[LAYOUT_KEY] = {k: int(v) for k, v in snap[LAYOUT_KEY].items()}
        return out
    if "leaves" in snap:
        panes = np.ascontiguousarray(snap["panes"], np.int64)
        counts = np.ascontiguousarray(snap["counts"], np.int32)
        n = out["key_index"]["reverse"].size if "key_index" in out else None
        if counts.ndim != 2 or counts.shape[1] != panes.size \
                or (n is not None and counts.shape[0] != n):
            raise ValueError(f"{source} snapshot counts {counts.shape} do not "
                             f"match {panes.size} panes x {n} keys")
        leaves = [np.ascontiguousarray(l) for l in snap["leaves"]]
        for l in leaves:
            if l.shape[:2] != counts.shape:
                raise ValueError(f"{source} snapshot leaf {l.shape} does not "
                                 f"match counts {counts.shape}")
        out["panes"] = panes
        out["counts"] = counts
        out["leaves"] = leaves
        schema = snap.get("leaf_schema")
        out["leaf_schema"] = (
            [{"name": str(s["name"]), "dtype": str(s["dtype"])}
             for s in schema] if schema is not None
            else [{"name": f"[{i}]", "dtype": l.dtype.name}
                  for i, l in enumerate(leaves)])
        for s, l in zip(out["leaf_schema"], leaves):
            if np.dtype(s["dtype"]) != l.dtype:
                raise ValueError(f"{source} snapshot leaf {s['name']!r} is "
                                 f"{l.dtype}, its schema says {s['dtype']}")
    return out


def _baselines(snap: Dict[str, Any], out: Dict[str, Any]) -> None:
    """The count-trigger registers, dtypes fixed: int64 counts, and the
    value baselines in their leaf dtypes (the schema's, where the snapshot
    has one)."""
    if snap.get("count_baselines"):
        out["count_baselines"] = {
            int(w): np.ascontiguousarray(b, np.int64)
            for w, b in snap["count_baselines"].items()}
    if snap.get("value_baselines"):
        dtypes = [np.dtype(s["dtype"]) for s in snap.get("leaf_schema")
                  or ()]
        out["value_baselines"] = {
            int(w): [np.ascontiguousarray(l, dtypes[j] if j < len(dtypes)
                                          else None)
                     for j, l in enumerate(leaves)]
            for w, leaves in snap["value_baselines"].items()}


def _normalize_keyed(snap: Dict[str, Any], source: str) -> Dict[str, Any]:
    if snap.get("empty", True):
        return {"empty": True}
    out: Dict[str, Any] = {"empty": False}
    n = _key_index_part(snap, source, out, "keys").size
    if "leaves" in snap:
        out["leaves"] = [np.ascontiguousarray(l) for l in snap["leaves"]]
        rows = [l.shape[0] for l in out["leaves"]]
    else:
        out["state.vals"] = np.ascontiguousarray(snap["state.vals"],
                                                 np.float64)
        out["state.rows"] = np.asarray(snap["state.rows"], object)
        rows = [out["state.vals"].shape[0], out["state.rows"].shape[0]]
    if any(r != n for r in rows):
        raise ValueError(f"{source} keyed snapshot rows {rows} do not match "
                         f"{n} keys")
    return out


def keyed_snapshot_from_jax(snap: Dict[str, Any]) -> Dict[str, Any]:
    """A JAX basic operator's keyed snapshot (``KeyedReduceOperator``,
    ``ExtremumByOperator``) -> the port's format."""
    return _normalize_keyed(snap, "JAX")


def keyed_snapshot_to_jax(snap: Dict[str, Any]) -> Dict[str, Any]:
    """A port basic operator's keyed snapshot -> the JAX operator's."""
    return _normalize_keyed(snap, "port")


def snapshot_from_jax(snap: Dict[str, Any]) -> Dict[str, Any]:
    """A JAX ``WindowAggOperator.snapshot_state()`` dict -> the port's
    format (ready for the port's ``restore_state``)."""
    return _normalize(snap, "JAX")


def snapshot_to_jax(snap: Dict[str, Any]) -> Dict[str, Any]:
    """A port ``WindowAggOperator.snapshot_state()`` dict -> the JAX
    operator's format (ready for its ``restore_state``)."""
    return _normalize(snap, "port")


#: 64-bit dtypes and the 32-bit ones JAX stores them as with x64 off
_X64_OFF = {np.dtype(np.float64): np.float32, np.dtype(np.int64): np.int32,
            np.dtype(np.uint64): np.uint32}


def _normalize_session(snap: Dict[str, Any], source: str,
                       x64_off: bool = False) -> Dict[str, Any]:
    keys = np.ascontiguousarray(snap.get("session_keys", ()), np.int64)
    n = keys.size
    out: Dict[str, Any] = {
        "session_keys": keys,
        "start": np.ascontiguousarray(snap.get("start", ()), np.int64),
        "end": np.ascontiguousarray(snap.get("end", ()), np.int64),
        "fired": np.ascontiguousarray(snap.get("fired", ()), bool),
        "watermark": int(snap.get("watermark", -(2 ** 63))),
        "late_dropped": int(snap.get("late_dropped", 0)),
    }
    acc = [np.asarray(a) for a in snap.get("acc", ())]
    if x64_off:
        acc = [a.astype(_X64_OFF.get(a.dtype, a.dtype), copy=False)
               for a in acc]
    out["acc"] = tuple(np.ascontiguousarray(a) for a in acc)
    rows = [out[f].shape[0] for f in ("start", "end", "fired")] + [
        a.shape[0] for a in out["acc"]]
    if "sets" in snap:
        out["sets"] = [list(s) for s in snap["sets"]]
        rows.append(len(out["sets"]))
    if any(r != n for r in rows):
        raise ValueError(f"{source} session snapshot rows {rows} do not "
                         f"match {n} session keys")
    return out


def session_snapshot_from_jax(snap: Dict[str, Any]) -> Dict[str, Any]:
    """A JAX session operator's snapshot -> the port's format (a restore
    casts each leaf into the port's accumulator dtype)."""
    return _normalize_session(snap, "JAX")


def session_snapshot_to_jax(snap: Dict[str, Any]) -> Dict[str, Any]:
    """A port session operator's snapshot -> the JAX operator's format, its
    64-bit accumulator leaves narrowed as JAX holds them with x64 off."""
    return _normalize_session(snap, "port", x64_off=True)


def _normalize_evicting(snap: Dict[str, Any], source: str) -> Dict[str, Any]:
    missing = [k for k in ("pane_base", "max_pane", "last_fired_window",
                           "watermark") if k not in snap]
    if missing:
        raise ValueError(f"{source} evicting snapshot lacks {missing}")
    out: Dict[str, Any] = {k: _optional_int(snap[k])
                           for k in ("pane_base", "max_pane",
                                     "last_fired_window", "watermark")}
    out["late_dropped"] = int(snap.get("late_dropped", 0))
    if "key_index" in snap:
        _key_index_part(snap, source, out)
    if "vals" in snap:
        cols = {"vals": np.float32, "keys": np.int32, "panes": np.int64,
                "ts": np.int64}
        for k, dt in cols.items():
            out[k] = np.ascontiguousarray(snap[k], dt)
        rows = {k: out[k].shape for k in cols}
        if len(set(rows.values())) != 1 or out["vals"].ndim != 1:
            raise ValueError(f"{source} evicting snapshot columns {rows} "
                             f"differ")
    return out


def evicting_snapshot_from_jax(snap: Dict[str, Any]) -> Dict[str, Any]:
    """A JAX ``DeviceEvictingWindowOperator`` snapshot -> the port's."""
    return _normalize_evicting(snap, "JAX")


def evicting_snapshot_to_jax(snap: Dict[str, Any]) -> Dict[str, Any]:
    """A port ``DeviceEvictingWindowOperator`` snapshot -> JAX's."""
    return _normalize_evicting(snap, "port")


_PARTIAL_FIELDS = ("stage_i", "count", "events", "first_ts", "greedy_from")


def _cep_snapshot(snap: Dict[str, Any], partial: Callable,
                  source: str) -> Dict[str, Any]:
    missing = [k for k in ("buffers", "nfas", "next_event_id", "watermark")
               if k not in snap]
    if missing:
        raise ValueError(f"{source} CEP snapshot lacks {missing}")

    def convert(pm):
        fields = (tuple(pm) if isinstance(pm, tuple)
                  else tuple(getattr(pm, f) for f in _PARTIAL_FIELDS))
        stage_i, count, events, first_ts, greedy_from = fields
        return partial(int(stage_i), int(count),
                       tuple((int(s), int(e)) for s, e in events),
                       int(first_ts), int(greedy_from))

    return {
        "buffers": {k: [tuple(e) for e in v]
                    for k, v in snap["buffers"].items()},
        "nfas": {k: ([convert(pm) for pm in partials], int(skip_ts),
                     dict(rows))
                 for k, (partials, skip_ts, rows) in snap["nfas"].items()},
        "last_rows": dict(snap.get("last_rows", {})),
        "next_event_id": int(snap["next_event_id"]),
        "watermark": int(snap["watermark"]),
    }


def cep_snapshot_from_jax(snap: Dict[str, Any]) -> Dict[str, Any]:
    """A JAX ``CepOperator`` snapshot -> the port's (its ``_Partial``
    instances rebuilt as the port's)."""
    from flink_tpu_torch.cep.operator import _Partial
    return _cep_snapshot(snap, _Partial, "JAX")


def cep_snapshot_to_jax(snap: Dict[str, Any],
                        partial: Optional[Callable] = None) -> Dict[str, Any]:
    """A port ``CepOperator`` snapshot -> JAX's layout.  Each partial match
    becomes ``partial(stage_i, count, events, first_ts, greedy_from)`` —
    pass JAX's ``_Partial`` — or, without ``partial``, that tuple."""
    return _cep_snapshot(snap, partial if partial is not None
                         else (lambda *fields: fields), "port")


def _changelog_agg_snapshot(snap: Dict[str, Any], source: str
                            ) -> Dict[str, Any]:
    if "groups" in snap:
        return {"groups": {k: dict(v) for k, v in snap["groups"].items()}}
    if "key_index" not in snap:
        return {}
    out: Dict[str, Any] = {}
    rev = _key_index_part(snap, source, out)
    if "state" in snap:
        out["state"] = [np.ascontiguousarray(a, np.float32)
                        for a in snap["state"]]
        rows = {a.shape for a in out["state"]}
        if rows != {(rev.size,)}:
            raise ValueError(f"{source} changelog snapshot words {rows} do "
                             f"not match {rev.size} keys")
    return out


def changelog_agg_snapshot_from_jax(snap: Dict[str, Any]) -> Dict[str, Any]:
    """A JAX ``ChangelogGroupAggOperator`` snapshot -> the port's."""
    return _changelog_agg_snapshot(snap, "JAX")


def changelog_agg_snapshot_to_jax(snap: Dict[str, Any]) -> Dict[str, Any]:
    """A port ``ChangelogGroupAggOperator`` snapshot -> JAX's."""
    return _changelog_agg_snapshot(snap, "port")


# ---------------------------------------------------------------------------
# keyed-state backends: the heap, the process operator, the changelog
# ---------------------------------------------------------------------------

def heap_snapshot_to_jax(snap: Dict[str, Any]) -> Dict[str, Any]:
    """A port keyed-backend snapshot (or a process operator's) -> JAX's:
    every 64-bit accumulator leaf of an aggregating or reducing state, and
    its ``leaf_schema`` entry, narrowed to 32 bits.  Everything else crosses
    as it is."""
    out = dict(snap)
    for field, schema in snap.items():
        if not (field.startswith("state.")
                and field.endswith(".leaf_schema")):
            continue
        rows_field = field[:-len("leaf_schema")] + "rows"
        narrow = [np.dtype(_X64_OFF.get(np.dtype(e["dtype"]),
                                        np.dtype(e["dtype"])))
                  for e in schema]
        out[field] = [dict(e, dtype=d.name) for e, d in zip(schema, narrow)]
        if rows_field in snap:
            out[rows_field] = tuple(np.asarray(r).astype(d, copy=False)
                                    for r, d in zip(snap[rows_field],
                                                    narrow))
    return out


def _changelog_snapshot(snap: Dict[str, Any], descriptors: Dict[str, Any],
                        convert: Callable) -> Dict[str, Any]:
    if not snap.get("changelog_backend"):
        return convert(snap)
    log = []
    for entry in snap.get("changelog", []):
        if entry[0] == "register":
            name = entry[1].name
            if name not in descriptors:
                raise ValueError(f"no descriptor for the changelog's state "
                                 f"{name!r}: pass the restoring job's own")
            entry = ("register", descriptors[name])
        log.append(entry)
    out = dict(snap)
    out["changelog"] = log
    if snap.get("materialized") is not None:
        out["materialized"] = convert(snap["materialized"])
    return out


def changelog_snapshot_from_jax(snap: Dict[str, Any],
                                descriptors: Dict[str, Any]
                                ) -> Dict[str, Any]:
    """A JAX ``ChangelogKeyedStateBackend`` snapshot (or a process
    operator's over one) -> the port's: each logged registration takes the
    port descriptor of its state's name from ``descriptors``."""
    return _changelog_snapshot(snap, descriptors, dict)


def changelog_snapshot_to_jax(snap: Dict[str, Any],
                              descriptors: Dict[str, Any]) -> Dict[str, Any]:
    """A port ``ChangelogKeyedStateBackend`` snapshot -> JAX's: the logged
    registrations take the JAX descriptors in ``descriptors`` (by state
    name) and the materialized base goes through
    :func:`heap_snapshot_to_jax`."""
    return _changelog_snapshot(snap, descriptors, heap_snapshot_to_jax)


# ---------------------------------------------------------------------------
# incremental checkpoints: increment nodes and MiniCluster checkpoint trees
# ---------------------------------------------------------------------------

def _normalize_window_delta(inc: Dict[str, Any], source: str
                            ) -> Dict[str, Any]:
    if inc.get("kind") != "window_delta":
        raise ValueError(f"{source} snapshot carries __increment__ of kind "
                         f"{inc.get('kind')!r}, not a window_delta")
    meta = inc["meta"]
    kind = inc.get("key_index_kind", "KeyIndex")
    out: Dict[str, Any] = {
        "__increment__": 1, "kind": "window_delta",
        "checkpoint_id": int(inc["checkpoint_id"]), "n": int(inc["n"]),
        "base_n": int(inc["base_n"]), "has_grid": bool(inc["has_grid"]),
        "meta": {k: _optional_int(meta.get(k, 0)) for k in _SCALARS},
        "key_index_kind": kind,
        "key_tail": _key_reverse(inc["key_tail"], kind, source),
    }
    leaf_meta = [(np.asarray(init, np.dtype(d)), str(np.dtype(d)),
                  tuple(int(x) for x in shape))
                 for init, d, shape in inc.get("leaf_meta", ())]
    out["leaf_meta"] = leaf_meta
    dtypes = [np.dtype(d) for _init, d, _shape in leaf_meta]
    cells = []
    for c in inc.get("cells", ()):
        gids = np.ascontiguousarray(c["gids"], np.int64)
        cell = {"pane": int(c["pane"]), "gids": gids,
                "counts": np.ascontiguousarray(c["counts"], np.int32),
                "leaves": [np.ascontiguousarray(l, dtypes[j]
                                                if j < len(dtypes) else None)
                           for j, l in enumerate(c["leaves"])]}
        rows = {a.shape[0] for a in [cell["counts"], *cell["leaves"]]}
        if rows - {gids.size}:
            raise ValueError(f"{source} increment cell of pane "
                             f"{cell['pane']} has rows {rows} for "
                             f"{gids.size} keys")
        cells.append(cell)
    out["cells"] = cells
    if "leaf_schema" in inc:
        out["leaf_schema"] = [{"name": str(e["name"]),
                               "dtype": str(e["dtype"])}
                              for e in inc["leaf_schema"]]
    if inc.get("paging_stats") is not None:
        out["paging_stats"] = {str(k): int(v)
                               for k, v in inc["paging_stats"].items()}
    _baselines({"count_baselines": inc.get("count_baselines"),
                "value_baselines": inc.get("value_baselines"),
                "leaf_schema": out.get("leaf_schema")}, out)
    out.setdefault("count_baselines", {})
    out.setdefault("value_baselines", {})
    out["cb_drops"] = sorted(int(w) for w in inc.get("cb_drops", ()))
    out["vb_drops"] = sorted(int(w) for w in inc.get("vb_drops", ()))
    return out


def window_delta_from_jax(inc: Dict[str, Any]) -> Dict[str, Any]:
    """A JAX window operator's ``window_delta`` increment -> the port's."""
    return _normalize_window_delta(inc, "JAX")


def window_delta_to_jax(inc: Dict[str, Any]) -> Dict[str, Any]:
    """A port window operator's ``window_delta`` increment -> JAX's."""
    return _normalize_window_delta(inc, "port")


def _changelog_increment(inc: Dict[str, Any], descriptors: Dict[str, Any],
                         source: str) -> Dict[str, Any]:
    if inc.get("kind") != "changelog":
        raise ValueError(f"{source} increment is {inc.get('kind')!r}, not "
                         f"a changelog increment")
    suffix = _changelog_snapshot(
        {"changelog_backend": True, "changelog": inc.get("log_suffix", [])},
        descriptors, dict)["changelog"]
    return {"__increment__": 1, "kind": "changelog",
            "checkpoint_id": int(inc["checkpoint_id"]),
            "log_base": int(inc["log_base"]), "log_suffix": suffix,
            "extras": dict(inc.get("extras", {}))}


def changelog_increment_from_jax(inc: Dict[str, Any],
                                 descriptors: Optional[Dict[str, Any]] = None
                                 ) -> Dict[str, Any]:
    """A JAX changelog backend's ``changelog`` increment (or a process
    operator's, its timers in ``extras``) -> the port's: the suffix's
    logged registrations take the port descriptors in ``descriptors``."""
    return _changelog_increment(inc, descriptors or {}, "JAX")


def changelog_increment_to_jax(inc: Dict[str, Any],
                               descriptors: Optional[Dict[str, Any]] = None
                               ) -> Dict[str, Any]:
    """A port ``changelog`` increment -> JAX's (registrations take the JAX
    descriptors in ``descriptors``)."""
    return _changelog_increment(inc, descriptors or {}, "port")


def _operator_state(snap: Any, source: str, descriptors: Dict[str, Any]
                    ) -> Any:
    """One subtask's operator state through the converter of its kind: a
    chain member by member, a window snapshot or increment, a changelog
    increment or snapshot; every other state (sources, sinks, the heap,
    joins, sessions' numpy trees) as it is."""
    if not isinstance(snap, dict):
        return snap
    if snap.get("__increment__"):
        if snap.get("kind") == "changelog":
            return _changelog_increment(snap, descriptors, source)
        return _normalize_window_delta(snap, source)
    if "pane_base" in snap and "P" in snap:
        return _normalize(snap, source)
    if snap.get("changelog_backend"):
        return _changelog_snapshot(snap, descriptors, dict)
    if any(k.startswith("op") and k[2:].isdigit() for k in snap):
        return {k: (_operator_state(v, source, descriptors)
                    if k.startswith("op") and k[2:].isdigit() else v)
                for k, v in snap.items()}
    return snap


def _element(el: Any, batch_module) -> Any:
    """A stream element of either package as ``batch_module``'s class of
    the same name (``core/batch.py`` of the receiving package)."""
    name = type(el).__name__
    cls = getattr(batch_module, name)
    if name == "RecordBatch":
        out = cls({k: np.asarray(v) for k, v in el.columns.items()},
                  timestamps=(None if el.timestamps is None
                              else np.asarray(el.timestamps)))
        for f in ("key_ids", "key_groups"):
            v = getattr(el, f, None)
            if v is not None:
                setattr(out, f, np.asarray(v))
        return out
    if name == "TaggedBatch":
        return cls(el.tag, _element(el.batch, batch_module))
    fields = getattr(el, "__dataclass_fields__", None)
    if fields is None:
        raise ValueError(f"no converter for the stream element {name}")
    return cls(**{f: getattr(el, f) for f in fields})


def _job_checkpoint(tree: Dict[str, Any], source: str,
                    descriptors: Dict[str, Any], batch_module
                    ) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for uid, entry in tree.items():
        if uid.startswith("__") or not isinstance(entry, dict) \
                or "subtasks" not in entry:
            out[uid] = entry
            continue
        subs = []
        for sub in entry["subtasks"]:
            if not isinstance(sub, dict):
                subs.append(sub)
                continue
            sub = dict(sub)
            if "operator" in sub:
                sub["operator"] = _operator_state(sub["operator"], source,
                                                  descriptors)
            cs = sub.get("channel_state")
            if isinstance(cs, dict) and cs.get("elements"):
                if batch_module is None:
                    raise ValueError("the checkpoint holds in-flight "
                                     "elements: pass the receiving "
                                     "package's core.batch module")
                cs = dict(cs)
                cs["elements"] = [(i, _element(el, batch_module))
                                  for i, el in cs["elements"]]
                sub["channel_state"] = cs
            subs.append(sub)
        out[uid] = dict(entry, subtasks=subs)
    return out


def job_checkpoint_from_jax(tree: Dict[str, Any],
                            descriptors: Optional[Dict[str, Any]] = None
                            ) -> Dict[str, Any]:
    """A JAX MiniCluster checkpoint (resolved, or raw with increment nodes)
    -> the port's: operator states by kind, in-flight elements as the
    port's stream elements."""
    from flink_tpu_torch.core import batch
    return _job_checkpoint(tree, "JAX", descriptors or {}, batch)


def job_checkpoint_to_jax(tree: Dict[str, Any],
                          descriptors: Optional[Dict[str, Any]] = None,
                          batch_module=None) -> Dict[str, Any]:
    """A port MiniCluster checkpoint -> JAX's.  A tree with unaligned
    channel state needs ``batch_module``, the JAX package's
    ``core.batch``, to rebuild its in-flight elements."""
    return _job_checkpoint(tree, "port", descriptors or {}, batch_module)
