"""Changelog keyed-state backend: log mutations, materialize periodically
(port of ``flink_tpu/state/changelog.py``, host Python as JAX's).

Analog of the reference's changelog state backend
(``flink-statebackend-changelog/.../ChangelogKeyedStateBackend.java``,
``ChangelogAggregatingState.java``): wraps ANY inner keyed backend and
records every state mutation into an in-order changelog.  A checkpoint is
then ``(last materialized snapshot, changelog suffix)`` — near-constant-size
when mutations since the last materialization are few, enabling very frequent
checkpoints; ``materialize()`` takes a full inner snapshot and truncates the
log (the periodic materialization of the reference).

Replay correctness: key-slot assignment is part of the log — ``key_slots`` /
``set_current_key`` calls are recorded, so replay reproduces identical dense
slot ids in the restored inner backend.

The applier of :meth:`ChangelogKeyedStateBackend.snapshot_increment`'s
nodes is ``runtime/checkpoint/delta.py``; the increments themselves are
JAX's format.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from flink_tpu_torch.state import api as state_api
from flink_tpu_torch.state.api import StateDescriptor
from flink_tpu_torch.testing import chaos

#: mutating methods per state flavor — everything else passes through as read
_MUTATORS = {
    "update", "clear", "add", "add_all", "add_rows", "put", "put_all",
    "put_rows", "remove", "clear_rows",
}


class _ChangelogStateProxy:
    """Forwards reads to the inner state; records + forwards mutations."""

    def __init__(self, backend: "ChangelogKeyedStateBackend", name: str,
                 inner_state):
        object.__setattr__(self, "_backend", backend)
        object.__setattr__(self, "_name", name)
        object.__setattr__(self, "_inner", inner_state)

    def __getattr__(self, attr: str):
        target = getattr(self._inner, attr)
        if attr in _MUTATORS and callable(target):
            name = self._name
            backend = self._backend

            def recorded(*args, **kwargs):
                backend._log.append(("mutate", name, attr, args, kwargs))
                return target(*args, **kwargs)

            return recorded
        return target


class ChangelogKeyedStateBackend:
    """Wraps an inner keyed backend with a state changelog."""

    def __init__(self, inner):
        self.inner = inner
        self._log: List[Tuple] = []
        self._materialized: Optional[Dict[str, Any]] = None
        self._states: Dict[str, _ChangelogStateProxy] = {}
        self._descs: Dict[str, StateDescriptor] = {}
        # ---- incremental checkpointing: a cut may ship only the
        # log SUFFIX beyond the last CONFIRMED checkpoint's log position,
        # valid only within one materialization epoch (materialize() re-bases
        # the log, so positions across epochs are incomparable)
        self._epoch = 0
        #: auto-materialize when the log outgrows this (0 = manual only)
        self.materialize_threshold = 0
        self._unconfirmed: List[Tuple[int, int, int]] = []  # (cid,epoch,len)
        self._confirmed: Optional[Tuple[int, int]] = None   # (epoch, len)

    def reserve_managed(self, manager, owner: str) -> None:
        """Forward the managed-memory claim to the wrapped backend (the
        changelog itself is unbudgeted bookkeeping; the spill tier inside
        is what holds resident bytes)."""
        if hasattr(self.inner, "reserve_managed"):
            self.inner.reserve_managed(manager, owner)

    def close(self) -> None:
        if hasattr(self.inner, "close"):
            self.inner.close()

    # -- key plumbing (recorded: slot assignment must replay identically) ----
    @property
    def max_parallelism(self) -> int:
        return self.inner.max_parallelism

    @max_parallelism.setter
    def max_parallelism(self, value: int) -> None:
        self.inner.max_parallelism = value

    @property
    def num_keys(self) -> int:
        return self.inner.num_keys

    def key_slots(self, keys: np.ndarray) -> np.ndarray:
        self._log.append(("key_slots", np.asarray(keys)))
        return self.inner.key_slots(keys)

    def set_current_key(self, key) -> None:
        self._log.append(("set_current_key", key))
        self.inner.set_current_key(key)

    def current_slot(self) -> int:
        return self.inner.current_slot()

    def slot_keys(self, slots: np.ndarray) -> np.ndarray:
        return self.inner.slot_keys(slots)

    # -- states --------------------------------------------------------------
    def get_state(self, desc: StateDescriptor):
        proxy = self._states.get(desc.name)
        if proxy is None:
            self._log.append(("register", desc))
            proxy = _ChangelogStateProxy(self, desc.name,
                                         self.inner.get_state(desc))
            self._states[desc.name] = proxy
            self._descs[desc.name] = desc
        return proxy

    def value_state(self, name: str, **kw):
        return self.get_state(state_api.ValueStateDescriptor(name, **kw))

    def list_state(self, name: str, **kw):
        return self.get_state(state_api.ListStateDescriptor(name, **kw))

    def map_state(self, name: str, **kw):
        return self.get_state(state_api.MapStateDescriptor(name, **kw))

    def reducing_state(self, name: str, reduce_fn, **kw):
        return self.get_state(
            state_api.ReducingStateDescriptor(name, reduce_fn, **kw))

    def aggregating_state(self, name: str, agg, **kw):
        return self.get_state(state_api.AggregatingStateDescriptor(name, agg, **kw))

    # -- changelog lifecycle -------------------------------------------------
    def materialize(self) -> None:
        """Full inner snapshot; truncate the log (periodic materialization).
        The truncated log is re-seeded with register entries so later
        mutations of already-known states stay replayable."""
        chaos.fire("checkpoint.materialize", log_size=len(self._log))
        self._materialized = self.inner.snapshot()
        self._log = [("register", d) for d in self._descs.values()]
        self._epoch += 1    # log positions of older epochs are now invalid

    def changelog_size(self) -> int:
        return len(self._log)

    def snapshot(self) -> Dict[str, Any]:
        """(materialized base, changelog suffix) — cheap when the log is
        short; callers trigger ``materialize()`` on their own cadence."""
        return {
            "changelog_backend": True,
            "materialized": self._materialized,
            "changelog": list(self._log),
        }

    def snapshot_increment(self, checkpoint_id: int):
        """A ``changelog`` increment node (runtime/checkpoint/delta.py) with
        the log suffix beyond the last CONFIRMED cut, or None when this cut
        must ship the full snapshot (no confirmed base, or a materialization
        re-based the log since).  Freezes the cut position either way, so
        later cuts keep covering it until ``notify_checkpoint_complete``."""
        if self.materialize_threshold \
                and len(self._log) >= self.materialize_threshold:
            self.materialize()   # background re-base: this cut goes full
        self._unconfirmed.append((checkpoint_id, self._epoch,
                                  len(self._log)))
        if self._confirmed is None or self._confirmed[0] != self._epoch:
            return None
        log_base = self._confirmed[1]
        return {
            "__increment__": 1, "kind": "changelog",
            "checkpoint_id": checkpoint_id,
            "log_base": log_base,
            "log_suffix": list(self._log[log_base:]),
            "extras": {},
        }

    def notify_checkpoint_complete(self, checkpoint_id: int) -> None:
        """Advance the confirmed log position to a cut this backend froze
        (savepoints/finals never call ``snapshot_increment`` and therefore
        never advance the increment chain)."""
        match = next((e for e in self._unconfirmed
                      if e[0] == checkpoint_id), None)
        if match is not None:
            self._unconfirmed = [e for e in self._unconfirmed
                                 if e[0] > checkpoint_id]
            self._confirmed = (match[1], match[2])

    def restore(self, snap: Dict[str, Any]) -> None:
        # restored state severs the linkage to any storage-side increment
        # chain: the first cut after restore is a full base
        self._unconfirmed = []
        self._confirmed = None
        self._epoch += 1
        if not snap.get("changelog_backend"):
            # plain inner snapshot (e.g. pre-changelog checkpoint)
            self.inner.restore(snap)
            return
        if snap.get("materialized") is not None:
            self.inner.restore(snap["materialized"])
        self._materialized = snap.get("materialized")
        self._states = {}
        replayed: Dict[str, Any] = {}
        for entry in snap.get("changelog", []):
            kind = entry[0]
            if kind == "key_slots":
                self.inner.key_slots(entry[1])
            elif kind == "set_current_key":
                self.inner.set_current_key(entry[1])
            elif kind == "register":
                desc = entry[1]
                replayed[desc.name] = self.inner.get_state(desc)
                self._states[desc.name] = _ChangelogStateProxy(
                    self, desc.name, replayed[desc.name])
                self._descs[desc.name] = desc
            elif kind == "mutate":
                _, name, attr, args, kwargs = entry
                getattr(replayed[name], attr)(*args, **kwargs)
        # the restored log IS the current log: a snapshot taken now must
        # still contain these mutations relative to the same base
        self._log = list(snap.get("changelog", []))
