"""Keyed state API: descriptors, state handles, TTL config (a copy of
``flink_tpu/state/api.py``, which imports no JAX; the port keeps its own).

Analog of ``flink-core/src/main/java/org/apache/flink/api/common/state/``
(``StateDescriptor``, ``ValueState``/``ListState``/``MapState``/
``ReducingState``/``AggregatingState``, ``StateTtlConfig``), re-designed for a
batched runtime: every state kind exposes BOTH the reference's per-key
scalar accessors (valid under a ``set_current_key``) and **vectorized
row-batch accessors** (``get_rows``/``put_rows``/``add_rows`` over dense slot
ids) — the batched path is what operators use in the hot loop, the scalar
path is the compatibility surface for host-side user code (ProcessFunction,
CEP, tests).
"""

from __future__ import annotations

import abc
from dataclasses import dataclass
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# TTL (StateTtlConfig analog)
# ---------------------------------------------------------------------------

class UpdateType:
    """When the TTL timestamp refreshes (StateTtlConfig.UpdateType)."""

    Disabled = "disabled"
    OnCreateAndWrite = "on_create_and_write"
    OnReadAndWrite = "on_read_and_write"


class StateVisibility:
    """Whether expired-but-not-cleaned values are returned."""

    NeverReturnExpired = "never_return_expired"
    ReturnExpiredIfNotCleanedUp = "return_expired_if_not_cleaned_up"


@dataclass(frozen=True)
class StateTtlConfig:
    """``StateTtlConfig`` analog: time-to-live for keyed state entries.

    The heap backend stores one int64 last-access timestamp per (state, slot)
    and filters expired rows vectorized on read; full-snapshot cleanup drops
    expired rows at checkpoint time (the reference's ``CleanupStrategies`` /
    full-snapshot filter, ``runtime/state/ttl/``).
    """

    ttl_ms: int
    update_type: str = UpdateType.OnCreateAndWrite
    visibility: str = StateVisibility.NeverReturnExpired
    cleanup_in_snapshot: bool = True

    def __post_init__(self):
        if self.ttl_ms <= 0:
            raise ValueError("ttl_ms must be > 0")

    @staticmethod
    def new_builder(ttl_ms: int) -> "StateTtlConfigBuilder":
        return StateTtlConfigBuilder(ttl_ms)


class StateTtlConfigBuilder:
    def __init__(self, ttl_ms: int):
        self._ttl_ms = ttl_ms
        self._update = UpdateType.OnCreateAndWrite
        self._visibility = StateVisibility.NeverReturnExpired
        self._cleanup = True

    def set_update_type(self, t: str) -> "StateTtlConfigBuilder":
        self._update = t
        return self

    def set_state_visibility(self, v: str) -> "StateTtlConfigBuilder":
        self._visibility = v
        return self

    def cleanup_full_snapshot(self, enabled: bool = True) -> "StateTtlConfigBuilder":
        self._cleanup = enabled
        return self

    def build(self) -> StateTtlConfig:
        return StateTtlConfig(self._ttl_ms, self._update, self._visibility,
                              self._cleanup)


# ---------------------------------------------------------------------------
# Descriptors (StateDescriptor analog)
# ---------------------------------------------------------------------------

class StateDescriptor:
    """Named, typed description of a piece of keyed state
    (``StateDescriptor.java`` analog). ``dtype=None`` ⇒ arbitrary Python
    objects (the Kryo-fallback analog); a numpy dtype ⇒ dense array storage
    (the fast path, device-promotable)."""

    kind: str = "value"

    def __init__(self, name: str, dtype=None, shape: Tuple[int, ...] = (),
                 default: Any = None, ttl: Optional[StateTtlConfig] = None):
        self.name = name
        self.dtype = np.dtype(dtype) if dtype is not None else None
        self.shape = tuple(shape)
        self.default = default
        self.ttl = ttl

    def enable_time_to_live(self, ttl: StateTtlConfig) -> "StateDescriptor":
        self.ttl = ttl
        return self

    def __repr__(self):
        return (f"{type(self).__name__}({self.name!r}, dtype={self.dtype}, "
                f"shape={self.shape})")


class ValueStateDescriptor(StateDescriptor):
    kind = "value"


class ListStateDescriptor(StateDescriptor):
    kind = "list"


class MapStateDescriptor(StateDescriptor):
    kind = "map"


class ReducingStateDescriptor(StateDescriptor):
    """ACC layout (dtype/shape) comes from ``reduce_fn.identity()`` — there
    are no separate dtype/shape knobs here."""

    kind = "reducing"

    def __init__(self, name: str, reduce_fn,
                 ttl: Optional[StateTtlConfig] = None):
        super().__init__(name, dtype=None, shape=(), ttl=ttl)
        self.reduce_fn = reduce_fn


class AggregatingStateDescriptor(StateDescriptor):
    kind = "aggregating"

    def __init__(self, name: str, agg, ttl: Optional[StateTtlConfig] = None):
        super().__init__(name, dtype=None, shape=(), ttl=ttl)
        self.agg = agg


# ---------------------------------------------------------------------------
# State handles (State interface analogs)
# ---------------------------------------------------------------------------

class State(abc.ABC):
    """Base handle; ``clear()`` clears the *current key*'s entry."""

    @abc.abstractmethod
    def clear(self) -> None:
        ...


class ValueState(State):
    @abc.abstractmethod
    def value(self) -> Any:
        ...

    @abc.abstractmethod
    def update(self, value: Any) -> None:
        ...

    # vectorized accessors (dense slot ids — the hot path)
    def get_rows(self, slots: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def put_rows(self, slots: np.ndarray, values: np.ndarray) -> None:
        raise NotImplementedError


class ListState(State):
    @abc.abstractmethod
    def get(self) -> List[Any]:
        ...

    @abc.abstractmethod
    def add(self, value: Any) -> None:
        ...

    def update(self, values: Iterable[Any]) -> None:
        self.clear()
        for v in values:
            self.add(v)

    def add_all(self, values: Iterable[Any]) -> None:
        for v in values:
            self.add(v)


class MapState(State):
    @abc.abstractmethod
    def get(self, key: Any) -> Any:
        ...

    @abc.abstractmethod
    def put(self, key: Any, value: Any) -> None:
        ...

    @abc.abstractmethod
    def remove(self, key: Any) -> None:
        ...

    @abc.abstractmethod
    def contains(self, key: Any) -> bool:
        ...

    @abc.abstractmethod
    def items(self) -> Iterable[Tuple[Any, Any]]:
        ...

    def keys(self):
        return (k for k, _ in self.items())

    def values(self):
        return (v for _, v in self.items())

    def is_empty(self) -> bool:
        return next(iter(self.items()), None) is None

    def put_all(self, mapping: Dict[Any, Any]) -> None:
        for k, v in mapping.items():
            self.put(k, v)


class AppendingState(State):
    """ReducingState/AggregatingState common surface (``AppendingState``)."""

    @abc.abstractmethod
    def get(self) -> Any:
        ...

    @abc.abstractmethod
    def add(self, value: Any) -> None:
        ...

    def add_rows(self, slots: np.ndarray, values) -> None:
        """Vectorized fold: merge values[i] into slot slots[i] (duplicates
        combine). This is the batched ``AggregatingState.add`` — the
        north-star per-record call, done once per micro-batch."""
        raise NotImplementedError


class ReducingState(AppendingState):
    pass


class AggregatingState(AppendingState):
    pass
