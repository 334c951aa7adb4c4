"""User function contracts, batch-vectorized (port of ``flink_tpu/core/functions.py``).

An aggregate is a commutative monoid over accumulators:

    lift(values)        [B, ...] record values -> [B, ...] accumulator leaves
    combine(a, b)       associative + commutative elementwise merge
    identity()          the neutral accumulator
    get_result(acc)     accumulator -> output value

Where the JAX package uses pytrees, the port uses plain Python structures:
an accumulator is one leaf (a tensor or numpy array) or dicts, tuples and
lists of leaves, flattened as ``jax.tree_util`` flattens them (dict keys
sorted), so leaf ``j`` here is leaf ``j`` there and snapshots line up.  The port carries
the add/min/max aggregates (sum, min, max, count, average, and a tuple of
them) and :class:`LambdaReduce`, a reduce by any function, which has no
scatter kinds and folds through ``ops/scatter.py`` ``scatter_generic``.
JAX's x64 switch does not exist here, so the count is int32, the width JAX
stores it in with x64 off, and where JAX would canonicalize a 64-bit value
or identity to 32 bits, :func:`canonical_tensor` does the same.
"""

from __future__ import annotations

import abc
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

#: numpy ufunc per scatter kind — the host mirror's twins of ops/scatter.py
SCATTER_UFUNCS = {"add": np.add, "min": np.minimum, "max": np.maximum}


def tree_leaves(tree) -> list:
    """Leaves of an accumulator/value structure, flattened as
    ``jax.tree_util.tree_leaves`` flattens it: dict keys sorted, tuples and
    lists in order, nested to any depth, ``None`` with no leaf."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [l for k in sorted(tree) for l in tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [l for t in tree for l in tree_leaves(t)]
    return [tree]


def tree_structure(tree):
    """None for a single leaf, else a hashable description of the nesting
    (dict keys sorted) that :func:`tree_unflatten` rebuilds."""
    if tree is None:
        return ("none",)
    if isinstance(tree, dict):
        return ("dict", tuple((k, tree_structure(tree[k]))
                              for k in sorted(tree)))
    if isinstance(tree, (tuple, list)):
        return (type(tree).__name__,
                tuple(tree_structure(t) for t in tree))
    return None


def tree_unflatten(structure, leaves):
    it = iter(list(leaves))

    def build(st):
        if st is None:
            return next(it)
        kind, parts = st[0], st[1] if len(st) > 1 else ()
        if kind == "none":
            return None
        if kind == "dict":
            return {k: build(sub) for k, sub in parts}
        items = [build(sub) for sub in parts]
        return tuple(items) if kind == "tuple" else items

    out = build(structure)
    if next(it, None) is not None:
        raise ValueError("more leaves than the structure holds")
    return out


def tree_leaf_names(structure) -> Tuple[str, ...]:
    """Each leaf's path, spelled as ``jax.tree_util.keystr`` spells it
    ("" for a single leaf, "['sum']" for a dict field, "[0]" for a tuple's
    first item)."""
    if structure is None:
        return ("",)
    kind = structure[0]
    if kind == "none":
        return ()
    if kind == "dict":
        return tuple(f"[{k!r}]" + n for k, sub in structure[1]
                     for n in tree_leaf_names(sub))
    return tuple(f"[{i}]" + n for i, sub in enumerate(structure[1])
                 for n in tree_leaf_names(sub))


def tree_map(fn: Callable, tree):
    """``fn`` over every leaf of a structure."""
    return tree_unflatten(tree_structure(tree),
                          [fn(l) for l in tree_leaves(tree)])


def to_tensors(tree):
    """numpy leaves (arrays or scalars) -> CPU tensors of the same dtype, so
    an aggregate's tensor functions see JAX's operand dtypes.  Leaves
    torch cannot hold (strings, objects) stay numpy."""
    def conv(a):
        a = np.asarray(a)
        if a.dtype.kind not in "biuf":
            return a
        return torch.from_numpy(np.array(a))   # a copy: never aliases
    return tree_map(conv, tree)


def to_numpy(tree):
    """Tensor leaves -> numpy arrays (a 0-d tensor -> a 0-d array)."""
    return tree_map(lambda t: t.cpu().numpy() if isinstance(t, torch.Tensor)
                    else np.asarray(t), tree)


def combine_rows(agg: "AggregateFunction", a, b) -> Tuple[np.ndarray, ...]:
    """``agg.combine_leaves`` of two leaf tuples of numpy scalars or arrays,
    as numpy arrays of the dtypes the combine produced (JAX's host merge
    calls its combine on numpy scalars and keeps what comes out)."""
    out = agg.combine_leaves(tuple(to_tensors(x) for x in a),
                             tuple(to_tensors(x) for x in b))
    return tuple(to_numpy(x) for x in out)


def host_result(agg: "AggregateFunction", spec, leaves):
    """``agg.get_result`` over numpy accumulator leaves, as numpy."""
    return to_numpy(agg.get_result(spec.unflatten(
        [to_tensors(l) for l in leaves])))


def torch_dtype(dtype) -> torch.dtype:
    """torch twin of a numpy (or torch) dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.zeros((), np.dtype(dtype))).dtype


#: 64-bit dtypes and the 32-bit ones JAX stores them as with x64 off
_X64_OFF = {torch.float64: torch.float32, torch.int64: torch.int32,
            torch.complex128: torch.complex64}


def canonical_tensor(value) -> torch.Tensor:
    """``value`` (a Python scalar, numpy array or tensor) as the tensor JAX
    would make of it with x64 off: 64-bit floats and ints narrow to 32
    bits, a Python float is float32 and a Python int int32."""
    if isinstance(value, bool):
        return torch.tensor(value)
    if isinstance(value, int):
        return torch.tensor(value, dtype=torch.int32)
    if isinstance(value, float):
        return torch.tensor(value, dtype=torch.float32)
    t = value if isinstance(value, torch.Tensor) else torch.as_tensor(
        np.asarray(value))
    narrow = _X64_OFF.get(t.dtype)
    return t if narrow is None else t.to(narrow)


class Function:
    """Marker base for all user functions (``Function.java``)."""


class RuntimeContext:
    """Runtime info handed to rich functions (``RuntimeContext.java``
    analog): the task, its metric group (``metrics/groups.py``), its slot's
    managed-memory accountant (``runtime/memory.py``, None outside a managed
    slot) and the user's accumulators."""

    def __init__(self, task_name: str = "task", subtask_index: int = 0,
                 parallelism: int = 1, max_parallelism: int = 128,
                 metrics=None,
                 external_resources: Optional[Dict[str, Any]] = None,
                 memory_manager=None):
        self.task_name = task_name
        self.subtask_index = subtask_index
        self.parallelism = parallelism
        self.max_parallelism = max_parallelism
        self.metrics = metrics
        self._external_resources = external_resources or {}
        self.memory_manager = memory_manager

    def get_external_resource_infos(self, name: str):
        """``RuntimeContext.getExternalResourceInfos`` analog."""
        return self._external_resources.get(name, [])

    # -- accumulators (user counters, ``Accumulator``/``IntCounter`` analog)
    def add_accumulator(self, name: str, start: float = 0.0) -> "Accumulator":
        accs = getattr(self, "_accumulators", None)
        if accs is None:
            accs = self._accumulators = {}
        if name not in accs:
            accs[name] = Accumulator(name, start)
        return accs[name]

    def get_accumulator(self, name: str) -> "Accumulator":
        return self.add_accumulator(name)

    def accumulator_results(self) -> Dict[str, float]:
        return {n: a.value for n, a in
                getattr(self, "_accumulators", {}).items()}


class Accumulator:
    """Distributed user counter (``IntCounter``/``DoubleCounter`` analog):
    per-subtask adds merge at job completion (``JobExecutionResult``)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str, start: float = 0.0):
        self.name = name
        self.value = start

    def add(self, v: float = 1.0) -> None:
        self.value += v


class RichFunction(Function):
    """open/close lifecycle."""

    def open(self, ctx: RuntimeContext) -> None:
        pass

    def close(self) -> None:
        pass


@dataclass(frozen=True)
class AccSpec:
    """Static description of an accumulator (shapes, numpy dtypes, identity)."""

    structure: Any   # tree_structure of the identity (None: one leaf)
    leaf_shapes: Tuple[Tuple[int, ...], ...]
    leaf_dtypes: Tuple[np.dtype, ...]
    leaf_inits: Tuple[np.ndarray, ...]
    #: per-leaf name, spelled like ``jax.tree_util.keystr`` ("" for a single
    #: leaf, "['sum']" for a dict field) — the snapshot schema identity
    leaf_names: Tuple[str, ...] = ()

    @property
    def num_leaves(self) -> int:
        return len(self.leaf_shapes)

    def unflatten(self, leaves):
        return tree_unflatten(self.structure, leaves)


class AggregateFunction(RichFunction, abc.ABC):
    """Batch-vectorized aggregate (reference contract: AggregateFunction.java:114).

    ``lift``/``get_result`` take and return torch tensors (the device fold);
    ``host_lift``/``host_get_result`` are their numpy twins, which the host
    value mirror evaluates in f64/i64."""

    @abc.abstractmethod
    def identity(self):
        """Neutral accumulator: a leaf or dict of 0-d tensors."""

    @abc.abstractmethod
    def lift(self, values):
        """Record value tensors [B, ...] -> accumulator leaves [B, ...]."""

    @abc.abstractmethod
    def combine(self, a, b):
        """Associative, commutative merge of two accumulators."""

    def get_result(self, acc):
        return acc

    def combine_leaves(self, a_leaves, b_leaves):
        """Leaf-tuple view of ``combine`` (the fire-time pane combine)."""
        spec = self.acc_spec()
        return tuple(tree_leaves(self.combine(spec.unflatten(a_leaves),
                                              spec.unflatten(b_leaves))))

    def host_lift(self, values):
        """numpy ``lift``; NotImplemented keeps an aggregate device-only."""
        return NotImplemented

    def host_get_result(self, acc):
        """numpy ``get_result``."""
        return NotImplemented

    def supports_host_emit(self) -> bool:
        """Kinds are declared and both numpy twins are overridden."""
        return (self.scatter_kind_leaves() is not None
                and type(self).host_lift is not AggregateFunction.host_lift
                and type(self).host_get_result
                is not AggregateFunction.host_get_result)

    def supports_retraction(self) -> bool:
        """Every leaf combines by addition (sum/count/avg): the aggregate is
        invertible, so a fired window's contents can be purged logically by
        subtracting a per-(key, window) value baseline — what a purging
        count trigger over sliding windows, whose panes overlapping windows
        share, needs."""
        kinds = self.scatter_kind_leaves()
        return kinds is not None and all(k == "add" for k in kinds)

    def scatter_kinds(self):
        """``"add"``/``"min"``/``"max"`` per leaf (same structure as
        ``identity()``) when ``combine`` is that elementwise op; None for
        arbitrary combines."""
        return None

    def scatter_kind_leaves(self) -> Optional[Tuple[str, ...]]:
        kinds = self.scatter_kinds()
        if kinds is None:
            return None
        if tree_structure(kinds) != self.acc_spec().structure:
            raise ValueError("scatter_kinds structure does not match identity()")
        return tuple(tree_leaves(kinds))

    def acc_spec(self) -> AccSpec:
        cached = getattr(self, "_acc_spec_cache", None)
        if cached is None:
            ident = self.identity()
            structure = tree_structure(ident)
            leaves = [torch.as_tensor(l).cpu().numpy()
                      for l in tree_leaves(ident)]
            names = tree_leaf_names(structure)
            cached = AccSpec(structure=structure,
                             leaf_shapes=tuple(l.shape for l in leaves),
                             leaf_dtypes=tuple(l.dtype for l in leaves),
                             leaf_inits=tuple(leaves),
                             leaf_names=names)
            self._acc_spec_cache = cached
        return cached


class ReduceFunction(AggregateFunction):
    """Associative reduce over values: ACC == value type."""

    def lift(self, values):
        return values

    def combine(self, a, b):
        return self.reduce(a, b)

    def host_lift(self, values):
        return values

    def host_get_result(self, acc):
        return acc

    @abc.abstractmethod
    def reduce(self, a, b):
        ...


class LambdaReduce(ReduceFunction):
    """``reduce(fn)``: any associative, commutative ``fn(a, b)`` on
    tensors, with the identity ``identity_value``.  It declares no scatter
    kinds, so it folds through the generic scan and fires on the device
    tier.  The identity is canonicalized as JAX does with x64 off (a
    Python ``0.0`` is float32, ``0`` int32)."""

    def __init__(self, fn: Callable, identity_value):
        self._fn = fn
        self._identity = identity_value

    def identity(self):
        return canonical_tensor(self._identity)

    def reduce(self, a, b):
        return self._fn(a, b)


class SumAggregator(ReduceFunction):
    """``.sum()`` (SumAggregator.java analog): elementwise sum, identity 0."""

    def __init__(self, dtype=torch.float32):
        self._dtype = torch_dtype(dtype)

    def identity(self):
        return torch.zeros((), dtype=self._dtype)

    def reduce(self, a, b):
        return a + b

    def scatter_kinds(self):
        return "add"



def _extreme(dtype: torch.dtype, kind: str):
    """The identity of min (``kind="min"``) or max: +-inf, or the integer
    type's bound."""
    if dtype.is_floating_point:
        return float("inf") if kind == "min" else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if kind == "min" else info.min


class MinAggregator(ReduceFunction):
    def __init__(self, dtype=torch.float32):
        self._dtype = torch_dtype(dtype)

    def identity(self):
        return torch.tensor(_extreme(self._dtype, "min"), dtype=self._dtype)

    def reduce(self, a, b):
        return torch.minimum(a, b)

    def scatter_kinds(self):
        return "min"


class MaxAggregator(ReduceFunction):
    def __init__(self, dtype=torch.float32):
        self._dtype = torch_dtype(dtype)

    def identity(self):
        return torch.tensor(_extreme(self._dtype, "max"), dtype=self._dtype)

    def reduce(self, a, b):
        return torch.maximum(a, b)

    def scatter_kinds(self):
        return "max"


class CountAggregator(AggregateFunction):
    """Records per key and window: an int32 count on the card, int64 in the
    host mirror."""

    def identity(self):
        return torch.zeros((), dtype=torch.int32)

    def lift(self, values):
        leaf = tree_leaves(values)[0]
        return torch.ones(leaf.shape[:1], dtype=torch.int32,
                          device=leaf.device)

    def combine(self, a, b):
        return a + b

    def host_lift(self, values):
        leaf = tree_leaves(values)[0]
        return np.ones(np.shape(leaf)[:1], np.int64)

    def host_get_result(self, acc):
        return acc

    def scatter_kinds(self):
        return "add"


class AvgAggregator(AggregateFunction):
    """Average: ACC = (sum, count)."""

    def __init__(self, dtype=torch.float32):
        self._dtype = torch_dtype(dtype)

    def identity(self):
        return {"sum": torch.zeros((), dtype=self._dtype),
                "count": torch.zeros((), dtype=torch.int32)}

    def lift(self, values):
        v = values.to(self._dtype)
        return {"sum": v, "count": torch.ones(v.shape[:1], dtype=torch.int32,
                                              device=v.device)}

    def combine(self, a, b):
        return {"sum": a["sum"] + b["sum"], "count": a["count"] + b["count"]}

    def get_result(self, acc):
        return acc["sum"] / torch.clamp(acc["count"], min=1).to(self._dtype)

    def host_lift(self, values):
        v = np.asarray(values, np.float64)
        return {"sum": v, "count": np.ones(v.shape[:1], np.int64)}

    def host_get_result(self, acc):
        cnt = np.maximum(np.asarray(acc["count"]), 1)
        return np.asarray(acc["sum"]) / cnt

    def scatter_kinds(self):
        return {"sum": "add", "count": "add"}


class TupleAggregator(AggregateFunction):
    """Several aggregates over named value columns in one ACC dict:
    ``aggs`` maps an output name to (value column, aggregate)."""

    def __init__(self, aggs: Dict[str, Tuple[str, AggregateFunction]]):
        self._aggs = aggs

    def identity(self):
        return {name: agg.identity() for name, (_, agg) in self._aggs.items()}

    def lift(self, values):
        return {name: agg.lift(values[col])
                for name, (col, agg) in self._aggs.items()}

    def combine(self, a, b):
        return {name: agg.combine(a[name], b[name])
                for name, (_, agg) in self._aggs.items()}

    def get_result(self, acc):
        return {name: agg.get_result(acc[name])
                for name, (_, agg) in self._aggs.items()}

    def host_lift(self, values):
        return {name: agg.host_lift(values[col])
                for name, (col, agg) in self._aggs.items()}

    def host_get_result(self, acc):
        return {name: agg.host_get_result(acc[name])
                for name, (_, agg) in self._aggs.items()}

    def supports_host_emit(self) -> bool:
        return (self.scatter_kind_leaves() is not None
                and all(agg.supports_host_emit()
                        for _, agg in self._aggs.values()))

    def scatter_kinds(self):
        kinds = {}
        for name, (_, agg) in self._aggs.items():
            k = agg.scatter_kinds()
            if k is None:
                return None
            kinds[name] = k
        return kinds


# ---------------------------------------------------------------------------
# Elementwise / host functions
# ---------------------------------------------------------------------------

class MapFunction(Function):
    """Vectorized map over batch columns (``MapFunction.java``): ``map``
    takes the batch's column dict and returns a new column dict."""

    def map(self, columns: Dict[str, Any]) -> Dict[str, Any]:
        raise NotImplementedError


class FilterFunction(Function):
    """Vectorized predicate: returns a boolean mask ``[B]``."""

    def filter(self, columns: Dict[str, Any]):
        raise NotImplementedError


class FlatMapFunction(Function):
    """Host-side flatMap: columns -> (columns, source row per output row)."""

    def flat_map(self, columns: Dict[str, Any]):
        raise NotImplementedError
