"""User function contracts, batch-vectorized (port of ``flink_tpu/core/functions.py``).

An aggregate is a commutative monoid over accumulators:

    lift(values)        [B, ...] record values -> [B, ...] accumulator leaves
    combine(a, b)       associative + commutative elementwise merge
    identity()          the neutral accumulator
    get_result(acc)     accumulator -> output value

Where the JAX package uses pytrees, the port uses plain Python structures:
an accumulator is either one leaf (a tensor or numpy array) or a dict of
leaves, flattened in sorted-key order (the order ``jax.tree_util`` uses), so
leaf ``j`` here is leaf ``j`` there and snapshots line up.  The port carries
the add/min/max aggregates (sum, min, max, count, average, and a tuple of
them); JAX's x64 switch does not exist here, so the count is int32, the
width JAX stores it in with x64 off.
"""

from __future__ import annotations

import abc
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

#: numpy ufunc per scatter kind — the host mirror's twins of ops/scatter.py
SCATTER_UFUNCS = {"add": np.add, "min": np.minimum, "max": np.maximum}


def tree_leaves(tree) -> list:
    """Leaves of a leaf-or-dict accumulator/value structure, dict keys sorted."""
    if isinstance(tree, dict):
        return [tree[k] for k in sorted(tree)]
    return [tree]


def tree_structure(tree) -> Optional[Tuple[str, ...]]:
    """None for a single leaf, else the sorted dict keys."""
    return tuple(sorted(tree)) if isinstance(tree, dict) else None


def tree_unflatten(structure: Optional[Tuple[str, ...]], leaves):
    leaves = list(leaves)
    if structure is None:
        (leaf,) = leaves
        return leaf
    return dict(zip(structure, leaves))


def torch_dtype(dtype) -> torch.dtype:
    """torch twin of a numpy (or torch) dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.zeros((), np.dtype(dtype))).dtype


class RuntimeContext:
    """Runtime info handed to rich functions (``RuntimeContext.java`` analog)."""

    def __init__(self, task_name: str = "task", subtask_index: int = 0,
                 parallelism: int = 1, max_parallelism: int = 128,
                 metrics=None):
        self.task_name = task_name
        self.subtask_index = subtask_index
        self.parallelism = parallelism
        self.max_parallelism = max_parallelism
        self.metrics = metrics


class RichFunction:
    """open/close lifecycle."""

    def open(self, ctx: RuntimeContext) -> None:
        pass

    def close(self) -> None:
        pass


@dataclass(frozen=True)
class AccSpec:
    """Static description of an accumulator (shapes, numpy dtypes, identity)."""

    structure: Optional[Tuple[str, ...]]
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
            names = (("",) if structure is None
                     else tuple(f"['{k}']" for k in structure))
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
