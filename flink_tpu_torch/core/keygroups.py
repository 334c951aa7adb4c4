"""Key groups: the state-sharding and rescaling unit (numpy copy of what
the mesh needs from ``flink_tpu/core/keygroups.py``).

The reference's key-group assignment (``KeyGroupRangeAssignment.java:50-84``
and the murmur finalizer of ``MathUtils.java:137``): ``key_group =
murmur(key_hash) % max_parallelism``, and contiguous key-group RANGES per
parallel subtask, so state laid out by key group rescales without rehashing
keys.  Everything is vectorized numpy over int32 key hashes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, List

import numpy as np

_C1 = np.uint32(0xCC9E2D51)
_C2 = np.uint32(0x1B873593)
_M5 = np.uint32(5)
_N = np.uint32(0xE6546B64)


def _rotl32(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def murmur_hash(code) -> np.ndarray:
    """Vectorized ``MathUtils.murmurHash(int)``: non-negative int32, with
    the reference's ``Integer.MIN_VALUE -> 0`` edge case."""
    code = np.asarray(code, dtype=np.int64).astype(np.uint32)
    with np.errstate(over="ignore"):
        code = code * _C1
        code = _rotl32(code, 15)
        code = code * _C2
        code = _rotl32(code, 13)
        code = code * _M5 + _N
        code = code ^ np.uint32(4)
        # bitMix (MathUtils.java:194)
        code ^= code >> np.uint32(16)
        code = code * np.uint32(0x85EBCA6B)
        code ^= code >> np.uint32(13)
        code = code * np.uint32(0xC2B2AE35)
        code ^= code >> np.uint32(16)
    signed = code.astype(np.int32)
    out = np.where(signed >= 0, signed,
                   np.where(signed == np.int32(-2147483648), 0, -signed))
    return out.astype(np.int32)


def java_int_hash(values: np.ndarray) -> np.ndarray:
    """``Integer.hashCode`` / ``Long.hashCode`` for numpy int arrays."""
    v = np.asarray(values)
    if v.dtype in (np.int64, np.uint64):
        u = v.astype(np.uint64)
        return (u ^ (u >> np.uint64(32))).astype(np.uint32).astype(np.int32)
    return v.astype(np.int32)


def assign_to_key_group(key_hashes: np.ndarray,
                        max_parallelism: int) -> np.ndarray:
    """``computeKeyGroupForKeyHash``: murmur % maxParallelism."""
    return murmur_hash(key_hashes) % np.int32(max_parallelism)


def java_string_hash(values: np.ndarray) -> np.ndarray:
    """``String.hashCode`` of each element of an object array."""
    out = np.empty(len(values), np.int64)
    for i, s in enumerate(values):
        acc = 0
        for ch in str(s):
            acc = (acc * 31 + ord(ch)) & 0xFFFFFFFF
        out[i] = acc
    return out.astype(np.uint32).astype(np.int32)


def hash_keys(keys: np.ndarray) -> np.ndarray:
    """Key column (int, packed composite or object dtype) -> int32 hashes
    (``Object.hashCode``)."""
    keys = np.asarray(keys)
    if keys.dtype.kind in "iu":
        return java_int_hash(keys)
    if keys.dtype.kind == "V" and keys.dtype.itemsize % 8 == 0:
        # packed composite keys: polynomial mix over the 8-byte words
        words = keys.view(np.int64).reshape(len(keys), -1)
        h = np.zeros(len(keys), np.int64)
        with np.errstate(over="ignore"):
            for j in range(words.shape[1]):
                h = h * np.int64(31) + words[:, j]
        return java_int_hash(h)
    return java_string_hash(keys)


@dataclass(frozen=True)
class KeyGroupRange:
    """Inclusive [start, end] range of key groups (``KeyGroupRange.java``);
    an empty range is (0, -1)."""

    start: int
    end: int

    def __post_init__(self):
        if self.end < self.start:
            object.__setattr__(self, "start", 0)
            object.__setattr__(self, "end", -1)

    @property
    def num_key_groups(self) -> int:
        return self.end - self.start + 1

    def contains(self, key_group: int) -> bool:
        return self.start <= key_group <= self.end

    def __iter__(self) -> Iterator[int]:
        return iter(range(self.start, self.end + 1))

    def intersection(self, other: "KeyGroupRange") -> "KeyGroupRange":
        return KeyGroupRange(max(self.start, other.start),
                             min(self.end, other.end))


def compute_key_group_range(max_parallelism: int, parallelism: int,
                            operator_index: int) -> KeyGroupRange:
    """``computeKeyGroupRangeForOperatorIndex``."""
    if parallelism > max_parallelism:
        raise ValueError(f"parallelism {parallelism} > max_parallelism "
                         f"{max_parallelism}")
    start = (operator_index * max_parallelism + parallelism - 1) // parallelism
    end = ((operator_index + 1) * max_parallelism - 1) // parallelism
    return KeyGroupRange(start, end)


def compute_operator_index_for_key_group(max_parallelism: int,
                                         parallelism: int,
                                         key_group: int) -> int:
    """``computeOperatorIndexForKeyGroup``."""
    return key_group * parallelism // max_parallelism


def assign_key_to_parallel_operator(key_hashes: np.ndarray,
                                    max_parallelism: int,
                                    parallelism: int) -> np.ndarray:
    """Vectorized ``assignKeyToParallelOperator``: subtask index per key."""
    kg = assign_to_key_group(key_hashes, max_parallelism)
    return (kg.astype(np.int64) * parallelism
            // max_parallelism).astype(np.int32)


def key_group_ranges(max_parallelism: int,
                     parallelism: int) -> List[KeyGroupRange]:
    return [compute_key_group_range(max_parallelism, parallelism, i)
            for i in range(parallelism)]


def route_raw_keys(keys: np.ndarray, parallelism: int,
                   max_parallelism: int = 128) -> np.ndarray:
    """RAW key column -> owning shard per key (key hash -> murmur key group
    -> contiguous range)."""
    if parallelism <= 1:
        return np.zeros(len(keys), np.int32)
    return assign_key_to_parallel_operator(hash_keys(np.asarray(keys)),
                                           max_parallelism, parallelism)
