"""Sizing helpers (copy of ``flink_tpu/ops/shapes.py`` ``next_pow2``)."""

from __future__ import annotations


def next_pow2(n: int, floor: int = 1) -> int:
    c = floor
    while c < n:
        c <<= 1
    return c
