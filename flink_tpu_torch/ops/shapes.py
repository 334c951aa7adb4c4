"""Sizing helpers (copy of ``flink_tpu/ops/shapes.py``)."""

from __future__ import annotations


def next_pow2(n: int, floor: int = 1) -> int:
    c = floor
    while c < n:
        c <<= 1
    return c


def quantize_pow2(n: int, floor: int = 64, steps: int = 4) -> int:
    """Round ``n`` up to a multiple of ``next_pow2(n)/steps`` (>= floor):
    at most ``steps`` distinct sizes per power of two, <= 1/steps padding."""
    p = next_pow2(max(n, floor), floor)
    q = max(p // steps, floor)
    return ((n + q - 1) // q) * q
