"""Arithmetic of the benchmark's numbers: percentiles, spreads and
interval sets."""

from __future__ import annotations

import math
import statistics
from typing import Sequence

import numpy as np


def percentile(values: Sequence[float], q: float) -> float:
    """The nearest-rank ``q``-th percentile: the smallest sample with at
    least ``q`` percent of all samples at or below it, so every sample
    counts and the result is one that was observed."""
    if not len(values):
        raise ValueError("percentile of no samples")
    ordered = sorted(values)
    rank = max(1, math.ceil(q / 100.0 * len(ordered)))
    return float(ordered[rank - 1])


def spread(values: Sequence[float]) -> float:
    """The distance between the first and third quartiles as
    ``statistics.quantiles(values, n=4)`` gives them, over the median."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2


def union(starts: np.ndarray, ends: np.ndarray):
    """The union of intervals ``[starts[i], ends[i])`` as sorted disjoint
    ``(starts, ends)`` arrays."""
    starts = np.asarray(starts, np.float64)
    ends = np.asarray(ends, np.float64)
    if not starts.size:
        return starts, ends
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], ends[order]
    reach = np.maximum.accumulate(e)
    # an interval opens a new run where it starts after all before it end
    new = np.ones(s.size, bool)
    new[1:] = s[1:] > reach[:-1]
    run = np.cumsum(new) - 1
    out_s = s[new]
    out_e = np.zeros(out_s.size)
    np.maximum.at(out_e, run, e)
    return out_s, out_e


def clip(starts: np.ndarray, ends: np.ndarray, lo: float, hi: float):
    """Disjoint intervals cut to ``[lo, hi)``; empty ones dropped."""
    s = np.clip(starts, lo, hi)
    e = np.clip(ends, lo, hi)
    keep = e > s
    return s[keep], e[keep]


def gaps(starts: np.ndarray, ends: np.ndarray, lo: float, hi: float):
    """The complement of sorted disjoint intervals within ``[lo, hi)``."""
    s, e = clip(starts, ends, lo, hi)
    g_s = np.concatenate([[lo], e])
    g_e = np.concatenate([s, [hi]])
    keep = g_e > g_s
    return g_s[keep], g_e[keep]


def first_level(starts: np.ndarray, ends: np.ndarray, labels: list):
    """Of possibly nested intervals, those that no earlier-starting one
    still covers (the outermost), as sorted disjoint ``(starts, ends,
    labels)``."""
    order = np.argsort(np.asarray(starts, np.float64), kind="stable")
    out_s, out_e, out_l = [], [], []
    reach = -math.inf
    for i in order.tolist():
        if starts[i] >= reach:
            out_s.append(starts[i])
            out_e.append(ends[i])
            out_l.append(labels[i])
            reach = ends[i]
    return (np.asarray(out_s, np.float64), np.asarray(out_e, np.float64),
            out_l)


def attribute(gap_s: np.ndarray, gap_e: np.ndarray, layers) -> dict:
    """Seconds of the disjoint ``gaps`` by what covered them: ``layers`` is
    a list, coarse first, of sorted disjoint ``(starts, ends, labels)``;
    each moment of a gap is named by the labels of the layers covering it,
    joined by ``/`` (``-`` where none covers it).  Times in the
    intervals' unit; the sums come back in that unit."""
    cuts = [gap_s, gap_e]
    for s, e, _ in layers:
        cuts += [s, e]
    edges = np.unique(np.concatenate(cuts)) if cuts else np.zeros(0)
    if edges.size < 2:
        return {}
    mid = (edges[:-1] + edges[1:]) / 2
    width = np.diff(edges)

    def covering(s, e, t):
        if not len(s):
            return np.full(t.size, -1)
        i = np.searchsorted(s, t, side="right") - 1
        ok = (i >= 0) & (e[np.maximum(i, 0)] > t)
        return np.where(ok, i, -1)

    in_gap = covering(gap_s, gap_e, mid) >= 0
    mid, width = mid[in_gap], width[in_gap]
    parts = []
    for s, e, labels in layers:
        idx = covering(s, e, mid)
        parts.append(np.array(list(labels) + [""], dtype=object)[idx])
    out: dict = {}
    for names, w in zip(zip(*parts) if parts else [()] * mid.size,
                        width.tolist()):
        name = "/".join(n for n in names if n) or "-"
        out[name] = out.get(name, 0.0) + w
    return out
