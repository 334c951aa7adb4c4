"""The benchmark's input generators, drawn from the run's seed.

- :func:`window_pool` draws a window-family mix's batches: ``bench.py``'s
  ``make_batches``, draw for draw (uniform int64 keys, f32 values in
  [0, 1), sorted event times advancing 1000 ms a batch).
- :func:`rmat_edges` is Graph500's Kronecker (R-MAT) generator as
  ``chip_smoke.py`` runs it on the card: every edge's ``scale`` bits drawn
  from the initiator (A, B, C, D), vertex labels permuted, self loops and
  duplicates kept, as the generator emits them.
- :func:`relabel` permutes an edge list's vertex labels: one graph, in
  another order.
- :func:`graphalytics_form` turns such an edge list into the graph LDBC
  Graphalytics' ``graph500-*`` datasets hold: undirected, without self
  loops, duplicate edges or vertices that have no edge.

Nothing here imports the program: the reference and the program are handed
what these functions make.
"""

from __future__ import annotations

import numpy as np


def window_pool(traffic: dict, n_keys: int, seed: int):
    """The pool of ``traffic["pool_batches"]`` ``(keys, values,
    timestamps)`` batches a window-family run cycles through, batch ``i``
    at event times ``[i * ms_per_batch, (i + 1) * ms_per_batch)``, its keys
    uniform over ``n_keys`` (``traffic["keys"]["dist"]`` is ``uniform``)."""
    n = int(traffic["batch_size"])
    ms = int(traffic["ms_per_batch"])
    dist = traffic["keys"]["dist"]
    if dist != "uniform":
        raise ValueError(f"unknown key distribution {dist!r}")
    rng = np.random.default_rng(seed)
    out = []
    for i in range(int(traffic["pool_batches"])):
        keys = rng.integers(0, n_keys, n).astype(np.int64)
        vals = rng.random(n).astype(np.float32)
        ts = i * ms + np.sort(rng.integers(0, ms, n)).astype(np.int64)
        out.append((keys, vals, ts))
    return out


def rmat_edges(scale: int, edge_factor: int, abc, seed: int, device):
    """Graph500's Kronecker generator on ``device`` (``chip_smoke.py``'s
    ``rmat_edges`` without its SSSP weights, which it draws last):
    ``edge_factor << scale`` directed edges as int32 ``(src, dst)``
    tensors."""
    import torch
    a, b, c = abc
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    m = edge_factor << scale
    src = torch.zeros(m, dtype=torch.int64, device=device)
    dst = torch.zeros(m, dtype=torch.int64, device=device)
    for bit in range(scale):
        r = torch.rand(m, generator=g, device=device)
        src |= (r >= a + b).to(torch.int64) << bit
        dst |= (((r >= a) & (r < a + b)) | (r >= a + b + c)).to(
            torch.int64) << bit
        del r
    perm = torch.randperm(1 << scale, generator=g, device=device)
    return perm[src].to(torch.int32), perm[dst].to(torch.int32)


def relabel(src, dst, n: int, seed: int):
    """The edges ``(src, dst)`` over vertices ``[0, n)`` with the labels
    permuted by a permutation drawn from ``seed`` on the edges' device."""
    import torch
    g = torch.Generator(device=src.device)
    g.manual_seed(seed)
    perm = torch.randperm(n, generator=g, device=src.device)
    return (perm[src.to(torch.int64)].to(torch.int32),
            perm[dst.to(torch.int64)].to(torch.int32))


def graphalytics_form(src, dst, n: int):
    """The undirected graph of the edge list ``(src, dst)`` over vertices
    ``[0, n)`` as Graphalytics' Graph500 datasets hold it: self loops and
    repeated edges dropped (``u-v`` and ``v-u`` are one edge), vertices
    without an edge dropped and the rest numbered densely in their order.
    Returns ``(vertices, src, dst)``: int32 arcs on the edges' device, both
    directions of each edge, so ``len(src) // 2`` is the edge count."""
    import torch
    keep = src != dst
    lo = torch.minimum(src, dst)[keep].to(torch.int64)
    hi = torch.maximum(src, dst)[keep].to(torch.int64)
    del keep
    edge = torch.unique(lo * n + hi)      # sorted: (lo, hi) in order
    del lo, hi
    lo, hi = edge // n, edge % n
    del edge
    used = torch.zeros(n, dtype=torch.bool, device=src.device)
    used[lo] = True
    used[hi] = True
    number = torch.cumsum(used, 0) - 1
    vertices = int(used.sum())
    del used
    lo = number[lo].to(torch.int32)
    hi = number[hi].to(torch.int32)
    return vertices, torch.cat([lo, hi]), torch.cat([hi, lo])
