"""Plain reference of PageRank (Flink Gelly's ``PageRank``: power
iteration from 1/n, damping ``d``, the rank of vertices without out-edges
spread evenly over all vertices):

    r' = (1 - d) / n + d * (sum over arcs u->v of r[u] / outdeg[u]
                            + sum over dangling u of r[u] / n)

It takes the arcs the benchmark made (an undirected graph's edges in both
directions, as Graphalytics' PageRank reads them), works the out-degrees
out itself, and runs in plain PyTorch on the edges' device in the dtype it is
given (f64 for the check, a lower one for the control).
"""

from __future__ import annotations

import torch


def answer(src: torch.Tensor, dst: torch.Tensor, n: int, traffic: dict,
           dtype: torch.dtype) -> torch.Tensor:
    kw = traffic["kwargs"]
    d = float(kw["damping"])
    src = src.to(torch.int64)
    dst = dst.to(torch.int64)
    deg = torch.bincount(src, minlength=n).to(dtype)
    dangling = deg == 0
    safe = torch.where(dangling, torch.ones_like(deg), deg)
    r = torch.full((n,), 1.0 / n, dtype=dtype, device=src.device)
    for _ in range(int(kw["num_iterations"])):
        spread = torch.zeros(n, dtype=dtype, device=src.device).index_add_(
            0, dst, (r / safe)[src])
        lost = r[dangling].sum()
        r = (1 - d) / n + d * (spread + lost / n)
    return r
