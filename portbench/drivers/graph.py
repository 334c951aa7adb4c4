"""The graph family: whole jobs of the port's graph library, back to back,
on a graph made at set-up.

Set-up draws the configuration's Graph500 Kronecker edge list on the card
from its ``graph_seed`` (a dataset is one graph), relabels its vertices by
a permutation drawn from the run's seed (the same graph in another order,
so every seed does the same work), puts it in Graphalytics' form (undirected; no self loops,
repeated edges or vertices without an edge: each edge two arcs), builds a
``flink_tpu_torch`` ``Graph`` on the arcs and runs the mix's warm-up jobs.  The timed loop calls the mix's ``method`` on the
graph with its ``kwargs`` until the window's seconds are up; each call is
a whole job, its answer downloaded to the host.  The sink keeps the
answers of ``sample_jobs`` jobs chosen from the seed (a reservoir over
however many jobs the window runs): each is a vertex vector of 16 MB.
"""

from __future__ import annotations

import time

import numpy as np

from portbench.lib import gen


class Driver:
    def __init__(self, cell, seed: int, device):
        self.cell = cell
        self.config = cell.config
        self.traffic = cell.traffic
        self.seed = int(seed)
        self.device = device
        self.graph = None

    def edges(self):
        """``(vertices, src, dst)``: the graph's arcs on ``self.device``,
        labelled from the run's seed; sets ``n`` (vertices) and ``m``
        (edges)."""
        c = self.config
        scale = int(c["scale"])
        src, dst = gen.rmat_edges(scale, int(c["edge_factor"]),
                                  tuple(c["initiator_abc"]),
                                  int(c["graph_seed"]), self.device)
        src, dst = gen.relabel(src, dst, 1 << scale, self.seed)
        n, src, dst = gen.graphalytics_form(src, dst, 1 << scale)
        self.n, self.m = n, int(src.shape[0]) // 2
        return n, src, dst

    def setup(self) -> None:
        from flink_tpu_torch.graph_lib import Graph
        n, src, dst = self.edges()
        self.graph = Graph(n, src, dst, device=self.device)
        del src, dst
        for _ in range(int(self.traffic["warmup_jobs"])):
            self._job()
        self.rng = np.random.default_rng([self.seed, 2])
        self.kept = []

    def _job(self) -> np.ndarray:
        return getattr(self.graph, self.traffic["method"])(
            **self.traffic["kwargs"])

    def run(self, seconds: float, window) -> None:
        k = int(self.traffic["sample_jobs"])
        jobs = 0
        window.begin()
        deadline = window.t0 + seconds
        while time.perf_counter() < deadline:
            with window.span("job"):
                out = self._job()
            jobs += 1
            # reservoir sampling: each job is kept with chance k / jobs
            if len(self.kept) < k:
                self.kept.append(out)
            else:
                slot = int(self.rng.integers(0, jobs))
                if slot < k:
                    self.kept[slot] = out
        window.end()
        self.jobs = jobs

    def end_to_end(self, window) -> dict:
        # LDBC Graphalytics' EVPS: the dataset's vertices + edges (each
        # undirected edge once) a job, per second
        return {"evps": (self.n + self.m) * self.jobs / window.seconds}

    def counters(self) -> dict:
        return {"jobs": self.jobs, "method": self.traffic["method"],
                "kwargs": self.traffic["kwargs"], "vertices": self.n,
                "edges": self.m, "arcs": 2 * self.m}

    def release(self) -> None:
        self.graph = None

    def reference(self):
        return self.cell.module("reference", self.traffic["reference"])

    def answers(self):
        """(jobs run, jobs that returned nothing, the readings the limits
        apply to)."""
        import torch
        n, src, dst = self.edges()
        want = self.reference().answer(src, dst, n, self.traffic,
                                       torch.float64).cpu().numpy()
        del src, dst
        return compare(self.kept, want, self.jobs)

    def control(self, dtype, batches: int):
        """The control: the reference computed in ``dtype`` in the
        program's place for one job, through the same check (``batches``
        is the window family's)."""
        n, src, dst = self.edges()
        ref = self.reference()
        got = ref.answer(src, dst, n, self.traffic, dtype)
        self.kept = [got.float().cpu().numpy()]
        self.jobs = 1
        return self.answers()


def compare(kept, want: np.ndarray, jobs: int):
    """Readings: ``answer_errors`` (kept answers of the wrong shape or not
    finite) and ``rel_err`` (the largest |got - want| / |want| over the
    kept answers' vertices)."""
    errors = 0
    rel = 0.0
    for got in kept:
        got = np.asarray(got)
        if got.shape != want.shape or not np.isfinite(got).all():
            errors += 1
            continue
        err = np.abs(got.astype(np.float64) - want) / np.maximum(
            np.abs(want), np.finfo(np.float64).tiny)
        rel = max(rel, float(err.max()))
    if not kept:
        errors += 1
    return jobs, 0, {"answer_errors": errors, "rel_err": rel}
