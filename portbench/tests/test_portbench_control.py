"""The check has to fail what it is there to catch, at sizes a test run
holds (on the card the control runs at each cell's own size:
``portbench/control.py``):

- the control, the plain reference computed in bfloat16 (the precision
  below the f32 the configurations state) in the program's place;
- a run of the harness with the timed path broken underneath, once for
  each fault a one-card cell can have: a step that returns its state
  unchanged, half of each batch left out (the rest weighted double, so a
  mean is kept), an answer altered where it is produced; and, where the
  configuration states checkpoints, a cut whose state is left empty or
  stale.
"""

import numpy as np
import pytest
import torch

from portbench.tests.small import run_small, small_cell

TUMBLE = "tumble_sum_1m.uniform"
GRAPH = "graph500_s22.pagerank"
SEED = 2 ** 31 + 4242


def _control(name, dtype):
    cell = small_cell(name)
    driver = cell.module("drivers", cell.config["driver"]).Driver(
        cell, SEED, torch.device("cpu"))
    attempted, failed, got = driver.control(dtype, 200)
    assert attempted > 0 and failed == 0
    return cell, got


@pytest.mark.parametrize("name", [TUMBLE, GRAPH])
def test_the_bfloat16_control_fails(name):
    cell, got = _control(name, torch.bfloat16)
    assert any(got[k] > v for k, v in cell.limits.items()), got


@pytest.mark.parametrize("name", [TUMBLE, GRAPH])
def test_the_reference_in_its_own_precision_passes(name):
    cell, got = _control(name, torch.float64)
    assert all(got[k] <= v for k, v in cell.limits.items()), got


def _tumble_unchanged(mp):
    from flink_tpu_torch.operators import window_agg
    mp.setattr(window_agg, "ordered_fold_counts", lambda *a, **k: None)


def _tumble_half(mp):
    from flink_tpu_torch.core.batch import RecordBatch
    from flink_tpu_torch.operators.window_agg import WindowAggOperator
    orig = WindowAggOperator.process_batch

    def half(self, batch):
        n = len(batch) // 2
        cols = {c: np.asarray(v)[:n] for c, v in batch.columns.items()}
        cols["v"] = cols["v"] * np.float32(2)
        return orig(self, RecordBatch(cols,
                                      timestamps=batch.timestamps[:n]))
    mp.setattr(WindowAggOperator, "process_batch", half)


def _tumble_altered(mp):
    from flink_tpu_torch.operators.window_agg import WindowAggOperator
    orig = WindowAggOperator.process_watermark

    def altered(self, wm):
        out = orig(self, wm)
        if out:
            res = np.array(out[0].column("result"))
            res[len(res) // 2] += 0.5
            out[0].columns["result"] = res
        return out
    mp.setattr(WindowAggOperator, "process_watermark", altered)


def _tumble_cut_empty(mp):
    from flink_tpu_torch.operators.window_agg import WindowAggOperator
    orig = WindowAggOperator.snapshot_state

    def empty(self):
        snap = orig(self)
        return {k: v for k, v in snap.items()
                if k not in ("panes", "counts", "leaves")}
    mp.setattr(WindowAggOperator, "snapshot_state", empty)


def _tumble_cut_stale(mp):
    from flink_tpu_torch.operators.window_agg import WindowAggOperator
    orig = WindowAggOperator.snapshot_state
    first = []

    def stale(self):
        snap = orig(self)
        if not first:
            first.append(snap)
        return first[0]
    mp.setattr(WindowAggOperator, "snapshot_state", stale)


def _graph_unchanged(mp):
    from flink_tpu_torch.graph_lib.graph import Graph
    orig = Graph.pagerank
    mp.setattr(Graph, "pagerank", lambda self, damping, num_iterations:
               orig(self, damping=damping, num_iterations=0))


def _graph_half(mp):
    from flink_tpu_torch.graph_lib import graph
    orig = graph.segment_combine

    def half(msgs, dst, n, kind):
        m = msgs.shape[0] // 2
        return orig(msgs[:m] * 2, dst[:m], n, kind)
    mp.setattr(graph, "segment_combine", half)


def _graph_altered(mp):
    from flink_tpu_torch.graph_lib.graph import Graph
    orig = Graph.pagerank

    def altered(self, **kw):
        r = orig(self, **kw)
        r[len(r) // 3] *= np.float32(1.05)
        return r
    mp.setattr(Graph, "pagerank", altered)


FAULTS = {TUMBLE: [_tumble_unchanged, _tumble_half, _tumble_altered,
                  _tumble_cut_empty, _tumble_cut_stale],
          GRAPH: [_graph_unchanged, _graph_half, _graph_altered]}


@pytest.mark.parametrize("name,fault", [(n, f) for n, fs in FAULTS.items()
                                        for f in fs],
                         ids=lambda x: getattr(x, "__name__", x))
def test_a_broken_timed_path_is_not_correct(monkeypatch, name, fault):
    fault(monkeypatch)
    out = run_small(small_cell(name), seed=SEED)
    assert out["attempted"] > 0
    assert out["correct"] is False, out["checks"]
