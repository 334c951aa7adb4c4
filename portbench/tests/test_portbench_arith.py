"""The benchmark's arithmetic: the percentile over every fire, the interval
union behind the device's busy and idle time, the attribution of idle
gaps, the trace reduction, and the bytes models."""

import json

import numpy as np
import pytest

from portbench.lib import harness, stats, traces


def test_percentile_is_nearest_rank_over_every_sample():
    fires = list(range(1, 201))            # 200 fires: 10 above the p95
    assert stats.percentile(fires, 95) == 190
    assert stats.percentile([5.0], 95) == 5.0
    assert stats.percentile([3, 1, 2], 50) == 2
    # a value that was observed, never an interpolation
    assert stats.percentile([1.0, 10.0], 95) == 10.0
    with pytest.raises(ValueError):
        stats.percentile([], 95)


def test_spread_is_the_quartiles_over_the_median():
    assert stats.spread([1, 2, 3, 4, 5]) == pytest.approx((4.5 - 1.5) / 3)
    assert stats.spread([7.0] * 6) == 0


def test_union_counts_overlap_once():
    s, e = stats.union(np.array([0, 5, 1, 20, 8]), np.array([2, 9, 3, 30, 10]))
    assert s.tolist() == [0, 5, 20] and e.tolist() == [3, 10, 30]
    assert (e - s).sum() == 18
    s, e = stats.union(np.array([0.0, 0.0]), np.array([4.0, 1.0]))
    assert s.tolist() == [0.0] and e.tolist() == [4.0]


def test_gaps_are_the_complement_inside_the_window():
    s, e = stats.gaps(np.array([2.0, 6.0]), np.array([4.0, 12.0]), 0.0, 10.0)
    assert s.tolist() == [0.0, 4.0] and e.tolist() == [2.0, 6.0]
    s, e = stats.gaps(np.zeros(0), np.zeros(0), 1.0, 3.0)
    assert s.tolist() == [1.0] and e.tolist() == [3.0]


def test_first_level_keeps_the_outermost():
    s, e, lab = stats.first_level(np.array([0.0, 1.0, 5.0, 6.0]),
                                  np.array([4.0, 2.0, 9.0, 7.0]),
                                  ["a", "a.in", "b", "b.in"])
    assert lab == ["a", "b"] and s.tolist() == [0.0, 5.0]


def test_attribute_names_each_moment_by_its_layers():
    gap_s, gap_e = np.array([0.0, 10.0]), np.array([4.0, 12.0])
    coarse = (np.array([0.0]), np.array([11.0]), ["batch"])
    fine = (np.array([1.0]), np.array([3.0]), ["probe"])
    got = stats.attribute(gap_s, gap_e, [coarse, fine])
    assert got == pytest.approx({"batch": 3.0, "batch/probe": 2.0, "-": 1.0})
    assert sum(got.values()) == pytest.approx(6.0)


def test_reduce_trace_busy_idle_and_breakdown():
    """A synthetic chrome trace: two overlapping kernels and a copy inside
    a 10 ms window; the host's spans name the gaps."""
    anchor_ns = 1_000_000_000
    base = 5_000.0                         # the anchor's ts in us
    ev = [{"ph": "X", "cat": "user_annotation", "name": traces.ANCHOR,
           "ts": base, "dur": 1, "tid": 7},
          {"ph": "X", "cat": "kernel", "name": "fold", "ts": base + 1000,
           "dur": 2000},
          {"ph": "X", "cat": "kernel", "name": "fold", "ts": base + 2000,
           "dur": 2000},
          {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH",
           "ts": base + 8000, "dur": 500},
          {"ph": "X", "cat": "cpu_op", "name": "aten::to", "ts": base + 7000,
           "dur": 1000, "tid": 7},
          {"ph": "X", "cat": "cpu_op", "name": "aten::to", "ts": base + 7000,
           "dur": 1000, "tid": 9}]
    t0, t1 = anchor_ns, anchor_ns + 10_000_000
    harness_spans = [("batch", t0, t0 + 6_000_000)]
    phases = [("probe", t0 + 4_000_000, t0 + 6_000_000)]
    got = traces.reduce_trace(json.loads(json.dumps(ev)), anchor_ns, t0, t1,
                              harness_spans, phases)
    assert got["window_s"] == pytest.approx(0.010)
    assert got["busy_s"] == pytest.approx(0.0035)
    assert got["device_ops"][0] == ["fold", pytest.approx(0.004)]
    idle = dict(got["idle_gaps"])
    assert idle["batch"] == pytest.approx(0.001)
    assert idle["batch/probe"] == pytest.approx(0.002)
    assert idle["aten::to"] == pytest.approx(0.001)
    assert sum(idle.values()) == pytest.approx(0.0065)


def test_reduce_trace_needs_its_anchor():
    with pytest.raises(RuntimeError):
        traces.reduce_trace([], 0, 0, 1, [], [])


def _ctx(name, counters, busy_s=1.0):
    cell = harness.load_cell(name)
    trace = {"busy_s": busy_s, "window_s": 4.0}
    return harness.Context(cell, counters, trace, "NVIDIA H100 80GB HBM3")


def test_tumble_bytes_model():
    keys = np.array([1, 1, 2, 5], np.int64)
    pool = [(keys, np.ones(4, np.float32), np.arange(4))] * 2
    ctx = _ctx("tumble_sum_1m.uniform", {
        "batches": 3, "batch_size": 4, "pool": pool,
        "pool_visits": np.array([2, 1]), "fired_rows": 10})
    work = harness.load_module("work", "tumble_sum_1m").window_work(ctx)
    # 12 records x 20 B, 3 batches x 3 cells read and written x 4 B,
    # 10 rows x 12 B; one add a record
    assert work == (12 * 20 + 2 * 9 * 4 + 10 * 12, 12)
    want = 100 * (work[0] / 3.35e12) / 1.0
    assert ctx.roofline_pct() == pytest.approx(want)
    assert ctx.idle_pct() == pytest.approx(75.0)


def test_graph_bytes_model():
    ctx = _ctx("graph500_s22.pagerank", {
        "jobs": 2, "method": "pagerank", "vertices": 16, "edges": 32,
        "arcs": 64, "kwargs": {"damping": 0.85, "num_iterations": 10}})
    work = harness.load_module("work", "graph500_s22").window_work(ctx)
    # each of the 32 undirected edges is two arcs
    assert work == (2 * (4 * 64 + 4 * 16 + 10 * (8 * 64 + 12 * 16)),
                    2 * 10 * 64)
    ctx.counters["method"] = "connected_components"
    assert ctx.roofline_pct() is None


def test_readers_are_silent_without_a_trace():
    cell = harness.load_cell("graph500_s22.pagerank")
    ctx = harness.Context(cell, {"jobs": 3}, None, "cpu")
    for m in cell.per_layer:
        assert cell.module("metrics", m["name"]).read(ctx) is None


def test_host_metrics_are_phase_ms_over_their_count():
    cell = harness.load_cell("tumble_sum_1m.uniform")
    ctx = harness.Context(cell, {
        "phase_ns": {"probe": 8_000_000, "probe_mirror": 2_000_000,
                     "device_dispatch": 4_000_000, "fire": 9_000_000,
                     "snapshot": 3_000_000},
        "batches": 2, "fires": 3, "cuts": 1,
        "fire_ms": [float(x) for x in range(1, 201)]}, None, "cpu")
    read = {m["name"]: cell.module("metrics", m["name"]).read(ctx)
            for m in cell.per_layer}
    assert read["probe_ms_per_batch"] == pytest.approx(5.0)
    assert read["dispatch_ms_per_batch"] == pytest.approx(2.0)
    assert read["fire_ms_per_fire"] == pytest.approx(3.0)
    assert read["snapshot_ms_per_cut"] == pytest.approx(3.0)
    assert read["fire_wall_p95_ms"] == 190.0
    assert read["device_roofline_pct.tumble"] is None
    ctx.counters.update(fires=0, fire_ms=[])
    assert cell.module("metrics", "fire_ms_per_fire").read(ctx) is None
    assert cell.module("metrics", "fire_wall_p95_ms").read(ctx) is None
