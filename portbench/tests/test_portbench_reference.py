"""Each plain reference against the port at tiny sizes on the CPU (the
port's plain kernel versions), and against a brute-force loop."""

import numpy as np
import pytest
import torch

from portbench.lib import gen, harness
from portbench.tests.small import run_small, small_cell

TUMBLE = "tumble_sum_1m.uniform"
GRAPH = "graph500_s22.pagerank"
window_sum = harness.load_module("reference", "window_sum")
pagerank = harness.load_module("reference", "pagerank")

TRAFFIC = {"batch_size": 300, "ms_per_batch": 1000, "pool_batches": 4,
           "keys": {"dist": "uniform"}}


def _brute(pool, size, ms, w):
    """Per-key f64 sums of window ``w`` over the repeated pool, by a loop."""
    span = len(pool) * ms
    out = {}
    for p in range(-1, (w + 1) * size // span + 2):
        for keys, vals, ts in pool:
            for k, v, t in zip(keys.tolist(), vals.tolist(), ts.tolist()):
                if w * size <= t + p * span < (w + 1) * size:
                    out[k] = out.get(k, 0.0) + v
    return out


@pytest.mark.parametrize("size_ms", [5000, 1500, 3000])
def test_window_sum_equals_a_loop(size_ms):
    """Windows that hold whole batches, cut batches, and span two passes
    over the pool."""
    pool = gen.window_pool(TRAFFIC, 50, 4)
    ref = window_sum.TumblingSum(pool, size_ms, 1000, 50)
    for w in range(0, 8):
        want = _brute(pool, size_ms, 1000, w)
        got = ref.window(w)
        assert got["rows"] == len(want)
        assert got["total"] == pytest.approx(sum(want.values()), rel=1e-12)
        counts, sums = ref.sums(w)
        assert np.flatnonzero(counts).tolist() == sorted(want)
        assert sums[sorted(want)] == pytest.approx(
            [want[k] for k in sorted(want)], rel=1e-12)
        fired = ref.fired(w, torch.float64)
        assert len(fired) == len(want)
        assert dict(zip(fired.column("k").tolist(),
                        fired.column("result").tolist())) == pytest.approx(
            want, rel=1e-12)


def test_window_sum_reference_agrees_with_the_port():
    """The harness's whole check of a run of the port's operator on the
    CPU: every due window, every row count, the sampled rows and totals."""
    out = run_small(small_cell(TUMBLE))
    assert out["correct"], out["checks"]
    assert out["attempted"] > 5
    c = out["checks"]
    assert c["window_errors"]["value"] == c["row_count_gap"]["value"] == 0
    assert c["sample_key_gap"]["value"] == 0
    assert c["sample_rel_err"]["value"] < 1e-6


def _brute_pagerank(src, dst, n, d, iters):
    deg = np.bincount(src, minlength=n).astype(np.float64)
    r = np.full(n, 1.0 / n)
    for _ in range(iters):
        nxt = np.full(n, (1 - d) / n)
        lost = sum(r[u] for u in range(n) if deg[u] == 0)
        for u, v in zip(src.tolist(), dst.tolist()):
            nxt[v] += d * r[u] / deg[u]
        r = nxt + d * lost / n
    return r


def test_pagerank_equals_a_loop():
    src, dst = gen.rmat_edges(6, 4, (0.57, 0.19, 0.19), 3,
                              torch.device("cpu"))
    kw = {"kwargs": {"damping": 0.85, "num_iterations": 5}}
    got = pagerank.answer(src, dst, 64, kw, torch.float64).numpy()
    want = _brute_pagerank(src.numpy(), dst.numpy(), 64, 0.85, 5)
    assert got == pytest.approx(want, rel=1e-12)
    assert got.sum() == pytest.approx(1.0, rel=1e-12)


@pytest.mark.parametrize("form", ["raw", "graphalytics"])
def test_pagerank_reference_agrees_with_the_port(form):
    from flink_tpu_torch.graph_lib import Graph
    src, dst = gen.rmat_edges(10, 16, (0.57, 0.19, 0.19), 11,
                              torch.device("cpu"))
    n = 1 << 10
    if form == "graphalytics":
        n, src, dst = gen.graphalytics_form(src, dst, n)
    got = Graph(n, src, dst, device="cpu").pagerank(
        damping=0.85, num_iterations=10)
    want = pagerank.answer(src, dst, n, {"kwargs": {
        "damping": 0.85, "num_iterations": 10}}, torch.float64).numpy()
    assert np.max(np.abs(got - want) / want) < 1e-5
    out = run_small(small_cell(GRAPH))
    assert out["correct"], out["checks"]
    assert out["checks"]["rel_err"]["value"] < 1e-5


def _check(rows_of, keep=8):
    """The window check over windows 1..4 of a small pool, each window's
    rows as ``rows_of(w, keys, sums)`` returns them."""
    window = harness.load_module("drivers", "window")
    pool = gen.window_pool(TRAFFIC, 50, 9)
    ref = window_sum.TumblingSum(pool, 2000, 1000, 50)
    sink = window.Sink(2000, keep, np.random.default_rng(0))
    for w in range(1, 5):
        counts, sums = ref.sums(w)
        keys = np.flatnonzero(counts)
        k, v = rows_of(w, keys, sums[keys].astype(np.float32))
        sink.take([window_sum._Rows({
            "k": k, "result": v, "window_start": np.full(len(k), w * 2000),
            "window_end": np.full(len(k), w * 2000 + 2000)})], w)
    return window.compare(sink, np.arange(1, 5), 2000, ref)[2]


def test_the_window_check_reads_each_fault():
    ok = _check(lambda w, k, v: (k, v))
    assert ok["window_errors"] == ok["row_count_gap"] == 0
    assert ok["sample_key_gap"] == 0 and ok["sample_rel_err"] < 1e-6
    assert ok["total_rel_err"] < 1e-6
    dropped = _check(lambda w, k, v: (k[1:], v[1:]) if w == 2 else (k, v))
    assert dropped["row_count_gap"] == 1 and dropped["sample_key_gap"] == 1
    twice = _check(lambda w, k, v: (np.r_[k, k[:1]], np.r_[v, v[:1]]))
    assert twice["sample_key_gap"] == 4
    wrong_key = _check(lambda w, k, v: (np.r_[k[:-1], 77], v)
                       if w == 3 else (k, v))
    assert wrong_key["sample_key_gap"] == 2
    altered = _check(lambda w, k, v: (k, v * np.float32(1.001))
                     if w == 4 else (k, v))
    assert altered["sample_rel_err"] > 5e-4
    assert altered["total_rel_err"] > 5e-4
    # windows outside the sample still have their counts and totals read
    unsampled = _check(lambda w, k, v: (k[1:], v[1:]), keep=0)
    assert unsampled["row_count_gap"] == 4
    assert unsampled["sample_key_gap"] == 0


def _cut_readings(state_of):
    """The cut check of a cut after batch 6 of a small pool (2 s windows,
    the watermark 1 ms before batch 6's end), its state as ``state_of``
    makes it from the reference's exact one."""
    window = harness.load_module("drivers", "window")
    pool = gen.window_pool(TRAFFIC, 50, 9)
    ref = window_sum.TumblingSum(pool, 2000, 1000, 50)
    until, wm = 7000, 6998
    exact = ref.cut(window.open_windows(until, wm, 2000), until,
                    torch.float64)
    return window.compare_cut((until, wm, state_of(ref, exact)), ref, 2000)


def test_the_cut_check_reads_each_fault():
    window = harness.load_module("drivers", "window")
    assert list(window.open_windows(7000, 6998, 2000)) == [3]
    assert list(window.open_windows(8000, 7998, 2000)) == [3]
    assert list(window.open_windows(8000, 7999, 2000)) == []
    ok = _cut_readings(lambda ref, s: s)
    assert ok == {"cut_count_gap": 0, "cut_rel_err": 0.0}
    # the operator's layout: slots in another order than the keys
    def shuffled(ref, s):
        order = np.random.default_rng(1).permutation(ref.n_keys)
        return dict(s, key_index={"reverse": order},
                    counts=s["counts"][order], leaves=[s["leaves"][0][order]])
    assert _cut_readings(shuffled) == ok
    # window 3 holds batches 6 and 7: the cut has batch 6's records
    records = TRAFFIC["batch_size"]
    empty = _cut_readings(lambda ref, s: {"watermark": 6998})
    assert empty["cut_count_gap"] == records
    stale = _cut_readings(lambda ref, s: ref.cut([3], 6000, torch.float64))
    assert stale["cut_count_gap"] == records
    other_pane = _cut_readings(lambda ref, s: dict(s, panes=s["panes"] + 1))
    assert other_pane["cut_count_gap"] == 2 * records
    altered = _cut_readings(lambda ref, s: dict(
        s, leaves=[s["leaves"][0] * 1.001]))
    assert altered["cut_count_gap"] == 0
    assert altered["cut_rel_err"] > 5e-4
    assert window.compare_cut(None, None, 2000)["cut_count_gap"] == 1

