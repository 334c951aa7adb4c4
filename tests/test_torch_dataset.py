"""Port parity for the DataSet API, its optimizer and the out-of-core batch
runtime: ``flink_tpu_torch.dataset`` (``api.py``, ``optimizer.py``,
``external.py``) against ``flink_tpu.dataset`` on the CPU.

- The 18 tier-1 cases of ``tests/test_dataset.py`` and the 15 of
  ``tests/test_external_batch.py`` run through both packages (each case is
  a function of the package's modules, with its own assertions).  Their
  results must be equal row for row: the same rows in the same order, the
  same column order, dtypes and values.  The two ``slow`` cases of those
  files (peak RSS of a 40M-row plan and of a 10M x 10M join, in a child
  process) are not mirrored.
- The equi-join's device lane (``FLINK_TPU_DEVICE_JOIN=1`` in both
  packages, the port on ``device="cpu"``): inner, outer, multi-column and
  object-key joins and the grace join, held bit for bit to JAX's device
  lane, in the streamed and materialized executors, and to the host lane as
  a multiset of rows only: the device lane emits pairs left-major in left
  row order, the host lane key by key in sorted-key order.
- Iterations run their supersteps in the caller's environment (its device
  and config), where JAX's build a fresh default one.
- Out-of-core sort and join under a small ``FLINK_TPU_BATCH_MEMORY_ROWS``:
  the spill files are the port's FTB files (``external.spilled_bytes``).
"""

from __future__ import annotations

import os
import types

import numpy as np
import pytest

import flink_tpu.dataset.external as jext
from flink_tpu.core.batch import RecordBatch as JaxBatch
from flink_tpu.dataset.api import ExecutionEnvironment as JaxEnv
from flink_tpu.operators.joins import _join_pairs as jax_join_pairs
import flink_tpu_torch.dataset.external as pext
from flink_tpu_torch.core.batch import RecordBatch
from flink_tpu_torch.dataset.api import ExecutionEnvironment
from flink_tpu_torch.operators.joins import _join_pairs as port_join_pairs

SIDES = {
    "jax": types.SimpleNamespace(
        name="jax", RB=JaxBatch, ext=jext, Env=JaxEnv,
        env=lambda config=None: JaxEnv(config),
        join_pairs=lambda lk, rk: jax_join_pairs(lk, rk)),
    "port": types.SimpleNamespace(
        name="port", RB=RecordBatch, ext=pext, Env=ExecutionEnvironment,
        env=lambda config=None: ExecutionEnvironment(config, device="cpu"),
        join_pairs=lambda lk, rk: port_join_pairs(lk, rk, "cpu")),
}


@pytest.fixture(params=["host", "device"])
def lane(request, monkeypatch):
    """The equi-join's lane in both packages: the host span intersection or
    the device sorted-merge join (``FLINK_TPU_DEVICE_JOIN=1``)."""
    if request.param == "device":
        monkeypatch.setenv("FLINK_TPU_DEVICE_JOIN", "1")
    else:
        monkeypatch.delenv("FLINK_TPU_DEVICE_JOIN", raising=False)
    return request.param


def norm(x):
    """A comparable, exact view: batches by column name, dtype and bytes
    (object columns by value), rows by key, type and value."""
    if isinstance(x, (JaxBatch, RecordBatch)):
        cols = []
        for k, v in x.columns.items():
            a = np.asarray(v)
            cols.append((k, a.dtype.str, a.shape,
                         a.tolist() if a.dtype == object else a.tobytes()))
        ts = None if x.timestamps is None else \
            np.asarray(x.timestamps).tobytes()
        return ("batch", len(x), cols, ts)
    if isinstance(x, dict):
        return tuple((k, type(v).__name__, norm(v)) for k, v in x.items())
    if isinstance(x, (list, tuple)):
        return [norm(v) for v in x]
    if isinstance(x, np.ndarray):
        return (x.dtype.str, x.shape, x.tolist())
    if isinstance(x, float) and x != x:
        return "nan"
    return x


def both(run, *args):
    out = [run(SIDES[s], *args) for s in ("jax", "port")]
    assert norm(out[0]) == norm(out[1])
    return out[1]


def _streamed_rows(ds):
    rows = []
    for b in ds.stream_batches():
        rows.extend(b.to_rows())
    return rows


def _multiset(rows):
    return sorted(tuple(sorted((k, repr(v)) for k, v in r.items()))
                  for r in rows)


# ---------------------------------------------------------------------------
# tests/test_dataset.py
# ---------------------------------------------------------------------------

def d_map_filter_project(ns, _tmp):
    out = (ns.env().generate_sequence(1, 10)
           .map(lambda c: {"value": c["value"],
                           "sq": np.asarray(c["value"]) ** 2})
           .filter(lambda c: np.asarray(c["sq"]) % 2 == 0)
           .project("sq")
           .collect())
    assert [r["sq"] for r in out] == [4, 16, 36, 64, 100]
    return out


def d_group_by_aggregations(ns, _tmp):
    ds = ns.env().from_columns({"k": [1, 2, 1, 2, 1],
                                "v": [10., 20., 30., 40., 50.]})
    sums = ds.group_by("k").sum("v").collect()
    mins = ds.group_by("k").min("v").collect()
    maxs = ds.group_by("k").max("v").collect()
    counts = ds.group_by("k").count().collect()
    assert {r["k"]: r["v"] for r in sums} == {1: 90.0, 2: 60.0}
    assert {r["k"]: r["v"] for r in mins} == {1: 10.0, 2: 20.0}
    assert {r["k"]: r["count"] for r in counts} == {1: 3, 2: 2}
    return sums, mins, maxs, counts


def d_group_by_composite_key(ns, _tmp):
    ds = ns.env().from_columns({"a": [1, 1, 2], "b": [1, 1, 1],
                                "v": [5., 6., 7.]})
    out = ds.group_by("a", "b").sum("v").collect()
    assert {(r["a"], r["b"]): r["v"] for r in out} == {(1, 1): 11.0,
                                                       (2, 1): 7.0}
    return out


def d_group_reduce_and_first_n(ns, _tmp):
    ds = ns.env().from_columns({"k": [1, 1, 1, 2], "v": [3., 1., 2., 9.]})
    out = (ds.group_by("k")
           .reduce_group(lambda k, rows: {"k": k, "n": len(rows),
                                          "tot": sum(r["v"] for r in rows)})
           .collect())
    assert {r["k"]: (r["n"], r["tot"]) for r in out} == {1: (3, 6.0),
                                                         2: (1, 9.0)}
    topn = ds.sort_partition("v").group_by("k").first_n(2).collect()
    assert len(topn) == 3
    return out, topn


def d_distinct_sort_first(ns, _tmp):
    ds = ns.env().from_columns({"x": [3, 1, 2, 3, 1]})
    dist = ds.distinct().collect()
    first = ds.sort_partition("x").first_n(2).collect()
    assert sorted(r["x"] for r in dist) == [1, 2, 3]
    assert [r["x"] for r in first] == [1, 1]
    return dist, first


def d_inner_join(ns, _tmp):
    env = ns.env()
    users = env.from_columns({"uid": [1, 2, 3],
                              "name": np.asarray(["a", "b", "c"], object)})
    orders = env.from_columns({"uid": [1, 1, 3], "amt": [10., 20., 30.]})
    out = orders.join(users).where("uid").equal_to("uid").apply().collect()
    assert sorted((r["name"], r["amt"]) for r in out) == \
        [("a", 10.0), ("a", 20.0), ("c", 30.0)]
    return out


def d_outer_joins(ns, _tmp):
    env = ns.env()
    l = env.from_columns({"k": [1, 2], "lv": [10., 20.]})
    r = env.from_columns({"k": [2, 3], "rv": [200., 300.]})
    left = l.left_outer_join(r).where("k").equal_to("k").apply().collect()
    right = l.right_outer_join(r).where("k").equal_to("k").apply().collect()
    full = l.full_outer_join(r).where("k").equal_to("k").apply().collect()
    assert len(left) == 2 and len(right) == 2 and len(full) == 3
    assert [x for x in left if x["lv"] == 10.0][0]["rv"] is None
    return left, right, full


def d_cogroup(ns, _tmp):
    env = ns.env()
    l = env.from_columns({"k": [1, 1, 2], "v": [1., 2., 3.]})
    r = env.from_columns({"k": [2, 3], "w": [9., 8.]})
    out = (l.co_group(r).where("k").equal_to("k")
           .apply(lambda k, lr, rr: {"k": k, "nl": len(lr), "nr": len(rr)})
           .collect())
    assert {r["k"]: (r["nl"], r["nr"]) for r in out} == \
        {1: (2, 0), 2: (1, 1), 3: (0, 1)}
    with pytest.raises(ValueError, match="apply function"):
        l.co_group(r).where("k").equal_to("k").apply().collect()
    return out


def d_cross_and_union(ns, _tmp):
    env = ns.env()
    a = env.from_columns({"x": [1, 2]})
    b = env.from_columns({"y": [10, 20, 30]})
    cross, union = a.cross(b).collect(), a.union(a).collect()
    assert len(cross) == 6 and len(union) == 4
    with pytest.raises(ValueError, match="where"):
        a.join(b).apply()
    return cross, union


def d_optimizer_broadcast_choice(ns, _tmp):
    env = ns.env()
    big = env.from_columns({"k": np.arange(1000) % 10, "v": np.ones(1000)})
    small = env.from_columns({"k": np.arange(10), "name": np.arange(10)})
    joined = big.join(small).where("k").equal_to("k").apply()
    plan = joined.explain()
    assert "broadcast_hash_right" in plan
    left = small.join(big).where("k").equal_to("k").apply().explain()
    assert "broadcast_hash_left" in left
    hinted = (big.join(small).where("k").equal_to("k")
              .with_hint("sort_merge").apply())
    assert "sort_merge" in hinted.explain()
    rows = joined.collect()
    assert len(rows) == 1000
    return plan, left, hinted.explain(), rows


def d_bulk_iteration_converges(ns, _tmp):
    start = ns.env().from_columns({"x": [1.0, 3.0]})

    def step(ds):
        return ds.map(lambda c: {"x": (np.asarray(c["x"])
                                       + 2 / np.asarray(c["x"])) / 2})

    out = start.iterate(50, step, termination=lambda prev, nxt: bool(
        np.allclose(np.asarray(prev.column("x")),
                    np.asarray(nxt.column("x"))))).collect()
    assert np.allclose([r["x"] for r in out], np.sqrt(2))
    return out


def d_delta_iteration_connected_components_style(ns, _tmp):
    env = ns.env()
    edges = [(0, 1), (1, 2), (3, 4)]
    neighbors = {n: set() for n in range(5)}
    for a, b in edges:
        neighbors[a].add(b)
        neighbors[b].add(a)
    solution = env.from_columns({"v": np.arange(5), "label": np.arange(5)})
    workset = env.from_columns({"v": np.arange(5), "label": np.arange(5)})

    def step(sol_ds, work_ds):
        sol, work = sol_ds.collect_batch(), work_ds.collect_batch()
        labels = {int(v): int(l) for v, l in
                  zip(np.asarray(sol.column("v")),
                      np.asarray(sol.column("label")))}
        changed = {}
        for v, l in zip(np.asarray(work.column("v")).tolist(),
                        np.asarray(work.column("label")).tolist()):
            for nb in neighbors[v]:
                if l < labels.get(nb, 1 << 30) and \
                        l < changed.get(nb, 1 << 30):
                    changed[nb] = l
        delta = ns.env().from_columns(
            {"v": np.asarray(list(changed.keys()), np.int64),
             "label": np.asarray(list(changed.values()), np.int64)})
        return delta, delta

    out = solution.delta_iterate(workset, "v", 10, step).collect()
    assert {r["v"]: r["label"] for r in out} == {0: 0, 1: 0, 2: 0, 3: 3,
                                                 4: 3}
    return out


def d_global_agg_and_reduce(ns, _tmp):
    ds = ns.env().from_columns({"v": [1., 2., 3.]})
    s, mx, mn = (ds.sum("v").collect(), ds.max("v").collect(),
                 ds.min("v").collect())
    red = ds.reduce(lambda a, b: {"v": a["v"] + b["v"]}).collect()
    assert s[0]["v"] == 6.0 and mx[0]["v"] == 3.0 and red[0]["v"] == 6.0
    return s, mx, mn, red, ds.count()


def d_file_roundtrip(ns, tmp):
    env = ns.env()
    outs = []
    for fmt in ("csv", "jsonl", "ftb"):
        p = str(tmp / f"{ns.name}.{fmt}")
        n = env.from_columns({"a": [1, 2, 3], "b": [1., 2., 3.]}) \
            .write_file(p, format=fmt)
        back = env.read_file(p, format=fmt).collect()
        assert n == 3 and [r["a"] for r in back] == [1, 2, 3]
        outs.append((back, list(env.read_file(p, format=fmt)
                                .stream_batches())))
    return outs


def d_composite_key_no_collision_large_values(ns, _tmp):
    ds = ns.env().from_columns({"a": np.array([0, 1], np.int64),
                                "b": np.array([2147483647, 0], np.int64),
                                "v": np.array([1.0, 1.0])})
    out = ds.group_by("a", "b").sum("v").collect()
    assert len(out) == 2
    return out


def d_stream_plan_matches_materialized(ns, _tmp):
    env = ns.env()
    old = ns.ext.memory_budget_rows
    ns.ext.memory_budget_rows = lambda: 64    # many chunks and spills
    try:
        n = 1000
        ds = (env.from_columns({"k": np.arange(n) % 17,
                                "v": np.arange(n, dtype=np.float64)})
              .filter(lambda c: np.asarray(c["v"]) % 3 != 0)
              .map(lambda c: {"k": c["k"], "v": np.asarray(c["v"]) * 2}))
        out = []
        for plan in (ds.group_by("k").sum("v"), ds.group_by("k").count(),
                     ds.sort_partition("v", ascending=False).first_n(10),
                     ds.map(lambda c: {"k": c["k"]}).distinct("k"),
                     ds.group_by("k").min("v"), ds.sum("v")):
            got, ref = _streamed_rows(plan), plan.collect()
            assert _multiset(got) == _multiset(ref)
            out.append((got, ref))
        assert ds.count() == sum(1 for i in range(n) if i % 3 != 0)
        return out, ds.count()
    finally:
        ns.ext.memory_budget_rows = old


def d_stream_plan_shared_subplan_materializes_once(ns, _tmp):
    calls = {"n": 0}

    def spy(cols):
        calls["n"] += 1
        return {"k": cols["k"], "v": cols["v"]}

    base = ns.env().from_columns({"k": np.arange(100) % 5,
                                  "v": np.ones(100)}).map(spy)
    joined = base.join(base).where("k").equal_to("k").apply()
    rows = _streamed_rows(joined)
    assert calls["n"] == 1
    return rows


def d_stream_plan_empty_result_keeps_schema(ns, _tmp):
    env = ns.env()
    ds = (env.from_columns({"v": np.arange(10.0)})
          .filter(lambda c: np.asarray(c["v"]) < 0))
    assert ds.count() == 0
    batches = list(ds.stream_batches())
    assert len(batches) == 1 and len(batches[0]) == 0
    assert list(batches[0].columns) == ["v"]
    s = ds.sum("v")
    assert [r for b in s.stream_batches() for r in b.to_rows()] == \
        s.collect()
    right = env.from_columns({"v": np.arange(3.0), "b": np.ones(3)})
    j = ds.full_outer_join(right).where("v").equal_to("v").apply()
    got = sorted(tuple(sorted(r)) for b in j.stream_batches()
                 for r in b.to_rows())
    ref = sorted(tuple(sorted(r)) for r in j.collect())
    assert got == ref and len(ref) == 3
    return batches, got, j.collect()


DATASET_CASES = {n[2:]: f for n, f in dict(globals()).items()
                 if n.startswith("d_")}


@pytest.mark.parametrize("case", sorted(DATASET_CASES))
def test_dataset_case_equals_jax(case, tmp_path):
    both(DATASET_CASES[case], tmp_path)


# ---------------------------------------------------------------------------
# tests/test_external_batch.py
# ---------------------------------------------------------------------------

def x_external_sort_many_runs_matches_inmemory(ns, _tmp):
    rng = np.random.default_rng(7)
    keys = rng.integers(0, 10_000, 50_000).astype(np.int64)
    vals = rng.random(50_000)
    s = ns.ext.ExternalSorter(["k"], budget_rows=3_000)   # ~17 runs
    for lo in range(0, 50_000, 1_000):
        s.add(ns.RB({"k": keys[lo:lo + 1_000], "v": vals[lo:lo + 1_000]}))
    out = s.sorted_batch()
    got = np.asarray(out.column("k"))
    np.testing.assert_array_equal(got, np.sort(keys))
    assert sorted(zip(got.tolist(), np.asarray(out.column("v")).tolist())) \
        == sorted(zip(keys.tolist(), vals.tolist()))
    return out


def x_external_sort_descending_and_streamed_batches(ns, _tmp):
    keys = np.arange(9_000, dtype=np.int64)
    s = ns.ext.ExternalSorter(["k"], ascending=False, budget_rows=2_000,
                              emit_batch_rows=1_000)
    s.add(ns.RB({"k": keys}))
    chunks = list(s.merged())
    assert all(len(c) <= 1_000 for c in chunks)
    np.testing.assert_array_equal(
        np.concatenate([np.asarray(c.column("k")) for c in chunks]),
        keys[::-1])
    return chunks


def x_external_sort_in_memory_tail_only(ns, _tmp):
    s = ns.ext.ExternalSorter(["k"], budget_rows=1_000_000)
    s.add(ns.RB({"k": np.array([3, 1, 2], np.int64)}))
    s.add(ns.RB({"k": np.zeros(0, np.int64)}))
    out = s.sorted_batch()
    assert np.asarray(out.column("k")).tolist() == [1, 2, 3]
    assert ns.ext.ExternalSorter(["k"]).sorted_batch() is None
    return out


def _grace_rows(gj):
    out = []
    for lb, li, rb, ri in gj.join_pairs():
        assert (np.asarray(lb.column("k"))[li]
                == np.asarray(rb.column("k"))[ri]).all()
        out.append((lb, li, rb, ri))
    return out


def x_grace_hash_join_matches_inmemory(ns, _tmp):
    rng = np.random.default_rng(9)
    lk = rng.integers(0, 500, 20_000).astype(np.int64)
    rk = rng.integers(0, 500, 5_000).astype(np.int64)
    gj = ns.ext.GraceHashJoin("k", "k", budget_rows=4_000)
    gj.add(0, ns.RB({"k": lk, "lv": np.arange(20_000)}))
    gj.add(1, ns.RB({"k": rk, "rv": np.arange(5_000)}))
    parts = _grace_rows(gj)
    pairs = sorted(p for lb, li, rb, ri in parts for p in zip(
        np.asarray(lb.column("lv"))[li].tolist(),
        np.asarray(rb.column("rv"))[ri].tolist()))
    li0, ri0 = ns.join_pairs(lk, rk)
    assert pairs == sorted(zip(li0.tolist(), ri0.tolist()))
    return parts


def x_dataset_sort_and_join_use_spill_paths(ns, _tmp):
    rng = np.random.default_rng(3)
    n = 30_000
    keys = rng.integers(0, 2_000, n).astype(np.int64)

    def run():
        env = ns.env()
        ds = env.from_columns({"k": keys, "v": np.arange(n)})
        sorted_rows = ds.sort_partition("k").collect()
        other = env.from_columns({"k": np.arange(0, 2_000, 2),
                                  "w": np.arange(1_000)})
        joined = (env.from_columns({"k": keys, "v": np.arange(n)})
                  .join(other).where("k").equal_to("k").apply().collect())
        return sorted_rows, joined

    in_mem = run()
    old = os.environ.get("FLINK_TPU_BATCH_MEMORY_ROWS")
    os.environ["FLINK_TPU_BATCH_MEMORY_ROWS"] = "4000"
    try:
        spilled = run()
    finally:
        _restore_budget(old)
    assert [r["k"] for r in spilled[0]] == [r["k"] for r in in_mem[0]]
    assert _multiset(spilled[1]) == _multiset(in_mem[1])
    return in_mem, spilled


def _restore_budget(old):
    if old is None:
        os.environ.pop("FLINK_TPU_BATCH_MEMORY_ROWS", None)
    else:
        os.environ["FLINK_TPU_BATCH_MEMORY_ROWS"] = old


def x_grace_hash_join_aliasing_and_skew(ns, _tmp):
    gj = ns.ext.GraceHashJoin("k", "k", budget_rows=1_000)
    gj.add(0, ns.RB({"k": np.zeros(9_000, np.int64),
                     "lv": np.arange(9_000)}))
    gj.add(1, ns.RB({"k": np.zeros(50, np.int64), "rv": np.arange(50)}))
    parts = _grace_rows(gj)
    assert sum(len(li) for _l, li, _r, _ri in parts) == 9_000 * 50
    gj.add(0, ns.RB({"k": np.array([1], np.int64), "lv": np.array([0])}))
    assert len(gj._right) == 0
    return parts


def x_external_sort_string_keys_fall_back_to_rowheap(ns, _tmp):
    s = ns.ext.ExternalSorter(["k"], budget_rows=100)
    words = np.asarray([f"w{i:03d}" for i in range(500)][::-1], object)
    for lo in range(0, 500, 50):
        s.add(ns.RB({"k": words[lo:lo + 50]}))
    out = s.sorted_batch()
    assert [str(x) for x in np.asarray(out.column("k"))] == \
        sorted(str(w) for w in words)
    d = ns.ext.ExternalSorter(["k", "j"], ascending=False, budget_rows=100)
    for lo in range(0, 500, 50):
        d.add(ns.RB({"k": words[lo:lo + 50] if lo % 100 else
                     words[lo:lo + 50][::-1],
                     "j": np.arange(lo, lo + 50, dtype=np.int64) % 7},
                    timestamps=np.arange(lo, lo + 50, dtype=np.int64)))
    return out, d.sorted_batch()


def x_external_sort_descending_uint64_and_int64_min(ns, _tmp):
    vals = np.array([5, 2, 9, 2**63 + 7, 0, 13], np.uint64)
    s = ns.ext.ExternalSorter(["k"], ascending=False, budget_rows=2)
    for v in vals:
        s.add(ns.RB({"k": np.array([v], np.uint64)}))
    out = s.sorted_batch()
    np.testing.assert_array_equal(np.asarray(out.column("k")),
                                  np.sort(vals)[::-1])
    imin = np.iinfo(np.int64).min
    vals2 = np.array([3, imin, 7, -5], np.int64)
    s2 = ns.ext.ExternalSorter(["k"], ascending=False, budget_rows=2)
    for v in vals2:
        s2.add(ns.RB({"k": np.array([v], np.int64)}))
    out2 = s2.sorted_batch()
    np.testing.assert_array_equal(np.asarray(out2.column("k")),
                                  np.sort(vals2)[::-1])
    return out, out2


def x_grace_join_fast_path_resets_and_cleans(ns, _tmp):
    gj = ns.ext.GraceHashJoin("k", "k", budget_rows=1_000_000)
    gj.add(0, ns.RB({"k": np.array([1], np.int64)}))
    gj.add(1, ns.RB({"k": np.array([1], np.int64)}))
    n = sum(len(li) for _l, li, _r, _ri in gj.join_pairs())
    assert n == 1
    assert gj._left == [] and gj._right == [] and gj._rows == [0, 0]
    return n


def x_incremental_spill_during_add(ns, tmp):
    d = tmp / f"gj-{ns.name}"
    gj = ns.ext.GraceHashJoin("k", "k", budget_rows=1_000, spill_dir=str(d))
    rng = np.random.default_rng(2)
    for lo in range(0, 10_000, 500):
        gj.add(0, ns.RB({"k": rng.integers(0, 200, 500).astype(np.int64),
                         "v": np.arange(500)}))
    assert gj._spilled and not gj._left and not gj._right
    files = sorted(os.listdir(d))
    assert any(f.endswith(".ftb") for f in files)
    blobs = {f: (d / f).read_bytes() for f in files}
    gj.add(1, ns.RB({"k": np.arange(200, dtype=np.int64),
                     "w": np.arange(200)}))
    parts = _grace_rows(gj)
    assert sum(li.size for _l, li, _r, _ri in parts) == 10_000
    return parts, blobs


def x_streamed_join_matches_materialized(ns, _tmp):
    rng = np.random.default_rng(11)
    env = ns.env()
    l = env.from_columns({"k": rng.integers(0, 50, 3_000).astype(np.int64),
                          "v": np.arange(3_000)})
    r = env.from_columns({"k": rng.integers(0, 50, 800).astype(np.int64),
                          "w": np.arange(800)})
    ds = l.join(r).where("k").equal_to("k").apply()
    mat, got = ds.collect(), _streamed_rows(ds)
    assert _multiset(got) == _multiset(mat) and len(got) > 3_000
    return mat, got


def x_streamed_group_reduce_matches_materialized(ns, _tmp):
    rng = np.random.default_rng(12)
    ds0 = ns.env().from_columns(
        {"k": rng.integers(0, 40, 5_000).astype(np.int64),
         "v": rng.integers(0, 100, 5_000)})

    def fn(key, rows):
        return {"k": int(key), "n": len(rows),
                "s": sum(int(r["v"]) for r in rows)}

    ds = ds0.group_by("k").reduce_group(fn)
    mat, got = ds.collect(), _streamed_rows(ds)
    assert sorted((r["k"], r["n"], r["s"]) for r in got) == \
        sorted((r["k"], r["n"], r["s"]) for r in mat)
    return mat, got


def x_streamed_join_empty_keeps_schema(ns, _tmp):
    env = ns.env()
    l = env.from_columns({"k": np.arange(5, dtype=np.int64),
                          "v": np.arange(5)})
    r = env.from_columns({"k": np.arange(10, 15, dtype=np.int64),
                          "w": np.arange(5)})
    ds = l.join(r).where("k").equal_to("k").apply()
    batches = list(ds.stream_batches())
    assert sum(len(b) for b in batches) == 0
    assert set(batches[-1].columns) == set(ds.collect_batch().columns)
    return batches


def x_multicolumn_key_join_canonical_across_chunks(ns, _tmp):
    env = ns.env()
    l = env.from_columns({"a": np.array([0, 1, 10, 11] * 3, np.int64),
                          "b": np.array([0, 0, 0, 0, 1, 1, 1, 1,
                                         2, 2, 2, 2], np.int64),
                          "v": np.arange(12)})
    r = env.from_columns({"a": np.array([0, 10, 0], np.int64),
                          "b": np.array([0, 0, 1], np.int64),
                          "w": np.arange(3)})
    ds = l.join(r).where("a", "b").equal_to("a", "b").apply()
    expected = sorted([(0, 0, 0), (10, 0, 2), (0, 1, 4)])

    def got(rows):
        return sorted((int(x["a"]), int(x["b"]), int(x["v"])) for x in rows)

    mat = ds.collect()
    assert got(mat) == expected
    old = os.environ.get("FLINK_TPU_BATCH_MEMORY_ROWS")
    os.environ["FLINK_TPU_BATCH_MEMORY_ROWS"] = "4"
    try:
        streamed = _streamed_rows(ds)
    finally:
        _restore_budget(old)
    assert got(streamed) == expected
    return mat, streamed


def x_multicolumn_distinct_across_chunks(ns, _tmp):
    ds = ns.env().from_columns({
        "a": np.array([0, 1, 10, 11, 0, 10], np.int64),
        "b": np.array([0, 0, 0, 0, 0, 0], np.int64)}).distinct("a", "b")
    old = os.environ.get("FLINK_TPU_BATCH_MEMORY_ROWS")
    os.environ["FLINK_TPU_BATCH_MEMORY_ROWS"] = "2"
    try:
        rows = _streamed_rows(ds)
    finally:
        _restore_budget(old)
    assert sorted((int(r["a"]), int(r["b"])) for r in rows) == [
        (0, 0), (1, 0), (10, 0), (11, 0)]
    return rows


EXTERNAL_CASES = {n[2:]: f for n, f in dict(globals()).items()
                  if n.startswith("x_")}


@pytest.mark.parametrize("case", sorted(EXTERNAL_CASES))
def test_external_batch_case_equals_jax(case, tmp_path):
    both(EXTERNAL_CASES[case], tmp_path)


# ---------------------------------------------------------------------------
# the equi-join's device lane
# ---------------------------------------------------------------------------

def _join_inputs(env, rng, n_l=3_000, n_r=700, keys=60, obj=False):
    lk = rng.integers(0, keys, n_l).astype(np.int64)
    rk = rng.integers(0, keys + 20, n_r).astype(np.int64)
    if obj:
        lk = np.asarray([f"k{k}" for k in lk], object)
        rk = np.asarray([f"k{k}" for k in rk], object)
    l = env.from_columns({"k": lk, "j": np.arange(n_l) % 3,
                          "v": rng.standard_normal(n_l)})
    r = env.from_columns({"k": rk, "j": np.arange(n_r) % 3,
                          "w": rng.integers(0, 99, n_r)})
    return l, r


def _lane_plans(ns, how, multi, obj):
    rng = np.random.default_rng(41)
    l, r = _join_inputs(ns.env(), rng, obj=obj)
    keys = ("k", "j") if multi else ("k",)
    builder = {"inner": l.join, "left": l.left_outer_join,
               "right": l.right_outer_join, "full": l.full_outer_join}[how]
    j = builder(r).where(*keys).equal_to(*keys).apply()
    agg = j.group_by("k").sum("v") if how == "inner" else None
    return j, agg


JOIN_KINDS = {"inner": ("inner", False, False),
              "inner-multicolumn": ("inner", True, False),
              "inner-object-keys": ("inner", False, True),
              "left": ("left", False, False),
              "right": ("right", False, False),
              "full-multicolumn": ("full", True, False)}


@pytest.mark.parametrize("kind", sorted(JOIN_KINDS))
def test_device_lane_equals_jax_device_lane(kind, monkeypatch):
    """Under ``FLINK_TPU_DEVICE_JOIN=1`` in both packages the port's joins
    (materialized and streamed) equal JAX's device lane bit for bit, and
    the host lane as a multiset of rows."""
    how, multi, obj = JOIN_KINDS[kind]

    def run(ns):
        j, agg = _lane_plans(ns, how, multi, obj)
        out = [j.collect_batch(), list(j.stream_batches())]
        if agg is not None:
            out.append(agg.collect_batch())
        return out

    monkeypatch.setenv("FLINK_TPU_DEVICE_JOIN", "1")
    dev = both(run)
    monkeypatch.delenv("FLINK_TPU_DEVICE_JOIN")
    host = run(SIDES["port"])
    assert _multiset(dev[0].to_rows()) == _multiset(host[0].to_rows())
    streamed = [r for b in dev[1] for r in b.to_rows()]
    assert _multiset(streamed) == _multiset(host[0].to_rows())
    assert len(dev[0]) > 0
    if agg_rows := (dev[2:] and dev[2].to_rows()):
        # a later float sum over rows in another order: keys exact, values
        # to the last bits
        want = {r["k"]: r["v"] for r in host[2].to_rows()}
        got = {r["k"]: r["v"] for r in agg_rows}
        assert got.keys() == want.keys()
        np.testing.assert_allclose([got[k] for k in want],
                                   [want[k] for k in want], rtol=1e-12)


def test_device_lane_grace_join_equals_jax(monkeypatch):
    """The grace join's bucket pairs through the device lane, out of core
    (the bucket files are the port's FTB files), bit for bit with JAX's."""
    monkeypatch.setenv("FLINK_TPU_DEVICE_JOIN", "1")

    def run(ns, tmp=None):
        rng = np.random.default_rng(5)
        lk = rng.integers(0, 300, 6_000).astype(np.int64)
        rk = rng.integers(0, 300, 2_000).astype(np.int64)
        kw = {"device": "cpu"} if ns.name == "port" else {}
        gj = ns.ext.GraceHashJoin("k", "k", budget_rows=3_000,
                                  num_buckets=4, **kw)
        gj.add(0, ns.RB({"k": lk, "lv": np.arange(6_000)}))
        gj.add(1, ns.RB({"k": rk, "rv": np.arange(2_000)}))
        return _grace_rows(gj)

    before = pext.spilled_bytes["join"]
    parts = both(run)
    assert len(parts) > 1 and pext.spilled_bytes["join"] > before


def test_device_lane_default_device_is_the_card(monkeypatch):
    """``ExecutionEnvironment()`` puts the device lane on the card: with no
    GPU its join raises instead of running on the CPU; the host lane needs
    no device."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device is usable")
    env = ExecutionEnvironment()
    assert env.device is None
    l = env.from_columns({"k": np.arange(4, dtype=np.int64)})
    j = l.join(l).where("k").equal_to("k").apply()
    assert len(j.collect()) == 4                 # host lane
    monkeypatch.setenv("FLINK_TPU_DEVICE_JOIN", "1")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        j.collect()


def _iteration_plans(ns):
    env = ns.env()
    edges = env.from_columns({"src": np.array([0, 1, 1, 2, 3, 4], np.int64),
                              "dst": np.array([1, 0, 2, 1, 4, 3], np.int64)})
    sol = env.from_columns({"v": np.arange(6, dtype=np.int64),
                            "label": np.arange(6, dtype=np.int64)})

    def step(sol_ds, work_ds):
        cand = (work_ds.join(edges).where("v").equal_to("src").apply()
                .map(lambda c: {"v": c["dst"], "label": c["label"]})
                .group_by("v").min("label"))
        better = (cand.join(sol_ds).where("v").equal_to("v").apply()
                  .filter(lambda c: np.asarray(c["label"])
                          < np.asarray(c["r_label"]))
                  .project("v", "label"))
        b = ns.env().from_columns(dict(better.collect_batch().columns))
        return b, b

    cc = sol.delta_iterate(sol, "v", 10, step)

    def bulk_step(ds):
        return (ds.join(edges).where("v").equal_to("src").apply()
                .map(lambda c: {"v": c["dst"], "label": c["label"]})
                .union(ds).group_by("v").min("label"))

    bulk = sol.iterate(10, bulk_step)
    return cc, bulk


def test_iterations_run_on_the_callers_environment(monkeypatch):
    """Both iteration drivers run their supersteps in the caller's
    environment: under the device lane every join of a superstep runs on
    the environment's device (``cpu`` here; a fresh default environment
    would put it on the card), and the labels equal JAX's."""
    from flink_tpu_torch.ops import join_kernels
    monkeypatch.setenv("FLINK_TPU_DEVICE_JOIN", "1")
    devices = []
    orig = join_kernels.device_join_pairs

    def spy(lk, rk, device=None):
        devices.append(device)
        return orig(lk, rk, device)

    monkeypatch.setattr(join_kernels, "device_join_pairs", spy)

    def run(ns):
        cc, bulk = _iteration_plans(ns)
        return cc.collect_batch(), bulk.collect_batch()

    cc, bulk = both(run)
    assert {r["v"]: r["label"] for r in cc.to_rows()} == \
        {0: 0, 1: 0, 2: 0, 3: 3, 4: 3, 5: 5}
    assert sorted((r["v"], r["label"]) for r in bulk.to_rows()) == \
        [(0, 0), (1, 0), (2, 0), (3, 3), (4, 3), (5, 5)]
    assert devices and set(devices) == {"cpu"}
    # the environment's config reaches the superstep's plans too
    from flink_tpu_torch.config.config_option import Configuration
    cfg = Configuration()
    env = ExecutionEnvironment(cfg, device="cpu")
    seen = []
    env.from_columns({"x": [1.0]}).iterate(
        2, lambda ds: (seen.append(ds.env), ds)[1]).collect()
    assert seen and all(e is env and e.config is cfg for e in seen)


def test_out_of_core_sort_and_join_spill_ftb(monkeypatch, lane):
    """Under a small row budget the DataSet sort and join run out of core
    (sorted runs, grace buckets: the port's FTB files, counted in
    ``external.spilled_bytes``) and give JAX's rows."""
    monkeypatch.setenv("FLINK_TPU_BATCH_MEMORY_ROWS", "2000")

    def run(ns):
        rng = np.random.default_rng(8)
        env = ns.env()
        a = env.from_columns({"k": rng.integers(0, 900, 9_000),
                              "v": rng.standard_normal(9_000)})
        b = env.from_columns({"k": np.arange(0, 900, 3),
                              "w": np.arange(300)})
        srt = a.sort_partition("k", ascending=False)
        j = a.join(b).where("k").equal_to("k").apply()
        return (srt.collect_batch(), list(srt.stream_batches()),
                j.collect_batch(), list(j.stream_batches()))

    before = dict(pext.spilled_bytes)
    out = both(run)
    assert pext.spilled_bytes["sort"] > before["sort"]
    assert pext.spilled_bytes["join"] > before["join"]
    assert len(out[2]) == sum(len(b) for b in out[3]) > 0
