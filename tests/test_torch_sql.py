"""Port parity for the SQL stack, beside the reference cases run through
both packages (``tests/test_torch_sql_cases.py``).

What this file holds, JAX against the port on the same numpy inputs:

- the parser: every statement the reference's SQL tests write parses to
  the same AST in both packages, or fails with the same error;
- ``_CompositeKeyHasher``: the same int64 hashes, side table and split-back
  components for the same columns, negative, extreme and float-as-bits
  lanes included, and the same collision refusals;
- ``_agg_dtype``: SQL aggregates accumulate in float32 in both packages;
- every numpy operator of ``operators/sql_ops.py`` driven alone (process,
  watermark, end of input, snapshot), its snapshots restored across the
  packages both ways;
- the entry points: ``TableEnvironment()`` needs the card or
  ``device="cpu"``, and every environment it plans onto gets its device;
- the reference cases that cannot run through both packages as written:
  the changelog aggregate's state is a ``torch.Tensor`` on its device where
  JAX's is a ``jax.Array``, and the MiniCluster's count distinct;
- ``tests/test_cep_vectorized.py::test_match_recognize_threads_vectorized_mode``;
- the exact SQL of the smoke's paths 48 and 50 (``chip_smoke.py``) at a
  small size: config 5 at 2^14 rows, TPC-H Q3 at SF 0.01.

Values compare bit for bit: both packages run the same float32 folds on
the CPU.  The one tolerance is the smoke's own check of Q3's revenue
against the f64 numpy model (each group's n f32 terms and n - 1 adds:
within 2 n 2^-24).
"""

import ast
import sys

import numpy as np
import pytest
import torch

from flink_tpu.operators import sql_ops as jops
from flink_tpu.sql import parser as jparser
from flink_tpu.sql import planner as jplanner
from flink_tpu.sql import table_env as jtable
from flink_tpu.core import batch as jbatch
from flink_tpu.state import keyindex as jkeyindex
from flink_tpu_torch.operators import sql_ops as pops
from flink_tpu_torch.sql import parser as pparser
from flink_tpu_torch.sql import planner as pplanner
from flink_tpu_torch.sql import table_env as ptable
from flink_tpu_torch.core import batch as pbatch
from flink_tpu_torch.state import keyindex as pkeyindex
from test_torch_calibration import verdicts  # noqa: F401 — the fixture
from test_torch_sql_cases import REFERENCE_FILES, TESTS, plain

REPO = TESTS.parent
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402 — the smoke's SQL text and inputs

SIDES = {
    "jax": dict(ops=jops, batch=jbatch, planner=jplanner,
                tenv=lambda **kw: jtable.TableEnvironment(**kw)),
    "port": dict(ops=pops, batch=pbatch, planner=pplanner,
                 tenv=lambda **kw: ptable.TableEnvironment(device="cpu",
                                                           **kw)),
}


@pytest.fixture(autouse=True)
def _pinned(verdicts):  # noqa: F811 — the fixture
    verdicts(taxed=False, shards=1, super_shards=1, depth=1, probe=False)


def both(scenario, *args):
    """``scenario(S, *args)`` through each package; the results must be
    equal (floats bit for bit).  Returns the port's."""
    want = scenario(SIDES["jax"], *args)
    got = scenario(SIDES["port"], *args)
    assert plain(got) == plain(want)
    return got


# ---------------------------------------------------------------------------
# the parser: the reference tests' statements
# ---------------------------------------------------------------------------

_KEYWORDS = ("SELECT", "CREATE", "DROP", "SHOW", "DESCRIBE", "DESC",
             "INSERT", "EXPLAIN", "WITH")


def _statements():
    """Every string literal of the reference SQL tests (implicit
    concatenations joined) that starts like a statement."""
    seen = {}
    for ref in REFERENCE_FILES + ("test_cep_vectorized",):
        tree = ast.parse((TESTS / f"{ref}.py").read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Constant) and isinstance(node.value,
                                                             str):
                text = node.value.strip()
                head = text.split(None, 1)[0].upper() if text else ""
                if head in _KEYWORDS and len(text) > len(head):
                    seen.setdefault(text, f"{ref}:{node.lineno}")
    return sorted(seen.items(), key=lambda kv: kv[1])


STATEMENTS = _statements()


def _parsed(parser, sql):
    try:
        return ("ok", repr(parser.parse_any(sql)))
    except Exception as e:  # noqa: BLE001 — the error is the result
        return ("raises", type(e).__name__, str(e))


def test_the_corpus_is_the_reference_tests_statements():
    assert len(STATEMENTS) > 150
    assert any(s.startswith("CREATE TABLE") for s, _ in STATEMENTS)
    assert any("MATCH_RECOGNIZE" in s for s, _ in STATEMENTS)


@pytest.mark.parametrize("sql", [s for s, _ in STATEMENTS],
                         ids=[where for _, where in STATEMENTS])
def test_parser_ast_equals_jax(sql):
    got, want = _parsed(pparser, sql), _parsed(jparser, sql)
    assert got == want


@pytest.mark.parametrize("sql", [
    "SELECT FROM t", "SELECT a FROM", "SELECT a FROM t WHERE",
    "SELECT a FROM t GROUP BY", "SELECT a b c FROM t",
    "SELECT a FROM t ORDER BY a LIMIT x", "CREATE TABLE t (a)",
    "SELECT SUM( FROM t", "SELECT a FROM t MATCH_RECOGNIZE (PATTERN (A)",
    "SELECT 'unterminated FROM t", "DROP", "SELECT * FROM t LIMIT -1"])
def test_parse_errors_equal_jax(sql):
    got, want = _parsed(pparser, sql), _parsed(jparser, sql)
    assert got == want and got[0] == "raises"


# ---------------------------------------------------------------------------
# _CompositeKeyHasher: the GROUP BY / merge key's int64 hash
# ---------------------------------------------------------------------------

I64 = np.iinfo(np.int64)


def _key_columns(rng, n):
    return [
        np.concatenate([[I64.min, I64.max, -1, 0],
                        rng.integers(-5, 5, n - 4)]).astype(np.int64),
        np.concatenate([[-0.0, 0.0, np.nan, -np.inf],
                        np.round(rng.normal(size=n - 4), 1)]),
        rng.integers(0, 3, n).astype(np.int32),
        rng.random(n) < 0.5,
        np.concatenate([[np.float32(np.nan), np.float32(-0.0),
                         np.float32(3.5), np.float32(np.inf)],
                        rng.integers(0, 4, n - 4).astype(np.float32)]),
    ]


@pytest.mark.parametrize("width", [2, 3, 5])
def test_composite_key_hashes_equal_jax(width):
    rng = np.random.default_rng(width)
    hashers = {s: SIDES[s]["planner"]._CompositeKeyHasher(
        keep_components=True) for s in SIDES}
    for batch in range(3):
        parts = _key_columns(rng, 256)[:width]
        out = {s: h.combine(parts, 256) for s, h in hashers.items()}
        assert out["port"].dtype == np.int64
        assert np.array_equal(out["port"], out["jax"])
        nan_payload = parts[1].copy() if width > 1 else None
        if nan_payload is not None:
            # a NaN's payload bits do not split its group
            nan_payload[2] = np.frombuffer(
                np.uint64(0x7FF8000000000001).tobytes(), np.float64)[0]
            assert np.array_equal(
                hashers["port"].combine([parts[0], nan_payload]
                                        + parts[2:], 256), out["port"])
    hp, hj = hashers["port"], hashers["jax"]
    assert np.array_equal(hp._known, hj._known)
    assert all(np.array_equal(a, b) for a, b in zip(hp._sigs, hj._sigs))
    probe = rng.choice(hp._known, 64)
    for a, b in zip(hp.components(probe), hj.components(probe)):
        assert a.dtype == b.dtype
        assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f")
    with pytest.raises(KeyError):
        hp.components(np.asarray([12345], np.int64))


def test_composite_key_hasher_refusals_equal_jax(monkeypatch):
    """A numeric key that turns into strings, and a genuine collision (the
    mixer weakened in both packages), raise the same errors."""
    def run(S):
        h = S["planner"]._CompositeKeyHasher()
        a = np.arange(4, dtype=np.int64)
        out = [plain(h.combine([a, a], 4))]
        try:
            h.combine([a, np.asarray(list("abcd"), object)], 4)
        except S["planner"].KeyHashCollisionError as e:
            out.append(str(e))
        t = S["planner"]._CompositeKeyHasher()
        out.append(t.combine([np.asarray(list("ab"), object), a[:2]], 2))
        return out
    both(run)
    weak = lambda x: np.asarray(x, np.uint64) & np.uint64(3)  # noqa: E731
    monkeypatch.setattr(jkeyindex, "_mix64", weak)
    monkeypatch.setattr(pkeyindex, "_mix64", weak)

    def collide(S):
        h = S["planner"]._CompositeKeyHasher()
        a = np.arange(16, dtype=np.int64)
        with pytest.raises(S["planner"].KeyHashCollisionError) as e:
            h.combine([a, a * 7], 16)
        return str(e.value)
    both(collide)


# ---------------------------------------------------------------------------
# float32 accumulators
# ---------------------------------------------------------------------------

def test_sql_aggregates_accumulate_in_float32():
    """JAX picks f64 only under ``jax_enable_x64`` (off, its default); the
    port has no such switch and takes f32."""
    import jax.numpy as jnp
    assert pplanner._agg_dtype() is torch.float32
    assert jplanner._agg_dtype() == jnp.float32
    for func in ("SUM", "AVG", "MIN", "MAX"):
        spec = pplanner.AggSpec("__agg0", func, None)
        assert pplanner._make_aggregator(spec, "v")._dtype is torch.float32

    def run(S):
        te = S["tenv"]()
        te.register_collection("t", columns={
            "k": np.zeros(3, np.int64), "v": np.asarray([1e8, 1.0, 1.0])})
        return te.execute_sql("SELECT k, SUM(v) AS s FROM t "
                              "GROUP BY k").collect()
    rows = both(run)
    assert rows[0]["s"] == float(np.float32(1e8))   # the 1.0s round away


# ---------------------------------------------------------------------------
# the numpy operators of sql_ops, alone, snapshots across the packages
# ---------------------------------------------------------------------------

def _b(S, cols, ts=None):
    return S["batch"].RecordBatch(
        {k: np.asarray(v) for k, v in cols.items()},
        timestamps=None if ts is None else np.asarray(ts, np.int64))


def _wm(S, t):
    return S["batch"].Watermark(t)


def _lookup(S):
    dim = {1: [{"id": 1, "label": "ant"}], 2: [{"id": 2, "label": "bee"},
                                              {"id": 2, "label": "bug"}],
           "x": [{"id": "x", "label": "ex"}]}
    calls = []

    def fn(key):
        calls.append(key)
        return dim.get(key, [])
    op = S["ops"].LookupJoinOperator("pid", fn, ["label"],
                                     right_rename={"label": "lbl"},
                                     how="left", max_cache_rows=2)
    return op, calls


def _lookup_steps(S, op, calls):
    return [op.process_batch(_b(S, {"pid": [2, 1, 9, 2], "q": [4, 5, 6, 7]})),
            op.process_batch(_b(S, {"pid": [1, 3], "q": [1, 2]})),
            op.process_batch(_b(S, {"pid": np.asarray(["x", "y"], object),
                                    "q": [8, 9]})),
            (op.cache_hits, op.cache_misses, list(calls))]


def _temporal(S):
    return S["ops"].TemporalJoinOperator(
        "cur", "cur", "t", "vt", ["rate"], how="left")


def _temporal_steps(S, op, half):
    steps = [
        lambda: op.process_batch2(_b(S, {"cur": ["e", "e", "u"],
                                         "vt": [0, 10, 5],
                                         "rate": [1.0, 1.5, 0.9]}), 1),
        lambda: op.process_batch2(_b(S, {"cur": ["e", "u", "e", "g"],
                                         "t": [3, 7, 12, 4],
                                         "q": [1, 2, 3, 4]}), 0),
        lambda: op.process_watermark(_wm(S, 8)),
        lambda: op.process_batch2(_b(S, {"cur": ["u"], "vt": [6],
                                         "rate": [0.8]}), 1),
        lambda: op.process_batch2(_b(S, {"cur": ["u", "e"], "t": [9, 20],
                                         "q": [5, 6]}), 0),
        lambda: op.process_watermark(_wm(S, 15)),
        lambda: op.end_input(),
    ]
    return steps[:half] if half is not None else steps


def _rows_over(S, n, seed):
    rng = np.random.default_rng(seed)
    return _b(S, {"p": rng.integers(0, 3, n).astype(np.int64),
                  "v": np.round(rng.random(n) * 10, 2),
                  "k": rng.integers(0, 5, n).astype(np.int64)},
              ts=np.sort(rng.integers(0, 50, n)) + 50 * seed)


def _batches(S, op, n, rows, wm=None):
    """Steps feeding ``n`` of :func:`_rows_over`'s batches (each followed by
    a watermark at ``wm(i)`` when given), then the end of input."""
    steps = []
    for i in range(n):
        steps.append(lambda i=i: op.process_batch(_rows_over(S, rows, i)))
        if wm is not None:
            steps.append(lambda i=i: op.process_watermark(_wm(S, wm(i))))
    return steps + [op.end_input]


#: name -> (make(S), steps(S, op): the calls, in order, as thunks)
OPERATORS = {
    "top-n": (lambda S: S["ops"].TopNOperator(2, "p", "v"),
              lambda S, op: _batches(S, op, 3, 12)),
    "top-n-global-ascending": (
        lambda S: S["ops"].TopNOperator(3, None, "v", ascending=True),
        lambda S, op: _batches(S, op, 3, 9)),
    "deduplicate-first": (
        lambda S: S["ops"].DeduplicateOperator("k"),
        lambda S, op: _batches(S, op, 3, 10)),
    "deduplicate-last-ordered": (
        lambda S: S["ops"].DeduplicateOperator("k", keep="last",
                                               order_column="v"),
        lambda S, op: _batches(S, op, 3, 10)),
    "deduplicate-last-object-keys": (
        lambda S: S["ops"].DeduplicateOperator("s", keep="last"),
        lambda S, op: [lambda i=i: op.process_batch(_b(S, {
            "s": np.asarray(["a", "b", "a", "c"][i:] + ["b"] * i, object),
            "v": np.arange(4) + 10 * i})) for i in range(3)]
        + [op.end_input]),
    "sort-limit": (
        lambda S: S["ops"].SortLimitOperator([("p", True), ("v", False)], 7),
        lambda S, op: _batches(S, op, 3, 8)),
    "mini-batch": (
        lambda S: S["ops"].MiniBatchOperator(20),
        lambda S, op: _batches(S, op, 4, 8, wm=lambda i: 50 * i - 10)),
    "over-rows-and-range": (
        lambda S: S["ops"].OverAggregateOperator(
            [S["ops"].OverAggSpec("s", "SUM", "v"),
             S["ops"].OverAggSpec("r2", "SUM", "v", rows=1),
             S["ops"].OverAggSpec("mx", "MAX", "v", range_ms=20),
             S["ops"].OverAggSpec("n", "COUNT", None, is_rows=True),
             S["ops"].OverAggSpec("rn", "ROW_NUMBER", None),
             S["ops"].OverAggSpec("dv", "SUM", "k", distinct=True)], "p"),
        lambda S, op: _batches(S, op, 3, 10, wm=lambda i: 50 * i + 30)),
    "over-arrival-order": (
        lambda S: S["ops"].OverAggregateOperator(
            [S["ops"].OverAggSpec("s", "SUM", "v"),
             S["ops"].OverAggSpec("a", "AVG", "v", rows=2)], None,
            event_time=False),
        lambda S, op: _batches(S, op, 3, 6)),
    "hop-expand": (
        lambda S: S["ops"].HopWindowExpandOperator(60, 25),
        lambda S, op: _batches(S, op, 2, 6)),
    "branch-merge": (
        lambda S: S["ops"].BranchMergeOperator("__merge", ["d"]),
        lambda S, op: [
            lambda: op.process_batch2(_b(S, {"__merge": [1, 2, 3],
                                             "s": [1., 2., 3.]}), 0),
            lambda: op.process_batch2(_b(S, {"__merge": [3, 1],
                                             "d": [30, 10]}), 1),
            lambda: op.process_batch2(_b(S, {"__merge": [4, 2],
                                             "d": [40, 20]}), 1),
            lambda: op.process_batch2(_b(S, {"__merge": [4], "s": [4.]}),
                                      0)]),
}


def _run_op(name, first, second=None, cut=None):
    """Operator ``name``'s steps in package ``first``; with ``cut``, the
    snapshot after the first ``cut`` steps restores into a fresh operator
    of package ``second``, which runs the rest.  (outputs, the snapshot)"""
    make, steps = OPERATORS[name]
    S1 = SIDES[first]
    op = make(S1)
    thunks = steps(S1, op)
    if cut is None:
        return [t() for t in thunks], None
    outs = [t() for t in thunks[:cut]]
    snap = op.snapshot_state()
    S2 = SIDES[second]
    op2 = make(S2)
    op2.restore_state(snap)
    return outs + [t() for t in steps(S2, op2)[cut:]], snap


@pytest.mark.parametrize("name", sorted(OPERATORS))
def test_operator_alone_equals_jax(name):
    got, want = _run_op(name, "port")[0], _run_op(name, "jax")[0]
    assert plain(got) == plain(want)
    assert any(o for o in got)


@pytest.mark.parametrize("name", sorted(OPERATORS))
@pytest.mark.parametrize("first,second", [("jax", "port"), ("port", "jax")])
def test_operator_snapshot_restores_across_packages(name, first, second):
    """The snapshot after the first half of the steps, taken in one
    package, restores in the other: the whole run equals an uninterrupted
    one, and the snapshot equals the other package's at the same point."""
    whole, _ = _run_op(name, "jax")
    cut = max(1, len(whole) // 2)
    got, snap = _run_op(name, first, second, cut)
    _, other_snap = _run_op(name, second, second, cut)
    assert plain(got) == plain(whole)
    assert plain(snap) == plain(other_snap)


def test_lookup_join_alone_equals_jax():
    """The cache is not state: the snapshot is empty and a restore clears
    it (the dimension is probed again), in both packages."""
    def run(S):
        op, calls = _lookup(S)
        out = _lookup_steps(S, op, calls)
        snap = op.snapshot_state()
        op.restore_state(snap)
        out.append((snap, op.process_batch(_b(S, {"pid": [1], "q": [0]})),
                    op.cache_misses))
        return out
    out = both(run)
    assert out[-1][0] == {} and out[-1][2] == 7   # 6 misses, 1 after


@pytest.mark.parametrize("first,second", [("jax", "port"), ("port", "jax"),
                                          ("port", "port")])
def test_temporal_join_snapshot_restores_across_packages(first, second):
    S1, S2 = SIDES[first], SIDES[second]
    whole = [t() for t in _temporal_steps(SIDES["jax"],
                                          _temporal(SIDES["jax"]), None)]
    op1 = _temporal(S1)
    outs = [t() for t in _temporal_steps(S1, op1, 3)]
    snap = op1.snapshot_state()
    op2 = _temporal(S2)
    op2.restore_state(snap)
    outs += [t() for t in _temporal_steps(S2, op2, None)[3:]]
    assert plain(outs) == plain(whole)
    assert any(o for o in whole)


# ---------------------------------------------------------------------------
# entry points: the device
# ---------------------------------------------------------------------------

def test_table_environment_needs_the_card_or_the_cpu(monkeypatch):
    """``TableEnvironment()`` resolves its device at once: without a card
    it raises; ``device="cpu"`` goes to every environment it plans onto
    (queries, views' dry runs, EXPLAIN, DDL views)."""
    from flink_tpu_torch.datastream import api as pds
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ptable.TableEnvironment()
    built = []
    orig = pds.StreamExecutionEnvironment.__init__

    def record(self, *args, **kwargs):
        orig(self, *args, **kwargs)
        built.append(self.device)
    monkeypatch.setattr(pds.StreamExecutionEnvironment, "__init__", record)
    te = ptable.TableEnvironment(device="cpu")
    assert te.device == torch.device("cpu")
    te.register_collection("t", columns={"k": np.arange(4, dtype=np.int64),
                                         "v": np.ones(4)})
    te.create_temporary_view("v1", te.sql_query("SELECT k, v FROM t"))
    te.execute_sql("CREATE VIEW v2 AS SELECT k FROM t")
    te.explain_sql("SELECT k FROM v1")
    rows = te.execute_sql("SELECT k, SUM(v) AS s FROM v1 GROUP BY k")
    assert len(rows.collect()) == 4 and rows.env.device == torch.device("cpu")
    assert len(built) == 4 and set(built) == {torch.device("cpu")}


# ---------------------------------------------------------------------------
# reference cases with counterparts of their own
# ---------------------------------------------------------------------------

def test_changelog_agg_device_state_and_snapshot_roundtrip():
    """``test_sql_advanced.py``'s case: the state is a ``torch.Tensor`` on
    the operator's device (JAX's a ``jax.Array``); the rows, the snapshot
    and the rows after a restore equal JAX's."""
    import jax
    aggs = {"s": ("v", "sum"), "mn": ("v", "min"), "mx": ("v", "max"),
            "n": (None, "count")}

    def run(S):
        kw = {} if S is SIDES["jax"] else {"device": "cpu"}
        op = S["ops"].ChangelogGroupAggOperator("k", aggs, **kw)
        out = op.process_batch(_b(S, {"k": np.array([1, 2, 1], np.int64),
                                      "v": np.array([3., 5., 7.])}))
        if S is SIDES["jax"]:
            assert isinstance(op._state[0], jax.Array)
        else:
            assert isinstance(op._state[0], torch.Tensor)
            assert op._state[0].device == op.device == torch.device("cpu")
        snap = op.snapshot_state()
        op2 = S["ops"].ChangelogGroupAggOperator("k", aggs, **kw)
        op2.restore_state(snap)
        out2 = op2.process_batch(_b(S, {"k": np.array([1], np.int64),
                                        "v": np.array([1.])}))
        return out, out2
    out, out2 = both(run)
    rows = {r["k"]: r for b in out for r in b.to_rows()}
    assert rows[1]["s"] == 10.0 and rows[1]["mn"] == 3.0
    rows2 = [r for b in out2 for r in b.to_rows()]
    assert [r["op"] for r in rows2] == ["-U", "+U"]
    assert rows2[1]["s"] == 11.0 and rows2[1]["mn"] == 1.0


def test_count_distinct_parallel_cluster_waits_for_the_cluster_runtime():
    """``test_sql_advanced.py``'s MiniCluster case.  The name is from when
    the cluster runtime was missing; it came with the checkpoint slice.
    The DISTINCT stage hash-routes by the (key, value) pair, so the two
    subtasks of the MiniCluster count the duplicate once, in both
    packages."""
    def run(table_mod, **kw):
        te = table_mod.TableEnvironment(parallelism=2, **kw)
        te.register_collection("t", columns={
            "k": np.ones(8, np.int64), "v": np.full(8, 5.0)}, batch_size=1)
        table = te.sql_query(
            "SELECT k, COUNT(DISTINCT v) AS n FROM t GROUP BY k")
        env, plan = te._plan(table._stmt)
        sink = plan.stream.collect()
        assert env.execute_cluster(timeout_s=60).state == "FINISHED"
        rows = sink.rows()
        final = {r["k"]: r["__agg0"] for r in rows if "__agg0" in r} \
            or {r["k"]: r["n"] for r in rows}
        return {int(k): float(v) for k, v in final.items()}

    assert run(ptable, device="cpu") == run(jtable) == {1: 1.0}


@pytest.mark.parametrize("connector", ["postgres", "jdbc"])
def test_postgres_and_jdbc_ddl_on_both_packages(connector, tmp_path):
    """A source and a sink table of ``'connector' = 'postgres'`` or
    ``'jdbc'`` (the same branch) over one Postgres wire server with md5
    authentication: each package's ``INSERT INTO ... SELECT`` with a
    ``TUMBLE`` sum writes the same rows, each registers both tables in its
    persisted catalog, and each reads the other's result table back."""
    from flink_tpu.connectors import postgres as jpg
    from flink_tpu_torch.connectors import postgres as ppg
    rng = np.random.default_rng(24)
    k = rng.integers(0, 40, 600)
    v = rng.integers(0, 1000, 600) / 8.0
    ts = np.sort(rng.integers(0, 20_000, 600))
    srv = ppg.PostgresWireServer(users={"u": "pw"})
    try:
        with jpg.PostgresWireClient(srv.host, srv.port, user="u",
                                    password="pw") as c:
            c.execute("CREATE TABLE ev (k int8, v float8, ts int8)")
            c.execute("INSERT INTO ev (k, v, ts) VALUES " + ", ".join(
                f"({a}, {b}, {t})" for a, b, t in zip(k, v, ts)))
            for side in ("jax", "port"):
                c.execute(f"CREATE TABLE out_{side} (k int8, ws int8, "
                          f"s float8)")
        where = (f"'connector' = '{connector}', 'hostname' = '{srv.host}', "
                 f"'port' = '{srv.port}', 'username' = 'u', "
                 f"'password' = 'pw'")
        got = {}
        for side, mod in (("jax", jtable), ("port", ptable)):
            kw = {"device": "cpu"} if side == "port" else {}
            te = mod.TableEnvironment(catalog_dir=str(tmp_path / side), **kw)
            te.execute_sql(
                "CREATE TABLE ev (k BIGINT, v DOUBLE, ts BIGINT, "
                "WATERMARK FOR ts AS ts - INTERVAL '0' SECOND) WITH ("
                f"{where}, 'table-name' = 'ev', "
                "'scan.partition.column' = 'k')")
            te.execute_sql(f"CREATE TABLE res (k BIGINT, ws BIGINT, s DOUBLE)"
                           f" WITH ({where}, 'table-name' = 'out_{side}')")
            assert [r["table name"] for r in
                    te.execute_sql("SHOW TABLES").collect()] == ["ev", "res"]
            n = te.execute_sql(
                "INSERT INTO res SELECT k, TUMBLE_START(ts, INTERVAL '5' "
                "SECOND) AS ws, SUM(v) AS s FROM ev "
                "GROUP BY k, TUMBLE(ts, INTERVAL '5' SECOND)").collect()
            got[side] = n[0]["rows_written"]
        reads = {}
        for side, other, mod in (("jax", "port", jpg), ("port", "jax", ppg)):
            with mod.PostgresWireClient(srv.host, srv.port, user="u",
                                        password="pw") as c:
                cols = c.query_columns(f"SELECT k, ws, s FROM out_{other}")
            reads[other] = sorted(zip(cols["k"].tolist(),
                                      cols["ws"].tolist(),
                                      cols["s"].tolist()))
    finally:
        srv.close()
    assert got["jax"] == got["port"] == len(reads["jax"]) > 0
    assert reads["jax"] == reads["port"]
    want = {}
    for a, b, t in zip(k.tolist(), v.tolist(), ts.tolist()):
        key = (a, t // 5000 * 5000)
        want[key] = want.get(key, 0.0) + b
    assert {(a, w): s for a, w, s in reads["port"]} == want


def test_match_recognize_threads_vectorized_mode():
    """``test_cep_vectorized.py``'s case through both packages: the
    planner threads ``cep_vectorized`` into the CEP operator; deferred
    conditions keep MATCH_RECOGNIZE on the interpreted engine, and "on"
    raises the same refusal."""
    cols = {"k": np.asarray([1, 1, 1], np.int64),
            "v": np.asarray([1.0, 9.0, 2.0]),
            "ts": np.asarray([1, 2, 3], np.int64)}
    sql = ("SELECT k, n FROM t MATCH_RECOGNIZE (PARTITION BY k ORDER BY ts "
           "MEASURES COUNT(*) AS n AFTER MATCH SKIP PAST LAST ROW "
           "PATTERN (A B) DEFINE A AS v < 5, B AS v > 5)")

    def run(S, mode):
        te = S["tenv"](cep_vectorized=mode)
        te.register_collection("t", columns=cols, rowtime="ts")
        try:
            res = te.execute_sql(sql)
            rows = res.collect()
        except ValueError as e:
            return ("raises", str(e))
        ops = [m for rv in res.env._last_executor.running.values()
               for m in getattr(rv.operator, "operators", [rv.operator])]
        engine = [m.cep_stats()["engine"] for m in ops
                  if hasattr(m, "cep_stats")]
        return rows, engine
    rows, engine = both(run, "auto")
    assert len(rows) == 1 and int(rows[0]["n"]) == 2
    assert engine == ["interpreted"]
    assert both(run, "off")[1] == ["interpreted"]
    refused = both(run, "on")
    assert refused[0] == "raises" and "not eligible" in refused[1]


# ---------------------------------------------------------------------------
# the smoke's SQL (paths 48 and 50) at a small size
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("query", ["tumble", "hop"])
def test_config5_sql_of_path_48_equals_jax(query):
    """Path 48's query text and input (``bench.py`` config 5) at 2^14 rows:
    the port's rows equal JAX's bit for bit and pass the smoke's check
    against the f64 numpy model."""
    sql = {"tumble": chip_smoke.CONFIG5_TUMBLE_SQL,
           "hop": chip_smoke.CONFIG5_HOP_SQL}[query]
    cols = chip_smoke.lineitem(1 << 14)

    def run(S):
        te = S["tenv"]()
        te.register_collection("lineitem", columns=cols, rowtime="ts",
                               batch_size=1 << 11)
        return te.execute_sql(sql).collect()
    rows = both(run)
    hop = query == "hop"
    worst = chip_smoke.check_config5(f"config 5 {query}", rows,
                                     chip_smoke.config5_model(cols, hop), hop)
    assert 0 < worst <= 1


def test_tpch_q3_sql_of_path_50_equals_jax(monkeypatch):
    """Path 50's Q3 text at SF 0.01, the joins' device lane on (on the
    CPU): the port's rows equal JAX's bit for bit and the numpy model's top
    10, revenue within 2 n 2^-24."""
    monkeypatch.setenv("FLINK_TPU_DEVICE_JOIN", "1")
    tables = chip_smoke.make_tpch(sf=0.01)

    def run(S):
        te = S["tenv"]()
        for name, cols in tables.items():
            te.register_collection(name, columns=cols, batch_size=1 << 13)
        return te.execute_sql(chip_smoke.Q3_SQL).collect()
    chip_smoke.check_q3_rows("Q3", both(run), tables)


def test_match_recognize_of_path_50b_equals_jax(monkeypatch):
    """Path 50b's MATCH_RECOGNIZE on a small slice of the CEP stream: the
    same matches in both packages, on the interpreted engine."""
    monkeypatch.setattr(chip_smoke, "CEP_RECORDS", 1 << 14)
    monkeypatch.setattr(chip_smoke, "CEP_BATCH", 1 << 14)
    monkeypatch.setattr(chip_smoke, "CEP_KEYS", 3000)
    k, v, ts = chip_smoke.make_cep_batches()[0]
    cols = {"k": k, "v": v, "ts": ts, "e": np.arange(k.size, dtype=np.int64)}

    def run(S):
        te = S["tenv"]()
        te.register_collection("events", columns=cols, rowtime="ts",
                               batch_size=1 << 14)
        return te.execute_sql(chip_smoke.MATCH_SQL).collect()
    rows = both(run)
    assert rows and all(r["a_e"] < r["b_e"] for r in rows)
    assert all(v[r["a_e"]] < 30 and v[r["b_e"]] > 570 for r in rows)
