"""Port parity for the State Processor API: ``flink_tpu_torch.
state_processor`` (``Savepoint``, ``SavepointReader``, ``SavepointWriter``)
against ``flink_tpu.state_processor`` on the CPU.

- The 8 cases of ``tests/test_state_processor.py`` that need neither the
  MiniCluster nor the queryable tier run through both packages, with equal
  results.  Not mirrored: ``test_minicluster_layout_merges_subtasks``
  (the MiniCluster: ROADMAP Queue A item 8.4) and the two queryable cases
  ``test_queryable_state_live_lookup`` and
  ``test_queryable_lookup_never_inserts`` (item 10).
- Savepoints cross packages: one that JAX's ``SavepointWriter`` writes
  through JAX's file storage, the port's reader reads, and the other way
  round.
- ``read_window_state`` of the port's device-tier and mesh (D = 4 on
  ``["cpu"] * 4``) window operators equals JAX's reader on JAX's operators
  fed the same batches, bit for bit.  The window jobs sum in f32
  (``sum("v", dtype=...)``): the DataStream's default f64 sum is f32 in JAX
  without x64 and f64 in the port, a known difference of the window
  operator, not of the reader.
- A transform of a subtask layout carries unaligned channel state through
  ``state/redistribute.py`` ``redistribute_channel_state``, as JAX's does.
"""

from __future__ import annotations

import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from flink_tpu.core import functions as jfn
from flink_tpu.core.batch import RecordBatch as JaxBatch
from flink_tpu.core.batch import Watermark as JaxWatermark
from flink_tpu.dataset import ExecutionEnvironment as JaxBatchEnv
from flink_tpu.datastream.api import StreamExecutionEnvironment as JaxEnv
from flink_tpu.operators import process as jprocess
from flink_tpu.operators.window_agg import WindowAggOperator as JaxOp
from flink_tpu.runtime.checkpoint import storage as jst
from flink_tpu.state import api as japi
from flink_tpu.state import redistribute as jredist
from flink_tpu.state_processor import Savepoint as JaxSavepoint
from flink_tpu.state_processor import SavepointWriter as JaxWriter
from flink_tpu.windowing import assigners as jwin
from flink_tpu_torch.core import functions as pfn
from flink_tpu_torch.core.batch import RecordBatch, Watermark
from flink_tpu_torch.dataset import ExecutionEnvironment
from flink_tpu_torch.datastream.api import StreamExecutionEnvironment
from flink_tpu_torch.operators import process as pprocess
from flink_tpu_torch.operators.window_agg import WindowAggOperator
from flink_tpu_torch.parallel import mesh as pmesh
from flink_tpu_torch.runtime.checkpoint import storage as pst
from flink_tpu_torch.state import api as papi
from flink_tpu_torch.state import redistribute as predist
from flink_tpu_torch.state_processor import Savepoint, SavepointWriter
from flink_tpu_torch.windowing import assigners as pwin
from test_torch_calibration import verdicts  # noqa: F401 — the fixture
from test_torch_dataset import norm

SIDES = {
    "jax": types.SimpleNamespace(
        name="jax", st=jst, Savepoint=JaxSavepoint, Writer=JaxWriter,
        batch_env=lambda: JaxBatchEnv(), env=lambda: JaxEnv(),
        mesh_env=lambda D: JaxEnv().set_mesh(n_devices=D), win=jwin,
        process=jprocess, api=japi, RB=JaxBatch, redist=jredist,
        f32=jnp.float32, WM=JaxWatermark),
    "port": types.SimpleNamespace(
        name="port", st=pst, Savepoint=Savepoint, Writer=SavepointWriter,
        batch_env=lambda: ExecutionEnvironment(device="cpu"),
        env=lambda: StreamExecutionEnvironment(device="cpu"),
        mesh_env=lambda D: StreamExecutionEnvironment(
            device="cpu", mesh=pmesh.make_mesh(devices=["cpu"] * D)),
        win=pwin, process=pprocess, api=papi, RB=RecordBatch,
        redist=predist, f32=torch.float32, WM=Watermark),
}


@pytest.fixture(autouse=True)
def _pinned(verdicts):  # noqa: F811 — the fixture
    verdicts(taxed=False, shards=1, super_shards=1, depth=1, probe=False)


def both(run, *args):
    out = [run(SIDES[s], *args) for s in ("jax", "port")]
    assert norm(out[0]) == norm(out[1])
    return out[1]


def _run_job_with_savepoint(ns, storage):
    env = ns.env()
    n = 500
    (env.from_collection(columns={"k": np.arange(n) % 7, "v": np.ones(n)})
     .key_by("k").sum("v").collect())
    env.execute(drain=False)
    snap = env._last_executor.trigger_checkpoint(1)
    storage.store(1, snap)
    return snap


def test_read_operator_uids_and_raw():
    def run(ns):
        storage = ns.st.InMemoryCheckpointStorage()
        _run_job_with_savepoint(ns, storage)
        reader = ns.Savepoint.load(storage)
        uids = reader.operator_uids()
        assert uids and isinstance(reader.raw(uids[0]), dict)
        with pytest.raises(ValueError, match="no checkpoint"):
            ns.Savepoint.load(ns.st.InMemoryCheckpointStorage())
        return len(uids), sorted(reader.raw(uids[0]))

    both(run)


def _window_rows(ns, env, n=300):
    keys = np.arange(n) % 5
    vals = np.ones(n, np.float32)
    ts = np.linspace(0, 900, n).astype(np.int64)
    (env.from_collection(columns={"k": keys, "v": vals, "t": ts})
     .assign_timestamps_and_watermarks(0, timestamp_column="t")
     .key_by("k")
     .window(ns.win.TumblingEventTimeWindows.of(10_000))  # never fires
     .sum("v", dtype=ns.f32).collect())
    env.execute(drain=False)
    reader = ns.Savepoint.from_snapshot(
        env._last_executor.trigger_checkpoint(1))

    def rows(uid):
        try:
            return reader.read_window_state(uid).collect_batch()
        except (ValueError, KeyError):
            return None

    return next(r for u in reader.operator_uids()
                if (r := rows(u)) is not None)


def test_read_window_state():
    b = both(lambda ns: _window_rows(ns, ns.env()))
    rows = b.to_rows()
    assert len(rows) == 5
    assert sum(r["acc0"] for r in rows) == pytest.approx(300)
    assert all(r["count"] == 60 for r in rows)


def test_read_window_state_from_mesh_snapshot():
    b = both(lambda ns: _window_rows(ns, ns.mesh_env(4)))
    assert sorted(int(r["count"]) for r in b.to_rows()) == [60] * 5


def test_bootstrap_and_restore_into_job():
    def run(ns):
        seed = ns.batch_env().from_columns(
            {"k": np.array([1, 2, 3]), "total": np.array([100., 200., 300.])})
        writer = ns.Writer.new_savepoint()
        writer.with_keyed_state("my-op", seed, key_column="k",
                                value_column="total", state_name="total")
        storage = ns.st.InMemoryCheckpointStorage()
        writer.write(storage, checkpoint_id=1)
        api = ns.api

        class AddToTotal(ns.process.KeyedProcessFunction):
            def process_batch(self, ctx, batch):
                st = ctx.state(api.ValueStateDescriptor("total", default=0.0))
                cur, _alive = st.get_rows(batch.key_ids)
                vals = np.asarray([0.0 if c is None else float(c)
                                   for c in cur])
                new = vals + np.asarray(batch.column("v"))
                st.put_rows(batch.key_ids, new)
                return [batch.with_columns({"k": batch.column("k"),
                                            "total": new})]

        env = ns.env()
        sink = (env.from_collection(columns={"k": np.array([1, 2, 3]),
                                             "v": np.array([1., 1., 1.])})
                .key_by("k").process(AddToTotal(), name="proc").collect())
        plan = env.get_stream_graph().to_plan()
        proc_uid = next(v.uid for v in plan.vertices if "proc" in v.name)
        snap = storage.load_latest()
        snap[proc_uid] = snap.pop("my-op")
        env.execute(restore=snap)
        got = {r["k"]: r["total"] for r in sink.rows()}
        assert got == {1: 101.0, 2: 201.0, 3: 301.0}
        return got

    both(run)


def _bootstrapped(ns, x=(10., 20.), keys=(1, 2)):
    seed = ns.batch_env().from_columns({"k": np.array(keys),
                                        "x": np.array(x)})
    writer = ns.Writer.new_savepoint()
    writer.with_keyed_state("op", seed, "k", "x", "s")
    return writer


def test_transform_keyed_state():
    def run(ns):
        writer = _bootstrapped(ns)
        writer.transform_keyed_state("op", "s", lambda k, v: v * 2)
        rows = ns.Savepoint.from_snapshot(writer.snapshot) \
            .read_keyed_state("op", "s").collect()
        assert {r["key"]: r["value"] for r in rows} == {1: 20.0, 2: 40.0}
        with pytest.raises(ValueError, match="no heap state"):
            writer.transform_keyed_state("op", "nope", lambda k, v: v)
        return rows

    both(run)


def test_read_source_positions_both_layouts():
    def run(ns):
        r1 = ns.Savepoint.from_snapshot({"__sources__": {"u": {"s": 42}}})
        r2 = ns.Savepoint.from_snapshot(
            {"src": {"subtasks": [{"operator": {}, "source_offset": 7}]}})
        assert r1.operator_uids() == []
        return r1.read_source_positions(), r2.read_source_positions()

    assert both(run) == ({"u": {"s": 42}}, {"src": {"0": 7}})


def test_transform_preserves_timers_field():
    def run(ns):
        writer = _bootstrapped(ns, x=(5.0,), keys=(1,))
        writer.snapshot["op"]["timers"] = {"event": "sentinel"}
        writer.transform_keyed_state("op", "s", lambda k, v: v + 1)
        assert writer.snapshot["op"]["timers"] == {"event": "sentinel"}
        return sorted(writer.snapshot["op"])

    both(run)


def test_transform_does_not_mutate_source_snapshot():
    def run(ns):
        base = _bootstrapped(ns, x=(5.0,), keys=(1,))
        reader = ns.Savepoint.from_snapshot(base.snapshot)
        w2 = ns.Writer.from_existing(reader)
        w2.transform_keyed_state("op", "s", lambda k, v: v * 10)
        orig = reader.read_keyed_state("op", "s").collect()
        new = ns.Savepoint.from_snapshot(w2.snapshot) \
            .read_keyed_state("op", "s").collect()
        assert orig[0]["value"] == 5.0 and new[0]["value"] == 50.0
        w2.remove_operator("op").remove_operator("absent")
        return orig, new, sorted(w2.snapshot)

    both(run)


# ---------------------------------------------------------------------------
# across packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("writer", ["jax", "port"])
def test_savepoint_crosses_packages(tmp_path, writer):
    """A savepoint one package's writer bootstraps and stores through its
    file storage, the other's reader loads and reads to the same rows."""
    reader = "port" if writer == "jax" else "jax"
    w, r = SIDES[writer], SIDES[reader]
    rng = np.random.default_rng(3)
    keys = rng.permutation(1000)[:300].astype(np.int64)
    vals = rng.standard_normal(300)
    sp = _bootstrapped(w, x=vals, keys=keys)
    sp.transform_keyed_state("op", "s", lambda k, v: v + k)
    sp.write(w.st.FileCheckpointStorage(str(tmp_path)), checkpoint_id=3)
    got = r.Savepoint.load(r.st.FileCheckpointStorage(str(tmp_path)), 3) \
        .read_keyed_state("op", "s").collect_batch()
    want = w.Savepoint.from_snapshot(sp.snapshot) \
        .read_keyed_state("op", "s").collect_batch()
    assert norm(got) == norm(want)
    np.testing.assert_array_equal(np.asarray(got.column("value")),
                                  vals + keys)


def _device_op(ns, **kw):
    common = dict(key_column="k", value_column="v", emit_tier="device",
                  snapshot_source="device", device_sync="scatter",
                  native_shards=1, pipeline_depth=0, **kw)
    if ns.name == "jax":
        op = JaxOp(jwin.TumblingEventTimeWindows.of(1000),
                   jfn.SumAggregator(jnp.float32), **common)
        op.open(jfn.RuntimeContext())
        return op
    op = WindowAggOperator(pwin.TumblingEventTimeWindows.of(1000),
                           pfn.SumAggregator(torch.float32), device="cpu",
                           **common)
    op.open(pfn.RuntimeContext())
    return op


def _stream(n_batches=5, seed=12):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 2000, 800).astype(np.int64),
             rng.standard_normal(800).astype(np.float32),
             (i * 300 + np.sort(rng.integers(0, 300, 800))).astype(np.int64))
            for i in range(n_batches)]


def test_read_window_state_of_the_device_tier_equals_jax():
    """The device-tier operator's snapshot inside a window (window 0 fired
    and purged, window 1 open) reads, through each package's reader, to
    the same rows; ``group_by("key").sum("acc0")`` is the open window's f32
    record-order sum, bit for bit."""
    stream = _stream()

    def run(ns):
        op = _device_op(ns)
        for keys, vals, ts in stream:
            op.process_batch(ns.RB({"k": keys, "v": vals}, timestamps=ts))
        fired = op.process_watermark(ns.WM(999))
        snap = op.snapshot_state()
        ds = ns.Savepoint.from_snapshot({"win": snap}) \
            .read_window_state("win")
        return (ds.collect_batch(), ds.group_by("key").sum("acc0")
                .collect_batch(), sum(len(b) for b in fired))

    rows, sums, n_fired = both(run)
    want = {}
    for keys, vals, ts in stream:
        for k, v in zip(keys[ts >= 1000].tolist(), vals[ts >= 1000]):
            want[k] = np.float32(want.get(k, np.float32(0)) + v)
    assert n_fired > 0 and set(np.asarray(rows.column("pane"))) == {1}
    got = dict(zip(np.asarray(sums.column("key")).tolist(),
                   np.asarray(sums.column("acc0"))))
    assert got.keys() == want.keys()
    assert all(got[k].tobytes() == want[k].tobytes() for k in want)


def test_read_window_state_of_the_mesh_equals_jax():
    """A 4-block mesh snapshot (per-shard slices and their key-group
    manifest) densifies and reads to JAX's rows bit for bit."""
    stream = _stream(n_batches=4, seed=21)

    def run(ns):
        env = ns.mesh_env(4)
        cols = {"k": np.concatenate([s[0] for s in stream]),
                "v": np.concatenate([s[1] for s in stream]),
                "t": np.concatenate([s[2] for s in stream])}
        (env.from_collection(columns=cols, batch_size=800)
         .assign_timestamps_and_watermarks(0, timestamp_column="t")
         .key_by("k").window(ns.win.TumblingEventTimeWindows.of(100_000))
         .sum("v", dtype=ns.f32).collect())
        env.execute(drain=False)
        reader = ns.Savepoint.from_snapshot(
            env._last_executor.trigger_checkpoint(1))
        for uid in reader.operator_uids():
            try:
                return reader.read_window_state(uid).collect_batch()
            except (ValueError, KeyError):
                continue
        raise AssertionError("no window state")

    b = both(run)
    assert int(np.asarray(b.column("count")).sum()) == 3200


def test_transform_carries_channel_state_as_jax():
    """A subtask-layout transform redistributes unaligned channel state to
    one logical subtask (``redistribute_channel_state``); a legacy v1
    section with elements is refused, in both packages."""
    def run(ns):
        w = _bootstrapped(ns)
        member = w.snapshot.pop("op")
        el = ns.RB({"k": np.arange(6, dtype=np.int64),
                    "v": np.arange(6, dtype=np.float64)})
        cs = {"version": 2, "elements": [(0, el)], "unaligned": True,
              "alignment_ms": 1.5, "overtaken_bytes": 96,
              "inputs": [{"key_column": "k", "partitioning": "hash",
                          "max_parallelism": 128, "logical": 0}]}
        w.snapshot["op"] = {"subtasks": [{"operator": member,
                                          "channel_state": cs}]}
        w.transform_keyed_state("op", "s", lambda k, v: v + 1)
        sub = w.snapshot["op"]["subtasks"][0]
        out = dict(sub["channel_state"])
        out["elements"] = [(p, e.to_rows()) for p, e in out["elements"]]
        split = ns.redist.redistribute_channel_state([cs, None], 3)
        bad = dict(cs, version=1)
        with pytest.raises(ns.redist.ChannelStateRescaleError):
            ns.redist.redistribute_channel_state([bad], 2)
        with pytest.raises(ns.redist.ChannelStateRescaleError):
            ns.redist.reject_channel_state(
                {"op": {"subtasks": [{"channel_state": cs}]}}, "merge")
        return out, [[(p, e.to_rows()) for p, e in s["elements"]]
                     for s in split], [s["persisted_bytes"] for s in split]

    out, split, persisted = both(run)
    assert out["unaligned"] and sum(len(r) for _, r in out["elements"]) == 6
    assert sum(len(r) for s in split for _, r in s) == 6
