"""Port parity for the keyed process path: ``flink_tpu_torch.runtime.timers``
and ``flink_tpu_torch.operators.process`` against ``flink_tpu``'s on the
CPU.

Every case of ``tests/test_process.py`` runs on both packages with the same
numpy batches, through a small harness (:class:`Harness`, the shape of
JAX's ``KeyedOneInputOperatorHarness``): the timers fired, every emitted
batch (columns, dtypes, timestamps, order) and every snapshot tree must be
equal bit for bit.  Operator snapshots (keyed state plus timers on raw
keys) restore across the packages both ways, split and merge for rescales
through each package's ``state/redistribute.py``, and run over the
changelog backend, whose incremental branch runs under
``snapshot_scope(cid, incremental=True)``.

Left out, with the modules they need (ROADMAP item 8):
``test_process_in_datastream_pipeline`` (the DataStream API) and
``test_executor_fires_processing_time_timers`` (the executor); the
processing-time timer itself is driven here through
``on_processing_time``.
"""

import numpy as np
import pytest

from flink_tpu.core import batch as jbatch
from flink_tpu.core import functions as jfn
from flink_tpu.operators import base as jbase
from flink_tpu.operators import process as jprocess
from flink_tpu.runtime import timers as jtimers
from flink_tpu.state import api as japi
from flink_tpu.state import changelog as jchangelog
from flink_tpu.state import heap as jheap
from flink_tpu_torch import interop
from flink_tpu_torch.core import batch as pbatch
from flink_tpu_torch.core import functions as pfn
from flink_tpu_torch.operators import base as pbase
from flink_tpu_torch.operators import process as pprocess
from flink_tpu_torch.runtime import timers as ptimers
from flink_tpu_torch.state import api as papi
from flink_tpu_torch.state import changelog as pchangelog
from flink_tpu_torch.state import heap as pheap

from test_torch_heap import same

SIDES = {
    "jax": dict(batch=jbatch, fn=jfn, base=jbase, process=jprocess,
                timers=jtimers, api=japi, cl=jchangelog, heap=jheap),
    "port": dict(batch=pbatch, fn=pfn, base=pbase, process=pprocess,
                 timers=ptimers, api=papi, cl=pchangelog, heap=pheap),
}


def both(scenario, *args):
    want = scenario(SIDES["jax"], *args)
    got = scenario(SIDES["port"], *args)
    same(got, want)
    return got


class Harness:
    """One operator with manual elements, watermarks and processing time;
    collects what it emits as plain trees (columns, timestamps, tags)."""

    def __init__(self, S, op, ctx=None):
        self.S, self.op = S, op
        op.open(ctx or S["fn"].RuntimeContext())
        self.output = []

    @classmethod
    def restored(cls, S, op, snap, ctx=None):
        h = cls(S, op, ctx)
        op.restore_state(snap)
        return h

    def _take(self, elements):
        for e in elements:
            if isinstance(e, self.S["batch"].TaggedBatch):
                self.output.append(("tag", e.tag, _batch_tree(e.batch)))
            else:
                self.output.append(_batch_tree(e))

    def process_batch(self, batch):
        self._take(self.op.process_batch(batch))

    def process_watermark(self, ts):
        self._take(self.op.process_watermark(self.S["batch"].Watermark(ts)))

    def set_processing_time(self, ts):
        self._take(self.op.on_processing_time(ts))

    def rows(self):
        out = []
        for b in self.output:
            if b[0] == "tag":
                continue
            cols, _ = b
            n = len(next(iter(cols.values()))) if cols else 0
            out += [{k: v[i].item() for k, v in cols.items()}
                    for i in range(n)]
        return out

    def clear(self):
        self.output = []


def _batch_tree(b):
    return ({k: np.asarray(v) for k, v in b.columns.items()},
            None if b.timestamps is None else np.asarray(b.timestamps))


def make_batch(S, keys, ts, **cols):
    columns = {"k": np.asarray(keys, np.int64)}
    columns.update({k: np.asarray(v) for k, v in cols.items()})
    return S["batch"].RecordBatch(columns, timestamps=np.asarray(ts, np.int64))


# ---------------------------------------------------------------- timer table

def test_timer_fire_order_and_dedup():
    def run(S):
        t = S["timers"].InternalTimerService()
        t.register_event_time([3, 1, 2], [30, 10, 20])
        t.register_event_time([1], [10])  # duplicate — idempotent
        return [t.advance_watermark(25), t.advance_watermark(25),
                t.advance_watermark(100)]

    out = both(run)
    assert out[0][2].tolist() == [10, 20] and out[0][0].tolist() == [1, 2]
    assert out[1][0].size == 0 and out[2][0].tolist() == [3]


def test_timer_delete():
    def run(S):
        t = S["timers"].InternalTimerService()
        t.register_event_time([1, 2], [10, 10])
        t.delete_event_time([1], [10])
        return t.advance_watermark(100)

    assert both(run)[0].tolist() == [2]


def test_timer_snapshot_restore():
    def run(S):
        t = S["timers"].InternalTimerService()
        t.register_event_time([1, 2], [10, 20])
        t.register_processing_time([5], [50])
        snap = t.snapshot()
        t2 = S["timers"].InternalTimerService()
        t2.restore(snap)
        return snap, t2.advance_watermark(15), t2.advance_processing_time(60)

    snap, ev, proc = both(run)
    assert ev[0].tolist() == [1] and proc[0].tolist() == [5]


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_timer_snapshot_restores_across_packages(direction):
    src, dst = (("jax", "port") if direction == "jax_to_port"
                else ("port", "jax"))
    t = SIDES[src]["timers"].InternalTimerService()
    t.register_event_time([4, 1, 4], [40, 10, 40], namespaces=[0, 1, 0])
    t.register_processing_time([2], [20])
    t.advance_watermark(5)
    t2 = SIDES[dst]["timers"].InternalTimerService()
    t2.restore(t.snapshot())
    same([t2.snapshot(), t2.advance_watermark(100),
          t2.advance_processing_time(30)],
         [t.snapshot(), t.advance_watermark(100),
          t.advance_processing_time(30)])


def test_namespaced_timers_distinct():
    def run(S):
        t = S["timers"].InternalTimerService()
        t.register_event_time([1, 1], [10, 10], namespaces=[100, 200])
        return t.advance_watermark(10)

    slots, ns, _ = both(run)
    assert slots.size == 2 and sorted(ns.tolist()) == [100, 200]


def test_processing_time_is_monotone():
    def run(S):
        t = S["timers"].InternalTimerService()
        t.register_processing_time([1, 2, 3], [10, 20, 30])
        return [t.advance_processing_time(25), t.advance_processing_time(5),
                t.advance_processing_time(25), t.next_processing_time(),
                t.current_processing_time]

    out = both(run)
    assert out[0][0].tolist() == [1, 2] and out[1][0].size == 0


def test_random_timer_workload():
    def run(S):
        rng = np.random.default_rng(3)
        t = S["timers"].InternalTimerService()
        out = []
        for step in range(10):
            n = int(rng.integers(1, 60))
            t.register_event_time(rng.integers(0, 30, n),
                                  rng.integers(0, 400, n),
                                  namespaces=rng.integers(0, 3, n))
            t.delete_event_time(rng.integers(0, 30, 5),
                                rng.integers(0, 400, 5))
            out.append(t.advance_watermark(step * 40))
            if step % 3 == 0:
                out.append(t.snapshot())
        return out

    both(run)


# ------------------------------------------------------------ process operator

def functions(S):
    """The test functions of ``tests/test_process.py``, over package ``S``."""
    api, KPF, RB = S["api"], S["process"].KeyedProcessFunction, \
        S["batch"].RecordBatch

    class DedupeWithTimeout(KPF):
        def __init__(self, timeout_ms=100):
            self.timeout_ms = timeout_ms
            self.seen_desc = api.ValueStateDescriptor("seen", dtype=np.int64,
                                                      default=0)

        def process_batch(self, ctx, batch):
            seen = ctx.state(self.seen_desc)
            vals, alive = seen.get_rows(ctx.slots)
            _, first_idx = np.unique(ctx.slots, return_index=True)
            first_mask = np.zeros(len(batch), bool)
            first_mask[first_idx] = True
            fresh = first_mask & ~(alive & (vals > 0))
            seen.put_rows(ctx.slots, np.ones(len(batch), np.int64))
            ctx.timer_service.register_event_time_timers(
                ctx.slots[fresh],
                np.asarray(batch.timestamps)[fresh] + self.timeout_ms)
            return [batch.select(fresh)]

        def on_timer_batch(self, ctx, slots, timestamps):
            ctx.state(self.seen_desc).clear_rows(slots)
            return None

    class CountAndEmitOnTimer(KPF):
        def __init__(self):
            self.cnt_desc = api.ValueStateDescriptor("cnt", dtype=np.int64,
                                                     default=0)

        def process_batch(self, ctx, batch):
            cnt = ctx.state(self.cnt_desc)
            uniq, counts = np.unique(ctx.slots, return_counts=True)
            base, _ = cnt.get_rows(uniq)
            cnt.put_rows(uniq, base + counts)
            ctx.timer_service.register_event_time_timers(
                uniq, np.full(uniq.size, 100, np.int64))
            return None

        def on_timer_batch(self, ctx, slots, timestamps):
            vals, _ = ctx.state(self.cnt_desc).get_rows(slots)
            return [RB({"k": ctx.keys_of(slots), "count": vals},
                       timestamps=np.asarray(timestamps))]

    class EmitOnProcTimer(KPF):
        def process_batch(self, ctx, batch):
            u = np.unique(ctx.slots)
            ctx.timer_service.register_processing_time_timers(
                u, np.zeros(len(u), np.int64))
            ctx.side_output("seen", {"k": batch.column("k")})
            return None

        def on_timer_batch(self, ctx, slots, timestamps):
            return [RB({"fired_k": ctx.keys_of(slots)})]

    return dict(dedupe=DedupeWithTimeout, count=CountAndEmitOnTimer,
                proc=EmitOnProcTimer)


def operator(S, fn, backend=None):
    return S["process"].KeyedProcessOperator(fn, "k", backend=backend)


def test_process_function_dedupe_with_timer_reset():
    def run(S):
        h = Harness(S, operator(S, functions(S)["dedupe"](100)))
        h.process_batch(make_batch(S, [1, 2, 1], [10, 11, 12]))
        first = h.rows()
        h.clear()
        h.process_batch(make_batch(S, [1], [50]))
        second = h.rows()
        h.process_watermark(200)
        h.process_batch(make_batch(S, [1], [210]))
        return first, second, h.rows(), h.output

    first, second, third, _ = both(run)
    assert [r["k"] for r in first] == [1, 2]
    assert second == [] and [r["k"] for r in third] == [1]


def _dedupe_snapshot(S):
    h = Harness(S, operator(S, functions(S)["dedupe"](100)))
    h.process_batch(make_batch(S, [1, 2], [10, 20]))
    return h.op.snapshot_state()


def _after_restore(S, snap):
    h = Harness.restored(S, operator(S, functions(S)["dedupe"](100)), snap)
    h.process_batch(make_batch(S, [1, 2], [30] * 2))
    deduped = h.rows()
    h.clear()
    h.process_watermark(300)
    h.process_batch(make_batch(S, [1, 2], [310, 311]))
    return deduped, h.rows(), h.op.snapshot_state()


def test_process_operator_snapshot_restore_keeps_timers_and_state():
    def run(S):
        snap = _dedupe_snapshot(S)
        return snap, _after_restore(S, snap)

    _, (deduped, fired, _) = both(run)
    assert deduped == [] and sorted(r["k"] for r in fired) == [1, 2]


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_process_snapshot_restores_across_packages(direction):
    src, dst = (("jax", "port") if direction == "jax_to_port"
                else ("port", "jax"))
    snap = _dedupe_snapshot(SIDES[src])
    if dst == "jax":
        snap = interop.heap_snapshot_to_jax(snap)
    same(_after_restore(SIDES[dst], snap),
         _after_restore(SIDES[src], _dedupe_snapshot(SIDES[src])))


def test_emit_from_timer():
    def run(S):
        h = Harness(S, operator(S, functions(S)["count"]()))
        h.process_batch(make_batch(S, [7, 7, 8], [1, 2, 3]))
        h.process_batch(make_batch(S, [7], [4]))
        before = h.rows()
        h.process_watermark(150)
        return before, h.rows(), h.output

    before, rows, _ = both(run)
    assert before == []
    assert sorted((r["k"], r["count"]) for r in rows) == [(7, 3), (8, 1)]


def test_scale_down_merges_timers_from_all_subtasks():
    def run(S):
        snaps = []
        for sub in range(2):
            h = Harness(S, operator(S, functions(S)["dedupe"](100)))
            h.process_batch(make_batch(S, [sub * 10 + 1], [10]))
            snaps.append(h.op.snapshot_state())
        merged = S["process"].KeyedProcessOperator.merge_snapshots(snaps)
        h2 = Harness.restored(S, operator(S, functions(S)["dedupe"](100)),
                              merged)
        h2.process_watermark(1000)
        h2.process_batch(make_batch(S, [1, 11], [1100, 1101]))
        return merged, h2.rows()

    _, rows = both(run)
    assert sorted(r["k"] for r in rows) == [1, 11]


def test_scale_up_split_filters_timers_by_key_group():
    """A split snapshot carries every subtask's timers; each restoring
    subtask keeps the keys of its own key-group range."""
    def run(S):
        h = Harness(S, operator(S, functions(S)["count"]()))
        keys = np.arange(40, dtype=np.int64)
        h.process_batch(make_batch(S, keys, np.arange(40)))
        snap = h.op.snapshot_state()
        parts = S["process"].KeyedProcessOperator.split_snapshot(snap, 128,
                                                                 3)
        out = []
        for i, part in enumerate(parts):
            ctx = S["fn"].RuntimeContext(subtask_index=i, parallelism=3,
                                         max_parallelism=128)
            h2 = Harness.restored(S, operator(S, functions(S)["count"]()),
                                  part, ctx)
            h2.process_watermark(500)
            out.append((part, h2.rows()))
        return out

    out = both(run)
    fired = sorted(r["k"] for _, rows in out for r in rows)
    assert fired == list(range(40))


def test_processing_time_timers_and_side_output():
    def run(S):
        h = Harness(S, operator(S, functions(S)["proc"]()))
        h.process_batch(make_batch(S, [0, 1, 0, 1], [1, 2, 3, 4]))
        h.set_processing_time(5)
        h.set_processing_time(6)
        return h.output, h.op.snapshot_state()

    out, _ = both(run)
    assert out[0][0] == "tag"
    assert sorted(out[1][0]["fired_k"].tolist()) == [0, 1] and len(out) == 2


def test_process_over_the_changelog_backend():
    """The operator over ``ChangelogKeyedStateBackend``: the same rows as
    over the heap; full snapshots restore, and the incremental branch
    ships the log suffix (timers in its extras) once a cut is confirmed."""
    def run(S):
        be = S["cl"].ChangelogKeyedStateBackend(
            S["heap"].HeapKeyedStateBackend())
        op = operator(S, functions(S)["count"](), backend=be)
        op.incremental_state = True
        h = Harness(S, op)
        out = []
        h.process_batch(make_batch(S, [5, 6, 5], [1, 2, 3]))
        with S["base"].snapshot_scope(1, incremental=True):
            out.append(op.snapshot_state())
        op.notify_checkpoint_complete(1)
        h.process_batch(make_batch(S, [6, 7], [4, 5]))
        with S["base"].snapshot_scope(2, incremental=True):
            out.append(op.snapshot_state())
        with S["base"].snapshot_scope(3, incremental=False):
            full = op.snapshot_state()
        out.append(full)
        h.process_watermark(150)
        out.append(h.rows())
        h2 = Harness.restored(S, operator(S, functions(S)["count"](),
                              backend=S["cl"].ChangelogKeyedStateBackend(
                                  S["heap"].HeapKeyedStateBackend())), full)
        h2.process_watermark(150)
        out.append(h2.rows())
        return out

    out = both(run)
    assert "changelog_backend" in out[0]
    assert out[1]["__increment__"] == 1 and "timers" in out[1]["extras"]
    assert out[3] == out[4]
    assert sorted((r["k"], r["count"]) for r in out[3]) == \
        [(5, 2), (6, 2), (7, 1)]


def test_snapshot_scope_contextvars():
    for S in SIDES.values():
        base = S["base"]
        assert base.current_checkpoint_id() is None
        assert not base.snapshot_is_incremental()
        with base.snapshot_scope(9, incremental=True):
            assert base.current_checkpoint_id() == 9
            assert base.snapshot_is_incremental()
            with base.snapshot_scope(10):
                assert base.current_checkpoint_id() == 10
                assert not base.snapshot_is_incremental()
            assert base.current_checkpoint_id() == 9
        assert base.current_checkpoint_id() is None


def test_keyed_tumbling_sum_as_a_process_function():
    """The smoke's path 36 at a small size: a per-key ``SumAggregator``
    ``AggregatingState`` and a count ``ValueState``, an event-time timer at
    each window's end that emits (key, window, sum, count) and clears."""
    def run(S):
        api = S["api"]

        class WindowSum(S["process"].KeyedProcessFunction):
            def __init__(self):
                self.sum_d = api.AggregatingStateDescriptor(
                    "sum", S["fn"].SumAggregator(np.float32))
                self.cnt_d = api.ValueStateDescriptor("n", dtype=np.int64,
                                                      default=0)

            def process_batch(self, ctx, batch):
                ctx.state(self.sum_d).add_rows(
                    ctx.slots, np.asarray(batch.column("v")))
                u, c = np.unique(ctx.slots, return_counts=True)
                cnt = ctx.state(self.cnt_d)
                cnt.put_rows(u, cnt.get_rows(u)[0] + c)
                end = (np.asarray(batch.timestamps) // 500 + 1) * 500 - 1
                ctx.timer_service.register_event_time_timers(ctx.slots, end)
                return None

            def on_timer_batch(self, ctx, slots, ts):
                s, _ = ctx.state(self.sum_d).get_rows(slots)
                n, _ = ctx.state(self.cnt_d).get_rows(slots)
                ctx.state(self.sum_d).clear_rows(slots)
                ctx.state(self.cnt_d).clear_rows(slots)
                return [S["batch"].RecordBatch(
                    {"k": ctx.keys_of(slots), "window_end": ts, "sum": s,
                     "count": n})]

        rng = np.random.default_rng(7)
        h = Harness(S, operator(S, WindowSum()))
        t = 0
        for _ in range(8):
            ts = t + np.sort(rng.integers(0, 200, 300))
            h.process_batch(make_batch(S, rng.integers(0, 50, 300), ts,
                                       v=rng.random(300).astype(np.float32)))
            h.process_watermark(int(ts.max()) - 1)
            t += 200
        return h.output, h.op.snapshot_state()

    both(run)
