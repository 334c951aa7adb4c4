"""Port parity for the shuffle SPI: ``flink_tpu_torch.runtime.shuffle``
against ``flink_tpu.runtime.shuffle``.

The 15 cases of ``tests/test_shuffle.py`` run through both packages (each
case is a function of the package's modules): the sort-merge service's
regions and lifecycle, the pipelined service, the registry and the
configured-service resolution (``ShuffleOptions``), hash routing, and the
``partition_by_hash``/``map_partition`` DataSet exchange in the streamed and
materialized executors.  The outcomes must be equal, and the partition
files too: a partition one package writes, the other reads.
"""

from __future__ import annotations

import os
import threading
import types

import numpy as np
import pytest

from flink_tpu.config.config_option import Configuration as JaxConfiguration
from flink_tpu.config.options import ShuffleOptions as JaxShuffleOptions
from flink_tpu.core.batch import RecordBatch as JaxBatch
from flink_tpu.core.keygroups import hash_keys as jax_hash_keys
from flink_tpu.dataset.api import ExecutionEnvironment as JaxEnv
from flink_tpu.runtime import shuffle as jshuffle
from flink_tpu_torch.config.config_option import Configuration
from flink_tpu_torch.config.options import ShuffleOptions
from flink_tpu_torch.core.batch import RecordBatch
from flink_tpu_torch.core.keygroups import hash_keys
from flink_tpu_torch.dataset.api import ExecutionEnvironment
from flink_tpu_torch.runtime import shuffle as pshuffle

SIDES = {
    "jax": types.SimpleNamespace(
        sh=jshuffle, RB=JaxBatch, Config=JaxConfiguration,
        SO=JaxShuffleOptions, hash_keys=jax_hash_keys,
        env=lambda config=None: JaxEnv.get_execution_environment(config)),
    "port": types.SimpleNamespace(
        sh=pshuffle, RB=RecordBatch, Config=Configuration,
        SO=ShuffleOptions, hash_keys=hash_keys,
        env=lambda config=None: ExecutionEnvironment.
        get_execution_environment(config, device="cpu")),
}


def both(fn, tmp_path=None):
    """``fn(side[, directory])`` in each package; equal results."""
    out = []
    for s in ("jax", "port"):
        args = (SIDES[s],) if tmp_path is None else (SIDES[s],
                                                     _fresh(tmp_path, s))
        out.append(fn(*args))
    assert _norm(out[0]) == _norm(out[1]), out
    return out[1]


def _fresh(tmp_path, s):
    d = tmp_path / s
    d.mkdir()
    return d


def _norm(x):
    if isinstance(x, dict):
        return {k: _norm(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_norm(v) for v in x]
    if isinstance(x, np.ndarray):
        return (x.dtype.str, x.tolist())
    if isinstance(x, np.generic):
        return (type(x).__name__, x.item())
    return x


def make_batch(ns, lo: int, hi: int):
    return ns.RB({"k": np.arange(lo, hi, dtype=np.int64),
                  "v": np.arange(lo, hi, dtype=np.float64) * 0.5})


def _ks(batches):
    return [np.asarray(b.column("k")).tolist() for b in batches]


class TestSortMergeService:
    def test_write_finish_read_round_trip(self, tmp_path):
        def run(ns, d):
            svc = ns.sh.SortMergeShuffleService(str(d),
                                                memory_budget_bytes=1 << 20)
            w = svc.create_partition("p1", 3)
            w.emit(0, make_batch(ns, 0, 10))
            w.emit(2, make_batch(ns, 10, 15))
            w.emit(0, make_batch(ns, 20, 25))
            w.finish()
            return [_ks(svc.open_reader("p1", s)) for s in range(3)]

        got = both(run, tmp_path)
        assert got == [[list(range(10)), list(range(20, 25))], [],
                       [list(range(10, 15))]]
        # the partition files are byte for byte equal, and cross
        for ext in (".shuffle", ".index"):
            assert (tmp_path / "jax" / f"p1{ext}").read_bytes() == \
                (tmp_path / "port" / f"p1{ext}").read_bytes()
        svc = pshuffle.SortMergeShuffleService(str(tmp_path / "jax"))
        assert _ks(svc.open_reader("p1", 0)) == got[0]
        assert all(type(b) is RecordBatch for b in svc.open_reader("p1", 0))

    def test_small_budget_spills_many_regions(self, tmp_path):
        def run(ns, d):
            svc = ns.sh.SortMergeShuffleService(str(d),
                                                memory_budget_bytes=64)
            w = svc.create_partition("p", 2)
            for i in range(12):
                w.emit(i % 2, make_batch(ns, i * 10, i * 10 + 5))
            w.finish()
            return (len(w._regions), w._regions,
                    [int(np.asarray(b.column("k"))[0])
                     for b in svc.open_reader("p", 0)])

        n, _, heads = both(run, tmp_path)
        assert n >= 6 and heads == [0, 20, 40, 60, 80, 100]

    def test_blocking_contract_and_release(self, tmp_path):
        def run(ns, d):
            svc = ns.sh.SortMergeShuffleService(str(d))
            assert svc.blocking
            w = svc.create_partition("p", 1)
            w.emit(0, make_batch(ns, 0, 4))
            with pytest.raises(ValueError, match="not finished"):
                list(svc.open_reader("p", 0))
            w.finish()
            fin = svc.is_finished("p")
            with pytest.raises(ValueError, match="already finished"):
                svc.create_partition("p", 1)
            with pytest.raises(IndexError):
                list(svc.open_reader("p", 1))
            svc.release_partition("p")
            return fin, svc.is_finished("p"), sorted(os.listdir(d))

        assert both(run, tmp_path) == (True, False, [])

    def test_abort_leaves_no_files(self, tmp_path):
        def run(ns, d):
            svc = ns.sh.SortMergeShuffleService(str(d))
            w = svc.create_partition("p", 2)
            w.emit(1, make_batch(ns, 0, 100))
            with pytest.raises(IndexError):
                w.emit(2, make_batch(ns, 0, 1))
            w.abort()
            return sorted(os.listdir(d))

        assert both(run, tmp_path) == []

    def test_partition_outlives_producer_service(self, tmp_path):
        def run(ns, d):
            svc1 = ns.sh.SortMergeShuffleService(str(d))
            w = svc1.create_partition("p", 2)
            w.emit(0, make_batch(ns, 0, 50))
            w.finish()
            with pytest.raises(ValueError, match="finished"):
                w.emit(0, make_batch(ns, 0, 1))
            del svc1
            svc2 = ns.sh.SortMergeShuffleService(str(d))
            got = sum(len(b) for b in svc2.open_reader("p", 0))
            again = sum(len(b) for b in svc2.open_reader("p", 0))
            svc2.release_all()
            return got, again, os.listdir(d)

        assert both(run, tmp_path) == (50, 50, [])


class TestPipelinedService:
    def test_concurrent_producer_consumer(self):
        def run(ns):
            svc = ns.sh.PipelinedShuffleService()
            assert not svc.blocking
            w = svc.create_partition("p", 1)
            with pytest.raises(ValueError, match="already exists"):
                svc.create_partition("p", 1)
            got = []

            def consume():
                for b in svc.open_reader("p", 0):
                    got.append(len(b))

            t = threading.Thread(target=consume)
            t.start()
            for i in range(5):
                w.emit(0, make_batch(ns, i, i + 3))
            w.finish()
            t.join(timeout=10)
            svc.release_partition("p")
            return got

        assert both(run) == [3] * 5


class TestRegistry:
    def test_configured_service_resolution(self, tmp_path):
        def run(ns, d):
            cfg = ns.Config()
            cfg.set(ns.SO.SERVICE, "sort-merge")
            cfg.set(ns.SO.DIRECTORY, str(d))
            cfg.set(ns.SO.MEMORY_BUDGET_BYTES, 123)
            svc = ns.sh.shuffle_service_for(cfg)
            out = (type(svc).__name__, svc.directory == str(d),
                   svc.memory_budget_bytes)
            cfg.set(ns.SO.SERVICE, "pipelined")
            return out + (type(ns.sh.shuffle_service_for(cfg)).__name__,)

        assert both(run, tmp_path) == ("SortMergeShuffleService", True, 123,
                                       "PipelinedShuffleService")

    def test_third_party_registration(self):
        def run(ns):
            class Custom(ns.sh.ShuffleService):
                pass

            ns.sh.register_shuffle_service("custom-test",
                                           lambda **kw: Custom())
            try:
                got = type(ns.sh.shuffle_service_for(
                    name="custom-test")).__name__
                with pytest.raises(ValueError,
                                   match="unknown shuffle.service"):
                    ns.sh.shuffle_service_for(name="no-such")
                for call in (lambda c: c.create_partition("p", 1),
                             lambda c: list(c.open_reader("p", 0)),
                             lambda c: c.release_partition("p")):
                    with pytest.raises(NotImplementedError):
                        call(Custom())
            finally:
                ns.sh._FACTORIES.pop("custom-test")
            return got

        assert both(run) == "Custom"

    def test_hash_routing_matches_keygroup_spread(self):
        def run(ns):
            keys = np.arange(10_000, dtype=np.int64)
            sub = ns.sh.hash_subpartition(keys, 7)
            assert np.array_equal(sub, ns.sh.hash_subpartition(keys, 7))
            words = np.asarray([f"w{i}" for i in range(500)], object)
            return sub, ns.sh.hash_subpartition(words, 5)

        sub, words = both(run)
        assert sub.dtype == np.int64 and sub.min() >= 0 and sub.max() < 7
        assert np.bincount(sub, minlength=7).min() > 800
        # the key-group spread: the port's hash_keys, as the stream routes
        keys = np.arange(10_000, dtype=np.int64)
        assert np.array_equal(sub, hash_keys(keys).astype(np.int64) % 7)


def _stream_rows(ds):
    rows = []
    for b in ds.stream_batches():
        rows.extend(b.to_rows())
    return rows


def _rows(rows):
    return [tuple((k, type(v).__name__, v) for k, v in r.items())
            for r in rows]


class TestDataSetExchange:
    def test_map_partition_over_hash_exchange_streamed(self):
        def run(ns):
            env = ns.env()
            n = 5000
            keys = np.arange(n, dtype=np.int64) % 100

            def dedup_count(part):
                k = np.asarray(part.column("k"))
                uniq, cnt = np.unique(k, return_counts=True)
                return ns.RB({"k": uniq, "cnt": cnt.astype(np.int64)})

            ds = (env.from_columns({"k": keys})
                  .partition_by_hash("k", num_partitions=6)
                  .map_partition(dedup_count))
            return _rows(_stream_rows(ds)), _rows(ds.collect())

        for rows in both(run):
            got = {r[0][2]: r[1][2] for r in rows}
            assert len(got) == 100 and all(c == 50 for c in got.values())

    def test_map_partition_without_exchange_is_one_partition(self):
        def run(ns):
            calls = []

            def fn(part):
                calls.append(len(part))
                return part

            rows = _stream_rows(
                ns.env().from_columns({"k": np.arange(10, dtype=np.int64)})
                .map_partition(fn))
            return _rows(rows), calls

        rows, calls = both(run)
        assert len(rows) == 10 and calls == [10]

    def test_exchange_through_pipelined_service_override(self):
        def run(ns):
            created = []
            orig = ns.sh.PipelinedShuffleService

            class Tracking(orig):
                def __init__(self):
                    super().__init__()
                    created.append(self)

            ns.sh._FACTORIES["pipelined"] = lambda **kw: Tracking()
            try:
                rows = _stream_rows(
                    ns.env().from_columns({"k": np.arange(64,
                                                          dtype=np.int64)})
                    .partition_by_hash("k", num_partitions=4,
                                       service="pipelined")
                    .map_partition(lambda p: p))
            finally:
                ns.sh._FACTORIES["pipelined"] = lambda **kw: orig()
            return _rows(rows), len(created)

        rows, created = both(run)
        assert sorted(r[0][2] for r in rows) == list(range(64))
        assert created == 1

    def test_shuffle_options_govern_the_exchange(self, tmp_path):
        def run(ns, d):
            cfg = ns.Config()
            cfg.set(ns.SO.DIRECTORY, str(d))
            cfg.set(ns.SO.MEMORY_BUDGET_BYTES, 128)   # spill a lot
            seen_files = []

            def fn(part):
                seen_files.append(len(os.listdir(d)))
                return part

            rows = _stream_rows(
                ns.env(cfg).from_columns({"k": np.arange(500,
                                                         dtype=np.int64)})
                .partition_by_hash("k", num_partitions=3)
                .map_partition(fn))
            return _rows(rows), max(seen_files) > 0, os.listdir(d)

        rows, spilled, left = both(run, tmp_path)
        assert len(rows) == 500 and spilled and left == []

    def test_default_partition_count_agrees_across_executors(self):
        def run(ns):
            def tag_max(part):
                k = np.asarray(part.column("k"))
                return ns.RB({"k": k, "part_max": np.full(
                    len(k), k.max(), np.int64)})

            ds = (ns.env().from_columns({"k": np.arange(40,
                                                        dtype=np.int64) % 7})
                  .partition_by_hash("k")
                  .map_partition(tag_max))
            return _rows(_stream_rows(ds)), _rows(ds.collect())

        streamed, collected = both(run)
        assert sorted(streamed) == sorted(collected)

    def test_materialized_path_agrees_with_streamed(self):
        def run(ns):
            def tag_max(part):
                k = np.asarray(part.column("k"))
                return ns.RB({"k": k, "part_max": np.full(
                    len(k), k.max(), np.int64)})

            ds = (ns.env().from_columns({"k": np.arange(40, dtype=np.int64)})
                  .partition_by_hash("k", num_partitions=4)
                  .map_partition(tag_max))
            return _rows(ds.union(ds).collect())   # a diamond: consumed twice

        rows = both(run)
        assert len(rows) == 80
        assert sorted(r[0][2] for r in rows) == sorted(list(range(40)) * 2)
        assert all(r[1][2] >= r[0][2] for r in rows)
