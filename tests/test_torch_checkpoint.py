"""Port parity for incremental checkpoints and job checkpoints, by hand.

- **Same increments.**  The JAX window operator and the port's run the same
  seeded batches with ``incremental_state`` on, cut every second batch
  under ``snapshot_scope(cid, incremental=True)`` and confirm each cut but
  one (the withheld confirmation makes the next cuts ship the union of the
  unconfirmed dirt).  Every cut, an increment or a full re-base, is equal
  field for field and bit for bit through ``interop``: on the host mirror
  (numpy and C), the device tier (CPU), the device tier with the pipelined
  hot stage and with async fires, the fused super-batch lane, the paged
  lane and the mesh at D = 1, 2 and 4.
- **Chains resolve to full snapshots.**  Every cut resolved against the
  chain before it equals a full snapshot the operator takes at the same
  batch, bit for bit; the port's ``delta`` resolves JAX's chains and JAX's
  resolves the port's.
- **The changelog applier.**  ``ChangelogKeyedStateBackend.snapshot_increment``
  nodes resolve the same way through ``apply_changelog`` in both packages.
- **Storage.**  ``IncrementalCheckpointStorage`` dedups blobs, keeps the
  chains retention needs, compacts and detects corruption the same way in
  both packages; a directory JAX wrote loads in the port bit for bit.
- **Job checkpoints.**  A MiniCluster checkpoint tree crosses over both
  ways and the job restores from it in either package; the reference's
  MiniCluster incremental case holds on both (its steady cut picked free of
  the end-of-input race, see :func:`test_minicluster_incremental_end_to_end`).
- ``execute_cluster`` with no device and no card raises.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from flink_tpu.core import batch as jbatch
from flink_tpu.core.functions import RuntimeContext as JaxContext
from flink_tpu.core.functions import SumAggregator as JaxSum
from flink_tpu.datastream.api import StreamExecutionEnvironment as JaxEnv
from flink_tpu.operators.base import snapshot_scope as jscope
from flink_tpu.operators.window_agg import WindowAggOperator as JaxOp
from flink_tpu.parallel import mesh as jmesh
from flink_tpu.parallel.mesh_runtime import MeshWindowAggOperator as JaxMesh
from flink_tpu.runtime.checkpoint import delta as jdelta
from flink_tpu.runtime.checkpoint import incremental as jinc
from flink_tpu.runtime.checkpoint.storage import CorruptCheckpointError as JCE
from flink_tpu.state import changelog as jchangelog
from flink_tpu.state import heap as jheap
from flink_tpu.state.paging import PagingConfig as JaxPaging
from flink_tpu.testing import chaos as jchaos
from flink_tpu import windowing as jwin
from flink_tpu.windowing import triggers as jtrig
from flink_tpu.windowing.assigners import TumblingEventTimeWindows as JaxTumb
from flink_tpu_torch import interop
from flink_tpu_torch.core import batch as pbatch
from flink_tpu_torch.core.functions import RuntimeContext, SumAggregator
from flink_tpu_torch.datastream.api import StreamExecutionEnvironment
from flink_tpu_torch.operators.base import snapshot_scope as pscope
from flink_tpu_torch.operators.window_agg import WindowAggOperator
from flink_tpu_torch.parallel import mesh as pmesh
from flink_tpu_torch.parallel.mesh_runtime import MeshWindowAggOperator
from flink_tpu_torch.runtime.checkpoint import delta as pdelta
from flink_tpu_torch.runtime.checkpoint import incremental as pinc
from flink_tpu_torch.runtime.checkpoint.storage import CorruptCheckpointError
from flink_tpu_torch.state import changelog as pchangelog
from flink_tpu_torch.state import heap as pheap
from flink_tpu_torch.state.paging import PagingConfig
from flink_tpu_torch.state.shard_layout import densify_keyed_snapshot
from flink_tpu_torch.testing import chaos as pchaos
from flink_tpu_torch import windowing as pwin
from flink_tpu_torch.windowing import triggers as ptrig
from flink_tpu_torch.windowing.assigners import TumblingEventTimeWindows
from test_torch_calibration import _jax_x64, verdicts  # noqa: F401

HOST = dict(emit_tier="host", snapshot_source="mirror", device_sync="scatter")
DEVICE = dict(emit_tier="device", snapshot_source="device",
              device_sync="scatter")

#: lane -> (operator options, mesh size or None)
LANES = {
    "host-mirror": (dict(HOST, native_emit=False), None),
    "host-native": (dict(HOST, native_emit=True), None),
    "host-superbatch": (dict(emit_tier="host", snapshot_source="mirror",
                             device_sync="deferred", native_emit=True,
                             superbatch=4), None),
    "device": (dict(DEVICE), None),
    "device-pipelined": (dict(DEVICE, pipeline_depth=2), None),
    "device-async": (dict(DEVICE, async_fire=True), None),
    "paged": (dict(DEVICE, paging=dict(capacity=1024, mem_budget=8 << 10)),
              None),
    "mesh-1": (dict(DEVICE), 1),
    "mesh-2": (dict(DEVICE), 2),
    "mesh-4": (dict(DEVICE), 4),
}

N_BATCHES = 12
#: the cut whose confirmation is withheld
WITHHELD = 5


@pytest.fixture(autouse=True)
def _pinned(verdicts):  # noqa: F811
    verdicts(taxed=False, shards=1, super_shards=1, depth=1, probe=False)


def _batches(seed=7, nk=3000, b=2000):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(N_BATCHES):
        # a hot set that changes slowly, so most cuts are increments
        hot = rng.integers(0, nk // (4 if i else 1), b).astype(np.int64)
        vals = rng.random(b).astype(np.float32)
        ts = i * 300 + np.sort(rng.integers(0, 300, b)).astype(np.int64)
        out.append((hot, vals, ts))
    return out


def _op(side, lane):
    opts, D = LANES[lane]
    opts = dict(opts, key_column="k", value_column="v", device_probe="off")
    opts.setdefault("native_emit", False)
    opts.setdefault("pipeline_depth", 0)
    opts.setdefault("superbatch", 1)
    paging = opts.pop("paging", None)
    if side == "jax":
        if paging is not None:
            opts["paging"] = JaxPaging(**paging)
        with _jax_x64():
            if D is None:
                op = JaxOp(JaxTumb.of(1000), JaxSum(jnp.float32), **opts)
            else:
                op = JaxMesh(JaxTumb.of(1000), JaxSum(jnp.float32),
                             mesh=jmesh.make_mesh(D), **opts)
            op.open(JaxContext())
    else:
        if paging is not None:
            opts["paging"] = PagingConfig(**paging)
        if D is None:
            op = WindowAggOperator(TumblingEventTimeWindows.of(1000),
                                   SumAggregator(torch.float32),
                                   device="cpu", **opts)
        else:
            op = MeshWindowAggOperator(
                TumblingEventTimeWindows.of(1000),
                SumAggregator(torch.float32),
                mesh=pmesh.make_mesh(devices=["cpu"] * D), **opts)
        op.open(RuntimeContext())
    op.incremental_state = True
    return op


def _drive(side, lane, batches):
    """Cuts (raw) and full snapshots at the same batches, and the fires."""
    B = jbatch if side == "jax" else pbatch
    scope = jscope if side == "jax" else pscope
    op = _op(side, lane)
    cuts, fulls, fires = [], [], []
    with _jax_x64():
        for i, (k, v, ts) in enumerate(batches):
            fires += op.process_batch(B.RecordBatch({"k": k, "v": v},
                                                    timestamps=ts))
            fires += op.process_watermark(B.Watermark(int(ts.max()) - 1200))
            if i % 2 == 1:
                cid = i
                fires += op.prepare_snapshot_pre_barrier()
                with scope(cid, incremental=True):
                    cuts.append(op.snapshot_state())
                fulls.append(op.snapshot_state())   # outside the scope
                if cid != WITHHELD:
                    op.notify_checkpoint_complete(cid)
    op.close()
    return cuts, fulls, op


def tree_equal(a, b, path="$"):
    """Bit-exact structural equality of two snapshot trees."""
    if isinstance(a, (np.ndarray, np.generic)) or isinstance(
            b, (np.ndarray, np.generic)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype, f"{path}: dtype {a.dtype} != {b.dtype}"
        assert a.shape == b.shape, f"{path}: shape {a.shape} != {b.shape}"
        if a.dtype == object:
            assert a.tolist() == b.tolist(), f"{path}: values differ"
        else:
            assert a.tobytes() == b.tobytes(), f"{path}: bits differ"
        return
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), \
            f"{path}: keys {sorted(map(str, a))} != {sorted(map(str, b))}"
        for k in a:
            tree_equal(a[k], b[k], f"{path}.{k}")
        return
    if isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), \
            f"{path}: length {len(a)} != {len(b)}"
        for i, (x, y) in enumerate(zip(a, b)):
            tree_equal(x, y, f"{path}[{i}]")
        return
    assert a == b, f"{path}: {a!r} != {b!r}"


def _fixed(snap, source):
    """One cut through ``interop``, as the other package would take it."""
    conv = (interop.snapshot_from_jax if source == "jax"
            else interop.snapshot_to_jax)
    return conv(snap)


_RUNS = {}


def _runs(lane):
    if lane not in _RUNS:
        batches = _batches()
        _RUNS[lane] = (_drive("jax", lane, batches),
                       _drive("port", lane, batches))
    return _RUNS[lane]


@pytest.mark.parametrize("lane", list(LANES))
def test_increments_equal_jax(lane):
    (jcuts, _jf, jop), (pcuts, _pf, pop) = _runs(lane)
    kinds = [c.get("kind") for c in pcuts]
    assert kinds == [c.get("kind") for c in jcuts]
    # a base, increments, and a re-base after the withheld confirmation
    # (or when a cut is too dirty) on every lane
    assert kinds[0] is None and "window_delta" in kinds
    for j, p in zip(jcuts, pcuts):
        tree_equal(_fixed(p, "port"), _fixed(j, "jax"))
    # the device tier's increment download keeps JAX's counter name (a
    # paged full snapshot books its resident rows under "d2h" in the port
    # and under "d2h_page_out" in JAX, so the paged lane is left out)
    if LANES[lane][0].get("emit_tier") == "device" and lane != "paged":
        assert pop.phase_bytes.get("d2h_page_out") == \
            jop.phase_bytes.get("d2h_page_out")


def test_withheld_confirmation_ships_the_union():
    """The cut after the withheld one re-ships the withheld cut's cells:
    its cells cover both cuts' dirt."""
    (_j, _jf, _jo), (pcuts, _pf, _po) = _runs("device")
    at = WITHHELD // 2
    nxt = pcuts[at + 1]
    if nxt.get("kind") != "window_delta":
        pytest.fail("the cut after the withheld one is not an increment")
    w = pcuts[at]
    covered = {(c["pane"], int(g)) for c in nxt["cells"] for g in c["gids"]}
    if w.get("kind") == "window_delta":
        mine = {(c["pane"], int(g)) for c in w["cells"] for g in c["gids"]}
        assert mine <= covered | {(p, g) for p, g in mine
                                  if p < nxt["meta"]["pane_base"]}


#: count-trigger cases: (assigner, trigger) built from either package
COUNT_CASES = {
    "global-running": (lambda w: w.GlobalWindows.create(),
                       lambda t: t.CountTrigger.of(5, purge=False)),
    "tumbling-purging": (lambda w: w.TumblingEventTimeWindows.of(1000),
                         lambda t: t.CountTrigger.of(3, purge=True)),
    "sliding-running": (lambda w: w.SlidingEventTimeWindows.of(2000, 1000),
                        lambda t: t.CountTrigger.of(4, purge=False)),
    "sliding-purging": (lambda w: w.SlidingEventTimeWindows.of(2000, 1000),
                        lambda t: t.CountTrigger.of(4, purge=True)),
}


@pytest.mark.parametrize("case", list(COUNT_CASES))
def test_count_trigger_increments_equal_jax(case):
    """Count triggers mark their registers (count baselines, value
    baselines, their drops at expiry) and their purged cells: every cut
    equals JAX's field for field, and resolves to the full snapshot."""
    assign, trig = COUNT_CASES[case]
    batches = _batches(nk=600, b=1500)
    got = {}
    for side in ("jax", "port"):
        B, scope = (jbatch, jscope) if side == "jax" else (pbatch, pscope)
        w, t = (jwin, jtrig) if side == "jax" else (pwin, ptrig)
        kw = dict(key_column="k", value_column="v", emit_tier="device",
                  snapshot_source="device", device_probe="off",
                  trigger=trig(t))
        with _jax_x64():
            op = (JaxOp(assign(w), JaxSum(jnp.float32), **kw)
                  if side == "jax" else
                  WindowAggOperator(assign(w), SumAggregator(torch.float32),
                                    device="cpu", **kw))
            op.open(JaxContext() if side == "jax" else RuntimeContext())
            op.incremental_state = True
            cuts, resolved = [], None
            for i, (k, v, ts) in enumerate(batches):
                op.process_batch(B.RecordBatch({"k": k, "v": v},
                                               timestamps=ts))
                op.process_watermark(B.Watermark(int(ts.max()) - 1200))
                if i % 2:
                    with scope(i, incremental=True):
                        cuts.append(op.snapshot_state())
                    resolved = pdelta.apply_increments(resolved, cuts[-1]) \
                        if resolved is not None else cuts[-1]
                    tree_equal(resolved, op.snapshot_state())
                    if i != WITHHELD:
                        op.notify_checkpoint_complete(i)
        got[side] = cuts
    kinds = [c.get("kind") for c in got["port"]]
    assert "window_delta" in kinds
    assert kinds == [c.get("kind") for c in got["jax"]]
    for j, p in zip(got["jax"], got["port"]):
        tree_equal(_fixed(p, "port"), _fixed(j, "jax"))


def test_rebase_ratio_forces_a_full_cut():
    batches = _batches()
    for side, scope in (("jax", jscope), ("port", pscope)):
        B = jbatch if side == "jax" else pbatch
        op = _op(side, "device")
        op.incr_rebase_ratio = 0.0
        with _jax_x64():
            for i, (k, v, ts) in enumerate(batches[:4]):
                op.process_batch(B.RecordBatch({"k": k, "v": v},
                                               timestamps=ts))
                with scope(i + 1, incremental=True):
                    cut = op.snapshot_state()
                assert not cut.get("__increment__")
                op.notify_checkpoint_complete(i + 1)


@pytest.mark.parametrize("lane", ["host-native", "device", "paged",
                                  "mesh-2", "mesh-4"])
def test_chains_resolve_to_full_snapshots(lane):
    (jcuts, jfulls, _jo), (pcuts, pfulls, _po) = _runs(lane)
    for cuts, fulls, own in ((pcuts, pfulls, pdelta),
                             (jcuts, jfulls, jdelta)):
        resolved = None
        for raw, full in zip(cuts, fulls):
            resolved = pdelta.apply_increments(resolved, raw) \
                if resolved is not None else raw
            tree_equal(densify_keyed_snapshot(resolved),
                       densify_keyed_snapshot(full))
    # each package resolves the other's chains
    tree_equal(_fixed(pdelta.resolve_chain(
        [interop.snapshot_from_jax(c) for c in jcuts]), "port"),
        _fixed(jdelta.resolve_chain(jcuts), "jax"))
    tree_equal(_fixed(jdelta.resolve_chain(
        [interop.snapshot_to_jax(c) for c in pcuts]), "jax"),
        _fixed(pdelta.resolve_chain(pcuts), "port"))


def test_restored_chain_runs_on_like_the_uninterrupted_run():
    """A fresh operator restored from the resolved chain at batch 6 and run
    to the end fires what the uninterrupted run fires."""
    batches = _batches()
    (_j, _jf, _jo), (pcuts, _pf, _po) = _runs("device")
    chain = pcuts[:3]                      # cuts at batches 1, 3, 5
    op = _op("port", "device")
    op.restore_state(pdelta.resolve_chain(chain))
    ref = _op("port", "device")
    got, want = [], []
    for i, (k, v, ts) in enumerate(batches):
        b = pbatch.RecordBatch({"k": k, "v": v}, timestamps=ts)
        wm = pbatch.Watermark(int(ts.max()) - 1200)
        w = ref.process_batch(b) + ref.process_watermark(wm)
        if i > 5:
            want += w
            got += op.process_batch(b) + op.process_watermark(wm)
    tree_equal([x.columns for x in got], [x.columns for x in want])
    tree_equal(op.snapshot_state(), ref.snapshot_state())


# ---------------------------------------------------------------------------
# the changelog applier
# ---------------------------------------------------------------------------

def _changelog_chain(changelog, heap):
    be = changelog.ChangelogKeyedStateBackend(
        heap.HeapKeyedStateBackend(max_parallelism=16))
    st = be.value_state("v", default=0.0)
    slots = be.key_slots(np.arange(50))
    st.put_rows(slots, np.arange(50.0))
    be.materialize()
    chain = [be.snapshot()]
    be._unconfirmed.append((1, be._epoch, len(be._log)))
    be.notify_checkpoint_complete(1)
    for cid, (key, val) in enumerate([(7, 700.0), (9, 900.0), (3, 30.0)],
                                     start=2):
        be.set_current_key(key)
        st.update(val)
        chain.append(be.snapshot_increment(cid))
        if cid != 3:
            be.notify_checkpoint_complete(cid)
    return chain, be.snapshot()


def test_changelog_increments_resolve_alike():
    jchain, jfull = _changelog_chain(jchangelog, jheap)
    pchain, pfull = _changelog_chain(pchangelog, pheap)
    assert [c.get("kind") for c in pchain] == \
        [c.get("kind") for c in jchain] == [None] + ["changelog"] * 3
    for j, p in zip(jchain[1:], pchain[1:]):
        assert interop.changelog_increment_to_jax(p)["log_base"] == \
            interop.changelog_increment_from_jax(j)["log_base"]
        assert len(p["log_suffix"]) == len(j["log_suffix"])
    presolved = pdelta.resolve_chain(pchain)
    jresolved = jdelta.resolve_chain(jchain)
    assert len(presolved["changelog"]) == len(jresolved["changelog"]) \
        == len(pfull["changelog"])
    for be_mod, heap, resolved in ((pchangelog, pheap, presolved),
                                   (jchangelog, jheap, jresolved)):
        be = be_mod.ChangelogKeyedStateBackend(
            heap.HeapKeyedStateBackend(max_parallelism=16))
        st = be.value_state("v", default=0.0)
        be.restore(resolved)
        for key, want in ((7, 700.0), (9, 900.0), (3, 30.0), (4, 4.0)):
            be.set_current_key(key)
            assert st.value() == want


# ---------------------------------------------------------------------------
# storage
# ---------------------------------------------------------------------------

def _store_chain(inc_mod, root, cuts, **kw):
    storage = inc_mod.IncrementalCheckpointStorage(str(root), **kw)
    for i, c in enumerate(cuts, start=1):
        storage.store(i, {"w": c})
    storage.wait_for_compaction()
    return storage


@pytest.mark.parametrize("kw", [
    dict(retain=10, max_increments_per_base=10),
    dict(retain=2, max_increments_per_base=10),
    dict(retain=10, max_increments_per_base=2, compact_in_background=False),
], ids=["chain", "retention", "compaction"])
def test_storage_behaves_alike(tmp_path, kw):
    (jcuts, _jf, _jo), (pcuts, _pf, _po) = _runs("device")
    js = _store_chain(jinc, tmp_path / "j", jcuts, **kw)
    ps = _store_chain(pinc, tmp_path / "p", pcuts, **kw)
    assert ps.checkpoint_ids() == js.checkpoint_ids()
    assert ps.compactions == js.compactions
    assert ps.shared_blob_count() == js.shared_blob_count()
    for cid in ps.checkpoint_ids():
        assert ps.chain_length(cid) == js.chain_length(cid)
        for k in ("delta", "new_blobs", "referenced_blobs"):
            assert ps.metadata(cid).get(k) == js.metadata(cid).get(k)
        tree_equal(_fixed(ps.load(cid)["w"], "port"),
                   _fixed(js.load(cid)["w"], "jax"))


def test_corruption_falls_back_alike(tmp_path):
    (jcuts, _jf, _jo), (pcuts, _pf, _po) = _runs("device")
    seen = []
    for inc_mod, cuts, root, err in ((jinc, jcuts, tmp_path / "j", JCE),
                                     (pinc, pcuts, tmp_path / "p",
                                      CorruptCheckpointError)):
        storage = _store_chain(inc_mod, root, cuts, retain=10,
                               max_increments_per_base=10)
        last = storage.checkpoint_ids()[-1]
        path = root / f"chk-{last}" / "snapshot.pkl"
        path.write_bytes(path.read_bytes()[:-7])        # a torn write
        with pytest.raises(err):
            storage.load(last)
        blob = sorted((root / "shared").iterdir())[0]
        blob.write_bytes(b"\0" + blob.read_bytes()[1:])  # a flipped byte
        ok = []
        for cid in storage.checkpoint_ids():
            try:
                storage.load(cid)
                ok.append(cid)
            except err:
                pass
        seen.append((ok, storage.load_latest() is None))
    assert seen[0] == seen[1]


def test_a_directory_jax_wrote_loads_in_the_port(tmp_path):
    (jcuts, _jf, _jo), _ = _runs("device")
    js = _store_chain(jinc, tmp_path, jcuts, retain=10,
                      max_increments_per_base=10)
    ps = pinc.IncrementalCheckpointStorage(str(tmp_path), retain=10)
    payload = (tmp_path / "chk-1" / "snapshot.pkl").read_bytes()
    assert b"flink_tpu.runtime.checkpoint.incremental" in payload
    for cid in js.checkpoint_ids():
        tree_equal(ps.load(cid), js.load(cid))
    tree_equal(ps.load_latest(), js.load_latest())
    # the loaded state restores into the port's operator
    op = _op("port", "device")
    op.restore_state(interop.snapshot_from_jax(ps.load_latest()["w"]))
    assert op.key_index.num_keys == _runs("device")[1][2].key_index.num_keys


# ---------------------------------------------------------------------------
# job checkpoints: the MiniCluster's tree, both ways
# ---------------------------------------------------------------------------

def _job(env_cls, rows, **env_kw):
    from flink_tpu_torch.windowing import TumblingEventTimeWindows as PT
    env = env_cls(**env_kw)
    env.set_parallelism(2)
    if env_cls is JaxEnv:
        win, agg = JaxTumb.of(1000), JaxSum(jnp.float32)
    else:
        win, agg = PT.of(1000), SumAggregator(torch.float32)
    sink = (env.from_collection(columns=rows, timestamp_column="t",
                                batch_size=100)
            .assign_timestamps_and_watermarks(0, timestamp_column="t")
            .key_by("k").window(win).aggregate(agg, value_column="v")
            .collect())
    return env, sink


def _rows(seed=5, n=3000):
    rng = np.random.default_rng(seed)
    return {"k": rng.integers(0, 40, n).astype(np.int64),
            "v": rng.random(n).astype(np.float32),
            "t": np.sort(rng.integers(0, 6000, n)).astype(np.int64)}


def _final(sink):
    return {(int(r["k"]), int(r["window_start"])): r["result"]
            for r in sink.rows()}


def _checkpoint_of(env_cls, storage_cls, chaos, tmp, **env_kw):
    """A MiniCluster checkpoint of the job on the first half of the input
    (each subtask step slowed by 3 ms, so periodic checkpoints complete
    while it runs); a restore of it on the whole input resumes after the
    source offsets it holds."""
    rows = _rows()
    half = {k: v[:1500] for k, v in rows.items()}
    env, _sink = _job(env_cls, half, **env_kw)
    storage = storage_cls(str(tmp), retain=100)
    inj = chaos.FaultInjector(seed=1)
    inj.inject("subtask.run", chaos.DelayBy(0.003))
    with chaos.installed(inj):
        res = env.execute_cluster(storage=storage, checkpoint_interval_ms=10,
                                  timeout_s=60)
    assert res.state == "FINISHED" and res.completed_checkpoints
    return storage.load(res.completed_checkpoints[0])


@pytest.mark.parametrize("direction", ["jax-to-port", "port-to-jax"])
def test_job_checkpoint_crosses_and_restores(tmp_path, direction):
    from flink_tpu.runtime.checkpoint.storage import \
        FileCheckpointStorage as JFile
    from flink_tpu_torch.runtime.checkpoint.storage import \
        FileCheckpointStorage as PFile
    if direction == "jax-to-port":
        tree = _checkpoint_of(JaxEnv, JFile, jchaos, tmp_path)
        moved = interop.job_checkpoint_from_jax(tree)
        env, sink = _job(StreamExecutionEnvironment, _rows(), device="cpu")
        twin = tree
        tenv, tsink = _job(JaxEnv, _rows())
    else:
        tree = _checkpoint_of(StreamExecutionEnvironment, PFile, pchaos,
                              tmp_path, device="cpu")
        moved = interop.job_checkpoint_to_jax(tree, batch_module=jbatch)
        env, sink = _job(JaxEnv, _rows())
        twin = tree
        tenv, tsink = _job(StreamExecutionEnvironment, _rows(),
                           device="cpu")
    assert tree is not None and "__job__" in tree
    assert env.execute_cluster(restore=moved, timeout_s=60).state == \
        "FINISHED"
    assert tenv.execute_cluster(restore=twin, timeout_s=60).state == \
        "FINISHED"
    got, want = _final(sink), _final(tsink)
    assert got.keys() == want.keys()
    for k in want:
        assert np.float32(got[k]).tobytes() == np.float32(want[k]).tobytes()


def test_job_checkpoint_channel_state_elements_cross():
    """Persisted in-flight elements (unaligned checkpoints) are rebuilt as
    the receiving package's stream elements."""
    tree = {"__job__": {"checkpoint_id": 3}, "w": {"subtasks": [{
        "operator": {}, "channel_state": {
            "version": 2, "unaligned": True,
            "elements": [(0, jbatch.RecordBatch(
                {"k": np.arange(3), "v": np.ones(3, np.float32)},
                timestamps=np.arange(3))),
                (1, jbatch.Watermark(17))]}}]}}
    moved = interop.job_checkpoint_from_jax(tree)
    els = moved["w"]["subtasks"][0]["channel_state"]["elements"]
    assert isinstance(els[0][1], pbatch.RecordBatch)
    assert els[0][1].to_rows() == tree["w"]["subtasks"][0][
        "channel_state"]["elements"][0][1].to_rows()
    assert els[1] == (1, pbatch.Watermark(17))
    back = interop.job_checkpoint_to_jax(moved, batch_module=jbatch)
    assert isinstance(back["w"]["subtasks"][0]["channel_state"]["elements"]
                      [0][1], jbatch.RecordBatch)
    with pytest.raises(ValueError, match="core.batch"):
        interop.job_checkpoint_to_jax(moved)


def test_minicluster_incremental_end_to_end(tmp_path):
    """``test_incremental_checkpoints.py``'s MiniCluster case in both
    packages.  The reference checks its size bound on the LAST incremental
    cut; that cut may land after the end-of-input fire (a source emits its
    final watermark before it takes a trigger already queued), when the
    collect sink's rows ride the cut in full, in either package.  So the
    bound is held on the last steady cut: the last incremental cut whose state
    size is no larger than an earlier cut's."""
    rng = np.random.default_rng(7)
    keys = np.concatenate([np.repeat(np.arange(5000), 2),
                           rng.integers(0, 100, 50_000)])
    vals = np.ones(len(keys), np.float32)
    ts = np.full(len(keys), 100, np.int64)
    for side in ("jax", "port"):
        inc_mod = jinc if side == "jax" else pinc
        storage = inc_mod.IncrementalCheckpointStorage(
            str(tmp_path / side), retain=4, max_increments_per_base=4)
        if side == "jax":
            env = JaxEnv()
            agg = JaxSum(jnp.float32)
            from flink_tpu.windowing.assigners import \
                TumblingEventTimeWindows as W
        else:
            env = StreamExecutionEnvironment(device="cpu")
            agg = SumAggregator(torch.float32)
            W = TumblingEventTimeWindows
        env.set_parallelism(2)
        sink = (env.from_collection(columns={"k": keys, "v": vals, "t": ts},
                                    batch_size=128)
                .assign_timestamps_and_watermarks(0, timestamp_column="t")
                .key_by("k").window(W.of(1000))
                .aggregate(agg, value_column="v").collect())
        res = env.execute_cluster(storage=storage, checkpoint_interval_ms=5,
                                  incremental=True, timeout_s=120)
        assert res.state == "FINISHED"
        stats = env._last_cluster._checkpoint_stats
        incs = [s for s in stats if s.get("incremental")]
        assert incs, f"no incremental cuts in {len(stats)} checkpoints"
        # the last incremental cut of the plateau: its state no larger than
        # an earlier cut's (the growth phase's cuts and a cut after the
        # end-of-input fire, which adds the sink's rows, are bigger)
        steady, peak = None, 0
        for s in stats:
            if s.get("incremental") and s["state_size_bytes"] <= peak:
                steady = s
            peak = max(peak, s["state_size_bytes"])
        assert steady is not None, stats
        assert steady["delta_bytes"] <= 0.25 * steady["state_size_bytes"], \
            steady
        snap = storage.load_latest()
        has_inc = (jdelta if side == "jax" else pdelta).tree_has_increment
        assert snap is not None and not has_inc(snap)
        assert sum(r["result"] for r in sink.rows()) == len(keys)


def test_checkpoint_package_exports_what_jax_exports():
    import flink_tpu.runtime.checkpoint as jck
    import flink_tpu_torch.runtime.checkpoint as pck
    assert pck.__all__ == jck.__all__
    assert all(hasattr(pck, name) for name in pck.__all__)


def test_execute_cluster_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    env = StreamExecutionEnvironment()
    env.from_collection(columns={"k": np.arange(3)}).collect()
    with pytest.raises(RuntimeError, match="CUDA"):
        env.execute_cluster()


def test_interop_refuses_a_foreign_increment_kind():
    with pytest.raises(ValueError, match="window_delta"):
        interop.window_delta_from_jax({"__increment__": 1,
                                       "kind": "changelog"})
    with pytest.raises(ValueError, match="changelog increment"):
        interop.changelog_increment_to_jax({"__increment__": 1,
                                            "kind": "window_delta"})
