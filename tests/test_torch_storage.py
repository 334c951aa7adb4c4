"""Port parity for checkpoint storage: ``flink_tpu_torch.runtime.checkpoint.
storage`` against ``flink_tpu.runtime.checkpoint.storage``.

- The storage cases of ``tests/test_checkpoint.py``
  (``test_file_storage_roundtrip``, ``test_savepoint_write_read``).
- The storage cases of ``tests/test_chaos.py``: the retrying storage (its
  backoff, its give-up, no retry of corruption) and the file commit
  protocol (torn writes, checksums, unreadable metadata, a crash before the
  publish), under the port's chaos schedules (``testing/chaos.py``; a crash
  at the first firing is ``ActionSequence(["fail"])``, JAX's
  ``CrashOnceAt(1)``).  Each runs through both packages; the outcomes
  (retries, sleeps, fault histories, what loads) must be the same.
- Files cross packages: a checkpoint of the port's device-tier
  ``WindowAggOperator`` stored by the port loads in JAX's storage and
  restores into JAX's operator (``interop.snapshot_to_jax``), which fires
  what the port fires, and the other way round.  A tree holding torch
  tensors is stored as numpy: the pickle holds no torch object.
"""

import contextlib
import os
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.experimental
import jax.numpy as jnp

from flink_tpu.core import functions as jfn
from flink_tpu.core.batch import RecordBatch as JaxBatch
from flink_tpu.core.batch import Watermark as JaxWatermark
from flink_tpu.operators.window_agg import WindowAggOperator as JaxOp
from flink_tpu.runtime.checkpoint import storage as jst
from flink_tpu.testing import chaos as jchaos
from flink_tpu.windowing import TumblingEventTimeWindows as JaxTumbling
from flink_tpu_torch.core import functions as pfn
from flink_tpu_torch.core.batch import RecordBatch, Watermark
from flink_tpu_torch.interop import snapshot_from_jax, snapshot_to_jax
from flink_tpu_torch.operators.window_agg import WindowAggOperator
from flink_tpu_torch.runtime.checkpoint import storage as pst
from flink_tpu_torch.testing import chaos as pchaos
from flink_tpu_torch.windowing import TumblingEventTimeWindows

SIDES = {"jax": (jst, jchaos), "port": (pst, pchaos)}


@contextlib.contextmanager
def _jax_x64():
    with pytest.MonkeyPatch.context() as mp:
        if not hasattr(jax.experimental, "enable_x64"):
            mp.setattr(jax.experimental, "enable_x64",
                       lambda new_val=True: jax.enable_x64(new_val),
                       raising=False)
        yield


@pytest.fixture(autouse=True)
def _no_injector():
    yield
    jchaos.uninstall()
    pchaos.uninstall()


def both(fn, *args):
    """``fn(storage_module, chaos_module, *args)`` in each package; the two
    results must be equal."""
    out = [fn(*SIDES[s], *args) for s in ("jax", "port")]
    assert out[0] == out[1], out
    return out[1]


def _tree_equal(a, b):
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(_tree_equal(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(_tree_equal(x, y) for x, y in zip(a, b)))
    if isinstance(a, np.ndarray):
        return (isinstance(b, np.ndarray) and a.dtype == b.dtype
                and a.shape == b.shape
                and (a.tolist() == b.tolist() if a.dtype == object
                     else a.tobytes() == b.tobytes()))
    return type(a) is type(b) and a == b


SNAP = {"op-a": {"x": np.arange(5), "nested": {"y": np.ones((2, 3))},
                 "scalar": 7, "none": None, "pair": (1, [2.5, "s"])},
        "op-b": {"keys": {"raw": np.asarray(["a", "b"], object)}}}


def test_file_storage_roundtrip(tmp_path):
    def run(st_mod, _chaos, root):
        st = st_mod.FileCheckpointStorage(root, retain=2)
        for cid in (1, 2, 3):
            st.store(cid, SNAP)
        back = st.load(3)
        assert _tree_equal(back, SNAP)
        return st.checkpoint_ids(), st.metadata(3)["checkpoint_id"]

    assert run(pst, pchaos, str(tmp_path / "p")) == ([2, 3], 3)
    assert run(jst, jchaos, str(tmp_path / "j")) == ([2, 3], 3)
    # the files cross: each package loads the other's checkpoint
    assert _tree_equal(jst.FileCheckpointStorage(str(tmp_path / "p")).load(3),
                       SNAP)
    assert _tree_equal(pst.FileCheckpointStorage(str(tmp_path / "j")).load(3),
                       SNAP)
    pm = pst.FileCheckpointStorage(str(tmp_path / "p")).metadata(3)
    jm = jst.FileCheckpointStorage(str(tmp_path / "j")).metadata(3)
    assert [(e["uid"], e["file"], e["crc32"], e["size"])
            for e in pm["operators"]] == \
        [(e["uid"], e["file"], e["crc32"], e["size"])
         for e in jm["operators"]]


def test_in_memory_storage_retention_and_copies():
    def run(st_mod, _chaos):
        st = st_mod.InMemoryCheckpointStorage(retain=2)
        snap = {"op": {"x": np.arange(3)}}
        for cid in (4, 5, 6):
            st.store(cid, snap)
        snap["op"]["x"][0] = 99              # the store deep-copied
        back = st.load_latest()
        back["op"]["x"][1] = 77              # and hands out copies
        return st.checkpoint_ids(), st.load(6)["op"]["x"].tolist()

    assert both(run) == ([5, 6], [0, 1, 2])


def test_torch_tensors_are_stored_as_numpy(tmp_path):
    """``_to_numpy`` downloads tensors: the pickled files hold numpy only,
    so JAX's storage loads them."""
    t = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    snap = {"op": {"t": t, "list": [torch.ones(2, dtype=torch.int64), 3],
                   "tup": (torch.zeros(1, dtype=torch.bool),)}}
    st = pst.FileCheckpointStorage(str(tmp_path))
    st.store(1, snap)
    payload = open(os.path.join(str(tmp_path), "chk-1", "op-0.pkl"),
                   "rb").read()
    assert b"torch" not in payload
    back = jst.FileCheckpointStorage(str(tmp_path)).load(1)["op"]
    assert back["t"].dtype == np.float32 and back["t"].tolist() == \
        t.tolist()
    assert back["list"][0].dtype == np.int64 and back["list"][1] == 3
    assert back["tup"][0].dtype == np.bool_
    assert pst._to_numpy(t.requires_grad_()).dtype == np.float32


# ---------------------------------------------------------------------------
# RetryingCheckpointStorage (tests/test_chaos.py's fast tier)
# ---------------------------------------------------------------------------

def test_retrying_storage_absorbs_transient_flakes():
    def run(st_mod, chaos):
        inj = chaos.install(chaos.FaultInjector())
        inj.inject("checkpoint.store", chaos.FailTimes(2))
        sleeps = []
        st = st_mod.RetryingCheckpointStorage(
            st_mod.InMemoryCheckpointStorage(), max_attempts=3,
            initial_backoff_ms=10, sleep=sleeps.append)
        st.store(1, {"op": {"total": 1.0}})
        out = (st.retries, sleeps, st.load_latest(),
               inj.history("checkpoint.store"))
        chaos.uninstall()
        return out

    assert both(run) == (2, [0.01, 0.02], {"op": {"total": 1.0}},
                         ["fail", "fail", "ok"])


def test_retrying_storage_backoff_is_capped():
    def run(st_mod, chaos):
        inj = chaos.install(chaos.FaultInjector())
        inj.inject("checkpoint.store", chaos.FailTimes(4))
        sleeps = []
        st = st_mod.RetryingCheckpointStorage(
            st_mod.InMemoryCheckpointStorage(), max_attempts=5,
            initial_backoff_ms=100, multiplier=10.0, max_backoff_ms=250,
            sleep=sleeps.append)
        st.store(1, {"op": {}})
        chaos.uninstall()
        return sleeps

    assert both(run) == [0.1, 0.25, 0.25, 0.25]


def test_retrying_storage_gives_up_past_max_attempts():
    def run(st_mod, chaos):
        inj = chaos.install(chaos.FaultInjector())
        inj.inject("checkpoint.store", chaos.FailTimes(10))
        st = st_mod.RetryingCheckpointStorage(
            st_mod.InMemoryCheckpointStorage(), max_attempts=3,
            sleep=lambda s: None)
        with pytest.raises(chaos.InjectedFault):
            st.store(1, {"op": {}})
        out = inj.fired("checkpoint.store")
        chaos.uninstall()
        with pytest.raises(ValueError, match="max_attempts"):
            st_mod.RetryingCheckpointStorage(st, max_attempts=0)
        return out

    assert both(run) == 3


def test_retrying_storage_never_retries_corruption(tmp_path):
    def run(st_mod, _chaos, root):
        st = st_mod.FileCheckpointStorage(root)
        st.store(1, {"op": {"x": 1}})
        path = os.path.join(root, "chk-1", st.metadata(1)["operators"][0]
                            ["file"])
        with open(path, "r+b") as f:
            f.truncate(4)                        # torn write
        attempts = []
        wrapped = st_mod.RetryingCheckpointStorage(st, max_attempts=5,
                                                   sleep=attempts.append)
        with pytest.raises(st_mod.CorruptCheckpointError):
            wrapped.load(1)
        # metadata() passes through un-retried
        return attempts, wrapped.metadata(1)["checkpoint_id"]

    assert run(jst, jchaos, str(tmp_path / "j")) == \
        run(pst, pchaos, str(tmp_path / "p")) == ([], 1)


# ---------------------------------------------------------------------------
# the FileCheckpointStorage commit protocol
# ---------------------------------------------------------------------------

def _file_of(st, cid, idx=0):
    return os.path.join(st.base_dir, f"chk-{cid}",
                        st.metadata(cid)["operators"][idx]["file"])


def _per_side(tmp_path, run):
    out = [run(*SIDES[s], str(tmp_path / s)) for s in ("jax", "port")]
    assert out[0] == out[1], out
    return out[1]


def test_torn_checkpoint_is_skipped_by_load_latest(tmp_path):
    def run(st_mod, _chaos, root):
        st = st_mod.FileCheckpointStorage(root)
        st.store(1, {"op": {"total": 1.0}})
        st.store(2, {"op": {"total": 2.0}})
        with open(_file_of(st, 2), "r+b") as f:
            f.truncate(8)                        # a torn write survives
        with pytest.raises(st_mod.CorruptCheckpointError, match="torn"):
            st.load(2)
        return st.load_latest()

    assert _per_side(tmp_path, run) == {"op": {"total": 1.0}}


def test_checksum_mismatch_detected(tmp_path):
    def run(st_mod, _chaos, root):
        st = st_mod.FileCheckpointStorage(root)
        st.store(1, {"op": {"total": 7.0}})
        path = _file_of(st, 1)
        data = bytearray(open(path, "rb").read())
        data[-1] ^= 0xFF                         # same size, flipped bits
        open(path, "wb").write(bytes(data))
        with pytest.raises(st_mod.CorruptCheckpointError, match="checksum"):
            st.load(1)
        return st.load_latest()

    assert _per_side(tmp_path, run) is None


def test_unreadable_metadata_is_corrupt_not_fatal(tmp_path):
    def run(st_mod, _chaos, root):
        st = st_mod.FileCheckpointStorage(root)
        st.store(1, {"op": {"total": 1.0}})
        st.store(2, {"op": {"total": 2.0}})
        with open(os.path.join(root, "chk-2", "_metadata.json"), "w") as f:
            f.write("{ torn json")
        with pytest.raises(st_mod.CorruptCheckpointError, match="metadata"):
            st.load(2)
        return st.load_latest()

    assert _per_side(tmp_path, run) == {"op": {"total": 1.0}}


def test_crash_mid_write_leaves_only_staging_dir(tmp_path):
    def run(st_mod, chaos, root):
        inj = chaos.install(chaos.FaultInjector())
        st = st_mod.FileCheckpointStorage(root)
        st.store(1, {"op": {"total": 1.0}})
        # a crash at the store's fault point: nothing of chk-2 is visible
        inj.inject("checkpoint.store", chaos.ActionSequence(["fail"]))
        with pytest.raises(chaos.InjectedFault):
            st.store(2, {"op": {"total": 2.0}})
        chaos.uninstall()
        ids = st.checkpoint_ids()
        latest = st.load_latest()
        os.makedirs(os.path.join(root, "chk-3.inprogress"))
        return ids, latest, st.checkpoint_ids()

    assert _per_side(tmp_path, run) == ([1], {"op": {"total": 1.0}}, [1])


def test_load_fault_point_and_newer_format(tmp_path):
    def run(st_mod, chaos, root):
        st = st_mod.FileCheckpointStorage(root)
        st.store(1, {"op": {"v": 1}})
        inj = chaos.install(chaos.FaultInjector())
        inj.inject("checkpoint.load", chaos.FailTimes(1))
        with pytest.raises(chaos.InjectedFault):
            st.load(1)
        out = st.load(1)
        chaos.uninstall()
        meta = os.path.join(root, "chk-1", "_metadata.json")
        text = open(meta).read().replace('"version": 1', '"version": 9')
        open(meta, "w").write(text)
        with pytest.raises(ValueError, match="too new"):
            st.load(1)
        return out

    assert _per_side(tmp_path, run) == {"op": {"v": 1}}


# ---------------------------------------------------------------------------
# savepoints and operator checkpoints across packages
# ---------------------------------------------------------------------------

def _op(side):
    common = dict(key_column="k", value_column="v", emit_tier="device",
                  snapshot_source="device", device_sync="scatter",
                  device_probe="on", native_shards=1, pipeline_depth=0)
    if side == "jax":
        with _jax_x64():
            op = JaxOp(JaxTumbling.of(1000), jfn.SumAggregator(jnp.float32),
                       **common)
            op.open(jfn.RuntimeContext())
        return op
    op = WindowAggOperator(TumblingEventTimeWindows.of(1000),
                           pfn.SumAggregator(torch.float32), device="cpu",
                           **common)
    op.open(pfn.RuntimeContext())
    return op


def _feed(side, op, keys, vals, ts, wm=None):
    RB, WM = (JaxBatch, JaxWatermark) if side == "jax" else (RecordBatch,
                                                              Watermark)
    with _jax_x64() if side == "jax" else contextlib.nullcontext():
        out = op.process_batch(RB({"k": np.asarray(keys),
                                   "v": np.asarray(vals, np.float32)},
                                  timestamps=np.asarray(ts, np.int64)))
        if wm is not None:
            out += op.process_watermark(WM(wm))
    return out


def _collect(elements):
    rows = {}
    for b in elements:
        for i in range(len(b)):
            rows[(int(np.asarray(b.column("k"))[i]),
                  int(np.asarray(b.column("window_start"))[i]))] = \
                np.asarray(b.column("result"))[i].tobytes()
    return rows


def test_savepoint_write_read(tmp_path):
    op = _op("port")
    _feed("port", op, [1, 2, 3], [1.0, 2.0, 3.0], [10, 20, 30])
    p = pst.write_savepoint(str(tmp_path / "sp"), {"win": op.snapshot_state()})
    assert p.endswith("chk-1")
    for back in (pst.read_savepoint(p), pst.read_savepoint(str(tmp_path /
                                                                "sp"))):
        assert "win" in back
        op2 = _op("port")
        op2.restore_state(back["win"])
        out = op2.process_watermark(Watermark(5000))
        assert {k: np.frombuffer(v, np.float32)[0] for k, v in
                _collect(out).items()} == {(1, 0): 1.0, (2, 0): 2.0,
                                           (3, 0): 3.0}
    assert pst.write_savepoint(str(tmp_path / "sp"), {"win": {}}) \
        .endswith("chk-2")
    with pytest.raises(FileNotFoundError):
        pst.read_savepoint(str(tmp_path / "none"))


def _stream():
    rng = np.random.default_rng(17)
    out = []
    for i in range(6):
        keys = rng.integers(0, 300, 500).astype(np.int64)
        vals = rng.standard_normal(500).astype(np.float32)
        ts = (i * 400 + np.sort(rng.integers(0, 400, 500))).astype(np.int64)
        out.append((keys, vals, ts, i * 400 + 399))
    return out


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_operator_checkpoint_crosses_packages(tmp_path, writer):
    """A device-tier window checkpoint stored by one package's
    FileCheckpointStorage loads in the other's, restores into the other's
    operator and fires, bit for bit, what the writer's own restore fires."""
    reader = "jax" if writer == "port" else "port"
    st_w = SIDES[writer][0].FileCheckpointStorage(str(tmp_path), retain=5)
    stream = _stream()
    op = _op(writer)
    for keys, vals, ts, wm in stream[:3]:
        _feed(writer, op, keys, vals, ts, wm)
    with _jax_x64() if writer == "jax" else contextlib.nullcontext():
        snap = op.snapshot_state()
    st_w.store(7, {"win": snap, "__sources__": {"src": {"offset": 3}}})

    loaded = SIDES[reader][0].FileCheckpointStorage(str(tmp_path)).load(7)
    assert loaded["__sources__"] == {"src": {"offset": 3}}
    conv = snapshot_to_jax if reader == "jax" else snapshot_from_jax
    fires = {}
    for side, s in ((reader, conv(loaded["win"])), (writer, snap)):
        op2 = _op(side)
        with _jax_x64() if side == "jax" else contextlib.nullcontext():
            op2.restore_state(s)
        out = []
        for keys, vals, ts, wm in stream[3:]:
            out += _feed(side, op2, keys, vals, ts, wm)
        fires[side] = _collect(out)
    assert fires[reader] == fires[writer] and fires[reader]
