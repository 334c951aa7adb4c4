"""Port parity for the queryable serving tier: the reference's cases of
``tests/test_queryable_serving.py``, ``test_queryable_scale.py`` and the
two queryable cases of ``test_state_processor.py``, run through both
packages with the harness of ``tests/test_torch_cluster_cases.py``, each
keeping its reference marks.
"""

import pytest

from test_torch_calibration import verdicts  # noqa: F401 — the fixture
from test_torch_cluster_cases import cases, check_case


@pytest.mark.parametrize(
    "ref, cls, fn_name, params",
    cases(("test_queryable_serving", "test_queryable_scale"), marks=True)
    + cases({"test_state_processor": ("test_queryable_state_live_lookup",
                                      "test_queryable_lookup_never_inserts")},
            marks=True))
def test_reference_case(ref, cls, fn_name, params, tmp_path_factory,
                        verdicts):  # noqa: F811 — the fixture
    check_case(ref, cls, fn_name, params, tmp_path_factory, verdicts)


# ---------------------------------------------------------------------------
# the port's own cases: one seeded stream through both packages
# ---------------------------------------------------------------------------

import numpy as np  # noqa: E402

import flink_tpu.queryable as jq  # noqa: E402
import flink_tpu.queryable.wire as jwire  # noqa: E402
import flink_tpu_torch.queryable as pq  # noqa: E402
import flink_tpu_torch.queryable.wire as pwire  # noqa: E402
from test_torch_calibration import _jax_x64  # noqa: E402
from test_torch_mesh import SIDES, _mk  # noqa: E402

N_KEYS = 6000
#: the lookup keys: every key of the stream and 64 it never saw
LOOKUP = np.arange(N_KEYS + 64, dtype=np.int64)
#: (mesh blocks, tier, paging) of each lane
LANES = {"host": (1, "host", None), "device": (1, "device", None),
         "paged": (1, "device", dict(capacity=2048)),
         "mesh4": (4, "device", None)}
PKG = {"jax": jq, "port": pq}
WIRE = {"jax": jwire, "port": pwire}


@pytest.fixture
def pinned(verdicts):  # noqa: F811 — the fixture
    """Every verdict pinned (none measured) and restored; both packages'
    monitors put back."""
    verdicts(taxed=False, shards=1, super_shards=1, depth=1, probe=False)
    prev = {s: S["dh"].get_monitor(create=False) for s, S in SIDES.items()}
    yield
    for s, S in SIDES.items():
        S["dh"].set_monitor(prev[s])


def _op(side, lane):
    D, tier, paging = LANES[lane]
    return _mk(side, D, tier, paging=paging, queryable="sums")


def _columnar(found, cols, tags):
    """An answer by its bytes: the found plane, each column's dtype and
    bytes, the tags."""
    return (np.asarray(found).tobytes(),
            {c: (str(a.dtype), np.ascontiguousarray(a).tobytes())
             for c, a in cols.items()}, tags)


def _drive(side, lane, n_batches=6, B=4096, seed=11, snap_at=3):
    """The seeded stream (``N_KEYS`` uniform keys, random f32 values, a
    watermark after each batch) through one package's operator with
    ``queryable=``.  After each call that fires, the view answers every
    lookup key, and each key of the newest window's fire batches must read
    that batch's row.  Returns (answers, snapshot, operator)."""
    S = SIDES[side]
    op = _op(side, lane)
    view = op.queryable_view()
    rng = np.random.default_rng(seed)
    answers, snap = [], None

    def after(out):
        fired = [b for b in out if hasattr(b, "columns")
                 and "result" in b.columns]
        if not fired:
            return
        newest = max(int(np.asarray(b.column("window_start"))[0])
                     for b in fired)
        for b in fired:
            if int(np.asarray(b.column("window_start"))[0]) != newest:
                continue
            keys = np.asarray(b.column("k"))
            found, cols, _ = view.lookup_batch_columnar(keys)
            assert found.all()
            np.testing.assert_array_equal(
                cols["result"].view(np.uint8),
                np.asarray(b.column("result")).view(np.uint8))
            assert (cols["window_start"] == newest).all()
        answers.append(_columnar(*view.lookup_batch_columnar(LOOKUP)))
        found, values, tags = view.lookup_batch(LOOKUP[::97].tolist())
        answers.append((found.tolist(), values, tags))

    for i in range(n_batches):
        k = rng.integers(0, N_KEYS, B).astype(np.int64)
        v = rng.random(B).astype(np.float32)
        ts = i * 500 + np.sort(rng.integers(0, 500, B)).astype(np.int64)
        after(op.process_batch(S["RB"]({"k": k, "v": v}, timestamps=ts)))
        after(op.process_watermark(S["WM"](int(ts.max()) - 1)))
        if i == snap_at:
            after(op.prepare_snapshot_pre_barrier())
            snap = op.snapshot_state()
            op.notify_checkpoint_complete(1)
    after(op.end_input())
    assert view.published_windows >= 3
    return answers, snap, op


def _run_side(side, lane):
    if side == "jax":
        with _jax_x64():
            return _drive(side, lane)
    return _drive(side, lane)


@pytest.mark.parametrize("lane", list(LANES))
def test_live_answers_equal_jax(lane, pinned):
    """Live lookups after every fire: bit-equal across packages on the
    host tier, the device tier, the paged lane and 4 mesh blocks (values,
    found planes, window bounds and the watermark and checkpoint tags), and
    each equal to the fire's own rows (checked inside the drive)."""
    want, _, _ = _run_side("jax", lane)
    got, _, _ = _run_side("port", lane)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, f"answer {i} differs"


def _replica(side, op):
    spec = PKG[side].QueryableStateSpec.from_operator("sums", "w", op)
    return PKG[side].CheckpointReplica(spec)


@pytest.mark.parametrize("lane", ["host", "device", "mesh4"])
def test_replica_answers_equal_across_packages(lane, pinned):
    """Each package's replica ingests each package's snapshot (the port's
    adopts JAX's as it is, through ``interop``'s key tables): the four
    checkpoint-consistency answers are bit-equal."""
    runs = {s: _run_side(s, lane) for s in ("jax", "port")}
    got = {}
    for rside in ("jax", "port"):
        for sside in ("jax", "port"):
            rep = _replica(rside, runs[rside][2])
            assert rep.ingest_assembled(
                7, {"w": {"subtasks": [runs[sside][1]]}})
            got[rside, sside] = _columnar(*rep.lookup_batch_columnar(LOOKUP))
            assert rep.lookup_batch(LOOKUP[::101])[0].any()
    first = got["jax", "jax"]
    assert np.frombuffer(first[0], np.uint8).sum() > N_KEYS // 2
    for key, ans in got.items():
        assert ans == first, key


def _wire_cases():
    rng = np.random.default_rng(5)
    n = 257
    found = rng.random(n) < 0.7
    cols = {"result": rng.random(n).astype(np.float32),
            "count": rng.integers(-2**40, 2**40, n).astype(np.int64),
            "flag": rng.random(n) < 0.5,
            "small": rng.integers(0, 200, n).astype(np.uint8),
            "name": np.asarray([f"k{i}" if i % 3 else None
                                for i in range(n)], object)}
    cols["result"][:3] = [np.nan, -0.0, np.inf]
    tags = {"watermark": 4999, "checkpoint_id": None,
            "window_start": 0, "window_end": 5000}
    return found, cols, tags


@pytest.mark.parametrize("what", ["int_request", "object_request",
                                  "response", "error"])
def test_wire_bytes_equal_across_packages(what):
    """The binary columnar codec writes the same bytes in both packages,
    and each decodes the other's."""
    found, cols, tags = _wire_cases()
    if what == "int_request":
        args = ("sums", np.arange(-5, 300, dtype=np.int64), "checkpoint")
        enc = "encode_request"
    elif what == "object_request":
        args = ("sums", ["a", 3, 2.5, True], "live")
        enc = "encode_request"
    elif what == "response":
        args, enc = (found, cols, tags), "encode_response"
    else:
        args, enc = ("unknown state",), "encode_error"
    raw = {s: getattr(WIRE[s], enc)(*args) for s in WIRE}
    assert raw["jax"] == raw["port"]
    assert pwire.is_binary(raw["jax"]) and jwire.is_binary(raw["port"])
    if enc == "encode_request":
        st, keys, cons = pwire.decode_request(raw["jax"])
        jst, jkeys, jcons = jwire.decode_request(raw["port"])
        assert (st, cons) == (jst, jcons) == (args[0], args[2])
        assert list(np.asarray(keys).tolist()) == \
            list(np.asarray(jkeys).tolist())
    elif enc == "encode_response":
        pf, pc, pt = pwire.decode_response(raw["jax"])
        jf, jc, jt = jwire.decode_response(raw["port"])
        assert pf.tobytes() == jf.tobytes() and pt == jt == tags
        for c in cols:
            if cols[c].dtype == object:
                assert list(pc[c]) == list(jc[c])
            else:
                assert pc[c].tobytes() == jc[c].tobytes() \
                    == cols[c].tobytes()
        assert pwire.values_from_columnar(pf, pc) == \
            jwire.values_from_columnar(jf, jc)


@pytest.mark.parametrize("server_side, client_side",
                         [("jax", "port"), ("port", "jax")])
@pytest.mark.parametrize("protocol", ["binary", "json"])
def test_clients_and_servers_cross_packages(server_side, client_side,
                                            protocol, pinned):
    """A client of one package reads a server of the other: live answers
    over the binary and JSON protocols, routed and not, equal what the
    server package's own client reads, and the columnar answers equal the
    view's bytes."""
    if server_side == "jax":
        with _jax_x64():
            _, _, op = _drive("jax", "device")
    else:
        _, _, op = _drive("port", "device")
    # no hot-key cache: a request the cache answers whole carries the tags
    # of an empty lookup (no watermark) in either package, so the second
    # client's answer would differ from the first's by the cache alone
    service = PKG[server_side].QueryableStateService(cache_enabled=False)
    service.register_views("sums", [op.queryable_view()], parallelism=1,
                           max_parallelism=128)
    server = service.start_server()
    try:
        keys = LOOKUP[::7]
        wf, wc, _ = op.queryable_view().lookup_batch_columnar(keys)
        for routing in (False, True):
            got = {}
            for side in (server_side, client_side):
                pool = PKG[side].QueryableStateClientPool(
                    "127.0.0.1", server.port, protocol=protocol,
                    routing=routing)
                try:
                    got[side] = pool.get_batch("sums", keys.tolist())
                    if protocol == "binary":
                        found, cols, _ = pool.get_batch_columnar("sums",
                                                                 keys)
                        assert found.tobytes() == wf.tobytes()
                        assert cols["result"].tobytes() == \
                            wc["result"].tobytes()
                finally:
                    pool.close()
            assert got[client_side] == got[server_side]
            assert got[client_side]["found"] == wf.tolist()
    finally:
        service.close()
