"""Port parity for the Kafka edge: the reference's cases of
``tests/test_kafka.py``, ``test_kafka_eos.py`` and ``test_kafka_v2.py``,
run through both packages with the harness of
``tests/test_torch_cluster_cases.py``, and the cross-package cases below.

The port's ``connectors/kafka.py`` and ``kafka_v2.py`` are JAX's host
Python: the same v0 message sets (CRC-32 over magic..value), v2 record
batches (CRC-32C through the port's ``native.crc32c`` over
``csrc/codec.cc``), broker logs and transaction records on disk, and the
same SCRAM-SHA-256 messages.  So a client, source or exactly-once sink of
one package works against a broker of the other, and the cases at the end
hold exactly that, both ways round.
"""

import json
import os

import numpy as np
import pytest

from test_torch_calibration import verdicts  # noqa: F401 — the fixture
from test_torch_cluster_cases import cases, check_case

REFERENCE_FILES = ("test_kafka", "test_kafka_eos", "test_kafka_v2")


@pytest.mark.parametrize("ref, cls, fn_name, params",
                         cases(REFERENCE_FILES, marks=True))
def test_reference_case(ref, cls, fn_name, params, tmp_path_factory,
                        verdicts):  # noqa: F811 — the fixture
    check_case(ref, cls, fn_name, params, tmp_path_factory, verdicts)


# ---------------------------------------------------------------------------
# the same bytes from both packages
# ---------------------------------------------------------------------------

def _packages():
    from flink_tpu.connectors import kafka as jk
    from flink_tpu.connectors import kafka_v2 as jv2
    from flink_tpu_torch.connectors import kafka as pk
    from flink_tpu_torch.connectors import kafka_v2 as pv2
    return {"jax": (jk, jv2), "port": (pk, pv2)}


def test_message_set_v0_bytes_equal():
    """A v0 message set (offsets, null and empty keys and values, CRC-32)
    encodes to the same bytes in both packages, and each decodes the
    other's."""
    pk = _packages()
    rng = np.random.default_rng(5)
    entries = [(i, None if i % 3 == 0 else rng.bytes(i % 7),
                b"" if i % 5 == 0 else rng.bytes(1 + i * 3))
               for i in range(40)]
    j = pk["jax"][0].encode_message_set(entries)
    p = pk["port"][0].encode_message_set(entries)
    assert j == p
    assert pk["port"][0].decode_message_set(j) == \
        pk["jax"][0].decode_message_set(p)


def test_record_batch_v2_bytes_equal():
    """A v2 record batch (varint deltas, headers, the transactional bit and
    its CRC-32C) encodes to the same bytes in both packages, and each
    decodes the other's."""
    pk = _packages()
    rng = np.random.default_rng(6)
    records = [(1_700_000_000_000 + int(rng.integers(0, 10_000)),
                None if i % 4 == 0 else rng.bytes(8),
                rng.bytes(int(rng.integers(0, 300))),
                [("h", rng.bytes(3)), ("n", None)] if i % 2 else [])
               for i in range(64)]
    for kw in ({}, {"producer_id": 7, "producer_epoch": 3,
                    "transactional": True}):
        j = pk["jax"][1].encode_record_batch(42, records, **kw)
        p = pk["port"][1].encode_record_batch(42, records, **kw)
        assert j == p
        assert pk["port"][1].decode_record_batches(j) == \
            pk["jax"][1].decode_record_batches(p)
        assert pk["port"][1].batch_producer_info(j) == \
            pk["jax"][1].batch_producer_info(p)
    from flink_tpu.native import crc32c as jcrc
    from flink_tpu_torch.native import crc32c as pcrc
    blob = rng.bytes(4099)
    assert pcrc(blob) == jcrc(blob)


def test_group_protocol_codec_equal():
    """The consumer group's embedded subscription and assignment encodings
    and the range assignor agree across packages."""
    pk = _packages()
    j, p = pk["jax"][1], pk["port"][1]
    topics = ["a", "bb", "topic-c"]
    parts = {"a": [0, 2, 5], "bb": [], "topic-c": [1]}
    assert j.encode_subscription(topics) == p.encode_subscription(topics)
    assert p.decode_subscription(j.encode_subscription(topics)) == topics
    assert j.encode_assignment(parts) == p.encode_assignment(parts)
    assert p.decode_assignment(j.encode_assignment(parts)) == \
        j.decode_assignment(p.encode_assignment(parts))
    members = [("m1", ["a", "bb"]), ("m0", ["a"]), ("m2", ["topic-c"])]
    counts = {"a": 5, "bb": 3, "topic-c": 2}
    assert j.range_assign(members, counts) == p.range_assign(members, counts)


@pytest.mark.parametrize("client_side", ["jax", "port"])
def test_scram_exchange_with_a_fixed_nonce(monkeypatch, client_side):
    """SCRAM-SHA-256 with the nonces and the salt fixed: one package's
    client against the other's server completes both proofs, and every
    message of the exchange is the same string in both packages."""
    import itertools

    from flink_tpu.security import scram as jscram
    from flink_tpu_torch.security import scram as pscram
    counter = itertools.count()

    def fixed_urandom(n):
        return bytes((next(counter) * 37 + i) % 256 for i in range(n))

    def exchange(client_mod, server_mod):
        monkeypatch.setattr(os, "urandom", fixed_urandom)
        cli = client_mod.ScramClient("al,ice=", "pässword")
        srv = server_mod.ScramServer(iterations=4096)
        first = cli.first()
        assert server_mod.ScramServer.username_of(first) == "al,ice="
        server_first = srv.first_response(first, "pässword")
        final = cli.final(server_first)
        ok, server_final = srv.verify_final(final)
        assert ok
        cli.verify(server_final)
        return first, server_first, final, server_final

    other = "port" if client_side == "jax" else "jax"
    mods = {"jax": jscram, "port": pscram}
    counter = itertools.count()
    mixed = exchange(mods[client_side], mods[other])
    counter = itertools.count()
    same = exchange(mods[other], mods[other])
    assert mixed == same
    # a wrong password fails the other package's proof check
    monkeypatch.setattr(os, "urandom", fixed_urandom)
    cli = mods[client_side].ScramClient("al,ice=", "wrong")
    srv = mods[other].ScramServer()
    final = cli.final(srv.first_response(cli.first(), "pässword"))
    assert srv.verify_final(final) == (False, "")


# ---------------------------------------------------------------------------
# one broker, the other package's clients
# ---------------------------------------------------------------------------

def _consume(client_mod, b, topic, part=0):
    c = client_mod.KafkaWireClient(b.host, b.port)
    try:
        out, off = [], 0
        hw = c.latest_offset(topic, part)
        while off < hw:
            msgs, _ = c.fetch(topic, part, off)
            for o, _k, v in msgs:
                if o >= hw:
                    break
                out.append(json.loads(v.decode()) if v else None)
                off = o + 1
        return out
    finally:
        c.close()


@pytest.mark.parametrize("broker_side", ["jax", "port"])
def test_clients_source_and_sink_against_the_other_broker(tmp_path,
                                                          broker_side):
    """A broker of one package serves the other's ``KafkaWireClient`` (v0
    produce and fetch, v2 produce and fetch, group membership), its
    ``KafkaWireSource`` in a keyed job and its ``KafkaExactlyOnceSink``
    (stage, commit on notify, replay on restore, fenced stale epoch)."""
    import importlib

    from flink_tpu_torch.core.batch import RecordBatch as PBatch
    from flink_tpu.core.batch import RecordBatch as JBatch
    pk = _packages()
    client_side = "port" if broker_side == "jax" else "jax"
    bk, _ = pk[broker_side]
    ck, cv2 = pk[client_side]
    batch_cls = PBatch if client_side == "port" else JBatch
    pkg = "flink_tpu_torch" if client_side == "port" else "flink_tpu"
    base = importlib.import_module(f"{pkg}.operators.base")
    api = importlib.import_module(f"{pkg}.datastream.api")
    b = bk.KafkaWireBroker(directory=str(tmp_path / "kafka"),
                           users={"alice": "s3cret"}).start()
    try:
        b.create_topic("in", partitions=2)
        b.create_topic("out", partitions=1)
        c = ck.KafkaWireClient(b.host, b.port, username="alice",
                               password="s3cret",
                               sasl_mechanism="SCRAM-SHA-256")
        rows = [{"k": i % 5, "v": float(i)} for i in range(200)]
        for p in range(2):
            c.produce("in", p, [(str(r["k"]).encode(),
                                 json.dumps(r).encode())
                                for r in rows[p::2][:60]])
            cv2.produce_v2(c, "in", p, [(1000 + i, None,
                                         json.dumps(r).encode(), [])
                                        for i, r in
                                        enumerate(rows[p::2][60:])])
        got = []
        for p in range(2):
            off = 0
            while True:
                recs, hw = cv2.fetch_v2(c, "in", p, off)
                if not recs:
                    break
                got += [json.loads(r[3]) for r in recs]
                off = recs[-1][0] + 1
        assert sorted(got, key=lambda r: r["v"]) == rows
        c.close()
    finally:
        b.stop()
    # the group, the source and the sink (they take no credentials)
    b = bk.KafkaWireBroker(directory=str(tmp_path / "kafka2")).start()
    try:
        b.create_topic("in", partitions=2)
        b.create_topic("out", partitions=1)
        c = ck.KafkaWireClient(b.host, b.port)
        for p in range(2):
            c.produce("in", p, [(None, json.dumps(r).encode())
                                for r in rows[p::2]])
        c.close()
        g = cv2.KafkaGroupConsumer(b.host, b.port, "grp", ["in"])
        assert g.join() == {"in": [0, 1]}
        g.commit({("in", 0): 7})
        assert g.committed([("in", 0)]) == {("in", 0): 7}
        g.leave()
        g.close()
        # the source in a keyed job of the client's package
        env = api.StreamExecutionEnvironment(
            **({"device": "cpu"} if client_side == "port" else {}))
        src = ck.KafkaWireSource(b.host, b.port, "in")
        out = env.from_source(src).key_by("k").sum("v").execute_and_collect()
        final = {}
        for r in out:
            final[int(r["k"])] = float(r["v"])
        want = {}
        for r in rows:
            want[r["k"]] = want.get(r["k"], 0.0) + r["v"]
        assert final == want

        # the exactly-once sink: staged until notify, replayed on restore
        sink = ck.KafkaExactlyOnceSink(b.host, b.port, "out", sink_id="x")
        sink.open(type("Ctx", (), {"subtask_index": 0})())
        sink.write_batch(batch_cls({"v": np.asarray([1, 2], np.int64)}))
        with base.snapshot_scope(1):
            snap = sink.snapshot_state()
        assert _consume(bk, b, "out") == []
        sink.write_batch(batch_cls({"v": np.asarray([3], np.int64)}))
        with base.snapshot_scope(2):
            sink.snapshot_state()
        del sink
        restored = ck.KafkaExactlyOnceSink(b.host, b.port, "out",
                                           sink_id="x")
        restored.open(type("Ctx", (), {"subtask_index": 0})())
        restored.restore_state(snap)
        assert sorted(r["v"] for r in _consume(bk, b, "out")) == [1, 2]
        restored.write_batch(batch_cls({"v": np.asarray([3], np.int64)}))
        with base.snapshot_scope(2):
            restored.snapshot_state()
        restored.fence_epoch = 5
        restored.notify_checkpoint_complete(2, epoch=4)
        assert restored.fenced_commits == 1
        assert sorted(r["v"] for r in _consume(ck, b, "out")) == [1, 2]
        restored.notify_checkpoint_complete(2, epoch=5)
        assert sorted(r["v"] for r in _consume(ck, b, "out")) == [1, 2, 3]
        restored.close()
    finally:
        b.stop()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_broker_directory_serves_the_other_package(tmp_path, writer):
    """A broker directory one package wrote (v0 and v2 logs, topic
    metadata, committed group offsets) restarts under the other package's
    broker and serves what the writer's own broker serves from a copy of
    it: every record, high watermark and committed offset."""
    import shutil
    pk = _packages()
    reader = "port" if writer == "jax" else "jax"
    d = str(tmp_path / "kafka")
    wk, wv2 = pk[writer]
    b = wk.KafkaWireBroker(directory=d).start()
    try:
        b.create_topic("t", partitions=2)
        c = wk.KafkaWireClient(b.host, b.port)
        c.produce("t", 0, [(b"a", b"v0-1"), (None, b"v0-2")])
        wv2.produce_v2(c, "t", 0, [(5, b"k", b"v2-1", [("h", b"x")])])
        c.produce("t", 1, [(None, b"p1")])
        g = wv2.KafkaGroupConsumer(b.host, b.port, "g", ["t"])
        g.join()
        g.commit({("t", 0): 2, ("t", 1): 1})
        g.leave()
        g.close()
        c.close()
    finally:
        b.stop()
    shutil.copytree(d, str(tmp_path / "copy"))

    def served(side, directory):
        k, v2 = pk[side]
        b2 = k.KafkaWireBroker(directory=directory).start()
        try:
            c = k.KafkaWireClient(b2.host, b2.port)
            msgs, hw = c.fetch("t", 0, 0)
            recs, _ = v2.fetch_v2(c, "t", 0, 0)
            out = (msgs, hw, [r[:1] + r[2:] for r in recs],
                   c.latest_offset("t", 1))
            g = v2.KafkaGroupConsumer(b2.host, b2.port, "g", ["t"])
            out += (g.committed([("t", 0), ("t", 1)]),)
            g.close()
            c.close()
            return out
        finally:
            b2.stop()

    got = served(reader, d)
    assert got == served(writer, str(tmp_path / "copy"))
    assert got[1] == 3 and [m[2] for m in got[0]] == [b"v0-1", b"v0-2",
                                                      b"v2-1"]
    assert got[4] == {("t", 0): 2, ("t", 1): 1}
