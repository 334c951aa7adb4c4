"""Port parity for the host edges' connectors: the reference's cases of
``tests/test_log_service.py``, ``test_postgres.py``, ``test_s3.py``,
``test_kinesis.py``, ``test_cassandra.py``, ``test_elasticsearch.py``,
``test_rabbitmq.py``, ``test_connectors.py``,
``test_file_sink_exactly_once.py`` and ``test_security.py`` (all
``slow``), run through both packages with the harness of
``tests/test_torch_cluster_cases.py``, each keeping its reference marks,
and the cross-package cases below.
"""

import pytest

from test_torch_calibration import verdicts  # noqa: F401 — the fixture
from test_torch_cluster_cases import cases, check_case

REFERENCE_FILES = ("test_log_service", "test_postgres", "test_s3",
                   "test_kinesis", "test_cassandra", "test_elasticsearch",
                   "test_rabbitmq", "test_connectors",
                   "test_file_sink_exactly_once", "test_security")


@pytest.mark.parametrize("ref, cls, fn_name, params",
                         cases(REFERENCE_FILES, marks=True))
def test_reference_case(ref, cls, fn_name, params, tmp_path_factory,
                        verdicts):  # noqa: F811 — the fixture
    check_case(ref, cls, fn_name, params, tmp_path_factory, verdicts)


#: a clock of source rounds for the local executor's checkpoint timer: one
#: "millisecond" a round, so the job checkpoints every 20 rounds in either
#: package, however fast the machine is
ROUND_CLOCK = (
    ("def test_s3_backs_a_streaming_job_checkpoint(s3):",
     "def test_s3_backs_a_streaming_job_checkpoint(s3, monkeypatch):"),
    ("    env.enable_checkpointing(20, storage=st)",
     "    from flink_tpu.utils import clock as _clock\n"
     "\n"
     "    class _Rounds:\n"
     "        def __init__(self):\n"
     "            self.n = 0\n"
     "\n"
     "        def ms(self):\n"
     "            self.n += 1\n"
     "            return self.n\n"
     "\n"
     "    monkeypatch.setattr(_clock, 'MonotoneElapsed', _Rounds)\n"
     "    env.enable_checkpointing(20, storage=st)"),
)


def test_s3_backs_a_streaming_job_checkpoint_on_a_round_clock(
        tmp_path_factory, verdicts):  # noqa: F811 — the fixture
    """``test_s3.py``'s streaming job on both packages, checkpointing
    through the S3 protocol every 20 source rounds: the same checkpoint
    ids reach the bucket, and the latest restores the same state."""
    check_case("test_s3", None, "test_s3_backs_a_streaming_job_checkpoint",
               {}, tmp_path_factory, verdicts, patches=ROUND_CLOCK)


# ---------------------------------------------------------------------------
# each package's clients against the other package's servers
# ---------------------------------------------------------------------------

#: per reference file: the module of its wire protocol, the names of its
#: server and the names of its client side (the client and what it raises
#: or encodes with)
WIRE = {
    "test_s3": ("filesystems.s3", ("S3CompatibleServer",),
                ("S3Client", "sign_v4")),
    "test_log_service": ("connectors.log_service", ("LogServiceBroker",),
                         ("LogServiceClient",)),
    "test_postgres": ("connectors.postgres", ("PostgresWireServer",),
                      ("PostgresWireClient", "PostgresError",
                       "md5_password", "read_message")),
    "test_kinesis": ("connectors.kinesis", ("KinesisService",),
                     ("KinesisClient", "KinesisError")),
    "test_cassandra": ("connectors.cassandra", ("CqlServer",),
                       ("CqlClient", "CassandraError")),
    "test_elasticsearch": ("connectors.elasticsearch",
                           ("ElasticsearchServer",),
                           ("ElasticsearchClient", "ElasticsearchError")),
    "test_rabbitmq": ("connectors.rabbitmq", ("AmqpBroker",),
                      ("AmqpClient",)),
    "test_schema_registry": ("formats.registry", ("SchemaRegistryServer",),
                             ("SchemaRegistryClient",
                              "SchemaRegistryError",
                              "AvroRegistrySerializer")),
}

#: cases that spy on the server's own module (the package the case
#: imports), so a run with the other package's server has nothing to spy on
SERVER_INTERNALS = {"test_log_service::test_broker_persists_seq_after_data"}

#: S3's server hands out clients of its own package: the mixed run's
#: server hands out the module's ``S3Client`` (the other package's)
_S3_CLIENT = '''
_Server = S3CompatibleServer


class S3CompatibleServer(_Server):
    def client(self, bucket):
        return S3Client(self.url, bucket, self.access_key, self.secret_key,
                        self.region)
'''


def _mixed(ref, jax_side):
    """The port's run of ``ref`` with ``jax_side`` (``server`` or
    ``client``) taken from the JAX package: a patch that rebinds those
    names of the module's globals before its first fixture.  The JAX
    package's name is spelled so the port's rewrite leaves it."""
    mod, server, client = WIRE[ref]
    names = server if jax_side == "server" else client
    rebind = ("\nimport importlib as _importlib\n"
              f"_jax = _importlib.import_module('flink_' + 'tpu.{mod}')\n"
              + "".join(f"{n} = _jax.{n}\n" for n in names))
    if ref == "test_s3":
        rebind += _S3_CLIENT
    anchor = "\n@pytest.fixture\n"
    return ((anchor, rebind + anchor),)


def _wire_cases():
    out = []
    for p in cases(tuple(WIRE), marks=True):
        ref, cls, fn_name, params = p.values
        if f"{ref}::{fn_name}" in SERVER_INTERNALS:
            continue
        for side in ("server", "client"):
            out.append(pytest.param(ref, cls, fn_name, params, side,
                                    marks=p.marks,
                                    id=f"{p.id}[jax {side}]"))
    return out


@pytest.mark.parametrize("ref, cls, fn_name, params, jax_side",
                         _wire_cases())
def test_reference_case_across_packages(ref, cls, fn_name, params, jax_side,
                                        tmp_path_factory,
                                        verdicts):  # noqa: F811
    """Every case of the wire protocols' reference files with the port's
    client against JAX's server, and JAX's client against the port's
    server; the case's own assertions hold, and its record equals the
    all-JAX run's."""
    check_case(ref, cls, fn_name, params, tmp_path_factory, verdicts,
               port_patches=_mixed(ref, jax_side))


# ---------------------------------------------------------------------------
# the same bytes, topics and pending parts from both packages
# ---------------------------------------------------------------------------

import importlib  # noqa: E402
import os  # noqa: E402
import re  # noqa: E402
import threading  # noqa: E402

import numpy as np  # noqa: E402

SIDES = ("flink_tpu", "flink_tpu_torch")


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _other(pkg):
    return SIDES[1] if pkg == SIDES[0] else SIDES[0]


def test_sigv4_headers_equal_with_a_fixed_clock():
    """SigV4 over the same request and clock gives the same headers in both
    packages, for S3 (the path signed as sent) and Kinesis (each segment
    encoded again), reserved characters and query strings included."""
    for service in ("s3", "kinesis"):
        for url in ("http://127.0.0.1:9001/bkt/a%20b/c.parquet",
                    "http://127.0.0.1:9001/bkt?list-type=2&prefix=a%2Fb",
                    "http://127.0.0.1:9001/"):
            heads = [_mod(pkg, "filesystems.s3").sign_v4(
                "PUT", url, {"host": "127.0.0.1:9001",
                             "x-amz-content-sha256": "e3b0c4"},
                "e3b0c4", "AKIA_TEST", "s3cret", "eu-west-1", service,
                amz_date="20261018T164402Z") for pkg in SIDES]
            assert heads[0] == heads[1]
            assert "Signature=" in heads[1]["Authorization"]


@pytest.mark.parametrize("writer", SIDES)
def test_log_topic_written_by_one_package_reads_in_the_other(writer,
                                                             tmp_path):
    """A 3-partition topic that one package's ``LogServiceSink`` fills
    (keys routed by ``hash_keys``, exactly-once commits with producer
    sequences, a replayed commit deduplicated) holds the same frames as
    the other's sink writes from the same batches; the other package's
    broker serves the directory after a restart, and its source reads
    every record back."""
    reader = _other(writer)
    rng = np.random.default_rng(4)
    cols = [{"k": rng.integers(0, 5000, 700).astype(np.int64),
             "v": rng.random(700).astype(np.float32),
             "ts": np.arange(700, dtype=np.int64) + 700 * i}
            for i in range(4)]

    def fill(pkg, d):
        ls = _mod(pkg, "connectors.log_service")
        base = _mod(pkg, "operators.base")
        batch = _mod(pkg, "core.batch")
        b = ls.LogServiceBroker(d).start()
        try:
            sink = ls.LogServiceSink(b.url, "t", num_partitions=3,
                                     key_column="k", producer_id="p1")
            sink.open(type("Ctx", (), {"subtask_index": 0})())
            for i, c in enumerate(cols):
                sink.write_batch(batch.RecordBatch(dict(c)))
                if i == 1:
                    with base.snapshot_scope(1):
                        snap = sink.snapshot_state()
                    sink.notify_checkpoint_complete(1)
            # a restore: the snapshot's commit replayed (deduplicated by
            # its producer sequences), the batches after it written again
            sink.restore_state(snap)
            for c in cols[2:]:
                sink.write_batch(batch.RecordBatch(dict(c)))
            sink.flush()
            return ls.LogServiceClient(b.url).meta("t")
        finally:
            b.stop()

    meta = {pkg: fill(pkg, str(tmp_path / pkg)) for pkg in SIDES}
    assert meta[writer] == meta[reader]
    assert sorted(os.listdir(tmp_path / SIDES[0] / "t")) == \
        sorted(os.listdir(tmp_path / SIDES[1] / "t"))
    for root, _dirs, files in os.walk(tmp_path / writer):
        for f in files:
            mine = os.path.join(root, f)
            theirs = mine.replace(str(tmp_path / writer),
                                  str(tmp_path / reader))
            with open(mine, "rb") as a, open(theirs, "rb") as b:
                assert a.read() == b.read(), f
    # the reader's broker serves the writer's directory to its source
    ls = _mod(reader, "connectors.log_service")
    api = _mod(reader, "datastream.api")
    b = ls.LogServiceBroker(str(tmp_path / writer)).start()
    try:
        env = api.StreamExecutionEnvironment(
            **({"device": "cpu"} if reader == SIDES[1] else {}))
        got = (env.from_source(ls.LogServiceSource(b.url, "t",
                                                   timestamp_column="ts"))
               .execute_and_collect())
    finally:
        b.stop()
    assert sorted(int(r["ts"]) for r in got) == list(range(2800))
    want = {int(t): (int(k), float(v)) for c in cols
            for k, v, t in zip(c["k"], c["v"], c["ts"])}
    assert {int(r["ts"]): (int(r["k"]), float(r["v"])) for r in got} == want


def _sink_ctx():
    return type("Ctx", (), {"subtask_index": 0})()


@pytest.mark.parametrize("fmt", ["csv", "parquet", "avro"])
@pytest.mark.parametrize("writer", SIDES)
def test_file_sink_pending_groups_commit_in_the_other_package(writer, fmt,
                                                              tmp_path,
                                                              monkeypatch):
    """A ``FileSink`` of one package snapshots pending groups under two
    checkpoints; the other package's sink restores that snapshot (its
    orphaned in-progress part discarded, the pending parts committed) and
    commits its own group on notify.  The committed files are the bytes
    the writer's package commits itself, under the same normalised
    names."""
    monkeypatch.setattr(os, "urandom", lambda n: bytes(range(n)))
    reader = _other(writer)
    rng = np.random.default_rng(8)
    cols = [{"k": rng.integers(0, 50, 40).astype(np.int64),
             "v": rng.random(40)} for _ in range(3)]

    def run(first, second, d):
        fs1 = _mod(first, "connectors.file_source")
        b1 = _mod(first, "core.batch")
        base1 = _mod(first, "operators.base")
        sink = fs1.FileSink(d, format=fmt, rolling_records=1000)
        sink.open(_sink_ctx())
        sink.write_batch(b1.RecordBatch(dict(cols[0])))
        with base1.snapshot_scope(1):
            sink.snapshot_state()
        sink.write_batch(b1.RecordBatch(dict(cols[1])))
        with base1.snapshot_scope(2):
            snap = sink.snapshot_state()
        sink.write_batch(b1.RecordBatch(dict(cols[2])))   # orphaned
        sink._roll()
        fs2 = _mod(second, "connectors.file_source")
        b2 = _mod(second, "core.batch")
        base2 = _mod(second, "operators.base")
        again = fs2.FileSink(d, format=fmt, rolling_records=1000)
        again.open(_sink_ctx())
        again.restore_state(snap)
        again.write_batch(b2.RecordBatch(dict(cols[2])))
        with base2.snapshot_scope(3):
            again.snapshot_state()
        again.notify_checkpoint_complete(3)
        out = {}
        for root, _dirs, files in os.walk(d):
            for f in files:
                with open(os.path.join(root, f), "rb") as fh:
                    out[re.sub(r"-[0-9a-f]{8}-", "-<attempt>-", f)] = \
                        fh.read()
        return out, [p for p in (again.committed_files())]

    mixed, committed = run(writer, reader, str(tmp_path / "mixed"))
    same, _ = run(writer, writer, str(tmp_path / "same"))
    assert mixed == same
    assert len(mixed) == 3 and not any(
        n.endswith((".pending", ".inprogress")) for n in mixed)
    rows = []
    fmt_mod = _mod(reader, "formats")
    for path in committed:
        for b in fmt_mod.reader_for(fmt)(path):
            rows += [(int(r["k"]), float(r["v"])) for r in b.to_rows()]
    assert sorted(rows) == sorted((int(k), float(v)) for c in cols
                                  for k, v in zip(c["k"], c["v"]))


#: a started server of each kind, the port's
SERVERS = {
    "s3": lambda tmp: _mod(SIDES[1], "filesystems.s3").S3CompatibleServer(
        str(tmp), "AKIA_TEST", "s3cret").start(),
    "log_service": lambda tmp: _mod(
        SIDES[1], "connectors.log_service").LogServiceBroker(
        str(tmp)).start(),
    "schema_registry": lambda tmp: _mod(
        SIDES[1], "formats.registry").SchemaRegistryServer(),
    "postgres": lambda tmp: _mod(
        SIDES[1], "connectors.postgres").PostgresWireServer(
        users={"alice": "pw"}, auth="scram-sha-256"),
    "kinesis": lambda tmp: _mod(
        SIDES[1], "connectors.kinesis").KinesisService(),
    "cql": lambda tmp: _mod(SIDES[1], "connectors.cassandra").CqlServer(),
    "elasticsearch": lambda tmp: _mod(
        SIDES[1], "connectors.elasticsearch").ElasticsearchServer(),
    "amqp": lambda tmp: _mod(SIDES[1], "connectors.rabbitmq").AmqpBroker(),
}


def _use(name, srv):
    """One request through the server's own client, its connection
    closed."""
    p = SIDES[1]
    if name == "s3":
        c = srv.client("b")
        c._request("PUT").read()
        c.put_object("x", b"1")
    elif name == "log_service":
        _mod(p, "connectors.log_service").LogServiceClient(
            srv.url).create_topic("t")
    elif name == "schema_registry":
        _mod(p, "formats.registry").SchemaRegistryClient(
            f"http://{srv.host}:{srv.port}").register(
            "s", {"type": "record", "name": "r", "fields": [
                {"name": "a", "type": "long"}]})
    elif name == "postgres":
        with _mod(p, "connectors.postgres").PostgresWireClient(
                srv.host, srv.port, user="alice", password="pw") as c:
            c.execute("CREATE TABLE t (a int8)")
    elif name == "kinesis":
        _mod(p, "connectors.kinesis").KinesisClient(
            f"http://{srv.host}:{srv.port}").create_stream("s")
    elif name == "cql":
        with _mod(p, "connectors.cassandra").CqlClient(srv.host,
                                                        srv.port) as c:
            c.execute("CREATE KEYSPACE ks")
    elif name == "elasticsearch":
        _mod(p, "connectors.elasticsearch").ElasticsearchClient(
            srv.host, srv.port).create_index("i")
    else:
        c = _mod(p, "connectors.rabbitmq").AmqpClient(srv.host, srv.port)
        c.queue_declare("q")
        c.close()


def _stop(srv):
    (getattr(srv, "stop", None) or srv.close)()


@pytest.mark.parametrize("name", sorted(SERVERS))
def test_port_servers_stop_every_thread(name, tmp_path):
    """Each of the port's servers ends every thread it started when it is
    stopped: its accept loop and its connections' threads, those of
    clients that closed and of one that still holds an idle connection."""
    import socket
    import time
    before = set(threading.enumerate())
    srv = SERVERS[name](tmp_path / "data")
    _use(name, srv)
    idle = socket.create_connection((srv.host, srv.port))
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline and not any(
            t.name.endswith("-conn") and t.is_alive()
            for t in set(threading.enumerate()) - before):
        time.sleep(0.01)
    started = set(threading.enumerate()) - before
    assert started, "the server started no thread"
    try:
        _stop(srv)
        left = [t.name for t in set(threading.enumerate()) - before
                if t.is_alive()]
        assert not left, left
    finally:
        idle.close()
