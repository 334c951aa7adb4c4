"""Command-line entry point, the ``flink`` CLI analog (port of
``flink_tpu/__main__.py``).

    python -m flink_tpu_torch run my_job.py [--parallelism N] [--cluster]
        [--device cuda|cpu]
    python -m flink_tpu_torch run --workers N my_job:build [--device ...]
    python -m flink_tpu_torch sql "SELECT ..." --table name=path.csv
        [--device cuda|cpu]
    python -m flink_tpu_torch info
    python -m flink_tpu_torch worker --index I --workers N --job mod:fn \\
        --coordinator host:port [--device cuda|cpu]
    python -m flink_tpu_torch coordinate --job mod:fn --workers N \\
        [--listen host:port] [--checkpoint-dir D] [--ha-dir H]
    python -m flink_tpu_torch list|status|cancel|savepoint|stop \\
        --url http://host:port [job_id]
    python -m flink_tpu_torch logservice --dir D [--host H] [--port P]
    python -m flink_tpu_torch s3 --dir D --access-key A --secret-key S \\
        [--region R] [--host H] [--port P]

``run`` executes a job script: the script either defines ``main(env)`` or
just uses a module-level ``env = StreamExecutionEnvironment()`` pipeline
(``env.execute()`` inside the script also works).  ``run``, ``sql`` and
``worker`` take the device as ``--device``: the card unless the CPU is
asked for, and no card is an error.  ``repl``, ``objectstore``, ``kafka``,
``logservice``, ``s3`` and ``quickstart`` are JAX's; ``info`` reports
torch, the CUDA devices it sees and the host C libraries.
"""

from __future__ import annotations

import argparse
import os
import runpy
import sys

def _cmd_run(args) -> int:
    from flink_tpu_torch.datastream.api import StreamExecutionEnvironment

    if args.workers:
        # multi-process execution: the job must be a module:function
        # reference (the jar-shipping model of cluster.distributed)
        if ":" not in args.script or args.script.endswith(".py"):
            print("error: --workers needs a module:function job reference "
                  "(e.g. my_job:build), importable in every worker",
                  file=sys.stderr)
            return 2
        from flink_tpu_torch.cluster.distributed import ProcessCluster
        from flink_tpu_torch.runtime.checkpoint.storage import \
            FileCheckpointStorage

        storage = (FileCheckpointStorage(args.checkpoint_dir)
                   if args.checkpoint_dir else None)
        ha_store = None
        if getattr(args, "ha_dir", None):
            from flink_tpu_torch.runtime.ha import FileHaStore
            ha_store = FileHaStore(args.ha_dir)
        pc = ProcessCluster(
            args.script, n_workers=args.workers,
            checkpoint_storage=storage,
            checkpoint_interval_ms=args.checkpoint_interval,
            restart_attempts=args.restart_attempts,
            ha_store=ha_store,
            extra_sys_path=(os.getcwd(),),
            device=args.device)
        res = pc.run(timeout_s=86400.0, restore=_load_restore(args))
        print(f"job finished: {res['state']} (attempts={res['attempts']}, "
              f"checkpoints={len(res['completed_checkpoints'])})")
        if res["state"] != "FINISHED":
            print(f"error: {res['error']}", file=sys.stderr)
            return 1
        return 0

    env = StreamExecutionEnvironment(parallelism=args.parallelism,
                                     device=args.device)
    ns = runpy.run_path(args.script, init_globals={"env": env})
    main = ns.get("main")
    if callable(main):
        main(env)
    if getattr(env, "_last_executor", None) is not None or \
            getattr(env, "_last_cluster", None) is not None:
        # the script executed itself: don't run the job a second time
        print("job executed by script")
        return 0
    if not env._sinks:
        print(f"error: {args.script} registered no sinks on the provided "
              f"'env' (use the injected env or define main(env)); "
              f"nothing to run", file=sys.stderr)
        return 2
    if args.cluster:
        res = env.execute_cluster(job_name=args.script)
        print(f"job finished: {res.state} in {res.net_runtime_ms:.0f} ms")
        return 0 if res.state == "FINISHED" else 1
    res = env.execute(job_name=args.script)
    print(f"job finished in {res.net_runtime_ms:.0f} ms "
          f"({res.records_emitted} records)")
    return 0


def _cmd_sql(args) -> int:
    from flink_tpu_torch.sql.table_env import TableEnvironment

    tenv = TableEnvironment(parallelism=args.parallelism, device=args.device)
    for spec in args.table or []:
        name, path = spec.split("=", 1)
        fmt = path.rsplit(".", 1)[-1]
        from flink_tpu_torch import formats
        from flink_tpu_torch.core.batch import RecordBatch
        batches = list(formats.reader_for(fmt)(path))
        batch = RecordBatch.concat(batches) if batches else RecordBatch({})
        tenv.register_collection(name, columns=dict(batch.columns))
    tenv.execute_sql(args.query).print()
    return 0


def _cmd_repl(args) -> int:
    """Interactive shell with a preloaded environment — the Scala REPL
    (``FlinkShell.scala``) analog, Python-native."""
    import code

    import numpy as np

    from flink_tpu_torch.datastream.api import StreamExecutionEnvironment
    from flink_tpu_torch.sql.table_env import TableEnvironment

    env = StreamExecutionEnvironment(device=args.device)
    tenv = TableEnvironment(device=args.device)
    banner = ("flink-tpu shell\n"
              "  env  = StreamExecutionEnvironment()  "
              "(env.from_collection(...).key_by(...)...)\n"
              "  tenv = TableEnvironment()            "
              "(tenv.register_collection / execute_sql)\n"
              "  np   = numpy")
    code.interact(banner=banner, local={"env": env, "tenv": tenv, "np": np},
                  exitmsg="")
    return 0


def _cmd_rest(args) -> int:
    """Cluster commands against a running REST endpoint
    (``flink list/cancel/savepoint`` parity)."""
    import json
    import urllib.error
    import urllib.request

    base = args.url.rstrip("/")

    def req(path, method="GET"):
        """-> (status_code, parsed body); non-2xx responses are DATA here
        (the server answers 404/409 with JSON bodies), not tracebacks."""
        rq = urllib.request.Request(base + path, method=method)
        try:
            with urllib.request.urlopen(rq, timeout=60) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            try:
                return e.code, json.loads(e.fp.read())
            except (ValueError, OSError):
                return e.code, {"error": str(e)}

    if args.cmd == "list":
        _st, body = req("/jobs")
        for j in body.get("jobs", []):
            print(f"{j['id']}  {j['state']:<10} {j['name']}")
        return 0
    if args.cmd == "status":
        st, body = req(f"/jobs/{args.job_id}")
        print(json.dumps(body, indent=2))
        return 0 if st == 200 else 1
    if args.cmd == "cancel":
        st, body = req(f"/jobs/{args.job_id}", "PATCH")
        print(body.get("status", body.get("error")))
        return 0 if st < 400 else 1
    if args.cmd == "savepoint":
        st, body = req(f"/jobs/{args.job_id}/savepoints", "POST")
        if body.get("status") == "completed":
            print(f"completed: checkpoint {body.get('checkpoint_id')}")
            return 0
        print(body.get("status", body.get("error")))
        return 1
    if args.cmd == "stop":
        # stop-with-savepoint (`flink stop` analog)
        st, body = req(f"/jobs/{args.job_id}/stop", "POST")
        if body.get("status") == "stopped":
            print(f"stopped: checkpoint {body.get('checkpoint_id')}")
            return 0
        print(body.get("status", body.get("error")))
        return 1
    return 2


def _cmd_info(_args) -> int:
    import torch

    import flink_tpu_torch
    from flink_tpu_torch.kernels import build

    print(f"flink-tpu {getattr(flink_tpu_torch, '__version__', 'dev')} "
          f"(flink_tpu_torch)")
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    print(f"torch {torch.__version__} (CUDA {torch.version.cuda}); devices: "
          f"{[f'cuda:{i} {torch.cuda.get_device_name(i)}' for i in range(n)]}")
    try:
        for source in (build.HOST_SOURCE, build.SPILL_SOURCE,
                       build.CODEC_SOURCE):
            build.build_host(source)
        status = "ok"
    except RuntimeError as e:
        status = str(e)
    print(f"native layer: {status}")
    return 0


def _cmd_worker(args) -> int:
    from flink_tpu_torch.cluster.distributed import _WorkerRuntime

    host, port = args.coordinator.rsplit(":", 1)
    return _WorkerRuntime(args.index, args.workers, args.job,
                          host, int(port), bind_host=args.bind,
                          advertise_host=args.advertise,
                          device=args.device).run()


_QUICKSTART_JOB = '''\
"""__NAME__: streaming windowed wordcount (the SocketWindowWordCount shape).

Run it:            python job.py
Multi-process:     python -m flink_tpu_torch run --workers 2 job:build
With checkpoints:  see README.md
"""

import numpy as np

from flink_tpu_torch.datastream.api import StreamExecutionEnvironment
from flink_tpu_torch.windowing.assigners import TumblingEventTimeWindows


def build():
    env = StreamExecutionEnvironment()
    # demo input: replace with env.from_source(KafkaWireSource(...)) /
    # LogServiceSource / a file source for real data
    n = 10_000
    words = np.asarray(["tpu", "flink", "stream"], object)[
        np.arange(n) % 3]
    from flink_tpu_torch.core.functions import CountAggregator
    (env.from_collection(columns={"word": words,
                                  "ts": np.arange(n, dtype=np.int64)},
                         batch_size=512, timestamp_column="ts")
        .key_by("word")
        .window(TumblingEventTimeWindows.of(1_000))
        .aggregate(CountAggregator(), value_column="ts",
                   output_column="count")
        .print())
    return env


if __name__ == "__main__":
    build().execute()
'''

_QUICKSTART_TEST = '''\
"""Operator-level test for the quickstart job (the
KeyedOneInputOperatorTestHarness pattern — no cluster needed)."""

import numpy as np

from flink_tpu_torch.core.functions import CountAggregator
from flink_tpu_torch.operators.window_agg import WindowAggOperator
from flink_tpu_torch.testing import KeyedOneInputOperatorHarness
from flink_tpu_torch.windowing.assigners import TumblingEventTimeWindows


def test_counts_per_window():
    # the update step needs a NUMERIC value column (string keys stay
    # host-side); a unit test asks for the CPU, a job runs on the card
    op = WindowAggOperator(TumblingEventTimeWindows.of(1_000),
                           CountAggregator(), key_column="word",
                           value_column="one", device="cpu")
    h = KeyedOneInputOperatorHarness(op)
    h.process_elements([{"word": "tpu", "one": 1},
                        {"word": "tpu", "one": 1},
                        {"word": "flink", "one": 1}], [10, 20, 30])
    h.process_watermark(999)
    got = {r["word"]: r["result"] for r in h.extract_output_rows()}
    assert got == {"tpu": 2, "flink": 1}
'''

_QUICKSTART_README = '''\
# __NAME__

A flink-tpu (PyTorch) project skeleton (the quickstart-archetype analog).

## Run

    python job.py                       # local, single process
    python -m pytest test_job.py -q     # operator-level test

## Scale out

    python -m flink_tpu_torch run --workers 2 job:build

## Checkpointing + restore

    from flink_tpu_torch.runtime.checkpoint.storage import FileCheckpointStorage
    env.enable_checkpointing(1000, storage=FileCheckpointStorage("./ckpt"))

Savepoints, REST, SQL, the device mesh (`env.set_mesh(...)`), Kafka and
S3 integration: see `docs/quickstart.md` in the framework repo.
'''


def _cmd_quickstart(args) -> int:
    import os

    os.makedirs(args.dir, exist_ok=True)
    wrote = []
    for fname, tpl in (("job.py", _QUICKSTART_JOB),
                       ("test_job.py", _QUICKSTART_TEST),
                       ("README.md", _QUICKSTART_README)):
        path = os.path.join(args.dir, fname)
        if os.path.exists(path) and not args.force:
            print(f"skip {path} (exists; --force to overwrite)")
            continue
        with open(path, "w") as f:
            f.write(tpl.replace("__NAME__", args.name))
        wrote.append(fname)
    print(f"quickstart project in {args.dir}: {', '.join(wrote)}")
    print(f"  cd {args.dir} && python job.py")
    return 0


def _cmd_kafka(args) -> int:
    from flink_tpu_torch.connectors.kafka import KafkaWireBroker

    b = KafkaWireBroker(host=args.host, port=args.port,
                        directory=args.dir)
    for t in args.topic or []:
        name, _, parts = t.partition(":")
        b.create_topic(name, int(parts or 1))
    b.start()
    print(f"kafka-wire broker on {b.host}:{b.port} (dir={args.dir})")
    try:
        b._thread.join()
    except KeyboardInterrupt:
        b.stop()
    return 0


def _cmd_objectstore(args) -> int:
    from flink_tpu_torch.runtime.checkpoint.objectstore import \
        ObjectStoreServer

    store = ObjectStoreServer(args.dir, host=args.host, port=args.port)
    print(f"object store on {store.url} (dir={args.dir})")
    try:
        store.serve_forever()
    except KeyboardInterrupt:
        pass
    return 0


def _cmd_logservice(args) -> int:
    from flink_tpu_torch.connectors.log_service import LogServiceBroker

    broker = LogServiceBroker(args.dir, host=args.host, port=args.port)
    print(f"log service broker on {broker.url} (dir={args.dir})")
    try:
        broker.serve_forever()
    except KeyboardInterrupt:
        pass
    return 0


def _cmd_s3(args) -> int:
    from flink_tpu_torch.filesystems import S3CompatibleServer

    srv = S3CompatibleServer(args.dir, access_key=args.access_key,
                             secret_key=args.secret_key,
                             region=args.region,
                             host=args.host, port=args.port)
    print(f"S3-compatible endpoint on {srv.url} (dir={args.dir}, "
          f"SigV4 region={args.region})")
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    return 0


def _load_restore(args):
    """--restore/-s: explicit savepoint/checkpoint path (or None)."""
    if not getattr(args, "restore", None):
        return None
    from flink_tpu_torch.runtime.checkpoint.storage import read_savepoint
    return read_savepoint(args.restore)


def _cmd_coordinate(args) -> int:
    import json as _json

    from flink_tpu_torch.cluster.distributed import (ProcessCluster,
                                                     _security_from_env)
    from flink_tpu_torch.runtime.checkpoint.storage import \
        FileCheckpointStorage

    storage = (FileCheckpointStorage(args.checkpoint_dir)
               if args.checkpoint_dir else None)
    ha_store = None
    if getattr(args, "ha_dir", None):
        from flink_tpu_torch.runtime.ha import FileHaStore
        ha_store = FileHaStore(args.ha_dir)
    host, port = args.listen.rsplit(":", 1)
    # same FLINK_TPU_SSL_*/FLINK_TPU_AUTH_TOKEN env contract as workers —
    # on k8s both containers receive the secrets the same way
    try:
        pc = ProcessCluster(args.job, n_workers=args.workers,
                            checkpoint_storage=storage,
                            checkpoint_interval_ms=args.checkpoint_interval,
                            spawn=False, bind_host=host,
                            listen_port=int(port),
                            ha_store=ha_store,
                            security=_security_from_env())
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    res = pc.run(timeout_s=args.timeout, restore=_load_restore(args))
    print(_json.dumps({k: v for k, v in res.items() if k != "rows"},
                      default=str))
    return 0 if res["state"] == "FINISHED" else 1


def _device_arg(p) -> None:
    p.add_argument("--device", default=None,
                   help="where the job's device operators run (cuda or "
                        "cpu; default: the card, and no card is an error)")


def build_parser() -> "argparse.ArgumentParser":
    """The CLI surface (exposed so deployment renderers can validate the
    commands they emit against the real parser); :func:`main` refuses the
    JAX CLI's ``logservice`` and ``s3``, naming their item."""
    p = argparse.ArgumentParser(prog="flink_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    pr = sub.add_parser("run", help="run a job script")
    pr.add_argument("script",
                    help="a .py script (local/MiniCluster) or, with "
                         "--workers, a module:function job reference")
    pr.add_argument("--parallelism", "-p", type=int, default=1)
    pr.add_argument("--cluster", action="store_true",
                    help="run on the in-process MiniCluster (parallel "
                         "subtasks)")
    pr.add_argument("--workers", type=int, default=0,
                    help="run on a MULTI-PROCESS cluster with this many "
                         "worker processes")
    pr.add_argument("--checkpoint-dir", default=None)
    pr.add_argument("--checkpoint-interval", type=int, default=0)
    pr.add_argument("--restart-attempts", type=int, default=0)
    pr.add_argument("--restore", "-s", default=None,
                    help="savepoint/checkpoint path to restore from "
                         "(a fresh run never resumes implicitly)")
    pr.add_argument("--ha-dir", default=None,
                    help="FileHaStore directory enabling coordinator HA: "
                         "leader lease + epoch fencing + job recovery "
                         "(high-availability.storageDir)")
    _device_arg(pr)
    pr.set_defaults(fn=_cmd_run)
    ps = sub.add_parser("sql", help="run a SQL query")
    ps.add_argument("query")
    ps.add_argument("--table", action="append",
                    help="name=path.csv|jsonl|ftb (repeatable)")
    ps.add_argument("--parallelism", "-p", type=int, default=1)
    _device_arg(ps)
    ps.set_defaults(fn=_cmd_sql)
    pi = sub.add_parser("info", help="environment info")
    pi.set_defaults(fn=_cmd_info)
    prl = sub.add_parser("repl", help="interactive shell with a preloaded "
                         "environment (Scala-shell analog)")
    _device_arg(prl)
    prl.set_defaults(fn=_cmd_repl)
    pw = sub.add_parser(
        "worker", help="TaskExecutor worker process (spawned by "
        "cluster.distributed.ProcessCluster)")
    pw.add_argument("--index", type=int, required=True)
    pw.add_argument("--workers", type=int, required=True)
    pw.add_argument("--job", required=True)
    pw.add_argument("--coordinator", required=True)
    pw.add_argument("--bind", default="127.0.0.1",
                    help="data-plane bind address (0.0.0.0 on k8s)")
    pw.add_argument("--advertise", default=None,
                    help="address peers dial (pod IP on k8s)")
    pw.add_argument("--device", default=None,
                    help="the worker's device (cuda or cpu; default: the "
                         "card, and no card is an error)")
    pw.set_defaults(fn=_cmd_worker)
    pco = sub.add_parser(
        "coordinate", help="cluster coordinator that WAITS for externally "
        "started workers (k8s / multi-host deployments); non-loopback "
        "--listen requires TLS env vars (FLINK_TPU_SSL_*) or "
        "FLINK_TPU_ALLOW_INSECURE=1")
    pco.add_argument("--job", required=True)
    pco.add_argument("--workers", type=int, required=True)
    pco.add_argument("--listen", default="0.0.0.0:6123")
    pco.add_argument("--checkpoint-dir", default=None)
    pco.add_argument("--checkpoint-interval", type=int, default=0)
    pco.add_argument("--restore", "-s", default=None,
                     help="savepoint/checkpoint path to restore from")
    pco.add_argument("--ha-dir", default=None,
                     help="FileHaStore directory enabling coordinator HA "
                          "(a standby coordinator pointed at the same dir "
                          "takes over at epoch + 1)")
    pco.add_argument("--timeout", type=float, default=86400.0)
    pco.set_defaults(fn=_cmd_coordinate)
    pls = sub.add_parser("logservice", help="standalone durable log broker "
                         "(Kafka-analog service any process can dial)")
    pls.add_argument("--dir", required=True)
    pls.add_argument("--host", default="127.0.0.1")
    pls.add_argument("--port", type=int, default=9092)
    pls.set_defaults(fn=_cmd_logservice)
    pos = sub.add_parser("objectstore", help="standalone HTTP object store "
                         "(S3-analog checkpoint/savepoint backend)")
    pos.add_argument("--dir", required=True)
    pos.add_argument("--host", default="127.0.0.1")
    pos.add_argument("--port", type=int, default=9000)
    pos.set_defaults(fn=_cmd_objectstore)
    ps3 = sub.add_parser("s3", help="S3-compatible endpoint (real SigV4 "
                         "REST dialect) over a local directory")
    ps3.add_argument("--dir", required=True)
    ps3.add_argument("--access-key", required=True)
    ps3.add_argument("--secret-key", required=True)
    ps3.add_argument("--region", default="us-east-1")
    ps3.add_argument("--host", default="127.0.0.1")
    ps3.add_argument("--port", type=int, default=9001)
    ps3.set_defaults(fn=_cmd_s3)
    pk = sub.add_parser("kafka", help="broker speaking the Kafka v0 binary "
                        "wire protocol over per-partition logs")
    pk.add_argument("--dir", default=None)
    pk.add_argument("--host", default="127.0.0.1")
    pk.add_argument("--port", type=int, default=9092)
    pk.add_argument("--topic", action="append",
                    help="name[:partitions], repeatable")
    pk.set_defaults(fn=_cmd_kafka)
    pq = sub.add_parser("quickstart", help="generate a runnable project "
                        "skeleton (job + test + README)")
    pq.add_argument("dir")
    pq.add_argument("--name", default="my-flink-tpu-job")
    pq.add_argument("--force", action="store_true")
    pq.set_defaults(fn=_cmd_quickstart)
    for name, needs_job in (("list", False), ("status", True),
                            ("cancel", True), ("savepoint", True),
                            ("stop", True)):
        pc = sub.add_parser(name, help=f"{name} jobs via the REST endpoint")
        pc.add_argument("--url", required=True,
                        help="REST endpoint, e.g. http://127.0.0.1:8081")
        if needs_job:
            pc.add_argument("job_id")
        pc.set_defaults(fn=_cmd_rest)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
