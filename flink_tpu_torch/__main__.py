"""Command-line entry point (port of ``flink_tpu/__main__.py``): the
process cluster's two subcommands and the REST client commands.

    python -m flink_tpu_torch worker --index I --workers N --job mod:fn \\
        --coordinator host:port [--device cuda|cpu]
    python -m flink_tpu_torch coordinate --job mod:fn --workers N \\
        [--listen host:port] [--checkpoint-dir D] [--ha-dir H]
    python -m flink_tpu_torch list|status|cancel|savepoint|stop \\
        --url http://host:port [job_id]

``worker`` is the TaskExecutor process a ``ProcessCluster`` spawns (it
passes its own device as ``--device``); ``coordinate`` is a coordinator
that waits for workers started by hand, each on its own ``--device``;
``list``, ``status``, ``cancel``, ``savepoint`` and ``stop`` talk to a
running REST endpoint (``rest/server.py``).  The other subcommands of the
JAX package's CLI come with a later slice and raise
``NotImplementedError`` naming their item of ROADMAP Queue A, the
host-only edges (12).
"""

from __future__ import annotations

import argparse
import sys

#: the JAX package's subcommands that a later slice brings, by item
LATER = {
    "run": "the job-script runner comes with the CLI of the host-only "
           "edges (12)",
    "sql": "the SQL runner comes with the CLI of the host-only edges (12)",
    "repl": "the shell comes with the CLI of the host-only edges (12)",
    "info": "the environment report comes with the CLI of the host-only "
            "edges (12)",
    "logservice": "the log broker comes with the host-only edges (12)",
    "objectstore": "the standalone object store comes with the CLI of the "
                   "host-only edges (12)",
    "s3": "the S3 endpoint comes with the host-only edges (12)",
    "kafka": "the Kafka broker comes with the host-only edges (12)",
    "quickstart": "the project skeleton comes with the CLI of the "
                  "host-only edges (12)",
}


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


def _cmd_worker(args) -> int:
    from flink_tpu_torch.cluster.distributed import _WorkerRuntime

    host, port = args.coordinator.rsplit(":", 1)
    return _WorkerRuntime(args.index, args.workers, args.job,
                          host, int(port), bind_host=args.bind,
                          advertise_host=args.advertise,
                          device=args.device).run()


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


def build_parser() -> "argparse.ArgumentParser":
    """The CLI surface: ``worker``, ``coordinate`` and the REST client
    commands (:func:`main` refuses the JAX CLI's other subcommands, naming
    their item)."""
    p = argparse.ArgumentParser(prog="flink_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
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
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] in LATER:
        raise NotImplementedError(f"not in this slice of flink_tpu_torch: "
                                  f"{LATER[argv[0]]}")
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
