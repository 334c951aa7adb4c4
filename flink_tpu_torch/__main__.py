"""Command-line entry point (port of ``flink_tpu/__main__.py``): the
process cluster's two subcommands.

    python -m flink_tpu_torch worker --index I --workers N --job mod:fn \\
        --coordinator host:port [--device cuda|cpu]
    python -m flink_tpu_torch coordinate --job mod:fn --workers N \\
        [--listen host:port] [--checkpoint-dir D] [--ha-dir H]

``worker`` is the TaskExecutor process a ``ProcessCluster`` spawns (it
passes its own device as ``--device``); ``coordinate`` is a coordinator
that waits for workers started by hand, each on its own ``--device``.  The
other subcommands of the JAX package's CLI come with later slices and
raise ``NotImplementedError`` naming their item of ROADMAP Queue A: the
REST client commands with the REST views (10), the rest with the
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
    **{name: "the REST client commands come with the REST views (10)"
       for name in ("list", "status", "cancel", "savepoint", "stop")},
}


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
    """The CLI surface: ``worker`` and ``coordinate`` (:func:`main`
    refuses the JAX CLI's other subcommands, naming their item)."""
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
