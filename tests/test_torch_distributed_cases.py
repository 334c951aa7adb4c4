"""Port parity for the process cluster: the reference's cases of
``tests/test_distributed.py``, ``test_coordination.py`` and the
``ProcessCluster`` case of ``test_source_coordination.py``, run through
both packages with the harness of ``tests/test_torch_cluster_cases.py``.

Each case runs as the reference wrote it on the JAX package, then with its
source importing ``flink_tpu_torch`` (which also rewrites the job modules
the case writes, so the port's workers import the port).  A process
cluster's coordinator resolves its device once and ships it to every
worker it spawns: the port's run resolves a device nobody names to the
CPU, so its workers start with ``--device cpu``.  The reference's result
records are compared by state (``ProcessCluster.run``), and the case's own
assertions (rows, sums, restores, recoveries) hold on the port.  Each case
keeps its reference marks: ``test_distributed.py`` and
``test_coordination.py`` are all ``slow``, so a tier-1 case of its own
below runs the two-process job on both packages.
"""

import os
import signal
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import flink_tpu_torch.cluster.distributed  # noqa: F401 — patched by the harness
from test_torch_calibration import verdicts  # noqa: F401 — the fixture
from test_torch_cluster_cases import cases, check_case

REFERENCE_FILES = {
    "test_distributed": None,
    "test_coordination": None,
    "test_source_coordination": ("test_cross_process_split_requests",),
}

#: the tier-1 process cluster case (the reference's file is all ``slow``)
TIER1 = ("test_distributed", None, "test_two_process_job", {})


@pytest.mark.parametrize(
    "ref, cls, fn_name, params",
    cases(("test_distributed", "test_coordination"), marks=True)
    + cases({"test_source_coordination":
             ("test_cross_process_split_requests",)}, marks=True))
def test_reference_case(ref, cls, fn_name, params, tmp_path_factory,
                        verdicts):  # noqa: F811 — the fixture
    check_case(ref, cls, fn_name, params, tmp_path_factory, verdicts)


def test_two_process_job_on_both_packages(tmp_path_factory,
                                          verdicts):  # noqa: F811
    """``test_distributed.py::test_two_process_job`` (a keyed sum over two
    worker processes, half the records crossing the TCP data plane) on
    both packages, in tier-1."""
    check_case(*TIER1, tmp_path_factory, verdicts)


@pytest.mark.slow
def test_region_scoped_recovery_without_the_race(tmp_path_factory,
                                                 verdicts):  # noqa: F811
    """``test_distributed.py::test_region_scoped_recovery_survivor_regions_
    never_restart`` on both packages, its map slowed by 2 ms a batch: as
    written, worker 2's region can finish before the first checkpoint
    completes, so the kill finds nothing to recover (either package fails
    ``recoveries >= 1`` under load).  Every assertion stands as written."""
    check_case("test_distributed", None,
               "test_region_scoped_recovery_survivor_regions_never_restart",
               {}, tmp_path_factory, verdicts, patches=((
                   '.map(lambda c: {"v2": np.asarray(c["v"]) * 2.0})',
                   '.map(lambda c: (__import__("time").sleep(0.002),'
                   ' {"v2": np.asarray(c["v"]) * 2.0})[1])'),))


# ---------------------------------------------------------------------------
# the device across processes
# ---------------------------------------------------------------------------

DEVICE_JOB = textwrap.dedent('''
    """A keyed sum that takes ``SLOW_S`` seconds; each process that runs
    its map records the device a name-less resolve gives there."""
    import os
    import time

    import numpy as np

    import flink_tpu_torch
    from flink_tpu_torch.datastream.api import StreamExecutionEnvironment

    OUT = os.environ["DEVICE_JOB_OUT"]
    SLOW_S = float(os.environ.get("DEVICE_JOB_SLOW_S", "0"))

    def _slow(cols):
        mark = os.path.join(OUT, f"dev-{os.getpid()}")
        if not os.path.exists(mark):
            with open(mark, "w") as f:
                f.write(str(flink_tpu_torch.resolve_device()))
        time.sleep(SLOW_S / 40)
        return cols

    def build():
        env = StreamExecutionEnvironment()
        env.set_parallelism(2)
        keys = (np.arange(4000) % 13).astype(np.int64)
        (env.from_collection(columns={"k": keys, "v": np.ones(4000)},
                             batch_size=100)
            .map(_slow).key_by("k").sum("v").collect())
        return env.get_stream_graph("device-job")
''')


@pytest.fixture
def device_job(tmp_path, monkeypatch):
    (tmp_path / "device_job_mod.py").write_text(DEVICE_JOB)
    monkeypatch.syspath_prepend(str(tmp_path))
    monkeypatch.setenv("DEVICE_JOB_OUT", str(tmp_path))
    yield tmp_path, "device_job_mod:build"
    sys.modules.pop("device_job_mod", None)


def _cluster(path, job, **kw):
    from flink_tpu_torch.cluster.distributed import ProcessCluster
    return ProcessCluster(job, n_workers=2, extra_sys_path=(str(path),),
                          **kw)


def test_coordinator_ships_its_device_and_reaps_its_workers(device_job):
    """Every spawned worker starts with the coordinator's device, and a
    device nobody names resolves to it there; after the job no worker
    process is alive."""
    path, job = device_job
    pc = _cluster(path, job, device="cpu")
    res = pc.run(timeout_s=120)
    assert res["state"] == "FINISHED", res["error"]
    assert sum(r["v"] for r in res["rows"]
               if r["k"] == 0) > 0
    assert all(p.poll() is not None for p in pc._procs)
    assert all(f"--device cpu" in " ".join(p.args) for p in pc._procs)
    workers = [f for f in os.listdir(path) if f.startswith("dev-")]
    assert len(workers) == 2
    assert {(path / f).read_text() for f in workers} == {"cpu"}


def test_coordinator_resolves_the_card_unless_told(monkeypatch):
    """``ProcessCluster`` with no device resolves the card once, and
    raises without one, as every entry point of the port does."""
    import torch

    from flink_tpu_torch.cluster.distributed import ProcessCluster
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        ProcessCluster("no_module:build")
    assert ProcessCluster("no_module:build", spawn=False).device is None


def test_worker_told_cuda_without_a_card_fails_the_attempt(device_job,
                                                           monkeypatch):
    """A worker told ``cuda`` that sees no card raises at start, before
    its hello; the coordinator reports the attempt as failed at once (no
    CPU fallback, no registration timeout)."""
    import torch
    path, job = device_job
    pc = _cluster(path, job, device="cpu")
    pc.device = torch.device("cuda")
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    monkeypatch.setattr(os, "environ", env)
    res = pc.run(timeout_s=60)
    assert res["state"] == "FAILED"
    assert "before registering" in res["error"], res["error"]
    out = subprocess.run(
        [sys.executable, "-m", "flink_tpu_torch", "worker", "--index", "0",
         "--workers", "1", "--job", job, "--coordinator", "127.0.0.1:9",
         "--device", "cuda"], capture_output=True, text=True, timeout=120,
        env={**env, "PYTHONPATH": os.pathsep.join(sys.path)})
    assert out.returncode != 0
    assert "CUDA device" in out.stderr


def test_orphaned_workers_exit_when_the_coordinator_goes_silent(device_job):
    """The orphan reaper: a coordinator that stops (SIGSTOP: its sockets
    stay open, its pings stop) loses its workers after
    ``worker_orphan_timeout_s``; they exit without finishing the job."""
    import time
    path, job = device_job
    pids = path / "pids"
    script = textwrap.dedent(f'''
        import sys
        sys.path[:0] = {sys.path!r}
        from flink_tpu_torch.cluster.distributed import ProcessCluster
        pc = ProcessCluster({job!r}, n_workers=2, device="cpu",
                            extra_sys_path=({str(path)!r},),
                            worker_orphan_timeout_s=2.0,
                            ping_interval_s=0.25)
        real = pc._spawn_worker
        def spawn(i, cport):
            p = real(i, cport)
            with open({str(pids)!r}, "a") as f:
                f.write(f"{{p.pid}}\\n")
            return p
        pc._spawn_worker = spawn
        pc.run(timeout_s=300)
    ''')
    coord = subprocess.Popen(
        [sys.executable, "-c", script],
        env={**os.environ, "DEVICE_JOB_SLOW_S": "120"})
    try:
        end = time.monotonic() + 90
        while time.monotonic() < end and (
                not pids.exists() or len(pids.read_text().split()) < 2
                or len([f for f in os.listdir(path)
                        if f.startswith("dev-")]) < 2):
            time.sleep(0.2)
        worker_pids = [int(x) for x in pids.read_text().split()]
        assert len(worker_pids) == 2
        time.sleep(1.0)  # the workers are deployed and running
        os.kill(coord.pid, signal.SIGSTOP)
        end = time.monotonic() + 60
        alive = list(worker_pids)
        while alive and time.monotonic() < end:
            time.sleep(0.2)
            alive = [p for p in alive if _alive(p)]
        assert not alive, f"workers outlived their silent coordinator"
    finally:
        coord.kill()
        coord.wait(timeout=30)


def _alive(pid: int) -> bool:
    """A child of a stopped coordinator that exited stays a zombie until
    reaped: read its state."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().split(") ", 1)[1][0] not in "ZX"
    except FileNotFoundError:
        return False


# ---------------------------------------------------------------------------
# the reference's CLI cases (item 12)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cmd", ["run", "sql", "info"])
def test_cli_commands_wait_for_12(cmd):
    """``test_coordination.py::test_cli_run_script``, ``test_cli_sql`` and
    ``test_cli_info`` drive the job-script, SQL and info subcommands,
    which come with the CLI of the host-only edges (ROADMAP Queue A item
    12): the port's CLI refuses them naming the item."""
    from flink_tpu_torch.__main__ import main
    with pytest.raises(NotImplementedError, match=r"\(12\)"):
        main([cmd, "x"] if cmd != "info" else [cmd])


def _finished_rest_job(side, n=2000):
    """A finished two-subtask keyed sum on a MiniCluster of ``side``'s
    package, registered with a started ``RestServer``: (server, job id)."""
    import importlib
    pkg = "flink_tpu" if side == "jax" else "flink_tpu_torch"
    api = importlib.import_module(f"{pkg}.datastream.api")
    mini = importlib.import_module(f"{pkg}.cluster.minicluster")
    rest = importlib.import_module(f"{pkg}.rest.server")
    env = api.StreamExecutionEnvironment(
        **({"device": "cpu"} if side == "port" else {}))
    env.set_parallelism(2)
    (env.from_collection(columns={"k": np.arange(n) % 7, "v": np.ones(n)},
                         batch_size=256)
        .key_by("k").sum("v").collect())
    plan = env.get_stream_graph("cli-job").to_plan()
    mc = mini.MiniCluster()
    registry = rest.JobRegistry()
    job_id = registry.register("cli-job", mc)
    assert mc.execute(plan, timeout_s=60).state == "FINISHED"
    return rest.RestServer(registry).start(), job_id


@pytest.mark.parametrize("cmd", ["list", "status", "cancel", "savepoint",
                                 "stop"])
def test_cli_rest_commands_on_either_server(cmd, capsys):
    """The REST client subcommands of either package's CLI against either
    package's REST server (a finished job): each pair gives the exit code
    and the answer the JAX CLI gets from the JAX server (``status`` by its
    keys and state: its times are the run's own)."""
    import json

    from flink_tpu.__main__ import main as jax_main
    from flink_tpu_torch.__main__ import main as port_main
    servers = {s: _finished_rest_job(s) for s in ("jax", "port")}
    try:
        got = {}
        for srv, (server, job_id) in servers.items():
            for cli, main in (("jax", jax_main), ("port", port_main)):
                argv = [cmd, "--url", server.url] + (
                    [job_id] if cmd != "list" else [])
                rc = main(argv)
                out = capsys.readouterr().out
                if cmd == "status":
                    body = json.loads(out)
                    out = (sorted(body), body["state"])
                got[srv, cli] = (rc, out)
        want = got["jax", "jax"]
        assert all(v == want for v in got.values()), got
        if cmd == "list":
            assert "cli-job" in want[1] and "FINISHED" in want[1]
        if cmd == "status":
            assert want[0] == 0 and want[1][1] == "FINISHED"
    finally:
        for server, _ in servers.values():
            server.stop()


# ---------------------------------------------------------------------------
# a process cluster's checkpoint and HA pointer, across packages
# ---------------------------------------------------------------------------

CROSS_JOB = textwrap.dedent('''
    """A keyed tumbling f32 sum over ``CROSS_N`` rows, each batch slowed so
    the coordinator's cuts complete while the stream runs."""
    import os
    import time

    import numpy as np
    {imports}

    def _slow(cols):
        time.sleep(0.01)
        return cols

    def build():
        n = int(os.environ.get("CROSS_N", "3000"))
        rng = np.random.default_rng(5)
        cols = {{"k": rng.integers(0, 40, 3000).astype(np.int64),
                 "v": rng.random(3000).astype(np.float32),
                 "t": np.sort(rng.integers(0, 6000, 3000)).astype(np.int64)}}
        cols = {{c: v[:n] for c, v in cols.items()}}
        env = StreamExecutionEnvironment()
        env.set_parallelism(2)
        (env.from_collection(columns=cols, timestamp_column="t",
                             batch_size=100)
            .map(_slow)
            .assign_timestamps_and_watermarks(0, timestamp_column="t")
            .key_by("k").window(Tumbling.of(1000))
            .aggregate(SUM, value_column="v").collect())
        return env.get_stream_graph("cross-job")
''')

CROSS_IMPORTS = {
    "jax": ("import jax.numpy as jnp\n"
            "from flink_tpu.core.functions import SumAggregator\n"
            "from flink_tpu.datastream.api import "
            "StreamExecutionEnvironment\n"
            "from flink_tpu.windowing.assigners import "
            "TumblingEventTimeWindows as Tumbling\n"
            "SUM = SumAggregator(jnp.float32)"),
    "port": ("import torch\n"
             "from flink_tpu_torch.core.functions import SumAggregator\n"
             "from flink_tpu_torch.datastream.api import "
             "StreamExecutionEnvironment\n"
             "from flink_tpu_torch.windowing.assigners import "
             "TumblingEventTimeWindows as Tumbling\n"
             "SUM = SumAggregator(torch.float32)"),
}


def _cross_run(side, tmp, monkeypatch, n, restore=None, ha_dir=None):
    """The job of ``side`` on a 2-worker process cluster of ``side``,
    checkpointing into ``tmp / ckpt`` (with an HA store at ``ha_dir``);
    returns (final rows by (key, window), the storage, the cluster)."""
    import importlib
    pkg = "flink_tpu" if side == "jax" else "flink_tpu_torch"
    mod = f"cross_job_{side}"
    (tmp / f"{mod}.py").write_text(CROSS_JOB.format(
        imports=CROSS_IMPORTS[side]))
    monkeypatch.syspath_prepend(str(tmp))
    monkeypatch.setenv("CROSS_N", str(n))
    dist = importlib.import_module(f"{pkg}.cluster.distributed")
    storage_mod = importlib.import_module(
        f"{pkg}.runtime.checkpoint.storage")
    ha = importlib.import_module(f"{pkg}.runtime.ha")
    storage = storage_mod.FileCheckpointStorage(str(tmp / "ckpt"),
                                                retain=100)
    kw = {"device": "cpu"} if side == "port" else {}
    if ha_dir is not None:
        kw["ha_store"] = ha.FileHaStore(str(ha_dir))
    pc = dist.ProcessCluster(f"{mod}:build", n_workers=2,
                             checkpoint_storage=storage,
                             checkpoint_interval_ms=20,
                             extra_sys_path=(str(tmp),), **kw)
    res = pc.run(timeout_s=120, restore=restore)
    sys.modules.pop(mod, None)
    assert res["state"] == "FINISHED", res["error"]
    rows = {(int(r["k"]), int(r["window_start"])):
            np.float32(r["result"]).tobytes() for r in res["rows"]}
    return rows, storage, pc


@pytest.mark.parametrize("direction", ["jax-to-port", "port-to-jax"])
def test_process_cluster_checkpoint_crosses_and_restores(
        tmp_path, monkeypatch, direction):
    """A cut one package's process cluster completed on the first half of
    the input, found through that package's HA store (its completed-
    checkpoint pointer, read by the other package's ``FileHaStore``),
    loaded from its ``FileCheckpointStorage`` by the other package and
    converted through ``interop``, restores in the other package's process
    cluster on the whole input: the rows equal the writer's own restore of
    the same cut, f32 bits and all."""
    from flink_tpu.core import batch as jbatch
    from flink_tpu.runtime import ha as jha
    from flink_tpu.runtime.checkpoint import storage as jstorage
    from flink_tpu_torch import interop
    from flink_tpu_torch.runtime import ha as pha
    from flink_tpu_torch.runtime.checkpoint import storage as pstorage
    src, dst = direction.split("-to-")
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    (tmp_path / "c").mkdir()
    _, _, pc = _cross_run(src, tmp_path / "a", monkeypatch, 1500,
                          ha_dir=tmp_path / "ha")
    reader_ha, reader_storage = (pha, pstorage) if dst == "port" \
        else (jha, jstorage)
    pointer = reader_ha.FileHaStore(str(tmp_path / "ha")).completed_checkpoint(
        pc.ha_job_id)
    assert pointer is not None and pointer["checkpoint_id"] in \
        pc._completed_ids
    tree = None
    for cid in pc._completed_ids:     # the first cut taken mid-stream
        tree = reader_storage.FileCheckpointStorage(
            str(tmp_path / "a" / "ckpt")).load(cid)
        if any(0 < sub.get("source_offset", 0) for entry in tree.values()
               if isinstance(entry, dict)
               for sub in entry.get("subtasks", ()) if sub):
            break
    else:
        pytest.fail(f"no cut of {pc._completed_ids} was taken mid-stream")
    moved = (interop.job_checkpoint_from_jax(tree) if dst == "port"
             else interop.job_checkpoint_to_jax(tree, batch_module=jbatch))
    got, _, _ = _cross_run(dst, tmp_path / "b", monkeypatch, 3000,
                           restore=moved)
    own = (jstorage if src == "jax" else pstorage).FileCheckpointStorage(
        str(tmp_path / "a" / "ckpt")).load(cid)
    want, _, _ = _cross_run(src, tmp_path / "c", monkeypatch, 3000,
                            restore=own)
    assert got == want
    assert len(want) > 100


# ---------------------------------------------------------------------------
# the serving tier of a process cluster and the session cluster's history
# ---------------------------------------------------------------------------

def _serving_surface(side, method):
    """What ``method`` of a listening (not yet run) process cluster of
    ``side``'s package returns, in a form both packages can be compared
    by: before any queryable state, after ``enable_queryable`` and with the
    TCP front end started (its routing table read by a client)."""
    import importlib
    pkg = "flink_tpu" if side == "jax" else "flink_tpu_torch"
    dist = importlib.import_module(f"{pkg}.cluster.distributed")
    fn = importlib.import_module(f"{pkg}.core.functions")
    qs = importlib.import_module(f"{pkg}.queryable")
    pc = dist.ProcessCluster("no_module:build", spawn=False)
    before = pc.queryable_stats() if method == "queryable_stats" else None
    agg = fn.SumAggregator(np.float32)
    service = pc.enable_queryable("sums", "window-uid", agg, "k")
    try:
        if method == "enable_queryable":
            return (type(service).__name__, sorted(service.stats()),
                    sorted(service.registry.replicas()))
        if method == "queryable_stats":
            st = pc.queryable_stats()
            return before, sorted(st), sorted(st["states"])
        if method == "queryable_endpoints":
            return pc.queryable_endpoints()
        server = pc.start_queryable_server()
        assert server.port > 0
        pool = qs.QueryableStateClientPool("127.0.0.1", server.port)
        try:
            table = pool.refresh_routing()
            ans = pool.get_batch("sums", [1, 2], consistency="checkpoint")
        finally:
            pool.close()
        return sorted(table), ans["found"], ans["tags"]["consistency"]
    finally:
        service.close()


@pytest.mark.parametrize("method", ["enable_queryable",
                                    "start_queryable_server",
                                    "queryable_stats",
                                    "queryable_endpoints"])
def test_process_cluster_serving_surface_equals_jax(method):
    """The process cluster's serving tier (``enable_queryable``, the TCP
    front end, the staleness view and the workers' endpoints, JAX's
    ``distributed.py:1202-1256``) answers as JAX's does before a job
    runs; the reference's ``test_process_cluster_replica_wiring`` and
    ``test_per_worker_serving_e2e_process_cluster`` run the job."""
    assert _serving_surface("port", method) == \
        _serving_surface("jax", method)


@pytest.mark.parametrize("writer, reader", [("jax", "port"),
                                            ("port", "jax")])
def test_session_cluster_history_reads_across_packages(writer, reader,
                                                       tmp_path):
    """A session cluster with a ``history_dir`` archives its finished job
    (JAX's ``coordination.py:346``, ``rest/history.py``); the other
    package's ``HistoryServer`` serves that archive as the writer's
    does."""
    import importlib
    import json
    import time
    import urllib.request

    def pkg(side, mod):
        return importlib.import_module(
            ("flink_tpu" if side == "jax" else "flink_tpu_torch") + mod)

    d = str(tmp_path / "archive")
    api = pkg(writer, ".datastream.api")
    env = api.StreamExecutionEnvironment(
        **({"device": "cpu"} if writer == "port" else {}))
    env.set_parallelism(1)
    (env.from_collection(columns={"k": np.arange(3000) % 7,
                                  "v": np.ones(3000)}, batch_size=256)
        .key_by("k").sum("v").collect())
    plan = env.get_stream_graph("hist-job").to_plan()
    cluster = pkg(writer, ".cluster.coordination").StandaloneSessionCluster(
        num_task_executors=1, slots_per_executor=1, history_dir=d)
    try:
        client = cluster.client()
        job_id = client.submit(plan, parallelism=1)
        client.wait_for_completion(job_id, timeout_s=120)
        deadline = time.time() + 10
        while time.time() < deadline and not pkg(
                writer, ".rest.history").list_archived(d):
            time.sleep(0.05)
    finally:
        cluster.shutdown()
    seen = {}
    for side in (writer, reader):
        hs = pkg(side, ".rest.history").HistoryServer(d).start()
        try:
            for path in ("/jobs", f"/jobs/{job_id}", "/overview"):
                with urllib.request.urlopen(f"{hs.url}{path}",
                                            timeout=10) as r:
                    seen[side, path] = json.loads(r.read())
        finally:
            hs.stop()
    for path in ("/jobs", f"/jobs/{job_id}", "/overview"):
        assert seen[reader, path] == seen[writer, path]
    assert seen[reader, "/jobs"]["jobs"][0]["id"] == job_id
    assert seen[reader, f"/jobs/{job_id}"]["state"] == "FINISHED"
