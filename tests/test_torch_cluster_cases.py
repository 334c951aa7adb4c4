"""Port parity for the MiniCluster: the reference's cluster cases, run
through both packages (the checkpoint cases are
``tests/test_torch_checkpoint_cases.py``'s, through this file's harness).

Each case of ``tests/test_minicluster.py``, ``test_unaligned.py``,
``test_chaos.py`` (apart from the storage cases ``tests/test_torch_storage.py``
mirrors), ``test_end_to_end_exactly_once.py`` and the object-store cases
of ``test_storage_contract.py`` (and the MiniCluster cases of
``test_streams_advanced.py`` and ``test_paging.py``) runs twice: once
as the reference wrote it, on the JAX package, and once with its source
importing ``flink_tpu_torch`` in place of ``flink_tpu``.  So the same numpy
inputs go through both packages, and the reference case's own assertions
hold on the port.  A case that raises records its exception: the port must
raise the same (one reference case fails on JAX as written; the port fails
it the same way).

Each run also records what the API hands back at its boundary, on the
case's own thread, and the port's record must equal JAX's, floats bit for
bit.  A case that runs subtask threads, channels, heartbeats or RPC (a
MiniCluster job, a ``Subtask`` driven by hand) records its job results'
states only: its checkpoint ids, restart timing and the order in which
threads interleave are the wall clock's, and its own assertions (rows as a
multiset, exactly-once sums, what a restore holds) carry the comparison.
Every other case records query rows (a multiset), operator outputs and
snapshots, increments and their resolution, storage loads and fault
histories.  Calls nested inside a recorded call are not recorded again.

The port's run resolves a device nobody names to the CPU (the reference
cases name none; a process cluster's coordinator ships that device to its
workers) and pins the DataStream API's default aggregate dtype to f32, the
dtype JAX folds its default in (x64 off).  The process cluster's, HA's,
chaos' and rescale's reference files run in their own files through this
harness (``tests/test_torch_distributed_cases.py``, ``_ha_cases``,
``_chaos_cases``, ``_rescale_cases``), keeping their reference marks
(``cases(..., marks=True)``); a counterpart may patch a case's source
(``check_case(..., patches=...)``) and says why.
``tests/test_torch_checkpoint.py`` holds that ``execute_cluster`` raises
without a card.  The cases that cannot run this
way have counterparts at the end of this file (:data:`OWN_COUNTERPART`).
"""

import inspect
import math
import pathlib
import re
import sys
import threading
import types

import numpy as np
import pytest
import torch

import flink_tpu_torch
from test_torch_calibration import verdicts  # noqa: F401 — the fixture

TESTS = pathlib.Path(__file__).parent

REFERENCE_FILES = ("test_minicluster", "test_unaligned", "test_chaos",
                   "test_end_to_end_exactly_once", "test_storage_contract")

#: the MiniCluster cases of other reference files (the rest of each file
#: has its own parity file)
ALSO = {"test_streams_advanced": ("test_window_join_parallel_cluster",
                                  "test_side_output_parallel_cluster_no_"
                                  "duplicates"),
        "test_paging": ("test_minicluster_job_status_aggregates_paging",)}

#: cases with counterparts of their own below, or in
#: ``tests/test_torch_storage.py`` (the eight storage cases of
#: ``test_chaos.py`` it mirrors)
OWN_COUNTERPART = {
    # an unused import of the partitioned log (item 12):
    # tests/test_torch_rescale_cases.py runs the rest of it
    "test_adaptive::test_adaptive_rescale_mid_job",
    # ROADMAP Queue C item 6: the autoscaler's decisions race the
    # machine's load in either package; tests/test_torch_rescale_cases.py
    # runs both packages with the decisions scripted
    "test_rescale_under_fire::test_acceptance_autoscaled_2_4_2_exactly_once",
    "test_rescale_under_fire::test_acceptance_kill_during_rescale_is_"
    "idempotent",
    "test_rescale_under_fire::test_acceptance_rollback_on_redeploy_failure",
    "test_rescale_under_fire::test_acceptance_worker_killed_mid_redeploy",
    # item 12: the fraud scenario (tests/test_torch_ha_cases.py)
    "test_ha::test_coordinator_kill_at_peak_recovers_exactly_once",
    # its kill races the job's end in either package (the dead worker's
    # region may have finished first): tests/test_torch_distributed_cases.py
    # runs it on both with the map slowed so the kill lands mid-run
    "test_distributed::test_region_scoped_recovery_survivor_regions_never_"
    "restart",
    # item 12: the CLI's job-script, SQL and info subcommands
    # (tests/test_torch_distributed_cases.py)
    "test_coordination::test_cli_run_script",
    "test_coordination::test_cli_sql",
    "test_coordination::test_cli_info",
    # 4 M records through the port's keyed sum on the CPU meet the case's
    # 120 s timeout under load: tests/test_torch_rest_cases.py runs it on
    # both packages over 1 M
    "test_rest::test_stop_with_savepoint",
    # its size bound races the end-of-input fire in either package:
    # tests/test_torch_checkpoint.py runs it on both with the race taken out
    "test_incremental_checkpoints::test_minicluster_incremental_end_to_end",
    # item 12: the partitioned log connector
    "test_end_to_end_exactly_once::test_log_to_log_exactly_once_with_chaos",
    "test_end_to_end_exactly_once::test_log_to_log_unaligned_checkpoints",
    "test_end_to_end_exactly_once::"
    "test_commit_crash_window_not_truncated_by_new_attempt",
    # tests/test_torch_storage.py
    "test_chaos::test_retrying_storage_absorbs_transient_flakes",
    "test_chaos::test_retrying_storage_backoff_is_capped",
    "test_chaos::test_retrying_storage_gives_up_past_max_attempts",
    "test_chaos::test_retrying_storage_never_retries_corruption",
    "test_chaos::test_torn_checkpoint_is_skipped_by_load_latest",
    "test_chaos::test_checksum_mismatch_detected",
    "test_chaos::test_unreadable_metadata_is_corrupt_not_fatal",
    "test_chaos::test_crash_mid_write_leaves_only_staging_dir",
}

#: the parametrized fixtures' values that run here: the object store only
#: (memory and file storage are ``tests/test_torch_storage.py``'s; S3
#: waits for item 12)
FIXTURE_PARAMS = {"impl": ["objectstore"]}

#: (module, attribute, method or None) recorded in each package
RECORDED = [
    ("datastream.api", "DataStream", "execute_and_collect"),
    ("cluster.minicluster", "MiniCluster", "execute"),
    ("cluster.distributed", "ProcessCluster", "run"),
    ("runtime.checkpoint.delta", "apply_increments", None),
    ("runtime.checkpoint.delta", "resolve_chain", None),
    ("runtime.checkpoint.delta", "state_size", None),
    ("runtime.checkpoint.incremental", "IncrementalCheckpointStorage",
     "load"),
    ("runtime.checkpoint.incremental", "IncrementalCheckpointStorage",
     "load_latest"),
    ("runtime.checkpoint.incremental", "IncrementalCheckpointStorage",
     "checkpoint_ids"),
    ("runtime.checkpoint.incremental", "IncrementalCheckpointStorage",
     "chain_length"),
    ("runtime.checkpoint.incremental", "IncrementalCheckpointStorage",
     "shared_blob_count"),
    ("runtime.checkpoint.local", "TaskLocalStateStore", "load"),
    ("runtime.checkpoint.local", "TaskLocalStateStore", "checkpoint_ids"),
    ("runtime.checkpoint.storage", "FileCheckpointStorage", "load"),
    ("runtime.checkpoint.storage", "FileCheckpointStorage", "load_latest"),
    ("runtime.checkpoint.storage", "InMemoryCheckpointStorage",
     "load_latest"),
    ("runtime.checkpoint.storage", "read_savepoint", None),
    ("runtime.checkpoint.objectstore", "ObjectStoreCheckpointStorage",
     "load"),
    ("runtime.checkpoint.objectstore", "ObjectStoreCheckpointStorage",
     "load_latest"),
    ("runtime.checkpoint.objectstore", "ObjectStoreCheckpointStorage",
     "checkpoint_ids"),
    ("runtime.checkpoint.failure", "CheckpointFailureManager",
     "on_checkpoint_failure"),
    ("operators.window_agg", "WindowAggOperator", "process_batch"),
    ("operators.window_agg", "WindowAggOperator", "process_watermark"),
    ("operators.window_agg", "WindowAggOperator", "snapshot_state"),
    ("operators.session_window", "SessionWindowOperator", "process_batch"),
    ("operators.session_window", "SessionWindowOperator",
     "process_watermark"),
    ("operators.session_window", "SessionWindowOperator", "snapshot_state"),
    ("state.changelog", "ChangelogKeyedStateBackend", "snapshot_increment"),
    ("state.changelog", "ChangelogKeyedStateBackend", "snapshot"),
    ("testing.chaos", "FaultInjector", "history"),
]

#: what a case that runs threads records (see the module's docstring)
THREADED_RECORDED = {"MiniCluster.execute", "ProcessCluster.run"}

#: a case whose source names one of these runs threads
THREADED = re.compile(
    r"execute_cluster|MiniCluster|ProcessCluster|Subtask\(|SourceSubtask|"
    r"Heartbeat|Gateway|RpcEndpoint|LocalChannel|_run_backpressured|"
    r"_window_job|_backpressure_job|threading|Thread\(")


def plain(v, tmp=None):
    """A value both packages can be compared by: numbers as Python values
    (floats by their bits), arrays and tensors as lists, batches as rows
    and timestamps, job results by their state, dataclasses by their class
    name and fields; strings read ``<tmp>`` for the case's temporary
    directory and ``flink_tpu`` for either package's name."""
    if isinstance(v, str):
        if tmp is not None:
            v = v.replace(tmp, "<tmp>")
        return v.replace("flink_tpu_torch", "flink_tpu")
    if v is None or isinstance(v, (bool, int, bytes)):
        return v
    if isinstance(v, float):
        return ("float", "nan" if math.isnan(v) else v.hex())
    if isinstance(v, np.generic):
        return plain(v.item(), tmp)
    if isinstance(v, torch.Tensor):
        return plain(v.detach().cpu().numpy(), tmp)
    if isinstance(v, np.ndarray):
        items = v.tolist()
        return ("array", str(v.dtype) if v.dtype != object else "object",
                [plain(x, tmp) for x in items] if v.ndim
                else plain(items, tmp))
    if isinstance(v, dict) and "rows" in v and "completed_checkpoints" in v:
        # a process cluster's result: its state, as a JobResult's
        return ("ProcessCluster.run", v["state"])
    if isinstance(v, dict):
        return {plain(k, tmp): plain(x, tmp) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [plain(x, tmp) for x in v]
    if isinstance(v, (set, frozenset)):
        return sorted((plain(x, tmp) for x in v), key=repr)
    if type(v).__name__ == "JobResult":
        return ("JobResult", v.state)
    if hasattr(v, "to_rows") and hasattr(v, "columns"):
        ts = getattr(v, "timestamps", None)
        return {"rows": plain(v.to_rows(), tmp),
                "ts": None if ts is None else plain(np.asarray(ts))}
    if type(v).__name__ == "Watermark":
        return ("watermark", v.timestamp)
    fields = getattr(v, "__dataclass_fields__", None)
    if fields is not None:
        return (type(v).__name__,
                {f: plain(getattr(v, f), tmp) for f in fields})
    if hasattr(v, "__array__"):
        return plain(np.asarray(v), tmp)
    return type(v).__name__


class Recorder:
    """Records what the wrapped calls of one package return or raise on the
    case's own thread; a call nested inside a recorded one is not recorded
    again, and a threaded case records its job results' states only."""

    def __init__(self, tmp: str, threaded: bool):
        self.log = []
        self.tmp = tmp
        self.threaded = threaded
        self.thread = threading.get_ident()
        self._depth = 0

    def wrap(self, monkeypatch, owner, name, label):
        fn = getattr(owner, name)
        rec = self
        multiset = label == "DataStream.execute_and_collect"

        def recorded(*args, **kwargs):
            if threading.get_ident() != rec.thread or (
                    rec.threaded and label not in THREADED_RECORDED):
                return fn(*args, **kwargs)
            rec._depth += 1
            try:
                out = fn(*args, **kwargs)
            except Exception as e:
                if rec._depth == 1:
                    rec.log.append((label, "raises", type(e).__name__,
                                    plain(str(e), rec.tmp)))
                raise
            finally:
                rec._depth -= 1
            if rec._depth == 0:
                got = plain(out, rec.tmp)
                if multiset:
                    got = sorted(got, key=repr)
                rec.log.append((label, got))
            return out

        monkeypatch.setattr(owner, name, recorded)

    def install(self, monkeypatch, package: str):
        import importlib
        for mod, attr, meth in RECORDED:
            m = importlib.import_module(f"{package}.{mod}")
            owner = getattr(m, attr)
            if meth is None:
                self.wrap(monkeypatch, m, attr, f"{mod}.{attr}")
            else:
                self.wrap(monkeypatch, owner, meth, f"{attr}.{meth}")


def _cpu_when_unnamed(monkeypatch):
    """Every port module's ``resolve_device``: a device nobody names is the
    CPU for the port's run of a reference case, and a mesh nobody places
    (``make_mesh(n)``) is ``n`` CPU blocks, as JAX's is over the conftest's
    CPU devices."""
    from flink_tpu_torch.parallel import mesh
    real_mesh = mesh.make_mesh

    def make_mesh(n_devices=None, devices=None, **kw):
        if devices is None:
            devices = ["cpu"] * int(n_devices)
        return real_mesh(devices=devices, **kw)

    monkeypatch.setattr(mesh, "make_mesh", make_mesh)
    real = flink_tpu_torch.resolve_device

    def resolve(device=None):
        return real("cpu" if device is None else device)

    for name, mod in list(sys.modules.items()):
        if (name.startswith("flink_tpu_torch")
                and getattr(mod, "resolve_device", None) is real):
            monkeypatch.setattr(mod, "resolve_device", resolve)


def _f32_defaults(monkeypatch):
    """The DataStream API's ``sum``/``min``/``max`` without a dtype: f64 in
    the port, ``jnp.float64`` in JAX, which JAX (x64 off) folds as f32; the
    port's run pins f32, so both packages fold the same values."""
    from flink_tpu_torch.datastream import api
    for cls in (api.KeyedStream, api.WindowedStream):
        for name in ("sum", "min", "max"):
            fn = getattr(cls, name)

            def pinned(self, value_column, output_column=None, dtype=None,
                       _fn=fn):
                return _fn(self, value_column, output_column,
                           dtype or torch.float32)

            monkeypatch.setattr(cls, name, pinned)


_SOURCES = {}


def _source(ref: str, side: str, patches=()) -> str:
    """The reference file's source for one package, with the
    ``(old, new)`` replacements of a counterpart (each must apply)."""
    src = (TESTS / f"{ref}.py").read_text()
    for old, new in patches:
        assert old in src, f"{ref}: the patched text is gone: {old!r}"
        src = src.replace(old, new)
    if side == "port":
        src = re.sub(r"\bflink_tpu\b", "flink_tpu_torch", src)
        # the partitioned log waits for item 12: only the cases that use
        # it name it, and they are OWN_COUNTERPART
        src = re.sub(r"^from flink_tpu_torch\.connectors\.partitioned_log "
                     r"import \([^)]*\)\n",
                     "LogSink = LogSource = PartitionedLog = None\n", src,
                     flags=re.M)
    return src


def _module(ref: str, side: str, patches=()) -> types.ModuleType:
    """A fresh module of the reference file ``ref``: as written (``jax``),
    or importing the port in place of the JAX package (``port``)."""
    key = (ref, side, tuple(patches))
    if key not in _SOURCES:
        _SOURCES[key] = compile(_source(ref, side, patches),
                                str(TESTS / f"{ref}.py"), "exec")
    mod = types.ModuleType(f"{ref}__{side}")
    mod.__file__ = str(TESTS / f"{ref}.py")
    exec(_SOURCES[key], mod.__dict__)
    return mod


def _grid(marks):
    grid = [{}]
    for mark in marks:
        if mark.name != "parametrize":
            continue
        argnames, argvalues = mark.args[:2]
        argnames = [a.strip() for a in argnames.split(",")] \
            if isinstance(argnames, str) else list(argnames)
        grid = [{**g, **dict(zip(argnames, v if len(argnames) > 1
                                 else (v,)))}
                for g in grid for v in argvalues]
    return grid


#: the reference marks a case keeps with ``cases(..., marks=True)``
KEPT_MARKS = ("slow", "chaos")


def _marks(mod, fn):
    """The :data:`KEPT_MARKS` of a reference case: its module's
    ``pytestmark`` and its own."""
    own = getattr(mod, "pytestmark", [])
    own = own if isinstance(own, list) else [own]
    return [getattr(pytest.mark, m.name) for m in
            own + list(getattr(fn, "pytestmark", []))
            if m.name in KEPT_MARKS]


def cases(files, marks=False):
    """``(id, reference file, class or None, function name, parametrize
    kwargs)`` for every case of the reference ``files`` (a mapping: only
    the cases it names of each), parametrized ones expanded (fixture
    parameters by :data:`FIXTURE_PARAMS`); with ``marks``, each case keeps
    its reference's ``slow`` and ``chaos`` marks."""
    out = []
    for ref in files:
        mod = _module(ref, "jax")
        src = (TESTS / f"{ref}.py").read_text()
        found = [(None, n) for n in re.findall(r"^def (test_\w+)\(", src,
                                               re.M)]
        for cls in re.findall(r"^class (Test\w+)", src, re.M):
            found += [(cls, n) for n in vars(mod.__dict__[cls])
                      if n.startswith("test_")]
        for cls, fn_name in found:
            cid = f"{ref}::{fn_name}" if cls is None \
                else f"{ref}::{cls}::{fn_name}"
            if cid in OWN_COUNTERPART or (isinstance(files, dict)
                                          and fn_name not in files[ref]):
                continue
            fn = (mod.__dict__[fn_name] if cls is None
                  else vars(mod.__dict__[cls])[fn_name])
            grid = _grid(getattr(fn, "pytestmark", []))
            for name, values in FIXTURE_PARAMS.items():
                if name in inspect.signature(fn).parameters:
                    grid = [{**g, name: v} for g in grid for v in values]
            kept = _marks(mod, fn) if marks else []
            for g in grid:
                pid = "-".join(str(v) for v in g.values())
                out.append(pytest.param(
                    ref, cls, fn_name, g, marks=kept,
                    id=f"{cid}[{pid}]" if pid else cid))
    return out


def _with_helpers(ref: str, src: str, depth: int = 3) -> str:
    """``src`` and the source of every module-level helper it calls (to
    ``depth`` calls deep): what :data:`THREADED` is matched against."""
    text = _source(ref, "jax")
    defs = {m.group(1): m.group(0) for m in re.finditer(
        r"^def (_\w+)\(.*?(?=^\S)", text, re.M | re.S)}
    seen, todo = set(), [src]
    for _ in range(depth):
        called = {n for s in todo for n in re.findall(r"\b(_\w+)\(", s)
                  if n in defs and n not in seen}
        seen |= called
        todo = [defs[n] for n in called]
        src += "".join(todo)
    return src


def _run(ref, cls, fn_name, params, side, tmp_path_factory, patches=()):
    """The case through one package; returns its record (the case's own
    exception, if it raises, is the last entry)."""
    mp = pytest.MonkeyPatch()
    tmp = tmp_path_factory.mktemp(f"{fn_name[:20]}_{side}")
    src = _source(ref, "jax").split(f"\nclass {cls}" if cls
                                    else f"\ndef {fn_name}(", 1)[1]
    src = re.split(r"\n(?:def|class) ", src, maxsplit=1)[0]
    src = _with_helpers(ref, src)
    rec = Recorder(str(tmp), bool(THREADED.search(src)))
    finalizers = []
    try:
        package = "flink_tpu" if side == "jax" else "flink_tpu_torch"
        rec.install(mp, package)
        if side == "port":
            _cpu_when_unnamed(mp)
            _f32_defaults(mp)
        mod = _module(ref, side, patches)
        case_mp = pytest.MonkeyPatch()
        finalizers.append(case_mp.undo)

        def fixture_value(fixture, name):
            fn = fixture._get_wrapped_function()
            args = []
            for p in inspect.signature(fn).parameters:
                args.append(types.SimpleNamespace(param=params[name])
                            if p == "request" else resolve(p))
            value = fn(*args)
            if inspect.isgenerator(value):
                gen, value = value, next(value)
                finalizers.append(lambda: next(gen, None))
            return value

        def resolve(name):
            if name in params and name not in FIXTURE_PARAMS:
                return params[name]
            if name == "tmp_path":
                return tmp
            if name == "tmp_path_factory":
                return tmp_path_factory
            if name == "monkeypatch":
                return case_mp
            return fixture_value(mod.__dict__[name], name)

        for name, obj in list(mod.__dict__.items()):
            marker = getattr(obj, "_fixture_function_marker", None)
            if marker is not None and marker.autouse:
                fixture_value(obj, name)
        if cls is None:
            fn = mod.__dict__[fn_name]
        else:
            fn = getattr(mod.__dict__[cls](), fn_name)
        try:
            fn(*[resolve(p) for p in inspect.signature(fn).parameters])
        except Exception as e:  # noqa: BLE001 — the outcome is recorded
            rec.log.append(("case raises", type(e).__name__,
                            plain(str(e).split("\n")[0], rec.tmp)))
    finally:
        for f in reversed(finalizers):
            f()
        mp.undo()
    return rec.log


def check_case(ref, cls, fn_name, params, tmp_path_factory, pin,
               patches=()):
    """One reference case through both packages; the records must be
    equal.  A counterpart passes ``patches`` (see :func:`_source`)."""
    pin(taxed=False, shards=1, super_shards=1, depth=1, probe=False)
    want = _run(ref, cls, fn_name, params, "jax", tmp_path_factory, patches)
    got = _run(ref, cls, fn_name, params, "port", tmp_path_factory, patches)
    assert len(got) == len(want), (got[-1:], want[-1:])
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, f"record {i} of {fn_name} differs"


@pytest.mark.parametrize("ref, cls, fn_name, params",
                         cases(REFERENCE_FILES) + cases(ALSO))
def test_reference_case(ref, cls, fn_name, params, tmp_path_factory,
                        verdicts):  # noqa: F811 — the fixture
    check_case(ref, cls, fn_name, params, tmp_path_factory, verdicts)


# ---------------------------------------------------------------------------
# the counterparts of OWN_COUNTERPART's cases
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["partitioned_log"])
def test_partitioned_log_cases_wait_for_12(name):
    """The three ``PartitionedLog`` cases of
    ``test_end_to_end_exactly_once.py``: the log connector comes with
    ROADMAP Queue A item 12, and importing it raises naming the item."""
    from flink_tpu_torch import connectors
    with pytest.raises(NotImplementedError, match=r"\(12\)"):
        getattr(connectors, name)


def test_s3_storage_waits_for_12():
    """The S3 cases of ``test_storage_contract.py``: S3 storage comes with
    ROADMAP Queue A item 12."""
    from flink_tpu_torch import filesystems
    with pytest.raises(NotImplementedError, match=r"\(12\)"):
        filesystems.s3
