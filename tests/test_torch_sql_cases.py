"""Port parity for the SQL stack: every case of the reference's eight SQL
test files, run through both packages.

Each case of ``tests/test_sql.py``, ``test_sql_advanced.py``,
``test_sql_over.py``, ``test_match_recognize.py``, ``test_sql_cost.py``,
``test_temporal_lookup_join.py``, ``test_sql_ddl.py`` and
``test_streaming_join.py`` runs twice: once as the reference wrote it, on
the JAX package, and once with its source importing ``flink_tpu_torch``
in place of ``flink_tpu``.  So the same numpy inputs go through both
packages, and the reference case's own assertions hold on the port.  Each
run records what the API hands back at its boundary (query rows, DDL and
EXPLAIN results, parsed statements, the cost model's orders, the
operators' outputs and snapshots, and every exception those calls raise,
with its message); the port's record must equal JAX's, floats bit for bit
(SQL aggregates accumulate in float32 in both packages).  Calls nested
inside a recorded call are not recorded again.

The port's run resolves a device nobody names to the CPU (the reference
cases name none); ``tests/test_torch_sql.py`` holds that the port raises
without a card.  The cases that cannot run this way have counterparts of
their own in ``tests/test_torch_sql.py`` (:data:`OWN_COUNTERPART`).
"""

import inspect
import math
import pathlib
import re
import sys
import types

import numpy as np
import pytest
import torch

import flink_tpu_torch
from test_torch_calibration import verdicts  # noqa: F401 — the fixture

TESTS = pathlib.Path(__file__).parent

REFERENCE_FILES = ("test_sql", "test_sql_advanced", "test_sql_over",
                   "test_match_recognize", "test_sql_cost",
                   "test_temporal_lookup_join", "test_sql_ddl",
                   "test_streaming_join")

#: reference cases that ``tests/test_torch_sql.py`` mirrors by hand: the
#: cluster case waits for ROADMAP Queue A item 8.4; the changelog
#: aggregate's state is a ``jax.Array`` in JAX and a ``torch.Tensor`` in
#: the port
OWN_COUNTERPART = {
    "test_sql_advanced::test_count_distinct_parallel_cluster",
    "test_sql_advanced::test_changelog_agg_device_state_and_snapshot_roundtrip",
}

#: (module, attribute, method or None) recorded in each package
RECORDED = [
    ("sql.table_env", "TableResult", "collect"),
    ("sql.table_env", "_RowsResult", "collect"),
    ("sql.table_env", "_DdlResult", "collect"),
    ("sql.table_env", "_ExplainResult", "collect"),
    ("sql.table_env", "_InsertResult", "collect"),
    ("sql.table_env", "TableEnvironment", "explain_sql"),
    ("sql.table_env", "TableEnvironment", "sql_query"),
    ("sql.table_env", "Table", "where"),
    ("sql.table_env", "Table", "select"),
    ("sql.table_env", "CatalogTable", "get_stats"),
    ("sql", "parse", None),
    ("sql.parser", "parse", None),
    ("sql.parser", "parse_any", None),
    ("sql.planner", "_CompositeKeyHasher", "combine"),
    ("sql.planner", "_CompositeKeyHasher", "components"),
    ("sql.cost", "_best_order", None),
    ("sql.cost", "join_reorder", None),
    ("sql.cost", "filter_selectivity", None),
    ("sql.rules", "apply_rules", None),
    ("operators.joins", "_join_pairs", None),
    ("ops.join_kernels", "device_join_pairs", None),
    ("datastream.api", "DataStream", "execute_and_collect"),
    ("operators.session_window", "SessionWindowOperator", "process_batch"),
    ("operators.session_window", "SessionWindowOperator",
     "process_watermark"),
    ("cep.operator", "CepOperator", "process_batch"),
    ("cep.operator", "CepOperator", "process_watermark"),
    ("cep.operator", "CepOperator", "end_input"),
]

#: the SQL operators' protocol, recorded on every operator class of
#: ``operators/sql_ops.py``
OPERATOR_METHODS = ("process_batch", "process_batch2", "process_watermark",
                    "end_input", "snapshot_state")

NOW_MS = 1_790_000_000_000


def plain(v, tmp=None):
    """A value both packages can be compared by: numbers as Python values
    (floats by their bits), arrays and tensors as lists, batches as rows
    and timestamps, AST nodes by their repr; the case's temporary
    directory ``tmp`` reads ``<tmp>`` in strings, and a loopback address's
    port (a Kafka DDL's broker or a Postgres DDL's server, bound to an
    ephemeral port in each run) ``<port>``, in an address or in a DDL's
    ``'port'`` property."""
    if isinstance(v, str) and tmp is not None:
        v = re.sub(r"127\.0\.0\.1:\d+", "127.0.0.1:<port>",
                   v.replace(tmp, "<tmp>"))
        return re.sub(r"'port': '\d+'", "'port': '<port>'", v)
    if v is None or isinstance(v, (bool, int, str, bytes)):
        return v
    if isinstance(v, float):
        return ("float", "nan" if math.isnan(v) else v.hex())
    if isinstance(v, np.generic):
        return plain(v.item(), tmp)
    if isinstance(v, torch.Tensor):
        return plain(v.detach().cpu().numpy(), tmp)
    if isinstance(v, np.ndarray):
        return [plain(x, tmp) for x in v.tolist()]
    if isinstance(v, dict):
        return {plain(k, tmp): plain(x, tmp) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [plain(x, tmp) for x in v]
    if isinstance(v, (set, frozenset)):
        return sorted((plain(x, tmp) for x in v), key=repr)
    if hasattr(v, "to_rows") and hasattr(v, "columns"):
        ts = getattr(v, "timestamps", None)
        return {"rows": plain(v.to_rows(), tmp),
                "ts": None if ts is None else plain(np.asarray(ts))}
    if type(v).__name__ == "Watermark":
        return ("watermark", v.timestamp)
    if hasattr(v, "__dataclass_fields__"):
        return plain(repr(v), tmp)
    if hasattr(v, "__array__"):
        return plain(np.asarray(v), tmp)
    return type(v).__name__


class Recorder:
    """Records what the wrapped calls of one package return or raise; a call
    nested inside a recorded one is not recorded again."""

    def __init__(self, tmp: str):
        self.log = []
        self.tmp = tmp
        self._depth = 0

    def wrap(self, monkeypatch, owner, name, label):
        fn = getattr(owner, name)
        rec = self

        def recorded(*args, **kwargs):
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
                rec.log.append((label, plain(out, rec.tmp)))
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
        ops = importlib.import_module(f"{package}.operators.sql_ops")
        base = importlib.import_module(f"{package}.operators.base")
        # the streaming join stamps its rows with the wall clock (its TTL
        # clock): one fixed instant in both runs
        monkeypatch.setattr(ops.StreamingJoinOperator, "_now_ms",
                            lambda self: NOW_MS)
        for name, cls in sorted(vars(ops).items()):
            if (isinstance(cls, type) and cls.__module__ == ops.__name__
                    and issubclass(cls, base.StreamOperator)):
                for meth in OPERATOR_METHODS:
                    if meth in vars(cls):
                        self.wrap(monkeypatch, cls, meth, f"{name}.{meth}")


def _cpu_when_unnamed(monkeypatch):
    """Every port module's ``resolve_device``: a device nobody names is the
    CPU for the port's run of a reference case."""
    real = flink_tpu_torch.resolve_device

    def resolve(device=None):
        return real("cpu" if device is None else device)

    for name, mod in list(sys.modules.items()):
        if (name.startswith("flink_tpu_torch")
                and getattr(mod, "resolve_device", None) is real):
            monkeypatch.setattr(mod, "resolve_device", resolve)


_SOURCES = {}


def _module(ref: str, side: str) -> types.ModuleType:
    """A fresh module of the reference file ``ref``: as written (``jax``),
    or importing the port in place of the JAX package (``port``)."""
    key = (ref, side)
    if key not in _SOURCES:
        src = (TESTS / f"{ref}.py").read_text()
        if side == "port":
            src = re.sub(r"\bflink_tpu\b", "flink_tpu_torch", src)
        _SOURCES[key] = compile(src, str(TESTS / f"{ref}.py"), "exec")
    mod = types.ModuleType(f"{ref}__{side}")
    mod.__file__ = str(TESTS / f"{ref}.py")
    exec(_SOURCES[key], mod.__dict__)
    return mod


def _cases():
    """``(id, reference file, function name, parametrize kwargs)`` for every
    case of the reference files, parametrized ones expanded."""
    out = []
    for ref in REFERENCE_FILES:
        src = (TESTS / f"{ref}.py").read_text()
        names = re.findall(r"^def (test_\w+)\(", src, re.M)
        mod = None
        for fn_name in names:
            cid = f"{ref}::{fn_name}"
            if cid in OWN_COUNTERPART:
                continue
            marks = re.search(
                rf"((?:^@pytest\.mark\.parametrize\(.*\)\n)+)^def {fn_name}\(",
                src, re.M)
            if marks is None:
                out.append(pytest.param(ref, fn_name, {}, id=cid))
                continue
            if mod is None:
                mod = _module(ref, "jax")
            grid = [{}]
            for mark in getattr(mod.__dict__[fn_name], "pytestmark", []):
                argnames, argvalues = mark.args[:2]
                argnames = [a.strip() for a in argnames.split(",")] \
                    if isinstance(argnames, str) else list(argnames)
                grid = [{**g, **dict(zip(argnames, v if len(argnames) > 1
                                         else (v,)))}
                        for g in grid for v in argvalues]
            for g in grid:
                pid = "-".join(str(v) for v in g.values())
                out.append(pytest.param(ref, fn_name, g, id=f"{cid}[{pid}]"))
    return out


def _run(ref, fn_name, params, side, tmp_path_factory):
    """The case through one package; returns its record."""
    mp = pytest.MonkeyPatch()
    tmp = tmp_path_factory.mktemp(f"{fn_name[:20]}_{side}")
    rec = Recorder(str(tmp))
    finalizers = []
    try:
        package = "flink_tpu" if side == "jax" else "flink_tpu_torch"
        rec.install(mp, package)
        if side == "port":
            _cpu_when_unnamed(mp)
        mod = _module(ref, side)
        case_mp = pytest.MonkeyPatch()
        finalizers.append(case_mp.undo)

        def resolve(name):
            if name in params:
                return params[name]
            if name == "tmp_path":
                return tmp
            if name == "monkeypatch":
                return case_mp
            fixture = mod.__dict__[name]
            fn = fixture._get_wrapped_function()
            value = fn(*[resolve(p) for p in
                         inspect.signature(fn).parameters])
            if inspect.isgenerator(value):
                gen, value = value, next(value)
                finalizers.append(lambda: next(gen, None))
            return value

        fn = mod.__dict__[fn_name]
        fn(*[resolve(p) for p in inspect.signature(fn).parameters])
    finally:
        for f in reversed(finalizers):
            f()
        mp.undo()
    return rec.log


@pytest.mark.parametrize("ref, fn_name, params", _cases())
def test_reference_case(ref, fn_name, params, tmp_path_factory,
                        verdicts):  # noqa: F811 — the fixture
    verdicts(taxed=False, shards=1, super_shards=1, depth=1, probe=False)
    want = _run(ref, fn_name, params, "jax", tmp_path_factory)
    got = _run(ref, fn_name, params, "port", tmp_path_factory)
    assert want, f"{fn_name} records nothing to compare"
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, f"record {i} of {fn_name} differs"
