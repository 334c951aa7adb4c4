"""Port parity for observability: the reference's cases of
``tests/test_tracing.py``, ``test_metrics.py`` and the device-health views
of ``test_device_health.py``, run through both packages with the harness
of ``tests/test_torch_cluster_cases.py``, each keeping its reference marks
(the REST server's, the dashboard's and the history server's are
``tests/test_torch_rest_cases.py``'s); and the hot paths' span sites held
to JAX's: the window operator's ``hot_stage`` phases, the pager's
``paging.page_out``/``page_in``, the watchdog's ``device_health.*``, CEP's
``cep.vectorized_drain`` and the exchange's ``mesh.exchange``.
"""

import pytest

from test_torch_calibration import verdicts  # noqa: F401 — the fixture
from test_torch_cluster_cases import cases, check_case

#: the device-health surface of ``test_device_health.py`` (its job status,
#: metrics and REST panel, and the cluster acceptance that reads them);
#: the rest of that file is ``tests/test_torch_device_health.py``'s
DEVICE_HEALTH_VIEWS = ("test_job_status_reports_device_health_defaults",
                       "test_device_health_metrics_registered",
                       "test_device_health_html_panel",
                       "test_acceptance_wedge_degrade_heal_cluster_exactly_"
                       "once")


@pytest.mark.parametrize(
    "ref, cls, fn_name, params",
    cases(("test_tracing", "test_metrics"), marks=True)
    + cases({"test_device_health": DEVICE_HEALTH_VIEWS}, marks=True))
def test_reference_case(ref, cls, fn_name, params, tmp_path_factory,
                        verdicts):  # noqa: F811 — the fixture
    check_case(ref, cls, fn_name, params, tmp_path_factory, verdicts)


# ---------------------------------------------------------------------------
# the hot paths' span sites, against JAX's
# ---------------------------------------------------------------------------

import collections  # noqa: E402
import contextlib  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

import flink_tpu.observability.tracing as jtr  # noqa: E402
import flink_tpu.parallel.exchange as jex  # noqa: E402
import flink_tpu_torch.observability.tracing as ptr  # noqa: E402
import flink_tpu_torch.parallel.exchange as pex  # noqa: E402
import test_torch_cep_vectorized as CV  # noqa: E402
import test_torch_device_health as DH  # noqa: E402
import test_torch_mesh as MS  # noqa: E402
from test_torch_calibration import _jax_x64  # noqa: E402

TRACING = {"jax": jtr, "port": ptr}
#: phases the port times and JAX does not: the device tier's boolean emit
#: mirror (``emit_mirror``), the mesh's exchange on the device lane
#: (``exchange``; JAX's runs inside its jitted step) and the mesh device
#: tier's fire (JAX's fires there outside its phase timer)
PORT_ONLY = {(1, "device"): {"emit_mirror"}, (4, "host"): {"exchange"},
             (4, "device"): {"exchange", "fire"}}


@pytest.fixture
def clean(verdicts):  # noqa: F811 — the fixture
    """Every verdict pinned and restored; both packages' monitors,
    injectors, CEP verdicts and journals put back."""
    verdicts(taxed=False, shards=1, super_shards=1, depth=1, probe=False)
    prev = {s: S["dh"].get_monitor(create=False)
            for s, S in MS.SIDES.items()}
    yield
    for s, S in MS.SIDES.items():
        S["dh"].set_monitor(prev[s])
        S["chaos"].uninstall()
        TRACING[s].uninstall()
    CV.jv._reset_calibration()
    CV.pv._reset_calibration()


@contextlib.contextmanager
def _journal(side):
    """Installs a fresh journal in ``side``'s tracing for the block; yields
    it (uninstalled after)."""
    j = TRACING[side].SpanJournal(1 << 17)
    TRACING[side].install(j)
    try:
        yield j
    finally:
        TRACING[side].uninstall()
    assert j.dropped == 0


def _by_thread(journal, keep):
    """The journal's spans whose (name, cat) ``keep`` accepts, per thread:
    (kind, name, category, arguments) in recording order."""
    out = collections.defaultdict(list)
    for ph, _ts, _dur, name, cat, tid, args in journal.spans():
        if keep(name, cat):
            out[tid].append((ph, name, cat, tuple(sorted((args or {})
                                                         .items()))))
    return dict(out)


def _phase_sums(journal):
    sums = collections.Counter()
    for ph, _ts, dur, name, cat, _tid, _args in journal.spans():
        if cat == "hot_stage":
            assert ph == "X"
            sums[name] += dur
    return dict(sums)


@pytest.mark.parametrize("lane", [(1, "host", "scatter", None),
                                  (1, "host", "deferred", None),
                                  (1, "device", "scatter", None),
                                  (1, "device", "scatter", 1024),
                                  (4, "host", "scatter", None),
                                  (4, "device", "scatter", None)],
                         ids=["host", "deferred", "device", "paged",
                              "mesh4-host", "mesh4-device"])
def test_hot_stage_and_paging_spans_equal_jax(lane, clean):
    """One seeded stream (late records, a mid-run snapshot, ``end_input``)
    through both operators with the journal installed: on each thread the
    port records JAX's sequence of ``hot_stage`` spans (the port's own
    phases, :data:`PORT_ONLY`, apart) and of ``paging.page_out``/
    ``paging.page_in`` with their arguments; in both packages each
    phase's span durations sum exactly to its ``phase_ns``."""
    D, tier, sync, cap = lane
    paging = None if cap is None else dict(capacity=cap)
    got = {}
    for side in ("jax", "port"):
        op = MS._mk(side, D, tier, sync, paging=paging)
        with _journal(side) as j, (_jax_x64() if side == "jax"
                                   else contextlib.nullcontext()):
            MS._run(side, op, snap_at=2, late_every=3)
        assert _phase_sums(j) == op.phase_ns
        skip = PORT_ONLY.get((D, tier), set()) if side == "port" else set()
        got[side] = _by_thread(
            j, lambda n, c: (c == "hot_stage" and n not in skip)
            or c == "paging")
    assert got["port"] == got["jax"]
    if cap is not None:
        names = {s[1] for spans in got["port"].values() for s in spans}
        assert {"paging.page_out", "paging.page_in"} <= names


def test_device_health_spans_equal_jax(clean):
    """The device tier's wedge, quarantine, salvage and heal cycle (a wedge
    at dispatch 8, a heal after batch 11, re-promotion at 14) records
    JAX's ``device_health.*`` instants and spans, arguments and order."""
    batches = DH._batches(values="random")
    got = {}
    for side in ("jax", "port"):
        with _journal(side) as j:
            DH._cycle(side, batches, {"pipeline_depth": 0},
                      **DH.DEVICE_CYCLE)
        got[side] = _by_thread(j, lambda n, c: c == "device_health")
    names = [s[1] for spans in got["port"].values() for s in spans]
    assert {"device_health.wedge", "device_health.quarantine",
            "device_health.salvage", "device_health.heal"} <= set(names)
    assert got["port"] == got["jax"]


def test_cep_drain_spans_equal_jax(clean):
    """Each vectorized drain of a seeded CEP stream records
    ``cep.vectorized_drain`` with its ``up_to_ts``, as JAX's does."""
    chunks, wms = CV._stream(7)
    got = {}
    for side in ("jax", "port"):
        op = CV._op(side, CV._corpus(side, "no_skip")["followed_by"], "on")
        with _journal(side) as j, _jax_x64():
            CV._feed(side, op, chunks, wms)
        got[side] = _by_thread(j, lambda n, c: c == "cep")
    assert sum(len(v) for v in got["port"].values()) > 3
    assert got["port"] == got["jax"]


def test_mesh_exchange_spans_equal_jax(clean):
    """The resizing exchange records ``mesh.exchange`` with its capacity
    and rows each round, the overflowed round and its re-run at twice the
    capacity included, as JAX's does."""
    rng = np.random.default_rng(3)
    B, D = 64, 4
    dest = np.zeros(B, np.int32)          # every row to position 0
    dest[::5] = rng.integers(0, D, dest[::5].size)
    vals = rng.random(B).astype(np.float32)
    got = {}
    for side in ("jax", "port"):
        if side == "jax":
            mesh = MS.SIDES["jax"]["mesh"](D)
            ex = jex.ResizingExchange(mesh, 1, cap=8)
            args = (jex.jnp.asarray(dest), jex.jnp.asarray(vals))
        else:
            mesh = MS.SIDES["port"]["mesh"](D)
            ex = pex.ResizingExchange(mesh, 1, cap=8)
            args = (torch.from_numpy(dest), torch.from_numpy(vals))
        with _journal(side) as j:
            ex(*args)
        got[side] = _by_thread(j, lambda n, c: c == "exchange")
    assert [s[3] for s in got["port"]["MainThread"]] == [
        (("cap", 8), ("rows", B)), (("cap", 16), ("rows", B)),
        (("cap", 32), ("rows", B)), (("cap", 64), ("rows", B))][
        :len(got["port"]["MainThread"])]
    assert got["port"] == got["jax"]
