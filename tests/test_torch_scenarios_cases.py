"""Port parity for the scenario suite: the reference's cases of
``tests/test_scenarios.py`` (the diurnal workload, the two-phase commit
sink, the CEP and session rescale machinery, the harness's units) run
through both packages with the harness of
``tests/test_torch_cluster_cases.py``, each keeping its reference marks;
the three end-to-end acceptance cases run in
``tests/test_torch_scenarios_acceptance.py``, and the HA kill at the peak
in ``tests/test_torch_ha_cases.py``.

``test_fraud_example_rides_the_scenario_pattern`` runs JAX's shipped
example (``examples/fraud_detection.py``), which imports JAX's scenario:
its counterpart runs the example's source with the port's package in
JAX's place.  The cross-package cases at the end hold that one seed gives
both packages the same diurnal stream, and that each scenario's unfaulted
control leg commits the same rows, as canonical JSON, in both.
"""

import pytest

from test_torch_calibration import verdicts  # noqa: F401 — the fixture
from test_torch_cluster_cases import (_cpu_when_unnamed, cases, check_case)

#: the acceptance cases: tests/test_torch_scenarios_acceptance.py
ACCEPTANCE = ("test_fraud_detection_exactly_once_under_kill",
              "test_sessionized_analytics_exactly_once_and_sql_crosscheck",
              "test_feature_store_exactly_once_with_routed_reads")

#: the example case (its counterpart is below)
EXAMPLE = "test_fraud_example_rides_the_scenario_pattern"


def _light():
    src = open(__file__.replace("test_torch_scenarios_cases",
                                "test_scenarios")).read()
    import re
    names = re.findall(r"^def (test_\w+)\(", src, re.M)
    return {"test_scenarios": tuple(n for n in names
                                    if n not in ACCEPTANCE + (EXAMPLE,))}


@pytest.mark.parametrize("ref, cls, fn_name, params",
                         cases(_light(), marks=True))
def test_reference_case(ref, cls, fn_name, params, tmp_path_factory,
                        verdicts):  # noqa: F811 — the fixture
    check_case(ref, cls, fn_name, params, tmp_path_factory, verdicts)


def test_fraud_example_on_the_ports_scenario(tmp_path_factory,
                                             verdicts):  # noqa: F811
    """``test_scenarios.py::test_fraud_example_rides_the_scenario_pattern``
    on both packages: the port's run executes the example's source with
    the port's package in JAX's place (the example imports the scenario's
    pattern and topology), and finds exactly the planted alerts."""
    run = '    ns = runpy.run_path(example, init_globals={"env": env})'
    ported = ('    import re\n'
              '    ns = {"env": env, "__name__": "<run_path>"}\n'
              '    exec(compile(re.sub(r"\\bflink_" r"tpu\\b", "flink_" '
              '"tpu_torch", open(example).read()), example, "exec"), ns)')
    check_case("test_scenarios", None, EXAMPLE, {}, tmp_path_factory,
               verdicts, port_patches=((run, ported),))


# ---------------------------------------------------------------------------
# one seed, both packages
# ---------------------------------------------------------------------------

def _scenario_modules():
    from flink_tpu import scenarios as jsc
    from flink_tpu.testing import workload as jw
    from flink_tpu_torch import scenarios as psc
    from flink_tpu_torch.testing import workload as pw
    return {"jax": (jsc, jw), "port": (psc, pw)}


@pytest.mark.parametrize("name", ["fraud_detection", "feature_store",
                                  "sessionized_analytics"])
def test_diurnal_batches_equal_for_one_seed(name):
    """Each scenario's ``DiurnalSource`` (its keys, values and per-split
    timestamp residue classes, drawn in the reference's order) yields the
    same batches, bit for bit, and the same pacing curve in both
    packages."""
    import numpy as np
    mods = _scenario_modules()
    out = {}
    for side, (sc, _w) in mods.items():
        scen = sc.get_scenario(name)
        spec = scen.spec(True, records=6_000, keys=211)
        src = scen.make_source(spec, paced=False)
        batches = []
        for split in src.create_splits(2):
            for b in src.read_split(split.index, split.of):
                batches.append({c: np.asarray(b.column(c))
                                for c in ("k", "v", "t")})
        out[side] = (batches, src.paces, src.n_batches,
                     src.expected_per_key())
    (jb, jp, jn, je), (pb, pp, pn, pe) = out["jax"], out["port"]
    assert (jp, jn, je) == (pp, pn, pe)
    assert len(jb) == len(pb) > 0
    for a, b in zip(jb, pb):
        for c in ("k", "v", "t"):
            assert a[c].dtype == b[c].dtype
            assert a[c].tobytes() == b[c].tobytes()
        assert np.all(a["t"] % 2 == a["t"][0] % 2)   # one residue a split


@pytest.mark.parametrize("name", ["feature_store", "sessionized_analytics",
                                  "fraud_detection"])
def test_control_leg_commits_the_same_rows(name, tmp_path, monkeypatch):
    """A scenario's unfaulted control leg (a parallelism-2 MiniCluster job
    into transactional Kafka sinks over the test-size stream) commits the
    same rows in both packages, character for character as canonical JSON,
    so the committed digests are equal: ``feature_store``'s and
    ``sessionized_analytics``' sums of ones are exact in JAX's f32 and the
    port's f64, and ``fraud_detection``'s alerts copy the input amounts."""
    mods = _scenario_modules()
    _cpu_when_unnamed(monkeypatch)
    legs = {}
    for side, (sc, _w) in mods.items():
        harness_mod = __import__(f"{sc.__name__}.harness",
                                 fromlist=["harness"])
        h = sc.ScenarioHarness(sc.get_scenario(name), smoke=True,
                               records=12_000, keys=211,
                               base_dir=str(tmp_path / side))
        leg = h._run_control()
        assert leg.state == "Finished", leg.error
        legs[side] = (leg.committed, harness_mod)
    (jc, jh), (pc, ph) = legs["jax"], legs["port"]
    assert sorted(jc) == sorted(pc) and sum(map(len, pc.values())) > 0
    for topic in jc:
        assert ph.canonical_rows(pc[topic]) == jh.canonical_rows(jc[topic])
    assert ph.committed_digest(pc) == jh.committed_digest(jc)
    assert ph.diff_committed(pc, jc) == (0, 0)
