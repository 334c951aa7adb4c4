"""``BENCHMARK.json`` against the rules a benchmark file keeps, every cell
loaded by name, and a configuration, traffic mix, cell and metric added as
new files only, in a copy of the tree, and run."""

import json
import re
import shutil

import pytest

from portbench.lib import harness
from portbench.tests.small import SMALL, run_small, small_cell

SPEC = harness.load_json(harness.REPO / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
CELLS = [w["name"] for w in SPEC["workloads"]]


def _line(text):
    return (isinstance(text, str) and 1 <= len(text) <= 200
            and "\n" not in text and "\t" not in text)


def test_top_level_shape():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "portbench/run.py"]
    assert 1 <= len(SPEC["paths"]) <= 16
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p
               for p in SPEC["paths"])
    assert isinstance(SPEC["run_seconds"], int)
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len((harness.REPO / "BENCHMARK.json").read_bytes()) <= 64 << 10


def test_names_units_and_lines():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in SPEC[group]:
            assert NAME.match(e["name"]), e["name"]
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
    for e in SPEC["configs"] + SPEC["workloads"]:
        assert _line(e["why"]), e["name"]
    for e in SPEC["configs"]:
        assert _line(e["source"]), e["name"]
    for e in SPEC["per_layer"]:
        assert _line(e["layer"]), e["name"]
    metrics = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(set(metrics)) == len(metrics)
    assert len(set(CELLS)) == len(CELLS)


def test_configs_and_cells():
    configs = {c["name"]: c for c in SPEC["configs"]}
    assert 1 <= len(configs) <= 24 and 1 <= len(CELLS) <= 24
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/")
        assert c["source"].startswith("https://")
        assert len(c["reduced"]) <= 16
        data = harness.load_json(harness.REPO / c["file"])
        assert data["name"] == c["name"] and data["reduced"] == c["reduced"]
        assert _line(data["source"])
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == set(configs)
    pairs = {(w["config"], w["traffic"]) for w in SPEC["workloads"]}
    assert len(pairs) == len(CELLS)
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and _line(w["why"])


def test_metrics():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e
        assert (harness.REPO / "portbench" / "metrics"
                / f"{m['name']}.py").is_file()
        for cell in m.get("workloads", []):
            assert cell in CELLS
            mv = e2e[m["moves"]]
            assert "workloads" not in mv or cell in mv["workloads"]
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_loads_by_name(name):
    cell = harness.load_cell(name)
    assert "setup_s" in cell.end_to_end and len(cell.end_to_end) >= 2
    assert cell.per_layer
    assert cell.limits
    driver = cell.module("drivers", cell.config["driver"])
    assert hasattr(driver, "Driver")
    cell.module("work", cell.config["name"])
    ref = cell.traffic.get("reference", cell.config.get("reference"))
    cell.module("reference", ref)
    with pytest.raises(KeyError):
        harness.load_cell(name + ".absent")


def test_new_files_alone_add_a_cell_and_a_metric(tmp_path):
    """A copy of the tree gains a configuration, a mix, a cell, its limits
    and a metric as new files plus entries in its BENCHMARK.json; no file
    the tree had is edited, and the new cell runs and reports the new
    metric."""
    shutil.copytree(harness.REPO / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p: p.read_bytes() for p in (tmp_path / "portbench").rglob("*")
              if p.is_file()}
    spec = json.loads(json.dumps(SPEC))
    config = harness.load_json(harness.REPO / "portbench/configs/"
                               "tumble_sum_1m.json")
    config.update(SMALL["window"][0], name="tumble_tiny",
                  checkpoint_every_batches=4)
    (tmp_path / "portbench/configs/tumble_tiny.json").write_text(
        json.dumps(config))
    mix = dict(harness.load_json(harness.REPO / "portbench/traffic/"
                                 "uniform.json"),
               **SMALL["window"][1], ms_per_batch=500)
    (tmp_path / "portbench/traffic/halfsecond.json").write_text(
        json.dumps(mix))
    (tmp_path / "portbench/limits/tumble_tiny.halfsecond.json").write_text(
        (harness.REPO / "portbench/limits/tumble_sum_1m.uniform.json")
        .read_text())
    (tmp_path / "portbench/metrics/rows_per_fire.py").write_text(
        "def read(ctx):\n"
        "    c = ctx.counters\n"
        "    return c['fired_rows'] / c['fires'] if c['fires'] else None\n")
    (tmp_path / "portbench/work/tumble_tiny.py").write_text(
        "def window_work(ctx):\n    return None\n")
    spec["configs"].append({"name": "tumble_tiny", "source": "https://x.org",
                            "file": "portbench/configs/tumble_tiny.json",
                            "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "tumble_tiny.halfsecond",
                              "config": "tumble_tiny",
                              "traffic": "halfsecond",
                              "chips": 1, "why": "a test"})
    for m in spec["end_to_end"]:
        if "records_per_s" == m["name"]:
            m["workloads"].append("tumble_tiny.halfsecond")
    spec["per_layer"].append({"name": "rows_per_fire", "unit": "rows",
                              "better": "higher", "source": "host_clock",
                              "layer": "operator fire path",
                              "moves": "records_per_s"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = harness.load_cell("tumble_tiny.halfsecond", root=tmp_path)
    assert "rows_per_fire" in [m["name"] for m in cell.per_layer]
    out = run_small(cell, trace=True)
    assert out["correct"], out["checks"]
    assert out["metrics"]["rows_per_fire"]["value"] > 0
    assert set(cell.end_to_end) == {"records_per_s", "setup_s"}
    # the tree's own files are as they were, and its own cells still load
    for p, data in before.items():
        assert p.read_bytes() == data
    assert small_cell("tumble_sum_1m.uniform", root=tmp_path).per_layer
