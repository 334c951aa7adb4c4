"""One run of one cell: find the cell's files by name, run its driver,
read the per-layer metrics, check the answers against the plain reference,
and build the result line.

Everything that belongs to one configuration, traffic mix or metric is a
file of its own, found by the name ``BENCHMARK.json`` gives it:

- ``portbench/configs/<config>.json`` (the path in ``configs[].file``):
  the deployment, its ``driver`` and ``reference``;
- ``portbench/traffic/<mix>.json``: the traffic mix's parameters;
- ``portbench/limits/<workload>.json``: the limit of each number the
  cell's check compares;
- ``portbench/drivers/<driver>.py``: a family's set-up and timed loop, a
  ``Driver`` class;
- ``portbench/reference/<reference>.py``: the plain reference;
- ``portbench/metrics/<metric>.py``: a per-layer metric's reader,
  ``read(ctx) -> float | None``;
- ``portbench/work/<config>.py``: the bytes and operations the
  configuration's work needs, ``window_work(ctx) -> (bytes, flops) |
  None``.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

from portbench.lib import peaks
from portbench.lib.host import HostClock
from portbench.lib.traces import Window, sync

REPO = Path(__file__).resolve().parents[2]
#: top-level module names that may not be loaded in a run's process: JAX
#: and the JAX package the port was made from
FORBIDDEN = ("jax", "jaxlib", "flax", "flink_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str, root: Path = REPO):
    """``portbench/<kind>/<name>.py`` under ``root``, loaded from its path
    (a name may hold dots)."""
    path = root / "portbench" / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path}")
    mod_name = "portbench_" + kind + "_" + "".join(
        c if c.isalnum() else "_" for c in name)
    mod = sys.modules.get(mod_name)
    if mod is not None and getattr(mod, "__file__", None) == str(path):
        return mod
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    """One entry of ``workloads`` with the files it names."""
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: Dict[str, float]
    #: end-to-end metric name -> unit, of the metrics this cell reports
    end_to_end: Dict[str, str]
    #: the per-layer entries this cell reports
    per_layer: List[dict] = field(default_factory=list)
    #: the checkout the cell's files were read from
    root: Path = REPO

    def module(self, kind: str, name: str):
        """A file of this cell's checkout (:func:`load_module`)."""
        return load_module(kind, name, self.root)


def load_cell(name: str, spec: Optional[dict] = None,
              root: Path = REPO) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` (or of ``spec``), with its
    configuration, traffic mix and limits read from their files under
    ``root``."""
    if spec is None:
        spec = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    config = load_json(root / configs[w["config"]]["file"])
    bench = root / "portbench"
    traffic = load_json(bench / "traffic" / f"{w['traffic']}.json")
    limits = load_json(bench / "limits" / f"{name}.json")

    def reports(m: dict) -> bool:
        return name in m["workloads"] if "workloads" in m else None

    e2e = {m["name"]: m["unit"] for m in spec["end_to_end"]
           if reports(m) in (True, None)}
    per_layer = [m for m in spec["per_layer"]
                 if reports(m) or (reports(m) is None and m["moves"] in e2e)]
    return Cell(name, int(w["chips"]), config, traffic, limits, e2e,
                per_layer, Path(root))


class Context:
    """What a per-layer metric's reader may read: ``Driver.counters()``
    over the window, the reduced trace (None untraced or on the CPU), the
    card's name, and the work the configuration needed."""

    def __init__(self, cell: Cell, counters: dict, trace: Optional[dict],
                 kind: str):
        self.cell = cell
        self.counters = counters
        self.trace = trace
        self.kind = kind

    def busy_s(self) -> Optional[float]:
        if self.trace is None or self.trace["busy_s"] <= 0:
            return None
        return self.trace["busy_s"]

    def idle_pct(self) -> Optional[float]:
        busy = self.busy_s()
        if busy is None:
            return None
        return 100.0 * (1.0 - busy / self.trace["window_s"])

    def roofline_pct(self) -> Optional[float]:
        """The least time the window's work needs on this card (the larger
        of its bytes at peak bandwidth and its operations at the f32 peak)
        as a share of the device's busy time."""
        busy = self.busy_s()
        if busy is None:
            return None
        work = self.cell.module("work",
                                self.cell.config["name"]).window_work(self)
        if work is None:
            return None
        n_bytes, flops = work
        least = max(n_bytes / peaks.peak(self.kind, "hbm_bytes_per_s"),
                    flops / peaks.peak(self.kind, "f32_flops"))
        return 100.0 * least / busy

    def phase_ms_per(self, phases, count_key: str) -> Optional[float]:
        """Milliseconds of the program's ``phase_ns`` ``phases`` over the
        window, per ``counters[count_key]``."""
        ns = self.counters.get("phase_ns")
        count = self.counters.get(count_key, 0)
        if ns is None or not count:
            return None
        return sum(ns.get(p, 0) for p in phases) / 1e6 / count


def device_info(device) -> dict:
    import torch
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (``flink_tpu_torch`` is not ``flink_tpu``)."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float) -> dict:
    """One run; returns the result line's object (with ``checks`` last).
    ``t_start`` is the process's start on ``time.perf_counter``."""
    import torch
    clock = [("start", t_start)]

    def lap(name: str) -> None:
        clock.append((name, time.perf_counter()))

    driver = cell.module("drivers", cell.config["driver"]).Driver(
        cell, seed, device)
    driver.setup()
    sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    window = Window(trace, device)
    host = HostClock()
    host.begin()
    driver.run(seconds, window)
    host.end()
    clock += [("setup", window.t0), ("window", window.t1)]
    dev = device_info(device)
    breakdown = None
    reduced = None
    if trace and device.type == "cuda":
        reduced = window.reduce()
        lap("trace")
        dev["busy_s"] = reduced["busy_s"]
        dev["window_s"] = reduced["window_s"]
        breakdown = {"device_ops": reduced["device_ops"],
                     "idle_gaps": reduced["idle_gaps"]}
    # the per-layer metrics are read in every run (those of the trace only
    # in a traced one) and reported in a traced run
    ctx = Context(cell, driver.counters(), reduced, dev["kind"])
    layers = {}
    for m in cell.per_layer:
        v = cell.module("metrics", m["name"]).read(ctx)
        if v is not None:
            layers[m["name"]] = {"value": float(v), "unit": m["unit"]}
    lap("metrics")
    values = dict(driver.end_to_end(window), setup_s=window.t0 - t_start)
    metrics = layers if trace else {
        name: {"value": float(values[name]), "unit": unit}
        for name, unit in cell.end_to_end.items()}
    driver.release()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    lap("release")
    attempted, failed, readings = driver.answers()
    lap("check")
    host_reading = host.reading()
    checks = {}
    for name, limit in cell.limits.items():
        checks[name] = {"value": readings.get(name), "limit": limit}
    correct = (attempted > 0 and all(
        c["value"] is not None and c["value"] <= c["limit"]
        for c in checks.values()))
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics, "device": dev}
    if breakdown is not None:
        out["breakdown"] = breakdown
    # host seconds of each stage of this run (the check's included), the
    # per-layer readings of an untraced run, and what the host did over the
    # window, for the record
    out["stage_s"] = {b[0]: b[1] - a[1] for a, b in zip(clock, clock[1:])}
    if not trace:
        out["layers"] = {k: v["value"] for k, v in layers.items()}
    out["host"] = host_reading
    out["checks"] = checks
    return out
