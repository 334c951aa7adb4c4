"""Thread-sampling flame graphs (port of ``flink_tpu/rest/flamegraph.py``).

Analog of the reference's REST-triggered task sampling
(``ThreadInfoRequestCoordinator`` + ``JobVertexFlameGraphFactory`` rendered
by d3-flame-graph): sample every live thread's Python stack via
``sys._current_frames`` at a fixed interval, fold identical stacks, and
build the nested-tree JSON a flame graph renders from.
"""

from __future__ import annotations

import sys
import threading
import time
import traceback
from collections import Counter
from typing import Any, Dict, List, Optional


def sample_stacks(duration_ms: int = 200, interval_ms: int = 5,
                  thread_prefix: Optional[str] = None,
                  thread_names: Optional[set] = None) -> Counter:
    """Collapsed stack counter: 'frameA;frameB;frameC' -> samples.
    ``thread_names``: exact-name allowlist (per-job scoping); otherwise
    ``thread_prefix`` filters by prefix."""
    folded: Counter = Counter()
    deadline = time.monotonic() + duration_ms / 1000.0
    names = {t.ident: t.name for t in threading.enumerate()}
    while time.monotonic() < deadline:
        for tid, frame in sys._current_frames().items():
            name = names.get(tid, str(tid))
            if tid == threading.get_ident():
                continue  # skip the sampler itself
            if thread_names is not None:
                if name not in thread_names:
                    continue
            elif thread_prefix and not name.startswith(thread_prefix):
                continue
            stack = traceback.extract_stack(frame)
            key = ";".join(f"{f.name} ({f.filename.rsplit('/', 1)[-1]}"
                           f":{f.lineno})" for f in stack)
            folded[key] += 1
        time.sleep(interval_ms / 1000.0)
    return folded


def folded_to_tree(folded: Counter) -> Dict[str, Any]:
    """Collapsed stacks -> d3-flame-graph nested {name, value, children}."""
    root: Dict[str, Any] = {"name": "root", "value": 0, "children": {}}
    for stack, count in folded.items():
        root["value"] += count
        node = root
        for frame in stack.split(";"):
            child = node["children"].get(frame)
            if child is None:
                child = {"name": frame, "value": 0, "children": {}}
                node["children"][frame] = child
            child["value"] += count
            node = child

    def finalize(node: Dict[str, Any]) -> Dict[str, Any]:
        return {"name": node["name"], "value": node["value"],
                "children": [finalize(c) for c in node["children"].values()]}

    return finalize(root)


def flamegraph(duration_ms: int = 200, interval_ms: int = 5,
               thread_prefix: Optional[str] = "task-",
               thread_names: Optional[set] = None) -> Dict[str, Any]:
    return folded_to_tree(sample_stacks(duration_ms, interval_ms,
                                        thread_prefix, thread_names))
