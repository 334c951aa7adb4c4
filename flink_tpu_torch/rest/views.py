"""Server-rendered dashboard views: job DAG SVG, flame graph SVG,
checkpoint-history and per-subtask backpressure HTML fragments (port of
``flink_tpu/rest/views.py``).

The reference ships a 17k-LoC Angular SPA (``flink-runtime-web/
web-dashboard``: dagre DAG view, d3-flame-graph, checkpoint drill-down,
per-subtask backpressure); this framework renders the same four views
server-side as SVG/HTML fragments the embedded dashboard injects — which
also makes them assertable by automated DOM tests (parse the markup, no
browser needed)."""

from __future__ import annotations

import html
from typing import Any, Dict, List, Optional


def _esc(s: Any) -> str:
    return html.escape(str(s), quote=True)


# ---------------------------------------------------------------------------
# job DAG (dagre-analog layered layout)
# ---------------------------------------------------------------------------

def plan_svg(plan: Dict[str, Any]) -> str:
    """ExecutionPlan view -> layered SVG.  ``plan``: {"vertices": [{id,
    name, parallelism}], "edges": [{source, target, partitioning}]}.
    Layers = longest-path depth from sources; vertices are rounded rects,
    edges cubic paths labeled with their partitioning."""
    vertices = plan.get("vertices", [])
    edges = plan.get("edges", [])
    depth: Dict[Any, int] = {v["id"]: 0 for v in vertices}
    for _ in range(len(vertices)):
        for e in edges:
            if e["source"] in depth and e["target"] in depth:
                depth[e["target"]] = max(depth[e["target"]],
                                         depth[e["source"]] + 1)
    layers: Dict[int, List[dict]] = {}
    for v in vertices:
        layers.setdefault(depth[v["id"]], []).append(v)
    BW, BH, HGAP, VGAP, PAD = 190, 54, 90, 28, 24
    pos: Dict[Any, tuple] = {}
    max_rows = max((len(vs) for vs in layers.values()), default=1)
    for d in sorted(layers):
        for i, v in enumerate(layers[d]):
            x = PAD + d * (BW + HGAP)
            y = PAD + i * (BH + VGAP)
            pos[v["id"]] = (x, y)
    width = PAD * 2 + (max(layers, default=0) + 1) * (BW + HGAP) - HGAP
    height = PAD * 2 + max_rows * (BH + VGAP) - VGAP
    parts = [f'<svg xmlns="http://www.w3.org/2000/svg" class="job-dag" '
             f'viewBox="0 0 {width} {height}" width="{width}" '
             f'height="{height}">']
    for e in edges:
        if e["source"] not in pos or e["target"] not in pos:
            continue
        x1, y1 = pos[e["source"]]
        x2, y2 = pos[e["target"]]
        sx, sy = x1 + BW, y1 + BH / 2
        tx, ty = x2, y2 + BH / 2
        mx = (sx + tx) / 2
        parts.append(
            f'<path class="dag-edge" d="M {sx} {sy} C {mx} {sy}, '
            f'{mx} {ty}, {tx} {ty}" fill="none" stroke="#8b949e" '
            f'stroke-width="1.5" marker-end="url(#arr)"/>')
        label = _esc(e.get("partitioning", ""))
        if label:
            parts.append(f'<text class="dag-edge-label" x="{mx}" '
                         f'y="{(sy + ty) / 2 - 5}" font-size="10" '
                         f'fill="#8b949e" text-anchor="middle">{label}'
                         f'</text>')
    parts.append('<defs><marker id="arr" viewBox="0 0 10 10" refX="9" '
                 'refY="5" markerWidth="7" markerHeight="7" '
                 'orient="auto-start-reverse">'
                 '<path d="M 0 0 L 10 5 L 0 10 z" fill="#8b949e"/>'
                 '</marker></defs>')
    for v in vertices:
        x, y = pos[v["id"]]
        name = _esc(v.get("name", v["id"]))
        parts.append(
            f'<g class="dag-vertex" data-vertex-id="{_esc(v["id"])}">'
            f'<rect x="{x}" y="{y}" width="{BW}" height="{BH}" rx="8" '
            f'fill="#1c2430" stroke="#2f81f7" stroke-width="1.5"/>'
            f'<text x="{x + BW / 2}" y="{y + 22}" font-size="12" '
            f'fill="#e6edf3" text-anchor="middle">{name}</text>'
            f'<text x="{x + BW / 2}" y="{y + 40}" font-size="10" '
            f'fill="#8b949e" text-anchor="middle">parallelism '
            f'{_esc(v.get("parallelism", 1))}</text></g>')
    parts.append("</svg>")
    return "".join(parts)


# ---------------------------------------------------------------------------
# flame graph (d3-flame-graph analog, static SVG)
# ---------------------------------------------------------------------------

def flamegraph_svg(tree: Dict[str, Any], width: int = 1000,
                   row_h: int = 18, max_depth: int = 40) -> str:
    """{name, value, children} tree -> icicle-layout SVG (root at top)."""
    total = max(tree.get("value", 0), 1)

    rects: List[str] = []
    depth_max = 0

    def walk(node, x0: float, x1: float, depth: int):
        nonlocal depth_max
        if depth > max_depth or x1 - x0 < 0.5:
            return
        depth_max = max(depth_max, depth)
        w = x1 - x0
        name = _esc(node.get("name", ""))
        pct = 100.0 * node.get("value", 0) / total
        hue = 20 + (hash(name) % 20)
        rects.append(
            f'<g class="flame-frame" data-depth="{depth}">'
            f'<rect x="{x0:.2f}" y="{depth * row_h}" width="{w:.2f}" '
            f'height="{row_h - 1}" fill="hsl({hue},85%,{60 - depth % 3 * 4}%)"'
            f'><title>{name} — {node.get("value", 0)} samples '
            f'({pct:.1f}%)</title></rect>')
        if w > 40:
            shown = name if len(name) * 6 < w else name[: int(w / 6)] + "…"
            # style (not attribute): survives the dashboard's
            # `#flame text{fill:#fff}` ID-selector rule
            rects.append(
                f'<text x="{x0 + 3:.2f}" y="{depth * row_h + 13}" '
                f'font-size="10" style="fill:#1a1a1a">{shown}</text>')
        rects.append("</g>")
        x = x0
        for c in node.get("children", []):
            cw = w * c.get("value", 0) / max(node.get("value", 1), 1)
            walk(c, x, x + cw, depth + 1)
            x += cw

    walk(tree, 0.0, float(width), 0)
    height = (depth_max + 1) * row_h
    return (f'<svg xmlns="http://www.w3.org/2000/svg" class="flamegraph" '
            f'viewBox="0 0 {width} {height}" width="100%" '
            f'height="{height}">' + "".join(rects) + "</svg>")


# ---------------------------------------------------------------------------
# checkpoint drill-down + per-subtask backpressure (HTML fragments)
# ---------------------------------------------------------------------------

def checkpoints_html(history: List[Dict[str, Any]],
                     completed_ids: List[int]) -> str:
    """Checkpoint-history drill-down table (CheckpointStatsTracker view)."""
    rows = []
    done = set(completed_ids)
    for cp in history:
        cid = cp.get("id")
        state = cp.get("state") or ("COMPLETED" if cid in done
                                    else "IN_PROGRESS")
        rows.append(
            f'<tr class="ckpt-row" data-checkpoint-id="{_esc(cid)}">'
            f'<td>{_esc(cid)}</td><td>{_esc(state)}</td>'
            f'<td>{_esc(cp.get("duration_ms", "—"))}</td>'
            f'<td>{_esc(cp.get("state_size_bytes", "—"))}</td>'
            f'<td>{_esc(cp.get("kind", "checkpoint"))}</td></tr>')
    if not rows:
        rows.append('<tr class="ckpt-row"><td colspan="5">no checkpoints '
                    'yet</td></tr>')
    return ('<table class="ckpt-table"><thead><tr><th>id</th><th>state</th>'
            '<th>duration (ms)</th><th>size (bytes)</th><th>kind</th>'
            '</tr></thead><tbody>' + "".join(rows) + "</tbody></table>")


def device_health_html(status: Dict[str, Any]) -> str:
    """Device-lane health panel (``job_status()["device_health"]``): tier
    state badge + watchdog/quarantine/heal counters.  Server-rendered, DOM
    -testable — same pattern as the checkpoint drill-down."""
    state = str(status.get("state", "healthy"))
    cls = "dh-healthy" if state == "healthy" else "dh-quarantined"
    rows = []
    for label, key in (("quarantines", "quarantines"),
                       ("heals", "heals"),
                       ("watchdog timeouts", "watchdog_timeouts"),
                       ("watchdog near-misses", "near_misses"),
                       ("transient retries", "transient_retries"),
                       ("OOM page-outs", "oom_pageouts"),
                       ("degraded operators", "degraded_operators"),
                       ("tier migrations", "quarantine_migrations"),
                       ("re-promotions", "repromotions")):
        rows.append(f'<tr class="dh-row" data-metric="{_esc(key)}">'
                    f'<td>{_esc(label)}</td>'
                    f'<td>{_esc(status.get(key, 0))}</td></tr>')
    failure = status.get("last_failure")
    detail = (f'<div class="dh-failure">last failure: {_esc(failure)}</div>'
              if failure else "")
    return (f'<div class="dh-panel">'
            f'<span class="dh-state {cls}" data-state="{_esc(state)}">'
            f'device tier: {_esc(state)}</span>{detail}'
            f'<table class="dh-table"><thead><tr><th>metric</th>'
            f'<th>value</th></tr></thead><tbody>' + "".join(rows)
            + "</tbody></table></div>")


def autoscaler_html(status: Dict[str, Any]) -> str:
    """Reactive-autoscaler panel (``job_status()["autoscaler"]``): the
    rescale lifecycle's state badge, current→target parallelism, the
    rescale/rollback/re-trigger counters, cooldown, the parallelism path
    the job has walked, and the last observed signals.  Server-rendered,
    DOM-testable — same pattern as the device-health panel."""
    if not status:
        return ('<div class="as-panel"><span class="as-state as-off" '
                'data-state="off">autoscaler: off</span></div>')
    state = str(status.get("state", "?"))
    cur = status.get("current_parallelism", "?")
    tgt = status.get("target_parallelism", "?")
    cls = ("as-rescaling" if state == "Restarting" else "as-running")
    rows = []
    for label, key in (("rescales", "rescales"),
                       ("rollbacks", "rollbacks"),
                       ("re-triggers", "retriggers"),
                       ("rescales skipped", "rescales_skipped"),
                       ("last rescale duration (ms)",
                        "last_rescale_duration_ms"),
                       ("cooldown remaining (ms)", "cooldown_remaining_ms"),
                       ("min parallelism", "min_parallelism"),
                       ("max parallelism", "max_parallelism")):
        rows.append(f'<tr class="as-row" data-metric="{_esc(key)}">'
                    f'<td>{_esc(label)}</td>'
                    f'<td>{_esc(status.get(key, 0))}</td></tr>')
    path = " → ".join(str(p) for p in status.get("parallelism_path", []))
    sig = status.get("signals") or {}
    sig_items = "".join(
        f'<span class="as-signal" data-signal="{_esc(k)}">'
        f'{_esc(k)}={_esc(v)}</span> ' for k, v in sorted(sig.items()))
    return (f'<div class="as-panel">'
            f'<span class="as-state {cls}" data-state="{_esc(state)}">'
            f'autoscaler: {_esc(state)} · parallelism {_esc(cur)} → '
            f'{_esc(tgt)}</span>'
            f'<div class="as-path" data-path="{_esc(path)}">path: '
            f'{_esc(path)}</div>'
            f'<div class="as-signals">{sig_items}</div>'
            f'<table class="as-table"><thead><tr><th>metric</th>'
            f'<th>value</th></tr></thead><tbody>' + "".join(rows)
            + "</tbody></table></div>")


def ha_html(status: Dict[str, Any]) -> str:
    """Coordinator-HA panel (``job_status()["ha"]``): leader/demoted
    badge, the fencing epoch every control message carries, the lease
    holder + deadline, which source recovery restored from, and the
    stale-epoch rejection counters.  Server-rendered, DOM-testable —
    same pattern as the autoscaler panel."""
    if not status or not status.get("enabled"):
        return ('<div class="ha-panel"><span class="ha-state ha-off" '
                'data-state="off">ha: off</span></div>')
    demoted = bool(status.get("demoted"))
    state = "demoted" if demoted else "leading"
    cls = "ha-demoted" if demoted else "ha-leading"
    epoch = status.get("leader_epoch", 0)
    rows = []
    for label, key in (("job id", "job_id"),
                       ("lease holder", "holder"),
                       ("lease deadline (unix s)", "lease_deadline"),
                       ("restore source", "restore_source"),
                       ("fenced completions", "fenced_completions"),
                       ("fenced worker msgs", "fenced_worker_msgs")):
        rows.append(f'<tr class="ha-row" data-metric="{_esc(key)}">'
                    f'<td>{_esc(label)}</td>'
                    f'<td>{_esc(status.get(key, ""))}</td></tr>')
    return (f'<div class="ha-panel">'
            f'<span class="ha-state {cls}" data-state="{_esc(state)}" '
            f'data-epoch="{_esc(epoch)}">'
            f'ha: {_esc(state)} · epoch {_esc(epoch)}</span>'
            f'<table class="ha-table"><thead><tr><th>field</th>'
            f'<th>value</th></tr></thead><tbody>' + "".join(rows)
            + "</tbody></table></div>")


def queryable_html(stats: Dict[str, Any]) -> str:
    """Queryable serving tier panel (``job_status()["queryable"]``):
    per-state lookup volume/latency + replica staleness and shard
    manifests.  Server-rendered, DOM-testable — same pattern as the
    device-health panel."""
    per_state = stats.get("per_state", {})
    lag = stats.get("replica_lag_checkpoints", 0)
    protocols = stats.get("protocols") or {}
    head = (f'<div class="qs-summary" '
            f'data-lookups="{_esc(stats.get("lookups_total", 0))}" '
            f'data-serve-p99="{_esc(stats.get("serve_p99_ms"))}" '
            f'data-cache-hit-rate='
            f'"{_esc(stats.get("cache_hit_rate", 0))}" '
            f'data-replica-lag="{_esc(lag)}">'
            f'lookups {_esc(stats.get("lookups_total", 0))} · '
            f'{_esc(stats.get("lookups_per_sec", 0))}/s · '
            # both latency readings, labelled: the SERVER-side service
            # time (lookup + serialization in the handler) is the honest
            # serve cost; the lookup p99 excludes serialization
            f'serve p99 {_esc(stats.get("serve_p99_ms"))} ms '
            f'(server-side) · '
            f'lookup p99 {_esc(stats.get("lookup_p99_ms"))} ms · '
            f'binary {_esc(protocols.get("binary", 0))} / '
            f'json {_esc(protocols.get("json", 0))} · '
            f'cache hit {_esc(stats.get("cache_hit_rate", 0))} · '
            f'replica lag {_esc(lag)} ckpts / '
            f'{_esc(stats.get("replica_lag_ms", 0))} ms</div>')
    rows = []
    for name in sorted(per_state):
        s = per_state[name]
        rep = s.get("replica", {})
        laggards = ",".join(rep.get("laggards", [])) or "-"
        rows.append(
            f'<tr class="qs-row" data-state="{_esc(name)}" '
            f'data-laggards="{_esc(laggards)}">'
            f'<td>{_esc(name)}</td>'
            f'<td>{_esc(s.get("lookups", 0))}</td>'
            f'<td>{_esc(s.get("lookup_p50_ms"))}</td>'
            f'<td>{_esc(s.get("lookup_p99_ms"))}</td>'
            f'<td>{_esc(rep.get("serving_checkpoint_id"))}</td>'
            f'<td>{_esc(rep.get("replica_lag_checkpoints", 0))}</td>'
            f'<td>{_esc(rep.get("replicas", 1))}</td>'
            f'<td>{_esc(laggards)}</td>'
            f'<td>{_esc(len(rep.get("shards", [])))}</td></tr>')
    return (f'<div class="qs-panel">{head}'
            f'<table class="qs-table"><thead><tr><th>state</th>'
            f'<th>lookups</th><th>p50 ms</th><th>p99 ms</th>'
            f'<th>serving ckpt</th><th>lag</th><th>replicas</th>'
            f'<th>laggards</th><th>shards</th>'
            f'</tr></thead><tbody>' + "".join(rows)
            + "</tbody></table></div>")


def latency_html(hops: List[Dict[str, Any]]) -> str:
    """Per-(source, operator-hop) latency panel
    (``job_status()["latency"]`` rows from the LatencyMarker flow):
    p50/p95/p99/max per hop.  Server-rendered, DOM-testable — same
    pattern as the device-health panel."""
    if not hops:
        return ('<div class="lat-panel" data-hops="0">no latency markers '
                'recorded — set metrics.latency.interval to enable</div>')
    rows = []
    for h in hops:
        rows.append(
            f'<tr class="lat-row" data-source="{_esc(h["source"])}" '
            f'data-hop="{_esc(h["hop"])}">'
            f'<td>{_esc(h["source"])}[{_esc(h["source_subtask"])}]</td>'
            f'<td>{_esc(h["hop"])}</td>'
            f'<td>{_esc(h["count"])}</td>'
            f'<td>{_esc(h["p50_ms"])}</td>'
            f'<td>{_esc(h["p95_ms"])}</td>'
            f'<td>{_esc(h["p99_ms"])}</td>'
            f'<td>{_esc(h["max_ms"])}</td></tr>')
    return (f'<div class="lat-panel" data-hops="{len(hops)}">'
            f'<table class="lat-table"><thead><tr><th>source</th>'
            f'<th>hop</th><th>samples</th><th>p50 ms</th><th>p95 ms</th>'
            f'<th>p99 ms</th><th>max ms</th></tr></thead><tbody>'
            + "".join(rows) + "</tbody></table></div>")


def backpressure_html(vertices: List[Dict[str, Any]],
                      checkpoints: Optional[Dict[str, Any]] = None) -> str:
    """Per-SUBTASK busy/backpressure/idle bars (the reference's subtask
    backpressure tab), one row per subtask under its vertex — plus, when
    present, the per-channel queue-depth/backpressured-time table and the
    checkpoint-alignment summary of the unaligned-checkpoint path (same
    server-rendered, DOM-testable pattern as the device-health panel)."""
    out = ['<div class="bp-view">']
    cp = checkpoints or {}
    if cp:
        out.append(
            f'<div class="bp-alignment">'
            f'<span class="bp-align-item" data-metric='
            f'"last_alignment_duration_ms">alignment '
            f'{_esc(cp.get("last_alignment_duration_ms", 0))} ms</span>'
            f'<span class="bp-align-item" data-metric='
            f'"last_overtaken_bytes">overtaken '
            f'{_esc(cp.get("last_overtaken_bytes", 0))} B</span>'
            f'<span class="bp-align-item" data-metric='
            f'"last_persisted_inflight_bytes">persisted in-flight '
            f'{_esc(cp.get("last_persisted_inflight_bytes", 0))} B</span>'
            f'<span class="bp-align-item" data-metric='
            f'"unaligned_checkpoints">unaligned checkpoints '
            f'{_esc(cp.get("unaligned_checkpoints", 0))}</span></div>')
    for v in vertices:
        out.append(f'<div class="bp-vertex" data-vertex-id='
                   f'"{_esc(v["id"])}"><h3>{_esc(v.get("name", v["id"]))}'
                   f"</h3>")
        for s in v.get("subtasks", []):
            busy = float(s.get("busy_ratio", 0))
            bp = float(s.get("backpressure_ratio", 0))
            idle = float(s.get("idle_ratio", 0))
            out.append(
                f'<div class="bp-subtask" data-subtask='
                f'"{_esc(s.get("index"))}">'
                f'<span class="bp-label">#{_esc(s.get("index"))} '
                f'{_esc(s.get("state", ""))}</span>'
                f'<div class="bp-bar">'
                f'<div class="bp-busy" style="width:{busy * 100:.1f}%">'
                f"</div>"
                f'<div class="bp-backpressured" '
                f'style="width:{bp * 100:.1f}%"></div>'
                f'<div class="bp-idle" style="width:{idle * 100:.1f}%">'
                f"</div></div>"
                f'<span class="bp-pct">busy {busy * 100:.0f}% · bp '
                f'{bp * 100:.0f}% · idle {idle * 100:.0f}%</span>')
            chans = s.get("channels") or []
            if chans:
                rows = "".join(
                    f'<tr class="bp-chan" data-channel="{_esc(c["name"])}">'
                    f'<td>{_esc(c["name"])}</td><td>{_esc(c["depth"])}</td>'
                    f'<td>{_esc(c.get("queued_bytes", 0))}</td>'
                    f'<td>{_esc(c.get("backpressured_ms", 0))}</td></tr>'
                    for c in chans)
                out.append(
                    f'<table class="bp-chan-table" data-alignment-queued='
                    f'"{_esc(s.get("alignment_queued", 0))}">'
                    f'<thead><tr><th>channel</th><th>depth</th>'
                    f'<th>queued bytes</th><th>backpressured (ms)</th>'
                    f'</tr></thead><tbody>{rows}</tbody></table>')
            out.append("</div>")
        out.append("</div>")
    out.append("</div>")
    return "".join(out)
