"""REST API + web dashboard (port of ``flink_tpu/rest/server.py``, host
Python as JAX's).

Analog of the reference's REST endpoint (``RestServerEndpoint`` + ~100
typed handlers in ``runtime/rest/handler/job/*`` + the Angular dashboard of
``flink-runtime-web``): a threaded HTTP server over the MiniCluster's job
registry serving reference-shaped JSON plus a single-page dashboard that
polls it.

Endpoints:
  GET  /overview                      cluster overview
  GET  /jobs                          job listing
  GET  /jobs/<id>                     topology + per-vertex gauges
  GET  /jobs/<id>/checkpoints         completed checkpoint stats
  GET  /jobs/<id>/backpressure        busy/idle/backpressured per vertex
  GET  /jobs/<id>/metrics             numeric metrics incl. latency pcts
  GET  /jobs/<id>/autoscaler(.html)   reactive-autoscaler rescale status
  GET  /jobs/<id>/ha(.html)           coordinator HA: leader epoch + fences
  GET  /jobs/<id>/exceptions          root failure cause
  GET  /jobs/<id>/flamegraph          sampled task-thread flame graph
  POST /jobs/<id>/savepoints          trigger a savepoint
  PATCH /jobs/<id>                    cancel
  GET  /                              dashboard (HTML)
"""

from __future__ import annotations

import json
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Tuple

import numpy as np


class JobRegistry:
    """Named running/finished jobs the REST layer exposes."""

    def __init__(self):
        self._jobs: Dict[str, Tuple[str, Any]] = {}  # id -> (name, cluster)
        self._lock = threading.Lock()
        self._n = 0

    def register(self, name: str, cluster) -> str:
        with self._lock:
            self._n += 1
            job_id = f"job-{self._n:04d}"
            self._jobs[job_id] = (name, cluster)
            return job_id

    def jobs(self) -> List[Tuple[str, str, Any]]:
        with self._lock:
            return [(jid, name, c) for jid, (name, c) in self._jobs.items()]

    def get(self, job_id: str):
        with self._lock:
            return self._jobs.get(job_id)


def _percentiles(xs: List[float]) -> Dict[str, float]:
    if not xs:
        return {}
    a = np.asarray(xs)
    return {"p50": float(np.percentile(a, 50)),
            "p95": float(np.percentile(a, 95)),
            "p99": float(np.percentile(a, 99)),
            "max": float(a.max()), "count": len(xs)}


class MetricsHistory:
    """Per-job ring of periodic metric samples — the
    ``MetricStore``/``MetricFetcher`` analog behind the dashboard's
    per-operator graphs.  Sampled by the REST server's background thread;
    each sample is (wall ms, {vertex id: {records_in, records_out,
    busy_ratio, backpressure_ratio}})."""

    def __init__(self, capacity: int = 240):
        self.capacity = capacity
        self._lock = threading.Lock()
        self._series: Dict[str, List[dict]] = {}

    def sample(self, job_id: str, status: Dict[str, Any]) -> None:
        import time as _time
        entry = {"ts": int(_time.time() * 1000),
                 "vertices": {v["id"]: {
                     "records_in": v["records_in"],
                     "records_out": v["records_out"],
                     "busy_ratio": round(v.get("busy_ratio", 0.0), 4),
                     "backpressure_ratio": round(
                         v.get("backpressure_ratio", 0.0), 4)}
                     for v in status.get("vertices", [])}}
        with self._lock:
            ring = self._series.setdefault(job_id, [])
            ring.append(entry)
            del ring[:-self.capacity]

    def series(self, job_id: str) -> List[dict]:
        with self._lock:
            return list(self._series.get(job_id, []))


class RestServer:
    def __init__(self, registry: JobRegistry, host: str = "127.0.0.1",
                 port: int = 0, ssl_context=None,
                 auth_token: Optional[str] = None,
                 sample_interval_s: float = 1.0):
        """``ssl_context``: server-side TLS (``security.ssl.rest.enabled``
        analog); ``auth_token``: require ``Authorization: Bearer <token>``
        on every request.  A background thread samples every job's
        per-vertex metrics into ``MetricsHistory`` each
        ``sample_interval_s`` (the dashboard's graphs-over-time feed)."""
        self.registry = registry
        self._ssl = ssl_context
        self.history = MetricsHistory()
        self._sample_interval_s = sample_interval_s
        self._stop_sampling = threading.Event()
        registry_ref = registry
        token_ref = auth_token
        history_ref = self.history

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def parse_request(self):
                ok = super().parse_request()
                if ok and token_ref is not None:
                    import hmac as _hmac
                    got = self.headers.get("Authorization", "")
                    if not _hmac.compare_digest(got.encode(),
                                                f"Bearer {token_ref}".encode()):
                        self.send_error(401, "missing or wrong bearer token")
                        return False
                return ok

            def _send(self, obj, status: int = 200,
                      content_type: str = "application/json"):
                data = (obj if isinstance(obj, bytes)
                        else json.dumps(obj, default=str).encode())
                self.send_response(status)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def _job(self, job_id: str):
                entry = registry_ref.get(job_id)
                if entry is None:
                    self._send({"error": f"no job {job_id}"}, 404)
                    return None
                return entry

            def do_GET(self):  # noqa: N802
                path = self.path.split("?")[0].rstrip("/")
                if path == "" or path == "/index.html":
                    return self._send(_DASHBOARD_HTML.encode(),
                                      content_type="text/html")
                if path == "/overview":
                    jobs = registry_ref.jobs()
                    states = [c.job_status()["state"] for _, _, c in jobs]
                    return self._send({
                        "jobs_total": len(jobs),
                        "jobs_running": states.count("RUNNING"),
                        "jobs_finished": states.count("FINISHED"),
                        "jobs_failed": states.count("FAILED")})
                if path == "/jobs":
                    return self._send({"jobs": [
                        {"id": jid, "name": name,
                         "state": c.job_status()["state"]}
                        for jid, name, c in registry_ref.jobs()]})
                m = re.match(r"^/jobs/([^/]+)(?:/(.*))?$", path)
                if not m:
                    return self._send({"error": "not found"}, 404)
                entry = self._job(m.group(1))
                if entry is None:
                    return
                name, cluster = entry
                sub = m.group(2) or ""
                status = cluster.job_status()
                if sub == "":
                    return self._send({"id": m.group(1), "name": name,
                                       **status})
                if sub == "checkpoints":
                    return self._send({
                        "completed": status["completed_checkpoints"],
                        "count": len(status["completed_checkpoints"]),
                        # per-checkpoint duration/size history
                        # (CheckpointStatsTracker analog)
                        "history": status.get("checkpoint_stats", [])})
                if sub == "watermarks":
                    return self._send({"vertices": [
                        {"id": v["id"], "watermark": v.get("watermark")}
                        for v in status["vertices"]]})
                if sub == "backpressure":
                    ck = status.get("checkpoints", {})
                    return self._send({"vertices": [
                        {"id": v["id"],
                         "busy": round(v["busy_ratio"], 4),
                         "idle": round(v["idle_ratio"], 4),
                         "backpressured": round(v["backpressure_ratio"], 4),
                         # per-channel queue depth / backpressured time +
                         # the alignment-queue gauge (unaligned ckpts)
                         "subtasks": [
                             {"index": s["index"],
                              "channels": s.get("channels", []),
                              "alignment_queued":
                                  s.get("alignment_queued", 0)}
                             for s in v.get("subtasks", [])]}
                        for v in status["vertices"]],
                        "checkpoints": {
                            k: ck.get(k, 0) for k in (
                                "last_alignment_duration_ms",
                                "last_overtaken_bytes",
                                "last_persisted_inflight_bytes",
                                "unaligned_checkpoints")}})
                if sub == "metrics":
                    return self._send({
                        "records_in": sum(v["records_in"]
                                          for v in status["vertices"]),
                        "records_out": sum(v["records_out"]
                                           for v in status["vertices"]),
                        "latency_ms": _percentiles(
                            cluster.sink_latencies_ms())})
                if sub == "latency":
                    # per-(source, operator-hop) percentiles from the
                    # LatencyMarker flow + the legacy sink rollup
                    return self._send({
                        "hops": status.get("latency", []),
                        "sink_latency_ms": _percentiles(
                            cluster.sink_latencies_ms())})
                if sub == "latency.html":
                    from flink_tpu_torch.rest.views import latency_html
                    return self._send(
                        latency_html(status.get("latency", [])).encode(),
                        content_type="text/html")
                if sub == "trace":
                    # Chrome trace-event JSON of the span journal
                    # (Perfetto-viewable; trace summary in job_status)
                    fn = getattr(cluster, "trace_events", None)
                    if fn is None:
                        return self._send(
                            {"traceEvents": [], "displayTimeUnit": "ms",
                             "otherData": {"enabled": False}})
                    return self._send(fn())
                if sub == "metrics/history":
                    return self._send(
                        {"series": history_ref.series(m.group(1))})
                if sub == "exceptions":
                    return self._send({
                        "root_exception": status["failure"],
                        "history": status.get("exception_history", [])})
                if sub == "flamegraph":
                    from flink_tpu_torch.rest.flamegraph import flamegraph
                    # scope to THIS job's subtask threads — concurrent jobs
                    # must not pollute each other's profiles
                    names = {f"task-{t.vertex_uid}-{t.subtask_index}"
                             for t in getattr(cluster, "_tasks", [])}
                    return self._send(flamegraph(duration_ms=150,
                                                 thread_names=names))
                if sub == "plan":
                    view = getattr(cluster, "execution_plan_view",
                                   lambda: {"vertices": [], "edges": []})()
                    return self._send(view)
                # ---- server-rendered dashboard views (views.py): DAG svg,
                # flame svg, checkpoint table, per-subtask backpressure —
                # DOM-testable without a browser
                if sub == "plan.svg":
                    from flink_tpu_torch.rest.views import plan_svg
                    view = getattr(cluster, "execution_plan_view",
                                   lambda: {"vertices": [], "edges": []})()
                    return self._send(plan_svg(view).encode(),
                                      content_type="image/svg+xml")
                if sub == "flamegraph.svg":
                    from flink_tpu_torch.rest.flamegraph import flamegraph
                    from flink_tpu_torch.rest.views import flamegraph_svg
                    names = {f"task-{t.vertex_uid}-{t.subtask_index}"
                             for t in getattr(cluster, "_tasks", [])}
                    tree = flamegraph(duration_ms=150, thread_names=names)
                    return self._send(flamegraph_svg(tree).encode(),
                                      content_type="image/svg+xml")
                if sub == "checkpoints.html":
                    from flink_tpu_torch.rest.views import checkpoints_html
                    frag = checkpoints_html(
                        status.get("checkpoint_stats", []),
                        status["completed_checkpoints"])
                    return self._send(frag.encode(),
                                      content_type="text/html")
                if sub == "backpressure.html":
                    from flink_tpu_torch.rest.views import backpressure_html
                    return self._send(
                        backpressure_html(
                            status["vertices"],
                            status.get("checkpoints", {})).encode(),
                        content_type="text/html")
                if sub == "queryable":
                    return self._send(status.get(
                        "queryable", {"states": [], "lookups_total": 0}))
                if sub == "queryable.html":
                    from flink_tpu_torch.rest.views import queryable_html
                    return self._send(queryable_html(
                        status.get("queryable", {})).encode(),
                        content_type="text/html")
                if sub.startswith("state/"):
                    # GET /jobs/<id>/state/<name>/<key>?consistency=live
                    qsvc = getattr(cluster, "queryable", None)
                    if qsvc is None:
                        return self._send(
                            {"error": "queryable serving tier not enabled"},
                            404)
                    parts = sub.split("/", 2)
                    if len(parts) != 3 or not parts[2]:
                        return self._send({"error": "state/<name>/<key>"},
                                          404)
                    name, raw = parts[1], parts[2]
                    from urllib.parse import parse_qs, unquote, urlparse
                    q = parse_qs(urlparse(self.path).query)
                    cons = (q.get("consistency") or ["live"])[0]
                    raw = unquote(raw)
                    try:
                        key: Any = int(raw)
                    except ValueError:
                        key = raw
                    st, value = qsvc.lookup_batch(name, [key], cons)
                    if st != "ok":
                        return self._send({"error": value}, 400)
                    if not value["found"][0]:
                        return self._send({"error": f"no state for key "
                                                    f"{key!r}",
                                           "tags": value["tags"]}, 404)
                    return self._send({"key": key,
                                       "value": value["values"][0],
                                       "tags": value["tags"]})
                if sub == "device_health":
                    return self._send(status.get(
                        "device_health", {"state": "healthy"}))
                if sub == "device_health.html":
                    from flink_tpu_torch.rest.views import device_health_html
                    return self._send(device_health_html(
                        status.get("device_health", {})).encode(),
                        content_type="text/html")
                if sub == "autoscaler":
                    return self._send(status.get(
                        "autoscaler", {"state": "off"}))
                if sub == "autoscaler.html":
                    from flink_tpu_torch.rest.views import autoscaler_html
                    return self._send(autoscaler_html(
                        status.get("autoscaler", {})).encode(),
                        content_type="text/html")
                if sub == "ha":
                    return self._send(status.get("ha", {"enabled": False}))
                if sub == "ha.html":
                    from flink_tpu_torch.rest.views import ha_html
                    return self._send(ha_html(
                        status.get("ha", {})).encode(),
                        content_type="text/html")
                return self._send({"error": f"unknown path {sub}"}, 404)

            def do_POST(self):  # noqa: N802
                path = self.path.split("?")[0].rstrip("/")
                mb = re.match(r"^/jobs/([^/]+)/state/([^/:]+):batch$", path)
                if mb:
                    # POST /jobs/<id>/state/<name>:batch
                    # body: {"keys": [...], "consistency": "live|checkpoint"}
                    entry = self._job(mb.group(1))
                    if entry is None:
                        return
                    qsvc = getattr(entry[1], "queryable", None)
                    if qsvc is None:
                        return self._send(
                            {"error": "queryable serving tier not enabled"},
                            404)
                    try:
                        n = int(self.headers.get("Content-Length", 0))
                        body = json.loads(self.rfile.read(n) or b"{}")
                        keys = body["keys"]
                        assert isinstance(keys, list)
                    except (ValueError, KeyError, AssertionError):
                        return self._send(
                            {"error": "body must be JSON with a 'keys' "
                                      "list"}, 400)
                    st, value = qsvc.lookup_batch(
                        mb.group(2), keys,
                        body.get("consistency", "live"))
                    if st != "ok":
                        return self._send({"error": value}, 400)
                    return self._send(value)
                m = re.match(r"^/jobs/([^/]+)/(savepoints|stop)$", path)
                if not m:
                    return self._send({"error": "not found"}, 404)
                entry = self._job(m.group(1))
                if entry is None:
                    return
                _name, cluster = entry
                if m.group(2) == "stop":
                    # stop-with-savepoint (`flink stop` analog)
                    sp = cluster.stop_with_savepoint()
                    if sp is None:
                        return self._send({"status": "failed"}, 409)
                    return self._send({"status": "stopped",
                                       "checkpoint_id": sp})
                sp = cluster.savepoint()
                if sp is None:
                    return self._send({"status": "failed"}, 409)
                return self._send({"status": "completed", "checkpoint_id": sp})

            def do_PATCH(self):  # noqa: N802
                m = re.match(r"^/jobs/([^/]+)$", self.path.rstrip("/"))
                if not m:
                    return self._send({"error": "not found"}, 404)
                entry = self._job(m.group(1))
                if entry is None:
                    return
                entry[1].cancel()
                return self._send({"status": "cancelling"}, 202)

        self._server = ThreadingHTTPServer((host, port), Handler)
        if ssl_context is not None:
            self._server.socket = ssl_context.wrap_socket(
                self._server.socket, server_side=True)
        self.host, self.port = self._server.server_address
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        name="rest-server", daemon=True)
        self._sampler = threading.Thread(target=self._sample_loop,
                                         name="rest-metrics-sampler",
                                         daemon=True)

    def _sample_loop(self) -> None:
        terminal_done: set = set()
        while not self._stop_sampling.wait(self._sample_interval_s):
            for jid, _name, cluster in self.registry.jobs():
                if jid in terminal_done:
                    continue       # frozen: keep the run's real history
                try:
                    status = cluster.job_status()
                    self.history.sample(jid, status)
                    if status.get("state") in ("FINISHED", "FAILED",
                                               "CANCELED"):
                        # one final sample then freeze — endless flatline
                        # samples would evict the run's actual series
                        terminal_done.add(jid)
                except Exception:  # noqa: BLE001 — a finished/torn-down
                    pass           # job must not kill the sampler

    def start(self) -> "RestServer":
        self._thread.start()
        self._sampler.start()
        return self

    def stop(self) -> None:
        self._stop_sampling.set()
        self._server.shutdown()
        self._server.server_close()

    @property
    def url(self) -> str:
        scheme = "https" if self._ssl is not None else "http"
        return f"{scheme}://{self.host}:{self.port}"


_DASHBOARD_HTML = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>flink-tpu dashboard</title>
<style>
 :root{color-scheme:light;
   --surface:#fcfcfb;--panel:#f3f3f1;--border:#d9d8d4;
   --text:#0b0b0b;--text-2:#52514e;
   --busy:#2a78d6;--bp:#ec835a;--idle:#9a9a99;
   --flame:#2a78d6;--good:#0ca30c;--crit:#d03b3b}
 @media (prefers-color-scheme: dark){:root{color-scheme:dark;
   --surface:#1a1a19;--panel:#232322;--border:#3a3a38;
   --text:#fff;--text-2:#c3c2b7;
   --busy:#3987e5;--bp:#ec835a;--idle:#7a7a78;
   --flame:#3987e5;--good:#0ca30c;--crit:#d03b3b}}
 body{font-family:system-ui,sans-serif;margin:1.5rem;max-width:72rem;
   background:var(--surface);color:var(--text)}
 h1{font-size:1.25rem;margin:.2rem 0 1rem}
 h2{font-size:1rem;margin:1.4rem 0 .5rem;color:var(--text)}
 .tiles{display:flex;gap:.8rem;flex-wrap:wrap}
 .tile{background:var(--panel);border:1px solid var(--border);
   border-radius:8px;padding:.6rem .9rem;min-width:7.5rem}
 .tile .v{font-size:1.4rem;font-weight:600}
 .tile .l{font-size:.75rem;color:var(--text-2)}
 table{border-collapse:collapse;width:100%;font-size:.88rem}
 th,td{border-bottom:1px solid var(--border);padding:.35rem .6rem;
   text-align:left}
 th{color:var(--text-2);font-weight:500}
 tr.sel{background:var(--panel)} tr.job{cursor:pointer}
 code{background:var(--panel);padding:0 .3rem;border-radius:4px}
 .ratio{display:flex;height:12px;width:160px;border-radius:4px;
   overflow:hidden;gap:2px;background:var(--surface)}
 .ratio div{height:100%}
 .legend{display:flex;gap:1rem;font-size:.78rem;color:var(--text-2);
   margin:.3rem 0}
 .legend span::before{content:"";display:inline-block;width:10px;
   height:10px;border-radius:3px;margin-right:.35rem;
   background:var(--c);vertical-align:-1px}
 button{background:var(--panel);color:var(--text);
   border:1px solid var(--border);border-radius:6px;
   padding:.25rem .6rem;font-size:.8rem;cursor:pointer;margin-right:.3rem}
 button:hover{border-color:var(--text-2)}
 #flame svg{width:100%;background:var(--panel);border-radius:8px}
 #flame text{font:10px system-ui;fill:#fff;pointer-events:none}
 .panelbox{background:var(--panel);border:1px solid var(--border);
   border-radius:8px;padding:.4rem;overflow-x:auto}
 .bp-subtask{display:flex;align-items:center;gap:.6rem;margin:.2rem 0}
 .bp-label{font-size:.8rem;color:var(--text-2);min-width:7rem}
 .bp-pct{font-size:.75rem;color:var(--text-2)}
 .bp-bar{display:flex;height:10px;width:220px;border-radius:4px;
   overflow:hidden;background:var(--surface)}
 .bp-busy{background:var(--busy)} .bp-backpressured{background:var(--bp)}
 .bp-idle{background:var(--idle)}
 .bp-vertex h3{font-size:.85rem;margin:.5rem 0 .15rem}
 .ckpt-table{margin:.3rem 0}
 .state-RUNNING{color:var(--busy)} .state-FINISHED{color:var(--good)}
 .state-FAILED,.state-CANCELED{color:var(--crit)}
 .err{color:var(--crit);font-size:.85rem;white-space:pre-wrap}
</style></head><body>
<h1>flink-tpu dashboard</h1>
<div class="tiles" id="tiles"></div>
<h2>Jobs</h2>
<table id="jobs"><thead><tr><th>id</th><th>name</th><th>state</th>
<th>records in / out</th><th>checkpoints</th><th>actions</th></tr></thead>
<tbody></tbody></table>
<div id="detail" style="display:none">
 <h2>Vertices — <code id="selid"></code></h2>
 <div class="legend">
  <span style="--c:var(--busy)">busy</span>
  <span style="--c:var(--bp)">backpressured</span>
  <span style="--c:var(--idle)">idle</span></div>
 <table id="verts"><thead><tr><th>vertex</th><th>par</th><th>state</th>
 <th>records in / out</th><th>watermark</th><th>time share</th></tr></thead>
 <tbody></tbody>
 </table>
 <h2>Throughput (records/s per operator)</h2><div id="tput"></div>
 <h2>Job graph</h2><div id="dag" class="panelbox"></div>
 <h2>Subtask backpressure</h2><div id="bp"></div>
 <div id="qswrap" style="display:none"><h2>Queryable state</h2>
 <div id="qs" class="panelbox"></div></div>
 <h2>Latency (source&rarr;sink)</h2><div class="tiles" id="lat"></div>
 <div id="lathops"></div>
 <h2>Checkpoints</h2>
 <div id="ckview"></div>
 <div id="ckpts" style="font-size:.88rem;color:var(--text-2)"></div>
 <div id="exc"></div>
 <h2>Flame graph <button onclick="flame()">sample</button>
  <button onclick="flameSvg()">server svg</button></h2>
 <div id="flame"></div>
</div>
<script>
let sel=null;
const J=async p=>(await fetch(p)).json();
const esc=s=>String(s).replace(/[&<>"]/g,c=>({'&':'&amp;','<':'&lt;',
  '>':'&gt;','"':'&quot;'}[c]));
function tile(l,v){return `<div class="tile"><div class="v">${v}</div>`+
  `<div class="l">${l}</div></div>`}
async function refresh(){
  const ov=await J('/overview');
  const jobs=(await J('/jobs')).jobs;
  let tin=0,tout=0;const rows=[];
  for(const j of jobs){
    const d=await J('/jobs/'+j.id);const m=await J('/jobs/'+j.id+'/metrics');
    tin+=m.records_in;tout+=m.records_out;
    rows.push({j,d,m});
  }
  document.getElementById('tiles').innerHTML=
    tile('running',ov.jobs_running)+tile('finished',ov.jobs_finished)+
    tile('failed',ov.jobs_failed)+
    tile('records in',tin.toLocaleString())+
    tile('records out',tout.toLocaleString());
  const tb=document.querySelector('#jobs tbody');tb.innerHTML='';
  for(const {j,d,m} of rows){
    const tr=document.createElement('tr');
    tr.className='job'+(sel===j.id?' sel':'');
    tr.onclick=()=>{sel=j.id;refresh()};
    tr.innerHTML=`<td><code>${esc(j.id)}</code></td><td>${esc(j.name)}</td>`+
     `<td class="state-${esc(d.state)}">${esc(d.state)}</td>`+
     `<td>${m.records_in.toLocaleString()} / ${m.records_out.toLocaleString()}</td>`+
     `<td>${d.completed_checkpoints.length}</td>`+
     `<td><button onclick="act(event,'${esc(j.id)}','savepoints')">savepoint</button>`+
     `<button onclick="act(event,'${esc(j.id)}','stop')">stop</button>`+
     `<button onclick="cancelJob(event,'${esc(j.id)}')">cancel</button></td>`;
    tb.appendChild(tr);
  }
  if(sel===null&&rows.length)sel=rows[0].j.id;
  const cur=rows.find(r=>r.j.id===sel);
  document.getElementById('detail').style.display=cur?'':'none';
  if(!cur)return;
  document.getElementById('selid').textContent=sel;
  const vb=document.querySelector('#verts tbody');vb.innerHTML='';
  for(const v of cur.d.vertices){
    const pct=x=>(100*x).toFixed(1)+'%';
    const tr=document.createElement('tr');
    tr.innerHTML=`<td>${esc(v.id)}</td><td>${v.parallelism}</td>`+
     `<td>${esc((v.status||[]).join(','))}</td>`+
     `<td>${v.records_in.toLocaleString()} / ${v.records_out.toLocaleString()}</td>`+
     `<td>${v.watermark==null?'&mdash;':v.watermark.toLocaleString()}</td>`+
     `<td><div class="ratio" title="busy ${pct(v.busy_ratio)} · `+
     `backpressured ${pct(v.backpressure_ratio)} · idle ${pct(v.idle_ratio)}">`+
     `<div style="width:${v.busy_ratio*100}%;background:var(--busy)"></div>`+
     `<div style="width:${v.backpressure_ratio*100}%;background:var(--bp)"></div>`+
     `<div style="width:${v.idle_ratio*100}%;background:var(--idle)"></div>`+
     `</div></td>`;
    vb.appendChild(tr);
  }
  const lat=cur.m.latency_ms||{};
  document.getElementById('lat').innerHTML=['p50','p95','p99','max']
    .filter(k=>lat[k]!==undefined)
    .map(k=>tile(k,lat[k].toFixed(1)+' ms')).join('')||
    '<span style="color:var(--text-2);font-size:.85rem">no samples yet</span>';
  fetch('/jobs/'+sel+'/latency.html').then(r=>r.text())
    .then(t=>{document.getElementById('lathops').innerHTML=t});
  renderTput(await J('/jobs/'+sel+'/metrics/history'));
  const ck=await J('/jobs/'+sel+'/checkpoints');
  document.getElementById('ckpts').textContent=
    ck.count?('completed: '+ck.count):'none yet';
  // server-rendered views: DAG svg, per-subtask backpressure, and the
  // checkpoint drill-down table (replaces the old client-side renderer)
  fetch('/jobs/'+sel+'/plan.svg').then(r=>r.text())
    .then(t=>{document.getElementById('dag').innerHTML=t});
  fetch('/jobs/'+sel+'/backpressure.html').then(r=>r.text())
    .then(t=>{document.getElementById('bp').innerHTML=t});
  const qsw=document.getElementById('qswrap');
  if(cur.d.queryable){qsw.style.display='';
    fetch('/jobs/'+sel+'/queryable.html').then(r=>r.text())
      .then(t=>{document.getElementById('qs').innerHTML=t});
  }else qsw.style.display='none';
  fetch('/jobs/'+sel+'/checkpoints.html').then(r=>r.text())
    .then(t=>{document.getElementById('ckview').innerHTML=t});
  const ex=await J('/jobs/'+sel+'/exceptions');
  let exh='';
  if((ex.history||[]).length){
    exh='<h2>Exception history</h2>'+ex.history.slice(-8).reverse()
      .map(e=>'<div class="err">'+
        new Date(e.timestamp_ms).toLocaleTimeString()+' '+
        esc(e.task)+': '+esc(e.exception)+'</div>').join('');
  }
  document.getElementById('exc').innerHTML=(ex.root_exception?
    ('<h2>Root exception</h2><div class="err">'+esc(ex.root_exception)+
     '</div>'):'')+exh;
}
function renderTput(h){
  // per-vertex records/sec over time, derived from the sampled cumulative
  // counters (MetricStore analog); one sparkline row per operator
  const s=h.series||[];const el=document.getElementById('tput');
  if(s.length<2){el.innerHTML=
    '<span style="color:var(--text-2);font-size:.85rem">sampling…</span>';
    return}
  const ids=Object.keys(s[s.length-1].vertices);
  const W=560,H=36;let out='';
  for(const id of ids){
    const rates=[];
    for(let i=1;i<s.length;i++){
      const a=s[i-1],b=s[i];
      const va=a.vertices[id],vb=b.vertices[id];
      if(!va||!vb)continue;
      const dt=Math.max(1,(b.ts-a.ts))/1000;
      rates.push(Math.max(0,(vb.records_in-va.records_in)/dt));
    }
    if(!rates.length)continue;
    const mx=Math.max(1,...rates);
    const pts=rates.map((r,i)=>
      `${(i/(rates.length-1||1)*W).toFixed(1)},`+
      `${(H-2-(H-6)*r/mx).toFixed(1)}`).join(' ');
    const cur=rates[rates.length-1];
    out+='<div class="bp-subtask"><span class="bp-label" title="'+esc(id)+
      '">'+esc(id.length>14?id.slice(0,13)+'…':id)+'</span>'+
      `<svg width="${W}" height="${H}" style="background:var(--panel);`+
      `border-radius:6px"><polyline fill="none" stroke="var(--busy)" `+
      `stroke-width="1.5" points="${pts}"/></svg>`+
      '<span class="bp-pct">'+
      (cur>=1e6?(cur/1e6).toFixed(2)+'M':cur>=1e3?(cur/1e3).toFixed(1)+'k':
       cur.toFixed(0))+'/s · peak '+
      (mx>=1e6?(mx/1e6).toFixed(2)+'M':mx>=1e3?(mx/1e3).toFixed(1)+'k':
       mx.toFixed(0))+'/s</span></div>';
  }
  el.innerHTML=out||'<span style="color:var(--text-2)">no vertices</span>';
}
async function act(ev,id,verb){ev.stopPropagation();
  await fetch('/jobs/'+id+'/'+verb,{method:'POST'});refresh()}
async function cancelJob(ev,id){ev.stopPropagation();
  await fetch('/jobs/'+id,{method:'PATCH'});refresh()}
async function flame(){
  const t=await J('/jobs/'+sel+'/flamegraph');
  const H=16,rows=[];
  (function walk(n,x0,x1,d){if(d>=0)rows.push({n,x0,x1,d});
    let x=x0;for(const c of (n.children||[])){
      const w=(x1-x0)*(c.value/Math.max(1,n.value));
      walk(c,x,x+w,d+1);x+=w;}})(t,0,100,-1);
  const depth=Math.max(0,...rows.map(r=>r.d))+1;
  // sequential single-hue: depth shades the one flame hue
  const svg=['<svg viewBox="0 0 1000 '+(depth*(H+2))+'" '+
    'xmlns="http://www.w3.org/2000/svg">'];
  for(const r of rows){
    const w=(r.x1-r.x0)*10;if(w<1)continue;
    const o=0.45+0.55*(1-r.d/Math.max(1,depth));
    svg.push(`<g><rect x="${(r.x0*10).toFixed(1)}" y="${r.d*(H+2)}" `+
     `width="${w.toFixed(1)}" height="${H}" rx="3" `+
     `fill="var(--flame)" fill-opacity="${o.toFixed(2)}">`+
     `<title>${esc(r.n.name)} — ${r.n.value} samples</title></rect>`+
     (w>60?`<text x="${(r.x0*10+4).toFixed(1)}" y="${r.d*(H+2)+12}">`+
       esc(r.n.name.slice(0,Math.floor(w/7)))+'</text>':'')+'</g>');
  }
  svg.push('</svg>');
  document.getElementById('flame').innerHTML=svg.join('');
}
async function flameSvg(){
  const t=await (await fetch('/jobs/'+sel+'/flamegraph.svg')).text();
  document.getElementById('flame').innerHTML=t;
}
refresh();setInterval(refresh,2000);
</script></body></html>
"""
