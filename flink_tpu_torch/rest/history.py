"""History server: archived finished jobs, served after the cluster is gone
(port of ``flink_tpu/rest/history.py``).

Analog of the reference's ``flink-runtime/.../history/`` (``HistoryServer``
+ ``FsJobArchivist``): when a job reaches a terminal state its REST-visible
facts (status, vertices, metrics, checkpoint counts) are archived as one
JSON document per job; a standalone :class:`HistoryServer` serves the
archive directory with the same ``/jobs`` shapes the live REST API uses, so
the dashboard/CLI work identically against finished clusters.
"""

from __future__ import annotations

import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional


def archive_job(archive_dir: str, job_id: str,
                status: Dict[str, Any]) -> str:
    """Write one job's terminal REST document (``FsJobArchivist.archiveJob``
    analog); returns the archive path."""
    os.makedirs(archive_dir, exist_ok=True)
    doc = dict(status)
    doc.setdefault("id", job_id)
    doc["archived_at"] = int(time.time() * 1000)
    path = os.path.join(archive_dir, f"{job_id}.json")
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f, default=str)
    os.replace(tmp, path)
    return path


def list_archived(archive_dir: str) -> List[Dict[str, Any]]:
    out = []
    if not os.path.isdir(archive_dir):
        return out
    for fn in sorted(os.listdir(archive_dir)):
        if not fn.endswith(".json"):
            continue
        try:
            with open(os.path.join(archive_dir, fn)) as f:
                out.append(json.load(f))
        except (OSError, json.JSONDecodeError):
            continue
    return out


class HistoryServer:
    """Serves an archive directory over HTTP (``HistoryServer`` analog):
    ``/jobs`` (summaries), ``/jobs/<id>`` (full archived document),
    ``/overview``."""

    def __init__(self, archive_dir: str, host: str = "127.0.0.1",
                 port: int = 0, ssl_context=None):
        self.archive_dir = archive_dir
        self._ssl = ssl_context
        adir = archive_dir

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, obj, status: int = 200):
                data = json.dumps(obj, default=str).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):  # noqa: N802
                path = self.path.split("?")[0].rstrip("/")
                if path.startswith("/jobs/"):
                    # direct file open — no full-archive scan per lookup
                    job_id = os.path.basename(path.split("/", 2)[2])
                    fp = os.path.join(adir, f"{job_id}.json")
                    try:
                        with open(fp) as f:
                            return self._send(json.load(f))
                    except (OSError, json.JSONDecodeError):
                        return self._send(
                            {"error": f"no archived job {job_id}"}, 404)
                jobs = list_archived(adir)
                if path in ("", "/jobs"):
                    return self._send({"jobs": [
                        {"id": j.get("id"), "state": j.get("state"),
                         "name": j.get("name"),
                         "archived_at": j.get("archived_at")}
                        for j in jobs]})
                if path == "/overview":
                    return self._send({
                        "jobs_total": len(jobs),
                        "by_state": _count_by_state(jobs)})
                return self._send({"error": "not found"}, 404)

        self._server = ThreadingHTTPServer((host, port), Handler)
        if ssl_context is not None:
            self._server.socket = ssl_context.wrap_socket(
                self._server.socket, server_side=True)
        self.host, self.port = self._server.server_address
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        name="history-server", daemon=True)

    def start(self) -> "HistoryServer":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()

    @property
    def url(self) -> str:
        scheme = "https" if self._ssl is not None else "http"
        return f"{scheme}://{self.host}:{self.port}"


def _count_by_state(jobs: List[Dict[str, Any]]) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for j in jobs:
        out[j.get("state", "?")] = out.get(j.get("state", "?"), 0) + 1
    return out
