"""Metric reporters — the reporter SPI + shipped implementations (port of
``flink_tpu/metrics/reporters.py``, host Python as JAX's).

Analog of the ``MetricReporter`` SPI (``flink-metrics-core``) and the
reference's shipped reporters (``flink-metrics/``): a logging reporter
(slf4j analog), a Prometheus reporter serving the text exposition format
over HTTP (``flink-metrics-prometheus``), and the line-protocol push
reporters — StatsD over UDP (``flink-metrics-statsd``), Graphite
plaintext over TCP/UDP (``flink-metrics-graphite``), and InfluxDB line
protocol over HTTP (``flink-metrics-influxdb``).  Each push reporter
exposes ``render()`` returning the wire lines so tests and in-process
consumers can assert the exact protocol bytes without a live server.
"""

from __future__ import annotations

import logging
import re
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional

from flink_tpu_torch.metrics.core import Counter, Gauge, Histogram, Meter, Metric

log = logging.getLogger("flink_tpu_torch.metrics")


class MetricReporter:
    """SPI: ``notify_of_added_metric`` on registration, ``report`` on each
    reporting tick (scheduled reporters), ``close`` on shutdown."""

    def notify_of_added_metric(self, metric: Metric, name: str, group) -> None:
        pass

    def report(self, metrics: Dict[str, Metric]) -> None:
        pass

    def close(self) -> None:
        pass


class LoggingReporter(MetricReporter):
    def __init__(self, level: int = logging.INFO):
        self.level = level

    def report(self, metrics: Dict[str, Metric]) -> None:
        for ident, m in sorted(metrics.items()):
            log.log(self.level, "%s = %s", ident, _render(m))


def _render(m: Metric):
    if isinstance(m, Counter):
        return m.get_count()
    if isinstance(m, Meter):
        return f"{m.get_rate():.1f}/s (n={m.get_count()})"
    if isinstance(m, Histogram):
        s = m.get_statistics()
        return f"p50={s['p50']:.2f} p99={s['p99']:.2f} n={s['count']}"
    if isinstance(m, Gauge):
        return m.get_value()
    return m


_INVALID = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(ident: str) -> str:
    return "flink_tpu_" + _INVALID.sub("_", ident)


class PrometheusReporter(MetricReporter):
    """Prometheus text exposition; optionally serves GET /metrics."""

    def __init__(self, registry=None, port: Optional[int] = None):
        self._registry = registry
        self._server: Optional[ThreadingHTTPServer] = None
        self._thread = None
        if port is not None:
            self.start_server(port)

    def bind(self, registry) -> None:
        self._registry = registry

    def render(self, metrics: Dict[str, Metric]) -> List[str]:
        """Exposition-format lines for ``metrics`` — the same wire-level
        seam the push reporters expose, so tests can assert exact
        protocol bytes without an HTTP server.  Histograms ship as proper
        Prometheus SUMMARY families: ``{quantile="0.5|0.95|0.99"}``
        series plus the ``_sum`` / ``_count`` conventions."""
        lines: List[str] = []
        for ident, m in sorted(metrics.items()):
            name = _prom_name(ident)
            if isinstance(m, Counter):
                lines += [f"# TYPE {name} counter", f"{name} {m.get_count()}"]
            elif isinstance(m, Meter):
                lines += [f"# TYPE {name} gauge", f"{name} {m.get_rate()}"]
            elif isinstance(m, Histogram):
                s = m.get_statistics()
                lines.append(f"# TYPE {name} summary")
                for q, k in (("0.5", "p50"), ("0.95", "p95"),
                             ("0.99", "p99")):
                    lines.append(f'{name}{{quantile="{q}"}} {s[k]}')
                lines.append(f"{name}_sum {m.get_sum()}")
                lines.append(f"{name}_count {s['count']}")
            elif isinstance(m, Gauge):
                v = m.get_value()
                if isinstance(v, (int, float)) and not isinstance(v, bool):
                    lines += [f"# TYPE {name} gauge", f"{name} {v}"]
        return lines

    def scrape(self) -> str:
        metrics = self._registry.all_metrics() if self._registry else {}
        return "\n".join(self.render(metrics)) + "\n"

    # -- HTTP ---------------------------------------------------------------
    def start_server(self, port: int) -> int:
        reporter = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802
                if self.path.rstrip("/") in ("", "/metrics"):
                    body = reporter.scrape().encode()
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "text/plain; version=0.0.4")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                else:
                    self.send_response(404)
                    self.end_headers()

            def log_message(self, *a):  # silence per-request logging
                pass

        self._server = ThreadingHTTPServer(("127.0.0.1", port), Handler)
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self._server.server_address[1]

    def close(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server = None


def _numeric_points(metrics: Dict[str, Metric]):
    """Flatten metrics to (identifier, field, numeric value) points — the
    shared shape every line-protocol reporter pushes."""
    for ident, m in sorted(metrics.items()):
        if isinstance(m, Counter):
            yield ident, "count", m.get_count()
        elif isinstance(m, Meter):
            yield ident, "rate", m.get_rate()
            yield ident, "count", m.get_count()
        elif isinstance(m, Histogram):
            s = m.get_statistics()
            for k in ("p50", "p95", "p99"):
                yield ident, k, s[k]
            yield ident, "count", s["count"]
        elif isinstance(m, Gauge):
            v = m.get_value()
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                yield ident, "value", v


class StatsDReporter(MetricReporter):
    """StatsD datagrams (``flink-metrics-statsd`` analog):
    ``<name>.<field>:<value>|g``, one metric per UDP datagram.
    EVERYTHING ships as a gauge — counters here are CUMULATIVE snapshots,
    and StatsD ``|c`` sums deltas, so reporting running totals as ``|c``
    would inflate without bound (the reference's StatsD reporter makes
    the same all-gauges choice)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 8125,
                 prefix: str = "flink_tpu"):
        self.addr = (host, port)
        self.prefix = prefix
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)

    def _name(self, ident: str, field: str) -> str:
        safe = re.sub(r"[:|@]", "_", ident).replace(" ", "_")
        return f"{self.prefix}.{safe}.{field}"

    def render(self, metrics: Dict[str, Metric]) -> List[str]:
        out = []
        for ident, field, v in _numeric_points(metrics):
            val = int(v) if field == "count" else round(float(v), 6)
            out.append(f"{self._name(ident, field)}:{val}|g")
        return out

    def report(self, metrics: Dict[str, Metric]) -> None:
        for line in self.render(metrics):
            try:
                self._sock.sendto(line.encode(), self.addr)
            except OSError:
                pass                   # metrics must never fail the job

    def close(self) -> None:
        self._sock.close()


class GraphiteReporter(MetricReporter):
    """Graphite plaintext protocol (``flink-metrics-graphite`` analog):
    ``<path> <value> <unix-ts>\\n`` over one TCP connection, re-dialed on
    error."""

    def __init__(self, host: str = "127.0.0.1", port: int = 2003,
                 prefix: str = "flink_tpu"):
        self.addr = (host, port)
        self.prefix = prefix
        self._sock: Optional[socket.socket] = None

    def _name(self, ident: str, field: str) -> str:
        safe = re.sub(r"[^A-Za-z0-9_\-.]", "_", ident)
        return f"{self.prefix}.{safe}.{field}"

    def render(self, metrics: Dict[str, Metric],
               now: Optional[int] = None) -> List[str]:
        ts = int(now if now is not None else time.time())
        return [f"{self._name(ident, field)} "
                f"{int(v) if field == 'count' else round(float(v), 6)} {ts}"
                for ident, field, v in _numeric_points(metrics)]

    def report(self, metrics: Dict[str, Metric]) -> None:
        payload = ("\n".join(self.render(metrics)) + "\n").encode()
        try:
            if self._sock is None:
                self._sock = socket.create_connection(self.addr, timeout=5)
            self._sock.sendall(payload)
        except OSError:
            if self._sock is not None:
                try:
                    self._sock.close()
                except OSError:
                    pass
                self._sock = None      # re-dial on the next tick

    def close(self) -> None:
        if self._sock is not None:
            self._sock.close()
            self._sock = None


class InfluxDBReporter(MetricReporter):
    """InfluxDB line protocol (``flink-metrics-influxdb`` analog):
    ``<measurement>[,tag=v] field=value <ns-timestamp>`` POSTed to
    ``/write?db=<db>``."""

    def __init__(self, host: str = "127.0.0.1", port: int = 8086,
                 db: str = "flink", tags: Optional[Dict[str, str]] = None):
        self.host, self.port, self.db = host, port, db
        self.tags = dict(tags or {})

    @staticmethod
    def _escape(s: str) -> str:
        return s.replace(" ", "\\ ").replace(",", "\\,").replace("=", "\\=")

    def render(self, metrics: Dict[str, Metric],
               now_ns: Optional[int] = None) -> List[str]:
        ts = int(now_ns if now_ns is not None else time.time() * 1e9)
        tagstr = "".join(f",{self._escape(k)}={self._escape(v)}"
                         for k, v in sorted(self.tags.items()))
        by_ident: Dict[str, List[str]] = {}
        for ident, field, v in _numeric_points(metrics):
            val = f"{int(v)}i" if isinstance(v, int) else repr(float(v))
            by_ident.setdefault(ident, []).append(f"{field}={val}")
        return [f"{self._escape(ident)}{tagstr} {','.join(fields)} {ts}"
                for ident, fields in sorted(by_ident.items())]

    def report(self, metrics: Dict[str, Metric]) -> None:
        import urllib.request
        body = ("\n".join(self.render(metrics)) + "\n").encode()
        url = f"http://{self.host}:{self.port}/write?db={self.db}"
        try:
            req = urllib.request.Request(url, data=body, method="POST")
            urllib.request.urlopen(req, timeout=5).close()
        except OSError:
            pass                       # metrics must never fail the job
