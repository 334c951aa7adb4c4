"""Loopback servers that stop every thread they start.

The host edges' servers (S3, the log service, the schema registry,
Postgres, Kinesis, Elasticsearch, CQL and AMQP) serve each connection on a
thread of its own.  ``socketserver``'s threading mix-in joins none of its
daemon threads, and a client that keeps its connection open would hold
one past the server's close.  :class:`ConnectionThreads` keeps each open
connection's socket and thread: ``close()`` shuts the sockets down, so a
handler blocked in a read sees the end of its stream, and joins the
threads.  :class:`ThreadingHTTPServer` and :class:`ThreadingTCPServer`
close through it, and the servers with an accept loop of their own (CQL,
AMQP) use it directly.
"""

from __future__ import annotations

import http.server
import socket
import socketserver
import threading
from typing import Callable, Dict, Optional

#: seconds ``close()`` waits for one connection's thread to end
JOIN_TIMEOUT_S = 10.0


class ConnectionThreads:
    """The open connections of one server: a thread each, and its socket."""

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._open: Dict[threading.Thread, socket.socket] = {}

    def start(self, serve: Callable[[socket.socket], None],
              sock: socket.socket) -> None:
        t = threading.Thread(target=self._run, args=(serve, sock),
                             name=f"{self.name}-conn", daemon=True)
        with self._lock:
            self._open[t] = sock
        t.start()

    def _run(self, serve, sock) -> None:
        try:
            serve(sock)
        finally:
            with self._lock:
                self._open.pop(threading.current_thread(), None)

    def close(self) -> None:
        """Shut every open connection down and join its thread."""
        with self._lock:
            items = list(self._open.items())
        for _t, sock in items:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        for t, _sock in items:
            if t is not threading.current_thread():
                t.join(JOIN_TIMEOUT_S)


class _ClosingThreads:
    """``socketserver`` mix-in: each request on a :class:`ConnectionThreads`
    thread, all of them shut down and joined by ``server_close()``."""

    daemon_threads = True
    _connections: Optional[ConnectionThreads] = None

    def process_request(self, request, client_address):
        if self._connections is None:
            self._connections = ConnectionThreads(type(self).__name__)
        self._connections.start(
            lambda sock: self.process_request_thread(sock, client_address),
            request)

    def server_close(self):
        super().server_close()
        if self._connections is not None:
            self._connections.close()


class ThreadingHTTPServer(_ClosingThreads, http.server.ThreadingHTTPServer):
    pass


class ThreadingTCPServer(_ClosingThreads, socketserver.ThreadingTCPServer):
    pass


def stop_serving(server: socketserver.BaseServer,
                 thread: threading.Thread) -> None:
    """Stop a server whose ``serve_forever`` runs on ``thread`` (or in the
    foreground, ``thread`` never started): its loop, its listening socket,
    every connection's thread, and ``thread`` itself."""
    if thread.is_alive():
        server.shutdown()
    server.server_close()
    if thread.is_alive() and thread is not threading.current_thread():
        thread.join(JOIN_TIMEOUT_S)
