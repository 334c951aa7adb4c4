"""RPC framework: single-threaded endpoints + gateway proxies.

Analog of the reference's Akka-based RPC (``runtime/rpc/akka/AkkaRpcService.java``,
``AkkaRpcActor.java``): every coordinator (Dispatcher, JobMaster,
ResourceManager, TaskExecutor) is an ``RpcEndpoint`` whose state is mutated
ONLY by its own main thread — calls from other components are marshalled into
the endpoint's mailbox and executed sequentially.  The single-thread invariant
is asserted at runtime exactly like ``MainThreadValidatorUtil.java``.

Transport is in-process (MiniCluster mode, the reference's shared
``AkkaRpcService`` inside ``MiniCluster.java:271``): a gateway is a dynamic
proxy posting closures to the target endpoint's mailbox and returning
``concurrent.futures.Future``s.  Multi-host deployments put a gRPC/TCP bridge
behind the same ``RpcService.connect`` seam (SURVEY §5.8 control plane).

The port's copy of ``flink_tpu/cluster/rpc.py`` (host Python, as JAX's).
"""

from __future__ import annotations

import queue
import threading
import traceback
from concurrent.futures import Future
from typing import Any, Callable, Dict, Optional

from flink_tpu_torch.testing import chaos


class RpcTimeout(Exception):
    pass


class RpcEndpoint:
    """Base endpoint: owns a mailbox thread; subclasses implement rpc methods
    as plain methods and MUST only touch state from the main thread."""

    def __init__(self, name: str):
        self.name = name
        self._mailbox: "queue.Queue[Optional[Callable]]" = queue.Queue()
        self._main_thread: Optional[threading.Thread] = None
        self._running = False

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> None:
        if self._running:
            return
        self._running = True
        self._main_thread = threading.Thread(
            target=self._run_mailbox, name=f"rpc-{self.name}", daemon=True)
        self._main_thread.start()
        self.run_async(self.on_start)

    def stop(self) -> None:
        if not self._running:
            return
        def _shutdown():
            self.on_stop()
            self._running = False
        self._mailbox.put(_shutdown)
        self._mailbox.put(None)  # poison

    def on_start(self) -> None:
        pass

    def on_stop(self) -> None:
        pass

    def _run_mailbox(self) -> None:
        while True:
            item = self._mailbox.get()
            if item is None:
                return
            try:
                item()
            except Exception:
                traceback.print_exc()

    # -- main-thread discipline ---------------------------------------------
    def validate_runs_in_main_thread(self) -> None:
        """``MainThreadValidatorUtil.isRunningInExpectedThread`` analog."""
        assert threading.current_thread() is self._main_thread, (
            f"endpoint {self.name}: state touched from "
            f"{threading.current_thread().name}, not the endpoint main thread")

    def run_async(self, fn: Callable, *args) -> None:
        """Post a closure to the mailbox (``runAsync`` analog)."""
        self._mailbox.put(lambda: fn(*args))

    def call_async(self, fn: Callable, *args) -> Future:
        """Post and return a Future of the result (``callAsync`` analog)."""
        fut: Future = Future()

        def run():
            try:
                fut.set_result(fn(*args))
            except Exception as e:  # noqa: BLE001
                fut.set_exception(e)

        self._mailbox.put(run)
        return fut


class Gateway:
    """Dynamic proxy: attribute access returns a callable that executes the
    endpoint method on the endpoint's main thread and returns a Future
    (``AkkaInvocationHandler`` analog)."""

    def __init__(self, endpoint: RpcEndpoint):
        object.__setattr__(self, "_endpoint", endpoint)

    def __getattr__(self, item: str):
        ep = object.__getattribute__(self, "_endpoint")
        method = getattr(ep, item)
        if not callable(method):
            raise AttributeError(item)

        def call(*args, **kwargs) -> Future:
            # fault point: a dropped RPC never reaches the mailbox — the
            # caller's future stays pending (timeout at await_future), the
            # lost-message model; fail schedules raise synchronously
            if not chaos.fire("rpc.call", endpoint=ep.name, method=item):
                return Future()
            return ep.call_async(lambda: method(*args, **kwargs))

        return call

    @property
    def address(self) -> str:
        return object.__getattribute__(self, "_endpoint").name


class RpcService:
    """Endpoint registry + connection factory (``AkkaRpcService`` analog)."""

    def __init__(self):
        self._endpoints: Dict[str, RpcEndpoint] = {}
        self._lock = threading.Lock()

    def start_endpoint(self, endpoint: RpcEndpoint) -> Gateway:
        with self._lock:
            self._endpoints[endpoint.name] = endpoint
        endpoint.start()
        return Gateway(endpoint)

    def connect(self, address: str) -> Gateway:
        with self._lock:
            ep = self._endpoints.get(address)
        if ep is None or not ep._running:
            raise ConnectionError(f"no endpoint at {address!r}")
        return Gateway(ep)

    def stop_endpoint(self, address: str) -> None:
        with self._lock:
            ep = self._endpoints.pop(address, None)
        if ep is not None:
            ep.stop()

    def stop(self) -> None:
        with self._lock:
            eps = list(self._endpoints.values())
            self._endpoints.clear()
        for ep in eps:
            ep.stop()


def await_future(fut: Future, timeout_s: float = 30.0):
    """Block on an RPC future (client-side convenience)."""
    try:
        return fut.result(timeout=timeout_s)
    except TimeoutError as e:
        raise RpcTimeout(f"rpc did not complete within {timeout_s}s") from e
