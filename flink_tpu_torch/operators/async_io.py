"""Async I/O operator: concurrent external lookups with ordered/unordered
result emission (port of ``flink_tpu/operators/async_io.py``).

Analog of ``AsyncWaitOperator.java:78`` (``AsyncDataStream.orderedWait`` /
``unorderedWait``): user async function runs on a thread pool, a bounded
in-flight queue applies backpressure, a timeout fails or drops slow calls.
Batched: the unit of async work is a whole RecordBatch (one pool task per
batch), keeping the boundary-crossing cost amortized.  Ordered mode emits
results in submission order; unordered emits as they complete but never
across a watermark (the reference's watermark fencing).
"""

from __future__ import annotations

import concurrent.futures as cf
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from flink_tpu_torch.core.batch import RecordBatch, StreamElement, Watermark
from flink_tpu_torch.core.functions import RuntimeContext
from flink_tpu_torch.operators.base import StreamOperator


class AsyncFunction:
    """User async function: ``invoke(cols) -> cols`` runs on a worker
    thread (``AsyncFunction.asyncInvoke`` analog)."""

    def open(self, ctx: RuntimeContext) -> None:
        pass

    def invoke(self, cols: Dict[str, Any]) -> Dict[str, Any]:
        raise NotImplementedError

    def timeout(self, cols: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        """Called when a batch times out; return replacement output or None
        to drop (default: raise, failing the job like the reference)."""
        raise TimeoutError("async I/O batch timed out")


class _Entry:
    __slots__ = ("future", "batch", "is_watermark", "watermark", "deadline")

    def __init__(self, future=None, batch=None, watermark=None,
                 deadline: float = 0.0):
        self.future = future
        self.batch = batch
        self.is_watermark = watermark is not None
        self.watermark = watermark
        #: absolute monotonic deadline; the timeout clock starts at
        #: SUBMISSION (reference registers the timer on asyncInvoke), not at
        #: drain time
        self.deadline = deadline


class AsyncWaitOperator(StreamOperator):
    #: the operator owns watermark ordering: queued watermarks re-emit from
    #: _drain AFTER the results submitted before them — the runtime must not
    #: forward them early
    forwards_watermarks = False

    def __init__(self, fn: AsyncFunction | Callable, capacity: int = 16,
                 timeout_ms: int = 60_000, ordered: bool = True,
                 name: str = "async-wait"):
        if not isinstance(fn, AsyncFunction):
            f = fn

            class _Wrap(AsyncFunction):
                def invoke(self, cols):
                    return f(cols)

            fn = _Wrap()
        self.fn = fn
        self.capacity = capacity
        self.timeout_ms = timeout_ms
        self.ordered = ordered
        self.name = name
        self._queue: List[_Entry] = []
        self._pool: Optional[cf.ThreadPoolExecutor] = None

    def open(self, ctx: RuntimeContext) -> None:
        super().open(ctx)
        self.fn.open(ctx)
        self._pool = cf.ThreadPoolExecutor(
            max_workers=min(self.capacity, 8),
            thread_name_prefix=f"async-{self.name}")

    def process_batch(self, batch: RecordBatch) -> List[StreamElement]:
        out = []
        # capacity backpressure: block for completions when the queue is full
        while len([e for e in self._queue if not e.is_watermark]) >= self.capacity:
            out.extend(self._drain(wait_one=True))
        self._queue.append(_Entry(
            future=self._pool.submit(self.fn.invoke, dict(batch.columns)),
            batch=batch,
            deadline=time.monotonic() + self.timeout_ms / 1000.0))
        out.extend(self._drain())
        return out

    def process_watermark(self, watermark: Watermark) -> List[StreamElement]:
        # watermark fences: everything submitted before it must emit first
        self._queue.append(_Entry(watermark=watermark))
        return self._drain()

    def end_input(self) -> List[StreamElement]:
        out = []
        while self._queue:
            out.extend(self._drain(wait_one=True))
        return out

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=False)

    # -- emission ------------------------------------------------------------
    def _result(self, entry: _Entry) -> Optional[RecordBatch]:
        remaining = max(0.0, entry.deadline - time.monotonic())
        try:
            cols = entry.future.result(timeout=remaining)
        except cf.TimeoutError:
            entry.future.cancel()
            cols = self.fn.timeout(dict(entry.batch.columns))
            if cols is None:
                return None
        return RecordBatch({k: np.asarray(v) for k, v in cols.items()},
                           entry.batch.timestamps)

    def _drain(self, wait_one: bool = False) -> List[StreamElement]:
        out: List[StreamElement] = []
        while self._queue:
            head = self._queue[0]
            if head.is_watermark:
                self._queue.pop(0)
                out.append(head.watermark)
                continue
            if self.ordered:
                expired = time.monotonic() >= head.deadline
                if not head.future.done() and not wait_one and not expired:
                    break
                self._queue.pop(0)
                res = self._result(head)
                if res is not None:
                    out.append(res)
                wait_one = False
            else:
                # unordered: emit ANY completed entry up to the next fence
                fence = next((i for i, e in enumerate(self._queue)
                              if e.is_watermark), len(self._queue))
                now = time.monotonic()
                done = [i for i in range(fence)
                        if self._queue[i].future.done()
                        or now >= self._queue[i].deadline]
                if not done and wait_one and fence > 0:
                    # waits up to the timeout and applies the fn.timeout
                    # replacement hook — same semantics as ordered mode
                    e = self._queue.pop(0)
                    res = self._result(e)
                    if res is not None:
                        out.append(res)
                    wait_one = False
                    continue
                if not done:
                    if fence == 0:
                        continue  # head is a fence: loop handles it
                    break
                for i in reversed(done):
                    e = self._queue.pop(i)
                    res = self._result(e)
                    if res is not None:
                        out.append(res)
                wait_one = False
        return out

    #: note on checkpoints: the WHOLE queue is part of the snapshot — batches
    #: re-submit on restore, and fenced watermarks must survive too (this
    #: operator is their only forwarder: forwards_watermarks is False)
    def snapshot_state(self) -> Dict[str, Any]:
        entries = []
        for e in self._queue:
            if e.is_watermark:
                entries.append({"watermark": e.watermark.timestamp})
            else:
                entries.append({"columns": {k: np.asarray(v)
                                            for k, v in e.batch.columns.items()},
                                "timestamps": None if e.batch.timestamps is None
                                else np.asarray(e.batch.timestamps)})
        return {"queue": entries}

    def restore_state(self, snap: Dict[str, Any]) -> None:
        for e in snap.get("queue", snap.get("pending", [])):
            if "watermark" in e:
                self._queue.append(_Entry(watermark=Watermark(e["watermark"])))
            else:
                self._queue.append(_Entry(
                    future=self._pool.submit(self.fn.invoke, dict(e["columns"])),
                    batch=RecordBatch(e["columns"], timestamps=e["timestamps"]),
                    deadline=time.monotonic() + self.timeout_ms / 1000.0))
