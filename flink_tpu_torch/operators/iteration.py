"""Streaming iterations: feedback edges via in-memory queues (port of
``flink_tpu/operators/iteration.py``).

Analog of ``StreamIterationHead``/``StreamIterationTail``
(``runtime/tasks/StreamIterationHead.java``): ``iterate()`` unions the
original stream with a feedback source backed by a shared queue;
``close_with(stream)`` attaches a feedback sink writing that stream's
batches back into the queue.  Like the reference, termination is
timeout-based: the feedback source ends after ``max_wait_ms`` with no
feedback data once its upstream finished feeding it.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Iterator, List, Optional

from flink_tpu_torch.core.batch import RecordBatch, StreamElement
from flink_tpu_torch.connectors.sources import Source, SourceSplit
from flink_tpu_torch.operators.base import StreamOperator


class FeedbackQueue:
    """Shared buffer between iteration tail and head."""

    def __init__(self):
        self._q: deque = deque()
        self._lock = threading.Lock()
        self.closed = False

    def put(self, batch: RecordBatch) -> None:
        with self._lock:
            self._q.append(batch)

    def poll(self) -> Optional[RecordBatch]:
        with self._lock:
            return self._q.popleft() if self._q else None

    def __len__(self) -> int:
        with self._lock:
            return len(self._q)


class FeedbackSource(Source):
    """Iteration head: replays fed-back batches; ends after ``max_wait_ms``
    of quiet (the reference's iteration timeout)."""

    bounded = True  # terminates via timeout

    def __init__(self, queue: FeedbackQueue, max_wait_ms: int = 200):
        self.queue = queue
        self.max_wait_ms = max_wait_ms

    def create_splits(self, parallelism: int) -> List[SourceSplit]:
        return [SourceSplit(self, 0, 1)]

    def read_split(self, index: int, of: int) -> Iterator[StreamElement]:
        last_data = time.monotonic()
        while True:
            b = self.queue.poll()
            if b is not None:
                last_data = time.monotonic()
                yield b
                continue
            if (time.monotonic() - last_data) * 1000 > self.max_wait_ms:
                return
            time.sleep(0.001)
            yield RecordBatch({})  # keep the round-robin loop moving


class FeedbackSinkOperator(StreamOperator):
    """Iteration tail: pushes batches back to the head's queue."""

    def __init__(self, queue: FeedbackQueue, name: str = "iteration-tail"):
        self.queue = queue
        self.name = name

    def process_batch(self, batch: RecordBatch) -> List[StreamElement]:
        if len(batch):
            self.queue.put(batch)
        return []

    def process_watermark(self, watermark) -> List[StreamElement]:
        return []
