"""Sources: batched record producers (port of ``flink_tpu/connectors/sources.py``).

The unified source contract mirrors FLIP-27
(``flink-core/.../api/connector/source/Source.java``): a source exposes
*splits* via ``create_splits`` and readers turn a split into an ordered
iterator of ``StreamElement``s (RecordBatches + Watermarks).  The executor is
the ``SourceReaderBase``/``SourceOperator`` analog: it drains reader batches
through the pipeline.  Boundedness drives end-of-input handling
(``Boundedness.java``).
"""

from __future__ import annotations

import socket as _socket
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, Iterator, List, Mapping, Optional, Sequence

import numpy as np

from flink_tpu_torch.core.batch import RecordBatch, StreamElement, Watermark


class Source:
    """Base source. bounded=True sources end; unbounded ones run until a
    record budget/cancellation (the executor enforces budgets)."""

    bounded: bool = True

    def create_splits(self, parallelism: int) -> List["SourceSplit"]:
        """Partition the source into independent splits (``SplitEnumerator``)."""
        return [SourceSplit(self, 0, 1)]


@dataclass
class SourceSplit:
    """One independently readable partition of a source."""

    source: "Source"
    index: int
    of: int

    def read(self) -> Iterator[StreamElement]:
        return self.source.read_split(self.index, self.of)


def split_id_of(split) -> str:
    """Canonical split identity, shared by every runtime (reader-side
    finished/assigned bookkeeping, enumerator reclaim, executor position
    tracking must all key identically): a ``split_id`` method or plain
    string attribute wins, else ``index/of``."""
    sid = getattr(split, "split_id", None)
    if callable(sid):
        return sid()
    return sid if sid else f"{split.index}/{split.of}"


def _columns_from_rows(rows: Sequence[Mapping[str, Any]]) -> Dict[str, np.ndarray]:
    if not rows:
        return {}
    names = rows[0].keys()
    return {n: np.asarray([r[n] for r in rows]) for n in names}


class CollectionSource(Source):
    """Bounded in-memory source (``env.fromCollection`` analog). Accepts rows
    (list of dicts) or a columns mapping; optional timestamp column."""

    def __init__(self, rows: Optional[Sequence[Mapping[str, Any]]] = None,
                 columns: Optional[Mapping[str, Any]] = None,
                 timestamp_column: Optional[str] = None,
                 batch_size: int = 4096):
        if columns is None:
            columns = _columns_from_rows(rows or [])
        self.columns = {k: np.asarray(v) for k, v in columns.items()}
        self.timestamp_column = timestamp_column
        self.batch_size = batch_size
        n = 0
        for v in self.columns.values():
            n = len(v)
            break
        self.n = n

    def create_splits(self, parallelism: int) -> List[SourceSplit]:
        return [SourceSplit(self, i, parallelism) for i in range(parallelism)]

    def read_split(self, index: int, of: int) -> Iterator[StreamElement]:
        # contiguous range per split
        lo = self.n * index // of
        hi = self.n * (index + 1) // of
        for start in range(lo, hi, self.batch_size):
            stop = min(start + self.batch_size, hi)
            cols = {k: v[start:stop] for k, v in self.columns.items()}
            ts = (np.asarray(cols[self.timestamp_column], np.int64)
                  if self.timestamp_column else None)
            yield RecordBatch(cols, timestamps=ts)


class GeneratorSource(Source):
    """Data-generator source (``DataGeneratorSource`` analog): calls
    ``make_batch(split_index, batch_index, batch_size) -> columns dict`` until
    ``num_batches`` is reached."""

    def __init__(self, make_batch: Callable[[int, int, int], Mapping[str, Any]],
                 num_batches: int, batch_size: int = 4096,
                 timestamp_column: Optional[str] = None, bounded: bool = True):
        self.make_batch = make_batch
        self.num_batches = num_batches
        self.batch_size = batch_size
        self.timestamp_column = timestamp_column
        self.bounded = bounded

    def create_splits(self, parallelism: int) -> List[SourceSplit]:
        return [SourceSplit(self, i, parallelism) for i in range(parallelism)]

    def read_split(self, index: int, of: int) -> Iterator[StreamElement]:
        for b in range(index, self.num_batches, of):
            cols = dict(self.make_batch(index, b, self.batch_size))
            ts = (np.asarray(cols[self.timestamp_column], np.int64)
                  if self.timestamp_column else None)
            yield RecordBatch({k: np.asarray(v) for k, v in cols.items()},
                              timestamps=ts)


class SocketTextSource(Source):
    """``env.socketTextStream`` analog (baseline config #1 source): reads
    newline-delimited text from a TCP socket, emits ``{"line": ...}`` batches.
    Batches are cut by ``batch_size`` lines or ``linger_ms``, whichever first —
    the linger bound keeps fire latency low on slow streams."""

    bounded = False

    def __init__(self, host: str, port: int, batch_size: int = 4096,
                 linger_ms: int = 50, max_retries: int = 3):
        self.host, self.port = host, port
        self.batch_size = batch_size
        self.linger_ms = linger_ms
        self.max_retries = max_retries

    def read_split(self, index: int, of: int) -> Iterator[StreamElement]:
        if index != 0:
            return
        retries = 0
        while retries <= self.max_retries:
            try:
                with _socket.create_connection((self.host, self.port)) as sock:
                    sock.settimeout(self.linger_ms / 1000.0)
                    buf = b""
                    lines: List[str] = []
                    deadline = time.monotonic() + self.linger_ms / 1000.0
                    while True:
                        try:
                            data = sock.recv(1 << 16)
                            if not data:
                                break
                            buf += data
                            *complete, buf = buf.split(b"\n")
                            lines.extend(l.decode("utf-8", "replace")
                                         for l in complete)
                        except _socket.timeout:
                            pass
                        now = time.monotonic()
                        if lines and (len(lines) >= self.batch_size or now >= deadline):
                            chunk, lines = lines[: self.batch_size], lines[self.batch_size:]
                            yield RecordBatch({"line": np.asarray(chunk, object)})
                            deadline = now + self.linger_ms / 1000.0
                    if buf:
                        lines.append(buf.decode("utf-8", "replace"))
                    if lines:
                        yield RecordBatch({"line": np.asarray(lines, object)})
                    return
            except (ConnectionError, OSError):
                retries += 1
                time.sleep(0.2 * retries)


class IteratorSource(Source):
    """Wraps any iterator of pre-built StreamElements (testing / replay)."""

    def __init__(self, elements: Iterable[StreamElement], bounded: bool = True):
        self.elements = list(elements)
        self.bounded = bounded

    def read_split(self, index: int, of: int) -> Iterator[StreamElement]:
        if index == 0:
            yield from self.elements
