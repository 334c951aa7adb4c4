"""File system connector, source half: the split-based ``FileSource``
(port of the source side of ``flink_tpu/connectors/file_source.py``).

The FLIP-27 file source analog (``flink-connectors/flink-connector-files``:
``FileSource`` + ``SplitEnumerator`` over file splits): one split per
matched file, readers track a **row position** so checkpoints capture exact
resume points — the executor snapshots ``reader.position`` per split and
hands it back to ``open_split`` on restore (``SourceReader.snapshotState``
analog).  The SQL ``filesystem`` connector reads through it.  The
two-phase-commit ``FileSink`` comes with the other connectors (ROADMAP
Queue A item 12).
"""

from __future__ import annotations

import glob as _glob
import os
from dataclasses import dataclass
from typing import Iterator, List, Optional

import numpy as np

from flink_tpu_torch.connectors.sources import Source, SourceSplit
from flink_tpu_torch.core.batch import RecordBatch, StreamElement
from flink_tpu_torch.formats import reader_for


class _PositionedFileReader:
    """Iterator over one file's batches; ``position`` = rows already emitted
    (checkpointable, consumed by ``open_split`` on restore)."""

    def __init__(self, source: "FileSource", path: str, start_row: int):
        self.position = int(start_row)
        self._it = source._read_file(path, start_row)

    def __iter__(self):
        return self

    def __next__(self) -> StreamElement:
        el = next(self._it)
        if isinstance(el, RecordBatch):
            self.position += len(el)
        return el


class FileSource(Source):
    """Reads a file, directory, or glob in ``csv``/``jsonl``/``ftb``/``seq`` format.
    One split per file (``FileSourceSplit`` analog)."""

    def __init__(self, path: str, format: str = "csv",
                 timestamp_column: Optional[str] = None,
                 batch_size: int = 8192, **format_kwargs):
        self.path = path
        self.format = format
        self.timestamp_column = timestamp_column
        self.batch_size = batch_size
        self.format_kwargs = format_kwargs
        reader_for(format)  # validate eagerly

    def _files(self) -> List[str]:
        if os.path.isdir(self.path):
            fs = [os.path.join(self.path, f) for f in sorted(os.listdir(self.path))
                  if not f.startswith((".", "_"))]
        else:
            fs = sorted(_glob.glob(self.path)) or [self.path]
        files = [f for f in fs if os.path.isfile(f)]
        if not files and not os.path.isdir(self.path):
            # a typo'd path must fail loudly, not run an empty job to success
            raise FileNotFoundError(
                f"FileSource: no files match {self.path!r}")
        return files

    def create_splits(self, parallelism: int) -> List[SourceSplit]:
        files = self._files()
        return [FileSplit(self, i, len(files), path=f) for i, f in enumerate(files)]

    def _read_file(self, path: str, start_row: int) -> Iterator[StreamElement]:
        read = reader_for(self.format)
        kw = dict(self.format_kwargs)
        if self.format in ("csv", "jsonl", "seq"):
            kw.setdefault("batch_size", self.batch_size)
            kw["timestamp_column"] = self.timestamp_column
            kw["skip_rows"] = start_row
            yield from read(path, **kw)
        else:  # ftb: frame-level skip by rows
            skipped = 0
            for b in read(path, **kw):
                if skipped + len(b) <= start_row:
                    skipped += len(b)
                    continue
                if skipped < start_row:  # partial batch resume
                    b = b.take(np.arange(start_row - skipped, len(b)))
                    skipped = start_row
                yield b

    # stateful-reader protocol (used by the executor; falls back to
    # ``split.read()`` for sources that don't implement it)
    def open_split(self, split: "FileSplit",
                   position: Optional[int]) -> _PositionedFileReader:
        return _PositionedFileReader(self, split.path, position or 0)


@dataclass
class FileSplit(SourceSplit):
    path: str = ""

    @property
    def split_id(self) -> str:
        return self.path

    def read(self) -> Iterator[StreamElement]:
        return self.source.open_split(self, 0)
