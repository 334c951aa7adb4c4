"""Out-of-core batch runtime: external merge sort + grace hash join.

The reference's batch operators run out-of-core by design —
``ExternalSorter`` (normalized-key sort over MemorySegments with spill +
k-way merge, ``flink-runtime/.../operators/sort/``) and the spilling hybrid
hash join (``operators/hash/MutableHashTable.java``).  This module is the
columnar analog: runs/partitions are FTB files of RecordBatches (CRC-framed,
block-compressed — the same on-disk format as the connectors), and the
in-memory kernels stay the vectorized argsort / span-intersection joins of
``dataset/optimizer.py`` — spilling changes WHERE data lives, not how a run
is processed.

- :class:`ExternalSorter`: accumulate batches; when the in-memory rows
  exceed the budget, sort the run (argsort on the composite key) and spill
  it; ``merged()`` streams a k-way merge over all runs in bounded memory.
- :class:`GraceHashJoin`: partition both sides by key hash into B bucket
  files; join bucket-by-bucket in memory (each bucket pair must fit — the
  grace scheme; B is chosen from the budget).

Budget: ``FLINK_TPU_BATCH_MEMORY_ROWS`` rows (default 4M) — the managed-
memory knob of the batch runtime (``MemoryManager`` analog).  The dataset
drivers switch to these paths automatically above the budget.

The port's copy of ``flink_tpu/dataset/external.py``: the spill files are
the port's FTB files (``csrc/codec.cc``, byte for byte JAX's), buckets hash
through the port's ``core/keygroups.hash_keys``, and each bucket pair joins
through ``operators/joins._join_pairs`` on the join's ``device`` (its
device lane runs under ``FLINK_TPU_DEVICE_JOIN=1``).  :data:`spilled_bytes`
sums the bytes of the spill files, counted as each file is removed.
"""

from __future__ import annotations

import heapq
import os
import tempfile
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from flink_tpu_torch import DeviceLike
from flink_tpu_torch.core.batch import RecordBatch

#: bytes of the spill files written (``sort``: the sorted runs of
#: :class:`ExternalSorter`; ``join``: the bucket files of
#: :class:`GraceHashJoin`), summed over the process as each is removed
spilled_bytes = {"sort": 0, "join": 0}


def _remove(path: str, kind: str) -> None:
    try:
        size = os.path.getsize(path)
        os.remove(path)
    except OSError:
        return
    spilled_bytes[kind] += size


def memory_budget_rows() -> int:
    try:
        return int(os.environ.get("FLINK_TPU_BATCH_MEMORY_ROWS", 1 << 22))
    except ValueError:
        return 1 << 22


def _sort_key(batch: RecordBatch, columns: Sequence[str]):
    """np.lexsort keys (last = primary, lexsort convention)."""
    return [np.asarray(batch.column(c)) for c in reversed(columns)]


class _RunCursor:
    """Streaming cursor over one sorted spilled run (batch at a time)."""

    def __init__(self, path: str, columns: Sequence[str]):
        from flink_tpu_torch.formats import read_ftb

        self._it = read_ftb(path)
        self.columns = columns
        self._batch: Optional[RecordBatch] = None
        self._keys = None
        self._pos = 0
        self._advance_batch()

    def _advance_batch(self) -> None:
        self._batch = next(self._it, None)
        self._pos = 0
        if self._batch is not None:
            self._keys = [np.asarray(self._batch.column(c))
                          for c in self.columns]

    @property
    def exhausted(self) -> bool:
        return self._batch is None

    def head_key(self) -> Tuple:
        return tuple(k[self._pos] for k in self._keys)

    def head_scalar(self):
        return self._keys[0][self._pos]

    def pop_row(self) -> Tuple[RecordBatch, int]:
        b, i = self._batch, self._pos
        self._pos += 1
        if self._pos >= len(self._batch):
            self._advance_batch()
        return b, i


class ExternalSorter:
    """Spilling sort: bounded memory regardless of input size
    (``ExternalSorter`` / ``UnilateralSortMerger`` analog)."""

    def __init__(self, columns: Sequence[str], ascending: bool = True,
                 budget_rows: Optional[int] = None,
                 spill_dir: Optional[str] = None,
                 emit_batch_rows: int = 1 << 16):
        self.columns = list(columns)
        self.ascending = ascending
        self.budget_rows = budget_rows or memory_budget_rows()
        self.emit_batch_rows = emit_batch_rows
        self._dir = spill_dir or tempfile.mkdtemp(prefix="flink-tpu-sort-")
        self._own_dir = spill_dir is None
        self._pending: List[RecordBatch] = []
        self._pending_rows = 0
        self._runs: List[str] = []

    def add(self, batch: RecordBatch) -> None:
        if len(batch) == 0:
            return
        self._pending.append(batch)
        self._pending_rows += len(batch)
        if self._pending_rows >= self.budget_rows:
            self._spill_run()

    def _sorted_pending(self) -> Optional[RecordBatch]:
        if not self._pending:
            return None
        b = (self._pending[0] if len(self._pending) == 1
             else RecordBatch.concat(self._pending))
        order = np.lexsort(_sort_key(b, self.columns))
        if not self.ascending:
            order = order[::-1]
        self._pending = []
        self._pending_rows = 0
        return b.take(order)

    def _spill_run(self) -> None:
        from flink_tpu_torch.formats import write_ftb

        run = self._sorted_pending()
        if run is None:
            return
        path = os.path.join(self._dir, f"run-{len(self._runs):05d}.ftb")
        chunks = [run.take(np.arange(lo, min(lo + self.emit_batch_rows,
                                             len(run))))
                  for lo in range(0, len(run), self.emit_batch_rows)]
        write_ftb(chunks, path)
        self._runs.append(path)

    def merged(self) -> Iterator[RecordBatch]:
        """K-way merge over the spilled runs + the in-memory tail, streamed
        as bounded batches.  Single-column keys use a vectorized GALLOP
        merge (emit the leading run's whole prefix up to the runner-up's
        head via ``searchsorted`` — numpy slices, not per-row Python);
        composite keys fall back to a row heap."""
        tail = self._sorted_pending()
        if not self._runs:
            if tail is not None:
                yield tail
            self._cleanup()
            return
        if tail is not None:
            from flink_tpu_torch.formats import write_ftb

            path = os.path.join(self._dir, f"run-{len(self._runs):05d}.ftb")
            write_ftb([tail], path)
            self._runs.append(path)
        cursors = [_RunCursor(p, self.columns) for p in self._runs]
        live = [c for c in cursors if not c.exhausted]
        numeric = (live and live[0]._keys[0].dtype.kind in "iuf")
        try:
            if len(self.columns) == 1 and numeric:
                yield from self._merge_gallop(cursors)
            else:
                yield from self._merge_rowheap(cursors)
        finally:
            # abandoned/failed iteration must not leak input-sized run files
            self._cleanup()

    def _merge_gallop(self, cursors: List[_RunCursor]
                      ) -> Iterator[RecordBatch]:
        asc = self.ascending
        out: List[RecordBatch] = []
        out_rows = 0
        live = [c for c in cursors if not c.exhausted]
        while live:
            heads = [c.head_scalar() for c in live]
            # lead cursor + runner-up WITHOUT negating keys (negation would
            # overflow uint64 and wrap INT64_MIN)
            j = int(np.argmin(heads)) if asc else int(np.argmax(heads))
            c = live[j]
            if len(live) == 1:
                hi = len(c._batch)
            else:
                others = [h for i, h in enumerate(heads) if i != j]
                runner_up = min(others) if asc else max(others)
                keys = c._keys[0]
                if asc:
                    # prefix of the (ascending) lead batch <= runner-up
                    hi = int(np.searchsorted(keys, runner_up, side="right"))
                else:
                    # prefix of the DESCENDING lead batch >= runner-up:
                    # count via the reversed (ascending) view
                    hi = len(keys) - int(np.searchsorted(
                        keys[::-1], runner_up, side="left"))
                hi = max(hi, c._pos + 1)
            chunk = c._batch.take(np.arange(c._pos, hi))
            c._pos = hi
            if c._pos >= len(c._batch):
                c._advance_batch()
            out.append(chunk)
            out_rows += len(chunk)
            if out_rows >= self.emit_batch_rows:
                yield (RecordBatch.concat(out) if len(out) > 1 else out[0])
                out, out_rows = [], 0
            live = [x for x in live if not x.exhausted]
        if out:
            yield RecordBatch.concat(out) if len(out) > 1 else out[0]

    def _merge_rowheap(self, cursors: List[_RunCursor]
                       ) -> Iterator[RecordBatch]:
        sign = 1 if self.ascending else -1

        def key_of(c: _RunCursor):
            k = c.head_key()
            return k if sign == 1 else tuple(_Neg(x) for x in k)

        heap = [(key_of(c), j) for j, c in enumerate(cursors)
                if not c.exhausted]
        heapq.heapify(heap)
        out_idx: List[Tuple[RecordBatch, int]] = []

        def flush():
            nonlocal out_idx
            if not out_idx:
                return None
            cols = {}
            first = out_idx[0][0]
            for cname in first.columns:
                cols[cname] = np.asarray(
                    [np.asarray(b.column(cname))[i] for b, i in out_idx])
            ts = (np.asarray([np.asarray(b.timestamps)[i]
                              for b, i in out_idx], np.int64)
                  if first.timestamps is not None else None)
            out_idx = []
            return RecordBatch(cols, timestamps=ts)

        while heap:
            _k, j = heapq.heappop(heap)
            c = cursors[j]
            out_idx.append(c.pop_row())
            if not c.exhausted:
                heapq.heappush(heap, (key_of(c), j))
            if len(out_idx) >= self.emit_batch_rows:
                yield flush()
        last = flush()
        if last is not None:
            yield last

    def sorted_batch(self) -> Optional[RecordBatch]:
        """Materialize the fully sorted result (drivers' convenience)."""
        parts = list(self.merged())
        if not parts:
            return None
        return parts[0] if len(parts) == 1 else RecordBatch.concat(parts)

    def _cleanup(self) -> None:
        for p in self._runs:
            _remove(p, "sort")
        self._runs = []
        if self._own_dir:
            try:
                os.rmdir(self._dir)
            except OSError:
                pass


class _Neg:
    """Ordering inverter for descending k-way merges over mixed types."""

    __slots__ = ("v",)

    def __init__(self, v):
        self.v = v

    def __lt__(self, other):
        return other.v < self.v

    def __eq__(self, other):
        return other.v == self.v


class GraceHashJoin:
    """Spilling equi-join (``MutableHashTable`` hybrid hash analog): both
    sides hash-partition into bucket files; each bucket pair joins in
    memory with the span-intersection kernel (or, under
    ``FLINK_TPU_DEVICE_JOIN=1``, the device lane on ``device``).

    ``add`` spills INCREMENTALLY: once accumulated input crosses the row
    budget, buffered batches flush to depth-0 bucket files and every later
    batch streams straight to its buckets — so building the join holds at
    most ~budget rows in memory no matter how large the inputs (the
    streamed-plan dam breaker).  Skewed buckets
    recursively repartition with a re-salted hash; a single hot KEY cannot
    be split and joins in memory past ``_MAX_DEPTH``."""

    _MAX_DEPTH = 3

    def __init__(self, left_key: str, right_key: str,
                 budget_rows: Optional[int] = None,
                 num_buckets: Optional[int] = None,
                 spill_dir: Optional[str] = None,
                 device: DeviceLike = None):
        self.left_key = left_key
        self.right_key = right_key
        self.budget_rows = budget_rows or memory_budget_rows()
        self.num_buckets = num_buckets or 0
        self._dir = spill_dir or tempfile.mkdtemp(prefix="flink-tpu-join-")
        self._left: List[RecordBatch] = []
        self._right: List[RecordBatch] = []
        self._rows = [0, 0]
        self._spilled = False
        self._B = 0
        self._file_rows: Dict[str, int] = {}
        self.device = device

    def add(self, side: int, batch: RecordBatch) -> None:
        if len(batch) == 0:
            return
        self._rows[side] += len(batch)
        if self._spilled:
            self._write_buckets(side, [batch], depth=0, tag="d0",
                                B=self._B)
            return
        (self._left if side == 0 else self._right).append(batch)
        if self._rows[0] + self._rows[1] > self.budget_rows:
            # switch to spill mode: flush the buffer, stream from now on
            self._spilled = True
            self._B = self.num_buckets or 32
            self._write_buckets(0, self._left, depth=0, tag="d0", B=self._B)
            self._write_buckets(1, self._right, depth=0, tag="d0",
                                B=self._B)
            self._left, self._right = [], []

    def _key_name(self, side: int) -> str:
        return self.left_key if side == 0 else self.right_key

    def _bucket_of(self, keys: np.ndarray, B: int) -> np.ndarray:
        from flink_tpu_torch.core.keygroups import hash_keys

        return (np.abs(hash_keys(keys).astype(np.int64)) % B)

    def _path(self, tag: str, side: int, b: int) -> str:
        return os.path.join(self._dir, f"{tag}-s{side}-b{b:04d}.ftb")

    def _write_buckets(self, side: int, batches, depth: int, tag: str,
                       B: int) -> None:
        from flink_tpu_torch.formats import write_ftb

        os.makedirs(self._dir, exist_ok=True)
        key_name = self._key_name(side)
        for batch in batches:
            keys = np.asarray(batch.column(key_name))
            if depth:  # re-salt: a skewed bucket must re-split differently
                keys = keys + np.int64(depth * 0x9E3779B9) \
                    if keys.dtype.kind in "iu" else keys
            buckets = self._bucket_of(keys, B)
            for b in np.unique(buckets).tolist():
                part = batch.select(buckets == b)
                p = self._path(tag, side, int(b))
                write_ftb([part], p, append=True)
                self._file_rows[p] = self._file_rows.get(p, 0) + len(part)

    def join_pairs(self) -> Iterator[Tuple[RecordBatch, np.ndarray,
                                           RecordBatch, np.ndarray]]:
        """Yields (left_batch, left_idx, right_batch, right_idx) per bucket
        pair; in-memory (single pair) when everything fit the budget."""
        from flink_tpu_torch.operators.joins import _join_pairs

        try:
            if not self._spilled:
                l = RecordBatch.concat(self._left) if self._left else None
                r = RecordBatch.concat(self._right) if self._right else None
                if l is not None and r is not None and len(l) and len(r):
                    li, ri = _join_pairs(
                        np.asarray(l.column(self.left_key)),
                        np.asarray(r.column(self.right_key)), self.device)
                    if li.size:
                        yield l, li, r, ri
                return
            parent = self._rows[0] + self._rows[1]
            for b in range(self._B):
                yield from self._join_bucket("d0", b, depth=0,
                                             parent_rows=parent)
        finally:
            self._left, self._right = [], []
            self._rows = [0, 0]
            self._spilled = False
            for p in list(self._file_rows):
                _remove(p, "join")
            self._file_rows = {}
            try:
                os.rmdir(self._dir)
            except OSError:
                pass

    def _join_bucket(self, tag: str, b: int, depth: int, parent_rows: int):
        """Join one bucket pair, recursively repartitioning (streamed —
        batches flow file->file, never fully resident) while it exceeds the
        budget AND re-splitting still shrinks it."""
        from flink_tpu_torch.formats import read_ftb
        from flink_tpu_torch.operators.joins import _join_pairs

        lp, rp = self._path(tag, 0, b), self._path(tag, 1, b)
        rows = self._file_rows.get(lp, 0) + self._file_rows.get(rp, 0)
        if not (os.path.exists(lp) and os.path.exists(rp)):
            return
        if rows > self.budget_rows and depth < self._MAX_DEPTH \
                and rows < parent_rows:
            sub = f"{tag}b{b}"
            B2 = max(2, int(np.ceil(rows / max(self.budget_rows // 2, 1))))
            for side, path in ((0, lp), (1, rp)):
                self._write_buckets(side, read_ftb(path), depth + 1, sub, B2)
            for b2 in range(B2):
                yield from self._join_bucket(sub, b2, depth + 1, rows)
            return
        l = RecordBatch.concat(list(read_ftb(lp)))
        r = RecordBatch.concat(list(read_ftb(rp)))
        if len(l) and len(r):
            li, ri = _join_pairs(np.asarray(l.column(self.left_key)),
                                 np.asarray(r.column(self.right_key)),
                                 self.device)
            if li.size:
                yield l, li, r, ri
