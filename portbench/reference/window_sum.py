"""Plain reference of a keyed tumbling event-time window sum (Flink's
``TumblingEventTimeWindows`` with a ``sum``; allowed lateness 0, every
record on time).

It reads the batches the benchmark made and nothing of the program: a
window ``w`` holds every record with ``w * size <= ts < (w + 1) * size``,
and its rows are the keys with at least one record there, each with the
sum of its values.  Sums are f64 from the f32 values; :meth:`fired`
computes the rows, and :meth:`cut` a checkpoint's state, in another
precision (the control).
"""

from __future__ import annotations

import numpy as np
import torch


class _Rows:
    """Fired rows in the column layout a window fire emits."""

    def __init__(self, cols: dict):
        self._cols = cols

    def column(self, name: str):
        return self._cols[name]

    def __len__(self) -> int:
        return len(self._cols["k"])


class TumblingSum:
    """The pool of ``(keys, values, timestamps)`` batches, repeated: pass
    ``p`` over the pool shifts its event times by ``p * len(pool) *
    ms_per_batch``."""

    def __init__(self, pool, size_ms: int, ms_per_batch: int, n_keys: int):
        self.pool = pool
        self.size = int(size_ms)
        self.ms = int(ms_per_batch)
        self.n_keys = int(n_keys)
        self.span = len(pool) * self.ms
        self.lo = np.array([int(ts.min()) for _, _, ts in pool])
        self.hi = np.array([int(ts.max()) for _, _, ts in pool])
        self._cache: dict = {}

    def parts(self, w: int, until=None):
        """Window ``w``'s records (those before event time ``until``, where
        given) as ``(pool batch, lo, hi)``: the records of pool batch ``i``
        with ``lo <= ts < hi`` in the batch's own times (``None`` for both
        where the whole batch falls in ``w``)."""
        a, b = w * self.size, (w + 1) * self.size
        if until is not None:
            b = min(b, int(until))
        out = []
        for p in range(a // self.span - 1, b // self.span + 1):
            shift = p * self.span
            for i in np.flatnonzero((self.lo + shift < b)
                                    & (self.hi + shift >= a)).tolist():
                whole = self.lo[i] + shift >= a and self.hi[i] + shift < b
                out.append((i, None, None) if whole
                           else (i, a - shift, b - shift))
        return out

    def _select(self, i: int, lo, hi):
        k, v, ts = self.pool[i]
        if lo is None:
            return k, v
        inside = (ts >= lo) & (ts < hi)
        return k[inside], v[inside]

    def records(self, w: int, until=None):
        """Keys and values of every record of window ``w`` (before event
        time ``until``, where given)."""
        sel = [self._select(*part) for part in self.parts(w, until)]
        if not sel:
            return np.zeros(0, np.int64), np.zeros(0, np.float32)
        return (np.concatenate([k for k, _ in sel]),
                np.concatenate([v for _, v in sel]))

    def _part(self, part) -> tuple:
        """(keys present, f64 total) of one part of a window; parts repeat
        from pass to pass over the pool, so each is worked out once."""
        got = self._cache.get(part)
        if got is None:
            keys, vals = self._select(*part)
            present = np.zeros(self.n_keys, bool)
            present[keys] = True
            got = self._cache[part] = (present,
                                       float(vals.sum(dtype=np.float64)))
        return got

    def window(self, w: int) -> dict:
        """Window ``w``'s row count and f64 total."""
        present = np.zeros(self.n_keys, bool)
        total = 0.0
        for part in self.parts(w):
            p, t = self._part(part)
            present |= p
            total += t
        return {"rows": int(np.count_nonzero(present)), "total": total}

    def sums(self, w: int, until=None):
        """Window ``w``'s records a key and f64 sum a key, over every key
        (of the records before event time ``until``, where given)."""
        keys, vals = self.records(w, until)
        return (np.bincount(keys, minlength=self.n_keys),
                np.bincount(keys, weights=vals.astype(np.float64),
                            minlength=self.n_keys))

    def fired(self, w: int, dtype: torch.dtype) -> _Rows:
        """Window ``w``'s rows with every sum accumulated in ``dtype``, the
        values first rounded to it."""
        keys, vals = self.records(w)
        t_keys = torch.from_numpy(keys)
        sums = torch.zeros(self.n_keys, dtype=dtype).index_add_(
            0, t_keys, torch.from_numpy(vals).to(dtype))
        present = torch.zeros(self.n_keys, dtype=torch.bool)
        present[t_keys] = True
        k = torch.nonzero(present).flatten()
        n = int(k.numel())
        return _Rows({"k": k.numpy(),
                      "result": sums[k].to(torch.float64).numpy(),
                      "window_start": np.full(n, w * self.size, np.int64),
                      "window_end": np.full(n, (w + 1) * self.size,
                                            np.int64)})

    def cut(self, windows, until: int, dtype: torch.dtype) -> dict:
        """A checkpoint's state taken before event time ``until`` for the
        open ``windows``, each key's sum accumulated in ``dtype``, in the
        layout the operator's ``snapshot_state`` gives: ``key_index``
        (slot -> key), ``panes``, ``counts`` and ``leaves`` a slot a
        pane."""
        counts, leaves = [], []
        for w in windows:
            keys, vals = self.records(w, until)
            t_keys = torch.from_numpy(keys)
            counts.append(np.bincount(keys, minlength=self.n_keys))
            leaves.append(torch.zeros(self.n_keys, dtype=dtype).index_add_(
                0, t_keys, torch.from_numpy(vals).to(dtype)).to(
                torch.float64).numpy())
        shape = (self.n_keys, 0)
        return {"key_index": {"reverse": np.arange(self.n_keys,
                                                   dtype=np.int64)},
                "panes": np.asarray(list(windows), np.int64),
                "counts": (np.stack(counts, 1).astype(np.int32) if counts
                           else np.zeros(shape, np.int32)),
                "leaves": [np.stack(leaves, 1) if leaves
                           else np.zeros(shape)]}
