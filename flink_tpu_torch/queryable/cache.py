"""Hot-key response cache for the queryable serving tier (port of
``flink_tpu/queryable/cache.py``).

Production read traffic is zipfian: a handful of hot keys absorb most of
the lookup volume, and re-running the segment/shard locate + gather for
the same (state, key, consistency) between state changes is pure waste.
This cache memoizes **per-key answer rows** under an explicit content
epoch:

- ``checkpoint`` consistency: the epoch is the replica's serving
  checkpoint id — every completed-checkpoint ingest silently invalidates
  all of the state's cached rows (an entry whose stored epoch no longer
  matches reads as a miss and is dropped);
- ``live`` consistency: the epoch is the view's publish counter — every
  fired window invalidates, so a cached row can never outlive the value
  it memoized.

Entries are ``(found, row)`` pairs — a *negative* answer (key absent) is
cacheable under the same epoch rule.  Bounded LRU; thread-safe; reads are
batched (``get_many``/``put_many``) so the serve path pays one lock
round-trip per request, not per key.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

#: default capacity: enough for a serious hot set, bounded against
#: high-cardinality scans evicting rather than growing
DEFAULT_CAPACITY = 1 << 16


class HotKeyCache:
    """Bounded LRU of per-key lookup answers, invalidated by epoch."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self.capacity = max(1, int(capacity))
        self._d: "OrderedDict[Tuple, Tuple[Any, bool, Any]]" = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.invalidations = 0

    def get_many(self, state: str, consistency: str, epoch,
                 keys) -> Tuple[Dict[int, Tuple[bool, Any]], List[int]]:
        """-> ({query index: (found, row)}, [missing query indices]).
        Entries stored under a different epoch count as invalidations and
        are evicted on sight."""
        hits: Dict[int, Tuple[bool, Any]] = {}
        missing: List[int] = []
        with self._lock:
            d = self._d
            for i, k in enumerate(keys):
                ck = (state, consistency, k)
                got = d.get(ck)
                if got is None:
                    missing.append(i)
                elif got[0] != epoch:
                    del d[ck]
                    self.invalidations += 1
                    missing.append(i)
                else:
                    d.move_to_end(ck)
                    hits[i] = (got[1], got[2])
            self.hits += len(hits)
            self.misses += len(missing)
        return hits, missing

    def put_many(self, state: str, consistency: str, epoch, keys,
                 entries) -> None:
        """Store ``entries[i] = (found, row)`` for each key (row is an
        opaque value — the dict path stores value dicts, the columnar
        path stores per-key column tuples)."""
        with self._lock:
            d = self._d
            for k, (found, row) in zip(keys, entries):
                d[(state, consistency, k)] = (epoch, found, row)
                d.move_to_end((state, consistency, k))
            while len(d) > self.capacity:
                d.popitem(last=False)

    def clear(self) -> None:
        with self._lock:
            self._d.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._d)

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            total = self.hits + self.misses
            return {"entries": len(self._d),
                    "capacity": self.capacity,
                    "hits": self.hits,
                    "misses": self.misses,
                    "invalidations": self.invalidations,
                    "hit_rate": round(self.hits / total, 4) if total else 0.0}
