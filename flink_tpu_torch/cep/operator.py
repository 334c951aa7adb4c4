"""CEP NFA operator over keyed streams (port of ``flink_tpu/cep/operator.py``).

Analog of ``flink-libraries/flink-cep``'s ``CepOperator`` + ``nfa/NFA.java:86``
+ ``sharedbuffer/SharedBuffer.java:62``, re-shaped for the batched runtime:

- **Vectorized condition evaluation**: every stage's predicate runs ONCE per
  batch over the whole column set, producing a ``[B, num_stages]`` bool
  matrix.
- **Batched NFA transitions**: for eligible patterns (``cep/vectorized.py``
  classifier) the per-key partial matches of ALL keys advance together as
  fixed-shape arrays, one batched step per event position per drain —
  bit-identical to the interpreted matcher below.  On a CUDA device the
  step runs as torch ops on the card (``vectorized.step_device``), and the
  whole drain is ONE dispatch under the device watchdog
  (``runtime/device_health.guarded_dispatch``, label
  ``cep.vectorized_drain``); a quarantine degrades the operator to the
  interpreted engine mid-job, digest-identical.  Ineligible shapes
  (``followedByAny``, ``greedy()``, drain-time/``PREV`` conditions) run the
  interpreted per-key NFA: per key, events are buffered until the
  watermark passes them (the reference buffers in ``elementQueueState``
  and processes on watermark, ``CepOperator.onEventTime``), then sorted by
  timestamp and fed through the NFA with branching partial matches.

Event rows are buffered **columnar** (``_RowStore``): ``process_batch``
never materializes per-row dicts up front — rows materialize lazily, only
for events referenced by live partials or completed matches at emit time.

Supported semantics: strict (``next``) / relaxed (``followedBy``) /
non-deterministic relaxed (``followedByAny``) contiguity, NOT-patterns
(``notNext``/``notFollowedBy``, incl. trailing ``notFollowedBy`` completing
on ``within``-window close), ``times``/``oneOrMore``/``optional``
quantifiers with ``greedy()`` and ``until()``, ``within``, NO_SKIP and
SKIP_PAST_LAST_EVENT after-match strategies (``NFA.java:86``,
``Quantifier.java``).  Keys are any hashable values; the vectorized engine
maps them to slots through ``state/keyindex.py`` ``make_key_index`` (the C
keydict for integer keys, an ``ObjectKeyIndex`` for others).

``CEP.pattern(keyed, pattern).select(fn)`` is the DataStream entry; each
vectorized drain records a ``cep.vectorized_drain`` span when the span
journal is installed.
"""

from __future__ import annotations

import bisect
import contextlib
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from flink_tpu_torch import DeviceLike, resolve_device
from flink_tpu_torch.core.batch import (LONG_MIN, RecordBatch, StreamElement,
                                  Watermark)
from flink_tpu_torch.cep.pattern import AfterMatchSkipStrategy, Pattern
from flink_tpu_torch.observability import tracing
from flink_tpu_torch.operators.base import StreamOperator


@dataclass(frozen=True)
class _Partial:
    """One partial match: position in the pattern + taken events.

    events: tuple of (stage_index, event_id); count = matches of the
    CURRENT stage taken so far (for quantifiers); greedy_from: index of the
    greedy looping stage this partial advanced out of (-1 = none) — while
    events still match that loop, the loop sibling consumes them and this
    partial must ignore them (``Quantifier.greedy`` semantics)."""

    stage_i: int
    count: int
    events: Tuple[Tuple[int, int], ...]
    first_ts: int
    greedy_from: int = -1


class NFA:
    """Pattern matcher for one key (``NFA.java:86`` analog)."""

    def __init__(self, pattern: Pattern):
        self.pattern = pattern
        self.stages = pattern.stages
        last = pattern.stages[-1]
        #: fast-path flag: only trailing notFollowedBy patterns need the
        #: per-event window-close harvest
        self._trailing_negation = last.negated and last.contiguity != "strict"
        self.partials: List[_Partial] = [_Partial(0, 0, (), LONG_MIN)]
        #: SKIP_PAST_LAST_EVENT barrier: events at/before this ts cannot
        #: extend or start matches
        self.skip_until_ts: int = LONG_MIN
        #: legacy event-id -> row map: rows now resolve through the
        #: operator's columnar ``_RowStore``; stays (empty) for readers of
        #: the old layout
        self._rows: Dict[int, dict] = {}

    def _expired(self, pm: _Partial, ts: int) -> bool:
        w = self.pattern.within_ms
        return (w is not None and pm.first_ts != LONG_MIN
                and ts - pm.first_ts > w)

    def advance(self, event_id: int, ts: int, stage_bits: np.ndarray,
                until_bits: Optional[np.ndarray] = None,
                ) -> List[Tuple[Tuple[int, int], ...]]:
        """Feed one event; returns completed matches (event lists).

        Per partial the NFA edges are: **take** (event matches current
        stage — branch into 'stay in looping stage' and, once the
        quantifier's minimum is met, 'pointer moves to next stage'),
        **ignore** (relaxed stages skip non-matching events; ``relaxed_any``
        = ``followedByAny`` may skip matching ones too), and **die** (strict
        stage miss — the pointer-move sibling was already branched at take
        time, so nothing is lost).  Optional stages forward the event to the
        following stage when they have taken nothing yet.  NEGATED stages
        (``notNext``/``notFollowedBy``) invert: a condition match KILLS the
        partial; strict negation is satisfied by one clean event (which then
        feeds the following stage), relaxed negation watches until the
        following stage matches.  Greedy loops consume events the advanced
        sibling would otherwise take; ``until`` closes a loop without taking
        the closing event."""
        if ts <= self.skip_until_ts:
            return []
        n_stages = len(self.stages)
        matches: List[Tuple[Tuple[int, int], ...]] = []
        new_partials: List[_Partial] = []
        seen = set()

        def add(pm: _Partial):
            if pm.stage_i >= n_stages:
                matches.append(pm.events)
                return
            key = (pm.stage_i, pm.count, pm.events, pm.greedy_from)
            if key not in seen:
                seen.add(key)
                new_partials.append(pm)

        def take(pm: _Partial, i: int):
            st = self.stages[i]
            first = pm.first_ts if pm.first_ts != LONG_MIN else ts
            taken = pm.events + ((i, event_id),)
            c = pm.count + 1
            if st.times_max is None or c < st.times_max:
                add(_Partial(i, c, taken, first))       # stay in looping stage
            if c >= st.times_min:
                add(_Partial(i + 1, 0, taken, first,    # stage satisfied
                             i if st.greedy else -1))

        def feed(pm: _Partial, i: int) -> bool:
            """Match the event against stage i (skipping through optionals)."""
            st = self.stages[i]
            if st.negated:
                return False  # negated stages are driven by the main loop
            if stage_bits[i]:
                if i == pm.stage_i and until_bits is not None \
                        and until_bits[i]:
                    return False  # until: the loop is closed to this event
                cnt = pm.count if i == pm.stage_i else 0
                take(_Partial(i, cnt, pm.events, pm.first_ts,
                              pm.greedy_from), i)
                return True
            took_nothing = pm.count == 0 or i != pm.stage_i
            if st.optional and took_nothing and i + 1 < n_stages:
                return feed(pm, i + 1)
            return False

        for pm in self.partials:
            if self._expired(pm, ts):
                continue  # within window exceeded: prune
            if pm.greedy_from >= 0 and stage_bits[pm.greedy_from] \
                    and not (until_bits is not None
                             and until_bits[pm.greedy_from]):
                # the event extends the greedy loop this partial advanced
                # out of: the loop sibling consumes it and THIS branch is
                # non-maximal — it dies (greedy suppresses the ignore edge).
                # EXCEPT when until() closes the loop on this very event:
                # the loop cannot consume it, so this branch lives on.
                continue
            i = pm.stage_i
            st = self.stages[i]
            if st.negated:
                if stage_bits[i]:
                    continue        # forbidden event arrived: partial dies
                if st.contiguity == "strict":
                    # notNext satisfied by this one clean event; the SAME
                    # event then feeds the following stage
                    adv = _Partial(i + 1, 0, pm.events,
                                   pm.first_ts if pm.first_ts != LONG_MIN
                                   else ts)
                    if i + 1 >= n_stages:
                        add(adv)    # notNext at the end: match completes
                        continue
                    matched = feed(adv, i + 1)
                    nxt = self.stages[i + 1]
                    if matched:
                        if nxt.contiguity == "relaxed_any":
                            add(adv)
                    elif nxt.contiguity in ("relaxed", "relaxed_any"):
                        add(adv)
                    # strict next-stage miss: partial dies
                else:
                    # notFollowedBy: watch for the forbidden event while
                    # offering each event to the FOLLOWING stage; once that
                    # stage matches, the watcher retires (first-match
                    # semantics — staying would turn a plain followedBy
                    # into followedByAny)
                    matched = (feed(pm, i + 1) if i + 1 < n_stages
                               else False)
                    nxt = (self.stages[i + 1] if i + 1 < n_stages else None)
                    if matched:
                        if nxt is not None and nxt.contiguity == "relaxed_any":
                            add(pm)
                    elif nxt is None or nxt.contiguity != "strict":
                        add(pm)     # keep watching (relaxed)
                continue
            # until on a looping stage: the closing event ends the loop
            # permanently — the advanced sibling (created at the last take)
            # carries on; this stay-partial dies without taking
            if until_bits is not None and until_bits[i] and pm.count > 0:
                continue
            matched = feed(pm, i)
            if i == 0 and pm.count == 0:
                add(pm)                 # the start state always persists
            elif matched:
                if st.contiguity == "relaxed_any":
                    add(pm)             # followedByAny: may ignore a match
            elif st.contiguity in ("relaxed", "relaxed_any"):
                add(pm)                 # skip the non-matching event
            # else: strict miss -> partial dies

        if not any(p.stage_i == 0 and p.count == 0 for p in new_partials):
            new_partials.append(_Partial(0, 0, (), LONG_MIN))
        self.partials = new_partials

        if matches and self.pattern.skip_strategy == \
                AfterMatchSkipStrategy.SKIP_PAST_LAST_EVENT:
            self.skip_until_ts = ts
            self.partials = [_Partial(0, 0, (), LONG_MIN)]
        return matches

    def harvest_expired_negations(self, now: int
                                  ) -> List[Tuple[Tuple[Tuple[int, int], ...],
                                                  int]]:
        """A pattern ENDING in ``notFollowedBy`` completes when its
        ``within`` window closes without the forbidden event (the reference
        only allows a trailing notFollowedBy under ``within``).  Returns
        ``(events, completion_ts)`` pairs — the match's event time is the
        WINDOW CLOSE (first_ts + within), not the draining watermark."""
        w = self.pattern.within_ms
        if w is None or not self._trailing_negation:
            return []
        n = len(self.stages)
        out: List[Tuple[Tuple[Tuple[int, int], ...], int]] = []
        keep: List[_Partial] = []
        for pm in self.partials:
            if (pm.stage_i == n - 1 and pm.first_ts != LONG_MIN
                    and now - pm.first_ts > w):
                out.append((pm.events, pm.first_ts + w))
                continue
            keep.append(pm)
        self.partials = keep
        return out


class _RowStore:
    """Columnar event-row store (the lazy half of the ``SharedBuffer``
    analog): ``process_batch`` registers each batch's column arrays once;
    row dicts materialize on demand — only for events referenced by live
    partials or completed matches at emit time.  ``prune`` drops whole
    batches once no referenced event id falls in their range."""

    def __init__(self):
        #: parallel sorted lists: event-id base per batch + (n, columns)
        self._bases: List[int] = []
        self._batches: List[Tuple[int, Dict[str, np.ndarray]]] = []
        #: restored-snapshot rows (already materialized dicts)
        self._extra: Dict[int, dict] = {}

    def add_batch(self, cols: Dict[str, Any], base: int, n: int) -> None:
        if n == 0:
            return
        self._bases.append(base)          # bases are monotone (event ids)
        self._batches.append((n, {k: np.asarray(v)
                                  for k, v in cols.items()}))

    def put_row(self, eid: int, row: dict) -> None:
        self._extra[eid] = row

    def row(self, eid: int) -> dict:
        r = self._extra.get(eid)
        if r is not None:
            return r
        i = bisect.bisect_right(self._bases, eid) - 1
        if i < 0:
            raise KeyError(f"event {eid} not in row store")
        base = self._bases[i]
        n, arrs = self._batches[i]
        if eid >= base + n:
            raise KeyError(f"event {eid} not in row store")
        j = eid - base

        def cell(a):
            x = a[j]
            return x.item() if isinstance(x, np.generic) else x

        return {k: cell(a) for k, a in arrs.items()}

    def prune(self, referenced) -> None:
        """Drop batches with no referenced event and stale restored rows.
        ``referenced``: iterable/array of still-live event ids."""
        ref = np.unique(np.asarray(list(referenced)
                                   if not isinstance(referenced, np.ndarray)
                                   else referenced, np.int64))
        keep_b, keep_bt = [], []
        for base, (n, arrs) in zip(self._bases, self._batches):
            lo = np.searchsorted(ref, base)
            if lo < ref.size and ref[lo] < base + n:
                keep_b.append(base)
                keep_bt.append((n, arrs))
        self._bases, self._batches = keep_b, keep_bt
        if self._extra:
            refset = set(ref.tolist())
            self._extra = {e: r for e, r in self._extra.items()
                           if e in refset}

    def stats(self) -> Dict[str, int]:
        return {"batches": len(self._batches),
                "restored_rows": len(self._extra)}


class _VecState:
    """Array-resident NFA state for ALL keys (the vectorized engine's
    half of ``CepOperator``): ``[K, M]`` planes of (stage, count,
    first_ts, event-ring length, rolling event hash), a ``[K, M, E]``
    bounded event-pointer ring, per-key live count + skip barrier, and the
    key <-> slot mapping.  M/E are sticky pow2 high-waters."""

    def __init__(self, tab, kernel: str, m_cap: int = 4, e_cap: int = 4):
        self.tab = tab
        self.kernel = kernel
        self.m_cap = m_cap
        self.e_cap = e_cap
        self.index = None                  # key index, built on first batch
        self.n_slots = 0
        k0 = 0
        self.st = np.zeros((k0, m_cap), np.int32)
        self.cnt = np.zeros((k0, m_cap), np.int32)
        self.fst = np.full((k0, m_cap), LONG_MIN, np.int64)
        self.eln = np.zeros((k0, m_cap), np.int32)
        self.ev = np.zeros((k0, m_cap, e_cap), np.int64)
        self.evh = np.zeros((k0, m_cap), np.int32)
        self.nlv = np.zeros(k0, np.int32)
        self.skip = np.full(k0, LONG_MIN, np.int64)
        #: slots in first-DRAIN order (the interpreted ``_nfas`` creation
        #: order — final negation harvests emit in this order)
        self.drained_order: List[int] = []
        self.drained = np.zeros(k0, bool)
        self.rank = np.full(k0, -1, np.int32)
        #: pending (buffered, not-yet-drained) events as columnar pieces:
        #: dicts of slot/ts/eid int64 + bits/ubits [n, S] bool
        self.pending: List[Dict[str, np.ndarray]] = []

    # -- key slots -----------------------------------------------------------
    def map_keys(self, keys: np.ndarray) -> np.ndarray:
        from flink_tpu_torch.state.keyindex import make_key_index

        if self.index is None:
            self.index = make_key_index(keys[0])
        slots = np.asarray(self.index.lookup_or_insert(keys), np.int64)
        self.ensure_slots(int(self.index.num_keys))
        return slots

    def slot_keys(self) -> List[Any]:
        """Every slot's key, in slot order."""
        return self.index.reverse_keys()[:self.n_slots].tolist()

    def drained_partials(self) -> List[list]:
        """The ``_Partial`` lists of the drained slots, in first-drain
        order (``decode_partials`` of each)."""
        from flink_tpu_torch.cep.vectorized import decode_partial_lists

        slots = np.asarray(self.drained_order, np.int64)
        return decode_partial_lists(self.st[slots], self.cnt[slots],
                                    self.fst[slots], self.eln[slots],
                                    self.ev[slots], self.nlv[slots])

    def ensure_slots(self, n: int) -> None:
        if n <= self.n_slots:
            return
        cap = max(64, self.st.shape[0])
        while cap < n:
            cap *= 2
        if cap > self.st.shape[0]:
            grow = cap - self.st.shape[0]

            def w(a, fill, dtype):
                return np.concatenate(
                    [a, np.full((grow,) + a.shape[1:], fill, dtype)], axis=0)

            self.st = w(self.st, 0, np.int32)
            self.cnt = w(self.cnt, 0, np.int32)
            self.fst = w(self.fst, LONG_MIN, np.int64)
            self.eln = w(self.eln, 0, np.int32)
            self.ev = w(self.ev, 0, np.int64)
            self.evh = w(self.evh, 0, np.int32)
            self.nlv = np.concatenate(
                [self.nlv, np.zeros(grow, np.int32)])
            self.skip = np.concatenate(
                [self.skip, np.full(grow, LONG_MIN, np.int64)])
            self.drained = np.concatenate(
                [self.drained, np.zeros(grow, bool)])
            self.rank = np.concatenate(
                [self.rank, np.full(grow, -1, np.int32)])
        # fresh slots carry one pristine start partial
        self.nlv[self.n_slots:n] = 1
        self.n_slots = n

    def grow_caps(self, m_cap: int, e_cap: int) -> None:
        if m_cap > self.m_cap:
            pad = m_cap - self.m_cap
            K = self.st.shape[0]

            def w(a, fill):
                return np.concatenate(
                    [a, np.full((K, pad) + a.shape[2:], fill, a.dtype)],
                    axis=1)

            self.st, self.cnt = w(self.st, 0), w(self.cnt, 0)
            self.fst = w(self.fst, LONG_MIN)
            self.eln, self.evh = w(self.eln, 0), w(self.evh, 0)
            self.ev = w(self.ev, 0)
            self.m_cap = m_cap
        if e_cap > self.e_cap:
            K, M = self.ev.shape[:2]
            wide = np.zeros((K, M, e_cap), np.int64)
            wide[:, :, :self.e_cap] = self.ev
            self.ev = wide
            self.e_cap = e_cap

    # -- drain helpers -------------------------------------------------------
    def consolidate(self) -> Optional[Dict[str, np.ndarray]]:
        if not self.pending:
            return None
        if len(self.pending) == 1:
            out = self.pending[0]
        else:
            out = {k: np.concatenate([p[k] for p in self.pending])
                   for k in self.pending[0]}
        self.pending = []
        return out

    def gather(self, slots: np.ndarray, m_cap: int, e_cap: int):
        """Copy the rows for ``slots`` into a compact block at the
        requested caps (the transactional unit the kernel advances).
        Narrower-than-storage caps are fine when the rows fit — callers
        size them from the rows' own nlv/eln high-water, so only dead
        (pristine) columns are dropped."""
        kc = slots.size
        wm = min(m_cap, self.st.shape[1])

        def g2(a, fill, dtype):
            out = np.full((kc, m_cap), fill, dtype)
            out[:, :wm] = a[slots][:, :wm]
            return out

        we = min(e_cap, self.ev.shape[2])
        ev = np.zeros((kc, m_cap, e_cap), np.int64)
        ev[:, :wm, :we] = self.ev[slots][:, :wm, :we]
        return (g2(self.st, 0, np.int32), g2(self.cnt, 0, np.int32),
                g2(self.fst, LONG_MIN, np.int64), g2(self.eln, 0, np.int32),
                ev, g2(self.evh, 0, np.int32),
                self.nlv[slots].copy(), self.skip[slots].copy())

    def adopt(self, chunks, m_cap: int, e_cap: int) -> None:
        """Commit the advanced blocks (after the whole drain's compute
        succeeded — a quarantined dispatch leaves the state untouched)."""
        self.grow_caps(m_cap, e_cap)
        for slots, block in chunks:
            if (block[4].shape[1] < self.m_cap
                    or block[4].shape[2] < self.e_cap):
                block = _grow_block(block, self.m_cap, self.e_cap)
            st, cnt, fst, eln, ev, evh, nlv, skip = block
            self.st[slots] = st
            self.cnt[slots] = cnt
            self.fst[slots] = fst
            self.eln[slots] = eln
            self.ev[slots] = ev
            self.evh[slots] = evh
            self.nlv[slots] = nlv
            self.skip[slots] = skip

    def mark_drained(self, slots: np.ndarray) -> None:
        newly = slots[~self.drained[slots]]
        if newly.size:
            self.drained[newly] = True
            base = len(self.drained_order)
            self.rank[newly] = base + np.arange(newly.size, dtype=np.int32)
            self.drained_order.extend(int(s) for s in newly)

    def referenced_event_ids(self) -> np.ndarray:
        """Event ids referenced by any live partial (for row pruning)."""
        from flink_tpu_torch.cep.vectorized import _PACK_MASK

        rows = np.flatnonzero((self.nlv > 0)
                              & (self.eln.max(axis=1, initial=0) > 0))
        if rows.size == 0:
            return np.empty(0, np.int64)
        ev = self.ev[rows]
        eln = self.eln[rows]
        mask = (np.arange(ev.shape[2])[None, None, :]
                < eln[:, :, None])
        return np.unique(ev[mask] & np.int64(_PACK_MASK))

    def total_partials(self) -> int:
        if self.n_slots == 0:
            return 0
        return int(self.nlv[:self.n_slots][
            self.drained[:self.n_slots]].sum())


class CepOperator(StreamOperator):
    """Keyed CEP: buffer events to watermark, run per-key NFAs, emit matches.

    ``select_fn(match: Dict[stage_name, List[row_dict]]) -> row_dict``
    (``PatternSelectFunction`` analog).

    ``vectorized``: ``"auto"`` (default — eligible patterns use the batched
    engine when the process-wide calibration, measured on ``device``, says
    it wins there, like ``--device-probe``), ``"on"`` (force; raises on
    ineligible patterns), ``"off"`` (interpreted NFA).  Both engines are
    bit-identical on eligible patterns — same matches, same order, same
    snapshots.

    ``device``: where the batched engine's step runs (``vectorized.
    default_kernel``: the torch step on ``cuda``, the numpy step on the CPU
    unless ``FLINK_TPU_CEP_KERNEL`` says otherwise).  ``None`` is the card
    and raises when none is visible; tests pass ``"cpu"``.
    """

    def __init__(self, pattern: Pattern, key_column: str,
                 select_fn: Callable[[Dict[str, List[dict]]], dict],
                 name: str = "cep",
                 defer_conditions: bool = False,
                 prev_columns: Optional[List[str]] = None,
                 leftmost_order_column: Optional[str] = None,
                 vectorized: str = "auto",
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        last = pattern.stages[-1]
        if last.negated and last.contiguity != "strict" \
                and pattern.within_ms is None:
            # the reference's rule: NotFollowedBy can't end a pattern
            # without a within window (the match could never complete)
            raise ValueError("notFollowedBy cannot be the last pattern "
                             "stage without within()")
        if vectorized not in ("auto", "on", "off"):
            raise ValueError(f"vectorized must be auto|on|off, "
                             f"got {vectorized!r}")
        self.pattern = pattern
        self.key_column = key_column
        self.select_fn = select_fn
        self.name = name
        #: evaluate conditions at DRAIN time, per key over event-time-sorted
        #: rows, instead of at arrival — required when conditions reference
        #: order-dependent derived columns (MATCH_RECOGNIZE ``PREV(col)``:
        #: ``__prev_<col>`` = the previous row of the same key in rowtime
        #: order, which arrival order cannot provide)
        self.defer_conditions = defer_conditions or bool(prev_columns)
        self.prev_columns = list(prev_columns or [])
        #: MATCH_RECOGNIZE determinism: when several branches complete on
        #: the same event under SKIP PAST LAST ROW, SQL row-pattern
        #: matching emits only the match attempt with the EARLIEST start
        #: row (``SqlMatchRecognize`` leftmost semantics); CEP emits all.
        #: Names the rowtime column used to order starts.
        self.leftmost_order_column = leftmost_order_column
        self.vectorized = vectorized
        self._nfas: Dict[Any, NFA] = {}
        #: per key: list of (ts, event_id, stage_bits, until_bits|None) —
        #: rows live in the columnar ``_RowStore``, not here
        self._buffers: Dict[Any, List] = {}
        #: per key: last drained row (PREV continuity across drains)
        self._last_row: Dict[Any, dict] = {}
        self._next_event_id = 0
        self.watermark = LONG_MIN
        self._rowstore = _RowStore()
        self._engine: Optional[str] = None
        self._engine_reasons: List[str] = []
        self._vec: Optional[_VecState] = None
        self._stats = {"matches": 0, "partials_high_water": 0,
                       "vectorized_drains": 0, "interpreted_drains": 0,
                       "degraded": 0}
        self._partials_total = 0          # interpreted engine's live count
        #: the batched engine's step counters, committed per drain:
        #: ``steps`` run, steps ``replayed`` on the host step after a flag,
        #: bytes moved to and from the device by the device step
        self.step_stats = {"steps": 0, "replayed": 0, "h2d_bytes": 0,
                           "d2h_bytes": 0}
        if vectorized == "on":
            ok, reasons = self._classify()
            if not ok:
                raise ValueError(
                    "vectorized='on' but the pattern is not eligible for "
                    "the batched kernel: " + "; ".join(reasons))

    # -- engine resolution ---------------------------------------------------
    def _classify(self) -> Tuple[bool, List[str]]:
        from flink_tpu_torch.cep.vectorized import classify_pattern

        ok, reasons = classify_pattern(self.pattern)
        if self.defer_conditions:
            ok = False
            reasons.append("drain-time (deferred/PREV) condition evaluation")
        if self.leftmost_order_column is not None:
            ok = False
            reasons.append("leftmost-match pruning (MATCH_RECOGNIZE "
                           "SKIP PAST LAST ROW)")
        return ok, reasons

    def _resolve_engine(self) -> None:
        if self._engine is not None:
            return
        from flink_tpu_torch.cep import vectorized as V

        ok, reasons = self._classify()
        if self.vectorized == "off":
            self._engine = "interpreted"
            self._engine_reasons = ["vectorized='off'"]
        elif self.vectorized == "on":
            if not ok:
                raise ValueError("vectorized='on' but the pattern is not "
                                 "eligible: " + "; ".join(reasons))
            self._engine = "vectorized"
        else:
            if ok and V.calibrated_vectorized_cep(self.device):
                self._engine = "vectorized"
            else:
                self._engine = "interpreted"
                if ok:
                    reasons = ["calibration picked the interpreted NFA on "
                               "this backend"]
                self._engine_reasons = reasons
        if self._engine == "vectorized":
            self._vec = _VecState(V.compile_pattern(self.pattern),
                                  V.default_kernel(self.device))

    def cep_stats(self) -> Dict[str, Any]:
        """Monitoring-grade counters: engine, matches emitted, the
        partial-match high-water mark, drain counts per engine, and
        mid-job degradations (quarantine fallbacks).  Never blocks: an
        auto-mode operator that has not processed a batch yet reports
        ``engine="unresolved"`` instead of running the calibration A/B on
        the stats path."""
        out = dict(self._stats)
        out["engine"] = self._engine or "unresolved"
        out["fallback_reasons"] = list(self._engine_reasons)
        out.update(self._rowstore.stats())
        return out

    # -- ingestion -----------------------------------------------------------
    def process_batch(self, batch: RecordBatch) -> List[StreamElement]:
        if len(batch) == 0:
            return []
        self._resolve_engine()
        cols = batch.columns
        if self.defer_conditions:
            bits = ubits = None
        else:
            # vectorized: all stage (and until) conditions over the batch —
            # these [B, S] planes are the kernel's condition inputs
            bits = np.stack([s.matches(cols) for s in self.pattern.stages],
                            axis=1)
            ubits = (np.stack([s.until_matches(cols)
                               for s in self.pattern.stages], axis=1)
                     if any(s.until is not None for s in self.pattern.stages)
                     else None)
        ts = (np.asarray(batch.timestamps, np.int64)
              if batch.timestamps is not None
              else np.arange(len(batch), dtype=np.int64) + self._next_event_id)
        base = self._next_event_id
        self._next_event_id += len(batch)
        self._rowstore.add_batch(cols, base, len(batch))
        keys = np.asarray(cols[self.key_column])
        if self._engine == "vectorized":
            slots = self._vec.map_keys(keys)
            piece = {"slot": slots,
                     "ts": ts.astype(np.int64),
                     "eid": base + np.arange(len(batch), dtype=np.int64),
                     "bits": bits,
                     "ubits": (ubits if ubits is not None
                               else np.zeros_like(bits))}
            self._vec.pending.append(piece)
        else:
            for i in range(len(batch)):
                k = (keys[i].item() if isinstance(keys[i], np.generic)
                     else keys[i])
                self._buffers.setdefault(k, []).append(
                    (int(ts[i]), base + i,
                     None if bits is None else bits[i],
                     None if ubits is None else ubits[i]))
        if batch.timestamps is None:
            # processing-time style: no watermarks will come, match eagerly
            return self._drain(2 ** 62)
        return []

    def process_watermark(self, watermark: Watermark) -> List[StreamElement]:
        self.watermark = max(self.watermark, watermark.timestamp)
        return self._drain(self.watermark)

    def end_input(self) -> List[StreamElement]:
        return self._drain(2 ** 62)

    # -- shared emission helpers ---------------------------------------------
    def _row(self, eid: int) -> dict:
        return self._rowstore.row(eid)

    def _emit_match(self, events, mts: int, out_rows, out_ts) -> None:
        self._stats["matches"] += 1
        named: Dict[str, List[dict]] = {}
        for stage_i, ev_id in events:
            named.setdefault(self.pattern.stages[stage_i].name,
                             []).append(self._row(ev_id))
        res = self.select_fn(named)
        if res is not None:
            out_rows.append(res)
            out_ts.append(mts)

    def _emit_batch(self, out_rows, out_ts) -> List[StreamElement]:
        if not out_rows:
            return []
        cols = {c: np.asarray([r[c] for r in out_rows])
                for c in out_rows[0]}
        return [RecordBatch(cols, timestamps=np.asarray(out_ts, np.int64))]

    def _prune_rows_interpreted(self) -> None:
        referenced = {ev for nfa in self._nfas.values()
                      for pm in nfa.partials for _s, ev in pm.events}
        for buf in self._buffers.values():
            referenced.update(e[1] for e in buf)
        self._rowstore.prune(np.fromiter(referenced, np.int64,
                                         count=len(referenced)))

    # -- drain dispatch ------------------------------------------------------
    def _drain(self, up_to_ts: int) -> List[StreamElement]:
        self._resolve_engine()
        if self._engine == "vectorized":
            from flink_tpu_torch.runtime import device_health
            mon = device_health.get_monitor(create=False)
            if mon is not None and mon.quarantined:
                self._degrade_to_interpreted("device quarantined")
                return self._drain_interpreted(up_to_ts)
            try:
                with tracing.span("cep.vectorized_drain", cat="cep",
                                  up_to_ts=int(up_to_ts)):
                    return self._drain_vectorized(up_to_ts)
            except device_health.DeviceQuarantinedError:
                self._degrade_to_interpreted(
                    "vectorized drain dispatch quarantined")
                return self._drain_interpreted(up_to_ts)
        return self._drain_interpreted(up_to_ts)

    # -- interpreted drain ---------------------------------------------------
    def _drain_interpreted(self, up_to_ts: int) -> List[StreamElement]:
        out_rows: List[dict] = []
        out_ts: List[int] = []

        for k, buf in self._buffers.items():
            ready = [e for e in buf if e[0] <= up_to_ts]
            if not ready:
                continue
            self._buffers[k] = [e for e in buf if e[0] > up_to_ts]
            ready.sort(key=lambda e: (e[0], e[1]))
            if self.defer_conditions:
                ready = self._evaluate_deferred(k, ready)
            nfa = self._nfas.get(k)
            if nfa is None:
                nfa = self._nfas[k] = NFA(self.pattern)
                self._partials_total += len(nfa.partials)
            for ts, eid, bits, ubits in ready:
                # a trailing notFollowedBy completes by TIME, which may
                # happen between events (the within window closing)
                before = len(nfa.partials)
                for match, cts in nfa.harvest_expired_negations(ts):
                    self._emit_match(match, cts, out_rows, out_ts)
                ms = nfa.advance(eid, ts, bits, ubits)
                self._partials_total += len(nfa.partials) - before
                if len(ms) > 1 and self.leftmost_order_column is not None \
                        and self.pattern.skip_strategy == \
                        AfterMatchSkipStrategy.SKIP_PAST_LAST_EVENT:
                    oc = self.leftmost_order_column
                    ms = [min(ms, key=lambda m: (
                        self._row(m[0][1]).get(oc), m[0][1]))]
                for match in ms:
                    self._emit_match(match, ts, out_rows, out_ts)
        # time-driven completions for EVERY key — including quiet ones whose
        # within window the watermark just closed
        for k, nfa in self._nfas.items():
            before = len(nfa.partials)
            for match, cts in nfa.harvest_expired_negations(up_to_ts):
                self._emit_match(match, cts, out_rows, out_ts)
            self._partials_total += len(nfa.partials) - before
        # SharedBuffer-style pruning: event rows only live as long as a
        # partial match (or a buffered event) references them — otherwise
        # host memory (and every checkpoint) grows with events processed
        self._prune_rows_interpreted()
        self._stats["interpreted_drains"] += 1
        self._stats["partials_high_water"] = max(
            self._stats["partials_high_water"], self._partials_total)
        return self._emit_batch(out_rows, out_ts)

    def _evaluate_deferred(self, k, ready):
        """Drain-time condition evaluation over the key's event-time-sorted
        rows: inject ``__prev_<col>`` columns (the previous row's values in
        ROWTIME order, seeded from the last drained row of this key), then
        run every stage condition vectorized over the chunk."""
        rows_ = [self._row(e[1]) for e in ready]
        cols = {c: np.asarray([r.get(c) for r in rows_])
                for c in rows_[0]}
        prev = self._last_row.get(k)
        for c in self.prev_columns:
            vals = []
            p = prev
            for r in rows_:
                vals.append(p.get(c) if p is not None else None)
                p = r
            arr = np.asarray(vals, object)
            try:
                # numeric prevs: None -> NaN so ordering comparisons are
                # well-defined (and False) on the partition's first row
                arr = arr.astype(np.float64)
            except (TypeError, ValueError):
                pass
            cols["__prev_" + c] = arr
        self._last_row[k] = rows_[-1]
        bits = np.stack([s.matches(cols) for s in self.pattern.stages],
                        axis=1)
        ubits = (np.stack([s.until_matches(cols)
                           for s in self.pattern.stages], axis=1)
                 if any(s.until is not None for s in self.pattern.stages)
                 else None)
        return [(ts, eid, bits[i], None if ubits is None else ubits[i])
                for i, (ts, eid, _b, _u) in enumerate(ready)]

    # -- vectorized drain ----------------------------------------------------
    def _drain_vectorized(self, up_to_ts: int) -> List[StreamElement]:
        from flink_tpu_torch.runtime import device_health

        vec = self._vec
        pend = vec.consolidate()
        sect0: List[Tuple[tuple, tuple, int]] = []
        if pend is not None:
            ready_m = pend["ts"] <= up_to_ts
            if not ready_m.all():
                keep = ~ready_m
                vec.pending = [{k: v[keep] for k, v in pend.items()}]
            if ready_m.any():
                r = {k: v[ready_m] for k, v in pend.items()}
                order = np.lexsort((r["eid"], r["ts"], r["slot"]))
                r = {k: v[order] for k, v in r.items()}
                uniq, offsets, counts = np.unique(
                    r["slot"], return_index=True, return_counts=True)
                pos = (np.arange(r["ts"].size)
                       - np.repeat(offsets, counts))
                krow = np.repeat(np.arange(uniq.size), counts)
                # regroup keys by (partial-width bucket, ASCENDING event
                # count): chunks never span width buckets, so the kernel
                # runs each chunk at the narrow width ITS rows need (one
                # hot key with many partials must not widen everyone), and
                # within a bucket it steps only the suffix of keys still
                # holding an event at step t — total work tracks
                # sum(events), not keys x T_max.  Match ORDER is
                # unaffected: every match carries its original
                # (buffer-order, step) sort key.
                nl = np.maximum(vec.nlv[uniq], 1)
                wb = np.int64(1) << (
                    np.ceil(np.log2(np.maximum(nl, 4))).astype(np.int64))
                ksort = np.lexsort((counts, wb))
                inv = np.empty_like(ksort)
                inv[ksort] = np.arange(ksort.size)
                sc = counts[ksort]
                new_off = np.zeros(ksort.size, np.int64)
                np.cumsum(sc[:-1], out=new_off[1:])
                dest = new_off[inv[krow]] + pos
                r2 = {}
                for k, v in r.items():
                    out = np.empty_like(v)
                    out[dest] = v
                    r2[k] = out
                krow2 = np.empty(krow.size, np.int64)
                krow2[dest] = inv[krow]
                pos2 = np.empty_like(pos)
                pos2[dest] = pos
                wbs = wb[ksort]
                bounds = np.flatnonzero(
                    np.concatenate([[True], wbs[1:] != wbs[:-1]]))
                bounds = np.append(bounds, wbs.size)
                # ONE guarded dispatch per drain: the whole step loop is a
                # pure function of gathered copies — a watchdog-abandoned
                # (wedged) dispatch commits nothing; the ready events go
                # back to pending so the degrade path re-drains the
                # identical stream interpreted.  The thunk runs on the
                # monitor's lane thread, under the operator's card.
                def thunk():
                    with self._on_card():
                        return self._vec_compute(
                            vec, r2, uniq[ksort], sc, pos2, krow2, ksort,
                            bounds)

                try:
                    chunks, sect0, m_cap, e_cap, counters = \
                        device_health.guarded_dispatch(
                            thunk, label="cep.vectorized_drain")
                except BaseException:
                    vec.pending.append(r)
                    raise
                vec.adopt(chunks, m_cap, e_cap)
                vec.mark_drained(uniq)
                for k, v in counters.items():
                    self.step_stats[k] += v
        out_rows: List[dict] = []
        out_ts: List[int] = []
        sect0.sort(key=lambda m: m[0])
        for _o, events, mts in sect0:
            self._emit_match(events, mts, out_rows, out_ts)
        for events, mts in self._vec_harvest_all(up_to_ts):
            self._emit_match(events, mts, out_rows, out_ts)
        self._stats["vectorized_drains"] += 1
        self._stats["partials_high_water"] = max(
            self._stats["partials_high_water"], vec.total_partials())
        self._prune_rows_vectorized()
        return self._emit_batch(out_rows, out_ts)

    def _on_card(self):
        return (torch.cuda.device(self.device)
                if self.device.type == "cuda" else contextlib.nullcontext())

    def _vec_compute(self, vec, r, uniq, counts, pos, krow, korder, bounds):
        """The drain's pure compute: advance every ready key's partials
        through its event steps, chunked over keys.  Keys arrive sorted by
        (partial-width bucket, ascending event count); ``korder[p]`` = the
        key's original buffer-order rank, the match sort key.  Chunks stay
        inside one width bucket (``bounds``) so each runs at the narrow
        partial capacity its own rows need, and the numpy step steps only
        the suffix of keys that still hold an event at step t (the device
        step runs the whole chunk at every step, at one shape, as JAX's
        jitted step does).  Returns the advanced blocks + matches + grown
        caps + the step counters; commits NOTHING (transactional — see the
        guarded dispatch above).  ``vec`` is the state captured at
        dispatch: a late, abandoned attempt reads it and writes nothing."""
        from flink_tpu_torch.cep import vectorized as V

        tab = vec.tab
        S = tab.n_stages
        m_cap, e_cap = vec.m_cap, vec.e_cap
        chunk = 65536
        counters = {"steps": 0, "replayed": 0, "h2d_bytes": 0,
                    "d2h_bytes": 0}
        if vec.kernel == "device":
            # the table goes up once a drain, not once a step
            planes = V.table_planes(tab, self.device)
            counters["h2d_bytes"] += V.table_bytes(tab)

            def step(tab_, m, block_, inputs_):
                return V.step_device(tab_, m, block_, inputs_, self.device,
                                     counters, planes)
        else:
            step = V.step_numpy
        suffix = vec.kernel != "device"   # the device step keeps one shape
        sect0: List[Tuple[tuple, tuple, int]] = []
        chunks = []
        spans = [(int(lo2), min(int(lo2) + chunk, int(bhi)))
                 for blo, bhi in zip(bounds[:-1], bounds[1:])
                 for lo2 in range(int(blo), int(bhi), chunk)]
        for lo, hi in spans:
            kc = hi - lo
            sel = (krow >= lo) & (krow < hi)
            ek = (krow[sel] - lo).astype(np.int64)
            ep = pos[sel].astype(np.int64)
            cchunk = counts[lo:hi]
            Tc = int(cchunk.max())
            ets = np.zeros((kc, Tc), np.int64)
            eid = np.zeros((kc, Tc), np.int64)
            val = np.zeros((kc, Tc), bool)
            bit = np.zeros((kc, Tc, S), bool)
            ubi = np.zeros((kc, Tc, S), bool)
            ets[ek, ep] = r["ts"][sel]
            eid[ek, ep] = r["eid"][sel]
            val[ek, ep] = True
            bit[ek, ep] = r["bits"][sel]
            ubi[ek, ep] = r["ubits"][sel]
            # chunk-local widths: exactly what THIS bucket's rows need
            slots = uniq[lo:hi]
            m_loc = _pow2_at_least(int(vec.nlv[slots].max(initial=1)), 4)
            e_loc = _pow2_at_least(
                int(vec.eln[slots].max(initial=0)) + 1, 4)
            block = vec.gather(slots, m_loc, e_loc)
            for t in range(Tc):
                # counts ascend within the chunk: keys with an event at
                # step t are exactly the suffix [s0:]
                s0 = int(np.searchsorted(cchunk, t, side="right")) \
                    if suffix else 0
                part = tuple(a[s0:] for a in block)
                if tab.trailing_negation:
                    part, harvested = _harvest_block(
                        tab, part, val[s0:, t], ets[s0:, t])
                    for i, (k, m, events, cts) in enumerate(harvested):
                        sect0.append(
                            ((korder[lo + s0 + k], t, 0, i), events, cts))
                inputs = (val[s0:, t], ets[s0:, t], eid[s0:, t],
                          bit[s0:, t, :], ubi[s0:, t, :])
                res, m_new = step(tab, m_loc, part, inputs)
                counters["steps"] += 1
                part = res.block
                m_grew = max(m_new, part[0].shape[1])
                e_grew = part[4].shape[2]
                if m_grew > m_loc or e_grew > e_loc:
                    m_loc = max(m_loc, m_grew)
                    e_loc = max(e_loc, e_grew)
                    block = _grow_block(block, m_loc, e_loc)
                    part = _grow_block(part, m_loc, e_loc)
                if s0:
                    block = tuple(np.concatenate([full[:s0], new])
                                  for full, new in zip(block, part))
                else:
                    block = part
                for i in range(res.match_kc.shape[0]):
                    k, _c = res.match_kc[i]
                    sect0.append(
                        ((korder[lo + s0 + int(k)], t, 1, i),
                         V.unpack_events(res.match_ev[i]),
                         int(ets[s0 + int(k), t])))
            chunks.append((slots, block))
            m_cap = max(m_cap, m_loc)
            e_cap = max(e_cap, e_loc)
        return chunks, sect0, m_cap, e_cap, counters

    def _vec_harvest_all(self, now: int):
        """Drain-end trailing-negation harvest over every drained key, in
        first-drain order (the interpreted engine's second ``_nfas``
        loop)."""
        from flink_tpu_torch.cep.vectorized import unpack_events

        vec = self._vec
        tab = vec.tab
        if not tab.trailing_negation or not vec.drained_order:
            return []
        n = vec.n_slots
        live = (np.arange(vec.m_cap)[None, :] < vec.nlv[:n, None])
        fst = vec.fst[:n]
        safe = np.where(fst == LONG_MIN, now, fst)
        mask = (live & vec.drained[:n, None]
                & (vec.st[:n] == tab.n_stages - 1)
                & (fst != LONG_MIN) & (now - safe > tab.within))
        if not mask.any():
            return []
        hits = np.argwhere(mask)
        hits = hits[np.lexsort((hits[:, 1], vec.rank[hits[:, 0]]))]
        out = []
        for k, m in hits:
            eln = int(vec.eln[k, m])
            out.append((unpack_events(vec.ev[k, m, :eln]),
                        int(vec.fst[k, m] + tab.within)))
        # remove the harvested partials (stable compaction of the rest)
        rows = np.unique(hits[:, 0])
        keep = live[rows] & ~mask[rows]
        order = np.argsort(~keep, axis=1, kind="stable")
        for name in ("st", "cnt", "fst", "eln", "evh"):
            a = getattr(vec, name)
            a[rows] = np.take_along_axis(a[rows], order, axis=1)
        vec.ev[rows] = np.take_along_axis(vec.ev[rows],
                                          order[:, :, None], axis=1)
        vec.nlv[rows] = keep.sum(axis=1).astype(np.int32)
        dead = (np.arange(vec.m_cap)[None, :] >= vec.nlv[rows, None])
        vec.st[rows] = np.where(dead, 0, vec.st[rows])
        vec.cnt[rows] = np.where(dead, 0, vec.cnt[rows])
        vec.fst[rows] = np.where(dead, LONG_MIN, vec.fst[rows])
        vec.eln[rows] = np.where(dead, 0, vec.eln[rows])
        vec.evh[rows] = np.where(dead, 0, vec.evh[rows])
        vec.ev[rows] = np.where(dead[:, :, None], 0, vec.ev[rows])
        return out

    def _prune_rows_vectorized(self) -> None:
        vec = self._vec
        parts = [vec.referenced_event_ids()]
        for p in vec.pending:
            parts.append(np.asarray(p["eid"], np.int64))
        self._rowstore.prune(np.concatenate(parts)
                             if parts else np.empty(0, np.int64))

    # -- degrade to the interpreted engine (quarantine fallback) -------------
    def _degrade_to_interpreted(self, reason: str) -> None:
        """Mid-job fallback: decode the array state into per-key NFAs and
        per-key buffers, then continue interpreted — digest-identical (the
        two engines share one logical state)."""
        vec = self._vec
        self._buffers = {}
        self._nfas = {}
        self._partials_total = 0
        if vec is not None and vec.index is not None:
            # buffer dict insertion order = first-arrival order = slot id
            keys = vec.slot_keys()
            self._buffers = {k: [] for k in keys}
            pend = vec.consolidate()
            if pend is not None:
                order = np.lexsort((pend["eid"], pend["slot"]))
                for i in order:
                    slot = int(pend["slot"][i])
                    self._buffers[keys[slot]].append(
                        (int(pend["ts"][i]), int(pend["eid"][i]),
                         pend["bits"][i],
                         pend["ubits"][i] if vec.tab.has_until else None))
            skips = vec.skip[vec.drained_order].tolist()
            for slot, partials, skip_ts in zip(vec.drained_order,
                                               vec.drained_partials(), skips):
                nfa = NFA(self.pattern)
                nfa.partials = partials
                nfa.skip_until_ts = skip_ts
                self._nfas[keys[slot]] = nfa
                self._partials_total += len(nfa.partials)
        self._vec = None
        self._engine = "interpreted"
        self._engine_reasons = [f"degraded mid-job: {reason}"]
        self._stats["degraded"] += 1

    # -- checkpointing -------------------------------------------------------
    def snapshot_state(self) -> Dict[str, Any]:
        """One snapshot format for BOTH engines (the interpreted layout —
        buffers carry materialized rows, NFAs carry partial lists), so
        checkpoints restore across engine choices and mid-job degradations
        never strand a savepoint."""
        self._resolve_engine()
        if self._engine == "vectorized":
            buffers, nfas = self._vec_snapshot_views()
        else:
            buffers = {k: [(ts, eid, bits, ubits, self._row(eid))
                           for ts, eid, bits, ubits in v]
                       for k, v in self._buffers.items()}
            nfas = {}
            for k, n in self._nfas.items():
                referenced = {ev for pm in n.partials
                              for _s, ev in pm.events}
                nfas[k] = (n.partials, n.skip_until_ts,
                           {e: self._row(e) for e in sorted(referenced)})
        return {
            "buffers": buffers,
            "nfas": nfas,
            "last_rows": dict(self._last_row),
            "next_event_id": self._next_event_id,
            "watermark": self.watermark,
        }

    def _vec_snapshot_views(self):
        vec = self._vec
        buffers: Dict[Any, list] = {}
        keys = vec.slot_keys() if vec.index is not None else []
        if vec.index is not None:
            buffers = {k: [] for k in keys}
            pend = vec.consolidate()
            if pend is not None:
                vec.pending = [pend]         # snapshot must not consume
                order = np.lexsort((pend["eid"], pend["slot"]))
                for i in order:
                    slot = int(pend["slot"][i])
                    eid = int(pend["eid"][i])
                    buffers[keys[slot]].append(
                        (int(pend["ts"][i]), eid, pend["bits"][i],
                         pend["ubits"][i] if vec.tab.has_until else None,
                         self._row(eid)))
        nfas: Dict[Any, tuple] = {}
        skips = vec.skip[vec.drained_order].tolist()
        for slot, partials, skip_ts in zip(vec.drained_order,
                                           vec.drained_partials(), skips):
            referenced = sorted({ev for pm in partials
                                 for _s, ev in pm.events})
            nfas[keys[slot]] = (partials, skip_ts,
                                {e: self._row(e) for e in referenced})
        return buffers, nfas

    def restore_state(self, snap: Dict[str, Any]) -> None:
        self._engine = None
        self._resolve_engine()
        self._rowstore = _RowStore()
        self._buffers = {}
        self._nfas = {}
        self._partials_total = 0
        for k, (partials, skip_ts, rows) in snap["nfas"].items():
            for e, row in rows.items():
                self._rowstore.put_row(e, row)
        if self._engine == "vectorized":
            self._vec_restore(snap)
        else:
            for k, v in snap["buffers"].items():
                entries = []
                for e in v:
                    # 5-tuple (with row) is the on-disk format; rows go to
                    # the columnar store, buffers stay slim
                    ts, eid, bits, ubits = e[0], e[1], e[2], e[3]
                    if len(e) > 4:
                        self._rowstore.put_row(eid, e[4])
                    entries.append((ts, eid, bits, ubits))
                self._buffers[k] = entries
            for k, (partials, skip_ts, _rows) in snap["nfas"].items():
                # the snapshot's rows already went into the row store's
                # restored-row map above — duplicating them on the NFA
                # would hold every row dict twice for the operator's life
                nfa = NFA(self.pattern)
                nfa.partials = list(partials)
                nfa.skip_until_ts = skip_ts
                self._nfas[k] = nfa
                self._partials_total += len(nfa.partials)
        self._last_row = dict(snap.get("last_rows", {}))
        self._next_event_id = snap["next_event_id"]
        self.watermark = snap["watermark"]

    # -- rescale -------------------------------------------------------------
    @staticmethod
    def split_snapshot(snap: Dict[str, Any], max_parallelism: int,
                       new_parallelism: int) -> List[Dict[str, Any]]:
        """One CEP snapshot -> ``new_parallelism`` snapshots, per-key
        entries (event buffers, NFA partials, PREV rows) routed by the
        key's key group — the same assignment the record router uses, so
        a key's partial matches land exactly where its future events will
        (scenarios rescale CEP jobs mid-stream).  Event ids stay
        as-is: each part keeps a disjoint key subset and every key's
        events came from this one operator, so ids stay unique per part;
        ``next_event_id``/``watermark`` ride to every part."""
        from flink_tpu_torch.core import keygroups

        keys: List[Any] = list(snap.get("buffers", {}))
        known = set(keys)
        for src in (snap.get("nfas", {}), snap.get("last_rows", {})):
            for k in src:
                if k not in known:
                    known.add(k)
                    keys.append(k)
        if keys:
            karr = np.asarray(keys)
            if karr.dtype.kind not in "iu":
                karr = np.asarray(keys, object)
            owner = keygroups.route_raw_keys(karr, new_parallelism,
                                             max_parallelism)
        else:
            owner = np.zeros(0, np.int32)
        own_of = {k: int(owner[i]) for i, k in enumerate(keys)}
        out = []
        for p in range(new_parallelism):
            out.append({
                # preserve dict order: buffer order IS the vectorized
                # engine's slot (first-arrival) order
                "buffers": {k: v for k, v in snap.get("buffers", {}).items()
                            if own_of[k] == p},
                "nfas": {k: v for k, v in snap.get("nfas", {}).items()
                         if own_of[k] == p},
                "last_rows": {k: v
                              for k, v in snap.get("last_rows", {}).items()
                              if own_of[k] == p},
                "next_event_id": snap.get("next_event_id", 0),
                "watermark": snap.get("watermark", LONG_MIN),
            })
        return out

    @staticmethod
    def merge_snapshots(snaps: List[Dict[str, Any]]) -> Dict[str, Any]:
        """Scale-down merge.  Keys are disjoint across parts (keyed
        state), but event ids are NOT — each part numbered its events
        independently, and the restore funnels every part's rows into ONE
        columnar row store keyed by event id, where a collision would
        silently alias two different events' rows.  Remap every event id
        to ``eid * n_parts + part_index`` (disjoint ranges; within-part
        order preserved, and all of one key's events come from one part,
        so per-key event order is untouched).  The merged watermark takes
        MIN — under an unaligned cut the parts sit at different
        watermarks, and the behind part's in-flight elements replay with
        their own watermark progression (the ordering contract), so
        the lower bound is the safe restart point (the ahead part's
        already-drained keys hold post-drain state: nothing re-emits)."""
        import dataclasses

        live = [s for s in snaps if isinstance(s, dict) and s]
        if not live:
            return dict(snaps[0]) if snaps else {}
        P = max(1, len(snaps))

        def remap(eid: int, part: int) -> int:
            return int(eid) * P + part

        buffers: Dict[Any, list] = {}
        nfas: Dict[Any, tuple] = {}
        last_rows: Dict[Any, dict] = {}
        next_eid = 0
        wms = []
        for part, s in enumerate(snaps):
            if not isinstance(s, dict) or not s:
                continue
            for k, entries in s.get("buffers", {}).items():
                buffers[k] = [
                    (e[0], remap(e[1], part)) + tuple(e[2:])
                    for e in entries]
            for k, (partials, skip_ts, rows) in s.get("nfas", {}).items():
                nfas[k] = (
                    [dataclasses.replace(
                        pm, events=tuple((st, remap(e, part))
                                         for st, e in pm.events))
                     for pm in partials],
                    skip_ts,
                    {remap(e, part): r for e, r in rows.items()})
            last_rows.update(s.get("last_rows", {}))
            next_eid = max(next_eid,
                           remap(int(s.get("next_event_id", 0)), part) + 1)
            wms.append(int(s.get("watermark", LONG_MIN)))
        return {"buffers": buffers, "nfas": nfas, "last_rows": last_rows,
                "next_event_id": next_eid,
                "watermark": min(wms) if wms else LONG_MIN}

    def _vec_restore(self, snap: Dict[str, Any]) -> None:
        from flink_tpu_torch.cep import vectorized as V

        self._vec = _VecState(V.compile_pattern(self.pattern),
                              V.default_kernel(self.device))
        vec = self._vec
        # slot order: buffers dict order IS the original first-arrival
        # order; any nfa-only keys (none in practice) follow
        keys = list(snap["buffers"].keys())
        known = set(keys)
        keys += [k for k in snap["nfas"] if k not in known]
        if not keys:
            return
        karr = np.asarray(keys)
        if karr.dtype.kind not in "iu":
            karr = np.asarray(keys, object)
        vec.map_keys(karr)
        slot_of = {k: i for i, k in enumerate(keys)}
        pieces = {"slot": [], "ts": [], "eid": [], "bits": [], "ubits": []}
        S = vec.tab.n_stages
        for k, v in snap["buffers"].items():
            for e in v:
                ts, eid, bits, ubits = e[0], e[1], e[2], e[3]
                if len(e) > 4:
                    self._rowstore.put_row(eid, e[4])
                pieces["slot"].append(slot_of[k])
                pieces["ts"].append(ts)
                pieces["eid"].append(eid)
                pieces["bits"].append(np.asarray(bits, bool))
                pieces["ubits"].append(np.zeros(S, bool) if ubits is None
                                       else np.asarray(ubits, bool))
        if pieces["slot"]:
            vec.pending = [{
                "slot": np.asarray(pieces["slot"], np.int64),
                "ts": np.asarray(pieces["ts"], np.int64),
                "eid": np.asarray(pieces["eid"], np.int64),
                "bits": np.stack(pieces["bits"]),
                "ubits": np.stack(pieces["ubits"]),
            }]
        if not snap["nfas"]:
            return
        # every key's rows at once: the planes ``encode_partials`` gives
        # each key, at the sticky caps the last key would leave
        slots = np.fromiter((slot_of[k] for k in snap["nfas"]), np.int64,
                            count=len(snap["nfas"]))
        entries = list(snap["nfas"].values())
        rows, m_cap, e_cap = V.encode_partial_lists(
            [list(e[0]) for e in entries], vec.m_cap, vec.e_cap)
        vec.grow_caps(m_cap, e_cap)
        st, cnt, fst, eln, ev, evh, nlv = rows
        vec.st[slots], vec.cnt[slots], vec.fst[slots] = st, cnt, fst
        vec.eln[slots], vec.ev[slots], vec.evh[slots] = eln, ev, evh
        vec.nlv[slots] = nlv
        vec.skip[slots] = np.fromiter((int(e[1]) for e in entries), np.int64,
                                      count=len(entries))
        vec.mark_drained(slots)


def _pow2_at_least(n: int, floor: int) -> int:
    out = floor
    while out < n:
        out *= 2
    return out


def _grow_block(block, m_cap: int, e_cap: int):
    """Widen a gathered block to the given sticky caps (both axes)."""
    from flink_tpu_torch.cep.vectorized import grow_partials

    block = grow_partials(block, m_cap)
    st, cnt, fst, eln, ev, evh, nlv, skip = block
    if ev.shape[2] < e_cap:
        wide = np.zeros(ev.shape[:2] + (e_cap,), np.int64)
        wide[:, :, :ev.shape[2]] = ev
        ev = wide
    return (st, cnt, fst, eln, ev, evh, nlv, skip)


def _harvest_block(tab, block, keymask, now):
    """Trailing-negation harvest for a gathered block, BEFORE the event
    advances (the interpreted drain calls ``harvest_expired_negations(ts)``
    per event): emits expired window-close completions in partial-list
    order and compacts them out.  Pure — returns the new block."""
    from flink_tpu_torch.cep.vectorized import unpack_events

    st, cnt, fst, eln, ev, evh, nlv, skip = block
    M = st.shape[1]
    live = np.arange(M)[None, :] < nlv[:, None]
    safe = np.where(fst == LONG_MIN, now[:, None], fst)
    mask = (live & keymask[:, None] & (st == tab.n_stages - 1)
            & (fst != LONG_MIN) & (now[:, None] - safe > tab.within))
    if not mask.any():
        return block, []
    out = []
    for k, m in np.argwhere(mask):
        out.append((int(k), int(m),
                    unpack_events(ev[k, m, :int(eln[k, m])]),
                    int(fst[k, m] + tab.within)))
    keep = live & ~mask
    order = np.argsort(~keep, axis=1, kind="stable")
    t2 = lambda a: np.take_along_axis(a, order, axis=1)  # noqa: E731
    n_nlv = keep.sum(axis=1).astype(np.int32)
    n_st, n_cnt, n_fst = t2(st), t2(cnt), t2(fst)
    n_eln, n_evh = t2(eln), t2(evh)
    n_ev = np.take_along_axis(ev, order[:, :, None], axis=1)
    dead = np.arange(M)[None, :] >= n_nlv[:, None]
    n_st = np.where(dead, 0, n_st)
    n_cnt = np.where(dead, 0, n_cnt)
    n_fst = np.where(dead, LONG_MIN, n_fst)
    n_eln = np.where(dead, 0, n_eln)
    n_evh = np.where(dead, 0, n_evh)
    n_ev = np.where(dead[:, :, None], 0, n_ev)
    return (n_st, n_cnt, n_fst, n_eln, n_ev, n_evh, n_nlv, skip), out



class CEP:
    """Entry point (``CEP.java``): ``CEP.pattern(keyed_stream, pattern)``."""

    @staticmethod
    def pattern(keyed_stream, pattern: Pattern) -> "PatternStream":
        return PatternStream(keyed_stream, pattern)


class PatternStream:
    """``CEP.pattern(...)``: ``select`` appends a :class:`CepOperator` on the
    keyed stream, its batched engine's step on the environment's device."""

    def __init__(self, keyed_stream, pattern: Pattern):
        self.keyed = keyed_stream
        self.pattern = pattern

    def select(self, fn: Callable[[Dict[str, List[dict]]], dict],
               name: str = "cep-select", vectorized: str = "auto"):
        from flink_tpu_torch.datastream.api import DataStream
        key_col = self.keyed.key_column
        pat = self.pattern
        env = self.keyed.env
        t = self.keyed._then(
            name, lambda _v=vectorized: CepOperator(
                pat, key_col, fn, name, vectorized=_v,
                device=env.operator_device()))
        return DataStream(env, t)
