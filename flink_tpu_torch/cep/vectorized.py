"""Vectorized CEP: batched NFA state transitions for ALL keys at once
(port of ``flink_tpu/cep/vectorized.py``).

The interpreted matcher (``cep/operator.py``, ``NFA.advance``) walks one
event x one partial match at a time in Python.  This module compiles a
``Pattern`` into a dense :class:`TransitionTable` and advances **every
key's partial matches in one batched step per event position**: the active
partials of all keys live in fixed-shape arrays ``[K, M]`` (stage index,
loop count, first timestamp, a bounded event-pointer ring), the per-stage
condition bits that ``process_batch`` evaluates vectorized become the
step's input planes, and the NFA edges (take / ignore / die /
optional-forward / negation) become masked gather/scatter updates.
``within()`` expiry and the after-match skip barrier apply as vectorized
masks; host code touches only *completed* matches.

Equivalence contract: for every **eligible** pattern (see
:func:`classify_pattern`) the step produces bit-identical results to the
interpreted NFA — same matches, same order, same partial-match lists after
every event.  The candidate layout mirrors ``NFA.advance``'s generation
order exactly (per partial: take-stay, take-advance, keep; the fresh start
partial appended last), candidate dedup mirrors the ``seen`` set (exact
comparison, hash-prefiltered), and completed matches bypass dedup just as
``add()`` does.

Two step backends share one layout:

- ``numpy`` (:func:`step_numpy`): the host-vectorized path, exact dedup
  and ring/partial growth; the winner on the CPU.
- ``device`` (:func:`step_device`, the counterpart of JAX's ``step_jit``):
  the same step as torch ops on an explicit device, one step per event
  position at a fixed chunk shape.  Candidate dedup there is
  hash-prefiltered only; a hash hit, a full event ring or a full partial
  axis raises a flag and the step replays on :func:`step_numpy` from the
  block as it was, so bit-identity never rests on a hash.

:func:`calibrated_vectorized_cep` is the measured engine A/B behind
``CepOperator(vectorized="auto")``, run on the operator's device.
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from flink_tpu_torch import resolve_device
from flink_tpu_torch.cep.pattern import AfterMatchSkipStrategy, Pattern
from flink_tpu_torch.core.batch import LONG_MIN

#: event pointers pack (stage << PACK_SHIFT) | event_id into one int64
PACK_SHIFT = 48
_PACK_MASK = (1 << PACK_SHIFT) - 1

#: sentinel for "no within window"
_NO_WITHIN = -1

_ENV_ENGINE = "FLINK_TPU_CEP_VECTORIZED"
_ENV_KERNEL = "FLINK_TPU_CEP_KERNEL"

#: rolling-hash multiplier for the per-partial event-list hash (int32 wrap)
_HASH_MUL = np.int32(1000003)


# ---------------------------------------------------------------------------
# plan-time classifier + transition table
# ---------------------------------------------------------------------------

def classify_pattern(pattern: Pattern) -> Tuple[bool, List[str]]:
    """Is this pattern eligible for the vectorized step?

    The branching stays bounded (<= 3 successor candidates per partial per
    event, mirroring ``NFA.advance``'s edge set):

    - ``followedByAny`` (``relaxed_any``) multiplies ignore edges for
      *matching* events — unbounded combination explosion.
    - ``greedy()`` loops couple a partial's fate to its *sibling's* bits
      (``greedy_from`` suppression), an extra cross-partial plane.

    Everything else — strict/relaxed contiguity, ``notNext`` /
    ``notFollowedBy`` (incl. trailing under ``within``), ``times`` /
    ``oneOrMore`` / ``optional``, ``until``, both after-match skip
    strategies — lowers exactly.  Returns ``(eligible, reasons)``.
    """
    reasons = []
    for s in pattern.stages:
        if s.contiguity == "relaxed_any":
            reasons.append(f"stage {s.name!r}: followedByAny (relaxed_any) "
                           f"contiguity")
        if s.greedy:
            reasons.append(f"stage {s.name!r}: greedy loop")
    return (not reasons), reasons


@dataclass(frozen=True)
class TransitionTable:
    """A ``Pattern`` compiled to dense per-stage planes (numpy; the device
    engine uploads them once per drain, :func:`table_planes`)."""

    n_stages: int
    strict: np.ndarray      # bool[S]: 'next' contiguity
    negated: np.ndarray     # bool[S]
    optional: np.ndarray    # bool[S]
    tmin: np.ndarray        # int64[S] quantifier lower bound
    tmax: np.ndarray        # int64[S] upper bound (2^62 = unbounded)
    within: int             # ms, or _NO_WITHIN
    skip_past: bool         # SKIP_PAST_LAST_EVENT
    trailing_negation: bool
    has_until: bool


def compile_pattern(pattern: Pattern) -> TransitionTable:
    stages = pattern.stages
    S = len(stages)
    unbounded = np.int64(2 ** 62)
    last = stages[-1]
    return TransitionTable(
        n_stages=S,
        strict=np.asarray([s.contiguity == "strict" for s in stages], bool),
        negated=np.asarray([s.negated for s in stages], bool),
        optional=np.asarray([s.optional for s in stages], bool),
        tmin=np.asarray([s.times_min for s in stages], np.int64),
        tmax=np.asarray([s.times_max if s.times_max is not None
                         else unbounded for s in stages], np.int64),
        within=(pattern.within_ms if pattern.within_ms is not None
                else _NO_WITHIN),
        skip_past=(pattern.skip_strategy
                   == AfterMatchSkipStrategy.SKIP_PAST_LAST_EVENT),
        trailing_negation=(last.negated and last.contiguity != "strict"
                           and pattern.within_ms is not None),
        has_until=any(s.until is not None for s in stages),
    )


# ---------------------------------------------------------------------------
# packing helpers
# ---------------------------------------------------------------------------

def pack_event(stage: int, event_id: int) -> int:
    return (int(stage) << PACK_SHIFT) | int(event_id)


def unpack_events(row: np.ndarray) -> Tuple[Tuple[int, int], ...]:
    r = np.asarray(row, np.int64)
    return tuple((int(p) >> PACK_SHIFT, int(p) & _PACK_MASK) for p in r)


def _fold32(packed):
    """int64 packed pointer -> int32 hash lane (both words folded)."""
    p = packed.astype(np.int64) if hasattr(packed, "astype") else packed
    lo = (p & np.int64(0xFFFFFFFF)).astype(np.int32)
    hi = (p >> np.int64(32)).astype(np.int32)
    return lo ^ (hi * np.int32(31))


def event_list_hash(packed_row) -> np.int32:
    """Rolling int32 hash of an event list — MUST match the step's
    incremental update (``h' = h * _HASH_MUL + fold32(packed)``).  Runs on
    1-element arrays so int32 wraparound stays silent (scalar overflow
    warns under ``-W error``)."""
    r = np.asarray(packed_row, np.int64).reshape(-1)
    folded = _fold32(r)
    h = np.zeros(1, np.int32)
    for i in range(r.size):
        h = h * _HASH_MUL + folded[i:i + 1]
    return np.int32(h[0])


# ---------------------------------------------------------------------------
# the numpy step
# ---------------------------------------------------------------------------

def _gather_stage(plane, stage, S):
    """plane[Ka, S] gathered at stage[Ka, M] -> [Ka, M] (clipped gather —
    out-of-range stages are masked off by callers)."""
    idx = np.clip(stage, 0, S - 1)
    return np.take_along_axis(plane, idx, axis=1)


def _candidates(tab: TransitionTable, block, inputs):
    """One NFA event step for a block of keys: build the candidate arrays.

    ``block``: (st, cnt, fst, eln, ev, evh, nlv, skip) — [Ka, M] planes
    (+ ev [Ka, M, E], nlv/skip [Ka]).  ``inputs``: (active, ets, eid,
    bits, ubits) with bits/ubits [Ka, S].

    Returns candidate planes laid out ``[Ka, C=3M+1]`` in the interpreted
    generation order (per partial m: 3m+0 take-stay, 3m+1 take-advance,
    3m+2 keep; slot 3M = the fresh start partial appended last), plus
    ``stepping`` and the E-overflow flag.
    """
    st, cnt, fst, eln, ev, evh, nlv, skip = block
    active, ets, eid, bits, ubits = inputs
    Ka, M = st.shape
    E = ev.shape[2]
    S = tab.n_stages

    m_idx = np.arange(M, dtype=np.int32)[None, :]
    live = m_idx < nlv[:, None]
    stepping = active & (ets > skip)                      # skip barrier
    act = stepping[:, None] & live
    ts_b = ets[:, None]

    # within-window expiry (guard LONG_MIN before subtracting)
    if tab.within != _NO_WITHIN:
        safe_fst = np.where(fst == LONG_MIN, ts_b, fst)
        expired = (fst != LONG_MIN) & (ts_b - safe_fst > tab.within)
    else:
        expired = np.zeros_like(live)
    alive = act & ~expired

    stage_c = np.clip(st, 0, S - 1)
    neg_plane = tab.negated
    strict_plane = tab.strict
    opt_plane = tab.optional

    neg = neg_plane[stage_c] & alive
    strictneg = neg & strict_plane[stage_c]
    relaxneg = neg & ~strict_plane[stage_c]
    normal = alive & ~neg

    b_at = _gather_stage(bits, st, S) & alive
    u_at = _gather_stage(ubits, st, S) & alive

    neg_dead = neg & b_at                   # forbidden event: partial dies
    norm_until_dead = normal & u_at & (cnt > 0)
    normal_f = normal & ~norm_until_dead
    strictneg_f = strictneg & ~neg_dead
    relaxneg_f = relaxneg & ~neg_dead

    # ---- feed(): chain walk through optional stages to the take stage j.
    # own = the stage whose until() can close the loop (the partial's own
    # stage for normal partials; the advanced stage for notNext; never for
    # notFollowedBy — feed there starts past the partial's own stage).
    cs = np.where(neg, st + 1, st)
    own = np.where(relaxneg, np.full_like(st, -1),
                   np.where(strictneg, st + 1, st))
    took_nothing0 = np.where(neg, np.ones_like(live), cnt == 0)

    sn_complete = strictneg_f & (cs >= S)   # notNext ends the pattern
    feeding = (normal_f | strictneg_f | relaxneg_f) & (cs < S)

    jj = np.clip(cs, 0, S - 1)
    remaining = feeding
    matched = np.zeros_like(live)
    take_j = jj
    for _ in range(S):
        bj = np.take_along_axis(bits, jj, axis=1)
        uj = np.take_along_axis(ubits, jj, axis=1)
        negj = neg_plane[jj]
        ublock = (jj == own) & uj
        take_here = remaining & bj & ~negj & ~ublock
        tn = np.where(jj == cs, took_nothing0, np.ones_like(live))
        fwd = (remaining & ~take_here & ~negj & ~(bj & ublock)
               & ~bj & opt_plane[jj] & tn & (jj + 1 < S))
        take_j = np.where(take_here, jj, take_j)
        matched = matched | take_here
        remaining = fwd
        jj = np.where(fwd, jj + 1, jj)

    # ---- take candidates (stay in loop / advance pointer)
    cnt_at_j = np.where((take_j == own) & ~neg, cnt, np.zeros_like(cnt))
    newc = cnt_at_j + 1
    first_f = np.where(fst == LONG_MIN, ts_b, fst)
    tmax_j = tab.tmax[take_j]
    tmin_j = tab.tmin[take_j]
    stay_ok = matched & (newc.astype(np.int64) < tmax_j)
    adv_ok = matched & (newc.astype(np.int64) >= tmin_j)
    adv_stage = take_j + 1
    adv_is_match = adv_ok & (adv_stage >= S)

    packed = ((take_j.astype(np.int64) << PACK_SHIFT)
              | eid[:, None].astype(np.int64))
    e_idx = np.arange(E, dtype=np.int32)[None, None, :]
    ev_app = np.where(e_idx == eln[:, :, None], packed[:, :, None], ev)
    evh_app = (evh * _HASH_MUL + _fold32(packed)).astype(np.int32)
    # E overflow: a take with a full ring cannot record its pointer
    overflow_e = np.any((stay_ok | adv_ok) & (eln >= E))

    # ---- keep candidates
    keep_normal = normal_f & (((st == 0) & (cnt == 0))
                              | (~matched & ~strict_plane[stage_c]))
    nxt_c = np.clip(cs, 0, S - 1)
    keep_sn = (strictneg_f & (cs < S) & ~matched & ~strict_plane[nxt_c])
    keep_rn = relaxneg_f & ~matched & ((cs >= S) | ~strict_plane[nxt_c])

    keep_valid = keep_normal | keep_rn | keep_sn | sn_complete
    # keep content: pm unchanged, EXCEPT notNext which keeps the advanced
    # partial (stage+1, count 0, first filled)
    sn_like = strictneg_f & (keep_sn | sn_complete)
    keep_st = np.where(sn_like, cs, st)
    keep_cnt = np.where(sn_like, np.zeros_like(cnt), cnt)
    keep_fst = np.where(sn_like, first_f, fst)

    # ---- assemble [Ka, C] candidate planes (C = 3M + 1)
    def lay(a0, a1, a2, start_val, dtype):
        tri = np.stack([a0, a1, a2], axis=2).reshape(Ka, 3 * M)
        startc = np.full((Ka, 1), start_val, dtype)
        return np.concatenate([tri, startc], axis=1)

    zil = np.zeros_like
    c_st = lay(take_j, adv_stage, keep_st, np.int32(0), np.int32)
    c_cnt = lay(newc, zil(newc), keep_cnt, np.int32(0), np.int32)
    c_fst = lay(first_f, first_f, keep_fst, np.int64(LONG_MIN), np.int64)
    c_eln = lay(eln + 1, eln + 1, eln, np.int32(0), np.int32)
    c_evh = lay(evh_app, evh_app, evh, np.int32(0), np.int32)
    c_valid = lay(stay_ok, adv_ok, keep_valid, False, bool)
    c_match = lay(zil(stay_ok), adv_is_match, sn_complete, False, bool)
    ev_tri = np.stack([ev_app, ev_app, ev], axis=2).reshape(Ka, 3 * M, E)
    c_ev = np.concatenate([ev_tri, np.zeros((Ka, 1, E), np.int64)], axis=1)

    # the fresh start partial is appended only when no surviving candidate
    # already sits at (stage 0, count 0) — interpreted NFA end-of-advance
    has_start = np.any(c_valid[:, :3 * M] & ~c_match[:, :3 * M]
                       & (c_st[:, :3 * M] == 0) & (c_cnt[:, :3 * M] == 0),
                       axis=1)
    start_col_valid = stepping & ~has_start
    c_valid = np.concatenate(
        [c_valid[:, :3 * M], start_col_valid[:, None]], axis=1)

    cand = dict(st=c_st, cnt=c_cnt, fst=c_fst, eln=c_eln, ev=c_ev,
                evh=c_evh, valid=c_valid, ismatch=c_match)
    return cand, stepping, overflow_e


def _cand_hash(cand):
    """int32 identity hash per candidate: (stage, count, elen, event-list
    rolling hash) — the dedup prefilter."""
    h = (cand["st"].astype(np.int32) * np.int32(31)
         + cand["cnt"].astype(np.int32))
    h = h * _HASH_MUL + cand["eln"].astype(np.int32)
    return (h * _HASH_MUL + cand["evh"]).astype(np.int32)


def _dup_prefilter(cand):
    """dup[k, c] = an EARLIER valid non-match candidate has the same hash —
    the vectorized ``seen``-set prefilter (exact verification is the
    caller's job on rows where this fires)."""
    h = _cand_hash(cand)
    eligible = cand["valid"] & ~cand["ismatch"]
    C = h.shape[1]
    eq = (h[:, None, :] == h[:, :, None])          # [Ka, C(earlier), C]
    tri = np.tril(np.ones((C, C), bool), -1).T     # earlier < c
    hit = eq & tri[None, :, :] & eligible[:, :, None] & eligible[:, None, :]
    return np.any(hit, axis=1)


def _dup_candidate_rows(cand) -> np.ndarray:
    """Rows that MIGHT contain a duplicate candidate — detected by sorting
    each row's (valid, non-match) candidate hashes and looking for adjacent
    equals (O(C log C) instead of the [C, C] pairwise plane).  Invalid
    slots get per-position sentinels above the int32 hash range so they can
    never create a false adjacency."""
    h = _cand_hash(cand).astype(np.int64)
    eligible = cand["valid"] & ~cand["ismatch"]
    C = h.shape[1]
    sentinel = (np.arange(C, dtype=np.int64) + (np.int64(1) << 33))[None, :]
    hm = np.where(eligible, h, sentinel)
    hs = np.sort(hm, axis=1)
    return np.flatnonzero((hs[:, 1:] == hs[:, :-1]).any(axis=1))


def _finalize(M_out: int, cand, dup, block, stepping, ets, skip_past: bool):
    """Compact surviving candidates (valid, non-match, non-dup) into the
    first ``M_out`` slots in candidate order; apply the after-match skip
    reset; keep non-stepping keys' rows untouched.  Returns the new block
    plus the M-overflow flag."""
    st, cnt, fst, eln, ev, evh, nlv, skip = block
    Ka, M = st.shape
    C = cand["st"].shape[1]

    keep = cand["valid"] & ~cand["ismatch"] & ~dup
    ncand = keep.sum(axis=1).astype(np.int32)
    overflow_m = np.max(ncand, initial=0) > M_out

    # stable compaction: argsort(~keep) puts kept candidates first, in
    # order.  M_out may exceed C (a pow2 growth overshooting 3M+1 when a
    # step nearly triples the partial set): gather the min(M_out, C)
    # candidate columns that exist, then pad to M_out — the dead-slot
    # masking below restores the pristine pattern on the padding.
    W = min(M_out, C)
    order = np.argsort(~keep, axis=1, kind="stable")[:, :W]

    def take2(a):
        return np.take_along_axis(a, order, axis=1)

    def padw(a, fill):
        if W >= M_out:
            return a
        return np.concatenate(
            [a, np.full((Ka, M_out - W) + a.shape[2:], fill, a.dtype)],
            axis=1)

    n_st = padw(take2(cand["st"]), np.int32(0))
    n_cnt = padw(take2(cand["cnt"]), np.int32(0))
    n_fst = padw(take2(cand["fst"]), np.int64(LONG_MIN))
    n_eln = padw(take2(cand["eln"]), np.int32(0))
    n_evh = padw(take2(cand["evh"]), np.int32(0))
    n_ev = padw(np.take_along_axis(cand["ev"], order[:, :, None], axis=1),
                np.int64(0))

    # after-match skip: a completing match resets the key to one fresh
    # start partial and raises the skip barrier to the match event's ts
    any_match = np.any(cand["ismatch"] & cand["valid"], axis=1) & stepping
    if skip_past:
        rst = any_match[:, None]
        n_st = np.where(rst, np.zeros_like(n_st), n_st)
        n_cnt = np.where(rst, np.zeros_like(n_cnt), n_cnt)
        n_fst = np.where(rst, np.full_like(n_fst, LONG_MIN), n_fst)
        n_eln = np.where(rst, np.zeros_like(n_eln), n_eln)
        n_evh = np.where(rst, np.zeros_like(n_evh), n_evh)
        n_ev = np.where(rst[:, :, None], np.zeros_like(n_ev), n_ev)
        n_nlv = np.where(any_match, np.ones_like(ncand), ncand)
        n_skip = np.where(any_match, ets, skip)
    else:
        n_nlv = ncand
        n_skip = skip

    # pad target shapes to M_out, then keep non-stepping keys untouched
    def merge(new, old, fill):
        if new.shape[1] < M_out or old.shape[1] < M_out:
            pad_n = M_out - new.shape[1]
            pad_o = M_out - old.shape[1]
            if pad_n:
                new = np.concatenate(
                    [new, np.full((Ka, pad_n) + new.shape[2:], fill,
                                  new.dtype)], axis=1)
            if pad_o:
                old = np.concatenate(
                    [old, np.full((Ka, pad_o) + old.shape[2:], fill,
                                  old.dtype)], axis=1)
        cond = stepping[:, None]
        if new.ndim == 3:
            cond = cond[:, :, None]
        return np.where(cond, new, old)

    # mask dead trailing slots to the pristine pattern so stale payloads
    # never alias into a later comparison or snapshot
    slot = np.arange(M_out, dtype=np.int32)[None, :]
    dead = slot >= n_nlv[:, None]
    n_st = np.where(dead, np.zeros_like(n_st), n_st)
    n_cnt = np.where(dead, np.zeros_like(n_cnt), n_cnt)
    n_fst = np.where(dead, np.full_like(n_fst, LONG_MIN), n_fst)
    n_eln = np.where(dead, np.zeros_like(n_eln), n_eln)
    n_evh = np.where(dead, np.zeros_like(n_evh), n_evh)
    n_ev = np.where(dead[:, :, None], np.zeros_like(n_ev), n_ev)

    new_block = (
        merge(n_st, st, np.int32(0)),
        merge(n_cnt, cnt, np.int32(0)),
        merge(n_fst, fst, np.int64(LONG_MIN)),
        merge(n_eln, eln, np.int32(0)),
        merge(n_ev, ev, np.int64(0)),
        merge(n_evh, evh, np.int32(0)),
        np.where(stepping, n_nlv, nlv),
        n_skip,
    )
    return new_block, overflow_m


def _exact_dup(cand, dup_pre: np.ndarray) -> np.ndarray:
    """Resolve the hash prefilter to EXACT duplicates (the interpreted
    ``seen`` key is (stage, count, events, greedy_from); greedy_from is
    always -1 for eligible patterns)."""
    if not dup_pre.any():
        return dup_pre
    dup = np.zeros_like(dup_pre)
    h = _cand_hash(cand)
    eligible = cand["valid"] & ~cand["ismatch"]
    for k, c in np.argwhere(dup_pre):
        hc = h[k, c]
        for c2 in range(c):
            if not eligible[k, c2] or h[k, c2] != hc or dup[k, c2]:
                continue
            if (cand["st"][k, c2] == cand["st"][k, c]
                    and cand["cnt"][k, c2] == cand["cnt"][k, c]
                    and cand["eln"][k, c2] == cand["eln"][k, c]):
                n = int(cand["eln"][k, c])
                if np.array_equal(cand["ev"][k, c2, :n],
                                  cand["ev"][k, c, :n]):
                    dup[k, c] = True
                    break
    return dup


class StepResult:
    """One event step's outcome: the new block plus match extraction."""

    __slots__ = ("block", "match_kc", "match_ev", "match_eln")

    def __init__(self, block, match_kc, match_ev, match_eln):
        self.block = block
        self.match_kc = match_kc       # [n, 2] (key row, candidate order)
        self.match_ev = match_ev       # list of packed int64 rows
        self.match_eln = match_eln


def step_numpy(tab: TransitionTable, m_cap: int, block, inputs
               ) -> Tuple[StepResult, int]:
    """One exact event step on the host.  Returns the result and the
    (possibly grown) partial capacity — E growth is handled internally by
    re-running the candidate pass on widened rings."""
    while True:
        cand, stepping, overflow_e = _candidates(tab, block, inputs)
        if bool(overflow_e):
            block = grow_event_ring(block)
            continue
        break
    sus = _dup_candidate_rows(cand)
    dup = np.zeros_like(cand["valid"])
    if sus.size:
        sub = {k: v[sus] for k, v in cand.items()}
        dup[sus] = _exact_dup(sub, _dup_prefilter(sub))
    keep = cand["valid"] & ~cand["ismatch"] & ~dup
    need = int(keep.sum(axis=1).max(initial=0))
    m_out = m_cap
    while need > m_out:
        m_out *= 2
    new_block, _ = _finalize(m_out, cand, dup, block, stepping, inputs[1],
                             tab.skip_past)
    mm = cand["ismatch"] & cand["valid"]
    kc = np.argwhere(mm)               # row-major: candidate order per key
    evs, elns = [], []
    for k, c in kc:
        n = int(cand["eln"][k, c])
        evs.append(np.array(cand["ev"][k, c, :n], np.int64))
        elns.append(n)
    return StepResult(new_block, kc, evs, elns), m_out


def grow_event_ring(block):
    """Double the bounded event-pointer ring (sticky high-water)."""
    st, cnt, fst, eln, ev, evh, nlv, skip = block
    Ka, M, E = ev.shape
    wide = np.zeros((Ka, M, max(2 * E, 2)), np.int64)
    wide[:, :, :E] = ev
    return (st, cnt, fst, eln, wide, evh, nlv, skip)


def grow_partials(block, m_new: int):
    """Widen the partial axis to ``m_new`` slots (sticky high-water)."""
    st, cnt, fst, eln, ev, evh, nlv, skip = block
    Ka, M, E = ev.shape
    if m_new <= M:
        return block
    pad = m_new - M

    def w(a, fill):
        return np.concatenate(
            [a, np.full((Ka, pad) + a.shape[2:], fill, a.dtype)], axis=1)

    return (w(st, 0), w(cnt, 0), w(fst, LONG_MIN), w(eln, 0),
            w(ev, 0), w(evh, 0), nlv, skip)


# ---------------------------------------------------------------------------
# the device step: the same step as torch ops, numpy replay on a flag
# ---------------------------------------------------------------------------

def _torch_fold32(packed):
    import torch

    lo = (packed & 0xFFFFFFFF).to(torch.int32)
    hi = (packed >> 32).to(torch.int32)
    return lo ^ (hi * 31)


def _torch_candidates(tab: TransitionTable, block, inputs, planes):
    """:func:`_candidates` over torch tensors on one device: the same
    candidate planes in the same layout and dtypes (int32 arithmetic wraps
    as numpy's does; Python scalars never widen a tensor)."""
    import torch

    st, cnt, fst, eln, ev, evh, nlv, skip = block
    active, ets, eid, bits, ubits = inputs
    neg_plane, strict_plane, opt_plane, tmin_plane, tmax_plane = planes
    Ka, M = st.shape
    E = ev.shape[2]
    S = tab.n_stages
    dev = st.device

    m_idx = torch.arange(M, dtype=torch.int32, device=dev)[None, :]
    live = m_idx < nlv[:, None]
    stepping = active & (ets > skip)
    act = stepping[:, None] & live
    ts_b = ets[:, None]

    if tab.within != _NO_WITHIN:
        safe_fst = torch.where(fst == LONG_MIN, ts_b, fst)
        expired = (fst != LONG_MIN) & (ts_b - safe_fst > tab.within)
    else:
        expired = torch.zeros_like(live)
    alive = act & ~expired

    stage_c = st.clamp(0, S - 1).long()
    strict_c = strict_plane[stage_c]
    neg = neg_plane[stage_c] & alive
    strictneg = neg & strict_c
    relaxneg = neg & ~strict_c
    normal = alive & ~neg

    b_at = torch.gather(bits, 1, stage_c) & alive
    u_at = torch.gather(ubits, 1, stage_c) & alive

    neg_dead = neg & b_at
    norm_until_dead = normal & u_at & (cnt > 0)
    normal_f = normal & ~norm_until_dead
    strictneg_f = strictneg & ~neg_dead
    relaxneg_f = relaxneg & ~neg_dead

    cs = torch.where(neg, st + 1, st)
    own = torch.where(relaxneg, torch.full_like(st, -1),
                      torch.where(strictneg, st + 1, st))
    took_nothing0 = torch.where(neg, torch.ones_like(live), cnt == 0)

    sn_complete = strictneg_f & (cs >= S)
    feeding = (normal_f | strictneg_f | relaxneg_f) & (cs < S)

    jj = cs.clamp(0, S - 1)
    remaining = feeding
    matched = torch.zeros_like(live)
    take_j = jj
    for _ in range(S):
        jl = jj.long()
        bj = torch.gather(bits, 1, jl)
        uj = torch.gather(ubits, 1, jl)
        negj = neg_plane[jl]
        ublock = (jj == own) & uj
        take_here = remaining & bj & ~negj & ~ublock
        tn = torch.where(jj == cs, took_nothing0, torch.ones_like(live))
        fwd = (remaining & ~take_here & ~negj & ~(bj & ublock)
               & ~bj & opt_plane[jl] & tn & (jj + 1 < S))
        take_j = torch.where(take_here, jj, take_j)
        matched = matched | take_here
        remaining = fwd
        jj = torch.where(fwd, jj + 1, jj)

    cnt_at_j = torch.where((take_j == own) & ~neg, cnt, torch.zeros_like(cnt))
    newc = cnt_at_j + 1
    first_f = torch.where(fst == LONG_MIN, ts_b, fst)
    tj = take_j.long()
    stay_ok = matched & (newc.long() < tmax_plane[tj])
    adv_ok = matched & (newc.long() >= tmin_plane[tj])
    adv_stage = take_j + 1
    adv_is_match = adv_ok & (adv_stage >= S)

    packed = (tj << PACK_SHIFT) | eid[:, None]
    e_idx = torch.arange(E, dtype=torch.int32, device=dev)[None, None, :]
    ev_app = torch.where(e_idx == eln[:, :, None], packed[:, :, None], ev)
    evh_app = evh * int(_HASH_MUL) + _torch_fold32(packed)
    overflow_e = ((stay_ok | adv_ok) & (eln >= E)).any()

    keep_normal = normal_f & (((st == 0) & (cnt == 0))
                              | (~matched & ~strict_c))
    strict_nxt = strict_plane[cs.clamp(0, S - 1).long()]
    keep_sn = strictneg_f & (cs < S) & ~matched & ~strict_nxt
    keep_rn = relaxneg_f & ~matched & ((cs >= S) | ~strict_nxt)

    keep_valid = keep_normal | keep_rn | keep_sn | sn_complete
    sn_like = strictneg_f & (keep_sn | sn_complete)
    keep_st = torch.where(sn_like, cs, st)
    keep_cnt = torch.where(sn_like, torch.zeros_like(cnt), cnt)
    keep_fst = torch.where(sn_like, first_f, fst)

    def lay(a0, a1, a2, start_val):
        tri = torch.stack([a0, a1, a2], dim=2).reshape(Ka, 3 * M)
        startc = torch.full((Ka, 1), start_val, dtype=a0.dtype, device=dev)
        return torch.cat([tri, startc], dim=1)

    zil = torch.zeros_like
    c_st = lay(take_j, adv_stage, keep_st, 0)
    c_cnt = lay(newc, zil(newc), keep_cnt, 0)
    c_fst = lay(first_f, first_f, keep_fst, LONG_MIN)
    c_eln = lay(eln + 1, eln + 1, eln, 0)
    c_evh = lay(evh_app, evh_app, evh, 0)
    c_valid = lay(stay_ok, adv_ok, keep_valid, False)
    c_match = lay(zil(stay_ok), adv_is_match, sn_complete, False)
    ev_tri = torch.stack([ev_app, ev_app, ev], dim=2).reshape(Ka, 3 * M, E)
    c_ev = torch.cat([ev_tri, torch.zeros((Ka, 1, E), dtype=torch.int64,
                                          device=dev)], dim=1)

    has_start = (c_valid[:, :3 * M] & ~c_match[:, :3 * M]
                 & (c_st[:, :3 * M] == 0)
                 & (c_cnt[:, :3 * M] == 0)).any(dim=1)
    c_valid = torch.cat([c_valid[:, :3 * M], (stepping & ~has_start)[:, None]],
                        dim=1)

    cand = dict(st=c_st, cnt=c_cnt, fst=c_fst, eln=c_eln, ev=c_ev,
                evh=c_evh, valid=c_valid, ismatch=c_match)
    return cand, stepping, overflow_e


def _torch_dup_prefilter(cand):
    """:func:`_dup_prefilter` (with :func:`_cand_hash`) in torch ops."""
    import torch

    h = cand["st"] * 31 + cand["cnt"]
    h = h * int(_HASH_MUL) + cand["eln"]
    h = h * int(_HASH_MUL) + cand["evh"]
    eligible = cand["valid"] & ~cand["ismatch"]
    C = h.shape[1]
    eq = h[:, None, :] == h[:, :, None]
    tri = torch.ones((C, C), dtype=torch.bool, device=h.device).tril(-1).T
    hit = eq & tri[None, :, :] & eligible[:, :, None] & eligible[:, None, :]
    return hit.any(dim=1)


def _torch_finalize(cand, dup, block, stepping, ets, skip_past: bool):
    """:func:`_finalize` in torch ops at ``M_out`` = the block's own width
    (the device step's fixed shape: a wider need raises the M flag and
    replays on the host, which grows)."""
    import torch

    st, cnt, fst, eln, ev, evh, nlv, skip = block
    Ka, M = st.shape
    E = ev.shape[2]
    dev = st.device

    keep = cand["valid"] & ~cand["ismatch"] & ~dup
    ncand = keep.sum(dim=1).to(torch.int32)
    order = torch.argsort((~keep).to(torch.uint8), dim=1,
                          stable=True)[:, :M]

    def take2(a):
        return torch.gather(a, 1, order)

    n_st = take2(cand["st"])
    n_cnt = take2(cand["cnt"])
    n_fst = take2(cand["fst"])
    n_eln = take2(cand["eln"])
    n_evh = take2(cand["evh"])
    n_ev = torch.gather(cand["ev"], 1, order[:, :, None].expand(Ka, M, E))

    any_match = (cand["ismatch"] & cand["valid"]).any(dim=1) & stepping
    if skip_past:
        rst = any_match[:, None]
        n_st = torch.where(rst, torch.zeros_like(n_st), n_st)
        n_cnt = torch.where(rst, torch.zeros_like(n_cnt), n_cnt)
        n_fst = torch.where(rst, torch.full_like(n_fst, LONG_MIN), n_fst)
        n_eln = torch.where(rst, torch.zeros_like(n_eln), n_eln)
        n_evh = torch.where(rst, torch.zeros_like(n_evh), n_evh)
        n_ev = torch.where(rst[:, :, None], torch.zeros_like(n_ev), n_ev)
        n_nlv = torch.where(any_match, torch.ones_like(ncand), ncand)
        n_skip = torch.where(any_match, ets, skip)
    else:
        n_nlv = ncand
        n_skip = skip

    slot = torch.arange(M, dtype=torch.int32, device=dev)[None, :]
    dead = slot >= n_nlv[:, None]
    n_st = torch.where(dead, torch.zeros_like(n_st), n_st)
    n_cnt = torch.where(dead, torch.zeros_like(n_cnt), n_cnt)
    n_fst = torch.where(dead, torch.full_like(n_fst, LONG_MIN), n_fst)
    n_eln = torch.where(dead, torch.zeros_like(n_eln), n_eln)
    n_evh = torch.where(dead, torch.zeros_like(n_evh), n_evh)
    n_ev = torch.where(dead[:, :, None], torch.zeros_like(n_ev), n_ev)

    cond = stepping[:, None]
    return (torch.where(cond, n_st, st), torch.where(cond, n_cnt, cnt),
            torch.where(cond, n_fst, fst), torch.where(cond, n_eln, eln),
            torch.where(cond[:, :, None], n_ev, ev),
            torch.where(cond, n_evh, evh),
            torch.where(stepping, n_nlv, nlv), n_skip)


def _table_arrays(tab: TransitionTable):
    return (tab.negated, tab.strict, tab.optional, tab.tmin, tab.tmax)


def table_planes(tab: TransitionTable, device):
    """The transition table's per-stage planes as tensors on ``device``:
    uploaded once per drain and handed to every step of it."""
    import torch

    return tuple(torch.from_numpy(a).to(device) for a in _table_arrays(tab))


def table_bytes(tab: TransitionTable) -> int:
    """Bytes :func:`table_planes` uploads."""
    return sum(a.nbytes for a in _table_arrays(tab))


def device_step(tab: TransitionTable, m_cap: int, block, inputs,
                planes=None):
    """The step body over tensors of one device (JAX's jitted ``step``,
    ``_make_jit_step``): returns the new block, the match plane ``mm``
    ``[Ka, C]``, the candidates' event rings ``[Ka, C, E]`` and lengths,
    and the flags ``(overflow_e, overflow_m, any(dup))``.  It keeps the
    block's width ``m_cap``.  ``planes`` are :func:`table_planes` on the
    block's device (built here when not given)."""
    import torch

    Ka = block[0].shape[0]
    dev = block[0].device
    if planes is None:
        planes = table_planes(tab, dev)
    cand, stepping, overflow_e = _torch_candidates(tab, block, inputs, planes)
    dup = _torch_dup_prefilter(cand)
    keep = cand["valid"] & ~cand["ismatch"] & ~dup
    if Ka:
        overflow_m = keep.sum(dim=1).max() > m_cap
    else:
        overflow_m = torch.zeros((), dtype=torch.bool, device=dev)
    new_block = _torch_finalize(cand, dup, block, stepping, inputs[1],
                                tab.skip_past)
    mm = cand["ismatch"] & cand["valid"]
    flags = torch.stack([overflow_e, overflow_m, dup.any()])
    return new_block, mm, cand["ev"], cand["eln"], flags


def step_device(tab: TransitionTable, m_cap: int, block, inputs, device,
                counters: Optional[Dict[str, int]] = None, planes=None
                ) -> Tuple[StepResult, int]:
    """One event step as torch ops on ``device`` (the counterpart of JAX's
    ``step_jit``): the block and the step's inputs go up, the step runs at
    the block's own shape, the flags come down, and then either the new
    block (and, only where a match completed, its event rows) comes down,
    or — on an E overflow, an M overflow or any hash-prefilter hit — the
    step replays on :func:`step_numpy` from the block as it was, so no
    dedup decision is ever taken on a hash alone.  ``counters`` (optional)
    accumulates ``replayed`` (steps that took the host step), ``h2d_bytes``
    and ``d2h_bytes``.  ``planes`` are :func:`table_planes` on ``device``,
    uploaded once by the caller; without them this step uploads (and
    counts) the table itself.
    On a CUDA device the step runs on the card or raises."""
    import torch

    M = block[0].shape[1]
    if m_cap != M:
        raise ValueError(f"the device step runs at the block's width {M}, "
                         f"not {m_cap}")
    dev = torch.device(device)
    host = [np.ascontiguousarray(a) for a in (*block, *inputs)]
    up = [torch.from_numpy(a).to(dev, non_blocking=False) for a in host]
    blk, inp = tuple(up[:8]), tuple(up[8:])
    inp = (inp[0], inp[1], inp[2].long(), inp[3], inp[4])
    moved_up = sum(a.nbytes for a in host)
    if planes is None:
        planes = table_planes(tab, dev)
        moved_up += table_bytes(tab)
    new_block, mm, c_ev, c_eln, flags = device_step(tab, m_cap, blk, inp,
                                                    planes)
    flags = torch.cat([flags, mm.any()[None]]).cpu().numpy()
    moved_down = flags.nbytes
    if flags[:3].any():
        if counters is not None:
            counters["replayed"] = counters.get("replayed", 0) + 1
            counters["h2d_bytes"] = counters.get("h2d_bytes", 0) + moved_up
            counters["d2h_bytes"] = (counters.get("d2h_bytes", 0)
                                     + moved_down)
        return step_numpy(tab, m_cap, block, inputs)
    if flags[3]:
        kc_t = mm.nonzero()
        rows_ev = c_ev[kc_t[:, 0], kc_t[:, 1]].cpu().numpy()
        rows_eln = c_eln[kc_t[:, 0], kc_t[:, 1]].cpu().numpy()
        kc = kc_t.cpu().numpy()
        moved_down += rows_ev.nbytes + rows_eln.nbytes + kc.nbytes
        elns = [int(n) for n in rows_eln]
        evs = [np.array(rows_ev[i, :n], np.int64)
               for i, n in enumerate(elns)]
    else:
        kc = np.empty((0, 2), np.int64)
        evs, elns = [], []
    out = tuple(a.cpu().numpy() for a in new_block)
    moved_down += sum(a.nbytes for a in out)
    if counters is not None:
        counters["h2d_bytes"] = counters.get("h2d_bytes", 0) + moved_up
        counters["d2h_bytes"] = counters.get("d2h_bytes", 0) + moved_down
    return StepResult(out, kc, evs, elns), m_cap


def _device_type(device) -> str:
    """``device``'s type; ``None`` is the card (``resolve_device``: raises
    without one, never the CPU)."""
    if device is None:
        device = resolve_device(None)
    return getattr(device, "type", None) or str(device)


def default_kernel(device=None) -> str:
    """Step backend pick: ``FLINK_TPU_CEP_KERNEL=numpy|np|host`` chooses
    the host step, ``jit|jax|device`` the device step; otherwise the step
    follows the operator's device (``None``: the card): the device step on
    ``cuda``, ``numpy`` on the CPU (the per-step dispatch loses to one fused
    numpy pass there, JAX's CPU verdict)."""
    kind = _device_type(device)
    env = os.environ.get(_ENV_KERNEL, "").lower()
    if env in ("numpy", "np", "host"):
        return "numpy"
    if env in ("jit", "jax", "device"):
        return "device"
    return "device" if kind.startswith("cuda") else "numpy"


# ---------------------------------------------------------------------------
# engine calibration (the --device-probe-style measured A/B)
# ---------------------------------------------------------------------------

#: cached verdicts, one per device type ("cuda", "cpu")
_calibrated: Dict[str, bool] = {}
_calib_lock = threading.Lock()
#: the last measurement's timings (seconds) by device type, for reports
last_measurement: Dict[str, Dict[str, float]] = {}


def calibrated_vectorized_cep(device=None) -> bool:
    """MEASURED verdict, cached process-wide per device type: does the
    batched engine beat the interpreted NFA on this device (``None``: the
    card, raising without one)?
    ``vectorized="auto"`` asks this once; ``FLINK_TPU_CEP_VECTORIZED=
    on|off`` short-circuits (same contract as ``FLINK_TPU_DEVICE_PROBE``)."""
    kind = _device_type(device)
    got = _calibrated.get(kind)
    if got is not None:
        return got
    with _calib_lock:
        got = _calibrated.get(kind)
        if got is not None:
            return got
        env = os.environ.get(_ENV_ENGINE, "").lower()
        if env in ("on", "1", "true"):
            _calibrated[kind] = True
            return True
        if env in ("off", "0", "false"):
            _calibrated[kind] = False
            return False
        _calibrated[kind] = _measure_vectorized(device)
        return _calibrated[kind]


def _reset_calibration() -> None:
    """Test hook: drop the cached verdicts."""
    with _calib_lock:
        _calibrated.clear()


def _measure_vectorized(device=None) -> bool:
    """A/B one synthetic drain (4k keys x 4 events, 2-stage pattern)
    through both engines on ``device`` (``None``: the card, raising
    without one); ties go to the batched engine (it scales with keys, the
    interpreted loop does not)."""
    from flink_tpu_torch.cep.operator import CepOperator
    from flink_tpu_torch.core.batch import RecordBatch, Watermark

    dev = resolve_device(device)
    kind = _device_type(device)

    def build(mode):
        pat = (Pattern.begin("a")
               .where(lambda c: np.asarray(c["v"]) < 0.25)
               .followed_by("b")
               .where(lambda c: np.asarray(c["v"]) > 0.75))
        return CepOperator(pat, "k", lambda m: {"n": 1}, vectorized=mode,
                           device=dev)

    rng = np.random.default_rng(41)
    n_keys, n_ev = 4096, 4
    keys = np.repeat(np.arange(n_keys, dtype=np.int64), n_ev)
    rng.shuffle(keys)
    vals = rng.random(keys.size)
    ts = np.arange(keys.size, dtype=np.int64)

    def run(mode):
        op = build(mode)
        t0 = time.perf_counter()
        op.process_batch(RecordBatch({"k": keys, "v": vals}, timestamps=ts))
        op.process_watermark(Watermark(int(ts[-1])))
        return time.perf_counter() - t0

    run("on")                    # warm builds/caches outside the timing
    t_vec = min(run("on") for _ in range(2))
    t_int = min(run("off") for _ in range(2))
    last_measurement[kind] = {"vectorized_s": t_vec, "interpreted_s": t_int}
    return t_vec <= t_int


# ---------------------------------------------------------------------------
# interpreted-state bridge (degrade / snapshots / restore)
# ---------------------------------------------------------------------------

def encode_partials(partials, m_cap: int, e_cap: int):
    """Interpreted ``_Partial`` list -> one key's row planes (grown caps
    returned alongside; callers fold them into the sticky high-water):
    row 0 of :func:`encode_partial_lists`."""
    planes, m_cap, e_cap = encode_partial_lists([partials], m_cap, e_cap)
    return tuple(a[0] for a in planes), m_cap, e_cap


def decode_partials(row_block, nlive: int):
    """One key's row planes -> the interpreted ``_Partial`` list: key 0 of
    :func:`decode_partial_lists`."""
    st, cnt, fst, eln, ev = (np.asarray(a)[None] for a in row_block[:5])
    return decode_partial_lists(st, cnt, fst, eln, ev,
                                np.asarray([nlive], np.int32))[0]


def encode_partial_lists(lists, m_cap: int, e_cap: int):
    """Many keys' ``_Partial`` lists -> their row planes at once, at the
    caps the widest key needs (``[n_keys, m, e]`` planes, dead slots
    pristine, the rolling hashes computed over whole arrays)."""
    n_keys = len(lists)
    most = max((len(ps) for ps in lists), default=0)
    longest = max((len(p.events) for ps in lists for p in ps), default=0)
    while m_cap < max(most, 1):
        m_cap *= 2
    while e_cap < max(longest, 1):
        e_cap *= 2
    st = np.zeros((n_keys, m_cap), np.int32)
    cnt = np.zeros((n_keys, m_cap), np.int32)
    fst = np.full((n_keys, m_cap), LONG_MIN, np.int64)
    eln = np.zeros((n_keys, m_cap), np.int32)
    ev = np.zeros((n_keys, m_cap, e_cap), np.int64)
    nlv = np.fromiter((len(ps) for ps in lists), np.int32, count=n_keys)
    rows, cols, vals = [], [], []
    ek, em, ee, ep = [], [], [], []
    for i, ps in enumerate(lists):
        for m, p in enumerate(ps):
            rows.append(i)
            cols.append(m)
            vals.append((p.stage_i, p.count, p.first_ts, len(p.events)))
            for e, (stage, eid) in enumerate(p.events):
                ek.append(i)
                em.append(m)
                ee.append(e)
                ep.append((int(stage) << PACK_SHIFT) | int(eid))
    if rows:
        v = np.asarray(vals, np.int64)
        st[rows, cols] = v[:, 0]
        cnt[rows, cols] = v[:, 1]
        fst[rows, cols] = v[:, 2]
        eln[rows, cols] = v[:, 3]
    if ek:
        ev[ek, em, ee] = np.asarray(ep, np.int64)
    evh = np.zeros((n_keys, m_cap), np.int32)
    for e in range(e_cap):
        evh = np.where(e < eln, evh * _HASH_MUL + _fold32(ev[:, :, e]), evh)
    return (st, cnt, fst, eln, ev, evh, nlv), m_cap, e_cap


def decode_partial_lists(st, cnt, fst, eln, ev, nlv):
    """Row planes of many keys -> their ``_Partial`` lists."""
    from flink_tpu_torch.cep.operator import _Partial

    st_l, cnt_l, fst_l, eln_l = (a.tolist() for a in (st, cnt, fst, eln))
    # most keys hold only the pristine start partial: share one (frozen)
    start = _Partial(0, 0, (), LONG_MIN)
    out = []
    for i, n in enumerate(np.asarray(nlv).tolist()):
        if (n == 1 and eln_l[i][0] == 0 and st_l[i][0] == 0
                and cnt_l[i][0] == 0 and fst_l[i][0] == LONG_MIN):
            out.append([start])
            continue
        ps = []
        for m in range(n):
            k = eln_l[i][m]
            events = (tuple((p >> PACK_SHIFT, p & _PACK_MASK)
                            for p in ev[i, m, :k].tolist()) if k else ())
            ps.append(_Partial(st_l[i][m], cnt_l[i][m], events, fst_l[i][m]))
        out.append(ps)
    return out
