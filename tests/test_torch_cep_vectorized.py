"""Port parity for the vectorized CEP engine: ``flink_tpu_torch.cep``
against ``flink_tpu.cep`` on the CPU, on numpy-seeded event streams.

The counterparts of ``tests/test_cep_vectorized.py``: every case runs
through both packages, and the port's three engines (the interpreted NFA,
the numpy step and the torch device step on CPU tensors) must equal JAX's
BIT FOR BIT — the same match rows in the same order with the same
timestamps, the same ``cep_stats()``, and the same snapshots (compared field
by field after :func:`~flink_tpu_torch.interop.cep_snapshot_to_jax`).
Added here: the torch step against JAX's ``step_numpy`` and, through the
``_jax_x64`` shim, its jitted step, step by step (new block, flags, match
planes); the port's ``step_numpy`` against JAX's; the classifier and the
compiled table; the rolling hash at the int32 wrap edges; the wedge
degrade against JAX's; the env overrides; and ``bench.py``'s small
equivalence stream through all three engines of both packages.  The
``PatternStream.select`` and ``MATCH_RECOGNIZE`` cases need the DataStream
API and SQL, which the port does not have yet; the port's refusal of
``CEP``/``PatternStream`` is tested instead.

JAX's jitted step imports ``jax.experimental.enable_x64``, gone in jax
0.9: ``_jax_x64`` restores the name for the JAX calls that need it.
"""

import jax
import numpy as np
import pytest
import torch

from flink_tpu.cep import operator as jop
from flink_tpu.cep import pattern as jpat
from flink_tpu.cep import vectorized as jv
from flink_tpu.core.batch import RecordBatch as JaxBatch
from flink_tpu.core.batch import Watermark as JaxWatermark
from flink_tpu.runtime import device_health as jdh
from flink_tpu.testing import chaos as jchaos
from flink_tpu_torch.cep import operator as pop
from flink_tpu_torch.cep import pattern as ppat
from flink_tpu_torch.cep import vectorized as pv
from flink_tpu_torch.core.batch import RecordBatch, Watermark
from flink_tpu_torch.interop import cep_snapshot_from_jax, cep_snapshot_to_jax
from flink_tpu_torch.runtime import device_health as pdh
from flink_tpu_torch.testing import chaos as pchaos

SIDES = {
    "jax": dict(op=jop, pat=jpat, v=jv, RB=JaxBatch, WM=JaxWatermark,
                dh=jdh, chaos=jchaos, kw={}),
    "port": dict(op=pop, pat=ppat, v=pv, RB=RecordBatch, WM=Watermark,
                 dh=pdh, chaos=pchaos, kw={"device": "cpu"}),
}
SKIPS = ("no_skip", "skip_past_last_event")
#: the port's device step, kept for the cases that wrap it
STEP_DEVICE = pv.step_device
#: the block's plane dtypes in block order (st, cnt, fst, eln, ev, evh,
#: nlv, skip), numpy's and JAX's x64 step's
BLOCK_DTYPES = (np.int32, np.int32, np.int64, np.int32, np.int64, np.int32,
                np.int32, np.int64)


@pytest.fixture(autouse=True)
def calibration():
    """Both packages' engine verdicts are dropped before and after each
    test, and neither package's monitor nor injector leaks out of it."""
    prev = {s: S["dh"].get_monitor(create=False) for s, S in SIDES.items()}
    jv._reset_calibration()
    pv._reset_calibration()
    yield
    jv._reset_calibration()
    pv._reset_calibration()
    for s, S in SIDES.items():
        S["dh"].set_monitor(prev[s])
        S["chaos"].uninstall()


@pytest.fixture
def _jax_x64():
    with pytest.MonkeyPatch.context() as mp:
        if not hasattr(jax.experimental, "enable_x64"):
            mp.setattr(jax.experimental, "enable_x64",
                       lambda new_val=True: jax.enable_x64(new_val),
                       raising=False)
        yield


def _is(kind):
    return lambda cols: np.asarray(cols["kind"]) == kind


def _sel(m):
    return {"sig": "|".join(f"{n}:{','.join(r['kind'] for r in rs)}"
                            for n, rs in sorted(m.items())),
            "k": next(iter(m.values()))[0]["k"]}


def _stream(seed, n=90, n_keys=6):
    """``tests/test_cep_vectorized.py``'s seeded stream: uneven batches with
    jittery watermarks (some events held across drains)."""
    rng = np.random.default_rng(seed)
    kinds = ["a", "b", "c", "m", "s", "e", "x"]
    evs = [(int(rng.integers(0, n_keys)), kinds[rng.integers(0, len(kinds))],
            t) for t in range(n)]
    chunks, wms = [], []
    t = 0
    while t < n:
        sz = int(rng.integers(0, 7))
        chunks.append(evs[t:t + sz])
        t += sz
        wms.append(int(rng.integers(max(0, t - 8), t + 3)))
    return chunks, wms


def _corpus(side, skip):
    P = SIDES[side]["pat"].Pattern
    return {
        "followed_by": P.begin("a", skip_strategy=skip)
        .where(_is("a")).followed_by("b").where(_is("b")),
        "next_strict": P.begin("a", skip_strategy=skip)
        .where(_is("a")).next("b").where(_is("b")),
        "times_1_3": P.begin("a", skip_strategy=skip)
        .where(_is("a")).times(1, 3).followed_by("b").where(_is("b")),
        "times_2_strict": P.begin("a", skip_strategy=skip)
        .where(_is("a")).times(2).next("b").where(_is("b")),
        "one_or_more_within": P.begin("a", skip_strategy=skip)
        .where(_is("a")).one_or_more().followed_by("b").where(_is("b"))
        .within(7),
        "optional_chain": P.begin("a", skip_strategy=skip)
        .where(_is("a")).followed_by("m").where(_is("m")).optional()
        .followed_by("m2").where(_is("s")).optional()
        .followed_by("b").where(_is("b")),
        "not_next": P.begin("a", skip_strategy=skip)
        .where(_is("a")).not_next("nb").where(_is("b"))
        .next("c").where(_is("c")),
        "not_next_end": P.begin("a", skip_strategy=skip)
        .where(_is("a")).not_next("nb").where(_is("b")),
        "not_followed_by": P.begin("a", skip_strategy=skip)
        .where(_is("a")).not_followed_by("nb").where(_is("b"))
        .followed_by("c").where(_is("c")).within(15),
        "trailing_negation": P.begin("a", skip_strategy=skip)
        .where(_is("a")).times(1, 2).not_followed_by("nb").where(_is("b"))
        .within(6),
        "until_loop": P.begin("a", skip_strategy=skip)
        .where(_is("a")).one_or_more().until(_is("s"))
        .followed_by("e").where(_is("e")).within(20),
    }


def _op(side, pattern, mode, kernel=None, select=_sel):
    S = SIDES[side]
    op = S["op"].CepOperator(pattern, "k", select, vectorized=mode,
                             **S["kw"])
    if kernel is not None:
        op._resolve_engine()
        op._vec.kernel = kernel
    return op


def _feed(side, op, chunks, wms, snap_at=(), end=True):
    S = SIDES[side]
    out, snaps = [], []
    for j, (chunk, wm) in enumerate(zip(chunks, wms)):
        if chunk:
            ks = np.asarray([e[0] for e in chunk])
            ks = ks.astype(np.int64 if ks.dtype.kind in "iu" else object)
            kk = np.asarray([e[1] for e in chunk], object)
            ts = np.asarray([e[2] for e in chunk], np.int64)
            out += op.process_batch(S["RB"]({"k": ks, "kind": kk},
                                            timestamps=ts))
        out += op.process_watermark(S["WM"](wm))
        if j in snap_at:
            snaps.append(op.snapshot_state())
    if end:
        out += op.end_input()
    return _rows(out), snaps


def _rows(out):
    """Each emitted row with its columns' values, dtypes and timestamp."""
    return [tuple(sorted((c, str(b.columns[c][i]),
                          np.asarray(b.columns[c]).dtype.str)
                         for c in b.columns))
            + (int(np.asarray(b.timestamps)[i]),
               np.asarray(b.timestamps).dtype.str)
            for b in out for i in range(len(b))]


def _neutral(snap, side):
    """A snapshot in the neutral layout: partial matches as tuples."""
    if side == "port":
        return cep_snapshot_to_jax(snap)
    return cep_snapshot_to_jax(cep_snapshot_from_jax(snap))


def _snap_eq(a, b):
    if isinstance(a, dict) and isinstance(b, dict):
        return (list(a.keys()) == list(b.keys())
                and all(_snap_eq(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(_snap_eq(x, y)
                                        for x, y in zip(a, b))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return np.array_equal(np.asarray(a), np.asarray(b))
    return a == b


_STATS = ("matches", "partials_high_water", "vectorized_drains",
          "interpreted_drains", "degraded", "engine", "fallback_reasons",
          "batches", "restored_rows")


def _stats(op):
    st = op.cep_stats()
    assert set(st) == set(_STATS)
    return st


# port engines: (vectorized, kernel)
PORT_ENGINES = (("off", None), ("on", "numpy"), ("on", "device"))


@pytest.mark.parametrize("skip", SKIPS)
@pytest.mark.parametrize("name", sorted(_corpus("jax", "no_skip")))
def test_equivalence_corpus(skip, name):
    """Every eligible corpus pattern, both skip strategies, three seeds:
    the port's three engines equal JAX's vectorized and interpreted
    engines bit for bit — rows, order, stats, mid-stream snapshots."""
    for seed in (0, 7, 11):
        chunks, wms = _stream(seed)
        snap_at = {len(chunks) // 2}
        ref = {}
        for mode in ("on", "off"):
            op = _op("jax", _corpus("jax", skip)[name], mode)
            rows, snaps = _feed("jax", op, chunks, wms, snap_at)
            ref[mode] = rows, _stats(op), [_neutral(s, "jax") for s in snaps]
        assert ref["on"][0] == ref["off"][0]
        for mode, kernel in PORT_ENGINES:
            op = _op("port", _corpus("port", skip)[name], mode, kernel)
            rows, snaps = _feed("port", op, chunks, wms, snap_at)
            j_rows, j_stats, j_snaps = ref[mode]
            assert rows == j_rows, (seed, mode, kernel)
            assert _stats(op) == j_stats, (seed, mode, kernel)
            assert all(_snap_eq(_neutral(a, "port"), b)
                       for a, b in zip(snaps, j_snaps)), (seed, mode, kernel)


def test_device_step_kernel_matches_numpy_kernel():
    """The counterpart of ``test_jit_kernel_matches_numpy_kernel``: the
    torch step (CPU tensors) gives the numpy step's exact rows, and both
    give JAX's numpy step's."""
    def run(side, kernel):
        pattern = _corpus(side, "skip_past_last_event")["times_1_3"]
        op = _op(side, pattern, "on", kernel)
        return _feed(side, op, *_stream(3, n=60))[0]

    ref = run("jax", "numpy")
    assert run("port", "device") == run("port", "numpy") == ref


def _step_sides(block, inputs, tab_p, tab_j, m):
    """The port's torch step body, its step_device and its step_numpy
    against JAX's step_numpy on the same block."""
    blk = tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in block)
    inp = tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in inputs)
    raw = pv.device_step(tab_p, m, blk, inp)
    dev_res, dev_m = STEP_DEVICE(tab_p, m, block, inputs, "cpu")
    np_res, np_m = pv.step_numpy(tab_p, m, block, inputs)
    j_res, j_m = jv.step_numpy(tab_j, m, block, inputs)
    return raw, (dev_res, dev_m), (np_res, np_m), (j_res, j_m)


def _same_result(a, b):
    (ra, ma), (rb, mb) = a, b
    assert ma == mb
    assert len(ra.block) == len(rb.block) == 8
    for x, y, dt in zip(ra.block, rb.block, BLOCK_DTYPES):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype == dt and np.array_equal(x, y)
    assert np.array_equal(ra.match_kc, rb.match_kc)
    assert ra.match_eln == rb.match_eln
    assert all(np.array_equal(x, y) for x, y in zip(ra.match_ev, rb.match_ev))


def _jit_outputs(tab_j, m, block, inputs):
    from jax.experimental import enable_x64
    e = block[4].shape[2]
    fn = jv._make_jit_step(tab_j, m, e)
    with enable_x64():
        new_block, mm, c_ev, c_eln, flags = fn(*block, *inputs)
        return (tuple(np.asarray(a) for a in new_block), np.asarray(mm),
                np.asarray(c_ev), np.asarray(c_eln), np.asarray(flags))


def _same_raw(raw, jit):
    new_block, mm, c_ev, c_eln, flags = raw
    j_block, j_mm, j_ev, j_eln, j_flags = jit
    assert np.array_equal(flags.numpy(), j_flags)
    assert np.array_equal(mm.numpy(), j_mm)
    assert np.array_equal(c_ev.numpy(), j_ev)
    assert np.array_equal(c_eln.numpy(), j_eln)
    for x, y in zip(new_block, j_block):
        assert x.numpy().dtype == y.dtype and np.array_equal(x.numpy(), y)


@pytest.mark.parametrize("name", ["times_1_3", "until_loop",
                                  "not_followed_by", "trailing_negation",
                                  "not_next"])
def test_torch_step_equals_jax_steps_step_by_step(name, _jax_x64):
    """Every step of a corpus run (the blocks the operator really feeds):
    the torch step body equals JAX's jitted step (new block where no flag
    is set, match plane, candidate rings, the three flags); ``step_device``
    equals JAX's ``step_numpy``, and so does the port's ``step_numpy``."""
    tab_p = pv.compile_pattern(_corpus("port", "no_skip")[name])
    tab_j = jv.compile_pattern(_corpus("jax", "no_skip")[name])
    seen = {"steps": 0, "flagged": 0}

    def checked(tab, m, block, inputs, device, counters=None, planes=None):
        raw, dev, nump, jnp_ = _step_sides(block, inputs, tab_p, tab_j, m)
        _same_raw(raw, _jit_outputs(tab_j, m, block, inputs))
        _same_result(dev, jnp_)
        _same_result(nump, jnp_)
        seen["steps"] += 1
        seen["flagged"] += int(raw[4].any())
        return STEP_DEVICE(tab, m, block, inputs, device, counters, planes)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pv, "step_device", checked)
        op = _op("port", _corpus("port", "no_skip")[name], "on", "device")
        _feed("port", op, *_stream(37, n=120, n_keys=4))
    assert seen["steps"] > 20


def _random_block(rng, Ka, M, E, S):
    """A seeded block in the engine's invariants: live slots first, dead
    slots pristine, event rings of the live slots' lengths, hashes of
    their event lists (a few duplicated slots provoke the dup flag)."""
    nlv = rng.integers(0, M + 1, Ka).astype(np.int32)
    st = np.zeros((Ka, M), np.int32)
    cnt = np.zeros((Ka, M), np.int32)
    fst = np.full((Ka, M), np.iinfo(np.int64).min, np.int64)
    eln = np.zeros((Ka, M), np.int32)
    ev = np.zeros((Ka, M, E), np.int64)
    evh = np.zeros((Ka, M), np.int32)
    for k in range(Ka):
        for m in range(nlv[k]):
            if m and rng.random() < 0.15:        # a duplicate partial
                st[k, m], cnt[k, m], fst[k, m] = (st[k, m - 1],
                                                  cnt[k, m - 1],
                                                  fst[k, m - 1])
                eln[k, m], ev[k, m], evh[k, m] = (eln[k, m - 1],
                                                  ev[k, m - 1],
                                                  evh[k, m - 1])
                continue
            st[k, m] = rng.integers(0, S)
            cnt[k, m] = rng.integers(0, 3)
            n = int(rng.integers(0, E + 1))
            eln[k, m] = n
            if n or rng.random() < 0.5:
                fst[k, m] = rng.integers(0, 50)
            for e in range(n):
                ev[k, m, e] = pv.pack_event(rng.integers(0, S),
                                            rng.integers(0, 2 ** 40))
            evh[k, m] = pv.event_list_hash(ev[k, m, :n])
    skip = np.where(rng.random(Ka) < 0.2, rng.integers(0, 60, Ka),
                    np.iinfo(np.int64).min).astype(np.int64)
    block = (st, cnt, fst, eln, ev, evh, nlv, skip)
    inputs = (rng.random(Ka) < 0.8,
              rng.integers(0, 80, Ka).astype(np.int64),
              rng.integers(0, 2 ** 40, Ka).astype(np.int64),
              rng.random((Ka, S)) < 0.4, rng.random((Ka, S)) < 0.15)
    return block, inputs


@pytest.mark.parametrize("name", sorted(_corpus("jax", "no_skip")))
@pytest.mark.parametrize("skip", SKIPS)
def test_torch_step_on_seeded_random_blocks(name, skip, _jax_x64):
    """Seeded random blocks (live, dead, duplicated and full-ring slots),
    each corpus pattern: planes, flags and match planes of the torch step
    equal JAX's jitted step's; every step's result equals JAX's
    ``step_numpy`` through ``step_device`` and the port's ``step_numpy``."""
    tab_p = pv.compile_pattern(_corpus("port", skip)[name])
    tab_j = jv.compile_pattern(_corpus("jax", skip)[name])
    rng = np.random.default_rng(sorted(_corpus("jax", skip)).index(name)
                                + 100 * SKIPS.index(skip))
    for Ka, M, E in ((1, 4, 4), (64, 8, 4), (17, 4, 8)):
        block, inputs = _random_block(rng, Ka, M, E, tab_p.n_stages)
        raw, dev, nump, jnp_ = _step_sides(block, inputs, tab_p, tab_j, M)
        _same_raw(raw, _jit_outputs(tab_j, M, block, inputs))
        _same_result(dev, jnp_)
        _same_result(nump, jnp_)


def test_device_step_on_an_empty_block():
    """A chunk with no keys: no max over an empty plane, nothing flagged,
    an empty block back in the block dtypes."""
    tab = pv.compile_pattern(_corpus("port", "no_skip")["times_1_3"])
    block, inputs = _random_block(np.random.default_rng(0), 0, 4, 4, 2)
    res, m = pv.step_device(tab, 4, block, inputs, "cpu")
    ref, m_ref = pv.step_numpy(tab, 4, block, inputs)
    _same_result((res, m), (ref, m_ref))
    assert res.match_kc.shape == (0, 2)


def test_device_step_counts_its_bytes_and_replays():
    tab = pv.compile_pattern(_corpus("port", "no_skip")["one_or_more_within"])
    block, inputs = _random_block(np.random.default_rng(3), 40, 4, 4, 2)
    counters = {}
    pv.step_device(tab, 4, block, inputs, "cpu", counters)
    up = sum(np.asarray(a).nbytes for a in (*block, *inputs))
    # without the caller's planes the step uploads (and counts) the table
    assert counters["h2d_bytes"] == up + pv.table_bytes(tab)
    assert counters["d2h_bytes"] >= 3
    assert counters.get("replayed", 0) in (0, 1)
    given = {}
    got = pv.step_device(tab, 4, block, inputs, "cpu", given,
                         pv.table_planes(tab, "cpu"))
    assert given["h2d_bytes"] == up
    _same_result(got, pv.step_numpy(tab, 4, block, inputs))


# ---------------------------------------------------------------------------
# plan-time classifier, compiled table, packing and the rolling hash
# ---------------------------------------------------------------------------

def _classify_both(build):
    return (jv.classify_pattern(build("jax")),
            pv.classify_pattern(build("port")))


def test_classifier_rejects_followed_by_any():
    def build(side):
        P = SIDES[side]["pat"].Pattern
        return (P.begin("a").where(_is("a"))
                .followed_by_any("b").where(_is("b")))
    j, p = _classify_both(build)
    assert j == p
    ok, reasons = p
    assert not ok and any("relaxed_any" in r for r in reasons)


def test_classifier_rejects_greedy():
    def build(side):
        P = SIDES[side]["pat"].Pattern
        return (P.begin("a").where(_is("a")).one_or_more().greedy()
                .followed_by("b").where(_is("b")))
    j, p = _classify_both(build)
    assert j == p
    ok, reasons = p
    assert not ok and any("greedy" in r for r in reasons)


def test_classifier_accepts_full_eligible_surface():
    def build(side):
        P = SIDES[side]["pat"].Pattern
        return (P.begin("a").where(_is("a")).times(1, 3)
                .not_followed_by("nb").where(_is("b"))
                .followed_by("c").where(_is("c")).optional()
                .followed_by("d").where(_is("e")).within(100))
    j, p = _classify_both(build)
    assert j == p == (True, [])


@pytest.mark.parametrize("skip", SKIPS)
def test_compiled_tables_equal(skip):
    for name in _corpus("jax", skip):
        tj = jv.compile_pattern(_corpus("jax", skip)[name])
        tp = pv.compile_pattern(_corpus("port", skip)[name])
        for f in ("n_stages", "within", "skip_past", "trailing_negation",
                  "has_until"):
            assert getattr(tj, f) == getattr(tp, f), (name, f)
        for f in ("strict", "negated", "optional", "tmin", "tmax"):
            a, b = getattr(tj, f), getattr(tp, f)
            assert a.dtype == b.dtype and np.array_equal(a, b), (name, f)
        assert jv._table_key(tj) == (tp.n_stages,
                                     *(tuple(getattr(tp, f).tolist())
                                       for f in ("strict", "negated",
                                                 "optional", "tmin",
                                                 "tmax")),
                                     tp.within, tp.skip_past,
                                     tp.trailing_negation, tp.has_until)


_WRAP = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF, 0x100000000,
                  0x17FFFFFFF, (1 << 47) - 1, (1 << 48) | 0xFFFFFFFF,
                  (3 << 48) | 0x80000000, (7 << 48) | ((1 << 48) - 1),
                  np.iinfo(np.int64).max], np.int64)


def test_event_list_hash_equal_at_the_int32_wrap_edges():
    """The rolling hash over packed pointers whose words sit at the int32
    edges, over lists long enough to wrap many times: the port's numpy
    hash, JAX's, and the torch step's incremental update agree."""
    rng = np.random.default_rng(4)
    rows = [_WRAP, _WRAP[::-1], np.repeat(_WRAP[3:5], 40),
            rng.choice(_WRAP, 200), np.zeros(0, np.int64)]
    for row in rows:
        h = pv.event_list_hash(row)
        assert h == jv.event_list_hash(row) and h.dtype == np.int32
        t = torch.zeros(1, dtype=torch.int32)
        packed = torch.from_numpy(np.ascontiguousarray(row))
        for i in range(row.size):
            t = t * int(pv._HASH_MUL) + pv._torch_fold32(packed[i:i + 1])
        assert t.dtype == torch.int32 and int(t[0]) == int(h)
        folded = pv._fold32(row)
        assert np.array_equal(folded, jv._fold32(row))
        assert np.array_equal(pv._torch_fold32(packed).numpy(), folded)


def test_pack_unpack_round_trip_equals_jax():
    for stage, eid in ((0, 0), (3, (1 << 48) - 1), (7, 12345), (1, 1 << 40)):
        p = pv.pack_event(stage, eid)
        assert p == jv.pack_event(stage, eid)
        row = np.array([p, p], np.int64)
        assert pv.unpack_events(row) == jv.unpack_events(row) \
            == ((stage, eid), (stage, eid))


# ---------------------------------------------------------------------------
# engine resolution, overrides, refusals
# ---------------------------------------------------------------------------

def test_vectorized_on_raises_for_ineligible_pattern():
    for side in SIDES:
        P = SIDES[side]["pat"].Pattern
        p = (P.begin("a").where(_is("a"))
             .followed_by_any("b").where(_is("b")))
        with pytest.raises(ValueError, match="not eligible"):
            SIDES[side]["op"].CepOperator(p, "k", _sel, vectorized="on",
                                          **SIDES[side]["kw"])


def test_deferred_conditions_fall_back_interpreted():
    st = {}
    for side in SIDES:
        P = SIDES[side]["pat"].Pattern
        p = P.begin("a").where(_is("a")).followed_by("b").where(_is("b"))
        op = SIDES[side]["op"].CepOperator(p, "k", _sel,
                                           defer_conditions=True,
                                           vectorized="auto",
                                           **SIDES[side]["kw"])
        op._resolve_engine()
        st[side] = op.cep_stats()
    assert st["port"] == st["jax"]
    assert st["port"]["engine"] == "interpreted"
    assert any("deferred" in r or "PREV" in r
               for r in st["port"]["fallback_reasons"])


def test_ineligible_pattern_auto_falls_back():
    chunks, wms = _stream(2, n=40)
    got = {}
    for side in SIDES:
        P = SIDES[side]["pat"].Pattern
        p = (P.begin("a").where(_is("a")).one_or_more().greedy()
             .followed_by("b").where(_is("b")))
        op = _op(side, p, "auto")
        rows, _ = _feed(side, op, chunks, wms)
        assert op.cep_stats()["engine"] == "interpreted"
        got[side] = rows, _op(side, p, "off")
    assert got["port"][0] == got["jax"][0]
    assert got["port"][0] == _feed("port", got["port"][1], chunks, wms)[0]


@pytest.mark.parametrize("value,engine", [("off", "interpreted"),
                                          ("on", "vectorized")])
def test_env_override_forces_engine(monkeypatch, value, engine):
    """``FLINK_TPU_CEP_VECTORIZED`` pins ``auto`` in both packages (no
    measurement), as ``FLINK_TPU_DEVICE_PROBE`` does."""
    monkeypatch.setenv("FLINK_TPU_CEP_VECTORIZED", value)
    monkeypatch.setattr(pv, "_measure_vectorized", None)
    monkeypatch.setattr(jv, "_measure_vectorized", None)
    for side in SIDES:
        P = SIDES[side]["pat"].Pattern
        p = P.begin("a").where(_is("a")).followed_by("b").where(_is("b"))
        op = _op(side, p, "auto")
        op._resolve_engine()
        assert op.cep_stats()["engine"] == engine, side


@pytest.mark.parametrize("value,kernel", [
    ("numpy", "numpy"), ("np", "numpy"), ("host", "numpy"),
    ("jit", "device"), ("jax", "device"), ("device", "device"),
    ("", None)])
def test_env_override_picks_the_step(monkeypatch, value, kernel):
    """``FLINK_TPU_CEP_KERNEL`` takes JAX's values; unset, the step follows
    the operator's device (numpy on the CPU, as JAX's CPU verdict)."""
    monkeypatch.setenv("FLINK_TPU_CEP_KERNEL", value)
    assert pv.default_kernel("cpu") == (kernel or "numpy")
    assert pv.default_kernel(torch.device("cuda")) == (kernel or "device")
    assert jv.default_kernel() == {"numpy": "numpy", "device": "jit",
                                   None: "numpy"}[kernel]
    p = (ppat.Pattern.begin("a").where(_is("a"))
         .followed_by("b").where(_is("b")))
    op = _op("port", p, "on")
    op._resolve_engine()
    assert op._vec.kernel == (kernel or "numpy")


def test_calibration_measures_once_per_device_and_resets(monkeypatch):
    """``auto`` measures on the operator's device once (one warm run, then
    best of two per engine, as JAX) and caches the verdict; the reset hook
    drops it."""
    monkeypatch.delenv("FLINK_TPU_CEP_VECTORIZED", raising=False)
    calls = []
    monkeypatch.setattr(pv, "_measure_vectorized",
                        lambda device=None: calls.append(device) or False)
    assert pv.calibrated_vectorized_cep("cpu") is False
    assert pv.calibrated_vectorized_cep("cpu") is False
    assert calls == ["cpu"]
    pv._reset_calibration()
    assert pv.calibrated_vectorized_cep("cpu") is False
    assert calls == ["cpu", "cpu"]


def test_measured_calibration_reports_both_timings(monkeypatch):
    monkeypatch.delenv("FLINK_TPU_CEP_VECTORIZED", raising=False)
    verdict = pv.calibrated_vectorized_cep("cpu")
    m = pv.last_measurement["cpu"]
    assert verdict == (m["vectorized_s"] <= m["interpreted_s"])
    assert m["vectorized_s"] > 0 and m["interpreted_s"] > 0


def test_cep_and_pattern_stream_refuse_until_the_runtime_stack():
    """The name is from when the DataStream entry refused: since the local
    job path's slice ``CEP`` and ``PatternStream`` are the package's, with
    JAX's exports, and ``CEP.pattern(keyed, pattern)`` is a
    ``PatternStream`` over that stream (its jobs are held to JAX's in
    ``tests/test_torch_job_routes.py``)."""
    import flink_tpu_torch.cep as pcep
    for name in ("CEP", "PatternStream"):
        assert getattr(pcep, name) is getattr(pop, name)
    assert not hasattr(pop, "LATER_DATASTREAM")
    with pytest.raises(AttributeError):
        getattr(pcep, "NoSuchName")
    assert set(pcep.__all__) == set(__import__(
        "flink_tpu.cep", fromlist=["x"]).__all__)
    ps = pcep.CEP.pattern("a keyed stream", "a pattern")
    assert isinstance(ps, pcep.PatternStream)
    assert (ps.keyed, ps.pattern) == ("a keyed stream", "a pattern")


def test_vectorized_engine_refuses_object_keys():
    """String keys (the name is from when the engine refused them): the
    vectorized engine maps them through ``ObjectKeyIndex`` (``_VecState.
    map_keys``) and its matches, with both step kernels, equal JAX's
    interpreted engine; snapshots restore across the packages."""
    from flink_tpu_torch.state.keyindex import ObjectKeyIndex

    chunks, wms = _stream(21)
    chunks = [[(f"u{k}", kind, t) for k, kind, t in c] for c in chunks]
    for kernel, name in [(kernel, name) for kernel in ("numpy", "device")
                         for name in ("followed_by", "times_1_3",
                                      "not_followed_by")]:
        want, jsnaps = _feed("jax", _op("jax", _corpus(
            "jax", "no_skip")[name], "off"),
            chunks, wms, snap_at=(len(chunks) // 2,))
        op = _op("port", _corpus(
            "port", "no_skip")[name], "on",
            kernel=kernel)
        got, snaps = _feed("port", op, chunks, wms,
                           snap_at=(len(chunks) // 2,))
        assert got == want and want, (kernel, name)
        assert isinstance(op._vec.index, ObjectKeyIndex)
        assert _snap_eq(_neutral(snaps[0], "port"),
                        _neutral(jsnaps[0], "jax"))


def test_operator_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    p = (ppat.Pattern.begin("a").where(_is("a"))
         .followed_by("b").where(_is("b")))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pop.CepOperator(p, "k", _sel)


# ---------------------------------------------------------------------------
# snapshots across engines and packages + sticky growth + lazy rows
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("first,second", [
    (("port", "on"), ("port", "off")), (("port", "off"), ("port", "on")),
    (("port", "on"), ("jax", "on")), (("jax", "on"), ("port", "on")),
    (("port", "off"), ("jax", "off")), (("jax", "off"), ("port", "on"))])
def test_cross_engine_restore(first, second):
    """A mid-stream snapshot from either engine of either package restores
    into the other and continues with identical rows."""
    chunks, wms = _stream(5, n=80)
    half = len(chunks) // 2
    pat = lambda s: _corpus(s, "no_skip")["one_or_more_within"]  # noqa: E731
    ref, _ = _feed("jax", _op("jax", pat("jax"), "off"), chunks, wms)

    (s1, m1), (s2, m2) = first, second
    op1 = _op(s1, pat(s1), m1)
    rows1, _ = _feed(s1, op1, chunks[:half], wms[:half], end=False)
    snap = op1.snapshot_state()
    if s1 != s2:
        snap = (cep_snapshot_from_jax(snap) if s2 == "port"
                else cep_snapshot_to_jax(snap, jop._Partial))
    op2 = _op(s2, pat(s2), m2)
    op2.restore_state(snap)
    rows2, _ = _feed(s2, op2, chunks[half:], wms[half:])
    assert rows1 + rows2 == ref


def test_sticky_growth_from_tiny_caps():
    """Long oneOrMore runs overflow the initial partial/event-ring caps; the
    sticky pow2 growth keeps bit-identity with JAX, on both steps."""
    evs = [(1, "a", t) for t in range(9)] + [(1, "b", 9)]
    ref = None
    for side, kernel in (("jax", "numpy"), ("port", "numpy"),
                         ("port", "device")):
        P = SIDES[side]["pat"].Pattern
        p = (P.begin("a").where(_is("a")).one_or_more()
             .followed_by("b").where(_is("b")))
        op = _op(side, p, "on", kernel)
        rows, _ = _feed(side, op, [evs], [100])
        assert len(rows) == 45
        assert op._vec.m_cap > 4 and op._vec.e_cap > 4
        caps = (op._vec.m_cap, op._vec.e_cap)
        ref = ref or (rows, caps)
        assert (rows, caps) == ref, (side, kernel)


def test_process_batch_never_materializes_rows_upfront():
    p = (ppat.Pattern.begin("a").where(_is("a"))
         .followed_by("b").where(_is("b")))

    class NoRows(RecordBatch):
        def to_rows(self):
            raise AssertionError("to_rows called on the ingest path")

    for mode, kernel in PORT_ENGINES:
        op = _op("port", p, mode, kernel)
        b = NoRows({"k": np.zeros(4, np.int64),
                    "kind": np.asarray(["a", "x", "b", "x"], object)},
                   timestamps=np.arange(4, dtype=np.int64))
        op.process_batch(b)
        out = op.process_watermark(Watermark(100))
        assert sum(len(x) for x in out) == 1


def test_row_store_prunes_unreferenced_batches():
    for side in SIDES:
        P = SIDES[side]["pat"].Pattern
        p = P.begin("a").where(_is("a")).next("b").where(_is("b"))
        for mode in ("on", "off"):
            op = _op(side, p, mode)
            for lo in range(0, 500, 50):
                kk = np.asarray(["x"] * 50, object)
                b = SIDES[side]["RB"](
                    {"k": np.zeros(50, np.int64), "kind": kk},
                    timestamps=np.arange(lo, lo + 50, dtype=np.int64))
                op.process_batch(b)
                op.process_watermark(SIDES[side]["WM"](lo + 49))
            assert op.cep_stats()["batches"] == 0, (side, mode)
            snap = op.snapshot_state()
            assert sum(len(r) for _p, _s, r in snap["nfas"].values()) == 0


# ---------------------------------------------------------------------------
# chaos: mid-job quarantine degrades to the interpreted path
# ---------------------------------------------------------------------------

def _wedge_pass(side, inject, kernel=None):
    S = SIDES[side]
    dh, chaos = S["dh"], S["chaos"]
    P = S["pat"].Pattern
    pattern = (P.begin("a").where(_is("a"))
               .followed_by("b").where(_is("b")).within(30))
    rng = np.random.default_rng(9)
    kinds = ["a", "b", "x"]
    evs = [(int(rng.integers(0, 8)), kinds[rng.integers(0, 3)], t)
           for t in range(80)]
    mon = dh.DeviceHealthMonitor(dh.WatchdogConfig(deadline_floor_s=0.5),
                                 heal_async=False)
    dh.set_monitor(mon)
    inj = chaos.FaultInjector(seed=3)
    wedge = chaos.WedgedDevice(at=4)
    if inject:
        inj.inject("device.dispatch", wedge)
    op = _op(side, pattern, "on", kernel)
    out = []
    try:
        with chaos.installed(inj):
            for lo in range(0, len(evs), 8):
                ch = evs[lo:lo + 8]
                ks = np.asarray([e[0] for e in ch], np.int64)
                kk = np.asarray([e[1] for e in ch], object)
                ts = np.asarray([e[2] for e in ch], np.int64)
                out += op.process_batch(S["RB"]({"k": ks, "kind": kk},
                                                timestamps=ts))
                out += op.process_watermark(S["WM"](int(ts.max())))
            out += op.end_input()
    finally:
        wedge.heal()        # release the sacrificed lane thread
    counters = {k: mon.counters[k] for k in ("quarantines",
                                             "watchdog_timeouts",
                                             "dispatches")}
    return _rows(out), op.cep_stats(), counters, dict(mon.label_counts)


@pytest.mark.chaos
@pytest.mark.parametrize("kernel", ["numpy", "device"])
def test_wedged_drain_degrades_digest_identical(kernel):
    """A ``WedgedDevice`` at the fourth ``cep.vectorized_drain`` dispatch:
    both packages quarantine, degrade mid-job to the interpreted engine and
    re-drain the identical pending events — rows, stats and the monitors'
    counters equal JAX's, and equal an unfaulted pass."""
    j_clean = _wedge_pass("jax", False)
    j_wedged = _wedge_pass("jax", True)
    p_clean = _wedge_pass("port", False, kernel)
    p_wedged = _wedge_pass("port", True, kernel)
    assert p_clean == j_clean
    assert p_wedged[:3] == j_wedged[:3]
    assert p_wedged[0] == p_clean[0]
    assert p_wedged[1]["engine"] == "interpreted"
    assert p_wedged[1]["degraded"] == 1
    assert p_wedged[2]["quarantines"] == 1
    assert p_wedged[2]["watchdog_timeouts"] == 1
    assert p_wedged[3] == {"cep.vectorized_drain": 4}


def test_quarantined_monitor_degrades_before_dispatch():
    got = {}
    for side in SIDES:
        S = SIDES[side]
        dh = S["dh"]
        mon = dh.DeviceHealthMonitor(dh.WatchdogConfig(deadline_floor_s=0.5),
                                     heal_async=False)
        dh.set_monitor(mon)
        mon.quarantine("test")
        P = S["pat"].Pattern
        p = P.begin("a").where(_is("a")).followed_by("b").where(_is("b"))
        op = _op(side, p, "on")
        op.process_batch(S["RB"](
            {"k": np.zeros(2, np.int64),
             "kind": np.asarray(["a", "b"], object)},
            timestamps=np.arange(2, dtype=np.int64)))
        out = op.process_watermark(S["WM"](10))
        got[side] = _rows(out), op.cep_stats(), mon.counters["dispatches"]
    assert got["port"] == got["jax"]
    rows, st, dispatches = got["port"]
    assert len(rows) == 1 and dispatches == 0
    assert st["engine"] == "interpreted" and st["degraded"] == 1


def test_partial_set_tripling_in_one_step():
    """A step that nearly triples one hot key's partial set (M_out > 3M+1
    after pow2 growth): the host step pads, the device step flags and
    replays — both equal JAX."""
    for name in ("until_loop", "one_or_more_within", "times_1_3"):
        for seed in (37, 41):
            chunks, wms = _stream(seed, n=120, n_keys=4)
            jp = _corpus("jax", "no_skip")[name]
            ref, _ = _feed("jax", _op("jax", jp, "off"), chunks, wms)
            for mode, kernel in PORT_ENGINES:
                op = _op("port", _corpus("port", "no_skip")[name], mode,
                         kernel)
                rows, _ = _feed("port", op, chunks, wms)
                assert rows == ref, (name, seed, mode, kernel)


def test_cep_stats_never_runs_calibration(monkeypatch):
    monkeypatch.setattr(pv, "_measure_vectorized", None)
    p = (ppat.Pattern.begin("a").where(_is("a"))
         .followed_by("b").where(_is("b")))
    st = _op("port", p, "auto").cep_stats()
    assert st["engine"] == "unresolved"


# ---------------------------------------------------------------------------
# bench.py's small equivalence stream, all engines of both packages
# ---------------------------------------------------------------------------

def _cep_batches(n_records, n_keys, batch_size, window_ms, seed=23):
    """``bench.py`` ``_cep_batches``."""
    rng = np.random.default_rng(seed)
    batches = []
    t = 0
    for lo in range(0, n_records, batch_size):
        b = min(batch_size, n_records - lo)
        keys = rng.integers(0, n_keys, b).astype(np.int64)
        vals = (rng.random(b) * 600.0).astype(np.float64)
        ts = t + np.sort(rng.integers(0, window_ms, b)).astype(np.int64)
        t += window_ms
        batches.append((keys, vals, ts))
    return batches


def test_bench_equivalence_stream_through_every_engine(_jax_x64):
    """``bench.py --cep``'s prefix check (2^14 records, 4096 keys, batches
    of 4096, the fraud pattern): JAX's interpreted, numpy and jit engines
    and the port's interpreted, numpy and device (CPU) engines give the
    same rows in the same order."""
    window_ms = 5000
    batches = _cep_batches(1 << 14, 4096, 4096, window_ms)
    got = {}
    for side in SIDES:
        S = SIDES[side]
        P = S["pat"].Pattern
        pattern = (P.begin("small")
                   .where(lambda c: np.asarray(c["v"]) < 30.0)
                   .followed_by("large")
                   .where(lambda c: np.asarray(c["v"]) > 570.0)
                   .within(4 * window_ms))
        select = (lambda m: {"k": m["small"][0]["k"],
                             "amount": m["large"][0]["v"]})
        kernels = (("off", None), ("on", "numpy"),
                   ("on", "jit" if side == "jax" else "device"))
        for mode, kernel in kernels:
            op = _op(side, pattern, mode, kernel, select)
            out = []
            for keys, vals, ts in batches:
                out += op.process_batch(S["RB"]({"k": keys, "v": vals},
                                                timestamps=ts))
                out += op.process_watermark(S["WM"](int(ts.max()) - 1))
            out += op.end_input()
            got[(side, mode, kernel)] = _rows(out), _stats(op)["matches"]
    first = next(iter(got.values()))
    assert first[1] > 50
    for key, val in got.items():
        assert val == first, key


def test_partial_codecs_equal_jax_and_each_other():
    """``encode_partials``/``decode_partials`` equal JAX's key by key, and
    the batched codecs the operator's snapshot, restore and degrade use
    (``encode_partial_lists``/``decode_partial_lists``) give every key's
    rows at the caps the last key would leave."""
    rng = np.random.default_rng(12)
    lists = []
    for _ in range(40):
        ps = []
        for _ in range(int(rng.integers(0, 7))):
            n = int(rng.integers(0, 11))
            events = tuple((int(rng.integers(0, 4)),
                            int(rng.integers(0, 2 ** 47))) for _ in range(n))
            ps.append(pop._Partial(int(rng.integers(0, 4)),
                                   int(rng.integers(0, 3)), events,
                                   int(rng.integers(-5, 10 ** 6))
                                   if n else int(np.iinfo(np.int64).min)))
        lists.append(ps)
    rows, m_cap, e_cap = pv.encode_partial_lists(lists, 4, 4)
    m, e = 4, 4
    for i, ps in enumerate(lists):
        j_ps = [jop._Partial(p.stage_i, p.count, p.events, p.first_ts)
                for p in ps]
        mine, ref = pv.encode_partials(ps, 4, 4), jv.encode_partials(j_ps,
                                                                    4, 4)
        assert mine[1:] == ref[1:]
        for a, b in zip(mine[0], ref[0]):
            a, b = np.asarray(a), np.asarray(b)
            assert a.dtype == b.dtype and np.array_equal(a, b)
        one, m, e = pv.encode_partials(ps, m, e)
        for plane, single in zip(rows[:6], one[:6]):
            sl = (i,) + tuple(slice(0, s) for s in single.shape)
            assert np.array_equal(plane[sl], single)
        assert rows[6][i] == len(ps)
        assert pv.decode_partials(one, len(ps)) == ps
        back = jv.decode_partials(one, len(ps))
        assert [tuple(vars(p).values()) for p in back] == \
            [tuple(vars(p).values()) for p in ps]
    assert (m_cap, e_cap) == (m, e)
    assert pv.decode_partial_lists(*rows[:5], rows[6]) == lists


def test_no_device_means_the_card(monkeypatch):
    """``None`` is the card in the engine pick and its calibration: with no
    card they raise instead of measuring or picking the CPU's step; the
    CPU's verdicts, asked for by name, are unchanged."""
    monkeypatch.delenv("FLINK_TPU_CEP_VECTORIZED", raising=False)
    monkeypatch.delenv("FLINK_TPU_CEP_KERNEL", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(pv, "_calibrated", {})
    for call in (pv.calibrated_vectorized_cep, pv.default_kernel,
                 pv._measure_vectorized):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert pv._calibrated == {}
    assert pv.default_kernel("cpu") == "numpy"
    assert pv.default_kernel(torch.device("cuda")) == "device"
    calls = []
    monkeypatch.setattr(pv, "_measure_vectorized",
                        lambda device=None: calls.append(device) or False)
    assert pv.calibrated_vectorized_cep("cpu") is False
    assert calls == ["cpu"] and pv._calibrated == {"cpu": False}
