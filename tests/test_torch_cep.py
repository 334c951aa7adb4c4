"""Port parity for CEP: the cases of ``tests/test_cep.py`` through
``flink_tpu_torch.cep`` and ``flink_tpu.cep`` on the CPU.

The reference drives its cases through the DataStream API
(``CEP.pattern(...).select(...)``), which the port does not have yet; here
both packages' ``CepOperator`` are driven directly on the same rows, in two
cuts — all rows in one batch, and one row a batch with a watermark after
each and a snapshot half way — and must agree BIT FOR BIT: the match rows in
the same order with the same timestamps, ``cep_stats()``, and the snapshots
(compared field by field in the neutral layout of
:func:`~flink_tpu_torch.interop.cep_snapshot_to_jax`).  The half-way
snapshot of each package restores into the other and finishes the stream
with the rows of the uninterrupted run.  Each case also asserts the
reference test's own expectation on the port's rows.  Every case runs the
port's interpreted, numpy-step and device-step (CPU tensors) engines,
string-keyed cases too (the batched engine maps them through
``ObjectKeyIndex``).  ``split_snapshot``/``merge_snapshots`` equal
JAX's.
"""

import numpy as np
import pytest

from flink_tpu.cep import operator as jop
from flink_tpu.cep import pattern as jpat
from flink_tpu.cep import vectorized as jv
from flink_tpu.core.batch import RecordBatch as JaxBatch
from flink_tpu.core.batch import Watermark as JaxWatermark
from flink_tpu_torch.cep import operator as pop
from flink_tpu_torch.cep import pattern as ppat
from flink_tpu_torch.cep import vectorized as pv
from flink_tpu_torch.core.batch import RecordBatch, Watermark
from flink_tpu_torch.interop import cep_snapshot_from_jax, cep_snapshot_to_jax

SIDES = {
    "jax": dict(op=jop, pat=jpat, RB=JaxBatch, WM=JaxWatermark, kw={}),
    "port": dict(op=pop, pat=ppat, RB=RecordBatch, WM=Watermark,
                 kw={"device": "cpu"}),
}
END = 1 << 40


@pytest.fixture(autouse=True)
def calibration(monkeypatch):
    """``auto`` resolves without measuring (the verdicts are pinned to the
    batched engine in both packages and dropped afterwards)."""
    monkeypatch.setenv("FLINK_TPU_CEP_VECTORIZED", "on")
    jv._reset_calibration()
    pv._reset_calibration()
    yield
    jv._reset_calibration()
    pv._reset_calibration()


def _is(kind, col="kind"):
    return lambda cols: np.asarray(cols[col]) == kind


def _columns(rows):
    cols = {}
    for c in rows[0]:
        vals = [r[c] for r in rows]
        cols[c] = (np.asarray(vals, object) if isinstance(vals[0], str)
                   else np.asarray(vals, np.int64))
    return cols


def _out_rows(out):
    return [tuple(sorted((c, repr(b.columns[c][i])) for c in b.columns))
            + (int(np.asarray(b.timestamps)[i]),)
            for b in out for i in range(len(b))]


def _neutral(snap, side):
    return (cep_snapshot_to_jax(snap) if side == "port"
            else cep_snapshot_to_jax(cep_snapshot_from_jax(snap)))


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


def _make(side, build, select, mode, kernel=None):
    S = SIDES[side]
    op = S["op"].CepOperator(build(S["pat"]), "k", select, vectorized=mode,
                             **S["kw"])
    if kernel is not None:
        op._resolve_engine()
        op._vec.kernel = kernel
    return op


def _feed(side, op, pieces, start=0, stop=None, snap_after=None):
    """``pieces``: list of row lists, each one batch followed by a
    watermark at its last timestamp."""
    S = SIDES[side]
    out, snap = [], None
    for j, rows in enumerate(pieces[start:stop], start):
        ts = np.asarray([r["ts"] for r in rows], np.int64)
        out += op.process_batch(S["RB"](_columns(rows), timestamps=ts))
        out += op.process_watermark(S["WM"](int(ts.max())))
        if j == snap_after:
            snap = op.snapshot_state()
    return out, snap


def _run_case(build, rows, select):
    """Both packages, every engine the keys allow, two cuts; returns the
    port's rows of the one-batch cut (for the reference's assertion)."""
    engines = [("off", None), ("on", "numpy"), ("on", "device")]
    cuts = {"one batch": [rows], "row by row": [[r] for r in rows]}
    first = None
    for cut, pieces in cuts.items():
        mid = len(pieces) // 2
        ref_op = _make("jax", build, select, "off")
        out, ref_snap = _feed("jax", ref_op, pieces, snap_after=mid)
        out += ref_op.process_watermark(JaxWatermark(END))
        out += ref_op.end_input()
        ref = _out_rows(out)
        ref_stats = ref_op.cep_stats()
        ref_final = _neutral(ref_op.snapshot_state(), "jax")
        for mode, kernel in engines:
            op = _make("port", build, select, mode, kernel)
            out, snap = _feed("port", op, pieces, snap_after=mid)
            out += op.process_watermark(Watermark(END))
            out += op.end_input()
            got = _out_rows(out)
            assert got == ref, (cut, mode, kernel)
            stats = op.cep_stats()
            if mode == "off":
                assert stats == ref_stats, (cut, mode)
            else:
                assert stats["matches"] == ref_stats["matches"]
                assert (stats["partials_high_water"]
                        == ref_stats["partials_high_water"])
            assert _snap_eq(_neutral(op.snapshot_state(), "port"),
                            ref_final), (cut, mode, kernel)
            if snap is not None:
                assert _snap_eq(_neutral(snap, "port"),
                                _neutral(ref_snap, "jax")), (cut, mode)
                _restores_across(build, select, pieces, mid, snap, ref_snap,
                                 mode, kernel, ref)
            if first is None:
                first = got
    return [dict((c, eval(v)) for c, v in r[:-1]) for r in first]


def _restores_across(build, select, pieces, mid, port_snap, jax_snap, mode,
                     kernel, ref):
    """The port's half-way snapshot finishes in JAX, JAX's in the port:
    both give the uninterrupted run's rows."""
    head_j = _make("jax", build, select, "off")
    head, _ = _feed("jax", head_j, pieces, stop=mid + 1)
    for side, snap in (("jax", cep_snapshot_to_jax(port_snap, jop._Partial)),
                       ("port", cep_snapshot_from_jax(jax_snap))):
        op = (_make(side, build, select, "off") if side == "jax"
              else _make(side, build, select, mode, kernel))
        op.restore_state(snap)
        out, _ = _feed(side, op, pieces, start=mid + 1)
        out += op.process_watermark(SIDES[side]["WM"](END))
        out += op.end_input()
        assert _out_rows(head) + _out_rows(out) == ref, side


# ---------------------------------------------------------------------------
# the cases of tests/test_cep.py
# ---------------------------------------------------------------------------

def test_followed_by_basic():
    def build(P):
        return (P.Pattern.begin("start").where(_is("a", "type"))
                .followed_by("end").where(_is("b", "type")))
    rows = [{"k": "u", "type": "a", "v": 1, "ts": 1},
            {"k": "u", "type": "x", "v": 2, "ts": 2},
            {"k": "u", "type": "b", "v": 3, "ts": 3},
            {"k": "w", "type": "b", "v": 9, "ts": 4}]
    out = _run_case(build, rows, lambda m: {
        "k": m["start"][0]["k"], "sv": m["start"][0]["v"],
        "ev": m["end"][0]["v"]})
    assert out == [{"k": "u", "sv": 1, "ev": 3}]


def _t_rows(spec, key=0):
    return [{"k": key, "t": t, "ts": ts} for t, ts in spec]


def test_next_strict_contiguity():
    def build(P):
        return (P.Pattern.begin("a").where(_is("a", "t"))
                .next("b").where(_is("b", "t")))
    rows = _t_rows([("a", 1), ("x", 2), ("b", 3), ("a", 4), ("b", 5)], 1)
    out = _run_case(build, rows, lambda m: {
        "at": m["a"][0]["ts"], "bt": m["b"][0]["ts"]})
    assert out == [{"at": 4, "bt": 5}]


def test_times_quantifier():
    def build(P):
        return (P.Pattern.begin("a").where(_is("a", "t")).times(2)
                .followed_by("b").where(_is("b", "t")))
    out = _run_case(build, _t_rows([("a", 1), ("a", 2), ("b", 3)]),
                    lambda m: {"n_a": len(m["a"]), "bt": m["b"][0]["ts"]})
    assert {"n_a": 2, "bt": 3} in out


def test_one_or_more():
    def build(P):
        return (P.Pattern.begin("a").where(_is("a", "t")).one_or_more()
                .followed_by("b").where(_is("b", "t")))
    out = _run_case(build, _t_rows([("a", 1), ("a", 2), ("b", 3)]),
                    lambda m: {"n_a": len(m["a"])})
    assert sorted(r["n_a"] for r in out) == [1, 1, 2]


def test_optional_stage():
    def build(P):
        return (P.Pattern.begin("a").where(_is("a", "t"))
                .followed_by("mid").where(_is("m", "t")).optional()
                .followed_by("b").where(_is("b", "t")))
    out = _run_case(build, _t_rows([("a", 1), ("b", 2)]),
                    lambda m: {"has_mid": int("mid" in m)})
    assert {"has_mid": 0} in out


def test_within_window():
    def build(P):
        return (P.Pattern.begin("a").where(_is("a", "t"))
                .followed_by("b").where(_is("b", "t")).within(10))
    out = _run_case(build,
                    _t_rows([("a", 0), ("b", 50), ("a", 60), ("b", 65)]),
                    lambda m: {"at": m["a"][0]["ts"], "bt": m["b"][0]["ts"]})
    assert out == [{"at": 60, "bt": 65}]


def test_skip_past_last_event():
    def build(P):
        return (P.Pattern.begin(
            "a", skip_strategy=P.AfterMatchSkipStrategy.SKIP_PAST_LAST_EVENT)
            .where(_is("a", "t")).followed_by("b").where(_is("b", "t")))
    out = _run_case(build,
                    _t_rows([("a", 1), ("a", 2), ("b", 3), ("b", 4)]),
                    lambda m: {"at": m["a"][0]["ts"], "bt": m["b"][0]["ts"]})
    assert out in ([{"at": 1, "bt": 3}],
                   [{"at": 1, "bt": 3}, {"at": 2, "bt": 3}])


def test_keyed_isolation():
    def build(P):
        return (P.Pattern.begin("a").where(_is("a", "t"))
                .next("b").where(_is("b", "t")))
    rows = [{"k": 1, "t": "a", "ts": 1}, {"k": 2, "t": "b", "ts": 2},
            {"k": 2, "t": "a", "ts": 3}, {"k": 2, "t": "b", "ts": 4}]
    out = _run_case(build, rows, lambda m: {"k": m["a"][0]["k"]})
    assert out == [{"k": 2}]


def test_followed_by_any():
    """Ineligible for the batched engine: both packages run it
    interpreted (``auto`` resolves there; ``on`` raises in both)."""
    def build(P):
        return (P.Pattern.begin("a").where(_is("a", "t"))
                .followed_by_any("b").where(_is("b", "t")))
    select = lambda m: {"bt": m["b"][0]["ts"]}  # noqa: E731
    rows = _t_rows([("a", 1), ("b", 2), ("b", 3)])
    got = {}
    for side in SIDES:
        op = _make(side, build, select, "auto")
        out, _ = _feed(side, op, [rows])
        out += op.end_input()
        got[side] = _out_rows(out), op.cep_stats()
        with pytest.raises(ValueError, match="not eligible"):
            _make(side, build, select, "on")
    assert got["port"] == got["jax"]
    assert got["port"][1]["engine"] == "interpreted"
    assert sorted(int(eval(r[0][1])) for r in got["port"][0]) == [2, 3]


def test_cep_rows_pruned_no_unbounded_growth():
    def build(P):
        return (P.Pattern.begin("a").where(_is(1, "v"))
                .next("b").where(_is(2, "v")))
    for mode, kernel in (("off", None), ("on", "numpy"), ("on", "device")):
        ops = {"jax": _make("jax", build, lambda m: {"ok": 1}, "off"),
               "port": _make("port", build, lambda m: {"ok": 1}, mode,
                             kernel)}
        for side, op in ops.items():
            S = SIDES[side]
            for lo in range(0, 500, 50):
                b = S["RB"]({"k": np.zeros(50, np.int64),
                             "v": np.zeros(50, np.int64) + 7},
                            timestamps=np.arange(lo, lo + 50,
                                                 dtype=np.int64))
                op.process_batch(b)
                op.process_watermark(S["WM"](lo + 49))
        port = ops["port"]
        assert sum(len(n._rows) for n in port._nfas.values()) == 0
        snap = port.snapshot_state()
        assert sum(len(r) for _, _, r in snap["nfas"].values()) == 0
        assert port.cep_stats()["batches"] == 0
        assert _snap_eq(_neutral(snap, "port"),
                        _neutral(ops["jax"].snapshot_state(), "jax"))


def _kinds_select(m):
    flat = [r["kind"] for rows in m.values() for r in rows]
    return {"names": ",".join(sorted(m.keys())), "flat": ",".join(flat)}


def _events(events):
    return [{"k": k, "kind": kind, "ts": ts} for k, kind, ts in events]


def _flat(out):
    return [r["flat"].split(",") for r in out]


def _not_next(P):
    return (P.Pattern.begin("a").where(_is("a"))
            .not_next("nb").where(_is("b"))
            .followed_by("c").where(_is("c")))


def _not_followed(P):
    return (P.Pattern.begin("a").where(_is("a"))
            .not_followed_by("nb").where(_is("b"))
            .followed_by("c").where(_is("c")))


def _trailing(P):
    return (P.Pattern.begin("a").where(_is("a"))
            .not_followed_by("nb").where(_is("b")).within(10))


def test_not_next_blocks_immediate_match():
    assert _run_case(_not_next, _events([(1, "a", 1), (1, "b", 2),
                                         (1, "c", 3)]), _kinds_select) == []
    got = _flat(_run_case(_not_next, _events([(1, "a", 1), (1, "x", 2),
                                              (1, "c", 3)]), _kinds_select))
    assert got == [["a", "c"]]


def test_not_next_same_event_can_match_following_stage():
    got = _flat(_run_case(_not_next, _events([(1, "a", 1), (1, "c", 2)]),
                          _kinds_select))
    assert got == [["a", "c"]]


def test_not_followed_by_kills_on_forbidden_event():
    assert _run_case(_not_followed, _events(
        [(1, "a", 1), (1, "x", 2), (1, "b", 3), (1, "c", 4)]),
        _kinds_select) == []
    got = _flat(_run_case(_not_followed, _events(
        [(1, "a", 1), (1, "x", 2), (1, "x", 3), (1, "c", 4)]),
        _kinds_select))
    assert got == [["a", "c"]]


def test_not_followed_by_last_requires_within():
    msgs = []
    for side in SIDES:
        P = SIDES[side]["pat"]
        p = (P.Pattern.begin("a").where(_is("a"))
             .not_followed_by("nb").where(_is("b")))
        with pytest.raises(ValueError, match="within") as err:
            SIDES[side]["op"].CepOperator(p, "k", lambda m: m,
                                          **SIDES[side]["kw"])
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


def test_trailing_not_followed_by_completes_on_window_close():
    got = _flat(_run_case(_trailing, _events(
        [(1, "a", 1), (1, "x", 5), (1, "x", 100)]), _kinds_select))
    assert got == [["a"]]
    assert _run_case(_trailing, _events(
        [(1, "a", 1), (1, "b", 5), (1, "x", 100)]), _kinds_select) == []


def test_greedy_loop_consumes_ambiguous_events():
    """Greedy loops are ineligible for the batched engine: both packages
    run them interpreted."""
    def is_num(cols):
        return np.char.isdigit(np.asarray(cols["kind"], str))

    def greedy(P):
        return (P.Pattern.begin("nums").where(is_num).one_or_more()
                .greedy().followed_by("end").where(_is("x")))

    def lazy(P):
        return (P.Pattern.begin("nums").where(is_num).one_or_more()
                .followed_by("end").where(_is("x")))

    ev = _events([(1, "1", 1), (1, "2", 2), (1, "3", 3), (1, "x", 4)])
    got_lazy = _flat(_run_case(lazy, ev, _kinds_select))
    assert len(got_lazy) == 6
    got = {}
    for side in SIDES:
        op = _make(side, greedy, _kinds_select, "off")
        out, _ = _feed(side, op, [ev])
        out += op.end_input()
        got[side] = _out_rows(out)
    assert got["port"] == got["jax"]
    got_greedy = [eval(dict((c, v) for c, v in r[:-1])["flat"]).split(",")
                  for r in got["port"]]
    assert sorted(len(m) for m in got_greedy) == [2, 3, 4]
    assert ["1", "2", "3", "x"] in got_greedy


def test_until_closes_the_loop():
    def build(P):
        return (P.Pattern.begin("a").where(_is("a")).one_or_more()
                .until(_is("s")).followed_by("end").where(_is("e")))
    got = _flat(_run_case(build, _events(
        [(1, "a", 1), (1, "a", 2), (1, "s", 3), (1, "a", 4), (1, "e", 5)]),
        _kinds_select))
    assert got
    assert all(sum(1 for x in flat if x == "a") <= 2 for flat in got)


def test_quantified_not_stage_rejected():
    for side in SIDES:
        P = SIDES[side]["pat"]
        p = P.Pattern.begin("a").where(_is("a")).not_next("nb")
        with pytest.raises(ValueError, match="quantified"):
            p.times(2)
        with pytest.raises(ValueError, match="optional"):
            p.optional()
        with pytest.raises(ValueError, match="quantified"):
            p.one_or_more()
        with pytest.raises(ValueError, match="until"):
            P.Pattern.begin("a").until(_is("s"))
        with pytest.raises(ValueError, match="greedy"):
            P.Pattern.begin("a").greedy()


def test_not_patterns_across_keys_are_independent():
    got = _flat(_run_case(_not_followed, _events(
        [(1, "a", 1), (2, "b", 2), (1, "c", 3)]), _kinds_select))
    assert got == [["a", "c"]]


def test_not_followed_by_first_match_retires_watcher():
    got = _flat(_run_case(_not_followed, _events(
        [(1, "a", 1), (1, "c", 2), (1, "c", 3)]), _kinds_select))
    assert got == [["a", "c"]]


def test_greedy_until_closing_event_completes():
    def build(P):
        return (P.Pattern.begin("nums")
                .where(lambda c: np.char.isdigit(np.asarray(c["kind"], str)))
                .one_or_more().greedy().until(_is("9"))
                .followed_by("end").where(_is("x")))
    ev = _events([(1, "1", 1), (1, "2", 2), (1, "9", 3), (1, "x", 4)])
    got = {}
    for side in SIDES:
        op = _make(side, build, _kinds_select, "off")
        out, _ = _feed(side, op, [ev])
        out += op.end_input()
        got[side] = _out_rows(out), op.cep_stats()
    assert got["port"] == got["jax"]
    flats = [eval(dict((c, v) for c, v in r[:-1])["flat"]).split(",")
             for r in got["port"][0]]
    assert ["1", "2", "x"] in flats and all("9" not in f for f in flats)


def test_trailing_negation_match_timestamped_at_window_close():
    got = {}
    for side in SIDES:
        S = SIDES[side]
        for mode in ("off", "on"):
            op = _make(side, _trailing, lambda m: {"ok": 1}, mode)
            op.process_batch(S["RB"](
                {"k": np.array([1], np.int64),
                 "kind": np.asarray(["a"], object)},
                timestamps=np.array([1], np.int64)))
            out = op.process_watermark(S["WM"](END))
            got[side, mode] = [int(np.asarray(b.timestamps)[0])
                               for b in out]
    assert set(map(tuple, got.values())) == {(11,)}


# ---------------------------------------------------------------------------
# rescale: split and merge equal JAX's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("string_keys", [False, True])
def test_split_and_merge_snapshots_equal_jax(string_keys):
    """A mid-stream snapshot over 12 keys split into 1, 2 and 3 parts, and
    the parts merged back: every part and every merge equals JAX's, and
    each part restores and finishes in the port as JAX's part does."""
    rng = np.random.default_rng(6)
    kinds = ["a", "b", "c", "x"]
    keys = [f"k{i}" if string_keys else i for i in range(12)]
    ev = [(keys[int(rng.integers(0, 12))], kinds[int(rng.integers(0, 4))],
           t) for t in range(120)]
    pieces = [_events(ev[i:i + 10]) for i in range(0, 120, 10)]
    mode = "off" if string_keys else "on"
    snaps = {}
    for side in SIDES:
        op = _make(side, _not_followed, _kinds_select, mode)
        _feed(side, op, pieces, stop=6)
        snaps[side] = op.snapshot_state()
    Js, Ps = jop.CepOperator, pop.CepOperator
    for n in (1, 2, 3):
        j_parts = Js.split_snapshot(snaps["jax"], 128, n)
        p_parts = Ps.split_snapshot(snaps["port"], 128, n)
        assert len(j_parts) == len(p_parts) == n
        for a, b in zip(p_parts, j_parts):
            assert _snap_eq(_neutral(a, "port"), _neutral(b, "jax"))
        j_merged = Js.merge_snapshots(j_parts)
        p_merged = Ps.merge_snapshots(p_parts)
        assert _snap_eq(_neutral(p_merged, "port"),
                        _neutral(j_merged, "jax"))
        for part_p, part_j in zip(p_parts, j_parts):
            outs = {}
            for side, part in (("port", part_p), ("jax", part_j)):
                op = _make(side, _not_followed, _kinds_select, mode)
                op.restore_state(part)
                out, _ = _feed(side, op, pieces, start=6)
                out += op.end_input()
                outs[side] = _out_rows(out)
            assert outs["port"] == outs["jax"]
    assert Ps.merge_snapshots([]) == Js.merge_snapshots([]) == {}


def test_cep_snapshot_interop_round_trip():
    """JAX -> port -> JAX gives JAX's snapshot back field for field, its
    partial matches as JAX's own ``_Partial``."""
    ops = _make("jax", _not_followed, _kinds_select, "off")
    ev = _events([(1, "a", 1), (2, "a", 2), (1, "x", 3), (3, "c", 4)])
    _feed("jax", ops, [ev[:3], ev[3:]])
    snap = ops.snapshot_state()
    snap["buffers"][1] = [(9, 99, np.array([True, False, True]), None,
                           {"k": 1, "kind": "a", "ts": 9})]
    back = cep_snapshot_to_jax(cep_snapshot_from_jax(snap), jop._Partial)
    assert _snap_eq(back, snap)
    for partials, _s, _r in back["nfas"].values():
        assert all(type(pm) is jop._Partial for pm in partials)
    port = cep_snapshot_from_jax(snap)
    for partials, _s, _r in port["nfas"].values():
        assert all(type(pm) is pop._Partial for pm in partials)
    with pytest.raises(ValueError, match="lacks"):
        cep_snapshot_from_jax({"buffers": {}})
