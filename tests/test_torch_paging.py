"""Port parity for slice 7: cold-key paging on the device emit tier of
``flink_tpu_torch`` (``state/spill.py`` over ``csrc/spill_store.cc``,
``state/paging.py`` ``DevicePager``, the page-out/page-in helpers of
``ops/scatter.py`` and the paged ``WindowAggOperator``) against the JAX
package's paging on the CPU.

The store keeps the JAX package's cell layout and its eviction rule, so the
same puts leave the same values, the same resident bytes and the same log.
The pager makes the JAX pager's decisions, so the same calls give the same
victims, rows, bitmaps and counters.  The paged operator folds every batch
in row order and promotes a key's spilled cells back before its fold, so
its fires, snapshots and ``paging_stats`` equal the JAX paged operator's
bit for bit, and its fires equal the port's own fully resident run.  The
values are random f32, so a sum in another order would show in its bits.
JAX runs as ``tests/test_paging.py`` runs it (under the ``_jax_x64`` shim
of the other parity files), the port with ``device="cpu"``.
"""

import contextlib
import os
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.experimental
import jax.numpy as jnp

from flink_tpu.core import functions as jfn
from flink_tpu.core.batch import RecordBatch as JaxBatch
from flink_tpu.core.batch import Watermark as JaxWatermark
from flink_tpu.operators.window_agg import WindowAggOperator as JaxOp
from flink_tpu.ops import scatter as jsc
from flink_tpu.state import paging as jpg
from flink_tpu.state.spill import PaneSpillStore as JaxStore
from flink_tpu.windowing import assigners as jwin
from flink_tpu.windowing.triggers import CountTrigger
from flink_tpu_torch.core import functions as pfn
from flink_tpu_torch.core.batch import RecordBatch, Watermark
from flink_tpu_torch.interop import snapshot_from_jax, snapshot_to_jax
from flink_tpu_torch.kernels import build
from flink_tpu_torch.operators.window_agg import WindowAggOperator
from flink_tpu_torch.ops import scatter as tsc
from flink_tpu_torch.state import paging as ppg
from flink_tpu_torch.state.spill import PaneSpillStore
from flink_tpu_torch.windowing import assigners as pwin
from flink_tpu_torch.windowing.triggers import CountTrigger as PortCountTrigger

DEVICE_TIER = dict(emit_tier="device", snapshot_source="device",
                   device_sync="scatter", pipeline_depth=0)
STAT_KEYS = ("resident_keys", "spilled_keys", "evictions", "promotions",
             "capacity", "spill_mem_bytes", "spill_log_bytes")


@contextlib.contextmanager
def _jax_x64():
    with pytest.MonkeyPatch.context() as mp:
        if not hasattr(jax.experimental, "enable_x64"):
            mp.setattr(jax.experimental, "enable_x64",
                       lambda new_val=True: jax.enable_x64(new_val),
                       raising=False)
        yield


def _ctx(side):
    return _jax_x64() if side == "jax" else contextlib.nullcontext()


# ---------------------------------------------------------------------------
# operators of either package, and seeded plans driven through them
# ---------------------------------------------------------------------------

def _tumbling(window_ms=1000):
    return lambda mod: mod.TumblingEventTimeWindows.of(window_ms)


def _make(side, paging, assigner=_tumbling(), capacity_hint=1 << 13, **kw):
    """A device-tier operator of either package; ``paging`` is None or the
    keyword arguments of the side's ``PagingConfig``."""
    args = {**dict(key_column="k", value_column="v",
                   initial_key_capacity=capacity_hint, **DEVICE_TIER), **kw}
    if side == "jax":
        args.setdefault("device_probe", "off")
        pg = None if paging is None else jpg.PagingConfig(**paging)
        with _jax_x64():
            op = JaxOp(assigner(jwin), jfn.SumAggregator(jnp.float32),
                       paging=pg, **args)
            op.open(jfn.RuntimeContext())
        return op
    pg = None if paging is None else ppg.PagingConfig(**paging)
    op = WindowAggOperator(assigner(pwin), pfn.SumAggregator(), paging=pg,
                           device="cpu", **args)
    op.open(pfn.RuntimeContext())
    return op


def _batches(keys, ts_value, batch, rng):
    """(keys, random f32 values, timestamps) in batches of ``batch``."""
    out = []
    for lo in range(0, keys.size, batch):
        k = keys[lo: lo + batch]
        out.append((k, (rng.random(k.size) * 100).astype(np.float32),
                    np.full(k.size, ts_value, np.int64)))
    return out


def _passes(n_keys, windows=2, reps=2, seed=7, batch=512, refeed=0):
    """``reps`` shuffled passes over ``n_keys`` keys per window, then its
    watermark (``refeed``: the first keys once more in window 0, which
    promotes spilled keys while their pane is live)."""
    rng = np.random.default_rng(seed)
    plan = []
    for w in range(windows):
        for _ in range(reps):
            plan += _batches(rng.permutation(n_keys).astype(np.int64),
                             w * 1000 + 10, batch, rng)
        if refeed and w == 0:
            plan += _batches(np.arange(refeed, dtype=np.int64), 10, batch,
                             rng)
        plan.append(w * 1000 + 999)
    return plan


def _step(side, op, step):
    """One plan step: a watermark (an int) or a (keys, values, ts) batch."""
    RB, WM = ((JaxBatch, JaxWatermark) if side == "jax"
              else (RecordBatch, Watermark))
    with _ctx(side):
        if isinstance(step, int):
            return op.process_watermark(WM(step))
        k, v, ts = step
        return op.process_batch(RB({"k": k, "v": v}, timestamps=ts))


def _drive(side, op, plan, cut=None):
    """Run ``plan`` and ``end_input``; with ``cut = (i, make_next, convert,
    next_side)`` snapshot before step ``i`` and go on in ``make_next()``
    restored from ``convert(snap)``.  Returns (fires, the snapshot, the last
    operator)."""
    out, snap = [], None
    for i, step in enumerate(plan):
        if cut is not None and i == cut[0]:
            with _ctx(side):
                out += op.prepare_snapshot_pre_barrier()
                snap = op.snapshot_state()
            side, op = cut[3], cut[1]()
            with _ctx(side):
                op.restore_state(cut[2](snap))
        out += _step(side, op, step)
    with _ctx(side):
        out += op.end_input()
    return out, snap, op


def _digests(elements):
    """Sorted (window start, key, result bits): fires compared by key (the
    spilled keys fire after the resident ones), bit for bit."""
    out = []
    for b in elements:
        if hasattr(b, "columns") and len(b):
            res = np.ascontiguousarray(b.column("result"), np.float32)
            out.extend(zip(np.asarray(b.column("window_start")).tolist(),
                           np.asarray(b.column("k")).tolist(),
                           res.view(np.uint32).tolist()))
    return sorted(out)


def _run(side, paging, plan, **kw):
    out, _, op = _drive(side, _make(side, paging, **kw), plan)
    return _digests(out), op


def _stats(op):
    return {k: op.paging_stats()[k] for k in STAT_KEYS}


def _assert_snaps_bit_equal(got, want):
    for k in ("pane_base", "max_pane", "last_fired_window", "watermark",
              "late_dropped", "P", "key_index_kind"):
        assert got[k] == want[k], k
    for k in ("panes", "counts"):
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
        assert np.array_equal(got[k], want[k]), k
    assert np.array_equal(got["key_index"]["reverse"],
                          want["key_index"]["reverse"])
    for g, w in zip(got["leaves"], want["leaves"], strict=True):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes()


# ---------------------------------------------------------------------------
# the store: the C spill store against the JAX package's
# ---------------------------------------------------------------------------

LAYOUTS = {
    "f32": ((np.float32,), ((),)),
    "f64+i64x2": ((np.float64, np.int64), ((), (2,))),
    "i32": ((np.int32,), ((),)),
}


def _cells(rng, layout, n):
    dtypes, shapes = LAYOUTS[layout]
    gids = rng.choice(1 << 40, n, replace=False).astype(np.int64) - (1 << 39)
    panes = rng.integers(-5, 50, n).astype(np.int64)
    flags = rng.integers(0, 2, n).astype(np.uint8)
    counts = rng.integers(0, 1 << 40, n).astype(np.int64)
    leaves = []
    for d, s in zip(dtypes, shapes):
        if np.dtype(d).kind == "f":
            # arbitrary bit patterns, NaNs and infinities included
            raw = rng.integers(0, 256, (n,) + s + (np.dtype(d).itemsize,),
                               dtype=np.uint8)
            leaves.append(raw.view(d).reshape((n,) + s))
        else:
            leaves.append(rng.integers(np.iinfo(d).min, np.iinfo(d).max,
                                       (n,) + s, dtype=d))
    return gids, panes, flags, counts, leaves


def _bits(a):
    return np.ascontiguousarray(a).tobytes()


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_store_round_trips_cells_bit_for_bit(layout, tmp_path):
    """Cells put through the single and the array entries come back bit for
    bit through both, as the JAX store returns them, with the same resident
    bytes and log (a budget that sends part of them to the log)."""
    dtypes, shapes = LAYOUTS[layout]
    rng = np.random.default_rng(5)
    gids, panes, flags, counts, leaves = _cells(rng, layout, 300)
    budget = 2048
    port = PaneSpillStore(str(tmp_path / "port"), budget, dtypes, shapes)
    ref = JaxStore(str(tmp_path / "jax"), budget, dtypes, shapes)
    half = 150
    for i in range(half):                      # the single entries
        vals = [l[i] for l in leaves]
        port.put(int(gids[i]), int(panes[i]), int(flags[i]), int(counts[i]),
                 vals)
        ref.put(int(gids[i]), int(panes[i]), int(flags[i]), int(counts[i]),
                vals)
    port.put_many(gids[half:], panes[half:], flags[half:], counts[half:],
                  [l[half:] for l in leaves])
    for i in range(half, gids.size):
        ref.put(int(gids[i]), int(panes[i]), int(flags[i]), int(counts[i]),
                [l[i] for l in leaves])
    assert len(port) == len(ref) == gids.size
    assert port.mem_used() == ref.mem_used() <= budget
    assert port.log_bytes() == ref.log_bytes() > 0
    found, f, c, ls = port.get_many(gids, panes)
    assert found.all() and np.array_equal(f, flags)
    assert np.array_equal(c, counts)
    for got, want in zip(ls, leaves, strict=True):
        assert got.dtype == want.dtype and _bits(got) == _bits(want)
    for i in range(0, gids.size, 7):
        pf, pc, pv = port.get(int(gids[i]), int(panes[i]))
        jf, jc, jv = ref.get(int(gids[i]), int(panes[i]))
        assert (pf, pc) == (jf, jc) == (int(flags[i]), int(counts[i]))
        for a, b in zip(pv, jv, strict=True):
            assert _bits(a) == _bits(b)
    assert port.get(int(gids[0]), int(panes[0]) + 1000) is None
    missing = port.get_many(np.array([1, 2]), np.array([-100, -100]))[0]
    assert not missing.any()
    port.close()
    ref.close()


def test_store_overflows_to_its_log_and_deletes(tmp_path):
    """A 1 KiB budget: nearly every cell lives in the log, more of it than
    the store buffers before it writes, and the cells come back intact
    from the file and from the buffer.  Deletes (single, array and through
    a promotion's ``delete=True``), re-puts, ``clear``, ``len``,
    ``mem_used`` and ``log_bytes`` keep the JAX store's accounting."""
    dtypes, shapes = LAYOUTS["f32"]
    rng = np.random.default_rng(9)
    n = 40000                  # 41 B log records: 1.6 MB of log
    gids, panes, flags, counts, leaves = _cells(rng, "f32", n)
    port = PaneSpillStore(str(tmp_path / "port"), 1024, dtypes, shapes)
    ref = JaxStore(str(tmp_path / "jax"), 1024, dtypes, shapes)
    port.put_many(gids, panes, flags, counts, leaves)
    for i in range(n):
        ref.put(int(gids[i]), int(panes[i]), int(flags[i]), int(counts[i]),
                [leaves[0][i]])
    assert port.log_bytes() == ref.log_bytes() > 1 << 20
    assert port.mem_used() == ref.mem_used() <= 1024
    assert os.path.getsize(tmp_path / "port" / "spill.log") >= 1 << 20
    found, f, c, (v,) = port.get_many(gids[:200], panes[:200], delete=True)
    assert found.all() and np.array_equal(c, counts[:200])
    assert np.array_equal(f, flags[:200]) and _bits(v) == _bits(leaves[0][:200])
    for i in range(200):
        ref.delete(int(gids[i]), int(panes[i]))
    assert port.delete(int(gids[200]), int(panes[200]))
    assert not port.delete(int(gids[0]), int(panes[0]))
    ref.delete(int(gids[200]), int(panes[200]))
    assert port.delete_many(gids[201:260], panes[201:260]) == 59
    for i in range(201, 260):
        ref.delete(int(gids[i]), int(panes[i]))
    # re-puts after deletes evict in the JAX store's order as well
    port.put_many(gids[:100], panes[:100], flags[:100], counts[:100],
                  [leaves[0][:100]])
    for i in range(100):
        ref.put(int(gids[i]), int(panes[i]), int(flags[i]), int(counts[i]),
                [leaves[0][i]])
    assert len(port) == len(ref) == n - 160
    assert (port.mem_used(), port.log_bytes()) == (ref.mem_used(),
                                                   ref.log_bytes())
    found, f, c, (v,) = port.get_many(gids, panes)
    keep = np.r_[0:100, 260:n]
    assert found[keep].all() and found.sum() == n - 160
    assert np.array_equal(c[keep], counts[keep])
    assert np.array_equal(f[keep], flags[keep])
    assert _bits(v[keep]) == _bits(leaves[0][keep])
    port.clear()
    ref.clear()
    assert len(port) == len(ref) == 0
    assert port.mem_used() == ref.mem_used() == 0
    assert port.log_bytes() == ref.log_bytes()
    port.close()
    ref.close()


def test_store_close_releases_its_handle_and_directory(tmp_path):
    store = PaneSpillStore(None, 1 << 20, (np.float32,), ((),))
    owned = Path(store.directory)
    assert owned.is_dir()
    store.put(1, 2, 1, 3, [np.float32(4.5)])
    store.close()
    store.close()                              # idempotent
    assert store.closed and not owned.exists()
    assert store.mem_used() == 0 and store.log_bytes() == 0
    with pytest.raises(ValueError, match="closed"):
        store.get(1, 2)
    given = tmp_path / "kept"
    store = PaneSpillStore(str(given), 1 << 20, (np.float32,), ((),))
    store.close()
    assert (given / "spill.log").is_file()      # a caller's directory stays


def test_store_has_no_python_fallback(monkeypatch, tmp_path):
    """Without a compiler the store raises; it never falls back to
    Python."""
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(build, "_libs", {})
    monkeypatch.setattr(build, "HOST_CXX", "no-such-compiler-here")
    with pytest.raises(RuntimeError, match="not found"):
        PaneSpillStore(None, 1 << 20, (np.float32,), ((),))


# ---------------------------------------------------------------------------
# the pager: the same calls, the same decisions
# ---------------------------------------------------------------------------

SPECS = {"sum": (lambda: jfn.SumAggregator(jnp.float32).acc_spec(),
                 lambda: pfn.SumAggregator().acc_spec()),
         "avg": (lambda: jfn.AvgAggregator(jnp.float32).acc_spec(),
                 lambda: pfn.AvgAggregator().acc_spec())}


def _pagers(policy, spec, K, budget=512):
    jspec, pspec = SPECS[spec]
    j = jpg.DevicePager(jpg.PagingConfig(K, policy=policy,
                                         mem_budget=budget), jspec(), K)
    p = ppg.DevicePager(ppg.PagingConfig(K, policy=policy,
                                         mem_budget=budget), pspec(), K)
    return j, p


def _same(a, b):
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray):
        assert a.shape == np.asarray(b).shape and _bits(a) == _bits(b)
    else:
        assert a == b


@pytest.mark.parametrize("spec", list(SPECS))
@pytest.mark.parametrize("policy", ["clock", "lru"])
def test_pager_makes_the_jax_pagers_decisions(policy, spec):
    """A seeded run of the operator's calls (victims under protection,
    page-out, assignment, promotion, touches, expiry, snapshot fill and
    restore import) gives the same victims, rows, cells, bitmaps and
    ``stats()`` on both pagers."""
    K, n_keys, m = 64, 400, 2
    rng = np.random.default_rng(3)
    jp, pp = _pagers(policy, spec, K)
    dtypes = [np.dtype(d) for d in pp.spec.leaf_dtypes]
    for pager in (jp, pp):
        pager.ensure_gids(n_keys)
    base = 0
    for step in range(60):
        if step % 15 == 14:
            for pager in (jp, pp):
                pager.drop_panes([base])
            base += 1
        live = np.arange(base, base + m, dtype=np.int64)
        gids = rng.choice(n_keys, int(rng.integers(1, K // 2)),
                          replace=False).astype(np.int64)
        rows_u = pp.rows(gids)
        _same(rows_u, jp.rows(gids))
        missing = gids[rows_u < 0]
        n_evict = int(missing.size) - pp.free_count()
        assert n_evict == int(missing.size) - jp.free_count()
        if n_evict > 0:
            victims = pp.pick_victims(n_evict, rows_u[rows_u >= 0])
            _same(victims, jp.pick_victims(n_evict, rows_u[rows_u >= 0]))
            V = victims.size
            counts = rng.integers(0, 3, (V, m)).astype(np.int32)
            leaves = [(rng.random((V, m)) * 9).astype(d) for d in dtypes]
            bits = rng.random((V, m)) < 0.3
            for pager in (jp, pp):
                pager.spill_rows(victims, live, counts, leaves, bits)
        got = pp.assign_rows(missing)
        _same(got, jp.assign_rows(missing))
        assert pp.any_spilled(missing, live) == jp.any_spilled(missing, live)
        _same(pp.load_entries(missing, live, delete=True),
              jp.load_entries(missing, live, delete=True))
        if step % 4 == 0:           # a fire's read of spilled keys
            spilled = pp.spilled_gids(live)
            _same(spilled, jp.spilled_gids(live))
            _same(pp.load_entries(spilled, live, delete=False),
                  jp.load_entries(spilled, live, delete=False))
        for pager in (jp, pp):
            pager.touch(pager.rows(gids))
        _same(pp.gid_of, jp.gid_of)
        _same(pp.row_of, jp.row_of)
        assert pp.stats(n_keys) == jp.stats(n_keys)
    assert pp.evictions > 0 and pp.promotions > 0
    assert pp.stats(n_keys)["spill_log_bytes"] > 0
    _same(pp.resident_pairs(), jp.resident_pairs())
    snaps = []
    for pager in (pp, jp):
        counts = np.zeros((n_keys, m), np.int32)
        leaves = ppg.identity_grid(pp.spec, n_keys, m)
        pager.fill_snapshot(counts, leaves, live)
        snaps.append((counts, leaves))
    _same(*snaps)
    counts, leaves = snaps[0]
    counts[rng.random(counts.shape) < 0.5] += 1
    for pager in (pp, jp):
        pager.reset()
        pager.ensure_gids(n_keys)
        pager.import_rows(np.arange(K, n_keys), live, counts, leaves)
    assert pp.stats(n_keys) == jp.stats(n_keys)
    _same(pp.spilled_gids(live), jp.spilled_gids(live))
    everyone = np.arange(n_keys, dtype=np.int64)
    _same(pp.load_entries(everyone, live, delete=False),
          jp.load_entries(everyone, live, delete=False))
    for pager in (pp, jp):
        pager.close()


@pytest.mark.parametrize("policy", ["clock", "lru"])
def test_pager_protected_rows_and_too_few_eligible(policy):
    jp, pp = _pagers(policy, "sum", 4)
    for pager in (jp, pp):
        pager.ensure_gids(8)
        pager.assign_rows(np.arange(4, dtype=np.int64))
        pager.touch(np.array([2, 3], np.int32))
    protected = np.array([0, 1], np.int64)
    victims = pp.pick_victims(2, protected)
    _same(victims, jp.pick_victims(2, protected))
    assert set(victims.tolist()) == {2, 3}
    for pager in (jp, pp):
        with pytest.raises(RuntimeError, match="exceeds capacity"):
            pager.pick_victims(3, protected)
    _same(pp.pick_victims(1, np.empty(0, np.int64)),
          jp.pick_victims(1, np.empty(0, np.int64)))
    for pager in (jp, pp):
        pager.close()


@pytest.mark.parametrize("case", ["policy", "host_tier", "count_trigger"])
def test_paging_config_validation_matches_jax(case):
    """The ValueErrors of ``tests/test_paging.py``'s validation test, raised
    by both packages for the same configuration."""
    kw = {"policy": ({"paging": {"capacity": 16, "policy": "fifo"}}, {}),
          "host_tier": ({"paging": {"capacity": 16}},
                        {"emit_tier": "host", "snapshot_source": "mirror"}),
          "count_trigger": ({"paging": {"capacity": 16}}, {})}[case]
    for side in ("jax", "port"):
        extra = dict(kw[1])
        if case == "count_trigger":
            extra["trigger"] = (CountTrigger.of(3) if side == "jax"
                                else PortCountTrigger.of(3))
        with pytest.raises(ValueError):
            _make(side, kw[0]["paging"], **extra)


# ---------------------------------------------------------------------------
# the page-out / page-in helpers against JAX's
# ---------------------------------------------------------------------------

def test_row_pane_helpers_equal_jax():
    """Gather, reset and set at the ring's edges (row 0 and K-1, pane slot
    0 and P-1), without the pads JAX needs."""
    K, P = 64, 8
    rng = np.random.default_rng(2)
    leaf = (rng.random((K, P)) * 10).astype(np.float32)
    counts = rng.integers(0, 5, (K, P)).astype(np.int32)
    rows = np.array([K - 1, 0, 17, 5], np.int64)
    slots = np.array([P - 1, 0, 3], np.int64)
    jc, (jl,) = jsc.gather_row_pane_columns(
        (jnp.asarray(leaf),), jnp.asarray(counts), jnp.asarray(rows),
        jnp.asarray(slots))
    pc, (pl,) = tsc.gather_row_pane_columns(
        (torch.from_numpy(leaf),), torch.from_numpy(counts),
        torch.from_numpy(rows), torch.from_numpy(slots))
    assert _bits(pc.numpy()) == _bits(np.asarray(jc))
    assert _bits(pl.numpy()) == _bits(np.asarray(jl))
    cols = (rng.random((rows.size, slots.size)) * 3).astype(np.float32)
    ccols = rng.integers(1, 9, (rows.size, slots.size)).astype(np.int32)
    rows_p = np.r_[rows, K, K].astype(np.int32)          # JAX's pads
    slots_p = np.r_[slots, P].astype(np.int32)
    (jl2,), jc2 = jsc.set_row_pane_columns(
        (jnp.asarray(leaf),), jnp.asarray(counts), jnp.asarray(rows_p),
        jnp.asarray(slots_p), (jnp.asarray(np.pad(cols, ((0, 2), (0, 1)))),),
        jnp.asarray(np.pad(ccols, ((0, 2), (0, 1)))), (np.float32(0),))
    pleaf, pcounts = torch.from_numpy(leaf.copy()), torch.from_numpy(
        counts.copy())
    tsc.set_row_pane_columns((pleaf,), pcounts, torch.from_numpy(rows),
                             torch.from_numpy(slots),
                             (torch.from_numpy(cols),),
                             torch.from_numpy(ccols), (np.float32(0),))
    assert _bits(pleaf.numpy()) == _bits(np.asarray(jl2))
    assert _bits(pcounts.numpy()) == _bits(np.asarray(jc2))
    (jl3,), jc3 = jsc.reset_rows((jnp.asarray(leaf),), jnp.asarray(counts),
                                 jnp.asarray(rows_p), (np.float32(0),))
    pleaf, pcounts = torch.from_numpy(leaf.copy()), torch.from_numpy(
        counts.copy())
    tsc.reset_rows((pleaf,), pcounts, torch.from_numpy(rows),
                   (np.float32(0),))
    assert _bits(pleaf.numpy()) == _bits(np.asarray(jl3))
    assert _bits(pcounts.numpy()) == _bits(np.asarray(jc3))


# ---------------------------------------------------------------------------
# the paged operator against JAX's, and against the port's resident run
# ---------------------------------------------------------------------------

def _three_way(plan, paging, **kw):
    """JAX paged, port paged and port resident over ``plan``: the digests
    agree bit for bit, and so do the two pagers' counters."""
    jd, jop = _run("jax", paging, plan, **kw)
    pd, pop = _run("port", paging, plan, **kw)
    rd, _ = _run("port", None, plan, **kw)
    assert pd == jd
    assert pd == rd
    assert _stats(pop) == _stats(jop)
    return pd, pop


@pytest.mark.parametrize("native_emit", [False, True])
@pytest.mark.parametrize("policy", ["clock", "lru"])
def test_paged_fires_equal_jax_both_policies(policy, native_emit):
    plan = _passes(4096)
    d, op = _three_way(plan, {"capacity": 1024, "policy": policy,
                              "mem_budget": 16 << 10},
                       native_emit=native_emit)
    assert len(d) == 2 * 4096
    st = op.paging_stats()
    assert st["evictions"] > 0 and st["promotions"] > 0
    assert st["resident_keys"] == 1024 and st["spilled_keys"] == 3072
    assert st["spill_log_bytes"] > 0     # promotions read the log too
    assert op.fused_stats()["depth"] == 1
    assert op.phase_ns["paging"] > 0
    assert op.phase_bytes["d2h_page_out"] > 0
    assert op.phase_bytes["h2d_page_in"] > 0


def test_paged_sliding_windows_equal_jax():
    """Sliding windows: spilled cells span two panes a window and every
    pane feeds two windows."""
    rng = np.random.default_rng(11)
    plan = []
    for w in range(4):
        plan += _batches(rng.permutation(2048).astype(np.int64),
                         w * 1000 + 10, 512, rng)
        plan.append(w * 1000 + 999)
    sliding = lambda mod: mod.SlidingEventTimeWindows.of(2000, 1000)  # noqa
    _three_way(plan, {"capacity": 512}, assigner=sliding)


def test_paged_late_refires_equal_jax():
    """A late record for a key whose cells are spilled folds in after its
    promotion and re-fires as in the resident run."""
    rng = np.random.default_rng(4)
    plan = _batches(np.arange(1024, dtype=np.int64), 10, 512, rng)
    plan.append(999)
    plan += _batches(np.arange(1024, 2048, dtype=np.int64), 1010, 512, rng)
    plan += _batches(np.arange(512, dtype=np.int64), 20, 128, rng)
    plan.append(1999)
    _three_way(plan, {"capacity": 256}, allowed_lateness_ms=1000)


def test_async_fire_eviction_between_fire_and_drain_keeps_attribution():
    """``async_fire``: a queued fire's rows are evicted and reassigned
    before its download drains; its rows keep the keys that fired."""
    rng = np.random.default_rng(8)
    plan = _batches(np.arange(1024, dtype=np.int64), 10, 128, rng)
    plan.append(999)
    plan += _batches(np.arange(1024, 2048, dtype=np.int64), 1010, 128, rng)
    plan.append(1999)
    d, _ = _three_way(plan, {"capacity": 256}, async_fire=True)
    sync, _ = _run("port", {"capacity": 256}, plan)
    assert d == sync and len(d) == 2048


def test_k_cap_one_still_correct():
    """K_cap=1: every batch splits to single records and every access
    evicts, without recursing forever."""
    rng = np.random.default_rng(1)
    plan = _batches(np.arange(16, dtype=np.int64), 10, 8, rng)
    d, op = _three_way(plan, {"capacity": 1})
    assert len(d) == 16 and op._K == 1


def test_oversized_batch_splits():
    """One batch of 2048 distinct keys against K_cap=256 splits into
    K_cap/2 pieces."""
    rng = np.random.default_rng(6)
    plan = _batches(np.arange(2048, dtype=np.int64), 10, 2048, rng)
    d, op = _three_way(plan, {"capacity": 256})
    assert len(d) == 2048 and op.paging_stats()["evictions"] >= 2048 - 256


def _cut_plan(n_keys=4096, seed=3):
    """2 windows x 2 passes of 512-key batches, with watermarks."""
    rng = np.random.default_rng(seed)
    plan = []
    for w in range(2):
        for _ in range(2):
            plan += _batches(rng.permutation(n_keys).astype(np.int64),
                             w * 1000 + 10, 512, rng)
        plan.append(w * 1000 + 999)
    return plan


def _cut_run(before, after, at=10, before_side="port", after_side="port"):
    """Snapshot before step ``at`` and go on in a fresh operator with
    ``after`` paging, converting between packages as needed."""
    convert = {("jax", "port"): snapshot_from_jax,
               ("port", "jax"): snapshot_to_jax}.get((before_side,
                                                      after_side),
                                                     lambda s: s)
    out, snap, op = _drive(before_side, _make(before_side, before),
                           _cut_plan(),
                           cut=(at, lambda: _make(after_side, after),
                                convert, after_side))
    return _digests(out), snap, op


@pytest.mark.parametrize("before,after", [(1024, 256), (256, 2048)])
def test_restore_at_smaller_and_larger_capacity(before, after):
    """A paged snapshot restores at another K_cap: fires equal JAX's same
    cut and the uncut resident run, the snapshot equals JAX's and the
    resident snapshot bit for bit, and the ring stays at its K_cap."""
    ref, rsnap, _ = _cut_run(None, None)
    jd, jsnap, jop = _cut_run({"capacity": before}, {"capacity": after},
                              before_side="jax", after_side="jax")
    pd, psnap, pop = _cut_run({"capacity": before}, {"capacity": after})
    assert pd == jd == ref
    _assert_snaps_bit_equal(psnap, snapshot_from_jax(jsnap))
    _assert_snaps_bit_equal(psnap, rsnap)
    assert psnap["paging_stats"] == jsnap["paging_stats"]
    assert pop._K == after and _stats(pop) == _stats(jop)


@pytest.mark.parametrize("before,after", [(None, 512), (512, None)])
def test_savepoints_resident_to_paged_and_back(before, after):
    ref, _, _ = _cut_run(None, None)
    pg = lambda c: None if c is None else {"capacity": c}  # noqa: E731
    assert _cut_run(pg(before), pg(after))[0] == ref
    assert _cut_run(pg(before), pg(after), before_side="jax",
                    after_side="jax")[0] == ref


@pytest.mark.parametrize("before_side,after_side", [("jax", "port"),
                                                    ("port", "jax")])
def test_paged_snapshots_cross_packages(before_side, after_side):
    """A JAX paged snapshot restored into the port, and a port paged
    snapshot restored into JAX through ``snapshot_to_jax``."""
    ref, _, _ = _cut_run(None, None)
    got, snap, _ = _cut_run({"capacity": 1024}, {"capacity": 256},
                            before_side=before_side, after_side=after_side)
    assert got == ref and "paging_stats" in snap


def test_housekeeping_reset_close_and_stats_off():
    """``paging_stats`` is None without paging; with it the counters are
    live, the emit scan stops at the rows ever assigned, ``reset_state``
    empties the spill tier, and ``close`` releases the store."""
    op = _make("port", None)
    assert op.paging_stats() is None
    op.close()
    op = _make("port", {"capacity": 256, "mem_budget": 256})
    for step in _batches(np.arange(1000, dtype=np.int64), 10, 128,
                         np.random.default_rng(0)):
        op.process_batch(RecordBatch({"k": step[0], "v": step[1]},
                                     timestamps=step[2]))
    st = op.paging_stats()
    assert st["resident_keys"] == 256 and st["spilled_keys"] == 744
    assert st["spill_log_bytes"] > 0 and len(op._pager.store) == 744
    assert op._pager.row_high_water == 256 < op.key_index.num_keys
    assert op._mirror_emit_idx(np.array([0])).tolist() == list(range(256))
    op.reset_state()
    assert op.paging_stats()["evictions"] == 0 and len(op._pager.store) == 0
    store_dir = Path(op._pager.store.directory)
    op.close()
    assert op._pager.store.closed and not store_dir.exists()
    assert op.paging_stats()["spill_mem_bytes"] == 0


def test_acceptance_64k_cap_256k_keys_equal_jax():
    """The JAX package's acceptance run: K_cap = 64k under 256k live keys,
    every key fires in every window, a re-feed promotes spilled keys while
    their pane is live, digest for digest against JAX's paged operator and
    the port's resident run, and the counters equal JAX's."""
    n_keys, cap = 256 * 1024, 64 * 1024
    plan = _passes(n_keys, reps=1, seed=13, batch=1 << 15, refeed=cap)
    d, op = _three_way(plan, {"capacity": cap, "mem_budget": 1 << 20},
                       native_emit=True, capacity_hint=1 << 10)
    assert len(d) == 2 * n_keys
    st = op.paging_stats()
    assert st["resident_keys"] == cap
    assert st["spilled_keys"] == n_keys - cap
    assert st["evictions"] >= n_keys - cap and st["promotions"] > 0
    assert st["spill_log_bytes"] > 1 << 20
