#!/usr/bin/env python3
"""Chip smoke of flink_tpu_torch on one NVIDIA GPU (written for the H100).

    python3 chip_smoke.py

Phases, each fatal on failure (exit code 1, no result line):

1. the card's name and power limit, as nvidia-smi reports them;
2. build of every kernel of the port's main paths from
   ``flink_tpu_torch/csrc`` with nvcc (``sm_90a``), one nvcc per source, and
   of the C host layer (``csrc/host_mirror.cc``: the keydict and the window
   value mirror) with g++, all started together;
3. kernel phase, probe: the device key probe (``csrc/probe.cu``, which
   hashes the int64 keys on the card) at the main path's shapes — a table of
   1M keys at capacity 2^21 (an interleaved ``[cap, 4]`` bucket array),
   batches of 2^18 records, about 10% of them unseen — must equal the plain
   ``torch_probe`` and ``KeyIndex.lookup`` exactly; its median time over
   CUDA-event-timed runs (after a flush that writes L2, after one that
   reads it, and warm) is printed beside the timing floor (an empty
   kernel), its bound (and the bound's bytes under the earlier
   three-plane interface, with host-made starts), and the plain version's
   time;
4. main path 1: the 1M-key tumbling-sum workload of ``bench.py`` (seed 7,
   1,000,000 keys, 2^18 records per batch, 5000 ms windows), 40 batches
   through ``WindowAggOperator(device="cuda", device_probe="on")`` (scatter
   sync, one batch at a time) with a snapshot every 16 batches and
   ``end_input``; every fire is held against an independent numpy reference
   (per window ``np.bincount`` in f64 over the same records);
5. restore and replay of path 1: the first snapshot restored into a fresh
   operator and the remaining batches replayed must give the same
   per-window digests, bit for bit for every window that starts after the
   snapshot's (the window it cuts is re-seeded from the snapshot's f32
   cells, as in the reference, so its sums agree to 1e-6); a profiled
   replay gives the device's busy share and must equal the first replay
   bit for bit;
6. main path 2: the same 40 batches through the fused super-batch lane,
   ``device_sync="deferred"``, ``superbatch=8``: the same checks, plus
   launches of ``probe_fold`` and a scan depth above 1;
7. restore and replay of path 2, as in phase 5;
7a. main paths 3 and 4: paths 1 and 2 with ``native_emit=True`` and
   ``native_shards = min(4, os.cpu_count())``: the key index and the host
   mirror are the C layer's, so each pair differs only in the mirror.  The
   same checks, plus: the C mirror is active, both kernels still launch,
   and every fire equals its numpy twin's bit for bit (same keys in the
   same order; the probe lane folds the replica and the delta ring through
   the ordered ``scatter_fold``, and both mirrors fold in row order).  Each
   is restored and replayed as in phase 5.  The paths run in the order 1,
   3, 2, 4, so each pair runs back to back;
7b. host layer phase: the C layer's calls at the main paths' sizes, on the
   host's clock (median of 5): the probe + mirror pass over one batch of
   2^18 records into a warm 1M-key keydict at 1 and at ``native_shards``
   threads, beside the numpy ``KeyIndex.lookup_or_insert`` of the same
   keys; ``apply_delta`` of a 1M-row delta column into a pane whose pages
   are fresh and into one already touched; one fire sweep over 1M rows;
8. kernel phase, probe_fold: the fused probe + ordered fold
   (``csrc/probe_fold.cu``) at the fused lane's shapes — the same table, one
   flush of 8 staged batches of 2^18 records (the last one short, about 10%
   unseen keys) into f64/int32 delta planes of 2^20 x 16 cells with non-zero
   contents — must equal ``torch_probe_fold`` on CPU copies bit for bit; its
   median time (L2 flushed and warm, and split into its four steps: probe +
   tile histogram, offsets, stable partition by tile, ordered fold) is
   printed beside its bound, the plain version's time and the unfused
   route's (the probe kernel + ``index_add_``).  A skewed flush, one key on
   25% of the rows, is held to ``torch_probe_fold`` bit for bit too, and
   timed beside the uniform one (a check of the kernel, not a main path);
9. main paths 5 and 6, the device emit tier: path 5 is
   ``emit_tier="device"``, ``snapshot_source="device"``, scatter sync, one
   batch at a time, ``native_emit=True`` (the C keydict, no value mirror);
   path 6 is path 5 with ``async_fire=True`` and ``superbatch=8``.  Every
   batch folds into the f32 replica through ``scatter_fold``; a fire gathers
   the emitted rows on the card and downloads the values.  Every fire must
   equal, bit for bit, a numpy reference that folds the same records into
   f32 cells in record order (``np.add.at``); every fire must equal path 3's
   (same keys in the same order, values to rtol 1e-5: f32 against the f64
   mirror); path 6 must surface exactly path 5's fires, each at most one
   batch later.  Each is restored and replayed, with fires equal bit for
   bit;
9a. main path 7, cold-key paging on the device tier: path 5 with
   ``paging=PagingConfig(capacity=2^18, policy="clock", mem_budget=4 MiB)``
   (``state/paging.py`` over the C spill store ``csrc/spill_store.cc``,
   built with g++ in phase 2).  The ring holds a quarter of the key space,
   so each 2^18-record batch splits in two (the reference splits batches
   longer than K_cap / 2), cold keys page out to the store and back, and
   the store's budget sends part of the spill tier to its disk log.  Every
   fire must equal the f32 record-order reference bit for bit (compared by
   key: the spilled keys fire after the resident ones), the set of
   (window, key, value) must equal path 5's bit for bit, and the paging
   counters must show a full ring (2^18 resident keys, the rest spilled),
   evictions, promotions and log bytes.  The mid-run snapshot restores
   into a paged operator at capacity 2^19 and replays bit for bit (twice);
9b. main path 8, the ``auto`` settings (slice 8):
   ``WindowAggOperator(device="cuda", superbatch=0)`` with every other
   option at its default, the JAX operator's, run after the process's
   calibration verdicts are reset so that it calibrates on the card: the
   emit tier (the host tier on a card) and snapshot source, the sync
   cadence (its first batches time their own update steps), the C pass's
   shard count, the super-batch depth, and the device probe (the probe
   kernel and ``scatter_fold`` against the C pass: their launches count
   under path 8).  One line prints the resolved lane and every
   calibration's numbers.  A pinned twin, built with exactly the resolved
   settings, runs next: path 8's fires and mid-run snapshot must equal
   its bit for bit, and its counters from the first batch after the
   calibration; fires are held to the numpy reference (on the device tier
   to the f32 reference, bit for bit);
9c. main paths 9 and 10: paths 3 and 7 with ``pipeline_depth=2`` (the hot
   stage on a worker thread): the fires (at the same calls), the mid-run
   snapshot's bytes, every counter and the replay must equal paths 3's and
   7's bit for bit, and path 10 is held as path 7 is.  Then an A/B of path
   9 against path 3 on batches generated inside the timed loop from the
   seed (turns 3, 9, 9, 3; every run bit-equal to path 3's fires): records/s
   and, from one profiled run each, the device's idle share;
9d. spill store phase: the store's array entries at path 7's layout and
   budget, on the host's clock: puts of 2^19 cells, gets in random order,
   a promotion's get + delete, deletes (ns per cell);
9e. main paths 11-13, the device watchdog (slice 9), each under a fast
   monitor (0.25 s deadline floor, 30 s grace for a new geometry, no
   background healer) and a fault schedule of the port's own injector
   (``FAULTS``): path 11 is path 5 with ``WedgedDevice(at=12)`` (batch
   11's fold wedges; the tier migrates its ring to the host mirror, the
   batches up to the re-promotion fold there, the snapshot at batch 15 is
   taken degraded, the schedule heals after batch 19 and the state goes
   back on the card at batch 31's barrier); path 12 is path 3 with a wedge
   in batch 11's guarded probe step (the f64 delta ring is salvaged from
   the card; heal and re-promotion as path 11, then ``verify_mirror``);
   path 13 is path 7 whose third dispatch fails with an OOM (one forced
   page-out, no quarantine).  Windows the quarantine did not touch must
   equal the base path's bit for bit, every window the numpy reference;
   path 12's touched windows equal path 3's to ``F64_REASSOCIATION_RTOL``,
   path 13's every fire path 7's by key bit for bit, with more evictions.
   Every path, 1-10 included, checks its monitor's counters against what
   its schedule injects (``EXPECT_MONITOR``, else ``QUIET``), that the
   tier ends healthy and the state on the card.  Paths 11 and 12 replay
   their degraded snapshot under a healthy and a still quarantined
   monitor.  Then the guard's A/B (paths 3, 5 and 9 with
   ``FLINK_TPU_DEVICE_WATCHDOG=off`` against the default, same batches,
   turns on, off, off, on, twice: records/s, phases, dispatches a batch, the
   hand-off to the lane and back), the round trip of an empty guarded
   thunk, and the healer's subprocess probe on the card;
9f. main paths 14-17, the key-group mesh (slice 10): a
   ``MeshWindowAggOperator`` over ``MESH_BLOCKS = 4`` row blocks of the
   state on the one card (``make_mesh(devices=[card] * 4)``; on one card
   the exchange crosses no interconnect, so these runs price the sharded
   code: the host routing, the buckets, one ``scatter_fold`` a block, the
   full-capacity fire).  Path 14 is path 3 on the mesh (the C pass sharded
   by the blocks' slot ranges, ``native_shards=4``; the probe on position
   0, the delta and replica folds through the exchange): its fires equal
   path 3's bit for bit (same calls, keys, values), its mid-run snapshot,
   densified, equals path 3's byte for byte, and the C pass times each of
   its 4 shards.  Path 15 is path 5 on the mesh (the full-capacity fire,
   sliced snapshots): its fires equal path 5's bit for bit, and its
   mid-run snapshot restored at 2 blocks and at 1 (the single-card
   operator) replays bit for bit.  Path 16 is path 15 under path 11's
   wedge: the whole mesh migrates to the host mirror, heals and
   re-promotes into 4 blocks; held as path 11 is (to path 15), and its
   fires equal path 11's bit for bit.  Path 17 is path 7 on the mesh (the
   ring's 2^18 rows as 4 blocks of 2^16): its fires equal path 7's by key
   and every paging counter path 7's.  Then each mesh path is timed
   against its twin in turns (twin, mesh, mesh, twin);
10. kernel phase, scatter_fold: the ordered fold (``csrc/scatter_fold.cu``)
   at path 5's shapes — 2^18 int32 flat ids (about 2% dropped) into an f32
   ``[2^20, 16]`` replica and int32 counts with non-zero contents, and a
   skewed batch with one key on 25% of the rows — must equal its plain
   version on CPU copies bit for bit; its median time (L2 flushed and warm,
   split into its two steps, partition and fold) is printed beside its
   bound, the plain version's time and the two ``index_add_`` calls it
   replaces.  Then the multi-plane call at path 1's shapes (int64 ids, the
   f32 replica and the f64 delta ring from one value column, both count
   planes) is held to its plain version bit for bit and timed against two
   single-plane calls and the ``index_add_`` route the probe lane ran
   before.
9g. main paths 18-21 (slice 11), after path 17, over the same stream: path
   18 is path 5 with ``LambdaReduce(lambda a, b: a + b, 0.0)`` (no scatter
   kinds: every batch folds through ``scatter_generic``, the stable sort
   and JAX's segmented scan in torch ops, and no ``scatter_fold``); path 19
   is path 5 under ``PurgingTrigger.of(CountTrigger.of(2))`` (after every
   batch the touched pane's counts column comes down and the keys at 2
   fire and purge); path 20 is ``GlobalWindows`` with
   ``CountTrigger.of(4, purge=True)`` (``countWindow(4)``) and a sum; path
   21 is ``KeyedReduceOperator(SumAggregator)`` (every record's running
   sum comes down).  Each is held (a) to the same operator on the CPU over
   the first ``SLICE11_CPU_BATCHES`` batches, bit for bit, (b) to a numpy
   semantics of its own (f64 sums; rtol ``RTOL``, path 21
   ``REDUCE_RTOL``), (c) to a restore of its mid-run snapshot replayed on
   the card, bit for bit, twice, the second under ``torch.profiler`` (the
   device's busy share, its kernels a batch).  Paths 19 and 20 must launch
   ``scatter_fold``, paths 18 and 21 must not; each is timed against path
   5.
9h. main paths 22-25 (slice 12), after path 21: path 22 is
   ``SessionWindowOperator`` (host only, as in JAX) on config 4 of
   ``BASELINE.json`` at ``bench.py`` ``run_config4``'s full size (seed 17,
   2^21 records in 64 batches of 2^15, keys ``(zipf(1.3) - 1) % 100000``,
   bursts of 800 ms every 3000 ms, gap 1000 ms, an f32 sum, a watermark of
   ``max(ts) - 1`` after each batch, then the end-of-input watermark); path
   23 is ``MeshSessionWindowOperator`` over ``MESH_BLOCKS`` blocks of the
   card on the same batches (the fold through the exchange and
   ``scatter_fold``, one call a block a batch).  Both are held to a
   pure-Python model (``bench.py``'s heap pass with the operator's
   boundaries): the same (key, start, end) at the same calls, each sum
   within ``n * U32`` of the model's f64 sum; path 23's sessions equal path
   22's, and its first ``SESSION_CPU_BATCHES`` batches equal a CPU mesh's
   bit for bit.  Path 24 is ``DeviceEvictingWindowOperator`` on the 1M-key
   stream (tumbling 5000 ms, ``CountEvictor.of(1)``, f32 sum): every fire
   equals a numpy model (each key's last arrival) bit for bit; path 25 is
   path 24 with ``TimeEvictor.of(1000)`` and an f32 average, held bit for
   bit to an f32 ``np.add.at`` model of each key's kept records in arrival
   order.  Paths 24 and 25 equal the CPU over the first
   ``EVICT_CPU_BATCHES`` batches bit for bit, guard one ``append_step``
   dispatch a batch, and launch ``scatter_fold`` once a fire.  Each path's
   mid-run snapshot is restored and replayed twice (the second under
   ``torch.profiler``): the same outputs at the same calls, each value bit
   for bit.  A/B lines: path 23 against path 22, paths 24 and 25 against
   path 5.

Each main path runs with every launch count set to 0 just before it and
read just after; the kernel line reports each kernel's launches on every
path (``launches_by_path``) and their sum (``launches``).  Then one JSON
line of kernel numbers, the nvidia-smi line, and, last,
``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

#: H100 SXM published peaks (NVIDIA data sheet) used for the bounds
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12          # non-tensor-core 32-bit rate
F64_OPS_PER_S = 34e12            # non-tensor-core f64 rate

N_KEYS = 1_000_000              # bench.py --keys default
KEY_CAPACITY = 1 << 20
BATCH = 1 << 18
WINDOW_MS = 5000
N_BATCHES = 40
SNAPSHOT_EVERY = 16
PANES = 16                      # the operator's pane ring at these windows
SUPERBATCH = 8
RTOL = 1e-6   # f32 results against the reference's f64 sums

#: the kernels of the main paths, built together in phase 2
SOURCES = ("probe.cu", "probe_fold.cu", "scatter_fold.cu")
#: the C host layer of paths 3 and 4, and the spill store of path 7, built
#: beside them with g++
HOST_SOURCE = "host_mirror.cc"
SPILL_SOURCE = "spill_store.cc"
#: host threads of the C probe + fold pass on paths 3 and 4 (pinned)
NATIVE_SHARDS = min(4, os.cpu_count() or 1)

#: the main paths: slice 1's per-batch scatter lane, slice 2's fused lane,
#: each of them on the C host layer (slice 4), and the device emit tier,
#: synchronous and async (slice 5), each with every option pinned; slice 8's
#: ``auto`` path takes the defaults (the JAX operator's)
HOST_TIER = dict(emit_tier="host", snapshot_source="mirror",
                 device_probe="on", native_emit=False)
C_LAYER = dict(native_emit=True, native_shards=NATIVE_SHARDS)
DEVICE_TIER = dict(emit_tier="device", snapshot_source="device",
                   device_sync="scatter", device_probe="on", **C_LAYER)
PATHS = {
    "path 1": dict(HOST_TIER, device_sync="scatter", superbatch=1),
    "path 2": dict(HOST_TIER, device_sync="deferred", superbatch=SUPERBATCH),
    "path 3": dict(HOST_TIER, device_sync="scatter", superbatch=1,
                   **C_LAYER),
    "path 4": dict(HOST_TIER, device_sync="deferred", superbatch=SUPERBATCH,
                   **C_LAYER),
    "path 5": dict(DEVICE_TIER, superbatch=1),
    "path 6": dict(DEVICE_TIER, superbatch=SUPERBATCH, async_fire=True),
    # slice 7: the ring holds a quarter of the key space, as in the
    # reference's acceptance run (64k rows for 256k keys).  A key's spilled
    # cell lives as long as its window: about 73% of the keys show up in a
    # 5-batch window (1 - e^-1.31), and roughly half a million of those are
    # out of the ring at the window's end: 6-7 MB of 13-byte values, under
    # an 8 MiB budget.  A 4 MiB budget keeps part of them in the store's
    # disk log in every window
    "path 7": dict(DEVICE_TIER, superbatch=1,
                   paging=dict(capacity=1 << 18, policy="clock",
                               mem_budget=4 << 20)),
    # slice 8: every option at its default (``auto``), the super-batch
    # depth measured too; the process's verdicts are reset before it runs
    "path 8": dict(superbatch=0),
}
# slice 8: paths 3 and 7 with the hot stage on the pipeline's worker
PATHS["path 9"] = dict(PATHS["path 3"], pipeline_depth=2)
PATHS["path 10"] = dict(PATHS["path 7"], pipeline_depth=2)
#: the pipelined paths and the serial path each equals bit for bit
PIPELINED = {"path 9": "path 3", "path 10": "path 7"}
#: the paged paths, the path each is held to bit for bit by key, and the
#: ring capacity its restore replays at
PAGED_PATHS = {"path 7": "path 5", "path 10": "path 5"}
PAGED_REPLAY_CAPACITY = {"path 7": 1 << 19, "path 10": 1 << 19}
#: each native path's numpy twin
TWIN = {"path 3": "path 1", "path 4": "path 2"}
#: the device-tier paths, and the host-tier path each is held to
DEVICE_PATHS = {"path 5": "path 3", "path 6": "path 3"}
#: slice 9: the watchdog's paths, each a main path under a fault schedule
#: of the port's own injector: ``base`` is the path whose options it runs
#: and whose fires it is held to; ``schedule(chaos, fired)`` is injected
#: on ``device.dispatch`` before batch ``inject_at`` (``fired``: the
#: point's firings so far), and heals after batch ``heal_at``.  Path 11
#: wedges the device tier's 12th dispatch (batch 11's fold); path 12
#: wedges batch 11's guarded probe step (the probe lane has one or two
#: dispatches a batch, so the point is counted when the batch starts);
#: path 13's third dispatch (batch 1's first half) fails with an OOM
OOM_ACTION = ("fail", "RESOURCE_EXHAUSTED: out of memory allocating the "
              "replica fold's scratch (injected)")
FAULTS = {
    "path 11": dict(base="path 5", inject_at=0, heal_at=19,
                    schedule=lambda ch, fired: ch.WedgedDevice(at=12)),
    "path 12": dict(base="path 3", inject_at=11, heal_at=19,
                    schedule=lambda ch, fired: ch.WedgedDevice(at=fired + 1)),
    "path 13": dict(base="path 7", inject_at=0, heal_at=None,
                    schedule=lambda ch, fired: ch.ActionSequence(
                        ["ok", "ok", OOM_ACTION])),
}
for _label, _fault in FAULTS.items():
    PATHS[_label] = dict(PATHS[_fault["base"]])
PAGED_PATHS["path 13"] = "path 5"
PAGED_REPLAY_CAPACITY["path 13"] = 1 << 19
#: slice 10: the key-group mesh, ``MESH_BLOCKS`` row blocks of the state on
#: the one card (``make_mesh(devices=[card] * 4)``): path 14 is path 3 on
#: the mesh (the C pass sharded by the blocks' slot ranges), path 15 path
#: 5 (the full-capacity sharded fire, sliced snapshots), path 16 path 15
#: under path 11's wedge (the whole mesh degrades and re-promotes into its
#: blocks), path 17 path 7 (paged, 2^16 ring rows a block)
MESH_BLOCKS = 4
PATHS["path 14"] = dict(PATHS["path 3"], native_shards=MESH_BLOCKS,
                        mesh_blocks=MESH_BLOCKS)
PATHS["path 15"] = dict(PATHS["path 5"], mesh_blocks=MESH_BLOCKS)
PATHS["path 17"] = dict(PATHS["path 7"], mesh_blocks=MESH_BLOCKS)
FAULTS["path 16"] = dict(base="path 15", inject_at=0, heal_at=19,
                         schedule=lambda ch, fired: ch.WedgedDevice(at=12))
PATHS["path 16"] = dict(PATHS["path 15"])
DEVICE_PATHS["path 15"] = "path 3"
PAGED_PATHS["path 17"] = "path 5"
PAGED_REPLAY_CAPACITY["path 17"] = 1 << 19
#: each mesh path and the single-block path it equals bit for bit (fires;
#: path 14's snapshot too, densified), and is timed against in turns
MESH_TWIN = {"path 14": "path 3", "path 15": "path 5", "path 16": "path 11",
             "path 17": "path 7"}
#: the mesh sizes path 15's mid-run snapshot is restored at (rescale)
RESCALE_BLOCKS = (2, 1)
#: the watchdog's paths on the device tier (their untouched windows also
#: equal the f32 reference bit for bit)
DEVICE_FAULTS = ("path 11", "path 16")
#: the reference tests' fast monitor, for the watchdog's paths (every other
#: path runs under a fresh monitor of the default configuration)
FAST_WATCHDOG = dict(deadline_floor_s=0.25, first_dispatch_grace_s=30.0)
#: what each path's monitor must count at its end; any other count (a
#: quarantine, a timeout, a retry or a page-out the script did not inject)
#: fails the smoke
QUIET = dict(quarantines=0, heals=0, watchdog_timeouts=0,
             transient_retries=0, oom_pageouts=0)
EXPECT_MONITOR = {"path 11": dict(QUIET, quarantines=1, heals=1,
                                  watchdog_timeouts=1),
                  "path 12": dict(QUIET, quarantines=1, heals=1,
                                  watchdog_timeouts=1),
                  "path 13": dict(QUIET, oom_pageouts=1)}
EXPECT_MONITOR["path 16"] = EXPECT_MONITOR["path 11"]
#: the paths whose runs the guard's A/B repeats with the watchdog on and
#: off: the host tier's probe lane, the device tier, and the probe lane
#: behind the pipeline's worker (three threads: driver, worker, lane)
GUARD_AB = ("path 3", "path 5", "path 9")
#: path 12's windows the quarantine touched against path 3's: the same
#: records summed in f64 in another association (a degraded batch folds
#: every row into the mirror in row order; the probe lane sums its warm
#: rows in the delta ring, then adds them), a cell holding a few values
F64_REASSOCIATION_RTOL = 1e-12
#: run order: each numpy/C pair back to back, then the device tier, then
#: paging, then slice 8's paths, then slice 9's
ORDER = ("path 1", "path 3", "path 2", "path 4", "path 5", "path 6",
         "path 7", "path 8", "path 9", "path 10", "path 11", "path 12",
         "path 13", "path 14", "path 15", "path 16", "path 17")
#: device-tier fires against the host tier's f64 mirror
DEVICE_VS_HOST_RTOL = 1e-5
#: slice 11's paths, run after path 17 over the same stream: the generic
#: fold (path 18: path 5 with ``LambdaReduce(a + b)``), count triggers over
#: tumbling windows (path 19: path 5 under ``PurgingTrigger(CountTrigger(
#: 2))``) and over GlobalWindows (path 20: ``countWindow(4)``), and the
#: keyed running reduce (path 21: ``KeyedReduceOperator``)
SLICE11 = ("path 18", "path 19", "path 20", "path 21")
COUNT_WINDOW_N = 2      # path 19's threshold
GLOBAL_COUNT_N = 4      # path 20's threshold
#: the first batches each slice-11 path also runs on the CPU, its fires
#: held to the card's bit for bit
SLICE11_CPU_BATCHES = 10
#: path 21's running sums (f32, a key's up to a few tens of records
#: grouped by the scan) against a sequential f64 running sum
REDUCE_RTOL = 1e-5
#: the slice-11 paths that fold through scatter_fold (SumAggregator);
#: paths 18 and 21 launch no hand-written kernel (the scan is torch ops)
SLICE11_SCATTER = ("path 19", "path 20")
#: slice 12's paths, after path 21: session windows at config 4 of
#: ``BASELINE.json`` (path 22: ``SessionWindowOperator``, host only; path
#: 23: ``MeshSessionWindowOperator`` over ``MESH_BLOCKS`` blocks of the
#: card) and the device evicting lane on the 1M-key stream (path 24:
#: ``CountEvictor.of(1)`` + sum; path 25: ``TimeEvictor.of(1000)`` + avg)
SLICE12 = ("path 22", "path 23", "path 24", "path 25")
#: ``bench.py`` ``run_config4`` at its full (non-smoke) size
SESSION_RECORDS = 1 << 21
SESSION_BATCH = 1 << 15
SESSION_KEYS = 100_000
SESSION_GAP_MS = 1000
SESSION_SEED = 17
#: the session paths' mid-run snapshot (after this batch of 64)
SESSION_SNAPSHOT_AT = 31
#: the first batches path 23 also runs on a CPU mesh, bit for bit
SESSION_CPU_BATCHES = 16
#: the first batches paths 24 and 25 also run on the CPU, bit for bit
EVICT_CPU_BATCHES = 10
#: f32 unit roundoff: an f32 sum of n non-negative f32 values, in any
#: association, is within (n - 1) * U32 * (the exact sum) of the exact sum
#: (Higham, gamma_{n-1}); the sessions' sums are held to n * U32 against
#: the f64 model
U32 = 2.0 ** -24
EVICT_LABEL = "evicting-window-device.append_step"


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def make_batches(n_records: int, n_keys: int, batch_size: int,
                 window_ms: int, seed: int = 7):
    """Copy of ``bench.py`` ``make_batches``: uniform keys, f32 values,
    event time advancing 1000 ms per batch."""
    rng = np.random.default_rng(seed)
    batches = []
    t = 0
    for lo in range(0, n_records, batch_size):
        b = min(batch_size, n_records - lo)
        keys = rng.integers(0, n_keys, b).astype(np.int64)
        vals = rng.random(b).astype(np.float32)
        ts = t + np.sort(rng.integers(0, 1000, b)).astype(np.int64)
        t += 1000
        batches.append((keys, vals, ts))
    return batches


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "-i", "0",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    check(res.returncode == 0, f"nvidia-smi failed: {res.stderr}")
    return res.stdout.strip()


def cuda_time_ms(fn, runs: int, flush=None) -> float:
    """Median ms of ``fn()`` over ``runs`` CUDA-event-timed calls (after two
    warm-up calls).  Before each call ``flush()`` (if given) evicts L2, and a
    ~1 ms spin keeps the stream busy, so the host's launch overhead is not
    inside the timed interval.  :func:`timing_floor_ms` is what the method
    reads for an empty kernel."""
    import torch
    for _ in range(2):
        fn()
    times = []
    for _ in range(runs):
        if flush is not None:
            flush()
        torch.cuda._sleep(2_000_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def l2_flushes(device):
    """Two ways to evict L2 before a timed call: ``dirty`` writes 256 MiB
    (the flush the earlier kernel times were taken with, so the timed
    kernel also writes back up to 50 MB of the flush's dirty lines), ``clean`` reads them (L2 then holds clean
    lines, and the time is the kernel's own traffic)."""
    import torch
    scratch = torch.empty(256 << 20, dtype=torch.uint8, device=device)
    return (lambda: scratch.fill_(1)), (lambda: scratch.sum())


def timing_floor_ms() -> float:
    """What :func:`cuda_time_ms` reads for an empty kernel (a one-cycle
    spin): the events' and the launch's own share of every time."""
    import torch
    return cuda_time_ms(lambda: torch.cuda._sleep(1), 20)


def probe_work(buckets, keys):
    """(probe steps, distinct buckets touched) this data needs: the same
    walk as the probe, counting bucket reads."""
    import torch

    from flink_tpu_torch.state import device_keyindex as dk
    cap = buckets.shape[0]
    pending = torch.arange(keys.shape[0], device=keys.device)
    idx = dk.torch_probe_starts(keys, cap)
    steps = 0
    touched = torch.zeros(cap, dtype=torch.bool, device=keys.device)
    while pending.numel():
        steps += pending.numel()
        touched[idx] = True
        rows = buckets[idx]
        empty = rows[:, 2] == 0
        hit = ~empty & (dk.bucket_keys(rows) == keys[pending])
        go_on = ~(hit | empty)
        pending = pending[go_on]
        idx = (idx[go_on] + 1) & (cap - 1)
    return steps, int(touched.sum())


def bound(bytes_: int, int_ops: int, f64_ops: int = 0):
    """(bound ms, "bytes" or "operations") for this work on the card."""
    by_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    by_ops = (int_ops / INT32_OPS_PER_S + f64_ops / F64_OPS_PER_S) * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                   else "operations"), by_bytes, by_ops


def build_kernels():
    """Phase 2: one nvcc per source and g++ for the host layer, started
    together, then load each."""
    from flink_tpu_torch.kernels import build
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES) + 2) as pool:
        list(pool.map(lambda f: f(), [lambda s=s: build.build(s)
                                      for s in SOURCES]
                      + [lambda s=s: build.build_host(s)
                         for s in (HOST_SOURCE, SPILL_SOURCE)]))
    build.probe_lib()
    build.probe_fold_lib()
    build.scatter_fold_lib()
    build.spill_store_lib()
    host = build.host_mirror_lib()
    print(f"build: {', '.join(SOURCES)}, {HOST_SOURCE}, {SPILL_SOURCE} in "
          f"{time.perf_counter() - t0:.2f} s wall (nvcc " + ", ".join(
              f"{s} {build.build_seconds.get(s, 0.0):.2f} s"
              for s in SOURCES) + "; g++ " + ", ".join(
              f"{s} {build.build_seconds.get(s, 0.0):.2f} s"
              for s in (HOST_SOURCE, SPILL_SOURCE)) + ")")
    print(f"host layer: ftt_hw_threads() = {host.ftt_hw_threads()}, "
          f"os.cpu_count() = {os.cpu_count()}, native_shards = "
          f"{NATIVE_SHARDS} on paths 3 and 4")
    for s in SOURCES:
        print(f"ptxas {s}: " + build.ptxas_report.get(s, "(cached)")
              .replace("\n", " | "))


def load_table(device, rng):
    """A device table of N_KEYS keys at capacity 2^21, and its KeyIndex."""
    from flink_tpu_torch.state import device_keyindex as dk
    from flink_tpu_torch.state.keyindex import KeyIndex

    ki = KeyIndex(initial_capacity=2 * KEY_CAPACITY)
    ki.lookup_or_insert(rng.permutation(N_KEYS).astype(np.int64))
    dki = dk.DeviceKeyIndex(initial_capacity=2 * KEY_CAPACITY, device=device)
    dki.ensure_loaded(ki)
    check(dki.capacity == 2 * KEY_CAPACITY, f"table capacity {dki.capacity}")
    return ki, dki


#: int32 operations a record spends on the hash: 9 uint64 operations
#: (3 shifts, 3 xors, 2 multiplies, 1 and), counted as 2 each
HASH_OPS = 18


def kernel_phase(device, rng, ki, dki):
    import torch

    from flink_tpu_torch.state import device_keyindex as dk

    keys = rng.integers(0, N_KEYS, BATCH).astype(np.int64)
    unseen = rng.random(BATCH) < 0.1
    keys[unseen] = rng.integers(N_KEYS, 1 << 40, int(unseen.sum()))
    kt = torch.from_numpy(keys).to(device)
    buckets = dki.buckets

    got = dk.probe(buckets, kt)
    torch.cuda.synchronize()
    want = dk.torch_probe(buckets, kt)
    check(torch.equal(got, want), "probe kernel != torch_probe")
    check(np.array_equal(got.cpu().numpy(), ki.lookup(keys)),
          "probe kernel != KeyIndex.lookup")
    max_abs_err = int((got.long() - want.long()).abs().max())

    dirty, clean = l2_flushes(device)
    ms_cold = cuda_time_ms(lambda: dk.probe(buckets, kt), 20, flush=dirty)
    ms_clean = cuda_time_ms(lambda: dk.probe(buckets, kt), 20, flush=clean)
    ms_warm = cuda_time_ms(lambda: dk.probe(buckets, kt), 20)
    floor_ms = timing_floor_ms()
    plain_ms = cuda_time_ms(lambda: dk.torch_probe(buckets, kt), 5)
    del dirty, clean
    steps, touched = probe_work(buckets, kt)
    # the key streams in (8 B) and the slot out (4 B); each touched bucket's
    # key words and slot (12 B) are read once, whatever the layout stores
    bytes_ = 12 * BATCH + 12 * touched
    old_bytes = 16 * BATCH + 12 * touched   # key_lo, key_hi, start in
    ops = 6 * steps + HASH_OPS * BATCH     # 3 compares, 2 ands, 1 step add
    bound_ms, bound_by, bound_bytes_ms, bound_ops_ms = bound(bytes_, ops)
    print(f"probe kernel: cap={dki.capacity} B={BATCH} "
          f"unseen={int(unseen.sum())} hits={int((got >= 0).sum())}")
    print(f"probe kernel: median {ms_cold:.4f} ms with L2 flushed, "
          f"{ms_clean:.4f} ms after a read-only flush, {ms_warm:.4f} ms warm "
          f"(20 runs each); timing floor (an empty kernel) {floor_ms:.4f} ms; "
          f"plain torch_probe {plain_ms:.4f} ms")
    print(f"probe bound: bytes = 12 B/record x {BATCH} + 12 B x {touched} "
          f"distinct buckets touched = {bytes_} B over "
          f"{HBM_BYTES_PER_S:.3g} B/s = {bound_bytes_ms:.5f} ms (the "
          f"three-plane interface's 16 B/record: {old_bytes} B = "
          f"{old_bytes / HBM_BYTES_PER_S * 1e3:.5f} ms); ops = 6 x {steps} "
          f"probe steps + {HASH_OPS} x {BATCH} hashes over "
          f"{INT32_OPS_PER_S:.3g}/s = {bound_ops_ms:.6f} ms; bound by "
          f"{bound_by}")
    print("probe library_ms: null — PyTorch has no single call that probes "
          "an open-addressing hash table")
    return {"name": "probe", "route": "cuda",
            "source": "flink_tpu_torch/csrc/probe.cu",
            "replaces": "flink_tpu/state/device_keyindex.py:139",
            "launches": 0, "max_abs_err": max_abs_err,
            "ms": ms_cold, "ms_clean_l2": ms_clean, "ms_warm": ms_warm,
            "timing_floor_ms": floor_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_bytes": bytes_, "old_bound_bytes": old_bytes,
            "library_ms": None}


def make_flush(rng, device, hot_key=None):
    """One flush of the fused lane at the main path's shapes: 8 staged
    batches of 2^18 records (the last one 4096 short), ~10% unseen keys,
    pane slots of 5000 ms panes in a 16-pane ring, f32 values.  With
    ``hot_key``, that key takes 25% of the rows (the skewed flush)."""
    import torch
    keys, panes, vals = [], [], []
    for i in range(SUPERBATCH):
        b = BATCH - (4096 if i == SUPERBATCH - 1 else 0)
        k = rng.integers(0, N_KEYS, b).astype(np.int64)
        unseen = rng.random(b) < 0.1
        k[unseen] = rng.integers(N_KEYS, 1 << 40, int(unseen.sum()))
        if hot_key is not None:
            k[rng.random(b) < 0.25] = hot_key
        ts = i * 1000 + np.sort(rng.integers(0, 1000, b)).astype(np.int64)
        keys.append(k)
        panes.append((ts // WINDOW_MS % PANES).astype(np.int32))
        vals.append(rng.random(b).astype(np.float32))
    return [torch.from_numpy(np.concatenate(a)).to(device)
            for a in (keys, panes, vals)]


def split_ms(steps, launch, runs: int, flush=None):
    """Median ms of each of a kernel's ``steps`` (name -> bit of its steps
    mask), each between CUDA events: ``launch(bit)`` runs one step."""
    import torch
    times = []
    for r in range(runs + 2):
        if flush is not None:
            flush()
        torch.cuda._sleep(2_000_000)
        ev = [torch.cuda.Event(enable_timing=True)
              for _ in range(len(steps) + 1)]
        ev[0].record()
        for i, step in enumerate(steps.values()):
            launch(step)
            ev[i + 1].record()
        ev[-1].synchronize()
        if r >= 2:
            times.append([ev[i].elapsed_time(ev[i + 1])
                          for i in range(len(steps))])
    med = np.median(np.asarray(times), axis=0)
    return {name: float(t) for name, t in zip(steps, med)}


def probe_fold_split_ms(buckets, keys, panes, vals, ds, dc, runs: int,
                        flush=None):
    """Median ms of probe_fold's four steps (probe + tile histogram,
    offsets, partition, fold): the wrapper's launches, made one step at a
    time."""
    import torch

    from flink_tpu_torch.state import device_keyindex as dk
    n = int(keys.shape[0])
    slot = torch.empty(n, dtype=torch.int32, device=keys.device)
    scratch = dk.probe_fold_scratch(n, int(ds.shape[0]), vals)
    return split_ms(dk.FOLD_STEPS, lambda step: dk.launch_probe_fold_steps(
        buckets, keys, panes, n, vals, ds, dc, PANES, slot, scratch, step),
        runs, flush)


def _fold_check(device, buckets, flush_t, dsum0, dcnt0, label):
    """One probe_fold on the card against torch_probe_fold on CPU copies,
    bit for bit; returns (max abs errors, the plain version's slots, the
    most rows folded into one cell)."""
    import torch

    from flink_tpu_torch.state import device_keyindex as dk
    keys, panes, vals = flush_t
    R = int(keys.shape[0])
    ds, dc = dsum0.to(device, copy=True), dcnt0.to(device, copy=True)
    slot, ds, dc = dk.probe_fold(buckets, keys, panes, R, vals, ds, dc, PANES)
    torch.cuda.synchronize()
    wslot, ws, wc = dk.torch_probe_fold(
        buckets.cpu(), keys.cpu(), panes.cpu(), R, vals.cpu(), dsum0.clone(),
        dcnt0.clone(), PANES)
    got_slot, got_sum, got_cnt = slot.cpu(), ds.cpu(), dc.cpu()
    errs = {"slot": int((got_slot.long() - wslot.long()).abs().max()),
            "dcnt": int((got_cnt.long() - wc.long()).abs().max()),
            "dsum": float((got_sum - ws).abs().max())}
    check(max(errs.values()) == 0, f"probe_fold kernel != torch_probe_fold "
          f"on the {label} flush: max abs errors {errs}")
    check(torch.equal(got_sum.view(torch.int64), ws.view(torch.int64)),
          f"probe_fold dsum differs from torch_probe_fold in its bits on "
          f"the {label} flush")
    return errs, wslot, (wc.long() - dcnt0.long()).max().item()


def _steps(split) -> str:
    return " + ".join(f"{k} {v:.4f}" for k, v in split.items())


def probe_fold_phase(device, rng, dki):
    import torch

    from flink_tpu_torch.ops.scatter import scatter_fold_counts
    from flink_tpu_torch.state import device_keyindex as dk

    buckets = dki.buckets
    keys, panes, vals = flush_t = make_flush(rng, device)
    R = int(vals.shape[0])
    n_cells = KEY_CAPACITY * PANES
    gen = torch.Generator().manual_seed(11)
    dsum0 = torch.rand(n_cells, dtype=torch.float64, generator=gen)
    dcnt0 = torch.randint(0, 5, (n_cells,), dtype=torch.int32, generator=gen)

    errs, wslot, _ = _fold_check(device, buckets, flush_t, dsum0, dcnt0,
                                 "uniform")
    hits = int((wslot >= 0).sum())
    flat_hit = (wslot.long() * PANES + panes.cpu().long())[wslot >= 0]
    cells = int(torch.unique(flat_hit).numel())
    hot_key = int(N_KEYS // 3)
    skew_t = make_flush(rng, device, hot_key=hot_key)
    skew_errs, _, hot_run = _fold_check(device, buckets, skew_t, dsum0,
                                        dcnt0, "skewed")

    ds, dc = dsum0.to(device, copy=True), dcnt0.to(device, copy=True)
    flush, clean = l2_flushes(device)
    run = lambda: dk.probe_fold(buckets, keys, panes, R,  # noqa: E731
                                vals, ds, dc, PANES)
    ms_cold = cuda_time_ms(run, 20, flush=flush)
    ms_clean = cuda_time_ms(run, 20, flush=clean)
    ms_warm = cuda_time_ms(run, 20)
    split_cold = probe_fold_split_ms(buckets, keys, panes, vals, ds, dc, 20,
                                     flush)
    split_warm = probe_fold_split_ms(buckets, keys, panes, vals, ds, dc, 20)
    skew_ms = cuda_time_ms(lambda: dk.probe_fold(
        buckets, skew_t[0], skew_t[1], R, skew_t[2], ds, dc, PANES), 10,
        flush=flush)
    skew_split = probe_fold_split_ms(buckets, *skew_t, ds, dc, 10, flush)

    def unfused():
        s = dk.probe(buckets, keys)
        f = torch.where(s >= 0, s.long() * PANES + panes, n_cells)
        scatter_fold_counts((ds,), dc, f, (vals,), ("add",))

    unfused_ms = cuda_time_ms(unfused, 20, flush=flush)
    plain_ms = cuda_time_ms(lambda: dk.torch_probe_fold(
        buckets, keys, panes, R, vals, ds, dc, PANES), 5)
    del flush, clean
    steps, touched = probe_work(buckets, keys)
    # rows stream in (key, pane slot, value) and out (slot); each touched
    # bucket's key words and slot are read once; each touched cell's dsum
    # and dcnt are read and written once
    bytes_ = 20 * R + 12 * touched + 24 * cells
    old_bytes = 24 * R + 12 * touched + 24 * cells
    bound_ms, bound_by, bound_bytes_ms, bound_ops_ms = bound(
        bytes_, 6 * steps + HASH_OPS * R + hits, hits)
    bits, tiles, blocks = dk.fold_plan(R, n_cells)
    print(f"probe_fold kernel: cap={dki.capacity} R={R} rows "
          f"({SUPERBATCH} batches), hits={hits}, distinct cells={cells}, "
          f"planes {n_cells} cells f64 + int32 in {tiles} tiles of "
          f"2^{bits} cells, {blocks} row blocks; max abs err {errs}")
    print(f"probe_fold kernel: median {ms_cold:.4f} ms with L2 flushed "
          f"({_steps(split_cold)}), {ms_clean:.4f} ms after a read-only "
          f"flush, {ms_warm:.4f} ms warm ({_steps(split_warm)}); 20 runs "
          f"each")
    print(f"probe_fold skewed flush (key {hot_key} on 25% of the rows, its "
          f"longest cell run {hot_run} rows; max abs err {skew_errs}): "
          f"median {skew_ms:.4f} ms with L2 flushed ({_steps(skew_split)}; 10 "
          f"runs) vs the uniform flush's {ms_cold:.4f} ms")
    print(f"probe_fold plain torch_probe_fold on the card {plain_ms:.4f} ms; "
          f"unfused route (probe kernel + index_add_, f64 atomics in no "
          f"fixed order) {unfused_ms:.4f} ms with L2 flushed")
    print(f"probe_fold bound: bytes = 20 B/row x {R} + 12 B x {touched} "
          f"buckets + 24 B x {cells} cells = {bytes_} B over "
          f"{HBM_BYTES_PER_S:.3g} B/s = {bound_bytes_ms:.5f} ms (the "
          f"three-plane interface's 24 B/row: {old_bytes} B = "
          f"{old_bytes / HBM_BYTES_PER_S * 1e3:.5f} ms); ops = "
          f"{6 * steps + HASH_OPS * R + hits} int32 + {hits} f64 = "
          f"{bound_ops_ms:.6f} ms; bound by {bound_by}")
    print("probe_fold library_ms: null — no single PyTorch call probes a "
          "hash table and folds; the unfused route above is two calls and "
          "its float fold is unordered")
    return {"name": "probe_fold", "route": "cuda",
            "source": "flink_tpu_torch/csrc/probe_fold.cu",
            "replaces": "flink_tpu/state/device_keyindex.py:228",
            "launches": 0, "max_abs_err": max(errs.values()),
            "ms": ms_cold, "ms_clean_l2": ms_clean, "ms_warm": ms_warm,
            "split_ms": split_cold, "split_ms_warm": split_warm,
            "skewed_ms": skew_ms, "skewed_split_ms": skew_split,
            "plain_ms": plain_ms, "unfused_ms": unfused_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_bytes": bytes_, "old_bound_bytes": old_bytes,
            "library_ms": None}


def make_replica_batch(rng, device, hot_key=None):
    """One batch of path 5's update step: 2^18 int32 flat ids ``slot * 16 +
    pane slot`` of uniform keys into the ``[2^20, 16]`` replica, about 2% of
    them the dropped id, f32 values.  With ``hot_key``, that key takes 25% of
    the rows (the skewed batch)."""
    import torch
    n_cells = KEY_CAPACITY * PANES
    slots = rng.integers(0, N_KEYS, BATCH)
    if hot_key is not None:
        slots[rng.random(BATCH) < 0.25] = hot_key
    ids = slots * PANES + rng.integers(2, 4, BATCH)      # two live panes
    ids[rng.random(BATCH) < 0.02] = n_cells
    vals = rng.random(BATCH).astype(np.float32)
    return [torch.from_numpy(a).to(device)
            for a in (ids.astype(np.int32), vals)]


def _scatter_fold_check(device, batch, plane0, counts0, label):
    """One ``ordered_fold_counts`` on the card against its plain version on
    CPU copies, bit for bit; returns (max abs errors, rows folded, distinct
    cells touched, the longest run of one cell)."""
    import torch

    from flink_tpu_torch.ops import scatter as sc
    ids, vals = batch
    plane, counts = plane0.to(device, copy=True), counts0.to(device, copy=True)
    sc.ordered_fold_counts((plane,), counts, ids, (vals,), ("add",))
    torch.cuda.synchronize()
    (want,), want_c = sc.scatter_fold_counts(
        (plane0.clone(),), counts0.clone(), ids.cpu(), (vals.cpu(),),
        ("add",))
    got, got_c = plane.cpu(), counts.cpu()
    errs = {"plane": float((got - want).abs().max()),
            "counts": int((got_c.long() - want_c.long()).abs().max())}
    check(max(errs.values()) == 0 and torch.equal(
        got.view(torch.int32), want.view(torch.int32)),
        f"scatter_fold kernel != its plain version on the {label} batch: "
        f"max abs errors {errs}")
    added = want_c.long() - counts0.long()
    return (errs, int(added.sum()), int((added > 0).sum()),
            int(added.max()))


def scatter_fold_split_ms(ids, groups, runs: int, flush=None):
    """Median ms of scatter_fold's two steps (partition, fold) for the
    ``(leaves, counts, lifted)`` groups of one call: the wrapper's launch,
    made one step at a time."""
    from flink_tpu_torch.ops import scatter as sc
    ((sources, planes, counts),) = sc._fold_launches(groups, ("add",))
    return split_ms(sc.SCATTER_FOLD_STEPS, lambda step:
                    sc.launch_ordered_fold_steps(ids, sources, planes, counts,
                                                 step), runs, flush)


def _multi_check(device, ids, vals, planes0, label):
    """One multi-plane call on the card (the probe lane's replica and delta
    ring with their counts) against a loop of the plain version on CPU
    copies, bit for bit; returns the max abs errors."""
    import torch

    from flink_tpu_torch.ops import scatter as sc

    def groups(dev, ids_, vals_):
        t = [p.to(dev, copy=True) for p in planes0]
        return [((t[0],), t[1], (vals_,)), ((t[2],), t[3], (vals_,))]

    got = sc.ordered_fold_counts_multi(groups(device, ids, vals), ids,
                                       ("add",))
    torch.cuda.synchronize()
    want = sc.scatter_fold_counts_multi(groups("cpu", ids.cpu(), vals.cpu()),
                                        ids.cpu(), ("add",))
    errs = {}
    for name, (gl, gc), (wl, wc) in zip(("replica", "delta"), got, want):
        g, w = gl[0].cpu(), wl[0]
        errs[name] = float((g.double() - w.double()).abs().max())
        errs[name + "_counts"] = int((gc.cpu().long() - wc.long()).abs().max())
        check(g.numpy().tobytes() == w.numpy().tobytes()
              and torch.equal(gc.cpu(), wc),
              f"scatter_fold multi-plane call != its plain version on the "
              f"{label} batch ({name}): max abs errors {errs}")
    return errs


def scatter_fold_phase(device, rng):
    import torch

    from flink_tpu_torch.ops import scatter as sc
    n_cells = KEY_CAPACITY * PANES
    gen = torch.Generator().manual_seed(13)
    plane0 = torch.rand(n_cells, dtype=torch.float32, generator=gen) * 100
    counts0 = torch.randint(0, 5, (n_cells,), dtype=torch.int32,
                            generator=gen)
    batch = make_replica_batch(rng, device)
    errs, rows, cells, _ = _scatter_fold_check(device, batch, plane0,
                                               counts0, "uniform")
    hot_key = int(N_KEYS // 3)
    skew = make_replica_batch(rng, device, hot_key=hot_key)
    skew_errs, _, _, hot_run = _scatter_fold_check(device, skew, plane0,
                                                   counts0, "skewed")

    ids, vals = batch
    plane, counts = plane0.to(device), counts0.to(device)
    one = [((plane,), counts, (vals,))]
    flush, clean = l2_flushes(device)
    run = lambda: sc.ordered_fold_counts(  # noqa: E731
        (plane,), counts, ids, (vals,), ("add",))
    ms_cold = cuda_time_ms(run, 20, flush=flush)
    ms_clean = cuda_time_ms(run, 20, flush=clean)
    ms_warm = cuda_time_ms(run, 20)
    split_cold = scatter_fold_split_ms(ids, one, 20, flush)
    split_warm = scatter_fold_split_ms(ids, one, 20)
    skew_ms = cuda_time_ms(lambda: sc.ordered_fold_counts(
        (plane,), counts, skew[0], (skew[1],), ("add",)), 10, flush=flush)
    skew_split = scatter_fold_split_ms(
        skew[0], [((plane,), counts, (skew[1],))], 10, flush)
    plain_ms = cuda_time_ms(lambda: sc.scatter_fold_counts(
        (plane,), counts, ids, (vals,), ("add",)), 20, flush=flush)
    # the library route: the two index_add_ calls alone, on ids already
    # cleared of the dropped id (what the plain version spends around them
    # is not counted)
    keep = ids < n_cells
    lib_ids = ids[keep].long()
    lib_vals, lib_ones = vals[keep], torch.ones_like(lib_ids,
                                                     dtype=torch.int32)

    def library():
        plane.index_add_(0, lib_ids, lib_vals)
        counts.index_add_(0, lib_ids, lib_ones)

    library_ms = cuda_time_ms(library, 20, flush=flush)

    # the multi-plane call at path 1's shapes: the probe lane's int64 flat
    # ids (misses carry the dropped id), the f32 replica and the f64 delta
    # ring folded from one f32 column, both count planes
    ids64 = ids.long()
    delta0 = torch.rand(n_cells, dtype=torch.float64, generator=gen)
    dcnt0 = torch.randint(0, 5, (n_cells,), dtype=torch.int32, generator=gen)
    planes0 = (plane0, counts0, delta0, dcnt0)
    multi_errs = _multi_check(device, ids64, vals, planes0, "uniform")
    _multi_check(device, skew[0].long(), skew[1], planes0, "skewed")
    delta, dcnt = delta0.to(device), dcnt0.to(device)
    pair = [((plane,), counts, (vals,)), ((delta,), dcnt, (vals,))]
    multi_ms = cuda_time_ms(lambda: sc.ordered_fold_counts_multi(
        pair, ids64, ("add",)), 20, flush=flush)
    multi_warm = cuda_time_ms(lambda: sc.ordered_fold_counts_multi(
        pair, ids64, ("add",)), 20)
    multi_split = scatter_fold_split_ms(ids64, pair, 20, flush)

    def two_single():
        sc.ordered_fold_counts((plane,), counts, ids64, (vals,), ("add",))
        sc.ordered_fold_counts((delta,), dcnt, ids64, (vals,), ("add",))

    def index_add_pair():       # the probe lane's fold before this design
        sc.scatter_fold_counts((plane,), counts, ids64, (vals,), ("add",))
        sc.scatter_fold_counts((delta,), dcnt, ids64, (vals,), ("add",))

    two_ms = cuda_time_ms(two_single, 20, flush=flush)
    pair_plain_ms = cuda_time_ms(index_add_pair, 20, flush=flush)
    del flush, clean
    # ids and values stream in (4 + 4 B a row); each touched cell of the
    # replica and the counts is read and written once (4 + 4 B each way)
    bytes_ = 8 * BATCH + 16 * cells
    bound_ms, bound_by, bound_bytes_ms, bound_ops_ms = bound(bytes_,
                                                             2 * rows)
    # int64 ids and f32 values in (12 B a row); each touched cell of the
    # f32 replica, the f64 delta ring and both count planes read and
    # written once (2 x (4 + 8 + 4 + 4) B)
    multi_bytes = 12 * BATCH + 40 * cells
    multi_bound, multi_by, _, _ = bound(multi_bytes, 4 * rows, rows)
    bits, tiles, blocks = sc.scatter_plan(BATCH, n_cells)
    print(f"scatter_fold kernel: {BATCH} rows ({BATCH - rows} dropped) into "
          f"an f32 replica and int32 counts of {n_cells} cells "
          f"({cells} touched) in {tiles} tiles of 2^{bits} cells, {blocks} "
          f"partition blocks; max abs err {errs}")
    print(f"scatter_fold kernel: median {ms_cold:.4f} ms with L2 flushed "
          f"({_steps(split_cold)}), {ms_clean:.4f} ms after a read-only "
          f"flush, {ms_warm:.4f} ms warm ({_steps(split_warm)}); 20 runs "
          f"each")
    print(f"scatter_fold skewed batch (key {hot_key} on 25% of the rows, its "
          f"longest cell run {hot_run} rows; max abs err {skew_errs}): "
          f"median {skew_ms:.4f} ms with L2 flushed ({_steps(skew_split)}; "
          f"10 runs)")
    print(f"scatter_fold plain version (scatter_fold_counts on the card: "
          f"identity rewrite + index_add_ x2) {plain_ms:.4f} ms; library "
          f"route (index_add_ x2, f32 atomics in no fixed order) "
          f"{library_ms:.4f} ms; both with L2 flushed")
    print(f"scatter_fold bound: bytes = 8 B/row x {BATCH} + 16 B x {cells} "
          f"cells = {bytes_} B over {HBM_BYTES_PER_S:.3g} B/s = "
          f"{bound_bytes_ms:.5f} ms; ops = {2 * rows} adds = "
          f"{bound_ops_ms:.6f} ms; bound by {bound_by}")
    print(f"scatter_fold multi-plane call at path 1's shapes (int64 ids; f32 "
          f"replica + f64 delta ring from one f32 column + two count planes; "
          f"max abs err {multi_errs}): median {multi_ms:.4f} ms with L2 "
          f"flushed ({_steps(multi_split)}), {multi_warm:.4f} ms warm; two "
          f"single-plane calls {two_ms:.4f} ms; the index_add_ route the "
          f"probe lane ran before (scatter_fold_counts x2) "
          f"{pair_plain_ms:.4f} ms; bound {multi_bytes} B = "
          f"{multi_bound:.5f} ms ({multi_by})")
    return {"name": "scatter_fold", "route": "cuda",
            "source": "flink_tpu_torch/csrc/scatter_fold.cu",
            "replaces": "flink_tpu/ops/scatter.py:61 (scatter_fold_counts, "
                        "an XLA scatter; no Pallas kernel)",
            "launches": 0, "max_abs_err": max(errs.values()),
            "ms": ms_cold, "ms_clean_l2": ms_clean, "ms_warm": ms_warm,
            "split_ms": split_cold, "split_ms_warm": split_warm,
            "skewed_ms": skew_ms, "skewed_split_ms": skew_split,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_bytes": bytes_, "library_ms": library_ms,
            "multi_ms": multi_ms, "multi_ms_warm": multi_warm,
            "multi_split_ms": multi_split, "two_single_ms": two_ms,
            "multi_index_add_ms": pair_plain_ms,
            "multi_bound_ms": multi_bound, "multi_bound_bytes": multi_bytes,
            "multi_max_abs_err": max(multi_errs.values())}


def check_async(fired, sync, label, ref):
    """An async path surfaces exactly the synchronous path's fires, in the
    same order and bit for bit, each at most one batch later."""
    check(len(fired) == len(sync), f"{label}: {len(fired)} fires, {ref} "
          f"{len(sync)}")
    lag = []
    for (ia, a), (ib, b) in zip(fired, sync):
        w = int(a.column("window_start")[0])
        check(w == int(b.column("window_start")[0])
              and np.asarray(a.column("k")).tobytes()
              == np.asarray(b.column("k")).tobytes()
              and np.asarray(a.column("result")).tobytes()
              == np.asarray(b.column("result")).tobytes(),
              f"{label} window {w}: differs from {ref}'s fire")
        lag.append(ia - ib)
    check(all(0 <= d <= 1 for d in lag), f"{label}: fires surfaced {lag} "
          f"batches after {ref}'s")
    print(f"{label} surfaces {ref}'s {len(sync)} fires bit for bit: "
          f"{lag.count(1)} one batch later, {lag.count(0)} in the same batch")


def host_ms(fn, runs: int = 5, setup=None) -> float:
    """Median host wall ms of ``fn()`` over ``runs`` calls, each after
    ``setup()`` if given (untimed)."""
    times = []
    for _ in range(runs):
        if setup is not None:
            setup()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def host_layer_phase(rng):
    """Phase 7b: the C layer's calls timed alone on this host."""
    from flink_tpu_torch.core.functions import SumAggregator
    from flink_tpu_torch.state.keyindex import KeyIndex, NativeKeyIndex
    from flink_tpu_torch.state.native_mirror import NativeWindowMirror

    warm = rng.permutation(N_KEYS).astype(np.int64)
    keys = rng.integers(0, N_KEYS, BATCH).astype(np.int64)
    vals = rng.random(BATCH).astype(np.float32)
    panes = np.zeros(BATCH, np.int64)
    nki = NativeKeyIndex(initial_capacity=2 * KEY_CAPACITY)
    nm = NativeWindowMirror.create(nki, SumAggregator().acc_spec(), ("add",),
                                   (np.float64,))
    nm.probe_update(warm, np.zeros(N_KEYS, np.int64),
                    [np.zeros(N_KEYS, np.float32)])
    pass_ms = {s: host_ms(lambda s=s: nm.probe_update(keys, panes, [vals],
                                                      shards=s))
               for s in sorted({1, NATIVE_SHARDS})}
    ki = KeyIndex(initial_capacity=2 * KEY_CAPACITY)
    ki.lookup_or_insert(warm)
    numpy_ms = host_ms(lambda: ki.lookup_or_insert(keys))
    cnt = np.ones(N_KEYS, np.int64)
    col = rng.random(N_KEYS)
    fresh = iter(range(1000, 2000))
    pane = [0]
    fresh_ms = host_ms(lambda: nm.apply_delta(pane[0], cnt, [col]),
                       setup=lambda: pane.__setitem__(0, next(fresh)))
    touched_ms = host_ms(lambda: nm.apply_delta(0, cnt, [col]))
    fire_ms = host_ms(lambda: nm.fire(np.zeros(1, np.int64)))
    print(f"host layer: probe + mirror pass over {BATCH} records into a "
          f"warm {N_KEYS}-key keydict: " + ", ".join(
              f"{v:.3f} ms at {k} shard(s)" for k, v in pass_ms.items())
          + f"; numpy KeyIndex.lookup_or_insert of the same keys "
          f"{numpy_ms:.3f} ms (no mirror fold)")
    print(f"host layer: apply_delta of {N_KEYS} rows into a fresh pane "
          f"{fresh_ms:.3f} ms, into a touched pane {touched_ms:.3f} ms; one "
          f"fire sweep over {N_KEYS} rows {fire_ms:.3f} ms")


def store_phase(rng):
    """Phase 9d: the spill store's array entries timed alone on this host,
    at path 7's layout (13-byte f32 cells) and budget: puts of 2^19 cells
    (part of them evicted to the log), gets in random order from the log
    and from memory, a promotion's get + delete, and deletes."""
    from flink_tpu_torch.state.spill import PaneSpillStore
    n = min(1 << 19, N_KEYS)
    gids = rng.permutation(N_KEYS)[:n].astype(np.int64)
    vals = [rng.random(n).astype(np.float32)]
    ones = np.ones(n, np.int64)
    store = PaneSpillStore(None, PATHS["path 7"]["paging"]["mem_budget"],
                           (np.float32,), ((),))
    try:
        t0 = time.perf_counter()
        store.put_many(gids, 0, 1, ones, vals)
        put_ns = (time.perf_counter() - t0) / n * 1e9
        log_bytes, mem = store.log_bytes(), store.mem_used()
        order = rng.permutation(n)
        t0 = time.perf_counter()
        found, _, _, (got,) = store.get_many(gids[order], 0)
        get_ns = (time.perf_counter() - t0) / n * 1e9
        check(found.all() and got.tobytes() == vals[0][order].tobytes(),
              "spill store: cells did not come back bit for bit")
        half = order[: n // 2]
        t0 = time.perf_counter()
        found, _, _, _ = store.get_many(gids[half], 0, delete=True)
        promote_ns = (time.perf_counter() - t0) / half.size * 1e9
        rest = order[n // 2:]
        t0 = time.perf_counter()
        gone = store.delete_many(gids[rest], 0)
        delete_ns = (time.perf_counter() - t0) / rest.size * 1e9
        check(found.all() and gone == rest.size and len(store) == 0,
              "spill store: promotions or deletes lost cells")
    finally:
        store.close()
    print(f"spill store: {n} cells of 13 B ({mem} B resident, {log_bytes} B "
          f"in the log after the puts): put {put_ns:.1f} ns/cell, get "
          f"in random order {get_ns:.1f} ns/cell, get + delete (promotion) "
          f"{promote_ns:.1f} ns/cell, delete {delete_ns:.1f} ns/cell")


def build_op(device, paging=None, mesh_blocks=0, **options):
    """The operator of a path: the headline workload's arguments and the
    path's ``options`` (the JAX operator's defaults for any it leaves
    out); ``paging`` the keyword arguments of a ``PagingConfig``;
    ``mesh_blocks`` > 0: a ``MeshWindowAggOperator`` over that many row
    blocks on the card."""
    import torch

    from flink_tpu_torch.core.functions import RuntimeContext, SumAggregator
    from flink_tpu_torch.operators.window_agg import WindowAggOperator
    from flink_tpu_torch.parallel.mesh import make_mesh
    from flink_tpu_torch.parallel.mesh_runtime import MeshWindowAggOperator
    from flink_tpu_torch.state.paging import PagingConfig
    from flink_tpu_torch.windowing.assigners import TumblingEventTimeWindows
    if paging is not None:
        options["paging"] = PagingConfig(**paging)
    if mesh_blocks:
        options["mesh"] = make_mesh(devices=[device] * mesh_blocks)
        cls = MeshWindowAggOperator
    else:
        options["device"] = device
        cls = WindowAggOperator
    op = cls(
        TumblingEventTimeWindows.of(WINDOW_MS), SumAggregator(torch.float32),
        key_column="k", value_column="v", initial_key_capacity=KEY_CAPACITY,
        **options)
    op.open(RuntimeContext())
    return op


def digests(out):
    """(window start, rows, f64 sum of the results, hash of the keys' and
    results' bytes) per fire."""
    return [(int(b.column("window_start")[0]), len(b),
             float(np.asarray(b.column("result"), np.float64).sum()),
             hashlib.sha256(np.asarray(b.column("k")).tobytes()
                            + np.asarray(b.column("result")).tobytes())
             .hexdigest())
            for b in out]


def by_window(fired):
    """One batch per window, its rows sorted by key (a paged fire emits the
    resident keys, then the spilled keys chunk by chunk, as several
    batches)."""
    from flink_tpu_torch.core.batch import RecordBatch
    parts = {}
    for b in fired:
        parts.setdefault(int(b.column("window_start")[0]), []).append(b)
    out = []
    for bs in parts.values():
        cols = {c: np.concatenate([np.asarray(b.column(c)) for b in bs])
                for c in bs[0].columns}
        order = np.argsort(cols["k"], kind="stable")
        out.append(RecordBatch({c: v[order] for c, v in cols.items()}))
    return out


def window_digests(out):
    """``digests`` of the fires merged per window and sorted by key."""
    return digests(by_window(out))


def digest_fn(label):
    return window_digests if label in PAGED_PATHS else digests


def reference(batches):
    """Independent numpy reference: window start -> (f64 sums, counts) per
    key, a plain bincount over every record of the window."""
    expect = {}
    for keys, vals, ts in batches:
        starts = ts // WINDOW_MS * WINDOW_MS
        for w in np.unique(starts).tolist():
            m = starts == w
            sums, cnt = expect.setdefault(w, (np.zeros(N_KEYS),
                                              np.zeros(N_KEYS, np.int64)))
            sums += np.bincount(keys[m], weights=vals[m].astype(np.float64),
                                minlength=N_KEYS)
            cnt += np.bincount(keys[m], minlength=N_KEYS)
    return expect


def reference_f32(batches):
    """The device tier's bits, independently: window start -> f32 cells per
    key, each record added in record order (``np.add.at``); a tumbling
    window is one pane, so its fire is the cell itself."""
    cells = {}
    for keys, vals, ts in batches:
        starts = ts // WINDOW_MS * WINDOW_MS
        for w in np.unique(starts).tolist():
            m = starts == w
            np.add.at(cells.setdefault(w, np.zeros(N_KEYS, np.float32)),
                      keys[m], vals[m])
    return cells


def check_fires_bits(fired, cells, label):
    """Every fire's values equal the f32 reference bit for bit."""
    for b in fired:
        w = int(b.column("window_start")[0])
        res = np.asarray(b.column("result"))
        want = cells[w][np.asarray(b.column("k"))]
        check(res.dtype == np.float32 and np.array_equal(
            res.view(np.uint32), want.view(np.uint32)),
            f"{label} window {w}: results differ from the f32 ordered "
            f"reference in their bits ({int((res != want).sum())} rows, max "
            f"abs {np.max(np.abs(res - want))})")


def check_fires(fired, expect, label):
    """Every window fired once, with the reference's keys and sums."""
    starts = [int(b.column("window_start")[0]) for b in fired]
    check(starts == sorted(expect), f"{label}: fired windows {starts} != "
          f"reference {sorted(expect)}")
    for w, b in zip(starts, fired):
        sums, cnt = expect[w]
        keys = np.asarray(b.column("k"))
        check(np.array_equal(np.sort(keys), np.flatnonzero(cnt)),
              f"{label} window {w}: fired keys differ from the reference")
        res = np.asarray(b.column("result"))
        check(np.allclose(res, sums[keys], rtol=RTOL, atol=0),
              f"{label} window {w}: results differ from the reference (max "
              f"abs {np.max(np.abs(res - sums[keys]))})")


def check_twin(fired, twin, label, rtol=None):
    """A path's fires against another's: the same windows, keys in the same
    (slot) order, values bit for bit, or to ``rtol`` where given."""
    check(len(fired) == len(twin), f"{label}: {len(fired)} fires, its twin "
          f"{len(twin)}")
    for a, b in zip(fired, twin):
        w = int(a.column("window_start")[0])
        check(w == int(b.column("window_start")[0])
              and np.array_equal(np.asarray(a.column("k")),
                                 np.asarray(b.column("k"))),
              f"{label} window {w}: keys differ from the numpy twin's")
        ra, rb = np.asarray(a.column("result")), np.asarray(b.column("result"))
        check(ra.tobytes() == rb.tobytes() if rtol is None
              else np.allclose(ra, rb, rtol=rtol, atol=0),
              f"{label} window {w}: values differ from the twin's (max abs "
              f"{np.max(np.abs(ra - rb))})")


def reset_launches() -> None:
    from flink_tpu_torch.ops import scatter as sc
    from flink_tpu_torch.state import device_keyindex as dk
    dk.probe.launches = 0
    dk.probe_fold.launches = 0
    sc.ordered_fold_counts.launches = 0
    sc.ordered_fold_counts_multi.launches = 0


def read_launches():
    """Launches per kernel; ``scatter_fold`` sums its two wrappers' counts,
    each also given alone (``_single``: ``ordered_fold_counts``,
    ``_multi``: ``ordered_fold_counts_multi``)."""
    from flink_tpu_torch.ops import scatter as sc
    from flink_tpu_torch.state import device_keyindex as dk
    single = sc.ordered_fold_counts.launches
    multi = sc.ordered_fold_counts_multi.launches
    return {"probe": dk.probe.launches, "probe_fold": dk.probe_fold.launches,
            "scatter_fold": single + multi, "scatter_fold_single": single,
            "scatter_fold_multi": multi}


def lane_of(op) -> dict:
    """The lane an operator resolved to (slice 8's ``auto`` settings)."""
    stats, fused = op.device_probe_stats(), op.fused_stats()
    return {"emit_tier": op.emit_tier,
            "snapshot_source": op.snapshot_source,
            "device_sync_mode": op.device_sync_mode,
            "device_probe": bool(stats["enabled"]),
            "superbatch": fused["depth"] or 1,
            "native_mirror_active": op.native_mirror_active,
            "nm_shards": op._nm_shards,
            "calibrating_batches": op._calib_batches}


def counters_of(op) -> dict:
    """Every counter a run leaves: the probe's, the fused lane's, the
    pager's and the operator's own."""
    return {"probe": op.device_probe_stats(), "fused": op.fused_stats(),
            "paging": op.paging_stats(), "late_dropped": op.late_dropped,
            "num_keys": op.key_index.num_keys, "watermark": op.watermark,
            "last_fired_window": op.last_fired_window}


def snap_bytes(snap) -> tuple:
    """A snapshot's arrays as bytes and its scalars, for bit comparisons."""
    return (tuple(snap[k] for k in ("pane_base", "max_pane",
                                    "last_fired_window", "watermark",
                                    "late_dropped", "P")),
            np.asarray(snap["panes"]).tobytes(),
            np.asarray(snap["counts"]).tobytes(),
            tuple(np.asarray(l).tobytes() for l in snap["leaves"]),
            np.asarray(snap["key_index"]["reverse"]).tobytes())


def main_path(device, batches, expect, label):
    """Drive one main path with every launch count at 0 just before and
    read just after; returns (launches per kernel, first snapshot, digests
    of the fires after it, every fire with the batch it surfaced at, the
    path's numbers)."""
    import torch

    from flink_tpu_torch.core.batch import RecordBatch, Watermark
    from flink_tpu_torch.runtime import device_health
    from flink_tpu_torch.testing import chaos

    fault = FAULTS.get(label)
    sharded = bool(PATHS[label].get("mesh_blocks"))
    mon = (device_health.DeviceHealthMonitor(
        device_health.WatchdogConfig(**FAST_WATCHDOG), heal_async=False)
        if fault else device_health.DeviceHealthMonitor())
    device_health.set_monitor(mon)
    op = build_op(device, **PATHS[label])
    watch = watch_tiers(op) if fault else None
    inj = chaos.FaultInjector(seed=7) if fault else None
    sched = None
    device_tier = op.emit_tier == "device"
    fire_ms = []
    fired = []
    after_snap = []
    mid = None
    snaps, snap_d2h = 0, 0
    per_batch = []

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    if fault:
        chaos.install(inj)
    t0 = time.perf_counter()
    for i, (keys, vals, ts) in enumerate(batches):
        if fault and i == fault["inject_at"]:
            sched = inj.inject("device.dispatch", fault["schedule"](
                chaos, inj.fired("device.dispatch")))
        out = op.process_batch(RecordBatch({"k": keys, "v": vals},
                                           timestamps=ts))
        if watch is not None:
            watch["batches"].append(op._degraded)
        pending = len(op._pending_fires)
        f0 = time.perf_counter()
        wm_out = op.process_watermark(Watermark(int(ts.max()) - 1))
        if wm_out or len(op._pending_fires) > pending:
            # a call that fired (or, async, started a fire's download)
            fire_ms.append((time.perf_counter() - f0) * 1e3)
        out += wm_out
        snapshot_now = (i + 1) % SNAPSHOT_EVERY == 0
        if snapshot_now:
            # async fires surface before the barrier
            out += op.prepare_snapshot_pre_barrier()
        fired += [(i, b) for b in out]
        if mid is not None:
            after_snap += out
        if snapshot_now:
            d0 = op.phase_bytes.get("d2h", 0)
            snap = op.snapshot_state()
            snaps += 1
            snap_d2h += op.phase_bytes.get("d2h", 0) - d0
            if mid is None:
                mid = (i, snap)
        per_batch.append(dict(op.device_probe_stats(),
                              staged=op.fused_stats()["staged_batches"]))
        if fault and i == fault["heal_at"]:
            sched.heal()
            check(mon.probe_now(), f"{label}: the healed schedule's probe "
                  f"failed")
    f0 = time.perf_counter()
    tail = op.end_input()
    fire_ms.append((time.perf_counter() - f0) * 1e3)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    chaos.uninstall()
    launches = read_launches()
    health = check_monitor(op, mon, label, device)
    fired += [(len(batches), b) for b in tail]
    after_snap += tail
    stats = op.device_probe_stats()
    fused = op.fused_stats()
    lane = lane_of(op)
    paged = label in PAGED_PATHS
    plain = [b for _, b in fired]
    check_fires(by_window(plain) if paged else plain, expect, label)
    native = op.native_emit and not device_tier
    check(op.native_mirror_active == native,
          f"{label}: native_mirror_active is {op.native_mirror_active}")
    if device_tier:
        check(stats["enabled"] == 0 and stats["probe_hits"] == 0,
              f"{label}: the device probe ran on the device tier")
        check(launches["scatter_fold"] > 0 and launches["probe_fold"] == 0,
              f"{label}: launches {launches}; the device tier folds through "
              f"scatter_fold and launches no probe_fold")
        check(launches["probe"] == 0 or label == "path 8",
              f"{label}: launches {launches}; the device tier launches no "
              f"probe (outside path 8's calibration)")
        # (the unpaged mesh fires at full capacity: no emit mirror)
        check(("emit_mirror" in op.phase_ns
               or sharded and op._pager is None) and "probe" in op.phase_ns
              and ("mirror" not in op.phase_ns
                   or health["quarantine_migrations"]),
              f"{label}: the device tier's phases are wrong: "
              f"{sorted(op.phase_ns)}")
        check(not op._pending_fires, f"{label}: fires left pending")
        if paged:
            check_paging(op, label)
    else:
        check(stats["probe_hits"] > 0 or not stats["enabled"],
              f"{label}: the probe never hit")
        check(native or "probe_mirror" in op.phase_ns
              and "mirror" in op.phase_ns,
              f"{label}: the numpy lane's phases are missing")
        check(not native or "mirror" not in op.phase_ns,
              f"{label}: the C lane ran a numpy mirror fold")
        deferred = op.device_sync_mode == "deferred"
        if stats["enabled"] and fused["depth"] > 1:
            check(launches["probe_fold" if deferred else "probe"] > 0,
                  f"{label}: the one-step passes launched no "
                  f"{'probe_fold' if deferred else 'probe'}: {launches}")
            check(fused["scan_dispatches"] > 0, f"{label}: no one-step pass")
            check(fused["scan_steps"] > fused["scan_dispatches"],
                  f"{label}: the one-step passes covered one batch each")
        elif stats["enabled"]:
            check(launches["probe"] > 0,
                  f"{label} never launched the probe kernel")
            # (the mesh folds the delta ring and the replica block by
            # block, each through the single-tree scatter_fold)
            check(deferred or launches["scatter_fold_single" if sharded
                                       else "scatter_fold_multi"] > 0,
                  f"{label}: the probe lane never folded its replica and "
                  f"delta ring through the ordered scatter_fold")
        else:
            check(deferred or launches["scatter_fold_single"] > 0,
                  f"{label}: the probe-off scatter lane never launched "
                  f"scatter_fold")
    check(fused["staged_pending"] == 0, f"{label}: batches left staged")
    check(op.verify_mirror(), f"{label}: device replica != host mirror")
    n_records = sum(len(b[0]) for b in batches)
    # a paged fire is several batches (the resident keys, then the spilled
    # keys chunk by chunk): count windows
    n_fires = len(by_window(plain)) if paged else len(fired)
    print(f"{label} {PATHS[label]}: {n_records} records in {elapsed:.3f} s "
          f"= {n_records / elapsed:.1f} records/s; {n_fires} windows "
          f"fired and matched the numpy reference (rtol {RTOL}); launches "
          f"{launches}; probe hits {stats['probe_hits']}, misses "
          f"{stats['probe_misses']}; native_mirror_active "
          f"{op.native_mirror_active}")
    if fused["scan_dispatches"] or fused["host_super_passes"]:
        print(f"{label} fused lane: {fused}" + (
            f"; scan depth {fused['scan_steps'] / fused['scan_dispatches']:.3f}"
            f" batches per one-step pass" if fused["scan_dispatches"]
            else ""))
    p50, p99 = np.percentile(fire_ms, 50), np.percentile(fire_ms, 99)
    print(f"{label} fire latency ms over {len(fire_ms)} firing calls: p50 "
          f"{p50:.3f} p99 {p99:.3f}")
    print(f"{label} phase_ns: " + json.dumps(op.phase_ns, sort_keys=True))
    print(f"{label} phase_bytes: " + json.dumps(op.phase_bytes,
                                                sort_keys=True))
    fire_d2h = op.phase_bytes.get("d2h", 0) - snap_d2h
    print(f"{label} d2h bytes: {fire_d2h / max(n_fires, 1):.0f} per fire "
          f"({n_fires} fires), {snap_d2h / max(snaps, 1):.0f} per snapshot "
          f"({snaps} snapshots)")
    print(f"{label} peak device memory: {torch.cuda.max_memory_allocated()} B")
    ring_bytes = sum(t.nbytes for t in state_tensors(op))
    numbers = {"records_per_s": n_records / elapsed, "wall_s": elapsed,
               "fire_p50_ms": p50, "fire_p99_ms": p99,
               "d2h_per_fire": fire_d2h / max(n_fires, 1),
               "d2h_per_snapshot": snap_d2h / max(snaps, 1),
               "phase_ms": {k: v / 1e6 for k, v in op.phase_ns.items()},
               "ring_bytes": ring_bytes, "lane": lane,
               "counters": counters_of(op), "per_batch": per_batch,
               "monitor": dict(mon.counters), "health": health,
               "hot_dispatches": op.fused_stats()["hot_dispatches"],
               "shard_ns": {k: v.tolist()
                            for k, v in op.phase_shard_ns.items()}}
    if sharded:
        check(len(op._counts) == MESH_BLOCKS
              and all(c.shape[0] == op._K // MESH_BLOCKS
                      for c in op._counts),
              f"{label}: the state is not {MESH_BLOCKS} row blocks")
        print(f"{label} mesh: {MESH_BLOCKS} blocks of {op._K // MESH_BLOCKS}"
              f" rows on {device}; exchange capacity {op._exchange_cap_hw} "
              f"rows a (source, destination) pair, "
              f"{op.mesh_step_cache_size()} exchange geometries; "
              f"phase_shard_ns (ms) " + json.dumps(
                  {k: [round(x / 1e6, 3) for x in v]
                   for k, v in op.phase_shard_ns.items()}))
    print(f"{label} watchdog: {mon.counters['dispatches']} guarded "
          f"dispatches ({mon.counters['dispatches'] / len(batches):.2f} a "
          f"batch; labels {json.dumps(mon.label_counts, sort_keys=True)}); "
          f"monitor {json.dumps(mon.counters, sort_keys=True)}; "
          f"device_health_stats {json.dumps(health, sort_keys=True)}")
    if watch is not None:
        numbers["watch"] = report_watch(label, watch, mon)
    if paged:
        numbers.update(
            page_out_per_batch=op.phase_bytes.get("d2h_page_out", 0)
            / len(batches),
            page_in_per_batch=op.phase_bytes.get("h2d_page_in", 0)
            / len(batches),
            paging_stats=op.paging_stats())
        print(f"{label} paging: ring {ring_bytes} B on the card "
              f"({op._K} rows x {op._P} panes); d2h_page_out "
              f"{numbers['page_out_per_batch']:.0f} B and h2d_page_in "
              f"{numbers['page_in_per_batch']:.0f} B per batch; paging "
              f"phase {op.phase_ns.get('paging', 0) / 1e6 / len(batches):.3f}"
              f" ms per batch; paging_stats "
              + json.dumps(numbers["paging_stats"], sort_keys=True))
    op.close()
    return launches, mid, digest_fn(label)(after_snap), fired, numbers


def check_monitor(op, mon, label, device) -> dict:
    """The no-fallback checks of every path: its monitor counted exactly
    what the path's schedule injects (on paths 1-10: no quarantine, no
    timeout, no retry, no page-out), the tier ends healthy with every
    migration re-promoted, and the state is back on the card.  Returns
    ``device_health_stats()``."""
    want = EXPECT_MONITOR.get(label, QUIET)
    got = {k: mon.counters[k] for k in want}
    check(got == want, f"{label}: the monitor counted {got}, expected {want}"
          f" (last failure: {mon.last_failure})")
    check(mon.healthy, f"{label}: the tier ends quarantined")
    health = op.device_health_stats()
    moved = want["quarantines"]
    check(health == {"degraded": 0, "quarantine_migrations": moved,
                     "repromotions": moved},
          f"{label}: device_health_stats {health}")
    check(op._leaves is not None and all(
        t.device.type == device.type for t in state_tensors(op)),
        f"{label}: the state is not on the card")
    return health


def state_tensors(op) -> list:
    """Every tensor of an operator's ring (each block's, when sharded)."""
    return [t for _, leaves, counts in op._row_blocks(op._leaves, op._counts)
            for t in (*leaves, counts)]


def watch_tiers(op) -> dict:
    """Times a watchdog path's tier moves on ``op``: each salvage (the
    migration's ring download, or the probe lane's delta pull, on the
    monitor's lane) and each re-promotion that happened; the loop appends
    the per-batch degraded flags to ``batches``."""
    watch = {"batches": [], "salvage": [], "repromote": []}
    salvage, repromote = op._salvage, op._maybe_repromote

    def timed_salvage(err, read, what):
        t0 = time.perf_counter()
        try:
            return salvage(err, read, what)
        finally:
            watch["salvage"].append((what, (time.perf_counter() - t0) * 1e3))

    def timed_repromote():
        t0 = time.perf_counter()
        done = repromote()
        if done:
            watch["repromote"].append((time.perf_counter() - t0) * 1e3)
        return done
    op._salvage = timed_salvage
    op._maybe_repromote = timed_repromote
    return watch


def report_watch(label, watch, mon) -> dict:
    """A watchdog path's tier moves: the degraded batches (one contiguous
    run when a quarantine was injected), salvage and re-promotion times."""
    flags = watch["batches"]
    degraded = [i for i, d in enumerate(flags) if d]
    out = {"degraded_batches": len(degraded),
           "wedge_batch": degraded[0] if degraded else None,
           "repromote_batch": degraded[-1] if degraded else None,
           "salvage_ms": watch["salvage"], "repromote_ms": watch["repromote"]}
    if EXPECT_MONITOR[label]["quarantines"]:
        check(degraded and degraded == list(range(degraded[0],
                                                  degraded[-1] + 1))
              and len(watch["repromote"]) == 1,
              f"{label}: degraded batches {degraded}, re-promotions "
              f"{watch['repromote']}")
    print(f"{label} tier moves: {len(degraded)} degraded batches"
          + (f" ({degraded[0]}..{degraded[-1]}: the wedge in batch "
             f"{degraded[0]}, re-promotion at batch {degraded[-1]}'s "
             f"checkpoint barrier)" if degraded else "")
          + "; salvage " + (", ".join(f"{w} {ms:.3f} ms" for w, ms in
                                      watch["salvage"]) or "none")
          + "; re-promotion " + (", ".join(f"{ms:.3f} ms" for ms in
                                           watch["repromote"]) or "none")
          + f"; last failure: {mon.last_failure}")
    return out


def touched_windows(watch) -> set:
    """Starts of the windows a quarantine touched: those live at the
    migration (fired in or after the wedge batch's watermark) that hold a
    batch up to the re-promotion.  Window j holds batches 5j..5j+4 and
    fires in batch 5j+5's watermark."""
    w, r = watch["wedge_batch"], watch["repromote_batch"]
    per = WINDOW_MS // 1000
    return {j * WINDOW_MS for j in range(N_BATCHES // per + 1)
            if j * per + per >= w and j * per <= r}


def check_fault_path(label, plain, numbers, base_fires, base_numbers,
                     cells):
    """A watchdog path against its base path.  Path 11: untouched windows
    equal path 5's and the f32 reference bit for bit (every window is held
    to the numpy reference at rtol 1e-6 by ``main_path``).  Path 12:
    untouched windows equal path 3's bit for bit, touched ones to
    ``F64_REASSOCIATION_RTOL``.  Path 13: path 7's fires by key bit for
    bit, more evictions than path 7."""
    base = [b for _, b in base_fires]
    if label == "path 13":
        check_twin(by_window(plain), by_window(base), label)
        ev = numbers["counters"]["paging"]["evictions"]
        ev7 = base_numbers["counters"]["paging"]["evictions"]
        check(ev > ev7, f"{label}: {ev} evictions, path 7 {ev7}: the forced "
              f"page-out evicted nothing")
        print(f"{label} fires equal path 7's by key bit for bit; the OOM's "
              f"forced page-out: {ev} evictions against path 7's {ev7}, "
              f"oom_pageouts {numbers['monitor']['oom_pageouts']}, "
              f"quarantines {numbers['monitor']['quarantines']}")
        return
    touched = touched_windows(numbers["watch"])
    untouched = [b for b in plain
                 if int(b.column("window_start")[0]) not in touched]
    want = [b for b in base
            if int(b.column("window_start")[0]) not in touched]
    check(len(untouched) >= 2 and len(plain) == len(base),
          f"{label}: {len(untouched)} untouched of {len(plain)} windows")
    check_twin(untouched, want, label)
    if label in DEVICE_FAULTS:
        check_fires_bits(untouched, cells, label)
    else:
        check_twin([b for b in plain if int(b.column("window_start")[0])
                    in touched],
                   [b for b in base if int(b.column("window_start")[0])
                    in touched], label, rtol=F64_REASSOCIATION_RTOL)
    print(f"{label}: windows {sorted(touched)} touched by the quarantine "
          f"(held to the numpy reference at rtol {RTOL}"
          + ("" if label in DEVICE_FAULTS else
             f" and to {FAULTS[label]['base']}'s at rtol "
             f"{F64_REASSOCIATION_RTOL}")
          + f"); the other {len(untouched)} equal "
          f"{FAULTS[label]['base']}'s bit for bit"
          + (" and the f32 ordered reference" if label in DEVICE_FAULTS
             else ""))


def fault_replays(device, batches, mid, want, label):
    """The mid-quarantine snapshot restored under a healthy monitor and
    under one still quarantined (whose first dispatch migrates the replay
    at once): both replays fire the run's windows and rows, with sums to
    rtol 1e-6 (the run re-promoted mid-replay; the replays stay on one tier
    each), and the quarantined one ends degraded."""
    from flink_tpu_torch.runtime import device_health
    got = {}
    for quarantined in (False, True):
        mon = device_health.DeviceHealthMonitor(
            device_health.WatchdogConfig(**FAST_WATCHDOG), heal_async=False)
        if quarantined:
            mon.quarantine("chip smoke: the card is still wedged")
        device_health.set_monitor(mon)
        wall, out, health = _replay_once(device, batches, mid, label)
        check(health["degraded"] == health["quarantine_migrations"]
              == int(quarantined),
              f"{label} replay (quarantined={quarantined}): {health}")
        got[quarantined] = digests(out)
        check(len(got[quarantined]) == len(want) and len(want) > 0
              and all(w1 == w2 and n1 == n2
                      and abs(s1 - s2) <= 1e-6 * max(abs(s2), 1)
                      for (w1, n1, s1, _), (w2, n2, s2, _) in
                      zip(got[quarantined], want)),
              f"{label} replay (quarantined={quarantined}) differs from "
              f"the run")
        state = "quarantined" if quarantined else "healthy"
        print(f"{label} restore+replay from batch {mid[0]} (snapshot taken "
              f"degraded) under a {state} monitor: {len(want)} windows with the run's rows and sums; "
              f"wall {wall * 1e3:.3f} ms; device_health_stats {health}")
    same = sum(a[3] == b[3] for a, b in zip(got[False], got[True]))
    print(f"{label} the two replays fire the same windows and keys; "
          f"{same} of {len(want)} windows bit for bit")


def check_mesh_path(label, fires, mids, numbers) -> None:
    """A mesh path against its single-block twin (``MESH_TWIN``), in the
    same process on the same batches: path 14's and 15's fires surface at
    the same calls with the same keys in the same order and the same bytes,
    path 14's mid-run snapshot, densified, is path 3's byte for byte, and
    its C pass reports one time per block; path 16's fires equal path
    11's (the same wedge, migration and re-promotion, of 4 blocks against
    one); path 17's fires equal path 7's by key, and every paging counter
    does."""
    from flink_tpu_torch.state.shard_layout import (densify_keyed_snapshot,
                                                    has_shard_slices)
    twin = MESH_TWIN[label]
    plain = [b for _, b in fires[label]]
    base = [b for _, b in fires[twin]]
    if label in PAGED_PATHS:
        check_twin(by_window(plain), by_window(base), label)
        a = numbers[label]["counters"]["paging"]
        b = numbers[twin]["counters"]["paging"]
        check(a == b, f"{label}: paging_stats {a} != {twin}'s {b}")
        print(f"{label} fires equal {twin}'s by key bit for bit, and every "
              f"paging counter equals {twin}'s: {json.dumps(a)}")
        return
    check([i for i, _ in fires[label]] == [i for i, _ in fires[twin]],
          f"{label}: fires surfaced at other batches than {twin}'s")
    check_twin(plain, base, label)
    snap = mids[label][1]
    check(has_shard_slices(snap), f"{label}: the mid-run snapshot has no "
          f"per-shard slices")
    if label == "path 14":
        dense = densify_keyed_snapshot(snap)
        check(mids[label][0] == mids[twin][0]
              and snap_bytes(dense) == snap_bytes(mids[twin][1]),
              f"{label}: the densified mid-run snapshot differs from "
              f"{twin}'s")
        per_shard = numbers[label]["shard_ns"].get("probe_mirror", [])
        check(len(per_shard) == MESH_BLOCKS and sum(per_shard) > 0,
              f"{label}: phase_shard_ns['probe_mirror'] {per_shard}")
    print(f"{label} fires equal {twin}'s bit for bit (same calls, keys in "
          f"the same order, values)"
          + ("; its densified mid-run snapshot equals path 3's byte for "
             "byte; the C pass reported its "
             f"{MESH_BLOCKS} shards' times" if label == "path 14" else ""))


def rescale_replays(device, batches, mid, want, label) -> None:
    """Path 15's mid-run snapshot (4 blocks) restored at the mesh sizes of
    ``RESCALE_BLOCKS`` (1: the single-card operator) and replayed: every
    window digest equals path 15's bit for bit."""
    for blocks in RESCALE_BLOCKS:
        opts = dict(PATHS[label], mesh_blocks=blocks if blocks > 1 else 0)
        wall, out, _ = _replay_once(device, batches, mid, label,
                                    options=opts)
        got = digests(out)
        check(got == want, f"{label}: the replay rescaled to {blocks} "
              f"block(s) differs from the run")
        print(f"{label} rescale: the mid-run snapshot of batch {mid[0]} "
              f"({MESH_BLOCKS} blocks) restored at {blocks} block(s) "
              f"replays {len(got)} windows bit for bit; wall "
              f"{wall * 1e3:.3f} ms")


def ab_run(device, batches, label):
    """One run of a path as ``main_path`` drives it (snapshots, its fault
    schedule and monitor), timed; returns (wall s, digests of its fires)."""
    import torch

    from flink_tpu_torch.core.batch import RecordBatch, Watermark
    from flink_tpu_torch.runtime import device_health
    from flink_tpu_torch.testing import chaos

    fault = FAULTS.get(label)
    mon = (device_health.DeviceHealthMonitor(
        device_health.WatchdogConfig(**FAST_WATCHDOG), heal_async=False)
        if fault else device_health.DeviceHealthMonitor())
    device_health.set_monitor(mon)
    op = build_op(device, **PATHS[label])
    inj = chaos.FaultInjector(seed=7) if fault else None
    sched, out = None, []
    if fault:
        chaos.install(inj)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        for i, (keys, vals, ts) in enumerate(batches):
            if fault and i == fault["inject_at"]:
                sched = inj.inject("device.dispatch", fault["schedule"](
                    chaos, inj.fired("device.dispatch")))
            out += op.process_batch(RecordBatch({"k": keys, "v": vals},
                                                timestamps=ts))
            out += op.process_watermark(Watermark(int(ts.max()) - 1))
            if (i + 1) % SNAPSHOT_EVERY == 0:
                out += op.prepare_snapshot_pre_barrier()
                op.snapshot_state()
            if fault and i == fault["heal_at"]:
                sched.heal()
                check(mon.probe_now(), f"A/B {label}: the healed "
                      f"schedule's probe failed")
        out += op.end_input()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        chaos.uninstall()
    check_monitor(op, mon, label, device)
    op.close()
    return wall, digest_fn(label)(out)


def mesh_ab(device, batches, want, card) -> dict:
    """Each mesh path against its single-block twin on the same batches,
    in turns twin, mesh, mesh, twin, each run's fires bit-equal to its
    path's main run: records/s and their median ratio, beside the card's
    nvidia-smi line."""
    n = sum(len(b[0]) for b in batches)
    ratios = {}
    for label, twin in MESH_TWIN.items():
        rate = {twin: [], label: []}
        for side in (twin, label, label, twin):
            wall, got = ab_run(device, batches, side)
            check(got == want[side], f"A/B {side}: fires differ from "
                  f"{side}'s run")
            rate[side].append(n / wall)
        ratios[label] = np.median(rate[label]) / np.median(rate[twin])
        print(f"A/B {label} ({MESH_BLOCKS} blocks on one card) vs {twin} "
              f"(one block), same batches, turns {twin}, {label}, {label}, "
              f"{twin}: records/s " + ", ".join(
                  f"{k} " + " / ".join(f"{r:.1f}" for r in v)
                  for k, v in rate.items())
              + f" (median ratio {ratios[label]:.3f}x); every run bit-equal "
              f"to its path's fires; card: {card}")
    return ratios


def guard_run(device, batches, label, guarded):
    """One run of a path's options over the batches, with the watchdog on
    (a fresh monitor of the default configuration) or off
    (``FLINK_TPU_DEVICE_WATCHDOG=off``); returns (wall s, digests, phase ms,
    guarded dispatches, hot dispatches, per-dispatch medians in ms of the
    hand-off to the thunk, the thunk, the hand-back to the caller).  The
    dispatches are timed through a wrapper of ``guarded_dispatch`` in both
    modes."""
    import torch

    from flink_tpu_torch.core.batch import RecordBatch, Watermark
    from flink_tpu_torch.runtime import device_health
    mon = device_health.DeviceHealthMonitor()
    device_health.set_monitor(mon)
    if not guarded:
        os.environ["FLINK_TPU_DEVICE_WATCHDOG"] = "off"
    real, marks = device_health.guarded_dispatch, []

    def timed_dispatch(fn, **kw):
        mark = {}

        def thunk():
            mark["s"] = time.perf_counter()
            try:
                return fn()
            finally:
                mark["e"] = time.perf_counter()
        t0 = time.perf_counter()
        out = real(thunk, **kw)
        marks.append((mark["s"] - t0, mark["e"] - mark["s"],
                      time.perf_counter() - mark["e"]))
        return out
    device_health.guarded_dispatch = timed_dispatch
    try:
        op = build_op(device, **PATHS[label])
        out = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for keys, vals, ts in batches:
            out += op.process_batch(RecordBatch({"k": keys, "v": vals},
                                                timestamps=ts))
            out += op.process_watermark(Watermark(int(ts.max()) - 1))
        out += op.end_input()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        hot = op.fused_stats()["hot_dispatches"]
        phase = {k: v / 1e6 for k, v in op.phase_ns.items()}
        op.close()
    finally:
        os.environ.pop("FLINK_TPU_DEVICE_WATCHDOG", None)
        device_health.guarded_dispatch = real
    check(mon.counters["quarantines"] == 0
          and mon.counters["dispatches"] == (hot if guarded else 0)
          and len(marks) == hot,
          f"guard A/B {label}: monitor {mon.counters}, {hot} dispatches, "
          f"{len(marks)} timed")
    return (wall, digests(out), phase, mon.counters["dispatches"], hot,
            tuple(np.median(np.asarray(marks) * 1e3, axis=0)))


def guard_ab(device, batches, want) -> dict:
    """The guard's cost: each of ``GUARD_AB`` with the watchdog on and off,
    on the same batches, in turns on, off, off, on, twice, each run's fires
    bit-equal to the path's main run; records/s, the phases, dispatches a
    batch and a dispatch's hand-off times."""
    n = sum(len(b[0]) for b in batches)
    result = {}
    for label in GUARD_AB:
        runs = {True: [], False: []}
        for guarded in (True, False, False, True) * 2:
            wall, got, phase, dispatches, hot, marks = guard_run(
                device, batches, label, guarded)
            check(got == want[label], f"guard A/B {label} (watchdog "
                  f"{'on' if guarded else 'off'}): fires differ from "
                  f"{label}'s run")
            runs[guarded].append((n / wall, phase, dispatches, hot, marks))
        result[label] = runs
        phases = sorted(set(runs[True][0][1]) | set(runs[False][0][1]))
        ph = lambda r, k: " / ".join(  # noqa: E731
            f"{x[1].get(k, 0.0):.3f}" for x in r)
        ratio = (np.median([x[0] for x in runs[True]])
                 / np.median([x[0] for x in runs[False]]))
        print(f"A/B guard {label} watchdog on vs off, same batches, turns "
              f"on, off, off, on, twice: records/s on "
              + " / ".join(f"{x[0]:.1f}" for x in runs[True]) + ", off "
              + " / ".join(f"{x[0]:.1f}" for x in runs[False])
              + f" (median ratio {ratio:.3f}x); "
              f"guarded dispatches a batch on "
              f"{runs[True][0][2] / len(batches):.3f} (hot_dispatches "
              f"{runs[True][0][3]}), off {runs[False][0][2]} (hot_dispatches "
              f"{runs[False][0][3]}); a dispatch's medians (ms; hand-off "
              f"to the thunk, the thunk, hand-back) on "
              + " / ".join("(%.3f, %.3f, %.3f)" % x[4] for x in runs[True])
              + ", off "
              + " / ".join("(%.3f, %.3f, %.3f)" % x[4] for x in runs[False])
              + "; phase ms on | off: "
              + "; ".join(f"{k} {ph(runs[True], k)} | {ph(runs[False], k)}"
                          for k in phases)
              + f"; every run bit-equal to {label}'s fires")
    lane_round_trip()
    return result


def lane_round_trip(n: int = 400, rounds: int = 5) -> None:
    """What the guard itself costs a dispatch, alone: an empty thunk
    through ``run_guarded`` (a queue hand-off to the lane thread and an
    event wait back) against the same thunk called inline; medians of
    ``rounds`` rounds of ``n`` calls, host clock."""
    from flink_tpu_torch.runtime import device_health
    mon = device_health.DeviceHealthMonitor()
    noop = lambda: None  # noqa: E731
    mon.run_guarded(noop)
    guarded, inline = [], []
    for _ in range(rounds):
        t0 = time.perf_counter_ns()
        for _ in range(n):
            mon.run_guarded(noop)
        guarded.append((time.perf_counter_ns() - t0) / n / 1e3)
        t0 = time.perf_counter_ns()
        for _ in range(n):
            noop()
        inline.append((time.perf_counter_ns() - t0) / n / 1e3)
    print(f"guard round trip: an empty thunk through run_guarded "
          f"{np.median(guarded):.1f} us (rounds "
          + " / ".join(f"{g:.1f}" for g in guarded)
          + f"), inline {np.median(inline):.3f} us; {n} calls a round")


def healer_phase() -> float:
    """The healer's card check: one throwaway process launches on the card
    and synchronizes; must report healthy.  Returns its seconds."""
    from flink_tpu_torch.runtime import device_health
    t0 = time.perf_counter()
    ok = device_health.probe_backend_subprocess(timeout_s=120)
    seconds = time.perf_counter() - t0
    check(ok, "the healer's subprocess probe reported the card unhealthy")
    print(f"healer probe: probe_backend_subprocess(timeout_s=120) True in "
          f"{seconds:.3f} s (a fresh process: import torch, one launch, "
          f"synchronize)")
    return seconds


def check_paging(op, label):
    """A paged path ran the ring as a cache: full, with evictions,
    promotions and a spill tier partly in its disk log."""
    st = op.paging_stats()
    n_keys = op.key_index.num_keys
    cap = PATHS[label]["paging"]["capacity"]
    check(st["capacity"] == cap and op._K == cap
          and st["resident_keys"] == cap
          and st["spilled_keys"] == n_keys - cap and st["evictions"] > 0
          and st["promotions"] > 0 and st["spill_log_bytes"] > 0,
          f"{label}: paging_stats {st} (capacity {cap}, {n_keys} keys)")
    check("paging" in op.phase_ns and op.phase_bytes.get("d2h_page_out", 0)
          > 0 and op.phase_bytes.get("h2d_page_in", 0) > 0,
          f"{label}: no paging phase or page bytes: {sorted(op.phase_ns)}, "
          f"{op.phase_bytes}")
    check(op.fused_stats()["depth"] == 1, f"{label}: superbatch did not "
          f"resolve to 1 under paging")


def _replay_once(device, batches, mid, label, prof=None, options=None):
    """Restore ``mid`` into a fresh operator (of ``label``'s options, or
    ``options``) and replay the rest; returns (wall seconds, fired batches,
    ``device_health_stats()``)."""
    import torch

    from flink_tpu_torch.core.batch import RecordBatch, Watermark

    i, snap = mid
    kw = dict(PATHS[label] if options is None else options)
    if label in PAGED_REPLAY_CAPACITY:
        kw["paging"] = dict(kw["paging"],
                            capacity=PAGED_REPLAY_CAPACITY[label])
    op = build_op(device, **kw)
    out = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with prof if prof is not None else contextlib.nullcontext():
        op.restore_state(snap)
        for keys, vals, ts in batches[i + 1:]:
            out += op.process_batch(RecordBatch({"k": keys, "v": vals},
                                                timestamps=ts))
            out += op.process_watermark(Watermark(int(ts.max()) - 1))
        out += op.end_input()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if label in PAGED_REPLAY_CAPACITY:
        check(op.paging_stats()["capacity"] == PAGED_REPLAY_CAPACITY[label],
              f"{label}: the replay's ring is {op.paging_stats()}")
    health = op.device_health_stats()
    op.close()
    return wall, out, health


def replay(device, batches, mid, want, label):
    """Restore + replay must give the run's digests.  The replay runs twice:
    plain (the digest check and the wall time), then under
    ``torch.profiler`` for the device's busy time — kernel and copy time
    summed over the trace — taken as a share of the plain run's wall time
    (the profiler's own host overhead would lengthen a profiled wall)."""
    from torch.profiler import ProfilerActivity, profile

    wall, out, _ = _replay_once(device, batches, mid, label)
    got = digest_fn(label)(out)
    check(len(got) == len(want) and len(got) > 0,
          f"{label} replay fired {len(got)} windows, the run {len(want)}")
    # every fold is ordered, so a window that starts after the snapshot
    # replays bit for bit; the device tier's cut window too (it folds on
    # from the restored f32 cells, as the run did), while the host tier
    # re-seeds its f64 mirror from the snapshot's f32 cells, so the window
    # the snapshot cuts agrees to 1e-6 there (as in the reference)
    cut = mid[0] * 1000 // WINDOW_MS * WINDOW_MS
    exact = 0
    for (w1, n1, s1, h1), (w2, n2, s2, h2) in zip(got, want):
        bits = label in DEVICE_PATHS or label in PAGED_PATHS or w2 > cut
        check(w1 == w2 and n1 == n2 and abs(s1 - s2) <= 1e-6 * max(abs(s2), 1)
              and (h1 == h2 or not bits),
              f"{label} replay digest {(w1, n1, s1, h1)} != "
              f"{(w2, n2, s2, h2)}")
        exact += h1 == h2
    print(f"{label} restore+replay from batch {mid[0]}"
          + (f" into a ring of {PAGED_REPLAY_CAPACITY[label]} rows"
             if label in PAGED_REPLAY_CAPACITY else "")
          + f": {len(got)} window digests equal, {exact} of them bit for bit"
          + ("" if label in DEVICE_PATHS or label in PAGED_PATHS else
             f" (every window after the cut one, {cut} ms)")
          + f"; wall {wall * 1e3:.3f} ms")
    prof = profile(activities=[ProfilerActivity.CUDA])
    _, again, _ = _replay_once(device, batches, mid, label, prof)
    check(digest_fn(label)(again) == got, f"{label}: a second replay "
          f"differs from the first in its bits")
    busy_ms, dev = device_busy_ms(prof)
    share = busy_ms / (wall * 1e3)
    print(f"{label} replay device busy {busy_ms:.3f} ms of {wall * 1e3:.3f} "
          f"ms wall = {100 * share:.2f}% (idle {100 - 100 * share:.2f}%); "
          f"a second, profiled replay equals the first bit for bit")
    print(f"{label} replay top device ops (ms): " + "; ".join(
        f"{k[:60]} {t / 1e3:.3f}" for t, k in dev[:8]))
    return got


def device_busy_ms(prof):
    """(device busy ms summed over the trace's kernels and copies, the ops
    by time) of a finished ``torch.profiler`` run."""
    from torch.autograd import DeviceType
    dev = sorted(((e.self_device_time_total, e.key)
                  for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and e.self_device_time_total > 0), reverse=True)
    return sum(t for t, _ in dev) / 1e3, dev


def reset_verdicts() -> None:
    """Drop the process's calibration verdicts (transport, shard counts,
    super-batch depth, device probe), so path 8 measures them on the
    card."""
    from flink_tpu_torch.operators import fused_step
    from flink_tpu_torch.state import device_keyindex, native_mirror
    from flink_tpu_torch.utils import transport
    transport.reset()
    fused_step._reset_calibration_for_tests()
    native_mirror._calibrated_shards = None
    native_mirror.last_shard_s.clear()
    device_keyindex._calibrated_probe = None
    device_keyindex.last_measurement.clear()
    for env in ("FLINK_TPU_NATIVE_SHARDS", "FLINK_TPU_SUPERBATCH",
                "FLINK_TPU_DEVICE_PROBE"):
        check(env not in os.environ, f"{env} is set: path 8 must measure")


def report_auto(lane) -> None:
    """Path 8's resolved lane and what each calibration measured."""
    from flink_tpu_torch.operators import fused_step
    from flink_tpu_torch.state import device_keyindex, native_mirror
    from flink_tpu_torch.utils import transport
    calib = {"transport_ms_per_mb": transport.dispatch_ms_per_mb(),
             "transport_taxed": transport.dispatch_taxed(),
             "device_probe_s": dict(device_keyindex.last_measurement),
             "superbatch_s": {k: v for k, v in
                              fused_step.last_measurement.items()
                              if k != "super_shard_s"},
             "shard_s": dict(native_mirror.last_shard_s),
             "super_shard_s": dict(fused_step.last_measurement.get(
                 "super_shard_s", {}))}
    print("path 8 resolved lane: " + json.dumps(lane, sort_keys=True)
          + "; calibrations (seconds unless named): "
          + json.dumps(calib, sort_keys=True, default=str))


def twin_options(lane) -> dict:
    """The options that pin path 8's resolved lane."""
    return dict(emit_tier=lane["emit_tier"],
                snapshot_source=lane["snapshot_source"],
                device_sync=lane["device_sync_mode"],
                device_probe="on" if lane["device_probe"] else "off",
                superbatch=lane["superbatch"], native_emit=True,
                native_shards=lane["nm_shards"], pipeline_depth=0)


def check_auto_twin(auto, twin, label="path 8"):
    """Path 8 against its pinned twin: the same fires and mid-run snapshot
    bit for bit, the same operator counters, and from the first batch after
    calibration the same probe counters (per-batch lanes; a super-batch
    groups batches from its own start, so only staging counts there)."""
    (a_fires, a_mid, a_num), (t_fires, t_mid, t_num) = auto, twin
    check_twin([b for _, b in a_fires], [b for _, b in t_fires], label)
    check(snap_bytes(a_mid[1]) == snap_bytes(t_mid[1]),
          f"{label}: the mid-run snapshot differs from the pinned twin's")
    ac, tc = a_num["counters"], t_num["counters"]
    for k in ("late_dropped", "num_keys", "watermark", "last_fired_window"):
        check(ac[k] == tc[k], f"{label}: {k} {ac[k]} != twin {tc[k]}")
    c = a_num["lane"]["calibrating_batches"]
    keys = (("staged",) if a_num["lane"]["superbatch"] > 1 else
            ("staged", "probe_hits", "probe_misses", "miss_inserts"))
    final = lambda n: dict(n["counters"]["probe"],  # noqa: E731
                           staged=n["counters"]["fused"]["staged_batches"])
    base = lambda n: (n["per_batch"][c - 1] if c else  # noqa: E731
                      {k: 0 for k in keys})
    for k in keys:
        da = final(a_num)[k] - base(a_num)[k]
        dt = final(t_num)[k] - base(t_num)[k]
        check(da == dt, f"{label}: {k} after the {c} calibrating batches "
              f"{da} != the pinned twin's {dt}")
    print(f"{label} equals its pinned twin {PATHS[label + ' twin']} bit for "
          f"bit: fires, mid-run snapshot, counters ({', '.join(keys)} "
          f"counted from batch {c + 1}, after {c} calibrating batches); "
          f"records/s {a_num['records_per_s']:.1f} vs twin "
          f"{t_num['records_per_s']:.1f}")


def check_pipelined(label, ref, run, ref_run):
    """A pipelined path against its serial twin: the same fires in the
    same order and calls, the same mid-run snapshot and every counter, bit
    for bit."""
    (fires, mid, numbers), (rfires, rmid, rnumbers) = run, ref_run
    check([i for i, _ in fires] == [i for i, _ in rfires],
          f"{label}: fires surfaced at other batches than {ref}'s")
    check_twin([b for _, b in fires], [b for _, b in rfires], label)
    check(mid[0] == rmid[0] and snap_bytes(mid[1]) == snap_bytes(rmid[1]),
          f"{label}: the mid-run snapshot differs from {ref}'s")
    check(numbers["counters"] == rnumbers["counters"],
          f"{label}: counters {numbers['counters']} != {ref}'s "
          f"{rnumbers['counters']}")
    print(f"{label} equals {ref} bit for bit: fires (same calls, keys, "
          f"values), mid-run snapshot bytes, probe/fused/paging counters")


def generated_run(device, options, prof=None):
    """Path 3's workload with each batch generated inside the timed loop
    from the seed (``make_batches``' own sequence), standing in for the
    source decode the pipeline overlaps; returns (wall s, digests)."""
    import torch

    from flink_tpu_torch.core.batch import RecordBatch, Watermark
    op = build_op(device, **options)
    rng = np.random.default_rng(7)
    out = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with prof if prof is not None else contextlib.nullcontext():
        for i in range(N_BATCHES):
            keys = rng.integers(0, N_KEYS, BATCH).astype(np.int64)
            vals = rng.random(BATCH).astype(np.float32)
            ts = i * 1000 + np.sort(rng.integers(0, 1000, BATCH)).astype(
                np.int64)
            out += op.process_batch(RecordBatch({"k": keys, "v": vals},
                                                timestamps=ts))
            out += op.process_watermark(Watermark(int(ts.max()) - 1))
        out += op.end_input()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    op.close()
    return wall, digests(out)


def pipeline_ab(device, label, ref, want) -> None:
    """Path ``label`` (pipelined) against ``ref`` (depth 0) on generated
    batches, in turns ref, label, label, ref, each held to ``want`` bit
    for bit; then one profiled run of each for the device's idle share."""
    from torch.profiler import ProfilerActivity, profile
    n = N_BATCHES * BATCH
    walls = {ref: [], label: []}
    for side in (ref, label, label, ref):
        wall, got = generated_run(device, PATHS[side])
        check(got == want, f"A/B {side}: generated batches fired other "
              f"digests than {ref}'s run")
        walls[side].append(wall)
    idle = {}
    for side in (ref, label):
        prof = profile(activities=[ProfilerActivity.CUDA])
        wall, got = generated_run(device, PATHS[side], prof)
        check(got == want, f"A/B {side}: a profiled run differs")
        busy, _ = device_busy_ms(prof)
        idle[side] = 100 - 100 * busy / (wall * 1e3)
    rate = {k: [n / w for w in v] for k, v in walls.items()}
    ratio = np.median(rate[label]) / np.median(rate[ref])
    print(f"A/B {label} (pipeline_depth=2) vs {ref} (depth 0), batches "
          f"generated in the timed loop, turns {ref}, {label}, {label}, "
          f"{ref}: records/s " + ", ".join(
              f"{k} " + " / ".join(f"{r:.1f}" for r in v)
              for k, v in rate.items())
          + f" (median ratio {ratio:.3f}x); device idle {idle[label]:.2f}% "
          f"vs {idle[ref]:.2f}% (one profiled run each); every run "
          f"bit-equal to {ref}'s digests")


# ---------------------------------------------------------------------------
# slice 11: the generic fold, count triggers and the keyed reduce
# ---------------------------------------------------------------------------

def slice11_op(device, label):
    """The operator of a slice-11 path on ``device``."""
    import torch

    from flink_tpu_torch.core.functions import (LambdaReduce, RuntimeContext,
                                                SumAggregator)
    from flink_tpu_torch.operators.basic import KeyedReduceOperator
    from flink_tpu_torch.operators.window_agg import WindowAggOperator
    from flink_tpu_torch.windowing.assigners import (GlobalWindows,
                                                     TumblingEventTimeWindows)
    from flink_tpu_torch.windowing.triggers import CountTrigger, PurgingTrigger
    if label == "path 21":
        op = KeyedReduceOperator(SumAggregator(torch.float32), key_column="k",
                                 value_column="v", device=device,
                                 initial_key_capacity=KEY_CAPACITY)
    else:
        tumbling = TumblingEventTimeWindows.of(WINDOW_MS)
        assigner, agg, trigger = {
            "path 18": (tumbling, LambdaReduce(lambda a, b: a + b, 0.0),
                        None),
            "path 19": (tumbling, SumAggregator(torch.float32),
                        PurgingTrigger.of(CountTrigger.of(COUNT_WINDOW_N))),
            "path 20": (GlobalWindows.create(), SumAggregator(torch.float32),
                        CountTrigger.of(GLOBAL_COUNT_N, purge=True)),
        }[label]
        op = WindowAggOperator(assigner, agg, key_column="k",
                               value_column="v", trigger=trigger,
                               device=device,
                               initial_key_capacity=KEY_CAPACITY,
                               **PATHS["path 5"])
    op.open(RuntimeContext())
    return op


def slice11_drive(op, batches, start=0, snap_at=None, fire_ms=None):
    """Feed ``batches[start:]`` (a watermark after each) and end the input;
    returns every output as (call, batch) and the snapshot taken after
    batch ``snap_at``.  ``fire_ms`` collects the host ms of each call
    whose watermark or count fired."""
    from flink_tpu_torch.core.batch import RecordBatch, Watermark
    fired, snap = [], None
    for i, (keys, vals, ts) in enumerate(batches):
        if i < start:
            continue
        f0 = time.perf_counter()
        out = op.process_batch(RecordBatch({"k": keys, "v": vals},
                                           timestamps=ts))
        f1 = time.perf_counter()
        wm = op.process_watermark(Watermark(int(ts.max()) - 1))
        if fire_ms is not None and (out or wm):
            # the call that emitted: the watermark's (time fires), else
            # the batch's (count fires; the keyed reduce's every batch,
            # its fold included)
            fire_ms.append(((time.perf_counter() - f1) if wm
                            else (f1 - f0)) * 1e3)
        out += wm
        if i == snap_at:
            out += op.prepare_snapshot_pre_barrier()
            snap = op.snapshot_state()
        fired += [(i, b) for b in out]
    fired += [(len(batches), b) for b in op.end_input()]
    return fired, snap


def slice11_digests(fired):
    """Per output: the call, then the bytes of its keys, results, window
    start and timestamps (the bit-for-bit view)."""
    def col(b, c):
        return np.asarray(b.column(c)).tobytes() if c in b.columns else b""
    return [(i, col(b, "k"), col(b, "result"), col(b, "window_start"),
             b"" if b.timestamps is None
             else np.asarray(b.timestamps).tobytes())
            for i, b in fired]


def count_reference(batches, label):
    """Independent numpy semantics of paths 19 and 20: per (key, window)
    counts and f64 sums; after each batch, for each touched window in
    order, every key at or over the threshold fires its sum and is purged.
    A tumbling window retires when the watermark passes its end; at the end
    of input the windows still live fire every key that holds records (a
    time fire, as the window operator's ``end_input`` does), GlobalWindows
    nothing.  Returns [(call, window start, keys ascending, f64 sums)]."""
    glob = label == "path 20"
    thr = GLOBAL_COUNT_N if glob else COUNT_WINDOW_N
    state, out = {}, []
    for i, (keys, vals, ts) in enumerate(batches):
        wins = (np.zeros(len(keys), np.int64) if glob
                else ts // WINDOW_MS)
        for w in np.unique(wins).tolist():
            m = wins == w
            sums, cnt = state.setdefault(w, (np.zeros(N_KEYS),
                                             np.zeros(N_KEYS, np.int64)))
            sums += np.bincount(keys[m], weights=vals[m].astype(np.float64),
                                minlength=N_KEYS)
            cnt += np.bincount(keys[m], minlength=N_KEYS)
            fired = np.flatnonzero(cnt >= thr)
            if fired.size:
                start = -(2 ** 63) if glob else w * WINDOW_MS
                out.append((i, start, fired, sums[fired].copy()))
                sums[fired] = 0
                cnt[fired] = 0
        if not glob:
            wm = int(ts.max()) - 1
            for w in [w for w in state if (w + 1) * WINDOW_MS - 1 <= wm]:
                del state[w]
    if not glob:
        for w in sorted(state):
            sums, cnt = state[w]
            live = np.flatnonzero(cnt > 0)
            if live.size:
                out.append((len(batches), w * WINDOW_MS, live, sums[live]))
    return out


def reduce_reference(batches):
    """Independent numpy semantics of path 21: every record's running f64
    sum of its key, in record order."""
    totals = np.zeros(N_KEYS)
    out = []
    for keys, vals, _ in batches:
        order = np.argsort(keys, kind="stable")
        k, v = keys[order], vals[order].astype(np.float64)
        first = np.r_[True, k[1:] != k[:-1]]
        cs = np.cumsum(v)
        base = np.maximum.accumulate(np.where(first, np.arange(len(k)), 0))
        run = cs - cs[base] + v[base] + totals[k]
        res = np.empty(len(k))
        res[order] = run
        last = np.r_[k[1:] != k[:-1], True]
        totals[k[last]] = run[last]
        out.append(res)
    return out


def check_slice11_reference(label, fired, batches, expect):
    """(b): the path's outputs against the numpy semantics."""
    plain = [b for _, b in fired]
    if label == "path 18":
        check_fires(plain, expect, label)
        return f"every window's keys and sums (rtol {RTOL})"
    if label == "path 21":
        want = reduce_reference(batches)
        check(len(plain) == len(want), f"{label}: {len(plain)} outputs")
        for i, (b, w) in enumerate(zip(plain, want)):
            res = np.asarray(b.column("result"))
            check(res.dtype == np.float32
                  and np.allclose(res, w, rtol=REDUCE_RTOL, atol=0),
                  f"{label} batch {i}: running sums differ from the f64 "
                  f"reference (max abs {np.max(np.abs(res - w))})")
        return f"every record's running sum (rtol {REDUCE_RTOL})"
    want = count_reference(batches, label)
    check(len(fired) == len(want), f"{label}: {len(fired)} fires, the "
          f"reference {len(want)}")
    for (i, b), (wi, ws, wkeys, wsums) in zip(fired, want):
        keys = np.asarray(b.column("k"))
        order = np.argsort(keys, kind="stable")
        res = np.asarray(b.column("result"))[order]
        check(i == wi and int(b.column("window_start")[0]) == ws
              and np.array_equal(keys[order], wkeys)
              and np.allclose(res, wsums, rtol=RTOL, atol=0),
              f"{label} call {i}: the fire differs from the reference's "
              f"(call {wi}, {len(keys)} vs {len(wkeys)} keys)")
    return (f"{len(want)} fires: the calls, windows, keys and sums "
            f"(rtol {RTOL})")


def slice11_path(device, batches, expect, label):
    """Drive one slice-11 path on the card with every launch count at 0
    just before and read just after, and hold it (a) to the same operator
    on the CPU over the first batches bit for bit, (b) to the numpy
    semantics, (c) to a restore of its mid-run snapshot replayed on the
    card, bit for bit, twice (the second under ``torch.profiler``)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    op = slice11_op(device, label)
    fire_ms = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    fired, snap = slice11_drive(op, batches, snap_at=SNAPSHOT_EVERY - 1,
                                fire_ms=fire_ms)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = read_launches()
    check(launches["probe"] == 0 and launches["probe_fold"] == 0,
          f"{label}: launches {launches}")
    check((launches["scatter_fold"] > 0) == (label in SLICE11_SCATTER),
          f"{label}: launches {launches}; scatter_fold runs on paths "
          f"{SLICE11_SCATTER} only")
    check(any(len(b) for _, b in fired), f"{label}: nothing fired")
    what = check_slice11_reference(label, fired, batches, expect)
    digests_ = slice11_digests(fired)
    n_cpu = SLICE11_CPU_BATCHES
    cpu_fired, _ = slice11_drive(slice11_op(torch.device("cpu"), label),
                                 batches[:n_cpu])
    cpu_d = [d for d in slice11_digests(cpu_fired) if d[0] < n_cpu]
    check(cpu_d == [d for d in digests_ if d[0] < n_cpu] and cpu_d,
          f"{label}: the card's first {n_cpu} batches differ from the "
          f"CPU's in their bits")
    after = [d for d in digests_ if d[0] >= SNAPSHOT_EVERY]
    replay_wall, busy_ms, kernels_per_batch, top = None, 0.0, 0.0, []
    for prof in (None, profile(activities=[ProfilerActivity.CUDA])):
        rop = slice11_op(device, label)
        torch.cuda.synchronize()
        r0 = time.perf_counter()
        with prof if prof is not None else contextlib.nullcontext():
            rop.restore_state(snap)
            got, _ = slice11_drive(rop, batches, start=SNAPSHOT_EVERY)
            torch.cuda.synchronize()
        check(slice11_digests(got) == after and after,
              f"{label}: the restore+replay differs from the run in its "
              f"bits" + (" (profiled)" if prof is not None else ""))
        if prof is None:
            replay_wall = time.perf_counter() - r0
            continue
        busy_ms, dev = device_busy_ms(prof)
        n_kernels = sum(e.count for e in prof.key_averages()
                        if e.device_type == DeviceType.CUDA
                        and e.self_device_time_total > 0)
        kernels_per_batch = n_kernels / (len(batches) - SNAPSHOT_EVERY)
        top = dev[:6]
    n_records = sum(len(b[0]) for b in batches)
    p50 = float(np.percentile(fire_ms, 50)) if fire_ms else 0.0
    p99 = float(np.percentile(fire_ms, 99)) if fire_ms else 0.0
    share = busy_ms / (replay_wall * 1e3)
    print(f"{label}: {n_records} records in {elapsed:.3f} s = "
          f"{n_records / elapsed:.1f} records/s; {len(fired)} outputs held "
          f"to the numpy semantics ({what}); the first {n_cpu} batches "
          f"equal the CPU run bit for bit; launches {launches}; peak device "
          f"memory {torch.cuda.max_memory_allocated()} B")
    print(f"{label} fire latency ms over {len(fire_ms)} firing calls: p50 "
          f"{p50:.3f} p99 {p99:.3f}")
    print(f"{label} phase_ns: " + json.dumps(op.phase_ns, sort_keys=True))
    if hasattr(op, "phase_bytes"):
        print(f"{label} phase_bytes: " + json.dumps(op.phase_bytes,
                                                    sort_keys=True))
    print(f"{label} restore+replay from batch {SNAPSHOT_EVERY - 1}: "
          f"{len(after)} outputs bit for bit, twice; wall "
          f"{replay_wall * 1e3:.3f} ms; device busy {busy_ms:.3f} ms = "
          f"{100 * share:.2f}% (idle {100 - 100 * share:.2f}%); "
          f"{kernels_per_batch:.1f} device kernels and copies a batch; top "
          f"device ops (ms): " + "; ".join(f"{k[:50]} {t / 1e3:.3f}"
                                            for t, k in top))
    return launches, {"records_per_s": n_records / elapsed,
                      "fire_p50_ms": p50, "fire_p99_ms": p99,
                      "busy_share": share,
                      "kernels_per_batch": kernels_per_batch}


def make_session_batches():
    """Copy of ``bench.py`` ``run_config4``'s generator at its full size:
    Zipf(1.3) keys over 100,000, f32 values, bursts of 800 ms every 3000 ms
    (so sessions close between bursts)."""
    rng = np.random.default_rng(SESSION_SEED)
    batches = []
    t = 0
    for lo in range(0, SESSION_RECORDS, SESSION_BATCH):
        b = min(SESSION_BATCH, SESSION_RECORDS - lo)
        keys = (rng.zipf(1.3, b).astype(np.int64) - 1) % SESSION_KEYS
        vals = rng.random(b).astype(np.float32)
        ts = t + np.sort(rng.integers(0, 800, b)).astype(np.int64)
        t += 3000
        batches.append((keys, vals, ts))
    return batches


def session_model(batches):
    """Independent pure-Python sessions: ``bench.py``'s heap pass (per key
    a list of ``[start, end, f64 sum, records]``, merged record by record,
    the MergingWindowSet analog) run to the end, with the session
    operator's boundaries: a record's window is ``[t, t + gap)``, two
    windows merge when they overlap, and a session fires once the watermark
    (``max(ts) - 1`` after each batch, then the end of input) reaches its
    end.  Returns ``{(call, key, start, end): (sum, records)}``."""
    sessions, out = {}, {}
    gap = SESSION_GAP_MS

    def fire(call, wm):
        for k in list(sessions):
            keep = []
            for s in sessions[k]:
                if s[1] <= wm:
                    out[(call, k, s[0], s[1])] = (s[2], s[3])
                else:
                    keep.append(s)
            if keep:
                sessions[k] = keep
            else:
                del sessions[k]

    for i, (keys, vals, ts) in enumerate(batches):
        for k, v, t in zip(keys.tolist(), vals.tolist(), ts.tolist()):
            lst = sessions.setdefault(k, [])
            new = [t, t + gap, v, 1]
            merged = []
            for s in lst:
                if s[0] < new[1] and new[0] < s[1]:
                    new = [min(s[0], new[0]), max(s[1], new[1]),
                           s[2] + new[2], s[3] + new[3]]
                else:
                    merged.append(s)
            merged.append(new)
            sessions[k] = merged
        fire(i, int(ts.max()) - 1)
    fire(len(batches), 2 ** 63 - 1)
    return out


def slice12_op(device, label, cpu_mesh=False):
    """The operator of a slice-12 path (``cpu_mesh``: path 23's operator
    over ``MESH_BLOCKS`` CPU blocks)."""
    import torch

    from flink_tpu_torch.core.functions import (AvgAggregator, RuntimeContext,
                                                SumAggregator)
    from flink_tpu_torch.operators.evicting_device import \
        DeviceEvictingWindowOperator
    from flink_tpu_torch.operators.session_window import \
        SessionWindowOperator
    from flink_tpu_torch.parallel.mesh import make_mesh
    from flink_tpu_torch.parallel.mesh_runtime import \
        MeshSessionWindowOperator
    from flink_tpu_torch.windowing.assigners import (EventTimeSessionWindows,
                                                     TumblingEventTimeWindows)
    from flink_tpu_torch.windowing.evictors import CountEvictor, TimeEvictor
    sessions = EventTimeSessionWindows(SESSION_GAP_MS)
    if label == "path 22":
        op = SessionWindowOperator(sessions, SumAggregator(torch.float32),
                                   key_column="k", value_column="v")
    elif label == "path 23":
        dev = torch.device("cpu") if cpu_mesh else device
        op = MeshSessionWindowOperator(
            sessions, SumAggregator(torch.float32), key_column="k",
            value_column="v", mesh=make_mesh(devices=[dev] * MESH_BLOCKS))
    else:
        evictor, agg = {
            "path 24": (CountEvictor.of(1), SumAggregator(torch.float32)),
            "path 25": (TimeEvictor.of(1000), AvgAggregator(torch.float32)),
        }[label]
        op = DeviceEvictingWindowOperator(
            TumblingEventTimeWindows.of(WINDOW_MS), evictor, agg,
            key_column="k", value_column="v",
            initial_key_capacity=KEY_CAPACITY, device=device)
    op.open(RuntimeContext())
    return op


def slice12_drive(op, batches, start=0, snap_at=None, fire_ms=None,
                  stop=None):
    """Feed ``batches[start:stop]`` (a watermark of ``max(ts) - 1`` after
    each); with ``stop`` None, then the end-of-input watermark and
    ``end_input``.  Returns every output as (call, batch), the snapshot
    taken after batch ``snap_at`` and the buffer rows' high-water (the
    evicting lane's).  ``fire_ms`` collects the host ms of each watermark
    call that fired."""
    from flink_tpu_torch.core.batch import MAX_WATERMARK, RecordBatch, \
        Watermark
    fired, snap, high = [], None, 0
    end = len(batches) if stop is None else stop
    for i in range(start, end):
        keys, vals, ts = batches[i]
        out = op.process_batch(RecordBatch({"k": keys, "v": vals},
                                           timestamps=ts))
        high = max(high, getattr(op, "_C", 0))
        f0 = time.perf_counter()
        wm = op.process_watermark(Watermark(int(ts.max()) - 1))
        if fire_ms is not None and wm:
            fire_ms.append((time.perf_counter() - f0) * 1e3)
        fired += [(i, b) for b in out + wm]
        if i == snap_at:
            snap = op.snapshot_state()
    if stop is None:
        f0 = time.perf_counter()
        tail = op.process_watermark(Watermark(MAX_WATERMARK)) + op.end_input()
        if fire_ms is not None and tail:
            fire_ms.append((time.perf_counter() - f0) * 1e3)
        fired += [(len(batches), b) for b in tail]
    return fired, snap, high


def slice12_rows(fired):
    """Per call, its output rows as (key, window start, window end, result
    bits), sorted: the view in which a restored session operator (whose key
    index numbers keys in snapshot order) must equal the run."""
    out = {}
    for i, b in fired:
        res = np.asarray(b.column("result"))
        out.setdefault(i, []).extend(zip(
            np.asarray(b.column("k")).tolist(),
            np.asarray(b.column("window_start")).tolist(),
            np.asarray(b.column("window_end")).tolist(),
            [r.tobytes() for r in res]))
    return {i: sorted(rows) for i, rows in out.items()}


def check_sessions(label, fired, model):
    """(key, start, end) at the same calls as the model, exactly; each f32
    sum within ``n * U32`` of the model's f64 sum of its n records."""
    got = {}
    for i, b in fired:
        res = np.asarray(b.column("result"))
        check(res.dtype == np.float32, f"{label}: result dtype {res.dtype}")
        for k, s, e, r in zip(np.asarray(b.column("k")).tolist(),
                              np.asarray(b.column("window_start")).tolist(),
                              np.asarray(b.column("window_end")).tolist(),
                              res.tolist()):
            check((i, k, s, e) not in got, f"{label}: session {(k, s, e)} "
                  f"fired twice at call {i}")
            got[(i, k, s, e)] = r
    check(set(got) == set(model), f"{label}: {len(got)} sessions, the model "
          f"{len(model)}; {len(set(got) ^ set(model))} differ")
    worst = 0.0
    for key, r in got.items():
        s, n = model[key]
        err = abs(r - s)
        check(err <= n * U32 * s + 1e-30, f"{label} session {key}: sum {r} "
              f"vs the model's {s} over {n} records")
        worst = max(worst, err / max(n * U32 * s, 1e-30))
    return len(got), worst


def evict_model(batches, label):
    """Independent numpy semantics of paths 24 and 25, per 5000 ms window:
    path 24 (``CountEvictor.of(1)``, sum) each key's last arrival's value;
    path 25 (``TimeEvictor.of(1000)``, average) each key's records within
    1000 ms of its newest, summed in f32 in arrival order (``np.add.at``)
    and divided by their count in f32.  Returns {window start: (keys
    ascending, f32 results)}."""
    keys = np.concatenate([b[0] for b in batches])
    vals = np.concatenate([b[1] for b in batches])
    ts = np.concatenate([b[2] for b in batches])
    win = ts // WINDOW_MS
    out = {}
    for w in np.unique(win).tolist():
        m = win == w
        k, v, t = keys[m], vals[m], ts[m]
        uniq, inv = np.unique(k, return_inverse=True)
        if label == "path 24":
            last = np.full(uniq.size, -1, np.int64)
            last[inv] = np.arange(k.size)       # the last write wins
            out[w * WINDOW_MS] = (uniq, np.float32(0) + v[last])
            continue
        tmax = np.full(uniq.size, np.iinfo(np.int64).min)
        np.maximum.at(tmax, inv, t)
        kept = t >= tmax[inv] - 1000
        sums = np.zeros(uniq.size, np.float32)
        np.add.at(sums, inv[kept], v[kept])
        cnt = np.bincount(inv[kept], minlength=uniq.size).astype(np.int32)
        out[w * WINDOW_MS] = (uniq,
                              sums / np.maximum(cnt, 1).astype(np.float32))
    return out


def check_evictions(label, fired, model):
    """Every fire against the model, bit for bit (keys compared in
    ascending order)."""
    check(len(fired) == len(model), f"{label}: {len(fired)} fires, the "
          f"model {len(model)} windows")
    for i, b in fired:
        w = int(np.asarray(b.column("window_start"))[0])
        k = np.asarray(b.column("k"))
        r = np.asarray(b.column("result"))
        order = np.argsort(k, kind="stable")
        mk, mr = model[w]
        check(r.dtype == np.float32 and np.array_equal(k[order], mk)
              and r[order].tobytes() == mr.tobytes(),
              f"{label} window {w} (call {i}): the fire differs from the "
              f"model in its bits ({k.size} vs {mk.size} keys)")
    return f"{len(fired)} fires bit for bit"


def slice12_path(device, label, batches, ref):
    """Drive one slice-12 path with every launch count at 0 just before and
    read just after, hold it to its model and its CPU twin, and restore and
    replay its mid-run snapshot twice (the second under
    ``torch.profiler``).  ``ref``: path 22's outputs for path 23."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from flink_tpu_torch.runtime import device_health

    session = label in ("path 22", "path 23")
    snap_at = SESSION_SNAPSHOT_AT if session else SNAPSHOT_EVERY - 1
    mon = device_health.DeviceHealthMonitor()
    device_health.set_monitor(mon)
    op = slice12_op(device, label)
    fire_ms = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    fired, snap, high = slice12_drive(op, batches, snap_at=snap_at,
                                      fire_ms=fire_ms)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    check(launches["probe"] == 0 and launches["probe_fold"] == 0,
          f"{label}: launches {launches}")
    check(snap is not None, f"{label}: no mid-run snapshot")
    n_out = sum(len(b) for _, b in fired)
    extra = ""
    if session:
        n_sess, worst = check_sessions(label, fired, ref["model"])
        what = (f"{n_sess} sessions: (key, start, end) at the model's calls "
                f"exactly, sums within n * 2^-24 of its f64 sums (worst "
                f"{worst:.4f} of the bound)")
        if label == "path 22":
            check(launches["scatter_fold"] == 0, f"{label}: launches "
                  f"{launches}; the host operator launches nothing")
        else:
            check(launches["scatter_fold"] > 0,
                  f"{label}: no scatter_fold launch")
            mine = {i: [r[:3] for r in rows]
                    for i, rows in slice12_rows(fired).items()}
            theirs = {i: [r[:3] for r in rows]
                      for i, rows in slice12_rows(ref["path 22"]).items()}
            check(mine == theirs, f"{label}: its sessions differ from path "
                  f"22's")
            n_cpu = SESSION_CPU_BATCHES
            cpu_fired, _, _ = slice12_drive(
                slice12_op(device, label, cpu_mesh=True), batches,
                stop=n_cpu)
            cpu_d = slice11_digests(cpu_fired)
            check(cpu_d and cpu_d == [d for d in slice11_digests(fired)
                                      if d[0] < n_cpu],
                  f"{label}: the card's first {n_cpu} batches differ from "
                  f"the CPU mesh's in their bits")
            extra = (f"; (key, start, end) equal path 22's at every call; "
                     f"the first {n_cpu} batches equal the same operator on "
                     f"a CPU mesh of {MESH_BLOCKS} bit for bit")
    else:
        what = check_evictions(label, fired, evict_model(batches, label))
        check(launches["scatter_fold"] == op.fire_steps == len(fired) > 0,
              f"{label}: launches {launches}, {op.fire_steps} fire steps, "
              f"{len(fired)} fires")
        labels = dict(mon.label_counts)
        check(labels.get(EVICT_LABEL) == len(batches)
              and mon.counters["dispatches"] == len(batches),
              f"{label}: guarded dispatches {labels}, "
              f"{mon.counters['dispatches']}")
        n_cpu = EVICT_CPU_BATCHES
        cpu_fired, _, _ = slice12_drive(
            slice12_op(torch.device("cpu"), label), batches, stop=n_cpu)
        cpu_d = slice11_digests(cpu_fired)
        check(cpu_d and cpu_d == [d for d in slice11_digests(fired)
                                  if d[0] < n_cpu],
              f"{label}: the card's first {n_cpu} batches differ from the "
              f"CPU's in their bits")
        extra = (f"; the first {n_cpu} batches equal the CPU bit for bit; "
                 f"one guarded {EVICT_LABEL} a batch ({labels})")
    # a restored session operator numbers keys in snapshot order, so its
    # rows come out in another order: compare each call's sorted rows; the
    # evicting lane restores its slot ids, so its fires compare as bytes
    view = slice12_rows if session else slice11_digests
    after = view([(i, b) for i, b in fired if i > snap_at])
    replay_wall, busy_ms, ops_per_batch, top = None, 0.0, 0.0, []
    for prof in (None, profile(activities=[ProfilerActivity.CUDA])):
        rop = slice12_op(device, label)
        torch.cuda.synchronize()
        r0 = time.perf_counter()
        with prof if prof is not None else contextlib.nullcontext():
            rop.restore_state(snap)
            got, _, _ = slice12_drive(rop, batches, start=snap_at + 1)
            torch.cuda.synchronize()
        wall = time.perf_counter() - r0
        check(view(got) == after and after,
              f"{label}: the restore+replay differs from the run"
              + (" (profiled)" if prof is not None else ""))
        if prof is None:
            replay_wall = wall
            continue
        busy_ms, dev = device_busy_ms(prof)
        n_ops = sum(e.count for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA
                    and e.self_device_time_total > 0)
        ops_per_batch = n_ops / (len(batches) - snap_at - 1)
        top = dev[:6]
    device_health.set_monitor(None)
    n_records = sum(len(b[0]) for b in batches)
    n_fires = len(fired)
    p50 = float(np.percentile(fire_ms, 50))
    p99 = float(np.percentile(fire_ms, 99))
    share = busy_ms / (replay_wall * 1e3)
    d2h = op.phase_bytes.get("d2h", 0)
    print(f"{label}: {n_records} records in {elapsed:.3f} s = "
          f"{n_records / elapsed:.1f} records/s; {n_fires} fires of "
          f"{n_out} rows held to the model ({what}){extra}; launches "
          f"{launches}; peak device memory {peak} B")
    print(f"{label} fire latency ms over {len(fire_ms)} firing calls: p50 "
          f"{p50:.3f} p99 {p99:.3f}")
    print(f"{label} phase_ns: " + json.dumps(op.phase_ns, sort_keys=True))
    print(f"{label} phase_bytes: " + json.dumps(op.phase_bytes,
                                                sort_keys=True))
    if session:
        # the mesh downloads each batch's folded accumulators; a fire reads
        # the host's session store
        print(f"{label} d2h bytes: 0 per fire ({n_fires} fires); "
              f"{d2h / len(batches):.0f} per batch (the folded sessions)")
    else:
        print(f"{label} d2h bytes: {d2h / max(n_fires, 1):.0f} per fire "
              f"({n_fires} fires), "
              f"{op.phase_bytes.get('d2h_snapshot', 0)} for the snapshot; "
              f"element buffer {16 * high} B on the card at its largest "
              f"({high} rows)")
    print(f"{label} restore+replay from batch {snap_at}: {len(after)} "
          f"calls' outputs equal the run's, each value bit for bit, twice; "
          f"wall {replay_wall * 1e3:.3f} ms; device busy {busy_ms:.3f} ms "
          f"= {100 * share:.2f}% (idle {100 - 100 * share:.2f}%); "
          f"{ops_per_batch:.1f} device kernels and copies a batch; top "
          f"device ops (ms): " + "; ".join(f"{k[:50]} {t / 1e3:.3f}"
                                            for t, k in top))
    return launches, fired, {
        "records_per_s": n_records / elapsed, "fire_p50_ms": p50,
        "fire_p99_ms": p99,
        "d2h_per_fire": 0.0 if session else d2h / max(n_fires, 1),
        "buffer_bytes": 16 * high, "busy_share": share,
        "kernels_per_batch": ops_per_batch}


def main() -> None:
    try:
        import torch

        import flink_tpu_torch  # noqa: F401
    except ImportError as err:
        fail(f"cannot import the port ({err}): run from the repository root")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs a GPU")
    device = torch.device("cuda")
    card = card_line()
    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {card}")

    build_kernels()
    rng = np.random.default_rng(7)
    ki, dki = load_table(device, rng)
    kernels = [kernel_phase(device, rng, ki, dki)]
    batches = make_batches(N_BATCHES * BATCH, N_KEYS, BATCH, WINDOW_MS)
    expect = reference(batches)
    cells = reference_f32(batches)
    launches, fires, numbers, mids, replays = {}, {}, {}, {}, {}
    ab_want = {}
    for label in ORDER:
        if label == "path 8":
            reset_verdicts()
        launches[label], mid, after, fires[label], numbers[label] = \
            main_path(device, batches, expect, label)
        check(mid is not None, f"{label}: no mid-run snapshot")
        mids[label] = mid
        plain = [b for _, b in fires[label]]
        if label in GUARD_AB or label in MESH_TWIN \
                or label in MESH_TWIN.values():
            # the fires the A/B runs are held to
            ab_want[label] = digest_fn(label)(plain)
        if label == "path 8":
            report_auto(numbers[label]["lane"])
            if numbers[label]["lane"]["emit_tier"] == "device":
                check_fires_bits(plain, cells, label)
            PATHS["path 8 twin"] = twin_options(numbers[label]["lane"])
            _, tmid, _, tfires, tnumbers = main_path(device, batches, expect,
                                                     "path 8 twin")
            check_auto_twin((fires[label], mid, numbers[label]),
                            (tfires, tmid, tnumbers))
            del tfires, tmid
        if label in PIPELINED:
            ref = PIPELINED[label]
            check_pipelined(label, ref, (fires[label], mid, numbers[label]),
                            (fires[ref], mids[ref], numbers[ref]))
        if label in TWIN:
            check_twin(plain, [b for _, b in fires[TWIN[label]]], label)
            print(f"{label} fires equal {TWIN[label]}'s bit for bit: same "
                  f"keys in the same order, same values")
        if label in DEVICE_PATHS:
            check_fires_bits(plain, cells, label)
            host = DEVICE_PATHS[label]
            check_twin(plain, [b for _, b in fires[host]], label,
                       rtol=DEVICE_VS_HOST_RTOL)
            print(f"{label} fires equal the f32 ordered reference bit for "
                  f"bit, and {host}'s (same keys in the same order, values "
                  f"to rtol {DEVICE_VS_HOST_RTOL})")
        if label == "path 6":
            check_async(fires["path 6"], fires["path 5"], label, "path 5")
        if label in PAGED_PATHS:
            merged = by_window(plain)
            check_fires_bits(merged, cells, label)
            ref = PAGED_PATHS[label]
            check_twin(merged, by_window([b for _, b in fires[ref]]), label)
            print(f"{label} fires equal the f32 ordered reference bit for "
                  f"bit by key, and the (window, key, value) set of {ref}'s "
                  f"bit for bit")
        if label in FAULTS:
            base = FAULTS[label]["base"]
            check_fault_path(label, plain, numbers[label], fires[base],
                             numbers[base], cells)
        if label in MESH_TWIN:
            check_mesh_path(label, fires, mids, numbers)
        if label in FAULTS and label not in PAGED_PATHS:
            fault_replays(device, batches, mid, after, label)
        else:
            replays[label] = replay(device, batches, mid, after, label)
        if label == "path 15":
            rescale_replays(device, batches, mid, after, label)
        if label in PIPELINED:
            check(replays[label] == replays[PIPELINED[label]],
                  f"{label}: its replay differs from {PIPELINED[label]}'s")
            print(f"{label} replay equals {PIPELINED[label]}'s bit for bit, "
                  f"every window")
        rest = ORDER[ORDER.index(label) + 1:]
        needed = ({TWIN.get(k) for k in rest}
                  | {DEVICE_PATHS.get(k) for k in rest}
                  | {PAGED_PATHS.get(k) for k in rest}
                  | {PIPELINED.get(k) for k in rest}
                  | {FAULTS[k]["base"] for k in rest if k in FAULTS}
                  | {MESH_TWIN.get(k) for k in rest}
                  | ({"path 5"} if "path 6" in rest else set()))
        for done in [k for k in fires if k not in needed]:
            del fires[done]
            del mids[done]
    del fires, mids
    for label in SLICE11:
        launches[label], numbers[label] = slice11_path(device, batches,
                                                       expect, label)
        a, b = numbers[label], numbers["path 5"]
        print(f"A/B {label} vs path 5, same batches, one process: records/s "
              f"{a['records_per_s']:.1f} vs {b['records_per_s']:.1f} "
              f"({a['records_per_s'] / b['records_per_s']:.3f}x); fire "
              f"p50/p99 {a['fire_p50_ms']:.3f}/{a['fire_p99_ms']:.3f} vs "
              f"{b['fire_p50_ms']:.3f}/{b['fire_p99_ms']:.3f} ms")
    session_batches = make_session_batches()
    session_ref = {"model": session_model(session_batches)}
    for label in SLICE12:
        stream = session_batches if label in ("path 22", "path 23") \
            else batches
        launches[label], fired_12, numbers[label] = slice12_path(
            device, label, stream, session_ref)
        if label == "path 22":
            session_ref["path 22"] = fired_12
        del fired_12
    a, b = numbers["path 23"], numbers["path 22"]
    print(f"A/B path 23 (mesh, {MESH_BLOCKS} blocks on the card) vs path 22 "
          f"(host), same batches, one process: records/s "
          f"{a['records_per_s']:.1f} vs {b['records_per_s']:.1f} "
          f"({a['records_per_s'] / b['records_per_s']:.3f}x); session-fire "
          f"p50/p99 {a['fire_p50_ms']:.3f}/{a['fire_p99_ms']:.3f} vs "
          f"{b['fire_p50_ms']:.3f}/{b['fire_p99_ms']:.3f} ms")
    del session_batches, session_ref
    for label in ("path 24", "path 25"):
        a, b = numbers[label], numbers["path 5"]
        print(f"A/B {label} (evicting lane) vs path 5 (device tier), same "
              f"batches, one process: records/s {a['records_per_s']:.1f} vs "
              f"{b['records_per_s']:.1f} "
              f"({a['records_per_s'] / b['records_per_s']:.3f}x); fire "
              f"p50/p99 {a['fire_p50_ms']:.3f}/{a['fire_p99_ms']:.3f} vs "
              f"{b['fire_p50_ms']:.3f}/{b['fire_p99_ms']:.3f} ms; d2h per "
              f"fire {a['d2h_per_fire']:.0f} vs {b['d2h_per_fire']:.0f} B; "
              f"state on the card: element buffer {a['buffer_bytes']} B vs "
              f"ring {b['ring_bytes']} B")
    pipeline_ab(device, "path 9", "path 3", ab_want["path 3"])
    guard_ab(device, batches, ab_want)
    mesh_ab(device, batches, ab_want, card)
    healer_phase()
    for label, twin in TWIN.items():
        a, b = numbers[label], numbers[twin]
        host = lambda n: sum(n["phase_ms"].get(k, 0.0)  # noqa: E731
                             for k in ("probe", "probe_mirror", "mirror"))
        print(f"A/B {label} (C layer) vs {twin} (numpy), same batches, one "
              f"process: records/s {a['records_per_s']:.1f} vs "
              f"{b['records_per_s']:.1f} ({a['records_per_s'] / b['records_per_s']:.3f}x); "
              f"probe/probe_mirror/mirror {host(a):.3f} vs {host(b):.3f} ms; "
              f"fire {a['phase_ms'].get('fire', 0.0):.3f} vs "
              f"{b['phase_ms'].get('fire', 0.0):.3f} ms (delta_sync "
              f"{a['phase_ms'].get('delta_sync', 0.0):.3f} vs "
              f"{b['phase_ms'].get('delta_sync', 0.0):.3f}); fire p50/p99 "
              f"{a['fire_p50_ms']:.3f}/{a['fire_p99_ms']:.3f} vs "
              f"{b['fire_p50_ms']:.3f}/{b['fire_p99_ms']:.3f} ms")
    for label, ref in (("path 5", "path 3"), ("path 6", "path 5")):
        a, b = numbers[label], numbers[ref]
        print(f"A/B {label} vs {ref}, same batches, one process: records/s "
              f"{a['records_per_s']:.1f} vs {b['records_per_s']:.1f} "
              f"({a['records_per_s'] / b['records_per_s']:.3f}x); fire "
              f"{a['phase_ms'].get('fire', 0.0):.3f} vs "
              f"{b['phase_ms'].get('fire', 0.0):.3f} ms; fire p50/p99 "
              f"{a['fire_p50_ms']:.3f}/{a['fire_p99_ms']:.3f} vs "
              f"{b['fire_p50_ms']:.3f}/{b['fire_p99_ms']:.3f} ms; d2h per "
              f"fire {a['d2h_per_fire']:.0f} vs {b['d2h_per_fire']:.0f} B, "
              f"per snapshot {a['d2h_per_snapshot']:.0f} vs "
              f"{b['d2h_per_snapshot']:.0f} B")
    for label, ref in PAGED_PATHS.items():
        a, b = numbers[label], numbers[ref]
        print(f"A/B {label} (paged, ring {a['ring_bytes']} B) vs {ref} "
              f"(resident, ring {b['ring_bytes']} B), same batches, one "
              f"process: records/s {a['records_per_s']:.1f} vs "
              f"{b['records_per_s']:.1f} "
              f"({a['records_per_s'] / b['records_per_s']:.3f}x); paging "
              f"{a['phase_ms'].get('paging', 0.0):.3f} ms; probe "
              f"{a['phase_ms'].get('probe', 0.0):.3f} vs "
              f"{b['phase_ms'].get('probe', 0.0):.3f} ms; fire "
              f"{a['phase_ms'].get('fire', 0.0):.3f} vs "
              f"{b['phase_ms'].get('fire', 0.0):.3f} ms; fire p50/p99 "
              f"{a['fire_p50_ms']:.3f}/{a['fire_p99_ms']:.3f} vs "
              f"{b['fire_p50_ms']:.3f}/{b['fire_p99_ms']:.3f} ms; d2h per "
              f"fire {a['d2h_per_fire']:.0f} vs {b['d2h_per_fire']:.0f} B, "
              f"per snapshot {a['d2h_per_snapshot']:.0f} vs "
              f"{b['d2h_per_snapshot']:.0f} B; page-out "
              f"{a['page_out_per_batch']:.0f} B and page-in "
              f"{a['page_in_per_batch']:.0f} B per batch")
    for label, ref in PIPELINED.items():
        a, b = numbers[label], numbers[ref]
        phases = sorted(set(a["phase_ms"]) | set(b["phase_ms"]))
        print(f"A/B {label} (pipeline_depth=2) vs {ref} (depth 0), same "
              f"batches, one process: records/s {a['records_per_s']:.1f} vs "
              f"{b['records_per_s']:.1f} "
              f"({a['records_per_s'] / b['records_per_s']:.3f}x); fire "
              f"p50/p99 {a['fire_p50_ms']:.3f}/{a['fire_p99_ms']:.3f} vs "
              f"{b['fire_p50_ms']:.3f}/{b['fire_p99_ms']:.3f} ms; phase ms "
              + ", ".join(f"{k} {a['phase_ms'].get(k, 0.0):.3f} vs "
                          f"{b['phase_ms'].get(k, 0.0):.3f}" for k in phases))
    host_layer_phase(rng)
    store_phase(rng)
    # the fused kernel's phase runs last: its 2M-row CPU check and large
    # host tensors would otherwise perturb the paths' host-bound timings
    kernels.append(probe_fold_phase(device, rng, dki))
    kernels.append(scatter_fold_phase(device, rng))
    for kernel in kernels:
        by_path = {label: launches[label][kernel["name"]]
                   for label in ORDER + SLICE11 + SLICE12}
        kernel["launches_by_path"] = by_path
        kernel["launches"] = sum(by_path.values())
        print(f"{kernel['name']} launches by path: {by_path}")
    for part in ("single", "multi"):
        kernels[-1][f"launches_by_path_{part}"] = by_path = {
            label: launches[label][f"scatter_fold_{part}"]
            for label in ORDER + SLICE11 + SLICE12}
        print(f"scatter_fold launches through ordered_fold_counts"
              f"{'_multi' if part == 'multi' else ''} by path: {by_path}")
    for label in ("path 1", "path 3"):
        check(launches[label]["probe"] > 0, f"{label}: no probe launch")
    for label in ("path 2", "path 4"):
        check(launches[label]["probe_fold"] > 0,
              f"{label}: no probe_fold launch")
    for label in (*DEVICE_PATHS, *PAGED_PATHS, *FAULTS, "path 8", "path 9",
                  *SLICE11_SCATTER, "path 23", "path 24", "path 25"):
        check(launches[label]["scatter_fold"] > 0,
              f"{label}: no scatter_fold launch")
    check(launches["path 12"]["probe"] > 0, "path 12: no probe launch")
    check(launches["path 14"]["probe"] > 0
          and launches["path 14"]["scatter_fold"] > 0,
          "path 14: no probe or scatter_fold launch")
    # path 8's probe launches come from the device-probe calibration, which
    # runs where the probe is eligible: the host tier, as auto picks on a
    # card
    for label in ("path 8", "path 9"):
        check(launches[label]["probe"] > 0
              or numbers[label]["lane"]["emit_tier"] == "device",
              f"{label}: no probe launch")

    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": 1}}))


if __name__ == "__main__":
    main()
