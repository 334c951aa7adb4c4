#!/usr/bin/env python3
"""Chip smoke of flink_tpu_torch on one NVIDIA GPU (written for the H100).

    python3 chip_smoke.py

Phases, each fatal on failure (exit code 1, no result line):

1. the card's name and power limit, as nvidia-smi reports them;
2. build of every kernel of the port's main paths from
   ``flink_tpu_torch/csrc`` with nvcc (``sm_90a``), one nvcc per source, and
   of the C host code with g++ (``csrc/host_mirror.cc``: the keydict and
   the window value mirror; ``csrc/spill_store.cc``; ``csrc/codec.cc``: the
   batch codec's FLZ blocks, varints and CRCs), all started together;
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
   1,000,000 keys, 2^18 records per batch, 5000 ms windows), 24 batches
   (``bench.py`` runs 64; cut for the time limit)
   through ``WindowAggOperator(device="cuda", device_probe="on")`` (scatter
   sync, one batch at a time) with a snapshot every 8 batches and
   ``end_input``; every fire is held against an independent numpy reference
   (per window ``np.bincount`` in f64 over the same records);
5. restore and replay of path 1: the first snapshot restored into a fresh
   operator and the remaining batches replayed must give the same
   per-window digests, bit for bit for every window that starts after the
   snapshot's (the window it cuts is re-seeded from the snapshot's f32
   cells, as in the reference, so its sums agree to 1e-6); a profiled
   replay gives the device's busy share and must equal the first replay
   bit for bit;
6. main path 2: the same 24 batches through the fused super-batch lane,
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
   (``FAULTS``): path 11 is path 5 with ``WedgedDevice(at=7)`` (batch
   6's fold wedges; the tier migrates its ring to the host mirror, the
   batches up to the re-promotion fold there, the snapshot at batch 7 is
   taken degraded, the schedule heals after batch 9 and the state goes
   back on the card at batch 15's barrier); path 12 is path 3 with a wedge
   in batch 6's guarded probe step (the f64 delta ring is salvaged from
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
   turns on, off, off, on: records/s, phases, dispatches a batch, the
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
   against its twin in turns (twin, mesh, mesh, twin; path 17 against path
   7 in one turn each);
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
9i. main paths 26-27 (slice 13), after path 25: path 26 is ``bench.py
   --cep``'s stream (``_cep_batches(1 << 22, 1_000_000, 1 << 18, 5000,
   seed=23)`` cut to its first 4 batches of 2^18 events, keys uniform over 1M,
   amounts uniform over [0, 600), each event's stream position in a column
   ``e``) through ``CepOperator(vectorized="on")`` on the card: the fraud
   pattern (``v < 30`` followed by ``v > 570`` within 20,000 ms), the
   select ``{k, amount}``, a watermark of ``max(ts) - 1`` after each batch,
   ``end_input`` last.  Every drain is one ``cep.vectorized_drain`` dispatch
   under the watchdog, and each event position of a chunk of up to 65,536
   keys one step of torch ops on the card (the block up, the flags and the
   new block down; a flagged step replays on the numpy step).  It launches
   no hand-written kernel.  Held to: its numpy twin (the same operator on
   the CPU, the host step) — the same rows in the same order, bit for bit,
   the snapshot after ``CEP_SNAPSHOT_AFTER`` batches and ``cep_stats()``;
   an interpreted twin over the first ``CEP_INTERPRETED_BATCHES`` batches;
   the operator on the CPU with ``FLINK_TPU_CEP_KERNEL=jit`` (the device
   step on CPU tensors) over ``CEP_CPU_BATCHES``; an independent numpy
   model of bait -> strike (the same set of (k, bait e, strike e) and
   count); and the snapshot restored on the card and replayed to the end
   (the rest of the rows bit for bit; its first drain under
   ``torch.profiler``: the device's busy share, ops a step).  It prints
   events/s, matches/s, drains, the partials high-water, drain walls,
   steps a drain and replays, bytes a step, the ``auto`` calibration's
   verdict and timings on the card, and an A/B against the numpy twin in
   turns (twin, card, card, twin).  Path 27 is path 26's first
   ``CEP_WEDGE_BATCHES`` batches under ``WedgedDevice`` at the third drain
   dispatch, under a monitor whose floor is ``CEP_FLOOR_FACTOR`` times
   path 26's worst drain: the operator degrades to the interpreted engine
   (``degraded`` 1), its rows equal the numpy twin's in order, the
   monitor's counters equal what was injected, and the degrade's cost is
   printed.
9j. join phase and main paths 28-31 (slice 14), after path 27.  The join
   phase holds ``ops/join_kernels.device_join_pairs`` (torch ops on the
   card: a stable sort of the right keys, two binary searches, the
   prefix-sum expansion) to its plain version on CPU copies exactly, in
   order and dtype: 2^20 x 2^20 keys uniform over 1M, a skewed case (one
   key on 0.1% of each side's rows, about 1.1M pairs from it), right keys
   half absent from the left, and empty sides; and times count, emit and
   the download (CUDA events) beside the plain version, the host lane's
   numpy ``_join_pairs`` and the bound.  Paths 28-30 run on the stream's
   first ``TABLE_BATCHES`` batches (the joins' right side a seed-8 stream
   of the same shape, each side with its stream position in ``e``); each
   path's mid-run snapshot is restored on the card and replayed bit for
   bit, the replay's first call under ``torch.profiler`` (the card's busy
   share).  Path 28 is ``ChangelogGroupAggOperator("k", {s: sum(v), n:
   count, mn: min(v), mx: max(v)})`` on the card (8 f32 planes of 2^20;
   the add words fold through ``scatter_fold``), held to the same operator
   on the CPU over ``TABLE_CPU_BATCHES`` batches bit for bit and to a
   numpy model batch by batch (counts, min and max exactly, sums to
   ``DS_STEP_RTOL`` a batch).  Path 29 is the two-level aggregate: path
   28's changelog keyed by its count ``n`` into
   ``ChangelogGroupAggOperator("n", {"keys": count},
   consume_retractions=True)``, held to the CPU bit for bit and to
   ``np.bincount`` of the model's counts.  Path 30 is
   ``IntervalJoinOperator`` (-500 ms, +500 ms) with
   ``FLINK_TPU_DEVICE_JOIN=1`` on the card, a watermark at each pair of
   batches' largest timestamp: its rows equal the device lane on the CPU
   in order, bit for bit, and the host lane's as a multiset of (left
   row, right row).  Path 31 is ``StreamingJoinOperator`` (inner,
   append-only: the ``_join_pairs`` fast path) on the card's device lane
   over the first halves (``STREAMING_ROWS``) of ``STREAMING_BATCHES``
   pairs of batches, held as path 30 is.  Each
   prints rows/s (the joins: input rows/s and pairs/s), the bytes over the
   bus and the card line.
9k. main paths 32-36 (slice 15), after path 31.  The graph is Graph500's
   Kronecker (R-MAT) graph at scale 22 (4,194,304 vertices, 67,108,864
   directed edges, edge factor 16, initiator 0.57/0.19/0.19/0.05, labels
   permuted, self loops and duplicates kept, SSSP weights uniform in [0,
   1)), made on the card from ``GRAPH_SEED`` and copied to the host for
   the models.  Path 32 is ``Graph.pagerank`` (damping 0.85, 10
   supersteps, ``tol=0``) on the directed graph: held to a scipy.sparse
   f64 power iteration with JAX's dangling redistribution
   (``PAGERANK_RTOL``), the ranks summing to 1; its sum combine at these
   shapes (67 M messages into 4 M vertices, one ``scatter_fold`` launch)
   equals the CPU's ``index_add_`` bit for bit and is timed beside
   ``index_add_`` and its bound; it prints supersteps, wall, CUDA-event
   time a superstep (p50/p99, the same supersteps through
   ``scatter_gather`` with an event at each), edges traversed per second,
   launches, the card's busy share over a profiled run and peak device
   memory.  Path 33 is BFS from ``BFS_ROOTS`` (1) seeded root of non-zero
   degree, WCC and SSSP from that root, on the graph taken undirected (Graph500
   kernels 2 and 3): levels and component labels (the least vertex id of
   each) equal scipy's BFS and weak components exactly, distances scipy's
   f64 Dijkstra within ``SSSP_RTOL``; each prints supersteps, edges
   traversed per second and the converged check's host wait.  Path 34 is
   path 32's PageRank and path 33's BFS over ``MESH_BLOCKS`` edge shards on
   the card (no interconnect): BFS equal to path 33's, PageRank within
   ``PAGERANK_RTOL`` of path 32's, each timed against its single-device
   twin in turns.  Path 35 is the dense family on a scale-12 graph of the
   same generator (all-pairs distances with eccentricity, closeness and
   diameter/radius, Jaccard, Adamic-Adar, HITS, label propagation)
   against scipy and numpy models (distances, Jaccard and labels
   exactly; the f32 scores within ``SCORE_RTOL`` and ``HITS_ATOL``), and
   the CPU bit for bit at scale 10 for everything whose order is fixed.
   Path 36 is a ``KeyedProcessFunction`` tumbling sum (per (window, key):
   a ``SumAggregator`` ``AggregatingState`` and a count ``ValueState``, an
   event-time timer at the window's end that emits and clears) over the
   1M-key stream's first 16 batches: held to ``reference`` (rtol
   ``RTOL``) and to the f32 record-order reference bit for bit, a twin
   over ``ChangelogKeyedStateBackend`` bit for bit, and the snapshot after
   batch 8 restored and replayed bit for bit; its numbers are the host's.
9l. main paths 37-39 (slice 16), after path 36: ``BASELINE.json`` config 1
   (SocketWindowWordCount) at ``bench.py`` ``run_config1``'s full size:
   2^22 words, Zipf(1.3) over a 30,000-word vocabulary from seed 11, 10
   words a line, 4096 lines a batch (``make_lines``, a copy of
   ``_make_lines``), string keys through ``ObjectKeyIndex``.  Path 37 is
   ``WindowAggOperator(TumblingEventTimeWindows.of(5000),
   SumAggregator(float32))`` on the host tier with the numpy mirror,
   scatter sync, tokenization in the timed region: every (word, window)
   count equals an exact Python-dict count (below 2^24, exact in f32), a
   device-emit-tier twin fires the same counts, and the halfway snapshot
   restores and replays bit for bit (a second, profiled replay gives the
   card's idle share).  Path 38 is the same WordCount as a DataStream job
   on ``LocalExecutor`` (lines -> ``flat_map`` -> timestamps ->
   ``key_by("word")`` -> tumbling 5000 ms -> ``sum`` -> collect): its rows
   equal path 37's.  Path 39 is ``examples/socket_window_word_count.py``'s
   shape: the lines over a loopback socket from a server thread the smoke
   starts, ``TumblingProcessingTimeWindows.of(5000)`` and ``count``,
   bounded by the server closing (``SOCKET_MAX_WALL_MS`` guard): per-word
   totals equal the input's.  Each launches ``scatter_fold`` and neither
   probe kernel.  After path 23, the mesh session fold's vector leaves (a
   [3] sum, [2] min and max) over ``MESH_BLOCKS`` blocks of the card equal
   the CPU mesh bit for bit on path 23's first batches.

9m. main paths 40-44 (slice 17), after path 39: the rest of the local
   job path and the DataStream API's routes, each through
   ``StreamExecutionEnvironment`` and ``LocalExecutor``.  Path 40 is the
   1M-key stream's 24 batches with late rows (from batch 6 on, a seed-41
   generator moves 8,192 rows of each batch back by 1,000-16,000 ms) through
   ``window(tumbling 5000).allowed_lateness(2000).side_output_late_data(
   "late")``, on the device tier (40a) and the host tier with the probe on
   (40b): the fires and late re-fires equal a numpy model (40a bit for bit,
   40b to ``RTOL``), the side output is the model's beyond-lateness rows in
   order, ``late_dropped`` is 0, and an untagged twin drops exactly those
   rows and fires 40a's rows bit for bit.  Path 41 is the environment's
   routes: its mesh (``make_mesh(devices=[card] * 4)``) for the window sum
   (41a, held to paths 14 and 15) and for config 4's sessions (41b, path
   23's rows), and ``.evictor(CountEvictor.of(1))`` with ``sum`` (the
   device lane, path 24's model) and ``apply`` (the host lane over 2
   batches).  Path 42 is ``CEP.pattern(...).select(vectorized="on")`` over
   the CEP stream's first 4 batches, equal to ``CepOperator`` driven
   directly and ``cep_model``.  Path 43 is the interval join (path 30's
   pairs) and the window join (a numpy model) through the API with
   ``FLINK_TPU_DEVICE_JOIN=1``.  Path 44 is path 36's process function on
   ``state.backend: spill`` with an 8 MiB budget over the first quarter
   of the first batch (``SPILL_ROWS``): the
   heap's fires bit for bit, the snapshot after the batch restored,
   persisted, compacted and fired bit for bit; host C and numpy, the card
   idle.

9n. main paths 45-47 (slice 18), after path 44: the batch side.  Path 45
   is TPC-H Query 3 as Flink's ``TPCHQuery3`` runs it on the DataSet API:
   customer, orders and lineitem at SF ``TPCH_SF`` (150,000, 1,500,000 and
   ~6.0 M rows from ``TPCH_SEED`` after dbgen's distributions), segment
   BUILDING and date 1995-03-15: the filters, customer join orders join
   lineitem, revenue summed by (orderkey, date, priority), the top 10, with
   ``FLINK_TPU_DEVICE_JOIN=1`` (the joins on the card) and a row budget of
   ``TPCH_BUDGET_ROWS`` (the lineitem join out of core: grace buckets in the
   port's FTB files).  Held to a host-lane twin (the joined rows as a
   multiset, the result's keys and order exactly, revenue to
   ``TPCH_RTOL``), a replay of the card lane bit for bit (profiled: the
   card's busy share), a numpy model of Q3, and ``stream_batches()``.  Path
   46 is Flink's ``ConnectedComponents`` on the DataSet API: a delta
   iteration (workset join edges, group-by min, join the solution set,
   filter) over path 32's Kronecker generator at scale ``CC_SCALE``
   undirected, whose edges come from the card through
   ``Graph.as_dataset``; the labels equal ``Graph.connected_components``
   on the card and scipy's weak components.  Path 47 is the State
   Processor API: path 5's and path 14's operators over the stream's 24
   batches, snapshotted inside the open window, stored through
   ``FileCheckpointStorage``, loaded and read with ``read_window_state``
   (``group_by("key").sum("acc0")`` equal to the f32 record-order
   reference bit for bit for path 5, the reference to ``RTOL`` for path
   14); ``BOOT_KEYS`` keys bootstrapped with ``SavepointWriter.
   with_keyed_state`` into path 36's count state and restored into path
   36's job on ``LocalExecutor``: its fires equal an un-bootstrapped run's
   plus the bootstrap values.  Paths 45 and 46 launch no hand-written
   kernel (the join's device work is torch ops); path 47 launches
   ``scatter_fold`` through path 5's and path 14's operators.

9o. main paths 48-50 (slice 19), after path 47: the SQL stack, each query
   through ``TableEnvironment(device=card)`` with plan, execute and collect
   in the timed region (``bench.py``'s).  Path 48 is ``BASELINE.json``
   config 5 at ``run_config5``'s full size: ``lineitem(2^22)`` (a copy of
   ``_lineitem``, seed 19) registered with ``rowtime="ts"`` and batches of
   2^17, its TUMBLE and HOP queries verbatim: the row counts, ``COUNT(*)``
   exactly and the sums within ``n * U32`` of a numpy model's f64 sums,
   every row bit for bit against a CPU twin whose window operator is
   pinned to the card's resolved lane (``window_lane``).  Path 49 is the
   main stream's first ``SQL_BATCHES`` (12) batches as a collection table
   under ``EVENTS_SQL``
   (``GROUP BY k, TUMBLE(ts, 5 s)``): ``ws`` the windows' starts,
   ``COUNT(*)`` exact, ``SUM(v)`` bit for bit against ``reference_f32`` on
   the device tier or within ``RTOL`` of ``reference`` on the host tier,
   its records/s beside paths 5 and 40a.  Path 50 is TPC-H Q3 as SQL
   (``Q3_SQL``) on path 45's tables at SF ``TPCH_SF`` with
   ``FLINK_TPU_DEVICE_JOIN=1``: the top 10 against ``q3_model`` (revenue
   within ``2 n U32``), every row bit for bit against the CPU twin, its
   wall beside path 45's; 50b is ``MATCH_SQL`` over the first
   ``MATCH_EVENTS`` events of path 26's first batch: the interpreted
   engine, the CPU twin's matches, and
   ``cep_vectorized="on"`` refused.  Each path launches ``scatter_fold``
   (50b none).

9p. main paths 51-52 (slice 20), after path 50: checkpointing and the
   MiniCluster.  Path 51 runs the operator with ``incremental_state`` on
   four lanes (51a path 5's options, 51b path 3's, 51c path 7's at 12
   batches, 51d path 14's at 12 batches): a cut every ``INCR_EVERY``
   batches under ``snapshot_scope(cid, incremental=True)`` into
   ``IncrementalCheckpointStorage(retain=3)``, confirmed but for cut
   ``INCR_WITHHELD`` (the next cuts ship the union), beside a full
   snapshot at the same batch into ``FileCheckpointStorage``: every
   ``load(cid)`` equals that full snapshot bit for bit; ``load_latest()``
   at the middle batch restored into a fresh operator and run to the end
   equals the restore of the full snapshot bit for bit, and the
   uninterrupted run (bit for bit on the device tiers; the host tiers'
   window open at the cut to 1e-6, as phase 5's replays).  It prints
   increments against re-bases, the increment's d2h bytes, cut ms p50/p99
   and stored bytes against the full snapshot's, ``load_latest`` ms and
   the chain.  Path 52 is the north star as a DataStream job on
   ``execute_cluster`` at parallelism 2 on the card (one source split, so
   every key folds in record order), checkpoints every 250 ms into
   ``IncrementalCheckpointStorage`` with ``incremental=True``: 52a the
   device tier, a ``CrashOnceAt`` on ``subtask.run`` failing window
   subtask 0 once after two completed checkpoints, ``restart_attempts=1``
   (every (key, window) present, every row, repeats included, equal to
   ``reference_f32`` bit for bit; one restart; the card's memory back
   within 64 MiB once the job is released); 52b the host tier with the
   probe on, unaligned checkpoints, no failure (rows to ``RTOL``).  Each
   prints records/s beside paths 5 and 40a, the checkpoints' count,
   ``delta_bytes`` and duration p50/p99, recovery ms, and each subtask's
   resolved lane.  51b, 52b launch ``probe``; every lane ``scatter_fold``.
9q. main path 53 (slice 21), after path 52: the north star as a ``ProcessCluster`` job on the
   card: ``PC_BATCHES`` (48) batches of the main stream in one split
   (``chip_smoke:job53``, which every worker imports), parallelism 2 on 2
   worker processes, each spawned with the coordinator's ``--device``,
   pinning path 3's lane (the host tier, the probe on) and counting its
   own launches, start-up and data-plane bytes into a file at its exit;
   the source's worker sends half the keyed records to the other over the
   TCP data plane; aligned incremental checkpoints every 250 ms into
   ``IncrementalCheckpointStorage``; after two completed cuts, while
   window subtask 0 runs, its worker is SIGKILLed, respawned on the card
   and restored in place while the other worker keeps its pid.  Checks:
   ``FINISHED`` with one recovery; every (key, window) present, every row
   equal to ``reference``'s f64 sums bit for bit (the host tier's sums of
   f32 values are exact), but the windows the restored cut held open,
   which restart from its f32 cells, to ``RTOL``; no repeats; each final
   worker launched ``probe`` and ``scatter_fold`` on the card; no worker
   alive after the job; the card's free memory back within 64 MiB.  It
   prints records/s beside 52a and 52b, recovery ms (kill to the respawned
   worker's first record), the respawned worker's start-up (its CUDA
   context and kernel load apart), the cuts (count, p50/p99, source
   offsets), the bytes over the data plane and each worker's launches.
9r. main paths 54-55 (slice 22), after path 53: serving and observability.
   Path 54 runs the main stream through path 5's operator (54a, the device
   tier) and path 3's (54b, the host tier with the probe on) with
   ``queryable="north_star"``, its view registered in a
   ``QueryableStateService`` behind a ``QueryableStateServer`` on
   127.0.0.1 (the binary columnar protocol), a snapshot every 8 batches
   fed to the service's ``CheckpointReplica``.  While the task thread
   runs, a client thread sends live lookups of 4096 uniform keys (numpy,
   seed 54) as fast as it can.  Checks: after each fire every key it
   emitted, looked up live in requests of 65,536, reads that fire's row bit
   for bit; at each snapshot 65,536 uniform keys at checkpoint consistency
   read the numpy combine of the snapshot's panes bit for bit; 54a launches
   ``scatter_fold``, 54b ``probe``.  It prints lookups/s, request p50/p99
   (the client's clock), serve p50/p99 (``service.stats()``), the cache's
   hit rate, the replica's lag and ingest ms, and records/s beside a twin
   without the view and the view without the client.  Path 55 runs the
   main stream's first ``OBS_BATCHES`` (8) batches as the north star job
   on a MiniCluster (parallelism 2, path 5's lane pinned) with
   ``metrics.tracing.enabled`` and a ``RestServer`` over it; with the
   sources held (they keep answering barriers) it GETs ``/overview``,
   ``/jobs``, ``/jobs/<id>`` and its ``checkpoints``, ``metrics``,
   ``backpressure`` and ``flamegraph``, and the dashboard (each 200, of the
   reference's shape), scrapes a ``PrometheusReporter`` and runs ``python
   -m flink_tpu_torch status`` against the server.  After the job: rows
   bit-equal to the f32 ordered reference, the journal's ``hot_stage``
   spans per phase summing to the window subtasks' ``phase_ns`` exactly,
   its Chrome export's ``checkpoint`` spans as many as
   ``_checkpoint_stats``.  It prints the journal's events and drops, the
   GETs' p50/p99 ms, and tracing's cost: path 5's operator with the journal
   off and on in alternating pairs.

Each phase and path prints its command time on a line of its own.

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
N_BATCHES = 24
SNAPSHOT_EVERY = 8
PANES = 16                      # the operator's pane ring at these windows
SUPERBATCH = 8
RTOL = 1e-6   # f32 results against the reference's f64 sums

#: the kernels of the main paths, built together in phase 2
SOURCES = ("probe.cu", "probe_fold.cu", "scatter_fold.cu")
#: the C host layer of paths 3 and 4, and the spill store of path 7, built
#: beside them with g++
HOST_SOURCE = "host_mirror.cc"
SPILL_SOURCE = "spill_store.cc"
#: the batch codec of paths 45-47's spill files and savepoints' frames
CODEC_SOURCE = "codec.cc"
HOST_SOURCES = (HOST_SOURCE, SPILL_SOURCE, CODEC_SOURCE)
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
#: wedges the device tier's 7th dispatch (batch 6's fold); path 12
#: wedges batch 6's guarded probe step (the probe lane has one or two
#: dispatches a batch, so the point is counted when the batch starts);
#: path 13's third dispatch (batch 1's first half) fails with an OOM.
#: The snapshot after batch 7 is taken degraded, the schedules heal after
#: batch 9 and the state goes back on the card at batch 15's barrier
OOM_ACTION = ("fail", "RESOURCE_EXHAUSTED: out of memory allocating the "
              "replica fold's scratch (injected)")
FAULTS = {
    "path 11": dict(base="path 5", inject_at=0, heal_at=9,
                    schedule=lambda ch, fired: ch.WedgedDevice(at=7)),
    "path 12": dict(base="path 3", inject_at=6, heal_at=9,
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
FAULTS["path 16"] = dict(base="path 15", inject_at=0, heal_at=9,
                         schedule=lambda ch, fired: ch.WedgedDevice(at=7))
PATHS["path 16"] = dict(PATHS["path 15"])
DEVICE_PATHS["path 15"] = "path 3"
PAGED_PATHS["path 17"] = "path 5"
PAGED_REPLAY_CAPACITY["path 17"] = 1 << 19
#: each mesh path and the single-block path it equals bit for bit (fires;
#: path 14's snapshot too, densified), and is timed against in turns
MESH_TWIN = {"path 14": "path 3", "path 15": "path 5", "path 16": "path 11",
             "path 17": "path 7"}
#: the mesh paths whose A/B runs one turn each, twin then mesh: the paged
#: pair's runs take about 7 s each (four turns before slice 22)
MESH_AB_ONE_PAIR = ("path 17",)
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
    with ThreadPoolExecutor(len(SOURCES) + len(HOST_SOURCES)) as pool:
        list(pool.map(lambda f: f(), [lambda s=s: build.build(s)
                                      for s in SOURCES]
                      + [lambda s=s: build.build_host(s)
                         for s in HOST_SOURCES]))
    build.probe_lib()
    build.probe_fold_lib()
    build.scatter_fold_lib()
    build.spill_store_lib()
    build.codec_lib()
    host = build.host_mirror_lib()
    print(f"build: {', '.join(SOURCES + HOST_SOURCES)} in "
          f"{time.perf_counter() - t0:.2f} s wall (nvcc " + ", ".join(
              f"{s} {build.build_seconds.get(s, 0.0):.2f} s"
              for s in SOURCES) + "; g++ " + ", ".join(
              f"{s} {build.build_seconds.get(s, 0.0):.2f} s"
              for s in HOST_SOURCES) + ")")
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
    sc.ordered_fold.launches = 0


def read_launches():
    """Launches per kernel; ``scatter_fold`` sums its three wrappers'
    counts, each also given alone (``_single``: ``ordered_fold_counts``,
    ``_multi``: ``ordered_fold_counts_multi``, ``_plane``:
    ``ordered_fold``, the graph library's sum combine)."""
    from flink_tpu_torch.ops import scatter as sc
    from flink_tpu_torch.state import device_keyindex as dk
    single = sc.ordered_fold_counts.launches
    multi = sc.ordered_fold_counts_multi.launches
    plane = sc.ordered_fold.launches
    return {"probe": dk.probe.launches, "probe_fold": dk.probe_fold.launches,
            "scatter_fold": single + multi + plane,
            "scatter_fold_single": single, "scatter_fold_multi": multi,
            "scatter_fold_plane": plane}


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
    in turns twin, mesh, mesh, twin (the paged pair, ``MESH_AB_ONE_PAIR``,
    in one turn each), each run's fires bit-equal to its path's main run:
    records/s and their median ratio, beside the card's nvidia-smi
    line."""
    n = sum(len(b[0]) for b in batches)
    ratios = {}
    for label, twin in MESH_TWIN.items():
        rate = {twin: [], label: []}
        turns = ((twin, label) if label in MESH_AB_ONE_PAIR
                 else (twin, label, label, twin))
        for side in turns:
            wall, got = ab_run(device, batches, side)
            check(got == want[side], f"A/B {side}: fires differ from "
                  f"{side}'s run")
            rate[side].append(n / wall)
        ratios[label] = np.median(rate[label]) / np.median(rate[twin])
        print(f"A/B {label} ({MESH_BLOCKS} blocks on one card) vs {twin} "
              f"(one block), same batches, turns {', '.join(turns)}: "
              f"records/s " + ", ".join(
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
    on the same batches, in turns on, off, off, on (twice before slice 22,
    whose paths took the time), each run's fires
    bit-equal to the path's main run; records/s, the phases, dispatches a
    batch and a dispatch's hand-off times."""
    n = sum(len(b[0]) for b in batches)
    result = {}
    for label in GUARD_AB:
        runs = {True: [], False: []}
        for guarded in (True, False, False, True):
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
              f"on, off, off, on: records/s on "
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
    from flink_tpu_torch.core.batch import (MAX_WATERMARK, RecordBatch,
                                            Watermark)
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


# ---------------------------------------------------------------------------
# slice 13: CEP (paths 26, 27)
# ---------------------------------------------------------------------------

SLICE13 = ("path 26", "path 27")
#: ``bench.py --cep``'s stream: ``_cep_batches(1 << 22, 1_000_000, 1 << 18,
#: 5000, seed=23)`` cut to its first 2^20 events (4 batches, widths
#: unchanged) for the time limit, and the fraud pattern within 4 windows
CEP_RECORDS = 1 << 20
CEP_KEYS = 1_000_000
CEP_BATCH = 1 << 18
CEP_WINDOW_MS = 5000
CEP_SEED = 23
CEP_WITHIN_MS = 4 * CEP_WINDOW_MS
CEP_SNAPSHOT_AFTER = 2          # batches in when the snapshot is taken
#: the interpreted twin's and the CPU run's depths: one batch each (four
#: and two before slice 22, whose paths took their time)
CEP_INTERPRETED_BATCHES = 1
CEP_CPU_BATCHES = 1
CEP_WEDGE_BATCHES = 4
CEP_WEDGE_AT = 3                # path 27 wedges its third drain dispatch
CEP_FLOOR_FACTOR = 4            # path 27's floor over path 26's worst drain
CEP_LABEL = "cep.vectorized_drain"


def make_cep_batches():
    """Copy of ``bench.py`` ``_cep_batches`` at ``--cep``'s full size: keys
    uniform over 1M, amounts uniform over [0, 600), timestamps sorted within
    each 5000 ms batch."""
    rng = np.random.default_rng(CEP_SEED)
    batches = []
    t = 0
    for lo in range(0, CEP_RECORDS, CEP_BATCH):
        b = min(CEP_BATCH, CEP_RECORDS - lo)
        keys = rng.integers(0, CEP_KEYS, b).astype(np.int64)
        vals = (rng.random(b) * 600.0).astype(np.float64)
        ts = t + np.sort(rng.integers(0, CEP_WINDOW_MS, b)).astype(np.int64)
        t += CEP_WINDOW_MS
        batches.append((keys, vals, ts))
    return batches


def cep_op(device, mode="on", log=None):
    """``bench.py``'s fraud pattern (a small bait, then a large strike on
    the same key within 20,000 ms) and its select ``{k, amount}``.  The
    batches carry each event's stream position in column ``e``; ``log``
    (a list) collects ``(k, bait e, strike e)`` of every match."""
    from flink_tpu_torch.cep import CepOperator, Pattern

    pattern = (Pattern.begin("small")
               .where(lambda c: np.asarray(c["v"]) < 30.0)
               .followed_by("large")
               .where(lambda c: np.asarray(c["v"]) > 570.0)
               .within(CEP_WITHIN_MS))

    def select(m):
        small, large = m["small"][0], m["large"][0]
        if log is not None:
            log.append((small["k"], small["e"], large["e"]))
        return {"k": small["k"], "amount": large["v"]}

    return CepOperator(pattern, "k", select, vectorized=mode, device=device)


def cep_drive(op, batches, start=0, stop=None, snap_after=None,
              drain_ms=None, end=True, profile_first=None, drain_steps=None):
    """Feed batches ``start:stop`` (a watermark of ``max(ts) - 1`` after
    each), then ``end_input``.  Returns (rows, snapshot, seconds without
    the snapshot, snapshot seconds): ``rows`` holds per emitting call
    ``(call, k bytes, amount bytes, ts bytes, dtypes)``; ``drain_ms``
    collects each watermark and end call's host wall, ``drain_steps`` the
    operator's step count after each; ``profile_first`` (a profiler) wraps
    the first watermark call."""
    from flink_tpu_torch.core.batch import RecordBatch, Watermark

    stop = len(batches) if stop is None else stop
    base = sum(len(b[0]) for b in batches[:start])
    rows, snap, snap_s = [], None, 0.0

    def keep(call, out):
        for b in out:
            k = np.asarray(b.columns["k"])
            amt = np.asarray(b.columns["amount"])
            ts = np.asarray(b.timestamps)
            rows.append((call, k.tobytes(), amt.tobytes(), ts.tobytes(),
                         (k.dtype.str, amt.dtype.str, ts.dtype.str)))

    t0 = time.perf_counter()
    for i in range(start, stop):
        keys, vals, ts = batches[i]
        e = base + np.arange(keys.size, dtype=np.int64)
        base += keys.size
        out = op.process_batch(RecordBatch({"k": keys, "v": vals, "e": e},
                                           timestamps=ts))
        prof = profile_first if i == start else None
        d0 = time.perf_counter()
        with prof if prof is not None else contextlib.nullcontext():
            out += op.process_watermark(Watermark(int(ts.max()) - 1))
        if drain_ms is not None:
            drain_ms.append((time.perf_counter() - d0) * 1e3)
        if drain_steps is not None:
            drain_steps.append(op.step_stats["steps"])
        keep(i, out)
        if snap_after is not None and i == snap_after - 1:
            s0 = time.perf_counter()
            snap = op.snapshot_state()
            snap_s = time.perf_counter() - s0
    if end:
        d0 = time.perf_counter()
        out = op.end_input()
        if drain_ms is not None:
            drain_ms.append((time.perf_counter() - d0) * 1e3)
        keep(stop, out)
    return rows, snap, time.perf_counter() - t0 - snap_s, snap_s


def cep_model(batches):
    """Independent numpy model of bait -> strike: per key in (ts, event)
    order, each small event (v < 30) matches the first later large one
    (v > 570) when it comes within ``CEP_WITHIN_MS``.  Returns the set of
    ``(k, bait e, strike e)``."""
    keys = np.concatenate([b[0] for b in batches])
    vals = np.concatenate([b[1] for b in batches])
    ts = np.concatenate([b[2] for b in batches])
    e = np.arange(keys.size, dtype=np.int64)
    order = np.lexsort((e, ts, keys))
    k, v, t, e = keys[order], vals[order], ts[order], e[order]
    large = np.flatnonzero(v > 570.0)
    small = np.flatnonzero(v < 30.0)
    nxt = np.searchsorted(large, small, side="right")
    ok = nxt < large.size
    s, l_ = small[ok], large[nxt[ok]]
    hit = (k[s] == k[l_]) & (t[l_] - t[s] <= CEP_WITHIN_MS)
    return set(zip(k[s][hit].tolist(), e[s][hit].tolist(),
                   e[l_][hit].tolist()))


def snap_equal(a, b) -> bool:
    if isinstance(a, dict) and isinstance(b, dict):
        return (list(a.keys()) == list(b.keys())
                and all(snap_equal(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(snap_equal(x, y)
                                        for x, y in zip(a, b))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return np.array_equal(np.asarray(a), np.asarray(b))
    return a == b


def cep_calibration(device) -> None:
    """The ``auto`` engine calibration, measured on the card."""
    from flink_tpu_torch.cep import vectorized as V

    V._reset_calibration()
    verdict = V.calibrated_vectorized_cep(device)
    m = V.last_measurement[device.type]
    print(f"path 26 auto calibration on the card: "
          f"{'vectorized' if verdict else 'interpreted'} (batched drain "
          f"{m['vectorized_s'] * 1e3:.3f} ms vs interpreted "
          f"{m['interpreted_s'] * 1e3:.3f} ms; 4096 keys x 4 events, best of "
          f"2 after one warm run)")
    V._reset_calibration()


def path26(device, batches):
    """Path 26: the ``bench.py --cep`` stream through ``CepOperator(
    vectorized="on")`` with the device step on the card, held to its numpy
    twin, an interpreted twin, the same operator on the CPU, an independent
    model and a replay of its mid-run snapshot.  Returns (launches, numbers,
    the twin's rows of the first ``CEP_WEDGE_BATCHES`` batches)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from flink_tpu_torch.runtime import device_health

    label = "path 26"
    n_events = sum(len(b[0]) for b in batches)
    # turn 1 of the A/B: the numpy twin (the host step on the CPU)
    device_health.set_monitor(device_health.DeviceHealthMonitor())
    twin = cep_op(torch.device("cpu"))
    twin_rows, twin_snap, twin_s1, _ = cep_drive(
        twin, batches, snap_after=CEP_SNAPSHOT_AFTER)
    check(twin._vec.kernel == "numpy", f"{label}: twin kernel "
          f"{twin._vec.kernel}")
    # turn 2: the main path on the card, every launch count at 0 before
    mon = device_health.DeviceHealthMonitor()
    device_health.set_monitor(mon)
    log, drain_ms = [], []
    op = cep_op(device, log=log)
    torch.cuda.synchronize()
    reset_launches()
    rows, snap, card_s1, snap_s = cep_drive(
        op, batches, snap_after=CEP_SNAPSHOT_AFTER, drain_ms=drain_ms)
    torch.cuda.synchronize()
    launches = read_launches()
    stats, steps = op.cep_stats(), dict(op.step_stats)
    check(op._vec.kernel == "device" and op.device.type == "cuda",
          f"{label}: kernel {op._vec.kernel} on {op.device}")
    check(all(v == 0 for v in launches.values()),
          f"{label}: launches {launches}; CEP runs no hand-written kernel")
    check(steps["steps"] > 0 and steps["h2d_bytes"] > 0,
          f"{label}: the device step did not run: {steps}")
    labels = dict(mon.label_counts)
    check(set(labels) == {CEP_LABEL}
          and 0 < labels[CEP_LABEL] <= stats["vectorized_drains"]
          and mon.counters["quarantines"] == 0
          and mon.counters["watchdog_timeouts"] == 0,
          f"{label}: monitor {labels} {mon.counters}")
    # turns 3 and 4: card, then twin, without snapshots
    _, _, card_s2, _ = cep_drive(cep_op(device), batches)
    device_health.set_monitor(device_health.DeviceHealthMonitor())
    _, _, twin_s2, _ = cep_drive(cep_op(torch.device("cpu")), batches)
    device_health.set_monitor(mon)
    # the numpy twin: rows, order, snapshot and stats
    check(rows == twin_rows and rows,
          f"{label}: the card's rows differ from the numpy twin's")
    tstats = twin.cep_stats()
    for k in ("matches", "partials_high_water", "vectorized_drains",
              "interpreted_drains", "degraded", "engine"):
        check(stats[k] == tstats[k], f"{label}: cep_stats {k} {stats[k]} vs "
              f"twin {tstats[k]}")
    check(stats["degraded"] == 0 and stats["engine"] == "vectorized",
          f"{label}: stats {stats}")
    check(snap_equal(snap, twin_snap),
          f"{label}: the snapshot after {CEP_SNAPSHOT_AFTER} batches differs "
          f"from the numpy twin's")
    del twin_snap
    # the independent model
    model = cep_model(batches)
    check(len(log) == len(set(log)) == len(model) == stats["matches"]
          and set(log) == model,
          f"{label}: {len(log)} matches ({len(set(log))} distinct) against "
          f"the model's {len(model)}; {len(set(log) ^ model)} differ")
    # the interpreted twin over the first batches
    n_int = CEP_INTERPRETED_BATCHES
    off = cep_op(torch.device("cpu"), mode="off")
    int_rows, _, int_s, _ = cep_drive(off, batches, stop=n_int, end=False)
    check(int_rows == [r for r in rows if r[0] < n_int] and int_rows,
          f"{label}: the interpreted twin's first {n_int} batches differ")
    # the same operator on the CPU with the device step forced
    n_cpu = CEP_CPU_BATCHES
    prev = os.environ.get("FLINK_TPU_CEP_KERNEL")
    os.environ["FLINK_TPU_CEP_KERNEL"] = "jit"
    try:
        cpu = cep_op(torch.device("cpu"))
        cpu_rows, _, _, _ = cep_drive(cpu, batches, stop=n_cpu, end=False)
    finally:
        if prev is None:
            os.environ.pop("FLINK_TPU_CEP_KERNEL")
        else:
            os.environ["FLINK_TPU_CEP_KERNEL"] = prev
    check(cpu._vec.kernel == "device" and cpu.step_stats["steps"] > 0,
          f"{label}: the CPU run's kernel {cpu._vec.kernel}")
    check(cpu_rows == [r for r in rows if r[0] < n_cpu] and cpu_rows,
          f"{label}: the device step on the CPU differs over {n_cpu} batches")
    # replay from the snapshot; its first drain under torch.profiler
    rop = cep_op(device)
    r0 = time.perf_counter()
    rop.restore_state(snap)
    restore_s = time.perf_counter() - r0
    before = dict(rop.step_stats)
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    replay_ms, replay_steps = [], []
    replay, _, _, _ = cep_drive(rop, batches, start=CEP_SNAPSHOT_AFTER,
                                drain_ms=replay_ms, profile_first=prof,
                                drain_steps=replay_steps)
    check(replay == [r for r in rows if r[0] >= CEP_SNAPSHOT_AFTER]
          and replay, f"{label}: the replay from the snapshot differs")
    busy_ms, dev = device_busy_ms(prof)
    n_ops = sum(e.count for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and e.self_device_time_total > 0)
    check(n_ops > 0, f"{label}: the profiled drain ran nothing on the card")
    del snap
    prof_steps = replay_steps[0] - before["steps"]
    share = busy_ms / replay_ms[0]
    n_drains = len(drain_ms)
    p50 = float(np.percentile(drain_ms, 50))
    p99 = float(np.percentile(drain_ms, 99))
    eps = n_events / card_s1
    print(f"{label}: {n_events} events in {card_s1:.3f} s = {eps:.1f} "
          f"events/s, {stats['matches'] / card_s1:.1f} matches/s "
          f"({stats['matches']} matches = the numpy twin's rows in order, bit "
          f"for bit; the model's (k, bait, strike) set); launches {launches}")
    print(f"{label} drains: {stats['vectorized_drains']} (guarded "
          f"{labels[CEP_LABEL]}), partials high-water "
          f"{stats['partials_high_water']}; drain host wall p50 {p50:.3f} ms "
          f"p99 {p99:.3f} ms (max {max(drain_ms):.3f}) over {n_drains} "
          f"calls; snapshot {snap_s * 1e3:.3f} ms, restore "
          f"{restore_s * 1e3:.3f} ms")
    print(f"{label} steps: {steps['steps'] / n_drains:.2f} a drain "
          f"({steps['steps']} in all), {steps['replayed']} replayed on the "
          f"numpy step (flags); h2d {steps['h2d_bytes'] / steps['steps']:.0f} "
          f"B and d2h {steps['d2h_bytes'] / steps['steps']:.0f} B a step")
    print(f"{label} profiled drain (the replay's first): wall "
          f"{replay_ms[0]:.3f} ms, device busy {busy_ms:.3f} ms = "
          f"{100 * share:.2f}% (idle {100 - 100 * share:.2f}%); {n_ops} "
          f"device ops over {prof_steps} steps = "
          f"{n_ops / max(prof_steps, 1):.1f} a step; top device ops (ms): "
          + "; ".join(f"{k[:50]} {t / 1e3:.3f}" for t, k in dev[:6]))
    print(f"{label} checks: the interpreted twin's first {n_int} batches "
          f"({int_s:.3f} s) and the device step on the CPU over {n_cpu} "
          f"batches equal the card's rows in order; the replay from the "
          f"snapshot after {CEP_SNAPSHOT_AFTER} batches equals the run's "
          f"rest, bit for bit")
    a1, a2 = n_events / card_s1, n_events / card_s2
    b1, b2 = n_events / twin_s1, n_events / twin_s2
    print(f"A/B path 26 (device step) vs its numpy twin, same batches, one "
          f"process, turns twin, card, card, twin: events/s {a1:.1f}, {a2:.1f} "
          f"vs {b1:.1f}, {b2:.1f} ({(a1 + a2) / (b1 + b2):.3f}x)")
    cep_calibration(device)
    device_health.set_monitor(None)
    numbers = {"events_per_s": eps, "max_drain_ms": max(drain_ms),
               "drain_ms": drain_ms}
    return launches, numbers, [r for r in twin_rows
                               if r[0] < CEP_WEDGE_BATCHES]


def path27(device, batches, numbers26, want):
    """Path 27: path 26's first batches with ``WedgedDevice`` at the third
    ``cep.vectorized_drain`` dispatch, under a monitor whose floor is
    ``CEP_FLOOR_FACTOR`` times path 26's worst clean drain: the operator
    degrades to the interpreted engine, and its rows equal the numpy twin's
    in order."""
    import torch

    from flink_tpu_torch.runtime import device_health
    from flink_tpu_torch.testing import chaos

    label = "path 27"
    floor = max(CEP_FLOOR_FACTOR * numbers26["max_drain_ms"] / 1e3, 2.0)
    mon = device_health.DeviceHealthMonitor(
        device_health.WatchdogConfig(deadline_floor_s=floor,
                                     first_dispatch_grace_s=max(60.0, floor)),
        heal_async=False)
    device_health.set_monitor(mon)
    inj = chaos.FaultInjector(seed=27)
    wedge = chaos.WedgedDevice(at=CEP_WEDGE_AT)
    inj.inject("device.dispatch", wedge)
    op = cep_op(device)
    drain_ms = []
    torch.cuda.synchronize()
    reset_launches()
    try:
        with chaos.installed(inj):
            rows, _, elapsed, _ = cep_drive(op, batches,
                                            stop=CEP_WEDGE_BATCHES,
                                            drain_ms=drain_ms, end=False)
    finally:
        wedge.heal()
        device_health.set_monitor(None)
    launches = read_launches()
    stats = op.cep_stats()
    check(all(v == 0 for v in launches.values()),
          f"{label}: launches {launches}")
    check(stats["degraded"] == 1 and stats["engine"] == "interpreted",
          f"{label}: stats {stats}")
    check(rows == want and rows,
          f"{label}: the degraded rows differ from the numpy twin's")
    expect = dict(QUIET, quarantines=1, watchdog_timeouts=1,
                  dispatches=CEP_WEDGE_AT)
    got = {k: mon.counters[k] for k in expect}
    check(got == expect and dict(mon.label_counts) == {CEP_LABEL:
                                                       CEP_WEDGE_AT},
          f"{label}: monitor {got} {dict(mon.label_counts)}, expected "
          f"{expect}")
    at = CEP_WEDGE_AT - 1
    clean = numbers26["drain_ms"]
    print(f"{label}: {sum(len(b[0]) for b in batches[:CEP_WEDGE_BATCHES])} "
          f"events in {elapsed:.3f} s; the wedge at drain {CEP_WEDGE_AT} "
          f"quarantined after the {floor:.3f} s floor ({CEP_FLOOR_FACTOR}x "
          f"path 26's worst drain); degraded {stats['degraded']}, engine "
          f"{stats['engine']}; rows equal the numpy twin's in order; monitor "
          f"{got}, labels {dict(mon.label_counts)}; launches {launches}")
    print(f"{label} degrade cost: the wedged call {drain_ms[at]:.3f} ms "
          f"(the floor, the decode to per-key NFAs, the interpreted drain) "
          f"against path 26's {clean[at]:.3f} ms; the drain after the "
          f"quarantine {drain_ms[at + 1]:.3f} ms interpreted against "
          f"{clean[at + 1]:.3f} ms")
    return launches


# ---------------------------------------------------------------------------
# slice 14: the table runtime's device half (join phase, paths 28-31)
# ---------------------------------------------------------------------------

SLICE14 = ("path 28", "path 29", "path 30", "path 31")
#: paths 28-30: the stream's first 8 batches (16 before slice 22, whose
#: paths took their time), the snapshot after 4
TABLE_BATCHES = 8
TABLE_SNAPSHOT_AFTER = 4        # batches in when the snapshot is taken
TABLE_CPU_BATCHES = 4           # path 28's CPU twin
RIGHT_SEED = 8                  # the joins' right side: a seed-8 stream
JOIN_LOWER_MS, JOIN_UPPER_MS = -500, 500
#: path 31 keeps every row of both sides as a Python tuple (JAX's state
#: layout), so it runs fewer batches than paths 28-30 (widths unchanged),
#: and each batch's first half (cut from the whole batch when slice 21's
#: path 53 took the smoke over its 900 s target)
STREAMING_BATCHES = 2
STREAMING_ROWS = BATCH // 2
STREAMING_SNAPSHOT_AFTER = 1
JOIN_PHASE_ROWS = 1 << 19       # each side's keys (2^20 before slice 22)
JOIN_HOT_SHARE = 0.001          # the skewed case's hot key, on each side
#: path 28's aggregates: the double-single sum and count, the Dekker-pair
#: min and max (8 f32 planes of K = 2^20 on the card)
TABLE_AGGS = {"s": ("v", "sum"), "n": (None, "count"), "mn": ("v", "min"),
              "mx": ("v", "max")}
#: the sums' bound against the model's f64 sum of the per-batch f32
#: partials: each 2Sum step of the double-single accumulator is exact but
#: for the rounding of its f32 low word, at most 2^-24 of a low word that
#: is itself at most half an ulp (2^-24) of the high word, so a step adds
#: at most 2^-47 |S|; 2^-46 a step leaves a factor 2 for the f64 model's
#: own rounding
DS_STEP_RTOL = 2.0 ** -46


def view_bits(batch) -> tuple:
    """A batch's columns and timestamps, dtype and bytes each (an object
    column by its values: the array numpy makes of them, tagged ``O``)."""
    def bits(a):
        a = np.asarray(a)
        if a.dtype.kind == "O":
            a = np.asarray(a.tolist())
            return "O", a.dtype.str, a.tobytes()
        return a.dtype.str, a.tobytes()
    ts = batch.timestamps
    return (tuple((c, bits(a)) for c, a in batch.columns.items()),
            None if ts is None else bits(ts))


def digest_rows(outs) -> list:
    """(call, sha256 of a batch's view) per emitted batch."""
    return [(i, hashlib.sha256(repr(view_bits(b)).encode()).hexdigest())
            for i, out in outs for b in out]


def join_phase(device):
    """The device equi-join (``ops/join_kernels.device_join_pairs``, torch
    ops) on the card at 2^20 x 2^20 keys drawn from 1M, and on a skewed,
    an absent-keys and empty inputs: each held to its plain version on the
    CPU exactly; timed (count, emit, download) beside the plain version,
    the host lane's numpy ``_join_pairs`` and the bound."""
    import torch

    from flink_tpu_torch.operators import joins
    from flink_tpu_torch.ops import join_kernels as jk

    rng = np.random.default_rng(7)
    n = JOIN_PHASE_ROWS
    lk = rng.integers(0, N_KEYS, n).astype(np.int64)
    rk = rng.integers(0, N_KEYS, n).astype(np.int64)
    hot_l, hot_r = lk.copy(), rk.copy()
    hot_l[rng.random(n) < JOIN_HOT_SHARE] = 123_456
    hot_r[rng.random(n) < JOIN_HOT_SHARE] = 123_456
    cases = {"uniform": (lk, rk), "skewed": (hot_l, hot_r),
             "absent": (lk, rk + N_KEYS // 2),
             "empty left": (lk[:0], rk), "empty right": (lk, rk[:0])}
    pairs = {}
    for name, (a, b) in cases.items():
        got = jk.device_join_pairs(a, b, device)
        want = jk.device_join_pairs(a, b, "cpu")
        check(all(g.dtype == w.dtype == np.int64 and np.array_equal(g, w)
                  for g, w in zip(got, want)),
              f"join phase {name}: the card's pairs differ from the plain "
              f"version's")
        pairs[name] = got[0].size
    hot = int(np.count_nonzero(hot_l == 123_456)) * int(
        np.count_nonzero(hot_r == 123_456))
    check(pairs["skewed"] >= hot > (JOIN_HOT_SHARE * n) ** 2 / 2,
          f"join phase: skewed pairs {pairs['skewed']}, hot key {hot}")
    numbers = {}
    runs = 10
    for name in ("uniform", "skewed"):
        a, b = cases[name]
        tl, tr = (torch.from_numpy(x).to(device) for x in (a, b))
        ro, lo, counts = jk.spans(tl, tr)
        n_t = counts.sum()
        m = int(n_t)
        cap = jk.quantize_pow2(m)
        li, ri = jk.expand(ro, lo, counts, n_t, cap)
        count_ms = cuda_time_ms(lambda: jk.spans(tl, tr)[2].sum(), runs)
        emit_ms = cuda_time_ms(lambda: jk.expand(ro, lo, counts, n_t, cap),
                               runs)
        down_ms = cuda_time_ms(lambda: torch.stack((li[:m], ri[:m])).cpu(),
                               runs)
        wall_ms = host_ms(lambda: jk.device_join_pairs(a, b, device))
        plain_ms = host_ms(lambda: jk.device_join_pairs(a, b, "cpu"), runs=2)
        prev = os.environ.pop("FLINK_TPU_DEVICE_JOIN", None)
        try:
            host_lane_ms = host_ms(lambda: joins._join_pairs(a, b), runs=1)
        finally:
            if prev is not None:
                os.environ["FLINK_TPU_DEVICE_JOIN"] = prev
        # compulsory bytes: both key columns in once, both int32 index
        # columns out once (the count is 8 bytes); no arithmetic bound
        bytes_ = a.nbytes + b.nbytes + 8 * m + 8
        bound_ms, bound_by, _, _ = bound(bytes_, 0)
        kernel_ms = count_ms + emit_ms
        numbers[name] = dict(pairs=m, count_ms=count_ms, emit_ms=emit_ms,
                             download_ms=down_ms, wall_ms=wall_ms,
                             plain_ms=plain_ms, host_lane_ms=host_lane_ms,
                             bound_ms=bound_ms)
        print(f"join phase {name}: {a.size} x {b.size} keys -> {m} pairs; "
              f"card count {count_ms:.4f} ms + emit {emit_ms:.4f} ms = "
              f"{kernel_ms:.4f} ms, download {down_ms:.4f} ms (CUDA events, "
              f"median of {runs}); device_join_pairs wall {wall_ms:.3f} ms "
              f"(host clock, upload and both syncs in); plain version "
              f"{plain_ms:.3f} ms, host lane numpy _join_pairs "
              f"{host_lane_ms:.3f} ms (host clock); bound {bound_ms:.4f} ms "
              f"by {bound_by} ({bytes_} B: keys in, pairs out, once) = "
              f"{100 * bound_ms / kernel_ms:.2f}% of count + emit; no "
              f"library call computes an equi-join")
    print(f"join phase checks: {', '.join(f'{k} {v} pairs' for k, v in pairs.items())}"
          f"; each equals the plain version on CPU copies exactly, in "
          f"order and dtype (int64)")
    return numbers


def table_batches(batches, seed):
    """The joins' two sides: ``batches`` (seed 7) and a seed-``seed``
    stream of the same shape, each with its stream position in ``e``."""
    right = make_batches(TABLE_BATCHES * BATCH, N_KEYS, BATCH, WINDOW_MS,
                         seed=seed)

    def with_e(side):
        out, base = [], 0
        for k, v, ts in side:
            out.append(({"k": k, "v": v,
                         "e": base + np.arange(k.size, dtype=np.int64)}, ts))
            base += k.size
        return out
    return with_e(batches[:TABLE_BATCHES]), with_e(right)


def table_op(device, label):
    from flink_tpu_torch.operators.joins import IntervalJoinOperator
    from flink_tpu_torch.operators.sql_ops import (ChangelogGroupAggOperator,
                                                   StreamingJoinOperator)
    if label == "path 28":
        return ChangelogGroupAggOperator("k", TABLE_AGGS, device=device)
    if label == "path 29":
        return ChangelogGroupAggOperator("n", {"keys": (None, "count")},
                                         consume_retractions=True,
                                         device=device)
    if label == "path 30":
        return IntervalJoinOperator("k", "k", JOIN_LOWER_MS, JOIN_UPPER_MS,
                                    device=device)
    cols = ["k", "v", "e"]
    return StreamingJoinOperator("k", "k", "inner",
                                 {c: "r_" + c for c in cols},
                                 left_columns=cols, right_columns=cols,
                                 device=device)


def table_drive(op, label, inputs, device, start=0, stop=None,
                snap_after=None, prof=None, wall_ms=None):
    """Feed calls ``start:stop`` of ``inputs`` (:func:`table_call`).
    Returns (outputs per call, the snapshot after ``snap_after`` calls,
    seconds without the snapshot).  ``prof`` (a profiler) wraps every
    call; ``wall_ms`` collects each call's host wall."""
    stop = len(inputs) if stop is None else stop
    outs, snap, snap_s = [], None, 0.0
    t0 = time.perf_counter()
    with prof if prof is not None else contextlib.nullcontext():
        for i in range(start, stop):
            outs.append((i, table_call(op, label, inputs, i, device,
                                       wall_ms)))
            if snap_after is not None and i == snap_after - 1:
                s0 = time.perf_counter()
                snap = op.snapshot_state()
                snap_s = time.perf_counter() - s0
    return outs, snap, time.perf_counter() - t0 - snap_s


def table_call(op, label, inputs, i, device, wall_ms):
    """Call ``i``: paths 28 and 29 get a batch; the joins get their left
    and right batch ``i``, and the interval join a watermark at their
    largest timestamp (``end_input`` after the last).  Returns its
    outputs, the card synchronized."""
    import torch

    from flink_tpu_torch.core.batch import RecordBatch, Watermark

    c0 = time.perf_counter()
    if label in ("path 28", "path 29"):
        out = op.process_batch(RecordBatch(inputs[i]))
    else:
        (lc, lts), (rc, rts) = inputs[i]
        out = op.process_batch2(RecordBatch(lc, timestamps=lts), 0)
        out += op.process_batch2(RecordBatch(rc, timestamps=rts), 1)
        if label == "path 30":
            out += op.process_watermark(
                Watermark(int(max(lts.max(), rts.max()))))
            if i == len(inputs) - 1:
                out += op.end_input()
    if device.type == "cuda":
        torch.cuda.synchronize()
    if wall_ms is not None:
        wall_ms.append((time.perf_counter() - c0) * 1e3)
    return out


def changelog_model_check(outs, batches, label):
    """Path 28 against an independent numpy model, batch by batch: each
    batch emits every key it touched, ``+I`` for a key seen first, else a
    ``-U`` of its values before the batch then a ``+U`` of its values
    after; counts, min and max equal the model's exactly
    (``np.add.at``/``np.minimum.at``/``np.maximum.at``), each sum the
    model's f64 sum of the per-batch f32 row-order partials to
    ``DS_STEP_RTOL`` a batch, and each ``-U`` sum the value last emitted.
    Returns (the model's final counts, the largest relative sum error)."""
    cnt = np.zeros(N_KEYS, np.int64)
    mn = np.full(N_KEYS, np.inf, np.float32)
    mx = np.full(N_KEYS, -np.inf, np.float32)
    tot = np.zeros(N_KEYS, np.float64)
    emitted = np.zeros(N_KEYS, np.float64)
    worst = 0.0
    for b, (keys, vals, _ts) in enumerate(batches):
        out = outs[b][1]
        check(len(out) == 1, f"{label}: batch {b} emitted {len(out)} batches")
        rows = out[0]
        op_, k = rows.column("op"), rows.column("k")
        uk = np.unique(keys)
        seen = cnt[uk] > 0
        old = op_ == "-U"
        check(np.array_equal(np.sort(k[op_ == "+I"]), uk[~seen])
              and np.array_equal(np.sort(k[old]), uk[seen])
              and np.array_equal(k[op_ == "+U"], k[old])
              and np.array_equal(op_[np.flatnonzero(old) + 1],
                                 np.full(old.sum(), "+U"))
              and (op_ == "+I").sum() + 2 * old.sum() == k.size,
              f"{label}: batch {b} emits other keys than it touched")
        ko = k[old]
        check(np.array_equal(rows.column("n")[old], cnt[ko])
              and np.array_equal(rows.column("mn")[old], mn[ko])
              and np.array_equal(rows.column("mx")[old], mx[ko])
              and np.array_equal(rows.column("s")[old], emitted[ko]),
              f"{label}: batch {b}'s -U rows differ from the model before it")
        part = np.zeros(N_KEYS, np.float32)
        np.add.at(part, keys, vals)
        np.add.at(cnt, keys, 1)
        np.minimum.at(mn, keys, vals)
        np.maximum.at(mx, keys, vals)
        tot[uk] += part[uk]
        kn = k[~old]
        check(np.array_equal(rows.column("n")[~old], cnt[kn])
              and np.array_equal(rows.column("mn")[~old], mn[kn])
              and np.array_equal(rows.column("mx")[~old], mx[kn]),
              f"{label}: batch {b}'s counts, min or max differ from the "
              f"model")
        got = rows.column("s")[~old]
        err = np.abs(got - tot[kn])
        check(bool(np.all(err <= (b + 1) * DS_STEP_RTOL * np.abs(tot[kn]))),
              f"{label}: batch {b}'s sums are off the model's by more than "
              f"{(b + 1) * DS_STEP_RTOL} relative")
        nz = tot[kn] != 0
        if nz.any():
            worst = max(worst, float((err[nz] / np.abs(tot[kn][nz])).max()))
        emitted[kn] = got
    return cnt, worst


def profiled_busy(prof, wall_ms):
    from torch.autograd import DeviceType
    busy_ms, dev = device_busy_ms(prof)
    n_ops = sum(e.count for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and e.self_device_time_total > 0)
    return busy_ms, busy_ms / wall_ms, n_ops, dev[:5]


def slice14_path(device, label, inputs, ctx):
    """Drive one path of slice 14 on the card with every launch count at 0
    just before and read just after; hold it to its CPU twin, its model or
    its other lane, and a replay of its mid-run snapshot; print its
    numbers.  Returns (launches, numbers)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from flink_tpu_torch.ops import join_kernels as jk

    join = label in ("path 30", "path 31")
    snap_at = (STREAMING_SNAPSHOT_AFTER if label == "path 31"
               else TABLE_SNAPSHOT_AFTER)
    prev_env = os.environ.get("FLINK_TPU_DEVICE_JOIN")
    os.environ["FLINK_TPU_DEVICE_JOIN"] = "1"
    try:
        op = table_op(device, label)
        jk.transfer_bytes.update(h2d=0, d2h=0)
        wall_ms = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        reset_launches()
        outs, snap, elapsed = table_drive(op, label, inputs, device,
                                          snap_after=snap_at,
                                          wall_ms=wall_ms)
        torch.cuda.synchronize()
        launches = read_launches()
        moved = dict(jk.transfer_bytes)
        peak = torch.cuda.max_memory_allocated() - base
        digests_ = digest_rows(outs)
        # the CPU twin: the same operator and lane on the CPU
        n_cpu = TABLE_CPU_BATCHES if label == "path 28" else len(inputs)
        cpu = torch.device("cpu")
        cpu_outs, _, cpu_s = table_drive(table_op(cpu, label), label,
                                         inputs, cpu, stop=n_cpu)
        cpu_d = digest_rows(cpu_outs)
        check(cpu_d == [d for d in digests_ if d[0] < n_cpu] and cpu_d,
              f"{label}: the card's rows over {n_cpu} calls differ from the "
              f"CPU's in their bits")
        # the replay from the snapshot, under the profiler
        rop = table_op(device, label)
        r0 = time.perf_counter()
        rop.restore_state(snap)
        restore_s = time.perf_counter() - r0
        prof = profile(activities=[ProfilerActivity.CUDA])
        rep, _, replay_s = table_drive(rop, label, inputs, device,
                                       start=snap_at, prof=prof)
        check(digest_rows(rep) == [d for d in digests_ if d[0] >= snap_at]
              and rep, f"{label}: the replay from the snapshot after "
              f"{snap_at} calls differs from the run's rest")
    finally:
        if prev_env is None:
            os.environ.pop("FLINK_TPU_DEVICE_JOIN", None)
        else:
            os.environ["FLINK_TPU_DEVICE_JOIN"] = prev_env
    busy_ms, share, n_ops, top = profiled_busy(prof, replay_s * 1e3)
    check(n_ops > 0, f"{label}: the profiled replay ran nothing on the card")
    n_rows = sum(len(b) for _, out in outs for b in out)
    numbers = {"elapsed_s": elapsed, "busy_share": share, "rows": n_rows}
    what = ""
    if label == "path 28":
        check(launches["scatter_fold"] > 0
              and launches["probe"] == launches["probe_fold"] == 0,
              f"{label}: launches {launches}")
        cnt, worst = changelog_model_check(outs, ctx["batches"], label)
        ctx["counts"] = cnt
        ctx["changelog"] = [b for _, out in outs for b in out]
        st = op.step_stats
        n_in = st["rows"]
        numbers.update(records_per_s=n_in / elapsed,
                       d2h_per_batch=st["d2h_bytes"] / st["steps"],
                       h2d_per_batch=st["h2d_bytes"] / st["steps"])
        what = (f"{n_in} records = {n_in / elapsed:.1f} records/s, "
                f"{n_rows} changelog rows; groups touched "
                f"{st['groups'] / st['steps']:.0f} a batch; h2d "
                f"{numbers['h2d_per_batch']:.0f} B and d2h (the [U] old/new "
                f"words) {numbers['d2h_per_batch']:.0f} B a batch; model: "
                f"counts, min, max exact, sums within {worst:.3e} relative "
                f"(bound {DS_STEP_RTOL:.3e} a batch)")
    elif label == "path 29":
        check(launches["scatter_fold"] > 0
              and launches["probe"] == launches["probe_fold"] == 0,
              f"{label}: launches {launches}")
        final = op.snapshot_state()
        rev = final["key_index"]["reverse"]
        got = final["state"][0].astype(np.float64) + final["state"][1]
        want = np.bincount(ctx["counts"])[rev]
        check(np.array_equal(got, want),
              f"{label}: its final state differs from np.bincount of the "
              f"model's counts")
        st = op.step_stats
        n_in = st["rows"]
        numbers.update(records_per_s=n_in / elapsed,
                       d2h_per_batch=st["d2h_bytes"] / st["steps"])
        what = (f"{n_in} changelog rows in = {n_in / elapsed:.1f} rows/s, "
                f"{n_rows} rows out; {rev.size} distinct counts; final state "
                f"= np.bincount of the model's counts; d2h "
                f"{numbers['d2h_per_batch']:.0f} B a batch")
    else:
        check(all(v == 0 for v in launches.values()),
              f"{label}: launches {launches}; the device join runs no "
              f"hand-written kernel")
        n_in = sum(lc["k"].size + rc["k"].size
                   for (lc, _), (rc, _) in inputs)
        # the host lane: the same pairs as a multiset
        os.environ.pop("FLINK_TPU_DEVICE_JOIN", None)
        try:
            host, _, host_s = table_drive(table_op(device, label), label,
                                          inputs, device)
        finally:
            if prev_env is not None:
                os.environ["FLINK_TPU_DEVICE_JOIN"] = prev_env

        def pairs(o):
            return np.sort(np.concatenate(
                [np.asarray(b.column("e"), np.int64) * (1 << 32)
                 + np.asarray(b.column("r_e"), np.int64)
                 for _, out in o for b in out]))
        card_pairs = pairs(outs)
        HELD[label] = card_pairs
        check(np.array_equal(card_pairs, pairs(host)) and card_pairs.size,
              f"{label}: the device lane's pairs differ from the host "
              f"lane's as a multiset")
        numbers.update(records_per_s=n_in / elapsed,
                       pairs_per_s=card_pairs.size / elapsed,
                       d2h=moved["d2h"], h2d=moved["h2d"],
                       host_lane_s=host_s, cpu_s=cpu_s)
        what = (f"{n_in} input rows = {n_in / elapsed:.1f} rows/s, "
                f"{card_pairs.size} joined pairs = "
                f"{card_pairs.size / elapsed:.1f} pairs/s; the join moved "
                f"h2d {moved['h2d']} B (keys) and d2h {moved['d2h']} B (index "
                f"pairs); the host lane's run {host_s:.3f} s gives the same "
                f"pairs as a multiset, the device lane on the CPU "
                f"{cpu_s:.3f} s the same rows in order")
    p50 = float(np.percentile(wall_ms, 50))
    p99 = float(np.percentile(wall_ms, 99))
    print(f"{label}: {elapsed:.3f} s; {what}; launches {launches}; peak "
          f"device memory {peak} B over what was allocated before it")
    print(f"{label} calls: host wall p50 {p50:.3f} ms p99 {p99:.3f} ms over "
          f"{len(wall_ms)}; the CPU twin over {n_cpu} calls bit for bit; the "
          f"snapshot after {snap_at} calls restored ({restore_s * 1e3:.3f} "
          f"ms) and replayed bit for bit")
    n_rep = len(inputs) - snap_at
    print(f"{label} profiled replay ({n_rep} calls): wall "
          f"{replay_s * 1e3:.3f} ms, device busy {busy_ms:.3f} ms = "
          f"{100 * share:.2f}% (idle {100 - 100 * share:.2f}%), "
          f"{n_ops / n_rep:.1f} device ops a call; top (ms): "
          + "; ".join(f"{k[:40]} {t / 1e3:.3f}" for t, k in top))
    print(f"{label} card: {ctx['card']}")
    return launches, numbers


def slice14(device, batches, card):
    """Paths 28-31 over the stream's first ``TABLE_BATCHES`` batches (and
    a seed-``RIGHT_SEED`` right side for the joins)."""
    left, right = table_batches(batches, RIGHT_SEED)
    ctx = {"batches": batches[:TABLE_BATCHES], "card": card}
    launches, numbers = {}, {}
    agg_in = [cols for cols, _ in left]
    t1 = time.perf_counter()
    launches["path 28"], numbers["path 28"] = slice14_path(
        device, "path 28", [{"k": c["k"], "v": c["v"]} for c in agg_in], ctx)
    print(f"path 28 took {time.perf_counter() - t1:.1f} s of command time")
    level2 = [{"op": b.column("op"),
               "n": np.asarray(b.column("n")).astype(np.int64)}
              for b in ctx.pop("changelog")]
    t1 = time.perf_counter()
    launches["path 29"], numbers["path 29"] = slice14_path(
        device, "path 29", level2, ctx)
    print(f"path 29 took {time.perf_counter() - t1:.1f} s of command time")
    del level2
    pairs = list(zip(left, right))
    halves = [tuple(({c: a[:STREAMING_ROWS] for c, a in cols.items()},
                     ts[:STREAMING_ROWS]) for cols, ts in pair)
              for pair in pairs[:STREAMING_BATCHES]]
    for label, inputs in (("path 30", pairs), ("path 31", halves)):
        t1 = time.perf_counter()
        launches[label], numbers[label] = slice14_path(device, label, inputs,
                                                       ctx)
        print(f"{label} took {time.perf_counter() - t1:.1f} s of command "
              f"time")
    return launches, numbers


SLICE15 = ("path 32", "path 33", "path 34", "path 35", "path 36")
#: the Graph500 Kronecker (R-MAT) graph: scale, edge factor, initiator
GRAPH_SCALE = 22
GRAPH_EDGE_FACTOR = 16
RMAT_ABC = (0.57, 0.19, 0.19)   # D = 0.05
GRAPH_SEED = 15
PAGERANK_ITERS = 10             # Graphalytics' PR iterations
DAMPING = 0.85
BFS_ROOTS = 1                   # two before slice 22 (its time)
DENSE_SCALE = 12                # path 35: _DENSE_LIMIT vertices
DENSE_CPU_SCALE = 10            # path 35's CPU twin
HITS_ITERS = 20
LABEL_ITERS = 10
#: f32 PageRank against the f64 model (10 supersteps of f32 sums)
PAGERANK_RTOL = 1e-4
#: f32 Bellman-Ford against f64 Dijkstra (paths of a few dozen f32 adds)
SSSP_RTOL = 1e-5
#: the dense family's f32 scores: Adamic-Adar against the f64 product,
#: HITS (unit vectors) absolute against the f64 power iteration
SCORE_RTOL = 1e-5
HITS_ATOL = 1e-5
PROCESS_BATCHES = 16
PROCESS_SNAPSHOT_AFTER = 8
#: path 36's composite key: window index << KEY_BITS | key
KEY_BITS = 20


def rmat_edges(scale, edge_factor, seed, device):
    """Graph500's Kronecker generator on ``device``: ``edge_factor <<
    scale`` directed edges, each of ``scale`` bits drawn from the
    initiator (A, B, C, D), vertex labels permuted from the seed, self
    loops and duplicates kept; SSSP weights uniform in [0, 1) (Graph500
    kernel 3).  Returns int32 ``src``, ``dst`` and f32 ``w`` tensors."""
    import torch
    a, b, c = RMAT_ABC
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    m = edge_factor << scale
    src = torch.zeros(m, dtype=torch.int64, device=device)
    dst = torch.zeros(m, dtype=torch.int64, device=device)
    for bit in range(scale):
        r = torch.rand(m, generator=g, device=device)
        src |= (r >= a + b).to(torch.int64) << bit
        dst |= (((r >= a) & (r < a + b)) | (r >= a + b + c)).to(
            torch.int64) << bit
    perm = torch.randperm(1 << scale, generator=g, device=device)
    w = torch.rand(m, generator=g, device=device)
    return perm[src].to(torch.int32), perm[dst].to(torch.int32), w


def graph_roots(src_h, dst_h, n, k, seed):
    """``k`` distinct roots of non-zero degree, drawn from the seed
    (Graph500 skips zero-degree roots)."""
    deg = np.bincount(src_h, minlength=n) + np.bincount(dst_h, minlength=n)
    rng = np.random.default_rng(seed)
    return [int(r) for r in rng.choice(np.flatnonzero(deg), k,
                                       replace=False)]


def pagerank_model(src_h, dst_h, n):
    """Independent PageRank: scipy.sparse f64 power iteration with the
    dangling mass spread over every vertex (JAX's formula)."""
    import scipy.sparse as sp
    at = sp.coo_matrix((np.ones(src_h.size), (dst_h, src_h)),
                       shape=(n, n)).tocsr()           # counts duplicates
    deg = np.bincount(src_h, minlength=n).astype(np.float64)
    dangling = deg == 0
    safe = np.where(dangling, 1.0, deg)
    r = np.full(n, 1.0 / n)
    for _ in range(PAGERANK_ITERS):
        r = (1 - DAMPING) / n + DAMPING * (at @ (r / safe)
                                           + r[dangling].sum() / n)
    return r, at


def bfs_levels_model(adj, root, n):
    """Hop levels from ``root`` over the undirected graph (scipy's BFS
    order and predecessors, depths by pointer jumping); -1 unreachable."""
    from scipy.sparse import csgraph
    order, pred = csgraph.breadth_first_order(adj, root, directed=False,
                                              return_predecessors=True)
    idx = np.arange(n)
    anc = np.where(pred >= 0, pred, idx)
    depth = (pred >= 0).astype(np.int64)
    while (anc != anc[anc]).any() or (depth[anc] > 0).any():
        depth = depth + depth[anc]
        anc = anc[anc]
    out = np.full(n, -1, np.int64)
    out[order] = depth[order]
    return out


def wcc_model(adj, n):
    """Weakly connected components, each labelled by its least vertex id."""
    from scipy.sparse import csgraph
    nc, lab = csgraph.connected_components(adj, directed=True,
                                           connection="weak")
    least = np.full(nc, n, np.int64)
    np.minimum.at(least, lab, np.arange(n))
    return least[lab]


def sssp_model(src_t, dst_t, w_t, n, root):
    """f64 Dijkstra (scipy) over the directed weighted edges, duplicates
    reduced to their least weight first (a stable sort by (src, dst) after
    one by weight, on the card), a weight of exactly 0 stored as the
    smallest positive f64 (scipy reads a stored 0 as no edge)."""
    import scipy.sparse as sp
    import torch
    from scipy.sparse import csgraph
    key = src_t.to(torch.int64) * n + dst_t.to(torch.int64)
    o1 = torch.argsort(w_t)
    o2 = torch.argsort(key[o1], stable=True)
    order = o1[o2]
    ks = key[order]
    first = torch.ones_like(ks, dtype=torch.bool)
    first[1:] = ks[1:] != ks[:-1]
    sel = order[first]
    s, d = src_t[sel].cpu().numpy(), dst_t[sel].cpu().numpy()
    w = w_t[sel].cpu().numpy().astype(np.float64)
    w[w == 0] = np.finfo(np.float64).tiny
    del key, o1, o2, order, ks, first, sel
    mat = sp.coo_matrix((w, (s, d)), shape=(n, n)).tocsr()
    return csgraph.dijkstra(mat, directed=True, indices=root)


class _Supersteps:
    """Counts and times the converged check (``graph._equal``, one host
    sync a superstep): the supersteps an algorithm ran and the host
    seconds it waited in them."""

    def __init__(self):
        from flink_tpu_torch.graph_lib import graph as gmod
        self.mod, self.orig = gmod, gmod._equal
        self.calls, self.seconds = 0, 0.0

    def __enter__(self):
        def timed(a, b):
            t0 = time.perf_counter()
            out = self.orig(a, b)
            self.seconds += time.perf_counter() - t0
            self.calls += 1
            return out
        self.mod._equal = timed
        return self

    def __exit__(self, *exc):
        self.mod._equal = self.orig


def graph_kernel_check(device, g, ranks0):
    """``segment_combine("sum")`` at path 32's shapes (PageRank's first
    superstep: E f32 messages into n vertices) against its plain version
    on CPU copies, bit for bit; ``scatter_fold`` timed beside
    ``index_add_`` and the bound."""
    import torch

    from flink_tpu_torch.graph_lib.graph import segment_combine
    from flink_tpu_torch.ops.scatter import ordered_fold
    n, E = g.n, g.num_edges
    deg = torch.from_numpy(g.out_degrees().astype(np.float32)).to(device)
    msgs = (ranks0 / torch.where(deg == 0, 1.0, deg))[g.src]
    got = segment_combine(msgs, g.dst, n, "sum")
    t0 = time.perf_counter()
    want = segment_combine(msgs.cpu(), g.dst.cpu(), n, "sum")
    plain_s = time.perf_counter() - t0
    err = float((got.cpu() - want).abs().max())
    check(torch.equal(got.cpu().view(torch.int32), want.view(torch.int32)),
          f"path 32: the sum combine of {E} messages into {n} vertices on "
          f"the card differs from its CPU plain version in its bits (max "
          f"abs {err})")
    plane = torch.zeros(n, dtype=torch.float32, device=device)
    ms = cuda_time_ms(lambda: ordered_fold(plane, g.dst, msgs), 5)
    lib = torch.zeros(n, dtype=torch.float32, device=device)
    lib_ms = cuda_time_ms(lambda: lib.index_add_(0, g.dst, msgs), 5)
    # each input read once (ids, values, the plane), the plane written once
    bytes_ = 8 * E + 8 * n
    bms, by, _, _ = bound(bytes_, E)
    out = {"rows": E, "cells": n, "ms": ms, "library_ms": lib_ms,
           "plain_cpu_ms": plain_s * 1e3, "bound_ms": bms, "bound_by": by,
           "max_abs_err": err}
    print(f"path 32 kernel: sum combine of {E} f32 messages into {n} "
          f"vertices equals its CPU plain version bit for bit; "
          f"scatter_fold {ms:.4f} ms (CUDA events, median of 5), "
          f"index_add_ {lib_ms:.4f} ms ({ms / lib_ms:.3f}x), bound "
          f"{bms:.4f} ms ({bytes_} B, by {by}), the CPU plain version "
          f"{plain_s * 1e3:.1f} ms on the host")
    del msgs, got, want, plane, lib
    return out


def path32(device, card, G):
    """PageRank (10 supersteps, damping 0.85, tol 0) on the directed
    scale-22 graph."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from flink_tpu_torch.graph_lib import Graph
    g = G["g"]
    n, E = g.n, g.num_edges
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    reset_launches()
    t0 = time.perf_counter()
    ranks = g.pagerank(damping=DAMPING, num_iterations=PAGERANK_ITERS)
    wall = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated() - base
    check(launches["scatter_fold_plane"] == PAGERANK_ITERS + 1
          and launches["probe"] == launches["probe_fold"] == 0,
          f"path 32: launches {launches}; want one scatter_fold a superstep "
          f"and one for the degrees")
    t0 = time.perf_counter()
    model, at = pagerank_model(G["src_h"], G["dst_h"], n)
    model_s = time.perf_counter() - t0
    G["at"] = at
    rel = float(np.max(np.abs(ranks - model)) / np.max(model))
    check(ranks.dtype == np.float32 and np.isfinite(ranks).all()
          and np.allclose(ranks, model, rtol=PAGERANK_RTOL,
                          atol=PAGERANK_RTOL / n)
          and abs(float(ranks.astype(np.float64).sum()) - 1.0) < 1e-4,
          f"path 32: PageRank differs from the f64 model (max abs "
          f"{np.max(np.abs(ranks - model))}, sum {ranks.sum()})")
    # CUDA-event time a superstep: the same supersteps through
    # scatter_gather, an event recorded at each (no sync in the loop)
    deg = g.out_degrees().astype(np.float32)
    dangling = torch.from_numpy(deg == 0).to(device)
    safe = np.where(deg == 0, np.float32(1), deg)
    gw = Graph(n, g.src, g.dst, (1.0 / safe)[G["src_h"]], device=device)
    events = [torch.cuda.Event(enable_timing=True)]

    def update(r, spread):
        dm = torch.sum(torch.where(dangling, r, 0.0))
        return (1.0 - DAMPING) / n + DAMPING * (spread + dm / n)

    def mark(_a, _b):
        events.append(torch.cuda.Event(enable_timing=True))
        events[-1].record()
        return False

    r0 = np.full(n, 1.0 / n, np.float32)
    events[0].record()
    timed = gw.scatter_gather(r0, lambda v, w: v * w, "sum", update,
                              PAGERANK_ITERS, converged=mark)
    torch.cuda.synchronize()
    step_ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    check(np.allclose(timed, model, rtol=PAGERANK_RTOL,
                      atol=PAGERANK_RTOL / n),
          "path 32: the timed scatter_gather run differs from the model")
    G["kernel"] = graph_kernel_check(device, g, torch.full(
        (n,), 1.0 / n, dtype=torch.float32, device=device))
    prof = profile(activities=[ProfilerActivity.CUDA])
    with prof:
        t1 = time.perf_counter()
        again = g.pagerank(damping=DAMPING, num_iterations=PAGERANK_ITERS)
        torch.cuda.synchronize()
        pwall = time.perf_counter() - t1
    check(np.array_equal(again, ranks), "path 32: a second run differs from "
          "the first in its bits")
    busy_ms, share, n_ops, top = profiled_busy(prof, pwall * 1e3)
    p50, p99 = np.percentile(step_ms, 50), np.percentile(step_ms, 99)
    teps = E * PAGERANK_ITERS / wall
    print(f"path 32: PageRank of the scale-{GRAPH_SCALE} Kronecker graph "
          f"({n} vertices, {E} edges), {PAGERANK_ITERS} supersteps in "
          f"{wall:.3f} s wall = {teps:.4e} edges traversed/s; superstep "
          f"(CUDA events) p50 {p50:.3f} ms p99 {p99:.3f} ms; launches "
          f"{launches}; peak device memory {peak} B over what was allocated "
          f"before it; held to the scipy f64 model within rtol "
          f"{PAGERANK_RTOL} (max abs / max {rel:.3e}; model {model_s:.1f} s "
          f"on the host), ranks sum to {ranks.astype(np.float64).sum():.7f}")
    print(f"path 32 profiled run: wall {pwall * 1e3:.3f} ms, device busy "
          f"{busy_ms:.3f} ms = {100 * share:.2f}% (idle "
          f"{100 - 100 * share:.2f}%), {n_ops} device ops; top (ms): "
          + "; ".join(f"{k[:40]} {t / 1e3:.3f}" for t, k in top))
    print(f"path 32 card: {card}")
    G["ranks"] = ranks
    return launches, {"wall_s": wall, "edges_per_s": teps,
                      "step_p50_ms": p50, "step_p99_ms": p99,
                      "busy_share": share, "peak_bytes": peak,
                      "kernel": G.pop("kernel")}


def _timed(fn, label, wall_of):
    import torch
    torch.cuda.synchronize()
    with _Supersteps() as ss:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    wall_of[label] = (wall, ss.calls, ss.seconds)
    return out


def path33(device, card, G):
    """BFS from ``BFS_ROOTS`` roots, WCC, and SSSP from the first root, on
    the same graph taken undirected (as Graph500 kernels 2 and 3 search
    it)."""
    import torch
    g = G["g"]
    n, E = g.n, g.num_edges
    roots = graph_roots(G["src_h"], G["dst_h"], n, BFS_ROOTS, GRAPH_SEED)
    walls = {}
    reset_launches()
    levels = [_timed(lambda r=r: g.bfs_levels(r), f"bfs {r}", walls)
              for r in roots]
    comps = _timed(g.connected_components, "wcc", walls)
    # Graph500 kernel 3 searches the undirected graph
    ug = g.undirected()
    dist = _timed(lambda: ug.sssp(roots[0]), "sssp", walls)
    launches = read_launches()
    check(all(v == 0 for v in launches.values()),
          f"path 33: launches {launches}; min combines launch no "
          f"hand-written kernel")
    t0 = time.perf_counter()
    at = G.pop("at")
    for r, lv in zip(roots, levels):
        want = bfs_levels_model(at, r, n)
        check(lv.dtype == np.int32 and np.array_equal(lv, want),
              f"path 33: BFS levels from {r} differ from scipy's BFS "
              f"({int((lv != want).sum())} vertices)")
    want = wcc_model(at, n)
    check(comps.dtype == np.int32 and np.array_equal(comps, want),
          f"path 33: component labels differ from scipy's weak components "
          f"({int((comps != want).sum())} vertices)")
    del at
    sp_model = sssp_model(ug.src, ug.dst, ug.weights, n, roots[0])
    del ug
    reach = np.isfinite(sp_model)
    check(np.array_equal(np.isfinite(dist), reach)
          and np.allclose(dist[reach], sp_model[reach], rtol=SSSP_RTOL,
                          atol=0),
          f"path 33: SSSP differs from scipy's f64 Dijkstra (max rel "
          f"{np.max(np.abs(dist[reach] - sp_model[reach]) / np.maximum(sp_model[reach], 1e-30))})")
    model_s = time.perf_counter() - t0
    numbers = {}
    for label, (wall, steps, sync) in walls.items():
        edges = 2 * E
        numbers[label] = {"wall_s": wall, "supersteps": steps,
                          "edges_per_s": edges * steps / wall,
                          "sync_share": sync / wall}
        print(f"path 33 {label}: {steps} supersteps in {wall:.3f} s = "
              f"{edges * steps / wall:.4e} edges traversed/s ({edges} edges "
              f"a superstep); the converged check's host wait {sync:.3f} s "
              f"= {100 * sync / wall:.1f}% of the wall")
    ncomp = np.unique(comps).size
    print(f"path 33: roots {roots}; {ncomp} components (largest "
          f"{np.bincount(np.unique(comps, return_inverse=True)[1]).max()}); "
          f"BFS reach {[int((lv >= 0).sum()) for lv in levels]}, depth "
          f"{[int(lv.max()) for lv in levels]}; SSSP reach {int(reach.sum())}"
          f"; BFS and WCC equal scipy exactly, SSSP within rtol {SSSP_RTOL}"
          f"; models {model_s:.1f} s on the host; launches {launches}")
    print(f"path 33 card: {card}")
    G["roots"], G["levels"] = roots, levels
    return launches, numbers


def path34(device, card, G):
    """Paths 32's PageRank and 33's BFS over four edge shards on the one
    card, each against its single-device twin in turns."""
    import torch

    from flink_tpu_torch.parallel.mesh import make_mesh
    g = G["g"]
    mesh = make_mesh(devices=[device] * MESH_BLOCKS)
    root = G["roots"][0]
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ranks = g.pagerank(damping=DAMPING, num_iterations=PAGERANK_ITERS,
                       mesh=mesh)
    levels = g.bfs_levels(root, mesh=mesh)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    check(launches["scatter_fold_plane"] == MESH_BLOCKS * PAGERANK_ITERS + 1,
          f"path 34: launches {launches}; want one scatter_fold a shard a "
          f"superstep and one for the degrees")
    check(np.array_equal(levels, G["levels"][0]),
          "path 34: the mesh's BFS levels differ from path 33's")
    rel = float(np.max(np.abs(ranks - G["ranks"])) / np.max(G["ranks"]))
    check(np.allclose(ranks, G["ranks"], rtol=PAGERANK_RTOL,
                      atol=PAGERANK_RTOL / g.n),
          f"path 34: the mesh's PageRank differs from path 32's ({rel:.3e})")
    turns = {}
    for label, run in (
            ("pagerank", lambda m: g.pagerank(
                damping=DAMPING, num_iterations=PAGERANK_ITERS, mesh=m)),
            ("bfs", lambda m: g.bfs_levels(root, mesh=m))):
        t = {"twin": [], "mesh": []}
        for who in ("twin", "mesh", "mesh", "twin"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(mesh if who == "mesh" else None)
            torch.cuda.synchronize()
            t[who].append(time.perf_counter() - t0)
        turns[label] = t
        a, b = np.mean(t["mesh"]), np.mean(t["twin"])
        print(f"A/B path 34 {label} ({MESH_BLOCKS} edge shards on the card) "
              f"vs its single-device twin, turns twin, mesh, mesh, twin: "
              f"{a * 1e3:.3f} vs {b * 1e3:.3f} ms ({b / a:.3f}x the twin's "
              f"rate)")
    print(f"path 34: PageRank + BFS on the mesh in {wall:.3f} s; BFS equals "
          f"path 33's exactly, PageRank path 32's within rtol "
          f"{PAGERANK_RTOL} (max abs / max {rel:.3e}); launches {launches}")
    print(f"path 34 card: {card}")
    return launches, {"wall_s": wall, "turns": turns}


def dense_models(src_h, dst_h, n):
    """Independent models of the dense family: all-pairs hop distances
    (scipy BFS from every vertex), Jaccard and Adamic-Adar (scipy.sparse
    products of the 0/1 adjacency), HITS (f64 power iteration) and label
    propagation (numpy)."""
    import scipy.sparse as sp
    from scipy.sparse import csgraph
    keep = src_h != dst_h
    a = sp.coo_matrix((np.ones(int(keep.sum())), (src_h[keep], dst_h[keep])),
                      shape=(n, n)).tocsr()
    a = ((a + a.T) > 0).astype(np.float64)            # symmetric 0/1
    d = csgraph.shortest_path(a, method="D", directed=False,
                              unweighted=True)
    dist = np.where(np.isfinite(d), d, -1).astype(np.int32)
    deg = np.asarray(a.sum(axis=1)).ravel()
    common = np.asarray((a @ a.T)[src_h, dst_h]).ravel()
    union = (deg[src_h] + deg[dst_h] - common).astype(np.float32)
    common32 = common.astype(np.float32)
    jac = np.where(union > 0, common32 / np.maximum(union, np.float32(1)),
                   np.float32(0))
    inv_log = np.where(deg > 1, 1.0 / np.log(np.maximum(deg, 2.0)), 0.0)
    aa = np.asarray((a @ sp.diags(inv_log) @ a.T)[src_h, dst_h]).ravel()
    cnt = sp.coo_matrix((np.ones(src_h.size), (src_h, dst_h)),
                        shape=(n, n)).tocsr()
    hub = np.full(n, 1 / np.sqrt(n))
    for _ in range(HITS_ITERS):
        auth = cnt.T @ hub
        auth /= max(np.linalg.norm(auth), 1e-12)
        hub = cnt @ auth
        hub /= max(np.linalg.norm(hub), 1e-12)
    return {"dist": dist, "jaccard": jac, "adamic_adar": aa, "hub": hub,
            "auth": auth, "deg_nl": np.bincount(src_h[keep], minlength=n)
            + np.bincount(dst_h[keep], minlength=n)}


def label_model(src_h, dst_h, labels):
    """Max-label adoption over the undirected edges (numpy), to a fixed
    point or ``LABEL_ITERS`` rounds."""
    s = np.concatenate([src_h, dst_h])
    d = np.concatenate([dst_h, src_h])
    lab = labels.astype(np.int64)
    low = np.iinfo(np.int32).min
    for _ in range(LABEL_ITERS):
        comb = np.full(lab.size, low, np.int64)
        np.maximum.at(comb, d, lab[s])
        new = np.where(comb > low, np.maximum(lab, comb), lab)
        if np.array_equal(new, lab):
            break
        lab = new
    return lab.astype(np.int32)


def path35(device, card):
    """The dense analysis family on a scale-12 graph of the same
    generator, and the CPU twin at scale 10."""
    import torch

    from flink_tpu_torch.graph_lib import Graph
    src, dst, _ = rmat_edges(DENSE_SCALE, GRAPH_EDGE_FACTOR, GRAPH_SEED,
                             device)
    n = 1 << DENSE_SCALE
    src_h, dst_h = src.cpu().numpy().copy(), dst.cpu().numpy().copy()
    g = Graph(n, src, dst, device=device)
    labels = np.random.default_rng(GRAPH_SEED).permutation(n)
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    times = {}

    def run(label, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times[label] = time.perf_counter() - t
        return out

    dist = run("all_pairs", g.all_pairs_distances)
    ecc = g.eccentricity(distances=dist)
    close_c = g.closeness_centrality(distances=dist)
    dr = g.diameter_radius(distances=dist)
    jac = run("jaccard", g.jaccard_similarity)
    aa = run("adamic_adar", g.adamic_adar)
    hub, auth = run("hits", lambda: g.hits(HITS_ITERS))
    lab = run("label_propagation",
              lambda: g.label_propagation(labels, LABEL_ITERS))
    wall = time.perf_counter() - t0
    launches = read_launches()
    check(launches["scatter_fold_plane"] == 2 * HITS_ITERS,
          f"path 35: launches {launches}; want two scatter_fold a HITS "
          f"superstep")
    t1 = time.perf_counter()
    m = dense_models(src_h, dst_h, n)
    check(np.array_equal(dist, m["dist"]),
          f"path 35: all-pairs distances differ from scipy's "
          f"({int((dist != m['dist']).sum())} pairs)")
    want_ecc = np.where(m["dist"] >= 0, m["dist"], 0).max(axis=1)
    check(np.array_equal(ecc, want_ecc.astype(np.int32)),
          "path 35: eccentricity differs from the model's")
    live = want_ecc[m["deg_nl"] > 0]
    check(dr == {"diameter": int(live.max()), "radius": int(live.min())},
          f"path 35: diameter/radius {dr} differ from the model's")
    reach = (m["dist"] >= 0).sum(axis=1) - 1.0
    dsum = np.where(m["dist"] > 0, m["dist"], 0).sum(axis=1)
    want_c = ((reach / max(n - 1, 1))
              * np.where(dsum > 0, reach / np.maximum(dsum, 1), 0.0))
    check(np.array_equal(close_c, want_c.astype(np.float32)),
          "path 35: closeness differs from the model's")
    check(jac.dtype == np.float32 and np.array_equal(jac, m["jaccard"]),
          f"path 35: Jaccard differs from the scipy model "
          f"({int((jac != m['jaccard']).sum())} edges)")
    check(np.allclose(aa, m["adamic_adar"], rtol=SCORE_RTOL, atol=1e-6),
          f"path 35: Adamic-Adar differs from the f64 product (max abs "
          f"{np.max(np.abs(aa - m['adamic_adar']))})")
    herr = max(float(np.max(np.abs(hub - m["hub"]))),
               float(np.max(np.abs(auth - m["auth"]))))
    check(herr <= HITS_ATOL, f"path 35: HITS differs from the f64 power "
          f"iteration by {herr}")
    check(np.array_equal(lab, label_model(src_h, dst_h, labels)),
          "path 35: label propagation differs from the numpy model")
    model_s = time.perf_counter() - t1
    # the CPU twin at scale 10: everything whose order is fixed, bit for bit
    cs, cd, _ = rmat_edges(DENSE_CPU_SCALE, GRAPH_EDGE_FACTOR, GRAPH_SEED,
                           device)
    nc = 1 << DENSE_CPU_SCALE
    card_g = Graph(nc, cs, cd, device=device)
    cpu_g = Graph(nc, cs.cpu(), cd.cpu(), device="cpu")
    lab_c = np.random.default_rng(GRAPH_SEED).permutation(nc)
    t2 = time.perf_counter()
    for name, fn in (("all_pairs", lambda x: x.all_pairs_distances()),
                     ("jaccard", lambda x: x.jaccard_similarity()),
                     ("label_propagation",
                      lambda x: x.label_propagation(lab_c, LABEL_ITERS)),
                     ("bfs", lambda x: x.bfs_levels([0, 5]))):
        a, b = fn(card_g), fn(cpu_g)
        check(a.dtype == b.dtype and a.tobytes() == b.tobytes(),
              f"path 35: {name} at scale {DENSE_CPU_SCALE} differs between "
              f"the card and the CPU")
    cpu_s = time.perf_counter() - t2
    print(f"path 35: the dense family on the scale-{DENSE_SCALE} graph ({n} "
          f"vertices, {src.numel()} edges) in {wall:.3f} s: "
          + ", ".join(f"{k} {v * 1e3:.1f} ms" for k, v in times.items())
          + f"; diameter {dr['diameter']} radius {dr['radius']}; distances, "
          f"eccentricity, closeness, Jaccard and labels equal the models "
          f"exactly, Adamic-Adar within rtol {SCORE_RTOL}, HITS within "
          f"{herr:.2e} (bound {HITS_ATOL}); models {model_s:.1f} s on the "
          f"host; the scale-{DENSE_CPU_SCALE} CPU twin bit for bit "
          f"({cpu_s:.1f} s); launches {launches}")
    print(f"path 35 card: {card}")
    return launches, {"wall_s": wall, "times": times}


def process_function():
    """The headline tumbling sum as a ``KeyedProcessFunction``: per key (a
    composite of the window's index and the key, the heap having no
    namespaces, as Flink's window state is namespaced by window) a
    ``SumAggregator`` ``AggregatingState`` and a count ``ValueState``; an
    event-time timer at the window's end emits (key, window, sum, count)
    and clears."""
    from flink_tpu_torch.core.batch import RecordBatch
    from flink_tpu_torch.core.functions import SumAggregator
    from flink_tpu_torch.operators.process import KeyedProcessFunction
    from flink_tpu_torch.state.api import (AggregatingStateDescriptor,
                                           ValueStateDescriptor)

    class WindowSum(KeyedProcessFunction):
        def __init__(self):
            self.sum_d = AggregatingStateDescriptor(
                "sum", SumAggregator(np.float32))
            self.cnt_d = ValueStateDescriptor("count", dtype=np.int64,
                                              default=0)

        def process_batch(self, ctx, batch):
            ctx.state(self.sum_d).add_rows(ctx.slots, batch.column("v"))
            u, first, c = np.unique(ctx.slots, return_index=True,
                                    return_counts=True)
            cnt = ctx.state(self.cnt_d)
            cnt.put_rows(u, cnt.get_rows(u)[0] + c)
            ends = (np.asarray(batch.timestamps)[first] // WINDOW_MS + 1) \
                * WINDOW_MS - 1
            ctx.timer_service.register_event_time_timers(u, ends)
            return None

        def on_timer_batch(self, ctx, slots, timestamps):
            s, _ = ctx.state(self.sum_d).get_rows(slots)
            n, _ = ctx.state(self.cnt_d).get_rows(slots)
            ctx.state(self.sum_d).clear_rows(slots)
            ctx.state(self.cnt_d).clear_rows(slots)
            ck = np.asarray(ctx.keys_of(slots), np.int64)
            return [RecordBatch({
                "k": ck & ((1 << KEY_BITS) - 1),
                "window_start": (ck >> KEY_BITS) * WINDOW_MS,
                "result": s, "count": n}, timestamps=np.asarray(timestamps))]

    return WindowSum()


def process_drive(op, batches, start=0, snap_after=None, fire_ms=None):
    """Feed ``batches[start:]`` (composite key column ``kw``) with a
    watermark of ``max(ts) - 1`` after each, then the end of input;
    returns (fired batches, snapshot after ``snap_after`` batches)."""
    from flink_tpu_torch.core.batch import (MAX_WATERMARK, RecordBatch,
                                            Watermark)
    fired, snap = [], None
    for i in range(start, len(batches)):
        keys, vals, ts = batches[i]
        kw = (ts // WINDOW_MS) << KEY_BITS | keys
        op.process_batch(RecordBatch({"kw": kw, "v": vals}, timestamps=ts))
        t0 = time.perf_counter()
        out = op.process_watermark(Watermark(int(ts.max()) - 1))
        if out and fire_ms is not None:
            fire_ms.append((time.perf_counter() - t0) * 1e3)
        fired += out
        if snap_after is not None and i + 1 == snap_after:
            snap = op.snapshot_state()
    fired += op.process_watermark(Watermark(MAX_WATERMARK))
    return fired, snap


def path36(card, batches):
    """The keyed process path over the 1M-key stream's first 16 batches:
    the heap (host numpy, as JAX's), its changelog twin, and a replay of
    the snapshot after batch 8."""
    from flink_tpu_torch.core.functions import RuntimeContext
    from flink_tpu_torch.operators.process import KeyedProcessOperator
    from flink_tpu_torch.state.changelog import ChangelogKeyedStateBackend
    from flink_tpu_torch.state.heap import HeapKeyedStateBackend
    batches = batches[:PROCESS_BATCHES]

    def make(changelog=False):
        be = HeapKeyedStateBackend()
        op = KeyedProcessOperator(
            process_function(), "kw",
            backend=ChangelogKeyedStateBackend(be) if changelog else be)
        op.open(RuntimeContext())
        return op

    reset_launches()
    fire_ms = []
    op = make()
    t0 = time.perf_counter()
    fired, snap = process_drive(op, batches,
                                snap_after=PROCESS_SNAPSHOT_AFTER,
                                fire_ms=fire_ms)
    wall = time.perf_counter() - t0
    launches = read_launches()
    check(all(v == 0 for v in launches.values()),
          f"path 36: launches {launches}; the heap is host numpy")
    expect = reference(batches)
    check_fires(fired, expect, "path 36")
    check_fires_bits(fired, reference_f32(batches), "path 36")
    for b in fired:
        w = int(b.column("window_start")[0])
        keys = np.asarray(b.column("k"))
        check(np.array_equal(np.asarray(b.column("count")), expect[w][1][keys]),
              f"path 36 window {w}: counts differ from the reference")

    def bits(out):
        return [(b.column("k").tobytes(), b.column("window_start").tobytes(),
                 b.column("result").tobytes(), b.column("count").tobytes())
                for b in out]

    t1 = time.perf_counter()
    twin, _ = process_drive(make(changelog=True), batches)
    twin_s = time.perf_counter() - t1
    check(bits(twin) == bits(fired), "path 36: the changelog twin's rows "
          "differ from the heap's in their bits")
    rop = make()
    t2 = time.perf_counter()
    rop.restore_state(snap)
    restore_ms = (time.perf_counter() - t2) * 1e3
    rest, _ = process_drive(rop, batches, start=PROCESS_SNAPSHOT_AFTER)
    later = [b for b in fired
             if int(b.column("window_start")[0])
             >= min(int(x.column("window_start")[0]) for x in rest)]
    check(bits(rest) == bits(later) and rest,
          "path 36: the replay from the snapshot after batch "
          f"{PROCESS_SNAPSHOT_AFTER} differs from the run's rest")
    n_rec = sum(len(k) for k, _, _ in batches)
    p50, p99 = np.percentile(fire_ms, 50), np.percentile(fire_ms, 99)
    print(f"path 36: KeyedProcessOperator (heap, host numpy as in JAX: these "
          f"are the host's numbers) over {len(batches)} batches, {n_rec} "
          f"records in {wall:.3f} s = {n_rec / wall:.1f} records/s; "
          f"{len(fired)} fires, {sum(len(b) for b in fired)} rows, fire "
          f"p50/p99 {p50:.1f}/{p99:.1f} ms; held to the reference (rtol "
          f"{RTOL}) and the f32 record-order reference bit for bit; the "
          f"changelog twin ({twin_s:.3f} s) bit for bit; the snapshot after "
          f"batch {PROCESS_SNAPSHOT_AFTER} restored in {restore_ms:.1f} ms "
          f"and replayed bit for bit; launches {launches}")
    print(f"path 36 card: {card}")
    return launches, {"records_per_s": n_rec / wall, "fire_p50_ms": p50,
                      "fire_p99_ms": p99}


def slice15(device, batches, card):
    """Paths 32-36: the graph library on the scale-22 Kronecker graph and
    the keyed process path."""
    import torch
    t0 = time.perf_counter()
    src, dst, w = rmat_edges(GRAPH_SCALE, GRAPH_EDGE_FACTOR, GRAPH_SEED,
                             device)
    from flink_tpu_torch.graph_lib import Graph
    n = 1 << GRAPH_SCALE
    G = {"g": Graph(n, src, dst, w, device=device),
         "src_h": src.cpu().numpy(), "dst_h": dst.cpu().numpy()}
    torch.cuda.synchronize()
    print(f"slice 15 graph: scale {GRAPH_SCALE}, {n} vertices, "
          f"{src.numel()} edges (edge factor {GRAPH_EDGE_FACTOR}, initiator "
          f"{RMAT_ABC}), made on the card and copied to the host in "
          f"{time.perf_counter() - t0:.2f} s")
    launches, numbers = {}, {}
    for label, fn in (("path 32", path32), ("path 33", path33),
                      ("path 34", path34)):
        t1 = time.perf_counter()
        launches[label], numbers[label] = fn(device, card, G)
        print(f"{label} took {time.perf_counter() - t1:.1f} s of command time")
    del G, src, dst, w
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    launches["path 35"], numbers["path 35"] = path35(device, card)
    print(f"path 35 took {time.perf_counter() - t1:.1f} s of command time")
    t1 = time.perf_counter()
    launches["path 36"], numbers["path 36"] = path36(card, batches)
    print(f"path 36 took {time.perf_counter() - t1:.1f} s of command time")
    print(f"slice 15 took {time.perf_counter() - t0:.1f} s of command time")
    return launches, numbers


# ---------------------------------------------------------------------------
# slice 16: object keys and the local job path (paths 37-39)
# ---------------------------------------------------------------------------

SLICE16 = ("path 37", "path 38", "path 39")
#: ``bench.py`` ``run_config1`` at its full (non-smoke) size: SocketWindow-
#: WordCount's words, Zipf(1.3) over a 30,000-word vocabulary, 10 words a
#: line, 4096 lines a batch, batch ``i``'s lines at ``i`` s plus a sorted
#: offset under 1 s, tumbling 5000 ms windows
WORDS = 1 << 22
VOCAB = 30_000
WORD_SEED = 11
WORDS_PER_LINE = 10
LINES_PER_BATCH = 4096
WORD_WINDOW_MS = 5000
#: path 39 stops the job if the server has not closed by then
SOCKET_MAX_WALL_MS = 300_000
#: the extra check of the mesh session fold's vector leaves: the first
#: batches of path 23's stream, on ``MESH_BLOCKS`` blocks of the card and
#: of the CPU
VECTOR_LEAF_BATCHES = 8


def make_lines(n_words: int, vocab: int, seed: int = WORD_SEED):
    """Copy of ``bench.py`` ``_make_lines``: text lines of 10 words, Zipf
    word frequencies; returns ``[(lines, ts_ms)]``."""
    rng = np.random.default_rng(seed)
    words = np.asarray([f"w{i:05d}" for i in range(vocab)], object)
    ranks = rng.zipf(1.3, n_words).astype(np.int64) % vocab
    flat = words[ranks]
    lines = [" ".join(flat[i:i + WORDS_PER_LINE])
             for i in range(0, n_words, WORDS_PER_LINE)]
    batches = []
    t = 0
    for lo in range(0, len(lines), LINES_PER_BATCH):
        chunk = lines[lo:lo + LINES_PER_BATCH]
        ts = t + np.sort(rng.integers(0, 1000, len(chunk))).astype(np.int64)
        t += 1000
        batches.append((chunk, ts))
    return batches


def tokenize(lines, ts=None):
    """A batch of lines -> (words, the line of each word, each word's
    timestamp): the flatMap of WordCount, in numpy where it can be."""
    per_line = [line.split() for line in lines]
    counts = np.fromiter(map(len, per_line), np.int64, len(per_line))
    words = np.asarray([w for ws in per_line for w in ws], object)
    src = np.repeat(np.arange(len(per_line)), counts)
    return words, src, (None if ts is None else np.asarray(ts)[src])


def word_counts(batches):
    """The exact count of every (word, window start): a Python dict."""
    counts = {}
    for lines, ts in batches:
        for line, t in zip(lines, ts.tolist()):
            w0 = t // WORD_WINDOW_MS * WORD_WINDOW_MS
            for w in line.split():
                counts[(w, w0)] = counts.get((w, w0), 0) + 1
    return counts


def word_rows(fired, key="k", value="result"):
    """{(word, window start): value} of fired batches; fails on a (word,
    window) fired twice."""
    rows = {}
    for b in fired:
        ws = np.asarray(b.column("window_start"))
        for w, s, v in zip(np.asarray(b.column(key)).tolist(), ws.tolist(),
                           np.asarray(b.column(value)).tolist()):
            check((w, s) not in rows, f"({w}, {s}) fired twice")
            rows[(w, s)] = v
    return rows


def fire_bits(fired):
    """Each fire as (window start, its words sorted, the values' f64 bits
    in that order): the host tier fires from its f64 mirror, the device
    tier its f32 cells, and the counts are integers below 2^24, exact in
    both."""
    out = []
    for b in fired:
        keys = np.asarray(b.column("k"))
        order = np.argsort(keys, kind="stable")
        out.append((int(np.asarray(b.column("window_start"))[0]),
                    tuple(keys[order].tolist()),
                    np.asarray(b.column("result"), np.float64)[order]
                    .tobytes()))
    return out


def wordcount_op(device, tier="host"):
    """Path 37's operator: the 5000 ms tumbling sum of ones, f32, scatter
    sync; the host tier with the numpy mirror (the object index takes no C
    mirror and no device probe), or its device-tier twin."""
    import torch

    from flink_tpu_torch.core.functions import RuntimeContext, SumAggregator
    from flink_tpu_torch.operators.window_agg import WindowAggOperator
    from flink_tpu_torch.windowing.assigners import TumblingEventTimeWindows
    op = WindowAggOperator(
        TumblingEventTimeWindows.of(WORD_WINDOW_MS),
        SumAggregator(torch.float32), key_column="k", value_column="v",
        emit_tier=tier,
        snapshot_source="mirror" if tier == "host" else "device",
        device_sync="scatter", device_probe="on", superbatch=1,
        pipeline_depth=0, device=device)
    op.open(RuntimeContext())
    return op


def wordcount_drive(op, batches, start=0, snap_at=None, fire_ms=None):
    """Tokenize and feed batches ``start:``, a watermark of the batch's
    last timestamp - 1 after each; returns (fired, snapshot taken after
    batch ``snap_at``)."""
    from flink_tpu_torch.core.batch import RecordBatch, Watermark
    fired, snap = [], None
    for i, (lines, ts) in enumerate(batches[start:], start):
        words, _, wts = tokenize(lines, ts)
        fired += op.process_batch(RecordBatch(
            {"k": words, "v": np.ones(words.size, np.float32)},
            timestamps=wts))
        f0 = time.perf_counter()
        out = op.process_watermark(Watermark(int(wts[-1]) - 1))
        if out and fire_ms is not None:
            fire_ms.append((time.perf_counter() - f0) * 1e3)
        fired += out
        if i == snap_at:
            fired += op.prepare_snapshot_pre_barrier()
            snap = op.snapshot_state()
    f0 = time.perf_counter()
    tail = op.end_input()
    if fire_ms is not None:
        fire_ms.append((time.perf_counter() - f0) * 1e3)
    return fired + tail, snap


def path37(device, card, batches, counts):
    """Path 37: WordCount on ``WindowAggOperator`` with string keys."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from flink_tpu_torch.state.keyindex import ObjectKeyIndex
    mid = len(batches) // 2
    op = wordcount_op(device)
    fire_ms = []
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    fired, snap = wordcount_drive(op, batches, snap_at=mid, fire_ms=fire_ms)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    n_words = int(sum(np.asarray(b.column("result")).sum() for b in fired))
    check(isinstance(op.key_index, ObjectKeyIndex)
          and not op.native_mirror_active
          and op.device_probe_stats()["enabled"] == 0,
          "path 37: not the object index on the numpy mirror without the "
          "probe")
    check(launches["scatter_fold"] > 0 and launches["probe"] == 0
          and launches["probe_fold"] == 0,
          f"path 37: launches {launches}; the object-key lane folds through "
          f"scatter_fold and probes nothing on the card")
    rows = word_rows(fired)
    check(rows == {k: float(v) for k, v in counts.items()},
          f"path 37: {len(rows)} (word, window) counts, the dict "
          f"{len(counts)}; they differ")
    print(f"path 37 fires equal the exact dict count of every (word, "
          f"window): {len(rows)} rows in {len(fired)} fires, "
          f"{op.key_index.num_keys} distinct words, {n_words} words")
    # the device emit tier's twin, bit for bit
    twin = wordcount_op(device, "device")
    tfired, _ = wordcount_drive(twin, batches)
    check(fire_bits(tfired) == fire_bits(fired),
          "path 37: the device-tier twin's fires differ")
    print(f"path 37 device-tier twin: {len(tfired)} fires equal the host "
          f"tier's exactly (the same words, the same counts)")
    # a replay from the halfway snapshot, then a profiled one
    want = fire_bits([b for b in fired
                      if int(np.asarray(b.column("window_start"))[0])
                      >= (mid + 1) * 1000 // WORD_WINDOW_MS * WORD_WINDOW_MS])

    def replay_once(prof=None):
        rop = wordcount_op(device)
        torch.cuda.synchronize()
        r0 = time.perf_counter()
        with prof if prof is not None else contextlib.nullcontext():
            rop.restore_state(snap)
            out, _ = wordcount_drive(rop, batches, start=mid + 1)
            torch.cuda.synchronize()
        return time.perf_counter() - r0, fire_bits(out)
    rwall, got = replay_once()
    check(got[-len(want):] == want and len(got) >= len(want) > 0,
          "path 37: the replay from the halfway snapshot differs")
    prof = profile(activities=[ProfilerActivity.CUDA])
    _, again = replay_once(prof)
    check(again == got, "path 37: a second replay differs from the first")
    busy_ms, _ = device_busy_ms(prof)
    idle = 100 - 100 * busy_ms / (rwall * 1e3)
    phases = sorted(op.phase_ns.items(), key=lambda kv: -kv[1])
    numbers = {"words_per_s": n_words / wall, "wall_s": wall,
               "fire_p50_ms": float(np.percentile(fire_ms, 50)),
               "fire_p99_ms": float(np.percentile(fire_ms, 99)),
               "phase_ms": {k: v / 1e6 for k, v in op.phase_ns.items()},
               "replay_idle_pct": idle}
    print(f"path 37 (WordCount, string keys, host tier): {n_words} words in "
          f"{wall:.3f} s = {numbers['words_per_s']:.1f} words/s "
          f"(tokenization included); fire p50/p99 "
          f"{numbers['fire_p50_ms']:.3f}/{numbers['fire_p99_ms']:.3f} ms; "
          f"phases " + ", ".join(f"{k} {v / 1e6:.1f} ms" for k, v in phases)
          + f"; restore+replay from batch {mid}: {len(want)} fires equal bit "
          f"for bit, wall {rwall * 1e3:.1f} ms, the card busy "
          f"{busy_ms:.3f} ms = idle {idle:.2f}%; {card}")
    return launches, numbers, rows


def path38(device, card, batches, want_rows):
    """Path 38: path 37's WordCount as a DataStream job on LocalExecutor."""
    import torch

    from flink_tpu_torch.connectors.sources import GeneratorSource
    from flink_tpu_torch.core.functions import SumAggregator
    from flink_tpu_torch.datastream import StreamExecutionEnvironment
    from flink_tpu_torch.windowing import TumblingEventTimeWindows

    def line_batch(split, b, n):
        lines, ts = batches[b]
        return {"line": np.asarray(lines, object), "t": ts}

    def split(cols):
        words, src, wts = tokenize(np.asarray(cols["line"]).tolist(),
                                   cols["t"])
        return ({"word": words, "v": np.ones(words.size, np.float32),
                 "t": wts}, src)

    env = StreamExecutionEnvironment(device=device)
    sink = (env.from_source(GeneratorSource(line_batch, len(batches),
                                            LINES_PER_BATCH), "lines")
            .flat_map(split, "split")
            .assign_timestamps_and_watermarks(0, timestamp_column="t")
            .key_by("word")
            .window(TumblingEventTimeWindows.of(WORD_WINDOW_MS))
            .aggregate(SumAggregator(torch.float32), value_column="v",
                       output_column="v", emit_tier="host")
            .collect())
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    result = env.execute("wordcount")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    rows = {}
    for r in sink.rows():
        check((r["word"], r["window_start"]) not in rows,
              f"path 38: ({r['word']}, {r['window_start']}) fired twice")
        rows[(r["word"], r["window_start"])] = r["v"]
    check(rows == want_rows, f"path 38: {len(rows)} rows differ from path "
          f"37's {len(want_rows)}")
    check(launches["scatter_fold"] > 0 and launches["probe"] == 0
          and launches["probe_fold"] == 0, f"path 38: launches {launches}")
    n_words = int(sum(want_rows.values()))
    numbers = {"wall_s": wall, "words_per_s": n_words / wall,
               "records_emitted": result.records_emitted}
    # where the job's wall goes: the window operator's own phases, and the
    # host work around it timed again alone over the same batches
    window_op = next(m for rv in env._last_executor.running.values()
                     for m in getattr(rv.operator, "operators",
                                      [rv.operator])
                     if hasattr(m, "phase_ns"))
    from flink_tpu_torch.core import keygroups
    t1 = time.perf_counter()
    tokenized = [tokenize(lines, ts) for lines, ts in batches]
    tok_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    for words, _, _ in tokenized:
        keygroups.assign_to_key_group(keygroups.hash_keys(words), 128)
    kg_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    sink.rows()
    rows_s = time.perf_counter() - t1
    print(f"path 38 breakdown: the window operator's phases "
          + ", ".join(f"{k} {v / 1e6:.1f} ms" for k, v in sorted(
              window_op.phase_ns.items(), key=lambda kv: -kv[1]))
          + f"; alone on the host: tokenization {tok_s * 1e3:.1f} ms, key "
          f"groups (string hashes) {kg_s * 1e3:.1f} ms, the sink's rows "
          f"{rows_s * 1e3:.1f} ms")
    print(f"path 38 (WordCount as a DataStream job on LocalExecutor: lines "
          f"-> flat_map -> timestamps -> key_by(word) -> tumbling 5000 ms "
          f"-> sum -> collect): {len(rows)} rows equal path 37's; job wall "
          f"{wall:.3f} s = {numbers['words_per_s']:.1f} words/s; {card}")
    return launches, numbers


def path39(device, card, batches, counts):
    """Path 39: ``examples/socket_window_word_count.py``'s shape: a
    loopback server thread sends the lines and closes; the job counts words
    in 5000 ms processing-time windows."""
    import socket
    import threading

    import torch

    from flink_tpu_torch.datastream import StreamExecutionEnvironment
    from flink_tpu_torch.windowing import TumblingProcessingTimeWindows

    payload = "".join(line + "\n" for lines, _ in batches
                      for line in lines).encode()
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    port = srv.getsockname()[1]

    def serve():
        try:
            conn, _ = srv.accept()
            with conn:
                conn.sendall(payload)
        finally:
            srv.close()
    server = threading.Thread(target=serve, daemon=True)
    server.start()

    def split(cols):
        words, src, _ = tokenize(np.asarray(cols["line"]).tolist())
        return {"word": words}, src

    env = StreamExecutionEnvironment(device=device)
    sink = (env.socket_text_stream("127.0.0.1", port, LINES_PER_BATCH)
            .flat_map(split, "split").key_by("word")
            .window(TumblingProcessingTimeWindows.of(WORD_WINDOW_MS))
            .count().collect())
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    env.execute("socket-wordcount", max_wall_ms=SOCKET_MAX_WALL_MS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    server.join(timeout=30)
    check(not server.is_alive(), "path 39: the server thread is still up")
    totals, windows = {}, set()
    for r in sink.rows():
        totals[r["word"]] = totals.get(r["word"], 0) + int(r["count"])
        windows.add(r["window_start"])
    want = {}
    for (w, _), c in counts.items():
        want[w] = want.get(w, 0) + c
    check(totals == want, f"path 39: per-word totals of {len(totals)} words "
          f"differ from the input's {len(want)}")
    check(launches["scatter_fold"] > 0 and launches["probe"] == 0
          and launches["probe_fold"] == 0, f"path 39: launches {launches}")
    n_words = sum(want.values())
    numbers = {"wall_s": wall, "words_per_s": n_words / wall,
               "windows": len(windows), "bytes": len(payload)}
    print(f"path 39 (socket WordCount, processing-time 5000 ms windows, "
          f"count): {len(payload)} bytes over loopback, {n_words} words "
          f"into {len(windows)} windows; per-word totals equal the input's; "
          f"job wall {wall:.3f} s = {numbers['words_per_s']:.1f} words/s; "
          f"{card}")
    return launches, numbers


def vector_leaf_check(device, session_batches) -> None:
    """The mesh session fold's vector leaves (a 3-vector sum and 2-vector
    min and max) over ``MESH_BLOCKS`` blocks of the card against the CPU,
    on path 23's first batches: every fire and the snapshot bit for bit,
    the sum leaf through ``ordered_fold`` (``scatter_fold``) on the card."""
    import torch

    from flink_tpu_torch.core.batch import RecordBatch, Watermark
    from flink_tpu_torch.core.functions import (AggregateFunction,
                                                RuntimeContext)
    from flink_tpu_torch.ops import scatter as sc
    from flink_tpu_torch.parallel.mesh import make_mesh
    from flink_tpu_torch.parallel.mesh_runtime import \
        MeshSessionWindowOperator
    from flink_tpu_torch.windowing.assigners import EventTimeSessionWindows

    class VectorStats(AggregateFunction):
        def identity(self):
            return {"s": torch.zeros(3),
                    "lo": torch.full((2,), float("inf")),
                    "hi": torch.full((2,), float("-inf"))}

        def lift(self, values):
            v = torch.as_tensor(values, dtype=torch.float32)
            pair = torch.stack([v, -v], 1)
            return {"s": torch.stack([v, v * v, torch.ones_like(v)], 1),
                    "lo": pair, "hi": pair}

        def combine(self, a, b):
            return {"s": a["s"] + b["s"],
                    "lo": torch.minimum(a["lo"], b["lo"]),
                    "hi": torch.maximum(a["hi"], b["hi"])}

        def get_result(self, acc):
            return acc["s"][..., 0] + acc["lo"][..., 0] + acc["hi"][..., 1]

        def scatter_kinds(self):
            return {"s": "add", "lo": "min", "hi": "max"}

    runs = []
    t0 = time.perf_counter()
    for dev in (device, torch.device("cpu")):
        op = MeshSessionWindowOperator(
            EventTimeSessionWindows(SESSION_GAP_MS), VectorStats(),
            key_column="k", value_column="v",
            mesh=make_mesh(devices=[dev] * MESH_BLOCKS))
        op.open(RuntimeContext())
        before = sc.ordered_fold.launches
        out = []
        for keys, vals, ts in session_batches[:VECTOR_LEAF_BATCHES]:
            out += op.process_batch(RecordBatch({"k": keys, "v": vals},
                                                timestamps=ts))
            out += op.process_watermark(Watermark(int(ts.max()) - 1))
        out += op.process_watermark(Watermark(1 << 40))
        snap = op.snapshot_state()
        runs.append(([tuple((c, np.asarray(b.column(c)).tobytes())
                            for c in sorted(b.columns)) for b in out],
                     [np.asarray(a).tobytes() for a in snap["acc"]],
                     sc.ordered_fold.launches - before))
    (gf, gs, gl), (cf, cs, cl) = runs
    check(gf == cf and gf and gs == cs,
          "vector leaves: the mesh on the card differs from the CPU mesh")
    check(gl == MESH_BLOCKS * VECTOR_LEAF_BATCHES and cl == 0,
          f"vector leaves: {gl} ordered_fold launches on the card")
    print(f"vector-leaf mesh session fold (a [3] sum, [2] min and max) on "
          f"{MESH_BLOCKS} blocks of the card: {len(gf)} fires over path "
          f"23's first {VECTOR_LEAF_BATCHES} batches and the snapshot equal "
          f"the CPU mesh's bit for bit; {gl} scatter_fold launches; "
          f"{time.perf_counter() - t0:.1f} s")


def slice16(device, card):
    """Paths 37-39: WordCount with string keys on the operator, as a
    DataStream job, and from a socket in processing-time windows."""
    t0 = time.perf_counter()
    batches = make_lines(WORDS, VOCAB)
    counts = word_counts(batches)
    print(f"slice 16 stream: {WORDS} words in {len(batches)} batches of "
          f"{LINES_PER_BATCH} lines, {len(counts)} (word, window) counts "
          f"(made and counted in {time.perf_counter() - t0:.1f} s)")
    launches, numbers = {}, {}
    t1 = time.perf_counter()
    launches["path 37"], numbers["path 37"], rows = path37(device, card,
                                                           batches, counts)
    print(f"path 37 took {time.perf_counter() - t1:.1f} s of command time")
    t1 = time.perf_counter()
    launches["path 38"], numbers["path 38"] = path38(device, card, batches,
                                                     rows)
    print(f"path 38 took {time.perf_counter() - t1:.1f} s of command time")
    t1 = time.perf_counter()
    launches["path 39"], numbers["path 39"] = path39(device, card, batches,
                                                     counts)
    print(f"path 39 took {time.perf_counter() - t1:.1f} s of command time")
    print(f"slice 16 took {time.perf_counter() - t0:.1f} s of command time")
    return launches, numbers


# ---------------------------------------------------------------------------
# slice 17: the rest of the local job path and the DataStream routes (paths
# 40-44)
# ---------------------------------------------------------------------------

SLICE17 = ("path 40", "path 41", "path 42", "path 43", "path 44")
#: path 40's late rows: from batch ``LATE_FROM`` on, a seed-``LATE_SEED``
#: generator moves ``LATE_ROWS`` rows of each batch (1/32) back by a
#: uniform draw in ``LATE_SHIFT_MS``; the window allows ``LATENESS_MS``
LATE_SEED = 41
LATE_FROM = 6
LATE_ROWS = 8192
LATE_SHIFT_MS = (1000, 16_000)
LATENESS_MS = 2000
#: path 41c's host evicting lane (``apply``) runs over the first batches
EVICT_APPLY_BATCHES = 2
#: path 42: the CEP stream's first batches through the DataStream API
CEP_JOB_BATCHES = 4
#: path 43: the window join's first batches of each side
WINDOW_JOIN_BATCHES = 4
#: path 44: the keyed process function on the spill backend, over the
#: first half of the stream's first batch (cut from 2 batches: the path
#: took 68.1 s of command time over 2 on the H100's host, over the 60 s it
#: may take; then from the whole batch when slice 21's path 53 took the
#: smoke over its 900 s target); the snapshot after it restores and fires
#: the end of input
SPILL_BATCHES = 1
SPILL_ROWS = BATCH // 4         # a quarter batch since slice 22
SPILL_SNAPSHOT_AFTER = 1
SPILL_BUDGET = 8 << 20
#: results of earlier paths that slice 17 is held to
HELD = {}


def sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


@contextlib.contextmanager
def timed_calls(cls, name: str, record: list, before=None):
    """Every call of ``cls.name`` during the block appends (host ms, whether
    it returned anything) to ``record``, after calling ``before()`` (when
    given) untimed."""
    orig = getattr(cls, name)

    def timed(self, *args, **kwargs):
        if before is not None:
            before()
        t0 = time.perf_counter()
        out = orig(self, *args, **kwargs)
        record.append(((time.perf_counter() - t0) * 1e3, bool(out)))
        return out

    setattr(cls, name, timed)
    try:
        yield
    finally:
        setattr(cls, name, orig)


def job_operators(env) -> list:
    """The operators of the environment's last job, chains unrolled."""
    return [m for rv in env._last_executor.running.values()
            for m in getattr(rv.operator, "operators", [rv.operator])]


def job_operator(env, cls):
    ops = [m for m in job_operators(env) if type(m) is cls]
    check(len(ops) == 1, f"the job ran {len(ops)} {cls.__name__}")
    return ops[0]


def stream_columns(batches, e=False):
    """One column dict over ``batches`` (``e``: each row's stream
    position)."""
    cols = {"k": np.concatenate([b[0] for b in batches]),
            "v": np.concatenate([b[1] for b in batches]),
            "ts": np.concatenate([b[2] for b in batches])}
    if e:
        cols["e"] = np.arange(cols["k"].size, dtype=np.int64)
    return cols


def keyed_job(env, batches, batch_size=None, e=False):
    """``batches`` as one collection source (``BATCH`` rows a batch, or
    ``batch_size``), timestamps from ``ts``, keyed by ``k``."""
    return (env.from_collection(columns=stream_columns(batches, e),
                                batch_size=batch_size or BATCH)
            .assign_timestamps_and_watermarks(0, timestamp_column="ts")
            .key_by("k"))


def late_batches(batches):
    """Path 40's stream: ``batches`` with late rows from batch
    ``LATE_FROM`` on."""
    rng = np.random.default_rng(LATE_SEED)
    out = []
    for i, (k, v, ts) in enumerate(batches):
        if i >= LATE_FROM:
            ts = ts.copy()
            rows = rng.choice(ts.size, LATE_ROWS, replace=False)
            ts[rows] -= rng.integers(*LATE_SHIFT_MS, LATE_ROWS)
        out.append((k, v, ts))
    return out


def late_model(batches, n_keys=None):
    """Independent numpy semantics of a tumbling sum with allowed lateness
    and a late side output: per batch, rows whose window's cleanup time
    (end - 1 + lateness) the watermark passed go to the side output; the
    rest fold into their window (f32 cells in record order, ``np.add.at``;
    f64 sums and counts); a window the watermark fired that the batch
    touched fires again with its whole contents; then the watermark
    (``max(ts) - 1``, cumulative) fires the windows it passed, and the end
    fires the rest.  Returns (fires as ``(window start, keys ascending, f32
    cells, f64 sums, counts, re-fire?)`` in order, the side rows per batch
    as ``(k, v, ts)``)."""
    n_keys = n_keys or N_KEYS
    cells, sums, cnts, fired = {}, {}, {}, set()
    fires, side = [], []
    wm = None

    def fire(w, refire=False):
        keys = np.flatnonzero(cnts[w])
        fires.append((w, keys, cells[w][keys], sums[w][keys],
                      cnts[w][keys], refire))

    for keys, vals, ts in batches:
        starts = ts // WINDOW_MS * WINDOW_MS
        late = (np.zeros(ts.size, bool) if wm is None
                else starts + WINDOW_MS - 1 + LATENESS_MS <= wm)
        if late.any():
            side.append((keys[late], vals[late], ts[late]))
        k, v, s = keys[~late], vals[~late], starts[~late]
        touched = np.unique(s).tolist()
        for w in touched:
            m = s == w
            if w not in cells:
                cells[w] = np.zeros(n_keys, np.float32)
                sums[w] = np.zeros(n_keys)
                cnts[w] = np.zeros(n_keys, np.int64)
            np.add.at(cells[w], k[m], v[m])
            sums[w] += np.bincount(k[m], weights=v[m].astype(np.float64),
                                   minlength=n_keys)
            cnts[w] += np.bincount(k[m], minlength=n_keys)
        if wm is not None:
            for w in touched:
                if w in fired and w + WINDOW_MS - 1 + LATENESS_MS > wm:
                    fire(w, refire=True)
        top = int(ts.max()) - 1
        wm = top if wm is None else max(wm, top)
        for w in sorted(cells):
            if w not in fired and w + WINDOW_MS - 1 <= wm:
                fire(w)
                fired.add(w)
        for w in [w for w in cells
                  if w in fired and w + WINDOW_MS - 1 + LATENESS_MS <= wm]:
            del cells[w], sums[w], cnts[w]
    for w in sorted(cells):
        if w not in fired:
            fire(w)
    return fires, side


def check_late_fires(label, fired, model, bits):
    """Every fire against the model in order: the window, its keys (as a
    set), the f32 cells bit for bit (``bits``: the device tier) or the f64
    sums to ``RTOL`` (the host tier's f64 mirror)."""
    check(len(fired) == len(model), f"{label}: {len(fired)} fires, the "
          f"model {len(model)}")
    for b, (w, keys, cells, sums, _, _) in zip(fired, model):
        k = np.asarray(b.column("k"))
        r = np.asarray(b.column("result"))
        order = np.argsort(k, kind="stable")
        check(int(np.asarray(b.column("window_start"))[0]) == w
              and np.array_equal(k[order], keys),
              f"{label} window {w}: its keys differ from the model's")
        ok = (r[order].tobytes() == cells.tobytes() if bits
              else np.allclose(r[order], sums, rtol=RTOL, atol=0))
        check(ok, f"{label} window {w}: results differ from the model "
              f"(max abs {np.max(np.abs(r[order] - sums))})")


def side_rows(batches):
    """The side output's rows, concatenated in arrival order."""
    if not batches:
        return np.zeros(0, np.int64), np.zeros(0, np.float32), \
            np.zeros(0, np.int64)
    return (np.concatenate([np.asarray(b.column("k")) for b in batches]),
            np.concatenate([np.asarray(b.column("v")) for b in batches]),
            np.concatenate([np.asarray(b.timestamps) for b in batches]))


def late_job(device, batches, tier, tag=True):
    """Path 40's job: the window sum with allowed lateness and (``tag``) a
    late side output.  Returns (fires, side batches, the window operator,
    wall s, launches, fire ms)."""
    import torch

    from flink_tpu_torch.core.functions import SumAggregator
    from flink_tpu_torch.datastream import StreamExecutionEnvironment
    from flink_tpu_torch.operators.window_agg import WindowAggOperator
    from flink_tpu_torch.windowing import TumblingEventTimeWindows

    env = StreamExecutionEnvironment(device=device)
    w = (keyed_job(env, batches)
         .window(TumblingEventTimeWindows.of(WINDOW_MS))
         .allowed_lateness(LATENESS_MS))
    if tag:
        w = w.side_output_late_data("late")
    agg = w.aggregate(SumAggregator(torch.float32), value_column="v",
                      emit_tier=tier, device_probe="on")
    main = agg.collect()
    late = agg.get_side_output("late").collect() if tag else None
    fire_ms = []
    sync(device)
    reset_launches()
    t0 = time.perf_counter()
    with timed_calls(WindowAggOperator, "process_watermark", fire_ms):
        env.execute("late-data")
    sync(device)
    wall = time.perf_counter() - t0
    launches = read_launches()
    op = job_operator(env, WindowAggOperator)
    return (list(main.batches), list(late.batches) if tag else [], op, wall,
            launches, [ms for ms, fired in fire_ms if fired])


def path40(device, card, batches):
    """Path 40: late data at full width as a DataStream job, on the device
    tier (40a) and the host tier with the probe on (40b)."""
    stream = late_batches(batches)
    t0 = time.perf_counter()
    model, side = late_model(stream)
    model_s = time.perf_counter() - t0
    want = tuple(np.concatenate([s[i] for s in side]) for i in range(3))
    n_refires = sum(f[5] for f in model)
    n_records = sum(len(b[0]) for b in stream)
    launches, numbers, sides = {}, {}, {}
    for lane, tier in (("40a", "device"), ("40b", "host")):
        fired, late, op, wall, ln, fire_ms = late_job(device, stream, tier)
        launches[lane] = ln
        check_late_fires(f"path {lane}", fired, model, bits=tier == "device")
        got = side_rows(late)
        check(all(a.tobytes() == b.tobytes() for a, b in zip(got, want))
              and got[0].size == want[0].size,
              f"path {lane}: the side output ({got[0].size} rows) differs "
              f"from the model's beyond-lateness rows ({want[0].size})")
        check(op.late_dropped == 0 and op.late_output_tag == "late",
              f"path {lane}: late_dropped {op.late_dropped} with the tag")
        check(op.emit_tier == tier, f"path {lane}: emit tier {op.emit_tier}")
        check(ln["scatter_fold"] > 0, f"path {lane}: launches {ln}")
        if tier == "host":
            check(ln["probe"] > 0, f"path {lane}: no probe launch: {ln}")
        sides[lane] = got
        p50, p99 = np.percentile(fire_ms, 50), np.percentile(fire_ms, 99)
        numbers[lane] = {"records_per_s": n_records / wall, "wall_s": wall,
                         "fire_p50_ms": p50, "fire_p99_ms": p99}
        print(f"path {lane} ({tier} tier{', probe on' if tier == 'host' else ''}"
              f"): {n_records} records through the job in {wall:.3f} s = "
              f"{n_records / wall:.1f} records/s; {len(fired)} fires "
              f"({n_refires} late re-fires) equal the model "
              f"({'bit for bit' if tier == 'device' else f'rtol {RTOL}'}); "
              f"{got[0].size} rows to the side output, equal to the model's "
              f"beyond-lateness rows in order; late_dropped 0; fire p50/p99 "
              f"{p50:.3f}/{p99:.3f} ms over {len(fire_ms)} firing calls; "
              f"launches {ln}; {card}")
        print(f"path {lane} phase_ns: " + json.dumps(op.phase_ns,
                                                     sort_keys=True))
        if lane == "40a":
            main_a = digests(fired)
    check(all(a.tobytes() == b.tobytes()
              for a, b in zip(sides["40a"], sides["40b"])),
          "path 40: the device and host tiers' side outputs differ")
    fired, late, op, wall, ln, _ = late_job(device, stream, "device",
                                            tag=False)
    check(op.late_dropped == want[0].size and not late,
          f"path 40: the untagged twin dropped {op.late_dropped} rows, the "
          f"side output held {want[0].size}")
    check(digests(fired) == main_a, "path 40: the untagged twin's fires "
          "differ from 40a's in their bits")
    print(f"path 40: the untagged twin (device tier) drops "
          f"{op.late_dropped} rows (late_dropped) = the side output's and "
          f"fires 40a's rows bit for bit ({wall:.3f} s); the model took "
          f"{model_s:.1f} s")
    total = {k: launches["40a"][k] + launches["40b"][k]
             for k in launches["40a"]}
    numbers.update(late_rows=int(want[0].size), refires=int(n_refires))
    return total, numbers


def path41(device, card, batches, session_batches):
    """Path 41: the environment's routes on one card: the mesh (41a: the
    window sum, 41b: sessions) and the evicting lanes (41c)."""
    import torch

    from flink_tpu_torch.core.functions import SumAggregator
    from flink_tpu_torch.datastream import StreamExecutionEnvironment
    from flink_tpu_torch.operators.evicting_device import \
        DeviceEvictingWindowOperator
    from flink_tpu_torch.operators.evicting_window import \
        EvictingWindowOperator
    from flink_tpu_torch.parallel.mesh import make_mesh
    from flink_tpu_torch.parallel.mesh_runtime import (
        MeshSessionWindowOperator, MeshWindowAggOperator)
    from flink_tpu_torch.windowing import (CountEvictor,
                                           EventTimeSessionWindows,
                                           TumblingEventTimeWindows)
    launches, numbers = {}, {}

    def run(lane, env, stream, cls):
        sink = stream.collect()
        sync(device)
        reset_launches()
        t0 = time.perf_counter()
        env.execute(lane)
        sync(device)
        wall = time.perf_counter() - t0
        launches[lane] = read_launches()
        check(launches[lane]["scatter_fold"] > 0,
              f"path {lane}: launches {launches[lane]}")
        return list(sink.batches), job_operator(env, cls), wall

    # 41a: the window sum on the environment's mesh
    env = StreamExecutionEnvironment(
        device=device, mesh=make_mesh(devices=[device] * MESH_BLOCKS))
    fired, op, wall = run("41a", env, keyed_job(env, batches)
                          .window(TumblingEventTimeWindows.of(WINDOW_MS))
                          .aggregate(SumAggregator(torch.float32),
                                     value_column="v", device_probe="on"),
                          MeshWindowAggOperator)
    # the environment's mesh route leaves the emit tier to auto (JAX's
    # API refuses emit_tier with a mesh): the host tier on a card, whose
    # fires are path 14's bit for bit, and path 15's (the device tier) to
    # the tolerance between the tiers
    d = digests(fired)
    same, other = (("path 14", "path 15") if op.emit_tier == "host"
                   else ("path 15", "path 14"))
    check(d == HELD[same], f"path 41a: the job's fires differ from {same}'s "
          f"(the {op.emit_tier} tier on the mesh, driven directly) in their "
          f"bits")
    check([x[:2] for x in d] == [x[:2] for x in HELD[other]]
          and all(abs(a[2] - b[2]) <= DEVICE_VS_HOST_RTOL * abs(b[2])
                  for a, b in zip(d, HELD[other])),
          f"path 41a: the job's fires differ from {other}'s")
    n = sum(len(b[0]) for b in batches)
    numbers["41a"] = {"records_per_s": n / wall, "wall_s": wall}
    print(f"path 41a (StreamExecutionEnvironment(mesh=make_mesh(devices="
          f"[card] * {MESH_BLOCKS})), the window sum): {n} records in "
          f"{wall:.3f} s = {n / wall:.1f} records/s; {op.emit_tier} tier on "
          f"{op.n_shards} blocks; {len(fired)} fires equal {same}'s bit "
          f"for bit and {other}'s (keys in the same order, sums to rtol "
          f"{DEVICE_VS_HOST_RTOL}); launches {launches['41a']}; {card}")
    # 41b: sessions on the environment's mesh
    env = StreamExecutionEnvironment(
        device=device, mesh=make_mesh(devices=[device] * MESH_BLOCKS))
    fired, op, wall = run("41b", env, keyed_job(env, session_batches,
                                                batch_size=SESSION_BATCH)
                          .window(EventTimeSessionWindows(SESSION_GAP_MS))
                          .aggregate(SumAggregator(torch.float32),
                                     value_column="v"),
                          MeshSessionWindowOperator)
    rows = session_rows(fired)
    check(rows == HELD["path 23"], f"path 41b: {len(rows)} sessions differ "
          f"from path 23's {len(HELD['path 23'])} (key, start, end, bits)")
    n = sum(len(b[0]) for b in session_batches)
    numbers["41b"] = {"records_per_s": n / wall, "wall_s": wall}
    print(f"path 41b (the environment's mesh, EventTimeSessionWindows("
          f"{SESSION_GAP_MS})): {n} records in {wall:.3f} s = "
          f"{n / wall:.1f} records/s; {len(rows)} sessions equal path 23's "
          f"bit for bit; launches {launches['41b']}; {card}")
    # 41c: the evictor's two lanes
    env = StreamExecutionEnvironment(device=device)
    fired, op, wall = run("41c", env, keyed_job(env, batches)
                          .window(TumblingEventTimeWindows.of(WINDOW_MS))
                          .evictor(CountEvictor.of(1))
                          .sum("v", dtype=torch.float32),
                          DeviceEvictingWindowOperator)
    from flink_tpu_torch.core.batch import RecordBatch
    as_result = [(i, RecordBatch({"k": b.column("k"),
                                  "window_start": b.column("window_start"),
                                  "result": b.column("v")}))
                 for i, b in enumerate(fired)]
    how = check_evictions("path 41c", as_result,
                          evict_model(batches, "path 24"))
    n = sum(len(b[0]) for b in batches)
    numbers["41c"] = {"records_per_s": n / wall, "wall_s": wall}
    first = batches[:EVICT_APPLY_BATCHES]
    env = StreamExecutionEnvironment(device=device)
    sink = (keyed_job(env, first)
            .window(TumblingEventTimeWindows.of(WINDOW_MS))
            .evictor(CountEvictor.of(1))
            .apply(lambda k, w, rows: {"k": k, "window_start": w.start,
                                       "result": np.float32(rows[-1]["v"])})
            .collect())
    reset_launches()
    t0 = time.perf_counter()
    env.execute("apply")
    apply_s = time.perf_counter() - t0
    apply_launches = read_launches()
    job_operator(env, EvictingWindowOperator)
    check(all(v == 0 for v in apply_launches.values()),
          f"path 41c: the host lane launched {apply_launches}")
    applied = [(i, RecordBatch({c: np.asarray(b.column(c))
                                for c in ("k", "window_start", "result")}))
               for i, b in enumerate(sink.batches)]
    how_apply = check_evictions("path 41c apply", applied,
                                evict_model(first, "path 24"))
    n_first = sum(len(b[0]) for b in first)
    n_keys = sum(len(b) for b in sink.batches)
    numbers["41c"].update(apply_s=apply_s, apply_records_per_s=n_first
                          / apply_s)
    print(f"path 41c: .evictor(CountEvictor.of(1)).sum() lands on "
          f"DeviceEvictingWindowOperator: {n} records in {wall:.3f} s = "
          f"{n / wall:.1f} records/s, {how} against path 24's model; "
          f".evictor(CountEvictor.of(1)).apply(fn) lands on the host "
          f"EvictingWindowOperator: {n_first} records, {n_keys} (key, "
          f"window) calls of fn in {apply_s:.3f} s = "
          f"{n_first / apply_s:.1f} records/s, {how_apply}; launches "
          f"{launches['41c']} (apply: {apply_launches}); {card}")
    total = {k: sum(launches[x][k] for x in launches)
             for k in launches["41a"]}
    return total, numbers


def session_rows(fired) -> list:
    """Every session row as (key, start, end, result bits), sorted."""
    out = []
    for b in fired:
        res = np.asarray(b.column("result"))
        out.extend(zip(np.asarray(b.column("k")).tolist(),
                       np.asarray(b.column("window_start")).tolist(),
                       np.asarray(b.column("window_end")).tolist(),
                       [r.tobytes() for r in res]))
    return sorted(out)


def path42(device, card, cep_batches):
    """Path 42: ``CEP.pattern(keyed, pattern).select(fn, vectorized="on")``
    as a DataStream job over the CEP stream's first batches, the step on
    the card."""
    from flink_tpu_torch.cep import CEP, CepOperator
    from flink_tpu_torch.datastream import StreamExecutionEnvironment
    batches = cep_batches[:CEP_JOB_BATCHES]
    log = []
    op_proto = cep_op(device, "on", log)
    env = StreamExecutionEnvironment(device=device)
    ks = (env.from_collection(columns=stream_columns(batches, e=True),
                              batch_size=CEP_BATCH)
          .assign_timestamps_and_watermarks(0, timestamp_column="ts")
          .key_by("k"))
    sink = CEP.pattern(ks, op_proto.pattern).select(
        op_proto.select_fn, vectorized="on").collect()
    drain_ms = []
    sync(device)
    reset_launches()
    t0 = time.perf_counter()
    with timed_calls(CepOperator, "process_watermark", drain_ms):
        env.execute("cep")
    sync(device)
    wall = time.perf_counter() - t0
    launches = read_launches()
    op = job_operator(env, CepOperator)
    check(op._engine == "vectorized" and op.device.type == "cuda",
          f"path 42: the CEP operator ran {op._engine} on {op.device}")

    def rows_of(batches_out):
        return sorted(zip(
            np.concatenate([np.asarray(b.column("k")) for b in batches_out]
                           ).tolist(),
            np.concatenate([np.asarray(b.column("amount"))
                            for b in batches_out]).tolist(),
            np.concatenate([np.asarray(b.timestamps)
                            for b in batches_out]).tolist()))
    got = rows_of(sink.batches)
    direct_rows, _, direct_s, _ = cep_drive(cep_op(device, "on"), batches,
                                            stop=CEP_JOB_BATCHES)
    want = []
    for _, k, amt, ts, (kd, ad, td) in direct_rows:
        want.extend(zip(np.frombuffer(k, kd).tolist(),
                        np.frombuffer(amt, ad).tolist(),
                        np.frombuffer(ts, td).tolist()))
    check(got == sorted(want) and got, f"path 42: the job's {len(got)} "
          f"matches differ from CepOperator's {len(want)} driven directly")
    model = cep_model(batches)
    check(set(log) == model and len(log) == len(model),
          f"path 42: {len(log)} matches, the model {len(model)}")
    n = sum(len(b[0]) for b in batches)
    p50, p99 = np.percentile([ms for ms, _ in drain_ms], [50, 99])
    print(f"path 42 (CEP.pattern(keyed, fraud).select(vectorized=\"on\") as "
          f"a DataStream job, the step on the card): {n} events in "
          f"{wall:.3f} s = {n / wall:.1f} events/s; {len(got)} matches equal "
          f"CepOperator driven directly ({direct_s:.3f} s) and the model; "
          f"drain p50/p99 {p50:.3f}/{p99:.3f} ms over {len(drain_ms)} "
          f"watermark calls; launches {launches}; {card}")
    return launches, {"events_per_s": n / wall, "drain_p50_ms": p50,
                      "drain_p99_ms": p99}


def path43(device, card, batches):
    """Path 43: the interval and window joins' DataStream routes with the
    device lane on (``FLINK_TPU_DEVICE_JOIN=1``)."""
    from flink_tpu_torch.datastream import StreamExecutionEnvironment
    from flink_tpu_torch.operators.joins import (IntervalJoinOperator,
                                                 WindowJoinOperator)
    from flink_tpu_torch.windowing import TumblingEventTimeWindows
    left = batches[:TABLE_BATCHES]
    right = make_batches(TABLE_BATCHES * BATCH, N_KEYS, BATCH, WINDOW_MS,
                         seed=RIGHT_SEED)
    prev = os.environ.get("FLINK_TPU_DEVICE_JOIN")
    os.environ["FLINK_TPU_DEVICE_JOIN"] = "1"
    try:
        env = StreamExecutionEnvironment(device=device)
        sink = (keyed_job(env, left, e=True)
                .interval_join(keyed_job(env, right, e=True))
                .between(JOIN_LOWER_MS, JOIN_UPPER_MS).process().collect())
        sync(device)
        reset_launches()
        t0 = time.perf_counter()
        env.execute("interval-join")
        sync(device)
        wall = time.perf_counter() - t0
        launches = read_launches()
        job_operator(env, IntervalJoinOperator)
        lv = np.concatenate([b[1] for b in left])
        rv = np.concatenate([b[1] for b in right])
        e = np.concatenate([np.asarray(b.column("e")) for b in sink.batches])
        re_ = np.concatenate([np.asarray(b.column("r_e"))
                              for b in sink.batches])
        check(all(np.concatenate([np.asarray(b.column(c)) for b in
                                  sink.batches]).tobytes() == want.tobytes()
                  for c, want in (("v", lv[e]), ("r_v", rv[re_]))),
              "path 43: the interval join's values are not its inputs'")
        pairs = np.sort(e * (1 << 32) + re_)
        check(np.array_equal(pairs, HELD["path 30"]) and pairs.size,
              f"path 43: the interval join's {pairs.size} pairs differ from "
              f"path 30's {HELD['path 30'].size}")
        n_in = sum(len(b[0]) for b in left) + sum(len(b[0]) for b in right)
        print(f"path 43 interval join (key_by(k).interval_join().between("
              f"{JOIN_LOWER_MS}, {JOIN_UPPER_MS}).process(), the device "
              f"lane): {n_in} rows in {wall:.3f} s, {pairs.size} pairs = "
              f"{pairs.size / wall:.1f} pairs/s, equal to path 30's "
              f"(operator driven directly); launches {launches}; {card}")
        wl, wr = left[:WINDOW_JOIN_BATCHES], right[:WINDOW_JOIN_BATCHES]
        env = StreamExecutionEnvironment(device=device)
        sink = (keyed_job(env, wl, e=True)
                .join(keyed_job(env, wr, e=True)).where("k").equal_to("k")
                .window(TumblingEventTimeWindows.of(WINDOW_MS))
                .apply(lambda c: {"e": c["e"], "r_e": c["r_e"],
                                  "window_start": c["window_start"]})
                .collect())
        reset_launches()
        t0 = time.perf_counter()
        env.execute("window-join")
        sync(device)
        wwall = time.perf_counter() - t0
        wlaunches = read_launches()
        job_operator(env, WindowJoinOperator)
    finally:
        if prev is None:
            os.environ.pop("FLINK_TPU_DEVICE_JOIN", None)
        else:
            os.environ["FLINK_TPU_DEVICE_JOIN"] = prev
    got = np.sort(np.concatenate(
        [np.asarray(b.column("e")) * (1 << 32) + np.asarray(b.column("r_e"))
         for b in sink.batches]))
    # the model: every (left, right) row pair of one key and one window
    lk = np.concatenate([b[0] for b in wl])
    lw = np.concatenate([b[2] for b in wl]) // WINDOW_MS
    rk = np.concatenate([b[0] for b in wr])
    rw = np.concatenate([b[2] for b in wr]) // WINDOW_MS
    lcode, rcode = lw * N_KEYS + lk, rw * N_KEYS + rk
    order = np.argsort(rcode, kind="stable")
    lo = np.searchsorted(rcode[order], lcode, "left")
    hi = np.searchsorted(rcode[order], lcode, "right")
    cnt = hi - lo
    li = np.repeat(np.arange(lcode.size), cnt)
    ri = order[np.repeat(lo - np.cumsum(cnt) + cnt, cnt)
               + np.arange(cnt.sum())]
    want = np.sort(li.astype(np.int64) * (1 << 32) + ri)
    digest = hashlib.sha256(got.tobytes()).hexdigest()
    check(np.array_equal(got, want) and got.size,
          f"path 43: the window join's {got.size} pairs differ from the "
          f"model's {want.size}")
    print(f"path 43 window join (join().where(k).equal_to(k).window("
          f"tumbling {WINDOW_MS}).apply(fn), the device lane) over "
          f"{WINDOW_JOIN_BATCHES} batches a side: {got.size} pairs in "
          f"{wwall:.3f} s = {got.size / wwall:.1f} pairs/s; pair count and "
          f"digest {digest[:16]} equal the numpy model; launches "
          f"{wlaunches}; {card}")
    total = {k: launches[k] + wlaunches[k] for k in launches}
    return total, {"pairs_per_s": pairs.size / wall,
                   "window_pairs_per_s": got.size / wwall}


def path44(card, batches):
    """Path 44: path 36's process function on the spill keyed backend
    (``state.backend: spill``, an 8 MiB budget): host C and numpy, the card
    idle."""
    from flink_tpu_torch.config.config_option import Configuration
    from flink_tpu_torch.config.options import StateOptions
    from flink_tpu_torch.core.functions import RuntimeContext
    from flink_tpu_torch.operators.process import KeyedProcessOperator
    from flink_tpu_torch.state import make_keyed_backend
    from flink_tpu_torch.state.heap import HeapKeyedStateBackend
    from flink_tpu_torch.state.spill import SpillKeyedStateBackend
    batches = [tuple(a[:SPILL_ROWS] for a in b)
               for b in batches[:SPILL_BATCHES]]
    cfg = Configuration()
    cfg.set(StateOptions.BACKEND, "spill")

    # the configured route, then the backend it builds with the path's
    # budget (make_keyed_backend takes none, as JAX's)
    routed = make_keyed_backend(cfg)
    check(type(routed) is SpillKeyedStateBackend,
          f"path 44: state.backend spill made {type(routed).__name__}")
    routed.close()

    def make(spill=True):
        be = (SpillKeyedStateBackend(None, mem_budget=SPILL_BUDGET) if spill
              else HeapKeyedStateBackend())
        op = KeyedProcessOperator(process_function(), "kw", backend=be)
        op.open(RuntimeContext())
        return op, be

    def bits(out):
        return [(b.column("k").tobytes(), b.column("window_start").tobytes(),
                 b.column("result").tobytes(), b.column("count").tobytes())
                for b in out]

    op, be = make()
    reset_launches()
    calls, sizes = [], []
    t0 = time.perf_counter()
    with timed_calls(KeyedProcessOperator, "process_watermark", calls,
                     lambda: sizes.append((be.store.mem_used(),
                                           be.store.log_bytes()))):
        fired, snap = process_drive(op, batches,
                                    snap_after=SPILL_SNAPSHOT_AFTER)
    wall = time.perf_counter() - t0
    fire_ms = [ms for ms, out in calls if out]
    # the store before the end of input's fire, when it holds every key
    resident, log = sizes[-1]
    launches = read_launches()
    check(all(v == 0 for v in launches.values()),
          f"path 44: launches {launches}; the spill tier is host C")
    heap, _ = make(spill=False)
    twin, _ = process_drive(heap, batches)
    check(bits(fired) == bits(twin) and fired, "path 44: the spill backend's "
          "fires differ from the heap's (path 36's backend) in their bits")
    check_fires(fired, reference(batches), "path 44")
    # the snapshot restored into a fresh backend, made durable and
    # compacted with every key in it, then replayed
    rop, rbe = make()
    r0 = time.perf_counter()
    rop.restore_state(snap)
    restore_ms = (time.perf_counter() - r0) * 1e3
    p0 = time.perf_counter()
    rbe.persist()
    persist_ms = (time.perf_counter() - p0) * 1e3
    c0 = time.perf_counter()
    reclaimed = rbe.compact()
    compact_ms = (time.perf_counter() - c0) * 1e3
    rest, _ = process_drive(rop, batches, start=SPILL_SNAPSHOT_AFTER)
    check(bits(rest) == bits(fired), "path 44: the replay from the snapshot "
          f"after batch {SPILL_SNAPSHOT_AFTER} differs from the run")
    n = sum(len(b[0]) for b in batches)
    p50, p99 = np.percentile(fire_ms, [50, 99])
    print(f"path 44: KeyedProcessOperator on the spill backend "
          f"(state.backend spill, an {SPILL_BUDGET >> 20} MiB budget; host C "
          f"and numpy, the card idle) over {len(batches)} batches: {n} "
          f"records in {wall:.3f} s = {n / wall:.1f} records/s; fire p50/p99 "
          f"{p50:.1f}/{p99:.1f} ms over {len(fire_ms)} firing calls; before "
          f"the fires {resident} B resident "
          f"and {log} B of log; the fires equal the heap backend's bit for "
          f"bit and the reference (rtol {RTOL}); the snapshot after batch "
          f"{SPILL_SNAPSHOT_AFTER} restored ({restore_ms:.1f} ms) into a "
          f"fresh backend, persisted ({persist_ms:.1f} ms) and compacted "
          f"({compact_ms:.1f} ms, {reclaimed} B reclaimed) replays bit for "
          f"bit; launches "
          f"{launches}; {card}")
    for o in (op, rop):
        o.close()
    return launches, {"records_per_s": n / wall, "resident_bytes": resident,
                      "log_bytes": log, "persist_ms": persist_ms,
                      "compact_ms": compact_ms}


def slice17(device, card, batches):
    """Paths 40-44: the rest of the local job path and the DataStream
    routes."""
    t0 = time.perf_counter()
    launches, numbers = {}, {}
    t1 = time.perf_counter()
    launches["path 40"], numbers["path 40"] = path40(device, card, batches)
    print(f"path 40 took {time.perf_counter() - t1:.1f} s of command time")
    t1 = time.perf_counter()
    launches["path 41"], numbers["path 41"] = path41(
        device, card, batches, make_session_batches())
    print(f"path 41 took {time.perf_counter() - t1:.1f} s of command time")
    t1 = time.perf_counter()
    launches["path 42"], numbers["path 42"] = path42(device, card,
                                                     make_cep_batches())
    print(f"path 42 took {time.perf_counter() - t1:.1f} s of command time")
    t1 = time.perf_counter()
    launches["path 43"], numbers["path 43"] = path43(device, card, batches)
    print(f"path 43 took {time.perf_counter() - t1:.1f} s of command time")
    t1 = time.perf_counter()
    launches["path 44"], numbers["path 44"] = path44(card, batches)
    print(f"path 44 took {time.perf_counter() - t1:.1f} s of command time")
    print(f"slice 17 took {time.perf_counter() - t0:.1f} s of command time")
    return launches, numbers


# ---------------------------------------------------------------------------
# slice 18: the batch side (paths 45-47)
# ---------------------------------------------------------------------------

SLICE18 = ("path 45", "path 46", "path 47")
#: TPC-H at this scale factor (dbgen's sizes: 150,000 customers and
#: 1,500,000 orders a unit, 1-7 lines an order)
TPCH_SF = 1.0
TPCH_SEED = 45
#: Q3's substitution parameters (the TPC-H specification's defaults)
TPCH_SEGMENT = "BUILDING"
TPCH_DATE = int(np.datetime64("1995-03-15", "D").astype(np.int64))
TPCH_SEGMENTS = np.asarray(["AUTOMOBILE", "BUILDING", "FURNITURE",
                            "HOUSEHOLD", "MACHINERY"])
#: the batch runtime's row budget on path 45: Q3's filtered inputs to the
#: lineitem join are ~3.4 M rows at SF 1, under the default 2^22, so the
#: path halves it for that join to run out of core (grace buckets in FTB
#: files)
TPCH_BUDGET_ROWS = 1 << 21
#: revenue against the host lane and the numpy model: sums over the same
#: rows in another order
TPCH_RTOL = 1e-12
#: path 46: Graph500's Kronecker graph (path 32's generator and seed) at
#: this scale, undirected (cut from 20, then 18, for the time limit: each
#: superstep re-spills every edge through the grace join on the host)
CC_SCALE = 17
CC_MAX_SUPERSTEPS = 64
#: path 47: the keys bootstrapped and the batches of path 36's job
BOOT_KEYS = N_KEYS
BOOT_BATCHES = 8


def make_tpch(sf=None, seed=TPCH_SEED):
    """Customer, orders and lineitem columns after dbgen's distributions:
    5 market segments; sparse order keys (8 of each 32); each order's
    customer one whose key is not a multiple of 3; order dates uniform over
    1992-01-01..1998-08-02; 1-7 lines an order; ship date = order date +
    1..121 days; quantity 1..50 of a part at its retail price; discount
    0.00..0.10.  Dates are days since 1970-01-01."""
    sf = TPCH_SF if sf is None else sf
    rng = np.random.default_rng(seed)
    n_cust, n_ord = int(150_000 * sf), int(1_500_000 * sf)
    custkey = np.arange(1, n_cust + 1, dtype=np.int64)
    segment = TPCH_SEGMENTS[rng.integers(0, 5, n_cust)]
    i = np.arange(n_ord, dtype=np.int64)
    orderkey = (i // 8) * 32 + i % 8 + 1
    ordering = custkey[custkey % 3 != 0]
    o_cust = ordering[rng.integers(0, ordering.size, n_ord)]
    lo = int(np.datetime64("1992-01-01", "D").astype(np.int64))
    hi = int(np.datetime64("1998-08-02", "D").astype(np.int64))
    odate = rng.integers(lo, hi + 1, n_ord).astype(np.int64)
    lines = rng.integers(1, 8, n_ord)
    n_li = int(lines.sum())
    part = rng.integers(1, int(200_000 * sf) + 1, n_li)
    price = (90_000 + (part // 10) % 20_001 + 100 * (part % 1000)) / 100.0
    qty = rng.integers(1, 51, n_li)
    return {
        "customer": {"c_custkey": custkey, "c_mktsegment": segment},
        "orders": {"o_orderkey": orderkey, "o_custkey": o_cust,
                   "o_orderdate": odate,
                   "o_shippriority": np.zeros(n_ord, np.int64)},
        "lineitem": {
            "l_orderkey": np.repeat(orderkey, lines),
            "l_extendedprice": np.round(qty * price, 2),
            "l_discount": rng.integers(0, 11, n_li) / 100.0,
            "l_shipdate": np.repeat(odate, lines)
            + rng.integers(1, 122, n_li)},
    }


def q3_plan(env, tables):
    """TPC-H Query 3 as Flink's ``TPCHQuery3`` writes it on the DataSet
    API: the three filters, customer join orders, join lineitem, revenue
    ``l_extendedprice * (1 - l_discount)`` grouped by (l_orderkey,
    o_orderdate, o_shippriority) and summed, the 10 largest.  Returns (the
    joined rows, the top 10)."""
    seg, date = TPCH_SEGMENT, TPCH_DATE
    cust = (env.from_columns(tables["customer"])
            .filter(lambda c: c["c_mktsegment"] == seg)
            .project("c_custkey"))
    orders = (env.from_columns(tables["orders"])
              .filter(lambda c: c["o_orderdate"] < date))
    lineitem = (env.from_columns(tables["lineitem"])
                .filter(lambda c: c["l_shipdate"] > date))
    joined = (cust.join(orders).where("c_custkey").equal_to("o_custkey")
              .apply()
              .join(lineitem).where("o_orderkey").equal_to("l_orderkey")
              .apply())
    top = (joined.map(lambda c: {
               "l_orderkey": c["l_orderkey"], "o_orderdate": c["o_orderdate"],
               "o_shippriority": c["o_shippriority"],
               "revenue": c["l_extendedprice"] * (1 - c["l_discount"])})
           .group_by("l_orderkey", "o_orderdate", "o_shippriority")
           .sum("revenue")
           .sort_partition("revenue", ascending=False)
           .first_n(10))
    return joined, top


def q3_model(tables):
    """Q3 in plain numpy (``isin`` semi-joins, ``bincount`` sums; order by
    revenue descending, then order date): (l_orderkey, o_orderdate,
    o_shippriority, revenue) of the top 10, and the joined row count."""
    c, o, li = tables["customer"], tables["orders"], tables["lineitem"]
    cust = c["c_custkey"][c["c_mktsegment"] == TPCH_SEGMENT]
    om = (o["o_orderdate"] < TPCH_DATE) & np.isin(o["o_custkey"], cust)
    okey = o["o_orderkey"][om]
    lm = (li["l_shipdate"] > TPCH_DATE) & np.isin(li["l_orderkey"], okey)
    keys, inv = np.unique(li["l_orderkey"][lm], return_inverse=True)
    rev = np.bincount(inv, weights=li["l_extendedprice"][lm]
                      * (1 - li["l_discount"][lm]))
    at = np.searchsorted(okey, keys)      # order keys ascend in the table
    date, prio = o["o_orderdate"][om][at], o["o_shippriority"][om][at]
    top = np.lexsort((date, -rev))[:10]
    return (keys[top], date[top], prio[top], rev[top]), int(lm.sum())


def q3_join_keys(tables):
    """The keys of Q3's largest join: the filtered orders of the segment's
    customers against the filtered lineitem."""
    c, o, li = tables["customer"], tables["orders"], tables["lineitem"]
    lk = o["o_orderkey"][(o["o_orderdate"] < TPCH_DATE) & np.isin(
        o["o_custkey"], c["c_custkey"][c["c_mktsegment"] == TPCH_SEGMENT])]
    return lk, li["l_orderkey"][li["l_shipdate"] > TPCH_DATE]


def collect_both(top, joined):
    """``top.collect_batch()`` through the optimizer's own executor, keeping
    its memo: (the result, the joined rows it computed on the way)."""
    from flink_tpu_torch.dataset import optimizer
    optimizer._estimate(top.op)
    memo = {}
    return optimizer._exec(top.op, memo), memo[id(joined.op)]


def numeric_rows(batch):
    """A batch's rows as sorted records: a multiset, exactly."""
    names = sorted(batch.columns)
    cols = [np.asarray(batch.column(n)) for n in names]
    rec = np.empty(len(batch), [(n, c.dtype) for n, c in zip(names, cols)])
    for n, c in zip(names, cols):
        rec[n] = c
    return np.sort(rec, order=names)


def batch_bits(batch):
    return [(k, np.asarray(v).dtype.str, np.asarray(v).tobytes())
            for k, v in batch.columns.items()]


@contextlib.contextmanager
def env_vars(**values):
    """Set (or, with None, clear) environment variables for the block."""
    old = {k: os.environ.get(k) for k in values}
    for k, v in values.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = str(v)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def path45(device, card):
    """Path 45: TPC-H Query 3 at SF ``TPCH_SF`` on the DataSet API, the
    joins on the card (``FLINK_TPU_DEVICE_JOIN=1``), the lineitem join out
    of core under ``TPCH_BUDGET_ROWS``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from flink_tpu_torch.dataset import ExecutionEnvironment, external
    from flink_tpu_torch.operators.joins import _join_pairs
    from flink_tpu_torch.ops import join_kernels
    t0 = time.perf_counter()
    tables = make_tpch()
    n_li = tables["lineitem"]["l_orderkey"].size
    gen_s = time.perf_counter() - t0
    card_env = ExecutionEnvironment(device=device)
    with env_vars(FLINK_TPU_DEVICE_JOIN=1,
                  FLINK_TPU_BATCH_MEMORY_ROWS=TPCH_BUDGET_ROWS):
        joined, top = q3_plan(card_env, tables)
        sync(device)
        reset_launches()
        spilled0 = external.spilled_bytes["join"]
        join_kernels.transfer_bytes.update(h2d=0, d2h=0)
        t1 = time.perf_counter()
        result = top.collect_batch()
        sync(device)
        wall = time.perf_counter() - t1
        launches = read_launches()
        spilled = external.spilled_bytes["join"] - spilled0
        bus = dict(join_kernels.transfer_bytes)
        # the replay of the same card lane, profiled
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t2 = time.perf_counter()
            replay, card_rows = collect_both(*q3_plan(card_env, tables)[::-1])
            sync(device)
            replay_ms = (time.perf_counter() - t2) * 1e3
        streamed = list(top.stream_batches())
    with env_vars(FLINK_TPU_DEVICE_JOIN=None,
                  FLINK_TPU_BATCH_MEMORY_ROWS=TPCH_BUDGET_ROWS):
        hjoined, htop = q3_plan(ExecutionEnvironment(device=device), tables)
        t3 = time.perf_counter()
        host, host_rows = collect_both(htop, hjoined)
        host_wall = time.perf_counter() - t3
    check(all(v == 0 for v in launches.values()),
          f"path 45: launches {launches}; the join's device work is torch "
          f"ops")
    check(spilled > 0, "path 45: the lineitem join did not run out of core")
    check(batch_bits(replay) == batch_bits(result),
          "path 45: a replay of the card lane differs in its bits")
    (mkeys, mdate, mprio, mrev), n_joined = q3_model(tables)
    check(len(card_rows) == len(host_rows) == n_joined
          and np.array_equal(numeric_rows(card_rows),
                             numeric_rows(host_rows)),
          f"path 45: the joined rows ({len(card_rows)}) differ from the "
          f"host lane's ({len(host_rows)}) as a multiset, or from the "
          f"model's count ({n_joined})")
    cols = ("l_orderkey", "o_orderdate", "o_shippriority")
    rev = np.asarray(result.column("revenue"))
    for name, other, want_rev in (("the host lane", host, None),
                                  ("the numpy model", None, mrev)):
        for c, m in zip(cols, (mkeys, mdate, mprio)):
            want = (np.asarray(other.column(c)) if other is not None else m)
            check(np.array_equal(np.asarray(result.column(c)), want),
                  f"path 45: {c} of the top 10 differs from {name}'s")
        wrev = (np.asarray(other.column("revenue")) if other is not None
                else want_rev)
        check(np.allclose(rev, wrev, rtol=TPCH_RTOL, atol=0),
              f"path 45: revenue differs from {name}'s beyond rtol "
              f"{TPCH_RTOL}: {rev} vs {wrev}")
    s_rows = [b for b in streamed if len(b)]
    check(len(s_rows) == 1 and [c for c, _, _ in batch_bits(s_rows[0])]
          == [c for c, _, _ in batch_bits(result)]
          and all(np.array_equal(np.asarray(s_rows[0].column(c)),
                                 np.asarray(result.column(c)))
                  for c in cols)
          and np.allclose(np.asarray(s_rows[0].column("revenue")), rev,
                          rtol=TPCH_RTOL, atol=0),
          "path 45: stream_batches() differs from collect_batch()")
    # the largest join: the card against the host
    lk, rk = q3_join_keys(tables)
    card_ms = cuda_time_ms(lambda: join_kernels.device_join_pairs(
        lk, rk, device), 5)
    host_join_ms = host_ms(lambda: _join_pairs(lk, rk, device), 3)
    busy_ms, busy, n_ops, _ = profiled_busy(prof, replay_ms)
    sync(device)
    numbers = {"lineitem_rows_per_s": n_li / wall, "wall_s": wall,
               "host_lane_wall_s": host_wall, "join_card_ms": card_ms,
               "join_host_ms": host_join_ms, "spilled_bytes": spilled,
               "busy_share": busy}
    top_rows = [(int(k), int(d), round(float(r), 2)) for k, d, r in zip(
        result.column("l_orderkey"), result.column("o_orderdate"), rev)]
    print(f"path 45: TPC-H Q3 at SF {TPCH_SF} on the DataSet API (customer "
          f"{tables['customer']['c_custkey'].size}, orders "
          f"{tables['orders']['o_orderkey'].size}, lineitem {n_li} rows, "
          f"made in {gen_s:.2f} s; segment {TPCH_SEGMENT}, date 1995-03-15),"
          f" the joins on the card, row budget {TPCH_BUDGET_ROWS}: "
          f"{len(card_rows)} joined rows, the query in {wall:.3f} s = "
          f"{n_li / wall:.1f} lineitem rows/s (host lane {host_wall:.3f} s);"
          f" the lineitem join out of core: {spilled} B of FTB bucket files;"
          f" bus {bus['h2d']} B h2d, {bus['d2h']} B d2h; the largest join "
          f"({lk.size} x {rk.size} keys) {card_ms:.3f} ms on the card (CUDA "
          f"events, uploads and download included) vs {host_join_ms:.3f} ms"
          f" on the host lane; a profiled replay of the card lane "
          f"({replay_ms:.1f} ms): the card busy {busy_ms:.3f} ms = "
          f"{100 * busy:.3f}% ({n_ops} device ops); top 10 (orderkey, date, "
          f"revenue) {top_rows[:3]}...; joined rows equal the host lane's "
          f"as a multiset, keys and order of the result exact against the "
          f"host lane and the numpy model, revenue to rtol {TPCH_RTOL}, a "
          f"replay bit for bit, stream_batches() equal; launches {launches};"
          f" {card}")
    return launches, numbers


def path46(device, card):
    """Path 46: ConnectedComponents on the DataSet API (Flink's
    ``ConnectedComponents`` example), a delta iteration over Graph500's
    Kronecker graph at scale ``CC_SCALE``, undirected, whose edges come
    from the card through ``Graph.as_dataset``."""
    import scipy.sparse as sp

    from flink_tpu_torch.dataset import ExecutionEnvironment
    from flink_tpu_torch.graph_lib import Graph
    from flink_tpu_torch.ops import join_kernels
    n = 1 << CC_SCALE
    src, dst, _ = rmat_edges(CC_SCALE, GRAPH_EDGE_FACTOR, GRAPH_SEED, device)
    g = Graph(n, src, dst, device=device).undirected()
    del src, dst
    t0 = time.perf_counter()
    edges = g.as_dataset()
    env = edges.env
    as_dataset_s = time.perf_counter() - t0
    E = g.num_edges
    vertices = np.arange(n, dtype=np.int64)
    steps = []

    def step(solution, workset):
        t = time.perf_counter()
        cand = (workset.join(edges).where("v").equal_to("src").apply()
                .map(lambda c: {"v": c["dst"].astype(np.int64),
                                "label": c["label"]})
                .group_by("v").min("label"))
        changes = (cand.join(solution).where("v").equal_to("v").apply()
                   .filter(lambda c: c["label"] < c["r_label"])
                   .project("v", "label")).collect_batch()
        b = env.from_columns(dict(changes.columns))
        steps.append((len(workset.op.args["batch"]), len(changes),
                      time.perf_counter() - t))
        return b, b

    with env_vars(FLINK_TPU_DEVICE_JOIN=1):
        init = env.from_columns({"v": vertices, "label": vertices})
        sync(device)
        reset_launches()
        t1 = time.perf_counter()
        sol = init.delta_iterate(init, "v", CC_MAX_SUPERSTEPS, step) \
            .collect_batch()
        sync(device)
        wall = time.perf_counter() - t1
        launches = read_launches()
        # the first superstep's join: the whole workset against every edge
        lk, rk = vertices, edges.op.args["batch"].column("src")
        card_ms = cuda_time_ms(lambda: join_kernels.device_join_pairs(
            lk, rk, device), 3)
    check(all(v == 0 for v in launches.values()),
          f"path 46: launches {launches}; the join's device work is torch "
          f"ops")
    check(len(steps) < CC_MAX_SUPERSTEPS and steps[-1][1] == 0,
          f"path 46: no convergence in {CC_MAX_SUPERSTEPS} supersteps")
    labels = np.full(n, -1, np.int64)
    labels[np.asarray(sol.column("v"))] = np.asarray(sol.column("label"))
    t2 = time.perf_counter()
    comps = g.connected_components()
    wcc_s = time.perf_counter() - t2
    check(np.array_equal(labels, np.asarray(comps, np.int64)),
          f"path 46: labels differ from Graph.connected_components on the "
          f"card ({int((labels != comps).sum())} vertices)")
    s_h, d_h = g._np("src"), g._np("dst")
    adj = sp.csr_matrix((np.ones(E, np.int8), (s_h, d_h)), shape=(n, n))
    want = wcc_model(adj, n)
    check(np.array_equal(labels, want),
          f"path 46: labels differ from scipy's connected_components "
          f"({int((labels != want).sum())} vertices)")
    ncomp = np.unique(labels).size
    numbers = {"supersteps": len(steps), "wall_s": wall,
               "edges_per_s": E * len(steps) / wall, "join_card_ms": card_ms}
    print(f"path 46: ConnectedComponents (delta iteration: workset join "
          f"edges, group-by min, join the solution set, filter) on Graph500 "
          f"scale {CC_SCALE} undirected ({n} vertices, {E} edges, as_dataset "
          f"{as_dataset_s:.3f} s), the joins on the card: {len(steps)} "
          f"supersteps in {wall:.3f} s = {E * len(steps) / wall:.4e} edges/s"
          f"; worksets {[w for w, _, _ in steps]}, superstep s "
          f"{[round(s, 2) for _, _, s in steps]}; {ncomp} components; the "
          f"first superstep's join ({lk.size} x {rk.size} keys) "
          f"{card_ms:.3f} ms on the card (CUDA events, uploads and download "
          f"included); labels equal Graph.connected_components on the card "
          f"({wcc_s:.3f} s) and scipy's connected_components exactly; "
          f"launches {launches}; {card}")
    return launches, numbers


def window_snapshot(device, batches, label):
    """Path ``label``'s operator over ``batches`` with a watermark after
    each and no end of input: (its snapshot inside the open window, the
    launches)."""
    from flink_tpu_torch.core.batch import RecordBatch, Watermark
    from flink_tpu_torch.runtime import device_health
    device_health.set_monitor(device_health.DeviceHealthMonitor())
    op = build_op(device, **PATHS[label])
    for keys, vals, ts in batches:
        op.process_batch(RecordBatch({"k": keys, "v": vals}, timestamps=ts))
        op.process_watermark(Watermark(int(ts.max()) - 1))
    op.prepare_snapshot_pre_barrier()
    return op.snapshot_state()


def dir_bytes(path) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(path) for f in fs)


def path47(device, card, batches):
    """Path 47: the State Processor API over the main path's state: path 5's
    and path 14's snapshots inside a window through ``FileCheckpointStorage``
    and ``read_window_state``; ``BOOT_KEYS`` keys bootstrapped into path
    36's job on ``LocalExecutor``."""
    import tempfile

    from flink_tpu_torch.dataset import ExecutionEnvironment
    from flink_tpu_torch.datastream import StreamExecutionEnvironment
    from flink_tpu_torch.runtime.checkpoint import FileCheckpointStorage
    from flink_tpu_torch.state.api import ValueStateDescriptor
    from flink_tpu_torch.state_processor import Savepoint, SavepointWriter
    sync(device)
    reset_launches()
    snaps = {label: window_snapshot(device, batches, label)
             for label in ("path 5", "path 14")}
    sync(device)
    launches = read_launches()
    open_w = int(batches[-1][2].max()) // WINDOW_MS * WINDOW_MS
    check(all(b[2].max() < open_w or b[2].min() >= open_w for b in batches),
          "path 47: a batch straddles the open window's start")
    tmp = tempfile.mkdtemp(prefix="chip-smoke-savepoint-")
    store = FileCheckpointStorage(tmp)
    t0 = time.perf_counter()
    store.store(1, snaps)
    store_ms = (time.perf_counter() - t0) * 1e3
    sp_bytes = dir_bytes(tmp)
    t1 = time.perf_counter()
    reader = Savepoint.load(FileCheckpointStorage(tmp), 1, device=device)
    load_ms = (time.perf_counter() - t1) * 1e3
    open_batches = [b for b in batches if b[2].min() >= open_w]
    cells = reference_f32(open_batches)[open_w]
    expect = reference(open_batches)[open_w]
    read = {}
    for label in ("path 5", "path 14"):
        t2 = time.perf_counter()
        rows = reader.read_window_state(label).collect_batch()
        read_s = time.perf_counter() - t2
        sums = reader.read_window_state(label).group_by("key") \
            .sum("acc0").collect_batch()
        keys = np.asarray(sums.column("key"))
        got = np.asarray(sums.column("acc0"))
        check(np.array_equal(np.sort(keys), np.nonzero(expect[1])[0])
              and np.array_equal(np.asarray(rows.column("count"))[
                  np.argsort(np.asarray(rows.column("key")))],
                  expect[1][np.sort(keys)]),
              f"path 47 {label}: the open window's keys or counts differ "
              f"from the reference")
        if label == "path 5":
            check(got.dtype == np.float32 and np.array_equal(
                got.view(np.uint32), cells[keys].view(np.uint32)),
                  "path 47 path 5: the open window's sums differ from the "
                  "f32 record-order reference in their bits")
        else:
            check(np.allclose(got, expect[0][keys], rtol=RTOL),
                  "path 47 path 14: the open window's sums differ from the "
                  f"reference beyond rtol {RTOL}")
        read[label] = (len(rows), read_s)
    # bootstrap path 36's count state for window 0's composite keys
    rng = np.random.default_rng(47)
    boot = rng.integers(1, 100, BOOT_KEYS).astype(np.int64)
    benv = ExecutionEnvironment(device=device)
    seed_ds = benv.from_columns({"kw": np.arange(BOOT_KEYS, dtype=np.int64),
                                 "count": boot})
    t3 = time.perf_counter()
    writer = SavepointWriter.new_savepoint().with_keyed_state(
        "proc", seed_ds, "kw", "count", "count",
        descriptor=ValueStateDescriptor("count", dtype=np.int64, default=0))
    boot_s = time.perf_counter() - t3
    boot_dir = tempfile.mkdtemp(prefix="chip-smoke-bootstrap-")
    t4 = time.perf_counter()
    writer.write(FileCheckpointStorage(boot_dir))
    boot_store_ms = (time.perf_counter() - t4) * 1e3
    boot_bytes = dir_bytes(boot_dir)
    job_batches = batches[:BOOT_BATCHES]

    def job(restore):
        env = StreamExecutionEnvironment(device=device)
        ts = np.concatenate([b[2] for b in job_batches])
        kw = (ts // WINDOW_MS) << KEY_BITS | np.concatenate(
            [b[0] for b in job_batches])
        sink = (env.from_collection(columns={
                    "kw": kw, "v": np.concatenate([b[1] for b in job_batches]),
                    "ts": ts}, batch_size=BATCH)
                .assign_timestamps_and_watermarks(0, timestamp_column="ts")
                .key_by("kw").process(process_function(), name="proc")
                .collect())
        snap = None
        if restore:
            plan = env.get_stream_graph().to_plan()
            uid = next(v.uid for v in plan.vertices if "proc" in v.name)
            snap = {uid: Savepoint.load(FileCheckpointStorage(boot_dir),
                                        device=device).raw("proc")}
        t = time.perf_counter()
        env.execute(restore=snap)
        wall = time.perf_counter() - t
        rows = sink.rows()
        k = np.asarray([r["k"] for r in rows], np.int64)
        w = np.asarray([r["window_start"] for r in rows], np.int64)
        order = np.lexsort((k, w))
        return ({c: np.asarray([r[c] for r in rows])[order]
                 for c in ("k", "window_start", "result", "count")}, wall)

    plain, plain_s = job(False)
    booted, boot_job_s = job(True)
    w0 = booted["window_start"] == 0
    want_count = plain["count"] + np.where(w0, boot[booted["k"]], 0)
    check(np.array_equal(booted["k"], plain["k"])
          and np.array_equal(booted["window_start"], plain["window_start"])
          and booted["result"].tobytes() == plain["result"].tobytes()
          and np.array_equal(booted["count"], want_count),
          "path 47: the bootstrapped job's fires differ from the plain run's "
          "plus the bootstrap values")
    n_boot = int(w0.sum())
    numbers = {"read_rows_per_s": {k: n / s for k, (n, s) in read.items()},
               "boot_rows_per_s": BOOT_KEYS / boot_s,
               "store_ms": store_ms, "load_ms": load_ms,
               "savepoint_bytes": sp_bytes}
    print(f"path 47: the State Processor API over the main path's state: "
          f"path 5's and path 14's operators over {len(batches)} batches "
          f"(snapshots inside window {open_w}) stored through "
          f"FileCheckpointStorage in {store_ms:.1f} ms ({sp_bytes} B), "
          f"loaded in {load_ms:.1f} ms; read_window_state "
          + ", ".join(f"{k} {n} rows in {s:.3f} s = {n / s:.1f} rows/s"
                      for k, (n, s) in read.items())
          + f"; group_by(key).sum(acc0) equals the open window's f32 "
          f"record-order reference bit for bit (path 5) and the reference to"
          f" rtol {RTOL} (path 14); {BOOT_KEYS} keys bootstrapped in "
          f"{boot_s:.3f} s = {BOOT_KEYS / boot_s:.1f} rows/s, written in "
          f"{boot_store_ms:.1f} ms ({boot_bytes} B) and restored into path "
          f"36's job on LocalExecutor over {len(job_batches)} batches "
          f"({boot_job_s:.3f} s; the plain job {plain_s:.3f} s): its "
          f"{len(booted['k'])} fires equal the plain run's plus the bootstrap"
          f" values ({n_boot} of window 0's); launches {launches}; {card}")
    import shutil
    shutil.rmtree(tmp, ignore_errors=True)
    shutil.rmtree(boot_dir, ignore_errors=True)
    return launches, numbers


def slice18(device, card, batches):
    """Paths 45-47: the batch side."""
    t0 = time.perf_counter()
    launches, numbers = {}, {}
    for label, fn in (("path 45", lambda: path45(device, card)),
                      ("path 46", lambda: path46(device, card)),
                      ("path 47", lambda: path47(device, card, batches))):
        t1 = time.perf_counter()
        launches[label], numbers[label] = fn()
        print(f"{label} took {time.perf_counter() - t1:.1f} s of command "
              f"time")
    print(f"slice 18 took {time.perf_counter() - t0:.1f} s of command time")
    return launches, numbers


# ---------------------------------------------------------------------------
# slice 19: the SQL stack (paths 48-50)
# ---------------------------------------------------------------------------

SLICE19 = ("path 48", "path 49", "path 50")
#: path 48: ``BASELINE.json`` config 5 at ``bench.py`` ``run_config5``'s
#: full size, its queries verbatim
LINEITEM_ROWS = 1 << 22
LINEITEM_SEED = 19
LINEITEM_BATCH = 1 << 17
CONFIG5_TUMBLE_SQL = (
    "SELECT l_returnflag, "
    "TUMBLE_START(ts, INTERVAL '5' SECOND) AS ws, "
    "SUM(l_extendedprice * (1 - l_discount)) AS revenue, "
    "SUM(l_quantity) AS qty, COUNT(*) AS n FROM lineitem "
    "GROUP BY l_returnflag, TUMBLE(ts, INTERVAL '5' SECOND)")
CONFIG5_HOP_SQL = (
    "SELECT l_returnflag, "
    "HOP_START(ts, INTERVAL '5' SECOND, INTERVAL '60' SECOND) AS ws, "
    "SUM(l_extendedprice * (1 - l_discount)) AS revenue, "
    "COUNT(*) AS n FROM lineitem "
    "GROUP BY l_returnflag, "
    "HOP(ts, INTERVAL '5' SECOND, INTERVAL '60' SECOND)")
#: the queries' windows (ms)
CONFIG5_TUMBLE_MS = 5000
CONFIG5_HOP = (5000, 60_000)            # slide, size
#: path 49: the north star's tumbling sum as SQL
#: path 49's depth: the main stream's first 12 batches (24 before slice
#: 22: its 3.57 M result rows as Python dicts took 21 s of PR 22's call 2)
SQL_BATCHES = 12
EVENTS_SQL = (
    "SELECT k, TUMBLE_START(ts, INTERVAL '5' SECOND) AS ws, SUM(v) AS s, "
    "COUNT(*) AS n FROM events GROUP BY k, TUMBLE(ts, INTERVAL '5' SECOND)")
#: path 50: TPC-H Query 3 in the dialect the planner takes (explicit JOIN
#: ... ON, the date as its day number), the specification's parameters
Q3_SQL = (
    "SELECT l_orderkey, SUM(l_extendedprice * (1 - l_discount)) AS revenue, "
    "o_orderdate, o_shippriority FROM customer "
    "JOIN orders ON c_custkey = o_custkey "
    "JOIN lineitem ON l_orderkey = o_orderkey "
    f"WHERE c_mktsegment = '{TPCH_SEGMENT}' AND o_orderdate < {TPCH_DATE} "
    f"AND l_shipdate > {TPCH_DATE} "
    "GROUP BY l_orderkey, o_orderdate, o_shippriority "
    "ORDER BY revenue DESC, o_orderdate LIMIT 10")
#: path 50b's events: the first quarter of path 26's first batch (the
#: whole batch before slice 22: the interpreted engine and its CPU twin took
#: 34 s of path 50's 38 s in PR 22's call 2)
MATCH_EVENTS = CEP_BATCH // 4
#: path 50b: a small amount then a large one on the same key, next to each
#: other (SQL's strict contiguity), within 20 s; no PREV in the DEFINE
MATCH_SQL = (
    "SELECT k, a_e, b_e FROM events MATCH_RECOGNIZE (PARTITION BY k "
    "ORDER BY ts MEASURES A.e AS a_e, B.e AS b_e "
    "AFTER MATCH SKIP PAST LAST ROW PATTERN (A B) "
    "WITHIN INTERVAL '20' SECOND DEFINE A AS v < 30, B AS v > 570)")


def lineitem(n: int, seed: int = LINEITEM_SEED):
    """Copy of ``bench.py`` ``_lineitem``: a TPC-H-like lineitem stream
    (return flag A/N/R, quantity 1-50, price, discount, sorted ts over two
    minutes)."""
    rng = np.random.default_rng(seed)
    flags = np.asarray(["A", "N", "R"], object)
    return {
        "l_returnflag": flags[rng.integers(0, 3, n)],
        "l_quantity": rng.integers(1, 51, n).astype(np.float64),
        "l_extendedprice": (rng.random(n) * 1000).astype(np.float64),
        "l_discount": (rng.random(n) * 0.1).astype(np.float64),
        "ts": np.sort(rng.integers(0, 120_000, n)).astype(np.int64),
    }


def config5_model(cols, hop: bool):
    """Config 5's answer in numpy: (flag, window start) -> (count, f64
    revenue, f64 quantity), every window covering each row (one for
    TUMBLE, size/slide for HOP)."""
    flags = np.asarray(["A", "N", "R"], object)
    f = np.searchsorted(flags.astype(str), cols["l_returnflag"].astype(str))
    ts = cols["ts"]
    rev = cols["l_extendedprice"] * (1 - cols["l_discount"])
    slide, size = CONFIG5_HOP if hop else (CONFIG5_TUMBLE_MS,) * 2
    model = {}
    for j in range(size // slide):
        start = (ts // slide - j) * slide
        keys, inv = np.unique(f * (1 << 40) + start + (1 << 39),
                              return_inverse=True)
        n = np.bincount(inv)
        r = np.bincount(inv, weights=rev)
        q = np.bincount(inv, weights=cols["l_quantity"])
        for key, a, b, c in zip(keys.tolist(), n.tolist(), r.tolist(),
                                q.tolist()):
            fk, w = divmod(key, 1 << 40)
            m = model.setdefault((flags[fk], w - (1 << 39)), [0, 0.0, 0.0])
            m[0] += a
            m[1] += b
            m[2] += c
    return model


def check_config5(label, rows, model, hop):
    """Every (flag, window) once; COUNT(*) exact, the f32 sums within
    ``n * U32`` of the model's f64 sums of their n records."""
    got = {(r["l_returnflag"], r["ws"]): r for r in rows}
    check(len(got) == len(rows) == len(model) and set(got) == set(model),
          f"{label}: {len(rows)} rows, the model {len(model)} groups")
    worst = 0.0
    for key, (n, rev, qty) in model.items():
        r = got[key]
        check(int(r["n"]) == n, f"{label} {key}: COUNT(*) {r['n']} != {n}")
        sums = [("revenue", rev)] + ([] if hop else [("qty", qty)])
        for name, want in sums:
            err = abs(r[name] - want)
            check(err <= n * U32 * want,
                  f"{label} {key}: {name} {r[name]} vs the model's {want} "
                  f"over {n} records")
            worst = max(worst, err / (n * U32 * want))
    return worst


@contextlib.contextmanager
def window_lane(pins):
    """Every ``WindowAggOperator`` built inside the block takes ``pins``
    (another run's resolved lane, ``twin_options``): a CPU twin of a query
    runs the card's lane, so its sums are the same adds in the same
    order.  None pins nothing."""
    from flink_tpu_torch.operators.window_agg import WindowAggOperator
    orig = WindowAggOperator.__init__

    def pinned(self, *args, **kwargs):
        orig(self, *args, **{**kwargs, **pins})

    if pins is not None:
        WindowAggOperator.__init__ = pinned
    try:
        yield
    finally:
        WindowAggOperator.__init__ = orig


def sql_run(device, tables, sql, batch_size, rowtime=None, pins=None,
            **tenv_options):
    """``sql`` on ``TableEnvironment(device=device)`` over ``tables``
    (name -> columns), planned, executed and collected in the timed
    region (``bench.py``'s): (rows, wall s, launches, the result)."""
    from flink_tpu_torch.sql import TableEnvironment
    tenv = TableEnvironment(device=device, **tenv_options)
    for name, cols in tables.items():
        tenv.register_collection(name, columns=cols, rowtime=rowtime,
                                 batch_size=batch_size)
    with window_lane(pins):
        sync(device)
        reset_launches()
        t0 = time.perf_counter()
        res = tenv.execute_sql(sql)
        rows = res.collect()
        sync(device)
        wall = time.perf_counter() - t0
        launches = read_launches()
    return rows, wall, launches, res


def path48(device, card):
    """Path 48: ``BASELINE.json`` config 5, SQL TUMBLE and HOP over the
    lineitem stream at ``run_config5``'s full size."""
    import torch

    from flink_tpu_torch.operators.window_agg import WindowAggOperator
    cols = lineitem(LINEITEM_ROWS)
    table = {"lineitem": cols}
    cpu = torch.device("cpu")
    launches, numbers = {}, {}
    for name, sql, hop in (("tumble", CONFIG5_TUMBLE_SQL, False),
                           ("hop", CONFIG5_HOP_SQL, True)):
        rows, wall, ln, res = sql_run(device, table, sql, LINEITEM_BATCH,
                                      rowtime="ts")
        op = job_operator(res.env, WindowAggOperator)
        lane = lane_of(op)
        check(op.device.type == "cuda", f"path 48 {name}: the window "
              f"operator runs on {op.device}")
        check(ln["scatter_fold"] > 0, f"path 48 {name}: launches {ln}")
        worst = check_config5(f"path 48 {name}", rows,
                              config5_model(cols, hop), hop)
        twin, twin_wall, twin_ln, _ = sql_run(
            cpu, table, sql, LINEITEM_BATCH, rowtime="ts",
            pins=twin_options(lane))
        check(twin == rows, f"path 48 {name}: the rows differ from the CPU "
              f"twin's (the same lane on the CPU)")
        launches[name] = ln
        numbers[name] = {"rows_per_s": LINEITEM_ROWS / wall, "wall_s": wall,
                         "result_rows": len(rows), "lane": lane,
                         "twin_wall_s": twin_wall}
        print(f"path 48 {name}: config 5 ({LINEITEM_ROWS} lineitem rows, "
              f"batches of {LINEITEM_BATCH}) planned, executed and collected"
              f" in {wall:.3f} s = {LINEITEM_ROWS / wall:.1f} rows/s; "
              f"{len(rows)} rows, COUNT(*) exact and the sums within "
              f"n * 2^-24 of the numpy model's f64 sums (worst at "
              f"{worst:.3f} of the bound), every row equal to the CPU "
              f"twin's bit for bit ({twin_wall:.3f} s); the window lane "
              f"{json.dumps(lane, sort_keys=True)}; launches {ln}; {card}")
        print(f"path 48 {name} phase_ns: "
              + json.dumps(op.phase_ns, sort_keys=True))
    t, h = numbers["tumble"], numbers["hop"]
    print(f"path 48: hop/tumble rows/s {h['rows_per_s'] / t['rows_per_s']:.3f}"
          f" ({h['rows_per_s']:.1f} vs {t['rows_per_s']:.1f}); {card}")
    total = {k: launches["tumble"][k] + launches["hop"][k]
             for k in launches["tumble"]}
    return total, numbers


def path49(device, card, batches, earlier):
    """Path 49: the north star's tumbling sum through SQL: the smoke's main
    batches (its first ``SQL_BATCHES``) as a collection table,
    ``EVENTS_SQL``, held to ``reference`` and ``reference_f32`` of those
    batches."""
    from flink_tpu_torch.operators.window_agg import WindowAggOperator
    expect, cells = reference(batches), reference_f32(batches)
    n_records = sum(len(b[0]) for b in batches)
    rows, wall, ln, res = sql_run(device, {"events": stream_columns(batches)},
                                  EVENTS_SQL, BATCH, rowtime="ts")
    op = job_operator(res.env, WindowAggOperator)
    lane = lane_of(op)
    check(op.device.type == "cuda", f"path 49: the window operator runs on "
          f"{op.device}")
    t0 = time.perf_counter()
    k = np.fromiter((r["k"] for r in rows), np.int64, len(rows))
    ws = np.fromiter((r["ws"] for r in rows), np.int64, len(rows))
    s = np.fromiter((r["s"] for r in rows), np.float64, len(rows))
    n = np.fromiter((r["n"] for r in rows), np.float64, len(rows))
    check(set(np.unique(ws).tolist()) == set(expect),
          f"path 49: ws {sorted(set(ws.tolist()))} != the windows' starts "
          f"{sorted(expect)}")
    bits = lane["emit_tier"] == "device"
    for w, (sums, cnt) in expect.items():
        m = ws == w
        keys = k[m]
        order = np.argsort(keys)
        check(np.array_equal(keys[order], np.flatnonzero(cnt)),
              f"path 49 window {w}: the keys differ from the reference's")
        check(np.array_equal(n[m], cnt[keys].astype(np.float64)),
              f"path 49 window {w}: COUNT(*) differs from the reference's")
        if bits:
            got = s[m].astype(np.float32)
            check(np.array_equal(got.view(np.uint32),
                                 cells[w][keys].view(np.uint32)),
                  f"path 49 window {w}: SUM(v) differs from the f32 ordered "
                  f"reference in its bits")
        else:
            check(np.allclose(s[m], sums[keys], rtol=RTOL, atol=0),
                  f"path 49 window {w}: SUM(v) differs from the reference "
                  f"beyond rtol {RTOL}")
    check_s = time.perf_counter() - t0
    check(ln["scatter_fold"] > 0, f"path 49: launches {ln}")
    rps = n_records / wall
    p5 = earlier["path 5"]["records_per_s"]
    p40 = earlier["path 40"]["40a"]["records_per_s"]
    print(f"path 49: {EVENTS_SQL!r} over the main stream ({n_records} "
          f"records, {len(batches)} batches of {BATCH}) planned, executed "
          f"and collected in {wall:.3f} s = {rps:.1f} records/s, beside path"
          f" 5 (the operator driven directly) {p5:.1f} ({rps / p5:.3f}x) "
          f"and path 40a (a DataStream job) {p40:.1f} ({rps / p40:.3f}x); "
          f"{len(rows)} rows: ws the windows' starts, COUNT(*) exact, SUM(v) "
          + ("equal to the f32 ordered reference bit for bit" if bits else
             f"within rtol {RTOL} of the reference")
          + f" (checked in {check_s:.1f} s); the window lane "
          f"{json.dumps(lane, sort_keys=True)}; launches {ln}; {card}")
    print("path 49 phase_ns: " + json.dumps(op.phase_ns, sort_keys=True))
    return ln, {"records_per_s": rps, "wall_s": wall,
                "result_rows": len(rows), "lane": lane}


def check_q3_rows(label, rows, tables):
    """Q3's rows against ``q3_model``: the top 10's keys, dates and
    priorities exactly, each revenue (an f32 sum of the group's n lines:
    each line rounds once into f32, each of the n - 1 adds once) within
    ``2 n U32`` of the model's f64 sum."""
    (keys, date, prio, rev), _ = q3_model(tables)
    check([r["l_orderkey"] for r in rows] == keys.tolist()
          and [r["o_orderdate"] for r in rows] == date.tolist()
          and [r["o_shippriority"] for r in rows] == prio.tolist(),
          f"{label}: the top 10 differ from the numpy model's: "
          f"{[r['l_orderkey'] for r in rows]} vs {keys.tolist()}")
    _, rk = q3_join_keys(tables)
    lines = np.asarray([int((rk == k).sum()) for k in keys.tolist()])
    got = np.asarray([r["revenue"] for r in rows])
    check(np.all(np.abs(got - rev) <= 2 * lines * U32 * rev),
          f"{label}: revenue {got} vs the model's {rev} beyond 2 n 2^-24")


def path50(device, card, earlier):
    """Path 50: TPC-H Q3 as SQL at SF ``TPCH_SF``, the joins on the card;
    50b: MATCH_RECOGNIZE over the first ``MATCH_EVENTS`` events of path
    26's first batch."""
    import torch

    from flink_tpu_torch.cep.operator import CepOperator
    from flink_tpu_torch.ops import join_kernels
    cpu = torch.device("cpu")
    tables = make_tpch()
    n_li = tables["lineitem"]["l_orderkey"].size
    with env_vars(FLINK_TPU_DEVICE_JOIN=1):
        rows, wall, ln, _ = sql_run(device, tables, Q3_SQL, LINEITEM_BATCH)
        twin, twin_wall, _, _ = sql_run(cpu, tables, Q3_SQL, LINEITEM_BATCH)
    check(ln["scatter_fold"] > 0, f"path 50: launches {ln}")
    check(twin == rows, "path 50: the rows differ from the CPU twin's")
    check_q3_rows("path 50", rows, tables)
    lk, rk = q3_join_keys(tables)
    card_ms = cuda_time_ms(lambda: join_kernels.device_join_pairs(
        lk, rk, device), 5)
    p45 = earlier["path 45"]
    print(f"path 50: TPC-H Q3 as SQL at SF {TPCH_SF} ({n_li} lineitem rows),"
          f" the joins on the card: planned, executed and collected in "
          f"{wall:.3f} s = {n_li / wall:.1f} lineitem rows/s, beside path 45"
          f" (the DataSet API) {p45['wall_s']:.3f} s = "
          f"{p45['lineitem_rows_per_s']:.1f}; the CPU twin {twin_wall:.3f} s"
          f" with the same rows bit for bit; the top 10 equal the numpy "
          f"model's, revenue within 2 n 2^-24 (f32 sums); the largest join "
          f"({lk.size} x {rk.size} keys) {card_ms:.3f} ms on the card (CUDA "
          f"events); launches {ln}; {card}")
    # 50b: MATCH_RECOGNIZE resolves to the interpreted NFA, as in JAX
    k, v, ts = (a[:MATCH_EVENTS] for a in make_cep_batches()[0])
    events = {"events": {"k": k, "v": v, "ts": ts,
                         "e": np.arange(k.size, dtype=np.int64)}}
    matches, mwall, mln, res = sql_run(device, events, MATCH_SQL, CEP_BATCH,
                                       rowtime="ts")
    op = job_operator(res.env, CepOperator)
    engine = op.cep_stats()["engine"]
    check(engine == "interpreted", f"path 50b: the engine is {engine}")
    mtwin, _, _, _ = sql_run(cpu, events, MATCH_SQL, CEP_BATCH, rowtime="ts")
    check(matches == mtwin and len(matches) > 0,
          f"path 50b: {len(matches)} matches, the CPU twin {len(mtwin)}")
    try:
        sql_run(device, events, MATCH_SQL, CEP_BATCH, rowtime="ts",
                cep_vectorized="on")
        refused = None
    except ValueError as err:
        refused = str(err)
    check(refused is not None and "not eligible" in refused,
          "path 50b: cep_vectorized='on' did not raise")
    print(f"path 50b: MATCH_RECOGNIZE over path 26's first {k.size} "
          f"events: {len(matches)} matches in {mwall:.3f} s on the "
          f"{engine} engine, equal to the CPU twin's; cep_vectorized='on' "
          f"raises ({refused.split(':')[0]}); launches {mln}; {card}")
    total = {key: ln[key] + mln[key] for key in ln}
    return total, {"lineitem_rows_per_s": n_li / wall, "wall_s": wall,
                   "twin_wall_s": twin_wall, "join_card_ms": card_ms,
                   "matches": len(matches), "match_wall_s": mwall}


def slice19(device, card, batches, earlier):
    """Paths 48-50: the SQL stack."""
    t0 = time.perf_counter()
    launches, numbers = {}, {}
    for label, fn in (
            ("path 48", lambda: path48(device, card)),
            ("path 49", lambda: path49(device, card, batches[:SQL_BATCHES],
                                       earlier)),
            ("path 50", lambda: path50(device, card, earlier))):
        t1 = time.perf_counter()
        launches[label], numbers[label] = fn()
        print(f"{label} took {time.perf_counter() - t1:.1f} s of command "
              f"time")
    print(f"slice 19 took {time.perf_counter() - t0:.1f} s of command time")
    return launches, numbers


# ---------------------------------------------------------------------------
# slice 20: incremental checkpoints and the MiniCluster (paths 51-52)
# ---------------------------------------------------------------------------

SLICE20 = ("path 51", "path 52")
#: path 51's lanes: the main path whose options each runs, and its depth
#: (None: the main stream's ``N_BATCHES``)
INCR_LANES = {"51a": ("path 5", None), "51b": ("path 3", None),
              "51c": ("path 7", 12), "51d": ("path 14", 12)}
INCR_EVERY = 2          # a cut every 2 batches
INCR_WITHHELD = 3       # the cut whose confirmation is withheld
INCR_RETAIN = 3
#: path 52: the job's parallelism on the one card, its checkpoint interval,
#: the checkpoints that must have completed before the injected crash, and
#: the card memory a finished job may leave allocated
JOB_PARALLELISM = 2
JOB_CHECKPOINT_MS = 250
CRASH_AFTER_CHECKPOINTS = 2
JOB_MEMORY_SLACK = 64 << 20
#: elements a channel buffers: with the default 32 the source would hand
#: all 24 batches over and finish before the first trigger, and a job whose
#: source finished declines every later checkpoint; two keep the source
#: paced by the window subtasks through the job
JOB_CHANNEL_CAPACITY = 2


def snapshot_d2h(op) -> int:
    """The operator's device-to-host bytes so far (a full snapshot books
    ``d2h``, an increment's gather ``d2h_page_out``, JAX's names)."""
    return op.phase_bytes.get("d2h", 0) + op.phase_bytes.get(
        "d2h_page_out", 0)


def state_equal(a, b, path="$", rtol=None) -> bool:
    """Two snapshot trees (mesh slices densified) equal, arrays bit for bit
    (or floats to ``rtol``)."""
    from flink_tpu_torch.state.shard_layout import densify_keyed_snapshot
    if isinstance(a, dict) and "pane_base" in a:
        a, b = densify_keyed_snapshot(a), densify_keyed_snapshot(b)
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(state_equal(a[k], b[k], f"{path}.{k}", rtol)
                        for k in a))
    if isinstance(a, (list, tuple)):
        return (isinstance(b, (list, tuple)) and len(a) == len(b)
                and all(state_equal(x, y, f"{path}[{i}]", rtol)
                        for i, (x, y) in enumerate(zip(a, b))))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        if a.dtype != b.dtype or a.shape != b.shape:
            return False
        if a.dtype == object:
            return a.tolist() == b.tolist()
        if rtol is not None and a.dtype.kind == "f":
            return bool(np.allclose(a, b, rtol=rtol, atol=0))
        return a.tobytes() == b.tobytes()
    return a == b


def check_replay(label, got, want, open_window, bits) -> None:
    """A restored run's fires against another run's: the same windows and
    keys; values bit for bit, or (``bits`` False: a host tier re-seeds its
    f64 mirror from the snapshot's f32 cells, as JAX's does) the window
    open at the cut to 1e-6 and every later one bit for bit."""
    g, w = ({int(b.column("window_start")[0]): b for b in by_window(f)}
            for f in (got, want))
    check(sorted(g) == sorted(w), f"{label}: windows {sorted(g)} vs "
          f"{sorted(w)}")
    for ws in w:
        gk, wk = (np.asarray(x[ws].column("k")) for x in (g, w))
        gr, wr = (np.asarray(x[ws].column("result")) for x in (g, w))
        check(np.array_equal(gk, wk), f"{label} window {ws}: keys differ")
        if bits or ws > open_window:
            check(gr.tobytes() == wr.tobytes(),
                  f"{label} window {ws}: values differ in their bits")
        else:
            check(np.allclose(gr, wr, rtol=1e-6, atol=0),
                  f"{label} window {ws}: values beyond 1e-6")


def path51_lane(device, card, lane, batches, tmp):
    """One lane of path 51: the operator with ``incremental_state``, a cut
    every ``INCR_EVERY`` batches into ``IncrementalCheckpointStorage``
    beside a full snapshot into ``FileCheckpointStorage``; the restore of
    ``load_latest()`` at the middle batch run to the end."""
    from flink_tpu_torch.core.batch import RecordBatch, Watermark
    from flink_tpu_torch.operators.base import snapshot_scope
    from flink_tpu_torch.runtime import device_health
    from flink_tpu_torch.runtime.checkpoint.incremental import \
        IncrementalCheckpointStorage
    from flink_tpu_torch.runtime.checkpoint.storage import \
        FileCheckpointStorage

    base, depth = INCR_LANES[lane]
    n = N_BATCHES if depth is None else min(depth, N_BATCHES)
    restore_at = n // 2
    inc_dir, full_dir = (os.path.join(tmp, lane, d) for d in ("inc", "full"))
    inc_store = IncrementalCheckpointStorage(inc_dir, retain=INCR_RETAIN)
    full_store = FileCheckpointStorage(full_dir, retain=INCR_RETAIN)
    device_health.set_monitor(device_health.DeviceHealthMonitor())
    options = dict(PATHS[base])
    bits = options.get("emit_tier") == "device"
    op = build_op(device, **options)
    op.incremental_state = True
    st = {k: [] for k in ("kind", "inc_ms", "full_ms", "inc_d2h", "full_d2h",
                          "inc_stored", "full_stored", "inc_read_ms")}
    held = {}

    def cut(i):
        out = op.prepare_snapshot_pre_barrier()
        cid = (i + 1) // INCR_EVERY
        b0 = snapshot_d2h(op)
        r0 = op.phase_ns.get("snapshot", 0)
        sync(device)
        t0 = time.perf_counter()
        with snapshot_scope(cid, incremental=True):
            raw = op.snapshot_state()
        sync(device)
        st["inc_ms"].append((time.perf_counter() - t0) * 1e3)
        # the cut's state read (the gather or the mirror's columns); the
        # rest of the cut is the dirt's bookkeeping on the host
        st["inc_read_ms"].append((op.phase_ns.get("snapshot", 0) - r0) / 1e6)
        st["inc_d2h"].append(snapshot_d2h(op) - b0)
        st["kind"].append(raw.get("kind", "full"))
        shared = os.path.join(inc_dir, "shared")
        old = set(os.listdir(shared)) if os.path.isdir(shared) else set()
        inc_store.store(cid, {"w": raw})
        st["inc_stored"].append(
            dir_bytes(os.path.join(inc_dir, f"chk-{cid}"))
            + sum(os.path.getsize(os.path.join(shared, f))
                  for f in set(os.listdir(shared)) - old))
        b0 = snapshot_d2h(op)
        t0 = time.perf_counter()
        full = op.snapshot_state()
        sync(device)
        st["full_ms"].append((time.perf_counter() - t0) * 1e3)
        st["full_d2h"].append(snapshot_d2h(op) - b0)
        full_store.store(cid, {"w": full})
        st["full_stored"].append(dir_bytes(os.path.join(full_dir,
                                                        f"chk-{cid}")))
        check(state_equal(inc_store.load(cid)["w"], full),
              f"path {lane}: load({cid}) differs from the full snapshot at "
              f"batch {i}")
        if cid != INCR_WITHHELD:
            op.notify_checkpoint_complete(cid)
        if i + 1 == restore_at:
            t0 = time.perf_counter()
            held["latest"] = inc_store.load_latest()
            held["load_ms"] = (time.perf_counter() - t0) * 1e3
            held["chain"] = inc_store.chain_length(
                inc_store.checkpoint_ids()[-1])
            held["full"] = full_store.load(cid)
        return out

    def drive(o, start, stop, cuts):
        fired = []
        for i in range(start, stop):
            keys, vals, ts = batches[i]
            fired += o.process_batch(RecordBatch({"k": keys, "v": vals},
                                                 timestamps=ts))
            fired += o.process_watermark(Watermark(int(ts.max()) - 1))
            if cuts and (i + 1) % INCR_EVERY == 0:
                fired += cut(i)
        return fired

    sync(device)
    reset_launches()
    t0 = time.perf_counter()
    drive(op, 0, restore_at, True)
    after = drive(op, restore_at, n, True) + op.end_input()
    sync(device)
    wall = time.perf_counter() - t0
    launches = read_launches()
    final = op.snapshot_state()
    open_window = int(batches[restore_at - 1][2].max()) // WINDOW_MS \
        * WINDOW_MS
    replays = {}
    for name, snap in (("chain", held["latest"]["w"]),
                       ("full", held["full"]["w"])):
        r = build_op(device, **options)
        r.restore_state(snap)
        replays[name] = (drive(r, restore_at, n, False) + r.end_input(),
                         r.snapshot_state())
        r.close()
    check_replay(f"path {lane} chain restore vs full restore",
                 replays["chain"][0], replays["full"][0], open_window, True)
    check(state_equal(replays["chain"][1], replays["full"][1]),
          f"path {lane}: the final snapshots of the chain and full restores "
          f"differ")
    check_replay(f"path {lane} restore vs the uninterrupted run",
                 replays["chain"][0], after, open_window, bits)
    # (the pager's counters are its own run's history, not state)
    check(state_equal(*({k: v for k, v in s.items() if k != "paging_stats"}
                        for s in (replays["chain"][1], final)),
                      rtol=None if bits else 1e-6),
          f"path {lane}: the restored run's final snapshot differs from the "
          f"uninterrupted run's")
    op.close()
    incs = [i for i, k in enumerate(st["kind"]) if k == "window_delta"]
    fulls = [i for i, k in enumerate(st["kind"]) if k != "window_delta"]
    check(incs, f"path {lane}: no cut was an increment: {st['kind']}")
    check(launches["scatter_fold"] > 0, f"path {lane}: launches {launches}")
    if base == "path 3":
        check(launches["probe"] > 0, f"path {lane}: no probe launch")

    def pct(xs, q):
        return float(np.percentile(xs, q)) if xs else 0.0

    def mean(key, idx):
        return float(np.mean([st[key][i] for i in idx])) if idx else 0.0

    numbers = {
        "increments": len(incs), "rebases": len(fulls),
        "inc_d2h": mean("inc_d2h", incs), "full_d2h": mean("full_d2h", incs),
        "inc_ms_p50": pct([st["inc_ms"][i] for i in incs], 50),
        "inc_ms_p99": pct([st["inc_ms"][i] for i in incs], 99),
        "inc_read_ms_p50": pct([st["inc_read_ms"][i] for i in incs], 50),
        "full_ms_p50": pct(st["full_ms"], 50),
        "full_ms_p99": pct(st["full_ms"], 99),
        "inc_stored": mean("inc_stored", incs),
        "full_stored": mean("full_stored", incs),
        "load_latest_ms": held["load_ms"], "chain": held["chain"],
        "records_per_s": sum(len(batches[i][0]) for i in range(n)) / wall}
    print(f"path {lane} ({base}'s options, {n} batches, a cut every "
          f"{INCR_EVERY}, cut {INCR_WITHHELD} unconfirmed): {len(incs)} "
          f"increments, {len(fulls)} full re-bases ({st['kind']}); d2h per "
          f"increment {numbers['inc_d2h']:.0f} B vs a full snapshot's "
          f"{numbers['full_d2h']:.0f} B at the same batches; cut ms p50/p99 "
          f"incremental {numbers['inc_ms_p50']:.3f}/"
          f"{numbers['inc_ms_p99']:.3f} (its state read p50 "
          f"{numbers['inc_read_ms_p50']:.3f}, the rest the dirt's "
          f"bookkeeping) vs full {numbers['full_ms_p50']:.3f}"
          f"/{numbers['full_ms_p99']:.3f}; stored per increment "
          f"{numbers['inc_stored']:.0f} B vs FileCheckpointStorage's "
          f"{numbers['full_stored']:.0f} B; load_latest at batch "
          f"{restore_at} {held['load_ms']:.3f} ms over a chain of "
          f"{held['chain']}; every load(cid) equals the full snapshot bit for "
          f"bit, the restore run to the end equals the full restore bit for "
          f"bit and the uninterrupted run "
          f"{'bit for bit' if bits else 'bit for bit (its open window to 1e-6)'}"
          f"; {numbers['records_per_s']:.1f} records/s with the cuts; "
          f"launches {launches}; {card}")
    # the increment's download alone, under JAX's counter names
    print(f"path {lane} increment bytes: d2h (d2h + d2h_page_out) per cut "
          f"{[st['inc_d2h'][i] for i in incs]} B, each full snapshot's "
          f"{[st['full_d2h'][i] for i in incs]} B; {card}")
    return launches, numbers


def path51(device, card, batches):
    """Path 51: incremental checkpoints on the operator, four lanes."""
    import tempfile
    launches, numbers = {}, {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_51_") as tmp:
        for lane in INCR_LANES:
            t1 = time.perf_counter()
            launches[lane], numbers[lane] = path51_lane(device, card, lane,
                                                        batches, tmp)
            print(f"path {lane} took {time.perf_counter() - t1:.1f} s of "
                  f"command time")
    total = {k: sum(ln[k] for ln in launches.values())
             for k in launches["51a"]}
    return total, numbers


def crash_window_subtask(chaos, uid, completed):
    """A ``CrashOnceAt(1)`` on ``subtask.run`` that matches the window
    vertex's subtask 0 only, once ``completed()`` checkpoints have
    completed: the crash lands inside the job, after a restorable cut.
    ``at`` is the firing of that subtask it failed, ``t`` when."""

    class Crash(chaos.CrashOnceAt):
        seen, at, t = 0, None, None

        def matches(self, ctx):
            if ctx.get("task") != uid or ctx.get("subtask") != 0:
                return False
            self.seen += 1
            if self.at is None and completed() >= CRASH_AFTER_CHECKPOINTS:
                self.at, self.t = self.seen, time.perf_counter()
                return True
            return False

    return Crash(1)


def one_split(columns):
    """The stream in one split: one source subtask reads it in order, so
    each window subtask folds every key's records in record order (the f32
    bits of ``reference_f32``), however the job is cut."""
    from flink_tpu_torch.connectors.sources import (CollectionSource,
                                                    SourceSplit)

    class OneSplit(CollectionSource):
        def create_splits(self, parallelism):
            return [SourceSplit(self, 0, 1)]

    return OneSplit(columns=columns, batch_size=BATCH)


def north_star_job(env, batches):
    """The north star as a job on ``env``: ``batches`` in one split, event
    time from ``ts``, keyed by ``k``, 5000 ms tumbling windows, an f32 sum;
    returns the collect sink."""
    import torch

    from flink_tpu_torch.core.functions import SumAggregator
    from flink_tpu_torch.windowing import TumblingEventTimeWindows
    return (env.from_source(one_split(stream_columns(batches)),
                            "collection-source")
            .assign_timestamps_and_watermarks(0, timestamp_column="ts")
            .key_by("k")
            .window(TumblingEventTimeWindows.of(WINDOW_MS))
            .aggregate(SumAggregator(torch.float32), value_column="v")
            .collect())


def job52(device, batches, pins, crash, unaligned, tmp):
    """Path 52's job on the MiniCluster; returns (the environment, the
    sink, the result, wall s, launches, the crash schedule or None, the
    window operators' first calls)."""
    from flink_tpu_torch.datastream import StreamExecutionEnvironment
    from flink_tpu_torch.operators.window_agg import WindowAggOperator
    from flink_tpu_torch.runtime.checkpoint.incremental import \
        IncrementalCheckpointStorage
    from flink_tpu_torch.testing import chaos

    env = StreamExecutionEnvironment(device=device)
    env.set_parallelism(JOB_PARALLELISM)
    sink = north_star_job(env, batches)
    uid = [v.uid for v in env.get_stream_graph().to_plan().vertices
           if not v.is_source]
    check(len(uid) == 1, f"path 52: the plan's non-source vertices {uid}")
    inj, sched = None, None
    if crash:
        inj = chaos.FaultInjector(seed=7)
        sched = inj.inject("subtask.run", crash_window_subtask(
            chaos, uid[0], lambda: len(getattr(
                getattr(env, "_last_cluster", None), "_completed_ids", ()))))
    first = []
    orig = WindowAggOperator.process_batch

    def process_batch(self, batch):
        if not getattr(self, "_first_call", None):
            self._first_call = time.perf_counter()
            first.append(self._first_call)
        return orig(self, batch)

    storage = IncrementalCheckpointStorage(tmp)
    WindowAggOperator.process_batch = process_batch
    try:
        with window_lane(pins), (chaos.installed(inj) if inj is not None
                                 else contextlib.nullcontext()):
            sync(device)
            reset_launches()
            t0 = time.perf_counter()
            res = env.execute_cluster(
                checkpoint_interval_ms=JOB_CHECKPOINT_MS, storage=storage,
                incremental=True, unaligned=unaligned,
                restart_attempts=1 if crash else 0, timeout_s=600,
                channel_capacity=JOB_CHANNEL_CAPACITY)
            sync(device)
            wall = time.perf_counter() - t0
            launches = read_launches()
    finally:
        WindowAggOperator.process_batch = orig
    return env, sink, res, wall, launches, sched, first


def check_job_rows(label, sink, expect, cells, bits, exact=()) -> int:
    """Every (key, window) of the reference is present; every row equals
    ``reference_f32`` bit for bit (``bits``), or, in the windows of
    ``exact``, ``reference`` bit for bit (the host tier's f64 sums of f32
    values, exact in f64 at these counts), else ``reference`` to ``RTOL``,
    repeats included.  Returns the number of repeated rows."""
    k = np.asarray(sink.column("k"), np.int64)
    ws = np.asarray(sink.column("window_start"), np.int64)
    res = np.asarray(sink.column("result"))
    check(res.dtype == np.float32 or not bits,
          f"{label}: result dtype {res.dtype}")
    repeats = 0
    for w, (sums, cnt) in expect.items():
        m = ws == w
        keys, vals = k[m], res[m]
        uniq = np.unique(keys)
        check(np.array_equal(uniq, np.flatnonzero(cnt)),
              f"{label} window {w}: keys differ from the reference's")
        repeats += int(keys.size - uniq.size)
        if bits:
            check(np.array_equal(vals.view(np.uint32),
                                 cells[w][keys].view(np.uint32)),
                  f"{label} window {w}: a row differs from the f32 ordered "
                  f"reference in its bits")
        elif w in exact:
            check(vals.dtype == np.float64 and np.array_equal(
                vals.view(np.uint64), sums[keys].view(np.uint64)),
                  f"{label} window {w}: a row differs from the f64 "
                  f"reference in its bits")
        else:
            check(np.allclose(vals, sums[keys], rtol=RTOL, atol=0),
                  f"{label} window {w}: a row differs beyond rtol {RTOL}")
    check(set(np.unique(ws).tolist()) == set(expect),
          f"{label}: windows {sorted(set(ws.tolist()))}")
    return repeats


def path52(device, card, batches, expect, cells, earlier):
    """Path 52: the north star as a checkpointed MiniCluster job, the
    device tier with one injected crash (52a) and the host tier with the
    probe on and unaligned checkpoints (52b)."""
    import gc
    import tempfile

    import torch

    from flink_tpu_torch.operators.window_agg import WindowAggOperator
    n_records = sum(len(b[0]) for b in batches)
    launches, numbers = {}, {}
    for lane, base, crash, unaligned in (("52a", "path 5", True, False),
                                         ("52b", "path 3", False, True)):
        pins = {k: v for k, v in PATHS[base].items()}
        bits = pins.get("emit_tier") == "device"
        gc.collect()
        sync(device)
        m0 = torch.cuda.memory_allocated(device) if device.type == "cuda" \
            else 0
        with tempfile.TemporaryDirectory(prefix=f"chip_smoke_{lane}_") as tmp:
            env, sink, res, wall, ln, sched, first = job52(
                device, batches, pins, crash, unaligned, tmp)
            cluster = env._last_cluster
            status = cluster.job_status()
        check(res.state == "FINISHED", f"path {lane}: the job {res}")
        stats = list(cluster._checkpoint_stats)
        lanes = [lane_of(m) for t in cluster._tasks
                 for m in getattr(t.operator, "operators", [t.operator])
                 if isinstance(m, WindowAggOperator)]
        devices = {str(m.device) for t in cluster._tasks
                   for m in getattr(t.operator, "operators", [t.operator])
                   if isinstance(m, WindowAggOperator)}
        check(len(lanes) == JOB_PARALLELISM and all(
            l["emit_tier"] == pins["emit_tier"] for l in lanes),
            f"path {lane}: the window subtasks' lanes {lanes}")
        check(devices == {str(torch.device(device))} or all(
            d.startswith(device.type) for d in devices),
            f"path {lane}: the window operators ran on {devices}")
        repeats = check_job_rows(f"path {lane}", sink, expect, cells, bits)
        incs = [s for s in status["checkpoint_stats"]
                if s.get("incremental")]
        check(incs, f"path {lane}: no incremental checkpoint among "
              f"{len(stats)}")
        check(ln["scatter_fold"] > 0, f"path {lane}: launches {ln}")
        if not bits:
            check(ln["probe"] > 0, f"path {lane}: no probe launch: {ln}")
        recovery_ms = crash_at = None
        if crash:
            check(res.restarts == 1 and status["restarts"] == 1,
                  f"path {lane}: restarts {res.restarts}, job_status "
                  f"{status['restarts']}")
            check(sched.at is not None, f"path {lane}: the crash never "
                  f"fired")
            after = [t for t in first if t > sched.t]
            check(after, f"path {lane}: no record reached a window operator "
                  f"after the restore")
            recovery_ms = (min(after) - sched.t) * 1e3
            crash_at = sched.at
        m1 = torch.cuda.memory_allocated(device) if device.type == "cuda" \
            else 0
        # a subtask reports FINISHED just before its thread ends, and the
        # crash schedule's condition holds the environment: wait for the
        # threads, then drop every reference to the job (a subtask holds
        # its cluster, the cluster every operator)
        for task in cluster._tasks:
            task.join(60)
        del env, sink, cluster, status, sched, task
        gc.collect()
        sync(device)
        m2 = torch.cuda.memory_allocated(device) if device.type == "cuda" \
            else 0
        check(m2 - m0 <= JOB_MEMORY_SLACK,
              f"path {lane}: {m2 - m0} B of card memory still allocated "
              f"after the job")
        dur = [s["duration_ms"] for s in stats]
        full_sizes = [s["state_size_bytes"] for s in incs]
        deltas = [s["delta_bytes"] for s in incs]
        rps = n_records / wall
        numbers[lane] = {
            "records_per_s": rps, "wall_s": wall, "checkpoints": len(stats),
            "incremental_checkpoints": len(incs),
            "delta_bytes_p50": float(np.median(deltas)),
            "state_size_bytes_p50": float(np.median(full_sizes)),
            "checkpoint_ms_p50": float(np.percentile(dur, 50)),
            "checkpoint_ms_p99": float(np.percentile(dur, 99)),
            "recovery_ms": recovery_ms, "repeats": repeats,
            "restarts": res.restarts, "lanes": lanes,
            "memory_after_job": m1 - m0, "memory_after_release": m2 - m0}
        launches[lane] = ln
        p5 = earlier["path 5"]["records_per_s"]
        p40 = earlier["path 40"]["40a"]["records_per_s"]
        crash_text = (f"window subtask 0 crashed at its firing {crash_at} of "
                      f"subtask.run (after {CRASH_AFTER_CHECKPOINTS} "
                      f"completed checkpoints), restarted once, recovery "
                      f"{recovery_ms:.1f} ms (crash to the first record in "
                      f"the restored window operators); " if crash else
                      "no failure; ")
        print(f"path {lane} ({base}'s lane pinned, parallelism "
              f"{JOB_PARALLELISM} on the card, "
              f"{'unaligned' if unaligned else 'aligned'} incremental "
              f"checkpoints every {JOB_CHECKPOINT_MS} ms into "
              f"IncrementalCheckpointStorage): {n_records} records in "
              f"{wall:.3f} s = {rps:.1f} records/s, beside path 40a "
              f"(LocalExecutor) {p40:.1f} ({rps / p40:.3f}x) and path 5 (the "
              f"operator alone) {p5:.1f} ({rps / p5:.3f}x); {crash_text}"
              f"{len(stats)} checkpoints, {len(incs)} incremental, delta_bytes"
              f" p50 {numbers[lane]['delta_bytes_p50']:.0f} of state_size "
              f"p50 {numbers[lane]['state_size_bytes_p50']:.0f} B, duration "
              f"p50/p99 {numbers[lane]['checkpoint_ms_p50']:.1f}/"
              f"{numbers[lane]['checkpoint_ms_p99']:.1f} ms; every (key, "
              f"window) present, every row "
              f"{'equal to the f32 ordered reference bit for bit' if bits else f'within rtol {RTOL} of the reference'}"
              f", {repeats} repeated rows; card memory after the job "
              f"{m1 - m0} B over the start, {m2 - m0} B once released; "
              f"subtask lanes {json.dumps(lanes, sort_keys=True)}; launches "
              f"{ln}; {card}")
    total = {k: launches["52a"][k] + launches["52b"][k]
             for k in launches["52a"]}
    return total, numbers


def slice20(device, card, batches, expect, cells, earlier):
    """Paths 51-52: incremental checkpoints and the MiniCluster."""
    t0 = time.perf_counter()
    launches, numbers = {}, {}
    for label, fn in (
            ("path 51", lambda: path51(device, card, batches)),
            ("path 52", lambda: path52(device, card, batches, expect, cells,
                                       earlier))):
        t1 = time.perf_counter()
        launches[label], numbers[label] = fn()
        print(f"{label} took {time.perf_counter() - t1:.1f} s of command "
              f"time")
    print(f"slice 20 took {time.perf_counter() - t0:.1f} s of command time")
    return launches, numbers


# ---------------------------------------------------------------------------
# slice 21: the north star as a process cluster job (path 53)
# ---------------------------------------------------------------------------

SLICE21 = ("path 53",)
#: path 53: worker processes on the one card (the window vertex's
#: parallelism stays ``JOB_PARALLELISM``), the main path whose lane each
#: worker pins (52b's: the host tier with the device probe on), the
#: checkpoint interval, and the environment variable that names the
#: directory each worker writes its numbers to
PC_WORKERS = 2
PC_LANE = "path 3"
PC_CHECKPOINT_MS = JOB_CHECKPOINT_MS
#: the job's depth: the main stream run on to twice its batches.  A
#: channel holds 32 elements (16 batches, each with its watermark), so an
#: aligned barrier waits behind up to 16 batches: over 24 batches the
#: second cut completes (~3 s a cut on the H100, its storage included) only
#: after window subtask 0 has finished, and the kill would find nothing to
#: recover; over 48 about 30 batches remain behind it (over 36 window
#: subtask 0 had finished when cut 2 completed at source offset 19: PR
#: 22's call 3)
PC_BATCHES = 2 * N_BATCHES
PC_OUT = "CHIP_SMOKE_PATH53_OUT"
#: ... and the one that carries the stream's sizes (the smoke's, so a
#: rehearsal's shrunk sizes reach the workers too)
PC_SIZES = "CHIP_SMOKE_PATH53_SIZES"
#: a worker's numbers (``path53_worker``), in the worker's own process
_PATH53 = {}


def _process_start_s() -> float:
    """This process's start, in epoch seconds (``/proc``: the start tick
    after boot, and the boot time)."""
    with open("/proc/self/stat") as f:
        ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/stat") as f:
        boot = next(int(line.split()[1]) for line in f
                    if line.startswith("btime"))
    return boot + ticks / os.sysconf("SC_CLK_TCK")


def path53_worker() -> None:
    """In a path 53 worker, once: pin every window operator to
    ``PC_LANE``'s options, open the CUDA context and load the kernels
    (timed: the worker's start-up), set the launch counts to 0, count the
    bytes of every frame the TCP data plane sends, note each window
    operator's first record, and write it all to ``PC_OUT`` when the worker
    exits.  The smoke's in-process pins and counters do not reach a
    worker: this runs in it."""
    if _PATH53:
        return
    import atexit

    import torch

    import flink_tpu_torch
    from flink_tpu_torch.cluster import net
    from flink_tpu_torch.kernels import build
    from flink_tpu_torch.operators.window_agg import WindowAggOperator
    t_enter = time.time()
    card = flink_tpu_torch.resolve_device().type == "cuda"
    _PATH53.update(pid=os.getpid(), started_s=_process_start_s(),
                   enter_s=t_enter, first_record_s=None, lanes=[], batches=0,
                   devices=[], net_bytes=0, net_frames=0,
                   index=int(sys.argv[sys.argv.index("--index") + 1]),
                   attempt=os.environ.get("FLINK_TPU_ATTEMPT"))
    t0 = time.perf_counter()
    if card:
        torch.zeros(1, device="cuda")
        torch.cuda.synchronize()
    _PATH53["cuda_context_ms"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    for lib in ((build.probe_lib, build.probe_fold_lib,
                 build.scatter_fold_lib) if card else ()) + (
            build.host_mirror_lib, build.codec_lib):
        lib()
    _PATH53["kernel_load_ms"] = (time.perf_counter() - t0) * 1e3
    pins = PATHS[PC_LANE]
    init, process_batch = (WindowAggOperator.__init__,
                           WindowAggOperator.process_batch)

    def pinned(self, *args, **kwargs):
        init(self, *args, **{**kwargs, **pins})

    def first(self, batch):
        _PATH53["batches"] += 1
        if getattr(self, "_path53_seen", False):
            return process_batch(self, batch)
        self._path53_seen = True
        if _PATH53["first_record_s"] is None:
            _PATH53["first_record_s"] = time.time()
        out = process_batch(self, batch)
        _PATH53["lanes"].append(lane_of(self))
        _PATH53["devices"].append(str(self.device))
        return out

    send = net._send_frame

    def counted(sock, ftype, payload):
        _PATH53["net_bytes"] += net._HDR.size + len(payload)
        _PATH53["net_frames"] += 1
        send(sock, ftype, payload)

    WindowAggOperator.__init__ = pinned
    WindowAggOperator.process_batch = first
    net._send_frame = counted
    reset_launches()

    def dump():
        _PATH53["launches"] = read_launches()
        with open(os.path.join(os.environ[PC_OUT],
                               f"worker-{os.getpid()}.json"), "w") as f:
            json.dump(_PATH53, f)

    atexit.register(dump)


def job53():
    """Path 53's job (``chip_smoke:job53``), built by the coordinator and
    by every worker, which imports this module (the coordinator ships its
    ``sys.path``): ``north_star_job`` over the main stream's first
    ``PC_BATCHES`` batches.  A worker (its
    coordinator sets ``FLINK_TPU_ATTEMPT``) first arms ``path53_worker``.
    No device is named: a worker's operators take the device its
    coordinator shipped."""
    from flink_tpu_torch.datastream import StreamExecutionEnvironment
    if "FLINK_TPU_ATTEMPT" in os.environ:
        path53_worker()
    sizes = json.loads(os.environ.get(PC_SIZES) or "{}")
    globals().update(sizes)
    env = StreamExecutionEnvironment()
    env.set_parallelism(JOB_PARALLELISM)
    north_star_job(env, make_batches(N_BATCHES * BATCH, N_KEYS, BATCH,
                                     WINDOW_MS))
    return env.get_stream_graph("path-53")


def job53_rows(rows):
    """A process cluster's collected rows (dicts) as the columns
    ``check_job_rows`` reads."""
    cols = {name: np.array([r[name] for r in rows])
            for name in ("k", "window_start", "result")}

    class Rows:
        def column(self, name):
            return cols[name]

    return Rows()


def kill_after_checkpoints(pc, index, source_uid, victim, killed):
    """Note each completed cut's source offset; once
    ``CRASH_AFTER_CHECKPOINTS`` cuts have completed while subtask
    ``victim`` still runs, SIGKILL worker ``index``, its host
    (``killed``: every worker's pid then, when, the cut it will
    restore)."""
    import signal
    t0 = time.monotonic()
    deadline = t0 + 600
    killed["cuts"] = cuts = []
    while time.monotonic() < deadline and not killed.get("stop"):
        done = list(pc._completed_ids)
        if len(done) > len(cuts):
            tree = pc._latest_resolved or {}
            sub = (tree.get(source_uid) or {}).get("subtasks") or [{}]
            cuts.append((done[-1], (sub[0] or {}).get("source_offset"),
                         bool((sub[0] or {}).get("finished")),
                         round(time.monotonic() - t0, 3),
                         pc._states.get(victim)))
        procs = getattr(pc, "_procs", None)
        if len(done) >= CRASH_AFTER_CHECKPOINTS and procs \
                and all(p.poll() is None for p in procs) \
                and pc._states.get(victim) == "RUNNING":
            killed["pids"] = [p.pid for p in procs]
            killed["cut"], killed["tree"] = done[-1], pc._latest_resolved
            killed["t"] = time.time()
            os.kill(procs[index].pid, signal.SIGKILL)
            return
        time.sleep(0.002)


def path53(device, card, earlier):
    """Path 53: the north star as a ``ProcessCluster`` job on the card
    (``PC_BATCHES`` batches of the main stream), two worker processes (half
    the keyed records cross between them over the TCP data plane), aligned
    incremental checkpoints, the worker that hosts window subtask 0
    SIGKILLed after two completed checkpoints and recovered in place."""
    import tempfile
    import threading

    import torch

    from flink_tpu_torch.cluster.distributed import (ProcessCluster,
                                                     assign_subtasks,
                                                     build_plan,
                                                     subtask_counts_of)
    from flink_tpu_torch.runtime.checkpoint.incremental import \
        IncrementalCheckpointStorage
    job = "chip_smoke:job53"
    here = os.path.dirname(os.path.abspath(__file__))
    batches = make_batches(PC_BATCHES * BATCH, N_KEYS, BATCH, WINDOW_MS)
    expect = reference(batches)
    n_records = sum(len(b[0]) for b in batches)
    os.environ[PC_SIZES] = json.dumps({"N_KEYS": N_KEYS, "BATCH": BATCH,
                                       "N_BATCHES": PC_BATCHES})
    plan = build_plan(job)
    counts, _ = subtask_counts_of(plan)
    window = [v.uid for v in plan.vertices if not v.is_source]
    check(len(window) == 1, f"path 53: the plan's non-source vertices "
          f"{window}")
    source_uid = plan.vertices[0].uid
    assign = assign_subtasks(plan, counts, PC_WORKERS)
    victim, source = assign[(window[0], 0)], assign[(source_uid, 0)]
    check(victim != source, "path 53: window subtask 0 shares the source's "
          "worker, so no record would cross the data plane to it")
    del plan
    sync(device)
    free0 = torch.cuda.mem_get_info(device)[0] if device.type == "cuda" \
        else 0
    spawned, killed = [], {}
    cut, cut_offset = set(), None
    with tempfile.TemporaryDirectory(prefix="chip_smoke_53_") as tmp:
        os.environ[PC_OUT] = tmp
        try:
            storage = IncrementalCheckpointStorage(os.path.join(tmp, "ckpt"))
            pc = ProcessCluster(job, n_workers=PC_WORKERS,
                                checkpoint_storage=storage,
                                checkpoint_interval_ms=PC_CHECKPOINT_MS,
                                incremental=True, restart_attempts=1,
                                extra_sys_path=(here,), device=device)
            spawn = pc._spawn_worker

            def spawn_timed(index, cport):
                proc = spawn(index, cport)
                spawned.append((index, proc.pid, time.time()))
                return proc

            pc._spawn_worker = spawn_timed
            chaos_thread = threading.Thread(
                target=kill_after_checkpoints,
                args=(pc, victim, source_uid, (window[0], 0), killed))
            chaos_thread.start()
            t0 = time.perf_counter()
            res = pc.run(timeout_s=600)
            wall = time.perf_counter() - t0
            killed["stop"] = True
            chaos_thread.join()
            # the windows open at the restored cut: their panes restart from
            # the snapshot's f32 cells, as the reference restores them
            snap = killed.pop("tree", None)
            if snap is not None:
                cut_offset = snap[source_uid]["subtasks"][0].get(
                    "source_offset")
                for sub in snap[window[0]]["subtasks"]:
                    for op in sub["operator"].values():
                        if isinstance(op, dict) and "pane_base" in op:
                            cut |= {p * WINDOW_MS for p in range(
                                op["pane_base"], op["max_pane"] + 1)}
                del snap
            workers = []
            for name in sorted(os.listdir(tmp)):
                if name.startswith("worker-"):
                    with open(os.path.join(tmp, name)) as f:
                        workers.append(json.load(f))
        finally:
            del os.environ[PC_OUT], os.environ[PC_SIZES]
    final_pids = [p.pid for p in pc._procs]
    by_pid = {w["pid"]: w for w in workers}
    finals = [by_pid.get(pid, {}) for pid in final_pids]
    respawned = finals[victim]
    respawn_t = [t for i, pid, t in spawned if pid == final_pids[victim]]
    first = respawned.get("first_record_s")
    recovery_ms = ((first - killed["t"]) * 1e3
                   if first and killed.get("t") else None)
    startup_ms = ((first - respawn_t[0]) * 1e3
                  if first and respawn_t else None)
    to_plan_ms = ((respawned["enter_s"] - respawn_t[0]) * 1e3
                  if respawned and respawn_t else None)
    stats = list(pc._checkpoint_stats)
    dur = [st["duration_ms"] for st in stats] or [float("nan")]
    incs = [st for st in stats if st.get("incremental")]
    launches = {k: sum(w.get("launches", {}).get(k, 0) for w in finals)
                for k in ("probe", "probe_fold", "scatter_fold",
                          "scatter_fold_single", "scatter_fold_multi",
                          "scatter_fold_plane")}
    net_bytes = sum(w.get("net_bytes", 0) for w in finals)
    rps = n_records / wall
    a, b = (earlier["path 52"][lane]["records_per_s"]
            for lane in ("52a", "52b"))
    ms = lambda v: "n/a" if v is None else f"{v:.1f}"  # noqa: E731
    numbers = {
        "records_per_s": rps, "wall_s": wall, "recovery_ms": recovery_ms,
        "respawn_startup_ms": startup_ms, "respawn_to_plan_ms": to_plan_ms,
        "respawn_cuda_context_ms": respawned.get("cuda_context_ms"),
        "respawn_kernel_load_ms": respawned.get("kernel_load_ms"),
        "checkpoints": len(stats), "incremental_checkpoints": len(incs),
        "checkpoint_ms_p50": float(np.percentile(dur, 50)),
        "checkpoint_ms_p99": float(np.percentile(dur, 99)),
        "cuts": killed.get("cuts"), "restored_cut": killed.get("cut"),
        "restored_cut_offset": cut_offset, "net_bytes": net_bytes,
        "batches_by_worker": {w.get("index"): w.get("batches")
                              for w in finals},
        "launches_by_worker": {w.get("index"): w.get("launches")
                               for w in finals}}
    print(f"path 53 (north star as a ProcessCluster job: {PC_WORKERS} worker "
          f"processes on the card, window parallelism {JOB_PARALLELISM}, "
          f"{PC_LANE}'s lane pinned in each worker, aligned incremental "
          f"checkpoints every {PC_CHECKPOINT_MS} ms into "
          f"IncrementalCheckpointStorage): {res['state']}, {n_records} "
          f"records in {wall:.3f} s = {rps:.1f} records/s, beside path 52a "
          f"{a:.1f} ({rps / a:.3f}x) and 52b {b:.1f} ({rps / b:.3f}x) in this "
          f"call; cuts completed (id, source offset in batches, source "
          f"finished, s after the start, window subtask 0's state) "
          f"{killed.get('cuts')}; worker {victim} (window subtask "
          f"0) SIGKILLed after {CRASH_AFTER_CHECKPOINTS} and respawned "
          f"(recoveries {res['recoveries']}), pids {killed.get('pids')} -> "
          f"{final_pids}; restored cut {killed.get('cut')} at source offset "
          f"{cut_offset} of {len(batches)} batches; recovery "
          f"{ms(recovery_ms)} ms (kill to the respawned worker's first "
          f"record); its start-up {ms(startup_ms)} ms (spawn to first "
          f"record: {ms(to_plan_ms)} ms to its plan, CUDA context "
          f"{ms(respawned.get('cuda_context_ms'))} ms, kernel load "
          f"{ms(respawned.get('kernel_load_ms'))} ms); {len(stats)} "
          f"checkpoints ({len(incs)} incremental), duration p50/p99 "
          f"{numbers['checkpoint_ms_p50']:.1f}/"
          f"{numbers['checkpoint_ms_p99']:.1f} ms; {net_bytes} B over the "
          f"TCP data plane (the final workers' frames); window batches by "
          f"worker {numbers['batches_by_worker']}; launches by worker "
          f"{json.dumps(numbers['launches_by_worker'], sort_keys=True)}; "
          f"{card}")
    check(res["state"] == "FINISHED",
          f"path 53: the job {res['state']}: {res['error']}")
    check(killed.get("pids") is not None, "path 53: the kill never fired: "
          f"{len(pc._completed_ids)} checkpoints completed, not "
          f"{CRASH_AFTER_CHECKPOINTS} while window subtask 0 ran")
    check(res["recoveries"] == 1, f"path 53: recoveries "
          f"{res['recoveries']}")
    check(final_pids[source] == killed["pids"][source]
          and final_pids[victim] != killed["pids"][victim],
          f"path 53: pids before the kill {killed['pids']}, after "
          f"{final_pids}: the survivor must keep its pid")
    alive = [p.pid for p in pc._procs if p.poll() is None]
    check(not alive, f"path 53: worker processes {alive} outlived the job")
    check(all(finals), f"path 53: numbers from workers {sorted(by_pid)}, "
          f"final workers {final_pids}")
    check(first is not None, "path 53: the respawned worker's window "
          "operator got no record (the restored cut held the whole stream)")
    for w in finals:
        ln = w["launches"]
        check(ln["probe"] > 0 and ln["scatter_fold"] > 0,
              f"path 53: worker {w['index']} (pid {w['pid']}) launches {ln}")
        check(w["lanes"] and all(l["emit_tier"] == "host"
                                 and l["device_probe"] for l in w["lanes"]),
              f"path 53: worker {w['index']}'s window lanes {w['lanes']}")
        check(all(d.startswith("cuda") for d in w["devices"]),
              f"path 53: worker {w['index']}'s window operators ran on "
              f"{w['devices']}")
    t1 = time.perf_counter()
    exact = set(expect) - cut
    check(exact, f"path 53: every window {sorted(expect)} was open at the "
          f"restored cut")
    repeats = check_job_rows("path 53", job53_rows(res["rows"]), expect,
                             None, bits=False, exact=exact)
    numbers["rows_check_s"] = time.perf_counter() - t1
    numbers["repeats"] = repeats
    check(repeats == 0, f"path 53: {repeats} repeated rows")
    del res["rows"]
    free1 = free0
    for _ in range(100):       # a context's release trails its process
        free1 = torch.cuda.mem_get_info(device)[0] \
            if device.type == "cuda" else 0
        if free0 - free1 <= JOB_MEMORY_SLACK:
            break
        time.sleep(0.1)
    numbers["memory_after_job"] = free0 - free1
    check(free0 - free1 <= JOB_MEMORY_SLACK,
          f"path 53: the card has {free0 - free1} B less free memory after "
          f"the job than before it")
    print(f"path 53: every (key, window) present, windows {sorted(exact)} "
          f"equal to the f64 reference bit for bit, "
          f"{sorted(cut & set(expect))} (open at the restored cut, "
          f"re-seeded from its f32 cells) within rtol {RTOL}, {repeats} "
          f"repeated rows (checked in {numbers['rows_check_s']:.1f} s); no "
          f"worker alive after the job; card memory free after it "
          f"{free0 - free1} B below the start; {card}")
    return launches, numbers


def slice21(device, card, earlier):
    """Path 53: the distributed runtime."""
    t0 = time.perf_counter()
    launches, numbers = {}, {}
    launches["path 53"], numbers["path 53"] = path53(device, card, earlier)
    print(f"path 53 took {time.perf_counter() - t0:.1f} s of command time")
    return launches, numbers


# ---------------------------------------------------------------------------
# slice 22: serving and observability (paths 54-55)
# ---------------------------------------------------------------------------

SLICE22 = ("path 54", "path 55")
#: path 54's variants and the main path whose options each runs
SERVE_LANES = {"54a": "path 5", "54b": "path 3"}
SERVE_STATE = "north_star"
SERVE_LOAD_KEYS = 4096          # keys a request of the load client
SERVE_CHECK_KEYS = 1 << 16      # keys a request of the fire and replica checks
SERVE_SEED = 54
#: path 55: the job's depth (the main stream's first batches), the
#: endpoints it GETs while the job runs, and the tracing-cost pairs
OBS_BATCHES = 8
OBS_ENDPOINTS = ("/overview", "/jobs", "/jobs/{id}",
                 "/jobs/{id}/checkpoints", "/jobs/{id}/metrics",
                 "/jobs/{id}/backpressure", "/jobs/{id}/flamegraph", "/")
TRACE_AB_PAIRS = 2


def serve_load(port, stop, out) -> None:
    """The load client: batched live lookups of ``SERVE_LOAD_KEYS`` uniform
    random keys (numpy, seed ``SERVE_SEED``) over the binary protocol, as
    fast as it can until ``stop``; fills ``out`` with the keys looked up,
    the seconds and each request's ms by its own clock."""
    from flink_tpu_torch.queryable import QueryableStateClientPool
    rng = np.random.default_rng(SERVE_SEED)
    pool = QueryableStateClientPool("127.0.0.1", port, protocol="binary")
    ms, n = [], 0
    t0 = time.perf_counter()
    try:
        while not stop.is_set():
            keys = rng.integers(0, N_KEYS, SERVE_LOAD_KEYS, dtype=np.int64)
            r0 = time.perf_counter()
            pool.get_batch_columnar(SERVE_STATE, keys)
            ms.append((time.perf_counter() - r0) * 1e3)
            n += keys.size
    except Exception as err:  # noqa: BLE001 — reported, and fatal below
        out["error"] = repr(err)
    finally:
        pool.close()
    out.update(keys=n, seconds=time.perf_counter() - t0, ms=ms)


def serve_drive(op, batches, on_fire=None, on_snapshot=None):
    """The main stream through ``op`` (a watermark after each batch, a
    snapshot every ``SNAPSHOT_EVERY``, ``end_input``); the checks between
    calls are not timed.  Returns the seconds spent in the operator's
    calls."""
    from flink_tpu_torch.core.batch import RecordBatch, Watermark
    spent, cid = 0.0, 0
    for i, (keys, vals, ts) in enumerate(batches):
        t0 = time.perf_counter()
        out = op.process_batch(RecordBatch({"k": keys, "v": vals},
                                           timestamps=ts))
        out += op.process_watermark(Watermark(int(ts.max()) - 1))
        snap = None
        if (i + 1) % SNAPSHOT_EVERY == 0:
            out += op.prepare_snapshot_pre_barrier()
            snap = op.snapshot_state()
            cid += 1
            op.notify_checkpoint_complete(cid)
        spent += time.perf_counter() - t0
        if on_fire is not None:
            on_fire(out)
        if snap is not None and on_snapshot is not None:
            on_snapshot(cid, snap)
    t0 = time.perf_counter()
    out = op.end_input()
    spent += time.perf_counter() - t0
    if on_fire is not None:
        on_fire(out)
    return spent


def served_fire_check(pool, label, out) -> int:
    """Every key of the newest window's fire batches in ``out``, looked up
    live in requests of ``SERVE_CHECK_KEYS``: each answer is that batch's
    row bit for bit, with its window's bounds.  Returns the keys checked."""
    fired = [b for b in out if "result" in getattr(b, "columns", {})]
    if not fired:
        return 0
    newest = max(int(np.asarray(b.column("window_start"))[0])
                 for b in fired)
    n = 0
    for b in fired:
        if int(np.asarray(b.column("window_start"))[0]) != newest:
            continue
        keys = np.asarray(b.column("k"), np.int64)
        vals = np.asarray(b.column("result"))
        for lo in range(0, keys.size, SERVE_CHECK_KEYS):
            sl = slice(lo, lo + SERVE_CHECK_KEYS)
            found, cols, _ = pool.get_batch_columnar(SERVE_STATE, keys[sl])
            check(found.all() and cols["result"].dtype == vals.dtype
                  and cols["result"].tobytes() == vals[sl].tobytes()
                  and (cols["window_start"] == newest).all(),
                  f"{label}: a live answer differs from window {newest}'s "
                  f"fire")
        n += keys.size
    return n


def replica_check(pool, label, cid, snap, rng) -> None:
    """``SERVE_CHECK_KEYS`` uniform keys at checkpoint consistency: each
    answer is a numpy combine of the snapshot's panes for that key (the
    key's row of counts and f32 sums: found where any pane counts, the
    panes' f32 sum), and the tags name checkpoint ``cid``."""
    keys = rng.integers(0, N_KEYS, SERVE_CHECK_KEYS, dtype=np.int64)
    found, cols, tags = pool.get_batch_columnar(SERVE_STATE, keys,
                                                consistency="checkpoint")
    rev = np.asarray(snap["key_index"]["reverse"], np.int64)
    counts = np.asarray(snap["counts"])
    sums = np.asarray(snap["leaves"][0])
    rev = rev[: counts.shape[0]]
    order = np.argsort(rev, kind="stable")
    pos = np.minimum(np.searchsorted(rev[order], keys), rev.size - 1)
    slot = order[pos]
    seen = rev[slot] == keys
    live = seen & (counts[slot].sum(axis=1) > 0)
    want = np.add.reduce(sums[slot[live]], axis=1)
    check(tags.get("checkpoint_id") == cid and np.array_equal(found, live)
          and cols["result"][live].tobytes() == want.tobytes(),
          f"{label}: the replica's answers at checkpoint {cid} differ from "
          f"the numpy combine of its snapshot ({int((found != live).sum())} "
          f"found bits)")


def path54_lane(device, card, batches, label, base):
    """One variant of path 54: ``base``'s operator without the view (the
    twin) and with it (no client) in turns twin, view, view, twin, timed;
    then with the live view served by a ``QueryableStateService`` behind a
    TCP server, under a load client's lookups, checked at every fire and
    snapshot."""
    import threading

    from flink_tpu_torch.queryable import (QueryableStateClientPool,
                                           QueryableStateService,
                                           QueryableStateSpec)
    from flink_tpu_torch.runtime import device_health
    n_records = sum(len(b[0]) for b in batches)
    rate, top = {"twin": [], "view": []}, []
    for run in ("twin", "view", "view", "twin"):
        device_health.set_monitor(device_health.DeviceHealthMonitor())
        op = build_op(device, **PATHS[base], **(
            {"queryable": SERVE_STATE} if run == "view" else {}))
        sync(device)
        rate[run].append(n_records / serve_drive(op, batches))
        name = max(op.phase_ns, key=op.phase_ns.get)
        top.append(f"{run} {name} {op.phase_ns[name] / 1e6:.1f}")
        op.close()
    device_health.set_monitor(device_health.DeviceHealthMonitor())
    op = build_op(device, queryable=SERVE_STATE, **PATHS[base])
    service = QueryableStateService()
    service.register_views(SERVE_STATE, [op.queryable_view()],
                           parallelism=1, max_parallelism=128)
    service.add_replica(SERVE_STATE, QueryableStateSpec.from_operator(
        SERVE_STATE, "window", op))
    server = service.start_server(host="127.0.0.1")
    pool = QueryableStateClientPool("127.0.0.1", server.port,
                                    protocol="binary")
    rng = np.random.default_rng(SERVE_SEED + 1)
    stop, load = threading.Event(), {}
    fire_keys, ingest_ms, snaps = [0], [], [0]

    def on_fire(out):
        fire_keys[0] += served_fire_check(pool, label, out)

    def on_snapshot(cid, snap):
        t0 = time.perf_counter()
        service.on_checkpoint_complete(cid, {"window": {"subtasks": [snap]}})
        check(service.drain_feed(60.0), f"{label}: checkpoint {cid} was "
              f"not ingested")
        ingest_ms.append((time.perf_counter() - t0) * 1e3)
        replica_check(pool, label, cid, snap, rng)
        snaps[0] += 1

    loader = threading.Thread(target=serve_load,
                              args=(server.port, stop, load),
                              name="path54-load", daemon=True)
    try:
        sync(device)
        reset_launches()
        loader.start()
        spent = serve_drive(op, batches, on_fire, on_snapshot)
        sync(device)
        launches = read_launches()
        stop.set()
        loader.join(60)
        st = service.stats()
    finally:
        stop.set()
        pool.close()
        service.close()
        op.close()
    check("error" not in load and load.get("keys", 0) > 0,
          f"{label}: the load client failed: {load.get('error')}")
    check(fire_keys[0] > 0 and snaps[0] == len(batches) // SNAPSHOT_EVERY,
          f"{label}: {fire_keys[0]} fire keys checked, {snaps[0]} replica "
          f"checks")
    kernel = "scatter_fold" if PATHS[base].get("emit_tier") == "device" \
        else "probe"
    check(launches[kernel] > 0, f"{label}: no {kernel} launch: {launches}")
    lat = np.asarray(load["ms"])
    numbers = {
        "records_per_s": n_records / spent,
        "twin_records_per_s": rate["twin"],
        "view_records_per_s": rate["view"],
        "view_cost": float(np.median(rate["view"])
                           / np.median(rate["twin"])),
        "lookups_per_s": load["keys"] / load["seconds"],
        "lookup_p50_ms": float(np.percentile(lat, 50)),
        "lookup_p99_ms": float(np.percentile(lat, 99)),
        "serve_p50_ms": st["serve_p50_ms"], "serve_p99_ms": st["serve_p99_ms"],
        "cache_hit_rate": st["cache_hit_rate"],
        "replica_lag_ms": st["replica_lag_ms"],
        "replica_lag_checkpoints": st["replica_lag_checkpoints"],
        "ingest_ms": ingest_ms, "fire_keys_checked": fire_keys[0]}
    print(f"path {label} ({base}'s options, queryable={SERVE_STATE!r}, a "
          f"QueryableStateService behind a binary TCP server on 127.0.0.1): "
          f"{n_records} records, {numbers['records_per_s']:.1f} records/s "
          f"over the operator's calls under the load client; the load "
          f"client {load['keys']} keys in {len(lat)} requests of "
          f"{SERVE_LOAD_KEYS} = {numbers['lookups_per_s']:.1f} lookups/s, "
          f"request p50/p99 {numbers['lookup_p50_ms']:.3f}/"
          f"{numbers['lookup_p99_ms']:.3f} ms (client clock); serve p50/p99 "
          f"{st['serve_p50_ms']}/{st['serve_p99_ms']} ms (service.stats()); "
          f"cache hit rate {st['cache_hit_rate']}; every key of every fire "
          f"({fire_keys[0]} keys, requests of {SERVE_CHECK_KEYS}) read its "
          f"fire's row bit for bit; {snaps[0]} checkpoints ingested in "
          + "/".join(f"{x:.1f}" for x in ingest_ms)
          + f" ms, each replica's {SERVE_CHECK_KEYS} answers the numpy "
          f"combine of its snapshot bit for bit; replica lag "
          f"{st['replica_lag_checkpoints']} checkpoints, "
          f"{st['replica_lag_ms']} ms; launches {launches}; {card}")
    twin, view = np.median(rate["twin"]), np.median(rate["view"])
    print(f"A/B path {label} view cost, same batches, one process, turns "
          f"twin (no view), view (no client), view, twin: records/s twin "
          + " / ".join(f"{r:.1f}" for r in rate["twin"]) + " vs view "
          + " / ".join(f"{r:.1f}" for r in rate["view"])
          + f" (median ratio {view / twin:.3f}x; each run's largest phase, "
          f"ms: {', '.join(top)}); under the load client "
          f"{numbers['records_per_s']:.1f} "
          f"({numbers['records_per_s'] / twin:.3f}x the twin's median)")
    return launches, numbers


def path54(device, card, batches):
    """Path 54: serving, in two variants (54a path 5's device tier, 54b
    path 3's host tier with the probe on)."""
    launches, numbers = {}, {}
    for lane, base in SERVE_LANES.items():
        launches[lane], numbers[lane] = path54_lane(device, card, batches,
                                                    lane, base)
    total = {k: sum(launches[v][k] for v in launches)
             for k in launches["54a"]}
    return total, numbers


def rest_get(url, timings):
    """GET ``url``: (status, content type, body); its ms appended to
    ``timings``."""
    import urllib.request
    t0 = time.perf_counter()
    with urllib.request.urlopen(url, timeout=60) as r:
        body, status = r.read(), r.status
        ctype = r.headers.get("Content-Type", "")
    timings.append((time.perf_counter() - t0) * 1e3)
    return status, ctype, body


def rest_shape(path, ctype, body) -> bool:
    """The reference's answer shape of each endpoint path 55 reads."""
    if path == "/":
        return ctype.startswith("text/html") and b"<html" in body
    doc = json.loads(body)
    need = {"/overview": {"jobs_total", "jobs_running", "jobs_finished",
                          "jobs_failed"},
            "/jobs": {"jobs"},
            "/jobs/{id}": {"id", "name", "state", "vertices"},
            "/jobs/{id}/checkpoints": {"completed", "count", "history"},
            "/jobs/{id}/metrics": {"records_in", "records_out",
                                   "latency_ms"},
            "/jobs/{id}/backpressure": {"vertices", "checkpoints"},
            "/jobs/{id}/flamegraph": {"name", "value", "children"}}[path]
    return isinstance(doc, dict) and need <= set(doc)


def trace_cost(device, batches, card) -> dict:
    """Tracing's cost: path 5's operator over the main stream with the
    span journal off and on, in alternating pairs (off, on, on, off, ...)
    in this process; records/s of each run."""
    from flink_tpu_torch.observability import tracing
    from flink_tpu_torch.runtime import device_health
    n_records = sum(len(b[0]) for b in batches)
    rate = {"off": [], "on": []}
    spans = 0
    for i in range(TRACE_AB_PAIRS):
        for run in (("off", "on") if i % 2 == 0 else ("on", "off")):
            device_health.set_monitor(device_health.DeviceHealthMonitor())
            op = build_op(device, **PATHS["path 5"])
            journal = tracing.SpanJournal(1 << 16) if run == "on" else None
            tracing.install(journal)
            try:
                sync(device)
                spent = serve_drive(op, batches)
                sync(device)
            finally:
                tracing.uninstall()
            op.close()
            rate[run].append(n_records / spent)
            if journal is not None:
                spans = journal.recorded
                check(journal.dropped == 0, "path 55: the journal dropped "
                      "spans of path 5's run")
    off, on = np.median(rate["off"]), np.median(rate["on"])
    print(f"A/B path 55 tracing cost on path 5's operator, same batches, one "
          f"process, alternating pairs: records/s journal off "
          + " / ".join(f"{r:.1f}" for r in rate["off"]) + " vs on "
          + " / ".join(f"{r:.1f}" for r in rate["on"])
          + f" (median ratio {on / off:.3f}x; {spans} spans a traced run); "
          f"{card}")
    return {"off": rate["off"], "on": rate["on"], "ratio": on / off}


def path55(device, card, batches):
    """Path 55: the north star as a job on the MiniCluster (parallelism 2,
    52a's device tier) with ``metrics.tracing.enabled`` on and a
    ``RestServer`` over it: the endpoints, the dashboard, a Prometheus
    scrape and ``python -m flink_tpu_torch status`` while it runs, then
    its Chrome trace against ``phase_ns`` and the checkpoint stats."""
    import threading

    from flink_tpu_torch.cluster.minicluster import MiniCluster
    from flink_tpu_torch.config.config_option import Configuration
    from flink_tpu_torch.config.options import MetricOptions
    from flink_tpu_torch.datastream import StreamExecutionEnvironment
    from flink_tpu_torch.metrics.reporters import PrometheusReporter
    from flink_tpu_torch.observability import tracing
    from flink_tpu_torch.operators.window_agg import WindowAggOperator
    from flink_tpu_torch.rest.server import JobRegistry, RestServer
    from flink_tpu_torch.runtime import device_health
    from flink_tpu_torch.runtime.checkpoint.storage import \
        InMemoryCheckpointStorage
    label = "path 55"
    stream = batches[:OBS_BATCHES]
    n_records = sum(len(b[0]) for b in stream)
    device_health.set_monitor(device_health.DeviceHealthMonitor())
    cfg = Configuration()
    cfg.set(MetricOptions.TRACING_ENABLED, True)
    env = StreamExecutionEnvironment(config=cfg, device=device)
    env.set_parallelism(JOB_PARALLELISM)
    pins = dict(PATHS["path 5"])
    timings, seen = [], {}
    # the cluster adopts this journal: it records past the job's end, so a
    # cut that completes while the last subtask winds down keeps its span
    # (a ring the cluster owns is released when ``execute`` returns)
    journal = tracing.install(tracing.SpanJournal(
        MetricOptions.TRACING_BUFFER.default))
    with window_lane(pins):
        sink = north_star_job(env, stream)
        plan = env.get_stream_graph("north-star").to_plan()
        mc = MiniCluster(checkpoint_storage=InMemoryCheckpointStorage(
            retain=3), checkpoint_interval_ms=JOB_CHECKPOINT_MS,
            channel_capacity=JOB_CHANNEL_CAPACITY, config=cfg)
        registry = JobRegistry()
        job_id = registry.register("north-star", mc)
        server = RestServer(registry).start()
        result = {}
        runner = threading.Thread(
            target=lambda: result.update(res=mc.execute(plan, timeout_s=600)),
            name="path55-job", daemon=True)
        try:
            sync(device)
            reset_launches()
            t0 = time.perf_counter()
            runner.start()
            deadline = time.monotonic() + 120
            while not (mc.job_status()["state"] == "RUNNING"
                       and getattr(mc, "_source_tasks", None)):
                check(time.monotonic() < deadline and runner.is_alive(),
                      f"{label}: the job never ran")
                time.sleep(0.005)
            # hold the sources (they keep answering barriers) so every read
            # lands while the job runs
            for t in mc._source_tasks:
                t._paused.set()
            try:
                for path in OBS_ENDPOINTS:
                    status, ctype, body = rest_get(
                        server.url + path.format(id=job_id), timings)
                    check(status == 200 and rest_shape(path, ctype, body),
                          f"{label}: GET {path}: {status}, a body not of "
                          f"the reference's shape")
                    seen[path] = len(body)
                scrape = PrometheusReporter(
                    registry=mc.metrics_registry).scrape()
                check("# TYPE" in scrape
                      and "numberOfCompletedCheckpoints" in scrape
                      and "device_health_state" in scrape,
                      f"{label}: the Prometheus scrape lacks the job's "
                      f"checkpoint or device-health metrics")
                repo = os.path.dirname(os.path.abspath(__file__))
                cli = subprocess.run(
                    [sys.executable, "-m", "flink_tpu_torch", "status",
                     "--url", server.url, job_id], capture_output=True,
                    text=True, timeout=300, cwd=repo)
                check(cli.returncode == 0
                      and json.loads(cli.stdout)["state"] == "RUNNING",
                      f"{label}: python -m flink_tpu_torch status: "
                      f"{cli.returncode} {cli.stdout[-300:]} "
                      f"{cli.stderr[-300:]}")
                check(mc.job_status()["state"] == "RUNNING",
                      f"{label}: the job ended before the reads did")
            finally:
                for t in mc._source_tasks:
                    t._paused.clear()
            runner.join(600)
            for t in mc._tasks:
                t.join(60)
            sync(device)
            wall = time.perf_counter() - t0
            launches = read_launches()
        finally:
            server.stop()
            tracing.uninstall()
    res = result.get("res")
    check(res is not None and res.state == "FINISHED",
          f"{label}: the job {res}")
    check_job_rows(label, sink, reference(stream), reference_f32(stream),
                   bits=True)
    ops = [m for t in mc._tasks
           for m in getattr(t.operator, "operators", [t.operator])
           if isinstance(m, WindowAggOperator)]
    check(len(ops) == JOB_PARALLELISM
          and all(o.emit_tier == "device" for o in ops),
          f"{label}: the window subtasks' tiers {[o.emit_tier for o in ops]}")
    check(launches["scatter_fold"] > 0, f"{label}: launches {launches}")
    check(mc._trace_journal is journal, f"{label}: the cluster did not adopt "
          f"the installed journal")
    spans = journal.spans()
    hot = {}
    for ph, _ts, dur, name, cat, _tid, _args in spans:
        if cat == "hot_stage":
            hot[name] = hot.get(name, 0) + dur
    phase = {}
    for o in ops:
        for k, v in o.phase_ns.items():
            phase[k] = phase.get(k, 0) + v
    check(journal.dropped == 0 and hot == phase,
          f"{label}: the hot_stage spans per phase {hot} do not sum to the "
          f"window subtasks' phase_ns {phase} ({journal.dropped} dropped)")
    trace = mc.trace_events()
    events = trace["traceEvents"]
    n_ckpt = sum(1 for e in events if e.get("name") == "checkpoint"
                 and e.get("ph") == "X")
    stats = list(mc._checkpoint_stats)
    check(n_ckpt == len(stats) > 0,
          f"{label}: {n_ckpt} checkpoint spans against {len(stats)} "
          f"completed checkpoints")
    check(sum(1 for e in events if e.get("cat") == "hot_stage")
          == sum(1 for s in spans if s[4] == "hot_stage"),
          f"{label}: the Chrome export lost hot_stage spans")
    ms = np.asarray(timings)
    cost = trace_cost(device, batches, card)
    numbers = {"records_per_s": n_records / wall, "wall_s": wall,
               "events": journal.recorded, "dropped": journal.dropped,
               "rest_p50_ms": float(np.percentile(ms, 50)),
               "rest_p99_ms": float(np.percentile(ms, 99)),
               "checkpoints": len(stats), "trace_cost": cost}
    print(f"path 55 (the north star on the MiniCluster, parallelism "
          f"{JOB_PARALLELISM}, path 5's lane pinned, metrics.tracing.enabled"
          f", a RestServer over it): {n_records} records in {wall:.3f} s "
          f"(the reads with the sources held included); {len(timings)} GETs "
          f"while it ran, each 200 of the reference's shape "
          f"({json.dumps(seen)} B), request p50/p99 "
          f"{numbers['rest_p50_ms']:.3f}/{numbers['rest_p99_ms']:.3f} ms; a "
          f"Prometheus scrape of {len(scrape)} B; `python -m flink_tpu_torch "
          f"status` answered RUNNING; the journal {journal.recorded} events, "
          f"{journal.dropped} dropped; the hot_stage spans per phase sum to "
          f"the window subtasks' phase_ns (ns) {json.dumps(phase)}; "
          f"{n_ckpt} checkpoint spans = {len(stats)} completed checkpoints; "
          f"rows equal the f32 ordered reference bit for bit; launches "
          f"{launches}; {card}")
    return launches, numbers


def slice22(device, card, batches):
    """Paths 54-55: serving and observability."""
    t0 = time.perf_counter()
    launches, numbers = {}, {}
    for label, fn in (
            ("path 54", lambda: path54(device, card, batches)),
            ("path 55", lambda: path55(device, card, batches))):
        t1 = time.perf_counter()
        launches[label], numbers[label] = fn()
        print(f"{label} took {time.perf_counter() - t1:.1f} s of command "
              f"time")
    print(f"slice 22 took {time.perf_counter() - t0:.1f} s of command time")
    return launches, numbers


def main() -> None:
    try:
        import torch

        import flink_tpu_torch  # noqa: F401
    except ImportError as err:
        fail(f"cannot import the port ({err}): run from the repository root")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs a GPU")
    t_start = time.perf_counter()
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
        t1 = time.perf_counter()
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
        print(f"{label} took {time.perf_counter() - t1:.1f} s of command "
              f"time (its checks and replays included)")
    del fires, mids
    for label in SLICE11:
        t1 = time.perf_counter()
        launches[label], numbers[label] = slice11_path(device, batches,
                                                       expect, label)
        print(f"{label} took {time.perf_counter() - t1:.1f} s of command "
              f"time")
        a, b = numbers[label], numbers["path 5"]
        print(f"A/B {label} vs path 5, same batches, one process: records/s "
              f"{a['records_per_s']:.1f} vs {b['records_per_s']:.1f} "
              f"({a['records_per_s'] / b['records_per_s']:.3f}x); fire "
              f"p50/p99 {a['fire_p50_ms']:.3f}/{a['fire_p99_ms']:.3f} vs "
              f"{b['fire_p50_ms']:.3f}/{b['fire_p99_ms']:.3f} ms")
    session_batches = make_session_batches()
    session_ref = {"model": session_model(session_batches)}
    for label in SLICE12:
        t1 = time.perf_counter()
        stream = session_batches if label in ("path 22", "path 23") \
            else batches
        launches[label], fired_12, numbers[label] = slice12_path(
            device, label, stream, session_ref)
        if label == "path 22":
            session_ref["path 22"] = fired_12
        if label == "path 23":
            HELD["path 23"] = session_rows([b for _, b in fired_12])
        del fired_12
        print(f"{label} took {time.perf_counter() - t1:.1f} s of command "
              f"time")
    vector_leaf_check(device, session_batches)
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
    cep_batches = make_cep_batches()
    t1 = time.perf_counter()
    launches["path 26"], numbers["path 26"], cep_want = path26(device,
                                                              cep_batches)
    print(f"path 26 took {time.perf_counter() - t1:.1f} s of command time")
    t1 = time.perf_counter()
    launches["path 27"] = path27(device, cep_batches, numbers["path 26"],
                                 cep_want)
    print(f"path 27 took {time.perf_counter() - t1:.1f} s of command time")
    del cep_batches, cep_want
    t1 = time.perf_counter()
    join_phase(device)
    print(f"join phase took {time.perf_counter() - t1:.1f} s of command "
          f"time")
    slice14_launches, slice14_numbers = slice14(device, batches, card)
    launches.update(slice14_launches)
    numbers.update(slice14_numbers)
    slice15_launches, slice15_numbers = slice15(device, batches, card)
    launches.update(slice15_launches)
    numbers.update(slice15_numbers)
    slice16_launches, slice16_numbers = slice16(device, card)
    launches.update(slice16_launches)
    numbers.update(slice16_numbers)
    HELD.update({k: ab_want[k] for k in ("path 14", "path 15")})
    slice17_launches, slice17_numbers = slice17(device, card, batches)
    launches.update(slice17_launches)
    numbers.update(slice17_numbers)
    slice18_launches, slice18_numbers = slice18(device, card, batches)
    launches.update(slice18_launches)
    numbers.update(slice18_numbers)
    slice19_launches, slice19_numbers = slice19(device, card, batches,
                                                numbers)
    launches.update(slice19_launches)
    numbers.update(slice19_numbers)
    slice20_launches, slice20_numbers = slice20(device, card, batches,
                                                expect, cells, numbers)
    launches.update(slice20_launches)
    numbers.update(slice20_numbers)
    slice21_launches, slice21_numbers = slice21(device, card, numbers)
    launches.update(slice21_launches)
    numbers.update(slice21_numbers)
    slice22_launches, slice22_numbers = slice22(device, card, batches)
    launches.update(slice22_launches)
    numbers.update(slice22_numbers)
    for name, phase in (("pipeline A/B", lambda: pipeline_ab(
            device, "path 9", "path 3", ab_want["path 3"])),
            ("guard A/B", lambda: guard_ab(device, batches, ab_want)),
            ("mesh A/B", lambda: mesh_ab(device, batches, ab_want, card)),
            ("healer phase", healer_phase)):
        t1 = time.perf_counter()
        phase()
        print(f"{name} took {time.perf_counter() - t1:.1f} s of command "
              f"time")
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
    every_path = (ORDER + SLICE11 + SLICE12 + SLICE13 + SLICE14 + SLICE15
                  + SLICE16 + SLICE17 + SLICE18 + SLICE19 + SLICE20
                  + SLICE21 + SLICE22)
    for kernel in kernels:
        by_path = {label: launches[label][kernel["name"]]
                   for label in every_path}
        kernel["launches_by_path"] = by_path
        kernel["launches"] = sum(by_path.values())
        print(f"{kernel['name']} launches by path: {by_path}")
    wrapper = {"single": "ordered_fold_counts",
               "multi": "ordered_fold_counts_multi", "plane": "ordered_fold"}
    for part, name in wrapper.items():
        kernels[-1][f"launches_by_path_{part}"] = by_path = {
            label: launches[label][f"scatter_fold_{part}"]
            for label in every_path}
        print(f"scatter_fold launches through {name} by path: {by_path}")
    # the graph library's sum combine at path 32's shapes
    kernels[-1]["graph"] = numbers["path 32"]["kernel"]
    for label in ("path 1", "path 3"):
        check(launches[label]["probe"] > 0, f"{label}: no probe launch")
    for label in ("path 2", "path 4"):
        check(launches[label]["probe_fold"] > 0,
              f"{label}: no probe_fold launch")
    for label in (*DEVICE_PATHS, *PAGED_PATHS, *FAULTS, "path 8", "path 9",
                  *SLICE11_SCATTER, "path 23", "path 24", "path 25",
                  "path 28", "path 29", "path 32", "path 34", "path 35",
                  *SLICE16, "path 40", "path 41", "path 47", *SLICE19,
                  *SLICE20, *SLICE21, *SLICE22):
        check(launches[label]["scatter_fold"] > 0,
              f"{label}: no scatter_fold launch")
    check(launches["path 12"]["probe"] > 0, "path 12: no probe launch")
    check(launches["path 40"]["probe"] > 0, "path 40: no probe launch")
    check(launches["path 51"]["probe"] > 0, "path 51: no probe launch")
    check(launches["path 52"]["probe"] > 0, "path 52: no probe launch")
    check(launches["path 53"]["probe"] > 0, "path 53: no probe launch")
    check(launches["path 54"]["probe"] > 0, "path 54: no probe launch")
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

    print(f"the smoke took {time.perf_counter() - t_start:.1f} s of command "
          f"time, the build included")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": 1}}))


if __name__ == "__main__":
    main()
