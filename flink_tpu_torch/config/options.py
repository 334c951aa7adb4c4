"""Built-in option groups (port of ``flink_tpu/config/options.py``).

Analog of the reference's ``XxxOptions`` classes in
``flink-core/src/main/java/org/apache/flink/configuration/`` (e.g.
``CoreOptions``, ``CheckpointingOptions``, ``StateBackendOptions``,
``TaskManagerOptions``, ``NettyShuffleEnvironmentOptions``).
"""

from flink_tpu_torch.config.config_option import key


class CoreOptions:
    DEFAULT_PARALLELISM = key("parallelism.default").int_type().default_value(
        1, "Default operator parallelism (number of key-group shards driven concurrently).")
    MAX_PARALLELISM = key("pipeline.max-parallelism").int_type().default_value(
        128, "Number of key groups (state sharding unit; rescaling upper bound).")
    AUTO_WATERMARK_INTERVAL = key("pipeline.auto-watermark-interval").duration_type().default_value(
        200, "Periodic watermark emission interval in ms.")
    OBJECT_REUSE = key("pipeline.object-reuse").bool_type().default_value(
        True, "Batches are passed by reference between chained operators.")


class ExecutionOptions:
    MICRO_BATCH_SIZE = key("execution.micro-batch-size").int_type().default_value(
        65536, "Records per device micro-batch (the batched mailbox default action).")
    MICRO_BATCH_TIMEOUT_MS = key("execution.micro-batch-timeout").duration_type().default_value(
        5, "Max ms to wait filling a micro-batch before flushing a partial one.")
    RUNTIME_MODE = key("execution.runtime-mode").string_type().default_value(
        "STREAMING", "STREAMING | BATCH.")
    BUFFER_TIMEOUT_MS = key("execution.buffer-timeout").duration_type().default_value(
        100, "Output flush interval in ms.")


class StateOptions:
    BACKEND = key("state.backend").string_type().default_value(
        "hbm", "Keyed state backend: 'hbm' (device-resident dense arrays) or 'host' (numpy).")
    KEY_CAPACITY = key("state.backend.hbm.key-capacity").int_type().default_value(
        1 << 20, "Initial dense key-slot capacity per key-group shard (grows by doubling).")
    PANE_RING_SLOTS = key("state.backend.hbm.pane-ring-slots").int_type().default_value(
        0, "Pane ring slots (0 = derive from window size / lateness).")
    CHECKPOINT_DIR = key("state.checkpoints.dir").string_type().default_value(
        None, "Directory for checkpoint snapshots.")
    SAVEPOINT_DIR = key("state.savepoints.dir").string_type().default_value(
        None, "Directory for user-triggered savepoints.")
    INCREMENTAL = key("state.backend.incremental").bool_type().default_value(
        False, "Incremental checkpoints: delta-tracking operators ship "
        "pane-granular / changelog-suffix increments against the last "
        "confirmed base instead of full snapshots — checkpoint bytes scale "
        "with the change rate.  Savepoints and final (drain) snapshots "
        "stay full/self-contained.")
    CHANGELOG_MATERIALIZATION_THRESHOLD = key(
        "state.changelog.materialization-threshold").int_type().default_value(
        256, "Changelog backend: auto-materialize (full inner snapshot + "
        "log truncation) once the mutation log reaches this many entries; "
        "0 keeps materialization manual.")


class CheckpointingOptions:
    INTERVAL = key("execution.checkpointing.interval").duration_type().default_value(
        0, "Checkpoint interval in ms (0 disables periodic checkpoints).")
    TIMEOUT = key("execution.checkpointing.timeout").duration_type().default_value(
        600_000, "Checkpoint timeout in ms.")
    MODE = key("execution.checkpointing.mode").string_type().default_value(
        "EXACTLY_ONCE", "EXACTLY_ONCE | AT_LEAST_ONCE.")
    MAX_CONCURRENT = key("execution.checkpointing.max-concurrent-checkpoints").int_type().default_value(
        1, "Max concurrent in-flight checkpoints.")
    MIN_PAUSE = key("execution.checkpointing.min-pause").duration_type().default_value(
        0, "Minimum pause between checkpoints in ms.")
    RETAINED = key("state.checkpoints.num-retained").int_type().default_value(
        1, "How many completed checkpoints to retain.")
    UNALIGNED = key("execution.checkpointing.unaligned").bool_type().default_value(
        False, "Unaligned checkpoints: the barrier overtakes in-flight "
        "channel data, which is persisted as channel state — checkpoint "
        "duration becomes independent of backpressure.")
    ALIGNMENT_TIMEOUT = key("execution.checkpointing.alignment-timeout").duration_type().default_value(
        None, "Aligned-checkpoint timeout in ms: a checkpoint starts "
        "aligned and ESCALATES to unaligned once alignment exceeds this "
        "(0 = unaligned from the first barrier; None/unset = stay aligned).")
    ALIGNMENT_QUEUE_MAX = key("execution.checkpointing.alignment-queue-max-elements").int_type().default_value(
        8192, "Cap on elements buffered per subtask from barrier-blocked "
        "channels during alignment.  Hitting it escalates to unaligned "
        "when an alignment timeout is configured, and raises a classified "
        "AlignmentBufferOverflowError otherwise — bounded memory either way.")
    INCREMENTAL_MAX_INCREMENTS = key(
        "execution.checkpointing.incremental.max-increments-per-base").int_type().default_value(
        8, "Incremental storage: background-compact a checkpoint into a "
        "self-contained base once its increment chain exceeds this many "
        "links (bounds restore replay depth and retention pinning).")
    INCREMENTAL_REBASE_RATIO = key(
        "execution.checkpointing.incremental.rebase-ratio").float_type().default_value(
        0.5, "Delta-tracking operators take a full re-base cut when dirty "
        "cells exceed this fraction of the dense state grid (an increment "
        "bigger than that stops paying for itself).")


class DeviceOptions:
    PLATFORM = key("device.platform").string_type().default_value(
        None, "Force jax platform ('tpu'|'cpu'); None = jax default.")
    MESH_SHAPE = key("device.mesh.shape").string_type().default_value(
        None, "Mesh shape as 'kg=8' style spec; None = all devices on one 'kg' axis.")
    DONATE_STATE = key("device.donate-state").bool_type().default_value(
        True, "Donate state buffers into the jitted step (in-place HBM update).")
    SCATTER_MODE = key("device.scatter-mode").string_type().default_value(
        "sorted", "Segment aggregation strategy: 'direct' scatter-add | 'sorted' dedupe+unique-scatter.")


class NetworkOptions:
    """Analog of NettyShuffleEnvironmentOptions — host data-plane knobs."""
    BUFFERS_PER_CHANNEL = key("taskmanager.network.memory.buffers-per-channel").int_type().default_value(
        2, "Exclusive credit buffers per channel in the host exchange layer.")
    FLOATING_BUFFERS_PER_GATE = key("taskmanager.network.memory.floating-buffers-per-gate").int_type().default_value(
        8, "Floating credit buffers shared per input gate.")
    BUFFER_SIZE = key("taskmanager.memory.segment-size").memory_type().default_value(
        32 * 1024, "Host exchange buffer (segment) size in bytes.")
    COMPRESSION = key("taskmanager.network.compression.enabled").bool_type().default_value(
        False, "zstd-compress exchange buffers between hosts.")


class TaskManagerOptions:
    """Analog of TaskManagerOptions' managed-memory knobs (FLIP-49)."""
    MANAGED_MEMORY_SIZE = key("taskmanager.memory.managed.size").memory_type().default_value(
        256 << 20, "Managed memory per task executor, split evenly over "
        "its slots; budgeted operators (spill tier, sort/hash buffers) "
        "reserve from the slot's share and fail fast when over-committed.")
    NUM_TASK_SLOTS = key("taskmanager.numberOfTaskSlots").int_type().default_value(
        1, "Task slots offered by one task executor.")


class ShuffleOptions:
    """Analog of the shuffle SPI knobs (ShuffleServiceOptions +
    NettyShuffleEnvironmentOptions' sort-shuffle settings)."""
    SERVICE = key("shuffle.service").string_type().default_value(
        "sort-merge", "Result-partition service for batch exchanges: "
        "'sort-merge' (spilled blocking partitions) | 'pipelined' "
        "(in-memory concurrent) | any name registered via "
        "register_shuffle_service.")
    DIRECTORY = key("shuffle.directory").string_type().default_value(
        None, "Directory for spilled sort-merge partitions (default: a "
        "per-process tmp dir).")
    MEMORY_BUDGET_BYTES = key("shuffle.sort-merge.memory").memory_type().default_value(
        32 << 20, "Clustering buffer bytes before a sort-merge writer "
        "spills one region.")


class RestOptions:
    PORT = key("rest.port").int_type().default_value(8081, "REST/web endpoint port.")
    ADDRESS = key("rest.address").string_type().default_value("127.0.0.1", "REST bind address.")


class HeartbeatOptions:
    INTERVAL = key("heartbeat.interval").duration_type().default_value(
        1000, "Heartbeat interval in ms between coordinator and workers.")
    TIMEOUT = key("heartbeat.timeout").duration_type().default_value(
        5000, "Heartbeat timeout in ms before a worker is declared dead.")


class RestartOptions:
    STRATEGY = key("restart-strategy").string_type().default_value(
        "exponential-delay", "none | fixed-delay | exponential-delay | failure-rate.")
    FIXED_DELAY_ATTEMPTS = key("restart-strategy.fixed-delay.attempts").int_type().default_value(3)
    FIXED_DELAY_DELAY = key("restart-strategy.fixed-delay.delay").duration_type().default_value(1000)
    EXP_INITIAL_BACKOFF = key("restart-strategy.exponential-delay.initial-backoff").duration_type().default_value(100)
    EXP_MAX_BACKOFF = key("restart-strategy.exponential-delay.max-backoff").duration_type().default_value(60_000)
    EXP_MULTIPLIER = key("restart-strategy.exponential-delay.backoff-multiplier").float_type().default_value(2.0)


class HighAvailabilityOptions:
    """Analog of ``HighAvailabilityOptions.java``: coordinator leader
    lease + epoch fencing + job recovery from the HA store
    (``runtime/ha.py``)."""

    MODE = key("high-availability.type").string_type().default_value(
        "none", "'none' (single coordinator) | 'filesystem' (FileHaStore: "
        "leader lease with a monotone fencing epoch, registered job "
        "plans, and the completed-checkpoint pointer recovery consults "
        "before any directory scan).")
    STORAGE_DIR = key("high-availability.storageDir").string_type().default_value(
        None, "Directory backing the FileHaStore (lease, epoch counter, "
        "job registry, checkpoint pointers).  Required when the type is "
        "'filesystem'.")
    LEASE_TTL = key("high-availability.lease.ttl").duration_type().default_value(
        2000, "Leader lease time-to-live in ms.  The holder renews every "
        "ttl/3; a standby acquires the lease (at epoch + 1) once the "
        "deadline passes un-renewed.")
    ORPHAN_TIMEOUT = key("high-availability.worker.orphan-timeout").duration_type().default_value(
        45_000, "Workers self-terminate (committing nothing) when the "
        "coordinator has been silent this long — no control traffic, no "
        "pings — so an orphaned worker pool cannot outlive its leader. "
        "0 disables the reaper.")
    PING_INTERVAL = key("high-availability.coordinator.ping-interval").duration_type().default_value(
        5000, "Coordinator ping cadence in ms: keeps quiet-but-alive "
        "leaders' workers from self-terminating (must be well under the "
        "orphan timeout).")


class MetricOptions:
    REPORTERS = key("metrics.reporters").list_type().default_value(
        [], "Active metric reporter names.")
    LATENCY_INTERVAL = key("metrics.latency.interval").duration_type().default_value(
        0, "Latency-marker emission interval in ms (0 = disabled): sources "
        "emit LatencyMarker probes on this cadence (through the injectable "
        "clock seam); every operator hop records them into per-(source, "
        "hop) latency histograms exported by the reporters and the REST "
        "latency panel.")
    TRACING_ENABLED = key("metrics.tracing.enabled").bool_type().default_value(
        False, "Install the per-process span journal at deploy: hot-stage "
        "phases, checkpoint lifecycle, device-health/paging/exchange/CEP "
        "events record structured spans, exported as Chrome trace-event "
        "JSON (REST /jobs/<id>/trace, Perfetto-viewable).")
    TRACING_BUFFER = key("metrics.tracing.buffer-size").int_type().default_value(
        65536, "Span-journal ring capacity; once full new spans are "
        "dropped and counted (bounded memory, loud truncation).")
    SCOPE_DELIMITER = key("metrics.scope.delimiter").string_type().default_value(".")


class SecurityOptions:
    """Transport security (``SecurityOptions.java`` analog: the
    ``security.ssl.internal.*`` / ``security.ssl.rest.*`` key families)."""

    SSL_INTERNAL_ENABLED = key("security.ssl.internal.enabled").bool_type().default_value(
        False, "Mutual TLS on internal connections (data plane channels, "
               "coordinator control plane).")
    SSL_REST_ENABLED = key("security.ssl.rest.enabled").bool_type().default_value(
        False, "TLS on the REST endpoint (server-auth only).")
    SSL_CERT = key("security.ssl.certificate").string_type().default_value(
        "", "PEM certificate presented by this process.")
    SSL_KEY = key("security.ssl.key").string_type().default_value(
        "", "PEM private key for the certificate.")
    SSL_CA = key("security.ssl.ca").string_type().default_value(
        "", "PEM CA bundle that signs every cluster certificate "
            "(the truststore).")
    AUTH_TOKEN = key("security.auth.token").string_type().default_value(
        "", "Shared cluster secret: HMAC-authenticates control-plane "
            "connections (usable with or without TLS).")
