"""Counter-field registries the port's engine uses.

Own copies of ``ra_tpu.metrics.ENGINE_PIPELINE_FIELDS``,
``TELEMETRY_FIELDS``, ``TELEMETRY_SUMMARY_FIELDS``, ``PHASE_FIELDS``,
``WAL_FIELDS``, ``ENGINE_WAL_FIELDS`` and ``DISK_FAULT_FIELDS`` (the
port imports nothing of ``ra_tpu``); the equality of every tuple with
the reference is pinned by ``tests/test_torch_engine.py`` and
``tests/test_torch_wal.py``.
"""

#: host-side dispatch-pipeline counters of ``LockstepEngine``:
#: ``dispatches`` device programs launched by the host, ``inner_steps``
#: engine rounds (a superstep of K adds K), ``superstep_dispatches`` the
#: fused subset, ``blocks_staged`` host->device staging transfers of the
#: dispatch-ahead driver, ``window_syncs`` its in-flight-cap pops that
#: had to wait for the device.
ENGINE_PIPELINE_FIELDS = ("dispatches", "inner_steps",
                          "superstep_dispatches", "blocks_staged",
                          "window_syncs")

#: device-resident per-lane telemetry accumulators (``LaneTelemetry``):
#: counters ``elections_requested``, ``elections_won``, ``leader_changes``,
#: ``steps``; gauges ``leader_age`` (steps since the leader last moved),
#: ``commit_lag`` (leader tail - leader commit), ``apply_lag`` (leader
#: commit - lane apply frontier), ``stall_steps`` (consecutive rounds with
#: a commit backlog and no commit progress).
TELEMETRY_FIELDS = (
    "elections_requested", "elections_won", "leader_changes",
    "leader_age", "commit_lag", "apply_lag", "stall_steps", "steps",
)

#: the on-device aggregation of TELEMETRY_FIELDS that
#: ``TelemetrySampler`` reads back: scalar rollups, the log2-bucket
#: ``commit_lag_hist``, the ``top_lanes`` offenders by (stall, lag) score
#: with their ``top_*`` gauges, and cumulative float32 totals.
TELEMETRY_SUMMARY_FIELDS = (
    "steps", "elections_requested", "elections_won", "leader_changes",
    "stalled_lanes", "commit_lag_max", "commit_lag_mean",
    "apply_lag_max", "apply_lag_mean", "leader_age_min",
    "commit_lag_hist", "top_lanes", "top_commit_lag", "top_apply_lag",
    "top_stall_steps", "committed_total",
    "read_served_total", "read_shed_total", "read_stale_total",
    "read_leased_total",
)

#: host-side latency phases of ``telemetry.PhaseStats``, stamped at the
#: dispatch path's edges: ``host_staging`` the driver's host copy of a
#: block into pinned memory plus the start of its host-to-device copy,
#: ``device_dispatch`` submit to the dispatch's committed watermark
#: observed on the host, ``read_e2e`` read-block submit to its serve
#: outcome observed.  The WAL phases are stamped by the durable engine
#: (``engine/durable.py``) and its WAL shards (``log/wal.py``):
#: ``queue_wait`` a submitted step's wait for its shard's worker,
#: ``wal_encode`` readback plus encode, ``encode`` the block encode
#: alone, ``fsync_wait`` and ``confirm_publish`` the WAL's group commit,
#: ``commit_e2e`` submit to the step covered by every shard's horizon.
PHASE_FIELDS = (
    "host_staging", "device_dispatch", "queue_wait", "wal_encode",
    "fsync_wait", "confirm_publish", "commit_e2e", "encode",
    "read_e2e",
)

#: WAL counter fields, one dict per WAL (each shard of the durable
#: engine owns one): ``wal_files`` files opened, ``batches`` group
#: commits, ``writes`` records, ``bytes_written``, ``syncs`` durability
#: syscalls and ``sync_time_us`` their cumulative wall time.
#: ``Wal.stats()`` adds fsync p50/p99 and records per fsync.
WAL_FIELDS = ("wal_files", "batches", "writes", "bytes_written", "syncs",
              "sync_time_us")

#: durable-engine bridge counters (``engine/durable.py``):
#: ``readback_bytes`` what the compacted device-to-host readback moved
#: for WAL encode, ``readback_bytes_full`` what a readback of the whole
#: [N, K, C] batch would have moved on the same steps, and the encoded
#: WAL blocks and their bytes.  The overview adds ``confirm_lag_steps``
#: (dispatched but unconfirmed steps on the laggiest shard) as a gauge.
ENGINE_WAL_FIELDS = ("readback_bytes", "readback_bytes_full",
                     "encoded_blocks", "encoded_bytes")

#: storage-plane fault counters (``log/faults.py``), one process-wide
#: dict: ``faults_injected`` plan decisions that injected a fault;
#: ``faults_hit`` I/O errors the log layer handled; ``crc_catches``
#: corruption caught by a CRC check; ``poisoned_files`` WAL files
#: poisoned by a failed durability syscall (never fsynced again);
#: ``fault_rollovers`` rollovers that poison forced;
#: ``wal_escalations`` poison-cap overflows escalated to thread death;
#: ``flush_retries``/``flush_escalations`` the segment-flush backoff;
#: ``snapshot_write_failures`` failed snapshot writes;
#: ``swallowed_oserrors`` the audited swallow sites; and
#: ``fsync_retries_after_failure`` fsyncs re-issued on a failed fd with
#: no rewrite in between, which must stay 0.
DISK_FAULT_FIELDS = (
    "faults_injected", "faults_hit", "crc_catches", "poisoned_files",
    "fault_rollovers", "wal_escalations", "flush_retries",
    "flush_escalations", "snapshot_write_failures",
    "swallowed_oserrors", "fsync_retries_after_failure",
)

#: every counter-field group of the port, by the reference's group names
FIELD_REGISTRY = {
    "wal": WAL_FIELDS,
    "engine_wal": ENGINE_WAL_FIELDS,
    "engine_pipeline": ENGINE_PIPELINE_FIELDS,
    "telemetry": TELEMETRY_FIELDS,
    "telemetry_summary": TELEMETRY_SUMMARY_FIELDS,
    "phase": PHASE_FIELDS,
    "disk_faults": DISK_FAULT_FIELDS,
}
